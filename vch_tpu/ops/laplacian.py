"""Neumann Laplacian: dense matrix, exact cosine eigenbasis, matrix-free applies.

The reference builds the (N+1)x(N+1) finite-difference Laplacian with mirrored
ghost-point Neumann rows — interior 3-point stencil a=1/h^2 and boundary rows
(Lv)_0 = 2a (v_1 - v_0), (Lv)_N = 2a (v_{N-1} - v_N)
(ref: Forward_solver.py:64-76; Forward2_solver.py:105-122) — and in 2D
assembles kron(I, Lx) + kron(Ly, I) over the flattened field
(Forward2_solver.py:125-137).

Design: this operator has an EXACT eigendecomposition in the
cosine basis on a uniform grid,

    v_k[j] = cos(pi*k*j/N),   L v_k = lambda_k v_k,
    lambda_k = -(4/h^2) sin^2(pi*k/(2N)),

which holds including the mirrored boundary rows. We precompute V (modes as
columns) and V^{-1} (DCT-I-like analysis with trapezoidal weights) host-side
in float64 and apply them as dense matmuls. This is what makes the
Newton/adjoint linear solves fast on an accelerator: the constant-coefficient
part of every implicit operator is diagonal in this basis (see
ops/linsolve.py).

Matrix-free stencil applies are also provided (a matmul-free alternative);
the 2D Laplacian is applied as two 1D matmuls Lx @ A + A @ Ly^T rather than
a kron matvec.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from vch_tpu.ops.grids import trapz_weights


def laplacian_matrix_neumann(N: int, h: float) -> np.ndarray:
    """Dense (N+1)x(N+1) Neumann FD Laplacian (host-side constant).

    Ref parity: Forward_solver.py:64-76.
    """
    a = 1.0 / (h * h)
    L = np.zeros((N + 1, N + 1))
    idx = np.arange(1, N)
    L[idx, idx - 1] = a
    L[idx, idx] = -2.0 * a
    L[idx, idx + 1] = a
    L[0, 0], L[0, 1] = -2.0 * a, 2.0 * a
    L[N, N - 1], L[N, N] = 2.0 * a, -2.0 * a
    return L


def neumann_eigendecomposition(N: int, h: float):
    """Exact eigendecomposition L = V diag(lam) V^{-1} of the Neumann Laplacian.

    V[:, k] = cos(pi*k*j/N) over nodes j=0..N; lam_k = -(4/h^2) sin^2(pi k/(2N)).
    V^{-1} follows from the discrete DCT-I orthogonality with trapezoidal
    weights w: sum_j w_j cos(pi k j/N) cos(pi m j/N) = (N/2) c_k delta_km,
    with c_k = 2 for k in {0, N} and 1 otherwise. All float64 numpy.

    Returns (lam, V, Vinv).
    """
    j = np.arange(N + 1)[:, None]
    k = np.arange(N + 1)[None, :]
    V = np.cos(np.pi * j * k / N)
    lam = -(4.0 / (h * h)) * np.sin(np.pi * np.arange(N + 1) / (2.0 * N)) ** 2
    c = np.ones(N + 1)
    c[0] = 2.0
    c[N] = 2.0
    w = trapz_weights(N + 1)
    # Vinv[k, j] = (2 / (N c_k)) * w_j * cos(pi k j / N)
    Vinv = (2.0 / (N * c))[:, None] * (w[None, :] * V.T)
    return lam, V, Vinv


def apply_laplacian_1d(L: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """L @ v along the last axis (batched-friendly matmul form)."""
    return v @ L.T


def apply_laplacian_2d(Lx: jnp.ndarray, Ly: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """2D Neumann Laplacian on a field v[..., i, j]: Lx along axis -2, Ly along -1.

    Equivalent to the reference's kron(I,L)+kron(L,I) matvec on square grids
    (Forward2_solver.py:125-152), expressed as two matmuls.
    """
    return jnp.einsum("ab,...bj->...aj", Lx, v) + v @ Ly.T


def stencil_laplacian_1d(v: jnp.ndarray, h: float) -> jnp.ndarray:
    """Matrix-free mirrored-ghost Neumann Laplacian along the last axis."""
    pad = jnp.concatenate([v[..., 1:2], v, v[..., -2:-1]], axis=-1)
    return (pad[..., :-2] - 2.0 * v + pad[..., 2:]) / (h * h)


def stencil_laplacian_2d(v: jnp.ndarray, hx: float, hy: float) -> jnp.ndarray:
    """Matrix-free 2D Neumann Laplacian on v[..., i, j]."""
    padx = jnp.concatenate([v[..., 1:2, :], v, v[..., -2:-1, :]], axis=-2)
    lap_x = (padx[..., :-2, :] - 2.0 * v + padx[..., 2:, :]) / (hx * hx)
    pady = jnp.concatenate([v[..., 1:2], v, v[..., -2:-1]], axis=-1)
    lap_y = (pady[..., :-2] - 2.0 * v + pady[..., 2:]) / (hy * hy)
    return lap_x + lap_y
