"""Operator-layer tests: Laplacian eigenstructure, quadrature, Schur solves.

Mirrors the reference's operator checks (test_1d_forward.py:161-183 cosine
eigenfunction; test_2d_Cost.py:120-134 Neumann nullspace) and adds exactness
tests for the spectral machinery that has no reference analog.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from vch_tpu.ops.grids import trapz_weights
from vch_tpu.ops.laplacian import (
    apply_laplacian_2d,
    laplacian_matrix_neumann,
    neumann_eigendecomposition,
    stencil_laplacian_1d,
    stencil_laplacian_2d,
)
from vch_tpu.ops.linsolve import (
    bicgstab,
    make_spectral_op_2d,
    newton_schur_solve_1d,
    newton_schur_solve_2d,
)


def test_trapz_weights():
    w = trapz_weights(5)
    assert np.allclose(w, [0.5, 1, 1, 1, 0.5])


def test_laplacian_cosine_eigenfunction():
    """L cos(k pi x / L) ~ -(k pi / L)^2 cos(...) for resolved modes."""
    N, Lx = 256, 1.0
    h = Lx / N
    x = np.linspace(0, Lx, N + 1)
    L = laplacian_matrix_neumann(N, h)
    for k in (1, 2, 5):
        v = np.cos(k * np.pi * x / Lx)
        lam_exact = -(k * np.pi / Lx) ** 2
        err = np.abs(L @ v - lam_exact * v).max() / abs(lam_exact)
        assert err < 1e-3, f"mode {k}: {err}"


def test_laplacian_neumann_nullspace():
    """Constants are in the nullspace: L @ 1 = 0 exactly."""
    L = laplacian_matrix_neumann(64, 1 / 64)
    assert np.abs(L @ np.ones(65)).max() == 0.0


def test_eigendecomposition_exact():
    N, h = 96, 1 / 96
    L = laplacian_matrix_neumann(N, h)
    lam, V, Vinv = neumann_eigendecomposition(N, h)
    assert np.abs(L @ V - V * lam[None, :]).max() < 1e-8
    assert np.abs(Vinv @ V - np.eye(N + 1)).max() < 1e-12


def test_stencil_matches_matrix_1d():
    N, h = 77, 1 / 77
    L = laplacian_matrix_neumann(N, h)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(N + 1)
    assert np.allclose(np.asarray(stencil_laplacian_1d(jnp.asarray(v), h)),
                       L @ v, atol=1e-9)


def test_stencil_matches_matmul_2d():
    Nx, Ny, hx, hy = 17, 23, 1 / 17, 1 / 23
    op = make_spectral_op_2d(Nx, Ny, hx, hy)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.standard_normal((Nx + 1, Ny + 1)))
    a = np.asarray(apply_laplacian_2d(op.Lx, op.Ly, v))
    b = np.asarray(stencil_laplacian_2d(v, hx, hy))
    assert np.abs(a - b).max() < 1e-9


def test_schur_solve_1d_matches_monolithic():
    """Schur-eliminated solve == the reference's monolithic block LU
    (Forward_solver.py:111-190) to roundoff."""
    N, h = 64, 1 / 64
    L = laplacian_matrix_neumann(N, h)
    rng = np.random.default_rng(0)
    phi = 0.8 * np.tanh(rng.standard_normal(N + 1))
    dt, tau, c1, kappa = 1e-2, 0.05, 0.75, 9e-4
    d = 2 * c1 / (1 - phi ** 2)
    Kpp = -0.5 * kappa * L + np.diag(tau / dt + d)
    I = np.eye(N + 1)
    J = np.block([[Kpp, -0.5 * I], [I / dt, -0.5 * L]])
    Rphi = rng.standard_normal(N + 1)
    Rmu = rng.standard_normal(N + 1)
    delta = np.linalg.solve(J, -np.concatenate([Rphi, Rmu]))
    dphi, dmu = newton_schur_solve_1d(
        jnp.asarray(L), jnp.asarray(phi), jnp.asarray(Rphi), jnp.asarray(Rmu),
        dt, tau, c1, kappa, 1e-2)
    assert np.abs(np.asarray(dphi) - delta[:N + 1]).max() < 1e-9
    assert np.abs(np.asarray(dmu) - delta[N + 1:]).max() < 1e-8


def test_schur_solve_2d_matches_dense_kron():
    """Matrix-free spectral-preconditioned BiCGStab == dense kron solve."""
    Nx = Ny = 16
    hx = hy = 1 / 16
    op = make_spectral_op_2d(Nx, Ny, hx, hy)
    rng = np.random.default_rng(2)
    dt, tau, c1, kappa, delta_sep = 1e-2, 0.05, 0.75, 1e-4, 1e-2
    L1x = laplacian_matrix_neumann(Nx, hx)
    L1y = laplacian_matrix_neumann(Ny, hy)
    L2d = (np.kron(L1x, np.eye(Ny + 1)) + np.kron(np.eye(Nx + 1), L1y))
    phi = 0.8 * np.tanh(rng.standard_normal((Nx + 1, Ny + 1)))
    d = 2 * c1 / (1 - np.clip(phi ** 2, 0, 1 - delta_sep ** 2).ravel())
    Nloc = (Nx + 1) * (Ny + 1)
    S = ((1 / dt) * np.eye(Nloc) + 0.5 * kappa * (L2d @ L2d)
         - (tau / dt) * L2d - L2d @ np.diag(d))
    Rphi = rng.standard_normal((Nx + 1, Ny + 1))
    Rmu = rng.standard_normal((Nx + 1, Ny + 1))
    rhs = L2d @ Rphi.ravel() - Rmu.ravel()
    dphi_ref = np.linalg.solve(S, rhs).reshape(Nx + 1, Ny + 1)
    dphi, _ = newton_schur_solve_2d(
        op, jnp.asarray(phi), jnp.asarray(Rphi), jnp.asarray(Rmu),
        dt, tau, c1, kappa, delta_sep, tol=1e-12, max_iter=500)
    rel = np.abs(np.asarray(dphi) - dphi_ref).max() / np.abs(dphi_ref).max()
    assert rel < 1e-8, rel


def test_bicgstab_solves_spd_system():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 40))
    A = A @ A.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    x = bicgstab(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                 lambda v: v / jnp.diag(jnp.asarray(A)), tol=1e-12,
                 max_iter=200)
    assert np.abs(A @ np.asarray(x) - b).max() < 1e-8
