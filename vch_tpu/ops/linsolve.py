"""Structured linear solvers for the Newton and adjoint systems.

The reference solves the coupled (phi, mu) Newton system monolithically —
dense LU on 2(N+1) unknowns in 1D (Forward_solver.py:185) and sparse LU
(spsolve) on 2*Nloc unknowns in 2D (Forward2_solver.py:370) — and the adjoint
march with dense/sparse LU per step (backward_solver.py:113-118,
backward2_solver.py:226-231). Sparse LU maps poorly onto an accelerator;
instead we exploit structure:

Newton system (J from Forward_solver.py:111-137):
    [Kpp  -I/2] [dphi]   [-Rphi]        Kpp = -(kappa/2) L + (tau/dt + D) I,
    [I/dt -L/2] [dmu ] = [-Rmu ],       D = diag(2 c1/(1-phi^2)).
Exact Schur elimination of dmu gives ONE system in dphi:
    S dphi = L Rphi - Rmu,   S = (1/dt) I + (kappa/2) L^2 - (tau/dt) L - L D,
    dmu = 2 (Kpp dphi + Rphi).

Adjoint step operator (backward_solver.py:99-105):
    A = I - tau L + (dt/2) L^2 - (dt/2) D_f L,   D_f = diag(f''(phi)).

Both are {constant-coefficient polynomial in L} + {one diagonal-times-L term}.
On the uniform Neumann grid L diagonalizes EXACTLY in the cosine basis
(ops/laplacian.py), so:

- 1D: form S densely ((N+1)^2, tiny) and use batched LU (jnp.linalg.solve) —
  batched dense linear algebra, exact parity with the reference.
- 2D: matrix-free preconditioned BiCGStab. The operator apply is two Laplacian
  applies (4 matmuls); the preconditioner replaces D by its mean dbar, which
  makes it diagonal in the cosine basis: 4 matmuls + a pointwise divide.
  All matmul work, batchable over scenarios via vmap.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from vch_tpu.ops.laplacian import (
    laplacian_matrix_neumann,
    neumann_eigendecomposition,
    apply_laplacian_2d,
)


class SpectralOp2D(NamedTuple):
    """Host-precomputed constants for 2D operators on a (Nx+1)x(Ny+1) grid."""

    Lx: jnp.ndarray      # (Nx+1, Nx+1) Neumann Laplacian, x direction
    Ly: jnp.ndarray      # (Ny+1, Ny+1)
    Vx: jnp.ndarray      # cosine modes as columns
    Vy: jnp.ndarray
    Vx_inv: jnp.ndarray
    Vy_inv: jnp.ndarray
    lam: jnp.ndarray     # (Nx+1, Ny+1) lam_x[i] + lam_y[j] eigenvalue grid


def make_spectral_op_2d(Nx: int, Ny: int, hx: float, hy: float,
                        dtype=jnp.float64) -> SpectralOp2D:
    Lx = laplacian_matrix_neumann(Nx, hx)
    Ly = laplacian_matrix_neumann(Ny, hy)
    lamx, Vx, Vx_inv = neumann_eigendecomposition(Nx, hx)
    lamy, Vy, Vy_inv = neumann_eigendecomposition(Ny, hy)
    lam = lamx[:, None] + lamy[None, :]
    as_j = lambda a: jnp.asarray(a, dtype=dtype)
    return SpectralOp2D(as_j(Lx), as_j(Ly), as_j(Vx), as_j(Vy),
                        as_j(Vx_inv), as_j(Vy_inv), as_j(lam))


def to_spectral(op: SpectralOp2D, v: jnp.ndarray) -> jnp.ndarray:
    """Analysis transform: vhat = Vx^{-1} v Vy^{-T} (2 matmuls)."""
    return jnp.einsum("ab,...bj->...aj", op.Vx_inv, v) @ op.Vy_inv.T


def from_spectral(op: SpectralOp2D, vhat: jnp.ndarray) -> jnp.ndarray:
    """Synthesis transform: v = Vx vhat Vy^T (2 matmuls)."""
    return jnp.einsum("ab,...bj->...aj", op.Vx, vhat) @ op.Vy.T


def spectral_poly_solve(op: SpectralOp2D, denom_of_lam: Callable, rhs: jnp.ndarray):
    """Exactly solve P v = rhs where P = poly(L) is diagonal in the cosine basis.

    denom_of_lam maps the eigenvalue grid lam -> the scalar symbol of P.
    """
    return from_spectral(op, to_spectral(op, rhs) / denom_of_lam(op.lam))


def bicgstab(apply_A: Callable, b: jnp.ndarray, apply_M: Callable,
             tol: float, max_iter: int, x0: jnp.ndarray | None = None,
             dot_fn: Callable | None = None,
             sync_pred: Callable | None = None):
    """Right-preconditioned BiCGStab, jit/vmap-safe (fixed-bound while_loop).

    Solves A x = b with preconditioner application apply_M ~= A^{-1}.
    Written out rather than using jax.scipy so the convergence policy,
    dtype behavior, and batching semantics are fully ours. Returns x.
    dot_fn overrides the inner product — the grid-sharded solver passes a
    psum-reduced dot so the same recurrence runs distributed
    (parallel/spatial.py).

    sync_pred (combined scenarios x grid mesh, parallel/spatial.py): an
    all-reduce applied to the continue predicate so every device in the
    mesh runs the SAME trip count. Collectives inside a data-dependent
    while_loop otherwise deadlock when trip counts diverge across device
    groups that share a global communicator (the XLA CPU collective
    rendezvous spans the whole mesh, and on the GPU a cross-group NCCL
    sequence mismatch is just as fatal). When set, converged systems
    FREEZE (body updates masked by the local predicate), so the extra
    lockstep iterations are exact no-ops and per-member results are
    independent of the other members' trip counts.
    """
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    rhat = r
    dot = dot_fn or (lambda a, c: jnp.sum(a * c))
    b_norm = jnp.sqrt(dot(b, b))
    atol2 = (tol * jnp.maximum(b_norm, 1e-300)) ** 2
    eps_div = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)

    # the residual norm rides the carry: cond reads it for free and the
    # body computes it once per trip for the NEXT test (the distributed
    # dot is a psum on the grid-sharded path — one collective saved/trip)
    def cond(carry):
        x, r, p, v, rho, alpha, omega, rr, k = carry
        pred = (rr > atol2) & (k < max_iter)
        return sync_pred(pred) if sync_pred is not None else pred

    def body(carry):
        x, r, p, v, rho, alpha, omega, rr, k = carry
        rho_new = dot(rhat, r)
        beta = (rho_new / (rho + eps_div)) * (alpha / (omega + eps_div))
        p_n = r + beta * (p - omega * v)
        phat = apply_M(p_n)
        v_n = apply_A(phat)
        alpha_n = rho_new / (dot(rhat, v_n) + eps_div)
        s = r - alpha_n * v_n
        shat = apply_M(s)
        t = apply_A(shat)
        omega_n = dot(t, s) / (dot(t, t) + eps_div)
        x_n = x + alpha_n * phat + omega_n * shat
        r_n = s - omega_n * t
        rr_n = dot(r_n, r_n)
        if sync_pred is not None:
            # freeze members already at tolerance: lockstep extra trips
            # (forced by the globally OR'd predicate) must not perturb them
            active = rr > atol2
            sel = lambda new, old: jnp.where(active, new, old)
            return (sel(x_n, x), sel(r_n, r), sel(p_n, p), sel(v_n, v),
                    sel(rho_new, rho), sel(alpha_n, alpha),
                    sel(omega_n, omega), sel(rr_n, rr), k + 1)
        return (x_n, r_n, p_n, v_n, rho_new, alpha_n, omega_n, rr_n, k + 1)

    one = jnp.asarray(1.0, dtype)
    init = (x, r, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
            dot(r, r), jnp.asarray(0, jnp.int32))
    out = jax.lax.while_loop(cond, body, init)
    return out[0]


def bicgstab_fixed(apply_A: Callable, b: jnp.ndarray, apply_M: Callable,
                   n_iter: int, x0: jnp.ndarray | None = None,
                   dot_fn: Callable | None = None):
    """Fixed-trip-count BiCGStab (fori_loop, no convergence predicate).

    The float32 execution path: a constant number of Krylov iterations compiles
    to a much smaller program than the adaptive while_loop (no reduce+branch
    per iteration) and runs without per-iteration convergence barriers. The
    outer (inexact) Newton iteration absorbs residual inexactness — its
    Armijo check and its own convergence test are on the TRUE nonlinear
    residual. With the cosine-diagonal preconditioner the typical solve
    converges in ~3 iterations, so n_iter ~ 8-16 is conservative.
    """
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    rhat = r
    dot = dot_fn or (lambda a, c: jnp.sum(a * c))
    eps_div = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)
    one = jnp.asarray(1.0, dtype)
    # Freeze threshold: once ||r|| reaches the dtype noise floor relative to
    # ||b||, further (branch-free) iterations would divide near-zero
    # quantities and inject garbage (BiCGStab breakdown) — mask the update
    # instead. This replaces the adaptive loop's early exit.
    eps_mach = 2.2e-16 if dtype == jnp.float64 else 1.2e-7
    floor2 = (50.0 * eps_mach) ** 2 * jnp.maximum(dot(b, b), eps_div)

    def body(_, carry):
        x, r, p, v, rho, alpha, omega, best_x, best_r2 = carry
        active = dot(r, r) > floor2
        rho_new = dot(rhat, r)
        beta = (rho_new / (rho + eps_div)) * (alpha / (omega + eps_div))
        p_n = r + beta * (p - omega * v)
        phat = apply_M(p_n)
        v_n = apply_A(phat)
        alpha_n = rho_new / (dot(rhat, v_n) + eps_div)
        s = r - alpha_n * v_n
        shat = apply_M(s)
        t = apply_A(shat)
        omega_n = dot(t, s) / (dot(t, t) + eps_div)
        x_n = x + alpha_n * phat + omega_n * shat
        r_n = s - omega_n * t
        # reject non-finite excursions (stabilizer breakdown)
        r2_n = dot(r_n, r_n)
        ok = active & jnp.isfinite(r2_n)
        sel = lambda a, bb: jnp.where(ok, a, bb)
        # BiCGStab residuals are NOT monotone: track the best iterate so a
        # fixed trip count can never return a transiently diverged state
        # (observed: the f32 2D adjoint sweep amplified such states to 1e14).
        better = ok & (r2_n < best_r2)
        best_x = jnp.where(better, x_n, best_x)
        best_r2 = jnp.where(better, r2_n, best_r2)
        return (sel(x_n, x), sel(r_n, r), sel(p_n, p), sel(v_n, v),
                jnp.where(ok, rho_new, rho), jnp.where(ok, alpha_n, alpha),
                jnp.where(ok, omega_n, omega), best_x, best_r2)

    init = (x, r, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
            x, dot(r, r))
    out = jax.lax.fori_loop(0, n_iter, body, init)
    return out[7]  # best iterate


def bicgstab_split(apply_A: Callable, b: jnp.ndarray, apply_Phalf: Callable,
                   apply_Phalf_inv: Callable, tol: float, max_iter: int,
                   x0: jnp.ndarray | None = None,
                   dot_fn: Callable | None = None,
                   sync_pred: Callable | None = None):
    """BiCGStab on the SPLIT-preconditioned system P^-1/2 A P^-1/2.

    Right preconditioning leaves Krylov residuals in the RAW system's metric;
    for operators with a biharmonic (lambda^2) part the raw condition number
    is ~1e6 and float32 cannot reduce the relative residual below
    eps * cond = O(1) — the 2D adjoint solve diverged/NaN'd in f32 for
    exactly this reason. Conditioning the system BEFORE Krylov sees it keeps
    every iterate O(1)-scaled: achievable accuracy becomes
    eps * cond(P^-1/2 A P^-1/2) ~ 1e-5.

    apply_Phalf(v)     ~ P^{-1/2} v  (e.g. cosine basis, diag 1/sqrt(denom))
    apply_Phalf_inv(v) ~ P^{+1/2} v  (used to transform the warm start)
    Solves A x = b; returns x = P^{-1/2} y.
    """
    bt = apply_Phalf(b)
    y0 = None if x0 is None else apply_Phalf_inv(x0)

    def apply_At(v):
        return apply_Phalf(apply_A(apply_Phalf(v)))

    y = bicgstab(apply_At, bt, lambda v: v, tol=tol, max_iter=max_iter,
                 x0=y0, dot_fn=dot_fn, sync_pred=sync_pred)
    return apply_Phalf(y)


def bicgstab_split_fixed(apply_A: Callable, b: jnp.ndarray,
                         apply_Phalf: Callable, apply_Phalf_inv: Callable,
                         n_iter: int, x0: jnp.ndarray | None = None,
                         dot_fn: Callable | None = None):
    """Fixed-trip-count variant of bicgstab_split (see both docstrings).

    Same split conditioning, with the bicgstab_fixed freeze/best-iterate
    policy — the float32 adjoint step solve (full-memory and low-memory
    sweeps)."""
    bt = apply_Phalf(b)
    y0 = None if x0 is None else apply_Phalf_inv(x0)

    def apply_At(v):
        return apply_Phalf(apply_A(apply_Phalf(v)))

    y = bicgstab_fixed(apply_At, bt, lambda v: v, n_iter=n_iter, x0=y0,
                       dot_fn=dot_fn)
    return apply_Phalf(y)


# ---------------------------------------------------------------------------
# 1D Newton Schur solve (dense, batched)
# ---------------------------------------------------------------------------

def newton_schur_solve_1d(L: jnp.ndarray, phi: jnp.ndarray,
                          Rphi: jnp.ndarray, Rmu: jnp.ndarray,
                          dt, tau: float, c1: float, kappa: float,
                          delta_sep: float):
    """Solve the coupled Newton system exactly via dense Schur elimination.

    Returns (dphi, dmu), identical (to roundoff) to the reference's monolithic
    np.linalg.solve on the 2(N+1) block system (Forward_solver.py:180-190).
    """
    n = phi.shape[-1]
    dtype = phi.dtype
    d = 2.0 * c1 / (1.0 - phi * phi)          # diagonal of D (|phi|<1 enforced)
    I = jnp.eye(n, dtype=dtype)
    # S = (1/dt) I + (kappa/2) L^2 - (tau/dt) L - L D
    LD = L * d[None, :]                        # L @ diag(d)
    S = (1.0 / dt) * I + (0.5 * kappa) * (L @ L) - (tau / dt) * L - LD
    rhs = L @ Rphi - Rmu
    dphi = jnp.linalg.solve(S, rhs)
    Kpp_dphi = -(0.5 * kappa) * (L @ dphi) + (tau / dt + d) * dphi
    dmu = 2.0 * (Kpp_dphi + Rphi)
    return dphi, dmu


class SpectralOp1D(NamedTuple):
    """Host-precomputed constants for 1D operators on an (N+1) grid."""

    L: jnp.ndarray
    V: jnp.ndarray
    Vinv: jnp.ndarray
    lam: jnp.ndarray


def make_spectral_op_1d(N: int, h: float, dtype=jnp.float64) -> SpectralOp1D:
    L = laplacian_matrix_neumann(N, h)
    lam, V, Vinv = neumann_eigendecomposition(N, h)
    as_j = lambda a: jnp.asarray(a, dtype=dtype)
    return SpectralOp1D(as_j(L), as_j(V), as_j(Vinv), as_j(lam))


def newton_schur_solve_1d_spectral(op: SpectralOp1D, phi: jnp.ndarray,
                                   Rphi: jnp.ndarray, Rmu: jnp.ndarray,
                                   dt, tau: float, c1: float, kappa: float,
                                   delta_sep: float, tol: float = 1e-9,
                                   max_iter: int = 100,
                                   fixed_iters: int | None = None):
    """Matrix-free 1D Schur solve — O(N^2) matmuls instead of O(N^3) LU.

    Same system as newton_schur_solve_1d; preferred for large N and for
    big scenario batches where a batched dense LU of (N+1)^2 systems per
    Newton iteration dominates (BASELINE.md config 2: N=512 x 256
    scenarios). The cosine-diagonal preconditioner is identical in spirit
    to the 2D one.
    """
    d = 2.0 * c1 / (1.0 - phi * phi)
    dbar = jnp.mean(d)
    L = op.L

    def lap(v):
        return v @ L.T

    def apply_S(v):
        u = (tau / dt + d) * v - 0.5 * kappa * lap(v)
        return (1.0 / dt) * v - lap(u)

    denom = (1.0 / dt) + 0.5 * kappa * op.lam ** 2 - (tau / dt + dbar) * op.lam

    def apply_M(v):
        return ((v @ op.Vinv.T) / denom) @ op.V.T

    rhs = lap(Rphi) - Rmu
    if fixed_iters is not None:
        dphi = bicgstab_fixed(apply_S, rhs, apply_M, n_iter=fixed_iters)
    else:
        dphi = bicgstab(apply_S, rhs, apply_M, tol=tol, max_iter=max_iter)
    Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau / dt + d) * dphi
    dmu = 2.0 * (Kpp_dphi + Rphi)
    return dphi, dmu


# ---------------------------------------------------------------------------
# 2D Newton Schur solve (matrix-free, spectral-preconditioned BiCGStab)
# ---------------------------------------------------------------------------

def newton_schur_solve_2d(op: SpectralOp2D, phi: jnp.ndarray,
                          Rphi: jnp.ndarray, Rmu: jnp.ndarray,
                          dt, tau: float, c1: float, kappa: float,
                          delta_sep: float, tol: float = 1e-9,
                          max_iter: int = 200,
                          fixed_iters: int | None = None):
    """2D version of the exact Schur solve; fields are (Nx+1, Ny+1).

    The Jacobian diagonal uses the reference's safety clip
    phi^2 <= 1 - delta_sep^2 (Forward2_solver.py:243-244).
    fixed_iters selects the fixed-trip-count Krylov variant (float32 path).
    """
    phi_sq = jnp.clip(phi * phi, 0.0, 1.0 - delta_sep * delta_sep)
    d = 2.0 * c1 / (1.0 - phi_sq)
    dbar = jnp.mean(d)
    lap = partial(apply_laplacian_2d, op.Lx, op.Ly)

    def apply_S(v):
        # S v = (1/dt) v - L[ (tau/dt + d) v - (kappa/2) L v ]
        u = (tau / dt + d) * v - 0.5 * kappa * lap(v)
        return (1.0 / dt) * v - lap(u)

    denom = (1.0 / dt) + 0.5 * kappa * op.lam ** 2 - (tau / dt + dbar) * op.lam

    def apply_M(v):
        # exact inverse of S with d replaced by its mean (cosine-diagonal)
        return from_spectral(op, to_spectral(op, v) / denom)

    rhs = lap(Rphi) - Rmu
    if fixed_iters is not None:
        dphi = bicgstab_fixed(apply_S, rhs, apply_M, n_iter=fixed_iters)
    else:
        dphi = bicgstab(apply_S, rhs, apply_M, tol=tol, max_iter=max_iter)
    Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau / dt + d) * dphi
    dmu = 2.0 * (Kpp_dphi + Rphi)
    return dphi, dmu
