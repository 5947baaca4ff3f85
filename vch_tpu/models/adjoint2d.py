"""2D adjoint (p, q, r) backward solver, a reverse `lax.scan`.

Implements the reference's 2D adjoint scheme (backward2_solver.py:75-246)
with the same operators (L^2 without kappa; see adjoint1d.py notes):

    A(phi_n)   = I - tau L + (dt/2) L^2 - (dt/2) diag(f''(phi_n)) L
    B(phi_np1) = I - tau L - (dt/2) L^2 + (dt/2) diag(f''(phi_np1)) L
    terminal: (I - tau L) p_T = b2 (phi_T - phi_Omega);  q = -L p;  r_T = 0.

Structured solves replace scipy spsolve (backward2_solver.py:185, :229):
  - the terminal operator (I - tau L) is constant-coefficient, hence EXACTLY
    diagonal in the cosine basis — solved with two transform matmul pairs;
  - the per-step A solve is matrix-free BiCGStab preconditioned by the
    cosine-diagonal operator with f'' replaced by its mean, warm-started
    from p_{n+1}.
Steps with dt <= 1e-14 copy the next level (backward2_solver.py:212-216).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import ForwardSolverConfig2D
from vch_tpu.ops.laplacian import apply_laplacian_2d
from vch_tpu.ops.linsolve import (bicgstab_split, bicgstab_split_fixed,
                                  make_spectral_op_2d, from_spectral,
                                  to_spectral)
from vch_tpu.ops.potential import fpp_log


class AdjointSolver2D:
    """Jit-compiled backward sweep producing (p, q, r) on the forward grid."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None):
        self.config = config or ForwardSolverConfig2D()
        cfg = self.config
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.hx, self.hy = cfg.Lx / cfg.Nx, cfg.Ly / cfg.Ny
        self.op = make_spectral_op_2d(cfg.Nx, cfg.Ny, self.hx, self.hy,
                                      dtype=self.dtype)
        # see forward2d: f32 cannot resolve 1e-9 relative residuals
        self.krylov_tol = (cfg.krylov_tol if self.dtype == jnp.float64
                           else max(cfg.krylov_tol, 1e-6))
        self._krylov_fixed = (None if self.dtype == jnp.float64
                              else (cfg.adjoint_krylov_fixed_iters
                                    or cfg.krylov_fixed_iters))
        self._run = jax.jit(self._run_impl)

    def _terminal(self, phi_T, phi_T_target, b2):
        """(I - tau L) p_T = b2 (phi_T - phi_Omega), exactly, in the cosine
        basis; q_T = -L p_T; r_T = 0."""
        op = self.op
        rhs_T = b2 * (phi_T - phi_T_target)
        p_T = from_spectral(op, to_spectral(op, rhs_T)
                            / (1.0 - self.config.tau * op.lam))
        q_T = -apply_laplacian_2d(op.Lx, op.Ly, p_T)
        return p_T, q_T, jnp.zeros_like(p_T)

    def _step(self, carry, phi_n, phi_np1, src_n, src_np1, dt, b1):
        """One backward step (p, q, r)_{n+1} -> (p, q, r)_n. Shared by the
        full sweep and the checkpointed one (models/lowmem.py), so both
        run the same program."""
        cfg = self.config
        op = self.op
        tau, gamma, c1, c2 = cfg.tau, cfg.gamma, cfg.c1, cfg.c2
        lap = partial(apply_laplacian_2d, op.Lx, op.Ly)
        p_next, q_next, r_next = carry

        fpp_n = fpp_log(phi_n, c1, c2)
        fpp_np1 = fpp_log(phi_np1, c1, c2)
        fbar = jnp.mean(fpp_n)

        # rhs = B(phi_np1) p_{n+1} + src
        w1 = lap(p_next)
        Bp = p_next - tau * w1 - 0.5 * dt * lap(w1) + 0.5 * dt * fpp_np1 * w1
        rhs = Bp + 0.5 * dt * b1 * (src_n + src_np1)

        def apply_A(v):
            w = lap(v)
            return v - tau * w + 0.5 * dt * (lap(w) - fpp_n * w)

        denom = (1.0 - tau * op.lam + 0.5 * dt * op.lam ** 2
                 - 0.5 * dt * fbar * op.lam)
        inv_sqrt_denom = jax.lax.rsqrt(jnp.abs(denom))

        def apply_Phalf(v):
            return from_spectral(op, to_spectral(op, v) * inv_sqrt_denom)

        def apply_Phalf_inv(v):
            return from_spectral(op, to_spectral(op, v) / inv_sqrt_denom)

        # split-preconditioned Krylov: the raw adjoint operator is
        # biharmonic-dominated (condition ~1e6) and f32 Krylov on it
        # stalls at eps*cond = O(1) relative error (observed as a 1e14
        # blow-up of the backward sweep); conditioning the system before
        # Krylov keeps iterates O(1)-scaled and restores f32 accuracy.
        if self._krylov_fixed is not None:
            p_n = bicgstab_split_fixed(apply_A, rhs, apply_Phalf,
                                       apply_Phalf_inv,
                                       n_iter=self._krylov_fixed, x0=p_next)
        else:
            p_n = bicgstab_split(apply_A, rhs, apply_Phalf, apply_Phalf_inv,
                                 tol=self.krylov_tol,
                                 max_iter=cfg.krylov_max_iter, x0=p_next)
        q_n = -lap(p_n)
        den = gamma + 0.5 * dt
        r_n = ((gamma - 0.5 * dt) / den * r_next
               + 0.5 * dt / den * (q_n + q_next))

        skip = dt <= 1e-14
        return (jnp.where(skip, p_next, p_n),
                jnp.where(skip, q_next, q_n),
                jnp.where(skip, r_next, r_n))

    def _run_impl(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        p_T, q_T, r_T = self._terminal(phi_hist[-1], phi_T_target, b2)
        src_all = phi_hist - phi_Q

        def step(carry, inp):
            out = self._step(carry, *inp, b1)
            return out, out

        inputs = (phi_hist[:-1], phi_hist[1:], src_all[:-1], src_all[1:], dts)
        _, (p_rev, q_rev, r_rev) = jax.lax.scan(
            step, (p_T, q_T, r_T), inputs, reverse=True)

        p = jnp.concatenate([p_rev, p_T[None]], axis=0)
        q = jnp.concatenate([q_rev, q_T[None]], axis=0)
        r = jnp.concatenate([r_rev, r_T[None]], axis=0)
        return p, q, r

    def run(self, phi_hist, t_hist, b1: float, b2: float,
            phi_Q: Optional[np.ndarray] = None,
            phi_T_target: Optional[np.ndarray] = None):
        dtype = self.dtype
        phi_hist = jnp.asarray(phi_hist, dtype)
        t = np.asarray(t_hist, dtype=np.float64)
        dts = jnp.asarray(np.diff(t), dtype)
        if phi_Q is None:
            phi_Q = jnp.zeros_like(phi_hist)
        else:
            phi_Q = jnp.asarray(phi_Q, dtype)
        if phi_T_target is None:
            phi_T_target = jnp.zeros(phi_hist.shape[-2:], dtype)
        else:
            phi_T_target = jnp.asarray(phi_T_target, dtype)
        return self._run(phi_hist, dts, float(b1), float(b2), phi_Q,
                         phi_T_target)
