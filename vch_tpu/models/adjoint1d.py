"""1D adjoint (p, q, r) backward solver, a reverse `lax.scan`.

Implements the reference's optimize-then-discretize adjoint scheme
(ref: backward_solver.py:48-125) exactly — including its quirks, which the
rebuild consciously reproduces for gradient parity (SURVEY.md section 5):

  - operators A/B use L^2 WITHOUT a kappa factor:
      A(phi_n)   = I - tau L + (dt/2) L^2 - (dt/2) diag(f''(phi_n)) L
      B(phi_np1) = I - tau L - (dt/2) L^2 + (dt/2) diag(f''(phi_np1)) L
  - terminal solve (I - tau L) p_T = b2 (phi_T - phi_Omega); q = -L p; r_T = 0
  - r backward CN recursion r_n = [(g-dt/2) r_{n+1} + (dt/2)(q_n+q_{n+1})]/(g+dt/2)
  - steps with dt <= 0 are skipped leaving p,q,r at ZERO (this is what the
    reference does for the duplicated t=0 history row: `continue` at :110
    leaves the allocated zeros in place).

Unlike the reference (which binds tau/gamma/c1/c2/kappa from a DEFAULT config
at import time, backward_solver.py:29-33), this solver threads the runtime
config — identical results for default physics, correct results otherwise.

Each step is one dense (N+1) linear solve; under vmap over scenarios these
become batched LUs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import ForwardSolverConfig1D
from vch_tpu.ops.laplacian import laplacian_matrix_neumann
from vch_tpu.ops.linsolve import bicgstab_split, make_spectral_op_1d
from vch_tpu.ops.potential import fpp_log


class AdjointSolver1D:
    """Jit-compiled backward sweep producing (p, q, r) on the forward grid."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None):
        self.config = config or ForwardSolverConfig1D()
        cfg = self.config
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.h = cfg.Lx / cfg.N
        self._L_np = laplacian_matrix_neumann(cfg.N, self.h)
        # dense per-step LU for parity-scale f64; matrix-free spectral
        # BiCGStab otherwise (same rule as ForwardSolver1D)
        self._use_spectral = (
            cfg.linsolve_1d == "spectral"
            or (cfg.linsolve_1d == "auto"
                and (self.dtype != jnp.float64 or cfg.N > 256)))
        self._op1d = (make_spectral_op_1d(cfg.N, self.h, self.dtype)
                      if self._use_spectral else None)
        self._krylov_fixed = (None if self.dtype == jnp.float64
                              else (cfg.adjoint_krylov_fixed_iters
                                    or cfg.krylov_fixed_iters))
        self._krylov_tol = (cfg.krylov_tol if self.dtype == jnp.float64
                            else max(cfg.krylov_tol, 1e-6))
        self._run = jax.jit(self._run_impl)

    def _run_impl(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        cfg = self.config
        dtype = self.dtype
        L = jnp.asarray(self._L_np, dtype)
        L2 = L @ L
        I = jnp.eye(L.shape[0], dtype=dtype)
        tau, gamma, c1, c2 = cfg.tau, cfg.gamma, cfg.c1, cfg.c2

        # Terminal conditions ((I - tau L): exact cosine-diagonal solve on
        # the spectral path, dense solve on the parity path)
        rhs_T = b2 * (phi_hist[-1] - phi_T_target)
        if self._op1d is not None:
            op = self._op1d
            p_T = ((rhs_T @ op.Vinv.T) / (1.0 - tau * op.lam)) @ op.V.T
        else:
            p_T = jnp.linalg.solve(I - tau * L, rhs_T)
        q_T = -(p_T @ L.T)
        r_T = jnp.zeros_like(p_T)

        src_all = phi_hist - phi_Q

        def step(carry, inp):
            p_next, q_next, r_next = carry
            phi_n, phi_np1, src_n, src_np1, dt = inp

            fpp_n = fpp_log(phi_n, c1, c2)
            fpp_np1 = fpp_log(phi_np1, c1, c2)
            # B p = (I - tau L - (dt/2) L^2 + (dt/2) diag(fpp_np1) L) p
            w1 = p_next @ L.T
            Bp = (p_next - tau * w1 - 0.5 * dt * (w1 @ L.T)
                  + 0.5 * dt * fpp_np1 * w1)
            rhs = Bp + 0.5 * dt * b1 * (src_n + src_np1)
            if self._op1d is not None:
                op = self._op1d
                fbar = jnp.mean(fpp_n)

                def apply_A(v):
                    w = v @ L.T
                    return v - tau * w + 0.5 * dt * ((w @ L.T) - fpp_n * w)

                denom = (1.0 - tau * op.lam + 0.5 * dt * op.lam ** 2
                         - 0.5 * dt * fbar * op.lam)
                inv_sqrt_denom = jax.lax.rsqrt(jnp.abs(denom))

                def apply_Phalf(v):
                    return ((v @ op.Vinv.T) * inv_sqrt_denom) @ op.V.T

                def apply_Phalf_inv(v):
                    return ((v @ op.Vinv.T) / inv_sqrt_denom) @ op.V.T

                # split-preconditioned Krylov (see adjoint2d: f32 cannot
                # solve the raw biharmonic-dominated system)
                p_n = bicgstab_split(apply_A, rhs, apply_Phalf,
                                     apply_Phalf_inv, tol=self._krylov_tol,
                                     max_iter=200, x0=p_next)
            else:
                # A = I - tau L + (dt/2) L^2 - (dt/2) diag(fpp_n) L
                A = (I - tau * L + 0.5 * dt * L2
                     - 0.5 * dt * (fpp_n[:, None] * L))
                p_n = jnp.linalg.solve(A, rhs)
            q_n = -(p_n @ L.T)
            denom = gamma + 0.5 * dt
            r_n = ((gamma - 0.5 * dt) / denom * r_next
                   + 0.5 * dt / denom * (q_n + q_next))

            # dt <= 0 (duplicated history rows): leave zeros, keep carry frozen
            skip = dt <= 0
            zero = jnp.zeros_like(p_n)
            out = (jnp.where(skip, zero, p_n), jnp.where(skip, zero, q_n),
                   jnp.where(skip, zero, r_n))
            new_carry = (jnp.where(skip, p_next, p_n),
                         jnp.where(skip, q_next, q_n),
                         jnp.where(skip, r_next, r_n))
            return new_carry, out

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
        """Solve the adjoint system backward over the given trajectory.

        Accepts histories in either core layout (M+1 rows) or reference
        layout (duplicated t=0 row); output matches the input layout.
        """
        dtype = self.dtype
        phi_hist = jnp.asarray(phi_hist, dtype)
        t = np.asarray(t_hist, dtype=np.float64)
        dts = jnp.asarray(np.diff(t), dtype)
        if phi_Q is None:
            phi_Q = jnp.zeros_like(phi_hist)
        else:
            phi_Q = jnp.asarray(phi_Q, dtype)
        if phi_T_target is None:
            phi_T_target = jnp.zeros(phi_hist.shape[-1], dtype)
        else:
            phi_T_target = jnp.asarray(phi_T_target, dtype)
        return self._run(phi_hist, dts, float(b1), float(b2), phi_Q,
                         phi_T_target)
