"""2D viscous Cahn–Hilliard forward solver in JAX.

Re-architecture of the reference's sparse-LU-based 2D solver
(ref: Forward2_solver.py:323-427 Newton, :489-608 marcher) as:

  - `lax.scan` time marcher over a static dt schedule,
  - Newton via `lax.while_loop` whose linear solve is the exact Schur
    complement system solved MATRIX-FREE by spectral-preconditioned BiCGStab
    (ops/linsolve.py) — the Laplacian and cosine transforms are dense 1D
    matmuls, replacing scipy spsolve on 2*Nloc unknowns
    (Forward2_solver.py:370), the dominant cost of the reference program
    (SURVEY.md section 3.2),
  - 2D Newton semantics preserved: mu re-initialized from the energy gradient
    at phi_old with w_new (:351), step ceiling starting at alpha_max=2.0 with
    0.9 safety (:377-391), Armijo eta=1e-4 with best-trial fallback and NO
    in-bounds recheck (:393-426), up to 500 iterations,
  - interior-only mass correction with margin 5e-3 and uniform fallback
    (:564-577).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu.models.forward1d import MarchStats, solve_w
from vch_tpu.models.timegrid import build_dt_schedule, t_history
from vch_tpu.ops.grids import grid_2d
from vch_tpu.ops.laplacian import apply_laplacian_2d
from vch_tpu.ops.linsolve import make_spectral_op_2d, newton_schur_solve_2d
from vch_tpu.ops.potential import f_prime, init_phi_random_2d, regularized_log


def mu_residual_2d(op, phi_new, phi_old, mu_new, mu_old, dt):
    return ((phi_new - phi_old) / dt
            - 0.5 * apply_laplacian_2d(op.Lx, op.Ly, mu_new + mu_old))


def phi_residual_2d(op, phi_new, phi_old, mu_new, mu_old, w_new, w_old,
                    dt, tau, c1, c2, kappa, delta_sep):
    lap_avg = 0.5 * apply_laplacian_2d(op.Lx, op.Ly, phi_new + phi_old)
    f_cvx = c1 * regularized_log(phi_new, delta_sep)
    f_ccv = -2.0 * c2 * phi_old
    return (tau * (phi_new - phi_old) / dt - kappa * lap_avg
            + f_cvx + f_ccv - 0.5 * (mu_new + mu_old) - 0.5 * (w_new + w_old))


def _step_ceiling_2d(phi, dphi, delta_sep):
    """Ref Forward2_solver.py:377-391: alpha_max starts at 2.0, 0.9 safety
    inside the per-sign minima, fallback 1.0, then alpha = min(1, alpha_max)."""
    big = jnp.asarray(jnp.inf, phi.dtype)
    ratio_pos = jnp.where(dphi > 0, (1.0 - delta_sep - phi) / dphi, big)
    ratio_neg = jnp.where(dphi < 0, (-1.0 + delta_sep - phi) / dphi, big)
    amax = jnp.minimum(jnp.asarray(2.0, phi.dtype),
                       jnp.minimum(0.9 * jnp.min(ratio_pos),
                                   0.9 * jnp.min(ratio_neg)))
    bad = ~jnp.isfinite(amax) | (amax <= 0)
    amax = jnp.where(bad, 1.0, amax)
    return jnp.minimum(1.0, amax)


def newton_2d(op, phi_old, mu_old, w_old, w_new, dt, tau, c1, c2, kappa,
              delta_sep, tol, max_iter, krylov_tol, krylov_max_iter,
              mu_init, record_history: bool = False,
              rtol: float = 0.0, stagnation_exit: bool = False,
              krylov_fixed: int | None = None,
              return_iters: bool = False):
    """2D monolithic Newton with best-trial-fallback Armijo.

    rtol / stagnation_exit are the float32 robustness guards described in
    forward1d.newton_1d (relative convergence + no-progress exit).
    return_iters appends the measured count of Newton linear solves."""
    dtype = phi_old.dtype

    def resid(phi, mu):
        Rphi = phi_residual_2d(op, phi, phi_old, mu, mu_old, w_new, w_old,
                               dt, tau, c1, c2, kappa, delta_sep)
        Rmu = mu_residual_2d(op, phi, phi_old, mu, mu_old, dt)
        norm = jnp.sqrt(jnp.sum(Rphi * Rphi) + jnp.sum(Rmu * Rmu))
        return norm, Rphi, Rmu

    hist0 = jnp.full((max_iter + 1,), jnp.nan, dtype) if record_history else None

    def armijo(phi, mu, dphi, dmu, norm_R):
        eta = 1e-4
        alpha0 = _step_ceiling_2d(phi, dphi, delta_sep)

        def cond(c):
            return (~c[6]) & (c[7] < 12)

        def body(c):
            alpha, phi_a, mu_a, best_norm, best_phi, best_mu, _, j = c
            phi_t = phi + alpha * dphi
            mu_t = mu + alpha * dmu
            norm_t, _, _ = resid(phi_t, mu_t)
            better = norm_t < best_norm
            best_norm = jnp.where(better, norm_t, best_norm)
            best_phi = jnp.where(better, phi_t, best_phi)
            best_mu = jnp.where(better, mu_t, best_mu)
            accept = norm_t <= (1.0 - eta * alpha) * norm_R
            phi_a = jnp.where(accept, phi_t, phi_a)
            mu_a = jnp.where(accept, mu_t, mu_a)
            alpha = jnp.where(accept, alpha, alpha * 0.5)
            return (alpha, phi_a, mu_a, best_norm, best_phi, best_mu,
                    accept, j + 1)

        big = jnp.asarray(jnp.inf, dtype)
        init = (alpha0, phi, mu, big, phi, mu, jnp.asarray(False),
                jnp.asarray(0, jnp.int32))
        (_, phi_a, mu_a, best_norm, best_phi, best_mu, accepted,
         _) = jax.lax.while_loop(cond, body, init)
        # fallback: best trial if it improved on norm_R, else unchanged
        use_best = (~accepted) & (best_norm < norm_R)
        phi_out = jnp.where(accepted, phi_a, jnp.where(use_best, best_phi, phi))
        mu_out = jnp.where(accepted, mu_a, jnp.where(use_best, best_mu, mu))
        return phi_out, mu_out

    def cond(carry):
        return (~carry[4]) & (carry[3] < max_iter)

    bignorm = jnp.asarray(jnp.inf, dtype)

    def body(carry):
        phi, mu, hist, k, done, norm0, prev_norm, nsolve = carry
        norm_R, Rphi, Rmu = resid(phi, mu)
        if record_history:
            hist = hist.at[k].set(norm_R)
        norm0 = jnp.where(k == 0, norm_R, norm0)
        converged = norm_R < tol
        if rtol > 0:
            converged = converged | (norm_R < rtol * norm0)
        if stagnation_exit:
            converged = converged | ((k > 0) & (norm_R >= prev_norm))

        def take_step(args):
            phi, mu = args
            dphi, dmu = newton_schur_solve_2d(
                op, phi, Rphi, Rmu, dt, tau, c1, kappa, delta_sep,
                tol=krylov_tol, max_iter=krylov_max_iter,
                fixed_iters=krylov_fixed)
            return armijo(phi, mu, dphi, dmu, norm_R)

        phi_n, mu_n = jax.lax.cond(converged, lambda a: a, take_step, (phi, mu))
        nsolve = nsolve + jnp.where(converged, 0, 1).astype(jnp.int32)
        return (phi_n, mu_n, hist, k + 1, converged, norm0, norm_R, nsolve)

    init = (phi_old, mu_init, hist0, jnp.asarray(0, jnp.int32),
            jnp.asarray(False), bignorm, bignorm, jnp.asarray(0, jnp.int32))
    phi, mu, hist, _, _, _, _, k = jax.lax.while_loop(cond, body, init)
    out = (phi, mu)
    if record_history:
        out = out + (hist,)
    if return_iters:
        out = out + (k,)
    return out


class ForwardSolver2D:
    """Jit-compiled 2D forward simulator with reference-compatible outputs."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None):
        self.config = config or ForwardSolverConfig2D()
        cfg = self.config
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        (self.x, self.y), (self.hx, self.hy), self._wts_h = grid_2d(
            cfg.Nx, cfg.Ny, cfg.Lx, cfg.Ly)
        self.op = make_spectral_op_2d(cfg.Nx, cfg.Ny, self.hx, self.hy,
                                      dtype=self.dtype)
        # f32 cannot resolve relative residuals below ~1e-6: clamp the inner
        # Krylov tolerance so BiCGStab exits instead of spinning to max_iter.
        self.krylov_tol = (cfg.krylov_tol if self.dtype == jnp.float64
                           else max(cfg.krylov_tol, 1e-6))
        self._rtol = 0.0 if self.dtype == jnp.float64 else cfg.newton_rtol
        self._stagnation = self.dtype != jnp.float64
        # f32 path: fixed-trip Krylov (smaller program, no barriers)
        self._krylov_fixed = (None if self.dtype == jnp.float64
                              else cfg.krylov_fixed_iters)
        # Forward matmul precision: None inherits the package-global
        # "highest". On the H100 "high" lowers to a TF32 cuBLAS gemm
        # (3e-4 relative error per product); its noise floor sits above the
        # relative Newton exit, and the 64x64 float32 sweep then took 6x the
        # Newton solves of "highest" for no accuracy gain.
        self._fwd_precision = cfg.forward_matmul_precision
        self.dts = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts, cfg.T)
        self.M = len(self.dts)
        self._simulate = jax.jit(self._march_impl)
        self.last_stats = None

    def default_initial_phi(self) -> np.ndarray:
        """Seed-42 Gaussian IC with interior mass fix, bit-identical to
        Forward2_solver.py:517 (amp=0.1)."""
        return init_phi_random_2d(self.config.Nx, self.config.Ny, DELTA_SEP,
                                  amp=0.1, seed=42)

    def initialize_mu(self, phi, w):
        cfg = self.config
        lap = apply_laplacian_2d(self.op.Lx, self.op.Ly, phi)
        return -cfg.kappa * lap + f_prime(phi, cfg.c1, cfg.c2, DELTA_SEP) - w

    def _simulate_impl(self, u, phi0):
        """Trajectory only (stats dropped) — the shape-stable inner API."""
        phi_hist, _ = self._march_impl(u, phi0)
        return phi_hist

    def matmul_precision(self):
        """Context applying the forward solver's matmul precision (a no-op
        when it inherits the package default)."""
        if self._fwd_precision is None:
            return contextlib.nullcontext()
        return jax.default_matmul_precision(self._fwd_precision)

    def _march_impl(self, u, phi0):
        with self.matmul_precision():
            return self._simulate_body(u, phi0)

    def _step(self, phi, mu, w, u_n, u_np1, dt, m0):
        """One Crank-Nicolson step: Newton solve, clip, interior-only mass
        correction (ref :564-577). Shared by the full march and the
        checkpointed one (models/lowmem.py), so both run the same program.
        Returns (phi, mu, w, newton_solves, mass_error before correction)."""
        cfg = self.config
        wts_h = jnp.asarray(self._wts_h, self.dtype)
        lo, hi = -1.0 + DELTA_SEP, 1.0 - DELTA_SEP
        w_new = solve_w(w, dt, cfg.gamma, u_n, u_np1)
        mu_init = self.initialize_mu(phi, w_new)
        phi_new, mu_new, k = newton_2d(
            self.op, phi, mu, w, w_new, dt, cfg.tau, cfg.c1, cfg.c2,
            cfg.kappa, DELTA_SEP, cfg.newton_tol, cfg.newton_max_iter,
            self.krylov_tol, cfg.krylov_max_iter, mu_init, rtol=self._rtol,
            stagnation_exit=self._stagnation,
            krylov_fixed=self._krylov_fixed, return_iters=True)
        phi_c = jnp.clip(phi_new, lo, hi)
        mass_error = jnp.sum(wts_h * phi_c) - m0
        interior = jnp.abs(phi_c) < (1.0 - DELTA_SEP - 5e-3)
        Wint = jnp.sum(jnp.where(interior, wts_h, 0.0))
        corrected = jnp.where(interior, phi_c - mass_error / Wint, phi_c)
        fallback = jnp.clip(phi_c - mass_error / (cfg.Lx * cfg.Ly), lo, hi)
        needs_fix = jnp.abs(mass_error) > 1e-16
        phi_c = jnp.where(needs_fix,
                          jnp.where(Wint > 0, corrected, fallback), phi_c)
        return phi_c, mu_new, w_new, k, mass_error

    def _simulate_body(self, u, phi0):
        wts_h = jnp.asarray(self._wts_h, self.dtype)
        dts = jnp.asarray(self.dts, self.dtype)
        w0 = jnp.zeros_like(phi0)
        mu0 = self.initialize_mu(phi0, w0)
        m0 = jnp.sum(wts_h * phi0)

        def step(carry, inp):
            phi, mu, w, nsolve, first_bad, idx = carry
            phi_c, mu_new, w_new, k, mass_error = self._step(
                phi, mu, w, *inp, m0)
            # runtime sanitizer (ref Forward_solver.py:166-172 analog)
            bad = ~jnp.isfinite(mass_error)
            first_bad = jnp.where((first_bad < 0) & bad, idx, first_bad)
            return (phi_c, mu_new, w_new, nsolve + k, first_bad,
                    idx + 1), phi_c

        inputs = (u[:-1], u[1:], dts)
        carry0 = (phi0, mu0, w0, jnp.asarray(0, jnp.int32),
                  jnp.asarray(-1, jnp.int32), jnp.asarray(0, jnp.int32))
        (_, _, _, nsolve, first_bad, _), phis = jax.lax.scan(
            step, carry0, inputs)
        phi_hist = jnp.concatenate([phi0[None], phis], axis=0)
        return phi_hist, MarchStats(nsolve, first_bad)

    def simulate(self, control: Optional[np.ndarray] = None,
                 initial_phi: Optional[np.ndarray] = None):
        """Run the 2D forward simulation; returns (phi_hist, (x, y), t_hist).

        control: (M+1, Nx+1, Ny+1) step-aligned array or None. (The 2D
        reference has no duplicated history row, so core layout == ref layout.)
        """
        cfg = self.config
        shape = (cfg.Nx + 1, cfg.Ny + 1)
        phi0 = (self.default_initial_phi() if initial_phi is None
                else np.asarray(initial_phi, np.float64))
        if control is None:
            u = jnp.zeros((self.M + 1,) + shape, self.dtype)
        else:
            u = jnp.asarray(control, self.dtype)
            assert u.shape == (self.M + 1,) + shape, (
                f"control must be (M+1, Nx+1, Ny+1) = {(self.M+1,) + shape}; "
                f"got {u.shape}")
        phi_hist, stats = self._simulate(u, jnp.asarray(phi0, self.dtype))
        self.last_stats = MarchStats(*map(np.asarray, stats))
        bad = int(stats.first_bad_step)
        if bad >= 0:
            raise RuntimeError(
                f"Non-finite mass defect at time step {bad} — solution "
                f"diverged (see Forward_solver.py:166-172 semantics).")
        return phi_hist, (self.x, self.y), self.t_hist

    def energy_history(self, phi_hist, w_hist=None, eps=None):
        """Free energy per stored frame (ref COMPUTE_ENERGY flag semantics,
        Forward2_solver.py:48-50, :552-561 — but vectorized over the whole
        history instead of per-step prints; energy decrease is the
        dissipation diagnostic the reference prints as Delta-E)."""
        from vch_tpu.ops.potential import free_energy_2d
        cfg = self.config
        return free_energy_2d(jnp.asarray(phi_hist, self.dtype), cfg.kappa,
                              cfg.c1, cfg.c2, self.hx, self.hy,
                              w=None if w_hist is None else jnp.asarray(w_hist, self.dtype),
                              eps=0.5 * DELTA_SEP if eps is None else eps)

    def newton_residual_history(self, phi_old, mu_old, w_old, w_new, dt):
        cfg = self.config
        d = self.dtype
        mu_init = self.initialize_mu(jnp.asarray(phi_old, d), jnp.asarray(w_new, d))
        phi, mu, hist = newton_2d(
            self.op, jnp.asarray(phi_old, d), jnp.asarray(mu_old, d),
            jnp.asarray(w_old, d), jnp.asarray(w_new, d), dt, cfg.tau, cfg.c1,
            cfg.c2, cfg.kappa, DELTA_SEP, cfg.newton_tol, cfg.newton_max_iter,
            self.krylov_tol, cfg.krylov_max_iter, mu_init, record_history=True,
            rtol=self._rtol, stagnation_exit=self._stagnation,
            krylov_fixed=self._krylov_fixed)
        hist = np.asarray(hist)
        return phi, mu, list(hist[~np.isnan(hist)])
