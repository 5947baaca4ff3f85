"""1D viscous Cahn–Hilliard forward solver (Crank–Nicolson + Newton) in JAX.

Re-architecture of the reference's Python time loop + monolithic dense Newton
(ref: Forward_solver.py:139-235, :286-397) as:

  - a `lax.scan` over a statically precomputed dt schedule,
  - Newton via `lax.while_loop` with convex–concave-split CN residuals,
    per-component step ceiling, and Armijo backtracking on the residual norm
    (eta=1e-3, up to 12 halvings; failure terminates the Newton loop, matching
    Forward_solver.py:214-229),
  - the Newton linear solve as an exact dense Schur-complement system in dphi
    (ops/linsolve.py), batched-LU friendly,
  - per-step clip into (-1+delta_sep, 1-delta_sep) and uniform mass projection
    phi -= mass_error/Lx (Forward_solver.py:361-366).

Semantics match the reference step-for-step; `simulate(..., ref_layout=True)`
additionally reproduces the reference's duplicated t=0 history row
(Forward_solver.py:329-337), so histories are drop-in comparable.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import DELTA_SEP, ForwardSolverConfig1D
from vch_tpu.models.timegrid import build_dt_schedule, t_history
from vch_tpu.ops.grids import grid_1d
from vch_tpu.ops.laplacian import laplacian_matrix_neumann
from vch_tpu.ops.linsolve import (make_spectral_op_1d,
    newton_schur_solve_1d, newton_schur_solve_1d_spectral)
from vch_tpu.ops.potential import (
    f_prime,
    init_phi_random_1d,
    regularized_log,
)


def solve_w(w_old, dt, gamma, u_n, u_np1):
    """Closed-form CN update of the control filter gamma*w_t + w = u."""
    gamma_dt = gamma / dt
    return ((gamma_dt - 0.5) * w_old + 0.5 * (u_np1 + u_n)) / (gamma_dt + 0.5)


class MarchStats(NamedTuple):
    """Measured per-run counters from the time marcher.

    newton_solves: total Newton linear solves across all time steps (the
        honest denominator-free count behind BASELINE.md's Newton-solves/s —
        measured from the while_loop trip counts, not estimated).
    first_bad_step: index of the first time step whose mass defect went
        non-finite, or -1. Mirrors the reference's runtime sanitizer
        (Forward_solver.py:166-172) as a jit-safe error channel; the host
        API raises RuntimeError when it is >= 0.
    """

    newton_solves: jnp.ndarray
    first_bad_step: jnp.ndarray


def mu_residual(L, phi_new, phi_old, mu_new, mu_old, dt):
    """CN residual of phi_t - Lap(mu) = 0."""
    return (phi_new - phi_old) / dt - 0.5 * ((mu_new + mu_old) @ L.T)


def phi_residual(L, phi_new, phi_old, mu_new, mu_old, w_new, w_old,
                 dt, tau, c1, c2, kappa, delta_sep):
    """CN residual of tau*phi_t - kappa*Lap(phi) + f'(phi) = mu + w
    with convex(log, implicit)/concave(-2c2 phi, explicit) splitting."""
    lap_avg = 0.5 * ((phi_new + phi_old) @ L.T)
    f_cvx = c1 * regularized_log(phi_new, delta_sep)
    f_ccv = -2.0 * c2 * phi_old
    return (tau * (phi_new - phi_old) / dt - kappa * lap_avg
            + f_cvx + f_ccv - 0.5 * (mu_new + mu_old) - 0.5 * (w_new + w_old))


def _step_ceiling_1d(phi, dphi, delta_sep):
    """Largest alpha keeping phi+alpha*dphi inside the open phase box.

    Mirrors Forward_solver.py:192-212: per-sign min ratios, fallback 1.0 when
    non-finite or <=0, then alpha = min(1, 0.9*alpha_max).
    """
    big = jnp.asarray(jnp.inf, phi.dtype)
    ratio_pos = jnp.where(dphi > 0, (1.0 - delta_sep - phi) / dphi, big)
    ratio_neg = jnp.where(dphi < 0, (-1.0 + delta_sep - phi) / dphi, big)
    alpha_max = jnp.minimum(jnp.min(ratio_pos), jnp.min(ratio_neg))
    bad = ~jnp.isfinite(alpha_max) | (alpha_max <= 0)
    alpha_max = jnp.where(bad, 1.0, alpha_max)
    return jnp.minimum(1.0, 0.9 * alpha_max)


def newton_1d(L, phi_old, mu_old, w_old, w_new, dt, tau, c1, c2, kappa,
              delta_sep, tol, max_iter, record_history: bool = False,
              rtol: float = 0.0, stagnation_exit: bool = False,
              spectral_op=None, krylov_fixed=None, krylov_tol: float = 1e-9,
              return_iters: bool = False):
    """Monolithic Newton on (phi, mu) via exact Schur solve.

    Returns (phi, mu) or (phi, mu, residual_norms) with norms padded by NaN;
    return_iters=True appends the measured iteration count k (the loop's
    trip count, the honest unit behind BASELINE.md's Newton-solves/s).
    Replicates the reference's control flow: convergence test at the top,
    step ceiling, Armijo with in-bounds guard, termination on line-search
    failure (Forward_solver.py:139-235).

    Float32 robustness (no reference analog — the reference is f64-only):
    rtol>0 adds a convergence test relative to the step's FIRST residual
    norm, and stagnation_exit stops when an iteration fails to decrease the
    norm — both prevent the loop from spinning to max_iter when the absolute
    tol sits below the f32 noise floor.
    """
    dtype = phi_old.dtype
    resid = partial(_residual_norm_and_parts, L, phi_old, mu_old, w_new, w_old,
                    dt, tau, c1, c2, kappa, delta_sep)
    hist0 = jnp.full((max_iter + 1,), jnp.nan, dtype) if record_history else None

    def armijo(phi, mu, dphi, dmu, norm_R):
        eta = 1e-3
        alpha0 = _step_ceiling_1d(phi, dphi, delta_sep)

        def cond(c):
            _, _, _, accepted, j = c
            return (~accepted) & (j < 12)

        def body(c):
            alpha, phi_a, mu_a, _, j = c
            phi_t = phi + alpha * dphi
            mu_t = mu + alpha * dmu
            in_bounds = jnp.all(jnp.abs(phi_t) < 1.0 - delta_sep)
            norm_t, _, _ = resid(phi_t, mu_t)
            accept = in_bounds & (norm_t <= (1.0 - eta * alpha) * norm_R)
            phi_a = jnp.where(accept, phi_t, phi_a)
            mu_a = jnp.where(accept, mu_t, mu_a)
            alpha = jnp.where(accept, alpha, alpha * 0.5)
            return (alpha, phi_a, mu_a, accept, j + 1)

        init = (alpha0, phi, mu, jnp.asarray(False), jnp.asarray(0, jnp.int32))
        _, phi_a, mu_a, accepted, _ = jax.lax.while_loop(cond, body, init)
        return phi_a, mu_a, accepted

    def cond(carry):
        return (~carry[4]) & (carry[3] < max_iter)

    big = jnp.asarray(jnp.inf, dtype)

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
            if spectral_op is None:
                dphi, dmu = newton_schur_solve_1d(L, phi, Rphi, Rmu, dt, tau,
                                                  c1, kappa, delta_sep)
            else:  # matrix-free path: large N / big batches / f32
                dphi, dmu = newton_schur_solve_1d_spectral(
                    spectral_op, phi, Rphi, Rmu, dt, tau, c1, kappa,
                    delta_sep, tol=krylov_tol, fixed_iters=krylov_fixed)
            phi_n, mu_n, accepted = armijo(phi, mu, dphi, dmu, norm_R)
            return phi_n, mu_n, ~accepted  # line-search failure => terminate

        phi_n, mu_n, failed = jax.lax.cond(
            converged, lambda a: (a[0], a[1], jnp.asarray(False)),
            take_step, (phi, mu))
        nsolve = nsolve + jnp.where(converged, 0, 1).astype(jnp.int32)
        return (phi_n, mu_n, hist, k + 1, converged | failed, norm0, norm_R,
                nsolve)

    init = (phi_old, mu_old, hist0, jnp.asarray(0, jnp.int32),
            jnp.asarray(False), big, big, jnp.asarray(0, jnp.int32))
    phi, mu, hist, _, _, _, _, k = jax.lax.while_loop(cond, body, init)
    out = (phi, mu)
    if record_history:
        out = out + (hist,)
    if return_iters:
        out = out + (k,)
    return out


def _residual_norm_and_parts(L, phi_old, mu_old, w_new, w_old, dt, tau, c1,
                             c2, kappa, delta_sep, phi, mu):
    Rphi = phi_residual(L, phi, phi_old, mu, mu_old, w_new, w_old,
                        dt, tau, c1, c2, kappa, delta_sep)
    Rmu = mu_residual(L, phi, phi_old, mu, mu_old, dt)
    norm = jnp.sqrt(jnp.sum(Rphi * Rphi) + jnp.sum(Rmu * Rmu))
    return norm, Rphi, Rmu


class ForwardSolver1D:
    """Jit-compiled 1D forward simulator with reference-compatible outputs."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None):
        self.config = config or ForwardSolverConfig1D()
        cfg = self.config
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.x, self.h, self._wts_h = grid_1d(cfg.N, cfg.Lx)
        self._L_np = laplacian_matrix_neumann(cfg.N, self.h)
        self.dts = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts, cfg.T)
        self.M = len(self.dts)
        # f32 robustness: relative tol + stagnation exit (see newton_1d)
        self._rtol = 0.0 if self.dtype == jnp.float64 else cfg.newton_rtol
        self._stagnation = self.dtype != jnp.float64
        # Linear-solve strategy: exact dense Schur LU for parity-scale f64
        # runs; matrix-free spectral BiCGStab for f32 or large N where
        # batched (N+1)^3 LUs would dominate (BASELINE.md config 2).
        self._use_spectral = (
            cfg.linsolve_1d == "spectral"
            or (cfg.linsolve_1d == "auto"
                and (self.dtype != jnp.float64 or cfg.N > 256)))
        self._op1d = (make_spectral_op_1d(cfg.N, self.h, self.dtype)
                      if self._use_spectral else None)
        self._krylov_fixed = (None if self.dtype == jnp.float64
                              else cfg.krylov_fixed_iters)
        self._krylov_tol = (cfg.krylov_tol if self.dtype == jnp.float64
                            else max(cfg.krylov_tol, 1e-6))
        self._simulate = jax.jit(self._march_impl)
        self.last_stats: Optional[MarchStats] = None

    # -- initial state ----------------------------------------------------
    def default_initial_phi(self) -> np.ndarray:
        """Seed-42 Gaussian IC, bit-identical to Forward_solver.py:316."""
        return init_phi_random_1d(self.config.N, DELTA_SEP, amp=0.01, seed=42)

    def initialize_mu(self, phi, w):
        cfg = self.config
        L = jnp.asarray(self._L_np, self.dtype)
        return (-cfg.kappa * (phi @ L.T)
                + f_prime(phi, cfg.c1, cfg.c2, DELTA_SEP) - w)

    # -- core jitted simulation ------------------------------------------
    def _simulate_impl(self, u, phi0):
        """Trajectory only (stats dropped) — the shape-stable inner API."""
        phi_hist, _ = self._march_impl(u, phi0)
        return phi_hist

    def _march_impl(self, u, phi0):
        cfg = self.config
        dtype = self.dtype
        L = jnp.asarray(self._L_np, dtype)
        wts_h = jnp.asarray(self._wts_h, dtype)
        dts = jnp.asarray(self.dts, dtype)
        tau, c1, c2 = cfg.tau, cfg.c1, cfg.c2
        gamma, kappa = cfg.gamma, cfg.kappa

        w0 = jnp.zeros_like(phi0)
        mu0 = self.initialize_mu(phi0, w0)
        m0 = jnp.dot(wts_h, phi0)

        def step(carry, inp):
            phi, mu, w, nsolve, first_bad, idx = carry
            u_n, u_np1, dt = inp
            w_new = solve_w(w, dt, gamma, u_n, u_np1)
            phi_new, mu_new, k = newton_1d(
                L, phi, mu, w, w_new, dt, tau, c1,
                c2, kappa, DELTA_SEP, cfg.newton_tol,
                cfg.newton_max_iter, rtol=self._rtol,
                stagnation_exit=self._stagnation,
                spectral_op=self._op1d,
                krylov_fixed=self._krylov_fixed,
                krylov_tol=self._krylov_tol, return_iters=True)
            phi_c = jnp.clip(phi_new, -1.0 + DELTA_SEP, 1.0 - DELTA_SEP)
            mass_error = jnp.dot(wts_h, phi_c) - m0
            # runtime sanitizer (ref Forward_solver.py:166-172): flag the
            # first step whose mass defect is non-finite
            bad = ~jnp.isfinite(mass_error)
            first_bad = jnp.where((first_bad < 0) & bad, idx, first_bad)
            phi_c = phi_c - mass_error / cfg.Lx
            return (phi_c, mu_new, w_new, nsolve + k, first_bad,
                    idx + 1), phi_c

        inputs = (u[:-1], u[1:], dts)
        carry0 = (phi0, mu0, w0, jnp.asarray(0, jnp.int32),
                  jnp.asarray(-1, jnp.int32), jnp.asarray(0, jnp.int32))
        (_, _, _, nsolve, first_bad, _), phis = jax.lax.scan(
            step, carry0, inputs)
        phi_hist = jnp.concatenate([phi0[None], phis], axis=0)
        return phi_hist, MarchStats(nsolve, first_bad)

    # -- public API -------------------------------------------------------
    def simulate(self, control: Optional[np.ndarray] = None,
                 initial_phi: Optional[np.ndarray] = None,
                 ref_layout: bool = False):
        """Run the forward simulation.

        control: step-aligned (M+1, N+1) array, or reference-layout
            (M+2, N+1) (matching the duplicated-row history), or None.
        Returns (phi_hist, x, t_hist); with ref_layout=True phi_hist/t_hist
        include the reference's duplicated t=0 entry (shape (M+2, N+1)).
        """
        cfg = self.config
        n = cfg.N + 1
        if initial_phi is None:
            phi0 = self.default_initial_phi()
        else:
            phi0 = np.asarray(initial_phi, dtype=np.float64)
        if control is None:
            u = jnp.zeros((self.M + 1, n), self.dtype)
        else:
            u = jnp.asarray(control, self.dtype)
            if u.shape[0] == self.M + 2:      # reference layout: drop dup row
                u = u[: self.M + 1]
            assert u.shape == (self.M + 1, n), (
                f"control must be (M+1, N+1) = ({self.M+1}, {n}); got {u.shape}")
        phi_hist, stats = self._simulate(u, jnp.asarray(phi0, self.dtype))
        self.last_stats = MarchStats(*map(np.asarray, stats))
        bad = int(stats.first_bad_step)
        if bad >= 0:
            # reference behavior: RuntimeError at the offending step
            # (Forward_solver.py:166-172)
            raise RuntimeError(
                f"Non-finite mass defect at time step {bad} — solution "
                f"diverged (see Forward_solver.py:166-172 semantics).")
        t_hist = self.t_hist
        if ref_layout:
            phi_hist = jnp.concatenate([phi_hist[:1], phi_hist], axis=0)
            t_hist = np.concatenate([[0.0], t_hist])
        return phi_hist, self.x, t_hist

    def energy_history(self, phi_hist, w_hist=None, eps=None):
        """Free energy per stored frame (dissipation diagnostic; the
        reference computes this ad hoc in tests, Forward_solver.py:243-262)."""
        from vch_tpu.ops.potential import free_energy_1d
        cfg = self.config
        return free_energy_1d(jnp.asarray(phi_hist, self.dtype), cfg.kappa,
                              cfg.c1, cfg.c2, self.h,
                              w=None if w_hist is None else jnp.asarray(w_hist, self.dtype),
                              eps=1e-8 if eps is None else eps)

    def newton_residual_history(self, phi_old, mu_old, w_old, w_new, dt):
        """Expose Newton residual norms for convergence-order tests
        (ref API: Forward_solver.py return_residual_history)."""
        cfg = self.config
        L = jnp.asarray(self._L_np, self.dtype)
        phi, mu, hist = newton_1d(
            L, jnp.asarray(phi_old, self.dtype), jnp.asarray(mu_old, self.dtype),
            jnp.asarray(w_old, self.dtype), jnp.asarray(w_new, self.dtype),
            dt, cfg.tau, cfg.c1, cfg.c2, cfg.kappa, DELTA_SEP,
            cfg.newton_tol, cfg.newton_max_iter, record_history=True,
            rtol=self._rtol, stagnation_exit=self._stagnation,
            spectral_op=self._op1d, krylov_fixed=self._krylov_fixed,
            krylov_tol=self._krylov_tol)
        hist = np.asarray(hist)
        return phi, mu, list(hist[~np.isnan(hist)])
