"""Proximal gradient descent (ISTA) outer loop with optimistic step,
backtracking line search, plateau detection, and alpha advisor.

Re-architecture of the reference drivers (GD_1D.py:257-609,
GD2_configured.py:231-441): the entire PGD iteration — adjoint sweep,
smooth gradient, prox step, optimistic forward+cost, and the full
backtracking search — is ONE jitted function; the Python host loop only
handles logging, plateau/advisor heuristics, and the stopping test on
scalars. The iteration function is pure jnp, so it vmaps across scenario
batches and shards over a device mesh unchanged (parallel/).

Semantics parity:
  - optimistic step at alpha_prev, accept if cost decreases (GD_1D.py:365-384)
  - else backtrack: 1D starts at alpha_prev, <=5 trials; 2D starts at
    0.8*alpha_prev, <=10 trials; beta=0.8 both; on total failure the last
    tried (worse) iterate is returned, with alpha already multiplied by beta
    (GD_1D.py:73-113; GD2_configured.py:71-146, :324)
  - alpha_prev <- min(alpha_max, 1.2*alpha_k); plateau boost 2.0x after 10
    iters within 1e-7 (1D) / 1.5x after 5 iters within 1e-5 (2D)
    (GD_1D.py:452-463; GD2_configured.py:365-373)
  - convergence: relative control change < 1e-5 after >10 (1D) / >20 (2D)
    iterations (GD_1D.py:466-473; GD2_configured.py:378)
  - alpha advisor: mean of successful optimistic alphas after iter 100,
    stability counter (GD_1D.py:388-404, :509-516)
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import OptimizationConfig
from vch_tpu.control.prox import calculate_gradient, proximal_step


@dataclass
class PGDSettings:
    """Line-search / heuristic constants that differ between 1D and 2D."""

    ls_max_trials: int = 5
    ls_beta: float = 0.8
    ls_alpha_factor: float = 1.0      # backtracking starts at factor*alpha_prev
    plateau_length: int = 10
    plateau_tolerance: float = 1e-7
    plateau_boost: float = 2.0
    conv_tol: float = 1e-5
    conv_min_iter: int = 10
    advisor_start_iter: int = 100
    # Reference semantics keep the last (worse) trial when every trial fails
    # (GD_1D.py:110-113). False = reject the step and retry next iteration
    # with a shrunk alpha — the sane choice for the exact-gradient mode.
    keep_failed_step: bool = True

    @classmethod
    def defaults_1d(cls) -> "PGDSettings":
        return cls()

    @classmethod
    def defaults_2d(cls) -> "PGDSettings":
        return cls(ls_max_trials=10, ls_alpha_factor=0.8, plateau_length=5,
                   plateau_tolerance=1e-5, plateau_boost=1.5,
                   conv_min_iter=20)

    @classmethod
    def defaults_exact(cls) -> "PGDSettings":
        """For the exact-gradient mode: the gradient has true (much larger)
        magnitude, so backtrack deeper and never keep an ascent step."""
        return cls(ls_max_trials=15, ls_beta=0.5, keep_failed_step=False)


def optimistic_backtracking_search(trial, cost_k, alpha_prev, s: PGDSettings):
    """One PGD step-size search: optimistic trial at alpha_prev, then
    backtracking (GD_1D.py:365-418 semantics). `trial(alpha) -> (u, phi, cost)`
    must be pure jnp. Returns (alpha_k, u1, phi1, c1, n_trials, optimistic_ok).

    Implemented as ONE while_loop whose trial j uses
        alpha_0 = alpha_prev                         (optimistic step)
        alpha_j = alpha_prev * f * beta^(j-1), j>=1  (backtracking)
    so the (expensive, full-forward-solve) `trial` is instantiated once in
    the compiled program instead of once per branch — this halves XLA
    compile time for the fused PGD iteration. Semantics are identical to the
    reference, including returning the last (worse) iterate with alpha
    already multiplied by beta when every trial fails (GD_1D.py:110-113).

    Shared by the single-scenario loop and the vmapped batched runner (the
    while_loop then runs to the max trial count across the batch, finished
    members holding their state).
    """
    max_trials = 1 + s.ls_max_trials  # optimistic + backtracking budget
    zero = jnp.zeros_like(cost_k)
    a0 = alpha_prev + zero
    u_shape, phi_shape, _ = jax.eval_shape(trial, a0)
    u_init = jnp.zeros(u_shape.shape, u_shape.dtype)
    phi_init = jnp.zeros(phi_shape.shape, phi_shape.dtype)

    def cond(c):
        j, _, _, _, _, ok, _ = c
        return (~ok) & (j < max_trials)

    def body(c):
        j, alpha, _, _, _, _, _ = c
        u_t, phi_t, c_t = trial(alpha)
        ok = c_t < cost_k
        nxt = jnp.where(j == 0, alpha_prev * s.ls_alpha_factor,
                        alpha * s.ls_beta)
        alpha_report = jnp.where(ok, alpha, nxt)
        return (j + 1, nxt, u_t, phi_t, c_t, ok, alpha_report)

    init = (jnp.asarray(0, jnp.int32), a0, u_init, phi_init, cost_k,
            jnp.asarray(False), a0)
    j, _, u_1, phi_1, c_1, ok, alpha_k = jax.lax.while_loop(cond, body, init)
    optimistic_ok = ok & (j == 1)
    return alpha_k, u_1, phi_1, c_1, j, optimistic_ok


@dataclass
class PGDResult:
    u_optimal: np.ndarray
    r_optimal: np.ndarray
    phi_final: np.ndarray
    cost_history: list
    alpha_history: list
    tracking_err_history: list
    terminal_err_history: list
    iterations: int
    converged: bool
    timers: dict
    ls_trials_per_iter: list
    advisor_alpha: Optional[float] = None
    plateau_boosts: int = 0


class ProximalGradientLoop:
    """Dimension-agnostic PGD engine over user-supplied jnp callables.

    forward:  u -> phi_hist           (pure jnp, jit-safe)
    adjoint:  phi_hist -> r           (pure jnp)
    cost:     (phi_hist, u) -> scalar (pure jnp)
    error_norms: optional (phi_hist) -> (rel_tracking, rel_terminal)
    """

    def __init__(self, forward: Callable, adjoint: Callable, cost: Callable,
                 opt_config: OptimizationConfig,
                 settings: Optional[PGDSettings] = None,
                 error_norms: Optional[Callable] = None,
                 search_mode: str = "host",
                 adjoint_takes_u: bool = False):
        """search_mode:
          'host'  — the line search is driven from the host; each trial
                    (prox + forward + cost) is one top-level jitted call.
                    Default: identical trial sequence to 'fused' with far
                    smaller compiled programs (the forward scan stays a
                    top-level program instead of nesting inside a search
                    while_loop).
          'fused' — the whole iteration (adjoint + search loop) is a single
                    jitted function (vmappable as one unit).
        """
        assert search_mode in ("host", "fused")
        self.forward = forward
        self.adjoint = adjoint
        self.cost = cost
        self.opt = opt_config
        self.s = settings or PGDSettings.defaults_1d()
        self.error_norms = error_norms
        self.search_mode = search_mode
        self.adjoint_takes_u = adjoint_takes_u
        self._iteration = jax.jit(self._iteration_impl)
        opt = self.opt

        def _adjoint_grad(phi_k, u_k):
            r_k = (self.adjoint(phi_k, u_k) if self.adjoint_takes_u
                   else self.adjoint(phi_k))
            return r_k, calculate_gradient(r_k, u_k, opt.b3)

        def _trial(u_k, grad, alpha):
            u_t = proximal_step(u_k, grad, alpha, opt.kappa_sparsity,
                                opt.u_min, opt.u_max)
            phi_t = self.forward(u_t)
            return u_t, phi_t, self.cost(phi_t, u_t)

        def _metrics(u_1, u_k, phi_1):
            change = (jnp.linalg.norm(u_1 - u_k)
                      / (jnp.linalg.norm(u_k) + 1e-9))
            errs = (self.error_norms(phi_1) if self.error_norms is not None
                    else (jnp.asarray(0.0), jnp.asarray(0.0)))
            return change, errs

        self._adjoint_grad = jax.jit(_adjoint_grad)
        self._trial = jax.jit(_trial)
        self._metrics = jax.jit(_metrics)

    def _iteration_host(self, u_k, phi_k, cost_k, alpha_prev,
                        timers: Optional[dict] = None):
        """Host-driven optimistic + backtracking search; same trial
        sequence as optimistic_backtracking_search. When `timers` is given,
        accumulates the reference's phase accounting (GD_1D.py:323-331):
        backward_total, optimistic_eval_total, line_search_total,
        successful_step_total."""
        s = self.s
        t0 = time.perf_counter()
        r_k, grad = self._adjoint_grad(phi_k, u_k)
        jax.block_until_ready(grad)
        t1 = time.perf_counter()
        if timers is not None:
            timers["backward_total"] += t1 - t0
        max_trials = 1 + s.ls_max_trials
        alpha = alpha_prev
        j = 0
        while True:
            tt = time.perf_counter()
            u_t, phi_t, c_t = self._trial(u_k, grad, alpha)
            c = float(c_t)
            trial_time = time.perf_counter() - tt
            j += 1
            ok = c < cost_k
            if timers is not None:
                if j == 1:
                    timers["optimistic_eval_total"] += trial_time
                else:
                    timers["line_search_total"] += trial_time
                if ok:
                    timers["successful_step_total"] += trial_time
            nxt = (alpha_prev * s.ls_alpha_factor if j == 1
                   else alpha * s.ls_beta)
            alpha_report = alpha if ok else nxt
            if ok or j >= max_trials:
                break
            alpha = nxt
        if not ok and not s.keep_failed_step:
            u_t, phi_t, c = u_k, phi_k, cost_k     # reject the ascent step
        opt_ok = ok and (j == 1)
        change, errs = self._metrics(u_t, u_k, phi_t)
        return (u_t, phi_t, c, alpha_report, r_k, j, change, opt_ok, errs)

    def _iteration_impl(self, u_k, phi_k, cost_k, alpha_prev):
        opt, s = self.opt, self.s
        r_k = (self.adjoint(phi_k, u_k) if self.adjoint_takes_u
               else self.adjoint(phi_k))
        grad = calculate_gradient(r_k, u_k, opt.b3)

        def trial(alpha):
            u_t = proximal_step(u_k, grad, alpha, opt.kappa_sparsity,
                                opt.u_min, opt.u_max)
            phi_t = self.forward(u_t)
            return u_t, phi_t, self.cost(phi_t, u_t)

        alpha_k, u_1, phi_1, c_1, n_trials, optimistic_ok = (
            optimistic_backtracking_search(trial, cost_k, alpha_prev, s))

        change = (jnp.linalg.norm(u_1 - u_k)
                  / (jnp.linalg.norm(u_k) + 1e-9))
        errs = (self.error_norms(phi_1) if self.error_norms is not None
                else (jnp.asarray(0.0), jnp.asarray(0.0)))
        return (u_1, phi_1, c_1, alpha_k, r_k, n_trials, change,
                optimistic_ok, errs)

    def run(self, u0, phi0_hist, max_iter: Optional[int] = None,
            verbose: bool = True) -> PGDResult:
        opt, s = self.opt, self.s
        max_iter = max_iter if max_iter is not None else opt.max_iter

        u_k = jnp.asarray(u0)
        phi_k = jnp.asarray(phi0_hist)
        cost_k = float(self.cost(phi_k, u_k))
        alpha_prev = float(opt.alpha_max)

        cost_history = [cost_k]
        alpha_history, track_hist, term_hist, ls_trials = [], [], [], []
        # phase accumulators matching the reference's time study
        # (GD_1D.py:323-331, :563-576)
        timers = {"total_optimization": 0.0, "backward_total": 0.0,
                  "line_search_total": 0.0, "optimistic_eval_total": 0.0,
                  "successful_step_total": 0.0, "iteration_total": 0.0}
        plateau_counter = 0
        plateau_boosts = 0
        successful_optimistic_alphas: list = []
        self._advisor_last_avg = 0.0
        self._advisor_stable = 0
        converged = False
        r_k = jnp.zeros_like(u_k)
        final_iters = max_iter

        if self.search_mode == "host":
            step_fn = partial(self._iteration_host, timers=timers)
        else:
            step_fn = self._iteration
        t_start = time.perf_counter()
        for k in range(max_iter):
            it0 = time.perf_counter()
            (u_1, phi_1, c_1, alpha_k, r_k, n_trials, change, opt_ok,
             (e_track, e_term)) = step_fn(u_k, phi_k, cost_k, alpha_prev)
            c_1 = float(c_1)
            alpha_k = float(alpha_k)
            change = float(change)
            timers["iteration_total"] += time.perf_counter() - it0

            cost_history.append(c_1)
            alpha_history.append(alpha_k)
            track_hist.append(float(e_track))
            term_hist.append(float(e_term))
            ls_trials.append(int(n_trials))

            if bool(opt_ok) and k >= s.advisor_start_iter:
                # live alpha advisor (ref GD_1D.py:388-404): track successful
                # optimistic alphas; after a stable average, tip the user.
                successful_optimistic_alphas.append(alpha_prev)
                if len(successful_optimistic_alphas) > 10:
                    cur_avg = float(np.mean(successful_optimistic_alphas))
                    if np.isclose(cur_avg, self._advisor_last_avg, rtol=1e-3):
                        self._advisor_stable += 1
                    else:
                        self._advisor_stable = 0
                    self._advisor_last_avg = cur_avg
                    if (self._advisor_stable >= 50 and k % 10 == 0
                            and verbose):
                        print(f"[LIVE ADVISOR] Stable average alpha "
                              f"{cur_avg:.4f} found — consider restarting "
                              f"with it as alpha_max.")

            # plateau detection + alpha update
            if k > 0 and abs(cost_history[-1] - cost_history[-2]) < s.plateau_tolerance:
                plateau_counter += 1
            else:
                plateau_counter = 0
            if plateau_counter >= s.plateau_length:
                if verbose:
                    print(f"[Notice] Cost plateaued for {plateau_counter} "
                          f"iterations. Boosting learning rate.")
                alpha_prev = min(opt.alpha_max, alpha_k * s.plateau_boost)
                plateau_counter = 0
                plateau_boosts += 1
            else:
                alpha_prev = min(opt.alpha_max, alpha_k * 1.2)

            if verbose:
                print(f"iter {k+1:4d} | cost {c_1:.6f} | alpha {alpha_k:.4f} "
                      f"| trials {int(n_trials)} | rel-du {change:.3e}")

            u_k, phi_k, cost_k = u_1, phi_1, c_1
            if change < s.conv_tol and k > s.conv_min_iter:
                if verbose:
                    print(f"Convergence reached at iteration {k+1}.")
                converged = True
                final_iters = k + 1
                break

        timers["total_optimization"] = time.perf_counter() - t_start
        if verbose and self.search_mode == "host":
            # time-study report (ref GD_1D.py:563-576 / GD2_configured.py:402-415)
            tot = timers["total_optimization"]
            print("\n--- COMPUTATIONAL TIME STUDY ---")
            print(f"Total optimization time:   {tot:8.2f} s")
            for key, label in (("backward_total", "Backward (adjoint) solves"),
                               ("optimistic_eval_total", "Optimistic evals"),
                               ("line_search_total", "Backtracking searches"),
                               ("successful_step_total", "Accepted steps")):
                v = timers[key]
                pct = 100.0 * v / tot if tot > 0 else 0.0
                print(f"{label:<26} {v:8.2f} s ({pct:4.1f}%)")
            if ls_trials:
                print(f"Line-search trials: total {sum(ls_trials)}, "
                      f"mean {np.mean(ls_trials):.2f}, max {max(ls_trials)}")
        advisor = (float(np.mean(successful_optimistic_alphas))
                   if successful_optimistic_alphas else None)
        return PGDResult(
            u_optimal=np.asarray(u_k), r_optimal=np.asarray(r_k),
            phi_final=np.asarray(phi_k), cost_history=cost_history,
            alpha_history=alpha_history, tracking_err_history=track_hist,
            terminal_err_history=term_hist, iterations=final_iters,
            converged=converged, timers=timers, ls_trials_per_iter=ls_trials,
            advisor_alpha=advisor, plateau_boosts=plateau_boosts)
