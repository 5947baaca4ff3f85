"""Problem assemblies: wire forward/adjoint/cost/targets into a PGD loop.

These assemble the reference's driver setups (GD_1D.py __main__,
GD2_configured.py __main__) as reusable objects: a baseline uncontrolled
trajectory, targets, and jnp closures handed to ProximalGradientLoop.
The 1D problem operates in the reference's history layout (duplicated t=0
row, Forward_solver.py:329-337) so cost trajectories are directly
comparable with reference runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from vch_tpu.config import ForwardSolverConfig1D, OptimizationConfig
from vch_tpu.control.cost import calculate_cost_1d
from vch_tpu.control.pgd import PGDSettings, ProximalGradientLoop
from vch_tpu.control.targets import build_targets_1d
from vch_tpu.models.adjoint1d import AdjointSolver1D
from vch_tpu.models.forward1d import ForwardSolver1D


class ControlProblem2D:
    """Sparse optimal control of the 2D vCH system (ref: GD2_configured.py).

    gradient_mode: 'reference' (the reference's approximate adjoint, parity)
    or 'exact' (implicit-differentiation exact gradient,
    models/adjoint_exact2d.py — no reference analog; 2D has no layout quirk
    so both modes share the same frame).
    """

    def __init__(self, fwd_config=None, opt_config: Optional[OptimizationConfig] = None,
                 choice_t: int = 1, choice_q: int = 1,
                 initial_phi: Optional[np.ndarray] = None,
                 gradient_mode: str = "reference"):
        from vch_tpu.config import ForwardSolverConfig2D
        from vch_tpu.control.cost import calculate_cost_2d
        from vch_tpu.control.targets import build_targets_2d
        from vch_tpu.models.adjoint2d import AdjointSolver2D
        from vch_tpu.models.forward2d import ForwardSolver2D

        assert gradient_mode in ("reference", "exact")
        self.gradient_mode = gradient_mode
        self.fwd_config = fwd_config or ForwardSolverConfig2D()
        self.opt_config = opt_config or OptimizationConfig.defaults_2d()
        self.solver = ForwardSolver2D(self.fwd_config)
        self.adjoint = AdjointSolver2D(self.fwd_config)
        dtype = self.solver.dtype

        self.phi0 = (self.solver.default_initial_phi() if initial_phi is None
                     else np.asarray(initial_phi, np.float64))
        self._phi0_dev = jnp.asarray(self.phi0, dtype)

        phi_hist, (x, y), t_hist = self.solver.simulate(initial_phi=self.phi0)
        self.phi_hist0 = phi_hist
        self.x, self.y, self.t_hist = x, y, t_hist
        self._dts = jnp.asarray(np.diff(t_hist), dtype)

        phi_T, phi_Q = build_targets_2d(
            x, y, t_hist, np.asarray(phi_hist[0]), float(self.fwd_config.Lx),
            float(self.fwd_config.Ly), float(self.fwd_config.T),
            choice_t=choice_t, choice_q=choice_q)
        self.phi_T_target = jnp.asarray(phi_T, dtype)
        self.phi_Q_target = jnp.asarray(phi_Q, dtype)

        opt = self.opt_config

        def forward(u):
            return self.solver._simulate_impl(u, self._phi0_dev)

        if gradient_mode == "exact":
            from vch_tpu.models.adjoint_exact2d import ExactAdjoint2D
            self._exact = ExactAdjoint2D(self.fwd_config)

            def adjoint(phi_hist_in, u):
                g, _ = self._exact._grad(
                    u, self._phi0_dev, opt.b1, opt.b2, opt.b3,
                    self.phi_Q_target, self.phi_T_target)
                return g - opt.b3 * u   # loop re-adds b3*u
        else:
            def adjoint(phi_hist):
                _, _, r = self.adjoint._run_impl(
                    phi_hist, self._dts, opt.b1, opt.b2, self.phi_Q_target,
                    self.phi_T_target)
                return r

        def cost(phi_hist, u):
            return calculate_cost_2d(
                phi_hist, u, self.phi_Q_target, self.phi_T_target,
                jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                jnp.asarray(t_hist, dtype), opt.b1, opt.b2, opt.b3,
                opt.kappa_sparsity)

        def error_norms(phi_hist):
            xj = jnp.asarray(x, dtype)
            yj = jnp.asarray(y, dtype)
            tj = jnp.asarray(t_hist, dtype)

            def sp(a):
                return jnp.trapezoid(jnp.trapezoid(a, x=yj, axis=-1),
                                     x=xj, axis=-1)

            def l2_xt(A):
                return jnp.sqrt(jnp.trapezoid(sp(A ** 2), x=tj, axis=-1))

            rms_scale = float(np.sqrt(max((x[-1] - x[0]) * (y[-1] - y[0]), 1e-30)
                                      * max(t_hist[-1] - t_hist[0], 1e-30)))
            numQ = l2_xt(phi_hist - self.phi_Q_target)
            denQ = l2_xt(self.phi_Q_target)
            denQ = jnp.where(denQ < 1e-9 * rms_scale, rms_scale, denQ)
            rel_track = numQ / (denQ + 1e-12)
            numT = jnp.sqrt(sp((phi_hist[..., -1, :, :] - self.phi_T_target) ** 2))
            denT = jnp.sqrt(sp(self.phi_T_target ** 2)) + 1e-12
            return rel_track, numT / denT

        self.loop = ProximalGradientLoop(
            forward, adjoint, cost, opt,
            settings=(PGDSettings.defaults_exact()
                      if gradient_mode == "exact"
                      else PGDSettings.defaults_2d()),
            error_norms=error_norms,
            adjoint_takes_u=(gradient_mode == "exact"))

    def initial_control(self):
        return jnp.zeros_like(self.phi_hist0)

    def optimize(self, max_iter: Optional[int] = None, verbose: bool = True):
        return self.loop.run(self.initial_control(), self.phi_hist0,
                             max_iter=max_iter, verbose=verbose)

    def verify_sparsity(self, result, verbose: bool = True):
        from vch_tpu.control.diagnostics import verify_sparsity_condition
        return verify_sparsity_condition(result.u_optimal, result.r_optimal,
                                         self.opt_config.kappa_sparsity,
                                         verbose=verbose)

    def second_order_check(self, result, num_directions: int = 5,
                           epsilon: float = 1e-4, seed: int = 42):
        """Batched FD coercivity probe (2D cone: bound activity only,
        ref second_order_conditions_2d.py:35-88)."""
        from vch_tpu.control.diagnostics import approximate_second_order_condition
        opt = self.opt_config
        return approximate_second_order_condition(
            self.loop.forward, self.loop.cost, result.u_optimal,
            result.r_optimal, result.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=num_directions,
            epsilon=epsilon, seed=seed, handle_kink=False)


class ControlProblem1D:
    """Sparse optimal control of the 1D vCH system (ref: GD_1D.py).

    gradient_mode:
      'reference' — the reference's optimize-then-discretize adjoint r
                    (approximate gradient; parity with GD_1D.py).
      'exact'     — the exact discrete gradient via implicit differentiation
                    (models/adjoint_exact1d.py), matching finite differences
                    to ~1e-8; no reference analog.
    """

    def __init__(self, fwd_config: Optional[ForwardSolverConfig1D] = None,
                 opt_config: Optional[OptimizationConfig] = None,
                 choice_t: int = 1, choice_q: int = 1,
                 initial_phi: Optional[np.ndarray] = None,
                 gradient_mode: str = "reference"):
        assert gradient_mode in ("reference", "exact")
        self.gradient_mode = gradient_mode
        self.fwd_config = fwd_config or ForwardSolverConfig1D()
        self.opt_config = opt_config or OptimizationConfig()
        self.solver = ForwardSolver1D(self.fwd_config)
        self.adjoint = AdjointSolver1D(self.fwd_config)
        dtype = self.solver.dtype

        self.phi0 = (self.solver.default_initial_phi() if initial_phi is None
                     else np.asarray(initial_phi, np.float64))
        self._phi0_dev = jnp.asarray(self.phi0, dtype)

        # baseline (uncontrolled) trajectory in reference layout
        phi_hist, x, t_hist = self.solver.simulate(
            initial_phi=self.phi0, ref_layout=True)
        self.phi_hist0 = phi_hist
        self.x, self.t_hist = x, t_hist
        self._dts = jnp.asarray(np.diff(t_hist), dtype)

        phi_T, phi_Q = build_targets_1d(
            x, t_hist, np.asarray(phi_hist[0]), float(self.fwd_config.Lx),
            float(self.fwd_config.T), choice_t=choice_t, choice_q=choice_q)
        self.phi_T_target = jnp.asarray(phi_T, dtype)
        self.phi_Q_target = jnp.asarray(phi_Q, dtype)

        opt = self.opt_config
        M = self.solver.M

        if gradient_mode == "exact":
            # Exact mode runs in CORE layout (no duplicated t=0 row): the
            # reference frame is internally inconsistent by one row — its
            # cost quadrature places u_ref[k] at time t_{k-1} while the
            # dynamics read it at t_k (SURVEY.md quirk 4) — which makes the
            # exact gradient ill-posed at the edge rows. Core layout is the
            # clean discretize-then-optimize formulation.
            from vch_tpu.models.adjoint_exact1d import ExactAdjoint1D
            self._exact = ExactAdjoint1D(self.fwd_config)
            phi_hist_core, _, t_core = self.solver.simulate(
                initial_phi=self.phi0, ref_layout=False)
            self.phi_hist0 = phi_hist_core
            self.t_hist = t_hist = t_core
            phi_T_c, phi_Q_c = build_targets_1d(
                x, t_core, np.asarray(phi_hist_core[0]),
                float(self.fwd_config.Lx), float(self.fwd_config.T),
                choice_t=choice_t, choice_q=choice_q)
            self.phi_T_target = jnp.asarray(phi_T_c, dtype)
            self.phi_Q_target = jnp.asarray(phi_Q_c, dtype)

            def forward(u_core):
                return self.solver._simulate_impl(u_core, self._phi0_dev)

            def adjoint(phi_core, u_core):
                g, _ = self._exact._grad(
                    u_core, self._phi0_dev, opt.b1, opt.b2, opt.b3,
                    self.phi_Q_target, self.phi_T_target)
                return g - opt.b3 * u_core   # loop re-adds b3*u
        else:
            def forward(u_ref):
                phi = self.solver._simulate_impl(u_ref[: M + 1],
                                                 self._phi0_dev)
                return jnp.concatenate([phi[:1], phi], axis=0)

            def adjoint(phi_ref):
                _, _, r = self.adjoint._run_impl(
                    phi_ref, self._dts, opt.b1, opt.b2, self.phi_Q_target,
                    self.phi_T_target)
                return r

        def cost(phi_ref, u_ref):
            return calculate_cost_1d(
                phi_ref, u_ref, self.phi_Q_target, self.phi_T_target,
                jnp.asarray(x, dtype), jnp.asarray(t_hist, dtype),
                opt.b1, opt.b2, opt.b3, opt.kappa_sparsity)

        def error_norms(phi_ref):
            xj = jnp.asarray(x, dtype)
            tj = jnp.asarray(t_hist, dtype)

            def l2_xt(A):
                s = jnp.trapezoid(A ** 2, x=xj, axis=-1)
                return jnp.sqrt(jnp.trapezoid(s, x=tj, axis=-1))

            def l2_x(a):
                return jnp.sqrt(jnp.trapezoid(a ** 2, x=xj, axis=-1))

            rms_scale = float(np.sqrt(max(x[-1] - x[0], 1e-30)
                                      * max(t_hist[-1] - t_hist[0], 1e-30)))
            numQ = l2_xt(phi_ref - self.phi_Q_target)
            denQ = l2_xt(self.phi_Q_target)
            denQ = jnp.where(denQ < 1e-9 * rms_scale, rms_scale, denQ)
            rel_track = numQ / (denQ + 1e-12)
            numT = l2_x(phi_ref[..., -1, :] - self.phi_T_target)
            denT = l2_x(self.phi_T_target) + 1e-12
            return rel_track, numT / denT

        self.loop = ProximalGradientLoop(
            forward, adjoint, cost, opt,
            settings=(PGDSettings.defaults_exact()
                      if gradient_mode == "exact"
                      else PGDSettings.defaults_1d()),
            error_norms=error_norms,
            adjoint_takes_u=(gradient_mode == "exact"))

    def initial_control(self):
        return jnp.zeros_like(self.phi_hist0)

    def optimize(self, max_iter: Optional[int] = None, verbose: bool = True):
        return self.loop.run(self.initial_control(), self.phi_hist0,
                             max_iter=max_iter, verbose=verbose)

    def verify_sparsity(self, result, verbose: bool = True):
        from vch_tpu.control.diagnostics import verify_sparsity_condition
        return verify_sparsity_condition(result.u_optimal, result.r_optimal,
                                         self.opt_config.kappa_sparsity,
                                         verbose=verbose)

    def second_order_check(self, result, num_directions: int = 3,
                           epsilon: float = 1e-4, seed: int = 42):
        """Batched FD coercivity probe (1D cone handles the L1 kink,
        ref second_order_conditions.py:33-55)."""
        from vch_tpu.control.diagnostics import approximate_second_order_condition
        opt = self.opt_config
        return approximate_second_order_condition(
            self.loop.forward, self.loop.cost, result.u_optimal,
            result.r_optimal, result.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=num_directions,
            epsilon=epsilon, seed=seed, handle_kink=True)
