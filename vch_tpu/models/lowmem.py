"""Memory-lean trajectory handling: segment-checkpointed recomputation.

The adjoint sweep needs the full phi trajectory; at 256x256 with large
scenario batches the stored history dominates memory (SURVEY.md section 7
'Memory at scale'). This module implements the classic sqrt-schedule
checkpointing: the forward marcher stores only every K-th state (plus the
running tracking-cost accumulator), and the backward sweep recomputes each
K-step segment from its checkpoint just before consuming it — O(M/K + K)
live states instead of O(M).

Generalized (round 2): non-uniform dt schedules (a shorter tail segment
absorbs M % K), a 1D variant, the tracking cost J1 accumulated DURING the
forward pass (so the PGD line search never materializes a trajectory), and
vmap-able pure functions that plug into the batched PGD runner
(parallel/batch.LowMemBatchedProblem2D). The adjoint scheme is the
reference one (backward2_solver.py:75-246 / backward_solver.py:48-125
operators; see adjoint1d.py/adjoint2d.py notes).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import (DELTA_SEP, ForwardSolverConfig1D,
                            ForwardSolverConfig2D)
from vch_tpu.models.adjoint1d import AdjointSolver1D
from vch_tpu.models.adjoint2d import AdjointSolver2D
from vch_tpu.models.forward1d import ForwardSolver1D, newton_1d, solve_w
from vch_tpu.models.forward2d import ForwardSolver2D
from vch_tpu.ops.linsolve import bicgstab_split, bicgstab_split_fixed
from vch_tpu.ops.potential import fpp_log


class LowMemState(NamedTuple):
    """Everything the PGD loop needs from a checkpointed forward solve.

    Holds O(M/K) segment-start states instead of the O(M) trajectory:
    ck_phi/ck_mu/ck_w have leading axis S (= number of segments, the last
    one possibly shorter), phi_T is the final state, j1_raw is the
    trapezoid-in-time tracking integral  integral_t integral_x (phi-phi_Q)^2
    (WITHOUT the b1/2 factor, so per-scenario weights apply downstream), and
    newton_solves is the measured solve count (MarchStats analog).
    """

    ck_phi: jnp.ndarray
    ck_mu: jnp.ndarray
    ck_w: jnp.ndarray
    phi_T: jnp.ndarray
    j1_raw: jnp.ndarray
    newton_solves: jnp.ndarray


class _Adapter2D:
    """2D physics callbacks for the generic pipeline (ForwardSolver2D /
    AdjointSolver2D internals, cited there)."""

    def __init__(self, solver: ForwardSolver2D, adjoint: AdjointSolver2D):
        self.solver, self.adjoint = solver, adjoint
        self.cfg = solver.config
        self.dtype = solver.dtype
        self.wts_h = jnp.asarray(solver._wts_h, self.dtype)
        # space trapz nodes for J1 (matches control/cost.calculate_cost_2d)
        self.x = jnp.asarray(solver.x, self.dtype)
        self.y = jnp.asarray(solver.y, self.dtype)

    def space_int(self, v):
        """trapz_y then trapz_x, matching cost_breakdown_2d's sp()."""
        return jnp.trapezoid(jnp.trapezoid(v, x=self.y, axis=-1),
                             x=self.x, axis=-1)

    def init_state(self, phi0):
        w0 = jnp.zeros_like(phi0)
        with self.solver.matmul_precision():
            mu0 = self.solver.initialize_mu(phi0, w0)
        m0 = jnp.sum(self.wts_h * phi0)
        return mu0, w0, m0

    def forward_step(self, phi, mu, w, u_n, u_np1, dt, m0):
        # the solver's own step and matmul precision, so checkpoints and
        # the adjoint's segment recomputation match the full-memory march
        with self.solver.matmul_precision():
            phi_c, mu_new, w_new, k, _ = self.solver._step(
                phi, mu, w, u_n, u_np1, dt, m0)
        return phi_c, mu_new, w_new, k

    def terminal(self, phi_T, phi_T_target, b2):
        return self.adjoint._terminal(phi_T, phi_T_target, b2)

    def adjoint_step(self, carry, phi_n, phi_np1, src_n, src_np1, dt, b1):
        out = self.adjoint._step(carry, phi_n, phi_np1, src_n, src_np1, dt,
                                 b1)
        return out, out[2]


class _Adapter1D:
    """1D physics callbacks (core layout, no duplicated t=0 row —
    ForwardSolver1D / AdjointSolver1D internals)."""

    def __init__(self, solver: ForwardSolver1D, adjoint: AdjointSolver1D):
        self.solver, self.adjoint = solver, adjoint
        self.cfg = solver.config
        self.dtype = solver.dtype
        self.L = jnp.asarray(solver._L_np, self.dtype)
        self.wts_h = jnp.asarray(solver._wts_h, self.dtype)
        self.x = jnp.asarray(solver.x, self.dtype)

    def space_int(self, v):
        return jnp.trapezoid(v, x=self.x, axis=-1)

    def init_state(self, phi0):
        w0 = jnp.zeros_like(phi0)
        mu0 = self.solver.initialize_mu(phi0, w0)
        m0 = jnp.dot(self.wts_h, phi0)
        return mu0, w0, m0

    def forward_step(self, phi, mu, w, u_n, u_np1, dt, m0):
        cfg, s = self.cfg, self.solver
        w_new = solve_w(w, dt, cfg.gamma, u_n, u_np1)
        phi_new, mu_new, k = newton_1d(
            self.L, phi, mu, w, w_new, dt, cfg.tau, cfg.c1, cfg.c2,
            cfg.kappa, DELTA_SEP, cfg.newton_tol, cfg.newton_max_iter,
            rtol=s._rtol, stagnation_exit=s._stagnation,
            spectral_op=s._op1d, krylov_fixed=s._krylov_fixed,
            krylov_tol=s._krylov_tol, return_iters=True)
        phi_c = jnp.clip(phi_new, -1.0 + DELTA_SEP, 1.0 - DELTA_SEP)
        mass_error = jnp.dot(self.wts_h, phi_c) - m0
        phi_c = phi_c - mass_error / cfg.Lx
        return phi_c, mu_new, w_new, k

    def terminal(self, phi_T, phi_T_target, b2):
        adj = self.adjoint
        tau = self.cfg.tau
        rhs_T = b2 * (phi_T - phi_T_target)
        if adj._op1d is not None:
            op = adj._op1d
            p_T = ((rhs_T @ op.Vinv.T) / (1.0 - tau * op.lam)) @ op.V.T
        else:
            I = jnp.eye(self.L.shape[0], dtype=self.dtype)
            p_T = jnp.linalg.solve(I - tau * self.L, rhs_T)
        q_T = -(p_T @ self.L.T)
        return p_T, q_T, jnp.zeros_like(p_T)

    def adjoint_step(self, carry, phi_n, phi_np1, src_n, src_np1, dt, b1):
        cfg, adj = self.cfg, self.adjoint
        L = self.L
        tau, gamma, c1, c2 = cfg.tau, cfg.gamma, cfg.c1, cfg.c2
        p_next, q_next, r_next = carry
        fpp_n = fpp_log(phi_n, c1, c2)
        fpp_np1 = fpp_log(phi_np1, c1, c2)
        w1 = p_next @ L.T
        Bp = (p_next - tau * w1 - 0.5 * dt * (w1 @ L.T)
              + 0.5 * dt * fpp_np1 * w1)
        rhs = Bp + 0.5 * dt * b1 * (src_n + src_np1)
        if adj._op1d is not None:
            op = adj._op1d
            fbar = jnp.mean(fpp_n)

            def apply_A(v):
                w = v @ L.T
                return v - tau * w + 0.5 * dt * ((w @ L.T) - fpp_n * w)

            denom = (1.0 - tau * op.lam + 0.5 * dt * op.lam ** 2
                     - 0.5 * dt * fbar * op.lam)
            inv_sqrt = jax.lax.rsqrt(jnp.abs(denom))

            def Phalf(v):
                return ((v @ op.Vinv.T) * inv_sqrt) @ op.V.T

            def Phalf_inv(v):
                return ((v @ op.Vinv.T) / inv_sqrt) @ op.V.T

            if adj._krylov_fixed is not None:
                p_n = bicgstab_split_fixed(apply_A, rhs, Phalf, Phalf_inv,
                                           n_iter=adj._krylov_fixed,
                                           x0=p_next)
            else:
                p_n = bicgstab_split(apply_A, rhs, Phalf, Phalf_inv,
                                     tol=adj._krylov_tol, max_iter=200,
                                     x0=p_next)
        else:
            I = jnp.eye(L.shape[0], dtype=self.dtype)
            A = (I - tau * L + 0.5 * dt * (L @ L)
                 - 0.5 * dt * (fpp_n[:, None] * L))
            p_n = jnp.linalg.solve(A, rhs)
        q_n = -(p_n @ L.T)
        den = gamma + 0.5 * dt
        r_n = ((gamma - 0.5 * dt) / den * r_next
               + 0.5 * dt / den * (q_n + q_next))
        skip = dt <= 1e-14
        out = (jnp.where(skip, p_next, p_n),
               jnp.where(skip, q_next, q_n),
               jnp.where(skip, r_next, r_n))
        return out, out[2]


class _LowMemCore:
    """Dimension-agnostic segment-checkpointed forward + recomputing adjoint.

    Segments: S_full = M // K full segments of K steps plus one tail segment
    of rem = M - S_full*K steps (rem may be 0) — so ANY dt schedule from
    build_dt_schedule works, including a partial final step. Checkpoints are
    the S_full + (rem>0) segment-start states.
    """

    def __init__(self, adapter, dts: np.ndarray, K: int,
                 t_hist: Optional[np.ndarray] = None):
        self.a = adapter
        self.K = int(K)
        self.M = len(dts)
        assert self.K >= 1
        self.S_full = self.M // self.K
        self.rem = self.M - self.S_full * self.K
        self.dts_np = np.asarray(dts, np.float64)
        self.t_np = (np.asarray(t_hist, np.float64) if t_hist is not None
                     else np.concatenate([[0.0], np.cumsum(self.dts_np)]))
        self.dtype = adapter.dtype
        # Procedural targets: when phi_Q is passed as None, tracking-target
        # frames are synthesized per segment instead of stored — the ramp
        # (control/targets.py choice_q=1) is (1 - t/T) phi0 + (t/T) phi_T,
        # "zeros" is choice_q=2. Storing phi_Q is O(M) HBM per member
        # (1.7 GB at 128x128 B=256) for data that is a closed form of
        # (phi0, phi_T, t); synthesizing it is what lets BASELINE config-4/5
        # batch sizes fit one chip. Mode is read at TRACE time.
        self.phi_Q_mode = "ramp"

    def _phiQ_seg(self, phi_Q, start, length, phi0, phi_T_ref):
        """Segment [start, start+length) of the tracking target: sliced from
        the stored array, or synthesized (ramp/zeros) when phi_Q is None.
        `start` may be a traced index (dynamic_slice)."""
        if phi_Q is not None:
            return jax.lax.dynamic_slice_in_dim(phi_Q, start, length, axis=0)
        if self.phi_Q_mode == "zeros":
            return jnp.zeros((length,) + phi0.shape, self.dtype)
        assert self.phi_Q_mode == "ramp", self.phi_Q_mode
        t = jnp.asarray(self.t_np / self.t_np[-1], self.dtype)
        tp = jax.lax.dynamic_slice_in_dim(t, start, length, axis=0)
        tp = tp.reshape((length,) + (1,) * phi0.ndim)
        return (1.0 - tp) * phi0[None] + tp * phi_T_ref[None]

    # -- segment machinery -------------------------------------------------
    def _segment_scan(self, phi, mu, w, u_seg, dt_seg, m0):
        """Run len(dt_seg) steps; returns final carry, all phis (k+1 rows),
        and the summed Newton-solve count."""

        def step(carry, inp):
            phi, mu, w, ns = carry
            u_n, u_np1, dt = inp
            phi2, mu2, w2, k = self.a.forward_step(phi, mu, w, u_n, u_np1,
                                                   dt, m0)
            return (phi2, mu2, w2, ns + k), phi2

        (phi_f, mu_f, w_f, ns), phis = jax.lax.scan(
            step, (phi, mu, w, jnp.asarray(0, jnp.int32)),
            (u_seg[:-1], u_seg[1:], dt_seg))
        phis = jnp.concatenate([phi[None], phis], axis=0)
        return (phi_f, mu_f, w_f), phis, ns

    def _seg_j1(self, phis, phiQ_seg, dt_seg):
        """trapz-in-time of the space integral of (phi - phi_Q)^2 over one
        segment — exactly the per-step terms of cost_breakdown's J1."""
        g = self.a.space_int((phis - phiQ_seg) ** 2)
        return jnp.sum(0.5 * dt_seg * (g[:-1] + g[1:]))

    # -- forward -----------------------------------------------------------
    def forward_ckpt(self, u, phi0, phi_Q, phi_T_ref=None) -> LowMemState:
        """Checkpointed forward march accumulating J1; pure jnp (vmappable).

        phi_Q=None synthesizes target frames per segment (see _phiQ_seg);
        phi_T_ref is the ramp endpoint (the scenario's terminal target)."""
        K, S = self.K, self.S_full
        a = self.a
        dts = jnp.asarray(self.dts_np, self.dtype)
        mu0, w0, m0 = a.init_state(phi0)

        def outer(carry, i):
            phi, mu, w, ns, j1 = carry
            u_seg = jax.lax.dynamic_slice_in_dim(u, i * K, K + 1, axis=0)
            dt_seg = jax.lax.dynamic_slice_in_dim(dts, i * K, K, axis=0)
            pQ_seg = self._phiQ_seg(phi_Q, i * K, K + 1, phi0, phi_T_ref)
            (phi_f, mu_f, w_f), phis, k = self._segment_scan(
                phi, mu, w, u_seg, dt_seg, m0)
            j1 = j1 + self._seg_j1(phis, pQ_seg, dt_seg)
            return (phi_f, mu_f, w_f, ns + k, j1), (phi, mu, w)

        zero = jnp.asarray(0.0, self.dtype)
        carry0 = (phi0, mu0, w0, jnp.asarray(0, jnp.int32), zero)
        if S > 0:
            (phi_e, mu_e, w_e, ns, j1), (ck_phi, ck_mu, ck_w) = jax.lax.scan(
                outer, carry0, jnp.arange(S))
        else:
            (phi_e, mu_e, w_e, ns, j1) = carry0
            shape = (0,) + phi0.shape
            ck_phi = jnp.zeros(shape, self.dtype)
            ck_mu = jnp.zeros(shape, self.dtype)
            ck_w = jnp.zeros(shape, self.dtype)
        if self.rem:
            # tail segment checkpoint + march (static-length separate scan)
            ck_phi = jnp.concatenate([ck_phi, phi_e[None]], axis=0)
            ck_mu = jnp.concatenate([ck_mu, mu_e[None]], axis=0)
            ck_w = jnp.concatenate([ck_w, w_e[None]], axis=0)
            u_t = u[S * K:]
            dt_t = dts[S * K:]
            pQ_t = self._phiQ_seg(phi_Q, S * K, self.rem + 1, phi0, phi_T_ref)
            (phi_e, mu_e, w_e), phis_t, k_t = self._segment_scan(
                phi_e, mu_e, w_e, u_t, dt_t, m0)
            j1 = j1 + self._seg_j1(phis_t, pQ_t, dt_t)
            ns = ns + k_t
        return LowMemState(ck_phi, ck_mu, ck_w, phi_e, j1, ns)

    # -- cost --------------------------------------------------------------
    def cost(self, state: LowMemState, u, phi_T_target, b1, b2, b3,
             kappa_spar):
        """J from the checkpointed state + the control arrays (no
        trajectory), matching control/cost.calculate_cost_* exactly."""
        a = self.a
        t = jnp.asarray(self.t_np, self.dtype)
        J1 = (b1 / 2.0) * state.j1_raw
        J2 = (b2 / 2.0) * a.space_int((state.phi_T - phi_T_target) ** 2)
        J3 = (b3 / 2.0) * jnp.trapezoid(a.space_int(u ** 2), x=t, axis=-1)
        J4 = kappa_spar * jnp.trapezoid(a.space_int(jnp.abs(u)), x=t, axis=-1)
        return J1 + J2 + J3 + J4

    # -- adjoint -----------------------------------------------------------
    def adjoint_r(self, state: LowMemState, u, phi_Q, b1, b2, phi_T_target):
        """Reference-scheme adjoint r with segment recomputation.

        Recomputes each segment's phis from its checkpoint just before the
        backward sweep consumes it; O(M/K + K) live states."""
        K, S, rem = self.K, self.S_full, self.rem
        a = self.a
        dts = jnp.asarray(self.dts_np, self.dtype)
        phi0 = state.ck_phi[0] if (S + (rem > 0)) > 0 else state.phi_T
        _, _, m0 = a.init_state(phi0)

        p, q, r = a.terminal(state.phi_T, phi_T_target, b2)
        r_T = r

        def adj_seg(carry, phis, phiQ_seg, dt_seg):
            src = phis - phiQ_seg

            def stp(c, inp):
                phi_n, phi_np1, s_n, s_np1, dt = inp
                return a.adjoint_step(c, phi_n, phi_np1, s_n, s_np1, dt, b1)

            inputs = (phis[:-1], phis[1:], src[:-1], src[1:], dt_seg)
            return jax.lax.scan(stp, carry, inputs, reverse=True)

        if rem:
            i0 = S * K
            (_, phis_t, _) = self._segment_scan(
                state.ck_phi[S], state.ck_mu[S], state.ck_w[S],
                u[i0:], dts[i0:], m0)
            pQ_t = self._phiQ_seg(phi_Q, i0, rem + 1, phi0, phi_T_target)
            (p, q, r), r_tail = adj_seg((p, q, r), phis_t, pQ_t, dts[i0:])
        else:
            r_tail = None

        if S > 0:
            def outer(carry, s_idx):
                i = S - 1 - s_idx
                u_seg = jax.lax.dynamic_slice_in_dim(u, i * K, K + 1, axis=0)
                dt_seg = jax.lax.dynamic_slice_in_dim(dts, i * K, K, axis=0)
                pQ_seg = self._phiQ_seg(phi_Q, i * K, K + 1, phi0,
                                        phi_T_target)
                (_, phis, _) = self._segment_scan(
                    state.ck_phi[i], state.ck_mu[i], state.ck_w[i],
                    u_seg, dt_seg, m0)
                return adj_seg(carry, phis, pQ_seg, dt_seg)

            (p, q, r), r_segs = jax.lax.scan(outer, (p, q, r), jnp.arange(S))
            r_main = jnp.flip(r_segs, axis=0).reshape((S * K,) + r_T.shape)
        else:
            r_main = jnp.zeros((0,) + r_T.shape, self.dtype)

        parts = [r_main]
        if r_tail is not None:
            parts.append(r_tail)
        parts.append(r_T[None])
        return jnp.concatenate(parts, axis=0)


class LowMemPipeline2D:
    """2D checkpointed forward + recomputing adjoint (public API).

    K need not divide M (a shorter tail segment absorbs the remainder), and
    non-uniform dt schedules (partial final step) are supported. Verified to
    reproduce the full-memory adjoint to machine precision
    (tests/test_lowmem.py).
    """

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 K: int = 10):
        self.solver = ForwardSolver2D(config)
        self.adjoint = AdjointSolver2D(self.solver.config)
        self.config = self.solver.config
        self.dtype = self.solver.dtype
        self.core = _LowMemCore(_Adapter2D(self.solver, self.adjoint),
                                self.solver.dts, K, self.solver.t_hist)
        self.K, self.S = self.core.K, self.core.S_full + (self.core.rem > 0)
        self._fwd = jax.jit(self.core.forward_ckpt)
        self._adj = jax.jit(
            lambda st, u, pQ, b1, b2, pT: self.core.adjoint_r(
                st, u, pQ, b1, b2, pT))

    def adjoint_r(self, u, initial_phi=None, b1: float = 5.0,
                  b2: float = 10.0, phi_Q=None, phi_T_target=None):
        """Compute the reference-scheme adjoint r with O(M/K + K) live phi
        states. Returns r of shape (M+1, Nx+1, Ny+1)."""
        cfg = self.config
        s = self.solver
        shape = (cfg.Nx + 1, cfg.Ny + 1)
        dtype = self.dtype
        phi0 = (s.default_initial_phi() if initial_phi is None
                else np.asarray(initial_phi, np.float64))
        u = jnp.asarray(u, dtype)
        assert u.shape == (s.M + 1,) + shape
        phi_Q = (jnp.zeros((s.M + 1,) + shape, dtype) if phi_Q is None
                 else jnp.asarray(phi_Q, dtype))
        phi_T_target = (jnp.zeros(shape, dtype) if phi_T_target is None
                        else jnp.asarray(phi_T_target, dtype))
        state = self._fwd(u, jnp.asarray(phi0, dtype), phi_Q)
        return self._adj(state, u, phi_Q, float(b1), float(b2), phi_T_target)


class LowMemPipeline1D:
    """1D variant (core layout, no duplicated t=0 row)."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None,
                 K: int = 10):
        self.solver = ForwardSolver1D(config)
        self.adjoint = AdjointSolver1D(self.solver.config)
        self.config = self.solver.config
        self.dtype = self.solver.dtype
        self.core = _LowMemCore(_Adapter1D(self.solver, self.adjoint),
                                self.solver.dts, K, self.solver.t_hist)
        self._fwd = jax.jit(self.core.forward_ckpt)
        self._adj = jax.jit(
            lambda st, u, pQ, b1, b2, pT: self.core.adjoint_r(
                st, u, pQ, b1, b2, pT))

    def adjoint_r(self, u, initial_phi=None, b1: float = 0.3,
                  b2: float = 13.0, phi_Q=None, phi_T_target=None):
        cfg = self.config
        s = self.solver
        n = cfg.N + 1
        dtype = self.dtype
        phi0 = (s.default_initial_phi() if initial_phi is None
                else np.asarray(initial_phi, np.float64))
        u = jnp.asarray(u, dtype)
        assert u.shape == (s.M + 1, n)
        phi_Q = (jnp.zeros((s.M + 1, n), dtype) if phi_Q is None
                 else jnp.asarray(phi_Q, dtype))
        phi_T_target = (jnp.zeros((n,), dtype) if phi_T_target is None
                        else jnp.asarray(phi_T_target, dtype))
        state = self._fwd(u, jnp.asarray(phi0, dtype), phi_Q)
        return self._adj(state, u, phi_Q, float(b1), float(b2), phi_T_target)
