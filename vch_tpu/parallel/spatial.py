"""Spatial (grid) sharding: the 2D solver under shard_map with halo exchange.

For very large grids (256x256+, BASELINE.md config 5) the scenario batch
alone may not fill the cards; the grid's x-axis is sharded across devices.
Design (SURVEY.md section 7 stretch goal, completed round 2):

  - the 5-point stencil Laplacian exchanges one halo row per neighbor per
    apply with `lax.ppermute` (neighbor traffic, no all-to-all); global
    Neumann boundaries keep their mirrored-ghost form automatically — the
    first/last shard substitutes its own second/second-to-last row for the
    missing halo, which is exactly the reflection stencil (ops/laplacian.py);
  - the cosine-basis preconditioner's x-transforms contract over the SHARDED
    axis: each shard multiplies its row block of V^-1/V and the partial
    products are combined with `lax.psum_scatter` (reduce-scatter, the
    bandwidth-optimal collective) so the result comes back row-sharded;
  - every scalar reduction in the Newton loop (residual norms, step-ceiling
    minima, the mean-diagonal dbar, mass-correction sums, Krylov inner
    products) becomes a `psum`/`pmin` over the mesh axis — the Krylov
    recurrence itself is unchanged (ops/linsolve.bicgstab with a distributed
    dot_fn).

The whole time marcher (scan over steps, Newton while_loop, Armijo, mass
correction) runs INSIDE one shard_map, so a forward solve is one compiled
SPMD program per mesh. Parity-gated against the unsharded ForwardSolver2D
on the 8-virtual-device CPU mesh (tests/test_spatial_sharding.py).

Replaces the role of scipy spsolve on the monolithic grid
(ref: Forward2_solver.py:370) at scales where one chip's HBM cannot hold
the working set.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vch_tpu.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu.models.forward1d import solve_w
from vch_tpu.models.timegrid import build_dt_schedule, t_history
from vch_tpu.ops.grids import trapz_weights
from vch_tpu.ops.laplacian import neumann_eigendecomposition
from vch_tpu.ops.linsolve import (bicgstab, bicgstab_split,
                                  bicgstab_split_fixed)
from vch_tpu.ops.potential import f_prime, regularized_log


def _halo_laplacian_local(v, hx, hy, axis_name):
    """Per-shard 2D Laplacian with ppermute halo exchange along axis 0."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)

    up_halo = lax.ppermute(v[-1:], axis_name,
                           [(i, i + 1) for i in range(n - 1)])
    down_halo = lax.ppermute(v[:1], axis_name,
                             [(i, i - 1) for i in range(1, n)])
    # global boundaries: mirrored ghost row (Neumann)
    up = jnp.where(idx == 0, v[1:2], up_halo)
    down = jnp.where(idx == n - 1, v[-2:-1], down_halo)

    pad = jnp.concatenate([up, v, down], axis=0)
    lap_x = (pad[:-2] - 2.0 * v + pad[2:]) / (hx * hx)

    pady = jnp.concatenate([v[:, 1:2], v, v[:, -2:-1]], axis=1)
    lap_y = (pady[:, :-2] - 2.0 * v + pady[:, 2:]) / (hy * hy)
    return lap_x + lap_y


def sharded_laplacian_2d(mesh: Mesh, axis_name: str, hx: float, hy: float):
    """Standalone jitted Laplacian whose x-axis is sharded over `axis_name`
    (kept as the minimal parity probe; the full solver is below)."""
    fn = jax.shard_map(
        partial(_halo_laplacian_local, hx=hx, hy=hy, axis_name=axis_name),
        mesh=mesh, in_specs=P(axis_name, None), out_specs=P(axis_name, None))
    sharding = NamedSharding(mesh, P(axis_name, None))

    @jax.jit
    def apply(v):
        v = jax.device_put(v, sharding)
        return fn(v)

    return apply


class GridShardedForward2D:
    """2D forward marcher + Newton solver sharded over the grid's x-axis.

    Semantics match models/forward2d.ForwardSolver2D step-for-step (CN +
    monolithic Newton via the Schur/spectral solve, step ceiling, Armijo
    with best-trial fallback, interior-only mass correction); only the
    *schedule* is distributed. Requires (Nx+1) divisible by the mesh axis
    size and >= 2 rows per shard (halo width 1).
    """

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 mesh: Optional[Mesh] = None, axis: str = "gx",
                 batch_axis: Optional[str] = None):
        """batch_axis: when set (combined scenarios x grid mesh), the marcher
        takes a LEADING batch axis on (u, phi0) sharded over `batch_axis`
        while field rows stay sharded over `axis` — each device runs the
        per-shard marcher vmapped over its local members, with the gx
        collectives (halo ppermute, psum_scatter transforms, psum'd dots)
        batched across them."""
        self.config = config or ForwardSolverConfig2D()
        cfg = self.config
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), (axis,))
        self.mesh, self.axis = mesh, axis
        self.batch_axis = batch_axis
        n_sh = mesh.shape[axis]
        rows = cfg.Nx + 1
        assert rows % n_sh == 0, (
            f"Nx+1={rows} must be divisible by grid-axis size {n_sh}")
        assert rows // n_sh >= 2, "need >= 2 rows per shard (halo width 1)"
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.hx, self.hy = cfg.Lx / cfg.Nx, cfg.Ly / cfg.Ny
        self.dts = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts, cfg.T)
        self.M = len(self.dts)

        # host-side spectral constants (float64, cast at use)
        lamx, Vx, Vx_inv = neumann_eigendecomposition(cfg.Nx, self.hx)
        lamy, Vy, Vy_inv = neumann_eigendecomposition(cfg.Ny, self.hy)
        d = self.dtype
        # x-matrices enter transposed so the SHARDED axis is their leading
        # axis: VxiT[r] = Vx_inv[:, r], VxT[r] = Vx[:, r]
        self._VxiT = jnp.asarray(Vx_inv.T, d)
        self._VxT = jnp.asarray(Vx.T, d)
        self._lamx = jnp.asarray(lamx, d)
        self._Vy = jnp.asarray(Vy, d)
        self._Vy_inv = jnp.asarray(Vy_inv, d)
        self._lamy = jnp.asarray(lamy, d)
        wx = trapz_weights(cfg.Nx + 1) * self.hx
        wy = trapz_weights(cfg.Ny + 1) * self.hy
        self._wts = jnp.asarray(np.outer(wx, wy), d)

        self.krylov_tol = (cfg.krylov_tol if self.dtype == jnp.float64
                           else max(cfg.krylov_tol, 1e-6))
        self._rtol = 0.0 if self.dtype == jnp.float64 else cfg.newton_rtol
        self._stagnation = self.dtype != jnp.float64

        sh_x = P(axis, None)          # row-sharded fields / x-matrices
        sh_t = P(None, axis, None)    # time-major control/history
        rep = P()
        # nsolve/first_bad are replicated scalars: every shard runs the
        # same psum-coupled Newton loop, so the counts agree by
        # construction (out_specs P() takes one copy)
        if batch_axis is None:
            self._simulate = jax.jit(jax.shard_map(
                self._march_local, mesh=mesh,
                in_specs=(sh_t, sh_x, sh_x, sh_x, P(axis), sh_x, rep, rep,
                          rep),
                out_specs=(sh_t, rep, rep),
                check_vma=False))
        else:
            # combined (scenarios, gx) mesh: vmap the per-shard marcher over
            # the LOCAL batch shard; the gx collectives batch elementwise
            ba = batch_axis
            vm = jax.vmap(self._march_local,
                          in_axes=(0, 0, None, None, None, None, None, None,
                                   None))
            self._simulate = jax.jit(jax.shard_map(
                vm, mesh=mesh,
                in_specs=(P(ba, None, axis, None), P(ba, axis, None), sh_x,
                          sh_x, P(axis), sh_x, rep, rep, rep),
                out_specs=(P(ba, None, axis, None), P(ba), P(ba)),
                check_vma=False))

    # ------------------------------------------------------------------
    def _march_local(self, u_l, phi0_l, VxiT_l, VxT_l, lamx_l, wts_l,
                     Vy, Vy_inv, lamy):
        """Per-shard marcher: u_l (M+1, rows_l, Ny+1); returns local rows of
        the full history (M+1, rows_l, Ny+1)."""
        cfg = self.config
        ax = self.axis
        dtype = self.dtype
        tau, c1, c2 = cfg.tau, cfg.c1, cfg.c2
        gamma, kappa = cfg.gamma, cfg.kappa
        lo, hi = -1.0 + DELTA_SEP, 1.0 - DELTA_SEP
        dts = jnp.asarray(self.dts, dtype)

        psum = lambda s: lax.psum(s, ax)
        pmin = lambda s: lax.pmin(s, ax)
        dot = lambda a, b: psum(jnp.sum(a * b))
        lap = partial(_halo_laplacian_local, hx=self.hx, hy=self.hy,
                      axis_name=ax)
        Ntot = (cfg.Nx + 1) * (cfg.Ny + 1)
        # combined-mesh lockstep: every data-dependent loop predicate is
        # OR'd over the WHOLE mesh so all devices run identical collective
        # sequences — trip counts otherwise diverge across scenario rows
        # and the cross-mesh collective rendezvous deadlocks. Converged
        # members' bodies are masked no-ops, so results are unchanged.
        if self.batch_axis is not None:
            axes = (self.batch_axis, ax)
            sync = lambda p: lax.psum(jnp.asarray(p, jnp.int32), axes) > 0
        else:
            sync = lambda p: p

        # distributed cosine transforms: contract over the sharded x-axis
        # with reduce-scatter (each shard keeps its row block)
        def to_spec(v_l):
            part = jnp.einsum("rk,rm->km", VxiT_l, v_l)
            vhat_l = lax.psum_scatter(part, ax, scatter_dimension=0,
                                      tiled=True)
            return vhat_l @ Vy_inv.T

        def from_spec(vh_l):
            part = jnp.einsum("rk,rm->km", VxT_l, vh_l)
            v_l = lax.psum_scatter(part, ax, scatter_dimension=0, tiled=True)
            return v_l @ Vy.T

        lam_l = lamx_l[:, None] + lamy[None, :]

        def initialize_mu(phi, w):
            return (-kappa * lap(phi)
                    + f_prime(phi, c1, c2, DELTA_SEP) - w)

        def resid(phi, mu, phi_old, mu_old, w_new, w_old, dt):
            lap_avg = 0.5 * lap(phi + phi_old)
            f_cvx = c1 * regularized_log(phi, DELTA_SEP)
            f_ccv = -2.0 * c2 * phi_old
            Rphi = (tau * (phi - phi_old) / dt - kappa * lap_avg + f_cvx
                    + f_ccv - 0.5 * (mu + mu_old) - 0.5 * (w_new + w_old))
            Rmu = (phi - phi_old) / dt - 0.5 * lap(mu + mu_old)
            norm = jnp.sqrt(dot(Rphi, Rphi) + dot(Rmu, Rmu))
            return norm, Rphi, Rmu

        def schur_solve(phi, Rphi, Rmu, dt):
            """Distributed spectral-preconditioned BiCGStab Schur solve
            (ops/linsolve.newton_schur_solve_2d with collective reductions)."""
            phi_sq = jnp.clip(phi * phi, 0.0, 1.0 - DELTA_SEP * DELTA_SEP)
            d = 2.0 * c1 / (1.0 - phi_sq)
            dbar = psum(jnp.sum(d)) / Ntot

            def apply_S(v):
                u = (tau / dt + d) * v - 0.5 * kappa * lap(v)
                return (1.0 / dt) * v - lap(u)

            denom = ((1.0 / dt) + 0.5 * kappa * lam_l ** 2
                     - (tau / dt + dbar) * lam_l)

            def apply_M(v):
                return from_spec(to_spec(v) / denom)

            rhs = lap(Rphi) - Rmu
            dphi = bicgstab(apply_S, rhs, apply_M, tol=self.krylov_tol,
                            max_iter=cfg.krylov_max_iter, dot_fn=dot,
                            sync_pred=(sync if self.batch_axis is not None
                                       else None))
            Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau / dt + d) * dphi
            dmu = 2.0 * (Kpp_dphi + Rphi)
            return dphi, dmu

        def step_ceiling(phi, dphi):
            big = jnp.asarray(jnp.inf, dtype)
            rp = jnp.where(dphi > 0, (hi - phi) / dphi, big)
            rn = jnp.where(dphi < 0, (lo - phi) / dphi, big)
            amax = jnp.minimum(jnp.asarray(2.0, dtype),
                               jnp.minimum(0.9 * pmin(jnp.min(rp)),
                                           0.9 * pmin(jnp.min(rn))))
            bad = ~jnp.isfinite(amax) | (amax <= 0)
            amax = jnp.where(bad, 1.0, amax)
            return jnp.minimum(1.0, amax)

        def newton(phi_old, mu_old, w_old, w_new, dt, mu_init):
            res = lambda p, m: resid(p, m, phi_old, mu_old, w_new, w_old, dt)

            def armijo(phi, mu, dphi, dmu, norm_R):
                eta = 1e-4
                alpha0 = step_ceiling(phi, dphi)

                def cond(c):
                    return sync((~c[6]) & (c[7] < 12))

                def body(c):
                    alpha, phi_a, mu_a, bn, bp, bm, acc, j = c
                    # `go` masks every update: under the combined mesh the
                    # globally OR'd cond forces extra lockstep trips on
                    # members that already accepted or failed out, and those
                    # must be exact no-ops (same schedule as unsharded)
                    go = (~acc) & (j < 12)
                    phi_t = phi + alpha * dphi
                    mu_t = mu + alpha * dmu
                    norm_t, _, _ = res(phi_t, mu_t)
                    better = go & (norm_t < bn)
                    bn = jnp.where(better, norm_t, bn)
                    bp = jnp.where(better, phi_t, bp)
                    bm = jnp.where(better, mu_t, bm)
                    accept = go & (norm_t <= (1.0 - eta * alpha) * norm_R)
                    phi_a = jnp.where(accept, phi_t, phi_a)
                    mu_a = jnp.where(accept, mu_t, mu_a)
                    alpha = jnp.where(go & ~accept, alpha * 0.5, alpha)
                    return (alpha, phi_a, mu_a, bn, bp, bm, acc | accept,
                            j + 1)

                big = jnp.asarray(jnp.inf, dtype)
                init = (alpha0, phi, mu, big, phi, mu, jnp.asarray(False),
                        jnp.asarray(0, jnp.int32))
                (_, phi_a, mu_a, bn, bp, bm, acc, _) = lax.while_loop(
                    cond, body, init)
                use_best = (~acc) & (bn < norm_R)
                phi_out = jnp.where(acc, phi_a, jnp.where(use_best, bp, phi))
                mu_out = jnp.where(acc, mu_a, jnp.where(use_best, bm, mu))
                return phi_out, mu_out

            def cond(carry):
                return sync((~carry[2]) & (carry[3] < cfg.newton_max_iter))

            big = jnp.asarray(jnp.inf, dtype)

            def body(carry):
                phi, mu, done, k, norm0, prev, ns = carry
                norm_R, Rphi, Rmu = res(phi, mu)
                norm0 = jnp.where(k == 0, norm_R, norm0)
                conv = norm_R < cfg.newton_tol
                if self._rtol > 0:
                    conv = conv | (norm_R < self._rtol * norm0)
                if self._stagnation:
                    conv = conv | ((k > 0) & (norm_R >= prev))
                # local budget guard: under the combined mesh the synced
                # cond may run extra lockstep trips; a member past its own
                # newton_max_iter (or converged) must stay frozen
                go = (~conv) & (k < cfg.newton_max_iter)

                def take(args):
                    phi, mu = args
                    dphi, dmu = schur_solve(phi, Rphi, Rmu, dt)
                    return armijo(phi, mu, dphi, dmu, norm_R)

                phi_n, mu_n = lax.cond(go, take, lambda a: a, (phi, mu))
                ns = ns + jnp.where(go, 1, 0).astype(jnp.int32)
                return (phi_n, mu_n, conv, k + 1, norm0, norm_R, ns)

            phi, mu, _, _, _, _, ns = lax.while_loop(
                cond, body, (phi_old, mu_init, jnp.asarray(False),
                             jnp.asarray(0, jnp.int32), big, big,
                             jnp.asarray(0, jnp.int32)))
            return phi, mu, ns

        # -- marcher -----------------------------------------------------
        w0 = jnp.zeros_like(phi0_l)
        mu0 = initialize_mu(phi0_l, w0)
        m0 = psum(jnp.sum(wts_l * phi0_l))

        def step(carry, inp):
            phi, mu, w, nsolve, first_bad, idx = carry
            u_n, u_np1, dt = inp
            w_new = solve_w(w, dt, gamma, u_n, u_np1)
            mu_init = initialize_mu(phi, w_new)
            phi_new, mu_new, k = newton(phi, mu, w, w_new, dt, mu_init)
            phi_c = jnp.clip(phi_new, lo, hi)
            mass_error = psum(jnp.sum(wts_l * phi_c)) - m0
            # runtime sanitizer channel (psum'd, so shard-identical;
            # Forward_solver.py:166-172 semantics like the other paths)
            bad = ~jnp.isfinite(mass_error)
            first_bad = jnp.where((first_bad < 0) & bad, idx, first_bad)
            interior = jnp.abs(phi_c) < (1.0 - DELTA_SEP - 5e-3)
            Wint = psum(jnp.sum(jnp.where(interior, wts_l, 0.0)))
            corrected = jnp.where(interior, phi_c - mass_error / Wint, phi_c)
            fallback = jnp.clip(phi_c - mass_error / (cfg.Lx * cfg.Ly),
                                lo, hi)
            phi_c = jnp.where(jnp.abs(mass_error) > 1e-16,
                              jnp.where(Wint > 0, corrected, fallback),
                              phi_c)
            return (phi_c, mu_new, w_new, nsolve + k, first_bad,
                    idx + 1), phi_c

        inputs = (u_l[:-1], u_l[1:], dts)
        carry0 = (phi0_l, mu0, w0, jnp.asarray(0, jnp.int32),
                  jnp.asarray(-1, jnp.int32), jnp.asarray(0, jnp.int32))
        (_, _, _, nsolve, first_bad, _), phis = lax.scan(step, carry0,
                                                         inputs)
        return (jnp.concatenate([phi0_l[None], phis], axis=0), nsolve,
                first_bad)

    # ------------------------------------------------------------------
    def march(self, u, phi0):
        """Jit-friendly inner API: (u (M+1, n, m), phi0 (n, m)) ->
        (phi_hist sharded, newton_solves, first_bad)."""
        return self._simulate(u, phi0, self._VxiT, self._VxT, self._lamx,
                              self._wts, self._Vy, self._Vy_inv, self._lamy)

    def simulate(self, control=None, initial_phi=None):
        """Run the grid-sharded forward simulation.

        Returns (phi_hist, (x, y), t_hist) with phi_hist row-sharded across
        the mesh (a global jax.Array — np.asarray gathers it). Measured
        Newton-solve counts land in self.last_stats (MarchStats, like
        ForwardSolver2D), and a non-finite mass defect raises (runtime
        sanitizer parity with the other paths)."""
        assert self.batch_axis is None, (
            "simulate() is the single-scenario surface; batched marchers "
            "are driven through march() by GridShardedBatchedProblem2D")
        cfg = self.config
        shape = (cfg.Nx + 1, cfg.Ny + 1)
        d = self.dtype
        if initial_phi is None:
            from vch_tpu.ops.potential import init_phi_random_2d
            initial_phi = init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP,
                                             amp=0.1, seed=42)
        phi0 = jnp.asarray(np.asarray(initial_phi), d)
        u = (jnp.zeros((self.M + 1,) + shape, d) if control is None
             else jnp.asarray(control, d))
        assert u.shape == (self.M + 1,) + shape
        phi_hist, nsolve, first_bad = self.march(u, phi0)
        from vch_tpu.models.forward1d import MarchStats
        self.last_stats = MarchStats(np.asarray(nsolve),
                                     np.asarray(first_bad))
        bad = int(self.last_stats.first_bad_step)
        if bad >= 0:
            raise RuntimeError(
                f"Non-finite mass defect at time step {bad} — solution "
                f"diverged (see Forward_solver.py:166-172 semantics).")
        x = np.linspace(0.0, cfg.Lx, cfg.Nx + 1)
        y = np.linspace(0.0, cfg.Ly, cfg.Ny + 1)
        return phi_hist, (x, y), self.t_hist


class GridShardedAdjoint2D:
    """2D adjoint (p, q, r) backward sweep sharded over the grid's x-axis.

    Semantics match models/adjoint2d.AdjointSolver2D step-for-step (same
    kappa-less A/B CN operators, ref backward2_solver.py:75-246; terminal
    (I - tau L) p_T = b2 (phi_T - phi_Omega), :183-187; dt<=1e-14 skip,
    :212-216) — only the schedule is distributed: the halo-exchange
    Laplacian, the reduce-scatter cosine transforms, and a psum'd inner
    product inside the split-preconditioned BiCGStab (the f32-critical
    conditioning is unchanged; see AdjointSolver2D notes).
    """

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 mesh: Optional[Mesh] = None, axis: str = "gx",
                 batch_axis: Optional[str] = None):
        self.config = config or ForwardSolverConfig2D()
        cfg = self.config
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), (axis,))
        self.mesh, self.axis = mesh, axis
        self.batch_axis = batch_axis
        n_sh = mesh.shape[axis]
        rows = cfg.Nx + 1
        assert rows % n_sh == 0 and rows // n_sh >= 2
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        self.hx, self.hy = cfg.Lx / cfg.Nx, cfg.Ly / cfg.Ny
        lamx, Vx, Vx_inv = neumann_eigendecomposition(cfg.Nx, self.hx)
        lamy, Vy, Vy_inv = neumann_eigendecomposition(cfg.Ny, self.hy)
        d = self.dtype
        self._VxiT = jnp.asarray(Vx_inv.T, d)
        self._VxT = jnp.asarray(Vx.T, d)
        self._lamx = jnp.asarray(lamx, d)
        self._Vy = jnp.asarray(Vy, d)
        self._Vy_inv = jnp.asarray(Vy_inv, d)
        self._lamy = jnp.asarray(lamy, d)
        self.krylov_tol = (cfg.krylov_tol if self.dtype == jnp.float64
                           else max(cfg.krylov_tol, 1e-6))
        self._krylov_fixed = (None if self.dtype == jnp.float64
                              else (cfg.adjoint_krylov_fixed_iters
                                    or cfg.krylov_fixed_iters))

        sh_x = P(axis, None)
        sh_t = P(None, axis, None)
        rep = P()
        if batch_axis is None:
            self._run_sharded = jax.jit(jax.shard_map(
                self._run_local, mesh=mesh,
                in_specs=(sh_t, rep, rep, rep, sh_t, sh_x,
                          sh_x, sh_x, P(axis), rep, rep, rep),
                out_specs=(sh_t, sh_t, sh_t),
                check_vma=False))
        else:
            # combined (scenarios, gx) mesh: per-member (b1, b2, phi_Q,
            # phi_T) batched over the local scenario shard, field rows
            # sharded over gx
            ba = batch_axis
            bt = P(ba, None, axis, None)
            vm = jax.vmap(self._run_local,
                          in_axes=(0, None, 0, 0, 0, 0, None, None, None,
                                   None, None, None))
            self._run_sharded = jax.jit(jax.shard_map(
                vm, mesh=mesh,
                in_specs=(bt, rep, P(ba), P(ba), bt, P(ba, axis, None),
                          sh_x, sh_x, P(axis), rep, rep, rep),
                out_specs=(bt, bt, bt),
                check_vma=False))

    def _run_local(self, phi_l, dts, b1, b2, phiQ_l, phiT_l,
                   VxiT_l, VxT_l, lamx_l, Vy, Vy_inv, lamy):
        cfg = self.config
        ax = self.axis
        tau, gamma, c1, c2 = cfg.tau, cfg.gamma, cfg.c1, cfg.c2
        Ntot = (cfg.Nx + 1) * (cfg.Ny + 1)

        psum = lambda s: lax.psum(s, ax)
        dot = lambda a, b_: psum(jnp.sum(a * b_))
        lap = partial(_halo_laplacian_local, hx=self.hx, hy=self.hy,
                      axis_name=ax)
        # combined-mesh lockstep for the tol-based Krylov solve (see the
        # marcher): predicates OR'd over the whole mesh, converged systems
        # frozen inside bicgstab
        sync = (None if self.batch_axis is None else
                (lambda p: lax.psum(jnp.asarray(p, jnp.int32),
                                    (self.batch_axis, ax)) > 0))

        def to_spec(v_l):
            part = jnp.einsum("rk,rm->km", VxiT_l, v_l)
            vhat_l = lax.psum_scatter(part, ax, scatter_dimension=0,
                                      tiled=True)
            return vhat_l @ Vy_inv.T

        def from_spec(vh_l):
            part = jnp.einsum("rk,rm->km", VxT_l, vh_l)
            v_l = lax.psum_scatter(part, ax, scatter_dimension=0, tiled=True)
            return v_l @ Vy.T

        lam_l = lamx_l[:, None] + lamy[None, :]

        # terminal: (I - tau L) p_T = b2 (phi_T - phi_Omega), exact in the
        # (distributed) cosine basis
        rhs_T = b2 * (phi_l[-1] - phiT_l)
        p_T = from_spec(to_spec(rhs_T) / (1.0 - tau * lam_l))
        q_T = -lap(p_T)
        r_T = jnp.zeros_like(p_T)

        src_all = phi_l - phiQ_l

        def fpp(phi):
            ph = jnp.clip(phi, -1.0 + 1e-8, 1.0 - 1e-8)
            return 2.0 * c1 / (1.0 - ph * ph) - 2.0 * c2

        def step(carry, inp):
            p_next, q_next, r_next = carry
            phi_n, phi_np1, src_n, src_np1, dt = inp
            fpp_n = fpp(phi_n)
            fpp_np1 = fpp(phi_np1)
            fbar = psum(jnp.sum(fpp_n)) / Ntot

            w1 = lap(p_next)
            Bp = (p_next - tau * w1 - 0.5 * dt * lap(w1)
                  + 0.5 * dt * fpp_np1 * w1)
            rhs = Bp + 0.5 * dt * b1 * (src_n + src_np1)

            def apply_A(v):
                w = lap(v)
                return v - tau * w + 0.5 * dt * (lap(w) - fpp_n * w)

            denom = (1.0 - tau * lam_l + 0.5 * dt * lam_l ** 2
                     - 0.5 * dt * fbar * lam_l)
            inv_sqrt = jax.lax.rsqrt(jnp.abs(denom))

            def Phalf(v):
                return from_spec(to_spec(v) * inv_sqrt)

            def Phalf_inv(v):
                return from_spec(to_spec(v) / inv_sqrt)

            if self._krylov_fixed is not None:
                p_n = bicgstab_split_fixed(apply_A, rhs, Phalf, Phalf_inv,
                                           n_iter=self._krylov_fixed,
                                           x0=p_next, dot_fn=dot)
            else:
                p_n = bicgstab_split(apply_A, rhs, Phalf, Phalf_inv,
                                     tol=self.krylov_tol,
                                     max_iter=cfg.krylov_max_iter,
                                     x0=p_next, dot_fn=dot, sync_pred=sync)
            q_n = -lap(p_n)
            den = gamma + 0.5 * dt
            r_n = ((gamma - 0.5 * dt) / den * r_next
                   + 0.5 * dt / den * (q_n + q_next))
            skip = dt <= 1e-14
            out = (jnp.where(skip, p_next, p_n),
                   jnp.where(skip, q_next, q_n),
                   jnp.where(skip, r_next, r_n))
            return out, out

        inputs = (phi_l[:-1], phi_l[1:], src_all[:-1], src_all[1:], dts)
        _, (p_rev, q_rev, r_rev) = lax.scan(step, (p_T, q_T, r_T), inputs,
                                            reverse=True)
        p = jnp.concatenate([p_rev, p_T[None]], axis=0)
        q = jnp.concatenate([q_rev, q_T[None]], axis=0)
        r = jnp.concatenate([r_rev, r_T[None]], axis=0)
        return p, q, r

    def run_impl(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        """Jit-friendly inner API (global jax.Arrays in/out)."""
        d = self.dtype
        return self._run_sharded(phi_hist, jnp.asarray(dts, d),
                                 jnp.asarray(b1, d), jnp.asarray(b2, d),
                                 phi_Q, phi_T_target, self._VxiT, self._VxT,
                                 self._lamx, self._Vy, self._Vy_inv,
                                 self._lamy)

    def run(self, phi_hist, t_hist, b1: float, b2: float,
            phi_Q=None, phi_T_target=None):
        """AdjointSolver2D.run-compatible surface on the grid mesh."""
        assert self.batch_axis is None, (
            "run() is the single-scenario surface; batched sweeps go "
            "through run_impl() with (B,)-shaped b1/b2 "
            "(GridShardedBatchedProblem2D)")
        d = self.dtype
        phi_hist = jnp.asarray(phi_hist, d)
        dts = np.diff(np.asarray(t_hist, np.float64))
        if phi_Q is None:
            phi_Q = jnp.zeros_like(phi_hist)
        else:
            phi_Q = jnp.asarray(phi_Q, d)
        if phi_T_target is None:
            phi_T_target = jnp.zeros(phi_hist.shape[-2:], d)
        else:
            phi_T_target = jnp.asarray(phi_T_target, d)
        return self.run_impl(phi_hist, dts, float(b1), float(b2), phi_Q,
                             phi_T_target)


class GridShardedProblem2D:
    """Full sparse-control PGD with the GRID sharded across the mesh.

    The config-5 story (BASELINE.md: 256x256+ where one member's working
    set outgrows a chip): forward marcher, adjoint sweep, gradient, prox,
    and the host-driven optimistic/backtracking line search all run with
    the field's x-axis sharded (shard_map halo stencils + reduce-scatter
    transforms inside; XLA auto-partitions the elementwise prox/cost
    programs from the input shardings). Wires the grid-sharded callables
    into the same ProximalGradientLoop as ControlProblem2D — identical
    trial schedule, so single-device parity is a direct test
    (tests/test_spatial_sharding.py).
    """

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 opt_config=None, mesh: Optional[Mesh] = None,
                 axis: str = "gx", choice_t: int = 1, choice_q: int = 1,
                 initial_phi=None):
        from vch_tpu.config import OptimizationConfig
        from vch_tpu.control.cost import calculate_cost_2d
        from vch_tpu.control.pgd import PGDSettings, ProximalGradientLoop
        from vch_tpu.control.targets import build_targets_2d
        from vch_tpu.ops.potential import init_phi_random_2d

        self.fwd = GridShardedForward2D(config, mesh=mesh, axis=axis)
        cfg = self.fwd.config
        self.config = cfg
        self.adjoint = GridShardedAdjoint2D(cfg, mesh=self.fwd.mesh,
                                            axis=axis)
        self.opt_config = opt_config or OptimizationConfig.defaults_2d()
        opt = self.opt_config
        d = self.fwd.dtype
        self.phi0 = (init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                        seed=42)
                     if initial_phi is None
                     else np.asarray(initial_phi, np.float64))
        self._phi0_dev = jnp.asarray(self.phi0, d)
        x = np.linspace(0.0, cfg.Lx, cfg.Nx + 1)
        y = np.linspace(0.0, cfg.Ly, cfg.Ny + 1)
        self.x, self.y, self.t_hist = x, y, self.fwd.t_hist
        self._dts = jnp.asarray(self.fwd.dts, d)
        phi_T, phi_Q = build_targets_2d(x, y, self.t_hist, self.phi0,
                                        float(cfg.Lx), float(cfg.Ly),
                                        float(cfg.T), choice_t=choice_t,
                                        choice_q=choice_q)
        self.phi_T_target = jnp.asarray(phi_T, d)
        self.phi_Q_target = jnp.asarray(phi_Q, d)
        self.newton_solves = 0

        def forward(u):
            phis, ns, _bad = self.fwd.march(u, self._phi0_dev)
            # the loop's trial API wants the trajectory; count solves on
            # the side (host callback-free: accumulate after each call)
            return phis

        def adjoint(phi_hist):
            _, _, r = self.adjoint.run_impl(
                phi_hist, self._dts, opt.b1, opt.b2, self.phi_Q_target,
                self.phi_T_target)
            return r

        xj, yj = jnp.asarray(x, d), jnp.asarray(y, d)
        tj = jnp.asarray(self.t_hist, d)

        def cost(phi_hist, u):
            return calculate_cost_2d(phi_hist, u, self.phi_Q_target,
                                     self.phi_T_target, xj, yj, tj,
                                     opt.b1, opt.b2, opt.b3,
                                     opt.kappa_sparsity)

        self.loop = ProximalGradientLoop(
            forward, adjoint, cost, opt,
            settings=PGDSettings.defaults_2d(), search_mode="host")
        # baseline (uncontrolled) trajectory for the loop's initial state
        self._u0 = jnp.zeros((self.fwd.M + 1, cfg.Nx + 1, cfg.Ny + 1), d)

    def optimize(self, max_iter: Optional[int] = None, verbose: bool = True):
        phi0_hist, ns, _ = self.fwd.march(self._u0, self._phi0_dev)
        self.newton_solves = int(np.asarray(ns))
        return self.loop.run(self._u0, phi0_hist, max_iter=max_iter,
                             verbose=verbose)

    def verify_sparsity(self, result, verbose: bool = True):
        from vch_tpu.control.diagnostics import verify_sparsity_condition
        return verify_sparsity_condition(result.u_optimal, result.r_optimal,
                                         self.opt_config.kappa_sparsity,
                                         verbose=verbose)

    def second_order_check(self, result, num_directions: int = 5,
                           epsilon: float = 1e-4, seed: int = 42):
        from vch_tpu.control.diagnostics import (
            approximate_second_order_condition)
        opt = self.opt_config
        return approximate_second_order_condition(
            self.loop.forward, self.loop.cost, result.u_optimal,
            result.r_optimal, result.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=num_directions,
            epsilon=epsilon, seed=seed, handle_kink=False)


from vch_tpu.parallel.batch import _BatchedPGDBase  # noqa: E402


class GridShardedBatchedProblem2D(_BatchedPGDBase):
    """Batched PGD over a combined (scenarios, gx) 2D mesh.

    The last composition the BASELINE config-5 spec implies (4096 scenarios
    at grids where ONE member's working set outgrows a device,
    ref Forward2_solver.py:370 at scale):
    the scenario batch is sharded over the mesh's "scenarios" axis while
    every member's field ROWS are sharded over its "gx" axis. Forward
    marches and adjoint sweeps run as one shard_map program on the full
    mesh — the per-shard marcher/adjoint of GridSharded{Forward,Adjoint}2D
    vmapped over the device's local members, with the gx collectives (halo
    ppermute, psum_scatter cosine transforms, psum'd Krylov dots) batched
    across them. The prox/cost/merge programs are plain XLA whose shardings
    propagate from the inputs. Reuses _BatchedPGDBase's masked host-driven
    optimistic/backtracking search unchanged, so semantics match
    BatchedProblem2D member-for-member (tests/test_spatial_sharding.py).
    """

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 settings=None, alpha_max: float = 50.0,
                 mesh: Optional[Mesh] = None, grid_axis: str = "gx",
                 grid_shards: Optional[int] = None):
        from vch_tpu.control.pgd import PGDSettings
        from vch_tpu.parallel.mesh import BATCH_AXIS

        self.fwd_config = fwd_config or ForwardSolverConfig2D()
        cfg = self.fwd_config
        if mesh is None:
            devs = np.array(jax.devices())
            gs = grid_shards or 2
            bs = devs.size // gs
            assert bs >= 1, (devs.size, gs)
            mesh = Mesh(devs[: bs * gs].reshape(bs, gs),
                        (BATCH_AXIS, grid_axis))
        assert BATCH_AXIS in mesh.axis_names and grid_axis in mesh.axis_names
        self.grid_axis = grid_axis
        self.fwd = GridShardedForward2D(cfg, mesh=mesh, axis=grid_axis,
                                        batch_axis=BATCH_AXIS)
        self.adj = GridShardedAdjoint2D(cfg, mesh=mesh, axis=grid_axis,
                                        batch_axis=BATCH_AXIS)
        self.dtype = self.fwd.dtype
        M = self.fwd.M
        self._control_shape = (M + 1, cfg.Nx + 1, cfg.Ny + 1)
        self._control_is_state_shaped = True
        self._dts = jnp.asarray(self.fwd.dts, self.dtype)
        self._x = jnp.asarray(np.linspace(0.0, cfg.Lx, cfg.Nx + 1),
                              self.dtype)
        self._y = jnp.asarray(np.linspace(0.0, cfg.Ly, cfg.Ny + 1),
                              self.dtype)
        self._t = jnp.asarray(self.fwd.t_hist, self.dtype)

        # whole-batch callables for the generic engine: the batch-forward /
        # batch-adjoint slots carry the shard_map programs (the engine's
        # per-member vmap path cannot wrap a shard_map)
        def _fwd(u, phi0, phi_Q=None, phi_T=None):
            phi, ns, _bad = self.fwd.march(u, phi0)   # ns is (B,) per-member
            return phi, ns

        def _adjoint(u, phi, b1, b2, phi_Q, phi_T):
            _, _, r = self.adj.run_impl(phi, self._dts, b1, b2, phi_Q,
                                        phi_T)
            return r

        self._batch_forward = _fwd
        self._batch_adjoint = _adjoint
        # the shard_map programs hard-require B divisible by the scenario
        # axis; run() raises a clear error instead of an opaque shard_map
        # partition failure (there is no unsharded fallback here)
        self._requires_divisible_batch = True
        super().__init__(settings or PGDSettings.defaults_2d(), alpha_max,
                         mesh=mesh)

    def _cost(self, phi_hist, u, phi_Q, phi_T, b1, b2, b3, ks):
        from vch_tpu.control.cost import calculate_cost_2d
        return calculate_cost_2d(phi_hist, u, phi_Q, phi_T, self._x,
                                 self._y, self._t, b1, b2, b3, ks)

    def _input_sharding(self, a):
        """Rank-based placement on the combined mesh: batch over
        "scenarios", field rows over the grid axis. (B,) weights -> P(b);
        (B, nx, ny) phi0/phi_T -> P(b, gx); (B, M+1, nx, ny)
        u/phi_Q/trajectories -> P(b, None, gx). `a` may be a host numpy
        array — only its rank is read (no device transfer)."""
        from vch_tpu.parallel.mesh import BATCH_AXIS
        gx = self.grid_axis
        spec = {1: P(BATCH_AXIS),
                3: P(BATCH_AXIS, gx, None),
                4: P(BATCH_AXIS, None, gx, None)}[np.ndim(a)]
        return NamedSharding(self.mesh, spec)
