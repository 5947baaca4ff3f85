"""Batched, mesh-sharded PGD over scenario sweeps.

The scenario batch is the unit of work on the accelerator (SURVEY.md
section 7): each member has its own initial condition, targets, and cost
weights (b1, b2, b3, kappa_spar). The adjoint sweep, gradient, prox, and
each line-search trial (prox + full forward + cost) are vmapped jitted
programs; the optimistic/backtracking schedule itself is driven from the
host with per-member masks, so members that accept early are frozen while
others keep backtracking, and the forward scan stays a TOP-LEVEL jit (see
ProximalGradientLoop.search_mode). With a Mesh, batch-axis inputs are
device_put with NamedSharding and jit propagates the sharding, so the same
programs span devices with XLA inserting any needed collectives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vch_tpu.config import (
    ForwardSolverConfig1D,
    ForwardSolverConfig2D,
    OptimizationConfig,
)
from vch_tpu.control.cost import calculate_cost_1d, calculate_cost_2d
from vch_tpu.control.pgd import PGDSettings
from vch_tpu.control.prox import proximal_step
from vch_tpu.control.targets import build_targets_1d, build_targets_2d
from vch_tpu.models.adjoint1d import AdjointSolver1D
from vch_tpu.models.adjoint2d import AdjointSolver2D
from vch_tpu.models.forward1d import ForwardSolver1D
from vch_tpu.models.forward2d import ForwardSolver2D
from vch_tpu.parallel.mesh import BATCH_AXIS, batch_sharding, make_mesh
from vch_tpu.runtime import donated


def _host_read(a):
    """Fetch a (small) device output for host-side control flow.

    Single-process this is np.asarray. Under multi-process SPMD
    (jax.distributed, scripts/multiprocess_cpu.py) the search/convergence
    arrays are sharded over processes and not fully addressable, so they
    are allgathered first — every process then drives the identical host
    schedule (the predicates this feeds must agree globally or the
    lockstep trial programs would diverge)."""
    if isinstance(a, jax.Array) and not a.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


@dataclass
class ScenarioBatch:
    """Per-scenario inputs, each with leading batch axis B (numpy, host)."""

    phi0: np.ndarray        # (B, *space)
    phi_T: np.ndarray       # (B, *space)
    phi_Q: Optional[np.ndarray]   # (B, M+1, *space), or None when procedural
    b1: np.ndarray          # (B,)
    b2: np.ndarray          # (B,)
    b3: np.ndarray          # (B,)
    kappa_spar: np.ndarray  # (B,)
    u_min: float = -1.0
    u_max: float = 1.0
    # procedural tracking target, used when phi_Q is None: "ramp" is the
    # linear time-ramp phi0 -> phi_T (targets.py choice_q=1), "zeros" is
    # choice_q=2. Synthesized per segment on device instead of storing
    # O(M) frames per member (models/lowmem._phiQ_seg).
    phi_Q_mode: Optional[str] = None

    @property
    def batch(self) -> int:
        return self.phi0.shape[0]


def sweep_1d(fwd_config: ForwardSolverConfig1D,
             opt_config: Optional[OptimizationConfig] = None,
             b3_values=None, kappa_values=None,
             choice_t: int = 1, choice_q: int = 1) -> ScenarioBatch:
    """Build a (b3, kappa_spar) sweep batch with the default IC/targets
    (BASELINE.md benchmark config 2)."""
    opt = opt_config or OptimizationConfig()
    solver = ForwardSolver1D(fwd_config)
    phi0 = solver.default_initial_phi()
    t_core = solver.t_hist
    phi_T, phi_Q = build_targets_1d(solver.x, t_core, phi0,
                                    float(fwd_config.Lx), float(fwd_config.T),
                                    choice_t=choice_t, choice_q=choice_q)
    b3s = np.asarray(b3_values if b3_values is not None else [opt.b3])
    kss = np.asarray(kappa_values if kappa_values is not None else [opt.kappa_sparsity])
    g_b3, g_ks = np.meshgrid(b3s, kss, indexing="ij")
    B = g_b3.size
    rep = lambda a: np.broadcast_to(a, (B,) + a.shape).copy()
    return ScenarioBatch(
        phi0=rep(phi0), phi_T=rep(phi_T), phi_Q=rep(phi_Q),
        b1=np.full(B, opt.b1), b2=np.full(B, opt.b2),
        b3=g_b3.ravel(), kappa_spar=g_ks.ravel(),
        u_min=opt.u_min, u_max=opt.u_max)


def sweep_2d(fwd_config: ForwardSolverConfig2D,
             opt_config: Optional[OptimizationConfig] = None,
             b3_values=None, kappa_values=None,
             choice_t: int = 1, choice_q: int = 1,
             materialize_phi_Q: bool = True) -> ScenarioBatch:
    """2D sweep batch (BASELINE.md benchmark configs 4-5).

    materialize_phi_Q=False stores NO tracking-target frames — phi_Q is a
    closed form of (phi0, phi_T, t) for both reference target choices, and
    the low-memory problem synthesizes it per segment on device
    (ScenarioBatch.phi_Q_mode). At config-4 scale the stored array is
    1.7 GB (B=256) of pure redundancy."""
    opt = opt_config or OptimizationConfig.defaults_2d()
    solver = ForwardSolver2D(fwd_config)
    phi0 = solver.default_initial_phi()
    phi_T, phi_Q = build_targets_2d(solver.x, solver.y, solver.t_hist, phi0,
                                    float(fwd_config.Lx), float(fwd_config.Ly),
                                    float(fwd_config.T),
                                    choice_t=choice_t, choice_q=choice_q)
    b3s = np.asarray(b3_values if b3_values is not None else [opt.b3])
    kss = np.asarray(kappa_values if kappa_values is not None else [opt.kappa_sparsity])
    g_b3, g_ks = np.meshgrid(b3s, kss, indexing="ij")
    B = g_b3.size
    rep = lambda a: np.broadcast_to(a, (B,) + a.shape).copy()
    return ScenarioBatch(
        phi0=rep(phi0), phi_T=rep(phi_T),
        phi_Q=rep(phi_Q) if materialize_phi_Q else None,
        b1=np.full(B, opt.b1), b2=np.full(B, opt.b2),
        b3=g_b3.ravel(), kappa_spar=g_ks.ravel(),
        u_min=opt.u_min, u_max=opt.u_max,
        phi_Q_mode=None if materialize_phi_Q
        else ("ramp" if choice_q == 1 else "zeros"))


class _BatchedPGDBase:
    """Shared machinery: vmapped jitted iteration + vectorized host loop."""

    def __init__(self, settings: PGDSettings, alpha_max: float,
                 mesh=None, use_mesh: bool = False,
                 straggler_batch: Optional[int] = None,
                 speculative: Optional[bool] = None,
                 chunk_size: Optional[int] = None):
        self.s = settings
        self.alpha_max = alpha_max
        self.mesh = mesh if mesh is not None else (make_mesh() if use_mesh else None)
        # Chunked execution: run the vmapped device programs on chunk_size
        # members at a time (B must divide evenly; otherwise runs whole).
        # Identical semantics — members are independent — but it bounds the
        # LOCKSTEP cost of the vmapped Newton/Armijo while_loops: one
        # vmapped program iterates until its slowest member converges each
        # CN step, so a single hard member stalls all B; with chunks only
        # its chunk waits. Single device only (chunks of a sharded batch
        # would serialize the mesh).
        self.chunk_size = chunk_size
        self.chunk_calls = 0          # diagnostic: chunked device calls
        # Straggler compaction: once <= straggler_batch members are still
        # backtracking, gather them into a smaller compiled trial program
        # instead of re-running (and masking out) the whole batch. Identical
        # semantics, ~B/straggler_batch fewer FLOPs per straggler round; one
        # extra compile at the sub-batch shape. UNITS: on a single
        # device a numeric straggler_batch is a GLOBAL sub-batch
        # size; under a 1-axis scenario mesh each device gathers its own
        # local stragglers, so the same number is a PER-DEVICE bucket size
        # (triggering at up to n_devices x more global stragglers). "auto"
        # = bucketed ladder (smallest power-of-2 bucket >= the straggler
        # count each round), sized per round either way; the recommended
        # setting under a mesh.
        self.straggler_batch = straggler_batch or None
        self.straggler_rounds = 0   # diagnostic: sub-batch rounds taken
        # Speculative ladder packing (see _search_speculative). OPT-IN: a
        # packed round mixes easy and hard alpha candidates in one lockstep
        # vmapped program, so the hardest row stalls every other row, and
        # the gather moves the full scenario set through device memory each
        # round. Meant for strongly heterogeneous batches where a few
        # members dominate trials.
        self.speculative = bool(speculative)
        self.speculative_rounds = 0

        # Host-driven search (see ProximalGradientLoop.search_mode='host'):
        # each jitted piece keeps the forward scan at top level.
        def _adjoint_only(u, phi, b1, b2, phi_Q, phi_T):
            return self._adjoint(phi, u, b1, b2, phi_Q, phi_T)

        # Whole-batch adjoint: set by a subclass whose programs cannot be
        # vmapped per member (the combined-mesh shard_map program,
        # parallel/spatial.py) as self._batch_adjoint
        # (u, phi, b1, b2, phi_Q, phi_T) -> r. Replaces vmap(adjoint).
        batch_adj = getattr(self, "_batch_adjoint", None)

        def _trial(u, r, alpha, phi0, phi_Q, phi_T, b1, b2, b3, ks):
            # grad = r + b3 u computed HERE (fused into the prox) rather
            # than persisted across the search: a control-shaped buffer is
            # 1.7 GB at config-4 scale (B=256, 128x128) and device-memory
            # residency, not FLOPs, is what bounds the max batch per card
            grad = r + b3 * u
            u_t = proximal_step(u, grad, alpha, ks, self.u_min, self.u_max)
            phi_t, nsolve = self._forward_stats(u_t, phi0, phi_Q, phi_T)
            c_t = self._cost(phi_t, u_t, phi_Q, phi_T, b1, b2, b3, ks)
            return u_t, phi_t, c_t, nsolve

        def _merge(take, new, old):
            """Per-member where over a (B,...) pytree given a (B,) mask."""
            def sel(a, b):
                m = take.reshape((-1,) + (1,) * (a.ndim - 1))
                return jnp.where(m, a, b)
            return jax.tree_util.tree_map(sel, new, old)

        def _change(u1, u):
            # axis-wise reduction, NOT reshape(B, -1)+norm: a reshape that
            # merges a sharded field axis into the flattened dim forces a
            # gather on the combined (scenarios, gx) mesh; the sum-of-
            # squares form reduces in place under any sharding
            axes = tuple(range(1, u.ndim))
            num = jnp.sqrt(jnp.sum((u1 - u) ** 2, axis=axes))
            den = jnp.sqrt(jnp.sum(u ** 2, axis=axes)) + 1e-9
            return num / den

        def _chunked(fn):
            """Wrap a jitted batch-axis fn to execute chunk_size members per
            device call (no-op when chunking is off / indivisible /
            sharded). Pure orchestration: outputs are concatenated, so the
            result is bit-identical to the single-call form."""
            def call(*args):
                c = self.chunk_size
                B = next(a.shape[0] for a in jax.tree_util.tree_leaves(args)
                         if hasattr(a, "shape") and a.ndim > 0)
                if not c or c >= B or B % c or self.mesh is not None:
                    return fn(*args)
                outs = []
                for i in range(0, B, c):
                    sl = lambda a: (a[i:i + c]
                                    if hasattr(a, "ndim") and a.ndim > 0
                                    and a.shape[0] == B else a)
                    outs.append(fn(*jax.tree_util.tree_map(sl, args)))
                    self.chunk_calls += 1
                return jax.tree_util.tree_map(
                    lambda *xs: jnp.concatenate(xs, axis=0), *outs)
            return call

        self._adjoint_v = _chunked(self._maybe_shard(
            batch_adj if batch_adj is not None else jax.vmap(_adjoint_only)))

        # Whole-batch forward, the companion of _batch_adjoint:
        # (u, phi0, phi_Q, phi_T) -> (phi, newton_solves (B,)). It replaces
        # vmap(forward) inside the trial; prox and cost stay vmapped
        # elementwise/reduction programs around the single call.
        batch_fwd = getattr(self, "_batch_forward", None)

        def _trial_batched(u, r, alpha, phi0, phi_Q, phi_T, b1, b2, b3, ks):
            def prox_one(u_i, r_i, a_i, b3_i, ks_i):
                grad = r_i + b3_i * u_i
                return proximal_step(u_i, grad, a_i, ks_i,
                                     self.u_min, self.u_max)
            u_t = jax.vmap(prox_one)(u, r, alpha, b3, ks)
            phi_t, nsolve = batch_fwd(u_t, phi0, phi_Q, phi_T)
            c_t = jax.vmap(self._cost)(phi_t, u_t, phi_Q, phi_T, b1, b2,
                                       b3, ks)
            return u_t, phi_t, c_t, nsolve

        self._trial_jit = self._maybe_shard(
            _trial_batched if batch_fwd is not None else jax.vmap(_trial))
        self._trial_v = _chunked(self._trial_jit)

        def _gather(idx, *trees):
            take = lambda a: None if a is None else jnp.take(a, idx, axis=0)
            return jax.tree_util.tree_map(take, trees)

        def _scatter(res, out_sub, idx, take_sub):
            """Write accepted sub-batch trial results back into the full-batch
            selection. Padding rows carry indices of NON-searching members
            with take=False, so they rewrite their own current value (no-op)
            and never collide with a real searching index."""
            def upd(full, sub):
                m = take_sub.reshape((-1,) + (1,) * (sub.ndim - 1))
                return full.at[idx].set(jnp.where(m, sub, full[idx]))
            return jax.tree_util.tree_map(upd, res, out_sub)

        self._gather_v = jax.jit(_gather)
        # donate the previous selection: after the masked write it is never
        # referenced again
        self._scatter_v = jax.jit(_scatter, donate_argnums=donated(0))
        # Shard-LOCAL gather/scatter for per-device straggler compaction
        # under the scenario mesh: members are
        # shard-local and independent, so each device gathers its OWN
        # stragglers by LOCAL index inside shard_map — no collectives; the
        # compacted (D*sb) batch then runs the same sharded trial program.
        # 1-axis scenario meshes only (on the combined (scenarios, gx) mesh
        # a P(scenarios) gather would re-replicate the gx-sharded rows).
        if self.mesh is not None and len(self.mesh.axis_names) == 1:
            from jax.sharding import PartitionSpec as P
            spec = P(BATCH_AXIS)

            # the SAME _gather/_scatter bodies as the single-chip path,
            # wrapped in shard_map so each device applies them to its own
            # block with LOCAL indices — one definition serves both paths
            self._gather_local_v = jax.jit(jax.shard_map(
                _gather, mesh=self.mesh, in_specs=spec,
                out_specs=spec, check_vma=False))
            _sc = jax.shard_map(_scatter, mesh=self.mesh,
                                in_specs=spec, out_specs=spec,
                                check_vma=False)
            self._scatter_local_v = jax.jit(_sc, donate_argnums=donated(0))
        else:
            self._gather_local_v = None
            self._scatter_local_v = None
        # donate the PREVIOUS selection: after the masked select it is
        # never referenced again, so each merge output aliases its old
        # buffer, one full (u, trajectory, cost) set off the search's peak
        # device memory. (Only the old selection: a single output can alias
        # only one input, so donating the trial outputs too leaves a
        # donated buffer unusable and warns.)
        self._merge_v = jax.jit(_merge, donate_argnums=donated(2))
        self._change_v = jax.jit(_change)
        self._forward_v = _chunked(self._maybe_shard(
            batch_fwd if batch_fwd is not None else
            jax.vmap(lambda u, p0, pQ, pT: self._forward_stats(u, p0, pQ,
                                                               pT))))
        self._cost_v = self._maybe_shard(jax.vmap(self._cost))

    def _maybe_shard(self, fn):
        """Jit fn. Sharding is applied by device_put of the inputs in run();
        jit propagates input shardings, so one compiled program serves the
        replicated and the mesh-sharded cases."""
        return jax.jit(fn)

    def _batch_shards(self) -> int:
        """Number of shards along the scenario axis. For the plain scenario
        mesh this is the device count; a combined (scenarios, gx) mesh
        (GridShardedBatchedProblem2D) shards the batch over its scenario
        axis only."""
        if self.mesh is None:
            return 1
        return self.mesh.shape.get(BATCH_AXIS, self.mesh.devices.size)

    def _input_sharding(self, a):
        """NamedSharding for a batch-leading input array; overridden by the
        combined-mesh problem to also shard field rows over the grid axis."""
        return batch_sharding(self.mesh)

    def _set_phi_Q_mode(self, mode: Optional[str]):
        """Procedural tracking targets (ScenarioBatch.phi_Q=None) need a
        problem class that synthesizes them; the default batched problems
        require materialized phi_Q."""
        raise ValueError(
            "ScenarioBatch.phi_Q=None (procedural targets) is supported by "
            "LowMemBatchedProblem2D only; pass a materialized phi_Q here")

    def _search(self, u, phi_b, cost_np, alpha_prev_np, r, phi0,
                phi_Q, phi_T, b1, b2, b3, ks, dtype):
        """Masked host-driven optimistic+backtracking over the batch.

        Replicates the reference trial schedule per member: alpha_prev
        first, then alpha_prev*ls_alpha_factor*ls_beta^(j-1); failed-out
        members keep their LAST tried (worse) iterate with alpha already
        multiplied by beta (GD_1D.py:110-113 semantics).
        """
        s = self.s
        B = cost_np.shape[0]
        max_trials = 1 + s.ls_max_trials
        searching = np.ones(B, dtype=bool)
        alpha_try = alpha_prev_np.copy()
        n_trials = np.zeros(B, dtype=int)
        opt_ok = np.zeros(B, dtype=bool)
        res = None
        res_alpha = alpha_prev_np.copy()
        solves = 0
        phase = {"optimistic": 0.0, "backtracking": 0.0}
        import time as _time
        sb = self.straggler_batch
        # per-device compaction geometry (mesh path): members are placed in
        # contiguous blocks of B/D per device by NamedSharding(P(scenarios))
        D = 0
        if (self.mesh is not None and self._gather_local_v is not None
                and sb is not None):
            Dm = self._batch_shards()
            if B % Dm == 0:
                D = Dm
        for j in range(max_trials):
            t_j = _time.perf_counter()
            n_search = int(searching.sum())
            last = j == max_trials - 1
            nxt = np.where(j == 0, alpha_prev_np * s.ls_alpha_factor,
                           alpha_try * s.ls_beta)
            # mesh path: per-DEVICE bucket, sized by the worst device's
            # straggler count (SPMD needs one uniform local shape)
            use_sub_mesh = False
            if D > 0 and j > 0 and res is not None and n_search > 0:
                B_local = B // D
                s2 = searching.reshape(D, B_local)
                counts = int(s2.sum(axis=1).max())
                if sb == "auto":
                    sb_loc = 8
                    while sb_loc < counts:
                        sb_loc *= 2
                else:
                    sb_loc = sb if counts <= sb else None
                use_sub_mesh = bool(sb_loc) and sb_loc < B_local
            if sb == "auto":
                # bucketed ladder: smallest power-of-2 sub-batch that holds
                # the still-searching set (>= 8, < B). One compile per
                # bucket shape (prewarm() pays them up front); each
                # backtracking round then costs FLOPs proportional to the
                # straggler count instead of the full batch.
                sb_j = 8
                while sb_j < n_search:
                    sb_j *= 2
                if sb_j >= B:
                    sb_j = None
            else:
                sb_j = sb
            use_sub = (sb_j is not None and j > 0 and res is not None
                       and 0 < n_search <= sb_j < B and self.mesh is None)
            if use_sub_mesh:
                self.straggler_rounds += 1
                # per-device compaction: each device gathers its own
                # stragglers by LOCAL index (padded with its own
                # non-searching rows, whose writes are masked off) inside
                # shard_map — identical semantics, B_local/sb_loc fewer
                # FLOPs per device for the backtracking tail, no collectives
                loc_blocks, glob_blocks = [], []
                for dv in range(D):
                    loc_s = np.nonzero(s2[dv])[0]
                    loc_ns = np.nonzero(~s2[dv])[0][: sb_loc - loc_s.size]
                    loc = np.concatenate([loc_s, loc_ns])
                    loc_blocks.append(loc)
                    glob_blocks.append(dv * B_local + loc)
                idx_loc = jnp.asarray(np.concatenate(loc_blocks))
                idx_glob = np.concatenate(glob_blocks)
                g = self._gather_local_v(idx_loc, u, r, phi0, phi_Q, phi_T,
                                         b1, b2, b3, ks)
                out = self._trial_v(g[0], g[1],
                                    jnp.asarray(alpha_try[idx_glob], dtype),
                                    *g[2:])
                c_sub = _host_read(out[2])
                solves += int(_host_read(out[3]).sum())
                ok = np.zeros(B, dtype=bool)
                ok[idx_glob] = c_sub < cost_np[idx_glob]
                take = searching & (ok | last)
                res = self._scatter_local_v(res, out[:3], idx_loc,
                                            jnp.asarray(take[idx_glob]))
            elif use_sub:
                self.straggler_rounds += 1
                # straggler compaction: gather the still-searching members
                # (+ non-searching padding rows, whose writes are masked off
                # and whose indices cannot collide with a searching one) into
                # a sub-batch trial program — identical semantics, B/sb fewer
                # FLOPs for the backtracking tail
                idx = np.concatenate([
                    np.nonzero(searching)[0],
                    np.nonzero(~searching)[0][: sb_j - n_search]])
                idx_j = jnp.asarray(idx)
                g = self._gather_v(idx_j, u, r, phi0, phi_Q, phi_T,
                                   b1, b2, b3, ks)
                out = self._trial_v(g[0], g[1],
                                    jnp.asarray(alpha_try[idx], dtype), *g[2:])
                c_sub = _host_read(out[2])
                solves += int(_host_read(out[3]).sum())
                ok = np.zeros(B, dtype=bool)
                ok[idx] = c_sub < cost_np[idx]
                take = searching & (ok | last)
                res = self._scatter_v(res, out[:3], idx_j,
                                      jnp.asarray(take[idx]))
            else:
                out = self._trial_v(u, r, jnp.asarray(alpha_try, dtype),
                                    phi0, phi_Q, phi_T, b1, b2, b3, ks)
                c_np = _host_read(out[2])
                # every member executes every round (masked merge); count the
                # Newton solves actually performed, from the while_loops
                solves += int(_host_read(out[3]).sum())
                ok = c_np < cost_np
                take = searching & (ok | last)
                if res is None:
                    res = out[:3]
                else:
                    res = self._merge_v(jnp.asarray(take), out[:3], res)
            res_alpha = np.where(take, np.where(ok, alpha_try, nxt),
                                 res_alpha)
            n_trials = np.where(searching, j + 1, n_trials)
            if j == 0:
                opt_ok = ok.copy()
            # c_np is already fetched, so the device work of this round is
            # drained: attribute it to the reference's phase taxonomy
            # (optimistic_eval_total vs backtracking, GD_1D.py:563-576)
            phase["optimistic" if j == 0 else "backtracking"] += (
                _time.perf_counter() - t_j)
            searching = searching & ~ok
            if not searching.any():
                break
            alpha_try = np.where(searching, nxt, alpha_try)
        u1, phi1, c1 = res
        return (u1, phi1, _host_read(c1), res_alpha, n_trials, opt_ok, solves,
                phase)

    def _search_speculative(self, u, phi_b, cost_np, alpha_prev_np, r, phi0,
                            phi_Q, phi_T, b1, b2, b3, ks, dtype):
        """Reference-identical search, but the backtracking ladder is
        evaluated SPECULATIVELY: once <= B/2 members are still searching,
        one full-batch trial call packs several ladder candidates
        alpha_prev*f*beta^(t-1) per straggler (round-robin over the B rows of
        the SAME compiled trial program), and each member keeps its
        first-succeeding candidate — exactly what the sequential schedule
        would have selected, several rounds at a time. A 6-trial episode
        costs ~2 rounds instead of 6. Single-chip path (a cross-member gather
        over a sharded batch axis would insert collectives per round);
        semantics parity is gated by
        test_batched_2d_speculative_matches_sequential.
        """
        s = self.s
        B = cost_np.shape[0]
        max_trials = 1 + s.ls_max_trials
        import time as _time
        phase = {"optimistic": 0.0, "backtracking": 0.0}
        solves = 0

        # round 0: optimistic trial at alpha_prev for every member
        t_j = _time.perf_counter()
        out = self._trial_v(u, r, jnp.asarray(alpha_prev_np, dtype),
                            phi0, phi_Q, phi_T, b1, b2, b3, ks)
        c_np = _host_read(out[2])
        solves += int(_host_read(out[3]).sum())
        ok = c_np < cost_np
        res = out[:3]
        opt_ok = ok.copy()
        phase["optimistic"] += _time.perf_counter() - t_j

        searching = ~ok
        pos = np.ones(B, dtype=int)         # ladder trials consumed so far
        n_trials = np.ones(B, dtype=int)
        res_alpha = np.where(ok, alpha_prev_np,
                             alpha_prev_np * s.ls_alpha_factor)
        lead = alpha_prev_np * s.ls_alpha_factor  # ladder head per member

        def ladder(member, t):
            # alpha of logical backtracking trial t (t = 1, 2, ...)
            return lead[member] * s.ls_beta ** (t - 1)

        while searching.any():
            t_j = _time.perf_counter()
            idx_s = np.nonzero(searching)[0]
            n_s = idx_s.size
            if n_s > B // 2:
                # too many stragglers to pack >=2 candidates each: plain
                # full-batch masked round, one ladder step per member
                alpha_try = np.where(searching, ladder(np.arange(B), pos),
                                     res_alpha)
                out = self._trial_v(u, r, jnp.asarray(alpha_try, dtype),
                                    phi0, phi_Q, phi_T, b1, b2, b3, ks)
                c_np = _host_read(out[2])
                solves += int(_host_read(out[3]).sum())
                ok_full = (c_np < cost_np) & searching
                pos_new = pos + searching
                fail_out = searching & ~ok_full & (pos_new >= max_trials)
                take = ok_full | fail_out
                res = self._merge_v(jnp.asarray(take), out[:3], res)
                res_alpha = np.where(
                    ok_full, alpha_try,
                    np.where(fail_out, alpha_try * s.ls_beta, res_alpha))
                n_trials = np.where(take, pos_new, n_trials)
                pos = pos_new
                searching = searching & ~take
                phase["backtracking"] += _time.perf_counter() - t_j
                continue

            # speculative packing: distribute the B rows of the SAME trial
            # program round-robin over the stragglers' remaining ladders
            self.speculative_rounds += 1
            rem = max_trials - pos[idx_s]               # ladder steps left
            base, extra = divmod(B, n_s)
            counts = np.minimum(base + (np.arange(n_s) < extra), rem)
            rows_m = np.repeat(idx_s, counts)
            rows_t = np.concatenate(
                [pos[m] + np.arange(c) for m, c in zip(idx_s, counts)])
            n_rows = rows_m.size
            idle = np.nonzero(~searching)[0]    # >= B/2 of them here
            h = int(idle[0])
            if n_rows < B:
                # pad with an idle member; its rows never write back
                rows_m = np.concatenate(
                    [rows_m, np.full(B - n_rows, h, dtype=int)])
                rows_t = np.concatenate(
                    [rows_t, np.ones(B - n_rows, dtype=int)])
            alpha_rows = ladder(rows_m, rows_t)

            idx_j = jnp.asarray(rows_m)
            g = self._gather_v(idx_j, u, r, phi0, phi_Q, phi_T,
                               b1, b2, b3, ks)
            out = self._trial_v(g[0], g[1], jnp.asarray(alpha_rows, dtype),
                                *g[2:])
            c_rows = np.asarray(out[2])
            solves += int(_host_read(out[3]).sum())
            ok_rows = c_rows < cost_np[rows_m]

            # per straggler: keep the FIRST succeeding candidate in ladder
            # order — exactly what the sequential schedule would select
            take_rows = np.zeros(B, dtype=bool)
            tgt = np.full(B, h, dtype=int)
            still = searching.copy()
            for i, m in enumerate(idx_s):
                rows_i = np.nonzero(rows_m[:n_rows] == m)[0]
                hits = rows_i[ok_rows[rows_i]]
                if hits.size:
                    w = int(hits[0])                # rows_t ascending by
                    take_rows[w] = True             # construction
                    tgt[w] = m
                    res_alpha[m] = alpha_rows[w]
                    n_trials[m] = rows_t[w] + 1
                    still[m] = False
                else:
                    pos[m] += rows_i.size
                    if pos[m] >= max_trials:
                        # failure-out: keep the LAST tried (worse) iterate
                        # with alpha already shrunk once more
                        # (GD_1D.py:110-113 semantics)
                        w = int(rows_i[-1])
                        take_rows[w] = True
                        tgt[w] = m
                        res_alpha[m] = alpha_rows[w] * s.ls_beta
                        n_trials[m] = max_trials
                        still[m] = False
            # non-writing rows all target the idle slot h: their masked
            # writes rewrite its current value (identical data, duplicate-
            # safe), and h is never a chosen target
            res = self._scatter_v(res, out[:3], jnp.asarray(tgt),
                                  jnp.asarray(take_rows))
            searching = still
            phase["backtracking"] += _time.perf_counter() - t_j

        u1, phi1, c1 = res
        return (u1, phi1, _host_read(c1), res_alpha, n_trials, opt_ok, solves,
                phase)

    def _straggler_buckets(self, B: int):
        """Sub-batch trial shapes (GLOBAL batch sizes) the masked search can
        gather into. Under a 1-axis scenario mesh these are per-DEVICE
        buckets of 8,16,... rows times the device count (numeric
        straggler_batch is per-device there); single-chip they are global
        sub-batch sizes."""
        sb = self.straggler_batch
        if sb is None:
            return []
        if self.mesh is not None:
            if self._gather_local_v is None:
                return []
            D = self._batch_shards()
            if B % D:
                return []
            B_local = B // D
            if sb == "auto":
                out, c = [], 8
                while c < B_local:
                    out.append(c * D)
                    c *= 2
                return out
            return [sb * D] if 0 < sb < B_local else []
        if sb == "auto":
            out, c = [], 8
            while c < B:
                out.append(c)
                c *= 2
            return out
        return [sb] if 0 < sb < B else []

    def trial_memory_analysis(self, scenarios: ScenarioBatch, dtype=None):
        """Compile-time device-memory accounting of the line-search trial
        program, the run's peak-memory program (it holds u, r, the trial
        outputs and, for full-memory problems, trajectory copies).

        XLA's buffer assignment (`compiled.memory_analysis()`). Returns a
        dict of byte counters, or None if the backend provides no
        analysis."""
        dtype = dtype or self.dtype
        B = scenarios.batch
        self.u_min, self.u_max = scenarios.u_min, scenarios.u_max
        if scenarios.phi_Q is None:
            self._set_phi_Q_mode(scenarios.phi_Q_mode)
        as_dev = lambda a: None if a is None else jnp.asarray(a, dtype)
        u = jnp.zeros((B,) + self._control_shape, dtype)
        r = jnp.zeros_like(u)
        alpha = jnp.ones((B,), dtype)
        args = (u, r, alpha, as_dev(scenarios.phi0), as_dev(scenarios.phi_Q),
                as_dev(scenarios.phi_T), as_dev(scenarios.b1),
                as_dev(scenarios.b2), as_dev(scenarios.b3),
                as_dev(scenarios.kappa_spar))
        ma = self._trial_jit.lower(*args).compile().memory_analysis()
        if ma is None:  # pragma: no cover - backend without analysis
            return None
        keys = ("peak_memory_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "temp_size_in_bytes",
                "alias_size_in_bytes", "generated_code_size_in_bytes")
        return {k: int(getattr(ma, k)) for k in keys}

    def prewarm(self, scenarios: ScenarioBatch, dtype=None):
        """Compile every sub-batch trial program run() can gather into.

        The bucketed straggler ladder trades one compile per bucket shape
        for per-round FLOPs proportional to the straggler count. Those
        compiles amortize over a production run's hundreds of iterations,
        but a short measurement (or a latency-sensitive caller) should pay
        them up front: this runs one throwaway trial per bucket size.
        The full-batch programs are compiled by a 1-iteration run().
        """
        dtype = dtype or self.dtype
        B = scenarios.batch
        buckets = self._straggler_buckets(B)
        if not buckets:
            return
        # the prox bounds are baked into the traced trial (same as run())
        self.u_min, self.u_max = scenarios.u_min, scenarios.u_max
        if scenarios.phi_Q is None:
            self._set_phi_Q_mode(scenarios.phi_Q_mode)
        # place inputs EXACTLY as run() will (sharded on the mesh): a mesh
        # prewarm with unsharded arrays would pile the full batch on one
        # device AND compile throwaway cache entries keyed by the wrong
        # shardings
        shard = (self.mesh is not None and B % self._batch_shards() == 0)
        as_dev = lambda a: (None if a is None else
                            (jax.device_put(jnp.asarray(a, dtype),
                                            self._input_sharding(a))
                             if shard else jnp.asarray(a, dtype)))
        phi0 = as_dev(scenarios.phi0)
        phi_Q = as_dev(scenarios.phi_Q)
        phi_T = as_dev(scenarios.phi_T)
        b1, b2 = as_dev(scenarios.b1), as_dev(scenarios.b2)
        b3, ks = as_dev(scenarios.b3), as_dev(scenarios.kappa_spar)
        u = jnp.zeros((B,) + self._control_shape, dtype)
        r = jnp.zeros_like(u)
        if shard:
            u = jax.device_put(u, self._input_sharding(u))
            r = jax.device_put(r, self._input_sharding(r))
        alpha = jnp.ones((B,), dtype)
        # full-batch trial supplies a correctly-shaped `res` for the
        # scatter programs (and is itself compiled here if run() hasn't)
        res = self._trial_v(u, r, alpha, phi0, phi_Q, phi_T,
                            b1, b2, b3, ks)[:3]
        # full-batch masked merge (used whenever the straggler count
        # exceeds the largest bucket); operands are donated on an
        # accelerator, so feed it a copy and keep its return value
        res = self._merge_v(jnp.zeros((B,), bool),
                            jax.tree_util.tree_map(jnp.copy, res), res)
        for bsz in buckets:
            # compile the whole compaction round at this bucket shape:
            # gather -> sub-batch trial -> masked scatter (exactly the
            # programs _search hits)
            if self.mesh is not None:
                D = self._batch_shards()
                idx = jnp.asarray(np.tile(np.arange(bsz // D), D))
                g = self._gather_local_v(idx, u, r, phi0, phi_Q, phi_T,
                                         b1, b2, b3, ks)
                out = self._trial_v(g[0], g[1], jnp.ones((bsz,), dtype),
                                    *g[2:])
                res = self._scatter_local_v(res, out[:3], idx,
                                            jnp.zeros((bsz,), bool))
            else:
                idx = jnp.asarray(np.arange(bsz))
                g = self._gather_v(idx, u, r, phi0, phi_Q, phi_T,
                                   b1, b2, b3, ks)
                out = self._trial_v(g[0], g[1], jnp.ones((bsz,), dtype),
                                    *g[2:])
                res = self._scatter_v(res, out[:3], idx,
                                      jnp.zeros((bsz,), bool))
        jax.block_until_ready(res[2])

    def run(self, scenarios: ScenarioBatch, max_iter: int,
            verbose: bool = True, dtype=None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, resume: bool = False,
            metrics_path: Optional[str] = None,
            host_results: bool = True):
        """Vectorized PGD over the batch. Per-member plateau detection,
        alpha growth, and convergence freezing mirror the single-scenario
        loop; converged members keep iterating as no-ops (their u no longer
        changes materially), matching masked-fixed-point semantics.

        checkpoint_path + checkpoint_every enable mid-run optimizer-state
        checkpointing (u, alpha, plateau/convergence state, cost history);
        resume=True restarts from the checkpoint, recomputing phi from u
        (the trajectory is a pure function of the control). The reference
        has no mid-run checkpointing (SURVEY.md section 5).

        metrics_path: JSONL per-iteration structured metrics (MetricsLogger)
        — the machine-parseable analog of the reference's printed logs.

        Returns a dict with the optimizer state plus measured counters:
        newton_solves (total forward Newton linear solves, from the
        while_loop trip counts) and phase timers (backward / line-search
        split, ref GD_1D.py:563-576 accounting).

        host_results=False leaves u/r/phi as device arrays: at config-4
        scale the eager download is ~1.3 GB, which a caller that only
        inspects cost_history (or fetches u once after hundreds of
        iterations) never needs."""
        import time as _time
        from vch_tpu.utils.metrics import MetricsLogger
        metrics = MetricsLogger(metrics_path) if metrics_path else None
        dtype = dtype or self.dtype
        B = scenarios.batch
        shard = (self.mesh is not None
                 and B % self._batch_shards() == 0)
        if (not shard and self.mesh is not None
                and getattr(self, "_requires_divisible_batch", False)):
            raise ValueError(
                f"batch {B} is not divisible by the mesh's scenario-axis "
                f"size {self._batch_shards()}; the combined (scenarios, gx) "
                f"mesh programs are shard_map-partitioned and have no "
                f"unsharded fallback — pad or trim the sweep")
        # _input_sharding only inspects the rank; pass the HOST array (an
        # eager jnp.asarray here would copy e.g. a 430 MB phi_Q to the
        # device once more per run)
        as_dev = lambda a: (jax.device_put(jnp.asarray(a, dtype),
                                           self._input_sharding(a))
                            if shard else jnp.asarray(a, dtype))
        phi0 = as_dev(scenarios.phi0)
        phi_T = as_dev(scenarios.phi_T)
        if scenarios.phi_Q is None:
            self._set_phi_Q_mode(scenarios.phi_Q_mode)
            phi_Q = None
        else:
            phi_Q = as_dev(scenarios.phi_Q)
        b1, b2 = as_dev(scenarios.b1), as_dev(scenarios.b2)
        b3, ks = as_dev(scenarios.b3), as_dev(scenarios.kappa_spar)
        self.u_min, self.u_max = scenarios.u_min, scenarios.u_max

        timers = {"total_optimization": 0.0, "backward_total": 0.0,
                  "line_search_total": 0.0, "optimistic_eval_total": 0.0,
                  "backtracking_total": 0.0}
        newton_solves = 0
        t_run0 = _time.perf_counter()

        k_start = 0
        if resume and checkpoint_path:
            from vch_tpu.utils.checkpoint import load_checkpoint
            state, meta = load_checkpoint(checkpoint_path)
            u = as_dev(state["u"])
            phi, ns0 = self._forward_v(u, phi0, phi_Q, phi_T)
            newton_solves += int(_host_read(ns0).sum())
            alpha = state["alpha"]
            plateau = state["plateau"].astype(int)
            converged = state["converged"].astype(bool)
            iters_to_converge = state["iters_to_converge"].astype(int)
            cost_hist = list(state["cost_history"])
            k_start = int(meta["iteration"])
            if verbose:
                print(f"[resume] from {checkpoint_path} at iter {k_start}")
        else:
            # baseline forward per scenario (u allocated device-side; a
            # host np.zeros would copy M*Nx*Ny*B zeros to the device)
            u = jnp.zeros((B,) + self._control_shape, dtype)
            if shard:
                u = jax.device_put(u, self._input_sharding(u))
            phi, ns0 = self._forward_v(u, phi0, phi_Q, phi_T)
            newton_solves += int(_host_read(ns0).sum())
            cost = self._cost_v(phi, u, phi_Q, phi_T, b1, b2, b3, ks)
            alpha = np.full((B,), self.alpha_max)
            cost_hist = [_host_read(cost)]
            plateau = np.zeros(B, dtype=int)
            converged = np.zeros(B, dtype=bool)
            iters_to_converge = np.full(B, max_iter, dtype=int)
        s = self.s
        # per-member alpha advisor state (ref GD_1D.py:388-404, vectorized):
        # running sum/count of alphas that succeeded optimistically
        advisor_sum = np.zeros(B)
        advisor_cnt = np.zeros(B, dtype=int)
        ls_trials = np.zeros(B, dtype=int)   # cumulative search trials
        r = None    # set by the first iteration (or below if none runs)

        for k in range(k_start, max_iter):
            t0 = _time.perf_counter()
            r = self._adjoint_v(u, phi, b1, b2, phi_Q, phi_T)
            jax.block_until_ready(r)
            t1 = _time.perf_counter()
            timers["backward_total"] += t1 - t0
            alpha_prev = alpha.copy()
            u_prev = u
            # speculative packing gathers across the batch axis, which would
            # insert per-round collectives under a sharded mesh — hard-gate it
            spec = self.speculative and self.mesh is None
            search = self._search_speculative if spec else self._search
            u, phi, c_np, a_np, n_trials, opt_ok, solves, phase = search(
                u, phi, cost_hist[-1], alpha, r, phi0, phi_Q, phi_T,
                b1, b2, b3, ks, dtype)
            # reference phase taxonomy (GD_1D.py:563-576, matching the
            # single-scenario loop): line_search_total counts BACKTRACKING
            # rounds only; the optimistic eval is its own phase
            timers["line_search_total"] += phase["backtracking"]
            timers["optimistic_eval_total"] += phase["optimistic"]
            timers["backtracking_total"] += phase["backtracking"]
            newton_solves += solves
            ls_trials += np.asarray(n_trials, dtype=int)
            ch_np = _host_read(self._change_v(u, u_prev))

            if k >= s.advisor_start_iter:
                advisor_sum += np.where(opt_ok, alpha_prev, 0.0)
                advisor_cnt += opt_ok.astype(int)

            flat = np.abs(c_np - cost_hist[-1]) < s.plateau_tolerance
            plateau = np.where(flat, plateau + 1, 0)
            boost = plateau >= s.plateau_length
            a_next = np.where(boost, a_np * s.plateau_boost, a_np * 1.2)
            plateau = np.where(boost, 0, plateau)
            alpha = np.minimum(self.alpha_max, a_next)

            newly = (~converged) & (ch_np < s.conv_tol) & (k > s.conv_min_iter)
            iters_to_converge[newly] = k + 1
            converged |= newly
            cost_hist.append(c_np)
            if verbose:
                print(f"iter {k+1:4d} | mean cost {c_np.mean():.6f} | "
                      f"converged {converged.sum()}/{B} | "
                      f"max trials {int(np.asarray(n_trials).max())}")
            if metrics:
                metrics.log("pgd_iter", k=k + 1, mean_cost=float(c_np.mean()),
                            max_cost=float(c_np.max()),
                            converged=int(converged.sum()),
                            max_trials=int(np.asarray(n_trials).max()),
                            newton_solves=newton_solves,
                            mean_alpha=float(np.mean(a_np)))
            if (checkpoint_path and checkpoint_every
                    and (k + 1) % checkpoint_every == 0):
                from vch_tpu.utils.checkpoint import save_checkpoint
                save_checkpoint(
                    checkpoint_path,
                    {"u": _host_read(u), "alpha": alpha, "plateau": plateau,
                     "converged": converged,
                     "iters_to_converge": iters_to_converge,
                     "cost_history": np.stack(cost_hist)},
                    {"iteration": k + 1})
            if converged.all():
                break

        if r is None:
            # the loop never ran (resume at a checkpoint whose iteration ==
            # max_iter, or max_iter == 0): still honor the output contract
            r = self._adjoint_v(u, phi, b1, b2, phi_Q, phi_T)
        jax.block_until_ready(u)     # drain queued merges (no transfer)
        timers["total_optimization"] = _time.perf_counter() - t_run0
        advisor_alpha = np.where(advisor_cnt > 0,
                                 advisor_sum / np.maximum(advisor_cnt, 1),
                                 np.nan)
        if metrics:
            metrics.log("run_done", timers=timers,
                        newton_solves=newton_solves)
        to_host = _host_read if host_results else (lambda a: a)
        return {
            "u": to_host(u), "r": to_host(r),
            "phi": jax.tree_util.tree_map(to_host, phi),
            "cost_history": np.stack(cost_hist), "alpha": np.asarray(alpha),
            "converged": converged, "iterations": iters_to_converge,
            "newton_solves": newton_solves, "timers": timers,
            "advisor_alpha": advisor_alpha, "ls_trials": ls_trials,
        }


class BatchedProblem1D(_BatchedPGDBase):
    """Batched 1D PGD (reference layout, duplicated t=0 row)."""

    def __init__(self, fwd_config: Optional[ForwardSolverConfig1D] = None,
                 settings: Optional[PGDSettings] = None,
                 alpha_max: float = 100.0, mesh=None, use_mesh: bool = False,
                 straggler_batch=None, speculative=None, chunk_size=None):
        self.fwd_config = fwd_config or ForwardSolverConfig1D()
        self.solver = ForwardSolver1D(self.fwd_config)
        self.adj = AdjointSolver1D(self.fwd_config)
        self.dtype = self.solver.dtype
        M, n = self.solver.M, self.fwd_config.N + 1
        self._control_shape = (M + 2, n)          # ref layout
        self._control_is_state_shaped = True
        self._dts_ref = jnp.asarray(
            np.diff(np.concatenate([[0.0], self.solver.t_hist])), self.dtype)
        self._x = jnp.asarray(self.solver.x, self.dtype)
        self._t_ref = jnp.asarray(
            np.concatenate([[0.0], self.solver.t_hist]), self.dtype)
        super().__init__(settings or PGDSettings.defaults_1d(), alpha_max,
                         mesh, use_mesh, straggler_batch=straggler_batch,
                         speculative=speculative, chunk_size=chunk_size)

    def _forward(self, u_ref, phi0):
        phi, _ = self._forward_stats(u_ref, phi0, None, None)
        return phi

    def _forward_stats(self, u_ref, phi0, phi_Q=None, phi_T=None):
        M = self.solver.M
        phi, st = self.solver._march_impl(u_ref[: M + 1], phi0)
        return jnp.concatenate([phi[:1], phi], axis=0), st.newton_solves

    def _adjoint(self, phi_ref, u, b1, b2, phi_Q, phi_T):
        _, _, r = self.adj._run_impl(phi_ref, self._dts_ref, b1, b2,
                                     phi_Q, phi_T)
        return r

    def _cost(self, phi_ref, u_ref, phi_Q, phi_T, b1, b2, b3, ks):
        return calculate_cost_1d(phi_ref, u_ref, phi_Q, phi_T, self._x,
                                 self._t_ref, b1, b2, b3, ks)

    def _to_ref_layout(self, scenarios: ScenarioBatch) -> ScenarioBatch:
        # convert core-layout phi_Q (M+1 rows, as sweep_1d builds) to the
        # reference layout (duplicated t=0 row) this problem operates in —
        # on a COPY of the caller's batch (mutating the input made a second
        # run() double-convert). jnp.concatenate keeps a device-staged
        # phi_Q on device (np.concatenate would force a full download and
        # re-upload inside the timed run when the caller pre-staged the
        # batch).
        pq = scenarios.phi_Q
        if pq is not None and pq.shape[1] == self.solver.M + 1:
            import dataclasses
            scenarios = dataclasses.replace(
                scenarios,
                phi_Q=jnp.concatenate([pq[:, :1], pq], axis=1))
        return scenarios

    def prewarm(self, scenarios: ScenarioBatch, dtype=None):
        return super().prewarm(self._to_ref_layout(scenarios), dtype)

    def trial_memory_analysis(self, scenarios: ScenarioBatch, dtype=None):
        return super().trial_memory_analysis(self._to_ref_layout(scenarios),
                                             dtype)

    def run(self, scenarios: ScenarioBatch, max_iter: int,
            verbose: bool = True, dtype=None, **kwargs):
        return super().run(self._to_ref_layout(scenarios), max_iter,
                           verbose=verbose, dtype=dtype, **kwargs)


class BatchedProblem2D(_BatchedPGDBase):
    """Batched 2D PGD (no layout quirk)."""

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 settings: Optional[PGDSettings] = None,
                 alpha_max: float = 50.0, mesh=None, use_mesh: bool = False,
                 straggler_batch=None, speculative=None, chunk_size=None):
        self.fwd_config = fwd_config or ForwardSolverConfig2D()
        self.solver = ForwardSolver2D(self.fwd_config)
        self.adj = AdjointSolver2D(self.fwd_config)
        self.dtype = self.solver.dtype
        M = self.solver.M
        self._control_shape = (M + 1, self.fwd_config.Nx + 1,
                               self.fwd_config.Ny + 1)
        self._control_is_state_shaped = True
        self._dts = jnp.asarray(self.solver.dts, self.dtype)
        self._x = jnp.asarray(self.solver.x, self.dtype)
        self._y = jnp.asarray(self.solver.y, self.dtype)
        self._t = jnp.asarray(self.solver.t_hist, self.dtype)
        super().__init__(settings or PGDSettings.defaults_2d(), alpha_max,
                         mesh, use_mesh, straggler_batch=straggler_batch,
                         speculative=speculative, chunk_size=chunk_size)

    def _forward(self, u, phi0):
        return self.solver._simulate_impl(u, phi0)

    def _forward_stats(self, u, phi0, phi_Q=None, phi_T=None):
        phi, st = self.solver._march_impl(u, phi0)
        return phi, st.newton_solves

    def _adjoint(self, phi_hist, u, b1, b2, phi_Q, phi_T):
        _, _, r = self.adj._run_impl(phi_hist, self._dts, b1, b2, phi_Q, phi_T)
        return r

    def _cost(self, phi_hist, u, phi_Q, phi_T, b1, b2, b3, ks):
        return calculate_cost_2d(phi_hist, u, phi_Q, phi_T, self._x, self._y,
                                 self._t, b1, b2, b3, ks)


# Peak device memory of a full-memory batched 2D run in units of S, one
# trajectory-shaped array (see make_batched_problem_2d), measured on an
# H100 (700 W): float32 64x64 B=512 through a warm-up and a 3-iteration
# run peaked at 10,738,439,168 B = 12.29 S; XLA's buffer assignment of the
# trial program alone is 7.29 S (args 3.02, outputs 2.00, temps 2.27) at
# both 64x64 B=512 and 128x128 B=128; a single 128x128 B=128 iteration
# peaked at 8.29 S. The rest is the run's own state (u, phi, r, the
# search's selection and the trial outputs it merges).
_PEAK_PER_S = 12.3


def make_batched_problem_2d(fwd_config: Optional[ForwardSolverConfig2D] = None,
                            batch: int = 1,
                            materialized_phi_Q: bool = True,
                            hbm_limit_bytes: Optional[int] = None,
                            safety: float = 0.75, K: int = 10, **kwargs):
    """Pick the full-memory or segment-checkpointed batched 2D problem by
    estimated peak device memory (SURVEY.md section 7 'Memory at scale').

    With S = one trajectory-shaped array = batch*(M+1)*(Nx+1)*(Ny+1)*bytes,
    the full-memory run is estimated at _PEAK_PER_S * S (one S less
    without a materialized phi_Q).
    Above safety * hbm_limit_bytes this returns LowMemBatchedProblem2D
    (O(M/K) checkpoints + segment recompute), else BatchedProblem2D.
    hbm_limit_bytes defaults to the device's own `bytes_limit`; a device
    that reports none (the CPU) needs it passed.
    """
    cfg = fwd_config or ForwardSolverConfig2D()
    # combined-mesh arm: a mesh that carries a grid axis means the caller
    # wants each member's field rows sharded too (grids where one member's
    # working set outgrows a chip — BASELINE config-5 growth path); route
    # to the (scenarios, gx) batched problem (parallel/spatial.py)
    mesh = kwargs.get("mesh")
    mesh_axes = tuple(getattr(mesh, "axis_names", ())) if mesh else ()
    extra_axes = [a for a in mesh_axes if a != BATCH_AXIS]
    if len(extra_axes) > 1:
        raise ValueError(
            f"mesh has axes {mesh_axes}; at most one non-'{BATCH_AXIS}' "
            f"(grid) axis is supported")
    if extra_axes:
        # combined-mesh arm: ANY non-scenario mesh axis is the grid axis
        # (routing on the literal name 'gx' would silently replicate
        # differently-named grid axes on the vmapped path)
        from vch_tpu.parallel.spatial import GridShardedBatchedProblem2D
        ga = kwargs.get("grid_axis")
        if ga is not None and ga != extra_axes[0]:
            raise ValueError(
                f"grid_axis={ga!r} not found in mesh axes {mesh_axes}")
        kwargs.setdefault("grid_axis", extra_axes[0])
        supported = {"settings", "alpha_max", "mesh", "grid_axis"}
        extra = set(kwargs) - supported
        if extra:
            raise ValueError(
                f"the combined (scenarios, grid) mesh arm does not support "
                f"{sorted(extra)}; supported kwargs: {sorted(supported)}")
        return GridShardedBatchedProblem2D(cfg, **kwargs)
    from vch_tpu.models.timegrid import build_dt_schedule
    M = len(build_dt_schedule(cfg.T, cfg.dt_initial))
    bytes_per = 8 if cfg.dtype == "float64" else 4
    field = (cfg.Nx + 1) * (cfg.Ny + 1) * bytes_per
    S = batch * (M + 1) * field
    est = S * (_PEAK_PER_S if materialized_phi_Q else _PEAK_PER_S - 1)
    if hbm_limit_bytes is None:
        stats = jax.local_devices()[0].memory_stats() or {}
        hbm_limit_bytes = stats.get("bytes_limit")
        if not hbm_limit_bytes:
            raise ValueError(
                f"{jax.local_devices()[0].platform} device reports no memory "
                f"limit; pass hbm_limit_bytes")
    # member-footprint rule: when even ONE member's LOWMEM working set
    # (ceil(M/K)+1 checkpoints + a 2K-frame recompute segment, ~3 live
    # copies through the search) exceeds the device, scenario sharding
    # cannot help: each member's field rows must span devices. Re-mesh the
    # caller's 1-axis scenario mesh into (scenarios, gx) with the smallest
    # gx that fits and route to the combined-mesh problem, which runs
    # full-memory histories (no lowmem arm): a does-not-fit-otherwise
    # escape hatch.
    member_lowmem = (-(-M // K) + 1 + 2 * K) * field * 3
    if mesh is not None and member_lowmem > safety * hbm_limit_bytes:
        from jax.sharding import Mesh
        from vch_tpu.parallel.spatial import GridShardedBatchedProblem2D
        devs = mesh.devices.reshape(-1)
        rows = cfg.Nx + 1
        gx = 2
        while (gx < devs.size
               and (member_lowmem / gx > safety * hbm_limit_bytes
                    or rows % gx)):
            gx *= 2
        if (devs.size % gx or rows % gx
                or member_lowmem / gx > safety * hbm_limit_bytes):
            raise ValueError(
                f"one member's lowmem working set (~{member_lowmem/2**30:.1f}"
                f" GiB) does not fit a chip and the {devs.size}-device mesh "
                f"cannot be factored into (scenarios, gx) with gx={gx} "
                f"(gx must divide both the device count and Nx+1={rows})")
        combined = Mesh(devs.reshape(devs.size // gx, gx),
                        (BATCH_AXIS, "gx"))
        kw = {k: v for k, v in kwargs.items()
              if k in ("settings", "alpha_max")}
        return GridShardedBatchedProblem2D(cfg, mesh=combined, **kw)
    if est > safety * hbm_limit_bytes:
        return LowMemBatchedProblem2D(cfg, K=K, **kwargs)
    return BatchedProblem2D(cfg, **kwargs)


class LowMemBatchedProblem2D(_BatchedPGDBase):
    """Batched 2D PGD whose forward/adjoint never materialize a trajectory.

    The "phi" slot of the generic runner carries a models/lowmem.LowMemState
    (O(M/K) segment checkpoints + terminal state + the J1 accumulator)
    instead of the (M+1, Nx+1, Ny+1) history — the line-search trials compute
    cost straight from the accumulator, and the adjoint recomputes each
    K-step segment from its checkpoint (sqrt-schedule rematerialization).
    This is what makes BASELINE.md config 5 (256x256) PGD iterations fit on
    one chip at useful batch sizes (SURVEY.md section 7 'Memory at scale').
    """

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 K: int = 10, settings: Optional[PGDSettings] = None,
                 alpha_max: float = 50.0, mesh=None, use_mesh: bool = False,
                 straggler_batch=None, speculative=None, chunk_size=None):
        from vch_tpu.models.lowmem import LowMemPipeline2D
        self.fwd_config = fwd_config or ForwardSolverConfig2D()
        self.pipe = LowMemPipeline2D(self.fwd_config, K=K)
        self.solver = self.pipe.solver
        self.dtype = self.solver.dtype
        M = self.solver.M
        self._control_shape = (M + 1, self.fwd_config.Nx + 1,
                               self.fwd_config.Ny + 1)
        super().__init__(settings or PGDSettings.defaults_2d(), alpha_max,
                         mesh, use_mesh, straggler_batch=straggler_batch,
                         speculative=speculative, chunk_size=chunk_size)

    def _set_phi_Q_mode(self, mode: Optional[str]):
        if mode not in ("ramp", "zeros"):
            raise ValueError(f"phi_Q=None requires phi_Q_mode in "
                             f"('ramp', 'zeros'); got {mode!r}")
        prev = getattr(self, "_phi_Q_mode", None)
        if prev is not None and prev != mode:
            # the mode is baked into the traced programs at compile time and
            # a None phi_Q has the same pytree structure for both modes, so
            # switching would silently reuse the stale compilation
            raise ValueError(
                f"phi_Q_mode already traced as {prev!r}; build a new "
                f"LowMemBatchedProblem2D for mode {mode!r}")
        self._phi_Q_mode = mode
        self.pipe.core.phi_Q_mode = mode

    def _forward_stats(self, u, phi0, phi_Q, phi_T=None):
        st = self.pipe.core.forward_ckpt(u, phi0, phi_Q, phi_T_ref=phi_T)
        return st, st.newton_solves

    def _forward(self, u, phi0):
        # full-trajectory API for parity/tests only (not used by run())
        return self.solver._simulate_impl(u, phi0)

    def _adjoint(self, state, u, b1, b2, phi_Q, phi_T):
        return self.pipe.core.adjoint_r(state, u, phi_Q, b1, b2, phi_T)

    def _cost(self, state, u, phi_Q, phi_T, b1, b2, b3, ks):
        return self.pipe.core.cost(state, u, phi_T, b1, b2, b3, ks)
