"""Smoke test of the engine's main path on the GPU.

Drives the public entry points at real sizes and checks every result by the
repository's own means: the float64 path against the golden reference runs,
the float32 batched sweep against the float64 path, the low-memory path
against the full-memory path, and the multi-card meshes against one card.

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --four-cards  # the four-card mesh phase only

Each phase prints one line with its compile seconds (JAX tracing, lowering
and XLA compilation, from jax.monitoring), the rest of its wall time, and
its measured results. A failing phase raises. Without a GPU the script exits
non-zero and prints no result. The last line of standard output is one JSON
object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CompileClock:
    """Sums JAX's compile-phase durations as they are reported."""

    def __init__(self):
        import jax
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.secs += duration


def require(ok, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def run_phase(clock: CompileClock, name: str, fn):
    c0, t0 = clock.secs, time.perf_counter()
    result = fn()
    wall = time.perf_counter() - t0
    comp = clock.secs - c0
    fields = " ".join(f"{k}={v}" for k, v in result.items())
    print(f"[{name}] compile_s={comp:.1f} run_s={wall - comp:.1f} "
          f"{fields}", flush=True)
    return result


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _rel_l2(a, b):
    """Largest per-member relative L2 distance of (B, ...) arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ax = tuple(range(1, a.ndim))
    return float(np.max(np.sqrt(np.sum((a - b) ** 2, axis=ax))
                        / np.sqrt(np.sum(b ** 2, axis=ax))))


def _peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def phase_device(jax):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in smi.strip().splitlines():
        print(line.strip(), flush=True)
    print(f"[device] kind={dev.device_kind} count={len(jax.devices())} "
          f"bytes_limit={(dev.memory_stats() or {}).get('bytes_limit')}",
          flush=True)
    return dev


def phase_golden():
    """Float64 on the card against the golden reference runs."""
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.control.problems import ControlProblem1D, ControlProblem2D
    gold = os.path.join(REPO, "tests", "golden")
    res1 = ControlProblem1D().optimize(max_iter=8, verbose=False)
    rel1 = _rel(res1.cost_history,
                np.load(os.path.join(gold, "ref_1d.npz"))["cost_traj"])
    res2 = ControlProblem2D(
        ForwardSolverConfig2D(Nx=32, Ny=32, T=0.25)).optimize(
            max_iter=3, verbose=False)
    rel2 = _rel(res2.cost_history,
                np.load(os.path.join(gold, "ref_2d_n32.npz"))["cost_traj"])
    require(rel1 <= 1e-8, f"1D golden cost trajectory rel {rel1:.3e}")
    require(rel2 <= 1e-8, f"2D golden cost trajectory rel {rel2:.3e}")
    return {"rel_1d": f"{rel1:.3e}", "rel_2d": f"{rel2:.3e}"}


def phase_headline(dev, N=64, B=512, iters=3):
    """bench.py's default cell, float32, through the memory chooser."""
    from bench import headline_config, headline_sweep, stage
    from vch_tpu.parallel.batch import make_batched_problem_2d
    cfg = headline_config(N, "float32")
    prob = make_batched_problem_2d(cfg, batch=B)
    sc = stage(headline_sweep(cfg, B), "float32")
    prob.run(sc, max_iter=1, verbose=False)            # warm-up
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False, host_results=False)
    el = time.perf_counter() - t0
    ch = out["cost_history"]
    require(np.all(np.isfinite(ch)), "finite costs")
    require(ch[-1].mean() < ch[0].mean(), "mean cost decreases")
    require(out["newton_solves"] > 0, "newton_solves > 0")
    return {"problem": type(prob).__name__, "window_s": f"{el:.3f}",
            "scenario_iters_per_s": f"{B * iters / el:.2f}",
            "newton_solves_per_s": f"{out['newton_solves'] / el:.0f}",
            "mean_cost": f"{ch[0].mean():.6f}->{ch[-1].mean():.6f}",
            "descend_frac": f"{float((ch[-1] < ch[0]).mean()):.3f}",
            "timers": json.dumps({k: round(v, 3)
                                  for k, v in out["timers"].items()}),
            "peak_bytes_in_use": _peak_bytes(dev)}


def phase_f32_vs_f64(N=64, B=8):
    """Float32 forward trajectory, adjoint gradient r and one-iteration
    cost against the same solvers in float64, under one smooth control."""
    import jax.numpy as jnp
    from bench import headline_config, headline_sweep, stage
    from vch_tpu.parallel.batch import BatchedProblem2D
    outs = {}
    for dtype in ("float32", "float64"):
        cfg = headline_config(N, dtype)
        prob = BatchedProblem2D(cfg)
        sc = stage(headline_sweep(cfg, B), dtype)
        s = prob.solver
        t = s.t_hist / s.t_hist[-1]
        u1 = (0.2 * np.sin(np.pi * t)[:, None, None]
              * np.cos(np.pi * s.x)[None, :, None]
              * np.cos(np.pi * s.y)[None, None, :])
        u = jnp.asarray(np.broadcast_to(u1, (B,) + u1.shape), dtype)
        phi, _ = prob._forward_v(u, sc.phi0, sc.phi_Q, sc.phi_T)
        r = prob._adjoint_v(u, phi, sc.b1, sc.b2, sc.phi_Q, sc.phi_T)
        cost = prob.run(sc, max_iter=1, verbose=False)["cost_history"][-1]
        outs[dtype] = (np.asarray(phi), np.asarray(r), cost)
    (p32, r32, c32), (p64, r64, c64) = outs["float32"], outs["float64"]
    d_phi, d_r, d_c = _rel_l2(p32, p64), _rel_l2(r32, r64), _rel(c32, c64)
    print(f"[f32_vs_f64] measured traj_rel_l2={d_phi:.3e} "
          f"grad_rel_l2={d_r:.3e} cost_rel={d_c:.3e}", flush=True)
    require(np.isfinite([d_phi, d_r, d_c]).all(), "finite comparisons")
    require(d_phi <= 1e-3, f"f32 trajectory rel L2 {d_phi:.3e}")
    require(d_r <= 1e-3, f"f32 gradient rel L2 {d_r:.3e}")
    require(d_c <= 1e-4, f"f32 one-iteration cost rel {d_c:.3e}")
    return {"traj_rel_l2": f"{d_phi:.3e}", "grad_rel_l2": f"{d_r:.3e}",
            "cost_rel": f"{d_c:.3e}"}


def phase_1d(B=256, iters=2, N=512, T=1.0):
    """BASELINE config 2: 1D, N=512, 500 steps, B=256, float32."""
    from bench import stage
    from vch_tpu.config import ForwardSolverConfig1D, OptimizationConfig
    from vch_tpu.parallel.batch import BatchedProblem1D, sweep_1d
    cfg = ForwardSolverConfig1D(N=N, T=T, dt_initial=2e-3,
                                dtype="float32", newton_tol=2e-4)
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=np.linspace(5e-4, 5e-3, B // 8),
                  kappa_values=np.linspace(1e-5, 2e-4, 8))
    require(sc.batch == B, f"1D sweep of {B} members")
    prob = BatchedProblem1D(cfg)
    out = prob.run(stage(sc, "float32"), max_iter=iters, verbose=False,
                   host_results=False)
    ch = out["cost_history"]
    require(np.all(np.isfinite(ch)), "finite costs")
    require(ch[-1].mean() < ch[0].mean(), "mean cost decreases")
    return {"mean_cost": f"{ch[0].mean():.6f}->{ch[-1].mean():.6f}",
            "newton_solves": out["newton_solves"]}


def phase_lowmem(N=128, B=16, K=10, T=0.25):
    """LowMemBatchedProblem2D against BatchedProblem2D: the same steps with
    other checkpointing. T=0.25 gives 25 steps, so two K=10 segments and a
    5-step tail. A one-ulp float32 difference between the two compiled
    programs grows about 30-fold over the 100 steps of T=1, which puts the
    one-iteration cost gap at the 1e-5 limit; over 25 steps it stays near
    1e-6."""
    from bench import headline_config, headline_sweep, stage
    from vch_tpu.parallel.batch import BatchedProblem2D, LowMemBatchedProblem2D
    cfg = headline_config(N, "float32", T=T)
    sc = stage(headline_sweep(cfg, B), "float32")
    full = BatchedProblem2D(cfg).run(sc, max_iter=1, verbose=False)
    low = LowMemBatchedProblem2D(cfg, K=K).run(sc, max_iter=1, verbose=False)
    rel = _rel(low["cost_history"], full["cost_history"])
    require(rel <= 1e-5, f"lowmem per-member cost rel {rel:.3e}")
    require(low["newton_solves"] == full["newton_solves"],
            f"Newton solves {low['newton_solves']} vs "
            f"{full['newton_solves']}")
    return {"cost_rel": f"{rel:.3e}", "newton_solves": full["newton_solves"]}


def _devices_holding(arr):
    return sorted({s.device.id for s in arr.addressable_shards})


def phase_four_cards(devs, N=64, B=512, grid_n=127, comb_n=63,
                     comb_b=8):
    """Scenario mesh, grid mesh and combined mesh over four cards, each
    against the same problem on one card in this process.

    The one-card scenario run executes in chunks of the per-card shard
    size, so both sides run each member through the same compiled
    per-member program: float32 roundoff from differently shaped programs
    would otherwise flip line-search decisions within three iterations.
    The grid and combined meshes change the order of the grid reductions
    (psum'd dots), so they are compared in float64."""
    from jax.sharding import Mesh
    from bench import headline_config, headline_sweep, stage
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.control.problems import ControlProblem2D
    from vch_tpu.parallel.batch import BatchedProblem2D
    from vch_tpu.parallel.mesh import BATCH_AXIS, make_mesh
    from vch_tpu.parallel.spatial import (GridShardedBatchedProblem2D,
                                          GridShardedProblem2D)
    out = {}

    # scenario mesh: 64x64, B=512, 128 members a card, 3 iterations
    cfg = headline_config(N, "float32")
    sc = stage(headline_sweep(cfg, B), "float32")
    one = BatchedProblem2D(cfg, chunk_size=B // len(devs)).run(
        sc, max_iter=3, verbose=False, host_results=False)
    mesh_prob = BatchedProblem2D(cfg, mesh=make_mesh(devices=devs))
    four = mesh_prob.run(sc, max_iter=3, verbose=False, host_results=False)
    per_iter = np.max(np.abs(four["cost_history"] - one["cost_history"])
                      / np.abs(one["cost_history"]), axis=1)
    print(f"[four_cards] scenario mesh cost rel per iteration "
          f"{per_iter.tolist()} Newton solves {four['newton_solves']} vs "
          f"{one['newton_solves']}", flush=True)
    held = _devices_holding(four["u"])
    require(held == sorted(d.id for d in devs),
            f"scenario-mesh result spread over devices {held}")
    require(all(s.data.shape[0] == B // len(devs)
                for s in four["u"].addressable_shards),
            f"{B // len(devs)} members a card")
    rel = _rel(four["cost_history"], one["cost_history"])
    require(rel <= 1e-5, f"scenario mesh per-member cost rel {rel:.3e}")
    require(four["newton_solves"] == one["newton_solves"],
            f"scenario mesh Newton solves {four['newton_solves']} vs "
            f"{one['newton_solves']}")
    out["scenario_mesh_cost_rel"] = f"{rel:.3e}"
    out["scenario_mesh_newton_solves"] = four["newton_solves"]

    # grid mesh: one float64 scenario, 128 rows over 4 cards
    gcfg = ForwardSolverConfig2D(Nx=grid_n, Ny=grid_n, T=0.25)
    ref = ControlProblem2D(gcfg).optimize(max_iter=1, verbose=False)
    gprob = GridShardedProblem2D(gcfg, mesh=Mesh(np.asarray(devs), ("gx",)))
    res = gprob.optimize(max_iter=1, verbose=False)
    rel = _rel(res.cost_history, ref.cost_history)
    require(rel <= 1e-10, f"grid mesh cost rel {rel:.3e}")
    out["grid_mesh_cost_rel"] = f"{rel:.3e}"

    # combined (scenarios, gx) = (2, 2) mesh, float64, one iteration
    ccfg = headline_config(comb_n, "float64")       # 64 rows: gx divides
    csc = stage(headline_sweep(ccfg, comb_b), "float64")
    cmesh = Mesh(np.asarray(devs).reshape(2, 2), (BATCH_AXIS, "gx"))
    c_one = BatchedProblem2D(ccfg).run(csc, max_iter=1, verbose=False)
    c_four = GridShardedBatchedProblem2D(ccfg, mesh=cmesh).run(
        csc, max_iter=1, verbose=False, host_results=False)
    held = _devices_holding(c_four["u"])
    require(held == sorted(d.id for d in devs),
            f"combined-mesh result spread over devices {held}")
    rel = _rel(c_four["cost_history"], c_one["cost_history"])
    require(rel <= 1e-5, f"combined mesh cost rel {rel:.3e}")
    out["combined_mesh_cost_rel"] = f"{rel:.3e}"
    out["peak_bytes_in_use"] = json.dumps([_peak_bytes(d) for d in devs])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    from vch_tpu.runtime import setup_compile_cache
    setup_compile_cache()
    clock = CompileClock()
    dev = phase_device(jax)
    if args.four_cards:
        devs = jax.devices()[:4]
        require(len(devs) == 4 and all(d.platform == "gpu" for d in devs),
                f"four GPUs (found {len(jax.devices())})")
        run_phase(clock, "four_cards", lambda: phase_four_cards(devs))
    else:
        run_phase(clock, "golden_f64", phase_golden)
        run_phase(clock, "headline_f32", lambda: phase_headline(dev))
        run_phase(clock, "f32_vs_f64", phase_f32_vs_f64)
        run_phase(clock, "sweep_1d_f32", phase_1d)
        run_phase(clock, "lowmem_vs_full", phase_lowmem)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
