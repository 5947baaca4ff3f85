"""Run the BASELINE.md benchmark configs and write results JSON.

Configs (BASELINE.md):
  1. 1D vCH, N=128, 100 steps, single-scenario PGD (CPU-parity config).
  2. 1D vCH, N=512, 500 steps, batched scenarios over a (b3, kappa) sweep.
  3. 2D vCH, 64x64 terminal-target steering, single scenario.
  4. 2D vCH, 128x128 batched scenarios (1 host).

Usage: python scripts/run_benchmarks.py [config_numbers...] [--iters=K]
           [--out=PATH]
Prints each config's results as JSON; with --out=PATH also merges them into
the JSON file at PATH.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bench import stage  # noqa: E402


def _dtype():
    from vch_tpu.runtime import default_dtype
    return default_dtype()


def bench_config_1(iters: int):
    from vch_tpu.config import ForwardSolverConfig1D, OptimizationConfig
    from vch_tpu.control.problems import ControlProblem1D
    dt = _dtype()
    if dt == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)
    prob = ControlProblem1D(ForwardSolverConfig1D(dtype=dt),
                            OptimizationConfig())
    prob.optimize(max_iter=1, verbose=False)          # compile
    t0 = time.perf_counter()
    res = prob.optimize(max_iter=iters, verbose=False)
    el = time.perf_counter() - t0
    return {"pgd_iters_per_s": iters / el, "final_cost": res.cost_history[-1],
            "iters": iters, "elapsed_s": el, "dtype": dt}


def bench_config_2(iters: int, batch: int = 64):
    from vch_tpu.config import ForwardSolverConfig1D, OptimizationConfig
    from vch_tpu.parallel.batch import BatchedProblem1D, sweep_1d
    dt = _dtype()
    cfg = ForwardSolverConfig1D(N=512, T=1.0, dt_initial=2e-3, dtype=dt,
                                newton_tol=2e-4 if dt == "float32" else 1e-6)
    prob = BatchedProblem1D(cfg)
    b3s = np.linspace(5e-4, 5e-3, max(1, batch // 8))
    kss = np.linspace(1e-5, 2e-4, 8)
    sc = sweep_1d(cfg, OptimizationConfig(), b3_values=b3s, kappa_values=kss)
    import dataclasses
    reps = -(-batch // sc.batch)
    tile = lambda a: np.concatenate([a] * reps, axis=0)[:batch]
    sc = dataclasses.replace(sc, phi0=tile(sc.phi0), phi_T=tile(sc.phi_T),
                             phi_Q=tile(sc.phi_Q), b1=tile(sc.b1),
                             b2=tile(sc.b2), b3=tile(sc.b3),
                             kappa_spar=tile(sc.kappa_spar))
    sc = stage(sc, dt)
    prob.run(sc, max_iter=1, verbose=False)           # compile
    prob.prewarm(sc)            # straggler-bucket trial shapes
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False,
                   host_results=False)
    el = time.perf_counter() - t0
    return {"scenario_iters_per_s": batch * iters / el, "batch": batch,
            "iters": iters, "elapsed_s": el, "dtype": dt,
            "newton_solves": int(out["newton_solves"]),
            "timers": {k: round(v, 3) for k, v in out["timers"].items()},
            "mean_final_cost": float(out["cost_history"][-1].mean())}


def bench_config_3(iters: int):
    from vch_tpu.config import ForwardSolverConfig2D, OptimizationConfig
    from vch_tpu.control.problems import ControlProblem2D
    dt = _dtype()
    prob = ControlProblem2D(
        ForwardSolverConfig2D(Nx=64, Ny=64, dtype=dt,
                              newton_tol=2e-4 if dt == "float32" else 1e-6),
        OptimizationConfig.defaults_2d())
    prob.optimize(max_iter=1, verbose=False)
    t0 = time.perf_counter()
    res = prob.optimize(max_iter=iters, verbose=False)
    el = time.perf_counter() - t0
    vs = None
    bm = os.path.join(REPO, "BASELINE_MEASURED.json")
    if os.path.exists(bm):
        ref_iter_s = json.load(open(bm)).get("2d_n64", {}).get(
            "pgd_iter_s_mean")
        if ref_iter_s:
            vs = round(iters / el * ref_iter_s, 2)
    return {"pgd_iters_per_s": iters / el, "final_cost": res.cost_history[-1],
            "iters": iters, "elapsed_s": el, "dtype": dt,
            "vs_ref_cpu_iter_s": vs,
            "note": "vs_ref_cpu_iter_s = pgd_iters_per_s * BASELINE_MEASURED "
                    "2d_n64 pgd_iter_s_mean (measured reference CPU)"}


def _tile_batch(sc, batch):
    import dataclasses
    reps = -(-batch // sc.batch)
    tile = lambda a: (None if a is None
                      else np.concatenate([a] * reps, axis=0)[:batch])
    return dataclasses.replace(
        sc, phi0=tile(sc.phi0), phi_T=tile(sc.phi_T), phi_Q=tile(sc.phi_Q),
        b1=tile(sc.b1), b2=tile(sc.b2), b3=tile(sc.b3),
        kappa_spar=tile(sc.kappa_spar))


def bench_config_4(iters: int, batch: int = 64, lowmem: bool = False,
                   trips: int = None, K: int = 10):
    """BASELINE config 4: 2D 128x128 batched scenarios, one device.

    Measured (not estimated) Newton-solve counts come back in
    out['newton_solves'] (demonstrating real batch scale, B >= 64). lowmem=True swaps in the segment-checkpointed
    adjoint so the trajectory history never materializes — the full-memory
    path holds three history copies through the line search; lowmem
    trades ~1 recompute for O(M/K) storage and so fits larger batches."""
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import (BatchedProblem2D,
                                        LowMemBatchedProblem2D, sweep_2d)
    dt = _dtype()
    cfg = ForwardSolverConfig2D(
        Nx=128, Ny=128, T=1.0, dtype=dt,
        newton_tol=2e-4 if dt == "float32" else 1e-6,
        **({"krylov_fixed_iters": trips,
            "adjoint_krylov_fixed_iters": 10} if trips else {}))
    prob = (LowMemBatchedProblem2D(cfg, K=K) if lowmem
            else BatchedProblem2D(cfg))
    sc = sweep_2d(cfg, b3_values=np.linspace(5e-5, 2e-4, max(1, batch // 8)),
                  kappa_values=np.linspace(5e-5, 2e-4, 8),
                  materialize_phi_Q=not lowmem)
    sc = _tile_batch(sc, batch)
    sc = stage(sc, dt)
    prob.run(sc, max_iter=1, verbose=False)           # compile
    prob.prewarm(sc)            # straggler-bucket trial shapes
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False,
                   host_results=False)
    el = time.perf_counter() - t0
    import jax
    mem = jax.local_devices()[0].memory_stats() or {}
    # XLA buffer-assignment accounting of the peak-memory program
    prog_mem = prob.trial_memory_analysis(sc)
    return {"scenario_iters_per_s": round(batch * iters / el, 4),
            "batch": batch, "grid": "128x128", "iters": iters,
            "lowmem": lowmem, "lowmem_K": K if lowmem else None, "krylov_trips": trips or cfg.krylov_fixed_iters,
            "elapsed_s": round(el, 2), "dtype": dt,
            "newton_solves": int(out["newton_solves"]),
            "newton_solves_per_s": round(out["newton_solves"] / el, 1),
            "timers": {k: round(v, 2) for k, v in out["timers"].items()},
            "mean_final_cost": float(out["cost_history"][-1].mean()),
            "descend_frac": float((out["cost_history"][-1]
                                   < out["cost_history"][0] + 1e-9).mean()),
            "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
            "trial_program_memory": prog_mem}


def bench_config_5(iters: int, batch: int = 8, K: int = 10):
    """BASELINE config 5 grid (256x256) on ONE device via the lowmem
    (segment-checkpointed) batched PGD; the 4096-scenario run needs
    several cards, but the per-device engine is demonstrated here."""
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import LowMemBatchedProblem2D, sweep_2d
    dt = _dtype()
    cfg = ForwardSolverConfig2D(
        Nx=256, Ny=256, T=1.0, dtype=dt,
        newton_tol=2e-4 if dt == "float32" else 1e-6)
    prob = LowMemBatchedProblem2D(cfg, K=K)
    sc = sweep_2d(cfg, b3_values=np.linspace(5e-5, 2e-4, max(1, batch // 2)),
                  kappa_values=[5e-5, 1e-4], materialize_phi_Q=False)
    sc = _tile_batch(sc, batch)
    sc = stage(sc, dt)
    prob.run(sc, max_iter=1, verbose=False)           # compile
    prob.prewarm(sc)            # straggler-bucket trial shapes
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False,
                   host_results=False)
    el = time.perf_counter() - t0
    import jax
    mem = jax.local_devices()[0].memory_stats() or {}
    prog_mem = prob.trial_memory_analysis(sc)
    return {"scenario_iters_per_s": round(batch * iters / el, 4),
            "batch": batch, "grid": "256x256", "lowmem_K": K,
            "iters": iters, "elapsed_s": round(el, 2), "dtype": dt,
            "timers": {k: round(v, 2) for k, v in out["timers"].items()},
            "newton_solves": int(out["newton_solves"]),
            "newton_solves_per_s": round(out["newton_solves"] / el, 1),
            "mean_final_cost": float(out["cost_history"][-1].mean()),
            "descend_frac": float((out["cost_history"][-1]
                                   < out["cost_history"][0] + 1e-9).mean()),
            "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
            "trial_program_memory": prog_mem}


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    iters = 3
    batch = None
    lowmem = False
    trips = None
    K = None
    path = None
    for a in sys.argv[1:]:
        if a.startswith("--iters"):
            iters = int(a.split("=")[1])
        if a.startswith("--batch"):
            batch = int(a.split("=")[1])
        if a.startswith("--trips"):
            trips = int(a.split("=")[1])
        if a.startswith("--K"):
            K = int(a.split("=")[1])
        if a.startswith("--out"):
            path = a.split("=", 1)[1]
        if a == "--lowmem":
            lowmem = True
    configs = [int(a) for a in args] or [1, 3]
    fns = {1: bench_config_1, 2: bench_config_2, 3: bench_config_3,
           4: bench_config_4, 5: bench_config_5}
    from vch_tpu.runtime import setup_compile_cache
    setup_compile_cache()
    results = {}
    if path and os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    for c in configs:
        print(f"--- config {c} ---", flush=True)
        kw = {"batch": batch} if (batch and c in (2, 4, 5)) else {}
        key = f"config_{c}"
        if c == 4 and lowmem:
            kw["lowmem"] = True
            key = "config_4_lowmem"
        if c == 4 and trips:
            kw["trips"] = trips
        if K is not None and (c == 5 or (c == 4 and lowmem)):
            kw["K"] = K
            key += f"_K{K}"
        results[key] = fns[c](iters, **kw)
        print(json.dumps(results[key], indent=1), flush=True)
        if path:
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
                f.write("\n")


if __name__ == "__main__":
    main()
