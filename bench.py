"""Headline benchmark: batched 2D PGD scenario-iterations per second.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Metric (BASELINE.md primary): PGD outer iterations/s on the 2D vCH control
problem, counted in SCENARIO-iterations (batch members x PGD iterations) per
second on one chip. The baseline is the reference NumPy/SciPy implementation
measured on CPU at the same grid/horizon (BASELINE_MEASURED.json, produced by
scripts/ref_baseline_2d.py running the actual reference code): it processes
1/pgd_iter_s_mean scenario-iterations per second (single scenario, its only
mode). vs_baseline = ours / reference.

Env overrides: VCH_BENCH_N (grid, default 64), VCH_BENCH_BATCH (default
512), VCH_BENCH_ITERS (default 20 — the SAME protocol as the baseline
denominator, which is the mean over a 20-iteration reference run; a
3-iteration window front-loads the hardest line searches), VCH_BENCH_DTYPE
(default float32 on an accelerator, float64 on the CPU).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def headline_config(N: int = 64, dtype: str = "float32", **over):
    """The benchmark's 2D configuration: N x N grid, T=1 (M=100 steps)."""
    from vch_tpu.config import ForwardSolverConfig2D
    kw = dict(Nx=N, Ny=N, T=1.0, dtype=dtype,
              newton_tol=2e-4 if dtype == "float32" else 1e-6)
    kw.update(over)
    return ForwardSolverConfig2D(**kw)


def headline_sweep(cfg, B: int):
    """The benchmark's (b3, kappa_spar) sweep of exactly B members."""
    import dataclasses
    from vch_tpu.parallel.batch import sweep_2d
    b3s = np.linspace(5e-5, 2e-4, max(1, B // 4))
    kss = np.linspace(5e-5, 2e-4, 4)[: max(1, min(4, B))]
    sc = sweep_2d(cfg, b3_values=b3s, kappa_values=kss)
    reps = -(-B // sc.batch)
    tile = lambda a: np.concatenate([a] * reps, axis=0)[:B]
    return dataclasses.replace(
        sc, phi0=tile(sc.phi0), phi_T=tile(sc.phi_T), phi_Q=tile(sc.phi_Q),
        b1=tile(sc.b1), b2=tile(sc.b2), b3=tile(sc.b3),
        kappa_spar=tile(sc.kappa_spar))


def stage(sc, dtype: str):
    """Put a sweep's arrays on the device once (a real optimization keeps
    them resident for hundreds of iterations)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    put = lambda a: None if a is None else jax.device_put(
        jnp.asarray(a, dtype))
    return dataclasses.replace(
        sc, phi0=put(sc.phi0), phi_T=put(sc.phi_T), phi_Q=put(sc.phi_Q),
        b1=put(sc.b1), b2=put(sc.b2), b3=put(sc.b3),
        kappa_spar=put(sc.kappa_spar))


def main():
    import jax

    from vch_tpu.runtime import default_dtype, setup_compile_cache
    setup_compile_cache()
    # VCH_BENCH_PROFILE=config4 selects BASELINE.md's config-4 shape (2D
    # 128x128, B=128); explicit VCH_BENCH_N / VCH_BENCH_BATCH override.
    profile = os.environ.get("VCH_BENCH_PROFILE", "")
    prof_n, prof_b = ("128", "128") if profile == "config4" else ("64", "512")
    N = int(os.environ.get("VCH_BENCH_N", prof_n))
    B = int(os.environ.get("VCH_BENCH_BATCH", prof_b))
    iters = int(os.environ.get("VCH_BENCH_ITERS", "20"))
    dtype = os.environ.get("VCH_BENCH_DTYPE", default_dtype())
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    from vch_tpu.parallel.batch import BatchedProblem2D

    kf = os.environ.get("VCH_BENCH_KRYLOV_FIXED")
    at = os.environ.get("VCH_BENCH_ADJ_TRIPS")
    cfg = headline_config(
        N, dtype,
        forward_matmul_precision=os.environ.get("VCH_BENCH_FWD_PRECISION")
        or None,
        **({"krylov_fixed_iters": int(kf)} if kf else {}),
        **({"adjoint_krylov_fixed_iters": int(at)} if at else {}))
    # VCH_BENCH_SEARCH selects the line-search scheduler; all three are
    # identical-semantics and parity-gated in tests/test_parallel.py:
    #   "plain" (default) — masked full-batch rounds.
    #   "spec"   — speculative ladder packing (idle rows evaluate several
    #             backtracking candidates per straggler per round).
    #   "straggler" — sub-batch compaction (size VCH_BENCH_STRAGGLER,
    #             default B/4; extra compile at the sub-shape).
    sb_env = os.environ.get("VCH_BENCH_STRAGGLER", "")
    sb = sb_env if sb_env == "auto" else int(sb_env or "0")
    mode = os.environ.get("VCH_BENCH_SEARCH", "plain")
    if mode == "straggler" and sb == 0:
        sb = max(1, B // 4)
    # VCH_BENCH_CHUNK=k: chunked execution (k members per device call) —
    # bounds the vmapped while_loop lockstep cost at large B
    ck = int(os.environ.get("VCH_BENCH_CHUNK", "0"))
    prob = BatchedProblem2D(cfg,
                            straggler_batch=(sb if sb == "auto"
                                             else (sb if sb > 0 else None)),
                            speculative=(mode == "spec" and sb == 0),
                            chunk_size=ck if ck > 0 else None)
    sc = stage(headline_sweep(cfg, B), dtype)

    # warmup (compile + 1 iteration; prewarm compiles the straggler-bucket
    # trial shapes the masked search can gather into)
    prob.run(sc, max_iter=1, verbose=False)
    prob.prewarm(sc)
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False,
                   host_results=False)
    elapsed = time.perf_counter() - t0
    assert np.all(np.isfinite(out["cost_history"]))
    # A failed line search legitimately keeps a worse iterate for a member
    # (reference semantics, GD_1D.py:110-113); report descent diagnostics
    # on stderr rather than gating the throughput metric on them.
    descend_frac = float(
        (out["cost_history"][-1] < out["cost_history"][0] + 1e-9).mean())
    print(f"[bench] mean cost {out['cost_history'][0].mean():.4f} -> "
          f"{out['cost_history'][-1].mean():.4f}, descend_frac "
          f"{descend_frac:.2f}", file=sys.stderr)

    value = B * iters / elapsed

    # BASELINE.md primary counter: Newton solves/s per device, MEASURED from the
    # Newton while_loop trip counts accumulated across every forward solve
    # the timed run performed (baseline forward + all line-search trials).
    from vch_tpu.utils.profiling import SolveCounters
    counters = SolveCounters(time_steps=prob.solver.M, batch=B)
    counters.record(pgd_iters=iters, elapsed_s=elapsed,
                    newton_solves=int(out["newton_solves"]))
    print(f"[bench] {counters.summary()}", file=sys.stderr)
    print(f"[bench] timers {out['timers']}", file=sys.stderr)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[bench] peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          file=sys.stderr)

    baseline = None
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE_MEASURED.json")) as f:
            ref = json.load(f)
        key = f"2d_n{N}"
        if key in ref and ref[key].get("pgd_iter_s_mean"):
            baseline = 1.0 / ref[key]["pgd_iter_s_mean"]
    except Exception:
        pass

    result = {
        "metric": f"pgd_scenario_iters_per_s_2d_{N}x{N}_b{B}_{dtype}",
        "value": round(value, 4),
        "unit": "scenario-iters/s",
        "vs_baseline": (round(value / baseline, 2) if baseline else None),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
