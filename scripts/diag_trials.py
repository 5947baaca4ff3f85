"""Diagnostic: per-iteration line-search trial counts at the headline config.

Mirrors bench.py's defaults (same shapes, so the same cached compiles) but
runs verbose and longer to expose where backtracking rounds are spent.

    VCH_BENCH_N=64 VCH_BENCH_BATCH=32 VCH_BENCH_ITERS=6 \\
        python scripts/diag_trials.py
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from bench import headline_config, headline_sweep, stage
    from vch_tpu.parallel.batch import BatchedProblem2D
    from vch_tpu.runtime import setup_compile_cache
    setup_compile_cache()

    N = int(os.environ.get("VCH_BENCH_N", "64"))
    B = int(os.environ.get("VCH_BENCH_BATCH", "32"))
    iters = int(os.environ.get("VCH_BENCH_ITERS", "6"))
    alpha0 = os.environ.get("VCH_ALPHA0")

    cfg = headline_config(N, "float32")
    prob = BatchedProblem2D(cfg)
    sc = stage(headline_sweep(cfg, B), "float32")
    if alpha0:
        prob.alpha_max = float(alpha0)  # initial alpha only; growth still capped below
    prob.run(sc, max_iter=1, verbose=False)  # warmup
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=True, host_results=False)
    el = time.perf_counter() - t0
    print(f"elapsed {el:.2f}s  {B*iters/el:.3f} scen-it/s  "
          f"newton_solves {out['newton_solves']}", file=sys.stderr)
    print("timers", {k: round(v, 3) for k, v in out["timers"].items()},
          file=sys.stderr)
    print("mean cost trajectory",
          np.asarray(out["cost_history"]).mean(axis=1).round(4),
          file=sys.stderr)


if __name__ == "__main__":
    main()
