"""Where the headline configuration's line search spends its rounds.

Reruns bench.py's headline configuration and prints, as JSON, the search
accounting run() already collects: straggler-bucket rounds, the ls_trials
distribution, and the phase timers — to show whether the backtracking tail
is many rounds, large buckets, or a few very hard members.

    python scripts/diag_backtracking.py [--b 512] [--iters 20]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    from bench import headline_config, headline_sweep, stage
    from vch_tpu.parallel.batch import BatchedProblem2D
    from vch_tpu.runtime import setup_compile_cache
    setup_compile_cache()

    B, iters = args.b, args.iters
    cfg = headline_config(64, "float32")
    prob = BatchedProblem2D(cfg)
    sc = stage(headline_sweep(cfg, B), "float32")

    prob.run(sc, max_iter=1, verbose=False)
    prob.prewarm(sc)
    prob.straggler_rounds = 0
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False, host_results=False)
    el = time.perf_counter() - t0
    lt = out["ls_trials"]
    hist = {str(k): int((lt == k).sum()) for k in sorted(set(lt.tolist()))}
    res = {
        "batch": B, "iters": iters,
        "scenario_iters_per_s": round(B * iters / el, 1),
        "timers": {k: round(v, 2) for k, v in out["timers"].items()},
        "straggler_bucket_rounds_total": int(prob.straggler_rounds),
        "rounds_per_iter": round(prob.straggler_rounds / iters, 2),
        "ls_trials_histogram_cumulative": hist,
        "mean_trials_per_member_per_iter": round(float(lt.mean()) / iters, 3),
    }
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
