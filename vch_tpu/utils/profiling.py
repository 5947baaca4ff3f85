"""Profiler integration + solver throughput counters.

The reference's only tracing is printed wall-clock accumulators
(GD_1D.py:563-576). Equivalents here:
  - `trace(logdir)`: context manager around `jax.profiler` producing
    TensorBoard-loadable device traces of the jitted solvers.
  - `SolveCounters`: derives the BASELINE.md north-star counters
    (Newton solves/s per device, PGD scenario-iterations/s) from phase timings
    and the solver's static step counts.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass


@contextmanager
def trace(logdir: str = "/tmp/vch_tpu_trace"):
    """Capture a jax.profiler device trace around a block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@dataclass
class SolveCounters:
    """Throughput accounting for a batched PGD run.

    newton_solves is MEASURED: the batched runner accumulates the Newton
    while_loop trip counts of every forward solve it executes
    (models/forward*.MarchStats; parallel/batch.run returns the total), so
    newton_solves_per_s is real work / real wall-clock — no estimated
    iteration factors.
    """

    time_steps: int
    batch: int
    pgd_iters: int = 0
    elapsed_s: float = 0.0
    newton_solves: int = 0

    def record(self, pgd_iters: int, elapsed_s: float, newton_solves: int):
        self.pgd_iters += pgd_iters
        self.elapsed_s += elapsed_s
        self.newton_solves += newton_solves

    @property
    def scenario_iters_per_s(self) -> float:
        return (self.batch * self.pgd_iters / self.elapsed_s
                if self.elapsed_s > 0 else 0.0)

    @property
    def newton_solves_per_s(self) -> float:
        return (self.newton_solves / self.elapsed_s
                if self.elapsed_s > 0 else 0.0)

    def summary(self) -> dict:
        return {
            "pgd_scenario_iters_per_s": round(self.scenario_iters_per_s, 4),
            "newton_solves_per_s": round(self.newton_solves_per_s, 1),
            "newton_solves_measured": self.newton_solves,
            "batch": self.batch,
            "pgd_iters": self.pgd_iters,
            "elapsed_s": round(self.elapsed_s, 3),
        }
