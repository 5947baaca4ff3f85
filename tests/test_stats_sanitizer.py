"""Measured-solve counters and the runtime non-finite sanitizer.

The marchers return MarchStats (measured Newton-solve counts + first
non-finite step); the batched runner aggregates them into the honest
Newton-solves/s counter (ref sanitizer: Forward_solver.py:166-172)."""
import numpy as np
import jax.numpy as jnp
import pytest

from vch_tpu.config import ForwardSolverConfig1D, ForwardSolverConfig2D
from vch_tpu.models.forward1d import ForwardSolver1D
from vch_tpu.models.forward2d import ForwardSolver2D


def test_1d_stats_counts_solves():
    s = ForwardSolver1D(ForwardSolverConfig1D(N=32, T=0.05))
    s.simulate()
    st = s.last_stats
    # 5 time steps, each needing >= 1 Newton solve, bounded by max_iter
    assert 5 <= int(st.newton_solves) <= 5 * s.config.newton_max_iter
    assert int(st.first_bad_step) == -1


def test_2d_stats_counts_solves():
    s = ForwardSolver2D(ForwardSolverConfig2D(Nx=16, Ny=16, T=0.03))
    s.simulate()
    st = s.last_stats
    assert 3 <= int(st.newton_solves) <= 3 * s.config.newton_max_iter
    assert int(st.first_bad_step) == -1


def test_1d_sanitizer_raises_on_nonfinite():
    s = ForwardSolver1D(ForwardSolverConfig1D(N=32, T=0.05))
    bad = np.full((33,), np.nan)
    with pytest.raises(RuntimeError, match="Non-finite mass defect"):
        s.simulate(initial_phi=bad)


def test_2d_sanitizer_raises_on_nonfinite():
    s = ForwardSolver2D(ForwardSolverConfig2D(Nx=16, Ny=16, T=0.03))
    bad = np.full((17, 17), np.nan)
    with pytest.raises(RuntimeError, match="Non-finite mass defect"):
        s.simulate(initial_phi=bad)


def test_batched_run_counts_and_does_not_mutate_scenarios():
    from vch_tpu.parallel.batch import BatchedProblem1D, sweep_1d

    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    prob = BatchedProblem1D(cfg)
    sc = sweep_1d(cfg, b3_values=[1e-3, 2e-3])
    shape_before = sc.phi_Q.shape
    out = prob.run(sc, max_iter=2, verbose=False)
    # input batch untouched (round-1 weak #4: run() mutated caller data)
    assert sc.phi_Q.shape == shape_before
    # and a second run with the SAME object works identically
    out2 = prob.run(sc, max_iter=2, verbose=False)
    np.testing.assert_allclose(out["cost_history"], out2["cost_history"],
                               rtol=1e-12)
    # measured counters present and plausible: >= M solves per forward,
    # >= 2 forwards per iteration counted across the batch
    assert out["newton_solves"] > 0
    assert out["timers"]["total_optimization"] > 0
    assert out["timers"]["backward_total"] > 0
    assert np.isnan(out["advisor_alpha"]).all()  # advisor starts at iter 100


def test_batched_metrics_jsonl(tmp_path):
    import json

    from vch_tpu.parallel.batch import BatchedProblem1D, sweep_1d

    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    prob = BatchedProblem1D(cfg)
    sc = sweep_1d(cfg, b3_values=[1e-3])
    path = str(tmp_path / "metrics.jsonl")
    prob.run(sc, max_iter=2, verbose=False, metrics_path=path)
    lines = [json.loads(l) for l in open(path)]
    events = [l["event"] for l in lines]
    assert events.count("pgd_iter") == 2
    assert events[-1] == "run_done"
    assert lines[0]["newton_solves"] > 0
