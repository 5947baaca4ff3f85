"""Batched + sharded PGD tests on the 8-device virtual CPU mesh.

No reference analog (the reference is single-process, SURVEY.md section 2.3);
gates: batched runs agree with single-scenario runs, and mesh-sharded
execution agrees with unsharded execution.
"""
import os

import numpy as np
import jax
import pytest

from vch_tpu.config import ForwardSolverConfig1D, ForwardSolverConfig2D, OptimizationConfig
from vch_tpu.control.problems import ControlProblem1D
from vch_tpu.parallel.batch import BatchedProblem1D, BatchedProblem2D, sweep_1d, sweep_2d
from vch_tpu.parallel.mesh import make_mesh, shard_batch


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_batched_1d_matches_single_scenario(golden_1d):
    """A batch whose members all equal the default scenario reproduces the
    single-scenario (and hence reference) cost trajectory."""
    cfg = ForwardSolverConfig1D()
    prob = BatchedProblem1D(cfg)
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=[0.0019, 0.0019], kappa_values=[9e-5])
    out = prob.run(sc, max_iter=3, verbose=False)
    ref = golden_1d["cost_traj"][:4]
    for b in range(2):
        rel = np.abs(out["cost_history"][:, b] - ref) / np.abs(ref)
        assert rel.max() < 1e-8, rel


def test_batched_1d_sweep_varies_sparsity():
    """Higher kappa_spar must give sparser controls."""
    cfg = ForwardSolverConfig1D(N=64, T=0.3)
    prob = BatchedProblem1D(cfg)
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=[0.0019], kappa_values=[1e-6, 5e-3])
    out = prob.run(sc, max_iter=6, verbose=False)
    sparsity = [np.mean(np.abs(out["u"][b]) < 1e-8) for b in range(2)]
    assert sparsity[1] > sparsity[0]
    assert (out["cost_history"][-1] <= out["cost_history"][0] + 1e-12).all()


def test_batched_1d_sharded_matches_unsharded():
    cfg = ForwardSolverConfig1D(N=64, T=0.2)
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=[1e-3, 2e-3, 3e-3, 4e-3],
                  kappa_values=[1e-5, 1e-4])
    out_plain = BatchedProblem1D(cfg).run(sc, max_iter=3, verbose=False)
    mesh = make_mesh()
    sc2 = sweep_1d(cfg, OptimizationConfig(),
                   b3_values=[1e-3, 2e-3, 3e-3, 4e-3],
                   kappa_values=[1e-5, 1e-4])
    out_mesh = BatchedProblem1D(cfg, mesh=mesh).run(sc2, max_iter=3,
                                                    verbose=False)
    assert np.allclose(out_plain["cost_history"], out_mesh["cost_history"],
                       rtol=1e-10)
    assert np.allclose(out_plain["u"], out_mesh["u"], atol=1e-10)


def test_batched_2d_runs_and_descends():
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1)
    prob = BatchedProblem2D(cfg, mesh=make_mesh())
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[1e-4])
    out = prob.run(sc, max_iter=2, verbose=False)
    assert (out["cost_history"][-1] < out["cost_history"][0]).all()


def test_shard_batch_places_on_mesh():
    mesh = make_mesh()
    x = np.zeros((8, 4))
    (y,) = shard_batch((x,), mesh)
    assert len(set(d.id for d in y.devices())) == 8


def test_batched_checkpoint_resume(tmp_path):
    """Checkpoint at iter 2, resume, and land on the same final state as an
    uninterrupted run (new capability; reference has none, SURVEY.md sec 5)."""
    cfg = ForwardSolverConfig1D(N=48, T=0.2)
    sc_a = sweep_1d(cfg, OptimizationConfig(), b3_values=[1e-3, 2e-3],
                    kappa_values=[1e-4])
    full = BatchedProblem1D(cfg).run(sc_a, max_iter=4, verbose=False)

    ckpt = str(tmp_path / "pgd.npz")
    sc_b = sweep_1d(cfg, OptimizationConfig(), b3_values=[1e-3, 2e-3],
                    kappa_values=[1e-4])
    prob = BatchedProblem1D(cfg)
    prob.run(sc_b, max_iter=2, verbose=False,
             checkpoint_path=ckpt, checkpoint_every=2)
    sc_c = sweep_1d(cfg, OptimizationConfig(), b3_values=[1e-3, 2e-3],
                    kappa_values=[1e-4])
    resumed = prob.run(sc_c, max_iter=4, verbose=False,
                       checkpoint_path=ckpt, resume=True)
    assert np.allclose(resumed["u"], full["u"], atol=1e-12)
    assert np.allclose(resumed["cost_history"][-1], full["cost_history"][-1],
                       rtol=1e-12)


def test_batched_2d_matches_single_scenario(golden_2d):
    """A 2-member batch of the default 32x32 scenario reproduces the golden
    (reference) cost trajectory, like the 1D batched parity test."""
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import BatchedProblem2D, sweep_2d

    cfg = ForwardSolverConfig2D(Nx=32, Ny=32, T=0.25)
    prob = BatchedProblem2D(cfg)
    sc = sweep_2d(cfg, OptimizationConfig.defaults_2d(),
                  b3_values=[1e-4, 1e-4], kappa_values=[1e-4])
    out = prob.run(sc, max_iter=3, verbose=False)
    ref = golden_2d["cost_traj"]
    for b in range(2):
        rel = np.abs(out["cost_history"][:, b] - ref) / np.abs(ref)
        assert rel.max() < 1e-6, rel


def test_batched_metrics_jsonl_and_advisor(tmp_path):
    """metrics_path streams one JSON object per PGD iteration plus a
    run_done record (the machine-readable analog of the reference's printed
    logs, SURVEY.md section 5), and the batched runner reports per-member
    alpha-advisor state (ref GD_1D.py:388-404 vectorized)."""
    import json

    from vch_tpu.control.pgd import PGDSettings

    cfg = ForwardSolverConfig1D(N=48, T=0.2)
    sc = sweep_1d(cfg, OptimizationConfig(), b3_values=[1e-3, 2e-3],
                  kappa_values=[1e-4])
    # advisor normally starts at iter 100; pull it forward for the test
    settings = PGDSettings.defaults_1d()
    import dataclasses
    settings = dataclasses.replace(settings, advisor_start_iter=1)
    path = str(tmp_path / "metrics.jsonl")
    out = BatchedProblem1D(cfg, settings=settings).run(
        sc, max_iter=3, verbose=False, metrics_path=path)

    with open(path) as f:
        records = [json.loads(line) for line in f]
    iters = [r for r in records if r["event"] == "pgd_iter"]
    done = [r for r in records if r["event"] == "run_done"]
    assert len(iters) == 3 and len(done) == 1
    assert {"k", "mean_cost", "converged", "max_trials",
            "newton_solves", "mean_alpha"} <= set(iters[0])
    assert done[0]["newton_solves"] == out["newton_solves"] > 0
    assert set(done[0]["timers"]) == set(out["timers"])

    # optimistic steps succeed from iter >= 2 here, so the advisor has data
    adv = out["advisor_alpha"]
    assert adv.shape == (2,)
    assert np.isfinite(adv).all() and (adv > 0).all()


def test_batched_2d_mesh_straggler_bucketing_matches_full():
    """Per-DEVICE straggler compaction under the scenario mesh (shard-local
    gather/scatter inside shard_map) reproduces the
    full-batch masked-merge mesh run exactly, with fewer Newton solves.
    Each device buckets its own stragglers by LOCAL index — no collectives."""
    from vch_tpu.parallel.mesh import make_mesh

    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.15)
    B = 24    # 3 members per device on the 8-device mesh
    mk = lambda: sweep_2d(cfg, b3_values=[5e-5, 1e-4, 2e-4, 4e-4],
                          kappa_values=[5e-5, 1e-4, 1.5e-4, 2e-4, 3e-4,
                                        4e-4])
    assert mk().batch == B
    mesh = make_mesh()
    out_full = BatchedProblem2D(cfg, alpha_max=2000.0, mesh=mesh).run(
        mk(), max_iter=8, verbose=False)
    prob = BatchedProblem2D(cfg, alpha_max=2000.0, mesh=mesh,
                            straggler_batch=1)
    out_sub = prob.run(mk(), max_iter=8, verbose=False)
    assert prob.straggler_rounds > 0, (
        "per-device compaction never engaged; tune the scenario so some "
        "backtracking round has <= straggler_batch stragglers per device")
    np.testing.assert_allclose(out_sub["cost_history"],
                               out_full["cost_history"], rtol=1e-11)
    np.testing.assert_allclose(out_sub["u"], out_full["u"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(out_sub["alpha"], out_full["alpha"],
                               rtol=1e-12)
    assert out_sub["newton_solves"] < out_full["newton_solves"]


def test_batched_2d_straggler_compaction_matches_full():
    """Straggler compaction (sub-batch backtracking rounds) is an identical-
    semantics optimization: gathered trial + scatter must reproduce the
    full-batch masked-merge run exactly. No reference analog."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.15)
    mk = lambda: sweep_2d(cfg, b3_values=[5e-5, 1e-4, 2e-4],
                          kappa_values=[5e-5, 2e-4])
    out_full = BatchedProblem2D(cfg, alpha_max=2000.0, speculative=False).run(
        mk(), max_iter=8, verbose=False)
    prob = BatchedProblem2D(cfg, alpha_max=2000.0, straggler_batch=4)
    out_sub = prob.run(mk(), max_iter=8, verbose=False)
    assert prob.straggler_rounds > 0, (
        "compaction never engaged; tune the scenario so some backtracking "
        "round has <= straggler_batch searching members")
    # sub-batch XLA programs may associate grid reductions differently ->
    # O(1e-14) f64 noise per accepted trial; semantics (accept decisions,
    # alphas, trial counts) must be exact
    np.testing.assert_allclose(out_sub["cost_history"],
                               out_full["cost_history"], rtol=1e-11)
    np.testing.assert_allclose(out_sub["u"], out_full["u"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(out_sub["alpha"], out_full["alpha"],
                               rtol=1e-12)
    assert out_sub["newton_solves"] < out_full["newton_solves"]


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_batched_speculative_matches_sequential(dim):
    """Speculative ladder packing must reproduce the sequential masked
    search exactly: same accepted iterates, same alphas, same per-member
    trial counts — it only reorders WHEN candidates are evaluated."""
    if dim == "1d":
        cfg = ForwardSolverConfig1D(N=32, T=0.2)
        mk = lambda: sweep_1d(cfg, b3_values=[1e-4, 5e-4, 2e-3],
                              kappa_values=[1e-4, 1e-3])
        mk_prob = lambda **kw: BatchedProblem1D(cfg, alpha_max=100.0, **kw)
        max_iter = 10
    else:
        cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.15)
        mk = lambda: sweep_2d(cfg, b3_values=[5e-5, 1e-4, 2e-4],
                              kappa_values=[5e-5, 2e-4])
        mk_prob = lambda **kw: BatchedProblem2D(cfg, alpha_max=2000.0, **kw)
        max_iter = 8
    out_seq = mk_prob(speculative=False).run(mk(), max_iter=max_iter,
                                             verbose=False)
    prob = mk_prob(speculative=True)
    out_spec = prob.run(mk(), max_iter=max_iter, verbose=False)
    assert prob.speculative_rounds > 0, (
        "speculation never engaged; tune the scenario so some search episode "
        "has <= B/2 members backtracking")
    np.testing.assert_allclose(out_spec["cost_history"],
                               out_seq["cost_history"], rtol=1e-11)
    np.testing.assert_allclose(out_spec["u"], out_seq["u"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(out_spec["alpha"], out_seq["alpha"],
                               rtol=1e-12)
    np.testing.assert_array_equal(out_spec["ls_trials"],
                                  out_seq["ls_trials"])


def test_batched_2d_chunked_matches_full():
    """Chunked execution (chunk_size members per device call) is pure
    orchestration: identical outputs to the single-program run. It exists
    to bound the vmapped while_loop lockstep cost at large B."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.15)
    mk = lambda: sweep_2d(cfg, b3_values=[5e-5, 1e-4, 2e-4],
                          kappa_values=[5e-5, 2e-4])
    out_full = BatchedProblem2D(cfg, alpha_max=2000.0).run(
        mk(), max_iter=6, verbose=False)
    prob = BatchedProblem2D(cfg, alpha_max=2000.0, chunk_size=3)
    out_chunk = prob.run(mk(), max_iter=6, verbose=False)
    assert prob.chunk_calls > 0
    # chunk-shaped XLA programs associate reductions differently -> f64
    # noise accumulates through prox/clip over iterations; decisions
    # (costs, trial counts, solve counts) must agree exactly
    np.testing.assert_allclose(out_chunk["cost_history"],
                               out_full["cost_history"], rtol=1e-9)
    np.testing.assert_allclose(out_chunk["u"], out_full["u"], rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(out_chunk["ls_trials"],
                                  out_full["ls_trials"])
    assert out_chunk["newton_solves"] == out_full["newton_solves"]


@pytest.mark.skipif(os.environ.get("VCH_RUN_MULTIPROCESS") != "1",
                    reason="spawns 2 jax.distributed subprocesses (Gloo); "
                           "opt in with VCH_RUN_MULTIPROCESS=1 (the script "
                           "is also run standalone: "
                           "scripts/multiprocess_cpu.py)")
def test_multiprocess_distributed_matches_single_process():
    """Two real jax.distributed CPU processes, global scenario batch from
    process-local shards, 3 batched PGD iterations — costs must match the
    single-process run to f64 roundoff (scripts/multiprocess_cpu.py)."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "multiprocess_cpu.py")],
        timeout=1500, env={**os.environ, "JAX_PLATFORMS": ""}).returncode
    assert rc == 0
