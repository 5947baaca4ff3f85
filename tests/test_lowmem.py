"""Segment-checkpointed (sqrt-schedule) adjoint pipeline tests.

SURVEY.md section 7 'Memory at scale': O(M/K + K) live phi states instead of
O(M). Gates: the recomputing adjoint reproduces the full-memory adjoint to
machine precision — including non-divisible segment counts and the partial
final dt — and the lowmem batched PGD matches the full-memory batched PGD
iteration-for-iteration."""
import numpy as np
import pytest

from vch_tpu.config import ForwardSolverConfig1D, ForwardSolverConfig2D
from vch_tpu.control.targets import build_targets_1d, build_targets_2d
from vch_tpu.models.adjoint1d import AdjointSolver1D
from vch_tpu.models.adjoint2d import AdjointSolver2D
from vch_tpu.models.forward1d import ForwardSolver1D
from vch_tpu.models.forward2d import ForwardSolver2D
from vch_tpu.models.lowmem import LowMemPipeline1D, LowMemPipeline2D


@pytest.mark.slow
def test_lowmem_adjoint_matches_full_memory():
    cfg = ForwardSolverConfig2D(Nx=24, Ny=24, T=0.2, dt_initial=1e-2)
    lp = LowMemPipeline2D(cfg, K=5)
    s = ForwardSolver2D(cfg)
    rng = np.random.default_rng(0)
    M = s.M
    u = 0.05 * rng.standard_normal((M + 1, 25, 25))
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_T, phi_Q = build_targets_2d(x, y, t, np.asarray(phi_hist[0]),
                                    1.0, 1.0, cfg.T)
    adj = AdjointSolver2D(cfg)
    _, _, r_full = map(np.asarray,
                       adj.run(np.asarray(phi_hist), t, 5.0, 10.0,
                               phi_Q, phi_T))
    r_low = np.asarray(lp.adjoint_r(u, b1=5.0, b2=10.0, phi_Q=phi_Q,
                                    phi_T_target=phi_T))
    assert r_low.shape == r_full.shape
    assert np.abs(r_low - r_full).max() < 1e-12


def test_lowmem_nondivisible_segments_and_partial_dt():
    """K need not divide M, and the dt schedule may end in a partial step
    (T=0.13 with dt=2e-2 gives 7 steps, the last dt=1e-2; K=3 -> 2 full
    segments + a 1-step tail)."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.13, dt_initial=2e-2)
    s = ForwardSolver2D(cfg)
    assert s.M % 3 != 0 and not np.allclose(s.dts, s.dts[0])
    lp = LowMemPipeline2D(cfg, K=3)
    rng = np.random.default_rng(1)
    u = 0.05 * rng.standard_normal((s.M + 1, 17, 17))
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_T, phi_Q = build_targets_2d(x, y, t, np.asarray(phi_hist[0]),
                                    1.0, 1.0, cfg.T)
    adj = AdjointSolver2D(cfg)
    _, _, r_full = map(np.asarray,
                       adj.run(np.asarray(phi_hist), t, 5.0, 10.0,
                               phi_Q, phi_T))
    r_low = np.asarray(lp.adjoint_r(u, b1=5.0, b2=10.0, phi_Q=phi_Q,
                                    phi_T_target=phi_T))
    assert r_low.shape == r_full.shape
    assert np.abs(r_low - r_full).max() < 1e-12


def test_lowmem_1d_matches_full_memory():
    cfg = ForwardSolverConfig1D(N=48, T=0.1, dt_initial=1e-2)
    s = ForwardSolver1D(cfg)
    lp = LowMemPipeline1D(cfg, K=4)   # 10 steps -> 2 full segs + 2-step tail
    rng = np.random.default_rng(2)
    u = 0.05 * rng.standard_normal((s.M + 1, 49))
    phi_hist, x, t = s.simulate(control=u)          # core layout
    phi_T, phi_Q = build_targets_1d(x, t, np.asarray(phi_hist[0]), 1.0,
                                    cfg.T)
    adj = AdjointSolver1D(cfg)
    _, _, r_full = map(np.asarray,
                       adj.run(np.asarray(phi_hist), t, 0.3, 13.0,
                               phi_Q, phi_T))
    r_low = np.asarray(lp.adjoint_r(u, b1=0.3, b2=13.0, phi_Q=phi_Q,
                                    phi_T_target=phi_T))
    assert r_low.shape == r_full.shape
    assert np.abs(r_low - r_full).max() < 1e-12


def test_lowmem_cost_matches_full_cost():
    """J1 accumulated during the forward must equal the trapz cost on the
    materialized trajectory."""
    import jax.numpy as jnp

    from vch_tpu.control.cost import calculate_cost_2d

    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.13, dt_initial=2e-2)
    lp = LowMemPipeline2D(cfg, K=3)
    s = lp.solver
    rng = np.random.default_rng(3)
    u = jnp.asarray(0.05 * rng.standard_normal((s.M + 1, 17, 17)))
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_T, phi_Q = build_targets_2d(x, y, t, np.asarray(phi_hist[0]),
                                    1.0, 1.0, cfg.T)
    phi_Q = jnp.asarray(phi_Q)
    phi0 = jnp.asarray(np.asarray(phi_hist[0]))
    state = lp.core.forward_ckpt(u, phi0, phi_Q)
    c_low = float(lp.core.cost(state, u, jnp.asarray(phi_T),
                               5.0, 10.0, 1e-4, 1e-4))
    c_full = float(calculate_cost_2d(phi_hist, u, phi_Q, jnp.asarray(phi_T),
                                     x, y, t, 5.0, 10.0, 1e-4, 1e-4))
    assert abs(c_low - c_full) < 1e-10 * max(abs(c_full), 1.0)


@pytest.mark.slow
def test_lowmem_batched_pgd_matches_full_memory_pgd():
    """Three lowmem PGD iterations == three full-memory PGD iterations
    (same costs, same controls) — the integration gate."""
    from vch_tpu.parallel.batch import (BatchedProblem2D,
                                        LowMemBatchedProblem2D, sweep_2d)

    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1, dt_initial=1e-2)
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4])
    full = BatchedProblem2D(cfg)
    low = LowMemBatchedProblem2D(cfg, K=4)   # 10 steps: 2 segs + 2-step tail
    out_f = full.run(sc, max_iter=3, verbose=False)
    out_l = low.run(sc, max_iter=3, verbose=False)
    np.testing.assert_allclose(out_l["cost_history"], out_f["cost_history"],
                               rtol=1e-9)
    np.testing.assert_allclose(out_l["u"], out_f["u"], atol=1e-10)
    assert out_l["newton_solves"] == out_f["newton_solves"]


def test_lowmem_f32_fixed_trip_adjoint_matches_full_memory():
    """The f32 path routes the lowmem adjoint recomputation through the
    fixed-trip split-preconditioned solve (bicgstab_split_fixed) — it
    must agree with
    the full-memory f32 adjoint, which uses the same solver family."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1, dt_initial=1e-2,
                                dtype="float32", newton_tol=2e-4)
    s = ForwardSolver2D(cfg)
    assert s._krylov_fixed is not None     # f32 selects fixed-trip Krylov
    lp = LowMemPipeline2D(cfg, K=4)
    rng = np.random.default_rng(3)
    u = (0.05 * rng.standard_normal((s.M + 1, 17, 17))).astype(np.float32)
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_T, phi_Q = build_targets_2d(x, y, t, np.asarray(phi_hist[0]),
                                    1.0, 1.0, cfg.T)
    adj = AdjointSolver2D(cfg)
    _, _, r_full = map(np.asarray,
                       adj.run(np.asarray(phi_hist), t, 5.0, 10.0,
                               phi_Q, phi_T))
    r_low = np.asarray(lp.adjoint_r(u, b1=5.0, b2=10.0, phi_Q=phi_Q,
                                    phi_T_target=phi_T))
    assert np.all(np.isfinite(r_low))
    scale = np.abs(r_full).max()
    # f32: segment recomputation reproduces phi to the last ulp only, and
    # the Krylov iterates amplify that — 3e-5 relative observed; gate at 1e-4
    assert np.abs(r_low - r_full).max() < 1e-4 * max(scale, 1e-30)


def test_lowmem_procedural_phi_Q_matches_materialized():
    """phi_Q=None + phi_Q_mode='ramp' synthesizes the tracking target per
    segment on device (O(1) memory instead of O(M) frames per member) and
    must reproduce the materialized-phi_Q run exactly — same formula
    (targets.py choice_q=1), same PGD trajectory."""
    from vch_tpu.parallel.batch import LowMemBatchedProblem2D, sweep_2d

    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.13, dt_initial=2e-2)
    sc_mat = sweep_2d(cfg, b3_values=[1e-4, 2e-4])
    sc_proc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], materialize_phi_Q=False)
    assert sc_proc.phi_Q is None and sc_proc.phi_Q_mode == "ramp"

    out_m = LowMemBatchedProblem2D(cfg, K=3).run(sc_mat, max_iter=3,
                                                 verbose=False)
    out_p = LowMemBatchedProblem2D(cfg, K=3).run(sc_proc, max_iter=3,
                                                 verbose=False)
    np.testing.assert_allclose(out_p["cost_history"], out_m["cost_history"],
                               rtol=1e-12)
    np.testing.assert_allclose(out_p["u"], out_m["u"], atol=1e-13)
    assert out_p["newton_solves"] == out_m["newton_solves"]


def test_lowmem_procedural_zeros_mode():
    """choice_q=2 (zero tracking target) also runs procedurally and matches
    its materialized counterpart."""
    from vch_tpu.parallel.batch import LowMemBatchedProblem2D, sweep_2d

    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1, dt_initial=1e-2)
    sc_mat = sweep_2d(cfg, b3_values=[1e-4], choice_q=2)
    sc_proc = sweep_2d(cfg, b3_values=[1e-4], choice_q=2,
                       materialize_phi_Q=False)
    assert sc_proc.phi_Q_mode == "zeros"
    out_m = LowMemBatchedProblem2D(cfg, K=4).run(sc_mat, max_iter=2,
                                                 verbose=False)
    out_p = LowMemBatchedProblem2D(cfg, K=4).run(sc_proc, max_iter=2,
                                                 verbose=False)
    np.testing.assert_allclose(out_p["cost_history"], out_m["cost_history"],
                               rtol=1e-12)


def test_procedural_phi_Q_rejected_by_full_memory_problem():
    from vch_tpu.parallel.batch import BatchedProblem2D, sweep_2d

    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1)
    sc = sweep_2d(cfg, b3_values=[1e-4], materialize_phi_Q=False)
    with pytest.raises(ValueError, match="LowMemBatchedProblem2D"):
        BatchedProblem2D(cfg).run(sc, max_iter=1, verbose=False)


def test_hbm_chooser_model_cross_checked_against_program_peak():
    """The chooser's S-multiple model is checked against XLA's own buffer
    assignment: trial_memory_analysis() (compiled.memory_analysis) shows
    the trial program alone peaking at a few S, below the whole-run
    multiple the chooser uses (the run also holds u, phi, r and the
    search's selection)."""
    from vch_tpu.parallel.batch import (_PEAK_PER_S, BatchedProblem2D,
                                        LowMemBatchedProblem2D,
                                        make_batched_problem_2d, sweep_2d)

    cfg = ForwardSolverConfig2D(Nx=32, Ny=32, T=0.2, dtype="float32",
                                newton_tol=2e-4)
    B = 4
    prob = BatchedProblem2D(cfg)
    sc = sweep_2d(cfg, b3_values=np.linspace(1e-4, 4e-4, B))
    ma = prob.trial_memory_analysis(sc)
    assert ma is not None and ma["peak_memory_in_bytes"] > 0
    M = prob.solver.M
    S = B * (M + 1) * 33 * 33 * 4
    ratio = ma["peak_memory_in_bytes"] / S
    assert 4.0 <= ratio <= 8.0, ratio
    assert ratio < _PEAK_PER_S

    # chooser decision against the model: plenty of headroom ->
    # full-memory problem; a limit the estimate exceeds -> lowmem
    est = _PEAK_PER_S * S
    assert isinstance(
        make_batched_problem_2d(cfg, batch=B, hbm_limit_bytes=100 * est),
        BatchedProblem2D)
    assert isinstance(
        make_batched_problem_2d(cfg, batch=B, hbm_limit_bytes=est),
        LowMemBatchedProblem2D)


def test_chooser_member_footprint_routes_to_combined_mesh():
    """When ONE member's lowmem working set exceeds the (synthetic) chip
    limit and a scenario mesh is provided, make_batched_problem_2d re-meshes
    the devices into (scenarios, gx) and returns the combined-mesh problem
    (member-footprint rule); with a big enough limit
    the same call keeps the cheap vmapped path."""
    from vch_tpu.parallel.batch import (BatchedProblem2D,
                                        make_batched_problem_2d)
    from vch_tpu.parallel.mesh import make_mesh
    from vch_tpu.parallel.spatial import GridShardedBatchedProblem2D

    cfg = ForwardSolverConfig2D(Nx=15, Ny=15, T=0.05, dtype="float32",
                                newton_tol=2e-4)   # Nx+1=16: gx-divisible
    mesh = make_mesh()            # 8 virtual devices, 1-axis scenarios
    # member lowmem working set at this config: a few hundred KB — force
    # the rule with a tiny synthetic limit
    p = make_batched_problem_2d(cfg, batch=4, mesh=mesh,
                                hbm_limit_bytes=64 * 1024)
    assert isinstance(p, GridShardedBatchedProblem2D)
    assert set(p.mesh.axis_names) == {"scenarios", "gx"}
    assert p.mesh.devices.size == 8

    p2 = make_batched_problem_2d(cfg, batch=4, mesh=mesh,
                                 hbm_limit_bytes=16 * 2**30)
    assert isinstance(p2, BatchedProblem2D)

    with pytest.raises(ValueError, match="does not fit"):
        make_batched_problem_2d(cfg, batch=4, mesh=mesh,
                                hbm_limit_bytes=1024)


def test_make_batched_problem_2d_memory_chooser():
    from vch_tpu.parallel.batch import (BatchedProblem2D,
                                        LowMemBatchedProblem2D,
                                        make_batched_problem_2d)
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06, dtype="float32",
                                newton_tol=2e-4)
    lim = 16 * 2**30
    small = make_batched_problem_2d(cfg, batch=8, hbm_limit_bytes=lim)
    assert isinstance(small, BatchedProblem2D)
    # a batch whose estimated footprint exceeds 75% of the limit
    big = make_batched_problem_2d(cfg, batch=2_000_000,
                                  hbm_limit_bytes=lim)
    assert isinstance(big, LowMemBatchedProblem2D)


def test_chooser_requires_a_limit_without_device_memory_stats():
    """The CPU reports no device memory limit: the chooser raises instead
    of guessing one, and names the argument that supplies it."""
    from vch_tpu.parallel.batch import make_batched_problem_2d
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06)
    with pytest.raises(ValueError, match="hbm_limit_bytes"):
        make_batched_problem_2d(cfg, batch=2)
