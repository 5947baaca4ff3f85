"""Grid-sharded (halo exchange) operator tests on the 8-device virtual mesh."""
import numpy as np
import jax.numpy as jnp
import pytest

from vch_tpu.ops.laplacian import stencil_laplacian_2d
from vch_tpu.ops.stability import dispersion_relation, instability_report
from vch_tpu.parallel.mesh import make_mesh
from vch_tpu.parallel.spatial import sharded_laplacian_2d


def test_sharded_halo_laplacian_matches_unsharded():
    mesh = make_mesh()
    N = 127  # 128 rows over 8 shards
    hx = hy = 1.0 / N
    f = sharded_laplacian_2d(mesh, "scenarios", hx, hy)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((N + 1, N + 1)))
    got = np.asarray(f(v))
    ref = np.asarray(stencil_laplacian_2d(v, hx, hy))
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


def test_sharded_laplacian_neumann_nullspace():
    mesh = make_mesh()
    f = sharded_laplacian_2d(mesh, "scenarios", 1 / 63, 1 / 63)
    out = np.asarray(f(jnp.ones((64, 64))))
    assert np.abs(out).max() == 0.0


def test_instability_report_matches_test_formula():
    """lambda(k) = (-kappa q^2 - a q)/(1+tau q) equals the growth-rate form
    q(2c2-2c1-kappa q)/(1+tau q) used by the reference 2D test
    (test_2d_forward.py:371-401)."""
    c1, c2, kappa, tau = 0.75, 1.0, 1e-4, 0.05
    k = np.pi * np.arange(1, 13)
    lam = dispersion_relation(c1, c2, kappa, tau, k)
    q = k ** 2
    lam2 = q * (2 * c2 - 2 * c1 - kappa * q) / (1 + tau * q)
    assert np.allclose(lam, lam2, rtol=1e-12)
    rep = instability_report(c1, c2, kappa, tau, 1.0, verbose=False)
    assert rep.shape == (12,)
    assert (rep > 0).sum() > 0  # default params are spinodally unstable


def test_grid_sharded_forward_matches_unsharded():
    """The FULL grid-sharded marcher (Newton + Armijo + mass correction
    under shard_map) must reproduce the single-device ForwardSolver2D
    trajectory."""
    import jax

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.models.forward2d import ForwardSolver2D
    from vch_tpu.parallel.spatial import GridShardedForward2D
    from jax.sharding import Mesh

    cfg = ForwardSolverConfig2D(Nx=31, Ny=24, T=0.05, dt_initial=1e-2)
    mesh = Mesh(np.array(jax.devices()[:8]), ("gx",))
    rng = np.random.default_rng(0)
    u = 0.05 * rng.standard_normal((6, 32, 25))

    gs = GridShardedForward2D(cfg, mesh=mesh)
    phi_sh, _, _ = gs.simulate(control=u)
    ref = ForwardSolver2D(cfg)
    phi_ref, _, _ = ref.simulate(control=u)
    # identical math, different reduction/apply order (stencil + collectives
    # vs dense matmuls): agree to solver tolerance, far below newton_tol
    err = np.abs(np.asarray(phi_sh) - np.asarray(phi_ref)).max()
    assert err < 1e-8, err


def test_grid_sharded_rejects_indivisible_rows():
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.spatial import GridShardedForward2D

    mesh = Mesh(np.array(jax.devices()[:8]), ("gx",))
    with pytest.raises(AssertionError):
        GridShardedForward2D(ForwardSolverConfig2D(Nx=30, Ny=30, T=0.05),
                             mesh=mesh)


def test_grid_sharded_forward_counters_and_sanitizer():
    """De-islanded GridShardedForward2D: measured Newton-solve counters
    (from the psum-coupled while_loop trips) and the non-finite sanitizer
    channel, matching the unsharded solver's counts exactly."""
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.models.forward2d import ForwardSolver2D
    from vch_tpu.parallel.spatial import GridShardedForward2D

    cfg = ForwardSolverConfig2D(Nx=31, Ny=24, T=0.04, dt_initial=1e-2)
    mesh = Mesh(np.array(jax.devices()[:8]), ("gx",))
    gs = GridShardedForward2D(cfg, mesh=mesh)
    gs.simulate()
    ref = ForwardSolver2D(cfg)
    ref.simulate()
    assert int(gs.last_stats.newton_solves) == int(ref.last_stats.newton_solves) > 0
    assert int(gs.last_stats.first_bad_step) == -1


def test_grid_sharded_adjoint_matches_unsharded():
    """Grid-sharded (p, q, r) backward sweep == AdjointSolver2D on a real
    forward trajectory."""
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.models.adjoint2d import AdjointSolver2D
    from vch_tpu.models.forward2d import ForwardSolver2D
    from vch_tpu.parallel.spatial import GridShardedAdjoint2D

    cfg = ForwardSolverConfig2D(Nx=31, Ny=24, T=0.05, dt_initial=1e-2)
    s = ForwardSolver2D(cfg)
    rng = np.random.default_rng(0)
    u = 0.05 * rng.standard_normal((s.M + 1, 32, 25))
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_T = 0.5 * np.cos(np.pi * x)[:, None] * np.ones(25)[None, :]
    phi_Q = np.zeros_like(np.asarray(phi_hist))

    ref = AdjointSolver2D(cfg)
    p0, q0, r0 = map(np.asarray, ref.run(phi_hist, t, 5.0, 10.0,
                                         phi_Q, phi_T))
    mesh = Mesh(np.array(jax.devices()[:8]), ("gx",))
    gadj = GridShardedAdjoint2D(cfg, mesh=mesh)
    p1, q1, r1 = map(np.asarray, gadj.run(phi_hist, t, 5.0, 10.0,
                                          phi_Q, phi_T))
    for a, b, nm in ((p0, p1, "p"), (q0, q1, "q"), (r0, r1, "r")):
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() < 1e-7 * scale, (
            nm, np.abs(a - b).max() / scale)


def _diversified_sweep_2d(cfg, B, seed0=50):
    import dataclasses

    from vch_tpu.config import DELTA_SEP
    from vch_tpu.ops.potential import init_phi_random_2d
    from vch_tpu.parallel.batch import sweep_2d

    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[5e-5, 1e-4])
    assert sc.batch == B
    phi0 = np.stack([init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                        seed=seed0 + i) for i in range(B)])
    scale = np.linspace(0.6, 1.4, B)
    return dataclasses.replace(
        sc, phi0=phi0,
        phi_T=sc.phi_T * scale[:, None, None],
        phi_Q=sc.phi_Q * scale[:, None, None, None],
        b1=sc.b1 * np.linspace(0.5, 2.0, B),
        b2=sc.b2 * np.linspace(1.5, 0.75, B))


def test_batched_grid_sharded_forward_adjoint_parity():
    """Batched grid-sharded march + adjoint on the combined (scenarios, gx)
    mesh == per-member single-device solvers.
    The mesh-lockstep loop predicates (globally OR'd conds with frozen
    members) must leave member results bit-level identical."""
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import DELTA_SEP, ForwardSolverConfig2D
    from vch_tpu.models.adjoint2d import AdjointSolver2D
    from vch_tpu.models.forward2d import ForwardSolver2D
    from vch_tpu.ops.potential import init_phi_random_2d
    from vch_tpu.parallel.spatial import (GridShardedAdjoint2D,
                                          GridShardedForward2D)

    cfg = ForwardSolverConfig2D(Nx=31, Ny=24, T=0.04, dt_initial=1e-2)
    B = 4
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("scenarios", "gx"))
    fwd = GridShardedForward2D(cfg, mesh=mesh, batch_axis="scenarios")
    phi0 = jnp.asarray(np.stack([
        init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1, seed=50 + i)
        for i in range(B)]))
    u = jnp.zeros((B, fwd.M + 1, cfg.Nx + 1, cfg.Ny + 1))
    phi, ns, bad = fwd.march(u, phi0)
    assert np.all(np.asarray(bad) == -1)

    ref = ForwardSolver2D(cfg)
    for i in range(B):
        pr, _, _ = ref.simulate(control=np.asarray(u[i]),
                                initial_phi=np.asarray(phi0[i]))
        assert np.abs(np.asarray(phi)[i] - np.asarray(pr)).max() < 1e-12
        assert int(np.asarray(ns)[i]) == int(ref.last_stats.newton_solves)

    adj = GridShardedAdjoint2D(cfg, mesh=mesh, batch_axis="scenarios")
    b1 = jnp.asarray(np.linspace(2.0, 8.0, B))
    b2 = jnp.asarray(np.linspace(12.0, 6.0, B))
    phiQ = jnp.zeros_like(phi)
    phiT = jnp.asarray(0.1 * np.random.default_rng(0).standard_normal(
        (B, cfg.Nx + 1, cfg.Ny + 1)))
    _, _, r = adj.run_impl(phi, jnp.asarray(fwd.dts), b1, b2, phiQ, phiT)
    radj = AdjointSolver2D(cfg)
    for i in range(B):
        _, _, r0 = radj.run(np.asarray(phi)[i], fwd.t_hist, float(b1[i]),
                            float(b2[i]), np.asarray(phiQ[i]),
                            np.asarray(phiT[i]))
        scale = max(np.abs(np.asarray(r0)).max(), 1e-30)
        assert np.abs(np.asarray(r)[i] - np.asarray(r0)).max() < 1e-10 * scale


def test_batched_grid_sharded_checkpoint_resume(tmp_path):
    """Checkpoint/resume works on the combined (scenarios, gx) mesh: the
    resume path re-places state through the rank-based input shardings and
    lands on the same final iterate as an uninterrupted run."""
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.spatial import GridShardedBatchedProblem2D

    cfg = ForwardSolverConfig2D(Nx=15, Ny=16, T=0.03, dt_initial=1e-2)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("scenarios", "gx"))
    sc = _diversified_sweep_2d(cfg, 4)
    full = GridShardedBatchedProblem2D(cfg, mesh=mesh).run(
        sc, max_iter=3, verbose=False)

    ckpt = str(tmp_path / "pgd_gs.npz")
    prob = GridShardedBatchedProblem2D(cfg, mesh=mesh)
    prob.run(sc, max_iter=2, verbose=False,
             checkpoint_path=ckpt, checkpoint_every=2)
    resumed = prob.run(sc, max_iter=3, verbose=False,
                       checkpoint_path=ckpt, resume=True)
    assert np.allclose(resumed["u"], full["u"], atol=1e-12)
    assert np.allclose(resumed["cost_history"][-1],
                       full["cost_history"][-1], rtol=1e-12)


def test_make_batched_problem_combined_mesh_arm():
    """make_batched_problem_2d routes a mesh that carries a 'gx' axis to
    the combined-mesh batched problem."""
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import make_batched_problem_2d
    from vch_tpu.parallel.spatial import GridShardedBatchedProblem2D

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("scenarios", "gx"))
    prob = make_batched_problem_2d(
        ForwardSolverConfig2D(Nx=31, Ny=24, T=0.04, dt_initial=1e-2),
        batch=4, mesh=mesh)
    assert isinstance(prob, GridShardedBatchedProblem2D)
    assert prob.mesh is mesh


@pytest.mark.slow
def test_batched_grid_sharded_pgd_matches_unsharded_batched():
    """Full batched PGD on the combined (4 scenarios x 2 gx) mesh ==
    BatchedProblem2D (single-device vmapped scan) member-for-member:
    cost histories, controls, and measured Newton counts."""
    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import BatchedProblem2D
    from vch_tpu.parallel.spatial import GridShardedBatchedProblem2D

    cfg = ForwardSolverConfig2D(Nx=31, Ny=24, T=0.04, dt_initial=1e-2)
    sc = _diversified_sweep_2d(cfg, 4)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("scenarios", "gx"))
    prob = GridShardedBatchedProblem2D(cfg, mesh=mesh)
    out = prob.run(sc, max_iter=2, verbose=False)

    ref = BatchedProblem2D(cfg)
    out_ref = ref.run(sc, max_iter=2, verbose=False)

    ch, ch_ref = out["cost_history"], out_ref["cost_history"]
    assert np.unique(ch_ref[-1].round(4)).size == 4   # genuinely distinct
    assert np.abs(ch - ch_ref).max() < 1e-8 * np.abs(ch_ref).max()
    assert np.abs(out["u"] - out_ref["u"]).max() < 1e-8
    assert out["newton_solves"] == out_ref["newton_solves"] > 0


@pytest.mark.slow
def test_grid_sharded_pgd_matches_unsharded():
    """Full grid-sharded PGD (forward + adjoint + prox + host line search,
    everything on the grid mesh) reproduces the single-device
    ControlProblem2D trajectory over SIX iterations that exercise the whole
    search machinery under the mesh: at least one backtracking episode
    (n_trials > 1) and at least one plateau boost both occur and match the
    reference loop decision-for-decision."""
    import dataclasses

    import jax
    from jax.sharding import Mesh

    from vch_tpu.config import ForwardSolverConfig2D, OptimizationConfig
    from vch_tpu.control.problems import ControlProblem2D
    from vch_tpu.parallel.spatial import GridShardedProblem2D

    cfg = ForwardSolverConfig2D(Nx=31, Ny=31, T=0.05, dt_initial=1e-2)
    # alpha_max far above the accept range forces a backtracking episode;
    # a tight plateau window (2 iters at 1e-2) forces plateau boosts within
    # the 6-iteration budget. Identical settings on both loops.
    opt = dataclasses.replace(OptimizationConfig.defaults_2d(),
                              alpha_max=400.0)
    tweak = dict(plateau_length=2, plateau_tolerance=1e-2)

    ref = ControlProblem2D(cfg, opt_config=opt)
    ref.loop.s = dataclasses.replace(ref.loop.s, **tweak)
    res_ref = ref.optimize(max_iter=6, verbose=False)
    assert max(res_ref.ls_trials_per_iter) > 1     # backtracking happened
    assert res_ref.plateau_boosts >= 1             # plateau boost happened

    mesh = Mesh(np.array(jax.devices()[:8]), ("gx",))
    prob = GridShardedProblem2D(cfg, opt_config=opt, mesh=mesh)
    prob.loop.s = dataclasses.replace(prob.loop.s, **tweak)
    res = prob.optimize(max_iter=6, verbose=False)
    assert prob.newton_solves > 0
    assert res.ls_trials_per_iter == res_ref.ls_trials_per_iter
    assert res.plateau_boosts == res_ref.plateau_boosts
    np.testing.assert_allclose(np.asarray(res.cost_history),
                               np.asarray(res_ref.cost_history), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res.u_optimal),
                               np.asarray(res_ref.u_optimal), atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.alpha_history),
                               np.asarray(res_ref.alpha_history), rtol=1e-8)
