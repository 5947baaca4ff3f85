"""The vmapped scan path: the batched forward march, its sanitizer and
schedule handling, float32 against float64, and mesh placement rules.

The batched problems run every member through `jax.vmap` of the same
`lax.scan` solvers the single-scenario tests cover; these tests pin what
the batch adds on top.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vch_tpu.config import (DELTA_SEP, ForwardSolverConfig1D,
                            ForwardSolverConfig2D, OptimizationConfig)
from vch_tpu.models.forward1d import ForwardSolver1D
from vch_tpu.models.forward2d import ForwardSolver2D
from vch_tpu.ops.potential import init_phi_random_1d, init_phi_random_2d
from vch_tpu.parallel.batch import (BatchedProblem1D, BatchedProblem2D,
                                    LowMemBatchedProblem2D, sweep_1d,
                                    sweep_2d)
from vch_tpu.parallel.mesh import make_mesh


def _solver(dim, dtype="float64", **kw):
    if dim == "1d":
        kw.setdefault("T", 0.06)
        cfg = ForwardSolverConfig1D(N=32, dtype=dtype, **kw)
        return ForwardSolver1D(cfg)
    kw.setdefault("T", 0.06)
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, dtype=dtype, **kw)
    return ForwardSolver2D(cfg)


def _batch(solver, B=2, amp=0.1, useed=0):
    """B distinct initial states and random controls, core layout."""
    rng = np.random.default_rng(useed)
    cfg = solver.config
    if isinstance(solver, ForwardSolver1D):
        phi0 = np.stack([init_phi_random_1d(cfg.N, DELTA_SEP, amp=0.01,
                                            seed=42 + i) for i in range(B)])
    else:
        phi0 = np.stack([init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP,
                                            amp=amp, seed=42 + i)
                         for i in range(B)])
    u = 0.1 * rng.standard_normal((B, solver.M + 1) + phi0.shape[1:])
    return jnp.asarray(phi0, solver.dtype), jnp.asarray(u, solver.dtype)


def _mass(solver, phi):
    wts = np.asarray(solver._wts_h)
    axes = tuple(range(-wts.ndim, 0))
    return (wts * np.asarray(phi, np.float64)).sum(axis=axes)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("float64", 1e-12)])
def test_batched_march_zero_control_conserves_mass(dtype, tol):
    solver = _solver("2d", dtype, newton_tol=2e-4 if dtype == "float32"
                     else 1e-6)
    phi0, u = _batch(solver)
    phi, st = jax.vmap(solver._march_impl)(jnp.zeros_like(u), phi0)
    m = _mass(solver, phi)                           # (B, M+1)
    assert np.abs(m - m[:, :1]).max() < tol
    assert (np.asarray(st.first_bad_step) == -1).all()


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_batched_sanitizer_flags_only_the_poisoned_member(dim):
    """A non-finite state makes that member's mass defect non-finite at the
    first step (ref Forward_solver.py:166-172); its batch neighbour stays
    clean."""
    solver = _solver(dim, newton_max_iter=3)
    phi0, u = _batch(solver)
    idx = (1, 3) if dim == "1d" else (1, 3, 3)
    phi0 = phi0.at[idx].set(jnp.nan)
    _, st = jax.vmap(solver._march_impl)(u, phi0)
    assert np.asarray(st.first_bad_step).tolist() == [-1, 0]


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_batched_march_nonuniform_final_dt(dim):
    """T=0.05 with dt=0.02 gives the schedule [0.02, 0.02, 0.01]: the
    vmapped march reproduces each member's own single-scenario march."""
    solver = _solver(dim, T=0.05, dt_initial=0.02)
    assert np.allclose(solver.dts, [0.02, 0.02, 0.01])
    phi0, u = _batch(solver, B=3)
    phi_b, st_b = jax.vmap(solver._march_impl)(u, phi0)
    for i in range(3):
        phi_i, st_i = jax.jit(solver._march_impl)(u[i], phi0[i])
        np.testing.assert_allclose(np.asarray(phi_b[i]), np.asarray(phi_i),
                                   rtol=0, atol=1e-12)
        assert int(st_b.newton_solves[i]) == int(st_i.newton_solves)


@pytest.mark.parametrize("N", [16, 24])
def test_f32_fixed_trip_cost_level_matches_f64(N):
    """The float32 path (fixed-trip Krylov, relative Newton exit) stays at
    the float64 path's cost level through one PGD iteration."""
    costs = {}
    for dtype in ("float32", "float64"):
        cfg = ForwardSolverConfig2D(
            Nx=N, Ny=N, T=0.1, dtype=dtype,
            newton_tol=2e-4 if dtype == "float32" else 1e-6)
        sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[1e-4])
        out = BatchedProblem2D(cfg).run(sc, max_iter=1, verbose=False)
        costs[dtype] = out["cost_history"]
    rel = np.abs(costs["float32"] - costs["float64"]) / costs["float64"]
    assert rel.max() < 1e-4, rel.max()


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_mesh_with_indivisible_batch_runs_unsharded(dim):
    """B=3 does not divide the 8-device mesh: run() leaves the batch
    unsharded, so the mesh problem reproduces the no-mesh problem."""
    if dim == "1d":
        cfg = ForwardSolverConfig1D(N=32, T=0.1)
        mk = lambda: sweep_1d(cfg, OptimizationConfig(),
                              b3_values=[1e-3, 2e-3, 3e-3],
                              kappa_values=[1e-4])
        cls = BatchedProblem1D
    else:
        cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06)
        mk = lambda: sweep_2d(cfg, b3_values=[1e-4, 2e-4, 3e-4],
                              kappa_values=[1e-4])
        cls = BatchedProblem2D
    out_plain = cls(cfg).run(mk(), max_iter=2, verbose=False)
    out_mesh = cls(cfg, mesh=make_mesh()).run(mk(), max_iter=2,
                                              verbose=False)
    np.testing.assert_allclose(out_mesh["cost_history"],
                               out_plain["cost_history"], rtol=1e-12)
    np.testing.assert_allclose(out_mesh["u"], out_plain["u"], atol=1e-12)


@pytest.mark.parametrize("mode,choice_q", [("ramp", 1), ("zeros", 2)])
def test_lowmem_procedural_phi_Q_under_mesh(mode, choice_q):
    """Procedural tracking targets (phi_Q=None) with the batch sharded over
    the 8-device scenario mesh match the unsharded low-memory run."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.07, dt_initial=1e-2)
    mk = lambda: sweep_2d(cfg, b3_values=[1e-4, 2e-4, 3e-4, 4e-4],
                          kappa_values=[5e-5, 1e-4], choice_q=choice_q,
                          materialize_phi_Q=False)
    assert mk().phi_Q_mode == mode and mk().batch == 8
    out_plain = LowMemBatchedProblem2D(cfg, K=3).run(mk(), max_iter=2,
                                                     verbose=False)
    prob = LowMemBatchedProblem2D(cfg, K=3, mesh=make_mesh())
    out_mesh = prob.run(mk(), max_iter=2, verbose=False, host_results=False)
    assert len(out_mesh["u"].sharding.device_set) == 8
    np.testing.assert_allclose(out_mesh["cost_history"],
                               out_plain["cost_history"], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out_mesh["u"]), out_plain["u"],
                               atol=1e-12)
    assert out_mesh["newton_solves"] == out_plain["newton_solves"]
