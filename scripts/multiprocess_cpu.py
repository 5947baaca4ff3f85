"""Multi-PROCESS distributed batched PGD on CPU.

Two `jax.distributed` processes on this host (Gloo collectives, coordinator
on localhost), each owning 2 virtual CPU devices -> a 4-device global
"scenarios" mesh that crosses a process boundary. This exercises the one
code path a single-process virtual mesh never touches:

  - `parallel/mesh.initialize_distributed` (real bring-up, not dead code),
  - global scenario arrays built from PROCESS-LOCAL shards
    (`jax.make_array_from_callback` — each process materializes only its
    addressable blocks, the pattern a real pod requires),
  - `_BatchedPGDBase.run`'s host-driven search over NON-fully-addressable
    device outputs (`_host_read` allgathers the (B,) cost/predicate
    arrays so every process drives the identical trial schedule),
  - XLA-inserted cross-process collectives for the vmapped while_loop
    convergence reductions.

The parent runs the identical problem single-process twice — once on the
SAME 4-device virtual mesh (identical sharded program: the multi-process
run must match it to roundoff; measured 0.0) and once as the plain
unsharded vmap (differs only by partitioned-reduction ordering, ~6.5e-10
f64 after 3 chaotic PGD iterations).

    python scripts/multiprocess_cpu.py            # parent: runs everything
    python scripts/multiprocess_cpu.py --rank N   # internal (spawned)

Prints the comparison as JSON. Reference anchor: the
reference is single-process NumPy (SURVEY.md section 2.3); this is the
BASELINE.md >= 2-host north-star path exercised at CPU scale.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

COORD = "127.0.0.1:19732"
N_PROC = 2
DEV_PER_PROC = 2
B = 4
MAX_ITER = 3
RESULT = "/tmp/vch_mp_rank0.json"


def _build_problem_and_scenarios():
    from vch_tpu.config import ForwardSolverConfig1D, OptimizationConfig
    from vch_tpu.parallel.batch import sweep_1d
    cfg = ForwardSolverConfig1D()          # N=128, T=1, f64 parity config
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=np.linspace(1e-3, 3e-3, B),
                  kappa_values=[9e-5])
    assert sc.batch == B, sc.batch
    return cfg, sc


def run_rank(rank: int):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from vch_tpu.parallel.mesh import initialize_distributed, make_mesh
    ok = initialize_distributed(coordinator_address=COORD,
                                num_processes=N_PROC, process_id=rank)
    assert ok and jax.process_count() == N_PROC, (ok, jax.process_count())
    assert jax.device_count() == N_PROC * DEV_PER_PROC

    import dataclasses
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vch_tpu.parallel.batch import BatchedProblem1D
    from vch_tpu.parallel.mesh import BATCH_AXIS

    cfg, sc = _build_problem_and_scenarios()
    mesh = make_mesh()
    print(f"[rank {rank}] mesh {mesh.shape} over "
          f"{jax.process_count()} processes", flush=True)

    # Global scenario arrays from PROCESS-LOCAL shards: the callback only
    # ever receives this process's addressable index blocks, so each
    # process materializes B/N_PROC members' data — the
    # make_array_from_single_device_arrays-style path of a real pod.
    def global_from_local(host_array):
        a = np.asarray(host_array, np.float64)
        sh = NamedSharding(mesh, P(BATCH_AXIS,
                                   *([None] * (a.ndim - 1))))
        touched = []

        def cb(idx):
            touched.append(idx)
            return a[idx]

        arr = jax.make_array_from_callback(a.shape, sh, cb)
        # every touched block must be process-local
        rows = {i for idx in touched
                for i in range(*idx[0].indices(a.shape[0]))}
        expect = set(range(rank * (B // N_PROC),
                           (rank + 1) * (B // N_PROC)))
        assert rows == expect, (rows, expect)
        return arr

    sc = dataclasses.replace(
        sc, phi0=global_from_local(sc.phi0),
        phi_T=global_from_local(sc.phi_T),
        phi_Q=global_from_local(sc.phi_Q),
        b1=global_from_local(sc.b1), b2=global_from_local(sc.b2),
        b3=global_from_local(sc.b3),
        kappa_spar=global_from_local(sc.kappa_spar))

    prob = BatchedProblem1D(cfg, mesh=mesh)
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=MAX_ITER, verbose=(rank == 0),
                   host_results=False)
    el = time.perf_counter() - t0
    cost_hist = np.asarray(out["cost_history"])   # host already (allgathered)
    print(f"[rank {rank}] costs {cost_hist[-1].round(6)} in {el:.1f}s",
          flush=True)
    if rank == 0:
        json.dump({"cost_history": cost_hist.tolist(),
                   "newton_solves": int(out["newton_solves"]),
                   "elapsed_s": el,
                   "devices": jax.device_count(),
                   "processes": jax.process_count()},
                  open(RESULT, "w"))
    jax.distributed.shutdown()


def run_single():
    """Single-process references: (a) the SAME 4-device mesh on virtual
    CPU devices — identical sharded program, so the multi-process layer
    must match it to roundoff; (b) the plain unsharded vmap — differs
    only by partitioned-reduction ordering (f64 ~1e-10 on this chaotic
    trajectory)."""
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_PROC * DEV_PER_PROC}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from vch_tpu.parallel.batch import BatchedProblem1D
    from vch_tpu.parallel.mesh import make_mesh
    cfg, sc = _build_problem_and_scenarios()
    out_mesh = BatchedProblem1D(cfg, mesh=make_mesh()).run(
        sc, max_iter=MAX_ITER, verbose=False)
    out_plain = BatchedProblem1D(cfg).run(sc, max_iter=MAX_ITER,
                                          verbose=False)
    return (np.asarray(out_mesh["cost_history"]),
            int(out_mesh["newton_solves"]),
            np.asarray(out_plain["cost_history"]))


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--rank":
        run_rank(int(sys.argv[2]))
        return

    print("--- single-process references ---", flush=True)
    ref_costs, ref_solves, plain_costs = run_single()
    print(f"[single] costs {ref_costs[-1].round(6)}", flush=True)

    print("--- spawning 2 jax.distributed processes ---", flush=True)
    if os.path.exists(RESULT):
        os.remove(RESULT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r)])
             for r in range(N_PROC)]
    rcs = [p.wait(timeout=900) for p in procs]
    assert all(rc == 0 for rc in rcs), rcs
    mp = json.load(open(RESULT))
    mp_costs = np.asarray(mp["cost_history"])

    # primary gate: same mesh/program single-process vs multi-process —
    # only the process boundary differs, so roundoff-tight
    rel = np.abs(mp_costs - ref_costs) / np.abs(ref_costs)
    # secondary: vs the UNSHARDED vmap run — partitioned reductions sum in
    # a different order (f64 ~1e-10 after 3 chaotic PGD iterations)
    rel_plain = np.abs(mp_costs - plain_costs) / np.abs(plain_costs)
    print(f"max cost rel diff: vs single-process SAME mesh "
          f"{rel.max():.3e}, vs unsharded vmap {rel_plain.max():.3e}",
          flush=True)
    assert rel.max() < 1e-12, rel.max()
    assert rel_plain.max() < 1e-8, rel_plain.max()
    assert mp["newton_solves"] == ref_solves, (mp["newton_solves"],
                                               ref_solves)

    entry = {
        "processes": N_PROC, "devices_per_process": DEV_PER_PROC,
        "batch": B, "pgd_iters": MAX_ITER, "problem": "1D N=128 f64",
        "max_cost_rel_diff_vs_single_process_same_mesh": float(rel.max()),
        "max_cost_rel_diff_vs_unsharded_vmap": float(rel_plain.max()),
        "newton_solves_match": True,
        "elapsed_s_multiprocess": round(mp["elapsed_s"], 1),
        "note": "2 jax.distributed CPU processes (Gloo), global scenario "
                "batch built from process-local shards via "
                "make_array_from_callback; host-driven search reads "
                "allgathered via _host_read. "
                + time.strftime("%Y-%m-%d"),
    }
    print(json.dumps(entry, indent=1))


if __name__ == "__main__":
    main()
