"""Scenario batching (vmap) and device-mesh sharding (NamedSharding/psum).

New capability relative to the reference, which is strictly single-process
single-thread NumPy (SURVEY.md section 2.3): the unit of work here is a
BATCH of control scenarios (initial conditions, targets, cost weights)
vmapped on the device and sharded across a `jax.sharding.Mesh` over the
"scenarios" axis. Cost/residual reductions ride XLA collectives (NCCL
between cards).
"""
from vch_tpu.parallel.mesh import make_mesh, shard_batch, batch_sharding
from vch_tpu.parallel.batch import (BatchedProblem1D, BatchedProblem2D,
                                    LowMemBatchedProblem2D,
                                    make_batched_problem_2d)
from vch_tpu.parallel.spatial import (GridShardedAdjoint2D,
                                      GridShardedBatchedProblem2D,
                                      GridShardedForward2D,
                                      GridShardedProblem2D)

__all__ = ["make_mesh", "shard_batch", "batch_sharding",
           "BatchedProblem1D", "BatchedProblem2D",
           "LowMemBatchedProblem2D", "make_batched_problem_2d",
           "GridShardedForward2D", "GridShardedAdjoint2D",
           "GridShardedProblem2D", "GridShardedBatchedProblem2D"]
