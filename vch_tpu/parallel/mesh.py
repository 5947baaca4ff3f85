"""Device mesh construction and batch-axis sharding helpers.

Design (SURVEY.md section 7): a 1D mesh over the scenario batch; arrays with
a leading batch axis are placed with NamedSharding(P("scenarios")), so every
elementwise/matmul op in the solvers runs embarrassingly parallel per
device and scalar reductions (cost sums, convergence tests) become
all-reduces, which XLA hands to NCCL between the cards (NVLink within a
host). For several processes, `initialize_distributed` + the same mesh spans
them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "scenarios"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh over the scenario-batch axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(BATCH_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays whose LEADING axis is the scenario batch."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join a multi-process run; returns whether it did.

    One process drives all of a host's cards, so a single process
    (num_processes None or 1) needs no bring-up and this returns False.
    Otherwise it wraps `jax.distributed.initialize` with an explicit
    coordinator ("host:port"), process count and rank: nothing on a plain
    GPU host tells JAX of a cluster. Afterwards `make_mesh()` over
    `jax.devices()` spans every process, and the scenario axis's
    collectives run over NCCL across cards and hosts. Errors propagate.
    """
    if not num_processes or num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def shard_batch(tree, mesh: Mesh):
    """Place every array in `tree` with its leading axis sharded over the mesh."""
    sh = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)
