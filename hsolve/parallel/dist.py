"""Multi-chip execution: shard the level-synchronous schedule over a device mesh.

The reference is strictly single-process (SURVEY.md section 2: no threading, no
Distributed, no MPI); this module shards the level-synchronous schedule over the
devices of one host (GPUs joined all to all, so the mesh follows the algorithm alone):

- **elimination-tree parallelism** (the solver analog of data/pipeline parallelism):
  same-level fronts are independent, so the batched level kernels shard their *node*
  axis across the ``tree`` mesh axis; the extend-add gathers between levels become XLA
  collectives,
- **intra-front parallelism** (the tensor-parallel analog): near the root the batch
  collapses to a handful of large fronts, whose rows shard across the ``front`` axis.

Implementation is idiomatic JAX SPMD: annotate shardings with ``NamedSharding`` /
``device_put`` and let XLA's partitioner insert the collectives (all-gather of child
Schur panels, reduce-scatter of the solve scatter-adds).  The planner pads each level's
batch to a multiple of the tree-axis size with identity dummy fronts so shapes divide
evenly.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, tree: Optional[int] = None,
              front: int = 1) -> Mesh:
    """Build a ('tree', 'front') mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if tree is None:
        tree = n_devices // front
    mesh_devs = np.asarray(devs[: tree * front]).reshape(tree, front)
    return Mesh(mesh_devs, axis_names=("tree", "front"))


def shard_batch_spec(mesh: Mesh, B: int, rank: int) -> NamedSharding:
    """Sharding for a [B, ...] level stack: shard the node axis over 'tree' when it
    divides evenly, otherwise replicate (top-of-tree batches are tiny)."""
    ntree = mesh.shape["tree"]
    if B % ntree == 0 and B >= ntree and ntree > 1:
        return NamedSharding(mesh, P("tree", *([None] * (rank - 1))))
    if rank >= 3 and mesh.shape["front"] > 1:
        # few large fronts: shard rows across 'front' (intra-front parallelism)
        return NamedSharding(mesh, P(None, "front", *([None] * (rank - 2))))
    return NamedSharding(mesh, P(*([None] * rank)))


def shard_level_input(mesh: Optional[Mesh], arr: jax.Array) -> jax.Array:
    if mesh is None:
        return arr
    return jax.device_put(arr, shard_batch_spec(mesh, arr.shape[0], arr.ndim))
