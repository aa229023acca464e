"""Timeline sharding over several ranks (sequence parallelism).

Port of termdaw_tpu/parallel/: the reference shards every render window's
block range over a `jax.sharding.Mesh` from one process; the port runs
one process per rank on `torch.distributed`, each with its own `State`
of the same project on its own device (see `mesh.py`). The cross-rank
data is tiny: per-block maxima for Normalize's causal prefix, the scan
summaries of the IIR filters and effects (ops/filters.exclusive_total),
per-residue-class summaries for the feedback lines and short input halos
for the delayed reads (ops/filters.prev_frames).
"""

from .mesh import (
    Mesh, all_gather, gather, launch, make_mesh, mesh_from_env, pmax,
    sharded_render,
)

__all__ = ["Mesh", "all_gather", "gather", "launch", "make_mesh",
           "mesh_from_env", "pmax", "sharded_render"]
