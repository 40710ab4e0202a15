"""Placement over devices and processes (counterpart of
``pilosa_tpu/parallel``): ``mesh`` (the serving mesh, ``init_multihost``),
``sharded`` (stacks cut over a mesh, ``ShardedField``) and ``meshplace``
(which cluster nodes' holders live in this process)."""

from pilosa_tpu_torch.parallel.mesh import default_mesh, mesh_shape_for
from pilosa_tpu_torch.parallel.sharded import ShardedField

__all__ = ["default_mesh", "mesh_shape_for", "ShardedField"]
