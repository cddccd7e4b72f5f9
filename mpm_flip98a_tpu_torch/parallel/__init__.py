"""Slab-sharded execution of the fast path (counterpart of `mpm_flip98a_tpu/parallel/`).

The grid's row axis is cut into n slabs, one shard each.  Here the n
shards live on one device as a leading tensor dimension (`mesh.SlabMesh`),
with the JAX package's `ppermute` / `psum` semantics as tensor shifts and
reductions along it; `fast_domain` (2D) and `fast_domain3d` (3D, one axis)
reach the collectives only through the mesh.
"""

from mpm_flip98a_tpu_torch.parallel.mesh import SlabMesh
