"""Slab-sharded execution of the fast path (counterpart of `mpm_flip98a_tpu/parallel/`).

The grid's row axis is cut into n slabs, one shard each (and in 3D,
`--devices N0xN1`, axis 1 into n1 pencil columns as well).  Here the
shards live on one device as a leading tensor dimension
(`mesh.SlabMesh`), with the JAX package's `ppermute` / `psum` semantics as
tensor shifts and reductions along it; `fast_domain` (2D) and
`fast_domain3d` (3D, one axis or two) reach the collectives only through
the mesh.
"""

from mpm_flip98a_tpu_torch.parallel.mesh import SlabMesh
