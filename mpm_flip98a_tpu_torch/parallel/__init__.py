"""Multi-device execution (counterpart of `mpm_flip98a_tpu/parallel/`).

The grid's row axis is cut into n slabs, one shard each (and in 3D,
`--devices N0xN1`, axis 1 into n1 pencil columns as well).  The fast
path's shards live on one device as a leading tensor dimension
(`mesh.SlabMesh`), with the JAX package's `ppermute` / `psum` semantics as
tensor shifts and reductions along it; `fast_domain` (2D) and
`fast_domain3d` (3D, one axis or two) reach the collectives only through
the mesh.  The general path's two strategies run one shard per process,
as `shard_map` runs one per chip: `domain` (slabs with halo exchange and
particle migration) and `replicated` (particles split, the grid merged by
psum) on `mesh.RankMesh`, whose ranks `launch.run_ranks` starts.
"""

from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh, SlabMesh
