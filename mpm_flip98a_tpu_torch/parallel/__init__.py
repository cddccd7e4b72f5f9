"""Multi-device execution (counterpart of `mpm_flip98a_tpu/parallel/`).

The grid's row axis is cut into n slabs, one shard each (and in 3D,
`--devices N0xN1`, axis 1 into n1 pencil columns as well).  The fast
path's shards live either on one device as a leading tensor dimension
(`mesh.SlabMesh`), with the JAX package's `ppermute` / `psum` semantics as
tensor shifts and reductions along it, or one per process (`--ranks`,
`mesh.RankMesh`, one or two axes), as `shard_map` runs one per chip;
`fast_domain` (2D) and `fast_domain3d` (3D, one axis or two) reach the
collectives only through the mesh.  On `RankMesh` run as well the general
path's `domain` (slabs with halo exchange and particle migration) and
`replicated` (particles split, the grid merged by psum), and the fast
path's `fast_replicated` (particle shares, the folded grid merged by
psum); `launch.run_ranks` starts the ranks.
"""

from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh, SlabMesh
