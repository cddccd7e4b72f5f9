"""Slab shards on one device (counterpart of `mpm_flip98a_tpu/parallel/mesh.py`).

The JAX package runs one shard per chip on a 1D `jax.sharding.Mesh`
(`make_mesh`) or a two-axis (n0 x n1) one (`make_mesh2`, mesh.py:26-37:
slabs x pencil columns, the 3D mesh of `--devices N0xN1`), and moves halo
rows and migrating particles with `ppermute` over the neighbour
permutations of `parallel/domain.py:120-125` along one mesh axis.
`SlabMesh(n0, device, n1=1)` keeps all n0 n1 shards on one device, each
tensor's leading dimension being the shard in shard-major order (shard
s = s0 n1 + s1), and gives the same collectives as tensor operations
along it:

- `shift_left(x, axis)`:  shard s receives the block of its neighbour one
  up along mesh axis `axis` (`ppermute` with `_perm_left`, i -> i - 1);
  the shards at that axis's last index receive zeros;
- `shift_right(x, axis)`: shard s receives the block of its neighbour one
  down along `axis` (`_perm_right`, i -> i + 1); the shards at index 0
  receive zeros;
- `psum` reduces over every shard, and `any` is its `psum > 0` of 0/1
  flags.

n1 = 1 is the one-axis slab mesh.  The sharded solvers (`fast_domain`,
`fast_domain3d`) reach the shards only through these methods, so a mesh
of one rank per card over `torch.distributed` can take its place without
touching them (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """n0 x n1 shards on one device; tensors carry the shard as dim 0, in
    shard-major (s0, s1) order."""

    n0: int
    device: torch.device = torch.device("cuda")
    n1: int = 1

    def __post_init__(self):
        if self.n0 < 1 or self.n1 < 1:
            raise ValueError(
                f"a mesh needs at least one shard on each axis, got {self.n0}x{self.n1}")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def n(self) -> int:
        """Shards in all, the size of dim 0."""
        return self.n0 * self.n1

    def shard_index(self, axis: int = 0) -> torch.Tensor:
        """(n,) int64: each shard's index along mesh axis `axis` (its
        `axis_index`)."""
        s = torch.arange(self.n, device=self.device)
        return s // self.n1 if axis == 0 else s % self.n1

    def _shift(self, x: torch.Tensor, by: int, axis: int) -> torch.Tensor:
        if x.shape[0] != self.n:
            raise ValueError(f"expected {self.n} shards on dim 0, got shape {tuple(x.shape)}")
        grid = x.reshape(self.n0, self.n1, *x.shape[1:])
        out = torch.zeros_like(grid)
        src = grid.narrow(axis, 0, grid.shape[axis] - 1)
        top = grid.narrow(axis, 1, grid.shape[axis] - 1)
        if by > 0:      # index i receives index i - 1's block
            out.narrow(axis, 1, grid.shape[axis] - 1).copy_(src)
        else:           # index i receives index i + 1's block
            out.narrow(axis, 0, grid.shape[axis] - 1).copy_(top)
        return out.view(x.shape)

    def shift_left(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """`ppermute` with `_perm_left` along `axis`: each shard sends to its
        left neighbour, so index i holds i + 1's block; zeros at the last."""
        return self._shift(x, -1, axis)

    def shift_right(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """`ppermute` with `_perm_right` along `axis`: index i holds i - 1's
        block; zeros at index 0."""
        return self._shift(x, 1, axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """True where any shard's flag is set: the reference's psum > 0 of
        the 0/1 flags (fast_domain.py:220-222)."""
        return self.psum(x.to(torch.int32)) > 0
