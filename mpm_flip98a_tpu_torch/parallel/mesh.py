"""Slab shards on one device (counterpart of `mpm_flip98a_tpu/parallel/mesh.py`).

The JAX package runs one shard per chip on a 1D `jax.sharding.Mesh` and
moves halo rows and migrating particles with `ppermute` over the
neighbour permutations of `parallel/domain.py:120-125`.  `SlabMesh(n,
device)` keeps all n shards on one device, each tensor's leading
dimension being the shard, and gives the same collectives as tensor
operations along it:

- `shift_left(x)`:  shard s receives shard s + 1's block (`ppermute` with
  `_perm_left`, i -> i - 1); the last shard receives zeros;
- `shift_right(x)`: shard s receives shard s - 1's block (`_perm_right`,
  i -> i + 1); shard 0 receives zeros;
- `psum` reduces over the shards, and `any` is its `psum > 0` of 0/1 flags.

The sharded solvers (`fast_domain`, `fast_domain3d`) reach the shards only
through these methods, so a mesh of one rank per card over
`torch.distributed` can take its place without touching them (ROADMAP
queue 1, item 7).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """n slab shards on one device; tensors carry the shard as dim 0."""

    n: int
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {self.n}")
        object.__setattr__(self, "device", torch.device(self.device))

    def shard_index(self) -> torch.Tensor:
        """(n,) int64 shard ids, the `axis_index` of each shard."""
        return torch.arange(self.n, device=self.device)

    def _shift(self, x: torch.Tensor, by: int) -> torch.Tensor:
        if x.shape[0] != self.n:
            raise ValueError(f"expected {self.n} shards on dim 0, got shape {tuple(x.shape)}")
        out = torch.zeros_like(x)
        if by > 0:      # shard s receives shard s - 1's block
            out[1:] = x[:-1]
        else:           # shard s receives shard s + 1's block
            out[:-1] = x[1:]
        return out

    def shift_left(self, x: torch.Tensor) -> torch.Tensor:
        """`ppermute` with `_perm_left`: each shard sends to its left
        neighbour, so shard s holds s + 1's block; zeros at the last."""
        return self._shift(x, -1)

    def shift_right(self, x: torch.Tensor) -> torch.Tensor:
        """`ppermute` with `_perm_right`: shard s holds s - 1's block;
        zeros at shard 0."""
        return self._shift(x, 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """True where any shard's flag is set: the reference's psum > 0 of
        the 0/1 flags (fast_domain.py:220-222)."""
        return self.psum(x.to(torch.int32)) > 0
