"""Slab meshes: shards on one device, or one shard per rank (counterpart of `mpm_flip98a_tpu/parallel/mesh.py`).

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
  flags; a bfloat16 psum sums in float32 in shard order and rounds once,
  as XLA's does (`bf16_sum`).

n1 = 1 is the one-axis slab mesh.  The sharded fast paths (`fast_domain`,
`fast_domain3d`) reach the shards only through these methods.

`RankMesh(device, backend, grid=None)` is the mesh of the JAX package's
`shard_map` proper: one shard per rank of the default `torch.distributed`
process group (`parallel/launch.run_ranks` starts the ranks), each rank
holding its own block and running the whole substep on it, as a chip runs
its shard in `shard_map`.  `grid=(n0, n1)` lays the ranks out on two axes
in SlabMesh's shard-major order (rank r sits at (r // n1, r % n1)); the
default is one axis of all the ranks.  It gives the same collectives on
the rank's block: `shift_left` / `shift_right` are point-to-point sends to
the one or two neighbours along the axis (`batch_isend_irecv` on that
axis's process group), so the bytes stay O(halo); `psum`, `pmax` and
`any` are `all_reduce`s over every rank, but for a bfloat16 `psum`: an
`all_gather` summed by `bf16_sum`, in rank order.  The general path's
`parallel/domain.py` and `parallel/replicated.py` and the fast paths'
`fast_domain`, `fast_domain3d` and `fast_replicated` run on it.

Both meshes say how many shard blocks this process holds on dim 0
(`blocks`: n for SlabMesh, 1 for RankMesh) and which shards they are
(`shard_index(axis)`: an (n,) arange's coordinates, or this rank's
coordinate as a (1,) tensor); `n`, `n0` and `n1` are the global counts.
`SlabMesh.psum` reduces dim 0, the shards, while `RankMesh.psum` keeps the
shape: callers reduce their block's own dims first, or use `any` / `pmax`
only where either shape will do.

The backend is the caller's choice and the mesh never changes it: `nccl`
for ranks that each hold their own card (it refuses ranks that share
one), `gloo` on the CPU and for several ranks on one card, where the mesh
stages every exchanged tensor through host memory itself.  The compute
stays on `device` whichever backend moves the blocks.  Each rank counts
its collectives' calls, bytes sent and seconds in `traffic`, by tag.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist


def bf16_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts (n, ...) bfloat16 summed over dim 0 as XLA's `psum` sums
    bfloat16 blocks: each widened to float32, added in index order 0..n-1,
    the total rounded to bfloat16 once."""
    total = parts[0].float()
    for part in parts[1:]:
        total = total + part.float()
    return total.to(torch.bfloat16)


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

    # Every shard lives in this process: no collective crosses processes.
    distributed = False

    @property
    def n(self) -> int:
        """Shards in all, the size of dim 0."""
        return self.n0 * self.n1

    @property
    def blocks(self) -> int:
        """The shard blocks this process holds on dim 0: all of them."""
        return self.n

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

    def shift_left(self, x: torch.Tensor, axis: int = 0, tag: str = "shift") -> torch.Tensor:
        """`ppermute` with `_perm_left` along `axis`: each shard sends to its
        left neighbour, so index i holds i + 1's block; zeros at the last.
        `tag` names the traffic on a RankMesh; here nothing is counted."""
        return self._shift(x, -1, axis)

    def shift_right(self, x: torch.Tensor, axis: int = 0, tag: str = "shift") -> torch.Tensor:
        """`ppermute` with `_perm_right` along `axis`: index i holds i - 1's
        block; zeros at index 0."""
        return self._shift(x, 1, axis)

    def psum(self, x: torch.Tensor, tag: str = "psum") -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return bf16_sum(x)
        return x.sum(dim=0)

    def any(self, x: torch.Tensor, tag: str = "any") -> torch.Tensor:
        """True where any shard's flag is set: the reference's psum > 0 of
        the 0/1 flags (fast_domain.py:220-222)."""
        return self.psum(x.to(torch.int32)) > 0

    def pmax(self, x: torch.Tensor, tag: str = "pmax") -> torch.Tensor:
        return x.amax(dim=0)


@dataclasses.dataclass
class Traffic:
    """A rank's collectives of one tag: calls, bytes this rank sent, and
    host seconds from the start of the transfer to the result on the
    rank's device (with gloo staging that includes the copies through host
    memory and the wait for the neighbours; with nccl only the launch)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


def shared_cards(cards) -> list:
    """The ranks whose card key (host and card UUID) another rank holds
    too, in rank order."""
    return [r for r, c in enumerate(cards) if cards.count(c) > 1]


class RankMesh:
    """One slab shard per rank of the default process group; every tensor
    is this rank's block (`blocks` = 1).  `rank` is the shard's index in
    shard-major order, `coords` its (s0, s1), `n` the shard count."""

    distributed = True
    blocks = 1

    def __init__(self, device="cuda", backend: str = "nccl", grid=None):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs an initialised process group "
                               "(parallel/launch.run_ranks starts one per rank)")
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                             f"the mesh was asked for {backend!r}")
        self.device = torch.device(device)
        self.backend = backend
        self.rank = dist.get_rank()
        self.n = dist.get_world_size()
        self.n0, self.n1 = (self.n, 1) if grid is None else (int(grid[0]), int(grid[1]))
        if self.n0 < 1 or self.n1 < 1 or self.n0 * self.n1 != self.n:
            raise ValueError(f"a {self.n0}x{self.n1} rank grid needs {self.n0 * self.n1} "
                             f"ranks, the process group has {self.n}")
        self.coords = (self.rank // self.n1, self.rank % self.n1)
        self._one_axis = grid is None
        self.traffic: Dict[str, Traffic] = {}
        if backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("nccl moves CUDA tensors only: pass backend='gloo' on the CPU")
            cards = [None] * self.n
            key = f"{socket.gethostname()}:{torch.cuda.get_device_properties(self.device).uuid}"
            dist.all_gather_object(cards, key, group=dist.new_group(backend="gloo"))
            shared = shared_cards(cards)
            if shared:
                raise ValueError(
                    f"ranks {shared} share one card, and nccl needs a card per rank: "
                    "pass backend='gloo' to run several ranks on one card")
        # One process group per line of ranks along each axis (the world
        # when one axis holds every rank).  new_group is collective over the
        # world: every rank creates every line's group, in the same order.
        self._groups = {}
        for axis in (0, 1):
            for line in self._lines(axis):
                if len(line) == 1:
                    continue
                group = None if len(line) == self.n else dist.new_group(line)
                if self.rank in line:
                    self._groups[axis] = group
        # gloo moves host tensors: CUDA blocks go through host memory.
        self._host = backend == "gloo" and self.device.type == "cuda"

    def _lines(self, axis: int) -> list:
        """The ranks of each line along `axis`, in coordinate order."""
        if axis == 0:
            return [[s0 * self.n1 + s1 for s0 in range(self.n0)] for s1 in range(self.n1)]
        return [[s0 * self.n1 + s1 for s1 in range(self.n1)] for s0 in range(self.n0)]

    def shard_index(self, axis: int = 0) -> torch.Tensor:
        """(1,) int64: this rank's coordinate along mesh axis `axis`."""
        return torch.tensor([self.coords[axis]], device=self.device)

    def _outgoing(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of x where the backend reads it."""
        if self._host:
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().contiguous().clone()

    def _timed(self, tag: str, nbytes: int, call):
        if self._host:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = call()
        rec = self.traffic.setdefault(tag, Traffic())
        rec.calls += 1
        rec.bytes += nbytes
        rec.seconds += time.perf_counter() - t0
        return out

    def _peer(self, axis: int, step: int):
        """The global rank `step` along `axis` from this one; None past the
        axis's ends."""
        c = self.coords[axis] + step
        if not 0 <= c < (self.n0, self.n1)[axis]:
            return None
        return self.rank + step * (self.n1 if axis == 0 else 1)

    def _shift(self, x: torch.Tensor, down: bool, rows: Optional[int], tag: str, axis: int):
        if axis not in (0, 1) or (axis == 1 and self._one_axis):
            raise ValueError(f"axis {axis} of a {self.n0}x{self.n1} rank grid: a RankMesh has "
                             "one axis unless it is built with grid=(n0, n1)")
        dst = self._peer(axis, -1 if down else 1)
        src = self._peer(axis, 1 if down else -1)
        group = self._groups.get(axis)

        def call():
            send = self._outgoing(x)
            shape = tuple(x.shape) if rows is None else (rows,) + tuple(x.shape[1:])
            recv = torch.zeros(shape, dtype=x.dtype, device=send.device)
            ops = []
            # The peers are global ranks, on the axis's group too.
            if dst is not None and send.numel():
                ops.append(dist.P2POp(dist.isend, send, dst, group=group))
            if src is not None and recv.numel():
                ops.append(dist.P2POp(dist.irecv, recv, src, group=group))
            for work in dist.batch_isend_irecv(ops) if ops else ():
                work.wait()
            return recv.to(self.device)

        return self._timed(tag, x.numel() * x.element_size() if dst is not None else 0, call)

    def shift_left(self, x: torch.Tensor, axis: int = 0, rows: Optional[int] = None,
                   tag: str = "shift") -> torch.Tensor:
        """`ppermute` with `_perm_left` along `axis`: the rank at index i
        receives index i + 1's block, the last index zeros.  With `rows`,
        the received block has that many leading rows (the sender's own
        count; 0 sends nothing)."""
        return self._shift(x, True, rows, tag, axis)

    def shift_right(self, x: torch.Tensor, axis: int = 0, rows: Optional[int] = None,
                    tag: str = "shift") -> torch.Tensor:
        """`ppermute` with `_perm_right` along `axis`: index i receives
        index i - 1's block, index 0 zeros; `rows` as in `shift_left`."""
        return self._shift(x, False, rows, tag, axis)

    def _all_reduce(self, x: torch.Tensor, op, tag: str) -> torch.Tensor:
        def call():
            buf = self._outgoing(x.reshape(-1))
            dist.all_reduce(buf, op=op)
            return buf.to(self.device).reshape(x.shape)

        return self._timed(tag, x.numel() * x.element_size(), call)

    def psum(self, x: torch.Tensor, tag: str = "psum") -> torch.Tensor:
        """The sum of every rank's x (every rank gets the same bits).  A
        bfloat16 x is gathered and summed by `bf16_sum` (gloo's all_reduce
        would round after every add, in its ring's order)."""
        if x.dtype == torch.bfloat16:
            return bf16_sum(self.all_gather(x, tag))
        return self._all_reduce(x, dist.ReduceOp.SUM, tag)

    def pmax(self, x: torch.Tensor, tag: str = "pmax") -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX, tag)

    def any(self, x: torch.Tensor, tag: str = "any") -> torch.Tensor:
        """True where any rank's flag is set (psum > 0 of the 0/1 flags)."""
        return self.psum(x.to(torch.int32), tag) > 0

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it."""
        dist.barrier()

    def all_gather(self, x: torch.Tensor, tag: str = "all_gather") -> torch.Tensor:
        """(n,) + x.shape: every rank's block, in rank order."""
        def call():
            send = self._outgoing(x)
            out = [torch.empty_like(send) for _ in range(self.n)]
            dist.all_gather(out, send)
            return torch.stack(out).to(self.device)

        return self._timed(tag, x.numel() * x.element_size(), call)
