"""Slab- and block-sharded 3D fast path (counterpart of `mpm_flip98a_tpu/parallel/fast_domain3d.py`).

One axis (`--devices N`): the grid's axis 0 is cut into n0 slabs of L0
pencil-bucket rows.  Two axes (`--devices N0xN1`, slabs x pencil columns):
axis 1 is cut into n1 windows of L1 rows as well, and each shard owns an
(L0 x L1) window of pencils.  State is shard-major: shard s = s0 n1 + s1
holds the contiguous block of pencils s L0 L1 + l0 L1 + l1 (`distribute`
reorders the global (s0, l0, s1, l1) order, bit for bit as JAX does; with
n1 = 1 the two orders are one).  The kernels see the stacked windows as an
(n L0, L1) pencil layout (`FastDomain3DSpec.global_spec`) and sum each
shard's window on its own (`p2g3d_grid`'s raw mode, `shards` = n0 n1),
with positions shifted by the window's origin on both axes.

Per substep one halo exchange per sharded axis moves the 4 folded edge
planes (1 below, 3 above) between neighbouring shards: axis 0 first, whose
legs carry the axis-1 halo columns, so the axis-1 legs then complete the
corner sums of diagonal neighbours (fast_domain3d.py:123-165).  Particles
migrate only on collective rebucket events: the axis-0 leg, then the
axis-1 leg, so a corner-crossing particle reaches its diagonal neighbour
in the same rebucket.  Both branches of `fast3d.substep` run on the
shards' local windows (`domain=...`).  The collectives are the mesh's:
`SlabMesh` stacks every shard on one device, `RankMesh` (with grid=(n0,
n1) on two axes) gives each rank its own (L0 L1, K) block, so the kernels
see one window there (`FastDomain3DSpec.stacked(mesh.blocks)`), shifted by
that rank's origin.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from mpm_flip98a_tpu_torch.config import MPMConfig
from mpm_flip98a_tpu_torch.models import fast3d
from mpm_flip98a_tpu_torch.models.fast2d import RunStats, _f32
from mpm_flip98a_tpu_torch.models.fast3d import FastSpec3D, FluidBuckets3D, _field_list
from mpm_flip98a_tpu_torch.models.stabilized import PAD, Scene
from mpm_flip98a_tpu_torch.parallel.fast_domain import (
    H_HI, H_LO, FastDomainCtx, bucket_shards, exchange, gather_dim, own_block, stacked_fields,
    sync_dim, unstack_fields,
)


def as_shards(n_shards: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    """(n0, n1) of `n_shards`: an int is the one-axis (n, 1)."""
    if isinstance(n_shards, int):
        return (n_shards, 1)
    n0, n1 = n_shards
    return (int(n0), int(n1))


@dataclasses.dataclass(frozen=True)
class FastDomain3DSpec:
    """Static decomposition parameters (fast_domain3d.py:58-102)."""

    n_shards0: int
    n_shards1: int
    rows_per_shard0: int  # L0: axis-0 bucket rows per shard (n0 L0 >= G)
    rows_per_shard1: int  # L1: axis-1 bucket rows per shard (n1 L1 >= G)
    local_spec: FastSpec3D  # rows0 = L0, rows1 = L1
    mig_cap: int

    @property
    def n_shards(self) -> int:
        return self.n_shards0 * self.n_shards1

    @property
    def global_spec(self) -> FastSpec3D:
        """The stacked shard windows as the kernels see them: (n L0, L1)
        pencils in shard-major order; one axis: (n L0, G), the global
        layout itself."""
        return self.stacked(self.n_shards)

    def stacked(self, blocks: int) -> FastSpec3D:
        """`blocks` shard windows stacked on axis 0, (blocks L0, L1): what a
        process holds (`mesh.blocks`: every shard on SlabMesh, one on a
        rank)."""
        return dataclasses.replace(self.local_spec, rows0=blocks * self.rows_per_shard0)

    @property
    def bucket_spec(self) -> FastSpec3D:
        """The global (n0 L0, n1 L1) pencil grid before the shard-major
        reorder."""
        return FastSpec3D(rows0=self.n_shards0 * self.rows_per_shard0,
                          rows1=self.n_shards1 * self.rows_per_shard1,
                          capacity=self.local_spec.capacity)

    @staticmethod
    def for_particles(cfg: MPMConfig, n_shards, p, headroom: float = 2.0) -> "FastDomain3DSpec":
        """The JAX package's sizing (fast_domain3d.py:79-102): L = ceil(G /
        n) on each axis, capacity from the peak pencil occupancy, mig_cap =
        max(128, 2 K)."""
        n0, n1 = as_shards(n_shards)
        g = cfg.num_grids
        rows0, rows1 = -(-g // n0), -(-g // n1)
        if rows0 < 4 or rows1 < 4:
            raise ValueError(f"shard windows must be at least 4 rows for the halo exchange, "
                             f"got {rows0}x{rows1}")
        cap = fast3d.FastSpec3D.for_particles(cfg, p, headroom).capacity
        return FastDomain3DSpec(
            n_shards0=n0, n_shards1=n1, rows_per_shard0=rows0, rows_per_shard1=rows1,
            local_spec=FastSpec3D(rows0=rows0, rows1=rows1, capacity=cap),
            mig_cap=max(128, cap * 2),
        )


@dataclasses.dataclass(frozen=True)
class FastDomain3DCtx(FastDomainCtx):
    """Runtime context handed to fast3d.substep(domain=...): the halo
    exchange on (n, L0 + 4, L1 + 4, nch, G2) buffers, axis 0 on dim 1 and,
    with n1 > 1, axis 1 on dim 2 (`_sync_dim`, fast_domain3d.py:105-165);
    the windows' origins and global row indices."""

    rows1: int = 0          # L1 (one axis: G)

    def _pencil(self, device):
        """Each local pencil's shard indices on both axes, its block and its
        local rows."""
        l0, l1 = self.rows_per_shard, self.rows1
        pencil = torch.arange(self.blocks * l0 * l1, device=device)
        blk, loc = pencil // (l0 * l1), pencil % (l0 * l1)
        s0 = self.mesh.shard_index(0).to(device)[blk]
        s1 = self.mesh.shard_index(1).to(device)[blk]
        return s0, s1, blk, loc // l1, loc % l1

    def x0_shift(self, device, cfg: MPMConfig) -> torch.Tensor:
        """(blocks L0 L1, 1) float32 window origin on axis 0 in metres, s0
        L0 dx (fast3d.py:518-527)."""
        s0 = self._pencil(device)[0]
        return ((s0 * self.rows_per_shard).to(torch.float32) * _f32(cfg.dx))[:, None]

    def x1_shift(self, device, cfg: MPMConfig):
        """(blocks L0 L1, 1) float32 window origin on axis 1, s1 L1 dx
        (fast3d.py:531-544); None on the one-axis mesh."""
        if self.mesh.n1 == 1:
            return None
        s1 = self._pencil(device)[1]
        return ((s1 * self.rows1).to(torch.float32) * _f32(cfg.dx))[:, None]

    def row_index0(self, device) -> torch.Tensor:
        """(n, L0 + 4) global axis-0 row of each halo plane: s0 L0 - 1 + j."""
        l0 = self.rows_per_shard
        s0 = self.mesh.shard_index(0).to(device)[:, None]
        return s0 * l0 - 1 + torch.arange(l0 + H_LO + H_HI, device=device)[None, :]

    def row_index1(self, device) -> torch.Tensor:
        """(n, L1 + 4) global axis-1 row of each halo plane: s1 L1 - 1 + j."""
        l1 = self.rows1
        s1 = self.mesh.shard_index(1).to(device)[:, None]
        return s1 * l1 - 1 + torch.arange(l1 + H_LO + H_HI, device=device)[None, :]

    def pencil_offsets(self, device):
        """(row0, row1) to add to a pencil's row in the stacked (blocks L0,
        L1) layout for its global pencil rows (the reference's row0 / row1
        of `_needs_rebucket`, fast3d.py:937-950): 0 where every shard of a
        one-axis mesh is stacked (the layout is the global one), else
        (blocks L0 L1, 1) int tensors ((s0 - block) L0, s1 L1)."""
        if self.mesh.n1 == 1 and self.blocks == self.mesh.n:
            return 0, 0
        s0, s1, blk, _, _ = self._pencil(device)
        return ((s0 - blk) * self.rows_per_shard)[:, None], (s1 * self.rows1)[:, None]

    def own_rows(self, device) -> torch.Tensor:
        """The nodes each shard owns, [1, 1 + L) on each sharded axis: (n,
        L0 + 4) on one axis, (n, L0 + 4, L1 + 4) on two (fast3d.py:
        321-331); the CG's dot products count them alone."""
        own0 = super().own_rows(device)
        if self.mesh.n1 == 1:
            return own0
        j = torch.arange(self.rows1 + H_LO + H_HI, device=device)
        own1 = (j >= H_LO) & (j < H_LO + self.rows1)
        return own0[:, :, None] & own1[None, None, :]

    def halo_sync(self, buf: torch.Tensor) -> torch.Tensor:
        """Folded halo sums -> globally complete planes, in place: axis 0
        (dim 1), whose legs move whole planes with their axis-1 halo
        columns, then axis 1 (dim 2), which completes the corner sums."""
        buf = sync_dim(self.mesh, buf, dim=1, axis=0)
        if self.mesh.n1 > 1:
            buf = sync_dim(self.mesh, buf, dim=2, axis=1)
        return buf

    def halo_gather_only(self, buf: torch.Tensor) -> torch.Tensor:
        """The halo rows and columns from the neighbours' interiors, in
        place, without the reduce legs: axis 0 first, so the axis-1 legs
        also deliver valid corner values.  Any (n, L0 + 4[, L1 + 4], ...)
        buffer."""
        buf = gather_dim(self.mesh, buf, dim=1, axis=0)
        if self.mesh.n1 > 1:
            buf = gather_dim(self.mesh, buf, dim=2, axis=1)
        return buf


def context(spec: FastDomain3DSpec, mesh) -> FastDomain3DCtx:
    if (mesh.n0, mesh.n1) != (spec.n_shards0, spec.n_shards1):
        raise ValueError(f"spec has {spec.n_shards0}x{spec.n_shards1} shards, "
                         f"mesh {mesh.n0}x{mesh.n1}")
    return FastDomain3DCtx(mesh, spec.rows_per_shard0, rows1=spec.rows_per_shard1)


def _reorder(a: torch.Tensor, n0: int, n1: int, l0: int, l1: int, to_shards: bool):
    """A (pencils, K) field between the global (s0, l0, s1, l1) order and
    the shard-major (s0, s1, l0, l1) one (fast_domain3d.py:184-190)."""
    src = (n0, l0, n1, l1) if to_shards else (n0, n1, l0, l1)
    return a.reshape(*src, *a.shape[1:]).transpose(1, 2).reshape(a.shape)


def distribute(p, cfg: MPMConfig, spec: FastDomain3DSpec, mesh) -> FluidBuckets3D:
    """Bucket by global (r0, r1) pencil into the (n0 L0, n1 L1) grid, then
    reorder to shard-major (s0, s1, l0, l1) blocks on the mesh's device
    (fast_domain3d.py:168-197); overflow per shard.  On a RankMesh the
    global layout is built on the host and each rank keeps its own (L0 L1,
    K) block, bit for bit SlabMesh's shard `rank`."""
    context(spec, mesh)
    where = "cpu" if mesh.distributed else mesh.device
    b = fast3d.from_particles(p, cfg, spec.bucket_spec, where)
    if int(b.overflow) != 0:
        raise ValueError(f"initial bucketing overflowed capacity {spec.local_spec.capacity}")
    b = _relayout(b, spec, to_shards=True)
    if mesh.distributed:
        b = own_block(b, mesh.rank, spec.n_shards, mesh.device)
    return dataclasses.replace(b, overflow=torch.zeros((mesh.blocks,), dtype=torch.int32,
                                                       device=mesh.device))


def to_global(b: FluidBuckets3D, spec: FastDomain3DSpec) -> FluidBuckets3D:
    """The shard-major state in the global (n0 L0, n1 L1) pencil order
    (`distribute`'s reorder undone; the per-shard overflow kept)."""
    return _relayout(b, spec, to_shards=False)


def _relayout(b: FluidBuckets3D, spec: FastDomain3DSpec, to_shards: bool) -> FluidBuckets3D:
    if spec.n_shards1 == 1:
        return b
    dims = (spec.n_shards0, spec.n_shards1, spec.rows_per_shard0, spec.rows_per_shard1)
    return dataclasses.replace(b, **{
        f.name: _reorder(getattr(b, f.name), *dims, to_shards)
        for f in dataclasses.fields(b) if f.name != "overflow"
    })


def rebucket_migrate(b: FluidBuckets3D, scene: Scene, spec: FastDomain3DSpec,
                     mesh) -> FluidBuckets3D:
    """Every shard at once: exchange slots that left the window with the
    adjacent shards, the axis-0 leg then the axis-1 leg
    (fast_domain3d.py:236-288), then re-sort survivors and arrivals into
    local pencil buckets.  Buffer overflow and an arrival outside the
    shard's window count into `overflow`."""
    cfg = scene.cfg
    n, l0, l1 = mesh.blocks, spec.rows_per_shard0, spec.rows_per_shard1
    k, m = spec.local_spec.capacity, spec.mig_cap
    fields = _field_list(b)
    act = b.mask.reshape(n, -1) > 0
    inv_dx = _f32(cfg.inv_dx)
    brow = lambda x: torch.floor(x.reshape(n, -1) * inv_dx + PAD - 0.5).to(torch.int32)
    lo0 = (mesh.shard_index(0).to(b.device) * l0)[:, None].to(torch.int32)
    lo1 = (mesh.shard_index(1).to(b.device) * l1)[:, None].to(torch.int32)
    cat, act, drop = exchange(mesh, stacked_fields(fields, n), act, brow(b.x0), lo0, l0, m)
    flat = unstack_fields(cat, fields)
    if spec.n_shards1 > 1:
        cat, act, drop1 = exchange(mesh, cat, act, brow(flat[1]), lo1, l1, m, axis=1)
        flat = unstack_fields(cat, fields)
        drop = drop + drop1
    r0a = brow(flat[0]) - lo0
    r1a = brow(flat[1]) - lo1
    # An arrival more than one shard away would be clipped into an edge
    # bucket outside the kernels' +-1-row margin: count it instead.
    hop_drop = (act & ((r0a < 0) | (r0a >= l0) | (r1a < 0) | (r1a >= l1))).sum(
        dim=1).to(torch.int32)
    pair = r0a.clamp(0, l0 - 1) * l1 + r1a.clamp(0, l1 - 1)
    out, mask, ovf = bucket_shards(pair, act, flat, n, l0 * l1, k)
    return fast3d._safe_dead_slots(
        FluidBuckets3D(*out, mask=mask.to(torch.float32),
                       overflow=b.overflow + ovf + drop + hop_drop)
    )


def make_run(scene: Scene, spec: FastDomain3DSpec, mesh):
    """`run(b, n_substeps, stats=None, plain=False, t0=None)`: the sharded
    3D stepper with the collective rebucket decision over both mesh axes
    (fast_domain3d.py:291-350) before each substep (one host read per
    substep); substep j of every shard sees t0 + j dt."""
    cfg = scene.cfg
    fast3d.check_supported(scene, sharded=True)
    ctx = context(spec, mesh)
    lspec = spec.stacked(mesh.blocks)

    def run(b: FluidBuckets3D, n_substeps: int, stats: RunStats = None,
            plain: bool = False, t0=None) -> FluidBuckets3D:
        stats = RunStats() if stats is None else stats
        row0, row1 = ctx.pencil_offsets(b.device)
        for t in fast3d.substep_times(scene, t0, n_substeps):
            stats.host_reads += 1
            flags = fast3d._margin_pencils(b, cfg, lspec, row0, row1).view(mesh.blocks, -1)
            if bool(mesh.any(flags.any(dim=1))):
                b = rebucket_migrate(b, scene, spec, mesh)
                stats.rebuckets += 1
            b = fast3d.substep(b, scene, lspec, plain=plain, domain=ctx, t=t)
            stats.substeps += 1
        return b

    return run
