"""Slab-sharded 2D fast path (counterpart of `mpm_flip98a_tpu/parallel/fast_domain.py`).

The grid's row axis is cut into n slabs of L bucket rows, and because the
fast path's bucket axis is the grid row axis, shard s owns the bucket rows
[s L, (s + 1) L).  The transfer kernels run on each shard's local window
(all shards in one kernel call); only two things cross shards, both O(halo):

  1. the grid halo exchange, once per substep: `p2g_grid`'s raw fold keeps
     its edge target rows (1 below the slab, 3 above: the +-1-bucket drift
     margin times the 3-tap stencil); partial sums reduce into the owning
     neighbour, completed rows gather back (`FastDomainCtx.halo_sync`);
  2. particle migration, only on rebucket events: slots whose base row
     left the slab ride fixed-capacity buffers to the adjacent shard and
     are re-bucketed together with the local slots (`rebucket_migrate`).

State keeps the JAX package's (n L, K) layout; viewed as (n, L, ...) its
leading dimension is the shard.  The collectives are the mesh's
(parallel/mesh.py), with the JAX package's `ppermute` and `psum`
semantics: on `SlabMesh` all n shards live on one device as that leading
dimension; on `RankMesh` each rank holds its own (L, K) block, one shard,
and runs the kernels on it alone, as a chip runs its shard in
`shard_map`.  Shapes follow the blocks a process holds (`mesh.blocks`),
origins the shards' global indices (`mesh.shard_index`).  `distribute`
gives each rank its rows of the global layout, `collect` gathers the
blocks back into it.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from mpm_flip98a_tpu_torch.config import MPMConfig
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.models.fast2d import FluidBuckets, RunStats, _f32, _field_list
from mpm_flip98a_tpu_torch.models.stabilized import PAD, Scene
from mpm_flip98a_tpu_torch.ops import binning
from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh, SlabMesh

# Halo rows of the folded P2G output: bucket row r scatters to target rows
# r - 1 .. r + 3 (rel in {-1, 0, 1} drift x 3-tap stencil), so a slab's
# buffer carries 1 row below and 3 above its L owned rows.
H_LO, H_HI = 1, 3


@dataclasses.dataclass(frozen=True)
class FastDomainSpec:
    """Static decomposition parameters for the sharded fast path."""

    n_shards: int
    rows_per_shard: int   # L: bucket rows per shard (n * L >= num_grids)
    capacity: int         # K slots per bucket row
    mig_cap: int          # migration slots per direction per rebucket

    @staticmethod
    def for_particles(cfg: MPMConfig, n_shards: int, p, headroom: float = 2.0) -> "FastDomainSpec":
        """The JAX package's sizing (fast_domain.py:56-75): L = ceil(G / n),
        capacity from the peak row occupancy, mig_cap = max(128, K)."""
        rows = -(-cfg.num_grids // n_shards)
        if rows < 4:
            raise ValueError(f"slabs must be at least 4 rows for the halo window, got {rows}")
        cap = fast2d.FastSpec.for_particles(cfg, p, headroom).capacity
        return FastDomainSpec(n_shards=n_shards, rows_per_shard=rows, capacity=cap,
                              mig_cap=max(128, cap))


@dataclasses.dataclass(frozen=True)
class FastDomainCtx:
    """Runtime context handed to fast2d.substep(domain=...)."""

    mesh: Union[SlabMesh, RankMesh]
    rows_per_shard: int

    @property
    def blocks(self) -> int:
        """The shard blocks this process holds (the kernels' `shards`)."""
        return self.mesh.blocks

    @property
    def rank_mesh(self):
        """The mesh when its shards span processes (the grid-side chains'
        maxima and dot products then reduce over the ranks), else None."""
        return self.mesh if self.mesh.distributed else None

    def bucket_rows(self, device) -> torch.Tensor:
        """(blocks L,) int64: the global row of each local bucket row, s L +
        i for local row i of shard s."""
        l = self.rows_per_shard
        rows = torch.arange(self.blocks * l, device=device)
        return self.mesh.shard_index().to(device)[rows // l] * l + rows % l

    def bucket_row0(self, device) -> torch.Tensor:
        """(blocks L, 1) float32: the global row of each bucket row's shard
        origin, s L (the reference's `axis_index * r`)."""
        l = self.rows_per_shard
        return ((self.bucket_rows(device) // l) * l).to(torch.float32)[:, None]

    def row_index0(self, device) -> torch.Tensor:
        """(blocks, L + 4) global row index of each halo row: s L - 1 + j."""
        l = self.rows_per_shard
        s = self.mesh.shard_index().to(device)[:, None]
        return s * l - 1 + torch.arange(l + H_LO + H_HI, device=device)[None, :]

    def own_rows(self, device) -> torch.Tensor:
        """(blocks, L + 4) bool: the rows each shard owns, [H_LO, H_LO + L):
        the grid-side CG's dot products count them alone (fast2d.py:
        371-373)."""
        j = torch.arange(self.rows_per_shard + H_LO + H_HI, device=device)
        return ((j >= H_LO) & (j < H_LO + self.rows_per_shard)).expand(self.blocks, -1)

    def halo_sync(self, buf: torch.Tensor) -> torch.Tensor:
        """(n, L + 4, ...) raw folded sums -> globally complete rows, in place.

        Reduce: edge partial sums into the owning neighbour's interior;
        gather: completed interior edge rows back into the halos.  The four
        legs run in the reference's order (fast_domain.py:97-110), each on
        the previous one's result; edge shards receive zeros on both legs
        (no neighbour, no partial sums; the out-of-domain halo rows are
        never read with nonzero weight thanks to the 4-cell padding)."""
        return sync_dim(self.mesh, buf, dim=1, axis=0)

    def halo_gather_only(self, buf: torch.Tensor) -> torch.Tensor:
        """Refresh the halo rows from the neighbours' completed interiors,
        in place, without the reduce leg (fast_domain.py:112-124): for the
        grid-side chains of CSF and the projection, whose inputs are
        already global sums.  Any (n, L + 4, ...) buffer, channel-less
        planes included."""
        return gather_dim(self.mesh, buf, dim=1, axis=0)


def sync_dim(mesh, buf: torch.Tensor, dim: int, axis: int) -> torch.Tensor:
    """The reduce legs, then `gather_dim`, on tensor dim `dim` of a halo
    buffer (L + 4 rows there, row j = target row j - 1) across mesh axis
    `axis` (`_sync_dim`, fast_domain3d.py:105-121), in place."""
    l = buf.shape[dim] - (H_LO + H_HI)
    rows = lambda a, b: buf.narrow(dim, a, b - a)
    # reduce: my bottom row belongs to the left neighbour's interior, my
    # top 3 rows to the right neighbour's.
    rows(l, l + H_LO).add_(mesh.shift_left(rows(0, H_LO), axis, tag="halo"))
    rows(H_LO, H_LO + H_HI).add_(mesh.shift_right(rows(l + H_LO, l + H_LO + H_HI), axis,
                                                  tag="halo"))
    return gather_dim(mesh, buf, dim, axis)


def gather_dim(mesh, buf: torch.Tensor, dim: int, axis: int) -> torch.Tensor:
    """The gather legs on tensor dim `dim` across mesh axis `axis`: the
    halo rows from the neighbours' completed interiors, in place."""
    l = buf.shape[dim] - (H_LO + H_HI)
    rows = lambda a, b: buf.narrow(dim, a, b - a)
    rows(0, H_LO).copy_(mesh.shift_right(rows(l, l + H_LO), axis, tag="halo"))
    rows(l + H_LO, l + H_LO + H_HI).copy_(mesh.shift_left(rows(H_LO, H_LO + H_HI), axis,
                                                          tag="halo"))
    return buf


def distribute(p, cfg: MPMConfig, spec: FastDomainSpec, mesh) -> FluidBuckets:
    """Bucket particles by global row into the (n L, K) layout (shard s
    owns rows [s L, (s + 1) L)) on the mesh's device; overflow per shard.
    On a RankMesh the global layout is bucketed on the host and each rank
    keeps its own L rows, bit for bit SlabMesh's shard `rank`."""
    n, l, k = spec.n_shards, spec.rows_per_shard, spec.capacity
    if mesh.n != n:
        raise ValueError(f"spec has {n} shards, mesh {mesh.n}")
    where = "cpu" if mesh.distributed else mesh.device
    b = fast2d.from_particles(p, cfg, fast2d.FastSpec(rows=n * l, capacity=k), where)
    if int(b.overflow) != 0:
        raise ValueError(f"initial bucketing overflowed capacity {k}")
    if mesh.distributed:
        b = own_block(b, mesh.rank, n, mesh.device)
    return dataclasses.replace(b, overflow=torch.zeros((mesh.blocks,), dtype=torch.int32,
                                                       device=mesh.device))


def own_block(b, s: int, n: int, device):
    """Shard s's contiguous block of a global shard-major (n ..., K) state
    (every field but `overflow`), on `device`."""
    return dataclasses.replace(b, **{
        f.name: getattr(b, f.name).reshape(n, -1, *getattr(b, f.name).shape[1:])[s]
        .to(device).contiguous()
        for f in dataclasses.fields(b) if f.name != "overflow"})


def collect(b, mesh):
    """The global shard-major state from every rank's block (an
    `all_gather` of each field, on every rank, on its device), per-shard
    overflow (n,) included; on SlabMesh the state as it is."""
    if not mesh.distributed:
        return b
    return dataclasses.replace(b, **{
        f.name: mesh.all_gather(getattr(b, f.name), tag="collect").flatten(0, 1)
        for f in dataclasses.fields(b)})


def exchange(mesh, stk: torch.Tensor, act: torch.Tensor, row: torch.Tensor,
             lo: torch.Tensor, l: int, m: int, axis: int = 0):
    """Send active slots whose bucket row left [lo, lo + l) to the adjacent
    shard along mesh axis `axis`, in fixed-capacity buffers of m slots per
    direction (fast_domain.py:141-174, fast_domain3d.py:200-233).

    stk (n, F, S) int32 bit patterns of the F fields of the n blocks this
    process holds, act (n, S) bool, row (n, S) int32 global rows, lo (n,
    1) -> the stay + arrivals (n, F, S + 2 m), their activity (n, S + 2 m)
    and the dropped movers (n,) int32.  Movers are packed by a stable sort, so they keep their
    slot order, as the reference's argsort does."""
    go_l = act & (row < lo)
    go_r = act & (row >= lo + l)

    def pack(mask):
        order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :m]
        idx = order[:, None, :].expand(-1, stk.shape[1], -1)
        return stk.gather(2, idx), mask.gather(1, order)

    send_l, val_l = pack(go_l)
    send_r, val_r = pack(go_r)
    drop = ((go_l.sum(1) - m).clamp(min=0) + (go_r.sum(1) - m).clamp(min=0)).to(torch.int32)
    from_right = (mesh.shift_left(send_l, axis, tag="migrate"),
                  mesh.shift_left(val_l, axis, tag="migrate"))
    from_left = (mesh.shift_right(send_r, axis, tag="migrate"),
                 mesh.shift_right(val_r, axis, tag="migrate"))
    stay = act & ~(go_l | go_r)
    cat = torch.cat([stk, from_left[0], from_right[0]], dim=2)
    cat_act = torch.cat([stay, from_left[1], from_right[1]], dim=1)
    return cat, cat_act, drop


def stacked_fields(fields, n: int) -> torch.Tensor:
    """(n, F, S) int32 bit patterns of 4-byte fields, each viewed (n, S)."""
    return torch.stack([f.reshape(n, -1).view(torch.int32) for f in fields], dim=1)


def unstack_fields(stk: torch.Tensor, like) -> list:
    """The flat fields of a (n, F, S) int32 stack, in the dtypes of `like`."""
    return [stk[:, e].reshape(-1).view(f.dtype) for e, f in enumerate(like)]


def bucket_shards(key_local, act, fields, n: int, rows: int, k: int):
    """Per-shard `bucket_by_row` of (n, S) local keys in one sort: the key
    offset by s rows keeps every shard's slots apart and in their order, so
    each shard's buckets equal its own bucket_by_row's.  Returns (fields
    (n rows, K), mask, overflow per shard (n,) int32)."""
    dev = act.device
    key = key_local.clamp(0, rows - 1) + (torch.arange(n, device=dev)[:, None] * rows).to(
        key_local.dtype)
    fields_out, mask, _ = binning.bucket_by_row(
        key.reshape(-1), act.reshape(-1), tuple(fields), n * rows, k)
    occ = torch.bincount(key[act].long(), minlength=n * rows).view(n, rows)
    ovf = (occ - k).clamp(min=0).sum(dim=1).to(torch.int32)
    return fields_out, mask, ovf


def rebucket_migrate(b: FluidBuckets, scene: Scene, spec: FastDomainSpec, mesh) -> FluidBuckets:
    """Every shard at once: exchange slots whose base row left the slab
    with the adjacent shard, then re-sort the survivors and arrivals into
    local row buckets (fast_domain.py:127-202).

    A particle can only ever need the adjacent shard (CFL << 1 and the
    +-1-row rebucket margin); buffer overflow (`mig_drop`) and an arrival
    still outside [0, L) (`hop_drop`) are counted into `overflow`, never
    silent."""
    cfg = scene.cfg
    n, l, k, m = mesh.blocks, spec.rows_per_shard, spec.capacity, spec.mig_cap
    fields = _field_list(b)
    stk = stacked_fields(fields, n)
    act = b.mask.reshape(n, -1) > 0
    inv_dx = _f32(cfg.inv_dx)
    brow = lambda x: torch.floor(x * inv_dx + PAD - 0.5).to(torch.int32)
    lo = (mesh.shard_index().to(b.device) * l)[:, None].to(torch.int32)
    cat, cat_act, mig_drop = exchange(mesh, stk, act, brow(b.x0.reshape(n, -1)), lo, l, m)
    flat = unstack_fields(cat, fields)
    row_local = brow(flat[0].view(n, -1)) - lo
    hop_drop = (cat_act & ((row_local < 0) | (row_local >= l))).sum(dim=1).to(torch.int32)
    out, mask, ovf = bucket_shards(row_local, cat_act, flat, n, l, k)
    return fast2d._safe_dead_slots(
        FluidBuckets(*out, mask=mask.to(torch.float32),
                     overflow=b.overflow + ovf + mig_drop + hop_drop)
    )


def needs_rebucket(b: FluidBuckets, cfg: MPMConfig, ctx: FastDomainCtx) -> torch.Tensor:
    """(blocks,) per-shard margin flags (the reference's `_needs_rebucket`
    with row0 = s L), each bucket row at its global row."""
    return fast2d._margin_rows(b, cfg, ctx.bucket_rows(b.device)).view(ctx.blocks, -1).any(dim=1)


def make_run(scene: Scene, spec: FastDomainSpec, mesh):
    """`run(b, n_substeps, stats=None, plain=False, t0=None)`: the sharded
    stepper with the collective rebucket decision of fast_domain.py:216-229
    (any shard near the margin migrates every shard) before each substep;
    the decision is one host read per substep, counted in `stats`.  Every
    shard's substep j sees the same time t0 + j dt for kinematic colliders
    (fast_domain.py:235-247, `fast2d.substep_times`)."""
    cfg = scene.cfg
    fast2d.check_supported(scene)
    if mesh.n != spec.n_shards:
        raise ValueError(f"spec has {spec.n_shards} shards, mesh {mesh.n}")
    ctx = FastDomainCtx(mesh, spec.rows_per_shard)

    def run(b: FluidBuckets, n_substeps: int, stats: RunStats = None,
            plain: bool = False, t0=None) -> FluidBuckets:
        stats = RunStats() if stats is None else stats
        for t in fast2d.substep_times(scene, t0, n_substeps):
            stats.host_reads += 1
            if bool(mesh.any(needs_rebucket(b, cfg, ctx))):
                b = rebucket_migrate(b, scene, spec, mesh)
                stats.rebuckets += 1
            b = fast2d.substep(b, scene, plain=plain, domain=ctx, t=t)
            stats.substeps += 1
        return b

    return run
