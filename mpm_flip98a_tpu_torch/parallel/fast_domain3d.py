"""Slab-sharded 3D fast path, one axis (counterpart of `mpm_flip98a_tpu/parallel/fast_domain3d.py`).

The grid's axis 0 is cut into n slabs of L0 pencil-bucket rows; the pencil
index r0 R1 + r1 is r0-major, so a slab is a contiguous block of pencils.
Per substep one halo exchange moves the 4 folded edge planes (1 below, 3
above) between neighbouring shards; particles migrate only on collective
rebucket events.  Both branches of `fast3d.substep` run on the shards'
local windows (`domain=...`), through `p2g3d_grid`'s raw mode.

The reference's two-axis mode (slabs x pencil columns, `--devices
N0xN1`) is not ported (ROADMAP queue 1, item 7): it raises
NotImplementedError.  The reference runs it through `p2g3d_grid`'s raw
mode on (L0, L1) windows (fast3d.py:631-641, 776-784), whose halo buffer
already carries the axis-1 halo, so it needs the axis-1 exchange and
migration legs, not `p2g3d`'s `halo1` mode.  State keeps the JAX
package's one-axis (n L0 R1, K) layout, and the collectives are
`SlabMesh`'s.
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
    FastDomainCtx, bucket_shards, exchange, stacked_fields, unstack_fields,
)
from mpm_flip98a_tpu_torch.parallel.mesh import SlabMesh


def as_shards(n_shards: Union[int, Tuple[int, int]]) -> int:
    """The axis-0 shard count of `n_shards` (an int or (n0, n1) with n1 = 1)."""
    n0, n1 = (n_shards, 1) if isinstance(n_shards, int) else map(int, n_shards)
    if n1 != 1:
        raise NotImplementedError(
            f"two-axis 3D sharding ({n0}x{n1}: slabs x pencil columns, the axis-1 halo "
            "and migration legs) is not ported yet (ROADMAP queue 1, item 7)"
        )
    return n0


@dataclasses.dataclass(frozen=True)
class FastDomain3DSpec:
    """Static decomposition parameters of the one-axis mode: the JAX
    spec's fields less n_shards1 = 1 and rows_per_shard1 = G."""

    n_shards0: int
    rows_per_shard0: int  # L0: axis-0 bucket rows per shard (n0 L0 >= G)
    local_spec: FastSpec3D  # rows0 = L0, rows1 = G
    mig_cap: int

    @property
    def n_shards(self) -> int:
        return self.n_shards0

    @property
    def global_spec(self) -> FastSpec3D:
        """The (n L0, G) pencil layout of the whole state."""
        return dataclasses.replace(self.local_spec, rows0=self.n_shards0 * self.rows_per_shard0)

    @staticmethod
    def for_particles(cfg: MPMConfig, n_shards, p, headroom: float = 2.0) -> "FastDomain3DSpec":
        """The JAX package's sizing (fast_domain3d.py:79-110): L0 = ceil(G /
        n0), capacity from the peak pencil occupancy, mig_cap = max(128,
        2 K)."""
        n0 = as_shards(n_shards)
        g = cfg.num_grids
        rows0 = -(-g // n0)
        if rows0 < 4:
            raise ValueError(f"shard windows must be at least 4 rows for the halo exchange, "
                             f"got {rows0}")
        cap = fast3d.FastSpec3D.for_particles(cfg, p, headroom).capacity
        return FastDomain3DSpec(
            n_shards0=n0, rows_per_shard0=rows0,
            local_spec=FastSpec3D(rows0=rows0, rows1=g, capacity=cap),
            mig_cap=max(128, cap * 2),
        )


@dataclasses.dataclass(frozen=True)
class FastDomain3DCtx(FastDomainCtx):
    """Runtime context handed to fast3d.substep(domain=...): the halo
    exchange on axis 0 of (n, L0 + 4, R1 + 4, nch, G2) buffers
    (`_sync_dim` on dim 0 of each shard's buffer, fast_domain3d.py:113-130)
    is the 2D context's on dim 1 of the stacked shards."""

    rows1: int = 0

    def x0_shift(self, device, cfg: MPMConfig) -> torch.Tensor:
        """(n L0 R1, 1) float32 slab origin in metres of each pencil's
        shard, s L0 dx (fast3d.py:521-525)."""
        per_shard = self.rows_per_shard * self.rows1
        pencil = torch.arange(self.n * per_shard, device=device)
        lo = (pencil // per_shard) * self.rows_per_shard
        return (lo.to(torch.float32) * _f32(cfg.dx))[:, None]


def distribute(p, cfg: MPMConfig, spec: FastDomain3DSpec, mesh: SlabMesh) -> FluidBuckets3D:
    """Bucket by global (r0, r1) pencil into the (n L0 R1, K) layout (shard
    s owns the pencils of axis-0 rows [s L0, (s + 1) L0)) on the mesh's
    device; overflow per shard."""
    n = spec.n_shards
    if mesh.n != n:
        raise ValueError(f"spec has {n} shards, mesh {mesh.n}")
    b = fast3d.from_particles(p, cfg, spec.global_spec, mesh.device)
    if int(b.overflow) != 0:
        raise ValueError(f"initial bucketing overflowed capacity {spec.local_spec.capacity}")
    return dataclasses.replace(b, overflow=torch.zeros((n,), dtype=torch.int32, device=mesh.device))


def rebucket_migrate(b: FluidBuckets3D, scene: Scene, spec: FastDomain3DSpec,
                     mesh: SlabMesh) -> FluidBuckets3D:
    """Every shard at once: exchange slots that left the slab with the
    adjacent shards (the axis-0 leg of fast_domain3d.py:243-300), then
    re-sort survivors and arrivals into local pencil buckets.  Buffer
    overflow and an arrival outside the shard's window count into
    `overflow`."""
    cfg = scene.cfg
    n, l0, l1 = spec.n_shards, spec.rows_per_shard0, spec.local_spec.rows1
    k, m = spec.local_spec.capacity, spec.mig_cap
    fields = _field_list(b)
    stk = stacked_fields(fields, n)
    act = b.mask.reshape(n, -1) > 0
    inv_dx = _f32(cfg.inv_dx)
    brow = lambda x: torch.floor(x * inv_dx + PAD - 0.5).to(torch.int32)
    lo0 = (mesh.shard_index() * l0)[:, None].to(torch.int32)
    cat, cat_act, drop0 = exchange(mesh, stk, act, brow(b.x0.reshape(n, -1)), lo0, l0, m)
    flat = unstack_fields(cat, fields)
    r0a = brow(flat[0].view(n, -1)) - lo0
    r1a = brow(flat[1].view(n, -1))
    # An arrival more than one shard away would be clipped into an edge
    # bucket outside the kernels' +-1-row margin: count it instead.
    hop_drop = (cat_act & ((r0a < 0) | (r0a >= l0) | (r1a < 0) | (r1a >= l1))).sum(
        dim=1).to(torch.int32)
    pair = r0a.clamp(0, l0 - 1) * l1 + r1a.clamp(0, l1 - 1)
    out, mask, ovf = bucket_shards(pair, cat_act, flat, n, l0 * l1, k)
    return fast3d._safe_dead_slots(
        FluidBuckets3D(*out, mask=mask.to(torch.float32),
                       overflow=b.overflow + ovf + drop0 + hop_drop)
    )


def make_run(scene: Scene, spec: FastDomain3DSpec, mesh: SlabMesh):
    """`run(b, n_substeps, stats=None, plain=False, t0=None)`: the sharded
    3D stepper with the collective rebucket decision of fast_domain3d.py:
    317-333 before each substep (one host read per substep); substep j of
    every shard sees t0 + j dt (fast_domain3d.py:332-345)."""
    cfg = scene.cfg
    fast3d.check_supported(scene, sharded=True)
    gspec = spec.global_spec
    ctx = FastDomain3DCtx(mesh, spec.rows_per_shard0, rows1=spec.local_spec.rows1)

    def run(b: FluidBuckets3D, n_substeps: int, stats: RunStats = None,
            plain: bool = False, t0=None) -> FluidBuckets3D:
        stats = RunStats() if stats is None else stats
        for t in fast3d.substep_times(scene, t0, n_substeps):
            stats.host_reads += 1
            flags = fast3d._margin_pencils(b, cfg, gspec).view(mesh.n, -1).any(dim=1)
            if bool(mesh.any(flags)):
                b = rebucket_migrate(b, scene, spec, mesh)
                stats.rebuckets += 1
            b = fast3d.substep(b, scene, gspec, plain=plain, domain=ctx, t=t)
            stats.substeps += 1
        return b

    return run
