"""Fast 2D fluid solver on the hand-written CUDA transfer kernels.

Counterpart of `mpm_flip98a_tpu/models/fast2d.py`, restricted to the
single-device fused branch: one weakly-compressible fluid (linear or Tait
EOS), PIC or APIC transfer with the FLIP blend, slip or sticky walls.  Per
substep: `p2g_fused` (kernel) -> `fold_rows` -> `_grid_update2d` -> `g2p`
(kernel) -> the particle update, all on float32 tensors on one device.

State lives in the row-bucketed (R, K) slot layout; `rebucket` re-sorts it
when a particle nears the kernels' +-1-row margin.  `run` keeps the
reference's order (a rebucket happens before the first substep whose
state fails the margin check); in eager PyTorch that costs one
device-to-host read of the check per substep, counted in `RunStats`.

Configurations outside this slice raise NotImplementedError naming their
ROADMAP item.  The TPU lane crop (`kernel_cols`) is not ported: the
kernels use all G = num_grids columns.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models.stabilized import PAD, Scene, _mass_floor
from mpm_flip98a_tpu_torch.ops import binning
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
from mpm_flip98a_tpu_torch.state import Particles


def _f32(v: float) -> float:
    """A Python float holding v rounded to float32, as JAX's jnp.float32(v)."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class FluidBuckets:
    """Row-bucketed particle state; every field (R, K) f32 (mat: int32)."""

    x0: torch.Tensor
    x1: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    C00: torch.Tensor
    C01: torch.Tensor
    C10: torch.Tensor
    C11: torch.Tensor
    F00: torch.Tensor
    F01: torch.Tensor
    F10: torch.Tensor
    F11: torch.Tensor
    J: torch.Tensor
    mass: torch.Tensor
    vol0: torch.Tensor
    mat: torch.Tensor       # int32 material id
    Jp: torch.Tensor        # plastic volume ratio (SNOW state)
    jbar_s: torch.Tensor    # fused-stabilization state (not used by this slice)
    p_s: torch.Tensor
    div_s: torch.Tensor
    mask: torch.Tensor      # f32 0/1
    overflow: torch.Tensor  # int32 scalar, cumulative rebucket overflow

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.x0.shape)

    @property
    def device(self) -> torch.device:
        return self.x0.device


@dataclasses.dataclass(frozen=True)
class FastSpec:
    """Static fast-path parameters."""

    rows: int          # R = num_grids (one bucket per grid row)
    capacity: int      # K slots per row

    @staticmethod
    def for_particles(cfg: MPMConfig, p: Particles, headroom: float = 1.5) -> "FastSpec":
        x = p.x.cpu().numpy()
        row = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        occ = int(np.bincount(np.clip(row, 0, cfg.num_grids - 1), minlength=cfg.num_grids).max())
        return FastSpec(rows=cfg.num_grids, capacity=capacity_for(occ, headroom))


def capacity_for(occ: int, headroom: float = 1.5) -> int:
    """Bucket capacity for a peak per-row occupancy: headroom-padded, a
    multiple of 128 and, above 1024, of 128 x the number of 1024-slot
    chunks.  The same rounding as the JAX package, so both packages bucket
    a scene into identical (R, K) layouts."""
    cap = max(128, -(-int(headroom * occ) // 128) * 128)
    if cap > 1024:
        nc = -(-cap // 1024)
        cap = -(-cap // (128 * nc)) * (128 * nc)
    return cap


def _field_list(b: FluidBuckets):
    return (
        b.x0, b.x1, b.v0, b.v1,
        b.C00, b.C01, b.C10, b.C11,
        b.F00, b.F01, b.F10, b.F11,
        b.J, b.mass, b.vol0, b.mat, b.Jp,
        b.jbar_s, b.p_s, b.div_s,
    )


def _safe_dead_slots(b: FluidBuckets) -> FluidBuckets:
    """Give inactive slots physically neutral values (J = 1, F = I), so the
    1/J Tait power stays finite in slots that masking then discards."""
    on = b.mask > 0
    one = lambda a: torch.where(on, a, torch.ones_like(a))
    return dataclasses.replace(
        b, J=one(b.J), F00=one(b.F00), F11=one(b.F11),
        Jp=one(b.Jp), jbar_s=one(b.jbar_s),
    )


def _rows_of(x0: torch.Tensor, cfg: MPMConfig) -> torch.Tensor:
    gx0 = x0 * cfg.inv_dx + PAD
    return torch.floor(gx0 - 0.5).to(torch.int32)


def rebucket(b: FluidBuckets, cfg: MPMConfig, spec: FastSpec) -> FluidBuckets:
    """Re-sort slots into their current base-row buckets (one sort)."""
    flat = tuple(f.reshape(-1) for f in _field_list(b))
    fields, new_mask, overflow = binning.bucket_by_row(
        _rows_of(flat[0], cfg), b.mask.reshape(-1) > 0, flat,
        spec.rows, spec.capacity,
    )
    return _safe_dead_slots(
        FluidBuckets(
            *fields,
            mask=new_mask.to(torch.float32),
            overflow=b.overflow + overflow,
        )
    )


def from_particles(
    p: Particles, cfg: MPMConfig, spec: FastSpec, device="cpu"
) -> FluidBuckets:
    """Dense Particles -> bucketed fast-path state (float32 on `device`)."""
    n = p.n
    to32 = lambda a: a.to(device=device, dtype=torch.float32)
    x, v, c, f = to32(p.x), to32(p.v), to32(p.C), to32(p.F)
    j = to32(p.J)
    flat = (
        x[:, 0], x[:, 1], v[:, 0], v[:, 1],
        c[:, 0, 0], c[:, 0, 1], c[:, 1, 0], c[:, 1, 1],
        f[:, 0, 0], f[:, 0, 1], f[:, 1, 0], f[:, 1, 1],
        j, to32(p.mass), to32(p.volume0),
        p.material.to(device=device, dtype=torch.int32),
        to32(p.Jp),
        j,                                                     # jbar_s init = J
        torch.zeros((n,), dtype=torch.float32, device=device),  # p_s
        torch.zeros((n,), dtype=torch.float32, device=device),  # div_s
    )
    fields, mask, overflow = binning.bucket_by_row(
        _rows_of(flat[0], cfg), torch.ones((n,), dtype=torch.bool, device=device),
        flat, spec.rows, spec.capacity,
    )
    return _safe_dead_slots(
        FluidBuckets(*fields, mask=mask.to(torch.float32), overflow=overflow)
    )


HOST_FIELDS = ("x0", "x1", "v0", "v1", "J", "mass", "vol0", "mat", "Jp")


def to_host(b: FluidBuckets) -> dict:
    """Host-side dense view of active slots (diagnostics / IO), in
    row-major slot order: two device-to-host copies in all."""
    sel = b.mask > 0
    floats = [n for n in HOST_FIELDS if n != "mat"]
    stk = torch.stack([getattr(b, n)[sel] for n in floats]).cpu().numpy()
    out = dict(zip(floats, stk))
    out["mat"] = b.mat[sel].cpu().numpy()
    return {n: out[n] for n in HOST_FIELDS}


def check_supported(scene: Scene) -> None:
    """Raise NotImplementedError for configs outside the ported slice."""
    cfg = scene.cfg
    gaps = [
        (cfg.dim != 2, "3D (fast3d)", 9),
        (cfg.use_penalty_ebc, "penalty EBC", 8),
        (cfg.surface_tension > 0.0, "CSF surface tension", 8),
        (cfg.incompressible, "the incompressible projection", 8),
        (bool(scene.colliders), "rigid SDF colliders", 8),
        (cfg.use_fbar or cfg.pressure_mixing_ratio > 0.0,
         "F-bar / pressure mixing (extended channels)", 8),
        (cfg.kernel == KernelKind.TENT, "the tent kernel", 8),
        (scene.materials_present != (mat.WEAKLY_COMPRESSIBLE_FLUID,),
         "materials other than one weakly-compressible fluid", 8),
        (scene.params.plastic, "plasticity", 8),
    ]
    for bad, what, item in gaps:
        if bad:
            raise NotImplementedError(
                f"fast2d port: {what} is not ported yet (ROADMAP queue 1, item {item})"
            )


def _axis_bands2d(cfg: MPMConfig, nrows: int, ncols: int, device):
    """Wall-band masks broadcastable against (R, G) planes: box faces at
    PAD / G-1-PAD, as models/stabilized._apply_wall_bc."""
    lo, hi = int(PAD), cfg.num_grids - 1 - int(PAD)
    idx0 = torch.arange(nrows, device=device)
    idx1 = torch.arange(ncols, device=device)
    return (
        (idx0 <= lo)[:, None], (idx0 >= hi)[:, None],
        (idx1 <= lo)[None, :], (idx1 >= hi)[None, :],
    )


def _grid_update2d(gridsum: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Grid momentum update on the row-leading (R, 5, G) fold output:
    mass floor, gravity, slip or sticky walls.  Returns grid4 (R, 4, G) =
    [v_new (2), v_old (2)] for g2p."""
    cfg = scene.cfg
    dt = np.float32(cfg.dt)
    g_m = gridsum[:, 4]
    has = g_m > _mass_floor(scene, g_m)
    safe = torch.where(has, g_m, 1.0)
    v0x = torch.where(has, gridsum[:, 0] / safe, 0.0)     # pre-force
    v0y = torch.where(has, gridsum[:, 1] / safe, 0.0)
    grav = np.asarray(cfg.gravity_acceleration(scene.physics), np.float32)
    low0, high0, low1, high1 = _axis_bands2d(
        cfg, gridsum.shape[0], gridsum.shape[-1], gridsum.device
    )
    hasf = has.to(torch.float32)
    vx = torch.where(has, gridsum[:, 2] / safe, 0.0) + float(dt * grav[0]) * hasf
    vy = torch.where(has, gridsum[:, 3] / safe, 0.0) + float(dt * grav[1]) * hasf
    if scene.wall.kind == "sticky":
        anyband = low0 | high0 | low1 | high1
        vx = torch.where(anyband, 0.0, vx)
        vy = torch.where(anyband, 0.0, vy)
    else:  # slip: clamp the outgoing normal component per axis band
        vx = torch.where(low0, vx.clamp(min=0.0), vx)
        vx = torch.where(high0, vx.clamp(max=0.0), vx)
        vy = torch.where(low1, vy.clamp(min=0.0), vy)
        vy = torch.where(high1, vy.clamp(max=0.0), vy)
    return torch.stack([vx, vy, v0x, v0y], dim=1)


def p2g_args(scene: Scene) -> dict:
    """Keyword arguments of `p2g_fused` for the scene (fast2d.py:585-592)."""
    cfg = scene.cfg
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    return dict(
        g=cfg.num_grids, dx=float(cfg.dx),
        apic=cfg.transfer == TransferKind.APIC,
        eos="linear" if scene.params.eos == EOSKind.LINEAR else "tait",
        kb=float(scene.params.bulk_modulus),
        mu=float(scene.params.dynamic_viscosity),
        gamma=float(scene.params.tait_gamma),
        fa=float(-cfg.dt * dinv),
    )


def transfer_inputs(b: FluidBuckets, cfg: MPMConfig):
    """(sdata (R, 11, K), pdata2 (R, 3, K), counts (R,)) for the kernels.

    P2G and G2P read one precomputed transfer coordinate gx = x / dx + PAD
    (docs/KERNELS.md:57-60): computed twice, it could round a knife-edge
    particle into different cells in the two transfers."""
    inv_dx = _f32(cfg.inv_dx)
    gx0 = b.x0 * inv_dx + PAD
    gx1 = b.x1 * inv_dx + PAD
    counts = (b.mask > 0).sum(dim=1).to(torch.int32)
    sdata = torch.stack(
        [gx0, gx1, b.v0, b.v1, b.C00, b.C01, b.C10, b.C11, b.J, b.mass, b.vol0],
        dim=1,
    )
    return sdata, torch.stack([gx0, gx1, b.mask], dim=1), counts


def substep(b: FluidBuckets, scene: Scene, plain: bool = False) -> FluidBuckets:
    """One fast substep (fast2d.py:479-875, fused branch).

    `plain=True` calls the kernels' plain PyTorch versions even on a card:
    it exists to time the plain path against the kernel path."""
    check_supported(scene)
    cfg = scene.cfg
    dt = _f32(cfg.dt)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    p2g, g2p = (tk.p2g_fused_plain, tk.g2p_plain) if plain else (tk.p2g_fused, tk.g2p)

    sdata, pdata2, counts = transfer_inputs(b, cfg)
    grid4 = _grid_update2d(tk.fold_rows(p2g(sdata, counts, **p2g_args(scene))), scene)
    out8 = g2p(pdata2, counts, grid4, float(cfg.dx), dinv)
    vpic0, vpic1 = out8[:, 0], out8[:, 1]
    vold0, vold1 = out8[:, 2], out8[:, 3]
    c00, c01, c10, c11 = out8[:, 4], out8[:, 5], out8[:, 6], out8[:, 7]

    # Particle update (fast2d.py:818-875): FLIP blend, advection, F and J.
    alpha = _f32(cfg.flip_blend)
    one_m_alpha = float(np.float32(1.0) - np.float32(alpha))
    nv0 = alpha * (b.v0 + vpic0 - vold0) + one_m_alpha * vpic0
    nv1 = alpha * (b.v1 + vpic1 - vold1) + one_m_alpha * vpic1
    f00 = (1 + dt * c00) * b.F00 + dt * c01 * b.F10
    f01 = (1 + dt * c00) * b.F01 + dt * c01 * b.F11
    f10 = dt * c10 * b.F00 + (1 + dt * c11) * b.F10
    f11 = dt * c10 * b.F01 + (1 + dt * c11) * b.F11
    on = b.mask > 0
    return dataclasses.replace(
        b,
        x0=b.x0 + dt * vpic0 * b.mask,
        x1=b.x1 + dt * vpic1 * b.mask,
        v0=nv0 * b.mask,
        v1=nv1 * b.mask,
        C00=c00, C01=c01, C10=c10, C11=c11,
        F00=f00, F01=f01, F10=f10, F11=f11,
        J=torch.where(on, b.J * (1.0 + dt * (c00 + c11)), 1.0),
    )


def _needs_rebucket(b: FluidBuckets, cfg: MPMConfig) -> torch.Tensor:
    """True (a 0-dim bool tensor) when any active slot approaches the
    kernels' +-1-row margin: post-rebucket every slot has gx0 - 0.5 - row
    in [0, 1); trigger with a 0.2-row safety band before [-1, 2) is left."""
    r, k = b.shape
    gx0 = b.x0 * _f32(cfg.inv_dx) + PAD
    rows = torch.arange(r, dtype=torch.int32, device=b.device)[:, None].to(torch.float32)
    d = torch.where(b.mask > 0, gx0 - 0.5 - rows, 0.5)
    return ((d <= -0.8) | (d >= 1.8)).any()


@dataclasses.dataclass
class RunStats:
    """Counts kept by `run` (the caller creates and passes it)."""

    substeps: int = 0
    rebuckets: int = 0
    host_reads: int = 0   # device->host reads of the margin flag


def run(
    b: FluidBuckets, scene: Scene, spec: FastSpec, n_substeps: int,
    stats: RunStats = None, plain: bool = False,
) -> FluidBuckets:
    """Advance n_substeps with adaptive rebucketing: before each substep,
    rebucket if the state fails the margin check (the order of
    fast2d.py:936-987).  Reading the flag is one host sync per substep."""
    stats = RunStats() if stats is None else stats
    for _ in range(n_substeps):
        stats.host_reads += 1
        if bool(_needs_rebucket(b, scene.cfg)):
            b = rebucket(b, scene.cfg, spec)
            stats.rebuckets += 1
        b = substep(b, scene, plain=plain)
        stats.substeps += 1
    return b
