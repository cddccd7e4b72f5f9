"""Fast 3D fluid solver on the hand-written CUDA transfer kernels.

Counterpart of `mpm_flip98a_tpu/models/fast3d.py`, restricted to the
single-device fused branch (fast3d.py:586-630 and the `grid_pad` branch of
`_finish_substep`, :454-456, :480-502): one weakly-compressible fluid
(linear or Tait EOS), PIC or APIC transfer with the FLIP blend, slip,
sticky or penalty walls, an absolute grid-mass floor.  Per substep:
`p2g3d_grid` (kernel: stress, scatter, grid update) -> `g2p3d` (kernel:
gather, FLIP blend, advection, J update), on float32 tensors on one
device.  No slot-sized pass runs outside the kernels except the transfer
coordinates and the margin check.

State lives in pencil buckets: one bucket of K slots per (axis-0, axis-1)
grid line, fields (R0 * R1, K).  `run` keeps the reference's order (a
rebucket happens before the first substep whose state fails the margin
check on either bucketed axis); in eager PyTorch that costs one
device-to-host read of the check per substep, counted in `RunStats`.

Configurations outside this slice raise NotImplementedError naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models.fast2d import RunStats, _f32
from mpm_flip98a_tpu_torch.models.stabilized import PAD, Scene
from mpm_flip98a_tpu_torch.ops import binning
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
from mpm_flip98a_tpu_torch.state import Particles


@dataclasses.dataclass(frozen=True)
class FluidBuckets3D:
    """Pencil-bucketed 3D state; every field (R0 * R1, K) f32 (mat int32).

    After a substep the fields the kernel writes (x, v, C, J) are channel
    views of its (R0 * R1, 16, K) output, not separate tensors."""

    x0: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    C00: torch.Tensor
    C01: torch.Tensor
    C02: torch.Tensor
    C10: torch.Tensor
    C11: torch.Tensor
    C12: torch.Tensor
    C20: torch.Tensor
    C21: torch.Tensor
    C22: torch.Tensor
    F00: torch.Tensor
    F01: torch.Tensor
    F02: torch.Tensor
    F10: torch.Tensor
    F11: torch.Tensor
    F12: torch.Tensor
    F20: torch.Tensor
    F21: torch.Tensor
    F22: torch.Tensor
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
class FastSpec3D:
    """Static fast-path parameters: R0 x R1 pencils of K slots."""

    rows0: int
    rows1: int
    capacity: int

    @staticmethod
    def for_particles(cfg: MPMConfig, p: Particles, headroom: float = 1.5) -> "FastSpec3D":
        g = cfg.num_grids
        x = p.x.cpu().numpy()
        r0 = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        r1 = np.floor(x[:, 1] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
        pair = np.clip(r0, 0, g - 1) * g + np.clip(r1, 0, g - 1)
        occ = int(np.bincount(pair, minlength=g * g).max())
        return FastSpec3D(rows0=g, rows1=g, capacity=capacity_for(occ, headroom))


def capacity_for(occ: int, headroom: float = 1.5) -> int:
    """Pencil capacity for a peak occupancy: headroom-padded, a multiple of
    128 (the same rounding as the JAX package, so both bucket a scene into
    identical layouts; the kernels take slots in blocks of 128)."""
    return max(128, -(-int(headroom * occ) // 128) * 128)


def _field_list(b: FluidBuckets3D):
    return (
        b.x0, b.x1, b.x2, b.v0, b.v1, b.v2,
        b.C00, b.C01, b.C02, b.C10, b.C11, b.C12, b.C20, b.C21, b.C22,
        b.F00, b.F01, b.F02, b.F10, b.F11, b.F12, b.F20, b.F21, b.F22,
        b.J, b.mass, b.vol0, b.mat, b.Jp,
        b.jbar_s, b.p_s, b.div_s,
    )


def _pair_row(x0, x1, cfg: MPMConfig, spec: FastSpec3D) -> torch.Tensor:
    """Pencil index (clamped base row on axes 0 and 1) of each slot."""
    r0 = torch.floor(x0 * cfg.inv_dx + PAD - 0.5).to(torch.int32)
    r1 = torch.floor(x1 * cfg.inv_dx + PAD - 0.5).to(torch.int32)
    return r0.clamp(0, spec.rows0 - 1) * spec.rows1 + r1.clamp(0, spec.rows1 - 1)


def _safe_dead_slots(b: FluidBuckets3D) -> FluidBuckets3D:
    """Give inactive slots physically neutral values (J = 1, F = I): the
    binning zero-fills them, and a zero J feeds the Tait 1/J power."""
    on = b.mask > 0
    one = lambda a: torch.where(on, a, torch.ones_like(a))
    return dataclasses.replace(
        b, J=one(b.J), F00=one(b.F00), F11=one(b.F11), F22=one(b.F22),
        Jp=one(b.Jp), jbar_s=one(b.jbar_s),
    )


def rebucket(b: FluidBuckets3D, cfg: MPMConfig, spec: FastSpec3D) -> FluidBuckets3D:
    """Re-sort slots into their current base-pencil buckets (one sort)."""
    flat = tuple(f.reshape(-1) for f in _field_list(b))
    fields, new_mask, overflow = binning.bucket_by_row(
        _pair_row(flat[0], flat[1], cfg, spec), b.mask.reshape(-1) > 0, flat,
        spec.rows0 * spec.rows1, spec.capacity,
    )
    return _safe_dead_slots(
        FluidBuckets3D(
            *fields, mask=new_mask.to(torch.float32), overflow=b.overflow + overflow,
        )
    )


def from_particles(
    p: Particles, cfg: MPMConfig, spec: FastSpec3D, device="cpu"
) -> FluidBuckets3D:
    """Dense Particles -> bucketed fast-path state (float32 on `device`)."""
    n = p.n
    to32 = lambda a: a.to(device=device, dtype=torch.float32)
    x, v, c, f = to32(p.x), to32(p.v), to32(p.C), to32(p.F)
    j = to32(p.J)
    zeros = torch.zeros((n,), dtype=torch.float32, device=device)
    flat = (
        x[:, 0], x[:, 1], x[:, 2], v[:, 0], v[:, 1], v[:, 2],
        *(c[:, a, e] for a in range(3) for e in range(3)),
        *(f[:, a, e] for a in range(3) for e in range(3)),
        j, to32(p.mass), to32(p.volume0),
        p.material.to(device=device, dtype=torch.int32),
        to32(p.Jp),
        j,        # jbar_s init = J
        zeros,    # p_s
        zeros,    # div_s
    )
    fields, mask, overflow = binning.bucket_by_row(
        _pair_row(flat[0], flat[1], cfg, spec),
        torch.ones((n,), dtype=torch.bool, device=device),
        flat, spec.rows0 * spec.rows1, spec.capacity,
    )
    return _safe_dead_slots(
        FluidBuckets3D(*fields, mask=mask.to(torch.float32), overflow=overflow)
    )


HOST_FIELDS = ("x0", "x1", "x2", "v0", "v1", "v2", "J", "mass", "mat", "Jp")


def to_host(b: FluidBuckets3D) -> dict:
    """Host-side dense view of active slots (diagnostics / IO), in
    pencil-major slot order: two device-to-host copies in all."""
    sel = b.mask > 0
    floats = [n for n in HOST_FIELDS if n != "mat"]
    stk = torch.stack([getattr(b, n)[sel] for n in floats]).cpu().numpy()
    out = dict(zip(floats, stk))
    out["mat"] = b.mat[sel].cpu().numpy()
    return {n: out[n] for n in HOST_FIELDS}


def check_supported(scene: Scene) -> None:
    """Raise NotImplementedError for configs outside the ported slice (the
    single-device fused branch of fast3d.substep)."""
    cfg = scene.cfg
    gaps = [
        (cfg.dim != 3, "fast3d needs a 3D config", 9),
        (cfg.use_fbar or cfg.pressure_mixing_ratio > 0.0,
         "F-bar / pressure mixing (extended 3D channels, kernel p2g3d)", 9),
        (cfg.kernel == KernelKind.TENT, "the 3D tent kernel (kernel p2g3d)", 9),
        (scene.materials_present != (mat.WEAKLY_COMPRESSIBLE_FLUID,),
         "3D materials other than one weakly-compressible fluid (kernel p2g3d)", 9),
        (bool(scene.colliders), "rigid SDF colliders", 8),
        (cfg.surface_tension > 0.0, "CSF surface tension", 8),
        (cfg.incompressible, "the incompressible projection", 8),
        (scene.mass_floor <= 0.0,
         "the relative mass floor in 3D (kernel p2g3d + the XLA grid update)", 9),
    ]
    for bad, what, item in gaps:
        if bad:
            raise NotImplementedError(
                f"fast3d port: {what} is not ported yet (ROADMAP queue 1, item {item})"
            )


def p2g_args(scene: Scene) -> dict:
    """Keyword arguments of `p2g3d_grid` for the scene (fast3d.py:608-627)."""
    cfg = scene.cfg
    g = cfg.num_grids
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    penalty = cfg.use_penalty_ebc
    return dict(
        g2=g, dx=float(cfg.dx),
        apic=cfg.transfer == TransferKind.APIC,
        stress="linear" if scene.params.eos == EOSKind.LINEAR else "tait",
        kb=float(scene.params.bulk_modulus),
        mu=float(scene.params.dynamic_viscosity),
        gamma=float(scene.params.tait_gamma),
        fa=float(-cfg.dt * dinv),
        dt=float(cfg.dt),
        grav=tuple(float(a) for a in cfg.gravity_acceleration(scene.physics)),
        floor=float(scene.mass_floor),
        lo=int(PAD), hi=g - 1 - int(PAD),
        wall="penalty" if penalty else scene.wall.kind,
        beta=float(cfg.penalty_parameter(scene.physics)) if penalty else 0.0,
    )


def transfer_inputs(b: FluidBuckets3D, spec: FastSpec3D, cfg: MPMConfig):
    """(planes, counts, mask, state) for the kernels, as (R0, R1, K) views:
    the 18 P2G planes [gx (3), v (3), C00..C22, J, mass, vol0], the pencil
    counts (R0 * R1,), the mask, and G2P's state [v (3), J, x (3)].

    P2G and G2P read one precomputed gx = x / dx + PAD (fast3d.py:551-560):
    computed in each kernel, FMA rounding could put a knife-edge particle
    into different cells in the two transfers."""
    shaped = lambda a: a.reshape(spec.rows0, spec.rows1, spec.capacity)
    invf = _f32(cfg.inv_dx)
    gxs = tuple(shaped(x * invf + PAD) for x in (b.x0, b.x1, b.x2))
    counts = (b.mask > 0).sum(dim=1).to(torch.int32)
    planes = (
        *gxs,
        *(shaped(getattr(b, n)) for n in ("v0", "v1", "v2")),
        *(shaped(getattr(b, f"C{a}{c}")) for a in range(3) for c in range(3)),
        shaped(b.J), shaped(b.mass), shaped(b.vol0),
    )
    state = tuple(shaped(getattr(b, n)) for n in ("v0", "v1", "v2", "J", "x0", "x1", "x2"))
    return planes, counts, shaped(b.mask), state


def substep(
    b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, plain: bool = False
) -> FluidBuckets3D:
    """One fast substep (fast3d.py:505-630, single-device fused branch).

    `plain=True` calls the kernels' plain PyTorch versions even on a card:
    it exists to time the plain path against the kernel path."""
    check_supported(scene)
    cfg = scene.cfg
    r0, r1 = spec.rows0, spec.rows1
    p2g, g2p = (
        (tk3.p2g3d_grid_plain, tk3.g2p3d_plain) if plain else (tk3.p2g3d_grid, tk3.g2p3d)
    )
    planes, counts, mask, state = transfer_inputs(b, spec, cfg)
    grid_pad = p2g(planes, counts, r1, **p2g_args(scene))
    out = g2p(
        *planes[:3], mask, counts, grid_pad, float(cfg.dx),
        float(4.0 * cfg.inv_dx * cfg.inv_dx), state, float(cfg.flip_blend), float(cfg.dt),
    ).view(r0 * r1, tk3.G2P_UPD, spec.capacity)
    return dataclasses.replace(
        b,
        x0=out[:, 0], x1=out[:, 1], x2=out[:, 2],
        v0=out[:, 3], v1=out[:, 4], v2=out[:, 5],
        C00=out[:, 6], C01=out[:, 7], C02=out[:, 8],
        C10=out[:, 9], C11=out[:, 10], C12=out[:, 11],
        C20=out[:, 12], C21=out[:, 13], C22=out[:, 14],
        J=out[:, 15],
    )


def _needs_rebucket(b: FluidBuckets3D, cfg: MPMConfig, spec: FastSpec3D) -> torch.Tensor:
    """True (a 0-dim bool tensor) when any active slot approaches the
    kernels' +-1-row margin on either bucketed axis (fast3d.py:937-949)."""
    s = b.shape[0]
    rows = torch.arange(s, dtype=torch.int32, device=b.device)[:, None]
    r0 = (rows // spec.rows1).to(torch.float32)
    r1 = (rows % spec.rows1).to(torch.float32)
    invf = _f32(cfg.inv_dx)
    on = b.mask > 0
    d0 = torch.where(on, b.x0 * invf + PAD - 0.5 - r0, 0.5)
    d1 = torch.where(on, b.x1 * invf + PAD - 0.5 - r1, 0.5)
    return ((d0 <= -0.8) | (d0 >= 1.8) | (d1 <= -0.8) | (d1 >= 1.8)).any()


def run(
    b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, n_substeps: int,
    stats: RunStats = None, plain: bool = False,
) -> FluidBuckets3D:
    """Advance n_substeps with adaptive rebucketing: before each substep,
    rebucket if the state fails the margin check (the order of
    fast3d.py:952-1008).  Reading the flag is one host sync per substep."""
    stats = RunStats() if stats is None else stats
    for _ in range(n_substeps):
        stats.host_reads += 1
        if bool(_needs_rebucket(b, scene.cfg, spec)):
            b = rebucket(b, scene.cfg, spec)
            stats.rebuckets += 1
        b = substep(b, scene, spec, plain=plain)
        stats.substeps += 1
    return b
