"""Fast 3D solver on the hand-written CUDA transfer kernels.

Counterpart of `mpm_flip98a_tpu/models/fast3d.py` on one device, routed
as fast3d.py:586-591 and :776-811 do (`uses_fused`, `scene.mass_floor`):

- one weakly-compressible fluid without F-bar, pressure mixing, the tent
  kernel, CSF or the projection, with an absolute grid-mass floor (the fused branch,
  fast3d.py:586-630): `p2g3d_grid` (kernel: stress, scatter, grid update)
  -> `g2p3d` (kernel: gather, FLIP blend, advection, J update).  No
  slot-sized pass runs outside the kernels except the transfer
  coordinates and the margin check;
- every other config (the prepped branch, fast3d.py:646-934: fluid,
  neo-Hookean, fixed-corotated, snow and Drucker-Prager sand mixed per
  slot; F-bar and pressure mixing with the lag correction; the tent
  kernel; CSF surface tension or the incompressible projection, which run
  on the grid in torch): the stress prepped in torch into separate planes,
  then with an absolute mass floor and neither CSF nor the projection
  `p2g3d_grid` in its prepped mode (kernel: scatter, grid update, the
  nodal Jbar, p and div), else (the relative floor, `Scene`'s default, or
  a grid-side extension: `ext_grid`, fast3d.py:578-591, :786) `p2g3d`
  (kernel) -> `fold_rows0` -> `_grid_update`;
  then `g2p3d` in gather mode (kernel) -> the tent's per-particle D^-1 ->
  the particle update, which ends in `materials.plastic_update` for snow,
  sand and the corotated clamp (on the live plastic slots only).

PIC or APIC with the FLIP blend, linear or Tait EOS, slip or sticky walls
or the penalty EBC, CSF surface tension, rigid SDF colliders (static or
kinematic: inside `p2g3d_grid`'s node pass, or in `_grid_update` on the
`p2g3d` and sharded routes) and the incompressible projection; all on
float32 tensors on one device.

State lives in pencil buckets: one bucket of K slots per (axis-0, axis-1)
grid line, fields (R0 * R1, K).  `run` keeps the reference's order (a
rebucket happens before the first substep whose state fails the margin
check on either bucketed axis); in eager PyTorch that costs one
device-to-host read of the check per substep, counted in `RunStats`.

`substep(..., domain=ctx)` runs either branch on the shards of
parallel/fast_domain3d.py (fast3d.py:518-544, 631-644, 776-784): n0 slabs
of L0 axis-0 rows, or n0 x n1 windows of (L0, L1) pencils: positions
shifted by the window's origin for the kernels, `p2g3d_grid`'s raw halo
sums, the halo exchange (axis 0, then axis 1), `_grid_update` on the halo
planes with each shard's global row indices on both axes (CSF and the
projection refresh the halo planes with `halo_gather_only` and count the
nodes each shard owns on both axes), and `g2p3d` on each shard's padded
window.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import colliders
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models.fast2d import (
    RunStats, _ext, _f32, plastic_materials, substep_times,
)
from mpm_flip98a_tpu_torch.models.stabilized import (
    PAD, Scene, _csf_increment, _mass_floor, _project_grid,
)
from mpm_flip98a_tpu_torch.ops import binning
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
from mpm_flip98a_tpu_torch.state import Particles, host_array


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
    # F-bar / mixing state: the nodal Jbar, p and div that the last G2P
    # gathered (one-substep lag; unused without F-bar or mixing).
    jbar_s: torch.Tensor
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
        x = host_array(p.x)
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
    p: Particles, cfg: MPMConfig, spec: FastSpec3D, device="cuda"
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


def check_supported(scene: Scene, sharded: bool = False) -> None:
    """Raise for a config that is not 3D (ValueError) and for the one the
    reference cannot route (NotImplementedError)."""
    cfg = scene.cfg
    if cfg.dim != 3:
        raise ValueError("fast3d runs 3D configs; a 2D config takes models/fast2d")
    if uses_fused(scene) and scene.mass_floor <= 0.0 and not sharded:
        # fast3d.py:601-645 sends such a scene on one device to the
        # sharded tail, which calls halo_sync on no domain.
        raise NotImplementedError(
            "fast3d port: the relative mass floor on the fused branch has no "
            "single-device route (the reference's raises; ROADMAP queue 3)"
        )


def ext_grid(cfg: MPMConfig) -> bool:
    """CSF or the projection: grid-side work in torch between the P2G sums
    and G2P, so no kernel may finish the grid (fast3d.py:578)."""
    return bool(cfg.incompressible or cfg.surface_tension > 0.0)


def uses_fused(scene: Scene) -> bool:
    """The predicate of fast3d.py:586-591: one weakly-compressible fluid,
    no F-bar or pressure mixing, the B-spline kernel and no `ext_grid`;
    every other config preps its fields in torch."""
    return (
        scene.materials_present == (mat.WEAKLY_COMPRESSIBLE_FLUID,)
        and not _ext(scene.cfg)
        and scene.cfg.kernel != KernelKind.TENT
        and not ext_grid(scene.cfg)
    )


def kernel_grid(scene: Scene) -> bool:
    """Does `p2g3d_grid` finish the grid on one device (fast3d.py:786)?  The
    fused branch always; the prepped one with an absolute mass floor and
    no `ext_grid`, else `p2g3d` + `fold_rows0` + `_grid_update`."""
    return uses_fused(scene) or (scene.mass_floor > 0.0 and not ext_grid(scene.cfg))


def _wall_args(scene: Scene) -> dict:
    """The grid-update arguments of `p2g3d_grid` (fast3d.py:608-627), the
    scene's colliders included; the caller adds `tcol`."""
    cfg = scene.cfg
    penalty = cfg.use_penalty_ebc
    return dict(
        dt=float(cfg.dt),
        grav=tuple(float(a) for a in cfg.gravity_acceleration(scene.physics)),
        floor=float(scene.mass_floor),
        lo=int(PAD), hi=cfg.num_grids - 1 - int(PAD),
        wall="penalty" if penalty else scene.wall.kind,
        beta=float(cfg.penalty_parameter(scene.physics)) if penalty else 0.0,
        colliders=tuple(scene.colliders),
    )


def p2g_args(scene: Scene, raw: bool = False) -> dict:
    """Keyword arguments of the scene's P2G wrapper after (fields, counts,
    g1): the stress mode of `p2g3d_grid` (fast3d.py:608-627) for a
    `uses_fused` scene; for the others its prepped mode (:797-802) where
    `kernel_grid`, else `p2g3d` (:805-808).  `raw`: the scatter's arguments
    alone, for `p2g3d_grid`'s raw mode (slab shards)."""
    cfg = scene.cfg
    apic = cfg.transfer == TransferKind.APIC
    args = dict(g2=cfg.num_grids, dx=float(cfg.dx), apic=apic)
    if uses_fused(scene):
        dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
        args.update(
            stress="linear" if scene.params.eos == EOSKind.LINEAR else "tait",
            kb=float(scene.params.bulk_modulus),
            mu=float(scene.params.dynamic_viscosity),
            gamma=float(scene.params.tait_gamma),
            fa=float(-cfg.dt * dinv),
        )
    else:
        args.update(ext=_ext(cfg), tent=cfg.kernel == KernelKind.TENT)
    if not raw and kernel_grid(scene):
        args.update(_wall_args(scene))
    return args


def _shaped(a: torch.Tensor, spec: FastSpec3D) -> torch.Tensor:
    return a.reshape(spec.rows0, spec.rows1, spec.capacity)


def _gxs(b: FluidBuckets3D, spec: FastSpec3D, cfg: MPMConfig, x0k=None, x1k=None):
    """The transfer coordinates gx = x / dx + PAD as (R0, R1, K) planes.

    P2G and G2P read this one precomputed gx (fast3d.py:551-560): computed
    in each kernel, FMA rounding could put a knife-edge particle into
    different cells in the two transfers.  `x0k` / `x1k` replace x0 / x1:
    on shards, x less the window's origin (fast3d.py:518-544)."""
    invf = _f32(cfg.inv_dx)
    x0 = b.x0 if x0k is None else x0k
    x1 = b.x1 if x1k is None else x1k
    return tuple(_shaped(x * invf + PAD, spec) for x in (x0, x1, b.x2))


def pencil_counts(b: FluidBuckets3D) -> torch.Tensor:
    """Active slots per pencil, (R0 * R1,) int32 (buckets are packed)."""
    return (b.mask > 0).sum(dim=1).to(torch.int32)


def transfer_inputs(b: FluidBuckets3D, spec: FastSpec3D, cfg: MPMConfig, x0k=None, x1k=None):
    """(planes, counts, mask, state) for the fused branch's kernels, as
    (R0, R1, K) views: the 18 P2G planes [gx (3), v (3), C00..C22, J, mass,
    vol0], the pencil counts (R0 * R1,), the mask, and G2P's state [v (3),
    J, x (3)], x0 and x1 replaced by `x0k` and `x1k` on shards."""
    shaped = lambda a: _shaped(a, spec)
    planes = (
        *_gxs(b, spec, cfg, x0k, x1k),
        *(shaped(getattr(b, n)) for n in ("v0", "v1", "v2")),
        *(shaped(getattr(b, f"C{a}{c}")) for a in range(3) for c in range(3)),
        shaped(b.J), shaped(b.mass), shaped(b.vol0),
    )
    x0 = b.x0 if x0k is None else x0k
    x1 = b.x1 if x1k is None else x1k
    state = (*(shaped(getattr(b, n)) for n in ("v0", "v1", "v2", "J")),
             shaped(x0), shaped(x1), shaped(b.x2))
    return planes, pencil_counts(b), shaped(b.mask), state


def _sharded_grid(fields, counts, scene: Scene, spec: FastSpec3D, plain: bool, domain, t=None):
    """`p2g3d_grid`'s raw halo sums on the shards' windows, the halo
    exchange, then `_grid_update` at time `t` on the (n, L0 + 4, L1 + 4)
    halo planes with each shard's global rows on both axes (fast3d.py:
    457-466, 776-784) -> each shard's G2P grid (n, L0 + 4, L1 + 4, 6 or 9,
    G2)."""
    kw = dict(shards=domain.blocks, **p2g_args(scene, raw=True))
    if plain:
        raw = tk3.p2g3d_raw_plain(fields, counts, **kw)
    else:
        raw = tk3.p2g3d_grid(fields, counts, spec.rows1, raw=True, **kw)
    dev = counts.device
    return _grid_update(domain.halo_sync(raw), scene, domain.row_index0(dev),
                        domain.row_index1(dev), t, domain)


def _shifts(b: FluidBuckets3D, cfg: MPMConfig, domain):
    """The shard windows' (x0, x1) origins per pencil, None where the axis
    is not sharded."""
    if domain is None:
        return None, None
    return domain.x0_shift(b.device, cfg), domain.x1_shift(b.device, cfg)


def _fused_substep(b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, plain: bool, domain=None,
                   t=None):
    """The fused branch (fast3d.py:592-644 and `_finish_substep`).  On
    shards the kernels see x0 (and, on two axes, x1) less the window's
    origin, and the origin is added back to the advected x (dead slots:
    (0 - a) + a == 0)."""
    cfg = scene.cfg
    r0, r1 = spec.rows0, spec.rows1
    g2p = tk3.g2p3d_plain if plain else tk3.g2p3d
    x0_shift, x1_shift = _shifts(b, cfg, domain)
    planes, counts, mask, state = transfer_inputs(
        b, spec, cfg, None if x0_shift is None else b.x0 - x0_shift,
        None if x1_shift is None else b.x1 - x1_shift)
    if domain is None:
        p2g = tk3.p2g3d_grid_plain if plain else tk3.p2g3d_grid
        grid_pad = p2g(planes, counts, r1, **p2g_args(scene), tcol=t)
    else:
        grid_pad = _sharded_grid(planes, counts, scene, spec, plain, domain, t)
    out = g2p(
        *planes[:3], mask, counts, grid_pad, float(cfg.dx),
        float(4.0 * cfg.inv_dx * cfg.inv_dx), state, float(cfg.flip_blend), float(cfg.dt),
    ).view(r0 * r1, tk3.G2P_UPD, spec.capacity)
    return dataclasses.replace(
        b,
        x0=out[:, 0] if x0_shift is None else out[:, 0] + x0_shift,
        x1=out[:, 1] if x1_shift is None else out[:, 1] + x1_shift,
        x2=out[:, 2],
        v0=out[:, 3], v1=out[:, 4], v2=out[:, 5],
        C00=out[:, 6], C01=out[:, 7], C02=out[:, 8],
        C10=out[:, 9], C11=out[:, 10], C12=out[:, 11],
        C20=out[:, 12], C21=out[:, 13], C22=out[:, 14],
        J=out[:, 15],
    )


# ---------------------------------------------------------------------------
# The prepped branch (fast3d.py:646-934)
# ---------------------------------------------------------------------------


def _cmat(b: FluidBuckets3D):
    return [getattr(b, f"C{a}{c}") for a in range(3) for c in range(3)]


def _fmat(b: FluidBuckets3D):
    return [getattr(b, f"F{a}{c}") for a in range(3) for c in range(3)]


def _fmat3(f) -> torch.Tensor:
    """Stack the 9-list [F00..F22] of (..., K) planes into (..., K, 3, 3)."""
    return torch.stack([torch.stack(f[3 * a : 3 * a + 3], -1) for a in range(3)], -2)


def _slots_of(b: FluidBuckets3D, ids: Tuple[int, ...]):
    """Index tensors of the live slots whose material is one of `ids`: the
    SVD-based sand stress and plastic update run there alone, because a
    3D layout holds several slots a particle (drop3d: 21M for 3.5M) and
    the plastic block is a part of the scene.  Reading the count is one
    device-to-host synchronisation."""
    sel = b.mask > 0
    on = b.mat == ids[0]
    for m in ids[1:]:
        on = on | (b.mat == m)
    return torch.nonzero(sel & on, as_tuple=True)


def _det3(m):
    return (
        m[0] * (m[4] * m[8] - m[5] * m[7])
        - m[1] * (m[3] * m[8] - m[5] * m[6])
        + m[2] * (m[3] * m[7] - m[4] * m[6])
    )


def _polar3d_rows(f, iters: int = 12):
    """Component-form 3D polar rotation factor (fast3d.py:256-288): the
    scaled Newton iteration R <- (gamma R + R^-T / gamma) / 2 on the 9
    component planes [F00..F22]; returns the 9-list R.  The determinant is
    guarded with float32's tiny, and dead slots sit at F = I."""
    r = list(f)

    def cof(m):
        # Cofactor matrix, row-major: cof / det = m^-T.
        return [
            m[4] * m[8] - m[5] * m[7], m[5] * m[6] - m[3] * m[8], m[3] * m[7] - m[4] * m[6],
            m[2] * m[7] - m[1] * m[8], m[0] * m[8] - m[2] * m[6], m[1] * m[6] - m[0] * m[7],
            m[1] * m[5] - m[2] * m[4], m[2] * m[3] - m[0] * m[5], m[0] * m[4] - m[1] * m[3],
        ]

    tiny = float(np.finfo(np.float32).tiny)
    for _ in range(iters):
        c = cof(r)
        det = r[0] * c[0] + r[1] * c[1] + r[2] * c[2]
        inv_det = 1.0 / torch.where(det.abs() > tiny, det, 1.0)
        rit = [ci * inv_det for ci in c]
        a = sum(x * x for x in rit)
        bb = sum(x * x for x in r)
        gamma = torch.sqrt(torch.sqrt(a / bb.clamp(min=tiny)))
        inv_g = 1.0 / gamma
        r = [0.5 * (gamma * r[i] + inv_g * rit[i]) for i in range(9)]
    return r


def _stress(b: FluidBuckets3D, scene: Scene):
    """Component-form V0-scaled Kirchhoff stress per slot (fast3d.py:
    646-744), the models of models/materials.py on (R0 * R1, K) planes.

    F-bar and pressure mixing read the nodal averages that the last
    substep's G2P gathered (jbar_s, p_s, div_s), advanced over the
    one-substep lag by their local rates (dJ/dt = J div, dp/dt = dp/dJ J
    div with div = tr C).  Scalars combine in float32 where the reference
    holds float32 values and as Python floats where it keeps weak types.
    Returns (tau, p_point, div_lag): the 9-list tau00..tau22, the fluid's
    pointwise pressure on every slot (zero without a fluid), and tr C."""
    cfg, params = scene.cfg, scene.params
    dt = _f32(cfg.dt)
    ratio = float(cfg.pressure_mixing_ratio)
    cm, fm = _cmat(b), _fmat(b)
    div_lag = cm[0] + cm[4] + cm[8]
    jbar_adv = b.jbar_s * (1.0 + dt * div_lag) if _ext(cfg) else b.jbar_s
    jeff = jbar_adv if cfg.use_fbar else b.J
    p_point_out = torch.zeros_like(b.J)
    tau = [torch.zeros_like(b.J)] * 9
    mu_s, lam_s = _f32(params.mu), _f32(params.lam)
    diag = (0, 4, 8)
    for mid in scene.materials_present:
        if mid == mat.WEAKLY_COMPRESSIBLE_FLUID:
            kb = np.float32(params.bulk_modulus)
            two_mu = 2.0 * _f32(params.dynamic_viscosity)
            vj = b.vol0 * jeff
            if params.eos == EOSKind.LINEAR:
                p_point = float(-kb) * (jeff - 1.0)
            else:
                gamma = np.float32(params.tait_gamma)
                j_safe = jeff.clamp(min=_f32(1e-3))
                p_point = float(kb / gamma) * ((1.0 / j_safe) ** float(gamma) - 1.0)
            p_point_out = p_point
            if ratio > 0.0:
                if params.eos == EOSKind.LINEAR:
                    dp_dt = float(-kb) * jeff * div_lag
                else:
                    dp_dt = float(-kb) * (1.0 / j_safe) ** float(gamma) * div_lag
                pressure = ratio * (b.p_s + dt * dp_dt) + (1.0 - ratio) * p_point
            else:
                pressure = p_point
            third = div_lag / 3.0
            tl = []
            for a in range(3):
                for c in range(3):
                    dev = 0.5 * (cm[3 * a + c] + cm[3 * c + a])
                    if a == c:
                        tl.append(vj * (-pressure + two_mu * (dev - third)))
                    elif c < a:
                        tl.append(tl[3 * c + a])    # symmetric
                    else:
                        tl.append(vj * (two_mu * dev))
        elif mid == mat.NEO_HOOKEAN:
            # V0 (mu (F F^T - I) + lam log(J) I), J floored at 1e-6.
            lj = lam_s * torch.log(_det3(fm).clamp(min=_f32(1e-6)))
            tl = []
            for a in range(3):
                for c in range(3):
                    if c < a:
                        tl.append(tl[3 * c + a])
                        continue
                    ffr = sum(fm[3 * a + e] * fm[3 * c + e] for e in range(3))
                    tl.append(b.vol0 * (mu_s * (ffr - 1.0) + lj) if a == c
                              else b.vol0 * (mu_s * ffr))
        elif mid == mat.SAND:
            # materials.sand_tau_hat on stacked (..., 3, 3) F (fast3d.py:
            # 683-695), on the live sand slots only: elsewhere the result
            # is discarded (another material) or zero (a dead slot, F = I).
            idx = _slots_of(b, (mat.SAND,))
            tm = mat.sand_tau_hat(params, b.vol0[idx], _fmat3([f[idx] for f in fm]))
            zero = torch.zeros_like(b.J)
            tl = [zero.index_put(idx, tm[:, a, c]) for a in range(3) for c in range(3)]
        else:  # FIXED_COROTATED / SNOW: V0 (2 mu (F - R) F^T + lam (J - 1) J I)
            mu_m, lam_m = mu_s, lam_s
            if mid == mat.SNOW:
                # Lame parameters hardened by the tracked plastic volume
                # (mls-mpm88-explained.cpp:67-69; fast3d.py:713-720).
                h = torch.exp(_f32(params.hardening) * (1.0 - b.Jp))
                mu_m, lam_m = mu_s * h, lam_s * h
            rrot = _polar3d_rows(fm)
            jf = _det3(fm)
            lj = lam_m * (jf - 1.0) * jf
            two_mu_s = 2.0 * mu_m
            df = [fm[i] - rrot[i] for i in range(9)]
            tl = []
            for a in range(3):
                for c in range(3):
                    dfr = sum(df[3 * a + e] * fm[3 * c + e] for e in range(3))
                    tl.append(b.vol0 * (two_mu_s * dfr + lj) if a == c
                              else b.vol0 * (two_mu_s * dfr))
        if len(scene.materials_present) == 1:
            tau = tl
        else:
            sel = b.mat == mid
            tau = [torch.where(sel, t, acc) for t, acc in zip(tl, tau)]
    return tau, p_point_out, div_lag


def prepped_fields(b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, x0k=None, x1k=None):
    """The prepped P2G planes (fast3d.py:746-773), each a separate (R0, R1,
    K) tensor: [gx (3), m v (3), P (9, APIC only), Q (9), m] + [V0 J, V0,
    V0 p, V0 div] under F-bar or mixing; every value plane masked.
    P = m C, Q = P - dt D^-1 tau; gx0 and gx1 from `x0k` and `x1k` on
    shards."""
    cfg = scene.cfg
    shaped = lambda a: _shaped(a, spec)
    tau, p_point, div_lag = _stress(b, scene)
    fa = float(-np.float32(cfg.dt) * np.float32(4.0 * cfg.inv_dx * cfg.inv_dx))
    m = b.mass * b.mask
    if cfg.transfer == TransferKind.APIC:
        p_aff = [b.mass * c * b.mask for c in _cmat(b)]
        q_aff = [p + fa * t * b.mask for p, t in zip(p_aff, tau)]
    else:
        p_aff = []
        q_aff = [fa * t * b.mask for t in tau]
    fields = [*_gxs(b, spec, cfg, x0k, x1k), *(shaped(m * v) for v in (b.v0, b.v1, b.v2)),
              *map(shaped, p_aff), *map(shaped, q_aff), shaped(m)]
    if _ext(cfg):
        v0m = b.vol0 * b.mask
        fields += [shaped(v0m * b.J), shaped(v0m), shaped(v0m * p_point), shaped(v0m * div_lag)]
    return tuple(fields)


def _plane_index(idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Node indices along grid axis `axis`, broadcastable against (G0, G1,
    G2) planes, or against (n, ...) shard planes when `idx` is a per-shard
    (n, rows) table."""
    shape = [1, 1, 1]
    shape[axis] = -1
    if idx.dim() == 2:
        shape = [idx.shape[0]] + shape
    return idx.reshape(shape)


def _axis_bands(cfg: MPMConfig, device, row_index0=None, row_index1=None):
    """(low, high) wall-band masks per axis, broadcastable against (...,
    G0, G1, G2) planes: box faces at PAD / G-1-PAD (fast3d.py:200-217).
    `row_index0` / `row_index1` carry the planes' global axis-0 / axis-1
    node indices (shards: (n, L0 + 4) and (n, L1 + 4))."""
    g = cfg.num_grids
    lo, hi = int(PAD), g - 1 - int(PAD)
    idx = torch.arange(g, device=device)
    rows = (idx if row_index0 is None else row_index0, idx if row_index1 is None else row_index1,
            idx)
    return [(_plane_index(r, a) <= lo, _plane_index(r, a) >= hi) for a, r in enumerate(rows)]


def _grid_update(gs: torch.Tensor, scene: Scene, row_index0=None, row_index1=None,
                 t=None, domain=None) -> torch.Tensor:
    """Grid momentum update on the fold's (G0, G1, 7 or 11, G2) layout
    (fast3d.py:291-430): mass floor (relative when `scene.mass_floor <= 0`:
    a device-side max), gravity, CSF surface tension, slip or sticky walls
    (`_wall_bc_ch`) or the penalty EBC (`_wall_normal_diag_ch`: the box's
    penalty matrix is diagonal), the scene's rigid colliders at simulation
    time `t` (fast3d.py:371-393), then the incompressible projection with
    the colliders' interiors as solid.  Returns the unpadded (G0, G1, 6 or
    9, G2) grid = [v_new (3), v_old (3)] + the nodal [Jbar, p, div] under
    F-bar or mixing.

    Slab shards (`domain`) pass the halo-synced (n, L0 + 4, R1 + 4, nch,
    G2) sums with their global row indices; the grid update's relative
    floor is then each shard's own (the reference's _mass_floor on
    shard-local sums takes no pmax; ROADMAP queue 3), the projection's the
    max over the shards (fast3d.py:400-403), and CSF and the CG refresh the
    halo planes with `domain.halo_gather_only` (fast3d.py:319-333)."""
    cfg = scene.cfg
    dt = np.float32(cfg.dt)
    g_m = gs[..., 6, :]
    has = g_m > _mass_floor(scene, g_m, sharded=gs.dim() == 5)
    safe = torch.where(has, g_m, 1.0)
    v_old = [torch.where(has, gs[..., a, :] / safe, 0.0) for a in range(3)]
    grav = np.asarray(cfg.gravity_acceleration(scene.physics), np.float32)
    bands = _axis_bands(cfg, gs.device, row_index0, row_index1)
    st = None
    if cfg.surface_tension > 0.0:
        # CSF on the (G0, G1, G2) mass field, the general path's force, as
        # a momentum increment per component (fast3d.py:334-350).
        st = _csf_increment(g_m, scene, domain).unbind(-1)
    if cfg.use_penalty_ebc:
        dt_beta = float(dt * np.float32(cfg.penalty_parameter(scene.physics)))
        dtm = float(dt) * g_m
        v = []
        for a, (low, high) in enumerate(bands):
            rhs = gs[..., 3 + a, :] + dtm * float(grav[a])
            if st is not None:
                rhs = rhs + st[a]
            v.append(torch.where(has, rhs / (g_m + dt_beta * (low | high).to(g_m.dtype)), 0.0))
    else:
        hasf = has.to(g_m.dtype)
        v = [
            torch.where(has, gs[..., 3 + a, :] / safe, 0.0) + float(dt * grav[a]) * hasf
            for a in range(3)
        ]
        if st is not None:
            # (mv + dt F m/rho) / m == mv / m + st / m (fast3d.py:352-369).
            v = [va + torch.where(has, sa / safe, 0.0) for va, sa in zip(v, st)]
        if scene.wall.kind == "sticky":
            anyband = torch.zeros((), dtype=torch.bool, device=gs.device)
            for low, high in bands:
                anyband = anyband | low | high
            v = [torch.where(anyband, 0.0, va) for va in v]
        else:   # slip: clamp the outgoing normal component per axis band
            for a, (low, high) in enumerate(bands):
                v[a] = torch.where(low, v[a].clamp(min=0.0), v[a])
                v[a] = torch.where(high, v[a].clamp(max=0.0), v[a])
    col_solid = None
    if scene.colliders:
        # Pointwise, after the wall or penalty BC, at global node indices.
        dev = gs.device
        idx0 = torch.arange(gs.shape[-4], device=dev) if row_index0 is None else row_index0
        idx1 = torch.arange(gs.shape[-3], device=dev) if row_index1 is None else row_index1
        idx2 = torch.arange(gs.shape[-1], device=dev)
        coords = colliders.node_coords(
            cfg, [_plane_index(i, a) for a, i in enumerate((idx0, idx1, idx2))], g_m.dtype)
        v = colliders.project(v, coords, scene.colliders, t)
        col_solid = colliders.inside_any(coords, scene.colliders, t)
    if cfg.incompressible:
        # The Chorin projection on the three velocity planes (fast3d.py:
        # 394-415); slab shards own axis-0 rows [1, 1 + L0) of L0 + 4.
        v = _project_grid(v, g_m, scene, col_solid, row_index0, row_index1, domain)
    gch = v + v_old
    if gs.shape[-2] == tk3.P2G_CH_EXT:
        # Nodal averages for the next substep's stress: Jbar, p, div, with
        # 1 / 0 / 0 where no volume landed.
        v0sum = gs[..., 8, :]
        has_v = v0sum > 0
        safe_v = torch.where(has_v, v0sum, 1.0)
        gch.append(torch.where(has_v, gs[..., 7, :] / safe_v, 1.0))
        gch.append(torch.where(has_v, gs[..., 9, :] / safe_v, 0.0))
        gch.append(torch.where(has_v, gs[..., 10, :] / safe_v, 0.0))
    return torch.stack(gch, dim=-2)


def _tent_inverse_d(gxs, dx: float):
    """The 6 distinct entries (00, 01, 02, 11, 12, 22) of the symmetric
    per-particle D^-1 for the tent kernel (fast3d.py:823-859): D = sum w
    dpos dpos^T is separable for a tensor-product kernel, D_aa = s2(gx_a),
    D_ab = s1(gx_a) s1(gx_b), regularised by 1e-12 on the diagonal."""
    dxf = _f32(dx)

    def axis_d(gx):
        base = torch.floor(gx - 0.5)
        fx = gx - base
        w = tk3._taps(fx, True)
        s1 = sum(w[i] * (i - fx) for i in range(3)) * dxf
        s2 = sum(w[i] * (i - fx) ** 2 for i in range(3)) * dxf * dxf
        return s1, s2

    (s0, d00), (s1, d11), (s2, d22) = (axis_d(gx) for gx in gxs)
    eps = _f32(1e-12)
    d00, d11, d22 = d00 + eps, d11 + eps, d22 + eps
    d01, d02, d12 = s0 * s1, s0 * s2, s1 * s2
    co00 = d11 * d22 - d12 * d12
    co01 = d02 * d12 - d01 * d22
    co02 = d01 * d12 - d02 * d11
    co11 = d00 * d22 - d02 * d02
    co12 = d01 * d02 - d00 * d12
    co22 = d00 * d11 - d01 * d01
    det = d00 * co00 + d01 * co01 + d02 * co02
    return tuple(co / det for co in (co00, co01, co02, co11, co12, co22))


def _prepped_substep(b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, plain: bool,
                     domain=None, t=None):
    """The prepped branch (fast3d.py:646-934): stress prep, P2G by the
    mass floor's route (on slab shards always `p2g3d_grid`'s raw mode),
    gather-mode G2P, the particle update."""
    cfg = scene.cfg
    r0, r1, k = spec.rows0, spec.rows1, spec.capacity
    dt = _f32(cfg.dt)
    dx = float(cfg.dx)
    tent = cfg.kernel == KernelKind.TENT
    ext = _ext(cfg)
    x0_shift, x1_shift = _shifts(b, cfg, domain)
    fields = prepped_fields(b, scene, spec, None if x0_shift is None else b.x0 - x0_shift,
                            None if x1_shift is None else b.x1 - x1_shift)
    del x0_shift, x1_shift
    counts = pencil_counts(b)
    args = p2g_args(scene)
    if domain is not None:
        grid = _sharded_grid(fields, counts, scene, spec, plain, domain, t)
    elif kernel_grid(scene):
        # Absolute floor, no ext_grid: scatter, fold and grid update in one
        # wrapper; the grid comes out padded on both axes.
        p2g = tk3.p2g3d_grid_plain if plain else tk3.p2g3d_grid
        grid = p2g(fields, counts, r1, **args, tcol=t)
    else:
        p2g = tk3.p2g3d_plain if plain else tk3.p2g3d
        grid = _grid_update(tk3.fold_rows0(p2g(fields, counts, r1, **args)), scene, t=t)
    gxs = fields[:3]
    del fields
    g2p = tk3.g2p3d_plain if plain else tk3.g2p3d
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    out = g2p(
        *gxs, _shaped(b.mask, spec), counts, grid, dx, 1.0 if tent else dinv, tent=tent,
    ).view(r0 * r1, -1, k)
    del grid
    vpic = [out[:, a] for a in range(3)]
    vold = [out[:, 3 + a] for a in range(3)]
    c_new = [out[:, 6 + i] for i in range(9)]
    if tent:
        # G2P returned the raw B = sum w v dpos^T (dinv = 1): C = B D^-1.
        i00, i01, i02, i11, i12, i22 = _tent_inverse_d(
            [gx.reshape(r0 * r1, k) for gx in gxs], dx)
        dinv_m = ((i00, i01, i02), (i01, i11, i12), (i02, i12, i22))
        c_new = [
            sum(c_new[3 * a + e] * dinv_m[e][c] for e in range(3))
            for a in range(3) for c in range(3)
        ]

    # Particle update (fast3d.py:867-934): FLIP blend, advection, F and J.
    alpha = _f32(cfg.flip_blend)
    one_m_alpha = float(np.float32(1.0) - np.float32(alpha))
    nv = [
        alpha * (vv + vp - vo) + one_m_alpha * vp
        for vv, vp, vo in zip((b.v0, b.v1, b.v2), vpic, vold)
    ]
    div_new = c_new[0] + c_new[4] + c_new[8]
    ratio = float(cfg.pressure_mixing_ratio)
    if ratio > 0.0:
        # The mixed divergence drives the volumetric update (one-substep lag).
        div_for_j = ratio * b.div_s + (1.0 - ratio) * div_new
    else:
        div_for_j = div_new
    on = b.mask > 0
    if ext:
        jbar_new = torch.where(on, out[:, 15], 1.0)
        p_new = out[:, 16] * b.mask
        div_s_new = out[:, 17] * b.mask
    else:
        jbar_new, p_new, div_s_new = b.jbar_s, b.p_s, b.div_s
    fm = _fmat(b)
    jp_new = b.Jp
    if scene.materials_present != (mat.WEAKLY_COMPRESSIBLE_FLUID,):
        # F <- (I + dt C) F; the fluid's stress never reads F, so a
        # fluid-only scene leaves it alone.
        fm = [
            sum(
                ((1.0 + dt * c_new[3 * a + e]) if a == e else dt * c_new[3 * a + e])
                * fm[3 * e + c]
                for e in range(3)
            )
            for a in range(3) for c in range(3)
        ]
        if plastic_materials(scene):
            # The snow clamp with Jp tracking, or sand's cone projection
            # (fast3d.py:883-910), on the live slots of the plastic
            # materials: it leaves the others' F and Jp as they are, and
            # dead slots (F = I, Jp = 1) unchanged.
            idx = _slots_of(b, plastic_materials(scene))
            fm3, jp_sub = mat.plastic_update(scene.params, b.mat[idx],
                                             _fmat3([f[idx] for f in fm]), jp_new[idx],
                                             scene.materials_present)
            fm = [f.index_put(idx, fm3[:, i // 3, i % 3]) for i, f in enumerate(fm)]
            jp_new = jp_new.index_put(idx, jp_sub)
    return dataclasses.replace(
        b,
        x0=b.x0 + dt * vpic[0] * b.mask,
        x1=b.x1 + dt * vpic[1] * b.mask,
        x2=b.x2 + dt * vpic[2] * b.mask,
        v0=nv[0] * b.mask, v1=nv[1] * b.mask, v2=nv[2] * b.mask,
        **{f"C{a}{c}": c_new[3 * a + c] for a in range(3) for c in range(3)},
        **{f"F{a}{c}": fm[3 * a + c] for a in range(3) for c in range(3)},
        J=torch.where(on, b.J * (1.0 + dt * div_for_j), 1.0), Jp=jp_new,
        jbar_s=jbar_new, p_s=p_new, div_s=div_s_new,
    )


def substep(
    b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, plain: bool = False, domain=None,
    t=None,
) -> FluidBuckets3D:
    """One fast substep (fast3d.py:505-934); `t` (simulation seconds, a
    host scalar) advects kinematic colliders.

    `uses_fused` configs compute the stress inside `p2g3d_grid` and update
    the particles inside `g2p3d` (absolute mass floor only); the others
    prep their fields in torch and take `p2g3d_grid`'s prepped mode or,
    where not `kernel_grid`, `p2g3d`, then the gather-mode `g2p3d` and the
    particle update.  `domain`
    (parallel/fast_domain3d.FastDomain3DCtx) runs both branches on its slab
    shards through `p2g3d_grid`'s raw mode; `spec` is then the global
    layout's (n L0 axis-0 rows).
    `plain=True` calls the kernels' plain PyTorch versions even on a card:
    it exists to time the plain path against the kernel path."""
    check_supported(scene, sharded=domain is not None)
    if uses_fused(scene):
        return _fused_substep(b, scene, spec, plain, domain, t)
    return _prepped_substep(b, scene, spec, plain, domain, t)


def _margin_pencils(b: FluidBuckets3D, cfg: MPMConfig, spec: FastSpec3D, row0=0,
                    row1=0) -> torch.Tensor:
    """(R0 R1,) bool: pencils with an active slot near the kernels' +-1-row
    margin on either bucketed axis (fast3d.py:937-949).  A pencil's rows
    are its row in `spec`'s layout plus `row0` / `row1` (scalars or (R0
    R1, 1) tensors): the stacked shard windows' offsets to their global
    rows (`FastDomain3DCtx.pencil_offsets`; 0 on one axis, whose layout is
    already global)."""
    s = b.shape[0]
    rows = torch.arange(s, dtype=torch.int32, device=b.device)[:, None]
    r0 = (row0 + rows // spec.rows1).to(torch.float32)
    r1 = (row1 + rows % spec.rows1).to(torch.float32)
    invf = _f32(cfg.inv_dx)
    on = b.mask > 0
    d0 = torch.where(on, b.x0 * invf + PAD - 0.5 - r0, 0.5)
    d1 = torch.where(on, b.x1 * invf + PAD - 0.5 - r1, 0.5)
    return ((d0 <= -0.8) | (d0 >= 1.8) | (d1 <= -0.8) | (d1 >= 1.8)).any(dim=1)


def _needs_rebucket(b: FluidBuckets3D, cfg: MPMConfig, spec: FastSpec3D, row0=0,
                    row1=0) -> torch.Tensor:
    """True (a 0-dim bool tensor) when any active slot approaches the
    kernels' +-1-row margin on either bucketed axis (`_margin_pencils`)."""
    return _margin_pencils(b, cfg, spec, row0, row1).any()


def run(
    b: FluidBuckets3D, scene: Scene, spec: FastSpec3D, n_substeps: int,
    stats: RunStats = None, plain: bool = False, t0=None,
) -> FluidBuckets3D:
    """Advance n_substeps with adaptive rebucketing: before each substep,
    rebucket if the state fails the margin check (the order of
    fast3d.py:952-1008).  Reading the flag is one host sync per substep.
    `t0` drives kinematic colliders: substep j sees t = t0 + j dt
    (`fast2d.substep_times`)."""
    stats = RunStats() if stats is None else stats
    for t in substep_times(scene, t0, n_substeps):
        stats.host_reads += 1
        if bool(_needs_rebucket(b, scene.cfg, spec)):
            b = rebucket(b, scene.cfg, spec)
            stats.rebuckets += 1
        b = substep(b, scene, spec, plain=plain, t=t)
        stats.substeps += 1
    return b
