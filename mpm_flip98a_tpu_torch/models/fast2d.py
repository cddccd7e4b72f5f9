"""Fast 2D fluid solver on the hand-written CUDA transfer kernels.

Counterpart of `mpm_flip98a_tpu/models/fast2d.py` on one device, routed
as fast2d.py:537-542 does (`uses_fused`):

- one weakly-compressible fluid without F-bar or pressure mixing, on the
  B-spline: `p2g_fused` (kernel, stress inside) -> `fold_rows` ->
  `_grid_update2d` -> `g2p` (kernel) -> the particle update;
- every other config (fluid, neo-Hookean, fixed-corotated, snow and
  Drucker-Prager sand mixed per slot; F-bar and pressure mixing with the
  lag correction; the tent kernel; penalty EBC): the stress prepped in
  torch into `pdata` -> `p2g` (kernel) -> `fold_rows` -> `_grid_update2d`
  (with the nodal Jbar, p and div under F-bar or mixing) -> `g2p` (kernel,
  7 grid channels and tent taps as needed) -> the tent's per-particle
  D^-1 -> the particle update, which ends in `materials.plastic_update`
  for snow, sand and the corotated clamp.

PIC or APIC with the FLIP blend, linear or Tait EOS, slip or sticky walls
or the penalty EBC, CSF surface tension, rigid SDF colliders (static or
kinematic) and the incompressible projection, the last three applied in
`_grid_update2d` in that order; all on float32 tensors on one device.

State lives in the row-bucketed (R, K) slot layout; `rebucket` re-sorts it
when a particle nears the kernels' +-1-row margin.  `run` keeps the
reference's order (a rebucket happens before the first substep whose
state fails the margin check); in eager PyTorch that costs one
device-to-host read of the check per substep, counted in `RunStats`.

`substep(..., domain=ctx)` runs the same physics on n slab shards of L
bucket rows (parallel/fast_domain.py, fast2d.py:510-519, 744-793): kernel
row coordinates local to the shard, `p2g_grid`'s raw halo sums for both
branches, the halo exchange, the grid update on the L + 4 halo rows with
global row indices (CSF and the projection refresh the halo rows with
`halo_gather_only` and take their maxima and sums over the shards), and
`g2p` on the prepadded grid.

`routes` reads the JAX package's two route variables (fast2d.py:543,
:563-567), off by default as there: `MPM_P2G_GRID=1` (one device, an
absolute mass floor, no projection or CSF) runs P2G, the fold and the grid
update with walls and colliders in one `p2g_grid(raw=False)` call on either
branch, whose padded grid feeds the prepadded `g2p`; `MPM_FUSE2D_G2P=1`
(the fused branch, one device or slab shards) runs the FLIP blend,
advection and the J update inside `g2p(update=True)`, leaving F and Jp as
they are (fast2d.py:437-476).  With both, a substep is two transfer
kernels.

The TPU lane crop (`kernel_cols`) is not ported: the
kernels use all G = num_grids columns.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import colliders
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models.stabilized import (
    PAD, Scene, _csf_increment, _mass_floor, _project_grid,
)
from mpm_flip98a_tpu_torch.ops import binning
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
from mpm_flip98a_tpu_torch.state import Particles, host_array


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
class FastSpec:
    """Static fast-path parameters."""

    rows: int          # R = num_grids (one bucket per grid row)
    capacity: int      # K slots per row

    @staticmethod
    def for_particles(cfg: MPMConfig, p: Particles, headroom: float = 1.5) -> "FastSpec":
        x = host_array(p.x)
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
    p: Particles, cfg: MPMConfig, spec: FastSpec, device="cuda"
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
    """Raise ValueError for a config that is not 2D: fast2d runs every
    switch of a 2D scene."""
    if scene.cfg.dim != 2:
        raise ValueError("fast2d runs 2D configs; a 3D config takes models/fast3d")


def plastic_materials(scene: Scene) -> Tuple[int, ...]:
    """The materials whose F (and SNOW's Jp) `materials.plastic_update`
    changes after the F update (fast2d.py:842-857): SNOW, SAND, and
    FIXED_COROTATED under `params.plastic`.  Empty: no plastic update."""
    present = scene.materials_present
    ids = [m for m in (mat.SNOW, mat.SAND) if m in present]
    if scene.params.plastic and mat.FIXED_COROTATED in present:
        ids.append(mat.FIXED_COROTATED)
    return tuple(ids)


def _fmat2(f00, f01, f10, f11) -> torch.Tensor:
    """Stack four (R, K) planes into (R, K, 2, 2) matrices."""
    return torch.stack([torch.stack([f00, f01], -1), torch.stack([f10, f11], -1)], -2)


def _ext(cfg: MPMConfig) -> bool:
    """F-bar or pressure mixing: the extended (9-channel) transfers."""
    return bool(cfg.use_fbar or cfg.pressure_mixing_ratio > 0.0)


def uses_fused(scene: Scene) -> bool:
    """The branch of fast2d.py:537-542: one weakly-compressible fluid, no
    F-bar or pressure mixing and the B-spline kernel take `p2g_fused`;
    every other config preps `pdata` for `p2g`."""
    return (
        scene.materials_present == (mat.WEAKLY_COMPRESSIBLE_FLUID,)
        and not _ext(scene.cfg)
        and scene.cfg.kernel != KernelKind.TENT
    )


def routes(scene: Scene, domain=None, grid_reduce=None) -> Tuple[bool, bool]:
    """(p2g_grid, fuse_g2p): the routes fast2d.py:536-599 reads from the
    environment, with JAX's defaults ("0") and conditions.
    `MPM_P2G_GRID=1` on one device, with no `grid_reduce` to merge the
    folded sums (fast2d.py:564), an absolute mass floor and no grid-side
    extension (the incompressible projection or CSF surface tension) runs
    P2G, the fold and the grid update (walls, colliders) in one
    `p2g_grid(raw=False)` call on either branch; `MPM_FUSE2D_G2P=1` on
    the fused branch (`uses_fused`), on one device or on slab shards, runs
    the particle update inside `g2p(update=True)`."""
    cfg = scene.cfg
    p2g_grid = (
        domain is None and grid_reduce is None and scene.mass_floor > 0.0
        and not (cfg.incompressible or cfg.surface_tension > 0.0)
        and os.environ.get("MPM_P2G_GRID", "0") == "1"
    )
    fuse_g2p = uses_fused(scene) and os.environ.get("MPM_FUSE2D_G2P", "0") == "1"
    return p2g_grid, fuse_g2p


def _axis_bands2d(cfg: MPMConfig, idx0: torch.Tensor, ncols: int):
    """Wall-band masks broadcastable against (..., rows, G) planes: box
    faces at PAD / G-1-PAD, as models/stabilized._apply_wall_bc.  `idx0`
    holds the planes' global row indices (fast2d.py:242-255)."""
    lo, hi = int(PAD), cfg.num_grids - 1 - int(PAD)
    idx1 = torch.arange(ncols, device=idx0.device)
    return (
        (idx0 <= lo)[..., None], (idx0 >= hi)[..., None],
        (idx1 <= lo)[None, :], (idx1 >= hi)[None, :],
    )


def _grid_update2d(gridsum: torch.Tensor, scene: Scene, row_index0=None, t=None,
                   domain=None) -> torch.Tensor:
    """Grid momentum update on the row-leading (R, 5 or 6 or 9, G) fold
    output (fast2d.py:258-398): mass floor, gravity, CSF surface tension,
    slip or sticky walls or the penalty EBC, the scene's rigid colliders at
    simulation time `t` (None: static geometry), then the incompressible
    projection with the colliders' interiors as solid.  Returns the grid
    (R, 4, G) = [v_new (2), v_old (2)] for g2p, plus the nodal averages
    [Jbar, p, div] (R, 7, G) under F-bar or mixing.

    Slab shards (`domain`) pass the halo-synced (n, L + 4, nch, G) sums and
    their global row indices `row_index0` (n, L + 4), which also place the
    colliders' node coordinates.  The grid update's relative mass floor is
    then each shard's own (the reference's _mass_floor on the shard-local
    sums, fast2d.py:277, takes no pmax; ROADMAP queue 3); the projection's
    is the max over the shards (fast2d.py:376-380), and CSF and the CG
    refresh the halo rows with `domain.halo_gather_only`."""
    cfg = scene.cfg
    dt = np.float32(cfg.dt)
    g_m = gridsum[..., 4, :]
    has = g_m > _mass_floor(scene, g_m, sharded=gridsum.dim() == 4)
    safe = torch.where(has, g_m, 1.0)
    v0x = torch.where(has, gridsum[..., 0, :] / safe, 0.0)     # pre-force
    v0y = torch.where(has, gridsum[..., 1, :] / safe, 0.0)
    grav = np.asarray(cfg.gravity_acceleration(scene.physics), np.float32)
    if row_index0 is None:
        row_index0 = torch.arange(gridsum.shape[0], device=gridsum.device)
    low0, high0, low1, high1 = _axis_bands2d(cfg, row_index0, gridsum.shape[-1])
    st_x = st_y = None
    if cfg.surface_tension > 0.0:
        # CSF on the (R, G) mass plane, the general path's force: the
        # momentum increment dt F/V (m / rho) joins the sums before the mass
        # solve and the wall BC (fast2d.py:289-307).
        st = _csf_increment(g_m, scene, domain)
        st_x, st_y = st[..., 0], st[..., 1]
    if cfg.use_penalty_ebc:
        # Implicit normal-velocity penalty (m I + dt beta n n^T) v = m v* +
        # dt m g; the box's penalty matrix is diagonal, so the solve is a
        # divide by the mass plus dt beta on the axis's wall band.
        dt_beta = float(dt * np.float32(cfg.penalty_parameter(scene.physics)))
        pen0 = (low0 | high0).to(torch.float32)
        pen1 = (low1 | high1).to(torch.float32)
        rhs_x = gridsum[..., 2, :] + float(dt * grav[0]) * g_m
        rhs_y = gridsum[..., 3, :] + float(dt * grav[1]) * g_m
        if st_x is not None:
            rhs_x, rhs_y = rhs_x + st_x, rhs_y + st_y
        vx = torch.where(has, rhs_x / (g_m + dt_beta * pen0), 0.0)
        vy = torch.where(has, rhs_y / (g_m + dt_beta * pen1), 0.0)
    else:
        hasf = has.to(torch.float32)
        vx = torch.where(has, gridsum[..., 2, :] / safe, 0.0) + float(dt * grav[0]) * hasf
        vy = torch.where(has, gridsum[..., 3, :] / safe, 0.0) + float(dt * grav[1]) * hasf
        if st_x is not None:
            # (mv + dt F m/rho) / m == mv / m + (dt F m/rho) / m (:318-336).
            vx = vx + torch.where(has, st_x / safe, 0.0)
            vy = vy + torch.where(has, st_y / safe, 0.0)
        if scene.wall.kind == "sticky":
            anyband = low0 | high0 | low1 | high1
            vx = torch.where(anyband, 0.0, vx)
            vy = torch.where(anyband, 0.0, vy)
        else:  # slip: clamp the outgoing normal component per axis band
            vx = torch.where(low0, vx.clamp(min=0.0), vx)
            vx = torch.where(high0, vx.clamp(max=0.0), vx)
            vy = torch.where(low1, vy.clamp(min=0.0), vy)
            vy = torch.where(high1, vy.clamp(max=0.0), vy)
    col_solid = None
    if scene.colliders:
        # Pointwise, after the wall or penalty BC (fast2d.py:345-359).
        idx1 = torch.arange(gridsum.shape[-1], device=gridsum.device)
        coords = colliders.node_coords(cfg, [row_index0[..., None], idx1], vx.dtype)
        vx, vy = colliders.project([vx, vy], coords, scene.colliders, t)
        col_solid = colliders.inside_any(coords, scene.colliders, t)
    if cfg.incompressible:
        # The Chorin projection on the velocity planes (fast2d.py:360-389);
        # slab shards own rows [1, 1 + L) of their L + 4 rows.
        vx, vy = _project_grid((vx, vy), g_m, scene, col_solid,
                               row_index0 if domain is not None else None, domain=domain)
    gch = [vx, vy, v0x, v0y]
    if _ext(cfg):
        # Nodal averages for the next substep's stress: Jbar, p, div, with
        # 1 / 0 / 0 where no volume landed.
        v0sum = gridsum[..., 6, :]
        has_v = v0sum > 0
        safe_v = torch.where(has_v, v0sum, 1.0)
        gch.append(torch.where(has_v, gridsum[..., 5, :] / safe_v, 1.0))
        gch.append(torch.where(has_v, gridsum[..., 7, :] / safe_v, 0.0))
        gch.append(torch.where(has_v, gridsum[..., 8, :] / safe_v, 0.0))
    return torch.stack(gch, dim=-2)


def p2g_args(scene: Scene) -> dict:
    """Keyword arguments of the scene's P2G wrapper: `p2g_fused`
    (fast2d.py:585-592) or `p2g` (:775), as `uses_fused` picks."""
    cfg = scene.cfg
    apic = cfg.transfer == TransferKind.APIC
    if not uses_fused(scene):
        return dict(g=cfg.num_grids, dx=float(cfg.dx),
                    tent=cfg.kernel == KernelKind.TENT, apic=apic)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    return dict(
        g=cfg.num_grids, dx=float(cfg.dx), apic=apic,
        eos="linear" if scene.params.eos == EOSKind.LINEAR else "tait",
        kb=float(scene.params.bulk_modulus),
        mu=float(scene.params.dynamic_viscosity),
        gamma=float(scene.params.tait_gamma),
        fa=float(-cfg.dt * dinv),
    )


def p2g_grid_args(scene: Scene, t=None) -> dict:
    """The node arguments of `p2g_grid`'s non-raw mode for the scene
    (fast2d.py:401-434): gravity, the absolute mass floor, the wall bands
    and BC (the penalty's beta under the penalty EBC), the colliders and,
    when one moves, their time `t`."""
    cfg = scene.cfg
    grav = np.asarray(cfg.gravity_acceleration(scene.physics), np.float32)
    penalty = cfg.use_penalty_ebc
    moving = bool(scene.colliders) and colliders.any_moving(scene.colliders)
    return dict(
        dt=float(cfg.dt), gx_=float(grav[0]), gy_=float(grav[1]),
        floor=float(scene.mass_floor), lo=int(PAD), hi=cfg.num_grids - 1 - int(PAD),
        wall="penalty" if penalty else scene.wall.kind,
        beta=float(cfg.penalty_parameter(scene.physics)) if penalty else 0.0,
        colliders=tuple(scene.colliders), tcol=t if moving else None,
    )


def _stress(b: FluidBuckets, scene: Scene):
    """Component-form V0-scaled Kirchhoff stress per slot (fast2d.py:
    620-714), the models of models/materials.py on (R, K) planes.

    F-bar and pressure mixing read the nodal averages that the last
    substep's G2P gathered (jbar_s, p_s, div_s), advanced over the
    one-substep lag by their local rates (dJ/dt = J div, dp/dt = dp/dJ J
    div with div = tr C).  Neo-Hookean solids get the neo-Hookean stress
    of materials.neo_hookean_tau_hat: the reference's fast2d dispatch
    lacks that branch and gives them the corotated one (ROADMAP queue 3).
    SNOW is the corotated stress with mu and lam hardened by
    exp(hardening (1 - Jp)) (fast2d.py:684-690).  SAND takes
    materials.sand_tau_hat on stacked (R, K, 2, 2) F, as the reference's
    fast3d does: the reference's fast2d computes it and then overwrites it
    with the neo-Hookean stress (fast2d.py:657-680; ROADMAP queue 3).
    Dead slots sit at F = I, where the sand stress is zero.
    Returns ((tau00, tau01, tau10, tau11), p_point, vj): p_point is the
    fluid's pointwise pressure on every slot, solids included (zero
    without a fluid); vj = V0 J_eff on every slot."""
    cfg, params = scene.cfg, scene.params
    dt = _f32(cfg.dt)
    ratio = float(cfg.pressure_mixing_ratio)
    div_lag = b.C00 + b.C11
    jbar_adv = b.jbar_s * (1.0 + dt * div_lag) if _ext(cfg) else b.jbar_s
    jeff = jbar_adv if cfg.use_fbar else b.J
    vj = b.vol0 * jeff
    p_point_out = torch.zeros_like(b.J)
    tau = (torch.zeros_like(b.J),) * 4
    mu_s, lam_s = _f32(params.mu), _f32(params.lam)
    for mid in scene.materials_present:
        if mid == mat.WEAKLY_COMPRESSIBLE_FLUID:
            kb = np.float32(params.bulk_modulus)
            mu = _f32(params.dynamic_viscosity)
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
            div = b.C00 + b.C11
            t00 = vj * (-pressure + 2.0 * mu * (b.C00 - 0.5 * div))
            t11 = vj * (-pressure + 2.0 * mu * (b.C11 - 0.5 * div))
            t01 = vj * (2.0 * mu * 0.5 * (b.C01 + b.C10))
            t10 = t01
        elif mid == mat.NEO_HOOKEAN:
            # V0 (mu (F F^T - I) + lam log(J) I), J floored at 1e-6.
            jf = (b.F00 * b.F11 - b.F01 * b.F10).clamp(min=_f32(1e-6))
            lj = lam_s * torch.log(jf)
            t00 = b.vol0 * (mu_s * (b.F00 ** 2 + b.F01 ** 2 - 1.0) + lj)
            t11 = b.vol0 * (mu_s * (b.F10 ** 2 + b.F11 ** 2 - 1.0) + lj)
            t01 = b.vol0 * mu_s * (b.F00 * b.F10 + b.F01 * b.F11)
            t10 = t01
        elif mid == mat.SAND:
            tm = mat.sand_tau_hat(params, b.vol0, _fmat2(b.F00, b.F01, b.F10, b.F11))
            t00, t01, t10, t11 = tm[..., 0, 0], tm[..., 0, 1], tm[..., 1, 0], tm[..., 1, 1]
        else:  # FIXED_COROTATED / SNOW: V0 (2 mu (F - R) F^T + lam (J - 1) J I)
            mu_m, lam_m = mu_s, lam_s
            if mid == mat.SNOW:
                # Lame parameters hardened by the tracked plastic volume
                # (mls-mpm88-explained.cpp:67-69).
                h = torch.exp(_f32(params.hardening) * (1.0 - b.Jp))
                mu_m, lam_m = mu_s * h, lam_s * h
            jf = b.F00 * b.F11 - b.F01 * b.F10
            px = b.F00 + b.F11
            py = b.F10 - b.F01
            # The floor guards the polar normalisation against a collapsed F.
            sc = 1.0 / torch.sqrt((px * px + py * py).clamp(min=_f32(1e-12)))
            rc, rs = px * sc, py * sc
            d00, d01 = b.F00 - rc, b.F01 + rs
            d10, d11 = b.F10 - rs, b.F11 - rc
            lj = lam_m * (jf - 1.0) * jf
            t00 = b.vol0 * (2 * mu_m * (d00 * b.F00 + d01 * b.F01) + lj)
            t01 = b.vol0 * (2 * mu_m * (d00 * b.F10 + d01 * b.F11))
            t10 = b.vol0 * (2 * mu_m * (d10 * b.F00 + d11 * b.F01))
            t11 = b.vol0 * (2 * mu_m * (d10 * b.F10 + d11 * b.F11) + lj)
        if len(scene.materials_present) == 1:
            tau = (t00, t01, t10, t11)
        else:
            sel = b.mat == mid
            tau = tuple(torch.where(sel, t, acc) for t, acc in zip((t00, t01, t10, t11), tau))
    return tau, p_point_out, vj


def _prep(b: FluidBuckets, scene: Scene, gx0, gx1) -> torch.Tensor:
    """pdata (R, 14 or 17, K) for `p2g` (fast2d.py:716-739): [gx0, gx1,
    m v (2), P (4), Q (4), m] + [V] or, under F-bar or mixing, [V0 J, V0,
    V0 p, V0 div]; every value row masked.  P = m C under APIC (else 0),
    Q = P - dt D^-1 tau."""
    cfg = scene.cfg
    (tau00, tau01, tau10, tau11), p_point, vj = _stress(b, scene)
    fa = float(-np.float32(cfg.dt) * np.float32(4.0 * cfg.inv_dx * cfg.inv_dx))
    if cfg.transfer == TransferKind.APIC:
        p00, p01, p10, p11 = b.mass * b.C00, b.mass * b.C01, b.mass * b.C10, b.mass * b.C11
    else:
        p00 = p01 = p10 = p11 = torch.zeros_like(b.C00)
    q00, q01 = p00 + fa * tau00, p01 + fa * tau01
    q10, q11 = p10 + fa * tau10, p11 + fa * tau11
    m = b.mass * b.mask
    rows = [
        gx0, gx1, m * b.v0, m * b.v1,
        *(a * b.mask for a in (p00, p01, p10, p11, q00, q01, q10, q11)),
        m,
    ]
    if _ext(cfg):
        v0m = b.vol0 * b.mask
        rows += [v0m * b.J, v0m, v0m * p_point, v0m * (b.C00 + b.C11)]
    else:
        rows += [vj * b.mask]
    return torch.stack(rows, dim=1)


def transfer_inputs(b: FluidBuckets, scene: Scene, domain=None, update=False):
    """(data, pdata2 (R, 3, K), counts (R,)) for the kernels, where data is
    `p2g_fused`'s sdata (R, 11, K) or `p2g`'s prepped pdata (R, 14 or 17,
    K), as `uses_fused` picks.  With `update` pdata2 is g2p's update-mode
    input (R, 8, K) = [gx0, gx1, mask, v0, v1, J, x0, x1].

    P2G and G2P read one precomputed transfer coordinate gx = x / dx + PAD
    (docs/KERNELS.md:57-60): computed twice, it could round a knife-edge
    particle into different cells in the two transfers.  On slab shards
    (`domain`) gx0 is local to the shard: bucket row i of shard s holds
    global base rows s L + i +- 1 (fast2d.py:510-515)."""
    inv_dx = _f32(scene.cfg.inv_dx)
    gx0 = b.x0 * inv_dx + PAD
    gx1 = b.x1 * inv_dx + PAD
    if domain is not None:
        gx0 = gx0 - domain.bucket_row0(b.device)
    counts = (b.mask > 0).sum(dim=1).to(torch.int32)
    if uses_fused(scene):
        data = torch.stack(
            [gx0, gx1, b.v0, b.v1, b.C00, b.C01, b.C10, b.C11, b.J, b.mass, b.vol0],
            dim=1,
        )
    else:
        data = _prep(b, scene, gx0, gx1)
    rows = [gx0, gx1, b.mask, b.v0, b.v1, b.J, b.x0, b.x1] if update else [gx0, gx1, b.mask]
    return data, torch.stack(rows, dim=1), counts


def _tent_inverse_d(gx0, gx1, dx: float):
    """(i00, i01, i11) of the per-particle D^-1 for the tent kernel
    (fast2d.py:797-816): D = sum w dpos dpos^T from the hat taps alone,
    regularised by 1e-12 on the diagonal."""
    dxf = _f32(dx)

    def axis_d(gx):
        base = torch.floor(gx - 0.5)
        fx = gx - base
        w = tk._axis_weights_tent(fx)
        s1 = sum(w[i] * (i - fx) for i in range(3)) * dxf       # ~0
        s2 = sum(w[i] * (i - fx) ** 2 for i in range(3)) * dxf * dxf
        return s1, s2

    s0_1, d00 = axis_d(gx0)
    s1_1, d11 = axis_d(gx1)
    d01 = s0_1 * s1_1
    eps = _f32(1e-12)
    d00, d11 = d00 + eps, d11 + eps
    det = d00 * d11 - d01 * d01
    return d11 / det, -d01 / det, d00 / det


def _grid(data, counts, scene: Scene, plain: bool, domain, t=None, p2g_grid=False,
          grid_reduce=None):
    """P2G, the fold and the grid update at time `t` -> the g2p grid: (R, 4
    or 7, G) on one device, `grid_reduce` applied to the folded sums
    before the update (fast2d.py:776-780); with `p2g_grid` the one-launch
    `p2g_grid(raw=False)`, whose (R + 4, 4 or 7, G) padded grid is returned
    as one shard (1, R + 4, ..) for the prepadded `g2p` (fast2d.py:401-434);
    on slab shards `p2g_grid`'s raw halo sums, the halo exchange and the
    update on the (n, L + 4) halo rows (fast2d.py:744-766)."""
    fused = uses_fused(scene)
    if p2g_grid:
        call = tk.p2g_grid_plain if plain else tk.p2g_grid
        return call(data, counts, fused=fused, **p2g_args(scene), **p2g_grid_args(scene, t))[None]
    if domain is None:
        if plain:
            p2g = tk.p2g_fused_plain if fused else tk.p2g_plain
        else:
            p2g = tk.p2g_fused if fused else tk.p2g
        gridsum = tk.fold_rows(p2g(data, counts, **p2g_args(scene)))
        if grid_reduce is not None:
            gridsum = grid_reduce(gridsum)
        return _grid_update2d(gridsum, scene, t=t)
    kw = dict(fused=fused, shards=domain.blocks, raw=True, **p2g_args(scene))
    raw = (tk.p2g_grid_plain if plain else tk.p2g_grid)(data, counts, **kw)
    return _grid_update2d(domain.halo_sync(raw), scene, domain.row_index0(data.device), t,
                          domain)


def substep(
    b: FluidBuckets, scene: Scene, plain: bool = False, domain=None, t=None, grid_reduce=None
) -> FluidBuckets:
    """One fast substep (fast2d.py:479-875); `t` (simulation seconds, a
    host scalar) advects kinematic colliders.

    `uses_fused` configs take `p2g_fused`; the others prep `pdata` and
    take `p2g`, the extended grid channels under F-bar or mixing and the
    tent kernel's per-particle D^-1.  Then `g2p` and the particle update.
    `domain` (parallel/fast_domain.FastDomainCtx) runs both branches on
    its slab shards through `p2g_grid`'s raw mode and the prepadded `g2p`.
    `grid_reduce` merges the folded (G, nch, G) sums of every particle
    share before the grid update (parallel/fast_replicated.py passes the
    mesh's psum; fast2d.py:776-780).  `routes` reads MPM_P2G_GRID and
    MPM_FUSE2D_G2P as JAX does: the first
    puts P2G, the fold and the grid update in one `p2g_grid(raw=False)`,
    the second the particle update in `g2p(update=True)`, which leaves F,
    Jp and the lagged nodal fields as they are (fast2d.py:437-476).
    `plain=True` calls the kernels' plain PyTorch versions even on a card:
    it exists to time the plain path against the kernel path."""
    check_supported(scene)
    cfg = scene.cfg
    dt = _f32(cfg.dt)
    dx = float(cfg.dx)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    tent = cfg.kernel == KernelKind.TENT
    ext = _ext(cfg)
    g2p = tk.g2p_plain if plain else tk.g2p
    if grid_reduce is not None and domain is not None:
        raise ValueError("grid_reduce merges one device's grid; slab shards exchange halos")
    use_grid, fuse_g2p = routes(scene, domain, grid_reduce)
    prepadded = use_grid or domain is not None

    data, pdata2, counts = transfer_inputs(b, scene, domain, fuse_g2p)
    grid = _grid(data, counts, scene, plain, domain, t, use_grid, grid_reduce)
    if fuse_g2p:
        out = g2p(pdata2, counts, grid, dx, dinv, prepadded=prepadded, update=True,
                  alpha=float(cfg.flip_blend), dtv=float(cfg.dt))
        return dataclasses.replace(
            b, x0=out[:, 0], x1=out[:, 1], v0=out[:, 2], v1=out[:, 3],
            C00=out[:, 4], C01=out[:, 5], C10=out[:, 6], C11=out[:, 7], J=out[:, 8],
        )
    out = g2p(pdata2, counts, grid, dx, 1.0 if tent else dinv, tent=tent, prepadded=prepadded)
    vpic0, vpic1 = out[:, 0], out[:, 1]
    vold0, vold1 = out[:, 2], out[:, 3]
    c00, c01, c10, c11 = out[:, 4], out[:, 5], out[:, 6], out[:, 7]
    if tent:
        # G2P returned the raw B = sum w v dpos^T (dinv = 1): C = B D^-1.
        i00, i01, i11 = _tent_inverse_d(pdata2[:, 0], pdata2[:, 1], dx)
        c00, c01 = c00 * i00 + c01 * i01, c00 * i01 + c01 * i11
        c10, c11 = c10 * i00 + c11 * i01, c10 * i01 + c11 * i11

    # Particle update (fast2d.py:818-875): FLIP blend, advection, F and J.
    alpha = _f32(cfg.flip_blend)
    one_m_alpha = float(np.float32(1.0) - np.float32(alpha))
    nv0 = alpha * (b.v0 + vpic0 - vold0) + one_m_alpha * vpic0
    nv1 = alpha * (b.v1 + vpic1 - vold1) + one_m_alpha * vpic1
    div_new = c00 + c11
    ratio = float(cfg.pressure_mixing_ratio)
    if ratio > 0.0:
        # The mixed divergence drives the volumetric update (one-substep lag).
        div_for_j = ratio * b.div_s + (1.0 - ratio) * div_new
    else:
        div_for_j = div_new
    on = b.mask > 0
    if ext:
        jbar_new = torch.where(on, out[:, 8], 1.0)
        p_new = out[:, 9] * b.mask
        div_s_new = out[:, 10] * b.mask
    else:
        jbar_new, p_new, div_s_new = b.jbar_s, b.p_s, b.div_s
    f00 = (1 + dt * c00) * b.F00 + dt * c01 * b.F10
    f01 = (1 + dt * c00) * b.F01 + dt * c01 * b.F11
    f10 = dt * c10 * b.F00 + (1 + dt * c11) * b.F10
    f11 = dt * c10 * b.F01 + (1 + dt * c11) * b.F11
    jp_new = b.Jp
    if plastic_materials(scene):
        # The snow clamp with Jp tracking, or sand's cone projection
        # (fast2d.py:842-857); dead slots sit at F = I, Jp = 1, which
        # neither changes.
        fm, jp_new = mat.plastic_update(scene.params, b.mat, _fmat2(f00, f01, f10, f11),
                                        b.Jp, scene.materials_present)
        f00, f01, f10, f11 = fm[..., 0, 0], fm[..., 0, 1], fm[..., 1, 0], fm[..., 1, 1]
    return dataclasses.replace(
        b,
        x0=b.x0 + dt * vpic0 * b.mask,
        x1=b.x1 + dt * vpic1 * b.mask,
        v0=nv0 * b.mask,
        v1=nv1 * b.mask,
        C00=c00, C01=c01, C10=c10, C11=c11,
        F00=f00, F01=f01, F10=f10, F11=f11,
        J=torch.where(on, b.J * (1.0 + dt * div_for_j), 1.0), Jp=jp_new,
        jbar_s=jbar_new, p_s=p_new, div_s=div_s_new,
    )


def _margin_rows(b: FluidBuckets, cfg: MPMConfig, rows=None) -> torch.Tensor:
    """(R,) bool: bucket rows with an active slot near the kernels' +-1-row
    margin: post-rebucket every slot has gx0 - 0.5 - row in [0, 1); trigger
    with a 0.2-row safety band before [-1, 2) is left.  `rows` (R,) holds
    each bucket row's global row (default: its index); on slab shards this
    is the reference's check with row0 = s L (fast2d.py:877-891)."""
    r, k = b.shape
    gx0 = b.x0 * _f32(cfg.inv_dx) + PAD
    if rows is None:
        rows = torch.arange(r, dtype=torch.int32, device=b.device)
    rows = rows.to(torch.int32)[:, None].to(torch.float32)
    d = torch.where(b.mask > 0, gx0 - 0.5 - rows, 0.5)
    return ((d <= -0.8) | (d >= 1.8)).any(dim=1)


def _needs_rebucket(b: FluidBuckets, cfg: MPMConfig) -> torch.Tensor:
    """True (a 0-dim bool tensor) when any active slot approaches the
    kernels' +-1-row margin (`_margin_rows`)."""
    return _margin_rows(b, cfg).any()


@dataclasses.dataclass
class RunStats:
    """Counts kept by `run` (the caller creates and passes it)."""

    substeps: int = 0
    rebuckets: int = 0
    host_reads: int = 0   # device->host reads of the margin flag


def substep_times(scene: Scene, t0, n_substeps: int):
    """The simulation time of each of `n_substeps` substeps from `t0`, as
    fast2d.py:905-985 forms it on the device: t = f32(t0) + f32(j) f32(dt)
    with j the run's substep counter (a rebucket does not reset it).  None
    for every substep when `t0` is None or no collider moves."""
    if t0 is None or not colliders.any_moving(scene.colliders):
        return [None] * n_substeps
    t0f, dtf = np.float32(t0), np.float32(scene.cfg.dt)
    return [float(t0f + np.float32(j) * dtf) for j in range(n_substeps)]


def run(
    b: FluidBuckets, scene: Scene, spec: FastSpec, n_substeps: int,
    stats: RunStats = None, plain: bool = False, t0=None,
) -> FluidBuckets:
    """Advance n_substeps with adaptive rebucketing: before each substep,
    rebucket if the state fails the margin check (the order of
    fast2d.py:936-987).  Reading the flag is one host sync per substep.
    `t0` (simulation seconds at entry) drives kinematic colliders: substep
    j sees t = t0 + j dt (`substep_times`)."""
    stats = RunStats() if stats is None else stats
    for t in substep_times(scene, t0, n_substeps):
        stats.host_reads += 1
        if bool(_needs_rebucket(b, scene.cfg)):
            b = rebucket(b, scene.cfg, spec)
            stats.rebuckets += 1
        b = substep(b, scene, plain=plain, t=t)
        stats.substeps += 1
    return b
