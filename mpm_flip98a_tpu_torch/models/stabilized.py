"""The stabilized MPM free-surface solver, the general path (counterpart of `mpm_flip98a_tpu/models/stabilized.py`).

The JAX module's flagship: the rebuild of the reference's withheld solver
(reference: README.md:23-25) from its field declarations (fields.py:4-51),
switch set (config.py:15-46) and driver loop (exec.py).  It takes every
switch in 2D and 3D and keeps the particles' dtype (the reference runs
float64):

  transfer (config.py:18)       PIC / APIC
  use_fbar (config.py:19)       cell-averaged volume ratio (F-bar)
  use_penalty_ebc (config.py:20) wall penalty folded into a matrix-valued
                                nodal mass and a per-node d x d solve
  kernel (config.py:21)         quadratic B-spline / tent
  pressure_mixing_ratio (:28)   grid-projected vs pointwise pressure and
                                divergence
  flip_blend (config.py:29)     PIC/APIC <-> FLIP velocity blend

Pipeline per substep: (1) the projection P2G of volume, pressure and
divergence when mixing is on, (2) the F-bar cell average, (3) the material
stress, (4) one fused momentum P2G of [momentum, momentum + force, mass,
volume], (5) the grid update (mass floor, gravity, the penalty solve or the
slip / sticky walls, the rigid colliders), (6) G2P: the FLIP/PIC/APIC
blend, the general APIC D for the tent, advection, the F and J updates,
the plasticity clamp and the consistency diagnostics.

Plain torch, but for the scatter: the JAX general path reaches no Pallas
kernel; its XLA scatter-add is `ops/cuda/scatter.stencil_add` for the
node transfers and `scatter_add` for the cell sums (on the CPU
`index_add_`, on the card a fixed-order sum in the CPU's order, so card
reruns are bitwise equal) and its gather a plain gather
(`ops/transfer.py`).  The flat node index and the scatter's plan are built
once a substep and serve every transfer.  Constants enter as Python floats rounded to the
particles' dtype (as JAX's `jnp.asarray(c, dtype)` does), and no value is
read on the host, so `run` queues its substeps on the card without a
synchronisation, except the projection's CG (`models/projection.py`),
which reads its active flag once every 8 iterations.

The physics is written once against a `GridContext` and a `grid_reduce`
hook applied to every raw P2G sum, as in the JAX module: one device
(global buffers, no reduce), the replicated grid of
`parallel/replicated.py` (global buffers, reduce = the ranks' psum) and
the slab domain of `parallel/domain.py` (slab buffers, global rows in
`row_index0`, reduce = halo reduce + gather between neighbouring ranks,
and the CSF chain and the projection taking their maxima and dot products
over the ranks).  The fast paths share `_csf_force`, `_csf_increment` and
`_project_grid`, and their slab shards pass those a halo refresh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import (KernelKind, MPMConfig, Physics, TransferKind, np_float,
                                          scalar)
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models import projection
from mpm_flip98a_tpu_torch.ops import mathx
from mpm_flip98a_tpu_torch.ops import transfer
from mpm_flip98a_tpu_torch.ops import weights as W
from mpm_flip98a_tpu_torch.ops.cuda import scatter
from mpm_flip98a_tpu_torch.state import Grid, Particles

# The physical domain sits PAD cells inside the background grid on every
# side (4 padding cells total per axis, reference: config.py:39).
PAD = 2.0


@dataclasses.dataclass(frozen=True)
class WallBC:
    """Wall boundary handling when penalty EBC is off."""

    kind: str = "slip"  # 'slip' (zero normal) | 'sticky' (zero all)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static bundle: numerics + physics + materials."""

    cfg: MPMConfig
    physics: Physics = Physics()
    params: mat.MaterialParams = mat.MaterialParams()
    materials_present: Tuple[int, ...] = (mat.WEAKLY_COMPRESSIBLE_FLUID,)
    wall: WallBC = WallBC()
    # Rigid SDF colliders (models/colliders.Collider), applied to the grid
    # velocities after the wall BC.
    colliders: tuple = ()
    # Absolute grid-mass floor (kg): nodes below it count as empty in the
    # grid update.  Scene builders set 1e-8 x the lightest particle mass;
    # 0.0 falls back to the relative floor 1e-8 * max(g_m).
    mass_floor: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class GridContext:
    """Where the grid buffers live (stabilized.py:119-155).

    - one device, and the replicated grid: global buffers (`single`);
    - a slab of the domain decomposition (parallel/domain.py): slab
      buffers; `base_shift` maps global stencil bases into them,
      `row_index0` holds the global node row of each local axis-0 row (for
      the walls and colliders), and the slab hooks of the grid-side chains
      (CSF, the projection): `mesh` (a `parallel.mesh.RankMesh`) for their
      maxima and dot products over the ranks, `halo_exchange` to refresh
      the axis-0 halo rows from the neighbours, `own_rows` the rows this
      rank owns.
    """

    node_shape: Tuple[int, ...]
    cell_shape: Tuple[int, ...]
    base_shift: Optional[torch.Tensor] = None   # (d,) int64, subtracted from global bases
    row_index0: Optional[torch.Tensor] = None   # (R,) global node row of each local row
    mesh: object = None
    halo_exchange: Optional[Callable] = None
    own_rows: Optional[torch.Tensor] = None     # (R,) bool

    @staticmethod
    def single(cfg: MPMConfig) -> "GridContext":
        return GridContext(node_shape=cfg.grid_shape, cell_shape=(cfg.num_cells,) * cfg.dim)

    def localize(self, idx: torch.Tensor) -> torch.Tensor:
        return idx if self.base_shift is None else idx - self.base_shift


def _live(p: Particles, ctx: GridContext):
    """On a slab, the particles whose rows the card's scatter plans keep:
    the slab's inert slots, all parked at its centre, have mass 0 and rows
    of +-0, which would only make one thread a node walk them all."""
    return p.mass > 0 if ctx.base_shift is not None else None


def _mass_floor(scene: Scene, g_m: torch.Tensor, sharded: bool = False):
    """Grid-mass emptiness threshold (see Scene.mass_floor): the absolute
    floor as a Python float in g_m's dtype, else the relative one.  With
    `sharded` (g_m with the slab shard as dim 0) the relative floor is each
    shard's own: the reference takes it on the shard-local sums, no pmax."""
    if scene.mass_floor > 0.0:
        return float(np_float(g_m.dtype)(scene.mass_floor))
    if sharded:
        return scalar(1e-8, g_m.dtype) * g_m.amax(dim=tuple(range(1, g_m.dim())), keepdim=True)
    return scalar(1e-8, g_m.dtype) * g_m.max()


def _grid_coords(p_x: torch.Tensor, cfg: MPMConfig) -> torch.Tensor:
    """Particle position in grid units including the padding shift."""
    return p_x * float(np_float(p_x.dtype)(cfg.inv_dx)) + PAD


def _weights(gx: torch.Tensor, cfg: MPMConfig):
    offsets = W.stencil_offsets(cfg.dim)
    base = torch.floor(gx - 0.5).to(torch.int64)
    fx = gx - base.to(gx.dtype)
    wst = W.stencil_weights(W.kernel_weights(fx, cfg.kernel), offsets)
    return offsets, base, fx, wst


def _cell_index(gx: torch.Tensor, cfg: MPMConfig) -> torch.Tensor:
    """Cell-centered index for the F-bar average (StabilizationFields,
    fields.py:33-36: cell arrays are (num_cells,)^dim)."""
    return torch.floor(gx).to(torch.int64).clamp(0, cfg.num_cells - 1)


def _flat_cell(cell: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten (possibly out-of-bounds) cell indices; returns (flat, mask)."""
    flat, in_bounds = None, None
    stride = 1
    for k in reversed(range(len(shape))):
        c = cell[:, k]
        ok = (c >= 0) & (c < shape[k])
        term = c.clamp(0, shape[k] - 1) * stride
        flat = term if flat is None else term + flat
        in_bounds = ok if in_bounds is None else ok & in_bounds
        stride *= shape[k]
    return flat, in_bounds


def _scatter_cells(values: torch.Tensor, cell: torch.Tensor, shape, keep=None) -> torch.Tensor:
    """Nearest-cell scatter-add: values (N, c) by cell (N, d) -> (shape, c);
    on the card the rows where `keep` is False (all +-0) stay out of the
    plan (`transfer.flat_node_index`)."""
    flat, in_bounds = _flat_cell(cell, shape)
    values = torch.where(in_bounds[..., None], values, 0.0)
    n = int(np.prod(shape))
    plan = scatter.segment_plan(flat, n, keep) if keep is not None and flat.is_cuda else None
    out = scatter.scatter_add(values, flat, n, plan)
    return out.reshape(tuple(shape) + (values.shape[-1],))


def fbar_jbar(p: Particles, scene: Scene, ctx: GridContext = None, *,
              grid_reduce: Callable = None) -> torch.Tensor:
    """Cell-averaged volume ratio (overline-F stabilization, reference:
    config.py:19, fields.py:33-36): Jbar_c = sum V0 J / sum V0 over the
    particles of the cell, gathered back; the particle's J where the cell
    is empty.  `grid_reduce` completes the raw cell sums (see
    `substep_grid`)."""
    cfg = scene.cfg
    ctx = ctx or GridContext.single(cfg)
    cell = ctx.localize(_cell_index(_grid_coords(p.x, cfg), cfg))
    vals = torch.stack([p.volume0 * p.J, p.volume0], dim=-1)
    cells = _scatter_cells(vals, cell, ctx.cell_shape, _live(p, ctx))
    if grid_reduce is not None:
        cells = grid_reduce(cells)
    cells = cells.reshape(-1, 2)
    flat, in_bounds = _flat_cell(cell, ctx.cell_shape)
    back = cells[flat]
    num = torch.where(in_bounds, back[:, 0], 0.0)
    den = torch.where(in_bounds, back[:, 1], 0.0)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), p.J)


def _axis_indices(grid_shape, device, row_index0=None):
    """Per-axis global node indices of the grid buffer: `row_index0` takes
    axis 0's on a slab buffer (parallel/domain.py)."""
    idx = [torch.arange(s, device=device) for s in grid_shape]
    if row_index0 is not None:
        idx[0] = row_index0
    return idx


def _axis_band(idx: torch.Tensor, a: int, d: int) -> torch.Tensor:
    shape = [1] * d
    shape[a] = idx.shape[0]
    return idx.reshape(shape)


def _wall_normal_diag(cfg: MPMConfig, dtype, grid_shape, device, row_index0=None) -> torch.Tensor:
    """sum over walls of n (x) n at every node, as its diagonal (the walls
    are axis-aligned): 1 on an axis's wall band, else 0.  (G..., d).  The
    walls are the physical box faces, node index PAD and G-1-PAD
    (PenaltyMethodFields, fields.py:46-51)."""
    lo, hi = int(PAD), cfg.num_grids - 1 - int(PAD)
    diag = []
    for a, idx in enumerate(_axis_indices(grid_shape, device, row_index0)):
        on_wall = _axis_band((idx <= lo) | (idx >= hi), a, cfg.dim)
        diag.append(on_wall.expand(grid_shape))
    return torch.stack(diag, dim=-1).to(dtype)


def _apply_wall_bc(v: torch.Tensor, cfg: MPMConfig, wall: WallBC, grid_shape,
                   row_index0=None) -> torch.Tensor:
    """Slip / sticky walls on the padded band (the non-penalty path): slip
    clamps the outgoing normal component at nodes on or outside the box
    faces, sticky zeroes every component there (the C++ analogue:
    mls-mpm88-explained.cpp:122-128)."""
    lo, hi = int(PAD), cfg.num_grids - 1 - int(PAD)
    comps = list(v.unbind(-1))
    for a, idx in enumerate(_axis_indices(grid_shape, v.device, row_index0)):
        low = _axis_band(idx <= lo, a, cfg.dim)
        high = _axis_band(idx >= hi, a, cfg.dim)
        if wall.kind == "sticky":
            comps = [torch.where(low | high, 0.0, c) for c in comps]
        else:
            va = torch.where(low, comps[a].clamp(min=0.0), comps[a])
            comps[a] = torch.where(high, va.clamp(max=0.0), va)
    return torch.stack(comps, dim=-1)


def _roll0(c: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """Shift with zero fill (vacuum outside the buffer): the color field
    treats everything beyond the padded grid as empty."""
    r = torch.roll(c, shift, axis)
    r.select(axis, 0 if shift > 0 else -1).zero_()
    return r


def _cdiff(c: torch.Tensor, axis: int, inv_dx) -> torch.Tensor:
    """Central difference with zero-extended boundaries: translation
    invariant, so a slab buffer with valid halo rows reproduces the
    single-device values on its interior."""
    return (_roll0(c, -1, axis) - _roll0(c, 1, axis)) * (0.5 * inv_dx)


def _csf_force(g_m: torch.Tensor, cfg: MPMConfig, physics: Physics, dtype,
               halo=None, mesh=None, lead=None) -> torch.Tensor:
    """Continuum-surface-force density sigma kappa grad(c~) on the grid
    (stabilized.py:311-358): the normalised, binomially smoothed nodal mass
    is the color function c~, n = grad c~, kappa = -div(n / |n|); nodes
    with |n| below 1% of its max contribute nothing.  Dim-agnostic: the
    general path's (G...) mass and the fast paths' planes.

    With `halo` (`FastDomainCtx.halo_gather_only`) the planes are slab
    shards stacked on dim 0: after each radius-1 stage `halo` refreshes
    their halo rows from the neighbours in place, and the two maxima are
    taken over every shard (the reference's pmax).  With `mesh` as well (a
    `RankMesh`; `halo` = the domain's `halo_gather`) `g_m` is this rank's
    slab and the maxima are the ranks' pmax (stabilized.py:332-345).
    `lead` (default: 1 with `halo` and no `mesh`) is the count of leading
    block dims: a fast path's planes on ranks keep their (1, ...) block
    dim and pass `mesh` too.  Returns (..., d) in `g_m`'s layout."""
    if lead is None:
        lead = 1 if halo is not None and mesh is None else 0
    sync = halo if halo is not None else (lambda x: x)
    gmax = (lambda x: x.max()) if mesh is None else (lambda x: mesh.pmax(x.max()))
    d = g_m.dim() - lead
    nd = np_float(dtype)
    inv_dx = float(nd(cfg.inv_dx))
    c = g_m / torch.clamp(gmax(g_m), min=float(nd(1e-30)))
    # One binomial (1,2,1)/4 pass per axis smooths the deposition ripple.
    for a in range(lead, lead + d):
        c = 0.25 * _roll0(c, 1, a) + 0.5 * c + 0.25 * _roll0(c, -1, a)
    c = sync(c)
    n = sync(torch.stack([_cdiff(c, lead + a, inv_dx) for a in range(d)], dim=-1))
    mag = torch.sqrt(mathx.seq_sum(n * n, -1))
    near = mag > float(nd(0.01)) * gmax(mag)
    safe = torch.where(near, mag, 1.0)
    nhat = torch.where(near[..., None], n / safe[..., None], 0.0)
    kappa = -sum(_cdiff(nhat[..., a], lead + a, inv_dx) for a in range(d))
    sigma = float(nd(cfg.surface_tension))
    force = torch.where(near[..., None], sigma * kappa[..., None] * n, 0.0)
    # kappa is one-sided on the outermost halo rows: refresh them.
    return sync(force)


def _csf_increment(g_m: torch.Tensor, scene: Scene, domain=None) -> torch.Tensor:
    """The fast paths' CSF momentum increment dt F/V (m / rho) on their
    float32 mass planes, (..., d) in `g_m`'s layout (fast2d.py:289-307,
    fast3d.py:334-350: the scale dt m / rho first, then the force; the
    general path keeps the reference's dt F (m / rho)).  On shards
    (`domain`, a FastDomainCtx) the halos refresh through its
    `halo_gather_only`, and on ranks its `rank_mesh` takes the maxima."""
    if domain is None:
        f_st = _csf_force(g_m, scene.cfg, scene.physics, torch.float32)
    else:
        f_st = _csf_force(g_m, scene.cfg, scene.physics, torch.float32,
                          domain.halo_gather_only, domain.rank_mesh, lead=1)
    st_scale = float(np.float32(scene.cfg.dt)) * g_m / float(
        np.float32(scene.physics.particle_density))
    return f_st * st_scale[..., None]


def _project_grid(vs, g_m: torch.Tensor, scene: Scene, col_solid=None, row_index0=None,
                  row_index1=None, domain=None, ctx: GridContext = None):
    """The nodal Chorin projection of the d velocity planes `vs`
    (models/projection.py; stabilized.py:525-549, fast2d.py:360-389,
    fast3d.py:394-415) with the walls and `col_solid` (the colliders'
    interiors) as solid; returns the projected planes as a list.  Slab
    shards (`domain`, a FastDomainCtx or FastDomain3DCtx) own axis-0 rows
    [1, 1 + L) of their L + 4, refresh the halo rows with
    `halo_gather_only` and take the relative floor over every shard
    (fast2d.py:376-380, fast3d.py:400-403), over the ranks on a RankMesh.
    A rank's slab (`ctx` with a mesh) takes the relative floor's pmax over
    the ranks (stabilized.py:533-538) and runs the CG's rank form."""
    cfg = scene.cfg
    own = halo = mesh = None
    floor = _mass_floor(scene, g_m)
    if domain is not None:
        own, halo = domain.own_rows(g_m.device), domain.halo_gather_only
        mesh = domain.rank_mesh
        if mesh is not None and scene.mass_floor <= 0.0:
            floor = mesh.pmax(floor)   # the max over every shard, as one device takes it
    elif ctx is not None and ctx.mesh is not None:
        own, halo, mesh, row_index0 = ctx.own_rows, ctx.halo_exchange, ctx.mesh, ctx.row_index0
        if scene.mass_floor <= 0.0:
            # Halo rows must classify fluid and air alike on both owners.
            floor = mesh.pmax(floor)
    out, _, _ = projection.project_planes(
        tuple(vs), g_m, floor,
        dx=float(cfg.dx), lo=int(PAD), hi=cfg.num_grids - 1 - int(PAD),
        iters=int(cfg.pressure_iters), tol=float(cfg.pressure_tol),
        row_index0=row_index0, row_index1=row_index1, shards=domain is not None,
        halo=halo, own=own, solid_extra=col_solid, mesh=mesh,
    )
    return list(out)


def substep_grid(
    p: Particles, scene: Scene, ctx: GridContext = None, t=None, *,
    grid_reduce: Callable = None,
) -> Tuple[Particles, Grid]:
    """One substep; returns the new particle state and the post-update grid.
    `t` (simulation seconds, a host float) places kinematic colliders;
    None keeps every collider at its initial position.  `ctx` describes
    the grid buffers (global by default); `grid_reduce` completes every raw
    P2G sum before it is read (stabilized.py:419-423): none on one device,
    the ranks' psum on the replicated grid, the halo reduce and gather on
    a slab."""
    cfg = scene.cfg
    ctx = ctx or GridContext.single(cfg)
    reduce = grid_reduce if grid_reduce is not None else (lambda g: g)
    d = cfg.dim
    dt_ = p.x.dtype
    dev = p.x.device
    nd = np_float(dt_)
    dt, dx, inv_dx = nd(cfg.dt), nd(cfg.dx), nd(cfg.inv_dx)
    dinv = nd(4.0) * inv_dx * inv_dx
    eye = torch.eye(d, dtype=dt_, device=dev)

    offsets, base_global, fx, wst = _weights(_grid_coords(p.x, cfg), cfg)
    base = ctx.localize(base_global)
    grid_shape = ctx.node_shape
    index = transfer.flat_node_index(base, offsets, grid_shape, _live(p, ctx))

    # ---- strain rate and pointwise divergence from last step's C ------
    eps = 0.5 * (p.C + mathx.transpose(p.C))
    div_point = mathx.trace(p.C)

    # ---- projection pass: volume / pressure / divergence to the grid --
    ratio = cfg.pressure_mixing_ratio
    jbar = fbar_jbar(p, scene, ctx, grid_reduce=grid_reduce) if cfg.use_fbar else p.J
    p_point = mat.fluid_pressure(scene.params, jbar)
    p_grid = None
    if ratio > 0.0:
        vol_n = p.volume0 * jbar
        proj_vals = wst[..., None] * torch.stack(
            [vol_n, vol_n * p_point, vol_n * div_point], dim=-1)[:, None, :]
        proj = reduce(transfer.p2g_scatter(proj_vals, base, offsets, grid_shape, index))
        den = proj[..., 0]
        safe = torch.where(den > 0, den, 1.0)
        p_grid = torch.where(den > 0, proj[..., 1] / safe, 0.0)
        div_grid = torch.where(den > 0, proj[..., 2] / safe, 0.0)
        back = transfer.g2p_gather(torch.stack([p_grid, div_grid], dim=-1), base, offsets, index)
        p_smooth = mathx.seq_sum(wst[..., None] * back, 1)
        r = float(nd(ratio))
        one_r = float(nd(1) - nd(ratio))
        pressure = r * p_smooth[..., 0] + one_r * p_point
        div_used = r * p_smooth[..., 1] + one_r * div_point
    else:
        pressure = p_point
        div_used = div_point

    # ---- stress (material dispatch) -----------------------------------
    tau = mat.tau_hat(scene.params, p.material, p.volume0, p.F, jbar, pressure, eps,
                      scene.materials_present, jp=p.Jp)
    sigma = tau / torch.clamp(p.volume0 * jbar, min=float(nd(1e-30)))[..., None, None]

    # ---- fused momentum P2G -------------------------------------------
    # Channels [momentum (d), momentum + force (d), mass, volume]; the
    # force is fused MLS-MPM style: -dt Dinv tau on the node offset
    # (mls-mpm88-explained.cpp:79-99).
    dpos_phys = W.stencil_dpos(fx, offsets) * float(dx)          # (N, S, d)
    if cfg.transfer == TransferKind.APIC:
        vel = p.v[:, None, :] + mathx.mv(p.C[:, None], dpos_phys)
    else:
        vel = p.v[:, None, :].expand(dpos_phys.shape)
    # Written into one buffer: on the card `torch.cat` of these narrow
    # last dimensions took 2.6 ms at slab 1M (27 taps x 8 channels).
    channels = torch.empty(wst.shape + (2 * d + 2,), dtype=dt_, device=dev)
    mv_pure = torch.mul(p.mass[:, None, None], vel, out=channels[..., 0:d])
    torch.add(mv_pure, mathx.mv((float(-dt * dinv) * tau)[:, None], dpos_phys),
              out=channels[..., d : 2 * d])
    channels[..., 2 * d] = p.mass[:, None]
    channels[..., 2 * d + 1] = (p.volume0 * jbar)[:, None]
    g_out = reduce(transfer.p2g_scatter(wst[..., None] * channels, base, offsets, grid_shape,
                                        index))
    g_mv0 = g_out[..., 0:d]
    g_mv1 = g_out[..., d : 2 * d]
    g_m = g_out[..., 2 * d]
    g_vol = g_out[..., 2 * d + 1]

    # ---- grid update ---------------------------------------------------
    has_mass = g_m > _mass_floor(scene, g_m)
    safe_m = torch.where(has_mass, g_m, 1.0)
    v0 = torch.where(has_mass[..., None], g_mv0 / safe_m[..., None], 0.0)

    grav = cfg.gravity_acceleration(scene.physics)
    dt_m = float(dt) * g_m
    rhs = torch.stack([g_mv1[..., a] + dt_m * float(nd(grav[a])) for a in range(d)], dim=-1)
    if cfg.surface_tension > 0.0:
        # CSF surface tension (Brackbill et al. 1992) from the nodal mass
        # as color function: F/V = sigma kappa grad(c~), applied as the
        # nodal force dt F/V (m / rho) (stabilized.py:479-489).
        rho = float(nd(scene.physics.particle_density))
        rhs = rhs + float(dt) * _csf_force(g_m, cfg, scene.physics, dt_, ctx.halo_exchange,
                                           ctx.mesh) * (g_m / rho)[..., None]
    if cfg.use_penalty_ebc:
        # Matrix nodal mass A = m I + dt beta sum n n^T (diagonal for the
        # axis-aligned box), solved per node (fields.py:28).
        dt_beta = float(dt * nd(cfg.penalty_parameter(scene.physics)))
        pen_diag = _wall_normal_diag(cfg, dt_, grid_shape, dev, ctx.row_index0)
        a_mat = g_m[..., None, None] * eye + (dt_beta * pen_diag)[..., None] * eye
        v_new = torch.where(has_mass[..., None], mathx.solve(a_mat, rhs), 0.0)
    else:
        v_new = torch.where(has_mass[..., None], rhs / safe_m[..., None], 0.0)
        v_new = _apply_wall_bc(v_new, cfg, scene.wall, grid_shape, ctx.row_index0)

    col_solid = None
    if scene.colliders:
        # Rigid SDF colliders: a pointwise grid-velocity projection after
        # the wall / penalty BC.
        from mpm_flip98a_tpu_torch.models import colliders as _col

        shaped = [_axis_band(idx, a, d)
                  for a, idx in enumerate(_axis_indices(grid_shape, dev, ctx.row_index0))]
        coords = _col.node_coords(cfg, shaped, dt_)
        comps = _col.project(list(v_new.unbind(-1)), coords, scene.colliders, t)
        v_new = torch.stack([c.expand(grid_shape) for c in comps], dim=-1)
        # The projection treats collider interiors as solid (Neumann): their
        # BC velocities stay pinned and source the RHS at fluid neighbours.
        col_solid = _col.inside_any(coords, scene.colliders, t)

    if cfg.incompressible:
        # The nodal Chorin projection (models/projection.py,
        # stabilized.py:525-549): divergence-free grid velocities; wall
        # nodes keep their BC values.
        v_new = torch.stack(_project_grid(v_new.unbind(-1), g_m, scene, col_solid, ctx=ctx),
                            dim=-1)

    grid = Grid(
        v=v_new,
        v0=v0,
        m=g_m[..., None, None] * eye,
        volume=g_vol,
        pressure=p_grid if p_grid is not None else torch.zeros_like(g_vol),
    )

    # ---- G2P ----------------------------------------------------------
    both = transfer.g2p_gather(torch.cat([v_new, v0], dim=-1), base, offsets, index)
    wv = wst[..., None] * both
    v_pic = mathx.seq_sum(wv[..., 0:d], 1)
    dv_flip = v_pic - mathx.seq_sum(wv[..., d : 2 * d], 1)

    # Velocity gradient: the B-spline's APIC D is (dx^2/4) I
    # (mls-mpm88-explained.cpp:79); other kernels invert the per-particle
    # D = sum w dpos dpos^T in closed form.
    b_mat = mathx.dot_sum(wv[..., 0:d, None], dpos_phys[..., None, :], 1)
    if cfg.kernel == KernelKind.BSPLINE:
        c_new = float(dinv) * b_mat
    else:
        # JAX's three-operand einsum contracts w with one dpos first.
        d_mat = mathx.dot_sum((wst[..., None] * dpos_phys)[..., :, None],
                              dpos_phys[..., None, :], 1)
        d_mat = d_mat + float(nd(1e-12)) * eye
        c_new = mathx.mm(b_mat, mathx.inv(d_mat))

    alpha = float(nd(cfg.flip_blend))
    one_alpha = float(nd(1) - nd(cfg.flip_blend))
    v_p = alpha * (p.v + dv_flip) + one_alpha * v_pic

    x_new = p.x + float(dt) * v_pic
    f_new = mathx.mm(eye[None] + float(dt) * c_new, p.F)
    # The plasticity clamp and Jp tracking (a static no-op unless the scene
    # declares a clamping material; mls-mpm88-explained.cpp:164-177).
    f_new, jp_new = mat.plastic_update(scene.params, p.material, f_new, p.Jp,
                                       scene.materials_present)
    # J by the divergence rate: with mixing on, the grid-projected
    # divergence of the pre-update C (a one-substep lag); otherwise the
    # fresh pointwise trace.
    div_new = mathx.trace(c_new)
    div_for_j = div_used if ratio > 0.0 else div_new
    j_new = p.J * (1.0 + float(dt) * div_for_j)

    # Kernel-consistency diagnostics (fields.py:15-18): partition of unity
    # and linear-field reproduction sum_i w_i x_i - x_p.
    pou = mathx.seq_sum(wst, 1)
    node_pos = (base_global[:, None, :].to(dt_) + W.constant(offsets, dt_, dev)[None]
                - PAD) * float(dx)
    cons = mathx.dot_sum(wst[..., None], node_pos, 1) - p.x

    return (
        Particles(
            x=x_new,
            v=v_p,
            C=c_new,
            F=f_new,
            J=j_new,
            stress=sigma,
            material=p.material,
            volume0=p.volume0,
            mass=p.mass,
            density=p.density / (1.0 + float(dt) * div_for_j),
            pressure=pressure,
            div_v=div_new,
            pou=pou,
            consistency=cons,
            Jp=jp_new,
        ),
        grid,
    )


def substep(p: Particles, scene: Scene, ctx: GridContext = None, t=None, *,
            grid_reduce: Callable = None) -> Particles:
    return substep_grid(p, scene, ctx, t, grid_reduce=grid_reduce)[0]


def make_substep(scene: Scene) -> Callable[[Particles], Particles]:
    """A callable taking one substep of `scene` (stabilized.py:643-648;
    eager, so there is nothing to compile)."""
    return lambda p: substep(p, scene)


def run(p: Particles, scene: Scene, n_substeps: int, t0=None) -> Particles:
    """`n_substeps` substeps in a Python loop that queues them on the
    particles' device (exec.py:21-26: 10k substeps a frame).  `t0`
    (simulation seconds at entry, the driver's total_time) drives kinematic
    colliders: substep i sees t0 + i dt.  None, or no moving collider,
    keeps the colliders static."""
    from mpm_flip98a_tpu_torch.models import colliders as _col

    moving = t0 is not None and _col.any_moving(scene.colliders)
    for i in range(n_substeps):
        p = substep(p, scene, t=t0 + i * scene.cfg.dt if moving else None)
    return p
