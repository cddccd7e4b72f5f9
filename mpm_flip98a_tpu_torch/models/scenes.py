"""Scene builders (counterpart of `mpm_flip98a_tpu/models/scenes.py`).

`dam_break_2d` is the reference's production scene: a 65 x 130 particle
lattice filling a 0.057 x 0.114 m fluid column against the left wall of a
0.4375 m box (reference: config.py:30-35), 105^2 grid with 4 padding
cells (config.py:37-39).  The lattice is built in float64 numpy and cast
to the requested dtype, exactly as the JAX builder does, so both packages
start from the same bits: `dtype` is a numpy float type or a torch float
dtype, and `torch.bfloat16` (or any type named "bfloat16") builds what JAX's
`dtype=jnp.bfloat16` does, float64 rounded through float32 to bfloat16.
`elastic_drop_2d` adds an elastic block to that column (BASELINE.json
configs[2]); `dam_break_3d`, `slab_3d` and
`elastic_drop_3d` are the 3D scenes.  `dam_break_obstacle_2d`, `plow_2d`
and `dam_break_obstacle_3d` add rigid colliders (models/colliders.py).
`snow_block_2d` drops a SNOW block onto the floor and `sand_column_2d`
collapses a Drucker-Prager SAND column into a pile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, Physics, TransferKind
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models.colliders import Collider
from mpm_flip98a_tpu_torch.models.stabilized import PAD, Scene, WallBC
from mpm_flip98a_tpu_torch.state import Particles


def _dtype_name(dtype) -> str:
    """"float32", "float64" or "bfloat16" of a numpy type or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def _host(a: np.ndarray, dtype) -> torch.Tensor:
    """The float64 array `a` cast once to `dtype` as a CPU tensor; bfloat16
    rounds through float32, as numpy's (ml_dtypes') cast from float64 does."""
    name = _dtype_name(dtype)
    if name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.astype(name))


def _lattice(counts, origin, size):
    """counts particles per axis, cell-centered in a box [origin, origin+size),
    in float64."""
    axes = [
        (np.arange(c, dtype=np.float64) + 0.5) * (s / c) + o
        for c, s, o in zip(counts, size, origin)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def _floor_of(p: Particles) -> float:
    """Absolute grid-mass floor for the scene: 1e-8 x the lightest particle."""
    return 1e-8 * float(p.mass.min())


def dam_break_2d(
    cfg: Optional[MPMConfig] = None,
    physics: Physics = Physics(),
    dtype=np.float64,
) -> Tuple[Particles, Scene]:
    """The reference production scene (config.py:30-35): fluid column at the
    left wall; particle mass/volume from the lattice (config.py:36)."""
    cfg = cfg or MPMConfig(dtype=_dtype_name(dtype))
    x = _lattice(
        (cfg.num_particles_x, cfg.num_particles_y),
        (0.0, 0.0),
        (cfg.fluid_width, cfg.fluid_height))
    p = Particles.init(
        _host(x, dtype),
        volume0=cfg.initial_particle_volume,
        density=physics.particle_density,
    )
    scene = Scene(cfg=cfg, physics=physics, params=mat.MaterialParams(
        bulk_modulus=physics.bulk_modulus,
        dynamic_viscosity=physics.dynamic_viscosity,
    ), mass_floor=_floor_of(p))
    return p, scene


def elastic_drop_2d(
    cfg: Optional[MPMConfig] = None,
    physics: Physics = Physics(),
    dtype=np.float64,
    block_frac: float = 0.12,
    drop_height_frac: float = 0.55,
    block_material: int = mat.NEO_HOOKEAN,
    plastic: bool = False,
) -> Tuple[Particles, Scene]:
    """An elastic block (neo-Hookean by default, E = 5e4 Pa, nu = 0.3,
    400 kg/m^3) dropped into the fluid column (BASELINE.json configs[2],
    the `elastic_drop` scenario)."""
    cfg = cfg or MPMConfig(dtype=_dtype_name(dtype))
    fluid_x = _lattice(
        (cfg.num_particles_x, cfg.num_particles_y),
        (0.0, 0.0),
        (cfg.fluid_width, cfg.fluid_height))
    l = cfg.domain_length
    side = block_frac * l
    nb = max(8, int(side / (cfg.fluid_width / cfg.num_particles_x)))
    block_x = _lattice((nb, nb), (0.45 * l, drop_height_frac * l), (side, side))
    x = np.concatenate([fluid_x, block_x], axis=0)
    material = np.concatenate([
        np.full(len(fluid_x), mat.WEAKLY_COMPRESSIBLE_FLUID, np.int32),
        np.full(len(block_x), block_material, np.int32),
    ])
    vol_b = (side * side) / len(block_x)
    volume0 = np.concatenate(
        [np.full(len(fluid_x), cfg.initial_particle_volume), np.full(len(block_x), vol_b)])
    rho_block = 400.0  # light elastic block (floats)
    density = np.concatenate(
        [np.full(len(fluid_x), physics.particle_density), np.full(len(block_x), rho_block)])
    p = Particles.init(
        _host(x, dtype),
        volume0=_host(volume0, dtype),
        density=_host(density, dtype),
        material=torch.from_numpy(material),
    )
    e_block, nu_block = 5e4, 0.3
    scene = Scene(
        cfg=cfg,
        physics=physics,
        params=mat.MaterialParams(
            bulk_modulus=physics.bulk_modulus,
            dynamic_viscosity=physics.dynamic_viscosity,
            mu=e_block / (2 * (1 + nu_block)),
            lam=e_block * nu_block / ((1 + nu_block) * (1 - 2 * nu_block)),
            plastic=plastic,
        ),
        materials_present=(mat.WEAKLY_COMPRESSIBLE_FLUID, block_material),
        mass_floor=_floor_of(p),
    )
    return p, scene


def snow_block_2d(
    cfg: Optional[MPMConfig] = None,
    physics: Physics = Physics(),
    dtype=np.float64,
    block_frac: float = 0.18,
    drop_height_frac: float = 0.5,
    particles_per_axis: int = 40,
    youngs: float = 1.4e5,
    poisson: float = 0.2,
) -> Tuple[Particles, Scene]:
    """A snow block (400 kg/m^3) dropped onto the floor (the `snow2d`
    scenario): materials.SNOW, the corotated stress hardened by the
    tracked plastic volume Jp and clamped at F-update time
    (mls-mpm88-explained.cpp:17-19,67-69,164-177; E and nu are Stomakhin et
    al. 2013's snow).  The block compacts on impact instead of bouncing."""
    cfg = cfg or MPMConfig(dtype=_dtype_name(dtype))
    l = cfg.domain_length
    side = block_frac * l
    n = particles_per_axis
    x = _lattice((n, n), (0.5 * (l - side), drop_height_frac * l), (side, side))
    p = Particles.init(
        _host(x, dtype),
        volume0=side * side / (n * n),
        density=400.0,
        material=torch.full((len(x),), mat.SNOW, dtype=torch.int32),
    )
    scene = Scene(
        cfg=cfg,
        physics=physics,
        params=mat.MaterialParams(
            mu=youngs / (2 * (1 + poisson)),
            lam=youngs * poisson / ((1 + poisson) * (1 - 2 * poisson)),
        ),
        materials_present=(mat.SNOW,),
        mass_floor=_floor_of(p),
    )
    return p, scene


def sand_column_2d(
    cfg: Optional[MPMConfig] = None,
    physics: Physics = Physics(),
    dtype=np.float64,
    width_frac: float = 0.14,
    height_frac: float = 0.38,
    particles_per_axis: Tuple[int, int] = (28, 76),
    youngs: float = 3.537e5,
    poisson: float = 0.3,
    friction_angle: float = 35.0,
) -> Tuple[Particles, Scene]:
    """A sand column (2200 kg/m^3) on the floor that collapses into a pile
    whose slope the friction angle sets (the `sand2d` scenario):
    materials.SAND with Klar et al. 2016's quartz sand (E = 3.537e5 Pa,
    nu = 0.3, phi = 35 degrees)."""
    cfg = cfg or MPMConfig(dtype=_dtype_name(dtype))
    l = cfg.domain_length
    w = width_frac * l
    h = height_frac * l
    floor_y = (PAD + 0.55) * cfg.dx  # just above the wall band
    nx, ny = particles_per_axis
    x = _lattice((nx, ny), (0.5 * (l - w), floor_y), (w, h))
    p = Particles.init(
        _host(x, dtype),
        volume0=w * h / (nx * ny),
        density=2200.0,
        material=torch.full((len(x),), mat.SAND, dtype=torch.int32),
    )
    scene = Scene(
        cfg=cfg,
        physics=physics,
        params=mat.MaterialParams(
            mu=youngs / (2 * (1 + poisson)),
            lam=youngs * poisson / ((1 + poisson) * (1 - 2 * poisson)),
            friction_angle=friction_angle,
        ),
        materials_present=(mat.SAND,),
        mass_floor=_floor_of(p),
    )
    return p, scene


def dam_break_obstacle_2d(
    cfg: Optional[MPMConfig] = None,
    physics: Physics = Physics(),
    dtype=np.float64,
    sticky: bool = False,
    center_frac: Tuple[float, float] = (0.55, 0.10),
    radius_frac: float = 0.08,
) -> Tuple[Particles, Scene]:
    """Dam break over a rigid cylinder in the run-out path (the
    `dam2d_obstacle` scenario): the collapsing column hits it and splits."""
    p, scene = dam_break_2d(cfg, physics=physics, dtype=dtype)
    l = scene.cfg.domain_length
    sphere = Collider(
        kind="sphere",
        center=(center_frac[0] * l, center_frac[1] * l),
        radius=radius_frac * l,
        sticky=sticky,
    )
    return p, dataclasses.replace(scene, colliders=(sphere,))


def plow_2d(
    cfg: Optional[MPMConfig] = None,
    physics: Physics = Physics(),
    dtype=np.float64,
    speed_frac: float = 0.25,
    sticky: bool = True,
) -> Tuple[Particles, Scene]:
    """A kinematic collider (the `plow2d` scenario): a rigid cylinder sweeps
    horizontally through the pool at constant velocity, `speed_frac` of
    the domain length per second, plowing material ahead of it."""
    p, scene = dam_break_2d(cfg, physics=physics, dtype=dtype)
    l = scene.cfg.domain_length
    plow = Collider(
        kind="sphere",
        center=(0.80 * l, 0.10 * l),
        radius=0.08 * l,
        sticky=sticky,
        center_velocity=(-speed_frac * l, 0.0),
    )
    return p, dataclasses.replace(scene, colliders=(plow,))


def _fluid_scene(cfg: MPMConfig, physics: Physics, p: Particles) -> Scene:
    """One weakly-compressible fluid between slip walls."""
    return Scene(
        cfg=cfg,
        physics=physics,
        params=mat.MaterialParams(
            bulk_modulus=physics.bulk_modulus,
            dynamic_viscosity=physics.dynamic_viscosity,
        ),
        wall=WallBC("slip"),
        mass_floor=_floor_of(p),
    )


def slab_3d(
    num_grids: int = 128,
    particles_per_axis: Tuple[int, int, int] = (256, 256, 16),
    height_frac: float = 0.125,
    physics: Physics = Physics(),
    dtype=np.float32,
    dt: float = 5e-6,
    flip_blend: float = 0.98,
) -> Tuple[Particles, Scene]:
    """3D fluid slab covering the whole floor: the load-balanced 3D bench
    workload (even pencil occupancy).  The defaults give 1M particles on
    128^3; BASELINE.json configs[3] is num_grids=256, (512, 512, 32)."""
    cfg = MPMConfig(
        dim=3,
        dtype=_dtype_name(dtype),
        num_grids=num_grids,
        dt=dt,
        flip_blend=flip_blend,
        transfer=TransferKind.PIC if flip_blend > 0 else TransferKind.APIC,
    )
    l = cfg.domain_length
    size = (0.98 * l, 0.98 * l, height_frac * l)
    x = _lattice(particles_per_axis, (0.0, 0.0, 0.0), size)
    vol = size[0] * size[1] * size[2] / len(x)
    p = Particles.init(_host(x, dtype), volume0=vol, density=physics.particle_density)
    return p, _fluid_scene(cfg, physics, p)


def dam_break_3d(
    num_grids: int = 64,
    particles_per_axis: Tuple[int, int, int] = (24, 24, 48),
    physics: Physics = Physics(),
    dtype=np.float32,
    dt: float = 1e-5,
    **cfg_kwargs,
) -> Tuple[Particles, Scene]:
    """3D free-surface column collapse (the `dam3d` scenario): a column a
    quarter of the box wide and half of it tall along the last axis, which
    gravity acts on.  Extra kwargs go to MPMConfig."""
    cfg = MPMConfig(
        dim=3, dtype=_dtype_name(dtype), num_grids=num_grids, dt=dt, **cfg_kwargs,
    )
    l = cfg.domain_length
    w = 0.25 * l
    h = 0.5 * l
    x = _lattice(particles_per_axis, (0.0, 0.0, 0.0), (w, w, h))
    vol = (w * h * w) / len(x)
    p = Particles.init(_host(x, dtype), volume0=vol, density=physics.particle_density)
    return p, _fluid_scene(cfg, physics, p)


def elastic_drop_3d(
    num_grids: int = 16,
    fluid_particles: Tuple[int, int, int] = (8, 8, 4),
    block_particles: Tuple[int, int, int] = (4, 4, 4),
    physics: Physics = Physics(),
    dtype=np.float32,
    dt: float = 2e-5,
    block_material: int = mat.NEO_HOOKEAN,
    plastic: bool = False,
    **cfg_kwargs,
) -> Tuple[Particles, Scene]:
    """3D mixed-material scene: an elastic block (E = 5e4 Pa, nu = 0.3,
    400 kg/m^3) dropped onto a fluid slab, the 3D analogue of
    `elastic_drop_2d` / BASELINE.json configs[2].  Extra kwargs go to
    MPMConfig."""
    cfg = MPMConfig(
        dim=3, dtype=_dtype_name(dtype), num_grids=num_grids, dt=dt, **cfg_kwargs,
    )
    l = cfg.domain_length
    fsize = (0.9 * l, 0.9 * l, 0.25 * l)
    fluid_x = _lattice(fluid_particles, (0.0, 0.0, 0.0), fsize)
    side = 0.2 * l
    block_x = _lattice(block_particles, (0.4 * l, 0.4 * l, 0.55 * l), (side,) * 3)
    x = np.concatenate([fluid_x, block_x], axis=0)
    material = np.concatenate([
        np.full(len(fluid_x), mat.WEAKLY_COMPRESSIBLE_FLUID, np.int32),
        np.full(len(block_x), block_material, np.int32),
    ])
    vol_f = fsize[0] * fsize[1] * fsize[2] / len(fluid_x)
    vol_b = side**3 / len(block_x)
    volume0 = np.concatenate([np.full(len(fluid_x), vol_f), np.full(len(block_x), vol_b)])
    density = np.concatenate(
        [np.full(len(fluid_x), physics.particle_density), np.full(len(block_x), 400.0)])
    p = Particles.init(
        _host(x, dtype),
        volume0=_host(volume0, dtype),
        density=_host(density, dtype),
        material=torch.from_numpy(material),
    )
    e_block, nu_block = 5e4, 0.3
    scene = Scene(
        cfg=cfg,
        physics=physics,
        params=mat.MaterialParams(
            bulk_modulus=physics.bulk_modulus,
            dynamic_viscosity=physics.dynamic_viscosity,
            mu=e_block / (2 * (1 + nu_block)),
            lam=e_block * nu_block / ((1 + nu_block) * (1 - 2 * nu_block)),
            plastic=plastic,
        ),
        materials_present=(mat.WEAKLY_COMPRESSIBLE_FLUID, block_material),
        wall=WallBC("slip"),
        mass_floor=_floor_of(p),
    )
    return p, scene


def dam_break_obstacle_3d(
    num_grids: int = 64,
    particles_per_axis: Tuple[int, int, int] = (24, 24, 48),
    physics: Physics = Physics(),
    dtype=np.float32,
    dt: float = 1e-5,
    center_frac: Tuple[float, float, float] = (0.55, 0.50, 0.12),
    radius_frac: float = 0.10,
    **cfg_kwargs,
) -> Tuple[Particles, Scene]:
    """3D dam break around a rigid sphere in the run-out path (the
    `dam3d_obstacle` scenario)."""
    p, scene = dam_break_3d(num_grids, particles_per_axis, physics, dtype, dt, **cfg_kwargs)
    l = scene.cfg.domain_length
    sphere = Collider(
        kind="sphere",
        center=tuple(c * l for c in center_frac),
        radius=radius_frac * l,
    )
    return p, dataclasses.replace(scene, colliders=(sphere,))
