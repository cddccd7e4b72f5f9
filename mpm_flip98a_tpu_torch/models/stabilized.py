"""Scene bundle and wall settings (counterpart of `mpm_flip98a_tpu/models/stabilized.py`).

Only the pieces the fast path shares with the general solver: the grid
padding `PAD`, `WallBC`, `Scene` and the grid-mass floor.  The general
stabilized solver itself is not ported yet (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, Physics
from mpm_flip98a_tpu_torch.models import materials as mat

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


def _mass_floor(scene: Scene, g_m: torch.Tensor, sharded: bool = False) -> torch.Tensor:
    """Grid-mass emptiness threshold (see Scene.mass_floor).  With
    `sharded` (g_m with the slab shard as dim 0) the relative floor is each
    shard's own: the reference takes it on the shard-local sums, no pmax."""
    if scene.mass_floor > 0.0:
        return torch.tensor(scene.mass_floor, dtype=g_m.dtype, device=g_m.device)
    tiny = torch.tensor(1e-8, dtype=g_m.dtype, device=g_m.device)
    if sharded:
        return tiny * g_m.amax(dim=tuple(range(1, g_m.dim())), keepdim=True)
    return tiny * g_m.max()
