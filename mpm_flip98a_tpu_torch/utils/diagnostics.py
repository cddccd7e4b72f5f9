"""Physics diagnostics (counterpart of `mpm_flip98a_tpu/utils/diagnostics.py`).

The global invariants of a particle state (total mass and momentum,
kinetic energy, the volume-ratio range) beside the reference's
per-particle consistency fields (partitionofUnity, consistency_dx/dy,
fields.py:15-18), as reductions on the state's device.
"""

from __future__ import annotations

from typing import Dict

import torch

from mpm_flip98a_tpu_torch.state import Particles


def summarize(p: Particles) -> Dict[str, torch.Tensor]:
    """Global invariants of a particle state, as 0-d tensors on its device."""
    live = p.mass > 0
    return {
        "total_mass": torch.sum(p.mass),
        "momentum_x": torch.sum(p.mass * p.v[:, 0]),
        "momentum_y": torch.sum(p.mass * p.v[:, -1]),
        "kinetic_energy": 0.5 * torch.sum(p.mass * torch.sum(p.v ** 2, dim=-1)),
        "j_min": torch.min(torch.where(live, p.J, 1.0)),
        "j_max": torch.max(torch.where(live, p.J, 1.0)),
        "pou_err": torch.max(torch.where(live, torch.abs(p.pou - 1.0), 0.0)),
        "consistency_err": torch.max(torch.where(live[:, None], torch.abs(p.consistency), 0.0)),
    }


def check(p: Particles, mass0: float, rtol: float = 1e-9) -> Dict[str, float]:
    """The summary as host floats; raises on a mass budget violation (mass
    is conserved exactly by construction)."""
    summary = summarize(p)
    s = dict(zip(summary, torch.stack(list(summary.values())).tolist()))   # one host copy
    if abs(s["total_mass"] - mass0) > rtol * max(mass0, 1.0):
        raise AssertionError(f"mass not conserved: {s['total_mass']} != {mass0}")
    return s
