"""Material ids and constants (counterpart of `mpm_flip98a_tpu/models/materials.py`).

Only what the fast 2D fluid path needs: the per-particle material ids and
`MaterialParams`.  The fused P2G kernel computes the weakly-compressible
fluid stress itself, so the stress functions and the plasticity updates
wait for the full switch matrix (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses

from mpm_flip98a_tpu_torch.config import EOSKind

# Material ids (per-particle, int32; reference: fields.py:12).
WEAKLY_COMPRESSIBLE_FLUID = 0
NEO_HOOKEAN = 1
FIXED_COROTATED = 2
SNOW = 3
SAND = 4


@dataclasses.dataclass(frozen=True)
class MaterialParams:
    """Static per-simulation material constants."""

    # fluid
    bulk_modulus: float = 2e6          # K [Pa], config.py:8
    dynamic_viscosity: float = 1e-3    # mu [Pa s], config.py:6
    eos: EOSKind = EOSKind.LINEAR
    tait_gamma: float = 7.0
    # elastic solids (lame parameters)
    mu: float = 0.0
    lam: float = 0.0
    # snow plasticity clamp for FIXED_COROTATED (mls-mpm88-explained.cpp:169)
    plastic: bool = False
    sig_clamp_lo: float = 1.0 - 2.5e-2
    sig_clamp_hi: float = 1.0 + 7.5e-3
    # SNOW hardening and Jp clamp bounds (mls-mpm88-explained.cpp:17-19,172-177)
    hardening: float = 10.0
    jp_clamp_lo: float = 0.6
    jp_clamp_hi: float = 20.0
    # SAND Drucker-Prager friction angle [degrees]
    friction_angle: float = 35.0
