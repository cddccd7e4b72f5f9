"""Material models (counterpart of `mpm_flip98a_tpu/models/materials.py`).

All stresses are the V0-scaled Kirchhoff stress
    tau_hat = V0 * P(F) F^T = V0 * J * sigma_cauchy        (shape (N, d, d))
that the MLS-MPM force term consumes (reference:
cpp_validation/mls-mpm88-explained.cpp:79-89).

Ported: the material ids, `MaterialParams`, the weakly-compressible fluid
(`fluid_pressure`, `fluid_tau_hat`), `neo_hookean_tau_hat`,
`fixed_corotated_tau_hat` (the polar decompositions of `ops/mathx`), the
`tau_hat` dispatch and `plastic_update` (the singular-value clamp of
FIXED_COROTATED under `params.plastic` and of SNOW, with SNOW's Jp).  The
fast paths compute the same stresses in component form
(`models/fast2d._stress`, `models/fast3d._stress`); these matrix forms
are the general path's and the fast paths' yardstick in the tests.  The
SNOW and SAND stresses and the sand return mapping wait for ROADMAP
queue 1, item 4.  Constants enter as Python floats rounded to the
tensors' dtype, so nothing is copied from the host on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mpm_flip98a_tpu_torch.config import EOSKind, np_float
from mpm_flip98a_tpu_torch.ops import mathx

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


def _scalar(v: float, like: torch.Tensor) -> float:
    """v rounded to like's dtype, as a Python float."""
    return float(np_float(like.dtype)(v))


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item 4)")


def fluid_pressure(params: MaterialParams, j_bar: torch.Tensor) -> torch.Tensor:
    """EOS pressure from the volume ratio: LINEAR p = -K (J - 1); TAIT
    p = (K / gamma) ((1/J)^gamma - 1), with J floored at 1e-3 as the
    kernels do."""
    k = _scalar(params.bulk_modulus, j_bar)
    if params.eos == EOSKind.LINEAR:
        return -k * (j_bar - 1.0)
    g = _scalar(params.tait_gamma, j_bar)
    nd = np_float(j_bar.dtype)
    k_over_g = float(nd(k) / nd(g))
    j_safe = torch.clamp(j_bar, min=1e-3)
    return k_over_g * (torch.pow(1.0 / j_safe, g) - 1.0)


def fluid_tau_hat(
    params: MaterialParams,
    volume0: torch.Tensor,
    j_bar: torch.Tensor,
    pressure: torch.Tensor,
    strain_rate: torch.Tensor,
) -> torch.Tensor:
    """Weakly-compressible viscous fluid: V0 J (-p I + 2 mu dev(eps_dot))."""
    d = strain_rate.shape[-1]
    eye = _eye(d, strain_rate)
    mu = _scalar(params.dynamic_viscosity, strain_rate)
    tr = strain_rate.diagonal(dim1=-2, dim2=-1).sum(-1)
    dev = strain_rate - (tr / d)[..., None, None] * eye
    sigma = (-pressure)[..., None, None] * eye + 2.0 * mu * dev
    return (volume0 * j_bar)[..., None, None] * sigma


def fixed_corotated_tau_hat(
    params: MaterialParams, volume0: torch.Tensor, f: torch.Tensor
) -> torch.Tensor:
    """V0 (2 mu (F - R) F^T + lambda (J - 1) J I)
    (reference: mls-mpm88-explained.cpp:81)."""
    d = f.shape[-1]
    j = mathx.det(f)
    r, _ = mathx.polar_decomp(f)
    mu, lam = _scalar(params.mu, f), _scalar(params.lam, f)
    pf = 2.0 * mu * mathx.mm(f - r, mathx.transpose(f)) + (
        (lam * (j - 1.0) * j)[..., None, None] * _eye(d, f)
    )
    return volume0[..., None, None] * pf


def neo_hookean_tau_hat(
    params: MaterialParams, volume0: torch.Tensor, f: torch.Tensor
) -> torch.Tensor:
    """V0 (mu (F F^T - I) + lambda log(J) I), J floored at 1e-6."""
    d = f.shape[-1]
    eye = _eye(d, f)
    j = torch.clamp(mathx.det(f), min=1e-6)
    mu, lam = _scalar(params.mu, f), _scalar(params.lam, f)
    b = mathx.mm(f, mathx.transpose(f))
    return volume0[..., None, None] * (
        mu * (b - eye) + (lam * torch.log(j))[..., None, None] * eye
    )


def plastic_update(
    params: MaterialParams,
    material: torch.Tensor,
    f: torch.Tensor,
    jp: torch.Tensor,
    materials_present: Tuple[int, ...] = (WEAKLY_COMPRESSIBLE_FLUID,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The snow-plasticity singular-value clamp and plastic volume
    tracking at F-update time (reference: mls-mpm88-explained.cpp:164-177):

        F  <- U clamp(Sigma) V^T
        Jp <- clamp(Jp det(F_old) / det(F_new), 0.6, 20)    [SNOW only]

    for SNOW particles, and for FIXED_COROTATED ones under
    `params.plastic` (their Jp stays as it is).  A static no-op unless the
    scene declares such a material.  Returns (F, Jp)."""
    clamp_fc = params.plastic and FIXED_COROTATED in materials_present
    has_snow = SNOW in materials_present
    if SAND in materials_present:
        raise _unported("the sand return mapping")
    if not clamp_fc and not has_snow:
        return f, jp
    nd = np_float(f.dtype)
    u, sig, v = mathx.svd(f)
    sig_c = torch.clamp(sig, min=float(nd(params.sig_clamp_lo)), max=float(nd(params.sig_clamp_hi)))
    f_c = mathx.mm(u, sig_c[..., :, None] * mathx.transpose(v))
    clamped = torch.zeros_like(material, dtype=torch.bool)
    if clamp_fc:
        clamped = clamped | (material == FIXED_COROTATED)
    if has_snow:
        old_j = torch.prod(sig, dim=-1)
        new_j = torch.prod(sig_c, dim=-1)
        jp_c = torch.clamp(
            jp * old_j / torch.clamp(new_j, min=float(nd(1e-12))),
            min=float(nd(params.jp_clamp_lo)), max=float(nd(params.jp_clamp_hi)),
        )
        clamped = clamped | (material == SNOW)
        jp = torch.where(material == SNOW, jp_c, jp)
    if all(m == SNOW or (m == FIXED_COROTATED and clamp_fc) for m in materials_present):
        return f_c, jp
    return torch.where(clamped[..., None, None], f_c, f), jp


def tau_hat(
    params: MaterialParams,
    material: torch.Tensor,
    volume0: torch.Tensor,
    f: torch.Tensor,
    j_bar: torch.Tensor,
    pressure: torch.Tensor,
    strain_rate: torch.Tensor,
    materials_present: Tuple[int, ...] = (WEAKLY_COMPRESSIBLE_FLUID,),
    jp: torch.Tensor = None,
) -> torch.Tensor:
    """Dispatch on the per-particle material id; only the branches of
    `materials_present` are evaluated.  `jp` (Particles.Jp) is the SNOW
    branch's hardening state."""

    def branch(mid):
        if mid == WEAKLY_COMPRESSIBLE_FLUID:
            return fluid_tau_hat(params, volume0, j_bar, pressure, strain_rate)
        if mid == NEO_HOOKEAN:
            return neo_hookean_tau_hat(params, volume0, f)
        if mid == FIXED_COROTATED:
            return fixed_corotated_tau_hat(params, volume0, f)
        raise _unported(f"the stress of material {mid} (snow / sand)")

    if len(materials_present) == 1:
        return branch(materials_present[0])
    out = torch.zeros_like(f)
    for mid in materials_present:
        out = torch.where((material == mid)[..., None, None], branch(mid), out)
    return out
