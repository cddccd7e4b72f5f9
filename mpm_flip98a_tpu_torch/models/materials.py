"""Material models (counterpart of `mpm_flip98a_tpu/models/materials.py`).

All stresses are the V0-scaled Kirchhoff stress
    tau_hat = V0 * P(F) F^T = V0 * J * sigma_cauchy        (shape (N, d, d))
that the MLS-MPM force term consumes (reference:
cpp_validation/mls-mpm88-explained.cpp:79-89).

Every material of the JAX module: the weakly-compressible fluid
(`fluid_pressure`, `fluid_tau_hat`), `neo_hookean_tau_hat`,
`fixed_corotated_tau_hat` (the polar decompositions of `ops/mathx`), SNOW
(`snow_tau_hat`: the corotated stress with Lame parameters hardened by
the tracked plastic volume Jp) and Drucker-Prager SAND (`sand_tau_hat`:
St. Venant-Kirchhoff on the Hencky strain; `sand_return`: the return map
of the log singular values onto the friction cone, Klar et al. 2016), the
`tau_hat` dispatch and `plastic_update` (the singular-value clamp of
FIXED_COROTATED under `params.plastic` and of SNOW with SNOW's Jp, and
the cone projection of SAND).  The fast paths compute the fluid and the
elastic stresses in component form (`models/fast2d._stress`,
`models/fast3d._stress`) and sand through these matrix forms.  Constants
enter as Python floats rounded to the tensors' dtype, so nothing is
copied from the host on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from mpm_flip98a_tpu_torch.config import EOSKind, np_float, scalar
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


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def fluid_pressure(params: MaterialParams, j_bar: torch.Tensor) -> torch.Tensor:
    """EOS pressure from the volume ratio: LINEAR p = -K (J - 1); TAIT
    p = (K / gamma) ((1/J)^gamma - 1), with J floored at 1e-3 as the
    kernels do."""
    k = scalar(params.bulk_modulus, j_bar.dtype)
    if params.eos == EOSKind.LINEAR:
        return -k * (j_bar - 1.0)
    g = scalar(params.tait_gamma, j_bar.dtype)
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
    mu = scalar(params.dynamic_viscosity, strain_rate.dtype)
    tr = mathx.trace(strain_rate)
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
    mu, lam = scalar(params.mu, f.dtype), scalar(params.lam, f.dtype)
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
    mu, lam = scalar(params.mu, f.dtype), scalar(params.lam, f.dtype)
    b = mathx.mm(f, mathx.transpose(f))
    return volume0[..., None, None] * (
        mu * (b - eye) + (lam * torch.log(j))[..., None, None] * eye
    )


def snow_tau_hat(
    params: MaterialParams, volume0: torch.Tensor, f: torch.Tensor, jp: torch.Tensor
) -> torch.Tensor:
    """Fixed corotated with hardening-scaled Lame parameters
    (mls-mpm88-explained.cpp:67-69,81): h = exp(hardening (1 - Jp)),
    V0 (2 mu0 h (F - R) F^T + lam0 h (J - 1) J I)."""
    d = f.shape[-1]
    h = torch.exp(scalar(params.hardening, f.dtype) * (1.0 - jp))
    j = mathx.det(f)
    r, _ = mathx.polar_decomp(f)
    mu = scalar(params.mu, f.dtype) * h
    lam = scalar(params.lam, f.dtype) * h
    pf = 2.0 * mu[..., None, None] * mathx.mm(f - r, mathx.transpose(f)) + (
        (lam * (j - 1.0) * j)[..., None, None] * _eye(d, f)
    )
    return volume0[..., None, None] * pf


def sand_alpha(params: MaterialParams) -> float:
    """Drucker-Prager yield-surface slope from the friction angle
    (Klar et al. 2016 eq. 28): alpha = sqrt(2/3) 2 sin(phi) / (3 - sin(phi))."""
    s = math.sin(math.radians(params.friction_angle))
    return math.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s)


def _hencky(f: torch.Tensor):
    """SVD and the log singular values, floored at 1e-4 against collapsed
    or inverted slots: (U, sig, V, eps)."""
    u, sig, v = mathx.svd(f)
    return u, sig, v, torch.log(torch.clamp(sig, min=scalar(1e-4, f.dtype)))


def sand_tau_hat(
    params: MaterialParams, volume0: torch.Tensor, f: torch.Tensor
) -> torch.Tensor:
    """Hencky-strain St. Venant-Kirchhoff stress (Klar et al. 2016 eq. 26):
    V0 U (2 mu eps + lam tr(eps) I) U^T with eps = log(Sigma)."""
    u, _, _, eps = _hencky(f)
    mu, lam = scalar(params.mu, f.dtype), scalar(params.lam, f.dtype)
    diag = 2.0 * mu * eps + (lam * mathx.seq_sum(eps, -1))[..., None]
    tau = mathx.mm(u * diag[..., None, :], mathx.transpose(u))
    return volume0[..., None, None] * tau


def _sand_project_eps(params: MaterialParams, eps: torch.Tensor, d: int) -> torch.Tensor:
    """Return-map the Hencky strain onto the cohesionless Drucker-Prager
    cone (Klar et al. 2016, alg. 1): expansion (tr eps > 0) goes to the tip
    eps = 0; dg <= 0 is elastic and unchanged; otherwise
    eps - dg dev(eps) / |dev(eps)| with
    dg = |dev(eps)| + alpha (d lam + 2 mu) / (2 mu) tr(eps), |dev(eps)|
    floored at 1e-12.  The cone's coefficient is rounded in eps's dtype at
    each step, as the reference's 0-d arrays are."""
    nd = np_float(eps.dtype)
    mu, lam, alpha = nd(params.mu), nd(params.lam), nd(sand_alpha(params))
    coef = float(alpha * (nd(d) * lam + nd(2.0) * mu) / (nd(2.0) * mu))
    tr = mathx.seq_sum(eps, -1)
    ehat = eps - (tr / d)[..., None]
    en = torch.sqrt(mathx.seq_sum(ehat * ehat, -1))
    dg = en + coef * tr
    en_safe = torch.clamp(en, min=float(nd(1e-12)))
    eps_proj = eps - (dg / en_safe)[..., None] * ehat
    eps_new = torch.where((dg > 0)[..., None], eps_proj, eps)
    return torch.where((tr > 0)[..., None], torch.zeros_like(eps), eps_new)


def sand_return(params: MaterialParams, f: torch.Tensor) -> torch.Tensor:
    """The plastic return map at F-update time: F <- U exp(eps') V^T with
    eps' the cone-projected Hencky strain.  An elastic state keeps F
    bitwise: only the projected states are rebuilt."""
    u, _, v, eps = _hencky(f)
    eps_new = _sand_project_eps(params, eps, f.shape[-1])
    changed = torch.any(eps_new != eps, dim=-1)
    rebuilt = mathx.mm(u * torch.exp(eps_new)[..., None, :], mathx.transpose(v))
    return torch.where(changed[..., None, None], rebuilt, f)


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
    `params.plastic` (their Jp stays as it is); SAND particles take the
    Drucker-Prager cone projection (`sand_return`) instead.  A static
    no-op unless the scene declares such a material.  Returns (F, Jp)."""
    clamp_fc = params.plastic and FIXED_COROTATED in materials_present
    has_snow = SNOW in materials_present
    has_sand = SAND in materials_present
    if not clamp_fc and not has_snow and not has_sand:
        return f, jp
    if has_sand and not clamp_fc and not has_snow:
        if all(m == SAND for m in materials_present):
            return sand_return(params, f), jp
        return torch.where((material == SAND)[..., None, None], sand_return(params, f), f), jp
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
    if has_sand:
        # Sand beside a clamping material: cone-project the sand slots.
        f = torch.where((material == SAND)[..., None, None], sand_return(params, f), f)
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
    branch's hardening state.  An unknown id takes the corotated stress,
    as in the reference."""

    def branch(mid):
        if mid == WEAKLY_COMPRESSIBLE_FLUID:
            return fluid_tau_hat(params, volume0, j_bar, pressure, strain_rate)
        if mid == NEO_HOOKEAN:
            return neo_hookean_tau_hat(params, volume0, f)
        if mid == SNOW:
            return snow_tau_hat(params, volume0, f, jp)
        if mid == SAND:
            return sand_tau_hat(params, volume0, f)
        return fixed_corotated_tau_hat(params, volume0, f)

    if len(materials_present) == 1:
        return branch(materials_present[0])
    out = torch.zeros_like(f)
    for mid in materials_present:
        out = torch.where((material == mid)[..., None, None], branch(mid), out)
    return out
