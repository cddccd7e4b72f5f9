"""Material models (counterpart of `mpm_flip98a_tpu/models/materials.py`).

All stresses are the V0-scaled Kirchhoff stress
    tau_hat = V0 * P(F) F^T = V0 * J * sigma_cauchy        (shape (N, d, d))
that the MLS-MPM force term consumes (reference:
cpp_validation/mls-mpm88-explained.cpp:79-89).

Ported: the material ids, `MaterialParams`, the weakly-compressible fluid
(`fluid_pressure`, `fluid_tau_hat`), `neo_hookean_tau_hat`,
`fixed_corotated_tau_hat` (the closed-form 2D polar and the scaled-Newton
3D polar of mpm_flip98a_tpu/ops/mathx.py:64-82, :131-150) and the
`tau_hat` dispatch.  The fast paths compute the same stresses in
component form (`models/fast2d._stress`, `models/fast3d._stress`); these
matrix forms are their yardstick in the tests.  Snow, sand and
`plastic_update` need the SVD and wait for ROADMAP queue 1, items 3-4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _det(f: torch.Tensor) -> torch.Tensor:
    if f.shape[-1] == 2:
        return f[..., 0, 0] * f[..., 1, 1] - f[..., 0, 1] * f[..., 1, 0]
    return (
        f[..., 0, 0] * (f[..., 1, 1] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 1])
        - f[..., 0, 1] * (f[..., 1, 0] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 0])
        + f[..., 0, 2] * (f[..., 1, 0] * f[..., 2, 1] - f[..., 1, 1] * f[..., 2, 0])
    )


def _polar_rotation(f: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """R of the polar decomposition F = R S: in 2D the closed form from
    the trace/skew pair (reference: taichi.h:8375-8385), in 3D the scaled
    Newton iteration R <- (gamma R + R^-T / gamma) / 2 with Frobenius
    scaling (mathx.polar_decomp_3d), which converges quadratically for the
    near-identity, positive-determinant F that MPM produces."""
    if f.shape[-1] == 2:
        x = f[..., 0, 0] + f[..., 1, 1]
        y = f[..., 1, 0] - f[..., 0, 1]
        scale = 1.0 / torch.sqrt(x * x + y * y)
        c, s = x * scale, y * scale
        return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    r = f
    tiny = torch.finfo(f.dtype).tiny
    for _ in range(iters):
        r_inv_t = torch.linalg.inv(r).transpose(-1, -2)
        a = torch.sqrt((r_inv_t * r_inv_t).sum(dim=(-2, -1)))
        b = torch.sqrt((r * r).sum(dim=(-2, -1)))
        gamma = torch.sqrt(a / b.clamp(min=tiny))[..., None, None]
        r = 0.5 * (gamma * r + r_inv_t / gamma)
    return r


def fluid_pressure(params: MaterialParams, j_bar: torch.Tensor) -> torch.Tensor:
    """EOS pressure from the volume ratio: LINEAR p = -K (J - 1); TAIT
    p = (K / gamma) ((1/J)^gamma - 1), with J floored at 1e-3 as the
    kernels do."""
    k = _scalar(params.bulk_modulus, j_bar)
    if params.eos == EOSKind.LINEAR:
        return -k * (j_bar - 1.0)
    g = _scalar(params.tait_gamma, j_bar)
    j_safe = torch.clamp(j_bar, min=1e-3)
    return (k / g) * (torch.pow(1.0 / j_safe, g) - 1.0)


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
    j = _det(f)
    r = _polar_rotation(f)
    mu, lam = _scalar(params.mu, f), _scalar(params.lam, f)
    pf = 2.0 * mu * ((f - r) @ f.transpose(-1, -2)) + (
        (lam * (j - 1.0) * j)[..., None, None] * _eye(d, f)
    )
    return volume0[..., None, None] * pf


def neo_hookean_tau_hat(
    params: MaterialParams, volume0: torch.Tensor, f: torch.Tensor
) -> torch.Tensor:
    """V0 (mu (F F^T - I) + lambda log(J) I), J floored at 1e-6."""
    d = f.shape[-1]
    eye = _eye(d, f)
    j = torch.clamp(_det(f), min=1e-6)
    mu, lam = _scalar(params.mu, f), _scalar(params.lam, f)
    b = f @ f.transpose(-1, -2)
    return volume0[..., None, None] * (
        mu * (b - eye) + (lam * torch.log(j))[..., None, None] * eye
    )


def tau_hat(
    params: MaterialParams,
    material: torch.Tensor,
    volume0: torch.Tensor,
    f: torch.Tensor,
    j_bar: torch.Tensor,
    pressure: torch.Tensor,
    strain_rate: torch.Tensor,
    materials_present: Tuple[int, ...] = (WEAKLY_COMPRESSIBLE_FLUID,),
) -> torch.Tensor:
    """Dispatch on the per-particle material id; only the branches of
    `materials_present` are evaluated."""

    def branch(mid):
        if mid == WEAKLY_COMPRESSIBLE_FLUID:
            return fluid_tau_hat(params, volume0, j_bar, pressure, strain_rate)
        if mid == NEO_HOOKEAN:
            return neo_hookean_tau_hat(params, volume0, f)
        if mid == FIXED_COROTATED:
            return fixed_corotated_tau_hat(params, volume0, f)
        raise NotImplementedError(
            f"material {mid} (snow / sand) is not ported yet (ROADMAP queue 1, item 4)"
        )

    if len(materials_present) == 1:
        return branch(materials_present[0])
    out = torch.zeros_like(f)
    for mid in materials_present:
        out = torch.where((material == mid)[..., None, None], branch(mid), out)
    return out
