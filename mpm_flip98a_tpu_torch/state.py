"""Particle state of the port (counterpart of `mpm_flip98a_tpu/state.py`).

Frozen dataclasses of tensors, structure-of-arrays with the particle (or
grid node) index leading and small per-particle matrices trailing
(..., d, d).  Scene builders make `Particles` on the host in the scene's
dtype (float64 by default); the general path moves it to its device as it
is (`to_device`), the fast path casts it to float32 in
`models/fast2d.from_particles` (bfloat16 too, as the JAX package does).
`Grid` is the general path's post-update grid, `MLS88Particles` the
validation model's state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def host_array(t: torch.Tensor) -> np.ndarray:
    """t as a numpy array on the host; bfloat16, which numpy lacks, widened
    to float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# How a host array holds bfloat16 values, which numpy lacks: 2-byte records
# of their bits (the JAX package's checkpoint layout).
BF16_RECORD = np.dtype("V2")


def host_bits(t: torch.Tensor) -> np.ndarray:
    """t as a numpy array on the host with its bits: bfloat16 as
    `BF16_RECORD`s, every other dtype as it is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def from_host_bits(a: np.ndarray, device="cpu") -> torch.Tensor:
    """The tensor of `host_bits`' array `a` (a copy) on `device`."""
    a = np.array(a, order="C")
    if a.dtype == BF16_RECORD:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_device(state, device):
    """A copy of the dataclass of tensors `state` with every field on `device`."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)
    })


@dataclasses.dataclass(frozen=True)
class MLS88Particles:
    """Particle state of the validation model
    (reference: cpp_validation/mls-mpm88-explained.cpp:28-42).

    x : (N, d)    position
    v : (N, d)    velocity
    F : (N, d, d) deformation gradient
    C : (N, d, d) APIC affine velocity matrix
    Jp: (N,)      plastic volume ratio
    """

    x: torch.Tensor
    v: torch.Tensor
    F: torch.Tensor
    C: torch.Tensor
    Jp: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @staticmethod
    def init(x: torch.Tensor, v: Optional[torch.Tensor] = None) -> "MLS88Particles":
        n, d = x.shape
        dt, dev = x.dtype, x.device
        return MLS88Particles(
            x=x,
            v=torch.zeros((n, d), dtype=dt, device=dev) if v is None else v.to(dtype=dt, device=dev),
            F=torch.eye(d, dtype=dt, device=dev).expand(n, d, d).clone(),
            C=torch.zeros((n, d, d), dtype=dt, device=dev),
            Jp=torch.ones((n,), dtype=dt, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class Particles:
    """Full particle state of the stabilized solver
    (reference: fields.py:4-21 ``ParticleFields``).

      x, v          : (N, d)      position / velocity
      C             : (N, d, d)   velocity gradient (APIC)
      F             : (N, d, d)   deformation gradient
      J             : (N,)        det(F)
      stress        : (N, d, d)   Cauchy stress
      material      : (N,) int32  material id
      volume0, mass, density, pressure, div_v : (N,)
      pou           : (N,)        partition-of-unity diagnostic
      consistency   : (N, d)      linear-field reproduction diagnostic
      Jp            : (N,)        plastic volume ratio (SNOW state)
    """

    x: torch.Tensor
    v: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    J: torch.Tensor
    stress: torch.Tensor
    material: torch.Tensor
    volume0: torch.Tensor
    mass: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    div_v: torch.Tensor
    pou: torch.Tensor
    consistency: torch.Tensor
    Jp: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @staticmethod
    def init(
        x: torch.Tensor,
        *,
        volume0,
        density,
        material: Optional[torch.Tensor] = None,
        v: Optional[torch.Tensor] = None,
    ) -> "Particles":
        """Particles with F = I, J = 1 (reference state.py:120).

        `volume0` and `density` are scalars or per-particle arrays, cast to
        x's dtype; `material` defaults to 0 (fluid), `v` to rest."""
        n, d = x.shape
        dt, dev = x.dtype, x.device
        per_particle = lambda val: torch.as_tensor(val, dtype=dt, device=dev).expand(n).clone()
        zeros = lambda *s: torch.zeros((n,) + s, dtype=dt, device=dev)
        volume0, density = per_particle(volume0), per_particle(density)
        return Particles(
            x=x,
            v=zeros(d) if v is None else v.to(dtype=dt, device=dev),
            C=zeros(d, d),
            F=torch.eye(d, dtype=dt, device=dev).expand(n, d, d).clone(),
            J=torch.ones((n,), dtype=dt, device=dev),
            stress=zeros(d, d),
            material=(
                torch.zeros((n,), dtype=torch.int32, device=dev) if material is None
                else torch.as_tensor(material, device=dev).to(torch.int32)
            ),
            volume0=volume0,
            mass=volume0 * density,
            density=density,
            pressure=zeros(),
            div_v=zeros(),
            pou=zeros(),
            consistency=zeros(d),
            Jp=torch.ones((n,), dtype=dt, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class Grid:
    """Grid state of the stabilized solver (reference: fields.py:24-30).

    v       : (G..., d)     nodal velocity
    v0      : (G..., d)     pre-force velocity for the FLIP delta
    m       : (G..., d, d)  matrix-valued nodal mass
    volume  : (G...,)       nodal volume
    pressure: (G...,)       nodal pressure
    """

    v: torch.Tensor
    v0: torch.Tensor
    m: torch.Tensor
    volume: torch.Tensor
    pressure: torch.Tensor
