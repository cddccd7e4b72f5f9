"""Carry state from the JAX package into the port.

The system has no learned weights; what crosses over is simulation state
and static configuration.  Each function takes plain Python / numpy data
(the JAX package's dataclasses as `dataclasses.asdict`, arrays as numpy),
so this module imports neither JAX nor the JAX package:

    particles_from_numpy({f.name: np.asarray(getattr(p, f.name)) ...}, device)
    mls88_particles_from_numpy({... the same for an MLS88Particles ...}, device)
    buckets_from_numpy({f.name: np.asarray(getattr(b, f.name)) ...}, device)
    buckets3d_from_numpy(... the same for a 3D FluidBuckets3D ...)
    scene_from_fields(dataclasses.asdict(scene))
    domain_state_from_numpy({... a domain state's particles ...}, dropped, rank, n, device)

Arrays keep their dtype and bits; the tests use this to feed both
packages the same state.  A JAX bfloat16 array (numpy dtype name
"bfloat16", from `ml_dtypes`, which this module does not import) becomes
a torch bfloat16 tensor through its 16-bit patterns (`bf16_tensor`), and
so does an array of the port's own `state.BF16_RECORD`s (`state.host_bits`),
which is how the rank workers carry bfloat16 fields.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import (
    EOSKind, KernelKind, MPMConfig, Physics, TransferKind,
)
from mpm_flip98a_tpu_torch.models.colliders import Collider
from mpm_flip98a_tpu_torch.models.fast2d import FluidBuckets
from mpm_flip98a_tpu_torch.models.fast3d import FluidBuckets3D
from mpm_flip98a_tpu_torch.models.materials import MaterialParams
from mpm_flip98a_tpu_torch.models.stabilized import Scene, WallBC
from mpm_flip98a_tpu_torch.parallel.domain import DomainState
from mpm_flip98a_tpu_torch.state import MLS88Particles, Particles, from_host_bits


def is_bf16(a) -> bool:
    """Whether the numpy array `a` holds bfloat16 values."""
    return getattr(getattr(a, "dtype", None), "name", None) == "bfloat16"


def bf16_tensor(a, device="cpu") -> torch.Tensor:
    """A numpy bfloat16 array as a torch bfloat16 tensor with the same bits
    (a 16-bit view: numpy's bfloat16 is `ml_dtypes`' extension type)."""
    bits = np.array(a, copy=True, order="C").view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def _tensor(a, device="cuda") -> torch.Tensor:
    """A numpy array as a tensor with its bits: `bf16_tensor` for a JAX
    bfloat16 array, `state.from_host_bits` for the rest (bfloat16 held as
    `state.BF16_RECORD`s included)."""
    if is_bf16(a):
        return bf16_tensor(a, device)
    return from_host_bits(a, device)


def _names(cls) -> list:
    return [f.name for f in dataclasses.fields(cls)]


def particles_from_numpy(fields: Mapping[str, np.ndarray], device="cuda") -> Particles:
    """The JAX `Particles` fields (numpy) -> the port's `Particles`."""
    return Particles(**{n: _tensor(fields[n], device) for n in _names(Particles)})


def mls88_particles_from_numpy(fields: Mapping[str, np.ndarray], device="cuda") -> MLS88Particles:
    """The JAX `MLS88Particles` fields (numpy) -> the port's `MLS88Particles`."""
    return MLS88Particles(**{n: _tensor(fields[n], device) for n in _names(MLS88Particles)})


def buckets_from_numpy(fields: Mapping[str, np.ndarray], device="cuda") -> FluidBuckets:
    """The JAX `FluidBuckets` fields (numpy) -> the port's `FluidBuckets`."""
    out = {n: _tensor(fields[n], device) for n in _names(FluidBuckets)}
    out["overflow"] = out["overflow"].to(torch.int32).reshape(())
    return FluidBuckets(**out)


def buckets3d_from_numpy(fields: Mapping[str, np.ndarray], device="cuda") -> FluidBuckets3D:
    """The JAX `FluidBuckets3D` fields (numpy) -> the port's `FluidBuckets3D`."""
    out = {n: _tensor(fields[n], device) for n in _names(FluidBuckets3D)}
    out["overflow"] = out["overflow"].to(torch.int32).reshape(())
    return FluidBuckets3D(**out)


def domain_state_from_numpy(fields: Mapping[str, np.ndarray], dropped, rank: int, n: int,
                            device="cuda") -> DomainState:
    """Rank `rank`'s shard of a JAX `DomainState` of n shards: its
    particles' fields (numpy, (n capacity, ...) in shard order) and its
    (n,) `dropped`, as the port's `parallel.domain.DomainState`."""
    cap = len(fields["x"]) // n
    mine = slice(rank * cap, (rank + 1) * cap)
    return DomainState(
        particles=Particles(**{f: _tensor(np.asarray(fields[f])[mine], device)
                               for f in _names(Particles)}),
        dropped=_tensor(np.asarray(dropped, np.int32)[rank:rank + 1], device),
    )


def _enum(cls, v):
    return cls(getattr(v, "value", v))


def scene_from_fields(fields: Mapping) -> Scene:
    """`dataclasses.asdict` of a JAX `Scene` -> the port's `Scene`; its
    colliders (a tuple of dicts) become the port's `Collider`s."""
    c = dict(fields["cfg"])
    c["transfer"] = _enum(TransferKind, c["transfer"])
    c["kernel"] = _enum(KernelKind, c["kernel"])
    c["eos"] = _enum(EOSKind, c["eos"])
    params = dict(fields["params"])
    params["eos"] = _enum(EOSKind, params["eos"])
    return Scene(
        cfg=MPMConfig(**c),
        physics=Physics(**fields["physics"]),
        params=MaterialParams(**params),
        materials_present=tuple(int(m) for m in fields["materials_present"]),
        wall=WallBC(**fields["wall"]),
        colliders=tuple(
            Collider(**{n: tuple(v) if isinstance(v, (list, tuple)) else v
                        for n, v in col.items()})
            for col in fields.get("colliders", ())
        ),
        mass_floor=float(fields["mass_floor"]),
    )
