"""The switch rule in bfloat16, 3D: where the JAX package runs a switch,
material or collider on bf16 particles the port runs it bit for bit, and
where JAX raises the port raises the same exception class.

Every case is one substep of the general path from JAX's
`scenes.dam_break_3d(16, (8, 8, 8), dtype=jnp.bfloat16)` (512 particles on
16^3, dt 1e-5) thrown at about 1 m/s from a numpy seed, carried across with
`convert`; the solids take the column's upper half (same shapes in every
case, so JAX's eager programs compile once).  What each case does in JAX
bf16 on the CPU, and so in the port:

  apic, flip98               the transfers                       runs, bitwise
  tent                       the tent kernel (D inverted)        runs, bitwise
  stabilized                 F-bar, penalty walls, mixing 1.0    runs, bitwise
  incompressible             the Chorin projection's CG          runs, bitwise
  surface_tension            CSF (sigma 5)                       runs, bitwise
  obstacle                   a static sphere collider            runs, bitwise
  neo_hookean                an elastic solid (no decomposition) runs, bitwise
  corotated, corotated_plastic, snow, sand
                             the 3D polar decomposition and SVD: raise
                             NotImplementedError (JAX's jnp.linalg.inv and
                             eigh have no bfloat16 kernel on the CPU; the
                             port's polar_decomp_3d raises it too)
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import KernelKind, TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.models.colliders import Collider as ColliderJax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import stabilized

FLIP = dict(flip_blend=0.98, transfer=TransferKind.PIC)
E_SOLID, NU_SOLID = 5e4, 0.3
LAME = dict(mu=E_SOLID / (2 * (1 + NU_SOLID)),
            lam=E_SOLID * NU_SOLID / ((1 + NU_SOLID) * (1 - 2 * NU_SOLID)))

CASES = {
    "apic": dict(),
    "flip98": dict(FLIP),
    "tent": dict(kernel=KernelKind.TENT),
    "stabilized": dict(FLIP, use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0),
    "incompressible": dict(FLIP, incompressible=True),
    "surface_tension": dict(surface_tension=5.0),
    "obstacle": dict(),
    "neo_hookean": dict(),
    "corotated": dict(),
    "corotated_plastic": dict(),
    "snow": dict(),
    "sand": dict(),
}
SOLIDS = {"neo_hookean": mat_jax.NEO_HOOKEAN, "corotated": mat_jax.FIXED_COROTATED,
          "corotated_plastic": mat_jax.FIXED_COROTATED, "snow": mat_jax.SNOW,
          "sand": mat_jax.SAND}
RAISES = {"corotated", "corotated_plastic", "snow", "sand"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _build(name):
    """(JAX bf16 particles, JAX scene) of one case."""
    p, scene = scenes_jax.dam_break_3d(16, (8, 8, 8), dtype=jnp.bfloat16, **CASES[name])
    rng = np.random.default_rng(8)
    v = rng.standard_normal(np.asarray(p.v).shape)
    p = dataclasses.replace(p, v=jnp.asarray(v, jnp.float32).astype(jnp.bfloat16))
    l = scene.cfg.domain_length
    if name == "obstacle":
        col = ColliderJax(kind="sphere", center=(0.10 * l, 0.10 * l, 0.10 * l), radius=0.08 * l)
        scene = dataclasses.replace(scene, colliders=(col,))
    elif name in SOLIDS:
        z = np.asarray(p.x)[:, 2].astype(np.float32)
        material = np.where(z > np.median(z), SOLIDS[name], mat_jax.WEAKLY_COMPRESSIBLE_FLUID)
        p = dataclasses.replace(p, material=jnp.asarray(material, jnp.int32))
        params = dataclasses.replace(scene.params, **LAME,
                                     plastic=name == "corotated_plastic")
        scene = dataclasses.replace(
            scene, params=params,
            materials_present=(mat_jax.WEAKLY_COMPRESSIBLE_FLUID, SOLIDS[name]))
    return p, scene


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_switch_rule_3d(name):
    """One bf16 substep: JAX's eager substep and the port's bitwise on every
    field, or both raise the same exception class (NotImplementedError
    exactly where RAISES says)."""
    pj, scene = _build(name)
    pt = convert.particles_from_numpy({f: np.asarray(getattr(pj, f))
                                       for f in pj.__dataclass_fields__}, "cpu")
    sc = convert.scene_from_fields(dataclasses.asdict(scene))
    try:
        want = stab_jax.substep(pj, scene)
    except Exception as e:                                   # noqa: BLE001 - the class is the claim
        assert name in RAISES and isinstance(e, NotImplementedError)
        with pytest.raises(type(e)):
            stabilized.substep(pt, sc)
        return
    assert name not in RAISES
    got = stabilized.substep(pt, sc)
    assert got.x.dtype == torch.bfloat16
    differ = [f for f in pj.__dataclass_fields__
              if not np.array_equal(_bits(getattr(want, f)), _bits(getattr(got, f)))]
    assert not differ
