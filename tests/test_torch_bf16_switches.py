"""The switch rule in bfloat16, 2D: where the JAX package runs a switch,
material or collider on bf16 particles the port runs it bit for bit, and
where JAX raises the port raises the same exception class.

Every case is one substep of the general path from the 37^2 dam of
tests/test_dtypes.py (512 particles, dt 2e-5) thrown at about 1 m/s from a
numpy seed, built in bf16 by JAX's `scenes.dam_break_2d(dtype=jnp.bfloat16)`
and carried across with `convert`; the solids take the column's upper half
(same shapes in every case, so JAX's eager programs compile once).  What
each case does in JAX bf16 on the CPU, and so in the port:

  apic, pic, flip98          the transfers                       runs, bitwise
  tent_apic, tent_flip98     the tent kernel (D inverted)        runs, bitwise
  fbar, penalty, mixing      the stabilized switches             runs, bitwise
  tait, sticky               Tait EOS; sticky walls              runs, bitwise
  incompressible             the Chorin projection's CG          runs, bitwise
  surface_tension            CSF (sigma 5)                       runs, bitwise
  obstacle, obstacle_sticky  a static sphere collider            runs, bitwise
  plow                       a moving one at t = 0.01 s          runs, bitwise
  neo_hookean, corotated     elastic solids (2D polar: closed)   runs, bitwise
  corotated_plastic, snow    the singular-value clamp (2D SVD)   runs, bitwise
  sand                       the Drucker-Prager return map       runs, bitwise

No 2D case raises in JAX; the 3D file holds the ones that do.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import EOSKind, KernelKind, MPMConfig, TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.models.colliders import Collider as ColliderJax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import stabilized

FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_dtypes.py:14
FLIP = dict(flip_blend=0.98, transfer=TransferKind.PIC)
E_SOLID, NU_SOLID = 5e4, 0.3
LAME = dict(mu=E_SOLID / (2 * (1 + NU_SOLID)),
            lam=E_SOLID * NU_SOLID / ((1 + NU_SOLID) * (1 - 2 * NU_SOLID)))
T_PLOW = 0.01

CASES = {
    "apic": dict(),
    "pic": dict(transfer=TransferKind.PIC),
    "flip98": dict(FLIP),
    "tent_apic": dict(kernel=KernelKind.TENT),
    "tent_flip98": dict(FLIP, kernel=KernelKind.TENT),
    "fbar": dict(FLIP, use_fbar=True),
    "penalty": dict(FLIP, use_penalty_ebc=True),
    "mixing": dict(FLIP, use_fbar=True, pressure_mixing_ratio=1.0),
    "tait": dict(eos=EOSKind.TAIT),
    "sticky": dict(),
    "incompressible": dict(FLIP, incompressible=True),
    "surface_tension": dict(surface_tension=5.0),
    "obstacle": dict(),
    "obstacle_sticky": dict(),
    "plow": dict(),
    "neo_hookean": dict(),
    "corotated": dict(),
    "corotated_plastic": dict(),
    "snow": dict(),
    "sand": dict(),
}
SOLIDS = {"neo_hookean": mat_jax.NEO_HOOKEAN, "corotated": mat_jax.FIXED_COROTATED,
          "corotated_plastic": mat_jax.FIXED_COROTATED, "snow": mat_jax.SNOW,
          "sand": mat_jax.SAND}


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
    """(JAX bf16 particles, JAX scene, t) of one case."""
    p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST, **CASES[name]), dtype=jnp.bfloat16)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(np.asarray(p.v).shape)
    p = dataclasses.replace(p, v=jnp.asarray(v, jnp.float32).astype(jnp.bfloat16))
    l, t = scene.cfg.domain_length, None
    if name == "sticky":
        scene = dataclasses.replace(scene, wall=stab_jax.WallBC("sticky"))
    elif name.startswith("obstacle") or name == "plow":
        col = ColliderJax(kind="sphere", center=(0.10 * l, 0.05 * l), radius=0.05 * l,
                          sticky=name != "obstacle",
                          center_velocity=(-0.25 * l, 0.0) if name == "plow" else (0.0, 0.0))
        scene = dataclasses.replace(scene, colliders=(col,))
        t = T_PLOW if name == "plow" else None
    elif name in SOLIDS:
        top = np.asarray(p.x)[:, 1].astype(np.float32) > 0.5 * scene.cfg.fluid_height
        material = np.where(top, SOLIDS[name], mat_jax.WEAKLY_COMPRESSIBLE_FLUID)
        p = dataclasses.replace(p, material=jnp.asarray(material, jnp.int32))
        params = dataclasses.replace(scene.params, **LAME,
                                     plastic=name == "corotated_plastic")
        scene = dataclasses.replace(
            scene, params=params,
            materials_present=(mat_jax.WEAKLY_COMPRESSIBLE_FLUID, SOLIDS[name]))
    return p, scene, t


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_switch_rule_2d(name):
    """One bf16 substep: JAX's eager substep and the port's bitwise on every
    field, or both raise the same exception class."""
    pj, scene, t = _build(name)
    pt = convert.particles_from_numpy({f: np.asarray(getattr(pj, f))
                                       for f in pj.__dataclass_fields__}, "cpu")
    sc = convert.scene_from_fields(dataclasses.asdict(scene))
    try:
        want = stab_jax.substep(pj, scene, t=t)
    except Exception as e:                                   # noqa: BLE001 - the class is the claim
        with pytest.raises(type(e)):
            stabilized.substep(pt, sc, t=t)
        return
    got = stabilized.substep(pt, sc, t=t)
    assert got.x.dtype == torch.bfloat16
    differ = [f for f in pj.__dataclass_fields__
              if not np.array_equal(_bits(getattr(want, f)), _bits(getattr(got, f)))]
    assert not differ
