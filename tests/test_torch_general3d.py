"""The port's general path in 3D against the JAX package.

The 3D dam break of tests/test_stabilized.py:164 (24^3, 8 x 8 x 16
particles, dt 2e-5) in float64, as built, with the stabilized switch set
and the tent, and as a plastic corotated solid (the 3D SVD clamp), from a
perturbed state (random v, C, F near the identity, J = det F; numpy seed).
1 and 10 substeps, every field within 1e-12 and 1e-9 of its scale
(`errors` of test_torch_general2d).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import KernelKind, TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu_torch.models import stabilized

from test_torch_general2d import LAME, _perturb, _to_port, errors

SIZE = dict(num_grids=24, particles_per_axis=(8, 8, 16), dt=2e-5, dtype=np.float64)
CASES = {
    "dam3d": dict(),
    "stab_tent": dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0,
                      flip_blend=0.98, transfer=TransferKind.PIC, kernel=KernelKind.TENT),
    "corotated_plastic": dict(),
}
TOL = {1: 1e-12, 10: 1e-9}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_case(case):
    p, scene = scenes_jax.dam_break_3d(**SIZE, **CASES[case])
    if case == "corotated_plastic":
        p = dataclasses.replace(p, material=jnp.full_like(p.material, mat_jax.FIXED_COROTATED))
        scene = dataclasses.replace(
            scene, params=dataclasses.replace(scene.params, plastic=True, **LAME),
            materials_present=(mat_jax.FIXED_COROTATED,))
    return (p, scene) if case == "dam3d" else (_perturb(p, seed=3), scene)


@functools.lru_cache(maxsize=None)
def jax_run(case, n):
    p, scene = _jax_case(case)
    q = p
    for _ in range(n):      # one compiled substep for both horizons
        q = stab_jax.run(q, scene, 1)
    return p, scene, q


@pytest.mark.parametrize("n", [1, 10])
@pytest.mark.parametrize("case", list(CASES))
def test_general3d_tracks_jax(case, n):
    p, scene, want = jax_run(case, n)
    p_t, scene_t = _to_port(p, scene)
    assert scene_t.cfg.dim == 3 and p_t.x.dtype == torch.float64
    got = stabilized.run(p_t, scene_t, n)
    errs = errors(got, want)
    bad = {k: v for k, v in errs.items() if v > TOL[n]}
    assert not bad, f"{case} after {n}: {bad} (all {errs})"
    if case == "dam3d" and n == 10:
        x0, x1 = p_t.x.numpy(), got.x.numpy()
        assert x1[:, 2].mean() < x0[:, 2].mean()      # the column falls along z
