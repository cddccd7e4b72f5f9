"""The port's prepped 3D path against the JAX package: the elastic drops
(neo-Hookean and corotated block), their scenes, one substep each, and
the 3D stresses at finite strain.

The substeps are cases of tests/test_torch_stabilized3d.py's
`test_single_substep_matches_jax`, with its states, tolerances and checks
(`check_single_substep`): the JAX kernels they compile (the drop's own
grid, which both drops share) serve no variant there, so they sit in a
module of their own, and each file stays inside its share of the suite's
time.  The stresses are compared on the drop scene's parameters.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast3d, scenes
from mpm_flip98a_tpu_torch.models import materials as mat

from test_torch_stabilized3d import (   # with its autouse fixture
    DROP, _jax_scene, _one_torch_thread, check_single_substep)


@pytest.mark.parametrize("variant", DROP)
def test_single_substep_matches_jax(variant):
    check_single_substep(variant)


def test_stresses_at_finite_strain_match_jax_materials():
    """The port's matrix-form 3D stresses and the component form the fast
    path preps (`fast3d._stress`, with `_polar3d_rows`) against JAX
    `materials` at a finite strain, within 1e-6 of the stress scale."""
    _, scene = _jax_scene("drop_neo_hookean")
    params = dataclasses.replace(scene.params, lam=3e4)   # log J and J - 1 differ visibly
    f = np.array([[1.15, 0.05, -0.02], [-0.03, 0.9, 0.04], [0.02, -0.06, 1.05]], np.float32)
    rng = np.random.default_rng(0)
    n = 6
    fs = (f[None] + rng.normal(0.0, 0.02, (n, 3, 3))).astype(np.float32)
    vol0 = rng.uniform(1e-5, 2e-5, n).astype(np.float32)
    material = np.array([0, 1, 2, 1, 2, 0], np.int32)
    j = rng.uniform(0.97, 1.03, n).astype(np.float32)
    c = rng.normal(0.0, 20.0, (n, 3, 3)).astype(np.float32)
    strain = 0.5 * (c + c.transpose(0, 2, 1))
    pressure = (-params.bulk_modulus * (j - 1.0)).astype(np.float32)
    present = (0, 1, 2)
    ja = jnp.asarray
    want = {
        "neo": np.asarray(mat_jax.neo_hookean_tau_hat(params, ja(vol0), ja(fs))),
        "corot": np.asarray(mat_jax.fixed_corotated_tau_hat(params, ja(vol0), ja(fs))),
        "mixed": np.asarray(mat_jax.tau_hat(
            params, ja(material), ja(vol0), ja(fs), ja(j), ja(pressure), ja(strain), present)),
    }
    params_t = convert.scene_from_fields(
        dataclasses.asdict(dataclasses.replace(scene, params=params))).params
    t = torch.from_numpy
    got = {
        "neo": mat.neo_hookean_tau_hat(params_t, t(vol0), t(fs)).numpy(),
        "corot": mat.fixed_corotated_tau_hat(params_t, t(vol0), t(fs)).numpy(),
        "mixed": mat.tau_hat(params_t, t(material), t(vol0), t(fs), t(j), t(pressure),
                             t(strain), present).numpy(),
    }
    # The fast path's component form on a one-pencil bucket of the same slots.
    ones, zeros = np.ones((1, n), np.float32), np.zeros((1, n), np.float32)
    fields = {name: zeros for name in (
        "x0", "x1", "x2", "v0", "v1", "v2", "mass", "p_s", "div_s")}
    fields.update({f"C{a}{e}": c[None, :, a, e] for a in range(3) for e in range(3)})
    fields.update({f"F{a}{e}": fs[None, :, a, e] for a in range(3) for e in range(3)})
    fields.update(J=j[None], jbar_s=j[None], vol0=vol0[None], mat=material[None], Jp=ones,
                  mask=ones, overflow=np.zeros((), np.int32))
    scene_fast = dataclasses.replace(
        convert.scene_from_fields(dataclasses.asdict(scene)), params=params_t,
        materials_present=present)
    tau, p_point, _ = fast3d._stress(convert.buckets3d_from_numpy(fields, device="cpu"), scene_fast)
    got["fast3d"] = torch.stack(tau, -1).reshape(n, 3, 3).numpy()
    want["fast3d"] = want["mixed"]
    for key in want:
        scale = float(np.abs(want[key]).max())
        assert scale > 0
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale, err_msg=key)
    np.testing.assert_allclose(p_point.numpy()[0], pressure, rtol=1e-6)
    assert np.abs(want["neo"] - want["corot"]).max() > 1e-2 * np.abs(want["neo"]).max()
    # The component-form polar: a rotation, and F = R S with S symmetric.
    r = torch.stack(fast3d._polar3d_rows([t(fs[:, a, e]) for a in range(3) for e in range(3)]),
                    -1).reshape(n, 3, 3).numpy().astype(np.float64)
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-6)
    s = r.transpose(0, 2, 1) @ fs
    np.testing.assert_allclose(s, s.transpose(0, 2, 1), atol=1e-6)


@pytest.mark.parametrize("block", ["neo_hookean", "corotated"])
def test_elastic_drop_3d_matches_jax(block):
    """Each package builds the scene itself: same bits (per-particle
    volume, density and material through `Particles.init`), same scene."""
    material = mat_jax.NEO_HOOKEAN if block == "neo_hookean" else mat_jax.FIXED_COROTATED
    kw = dict(num_grids=16, fluid_particles=(9, 8, 4), block_particles=(4, 5, 3),
              block_material=material, flip_blend=0.98)
    p_j, scene_j = scenes_jax.elastic_drop_3d(transfer=TransferKind.PIC, **kw)
    p_t, scene_t = scenes.elastic_drop_3d(transfer=TransferKind_t.PIC, **kw)
    assert p_t.n == 9 * 8 * 4 + 4 * 5 * 3
    for f in dataclasses.fields(p_j):
        want = np.asarray(getattr(p_j, f.name))
        got = getattr(p_t, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene_j))
    assert scene_t.materials_present == (0, material) and scene_t.cfg.dim == 3
