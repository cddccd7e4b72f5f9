"""The port's fast 3D path against the JAX fast path, slice as a whole.

Both packages build the same scene (bit for bit), bucket it identically,
and are then compared slot by slot after one substep (the JAX kernels in
Pallas interpret mode, once: seconds each); the rebuckets, bit for bit
and across runs, are in tests/test_torch_fast3d_rebucket.py.
Tolerances: the north star's 1e-7 on x and 1e-4 on v after one substep
(tests/test_fast2d.py:56-57), 1e-6 on J, and tests/test_fast3d.py's 5e-4
on the ensemble mean.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import KernelKind
from mpm_flip98a_tpu_torch.models import fast3d, scenes
from mpm_flip98a_tpu_torch.models.colliders import Collider

SMALL = dict(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(b):
    return {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}


def _assert_bits_equal(got: dict, want: dict):
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(
            np.atleast_1d(g).view(np.uint8), np.atleast_1d(w).view(np.uint8), err_msg=name
        )


def _t(b):
    return {f.name: getattr(b, f.name).numpy() for f in dataclasses.fields(b)}


def _setup(v=None, **kw):
    """JAX state and the port's copy of it, in identical bucket layouts."""
    p, scene = scenes_jax.dam_break_3d(**{**SMALL, **kw})
    if v is not None:
        p = dataclasses.replace(p, v=p.v.at[:].set(v))
    spec = fast3d_jax.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d_jax.from_particles(p, scene.cfg, spec)
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast3d.FastSpec3D(spec.rows0, spec.rows1, spec.capacity)
    b_t = convert.buckets3d_from_numpy(_fields(b), device="cpu")
    return (p, scene, spec, b), (scene_t, spec_t, b_t)


@pytest.mark.parametrize("scene", ["dam_break_3d", "slab_3d"])
def test_3d_scenes_match_jax(scene):
    """Each package builds the scene itself: same bits, same scene."""
    kw = SMALL if scene == "dam_break_3d" else dict(
        num_grids=16, particles_per_axis=(12, 12, 4), dtype=np.float32,
    )
    p_j, scene_j = getattr(scenes_jax, scene)(**kw)
    p_t, scene_t = getattr(scenes, scene)(**kw)
    _assert_bits_equal(_t(p_t), _fields(p_j))
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene_j))
    assert scene_t.cfg.dim == 3


def test_single_substep_matches_jax():
    rng = np.random.default_rng(3)
    n = 6 * 6 * 10
    v = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    (_, scene, spec, b), (scene_t, spec_t, b_t) = _setup(v=v)
    b1 = fast3d_jax.substep(b, scene, spec)
    b1_t = fast3d.substep(b_t, scene_t, spec_t)
    got, want = _t(b1_t), _fields(b1)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for name, atol in (("x", 1e-7), ("v", 1e-4)):
        for a in range(3):
            np.testing.assert_allclose(got[f"{name}{a}"], want[f"{name}{a}"], atol=atol)
    np.testing.assert_allclose(got["J"], want["J"], atol=1e-6)
    # Fields the fused substep does not write carry over untouched.
    for name in ("F00", "mass", "vol0", "jbar_s"):
        np.testing.assert_array_equal(got[name], want[name])


def test_unported_configs_raise():
    """What `check_supported` still refuses: the fused branch without an
    absolute mass floor (the reference sends it to `p2g3d_grid`'s raw
    mode, fast3d.py:631-645), colliders or not; a 2D config is a
    ValueError.  CSF and the projection (ROADMAP queue 1, item 6), with
    or without colliders, pass and leave the fused branch for `p2g3d` +
    `fold_rows0` + `_grid_update` (`ext_grid`), also with the relative
    floor; snow, sand and corotated plasticity (item 4) pass."""
    (_, _, _, _), (scene_t, spec_t, b_t) = _setup()
    cfg = scene_t.cfg
    plastic = dataclasses.replace(scene_t.params, plastic=True)
    sphere = Collider(kind="sphere", center=(0.2, 0.2, 0.1), radius=0.05)
    with pytest.raises(ValueError, match="3D"):
        fast3d.check_supported(dataclasses.replace(scene_t, cfg=dataclasses.replace(cfg, dim=2)))
    for change in (
        dict(colliders=(sphere,), mass_floor=0.0),
        dict(mass_floor=0.0),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fast3d.substep(b_t, dataclasses.replace(scene_t, **change), spec_t)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fast3d.check_supported(dataclasses.replace(scene_t, **change))
    for change in (
        dict(cfg=dataclasses.replace(cfg, surface_tension=0.07)),
        dict(cfg=dataclasses.replace(cfg, incompressible=True)),
        dict(cfg=dataclasses.replace(cfg, incompressible=True, use_fbar=True)),
        dict(cfg=dataclasses.replace(cfg, incompressible=True), colliders=(sphere,)),
        dict(cfg=dataclasses.replace(cfg, surface_tension=0.07), colliders=(sphere,)),
        dict(cfg=dataclasses.replace(cfg, incompressible=True), mass_floor=0.0),
    ):
        scene_ext = dataclasses.replace(scene_t, **change)
        fast3d.check_supported(scene_ext)
        assert not fast3d.uses_fused(scene_ext) and not fast3d.kernel_grid(scene_ext)
        got = fast3d.substep(b_t, scene_ext, spec_t)
        assert all(bool(torch.isfinite(getattr(got, n)).all()) for n in ("x0", "v0", "v2"))
    # The configs the slice now runs pass the check.
    for change in (
        dict(cfg=dataclasses.replace(cfg, use_fbar=True, pressure_mixing_ratio=0.5)),
        dict(cfg=dataclasses.replace(cfg, kernel=KernelKind.TENT)),
        dict(materials_present=(0, 1)),
        dict(materials_present=(0, 2)),
        dict(mass_floor=0.0, cfg=dataclasses.replace(cfg, use_fbar=True)),
        dict(mass_floor=0.0, materials_present=(0, 1)),
        dict(colliders=(sphere,)),
        dict(colliders=(sphere,), mass_floor=0.0, cfg=dataclasses.replace(cfg, use_fbar=True)),
        dict(materials_present=(3,)),            # snow
        dict(materials_present=(0, 4)),          # fluid + sand
        dict(materials_present=(0, 2), params=plastic),
        dict(materials_present=(2,), params=plastic),
    ):
        fast3d.check_supported(dataclasses.replace(scene_t, **change))
