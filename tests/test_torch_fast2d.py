"""The port's fast 2D path against the JAX fast path, slice as a whole.

Both packages start from the same scene (built by the JAX package and
carried across with `convert`, or built by each package and compared bit
for bit), bucket it identically (test_torch_binning.py), and are then
compared slot by slot.  Tolerances are the JAX package's own fast-path
tolerances (tests/test_fast2d.py:56-57, :67, :148-149).  The JAX kernels
run in Pallas interpret mode; the port runs its plain versions.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mpm_flip98a_tpu.config import EOSKind, MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models.stabilized import WallBC
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import MPMConfig as MPMConfig_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.models.colliders import Collider
from mpm_flip98a_tpu_torch.models import materials as mat
from mpm_flip98a_tpu_torch.models import scenes

_FAST_KW = dict(  # tests/test_fast2d.py:17-25
    dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
    num_particles_y=32, flip_blend=0.98,
)
FAST = MPMConfig(**_FAST_KW, transfer=TransferKind.PIC)
FAST_T = MPMConfig_t(**_FAST_KW, transfer=TransferKind_t.PIC)
# JAX's bucketing and substep, each as one program: called eagerly they
# compile every operation on its own, several seconds a scene.
from_particles_jax = jax.jit(fast2d_jax.from_particles, static_argnames=("cfg", "spec"))
substep_jax = jax.jit(fast2d_jax.substep, static_argnames=("scene",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(cfg=FAST, v0=0.0):
    """JAX state and the port's copy of it, in identical bucket layouts."""
    p, scene = scenes_jax.dam_break_2d(cfg, dtype=np.float32)
    if v0:
        p = dataclasses.replace(p, v=p.v.at[:, 0].set(v0))
    spec = fast2d_jax.FastSpec.for_particles(cfg, p, headroom=2.0)
    b = from_particles_jax(p, cfg, spec)
    fields = {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast2d.FastSpec(spec.rows, spec.capacity)
    return (scene, spec, b), (scene_t, spec_t, convert.buckets_from_numpy(fields, device="cpu"))


def _np(b, name):
    a = getattr(b, name)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dam_break_2d_matches_jax(dtype):
    """Each package builds the scene itself: same bits, same scene."""
    p_j, scene_j = scenes_jax.dam_break_2d(FAST, dtype=dtype)
    p_t, scene_t = scenes.dam_break_2d(FAST_T, dtype=dtype)
    for f in dataclasses.fields(p_j):
        want = np.asarray(getattr(p_j, f.name))
        got = getattr(p_t, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene_j))


@pytest.mark.parametrize("variant", ["flip98", "apic_tait", "sticky_relative_floor"])
def test_single_substep_matches_jax(variant):
    cfg = FAST
    if variant == "apic_tait":
        cfg = dataclasses.replace(FAST, flip_blend=0.0, transfer=TransferKind.APIC)
    (scene, _, b), (scene_t, _, b_t) = _setup(cfg)
    if variant == "apic_tait":
        params = dataclasses.replace(scene.params, eos=EOSKind.TAIT)
        scene = dataclasses.replace(scene, params=params)
    elif variant == "sticky_relative_floor":
        # Sticky walls, and mass_floor 0: the floor relative to max grid mass.
        scene = dataclasses.replace(scene, wall=WallBC("sticky"), mass_floor=0.0)
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    b1 = substep_jax(b, scene)
    b1_t = fast2d.substep(b_t, scene_t)
    np.testing.assert_array_equal(_np(b1_t, "mask"), _np(b1, "mask"))
    for name in ("x0", "x1"):
        np.testing.assert_allclose(_np(b1_t, name), _np(b1, name), atol=1e-7)
    for name in ("v0", "v1"):
        np.testing.assert_allclose(_np(b1_t, name), _np(b1, name), atol=1e-4)


def test_hundred_substeps_track_jax():
    (scene, spec, b), (scene_t, spec_t, b_t) = _setup()
    out = fast2d_jax.run(b, scene, spec, 100)
    out_t = fast2d.run(b_t, scene_t, spec_t, 100)
    for name in ("x0", "x1"):
        np.testing.assert_allclose(_np(out_t, name), _np(out, name), atol=1e-5)
    assert int(out.overflow) == int(out_t.overflow) == 0


def test_run_across_rebuckets_matches_jax_statistically():
    """A 2 m/s sideways start carries particles across rows, so both runs
    rebucket; the ensemble stays within the fast path's 5e-4 bound."""
    (scene, spec, b), (scene_t, spec_t, b_t) = _setup(v0=2.0)
    stats = fast2d.RunStats()
    out = b
    for _ in range(3):   # run(300) in three calls: test_hundred_substeps' compile
        out = fast2d_jax.run(out, scene, spec, 100)
    out_t = fast2d.run(b_t, scene_t, spec_t, 300, stats)
    assert stats.rebuckets > 0
    assert stats.substeps == stats.host_reads == 300
    h, h_t = fast2d_jax.to_host(out), fast2d.to_host(out_t)
    x = np.stack([h["x0"], h["x1"]], -1)
    x_t = np.stack([h_t["x0"], h_t["x1"]], -1)
    assert x_t.shape == x.shape and np.isfinite(x_t).all()
    np.testing.assert_allclose(x_t.mean(axis=0), x.mean(axis=0), atol=5e-4)
    np.testing.assert_allclose(x_t.std(axis=0), x.std(axis=0), atol=5e-4)
    assert int(out.overflow) == int(out_t.overflow) == 0
    np.testing.assert_allclose(h_t["mass"].sum(), h["mass"].sum(), rtol=1e-6)


def test_unported_configs_raise():
    """Nothing of fast2d's switch set is left unported: the incompressible
    projection and CSF surface tension (ROADMAP queue 1, item 6), alone or
    with a collider, pass `check_supported` and run one substep, finite,
    the collider's interior solid in the projection
    (tests/test_torch_projection.py and _surface_tension.py hold them to
    JAX); a 3D config is a ValueError.  Snow, sand and corotated plasticity
    (item 4) pass too and take the prepped branch with the plastic update
    (tests/test_torch_snow.py, _sand.py, _plasticity.py hold them to
    JAX)."""
    (scene, spec, b), (scene_t, spec_t, b_t) = _setup()
    sphere = Collider(kind="sphere", center=(0.2, 0.1), radius=0.03)
    ext = [
        dataclasses.replace(scene_t, cfg=dataclasses.replace(scene_t.cfg, **change),
                            colliders=cols)
        for change in (dict(incompressible=True), dict(surface_tension=0.07))
        for cols in ((), (sphere,))
    ]
    for scene_ext in ext:
        fast2d.check_supported(scene_ext)
        got = fast2d.substep(b_t, scene_ext)
        assert all(bool(torch.isfinite(getattr(got, n)).all()) for n in ("x0", "x1", "v0", "v1"))
    with pytest.raises(ValueError, match="3D"):
        fast2d.check_supported(dataclasses.replace(
            scene_t, cfg=dataclasses.replace(scene_t.cfg, dim=3)))
    fast2d.check_supported(dataclasses.replace(scene_t, colliders=(sphere,)))
    ported = [dataclasses.replace(scene_t, materials_present=(mat.WEAKLY_COMPRESSIBLE_FLUID, m))
              for m in (mat.SNOW, mat.SAND)]
    ported.append(dataclasses.replace(
        scene_t, materials_present=(mat.FIXED_COROTATED,),
        params=dataclasses.replace(scene_t.params, plastic=True)))
    for scene_ok in ported:
        fast2d.check_supported(scene_ok)
        assert fast2d.plastic_materials(scene_ok) and not fast2d.uses_fused(scene_ok)
    assert fast2d.plastic_materials(scene_t) == ()
