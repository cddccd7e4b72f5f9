"""Snow (materials.SNOW) in the port against the JAX package.

The small cases of tests/test_snow.py: the snow block thrown at the floor
(37^2, dt 2e-5, 24^2 particles at -2 m/s; and strained from a seed, so the
clamp acts at once), snow as the block of the mixed
fluid scene (`elastic_drop_2d(block_material=SNOW)`), and the 6^3 snow
block at 16^3.  Each runs through the port's fast path (plain kernel
versions on the CPU) and general path and is held to the JAX general path
(`stabilized.run`) from the same particles, carried across with
`convert`: x within 1e-7 after 1 substep, within 1e-5 after 100 (2D) or
20 (3D), slot for slot (the fast path's slots carry their particle index
in `p_s`, which no non-F-bar scene reads), and the tracked plastic volume
Jp within 1e-5 (tests/test_snow.py:76-81).  JAX fast2d's SNOW branch is
sound, so the mixed scene also meets it slot for slot after one substep.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu_torch import convert, driver
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, materials as mat, scenes, stabilized

X_TOL = {1: 1e-7, 20: 1e-5, 100: 1e-5}
JP_TOL = 1e-5
# JAX's bucketing and substep, each as one program: called eagerly they
# compile every operation on its own, several seconds a scene.
from_particles_jax = jax.jit(fast2d_jax.from_particles, static_argnames=("cfg", "spec"))
substep_jax = jax.jit(fast2d_jax.substep, static_argnames=("scene",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _impact():
    """tests/test_snow.py:22-36: the block just above the floor at -2 m/s."""
    cfg = MPMConfig(dtype="float32", num_grids=37, dt=2e-5)
    p, scene = scenes_jax.snow_block_2d(cfg, dtype=np.float32, drop_height_frac=0.08,
                                        particles_per_axis=24)
    return dataclasses.replace(p, v=jnp.zeros_like(p.v).at[:, 1].set(-2.0)), scene


def _mixed():
    """tests/test_snow.py:100-109: snow as the block of the fluid scene."""
    cfg = MPMConfig(dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
                    num_particles_y=32)
    return scenes_jax.elastic_drop_2d(cfg, dtype=np.float32, block_material=mat_jax.SNOW)


def _block3d():
    """tests/test_snow.py:124-149: a 6^3 snow block at 16^3, at -2 m/s."""
    cfg = MPMConfig(dim=3, dtype="float32", num_grids=16, dt=2e-5)
    l = cfg.domain_length
    side = 0.2 * l
    axes = [(np.arange(6) + 0.5) * (side / 6) + 0.5 * (l - side) for _ in range(3)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    p = ParticlesJax.init(jnp.asarray(x, jnp.float32), volume0=side**3 / 216, density=400.0,
                          material=jnp.full((len(x),), mat_jax.SNOW, jnp.int32))
    p = dataclasses.replace(p, v=jnp.zeros_like(p.v).at[:, 2].set(-2.0))
    scene = stab_jax.Scene(cfg=cfg, params=mat_jax.MaterialParams(mu=5e4, lam=5e4),
                           materials_present=(mat_jax.SNOW,),
                           mass_floor=1e-8 * float(np.min(np.asarray(p.mass))))
    return p, scene


def _strained():
    """The impact block with F = exp(eps) in a random frame, eps ~ N(0,
    0.02), from a seed: the clamp and Jp act from the first F update."""
    p, scene = _impact()
    rng = np.random.default_rng(6)
    eps = rng.normal(scale=0.02, size=(p.n, 2))
    q, _ = np.linalg.qr(rng.normal(size=(p.n, 2, 2)))
    f = (q * np.exp(eps)[:, None, :]) @ np.swapaxes(q, -1, -2)
    return dataclasses.replace(p, F=jnp.asarray(f, jnp.float32),
                               J=jnp.asarray(np.linalg.det(f), jnp.float32)), scene


CASES = {"impact": _impact, "strained": _strained, "mixed": _mixed, "block3d": _block3d}


@functools.lru_cache(maxsize=None)
def jax_general(case, n):
    """JAX's general path after n substeps: `stabilized.run` one substep a
    call, so that a case's horizons share one compile (as
    tests/test_torch_general2d.py's `jax_run` does)."""
    if n > 1:
        p, scene, q = jax_general(case, 1)
        for _ in range(1, n):
            q = stab_jax.run(q, scene, 1)
        return p, scene, q
    p, scene = CASES[case]()
    return p, scene, stab_jax.run(p, scene, 1)


def _to_port(p, scene):
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    return p_t, convert.scene_from_fields(dataclasses.asdict(scene))


def port_fast(case, n):
    """The port's fast path after n substeps: (x, Jp) in particle order and
    the bucket state."""
    p, scene = CASES[case]()
    p_t, scene_t = _to_port(p, scene)
    d = scene_t.cfg.dim
    mod = fast3d if d == 3 else fast2d
    spec = (fast3d.FastSpec3D if d == 3 else fast2d.FastSpec).for_particles(
        scene_t.cfg, p_t, headroom=2.0)
    b = mod.from_particles(p_t, scene_t.cfg, spec, "cpu")
    ids = mod.from_particles(dataclasses.replace(p_t, Jp=torch.arange(p_t.n, dtype=torch.float32)),
                             scene_t.cfg, spec, "cpu").Jp
    out = mod.run(dataclasses.replace(b, p_s=torch.where(b.mask > 0, ids, 0.0)), scene_t, spec, n)
    assert int(out.overflow) == 0
    h = mod.to_host(out)
    slot = out.p_s[out.mask > 0].long().numpy()
    assert np.array_equal(np.sort(slot), np.arange(p_t.n))
    x, jp = np.empty((p_t.n, d), np.float32), np.empty(p_t.n, np.float32)
    x[slot], jp[slot] = np.stack([h[f"x{a}"] for a in range(d)], -1), h["Jp"]
    return x, jp


HORIZONS = [("impact", 1), ("impact", 100), ("strained", 1), ("strained", 20), ("mixed", 1),
            ("mixed", 100), ("block3d", 1), ("block3d", 20)]


@pytest.mark.parametrize("case,n", HORIZONS)
def test_fast_path_tracks_jax_general(case, n):
    _, _, want = jax_general(case, n)
    x, jp = port_fast(case, n)
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=0, atol=X_TOL[n])
    np.testing.assert_allclose(jp, np.asarray(want.Jp), rtol=0, atol=JP_TOL)


@pytest.mark.parametrize("case,n", HORIZONS)
def test_general_path_tracks_jax_general(case, n):
    p, scene, want = jax_general(case, n)
    p_t, scene_t = _to_port(p, scene)
    got = stabilized.run(p_t, scene_t, n)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=X_TOL[n])
    np.testing.assert_allclose(got.Jp.numpy(), np.asarray(want.Jp), rtol=0, atol=JP_TOL)
    if n == 1:
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0, atol=1e-4)


def test_strained_snow_tracks_jp():
    """The strained case is not vacuous: the clamp moved Jp off 1 on most
    of the block, in both packages, inside the clamp bounds."""
    _, scene, want = jax_general("strained", 20)
    jp_j = np.asarray(want.Jp)
    _, jp = port_fast("strained", 20)
    for j in (jp_j, jp):
        assert (np.abs(j - 1.0) > 1e-4).mean() > 0.5, np.abs(j - 1.0).max()
        assert j.min() >= scene.params.jp_clamp_lo and j.max() <= scene.params.jp_clamp_hi


def test_mixed_scene_meets_jax_fast2d():
    """One substep of the fluid + snow scene slot for slot against JAX
    fast2d (its SNOW branch is the hardened corotated one) in identical
    bucket layouts."""
    p, scene = _mixed()
    cfg = scene.cfg
    spec = fast2d_jax.FastSpec.for_particles(cfg, p, headroom=2.0)
    b = from_particles_jax(p, cfg, spec)
    want = substep_jax(b, scene)
    b_t = convert.buckets_from_numpy(
        {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}, device="cpu")
    got = fast2d.substep(b_t, convert.scene_from_fields(dataclasses.asdict(scene)))
    for name, tol in (("x0", 1e-7), ("x1", 1e-7), ("v0", 1e-4), ("v1", 1e-4), ("Jp", 1e-6)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("path", ["general", "fast"])
def test_snow2d_cli_on_cpu(tmp_path, path):
    """The `snow2d` scenario through the port's CLI: 1 frame x 2 substeps."""
    assert "snow2d" in driver.SCENARIOS and "snow2d" not in driver.UNPORTED_SCENARIOS
    sim = driver.main(["--scenario", "snow2d", "--path", path, "--frames", "1", "--substeps",
                       "2", "--no-gif", "--sync-io", "--out", str(tmp_path), "--device", "cpu"])
    _, scene = scenes.snow_block_2d()
    assert sim.scene == scene and scene.materials_present == (mat.SNOW,)
    assert sim.stats.substeps == 2 and sim.frame_count == 1
    x = sim.positions()
    assert x.shape == (40 * 40, 2) and np.isfinite(x).all()
    assert os.path.exists(os.path.join(sim.vtk_dir, "00001.vtk"))


@pytest.mark.parametrize("scene_fn", ["snow_block_2d", "elastic_drop_2d_snow"])
def test_scene_matches_jax(scene_fn):
    """The snow scenes build the same particles and scene in both packages
    (elastic_drop_2d passes block_material=SNOW through)."""
    if scene_fn == "snow_block_2d":
        (p, scene), (p_t, scene_t) = scenes_jax.snow_block_2d(), scenes.snow_block_2d()
    else:
        (p, scene), (p_t, scene_t) = (scenes_jax.elastic_drop_2d(block_material=mat_jax.SNOW),
                                      scenes.elastic_drop_2d(block_material=mat.SNOW))
    for f in dataclasses.fields(p):
        np.testing.assert_array_equal(getattr(p_t, f.name).numpy(), np.asarray(getattr(p, f.name)))
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene))
    assert mat.SNOW in scene_t.materials_present
