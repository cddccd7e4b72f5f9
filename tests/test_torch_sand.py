"""Drucker-Prager sand (materials.SAND) in the port against the JAX package.

The small cases of tests/test_sand.py: the 2D column at 37^2 (dt 5e-5,
12 x 30 particles) and the 3D slab of sand at 16^3.  Each runs through the
port's fast path (plain kernel versions on the CPU) and general path, and
is held to the JAX general path (`stabilized.run`) from the same particles,
carried across with `convert`: x within 1e-7 after 1 substep, within 1e-5
after 100 (2D) or 20 (3D), slot for slot (the fast path's slots carry
their particle index in `p_s`, a field that no non-F-bar scene reads).

The JAX fast2d is not the yardstick for 2D sand: its SAND branch computes
`sand_tau_hat` and then overwrites it with the neo-Hookean stress
(mpm_flip98a_tpu/models/fast2d.py:657-680), while the port follows
`materials.sand_tau_hat` as JAX fast3d does.  So the port's fast2d meets
JAX fast2d only from F = I, where both stresses vanish, and
`test_jax_fast2d_sand_stress_fault` measures how far JAX fast2d leaves
the general path from a strained state.

The 4000-substep friction check (tests/test_sand.py:174-199) runs on the
card in chip_smoke.py's main:plastic phase, not here.
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
from mpm_flip98a_tpu_torch import convert, driver
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, materials as mat, scenes, stabilized
from mpm_flip98a_tpu_torch.parallel import SlabMesh, fast_domain

CFG = MPMConfig(dtype="float32", num_grids=37, dt=5e-5)          # test_sand.py:106-112
PARAMS = mat_jax.MaterialParams(mu=1.0e5, lam=1.5e5, friction_angle=30.0)   # :23
X_TOL = {1: 1e-7, 20: 1e-5, 100: 1e-5}
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


def _column():
    return scenes_jax.sand_column_2d(CFG, dtype=np.float32, particles_per_axis=(12, 30))


def _slab3d():
    """tests/test_sand.py:138-150: sand at 16^3, APIC."""
    p, scene = scenes_jax.slab_3d(num_grids=16, particles_per_axis=(8, 8, 6), dt=2e-5,
                                  height_frac=0.3, flip_blend=0.0)
    p = dataclasses.replace(p, material=jnp.full((p.n,), mat_jax.SAND, jnp.int32))
    return p, dataclasses.replace(scene, params=PARAMS, materials_present=(mat_jax.SAND,))


def _strained():
    """The column with F = exp(eps) in a random frame, eps ~ N(0, 0.05),
    from a seed: plastic and elastic states from the first substep."""
    p, scene = _column()
    rng = np.random.default_rng(5)
    eps = rng.normal(scale=0.05, size=(p.n, 2))
    q, _ = np.linalg.qr(rng.normal(size=(p.n, 2, 2)))
    f = (q * np.exp(eps)[:, None, :]) @ np.swapaxes(q, -1, -2)
    return dataclasses.replace(p, F=jnp.asarray(f, jnp.float32),
                               J=jnp.asarray(np.linalg.det(f), jnp.float32)), scene


CASES = {"column": _column, "slab3d": _slab3d, "strained": _strained}


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


def _tag_slots(b, p_t, cfg, spec, mod):
    """b with each live slot's particle index in p_s (the same bucketing of
    a copy whose Jp carries the index; exact in float32 below 2^24)."""
    ids = mod.from_particles(dataclasses.replace(p_t, Jp=torch.arange(p_t.n, dtype=p_t.Jp.dtype)),
                             cfg, spec, "cpu").Jp
    return dataclasses.replace(b, p_s=torch.where(b.mask > 0, ids, 0.0))


def _by_particle(b, mod, d):
    """Positions of the live slots, in particle order."""
    h = mod.to_host(b)
    ids = b.p_s[b.mask > 0].long().numpy()
    x = np.empty((len(ids), d), np.float32)
    x[ids] = np.stack([h[f"x{a}"] for a in range(d)], -1)
    assert np.array_equal(np.sort(ids), np.arange(len(ids)))
    return x


def port_fast(case, n):
    p, scene = CASES[case]()
    p_t, scene_t = _to_port(p, scene)
    d = scene_t.cfg.dim
    mod = fast3d if d == 3 else fast2d
    spec = (fast3d.FastSpec3D if d == 3 else fast2d.FastSpec).for_particles(
        scene_t.cfg, p_t, headroom=2.0)
    b = _tag_slots(mod.from_particles(p_t, scene_t.cfg, spec, "cpu"), p_t, scene_t.cfg, spec, mod)
    out = mod.run(b, scene_t, spec, n)
    assert int(out.overflow) == 0
    return _by_particle(out, mod, d), out


@pytest.mark.parametrize("case,n", [("column", 1), ("column", 100), ("slab3d", 1),
                                    ("slab3d", 20), ("strained", 1), ("strained", 20)])
def test_fast_path_tracks_jax_general(case, n):
    _, _, want = jax_general(case, n)
    x, _ = port_fast(case, n)
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=0, atol=X_TOL[n])


@pytest.mark.parametrize("case,n", [("column", 1), ("column", 100), ("slab3d", 1),
                                    ("slab3d", 20), ("strained", 1), ("strained", 20)])
def test_general_path_tracks_jax_general(case, n):
    p, scene, want = jax_general(case, n)
    p_t, scene_t = _to_port(p, scene)
    got = stabilized.run(p_t, scene_t, n)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=X_TOL[n])
    if n == 1:
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0, atol=1e-4)
    # F as U Sigma V^T, the returned state, within float32's reach of JAX's.
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), rtol=0, atol=1e-5)


def test_fast2d_meets_jax_fast2d_from_rest():
    """From F = I both fast2d sand stresses vanish: one substep slot for
    slot in identical bucket layouts."""
    p, scene = _column()
    spec = fast2d_jax.FastSpec.for_particles(CFG, p, headroom=2.0)
    b = from_particles_jax(p, CFG, spec)
    want = substep_jax(b, scene)
    b_t = convert.buckets_from_numpy(
        {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}, device="cpu")
    got = fast2d.substep(b_t, convert.scene_from_fields(dataclasses.asdict(scene)))
    for name in ("x0", "x1"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-7)
    for name in ("v0", "v1"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-4)


def test_jax_fast2d_sand_stress_fault():
    """The reference's fault, measured: from the strained column, JAX
    fast2d (neo-Hookean stress for sand) leaves the JAX general path after
    20 substeps by far more than the port's fast2d does (it follows
    sand_tau_hat).  Read on the CPU: JAX fast2d max |dv| 1.18e-2 and
    |dF| 9.4e-4; the port 1.8e-6 and 6.2e-6 (float32 over 20 substeps)."""
    p, scene, want = jax_general("strained", 20)
    spec = fast2d_jax.FastSpec.for_particles(CFG, p, headroom=2.0)
    jf = fast2d_jax.run(from_particles_jax(p, CFG, spec), scene, spec, 20)
    h = fast2d_jax.to_host(jf)
    live = np.asarray(jf.mask) > 0
    # The JAX layout matches the port's (tests/test_torch_binning.py), so
    # the port's slot ids order JAX's live slots too.
    _, out = port_fast("strained", 20)
    ids = out.p_s[out.mask > 0].long().numpy()
    assert np.array_equal(np.asarray(jf.mask) > 0, out.mask.numpy() > 0)
    v_jf = np.stack([h["v0"], h["v1"]], -1)
    f_jf = np.stack([np.stack([np.asarray(getattr(jf, f"F{a}{c}"))[live] for c in range(2)], -1)
                     for a in range(2)], -2)
    v_pt = np.stack([out.v0[out.mask > 0].numpy(), out.v1[out.mask > 0].numpy()], -1)
    f_pt = fast2d._fmat2(*(getattr(out, f"F{a}{c}")[out.mask > 0] for a in range(2)
                           for c in range(2))).numpy()
    v_ref, f_ref = np.asarray(want.v)[ids], np.asarray(want.F)[ids]
    dv_jax, df_jax = np.abs(v_jf - v_ref).max(), np.abs(f_jf - f_ref).max()
    dv_port, df_port = np.abs(v_pt - v_ref).max(), np.abs(f_pt - f_ref).max()
    assert dv_port <= 1e-4 and df_port <= 1e-5, (dv_port, df_port)
    assert dv_jax >= 1e3 * dv_port and df_jax >= 50 * df_port, (dv_jax, df_jax, dv_port, df_port)


def test_sharded_sand_matches_single():
    """tests/test_sand.py:202-226: the column in 4 slab shards, 50 substeps,
    against one device, slot ids carried through the migrations."""
    p, scene = _column()
    p_t, scene_t = _to_port(p, scene)
    mesh = SlabMesh(4, "cpu")
    spec = fast_domain.FastDomainSpec.for_particles(scene_t.cfg, 4, p_t, headroom=2.0)
    b = fast_domain.distribute(p_t, scene_t.cfg, spec, mesh)
    ids = fast_domain.distribute(dataclasses.replace(p_t, Jp=torch.arange(p_t.n, dtype=torch.float32)),
                                 scene_t.cfg, spec, mesh).Jp
    b = dataclasses.replace(b, p_s=torch.where(b.mask > 0, ids, 0.0))
    out = fast_domain.make_run(scene_t, spec, mesh)(b, 50)
    assert int(out.overflow.sum()) == 0
    x, _ = port_fast("column", 50)
    np.testing.assert_allclose(_by_particle(out, fast2d, 2), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", ["general", "fast"])
def test_sand2d_cli_on_cpu(tmp_path, path):
    """The `sand2d` scenario through the port's CLI: 1 frame x 2 substeps."""
    assert "sand2d" in driver.SCENARIOS and "sand2d" not in driver.UNPORTED_SCENARIOS
    sim = driver.main(["--scenario", "sand2d", "--path", path, "--frames", "1", "--substeps",
                       "2", "--no-gif", "--sync-io", "--out", str(tmp_path), "--device", "cpu"])
    p0, scene = scenes.sand_column_2d()
    assert sim.scene == scene and scene.materials_present == (mat.SAND,)
    assert sim.stats.substeps == 2 and sim.frame_count == 1
    x = sim.positions()
    assert x.shape == (28 * 76, 2) and np.isfinite(x).all()
    assert os.path.exists(os.path.join(sim.vtk_dir, "00001.vtk"))


def test_scene_matches_jax():
    """sand_column_2d builds the same particles and scene in both packages."""
    p, scene = scenes_jax.sand_column_2d()
    p_t, scene_t = scenes.sand_column_2d()
    for f in dataclasses.fields(p):
        np.testing.assert_array_equal(getattr(p_t, f.name).numpy(), np.asarray(getattr(p, f.name)))
    assert scene_t == convert.scene_from_fields(dataclasses.asdict(scene))
    assert scene_t.params.friction_angle == 35.0
