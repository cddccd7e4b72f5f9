"""The port's general-path slab domain (`parallel/domain.py`) on 4 gloo ranks against the JAX package.

The JAX package runs `parallel/domain.py` under `shard_map` on 4 of the
conftest's virtual CPU devices; the port runs the same 4 shards as 4
processes of a gloo process group (`parallel/launch.run_ranks`), one
launch for every case of this module.  Both start from the same
particles, so the layouts are compared bit for bit and the runs slot for
slot, with the JAX tests' tolerances (tests/test_parallel_domain.py,
tests/test_surface_tension.py:80-97, tests/test_projection.py:125-153).
The port's single-device general path is the second reference.

The migration case throws the dam column (32 x 32 particles, 3 m/s to
the right, dt 4e-5) across the first slab line: after 100 substeps 64
particles live on the second shard in both packages.  The JAX test's
unthrown collapse first migrates after 2,700 substeps at 4 shards.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, Physics, TransferKind
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models.stabilized import Scene as SceneJax
from mpm_flip98a_tpu.models.stabilized import WallBC as WallBCJax
from mpm_flip98a_tpu.parallel import domain as domain_jax
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.dryrun import dryrun_multichip
from mpm_flip98a_tpu_torch.models import stabilized
from mpm_flip98a_tpu_torch.parallel import domain, launch

N = 4
FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_parallel_domain.py:24
SWITCHES = dict(use_fbar=True, pressure_mixing_ratio=0.5, flip_blend=0.98,
                transfer=TransferKind.PIC, use_penalty_ebc=True)
FIELDS = [f.name for f in dataclasses.fields(ParticlesJax)]
# name: substeps, x and v tolerances (absolute, as the JAX tests).
CASES = {
    "layout": (0, 0.0, 0.0),
    "short": (5, 1e-12, 1e-10),          # test_parallel_domain.py:36-45
    "migrate": (100, 1e-12, 1e-10),
    "switches": (50, 1e-10, 1e-8),       # test_parallel_domain.py:88-98 (x)
    "dam3d": (5, 1e-8, 1e-6),            # test_parallel_domain.py:101-120, float32
    "csf": (200, 1e-12, 1e-10),          # test_surface_tension.py:80-97
    "projection": (25, 1e-8, 1e-7),      # test_projection.py:125-153
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drop_scene():
    """tests/test_surface_tension.py:19-48's zero-gravity 2:1 drop, sigma 5,
    float64."""
    cfg = MPMConfig(dtype="float64", num_grids=41, dt=5e-5, surface_tension=5.0)
    physics = Physics(gravity=0.0)
    l = cfg.domain_length
    w, h = 0.22 * l, 0.11 * l
    xs = (np.arange(32) + 0.5) * (w / 32) + 0.5 * (l - w)
    ys = (np.arange(16) + 0.5) * (h / 16) + 0.5 * (l - h)
    x = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    p = ParticlesJax.init(jnp.asarray(x, jnp.float64), volume0=w * h / 512,
                          density=physics.particle_density)
    scene = SceneJax(
        cfg=cfg, physics=physics,
        params=mat_jax.MaterialParams(bulk_modulus=physics.bulk_modulus,
                                      dynamic_viscosity=physics.dynamic_viscosity),
        wall=WallBCJax("slip"), mass_floor=1e-8 * float(np.min(np.asarray(p.mass))))
    return p, scene


def _jax_scene(name):
    """(particles, scene) of a case, JAX side."""
    if name in ("layout", "short"):
        return scenes_jax.dam_break_2d(MPMConfig(**FAST))
    if name == "migrate":
        p, scene = scenes_jax.dam_break_2d(MPMConfig(
            **{**FAST, "dt": 4e-5, "num_particles_x": 32}, fluid_width=0.11))
        return dataclasses.replace(p, v=p.v.at[:, 0].set(3.0)), scene
    if name == "switches":
        return scenes_jax.dam_break_2d(MPMConfig(**FAST, **SWITCHES))
    if name == "dam3d":
        return scenes_jax.dam_break_3d(num_grids=24, particles_per_axis=(8, 8, 16), dt=2e-5)
    if name == "csf":
        return _drop_scene()
    return scenes_jax.dam_break_2d(MPMConfig(
        dtype="float64", num_grids=33, dt=1e-5, num_particles_x=24, num_particles_y=48,
        fluid_width=0.105, fluid_height=0.21, flip_blend=0.98, transfer=TransferKind.PIC,
        incompressible=True, pressure_iters=60))


def _host(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_start(name):
    """The JAX domain's (scene, spec, distributed state, perm) of a case on
    4 shards."""
    p, scene = _jax_scene(name)
    spec = domain_jax.DomainSpec.for_particles(scene.cfg, N, p, headroom=2.0)
    return (scene, spec) + domain_jax.distribute(p, scene, spec, make_mesh(N))


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX domain's (start layout, final state, dropped, perm, spec) of a
    case."""
    scene, spec, state, perm = _jax_start(name)
    n_sub = CASES[name][0]
    out = domain_jax.make_run(scene, spec, make_mesh(N))(state, n_sub) if n_sub else state
    return (_host(state.particles), _host(out.particles), np.asarray(out.dropped), perm,
            dataclasses.asdict(spec))


def _port_inputs(name):
    p, scene = _jax_scene(name)
    return (convert.particles_from_numpy(_host(p), "cpu"),
            convert.scene_from_fields(dataclasses.asdict(scene)))


@pytest.fixture(scope="module")
def ranked():
    """Every case on 4 gloo ranks in one launch: {case: the global state
    (4 capacity slots, shard order) and dropped}.  The JAX runs and the
    port's single-device runs are made while the ranks work."""
    jobs = []
    for name, (n_sub, _, _) in CASES.items():
        p, scene = _port_inputs(name)
        spec = domain.DomainSpec.for_particles(scene.cfg, N, p, headroom=2.0)
        if name == "migrate":
            # The JAX domain's distributed state, carried across as it is.
            start = (_host(_jax_start(name)[2].particles), np.zeros(N, np.int32))
        else:
            start = {f: getattr(p, f).numpy() for f in FIELDS}
        jobs.append((scene, spec, n_sub, start))
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(launch.run_ranks, domain.run_jobs, N, args=(jobs,), device="cpu",
                            backend="gloo", timeout_s=60.0, deadline_s=300.0)
        refs = [pool.submit(f, name) for name in CASES for f in (_jax, _single)]
        for ref in refs:
            ref.result()
        per_rank = ranks.result()
    return {name: {k: np.concatenate([r[j][k] for r in per_rank]) for k in per_rank[0][j]}
            for j, name in enumerate(CASES)}


@functools.lru_cache(maxsize=None)
def _single(name):
    """The port's single-device general path, the second reference."""
    p, scene = _port_inputs(name)
    return stabilized.run(p, scene, CASES[name][0])


def test_spec_and_layout_bitwise():
    """DomainSpec, distribute's padded layout and perm equal JAX's bit for
    bit, on the host and as the ranks hold it."""
    for name in ("short", "migrate", "dam3d"):
        p, scene = _port_inputs(name)
        spec = domain.DomainSpec.for_particles(scene.cfg, N, p, headroom=2.0)
        _, spec_jax, state, perm_jax = _jax_start(name)
        start = _host(state.particles)
        assert dataclasses.asdict(spec) == dataclasses.asdict(spec_jax)
        full, perm = domain.layout(p, scene, spec)
        np.testing.assert_array_equal(perm, perm_jax)
        for f in FIELDS:
            assert full[f].dtype == start[f].dtype and np.array_equal(full[f], start[f]), f


def test_ranks_hold_the_layout(ranked):
    start = _host(_jax_start("layout")[2].particles)
    for f in FIELDS:
        np.testing.assert_array_equal(ranked["layout"][f], start[f], err_msg=f)
    np.testing.assert_array_equal(ranked["layout"]["dropped"], np.zeros(N, np.int32))


@pytest.mark.parametrize("name", ["short", "switches", "dam3d", "csf", "projection"])
def test_run_matches_jax_domain_slot_for_slot(ranked, name):
    _, want, dropped, _, _ = _jax(name)
    got = ranked[name]
    _, x_tol, v_tol = CASES[name]
    np.testing.assert_array_equal(got["dropped"], dropped)
    assert int(got["dropped"].sum()) == 0
    np.testing.assert_array_equal(got["mass"] > 0, want["mass"] > 0)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=x_tol)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=v_tol)


@pytest.mark.parametrize("name", ["short", "switches", "dam3d", "csf", "projection"])
def test_run_matches_single_device_port(ranked, name):
    """No particle crosses a slab line in these runs, so perm still maps
    each input particle to its slot."""
    perm = _jax(name)[3]
    ref = _single(name)
    _, x_tol, v_tol = CASES[name]
    np.testing.assert_allclose(ranked[name]["x"][perm], ref.x.numpy(), rtol=0, atol=x_tol)
    np.testing.assert_allclose(ranked[name]["v"][perm], ref.v.numpy(), rtol=0, atol=v_tol)


def test_migration_matches_jax_domain(ranked):
    """The same movers land in the same slots: dropped, every slot's
    activity and the per-shard counts as JAX's, and x and v slot for slot;
    count and mass exact."""
    start, want, dropped, _, _ = _jax("migrate")
    got = ranked["migrate"]
    np.testing.assert_array_equal(got["dropped"], dropped)
    assert int(got["dropped"].sum()) == 0
    active = got["mass"] > 0
    np.testing.assert_array_equal(active, want["mass"] > 0)
    per_shard = active.reshape(N, -1).sum(1)
    assert (per_shard != (start["mass"] > 0).reshape(N, -1).sum(1)).any(), per_shard
    assert active.sum() == (start["mass"] > 0).sum()
    np.testing.assert_allclose(got["mass"].sum(), start["mass"].sum(), rtol=1e-12)
    _, x_tol, v_tol = CASES["migrate"]
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=x_tol)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=v_tol)
    # Departed slots are inert, as the reference leaves them.
    for f in ("x", "F", "J", "density", "Jp", "volume0"):
        np.testing.assert_array_equal(got[f][~active], want[f][~active])


def test_dryrun_multichip_two_ranks():
    dryrun_multichip(2, device="cpu")
