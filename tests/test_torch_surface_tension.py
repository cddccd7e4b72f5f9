"""The port's CSF surface tension against the JAX package.

`stabilized._csf_force` on seeded numpy mass fields against the JAX
function in 2D and 3D, float32 and float64, and in 4 stacked slab shards
(halo refresh after each radius-1 stage, maxima over the shards) against
one device.  Then the zero-gravity drop of tests/test_surface_tension.py
(41^2, and the 16^3 2:1:1 drop in 3D): the sigma = 0 control stays static
over 300 substeps (the port alone), one substep of the general path with
slip walls and with the penalty EBC against JAX's, the fast paths against
JAX's general path slot for slot, and 4 shards against one device.

Tolerances: float64 1e-12 of each output's scale; float32 1e-5 of scale;
whole substeps JAX's own, x 1e-7 and v 1e-4 (tests/test_surface_tension.
py:133-134); shards against one device 1e-5 of each field's scale, slot
for slot.  JAX results are cached per module.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, Physics
from mpm_flip98a_tpu.models import materials as mat_jax
from mpm_flip98a_tpu.models import stabilized as stab_jax
from mpm_flip98a_tpu.state import Particles as Particles_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, stabilized
from mpm_flip98a_tpu_torch.parallel import SlabMesh
from mpm_flip98a_tpu_torch.parallel import fast_domain as fd
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

TOL = {np.float32: 1e-5, np.float64: 1e-12}
VS_GENERAL = {"x": 1e-7, "v": 1e-4}
# After one substep from rest v is 5e-5 to 3e-4 m/s, below JAX's absolute
# v bound: v is also held to 1e-5 of its scale (read on the CPU: 1.4e-6 at
# most, fast against general).
V_REL = 1e-5
SHARD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale, tol)


def _mass_field(g, d, dtype, seed):
    """A 2:1 block of nodal mass (the drop's shape) with a seeded 10%
    ripple, zero outside."""
    rng = np.random.default_rng(seed)
    m = np.zeros((g,) * d, dtype)
    half = [g // 4] + [g // 8] * (d - 1)
    m[tuple(slice(g // 2 - h, g // 2 + h) for h in half)] = 1.0
    return (m * (1.0 + 0.1 * rng.random(m.shape))).astype(dtype)


def _cfg(d, dtype, sigma=5.0):
    return MPMConfig(dim=d, dtype=np.dtype(dtype).name, num_grids=41 if d == 2 else 16,
                     dt=5e-5, surface_tension=sigma)


@pytest.mark.parametrize("d,dtype", [(2, np.float32), (2, np.float64), (3, np.float32),
                                     (3, np.float64)], ids=["2d-f32", "2d-f64", "3d-f32", "3d-f64"])
def test_csf_force_matches_jax(d, dtype):
    cfg = _cfg(d, dtype)
    m = _mass_field(cfg.num_grids, d, dtype, seed=d)
    want = jax.jit(lambda x: stab_jax._csf_force(x, cfg, Physics(), x.dtype))(jnp.asarray(m))
    cfg_t = convert.scene_from_fields(dataclasses.asdict(_scene(cfg, 1.0))).cfg
    got = stabilized._csf_force(torch.from_numpy(m), cfg_t, None, torch.from_numpy(m).dtype)
    _assert_close(got, want, TOL[dtype])
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("d", [2, 3])
def test_csf_force_shards_match_single(d):
    """4 slab shards stacked on dim 0 (`halo=halo_gather_only`): the
    force on the owned rows equals one device's (float64, 1e-12)."""
    n, g = 4, (40 if d == 2 else 16)
    cfg = convert.scene_from_fields(dataclasses.asdict(_scene(_cfg(d, np.float64), 1.0))).cfg
    m = _mass_field(g, d, np.float64, seed=d + 2)
    ctx = fd.FastDomainCtx(SlabMesh(n, "cpu"), g // n)
    rows = ctx.row_index0("cpu").numpy()
    valid = (rows >= 0) & (rows < g)
    stacked = np.zeros((n, g // n + 4) + m.shape[1:])
    stacked[valid] = m[rows[valid]]
    one = stabilized._csf_force(torch.from_numpy(m), cfg, None, torch.float64)
    many = stabilized._csf_force(
        torch.from_numpy(stacked), cfg, None, torch.float64, halo=ctx.halo_gather_only)
    own = ctx.own_rows("cpu").numpy()
    _assert_close(many.numpy()[own], one.numpy()[rows[own]], TOL[np.float64])


def _scene(cfg, min_mass, **kw):
    """tests/test_surface_tension.py:19-52's scene around particles of
    lightest mass `min_mass`."""
    physics = Physics(gravity=0.0)
    return stab_jax.Scene(
        cfg=cfg, physics=physics,
        params=mat_jax.MaterialParams(bulk_modulus=physics.bulk_modulus,
                                      dynamic_viscosity=physics.dynamic_viscosity),
        wall=stab_jax.WallBC("slip"), mass_floor=1e-8 * min_mass, **kw)


def _drop(d, sigma=5.0, dtype="float32", penalty=False):
    """The zero-gravity 2:1 drop of tests/test_surface_tension.py (41^2,
    32 x 16 particles) or its 2:1:1 3D drop (16^3, 12 x 6 x 6), JAX side."""
    cfg = MPMConfig(dim=d, dtype=dtype, num_grids=41 if d == 2 else 16, dt=5e-5,
                    surface_tension=sigma, use_penalty_ebc=penalty)
    l = cfg.domain_length
    if d == 2:
        size, n = (0.22 * l, 0.11 * l), (32, 16)
    else:
        size, n = (0.3 * l, 0.15 * l, 0.15 * l), (12, 6, 6)
    axes = [(np.arange(n[a]) + 0.5) * (size[a] / n[a]) + 0.5 * (l - size[a]) for a in range(d)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    p = Particles_jax.init(jnp.asarray(x, jdt), volume0=float(np.prod(size)) / float(np.prod(n)),
                           density=Physics().particle_density)
    return p, _scene(cfg, float(np.min(np.asarray(p.mass))))


def _to_port(p, scene):
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    return p_t, convert.scene_from_fields(dataclasses.asdict(scene))


def test_zero_sigma_control_is_static():
    """tests/test_surface_tension.py:75-80, the port alone."""
    p, scene = _to_port(*_drop(2, sigma=0.0))
    out = stabilized.run(p, scene, 300)
    np.testing.assert_allclose(out.x.numpy(), p.x.numpy(), atol=1e-6)


CASES = {"2d": dict(d=2), "2d-f64": dict(d=2, dtype="float64"),
         "2d-penalty": dict(d=2, penalty=True), "3d": dict(d=3),
         "3d-penalty": dict(d=3, penalty=True)}


@functools.lru_cache(maxsize=None)
def _jax_general(case):
    """One JAX general substep: (port particles, port scene, JAX x, JAX v)."""
    p, scene = _drop(**CASES[case])
    out = stab_jax.run(p, scene, 1)
    return (*_to_port(p, scene), np.asarray(out.x), np.asarray(out.v))


@pytest.mark.parametrize("case", list(CASES))
def test_general_substep_matches_jax(case):
    p, scene, x, v = _jax_general(case)
    out = stabilized.substep(p, scene)
    if p.x.dtype == torch.float64:
        _assert_close(out.x, x, TOL[np.float64])
        _assert_close(out.v, v, TOL[np.float64])
    else:
        np.testing.assert_allclose(out.x.numpy(), x, rtol=0, atol=VS_GENERAL["x"])
        np.testing.assert_allclose(out.v.numpy(), v, rtol=0, atol=VS_GENERAL["v"])
        _assert_close(out.v, v, V_REL)
    # Surface tension acts: without it (and without gravity) the drop rests.
    assert float(out.v.abs().max()) > 1e-5


def _fast(dim):
    return fast3d if dim == 3 else fast2d


@pytest.mark.parametrize("case", ["2d", "2d-penalty", "3d", "3d-penalty"])
def test_fast_substep_matches_general(case):
    """One fast substep against JAX's general one, slot for slot (Jp,
    which a fluid never reads, carries each particle's index)."""
    p, scene, x, v = _jax_general(case)
    d = scene.cfg.dim
    mod = _fast(d)
    spec = (fast3d.FastSpec3D if d == 3 else fast2d.FastSpec).for_particles(
        scene.cfg, p, headroom=2.0)
    b = mod.from_particles(p, scene.cfg, spec, "cpu")
    tagged = dataclasses.replace(p, Jp=torch.arange(p.n, dtype=p.Jp.dtype))
    ids = mod.to_host(mod.from_particles(tagged, scene.cfg, spec, "cpu"))["Jp"].astype(np.int64)
    b1 = fast3d.substep(b, scene, spec) if d == 3 else fast2d.substep(b, scene)
    h = mod.to_host(b1)
    np.testing.assert_allclose(np.stack([h[f"x{a}"] for a in range(d)], -1), x[ids],
                               rtol=0, atol=VS_GENERAL["x"])
    vf = np.stack([h[f"v{a}"] for a in range(d)], -1)
    np.testing.assert_allclose(vf, v[ids], rtol=0, atol=VS_GENERAL["v"])
    _assert_close(vf, v[ids], V_REL)


def _live(b, names):
    return torch.stack([getattr(b, k)[b.mask > 0] for k in names]).double()


@pytest.mark.parametrize("dim,n_sub", [(2, 50), (3, 10)], ids=["2d", "3d"])
def test_sharded_matches_single(dim, n_sub):
    """4 slab shards against one device (tests/test_surface_tension.py:
    160-190, 231-260), slot for slot: v, C and J to 1e-5 of their scale,
    the displacement to 1e-5 of its own."""
    p, scene = _to_port(*_drop(dim))
    mesh = SlabMesh(4, "cpu")
    dom = fd3 if dim == 3 else fd
    spec_cls = fd3.FastDomain3DSpec if dim == 3 else fd.FastDomainSpec
    spec = spec_cls.for_particles(scene.cfg, 4, p, headroom=2.0)
    b4 = dom.distribute(p, scene.cfg, spec, mesh)
    got = dom.make_run(scene, spec, mesh)(b4, n_sub)
    if dim == 3:
        spec1 = spec.global_spec
        ref = fast3d.run(fast3d.from_particles(p, scene.cfg, spec1, "cpu"), scene, spec1, n_sub)
        groups = {"v": ("v0", "v1", "v2"), "C": ("C00", "C11", "C22", "C01"), "J": ("J",)}
        xs = ("x0", "x1", "x2")
    else:
        spec1 = fast2d.FastSpec(rows=spec.n_shards * spec.rows_per_shard, capacity=spec.capacity)
        ref = fast2d.run(fast2d.from_particles(p, scene.cfg, spec1, "cpu"), scene, spec1, n_sub)
        groups = {"v": ("v0", "v1"), "C": ("C00", "C01", "C10", "C11"), "J": ("J",)}
        xs = ("x0", "x1")
    assert int(got.overflow.sum()) == 0 and int(ref.overflow) == 0
    assert torch.equal(got.mask, ref.mask)
    pairs = {g: (_live(got, k), _live(ref, k)) for g, k in groups.items()}
    start = _live(b4, xs)
    pairs["displacement"] = (_live(got, xs) - start, _live(ref, xs) - start)
    for g, (have, want) in pairs.items():
        scale = float(((want - 1.0) if g == "J" else want).abs().max())
        assert scale > 0 and float((have - want).abs().max()) <= SHARD_TOL * scale, g
