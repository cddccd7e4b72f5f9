"""The port's incompressible projection against the JAX package.

`models/projection.py` on the same seeded numpy fields as the JAX module:
`divergence_b`, `project_planes` in 2D (33^2) and 3D (16^3) in float32
and float64, with and without a collider's solid mask, at the default exit
and at a fixed iteration count (`tol = 0`), the breakdown guard on a fluid
block enclosed by solid, and the stacked 4-shard form against the single
one.  Then the physics twins of tests/test_projection.py (the divergence
dies, a second projection changes little, the hydrostatic column, the
200-substep golden statistics, run by the port alone against JAX's pinned
values), whole substeps (the general path against JAX's, the fast paths
against JAX's general path, 4 shards against one device, the
collider case of tests/test_colliders.py:303) and `dam2d_incompressible`
through the CLI on both paths and in 4 shards.

Tolerances: float64 1e-12 of each output's scale; float32 solver output
1e-5 of scale (the CG's scalars round differently in XLA and torch);
whole substeps JAX's own, x 1e-7 and v 1e-4 (tests/test_projection.py:
180-181); shards against one device 1e-5 of each field's scale, slot for
slot (tests/test_torch_colliders.py's sharded bound).  JAX results are
cached per module.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import projection as proj_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models.stabilized import run as run_jax
from mpm_flip98a_tpu_torch import convert, driver
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, projection, stabilized
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
DX = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(g, d, seed=0, dtype=np.float32, solid=False):
    """tests/test_projection.py:23-34's field: a fluid block in the lower
    quadrant with seeded velocities; `solid` adds a ball of solid nodes
    inside it (a collider's interior)."""
    rng = np.random.default_rng(seed)
    lo, hi = 2, g - 3
    m = np.zeros((g,) * d, dtype)
    m[tuple(slice(lo + 1, lo + 1 + (hi - lo) // 2) for _ in range(d))] = 1.0
    v = rng.normal(size=m.shape + (d,)).astype(dtype) * (m > 0)[..., None]
    extra = None
    if solid:
        idx = np.indices(m.shape)
        c = lo + 1 + (hi - lo) // 4
        extra = sum((i - c) ** 2 for i in idx) <= 2.5 ** 2
    return v, m, lo, hi, extra


def _assert_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale, tol)


@pytest.mark.parametrize("d", [2, 3])
def test_divergence_b_matches_jax(d):
    v = _field(33 if d == 2 else 16, d, seed=d, dtype=np.float64)[0]
    _assert_close(projection.divergence_b(torch.from_numpy(v), DX),
                  proj_jax.divergence_b(jnp.asarray(v), DX), TOL[np.float64])


# (d, dtype, collider solid, tol, iters): each dimension and dtype at the
# default exit and at a fixed count, with and without a solid mask.
SOLVES = {
    "2d-f32": (2, np.float32, False, 1e-4, 60),
    "2d-f64-solid": (2, np.float64, True, 1e-4, 60),
    "2d-f32-fixed-solid": (2, np.float32, True, 0.0, 25),
    "2d-f64-fixed": (2, np.float64, False, 0.0, 25),
    "3d-f32-solid": (3, np.float32, True, 1e-4, 60),
    "3d-f64": (3, np.float64, False, 1e-4, 60),
    "3d-f32-fixed": (3, np.float32, False, 0.0, 25),
    "3d-f64-fixed-solid": (3, np.float64, True, 0.0, 25),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_project_planes_matches_jax(case):
    d, dtype, solid, tol, iters = SOLVES[case]
    v, m, lo, hi, extra = _field(33 if d == 2 else 16, d, seed=len(case), dtype=dtype,
                                 solid=solid)
    kw = dict(dx=DX, lo=lo, hi=hi, iters=iters, tol=tol)
    vs = tuple(v[..., a] for a in range(d))
    # One jit of the whole solve: the JAX module is not jitted itself, and
    # op by op it compiles every primitive on first use.
    vj, qj, rj = jax.jit(functools.partial(proj_jax.project_planes, **kw))(
        tuple(jnp.asarray(x) for x in vs), jnp.asarray(m), 0.5,
        solid_extra=None if extra is None else jnp.asarray(extra))
    vt, qt, rt = projection.project_planes(
        tuple(torch.from_numpy(x) for x in vs), torch.from_numpy(m), 0.5, **kw,
        solid_extra=None if extra is None else torch.from_numpy(extra))
    for a in range(d):
        _assert_close(vt[a], vj[a], TOL[dtype])
    _assert_close(qt, qj, TOL[dtype])
    # resid = |r| / |b| is a ratio: its scale is 1.
    assert abs(float(rt) - float(rj)) <= TOL[dtype], (float(rt), float(rj))
    assert float(rt) < (1e-4 if tol else 1.0)
    if solid:       # the collider's nodes are Neumann: their velocity stays
        for a in range(d):
            np.testing.assert_array_equal(vt[a].numpy()[extra], vs[a][extra])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_breakdown_guard_matches_jax(dtype):
    """A fluid block filling the box (tests/test_colliders.py:276-300):
    pure Neumann, no free surface, so sum(b) = 0 fails and the iterates
    walk along the null space until pap collapses and the guard exits.
    On that walk rounding grows about 50x every 20 iterations (read here:
    1e-15 of scale at 40 iterations in float64, 1e-11 at the exit), so the
    solve is held to JAX at the stated tolerances at 40 iterations; at 300
    the exit is held: the guard froze the solve between 80 and 120
    iterations (the 120- and 300-iteration results are bitwise equal), v
    is finite and bounded as in JAX's test, and the exit resid is JAX's
    within 1e-3 of itself."""
    rng = np.random.default_rng(7)
    g, lo, hi = 32, 2, 29
    m = np.zeros((g, g), dtype)
    m[lo + 1 : hi, lo + 1 : hi] = 1.0
    v = rng.normal(size=(g, g, 2)).astype(dtype) * (m > 0)[..., None]
    args_j = (jnp.asarray(v), jnp.asarray(m), 0.5)
    args_t = (torch.from_numpy(v), torch.from_numpy(m), 0.5)
    kw = dict(dx=DX, lo=lo, hi=hi, tol=1e-6)
    vj, qj, _ = proj_jax.project(*args_j, **kw, iters=40)
    vt, qt, _ = projection.project(*args_t, **kw, iters=40)
    _assert_close(vt, vj, TOL[dtype])
    _assert_close(qt, qj, TOL[dtype])
    _, _, rj = proj_jax.project(*args_j, **kw, iters=300)
    vt, qt, rt = projection.project(*args_t, **kw, iters=300)
    v80 = projection.project(*args_t, **kw, iters=80)[0]
    v120 = projection.project(*args_t, **kw, iters=120)[0]
    assert torch.equal(v120, vt) and not torch.equal(v80, vt)
    assert bool(torch.isfinite(vt).all()) and float(vt.abs().max()) < 100.0 * np.abs(v).max()
    assert float(rt) > 1.0 and abs(float(rt) - float(rj)) <= 1e-3 * float(rj)


def test_host_read_interval_keeps_the_result(monkeypatch):
    """The active flag freezes a finished solve: reading it every
    iteration, every 8 or never gives bitwise the same v, q and resid."""
    v, m, lo, hi, extra = _field(33, 2, seed=9, solid=True)
    args = (torch.from_numpy(v), torch.from_numpy(m), 0.5)
    kw = dict(dx=DX, lo=lo, hi=hi, solid_extra=torch.from_numpy(extra))
    runs = []
    for every in (1, 8, 10 ** 6):
        monkeypatch.setattr(projection, "CHECK_EVERY", every)
        runs.append(projection.project(*args, **kw))
    one, eight, never = runs
    for a, b, c in zip(one, eight, never):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("d", [2, 3])
def test_stacked_shards_match_single(d):
    """4 slab shards stacked on dim 0, halo rows from `halo_gather_only`,
    dot products over the owned rows, against the single-device solve of
    the same (n L, G...) planes (float64, 1e-12 of scale)."""
    n, g = 4, (36 if d == 2 else 16)
    v, m, lo, hi, extra = _field(g, d, seed=d + 4, dtype=np.float64, solid=True)
    l = g // n
    ctx = fd.FastDomainCtx(SlabMesh(n, "cpu"), l)
    rows = ctx.row_index0("cpu")                                      # (n, L + 4)
    valid = ((rows >= 0) & (rows < g)).numpy()

    def shard(a):
        out = np.zeros((n, l + 4) + a.shape[1:], a.dtype)
        out[valid] = a[rows.numpy()[valid]]
        return torch.from_numpy(out)

    kw = dict(dx=DX, lo=lo, hi=hi)
    vs = [v[..., a] for a in range(d)]
    one = projection.project_planes(tuple(torch.from_numpy(x) for x in vs),
                                    torch.from_numpy(m), 0.5, **kw,
                                    solid_extra=torch.from_numpy(extra))
    many = projection.project_planes(
        tuple(shard(x) for x in vs), shard(m), 0.5, **kw, row_index0=rows, shards=True,
        halo=ctx.halo_gather_only, own=ctx.own_rows("cpu"), solid_extra=shard(extra))
    own = ctx.own_rows("cpu").numpy()
    at = rows.numpy()[own]
    for got, want in zip((*many[0], many[1]), (*one[0], one[1])):
        _assert_close(got.numpy()[own], want.numpy()[at], TOL[np.float64])
    assert abs(float(many[2]) - float(one[2])) <= TOL[np.float64]


# ---------------------------------------------------------------------------
# The physics twins of tests/test_projection.py, the port alone
# ---------------------------------------------------------------------------


def _core(fluid):
    core = fluid.copy()
    for a in range(fluid.ndim):
        core &= np.roll(fluid, 1, a) & np.roll(fluid, -1, a)
    return core


@pytest.mark.parametrize("d", [2, 3])
def test_projection_kills_divergence(d):
    """tests/test_projection.py:37-61: the divergence on the fluid core
    falls below 2% and wall nodes keep their velocity."""
    v, m, lo, hi, _ = _field(48 if d == 2 else 24, d)
    v2, q, _ = projection.project(torch.from_numpy(v), torch.from_numpy(m), 0.5, dx=DX,
                                  lo=lo, hi=hi, iters=200, tol=1e-6)
    core = _core(m > 0.5)
    div0 = projection.divergence_b(torch.from_numpy(v), DX).numpy()[core]
    div1 = projection.divergence_b(v2, DX).numpy()[core]
    assert np.sqrt((div1 ** 2).mean()) < 0.02 * np.sqrt((div0 ** 2).mean())
    idx = np.indices(m.shape)
    solid = (idx <= lo).any(axis=0) | (idx >= hi).any(axis=0)
    np.testing.assert_array_equal(v2.numpy()[solid], v[solid])
    assert bool(torch.isfinite(q).all())


def test_projection_near_idempotent():
    """tests/test_projection.py:64-72."""
    v, m, lo, hi, _ = _field(48, 2)
    kw = dict(dx=DX, lo=lo, hi=hi, iters=200, tol=1e-6)
    v1, _, _ = projection.project(torch.from_numpy(v), torch.from_numpy(m), 0.5, **kw)
    v2, _, _ = projection.project(v1, torch.from_numpy(m), 0.5, **kw)
    assert float((v2 - v1).abs().max()) < 0.2 * float((v1 - torch.from_numpy(v)).abs().max())


def test_projection_hydrostatic_column():
    """tests/test_projection.py:75-107: a column falling at c comes to rest
    and q decreases from floor to surface."""
    g, lo, hi = 40, 2, 37
    m = np.zeros((g, g), np.float32)
    m[lo + 1 : hi, lo + 1 : lo + 16] = 1.0
    c = 0.7
    v = np.zeros((g, g, 2), np.float32)
    v[..., 1] = -c * m
    v2, q, _ = projection.project(torch.from_numpy(v), torch.from_numpy(m), 0.5, dx=DX,
                                  lo=lo, hi=hi, iters=400, tol=1e-8)
    assert np.abs(v2.numpy()[_core(m > 0)]).max() < 0.02 * c
    assert (np.diff(q.numpy()[g // 2, lo + 1 : lo + 16]) < 1e-6).all()


def _incompressible_cfg(**kw):
    """tests/test_projection.py:110-117."""
    return MPMConfig(**{**dict(
        dtype="float32", num_grids=33, dt=1e-5, num_particles_x=24, num_particles_y=48,
        fluid_width=0.105, fluid_height=0.21, flip_blend=0.98, transfer=TransferKind.PIC,
        incompressible=True, pressure_iters=40), **kw})


def _to_port(p, scene):
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    return p_t, convert.scene_from_fields(dataclasses.asdict(scene))


def test_incompressible_golden_stats():
    """tests/test_projection.py:285-301's pinned 200-substep statistics,
    run by the port's general path alone."""
    p, scene = _to_port(*scenes_jax.dam_break_2d(_incompressible_cfg(), dtype=np.float32))
    out = stabilized.run(p, scene, 200)
    x = out.x.numpy()
    np.testing.assert_allclose(x.mean(0), [0.052505, 0.104992], atol=2e-4)
    np.testing.assert_allclose(x.std(0), [0.030286, 0.060605], atol=2e-4)
    assert float((out.J - 1).abs().max()) < 5e-4


# ---------------------------------------------------------------------------
# Whole substeps
# ---------------------------------------------------------------------------


def _jax_scene(case):
    if case == "2d-f64":
        return scenes_jax.dam_break_2d(_incompressible_cfg(dtype="float64"), dtype=np.float64)
    if case == "2d-obstacle":
        # tests/test_colliders.py:303-320's dam and cylinder, the cylinder
        # moved against the column's edge (tests/test_torch_colliders.py's
        # placement) so that its solid nodes border fluid nodes in the CG.
        cfg = MPMConfig(dtype="float32", num_grids=37, dt=2e-5, flip_blend=0.98,
                        transfer=TransferKind.PIC, incompressible=True)
        return scenes_jax.dam_break_obstacle_2d(cfg, dtype=np.float32, center_frac=(0.12, 0.10))
    if case == "3d":
        return scenes_jax.dam_break_3d(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5,
                                       dtype=np.float32, incompressible=True, pressure_iters=40)
    return scenes_jax.dam_break_2d(_incompressible_cfg(), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_general(case):
    """One JAX general substep: (port particles, port scene, JAX x, JAX v)."""
    p, scene = _jax_scene(case)
    out = run_jax(p, scene, 1)
    return (*_to_port(p, scene), np.asarray(out.x), np.asarray(out.v))


@pytest.mark.parametrize("case", ["2d", "2d-f64", "3d", "2d-obstacle"])
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


def _fast(dim):
    return fast3d if dim == 3 else fast2d


def _tagged_buckets(p, scene, spec):
    """The fast state of `p` and each live slot's particle index, in
    `to_host` order: Jp (never read by a fluid) carries the index."""
    mod = _fast(scene.cfg.dim)
    b = mod.from_particles(p, scene.cfg, spec, "cpu")
    tagged = dataclasses.replace(p, Jp=torch.arange(p.n, dtype=p.Jp.dtype))
    ids = mod.to_host(mod.from_particles(tagged, scene.cfg, spec, "cpu"))["Jp"]
    return b, ids.astype(np.int64)


def _host_xv(b, dim):
    h = _fast(dim).to_host(b)
    return (np.stack([h[f"x{a}"] for a in range(dim)], -1),
            np.stack([h[f"v{a}"] for a in range(dim)], -1))


@pytest.mark.parametrize("case", ["2d", "3d", "2d-obstacle"])
def test_fast_substep_matches_general(case):
    """One fast substep against JAX's general one, slot for slot, at JAX's
    fast-against-general tolerances; in 3D the scene leaves the fused
    branch for `p2g3d` + `fold_rows0` + `_grid_update`."""
    p, scene, x, v = _jax_general(case)
    dim = scene.cfg.dim
    spec_cls = fast3d.FastSpec3D if dim == 3 else fast2d.FastSpec
    spec = spec_cls.for_particles(scene.cfg, p, headroom=2.0)
    b, ids = _tagged_buckets(p, scene, spec)
    if dim == 3:
        assert not fast3d.uses_fused(scene) and not fast3d.kernel_grid(scene)
        assert scene.mass_floor > 0.0     # ext_grid alone leaves the fused branch
        b1 = fast3d.substep(b, scene, spec)
    else:
        b1 = fast2d.substep(b, scene)
    xf, vf = _host_xv(b1, dim)
    np.testing.assert_allclose(xf, x[ids], rtol=0, atol=VS_GENERAL["x"])
    np.testing.assert_allclose(vf, v[ids], rtol=0, atol=VS_GENERAL["v"])
    _assert_close(vf, v[ids], V_REL)


def _live(b, names):
    return torch.stack([getattr(b, k)[b.mask > 0] for k in names]).double()


@pytest.mark.parametrize("dim,n_sub", [(2, 50), (3, 10)], ids=["2d", "3d"])
def test_sharded_matches_single(dim, n_sub):
    """4 slab shards against one device (tests/test_projection.py:146-236),
    slot for slot: v, C and J to 1e-5 of their scale, the displacement to
    1e-5 of its own."""
    p, scene = _to_port(*_jax_scene("3d" if dim == 3 else "2d"))
    mesh = SlabMesh(4, "cpu")
    dom = fd3 if dim == 3 else fd
    spec_cls = fd3.FastDomain3DSpec if dim == 3 else fd.FastDomainSpec
    spec = spec_cls.for_particles(scene.cfg, 4, p, headroom=2.0)
    b4 = dom.distribute(p, scene.cfg, spec, mesh)
    got = dom.make_run(scene, spec, mesh)(b4, n_sub)
    if dim == 3:
        spec1 = spec.global_spec
        ref = fast3d.run(fast3d.from_particles(p, scene.cfg, spec1, "cpu"), scene, spec1, n_sub)
        groups = {"v": ("v0", "v1", "v2"), "C": ("C00", "C11", "C22", "C02"), "J": ("J",)}
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
        assert float((have - want).abs().max()) <= SHARD_TOL * scale, g


def test_collider_incompressible_fast_matches_general():
    """tests/test_colliders.py:303-320: the dam and the cylinder (against
    the column's edge) with the projection, the fast path against the
    general path (1e-5 on sorted x) after 20 substeps (JAX's test runs 40:
    the port's plain transfers take 0.2 s a substep here), the collider's
    nodes solid in the solve."""
    p, scene, _, _ = _jax_general("2d-obstacle")
    spec = fast2d.FastSpec.for_particles(scene.cfg, p)
    b20 = fast2d.run(fast2d.from_particles(p, scene.cfg, spec, "cpu"), scene, spec, 20)
    p20 = stabilized.run(p, scene, 20)
    xf = _host_xv(b20, 2)[0]
    xr = p20.x.numpy()
    assert np.isfinite(xr).all() and int(b20.overflow) == 0
    np.testing.assert_allclose(xf[np.lexsort((xf[:, 1], xf[:, 0]))],
                               xr[np.lexsort((xr[:, 1], xr[:, 0]))], atol=1e-5)


@pytest.mark.parametrize("extra", [[], ["--path", "fast"], ["--path", "fast", "--devices", "4"]],
                         ids=["general", "fast", "fast-x4"])
def test_cli_runs_dam2d_incompressible(tmp_path, extra):
    sim = driver.main(["--scenario", "dam2d_incompressible", "--frames", "1", "--substeps", "2",
                       "--no-gif", "--sync-io", "--out", str(tmp_path), "--device", "cpu", *extra])
    assert sim.cfg.incompressible and sim.stats.substeps == 2
    x = sim.positions()
    assert x.shape == (8450, 2) and np.isfinite(x).all()
    assert ((x > 0) & (x < sim.cfg.domain_length)).all()
    if extra:
        assert int(sim.state.overflow.sum()) == 0
        assert float((sim.state.J - 1).abs().max()) < 5e-4
