"""The general path's rank forms in bfloat16 against the JAX package's `shard_map` runs.

The JAX package runs `parallel/domain.py` and `parallel/replicated.py`
on bfloat16 particles under `shard_map` on the conftest's virtual CPU
devices; the port runs the same shards as gloo ranks
(`parallel/launch.run_ranks`): one launch of 4 ranks and one of 2 for
the whole module, the JAX references compiled once each meanwhile.  Both
start from the same bits (tests/test_dtypes.py's 37^2 dam cast to bf16),
and the runs are compared slot for slot, bit for bit, on every field but
`pou`: JAX's jitted run computes `pou` from float32 weight products that
its eager substep, and the port, round to bf16 first (PERF.md).
`pou` is held to one bf16 ulp of 1, its scale (2^-7, as
tests/test_torch_bf16.py holds JAX's jitted run); measured here: 2^-8 in
2D and 2^-7 on the 3D dam, where JAX's own jitted run is 2^-7 off its
eager substeps on one device too.  No state field reads `pou`.

Two roundings the port copies where the reference makes them:
  - the owning slab of `distribute` / `DomainSpec.for_particles` is
    computed in float32 (numpy on bf16 arrays promotes to float32 as they
    meet a Python float), the migration's base row in bf16 arithmetic on
    the device: the "slab_lines" case plants particles where the two
    differ, so the layout puts them on one rank and the first migration
    moves them to the next;
  - XLA's bf16 `psum` widens each rank's block to float32, adds them in
    rank order and rounds once (gloo's `all_reduce` rounds after every
    add, in its ring's order): planted partials tell the orders apart.
"""

import dataclasses
import functools
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import torch_bf16_rank_jobs as rank_jobs
from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.parallel import domain as domain_jax
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu.parallel import replicated as replicated_jax
from mpm_flip98a_tpu.state import Particles as ParticlesJax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.parallel import SlabMesh, domain, launch, replicated
from mpm_flip98a_tpu_torch.state import host_array, host_bits

FAST = dict(num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)   # test_dtypes.py:14
SWITCHES = dict(use_fbar=True, pressure_mixing_ratio=0.5, flip_blend=0.98,
                transfer=TransferKind.PIC, use_penalty_ebc=True)
FIELDS = [f.name for f in dataclasses.fields(ParticlesJax)]
POU_TOL = 2.0 ** -7          # one bf16 ulp of 1
# name: ranks, substeps.  "migrate" is tests/test_torch_domain.py's thrown
# column (32 x 32 particles at 3 m/s, dt 4e-5), which crosses the first
# slab line within 100 substeps in float64; in bf16 its front does not
# move in either package: v dt = 1.2e-4 is under half a bf16 ulp of x
# there (2.4e-4 at x = 0.116).  "thrown" throws it at 20 m/s (v dt 8e-4),
# which crosses.
CASES = {
    "plain": (4, 20),
    "switches": (4, 20),
    "migrate": (4, 100),
    "thrown": (4, 100),
    "slab_lines": (4, 2),        # at 41^2: at 37^2 no bf16 x sits where the rows part
    "plain_x2": (2, 20),
    "dam3d_x2": (2, 5),
}
REPLICATED = {"plain": 20, "switches": 20}
MULTIPLE = 12                # 512 particles padded to 516: 4 inert rows
# Planted partials, one bf16 block a rank (4 ranks).
PSUM = {
    # Rounded once: 1.015625; rounded after every add: 1.0.
    "round_once": [1.0, 2.0 ** -8, 2.0 ** -8, 2.0 ** -8],
    # Summed in rank order in float32: 0; (2^24 - 2^24) + 1 + 1: 2.
    "rank_order": [2.0 ** 24, 1.0, 1.0, -(2.0 ** 24)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_bf16(p):
    """JAX Particles with every float32 field cast to bf16 (test_dtypes.py:30-37)."""
    return type(p)(**{f: (getattr(p, f).astype(jnp.bfloat16)
                          if getattr(p, f).dtype == jnp.float32 else getattr(p, f))
                      for f in FIELDS})


def _bits(a) -> np.ndarray:
    """Bit patterns of a bf16 array (JAX's or `host_bits` records); other
    dtypes as they are."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" or a.dtype.kind == "V" else a


def _widen(a) -> np.ndarray:
    """A bf16 array's values as float64."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    return a.astype(np.float64)


def _host(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in FIELDS}


def _slab_line_x(cfg, rows, n_shards):
    """bf16 positions at the inner slab lines: every bf16 value within 64
    ulps of a line whose owning slab differs between the float32 base row
    (JAX's host numpy) and the bf16 one (JAX's `_base_row`), with the two
    values on either side of each."""
    out = set()
    for k in range(1, n_shards):
        line = torch.tensor((k * rows + 0.5 - domain.PAD) * cfg.dx).bfloat16()
        bits = line.view(torch.int16) + torch.arange(-64, 65, dtype=torch.int16)
        x = bits.view(torch.bfloat16).float().numpy()
        row32 = np.floor(x * cfg.inv_dx + domain.PAD - 0.5).astype(np.int64)
        xj = jnp.stack([jnp.asarray(x).astype(jnp.bfloat16)] * 2, -1)
        row16 = np.asarray(domain_jax._base_row(types.SimpleNamespace(x=xj), cfg), np.int64)
        slab = lambda row: np.clip(row // rows, 0, n_shards - 1)
        for i in np.nonzero(slab(row32) != slab(row16))[0]:
            out.update(x[max(i - 2, 0):i + 3].tolist())
    return np.asarray(sorted(out), np.float32)


@functools.lru_cache(maxsize=None)
def _jax_scene(name):
    """(bf16 particles, scene) of a case, JAX side."""
    if name in ("plain", "plain_x2", "slab_lines"):
        grid = dict(num_grids=41) if name == "slab_lines" else {}
        p, scene = scenes_jax.dam_break_2d(MPMConfig(**{**FAST, **grid}), dtype=np.float32)
        p = _to_bf16(p)
        if name == "slab_lines":
            x0 = _slab_line_x(scene.cfg, -(-scene.cfg.num_grids // 4), 4)
            idx = np.arange(len(x0)) * (p.n // len(x0))
            p = dataclasses.replace(
                p, x=p.x.at[idx, 0].set(jnp.asarray(x0).astype(jnp.bfloat16)))
        return p, scene
    if name == "switches":
        p, scene = scenes_jax.dam_break_2d(MPMConfig(**FAST, **SWITCHES), dtype=np.float32)
        return _to_bf16(p), scene
    if name in ("migrate", "thrown"):
        p, scene = scenes_jax.dam_break_2d(MPMConfig(
            **{**FAST, "dt": 4e-5, "num_particles_x": 32}, fluid_width=0.11), dtype=np.float32)
        speed = 3.0 if name == "migrate" else 20.0
        return _to_bf16(dataclasses.replace(p, v=p.v.at[:, 0].set(speed))), scene
    return scenes_jax.dam_break_3d(16, (8, 8, 16), dtype=jnp.bfloat16)


def _port(name):
    p, scene = _jax_scene(name)
    return (convert.particles_from_numpy(_host(p), "cpu"),
            convert.scene_from_fields(dataclasses.asdict(scene)))


@functools.lru_cache(maxsize=None)
def _jax_start(name):
    """JAX's (spec, distributed state, perm) of a case."""
    p, scene = _jax_scene(name)
    n = CASES[name][0]
    spec = domain_jax.DomainSpec.for_particles(scene.cfg, n, p, headroom=2.0)
    return (spec,) + domain_jax.distribute(p, scene, spec, make_mesh(n))


@functools.lru_cache(maxsize=None)
def _jax_domain(name):
    """JAX's domain run of a case: (start fields, end fields, dropped, the
    end's `collect`)."""
    spec, state, _ = _jax_start(name)
    n, n_sub = CASES[name]
    out = domain_jax.make_run(_jax_scene(name)[1], spec, make_mesh(n))(state, n_sub)
    return (_host(state.particles), _host(out.particles), np.asarray(out.dropped),
            _host(domain_jax.collect(out)))


@functools.lru_cache(maxsize=None)
def _jax_padded(name):
    p, _ = _jax_scene("plain" if name == "plain" else "switches")
    return replicated_jax.pad_particles(p, MULTIPLE)


@functools.lru_cache(maxsize=None)
def _jax_replicated(name):
    mesh = make_mesh(4)
    scene = _jax_scene("plain" if name == "plain" else "switches")[1]
    out = replicated_jax.make_run(scene, mesh)(
        replicated_jax.shard_particles(_jax_padded(name), mesh), REPLICATED[name])
    return _host(out)


@functools.lru_cache(maxsize=None)
def _jax_psum():
    """XLA's psum of each case's blocks under shard_map on 4 devices."""
    blocks = _psum_blocks()
    mesh = make_mesh(4)
    f = jax.jit(jax.shard_map(lambda x: jax.lax.psum(x, "x"), mesh=mesh, in_specs=P("x"),
                              out_specs=P("x")))
    return {name: np.asarray(f(jnp.asarray(b).astype(jnp.bfloat16)))[0]
            for name, b in blocks.items()}


@functools.lru_cache(maxsize=None)
def _psum_blocks():
    """{case: (4, k) float32 blocks, exact in bf16}: the planted partials
    and 4096 seeded values a rank spread over 1e-3 to 300 of either sign."""
    out = {name: np.asarray(v, np.float32)[:, None] for name, v in PSUM.items()}
    rng = np.random.default_rng(0)
    spread = rng.choice([-1.0, 1.0], (4, 4096)) * 10.0 ** rng.uniform(-3, np.log10(300),
                                                                      (4, 4096))
    out["spread"] = torch.from_numpy(spread).bfloat16().float().numpy()
    return out


HALO_L = 6                   # rows of a slab's interior in the halo case


@functools.lru_cache(maxsize=None)
def _halo_blocks():
    """(4, L + 2H, 64) bf16-exact float32 buffers, one a rank: seeded values
    spread over 1e-3 to 300 of either sign, so the halo adds round."""
    rng = np.random.default_rng(1)
    shape = (4, HALO_L + 2 * domain.H, 64)
    b = rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-3, np.log10(300), shape)
    return torch.from_numpy(b).bfloat16().float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_halo():
    """domain.halo_reduce's `.at[].add` on bf16 buffers under shard_map."""
    f = jax.jit(jax.shard_map(lambda b: domain_jax.halo_reduce(b[0], "x", 4, HALO_L)[None],
                              mesh=make_mesh(4), in_specs=P("x"), out_specs=P("x")))
    return np.asarray(f(jnp.asarray(_halo_blocks()).astype(jnp.bfloat16)))


def _domain_job(name):
    p, scene = _port(name)
    n, n_sub = CASES[name]
    spec = domain.DomainSpec.for_particles(scene.cfg, n, p, headroom=2.0)
    return dict(kind="domain", scene=scene, spec=spec, n=n_sub,
                start={f: host_bits(getattr(p, f)) for f in FIELDS})


@pytest.fixture(scope="module")
def ranked():
    """Every case in one launch of 4 ranks and one of 2: {case: the
    global state (n capacity slots, shard order) and dropped}, the
    replicated runs as "replicated/<case>", the psums as "psum"; the JAX
    references are made while the ranks work."""
    four = [name for name, (n, _) in CASES.items() if n == 4]
    two = [name for name, (n, _) in CASES.items() if n == 2]
    jobs4 = [_domain_job(name) for name in four]
    for name in REPLICATED:
        p, scene = _port("plain" if name == "plain" else "switches")
        pp = replicated.pad_particles(p, MULTIPLE)
        jobs4.append(dict(kind="replicated", scene=scene, n=REPLICATED[name],
                          fields={f: host_bits(getattr(pp, f)) for f in FIELDS}))
    jobs4.append(dict(kind="halo", L=HALO_L, blocks=[
        host_bits(torch.from_numpy(b).bfloat16()) for b in _halo_blocks()]))
    jobs4.append(dict(_domain_job("slab_lines"), kind="collect"))
    jobs4.append(dict(kind="psum", blocks={
        name: [host_bits(torch.from_numpy(b[r]).bfloat16()) for r in range(4)]
        for name, b in _psum_blocks().items()}))
    launch_kw = dict(args=(), device="cpu", backend="gloo", timeout_s=60.0, deadline_s=300.0)
    with ThreadPoolExecutor(4) as pool:
        r4 = pool.submit(launch.run_ranks, rank_jobs.run_jobs, 4,
                         **{**launch_kw, "args": (jobs4,)})
        r2 = pool.submit(launch.run_ranks, rank_jobs.run_jobs, 2,
                         **{**launch_kw, "args": ([_domain_job(name) for name in two],)})
        refs = [pool.submit(_jax_domain, name) for name in CASES]
        refs += [pool.submit(_jax_replicated, name) for name in REPLICATED]
        refs.append(pool.submit(_jax_psum))
        refs.append(pool.submit(_jax_halo))
        for ref in refs:
            ref.result()
        per4, per2 = r4.result(), r2.result()
    out = {}
    for names, per_rank in ((four, per4), (two, per2)):
        for j, name in enumerate(names):
            out[name] = {k: np.concatenate([r[j][k] for r in per_rank]) for k in per_rank[0][j]}
    for j, name in enumerate(REPLICATED):
        j += len(four)
        assert all(np.array_equal(_bits(r[j][f]), _bits(per4[0][j][f]))
                   for r in per4 for f in FIELDS), "the ranks' collected states differ"
        out[f"replicated/{name}"] = per4[0][j]
    out["halo"] = [r[-3] for r in per4]
    out["collect"] = [r[-2] for r in per4]
    out["psum"] = [r[-1] for r in per4]
    return out


def _assert_bitwise_but_pou(got, want):
    differ = [f for f in FIELDS if f != "pou" and not np.array_equal(_bits(got[f]), _bits(want[f]))]
    assert not differ, differ
    assert got["x"].dtype.kind == "V" and got["mass"].dtype.kind == "V"
    pou = float(np.abs(_widen(got["pou"]) - _widen(want["pou"])).max())
    assert pou <= POU_TOL, pou


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_spec_layout_and_perm_bitwise(name):
    """DomainSpec.for_particles, layout's padded fields (bf16 padding cast
    as JAX's astype casts it) and perm equal JAX's distribute bit for bit."""
    p, scene = _port(name)
    spec_jax, state, perm_jax = _jax_start(name)
    spec = domain.DomainSpec.for_particles(scene.cfg, CASES[name][0], p, headroom=2.0)
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_jax)
    full, perm = domain.layout(p, scene, spec)
    np.testing.assert_array_equal(perm, perm_jax)
    start = _host(state.particles)
    differ = [f for f in FIELDS if not np.array_equal(_bits(full[f]), _bits(start[f]))]
    assert not differ, differ
    assert full["x"].dtype == np.dtype("V2")


def test_bf16_slab_line_rows_differ_between_layout_and_migration():
    """The planted particles: on some of them the float32 row (layout's,
    JAX's host numpy) and the bf16 row (the migration's, JAX's device
    arithmetic) differ, and the layout follows float32."""
    p, scene = _port("slab_lines")
    rows32 = np.floor(host_array(p.x)[:, 0] * scene.cfg.inv_dx + domain.PAD - 0.5).astype(np.int64)
    rows16 = domain._base_row(p, scene.cfg).numpy()
    assert (rows32 != rows16).sum() >= 3, (rows32 != rows16).sum()
    L = -(-scene.cfg.num_grids // 4)
    spec = domain.DomainSpec.for_particles(scene.cfg, 4, p)
    perm = domain.layout(p, scene, spec)[1]
    np.testing.assert_array_equal(perm // spec.capacity, np.clip(rows32 // L, 0, 3))


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_domain_bitwise_jax_shard_map(ranked, name):
    """domain.make_run on 4 and 2 gloo ranks: every field of every slot
    bitwise JAX's make_run under shard_map, `pou` within one ulp of 1;
    `dropped` 0 and equal to JAX's."""
    _, want, dropped, _ = _jax_domain(name)
    got = ranked[name]
    np.testing.assert_array_equal(got["dropped"], dropped)
    assert int(got["dropped"].sum()) == 0
    _assert_bitwise_but_pou(got, want)


@pytest.mark.parametrize("name", ["thrown", "slab_lines"])
def test_bf16_domain_migrates(ranked, name):
    """Particles changed rank in both packages, none was lost, mass kept;
    at 3 m/s ("migrate") none changed rank in either."""
    start, want, _, _ = _jax_domain(name)
    got = ranked[name]
    n = CASES[name][0]
    before = (_widen(start["mass"]) > 0).reshape(n, -1).sum(1)
    after = (_widen(got["mass"]) > 0).reshape(n, -1).sum(1)
    assert (after != before).any(), (before, after)
    np.testing.assert_array_equal(after, (_widen(want["mass"]) > 0).reshape(n, -1).sum(1))
    assert after.sum() == before.sum()
    assert _widen(got["mass"]).sum() == _widen(start["mass"]).sum()
    start = _jax_domain("migrate")[0]
    np.testing.assert_array_equal((_widen(ranked["migrate"]["mass"]) > 0).reshape(4, -1).sum(1),
                                  (_widen(start["mass"]) > 0).reshape(4, -1).sum(1))


def test_bf16_collect_bitwise_jax(ranked):
    """domain.collect after the slab-line run: every rank holds the active
    particles of all, in shard-then-slot order, bitwise JAX's collect but
    `pou`."""
    want = _jax_domain("slab_lines")[3]
    for got in ranked["collect"]:
        assert len(got["x"]) == len(want["x"]) == _port("slab_lines")[0].n
        _assert_bitwise_but_pou(got, want)


def test_bf16_pad_particles_bitwise_jax():
    for name in REPLICATED:
        p, _ = _port("plain" if name == "plain" else "switches")
        got = replicated.pad_particles(p, MULTIPLE)
        want = _host(_jax_padded(name))
        differ = [f for f in FIELDS
                  if not np.array_equal(_bits(host_bits(getattr(got, f))), _bits(want[f]))]
        assert not differ, differ


@pytest.mark.parametrize("name", list(REPLICATED))
def test_bf16_replicated_bitwise_jax_shard_map(ranked, name):
    """replicated.make_run on 4 ranks, its grid merged by the bf16 psum:
    every field bitwise JAX's, `pou` within one ulp of 1."""
    _assert_bitwise_but_pou(ranked[f"replicated/{name}"], _jax_replicated(name))


@pytest.mark.parametrize("name", ["round_once", "rank_order", "spread"])
def test_bf16_psum_bitwise_jax(ranked, name):
    """RankMesh.psum on bf16 blocks: every rank the same bits, those of
    XLA's psum under shard_map and of SlabMesh.psum; the planted partials
    give the once-rounded, rank-ordered sums."""
    want = _bits(_jax_psum()[name])
    for rank in ranked["psum"]:
        np.testing.assert_array_equal(_bits(rank[name]), want)
    blocks = torch.from_numpy(_psum_blocks()[name]).bfloat16()
    slab = SlabMesh(4, torch.device("cpu")).psum(blocks)
    np.testing.assert_array_equal(_bits(host_bits(slab)), want)
    if name in PSUM:
        got = float(_widen(_jax_psum()[name])[0])
        assert got == {"round_once": 1.015625, "rank_order": 0.0}[name], got


def test_bf16_halo_reduce_bitwise_jax(ranked):
    """domain.halo_reduce's in-place `+=` on bf16 rows rounds each sum once,
    as the reference's `.at[L:L+H].add` does: every rank's buffer bitwise
    JAX's under shard_map (the end ranks' outer strips receive zeros)."""
    want = _jax_halo()
    for r, got in enumerate(ranked["halo"]):
        np.testing.assert_array_equal(_bits(got), _bits(want[r]))
    assert not np.array_equal(_bits(want[1]), _bits(torch.from_numpy(_halo_blocks()[1])
                                                    .bfloat16().view(torch.int16).numpy()))
