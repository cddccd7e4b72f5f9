"""The port's slab-sharded 2D fast path against the JAX package.

The JAX package runs one shard per device under `shard_map` on the
virtual 8-device CPU mesh (conftest.py); the port runs the same n shards
as a leading tensor dimension on one device (`parallel.SlabMesh`).  Both
start from the same scene and bucket it identically (the layouts are
compared bit for bit), so the halo exchange and the migration are held
bit-exact on random buffers and on a state with movers both ways, and the
runs slot for slot.  Run tolerances are the JAX package's own
(tests/test_parallel_fast_domain.py: 1e-5 on sorted positions).  The JAX
kernels run in Pallas interpret mode; the port runs its plain versions.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.parallel import fast_domain as fd_jax
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu_torch.config import MPMConfig as MPMConfig_t
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast2d, scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
from mpm_flip98a_tpu_torch.parallel import SlabMesh
from mpm_flip98a_tpu_torch.parallel import fast_domain as fd

N = 8
_FAST_KW = dict(  # tests/test_parallel_fast_domain.py:24-32
    dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
    num_particles_y=32, flip_blend=0.98,
)
SWITCHES = dict(use_fbar=True, pressure_mixing_ratio=0.5, use_penalty_ebc=True)
FIELDS = [f.name for f in dataclasses.fields(fast2d.FluidBuckets)]
GROUPS = {"v": ("v0", "v1"), "C": ("C00", "C01", "C10", "C11"), "J": ("J",)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(switches=()):
    """The same scene in both packages, distributed over N shards."""
    sw = dict(switches)
    p, scene = scenes_jax.dam_break_2d(
        MPMConfig(**_FAST_KW, **sw, transfer=TransferKind.PIC), dtype=np.float32)
    mesh = make_mesh(N)
    spec = fd_jax.FastDomainSpec.for_particles(scene.cfg, N, p, headroom=2.0)
    b = fd_jax.distribute(p, scene.cfg, spec, mesh)
    p_t, scene_t = scenes.dam_break_2d(
        MPMConfig_t(**_FAST_KW, **sw, transfer=TransferKind_t.PIC), dtype=np.float32)
    mesh_t = SlabMesh(N, "cpu")
    spec_t = fd.FastDomainSpec.for_particles(scene_t.cfg, N, p_t, headroom=2.0)
    b_t = fd.distribute(p_t, scene_t.cfg, spec_t, mesh_t)
    return (p, scene, mesh, spec, b), (p_t, scene_t, mesh_t, spec_t, b_t)


@functools.lru_cache(maxsize=None)
def _jax_run(switches, n_substeps):
    _, scene, mesh, spec, b = _setup(switches)[0]
    return fd_jax.make_run(scene, spec, mesh)(b, n_substeps)


def _sorted_xy(host):
    x = np.stack([host["x0"], host["x1"]], axis=-1)
    return x[np.lexsort((x[:, 1], x[:, 0]))]


def _f64(b):
    """The state in float64: the plain versions run in any float dtype."""
    return dataclasses.replace(b, **{f.name: getattr(b, f.name).double()
                                     for f in dataclasses.fields(b)
                                     if getattr(b, f.name).is_floating_point()})


def _assert_state_tracks(got, ref, tol, starts=None, what=""):
    """v, C and J of the live slots in bucket order (the N L rows and the
    single device's G rows list a row's particles alike), each to `tol` of
    its group's largest entry (J: of its largest |J - 1|); from `starts`
    (each run's initial state), the displacement x - x_start too."""
    live = lambda b, names: torch.stack([getattr(b, n)[b.mask > 0] for n in names]).double()
    pairs = {g: (live(got, names), live(ref, names)) for g, names in GROUPS.items()}
    if starts is not None:
        x = ("x0", "x1")
        pairs["displacement"] = (live(got, x) - live(starts[0], x),
                                 live(ref, x) - live(starts[1], x))
    for group, (have, want) in pairs.items():
        scale = float(((want - 1.0) if group == "J" else want).abs().max())
        err = float((have - want).abs().max())
        assert err <= tol * scale, f"{group} {what}: {err:.3e} against {tol} x {scale:.3e}"


def _shard_map(fn, mesh, n_in=1):
    return jax.shard_map(fn, mesh=mesh, in_specs=(P("x"),) * n_in, out_specs=P("x"),
                         check_vma=False)


def test_spec_and_distribute_match_jax():
    (p, scene, mesh, spec, b), (_, _, mesh_t, spec_t, b_t) = _setup()
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(b_t, name).numpy(), np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert b_t.shape == (N * spec.rows_per_shard, spec.capacity)


@pytest.mark.parametrize("gather_only", [False, True], ids=["halo_sync", "gather_only"])
def test_halo_exchange_is_bit_exact(gather_only):
    l = 5
    buf = np.random.default_rng(7).normal(0.0, 1.0, (N, l + 4, 6, 11)).astype(np.float32)
    ctx = fd_jax.FastDomainCtx(axis="x", n=N)
    fn = ctx.halo_gather_only if gather_only else ctx.halo_sync
    want = np.asarray(_shard_map(fn, make_mesh(N))(jnp.asarray(buf.reshape(N * (l + 4), 6, 11))))
    ctx_t = fd.FastDomainCtx(SlabMesh(N, "cpu"), l)
    fn_t = ctx_t.halo_gather_only if gather_only else ctx_t.halo_sync
    got = fn_t(torch.from_numpy(buf.copy())).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    # Edge shards receive zeros: shard 0's bottom halo row, the last
    # shard's top 3.
    assert (got[0, 0] == 0).all() and (got[-1, l + 1 :] == 0).all()


@pytest.mark.parametrize("op", ["shift_left", "shift_right", "psum", "any"])
def test_slab_mesh_collectives_match_jax(op):
    """SlabMesh's collectives on the shard dim against `ppermute` with the
    reference's neighbour permutations and `psum` under shard_map."""
    from mpm_flip98a_tpu.parallel.domain import _perm_left, _perm_right

    x = np.random.default_rng(5).normal(0.0, 1.0, (N, 3, 4)).astype(np.float32)
    if op == "any":
        x = (x > 1.8).astype(np.float32)
    jax_fn = {
        "shift_left": lambda a: jax.lax.ppermute(a, "x", _perm_left(N)),
        "shift_right": lambda a: jax.lax.ppermute(a, "x", _perm_right(N)),
        "psum": lambda a: jax.lax.psum(a, "x"),
        "any": lambda a: (jax.lax.psum(a, "x") > 0).astype(a.dtype),
    }[op]
    want = np.asarray(_shard_map(jax_fn, make_mesh(N))(jnp.asarray(x.reshape(N * 3, 4))))
    got = getattr(SlabMesh(N, "cpu"), op)(torch.from_numpy(x)).numpy()
    if op.startswith("shift"):
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    else:   # a reduction: every shard of the JAX result holds it
        for s in range(N):
            np.testing.assert_allclose(got.astype(np.float32), want.reshape(N, 3, 4)[s],
                                       rtol=1e-6, atol=1e-6)


def _with_movers(b, seed):
    """x0 of random active slots moved by up to +-1.3 cells: movers both
    ways across every slab edge, in numpy for both packages."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(b.x0).copy()
    act = np.asarray(b.mask) > 0
    shift = rng.uniform(-1.3, 1.3, x0.shape) * (0.4375 / 32) * (rng.random(x0.shape) < 0.5)
    return np.where(act, x0 + shift, x0).astype(np.float32)


@pytest.mark.parametrize("mig_cap", [None, 3], ids=["fits", "forced_overflow"])
def test_rebucket_migrate_is_bit_exact(mig_cap):
    (_, scene, mesh, spec, b), (_, scene_t, mesh_t, spec_t, b_t) = _setup()
    if mig_cap is not None:
        spec = dataclasses.replace(spec, mig_cap=mig_cap)
        spec_t = dataclasses.replace(spec_t, mig_cap=mig_cap)
    x0 = _with_movers(b, seed=11)
    b = dataclasses.replace(b, x0=jnp.asarray(x0))
    b_t = dataclasses.replace(b_t, x0=torch.from_numpy(x0))
    in_spec = fast2d_jax.FluidBuckets(**{f: P("x") for f in FIELDS})
    want = jax.jit(jax.shard_map(
        lambda bl: fd_jax.rebucket_migrate(bl, scene, spec, "x"), mesh=mesh,
        in_specs=(in_spec,), out_specs=in_spec, check_vma=False))(b)
    got = fd.rebucket_migrate(b_t, scene_t, spec_t, mesh_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    ovf = got.overflow.numpy()
    moved = (np.asarray(want.mask).reshape(N, -1) > 0).sum(1) != \
        (np.asarray(b.mask).reshape(N, -1) > 0).sum(1)
    assert moved.any()                           # slots changed shards
    if mig_cap is None:
        assert (ovf == 0).all()
        assert int(got.mask.sum()) == int(b_t.mask.sum())
    else:
        assert ovf.sum() > 0                     # dropped movers are counted
        assert int(got.mask.sum()) + int(ovf.sum()) == int(b_t.mask.sum())


def test_sharded_run_matches_jax_over_100_substeps():
    (p, _, _, spec, _), (_, scene_t, mesh_t, spec_t, b_t) = _setup()
    want = _jax_run((), 100)
    stats = fast2d.RunStats()
    got = fd.make_run(scene_t, spec_t, mesh_t)(b_t, 100, stats)
    assert stats.substeps == stats.host_reads == 100
    h, hj = fast2d.to_host(got), fast2d_jax.to_host(want)
    assert h["x0"].shape == hj["x0"].shape == (p.n,)
    np.testing.assert_allclose(_sorted_xy(h), _sorted_xy(hj), atol=1e-5)
    # The layouts match slot for slot: same buckets, same positions.
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0), atol=1e-5)
    assert int(got.overflow.sum()) == 0


def test_switch_matrix_matches_jax_over_50_substeps():
    """Penalty EBC + F-bar + pressure mixing through the sharded path."""
    sw = tuple(SWITCHES.items())
    _, (_, scene_t, mesh_t, spec_t, b_t) = _setup(sw)
    assert not fast2d.uses_fused(scene_t)
    want = _jax_run(sw, 50)
    got = fd.make_run(scene_t, spec_t, mesh_t)(b_t, 50)
    # Slot for slot (the layouts match; a sort by x0 pairs up lattice
    # neighbours whose x0 agree to the last bit in either order).
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for name in ("x0", "x1", "J"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    assert int(got.overflow.sum()) == 0


@pytest.mark.parametrize("switches", [(), tuple(SWITCHES.items())], ids=["fused", "prepped"])
def test_one_substep_matches_the_single_device_port(switches):
    """The same scene on one device (fast2d.run) and on N shards: one
    substep to 1e-7 in x and v, C, J slot for slot to 1e-6 of their scale;
    then 20 substeps in float64 through the plain versions, where v, C, J
    and the displacement agree to 1e-9 of their scale (read: 2e-11; in
    float32 the displacement is a few ulps of x)."""
    _, (p_t, scene_t, mesh_t, spec_t, b_t) = _setup(switches)
    spec1 = fast2d.FastSpec.for_particles(scene_t.cfg, p_t, headroom=2.0)
    b1 = fast2d.from_particles(p_t, scene_t.cfg, spec1, device="cpu")
    ref = fast2d.run(b1, scene_t, spec1, 1)
    run = fd.make_run(scene_t, spec_t, mesh_t)
    got = run(b_t, 1)
    h, hr = fast2d.to_host(got), fast2d.to_host(ref)
    np.testing.assert_allclose(_sorted_xy(h), _sorted_xy(hr), atol=1e-7)
    np.testing.assert_allclose(np.sort(h["v1"]), np.sort(hr["v1"]), atol=1e-4)
    _assert_state_tracks(got, ref, 1e-6, what="after 1 substep")
    starts = (_f64(b_t), _f64(b1))
    got = run(starts[0], 20, plain=True)
    ref = fast2d.run(starts[1], scene_t, spec1, 20, plain=True)
    assert got.v0.dtype == torch.float64 and int(got.overflow.sum()) == 0
    _assert_state_tracks(got, ref, 1e-9, starts, what="after 20 float64 substeps")


def test_halo_rows_carry_the_neighbours_sums():
    """After the exchange every shard's L + 4 rows hold the global grid's
    rows s L - 1 .. s L + L + 2: the single-device fold of the same state."""
    _, (p_t, scene_t, mesh_t, spec_t, b_t) = _setup()
    ctx = fd.FastDomainCtx(mesh_t, spec_t.rows_per_shard)
    data, _, counts = fast2d.transfer_inputs(b_t, scene_t, ctx)
    synced = ctx.halo_sync(tk.p2g_grid(data, counts, fused=True, raw=True, shards=N,
                                          **fast2d.p2g_args(scene_t)))
    data1, _, counts1 = fast2d.transfer_inputs(b_t, scene_t)
    full = tk.fold_rows_halo(tk.p2g_fused(data1, counts1, **fast2d.p2g_args(scene_t)))
    l = spec_t.rows_per_shard
    for s in range(N):
        np.testing.assert_allclose(synced[s].numpy(), full[s * l : s * l + l + 4].numpy(),
                                   rtol=0, atol=1e-6 * float(full.abs().max()))


def test_two_axis_and_small_slabs_raise():
    p_t, scene_t = scenes.dam_break_2d(
        MPMConfig_t(**_FAST_KW, transfer=TransferKind_t.PIC), dtype=np.float32)
    with pytest.raises(ValueError, match="at least 4 rows"):
        fd.FastDomainSpec.for_particles(scene_t.cfg, 16, p_t)
    spec = fd.FastDomainSpec.for_particles(scene_t.cfg, 4, p_t)
    with pytest.raises(ValueError, match="shards"):
        fd.distribute(p_t, scene_t.cfg, spec, SlabMesh(8, "cpu"))
