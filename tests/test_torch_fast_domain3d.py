"""The port's one-axis slab-sharded 3D fast path against the JAX package.

`p2g3d_grid`'s raw mode (the scatter alone, into each shard's raw halo
sums) against the JAX kernel in Pallas interpret mode, one cached call per
mode at 8^3; the axis-0 halo exchange and the migration bit-exact against
JAX `fast_domain3d` under `shard_map` on the virtual 8-device CPU mesh; the
sharded run against the port's single-device `fast3d`, which
tests/test_torch_stabilized3d.py holds to JAX.  (A run of JAX
`fast_domain3d.make_run` costs 25-30 s of compilation here even at 8^3
and one substep, past this file's share of the suite's time.)  The
port's shards are a leading tensor dimension on one device
(`parallel.SlabMesh`).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.ops.pallas import transfer3d as tk3_jax
from mpm_flip98a_tpu.parallel import fast_domain3d as fd3_jax
from mpm_flip98a_tpu.parallel import make_mesh
from mpm_flip98a_tpu_torch.config import TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3
from mpm_flip98a_tpu_torch.parallel import SlabMesh
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

R, K, G = 8, 128, 8
DX = 0.4375 / 3
FLUID = dict(kb=2.0e5, mu=1e-3, gamma=7.0, fa=-2e-5 * 4.0 / DX**2)
REL = 1e-6
MODES = {   # name: (stress, apic, ext, tent)
    "stress_tait": ("tait", True, False, False),
    "pic11": (None, False, True, False),
    "apic7_tent": (None, True, False, True),
}
SMALL = dict(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, dtype=np.float32)
STAB = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0, flip_blend=0.98)
FIELDS = [f.name for f in dataclasses.fields(fast3d.FluidBuckets3D)]
GROUPS = {"v": ("v0", "v1", "v2"), "C": tuple(f"C{a}{c}" for a in range(3) for c in range(3)),
          "J": ("J",)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(b):
    """The state in float64: the plain versions run in any float dtype."""
    return dataclasses.replace(b, **{f.name: getattr(b, f.name).double()
                                     for f in dataclasses.fields(b)
                                     if getattr(b, f.name).is_floating_point()})


def _assert_state_tracks(got, ref, tol, start=None, what=""):
    """v, C and J slot for slot, each to `tol` of its group's largest entry
    (J: of its largest |J - 1|); from a shared `start`, the displacement
    x - x_start too.  (In float32 the displacement after a few substeps is
    a few ulps of x, which no tolerance on x can hold.)"""
    np.testing.assert_array_equal(got.mask.numpy(), ref.mask.numpy())
    stack = lambda b, names: torch.stack([getattr(b, n) for n in names]).double()
    pairs = {g: (stack(got, names), stack(ref, names)) for g, names in GROUPS.items()}
    if start is not None:
        x = ("x0", "x1", "x2")
        pairs["displacement"] = (stack(got, x) - stack(start, x), stack(ref, x) - stack(start, x))
    for group, (have, want) in pairs.items():
        scale = float(((want - 1.0) if group == "J" else want).abs().max())
        err = float((have - want).abs().max())
        assert err <= tol * scale, f"{group} {what}: {err:.3e} against {tol} x {scale:.3e}"


@functools.lru_cache(maxsize=None)
def _fields(mode):
    """Random pencil slots: ragged counts, slots outside the margin on both
    bucketed axes, z past both edges; the mode's planes, masked."""
    stress, apic, ext, _ = MODES[mode]
    rng = np.random.default_rng(len(mode))
    counts = rng.integers(0, K + 1, (R, R))
    counts[0, :2] = 0
    counts[3, 3] = K
    rel0 = rng.choice([-1, 0, 0, 1, -2, 2], size=(R, R, K))
    rel1 = rng.choice([-1, 0, 0, 1, 2], size=(R, R, K))
    gx0 = np.arange(R)[:, None, None] + rel0 + 0.5 + rng.random((R, R, K))
    gx1 = np.arange(R)[None, :, None] + rel1 + 0.5 + rng.random((R, R, K))
    gx2 = rng.uniform(-1.0, G + 1.0, (R, R, K))
    live = np.arange(K) < counts[..., None]
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, R, K)), 0.0)
    if stress is not None:    # [gx (3), v (3), C (9), J, mass, vol0]
        vals = [*rng.normal(0.0, 1.0, (3, R, R, K)), *rng.normal(0.0, 5.0, (9, R, R, K)),
                np.where(live, rng.uniform(0.97, 1.03, (R, R, K)), 1.0), mass, mass / 1000.0]
    else:                     # [gx (3), m v (3), P (9, APIC), Q (9), m (, ext 4)]
        n_val = tk3.n_prepped(apic, ext) - 3
        vals = [a * live for a in rng.normal(0.0, 2.0, (n_val, R, R, K))]
        vals[n_val - 1 - (4 if ext else 0)] = mass
    planes = [np.asarray(a, np.float32) for a in (gx0, gx1, gx2, *vals)]
    return planes, counts.reshape(-1).astype(np.int32)


def _mode_kw(mode):
    stress, apic, ext, tent = MODES[mode]
    kw = dict(apic=apic, stress=stress, ext=ext, tent=tent)
    return {**kw, **FLUID} if stress else kw


@functools.lru_cache(maxsize=None)
def _jax_raw(mode):
    planes, counts = _fields(mode)
    return np.array(tk3_jax.p2g3d_grid(
        tuple(map(jnp.asarray, planes)), jnp.asarray(counts), R, G, DX, raw=True,
        **_mode_kw(mode)))


@pytest.mark.parametrize("mode", list(MODES))
def test_p2g3d_grid_raw_matches_jax(mode):
    """Raw sums to 1e-6 of each channel's max (fp32 sums in another
    order), uncropped on both axes; the same from the plain version."""
    planes, counts = _fields(mode)
    want = _jax_raw(mode)
    args = (tuple(map(torch.from_numpy, planes)), torch.from_numpy(counts), R, G, DX)
    got = tk3.p2g3d_grid(*args, raw=True, **_mode_kw(mode)).numpy()
    nch = want.shape[2]
    assert got.shape == (1, R + 4, R + 4, nch, G) and want.shape == (R + 4, R + 4, nch, G)
    for ch in range(nch):
        scale = float(np.abs(want[:, :, ch]).max())
        assert np.abs(got[0, :, :, ch] - want[:, :, ch]).max() <= REL * scale, ch
    np.testing.assert_array_equal(
        got[0], tk3.p2g3d_raw_plain(*args[:2], G, DX, **_mode_kw(mode)).numpy())
    # The axis-0 pad rows keep their sums (the non-raw mode zeroes them).
    assert np.abs(got[0, 0]).sum() > 0 and np.abs(got[0, R + 1 :]).sum() > 0
    assert tk3.LAUNCHES["p2g3d_grid"] == 0


def test_p2g3d_grid_raw_splits_into_shards():
    """shards = 2: each half of the axis-0 rows, gx0 local to it, is the
    raw mode of that half alone."""
    planes, counts = _fields("pic11")
    half = R // 2
    local = [p.copy() for p in planes]
    local[0][half:] -= half
    t = tuple(map(torch.from_numpy, local))
    got = tk3.p2g3d_grid(t, torch.from_numpy(counts), R, G, DX, raw=True, shards=2,
                         **_mode_kw("pic11")).numpy()
    assert got.shape == (2, half + 4, R + 4, 11, G)
    for s in range(2):
        part = tuple(p[s * half : (s + 1) * half] for p in t)
        want = tk3.p2g3d_grid(part, torch.from_numpy(counts[s * half * R : (s + 1) * half * R]),
                              R, G, DX, raw=True, **_mode_kw("pic11")).numpy()
        np.testing.assert_array_equal(got[s], want[0])
    with pytest.raises(ValueError):       # shards split the raw mode only
        tk3.p2g3d_grid(t, torch.from_numpy(counts), R, G, DX, shards=2, dt=2e-5,
                       grav=(0.0, 0.0, -9.8), floor=1e-9, lo=2, hi=G - 3, wall="slip",
                       **_mode_kw("pic11"))


@pytest.mark.parametrize("n", [2, 4])
def test_halo_sync_is_bit_exact(n):
    l0 = 4
    buf = np.random.default_rng(n).normal(0.0, 1.0, (n, l0 + 4, 7, 3, 5)).astype(np.float32)
    ctx = fd3_jax.FastDomain3DCtx(axis0="x", n0=n)
    want = np.asarray(jax.shard_map(
        ctx.halo_sync, mesh=make_mesh(n), in_specs=(P("x"),), out_specs=P("x"),
        check_vma=False)(jnp.asarray(buf.reshape(n * (l0 + 4), 7, 3, 5))))
    got = fd3.FastDomain3DCtx(SlabMesh(n, "cpu"), l0, rows1=3).halo_sync(
        torch.from_numpy(buf.copy())).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@functools.lru_cache(maxsize=None)
def _setup(n, switches=()):
    """The same 16^3 dam break in both packages, on n slab shards."""
    sw = dict(switches)
    kw = dict(sw, transfer=TransferKind.PIC) if sw else {}
    p_t, scene_t = scenes.dam_break_3d(**SMALL, **kw)
    mesh_t = SlabMesh(n, "cpu")
    spec_t = fd3.FastDomain3DSpec.for_particles(scene_t.cfg, n, p_t)
    return p_t, scene_t, mesh_t, spec_t, fd3.distribute(p_t, scene_t.cfg, spec_t, mesh_t)


@functools.lru_cache(maxsize=None)
def _jax_setup(n):
    p, scene = scenes_jax.dam_break_3d(**SMALL)
    mesh = make_mesh(n)
    spec = fd3_jax.FastDomain3DSpec.for_particles(scene.cfg, n, p)
    return scene, mesh, spec, fd3_jax.distribute(p, scene.cfg, spec, mesh)


def test_spec_and_distribute_match_jax():
    """The port's spec is the JAX one's, the one-axis constants n_shards1 =
    1 and rows_per_shard1 = G included."""
    scene, mesh, spec, b = _jax_setup(4)
    _, _, _, spec_t, b_t = _setup(4)
    want = dataclasses.asdict(spec)
    assert (want["n_shards1"], want["rows_per_shard1"]) == (1, SMALL["num_grids"])
    assert want == dataclasses.asdict(spec_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(b_t, name).numpy(), np.asarray(getattr(b, name)),
                                      err_msg=name)


@pytest.mark.parametrize("mig_cap", [None, 2], ids=["fits", "forced_overflow"])
def test_rebucket_migrate_is_bit_exact(mig_cap):
    scene, mesh, spec, b = _jax_setup(4)
    _, scene_t, mesh_t, spec_t, b_t = _setup(4)
    if mig_cap is not None:
        spec = dataclasses.replace(spec, mig_cap=mig_cap)
        spec_t = dataclasses.replace(spec_t, mig_cap=mig_cap)
    rng = np.random.default_rng(3)
    x0 = np.asarray(b.x0)
    moved = rng.uniform(-1.3, 1.3, x0.shape) * float(scene.cfg.dx) * (rng.random(x0.shape) < 0.5)
    x0 = np.where(np.asarray(b.mask) > 0, x0 + moved, x0).astype(np.float32)
    b = dataclasses.replace(b, x0=jnp.asarray(x0))
    b_t = dataclasses.replace(b_t, x0=torch.from_numpy(x0))
    in_spec = fast3d_jax.FluidBuckets3D(**{f: P("x") for f in FIELDS})
    want = jax.jit(jax.shard_map(
        lambda bl: fd3_jax.rebucket_migrate(bl, scene, spec, "x"), mesh=mesh,
        in_specs=(in_spec,), out_specs=in_spec, check_vma=False))(b)
    got = fd3.rebucket_migrate(b_t, scene_t, spec_t, mesh_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    ovf = got.overflow.numpy()
    before = (np.asarray(b.mask).reshape(4, -1) > 0).sum(1)
    assert ((np.asarray(want.mask).reshape(4, -1) > 0).sum(1) != before).any()
    assert (ovf == 0).all() if mig_cap is None else ovf.sum() > 0
    assert int(got.mask.sum()) + int(ovf.sum()) == int(before.sum())


@pytest.mark.parametrize("n,switches", [
    (2, ()), (4, ()), (4, tuple(STAB.items())),
], ids=["2_fused", "4_fused", "4_stabilized"])
def test_sharded_run_tracks_the_single_device_port(n, switches):
    """n L0 = 16 = G: the sharded and single-device layouts are the same,
    so the runs compare slot for slot: x after 1 substep to 1e-7 and after
    20 to 1e-5; v, C and J after 1 substep to 1e-6 of their scale.  Past
    that, float32 cannot hold the two runs together (F-bar's nodal Jbar is
    1 less a few ulps, so the halo sums' other order moves the pressure by
    parts in 1e5), so 20 substeps run again in float64 through the plain
    versions, where v, C, J and the displacement agree to 1e-6 of their
    scale: the residue (read: 2e-7) is the slab origin's float32 rounding,
    which the reference shifts x0 by (fast3d.py:518-527)."""
    p_t, scene_t, mesh_t, spec_t, b_t = _setup(n, switches)
    assert fast3d.uses_fused(scene_t) == (not switches)
    spec1 = fast3d.FastSpec3D.for_particles(scene_t.cfg, p_t, headroom=2.0)
    assert spec1 == spec_t.global_spec
    b1 = fast3d.from_particles(p_t, scene_t.cfg, spec1, device="cpu")
    run = fd3.make_run(scene_t, spec_t, mesh_t)
    for steps, tol in ((1, 1e-7), (20, 1e-5)):
        stats = fast2d.RunStats()
        got = run(b_t, steps, stats)
        ref = fast3d.run(b1, scene_t, spec1, steps)
        assert stats.substeps == steps and int(got.overflow.sum()) == 0
        np.testing.assert_array_equal(got.mask.numpy(), ref.mask.numpy())
        for name in ("x0", "x1", "x2"):
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(ref, name).numpy(),
                                       atol=tol, err_msg=f"{name} after {steps}")
        if steps == 1:
            _assert_state_tracks(got, ref, 1e-6, what="after 1 substep")
    b64 = _f64(b_t)
    got = run(b64, 20, plain=True)
    ref = fast3d.run(_f64(b1), scene_t, spec1, 20, plain=True)
    assert got.v0.dtype == torch.float64 and int(got.overflow.sum()) == 0
    _assert_state_tracks(got, ref, 1e-6, start=b64, what="after 20 float64 substeps")


def test_two_axis_and_relative_floor_routes():
    p_t, scene_t, mesh_t, spec_t, b_t = _setup(2)
    # The two-axis spec (tests/test_torch_fast_domain3d_2axis.py runs it):
    # 2 x 2 windows of 8 x 8 pencils; one axis is its n1 = 1 case.
    spec2 = fd3.FastDomain3DSpec.for_particles(scene_t.cfg, (2, 2), p_t)
    assert (spec2.n_shards, spec2.rows_per_shard0, spec2.rows_per_shard1) == (4, 8, 8)
    assert spec2.global_spec == dataclasses.replace(spec2.local_spec, rows0=32)
    assert fd3.FastDomain3DSpec.for_particles(scene_t.cfg, (2, 1), p_t) == spec_t
    with pytest.raises(ValueError, match="at least 4 rows"):
        fd3.FastDomain3DSpec.for_particles(scene_t.cfg, (2, 6), p_t)
    # The fused branch with the relative floor: no single-device route (the
    # reference's raises), but slab shards run it, the floor per shard.
    rel = dataclasses.replace(scene_t, mass_floor=0.0)
    with pytest.raises(NotImplementedError, match="relative mass floor.*ROADMAP"):
        fast3d.check_supported(rel)
    got = fd3.make_run(rel, spec_t, mesh_t)(b_t, 2)
    ref = fd3.make_run(scene_t, spec_t, mesh_t)(b_t, 2)
    np.testing.assert_allclose(got.x2.numpy(), ref.x2.numpy(), atol=1e-7)
    _assert_state_tracks(got, ref, 1e-6, what="relative against absolute floor")
