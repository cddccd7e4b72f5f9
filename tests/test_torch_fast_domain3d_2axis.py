"""The port's two-axis 3D mesh (`--devices N0xN1`) against the JAX package.

The shard-major reorder (`distribute`), the two-axis halo exchange and the
two-leg migration are held bit for bit to JAX `fast_domain3d` under
`shard_map` on the conftest's 8-device CPU mesh (`make_mesh2`).  The
two-axis run is held to the port's single-device `fast3d.run`, which
tests/test_torch_stabilized3d.py holds to JAX: a JAX 3D `make_run` costs
25-30 s of compilation here even at 16^3 and one substep, past this
file's share of the suite's time.  With n0 L0 = n1 L1 = G the global
layout (`to_global`) is the single-device one, so the runs compare slot
for slot.  The shards are a leading tensor dimension on one device
(`parallel.SlabMesh(n0, device, n1)`).
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
from mpm_flip98a_tpu.parallel import fast_domain3d as fd3_jax
from mpm_flip98a_tpu.parallel import make_mesh2
from mpm_flip98a_tpu_torch.config import TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes
from mpm_flip98a_tpu_torch.parallel import SlabMesh
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

SMALL = dict(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, dtype=np.float32)
STAB = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0, flip_blend=0.98,
            transfer=TransferKind.PIC)
INCOMP = dict(incompressible=True, flip_blend=0.98, transfer=TransferKind.PIC)
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
    return dataclasses.replace(b, **{f.name: getattr(b, f.name).double()
                                     for f in dataclasses.fields(b)
                                     if getattr(b, f.name).is_floating_point()})


def _errors(got, ref, start=None):
    """The largest difference of v, C, J (J: of J - 1) and, from a shared
    `start`, the displacement, each over its group's scale."""
    stack = lambda b, names: torch.stack([getattr(b, n) for n in names]).double()
    pairs = {g: (stack(got, names), stack(ref, names)) for g, names in GROUPS.items()}
    if start is not None:
        x = ("x0", "x1", "x2")
        pairs["displacement"] = (stack(got, x) - stack(start, x), stack(ref, x) - stack(start, x))
    out = {}
    for group, (have, want) in pairs.items():
        scale = float(((want - 1.0) if group == "J" else want).abs().max())
        out[group] = float((have - want).abs().max()) / max(scale, 1e-30)
    return out


def _assert_tracks(got, ref, tol, start=None, what=""):
    np.testing.assert_array_equal(got.mask.numpy(), ref.mask.numpy())
    for group, err in _errors(got, ref, start).items():
        assert err <= tol, f"{group} {what}: {err:.3e} of its scale against {tol}"


@functools.lru_cache(maxsize=None)
def _setup(shards, switches=(), scene_fn="dam_break_3d"):
    """A 16^3 scene on an n0 x n1 mesh and on one device, same particles."""
    if scene_fn == "dam_break_3d":
        p, scene = scenes.dam_break_3d(**SMALL, **dict(switches))
    else:
        p, scene = scenes.elastic_drop_3d()
    mesh = SlabMesh(shards[0], "cpu", shards[1])
    spec = fd3.FastDomain3DSpec.for_particles(scene.cfg, shards, p)
    spec1 = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b1 = fast3d.from_particles(p, scene.cfg, spec1, device="cpu")
    return p, scene, mesh, spec, fd3.distribute(p, scene.cfg, spec, mesh), spec1, b1


@functools.lru_cache(maxsize=None)
def _jax_setup(shards):
    p, scene = scenes_jax.dam_break_3d(**SMALL)
    mesh = make_mesh2(*shards)
    spec = fd3_jax.FastDomain3DSpec.for_particles(scene.cfg, shards, p)
    return scene, mesh, spec, fd3_jax.distribute(p, scene.cfg, spec, mesh)


@pytest.mark.parametrize("shards", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_spec_and_distribute_match_jax(shards):
    """The spec is JAX's; every field of the shard-major (s0, s1, l0, l1)
    state is bitwise JAX's, and `to_global` undoes the reorder into the
    global (n0 L0, n1 L1) bucketing."""
    _, _, spec, b = _jax_setup(shards)
    p, scene, _, spec_t, b_t, _, _ = _setup(shards)
    assert dataclasses.asdict(spec) == dataclasses.asdict(spec_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(b_t, name).numpy(), np.asarray(getattr(b, name)),
                                      err_msg=name)
    flat = fast3d.from_particles(p, scene.cfg, spec_t.bucket_spec, device="cpu")
    back = fd3.to_global(b_t, spec_t)
    for name in FIELDS[:-1]:
        assert torch.equal(getattr(back, name), getattr(flat, name)), name
    assert b_t.overflow.shape == (spec_t.n_shards,)


def _halo_buffer(shards, seed):
    n0, n1 = shards
    l0, l1 = 4, 5
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (n0 * n1, l0 + 4, l1 + 4, 3, 2)).astype(np.float32)


@pytest.mark.parametrize("shards", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("op", ["halo_sync", "halo_gather_only"])
def test_halo_exchange_is_bit_exact(shards, op):
    """Axis 0, then axis 1 (its legs move whole planes with the axis-1 halo
    columns) against JAX under shard_map on a two-axis mesh."""
    n0, n1 = shards
    buf = _halo_buffer(shards, n0 * 10 + n1)
    ctx = fd3_jax.FastDomain3DCtx(axis0="x", n0=n0, axis1="y", n1=n1)
    spec = P(("x", "y"))
    want = np.asarray(jax.shard_map(
        getattr(ctx, op), mesh=make_mesh2(n0, n1), in_specs=(spec,), out_specs=spec,
        check_vma=False)(jnp.asarray(buf.reshape(-1, *buf.shape[2:]))))
    got = getattr(fd3.FastDomain3DCtx(SlabMesh(n0, "cpu", n1), 4, rows1=5), op)(
        torch.from_numpy(buf.copy())).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_halo_sync_completes_a_planted_corner():
    """A partial sum planted in shard (0, 0)'s corner halo cell (target
    rows L0, L1: the diagonal shard (1, 1)'s first owned node) reaches
    that node through the axis-0 and then the axis-1 leg, and comes back
    into the halo copies of all four shards."""
    l0, l1 = 4, 5
    ctx = fd3.FastDomain3DCtx(SlabMesh(2, "cpu", 2), l0, rows1=l1)
    buf = torch.zeros((4, l0 + 4, l1 + 4, 1, 1))
    buf[0, l0 + 1, l1 + 1] = 3.0          # shard (0, 0), plane row/column j = target j - 1
    buf[3, 1, 1] = 0.5                    # shard (1, 1)'s own partial sum there
    out = ctx.halo_sync(buf)
    own = ctx.own_rows("cpu")
    assert float(out[3, 1, 1]) == 3.5
    assert float((out[..., 0, 0] * own).sum()) == 3.5      # counted once, by its owner
    for s, (r, c) in {0: (l0 + 1, l1 + 1), 1: (l0 + 1, 1), 2: (1, l1 + 1), 3: (1, 1)}.items():
        assert float(out[s, r, c]) == 3.5, s
    assert int((out != 0).sum()) == 4


@pytest.mark.parametrize("mig_cap", [None, 2], ids=["fits", "forced_overflow"])
def test_rebucket_migrate_is_bit_exact(mig_cap):
    """Slots moved up to 1.3 cells on both bucketed axes: the axis-0 leg,
    the axis-1 leg and the re-sort bitwise JAX's, overflow counted."""
    scene, mesh, spec, b = _jax_setup((2, 4))
    _, scene_t, mesh_t, spec_t, b_t, _, _ = _setup((2, 4))
    if mig_cap is not None:
        spec = dataclasses.replace(spec, mig_cap=mig_cap)
        spec_t = dataclasses.replace(spec_t, mig_cap=mig_cap)
    rng = np.random.default_rng(5)
    on = np.asarray(b.mask) > 0
    moved = {}
    for name, lift in (("x0", 3.0), ("x1", 0.0)):
        # The block spans bucket rows 2.7-5.0 on both axes: 3 cells up on
        # axis 0 it meets the axis-0 window edge (row 8) as it meets the
        # axis-1 one (row 4).
        x = np.asarray(getattr(b, name))
        step = rng.uniform(-1.3, 1.3, x.shape) * (rng.random(x.shape) < 0.5) + lift
        moved[name] = np.where(on, x + step * float(scene.cfg.dx), x).astype(np.float32)
    b = dataclasses.replace(b, **{k: jnp.asarray(v) for k, v in moved.items()})
    b_t = dataclasses.replace(b_t, **{k: torch.from_numpy(v) for k, v in moved.items()})
    pspec = P(("x", "y"))
    in_spec = fast3d_jax.FluidBuckets3D(**{f: pspec for f in FIELDS})
    want = jax.jit(jax.shard_map(
        lambda bl: fd3_jax.rebucket_migrate(bl, scene, spec, "x", "y"), mesh=mesh,
        in_specs=(in_spec,), out_specs=in_spec, check_vma=False))(b)
    got = fd3.rebucket_migrate(b_t, scene_t, spec_t, mesh_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    before = on.reshape(8, -1).sum(1)
    assert ((np.asarray(want.mask).reshape(8, -1) > 0).sum(1) != before).any()
    ovf = got.overflow.numpy()
    assert (ovf == 0).all() if mig_cap is None else ovf.sum() > 0
    assert int(got.mask.sum()) + int(ovf.sum()) == int(before.sum())


RUNS = {
    "dam3d_2x2": ((2, 2), (), "dam_break_3d"),
    "dam3d_2x4": ((2, 4), (), "dam_break_3d"),
    "elastic_drop_2x2": ((2, 2), (), "elastic_drop_3d"),
    "stabilized_2x2": ((2, 2), tuple(STAB.items()), "dam_break_3d"),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_two_axis_run_tracks_the_single_device_port(case):
    """Slot for slot against one device: x after 1 substep to 1e-7 and
    after 20 to 1e-5, v, C and J after 1 substep to 1e-6 of their scale
    (the one-axis bounds, tests/test_torch_fast_domain3d.py); then 20
    float64 substeps through the plain versions, v, C, J and the
    displacement to 1e-6 of their scale (the windows' float32 origins)."""
    shards, switches, scene_fn = RUNS[case]
    _, scene, mesh, spec, b, spec1, b1 = _setup(shards, switches, scene_fn)
    run = fd3.make_run(scene, spec, mesh)
    for steps, tol in ((1, 1e-7), (20, 1e-5)):
        stats = fast2d.RunStats()
        got = run(b, steps, stats)
        ref = fast3d.run(b1, scene, spec1, steps)
        assert stats.substeps == steps and int(got.overflow.sum()) == 0
        got = fd3.to_global(got, spec)
        np.testing.assert_array_equal(got.mask.numpy(), ref.mask.numpy())
        for name in ("x0", "x1", "x2"):
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(ref, name).numpy(),
                                       atol=tol, err_msg=f"{name} after {steps}")
        if steps == 1:
            _assert_tracks(got, ref, 1e-6, what="after 1 substep")
    got = fd3.to_global(run(_f64(b), 20, plain=True), spec)
    ref = fast3d.run(_f64(b1), scene, spec1, 20, plain=True)
    assert got.v0.dtype == torch.float64
    _assert_tracks(got, ref, 1e-6, start=_f64(b1), what="after 20 float64 substeps")


def test_two_axis_migrating_run():
    """A diagonal 6 m/s throw (tests/test_parallel_fast_domain3d.py:120-142):
    slots cross both window boundaries, corner crossers reach the diagonal
    shard through the two legs; 60 substeps at dt 2e-4 with overflow 0 and
    the ensemble within 5e-4 of one device."""
    p, scene = scenes.dam_break_3d(**SMALL)
    v = torch.zeros_like(p.v)
    v[:, 0], v[:, 1] = 6.0, 6.0
    # 3 cells up on axis 0, so the 1.8-cell drift crosses both window
    # edges (bucket rows 8 and 4) and some slots reach the diagonal shard.
    x = p.x.clone()
    x[:, 0] += 3.0 * float(scene.cfg.dx)
    p = dataclasses.replace(p, x=x, v=v)
    scene = dataclasses.replace(scene, cfg=dataclasses.replace(scene.cfg, dt=2e-4))
    mesh = SlabMesh(2, "cpu", 4)
    spec = fd3.FastDomain3DSpec.for_particles(scene.cfg, (2, 4), p)
    b = fd3.distribute(p, scene.cfg, spec, mesh)
    stats = fast2d.RunStats()
    out = fd3.make_run(scene, spec, mesh)(b, 60, stats)
    spec1 = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    ref = fast3d.run(fast3d.from_particles(p, scene.cfg, spec1, device="cpu"), scene, spec1, 60)
    assert int(out.overflow.sum()) == 0 and stats.rebuckets > 0
    live = lambda s: (s.mask > 0).reshape(8, -1).sum(1)
    assert int(live(out).sum()) == p.n and (live(out) != live(b)).any()
    assert int(live(b)[5]) == 0 and int(live(out)[5]) > 0       # shard (1, 1) filled
    pos = lambda s: torch.stack([getattr(s, n)[s.mask > 0] for n in ("x0", "x1", "x2")], 1)
    x, xr = pos(out), pos(ref)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.mean(0).numpy(), xr.mean(0).numpy(), atol=5e-4)
    np.testing.assert_allclose(x.std(0).numpy(), xr.std(0).numpy(), atol=5e-4)


def _stale_axis1_halo(monkeypatch):
    """Leave shard column s1 = 1's lower axis-1 halo column stale in every
    halo refresh of the grid-side chains."""
    real = fd3.FastDomain3DCtx.halo_gather_only

    def faulty(self, buf):
        old = buf[self.mesh.shard_index(1) == 1, :, 0].clone()
        out = real(self, buf)
        out[self.mesh.shard_index(1) == 1, :, 0] = old
        return out

    monkeypatch.setattr(fd3.FastDomain3DCtx, "halo_gather_only", faulty)


@pytest.mark.parametrize("shards,fault", [((2, 2), False), ((2, 4), False), ((2, 4), True)],
                         ids=["2x2", "2x4", "2x4_stale_axis1_halo"])
def test_projection_two_axis_matches_single(shards, fault, monkeypatch):
    """The incompressible projection on two-axis windows: the CG's dot
    products count each node once (own rows on both axes, then every
    shard), and one substep tracks one device to 1e-4 of the scale of v
    and C (an unconverged CG carries its dot products' rounding); a stale
    axis-1 halo column in the CG's refreshes reads above that bound (on 2
    x 4, where the water crosses the axis-1 window edge)."""
    _, scene, mesh, spec, b, spec1, b1 = _setup(shards, tuple(INCOMP.items()))
    ref = fast3d.run(b1, scene, spec1, 1)
    if fault:
        _stale_axis1_halo(monkeypatch)
    got = fd3.to_global(fd3.make_run(scene, spec, mesh)(b, 1), spec)
    err = _errors(got, ref)
    worst = max(err["v"], err["C"])
    assert (worst > 1e-4) if fault else (worst <= 1e-4), err
