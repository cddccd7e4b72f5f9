"""The CUDA transfer kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels are built from
mpm_flip98a_tpu_torch/csrc at first use); without a card they skip.  They
import no JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: per output channel, 1e-5 of the channel's max.  Both sides sum
each node's fp32 terms in another order (a fixed order of its own in each
P2G kernel, atomics in the plain `index_add_` on the card, FMA contraction
in the kernels).  Every P2G kernel's reruns are bitwise equal.  The 3D
grid's velocities are sums divided by the nodal mass, so their error is
weighted by that mass and scaled by the raw sum's max; G2P's C by one
term's size, D^-1 dx |v|max, as its terms cancel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

pytestmark = pytest.mark.cuda

REL = 1e-5
KB, MU, GAMMA = 2e6, 1e-3, 7.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(r, k, g, seed, device):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k + 1, r)
    counts[::5] = 0
    counts[1] = k
    rel = rng.choice([-1, 0, 0, 1, 2], size=(r, k))              # 2: outside the margin
    gx0 = np.arange(r)[:, None] + rel + 0.5 + rng.random((r, k))
    gx1 = rng.uniform(-1.0, g + 1.0, (r, k))                      # past both edges
    live = np.arange(k)[None, :] < counts[:, None]
    v = rng.normal(0.0, 1.0, (2, r, k))
    c = rng.normal(0.0, 5.0, (4, r, k))
    j = np.where(live, rng.uniform(0.9, 1.1, (r, k)), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, (r, k)), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, (r, k)), 0.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device).contiguous()
    sdata = t(np.stack([gx0, gx1, *v, *c, j, mass, vol0], axis=1))
    pdata2 = t(np.stack([gx0, gx1, live], axis=1))
    grid4 = t(rng.normal(0.0, 1.0, (r, 4, g)))
    return sdata, pdata2, t(counts, torch.int32), grid4


def _close(got, want, axis):
    g = got.movedim(axis, 0).reshape(got.shape[axis], -1).double()
    w = want.movedim(axis, 0).reshape(want.shape[axis], -1).double()
    err = (g - w).abs().amax(dim=1)
    scale = w.abs().amax(dim=1).clamp(min=1e-30)
    assert bool((err <= REL * scale).all()), (err / scale).tolist()


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513)], ids=["small", "g513"])
@pytest.mark.parametrize("apic", [False, True], ids=["pic", "apic"])
@pytest.mark.parametrize("eos", ["linear", "tait"])
def test_p2g_fused_kernel_matches_plain(dev, shape, apic, eos):
    r, k, g = shape
    sdata, _, counts, _ = _inputs(r, k, g, seed=r + apic, device=dev)
    dx = 0.4375 / (g - 5)
    args = dict(g=g, dx=dx, apic=apic, eos=eos, kb=KB, mu=MU, gamma=GAMMA,
                fa=-2e-5 * 4.0 / dx**2)
    n0 = tk.LAUNCHES["p2g_fused"]
    got = tk.p2g_fused(sdata, counts, **args)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2g_fused"] == n0 + 1
    _close(got, tk.p2g_fused_plain(sdata, counts, **args), axis=2)
    # The same inputs on the CPU take the plain route and agree too.
    cpu = tk.p2g_fused(sdata.cpu(), counts.cpu(), **args)
    _close(got.cpu(), cpu, axis=2)


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513)], ids=["small", "g513"])
def test_g2p_kernel_matches_plain(dev, shape):
    r, k, g = shape
    _, pdata2, counts, grid4 = _inputs(r, k, g, seed=7, device=dev)
    dx = 0.4375 / (g - 5)
    n0 = tk.LAUNCHES["g2p"]
    got = tk.g2p(pdata2, counts, grid4, dx, 4.0 / dx**2)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["g2p"] == n0 + 1
    _close(got, tk.g2p_plain(pdata2, counts, grid4, dx, 4.0 / dx**2), axis=1)


def _pdata(r, k, g, nch, seed, device):
    """Prepped P2G rows [gx0, gx1, m v (2), P (4), Q (4), *plain], masked,
    on the ragged slots of `_inputs`."""
    sdata, _, counts, _ = _inputs(r, k, g, seed, device)
    rng = np.random.default_rng(seed + 1)
    live = (torch.arange(k, device=device)[None, :] < counts[:, None]).float()
    extra = torch.as_tensor(rng.normal(0.0, 5.0, (r, 4 + nch - 6, k)), dtype=torch.float32,
                            device=device)
    mass, vol0 = sdata[:, 9:10], sdata[:, 10:11]
    rows = [sdata[:, :2], mass * sdata[:, 2:4], mass * sdata[:, 4:8], extra[:, :4] * live[:, None],
            mass, vol0, extra[:, 4:] * vol0]
    return torch.cat(rows, dim=1).contiguous(), counts


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513), (24, 512, 2049)],
                         ids=["small", "g513", "g2049_bands"])
@pytest.mark.parametrize("nch", [6, 9])
@pytest.mark.parametrize("apic,tent", [(False, False), (True, False), (False, True)],
                         ids=["pic", "apic", "tent"])
def test_p2g_kernel_matches_plain(dev, shape, nch, apic, tent):
    """At G = 2049 the 9-channel slab (369 KB) exceeds the opt-in shared
    memory, so the kernel runs in column bands."""
    r, k, g = shape
    pdata, counts = _pdata(r, k, g, nch, seed=r + nch, device=dev)
    dx = 0.4375 / (g - 5)
    n0 = tk.LAUNCHES["p2g"]
    got = tk.p2g(pdata, counts, g, dx, tent, apic)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2g"] == n0 + 1
    _close(got, tk.p2g_plain(pdata, counts, g, dx, tent, apic), axis=2)


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513)], ids=["small", "g513"])
@pytest.mark.parametrize("gch,tent", [(7, False), (4, True), (7, True)],
                         ids=["ext", "tent", "ext_tent"])
def test_g2p_extended_and_tent_kernel_match_plain(dev, shape, gch, tent):
    r, k, g = shape
    _, pdata2, counts, _ = _inputs(r, k, g, seed=9, device=dev)
    grid = torch.randn((r, gch, g), generator=torch.Generator().manual_seed(3)).to(dev)
    dx = 0.4375 / (g - 5)
    dinv = 1.0 if tent else 4.0 / dx**2
    n0 = tk.LAUNCHES["g2p"]
    got = tk.g2p(pdata2, counts, grid, dx, dinv, tent)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["g2p"] == n0 + 1
    assert got.shape == (r, 8 + gch - 4, k)
    _close(got, tk.g2p_plain(pdata2, counts, grid, dx, dinv, tent), axis=1)


def test_kernel_wrappers_reject_bad_inputs(dev):
    sdata, pdata2, counts, grid4 = _inputs(8, 128, 37, seed=1, device=dev)
    args = dict(g=37, dx=0.01, apic=False, eos="linear", kb=KB, mu=MU, gamma=GAMMA, fa=-1.0)
    with pytest.raises(ValueError):
        tk.p2g_fused(sdata, counts.cpu(), **args)        # mixed devices
    with pytest.raises(ValueError):
        tk.p2g_fused(sdata.transpose(0, 2).contiguous().transpose(0, 2), counts, **args)
    with pytest.raises(TypeError):
        tk.g2p(pdata2, counts.long(), grid4, 0.01, 1.0)


def test_substeps_on_the_card_track_the_cpu(dev):
    cfg = MPMConfig(
        dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
        num_particles_y=32, flip_blend=0.98, transfer=TransferKind.PIC,
    )
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
    b_gpu = fast2d.from_particles(p, cfg, spec, dev)
    b_cpu = fast2d.from_particles(p, cfg, spec, device="cpu")
    tk.reset_launches()
    stats = fast2d.RunStats()
    out = fast2d.run(b_gpu, scene, spec, 100, stats)
    assert tk.LAUNCHES == {"p2g_fused": 100, "p2g": 0, "p2g_grid": 0, "g2p": 100}
    assert stats.substeps == 100
    ref = fast2d.run(b_cpu, scene, spec, 100)
    for f in dataclasses.fields(out):
        if f.name in ("x0", "x1"):
            np.testing.assert_allclose(
                getattr(out, f.name).cpu().numpy(), getattr(ref, f.name).numpy(), atol=1e-5
            )
    assert int(out.overflow) == 0


def test_stabilized_substeps_on_the_card_track_the_cpu(dev):
    """The full stabilized switch set (F-bar, penalty, mixing 1.0, PIC +
    FLIP 0.98) through p2g and the extended g2p, 20 substeps."""
    cfg = MPMConfig(
        dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
        num_particles_y=32, flip_blend=0.98, transfer=TransferKind.PIC,
        use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0,
    )
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
    tk.reset_launches()
    out = fast2d.run(fast2d.from_particles(p, cfg, spec, dev), scene, spec, 20)
    assert tk.LAUNCHES == {"p2g_fused": 0, "p2g": 20, "p2g_grid": 0, "g2p": 20}
    ref = fast2d.run(fast2d.from_particles(p, cfg, spec, device="cpu"), scene, spec, 20)
    for name in ("x0", "x1"):
        np.testing.assert_allclose(
            getattr(out, name).cpu().numpy(), getattr(ref, name).numpy(), atol=1e-6
        )
    # The gathered Jbar to 1e-5 (80 float32 ulps near 1, 20 substeps of
    # reordered sums); the gathered pressure is K (1 - J), so one ulp of J
    # is K 2^-23 = 0.24 Pa: it gets the same bound in J, 1e-5 K.
    np.testing.assert_allclose(out.jbar_s.cpu().numpy(), ref.jbar_s.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.p_s.cpu().numpy(), ref.p_s.numpy(), rtol=0,
                               atol=1e-5 * scene.params.bulk_modulus)
    assert int(out.overflow) == 0


def _inputs3d(r, k, g, seed, device):
    """Ragged random pencils: empty, full and partly filled pencils, slots
    outside the +-1 margin on both axes, z past both grid edges."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k + 1, (r, r))
    counts[::5, ::3] = 0
    counts[1, 1] = k
    rel0 = rng.choice([-1, 0, 0, 1, 2], size=(r, r, k))
    rel1 = rng.choice([-1, 0, 0, 1, -2], size=(r, r, k))
    gx0 = np.arange(r)[:, None, None] + rel0 + 0.5 + rng.random((r, r, k))
    gx1 = np.arange(r)[None, :, None] + rel1 + 0.5 + rng.random((r, r, k))
    gx2 = rng.uniform(-1.0, g + 1.0, (r, r, k))
    live = np.arange(k) < counts[..., None]
    v = rng.normal(0.0, 1.0, (3, r, r, k))
    c = rng.normal(0.0, 5.0, (9, r, r, k))
    j = np.where(live, rng.uniform(0.9, 1.1, (r, r, k)), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, (r, r, k)), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, (r, r, k)), 0.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    planes = tuple(t(a) for a in (gx0, gx1, gx2, *v, *c, j, mass, vol0))
    counts = torch.as_tensor(counts.reshape(-1), dtype=torch.int32, device=device)
    return planes, t(live), counts


def _p2g3d_args(g, wall):
    dx = 0.4375 / (g - 5)
    dinv = 4.0 / dx**2
    return dict(
        apic=wall == "sticky", stress="tait" if wall == "sticky" else "linear",
        kb=KB, mu=MU, gamma=GAMMA, fa=-2e-5 * dinv, dt=2e-5, grav=(0.0, 0.0, -9.81),
        floor=1e-8, lo=2, hi=g - 3, wall=wall,
        beta=1e6 * 997.5 * dx**2 if wall == "penalty" else 0.0,
    ), dx, dinv


@pytest.mark.parametrize("shape", [(16, 128, 16), (128, 128, 128)], ids=["small", "g128"])
@pytest.mark.parametrize("wall", ["slip", "sticky", "penalty"])
def test_p2g3d_grid_kernel_matches_plain(dev, shape, wall):
    r, k, g = shape
    planes, _, counts = _inputs3d(r, k, g, seed=r, device=dev)
    kw, dx, _ = _p2g3d_args(g, wall)
    raw = torch.empty((r + 4, r + 4, tk3.P2G_CH, g), device=dev)
    n0 = tk3.LAUNCHES["p2g3d_grid"]
    got = tk3.p2g3d_grid(planes, counts, r, g, dx, raw_out=raw, **kw)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d_grid"] == n0 + 1
    scatter = {n: kw[n] for n in ("apic", "stress", "kb", "mu", "gamma", "fa")}
    raw_plain = tk3.p2g3d_raw_plain(planes, counts, g, dx, **scatter)
    _close(raw, raw_plain, axis=2)
    want = tk3.p2g3d_grid_plain(planes, counts, r, g, dx, **kw)
    m = raw_plain[:, :, 6:7]
    mom_err = ((got - want).abs() * m).double().amax(dim=(0, 1, 3))
    mom_max = raw_plain[:, :, [3, 4, 5, 0, 1, 2]].abs().double().amax(dim=(0, 1, 3))
    assert bool((mom_err <= REL * mom_max).all()), (mom_err / mom_max).tolist()
    assert not got[0].any() and not got[r + 1 :].any()
    raw2 = torch.empty_like(raw)
    assert torch.equal(got, tk3.p2g3d_grid(planes, counts, r, g, dx, raw_out=raw2, **kw))
    assert torch.equal(raw, raw2)


@pytest.mark.parametrize("shape", [(16, 128, 16), (128, 128, 128)], ids=["small", "g128"])
def test_g2p3d_kernel_matches_plain(dev, shape):
    r, k, g = shape
    planes, live, counts = _inputs3d(r, k, g, seed=r + 1, device=dev)
    kw, dx, dinv = _p2g3d_args(g, "slip")
    grid = tk3.p2g3d_grid_plain(planes, counts, r, g, dx, **kw)
    x = tuple((p - 2.0) * dx for p in planes[:3])
    state = (*planes[3:6], planes[15], *x)
    args = (*planes[:3], live, counts, grid, dx, dinv, state, 0.98, 2e-5)
    n0 = tk3.LAUNCHES["g2p3d"]
    got = tk3.g2p3d(*args)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["g2p3d"] == n0 + 1
    want = tk3.g2p3d_plain(*args)
    c_unit = dinv * dx * float(grid[:, :, :3].abs().max())
    err = (got - want).abs().double().amax(dim=(0, 1, 3))
    scale = want.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = c_unit
    assert bool((err <= REL * scale).all()), (err / scale).tolist()


def test_3d_substeps_on_the_card_track_the_cpu(dev):
    p, scene = scenes.dam_break_3d(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5)
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    tk3.reset_launches()
    stats = fast3d.RunStats()
    out = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, dev), scene, spec, 20, stats)
    assert tk3.LAUNCHES == {"p2g3d": 0, "p2g3d_grid": 20, "g2p3d": 20}
    assert stats.substeps == 20
    ref = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, device="cpu"), scene, spec, 20)
    for a in range(3):
        np.testing.assert_allclose(
            getattr(out, f"x{a}").cpu().numpy(), getattr(ref, f"x{a}").numpy(), atol=1e-6
        )
    assert int(out.overflow) == 0


def _prepped3d(r, k, g, apic, ext, seed, device):
    """Prepped P2G planes [gx (3), m v (3), P (9, APIC), Q (9), m (, ext
    4)], value planes masked, on the ragged slots of `_inputs3d`."""
    planes, live, counts = _inputs3d(r, k, g, seed, device)
    return _prep_planes(planes, live, apic, ext, seed, device), live, counts


def _prep_planes(planes, live, apic, ext, seed, device):
    """The prepped planes of `_prepped3d` from state planes and their mask."""
    rng = np.random.default_rng(seed + 1)
    mass, vol0 = planes[16], planes[17]
    rand = lambda scale: torch.as_tensor(
        rng.normal(0.0, scale, tuple(live.shape)), dtype=torch.float32, device=device)
    fields = [*planes[:3], *(mass * v for v in planes[3:6])]
    if apic:
        fields += [mass * c for c in planes[6:15]]
    fields += [rand(5.0) * live for _ in range(9)]
    fields.append(mass)
    if ext:
        fields += [vol0 * planes[15], vol0, vol0 * rand(2e3), vol0 * rand(5.0)]
    return tuple(f.contiguous() for f in fields)


PREPPED_MODES = [(False, True, False), (True, False, False), (False, True, True)]
PREPPED_IDS = ["pic_ext", "apic", "pic_ext_tent"]


@pytest.mark.parametrize("shape", [(16, 128, 16), (64, 128, 64), (8, 128, 2049)],
                         ids=["small", "g64", "g2049_bands"])
@pytest.mark.parametrize("apic,ext,tent", PREPPED_MODES, ids=PREPPED_IDS)
def test_p2g3d_kernel_matches_plain(dev, shape, apic, ext, tent):
    """At G2 = 2049 the 11-channel (5, 11, G2) slab (451 KB) exceeds the
    opt-in shared memory, so the kernel runs in z bands."""
    r, k, g = shape
    fields, _, counts = _prepped3d(r, k, g, apic, ext, seed=r + apic, device=dev)
    dx = 0.4375 / (g - 5)
    n0 = tk3.LAUNCHES["p2g3d"]
    got = tk3.p2g3d(fields, counts, r, g, dx, apic=apic, ext=ext, tent=tent)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d"] == n0 + 1
    assert got.shape == (r, 5, r, 11 if ext else 7, g)
    want = tk3.p2g3d_plain(fields, counts, r, g, dx, apic, ext, tent)
    _close(got, want, axis=3)
    # The fold of the expanded sums is the interior of p2g3d_grid's raw
    # sums (its axis-1 pad rows hold the taps that p2g3d drops).
    raw = tk3.p2g3d_raw_plain(fields, counts, g, dx, apic=apic, tent=tent, ext=ext)
    _close(tk3.fold_rows0(got), raw[1 : r + 1, 1 : r + 1], axis=2)


@pytest.mark.parametrize("shape", [(16, 128, 16), (64, 128, 64)], ids=["small", "g64"])
@pytest.mark.parametrize("apic,ext,tent", PREPPED_MODES, ids=PREPPED_IDS)
@pytest.mark.parametrize("wall", ["slip", "penalty"])
def test_p2g3d_grid_prepped_kernel_matches_plain(dev, shape, apic, ext, tent, wall):
    r, k, g = shape
    fields, _, counts = _prepped3d(r, k, g, apic, ext, seed=r + ext, device=dev)
    kw, dx, _ = _p2g3d_args(g, wall)
    node = {n: kw[n] for n in ("dt", "grav", "floor", "lo", "hi", "wall", "beta")}
    nch = 11 if ext else 7
    raw = torch.empty((r + 4, r + 4, nch, g), device=dev)
    n0 = tk3.LAUNCHES["p2g3d_grid"]
    got = tk3.p2g3d_grid(fields, counts, r, g, dx, apic=apic, tent=tent, ext=ext,
                         raw_out=raw, **node)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d_grid"] == n0 + 1
    assert got.shape == (r + 4, r + 4, 9 if ext else 6, g)
    raw_plain = tk3.p2g3d_raw_plain(fields, counts, g, dx, apic=apic, tent=tent, ext=ext)
    _close(raw, raw_plain, axis=2)
    want = tk3.p2g3d_grid_plain(fields, counts, r, g, dx, apic=apic, tent=tent, ext=ext, **node)
    # Velocities weighted by the nodal mass, the averages by the nodal
    # volume, each scaled by its raw sum's max.
    m = raw_plain[:, :, 6:7]
    err = ((got - want)[:, :, :6].abs() * m).double().amax(dim=(0, 1, 3))
    top = raw_plain[:, :, [3, 4, 5, 0, 1, 2]].abs().double().amax(dim=(0, 1, 3))
    assert bool((err <= REL * top).all()), (err / top).tolist()
    if ext:
        vol = raw_plain[:, :, 8:9]
        err = ((got - want)[:, :, 6:].abs() * vol).double().amax(dim=(0, 1, 3))
        top = raw_plain[:, :, [7, 9, 10]].abs().double().amax(dim=(0, 1, 3))
        assert bool((err <= REL * top).all()), (err / top).tolist()
    assert not got[0].any() and not got[r + 1 :].any()
    assert torch.equal(got, tk3.p2g3d_grid(fields, counts, r, g, dx, apic=apic, tent=tent,
                                           ext=ext, **node))


@pytest.mark.parametrize("shape", [(16, 128, 16), (64, 128, 64)], ids=["small", "g64"])
@pytest.mark.parametrize("gch,tent,pad", [(6, False, 2), (9, False, 2), (9, True, 0), (6, True, 1)],
                         ids=["gather", "ext", "ext_tent_unpadded", "tent_pad0"])
def test_g2p3d_gather_kernel_matches_plain(dev, shape, gch, tent, pad):
    """Gather mode on a grid padded on both axes (pad 2), on axis 0 only
    (1) or on neither (0)."""
    r, k, g = shape
    planes, live, counts = _inputs3d(r, k, g, seed=r + gch, device=dev)
    dx = 0.4375 / (g - 5)
    dinv = 1.0 if tent else 4.0 / dx**2
    rows = (r + 4 if pad else r, r + 4 if pad == 2 else r)
    grid = torch.randn((*rows, gch, g), generator=torch.Generator().manual_seed(5)).to(dev)
    args = (*planes[:3], live, counts, grid, dx, dinv)
    n0 = tk3.LAUNCHES["g2p3d"]
    got = tk3.g2p3d(*args, tent=tent)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["g2p3d"] == n0 + 1
    assert got.shape == (r, r, 15 + gch - 6, k)
    want = tk3.g2p3d_plain(*args, tent=tent)
    err = (got - want).abs().double().amax(dim=(0, 1, 3))
    scale = want.abs().double().amax(dim=(0, 1, 3))
    scale[6:15] = dinv * dx * float(grid[:, :, :3].abs().max())
    assert bool((err <= REL * scale).all()), (err / scale).tolist()
    dead = ~(live > 0)
    assert not got.movedim(2, 0)[:, dead].any()


@pytest.mark.parametrize("floor", ["absolute", "relative"])
def test_stabilized_3d_substeps_on_the_card_track_the_cpu(dev, floor):
    """The stabilized switch set (F-bar, penalty, mixing 1.0, PIC + FLIP
    0.98) in 3D, 10 substeps: `p2g3d_grid`'s prepped mode with the scene's
    absolute mass floor, `p2g3d` with the relative one."""
    p, scene = scenes.dam_break_3d(
        num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, flip_blend=0.98,
        transfer=TransferKind.PIC, use_fbar=True, use_penalty_ebc=True,
        pressure_mixing_ratio=1.0,
    )
    if floor == "relative":
        scene = dataclasses.replace(scene, mass_floor=0.0)
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    tk3.reset_launches()
    out = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, dev), scene, spec, 10)
    want = {"p2g3d": 0, "p2g3d_grid": 10, "g2p3d": 10} if floor == "absolute" else \
        {"p2g3d": 10, "p2g3d_grid": 0, "g2p3d": 10}
    assert tk3.LAUNCHES == want
    ref = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, device="cpu"), scene, spec, 10)
    for a in range(3):
        np.testing.assert_allclose(
            getattr(out, f"x{a}").cpu().numpy(), getattr(ref, f"x{a}").numpy(), atol=1e-6
        )
    # As in 2D: Jbar to 1e-5, the gathered pressure to 1e-5 K.
    np.testing.assert_allclose(out.jbar_s.cpu().numpy(), ref.jbar_s.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.p_s.cpu().numpy(), ref.p_s.numpy(), rtol=0,
                               atol=1e-5 * scene.params.bulk_modulus)
    assert int(out.overflow) == 0


@pytest.mark.parametrize("block", ["neo_hookean", "corotated"])
def test_elastic_drop_3d_substeps_on_the_card_track_the_cpu(dev, block):
    from mpm_flip98a_tpu_torch.models import materials as mat

    material = mat.NEO_HOOKEAN if block == "neo_hookean" else mat.FIXED_COROTATED
    p, scene = scenes.elastic_drop_3d(block_material=material)
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    tk3.reset_launches()
    out = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, dev), scene, spec, 10)
    assert tk3.LAUNCHES == {"p2g3d": 0, "p2g3d_grid": 10, "g2p3d": 10}
    ref = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, device="cpu"), scene, spec, 10)
    for name in ("x0", "x1", "x2"):
        np.testing.assert_allclose(
            getattr(out, name).cpu().numpy(), getattr(ref, name).numpy(), atol=1e-6
        )
    np.testing.assert_allclose(out.F22.cpu().numpy(), ref.F22.numpy(), rtol=0, atol=1e-6)
    assert int(out.overflow) == 0


# ---------------------------------------------------------------------------
# The slab-sharded path: p2g_grid's raw mode, the prepadded g2p, the raw
# p2g3d_grid and the sharded runs.
# ---------------------------------------------------------------------------


def _local_rows(data, shards):
    """gx0 of each shard's rows made local to it (row 0 = its origin)."""
    r = data.shape[0]
    l = r // shards
    out = data.clone()
    out[:, 0] -= (torch.arange(r, device=data.device) // l * l).to(data.dtype)[:, None]
    return out


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["fused", "ch9", "ch6_tent"])
def test_p2g_grid_kernel_matches_plain(dev, mode, shards):
    r, k, g = 32, 512, 513
    sdata, pdata2, counts, _ = _inputs(r, k, g, seed=40 + shards, device=dev)
    dx = 0.4375 / (g - 5)
    if mode == "fused":
        data = sdata
        kw = dict(fused=True, apic=True, eos="tait", kb=KB, mu=MU, gamma=GAMMA,
                  fa=-2e-5 * 4.0 / dx**2)
    else:
        nch = 9 if mode == "ch9" else 6
        rng = np.random.default_rng(7)
        vals = torch.as_tensor(rng.normal(0.0, 1.0, (r, 6 + nch, k)), dtype=torch.float32,
                               device=dev) * pdata2[:, 2:3]
        vals[:, 10] = sdata[:, 9]                  # m
        data = torch.cat([sdata[:, :2], vals], dim=1).contiguous()
        kw = dict(fused=False, tent=mode.endswith("tent"), apic=False)
    data = _local_rows(data, shards)
    n0 = tk.LAUNCHES["p2g_grid"]
    got = tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2g_grid"] == n0 + 1         # one call for all shards
    want = tk.p2g_grid_plain(data, counts, g, dx, raw=True, shards=shards, **kw)
    assert got.shape == want.shape == (shards, r // shards + 4, want.shape[2], g)
    _close(got, want, axis=2)


@pytest.mark.parametrize("gch,tent", [(4, False), (7, True)], ids=["base", "ext_tent"])
def test_g2p_prepadded_kernel_matches_plain(dev, gch, tent):
    r, k, g, shards = 32, 512, 513, 4
    _, pdata2, counts, _ = _inputs(r, k, g, seed=50, device=dev)
    pdata2 = _local_rows(pdata2, shards)
    grid = torch.randn((shards, r // shards + 4, gch, g), device=dev)
    dx = 0.4375 / (g - 5)
    dinv = 1.0 if tent else 4.0 / dx**2
    n0 = tk.LAUNCHES["g2p"]
    got = tk.g2p(pdata2, counts, grid, dx, dinv, tent, prepadded=True)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["g2p"] == n0 + 1
    want = tk.g2p_plain(pdata2, counts, grid, dx, dinv, tent, prepadded=True)
    err = (got - want).abs().double().amax(dim=(0, 2))
    scale = want.abs().double().amax(dim=(0, 2))
    scale[4:8] = dinv * dx * float(grid[:, :, :2].abs().max())   # C: one term's size
    assert bool((err <= REL * scale).all()), (err / scale).tolist()


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("stress", ["tait", None], ids=["stress", "prepped11"])
def test_p2g3d_grid_raw_kernel_matches_plain(dev, stress, shards):
    r, k, g = 32, 128, 32
    if stress:
        fields, _, counts = _inputs3d(r, k, g, seed=60, device=dev)
        kw = dict(apic=True, stress="tait", kb=KB, mu=MU, gamma=GAMMA, fa=-2e-5 * 4.0)
    else:
        fields, _, counts = _prepped3d(r, k, g, False, True, seed=61, device=dev)
        kw = dict(apic=False, ext=True)
    l0 = r // shards
    fields = list(fields)
    fields[0] = (fields[0] - (torch.arange(r, device=dev) // l0 * l0).to(torch.float32)
                 [:, None, None]).contiguous()
    dx = 0.4375 / (g - 5)
    n0 = tk3.LAUNCHES["p2g3d_grid"]
    got = tk3.p2g3d_grid(fields, counts, r, g, dx, raw=True, shards=shards, **kw)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d_grid"] == n0 + 1
    want = tk3.p2g3d_raw_plain(fields, counts, g, dx, shards=shards, **kw)
    assert got.shape == want.shape == (shards, l0 + 4, r + 4, want.shape[3], g)
    _close(got, want, axis=3)
    assert torch.equal(got, tk3.p2g3d_grid(fields, counts, r, g, dx, raw=True, shards=shards,
                                           **kw))


def test_sharded_substeps_on_the_card_track_the_cpu(dev):
    """20 substeps of the sharded 2D and 3D runs on the card against the
    CPU's: x to 1e-6, and slot for slot v and C to REL of their group's
    largest entry and J to 1e-6 (x moves by a few of its float32 ulps)."""
    from mpm_flip98a_tpu_torch.parallel import SlabMesh
    from mpm_flip98a_tpu_torch.parallel import fast_domain, fast_domain3d

    cfg = MPMConfig(dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
                    num_particles_y=32, flip_blend=0.98, transfer=TransferKind.PIC)
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    p3, scene3 = scenes.dam_break_3d(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5)
    for dom, (pp, sc), n, names in (
        (fast_domain, (p, scene), 8, ("x0", "x1")),
        (fast_domain3d, (p3, scene3), 4, ("x0", "x1", "x2")),
    ):
        spec_cls = dom.FastDomain3DSpec if dom is fast_domain3d else dom.FastDomainSpec
        spec = spec_cls.for_particles(sc.cfg, n, pp)
        out = {}
        for where in (dev, torch.device("cpu")):
            mesh = SlabMesh(n, where)
            tk.reset_launches()
            tk3.reset_launches()
            out[where.type] = dom.make_run(sc, spec, mesh)(
                dom.distribute(pp, sc.cfg, spec, mesh), 20)
            if where.type == "cuda":
                grid = tk3.LAUNCHES["p2g3d_grid"] if dom is fast_domain3d \
                    else tk.LAUNCHES["p2g_grid"]
                assert grid == 20 and tk.LAUNCHES["p2g_fused"] == 0
        for name in names:
            np.testing.assert_allclose(getattr(out["cuda"], name).cpu().numpy(),
                                       getattr(out["cpu"], name).numpy(), atol=1e-6)
        assert int(out["cuda"].overflow.sum()) == 0
        np.testing.assert_array_equal(out["cuda"].mask.cpu().numpy(), out["cpu"].mask.numpy())
        dim = len(names)
        for group, tol in (([f"v{a}" for a in range(dim)], REL),
                           ([f"C{a}{c}" for a in range(dim) for c in range(dim)], REL),
                           (["J"], None)):
            have = torch.stack([getattr(out["cuda"], g).cpu() for g in group]).double()
            want = torch.stack([getattr(out["cpu"], g) for g in group]).double()
            err = float((have - want).abs().max())
            bound = 1e-6 if tol is None else tol * float(want.abs().max())
            assert err <= bound, (dom.__name__, group, err, bound)


def _colliders3d(g, dx):
    """A slip sphere, a sticky box with a surface velocity and a moving
    center, and a halfspace spinner about its normal, over the grid of
    `_inputs3d` (node x = (idx - 2) dx)."""
    from mpm_flip98a_tpu_torch.models.colliders import Collider

    l = (g - 5) * dx
    n = np.array([0.15, -0.1, 1.0])
    return (
        Collider(kind="sphere", center=(0.45 * l, 0.5 * l, 0.35 * l), radius=0.2 * l),
        Collider(kind="box", center=(0.7 * l, 0.3 * l, 0.6 * l),
                 half_extents=(0.12 * l, 0.2 * l, 0.1 * l), sticky=True,
                 velocity=(0.3, 0.0, -0.2), center_velocity=(0.5, 0.0, 0.0)),
        Collider(kind="halfspace", center=(0.0, 0.0, 0.15 * l), normal=tuple(n),
                 angular=tuple(5.0 * n / np.linalg.norm(n))),
    )


def _inside_flips(call, colliders, r):
    """Nodes whose inside flag differs between the kernel and the plain
    version: each collider made sticky with a sentinel surface velocity
    (1000 (i + 1) m/s, no spin) pins the nodes inside it to exactly that
    velocity in both.  `call(colliders, kernel)` returns the finished grid.
    Returns (flips, nodes inside) over the interior rows."""
    probes = tuple(dataclasses.replace(c, sticky=True, angular=(), velocity=(1e3 * (i + 1),) * 3)
                   for i, c in enumerate(colliders))
    marks = torch.tensor([float(np.float32(1e3 * (i + 1)) + np.float32((c.center_velocity or
                                                                        (0.0,))[0]))
                          for i, c in enumerate(probes)])
    flags = [torch.isin(call(probes, kernel)[1 : r + 1, 1 : r + 1, 0].cpu(), marks)
             for kernel in (True, False)]
    return int((flags[0] != flags[1]).sum()), int(flags[1].sum())


@pytest.mark.parametrize("shape", [(16, 128, 16), (64, 128, 64)], ids=["small", "g64"])
@pytest.mark.parametrize("mode", ["stress", "prepped11", "tent"])
@pytest.mark.parametrize("tcol", [None, 0.05], ids=["static", "moving"])
def test_p2g3d_grid_collider_kernel_matches_plain(dev, shape, mode, tcol):
    """The node pass's collider projection against the plain version: the
    finished grid weighted by the nodal mass (as the collider-free modes)
    to REL of that weighted channel's max, the nodes that no mass reached
    to REL of their scale unweighted, and no node whose inside flag
    differs."""
    r, k, g = shape
    kw, dx, _ = _p2g3d_args(g, "slip")
    if mode == "stress":
        fields, _, counts = _inputs3d(r, k, g, seed=r + 5, device=dev)
    else:
        fields, _, counts = _prepped3d(r, k, g, False, True, seed=r + 6, device=dev)
        kw = dict({n: kw[n] for n in ("dt", "grav", "floor", "lo", "hi", "wall", "beta")},
                  apic=False, ext=True, tent=mode == "tent")
    cols = _colliders3d(g, dx)

    def call(colliders, kernel):
        fn = tk3.p2g3d_grid if kernel else tk3.p2g3d_grid_plain
        return fn(fields, counts, r, g, dx, **kw, colliders=colliders, tcol=tcol)

    n0 = tk3.LAUNCHES["p2g3d_grid"]
    got = call(cols, True)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d_grid"] == n0 + 1
    want = call(cols, False)
    free = call((), False)
    assert float((want[:, :, :3] - free[:, :, :3]).abs().max()) > 0.1   # the colliders act
    raw_plain = tk3.p2g3d_raw_plain(fields, counts, g, dx, **{
        n: kw[n] for n in ("apic", "stress", "kb", "mu", "gamma", "fa", "ext", "tent") if n in kw})
    # Scaled by the mass-weighted finished channel's max: the colliders give
    # nodes velocities that the raw sums never had.
    m = raw_plain[:, :, 6:7]
    err = ((got - want)[:, :, :6].abs() * m).double().amax(dim=(0, 1, 3))
    top = (want[:, :, :6].abs() * m).double().amax(dim=(0, 1, 3))
    assert bool((err <= REL * top).all()), (err / top).tolist()
    empty = (m == 0).expand_as(got[:, :, :3])
    err0 = float((got - want)[:, :, :3][empty].abs().max())
    assert err0 <= REL * float(want[:, :, :3][empty].abs().max()), err0
    assert not got[0].any() and not got[r + 1 :].any()
    flips, inside = _inside_flips(call, cols, r)
    assert flips == 0 and inside > 0, (flips, inside)
    assert torch.equal(got, call(cols, True))


def test_cli_runs_dam3d_obstacle_on_the_card(dev, tmp_path):
    """The `dam3d_obstacle` scenario through the CLI on the card: the
    collider mode of p2g3d_grid and g2p3d once per substep."""
    from mpm_flip98a_tpu_torch import driver

    tk.reset_launches()
    tk3.reset_launches()
    sim = driver.main(["--scenario", "dam3d_obstacle", "--path", "fast", "--frames", "2",
                       "--substeps", "10", "--no-gif", "--sync-io", "--out", str(tmp_path)])
    assert sim.device.type == "cuda"
    assert tk3.LAUNCHES == {"p2g3d": 0, "p2g3d_grid": 20, "g2p3d": 20}
    x = sim.positions()
    assert np.isfinite(x).all() and int(sim.state.overflow) == 0
    c = sim.scene.colliders[0]
    phi = np.sqrt(((x - np.asarray(c.center)) ** 2).sum(-1)) - c.radius
    assert phi.min() > -1.5 * sim.cfg.dx


# ---------------------------------------------------------------------------
# p2g3d_grid's tiles: the shapes a tile of five target planes on axis 0,
# its source window, its rounds of z columns, its chunks of source slots
# and its z bands can get wrong (ops/cuda/transfer3d.plan_p2g3d_grid: one
# band up to G2 = 512, chunks of 768 or 1024 slots).
# ---------------------------------------------------------------------------


def _edge_inputs3d(r0, r1, k, g, seed, device, rel=(-1, 0, 0, 1, 2), z=None, empty=None):
    """State planes on an (r0, r1) bucket grid: base rows at `rel` from the
    pencil's on both axes (2: outside the margin), gx2 uniform in `z`
    (default past both grid edges), every fourth pencil empty, and no slot
    in the pencils of `empty` (a pair of slices)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, k + 1, (r0, r1))
    counts[::4, ::3] = 0
    if empty is not None:
        counts[empty] = 0
    shape = (r0, r1, k)
    gx0 = np.arange(r0)[:, None, None] + rng.choice(rel, size=shape) + 0.5 + rng.random(shape)
    gx1 = np.arange(r1)[None, :, None] + rng.choice(rel, size=shape) + 0.5 + rng.random(shape)
    gx2 = rng.uniform(*(z or (-1.0, g + 1.0)), shape)
    live = np.arange(k) < counts[..., None]
    v = rng.normal(0.0, 1.0, (3, *shape))
    c = rng.normal(0.0, 5.0, (9, *shape))
    j = np.where(live, rng.uniform(0.9, 1.1, shape), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, shape), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, shape), 0.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    planes = tuple(t(a) for a in (gx0, gx1, gx2, *v, *c, j, mass, vol0))
    return planes, t(live), torch.as_tensor(counts.reshape(-1), dtype=torch.int32, device=device)


EDGE_SHAPES = {
    # R0, R1 not multiples of the tile (17 x 25 padded planes), G2 not of 32.
    "ragged_rows_g37": dict(r0=13, r1=21, k=64, g=37),
    # The sources of whole tiles empty: no slot in pencils [0, 14) x [0, 14).
    "empty_tiles": dict(r0=28, r1=20, k=64, g=32, empty=(slice(0, 14), slice(0, 14))),
    # Every slot's base row at -1 or +1 of its pencil's on both axes.
    "margin_edges": dict(r0=12, r1=12, k=64, g=24, rel=(-1, 1)),
    # A thin layer in a deep grid: one round of its columns, the other
    # columns through the node pass with zero sums.
    "thin_z_g256": dict(r0=12, r1=12, k=64, g=256, z=(40.0, 52.0)),
    # Slots over the full depth: the range summed in two rounds of 64
    # columns.
    "bands_g128": dict(r0=10, r1=10, k=64, g=128),
    # Crowded pencils: a tile's sources hold several chunks of slots.
    "crowded": dict(r0=6, r1=7, k=1536, g=24),
    # Past 512 columns: two z bands of 300, each its own block.
    "bands_g600": dict(r0=6, r1=6, k=64, g=600),
}


def _check_grid(got, raw, raw_plain, want, ext, r0):
    """Raw sums per channel; velocities weighted by the nodal mass, the ext
    averages by the nodal volume, each scaled by its raw sum's max; the
    axis-0 pad rows zero."""
    _close(raw, raw_plain, axis=2)
    weight = [raw_plain[:, :, 6:7]] * 6 + [raw_plain[:, :, 8:9]] * (3 * ext)
    tops = raw_plain[:, :, [3, 4, 5, 0, 1, 2] + [7, 9, 10] * ext].abs().double().amax(dim=(0, 1, 3))
    for ch in range(got.shape[2]):
        err = float(((got - want)[:, :, ch : ch + 1].abs() * weight[ch]).double().max())
        assert err <= REL * float(tops[ch]), (ch, err / float(tops[ch]))
    assert not got[0].any() and not got[r0 + 1 :].any()


@pytest.mark.parametrize("mode", ["stress", "prepped11", "tent7"])
@pytest.mark.parametrize("case", list(EDGE_SHAPES))
def test_p2g3d_grid_tiles_match_plain(dev, case, mode):
    """The single-device modes against plain on shapes the tiling can get
    wrong: the raw sums and the finished grid, one launch, and the plan the
    wrapper took."""
    size = dict(EDGE_SHAPES[case])
    r0, r1, k, g = (size.pop(n) for n in ("r0", "r1", "k", "g"))
    seed = 70 + list(EDGE_SHAPES).index(case)
    planes, live, counts = _edge_inputs3d(r0, r1, k, g, seed, dev, **size)
    kw, dx, _ = _p2g3d_args(g, "penalty" if mode == "tent7" else "slip")
    node = {n: kw[n] for n in ("dt", "grav", "floor", "lo", "hi", "wall", "beta")}
    if mode == "stress":
        fields, sums, nch = planes, {n: kw[n] for n in ("apic", "stress", "kb", "mu", "gamma", "fa")}, 7
    else:
        ext = mode == "prepped11"
        fields = _prep_planes(planes, live, not ext, ext, seed, dev)
        sums, nch = dict(apic=not ext, ext=ext, tent=mode == "tent7"), 11 if ext else 7
    plan = tk3.plan_p2g3d_grid(nch, g, r0, r1, apic=sums["apic"])
    assert plan.bands == (2 if g > tk3.GRID3D_MAX_BAND else 1)
    if case == "crowded":
        assert int(counts.view(r0, r1)[:5, :5].sum()) > 2 * plan.cap
    raw = torch.empty((r0 + 4, r1 + 4, nch, g), device=dev)
    n0 = tk3.LAUNCHES["p2g3d_grid"]
    got = tk3.p2g3d_grid(fields, counts, r1, g, dx, raw_out=raw, **sums, **node)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d_grid"] == n0 + 1
    raw_plain = tk3.p2g3d_raw_plain(fields, counts, g, dx, **sums)
    want = tk3.p2g3d_grid_plain(fields, counts, r1, g, dx, **sums, **node)
    _check_grid(got, raw, raw_plain, want, nch == 11, r0)
    # Reruns bitwise equal, and the raw mode's sums (one shard) bitwise the
    # non-raw mode's raw_out.
    raw2 = torch.empty_like(raw)
    assert torch.equal(got, tk3.p2g3d_grid(fields, counts, r1, g, dx, raw_out=raw2, **sums,
                                           **node))
    assert torch.equal(raw, raw2)
    assert torch.equal(raw, tk3.p2g3d_grid(fields, counts, r1, g, dx, raw=True, **sums)[0])


@pytest.mark.parametrize("stress", ["linear", None], ids=["stress", "prepped11"])
@pytest.mark.parametrize("shards,r1,g", [(3, 13, 37), (4, 9, 64)], ids=["l5_g37", "l4_g64"])
def test_p2g3d_grid_raw_tiles_match_plain(dev, stress, shards, r1, g):
    """The raw mode on shard windows of L0 + 4 = 9 planes (L0 = 5, which
    the 4-plane tile does not divide) or 8, a shard with no slot at all,
    and, at 11 channels and G2 = 64, z bands."""
    r0 = 5 * shards if g == 37 else 4 * shards
    l0 = r0 // shards
    planes, live, counts = _edge_inputs3d(r0, r1, 64, g, 80 + shards, dev,
                                          empty=(slice(l0, 2 * l0), slice(None)))
    if stress:
        fields = planes
        kw = dict(apic=False, stress="linear", kb=KB, mu=MU, gamma=GAMMA, fa=-2e-5 * 4.0)
    else:
        fields = _prep_planes(planes, live, False, True, 80 + shards, dev)
        kw = dict(apic=False, ext=True)
    fields = list(fields)
    fields[0] = (fields[0] - (torch.arange(r0, device=dev) // l0 * l0).to(torch.float32)
                 [:, None, None]).contiguous()
    dx = 0.4375 / (g - 5)
    n0 = tk3.LAUNCHES["p2g3d_grid"]
    got = tk3.p2g3d_grid(fields, counts, r1, g, dx, raw=True, shards=shards, **kw)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d_grid"] == n0 + 1
    want = tk3.p2g3d_raw_plain(fields, counts, g, dx, shards=shards, **kw)
    assert got.shape == want.shape == (shards, l0 + 4, r1 + 4, want.shape[3], g)
    _close(got, want, axis=3)
    assert not got[1].any()
    assert torch.equal(got, tk3.p2g3d_grid(fields, counts, r1, g, dx, raw=True, shards=shards,
                                           **kw))


@pytest.mark.parametrize("pos", [(2.7, 2.3, 4.6), (2.2, 3.9, 3.1), (4.6, 0.6, 0.6),
                                 (0.6, 5.4, 7.4)], ids=["inner", "axis1_taps", "low_edges",
                                                        "high_edges"])
def test_p2g3d_grid_one_particle_lands_whole(dev, pos):
    """One particle of unit mass: its 27 taps (those inside the grid) land
    with the plain version's weights, across tile edges on both axes and
    on the z edges, and its mass sums to 1."""
    r, k, g = 6, 2, 8
    planes = [torch.zeros((r, r, k)) for _ in range(18)]
    pen = tuple(int(x - 0.5) for x in pos[:2])
    for e in range(3):
        planes[e][pen[0], pen[1], 0] = pos[e]
    planes[15][...] = 1.0
    planes[16][pen[0], pen[1], 0] = 1.0
    planes[17][pen[0], pen[1], 0] = 1e-3
    counts = torch.zeros(r * r, dtype=torch.int32)
    counts[pen[0] * r + pen[1]] = 1
    kw = dict(apic=False, stress="linear", kb=0.0, mu=0.0, gamma=7.0, fa=0.0)
    want = tk3.p2g3d_raw_plain(planes, counts, g, 0.1, **kw)
    got = tk3.p2g3d_grid([p.to(dev).contiguous() for p in planes], counts.to(dev), r, g, 0.1,
                         raw=True, **kw)[0].cpu()
    _close(got, want, axis=2)
    inside = float(want[:, :, 6].sum())
    assert abs(float(got[:, :, 6].sum()) - inside) <= 1e-6
    assert inside > 0.5


def test_p2g3d_grid_allocates_no_raw_buffer(dev):
    """Without `raw_out` the call allocates its finished grid and nothing
    of the size of the raw sums (7/6 of it)."""
    r, k, g = 64, 128, 64
    planes, _, counts = _inputs3d(r, k, g, seed=90, device=dev)
    kw, dx, _ = _p2g3d_args(g, "slip")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = tk3.p2g3d_grid(planes, counts, r, g, dx, **kw)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    out_bytes = got.numel() * got.element_size()
    assert out_bytes <= grown < out_bytes + (1 << 20), (grown, out_bytes)


# ---------------------------------------------------------------------------
# p2g and p2g3d sum every node over its slots in a fixed order (csrc/p2g.cu,
# csrc/p2g3d.cu: a counting sort by base column, then a gather): two calls
# on the same inputs are bitwise equal, also where one column holds a whole
# bucket's slots (more than the staging window) and where slots sit on the
# edges of the column bands.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513), (24, 512, 2049)],
                         ids=["small", "g513", "g2049_bands"])
@pytest.mark.parametrize("nch", [6, 9])
@pytest.mark.parametrize("apic,tent", [(False, False), (True, False), (False, True)],
                         ids=["pic", "apic", "tent"])
def test_p2g_reruns_are_bitwise_equal(dev, shape, nch, apic, tent):
    r, k, g = shape
    pdata, counts = _pdata(r, k, g, nch, seed=r + nch, device=dev)
    dx = 0.4375 / (g - 5)
    first = tk.p2g(pdata, counts, g, dx, tent, apic)
    assert torch.equal(first, tk.p2g(pdata, counts, g, dx, tent, apic))


def _p2g_edge_case(case, dev):
    """Prepped rows with one full bucket row whose slots all sit in one
    column ("crowded": 2048 slots, past the staging window), or with every
    slot's columns within 2.5 of a column band's edge at G = 2049
    ("band_edges")."""
    if case == "crowded":
        r, k, g = 8, 2048, 64
        pdata, counts = _pdata(r, k, g, 9, seed=31, device=dev)
        u = torch.rand((k,), generator=torch.Generator().manual_seed(32)).to(dev)
        pdata[1, 1] = 20.5 + 0.999 * u          # counts[1] = K: base column 20
        assert int(counts[1]) == k
        assert tk.plan_p2g(9, g, k, False).cap < k
    else:
        r, k, g = 24, 512, 2049
        pdata, counts = _pdata(r, k, g, 9, seed=33, device=dev)
        band = tk.plan_p2g(9, g, k, False).band
        assert band < g
        gen = torch.Generator().manual_seed(34)
        edge = band * torch.randint(1, -(-g // band), (r, k), generator=gen)
        pdata[:, 1] = (edge + 5.0 * torch.rand((r, k), generator=gen) - 2.5).to(dev)
    return pdata, counts, g, 0.4375 / (g - 5)


@pytest.mark.parametrize("case", ["crowded", "band_edges"])
@pytest.mark.parametrize("apic,tent", [(False, False), (True, True)], ids=["pic", "apic_tent"])
def test_p2g_edge_cases_match_plain_and_rerun_equal(dev, case, apic, tent):
    pdata, counts, g, dx = _p2g_edge_case(case, dev)
    got = tk.p2g(pdata, counts, g, dx, tent, apic)
    _close(got, tk.p2g_plain(pdata, counts, g, dx, tent, apic), axis=2)
    assert torch.equal(got, tk.p2g(pdata, counts, g, dx, tent, apic))


@pytest.mark.parametrize("shape", [(16, 128, 16), (64, 128, 64), (8, 128, 2049)],
                         ids=["small", "g64", "g2049_bands"])
@pytest.mark.parametrize("apic,ext,tent", PREPPED_MODES, ids=PREPPED_IDS)
def test_p2g3d_reruns_are_bitwise_equal(dev, shape, apic, ext, tent):
    r, k, g = shape
    fields, _, counts = _prepped3d(r, k, g, apic, ext, seed=r + apic, device=dev)
    dx = 0.4375 / (g - 5)
    first = tk3.p2g3d(fields, counts, r, g, dx, apic=apic, ext=ext, tent=tent)
    assert torch.equal(first, tk3.p2g3d(fields, counts, r, g, dx, apic=apic, ext=ext, tent=tent))


def _p2g3d_edge_case(case, apic, ext, dev):
    """Prepped planes with one full pencil whose slots all sit in one z
    column ("crowded": 1024 slots, past the staging window with its
    neighbours), or with every slot's z columns within 2.5 of a z band's
    edge at G2 = 2049 ("band_edges")."""
    nch = tk3.P2G_CH_EXT if ext else tk3.P2G_CH
    if case == "crowded":
        r, k, g = 8, 1024, 32
        fields, _, counts = _prepped3d(r, k, g, apic, ext, seed=35, device=dev)
        u = torch.rand((k,), generator=torch.Generator().manual_seed(36)).to(dev)
        fields[2][1, 1] = 12.5 + 0.999 * u     # counts[1, 1] = K: base z column 12
        assert int(counts[r + 1]) == k
        assert tk3.plan_p2g3d(nch, g, k, apic).cap < k
    else:
        r, k, g = 8, 128, 2049
        fields, _, counts = _prepped3d(r, k, g, apic, ext, seed=37, device=dev)
        band = tk3.plan_p2g3d(nch, g, k, apic).band
        assert band < g
        gen = torch.Generator().manual_seed(38)
        edge = band * torch.randint(1, -(-g // band), (r, r, k), generator=gen)
        fields[2].copy_((edge + 5.0 * torch.rand((r, r, k), generator=gen) - 2.5).to(dev))
    return fields, counts, r, g, 0.4375 / (g - 5)


@pytest.mark.parametrize("case", ["crowded", "band_edges"])
@pytest.mark.parametrize("apic,ext,tent", [(True, False, False), (False, True, True)],
                         ids=["apic7", "pic_ext_tent"])
def test_p2g3d_edge_cases_match_plain_and_rerun_equal(dev, case, apic, ext, tent):
    fields, counts, r, g, dx = _p2g3d_edge_case(case, apic, ext, dev)
    got = tk3.p2g3d(fields, counts, r, g, dx, apic=apic, ext=ext, tent=tent)
    _close(got, tk3.p2g3d_plain(fields, counts, r, g, dx, apic, ext, tent), axis=3)
    assert torch.equal(got, tk3.p2g3d(fields, counts, r, g, dx, apic=apic, ext=ext, tent=tent))


# ---------------------------------------------------------------------------
# p2g_fused and p2g_grid run p2g's fixed-order gather (csrc/p2g.cu;
# p2g_grid over every shard's rows, then a fold in fold_rows_halo's
# order): reruns are bitwise equal, and p2g_grid's raw halo rows equal
# fold_rows_halo of the single-device kernel per shard.
# ---------------------------------------------------------------------------


def _fused_args(g, apic, eos):
    dx = 0.4375 / (g - 5)
    return dict(g=g, dx=dx, apic=apic, eos=eos, kb=KB, mu=MU, gamma=GAMMA,
                fa=-2e-5 * 4.0 / dx**2)


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513), (24, 512, 2049)],
                         ids=["small", "g513", "g2049_bands"])
@pytest.mark.parametrize("apic,eos", [(False, "linear"), (True, "tait")],
                         ids=["pic_linear", "apic_tait"])
def test_p2g_fused_reruns_are_bitwise_equal(dev, shape, apic, eos):
    r, k, g = shape
    sdata, _, counts, _ = _inputs(r, k, g, seed=60 + r, device=dev)
    args = _fused_args(g, apic, eos)
    first = tk.p2g_fused(sdata, counts, **args)
    _close(first, tk.p2g_fused_plain(sdata, counts, **args), axis=2)
    assert torch.equal(first, tk.p2g_fused(sdata, counts, **args))
    assert torch.equal(first, tk.p2g_fused(sdata, counts, **args))


def _fused_edge_case(case, dev):
    """sdata with one full bucket row whose slots all sit in one column
    ("crowded": 2048 slots, past the staging window), with every slot's
    columns within 2.5 of a column band's edge at G = 2049 ("band_edges"),
    or with slots on columns 0 and G - 1, empty rows and counts above K
    ("grid_edges")."""
    if case == "crowded":
        r, k, g = 8, 2048, 64
        sdata, _, counts, _ = _inputs(r, k, g, seed=71, device=dev)
        u = torch.rand((k,), generator=torch.Generator().manual_seed(72)).to(dev)
        sdata[1, 1] = 20.5 + 0.999 * u          # counts[1] = K: base column 20
        assert int(counts[1]) == k
        assert tk.plan_p2g_fused(g, k, True).cap < k
    elif case == "band_edges":
        r, k, g = 24, 512, 2049
        sdata, _, counts, _ = _inputs(r, k, g, seed=73, device=dev)
        band = tk.plan_p2g_fused(g, k, False).band
        assert band < g
        gen = torch.Generator().manual_seed(74)
        edge = band * torch.randint(1, -(-g // band), (r, k), generator=gen)
        sdata[:, 1] = (edge + 5.0 * torch.rand((r, k), generator=gen) - 2.5).to(dev)
    else:
        r, k, g = 16, 256, 37
        sdata, _, counts, _ = _inputs(r, k, g, seed=75, device=dev)
        gen = torch.Generator().manual_seed(76)
        side = torch.rand((r, k), generator=gen)
        sdata[:, 1] = torch.where(side < 0.5, 0.5 + 0.6 * side, g - 1.6 + 0.6 * side).to(dev)
        counts[2] = k + 7                       # past K: the K slots count
        counts[3:6] = 0
    return sdata, counts, g


@pytest.mark.parametrize("case", ["crowded", "band_edges", "grid_edges"])
@pytest.mark.parametrize("apic,eos", [(False, "linear"), (True, "tait")],
                         ids=["pic_linear", "apic_tait"])
def test_p2g_fused_edge_cases_match_plain_and_rerun_equal(dev, case, apic, eos):
    sdata, counts, g = _fused_edge_case(case, dev)
    args = _fused_args(g, apic, eos)
    got = tk.p2g_fused(sdata, counts, **args)
    _close(got, tk.p2g_fused_plain(sdata, counts, **args), axis=2)
    assert torch.equal(got, tk.p2g_fused(sdata, counts, **args))


def _grid_case(mode, shards, dev, case="ragged"):
    """(data, counts, g, dx, kw) for p2g_grid in `mode` (fused, ch9 APIC,
    ch6_tent PIC) on `shards` slab shards: the ragged slots of `_inputs`,
    or an edge case of `_fused_edge_case`."""
    if case == "ragged":
        sdata, _, counts, _ = _inputs(32, 512, 513, seed=80 + shards, device=dev)
        g = 513
    else:
        sdata, counts, g = _fused_edge_case(case, dev)
    r, _, k = sdata.shape
    assert r % shards == 0
    dx = 0.4375 / (g - 5)
    if mode == "fused":
        data = sdata
        kw = dict(fused=True, apic=True, eos="tait", kb=KB, mu=MU, gamma=GAMMA,
                  fa=-2e-5 * 4.0 / dx**2)
    else:
        nch = 9 if mode == "ch9" else 6
        rng = np.random.default_rng(8)
        live = (torch.arange(k, device=dev)[None, :] < counts[:, None]).float()[:, None]
        vals = torch.as_tensor(rng.normal(0.0, 1.0, (r, 6 + nch, k)), dtype=torch.float32,
                               device=dev) * live
        vals[:, 10] = sdata[:, 9]                  # m
        data = torch.cat([sdata[:, :2], vals], dim=1).contiguous()
        kw = dict(fused=False, tent=mode.endswith("tent"), apic=mode == "ch9")
    return _local_rows(data, shards), counts, g, dx, kw


def _fold_of_single(data, counts, g, dx, kw, shards):
    """fold_rows_halo of p2g_fused / p2g (the kernels) per shard."""
    l = data.shape[0] // shards
    if kw["fused"]:
        single = lambda d, c: tk.p2g_fused(d, c, g, dx, **{
            n: kw[n] for n in ("apic", "eos", "kb", "mu", "gamma", "fa")})
    else:
        single = lambda d, c: tk.p2g(d, c, g, dx, kw["tent"], kw["apic"])
    return torch.stack([tk.fold_rows_halo(single(data[s * l:(s + 1) * l],
                                                 counts[s * l:(s + 1) * l]))
                        for s in range(shards)])


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["fused", "ch9", "ch6_tent"])
def test_p2g_grid_reruns_and_equals_the_fold_of_the_single_device_kernel(dev, mode, shards):
    data, counts, g, dx, kw = _grid_case(mode, shards, dev)
    got = tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw)
    _close(got, tk.p2g_grid_plain(data, counts, g, dx, raw=True, shards=shards, **kw), axis=2)
    assert torch.equal(got, tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw))
    assert torch.equal(got, tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw))
    via = _fold_of_single(data, counts, g, dx, kw, shards)
    _close(got, via, axis=2)
    diff = float((got - via).abs().max())
    assert torch.equal(got, via), f"max |p2g_grid - fold_rows_halo(single)| = {diff:.3e}"


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("case", ["crowded", "band_edges", "grid_edges"])
@pytest.mark.parametrize("mode", ["fused", "ch9"])
def test_p2g_grid_edge_cases_match_plain_and_rerun_equal(dev, mode, case, shards):
    data, counts, g, dx, kw = _grid_case(mode, shards, dev, case)
    got = tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw)
    _close(got, tk.p2g_grid_plain(data, counts, g, dx, raw=True, shards=shards, **kw), axis=2)
    assert torch.equal(got, tk.p2g_grid(data, counts, g, dx, raw=True, shards=shards, **kw))
    via = _fold_of_single(data, counts, g, dx, kw, shards)
    _close(got, via, axis=2)
    diff = float((got - via).abs().max())
    assert torch.equal(got, via), f"max |p2g_grid - fold_rows_halo(single)| = {diff:.3e}"


# ---------------------------------------------------------------------------
# The general path and the validation model (plain torch, no kernel of
# their own), on the card against the CPU.  The card's index_add_ adds with
# atomics in no fixed order: float64 within 1e-12 of each field's scale
# after 1 substep and 1e-9 after 20, float32 x within 1e-7 and v 1e-4
# (absolute) after 1; the validation model within 1e-5 per substep.
# ---------------------------------------------------------------------------


def _general_errors(got, want):
    out = {}
    for f in dataclasses.fields(want):
        g = getattr(got, f.name).cpu().to(torch.float64)
        w = getattr(want, f.name).to(torch.float64)
        scale = float((want.x if f.name == "consistency" else w).abs().max())
        diff = float((g - w).abs().max())
        out[f.name] = diff / scale if diff else 0.0
    return out


# The general path in float32, card against CPU after one substep, v and C
# to this fraction of their scale.  The scatter kernel adds in the CPU's
# order; what is left is the elementwise passes and reductions.
GENERAL_F32_TOL = 1e-6


def _perturbed_dam(dtype, **switches):
    cfg = MPMConfig(dtype=np.dtype(dtype).name, num_grids=37, dt=2e-5, num_particles_x=16,
                    num_particles_y=32, **switches)
    p, scene = scenes.dam_break_2d(cfg, dtype=dtype)
    rng = np.random.default_rng(0)
    f = np.eye(2) + 0.01 * rng.standard_normal((p.n, 2, 2))
    t = lambda a: torch.from_numpy(np.asarray(a, dtype))
    p = dataclasses.replace(p, v=t(0.1 * rng.standard_normal((p.n, 2))),
                            C=t(10.0 * rng.standard_normal((p.n, 2, 2))), F=t(f),
                            J=t(np.linalg.det(f)))
    return p, scene


@pytest.mark.parametrize("switches", [
    dict(), dict(flip_blend=0.98, transfer=TransferKind.PIC, use_fbar=True,
                 use_penalty_ebc=True, pressure_mixing_ratio=1.0),
], ids=["apic", "stabilized"])
def test_general_substeps_on_the_card_track_the_cpu(dev, switches):
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.state import to_device

    p, scene = _perturbed_dam(np.float64, **switches)
    tk.reset_launches()
    for n, tol in ((1, 1e-12), (20, 1e-9)):
        got = stabilized.run(to_device(p, dev), scene, n)
        assert got.x.device.type == "cuda" and got.x.dtype == torch.float64
        errs = _general_errors(got, stabilized.run(p, scene, n))
        assert max(errs.values()) <= tol, (n, errs)
    assert not any(tk.LAUNCHES.values())       # the general path runs no kernel
    p32, scene32 = _perturbed_dam(np.float32, **switches)
    got = stabilized.substep(to_device(p32, dev), scene32)
    want = stabilized.substep(p32, scene32)
    np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.v.cpu().numpy(), want.v.numpy(), rtol=0, atol=1e-4)
    # The scatter adds in the CPU's order: v and C to GENERAL_F32_TOL of
    # their scale (1e-4 while the scatter added with atomics).
    errs = _general_errors(got, want)
    assert max(errs["v"], errs["C"]) <= GENERAL_F32_TOL, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_mls88_on_the_card_tracks_the_cpu(dev, dtype):
    """One substep from warm-ups 0, 50 and 200 within 1e-5: absolute in
    float64 (tests/test_mls_mpm_vs_oracle.py's warm-ups run in float64), of
    each field's scale in float32 (C reaches 522 at 200, where an ulp is
    6.1e-5)."""
    from mpm_flip98a_tpu_torch.config import MLS88Config
    from mpm_flip98a_tpu_torch.models import mls_mpm
    from mpm_flip98a_tpu_torch.state import to_device

    cfg = MLS88Config()
    s = mls_mpm.init_dam_break(n=2000, cfg=cfg, dtype=dtype, device="cpu")
    done = 0
    for warmup in (0, 50, 200):
        s = mls_mpm.run(s, cfg, warmup - done)
        done = warmup
        got, want = mls_mpm.substep(to_device(s, dev), cfg), mls_mpm.substep(s, cfg)
        for k in ("x", "v", "F", "C", "Jp"):
            w = getattr(want, k).double()
            scale = float(w.abs().max()) if dtype == torch.float32 else 1.0
            err = float((getattr(got, k).cpu().double() - w).abs().max()) / scale
            assert err <= 1e-5, (warmup, k, err)


# ---------------------------------------------------------------------------
# CSF surface tension and the incompressible projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_projection_on_the_card_tracks_the_cpu(dev, d, dtype):
    """The CG on seeded planes with a collider's solid ball, card against
    CPU: v and q to 1e-12 of their scale in float64, 1e-5 in float32 (the
    card's reductions sum in another order); the exit resid likewise."""
    from mpm_flip98a_tpu_torch.models import projection

    g = 33 if d == 2 else 16
    rng = np.random.default_rng(d)
    lo, hi = 2, g - 3
    m = np.zeros((g,) * d)
    m[tuple(slice(lo + 1, lo + 1 + (hi - lo) // 2) for _ in range(d))] = 1.0
    idx = np.indices(m.shape)
    solid = sum((i - (lo + 1 + (hi - lo) // 4)) ** 2 for i in idx) <= 2.5 ** 2
    vs = [rng.normal(size=m.shape) * (m > 0) for _ in range(d)]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    kw = dict(dx=0.01, lo=lo, hi=hi)
    t = lambda a, device: torch.as_tensor(a, dtype=dtype, device=device)
    got = projection.project_planes(tuple(t(v, dev) for v in vs), t(m, dev), 0.5, **kw,
                                    solid_extra=torch.as_tensor(solid, device=dev))
    want = projection.project_planes(tuple(t(v, "cpu") for v in vs), t(m, "cpu"), 0.5, **kw,
                                     solid_extra=torch.as_tensor(solid))
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert a.device.type == "cuda"
        err = float((a.cpu() - b).abs().max())
        assert err <= tol * float(b.abs().max()), err
    assert abs(float(got[2]) - float(want[2])) <= tol


def test_incompressible_fast2d_rerun_is_bitwise_equal(dev):
    """tests/test_projection.py:110-117's incompressible column on the
    fused 2D path (p2g_fused and g2p once per substep): two 50-substep runs
    are bitwise equal (the kernels and the CG's reductions sum in a fixed
    order), and the volume stays pinned."""
    cfg = MPMConfig(
        dtype="float32", num_grids=33, dt=1e-5, num_particles_x=24, num_particles_y=48,
        fluid_width=0.105, fluid_height=0.21, flip_blend=0.98, transfer=TransferKind.PIC,
        incompressible=True, pressure_iters=40,
    )
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
    b0 = fast2d.from_particles(p, cfg, spec, dev)
    tk.reset_launches()
    a = fast2d.run(b0, scene, spec, 50)
    assert tk.LAUNCHES == {"p2g_fused": 50, "p2g": 0, "p2g_grid": 0, "g2p": 50}
    b = fast2d.run(b0, scene, spec, 50)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert float((a.J - 1.0).abs().max()) < 5e-4


def test_p2g3d_7ch_on_an_incompressible_state_matches_plain(dev):
    """The projection leaves fast3d's fused branch for p2g3d's 7-channel
    mode + fold_rows0 + _grid_update (p2g3d_grid never launches): on the
    state of 5 such substeps, p2g3d against its plain version."""
    p, scene = scenes.dam_break_3d(num_grids=32, particles_per_axis=(12, 12, 24), dt=2e-5,
                                   incompressible=True)
    spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    tk3.reset_launches()
    b = fast3d.run(fast3d.from_particles(p, scene.cfg, spec, dev), scene, spec, 5)
    assert tk3.LAUNCHES == {"p2g3d": 5, "p2g3d_grid": 0, "g2p3d": 5}
    args = fast3d.p2g_args(scene)
    fields = fast3d.prepped_fields(b, scene, spec)
    counts = fast3d.pencil_counts(b)
    got = tk3.p2g3d(fields, counts, spec.rows1, **args)
    assert got.shape[3] == tk3.P2G_CH == 7
    want = tk3.p2g3d_plain(fields, counts, spec.rows1, args["g2"], args["dx"], args["apic"],
                           args["ext"], args["tent"])
    _close(got, want, axis=3)


# ---------------------------------------------------------------------------
# The general path's fixed-order scatter; p2g3d's halo1 mode; the two-axis
# mesh's (L0, L1) windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_scatter_kernel_equals_cpu_index_add(dev, dtype):
    """The segment sum bitwise the CPU's `index_add_` on the same rows, at
    the bench scale's node count (513^2, 6 channels, 2M clustered rows),
    and its reruns bitwise equal."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    rng = np.random.default_rng(7)
    nodes, m, c = 513 * 513, 2_000_000, 6
    flat = torch.from_numpy(rng.integers(0, nodes // 7, m) * 7 + rng.integers(0, 3, m))
    vals = torch.from_numpy(rng.normal(0.0, 1.0, (m, c)) * 10.0 ** rng.uniform(-5, 5, (m, 1)))
    vals = vals.to(dtype)
    want = torch.zeros((nodes, c), dtype=dtype).index_add_(0, flat, vals)
    n0 = scatter.LAUNCHES["scatter"]
    fd, vd = flat.to(dev), vals.to(dev)
    got = scatter.scatter_add(vd, fd, nodes)
    again = scatter.scatter_add(vd, fd, nodes, scatter.segment_plan(fd, nodes))
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter"] == n0 + 2
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_scatter_plan_without_zero_rows_equals_cpu_index_add(dev, dtype):
    """A plan that leaves out rows of +-0 (the slab domain's inert slots:
    250,000 particles' zero rows on one node here) sums the rest to the
    CPU's `index_add_` over every row, bit for bit."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    rng = np.random.default_rng(8)
    nodes, m, c = 513 * 513, 2_000_000, 6
    flat = torch.from_numpy(rng.integers(0, nodes // 7, m) * 7 + rng.integers(0, 3, m))
    vals = torch.from_numpy(rng.normal(0.0, 1.0, (m, c)) * 10.0 ** rng.uniform(-5, 5, (m, 1)))
    zero = torch.zeros(m, dtype=torch.bool)
    zero[rng.choice(m, 250_000, replace=False)] = True
    flat = torch.where(zero, nodes // 2, flat)
    vals = torch.where(zero[:, None], -0.0, vals).to(dtype)
    want = torch.zeros((nodes, c), dtype=dtype).index_add_(0, flat, vals)
    fd, vd = flat.to(dev), vals.to(dev)
    got = scatter.scatter_add(vd, fd, nodes, scatter.segment_plan(fd, nodes, ~zero.to(dev)))
    assert torch.equal(got.cpu(), want)


def _stencil_rows(dim, dtype, seed, n, dense=0):
    """(values (N, 3^dim, 5), base (N, dim), grid shape): bases over the
    grid and past its walls (clipped taps, particles with none in bounds),
    rows of many magnitudes; `dense` of the particles at one point, spread
    over the indices."""
    rng = np.random.default_rng(seed)
    shape = (257, 257) if dim == 2 else (64, 64, 64)
    base = np.stack([rng.integers(-3, g + 1, n) for g in shape], axis=1)
    base[rng.choice(n, dense, replace=False)] = np.asarray(shape) // 2
    vals = rng.normal(0.0, 1.0, (n, 3**dim, 5)) * 10.0 ** rng.uniform(-5, 5, (n, 1, 1))
    return torch.from_numpy(vals).to(dtype), torch.from_numpy(base), shape


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_stencil_scatter_kernel_equals_cpu_index_add(dev, dtype, dim):
    """The stencil form (one key a particle, each node merging its 3^dim
    runs) bitwise the CPU's `index_add_` over the clipped rows, with a
    dense node (5,000 particles at one point), and its reruns bitwise
    equal."""
    from mpm_flip98a_tpu_torch.ops import weights
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    vals, base, shape = _stencil_rows(dim, dtype, 9 + dim, 300_000, dense=5_000)
    offsets = weights.stencil_offsets(dim)
    want = scatter.stencil_add_plain(vals, base, offsets, shape)
    n0 = scatter.LAUNCHES["scatter"]
    vd, bd = vals.to(dev), base.to(dev)
    got = scatter.stencil_add(vd, bd, offsets, shape)
    again = scatter.stencil_add(vd, bd, offsets, shape, scatter.stencil_plan(bd, shape))
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter"] == n0 + 2
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)


@pytest.mark.parametrize("dim", [2, 3])
def test_stencil_keys_kernel_equals_plain(dev, dim):
    """The plan's key kernel equal to its plain version, with and without
    keep, on bases past every wall."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    _, base, shape = _stencil_rows(dim, torch.float32, 39 + dim, 100_000)
    keep = torch.from_numpy(np.random.default_rng(40).random(len(base)) < 0.8)
    n0 = scatter.LAUNCHES["scatter_keys"]
    for k in (None, keep):
        want, cells = scatter.stencil_keys_plain(base, shape, k)
        got, got_cells = scatter.stencil_keys(base.to(dev), shape,
                                              None if k is None else k.to(dev))
        assert got_cells == cells and torch.equal(got.cpu(), want)
    assert scatter.LAUNCHES["scatter_keys"] == n0 + 2


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_stencil_scatter_with_keep_equals_cpu_index_add(dev, dtype, dim):
    """A stencil plan that leaves out particles of +-0 rows (the slab
    domain's inert slots: 50,000 at one point here) beside a dense node of
    kept particles: the CPU's `index_add_` over every row, bit for bit."""
    from mpm_flip98a_tpu_torch.ops import weights
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    vals, base, shape = _stencil_rows(dim, dtype, 19 + dim, 300_000, dense=3_000)
    rng = np.random.default_rng(29 + dim)
    inert = torch.zeros(len(base), dtype=torch.bool)
    inert[rng.choice(len(base), 50_000, replace=False)] = True
    base = torch.where(inert[:, None], torch.tensor([s // 3 for s in shape]), base)
    sign = torch.from_numpy(np.where(rng.random((len(base), 1, 1)) < 0.5, -0.0, 0.0))
    vals = torch.where(inert[:, None, None], sign.to(dtype), vals)
    offsets = weights.stencil_offsets(dim)
    want = scatter.stencil_add_plain(vals, base, offsets, shape)
    vd, bd = vals.to(dev), base.to(dev)
    got = scatter.stencil_add(vd, bd, offsets, shape,
                              scatter.stencil_plan(bd, shape, ~inert.to(dev)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dim", [2, 3])
def test_bf16_stencil_scatter_kernel_equals_plain(dev, dim):
    """The scatter's bf16 mode (each node's sum rounded to bf16 after every
    add) bitwise its plain version on the CPU (the sequential rounded sum,
    XLA's bf16 `.at[].add`), with a dense node (5,000 particles at one
    point); reruns bitwise; every launch the bf16 instance."""
    from mpm_flip98a_tpu_torch.ops import weights
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    vals, base, shape = _stencil_rows(dim, torch.bfloat16, 49 + dim, 100_000, dense=5_000)
    offsets = weights.stencil_offsets(dim)
    want = scatter.stencil_add_plain(vals, base, offsets, shape)
    scatter.reset_launches()
    vd, bd = vals.to(dev), base.to(dev)
    got = scatter.stencil_add(vd, bd, offsets, shape)
    again = scatter.stencil_add(vd, bd, offsets, shape, scatter.stencil_plan(bd, shape))
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter"] == scatter.MODE_LAUNCHES["bf16"] == 2
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    assert torch.equal(again.view(torch.int16), got.view(torch.int16))


def test_bf16_scatter_kernel_equals_plain_with_zero_rows(dev):
    """The one-tap form's bf16 mode with a plan leaving out 50,000 rows of
    +-0 on one node, beside clustered rows: bitwise the sequential rounded
    sum over every row."""
    from mpm_flip98a_tpu_torch.ops.cuda import scatter

    rng = np.random.default_rng(48)
    nodes, m, c = 257 * 257, 500_000, 6
    flat = torch.from_numpy(rng.integers(0, nodes // 7, m) * 7 + rng.integers(0, 3, m))
    vals = torch.from_numpy(rng.normal(0.0, 1.0, (m, c)) * 10.0 ** rng.uniform(-5, 5, (m, 1)))
    zero = torch.zeros(m, dtype=torch.bool)
    zero[rng.choice(m, 50_000, replace=False)] = True
    flat = torch.where(zero, nodes // 2, flat)
    vals = torch.where(zero[:, None], -0.0, vals).to(torch.bfloat16)
    want = scatter.scatter_add_plain(vals, flat, nodes)
    fd, vd = flat.to(dev), vals.to(dev)
    got = scatter.scatter_add(vd, fd, nodes, scatter.segment_plan(fd, nodes, ~zero.to(dev)))
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_bf16_general_path_on_the_card_equals_the_cpu(dev):
    """20 bf16 substeps of the stabilized FLIP set (F-bar's cell sums, the
    projection and momentum transfers: three scatters a substep) on the
    card bitwise the CPU's on every field: the scatters by the bf16 mode,
    the contractions and sums in float32 in a fixed order."""
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.ops.cuda import scatter
    from mpm_flip98a_tpu_torch.state import to_device

    p, scene = _perturbed_dam(np.float32, flip_blend=0.98, transfer=TransferKind.PIC,
                              use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0)
    p = dataclasses.replace(p, **{f.name: getattr(p, f.name).bfloat16()
                                  for f in dataclasses.fields(p)
                                  if getattr(p, f.name).dtype == torch.float32})
    scatter.reset_launches()
    got = stabilized.run(to_device(p, dev), scene, 20)
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter"] == scatter.MODE_LAUNCHES["bf16"] == 20 * 3
    want = stabilized.run(p, scene, 20)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name).cpu(), getattr(want, f.name)
        if w.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert g.dtype == w.dtype and torch.equal(g, w), f.name


def test_general_reruns_on_the_card_are_bitwise_equal(dev):
    """tests/test_determinism.py:22-37 on the card: two 100-substep float32
    runs of the 37^2 dam break with the stabilized switch set (F-bar's
    cell sums and the node transfer both scatter) bitwise equal, through
    the scatter kernel and no transfer kernel."""
    from mpm_flip98a_tpu_torch.models import stabilized
    from mpm_flip98a_tpu_torch.ops.cuda import scatter
    from mpm_flip98a_tpu_torch.state import to_device

    p, scene = _perturbed_dam(np.float32, flip_blend=0.98, transfer=TransferKind.PIC,
                              use_fbar=True, pressure_mixing_ratio=1.0)
    tk.reset_launches()
    scatter.reset_launches()
    runs = [stabilized.run(to_device(p, dev), scene, 100) for _ in range(2)]
    torch.cuda.synchronize()
    assert scatter.LAUNCHES["scatter"] == 2 * 100 * 3      # cells, projection, momentum
    assert not any(tk.LAUNCHES.values())
    for f in dataclasses.fields(runs[0]):
        assert torch.equal(getattr(runs[0], f.name), getattr(runs[1], f.name)), f.name


@pytest.mark.parametrize("apic,ext,tent", PREPPED_MODES, ids=PREPPED_IDS)
def test_p2g3d_halo1_kernel_matches_plain(dev, apic, ext, tent):
    """halo1 (G1 + 4 output rows, row j = target row j - 1) against the
    plain version per channel, reruns bitwise equal, rows 1 .. G1 bitwise
    the cropped mode's, and `fold_rows0_halo` of it against raw
    `p2g3d_grid`'s halo sums."""
    r, k, g = 24, 128, 24
    fields, _, counts = _prepped3d(r, k, g, apic, ext, seed=70, device=dev)
    dx = 0.4375 / (g - 5)
    kw = dict(apic=apic, ext=ext, tent=tent)
    n0 = tk3.LAUNCHES["p2g3d"]
    got = tk3.p2g3d(fields, counts, r, g, dx, halo1=True, **kw)
    again = tk3.p2g3d(fields, counts, r, g, dx, halo1=True, **kw)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d"] == n0 + 2
    want = tk3.p2g3d_plain(fields, counts, r, g, dx, halo1=True, **kw)
    assert got.shape == want.shape == (r, tk3.NT, g + 4, 11 if ext else 7, g)
    _close(got, want, axis=3)
    assert torch.equal(got, again)
    assert torch.equal(got[:, :, 1 : g + 1], tk3.p2g3d(fields, counts, r, g, dx, **kw))
    raw = tk3.p2g3d_grid(fields, counts, r, g, dx, raw=True, **kw)[0]
    _close(tk3.fold_rows0_halo(got), raw, axis=2)


@pytest.mark.parametrize("switches,n_sub", [((), 10), (tuple(dict(
    use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0, flip_blend=0.98,
    transfer=TransferKind.PIC).items()), 1)], ids=["fused", "stabilized"])
def test_two_axis_windows_match_plain(dev, switches, n_sub):
    """The 2 x 2 mesh's kernels on its (L0, L1) windows (32^3, 16 x 16
    pencils a window, positions local to each window on both axes): raw
    `p2g3d_grid` and `g2p3d` against their plain versions; then n_sub
    substeps of the two-axis run, card against CPU: x to 1e-6, v and C to
    REL of their scale, J to 1e-6, slot for slot.  G2P's C is held to one
    term's size, D^-1 dx |v|max, as its terms cancel (this file's rule).
    The stabilized set runs one substep: F-bar's nodal Jbar is 1 less a
    few ulps, so the sums' other order moves the pressure by parts in 1e5
    a substep (tests/test_torch_fast_domain3d.py says the same of the
    one-axis shards); an H100 80GB HBM3 at 700 W read v 2.5e-4 of its scale
    after 10."""
    from mpm_flip98a_tpu_torch.parallel import SlabMesh
    from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

    p, scene = scenes.dam_break_3d(num_grids=32, particles_per_axis=(16, 16, 20), dt=2e-5,
                                   **dict(switches))
    cfg = scene.cfg
    spec = fd3.FastDomain3DSpec.for_particles(cfg, (2, 2), p)
    gspec = spec.global_spec
    out = {}
    for where in (dev, torch.device("cpu")):
        mesh = SlabMesh(2, where, 2)
        b = fd3.distribute(p, cfg, spec, mesh)
        if where.type == "cuda":
            ctx = fd3.context(spec, mesh)
            x0s, x1s = fast3d._shifts(b, cfg, ctx)
            x0k, x1k = b.x0 - x0s, b.x1 - x1s
            if fast3d.uses_fused(scene):
                fields, counts, mask, state = fast3d.transfer_inputs(b, gspec, cfg, x0k, x1k)
            else:
                fields = fast3d.prepped_fields(b, scene, gspec, x0k, x1k)
                counts, state = fast3d.pencil_counts(b), None
                mask = fast3d._shaped(b.mask, gspec)
            kw = dict(shards=4, **fast3d.p2g_args(scene, raw=True))
            raw = tk3.p2g3d_grid(fields, counts, gspec.rows1, raw=True, **kw)
            want = tk3.p2g3d_raw_plain(fields, counts, **kw)
            assert raw.shape == (4, 16 + 4, 16 + 4, want.shape[3], 32)
            _close(raw, want, axis=3)
            grid = fast3d._grid_update(ctx.halo_sync(want), scene, ctx.row_index0(where),
                                       ctx.row_index1(where), None, ctx)
            dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
            g2p = [f(*fields[:3], mask, counts, grid, float(cfg.dx), dinv,
                     *(() if state is None else (state, float(cfg.flip_blend), float(cfg.dt))))
                   for f in (tk3.g2p3d, tk3.g2p3d_plain)]
            err = (g2p[0] - g2p[1]).abs().double().amax(dim=(0, 1, 3))
            scale = g2p[1].abs().double().amax(dim=(0, 1, 3))
            scale[6:15] = dinv * float(cfg.dx) * float(grid[:, :, :, :3].abs().max())  # C
            scale[15] = max(float(scale[15]), 1.0)                 # J or Jbar near 1
            assert bool((err <= REL * scale.clamp(min=1e-30)).all()), (err / scale).tolist()
            tk3.reset_launches()
        out[where.type] = fd3.make_run(scene, spec, mesh)(b, n_sub)
        if where.type == "cuda":
            assert tk3.LAUNCHES["p2g3d_grid"] == tk3.LAUNCHES["g2p3d"] == n_sub
    got, want = out["cuda"], out["cpu"]
    assert int(got.overflow.sum()) == 0
    np.testing.assert_array_equal(got.mask.cpu().numpy(), want.mask.numpy())
    for name in ("x0", "x1", "x2"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(), getattr(want, name).numpy(),
                                   atol=1e-6)
    for group, tol in ((("v0", "v1", "v2"), REL),
                       (tuple(f"C{a}{c}" for a in range(3) for c in range(3)), REL),
                       (("J",), None)):
        have = torch.stack([getattr(got, g).cpu() for g in group]).double()
        ref = torch.stack([getattr(want, g) for g in group]).double()
        bound = 1e-6 if tol is None else tol * float(ref.abs().max())
        assert float((have - ref).abs().max()) <= bound, group


# ---------------------------------------------------------------------------
# The fully fused 2D substep's modes: p2g_grid(raw=False), g2p(update=True),
# and p2g3d's stress mode.
# ---------------------------------------------------------------------------


def _colliders2d(g, dx):
    """A slip sphere, a sticky box moving with a surface velocity and a
    halfspace spinner over the grid of `_inputs` (node x = (idx - 2) dx)."""
    from mpm_flip98a_tpu_torch.models.colliders import Collider

    l = (g - 5) * dx
    return (
        Collider(kind="sphere", center=(0.3 * l, 0.3 * l), radius=0.2 * l),
        Collider(kind="box", center=(0.6 * l, 0.6 * l), half_extents=(0.1 * l, 0.2 * l),
                 sticky=True, velocity=(0.1, -0.2), center_velocity=(0.5, 1.0)),
        Collider(kind="halfspace", center=(0.0, 0.9 * l), normal=(0.3, 1.0), angular=(3.0,)),
    )


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513)], ids=["small", "g513"])
@pytest.mark.parametrize("mode", ["fused", "ch9", "ch6_tent"])
@pytest.mark.parametrize("wall", ["slip", "sticky", "penalty", "colliders"])
def test_p2g_grid_finished_kernel_matches_plain(dev, shape, mode, wall):
    """The non-raw mode: one call, two launches, against the plain version
    per channel; pad rows exactly zero; reruns bitwise equal; the node pass
    of the kernel's own raw sums (grid_update2d_plain) to REL."""
    r, k, g = shape
    sdata, pdata2, counts, _ = _inputs(r, k, g, seed=90 + r, device=dev)
    dx = 0.4375 / (g - 5)
    if mode == "fused":
        data = sdata
        kw = dict(fused=True, apic=True, eos="tait", kb=KB, mu=MU, gamma=GAMMA,
                  fa=-2e-5 * 4.0 / dx**2)
    else:
        nch = 9 if mode == "ch9" else 6
        rng = np.random.default_rng(9)
        vals = torch.as_tensor(rng.normal(0.0, 1.0, (r, 6 + nch, k)), dtype=torch.float32,
                               device=dev) * pdata2[:, 2:3]
        vals[:, 10] = sdata[:, 9]                  # m
        if nch == 9:   # V0 J, V0 > 0: Jbar, p and div are averages over V0
            vals[:, 11] = sdata[:, 10] * sdata[:, 8]
            vals[:, 12] = sdata[:, 10]
            vals[:, 13:15] *= sdata[:, 10:11]
        data = torch.cat([sdata[:, :2], vals], dim=1).contiguous()
        kw = dict(fused=False, tent=mode.endswith("tent"), apic=False)
    node = dict(dt=2e-5, gx_=-9.81, gy_=0.7, floor=1e-3, lo=2, hi=g - 3,
                wall="slip" if wall == "colliders" else wall,
                beta=1e6 * 997.5 * dx**2 if wall == "penalty" else 0.0)
    if wall == "colliders":
        node.update(colliders=_colliders2d(g, dx), tcol=0.0125)
    n0 = tk.LAUNCHES["p2g_grid"]
    got = tk.p2g_grid(data, counts, g, dx, **kw, **node)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2g_grid"] == n0 + 1
    want = tk.p2g_grid_plain(data, counts, g, dx, **kw, **node)
    assert got.shape == want.shape == (r + 4, 7 if mode == "ch9" else 4, g)
    assert not got[0].any() and not got[r + 1 :].any()
    _close(got, want, axis=1)
    raw = tk.p2g_grid(data, counts, g, dx, raw=True, **kw)[0]
    _close(got, tk.grid_update2d_plain(raw, r, **node, dx=dx), axis=1)
    assert torch.equal(got, tk.p2g_grid(data, counts, g, dx, **kw, **node))


@pytest.mark.parametrize("shape", [(16, 256, 37), (40, 1024, 513)], ids=["small", "g513"])
@pytest.mark.parametrize("layout", ["unpadded", "prepadded", "shards4"])
@pytest.mark.parametrize("tent", [False, True], ids=["bspline", "tent"])
def test_g2p_update_kernel_matches_plain(dev, shape, layout, tent):
    r, k, g = shape
    sdata, pdata2, counts, grid4 = _inputs(r, k, g, seed=95 + r, device=dev)
    dx = 0.4375 / (g - 5)
    dinv = 1.0 if tent else 4.0 / dx**2
    x = torch.rand((2, r, k), device=dev)
    pdata8 = torch.cat([pdata2, sdata[:, 2:4], sdata[:, 8:9], x.permute(1, 0, 2)], dim=1)
    if layout == "unpadded":
        grid, pre = grid4, False
    else:
        n = 1 if layout == "prepadded" else 4
        l = r // n
        pdata8[:, 0] -= (torch.arange(r, device=dev) // l * l).to(torch.float32)[:, None]
        grid, pre = torch.randn((n, l + 4, 4, g), device=dev), True
    pdata8 = pdata8.contiguous()
    kw = dict(prepadded=pre, update=True, alpha=0.98, dtv=2e-5)
    n0 = tk.LAUNCHES["g2p"]
    got = tk.g2p(pdata8, counts, grid, dx, dinv, tent, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["g2p"] == n0 + 1 and got.shape == (r, 9, k)
    want = tk.g2p_plain(pdata8, counts, grid, dx, dinv, tent, **kw)
    _close(got, want, axis=1)
    dead = torch.arange(k, device=dev)[None, :] >= counts[:, None]
    assert torch.equal(got[:, :2].transpose(0, 1)[:, dead], pdata8[:, 6:8].transpose(0, 1)[:, dead])
    assert not got[:, 2:8].transpose(0, 1)[:, dead].any()
    assert bool((got[:, 8][dead] == 1.0).all())
    assert torch.equal(got, tk.g2p(pdata8, counts, grid, dx, dinv, tent, **kw))


@pytest.mark.parametrize("shape", [(16, 128, 16), (64, 128, 64), (8, 128, 2049)],
                         ids=["small", "g64", "g2049_bands"])
@pytest.mark.parametrize("apic", [False, True], ids=["pic", "apic"])
@pytest.mark.parametrize("stress", ["linear", "tait"])
def test_p2g3d_stress_kernel_matches_plain(dev, shape, apic, stress):
    r, k, g = shape
    planes, _, counts = _inputs3d(r, k, g, seed=r + 3 * apic, device=dev)
    dx = 0.4375 / (g - 5)
    kw = dict(apic=apic, stress=stress, kb=KB, mu=MU, gamma=GAMMA, fa=-2e-5 * 4.0 / dx**2)
    n0 = tk3.LAUNCHES["p2g3d"]
    got = tk3.p2g3d(planes, counts, r, g, dx, **kw)
    torch.cuda.synchronize()
    assert tk3.LAUNCHES["p2g3d"] == n0 + 1
    assert got.shape == (r, 5, r, 7, g)
    _close(got, tk3.p2g3d_plain(planes, counts, r, g, dx, **kw), axis=3)
    assert torch.equal(got, tk3.p2g3d(planes, counts, r, g, dx, **kw))
    halo = tk3.p2g3d(planes, counts, r, g, dx, halo1=True, **kw)
    raw = tk3.p2g3d_raw_plain(planes, counts, g, dx, **kw)
    _close(tk3.fold_rows0_halo(halo), raw, axis=2)


@pytest.mark.parametrize("setting", [("1", "0"), ("0", "1"), ("1", "1")],
                         ids=["p2g_grid", "fuse_g2p", "both"])
def test_fused2d_substeps_on_the_card_track_the_cpu(dev, monkeypatch, setting):
    """The fully fused 2D routes: 100 substeps on the card against the
    CPU's under the same variables, x to 1e-5; the kernels launched once a
    substep, the default route's p2g_fused not at all under P2G_GRID."""
    monkeypatch.setenv("MPM_P2G_GRID", setting[0])
    monkeypatch.setenv("MPM_FUSE2D_G2P", setting[1])
    cfg = MPMConfig(dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
                    num_particles_y=32, flip_blend=0.98, transfer=TransferKind.PIC)
    p, scene = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec = fast2d.FastSpec.for_particles(cfg, p, headroom=2.0)
    tk.reset_launches()
    out = fast2d.run(fast2d.from_particles(p, cfg, spec, dev), scene, spec, 100)
    grid = setting[0] == "1"
    assert tk.LAUNCHES == {"p2g_fused": 0 if grid else 100, "p2g": 0,
                           "p2g_grid": 100 if grid else 0, "g2p": 100}
    ref = fast2d.run(fast2d.from_particles(p, cfg, spec, device="cpu"), scene, spec, 100)
    for name in ("x0", "x1"):
        np.testing.assert_allclose(getattr(out, name).cpu().numpy(),
                                   getattr(ref, name).numpy(), atol=1e-5)
    assert int(out.overflow) == 0
