"""The port's prepped 3D transfers against the JAX Pallas kernels.

`p2g3d` (the expanded P2G of prepped fields), `p2g3d_grid` in its prepped
mode with the extended channels and the tent taps, and `g2p3d` in gather
mode.  On the CPU the port's wrappers run their plain PyTorch versions
(the CUDA kernels need the card: tests/test_torch_cuda.py); the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them.  Each JAX call costs seconds on the CPU (a `g2p3d` 20-35 s), so the
module caches them.  The extended grid with the penalty wall and its
padded gather are cases of tests/test_torch_stabilized3d.py, on this
module's slots and checks: that gather is the program the dam's F-bar
substep compiles, and there the two share one compile.  The tent taps'
cases are in tests/test_torch_p2g3d_tent.py: none of their JAX compiles
serves a case here, and each file stays inside its share of the suite's
time.  Inputs are random pencil slots from a numpy seed: empty,
partly filled and full pencils, slots outside the +-1 margin on both
bucketed axes, slots on the axis-1 edges (whose taps `p2g3d` drops and
`p2g3d_grid` keeps in its pad rows), z past both grid edges.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.ops.pallas import transfer3d as tk3_jax
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

R, K, G = 16, 128, 16
DX = 0.4375 / 11
DINV = 4.0 * (1.0 / DX) * (1.0 / DX)   # fast3d's dinv, bit for bit
DT = 2e-5
GRAV = (0.0, 0.0, -9.81)
# fp32 sums in another order: 1e-6 of each channel's max.
REL = 1e-6
MODES = {   # name: (apic, ext, tent)
    "apic7": (True, False, False),
    "pic11": (False, True, False),
    "pic11_tent": (False, True, True),
}
GRID_CASES = {   # name: (mode, wall)
    "ext_penalty": ("pic11", "penalty"),
    "tent_slip": ("pic11_tent", "slip"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed=0):
    """gx (3), the live mask, counts (R * R,) and a dict of value planes
    (R, R, K) f32, masked to the live slots."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, (R, R))
    counts[0, :3] = 0            # empty pencils
    counts[5, 5] = K             # a full pencil
    counts[:, 0] = K // 2        # both axis-1 edges: taps leave [0, G1)
    counts[:, R - 1] = K // 2
    rel0 = rng.choice([-1, 0, 0, 0, 1, -2, 2], size=(R, R, K))   # +-2: outside
    rel1 = rng.choice([-1, 0, 0, 0, 1, 2], size=(R, R, K))
    gx0 = np.arange(R)[:, None, None] + rel0 + 0.5 + rng.random((R, R, K))
    gx1 = np.arange(R)[None, :, None] + rel1 + 0.5 + rng.random((R, R, K))
    gx2 = rng.uniform(-1.0, G + 1.0, (R, R, K))                  # past both edges
    live = np.arange(K) < counts[..., None]
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, R, K)), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, (R, R, K)), 0.0)
    f32 = lambda a: np.asarray(a, np.float32)
    vals = dict(
        mv=[f32(mass * rng.normal(0.0, 1.0, (R, R, K))) for _ in range(3)],
        p=[f32(mass * rng.normal(0.0, 5.0, (R, R, K))) for _ in range(9)],
        q=[f32(live * rng.normal(0.0, 5.0, (R, R, K))) for _ in range(9)],
        m=f32(mass),
        ext=[f32(vol0 * rng.uniform(0.9, 1.1, (R, R, K))), f32(vol0),
             f32(vol0 * rng.normal(0.0, 2e3, (R, R, K))),
             f32(vol0 * rng.normal(0.0, 5.0, (R, R, K)))],
    )
    return [f32(gx0), f32(gx1), f32(gx2)], live, counts.reshape(-1).astype(np.int32), vals


GXS, LIVE, COUNTS, VALS = _slots()


def _fields(mode):
    apic, ext, _ = MODES[mode]
    return [*GXS, *VALS["mv"], *(VALS["p"] if apic else ()), *VALS["q"], VALS["m"],
            *(VALS["ext"] if ext else ())]


def _t(planes, dtype=torch.float32):
    return tuple(torch.from_numpy(np.asarray(p)).to(dtype) for p in planes)


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


def _node_kw(wall):
    beta = 1e6 * 997.5 * DX**2 if wall == "penalty" else 0.0
    return dict(dt=DT, grav=GRAV, floor=1e-8, lo=2, hi=G - 3, wall=wall, beta=beta)


@functools.lru_cache(maxsize=None)
def _jax_expanded(mode):
    apic, ext, tent = MODES[mode]
    return np.array(tk3_jax.p2g3d(
        _j(_fields(mode)), jnp.asarray(COUNTS), R, G, DX, apic=apic, ext=ext, tent=tent))


@functools.lru_cache(maxsize=None)
def _jax_grid(case):
    mode, wall = GRID_CASES[case]
    apic, ext, tent = MODES[mode]
    return np.array(tk3_jax.p2g3d_grid(
        _j(_fields(mode)), jnp.asarray(COUNTS), R, G, DX, apic=apic, ext=ext, tent=tent,
        **_node_kw(wall)))


def _close_per_channel(got, want, axis, rel=REL, scale=None):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        s = max(float(np.abs(b).max()), 1e-30) if scale is None else scale[ch]
        err = float(np.abs(a.astype(np.float64) - b).max())
        assert err <= rel * s, (ch, err, s)


def check_p2g3d(mode):
    """`p2g3d` against JAX's, 1e-6 of each channel's max."""
    apic, ext, tent = MODES[mode]
    want = _jax_expanded(mode)
    got = tk3.p2g3d(
        _t(_fields(mode)), torch.from_numpy(COUNTS), R, G, DX, apic=apic, ext=ext, tent=tent,
    ).numpy()
    nch = 11 if ext else 7
    assert got.shape == want.shape == (R, tk3.NT, G, nch, G)
    assert all(np.abs(want[:, :, :, ch]).max() > 0 for ch in range(nch))
    _close_per_channel(got, want, axis=3)
    if not apic:
        # PIC: the pure momentum carries no affine term (transfer3d.py:
        # 312-316), so it differs from the forced momentum by Q's part.
        assert np.abs(got[:, :, :, 0] - got[:, :, :, 3]).max() > 0
    assert tk3.LAUNCHES["p2g3d"] == 0   # the CPU runs the plain version


# The tent taps' cases of this file are in tests/test_torch_p2g3d_tent.py.
TENT_MODES = ("pic11_tent",)


@pytest.mark.parametrize("mode", [m for m in MODES if m not in TENT_MODES])
def test_p2g3d_matches_jax(mode):
    check_p2g3d(mode)


def test_p2g3d_against_float64():
    apic, ext, tent = MODES["apic7"]
    counts = torch.from_numpy(COUNTS)
    got = tk3.p2g3d_plain(_t(_fields("apic7")), counts, R, G, DX, apic, ext, tent).numpy()
    exact = tk3.p2g3d_plain(
        _t(_fields("apic7"), torch.float64), counts, R, G, DX, apic, ext, tent).numpy()
    _close_per_channel(got, exact, axis=3)
    _close_per_channel(_jax_expanded("apic7"), exact, axis=3)


def check_p2g3d_grid_prepped(case):
    """`p2g3d_grid`'s prepped mode against JAX's (1e-6 of each channel's
    max) and against its own float64 sums; the pad rows as JAX has them."""
    mode, wall = GRID_CASES[case]
    apic, ext, tent = MODES[mode]
    want = _jax_grid(case)
    got = tk3.p2g3d_grid(
        _t(_fields(mode)), torch.from_numpy(COUNTS), R, G, DX, apic=apic, ext=ext, tent=tent,
        **_node_kw(wall),
    ).numpy()
    assert got.shape == want.shape == (R + 4, R + 4, tk3.G2P_CH_EXT, G)
    # Axis-0 pad rows are zero (Jbar's default 1 stays off them); the
    # axis-1 pad rows carry the edge pencils' taps in both packages.
    assert not want[0].any() and not want[R + 1 :].any()
    assert np.abs(want[:, 0]).max() > 0 and np.abs(want[:, R + 1]).max() > 0
    assert (want[1 : R + 1, :, 6] == 1.0).any()
    _close_per_channel(got, want, axis=2)
    exact = tk3.p2g3d_grid_plain(
        _t(_fields(mode), torch.float64), torch.from_numpy(COUNTS), R, G, DX, apic=apic,
        ext=ext, tent=tent, **_node_kw(wall),
    ).numpy()
    _close_per_channel(got, exact, axis=2)
    assert tk3.LAUNCHES["p2g3d_grid"] == 0


G2P_CASES = {   # name: (grid, tent, rows kept of the padded grid)
    "gather_unpadded": ("random6", False, (slice(1, R + 1), slice(1, R + 1))),
    "ext_padded": ("ext_penalty", False, (slice(None), slice(None))),
    "ext_tent_padded0": ("tent_slip", True, (slice(None), slice(1, R + 1))),
}


def _g2p_grid(name):
    if name == "random6":
        return np.random.default_rng(11).normal(0.0, 1.0, (R + 4, R + 4, 6, G)).astype(np.float32)
    return _jax_grid(name)


@functools.lru_cache(maxsize=None)
def _jax_gather(case):
    name, tent, keep = G2P_CASES[case]
    grid = _g2p_grid(name)[keep]
    return np.asarray(tk3_jax.g2p3d(
        *_j(GXS), jnp.asarray(LIVE.astype(np.float32)), jnp.asarray(COUNTS), jnp.asarray(grid),
        DX, 1.0 if tent else DINV, ext=grid.shape[2] == 9,
        prepadded0=grid.shape[0] == R + 4, prepadded1=grid.shape[1] == R + 4, tent=tent,
    ))


def check_g2p3d_gather(case):
    """`g2p3d`'s gather mode against JAX's and against its own float64
    gather, per channel; slots past the count are zeros."""
    name, tent, keep = G2P_CASES[case]
    grid = _g2p_grid(name)[keep]
    dinv = 1.0 if tent else DINV
    want = _jax_gather(case)
    ins = (*_t(GXS), torch.from_numpy(LIVE.astype(np.float32)), torch.from_numpy(COUNTS))
    grid_t = torch.from_numpy(np.ascontiguousarray(grid))
    got = tk3.g2p3d(*ins, grid_t, DX, dinv, tent=tent).numpy()
    nout = 15 + grid.shape[2] - 6
    assert got.shape == want.shape == (R, R, nout, K)
    # v and the gathered averages per channel; C sums +-(x_node - x_p)
    # terms that cancel, so its error is scaled by one term's size,
    # D^-1 dx |v_new|max.
    c_unit = dinv * DX * np.abs(grid[:, :, :3]).max()
    scale = [max(float(np.abs(want[:, :, ch]).max()), 1e-30) for ch in range(nout)]
    scale[6:15] = [c_unit] * 9
    _close_per_channel(got, want, axis=2, scale=scale)
    exact = tk3.g2p3d_plain(
        *(a.double() for a in ins[:4]), ins[4], grid_t.double(), DX, dinv, tent=tent,
    ).numpy()
    _close_per_channel(got, exact, axis=2, scale=scale)
    # Slots past the count: zeros in every channel (not the update mode's
    # dead fill).
    assert not np.moveaxis(got, 2, 0)[:, ~LIVE].any()
    assert not np.moveaxis(want, 2, 0)[:, ~LIVE].any()
    assert tk3.LAUNCHES["g2p3d"] == 0


# "ext_penalty" and its gather "ext_padded" are in tests/test_torch_stabilized3d.py,
# "tent_slip" and its gather "ext_tent_padded0" in tests/test_torch_p2g3d_tent.py.
@pytest.mark.parametrize("case", ["gather_unpadded"])
def test_g2p3d_gather_matches_jax(case):
    check_g2p3d_gather(case)


def _shares():
    """float64 share of each live in-margin slot's weight that stays
    inside the grid along z and along axis 1 (B-spline)."""
    gx0, gx1, gx2 = (p.astype(np.float64) for p in GXS)
    rows = np.arange(R)
    in_margin = (
        (np.abs(np.floor(gx0 - 0.5) - rows[:, None, None]) <= 1)
        & (np.abs(np.floor(gx1 - 0.5) - rows[None, :, None]) <= 1) & LIVE
    )

    def share(gx, n):
        base = np.floor(gx - 0.5)
        fx = gx - base
        taps = np.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1) ** 2, 0.5 * (fx - 0.5) ** 2])
        cols = base[None] + np.arange(3)[:, None, None, None]
        return (taps * ((cols >= 0) & (cols < n))).sum(0)

    return in_margin, share(gx2, G), share(gx1, G)


@pytest.mark.parametrize("route", ["p2g3d", "p2g3d_grid"])
def test_partition_of_unity(route):
    """The mass and V0 channels hold the live in-margin slots' mass and
    volume: all of it where a slot's taps lie inside the grid, the
    in-range taps' share at the z edges and, for `p2g3d` (which drops
    them), at the axis-1 edges."""
    apic, ext, tent = MODES["pic11"]
    f, counts = _t(_fields("pic11")), torch.from_numpy(COUNTS)
    in_margin, share2, share1 = _shares()
    if route == "p2g3d":
        out = tk3.p2g3d_plain(f, counts, R, G, DX, apic, ext, tent).numpy()
        sums = out.astype(np.float64).sum(axis=(0, 1, 2, 4))
        share = share2 * share1
        assert (share1 * in_margin < in_margin).any()    # some axis-1 taps do fall off
    else:
        out = tk3.p2g3d_raw_plain(f, counts, G, DX, apic=apic, ext=ext).numpy()
        sums = out.astype(np.float64).sum(axis=(0, 1, 3))
        share = share2
    for ch, plane in ((6, VALS["m"]), (8, VALS["ext"][1])):
        expect = (plane.astype(np.float64) * share * in_margin).sum()
        assert 0 < expect < (plane.astype(np.float64) * in_margin).sum()
        np.testing.assert_allclose(sums[ch], expect, rtol=1e-6)


def check_fold_of_expanded(mode):
    """`fold_rows0(p2g3d)` equals `p2g3d_grid`'s raw sums on the interior
    rows of both axes (tests/test_p2g_grid.py:168-212 on the JAX side):
    the routes differ only in the axis-1 pad rows."""
    apic, ext, tent = MODES[mode]
    f, counts = _t(_fields(mode)), torch.from_numpy(COUNTS)
    folded = tk3.fold_rows0(tk3.p2g3d_plain(f, counts, R, G, DX, apic, ext, tent)).numpy()
    raw = tk3.p2g3d_raw_plain(f, counts, G, DX, apic=apic, tent=tent, ext=ext).numpy()
    assert folded.shape == (R, R, 11 if ext else 7, G)
    _close_per_channel(folded, raw[1 : R + 1, 1 : R + 1], axis=2)
    assert np.abs(raw[:, [0, R + 1]]).max() > 0     # what the fold route drops
    # And the JAX fold of the JAX expansion, bit for bit by the same adds.
    want = np.asarray(tk3_jax.fold_rows0(jnp.asarray(_jax_expanded(mode))))
    got = tk3.fold_rows0(torch.from_numpy(_jax_expanded(mode))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [m for m in MODES if m not in TENT_MODES])
def test_fold_of_expanded_is_interior_of_raw_sums(mode):
    check_fold_of_expanded(mode)


def test_wrappers_check_their_inputs():
    counts = torch.from_numpy(COUNTS)
    f7, f11 = _t(_fields("apic7")), _t(_fields("pic11"))
    assert len(f7) == tk3.n_prepped(True, False) == 25
    assert len(f11) == tk3.n_prepped(False, True) == 20
    with pytest.raises(ValueError):                    # PIC has no P planes
        tk3.p2g3d(f7, counts, R, G, DX, apic=False)
    with pytest.raises(ValueError):                    # ext needs its 4 planes
        tk3.p2g3d(f7, counts, R, G, DX, apic=True, ext=True)
    with pytest.raises(TypeError):
        tk3.p2g3d((f7[0].double(),) + f7[1:], counts, R, G, DX)
    with pytest.raises(ValueError):                    # K not the unit-stride axis
        tk3.p2g3d((f7[0].transpose(1, 2).contiguous().transpose(1, 2),) + f7[1:], counts, R, G, DX)
    with pytest.raises(TypeError):
        tk3.p2g3d(f7, counts.long(), R, G, DX)
    with pytest.raises(ValueError):                    # no kernel, no plain route
        tk3.p2g3d(tuple(p.to("meta") for p in f7), counts.to("meta"), R, G, DX)
    node = _node_kw("slip")
    with pytest.raises(ValueError):
        tk3.p2g3d_grid(f11, counts, R, G, DX, apic=False, ext=False, **node)
    with pytest.raises(ValueError):                    # stress mode has no ext / tent form
        tk3.p2g3d_grid(f11[:18], counts, R, G, DX, stress="linear", tent=True, **node)
    with pytest.raises(ValueError):
        tk3.p2g3d_grid(f11, counts, R, G, DX, apic=False, ext=True, **{**node, "wall": "soft"})
    grid = torch.zeros((R + 4, R + 4, 9, G))
    ins = (*f7[:3], torch.from_numpy(LIVE.astype(np.float32)), counts)
    with pytest.raises(ValueError):                    # rows neither padded nor unpadded
        tk3.g2p3d(*ins, grid[1:], DX, DINV)
    with pytest.raises(ValueError):                    # 6 or 9 channels
        tk3.g2p3d(*ins, grid[:, :, :7], DX, DINV)
    with pytest.raises(ValueError):                    # update mode: 6 channels, B-spline
        tk3.g2p3d(*ins, grid, DX, DINV, f7[3:6] + (f7[0],) + f7[:3], 0.98, DT)
    with pytest.raises(TypeError):
        tk3.g2p3d(*ins, grid.double(), DX, DINV)


@pytest.mark.parametrize("gone", ["dt", "floor", "wall"])
def test_p2g3d_grid_needs_the_node_arguments(gone):
    """The grid update's arguments are required outside the raw mode,
    which takes none."""
    counts = torch.from_numpy(COUNTS)
    f11 = _t(_fields("pic11"))
    node = {n: v for n, v in _node_kw("slip").items() if n != gone}
    with pytest.raises(TypeError, match=f"needs {gone}"):
        tk3.p2g3d_grid(f11, counts, R, G, DX, apic=False, ext=True, **node)
    raw = tk3.p2g3d_grid(f11, counts, R, G, DX, apic=False, ext=True, raw=True)
    assert raw.shape == (1, R + 4, R + 4, tk3.P2G_CH_EXT, G)


def test_unported_modes_raise():
    """Every mode is ported: `halo1` (test_p2g3d_halo1_matches_jax) and the
    stress mode (tests/test_torch_p2g3d_stress.py) run; the stress mode
    has no ext or tent form."""
    counts = torch.from_numpy(COUNTS)
    f7, f11 = _t(_fields("apic7")), _t(_fields("pic11"))
    assert tk3.p2g3d(f7, counts, R, G, DX, halo1=True).shape == (R, tk3.NT, G + 4, 7, G)
    assert tk3.p2g3d(f7[:18], counts, R, G, DX, stress="linear").shape == (R, tk3.NT, G, 7, G)
    with pytest.raises(ValueError, match="no ext or tent"):
        tk3.p2g3d(f7[:18], counts, R, G, DX, stress="tait", tent=True)


@functools.lru_cache(maxsize=None)
def _jax_halo1(mode):
    apic, ext, tent = MODES[mode]
    return np.array(tk3_jax.p2g3d(
        _j(_fields(mode)), jnp.asarray(COUNTS), R, G, DX, apic=apic, ext=ext, tent=tent,
        halo1=True))


def check_p2g3d_halo1(mode):
    """halo1 (transfer3d.py:366-372): the axis-1 plane uncropped, row j =
    target row j - 1, to 1e-6 of each channel's max; its rows 1 .. G are
    the cropped mode's output bit for bit, and the edge rows hold the taps
    that mode drops (this file's slots sit on both axis-1 edges)."""
    apic, ext, tent = MODES[mode]
    want = _jax_halo1(mode)
    args = (_t(_fields(mode)), torch.from_numpy(COUNTS), R, G, DX)
    kw = dict(apic=apic, ext=ext, tent=tent)
    got = tk3.p2g3d(*args, **kw, halo1=True).numpy()
    nch = 11 if ext else 7
    assert got.shape == want.shape == (R, tk3.NT, G + 4, nch, G)
    _close_per_channel(got, want, axis=3)
    np.testing.assert_array_equal(got[:, :, 1 : G + 1], tk3.p2g3d(*args, **kw).numpy())
    assert np.abs(got[:, :, 0]).sum() > 0 and np.abs(got[:, :, G + 1 :]).sum() > 0


@pytest.mark.parametrize("mode", ["apic7"])
def test_p2g3d_halo1_matches_jax(mode):
    check_p2g3d_halo1(mode)


@pytest.mark.parametrize("mode", ["apic7", "pic11"])
def test_fold_rows0_halo_of_halo1_is_raw_p2g3d_grid(mode):
    """tests/test_p2g_grid.py:150-166's twin: `fold_rows0_halo` of the
    halo1 expanded sums is raw `p2g3d_grid`'s (R0 + 4, R1 + 4) halo sums,
    up to the order of the sums (1e-6 of each channel's max)."""
    apic, ext, _ = MODES[mode]
    args = (_t(_fields(mode)), torch.from_numpy(COUNTS))
    folded = tk3.fold_rows0_halo(tk3.p2g3d(*args, R, G, DX, apic=apic, ext=ext, halo1=True))
    raw = tk3.p2g3d_raw_plain(*args, G, DX, apic=apic, ext=ext)
    assert folded.shape == raw.shape == (R + 4, R + 4, 11 if ext else 7, G)
    _close_per_channel(folded.numpy(), raw.numpy(), axis=2)
    np.testing.assert_array_equal(tk3.fold_rows0_halo(tk3.p2g3d(*args, R, G, DX, apic=apic,
                                                                ext=ext))[1 : R + 1].numpy(),
                                  tk3.fold_rows0(tk3.p2g3d(*args, R, G, DX, apic=apic,
                                                           ext=ext)).numpy())
