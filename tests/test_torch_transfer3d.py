"""The port's 3D transfer functions against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels need the card: tests/test_torch_cuda.py); the JAX kernels run in
Pallas interpret mode, as the JAX package's own tests run them.  Each JAX
call costs seconds here, so the file makes four: `p2g3d_grid` in three
configurations and `g2p3d` once, on that grid.  Inputs are random pencil
slots from a numpy seed: empty, partly filled and full pencils, slots
outside the +-1 margin on both bucketed axes, z past both grid edges.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.ops.pallas import transfer3d as tk3_jax
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

R, K, G = 16, 128, 16
DX = 0.4375 / 11
DINV = 4.0 / DX**2
DT = 2e-5
GRAV = (0.0, 0.0, -9.81)
# fp32 sums in another order: 1e-6 of each channel's max.
REL = 1e-6
CASES = {   # (stress, apic, wall)
    "linear_pic_slip": ("linear", False, "slip"),
    "tait_apic_sticky": ("tait", True, "sticky"),
    "linear_pic_penalty": ("linear", False, "penalty"),
}
_JAX_GRIDS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed=0):
    """18 P2G planes (R, R, K) f32, the live mask and counts (R * R,)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, (R, R))
    counts[0, :3] = 0           # empty pencils
    counts[5, 5] = K            # a full pencil
    counts[:, 0] = K // 2       # the axis-1 edge: taps land in the pad rows
    rel0 = rng.choice([-1, 0, 0, 0, 1, -2, 2], size=(R, R, K))   # +-2: outside
    rel1 = rng.choice([-1, 0, 0, 0, 1, 2], size=(R, R, K))
    gx0 = np.arange(R)[:, None, None] + rel0 + 0.5 + rng.random((R, R, K))
    gx1 = np.arange(R)[None, :, None] + rel1 + 0.5 + rng.random((R, R, K))
    gx2 = rng.uniform(-1.0, G + 1.0, (R, R, K))                 # past both edges
    live = np.arange(K) < counts[..., None]
    v = rng.normal(0.0, 1.0, (3, R, R, K))
    c = rng.normal(0.0, 5.0, (9, R, R, K))
    # Dead slots are neutral (fast3d._safe_dead_slots): m = V0 = 0, J = 1.
    j = np.where(live, rng.uniform(0.9, 1.1, (R, R, K)), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, R, K)), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, (R, R, K)), 0.0)
    planes = [a.astype(np.float32) for a in (gx0, gx1, gx2, *v, *c, j, mass, vol0)]
    return planes, live, counts.reshape(-1).astype(np.int32)


PLANES, LIVE, COUNTS = _slots()


def _kw(case):
    stress, apic, wall = CASES[case]
    beta = 1e6 * 997.5 * DX**2 if wall == "penalty" else 0.0
    return (
        dict(apic=apic, stress=stress, kb=2e6, mu=1e-3, gamma=7.0, fa=-DT * DINV),
        dict(dt=DT, grav=GRAV, floor=1e-8, lo=2, hi=G - 3, wall=wall, beta=beta),
    )


def _jax_grid(case):
    """JAX `p2g3d_grid` on PLANES, once per case for the whole module."""
    if case not in _JAX_GRIDS:
        kw, gk = _kw(case)
        _JAX_GRIDS[case] = np.array(tk3_jax.p2g3d_grid(
            tuple(jnp.asarray(p) for p in PLANES), jnp.asarray(COUNTS), R, G, DX, **kw, **gk,
        ))
    return _JAX_GRIDS[case]


def _t(planes, dtype=torch.float32):
    return tuple(torch.from_numpy(p).to(dtype) for p in planes)


def _close_per_channel(got, want, axis, rel=REL, scale=None):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        s = max(float(np.abs(b).max()), 1e-30) if scale is None else scale[ch]
        err = float(np.abs(a.astype(np.float64) - b).max())
        assert err <= rel * s, (ch, err, s)


@pytest.mark.parametrize("case", list(CASES))
def test_p2g3d_grid_matches_jax(case):
    kw, gk = _kw(case)
    want = _jax_grid(case)
    got = tk3.p2g3d_grid(_t(PLANES), torch.from_numpy(COUNTS), R, G, DX, **kw, **gk).numpy()
    assert got.shape == want.shape == (R + 4, R + 4, tk3.G2P_CH, G)
    # The whole padded grid, pads included: axis-0 pad rows are zero, the
    # axis-1 pad rows carry the edge pencils' taps in both packages.
    assert not want[0].any() and not want[R + 1 :].any()
    assert np.abs(want[:, 0]).max() > 0
    _close_per_channel(got, want, axis=2)
    exact = tk3.p2g3d_grid_plain(
        _t(PLANES, torch.float64), torch.from_numpy(COUNTS), R, G, DX, **kw, **gk
    ).numpy()
    _close_per_channel(got, exact, axis=2)
    assert tk3.LAUNCHES["p2g3d_grid"] == 0   # the CPU runs the plain version


def test_g2p3d_update_matches_jax():
    grid = _jax_grid("linear_pic_slip")
    rng = np.random.default_rng(7)
    mask = LIVE.astype(np.float32)
    x = [(PLANES[a] - 2.0) * np.float32(DX) for a in range(3)]
    j = np.where(LIVE, rng.uniform(0.9, 1.1, LIVE.shape), 1.0).astype(np.float32)
    state = [*PLANES[3:6], j, *x]
    args = (DX, DINV)
    want = np.asarray(tk3_jax.g2p3d(
        *(jnp.asarray(p) for p in PLANES[:3]), jnp.asarray(mask), jnp.asarray(COUNTS),
        jnp.asarray(grid), *args, state=tuple(jnp.asarray(s) for s in state),
        alpha=0.98, dtv=DT, prepadded0=True, prepadded1=True,
    ))
    ins = (*_t(PLANES[:3]), torch.from_numpy(mask), torch.from_numpy(COUNTS))
    got = tk3.g2p3d(*ins, torch.from_numpy(grid), *args, _t(state), 0.98, DT).numpy()
    assert got.shape == want.shape == (R, R, tk3.G2P_UPD, K)
    # x and J absolute; v per channel; C sums +-(x_node - x_p) terms that
    # cancel, so its error is scaled by one term's size, D^-1 dx |v_new|max.
    for ch in (0, 1, 2, 15):
        np.testing.assert_allclose(got[:, :, ch], want[:, :, ch], rtol=0, atol=1e-6)
    _close_per_channel(got[:, :, 3:6], want[:, :, 3:6], axis=2)
    c_unit = DINV * DX * np.abs(grid[:, :, :3]).max()
    _close_per_channel(got[:, :, 6:15], want[:, :, 6:15], axis=2, scale=[c_unit] * 9)
    exact = tk3.g2p3d_plain(
        *(a.double() for a in ins[:4]), ins[4], torch.from_numpy(grid).double(), *args,
        _t(state, torch.float64), 0.98, DT,
    ).numpy()
    _close_per_channel(got[:, :, 3:15], exact[:, :, 3:15], axis=2)
    # Dead slots: x passed through, v = C = 0, J = 1.
    dead = np.moveaxis(got, 2, 0)[:, ~LIVE]
    np.testing.assert_array_equal(dead[:3], np.stack(x)[:, ~LIVE])
    assert not dead[3:15].any() and (dead[15] == 1).all()
    assert tk3.LAUNCHES["g2p3d"] == 0


def test_p2g3d_partition_of_unity():
    """The raw mass channel holds the mass of the live in-margin slots:
    all of it where a slot's 3 z taps lie inside the grid, the in-range
    taps' share (float64) at the z edges."""
    kw, _ = _kw("linear_pic_slip")
    raw = tk3.p2g3d_raw_plain(_t(PLANES), torch.from_numpy(COUNTS), G, DX, **kw).numpy()
    gx0, gx1, gx2 = (p.astype(np.float64) for p in PLANES[:3])
    mass = PLANES[16].astype(np.float64)
    rows = np.arange(R)
    in_margin = (
        (np.abs(np.floor(gx0 - 0.5) - rows[:, None, None]) <= 1)
        & (np.abs(np.floor(gx1 - 0.5) - rows[None, :, None]) <= 1) & LIVE
    )
    base2 = np.floor(gx2 - 0.5)
    fx = gx2 - base2
    taps = np.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1) ** 2, 0.5 * (fx - 0.5) ** 2])
    cols = base2[None] + np.arange(3)[:, None, None, None]
    share = (taps * ((cols >= 0) & (cols < G))).sum(0)
    expect = (mass * share * in_margin).sum()
    assert 0 < expect < (mass * in_margin).sum()   # some taps do fall off
    np.testing.assert_allclose(raw[:, :, 6].astype(np.float64).sum(), expect, rtol=1e-6)


def test_wrappers_check_their_inputs():
    planes, counts = _t(PLANES), torch.from_numpy(COUNTS)
    kw, gk = _kw("linear_pic_slip")
    call = lambda p, c=counts, **over: tk3.p2g3d_grid(
        p, c, R, G, DX, **{**kw, **gk, **over}
    )
    with pytest.raises(TypeError):
        call((planes[0].double(),) + planes[1:])
    with pytest.raises(ValueError):
        call(planes[:17])
    with pytest.raises(ValueError):
        call((planes[0][:, :, :64].contiguous(),) + planes[1:])
    with pytest.raises(ValueError):   # K not the unit-stride axis
        call((planes[0].transpose(1, 2).contiguous().transpose(1, 2),) + planes[1:])
    with pytest.raises(TypeError):
        call(planes, counts.long())
    with pytest.raises(ValueError):
        call(planes, stress="stiff")
    # A device with no kernel and no plain route raises instead of falling back.
    with pytest.raises(ValueError):
        call(tuple(p.to("meta") for p in planes), counts.to("meta"))
    grid = torch.zeros((R + 4, R + 4, tk3.G2P_CH, G))
    state = planes[3:6] + (planes[15],) + planes[:3]
    with pytest.raises(ValueError):   # the grid must be padded on both axes
        tk3.g2p3d(*planes[:4], counts, grid[2:], DX, DINV, state, 0.98, DT)
    with pytest.raises(ValueError):
        tk3.g2p3d(*planes[:4], counts, grid.to("meta"), DX, DINV, state, 0.98, DT)
    # A channel view of a (R, R, 16, K) output is a valid plane.
    out = torch.zeros((R, R, tk3.G2P_UPD, K))
    assert tk3._check_plane("x0", out[:, :, 0], (R, R, K)) == tk3.G2P_UPD * K
