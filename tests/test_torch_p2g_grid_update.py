"""The port's `p2g_grid` in its non-raw mode and `g2p` in its update mode
against the JAX Pallas kernels: the two kernel modes of the fully fused 2D
substep (MPM_P2G_GRID=1, MPM_FUSE2D_G2P=1).

`p2g_grid(raw=False)` folds P2G on one device and finishes every node in
the kernel (mass floor, gravity, slip / sticky walls or the penalty's
diagonal solve, rigid colliders, the nodal Jbar, p and div) into the
g2p-ready (R + 4, 4 or 7, G) grid; `g2p(update=True)` gathers and then
applies the FLIP blend, advection and the J update.  On the CPU the
port's wrappers run their plain PyTorch versions (the CUDA kernels need
the card: tests/test_torch_cuda.py); the JAX kernels run in Pallas
interpret mode, one cached call per case.  Inputs are random bucketed
slots from a numpy seed with ragged counts, rows outside the +-1 margin
and columns past both grid edges (tests/test_torch_p2g_grid.py's).

Tolerances (ROADMAP queue 3): the JAX kernels fold the column-affine term
(c - gx1) dx as a rank-1 correction that cancels, so the channels that
carry it (v_new, and v_old under APIC) get 1e-5 of the channel max and
the others 1e-6; G2P's C01 and C11 get 1e-5 of one column term, dinv dx
|v|max.  Pad rows, and the dead slots of the update mode, are exact.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.models import colliders as col_jax
from mpm_flip98a_tpu.ops.pallas import transfer2d as tk_jax
from mpm_flip98a_tpu_torch.models import colliders as col
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

R, K, G = 16, 256, 37
DX = 0.4375 / 32
DINV = 4.0 / DX**2
DT = 2e-5
REL = 1e-6
FOLD_REL = 1e-5
FLUID = dict(kb=2.0e5, mu=1e-3, gamma=7.0, fa=-DT * DINV)
FUSED = {   # name: (apic, eos)
    "pic_linear": (False, "linear"),
    "pic_tait": (False, "tait"),
    "apic_linear": (True, "linear"),
    "apic_tait": (True, "tait"),
}
PREPPED = {   # name: (nch, tent)
    "ch6_bspline": (6, False),
    "ch9_bspline": (9, False),
    "ch6_tent": (6, True),
    "ch9_tent": (9, True),
}
# Node coordinates x = (idx - 2) dx: rows span [-0.03, 0.18], columns
# [-0.03, 0.46].
COLLIDERS = {   # name: (colliders, tcol)
    "sphere": ((dict(kind="sphere", center=(0.08, 0.2), radius=0.05),), None),
    "box": ((dict(kind="box", center=(0.1, 0.32), half_extents=(0.03, 0.05), sticky=True,
                  velocity=(0.1, -0.2)),), None),
    "halfspace": ((dict(kind="halfspace", center=(0.0, 0.4), normal=(0.3, 1.0),
                        angular=(3.0,)),), None),
    "moving": ((dict(kind="sphere", center=(0.05, 0.12), radius=0.04,
                     center_velocity=(0.5, 1.5), angular=(-2.0,)),
                dict(kind="box", center=(0.12, 0.25), half_extents=(0.02, 0.06))), 0.0125),
}
NODE = dict(dt=DT, gx_=-9.81, gy_=0.7, floor=1e-3, lo=2, hi=G - 3)
WALLS = {"slip": 0.0, "sticky": 0.0, "penalty": 1e6 * 997.5 * DX**2}
ALPHA = 0.98


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed, r=R):
    """Random (r, K) slot planes: gx0, gx1, live mask, counts; no slot
    reaches columns 21-23."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, r).astype(np.int32)
    counts[[2, 7]] = 0          # empty rows
    counts[5] = K               # a full row
    rel = rng.choice([-1, 0, 0, 0, 1, -2, 2], size=(r, K))   # +-2: outside the margin
    gx0 = np.arange(r)[:, None] + rel + 0.5 + rng.random((r, K))
    gx1 = rng.uniform(-1.0, G + 1.0, (r, K))                 # past both edges
    gx1 = np.where((gx1 > 19.0) & (gx1 < 25.0), gx1 - 8.0, gx1)   # columns 21-23 empty
    live = np.arange(K)[None, :] < counts[:, None]
    return rng, gx0.astype(np.float32), gx1.astype(np.float32), live, counts


@functools.lru_cache(maxsize=None)
def _sdata(seed=3):
    rng, gx0, gx1, live, counts = _slots(seed)
    v = rng.normal(0.0, 1.0, (2, R, K))
    c = rng.normal(0.0, 5.0, (4, R, K))
    j = np.where(live, rng.uniform(0.97, 1.03, (R, K)), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, K)), 0.0)
    sdata = np.stack([gx0, gx1, *v, *c, j, mass, mass / 1000.0], axis=1)
    return np.ascontiguousarray(sdata, dtype=np.float32), counts


@functools.lru_cache(maxsize=None)
def _pdata(nch, seed=5):
    rng, gx0, gx1, live, counts = _slots(seed + nch)
    mass = rng.uniform(0.5, 1.5, (R, K))
    vals = np.concatenate([
        mass * rng.normal(0.0, 1.0, (2, R, K)),
        mass * rng.normal(0.0, 5.0, (4, R, K)),
        rng.normal(0.0, 5.0, (4, R, K)),
        mass[None],
        rng.uniform(0.5e-3, 1.5e-3, (nch - 5, R, K)),
    ]) * live
    pdata = np.concatenate([gx0[None], gx1[None], vals]).transpose(1, 0, 2)
    return np.ascontiguousarray(pdata, dtype=np.float32), counts


def _inputs(case):
    if case in FUSED:
        apic, eos = FUSED[case]
        data, counts = _sdata()
        return data, counts, dict(fused=True, tent=False, apic=apic, eos=eos, **FLUID)
    nch, tent = PREPPED[case]
    data, counts = _pdata(nch)
    return data, counts, dict(fused=False, tent=tent, apic=True)


# (data case, wall, colliders) of each grid case: the fused cases on slip
# walls, the prepped ones on each wall, the colliders on the fused APIC Tait
# case.
PREPPED_WALLS = {"ch6_bspline": "sticky", "ch9_bspline": "penalty", "ch6_tent": "slip",
                 "ch9_tent": "sticky"}
GRID_CASES = {
    **{c: (c, "slip", None) for c in FUSED},
    **{c: (c, PREPPED_WALLS[c], None) for c in PREPPED},
    **{f"collider_{n}": ("apic_tait", "slip", n) for n in COLLIDERS},
}


def _node(case, pkg):
    _, wall, cname = GRID_CASES[case]
    kw = dict(NODE, wall=wall, beta=WALLS[wall])
    if cname is not None:
        specs, tcol = COLLIDERS[cname]
        cls = col.Collider if pkg == "port" else col_jax.Collider
        kw["colliders"] = tuple(cls(**s) for s in specs)
        if tcol is not None:
            kw["tcol"] = tcol if pkg == "port" else jnp.float32(tcol)
    return kw


@functools.lru_cache(maxsize=None)
def _jax_grid(case):
    data, counts, kw = _inputs(GRID_CASES[case][0])
    return np.array(tk_jax.p2g_grid(
        jnp.asarray(data), jnp.asarray(counts), G, DX, raw=False, **kw, **_node(case, "jax")))


def _port_grid(case, dtype=torch.float32, plain=False):
    data, counts, kw = _inputs(GRID_CASES[case][0])
    call = tk.p2g_grid_plain if plain else tk.p2g_grid
    return call(torch.from_numpy(data).to(dtype), torch.from_numpy(counts), G, DX, raw=False,
                **kw, **_node(case, "port")).numpy()


def _close_per_channel(got, want, axis, rel, scale=None):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        s = max(float(np.abs(b).max()), 1e-30) if scale is None or scale[ch] is None \
            else scale[ch]
        err = float(np.abs(a.astype(np.float64) - b).max())
        assert err <= rel[ch] * s, (ch, err, s)


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_p2g_grid_finished_matches_jax(case):
    data_case, wall, cname = GRID_CASES[case]
    want = _jax_grid(case)
    got = _port_grid(case)
    gch = 7 if PREPPED.get(data_case, (0,))[0] == 9 else 4
    assert got.shape == want.shape == (R + 4, gch, G)
    # Pad rows (target rows -1 and R .. R + 2) exactly zero in both.
    for grid in (got, want):
        assert not grid[0].any() and not grid[R + 1 :].any()
    apic = _inputs(data_case)[2]["apic"]
    rel = (FOLD_REL,) * 2 + (FOLD_REL if apic else REL,) * 2 + (REL,) * (gch - 4)
    _close_per_channel(got, want, axis=1, rel=rel)
    if gch == 7:   # Jbar's empty-node default on interior rows
        assert (want[1 : R + 1, 4, 21:24] == 1.0).all()
    if cname is not None:
        # The colliders changed v_new: the same call without them differs.
        free = tk.p2g_grid(*(torch.from_numpy(a) for a in _inputs(data_case)[:2]), G, DX,
                           raw=False, **_inputs(data_case)[2],
                           **dict(NODE, wall=wall, beta=WALLS[wall])).numpy()
        assert np.abs(free[:, :2] - got[:, :2]).max() > 1e-3
        np.testing.assert_array_equal(free[:, 2:], got[:, 2:])
    assert tk.LAUNCHES["p2g_grid"] == 0   # the CPU runs the plain version


@pytest.mark.parametrize("case", ["apic_tait", "ch9_tent", "collider_moving"])
def test_p2g_grid_finished_against_float64(case):
    """The plain version in float32 against itself in float64, per channel."""
    got = _port_grid(case)
    exact = _port_grid(case, torch.float64, plain=True)
    _close_per_channel(got, exact, axis=1, rel=(REL,) * got.shape[1])


def test_p2g_grid_finished_is_the_raw_sums_finished():
    """The non-raw output is `grid_update2d_plain` of the raw mode's sums,
    bit for bit: the two modes share the gather and the fold."""
    data, counts, kw = _inputs("ch9_bspline")
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    node = _node("ch9_bspline", "port")
    raw = tk.p2g_grid(d, c, G, DX, raw=True, **kw)[0]
    want = tk.grid_update2d_plain(raw, R, **node, dx=DX)
    np.testing.assert_array_equal(tk.p2g_grid(d, c, G, DX, **kw, **node).numpy(), want.numpy())


def _update_inputs(seed, padded):
    """pdata2 (R, 8, K) = [gx0, gx1, mask, v0, v1, J, x0, x1] and a grid."""
    rng, gx0, gx1, live, counts = _slots(seed)
    mask = live.astype(np.float32)
    mask[3, :5] = 0.0                    # live slots with mask 0
    v = rng.normal(0.0, 1.0, (2, R, K)).astype(np.float32)
    j = rng.uniform(0.97, 1.03, (R, K)).astype(np.float32)
    x = rng.uniform(0.0, 0.4, (2, R, K)).astype(np.float32)
    pdata2 = np.ascontiguousarray(np.stack([gx0, gx1, mask, *v, j, *x], axis=1))
    rows = R + 4 if padded else R
    grid = rng.normal(0.0, 1.0, (rows, 4, G)).astype(np.float32)
    return pdata2, counts, grid


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "prepadded"])
def test_g2p_update_matches_jax(padded):
    pdata2, counts, grid = _update_inputs(61 + padded, padded)
    want = np.asarray(tk_jax.g2p(
        jnp.asarray(pdata2), jnp.asarray(counts), jnp.asarray(grid), DX, DINV,
        prepadded=padded, update=True, alpha=ALPHA, dtv=DT))
    tgrid = torch.from_numpy(grid[None] if padded else grid)
    got = tk.g2p(torch.from_numpy(pdata2), torch.from_numpy(counts), tgrid, DX, DINV,
                 prepadded=padded, update=True, alpha=ALPHA, dtv=DT).numpy()
    assert got.shape == want.shape == (R, tk.G2P_UPD, K)
    term = DINV * DX * float(np.abs(grid[:, :2]).max())     # one C column term
    rel = (REL,) * 5 + (FOLD_REL, REL, FOLD_REL, REL)
    scale = [None] * 5 + [term, None, term, None]
    _close_per_channel(got, want, axis=1, rel=rel, scale=scale)
    # Dead slots: past the count x passes through, v = C = 0, J = 1, in
    # both; live slots with mask 0 keep x and J = 1, v = 0.
    dead = np.arange(K)[None, :] >= counts[:, None]
    off = ~dead & (pdata2[:, 2] == 0.0)
    assert dead.any() and off.any()
    for out in (got, want):
        for ch, fill in ((0, pdata2[:, 6]), (1, pdata2[:, 7])):
            np.testing.assert_array_equal(out[:, ch][dead | off], fill[dead | off])
        assert not out[:, 2:8][np.broadcast_to(dead[:, None], out[:, 2:8].shape)].any()
        assert (out[:, 8][dead | off] == 1.0).all()
    # The gathers are the non-update mode's.
    base = tk.g2p(torch.from_numpy(np.ascontiguousarray(pdata2[:, :3])),
                  torch.from_numpy(counts), tgrid, DX, DINV, prepadded=padded).numpy()
    live = ~dead
    np.testing.assert_array_equal(got[:, 4:8][np.broadcast_to(live[:, None], (R, 4, K))],
                                  base[:, 4:8][np.broadcast_to(live[:, None], (R, 4, K))])
    assert tk.LAUNCHES["g2p"] == 0


def test_g2p_update_on_shards_reads_each_window():
    """Two shards: bucket row i of shard s updates from window s only."""
    pdata2, counts, _ = _update_inputs(67, True)
    half = R // 2
    pdata2[half:, 0] -= half
    grid = np.random.default_rng(68).normal(0.0, 1.0, (2, half + 4, 4, G)).astype(np.float32)
    kw = dict(prepadded=True, update=True, alpha=ALPHA, dtv=DT)
    got = tk.g2p(torch.from_numpy(pdata2), torch.from_numpy(counts), torch.from_numpy(grid),
                 DX, DINV, **kw).numpy()
    for s in range(2):
        rows = slice(s * half, (s + 1) * half)
        want = tk.g2p(torch.from_numpy(np.ascontiguousarray(pdata2[rows])),
                      torch.from_numpy(counts[rows]), torch.from_numpy(grid[s : s + 1]),
                      DX, DINV, **kw).numpy()
        np.testing.assert_array_equal(got[rows], want)
