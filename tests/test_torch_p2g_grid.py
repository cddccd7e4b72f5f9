"""The port's `p2g_grid` raw mode, `fold_rows_halo` and the prepadded `g2p`
against the JAX Pallas kernels.

`p2g_grid(raw=True)` is TPU kernel #4 in the mode the slab-sharded 2D
path runs: P2G (fused stress or prepped rows) folded into each shard's
raw, uncropped (L + 4, nch, G) halo rows.  On the CPU the port's wrappers
run their plain PyTorch versions (the CUDA kernel needs the card:
tests/test_torch_cuda.py); the JAX kernels run in Pallas interpret mode,
one cached call per case.  Inputs are random bucketed slots from a numpy
seed with ragged counts, rows outside the +-1 margin and columns past both
grid edges.

Tolerances (ROADMAP queue 3): the JAX kernels fold the column-affine term
(c - gx1) dx as a rank-1 correction that cancels, so against JAX the
channels carrying it (2-3, and 0-1 under APIC) get 1e-5 of the channel
max and the others 1e-6.  G2P's C01 and C11 sum +-(c - gx1) dx terms that
cancel, so against JAX they get 1e-5 of one term's size, dinv dx |v|max
(as chip_smoke.py scales them), and every G2P channel is also held to a
float64 evaluation at 1e-6 of its max.  `fold_rows_halo` is bit-exact.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.ops.pallas import transfer2d as tk_jax
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

R, K, G = 16, 256, 37
DX = 0.4375 / 32
DINV = 4.0 / DX**2
REL = 1e-6
FOLD_REL = 1e-5
FLUID = dict(kb=2.0e5, mu=1e-3, gamma=7.0, fa=-2e-5 * DINV)
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed, r=R):
    """Random (r, K) slot planes: gx0, gx1, live mask, counts."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, r).astype(np.int32)
    counts[[2, 7]] = 0          # empty rows
    counts[5] = K               # a full row
    rel = rng.choice([-1, 0, 0, 0, 1, -2, 2], size=(r, K))   # +-2: outside the margin
    gx0 = np.arange(r)[:, None] + rel + 0.5 + rng.random((r, K))
    gx1 = rng.uniform(-1.0, G + 1.0, (r, K))                 # past both edges
    live = np.arange(K)[None, :] < counts[:, None]
    return rng, gx0.astype(np.float32), gx1.astype(np.float32), live, counts


@functools.lru_cache(maxsize=None)
def _sdata(seed=3):
    """Fused rows [gx0, gx1, v0, v1, C (4), J, mass, vol0]."""
    rng, gx0, gx1, live, counts = _slots(seed)
    v = rng.normal(0.0, 1.0, (2, R, K))
    c = rng.normal(0.0, 5.0, (4, R, K))
    j = np.where(live, rng.uniform(0.97, 1.03, (R, K)), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, K)), 0.0)
    sdata = np.stack([gx0, gx1, *v, *c, j, mass, mass / 1000.0], axis=1)
    return np.ascontiguousarray(sdata, dtype=np.float32), counts


@functools.lru_cache(maxsize=None)
def _pdata(nch, seed=5):
    """Prepped rows [gx0, gx1, m v (2), P (4), Q (4), *plain], masked."""
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


@functools.lru_cache(maxsize=None)
def _jax_raw(case):
    data, counts, kw = _inputs(case)
    return np.array(tk_jax.p2g_grid(
        jnp.asarray(data), jnp.asarray(counts), G, DX, raw=True, **kw))


def _close_per_channel(got, want, axis, rel, scale=None):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        s = max(float(np.abs(b).max()), 1e-30) if scale is None or scale[ch] is None \
            else scale[ch]
        err = float(np.abs(a - b).max())
        assert err <= rel[ch] * s, (ch, err, s)


@pytest.mark.parametrize("case", [*FUSED, *PREPPED])
def test_p2g_grid_raw_matches_jax(case):
    data, counts, kw = _inputs(case)
    want = _jax_raw(case)
    got = tk.p2g_grid(torch.from_numpy(data), torch.from_numpy(counts), G, DX, raw=True, **kw)
    nch = want.shape[1]
    assert got.shape == (1, R + 4, nch, G) and want.shape == (R + 4, nch, G)
    fold = (FOLD_REL if kw["apic"] else REL,) * 2 + (FOLD_REL,) * 2 + (REL,) * (nch - 4)
    _close_per_channel(got[0].numpy(), want, axis=1, rel=fold)
    assert tk.LAUNCHES["p2g_grid"] == 0   # the CPU runs the plain version


def test_p2g_grid_raw_keeps_the_halo_rows_and_the_mass():
    """Raw means uncropped: taps on target rows -1 and R .. R + 2 stay in
    rows 0 and R + 1 .. R + 3, so the mass channel sums to the in-margin
    slots' mass on in-range columns, as fold_rows would crop it not."""
    data, counts, kw = _inputs("ch9_bspline")
    got = tk.p2g_grid(torch.from_numpy(data), torch.from_numpy(counts), G, DX, raw=True,
                      **kw)[0].numpy().astype(np.float64)
    gx0, gx1, mass = data[:, 0], data[:, 1], data[:, 12].astype(np.float64)
    in_margin = np.abs(np.floor(gx0 - 0.5) - np.arange(R)[:, None]) <= 1
    fx1 = gx1.astype(np.float64) - np.floor(gx1 - 0.5)
    taps = np.stack([0.5 * (1.5 - fx1) ** 2, 0.75 - (fx1 - 1) ** 2, 0.5 * (fx1 - 0.5) ** 2])
    cols = np.floor(gx1 - 0.5)[None] + np.arange(3)[:, None, None]
    share = (taps * ((cols >= 0) & (cols < G))).sum(0)
    np.testing.assert_allclose(got[:, 4].sum(), (mass * share * in_margin).sum(), rtol=1e-6)
    assert np.abs(got[0, 4]).sum() > 0 and np.abs(got[R + 1 :, 4]).sum() > 0


def test_p2g_grid_shards_are_separate_slabs():
    """shards = 2: each half of the rows is its own slab, with gx0 local to
    it, and gives the JAX kernel's raw output on that half."""
    data, counts, kw = _inputs("apic_tait")
    half = R // 2
    local = data.copy()
    local[half:, 0] -= half
    got = tk.p2g_grid(torch.from_numpy(local), torch.from_numpy(counts), G, DX, raw=True,
                      shards=2, **kw).numpy()
    assert got.shape == (2, half + 4, 5, G)
    fold = (FOLD_REL,) * 4 + (REL,)
    for s in range(2):
        want = np.asarray(tk_jax.p2g_grid(
            jnp.asarray(local[s * half : (s + 1) * half]),
            jnp.asarray(counts[s * half : (s + 1) * half]), G, DX, raw=True, **kw))
        _close_per_channel(got[s], want, axis=1, rel=fold)


def test_fold_rows_halo_is_bit_exact():
    expanded = np.random.default_rng(9).normal(0.0, 1.0, (R, 5, 6, G)).astype(np.float32)
    want = np.asarray(tk_jax.fold_rows_halo(jnp.asarray(expanded)))
    got = tk.fold_rows_halo(torch.from_numpy(expanded)).numpy()
    assert got.shape == (R + 4, 6, G)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tk.fold_rows(torch.from_numpy(expanded)).numpy(),
                                  np.asarray(tk_jax.fold_rows(jnp.asarray(expanded))))


@pytest.mark.parametrize("gch,tent", [(4, False), (7, False), (7, True)],
                         ids=["base", "ext", "ext_tent"])
def test_g2p_prepadded_matches_jax(gch, tent):
    rng, gx0, gx1, live, counts = _slots(seed=41 + gch + tent)
    pdata2 = np.stack([gx0, gx1, live.astype(np.float32)], axis=1)
    grid = rng.normal(0.0, 1.0, (R + 4, gch, G)).astype(np.float32)
    dinv = 1.0 if tent else DINV
    want = np.asarray(tk_jax.g2p(
        jnp.asarray(pdata2), jnp.asarray(counts), jnp.asarray(grid), DX, dinv, tent=tent,
        prepadded=True,
    ))
    got = tk.g2p(
        torch.from_numpy(pdata2), torch.from_numpy(counts), torch.from_numpy(grid[None]),
        DX, dinv, tent, prepadded=True,
    ).numpy()
    n_out = 8 + gch - 4
    assert got.shape == want.shape == (R, n_out, K)
    rel = (REL,) * 5 + (FOLD_REL, REL, FOLD_REL) + (REL,) * (gch - 4)
    term = dinv * DX * float(np.abs(grid[:, :2]).max())     # one C column term
    scale = [None] * 5 + [term, None, term] + [None] * (gch - 4)
    _close_per_channel(got, want, axis=1, rel=rel, scale=scale)
    exact = tk.g2p_plain(
        torch.from_numpy(pdata2).double(), torch.from_numpy(counts),
        torch.from_numpy(grid[None]).double(), DX, dinv, tent, prepadded=True,
    ).numpy()
    _close_per_channel(got, exact, axis=1, rel=(REL,) * n_out)
    # The pad rows are read: the unpadded interior alone gives other sums.
    inner = tk.g2p(torch.from_numpy(pdata2), torch.from_numpy(counts),
                   torch.from_numpy(grid[1 : R + 1]), DX, dinv, tent).numpy()
    assert not np.allclose(inner, got)
    assert tk.LAUNCHES["g2p"] == 0


def test_g2p_prepadded_reads_each_shards_window():
    """Two shards: bucket row i of shard s reads window s only."""
    rng, gx0, gx1, live, counts = _slots(seed=47)
    half = R // 2
    gx0 = gx0 - np.where(np.arange(R) >= half, half, 0)[:, None].astype(np.float32)
    pdata2 = np.stack([gx0, gx1, live.astype(np.float32)], axis=1)
    grid = rng.normal(0.0, 1.0, (2, half + 4, 7, G)).astype(np.float32)
    got = tk.g2p(torch.from_numpy(pdata2), torch.from_numpy(counts),
                 torch.from_numpy(grid), DX, DINV, prepadded=True).numpy()
    for s in range(2):
        rows = slice(s * half, (s + 1) * half)
        want = tk.g2p(torch.from_numpy(np.ascontiguousarray(pdata2[rows])),
                      torch.from_numpy(counts[rows]), torch.from_numpy(grid[s : s + 1]),
                      DX, DINV, prepadded=True).numpy()
        np.testing.assert_array_equal(got[rows], want)


def test_p2g_grid_and_g2p_wrappers_check_their_inputs():
    data, counts, kw = _inputs("pic_tait")
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    node = dict(dt=2e-5, gx_=-9.81, gy_=0.0, floor=1e-3, lo=2, hi=G - 3, wall="slip")
    assert tk.p2g_grid(d, c, G, DX, **kw, **node).shape == (R + 4, 4, G)   # non-raw mode
    with pytest.raises(TypeError, match="needs floor"):   # ... needs the node arguments
        tk.p2g_grid(d, c, G, DX, **kw, **{k: v for k, v in node.items() if k != "floor"})
    with pytest.raises(ValueError):                     # ... on one device
        tk.p2g_grid(d, c, G, DX, shards=2, **kw, **node)
    with pytest.raises(ValueError):                     # the fused mode has no tent
        tk.p2g_grid(d, c, G, DX, raw=True, **{**kw, "tent": True})
    with pytest.raises(ValueError):
        tk.p2g_grid(d, c, G, DX, raw=True, **{**kw, "eos": "stiff"})
    with pytest.raises(ValueError):                     # 16 rows do not split in 3
        tk.p2g_grid(d, c, G, DX, raw=True, shards=3, **kw)
    with pytest.raises(ValueError):                     # prepped rows: 14 or 17
        tk.p2g_grid(d, c, G, DX, raw=True, fused=False)
    with pytest.raises(TypeError):
        tk.p2g_grid(d.double(), c, G, DX, raw=True, **kw)
    pdata2 = torch.zeros((R, 3, K))
    grid = torch.zeros((2, R // 2 + 4, 4, G))
    upd = tk.g2p(torch.zeros((R, 8, K)), c, grid, DX, DINV, prepadded=True, update=True)
    assert upd.shape == (R, 9, K)                       # the update mode runs ...
    with pytest.raises(ValueError):                     # ... on [gx0, gx1, mask, v, J, x]
        tk.g2p(pdata2, c, grid, DX, DINV, prepadded=True, update=True)
    with pytest.raises(ValueError):                     # windows of L + 4 rows
        tk.g2p(pdata2, c, grid[:, 1:], DX, DINV, prepadded=True)
    with pytest.raises(ValueError):                     # prepadded needs the shard dim
        tk.g2p(pdata2, c, grid[0], DX, DINV, prepadded=True)
