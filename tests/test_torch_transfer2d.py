"""The port's transfer functions against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels need the card: tests/test_torch_cuda.py); the JAX kernels run in
Pallas interpret mode, as the JAX package's own tests run them.  Inputs
are random bucketed slots from a numpy seed with ragged counts, rows out
of the +-1 margin and columns past both grid edges.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.ops.pallas import transfer2d as tk_jax
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

R, K, G = 16, 256, 37
DX = 0.4375 / 32
DINV = 4.0 / DX**2
KB, MU, GAMMA = 2e6, 1e-3, 7.0
FA = -2e-5 * DINV
# fp32 sums in another order: 1e-6 of each channel's max.
REL = 1e-6
# The JAX P2G folds the column-affine term (c - gx1) dx as a rank-1
# correction, (A2 @ W) c - (A2 gx1) @ W, which cancels: its error grows with
# the column index (measured up to 3.7e-6 of the channel max at G = 37,
# against a float64 evaluation).  The port adds (c - gx1) dx per tap and
# stays within REL of float64, so against JAX the channels that carry the
# affine column term get this bound: P2G channels 2-3 (and 0-1 under
# APIC), G2P's C01 and C11 (the same fold, transfer2d.py:814).
FOLD_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed):
    """Random (R, K) slot planes: gx0, gx1, live mask, counts."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, R).astype(np.int32)
    counts[[2, 7]] = 0          # empty rows
    counts[5] = K               # a full row
    rel = rng.choice([-1, 0, 0, 0, 1, -2, 2], size=(R, K))   # +-2: outside the margin
    gx0 = np.arange(R)[:, None] + rel + 0.5 + rng.random((R, K))
    gx1 = rng.uniform(-1.0, G + 1.0, (R, K))                 # past both edges
    live = np.arange(K)[None, :] < counts[:, None]
    return rng, gx0.astype(np.float32), gx1.astype(np.float32), live, counts


def _sdata(seed):
    rng, gx0, gx1, live, counts = _slots(seed)
    f32 = lambda a: a.astype(np.float32)
    v = rng.normal(0.0, 1.0, (2, R, K))
    c = rng.normal(0.0, 5.0, (4, R, K))
    j = rng.uniform(0.9, 1.1, (R, K))
    mass = rng.uniform(0.5, 1.5, (R, K))
    vol0 = rng.uniform(0.5e-3, 1.5e-3, (R, K))
    # Dead slots are neutral (fast2d._safe_dead_slots): m = V0 = 0, J = 1.
    j, mass, vol0 = np.where(live, j, 1.0), np.where(live, mass, 0.0), np.where(live, vol0, 0.0)
    sdata = np.stack([gx0, gx1, *v, *c, j, mass, vol0], axis=1)
    return f32(sdata), counts


def _close_per_channel(got, want, axis, rel=(REL,) * 8):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel[ch] * scale, (ch, err, scale)


@pytest.mark.parametrize("apic", [False, True], ids=["pic", "apic"])
@pytest.mark.parametrize("eos", ["linear", "tait"])
def test_p2g_fused_matches_jax(apic, eos):
    sdata, counts = _sdata(seed=1 + 2 * apic + (eos == "tait"))
    want = np.asarray(tk_jax.p2g_fused(
        jnp.asarray(sdata), jnp.asarray(counts), G, DX, tent=False, apic=apic,
        eos=eos, kb=KB, mu=MU, gamma=GAMMA, fa=FA,
    ))
    got = tk.p2g_fused(
        torch.from_numpy(sdata), torch.from_numpy(counts), G, DX, apic=apic,
        eos=eos, kb=KB, mu=MU, gamma=GAMMA, fa=FA,
    ).numpy()
    assert got.shape == want.shape == (R, 5, 5, G)
    fold = (FOLD_REL if apic else REL,) * 2 + (FOLD_REL,) * 2 + (REL,)
    _close_per_channel(got, want, axis=2, rel=fold)
    exact = tk.p2g_fused_plain(
        torch.from_numpy(sdata).double(), torch.from_numpy(counts), G, DX,
        apic=apic, eos=eos, kb=KB, mu=MU, gamma=GAMMA, fa=FA,
    ).numpy()
    _close_per_channel(got, exact, axis=2)
    assert tk.LAUNCHES["p2g_fused"] == 0   # the CPU runs the plain version


def test_p2g_fused_partition_of_unity():
    """The mass channel sums to the mass the in-margin slots put on
    in-range columns: all of it where a slot's 3 columns lie inside the
    grid, the in-range taps' share (computed in float64) at the edges."""
    sdata, counts = _sdata(seed=11)
    gx0, gx1, mass = sdata[:, 0], sdata[:, 1], sdata[:, 9].astype(np.float64)
    in_margin = np.abs(np.floor(gx0 - 0.5) - np.arange(R)[:, None]) <= 1
    base1 = np.floor(gx1 - 0.5)
    fx1 = gx1.astype(np.float64) - base1
    taps = np.stack([0.5 * (1.5 - fx1) ** 2, 0.75 - (fx1 - 1) ** 2, 0.5 * (fx1 - 0.5) ** 2])
    cols = base1[None] + np.arange(3)[:, None, None]
    share = (taps * ((cols >= 0) & (cols < G))).sum(0)
    out = tk.p2g_fused(
        torch.from_numpy(sdata), torch.from_numpy(counts), G, DX, apic=False,
        eos="linear", kb=KB, mu=MU, gamma=GAMMA, fa=FA,
    ).numpy()
    expect = (mass * share * in_margin).sum()
    assert 0 < expect < (mass * in_margin).sum()   # some taps do fall off
    np.testing.assert_allclose(out[:, :, 4].astype(np.float64).sum(), expect, rtol=1e-6)


def test_g2p_matches_jax():
    rng, gx0, gx1, live, counts = _slots(seed=5)
    pdata2 = np.stack([gx0, gx1, live.astype(np.float32)], axis=1)
    grid4 = rng.normal(0.0, 1.0, (R, 4, G)).astype(np.float32)
    want = np.asarray(tk_jax.g2p(
        jnp.asarray(pdata2), jnp.asarray(counts), jnp.asarray(grid4), DX, DINV,
    ))
    got = tk.g2p(
        torch.from_numpy(pdata2), torch.from_numpy(counts),
        torch.from_numpy(grid4), DX, DINV,
    ).numpy()
    assert got.shape == want.shape == (R, 8, K)
    _close_per_channel(got, want, axis=1, rel=(REL,) * 5 + (FOLD_REL, REL, FOLD_REL))
    exact = tk.g2p_plain(
        torch.from_numpy(pdata2).double(), torch.from_numpy(counts),
        torch.from_numpy(grid4).double(), DX, DINV,
    ).numpy()
    _close_per_channel(got, exact, axis=1)
    assert (got.transpose(1, 0, 2)[:, ~live] == 0).all()   # dead slots


def test_fold_rows_bit_exact():
    rng = np.random.default_rng(3)
    e = rng.normal(0.0, 1.0, (R, 5, 5, G)).astype(np.float32)
    want = np.asarray(tk_jax.fold_rows(jnp.asarray(e)))
    got = tk.fold_rows(torch.from_numpy(e)).numpy()
    assert got.shape == (R, 5, G)
    np.testing.assert_array_equal(got, want)


def test_wrappers_check_their_inputs():
    sdata, counts = _sdata(seed=2)
    s, c = torch.from_numpy(sdata), torch.from_numpy(counts)
    kw = dict(apic=False, eos="linear", kb=KB, mu=MU, gamma=GAMMA, fa=FA)
    with pytest.raises(TypeError):
        tk.p2g_fused(s.double(), c, G, DX, **kw)
    with pytest.raises(ValueError):
        tk.p2g_fused(s[:, :10].contiguous(), c, G, DX, **kw)
    with pytest.raises(ValueError):
        tk.p2g_fused(s.transpose(0, 2).contiguous().transpose(0, 2), c, G, DX, **kw)
    with pytest.raises(ValueError):
        tk.p2g_fused(s, c, G, DX, **{**kw, "eos": "stiff"})
    # A device with no kernel and no plain route raises instead of falling back.
    with pytest.raises(ValueError):
        tk.p2g_fused(s.to("meta"), c.to("meta"), G, DX, **kw)
    grid = torch.zeros((R, 4, G))
    with pytest.raises(ValueError):
        tk.g2p(s[:, :3].to("meta"), c.to("meta"), grid.to("meta"), DX, DINV)
    with pytest.raises(ValueError):
        tk.g2p(s[:, :3].contiguous(), c, grid.to("meta"), DX, DINV)
