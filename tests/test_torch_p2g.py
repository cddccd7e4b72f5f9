"""The port's `p2g` and extended / tent `g2p` against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels need the card: tests/test_torch_cuda.py); the JAX kernels run in
Pallas interpret mode, as the JAX package's own tests run them.  Inputs
are random bucketed slots from a numpy seed with ragged counts, rows out
of the +-1 margin and columns past both grid edges; value rows are
pre-masked as `fast2d` preps them.

Tolerances (ROADMAP queue 3): the JAX kernels fold the column-affine term
(c - gx1) dx as a rank-1 correction that cancels, so against JAX the
channels carrying it (P2G channels 2-3, and 0-1 under APIC; G2P's C01
and C11) get 1e-5 of the channel max and the others 1e-6; every channel
is held to a float64 evaluation at 1e-6.
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
REL = 1e-6
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


def _pdata(seed, nch):
    """Prepped rows [gx0, gx1, m v (2), P (4), Q (4), *plain], masked."""
    rng, gx0, gx1, live, counts = _slots(seed)
    mass = rng.uniform(0.5, 1.5, (R, K))
    vals = np.concatenate([
        mass * rng.normal(0.0, 1.0, (2, R, K)),          # m v
        mass * rng.normal(0.0, 5.0, (4, R, K)),          # P = m C
        rng.normal(0.0, 5.0, (4, R, K)),                 # Q = P + fa tau
        mass[None],
        rng.uniform(0.5e-3, 1.5e-3, (nch - 5, R, K)),    # V or [V0 J, V0, V0 p, V0 div]
    ]) * live
    pdata = np.concatenate([gx0[None], gx1[None], vals]).transpose(1, 0, 2)
    return np.ascontiguousarray(pdata, dtype=np.float32), counts


def _close_per_channel(got, want, axis, rel):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel[ch] * scale, (ch, err, scale)


@pytest.mark.parametrize("tent", [False, True], ids=["bspline", "tent"])
@pytest.mark.parametrize("apic", [False, True], ids=["pic", "apic"])
@pytest.mark.parametrize("nch", [6, 9])
def test_p2g_matches_jax(nch, apic, tent):
    pdata, counts = _pdata(seed=nch + 2 * apic + 4 * tent, nch=nch)
    want = np.asarray(tk_jax.p2g(
        jnp.asarray(pdata), jnp.asarray(counts), G, DX, tent=tent, apic=apic,
    ))
    got = tk.p2g(torch.from_numpy(pdata), torch.from_numpy(counts), G, DX, tent, apic).numpy()
    assert got.shape == want.shape == (R, 5, nch, G)
    fold = (FOLD_REL if apic else REL,) * 2 + (FOLD_REL,) * 2 + (REL,) * (nch - 4)
    _close_per_channel(got, want, axis=2, rel=fold)
    exact = tk.p2g_plain(
        torch.from_numpy(pdata).double(), torch.from_numpy(counts), G, DX, tent, apic,
    ).numpy()
    _close_per_channel(got, exact, axis=2, rel=(REL,) * nch)
    assert tk.LAUNCHES["p2g"] == 0   # the CPU runs the plain version


@pytest.mark.parametrize("tent", [False, True], ids=["bspline", "tent"])
def test_p2g_partition_of_unity(tent):
    """The mass channel sums to the mass the in-margin slots put on
    in-range columns (the in-range taps' share, in float64)."""
    pdata, counts = _pdata(seed=21, nch=9)
    gx0, gx1, mass = pdata[:, 0], pdata[:, 1], pdata[:, 12].astype(np.float64)
    in_margin = np.abs(np.floor(gx0 - 0.5) - np.arange(R)[:, None]) <= 1
    base1 = np.floor(gx1 - 0.5)
    fx1 = gx1.astype(np.float64) - base1
    if tent:
        taps = np.stack([np.maximum(0, 1 - fx1), 1 - np.abs(fx1 - 1), np.maximum(0, fx1 - 1)])
    else:
        taps = np.stack([0.5 * (1.5 - fx1) ** 2, 0.75 - (fx1 - 1) ** 2, 0.5 * (fx1 - 0.5) ** 2])
    cols = base1[None] + np.arange(3)[:, None, None]
    share = (taps * ((cols >= 0) & (cols < G))).sum(0)
    out = tk.p2g(torch.from_numpy(pdata), torch.from_numpy(counts), G, DX, tent, False).numpy()
    expect = (mass * share * in_margin).sum()
    assert 0 < expect < (mass * in_margin).sum()   # some taps do fall off
    np.testing.assert_allclose(out[:, :, 4].astype(np.float64).sum(), expect, rtol=1e-6)


@pytest.mark.parametrize("gch,tent", [(7, False), (4, True), (7, True)],
                         ids=["ext", "tent", "ext_tent"])
def test_g2p_extended_and_tent_match_jax(gch, tent):
    rng, gx0, gx1, live, counts = _slots(seed=31 + gch + tent)
    pdata2 = np.stack([gx0, gx1, live.astype(np.float32)], axis=1)
    grid = rng.normal(0.0, 1.0, (R, gch, G)).astype(np.float32)
    dinv = 1.0 if tent else DINV    # tent: the caller inverts D itself
    want = np.asarray(tk_jax.g2p(
        jnp.asarray(pdata2), jnp.asarray(counts), jnp.asarray(grid), DX, dinv, tent=tent,
    ))
    got = tk.g2p(
        torch.from_numpy(pdata2), torch.from_numpy(counts), torch.from_numpy(grid),
        DX, dinv, tent,
    ).numpy()
    n_out = 8 + gch - 4
    assert got.shape == want.shape == (R, n_out, K)
    rel = (REL,) * 5 + (FOLD_REL, REL, FOLD_REL) + (REL,) * (gch - 4)
    _close_per_channel(got, want, axis=1, rel=rel)
    exact = tk.g2p_plain(
        torch.from_numpy(pdata2).double(), torch.from_numpy(counts),
        torch.from_numpy(grid).double(), DX, dinv, tent,
    ).numpy()
    _close_per_channel(got, exact, axis=1, rel=(REL,) * n_out)
    assert (got.transpose(1, 0, 2)[:, ~live] == 0).all()   # dead slots
    assert tk.LAUNCHES["g2p"] == 0


def test_p2g_and_g2p_wrappers_check_their_inputs():
    pdata, counts = _pdata(seed=2, nch=6)
    p, c = torch.from_numpy(pdata), torch.from_numpy(counts)
    with pytest.raises(ValueError):      # 15 rows: neither 6 nor 9 channels
        tk.p2g(torch.cat([p, p[:, :1]], dim=1), c, G, DX)
    with pytest.raises(TypeError):
        tk.p2g(p.double(), c, G, DX)
    with pytest.raises(ValueError):
        tk.p2g(p.transpose(0, 2).contiguous().transpose(0, 2), c, G, DX)
    with pytest.raises(ValueError):      # no kernel and no plain route
        tk.p2g(p.to("meta"), c.to("meta"), G, DX)
    pdata2 = p[:, :3].contiguous()
    with pytest.raises(ValueError):      # 5 grid channels
        tk.g2p(pdata2, c, torch.zeros((R, 5, G)), DX, DINV)
    with pytest.raises(ValueError):
        tk.g2p(pdata2, c, torch.zeros((R, 7, G)).to("meta"), DX, DINV)
