"""The port's `p2g3d` in its stress mode against the JAX Pallas kernel.

`p2g3d(stress="linear" | "tait")` reads the 18 state planes [gx (3), v
(3), C00..C22, J, mass, vol0] and makes the fluid stress per slot in the
kernel (transfer3d.py:208-236), then the expanded P2G of `p2g3d`'s
prepped mode: (R0, 5, G1, 7, G2), or G1 + 4 plane rows with `halo1`
(held here to the raw `p2g3d_grid` it folds into).  On
the CPU the port's wrapper runs its plain PyTorch version (the CUDA kernel
needs the card: tests/test_torch_cuda.py); the JAX kernel runs in Pallas
interpret mode, one cached call per case.  Inputs are random pencil slots
from a numpy seed (tests/test_torch_transfer3d.py's layout at R 8, G 16):
empty, partly filled and full pencils, slots outside the +-1 margin on
both bucketed axes, z past both grid edges, dead slots neutral (m = V0 =
0, J = 1).

Tolerances are tests/test_torch_p2g3d.py's: fp32 sums in another order,
1e-6 of each channel's max.  The fold of the expanded output relates to
`p2g3d_grid`'s stress mode as tests/test_p2g_grid.py:168-210 relates the
JAX kernels.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.ops.pallas import transfer3d as tk3_jax
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

R, K, G = 8, 128, 16
DX = 0.4375 / 11
DINV = 4.0 / DX**2
DT = 2e-5
REL = 1e-6
FLUID = dict(kb=2e6, mu=1e-3, gamma=7.0, fa=-DT * DINV)
CASES = {   # name: (stress, apic)
    "linear_pic": ("linear", False),
    "linear_apic": ("linear", True),
    "tait_pic": ("tait", False),
    "tait_apic": ("tait", True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slots(seed=0):
    """18 state planes (R, R, K) f32 and counts (R * R,)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, (R, R))
    counts[0, :3] = 0           # empty pencils
    counts[5, 5] = K            # a full pencil
    counts[:, 0] = K // 2       # the axis-1 edge: taps leave [0, G1)
    rel0 = rng.choice([-1, 0, 0, 0, 1, -2, 2], size=(R, R, K))   # +-2: outside
    rel1 = rng.choice([-1, 0, 0, 0, 1, 2], size=(R, R, K))
    gx0 = np.arange(R)[:, None, None] + rel0 + 0.5 + rng.random((R, R, K))
    gx1 = np.arange(R)[None, :, None] + rel1 + 0.5 + rng.random((R, R, K))
    gx2 = rng.uniform(-1.0, G + 1.0, (R, R, K))                 # past both edges
    live = np.arange(K) < counts[..., None]
    v = rng.normal(0.0, 1.0, (3, R, R, K))
    c = rng.normal(0.0, 5.0, (9, R, R, K))
    j = np.where(live, rng.uniform(0.9, 1.1, (R, R, K)), 1.0)
    mass = np.where(live, rng.uniform(0.5, 1.5, (R, R, K)), 0.0)
    vol0 = np.where(live, rng.uniform(0.5e-3, 1.5e-3, (R, R, K)), 0.0)
    planes = [a.astype(np.float32) for a in (gx0, gx1, gx2, *v, *c, j, mass, vol0)]
    return planes, counts.reshape(-1).astype(np.int32)


PLANES, COUNTS = _slots()


def _t(planes, dtype=torch.float32):
    return tuple(torch.from_numpy(p).to(dtype) for p in planes)


def _kw(case):
    stress, apic = CASES[case]
    return dict(apic=apic, stress=stress, **FLUID)


@functools.lru_cache(maxsize=None)
def _jax_expanded(case):
    return np.array(tk3_jax.p2g3d(
        tuple(jnp.asarray(p) for p in PLANES), jnp.asarray(COUNTS), R, G, DX, **_kw(case)))


def _close_per_channel(got, want, axis, rel=REL):
    got, want = np.moveaxis(got, axis, 0), np.moveaxis(want, axis, 0)
    for ch, (a, b) in enumerate(zip(got, want)):
        s = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.astype(np.float64) - b).max())
        assert err <= rel * s, (ch, err, s)


@pytest.mark.parametrize("case", list(CASES))
def test_p2g3d_stress_matches_jax(case):
    want = _jax_expanded(case)
    got = tk3.p2g3d(_t(PLANES), torch.from_numpy(COUNTS), R, G, DX, **_kw(case)).numpy()
    assert got.shape == want.shape == (R, tk3.NT, R, tk3.P2G_CH, G)
    assert all(np.abs(want[:, :, :, ch]).max() > 0 for ch in range(tk3.P2G_CH))
    _close_per_channel(got, want, axis=3)
    assert tk3.LAUNCHES["p2g3d"] == 0   # the CPU runs the plain version


def test_p2g3d_stress_against_float64():
    got = tk3.p2g3d(_t(PLANES), torch.from_numpy(COUNTS), R, G, DX, **_kw("tait_apic")).numpy()
    exact = tk3.p2g3d_plain(_t(PLANES, torch.float64), torch.from_numpy(COUNTS), R, G, DX,
                            **_kw("tait_apic")).numpy()
    _close_per_channel(got, exact, axis=3)


@pytest.mark.parametrize("case", ["linear_pic", "tait_apic"])
def test_p2g3d_stress_is_the_prepped_mode_of_its_stress(case):
    """The stress mode equals the prepped mode on the fields the stress
    gives (transfer3d._fluid_affine), to the rounding of the Tait power
    (PyTorch's vectorised and scalar pow differ by an ulp)."""
    stress, apic = CASES[case]
    fields = _t(PLANES)
    mv, p_aff, q_aff, plain = tk3._fluid_affine(fields, apic, stress, **{
        k: v for k, v in FLUID.items()})
    prepped = (*fields[:3], *mv, *(p_aff if apic else ()), *q_aff, *plain)
    counts = torch.from_numpy(COUNTS)
    _close_per_channel(tk3.p2g3d(fields, counts, R, G, DX, **_kw(case)).numpy(),
                       tk3.p2g3d(prepped, counts, R, G, DX, apic=apic).numpy(), axis=3)


@pytest.mark.parametrize("case", ["linear_pic", "tait_apic"])
def test_fold_of_stress_mode_is_p2g3d_grid_stress_mode(case):
    """fold_rows0 + the grid update of the expanded stress-mode output
    against `p2g3d_grid`'s stress mode, interior within JAX's atol of 1e-6
    (tests/test_p2g_grid.py:168-210), pads exactly zero; and the fold of
    the halo1 output against its raw sums, per channel."""
    counts = torch.from_numpy(COUNTS)
    node = dict(dt=DT, grav=(0.0, 0.0, -9.81), floor=1e-8, lo=2, hi=G - 3, wall="slip")
    fused = tk3.p2g3d_grid(_t(PLANES), counts, R, G, DX, **_kw(case), **node).numpy()
    expanded = tk3.p2g3d(_t(PLANES), counts, R, G, DX, **_kw(case))
    raw = tk3.fold_rows0_halo(expanded)                 # (R + 4, G1, 7, G2)
    padded = torch.zeros((R + 4, R + 4, tk3.P2G_CH, G))
    padded[:, 1 : R + 1] = raw               # axis-1 target row t at plane t + 1
    ref = tk3.grid_update3d_plain(padded, R, node["dt"], node["grav"], node["floor"],
                                  node["lo"], node["hi"], "slip", 0.0).numpy()
    # The axis-1 pad rows of p2g3d_grid keep the edge taps that p2g3d drops.
    inner = (slice(1, R + 1), slice(1, R + 1))
    np.testing.assert_allclose(fused[inner], ref[inner], atol=1e-6)
    assert not fused[0].any() and not fused[R + 1 :].any()
    halo = tk3.fold_rows0_halo(tk3.p2g3d(_t(PLANES), counts, R, G, DX, halo1=True,
                                         **_kw(case))).numpy()
    want = tk3.p2g3d_grid(_t(PLANES), counts, R, G, DX, raw=True, **_kw(case)).numpy()[0]
    _close_per_channel(halo, want, axis=2)
