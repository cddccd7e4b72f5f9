"""The CUDA transfer kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels are built from
mpm_flip98a_tpu_torch/csrc at first use); without a card they skip.  They
import no JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: per output channel, 1e-5 of the channel's max.  Both sides sum
each node's fp32 terms in another order (shared-memory atomics in the P2G
kernel, atomics in the plain `index_add_` on the card, FMA contraction in
the G2P kernel).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, scenes
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

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
    b_cpu = fast2d.from_particles(p, cfg, spec)
    tk.reset_launches()
    stats = fast2d.RunStats()
    out = fast2d.run(b_gpu, scene, spec, 100, stats)
    assert tk.LAUNCHES == {"p2g_fused": 100, "g2p": 100} and stats.substeps == 100
    ref = fast2d.run(b_cpu, scene, spec, 100)
    for f in dataclasses.fields(out):
        if f.name in ("x0", "x1"):
            np.testing.assert_allclose(
                getattr(out, f.name).cpu().numpy(), getattr(ref, f.name).numpy(), atol=1e-5
            )
    assert int(out.overflow) == 0
