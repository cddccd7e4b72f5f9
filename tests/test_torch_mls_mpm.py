"""The port's MLS-MPM validation model against the JAX model and the NumPy oracle.

The BASELINE.json north star holds the model to the reference C++ solver's
semantics (the oracle, `mpm_flip98a_tpu.oracle.advance`) per substep within
1e-5 in float32; tests/test_mls_mpm_vs_oracle.py:42-55 holds the JAX model
so, from the fresh state and mid-collapse.  The port is held the same way,
to the oracle and to the JAX model, and over a 300-substep float64
trajectory at that file's own bound (5e-4 on x and v).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MLS88Config as MLS88ConfigJax
from mpm_flip98a_tpu.models import mls_mpm as mls_jax
from mpm_flip98a_tpu.oracle import advance, init_dam_break
from mpm_flip98a_tpu.state import MLS88Particles as MLS88ParticlesJax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.config import MLS88Config
from mpm_flip98a_tpu_torch.models import mls_mpm
from mpm_flip98a_tpu_torch.state import MLS88Particles

CFG = MLS88Config()
FIELDS = ("x", "v", "F", "C", "Jp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(s) -> MLS88Particles:
    return convert.mls88_particles_from_numpy({k: getattr(s, k) for k in FIELDS}, device="cpu")


@functools.lru_cache(maxsize=None)
def oracle_states(n, seed, warmups):
    """The oracle's state after each warm-up count, and one substep on."""
    s = init_dam_break(n=n, seed=seed)
    out, done = {}, 0
    for w in warmups:
        for _ in range(w - done):
            s = advance(s, CFG)
        done = w
        out[w] = (s, advance(s, CFG))
    return out


def _max_err(got: MLS88Particles, want) -> dict:
    return {k: float(np.abs(getattr(got, k).numpy().astype(np.float64)
                            - np.asarray(getattr(want, k), np.float64)).max()) for k in FIELDS}


def test_config_and_init_match():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(MLS88ConfigJax())
    assert (CFG.mu_0, CFG.lambda_0, CFG.grid_shape) == (
        MLS88ConfigJax().mu_0, MLS88ConfigJax().lambda_0, MLS88ConfigJax().grid_shape)
    p = mls_mpm.init_dam_break(n=500, seed=3, device="cpu")
    want = mls_jax.init_dam_break(n=500, seed=3)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(want, k)))


@pytest.mark.parametrize("warmup", [0, 50, 200])
def test_single_substep_matches_oracle_and_jax_fp32(warmup):
    """tests/test_mls_mpm_vs_oracle.py:42-55's case: from the float32 fresh
    state, and from the oracle's state after 50 and 200 substeps (200:
    boundary contact and plasticity active), which the oracle has promoted
    to float64, so the substep runs in float64 there; within 1e-5."""
    s, ref = oracle_states(2000, 0, (0, 50, 200))[warmup]
    ours = mls_mpm.substep(_to_port(s), CFG)
    errs = _max_err(ours, ref)
    assert max(errs.values()) <= 1e-5, f"vs oracle after warmup={warmup}: {errs}"
    p_j = MLS88ParticlesJax(**{k: jnp.asarray(getattr(s, k)) for k in FIELDS})
    errs = _max_err(ours, mls_jax.make_substep(MLS88ConfigJax())(p_j))
    assert max(errs.values()) <= 1e-5, f"vs JAX after warmup={warmup}: {errs}"


@pytest.mark.parametrize("warmup", [50, 200])
def test_mid_collapse_substep_in_float32(warmup):
    """The mid-collapse states cast back to float32, one substep of the
    port's float32 model against the oracle (which promotes the cast state
    to float64: a float64 reference) and against JAX's float32 model, each
    field within 1e-5 of its scale: C reaches 522 at warm-up 200, where a
    float32 ulp is 6.1e-5."""
    s64, _ = oracle_states(2000, 0, (0, 50, 200))[warmup]
    s = type(s64)(**{k: np.asarray(getattr(s64, k), np.float32) for k in FIELDS})
    ours = mls_mpm.substep(_to_port(s), CFG)
    assert ours.x.dtype == torch.float32
    p_j = MLS88ParticlesJax(**{k: jnp.asarray(getattr(s, k)) for k in FIELDS})
    for ref in (advance(s, CFG), mls_jax.make_substep(MLS88ConfigJax())(p_j)):
        errs = {k: float(np.abs(getattr(ours, k).numpy().astype(np.float64)
                                - np.asarray(getattr(ref, k), np.float64)).max())
                / float(np.abs(np.asarray(getattr(ref, k), np.float64)).max()) for k in FIELDS}
        assert max(errs.values()) <= 1e-5, f"warmup={warmup}: {errs}"
    if warmup == 200:
        assert float(np.abs(np.asarray(s.C)).max()) > 100.0


def test_stages_match_jax_fp64():
    """P2G, the grid update and G2P each against JAX's, float64, 1e-12."""
    s = init_dam_break(n=500, seed=4, dtype=np.float64)
    p, p_j = _to_port(s), MLS88ParticlesJax(**{k: jnp.asarray(getattr(s, k)) for k in FIELDS})
    cfg_j = MLS88ConfigJax()
    jit = lambda fn: functools.partial(jax.jit(fn, static_argnames="cfg"), cfg=cfg_j)
    g, g_j = mls_mpm.p2g(p, CFG), jit(mls_jax.p2g)(p_j)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-12 * float(np.abs(np.asarray(g_j)).max()))
    u, u_j = mls_mpm.grid_update(g, CFG), jit(mls_jax.grid_update)(g_j)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-12)
    q, q_j = mls_mpm.g2p(p, u, CFG), jit(mls_jax.g2p)(p_j, u_j)
    for k, e in _max_err(q, q_j).items():
        assert e <= 1e-12, f"{k}={e:.2e}"
    for k, e in _max_err(q, advance(s, CFG)).items():
        assert e <= 1e-12, f"vs oracle {k}={e:.2e}"


def test_trajectory_matches_oracle_300_steps_fp64():
    s = init_dam_break(n=1000, seed=2, dtype=np.float64)
    p = _to_port(s)
    worst = 0.0
    for step in range(300):
        s = advance(s, CFG)
        p = mls_mpm.substep(p, CFG)
        if step % 50 == 49:
            err = _max_err(p, s)
            worst = max(worst, err["x"], err["v"])
    assert worst <= 5e-4, f"trajectory diverged: {worst:.2e}"


def test_run_equals_substeps():
    p = mls_mpm.init_dam_break(n=300, seed=1, device="cpu")
    step = mls_mpm.make_substep(CFG)
    q = p
    for _ in range(5):
        q = step(q)
    r = mls_mpm.run(p, CFG, 5)
    for k in FIELDS:
        assert torch.equal(getattr(q, k), getattr(r, k)), k
