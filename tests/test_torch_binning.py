"""The port's binning and rebucketing against the JAX package: bit-exact.

Fields move as 4-byte bit patterns in both packages, so every bucketed
field, the mask and the overflow count must match to the bit, including
a forced overflow and a capacity change.
"""

import dataclasses

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu.config import MPMConfig, TransferKind
from mpm_flip98a_tpu.models import fast2d as fast2d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.ops import binning as binning_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import fast2d
from mpm_flip98a_tpu_torch.ops import binning

FAST = MPMConfig(
    dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
    num_particles_y=32, flip_blend=0.98, transfer=TransferKind.PIC,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _assert_buckets_equal(b_t, b_j):
    for f in dataclasses.fields(fast2d.FluidBuckets):
        got = getattr(b_t, f.name).cpu().numpy()
        want = np.asarray(getattr(b_j, f.name))
        assert got.shape == want.shape, f.name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f.name)


@pytest.mark.parametrize("capacity", [128, 16], ids=["fits", "overflows"])
def test_bucket_by_row_bit_exact(capacity):
    rng = np.random.default_rng(capacity)
    s, rows = 600, 12
    row = rng.integers(-3, rows + 3, s).astype(np.int32)     # clipped into range
    active = rng.random(s) < 0.8
    fields = (
        rng.normal(size=s).astype(np.float32),
        rng.normal(size=s).astype(np.float32) * 1e30,
        rng.integers(-5, 5, s).astype(np.int32),
    )
    fj, mj, oj = binning_jax.bucket_by_row(
        jnp.asarray(row), jnp.asarray(active), tuple(map(jnp.asarray, fields)),
        rows, capacity,
    )
    ft, mt, ot = binning.bucket_by_row(
        torch.from_numpy(row), torch.from_numpy(active),
        tuple(map(torch.from_numpy, fields)), rows, capacity,
    )
    for a, b in zip(ft, fj):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(ot) == int(oj)
    assert (int(ot) > 0) == (capacity == 16)


# JAX's bucketing and re-sort as one program each: called eagerly they
# compile each of their operations on its own.
from_particles_jax = jax.jit(fast2d_jax.from_particles, static_argnames=("cfg", "spec"))
rebucket_jax = jax.jit(fast2d_jax.rebucket, static_argnames=("cfg", "spec"))


def _jax_state():
    p, scene = scenes_jax.dam_break_2d(FAST, dtype=np.float32)
    spec = fast2d_jax.FastSpec.for_particles(FAST, p, headroom=2.0)
    return p, scene, spec, from_particles_jax(p, FAST, spec)


def _port_cfg(scene):
    return convert.scene_from_fields(dataclasses.asdict(scene)).cfg


def test_from_particles_bit_exact():
    p, scene, spec, b = _jax_state()
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu"
    )
    cfg = _port_cfg(scene)
    spec_t = fast2d.FastSpec.for_particles(cfg, p_t, headroom=2.0)
    assert (spec_t.rows, spec_t.capacity) == (spec.rows, spec.capacity)
    _assert_buckets_equal(fast2d.from_particles(p_t, cfg, spec_t, device="cpu"), b)


@pytest.mark.parametrize("scale", [1.0, 2.0, 0.25], ids=["same", "grow", "shrink"])
def test_rebucket_bit_exact(scale):
    """Drift every particle by up to 2 rows, then re-sort both states into
    the same, a larger and a too-small capacity (which overflows)."""
    _, scene, spec, b = _jax_state()
    rng = np.random.default_rng(7)
    drift = rng.uniform(-2.0, 2.0, b.x0.shape).astype(np.float32) * np.float32(FAST.dx)
    b = dataclasses.replace(b, x0=b.x0 + jnp.asarray(drift) * b.mask)
    fields = {f.name: np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b)}
    b_t = convert.buckets_from_numpy(fields, device="cpu")
    _assert_buckets_equal(b_t, b)
    new = dataclasses.replace(spec, capacity=int(spec.capacity * scale))
    out_j = rebucket_jax(b, FAST, new)
    out_t = fast2d.rebucket(
        b_t, _port_cfg(scene), fast2d.FastSpec(new.rows, new.capacity)
    )
    _assert_buckets_equal(out_t, out_j)
    assert (int(out_t.overflow) > 0) == (scale < 1.0)
