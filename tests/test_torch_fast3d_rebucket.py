"""The port's 3D rebucket against the JAX package: bit for bit, and in runs.

Bucketing and a rebucket after a shift, bit for bit against JAX
`from_particles` and `rebucket`; the fused branch thrown sideways over 80
substeps, by ensemble against the JAX general path (tests/test_fast3d.py's
5e-4 on the mean); and the stabilized switch set
(tests/test_torch_stabilized3d.py's) over 25 against JAX `fast3d.run`,
slot for slot.  Each JAX run is a compile of its own that no case of
tests/test_torch_fast3d.py or _stabilized3d.py shares, so they sit
together in a module apart, and each file stays inside its share of the
suite's time.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu.config import TransferKind as TransferKindJax
from mpm_flip98a_tpu.models import fast3d as fast3d_jax
from mpm_flip98a_tpu.models import scenes as scenes_jax
from mpm_flip98a_tpu.models.stabilized import run as run_ref_jax
from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import fast3d, scenes
from mpm_flip98a_tpu_torch.models.fast2d import RunStats

from test_torch_fast3d import (   # with its autouse fixture
    SMALL, _assert_bits_equal, _fields, _one_torch_thread, _setup, _t)

# tests/test_torch_stabilized3d.py's stabilized switch set.
STAB = dict(flip_blend=0.98, transfer=TransferKindJax.PIC, use_fbar=True, use_penalty_ebc=True,
            pressure_mixing_ratio=1.0)


@pytest.mark.parametrize("capacity", ["same", "grown"])
def test_from_particles_and_rebucket_bit_exact(capacity):
    """Bucketing and a rebucket after a shift that moves particles across
    pencils on both bucketed axes, bit for bit (XLA only on the JAX side)."""
    (p, scene, spec, b), (scene_t, spec_t, _) = _setup()
    p_t, _ = scenes.dam_break_3d(**SMALL)
    spec_t2 = fast3d.FastSpec3D.for_particles(scene_t.cfg, p_t, headroom=2.0)
    assert spec_t2 == spec_t
    b_t = fast3d.from_particles(p_t, scene_t.cfg, spec_t, device="cpu")
    _assert_bits_equal(_t(b_t), _fields(b))
    shift = np.float32(0.6 * scene.cfg.dx)
    moved = dataclasses.replace(b, x0=b.x0 + shift, x1=b.x1 - shift)
    moved_t = dataclasses.replace(b_t, x0=b_t.x0 + shift, x1=b_t.x1 - shift)
    if capacity == "grown":
        spec = dataclasses.replace(spec, capacity=spec.capacity + 128)
        spec_t = dataclasses.replace(spec_t, capacity=spec_t.capacity + 128)
    out = fast3d_jax.rebucket(moved, scene.cfg, spec)
    out_t = fast3d.rebucket(moved_t, scene_t.cfg, spec_t)
    _assert_bits_equal(_t(out_t), _fields(out))
    assert int(out_t.overflow) == 0 and int((out_t.mask > 0).sum()) == p.n


def test_run_across_rebuckets_tracks_jax():
    """80 substeps of a column thrown sideways on both bucketed axes and
    down (tests/test_fast3d.py:131-158 throws it at 1.5 m/s along x only,
    which drifts 0.6 cells in 80 substeps and never reaches the margin
    trigger): rebuckets fire, and the ensemble tracks the JAX general
    path within tests/test_fast3d.py's 5e-4."""
    kw = dict(SMALL, dt=2e-4)
    p, scene = scenes_jax.dam_break_3d(**kw)
    p_t, scene_t = scenes.dam_break_3d(**kw)
    v = np.zeros((p.n, 3), np.float32)
    v[:, 0], v[:, 1], v[:, 2] = 3.0, 2.0, -1.0
    p = dataclasses.replace(p, v=p.v.at[:].set(v))
    p_t = dataclasses.replace(p_t, v=torch.from_numpy(v))
    spec_t = fast3d.FastSpec3D.for_particles(scene_t.cfg, p_t, headroom=2.0)
    stats = RunStats()
    out = fast3d.run(fast3d.from_particles(p_t, scene_t.cfg, spec_t, device="cpu"), scene_t,
                     spec_t, 80, stats)
    ref = np.asarray(run_ref_jax(p, scene, 80).x)
    assert stats.rebuckets >= 1 and stats.substeps == stats.host_reads == 80
    h = fast3d.to_host(out)
    x = np.stack([h["x0"], h["x1"], h["x2"]], -1)
    cfg = scene_t.cfg
    assert x.shape == ref.shape and np.isfinite(x).all()
    assert ((x > -cfg.dx) & (x < cfg.domain_length + cfg.dx)).all()
    assert int(out.overflow) == 0
    np.testing.assert_allclose(x.mean(axis=0), ref.mean(axis=0), atol=5e-4)
    np.testing.assert_allclose(h["mass"].sum(), float(p_t.mass.sum()), rtol=1e-6)


def test_stabilized_run_across_a_rebucket_tracks_jax():
    """25 substeps of the stabilized switch set with the column set 1.5
    cells off the walls (their penalty band would hold it back) and thrown
    along both bucketed axes, 0.06 and 0.04 cells per substep, so the
    margin check fires a rebucket on the way: JAX `fast3d.run` and the
    port rebucket at the same substeps and stay in the same slot layout."""
    kw = dict(SMALL, dt=2e-4)
    p, scene = scenes_jax.dam_break_3d(**kw, **STAB)
    v = np.zeros((p.n, 3), np.float32)
    v[:, 0], v[:, 1], v[:, 2] = 12.0, 8.0, -1.0
    off = np.float32(1.5 * scene.cfg.dx)
    p = dataclasses.replace(p, v=p.v.at[:].set(v), x=p.x.at[:, :2].add(off))
    spec = fast3d_jax.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
    b = fast3d_jax.from_particles(p, scene.cfg, spec)
    scene_t = convert.scene_from_fields(dataclasses.asdict(scene))
    spec_t = fast3d.FastSpec3D(spec.rows0, spec.rows1, spec.capacity)
    stats = fast3d.RunStats()
    b_t = convert.buckets3d_from_numpy(_fields(b), device="cpu")
    out_t = fast3d.run(b_t, scene_t, spec_t, 25, stats)
    out = fast3d_jax.run(b, scene, spec, 25)
    assert stats.rebuckets >= 1 and stats.substeps == 25
    got, want = _t(out_t), _fields(out)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for a in range(3):
        np.testing.assert_allclose(got[f"x{a}"], want[f"x{a}"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[f"v{a}"], want[f"v{a}"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["jbar_s"], want["jbar_s"], rtol=0, atol=1e-5)
    assert int(out.overflow) == int(out_t.overflow) == 0
