"""Bit-exact reruns of the port on the CPU (twins of tests/test_determinism.py).

The reference checks that two runs of the same program agree to the last
bit, on the general path and the fast path (37^2, float32, 100 substeps:
tests/test_determinism.py:22-37).  The port is held the same way there,
and on the plastic scenes at 37^2: the sand column (dt 5e-5, 12 x 30) and
the snow block thrown at the floor (dt 2e-5, 24^2 at -2 m/s), whose
updates run the SVD, the return map and the Jp clamp; and the 3D fast
path at 16^3 on its fused branch (the fluid stress inside `p2g3d_grid`)
and its prepped one (the stabilized set), on one device and in two slab
shards (`SlabMesh(2)`, `p2g3d_grid`'s raw mode).  On the CPU every sum has
a fixed order (`index_add_` is sequential there; the fast path's plain
kernel versions sum in a fixed order).  On the card every P2G kernel and
the general path's scatter sum in a fixed order too, and chip_smoke.py
holds their reruns bitwise equal (main:plastic, main:checkpoint, the
kernels' rerun checks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes, stabilized
from mpm_flip98a_tpu_torch.parallel import SlabMesh
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

FAST = MPMConfig(dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16,
                 num_particles_y=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    if name == "dam2d":
        return scenes.dam_break_2d(FAST, dtype=np.float32)
    if name == "sand2d":
        return scenes.sand_column_2d(MPMConfig(dtype="float32", num_grids=37, dt=5e-5),
                                     dtype=np.float32, particles_per_axis=(12, 30))
    p, scene = scenes.snow_block_2d(MPMConfig(dtype="float32", num_grids=37, dt=2e-5),
                                    dtype=np.float32, drop_height_frac=0.08,
                                    particles_per_axis=24)
    v = torch.zeros_like(p.v)
    v[:, 1] = -2.0
    return dataclasses.replace(p, v=v), scene


@pytest.mark.parametrize("name", ["dam2d", "sand2d", "snow2d"])
def test_general_path_bit_exact(name):
    p, scene = _scene(name)
    a = stabilized.run(p, scene, 100)
    b = stabilized.run(p, scene, 100)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert not torch.equal(a.x, p.x)


@pytest.mark.parametrize("name", ["dam2d", "sand2d", "snow2d"])
def test_fast_path_bit_exact(name):
    p, scene = _scene(name)
    spec = fast2d.FastSpec.for_particles(scene.cfg, p, headroom=2.0)
    b0 = fast2d.from_particles(p, scene.cfg, spec, "cpu")
    a = fast2d.run(b0, scene, spec, 100)
    b = fast2d.run(b0, scene, spec, 100)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert not torch.equal(a.x1, b0.x1)


@pytest.mark.parametrize("shards", [1, 2], ids=["one_device", "slab2"])
@pytest.mark.parametrize("branch", ["fused", "prepped"])
def test_fast3d_path_bit_exact(branch, shards):
    stab = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0,
                flip_blend=0.98, transfer=TransferKind.PIC) if branch == "prepped" else {}
    p, scene = scenes.dam_break_3d(num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5,
                                   dtype=np.float32, **stab)
    if shards == 1:
        spec = fast3d.FastSpec3D.for_particles(scene.cfg, p, headroom=2.0)
        b0 = fast3d.from_particles(p, scene.cfg, spec, "cpu")
        step = lambda b: fast3d.run(b, scene, spec, 10)
    else:
        mesh = SlabMesh(shards, "cpu")
        spec = fd3.FastDomain3DSpec.for_particles(scene.cfg, shards, p)
        b0 = fd3.distribute(p, scene.cfg, spec, mesh)
        step = lambda b: fd3.make_run(scene, spec, mesh)(b, 10)
    assert fast3d.uses_fused(scene) == (branch == "fused")
    a, b = step(b0), step(b0)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert not torch.equal(a.x2, b0.x2)
