"""The port's kinematic colliders in slab shards against the port's one
device: tests/test_colliders.py's kinematic plow in 4 slab shards (2D,
tests/test_colliders.py:528-551) and its kinematic sphere in 2 (3D),
slot for slot, in float32 and through the plain versions in float64.

They use tests/test_torch_colliders.py's and
tests/test_torch_colliders3d.py's scenes and setups and run no JAX
reference (tests/test_torch_colliders_kinematic.py and
tests/test_torch_colliders3d_kinematic.py hold the one-device paths to
JAX); the 2D plow's port runs take 45-85 s on the CPU, so they have a
module of their own and each file stays inside its share of the suite's
time.
"""

import dataclasses

import numpy as np
import torch

from mpm_flip98a_tpu_torch import convert
from mpm_flip98a_tpu_torch.models import fast2d, fast3d
from mpm_flip98a_tpu_torch.parallel import SlabMesh
from mpm_flip98a_tpu_torch.parallel import fast_domain as fd
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3

from test_torch_colliders import (   # with its autouse fixture
    _f64, _one_torch_thread, _setup)
from test_torch_colliders3d import _states


def test_kinematic_sharded_matches_single_device():
    """tests/test_colliders.py:528-551: the plow in 4 slab shards against
    one device, 60 substeps from t0 = 0.03, slot for slot: v, C and J to
    1e-5 of their scale, the displacement to 1e-5 of its own; then 20
    substeps in float64 through the plain versions to 1e-9."""
    (p, _, _, _), (scene_t, _, _) = _setup("plow")
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    mesh = SlabMesh(4, "cpu")
    spec = fd.FastDomainSpec.for_particles(scene_t.cfg, 4, p_t, headroom=2.0)
    b = fd.distribute(p_t, scene_t.cfg, spec, mesh)
    spec1 = fast2d.FastSpec.for_particles(scene_t.cfg, p_t, headroom=2.0)
    b1 = fast2d.from_particles(p_t, scene_t.cfg, spec1, device="cpu")
    run = fd.make_run(scene_t, spec, mesh)
    for start, single, n, tol, plain in ((b, b1, 60, 1e-5, False),
                                         (_f64(b), _f64(b1), 20, 1e-9, True)):
        got = run(start, n, t0=0.03, plain=plain)
        ref = fast2d.run(single, scene_t, spec1, n, t0=0.03, plain=plain)
        assert int(got.overflow.sum()) == 0 and int(ref.overflow) == 0
        live = lambda s, names: torch.stack([getattr(s, k)[s.mask > 0] for k in names]).double()
        groups = {"v": ("v0", "v1"), "C": ("C00", "C01", "C10", "C11"), "J": ("J",)}
        pairs = {g: (live(got, k), live(ref, k)) for g, k in groups.items()}
        pairs["displacement"] = (live(got, ("x0", "x1")) - live(start, ("x0", "x1")),
                                 live(ref, ("x0", "x1")) - live(single, ("x0", "x1")))
        for g, (have, want) in pairs.items():
            scale = float(((want - 1.0) if g == "J" else want).abs().max())
            assert float((have - want).abs().max()) <= tol * scale, (g, n)
    # At t0 the plow overlaps the column's edge: its first substep acts.
    free = fast2d.substep(b1, dataclasses.replace(scene_t, colliders=()))
    hit = fast2d.substep(b1, scene_t, t=0.03)
    assert float((free.v0 - hit.v0).abs().max()) > 0.1


def test_3d_sharded_matches_single_device():
    """The kinematic scene in 2 slab shards (colliders in `_grid_update`
    on the halo planes) against one device (in `p2g3d_grid`'s node pass),
    5 substeps from t0 = 0.01, slot for slot: v, C and J to 1e-5 of their
    scale; then in float64 through the plain versions, where the
    displacement (in float32 a few ulps of x) is held too, to 1e-6.  Not
    to float64's 1e-9 (tests/test_torch_fast_domain3d.py): the shards'
    transfer coordinate is x0 less the slab origin s L0 dx, which sits some
    2e-7 cells off s L0 at the float32 inv_dx of `_gxs`, and the collider
    makes the grid velocity jump by O(1) m/s from one node to the next, so
    that shift moves v by ~2e-7 of its scale (read: v 1.8e-7, C 3.7e-7,
    J 4.9e-7, displacement 2.2e-7; without the collider 1e-10)."""
    (p, _, _, _, t0), (scene_t, spec1, _) = _states("kinematic")
    p_t = convert.particles_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device="cpu")
    mesh = SlabMesh(2, "cpu")
    spec = fd3.FastDomain3DSpec.for_particles(scene_t.cfg, 2, p_t, headroom=2.0)
    b = fd3.distribute(p_t, scene_t.cfg, spec, mesh)
    single = fast3d.from_particles(p_t, scene_t.cfg, spec1, device="cpu")
    run = fd3.make_run(scene_t, spec, mesh)
    live = lambda s, names: torch.stack([getattr(s, k)[s.mask > 0] for k in names]).double()
    groups = (("v", ("v0", "v1", "v2")), ("C", tuple(f"C{a}{c}" for a in range(3)
                                                      for c in range(3))), ("J", ("J",)))
    x = ("x0", "x1", "x2")
    for start, start1, tol, plain in ((b, single, 1e-5, False),
                                      (_f64(b), _f64(single), 1e-6, True)):
        got = run(start, 5, t0=t0, plain=plain)
        ref = fast3d.run(start1, scene_t, spec1, 5, t0=t0, plain=plain)
        assert int(got.overflow.sum()) == 0
        pairs = {g: (live(got, k), live(ref, k)) for g, k in groups}
        if plain:
            pairs["displacement"] = (live(got, x) - live(start, x), live(ref, x) - live(start1, x))
        for g, (have, want) in pairs.items():
            scale = float(((want - 1.0) if g == "J" else want).abs().max())
            assert float((have - want).abs().max()) <= tol * scale, (g, tol)
