"""The port's prepped 3D path against the JAX package: the dam with the
tent kernel, and the dam on the relative floor (mass floor 0: `p2g3d` +
`fold_rows0` + `_grid_update`, then the gather-mode `g2p3d`), one substep
each from a perturbed state; and the driver's `Simulation` on the prepped
branch.

The substeps are cases of tests/test_torch_stabilized3d.py's
`test_single_substep_matches_jax`, with its states, tolerances and checks
(`check_single_substep`): the JAX kernels they compile (the tent taps, the
expanded P2G) serve no variant there, so they sit in a module of their
own, and each file stays inside its share of the suite's time.  The
`Simulation` runs are port only.
"""

import numpy as np
import pytest

from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.config import TransferKind as TransferKind_t
from mpm_flip98a_tpu_torch.models import fast3d, scenes

from test_torch_stabilized3d import (   # with its autouse fixture
    TENT_RELFLOOR, _one_torch_thread, check_single_substep)


@pytest.mark.parametrize("variant", TENT_RELFLOOR)
def test_single_substep_matches_jax(variant):
    check_single_substep(variant)


@pytest.mark.parametrize("scene_kind", ["stabilized", "elastic_drop_3d"])
def test_simulation_runs_the_prepped_3d_branch(tmp_path, scene_kind):
    """`driver.Simulation` built from (particles, scene) routes by
    `cfg.dim` and runs the stabilized switch set and `elastic_drop_3d`,
    frames and VTK included."""
    if scene_kind == "stabilized":
        p, scene = scenes.dam_break_3d(
            num_grids=16, particles_per_axis=(6, 6, 10), dt=2e-5, flip_blend=0.98,
            transfer=TransferKind_t.PIC, use_fbar=True, use_penalty_ebc=True,
            pressure_mixing_ratio=1.0)
    else:
        p, scene = scenes.elastic_drop_3d()
    sim = driver.Simulation(p, scene, path="fast", out_dir=str(tmp_path), device="cpu",
                            render_res=64)
    sim.run(2, 3, gif=False, verbose=False)
    assert sim.stats.substeps == 6
    h = fast3d.to_host(sim.state)
    assert h["x0"].shape == (p.n,) and all(np.isfinite(h[n]).all() for n in h)
    assert np.abs(h["J"] - 1.0).max() < 0.1
    np.testing.assert_allclose(h["mass"].sum(), float(p.mass.sum()), rtol=1e-6)
    import os

    assert len(os.listdir(sim.frame_dir)) == 2 and len(os.listdir(sim.vtk_dir)) == 2
