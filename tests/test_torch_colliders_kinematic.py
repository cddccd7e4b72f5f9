"""The port's kinematic 2D colliders against the JAX package: the spinning
plow's time threading through `substep` and `run` against JAX `fast2d`,
and the three collider scenarios through the CLI (a moving collider gets
the frame's start time as the run's t0).

They use tests/test_torch_colliders.py's scenes, setup (`_setup`) and
tolerances, in a module of their own so that each file stays inside its
share of the suite's time.  The JAX kernels run in Pallas interpret mode;
the port runs its plain versions.
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.models import fast2d

from test_torch_colliders import (   # with its autouse fixture
    CFG, _assert_tracks, _np, _one_torch_thread, _setup, fast2d_jax, substep_jax)


def test_kinematic_time_threading_matches_jax():
    """The spinning plow (tests/test_colliders.py:455-493): one substep at
    t = f32(0.19), where the moved plow overlaps the column, then `run`
    from t0 = 0.123 over 30 substeps.  The spinner makes the surface
    velocity linear in the center, so a mis-indexed time errs by
    O(omega v n dt): a run started one substep late leaves the tolerance."""
    (_, scene, spec, b), (scene_t, spec_t, b_t) = _setup("spin_plow")
    t_hit = float(np.float32(0.19))
    b1 = substep_jax(b, scene, t=jnp.float32(t_hit))
    b1_t = fast2d.substep(b_t, scene_t, t=t_hit)
    _assert_tracks(b1_t, b1, 1e-7, v_atol=1e-4)
    static = fast2d.substep(b_t, scene_t)
    assert np.abs(_np(static, "v0") - _np(b1_t, "v0")).max() > 1.0   # the moved plow hit
    out = fast2d_jax.run(b, scene, spec, 30, 0.123)
    out_t = fast2d.run(b_t, scene_t, spec_t, 30, t0=0.123)
    _assert_tracks(out_t, out, 1e-5, v_rel=1e-5)
    late = fast2d.run(b_t, scene_t, spec_t, 30, t0=0.123 + CFG.dt)
    with pytest.raises(AssertionError):
        _assert_tracks(late, out, 1e-5, v_rel=1e-5)
    times = fast2d.substep_times(scene_t, 0.123, 3)
    assert times == [float(np.float32(0.123) + np.float32(j) * np.float32(CFG.dt))
                     for j in range(3)]
    assert fast2d.substep_times(dataclasses.replace(scene_t, colliders=()), 0.123, 2) == [None] * 2


@pytest.mark.parametrize("scenario", ["dam2d_obstacle", "plow2d", "dam3d_obstacle"])
def test_cli_runs_collider_scenarios_on_cpu(tmp_path, monkeypatch, scenario):
    """The JAX driver's collider scenarios through the port's CLI; a moving
    collider gets the frame's start time as the run's t0."""
    assert scenario in driver.SCENARIOS and scenario not in driver.UNPORTED_SCENARIOS
    seen = []
    for mod in (fast2d, driver.fast3d):
        real = mod.run
        monkeypatch.setattr(mod, "run", lambda *a, _r=real, **k: (seen.append(k["t0"]),
                                                                   _r(*a, **k))[1])
    sim = driver.main([
        "--scenario", scenario, "--path", "fast", "--frames", "2", "--substeps", "1", "--no-gif",
        "--sync-io",
        "--out", str(tmp_path), "--device", "cpu",
    ])
    assert sim.stats.substeps == sim.stats.host_reads == 2 and sim.frame_count == 2
    assert int(sim.state.overflow) == 0
    p, _ = driver.SCENARIOS[scenario]()
    x = sim.positions()
    assert x.shape == (p.n, sim.cfg.dim) and np.isfinite(x).all()
    assert os.path.exists(os.path.join(sim.frame_dir, "00002.png"))
    dt = sim.cfg.dt
    assert seen == ([0.0, dt] if scenario == "plow2d" else [None, None])
