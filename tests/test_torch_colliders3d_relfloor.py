"""The port's 3D path on the relative-floor route, with
tests/test_colliders.py's kinematic sphere, against the JAX package.

F-bar and mass floor 0 take `p2g3d` + `fold_rows0` + `_grid_update`, with
the colliders in torch `_grid_update`: 5 substeps from t0 = 0.01 against
JAX `fast3d.run` (tests/test_torch_colliders3d.py's `check_3d_run`: slot
for slot, x to 1e-6, v to 1e-5 of max |v|, J to 1e-6, and the run without
the sphere leaves that tolerance), on that module's scenes and states.
Each JAX run is a compile of its own (30-60 s on the CPU), so each of the
three 3D collider files holds one and stays inside its share of the
suite's time.
"""

import pytest

from test_torch_colliders3d import _one_torch_thread, check_3d_run   # with its autouse fixture


@pytest.mark.parametrize("kind", ["relfloor"])
def test_3d_run_matches_jax(kind):
    check_3d_run(kind)
