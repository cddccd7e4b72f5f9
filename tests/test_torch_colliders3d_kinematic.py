"""The port's 3D path with tests/test_colliders.py's kinematic sphere
against the JAX package, and the kernel's collider arguments.

5 substeps from t0 = 0.01 on the fused branch against JAX `fast3d.run`
(tests/test_torch_colliders3d.py's `check_3d_run`: slot for slot, x to
1e-6, v to 1e-5 of max |v|, J to 1e-6, and the run without the sphere
leaves that tolerance), on that module's scenes and states; and
`p2g3d_grid`'s limits on colliders and `tcol`.  Each JAX run is a compile
of its own (30-60 s on the CPU), so each of the three 3D collider files
holds one (tests/test_torch_colliders3d.py the static sphere's,
tests/test_torch_colliders3d_relfloor.py the relative floor's) and stays
inside its share of the suite's time.
"""

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.models import colliders as col
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3

from test_torch_colliders3d import (   # with its autouse fixture
    CASES, COUNTS, DX, G, NODE, R, SPIN_N, STATE, STRESS, _one_torch_thread, check_3d_run)


def test_p2g3d_grid_collider_arguments():
    """At most 8 3D colliders; the raw mode takes none; static colliders
    ignore `tcol`."""
    planes = tuple(torch.from_numpy(p) for p in STATE)
    counts = torch.from_numpy(COUNTS)
    sphere = col.Collider(**CASES["stress_static_sphere"][1][0])
    kw = dict(stress="linear", **STRESS, **NODE)
    with pytest.raises(ValueError, match="at most 8"):
        tk3.p2g3d_grid(planes, counts, R, G, DX, colliders=(sphere,) * 9, **kw)
    with pytest.raises(ValueError, match="3D"):
        tk3.p2g3d_grid(planes, counts, R, G, DX, **kw,
                       colliders=(col.Collider(kind="sphere", center=(0.1, 0.1), radius=0.1),))
    with pytest.raises(ValueError, match="raw mode"):
        tk3.p2g3d_grid(planes, counts, R, G, DX, raw=True, colliders=(sphere,), stress="linear")
    a = tk3.p2g3d_grid(planes, counts, R, G, DX, colliders=(sphere,), **kw)
    b = tk3.p2g3d_grid(planes, counts, R, G, DX, colliders=(sphere,), tcol=0.7, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    f, i, n = tk3.collider_arrays(tuple(col.Collider(**f) for f in CASES["ext_box_and_spinner"][1]))
    assert n == 2 and list(i) == [1, 1, 1, 0, 2, 0, 0, 1]
    assert f[19 + 10 : 19 + 13] == pytest.approx(list(np.asarray(SPIN_N) / np.linalg.norm(SPIN_N)))


@pytest.mark.parametrize("kind", ["kinematic"])
def test_3d_run_matches_jax(kind):
    check_3d_run(kind)
