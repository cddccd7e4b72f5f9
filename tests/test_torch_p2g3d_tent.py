"""The port's prepped 3D transfers with the tent taps against the JAX
Pallas kernels: `p2g3d` (cropped and halo1, and the fold of its JAX
expansion), `p2g3d_grid`'s prepped mode with slip walls, and `g2p3d`'s
gather of that JAX grid, padded on axis 0 only.

These are cases of tests/test_torch_p2g3d.py, on its random pencil slots,
with its checks and tolerances: the tent taps compile JAX kernels of their
own, which no case there shares, so they sit in a module apart, and each
file stays inside its share of the suite's time.
"""

import pytest

from test_torch_p2g3d import (   # with its autouse fixture
    TENT_MODES, _one_torch_thread, check_fold_of_expanded, check_g2p3d_gather, check_p2g3d,
    check_p2g3d_grid_prepped, check_p2g3d_halo1)


@pytest.mark.parametrize("mode", TENT_MODES)
def test_p2g3d_matches_jax(mode):
    check_p2g3d(mode)


@pytest.mark.parametrize("mode", TENT_MODES)
def test_fold_of_expanded_is_interior_of_raw_sums(mode):
    check_fold_of_expanded(mode)


@pytest.mark.parametrize("mode", TENT_MODES)
def test_p2g3d_halo1_matches_jax(mode):
    check_p2g3d_halo1(mode)


@pytest.mark.parametrize("case", ["tent_slip"])
def test_p2g3d_grid_prepped_matches_jax(case):
    check_p2g3d_grid_prepped(case)


@pytest.mark.parametrize("case", ["ext_tent_padded0"])
def test_g2p3d_gather_matches_jax(case):
    check_g2p3d_gather(case)
