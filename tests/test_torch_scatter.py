"""The general path's scatter-add (`ops/cuda/scatter.py`) on the CPU.

On the CPU `scatter_add` is `index_add_`, which adds each node's rows in
ascending position from zero, as XLA's CPU scatter does.  The card's
kernel (csrc/scatter.cu; tests/test_torch_cuda.py holds it to the CPU bit
for bit) walks `segment_plan`'s runs in that order: here the plan's runs,
summed one add after another in plain Python order, give the CPU's sums
bit for bit, so the plan states the order the kernel must follow.
"""

import numpy as np
import pytest
import torch

from mpm_flip98a_tpu_torch.models import stabilized
from mpm_flip98a_tpu_torch.ops import transfer
from mpm_flip98a_tpu_torch.ops.cuda import scatter


def _rows(dtype, seed=0, m=4000, nodes=300, c=5):
    rng = np.random.default_rng(seed)
    # Clustered ids (many rows a node, in no order) and rows spanning many
    # magnitudes, so the order of the adds shows in the last bits.
    flat = torch.from_numpy(rng.integers(0, nodes // 3, m) * 3 + rng.integers(0, 2, m))
    vals = rng.normal(0.0, 1.0, (m, c)) * 10.0 ** rng.uniform(-6, 6, (m, 1))
    return torch.from_numpy(vals).to(dtype), flat, nodes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_is_index_add(dtype):
    vals, flat, nodes = _rows(dtype)
    want = torch.zeros((nodes, vals.shape[1]), dtype=dtype).index_add_(0, flat, vals)
    got = scatter.scatter_add(vals, flat, nodes)
    assert got.dtype == dtype and torch.equal(got, want)
    assert scatter.LAUNCHES["scatter"] == 0
    # The general path's two scatters take it: the node transfer and the
    # F-bar cell sums.
    base = torch.from_numpy(np.random.default_rng(1).integers(1, 8, (50, 2)))
    offsets = np.array([[i, j] for i in range(3) for j in range(3)])
    index = transfer.flat_node_index(base, offsets, (12, 12))
    assert index.plan is None          # no sort on the CPU
    v = torch.from_numpy(np.random.default_rng(2).normal(0.0, 1.0, (50, 9, 3))).to(dtype)
    want = torch.zeros((144, 3), dtype=dtype).index_add_(0, index.flat.reshape(-1),
                                                          v.reshape(-1, 3))
    assert torch.equal(transfer.p2g_scatter(v, base, offsets, (12, 12), index),
                       want.reshape(12, 12, 3))
    cells = stabilized._scatter_cells(v[:, 0], base, (12, 12)).reshape(-1, 3)
    flat_c, _ = stabilized._flat_cell(base, (12, 12))
    assert torch.equal(cells, torch.zeros((144, 3), dtype=dtype).index_add_(0, flat_c, v[:, 0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_plan_gives_the_cpu_order(dtype):
    """Each node's run lists its rows in ascending position, and summing
    the runs from zero in that order is `index_add_` bit for bit; another
    order (the runs reversed) is not."""
    vals, flat, nodes = _rows(dtype, seed=3)
    plan = scatter.segment_plan(flat, nodes)
    assert plan.starts[0] == 0 and plan.starts[-1] == flat.numel()
    want = torch.zeros((nodes, vals.shape[1]), dtype=dtype).index_add_(0, flat, vals)
    got = torch.zeros_like(want)
    backwards = torch.zeros_like(want)
    for n in range(nodes):
        run = plan.order[plan.starts[n]:plan.starts[n + 1]]
        assert (flat[run] == n).all() and (run[1:] > run[:-1]).all()
        acc = torch.zeros(vals.shape[1], dtype=dtype)
        for r in run:
            acc = acc + vals[r]
        got[n] = acc
        acc = torch.zeros(vals.shape[1], dtype=dtype)
        for r in run.flip(0):
            acc = acc + vals[r]
        backwards[n] = acc
    assert torch.equal(got, want)
    assert not torch.equal(backwards, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_plan_leaves_out_zero_rows(dtype):
    """A plan that leaves out rows of +-0 (the slab domain's inert slots,
    many at one node) runs over the other rows alone, in ascending
    position, and its sums from zero are `index_add_` over every row bit
    for bit."""
    vals, flat, nodes = _rows(dtype, seed=4)
    rng = np.random.default_rng(5)
    zero = torch.from_numpy(rng.random(len(flat)) < 0.4)
    hot = torch.from_numpy(rng.random(len(flat)) < 0.3) & zero
    flat = torch.where(hot, 7, flat)                  # a node under many zero rows
    sign = torch.from_numpy(np.where(rng.random((len(flat), 1)) < 0.5, -1.0, 1.0)).to(dtype)
    vals = torch.where(zero[:, None], 0.0 * sign, vals)
    plan = scatter.segment_plan(flat, nodes, ~zero)
    assert plan.starts[-1] == int((~zero).sum()) and plan.order.shape == flat.shape
    want = torch.zeros((nodes, vals.shape[1]), dtype=dtype).index_add_(0, flat, vals)
    got = torch.zeros_like(want)
    for n in range(nodes):
        run = plan.order[plan.starts[n]:plan.starts[n + 1]]
        assert (flat[run] == n).all() and not zero[run].any() and (run[1:] > run[:-1]).all()
        acc = torch.zeros(vals.shape[1], dtype=dtype)
        for r in run:
            acc = acc + vals[r]
        got[n] = acc
    assert torch.equal(got, want) and not torch.signbit(want).logical_and(want == 0).any()


def test_scatter_add_checks_its_inputs():
    vals, flat, nodes = _rows(torch.float32)
    with pytest.raises(TypeError):
        scatter.scatter_add(vals.half(), flat, nodes)
    with pytest.raises(TypeError):
        scatter.scatter_add(vals, flat.int(), nodes)
    with pytest.raises(ValueError):
        scatter.scatter_add(vals[:, None], flat, nodes)
    with pytest.raises(ValueError):                   # no kernel, no plain route
        scatter.scatter_add(vals.to("meta"), flat.to("meta"), nodes)
