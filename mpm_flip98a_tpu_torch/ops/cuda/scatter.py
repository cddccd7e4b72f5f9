"""The general path's scatter-add in a fixed order (csrc/scatter.cu).

Not a TPU kernel: the JAX general path scatters with XLA's `.at[].add`
(`mpm_flip98a_tpu/ops/transfer.py:70`; the F-bar cell sums of
`stabilized.py`).  Its plain version is `index_add_`, which on the CPU adds
the rows in their order, as XLA's CPU scatter does.  On the card
`index_add_` adds with atomics in no fixed order; `scatter_add` instead
sorts the rows' node ids once (`segment_plan`: a stable `torch.sort`, so a
node's rows stay in ascending position) and `segment_sum` sums each node's
run in that order from zero.  On the same inputs the card's sums are
bitwise equal to the CPU's, and two card runs are bitwise equal.  A plan
may leave out rows that are all +-0 (`keep`): a sum that starts from +0
never is -0, so adding +-0 leaves it unchanged bit for bit, and the
slab domain's inert slots, all parked at one point, would otherwise make
one thread walk hundreds of thousands of zero rows.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  `LAUNCHES["scatter"]` counts
its launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpm_flip98a_tpu_torch import _build
from mpm_flip98a_tpu_torch.ops.cuda.transfer2d import _check, _ptr, _raise_on, _route, _stream

LAUNCHES = {"scatter": 0}


def reset_launches() -> None:
    LAUNCHES["scatter"] = 0


class SegmentPlan(NamedTuple):
    """The rows of each node, in ascending row position: node n's rows are
    order[starts[n]] .. order[starts[n + 1] - 1]."""

    order: torch.Tensor    # (M,) int64
    starts: torch.Tensor   # (nodes + 1,) int64


def segment_plan(flat: torch.Tensor, nodes: int, keep: Optional[torch.Tensor] = None
                 ) -> SegmentPlan:
    """Stable sort of the (M,) int64 node ids `flat` (each in [0, nodes)),
    and each node's run start: built once per substep and shared by the
    scatters over the same index.  Ids below 2^31 are sorted as int32: the
    same permutation, from a radix sort over 32 key bits instead of 64.
    Rows where the (M,) bool `keep` is False (rows of +-0 only) sort after
    every kept row, under the id `nodes`, and belong to no run."""
    flat = flat.reshape(-1)
    ids, bins = flat, nodes
    if keep is not None:
        ids, bins = torch.where(keep.reshape(-1), flat, nodes), nodes + 1
    keys = ids.to(torch.int32) if bins <= 2**31 else ids
    order = torch.sort(keys, stable=True).indices
    starts = torch.zeros((nodes + 1,), dtype=torch.int64, device=flat.device)
    torch.cumsum(torch.bincount(ids, minlength=bins)[:nodes], 0, out=starts[1:])
    return SegmentPlan(order, starts)


def scatter_add_plain(values: torch.Tensor, flat: torch.Tensor, nodes: int) -> torch.Tensor:
    """Plain version: rows (M, c) added into (nodes, c) by `index_add_`."""
    out = torch.zeros((nodes, values.shape[-1]), dtype=values.dtype, device=values.device)
    out.index_add_(0, flat.reshape(-1), values)
    return out


def scatter_add(values: torch.Tensor, flat: torch.Tensor, nodes: int,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """(M, c) float32 or float64 rows summed by their node id `flat` (M,)
    int64 into (nodes, c).  On the card every node adds its rows in
    ascending position from zero (the CPU `index_add_`'s order); `plan`,
    `segment_plan(flat, nodes)`, is built here when not given."""
    if values.dim() != 2:
        raise ValueError(f"values: expected (M, c), got {tuple(values.shape)}")
    m, c = values.shape
    _check("flat", flat.reshape(-1), (m,), torch.int64)
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values: expected float32 or float64, got {values.dtype}")
    if _route(values, flat) == "cpu":
        return scatter_add_plain(values, flat, nodes)
    plan = segment_plan(flat, nodes) if plan is None else plan
    _check("order", plan.order, (m,), torch.int64)
    _check("starts", plan.starts, (nodes + 1,), torch.int64)
    _route(values, plan.order, plan.starts)
    values = values.contiguous()
    out = torch.empty((nodes, c), dtype=values.dtype, device=values.device)
    lib = _build.load().lib
    fn = lib.mpm_segment_sum_f32 if values.dtype == torch.float32 else lib.mpm_segment_sum_f64
    rc = fn(_ptr(values), _ptr(plan.order), _ptr(plan.starts), _ptr(out), nodes, c,
            _stream(values))
    LAUNCHES["scatter"] += 1
    _raise_on(rc, "scatter")
    return out
