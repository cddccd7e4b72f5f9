"""The general path's scatter-add in a fixed order (csrc/scatter.cu).

Not a TPU kernel: the JAX general path scatters with XLA's `.at[].add`
(`mpm_flip98a_tpu/ops/transfer.py:70`; the F-bar cell sums of
`stabilized.py`).  Its plain version is `index_add_`, which on the CPU adds
the rows in their order, as XLA's CPU scatter does.  On the card
`index_add_` adds with atomics in no fixed order; the kernel instead sums
each node's rows from +0 in ascending row position, so on the same inputs
the card's sums are bitwise equal to the CPU's, and two card runs are
bitwise equal.

Two forms share the kernel.  The stencil form (`stencil_add`, the node
transfers) takes (N, S, c) rows, tap s of particle p landing on node
base[p] + offsets[s]; its plan (`stencil_plan`, built once a substep in
`transfer.flat_node_index`) sorts the particles, one key each (its base
node on a key grid widened by the stencil's reach), and the kernel merges
each node's S runs by particle index.  The one-tap form (`scatter_add`,
the F-bar cell sums) takes bare (M, c) rows and a node id a row; its plan
(`segment_plan`) sorts the ids.  A plan may leave out particles or rows
that are all +-0 (`keep`): a sum that starts from +0 never is -0, so
adding +-0 leaves it unchanged bit for bit, and the slab domain's inert
slots, all parked at one point, would otherwise make one node walk
hundreds of thousands of zero rows.  The stencil form reads the rows in
place and never a tap that is out of bounds (the CPU's clipped taps are
+0).

bfloat16 (the JAX package's bf16 mode): XLA's CPU scatter rounds each
node's sum to bfloat16 after every add, in update order, where the CPU's
`index_add_` sums in float32 and rounds once.  So the bf16 plain version
is that sequential rounded sum (`sequential_add_bf16`), and the kernel's
bf16 mode rounds after every add in the same order: the two are bitwise
equal, and equal to JAX's `.at[].add`.

The wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  `LAUNCHES["scatter"]` counts
the sum kernel's launches in both forms and every dtype,
`MODE_LAUNCHES["bf16"]` those of its bfloat16 instance among them,
`LAUNCHES["scatter_keys"]` the stencil plan's key kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpm_flip98a_tpu_torch import _build
from mpm_flip98a_tpu_torch.ops.cuda.transfer2d import _check, _ptr, _raise_on, _route, _stream
from mpm_flip98a_tpu_torch.ops.weights import constant, stencil_offsets

LAUNCHES = {"scatter": 0, "scatter_keys": 0}
MODE_LAUNCHES = {"bf16": 0}

# The kernel packs a particle index with its tap into 32 bits (index x 32 + tap).
MAX_PARTICLES = 1 << 27


def reset_launches() -> None:
    for counts in (LAUNCHES, MODE_LAUNCHES):
        for k in counts:
            counts[k] = 0


class SegmentPlan(NamedTuple):
    """Runs of rows (one-tap form) or particles (stencil form) in ascending
    index: run k is order[starts[k]] .. order[starts[k + 1] - 1]."""

    order: torch.Tensor    # (M,) int32
    starts: torch.Tensor   # (runs + 1,) int32


_RUN_IDS = {}     # (runs, device) -> arange(runs + 1) int32, made once


def _runs(ids: torch.Tensor, runs: int) -> SegmentPlan:
    """Stable sort of the int32 ids (each in [0, runs]; `runs` sorts last
    and belongs to no run) and each run's start, found in the sorted ids."""
    ids, order = torch.sort(ids, stable=True)
    key = (runs, str(ids.device))
    if key not in _RUN_IDS:
        _RUN_IDS[key] = torch.arange(runs + 1, dtype=torch.int32, device=ids.device)
    return SegmentPlan(order.to(torch.int32),
                       torch.searchsorted(ids, _RUN_IDS[key], out_int32=True))


def segment_plan(flat: torch.Tensor, nodes: int, keep: Optional[torch.Tensor] = None
                 ) -> SegmentPlan:
    """The one-tap plan: a stable sort of the (M,) int64 node ids `flat`
    (each in [0, nodes)) and each node's run start.  Rows where the (M,)
    bool `keep` is False (rows of +-0 only) sort after every kept row,
    under the id `nodes`, and belong to no run."""
    if flat.numel() >= 2**31 or nodes >= 2**31 - 1:
        raise ValueError(f"{flat.numel()} rows into {nodes} nodes: the plan takes int32 ids")
    flat = flat.reshape(-1)
    ids = flat if keep is None else torch.where(keep.reshape(-1), flat, nodes)
    return _runs(ids.to(torch.int32), nodes)


def _key_grid(base: torch.Tensor, grid_shape):
    """(key grid shape, cells), checked against the kernels' int32 limits."""
    kshape = [int(g) + 2 for g in grid_shape]
    cells = int(np.prod(kshape))
    if base.shape[0] >= MAX_PARTICLES or cells >= 2**31 - 1:
        raise ValueError(f"{base.shape[0]} particles on {tuple(kshape)} key cells: "
                         f"the plan takes below {MAX_PARTICLES} and 2^31 - 1")
    return kshape, cells


def stencil_keys_plain(base: torch.Tensor, grid_shape, keep: Optional[torch.Tensor] = None):
    """Plain version of `stencil_keys`."""
    kshape, cells = _key_grid(base, grid_shape)
    key, ok, stride = None, keep, 1
    for k in reversed(range(len(kshape))):
        b = base[:, k]
        inb = (b >= -2) & (b < kshape[k] - 2)
        ok = inb if ok is None else ok & inb
        term = (b + 2) * stride
        key = term if key is None else key + term
        stride *= kshape[k]
    return torch.where(ok, key, cells).to(torch.int32), cells


def stencil_keys(base: torch.Tensor, grid_shape, keep: Optional[torch.Tensor] = None):
    """(keys (N,) int32, cells): each particle's (N, d) integer base node
    shifted by 2 on the key grid (grid_shape + 2 on every axis), row-major,
    so every particle with a tap in bounds has a cell; `cells` for those
    with none, or where the (N,) bool `keep` is False (rows of +-0 only).
    On the card one launch (`LAUNCHES["scatter_keys"]`)."""
    d = len(grid_shape)
    if base.dim() != 2 or base.shape[1] != d or d not in (2, 3):
        raise ValueError(f"base: expected (N, 2 or 3) for a {d}D grid, got {tuple(base.shape)}")
    on = (base,) if keep is None else (base, keep)
    if _route(*on) == "cpu":
        return stencil_keys_plain(base, grid_shape, keep)
    _, cells = _key_grid(base, grid_shape)
    n = base.shape[0]
    base = base.to(torch.int64).contiguous()
    if keep is not None:
        _check("keep", keep, (n,), torch.bool)
    keys = torch.empty((n,), dtype=torch.int32, device=base.device)
    g = [int(x) for x in grid_shape] + [0] * (3 - d)
    rc = _build.load().lib.mpm_stencil_keys(
        _ptr(base), None if keep is None else _ptr(keep), n, d, *g, _ptr(keys), _stream(base))
    LAUNCHES["scatter_keys"] += 1
    _raise_on(rc, "scatter_keys")
    return keys, cells


def stencil_plan(base: torch.Tensor, grid_shape, keep: Optional[torch.Tensor] = None
                 ) -> SegmentPlan:
    """The stencil plan: a stable sort of the N `stencil_keys` and each key
    cell's run start; the particles with no tap in bounds or `keep` False
    sort after every cell and belong to no run."""
    return _runs(*stencil_keys(base, grid_shape, keep))


def _launch(values: torch.Tensor, plan: SegmentPlan, nodes: int, taps: int, g1: int, g2: int
            ) -> torch.Tensor:
    """The kernel over `values` (rows, c) in (particle, tap) order."""
    c = values.shape[-1]
    _check("order", plan.order, (values.shape[0] // taps,), torch.int32)
    if plan.starts.dtype != torch.int32 or plan.starts.dim() != 1:
        raise TypeError(f"starts: expected (runs + 1,) int32, got {plan.starts.dtype} "
                        f"{tuple(plan.starts.shape)}")
    _route(values, plan.order, plan.starts)
    values = values.contiguous()
    out = torch.empty((nodes, c), dtype=values.dtype, device=values.device)
    lib = _build.load().lib
    fn = {torch.float32: lib.mpm_segment_sum_f32, torch.float64: lib.mpm_segment_sum_f64,
          torch.bfloat16: lib.mpm_segment_sum_bf16}[values.dtype]
    rc = fn(_ptr(values), _ptr(plan.order), _ptr(plan.starts), _ptr(out), nodes, c, taps, g1,
            g2, _stream(values))
    LAUNCHES["scatter"] += 1
    MODE_LAUNCHES["bf16"] += values.dtype == torch.bfloat16
    _raise_on(rc, "scatter")
    return out


def _check_values(values: torch.Tensor, dim: int) -> None:
    if values.dim() != dim:
        raise ValueError(f"values: expected {dim} dimensions, got {tuple(values.shape)}")
    if values.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"values: expected float32, float64 or bfloat16, got {values.dtype}")


def sequential_add_bf16(values: torch.Tensor, flat: torch.Tensor, nodes: int) -> torch.Tensor:
    """bfloat16 rows (M, c) added into (nodes, c) one after another in row
    order from +0, each node's sum rounded to bfloat16 after every add (XLA's
    CPU `.at[].add` in bfloat16).  Rows of +-0 only are left out (they leave
    such a sum unchanged bit for bit); the rest go in rank levels: level r
    adds every node's r-th row at once, so no node appears twice in a level."""
    out = torch.zeros((nodes, values.shape[-1]), dtype=torch.bfloat16, device=values.device)
    live = torch.nonzero((values != 0).any(dim=-1)).reshape(-1)
    if live.numel() == 0:
        return out
    ids, order = torch.sort(flat.reshape(-1)[live], stable=True)
    rows = values[live[order]]
    pos = torch.arange(ids.numel(), device=ids.device)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), dim=0).values
    by_rank = torch.sort(rank, stable=True).indices
    at = 0
    for count in torch.bincount(rank).tolist():
        sel = by_rank[at : at + count]
        at += count
        node = ids[sel]
        out[node] = out[node] + rows[sel]
    return out


def scatter_add_plain(values: torch.Tensor, flat: torch.Tensor, nodes: int) -> torch.Tensor:
    """Plain version: rows (M, c) added into (nodes, c) in row order: by
    `index_add_` in float32 and float64, by `sequential_add_bf16` in
    bfloat16."""
    if values.dtype == torch.bfloat16:
        return sequential_add_bf16(values, flat, nodes)
    out = torch.zeros((nodes, values.shape[-1]), dtype=values.dtype, device=values.device)
    out.index_add_(0, flat.reshape(-1), values)
    return out


def scatter_add(values: torch.Tensor, flat: torch.Tensor, nodes: int,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """The one-tap form: (M, c) float32, float64 or bfloat16 rows summed by their
    node id `flat` (M,) int64 into (nodes, c).  On the card every node adds
    its rows in ascending position from zero (the CPU `index_add_`'s
    order); `plan`, `segment_plan(flat, nodes)`, is built here when not
    given."""
    _check_values(values, 2)
    _check("flat", flat.reshape(-1), (values.shape[0],), torch.int64)
    if _route(values, flat) == "cpu":
        return scatter_add_plain(values, flat, nodes)
    plan = segment_plan(flat, nodes) if plan is None else plan
    if plan.starts.shape != (nodes + 1,):
        raise ValueError(f"starts: expected ({nodes + 1},), got {tuple(plan.starts.shape)}")
    return _launch(values, plan, nodes, 1, 0, 0)


def stencil_flat(base: torch.Tensor, offsets: np.ndarray, grid_shape):
    """Row-major flat node index (N, S) int64 of every (particle, tap),
    clipped into the grid, and whether the tap is in bounds (N, S)."""
    off = constant(np.asarray(offsets), torch.int64, base.device)
    strides = np.concatenate([np.cumprod(np.asarray(grid_shape[1:], np.int64)[::-1])[::-1], [1]])
    flat, in_bounds = None, None
    for k, g in enumerate(grid_shape):
        idx = base[:, None, k].to(torch.int64) + off[None, :, k]
        ok = (idx >= 0) & (idx < g)
        term = idx.clamp(0, g - 1) * int(strides[k])
        flat = term if flat is None else flat + term
        in_bounds = ok if in_bounds is None else in_bounds & ok
    return flat, in_bounds


def stencil_add_plain(values: torch.Tensor, base: torch.Tensor, offsets: np.ndarray,
                      grid_shape) -> torch.Tensor:
    """Plain version of the stencil form: the out-of-bounds taps set to +0
    and every row added by `index_add_` over the clipped flat index."""
    flat, in_bounds = stencil_flat(base, offsets, grid_shape)
    values = torch.where(in_bounds[..., None], values, 0.0)
    return scatter_add_plain(values.reshape(-1, values.shape[-1]), flat,
                             int(np.prod(grid_shape)))


def stencil_add(values: torch.Tensor, base: torch.Tensor, offsets: np.ndarray, grid_shape,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """The stencil form: (N, S, c) float32, float64 or bfloat16 rows, tap s of
    particle p on node base[p] + offsets[s] of `grid_shape` (2D or 3D),
    summed into (nodes, c); taps out of bounds add nothing.  On the card
    every node adds its rows in ascending (particle, tap) position from
    zero, the CPU `index_add_`'s order; `plan`, `stencil_plan(base,
    grid_shape)`, is built here when not given."""
    _check_values(values, 3)
    d = len(grid_shape)
    n, taps = values.shape[:2]
    if tuple(base.shape) != (n, d) or taps != len(offsets):
        raise ValueError(f"values {tuple(values.shape)}, base {tuple(base.shape)}, "
                         f"{len(offsets)} taps on a {d}D grid")
    if _route(values, base) == "cpu":
        return stencil_add_plain(values, base, offsets, grid_shape)
    if d not in (2, 3) or not np.array_equal(np.asarray(offsets), stencil_offsets(d)):
        raise ValueError(f"the kernel takes the {{0, 1, 2}}^d taps in row-major order on a "
                         f"2D or 3D grid, got {d}D offsets {np.asarray(offsets).tolist()}")
    plan = stencil_plan(base, grid_shape) if plan is None else plan
    cells = int(np.prod([g + 2 for g in grid_shape]))
    if plan.starts.shape != (cells + 1,):
        raise ValueError(f"starts: expected ({cells + 1},), got {tuple(plan.starts.shape)}")
    g1, g2 = (int(grid_shape[1]), 0) if d == 2 else (int(grid_shape[1]), int(grid_shape[2]))
    return _launch(values.reshape(n * taps, -1), plan, int(np.prod(grid_shape)), taps, g1, g2)
