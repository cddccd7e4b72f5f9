"""Particle <-> grid transfers of the general path (counterpart of `mpm_flip98a_tpu/ops/transfer.py`).

All 3^dim stencil contributions ride along a static stencil axis and go to
the grid in one `index_add_` (P2G) or come back in one gather (G2P) over
row-major flat node indices (int64).  Out-of-range stencil nodes are
clipped and their contributions zeroed, as in the JAX module; in-domain
particles never produce one, since the grid is padded.

The flat index can be built once (`flat_node_index`) and passed to both
transfers of a substep.  The gather takes whole rows, or single elements
where the rows are a multiple of 16 bytes.  The scatter is
`ops/cuda/scatter.scatter_add`: on the CPU `index_add_`, which adds the
updates in order, as XLA's CPU scatter does; on the card a kernel that
sums each node's rows in that same order (a stable sort of the flat index,
built once in `flat_node_index` and shared by the substep's scatters), so
card runs are bitwise reproducible and equal to the CPU's sums.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpm_flip98a_tpu_torch.ops.cuda import scatter
from mpm_flip98a_tpu_torch.ops.weights import constant


class Index(NamedTuple):
    flat: torch.Tensor          # (N, S) int64 row-major node index, clipped
    in_bounds: torch.Tensor     # (N, S) bool
    plan: Optional[scatter.SegmentPlan] = None   # the card's fixed scatter order


def flat_node_index(base: torch.Tensor, offsets: np.ndarray, grid_shape,
                    keep: Optional[torch.Tensor] = None) -> Index:
    """Flat node index of every (particle, stencil node) pair.

    base: (N, d) integer base nodes; offsets: (S, d) static.  On the card
    the index also carries the scatter's `segment_plan` (one stable sort a
    substep), which leaves out the rows of particles where the (N,) bool
    `keep` is False (particles whose every contribution is +-0: the sums
    are the same bit for bit); the CPU's `index_add_` needs none."""
    off = constant(offsets, torch.int64, base.device)
    strides = np.concatenate([np.cumprod(np.asarray(grid_shape[1:], np.int64)[::-1])[::-1], [1]])
    flat, in_bounds = None, None
    for k, g in enumerate(grid_shape):
        idx = base[:, None, k].to(torch.int64) + off[None, :, k]
        ok = (idx >= 0) & (idx < g)
        term = idx.clamp(0, g - 1) * int(strides[k])
        flat = term if flat is None else flat + term
        in_bounds = ok if in_bounds is None else in_bounds & ok
    plan = None
    if flat.is_cuda:
        rows = None if keep is None else keep[:, None].expand(flat.shape)
        plan = scatter.segment_plan(flat, int(np.prod(grid_shape)), rows)
    return Index(flat, in_bounds, plan)


def p2g_scatter(
    values: torch.Tensor,
    base: torch.Tensor,
    offsets: np.ndarray,
    grid_shape,
    index: Optional[Index] = None,
) -> torch.Tensor:
    """Scatter-add weighted per-(particle, stencil node) values (N, S, c)
    onto the grid; returns (G..., c)."""
    c = values.shape[-1]
    index = index if index is not None else flat_node_index(base, offsets, grid_shape)
    values = torch.where(index.in_bounds[..., None], values, 0.0)
    out = scatter.scatter_add(values.reshape(-1, c), index.flat.reshape(-1),
                              int(np.prod(grid_shape)), index.plan)
    return out.reshape(tuple(grid_shape) + (c,))


def g2p_gather(
    grid: torch.Tensor,
    base: torch.Tensor,
    offsets: np.ndarray,
    index: Optional[Index] = None,
) -> torch.Tensor:
    """Grid values (G..., c) at every stencil node of every particle:
    (N, S, c)."""
    grid_shape = grid.shape[:-1]
    c = grid.shape[-1]
    flat, in_bounds, _ = index if index is not None else flat_node_index(base, offsets, grid_shape)
    if c * grid.element_size() % 16:
        vals = grid.reshape(-1, c).index_select(0, flat.reshape(-1)).reshape(flat.shape + (c,))
    else:
        # Rows of a multiple of 16 bytes take PyTorch's vectorised row
        # gather on the card, a block per index: 5.57 ms for bench 1M's 9M
        # rows of 4 float32 channels on an H100, against 0.53 ms for this
        # element-wise gather over (N, S, c) element indices (which loses
        # to `index_select` on 24-byte rows: 2.32 against 1.22 ms at slab
        # 1M; scripts/general_gather_variants.py).
        elem = flat[..., None] * c + constant(np.arange(c), torch.int64, grid.device)
        vals = grid.reshape(-1)[elem]
    return torch.where(in_bounds[..., None], vals, 0.0)
