"""Particle <-> grid transfers of the general path (counterpart of `mpm_flip98a_tpu/ops/transfer.py`).

All 3^dim stencil contributions ride along a static stencil axis and go to
the grid in one `index_add_` (P2G) or come back in one gather (G2P) over
row-major flat node indices (int64).  Out-of-range stencil nodes are
clipped and their contributions zeroed, as in the JAX module; in-domain
particles never produce one, since the grid is padded.

The flat index can be built once (`flat_node_index`) and passed to both
transfers of a substep.  The gather takes whole rows, or single elements
where the rows are a multiple of 16 bytes.  On the CPU `index_add_` adds the updates in order,
as XLA's CPU scatter does; on the card it adds with atomics in no fixed
order, so two runs there agree only to the rounding of the sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.ops.weights import constant

Index = Tuple[torch.Tensor, torch.Tensor]


def flat_node_index(base: torch.Tensor, offsets: np.ndarray, grid_shape) -> Index:
    """Flat node index of every (particle, stencil node) pair.

    base: (N, d) integer base nodes; offsets: (S, d) static.
    Returns (flat (N, S) int64, in_bounds (N, S) bool)."""
    off = constant(offsets, torch.int64, base.device)
    strides = np.concatenate([np.cumprod(np.asarray(grid_shape[1:], np.int64)[::-1])[::-1], [1]])
    flat, in_bounds = None, None
    for k, g in enumerate(grid_shape):
        idx = base[:, None, k].to(torch.int64) + off[None, :, k]
        ok = (idx >= 0) & (idx < g)
        term = idx.clamp(0, g - 1) * int(strides[k])
        flat = term if flat is None else flat + term
        in_bounds = ok if in_bounds is None else in_bounds & ok
    return flat, in_bounds


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
    flat, in_bounds = index if index is not None else flat_node_index(base, offsets, grid_shape)
    values = torch.where(in_bounds[..., None], values, 0.0)
    out = torch.zeros((int(np.prod(grid_shape)), c), dtype=values.dtype, device=values.device)
    out.index_add_(0, flat.reshape(-1), values.reshape(-1, c))
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
    flat, in_bounds = index if index is not None else flat_node_index(base, offsets, grid_shape)
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
