"""Row-bucketed particle layout (counterpart of `mpm_flip98a_tpu/ops/binning.py`).

Particles are bucketed by their stencil base row (grid axis 0), one
fixed-capacity bucket of K slots per grid row, so the transfer kernels
(ops/cuda/transfer2d.py) can give one grid row's particles to one block.
In 3D the "row" is a pencil, one (axis-0, axis-1) grid line
(models/fast3d.py).  The layout is the fast path's persistent state;
`bucket_by_row` runs again only when some particle approaches the
kernels' +-1-row margin.

Held bit-exact to the JAX version: a stable argsort, ranks within a row
from one cumulative-max scan, an int32 permutation, and every field moved
as its 4-byte bit pattern in one stacked gather.  Slots past a row's
capacity are counted in `overflow` and discarded: only the in-capacity
positions are written, so nothing lands on a shared sentinel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def bucket_by_row(
    row: torch.Tensor,      # (S,) int32 target row per slot (garbage where inactive)
    active: torch.Tensor,   # (S,) bool
    fields: Tuple[torch.Tensor, ...],  # each (S,), 4-byte dtype
    num_rows: int,
    capacity: int,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Sort slots into (num_rows, capacity) buckets.

    Returns (bucketed fields each (R, K), mask (R, K) bool, overflow count
    as an int32 scalar tensor).  Stable within a row.  Slots beyond a row's
    capacity are dropped and counted in `overflow`."""
    s = row.shape[0]
    dev = row.device
    big = num_rows
    key = torch.where(active, row.clamp(0, num_rows - 1), big).to(torch.int32)
    order = torch.argsort(key, stable=True).to(torch.int32)
    key_sorted = key[order]

    # Rank within equal-key runs via one cumulative-max scan.
    i = torch.arange(s, dtype=torch.int32, device=dev)
    is_start = torch.ones(s, dtype=torch.bool, device=dev)
    is_start[1:] = key_sorted[1:] != key_sorted[:-1]
    seg_start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    rank = i - seg_start

    live = key_sorted < big
    ok = live & (rank < capacity)
    overflow = (live & (rank >= capacity)).sum().to(torch.int32)
    nslots = num_rows * capacity

    # Invert the (sorted position -> slot) assignment into slot -> source.
    # Only in-capacity positions are written; unfilled slots keep index s,
    # which gathers the zero row appended below (zero fill, mask False).
    src_of_slot = torch.full((nslots,), s, dtype=torch.int32, device=dev)
    slot = (key_sorted * capacity + rank)[ok].long()
    src_of_slot[slot] = order[ok]

    for f in fields:
        if f.element_size() != 4:
            raise ValueError(f"bucket fields must be 4-byte, got {f.dtype}")
    stk = torch.zeros((len(fields) + 1, s + 1), dtype=torch.int32, device=dev)
    for k, f in enumerate(fields):
        stk[k, :s] = f.view(torch.int32)
    stk[-1, :s] = active.to(torch.int32)
    moved = stk.index_select(1, src_of_slot.long())  # (n_fields + 1, nslots)

    bucketed = tuple(
        moved[k].view(f.dtype).reshape(num_rows, capacity)
        for k, f in enumerate(fields)
    )
    mask = (moved[-1] > 0).reshape(num_rows, capacity)
    return bucketed, mask, overflow
