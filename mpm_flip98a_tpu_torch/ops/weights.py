"""Interpolation kernels and stencil utilities (counterpart of `mpm_flip98a_tpu/ops/weights.py`).

The quadratic B-spline with support 1.5 dx (reference: config.py:41-43;
cpp_validation/mls-mpm88-explained.cpp:59-64) and the linear "tent" behind
``switch_kernelFunction`` (config.py:21), evaluated per axis and combined by
tensor product over the static 3^dim stencil.  Stencil offsets are static
numpy arrays; their tensors are made once per (offsets, dtype, device) and
kept, so a substep on the card copies nothing from the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import KernelKind

_CONSTANTS = {}


def constant(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """`a` as a tensor of `dtype` on `device`, made once and kept."""
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, str(torch.device(device)))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(a).to(dtype=dtype, device=device)
    return _CONSTANTS[key]


def base_and_fx(x: torch.Tensor, inv_dx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base grid node and fractional offset of each particle:
    base = floor(x/dx - 0.5), fx = x/dx - base, fx in [0.5, 1.5)
    (reference: mls-mpm88-explained.cpp:55-57).

    x: (N, d).  Returns (base (N, d) int64, fx (N, d))."""
    xs = x * inv_dx
    base = torch.floor(xs - 0.5).to(torch.int64)
    return base, xs - base.to(x.dtype)


def quadratic_bspline(fx: torch.Tensor) -> torch.Tensor:
    """w = [0.5 (1.5 - fx)^2, 0.75 - (fx - 1)^2, 0.5 (fx - 0.5)^2]
    (reference: mls-mpm88-explained.cpp:60-64).  (N, d) -> (N, 3, d)."""
    w0 = 0.5 * torch.square(1.5 - fx)
    w1 = 0.75 - torch.square(fx - 1.0)
    w2 = 0.5 * torch.square(fx - 0.5)
    return torch.stack([w0, w1, w2], dim=-2)


def tent(fx: torch.Tensor) -> torch.Tensor:
    """Linear hat weights on the same 3-node stencil:
    w_i = max(0, 1 - |fx - i|).  (N, d) -> (N, 3, d)."""
    ws = [torch.clamp(1.0 - torch.abs(fx - i), min=0.0) for i in (0.0, 1.0, 2.0)]
    return torch.stack(ws, dim=-2)


def kernel_weights(fx: torch.Tensor, kind: KernelKind) -> torch.Tensor:
    if kind == KernelKind.BSPLINE:
        return quadratic_bspline(fx)
    return tent(fx)


def stencil_offsets(dim: int) -> np.ndarray:
    """Static (3^dim, dim) int array of stencil node offsets in {0, 1, 2}."""
    grids = np.meshgrid(*([np.arange(3)] * dim), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


def stencil_weights(w_axes: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """Tensor-product stencil weights: w_axes (N, 3, d), offsets (S, d)
    -> (N, S), entry prod_k w_axes[n, offsets[s, k], k]
    (reference: mls-mpm88-explained.cpp:98)."""
    off = constant(offsets, torch.int64, w_axes.device)
    prod = w_axes[:, off[:, 0], 0]
    for k in range(1, offsets.shape[1]):
        prod = prod * w_axes[:, off[:, k], k]
    return prod


def stencil_dpos(fx: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """Node-minus-particle offsets in grid units: (N, d), (S, d) -> (N, S, d)
    (reference: mls-mpm88-explained.cpp:94,149)."""
    return constant(offsets, fx.dtype, fx.device)[None, :, :] - fx[:, None, :]
