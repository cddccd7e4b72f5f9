"""Closed-form small-matrix algebra (counterpart of `mpm_flip98a_tpu/ops/mathx.py`).

Every function works on tensors of shape (..., d, d) with d = 2 or 3, in
float32, float64 or bfloat16, and keeps the dtype.  Products and
determinants are written out as sums over the d <= 3 contraction index, so
no float32 path goes through a GEMM (and TF32) on the card; the 2D polar
decomposition and SVD are the closed forms of the reference
(taichi.h:8375-8419).  Nothing
here reads a value on the host, so a caller can queue these ops on the card
without a synchronisation.

Two pieces are not closed forms in the JAX module either.  The 3D polar
decomposition is its scaled Newton iteration on R, with the batched LU
inverse (`torch.linalg.inv_ex`, which skips the host-side error check).
The 3D SVD diagonalises the polar factor S; JAX calls LAPACK's `eigh`
there, and the port runs a fixed count of cyclic Jacobi sweeps instead, so
that no cuSOLVER call (and no host synchronisation) is made on the card.
Singular values agree with JAX's; singular vectors agree up to the sign of
each column, which `U diag(sig) V^T` does not see.

In bfloat16 the products (`mm`, `mv`, `dot_sum`) round as the JAX module's
`einsum(..., precision="highest")` does on the CPU: float32 products
summed in float32 in the contraction's order, rounded to bfloat16 once;
`seq_sum` (and `trace`) sums as `jnp.sum` does, in float32 in order,
rounded once; every other operation rounds once, as torch's bfloat16 ops
and XLA's do.
The 3D polar decomposition (and so the 3D SVD) raises NotImplementedError
in bfloat16, as JAX's `jnp.linalg.inv` does there.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from mpm_flip98a_tpu_torch.config import scalar

JACOBI_SWEEPS = 8


def _widened(fn):
    """fn on bfloat16 operands in float32, its result rounded to bfloat16
    once (the einsum's rounding); float32 and float64 as they are."""
    @functools.wraps(fn)
    def wrapper(a, b):
        if a.dtype != torch.bfloat16:
            return fn(a, b)
        return fn(a.float(), b.float()).to(torch.bfloat16)
    return wrapper


@_widened
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix product (..., d, k) x (..., k, e), summed in
    order over k."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


@_widened
def mv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., d, k) x (..., k)."""
    out = a[..., :, 0] * b[..., 0:1]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k] * b[..., k : k + 1]
    return out


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.sum(x, dim); in bfloat16 the float32 sum in order over `dim`,
    rounded once (as `jnp.sum` sums on the CPU), so the card and the CPU
    give the same bits."""
    if x.dtype != torch.bfloat16:
        return torch.sum(x, dim=dim)
    x = x.float()
    out = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        out = out + x.select(dim, k)
    return out.to(torch.bfloat16)


def dot_sum(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """sum(a * b, dim) of broadcast operands: an einsum's contraction over
    `dim` (the JAX module's "nsa,nsb->nab" and "ns,nsa->na").  In float32
    and float64 `torch.sum` of the products; in bfloat16 the float32
    products summed in order over `dim` in float32, rounded once."""
    if a.dtype != torch.bfloat16:
        return torch.sum(a * b, dim=dim)
    a, b = torch.broadcast_tensors(a.float(), b.float())
    out = a.select(dim, 0) * b.select(dim, 0)
    for k in range(1, a.shape[dim]):
        out = out + a.select(dim, k) * b.select(dim, k)
    return out.to(torch.bfloat16)


def det2x2(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 2, 2) (reference: taichi.h:7850)."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) (reference: taichi.h:7855)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def det(m: torch.Tensor) -> torch.Tensor:
    return det2x2(m) if m.shape[-1] == 2 else det3x3(m)


def transpose(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _rot2(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[[c, -s], [s, c]] from (...,) tensors."""
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def polar_decomp_2d(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form 2D polar decomposition m = R S: R from the trace/skew
    pair (m00 + m11, m10 - m01), S = R^T m (reference: taichi.h:8375-8385)."""
    x = m[..., 0, 0] + m[..., 1, 1]
    y = m[..., 1, 0] - m[..., 0, 1]
    scale = 1.0 / torch.sqrt(x * x + y * y)
    r = _rot2(x * scale, y * scale)
    return r, mm(transpose(r), m)


def svd_2d(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form 2x2 SVD m = U diag(sig) V^T: the polar decomposition,
    then one Jacobi rotation of the symmetric factor, singular values
    ordered sig0 >= sig1 (Jiang et al., Algorithm 4; reference:
    taichi.h:8389-8419).  Returns U, V (..., 2, 2) rotations, sig (..., 2)."""
    u_p, s_m = polar_decomp_2d(m)
    s00, s01, s11 = s_m[..., 0, 0], s_m[..., 0, 1], s_m[..., 1, 1]

    small = s01.abs() < scalar(1e-6, m.dtype)
    tao = 0.5 * (s00 - s11)
    w = torch.sqrt(tao * tao + s01 * s01)
    denom = torch.where(tao > 0, tao + w, tao - w)
    denom = torch.where(small, torch.ones_like(denom), denom)
    t = s01 / denom
    c = torch.where(small, torch.ones_like(t), 1.0 / torch.sqrt(t * t + 1.0))
    s = torch.where(small, torch.zeros_like(t), -t * c)

    sig0 = torch.where(small, s00, c * c * s00 - 2.0 * c * s * s01 + s * s * s11)
    sig1 = torch.where(small, s11, s * s * s00 + 2.0 * c * s * s01 + c * c * s11)

    # Order the singular values: on a swap, rotate V by 90 degrees.
    swap = sig0 < sig1
    sig = torch.stack([torch.where(swap, sig1, sig0), torch.where(swap, sig0, sig1)], dim=-1)
    v_rows = torch.stack([
        torch.stack([torch.where(swap, -s, c), torch.where(swap, -c, -s)], dim=-1),
        torch.stack([torch.where(swap, c, s), torch.where(swap, -s, c)], dim=-1),
    ], dim=-2)
    v = transpose(v_rows)
    return mm(u_p, v), sig, v


def polar_decomp_3d(m: torch.Tensor, iters: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D polar decomposition by the scaled Newton iteration
    R <- (gamma R + R^-T / gamma) / 2 with Frobenius scaling, a fixed
    `iters` times; S = R^T m, symmetrised against round-off.  bfloat16
    raises NotImplementedError, as JAX's `jnp.linalg.inv` does."""
    if m.dtype == torch.bfloat16:
        raise NotImplementedError("polar_decomp_3d: the batched 3 x 3 inverse has no bfloat16 "
                                  "form (JAX's jnp.linalg.inv raises on bfloat16 too)")
    r = m
    tiny = torch.finfo(m.dtype).tiny
    for _ in range(iters):
        r_inv_t = transpose(torch.linalg.inv_ex(r).inverse)
        a = torch.sqrt((r_inv_t * r_inv_t).sum(dim=(-2, -1)))
        b = torch.sqrt((r * r).sum(dim=(-2, -1)))
        gamma = torch.sqrt(a / b.clamp(min=tiny))[..., None, None]
        r = 0.5 * (gamma * r + r_inv_t / gamma)
    s = mm(transpose(r), m)
    return r, 0.5 * (s + transpose(s))


def _jacobi_rotation(a, v, p: int, q: int) -> None:
    """One Jacobi rotation zeroing a[p][q] of the symmetric 3 x 3 `a`, in
    place; `v` accumulates the eigenvectors as columns.  Both are 3-lists of
    3-lists of (...,) tensors.  A rotation J changes only rows and columns
    p and q, so J^T a J and v J are formed on those entries alone, each sum
    in the order of the full product (rows of J^T a first, then its
    columns), so no 3 x 3 temporaries are made."""
    app, aqq, apq = a[p][p], a[q][q], a[p][q]
    zero = apq == 0
    tau = (aqq - app) / (2.0 * torch.where(zero, torch.ones_like(apq), apq))
    sign = torch.where(tau >= 0, torch.ones_like(tau), -torch.ones_like(tau))
    t = sign / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(zero, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    ms = -s
    for k in range(3):                          # rows p, q of J^T a
        ap, aq = a[p][k], a[q][k]
        a[p][k], a[q][k] = c * ap + ms * aq, s * ap + c * aq
    for m in (a, v):                            # columns p, q of (J^T a) J and v J
        for i in range(3):
            mp, mq = m[i][p], m[i][q]
            m[i][p], m[i][q] = mp * c + mq * ms, mp * s + mq * c


def sym_eig_3d(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (descending) and eigenvectors (columns) of the symmetric
    (..., 3, 3) s by cyclic Jacobi sweeps; quadratic convergence makes
    JACOBI_SWEEPS ample in float64.  The sweeps run in float64 whatever
    s's dtype: in float32 their 24 rotations would add up to a few ulps
    more error than LAPACK's eigh has."""
    s64 = s.to(torch.float64)
    a = [[s64[..., i, j] for j in range(3)] for i in range(3)]
    one, nil = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else nil for j in range(3)] for i in range(3)]
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            _jacobi_rotation(a, v, p, q)
    eigval = torch.stack([a[i][i] for i in range(3)], dim=-1)
    vm = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    eigval, order = torch.sort(eigval, dim=-1, descending=True, stable=True)
    vm = torch.gather(vm, -1, order[..., None, :].expand(vm.shape))
    return eigval.to(s.dtype), vm.to(s.dtype)


def svd_3d(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3x3 SVD m = U diag(sig) V^T with sig descending: the polar
    decomposition m = R S and the eigendecomposition S = V diag(sig) V^T,
    U = R V."""
    r, s = polar_decomp_3d(m)
    eigval, v = sym_eig_3d(s)
    return mm(r, v), eigval, v


def polar_decomp(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return polar_decomp_2d(m) if m.shape[-1] == 2 else polar_decomp_3d(m)


def svd(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return svd_2d(m) if m.shape[-1] == 2 else svd_3d(m)


def inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2)."""
    adj = torch.stack([
        torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
        torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / det2x2(m)[..., None, None]


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d_, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d_ * i, a * i - c * g, c * d_ - a * f], dim=-1),
        torch.stack([d_ * h - e * g, b * g - a * h, a * e - b * d_], dim=-1),
    ], dim=-2)
    return co / det3x3(m)[..., None, None]


def inv(m: torch.Tensor) -> torch.Tensor:
    return inv2x2(m) if m.shape[-1] == 2 else inv3x3(m)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for small d x d systems (..., d, d) x (..., d): the
    matrix-valued nodal mass of the penalty-EBC grid update
    (reference: fields.py:28)."""
    return mv(inv(a), b)


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., d) x (..., d) -> (..., d, d) (reference: taichi.h:7643)."""
    return a[..., :, None] * b[..., None, :]


def trace(m: torch.Tensor) -> torch.Tensor:
    return seq_sum(torch.diagonal(m, dim1=-2, dim2=-1), -1)


def eye_like(m: torch.Tensor) -> torch.Tensor:
    d = m.shape[-1]
    return torch.eye(d, dtype=m.dtype, device=m.device).expand(m.shape)
