"""2D P2G / G2P transfers over row-bucketed particles, as CUDA kernels.

Counterpart of `mpm_flip98a_tpu/ops/pallas/transfer2d.py`.  The TPU
kernels turn the column scatter/gather into dense one-hot matrix products
for the MXU; on the GPU each particle simply touches its 3x3 nodes:

- `p2g_fused` (csrc/p2g_fused.cu) replaces the Pallas `p2g_fused`
  (transfer2d.py:412, pallas_call :433): fluid stress computed per slot,
  then the quadratic B-spline scatter of [m v0, m v1, m v0 + f0, m v1 + f1,
  m] to the 5 candidate target rows of each bucket row.
- `g2p` (csrc/g2p.cu) replaces the Pallas `g2p` (transfer2d.py:843,
  pallas_call :893) in its `update=False`, 4-channel form: vpic, the
  gathered pre-force velocity and C = D^-1 sum w v (x_node - x_p)^T.

Each kernel has a plain PyTorch version with the same contract beside it
(`p2g_fused_plain`, `g2p_plain`).  A wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or raises.
`LAUNCHES` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.

Layouts are the JAX package's, so the two compare at this boundary:
  P2G in  : sdata (R, 11, K) = [gx0, gx1, v0, v1, C00, C01, C10, C11,
            J, mass, vol0], counts (R,) int32
  P2G out : (R, 5, 5, G), target row t of bucket i is grid row i + t - 1
  G2P in  : pdata2 (R, 3, K) = [gx0, gx1, mask], counts, grid4 (R, 4, G)
            = [v_new0, v_new1, v_old0, v_old1] (unpadded)
  G2P out : (R, 8, K) = [vpic0, vpic1, vold0, vold1, C00, C01, C10, C11]

Semantics kept from the TPU kernels: a slot contributes only when its
base row is within +-1 of its bucket row; taps on columns outside [0, G)
are dropped; P2G and G2P read the same precomputed gx.  The tent kernel,
the extended (F-bar / mixing) channels, G2P's update mode and the
prepadded grid are not on the ported path (ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from mpm_flip98a_tpu_torch import _build

NT = 5             # candidate target rows: bucket_row - 1 .. bucket_row + 3
P2G_CH_FUSED = 5   # [m v0, m v1, m v0 + f0, m v1 + f1, m]
G2P_CH = 4         # [v_new0, v_new1, v_old0, v_old1]
G2P_OUT = 8        # [vpic0, vpic1, vold0, vold1, C00, C01, C10, C11]
EOS_CODES = {"linear": 0, "tait": 1}

# Kernel launches per wrapper (the plain versions do not count).
LAUNCHES = {"p2g_fused": 0, "g2p": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _axis_weights(fx):
    """Quadratic B-spline taps (mls-mpm88-explained.cpp:60-64)."""
    return (
        0.5 * (1.5 - fx) ** 2,
        0.75 - (fx - 1.0) ** 2,
        0.5 * (fx - 0.5) ** 2,
    )


def _col_weights(d):
    """Column weight as a function of the signed distance d = col - gx1:
    0.5 (1.5-|d|)+^2 - 1.5 (0.5-|d|)+^2, the same piecewise values as
    `_axis_weights` (the formula the TPU kernels use)."""
    a = d.abs()
    t1 = (1.5 - a).clamp(min=0.0)
    t2 = (0.5 - a).clamp(min=0.0)
    return 0.5 * t1 * t1 - 1.5 * t2 * t2


def _row_ids(r: int, device) -> torch.Tensor:
    return torch.arange(r, device=device, dtype=torch.float32)[:, None]


def _live(counts: torch.Tensor, k: int) -> torch.Tensor:
    """(R, K) bool: slot index below the row's packed count."""
    return torch.arange(k, device=counts.device)[None, :] < counts[:, None]


def _check(name, t, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(*tensors) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no transfer kernel for device type {kind!r}")
    return kind


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# P2G
# ---------------------------------------------------------------------------


def _fluid_affine(sdata, apic, eos, kb, mu, gamma, fa):
    """Per-slot fluid stress and affine matrices, as transfer2d.py:376-401.

    Returns (mv0, mv1, mass, P or None, Q) on (R, K) planes."""
    gx0, gx1, v0, v1, c00, c01, c10, c11, jj, mass, vol0 = sdata.unbind(1)
    if eos == "linear":
        pressure = -kb * (jj - 1.0)
    else:
        j_safe = jj.clamp(min=1e-3)
        pressure = (kb / gamma) * ((1.0 / j_safe) ** gamma - 1.0)
    div = c00 + c11
    vj = vol0 * jj
    t00 = vj * (-pressure + 2.0 * mu * (c00 - 0.5 * div))
    t11 = vj * (-pressure + 2.0 * mu * (c11 - 0.5 * div))
    t01 = vj * (2.0 * mu * 0.5 * (c01 + c10))
    if apic:
        p_aff = (mass * c00, mass * c01, mass * c10, mass * c11)
        q_aff = (
            p_aff[0] + fa * t00, p_aff[1] + fa * t01,
            p_aff[2] + fa * t01, p_aff[3] + fa * t11,
        )
    else:
        p_aff = None
        q_aff = (fa * t00, fa * t01, fa * t01, fa * t11)
    return mass * v0, mass * v1, mass, p_aff, q_aff


def p2g_fused_plain(
    sdata: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    dx: float,
    apic: bool,
    eos: str,
    kb: float,
    mu: float,
    gamma: float,
    fa: float,
) -> torch.Tensor:
    """Plain PyTorch version of `p2g_fused`: one `index_add_` per stencil
    tap into a flat (R * 5 * 5 * G) view.  Sequential and deterministic on
    the CPU; on a card `index_add_` sums with atomics in no fixed order."""
    r, _, k = sdata.shape
    dev = sdata.device
    gx0, gx1 = sdata[:, 0], sdata[:, 1]
    mv0, mv1, mass, p_aff, q_aff = _fluid_affine(sdata, apic, eos, kb, mu, gamma, fa)

    base0 = torch.floor(gx0 - 0.5)
    rel = base0 - _row_ids(r, dev)
    live = _live(counts, k) & (rel >= -1.0) & (rel <= 1.0)
    w0 = _axis_weights(gx0 - base0)
    base1 = torch.floor(gx1 - 0.5)
    rows = torch.arange(r, device=dev)[:, None]
    chan = torch.arange(P2G_CH_FUSED, device=dev)[:, None]

    out = torch.zeros(r * NT * P2G_CH_FUSED * g, dtype=sdata.dtype, device=dev)
    for j in range(3):
        t = torch.where(live, rel, 0.0).long() + (j + 1)   # target row 0..4
        rdp = (base0 + float(j) - gx0) * dx
        if apic:
            row0 = mv0 + p_aff[0] * rdp
            row1 = mv1 + p_aff[2] * rdp
        row2 = mv0 + q_aff[0] * rdp
        row3 = mv1 + q_aff[2] * rdp
        for jc in range(3):
            c = base1 + float(jc)
            ok = live & (c >= 0.0) & (c < g)
            d = c - gx1
            cd = d * dx
            w = w0[j] * _col_weights(d)
            if apic:
                ch0 = w * (row0 + p_aff[1] * cd)
                ch1 = w * (row1 + p_aff[3] * cd)
            else:
                ch0 = w * mv0
                ch1 = w * mv1
            vals = torch.stack([
                ch0, ch1,
                w * (row2 + q_aff[1] * cd),
                w * (row3 + q_aff[3] * cd),
                w * mass,
            ])  # (5, R, K)
            col = torch.where(ok, c, 0.0).long()
            base = ((rows * NT + t) * P2G_CH_FUSED) * g + col     # (R, K)
            idx = base[None] + chan[:, :, None] * g                # (5, R, K)
            out.index_add_(0, idx[:, ok].reshape(-1), vals[:, ok].reshape(-1))
    return out.view(r, NT, P2G_CH_FUSED, g)


def p2g_fused(
    sdata: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    dx: float,
    apic: bool,
    eos: str,
    kb: float,
    mu: float,
    gamma: float,
    fa: float,
) -> torch.Tensor:
    """Fused-stress P2G for the single-fluid config.

    sdata (R, 11, K) f32, counts (R,) int32 -> (R, 5, 5, G) f32.  Slots at
    or past counts[i] are skipped (buckets are packed, actives first)."""
    r, f, k = sdata.shape
    _check("sdata", sdata, (r, 11, k), torch.float32)
    _check("counts", counts, (r,), torch.int32)
    if eos not in EOS_CODES:
        raise ValueError(f"unknown eos {eos!r}")
    if _route(sdata, counts) == "cpu":
        return p2g_fused_plain(sdata, counts, g, dx, apic, eos, kb, mu, gamma, fa)
    lib = _build.load().lib
    out = torch.empty((r, NT, P2G_CH_FUSED, g), dtype=torch.float32, device=sdata.device)
    rc = lib.mpm_p2g_fused(
        _ptr(sdata), _ptr(counts), _ptr(out), r, k, g, dx, int(apic),
        EOS_CODES[eos], kb, kb / gamma, gamma, 2.0 * mu, mu, fa, _stream(sdata),
    )
    LAUNCHES["p2g_fused"] += 1
    _raise_on(rc, "p2g_fused")
    return out


def fold_rows(expanded: torch.Tensor) -> torch.Tensor:
    """(R, 5, ch, G) -> (R, ch, G): grid[row, ch] = sum_t expanded[row+1-t, t].

    Plain torch (the JAX package leaves it to XLA too): five shifted adds
    in the same order as the reference, so the result is bit-identical."""
    r, nt, ch, g = expanded.shape
    buf = torch.zeros((r + nt - 1, ch, g), dtype=expanded.dtype, device=expanded.device)
    for t in range(nt):
        buf[t : t + r] += expanded[:, t]
    return buf[1 : r + 1]


# ---------------------------------------------------------------------------
# G2P
# ---------------------------------------------------------------------------


def g2p_plain(
    pdata2: torch.Tensor,
    counts: torch.Tensor,
    grid4: torch.Tensor,
    dx: float,
    dinv: float,
) -> torch.Tensor:
    """Plain PyTorch version of `g2p`: per stencil tap, one clamped gather
    of the 4 grid channels, summed in the kernel's order (rows, then
    columns)."""
    r, _, k = pdata2.shape
    g = grid4.shape[2]
    dev = pdata2.device
    gx0, gx1, mask = pdata2.unbind(1)
    base0 = torch.floor(gx0 - 0.5)
    rel = base0 - _row_ids(r, dev)
    valid = _live(counts, k) & (mask > 0) & (rel >= -1.0) & (rel <= 1.0)
    w0 = _axis_weights(gx0 - base0)
    base1 = torch.floor(gx1 - 0.5)
    flat = grid4.reshape(-1)
    zero = torch.zeros_like(gx0)
    vp0, vp1, vo0, vo1, b00, b01, b10, b11 = (zero,) * 8
    for j in range(3):
        row = base0 + float(j)
        rdp = (row - gx0) * dx
        rin = valid & (row >= 0.0) & (row < r)
        for jc in range(3):
            c = base1 + float(jc)
            ok = rin & (c >= 0.0) & (c < g)
            d = c - gx1
            w = torch.where(ok, w0[j] * _col_weights(d), 0.0)
            at = (torch.where(ok, row, 0.0).long() * G2P_CH) * g + torch.where(ok, c, 0.0).long()
            vn0, vn1, vo0_, vo1_ = (flat[at + e * g] for e in range(G2P_CH))
            vp0 = vp0 + w * vn0
            vp1 = vp1 + w * vn1
            vo0 = vo0 + w * vo0_
            vo1 = vo1 + w * vo1_
            wr, wd = w * rdp, w * d
            b00 = b00 + wr * vn0
            b01 = b01 + wd * vn0
            b10 = b10 + wr * vn1
            b11 = b11 + wd * vn1
    dinv_dx = dinv * dx
    return torch.stack(
        [vp0, vp1, vo0, vo1, dinv * b00, dinv_dx * b01, dinv * b10, dinv_dx * b11],
        dim=1,
    )


def g2p(
    pdata2: torch.Tensor,
    counts: torch.Tensor,
    grid4: torch.Tensor,
    dx: float,
    dinv: float,
) -> torch.Tensor:
    """pdata2 (R, 3, K), counts (R,) int32, grid4 (R, 4, G) -> (R, 8, K).

    Dead slots (past the count, mask 0, or outside the +-1-row margin)
    get zeros.  Grid rows outside [0, R) read as zero, like the TPU
    kernel's zero-padded grid."""
    r, _, k = pdata2.shape
    g = grid4.shape[2]
    _check("pdata2", pdata2, (r, 3, k), torch.float32)
    _check("counts", counts, (r,), torch.int32)
    _check("grid4", grid4, (r, G2P_CH, g), torch.float32)
    if _route(pdata2, counts, grid4) == "cpu":
        return g2p_plain(pdata2, counts, grid4, dx, dinv)
    lib = _build.load().lib
    out = torch.empty((r, G2P_OUT, k), dtype=torch.float32, device=pdata2.device)
    rc = lib.mpm_g2p(
        _ptr(pdata2), _ptr(counts), _ptr(grid4), _ptr(out), r, k, g,
        dx, dinv, dinv * dx, _stream(pdata2),
    )
    LAUNCHES["g2p"] += 1
    _raise_on(rc, "g2p")
    return out
