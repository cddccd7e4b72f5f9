"""3D P2G / G2P transfers over pencil-bucketed particles, as CUDA kernels.

Counterpart of `mpm_flip98a_tpu/ops/pallas/transfer3d.py`.  Particles sit
in one bucket of K slots per (axis-0, axis-1) grid line, a "pencil"; a
slot contributes only when its base row on both bucketed axes is within
+-1 of its pencil's, so its 3x3 stencil rows land in the 5x5 candidate
target pencils around it.  The TPU kernels turn the z (axis-2) scatter and
gather into one-hot matrix products and, for P2G, carry target rows
between consecutive grid steps in a rolling VMEM scratch.  Blocks on a GPU
run in no order, so here each slot touches its 27 nodes directly:

- `p2g3d_grid` (csrc/p2g3d_grid.cu) replaces the Pallas `p2g3d_grid`
  (transfer3d.py:622, pallas_call :709) in its stress mode: per-slot fluid
  stress, the scatter of [m v (pure, 3), m v + f (forced, 3), m] with
  float atomics into a raw padded buffer, then one thread per node for
  the grid update (mass floor, gravity, slip / sticky walls or the
  diagonal penalty solve) -> the finished G2P-ready padded grid.
- `g2p3d` (csrc/g2p3d.cu) replaces the Pallas `g2p3d` (transfer3d.py:930,
  pallas_call :995) in its update mode on a grid prepadded on both axes:
  the 27-node gather, C = D^-1 sum w v (x_node - x_p)^T, the FLIP blend,
  advection of x and the J update.

Each kernel has a plain PyTorch version with the same contract beside it
(`p2g3d_grid_plain`, `g2p3d_plain`).  A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises.  `LAUNCHES` counts kernel launches per wrapper.

Layouts are the JAX package's, so the two compare at this boundary:
  P2G in  : 18 (R0, R1, K) f32 planes [gx0, gx1, gx2, v0, v1, v2,
            C00..C22, J, mass, vol0], counts (R0 * R1,) int32
  P2G out : (R0 + 4, R1 + 4, 6, G2) = [v_new (3), v_old (3)]; plane/row j
            is target row j - 1 on both bucketed axes
  G2P in  : gx0..2, mask, v0..2, J, x0..2 as (R0, R1, K), counts, that
            padded grid
  G2P out : (R0, R1, 16, K) = [x (3), v (3), C00..C22, J]
A plane may be a channel slice of a larger tensor (the previous G2P
output): the kernels take each plane's pencil stride, so the state needs
no copy between substeps.

Semantics kept from the TPU kernels: axis-0 target rows outside [0, R0)
come out zero; the axis-1 pad rows keep what is scattered there (the TPU
kernel crops axis 0 only, and G2P reads those rows back); z taps outside
[0, G2) are dropped; P2G and G2P read the same precomputed gx.  Slots past
a pencil's count are skipped by P2G and get the dead fill in G2P: x passed
through, v = C = 0, J = 1.  The tent kernel, the extended channels, the
prepped-pdata and raw (sharded) modes, in-kernel colliders, G2P's gather
mode and one-axis prepadding are not on the ported path (ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from mpm_flip98a_tpu_torch import _build
from mpm_flip98a_tpu_torch.ops.cuda.transfer2d import (
    EOS_CODES, _axis_weights, _check, _col_weights, _ptr, _raise_on, _route, _stream,
)

NT = 5          # candidate target rows per bucketed axis: bucket row - 1 .. + 3
P2G_CH = 7      # raw sums: m v pure (3), m v forced (3), m
G2P_CH = 6      # finished grid: v_new (3), v_old (3)
G2P_UPD = 16    # update-mode output: x (3), v (3), C (9), J
N_P2G_IN = 18
N_G2P_IN = 11
WALL_CODES = {"slip": 0, "sticky": 1, "penalty": 2}

# Kernel launches per wrapper (the plain versions do not count).
LAUNCHES = {"p2g3d_grid": 0, "g2p3d": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_plane(name: str, t: torch.Tensor, shape) -> int:
    """A float32 (R0, R1, K) plane whose pencils (i0 * R1 + i1) sit at a
    fixed stride with unit stride along K; returns that pencil stride."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    s0, s1, s2 = t.stride()
    if s2 != 1 or s0 != shape[1] * s1:
        raise ValueError(f"{name}: needs unit stride along K and evenly strided pencils")
    return s1


def _plane_args(planes, strides):
    """Host arrays of plane pointers and pencil strides for the C entry."""
    n = len(planes)
    return (
        (ctypes.c_void_p * n)(*(p.data_ptr() for p in planes)),
        (ctypes.c_longlong * n)(*strides),
    )


def _live_slots(counts: torch.Tensor, r0: int, r1: int, k: int):
    """(R0, R1, K) bool of the slots below their pencil's packed count, and
    each such slot's pencil rows (i0, i1) as float32."""
    dev = counts.device
    live = torch.arange(k, device=dev) < counts.view(r0, r1, 1)
    i0 = torch.arange(r0, device=dev, dtype=torch.float32)[:, None, None]
    i1 = torch.arange(r1, device=dev, dtype=torch.float32)[None, :, None]
    return live, i0.expand(r0, r1, k)[live], i1.expand(r0, r1, k)[live]


def _margin(gx0, gx1, i0, i1):
    """Base rows, their offsets from the slot's pencil rows (i0, i1), and
    the +-1 drift-margin test on both bucketed axes."""
    base0 = torch.floor(gx0 - 0.5)
    base1 = torch.floor(gx1 - 0.5)
    rel0, rel1 = base0 - i0, base1 - i1
    ok = (rel0 >= -1.0) & (rel0 <= 1.0) & (rel1 >= -1.0) & (rel1 <= 1.0)
    return base0, base1, rel0, rel1, ok


# ---------------------------------------------------------------------------
# P2G + grid update
# ---------------------------------------------------------------------------


def _fluid_affine(fields, apic, stress, kb, mu, gamma, fa):
    """Per-slot m v, P = m C (APIC) and Q = P + fa tau, as _p2g3d_chunk
    (transfer3d.py:208-236).  Returns (mv, P or None, Q, mass)."""
    v3 = fields[3:6]
    cm = fields[6:15]
    jj, mass, vol0 = fields[15], fields[16], fields[17]
    mv = tuple(mass * v for v in v3)
    if stress == "linear":
        pressure = -kb * (jj - 1.0)
    else:
        j_safe = jj.clamp(min=1e-3)
        pressure = (kb / gamma) * ((1.0 / j_safe) ** gamma - 1.0)
    divc = cm[0] + cm[4] + cm[8]
    vj = vol0 * jj
    p_aff = tuple(mass * c for c in cm) if apic else None
    q_aff = []
    for a in range(3):
        for c in range(3):
            dev = 0.5 * (cm[3 * a + c] + cm[3 * c + a])
            if a == c:
                dev = dev - divc / 3.0
                tau = vj * (-pressure + (2.0 * mu) * dev)
            else:
                tau = vj * ((2.0 * mu) * dev)
            q_aff.append(p_aff[3 * a + c] + fa * tau if apic else fa * tau)
    return mv, p_aff, q_aff, mass


def p2g3d_raw_plain(fields, counts, g2, dx, apic, stress, kb, mu, gamma, fa):
    """The scatter half of `p2g3d_grid_plain`: raw sums (R0 + 4, R1 + 4, 7,
    G2) = [m v pure (3), m v forced (3), m], plane/row j = target j - 1.
    One `index_add_` per stencil tap over the live in-margin slots."""
    r0, r1, k = fields[0].shape
    dev = fields[0].device
    live, i0, i1 = _live_slots(counts, r0, r1, k)
    base0, base1, rel0, rel1, ok = _margin(fields[0][live], fields[1][live], i0, i1)
    fields = [f[live][ok] for f in fields]
    gx0, gx1, gx2 = fields[:3]
    base0, base1, base2 = base0[ok], base1[ok], torch.floor(gx2 - 0.5)
    mv, p_aff, q_aff, mass = _fluid_affine(fields, apic, stress, kb, mu, gamma, fa)
    w0 = _axis_weights(gx0 - base0)
    w1 = _axis_weights(gx1 - base1)
    # Padded plane of tap (j0, j1): bucket row + rel + j + 1 on each axis.
    p0 = (i0 + rel0)[ok].long() + 1
    p1 = (i1 + rel1)[ok].long() + 1
    pl1 = r1 + NT - 1
    out = torch.zeros((r0 + NT - 1) * pl1 * P2G_CH * g2, dtype=gx0.dtype, device=dev)
    chan = torch.arange(P2G_CH, device=dev)[:, None] * g2
    for j0 in range(3):
        rdp0 = (base0 + float(j0) - gx0) * dx
        for j1 in range(3):
            rdp1 = (base1 + float(j1) - gx1) * dx
            w01 = w0[j0] * w1[j1]
            row = ((p0 + j0) * pl1 + (p1 + j1)) * P2G_CH * g2
            # In-plane affine parts, shared by the three z taps.
            forced = [mv[a] + q_aff[3 * a] * rdp0 + q_aff[3 * a + 1] * rdp1 for a in range(3)]
            if apic:
                pure = [mv[a] + p_aff[3 * a] * rdp0 + p_aff[3 * a + 1] * rdp1 for a in range(3)]
            for j2 in range(3):
                c = base2 + float(j2)
                inz = (c >= 0.0) & (c < g2)
                d = c - gx2
                cd = d * dx
                w = w01 * _col_weights(d)
                if apic:
                    ch_pure = [w * (pure[a] + p_aff[3 * a + 2] * cd) for a in range(3)]
                else:
                    ch_pure = [w * mv[a] for a in range(3)]
                ch_forced = [w * (forced[a] + q_aff[3 * a + 2] * cd) for a in range(3)]
                vals = torch.stack([*ch_pure, *ch_forced, w * mass])   # (7, n)
                idx = (row + torch.where(inz, c, 0.0).long())[None, :] + chan
                out.index_add_(0, idx[:, inz].reshape(-1), vals[:, inz].reshape(-1))
    return out.view(r0 + NT - 1, pl1, P2G_CH, g2)


def grid_update3d_plain(raw, r0, dt, grav, floor, lo, hi, wall, beta):
    """The node half of `p2g3d_grid_plain`, as _emit_and_roll
    (transfer3d.py:491-547): raw (R0 + 4, R1 + 4, 7, G2) sums -> the
    finished (R0 + 4, R1 + 4, 6, G2) grid; axis-0 pad rows come out 0."""
    pr0, pl1, _, g2 = raw.shape
    dev = raw.device
    t0r = torch.arange(pr0, device=dev)[:, None, None] - 1      # target rows
    idx1 = torch.arange(pl1, device=dev)[None, :, None] - 1
    idx2 = torch.arange(g2, device=dev)[None, None, :]
    interior = (t0r >= 0) & (t0r < r0)
    m = raw[:, :, 6]
    has = (m > floor) & interior
    safe = torch.where(has, m, 1.0)
    v_old = [torch.where(has, raw[:, :, a] / safe, 0.0) for a in range(3)]
    a0l, a0h = (t0r <= lo) & interior, t0r >= hi
    a1l, a1h = idx1 <= lo, idx1 >= hi
    a2l, a2h = idx2 <= lo, idx2 >= hi
    dtg = [float(dt * grav[a]) for a in range(3)]
    if wall == "penalty":
        dtb = float(dt * beta)
        pens = [(a0l | a0h), (a1l | a1h), (a2l | a2h)]
        v = [
            torch.where(has, (raw[:, :, 3 + a] + dtg[a] * m) / (m + dtb * pens[a].float()), 0.0)
            for a in range(3)
        ]
    else:
        hasf = has.float()
        v = [torch.where(has, raw[:, :, 3 + a] / safe, 0.0) + dtg[a] * hasf for a in range(3)]
        if wall == "sticky":
            anyband = a0l | a0h | a1l | a1h | a2l | a2h
            v = [torch.where(anyband, 0.0, va) for va in v]
        else:   # slip: clamp the outgoing normal component per axis band
            for a, (low, high) in enumerate(((a0l, a0h), (a1l, a1h), (a2l, a2h))):
                v[a] = torch.where(low, v[a].clamp(min=0.0), v[a])
                v[a] = torch.where(high, v[a].clamp(max=0.0), v[a])
    return torch.stack(v + v_old, dim=2)


def p2g3d_grid_plain(
    fields, counts, g1, g2, dx, apic, stress, kb, mu, gamma, fa,
    *, dt, grav, floor, lo, hi, wall, beta=0.0,
):
    """Plain PyTorch version of `p2g3d_grid`: `index_add_` tap by tap into
    the raw padded sums, then the grid update on whole planes.  Sequential
    and deterministic on the CPU; on a card `index_add_` sums with atomics
    in no fixed order."""
    raw = p2g3d_raw_plain(fields, counts, g2, dx, apic, stress, kb, mu, gamma, fa)
    return grid_update3d_plain(raw, fields[0].shape[0], dt, grav, floor, lo, hi, wall, beta)


def p2g3d_grid(
    fields, counts, g1, g2, dx, apic, stress, kb, mu, gamma, fa,
    *, dt, grav, floor, lo, hi, wall, beta=0.0, raw=None,
):
    """Single-device fused P2G + grid update, stress mode (the arguments
    of the JAX `p2g3d_grid`): 18 (R0, R1, K) planes, counts (R0 * R1,)
    int32 -> the finished (R0 + 4, R1 + 4, 6, G2) grid.

    `raw`, a CUDA tensor (R0 + 4, R1 + 4, 7, G2) f32, is the kernel's
    scratch for the raw sums; pass one to read them after the call."""
    if len(fields) != N_P2G_IN:
        raise ValueError(f"fields: expected {N_P2G_IN} planes, got {len(fields)}")
    r0, r1, k = fields[0].shape
    if g1 != r1:
        raise ValueError(f"g1 ({g1}) must equal the pencil rows R1 ({r1})")
    strides = [_check_plane(f"fields[{i}]", f, (r0, r1, k)) for i, f in enumerate(fields)]
    _check("counts", counts, (r0 * r1,), torch.int32)
    if stress not in EOS_CODES:
        raise ValueError(f"unknown stress {stress!r}")
    if wall not in WALL_CODES:
        raise ValueError(f"unknown wall {wall!r}")
    kw = dict(dt=dt, grav=grav, floor=floor, lo=lo, hi=hi, wall=wall, beta=beta)
    if _route(counts, *fields) == "cpu":
        return p2g3d_grid_plain(fields, counts, g1, g2, dx, apic, stress, kb, mu, gamma, fa, **kw)
    lib = _build.load().lib
    dev = counts.device
    if raw is None:
        raw = torch.empty((r0 + NT - 1, r1 + NT - 1, P2G_CH, g2), dtype=torch.float32, device=dev)
    _check("raw", raw, (r0 + NT - 1, r1 + NT - 1, P2G_CH, g2), torch.float32)
    _route(counts, raw)
    out = torch.empty((r0 + NT - 1, r1 + NT - 1, G2P_CH, g2), dtype=torch.float32, device=dev)
    ptrs, pstr = _plane_args(fields, strides)
    rc = lib.mpm_p2g3d_grid(
        ptrs, pstr, _ptr(counts), _ptr(raw), _ptr(out), r0, r1, k, g2, dx,
        int(apic), EOS_CODES[stress], kb, kb / gamma, gamma, 2.0 * mu, fa,
        *(dt * g for g in grav), floor, lo, hi, WALL_CODES[wall], dt * beta,
        _stream(counts),
    )
    LAUNCHES["p2g3d_grid"] += 1
    _raise_on(rc, "p2g3d_grid")
    return out


# ---------------------------------------------------------------------------
# G2P (update mode)
# ---------------------------------------------------------------------------


def g2p3d_plain(gx0, gx1, gx2, mask, counts, grid, dx, dinv, state, alpha, dtv):
    """Plain PyTorch version of `g2p3d`: over the live slots, per stencil
    tap one gather of the 6 grid channels, then the particle update; the
    other slots get the dead fill."""
    r0, r1, k = gx0.shape
    g2 = grid.shape[3]
    pl1 = r1 + NT - 1
    live, i0, i1 = _live_slots(counts, r0, r1, k)
    # Slots past the count: x passed through, v = C = 0, J = 1.
    out = torch.cat([
        torch.stack(state[4:7], dim=2),
        torch.zeros((r0, r1, 12, k), dtype=gx0.dtype, device=gx0.device),
        torch.ones((r0, r1, 1, k), dtype=gx0.dtype, device=gx0.device),
    ], dim=2)
    gx0, gx1, gx2, mask = (a[live] for a in (gx0, gx1, gx2, mask))
    v_prev = [a[live] for a in state[0:3]]
    j_prev = state[3][live]
    x_prev = [a[live] for a in state[4:7]]
    base0, base1, rel0, rel1, ok = _margin(gx0, gx1, i0, i1)
    valid = mask * ok.float()
    w0 = [w * valid for w in _axis_weights(gx0 - base0)]
    w1 = _axis_weights(gx1 - base1)
    base2 = torch.floor(gx2 - 0.5)
    # Padded row of tap j on each axis: bucket row + rel + j + 1, in range
    # wherever the weight is not zero.
    p0 = (i0 + torch.where(ok, rel0, 0.0)).long() + 1
    p1 = (i1 + torch.where(ok, rel1, 0.0)).long() + 1
    flat = grid.reshape(-1)
    zero = torch.zeros_like(gx0)
    vpic, vold = [zero] * 3, [zero] * 3
    csum = [zero] * 9
    for j0 in range(3):
        rdp0 = (base0 + float(j0) - gx0) * dx
        for j1 in range(3):
            rdp1 = (base1 + float(j1) - gx1) * dx
            w01 = w0[j0] * w1[j1]
            row = ((p0 + j0) * pl1 + (p1 + j1)) * G2P_CH * g2
            for j2 in range(3):
                c = base2 + float(j2)
                inz = (c >= 0.0) & (c < g2)
                d = c - gx2
                w = torch.where(inz, w01 * _col_weights(d), 0.0)
                at = row + torch.where(inz, c, 0.0).long()
                dxs = (rdp0, rdp1, d * dx)
                for a in range(3):
                    vn = flat[at + a * g2]
                    vpic[a] = vpic[a] + w * vn
                    vold[a] = vold[a] + w * flat[at + (3 + a) * g2]
                    wv = w * vn
                    for bb in range(3):
                        csum[3 * a + bb] = csum[3 * a + bb] + wv * dxs[bb]
    cmat = [dinv * cs for cs in csum]
    x_new = [x_prev[a] + dtv * vpic[a] * mask for a in range(3)]
    one_m_alpha = float(1.0 - alpha)
    v_new = [
        (alpha * (v_prev[a] + vpic[a] - vold[a]) + one_m_alpha * vpic[a]) * mask
        for a in range(3)
    ]
    div = cmat[0] + cmat[4] + cmat[8]
    j_new = torch.where(mask > 0, j_prev * (1.0 + dtv * div), 1.0)
    out.permute(0, 1, 3, 2)[live] = torch.stack(x_new + v_new + cmat + [j_new], dim=1)
    return out


def g2p3d(gx0, gx1, gx2, mask, counts, grid, dx, dinv, state, alpha, dtv):
    """Update-mode G2P on a grid prepadded on both axes (the arguments of
    the JAX `g2p3d(..., state=, prepadded0=True, prepadded1=True)`):
    gx0..2 and mask (R0, R1, K), counts (R0 * R1,) int32, grid (R0 + 4,
    R1 + 4, 6, G2), state = (v0, v1, v2, J, x0, x1, x2) -> (R0, R1, 16, K)
    = [x (3), v (3), C00..C22, J]."""
    r0, r1, k = gx0.shape
    planes = (gx0, gx1, gx2, mask, *state)
    if len(planes) != N_G2P_IN:
        raise ValueError(f"state: expected 7 planes, got {len(state)}")
    strides = [_check_plane(f"plane[{i}]", p, (r0, r1, k)) for i, p in enumerate(planes)]
    _check("counts", counts, (r0 * r1,), torch.int32)
    g2 = grid.shape[-1]
    _check("grid", grid, (r0 + NT - 1, r1 + NT - 1, G2P_CH, g2), torch.float32)
    if _route(counts, grid, *planes) == "cpu":
        return g2p3d_plain(gx0, gx1, gx2, mask, counts, grid, dx, dinv, state, alpha, dtv)
    lib = _build.load().lib
    out = torch.empty((r0, r1, G2P_UPD, k), dtype=torch.float32, device=counts.device)
    ptrs, pstr = _plane_args(planes, strides)
    rc = lib.mpm_g2p3d(
        ptrs, pstr, _ptr(counts), _ptr(grid), _ptr(out), r0, r1, k, g2,
        dx, dinv, alpha, 1.0 - alpha, dtv, _stream(counts),
    )
    LAUNCHES["g2p3d"] += 1
    _raise_on(rc, "g2p3d")
    return out
