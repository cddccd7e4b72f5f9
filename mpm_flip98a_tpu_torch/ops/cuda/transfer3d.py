"""3D P2G / G2P transfers over pencil-bucketed particles, as CUDA kernels.

Counterpart of `mpm_flip98a_tpu/ops/pallas/transfer3d.py`.  Particles sit
in one bucket of K slots per (axis-0, axis-1) grid line, a "pencil"; a
slot contributes only when its base row on both bucketed axes is within
+-1 of its pencil's, so its 3x3 stencil rows land in the 5x5 candidate
target pencils around it.  The TPU kernels turn the z (axis-2) scatter and
gather into one-hot matrix products and, for P2G, carry target rows
between consecutive grid steps in a rolling VMEM scratch.  Blocks on a GPU
run in no order, so here a P2G block owns its output and pulls the taps
of its source pencils' slots, and G2P gathers each slot's 27 nodes:

- `p2g3d` (csrc/p2g3d.cu) replaces the Pallas `p2g3d` (transfer3d.py:349,
  pallas_call :408): the transfer of prepped fields [m v, P, Q, m (, V0 J,
  V0, V0 p, V0 div)], or in the stress mode of the 18 state planes with
  the fluid stress made per slot, into the expanded (R0, 5, G1, nch, G2)
  layout that `fold_rows0` folds; one block per (source axis-0 row,
  target axis-1 row) gathers its nodes' taps in a fixed order (no float
  atomics; reruns are bitwise equal); `plan_p2g3d` sizes its z bands and
  staging window.
  `halo1=True` keeps the axis-1 halo: (R0, 5, G1 + 4, nch, G2), plane row
  j = target row j - 1 (its blocks cover the G1 + 4 rows), which
  `fold_rows0_halo` folds into raw `p2g3d_grid`'s halo sums.
- `p2g3d_grid` (csrc/p2g3d_grid.cu) replaces the Pallas `p2g3d_grid`
  (transfer3d.py:622, pallas_call :709) in one launch: a block owns a tile
  of five target pencils on axis 0, gathers the taps of its source
  pencils' slots (the per-slot fluid stress in stress mode, or prepped
  fields with `ext` and `tent`) in a fixed order (no float atomics;
  reruns are bitwise equal), and finishes its nodes (mass floor,
  gravity, slip / sticky walls or the diagonal penalty solve, the rigid
  SDF colliders of `models/colliders` at kinematic time `tcol`, the nodal
  Jbar, p and div under `ext`) -> the finished G2P-ready padded grid; or,
  `raw=True` (the slab-sharded path's), each shard's raw halo sums, all
  shards in one launch.  `plan_p2g3d_grid` sizes its bands and chunks.
- `g2p3d` (csrc/g2p3d.cu) replaces the Pallas `g2p3d` (transfer3d.py:930,
  pallas_call :995): the 27-node gather and C = D^-1 sum w v (x_node -
  x_p)^T, then either the particle update (update mode: FLIP blend,
  advection, J) or the raw gathers (gather mode, 15 outputs, 18 with the
  extended grid; B-spline or tent taps).

Each kernel has a plain PyTorch version with the same contract beside it
(`p2g3d_plain`, `p2g3d_grid_plain`, `g2p3d_plain`).  A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises.  `LAUNCHES` counts kernel launches per wrapper.

Layouts are the JAX package's, so the two compare at this boundary:
  P2G in  : stress mode: 18 (R0, R1, K) f32 planes [gx0, gx1, gx2, v0, v1,
            v2, C00..C22, J, mass, vol0]; prepped: [gx (3), m v (3),
            P00..P22 (APIC only), Q00..Q22, m (, V0 J, V0, V0 p, V0 div)],
            16 to 29 planes; counts (R0 * R1,) int32
  P2G out : `p2g3d`: (R0, 5, G1, nch, G2), nch = 7 or 11 = [m v pure (3),
            m v forced (3), m (, ext 4)]; [i0, t0, row] is bucket row
            i0's share of target rows (i0 + t0 - 1, row).  `p2g3d_grid`:
            (R0 + 4, R1 + 4, 6 or 9, G2) = [v_new (3), v_old (3) (, Jbar,
            p, div)]; plane/row j is target row j - 1 on both axes
            `p2g3d_grid(raw=True)` on n slab shards of L0 = R0 / n rows
            (gx0 local to the shard): (n, L0 + 4, R1 + 4, 7 or 11, G2)
            raw sums, uncropped on both axes
  G2P in  : gx0..2 and mask (R0, R1, K), counts, a grid of 6 or 9
            channels: padded on both axes, on axis 0 only, or unpadded
            (then zero-padded here, as the JAX function pads in XLA), or
            one padded (L0 + 4, R1 + 4) window per slab shard, (n, L0 + 4,
            R1 + 4, gch, G2); update mode also v0..2, J, x0..2
  G2P out : update mode (R0, R1, 16, K) = [x (3), v (3), C00..C22, J];
            gather mode (R0, R1, 15 or 18, K) = [vpic (3), v_old (3),
            C00..C22 (, Jbar, p, div)]
A plane may be a channel slice of a larger tensor (the previous G2P
output): the kernels take each plane's pencil stride, so the state needs
no copy between substeps.

Semantics kept from the TPU kernels: `p2g3d_grid`'s axis-0 target rows
outside [0, R0) come out zero while its axis-1 pad rows keep what is
scattered there (the TPU kernel crops axis 0 only, and G2P reads those
rows back); `p2g3d` drops taps whose axis-1 row is outside [0, G1); z
taps outside [0, G2) are dropped; P2G and G2P read the same precomputed
gx.  Slots past a pencil's count are skipped by P2G; G2P gives them the
dead fill in update mode (x passed through, v = C = 0, J = 1) and zeros
in gather mode.  The colliders' projection leaves the axis-1 pad rows and
the rows outside [0, R0) as the walls left them (transfer3d.py:567-570).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mpm_flip98a_tpu_torch import _build
from mpm_flip98a_tpu_torch.config import scalar
from mpm_flip98a_tpu_torch.models import colliders as col
from mpm_flip98a_tpu_torch.ops.cuda.transfer2d import (
    EOS_CODES, SMEM_SM, WALL_CODES, GatherPlan, _check, _col_weights, _ptr, _raise_on, _route,
    _shard_rows, _stream, _taps, collider_arrays, plan_gather,
)

NT = 5            # candidate target rows per bucketed axis: bucket row - 1 .. + 3
P2G_CH = 7        # raw sums: m v pure (3), m v forced (3), m
P2G_CH_EXT = 11   # + V0 J, V0, V0 p, V0 div
G2P_CH = 6        # finished grid: v_new (3), v_old (3)
G2P_CH_EXT = 9    # + Jbar, p, div
G2P_OUT = 15      # gather-mode output: vpic (3), v_old (3), C (9)
G2P_OUT_EXT = 18  # + Jbar, p, div
G2P_UPD = 16      # update-mode output: x (3), v (3), C (9), J
N_P2G_IN = 18     # stress-mode input planes
N_PREPPED_MAX = 29
# p2g3d_grid's gather (csrc/p2g3d_grid.cu): a block owns a tile of NT
# target planes on axis 0 and GRID3D_ROWS on axis 1 (its kRows) over a band
# of at most GRID3D_MAX_BAND z columns, GRID3D_THREADS threads,
# GRID3D_BLOCKS_PER_SM blocks an SM (its kBlocksPerSM, the register cap of
# its __launch_bounds__); it keeps the tags of GRID3D_SEQ of its (NT + 4) x
# (GRID3D_ROWS + 4) source pencils' slots at once (kSeq) and stages `cap`
# records (one a slot and tile row) a chunk; GRID3D_COLS columns a round
# (kCols) and the kernel's static arrays (GRID3D_SMEM_STATIC, with room for
# rounding).
GRID3D_THREADS = 256
GRID3D_BLOCKS_PER_SM = 2
GRID3D_ROWS = 1
GRID3D_SEQ = 8192
GRID3D_MAX_BAND = 512
GRID3D_COLS = 64
GRID3D_SMEM_STATIC = 1_024
# p2g3d's gather (csrc/p2g3d.cu): P2G3D_WARPS warps a block (its kWarps),
# P2G3D_BLOCKS_PER_SM blocks an SM (its kBlocksPerSM), at most
# P2G3D_MAX_BAND z columns a block.
P2G3D_WARPS = 8
P2G3D_BLOCKS_PER_SM = 2
P2G3D_MAX_BAND = 512

# Kernel launches per wrapper (the plain versions do not count), and
# those of p2g3d's stress mode among LAUNCHES["p2g3d"].
LAUNCHES = {"p2g3d": 0, "p2g3d_grid": 0, "g2p3d": 0}
MODE_LAUNCHES = {"p2g3d_stress": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, MODE_LAUNCHES):
        for name in counts:
            counts[name] = 0


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
    """Host arrays of plane pointers and pencil strides for the C entry; a
    None plane (one the mode does not read) goes in as a null pointer."""
    n = len(planes)
    return (
        (ctypes.c_void_p * n)(*(None if p is None else p.data_ptr() for p in planes)),
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
# P2G
# ---------------------------------------------------------------------------


def _fluid_affine(fields, apic, stress, kb, mu, gamma, fa):
    """Per-slot m v, P = m C (APIC) and Q = P + fa tau, as _p2g3d_chunk
    (transfer3d.py:208-236).  Returns (mv, P or None, Q, [mass])."""
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
    return mv, p_aff, q_aff, [mass]


def n_prepped(apic: bool, ext: bool) -> int:
    """Planes of the prepped P2G input: gx (3), m v (3), P (9, APIC only),
    Q (9), m and, with `ext`, V0 J, V0, V0 p, V0 div."""
    return 3 + 3 + (9 if apic else 0) + 9 + 1 + (4 if ext else 0)


def _split_prepped(fields, apic: bool, ext: bool):
    """(mv, P or None, Q, [m, *ext]) of the prepped planes
    (transfer3d.py:239-248)."""
    if len(fields) != n_prepped(apic, ext):
        raise ValueError(
            f"fields: expected {n_prepped(apic, ext)} prepped planes "
            f"(apic={apic}, ext={ext}), got {len(fields)}"
        )
    qb = 15 if apic else 6
    p_aff = fields[6:15] if apic else None
    return fields[3:6], p_aff, fields[qb : qb + 9], list(fields[qb + 9 :])


def _slot_values(fields, apic, stress, kb, mu, gamma, fa, ext):
    if stress is None:
        return _split_prepped(fields, apic, ext)
    if ext or len(fields) != N_P2G_IN:
        raise ValueError(
            f"stress mode takes {N_P2G_IN} planes and no ext, got {len(fields)} (ext={ext})"
        )
    return _fluid_affine(fields, apic, stress, kb, mu, gamma, fa)


def _scatter3d_plain(fields, counts, values, g2, dx, tent, g1=None, halo1=False):
    """Shared plain P2G body: channels [m v pure (3), m v forced (3),
    *plain] of the live in-margin slots, one `index_add_` per stencil tap.

    With `g1` the target is the expanded (R0, 5, G1, nch, G2) layout of
    `p2g3d` (taps on axis-1 rows outside [0, G1) dropped; with `halo1`
    (R0, 5, G1 + 4, nch, G2), plane row j = target row j - 1, none
    dropped); without, the raw padded (R0 + 4, R1 + 4, nch, G2) sums of
    `p2g3d_grid` (plane/row j = target j - 1; the axis-1 pad rows keep
    their taps).  `values` maps the slot-selected planes to (mv, P or
    None, Q, plain)."""
    r0, r1, k = fields[0].shape
    dev = fields[0].device
    live, i0, i1 = _live_slots(counts, r0, r1, k)
    base0, base1, rel0, rel1, ok = _margin(fields[0][live], fields[1][live], i0, i1)
    fields = [f[live][ok] for f in fields]
    gx0, gx1, gx2 = fields[:3]
    base0, base1, base2 = base0[ok], base1[ok], torch.floor(gx2 - 0.5)
    mv, p_aff, q_aff, plain = values(fields)
    apic = p_aff is not None
    nch = 6 + len(plain)
    w0 = _taps(gx0 - base0, tent)
    w1 = _taps(gx1 - base1, tent)
    i0, rel0, rel1 = i0[ok].long(), rel0[ok].long(), rel1[ok].long()
    row1 = i1[ok].long() + rel1          # target axis-1 row of tap j1 = 0
    if g1 is None:
        pl1 = r1 + NT - 1
        out = torch.zeros((r0 + NT - 1, pl1, nch, g2), dtype=gx0.dtype, device=dev)
    else:
        g1out = g1 + NT - 1 if halo1 else g1
        out = torch.zeros((r0, NT, g1out, nch, g2), dtype=gx0.dtype, device=dev)
    flat = out.view(-1)
    chan = torch.arange(nch, device=dev)[:, None] * g2
    for j0 in range(3):
        rdp0 = (base0 + float(j0) - gx0) * dx
        for j1 in range(3):
            rdp1 = (base1 + float(j1) - gx1) * dx
            w01 = w0[j0] * w1[j1]
            if g1 is None:
                in1 = None
                row = ((i0 + rel0 + (j0 + 1)) * pl1 + (row1 + (j1 + 1))) * nch * g2
            elif halo1:
                in1 = None
                row = ((i0 * NT + rel0 + (j0 + 1)) * g1out + (row1 + (j1 + 1))) * nch * g2
            else:
                in1 = (row1 + j1 >= 0) & (row1 + j1 < g1)
                row = ((i0 * NT + rel0 + (j0 + 1)) * g1 + (row1 + j1).clamp(0, g1 - 1)) * nch * g2
            # In-plane affine parts, shared by the three z taps.
            forced = [mv[a] + q_aff[3 * a] * rdp0 + q_aff[3 * a + 1] * rdp1 for a in range(3)]
            if apic:
                pure = [mv[a] + p_aff[3 * a] * rdp0 + p_aff[3 * a + 1] * rdp1 for a in range(3)]
            for j2 in range(3):
                c = base2 + float(j2)
                inz = (c >= 0.0) & (c < g2)
                if in1 is not None:
                    inz = inz & in1
                d = c - gx2
                cd = d * dx
                w = w01 * _col_weights(d, tent)
                if apic:
                    ch_pure = [w * (pure[a] + p_aff[3 * a + 2] * cd) for a in range(3)]
                else:
                    ch_pure = [w * mv[a] for a in range(3)]
                ch_forced = [w * (forced[a] + q_aff[3 * a + 2] * cd) for a in range(3)]
                vals = torch.stack([*ch_pure, *ch_forced, *(w * e for e in plain)])   # (nch, n)
                idx = (row + torch.where(inz, c, 0.0).long())[None, :] + chan
                flat.index_add_(0, idx[:, inz].reshape(-1), vals[:, inz].reshape(-1))
    return out


def p2g3d_plain(fields, counts, g1, g2, dx, apic=True, ext=False, tent=False, halo1=False,
                stress=None, kb=0.0, mu=0.0, gamma=7.0, fa=0.0):
    """Plain PyTorch version of `p2g3d`: `index_add_` tap by tap into the
    expanded (R0, 5, G1, nch, G2) layout, or (R0, 5, G1 + 4, nch, G2)
    with `halo1`; with `stress` the per-slot fluid stress first.
    Sequential and deterministic on the CPU; on a card `index_add_` sums
    with atomics in no fixed order."""
    values = lambda sel: _slot_values(sel, apic, stress, kb, mu, gamma, fa, ext)
    return _scatter3d_plain(fields, counts, values, g2, dx, tent, g1=g1, halo1=halo1)


def plan_p2g3d(nch: int, g2: int, k: int, apic: bool) -> GatherPlan:
    """`p2g3d`'s plan: a block per (i0, axis-1 row, z band); the slots of
    its five source pencils (5 K) may all be listed; a record is [t0, gx0 -
    base0, gx2 - base2, w1, pure (9 APIC, 3 PIC), forced (9), plain (nch -
    6)]."""
    return plan_gather(g2, 4 + (9 if apic else 3) + 9 + nch - 6, NT * k, P2G3D_MAX_BAND,
                       P2G3D_WARPS, P2G3D_BLOCKS_PER_SM)


def _check_fields(fields, n_in: int):
    if len(fields) != n_in:
        raise ValueError(f"fields: expected {n_in} planes, got {len(fields)}")
    r0, r1, k = fields[0].shape
    return r0, r1, k, [_check_plane(f"fields[{i}]", f, (r0, r1, k)) for i, f in enumerate(fields)]


def _prepped_plane_args(fields, strides, apic: bool, ext: bool):
    """The prepped planes in the kernels' fixed 29-entry order [gx (3),
    m v (3), P (9), Q (9), m, ext (4)], null where the mode has none."""
    planes, pstr = [None] * N_PREPPED_MAX, [0] * N_PREPPED_MAX
    at = [*range(6), *(range(6, 15) if apic else ()), *range(15, 25),
          *(range(25, 29) if ext else ())]
    for slot, f, s in zip(at, fields, strides):
        planes[slot], pstr[slot] = f, s
    return _plane_args(planes, pstr)


def p2g3d(
    fields, counts, g1, g2, dx, apic=True, ext=False, stress=None, tent=False, halo1=False,
    kb=0.0, mu=0.0, gamma=7.0, fa=0.0,
):
    """Expanded P2G (the arguments of the JAX `p2g3d`): counts (R0 * R1,)
    int32 and either `n_prepped(apic, ext)` prepped (R0, R1, K) planes
    with `stress=None`, or, with `stress` "linear" or "tait" (B-spline, no
    ext), the 18 state planes [gx (3), v (3), C00..C22, J, mass, vol0]
    and the fluid's kb, mu, gamma and fa (the stress of
    transfer3d.py:208-236 made per slot in the kernel) -> (R0, 5, G1, nch,
    G2), nch = 11 with `ext` else 7, for `fold_rows0`; `halo1`
    (transfer3d.py:366-372) -> (R0, 5, G1 + 4, nch, G2), the axis-1 plane
    uncropped (row j = target row j - 1), for `fold_rows0_halo`.
    On the card every node sums its slots in a fixed order: two calls on
    the same inputs give bitwise equal outputs.  A block lists its five
    source pencils' slots in shared memory, so K is at most some 7,000
    there (`plan_p2g3d` raises past it; the scenes use 512-1,280)."""
    if stress is None:
        n_in = n_prepped(apic, ext)
    elif stress not in EOS_CODES:
        raise ValueError(f"unknown stress {stress!r}")
    elif ext or tent:
        raise ValueError("p2g3d's stress mode has no ext or tent form: prep the fields "
                         "(stress=None)")
    else:
        n_in = N_P2G_IN
    r0, r1, k, strides = _check_fields(fields, n_in)
    _check("counts", counts, (r0 * r1,), torch.int32)
    if _route(counts, *fields) == "cpu":
        return p2g3d_plain(fields, counts, g1, g2, dx, apic, ext, tent, halo1, stress, kb, mu,
                           gamma, fa)
    nch = P2G_CH_EXT if ext else P2G_CH
    plan = plan_p2g3d(nch, g2, k, apic)
    lib = _build.load().lib
    g1out = g1 + NT - 1 if halo1 else g1
    out = torch.empty((r0, NT, g1out, nch, g2), dtype=torch.float32, device=counts.device)
    if stress is None:
        ptrs, pstr = _prepped_plane_args(fields, strides, apic, ext)
    else:
        ptrs, pstr = _plane_args([*fields, *(None,) * (N_PREPPED_MAX - N_P2G_IN)],
                                 [*strides, *(0,) * (N_PREPPED_MAX - N_P2G_IN)])
    code = 0 if stress is None else 1 + EOS_CODES[stress]
    rc = lib.mpm_p2g3d(
        ptrs, pstr, _ptr(counts), _ptr(out), r0, r1, k, g1, g2, nch, int(apic), int(tent),
        int(halo1), dx, code, kb, kb / gamma, gamma, 2.0 * mu, fa, plan.band, plan.cap,
        _stream(counts),
    )
    LAUNCHES["p2g3d"] += 1
    if stress is not None:
        MODE_LAUNCHES["p2g3d_stress"] += 1
    _raise_on(rc, "p2g3d")
    return out


def fold_rows0(expanded: torch.Tensor) -> torch.Tensor:
    """(R0, 5, G1, ch, G2) -> (G0, G1, ch, G2): grid row g = sum_t
    expanded[g + 1 - t, t].  Plain torch (the JAX package leaves it to XLA
    too): five shifted adds in the reference's order (transfer3d.py:
    736-749), so the result is bit-identical."""
    r, nt, g1, ch, g2 = expanded.shape
    buf = torch.zeros((r + nt - 1, g1, ch, g2), dtype=expanded.dtype, device=expanded.device)
    for t in range(nt):
        buf[t : t + r] += expanded[:, t]
    return buf[1 : r + 1]


def fold_rows0_halo(expanded: torch.Tensor) -> torch.Tensor:
    """(L, 5, G1, ch, G2) -> (L + 4, G1, ch, G2): `fold_rows0` uncropped,
    row j = axis-0 target row j - 1 (transfer3d.py:752-763).  Of a
    `halo1` expanded output it gives raw `p2g3d_grid`'s (L + 4, G1 + 4)
    halo sums, up to the order of the sums."""
    r, nt, g1, ch, g2 = expanded.shape
    buf = torch.zeros((r + nt - 1, g1, ch, g2), dtype=expanded.dtype, device=expanded.device)
    for t in range(nt):
        buf[t : t + r] += expanded[:, t]
    return buf


def p2g3d_raw_plain(
    fields, counts, g2, dx, apic=True, stress=None, kb=0.0, mu=0.0, gamma=7.0, fa=0.0,
    tent=False, ext=False, shards=None,
):
    """The scatter half of `p2g3d_grid_plain`: raw sums (R0 + 4, R1 + 4,
    7 or 11, G2) = [m v pure (3), m v forced (3), m (, V0 J, V0, V0 p,
    V0 div)], plane/row j = target j - 1.  With `shards`, the raw mode's
    (shards, L0 + 4, R1 + 4, nch, G2): each shard's L0 = R0 / shards rows
    scattered on their own."""
    values = lambda sel: _slot_values(sel, apic, stress, kb, mu, gamma, fa, ext)
    if shards is None:
        return _scatter3d_plain(fields, counts, values, g2, dx, tent)
    l0 = _shard_rows(fields[0].shape[0], shards)
    r1 = fields[0].shape[1]
    return torch.stack([
        _scatter3d_plain([f[s * l0 : (s + 1) * l0] for f in fields],
                         counts[s * l0 * r1 : (s + 1) * l0 * r1], values, g2, dx, tent)
        for s in range(shards)
    ])


def grid_update3d_plain(raw, r0, dt, grav, floor, lo, hi, wall, beta, ext=False,
                        colliders=(), tcol=None, dx=0.0):
    """The node half of `p2g3d_grid_plain`, as _emit_and_roll
    (transfer3d.py:491-585): raw (R0 + 4, R1 + 4, 7 or 11, G2) sums -> the
    finished (R0 + 4, R1 + 4, 6 or 9, G2) grid; axis-0 pad rows come out
    0.  After the walls, `colliders.project` at node x = (idx - lo) dx and
    time `tcol` on the interior rows of both axes.  With `ext` the nodal
    Jbar = sum V0 J / sum V0 (1 on interior rows where no volume landed),
    p and div (0 there)."""
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
    if colliders:
        dxc = scalar(dx, raw.dtype)
        coords = [(i.to(raw.dtype) - lo) * dxc for i in (t0r, idx1, idx2)]
        vp = col.project(v, coords, colliders, tcol)
        keep = interior & (idx1 >= 0) & (idx1 < pl1 - (NT - 1))
        v = [torch.where(keep, vp[a], v[a]) for a in range(3)]
    extra = []
    if ext:
        v0sum = raw[:, :, 8]
        has_v = (v0sum > 0) & interior
        safe_v = torch.where(has_v, v0sum, 1.0)
        extra = [
            torch.where(has_v, raw[:, :, 7] / safe_v, interior.to(raw.dtype)),
            torch.where(has_v, raw[:, :, 9] / safe_v, 0.0),
            torch.where(has_v, raw[:, :, 10] / safe_v, 0.0),
        ]
    return torch.stack(v + v_old + extra, dim=2)


def p2g3d_grid_plain(
    fields, counts, g1, g2, dx, apic=True, stress=None, kb=0.0, mu=0.0, gamma=7.0, fa=0.0,
    tent=False, ext=False, *, dt, grav, floor, lo, hi, wall, beta=0.0, colliders=(),
    tcol=None,
):
    """Plain PyTorch version of `p2g3d_grid`: `index_add_` tap by tap into
    the raw padded sums, then the grid update on whole planes.  Sequential
    and deterministic on the CPU; on a card `index_add_` sums with atomics
    in no fixed order."""
    raw = p2g3d_raw_plain(fields, counts, g2, dx, apic, stress, kb, mu, gamma, fa, tent, ext)
    return grid_update3d_plain(raw, fields[0].shape[0], dt, grav, floor, lo, hi, wall, beta, ext,
                               colliders, tcol, dx)


def grid3d_rec_floats(nch: int, apic: bool) -> int:
    """Floats of `p2g3d_grid`'s staged record (csrc/taps.cuh, rec3d::Rec):
    [t0, gx0 - base0, gx2 - base2, w1, pure (9 APIC, 3 PIC), forced (9),
    plain (nch - 6)], padded to float4s."""
    return 4 * -(-(4 + (9 if apic else 3) + 9 + nch - 6) // 4)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """`p2g3d_grid`'s launch plan: blocks (x: shard, axis-0 tile of NT
    target planes, axis-1 tile of GRID3D_ROWS, the latter fastest; y: z
    band) over each of `shards` windows of (L0 + 4, R1 + 4) planes; chunks
    of at most `cap` records of `rec` bytes, which a block stages at once;
    `smem` dynamic shared bytes a block: the records, the round's sums
    (GRID3D_ROWS x NT x nch x GRID3D_COLS floats), the sort's counters
    (GRID3D_ROWS (GRID3D_COLS + 2) keys x warps) and key starts, a first
    entry for each step of 32 of GRID3D_SEQ slots and their 2-byte tags."""

    band: int
    cap: int
    rec: int
    smem: int
    shards: int
    l0: int
    r1: int
    g2: int

    @property
    def nt0(self) -> int:
        return -(-(self.l0 + NT - 1) // NT)

    @property
    def nt1(self) -> int:
        return -(-(self.r1 + NT - 1) // GRID3D_ROWS)

    @property
    def blocks(self) -> int:
        return self.shards * self.nt0 * self.nt1

    @property
    def bands(self) -> int:
        return -(-self.g2 // self.band)

    def tile(self, block: int):
        """(shard, window planes [q0lo, q0hi) on axis 0, [q1lo, q1hi) on
        axis 1) of blockIdx.x = block, as the kernel decodes it."""
        shard, rem = divmod(block, self.nt0 * self.nt1)
        q0lo, q1lo = (rem // self.nt1) * NT, (rem % self.nt1) * GRID3D_ROWS
        return (shard, q0lo, min(q0lo + NT, self.l0 + NT - 1),
                q1lo, min(q1lo + GRID3D_ROWS, self.r1 + NT - 1))

    def sources(self, block: int):
        """The shard-local source rows [lo, hi] on each axis that a block
        walks: plane q takes rows q - 4 .. q inside the shard."""
        _, q0lo, q0hi, q1lo, q1hi = self.tile(block)
        return ((max(q0lo - (NT - 1), 0), min(q0hi - 1, self.l0 - 1)),
                (max(q1lo - (NT - 1), 0), min(q1hi - 1, self.r1 - 1)))

    def columns(self, by: int):
        """[c0, c1) of blockIdx.y = by: c0 = by band, c1 = min(c0 + band, G2)."""
        c0 = by * self.band
        return c0, min(c0 + self.band, self.g2)


def plan_p2g3d_grid(nch: int, g2: int, r0: int, r1: int, shards: int = 1,
                    apic: bool = True) -> GridPlan:
    """Equal z bands of at most GRID3D_MAX_BAND columns, and the most
    records a chunk that let GRID3D_BLOCKS_PER_SM blocks share an SM.  A
    crowded pencil takes more chunks, not more memory."""
    l0 = _shard_rows(r0, shards)
    if g2 <= 0 or r1 <= 0:
        raise ValueError(f"bad grid: r1 {r1}, g2 {g2}")
    band = -(-g2 // -(-g2 // GRID3D_MAX_BAND))
    rec = 4 * grid3d_rec_floats(nch, apic)
    warps = GRID3D_THREADS // 32
    keys = GRID3D_ROWS * (GRID3D_COLS + 2)
    fixed = (4 * (GRID3D_ROWS * NT * nch * GRID3D_COLS + keys * warps + keys + 1
                  + GRID3D_SEQ // 32 + 1) + 2 * GRID3D_SEQ)
    budget = SMEM_SM // GRID3D_BLOCKS_PER_SM - 1_024 - GRID3D_SMEM_STATIC
    cap = (budget - fixed) // rec
    return GridPlan(band, cap, rec, fixed + cap * rec, shards, l0, r1, g2)


def p2g3d_grid(
    fields, counts, g1, g2, dx, apic=True, stress=None, kb=0.0, mu=0.0, gamma=7.0, fa=0.0,
    tent=False, ext=False, raw=False,
    *, dt=None, grav=None, floor=None, lo=None, hi=None, wall=None, beta=0.0,
    colliders=(), tcol=None, raw_out=None, shards=1,
):
    """Single-device fused P2G + grid update (the arguments of the JAX
    `p2g3d_grid`): counts (R0 * R1,) int32 and either 18 (R0, R1, K)
    state planes with `stress` "linear" or "tait" (B-spline, no ext), or
    `n_prepped(apic, ext)` prepped planes with `stress=None` -> the
    finished (R0 + 4, R1 + 4, 6 or 9, G2) grid.

    `raw=True` (the slab-sharded path's, transfer3d.py:484-489) stops after
    the scatter: R0 = shards x L0 rows with gx0 local to each shard ->
    (shards, L0 + 4, R1 + 4, 7 or 11, G2) raw sums, uncropped on both axes;
    it takes no node arguments, which the grid update needs: dt, grav,
    floor, lo, hi and wall.  `colliders` (3D `models/colliders.Collider`s,
    at most 8) project v_new after the walls, the moving ones at simulation
    time `tcol` (None: every collider where its center says); the raw mode
    takes none (the sharded grid update applies them).

    One launch, planned by `plan_p2g3d_grid` (tiles of 5 x 1 target
    pencils, z bands, chunks of records that fit the shared memory); no
    raw buffer is allocated.  Every node
    sums its slots in an order fixed by the inputs: two calls on the same
    inputs give bitwise equal outputs, and the raw mode at one shard equals
    the non-raw mode's `raw_out` bit for bit.
    `raw_out`, a CUDA tensor (R0 + 4, R1 + 4, 7 or 11, G2) f32 that only a
    checking caller passes, receives the raw sums of the non-raw mode as
    well, uncropped."""
    if raw and colliders:
        raise ValueError("p2g3d_grid's raw mode takes no colliders: the grid update applies them")
    if raw:     # the scatter alone: the node pass never reads these
        dt, grav, floor, lo, hi, wall = 0.0, (0.0, 0.0, 0.0), 0.0, 0, 0, "slip"
    missing = [n for n, v in zip(("dt", "grav", "floor", "lo", "hi", "wall"),
                                 (dt, grav, floor, lo, hi, wall)) if v is None]
    if missing:
        raise TypeError(f"p2g3d_grid: the grid update needs {', '.join(missing)}")
    if stress is None:
        n_in = n_prepped(apic, ext)
    elif stress not in EOS_CODES:
        raise ValueError(f"unknown stress {stress!r}")
    elif ext or tent:
        raise ValueError("stress mode has no ext or tent form: prep the fields (stress=None)")
    else:
        n_in = N_P2G_IN
    r0, r1, k, strides = _check_fields(fields, n_in)
    if g1 != r1:
        raise ValueError(f"g1 ({g1}) must equal the pencil rows R1 ({r1})")
    _check("counts", counts, (r0 * r1,), torch.int32)
    if wall not in WALL_CODES:
        raise ValueError(f"unknown wall {wall!r}")
    if not raw and shards != 1:
        raise ValueError("shards split the raw mode only")
    l0 = _shard_rows(r0, shards)
    colliders = tuple(colliders)
    col_f, col_i, ncol = collider_arrays(colliders)
    sums = dict(apic=apic, stress=stress, kb=kb, mu=mu, gamma=gamma, fa=fa, tent=tent, ext=ext)
    kw = dict(dt=dt, grav=grav, floor=floor, lo=lo, hi=hi, wall=wall, beta=beta,
              colliders=colliders, tcol=tcol)
    if _route(counts, *fields) == "cpu":
        if raw:
            return p2g3d_raw_plain(fields, counts, g2, dx, shards=shards, **sums)
        return p2g3d_grid_plain(fields, counts, g1, g2, dx, **sums, **kw)
    lib = _build.load().lib
    dev = counts.device
    nch = P2G_CH_EXT if ext else P2G_CH
    plan = plan_p2g3d_grid(nch, g2, r0, r1, shards, apic)
    if raw:
        raw_out = torch.empty((shards, l0 + NT - 1, r1 + NT - 1, nch, g2),
                              dtype=torch.float32, device=dev)
        out = raw_out
    else:
        if raw_out is not None:
            _check("raw_out", raw_out, (r0 + NT - 1, r1 + NT - 1, nch, g2), torch.float32)
            _route(counts, raw_out)
        out = torch.empty(
            (r0 + NT - 1, r1 + NT - 1, G2P_CH_EXT if ext else G2P_CH, g2),
            dtype=torch.float32, device=dev,
        )
    kin = tcol is not None and col.any_moving(colliders)
    node = (*(dt * g for g in grav), floor, lo, hi, WALL_CODES[wall], dt * beta,
            col_f, col_i, ncol, int(kin), float(np.float32(tcol)) if kin else 0.0, int(raw),
            plan.band, plan.cap, _stream(counts))
    raw_ptr = None if raw_out is None else _ptr(raw_out)
    if stress is None:
        ptrs, pstr = _prepped_plane_args(fields, strides, apic, ext)
        rc = lib.mpm_p2g3d_grid_pdata(
            ptrs, pstr, _ptr(counts), raw_ptr, _ptr(out), r0, l0, r1, k, g2, nch,
            int(apic), int(tent), dx, *node,
        )
    else:
        ptrs, pstr = _plane_args(fields, strides)
        rc = lib.mpm_p2g3d_grid(
            ptrs, pstr, _ptr(counts), raw_ptr, _ptr(out), r0, l0, r1, k, g2, dx,
            int(apic), EOS_CODES[stress], kb, kb / gamma, gamma, 2.0 * mu, fa, *node,
        )
    LAUNCHES["p2g3d_grid"] += 1
    _raise_on(rc, "p2g3d_grid")
    return out


# ---------------------------------------------------------------------------
# G2P
# ---------------------------------------------------------------------------


def _padded_grid(grid: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """The grid padded to (R0 + 4, R1 + 4, gch, G2), plane/row j = target
    row j - 1, from a grid padded on both axes (returned as it is), on
    axis 0 only, or on neither (transfer3d.py:960-975 pads the same way).
    A slab-sharded grid (n, L0 + 4, R1 + 4, gch, G2), n L0 = R0, is
    returned as it is."""
    if grid.dim() == 5 and grid.shape[3] in (G2P_CH, G2P_CH_EXT):
        n = grid.shape[0]
        l0 = _shard_rows(r0, n)
        if tuple(grid.shape[1:3]) != (l0 + NT - 1, r1 + NT - 1):
            raise ValueError(f"grid: shard windows {tuple(grid.shape[1:3])}, expected "
                             f"({l0 + NT - 1}, {r1 + NT - 1})")
        return grid
    if grid.dim() != 4 or grid.shape[2] not in (G2P_CH, G2P_CH_EXT):
        raise ValueError(f"grid: expected (rows0, rows1, 6 or 9, G2), got {tuple(grid.shape)}")
    p0, p1 = r0 + NT - 1, r1 + NT - 1
    rows = tuple(grid.shape[:2])
    if rows == (p0, p1):
        return grid
    if rows not in ((p0, r1), (r0, r1)):
        raise ValueError(
            f"grid: rows {rows} are neither ({r0}, {r1}) nor padded to {p0} on axis 0 "
            f"or to ({p0}, {p1}) on both"
        )
    padded = torch.zeros((p0, p1, *grid.shape[2:]), dtype=grid.dtype, device=grid.device)
    if rows[0] == p0:
        padded[:, 1 : r1 + 1] = grid
    else:
        padded[1 : r0 + 1, 1 : r1 + 1] = grid
    return padded


def g2p3d_plain(
    gx0, gx1, gx2, mask, counts, grid, dx, dinv, state=None, alpha=0.0, dtv=0.0, tent=False,
):
    """Plain PyTorch version of `g2p3d`: over the live slots, per stencil
    tap one gather of the grid channels, then the particle update (update
    mode, the other slots get the dead fill) or the raw gathers (gather
    mode, the other slots zeros)."""
    r0, r1, k = gx0.shape
    grid = _padded_grid(grid, r0, r1)
    gch, g2 = grid.shape[-2], grid.shape[-1]
    pl1 = r1 + NT - 1
    # Slab shards: axis-0 row i0 of shard s = i0 // L0 reads plane
    # s (L0 + 4) + (i0 mod L0) + rel + j + 1 of the stacked windows.
    l0 = r0 // grid.shape[0] if grid.dim() == 5 else r0
    live, i0, i1 = _live_slots(counts, r0, r1, k)
    win0 = torch.div(i0, l0, rounding_mode="floor") * (l0 + NT - 1)
    i0 = torch.remainder(i0, l0)
    if state is None:
        out = torch.zeros((r0, r1, G2P_OUT + gch - G2P_CH, k), dtype=gx0.dtype, device=gx0.device)
    else:
        # Slots past the count: x passed through, v = C = 0, J = 1.
        out = torch.cat([
            torch.stack(state[4:7], dim=2),
            torch.zeros((r0, r1, 12, k), dtype=gx0.dtype, device=gx0.device),
            torch.ones((r0, r1, 1, k), dtype=gx0.dtype, device=gx0.device),
        ], dim=2)
    gx0, gx1, gx2, mask = (a[live] for a in (gx0, gx1, gx2, mask))
    base0, base1, rel0, rel1, ok = _margin(gx0, gx1, i0, i1)
    valid = mask * ok.to(mask.dtype)
    w0 = [w * valid for w in _taps(gx0 - base0, tent)]
    w1 = _taps(gx1 - base1, tent)
    base2 = torch.floor(gx2 - 0.5)
    # Padded row of tap j on each axis: bucket row + rel + j + 1, in range
    # wherever the weight is not zero.
    p0 = (win0 + i0 + torch.where(ok, rel0, 0.0)).long() + 1
    p1 = (i1 + torch.where(ok, rel1, 0.0)).long() + 1
    flat = grid.reshape(-1)
    zero = torch.zeros_like(gx0)
    vpic, vold = [zero] * 3, [zero] * 3
    csum = [zero] * 9
    extra = [zero] * (gch - G2P_CH)
    for j0 in range(3):
        rdp0 = (base0 + float(j0) - gx0) * dx
        for j1 in range(3):
            rdp1 = (base1 + float(j1) - gx1) * dx
            w01 = w0[j0] * w1[j1]
            row = ((p0 + j0) * pl1 + (p1 + j1)) * gch * g2
            for j2 in range(3):
                c = base2 + float(j2)
                inz = (c >= 0.0) & (c < g2)
                d = c - gx2
                w = torch.where(inz, w01 * _col_weights(d, tent), 0.0)
                at = row + torch.where(inz, c, 0.0).long()
                dxs = (rdp0, rdp1, d * dx)
                for a in range(3):
                    vn = flat[at + a * g2]
                    vpic[a] = vpic[a] + w * vn
                    vold[a] = vold[a] + w * flat[at + (3 + a) * g2]
                    wv = w * vn
                    for bb in range(3):
                        csum[3 * a + bb] = csum[3 * a + bb] + wv * dxs[bb]
                extra = [acc + w * flat[at + (G2P_CH + e) * g2] for e, acc in enumerate(extra)]
    cmat = [dinv * cs for cs in csum]
    if state is None:
        out.permute(0, 1, 3, 2)[live] = torch.stack(vpic + vold + cmat + extra, dim=1)
        return out
    v_prev = [a[live] for a in state[0:3]]
    j_prev = state[3][live]
    x_prev = [a[live] for a in state[4:7]]
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


def g2p3d(
    gx0, gx1, gx2, mask, counts, grid, dx, dinv, state=None, alpha=0.0, dtv=0.0, tent=False,
):
    """G2P of pencil-bucketed slots (the JAX `g2p3d`; its `ext` and
    `prepadded0/1` flags are read off the grid's shape): gx0..2 and mask
    (R0, R1, K), counts (R0 * R1,) int32, grid of 6 or 9 channels with
    (R0 + 4, R1 + 4), (R0 + 4, R1) or (R0, R1) rows, or one padded window
    per slab shard, (n, L0 + 4, R1 + 4, gch, G2) with n L0 = R0 and gx0
    local to each shard.

    Update mode, `state` = (v0, v1, v2, J, x0, x1, x2) with a 6-channel
    grid and B-spline taps -> (R0, R1, 16, K) = [x (3), v (3), C00..C22,
    J].  Gather mode, `state=None` -> (R0, R1, 15 or 18, K) = [vpic (3),
    v_old (3), C00..C22 (, Jbar, p, div)], zeros in slots past the count,
    masked off or out of margin; with `tent` the caller passes dinv = 1
    and inverts the per-particle D itself."""
    r0, r1, k = gx0.shape
    update = state is not None
    planes = (gx0, gx1, gx2, mask, *(state if update else ()))
    if update and len(state) != 7:
        raise ValueError(f"state: expected 7 planes, got {len(state)}")
    strides = [_check_plane(f"plane[{i}]", p, (r0, r1, k)) for i, p in enumerate(planes)]
    _check("counts", counts, (r0 * r1,), torch.int32)
    if grid.dtype != torch.float32:
        raise TypeError(f"grid: expected torch.float32, got {grid.dtype}")
    grid = _padded_grid(grid, r0, r1)
    gch, g2 = grid.shape[-2], grid.shape[-1]
    if update and (gch != G2P_CH or tent):
        raise ValueError("update mode takes the 6-channel grid and B-spline taps")
    if grid.dim() == 5:
        l0 = r0 // grid.shape[0]
        _check("grid", grid, (grid.shape[0], l0 + NT - 1, r1 + NT - 1, gch, g2), torch.float32)
    else:
        l0 = r0
        _check("grid", grid, (r0 + NT - 1, r1 + NT - 1, gch, g2), torch.float32)
    if _route(counts, grid, *planes) == "cpu":
        return g2p3d_plain(gx0, gx1, gx2, mask, counts, grid, dx, dinv, state, alpha, dtv, tent)
    lib = _build.load().lib
    nout = G2P_UPD if update else G2P_OUT + gch - G2P_CH
    out = torch.empty((r0, r1, nout, k), dtype=torch.float32, device=counts.device)
    ptrs, pstr = _plane_args(planes, strides)
    if update:
        rc = lib.mpm_g2p3d(
            ptrs, pstr, _ptr(counts), _ptr(grid), _ptr(out), r0, l0, r1, k, g2,
            dx, dinv, alpha, 1.0 - alpha, dtv, _stream(counts),
        )
    else:
        rc = lib.mpm_g2p3d_gather(
            ptrs, pstr, _ptr(counts), _ptr(grid), _ptr(out), r0, l0, r1, k, g2, gch,
            int(tent), dx, dinv, _stream(counts),
        )
    LAUNCHES["g2p3d"] += 1
    _raise_on(rc, "g2p3d")
    return out
