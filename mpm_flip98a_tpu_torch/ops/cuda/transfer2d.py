"""2D P2G / G2P transfers over row-bucketed particles, as CUDA kernels.

Counterpart of `mpm_flip98a_tpu/ops/pallas/transfer2d.py`.  The TPU
kernels turn the column scatter/gather into dense one-hot matrix products
for the MXU; on the GPU each particle simply touches its 3x3 nodes:

- `p2g_fused` (csrc/p2g.cu) replaces the Pallas `p2g_fused`
  (transfer2d.py:412, pallas_call :433): fluid stress computed per slot,
  then the quadratic B-spline transfer of [m v0, m v1, m v0 + f0, m v1 +
  f1, m] to the 5 candidate target rows of each bucket row.
- `p2g` (csrc/p2g.cu) replaces the Pallas `p2g` (transfer2d.py:304,
  pallas_call :323): the same transfer of stress prepped outside the
  kernel (`pdata`), 6 or 9 channels, B-spline or tent taps.
- `p2g_grid` (csrc/p2g.cu) replaces the Pallas `p2g_grid`
  (transfer2d.py:597, pallas_call :666) in both modes: raw, the
  slab-sharded path's (the fused or prepped transfer of every shard's rows
  in one launch of the same kernel, then a fold launch into each shard's
  raw, uncropped (L + 4, nch, G) halo rows), and non-raw on one device
  (MPM_P2G_GRID=1: the fold launch also finishes each node, with the JAX
  kernel's mass floor, gravity, walls or penalty solve, rigid colliders and
  nodal averages, into the g2p-ready (R + 4, 4 or 7, G) grid).
One fixed-order gather with no float atomics computes the three: reruns
are bitwise equal, and `p2g_grid`'s raw output equals `fold_rows_halo` of
`p2g` / `p2g_fused` per shard bit for bit.  `plan_p2g` (and
`plan_p2g_fused` for the fused record) sizes its column bands and staging
window.
- `g2p` (csrc/g2p.cu) replaces the Pallas `g2p` (transfer2d.py:843,
  pallas_call :893): vpic, the gathered pre-force velocity, C = D^-1 sum
  w v (x_node - x_p)^T and, with the 7-channel grid, the gathered Jbar, p
  and div; B-spline or tent taps; on an unpadded grid or, `prepadded`, on
  each slab shard's halo rows (or `p2g_grid`'s finished grid); and with
  `update` (MPM_FUSE2D_G2P=1) the particle update in the kernel: the FLIP
  blend, advection and the J update.

Each kernel has a plain PyTorch version with the same contract beside it
(`p2g_fused_plain`, `p2g_plain`, `p2g_grid_plain`, `g2p_plain`).  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises.  `LAUNCHES` counts kernel launches per wrapper, so a run
can show that its main path went through the kernels.

Layouts are the JAX package's, so the two compare at this boundary:
  P2G fused in : sdata (R, 11, K) = [gx0, gx1, v0, v1, C00, C01, C10, C11,
                 J, mass, vol0], counts (R,) int32
  P2G in       : pdata (R, 8 + nch, K) = [gx0, gx1, m v0, m v1, P (4),
                 Q (4), *plain], plain = [m, V] (nch 6) or [m, V0 J, V0,
                 V0 p, V0 div] (nch 9), every value row pre-masked
  P2G out      : (R, 5, nch, G) (nch 5 fused), target row t of bucket i
                 is grid row i + t - 1; channels [m v (2), m v + f (2),
                 *plain]
  p2g_grid out : raw: n slab shards of L = R / n bucket rows (gx0 local
                 to the shard): (n, L + 4, nch, G), row j of shard s its
                 target row j - 1, = fold_rows_halo of P2G out per shard;
                 non-raw: (R + 4, 4 or 7, G) = [v_new (2), v_old (2)(,
                 Jbar, p, div)], row j target row j - 1, pad rows zero
  G2P in       : pdata2 (R, 3, K) = [gx0, gx1, mask], counts, grid
                 (R, 4 or 7, G) = [v_new (2), v_old (2)(, Jbar, p, div)]
                 (unpadded: rows outside [0, R) read as zero) or,
                 prepadded, (n, L + 4, 4 or 7, G) as p2g_grid's out
  G2P out      : (R, 8 or 11, K) = [vpic (2), vold (2), C00, C01, C10,
                 C11(, Jbar, p, div)]; update mode: pdata2 (R, 8, K) =
                 [gx0, gx1, mask, v0, v1, J, x0, x1] -> (R, 9, K) = [x (2),
                 v (2), C (4), J]

Semantics kept from the TPU kernels: a slot contributes only when its
base row is within +-1 of its bucket row; taps on columns outside [0, G)
are dropped; P2G and G2P read the same precomputed gx.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from mpm_flip98a_tpu_torch import _build
from mpm_flip98a_tpu_torch.config import scalar

NT = 5             # candidate target rows: bucket_row - 1 .. bucket_row + 3
P2G_CH_FUSED = 5   # [m v0, m v1, m v0 + f0, m v1 + f1, m]
P2G_CH = 6         # + V
P2G_CH_EXT = 9     # + [V0 J, V0, V0 p, V0 div] in place of V
G2P_CH = 4         # [v_new0, v_new1, v_old0, v_old1]
G2P_CH_EXT = 7     # + [Jbar, p, div]
G2P_OUT = 8        # [vpic0, vpic1, vold0, vold1, C00, C01, C10, C11]
G2P_UPD = 9        # update mode: [x0, x1, v0, v1, C00, C01, C10, C11, J]
EOS_CODES = {"linear": 0, "tait": 1}
WALL_CODES = {"slip": 0, "sticky": 1, "penalty": 2}
MAX_COLLIDERS = 8     # csrc/colliders.cuh's colliders::kMax
COLLIDER_KINDS = {"sphere": 0, "box": 1, "halfspace": 2}

# The fixed-order gathers' plans (csrc/p2g.cu, csrc/p2g3d.cu; transfer3d's
# plan_p2g3d too).  P2G_WARPS warps a block (p2g.cu's kWarps);
# P2G_BLOCKS_PER_SM blocks share an SM (its kBlocksPerSM, the register cap
# of its __launch_bounds__) and so its 228 KB of shared memory, less the
# 1 KB the system reserves and the kernel's static arrays (SMEM_STATIC,
# with room for rounding) per block.  A block owns at most P2G_MAX_BAND
# columns.
SMEM_SM = 233_472
SMEM_OPTIN = 232_448      # Hopper's opt-in limit per block
SMEM_STATIC = 128
MIN_CAP = 64
P2G_WARPS = 8
P2G_BLOCKS_PER_SM = 3
P2G_MAX_BAND = 256

# Kernel launches per wrapper (the plain versions do not count).
LAUNCHES = {"p2g_fused": 0, "p2g": 0, "p2g_grid": 0, "g2p": 0}


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


def _axis_weights_tent(fx):
    """Linear hat taps on the same 3-node stencil, fx in [0.5, 1.5)
    (transfer2d.py:132-140)."""
    return ((1.0 - fx).clamp(min=0.0), 1.0 - (fx - 1.0).abs(), (fx - 1.0).clamp(min=0.0))


def _taps(fx, tent: bool):
    return _axis_weights_tent(fx) if tent else _axis_weights(fx)


def _col_weights(d, tent: bool = False):
    """Column weight as a function of the signed distance d = col - gx1:
    the B-spline's 0.5 (1.5-|d|)+^2 - 1.5 (0.5-|d|)+^2 (the same piecewise
    values as `_axis_weights`) or the tent's (1-|d|)+, the formulas the
    TPU kernels use (transfer2d.py:147-159)."""
    a = d.abs()
    if tent:
        return (1.0 - a).clamp(min=0.0)
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


def _scatter_plain(gx0, gx1, counts, mv, p_aff, q_aff, plain, g, dx, tent, apic):
    """Shared plain P2G body (the counterpart of `_p2g_core`,
    transfer2d.py:210-277): channels [m v (2), m v + f (2), *plain] of the
    (R, K) slot planes, one `index_add_` per stencil tap into a flat
    (R * 5 * nch * G) view.  Sequential and deterministic on the CPU; on a
    card `index_add_` sums with atomics in no fixed order."""
    r, k = gx0.shape
    dev = gx0.device
    nch = 4 + len(plain)
    base0 = torch.floor(gx0 - 0.5)
    rel = base0 - _row_ids(r, dev)
    live = _live(counts, k) & (rel >= -1.0) & (rel <= 1.0)
    w0 = _taps(gx0 - base0, tent)
    base1 = torch.floor(gx1 - 0.5)
    rows = torch.arange(r, device=dev)[:, None]
    chan = torch.arange(nch, device=dev)[:, None]

    out = torch.zeros(r * NT * nch * g, dtype=gx0.dtype, device=dev)
    for j in range(3):
        t = torch.where(live, rel, 0.0).long() + (j + 1)   # target row 0..4
        rdp = (base0 + float(j) - gx0) * dx
        if apic:
            row0 = mv[0] + p_aff[0] * rdp
            row1 = mv[1] + p_aff[2] * rdp
        row2 = mv[0] + q_aff[0] * rdp
        row3 = mv[1] + q_aff[2] * rdp
        for jc in range(3):
            c = base1 + float(jc)
            ok = live & (c >= 0.0) & (c < g)
            d = c - gx1
            cd = d * dx
            w = w0[j] * _col_weights(d, tent)
            if apic:
                ch0 = w * (row0 + p_aff[1] * cd)
                ch1 = w * (row1 + p_aff[3] * cd)
            else:
                ch0 = w * mv[0]
                ch1 = w * mv[1]
            vals = torch.stack([
                ch0, ch1,
                w * (row2 + q_aff[1] * cd),
                w * (row3 + q_aff[3] * cd),
                *(w * e for e in plain),
            ])  # (nch, R, K)
            col = torch.where(ok, c, 0.0).long()
            base = ((rows * NT + t) * nch) * g + col               # (R, K)
            idx = base[None] + chan[:, :, None] * g                # (nch, R, K)
            out.index_add_(0, idx[:, ok].reshape(-1), vals[:, ok].reshape(-1))
    return out.view(r, NT, nch, g)


def _fluid_affine(sdata, apic, eos, kb, mu, gamma, fa):
    """Per-slot fluid stress and affine matrices, as transfer2d.py:376-401.

    Returns (mv, mass, P or None, Q) on (R, K) planes."""
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
    return (mass * v0, mass * v1), mass, p_aff, q_aff


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
    """Plain PyTorch version of `p2g_fused`: the fluid stress, then the
    shared plain scatter."""
    mv, mass, p_aff, q_aff = _fluid_affine(sdata, apic, eos, kb, mu, gamma, fa)
    return _scatter_plain(
        sdata[:, 0], sdata[:, 1], counts, mv, p_aff, q_aff, [mass], g, dx, False, apic
    )


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
    or past counts[i] are skipped (buckets are packed, actives first).  On
    the card the stress is computed per slot in the kernel and every node
    sums its slots in a fixed order (`p2g`'s kernel): two calls on the same
    inputs give bitwise equal outputs; `plan_p2g_fused` raises past its K
    limit."""
    r, f, k = sdata.shape
    _check("sdata", sdata, (r, 11, k), torch.float32)
    _check("counts", counts, (r,), torch.int32)
    if eos not in EOS_CODES:
        raise ValueError(f"unknown eos {eos!r}")
    if _route(sdata, counts) == "cpu":
        return p2g_fused_plain(sdata, counts, g, dx, apic, eos, kb, mu, gamma, fa)
    plan = plan_p2g_fused(g, k, apic)
    lib = _build.load().lib
    out = torch.empty((r, NT, P2G_CH_FUSED, g), dtype=torch.float32, device=sdata.device)
    rc = lib.mpm_p2g_fused(
        _ptr(sdata), _ptr(counts), _ptr(out), r, k, g, dx, int(apic),
        EOS_CODES[eos], kb, kb / gamma, gamma, 2.0 * mu, mu, fa, plan.band, plan.cap,
        _stream(sdata),
    )
    LAUNCHES["p2g_fused"] += 1
    _raise_on(rc, "p2g_fused")
    return out


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """A fixed-order gather's launch plan: blocks of `band` output columns
    (z in 3D) over `g`, `cap` slot records of `rec` bytes staged at a time,
    `smem` dynamic shared bytes a block: the records, the (band + 2) x
    warps sort counters, band + 3 bin starts and `order` list entries and
    as many 2-byte tags (the sources' slots)."""

    band: int
    cap: int
    rec: int
    order: int
    smem: int
    g: int

    @property
    def bands(self) -> int:
        return -(-self.g // self.band)

    def columns(self, by: int):
        """[c0, c1) of the block at blockIdx.y = by, as the kernels decode
        it: c0 = by band, c1 = min(c0 + band, g)."""
        c0 = by * self.band
        return c0, min(c0 + self.band, self.g)


def plan_gather(g: int, rec_floats: int, order: int, max_band: int, warps: int,
                blocks_per_sm: int) -> GatherPlan:
    """Equal bands of at most `max_band` columns, and the most records
    (at least MIN_CAP or all `order` slots, at most `order`) that let
    `blocks_per_sm` blocks share an SM.  Raises when even MIN_CAP records pass the opt-in limit
    (some hundred thousand bytes of `order`: far more slots a bucket than
    any scene holds)."""
    if g <= 0 or order < 0:
        raise ValueError(f"bad gather shape: g {g}, {order} source slots")
    band = -(-g // -(-g // max_band))
    rec = 16 * -(-rec_floats // 4)
    fixed = 4 * ((band + 2) * warps + band + 3 + order) + 2 * (order + order % 2)
    budget = SMEM_SM // blocks_per_sm - 1_024 - SMEM_STATIC
    cap = min(max(order, 1), max(MIN_CAP, (budget - fixed) // rec))
    smem = fixed + cap * rec
    if smem > SMEM_OPTIN:
        raise ValueError(f"{order} source slots a block need {smem} bytes of shared memory, "
                         f"past the card's {SMEM_OPTIN}")
    return GatherPlan(band, cap, rec, order, smem, g)


def plan_p2g(nch: int, g: int, k: int, apic: bool) -> GatherPlan:
    """The 2D gather's plan (`p2g`; `p2g_grid` on the sharded path's
    buckets, 25% wider than one device's): a block per (bucket row, band);
    the K slots of its row may all be listed; a record is [t0, gx0 -
    base0, gx1 - base1, m v (2), P (4, APIC), Q (4), plain (nch - 4)]."""
    return plan_gather(g, 5 + 4 * apic + 4 + nch - 4, k, P2G_MAX_BAND, P2G_WARPS,
                       P2G_BLOCKS_PER_SM)


def plan_p2g_fused(g: int, k: int, apic: bool) -> GatherPlan:
    """`p2g_fused`'s plan: `p2g`'s kernel on the 5-channel fused record
    (10 floats under PIC, 14 under APIC, the stress computed when it is
    staged)."""
    return plan_p2g(P2G_CH_FUSED, g, k, apic)


def _nch(pdata: torch.Tensor) -> int:
    nch = pdata.shape[1] - 8
    if nch not in (P2G_CH, P2G_CH_EXT):
        raise ValueError(f"pdata: expected 14 or 17 rows, got {pdata.shape[1]}")
    return nch


def p2g_plain(
    pdata: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    dx: float,
    tent: bool = False,
    apic: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of `p2g`: the shared plain scatter of the
    prepped rows (PIC ignores the P rows, as transfer2d.py:244-249 does)."""
    nch = _nch(pdata)
    rows = pdata.unbind(1)
    return _scatter_plain(
        rows[0], rows[1], counts, rows[2:4], rows[4:8], rows[8:12],
        list(rows[12 : 8 + nch]), g, dx, tent, apic,
    )


def p2g(
    pdata: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    dx: float,
    tent: bool = False,
    apic: bool = True,
) -> torch.Tensor:
    """P2G of prepped slot data.

    pdata (R, 8 + nch, K) f32 with nch = 6 or 9, counts (R,) int32 ->
    (R, 5, nch, G) f32.  Slots at or past counts[i] are skipped.  On the
    card every node sums its slots in a fixed order: two calls on the
    same inputs give bitwise equal outputs.  A block lists a bucket row's
    slots in shared memory, so K is at most some 36,000 there
    (`plan_p2g` raises past it; the scenes use 4,096-5,376)."""
    r, f, k = pdata.shape
    nch = _nch(pdata)
    _check("pdata", pdata, (r, f, k), torch.float32)
    _check("counts", counts, (r,), torch.int32)
    if _route(pdata, counts) == "cpu":
        return p2g_plain(pdata, counts, g, dx, tent, apic)
    plan = plan_p2g(nch, g, k, apic)
    lib = _build.load().lib
    out = torch.empty((r, NT, nch, g), dtype=torch.float32, device=pdata.device)
    rc = lib.mpm_p2g(
        _ptr(pdata), _ptr(counts), _ptr(out), r, k, g, nch, dx, int(apic), int(tent),
        plan.band, plan.cap, _stream(pdata),
    )
    LAUNCHES["p2g"] += 1
    _raise_on(rc, "p2g")
    return out


def fold_rows_halo(expanded: torch.Tensor) -> torch.Tensor:
    """(R, 5, ch, G) -> (R + 4, ch, G): the uncropped fold, row j = target
    row j - 1 (transfer2d.py:705-716).

    Plain torch (the JAX package leaves it to XLA too): five shifted adds
    in the same order as the reference, so the result is bit-identical."""
    r, nt, ch, g = expanded.shape
    buf = torch.zeros((r + nt - 1, ch, g), dtype=expanded.dtype, device=expanded.device)
    for t in range(nt):
        buf[t : t + r] += expanded[:, t]
    return buf


def fold_rows(expanded: torch.Tensor) -> torch.Tensor:
    """(R, 5, ch, G) -> (R, ch, G): grid[row, ch] = sum_t expanded[row+1-t, t],
    the rows [1, R + 1) of `fold_rows_halo`."""
    return fold_rows_halo(expanded)[1 : expanded.shape[0] + 1]


def _shard_rows(r: int, shards: int) -> int:
    if shards < 1 or r % shards:
        raise ValueError(f"{r} bucket rows do not split into {shards} shards")
    return r // shards


@functools.lru_cache(maxsize=32)
def collider_arrays(colliders: tuple, dim: int = 3):
    """The kernels' host arrays of `dim`-D `colliders` (csrc/colliders.cuh,
    colliders::unpack; p2g3d_grid takes 3D ones, p2g_grid's non-raw mode
    2D ones): per collider 19 float32 [center, center velocity, radius,
    half-extents, unit normal, surface velocity, omega] and 4 int32 [kind,
    sticky, moving, spin], rounded as `colliders.project` rounds them; a 2D
    collider's third components are 0 and its omega_z goes first.  Built
    once per scene (the tuple is the cache key)."""
    from mpm_flip98a_tpu_torch.models import colliders as col   # it imports this module

    name = "p2g3d_grid" if dim == 3 else "p2g_grid"
    if len(colliders) > MAX_COLLIDERS:
        raise ValueError(f"{name} takes at most {MAX_COLLIDERS} colliders, got {len(colliders)}")
    f32 = np.float32
    three = lambda v: (*v, *(0.0,) * (3 - len(v)))
    fl, it = [], []
    for c in colliders:
        if len(c.center) != dim:
            raise ValueError(f"{name} takes {dim}D colliders, got {c}")
        vel, cvel = three(c.velocity or ()), three(c.center_velocity or ())
        normal = three(col.halfspace_normal(c) if c.kind == "halfspace" else ())
        fl += [*three(c.center), *cvel, c.radius, *three(c.half_extents or ()), *normal,
               *(f32(vel[a]) + f32(cvel[a]) for a in range(3)), *three(c.angular or ())]
        it += [COLLIDER_KINDS[c.kind], int(c.sticky), int(c.moving), int(bool(c.angular))]
    n = len(colliders)
    # float32 first, so the C floats hold the values numpy rounded.
    return ((ctypes.c_float * max(n * 19, 1))(*np.asarray(fl, np.float32).tolist()),
            (ctypes.c_int * max(n * 4, 1))(*it), n)


def _f32(v) -> float:
    """v rounded to float32 once, as a Python float (exact in float32)."""
    return float(np.float32(v))


def grid_update2d_plain(raw, r, dt, gx_, gy_, floor, lo, hi, wall, beta, colliders=(),
                        tcol=None, dx=0.0):
    """The node pass of `p2g_grid`'s non-raw mode, the JAX kernel's
    arithmetic (transfer2d.py:476-560): the raw (R + 4, nch, G) halo sums
    of one device (row j = target row j - 1) -> the finished (R + 4, 4 or
    7, G) grid [v_new (2), v_old (2) (, Jbar, p, div)].  The absolute mass
    floor; gravity; slip or sticky walls or the penalty's diagonal solve
    (p + dt g m) / (m + dt beta pen), pen 1 on the axis's wall band (rows
    or columns <= lo or >= hi); the colliders projected at node x = ((row -
    lo) dx, (col - lo) dx) at time `tcol` (None: static), then cropped to
    the interior rows; with 9 channels the nodal averages (Jbar 1 where no
    volume landed, on interior rows only).  The scalars dt g and dt beta
    are rounded to float32 once from their double products, as the JAX
    kernel's weakly typed constants are.  Rows outside [0, R) are zero."""
    win, nch, g = raw.shape
    dev, f32 = raw.device, raw.dtype
    t0r = torch.arange(win, device=dev)[:, None] - 1               # target rows
    col_idx = torch.arange(g, device=dev)[None, :]
    interior = (t0r >= 0) & (t0r < r)
    m = raw[:, 4]
    has = (m > _f32(floor)) & interior
    safe = torch.where(has, m, 1.0)
    v0x = torch.where(has, raw[:, 0] / safe, 0.0)
    v0y = torch.where(has, raw[:, 1] / safe, 0.0)
    low0, high0, low1, high1 = t0r <= lo, t0r >= hi, col_idx <= lo, col_idx >= hi
    dtg = [_f32(float(dt) * float(a)) for a in (gx_, gy_)]
    if wall == "penalty":
        dtb = _f32(float(dt) * float(beta))
        pen0, pen1 = (low0 | high0).to(f32), (low1 | high1).to(f32)
        vx = torch.where(has, (raw[:, 2] + dtg[0] * m) / (m + dtb * pen0), 0.0)
        vy = torch.where(has, (raw[:, 3] + dtg[1] * m) / (m + dtb * pen1), 0.0)
    else:
        hasf = has.to(f32)
        vx = torch.where(has, raw[:, 2] / safe, 0.0) + dtg[0] * hasf
        vy = torch.where(has, raw[:, 3] / safe, 0.0) + dtg[1] * hasf
        if wall == "sticky":
            anyband = low0 | high0 | low1 | high1
            vx = torch.where(anyband, 0.0, vx)
            vy = torch.where(anyband, 0.0, vy)
        else:   # slip: clamp the outgoing normal component per band
            vx = torch.where(low0, vx.clamp(min=0.0), vx)
            vx = torch.where(high0, vx.clamp(max=0.0), vx)
            vy = torch.where(low1, vy.clamp(min=0.0), vy)
            vy = torch.where(high1, vy.clamp(max=0.0), vy)
    if colliders:
        from mpm_flip98a_tpu_torch.models import colliders as col

        dxc = scalar(dx, f32)
        coords = [(t0r.to(f32) - lo) * dxc, (col_idx.to(f32) - lo) * dxc]
        vx, vy = col.project([vx, vy], coords, colliders, tcol)
        vx = torch.where(interior, vx, 0.0)
        vy = torch.where(interior, vy, 0.0)
    rows = [vx, vy, v0x, v0y]
    if nch == P2G_CH_EXT:
        v0sum = raw[:, 6]
        has_v = (v0sum > 0) & interior
        safe_v = torch.where(has_v, v0sum, 1.0)
        rows += [
            torch.where(has_v, raw[:, 5] / safe_v, interior.to(f32)),
            torch.where(has_v, raw[:, 7] / safe_v, 0.0),
            torch.where(has_v, raw[:, 8] / safe_v, 0.0),
        ]
    return torch.stack([x.expand(win, g) for x in rows], dim=1)


def _node_args(raw, shards, dt, gx_, gy_, floor, lo, hi, wall, colliders):
    """Checks the node arguments of `p2g_grid`: no colliders with `raw`;
    without it one device and all of dt, gx_, gy_, floor, lo, hi and wall
    (TypeError when one is missing)."""
    if raw:
        if colliders:
            raise ValueError("p2g_grid's raw mode takes no colliders: the grid update applies "
                             "them")
        return
    if shards != 1:
        raise ValueError("p2g_grid's non-raw mode runs on one device (shards = 1)")
    missing = [n for n, v in zip(("dt", "gx_", "gy_", "floor", "lo", "hi", "wall"),
                                 (dt, gx_, gy_, floor, lo, hi, wall)) if v is None]
    if missing:
        raise TypeError(f"p2g_grid: the grid update needs {', '.join(missing)}")
    if wall not in WALL_CODES:
        raise ValueError(f"unknown wall {wall!r}")


def p2g_grid_plain(
    data: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    dx: float,
    *,
    fused: bool,
    tent: bool = False,
    apic: bool = True,
    raw: bool = False,
    eos: str = "tait",
    kb: float = 0.0,
    mu: float = 0.0,
    gamma: float = 7.0,
    fa: float = 0.0,
    dt=None, gx_=None, gy_=None, floor=None, lo=None, hi=None, wall=None, beta=0.0,
    colliders=(), tcol=None,
    shards: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of `p2g_grid`: per shard, `fold_rows_halo` of
    `p2g_fused_plain` (fused) or `p2g_plain` (prepped), which is what the
    TPU kernel's raw output equals (transfer2d.py:637-641); without `raw`,
    `grid_update2d_plain` of the one device's sums."""
    _node_args(raw, shards, dt, gx_, gy_, floor, lo, hi, wall, colliders)
    l = _shard_rows(data.shape[0], shards)
    out = []
    for s in range(shards):
        d, c = data[s * l : (s + 1) * l], counts[s * l : (s + 1) * l]
        if fused:
            expanded = p2g_fused_plain(d, c, g, dx, apic, eos, kb, mu, gamma, fa)
        else:
            expanded = p2g_plain(d, c, g, dx, tent, apic)
        out.append(fold_rows_halo(expanded))
    if raw:
        return torch.stack(out)
    return grid_update2d_plain(out[0], l, dt, gx_, gy_, floor, lo, hi, wall, beta, colliders,
                               tcol, dx)


def p2g_grid(
    data: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    dx: float,
    *,
    fused: bool,
    tent: bool = False,
    apic: bool = True,
    raw: bool = False,
    eos: str = "tait",
    kb: float = 0.0,
    mu: float = 0.0,
    gamma: float = 7.0,
    fa: float = 0.0,
    dt=None, gx_=None, gy_=None, floor=None, lo=None, hi=None, wall=None, beta=0.0,
    colliders=(), tcol=None,
    shards: int = 1,
) -> torch.Tensor:
    """P2G + the five-row fold (the JAX `p2g_grid`): raw halo sums batched
    over slab shards, or on one device the finished g2p-ready grid.

    data: sdata (R, 11, K) with `fused` (fluid stress in the kernel,
    B-spline) or prepped pdata (R, 8 + nch, K), nch 6 or 9; counts (R,)
    int32.  `raw=True`: R = shards x L with gx0 local to each shard ->
    (shards, L + 4, nch, G) f32 (nch 5 fused), row j of shard s its target
    row j - 1, uncropped.  `raw=False` (one device, the JAX default): the
    node pass of `grid_update2d_plain` with the JAX arguments dt, gx_, gy_
    (gravity), floor (the absolute mass floor), lo, hi (the wall bands),
    wall ("slip", "sticky" or "penalty"), beta (the penalty), `colliders`
    (2D `models/colliders.Collider`s, at most 8) and `tcol` (their time,
    None: static) -> (R + 4, 4 or 7, G) f32 = [v_new (2), v_old (2) (,
    Jbar, p, div)], row j its target row j - 1, pad rows zero, for the
    prepadded `g2p` (as one shard: `out[None]`).

    On the card `p2g`'s gather sums every shard's rows into a (R, 5, nch,
    G) scratch buffer (the columns with sums only, their ranges beside) and
    a second launch folds it in `fold_rows_halo`'s order (and, not raw,
    finishes each node): the raw output equals `fold_rows_halo` of
    `p2g_fused` / `p2g` per shard bit for bit, and two calls on the same
    inputs are bitwise equal; `plan_p2g` raises past its K limit."""
    r, f, k = data.shape
    if fused:
        if f != 11:
            raise ValueError(f"sdata: expected 11 rows, got {f}")
        if tent:
            raise ValueError("the fused mode has B-spline taps only")
        if eos not in EOS_CODES:
            raise ValueError(f"unknown eos {eos!r}")
        nch = P2G_CH_FUSED
    else:
        nch = _nch(data)
    l = _shard_rows(r, shards)
    _node_args(raw, shards, dt, gx_, gy_, floor, lo, hi, wall, colliders)
    _check("data", data, (r, f, k), torch.float32)
    _check("counts", counts, (r,), torch.int32)
    kw = dict(fused=fused, tent=tent, apic=apic, raw=raw, eos=eos, kb=kb, mu=mu, gamma=gamma,
              fa=fa, dt=dt, gx_=gx_, gy_=gy_, floor=floor, lo=lo, hi=hi, wall=wall, beta=beta,
              colliders=colliders, tcol=tcol, shards=shards)
    if _route(data, counts) == "cpu":
        return p2g_grid_plain(data, counts, g, dx, **kw)
    plan = plan_p2g(nch, g, k, apic)
    lib = _build.load().lib
    expanded = torch.empty((r, NT, nch, g), dtype=torch.float32, device=data.device)
    ranges = torch.empty((r, plan.bands, 2), dtype=torch.int32, device=data.device)
    if raw:
        out = torch.empty((shards, l + NT - 1, nch, g), dtype=torch.float32, device=data.device)
        node = (0.0, 0.0, 0.0, 0, 0, 0, 0.0)
    else:
        gch = G2P_CH_EXT if nch == P2G_CH_EXT else G2P_CH
        out = torch.empty((r + NT - 1, gch, g), dtype=torch.float32, device=data.device)
        node = (_f32(float(dt) * float(gx_)), _f32(float(dt) * float(gy_)), _f32(floor),
                int(lo), int(hi), WALL_CODES[wall], _f32(float(dt) * float(beta)))
    col_f, col_i, ncol = collider_arrays(tuple(colliders), 2)
    kin = int(tcol is not None and ncol > 0)
    rc = lib.mpm_p2g_grid(
        _ptr(data), _ptr(counts), _ptr(expanded), _ptr(ranges), _ptr(out), shards, l, k, g, nch,
        int(fused), int(tent), dx, int(apic), EOS_CODES[eos], kb, kb / gamma, gamma, 2.0 * mu,
        mu, fa, plan.band, plan.cap, int(raw), *node, col_f, col_i, ncol, kin,
        float(tcol) if kin else 0.0, _stream(data),
    )
    LAUNCHES["p2g_grid"] += 1
    _raise_on(rc, "p2g_grid")
    return out


# ---------------------------------------------------------------------------
# G2P
# ---------------------------------------------------------------------------


def _g2p_grid_rows(r: int, grid: torch.Tensor, prepadded: bool):
    """(rows per shard L, first grid row of each bucket row's window (R, 1)
    int64, its pad offset, rows per window) of an unpadded (R, gch, G) or
    a prepadded (n, L + 4, gch, G) grid."""
    if not prepadded:
        return r, torch.zeros((r, 1), dtype=torch.long, device=grid.device), 0, r
    n, win = grid.shape[0], grid.shape[1]
    l = _shard_rows(r, n)
    shard = torch.arange(r, device=grid.device)[:, None] // l
    return l, shard * win, 1, win


def _update_constants(alpha: float, dtv: float):
    """(alpha, 1 - alpha, dtv) as float32 values, each rounded once from a
    double, as the JAX kernel's weakly typed scalars are."""
    return _f32(alpha), _f32(1.0 - float(alpha)), _f32(dtv)


def g2p_plain(
    pdata2: torch.Tensor,
    counts: torch.Tensor,
    grid: torch.Tensor,
    dx: float,
    dinv: float,
    tent: bool = False,
    prepadded: bool = False,
    update: bool = False,
    alpha: float = 0.0,
    dtv: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of `g2p`: per stencil tap, one clamped gather
    of the grid channels, summed in the kernel's order (rows, then
    columns).  With `prepadded`, bucket row i of shard s = i // L reads row
    (row + 1) of its window grid[s].  `update` then applies the particle
    update of the JAX kernel (transfer2d.py:815-830) to the gathers."""
    r, _, k = pdata2.shape
    gch, g = grid.shape[-2], grid.shape[-1]
    dev = pdata2.device
    l, win0, pad, win = _g2p_grid_rows(r, grid, prepadded)
    gx0, gx1, mask = pdata2[:, :3].unbind(1)
    base0 = torch.floor(gx0 - 0.5)
    rel = base0 - (torch.arange(r, device=dev) % l).to(torch.float32)[:, None]
    valid = _live(counts, k) & (mask > 0) & (rel >= -1.0) & (rel <= 1.0)
    w0 = _taps(gx0 - base0, tent)
    base1 = torch.floor(gx1 - 0.5)
    flat = grid.reshape(-1)
    zero = torch.zeros_like(gx0)
    vp0, vp1, vo0, vo1, b00, b01, b10, b11 = (zero,) * 8
    extra = [zero] * (gch - G2P_CH)
    for j in range(3):
        row = base0 + float(j)
        rdp = (row - gx0) * dx
        wrow = row + float(pad)              # row in the shard's window
        rin = valid & (wrow >= 0.0) & (wrow < win)
        for jc in range(3):
            c = base1 + float(jc)
            ok = rin & (c >= 0.0) & (c < g)
            d = c - gx1
            w = torch.where(ok, w0[j] * _col_weights(d, tent), 0.0)
            at = ((win0 + torch.where(ok, wrow, 0.0).long()) * gch) * g \
                + torch.where(ok, c, 0.0).long()
            vn0, vn1, vo0_, vo1_, *ext = (flat[at + e * g] for e in range(gch))
            vp0 = vp0 + w * vn0
            vp1 = vp1 + w * vn1
            vo0 = vo0 + w * vo0_
            vo1 = vo1 + w * vo1_
            wr, wd = w * rdp, w * d
            b00 = b00 + wr * vn0
            b01 = b01 + wd * vn0
            b10 = b10 + wr * vn1
            b11 = b11 + wd * vn1
            extra = [a + w * e for a, e in zip(extra, ext)]
    dinv_dx = dinv * dx
    c_out = [dinv * b00, dinv_dx * b01, dinv * b10, dinv_dx * b11]
    if not update:
        return torch.stack([vp0, vp1, vo0, vo1, *c_out, *extra], dim=1)
    a32, oma, dt32 = _update_constants(alpha, dtv)
    v0, v1, jj, x0, x1 = pdata2[:, 3:].unbind(1)
    live = _live(counts, k)
    x_new = [x0 + dt32 * vp0, x1 + dt32 * vp1]
    v_new = [(a32 * (v + vp - vo) + oma * vp) * mask
             for v, vp, vo in ((v0, vp0, vo0), (v1, vp1, vo1))]
    j_new = torch.where(mask > 0, jj * (1.0 + dt32 * (c_out[0] + c_out[3])), 1.0)
    # Slots past the count: x passes through, v = C = 0, J = 1.
    outs = [
        torch.where(live, e, fill)
        for e, fill in zip([*x_new, *v_new, *c_out, j_new], [x0, x1, *(zero,) * 6, zero + 1.0])
    ]
    return torch.stack(outs, dim=1)


def g2p(
    pdata2: torch.Tensor,
    counts: torch.Tensor,
    grid: torch.Tensor,
    dx: float,
    dinv: float,
    tent: bool = False,
    prepadded: bool = False,
    update: bool = False,
    alpha: float = 0.0,
    dtv: float = 0.0,
) -> torch.Tensor:
    """pdata2 (R, 3, K), counts (R,) int32, grid (R, 4 or 7, G) ->
    (R, 8 or 11, K).

    Dead slots (past the count, mask 0, or outside the +-1-row margin)
    get zeros.  Grid rows outside [0, R) read as zero, like the TPU
    kernel's zero-padded grid.  With `prepadded` the grid is the slab
    shards' halo-synced (n, L + 4, 4 or 7, G), n L = R, gx0 local to each
    shard (transfer2d.py:859-863), or one device's `p2g_grid` output as
    n = 1.  The tent kernel takes dinv as given (the caller passes 1 and
    inverts the per-particle D itself).

    `update=True` (MPM_FUSE2D_G2P=1's fused particle update,
    transfer2d.py:815-830): pdata2 (R, 8, K) = [gx0, gx1, mask, v0, v1, J,
    x0, x1] and the 4-channel grid -> (R, 9, K) = [x0 + dtv vpic, (alpha
    (v + vpic - vold) + (1 - alpha) vpic) mask, C00, C01, C10, C11, J (1 +
    dtv (C00 + C11)) where mask > 0 else 1]; slots past the count keep x
    and get v = C = 0, J = 1."""
    r, npd, k = pdata2.shape
    gch, g = grid.shape[-2], grid.shape[-1]
    if gch not in (G2P_CH, G2P_CH_EXT):
        raise ValueError(f"grid: expected 4 or 7 channels, got {gch}")
    if update and gch != G2P_CH:
        raise ValueError("g2p's update mode takes the 4-channel grid")
    _check("pdata2", pdata2, (r, 8 if update else 3, k), torch.float32)
    _check("counts", counts, (r,), torch.int32)
    if prepadded:
        if grid.dim() != 4:
            raise ValueError(f"prepadded grid: expected (shards, L + 4, ch, G), got "
                             f"{tuple(grid.shape)}")
        l = _shard_rows(r, grid.shape[0])
        _check("grid", grid, (grid.shape[0], l + NT - 1, gch, g), torch.float32)
    else:
        l = r
        _check("grid", grid, (r, gch, g), torch.float32)
    if _route(pdata2, counts, grid) == "cpu":
        return g2p_plain(pdata2, counts, grid, dx, dinv, tent, prepadded, update, alpha, dtv)
    lib = _build.load().lib
    n_out = G2P_UPD if update else G2P_OUT + gch - G2P_CH
    out = torch.empty((r, n_out, k), dtype=torch.float32, device=pdata2.device)
    rc = lib.mpm_g2p(
        _ptr(pdata2), _ptr(counts), _ptr(grid), _ptr(out), r, l, int(prepadded), k, g, gch,
        int(tent), dx, dinv, dinv * dx, int(update), *_update_constants(alpha, dtv),
        _stream(pdata2),
    )
    LAUNCHES["g2p"] += 1
    _raise_on(rc, "g2p")
    return out
