// P2G over row-bucketed particles, for Hopper (sm_90a): prepped slot data
// (`p2g`), the fused fluid stress (`p2g_fused`), and either of them folded
// into the raw halo rows of slab shards or, on one device, into the
// finished g2p-ready grid (`p2g_grid`), one gather kernel.
//
// Replaces three Pallas TPU kernels in mpm_flip98a_tpu/ops/pallas/transfer2d.py:
//   `p2g`       (def :304, pallas_call :323, body _p2g_kernel :176 ->
//               _p2g_chunk :197 -> _p2g_core :210);
//   `p2g_fused` (def :412, pallas_call :433, body _p2g_fused_chunk :367
//               -> _p2g_core :210);
//   `p2g_grid`  (def :597, pallas_call :666, body _p2g_grid_kernel :456) in
//               both modes: raw, the one the slab-sharded path runs
//               (mpm_flip98a_tpu/models/fast2d.py:744-762), and non-raw,
//               the fold, grid update, walls and colliders in the kernel
//               (MPM_P2G_GRID=1, fast2d.py:563-581, :767-770).
// The TPU kernels build a dense (K, G) one-hot column-weight matrix and
// scatter with an MXU product, `p2g_grid` folding the five candidate target
// rows in a rolling VMEM scratch carried across its sequential grid and
// finishing each target row there; here each node gathers the taps of its
// slots, and GPU blocks, which run in no order, leave the fold (and the
// node pass) to a second, elementwise launch.
//
// Contract (same as the TPU kernels):
//   pdata  (R, 8 + kNch, K) f32 = [gx0, gx1, m v0, m v1, P00, P01, P10,
//          P11, Q00, Q01, Q10, Q11, *plain] with plain = [m, V] (kNch 6)
//          or [m, V0 J, V0, V0 p, V0 div] (kNch 9); every value row
//          pre-masked (zeros in dead slots)
//   or sdata (R, 11, K) f32 = [gx0, gx1, v0, v1, C00, C01, C10, C11, J,
//          mass, vol0] (fused, kNch 5, plain = [m]): the fluid stress tau
//          (linear or Tait EOS plus viscosity) per slot, Q = fa tau, + P =
//          m C under APIC (transfer2d.py:376-401)
//   counts (R,) i32 packed bucket counts (active slots first)
//   out    (R, 5, kNch, G) f32: for bucket row i, target row t (grid row
//          i + t - 1), channels [m v0, m v1, m v0 + f0, m v1 + f1, *plain];
//          p2g_grid: R = n L rows of n slab shards, gx0 local to each shard,
//          and out (n, L + 4, kNch, G), row j of shard s its local target
//          row j - 1: fold_rows_halo of the (L, 5, kNch, G) sums per shard;
//          non-raw (one device): (R + 4, 4 or 7, G) = [v_new (2), v_old (2)
//          (, Jbar, p, div)], row j its target row j - 1, rows 0 and R + 1
//          .. R + 3 zero.
// Channels 2-3 get w (m v_a + Q_a0 rdp + Q_a1 (c - gx1) dx); under APIC
// channels 0-1 get the same with P, under PIC w m v_a.  A slot contributes
// only when its base row floor(gx0 - 0.5) is within +-1 of i (of i mod L
// on shards); slots at or past min(counts[i], K) are skipped; taps on
// columns outside [0, G) are dropped.  Taps are the quadratic B-spline or,
// with kTent (prepped only), the linear hat.  The column-affine term is
// computed per tap, not as the TPU's rank-1 fold.
//
// Design: a fixed-order gather (taps.cuh, namespace gather), no float
// atomics.  One block of 256 threads per (bucket row, column band); the
// host's planner (ops/cuda/transfer2d.py, plan_p2g / plan_p2g_fused)
// picks the band (at most 256 columns: 171 at G = 513) and the staging
// window `cap`.
//   Walk: the block reads the row's positions once from device memory (8
//   warps, each a contiguous range, four steps of loads in flight) and tags
//   in shared memory each slot's base column when it is in the row margin
//   and its columns meet the band; the band's columns that no slot reaches
//   are written as zeros.
//   Sort: two walks of the tags (a counting sort per (bin, warp)) list the
//   kept slots by base column and, within a column, in slot order.
//   Sums: one thread per column c that the slots reach, in rounds of 256
//   columns, sums the slots of base columns c - 2 .. c in the list's order
//   into its five target rows' kNch channels in registers and writes them
//   once (neighbouring threads on neighbouring columns).  The slots a round
//   needs are staged in shared memory in list order, `cap` records at a
//   time ([t0, gx0 - base0, gx1 - base1, m v, P (APIC), Q, plain] in
//   float4s; the fused record gets its stress when it is staged, from
//   sdata), and stay staged for the next round while they are in the
//   window.  A thread reads each of its slots' records once for all three
//   of the slot's target rows: shared-memory bandwidth (a float per lane
//   per cycle) bounds this loop, so the records are short and the taps are
//   computed, not staged.
//   Fold (p2g_grid): the gather writes every shard's (L, 5, kNch, G) sums
//   into the caller's scratch buffer, only the columns each block has sums
//   for (their range beside, in place of the zeros), then fold_halo_kernel
//   adds each halo node's five terms from 0.0f in fold_rows_halo's order
//   (target t = 0 .. 4 of bucket row j - t; 0.0f outside the ranges), a
//   thread a halo column for all its channels.  The non-raw mode's
//   fold_finish_kernel folds the same way and finishes the node from its
//   sums in registers (finish_node2d: mass floor, gravity, walls or the
//   penalty solve, colliders.cuh's projection, the ext averages), writing
//   the (R + 4, 4 or 7, G) grid once, pad rows 0.
// Every node is written once, and its sum runs in the list's order
// whatever order the threads ran in: the result is bitwise reproducible,
// and p2g_grid's halo rows equal fold_rows_halo of p2g / p2g_fused per
// shard bit for bit (the same kernel computes the sums; the sharded and
// the single-device paths round alike).
//
// What bounds it on the H100: bytes (each live slot's 8 + kNch or 11 rows
// read, the (5, kNch, G) rows written; p2g_grid writes the columns with
// sums, and its fold reads them back and writes (L + 4, kNch, G) a shard)
// and, above them, the latency of each block's walk, sort and staging at
// three blocks an SM; no compare-and-swap loop.

#include <cuda_runtime.h>

#include "colliders.cuh"
#include "taps.cuh"

namespace {

constexpr int kNT = 5;         // candidate target rows
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks resident on an SM: the register cap of __launch_bounds__ (85: a
// thread holds 5 kNch sums) and the shared-memory budget of the host's
// planner (transfer2d.py's P2G_BLOCKS_PER_SM) follow it.
constexpr int kBlocksPerSM = 3;

// Fluid constants of the fused-stress record (transfer2d.py:376-401).
struct Fluid2d {
  int tait;
  float kb, kb_over_gamma, gamma, two_mu, mu, fa;
};

// Node-pass constants of p2g_grid's non-raw mode (transfer2d.py:476-560).
struct Node2d {
  float dtg0, dtg1;  // dt g per axis, rounded to float32 once from double
  float floor_m;     // the absolute grid-mass floor
  int lo, hi, wall;  // wall bands: rows and columns <= lo or >= hi; wall: 0
                     // slip, 1 sticky, 2 penalty
  float dt_beta;     // dt beta of the penalty, rounded once from double
  float dx;
};

// Staged record of one slot, in float4s: [t0 (int bits), gx0 - base0,
// gx1 - base1, m v (2), P (4, APIC only), Q (4), plain (kNch - 4)]; the
// fused record (kNch 5) has plain = [m].
template <int kNch, bool kApic>
struct Rec2d {
  static constexpr int kQ = 5 + (kApic ? 4 : 0);
  static constexpr int kPlain = kQ + 4;
  static constexpr int kVec = (kPlain + kNch - 4 + 3) / 4;
};

// Slot k's record from the bucket row at `row` (stride K).  Prepped
// (kFused false): the pdata rows as they are; PIC ignores P.  Fused: from
// the sdata rows, the weakly-compressible fluid stress tau (linear or Tait
// EOS plus viscosity), P = m C (APIC only), Q = P + fa tau (fa tau under
// PIC), plain = [m].
template <int kNch, bool kApic, bool kFused>
__device__ __forceinline__ void make_rec(const float* row, int K, int k, float fi,
                                         const Fluid2d& f,
                                         float r[4 * Rec2d<kNch, kApic>::kVec]) {
  using R = Rec2d<kNch, kApic>;
  const float gx0 = row[k], gx1 = row[K + k];
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
  r[0] = __int_as_float(static_cast<int>(base0 - fi) + 1);  // target row of row tap 0
  r[1] = gx0 - base0;
  r[2] = gx1 - base1;
  if constexpr (kFused) {
    static_assert(kNch == 5, "the fused record has 5 channels");
    const float v0 = row[2 * K + k], v1 = row[3 * K + k];
    const float c00 = row[4 * K + k], c01 = row[5 * K + k];
    const float c10 = row[6 * K + k], c11 = row[7 * K + k];
    const float jj = row[8 * K + k], mass = row[9 * K + k];
    const float vol0 = row[10 * K + k];
    float pressure;
    if (f.tait) {
      const float j_safe = fmaxf(jj, 1e-3f);
      pressure = f.kb_over_gamma * (powf(1.0f / j_safe, f.gamma) - 1.0f);
    } else {
      pressure = -f.kb * (jj - 1.0f);
    }
    const float div = c00 + c11;
    const float vj = vol0 * jj;
    const float t00 = vj * (-pressure + f.two_mu * (c00 - 0.5f * div));
    const float t11 = vj * (-pressure + f.two_mu * (c11 - 0.5f * div));
    const float t01 = vj * (f.mu * (c01 + c10));
    const float tau[4] = {t00, t01, t01, t11};
    const float c[4] = {c00, c01, c10, c11};
    r[3] = mass * v0;
    r[4] = mass * v1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kApic) {
        r[5 + e] = mass * c[e];
        r[R::kQ + e] = r[5 + e] + f.fa * tau[e];
      } else {
        r[R::kQ + e] = f.fa * tau[e];
      }
    }
    r[R::kPlain] = mass;
  } else {
    r[3] = row[2 * K + k];
    r[4] = row[3 * K + k];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kApic) r[5 + e] = row[(4 + e) * K + k];
      r[R::kQ + e] = row[(8 + e) * K + k];
    }
#pragma unroll
    for (int e = 0; e < kNch - 4; ++e) r[R::kPlain + e] = row[(12 + e) * K + k];
  }
#pragma unroll
  for (int e = R::kPlain + kNch - 4; e < 4 * R::kVec; ++e) r[e] = 0.0f;
}

// The slot's taps on target rows kT0 .. kT0 + 2 of its column: row tap j
// has weight w0[j] wc and offset rdp = (base0 + j - gx0) dx; u holds the
// column parts m v_a + A_a1 cd (A = P for channels 0-1 under APIC, Q for
// 2-3).
template <int kNch, bool kApic, int kT0>
__device__ __forceinline__ void add_rows(const float* r, const float w0[3], float wc,
                                         const float u[4], float dx, float acc[kNT][kNch]) {
  using R = Rec2d<kNch, kApic>;
  const float* q = r + R::kQ;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float w = w0[j] * wc;
    const float rdp = (static_cast<float>(j) - r[1]) * dx;
    float* a = acc[kT0 + j];
    if (kApic) {
      a[0] += w * (u[0] + r[5] * rdp);
      a[1] += w * (u[1] + r[7] * rdp);
    } else {
      a[0] += w * u[0];
      a[1] += w * u[1];
    }
    a[2] += w * (u[2] + q[0] * rdp);
    a[3] += w * (u[3] + q[2] * rdp);
#pragma unroll
    for (int e = 0; e < kNch - 4; ++e) a[4 + e] += w * r[R::kPlain + e];
  }
}

// Adds a staged slot's taps with column tap kJc (column base1 + kJc) to the
// column's five target rows.
template <int kNch, bool kTent, bool kApic, int kJc>
__device__ __forceinline__ void visit(const float4* rec, float dx, float acc[kNT][kNch]) {
  using R = Rec2d<kNch, kApic>;
  float r[4 * R::kVec];
#pragma unroll
  for (int v = 0; v < R::kVec; ++v) {
    const float4 f = rec[v];
    r[4 * v] = f.x;
    r[4 * v + 1] = f.y;
    r[4 * v + 2] = f.z;
    r[4 * v + 3] = f.w;
  }
  float w0[3];
  taps::axis<kTent>(r[1], w0);
  const float d = static_cast<float>(kJc) - r[2];  // c - gx1
  const float wc = taps::col<kTent>(d), cd = d * dx;
  const float* q = r + R::kQ;
  const float u[4] = {kApic ? r[3] + r[6] * cd : r[3], kApic ? r[4] + r[8] * cd : r[4],
                      r[3] + q[1] * cd, r[4] + q[3] * cd};
  const int t0 = __float_as_int(r[0]);
  if (t0 == 0) {
    add_rows<kNch, kApic, 0>(r, w0, wc, u, dx, acc);
  } else if (t0 == 1) {
    add_rows<kNch, kApic, 1>(r, w0, wc, u, dx, acc);
  } else {
    add_rows<kNch, kApic, 2>(r, w0, wc, u, dx, acc);
  }
}

// Bucket row i of a launch over R = n L rows is row i mod L of its shard
// (L = R on one device).  With `ranges` (p2g_grid's gather) the block
// writes only its columns with sums, all five target rows of them, and
// their first and last column to ranges[(i, blockIdx.y)] (first > last
// when it has none), in place of the zeros around them.
template <int kNch, bool kTent, bool kApic, bool kFused>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p2g_kernel(const float* __restrict__ data, const int* __restrict__ counts,
           float* __restrict__ out, int* __restrict__ ranges, int L, int K, int G, int band,
           int cap, float dx, Fluid2d fluid) {
  using R = Rec2d<kNch, kApic>;
  constexpr int kFields = kFused ? 11 : 8 + kNch;
  extern __shared__ float4 smem[];
  float4* stage = smem;                                              // [cap][kVec]
  int* cnt = reinterpret_cast<int*>(stage + static_cast<size_t>(cap) * R::kVec);
  int* bstart = cnt + (band + 2) * kWarps;                           // [band + 3]
  int* order = bstart + band + 3;                                    // [K]
  short* tag = reinterpret_cast<short*>(order + K);                  // [K]
  __shared__ int range[2];
  __shared__ int tmp[kWarps];

  const int i = blockIdx.x;
  const int c0 = blockIdx.y * band;
  const int bw = min(band, G - c0);
  const int count = max(min(counts[i], K), 0);
  const float* row = data + static_cast<size_t>(i) * kFields * K;
  const float fi = static_cast<float>(i % L);
  const float blo = static_cast<float>(c0 - 2), bhi = static_cast<float>(c0 + bw - 1);
  // Base column of slot k when it is in the row margin and its columns
  // base1 .. base1 + 2 meet the band.
  auto classify = [&](int k) {
    const float gx0 = row[k], gx1 = row[K + k];
    const float rel = floorf(gx0 - 0.5f) - fi;
    const float base1 = floorf(gx1 - 0.5f);
    const bool keep = rel >= -1.0f && rel <= 1.0f && base1 >= blo && base1 <= bhi;
    return keep ? static_cast<int>(base1) : gather::kNone;
  };
  int lo, hi;
  gather::warp_range<kThreads>(count, lo, hi);
  gather::tag_range(classify, lo, hi, c0 - 2, tag, range);
  const int bmin = range[0], bmax = range[1];
  const int nbins = bmax >= bmin ? bmax - bmin + 1 : 0;
  // Columns with sums: those the kept slots reach, inside the band.
  const int zlo = nbins ? max(c0, bmin) : c0;
  const int zhi = nbins ? min(c0 + bw - 1, bmax + 2) : c0 - 1;
  float* orow = out + static_cast<size_t>(i) * kNT * kNch * G;
  if (ranges == nullptr) {
    gather::zero_outside<kNT, kThreads>(orow, static_cast<long long>(kNch) * G, G, kNch, c0, bw,
                                        zlo, zhi);
  } else if (threadIdx.x == 0) {
    int* at = ranges + 2 * (static_cast<size_t>(i) * gridDim.y + blockIdx.y);
    at[0] = zlo;
    at[1] = zhi;
  }
  if (nbins == 0) return;

  for (int e = threadIdx.x; e < nbins * kWarps; e += kThreads) cnt[e] = 0;
  __syncthreads();
  const int tmin = bmin - (c0 - 2);
  gather::count_bins<kWarps>(tag, lo, hi, tmin, cnt);
  const int total = gather::exclusive_scan<kThreads>(cnt, nbins * kWarps, tmp);
  for (int b = threadIdx.x; b <= nbins; b += kThreads) {
    bstart[b] = b < nbins ? cnt[b * kWarps] : total;
  }
  __syncthreads();
  gather::place<kWarps>(tag, lo, hi, tmin, cnt, order);
  __syncthreads();

  // First list position of the slots with base column bmin + b (clamped).
  auto at = [&](int b) { return bstart[min(max(b, 0), nbins)]; };
  // One thread per column zlo .. zhi, in rounds of kThreads columns.
  const int ncols = zhi - zlo + 1;
  int staged_lo = 0, staged_hi = 0;  // the list window in `stage`
  for (int r0 = 0; r0 < ncols; r0 += kThreads) {
    const bool has = r0 + static_cast<int>(threadIdx.x) < ncols;
    const int c = zlo + min(r0 + static_cast<int>(threadIdx.x), ncols - 1);
    // This column's slots: base columns c - 2, c - 1, c (column taps 2, 1, 0).
    const int p0 = at(c - 2 - bmin), p1 = at(c - 1 - bmin), p2 = at(c - bmin);
    const int p3 = at(c + 1 - bmin);
    // The round's slots, from its first column's to its last's.
    const int need_lo = at(zlo + r0 - 2 - bmin);
    const int need_hi = at(zlo + min(r0 + kThreads, ncols) - bmin);
    float acc[kNT][kNch];
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) acc[t][ch] = 0.0f;
    }
    for (int sub = need_lo; sub < need_hi;) {
      if (sub < staged_lo || sub >= staged_hi) {
        __syncthreads();  // every column is done with the old window
        staged_lo = sub;
        staged_hi = min(total, sub + cap);
        gather::stage_window<kThreads, R::kVec>(
            staged_lo, staged_hi, stage, [&](int p, float* r) {
              make_rec<kNch, kApic, kFused>(row, K, order[p], fi, fluid, r);
            });
        __syncthreads();
      }
      const int end = min(need_hi, staged_hi);
      if (has) {
        for (int p = max(p0, sub); p < min(p1, end); ++p) {
          visit<kNch, kTent, kApic, 2>(stage + (p - staged_lo) * R::kVec, dx, acc);
        }
        for (int p = max(p1, sub); p < min(p2, end); ++p) {
          visit<kNch, kTent, kApic, 1>(stage + (p - staged_lo) * R::kVec, dx, acc);
        }
        for (int p = max(p2, sub); p < min(p3, end); ++p) {
          visit<kNch, kTent, kApic, 0>(stage + (p - staged_lo) * R::kVec, dx, acc);
        }
      }
      sub = end;
    }
    if (has) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
#pragma unroll
        for (int ch = 0; ch < kNch; ++ch) {
          orow[(static_cast<size_t>(t) * kNch + ch) * G + c] = acc[t][ch];
        }
      }
    }
  }
}

// The fold's five terms of halo node (s, j) at column c:
// term[t] = &expanded[s L + j - t, t, 0, c], in[t] whether j - t is a
// bucket row of shard s, wrote[t] whether its gather block wrote column c
// (ranges, per bucket row and band of `band` columns; a term it did not
// write is 0.0f, as the single-device gather writes it).
__device__ __forceinline__ void fold_terms(const float* expanded, const int2* ranges, int s,
                                           int j, int c, int L, int nch, int G, int band,
                                           const float* term[kNT], bool in[kNT],
                                           bool wrote[kNT]) {
  const int bands = (G + band - 1) / band, b = c / band;
  const size_t cs = static_cast<size_t>(nch) * G;  // one target row of a bucket row
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const int i = j - t;
    in[t] = i >= 0 && i < L;
    const int bucket = s * L + (in[t] ? i : 0);
    const int2 r = ranges[bucket * bands + b];
    term[t] = expanded + (static_cast<size_t>(bucket) * kNT + t) * cs + c;
    wrote[t] = in[t] && c >= r.x && c <= r.y;
  }
}

// out[s, j, ch, c] = the terms expanded[s L + j - t, t, ch, c] of the
// bucket rows 0 <= j - t < L of shard s, added from 0.0f for t = 0 .. 4:
// fold_rows_halo's order (ops/cuda/transfer2d.py).  One thread a column c
// of halo row (s, j) = blockIdx.x, for all nch channels: which of its five
// terms were written is worked out once, so the loop over channels is
// loads and adds only (neighbouring threads on neighbouring columns).
__global__ void __launch_bounds__(kThreads)
fold_halo_kernel(const float* __restrict__ expanded, const int2* __restrict__ ranges,
                 float* __restrict__ out, int L, int nch, int G, int band) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= G) return;
  const int sj = blockIdx.x;  // s (L + 4) + j
  const int s = sj / (L + kNT - 1), j = sj - s * (L + kNT - 1);
  const float* term[kNT];
  bool in[kNT], wrote[kNT];
  fold_terms(expanded, ranges, s, j, c, L, nch, G, band, term, in, wrote);
  const size_t cs = static_cast<size_t>(nch) * G;
  float* o = out + static_cast<size_t>(sj) * cs + c;
  for (int ch = 0; ch < nch; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      if (in[t]) acc = __fadd_rn(acc, wrote[t] ? term[t][ch * G] : 0.0f);
    }
    o[ch * G] = acc;
  }
}

// The node pass of target node (t0, c) from its folded sums r (the JAX
// kernel's, transfer2d.py:476-560) -> o = [v_new (2), v_old (2) (, Jbar, p,
// div)]: the absolute mass floor, v_old = pure / m, v_new = forced / m + dt
// g (or the diagonal penalty solve (forced + dt g m) / (m + dt beta pen)
// with pen 1 on the axis's wall band), the slip clamps or the sticky zero
// on the wall bands, the colliders' projection of v_new at node x = ((t0 -
// lo) dx, (c - lo) dx), and with kNch = 9 the nodal averages (Jbar 1, p
// and div 0 where no volume landed).  Rows outside [0, R) are all zeros.
// Each operation is rounded as the plain version's PyTorch op is (no FMA
// contraction), so the two differ only by the sums they start from.
template <int kNch>
__device__ __forceinline__ void finish_node2d(const float r[kNch], int t0, int c, int R,
                                              const Node2d& nd,
                                              const colliders::Colliders& cols, float o[]) {
  constexpr int kOut = kNch == 9 ? 7 : 4;
  if (t0 < 0 || t0 >= R) {
#pragma unroll
    for (int ch = 0; ch < kOut; ++ch) o[ch] = 0.0f;
    return;
  }
  const float m = r[4];
  const bool has = m > nd.floor_m;
  const float safe = has ? m : 1.0f;
  const bool lo0 = t0 <= nd.lo, hi0 = t0 >= nd.hi, lo1 = c <= nd.lo, hi1 = c >= nd.hi;
  float v[2];
  if (nd.wall == 2) {  // penalty: (m I + dt beta n(x)n) v = m v* + dt m g, diagonal
    const float pen0 = lo0 || hi0 ? 1.0f : 0.0f, pen1 = lo1 || hi1 ? 1.0f : 0.0f;
    v[0] = has ? __fdiv_rn(__fadd_rn(r[2], __fmul_rn(nd.dtg0, m)),
                           __fadd_rn(m, __fmul_rn(nd.dt_beta, pen0)))
               : 0.0f;
    v[1] = has ? __fdiv_rn(__fadd_rn(r[3], __fmul_rn(nd.dtg1, m)),
                           __fadd_rn(m, __fmul_rn(nd.dt_beta, pen1)))
               : 0.0f;
  } else {
    const float hasf = has ? 1.0f : 0.0f;
    v[0] = __fadd_rn(has ? __fdiv_rn(r[2], safe) : 0.0f, __fmul_rn(nd.dtg0, hasf));
    v[1] = __fadd_rn(has ? __fdiv_rn(r[3], safe) : 0.0f, __fmul_rn(nd.dtg1, hasf));
    if (nd.wall == 1) {  // sticky
      if (lo0 || hi0 || lo1 || hi1) v[0] = v[1] = 0.0f;
    } else {             // slip: clamp the outgoing normal component per band
      if (lo0) v[0] = fmaxf(v[0], 0.0f);
      if (hi0) v[0] = fminf(v[0], 0.0f);
      if (lo1) v[1] = fmaxf(v[1], 0.0f);
      if (hi1) v[1] = fminf(v[1], 0.0f);
    }
  }
  if (cols.n > 0) {  // after the walls (transfer2d.py:527-551)
    const float x[2] = {
        __fmul_rn(__fsub_rn(static_cast<float>(t0), static_cast<float>(nd.lo)), nd.dx),
        __fmul_rn(__fsub_rn(static_cast<float>(c), static_cast<float>(nd.lo)), nd.dx),
    };
    colliders::project<2>(cols, x, v);
  }
  o[0] = v[0];
  o[1] = v[1];
  o[2] = has ? __fdiv_rn(r[0], safe) : 0.0f;
  o[3] = has ? __fdiv_rn(r[1], safe) : 0.0f;
  if constexpr (kNch == 9) {
    // Nodal averages over the scattered volume, for the next substep.
    const float v0sum = r[6];
    const bool has_v = v0sum > 0.0f;
    const float safe_v = has_v ? v0sum : 1.0f;
    o[4] = has_v ? __fdiv_rn(r[5], safe_v) : 1.0f;
    o[5] = has_v ? __fdiv_rn(r[7], safe_v) : 0.0f;
    o[6] = has_v ? __fdiv_rn(r[8], safe_v) : 0.0f;
  }
}

// p2g_grid's non-raw mode on one device: the fold of fold_halo_kernel
// (halo row j = target row j - 1 of the R = L bucket rows), then the node
// pass, into the g2p-ready (R + 4, 4 or 7, G) grid.  One thread a node,
// its kNch folded sums in registers.
template <int kNch>
__global__ void __launch_bounds__(kThreads)
fold_finish_kernel(const float* __restrict__ expanded, const int2* __restrict__ ranges,
                   float* __restrict__ out, int L, int G, int band, Node2d nd,
                   const __grid_constant__ colliders::Colliders cols) {
  constexpr int kOut = kNch == 9 ? 7 : 4;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= G) return;
  const int j = blockIdx.x;
  const float* term[kNT];
  bool in[kNT], wrote[kNT];
  fold_terms(expanded, ranges, 0, j, c, L, kNch, G, band, term, in, wrote);
  float r[kNch];
#pragma unroll
  for (int ch = 0; ch < kNch; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      if (in[t]) acc = __fadd_rn(acc, wrote[t] ? term[t][ch * G] : 0.0f);
    }
    r[ch] = acc;
  }
  float o[kOut];
  finish_node2d<kNch>(r, j - 1, c, L, nd, cols, o);
  float* at = out + static_cast<size_t>(j) * kOut * G + c;
#pragma unroll
  for (int ch = 0; ch < kOut; ++ch) at[ch * G] = o[ch];
}

template <int kNch, bool kTent, bool kApic, bool kFused>
int launch(const float* data, const int* counts, float* out, int* ranges, int R, int L, int K,
           int G, int band, int cap, float dx, const Fluid2d& fluid, cudaStream_t stream) {
  using Rc = Rec2d<kNch, kApic>;
  const size_t smem = sizeof(float4) * Rc::kVec * static_cast<size_t>(cap) +
                      sizeof(int) * ((band + 2) * static_cast<size_t>(kWarps) + band + 3 + K) +
                      sizeof(short) * ((K + 1) / 2 * 2);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(p2g_kernel<kNch, kTent, kApic, kFused>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(R, (G + band - 1) / band);
  p2g_kernel<kNch, kTent, kApic, kFused><<<blocks, kThreads, smem, stream>>>(
      data, counts, out, ranges, L, K, G, band, cap, dx, fluid);
  return static_cast<int>(cudaGetLastError());
}

// The gather in every mode: nch 5 (fused: B-spline only) or 6 / 9
// (prepped); apic, tent 0/1; ranges as p2g_kernel's (null: every column).
int launch_mode(const float* data, const int* counts, float* out, int* ranges, int R, int L,
                int K, int G, int nch, int fused, int apic, int tent, int band, int cap,
                float dx, const Fluid2d& f, cudaStream_t s) {
#define MPM_P2G_LAUNCH(NCH, TENT, FUSED)                                                       \
  (apic ? launch<NCH, TENT, true, FUSED>(data, counts, out, ranges, R, L, K, G, band, cap, dx, \
                                         f, s)                                                 \
        : launch<NCH, TENT, false, FUSED>(data, counts, out, ranges, R, L, K, G, band, cap, dx, \
                                          f, s))
  if (fused) return MPM_P2G_LAUNCH(5, false, true);
  if (nch == 6) return tent ? MPM_P2G_LAUNCH(6, true, false) : MPM_P2G_LAUNCH(6, false, false);
  return tent ? MPM_P2G_LAUNCH(9, true, false) : MPM_P2G_LAUNCH(9, false, false);
#undef MPM_P2G_LAUNCH
}

// cudaErrorInvalidValue for an nch / mode the kernel has no form of or a
// plan out of range, else 0.
int check_args(int K, int nch, int fused, int tent, int band, int cap) {
  const bool mode = fused ? nch == 5 && !tent : nch == 6 || nch == 9;
  const bool plan = K >= 0 && band > 0 && cap > 0;
  return mode && plan ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// nch: 6 or 9; apic, tent: 0/1; band, cap: the plan (transfer2d.py's
// plan_p2g: columns a block owns, slots staged at a time).  Returns a
// cudaError_t as int (0 on success): cudaErrorInvalidValue for another
// nch, a plan out of range or one whose shared memory exceeds the card's
// opt-in limit, else the attribute call's or the launch's error.
extern "C" int mpm_p2g(const float* pdata, const int* counts, float* out, int R, int K, int G,
                       int nch, float dx, int apic, int tent, int band, int cap,
                       void* stream) {
  if (const int bad = check_args(K, nch, 0, tent, band, cap)) return bad;
  if (R <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  return launch_mode(pdata, counts, out, nullptr, R, R, K, G, nch, 0, apic, tent, band, cap, dx,
                     Fluid2d{}, static_cast<cudaStream_t>(stream));
}

// The fused-stress form: sdata (R, 11, K), 5 channels, B-spline taps; apic,
// tait: 0/1; the fluid constants kb, kb / gamma, gamma, 2 mu, mu and fa;
// band, cap: the plan (transfer2d.py's plan_p2g_fused).  Returns a
// cudaError_t as int, as mpm_p2g.
extern "C" int mpm_p2g_fused(const float* sdata, const int* counts, float* out, int R, int K,
                             int G, float dx, int apic, int tait, float kb, float kb_over_gamma,
                             float gamma, float two_mu, float mu, float fa, int band, int cap,
                             void* stream) {
  if (const int bad = check_args(K, 5, 1, 0, band, cap)) return bad;
  if (R <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  const Fluid2d fluid = {tait, kb, kb_over_gamma, gamma, two_mu, mu, fa};
  return launch_mode(sdata, counts, out, nullptr, R, R, K, G, 5, 1, apic, 0, band, cap, dx,
                     fluid, static_cast<cudaStream_t>(stream));
}

// p2g_grid: n shards of L bucket rows (gx0 local to each shard); nch 5
// (fused, B-spline only), 6 or 9 (prepped); fused, apic, tent: 0/1; the
// fluid constants are read in the fused mode only; band, cap: the plan
// (transfer2d.py's plan_p2g).  expanded, ranges: the caller's scratch for
// the gather's sums, (n L, 5, nch, G) f32, and the columns each of its
// blocks wrote, (n L, bands, 2) i32.  raw 1: out (n, L + 4, nch, G), the
// raw halo sums.  raw 0 (one device, n = 1): out (L + 4, 4 or 7, G), the
// finished grid, from the node constants dtg0, dtg1 (f32 of dt g), floor_m,
// lo, hi, wall (0 slip, 1 sticky, 2 penalty), dt_beta and the colliders
// (col_f, col_i: host arrays of ncol, as colliders::unpack reads them; kin
// 1 puts the moving ones at time tcol).  Two launches on the stream, the
// gather and the fold (with the node pass when not raw).  Returns a
// cudaError_t as int, as mpm_p2g.
extern "C" int mpm_p2g_grid(const float* data, const int* counts, float* expanded, int* ranges,
                            float* out, int n, int L, int K, int G, int nch, int fused, int tent,
                            float dx, int apic, int tait, float kb, float kb_over_gamma,
                            float gamma, float two_mu, float mu, float fa, int band, int cap,
                            int raw, float dtg0, float dtg1, float floor_m, int lo, int hi,
                            int wall, float dt_beta, const float* col_f, const int* col_i,
                            int ncol, int kin, float tcol, void* stream) {
  if (const int bad = check_args(K, nch, fused, tent, band, cap)) return bad;
  colliders::Colliders cols{};
  if ((!raw && (n != 1 || wall < 0 || wall > 2)) || (raw && ncol != 0) ||
      !colliders::unpack(col_f, col_i, ncol, kin, tcol, &cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || L <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  const Fluid2d fluid = {tait, kb, kb_over_gamma, gamma, two_mu, mu, fa};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_mode(data, counts, expanded, ranges, n * L, L, K, G, nch, fused, apic,
                              tent, band, cap, dx, fluid, s);
  if (err != 0) return err;
  const dim3 blocks(n * (L + kNT - 1), (G + kThreads - 1) / kThreads);
  const int2* rg = reinterpret_cast<const int2*>(ranges);
  if (raw) {
    fold_halo_kernel<<<blocks, kThreads, 0, s>>>(expanded, rg, out, L, nch, G, band);
  } else {
    const Node2d nd = {dtg0, dtg1, floor_m, lo, hi, wall, dt_beta, dx};
    if (nch == 5) {
      fold_finish_kernel<5><<<blocks, kThreads, 0, s>>>(expanded, rg, out, L, G, band, nd, cols);
    } else if (nch == 6) {
      fold_finish_kernel<6><<<blocks, kThreads, 0, s>>>(expanded, rg, out, L, G, band, nd, cols);
    } else {
      fold_finish_kernel<9><<<blocks, kThreads, 0, s>>>(expanded, rg, out, L, G, band, nd, cols);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
