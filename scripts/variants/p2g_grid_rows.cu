// A variant of the port's `p2g_grid` (TPU kernel #4, raw mode) kept for
// measurement only: scripts/p2g_variants.py builds it beside the committed
// kernels and times it against csrc/p2g.cu's two-pass p2g_grid (gather,
// then fold).  Nothing in the package calls it.
//
// Design (a fixed-order gather on csrc/taps.cuh's namespace gather): one
// block of 256 threads per (tile of kTile halo rows, column band, shard).
// Thread c owns band column c0 + c and keeps its tile's kTile x kNch sums
// in registers.  The block visits the source bucket rows of its tile in
// descending order, i = j0 + kTile - 1 down to j0 - 4 (those in the
// shard), and for each one walks the row's positions, tags the slots in
// the row margin whose row taps land on the tile and whose columns meet
// the band, sorts them by base column (stable in slot order), stages
// their records (the fused stress at staging time) and lets each column
// thread sum that row's slots in list order into a partial per tile row,
// which it then adds to the row's running total: fold_rows_halo's order.
// Each block writes its (kTile, kNch, band) sums once, zeros included.
// Entry: mpm_p2g_grid_rows, mpm_p2g_grid's arguments without the
// expanded scratch.

#include <climits>

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

// The records and tap sums: csrc/p2g.cu's, with the sums' rows as a
// runtime tag in [kLo, kHi] of kT rows.  Not bitwise equal to p2g.cu on
// the card (1-ulp differences; the sums' order is the same).

// Fluid constants of the fused-stress scatter (transfer2d.py:376-401).
struct Fluid2d {
  int tait;
  float kb, kb_over_gamma, gamma, two_mu, mu, fa;
};

// A slot's staged record, in float4s: [row tag (int bits), gx0 - base0,
// gx1 - base1, m v (2), P (4, APIC only), Q (4), plain (kNch - 4)].
// Channels [m v0, m v1, m v0 + f0, m v1 + f1, *plain]; plain = [m] (the
// fused record, kNch 5), [m, V] (6) or [m, V0 J, V0, V0 p, V0 div] (9).
template <int kNch, bool kApic>
struct Rec2d {
  static constexpr int kQ = 5 + (kApic ? 4 : 0);
  static constexpr int kPlain = kQ + 4;
  static constexpr int kVec = (kPlain + kNch - 4 + 3) / 4;
};

// Fills r[1 ..] of slot k's record from the bucket row at `row` (stride
// K) and returns its base row floor(gx0 - 0.5); the caller sets r[0].
// Prepped (kFused false): pdata rows [gx0, gx1, m v0, m v1, P (4), Q (4),
// *plain], every value row pre-masked; PIC ignores P.  Fused: sdata rows
// [gx0, gx1, v0, v1, C00, C01, C10, C11, J, mass, vol0]; the
// weakly-compressible fluid stress (linear or Tait EOS plus viscosity),
// Q = P + fa tau with P = m C (APIC) or Q = fa tau (PIC), and plain = [m].
template <int kNch, bool kApic, bool kFused>
__device__ __forceinline__ float make_rec2d(const float* row, int K, int k, const Fluid2d& f,
                                            float r[4 * Rec2d<kNch, kApic>::kVec]) {
  using R = Rec2d<kNch, kApic>;
  const float gx0 = row[k], gx1 = row[K + k];
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
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
    r[3] = mass * v0;
    r[4] = mass * v1;
    float* q = r + R::kQ;
    if constexpr (kApic) {
      r[5] = mass * c00;
      r[6] = mass * c01;
      r[7] = mass * c10;
      r[8] = mass * c11;
      q[0] = r[5] + f.fa * t00;
      q[1] = r[6] + f.fa * t01;
      q[2] = r[7] + f.fa * t01;
      q[3] = r[8] + f.fa * t11;
    } else {
      q[0] = f.fa * t00;
      q[1] = f.fa * t01;
      q[2] = f.fa * t01;
      q[3] = f.fa * t11;
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
  return base0;
}

// Adds row tap kJ of a record (row weight w0[kJ] wc, offset rdp = (kJ -
// (gx0 - base0)) dx) to one node's kNch sums a; u holds the column parts
// m v_a + A_a1 cd (A = P for channels 0-1 under APIC, Q for 2-3).
template <int kNch, bool kApic, int kJ>
__device__ __forceinline__ void add_row2d(const float* r, const float w0[3], float wc,
                                          const float u[4], float dx, float a[kNch]) {
  using R = Rec2d<kNch, kApic>;
  const float* q = r + R::kQ;
  const float w = w0[kJ] * wc;
  const float rdp = (static_cast<float>(kJ) - r[1]) * dx;
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

// The row taps of a record whose row tap 0 lands on sums row kQ0 of
// acc[kT]; taps on rows outside [0, kT) are dropped.
template <int kNch, bool kApic, int kT, int kQ0>
__device__ __forceinline__ void add_rows2d(const float* r, const float w0[3], float wc,
                                           const float u[4], float dx, float acc[kT][kNch]) {
  if constexpr (kQ0 >= 0 && kQ0 < kT) add_row2d<kNch, kApic, 0>(r, w0, wc, u, dx, acc[kQ0]);
  if constexpr (kQ0 + 1 >= 0 && kQ0 + 1 < kT) {
    add_row2d<kNch, kApic, 1>(r, w0, wc, u, dx, acc[kQ0 + 1]);
  }
  if constexpr (kQ0 + 2 >= 0 && kQ0 + 2 < kT) {
    add_row2d<kNch, kApic, 2>(r, w0, wc, u, dx, acc[kQ0 + 2]);
  }
}

// add_rows2d for the runtime row q0 in [kQ, kHi] (kHi taken for any q0
// past the others).
template <int kNch, bool kApic, int kT, int kQ, int kHi>
__device__ __forceinline__ void add_rows_at2d(int q0, const float* r, const float w0[3],
                                              float wc, const float u[4], float dx,
                                              float acc[kT][kNch]) {
  if constexpr (kQ == kHi) {
    add_rows2d<kNch, kApic, kT, kQ>(r, w0, wc, u, dx, acc);
  } else {
    if (q0 == kQ) {
      add_rows2d<kNch, kApic, kT, kQ>(r, w0, wc, u, dx, acc);
    } else {
      add_rows_at2d<kNch, kApic, kT, kQ + 1, kHi>(q0, r, w0, wc, u, dx, acc);
    }
  }
}

// Adds a staged record's taps with column tap kJc (column base1 + kJc) to
// one column's sums acc[kT][kNch]: its row tap 0 lands on row q0 = the
// record's tag, in [kLo, kHi].
template <int kNch, bool kTent, bool kApic, int kJc, int kT, int kLo, int kHi>
__device__ __forceinline__ void visit2d(const float4* rec, float dx, float acc[kT][kNch]) {
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
  add_rows_at2d<kNch, kApic, kT, kLo, kHi>(__float_as_int(r[0]), r, w0, wc, u, dx, acc);
}

// A compile-time int as a value (sum_columns' column tap).
template <int N>
struct Int {
  static constexpr int value = N;
};

// The 2D sums: this thread's column c (when `has`) visits the listed
// slots of base columns c - 2, c - 1 and c (column taps 2, 1, 0) in list
// order, visit(Int<kJc>(), record), with bstart from sort_list (bins from
// base column bmin).  The whole list is staged `cap` records at a time
// (make(p, r) fills list entry p's record), so every thread of the block
// calls it.  Ends with the block synchronised only when the list needs
// more than one window: the caller synchronises before `stage` is written
// again.
template <int kThreads, int kVec, typename Make, typename Visit>
__device__ __forceinline__ void sum_columns(int c, bool has, int bmin, int nbins,
                                            const int* bstart, int cap, float4* stage, Make make,
                                            Visit visit) {
  auto at = [&](int b) { return bstart[min(max(b, 0), nbins)]; };
  const int total = bstart[nbins];
  const int p0 = at(c - 2 - bmin), p1 = at(c - 1 - bmin), p2 = at(c - bmin);
  const int p3 = at(c + 1 - bmin);
  for (int sub = 0; sub < total; sub += cap) {
    const int end = min(total, sub + cap);
    if (sub > 0) __syncthreads();  // every column is done with the last window
    gather::stage_window<kThreads, kVec>(sub, end, stage, make);
    __syncthreads();
    if (has) {
      for (int p = max(p0, sub); p < min(p1, end); ++p) visit(Int<2>(), stage + (p - sub) * kVec);
      for (int p = max(p1, sub); p < min(p2, end); ++p) visit(Int<1>(), stage + (p - sub) * kVec);
      for (int p = max(p2, sub); p < min(p3, end); ++p) visit(Int<0>(), stage + (p - sub) * kVec);
    }
  }
}

// Walks 2 and 3 after tag_range, for nbins > 0 bins from tag tmin: fills
// bstart[b] (b <= nbins) with the first list position of bin b (bstart[nbins]
// = the kept slots) and order[] with the list; returns the kept slots.  cnt:
// nbins x kWarps ints, tmp: kWarps ints.  Ends with the block synchronised.
template <int kThreads>
__device__ __forceinline__ int sort_list(const short* tag, int lo, int hi, int tmin, int nbins,
                                         int* cnt, int* bstart, int* order, int* tmp) {
  constexpr int kWarps = kThreads / 32;
  for (int e = threadIdx.x; e < nbins * kWarps; e += kThreads) cnt[e] = 0;
  __syncthreads();
  gather::count_bins<kWarps>(tag, lo, hi, tmin, cnt);
  const int total = gather::exclusive_scan<kThreads>(cnt, nbins * kWarps, tmp);
  for (int b = threadIdx.x; b <= nbins; b += kThreads) {
    bstart[b] = b < nbins ? cnt[b * kWarps] : total;
  }
  __syncthreads();
  gather::place<kWarps>(tag, lo, hi, tmin, cnt, order);
  __syncthreads();
  return total;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1;       // halo rows a block owns
// Blocks resident on an SM: the register cap of __launch_bounds__; the
// script plans its shared memory with transfer2d.plan_p2g, whose
// budget (P2G_BLOCKS_PER_SM) is the same.
constexpr int kBlocksPerSM = 3;

template <int kNch, bool kTent, bool kApic, bool kFused>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p2g_grid_kernel(const float* __restrict__ data, const int* __restrict__ counts,
                float* __restrict__ out, int L, int K, int G, int band, int cap, float dx,
                Fluid2d fluid) {
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

  const int j0 = blockIdx.x * kTile;   // first halo row: local target row j0 - 1
  const int c0 = blockIdx.y * band;
  const int bw = min(band, G - c0);
  const long long shard = blockIdx.z;
  const bool has = static_cast<int>(threadIdx.x) < bw;
  const int c = c0 + static_cast<int>(threadIdx.x);
  const float blo = static_cast<float>(c0 - 2), bhi = static_cast<float>(c0 + bw - 1);
  // Row tap 0 of a slot with base row b lands on halo row b + 1, tile row
  // b + 1 - j0; its taps reach the tile when that is in [-2, kTile - 1].
  const float rlo = static_cast<float>(j0 - 3), rhi = static_cast<float>(j0 + kTile - 2);
  float tot[kTile][kNch];
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) tot[q][ch] = 0.0f;
  }

  for (int i = min(L - 1, j0 + kTile - 1); i >= max(0, j0 - 4); --i) {
    __syncthreads();  // the last row's readers are done with range, the list and the window
    const long long bucket = shard * L + i;
    const int count = max(min(counts[bucket], K), 0);
    if (count == 0) continue;
    const float* row = data + bucket * kFields * K;
    const float fi = static_cast<float>(i);
    // Base column of slot k when it is in the row margin, its row taps
    // reach the tile and its columns base1 .. base1 + 2 meet the band.
    auto classify = [&](int k) {
      const float gx0 = row[k], gx1 = row[K + k];
      const float base0 = floorf(gx0 - 0.5f);
      const float rel = base0 - fi;
      const float base1 = floorf(gx1 - 0.5f);
      const bool keep = rel >= -1.0f && rel <= 1.0f && base0 >= rlo && base0 <= rhi &&
                        base1 >= blo && base1 <= bhi;
      return keep ? static_cast<int>(base1) : gather::kNone;
    };
    int lo, hi;
    gather::warp_range<kThreads>(count, lo, hi);
    gather::tag_range(classify, lo, hi, c0 - 2, tag, range);
    const int bmin = range[0], bmax = range[1];
    if (bmax < bmin) continue;
    const int nbins = bmax - bmin + 1;
    sort_list<kThreads>(tag, lo, hi, bmin - (c0 - 2), nbins, cnt, bstart, order, tmp);

    float part[kTile][kNch];
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) part[q][ch] = 0.0f;
    }
    sum_columns<kThreads, R::kVec>(
        c, has, bmin, nbins, bstart, cap, stage,
        [&](int p, float* r) {
          const float base0 = make_rec2d<kNch, kApic, kFused>(row, K, order[p], fluid, r);
          r[0] = __int_as_float(static_cast<int>(base0) + 1 - j0);  // tile row of row tap 0
        },
        [&](auto jc, const float4* rec) {
          visit2d<kNch, kTent, kApic, decltype(jc)::value, kTile, -2, kTile - 1>(
              rec, dx, part);
        });
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) tot[q][ch] += part[q][ch];
    }
  }

  if (!has) return;
  float* o = out + ((shard * (L + 4) + j0) * kNch) * G + c;
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (j0 + q >= L + 4) break;
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) o[(static_cast<long long>(q) * kNch + ch) * G] = tot[q][ch];
  }
}

template <int kNch, bool kTent, bool kApic, bool kFused>
int launch(const float* data, const int* counts, float* out, int n, int L, int K, int G,
           int band, int cap, float dx, const Fluid2d& fluid, cudaStream_t stream) {
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
  err = cudaFuncSetAttribute(p2g_grid_kernel<kNch, kTent, kApic, kFused>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((L + 4 + kTile - 1) / kTile, (G + band - 1) / band, n);
  p2g_grid_kernel<kNch, kTent, kApic, kFused><<<blocks, kThreads, smem, stream>>>(
      data, counts, out, L, K, G, band, cap, dx, fluid);
  return static_cast<int>(cudaGetLastError());
}

template <int kNch, bool kFused>
int launch_mode(const float* data, const int* counts, float* out, int n, int L, int K, int G,
                int band, int cap, float dx, int apic, int tent, const Fluid2d& fluid,
                cudaStream_t s) {
  if constexpr (!kFused) {
    if (tent) {
      return apic ? launch<kNch, true, true, false>(data, counts, out, n, L, K, G, band, cap,
                                                    dx, fluid, s)
                  : launch<kNch, true, false, false>(data, counts, out, n, L, K, G, band, cap,
                                                     dx, fluid, s);
    }
  }
  return apic ? launch<kNch, false, true, kFused>(data, counts, out, n, L, K, G, band, cap, dx,
                                                  fluid, s)
              : launch<kNch, false, false, kFused>(data, counts, out, n, L, K, G, band, cap, dx,
                                                   fluid, s);
}

}  // namespace

// n shards of L bucket rows; nch: 5 (fused, B-spline only), 6 or 9
// (prepped); fused, apic, tent: 0/1; the fluid constants are read in the
// fused mode only; band, cap: the plan (transfer2d.py's plan_p2g:
// columns a block owns, slots staged at a time).  Returns a cudaError_t as
// int (0 on success): cudaErrorInvalidValue for an nch / mode the kernel
// has no form of, a plan out of range or one whose shared memory exceeds
// the card's opt-in limit, else the attribute call's or the launch's
// error.
extern "C" int mpm_p2g_grid_rows(const float* data, const int* counts, float* out, int n, int L,
                            int K, int G, int nch, int fused, int tent, float dx, int apic,
                            int tait, float kb, float kb_over_gamma, float gamma,
                            float two_mu, float mu, float fa, int band, int cap, void* stream) {
  if (fused ? (nch != 5 || tent) : (nch != 6 && nch != 9)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || L <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  if (K < 0 || band <= 0 || band > kThreads || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Fluid2d fluid = {tait, kb, kb_over_gamma, gamma, two_mu, mu, fa};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    return launch_mode<5, true>(data, counts, out, n, L, K, G, band, cap, dx, apic, 0, fluid, s);
  }
  return nch == 6
             ? launch_mode<6, false>(data, counts, out, n, L, K, G, band, cap, dx, apic, tent,
                                     fluid, s)
             : launch_mode<9, false>(data, counts, out, n, L, K, G, band, cap, dx, apic, tent,
                                     fluid, s);
}
