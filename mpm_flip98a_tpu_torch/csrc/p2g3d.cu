// Expanded 3D P2G of prepped fields over pencil-bucketed particles, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `p2g3d` in
// mpm_flip98a_tpu/ops/pallas/transfer3d.py (def :349, pallas_call :408,
// body _p2g3d_kernel :118 -> _p2g3d_chunk :193) in both modes: prepped
// (stress=None: PIC or APIC, 7 or 11 channels, B-spline or tent taps) and
// stress (the fluid stress made from the 18 state planes when a slot's
// fields are loaded, as p2g3d_grid.cu's stress mode does: linear or Tait
// EOS, PIC or APIC, 7 channels, B-spline), each with or without halo1.
// The TPU kernel scatters along z with one-hot MXU products, one program
// per batch of 8 source pencils, accumulating into an output block that
// stays in VMEM across the sequential axis-1 grid steps; GPU blocks run in
// no order, so here the block is turned round: it owns one target and
// gathers from the sources.
//
// Contract (same as the TPU kernel):
//   planes  the prepped fields in the fixed order of taps.cuh: gx (3),
//           m v (3), P (9, APIC only), Q (9), m, and with kNch = 11
//           [V0 J, V0, V0 p, V0 div]; each (R0, R1, K) f32 with its own
//           pencil stride, value planes pre-masked (zeros in dead slots);
//           or the stress mode's [gx (3), v (3), C00..C22, J, mass, vol0]
//           (dead slots neutral: mass = vol0 = 0)
//   counts  (R0 * R1,) i32 packed pencil counts (active slots first)
//   out     (R0, 5, G1, kNch, G2) f32: out[i0, t0, row] is bucket row i0's
//           share of target rows (i0 + t0 - 1, row); channels [m v pure
//           (3), m v forced (3), m (, V0 J, V0, V0 p, V0 div)].  halo1
//           (transfer3d.py:366-372): (R0, 5, G1 + 4, kNch, G2), plane row
//           q is target row q - 1, so the axis-1 taps on rows -1 and G1 ..
//           G1 + 2 (a shard window's halo) are kept, not dropped.
// Forced momentum gets w (m v_a + Q_a0 rdp0 + Q_a1 rdp1 + Q_a2 (c - gx2)
// dx); pure momentum the same with P under APIC and w m v_a under PIC.  A
// slot contributes only when its base row on both bucketed axes is within
// +-1 of its pencil's; slots at or past min(count, K) are skipped; taps
// whose axis-1 row is outside [0, G1) (without halo1) or whose z column is
// outside [0, G2) are dropped.
//
// Design: a fixed-order gather (taps.cuh, namespace gather), no float
// atomics.  One block of 256 threads per (i0, target axis-1 row, z band)
// (halo1: the G1 + 4 rows -1 .. G1 + 2, the edge rows pulling from the
// source pencils that exist);
// the host's planner (ops/cuda/transfer3d.py, plan_p2g3d) picks the band
// (all of G2 up to 512 columns) and the staging window `cap`.  The block
// owns out[i0, :, row, :, band] outright.
//   Walk: the slots of its five source pencils i1 = row + 1 - t1 (t1 = 0 ..
//   4) form one sequence, each warp a contiguous range of it.  When the
//   sequence fits kSteps steps a warp (640 slots at the 8M slab), every
//   thread loads its slots' fields into registers at once; then the block
//   writes its whole output as zeros (streaming float4 stores that drain
//   while it works; the columns with sums are written again at the end),
//   and tags in shared memory, by base z column, the slots whose axis-1
//   tap j1 = t1 - 1 - rel1 lands on `row`, inside the axis-0 margin, with
//   z columns meeting the band.
//   Sort: two walks of the tags (a counting sort per (bin, warp)) give each
//   kept slot its list position, by base z column and, within a column, in
//   (source pencil, slot) order.  Each thread writes its kept slots'
//   records straight from its registers to their positions in shared
//   memory.  A record holds what the slot's one axis-1 tap on the row
//   leaves: [t0, gx0 - base0, gx2 - base2, w1, the affine terms with that
//   tap's offset folded in (rec3d::Rec, taps.cuh)].
//   Sums: kSplit = 4 threads per z column that the slots reach (a thin
//   layer reaches some 34): thread s sums the column's slots at list
//   positions p0 + s, p0 + s + 4, ... (base columns c - 2 .. c) into the
//   column's five axis-0 targets' kNch channels in registers, reading each
//   record once for all three of the slot's targets; a fixed butterfly
//   adds the four shares, and the column's threads write its 5 kNch sums.
//   Longer sequences, or more kept slots than `cap`, take the windowed
//   path: the walk reads the positions alone, the list holds sequence
//   indices, and the records are staged from device memory `cap` at a time.
//   The order of every sum is the list's, whatever order the threads ran
//   in: the result is bitwise reproducible.
//
// What bounds it on the H100: the (R0, 5, G1, kNch, G2) output, written
// once (3.7 GB at 256^3 with 11 channels, most of it zeros where the
// particles fill a thin layer: 1.12 ms at 3.3 TB/s), then the latency of
// each block's walk and sort (each pencil is walked by the five rows it
// reaches) at two blocks an SM, and the butterfly and sums.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

using rec3d::kNT;              // candidate target rows per bucketed axis
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks resident on an SM: the register cap of __launch_bounds__ (128:
// a thread holds 5 kNch sums) and the shared-memory budget of the host's
// planner (transfer3d.py's P2G3D_BLOCKS_PER_SM) follow it.
constexpr int kBlocksPerSM = 2;
// Threads a z column: thread s sums the column's slots at list positions
// p0 + s, p0 + s + kSplit, ...; the kSplit partial sums are then added in
// a fixed butterfly.  kCols columns a round.
constexpr int kSplit = 4;
constexpr int kCols = kThreads / kSplit;
// Walk steps a warp whose slots' fields a thread keeps in registers (the
// five pencils of the 8M slab hold some 640 slots: 3 steps of 256).
constexpr int kSteps = 3;

// Base z column base2 of a slot of source t1 (pencil row fi1) with fields
// f when it is in the margin on both axes, its axis-1 tap lands on the
// block's row and base2 is in [blo, bhi] (its columns meet the band).
__device__ __forceinline__ int classify(const float* f, int t1, float fi0, float fi1, float blo,
                                        float bhi) {
  const float rel0 = floorf(f[0] - 0.5f) - fi0;
  const float rel1 = floorf(f[1] - 0.5f) - fi1;
  const float base2 = floorf(f[2] - 0.5f);
  const int j1 = t1 - 1 - static_cast<int>(fminf(fmaxf(rel1, -2.0f), 2.0f));
  const bool keep = rel1 >= -1.0f && rel1 <= 1.0f && j1 >= 0 && j1 <= 2 && rel0 >= -1.0f &&
                    rel0 <= 1.0f && base2 >= blo && base2 <= bhi;
  return keep ? static_cast<int>(base2) : gather::kNone;
}

// The staged record of a kept slot of source t1 (pencil rows i0, i1):
// its first target t0 = rel0 + 1 and its axis-1 tap on the block's row.
template <int kNch, bool kTent, bool kApic>
__device__ __forceinline__ void rec_from_source(const float* f, int t1, int i0, int i1,
                                                float dx,
                                                float r[4 * rec3d::Rec<kNch, kApic>::kVec]) {
  const float base0 = floorf(f[0] - 0.5f), base1 = floorf(f[1] - 0.5f);
  const int t0 = static_cast<int>(base0 - static_cast<float>(i0)) + 1;
  const int j1 = t1 - 1 - static_cast<int>(base1 - static_cast<float>(i1));
  rec3d::rec_from<kNch, kTent, kApic>(f, t0, j1, dx, r);
}

template <int kNch, bool kTent, bool kApic, bool kStress>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p2g3d_kernel(taps::Prepped in, const int* __restrict__ counts, float* __restrict__ out,
             int R1, int K, int G1out, int row_off, int G2, int band, int cap, float dx,
             taps::Fluid fl) {
  using R = rec3d::Rec<kNch, kApic>;
  extern __shared__ float4 smem[];
  float4* stage = smem;                                              // [cap][kVec]
  int* cnt = reinterpret_cast<int*>(stage + static_cast<size_t>(cap) * R::kVec);
  int* bstart = cnt + (band + 2) * kWarps;                           // [band + 3]
  int* order = bstart + band + 3;                                    // [5 K]
  short* tag = reinterpret_cast<short*>(order + kNT * K);            // [5 K]
  __shared__ int range[2];
  __shared__ int tmp[kWarps];
  __shared__ int pre[kNT + 1];  // the source pencils' live slots, running sum

  // Output plane row q holds target axis-1 row q + row_off.
  const int i0 = blockIdx.x / G1out;
  const int q = blockIdx.x - i0 * G1out;
  const int row = q + row_off;
  const int zb = blockIdx.y * band;
  const int bw = min(band, G2 - zb);
  if (threadIdx.x < kNT) {
    // Source pencil i1 puts its axis-1 tap t1 - 1 - rel1 on row i1 + t1 - 1.
    const int i1 = row + 1 - static_cast<int>(threadIdx.x);
    const int n = (i1 >= 0 && i1 < R1) ? counts[static_cast<long long>(i0) * R1 + i1] : 0;
    pre[threadIdx.x + 1] = max(min(n, K), 0);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    pre[0] = 0;
    for (int t1 = 0; t1 < kNT; ++t1) pre[t1 + 1] += pre[t1];
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  const int nsrc = pre[kNT];
  const float fi0 = static_cast<float>(i0);
  const float blo = static_cast<float>(zb - 2), bhi = static_cast<float>(zb + bw - 1);
  // Sequence slot v -> source t1 and slot k.
  auto locate = [&](int v, int& t1, int& k) {
    t1 = 0;
    while (t1 < kNT - 1 && v >= pre[t1 + 1]) ++t1;
    k = v - pre[t1];
  };
  auto pencil_of = [&](int t1) { return static_cast<long long>(i0) * R1 + row + 1 - t1; };
  const long long ts = static_cast<long long>(G1out) * kNch * G2;  // between axis-0 targets
  float* obase = out + (static_cast<long long>(i0) * kNT * G1out + q) * kNch * G2;
  int lo, hi;
  gather::warp_range<kThreads>(nsrc, lo, hi);
  const int lane = threadIdx.x & 31;
  // With at most kSteps steps a warp, each thread keeps its slots' fields
  // in registers from the walk to the placement, and the records go
  // straight to their list positions; else the walk reads the positions
  // alone and the records are staged from device memory window by window.
  const bool in_regs = nsrc <= kSteps * kThreads;
  using F = rec3d::Fields<kNch, kApic>;
  float f[kSteps][F::kN];
  if (in_regs) {
    // Every load of the walk goes out first, then the block's whole output
    // as zeros (the columns with sums are written again at the end), then
    // the tags.
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      int t1 = 0, k = 0;
      if (lo < hi) locate(min(lo + 32 * j + lane, hi - 1), t1, k);
      if (lo < hi) rec3d::load_fields<kNch, kApic, kStress>(in, pencil_of(t1), k, fl, f[j]);
    }
    gather::zero_outside<kNT, kThreads>(obase, ts, G2, kNch, zb, bw, zb + bw, zb + bw);
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int v = lo + 32 * j + lane;
      if (v >= hi) continue;
      int t1, k;
      locate(v, t1, k);
      const int b = classify(f[j], t1, fi0, static_cast<float>(row + 1 - t1), blo, bhi);
      tag[v] = static_cast<short>(b == gather::kNone ? -1 : b - (zb - 2));
      if (b != gather::kNone) {
        mn = min(mn, b);
        mx = max(mx, b);
      }
    }
    gather::reduce_range(mn, mx, range);
  } else {
    gather::zero_outside<kNT, kThreads>(obase, ts, G2, kNch, zb, bw, zb + bw, zb + bw);
    auto classify_v = [&](int v) {
      int t1, k;
      locate(v, t1, k);
      float g[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) g[e] = in.at(taps::kGx + e, pencil_of(t1), k);
      return classify(g, t1, fi0, static_cast<float>(row + 1 - t1), blo, bhi);
    };
    gather::tag_range(classify_v, lo, hi, zb - 2, tag, range);
  }
  const int bmin = range[0], bmax = range[1];
  const int nbins = bmax >= bmin ? bmax - bmin + 1 : 0;
  // z columns with sums: those the kept slots reach, inside the band.
  const int zlo = nbins ? max(zb, bmin) : zb;
  const int zhi = nbins ? min(zb + bw - 1, bmax + 2) : zb - 1;
  if (nbins == 0) return;

  for (int e = threadIdx.x; e < nbins * kWarps; e += kThreads) cnt[e] = 0;
  __syncthreads();
  const int tmin = bmin - (zb - 2);
  gather::count_bins<kWarps>(tag, lo, hi, tmin, cnt);
  const int total = gather::exclusive_scan<kThreads>(cnt, nbins * kWarps, tmp);
  for (int b = threadIdx.x; b <= nbins; b += kThreads) {
    bstart[b] = b < nbins ? cnt[b * kWarps] : total;
  }
  __syncthreads();
  int staged_lo = 0, staged_hi = 0;  // the list window in `stage`
  if (in_regs && total <= cap) {
    // Each kept slot's record from its fields, at its list position.
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int pos = gather::place_step<kWarps>(tag, lo + 32 * j, hi, tmin, cnt);
      if (pos >= 0) {
        int t1, k;
        const int v = lo + 32 * j + lane;
        locate(v, t1, k);
        float r[4 * R::kVec];
        rec_from_source<kNch, kTent, kApic>(f[j], t1, i0, row + 1 - t1, dx, r);
        rec3d::put_rec<R::kVec>(r, stage + static_cast<size_t>(pos) * R::kVec);
      }
    }
    staged_hi = total;
  } else {
    gather::place<kWarps>(tag, lo, hi, tmin, cnt, order);
  }
  __syncthreads();

  // First list position of the slots with base column bmin + b (clamped).
  auto at = [&](int b) { return bstart[min(max(b, 0), nbins)]; };
  // kSplit threads per z column zlo .. zhi, in rounds of kCols columns.
  const int ncols = zhi - zlo + 1;
  const int share = threadIdx.x % kSplit;
  for (int r0 = 0; r0 < ncols; r0 += kCols) {
    const int col = r0 + static_cast<int>(threadIdx.x) / kSplit;
    const bool has = col < ncols;
    const int c = zlo + min(col, ncols - 1);
    // This column's slots: base columns c - 2, c - 1, c (z taps 2, 1, 0).
    const int p0 = at(c - 2 - bmin), p1 = at(c - 1 - bmin), p2 = at(c - bmin);
    const int p3 = at(c + 1 - bmin);
    // The round's slots, from its first column's to its last's.
    const int need_lo = at(zlo + r0 - 2 - bmin);
    const int need_hi = at(zlo + min(r0 + kCols, ncols) - bmin);
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
              int t1, k;
              locate(order[p], t1, k);
              float g[F::kN];
              rec3d::load_fields<kNch, kApic, kStress>(in, pencil_of(t1), k, fl, g);
              rec_from_source<kNch, kTent, kApic>(g, t1, i0, row + 1 - t1, dx, r);
            });
        __syncthreads();
      }
      const int end = min(min(need_hi, staged_hi), p3);
      if (has) {
        // This thread's share of the column's slots in [sub, end).
        const int q = max(p0, sub);
        for (int p = q + (share - (q - p0) % kSplit + kSplit) % kSplit; p < end; p += kSplit) {
          const float jz = p < p1 ? 2.0f : (p < p2 ? 1.0f : 0.0f);
          rec3d::visit<kNch, kTent, kApic, 0, 2>(stage + (p - staged_lo) * R::kVec, jz, dx,
                                                 acc);
        }
      }
      sub = min(need_hi, staged_hi);
    }
    // The shares of a column, added in a fixed butterfly.
    rec3d::butterfly<kNch, kSplit>(acc);
    if (has) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
#pragma unroll
        for (int ch = 0; ch < kNch; ++ch) {
          if (ch % kSplit != share) continue;
          obase[t * ts + static_cast<long long>(ch) * G2 + c] = acc[t][ch];
        }
      }
    }
  }
}

template <int kNch, bool kTent, bool kApic, bool kStress>
int launch(const taps::Prepped& in, const int* counts, float* out, int R0, int R1, int K,
           int G1out, int row_off, int G2, int band, int cap, float dx, const taps::Fluid& fl,
           cudaStream_t stream) {
  using Rc = rec3d::Rec<kNch, kApic>;
  const size_t smem = sizeof(float4) * Rc::kVec * static_cast<size_t>(cap) +
                      sizeof(int) * ((band + 2) * static_cast<size_t>(kWarps) + band + 3 +
                                     static_cast<size_t>(kNT) * K) +
                      sizeof(short) * ((static_cast<size_t>(kNT) * K + 1) / 2 * 2);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(p2g3d_kernel<kNch, kTent, kApic, kStress>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(static_cast<unsigned>(R0) * G1out, (G2 + band - 1) / band);
  p2g3d_kernel<kNch, kTent, kApic, kStress><<<blocks, kThreads, smem, stream>>>(
      in, counts, out, R1, K, G1out, row_off, G2, band, cap, dx, fl);
  return static_cast<int>(cudaGetLastError());
}

template <int kNch>
int launch_nch(const taps::Prepped& in, const int* counts, float* out, int R0, int R1, int K,
               int G1out, int row_off, int G2, int band, int cap, float dx, int apic, int tent,
               cudaStream_t s) {
  const taps::Fluid fl{};
  const auto go = [&](auto fn) {
    return fn(in, counts, out, R0, R1, K, G1out, row_off, G2, band, cap, dx, fl, s);
  };
  if (tent) {
    return apic ? go(launch<kNch, true, true, false>) : go(launch<kNch, true, false, false>);
  }
  return apic ? go(launch<kNch, false, true, false>) : go(launch<kNch, false, false, false>);
}

}  // namespace

// planes / strides: 29 entries in the order of taps.cuh (null where the
// mode has no such plane), or in the stress mode the 18 state planes
// [gx (3), v (3), C00..C22, J, mass, vol0] first.  nch: 7 or 11; apic,
// tent, halo1: 0/1 (halo1: G1 + 4 output rows, row q = target row q - 1);
// stress: 0 prepped, 1 linear, 2 Tait EOS (nch 7, B-spline), with the
// fluid constants kb, kb / gamma, gamma, 2 mu and fa (read only then);
// band, cap: the plan (transfer3d.py's plan_p2g3d: z columns a block owns,
// slots staged at a time).  Returns a cudaError_t as int (0 on success):
// cudaErrorInvalidValue for another nch or mode, a plan out of range or one
// whose shared memory exceeds the card's opt-in limit, else the attribute
// call's or the launch's error.
extern "C" int mpm_p2g3d(const void* const* planes, const long long* strides,
                         const int* counts, float* out, int R0, int R1, int K,
                         int G1, int G2, int nch, int apic, int tent, int halo1, float dx,
                         int stress, float kb, float kb_over_gamma, float gamma, float two_mu,
                         float fa, int band, int cap, void* stream) {
  if (nch != 7 && nch != 11) return static_cast<int>(cudaErrorInvalidValue);
  if (stress < 0 || stress > 2 || (stress && (nch != 7 || tent))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R0 <= 0 || G1 <= 0 || G2 <= 0) return static_cast<int>(cudaGetLastError());
  if (K < 0 || band <= 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int g1out = halo1 ? G1 + kNT - 1 : G1;
  const int row_off = halo1 ? -1 : 0;
  if (static_cast<long long>(R0) * g1out > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const taps::Prepped in = taps::prepped_from(planes, strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stress) {
    const taps::Fluid fl{stress == 2, kb, kb_over_gamma, gamma, two_mu, fa};
    const auto go = [&](auto fn) {
      return fn(in, counts, out, R0, R1, K, g1out, row_off, G2, band, cap, dx, fl, s);
    };
    return apic ? go(launch<7, false, true, true>) : go(launch<7, false, false, true>);
  }
  return nch == 7 ? launch_nch<7>(in, counts, out, R0, R1, K, g1out, row_off, G2, band, cap, dx,
                                  apic, tent, s)
                  : launch_nch<11>(in, counts, out, R0, R1, K, g1out, row_off, G2, band, cap,
                                   dx, apic, tent, s);
}
