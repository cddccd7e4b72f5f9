// P2G + five-row fold into the raw halo layout of slab shards, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `p2g_grid` in
// mpm_flip98a_tpu/ops/pallas/transfer2d.py (def :597, pallas_call :666,
// body _p2g_grid_kernel :456) in its raw mode, the one the slab-sharded 2D
// fast path runs (mpm_flip98a_tpu/models/fast2d.py:744-762): the fused
// mode (sdata, fluid stress in the kernel, 5 channels) or the prepped mode
// (pdata, 6 or 9 channels), B-spline or (prepped) tent taps, PIC or APIC.
// The TPU kernel folds the five candidate target rows in a rolling 5-slot
// VMEM scratch carried across its sequential grid; GPU blocks run in no
// order, so that design does not carry over.  The non-raw mode (the fold
// plus the grid update and colliders in the same kernel, reached only by
// MPM_P2G_GRID=1) is not ported.
//
// Contract (the TPU kernel's raw output, batched over shards):
//   data   n shards of L bucket rows, (n L, 11, K) sdata = [gx0, gx1, v0,
//          v1, C00, C01, C10, C11, J, mass, vol0] or (n L, 8 + kNch, K)
//          prepped pdata = [gx0, gx1, m v (2), P (4), Q (4), *plain], gx0
//          local to the shard (bucket row i holds base rows i +- 1)
//   counts (n L,) i32 packed bucket counts (active slots first)
//   out    (n, L + 4, kNch, G) f32 raw, uncropped folded sums: row j of
//          shard s is its local target row j - 1, channels [m v0, m v1,
//          m v0 + f0, m v1 + f1, *plain].  That equals fold_rows_halo of
//          the expanded `p2g_fused` / `p2g` output per shard
//          (transfer2d.py:637-641, :484-489).
// A slot contributes only when its base row is within +-1 of its bucket
// row; taps on columns outside [0, G) are dropped.
//
// Design: one block per (halo row j, column band, shard) owns out[s, j,
// :, band] outright.  It pulls from the source bucket rows j - 4 .. j that
// exist in its shard, adds only the taps that land on target row j - 1 into
// a (kNch, band) shared-memory slab, and writes the slab once, zeros
// included: no global atomics, no memset and no (L, 5, kNch, G)
// intermediate.  The fused mode computes the stress per slot with
// p2g_fused.cu's arithmetic (taps.cuh), so the sharded and the
// single-device paths round alike.  One launch covers all shards (the
// shard is blockIdx.z).  The band is all G columns while the slab fits the
// opt-in shared memory, as in p2g.cu.
//
// What bounds it on the H100: bytes and shared-memory atomics.  Each slot
// is read by the (up to) 5 blocks of the target rows its rows can reach,
// i.e. up to 5 x 4 (11 or 8 + kNch) bytes, and issues 9 kNch shared atomic
// adds in all; each block writes kNch band floats.  Shared atomics add in
// a run-dependent order, so the result is not bitwise deterministic: it
// agrees with the plain version to fp32 rounding of each node's sum.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kNT = 5;     // candidate target rows per bucket row
constexpr int kThreads = 256;

template <int kNch, bool kFused, bool kTent>
__global__ void __launch_bounds__(kThreads)
p2g_grid_kernel(const float* __restrict__ data, const int* __restrict__ counts,
                float* __restrict__ out, int L, int K, int G, int band, float dx,
                int apic, taps::Fluid2d fluid) {
  constexpr int kFields = kFused ? 11 : 8 + kNch;
  constexpr int kPlain = kNch - 4;
  extern __shared__ float slab[];  // [kNch][band]
  const int j = blockIdx.x;        // halo row: local target row j - 1
  const int c0 = blockIdx.y * band;
  const long long shard = blockIdx.z;
  const int width = min(band, G - c0);
  for (int e = threadIdx.x; e < kNch * band; e += blockDim.x) slab[e] = 0.0f;
  __syncthreads();

  const int target = j - 1;
  for (int i = max(0, j - 4); i <= min(L - 1, j); ++i) {
    const long long bucket = shard * L + i;
    const int count = counts[bucket];
    const float* row = data + bucket * kFields * K;
    const float fi = static_cast<float>(i);
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const float gx0 = row[k];
      const float base0 = floorf(gx0 - 0.5f);
      const float rel = base0 - fi;
      if (!(rel >= -1.0f && rel <= 1.0f)) continue;  // outside the row margin
      const int jr = target - i - static_cast<int>(rel);  // row tap on `target`
      if (jr < 0 || jr > 2) continue;
      const float gx1 = row[K + k];
      const float base1 = floorf(gx1 - 0.5f);
      // The slot's columns base1 .. base1 + 2 must meet this block's band.
      if (base1 + 2.0f < static_cast<float>(c0) ||
          base1 >= static_cast<float>(c0 + width)) continue;
      taps::Slot2d<kPlain> slot;
      if constexpr (kFused) {
        taps::load_fused2d(row, K, k, apic, fluid, slot);
      } else {
        taps::load_prepped2d(row, K, k, apic, slot);
      }
      float w0[3];
      taps::axis<kTent>(gx0 - base0, w0);
      float r[4];
      taps::row_affine2d(slot, (base0 + static_cast<float>(jr) - gx0) * dx, r);
#pragma unroll
      for (int jc = 0; jc < 3; ++jc) {
        const float cf = base1 + static_cast<float>(jc);
        if (!(cf >= 0.0f && cf < static_cast<float>(G))) continue;
        const int cb = static_cast<int>(cf) - c0;  // column in the band
        if (cb < 0 || cb >= width) continue;
        const float d = cf - gx1;
        taps::add_tap2d(slot, r, d * dx, w0[jr] * taps::col<kTent>(d), slab + cb, band);
      }
    }
  }
  __syncthreads();
  // Channel rows of the slab go to out[s, j, ch, c0 : c0 + width].
  float* o = out + (shard * (L + kNT - 1) + j) * kNch * G + c0;
  for (int e = threadIdx.x; e < kNch * width; e += blockDim.x) {
    const int ch = e / width, c = e - ch * width;
    o[static_cast<long long>(ch) * G + c] = slab[ch * band + c];
  }
}

template <int kNch, bool kFused, bool kTent>
int launch(const float* data, const int* counts, float* out, int n, int L, int K, int G,
           int band, float dx, int apic, const taps::Fluid2d& fluid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kNch * static_cast<size_t>(band);
  cudaError_t err = cudaFuncSetAttribute(
      p2g_grid_kernel<kNch, kFused, kTent>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(L + kNT - 1, (G + band - 1) / band, n);
  p2g_grid_kernel<kNch, kFused, kTent><<<blocks, kThreads, smem, stream>>>(
      data, counts, out, L, K, G, band, dx, apic, fluid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n shards of L bucket rows; nch: 5 (fused, B-spline only), 6 or 9
// (prepped); fused, apic, tent: 0/1; the fluid constants are read in the
// fused mode only.  Returns a cudaError_t as int (0 on success):
// cudaErrorInvalidValue for an nch / mode the kernel has no form of.
extern "C" int mpm_p2g_grid(const float* data, const int* counts, float* out, int n, int L,
                            int K, int G, int nch, int fused, int tent, float dx, int apic,
                            int tait, float kb, float kb_over_gamma, float gamma,
                            float two_mu, float mu, float fa, void* stream) {
  if (fused ? (nch != 5 || tent) : (nch != 6 && nch != 9)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || L <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Widest equal column bands whose slab fits the opt-in shared memory.
  const int max_cols = static_cast<int>(optin / (static_cast<long long>(sizeof(float)) * nch));
  if (max_cols < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_bands = (G + max_cols - 1) / max_cols;
  const int band = (G + n_bands - 1) / n_bands;
  const taps::Fluid2d fluid = {tait, kb, kb_over_gamma, gamma, two_mu, mu, fa};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) return launch<5, true, false>(data, counts, out, n, L, K, G, band, dx, apic, fluid, s);
  if (nch == 6) {
    return tent ? launch<6, false, true>(data, counts, out, n, L, K, G, band, dx, apic, fluid, s)
                : launch<6, false, false>(data, counts, out, n, L, K, G, band, dx, apic, fluid, s);
  }
  return tent ? launch<9, false, true>(data, counts, out, n, L, K, G, band, dx, apic, fluid, s)
              : launch<9, false, false>(data, counts, out, n, L, K, G, band, dx, apic, fluid, s);
}
