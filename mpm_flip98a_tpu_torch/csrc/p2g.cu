// P2G of prepped slot data over row-bucketed particles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `p2g` in
// mpm_flip98a_tpu/ops/pallas/transfer2d.py (def :304, pallas_call :323,
// body _p2g_kernel :176 -> _p2g_chunk :197 -> _p2g_core :210).  The TPU
// kernel builds a dense (K, G) one-hot column-weight matrix and scatters
// with an MXU product; here each particle adds its 3x3 taps directly.
//
// Contract (same as the TPU kernel):
//   pdata  (R, 8 + kNch, K) f32 = [gx0, gx1, m v0, m v1, P00, P01, P10,
//          P11, Q00, Q01, Q10, Q11, *plain] with plain = [m, V] (kNch 6)
//          or [m, V0 J, V0, V0 p, V0 div] (kNch 9); every value row
//          pre-masked (zeros in dead slots)
//   counts (R,) i32 packed bucket counts (active slots first)
//   out    (R, 5, kNch, G) f32: for bucket row i, target row t (grid row
//          i + t - 1), channels [m v0, m v1, m v0 + f0, m v1 + f1, *plain].
// Channels 2-3 get w (m v_a + Q_a0 rdp + Q_a1 (c - gx1) dx); under APIC
// channels 0-1 get the same with P, under PIC w m v_a.  A slot contributes
// only when its base row floor(gx0 - 0.5) is within +-1 of i; slots at or
// past counts[i] are skipped; taps on columns outside [0, G) are dropped.
// Taps are the quadratic B-spline or, with kTent, the linear hat.  The
// column-affine term is computed per tap, not as the TPU's rank-1 fold.
//
// Design: one block per (bucket row, column band).  The block owns its
// part of out[i] outright, so it accumulates in a (5, kNch, band)
// shared-memory slab and writes it once, zeros included: no global
// atomics.  The band is all G columns while the slab fits in the card's
// opt-in shared memory (92.3 KB at kNch = 9, G = 513); past that (G above
// ~1290 at kNch = 9) the host splits the columns into equal bands and
// each block adds only the taps inside its own band.  Each thread walks
// slots k < counts[i] with a stride of the block size.
//
// What bounds it on the H100: bytes and shared-memory atomics, not flops.
// A slot reads 4 (8 + kNch) bytes and issues 9 kNch shared atomic adds;
// the block writes 5 kNch band floats.  Shared atomics add in a
// run-dependent order, so the result is not bitwise deterministic: it
// agrees with the plain version to fp32 rounding of each node's sum.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kNT = 5;     // candidate target rows
constexpr int kThreads = 256;

template <int kNch, bool kTent>
__global__ void __launch_bounds__(kThreads)
p2g_kernel(const float* __restrict__ pdata, const int* __restrict__ counts,
           float* __restrict__ out, int K, int G, int band, float dx, int apic) {
  constexpr int kFields = 8 + kNch;
  extern __shared__ float slab[];  // [kNT][kNch][band]
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * band;
  const int width = min(band, G - c0);
  const int n_slab = kNT * kNch * band;
  for (int e = threadIdx.x; e < n_slab; e += blockDim.x) slab[e] = 0.0f;
  __syncthreads();

  const int count = counts[i];
  const float* row = pdata + static_cast<size_t>(i) * kFields * K;
  const float fi = static_cast<float>(i);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const float gx0 = row[k];
    const float base0 = floorf(gx0 - 0.5f);
    const float rel = base0 - fi;
    if (!(rel >= -1.0f && rel <= 1.0f)) continue;  // outside the row margin
    const float gx1 = row[K + k];
    const float base1 = floorf(gx1 - 0.5f);
    // The slot's columns base1 .. base1 + 2 must meet this block's band.
    if (base1 + 2.0f < static_cast<float>(c0) ||
        base1 >= static_cast<float>(c0 + width)) continue;
    taps::Slot2d<kNch - 4> slot;
    taps::load_prepped2d(row, K, k, apic, slot);

    float w0[3];
    taps::axis<kTent>(gx0 - base0, w0);
    float wc[3], cd[3];
    int col[3];
#pragma unroll
    for (int jc = 0; jc < 3; ++jc) {
      const float cf = base1 + static_cast<float>(jc);
      const bool in = cf >= 0.0f && cf < static_cast<float>(G);
      const int cb = in ? static_cast<int>(cf) - c0 : -1;  // column in the band
      const float d = cf - gx1;
      col[jc] = (cb >= 0 && cb < width) ? cb : -1;
      wc[jc] = taps::col<kTent>(d);
      cd[jc] = d * dx;
    }
    const int t0 = static_cast<int>(rel) + 1;  // target of row tap j = 0
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int t = t0 + j;
      float r[4];
      taps::row_affine2d(slot, (base0 + static_cast<float>(j) - gx0) * dx, r);
      float* s = slab + t * kNch * band;
#pragma unroll
      for (int jc = 0; jc < 3; ++jc) {
        if (col[jc] < 0) continue;
        taps::add_tap2d(slot, r, cd[jc], w0[j] * wc[jc], s + col[jc], band);
      }
    }
  }
  __syncthreads();
  // Rows (t, ch) of the slab go to out[i, t, ch, c0 : c0 + width].
  float* o = out + static_cast<size_t>(i) * kNT * kNch * G + c0;
  const int n_out = kNT * kNch * width;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int r = e / width, c = e - r * width;
    o[static_cast<size_t>(r) * G + c] = slab[r * band + c];
  }
}

template <int kNch, bool kTent>
int launch(const float* pdata, const int* counts, float* out, int R, int K, int G,
           int band, float dx, int apic, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kNT * kNch * static_cast<size_t>(band);
  cudaError_t err = cudaFuncSetAttribute(
      p2g_kernel<kNch, kTent>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(R, (G + band - 1) / band);
  p2g_kernel<kNch, kTent><<<blocks, kThreads, smem, stream>>>(
      pdata, counts, out, K, G, band, dx, apic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nch: 6 or 9; apic, tent: 0/1.  Returns a cudaError_t as int (0 on
// success): cudaErrorInvalidValue for another nch, else the attribute
// call's or the launch's error.
extern "C" int mpm_p2g(const float* pdata, const int* counts, float* out, int R,
                       int K, int G, int nch, float dx, int apic, int tent,
                       void* stream) {
  if (nch != 6 && nch != 9) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Widest equal column bands whose slab fits the opt-in shared memory.
  const long long per_col = static_cast<long long>(sizeof(float)) * kNT * nch;
  const int max_cols = static_cast<int>(optin / per_col);
  if (max_cols < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_bands = (G + max_cols - 1) / max_cols;
  const int band = (G + n_bands - 1) / n_bands;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nch == 6) {
    return tent ? launch<6, true>(pdata, counts, out, R, K, G, band, dx, apic, s)
                : launch<6, false>(pdata, counts, out, R, K, G, band, dx, apic, s);
  }
  return tent ? launch<9, true>(pdata, counts, out, R, K, G, band, dx, apic, s)
              : launch<9, false>(pdata, counts, out, R, K, G, band, dx, apic, s);
}
