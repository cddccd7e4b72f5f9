// Fused-stress P2G over row-bucketed particles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `p2g_fused` in
// mpm_flip98a_tpu/ops/pallas/transfer2d.py (def :412, pallas_call :433,
// body _p2g_fused_chunk :367 -> _p2g_core :210).  The TPU kernel builds a
// dense (K, G) one-hot column-weight matrix and scatters with an MXU
// product; here each particle adds its 3x3 B-spline taps directly.
//
// Contract (same as the TPU kernel):
//   sdata  (R, 11, K) f32 = [gx0, gx1, v0, v1, C00, C01, C10, C11, J, mass, vol0]
//   counts (R,) i32       packed bucket counts (active slots first)
//   out    (R, 5, 5, G) f32: for bucket row i, target row t (grid row
//          i + t - 1), channels [m v0, m v1, m v0 + f0, m v1 + f1, m].
// A slot contributes only when its base row floor(gx0 - 0.5) is within
// +-1 of i; taps on columns outside [0, G) are dropped.  Channels 2-3 get
// w (m v_a + Q_a0 rdp + Q_a1 (c - gx1) dx) with Q = fa tau (+ m C under
// APIC, which also adds P = m C to channels 0-1).
//
// Design: one block per bucket row.  The block owns out[i] outright, so
// it accumulates in a (5, 5, G) shared-memory slab (51.3 KB at G = 513,
// past the 48 KB default, hence the attribute) and writes it once, zeros
// included: no global atomics.  Each thread walks slots k < counts[i]
// with a stride of the block size and computes the fluid stress in
// registers (taps.cuh's `load_fused2d`, which p2g_grid.cu shares).
//
// What bounds it on the H100: bytes and shared-memory atomics, not flops.
// A slot reads 44 bytes and issues 45 shared atomic adds (9 taps x 5
// channels, ~20 flops per tap); the block writes 25 G floats.  Shared
// atomics add in a run-dependent order, so the result is not bitwise
// deterministic: it agrees with the plain version to fp32 rounding of
// each node's sum (the tolerance is stated where the two are compared).

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kNT = 5;     // candidate target rows
constexpr int kNCH = 5;    // output channels
constexpr int kFields = 11;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
p2g_fused_kernel(const float* __restrict__ sdata, const int* __restrict__ counts,
                 float* __restrict__ out, int K, int G, float dx, int apic,
                 taps::Fluid2d fluid) {
  extern __shared__ float slab[];  // [kNT][kNCH][G]
  const int i = blockIdx.x;
  const int n_slab = kNT * kNCH * G;
  for (int e = threadIdx.x; e < n_slab; e += blockDim.x) slab[e] = 0.0f;
  __syncthreads();

  const int count = counts[i];
  const float* row = sdata + static_cast<size_t>(i) * kFields * K;
  const float fi = static_cast<float>(i);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const float gx0 = row[k];
    const float base0 = floorf(gx0 - 0.5f);
    const float rel = base0 - fi;
    if (!(rel >= -1.0f && rel <= 1.0f)) continue;  // outside the row margin
    const float gx1 = row[K + k];
    taps::Slot2d<1> slot;
    taps::load_fused2d(row, K, k, apic, fluid, slot);

    float w0[3];
    taps::axis<false>(gx0 - base0, w0);
    const float base1 = floorf(gx1 - 0.5f);
    float wc[3], cd[3];
    int col[3];
#pragma unroll
    for (int jc = 0; jc < 3; ++jc) {
      const float cf = base1 + static_cast<float>(jc);
      const bool in = cf >= 0.0f && cf < static_cast<float>(G);
      const float d = cf - gx1;
      col[jc] = in ? static_cast<int>(cf) : -1;
      wc[jc] = taps::col<false>(d);
      cd[jc] = d * dx;
    }
    const int t0 = static_cast<int>(rel) + 1;  // target of row tap j = 0
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int t = t0 + j;
      float r[4];
      taps::row_affine2d(slot, (base0 + static_cast<float>(j) - gx0) * dx, r);
      float* s = slab + t * kNCH * G;
#pragma unroll
      for (int jc = 0; jc < 3; ++jc) {
        if (col[jc] < 0) continue;
        taps::add_tap2d(slot, r, cd[jc], w0[j] * wc[jc], s + col[jc], G);
      }
    }
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(i) * n_slab;
  for (int e = threadIdx.x; e < n_slab; e += blockDim.x) o[e] = slab[e];
}

}  // namespace

extern "C" int mpm_p2g_fused(const float* sdata, const int* counts, float* out,
                             int R, int K, int G, float dx, int apic, int tait,
                             float kb, float kb_over_gamma, float gamma,
                             float two_mu, float mu, float fa, void* stream) {
  const size_t smem = sizeof(float) * kNT * kNCH * static_cast<size_t>(G);
  cudaError_t err = cudaFuncSetAttribute(
      p2g_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const taps::Fluid2d fluid = {tait, kb, kb_over_gamma, gamma, two_mu, mu, fa};
  if (R > 0) {
    p2g_fused_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        sdata, counts, out, K, G, dx, apic, fluid);
  }
  return static_cast<int>(cudaGetLastError());
}
