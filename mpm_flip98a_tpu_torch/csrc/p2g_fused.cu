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
// registers.
//
// What bounds it on the H100: bytes and shared-memory atomics, not flops.
// A slot reads 44 bytes and issues 45 shared atomic adds (9 taps x 5
// channels, ~20 flops per tap); the block writes 25 G floats.  Shared
// atomics add in a run-dependent order, so the result is not bitwise
// deterministic: it agrees with the plain version to fp32 rounding of
// each node's sum (the tolerance is stated where the two are compared).

#include <cuda_runtime.h>

namespace {

constexpr int kNT = 5;     // candidate target rows
constexpr int kNCH = 5;    // output channels
constexpr int kFields = 11;
constexpr int kThreads = 256;

__device__ __forceinline__ float col_weight(float d) {
  // 0.5 (1.5-|d|)+^2 - 1.5 (0.5-|d|)+^2: the quadratic B-spline as a
  // function of the signed distance (transfer2d.py:147-159).
  const float a = fabsf(d);
  const float t1 = fmaxf(1.5f - a, 0.0f);
  const float t2 = fmaxf(0.5f - a, 0.0f);
  return 0.5f * t1 * t1 - 1.5f * t2 * t2;
}

__global__ void __launch_bounds__(kThreads)
p2g_fused_kernel(const float* __restrict__ sdata, const int* __restrict__ counts,
                 float* __restrict__ out, int K, int G, float dx, int apic,
                 int tait, float kb, float kb_over_gamma, float gamma,
                 float two_mu, float mu, float fa) {
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
    const float v0 = row[2 * K + k], v1 = row[3 * K + k];
    const float c00 = row[4 * K + k], c01 = row[5 * K + k];
    const float c10 = row[6 * K + k], c11 = row[7 * K + k];
    const float jj = row[8 * K + k], mass = row[9 * K + k];
    const float vol0 = row[10 * K + k];

    // Weakly-compressible fluid stress (transfer2d.py:382-401).
    float pressure;
    if (tait) {
      const float j_safe = fmaxf(jj, 1e-3f);
      pressure = kb_over_gamma * (powf(1.0f / j_safe, gamma) - 1.0f);
    } else {
      pressure = -kb * (jj - 1.0f);
    }
    const float div = c00 + c11;
    const float vj = vol0 * jj;
    const float t00 = vj * (-pressure + two_mu * (c00 - 0.5f * div));
    const float t11 = vj * (-pressure + two_mu * (c11 - 0.5f * div));
    const float t01 = vj * (mu * (c01 + c10));
    const float p00 = apic ? mass * c00 : 0.0f, p01 = apic ? mass * c01 : 0.0f;
    const float p10 = apic ? mass * c10 : 0.0f, p11 = apic ? mass * c11 : 0.0f;
    const float q00 = p00 + fa * t00, q01 = p01 + fa * t01;
    const float q10 = p10 + fa * t01, q11 = p11 + fa * t11;
    const float mv0 = mass * v0, mv1 = mass * v1;

    const float fx0 = gx0 - base0;
    const float w0[3] = {0.5f * (1.5f - fx0) * (1.5f - fx0),
                         0.75f - (fx0 - 1.0f) * (fx0 - 1.0f),
                         0.5f * (fx0 - 0.5f) * (fx0 - 0.5f)};
    const float base1 = floorf(gx1 - 0.5f);
    float wc[3], cd[3];
    int col[3];
#pragma unroll
    for (int jc = 0; jc < 3; ++jc) {
      const float cf = base1 + static_cast<float>(jc);
      const bool in = cf >= 0.0f && cf < static_cast<float>(G);
      const float d = cf - gx1;
      col[jc] = in ? static_cast<int>(cf) : -1;
      wc[jc] = col_weight(d);
      cd[jc] = d * dx;
    }
    const int t0 = static_cast<int>(rel) + 1;  // target of row tap j = 0
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int t = t0 + j;
      const float rdp = (base0 + static_cast<float>(j) - gx0) * dx;
      const float r0 = mv0 + p00 * rdp, r1 = mv1 + p10 * rdp;
      const float r2 = mv0 + q00 * rdp, r3 = mv1 + q10 * rdp;
      float* s = slab + t * kNCH * G;
#pragma unroll
      for (int jc = 0; jc < 3; ++jc) {
        if (col[jc] < 0) continue;
        const float w = w0[j] * wc[jc];
        float* sc = s + col[jc];
        atomicAdd(sc, w * (r0 + p01 * cd[jc]));
        atomicAdd(sc + G, w * (r1 + p11 * cd[jc]));
        atomicAdd(sc + 2 * G, w * (r2 + q01 * cd[jc]));
        atomicAdd(sc + 3 * G, w * (r3 + q11 * cd[jc]));
        atomicAdd(sc + 4 * G, w * mass);
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
  if (R > 0) {
    p2g_fused_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        sdata, counts, out, K, G, dx, apic, tait, kb, kb_over_gamma, gamma,
        two_mu, mu, fa);
  }
  return static_cast<int>(cudaGetLastError());
}
