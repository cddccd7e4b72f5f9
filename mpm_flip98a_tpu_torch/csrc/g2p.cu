// G2P gather over row-bucketed particles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `g2p` in
// mpm_flip98a_tpu/ops/pallas/transfer2d.py (def :843, pallas_call :893,
// body _g2p_chunk :755) in its update=False, 4-channel form.  The TPU
// kernel multiplies the grid rows by a dense (G, K) one-hot weight matrix
// on the MXU; here each slot reads its 3x3 nodes directly.
//
// Contract (same as the TPU kernel):
//   pdata2 (R, 3, K) f32 = [gx0, gx1, mask], counts (R,) i32
//   grid   (R, 4, G) f32 = [v_new0, v_new1, v_old0, v_old1], row-leading,
//          unpadded: rows outside [0, R) read as zero
//   out    (R, 8, K) f32 = [vpic0, vpic1, vold0, vold1, C00, C01, C10, C11]
// with vpic = sum w v_new, vold = sum w v_old, C_a0 = D^-1 sum w v_new_a rdp,
// C_a1 = D^-1 dx sum w v_new_a (c - gx1), D^-1 = 4 / dx^2.  Slots past the
// count, with mask 0 or outside the +-1-row margin get zeros; taps on
// columns outside [0, G) are dropped.
//
// Design: one thread per slot, blocks of 256 slots along K and one grid
// row of blocks per bucket row.  Each thread sums its 9 taps in a fixed
// order (rows, then columns), so the result is deterministic.
//
// What bounds it on the H100: bytes.  A slot reads 12 bytes of slot data
// and 36 grid floats (mostly L2 hits: neighbouring slots share nodes) and
// writes 32 bytes, for ~20 flops per tap.  Reads of the slot planes and
// writes of the 8 output planes are coalesced along K.

#include <cuda_runtime.h>

namespace {

constexpr int kCh = 4;
constexpr int kOut = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float col_weight(float d) {
  const float a = fabsf(d);
  const float t1 = fmaxf(1.5f - a, 0.0f);
  const float t2 = fmaxf(0.5f - a, 0.0f);
  return 0.5f * t1 * t1 - 1.5f * t2 * t2;
}

__global__ void __launch_bounds__(kThreads)
g2p_kernel(const float* __restrict__ pdata2, const int* __restrict__ counts,
           const float* __restrict__ grid, float* __restrict__ out, int R, int K,
           int G, float dx, float dinv, float dinv_dx) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (k >= K) return;
  const float* pd = pdata2 + static_cast<size_t>(i) * 3 * K;
  float acc[kOut] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (k < counts[i]) {
    const float gx0 = pd[k], gx1 = pd[K + k], mask = pd[2 * K + k];
    const float base0 = floorf(gx0 - 0.5f);
    const float rel = base0 - static_cast<float>(i);
    if (mask > 0.0f && rel >= -1.0f && rel <= 1.0f) {
      const float fx0 = gx0 - base0;
      const float w0[3] = {0.5f * (1.5f - fx0) * (1.5f - fx0),
                           0.75f - (fx0 - 1.0f) * (fx0 - 1.0f),
                           0.5f * (fx0 - 0.5f) * (fx0 - 0.5f)};
      const float base1 = floorf(gx1 - 0.5f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float rowf = base0 + static_cast<float>(j);
        if (!(rowf >= 0.0f && rowf < static_cast<float>(R))) continue;
        const float rdp = (rowf - gx0) * dx;
        const float* gr = grid + static_cast<size_t>(rowf) * kCh * G;
#pragma unroll
        for (int jc = 0; jc < 3; ++jc) {
          const float cf = base1 + static_cast<float>(jc);
          if (!(cf >= 0.0f && cf < static_cast<float>(G))) continue;
          const int c = static_cast<int>(cf);
          const float d = cf - gx1;
          const float w = w0[j] * col_weight(d);
          const float vn0 = gr[c], vn1 = gr[G + c];
          const float vo0 = gr[2 * G + c], vo1 = gr[3 * G + c];
          acc[0] += w * vn0;
          acc[1] += w * vn1;
          acc[2] += w * vo0;
          acc[3] += w * vo1;
          const float wr = w * rdp, wd = w * d;
          acc[4] += wr * vn0;
          acc[5] += wd * vn0;
          acc[6] += wr * vn1;
          acc[7] += wd * vn1;
        }
      }
      acc[4] *= dinv;
      acc[5] *= dinv_dx;
      acc[6] *= dinv;
      acc[7] *= dinv_dx;
    }
  }
  float* o = out + static_cast<size_t>(i) * kOut * K + k;
#pragma unroll
  for (int ch = 0; ch < kOut; ++ch) o[static_cast<size_t>(ch) * K] = acc[ch];
}

}  // namespace

extern "C" int mpm_g2p(const float* pdata2, const int* counts, const float* grid,
                       float* out, int R, int K, int G, float dx, float dinv,
                       float dinv_dx, void* stream) {
  if (R > 0 && K > 0) {
    const dim3 blocks((K + kThreads - 1) / kThreads, R);
    g2p_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pdata2, counts, grid, out, R, K, G, dx, dinv, dinv_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
