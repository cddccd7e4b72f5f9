// G2P gather over row-bucketed particles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `g2p` in
// mpm_flip98a_tpu/ops/pallas/transfer2d.py (def :843, pallas_call :893,
// body _g2p_kernel :724 -> _g2p_chunk :755) in both forms: the gathers
// (update=False) with the 4- or 7-channel grid, and the fused particle
// update (update=True: the FLIP blend, advection and the J update,
// transfer2d.py:815-830, which MPM_FUSE2D_G2P=1 runs); B-spline or tent
// taps.  The TPU kernel multiplies
// the grid rows by a dense (G, K) one-hot weight matrix on the MXU; here
// each slot reads its 3x3 nodes directly.
//
// Contract (same as the TPU kernel):
//   pdata2 (R, 3, K) f32 = [gx0, gx1, mask], counts (R,) i32
//   grid   (R, kCh, G) f32 = [v_new0, v_new1, v_old0, v_old1(, Jbar, p,
//          div)], row-leading, unpadded: rows outside [0, R) read as zero;
//          or prepadded (transfer2d.py:859-863, :879-881): n slab shards
//          of L bucket rows (n L = R, gx0 local to the shard), grid
//          (n, L + 4, kCh, G) with row j of shard s its target row j - 1
//   out    (R, 8 + kCh - 4, K) f32 = [vpic0, vpic1, vold0, vold1, C00,
//          C01, C10, C11(, Jbar, p, div)]
//   update pdata2 (R, 8, K) = [gx0, gx1, mask, v0, v1, J, x0, x1], the
//          4-channel grid, out (R, 9, K) = [x0, x1, v0, v1, C00, C01, C10,
//          C11, J]: x + dtv vpic, (alpha (v + vpic - vold) + (1 - alpha)
//          vpic) mask, C, and J (1 + dtv (C00 + C11)) where mask > 0, else
//          1; slots past the count keep x and get v = C = 0, J = 1
// with vpic = sum w v_new, vold = sum w v_old, C_a0 = dinv sum w v_new_a
// rdp, C_a1 = dinv dx sum w v_new_a (c - gx1), and the extended channels
// sum w grid_e.  B-spline callers pass dinv = 4 / dx^2; tent callers pass
// 1 and invert the per-particle D themselves (models/fast2d.py).  Slots
// past the count, with mask 0 or outside the +-1-row margin get zeros;
// taps on columns outside [0, G) are dropped.
//
// Design: one thread per slot, blocks of 256 slots along K and one grid
// row of blocks per bucket row; a prepadded grid is a row offset and a
// bound per shard window, so one launch covers all shards.  Each thread
// sums its 9 taps in a fixed order (rows, then columns), so the result is
// deterministic; the update mode then finishes the slot in registers, one
// rounding per operation as the plain version's PyTorch ops round (no FMA
// contraction).  The channel count, the taps and the mode are template
// parameters: six instantiations, chosen by the host entry point.
//
// What bounds it on the H100: bytes.  A slot reads 12 bytes of slot data
// and 9 kCh grid floats (mostly L2 hits: neighbouring slots share nodes)
// and writes 4 (8 + kCh - 4) bytes, for ~2 (4 + kCh) flops per tap; the
// update mode reads 20 more bytes a slot and writes 36 in place of 32.
// Reads of the slot planes and writes of the output planes are coalesced
// along K.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kThreads = 256;

// Constants of the update mode, each rounded to float32 once (alpha, 1 -
// alpha from a double, as the JAX kernel's weakly typed scalars are).
struct Update {
  float alpha, one_m_alpha, dtv;
};

template <int kCh, bool kTent, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
g2p_kernel(const float* __restrict__ pdata2, const int* __restrict__ counts,
           const float* __restrict__ grid, float* __restrict__ out, int L, int pad,
           int K, int G, float dx, float dinv, float dinv_dx, Update up) {
  constexpr int kAcc = 8 + (kCh - 4);
  constexpr int kIn = kUpdate ? 8 : 3;
  constexpr int kOut = kUpdate ? 9 : kAcc;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;              // bucket row
  if (k >= K) return;
  const int shard = i / L;
  const int li = i - shard * L;          // row within the shard
  const int win = L + 4 * pad;           // rows of the shard's grid window
  const float* gwin = grid + static_cast<size_t>(shard) * win * kCh * G;
  const float* pd = pdata2 + static_cast<size_t>(i) * kIn * K;
  float acc[kAcc] = {};
  const bool live = k < counts[i];
  float mask = 0.0f;
  if (live) {
    const float gx0 = pd[k], gx1 = pd[K + k];
    mask = pd[2 * K + k];
    const float base0 = floorf(gx0 - 0.5f);
    const float rel = base0 - static_cast<float>(li);
    if (mask > 0.0f && rel >= -1.0f && rel <= 1.0f) {
      float w0[3];
      taps::axis<kTent>(gx0 - base0, w0);
      const float base1 = floorf(gx1 - 0.5f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float rowf = base0 + static_cast<float>(j);
        const float wrow = rowf + static_cast<float>(pad);  // row in the window
        if (!(wrow >= 0.0f && wrow < static_cast<float>(win))) continue;
        const float rdp = (rowf - gx0) * dx;
        const float* gr = gwin + static_cast<size_t>(wrow) * kCh * G;
#pragma unroll
        for (int jc = 0; jc < 3; ++jc) {
          const float cf = base1 + static_cast<float>(jc);
          if (!(cf >= 0.0f && cf < static_cast<float>(G))) continue;
          const int c = static_cast<int>(cf);
          const float d = cf - gx1;
          const float w = w0[j] * taps::col<kTent>(d);
          const float vn0 = gr[c], vn1 = gr[G + c];
          acc[0] += w * vn0;
          acc[1] += w * vn1;
          acc[2] += w * gr[2 * G + c];
          acc[3] += w * gr[3 * G + c];
          const float wr = w * rdp, wd = w * d;
          acc[4] += wr * vn0;
          acc[5] += wd * vn0;
          acc[6] += wr * vn1;
          acc[7] += wd * vn1;
#pragma unroll
          for (int e = 4; e < kCh; ++e) acc[4 + e] += w * gr[e * G + c];
        }
      }
      acc[4] *= dinv;
      acc[5] *= dinv_dx;
      acc[6] *= dinv;
      acc[7] *= dinv_dx;
    }
  }
  float o[kOut];
  if constexpr (kUpdate) {
    // The particle update (transfer2d.py:815-830): vpic = acc[0..1], vold =
    // acc[2..3], C = acc[4..7].
    const float x0 = pd[6 * K + k], x1 = pd[7 * K + k];
    if (live) {
      const float v[2] = {pd[3 * K + k], pd[4 * K + k]};
      const float jj = pd[5 * K + k];
      o[0] = __fadd_rn(x0, __fmul_rn(up.dtv, acc[0]));
      o[1] = __fadd_rn(x1, __fmul_rn(up.dtv, acc[1]));
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float flip = __fmul_rn(up.alpha, __fsub_rn(__fadd_rn(v[a], acc[a]), acc[2 + a]));
        o[2 + a] = __fmul_rn(__fadd_rn(flip, __fmul_rn(up.one_m_alpha, acc[a])), mask);
      }
      const float div = __fadd_rn(acc[4], acc[7]);
      o[8] = mask > 0.0f ? __fmul_rn(jj, __fadd_rn(1.0f, __fmul_rn(up.dtv, div))) : 1.0f;
    } else {  // dead fill: x passes through, v = C = 0, J = 1
      o[0] = x0;
      o[1] = x1;
      o[2] = o[3] = 0.0f;
      o[8] = 1.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 + e] = acc[4 + e];
  } else {
#pragma unroll
    for (int ch = 0; ch < kOut; ++ch) o[ch] = acc[ch];
  }
  float* dst = out + static_cast<size_t>(i) * kOut * K + k;
#pragma unroll
  for (int ch = 0; ch < kOut; ++ch) dst[static_cast<size_t>(ch) * K] = o[ch];
}

template <int kCh, bool kTent, bool kUpdate>
void launch(const float* pdata2, const int* counts, const float* grid, float* out,
            int R, int L, int pad, int K, int G, float dx, float dinv, float dinv_dx,
            const Update& up, cudaStream_t stream) {
  const dim3 blocks((K + kThreads - 1) / kThreads, R);
  g2p_kernel<kCh, kTent, kUpdate><<<blocks, kThreads, 0, stream>>>(
      pdata2, counts, grid, out, L, pad, K, G, dx, dinv, dinv_dx, up);
}

}  // namespace

// ch: grid channels (4 or 7; 4 with update); tent: 0 B-spline, 1 tent; L:
// bucket rows per shard (R for one unpadded grid); pad: 0 unpadded (R, ch,
// G), 1 prepadded (R / L, L + 4, ch, G); update: 1 reads (R, 8, K) and
// writes (R, 9, K) with the constants alpha, 1 - alpha and dtv (read only
// then).  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for another ch or an L that does not divide R.
extern "C" int mpm_g2p(const float* pdata2, const int* counts, const float* grid,
                       float* out, int R, int L, int pad, int K, int G, int ch, int tent,
                       float dx, float dinv, float dinv_dx, int update, float alpha,
                       float one_m_alpha, float dtv, void* stream) {
  if ((ch != 4 && ch != 7) || L <= 0 || R % L != 0 || (pad != 0 && pad != 1) ||
      (update && ch != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R > 0 && K > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Update up = {alpha, one_m_alpha, dtv};
    const auto go = [&](auto fn) {
      fn(pdata2, counts, grid, out, R, L, pad, K, G, dx, dinv, dinv_dx, up, s);
    };
    if (update) {
      tent ? go(launch<4, true, true>) : go(launch<4, false, true>);
    } else if (ch == 4) {
      tent ? go(launch<4, true, false>) : go(launch<4, false, false>);
    } else {
      tent ? go(launch<7, true, false>) : go(launch<7, false, false>);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
