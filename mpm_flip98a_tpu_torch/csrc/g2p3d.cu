// 3D G2P over pencil-bucketed particles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `g2p3d` in
// mpm_flip98a_tpu/ops/pallas/transfer3d.py (def :930, pallas_call :995,
// body _g2p3d_kernel :770 -> _g2p3d_chunk :831) on a grid prepadded on
// both bucketed axes (the wrapper pads an unpadded one), in two modes: the
// update mode (mpm_g2p3d: state given, 6-channel grid, B-spline) and the
// gather mode (mpm_g2p3d_gather: 6 or 9 grid channels, B-spline or tent
// taps).  The TPU kernel gathers along z with one-hot MXU products over
// each of the 25 candidate pencil rows; here each slot reads its 27 nodes
// directly.
//
// Contract of the gather mode (same as the TPU kernel):
//   planes  4 (R0, R1, K) f32 [gx0, gx1, gx2, mask]
//   grid    (R0 + 4, R1 + 4, 6 or 9, G2) f32 = [v_new (3), v_old (3)
//           (, Jbar, p, div)]
//   out     (R0, R1, 15 or 18, K) f32 = [vpic (3), vold (3), C00..C22
//           (, Jbar, p, div)], the weighted sums of the grid channels and
//           C_ab = dinv sum w v_new_a (x_node - x_p)_b dx; zeros in slots
//           past the count, masked off or out of margin.  With tent taps
//           the caller passes dinv = 1 and gets the raw B matrix.
//
// Contract of the update mode (same as the TPU kernel):
//   planes  11 (R0, R1, K) f32 [gx0, gx1, gx2, mask, v0, v1, v2, J, x0,
//           x1, x2], each with its own pencil stride (unit along K)
//   counts  (R0 * R1,) i32 packed pencil counts
//   grid    (R0 + 4, R1 + 4, 6, G2) f32 = [v_new (3), v_old (3)], plane /
//           row j = target row j - 1 on both axes
//   out     (R0, R1, 16, K) f32 = [x (3), v (3), C00..C22, J]
// with w = mask * margin * N(x0) N(x1) N(x2), vpic = sum w v_new,
// vold = sum w v_old, C_ab = D^-1 sum w v_new_a (x_node - x_p)_b dx, then
// x += dt vpic mask, v = (alpha (v + vpic - vold) + (1 - alpha) vpic) mask,
// J = mask > 0 ? J (1 + dt tr C) : 1 (transfer3d.py:895-917).  Slots past
// the count get the dead fill (transfer3d.py:795-821): x passed through
// from the input, v = C = 0, J = 1.
//
// Slab shards (the sharded path's axis-0-padded grid): n shards of L0
// axis-0 rows (n L0 = R0, gx0 local to the shard) read their own window of
// a grid (n, L0 + 4, R1 + 4, gch, G2); one launch covers all shards.
//
// Design: one thread per slot, blocks of kThreads slots inside one pencil.
// Each thread sums its 27 taps in a fixed order (axis 0, 1, then z), so
// the result is deterministic.  Offsets are 64-bit: the output alone has
// R0 R1 16 K elements (5.4e8 at 256^3, K = 512).
//
// What bounds it on the H100: bytes.  Every slot writes 64 bytes (the dead
// headroom slots too, which are most of them at the 8M slab); a live slot
// reads 44 bytes of state and 27 x 6 grid floats (mostly L2 hits: slots of
// one pencil share nodes), for ~30 flops per tap.  Slot reads and output
// writes are coalesced along K.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kNT = 5;
constexpr int kCh = 6;
constexpr int kOut = 16;
constexpr int kIn = 11;
constexpr int kThreads = 128;

struct Planes {
  const float* p[kIn];
  long long stride[kIn];
};

__device__ __forceinline__ float col_weight(float d) {
  const float a = fabsf(d);
  const float t1 = fmaxf(1.5f - a, 0.0f);
  const float t2 = fmaxf(0.5f - a, 0.0f);
  return 0.5f * t1 * t1 - 1.5f * t2 * t2;
}

__device__ __forceinline__ void axis_weights(float fx, float w[3]) {
  w[0] = 0.5f * (1.5f - fx) * (1.5f - fx);
  w[1] = 0.75f - (fx - 1.0f) * (fx - 1.0f);
  w[2] = 0.5f * (fx - 0.5f) * (fx - 0.5f);
}

__global__ void __launch_bounds__(kThreads)
g2p3d_kernel(Planes in, const int* __restrict__ counts,
             const float* __restrict__ grid, float* __restrict__ out, int L0, int R1,
             int K, int kblocks, int G2, float dx, float dinv, float alpha,
             float one_m_alpha, float dtv) {
  const long long pencil = blockIdx.x / kblocks;
  const int k = (blockIdx.x % kblocks) * kThreads + threadIdx.x;
  if (k >= K) return;
  float* o = out + pencil * kOut * K + k;
  const float x0 = in.p[8][pencil * in.stride[8] + k];
  const float x1 = in.p[9][pencil * in.stride[9] + k];
  const float x2 = in.p[10][pencil * in.stride[10] + k];
  if (k >= counts[pencil]) {  // dead slot
    o[0] = x0;
    o[static_cast<long long>(K)] = x1;
    o[2LL * K] = x2;
#pragma unroll
    for (int ch = 3; ch < kOut - 1; ++ch) o[static_cast<long long>(ch) * K] = 0.0f;
    o[15LL * K] = 1.0f;
    return;
  }
  const int shard = static_cast<int>(pencil / R1) / L0;
  const int i0 = static_cast<int>(pencil / R1) - shard * L0;  // row in the shard
  const int i1 = static_cast<int>(pencil % R1);
  const float gx0 = in.p[0][pencil * in.stride[0] + k];
  const float gx1 = in.p[1][pencil * in.stride[1] + k];
  const float gx2 = in.p[2][pencil * in.stride[2] + k];
  const float mask = in.p[3][pencil * in.stride[3] + k];
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
  const float rel0 = base0 - static_cast<float>(i0);
  const float rel1 = base1 - static_cast<float>(i1);
  const bool margin = rel0 >= -1.0f && rel0 <= 1.0f && rel1 >= -1.0f && rel1 <= 1.0f;
  const float valid = margin ? mask : 0.0f;

  float vpic[3] = {0.0f, 0.0f, 0.0f}, vold[3] = {0.0f, 0.0f, 0.0f};
  float cs[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (valid != 0.0f) {
    float w0[3], w1[3];
    axis_weights(gx0 - base0, w0);
    axis_weights(gx1 - base1, w1);
    const float base2 = floorf(gx2 - 0.5f);
    const long long P1 = R1 + kNT - 1;
    const long long q0 = static_cast<long long>(shard) * (L0 + kNT - 1) + i0 +
                         static_cast<int>(rel0) + 1;
    const long long q1 = i1 + static_cast<int>(rel1) + 1;
#pragma unroll
    for (int j0 = 0; j0 < 3; ++j0) {
      const float rdp0 = (base0 + static_cast<float>(j0) - gx0) * dx;
#pragma unroll
      for (int j1 = 0; j1 < 3; ++j1) {
        const float rdp1 = (base1 + static_cast<float>(j1) - gx1) * dx;
        const float w01 = w0[j0] * valid * w1[j1];
        const float* node = grid + ((q0 + j0) * P1 + (q1 + j1)) * kCh * G2;
#pragma unroll
        for (int j2 = 0; j2 < 3; ++j2) {
          const float cf = base2 + static_cast<float>(j2);
          if (!(cf >= 0.0f && cf < static_cast<float>(G2))) continue;
          const float d = cf - gx2;
          const float w = w01 * col_weight(d);
          const float* g = node + static_cast<int>(cf);
          const float dxs[3] = {rdp0, rdp1, d * dx};
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float vn = g[a * G2];
            vpic[a] += w * vn;
            vold[a] += w * g[(3 + a) * G2];
            const float wv = w * vn;
#pragma unroll
            for (int b = 0; b < 3; ++b) cs[3 * a + b] += wv * dxs[b];
          }
        }
      }
    }
  }
  float cm[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) cm[e] = dinv * cs[e];
  const float xs[3] = {x0, x1, x2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float vprev = in.p[4 + a][pencil * in.stride[4 + a] + k];
    o[static_cast<long long>(a) * K] = xs[a] + dtv * vpic[a] * mask;
    o[static_cast<long long>(3 + a) * K] =
        (alpha * (vprev + vpic[a] - vold[a]) + one_m_alpha * vpic[a]) * mask;
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) o[static_cast<long long>(6 + e) * K] = cm[e];
  const float jprev = in.p[7][pencil * in.stride[7] + k];
  const float div = cm[0] + cm[4] + cm[8];
  o[15LL * K] = mask > 0.0f ? jprev * (1.0f + dtv * div) : 1.0f;
}

// Gather mode: the raw gathers of kGch grid channels, no particle update.
template <int kGch, bool kTent>
__global__ void __launch_bounds__(kThreads)
g2p3d_gather_kernel(Planes in, const int* __restrict__ counts,
                    const float* __restrict__ grid, float* __restrict__ out,
                    int L0, int R1, int K, int kblocks, int G2, float dx, float dinv) {
  constexpr int kExtra = kGch - kCh;     // Jbar, p, div
  constexpr int kNout = 15 + kExtra;
  const long long pencil = blockIdx.x / kblocks;
  const int k = (blockIdx.x % kblocks) * kThreads + threadIdx.x;
  if (k >= K) return;
  float* o = out + pencil * kNout * K + k;
  float valid = 0.0f, gx0 = 0.0f, gx1 = 0.0f, base0 = 0.0f, base1 = 0.0f;
  float rel0 = 0.0f, rel1 = 0.0f;
  const int shard = static_cast<int>(pencil / R1) / L0;
  const int i0 = static_cast<int>(pencil / R1) - shard * L0;  // row in the shard
  const int i1 = static_cast<int>(pencil % R1);
  if (k < counts[pencil]) {
    gx0 = in.p[0][pencil * in.stride[0] + k];
    gx1 = in.p[1][pencil * in.stride[1] + k];
    base0 = floorf(gx0 - 0.5f);
    base1 = floorf(gx1 - 0.5f);
    rel0 = base0 - static_cast<float>(i0);
    rel1 = base1 - static_cast<float>(i1);
    const bool margin = rel0 >= -1.0f && rel0 <= 1.0f && rel1 >= -1.0f && rel1 <= 1.0f;
    valid = margin ? in.p[3][pencil * in.stride[3] + k] : 0.0f;
  }
  float sum[kGch], cs[9];
#pragma unroll
  for (int e = 0; e < kGch; ++e) sum[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 9; ++e) cs[e] = 0.0f;
  if (valid != 0.0f) {
    const float gx2 = in.p[2][pencil * in.stride[2] + k];
    float w0[3], w1[3];
    taps::axis<kTent>(gx0 - base0, w0);
    taps::axis<kTent>(gx1 - base1, w1);
    const float base2 = floorf(gx2 - 0.5f);
    const long long P1 = R1 + kNT - 1;
    const long long q0 = static_cast<long long>(shard) * (L0 + kNT - 1) + i0 +
                         static_cast<int>(rel0) + 1;
    const long long q1 = i1 + static_cast<int>(rel1) + 1;
#pragma unroll
    for (int j0 = 0; j0 < 3; ++j0) {
      const float rdp0 = (base0 + static_cast<float>(j0) - gx0) * dx;
#pragma unroll
      for (int j1 = 0; j1 < 3; ++j1) {
        const float rdp1 = (base1 + static_cast<float>(j1) - gx1) * dx;
        const float w01 = w0[j0] * valid * w1[j1];
        const float* node = grid + ((q0 + j0) * P1 + (q1 + j1)) * kGch * G2;
#pragma unroll
        for (int j2 = 0; j2 < 3; ++j2) {
          const float cf = base2 + static_cast<float>(j2);
          if (!(cf >= 0.0f && cf < static_cast<float>(G2))) continue;
          const float d = cf - gx2;
          const float w = w01 * taps::col<kTent>(d);
          const float* g = node + static_cast<int>(cf);
          const float dxs[3] = {rdp0, rdp1, d * dx};
#pragma unroll
          for (int e = 0; e < kGch; ++e) {
            const float ge = g[e * G2];
            sum[e] += w * ge;
            if (e < 3) {
              const float wv = w * ge;
#pragma unroll
              for (int b = 0; b < 3; ++b) cs[3 * e + b] += wv * dxs[b];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kCh; ++e) o[static_cast<long long>(e) * K] = sum[e];
#pragma unroll
  for (int e = 0; e < 9; ++e) o[static_cast<long long>(kCh + e) * K] = dinv * cs[e];
#pragma unroll
  for (int e = 0; e < kExtra; ++e) o[static_cast<long long>(15 + e) * K] = sum[kCh + e];
}

template <int kGch, bool kTent>
void launch_gather(const Planes& in, const int* counts, const float* grid, float* out,
                   unsigned blocks, int L0, int R1, int K, int kblocks, int G2, float dx,
                   float dinv, cudaStream_t s) {
  g2p3d_gather_kernel<kGch, kTent><<<blocks, kThreads, 0, s>>>(
      in, counts, grid, out, L0, R1, K, kblocks, G2, dx, dinv);
}

}  // namespace

// Gather mode.  planes / strides: [gx0, gx1, gx2, mask]; gch: 6 or 9 grid
// channels (15 or 18 outputs); tent: 0/1; L0: axis-0 rows per shard (R0
// for one device).  Returns a cudaError_t as int.
extern "C" int mpm_g2p3d_gather(const void* const* planes, const long long* strides,
                                const int* counts, const float* grid, float* out,
                                int R0, int L0, int R1, int K, int G2, int gch, int tent,
                                float dx, float dinv, void* stream) {
  if ((gch != 6 && gch != 9) || L0 <= 0 || R0 % L0 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes in = {};
  for (int e = 0; e < 4; ++e) {
    in.p[e] = static_cast<const float*>(planes[e]);
    in.stride[e] = strides[e];
  }
  const int kblocks = (K + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(R0) * R1 * kblocks;
  if (blocks > 0) {
    const unsigned nb = static_cast<unsigned>(blocks);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (gch == 6) {
      if (tent) launch_gather<6, true>(in, counts, grid, out, nb, L0, R1, K, kblocks, G2, dx, dinv, s);
      else launch_gather<6, false>(in, counts, grid, out, nb, L0, R1, K, kblocks, G2, dx, dinv, s);
    } else {
      if (tent) launch_gather<9, true>(in, counts, grid, out, nb, L0, R1, K, kblocks, G2, dx, dinv, s);
      else launch_gather<9, false>(in, counts, grid, out, nb, L0, R1, K, kblocks, G2, dx, dinv, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpm_g2p3d(const void* const* planes, const long long* strides,
                         const int* counts, const float* grid, float* out, int R0,
                         int L0, int R1, int K, int G2, float dx, float dinv, float alpha,
                         float one_m_alpha, float dtv, void* stream) {
  if (L0 <= 0 || R0 % L0 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Planes in;
  for (int e = 0; e < kIn; ++e) {
    in.p[e] = static_cast<const float*>(planes[e]);
    in.stride[e] = strides[e];
  }
  const int kblocks = (K + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(R0) * R1 * kblocks;
  if (blocks > 0) {
    g2p3d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        in, counts, grid, out, L0, R1, K, kblocks, G2, dx, dinv, alpha, one_m_alpha,
        dtv);
  }
  return static_cast<int>(cudaGetLastError());
}
