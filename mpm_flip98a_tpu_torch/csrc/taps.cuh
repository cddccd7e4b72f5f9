// Stencil taps, the prepped-plane argument block and the per-slot part of
// the prepped scatter, shared by the 3D transfer kernels (p2g3d.cu,
// p2g3d_grid.cu, g2p3d.cu): the quadratic B-spline or, with kTent, the
// linear hat on the same 3-node stencil, in the two forms the TPU kernels
// use (mpm_flip98a_tpu/ops/pallas/transfer2d.py:123-159): per-tap weights
// of the fractional offset on the two bucketed axes, and a weight of the
// signed distance along z.
#pragma once

#include <cuda_runtime.h>

namespace taps {

template <bool kTent>
__device__ __forceinline__ float col(float d) {
  // B-spline 0.5 (1.5-|d|)+^2 - 1.5 (0.5-|d|)+^2 or tent (1-|d|)+.
  const float a = fabsf(d);
  if (kTent) return fmaxf(1.0f - a, 0.0f);
  const float t1 = fmaxf(1.5f - a, 0.0f);
  const float t2 = fmaxf(0.5f - a, 0.0f);
  return 0.5f * t1 * t1 - 1.5f * t2 * t2;
}

template <bool kTent>
__device__ __forceinline__ void axis(float fx, float w[3]) {
  if (kTent) {
    w[0] = fmaxf(0.0f, 1.0f - fx);
    w[1] = 1.0f - fabsf(fx - 1.0f);
    w[2] = fmaxf(0.0f, fx - 1.0f);
  } else {
    w[0] = 0.5f * (1.5f - fx) * (1.5f - fx);
    w[1] = 0.75f - (fx - 1.0f) * (fx - 1.0f);
    w[2] = 0.5f * (fx - 0.5f) * (fx - 0.5f);
  }
}

// Prepped P2G planes in a fixed order, each (R0, R1, K) with its own
// pencil stride (unit along K); a plane the mode does not read is null.
constexpr int kGx = 0;     // gx0, gx1, gx2
constexpr int kMv = 3;     // m v (3)
constexpr int kP = 6;      // P00..P22 = m C (APIC only)
constexpr int kQ = 15;     // Q00..Q22 = P - dt D^-1 tau
constexpr int kM = 24;     // m
constexpr int kExt = 25;   // V0 J, V0, V0 p, V0 div (11-channel mode)
constexpr int kPrepped = 29;

struct Prepped {
  const float* p[kPrepped];
  long long stride[kPrepped];  // pencil stride of each plane, in floats

  __device__ __forceinline__ float at(int e, long long pencil, int k) const {
    return p[e][pencil * stride[e] + k];
  }
};

inline Prepped prepped_from(const void* const* planes, const long long* strides) {
  Prepped in;
  for (int e = 0; e < kPrepped; ++e) {
    in.p[e] = static_cast<const float*>(planes[e]);
    in.stride[e] = strides[e];
  }
  return in;
}

// One slot's prepped values and z taps, as both prepped P2G kernels use
// them: only the target of their adds differs (a shared slab in p2g3d.cu,
// the global raw buffer in p2g3d_grid.cu).
template <int kNch>
struct Slot {
  static constexpr int kPlain = kNch - 6;  // m (+ the 4 ext fields)
  float mv[3], p[9], q[9], plain[kPlain];
  float wz[3], cdz[3];  // z taps: weight, (node - particle) dx
  int z[3];             // z taps: column, -1 outside [0, G2)
};

template <int kNch, bool kTent>
__device__ __forceinline__ void load_slot(const Prepped& in, long long pencil, int k,
                                          int apic, float gx2, float base2, int G2,
                                          float dx, Slot<kNch>& s) {
#pragma unroll
  for (int a = 0; a < 3; ++a) s.mv[a] = in.at(kMv + a, pencil, k);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    s.p[e] = apic ? in.at(kP + e, pencil, k) : 0.0f;
    s.q[e] = in.at(kQ + e, pencil, k);
  }
#pragma unroll
  for (int e = 0; e < Slot<kNch>::kPlain; ++e) s.plain[e] = in.at(kM + e, pencil, k);
#pragma unroll
  for (int j2 = 0; j2 < 3; ++j2) {
    const float cf = base2 + static_cast<float>(j2);
    const float d = cf - gx2;
    s.z[j2] = (cf >= 0.0f && cf < static_cast<float>(G2)) ? static_cast<int>(cf) : -1;
    s.wz[j2] = col<kTent>(d);
    s.cdz[j2] = d * dx;
  }
}

// Momentum of the tap at (rdp0, rdp1) on the bucketed axes, before its z
// term: m v_a + A_a0 rdp0 + A_a1 rdp1 with A = P (pure) or Q (forced).
template <int kNch>
__device__ __forceinline__ void affine01(const Slot<kNch>& s, float rdp0, float rdp1,
                                         float pure[3], float forced[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pure[a] = s.mv[a] + s.p[3 * a] * rdp0 + s.p[3 * a + 1] * rdp1;
    forced[a] = s.mv[a] + s.q[3 * a] * rdp0 + s.q[3 * a + 1] * rdp1;
  }
}

// Adds the kNch channel values of z tap j2, weight w = w0 w1 wz, at
// at[ch * cs]: [m v pure (3), m v forced (3), m (, V0 J, V0, V0 p, V0 div)].
template <int kNch>
__device__ __forceinline__ void add_tap(const Slot<kNch>& s, const float pure[3],
                                        const float forced[3], int j2, float w,
                                        float* at, int cs) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    atomicAdd(at + a * cs, w * (pure[a] + s.p[3 * a + 2] * s.cdz[j2]));
    atomicAdd(at + (3 + a) * cs, w * (forced[a] + s.q[3 * a + 2] * s.cdz[j2]));
  }
#pragma unroll
  for (int e = 0; e < Slot<kNch>::kPlain; ++e) atomicAdd(at + (6 + e) * cs, w * s.plain[e]);
}

}  // namespace taps
