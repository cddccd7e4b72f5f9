// 3D P2G + grid update over pencil-bucketed particles, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `p2g3d_grid` in
// mpm_flip98a_tpu/ops/pallas/transfer3d.py (def :622, pallas_call :709,
// body _p2g3d_grid_kernel :428 -> _p2g3d_chunk :193), in two modes: the
// stress mode (mpm_p2g3d_grid: the fluid stress computed per slot,
// B-spline, 7 raw channels) and the prepped mode (mpm_p2g3d_grid_pdata:
// stress=None, PIC or APIC, B-spline or tent taps, and with 11 raw channels
// the nodal Jbar, p and div of `ext`); both with the rigid SDF colliders of
// the TPU kernel's node pass (transfer3d.py:548-570), static or kinematic.
// The TPU kernel scatters along z with one-hot MXU products and carries
// target rows from one sequential grid step to the next in a rolling
// 5-slot VMEM scratch; GPU blocks run in no order, so that design does
// not carry over.
//
// Contract (same as the TPU kernel):
//   planes  stress mode: 18 (R0, R1, K) f32 [gx0, gx1, gx2, v0, v1, v2,
//           C00..C22, J, mass, vol0]; prepped mode: the fields in the
//           fixed order of taps.cuh [gx (3), m v (3), P (9, APIC only),
//           Q (9), m (, V0 J, V0, V0 p, V0 div)], value planes pre-masked;
//           each plane with its own pencil stride (unit along K)
//   counts  (R0 * R1,) i32 packed pencil counts (active slots first)
//   out     (R0 + 4, R1 + 4, 6 or 9, G2) f32 = [v_new (3), v_old (3)
//           (, Jbar, p, div)], plane / row j = target row j - 1 on both
//           bucketed axes; Jbar = sum V0 J / sum V0 where volume landed,
//           else 1 on interior axis-0 rows and 0 on the pad rows; p and
//           div likewise with 0
// Raw mode (transfer3d.py:484-489, the slab-sharded path's): n slab
// shards of L0 axis-0 rows each (n L0 = R0, gx0 local to the shard); the
// scatter alone, into the raw sums (n, L0 + 4, R1 + 4, 7 or 11, G2), row
// j of shard s its local target row j - 1, uncropped on both axes; one
// launch covers all shards, and the update launch is skipped.
// A slot contributes only when its base row on both axes is within +-1 of
// its pencil's; z taps outside [0, G2) are dropped.  Axis-0 target rows
// outside [0, R0) come out zero (the TPU kernel's `interior` crop); the
// axis-1 pad rows keep their sums, as in the TPU kernel.
//
// Design: two launches.
//   1. scatter: one thread per slot, blocks of kThreads slots inside one
//      pencil (a block past the pencil's count returns at once).  The
//      thread computes the fluid stress in registers and adds its 27 taps
//      x 7 channels [m v pure (3), m v forced (3), m] with float atomics
//      into a zeroed raw buffer (R0 + 4, R1 + 4, 7, G2).  Every pencil
//      scatters to 25 target pencils, so a block cannot own its output as
//      the 2D kernel's does.  The prepped mode reads P, Q, m and the ext
//      fields instead of computing them (7 or 11 channels).
//   2. update: one thread per node of the padded grid: mass floor,
//      v_old = pure / m, v_new = forced / m + dt g (or the diagonal
//      penalty solve), then slip clamps or the sticky zero on the wall
//      bands of the three axes, then the colliders' projection of v_new
//      (models/colliders.project) on interior rows, then the ext averages.
// Colliders: at most kMaxColliders, passed by value in the update launch's
// parameters as a __grid_constant__ struct (no device buffer, no copy).
// The inside test phi <= 0 is a discontinuity: a node whose phi rounds to
// the other side of 0 differs from the plain version by a whole velocity.
// So phi, the normal and the kinematic center are computed with
// round-to-nearest intrinsics (no FMA contraction), one rounding per
// operation in the order of the reference's expressions
// (colliders.py:94-204), as PyTorch's elementwise ops round them.  `kin` =
// 0 (no moving collider, or no time) leaves every center where the host
// put it, bit for bit a time-free build; the host casts the constants to
// float32 as JAX does.  The projection costs about 30 flops and no bytes
// per node.
// Float atomics add in a run-dependent order: the result is not bitwise
// deterministic (the JAX kernel is); it agrees with the plain version to
// fp32 rounding of each node's sum (the tolerance is stated where the two
// are compared).  Offsets are 64-bit: R0 R1 K passes 2^31 at 256^3.
//
// What bounds it on the H100: the atomics and bytes, not flops.  A live
// slot reads 72 bytes and issues 189 atomic adds (~30 flops per tap);
// the update reads 7 and writes 6 floats per node of the padded grid.  The
// prepped ext mode reads 80 (PIC) or 116 (APIC) bytes per live slot and
// issues 297 atomic adds; its update reads 11 and writes 9 floats per node.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kNT = 5;        // candidate target rows per bucketed axis
constexpr int kRaw = 7;       // raw channels (11 with the ext fields)
constexpr int kIn = 18;       // input planes of the stress mode
constexpr int kThreads = 128; // slots per block (K is a multiple of 128)
constexpr int kMaxColliders = 8;
constexpr int kColF = 19;     // floats per collider in the host arrays
constexpr int kColI = 4;      // ints per collider in the host arrays

struct Collider {
  int kind;          // 0 sphere, 1 box, 2 halfspace
  int sticky;
  int moving;        // center advances by cvel * t in a kinematic launch
  int spin;          // the angular velocity applies
  float center[3];
  float cvel[3];
  float radius;
  float half[3];     // box half-extents
  float normal[3];   // halfspace unit normal (normalised in float64)
  float vsurf[3];    // f32(velocity) + f32(center_velocity)
  float omega[3];    // (wx, wy, wz)
};

struct Colliders {
  int n;             // 0: the node pass has no projection
  int kin;           // 1: moving centers at time t
  float t;
  Collider c[kMaxColliders];
};

struct Planes {
  const float* p[kIn];
  long long stride[kIn];  // pencil stride of each plane, in floats
};

__device__ __forceinline__ float col_weight(float d) {
  // 0.5 (1.5-|d|)+^2 - 1.5 (0.5-|d|)+^2: the quadratic B-spline as a
  // function of the signed distance (transfer2d.py:147-159).
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
p2g3d_scatter_kernel(Planes in, const int* __restrict__ counts,
                     float* __restrict__ raw, int L0, int R1, int K, int kblocks,
                     int G2, float dx, int apic, int tait, float kb,
                     float kb_over_gamma, float gamma, float two_mu,
                     float fa) {
  const long long pencil = blockIdx.x / kblocks;
  const int k = (blockIdx.x % kblocks) * kThreads + threadIdx.x;
  if (k >= K || k >= counts[pencil]) return;
  const int shard = static_cast<int>(pencil / R1) / L0;
  const int i0 = static_cast<int>(pencil / R1) - shard * L0;  // row in the shard
  const int i1 = static_cast<int>(pencil % R1);
  float f[kIn];
#pragma unroll
  for (int e = 0; e < kIn; ++e) f[e] = in.p[e][pencil * in.stride[e] + k];
  const float gx0 = f[0], gx1 = f[1], gx2 = f[2];
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
  const float rel0 = base0 - static_cast<float>(i0);
  const float rel1 = base1 - static_cast<float>(i1);
  if (!(rel0 >= -1.0f && rel0 <= 1.0f && rel1 >= -1.0f && rel1 <= 1.0f)) return;

  // Weakly-compressible fluid stress (transfer3d.py:208-236).
  const float* c = f + 6;
  const float jj = f[15], mass = f[16], vol0 = f[17];
  float pressure;
  if (tait) {
    const float j_safe = fmaxf(jj, 1e-3f);
    pressure = kb_over_gamma * (powf(1.0f / j_safe, gamma) - 1.0f);
  } else {
    pressure = -kb * (jj - 1.0f);
  }
  const float divc = c[0] + c[4] + c[8];
  const float vj = vol0 * jj;
  float p[9], q[9], mv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mv[a] = mass * f[3 + a];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float dev = 0.5f * (c[3 * a + b] + c[3 * b + a]);
      float tau;
      if (a == b) {
        dev -= divc / 3.0f;
        tau = vj * (-pressure + two_mu * dev);
      } else {
        tau = vj * (two_mu * dev);
      }
      p[3 * a + b] = apic ? mass * c[3 * a + b] : 0.0f;
      q[3 * a + b] = p[3 * a + b] + fa * tau;
    }
  }

  float w0[3], w1[3];
  axis_weights(gx0 - base0, w0);
  axis_weights(gx1 - base1, w1);
  const float base2 = floorf(gx2 - 0.5f);
  float wz[3], cdz[3];
  int z[3];
#pragma unroll
  for (int j2 = 0; j2 < 3; ++j2) {
    const float cf = base2 + static_cast<float>(j2);
    const float d = cf - gx2;
    z[j2] = (cf >= 0.0f && cf < static_cast<float>(G2)) ? static_cast<int>(cf) : -1;
    wz[j2] = col_weight(d);
    cdz[j2] = d * dx;
  }
  const long long P1 = R1 + kNT - 1;
  // Padded plane of tap j: bucket row + rel + j + 1 on each axis, in the
  // shard's window of L0 + 4 planes.
  const long long q0 = static_cast<long long>(shard) * (L0 + kNT - 1) + i0 +
                       static_cast<int>(rel0) + 1;
  const long long q1 = i1 + static_cast<int>(rel1) + 1;
#pragma unroll
  for (int j0 = 0; j0 < 3; ++j0) {
    const float rdp0 = (base0 + static_cast<float>(j0) - gx0) * dx;
#pragma unroll
    for (int j1 = 0; j1 < 3; ++j1) {
      const float rdp1 = (base1 + static_cast<float>(j1) - gx1) * dx;
      const float w01 = w0[j0] * w1[j1];
      float pure[3], forced[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        pure[a] = mv[a] + p[3 * a] * rdp0 + p[3 * a + 1] * rdp1;
        forced[a] = mv[a] + q[3 * a] * rdp0 + q[3 * a + 1] * rdp1;
      }
      float* node = raw + ((q0 + j0) * P1 + (q1 + j1)) * kRaw * G2;
#pragma unroll
      for (int j2 = 0; j2 < 3; ++j2) {
        if (z[j2] < 0) continue;
        const float w = w01 * wz[j2];
        float* at = node + z[j2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          atomicAdd(at + a * G2, w * (pure[a] + p[3 * a + 2] * cdz[j2]));
          atomicAdd(at + (3 + a) * G2, w * (forced[a] + q[3 * a + 2] * cdz[j2]));
        }
        atomicAdd(at + 6 * G2, w * mass);
      }
    }
  }
}

// Prepped mode: the same scatter of fields computed outside the kernel.
template <int kNch, bool kTent>
__global__ void __launch_bounds__(kThreads)
p2g3d_scatter_pdata_kernel(taps::Prepped in, const int* __restrict__ counts,
                           float* __restrict__ raw, int L0, int R1, int K, int kblocks,
                           int G2, float dx, int apic) {
  const long long pencil = blockIdx.x / kblocks;
  const int k = (blockIdx.x % kblocks) * kThreads + threadIdx.x;
  if (k >= K || k >= counts[pencil]) return;
  const int shard = static_cast<int>(pencil / R1) / L0;
  const int i0 = static_cast<int>(pencil / R1) - shard * L0;  // row in the shard
  const int i1 = static_cast<int>(pencil % R1);
  const float gx0 = in.at(taps::kGx, pencil, k);
  const float gx1 = in.at(taps::kGx + 1, pencil, k);
  const float gx2 = in.at(taps::kGx + 2, pencil, k);
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
  const float rel0 = base0 - static_cast<float>(i0);
  const float rel1 = base1 - static_cast<float>(i1);
  if (!(rel0 >= -1.0f && rel0 <= 1.0f && rel1 >= -1.0f && rel1 <= 1.0f)) return;

  const float base2 = floorf(gx2 - 0.5f);
  taps::Slot<kNch> slot;
  taps::load_slot<kNch, kTent>(in, pencil, k, apic, gx2, base2, G2, dx, slot);
  float w0[3], w1[3];
  taps::axis<kTent>(gx0 - base0, w0);
  taps::axis<kTent>(gx1 - base1, w1);
  const long long P1 = R1 + kNT - 1;
  // Padded plane of tap j: bucket row + rel + j + 1 on each axis, in the
  // shard's window of L0 + 4 planes.
  const long long q0 = static_cast<long long>(shard) * (L0 + kNT - 1) + i0 +
                       static_cast<int>(rel0) + 1;
  const long long q1 = i1 + static_cast<int>(rel1) + 1;
#pragma unroll
  for (int j0 = 0; j0 < 3; ++j0) {
    const float rdp0 = (base0 + static_cast<float>(j0) - gx0) * dx;
#pragma unroll
    for (int j1 = 0; j1 < 3; ++j1) {
      const float rdp1 = (base1 + static_cast<float>(j1) - gx1) * dx;
      const float w01 = w0[j0] * w1[j1];
      float pure[3], forced[3];
      taps::affine01(slot, rdp0, rdp1, pure, forced);
      float* node = raw + ((q0 + j0) * P1 + (q1 + j1)) * kNch * G2;
#pragma unroll
      for (int j2 = 0; j2 < 3; ++j2) {
        if (slot.z[j2] < 0) continue;
        taps::add_tap(slot, pure, forced, j2, w01 * slot.wz[j2], node + slot.z[j2], G2);
      }
    }
  }
}

// colliders.project at node x, one collider after the other: phi (sphere,
// box, halfspace) and, for phi <= 0, the slip or sticky projection relative
// to the surface velocity (+ omega x r).  The outward normal is computed
// only where a slip surface needs it: the same values as the reference's,
// which computes it everywhere and discards it outside.
__device__ __forceinline__ void project_colliders(const Colliders& cs, const float x[3],
                                                  float v[3]) {
  for (int i = 0; i < cs.n; ++i) {
    const Collider& c = cs.c[i];
    float diff[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ctr = (cs.kin && c.moving) ? __fadd_rn(c.center[a], __fmul_rn(c.cvel[a], cs.t))
                                             : c.center[a];
      diff[a] = __fsub_rn(x[a], ctr);
    }
    float phi, r = 0.0f, q[3], qp[3], out_len = 0.0f, qmax = 0.0f;
    if (c.kind == 0) {  // sphere
      r = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(diff[0], diff[0]), __fmul_rn(diff[1], diff[1])),
                               __fmul_rn(diff[2], diff[2])));
      phi = __fsub_rn(r, c.radius);
    } else if (c.kind == 1) {  // axis-aligned box, exact SDF
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q[a] = __fsub_rn(fabsf(diff[a]), c.half[a]);
        qp[a] = fmaxf(q[a], 0.0f);
      }
      out_len = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(qp[0], qp[0]), __fmul_rn(qp[1], qp[1])),
                                     __fmul_rn(qp[2], qp[2])));
      qmax = fmaxf(fmaxf(q[0], q[1]), q[2]);
      phi = __fadd_rn(out_len, fminf(qmax, 0.0f));
    } else {  // halfspace: phi = n . (x - p)
      phi = __fadd_rn(__fadd_rn(__fmul_rn(c.normal[0], diff[0]), __fmul_rn(c.normal[1], diff[1])),
                      __fmul_rn(c.normal[2], diff[2]));
    }
    if (!(phi <= 0.0f)) continue;
    float vs[3] = {c.vsurf[0], c.vsurf[1], c.vsurf[2]};
    if (c.spin) {  // v_surface += omega x (x - center(t)); diff is x - center(t)
      const float* w = c.omega;
      vs[0] = __fsub_rn(__fadd_rn(vs[0], __fmul_rn(w[1], diff[2])), __fmul_rn(w[2], diff[1]));
      vs[1] = __fsub_rn(__fadd_rn(vs[1], __fmul_rn(w[2], diff[0])), __fmul_rn(w[0], diff[2]));
      vs[2] = __fsub_rn(__fadd_rn(vs[2], __fmul_rn(w[0], diff[1])), __fmul_rn(w[1], diff[0]));
    }
    if (c.sticky) {
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = vs[a];
      continue;
    }
    float n[3];
    if (c.kind == 0) {
      const float r_safe = fmaxf(r, 1e-12f);
#pragma unroll
      for (int a = 0; a < 3; ++a) n[a] = __fdiv_rn(diff[a], r_safe);
    } else if (c.kind == 1) {
      // Inside: the nearest face's axis (one-hot on argmax q, ties at edges
      // share it); outside: from the closest surface point.
      const bool inside = qmax <= 0.0f;
      const float safe_out = fmaxf(out_len, 1e-12f);
      float face[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) face[a] = q[a] >= qmax ? 1.0f : 0.0f;
      const float face_n = __fsqrt_rn(face[0] + face[1] + face[2]);  // sqrt(1 | 2 | 3)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float sgn = diff[a] >= 0.0f ? 1.0f : -1.0f;
        n[a] = inside ? __fdiv_rn(sgn * face[a], face_n) : __fdiv_rn(sgn * qp[a], safe_out);
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) n[a] = c.normal[a];
    }
    float vrel[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) vrel[a] = __fsub_rn(v[a], vs[a]);
    const float vn = __fadd_rn(__fadd_rn(__fmul_rn(vrel[0], n[0]), __fmul_rn(vrel[1], n[1])),
                               __fmul_rn(vrel[2], n[2]));
    const float approach = fminf(vn, 0.0f);
#pragma unroll
    for (int a = 0; a < 3; ++a) v[a] = __fadd_rn(__fsub_rn(vrel[a], __fmul_rn(approach, n[a])), vs[a]);
  }
}

// kExt: 11 raw channels in, 9 out (+ the nodal Jbar, p, div); else 7 and 6.
template <bool kExt>
__global__ void __launch_bounds__(256)
p2g3d_update_kernel(const float* __restrict__ raw, float* __restrict__ out,
                    long long nodes, int R0, int P1, int G2, float dtg0,
                    float dtg1, float dtg2, float floor_m, int lo, int hi,
                    int wall, float dt_beta, float dx,
                    const __grid_constant__ Colliders cols) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= nodes) return;
  constexpr int kRaw = kExt ? 11 : 7;
  constexpr int kOut = kExt ? 9 : 6;
  const int zc = static_cast<int>(n % G2);
  const long long plane = n / G2;               // p0 * P1 + p1
  const int t0 = static_cast<int>(plane / P1) - 1;   // target rows
  const int t1 = static_cast<int>(plane % P1) - 1;
  const float* r = raw + plane * kRaw * G2 + zc;
  float* o = out + plane * kOut * G2 + zc;
  const bool interior = t0 >= 0 && t0 < R0;
  const float m = r[6 * G2];
  const bool has = m > floor_m && interior;
  const float safe = has ? m : 1.0f;
  const bool lo0 = t0 <= lo && interior, hi0 = t0 >= hi;
  const bool lo1 = t1 <= lo, hi1 = t1 >= hi;
  const bool lo2 = zc <= lo, hi2 = zc >= hi;
  const float dtg[3] = {dtg0, dtg1, dtg2};
  float v[3];
  if (wall == 2) {  // penalty: (m I + dt beta n(x)n) v = m v* + dt m g, diagonal
    const bool band[3] = {lo0 || hi0, lo1 || hi1, lo2 || hi2};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pen = band[a] ? 1.0f : 0.0f;
      v[a] = has ? (r[(3 + a) * G2] + dtg[a] * m) / (m + dt_beta * pen) : 0.0f;
    }
  } else {
    const float hasf = has ? 1.0f : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) v[a] = (has ? r[(3 + a) * G2] / safe : 0.0f) + dtg[a] * hasf;
    if (wall == 1) {  // sticky
      if (lo0 || hi0 || lo1 || hi1 || lo2 || hi2) v[0] = v[1] = v[2] = 0.0f;
    } else {          // slip: clamp the outgoing normal component per band
      if (lo0) v[0] = fmaxf(v[0], 0.0f);
      if (hi0) v[0] = fminf(v[0], 0.0f);
      if (lo1) v[1] = fmaxf(v[1], 0.0f);
      if (hi1) v[1] = fminf(v[1], 0.0f);
      if (lo2) v[2] = fmaxf(v[2], 0.0f);
      if (hi2) v[2] = fminf(v[2], 0.0f);
    }
  }
  // Colliders, after the walls; the axis-1 pad rows and the rows outside
  // [0, R0) keep the wall result (transfer3d.py:567-570's `keep`).
  if (cols.n > 0 && interior && t1 >= 0 && t1 < P1 - (kNT - 1)) {
    const float x[3] = {
        __fmul_rn(__fsub_rn(static_cast<float>(t0), static_cast<float>(lo)), dx),
        __fmul_rn(__fsub_rn(static_cast<float>(t1), static_cast<float>(lo)), dx),
        __fmul_rn(__fsub_rn(static_cast<float>(zc), static_cast<float>(lo)), dx),
    };
    project_colliders(cols, x, v);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a * G2] = v[a];
    o[(3 + a) * G2] = has ? r[a * G2] / safe : 0.0f;
  }
  if (kExt) {
    // Nodal averages over the scattered volume (transfer3d.py:574-585).
    const float v0sum = r[8 * G2];
    const bool has_v = v0sum > 0.0f && interior;
    const float safe_v = has_v ? v0sum : 1.0f;
    o[6 * G2] = has_v ? r[7 * G2] / safe_v : (interior ? 1.0f : 0.0f);
    o[7 * G2] = has_v ? r[9 * G2] / safe_v : 0.0f;
    o[8 * G2] = has_v ? r[10 * G2] / safe_v : 0.0f;
  }
}

template <bool kExt>
int launch_update(const float* raw, float* out, long long nodes, int R0, int P1,
                  int G2, float dtg0, float dtg1, float dtg2, float floor_m, int lo,
                  int hi, int wall, float dt_beta, float dx, const Colliders& cols,
                  cudaStream_t s) {
  if (nodes > 0) {
    const long long ublocks = (nodes + 255) / 256;
    p2g3d_update_kernel<kExt><<<static_cast<unsigned>(ublocks), 256, 0, s>>>(
        raw, out, nodes, R0, P1, G2, dtg0, dtg1, dtg2, floor_m, lo, hi, wall,
        dt_beta, dx, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

// The host arrays of the C entry points -> the launch's Colliders: per
// collider kColF floats [center (3), center velocity (3), radius,
// half-extents (3), unit normal (3), surface velocity (3), omega (3)] and
// kColI ints [kind, sticky, moving, spin].  False when n is out of range.
bool unpack_colliders(const float* col_f, const int* col_i, int n, int kin, float t,
                      Colliders* cols) {
  if (n < 0 || n > kMaxColliders || (n > 0 && (col_f == nullptr || col_i == nullptr))) {
    return false;
  }
  cols->n = n;
  cols->kin = kin;
  cols->t = t;
  for (int i = 0; i < n; ++i) {
    const float* f = col_f + i * kColF;
    const int* k = col_i + i * kColI;
    Collider& c = cols->c[i];
    c.kind = k[0];
    c.sticky = k[1];
    c.moving = k[2];
    c.spin = k[3];
    for (int a = 0; a < 3; ++a) {
      c.center[a] = f[a];
      c.cvel[a] = f[3 + a];
      c.half[a] = f[7 + a];
      c.normal[a] = f[10 + a];
      c.vsurf[a] = f[13 + a];
      c.omega[a] = f[16 + a];
    }
    c.radius = f[6];
  }
  return true;
}

template <int kNch, bool kTent>
void launch_pdata_scatter(const taps::Prepped& in, const int* counts, float* raw,
                          unsigned blocks, int L0, int R1, int K, int kblocks, int G2,
                          float dx, int apic, cudaStream_t s) {
  p2g3d_scatter_pdata_kernel<kNch, kTent><<<blocks, kThreads, 0, s>>>(
      in, counts, raw, L0, R1, K, kblocks, G2, dx, apic);
}

}  // namespace

// L0: axis-0 rows per shard (R0 for one device); raw_only: 1 stops after
// the scatter (the raw mode: `out` is unused, R0 / L0 shards), 0 runs the
// update too (then L0 must be R0).  col_f, col_i: host arrays of ncol
// colliders (see unpack_colliders; the raw mode takes none); kin: 1 puts
// the moving ones at time tcol.
extern "C" int mpm_p2g3d_grid(const void* const* planes, const long long* strides,
                              const int* counts, float* raw, float* out, int R0,
                              int L0, int R1, int K, int G2, float dx, int apic, int tait,
                              float kb, float kb_over_gamma, float gamma,
                              float two_mu, float fa, float dtg0, float dtg1,
                              float dtg2, float floor_m, int lo, int hi, int wall,
                              float dt_beta, const float* col_f, const int* col_i,
                              int ncol, int kin, float tcol, int raw_only, void* stream) {
  Colliders cols{};
  if (L0 <= 0 || R0 % L0 != 0 || (!raw_only && L0 != R0) || (raw_only && ncol != 0) ||
      !unpack_colliders(col_f, col_i, ncol, kin, tcol, &cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Planes in;
  for (int e = 0; e < kIn; ++e) {
    in.p[e] = static_cast<const float*>(planes[e]);
    in.stride[e] = strides[e];
  }
  const int P1 = R1 + kNT - 1;
  const long long nodes = static_cast<long long>(R0 / L0) * (L0 + kNT - 1) * P1 * G2;
  cudaError_t err = cudaMemsetAsync(raw, 0, sizeof(float) * kRaw * nodes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kblocks = (K + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(R0) * R1 * kblocks;
  if (blocks > 0) {
    p2g3d_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in, counts, raw, L0, R1, K, kblocks, G2, dx, apic, tait, kb, kb_over_gamma,
        gamma, two_mu, fa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (raw_only) return static_cast<int>(cudaGetLastError());
  return launch_update<false>(raw, out, nodes, R0, P1, G2, dtg0, dtg1, dtg2,
                              floor_m, lo, hi, wall, dt_beta, dx, cols, s);
}

// Prepped mode.  planes / strides: 29 entries in the order of taps.cuh
// (null where the mode has no such plane); nch: 7, or 11 with the ext
// fields (then out has 9 channels); apic, tent: 0/1; L0, the colliders and
// raw_only as in mpm_p2g3d_grid.
extern "C" int mpm_p2g3d_grid_pdata(const void* const* planes, const long long* strides,
                                    const int* counts, float* raw, float* out, int R0,
                                    int L0, int R1, int K, int G2, int nch, int apic,
                                    int tent, float dx, float dtg0, float dtg1, float dtg2,
                                    float floor_m, int lo, int hi, int wall,
                                    float dt_beta, const float* col_f, const int* col_i,
                                    int ncol, int kin, float tcol, int raw_only,
                                    void* stream) {
  if (nch != 7 && nch != 11) return static_cast<int>(cudaErrorInvalidValue);
  Colliders cols{};
  if (L0 <= 0 || R0 % L0 != 0 || (!raw_only && L0 != R0) || (raw_only && ncol != 0) ||
      !unpack_colliders(col_f, col_i, ncol, kin, tcol, &cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const taps::Prepped in = taps::prepped_from(planes, strides);
  const int P1 = R1 + kNT - 1;
  const long long nodes = static_cast<long long>(R0 / L0) * (L0 + kNT - 1) * P1 * G2;
  cudaError_t err = cudaMemsetAsync(raw, 0, sizeof(float) * nch * nodes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kblocks = (K + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(R0) * R1 * kblocks;
  if (blocks > 0) {
    const unsigned nb = static_cast<unsigned>(blocks);
    if (nch == 7) {
      if (tent) launch_pdata_scatter<7, true>(in, counts, raw, nb, L0, R1, K, kblocks, G2, dx, apic, s);
      else launch_pdata_scatter<7, false>(in, counts, raw, nb, L0, R1, K, kblocks, G2, dx, apic, s);
    } else {
      if (tent) launch_pdata_scatter<11, true>(in, counts, raw, nb, L0, R1, K, kblocks, G2, dx, apic, s);
      else launch_pdata_scatter<11, false>(in, counts, raw, nb, L0, R1, K, kblocks, G2, dx, apic, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (raw_only) return static_cast<int>(cudaGetLastError());
  if (nch == 11) {
    return launch_update<true>(raw, out, nodes, R0, P1, G2, dtg0, dtg1, dtg2,
                               floor_m, lo, hi, wall, dt_beta, dx, cols, s);
  }
  return launch_update<false>(raw, out, nodes, R0, P1, G2, dtg0, dtg1, dtg2,
                              floor_m, lo, hi, wall, dt_beta, dx, cols, s);
}
