// Rigid SDF colliders in the grid node pass (models/colliders.py), shared
// by p2g.cu (2D, p2g_grid's non-raw mode) and p2g3d_grid.cu (3D): the
// launch's collider set, the host-side unpacking of the wrappers' arrays
// and the projection of a node velocity, templated on the dimension.
//
// The inside test phi <= 0 is a discontinuity: a node whose phi rounds to
// the other side of 0 differs from the plain version by a whole velocity.
// So phi, the normal and the kinematic center are computed with
// round-to-nearest intrinsics (no FMA contraction), one rounding per
// operation in the order of the reference's expressions
// (colliders.py:94-204), as PyTorch's elementwise ops round them.
#pragma once

#include <cuda_runtime.h>

namespace colliders {

constexpr int kMax = 8;   // colliders a launch takes
constexpr int kF = 19;    // floats per collider in the host arrays
constexpr int kI = 4;     // ints per collider in the host arrays

// One collider; a 2D collider keeps its third components zero and its
// angular velocity omega_z in omega[0].
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
  float omega[3];    // 3D (wx, wy, wz); 2D (wz, 0, 0)
};

// Passed by value in a launch's parameters (__grid_constant__): no device
// buffer, no copy.
struct Colliders {
  int n;             // 0: the node pass has no projection
  int kin;           // 1: moving centers at time t
  float t;
  Collider c[kMax];
};

// The host arrays of the C entry points -> the launch's Colliders: per
// collider kF floats [center (3), center velocity (3), radius,
// half-extents (3), unit normal (3), surface velocity (3), omega (3)] and
// kI ints [kind, sticky, moving, spin].  False when n is out of range.
inline bool unpack(const float* col_f, const int* col_i, int n, int kin, float t,
                   Colliders* cols) {
  if (n < 0 || n > kMax || (n > 0 && (col_f == nullptr || col_i == nullptr))) {
    return false;
  }
  cols->n = n;
  cols->kin = kin;
  cols->t = t;
  for (int i = 0; i < n; ++i) {
    const float* f = col_f + i * kF;
    const int* k = col_i + i * kI;
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

// sum_a x[a] y[a], rounded after every operation, left to right.
template <int kDim>
__device__ __forceinline__ float dot_rn(const float* x, const float* y) {
  float s = __fmul_rn(x[0], y[0]);
#pragma unroll
  for (int a = 1; a < kDim; ++a) s = __fadd_rn(s, __fmul_rn(x[a], y[a]));
  return s;
}

// colliders.project at node x, one collider after the other: phi (sphere,
// box, halfspace) and, for phi <= 0, the slip or sticky projection relative
// to the surface velocity (+ omega x r).  The outward normal is computed
// only where a slip surface needs it: the same values as the reference's,
// which computes it everywhere and discards it outside.
template <int kDim>
__device__ __forceinline__ void project(const Colliders& cs, const float x[kDim],
                                        float v[kDim]) {
  for (int i = 0; i < cs.n; ++i) {
    const Collider& c = cs.c[i];
    float diff[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) {
      const float ctr = (cs.kin && c.moving) ? __fadd_rn(c.center[a], __fmul_rn(c.cvel[a], cs.t))
                                             : c.center[a];
      diff[a] = __fsub_rn(x[a], ctr);
    }
    float phi, r = 0.0f, q[kDim], qp[kDim], out_len = 0.0f, qmax = 0.0f;
    if (c.kind == 0) {  // sphere
      r = __fsqrt_rn(dot_rn<kDim>(diff, diff));
      phi = __fsub_rn(r, c.radius);
    } else if (c.kind == 1) {  // axis-aligned box, exact SDF
#pragma unroll
      for (int a = 0; a < kDim; ++a) {
        q[a] = __fsub_rn(fabsf(diff[a]), c.half[a]);
        qp[a] = fmaxf(q[a], 0.0f);
      }
      out_len = __fsqrt_rn(dot_rn<kDim>(qp, qp));
      qmax = q[0];
#pragma unroll
      for (int a = 1; a < kDim; ++a) qmax = fmaxf(qmax, q[a]);
      phi = __fadd_rn(out_len, fminf(qmax, 0.0f));
    } else {  // halfspace: phi = n . (x - p)
      phi = dot_rn<kDim>(c.normal, diff);
    }
    if (!(phi <= 0.0f)) continue;
    float vs[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) vs[a] = c.vsurf[a];
    if (c.spin) {  // v_surface += omega x (x - center(t)); diff is x - center(t)
      const float* w = c.omega;
      if constexpr (kDim == 3) {
        vs[0] = __fsub_rn(__fadd_rn(vs[0], __fmul_rn(w[1], diff[2])), __fmul_rn(w[2], diff[1]));
        vs[1] = __fsub_rn(__fadd_rn(vs[1], __fmul_rn(w[2], diff[0])), __fmul_rn(w[0], diff[2]));
        vs[2] = __fsub_rn(__fadd_rn(vs[2], __fmul_rn(w[0], diff[1])), __fmul_rn(w[1], diff[0]));
      } else {  // omega_z: (-wz r1, wz r0)
        vs[0] = __fsub_rn(vs[0], __fmul_rn(w[0], diff[1]));
        vs[1] = __fadd_rn(vs[1], __fmul_rn(w[0], diff[0]));
      }
    }
    if (c.sticky) {
#pragma unroll
      for (int a = 0; a < kDim; ++a) v[a] = vs[a];
      continue;
    }
    float n[kDim];
    if (c.kind == 0) {
      const float r_safe = fmaxf(r, 1e-12f);
#pragma unroll
      for (int a = 0; a < kDim; ++a) n[a] = __fdiv_rn(diff[a], r_safe);
    } else if (c.kind == 1) {
      // Inside: the nearest face's axis (one-hot on argmax q, ties at edges
      // share it); outside: from the closest surface point.
      const bool inside = qmax <= 0.0f;
      const float safe_out = fmaxf(out_len, 1e-12f);
      float face[kDim], faces = 0.0f;
#pragma unroll
      for (int a = 0; a < kDim; ++a) {
        face[a] = q[a] >= qmax ? 1.0f : 0.0f;
        faces += face[a];
      }
      const float face_n = __fsqrt_rn(faces);  // sqrt(1 | 2 | 3)
#pragma unroll
      for (int a = 0; a < kDim; ++a) {
        const float sgn = diff[a] >= 0.0f ? 1.0f : -1.0f;
        n[a] = inside ? __fdiv_rn(sgn * face[a], face_n) : __fdiv_rn(sgn * qp[a], safe_out);
      }
    } else {
#pragma unroll
      for (int a = 0; a < kDim; ++a) n[a] = c.normal[a];
    }
    float vrel[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) vrel[a] = __fsub_rn(v[a], vs[a]);
    const float vn = dot_rn<kDim>(vrel, n);
    const float approach = fminf(vn, 0.0f);
#pragma unroll
    for (int a = 0; a < kDim; ++a) {
      v[a] = __fadd_rn(__fsub_rn(vrel[a], __fmul_rn(approach, n[a])), vs[a]);
    }
  }
}

}  // namespace colliders
