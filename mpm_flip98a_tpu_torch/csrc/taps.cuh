// Stencil taps and the per-slot part of the scatter, shared by the
// transfer kernels: the quadratic B-spline or, with kTent, the linear hat
// on the same 3-node stencil, in the two forms the TPU kernels use
// (mpm_flip98a_tpu/ops/pallas/transfer2d.py:123-159): per-tap weights of
// the fractional offset on the bucketed axes, and a weight of the signed
// distance along the last axis.  The 3D kernels (p2g3d.cu, p2g3d_grid.cu,
// g2p3d.cu) share the prepped-plane block; the fixed-order gathers (p2g.cu,
// p2g3d.cu, p2g3d_grid.cu) the sort and the stores of namespace `gather`,
// and the 3D ones the staged record, its sums and their butterfly of
// namespace `rec3d`, at the end.
#pragma once

#include <climits>

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

// ---- 3D ---------------------------------------------------------------
//
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

// Weakly-compressible fluid constants of the 3D stress modes (p2g3d.cu,
// p2g3d_grid.cu): Tait (tait 1) or linear EOS, and the viscosity.
struct Fluid {
  int tait;
  float kb, kb_over_gamma, gamma, two_mu, fa;
};

// The stress modes' state planes: [gx (3), v (3), C00..C22, J, mass, vol0].
constexpr int kStressIn = 18;

// The fluid stress of a slot (transfer3d.py:208-236) from the state planes:
// mv = m v, P = m C (APIC, else 0), Q = P + fa tau and the mass.
template <bool kApic>
__device__ __forceinline__ void fluid_affine(const Prepped& in, long long pencil, int k,
                                             const Fluid& fl, float mv[3], float p[9],
                                             float q[9], float& mass_out) {
  float c[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) c[e] = in.at(6 + e, pencil, k);
  const float jj = in.at(15, pencil, k), mass = in.at(16, pencil, k);
  const float vol0 = in.at(17, pencil, k);
  float pressure;
  if (fl.tait) {
    const float j_safe = fmaxf(jj, 1e-3f);
    pressure = fl.kb_over_gamma * (powf(1.0f / j_safe, fl.gamma) - 1.0f);
  } else {
    pressure = -fl.kb * (jj - 1.0f);
  }
  const float divc = c[0] + c[4] + c[8];
  const float vj = vol0 * jj;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mv[a] = mass * in.at(3 + a, pencil, k);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float dev = 0.5f * (c[3 * a + b] + c[3 * b + a]);
      float tau;
      if (a == b) {
        dev -= divc / 3.0f;
        tau = vj * (-pressure + fl.two_mu * dev);
      } else {
        tau = vj * (fl.two_mu * dev);
      }
      p[3 * a + b] = kApic ? mass * c[3 * a + b] : 0.0f;
      q[3 * a + b] = p[3 * a + b] + fl.fa * tau;
    }
  }
  mass_out = mass;
}

}  // namespace taps

// ---- Fixed-order gathers ---------------------------------------------------
//
// p2g.cu, p2g3d.cu and p2g3d_grid.cu sum each node over its slots in a
// fixed order, with no float atomics.  A block owns a band of output
// columns (z in 3D) and walks its source slots as one sequence (the bucket
// row's slots in 2D; its source pencils' one after the other in 3D), each
// warp a contiguous range of it, in steps of 32.  `classify(v)` gives the base column of
// sequence slot v when its stencil reaches the band, else kNone; it reads
// the slot's positions unconditionally, so that the unrolled steps of the
// first walk keep their loads in flight together.  Three walks:
//   1. tag_range: each slot's tag (base column - tag0, or -1) into shared
//      memory, and the least and greatest base column kept; the columns
//      outside what they reach are written as zeros (zero_outside);
//   2. count_bins: the kept slots per (bin = tag - tmin, warp), bin-major,
//      so that an exclusive scan (exclusive_scan) gives every (bin, warp)
//      its first position;
//   3. place: each kept slot's position, its (bin, warp)'s first position
//      plus the kept slots of its bin that come before it in the warp's
//      range (integer shared adds by one leader per bin and step, ranks
//      from __match_any_sync), into `order`.
// Walks 2 and 3 read only the tags.  So `order` lists the kept slots by
// base column and, within a column, in sequence order, whatever order the
// warps ran in.  The kernels stage the slots' records into shared memory
// in that order (stage_window, or in p2g3d.cu and p2g3d_grid.cu straight
// from the walk's registers by place_step / place_tag) and sum each output
// column over the slots of base columns c - 2 .. c in it.
namespace gather {

constexpr int kNone = INT_MIN;
constexpr int kUnroll = 4;  // steps of walk 1 in flight together

// The warp's contiguous range [lo, hi) of a sequence of n slots: whole
// steps of 32, warp w taking the w-th.
template <int kThreads>
__device__ __forceinline__ void warp_range(int n, int& lo, int& hi) {
  const int span = (n + kThreads - 1) / kThreads * 32;
  lo = min(n, (static_cast<int>(threadIdx.x) >> 5) * span);
  hi = min(n, lo + span);
}

// The block's least and greatest kept base column from each thread's mn
// and mx into range[0], range[1] (set to INT_MAX, INT_MIN before, and the
// block synchronised since).  Ends with the block synchronised.
__device__ __forceinline__ void reduce_range(int mn, int mx, int* range) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0 && mn <= mx) {
    atomicMin(range, mn);
    atomicMax(range + 1, mx);
  }
  __syncthreads();
}

// Walk 1: tag[v] = classify(v) - tag0 (-1 for kNone); range[0] = least,
// range[1] = greatest kept base column (INT_MAX, INT_MIN when no slot is
// kept).  Ends with the block synchronised.
template <typename Classify>
__device__ __forceinline__ void tag_range(Classify classify, int lo, int hi, int tag0,
                                          short* tag, int* range) {
  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  int mn = INT_MAX, mx = INT_MIN;
  for (int s = lo + (threadIdx.x & 31); s < hi; s += 32 * kUnroll) {
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) b[u] = classify(min(s + 32 * u, hi - 1));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = s + 32 * u;
      if (v >= hi) continue;
      tag[v] = static_cast<short>(b[u] == kNone ? -1 : b[u] - tag0);
      if (b[u] != kNone) {
        mn = min(mn, b[u]);
        mx = max(mx, b[u]);
      }
    }
  }
  reduce_range(mn, mx, range);
}

// Walk 2, one step of the warp's range, every lane with its slot's tag b
// (-1: not kept, or past the range): cnt[(b - tmin) kWarps + warp] += the
// step's kept slots of tag b.
template <int kWarps>
__device__ __forceinline__ void count_step(int b, int tmin, int* cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  if (b >= 0 && lane == __ffs(peers) - 1) cnt[(b - tmin) * kWarps + warp] += __popc(peers);
  __syncwarp();
}

// Walk 2 over the tags in shared memory.  cnt zeroed before; the caller
// synchronises after.
template <int kWarps>
__device__ __forceinline__ void count_bins(const short* tag, int lo, int hi, int tmin, int* cnt) {
  for (int s = lo; s < hi; s += 32) {
    const int v = s + (threadIdx.x & 31);
    count_step<kWarps>(v < hi ? tag[v] : -1, tmin, cnt);
  }
}

// Walk 3, one step of the warp's range, every lane with its slot's tag b
// as in count_step: the list position of this lane's slot (-1 when it is
// not kept), its (bin, warp)'s next position in cnt plus the kept slots of
// its bin before it in the step; cnt is advanced past the step's slots.
template <int kWarps>
__device__ __forceinline__ int place_tag(int b, int tmin, int* cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int leader = __ffs(peers) - 1;
  int first = 0;
  if (b >= 0 && lane == leader) {
    int* at = cnt + (b - tmin) * kWarps + warp;
    first = *at;
    *at = first + __popc(peers);
  }
  first = __shfl_sync(0xffffffffu, first, leader);
  __syncwarp();
  return b >= 0 ? first + __popc(peers & ((1u << lane) - 1u)) : -1;
}

// Walk 3, one step of 32 slots s .. s + 31 (< hi) over the tags in shared
// memory.
template <int kWarps>
__device__ __forceinline__ int place_step(const short* tag, int s, int hi, int tmin, int* cnt) {
  const int v = s + (threadIdx.x & 31);
  return place_tag<kWarps>(v < hi ? tag[v] : -1, tmin, cnt);
}

// Walk 3: order[position] = v for every kept slot, cnt holding each (bin,
// warp)'s first position (it is advanced past the warp's slots).
template <int kWarps>
__device__ __forceinline__ void place(const short* tag, int lo, int hi, int tmin, int* cnt,
                                      int* order) {
  for (int s = lo; s < hi; s += 32) {
    const int pos = place_step<kWarps>(tag, s, hi, tmin, cnt);
    if (pos >= 0) order[pos] = s + (threadIdx.x & 31);
  }
}
// Stages list entries [lo, hi) into stage[p - lo] (kVec float4s each) by
// the whole block: make(p, r) fills the record's 4 kVec floats.
template <int kThreads, int kVec, typename Make>
__device__ __forceinline__ void stage_window(int lo, int hi, float4* stage, Make make) {
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) {
    float r[4 * kVec];
    make(p, r);
    float4* rec = stage + static_cast<size_t>(p - lo) * kVec;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      rec[v] = make_float4(r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
    }
  }
}

// Exclusive prefix sum of a[0, n) in place by the whole block; returns the
// total.  tmp: kThreads / 32 ints of shared memory.  Synchronises on entry
// and on exit.
template <int kThreads>
__device__ __forceinline__ int exclusive_scan(int* a, int n, int* tmp) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per), hi = min(n, lo + per);
  __syncthreads();
  int sum = 0;
  for (int e = lo; e < hi; ++e) sum += a[e];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) tmp[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? tmp[warp - 1] : 0);
  const int total = tmp[kWarps - 1];
  for (int e = lo; e < hi; ++e) {
    const int c = a[e];
    a[e] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

// Zeros out[t ts + ch cs + z] for t < kNT, ch < nch and z in [zb, zb + bw)
// outside [zlo, zhi], by the whole block, with streaming stores and no
// division per store.  When every column is zero and the band spans whole
// rows (bw == cs), each target's nch rows are one contiguous run, stored
// as float4s where it is 16-byte aligned; else each warp takes whole rows
// (t, ch) in turn, float4 stores where a row allows them.
template <int kNT, int kThreads>
__device__ __forceinline__ void zero_outside(float* out, long long ts, int cs, int nch, int zb,
                                             int bw, int zlo, int zhi) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const bool all = zlo > zhi || zlo >= zb + bw || zhi < zb;
  const bool aligned = (reinterpret_cast<size_t>(out) & 15) == 0 && ((ts | cs | zb) & 3) == 0;
  if (all && bw == cs && aligned) {
    const int n4 = nch * cs / 4;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      float4* seg = reinterpret_cast<float4*>(out + t * ts);
      for (int e = threadIdx.x; e < n4; e += kThreads) __stcs(seg + e, zero);
    }
    return;
  }
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const bool vec = aligned && (bw & 3) == 0;
  for (int r = threadIdx.x >> 5; r < kNT * nch; r += kWarps) {
    const int t = r / nch, ch = r - t * nch;
    float* row = out + t * ts + static_cast<long long>(ch) * cs;
    if (vec) {
      for (int z = zb + 4 * lane; z < zb + bw; z += 128) {
        if (z + 3 < zlo || z > zhi) {
          __stcs(reinterpret_cast<float4*>(row + z), zero);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (z + q < zlo || z + q > zhi) __stcs(row + z + q, 0.0f);
          }
        }
      }
    } else {
      for (int z = zb + lane; z < zb + bw; z += 32) {
        if (z < zlo || z > zhi) __stcs(row + z, 0.0f);
      }
    }
  }
}

}  // namespace gather

// ---- The 3D gathers' records and sums --------------------------------------
//
// p2g3d.cu and p2g3d_grid.cu stage one record per kept (slot, axis-1 target
// row), its axis-1 tap folded in, and sum it into the five axis-0 targets a
// thread holds in registers, acc[kNT][kNch]: the slot's taps land on targets
// t0, t0 + 1, t0 + 2 (those in [0, kNT)).
namespace rec3d {

constexpr int kNT = 5;  // axis-0 targets a thread sums

// Staged record of one slot, in float4s: [t0 (int bits), gx0 - base0,
// gx2 - base2, w1 (the slot's axis-1 tap on the block's row), pure (9
// APIC: m v + P_a1 rdp1, P_a0, P_a2; 3 PIC: m v), forced (9: m v + Q_a1
// rdp1, Q_a0, Q_a2), plain (kNch - 6)].
template <int kNch, bool kApic>
struct Rec {
  static constexpr int kQ = 4 + (kApic ? 9 : 3);
  static constexpr int kPlain = kQ + 9;
  static constexpr int kVec = (kPlain + kNch - 6 + 3) / 4;
};

// A slot's input fields as loaded: [gx (3), m v (3), P (9, APIC only),
// Q (9), plain (kNch - 6)].
template <int kNch, bool kApic>
struct Fields {
  static constexpr int kQ = 6 + (kApic ? 9 : 0);
  static constexpr int kN = kQ + 9 + kNch - 6;
};

// The slot's fields from the prepped planes or, in the stress mode
// (kStress, kNch 7), from the 18 state planes: the fluid stress of
// taps::fluid_affine.
template <int kNch, bool kApic, bool kStress>
__device__ __forceinline__ void load_fields(const taps::Prepped& in, long long pencil, int k,
                                            const taps::Fluid& fl,
                                            float f[Fields<kNch, kApic>::kN]) {
  using F = Fields<kNch, kApic>;
  if constexpr (kStress) {
    static_assert(kNch == 7, "the stress mode has 7 channels");
    float pic_p[9];  // P = 0 under PIC, which the fields do not hold
#pragma unroll
    for (int e = 0; e < 3; ++e) f[e] = in.at(taps::kGx + e, pencil, k);
    taps::fluid_affine<kApic>(in, pencil, k, fl, f + 3, kApic ? f + 6 : pic_p, f + F::kQ,
                              f[F::kQ + 9]);
  } else {
#pragma unroll
    for (int e = 0; e < 6; ++e) f[e] = in.at(taps::kGx + e, pencil, k);  // gx, m v
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      if (kApic) f[6 + e] = in.at(taps::kP + e, pencil, k);
      f[F::kQ + e] = in.at(taps::kQ + e, pencil, k);
    }
#pragma unroll
    for (int e = 0; e < kNch - 6; ++e) f[F::kQ + 9 + e] = in.at(taps::kM + e, pencil, k);
  }
}

// The staged record of a kept slot from its fields: its first axis-0
// target t0 and its axis-1 tap j1 on the block's row.
template <int kNch, bool kTent, bool kApic>
__device__ __forceinline__ void rec_from(const float* f, int t0, int j1, float dx,
                                         float r[4 * Rec<kNch, kApic>::kVec]) {
  using R = Rec<kNch, kApic>;
  using F = Fields<kNch, kApic>;
  const float gx0 = f[0], gx1 = f[1], gx2 = f[2];
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
  const float base2 = floorf(gx2 - 0.5f);
  float w1[3];
  taps::axis<kTent>(gx1 - base1, w1);
  const float rdp1 = (base1 + static_cast<float>(j1) - gx1) * dx;
  r[0] = __int_as_float(t0);
  r[1] = gx0 - base0;
  r[2] = gx2 - base2;
  r[3] = j1 == 0 ? w1[0] : (j1 == 1 ? w1[1] : w1[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float mv = f[3 + a];
    if (kApic) {
      r[4 + a] = mv + f[6 + 3 * a + 1] * rdp1;
      r[7 + a] = f[6 + 3 * a];
      r[10 + a] = f[6 + 3 * a + 2];
    } else {
      r[4 + a] = mv;
    }
    r[R::kQ + a] = mv + f[F::kQ + 3 * a + 1] * rdp1;
    r[R::kQ + 3 + a] = f[F::kQ + 3 * a];
    r[R::kQ + 6 + a] = f[F::kQ + 3 * a + 2];
  }
#pragma unroll
  for (int e = 0; e < kNch - 6; ++e) r[R::kPlain + e] = f[F::kQ + 9 + e];
#pragma unroll
  for (int e = R::kPlain + kNch - 6; e < 4 * R::kVec; ++e) r[e] = 0.0f;
}

template <int kVec>
__device__ __forceinline__ void put_rec(const float r[4 * kVec], float4* rec) {
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    rec[v] = make_float4(r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
  }
}

// The slot's taps on axis-0 targets kT0 .. kT0 + 2 of its z column that
// lie in [0, kNT): axis-0 tap j0 has weight w0[j0] w1 wz and offset rdp0 =
// (base0 + j0 - gx0) dx; u and f hold the z parts of pure (APIC) and forced
// momentum.
template <int kNch, bool kApic, int kT0>
__device__ __forceinline__ void add_rows(const float* r, const float w0[3], float wz,
                                         const float u[3], const float f[3], float dx,
                                         float acc[kNT][kNch]) {
  using R = Rec<kNch, kApic>;
#pragma unroll
  for (int j0 = 0; j0 < 3; ++j0) {
    if (kT0 + j0 < 0 || kT0 + j0 >= kNT) continue;
    const float w = (w0[j0] * r[3]) * wz;
    const float rdp0 = (static_cast<float>(j0) - r[1]) * dx;
    float* a = acc[kT0 + j0];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] += kApic ? w * (u[c] + r[7 + c] * rdp0) : w * r[4 + c];
      a[3 + c] += w * (f[c] + r[R::kQ + 3 + c] * rdp0);
    }
#pragma unroll
    for (int e = 0; e < kNch - 6; ++e) a[6 + e] += w * r[R::kPlain + e];
  }
}

// add_rows at the record's t0, one of kLo .. kHi.
template <int kNch, bool kApic, int kLo, int kHi>
__device__ __forceinline__ void add_at(int t0, const float* r, const float w0[3], float wz,
                                       const float u[3], const float f[3], float dx,
                                       float acc[kNT][kNch]) {
  if constexpr (kLo == kHi) {
    add_rows<kNch, kApic, kLo>(r, w0, wz, u, f, dx, acc);
  } else {
    if (t0 == kLo) {
      add_rows<kNch, kApic, kLo>(r, w0, wz, u, f, dx, acc);
    } else {
      add_at<kNch, kApic, kLo + 1, kHi>(t0, r, w0, wz, u, f, dx, acc);
    }
  }
}

// Adds a staged slot's taps with z tap jz (column base2 + jz) to the
// column's kNT axis-0 targets; its t0 is one of kLo .. kHi.
template <int kNch, bool kTent, bool kApic, int kLo, int kHi>
__device__ __forceinline__ void visit(const float4* rec, float jz, float dx,
                                      float acc[kNT][kNch]) {
  using R = Rec<kNch, kApic>;
  float r[4 * R::kVec];
#pragma unroll
  for (int v = 0; v < R::kVec; ++v) {
    const float4 f = rec[v];
    r[4 * v] = f.x;
    r[4 * v + 1] = f.y;
    r[4 * v + 2] = f.z;
    r[4 * v + 3] = f.w;
  }
  float w0[3];
  taps::axis<kTent>(r[1], w0);
  const float d = jz - r[2];  // c - gx2
  const float wz = taps::col<kTent>(d), cdz = d * dx;
  float u[3], f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u[c] = kApic ? r[4 + c] + r[10 + c] * cdz : 0.0f;
    f[c] = r[R::kQ + c] + r[R::kQ + 6 + c] * cdz;
  }
  add_at<kNch, kApic, kLo, kHi>(__float_as_int(r[0]), r, w0, wz, u, f, dx, acc);
}

// The kSplit threads of a column (consecutive lanes, kSplit a power of
// two) add their shares in a fixed butterfly: s + (s ^ 1), then with
// (s ^ 2)'s, ...; every thread of the column ends with the same sums.
template <int kNch, int kSplit>
__device__ __forceinline__ void butterfly(float acc[kNT][kNch]) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) {
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) acc[t][ch] += __shfl_xor_sync(0xffffffffu, acc[t][ch], o);
    }
  }
}

}  // namespace rec3d
