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
// The TPU kernel scatters along z with one-hot MXU products, carries
// target rows from one sequential grid step to the next in a rolling
// 5-slot VMEM scratch, and finishes each row with the node update once it
// is complete.  GPU blocks run in no order, so here a block owns a tile of
// target pencils outright and pulls from its sources.
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
//   raw     optional: the raw sums (R0 + 4, R1 + 4, 7 or 11, G2) = [m v
//           pure (3), m v forced (3), m (, V0 J, V0, V0 p, V0 div)],
//           uncropped, written beside `out` when not null
// Raw mode (transfer3d.py:484-489, the slab-sharded path's): n slab
// shards of L0 axis-0 rows each (n L0 = R0, gx0 local to the shard); the
// raw sums alone, (n, L0 + 4, R1 + 4, 7 or 11, G2), row j of shard s its
// local target row j - 1, uncropped on both axes; no node pass.
// A slot contributes only when its base row on both bucketed axes is within
// +-1 of its pencil's; slots at or past min(count, K) contribute nothing;
// z taps outside [0, G2) are dropped.  Axis-0 target rows outside [0, R0)
// come out zero (the TPU kernel's `interior` crop); the axis-1 pad rows
// keep their sums, as in the TPU kernel.
//
// Design: one launch, no global atomics, no raw buffer.
//   A block owns a tile of t0 x t1 target pencils (padded planes) of one
//   shard's window, over all of G2.  A target plane q receives only from
//   source rows q - 4 .. q on each axis, so the block walks the slots of
//   its (t0 + 4) x (t1 + 4) source pencils (chunks of 32 consecutive slots
//   of one pencil, lane on slot so the reads coalesce, dealt to the warps
//   in turn so that a crowded pencil spreads over them), drops the slots
//   whose stencil misses the tile, and adds the taps that fall inside it
//   (27 x nch at most) with shared-memory atomics into a slab of
//   [t0 t1][nch][band] floats (each pencil padded by one float, so lanes on
//   neighbouring pencils at the same z fall in different banks).  The card
//   has no float add in shared memory: each atomicAdd is a compare-and-swap
//   loop (ATOMS.CAST.SPIN) whose latency the warp waits out, so the design
//   buys warps: kBlocksPerSM = 4 blocks of 256 threads per SM, 64
//   registers a thread (APIC is a template parameter, so PIC carries no P
//   and spills less), and slabs small enough for four of them.
//   z bands: the slab holds `band` z columns.  When band < G2 the block
//   first reduces the z range its sources' taps reach, and sums only that
//   range, band by band (one walk of the sources per band); the other
//   columns have zero sums.  Each band ends in the epilogue: every node of
//   the tile goes through the node pass from the slab (the columns outside
//   the range with zero sums, through the same code): mass floor, v_old =
//   pure / m, v_new = forced / m + dt g (or the diagonal penalty solve),
//   slip clamps or the sticky zero on the wall bands of the three axes, the
//   colliders' projection of v_new (models/colliders.project) on interior
//   rows, the ext averages; the block writes the finished channels once
//   (and the raw sums when asked).  The host's planner
//   (ops/cuda/transfer3d.py, plan_p2g3d_grid) picks t0, t1 and band so
//   kBlocksPerSM slabs fit an SM's shared memory; tiles go in raster
//   order, axis 1 fastest, so neighbouring blocks share source pencils in
//   L2.
// Colliders: at most colliders::kMax, passed by value in the launch's
// parameters (colliders.cuh, shared with p2g.cu's 2D node pass, which
// computes the inside test with round-to-nearest intrinsics so that it
// agrees with PyTorch's bit for bit).  `kin` = 0 (no moving collider, or no
// time) leaves every center where the host put it, bit for bit a time-free
// build; the host casts the constants to float32 as JAX does.  The
// projection costs about 30 flops and no bytes per node.
// Shared-memory atomics add in a run-dependent order: the result is not
// bitwise deterministic (the JAX kernel is); it agrees with the plain
// version to fp32 rounding of each node's sum (the tolerance is stated
// where the two are compared).  Offsets are 64-bit: R0 R1 K passes 2^31 at
// 256^3.
//
// What bounds it on the H100: the latency of the shared-memory
// compare-and-swap loops and the walk of the source window, not bytes or
// flops.  A live slot reads 72 bytes (prepped: 80 PIC, 116 APIC, + 16
// with ext) and issues up to 189 (297 with ext) shared atomic adds; a tile
// reads its sources' gx from (t0 + 4)(t1 + 4) pencils (the rest of a slot
// only when its stencil meets the tile), once more per z band it sums;
// every node is written once, 6 or 9 floats (7 or 11 raw).

#include <cuda_runtime.h>

#include "colliders.cuh"
#include "taps.cuh"

namespace {

using colliders::Colliders;

constexpr int kHalo = 4;      // a target plane takes source rows q - 4 .. q
constexpr int kThreads = 256;
// Blocks resident on an SM: the register cap of __launch_bounds__ (64)
// and the shared-memory budget of the host's planner (transfer3d.py's
// BLOCKS_PER_SM) follow it.
constexpr int kBlocksPerSM = 4;
constexpr int kMaxSrc = 144;  // source pencils of an 8 x 8 tile, (8 + 4)^2

// Shapes and the host's tile plan.
struct Plan {
  int R0, L0, R1, K, G2;
  int t0, t1, band;  // tile pencils on each axis, z columns in the slab
  int nt0, nt1;      // tiles per shard window on each axis
  int pencil;        // slab floats per target pencil: nch band + 1
};

// Node-pass constants.
struct Node {
  float dtg[3];
  float floor_m;
  int lo, hi, wall;  // wall: 0 slip, 1 sticky, 2 penalty
  float dt_beta, dx;
};

// Stress mode: the fluid stress of the slot (taps::fluid_affine) as a
// 7-channel slot [m v, P = m C (APIC), Q = P + fa tau, m].
template <bool kApic>
__device__ __forceinline__ void load_stress(const taps::Prepped& in, long long pencil, int k,
                                            const taps::Fluid& fl, float gx2, float base2,
                                            int G2, float dx, taps::Slot<7>& s) {
  taps::fluid_affine<kApic>(in, pencil, k, fl, s.mv, s.p, s.q, s.plain[0]);
  taps::z_taps<7, false>(gx2, base2, G2, dx, s);
}

// A slot's stencil rows against the tile: its fractional positions and
// base rows on the bucketed axes, the tile-local row of tap j = 0 on each,
// and the taps j0lo..j0hi, j1lo..j1hi that fall inside the tile.  False
// for a slot outside the +-1 margin or whose stencil misses the tile.
struct Rows {
  float gx0, gx1, base0, base1;
  int qb0, qb1, j0lo, j0hi, j1lo, j1hi;
};

__device__ __forceinline__ bool slot_rows(const taps::Prepped& in, long long pencil, int k,
                                          int i0, int i1, int q0lo, int h0, int q1lo, int h1,
                                          Rows& r) {
  r.gx0 = in.at(taps::kGx, pencil, k);
  r.gx1 = in.at(taps::kGx + 1, pencil, k);
  r.base0 = floorf(r.gx0 - 0.5f);
  r.base1 = floorf(r.gx1 - 0.5f);
  const float rel0 = r.base0 - static_cast<float>(i0);
  const float rel1 = r.base1 - static_cast<float>(i1);
  if (!(rel0 >= -1.0f && rel0 <= 1.0f && rel1 >= -1.0f && rel1 <= 1.0f)) return false;
  // Window plane of tap j: source row + rel + 1 + j.
  r.qb0 = i0 + static_cast<int>(rel0) + 1 - q0lo;
  r.qb1 = i1 + static_cast<int>(rel1) + 1 - q1lo;
  r.j0lo = max(0, -r.qb0);
  r.j0hi = min(2, h0 - 1 - r.qb0);
  r.j1lo = max(0, -r.qb1);
  r.j1hi = min(2, h1 - 1 - r.qb1);
  return r.j0lo <= r.j0hi && r.j1lo <= r.j1hi;
}

// The node pass of one node from its raw sums r (transfer3d.py:491-585):
// target rows (t0, t1), column zc -> o = [v_new (3), v_old (3) (, Jbar,
// p, div)].  kNch = 11 adds the ext averages.
template <int kNch>
__device__ __forceinline__ void finish_node(const float r[kNch], int t0, int t1, int zc, int R0,
                                            int R1, const Node& nd, const Colliders& cols,
                                            float o[]) {
  const bool interior = t0 >= 0 && t0 < R0;
  const float m = r[6];
  const bool has = m > nd.floor_m && interior;
  const float safe = has ? m : 1.0f;
  const int lo = nd.lo, hi = nd.hi;
  const bool lo0 = t0 <= lo && interior, hi0 = t0 >= hi;
  const bool lo1 = t1 <= lo, hi1 = t1 >= hi;
  const bool lo2 = zc <= lo, hi2 = zc >= hi;
  float v[3];
  if (nd.wall == 2) {  // penalty: (m I + dt beta n(x)n) v = m v* + dt m g, diagonal
    const bool band[3] = {lo0 || hi0, lo1 || hi1, lo2 || hi2};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pen = band[a] ? 1.0f : 0.0f;
      v[a] = has ? (r[3 + a] + nd.dtg[a] * m) / (m + nd.dt_beta * pen) : 0.0f;
    }
  } else {
    const float hasf = has ? 1.0f : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) v[a] = (has ? r[3 + a] / safe : 0.0f) + nd.dtg[a] * hasf;
    if (nd.wall == 1) {  // sticky
      if (lo0 || hi0 || lo1 || hi1 || lo2 || hi2) v[0] = v[1] = v[2] = 0.0f;
    } else {             // slip: clamp the outgoing normal component per band
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
  if (cols.n > 0 && interior && t1 >= 0 && t1 < R1) {
    const float x[3] = {
        __fmul_rn(__fsub_rn(static_cast<float>(t0), static_cast<float>(lo)), nd.dx),
        __fmul_rn(__fsub_rn(static_cast<float>(t1), static_cast<float>(lo)), nd.dx),
        __fmul_rn(__fsub_rn(static_cast<float>(zc), static_cast<float>(lo)), nd.dx),
    };
    colliders::project<3>(cols, x, v);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = v[a];
    o[3 + a] = has ? r[a] / safe : 0.0f;
  }
  if (kNch == 11) {
    // Nodal averages over the scattered volume (transfer3d.py:574-585).
    const float v0sum = r[8];
    const bool has_v = v0sum > 0.0f && interior;
    const float safe_v = has_v ? v0sum : 1.0f;
    o[6] = has_v ? r[7] / safe_v : (interior ? 1.0f : 0.0f);
    o[7] = has_v ? r[9] / safe_v : 0.0f;
    o[8] = has_v ? r[10] / safe_v : 0.0f;
  }
}

// Writes one node of window plane (shard, q0, q1), column zc, from its raw
// sums: the raw channels to `raw` when not null, the node pass's to `out`
// when not null (null in the raw mode).
template <int kNch>
__device__ __forceinline__ void emit(const float r[kNch], int shard, int q0, int q1, int zc,
                                     const Plan& pl, const Node& nd, const Colliders& cols,
                                     float* out, float* raw) {
  constexpr int kOut = kNch == 11 ? 9 : 6;
  const long long plane =
      (static_cast<long long>(shard) * (pl.L0 + kHalo) + q0) * (pl.R1 + kHalo) + q1;
  if (raw != nullptr) {
    float* at = raw + plane * kNch * pl.G2 + zc;
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) at[ch * pl.G2] = r[ch];
  }
  if (out != nullptr) {
    float o[kOut];
    finish_node<kNch>(r, q0 - 1, q1 - 1, zc, pl.R0, pl.R1, nd, cols, o);
    float* at = out + plane * kOut * pl.G2 + zc;
#pragma unroll
    for (int ch = 0; ch < kOut; ++ch) at[ch * pl.G2] = o[ch];
  }
}

// One block per tile: blockIdx.x = (shard, tile row, tile column), the
// tile column fastest.  kStress: the 18 state planes and the fluid stress
// (kNch = 7, B-spline); else the prepped planes.
template <int kNch, bool kTent, bool kStress, bool kApic>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p2g3d_grid_kernel(taps::Prepped in, const int* __restrict__ counts, float* __restrict__ out,
                  float* __restrict__ raw, Plan pl, taps::Fluid fl, Node nd, float dx,
                  const __grid_constant__ Colliders cols) {
  extern __shared__ float slab[];  // [t0 t1][pencil = kNch band + 1]
  __shared__ int zrange[2];
  __shared__ int live[kMaxSrc];       // min(count, K) of each source pencil
  __shared__ int chunk_end[kMaxSrc];  // running sum of their 32-slot chunks
  const int tiles = pl.nt0 * pl.nt1;
  const int shard = blockIdx.x / tiles;
  const int tile = blockIdx.x - shard * tiles;
  const int q0lo = (tile / pl.nt1) * pl.t0, q1lo = (tile % pl.nt1) * pl.t1;
  const int h0 = min(pl.t0, pl.L0 + kHalo - q0lo), h1 = min(pl.t1, pl.R1 + kHalo - q1lo);
  // Source rows q - 4 .. q of the tile's planes, inside the shard.
  const int s0lo = max(q0lo - kHalo, 0), s0hi = min(q0lo + h0 - 1, pl.L0 - 1);
  const int s1lo = max(q1lo - kHalo, 0), s1hi = min(q1lo + h1 - 1, pl.R1 - 1);
  const int ns1 = s1hi - s1lo + 1;
  const int nsrc = max(s0hi - s0lo + 1, 0) * max(ns1, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int G2 = pl.G2;

  // The walk: chunks of 32 consecutive slots of one source pencil (lane
  // on slot), dealt to the warps in turn, so that a crowded pencil's
  // chunks spread over the warps.
  for (int sp = threadIdx.x; sp < nsrc; sp += blockDim.x) {
    const long long pencil =
        static_cast<long long>(shard * pl.L0 + s0lo + sp / ns1) * pl.R1 + s1lo + sp % ns1;
    live[sp] = max(min(counts[pencil], pl.K), 0);
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < nsrc; base += 32) {
      int v = base + lane < nsrc ? (live[base + lane] + 31) >> 5 : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (base + lane < nsrc) chunk_end[base + lane] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const int chunks = nsrc > 0 ? chunk_end[nsrc - 1] : 0;
  // Chunk `item` -> this lane's slot k of source pencil (i0, i1); false
  // past the pencil's live slots.
  auto slot_of = [&](int item, int& i0, int& i1, long long& pencil, int& k) {
    int lo = 0, hi = nsrc - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_end[mid] > item) hi = mid;
      else lo = mid + 1;
    }
    i0 = s0lo + lo / ns1;
    i1 = s1lo + lo % ns1;
    pencil = static_cast<long long>(shard * pl.L0 + i0) * pl.R1 + i1;
    k = (item - (lo > 0 ? chunk_end[lo - 1] : 0)) * 32 + lane;
    return k < live[lo];
  };

  // The z range the sources' taps reach, when the slab does not hold G2.
  int zlo = 0, zhi = G2 - 1;
  if (pl.band < G2) {
    if (threadIdx.x == 0) {
      zrange[0] = G2;
      zrange[1] = -1;
    }
    __syncthreads();
    int mylo = G2, myhi = -1;
    for (int item = warp; item < chunks; item += nwarps) {
      int i0, i1, k;
      long long pencil;
      if (!slot_of(item, i0, i1, pencil, k)) continue;
      Rows r;
      if (!slot_rows(in, pencil, k, i0, i1, q0lo, h0, q1lo, h1, r)) continue;
      const float base2 = floorf(in.at(taps::kGx + 2, pencil, k) - 0.5f);
      // Columns base2 .. base2 + 2 clipped to [0, G2); none (or NaN): skip.
      if (!(base2 >= -2.0f && base2 <= G2 - 1.0f)) continue;
      const int b2 = static_cast<int>(base2);
      mylo = min(mylo, max(b2, 0));
      myhi = max(myhi, min(b2 + 2, G2 - 1));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mylo = min(mylo, __shfl_xor_sync(0xffffffffu, mylo, o));
      myhi = max(myhi, __shfl_xor_sync(0xffffffffu, myhi, o));
    }
    if (lane == 0) {
      atomicMin(&zrange[0], mylo);
      atomicMax(&zrange[1], myhi);
    }
    __syncthreads();
    zlo = zrange[0];
    zhi = zrange[1];
  }

  // Sum [zlo, zhi] band by band; `done` ends the columns summed.
  int done = zlo;
  for (int zb = zlo; zb <= zhi; zb += pl.band) {
    const int bw = min(pl.band, G2 - zb);
    for (int e = threadIdx.x; e < h0 * h1 * pl.pencil; e += blockDim.x) slab[e] = 0.0f;
    __syncthreads();
    for (int item = warp; item < chunks; item += nwarps) {
      int i0, i1, k;
      long long pencil;
      if (!slot_of(item, i0, i1, pencil, k)) continue;
      Rows r;
      if (!slot_rows(in, pencil, k, i0, i1, q0lo, h0, q1lo, h1, r)) continue;
      const float gx2 = in.at(taps::kGx + 2, pencil, k);
      const float base2 = floorf(gx2 - 0.5f);
      // The slot's columns base2 .. base2 + 2 must meet this band.
      if (base2 + 2.0f < static_cast<float>(zb) || base2 >= static_cast<float>(zb + bw)) {
        continue;
      }
      taps::Slot<kNch> slot;
      if constexpr (kStress) {
        load_stress<kApic>(in, pencil, k, fl, gx2, base2, G2, dx, slot);
      } else {
        taps::load_slot<kNch, kTent>(in, pencil, k, kApic, gx2, base2, G2, dx, slot);
      }
      int col[3];  // the z taps' columns in this band, -1 outside
#pragma unroll
      for (int j2 = 0; j2 < 3; ++j2) {
        const int cb = slot.z[j2] < 0 ? -1 : slot.z[j2] - zb;
        col[j2] = (cb >= 0 && cb < bw) ? cb : -1;
      }
      float w0[3], w1[3];
      taps::axis<kTent>(r.gx0 - r.base0, w0);
      taps::axis<kTent>(r.gx1 - r.base1, w1);
#pragma unroll
      for (int j0 = 0; j0 < 3; ++j0) {
        if (j0 < r.j0lo || j0 > r.j0hi) continue;
        const float rdp0 = (r.base0 + static_cast<float>(j0) - r.gx0) * dx;
#pragma unroll
        for (int j1 = 0; j1 < 3; ++j1) {
          if (j1 < r.j1lo || j1 > r.j1hi) continue;
          const float rdp1 = (r.base1 + static_cast<float>(j1) - r.gx1) * dx;
          const float w01 = w0[j0] * w1[j1];
          float pure[3], forced[3];
          taps::affine01<kNch, kApic>(slot, rdp0, rdp1, pure, forced);
          float* node = slab + ((r.qb0 + j0) * h1 + (r.qb1 + j1)) * pl.pencil;
#pragma unroll
          for (int j2 = 0; j2 < 3; ++j2) {
            if (col[j2] < 0) continue;
            taps::add_tap<kNch, kApic>(slot, pure, forced, j2, w01 * slot.wz[j2],
                                       node + col[j2], pl.band);
          }
        }
      }
    }
    __syncthreads();
    // Epilogue of the band: every node of the tile in columns zb .. zb + bw.
    for (int e = threadIdx.x; e < h0 * h1 * bw; e += blockDim.x) {
      const int p = e / bw, zz = e - p * bw;
      const float* s = slab + p * pl.pencil + zz;
      float r[kNch];
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) r[ch] = s[ch * pl.band];
      emit<kNch>(r, shard, q0lo + p / h1, q1lo + p % h1, zb + zz, pl, nd, cols, out, raw);
    }
    done = zb + bw;
    __syncthreads();
  }

  // The columns outside the summed range: zero sums, the same node pass.
  const int skip = done - zlo;  // columns zlo .. done - 1 were written above
  const int rest = G2 - skip;
  float zero[kNch];
#pragma unroll
  for (int ch = 0; ch < kNch; ++ch) zero[ch] = 0.0f;
  for (int e = threadIdx.x; e < h0 * h1 * rest; e += blockDim.x) {
    const int p = e / rest, zi = e - p * rest;
    const int zc = zi < zlo ? zi : zi + skip;
    emit<kNch>(zero, shard, q0lo + p / h1, q1lo + p % h1, zc, pl, nd, cols, out, raw);
  }
}

template <int kNch, bool kTent, bool kStress>
int launch(const taps::Prepped& in, const int* counts, float* out, float* raw, const Plan& pl,
           const taps::Fluid& fl, const Node& nd, float dx, int apic, const Colliders& cols,
           unsigned blocks, size_t smem, cudaStream_t s) {
  auto kernel = apic ? p2g3d_grid_kernel<kNch, kTent, kStress, true>
                     : p2g3d_grid_kernel<kNch, kTent, kStress, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, s>>>(in, counts, out, raw, pl, fl, nd, dx, cols);
  return static_cast<int>(cudaGetLastError());
}

// Checks the arguments shared by both entry points and fills the plan, the
// node constants and the colliders; returns a cudaError_t as int (0: go)
// and the block count and shared bytes of the launch.
int prepare(float* raw, float* out, int R0, int L0, int R1, int K, int G2, int nch, int t0,
            int t1, int band, float dtg0, float dtg1, float dtg2, float floor_m, int lo,
            int hi, int wall, float dt_beta, float dx, const float* col_f, const int* col_i,
            int ncol, int kin, float tcol, int raw_only, Plan* pl, Node* nd, Colliders* cols,
            unsigned* blocks, size_t* smem) {
  if (L0 <= 0 || R0 % L0 != 0 || R1 <= 0 || K < 0 || G2 <= 0 || t0 <= 0 || t1 <= 0 ||
      (t0 + kHalo) * (t1 + kHalo) > kMaxSrc || band <= 0 || (!raw_only && (L0 != R0 || out == nullptr)) ||
      (raw_only && (ncol != 0 || raw == nullptr)) ||
      !colliders::unpack(col_f, col_i, ncol, kin, tcol, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pl->R0 = R0;
  pl->L0 = L0;
  pl->R1 = R1;
  pl->K = K;
  pl->G2 = G2;
  pl->t0 = t0;
  pl->t1 = t1;
  pl->band = min(band, G2);
  pl->nt0 = (L0 + kHalo + t0 - 1) / t0;
  pl->nt1 = (R1 + kHalo + t1 - 1) / t1;
  pl->pencil = nch * pl->band + 1;
  *smem = sizeof(float) * static_cast<size_t>(t0) * t1 * pl->pencil;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(R0 / L0) * pl->nt0 * pl->nt1;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  nd->dtg[0] = dtg0;
  nd->dtg[1] = dtg1;
  nd->dtg[2] = dtg2;
  nd->floor_m = floor_m;
  nd->lo = lo;
  nd->hi = hi;
  nd->wall = wall;
  nd->dt_beta = dt_beta;
  nd->dx = dx;
  return 0;
}

}  // namespace

// L0: axis-0 rows per shard (R0 for one device); raw_only: 1 writes the
// raw sums alone into `raw` (the raw mode: `out` is unused, R0 / L0
// shards), 0 runs the node pass into `out` (then L0 must be R0) and also
// writes the raw sums into `raw` when it is not null.  col_f, col_i: host
// arrays of ncol colliders (see unpack_colliders; the raw mode takes none);
// kin: 1 puts the moving ones at time tcol.  t0, t1, band: the tile plan
// (transfer3d.py's plan_p2g3d_grid); the slab of t0 t1 (7 band + 1) floats
// must fit the card's opt-in shared memory.  Returns a cudaError_t as int.
extern "C" int mpm_p2g3d_grid(const void* const* planes, const long long* strides,
                              const int* counts, float* raw, float* out, int R0,
                              int L0, int R1, int K, int G2, float dx, int apic, int tait,
                              float kb, float kb_over_gamma, float gamma,
                              float two_mu, float fa, float dtg0, float dtg1,
                              float dtg2, float floor_m, int lo, int hi, int wall,
                              float dt_beta, const float* col_f, const int* col_i,
                              int ncol, int kin, float tcol, int raw_only, int t0, int t1,
                              int band, void* stream) {
  Plan pl;
  Node nd;
  Colliders cols{};
  unsigned blocks = 0;
  size_t smem = 0;
  const int rc = prepare(raw, out, R0, L0, R1, K, G2, 7, t0, t1, band, dtg0, dtg1, dtg2,
                         floor_m, lo, hi, wall, dt_beta, dx, col_f, col_i, ncol, kin, tcol,
                         raw_only, &pl, &nd, &cols, &blocks, &smem);
  if (rc != 0) return rc;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  taps::Prepped in{};
  for (int e = 0; e < taps::kStressIn; ++e) {
    in.p[e] = static_cast<const float*>(planes[e]);
    in.stride[e] = strides[e];
  }
  const taps::Fluid fl{tait, kb, kb_over_gamma, gamma, two_mu, fa};
  return launch<7, false, true>(in, counts, raw_only ? nullptr : out, raw, pl, fl, nd, dx,
                                apic, cols, blocks, smem, static_cast<cudaStream_t>(stream));
}

// Prepped mode.  planes / strides: 29 entries in the order of taps.cuh
// (null where the mode has no such plane); nch: 7, or 11 with the ext
// fields (then out has 9 channels); apic, tent: 0/1; L0, the colliders,
// raw_only and the plan as in mpm_p2g3d_grid (the slab holds nch band + 1
// floats per pencil).
extern "C" int mpm_p2g3d_grid_pdata(const void* const* planes, const long long* strides,
                                    const int* counts, float* raw, float* out, int R0,
                                    int L0, int R1, int K, int G2, int nch, int apic,
                                    int tent, float dx, float dtg0, float dtg1, float dtg2,
                                    float floor_m, int lo, int hi, int wall,
                                    float dt_beta, const float* col_f, const int* col_i,
                                    int ncol, int kin, float tcol, int raw_only, int t0,
                                    int t1, int band, void* stream) {
  if (nch != 7 && nch != 11) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  Node nd;
  Colliders cols{};
  unsigned blocks = 0;
  size_t smem = 0;
  const int rc = prepare(raw, out, R0, L0, R1, K, G2, nch, t0, t1, band, dtg0, dtg1, dtg2,
                         floor_m, lo, hi, wall, dt_beta, dx, col_f, col_i, ncol, kin, tcol,
                         raw_only, &pl, &nd, &cols, &blocks, &smem);
  if (rc != 0) return rc;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const taps::Prepped in = taps::prepped_from(planes, strides);
  const taps::Fluid fl{};
  float* o = raw_only ? nullptr : out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nch == 7) {
    return tent ? launch<7, true, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, smem, s)
                : launch<7, false, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, smem, s);
  }
  return tent ? launch<11, true, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, smem, s)
              : launch<11, false, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, smem, s);
}
