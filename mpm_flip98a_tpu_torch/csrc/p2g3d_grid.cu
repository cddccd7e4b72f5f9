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
// target pencils outright and gathers from its sources.
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
// Design: one launch, a fixed-order gather (taps.cuh, namespaces gather
// and rec3d, shared with p2g3d.cu), no float atomics, no raw buffer.
//   A block owns a tile of kNT x kRows = 5 x 1 target planes of one shard's
//   window over a band of z columns (all of G2 up to 512).  Its source
//   pencils, axis-0 rows q0 - 4 .. q0 + 4 and axis-1 rows q1 - 4 .. q1 +
//   kRows - 1 (45 at most), form one sequence in (source pencil, slot)
//   order, so a pencil is walked by (9 / 5) 5 = 9 blocks on average.  A slot
//   is kept when it is in the margin and one of its axis-0 taps lands on
//   the tile; it makes an entry for each tile row its axis-1 tap lands on.
//   (Tiles of two rows walk each pencil 5.4 times, but were slower at the
//   8M slab: scripts/p2g3d_grid_variants.py's rows2.)
//   Walk 0 reads the slots' positions once and keeps each slot's tag (its
//   base z column and its rows) in shared memory, kSeq slots at a time (a
//   longer sequence is walked again in parts), and reduces the z range
//   the kept slots reach.  The columns outside it have zero sums and go
//   through the node pass as such.  The range is summed in rounds of
//   columns.  A round counts each step of 32 slots' entries and
//   cuts the steps into chunks of at most `cap` entries (the host's
//   planner picks cap so that a chunk's records fit the shared memory of
//   two blocks an SM; a crowded pencil takes more chunks, never more
//   memory), each warp a contiguous range of a chunk's steps.  A chunk: a
//   counting sort per (key = tile row, base column; warp) and an exclusive
//   scan give each entry its list position, by key and, within a key, in
//   sequence order; each thread then loads its kept slots' fields and
//   writes a record for each of their entries straight to its position
//   (rec3d::Rec: the slot's axis-1 tap on that row folded in, its first
//   axis-0 target t0 in -2 .. 4).  Thread s of a (row, column) sums its
//   list positions p0 + s, p0 + s + 4, ... (base columns c - 2 .. c) into
//   the five axis-0 targets' nch channels in registers, the 4 threads add
//   their shares in a fixed butterfly, and the chunk's sums are added to
//   the round's sums in shared memory, each value by one thread, chunk
//   after chunk.  A round holds 64 / kRows columns.  After the round, every node of the tile in its columns
//   goes through the node pass from those sums and is written once (and
//   its raw sums, when asked): mass floor, v_old = pure / m, v_new =
//   forced / m + dt g (or the diagonal penalty solve), slip clamps or the
//   sticky zero on the wall bands of the three axes, the colliders'
//   projection of v_new (models/colliders.project) on interior rows, the
//   ext averages.
//   Every sum has an order fixed by the inputs alone (the parts, the
//   rounds and the chunks follow the counts and the positions), whatever
//   order the warps ran in: reruns are bitwise equal, as the TPU kernel's
//   are.  The raw mode and the non-raw mode's `raw` run the same sums, so
//   at one shard they are bitwise equal.  Integer shared atomics
//   (atomicMin / atomicMax of the z range) are the only atomics.
// Colliders: at most colliders::kMax, passed by value in the launch's
// parameters (colliders.cuh, shared with p2g.cu's 2D node pass, which
// computes the inside test with round-to-nearest intrinsics so that it
// agrees with PyTorch's bit for bit).  `kin` = 0 (no moving collider, or no
// time) leaves every center where the host put it, bit for bit a time-free
// build; the host casts the constants to float32 as JAX does.  The
// projection costs about 30 flops and no bytes per node.  Offsets are
// 64-bit: R0 R1 K passes 2^31 at 256^3.
//
// What bounds it on the H100: the walks and the records, not bytes or
// flops.  Each slot is walked by some 9 blocks (12 bytes of positions each
// time), and its three entries' records (one a target row on axis 1),
// 80-112 bytes built from its 72 bytes of state (stress) or 80-116 of
// prepped fields, are staged by some 1.4 blocks each; each chunk's sort
// and sums end in block-wide barriers, at two blocks of 256 threads an SM.
// Every node is written once, 6 or 9 floats (7 or 11 raw).

#include <climits>

#include <cuda_runtime.h>

#include "colliders.cuh"
#include "taps.cuh"

namespace {

using colliders::Colliders;
using rec3d::kNT;             // target planes of a tile on axis 0

constexpr int kHalo = 4;      // a target plane takes source rows q - 4 .. q
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks resident on an SM: the register cap of __launch_bounds__ (128:
// a thread holds 5 kNch sums) and the shared-memory budget of the host's
// planner (transfer3d.py's GRID3D_BLOCKS_PER_SM) follow it.
constexpr int kBlocksPerSM = 2;
// Sequence slots whose tags a block keeps in shared memory at once (a
// longer sequence is walked in parts of kSeq), and their steps of 32.
constexpr int kSeq = 8192;
constexpr int kSteps = kSeq / 32;
constexpr int kRows = 1;      // target planes of a tile on axis 1
// Threads a (row, z column): thread s sums its list positions p0 + s, p0 +
// s + kSplit, ...; a fixed butterfly adds the shares.  kCols columns a
// round, kKeys sort keys (row, base column).
constexpr int kSplit = 4;
constexpr int kCols = kThreads / (kSplit * kRows);
constexpr int kKeys = kRows * (kCols + 2);
constexpr int kMaxSrc = (kNT + kHalo) * (kRows + kHalo);  // source pencils of a tile

// Shapes and the host's plan.
struct Plan {
  int R0, L0, R1, K, G2;
  int band;  // z columns a block (blockIdx.y)
  int cap;   // records staged at once: a chunk of at most cap entries
  int nt0;   // tiles of kNT planes per shard window on axis 0
  int nt1;   // tiles of kRows planes on axis 1
};

// Node-pass constants.
struct Node {
  float dtg[3];
  float floor_m;
  int lo, hi, wall;  // wall: 0 slip, 1 sticky, 2 penalty
  float dt_beta, dx;
};

// Dynamic shared bytes of a block: the chunk's records, the round's sums
// [kRows][kNT][kNch][kCols], the (key, warp) counters, the key starts, the
// steps' first entries and the tags of kSeq sequence slots.
template <int kNch, bool kApic>
size_t smem_bytes(int cap) {
  return sizeof(float4) * rec3d::Rec<kNch, kApic>::kVec * static_cast<size_t>(cap) +
         sizeof(float) * kRows * kNT * kNch * kCols +
         sizeof(int) * (kKeys * kWarps + kKeys + 1 + kSteps + 1) + sizeof(short) * kSeq;
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

// Tag of a slot at gx in source pencil (i0, i1) for the tile of planes
// [q0lo, q0lo + h0) x [q1lo, q1lo + h1) and the band of bw columns from zb:
// (the tile rows its axis-1 taps land on, a bit each) << 12 | (its base z
// column - (zb - 2)) when it is in the margin on both axes, one of its
// axis-0 taps lands on the tile and its z columns meet the band; else -1.
__device__ __forceinline__ int tag_of(float gx0, float gx1, float gx2, int i0, int i1, int q0lo,
                                      int h0, int q1lo, int h1, int zb, int bw) {
  const float base0 = floorf(gx0 - 0.5f), base1 = floorf(gx1 - 0.5f);
  const float base2 = floorf(gx2 - 0.5f);
  const float rel0 = base0 - static_cast<float>(i0), rel1 = base1 - static_cast<float>(i1);
  const float t0 = base0 + static_cast<float>(1 - q0lo);  // the first target's tile plane
  if (!(rel0 >= -1.0f && rel0 <= 1.0f && rel1 >= -1.0f && rel1 <= 1.0f && t0 >= -2.0f &&
        t0 <= static_cast<float>(h0 - 1) && base2 >= static_cast<float>(zb - 2) &&
        base2 <= static_cast<float>(zb + bw - 1))) {
    return -1;
  }
  // In the margin base1 is i1 - 1 .. i1 + 1: the axis-1 tap on row r is
  // j + r.
  const int j = q1lo - 1 - (i1 + static_cast<int>(rel1));
  int mask = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) mask |= r < h1 && j + r >= 0 && j + r <= 2 ? 1 << r : 0;
  return mask != 0 ? (mask << 12) | (static_cast<int>(base2) - (zb - 2)) : -1;
}

// One block per tile: blockIdx.x = (shard, axis-0 tile, axis-1 tile), the
// axis-1 tile fastest; blockIdx.y = z band.  kStress: the 18 state planes
// and the fluid stress (kNch = 7, B-spline); else the prepped planes.
template <int kNch, bool kTent, bool kStress, bool kApic>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
p2g3d_grid_kernel(taps::Prepped in, const int* __restrict__ counts, float* __restrict__ out,
                  float* __restrict__ raw, Plan pl, taps::Fluid fl, Node nd, float dx,
                  const __grid_constant__ Colliders cols) {
  using R = rec3d::Rec<kNch, kApic>;
  extern __shared__ float4 smem[];
  float4* stage = smem;                                                     // [cap][kVec]
  float* sums = reinterpret_cast<float*>(stage + static_cast<size_t>(pl.cap) * R::kVec);
  int* cnt = reinterpret_cast<int*>(sums + kRows * kNT * kNch * kCols);     // [kKeys kWarps]
  int* kstart = cnt + kKeys * kWarps;                                       // [kKeys + 1]
  int* estart = kstart + kKeys + 1;                                         // [kSteps + 1]
  short* tag = reinterpret_cast<short*>(estart + kSteps + 1);               // [kSeq]
  __shared__ int pre[kMaxSrc + 1];  // the source pencils' live slots, running sum
  __shared__ long long pencil_at[kMaxSrc];
  __shared__ int row_at[kMaxSrc];   // (i0 << 16) | i1, shard-local rows
  __shared__ int range[2];
  __shared__ int tmp[kWarps];

  const int rows1 = pl.R1 + kHalo;
  const int per_shard = pl.nt0 * pl.nt1;
  const int shard = blockIdx.x / per_shard;
  const int rem = blockIdx.x - shard * per_shard;
  const int q0lo = (rem / pl.nt1) * kNT, q1lo = (rem % pl.nt1) * kRows;
  const int h0 = min(kNT, pl.L0 + kHalo - q0lo), h1 = min(kRows, rows1 - q1lo);
  // Source rows q - 4 .. q of the tile's planes, inside the shard.
  const int s0lo = max(q0lo - kHalo, 0), s0hi = min(q0lo + h0 - 1, pl.L0 - 1);
  const int s1lo = max(q1lo - kHalo, 0), s1hi = min(q1lo + h1 - 1, pl.R1 - 1);
  const int n1 = max(s1hi - s1lo + 1, 0);
  const int npen = max(s0hi - s0lo + 1, 0) * n1;
  const int G2 = pl.G2;
  const int zb = blockIdx.y * pl.band;
  const int bw = min(pl.band, G2 - zb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < npen) {
    const int i0 = s0lo + threadIdx.x / n1, i1 = s1lo + threadIdx.x % n1;
    const long long pencil = static_cast<long long>(shard * pl.L0 + i0) * pl.R1 + i1;
    pencil_at[threadIdx.x] = pencil;
    row_at[threadIdx.x] = (i0 << 16) | i1;
    pre[threadIdx.x + 1] = max(min(counts[pencil], pl.K), 0);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    pre[0] = 0;
    for (int p = 0; p < npen; ++p) pre[p + 1] += pre[p];
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  const int nsrc = pre[npen];
  // Sequence slot v -> its source pencil p (the last whose running sum is
  // at most v: one with live slots), from a pencil p at or before it.
  auto advance = [&](int v, int& p) {
    while (p < npen - 1 && pre[p + 1] <= v) ++p;
  };
  auto locate = [&](int v) {
    int lo = 0, hi = npen - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= v) lo = mid;
      else hi = mid - 1;
    }
    return lo;
  };
  // Walk 0 over sequence slots [s0, s0 + n): each slot's tag into tag[v -
  // s0], and the least and greatest kept base column tag into range (with
  // `reduce`).  The loads of gather::kUnroll steps go out together.
  auto walk = [&](int s0, int n, bool reduce) {
    int lo, hi;
    gather::warp_range<kThreads>(n, lo, hi);
    int mn = INT_MAX, mx = INT_MIN;
    if (lo < hi) {
      int p = locate(s0 + min(lo + lane, hi - 1));
      for (int v = lo + lane; v < hi; v += 32 * gather::kUnroll) {
        float g[gather::kUnroll][3];
        int at[gather::kUnroll];
#pragma unroll
        for (int u = 0; u < gather::kUnroll; ++u) {
          const int w = s0 + min(v + 32 * u, hi - 1);
          advance(w, p);
          at[u] = p;
#pragma unroll
          for (int e = 0; e < 3; ++e) g[u][e] = in.at(taps::kGx + e, pencil_at[p], w - pre[p]);
        }
#pragma unroll
        for (int u = 0; u < gather::kUnroll; ++u) {
          if (v + 32 * u >= hi) continue;
          const int rows = row_at[at[u]];
          const int t = tag_of(g[u][0], g[u][1], g[u][2], rows >> 16, rows & 0xffff, q0lo, h0,
                               q1lo, h1, zb, bw);
          tag[v + 32 * u] = static_cast<short>(t);
          if (t >= 0) {
            mn = min(mn, t & 0xfff);
            mx = max(mx, t & 0xfff);
          }
        }
      }
    }
    if (reduce) gather::reduce_range(mn, mx, range);
  };

  const bool whole = nsrc <= kSeq;  // walk 0's tags serve every round
  for (int s0 = 0; s0 < nsrc; s0 += kSeq) walk(s0, min(kSeq, nsrc - s0), true);
  const int tmin = range[0], tmax = range[1];
  const bool any = tmin <= tmax;
  // Columns with sums: those the kept slots reach, inside the band.
  const int zlo = any ? max(zb, zb - 2 + tmin) : zb + bw;
  const int zhi = any ? min(zb + bw - 1, zb + tmax) : zb + bw - 1;
  const int ncols = zhi - zlo + 1;

  // The band's other columns: zero sums, the same node pass.
  {
    const int nz = bw - ncols;
    float zero[kNch];
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) zero[ch] = 0.0f;
    for (int e = threadIdx.x; e < h1 * h0 * nz; e += kThreads) {
      const int rt = e / nz, zi = zb + e - rt * nz;
      emit<kNch>(zero, shard, q0lo + rt % h0, q1lo + rt / h0, zi < zlo ? zi : zi + ncols, pl,
                 nd, cols, out, raw);
    }
  }
  if (!any) return;

  // The sums' threads: (tile row, column of the round, share).
  const int srow = threadIdx.x / (kCols * kSplit);
  const int col = (threadIdx.x % (kCols * kSplit)) / kSplit, share = threadIdx.x % kSplit;
  // Entries a chunk starts below: a step adds at most 32 kRows more.
  const int cmax = pl.cap - 32 * kRows;
  for (int c_lo = zlo; c_lo <= zhi; c_lo += kCols) {
    const int nr = min(kCols, zhi - c_lo + 1);
    const int nb = nr + 2;             // bins: base columns c_lo - 2 .. c_lo + nr - 1
    const int t_lo = c_lo - zb;        // their tags' columns: t_lo .. t_lo + nb - 1
    for (int e = threadIdx.x; e < kRows * kNT * kNch * kCols; e += kThreads) sums[e] = 0.0f;
    for (int s0 = 0; s0 < nsrc; s0 += kSeq) {
      const int ns = min(kSeq, nsrc - s0);
      const int nsteps = (ns + 31) >> 5;
      if (!whole) {
        __syncthreads();  // every chunk is done with the last part's tags
        walk(s0, ns, false);
        __syncthreads();
      }
      // The key (row r, bin) of this lane's slot in step st, or -1.
      auto key_at = [&](int st, int r) {
        const int v = (st << 5) + lane;
        const int t = v < ns ? tag[v] : -1;
        const int b = (t & 0xfff) - t_lo;
        return t >= 0 && ((t >> (12 + r)) & 1) && b >= 0 && b < nb ? r * nb + b : -1;
      };
      // Each step's entries, then each step's first entry (estart).
      for (int st = warp; st < nsteps; st += kWarps) {
        int e = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) e += key_at(st, r) >= 0;
        e = __reduce_add_sync(0xffffffffu, e);
        if (lane == 0) estart[st] = e;
      }
      const int entries = gather::exclusive_scan<kThreads>(estart, nsteps, tmp);
      // Chunk j: the steps whose first entry is in [j cmax, (j + 1) cmax),
      // at most cap entries; each warp a contiguous range of its steps.
      auto first_step = [&](int e) {
        int lo = 0, hi = nsteps;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (estart[mid] < e) lo = mid + 1;
          else hi = mid;
        }
        return lo;
      };
      for (int j = 0; j * cmax < entries; ++j) {
        const int sa = first_step(j * cmax), sb = first_step((j + 1) * cmax);
        const int span = (sb - sa + kWarps - 1) / kWarps;
        const int wa = min(sb, sa + warp * span), wb = min(sb, wa + span);
        const int nkeys = kRows * nb;
        for (int e = threadIdx.x; e < nkeys * kWarps; e += kThreads) cnt[e] = 0;
        __syncthreads();
        for (int st = wa; st < wb; ++st) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) gather::count_step<kWarps>(key_at(st, r), 0, cnt);
        }
        const int total = gather::exclusive_scan<kThreads>(cnt, nkeys * kWarps, tmp);
        for (int k = threadIdx.x; k <= nkeys; k += kThreads) {
          kstart[k] = k < nkeys ? cnt[k * kWarps] : total;
        }
        __syncthreads();
        // Each entry's record at its list position: the slot's fields
        // once, a record for each tile row it lands on.
        if (wa < wb) {
          int p = locate(s0 + min((wa << 5) + lane, ns - 1));
          for (int st = wa; st < wb; ++st) {
            int pos[kRows];
            bool some = false;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              pos[r] = gather::place_tag<kWarps>(key_at(st, r), 0, cnt);
              some = some || pos[r] >= 0;
            }
            if (!some) continue;
            const int v = s0 + (st << 5) + lane;
            advance(v, p);
            float f[rec3d::Fields<kNch, kApic>::kN];
            rec3d::load_fields<kNch, kApic, kStress>(in, pencil_at[p], v - pre[p], fl, f);
            const int t0 = static_cast<int>(floorf(f[0] - 0.5f)) + 1 - q0lo;
            const int base1 = static_cast<int>(floorf(f[1] - 0.5f));
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (pos[r] < 0) continue;
              float rec[4 * R::kVec];
              rec3d::rec_from<kNch, kTent, kApic>(f, t0, q1lo + r - 1 - base1, dx, rec);
              rec3d::put_rec<R::kVec>(rec, stage + static_cast<size_t>(pos[r]) * R::kVec);
            }
          }
        }
        __syncthreads();
        // Row srow, column c_lo + col: its entries are those of keys (srow,
        // col .. col + 2) (base columns c - 2, c - 1, c: z taps 2, 1, 0).
        float acc[kNT][kNch];
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
#pragma unroll
          for (int ch = 0; ch < kNch; ++ch) acc[t][ch] = 0.0f;
        }
        const bool has = col < nr && srow < h1;
        if (has) {
          const int k0 = srow * nb + col;
          const int p0 = kstart[k0], p1 = kstart[k0 + 1], p2 = kstart[k0 + 2];
          const int p3 = kstart[k0 + 3];
          for (int q = p0 + share; q < p3; q += kSplit) {
            const float jz = q < p1 ? 2.0f : (q < p2 ? 1.0f : 0.0f);
            rec3d::visit<kNch, kTent, kApic, -2, kNT - 1>(stage + static_cast<size_t>(q) * R::kVec,
                                                          jz, dx, acc);
          }
        }
        rec3d::butterfly<kNch, kSplit>(acc);
        if (has) {
          float* row_sums = sums + srow * kNT * kNch * kCols;
#pragma unroll
          for (int t = 0; t < kNT; ++t) {
#pragma unroll
            for (int ch = 0; ch < kNch; ++ch) {
              if ((t * kNch + ch) % kSplit != share) continue;
              row_sums[(t * kNch + ch) * kCols + col] += acc[t][ch];
            }
          }
        }
        __syncthreads();  // the next chunk reuses the counters and the records
      }
    }
    // The round's nodes, from its sums.
    for (int e = threadIdx.x; e < h1 * h0 * nr; e += kThreads) {
      const int rt = e / nr, c = e - rt * nr;
      const int r = rt / h0, t = rt - r * h0;
      const float* row_sums = sums + r * kNT * kNch * kCols;
      float v[kNch];
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) v[ch] = row_sums[(t * kNch + ch) * kCols + c];
      emit<kNch>(v, shard, q0lo + t, q1lo + r, c_lo + c, pl, nd, cols, out, raw);
    }
    __syncthreads();  // the next round zeroes the sums
  }
}

template <int kNch, bool kTent, bool kStress, bool kApic>
int launch_one(const taps::Prepped& in, const int* counts, float* out, float* raw,
               const Plan& pl, const taps::Fluid& fl, const Node& nd, float dx,
               const Colliders& cols, dim3 blocks, cudaStream_t s) {
  const size_t smem = smem_bytes<kNch, kApic>(pl.cap);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p2g3d_grid_kernel<kNch, kTent, kStress, kApic>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, s>>>(in, counts, out, raw, pl, fl, nd, dx, cols);
  return static_cast<int>(cudaGetLastError());
}

template <int kNch, bool kTent, bool kStress>
int launch(const taps::Prepped& in, const int* counts, float* out, float* raw, const Plan& pl,
           const taps::Fluid& fl, const Node& nd, float dx, int apic, const Colliders& cols,
           dim3 blocks, cudaStream_t s) {
  return apic ? launch_one<kNch, kTent, kStress, true>(in, counts, out, raw, pl, fl, nd, dx,
                                                       cols, blocks, s)
              : launch_one<kNch, kTent, kStress, false>(in, counts, out, raw, pl, fl, nd, dx,
                                                        cols, blocks, s);
}

// Checks the arguments shared by both entry points and fills the plan, the
// node constants and the colliders; returns a cudaError_t as int (0: go)
// and the launch's blocks (x: shard, axis-0 tile, axis-1 plane; y: band).
int prepare(float* raw, float* out, int R0, int L0, int R1, int K, int G2, int band, int cap,
            float dtg0, float dtg1, float dtg2, float floor_m, int lo, int hi, int wall,
            float dt_beta, float dx, const float* col_f, const int* col_i, int ncol, int kin,
            float tcol, int raw_only, Plan* pl, Node* nd, Colliders* cols, dim3* blocks) {
  // A chunk starts below cap - 32 kRows entries; a tag holds a column
  // of the band + 2 in 12 bits.
  if (L0 <= 0 || R0 % L0 != 0 || R1 <= 0 || K < 0 || G2 <= 0 || band <= 0 ||
      band > 4096 - 2 || cap <= 64 * kRows || (!raw_only && (L0 != R0 || out == nullptr)) ||
      (raw_only && (ncol != 0 || raw == nullptr)) ||
      !colliders::unpack(col_f, col_i, ncol, kin, tcol, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pl->R0 = R0;
  pl->L0 = L0;
  pl->R1 = R1;
  pl->K = K;
  pl->G2 = G2;
  pl->band = min(band, G2);
  pl->cap = cap;
  pl->nt0 = (L0 + kHalo + kNT - 1) / kNT;
  pl->nt1 = (R1 + kHalo + kRows - 1) / kRows;
  const long long n = static_cast<long long>(R0 / L0) * pl->nt0 * pl->nt1;
  const int nbands = (G2 + pl->band - 1) / pl->band;
  if (n > 0x7fffffffLL || nbands > 65535) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = dim3(static_cast<unsigned>(n), static_cast<unsigned>(nbands));
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
// kin: 1 puts the moving ones at time tcol.  band, cap: the plan
// (transfer3d.py's plan_p2g3d_grid: z columns a block, records staged at
// once, more than 128); its shared memory must fit the card's opt-in limit.
// Returns a cudaError_t as int.
extern "C" int mpm_p2g3d_grid(const void* const* planes, const long long* strides,
                              const int* counts, float* raw, float* out, int R0,
                              int L0, int R1, int K, int G2, float dx, int apic, int tait,
                              float kb, float kb_over_gamma, float gamma,
                              float two_mu, float fa, float dtg0, float dtg1,
                              float dtg2, float floor_m, int lo, int hi, int wall,
                              float dt_beta, const float* col_f, const int* col_i,
                              int ncol, int kin, float tcol, int raw_only, int band, int cap,
                              void* stream) {
  Plan pl;
  Node nd;
  Colliders cols{};
  dim3 blocks;
  const int rc = prepare(raw, out, R0, L0, R1, K, G2, band, cap, dtg0, dtg1, dtg2, floor_m,
                         lo, hi, wall, dt_beta, dx, col_f, col_i, ncol, kin, tcol, raw_only,
                         &pl, &nd, &cols, &blocks);
  if (rc != 0) return rc;
  if (blocks.x == 0) return static_cast<int>(cudaGetLastError());
  taps::Prepped in{};
  for (int e = 0; e < taps::kStressIn; ++e) {
    in.p[e] = static_cast<const float*>(planes[e]);
    in.stride[e] = strides[e];
  }
  const taps::Fluid fl{tait, kb, kb_over_gamma, gamma, two_mu, fa};
  return launch<7, false, true>(in, counts, raw_only ? nullptr : out, raw, pl, fl, nd, dx, apic,
                                cols, blocks, static_cast<cudaStream_t>(stream));
}

// Prepped mode.  planes / strides: 29 entries in the order of taps.cuh
// (null where the mode has no such plane); nch: 7, or 11 with the ext
// fields (then out has 9 channels); apic, tent: 0/1; L0, the colliders,
// raw_only and the plan as in mpm_p2g3d_grid.
extern "C" int mpm_p2g3d_grid_pdata(const void* const* planes, const long long* strides,
                                    const int* counts, float* raw, float* out, int R0,
                                    int L0, int R1, int K, int G2, int nch, int apic,
                                    int tent, float dx, float dtg0, float dtg1, float dtg2,
                                    float floor_m, int lo, int hi, int wall,
                                    float dt_beta, const float* col_f, const int* col_i,
                                    int ncol, int kin, float tcol, int raw_only, int band,
                                    int cap, void* stream) {
  if (nch != 7 && nch != 11) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  Node nd;
  Colliders cols{};
  dim3 blocks;
  const int rc = prepare(raw, out, R0, L0, R1, K, G2, band, cap, dtg0, dtg1, dtg2, floor_m,
                         lo, hi, wall, dt_beta, dx, col_f, col_i, ncol, kin, tcol, raw_only,
                         &pl, &nd, &cols, &blocks);
  if (rc != 0) return rc;
  if (blocks.x == 0) return static_cast<int>(cudaGetLastError());
  const taps::Prepped in = taps::prepped_from(planes, strides);
  const taps::Fluid fl{};
  float* o = raw_only ? nullptr : out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nch == 7) {
    return tent ? launch<7, true, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, s)
                : launch<7, false, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, s);
  }
  return tent ? launch<11, true, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, s)
              : launch<11, false, false>(in, counts, o, raw, pl, fl, nd, dx, apic, cols, blocks, s);
}
