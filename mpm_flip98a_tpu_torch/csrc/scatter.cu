// Fixed-order scatter-add of the general path, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX general path scatters with XLA's `.at[].add`
// (mpm_flip98a_tpu/ops/transfer.py:70, stabilized.py's cell sums), which
// the port's plain version does with `index_add_`.  On the CPU `index_add_`
// adds the rows in their order; on the card it adds with atomics in no
// fixed order, so two runs differ in the last bits.  This kernel gives each
// node the CPU's order: every node sums its rows from +0, one add after
// another, in ascending row position.  So on equal inputs the card and the
// CPU give bitwise equal sums, and reruns are equal.
//
// The plan (ops/cuda/scatter.py) sorts particles, not rows: one key a
// particle, its key cell, stably, so each cell's run lists its particles
// in ascending index.  With S taps a particle's row s lands on node
// base + off_s (off_s in {0, 1, 2}^d, s = o0 * 3^(d-1) + ... + o_{d-1}), so
// node n's rows are tap s of the particles of cells n - off_s: S runs, on
// a key grid widened by 2 on every axis so every particle with a tap in
// bounds has a cell.  A particle reaches a node through one tap at most,
// so merging the S runs by particle index is ascending row position.  The
// one-tap form (S = 1, bare rows) keys the node itself.
//
// Contract:
//   values  (N, S, c) float32, float64 or bfloat16, contiguous; read in
//           place, never at a tap that is out of bounds
//   order   (N,) int32, particles sorted stably by key cell
//   starts  (cells + 1,) int32, cell k's run order[starts[k] .. starts[k+1])
//   out     (nodes, c), every entry written (+0 where a node has no row)
//   nodes, c, S in {1, 9, 27}; g1, g2 the node shape's last axes
//           (S = 9: (nodes / g1, g1); S = 27: (nodes / (g1 g2), g1, g2));
//           key strides k1 = (g1 + 2)(g2 + 2), k2 = g2 + 2 in 3D, k1 =
//           g1 + 2 in 2D.  Particle indices below 2^27 (index x 32 + tap
//           fits 32 bits).
//
// Design.  A thread a node merges its S runs: the runs' heads, packed as
// index x 32 + tap, sit in registers, the run cursors in shared memory
// (one column a thread, no bank conflicts); each step takes the least
// head, loads that row (16- or 8-byte loads where c allows), advances its
// run and adds the previous row, so the row's loads are off the sum's
// dependent chain.  In 3D a block's nodes are a 4 x 8 x 4 tile (a thin
// slab of fluid leaves few lanes idle; in rows of 128 the slab 1M cell took
// 1.9x as long).  A node whose longest run exceeds kHeavyRun (a dense
// cell: thousands of particles at one point) goes to its whole warp
// instead, after the warp's other nodes: a lane a run, the least head by a
// warp reduction, then every element of that run below the next run's head
// (up to 32) at once: their rows are staged in shared memory with all loads
// in flight and added in order, a lane a channel.  What bounds it on the
// H100: the gathered row reads (each row once, but a node's rows belong to
// particles far apart in memory, so sectors are fetched per row) and, in
// 3D, the merge's instructions (about 2 S + 30 a row).
//
// bfloat16 (the JAX package's bf16 mode): XLA's CPU scatter rounds the
// node's sum to bfloat16 after every add, in update order.  The bf16 mode
// keeps the same plan and walks and sums each node's rows in float32 from
// +0, rounding the sum to bfloat16 (`__float2bfloat16_rn`) after every add,
// so it equals that sequential sum bit for bit (a float32 sum of two
// bfloat16 values rounds to bfloat16 as their exact sum does: 24 >= 2 x 8 + 2
// bits).  Rows load 8 bf16 values per 16 bytes (4 per 8, 2 per 4) where the
// row width allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCh = 8;             // channels summed per walk
constexpr int kHeavyRun = 64;      // a node with a longer run is walked by its warp
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;

// The sum's type and its one add: float32 and float64 add in their own
// type; bfloat16 adds in float32 and rounds the sum to bfloat16 every time.
template <typename T>
struct Acc {
  using type = T;
  __device__ __forceinline__ static T in(T v) { return v; }
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  __device__ __forceinline__ static T out(T a) { return a; }
};

template <>
struct Acc<__nv_bfloat16> {
  using type = float;
  __device__ __forceinline__ static float in(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
  }
  __device__ __forceinline__ static __nv_bfloat16 out(float a) { return __float2bfloat16_rn(a); }
};

struct Shape {
  long long nodes;
  int g0, g1, g2;   // the node shape (3D; in 2D g1 alone is read)
  int k1, k2;       // key strides of axes 0 and 1 (3D) or axis 0 (2D, k1)
  int t1, t2;       // tiles along axes 1 and 2
};

// This thread's node, or -1.  In 3D a block's nodes are a tile of
// 4 x 8 x 4, a warp on one axis-0 index of it; in 2D and the one-tap
// form, 128 consecutive nodes.
template <int S>
__device__ __forceinline__ long long node_of(const Shape& g) {
  const int tid = threadIdx.x;
  if (S != 27) {
    const long long n = static_cast<long long>(blockIdx.x) * kThreads + tid;
    return n < g.nodes ? n : -1;
  }
  const int b2 = blockIdx.x % g.t2, r = blockIdx.x / g.t2;
  const int b1 = r % g.t1, b0 = r / g.t1;
  const int i0 = b0 * 4 + (tid >> 5), i1 = b1 * 8 + ((tid & 31) >> 2), i2 = b2 * 4 + (tid & 3);
  return i0 < g.g0 && i1 < g.g1 && i2 < g.g2
             ? (static_cast<long long>(i0) * g.g1 + i1) * g.g2 + i2
             : -1;
}

// Node n's own key cell: its coordinates + 2 on the widened key grid.
template <int S>
__device__ __forceinline__ int key_of(long long n, const Shape& g) {
  if (S == 1) return static_cast<int>(n);
  if (S == 9) {
    const int i1 = static_cast<int>(n % g.g1);
    const int i0 = static_cast<int>(n / g.g1);
    return (i0 + 2) * g.k1 + i1 + 2;
  }
  const int i2 = static_cast<int>(n % g.g2);
  const long long t = n / g.g2;
  const int i1 = static_cast<int>(t % g.g1);
  const int i0 = static_cast<int>(t / g.g1);
  return (i0 + 2) * g.k1 + (i1 + 2) * g.k2 + i2 + 2;
}

// Tap s's offset on the key grid: node n's tap-s run is cell key_of(n) - delta.
template <int S>
__device__ __forceinline__ int delta_of(int s, const Shape& g) {
  if (S == 1) return 0;
  if (S == 9) return (s / 3) * g.k1 + s % 3;
  return (s / 9) * g.k1 + ((s / 3) % 3) * g.k2 + s % 3;
}

// `bytes` bytes of a row as k values, widened to the sum's type.
template <typename T, typename W, int k>
__device__ __forceinline__ void load_vec(const T* at, typename Acc<T>::type* v) {
  const W raw = __ldg(reinterpret_cast<const W*>(at));
  const T* got = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < k; ++j) v[j] = Acc<T>::in(got[j]);
}

// A row's cw channels into v (the rest +0), in loads of `vec` values: 16,
// 8 or 4 bytes where every row's start and cw allow it (one thread reads a
// whole row; neighbouring threads read rows of other particles).
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int cw, int vec,
                                         typename Acc<T>::type (&v)[kCh]) {
  using A = typename Acc<T>::type;
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) v[ch] = A(0);
  if (vec * sizeof(T) == 16) {
    constexpr int k = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kCh; i += k)
      if (i < cw) load_vec<T, uint4, k>(row + i, v + i);
  } else if (vec * sizeof(T) == 8 && sizeof(T) <= 4) {
    constexpr int k = 8 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kCh; i += k)
      if (i < cw) load_vec<T, uint2, k>(row + i, v + i);
  } else if (vec * sizeof(T) == 4 && sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < kCh; i += 2)
      if (i < cw) load_vec<T, unsigned, 2>(row + i, v + i);
  } else {
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch)
      if (ch < cw) v[ch] = Acc<T>::in(row[ch]);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ order,
                   const int* __restrict__ starts, T* __restrict__ out, Shape g, int c, int vec) {
  using A = typename Acc<T>::type;
  constexpr int kShift = S > 1 ? 5 : 0;
  __shared__ int s_cur[S][kThreads];
  __shared__ int s_end[S][kThreads];
  __shared__ T s_rows[kWarps][32 * kCh];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long n = node_of<S>(g);
  const bool valid = n >= 0;
  const int kc = valid ? key_of<S>(n, g) : 0;

  for (int c0 = 0; c0 < c; c0 += kCh) {
    const int cw = min(kCh, c - c0);
    int longest = 0;
    uint32_t head[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      int b = 0, e = 0;
      if (valid) {
        const int key = kc - delta_of<S>(s, g);
        b = starts[key];
        e = starts[key + 1];
      }
      s_cur[s][tid] = b;
      s_end[s][tid] = e;
      longest = max(longest, e - b);
      head[s] = b < e ? (static_cast<uint32_t>(order[b]) << kShift) | s : kNone;
    }
    const bool heavy = longest > kHeavyRun;

    if (valid && !heavy) {
      A acc[kCh], pend[kCh];
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) acc[ch] = pend[ch] = A(0);
      while (true) {
        uint32_t m = head[0];
#pragma unroll
        for (int s = 1; s < S; ++s) m = min(m, head[s]);
        if (m == kNone) break;
        const int s = S > 1 ? static_cast<int>(m & 31u) : 0;
        const T* row = values + ((static_cast<long long>(m >> kShift) * S + s) * c + c0);
        A v[kCh];
        load_row(row, cw, vec, v);
        const int pos = s_cur[s][tid] + 1;
        s_cur[s][tid] = pos;
        const uint32_t nh =
            pos < s_end[s][tid] ? (static_cast<uint32_t>(order[pos]) << kShift) | s : kNone;
#pragma unroll
        for (int t = 0; t < S; ++t) head[t] = t == s ? nh : head[t];
        // The row before this one: +0 ahead of the first row leaves the sum
        // bitwise unchanged (0 + 0 is +0).
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          acc[ch] = Acc<T>::add(acc[ch], pend[ch]);
          pend[ch] = v[ch];
        }
      }
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch)
        if (ch < cw) out[n * c + c0 + ch] = Acc<T>::out(Acc<T>::add(acc[ch], pend[ch]));
    }

    // The warp's dense nodes, one after another, by the whole warp.
    unsigned dense = __ballot_sync(kFull, valid && heavy);
    T* rows = s_rows[tid >> 5];
    while (dense) {
      const int h = __ffs(dense) - 1;
      dense &= dense - 1;
      const long long hn = __shfl_sync(kFull, n, h);
      const int hkc = __shfl_sync(kFull, kc, h);
      int cur = 0, end = 0;
      if (lane < S) {
        const int key = hkc - delta_of<S>(lane, g);
        cur = starts[key];
        end = starts[key + 1];
      }
      uint32_t hd = cur < end ? static_cast<uint32_t>(order[cur]) : kNone;
      A acc = A(0);
      while (true) {
        const uint32_t m1 = __reduce_min_sync(kFull, hd);
        if (m1 == kNone) break;
        const int owner = __ffs(__ballot_sync(kFull, hd == m1)) - 1;
        const uint32_t m2 = __reduce_min_sync(kFull, lane == owner ? kNone : hd);
        const int oc = __shfl_sync(kFull, cur, owner);
        const int oe = __shfl_sync(kFull, end, owner);
        // The owner's next 32 elements; those below the next head come
        // first in the merged order (a run is sorted, so they are a prefix).
        const uint32_t q = oc + lane < oe ? static_cast<uint32_t>(order[oc + lane]) : kNone;
        const int k = __popc(__ballot_sync(kFull, q < m2));
#pragma unroll
        for (int u = 0; u < kCh; ++u) {
          const int e = lane + 32 * u, j = e / kCh, ch = e % kCh;
          const uint32_t qj = __shfl_sync(kFull, q, j);
          if (j < k && ch < cw)
            rows[e] = values[(static_cast<long long>(qj) * S + owner) * c + c0 + ch];
        }
        __syncwarp();
        if (lane < cw) {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (j < k) acc = Acc<T>::add(acc, Acc<T>::in(rows[j * kCh + lane]));
        }
        __syncwarp();
        const uint32_t after = __shfl_sync(kFull, q, k & 31);
        if (lane == owner) {
          cur = oc + k;
          hd = cur < oe ? (k < 32 ? after : static_cast<uint32_t>(order[cur])) : kNone;
        }
      }
      if (lane < cw) out[hn * c + c0 + lane] = Acc<T>::out(acc);
    }
  }
}

// The plan's key of each particle: its base node + 2 on the key grid
// (g + 2 on every axis), row-major, or `cells` where it has no tap in
// bounds or keep is 0.
__global__ void stencil_keys_kernel(const long long* __restrict__ base,
                                    const unsigned char* __restrict__ keep, int n, int d, int g0,
                                    int g1, int g2, int* __restrict__ keys) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int g[3] = {g0, g1, g2};
  int key = 0;
  bool ok = keep == nullptr || keep[i] != 0;
  for (int k = 0; k < d; ++k) {
    const long long b = base[static_cast<long long>(i) * d + k];
    ok = ok && b >= -2 && b < g[k];
    key = key * (g[k] + 2) + static_cast<int>(ok ? b + 2 : 0);
  }
  int cells = 1;
  for (int k = 0; k < d; ++k) cells *= g[k] + 2;
  keys[i] = ok ? key : cells;
}

template <typename T, int S>
int launch_taps(const T* values, const int* order, const int* starts, T* out,
                const Shape& g, int c, cudaStream_t stream) {
  long long blocks = (g.nodes + kThreads - 1) / kThreads;
  if (S == 27) blocks = static_cast<long long>((g.g0 + 3) / 4) * g.t1 * g.t2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // Rows start at multiples of c values: 16-, 8- or 4-byte loads where c
  // allows.
  const int bytes = c * static_cast<int>(sizeof(T));
  int vec = (bytes % 16 == 0  ? 16
             : bytes % 8 == 0 ? 8
             : bytes % 4 == 0 ? 4
                              : static_cast<int>(sizeof(T))) /
            static_cast<int>(sizeof(T));
  if (reinterpret_cast<uintptr_t>(values) % (vec * sizeof(T))) vec = 1;
  segment_sum_kernel<T, S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      values, order, starts, out, g, c, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* values, const int* order, const int* starts, T* out, long long nodes,
           int c, int taps, int g1, int g2, void* stream) {
  if (nodes < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nodes == 0) return static_cast<int>(cudaGetLastError());
  Shape g{nodes, 0, g1, g2, 0, 0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 1:
      return launch_taps<T, 1>(values, order, starts, out, g, c, st);
    case 9:
      if (g1 <= 0 || nodes % g1) return static_cast<int>(cudaErrorInvalidValue);
      g.k1 = g1 + 2;
      return launch_taps<T, 9>(values, order, starts, out, g, c, st);
    case 27:
      if (g1 <= 0 || g2 <= 0 || nodes % (static_cast<long long>(g1) * g2))
        return static_cast<int>(cudaErrorInvalidValue);
      g.g0 = static_cast<int>(nodes / (static_cast<long long>(g1) * g2));
      g.k1 = (g1 + 2) * (g2 + 2);
      g.k2 = g2 + 2;
      g.t1 = (g1 + 7) / 8;
      g.t2 = (g2 + 3) / 4;
      return launch_taps<T, 27>(values, order, starts, out, g, c, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns a cudaError_t as int (0 on success): cudaErrorInvalidValue for a
// negative node count, c <= 0, a tap count other than 1, 9 or 27, a node
// count that the shape does not divide or a grid past 2^31 blocks, else
// the launch's.
extern "C" int mpm_segment_sum_f32(const float* values, const int* order,
                                   const int* starts, float* out, long long nodes, int c,
                                   int taps, int g1, int g2, void* stream) {
  return launch<float>(values, order, starts, out, nodes, c, taps, g1, g2, stream);
}

extern "C" int mpm_segment_sum_f64(const double* values, const int* order,
                                   const int* starts, double* out, long long nodes, int c,
                                   int taps, int g1, int g2, void* stream) {
  return launch<double>(values, order, starts, out, nodes, c, taps, g1, g2, stream);
}

// bfloat16 rows, each node's sum rounded to bfloat16 after every add.
extern "C" int mpm_segment_sum_bf16(const __nv_bfloat16* values, const int* order,
                                    const int* starts, __nv_bfloat16* out, long long nodes,
                                    int c, int taps, int g1, int g2, void* stream) {
  return launch<__nv_bfloat16>(values, order, starts, out, nodes, c, taps, g1, g2, stream);
}

// Returns a cudaError_t as int: cudaErrorInvalidValue for d other than 2 or
// 3 or a negative n, else the launch's.
extern "C" int mpm_stencil_keys(const long long* base, const unsigned char* keep, int n, int d,
                                int g0, int g1, int g2, int* keys, void* stream) {
  if (n < 0 || d < 2 || d > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    stencil_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(base, keep, n, d, g0, g1, g2,
                                                               keys);
  return static_cast<int>(cudaGetLastError());
}
