// A variant of the port's fixed-order scatter (csrc/scatter.cu) kept for
// measurement only: scripts/scatter_variants.py builds it beside the
// committed kernel and times it on the same plan.  Nothing in the package
// calls it.
//
// Design: one warp a node, a lane on each of its S runs (the plan and the
// contract are csrc/scatter.cu's).  The node's rows are taken in windows
// of kWin ranks of the merged order.  In a window every row still to come
// in each run, up to kWin a run, finds its rank in parallel: its index in
// its own run plus, in each other run, the count of smaller particle
// indices (a binary search).  The rows whose rank falls in the window are
// loaded into shared memory at their ranks, with all loads in flight, and
// a lane a channel adds them in rank order from +0.  Each run's rows in
// the window are a prefix of what is left of it, so its cursor moves on by
// their count.  Entry points: csrc/scatter.cu's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kCh = 8;
constexpr int kWin = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  long long nodes;
  int g1, g2;
  int k1, k2;
};

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

template <int S>
__device__ __forceinline__ int delta_of(int s, const Shape& g) {
  if (S == 1) return 0;
  if (S == 9) return (s / 3) * g.k1 + s % 3;
  return (s / 9) * g.k1 + ((s / 3) % 3) * g.k2 + s % 3;
}

// First position in order[lo, hi) whose particle index is not below p.
__device__ __forceinline__ int lower_bound(const int* order, int lo, int hi, int p) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (order[mid] < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
warp_rank_kernel(const T* __restrict__ values, const int* __restrict__ order,
                 const int* __restrict__ starts, T* __restrict__ out, Shape g, int c) {
  __shared__ int s_b[kWarps][32], s_e[kWarps][32], s_a[kWarps][32], s_pre[kWarps][33];
  __shared__ int s_take[kWarps][32];
  __shared__ T s_rows[kWarps][kWin * kCh];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (n >= g.nodes) return;   // whole warps only
  const int kc = key_of<S>(n, g);
  int b = 0, e = 0;
  if (lane < S) {
    const int key = kc - delta_of<S>(lane, g);
    b = starts[key];
    e = starts[key + 1];
  }
  s_b[w][lane] = b;
  s_e[w][lane] = e;
  s_a[w][lane] = b;
  int total = e - b;
#pragma unroll
  for (int o = 16; o; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
  __syncwarp();
  for (int c0 = 0; c0 < c; c0 += kCh) {
    const int cw = min(kCh, c - c0);
    s_a[w][lane] = b;
    T acc = T(0);
    for (int w0 = 0; w0 < total; w0 += kWin) {
      // This window's candidates: up to kWin left in each run.
      const int left = lane < S ? min(kWin, s_e[w][lane] - s_a[w][lane]) : 0;
      int pre = left;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, pre, o);
        if (lane >= o) pre += t;
      }
      s_pre[w][lane + 1] = pre;
      if (lane == 0) s_pre[w][0] = 0;
      s_take[w][lane] = 0;
      __syncwarp();
      const int cand = s_pre[w][32];
      for (int t = lane; t < cand; t += 32) {
        int s = 0;
        while (s_pre[w][s + 1] <= t) ++s;
        const int j = s_a[w][s] + (t - s_pre[w][s]);
        const int p = order[j];
        int rank = j - s_b[w][s];
        for (int o = 0; o < S; ++o)
          if (o != s) rank += lower_bound(order, s_b[w][o], s_e[w][o], p) - s_b[w][o];
        if (rank < w0 + kWin) {
          atomicAdd(&s_take[w][s], 1);
          const T* row = values + (static_cast<long long>(p) * S + s) * c + c0;
          T* dst = s_rows[w] + (rank - w0) * kCh;
          for (int ch = 0; ch < cw; ++ch) dst[ch] = row[ch];
        }
      }
      __syncwarp();
      const int here = min(kWin, total - w0);
      if (lane < cw)
        for (int r = 0; r < here; ++r) acc = acc + s_rows[w][r * kCh + lane];
      if (lane < S) s_a[w][lane] += s_take[w][lane];
      __syncwarp();
    }
    if (lane < cw) out[n * c + c0 + lane] = acc;
  }
}

template <typename T, int S>
int launch_taps(const T* values, const int* order, const int* starts, T* out,
                const Shape& g, int c, cudaStream_t stream) {
  const long long blocks = (g.nodes + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  warp_rank_kernel<T, S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      values, order, starts, out, g, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* values, const int* order, const int* starts, T* out, long long nodes,
           int c, int taps, int g1, int g2, void* stream) {
  if (nodes < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nodes == 0) return static_cast<int>(cudaGetLastError());
  Shape g{nodes, g1, g2, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 1:
      return launch_taps<T, 1>(values, order, starts, out, g, c, st);
    case 9:
      g.k1 = g1 + 2;
      return launch_taps<T, 9>(values, order, starts, out, g, c, st);
    case 27:
      g.k1 = (g1 + 2) * (g2 + 2);
      g.k2 = g2 + 2;
      return launch_taps<T, 27>(values, order, starts, out, g, c, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

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
