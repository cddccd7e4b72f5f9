// Fixed-order scatter-add of the general path, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX general path scatters with XLA's `.at[].add`
// (mpm_flip98a_tpu/ops/transfer.py:70, stabilized.py's cell sums), which
// the port's plain version does with `index_add_`.  On the CPU `index_add_`
// adds the rows in their order; on the card it adds with atomics in no
// fixed order, so two runs differ in the last bits.  This kernel gives each
// node the CPU's order: the caller sorts the rows' flat node indices with a
// stable sort once per substep (ops/cuda/scatter.py, `segment_plan`), and
// node n sums rows order[starts[n]] .. order[starts[n + 1] - 1] from zero,
// one add after another, in ascending row position.  So on equal inputs
// the card and the CPU give bitwise equal sums, and reruns are equal.
//
// Contract:
//   values  (M, c) float32 or float64, contiguous (the masked contributions)
//   order   (M,) int64, the stable sort permutation of the rows' node ids
//   starts  (nodes + 1,) int64, node n's run in `order`
//   out     (nodes, c), every entry written (0 where the run is empty)
//
// Design: one thread per (node, channel), channel fastest, so the c threads
// of a node read one row of `values` together.  No shared memory, no
// atomics.  What bounds it on the H100: the gathered reads of `values`
// (each row once per channel thread, in sorted order: rows of nearby
// particles sit close), then the long runs of the densest nodes, which one
// thread walks alone.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values, const long long* __restrict__ order,
                   const long long* __restrict__ starts, T* __restrict__ out, long long nodes,
                   int c) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nodes * c) return;
  const long long node = i / c;
  const int ch = static_cast<int>(i - node * c);
  const long long hi = starts[node + 1];
  T acc = T(0);
  for (long long p = starts[node]; p < hi; ++p) acc = acc + values[order[p] * c + ch];
  out[i] = acc;
}

template <typename T>
int launch(const T* values, const long long* order, const long long* starts, T* out,
           long long nodes, int c, void* stream) {
  if (nodes < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = nodes * c;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(values, order, starts, out,
                                                               nodes, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t as int (0 on success): cudaErrorInvalidValue for a
// negative node count, c <= 0 or a grid past 2^31 blocks, else the launch's.
extern "C" int mpm_segment_sum_f32(const float* values, const long long* order,
                                   const long long* starts, float* out, long long nodes, int c,
                                   void* stream) {
  return launch<float>(values, order, starts, out, nodes, c, stream);
}

extern "C" int mpm_segment_sum_f64(const double* values, const long long* order,
                                   const long long* starts, double* out, long long nodes, int c,
                                   void* stream) {
  return launch<double>(values, order, starts, out, nodes, c, stream);
}
