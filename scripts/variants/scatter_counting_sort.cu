// A hand-written counting sort for the fixed-order scatter's plan, kept
// for measurement only: scripts/scatter_variants.py times it against the
// plan's `torch.sort(stable=True)` on the same int32 keys and checks that
// it gives the same order and starts.  Nothing in the package calls it.
//
// Three launches around a `torch.cumsum`: each key counted with an atomic
// add (the counts do not depend on the order of the adds), each particle
// placed in its cell's run at a slot taken by an atomic add (in no fixed
// order), then each run sorted by particle index, a thread a cell
// (insertion sort: the runs of the general path hold a few particles; a
// dense cell's run costs its length squared).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void count_keys(const int* __restrict__ keys, int n, int* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) atomicAdd(&counts[keys[i]], 1);
}

__global__ void place_keys(const int* __restrict__ keys, int n, const int* __restrict__ starts,
                           int* __restrict__ cursor, int* __restrict__ order) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = keys[i];
  order[starts[k] + atomicAdd(&cursor[k], 1)] = i;
}

__global__ void sort_runs(int* __restrict__ order, const int* __restrict__ starts, int cells) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= cells) return;
  const int lo = starts[k], hi = starts[k + 1];
  for (int i = lo + 1; i < hi; ++i) {
    const int v = order[i];
    int j = i - 1;
    while (j >= lo && order[j] > v) {
      order[j + 1] = order[j];
      --j;
    }
    order[j + 1] = v;
  }
}

int blocks(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

// counts: (cells + 1,) zeroed by the caller.
extern "C" int mpm_count_keys(const int* keys, int n, int* counts, void* stream) {
  if (n > 0)
    count_keys<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(keys, n, counts);
  return static_cast<int>(cudaGetLastError());
}

// starts: (cells + 2,) exclusive sums of the counts; cursor (cells + 1,) zeroed.
extern "C" int mpm_place_keys(const int* keys, int n, const int* starts, int* cursor,
                              int* order, void* stream) {
  if (n > 0)
    place_keys<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(keys, n, starts,
                                                                             cursor, order);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpm_sort_runs(int* order, const int* starts, int cells, void* stream) {
  if (cells > 0)
    sort_runs<<<blocks(cells), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(order, starts,
                                                                                cells);
  return static_cast<int>(cudaGetLastError());
}
