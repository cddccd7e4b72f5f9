// Expanded 3D P2G of prepped fields over pencil-bucketed particles, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `p2g3d` in
// mpm_flip98a_tpu/ops/pallas/transfer3d.py (def :349, pallas_call :408,
// body _p2g3d_kernel :118 -> _p2g3d_chunk :193) in its prepped mode
// (stress=None), PIC or APIC, 7 or 11 channels, B-spline or tent taps,
// without halo1.  The TPU kernel scatters along z with one-hot MXU
// products, one program per batch of 8 source pencils, accumulating into
// an output block that stays in VMEM across the sequential axis-1 grid
// steps; GPU blocks run in no order, so here the block is turned round: it
// owns one target and pulls from the sources.
//
// Contract (same as the TPU kernel):
//   planes  the prepped fields in the fixed order of taps.cuh: gx (3),
//           m v (3), P (9, APIC only), Q (9), m, and with kNch = 11
//           [V0 J, V0, V0 p, V0 div]; each (R0, R1, K) f32 with its own
//           pencil stride, value planes pre-masked (zeros in dead slots)
//   counts  (R0 * R1,) i32 packed pencil counts (active slots first)
//   out     (R0, 5, G1, kNch, G2) f32: out[i0, t0, row] is bucket row i0's
//           share of target rows (i0 + t0 - 1, row); channels [m v pure
//           (3), m v forced (3), m (, V0 J, V0, V0 p, V0 div)].
// Forced momentum gets w (m v_a + Q_a0 rdp0 + Q_a1 rdp1 + Q_a2 (c - gx2)
// dx); pure momentum the same with P under APIC and w m v_a under PIC.  A
// slot contributes only when its base row on both bucketed axes is within
// +-1 of its pencil's; slots at or past the count are skipped; taps whose
// axis-1 row is outside [0, G1) or whose z column is outside [0, G2) are
// dropped.
//
// Design: one block per (i0, target axis-1 row, z band).  The block owns
// out[i0, :, row, :, band] outright, so it accumulates in a (5, kNch,
// band) shared-memory slab and writes it once, zeros included: no global
// atomics, no memset of the 3.7 GB output at 256^3.  It walks the slots of
// the five source pencils i1 = row - 3 .. row + 1 and adds, for each slot
// whose stencil has an axis-1 tap on `row`, that tap's 3 x 3 (axis 0, z)
// nodes.  The band is all G2 columns while the slab fits the card's opt-in
// shared memory (56 KB at kNch = 11, G2 = 256); past that the host splits
// z into equal bands.  Offsets into the output are 64-bit.
//
// What bounds it on the H100: bytes and shared-memory atomics, not flops.
// Every live slot is read by up to 5 blocks (3 of them use it: 9 kNch
// shared atomic adds each) and each block writes 5 kNch band floats, most
// of them zeros where the particles fill a thin layer.  Shared atomics add
// in a run-dependent order, so the result is not bitwise deterministic: it
// agrees with the plain version to fp32 rounding of each node's sum.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kNT = 5;      // candidate target rows per bucketed axis
constexpr int kThreads = 256;

// Four blocks per SM (64 registers a thread): four 56 KB slabs fill the
// shared memory at kNch = 11, G2 = 256, and the tent instantiation would
// otherwise take 74 registers and run three.
template <int kNch, bool kTent>
__global__ void __launch_bounds__(kThreads, 4)
p2g3d_kernel(taps::Prepped in, const int* __restrict__ counts,
             float* __restrict__ out, int R1, int G1, int G2, int band,
             float dx, int apic) {
  extern __shared__ float slab[];   // [kNT][kNch][band]
  const int i0 = blockIdx.x / G1;
  const int row = blockIdx.x % G1;
  const int c0 = blockIdx.y * band;
  const int width = min(band, G2 - c0);
  const int n_slab = kNT * kNch * band;
  for (int e = threadIdx.x; e < n_slab; e += blockDim.x) slab[e] = 0.0f;
  __syncthreads();

  const float fi0 = static_cast<float>(i0);
  for (int t1 = 0; t1 < kNT; ++t1) {
    // Source pencil i1 puts its target slot t1 on row i1 + t1 - 1.
    const int i1 = row + 1 - t1;
    if (i1 < 0 || i1 >= R1) continue;
    const long long pencil = static_cast<long long>(i0) * R1 + i1;
    const int count = counts[pencil];
    const float fi1 = static_cast<float>(i1);
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const float gx1 = in.at(taps::kGx + 1, pencil, k);
      const float base1 = floorf(gx1 - 0.5f);
      const float rel1 = base1 - fi1;
      if (!(rel1 >= -1.0f && rel1 <= 1.0f)) continue;  // outside the margin
      const int j1 = t1 - 1 - static_cast<int>(rel1);  // the tap that hits `row`
      if (j1 < 0 || j1 > 2) continue;
      const float gx0 = in.at(taps::kGx, pencil, k);
      const float base0 = floorf(gx0 - 0.5f);
      const float rel0 = base0 - fi0;
      if (!(rel0 >= -1.0f && rel0 <= 1.0f)) continue;
      const float gx2 = in.at(taps::kGx + 2, pencil, k);
      const float base2 = floorf(gx2 - 0.5f);
      // The slot's columns base2 .. base2 + 2 must meet this block's band.
      if (base2 + 2.0f < static_cast<float>(c0) ||
          base2 >= static_cast<float>(c0 + width)) continue;

      taps::Slot<kNch> slot;
      taps::load_slot<kNch, kTent>(in, pencil, k, apic, gx2, base2, G2, dx, slot);
      float w0[3], w1[3];
      taps::axis<kTent>(gx0 - base0, w0);
      taps::axis<kTent>(gx1 - base1, w1);
      const float w1j = j1 == 0 ? w1[0] : (j1 == 1 ? w1[1] : w1[2]);
      const float rdp1 = (base1 + static_cast<float>(j1) - gx1) * dx;
      int col[3];  // the z taps' columns in this block's band, -1 outside
#pragma unroll
      for (int j2 = 0; j2 < 3; ++j2) {
        const int cb = slot.z[j2] < 0 ? -1 : slot.z[j2] - c0;
        col[j2] = (cb >= 0 && cb < width) ? cb : -1;
      }
      const int t0 = static_cast<int>(rel0) + 1;  // target slot of axis-0 tap j0 = 0
#pragma unroll
      for (int j0 = 0; j0 < 3; ++j0) {
        const float rdp0 = (base0 + static_cast<float>(j0) - gx0) * dx;
        const float w01 = w0[j0] * w1j;
        float pure[3], forced[3];
        taps::affine01(slot, rdp0, rdp1, pure, forced);
        float* s = slab + (t0 + j0) * kNch * band;
#pragma unroll
        for (int j2 = 0; j2 < 3; ++j2) {
          if (col[j2] < 0) continue;
          taps::add_tap(slot, pure, forced, j2, w01 * slot.wz[j2], s + col[j2], band);
        }
      }
    }
  }
  __syncthreads();
  // Slab rows (t0, ch) go to out[i0, t0, row, ch, c0 : c0 + width].
  const int n_out = kNT * kNch * width;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int r = e / width, c = e - r * width;
    const int t0 = r / kNch, ch = r - t0 * kNch;
    const long long at =
        (((static_cast<long long>(i0) * kNT + t0) * G1 + row) * kNch + ch) * G2 + c0 + c;
    out[at] = slab[r * band + c];
  }
}

template <int kNch, bool kTent>
int launch(const taps::Prepped& in, const int* counts, float* out, int R0, int R1,
           int G1, int G2, int band, float dx, int apic, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kNT * kNch * static_cast<size_t>(band);
  cudaError_t err = cudaFuncSetAttribute(
      p2g3d_kernel<kNch, kTent>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(static_cast<unsigned>(R0) * G1, (G2 + band - 1) / band);
  p2g3d_kernel<kNch, kTent><<<blocks, kThreads, smem, stream>>>(
      in, counts, out, R1, G1, G2, band, dx, apic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes / strides: 29 entries in the order of taps.cuh (null where the
// mode has no such plane).  nch: 7 or 11; apic, tent: 0/1.  Returns a
// cudaError_t as int (0 on success): cudaErrorInvalidValue for another nch,
// else the attribute call's or the launch's error.
extern "C" int mpm_p2g3d(const void* const* planes, const long long* strides,
                         const int* counts, float* out, int R0, int R1, int K,
                         int G1, int G2, int nch, int apic, int tent, float dx,
                         void* stream) {
  (void)K;  // slots are addressed through counts and the pencil strides
  if (nch != 7 && nch != 11) return static_cast<int>(cudaErrorInvalidValue);
  if (R0 <= 0 || G1 <= 0 || G2 <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Widest equal z bands whose slab fits the opt-in shared memory.
  const long long per_col = static_cast<long long>(sizeof(float)) * kNT * nch;
  const int max_cols = static_cast<int>(optin / per_col);
  if (max_cols < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_bands = (G2 + max_cols - 1) / max_cols;
  const int band = (G2 + n_bands - 1) / n_bands;
  const taps::Prepped in = taps::prepped_from(planes, strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nch == 7) {
    return tent ? launch<7, true>(in, counts, out, R0, R1, G1, G2, band, dx, apic, s)
                : launch<7, false>(in, counts, out, R0, R1, G1, G2, band, dx, apic, s);
  }
  return tent ? launch<11, true>(in, counts, out, R0, R1, G1, G2, band, dx, apic, s)
              : launch<11, false>(in, counts, out, R0, R1, G1, G2, band, dx, apic, s);
}
