// K3: one banded (2k+1)-offset apply along one axis of a batched grid,
// native FP64, for Hopper (sm_90a).
//
// Replaces: stfem_tpu/ops/pallas_ffband.py::banded_ff_lane_apply (the Pallas
// TPU kernel `_kernel`, line 76; call at line 101), which applies the band
// in float-float (two f32 words) along the LAST (lane) axis only, with XLA
// transposes bringing the other axes to the lanes.  Hopper has native FP64,
// so this kernel computes in double, and it applies along any axis in place
// (the axis is a stride), so no permuted copy is made.
//
// What it computes: x viewed as [outer, n, inner] (n the applied axis,
// inner the product of the axes after it):
//     y[o, i, j] = sum_{t=0..2k} D[t, i] x[o, i+t-k, j]
// with the banded factor stored as diagonals D[t, i] = A1d[i, i+t-k]
// (stfem_tpu/ops/kronfac.py::_to_diags); taps that leave the axis are
// skipped.
//
// What bounds it on the H100: device memory.  Each element is read once
// from DRAM (the 2k+1 taps re-read neighbours through L1/L2) and written
// once: 16 B per element against 2(2k+1) FP64 flops -- far under the FP64
// roof.  At B = 128 x 65^3, k = 4 that is 562 MB, 0.168 ms at 3.35 TB/s.
//
// What the design does about it: one thread per output element, with
// consecutive threads on consecutive addresses; for every tap a warp reads
// a contiguous run of doubles whatever the axis (for an outer axis the tap
// offset is a whole row or plane), so every access is coalesced and the
// neighbours' reuse is served by the caches.  A simple kernel first: no
// shared-memory tiling.

#include <cuda_runtime.h>

namespace {

__global__ void banded_apply_kernel(const double* __restrict__ x,
                                    const double* __restrict__ diags,
                                    double* __restrict__ y, long long total,
                                    int n, long long inner, int k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int i = (int)((e / inner) % n);
  double acc = 0.0;
  for (int t = 0; t <= 2 * k; ++t) {
    const int j = i + t - k;
    if (j < 0 || j >= n) continue;
    acc += diags[t * n + i] * x[e + (long long)(t - k) * inner];
  }
  y[e] = acc;
}

}  // namespace

// x, y: [outer, n, inner] f64 (contiguous, distinct); diags: [2k+1, n] f64.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int stfem_banded_apply(const void* x, const void* diags, void* y,
                                  long long outer, int n, long long inner,
                                  int k, void* stream) {
  if (outer <= 0 || n <= 0 || inner <= 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = outer * (long long)n * inner;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  banded_apply_kernel<<<(unsigned int)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(diags),
      static_cast<double*>(y), total, n, inner, k);
  return (int)cudaGetLastError();
}
