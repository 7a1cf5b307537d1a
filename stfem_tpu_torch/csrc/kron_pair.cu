// K2: Kronecker pair (K x, M x) of the IR residual, native FP64, for Hopper
// (sm_90a).
//
// Replaces: stfem_tpu/ops/pallas_ffresid.py::kron_pair_ff_pallas (the Pallas
// TPU kernel `_kernel`, line 71; call at line 131), which computes the same
// pair in float-float (two f32 words) because the TPU has no FP64.  Hopper
// has native FP64, so this kernel computes the pair in double, which is
// more accurate than float-float.
//
// What it computes: for a batch of 3D dof grids x[B, n0, n1, n2]
//     M x = (M_0 (x) M_1 (x) M_2) x
//     K x = (A_0 (x) M_1 (x) M_2 + M_0 (x) A_1 (x) M_2 + M_0 (x) M_1 (x) A_2) x
// with banded 1D factors stored as diagonals D[o, i] = A1d[i, i+o-k]
// (o = 0..2k, zero off-range; stfem_tpu/ops/kronfac.py::_to_diags).  The
// shared-prefix chain of stfem_tpu's KronAssembled.pair is kept: one pass per
// axis d maps (val, ks) to
//     val' = M_d val,   ks' = M_d ks + A_d val     (d = 0: ks' = A_0 val).
//
// What bounds it on the H100: device memory.  At the bench shape (B = 128,
// n = 65, k = 4) one block is 2.2 MB and the batch 281 MB per array; each
// pass reads two arrays and writes two (the first reads one), about 3 x 32 B
// per element per pair, against at most 3 (2k+1) FP64 FMAs (54 flops) per
// element per pass -- well under the FP64 roof.
//
// What the design does about it: three launches, one per axis; a block does
// not fit an SM's 227 KB of shared memory, so no pass tries to hold one and
// the 50 MB L2 serves the (2k+1)-tap stencil's reuse.  One thread per output
// element, with consecutive threads on the contiguous last axis: for every
// tap, a warp reads a contiguous run of doubles on all three axes (for axes
// 0 and 1 the tap offset is a whole row or plane, so the access stays
// coalesced).  Taps that leave the grid meet a zero coefficient and are
// skipped, which also keeps every read inside the array.

#include <cuda_runtime.h>

namespace {

template <bool FIRST>
__global__ void kron_axis_kernel(const double* __restrict__ val,
                                 const double* __restrict__ ks,
                                 const double* __restrict__ dm,
                                 const double* __restrict__ da,
                                 double* __restrict__ val_out,
                                 double* __restrict__ ks_out, long long total,
                                 int n_axis, long long stride, int nmax,
                                 int k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int i = (int)((e / stride) % n_axis);
  double mv = 0.0, av = 0.0, mk = 0.0;
  for (int o = 0; o <= 2 * k; ++o) {
    const int j = i + o - k;
    if (j < 0 || j >= n_axis) continue;
    const long long src = e + (long long)(o - k) * stride;
    const double cm = dm[o * nmax + i];
    const double xv = val[src];
    mv += cm * xv;
    av += da[o * nmax + i] * xv;
    if (!FIRST) mk += cm * ks[src];
  }
  val_out[e] = mv;
  ks_out[e] = FIRST ? av : mk + av;
}

}  // namespace

// x: [B, n0, n1, n2] f64.  dm, da: [3, 2k+1, nmax] f64 (axis d's diagonals
// in the first n_d columns).  v1, k1, v2, k2: scratch/outputs of x's size.
// On return k1 = K x and v1 = M x.  Returns the first CUDA error code of the
// three launches (0 = success).
extern "C" int stfem_kron_pair(const void* x, const void* dm, const void* da,
                               void* v1, void* k1, void* v2, void* k2,
                               long long B, int n0, int n1, int n2, int nmax,
                               int k, void* stream) {
  if (B <= 0 || k < 0 || n0 <= 0 || n1 <= 0 || n2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = B * (long long)n0 * n1 * n2;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  const int ns[3] = {n0, n1, n2};
  const long long strides[3] = {(long long)n1 * n2, (long long)n2, 1};
  const double* dm_ = static_cast<const double*>(dm);
  const double* da_ = static_cast<const double*>(da);
  const long long dstride = (long long)(2 * k + 1) * nmax;
  const double* vin[3] = {static_cast<const double*>(x),
                          static_cast<const double*>(v1),
                          static_cast<const double*>(v2)};
  const double* kin[3] = {nullptr, static_cast<const double*>(k1),
                          static_cast<const double*>(k2)};
  double* vout[3] = {static_cast<double*>(v1), static_cast<double*>(v2),
                     static_cast<double*>(v1)};
  double* kout[3] = {static_cast<double*>(k1), static_cast<double*>(k2),
                     static_cast<double*>(k1)};
  for (int d = 0; d < 3; ++d) {
    if (d == 0) {
      kron_axis_kernel<true><<<blocks, threads, 0, st>>>(
          vin[d], kin[d], dm_ + d * dstride, da_ + d * dstride, vout[d],
          kout[d], total, ns[d], strides[d], nmax, k);
    } else {
      kron_axis_kernel<false><<<blocks, threads, 0, st>>>(
          vin[d], kin[d], dm_ + d * dstride, da_ + d * dstride, vout[d],
          kout[d], total, ns[d], strides[d], nmax, k);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
