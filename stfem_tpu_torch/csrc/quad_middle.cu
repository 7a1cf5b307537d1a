// K5: the full-cell-basis quadrature middle of the slab operator,
// hand-written for Hopper (sm_90a), in double and float.
//
// Replaces: stfem_tpu/ops/pallas_kernels.py::fused_quad_middle (the Pallas
// TPU kernel `_middle_kernel`, line 67; pallas_call at line 126).
//
// What it computes: for every destination block t and cell c, with the
// block mixing already applied (ub = Beta u, ua = Alpha u, both (T, C, A)),
//     qv[q]      = sum_a ub[t,c,a] PhiG[a, q]            q <  Q
//     qg[q]      = sum_a ua[t,c,a] PhiG[a, q]            Q <= q < NQ
//     y[t,c,a]   = sum_q (qv|qg)[q] W[c,q] PhiG[a,q]     over all NQ columns
// where PhiG (A, NQ = (1+dim) Q) holds the basis values and the reference
// gradients at the Q quadrature points of a cell and W (C, NQ) the
// quadrature weights with jxw, the coefficient and the inverse-Jacobian
// squares folded in.
//
// What bounds it on the H100: the operations.  At the main shape (T=24,
// C=4096, A=64, NQ=256, FP64) it reads 101 MB of ub/ua and 8.4 MB of W and
// writes 50 MB (~0.05 ms at 3.35 TB/s) but does 6.44 GFLOP (~0.19 ms at
// the 34 TFLOP/s FP64 rate outside the tensor cores).
//
// What the design does about it: one block of 256 threads per (cell, chunk
// of TT blocks).  The chunk's ub/ua rows are staged in shared memory; in
// phase 1 each thread owns one quadrature column j, reads PhiG[:, j] once
// (coalesced over j; PhiG stays in L1/L2, it is 128 KB) and accumulates
// all TT blocks of that column in registers, so every PhiG load feeds TT
// FMAs.  The weighted quadrature values stay in shared memory (never in
// device memory).  In phase 2 each thread owns one output dof a and four
// blocks, and walks the columns through the transposed PhiGT (coalesced
// over a), reusing each load for four FMAs.  The TPU kernel's cell-chunk
// BlockSpecs and its whole-PhiG VMEM residency have no counterpart here.
// FP64 tensor cores (DMMA), TMA staging and a tuned tile are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;        // blocks per phase-2 thread

template <typename T, int TT>
__global__ void __launch_bounds__(THREADS)
quad_middle_kernel(const T* __restrict__ ub, const T* __restrict__ ua,
                   const T* __restrict__ phig, const T* __restrict__ phigT,
                   const T* __restrict__ w, T* __restrict__ out, int Tn,
                   int C, int A, int Q, int NQ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* us = reinterpret_cast<T*>(smem_raw);       // [2][A][TT]: ub, ua rows
  T* qs = us + 2 * A * TT;                      // [NQ][TT]: weighted values
  const long long c = blockIdx.x;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, Tn - t0);

  // stage the chunk's ub / ua rows; blocks past the end are zero
  for (int i = threadIdx.x; i < 2 * TT * A; i += THREADS) {
    const int which = i / (TT * A);
    const int r = i - which * TT * A;
    const int t = r / A, a = r - (r / A) * A;
    const T* src = which ? ua : ub;
    us[(which * A + a) * TT + t] =
        t < nt ? src[((long long)(t0 + t) * C + c) * A + a] : T(0);
  }
  __syncthreads();

  // phase 1: column j of every block's quadrature values, weighted
  const T* wc = w + c * NQ;
  for (int j = threadIdx.x; j < NQ; j += THREADS) {
    const T* u = us + (j < Q ? 0 : A * TT);
    T acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = T(0);
    for (int a = 0; a < A; ++a) {
      const T p = phig[(long long)a * NQ + j];
      const T* ua_ = u + a * TT;
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] += ua_[t] * p;
    }
    const T wj = wc[j];
#pragma unroll
    for (int t = 0; t < TT; ++t) qs[j * TT + t] = acc[t] * wj;
  }
  __syncthreads();

  // phase 2: y[t, a] = sum_j qs[j, t] PhiG[a, j], four blocks per thread
  const int groups = (nt + GROUP - 1) / GROUP;
  for (int item = threadIdx.x; item < A * groups; item += THREADS) {
    const int a = item % A, g = item / A;
    T acc[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) acc[i] = T(0);
    const T* qg = qs + g * GROUP;
    for (int j = 0; j < NQ; ++j) {
      const T p = phigT[(long long)j * A + a];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) acc[i] += qg[j * TT + i] * p;
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int t = g * GROUP + i;
      if (t < nt) out[((long long)(t0 + t) * C + c) * A + a] = acc[i];
    }
  }
}

template <typename T, int TT>
int launch_tt(const void* ub, const void* ua, const void* phig,
              const void* phigT, const void* w, void* out, int Tn, int C,
              int A, int Q, int NQ, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * A + NQ) * TT * sizeof(T);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = quad_middle_kernel<T, TT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned int)C, (unsigned int)((Tn + TT - 1) / TT));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(ub), static_cast<const T*>(ua),
      static_cast<const T*>(phig), static_cast<const T*>(phigT),
      static_cast<const T*>(w), static_cast<T*>(out), Tn, C, A, Q, NQ);
  return (int)cudaGetLastError();
}

// The chunk of blocks per thread block: the fewest chunks of at most 16,
// each rounded up to a multiple of GROUP (T=24 -> 2 x 12, T=3 -> 1 x 4).
template <typename T>
int launch(const void* ub, const void* ua, const void* phig,
           const void* phigT, const void* w, void* out, int Tn, int C,
           int A, int Q, int NQ, cudaStream_t st) {
  const int chunks = (Tn + 15) / 16;
  const int tt = ((Tn + chunks - 1) / chunks + GROUP - 1) / GROUP * GROUP;
  switch (tt) {
    case 4:
      return launch_tt<T, 4>(ub, ua, phig, phigT, w, out, Tn, C, A, Q, NQ,
                             st);
    case 8:
      return launch_tt<T, 8>(ub, ua, phig, phigT, w, out, Tn, C, A, Q, NQ,
                             st);
    case 12:
      return launch_tt<T, 12>(ub, ua, phig, phigT, w, out, Tn, C, A, Q, NQ,
                              st);
    case 16:
      return launch_tt<T, 16>(ub, ua, phig, phigT, w, out, Tn, C, A, Q, NQ,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64 (all arrays share it).  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int stfem_quad_middle(const void* ub, const void* ua,
                                 const void* phig, const void* phigT,
                                 const void* w, void* out, int Tn, int C,
                                 int A, int Q, int NQ, int dtype,
                                 void* stream) {
  if (Tn <= 0 || C <= 0 || A <= 0 || Q <= 0 || NQ < Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ub, ua, phig, phigT, w, out, Tn, C, A, Q, NQ, st);
  if (dtype == 1)
    return launch<double>(ub, ua, phig, phigT, w, out, Tn, C, A, Q, NQ, st);
  return (int)cudaErrorInvalidValue;
}
