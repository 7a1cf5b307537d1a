// K1: Vanka multi-step time solve, hand-written for Hopper (sm_90a).
//
// Replaces: stfem_tpu/ops/pallas_timesolve.py::time_solve_pallas (the Pallas
// TPU kernel `_kernel`, line 68; call at line 97).
//
// What it computes: for every flattened eigen-position n (independently) the
// block-bidiagonal multi-step solve of the grid-mode Vanka smoother
//     y_s    = Ginv(n) w_s                      (nt x nt, per step s)
//     out_s  = y_s + last_{s-1} * cvec(n)
//     last_s = y_s[nt-1] + kappa(n) * last_{s-1},   kappa = cvec[nt-1]
// with w, out: (S*nt, N) in the level dtype (bf16 or f32), GinvT:
// (nt, nt, N) f32 and cvecT: (nt, N) f32.  Arithmetic is f32 throughout.
//
// What bounds it on the H100: device memory.  Per position it reads S*nt
// inputs + nt*nt + nt factors and writes S*nt outputs, with ~2*nt flops per
// value: at the bench shape (S=32, nt=3, N=512,000, bf16) about 98 MB in,
// 6 MB of factors and 98 MB out -- far below the flop roof.
//
// What the design does about it: one thread per position n.  The 12 f32
// factors live in registers and the S-step recurrence runs in registers, so
// every input is read once and every output written once.  Neighbouring
// threads own neighbouring n, and every array is (row, N) with N innermost,
// so each warp load/store of one row is a contiguous, coalesced 64/128-byte
// segment.  The ragged end of N is a bounds check.  The TPU kernel's lane
// tiling ((rows, 128) blocks, its VMEM tile picker) has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int NT>
__global__ void time_solve_kernel(const T* __restrict__ w,
                                  const float* __restrict__ ginv,
                                  const float* __restrict__ cvec,
                                  T* __restrict__ out, int S, long long N) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float g[NT][NT];
  float c[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    c[i] = cvec[i * N + n];
#pragma unroll
    for (int j = 0; j < NT; ++j) g[i][j] = ginv[(i * NT + j) * N + n];
  }
  const float kap = c[NT - 1];
  float prev = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long row = (long long)s * NT;
    float ws[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) ws[j] = load_f(w + (row + j) * N + n);
    float ylast = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) y += g[i][j] * ws[j];
      store_f(out + (row + i) * N + n, y + prev * c[i]);
      if (i == NT - 1) ylast = y;
    }
    prev = ylast + kap * prev;
  }
}

template <typename T>
int launch(const void* w, const void* ginv, const void* cvec, void* out,
           int S, int nt, long long N, cudaStream_t stream) {
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  const T* w_ = static_cast<const T*>(w);
  const float* g_ = static_cast<const float*>(ginv);
  const float* c_ = static_cast<const float*>(cvec);
  T* o_ = static_cast<T*>(out);
  switch (nt) {
    case 1:
      time_solve_kernel<T, 1><<<blocks, threads, 0, stream>>>(w_, g_, c_, o_,
                                                              S, N);
      break;
    case 2:
      time_solve_kernel<T, 2><<<blocks, threads, 0, stream>>>(w_, g_, c_, o_,
                                                              S, N);
      break;
    case 3:
      time_solve_kernel<T, 3><<<blocks, threads, 0, stream>>>(w_, g_, c_, o_,
                                                              S, N);
      break;
    case 4:
      time_solve_kernel<T, 4><<<blocks, threads, 0, stream>>>(w_, g_, c_, o_,
                                                              S, N);
      break;
    case 5:
      time_solve_kernel<T, 5><<<blocks, threads, 0, stream>>>(w_, g_, c_, o_,
                                                              S, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w and out share it); nt = 1..5 (dG(0)
// to dG(4), CGP(1) to CGP(5)).  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int stfem_time_solve(const void* w, const void* ginv,
                                const void* cvec, void* out, int S, int nt,
                                long long N, int dtype, void* stream) {
  if (N <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, ginv, cvec, out, S, nt, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, ginv, cvec, out, S, nt, N, st);
  return (int)cudaErrorInvalidValue;
}
