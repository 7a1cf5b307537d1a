// K4: the fused per-block grid chain of the grid-mode Vanka down/up, for
// Hopper (sm_90a).
//
// Replaces: stfem_tpu/ops/pallas_grid.py::_chain (the Pallas TPU kernel
// bodies `_down_body`, line 119, and `_up_body`, line 138; pallas_call at
// line 158), reached through chain_down (line 196) and chain_up (line 206).
//
// What it computes: for every space-time block b of x[nb, n0, n1, n2]
//     y[b, i0, i1, i2] = sum_{j0,j1,j2} M0[i0,j0] M1[i1,j1] M2[i2,j2]
//                        x[b, j0, j1, j2]
// with M_d of shape (q_d, n_d): the Vanka down chain (q_d eigen positions
// from n_d dofs) and the up chain (the transposed shapes) are the same
// contraction.  The sums run in f32 (f64 for f64 data) from bf16/f32 data
// and matrices, and y is rounded once to the output dtype, the TPU kernel's
// "widen at entry" rule.  The output keeps the natural axis order
// (i0, i1, i2); the TPU kernel's rotated order was a Mosaic artifact.
//
// What bounds it on the H100: device memory and latency, not flops.  At the
// heat fine level (nb = 96, 65^3 <-> 80^3, bf16) a chain reads and writes
// ~150 MB of data plus an f32 intermediate of ~130-160 MB; the matrices are
// banded (each row meets k+1 or 2(k+1) columns), so the useful work is a
// few GFLOP.
//
// What the design does about it: a block (1.1 MB in f32 at 65^3) does not
// fit an SM's 227 KB of shared memory, so the chain takes two passes and
// never materialises a permuted copy.
//   Pass A, one CTA per (block, j0) plane (CTAs loop over planes): the
//   plane x[b, j0, :, :] is read once, coalesced, into shared memory and
//   contracted along axis 2 and then axis 1 there; the (q1, q2) result is
//   written in f32 to the intermediate t[b, j0, i1, i2].
//   Pass B, one CTA per (block, tile of 128 (i1, i2) positions): the tile's
//   n0 rows of t are staged in shared memory and contracted along axis 0;
//   every write is a contiguous run along i2.
// Both passes keep the matrices in shared memory with, per output row, the
// range of its nonzero columns (found by the CTA when it loads them): the
// loops run over the band only, and dense matrices simply have full rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;       // pass B positions per CTA
constexpr size_t kMaxSmem = 232448;

template <typename A>
__device__ __forceinline__ A to_acc(float v) { return (A)v; }
template <typename A>
__device__ __forceinline__ A to_acc(double v) { return (A)v; }
template <typename A>
__device__ __forceinline__ A to_acc(__nv_bfloat16 v) {
  return (A)__bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows x cols matrix m (row-major, global) -> shared sm (row-major when
// transpose is false, column-major when true) and, per row, the half-open
// range [lo, hi) of its nonzero columns (lo = hi = 0 for a zero row).
template <typename TM, typename A>
__device__ void load_matrix(const TM* __restrict__ m, int rows, int cols,
                            bool transpose, A* sm, int* lo, int* hi) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int i = idx / cols, j = idx % cols;
    sm[transpose ? j * rows + i : idx] = to_acc<A>(m[idx]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    int first = cols, last = -1;
    for (int j = 0; j < cols; ++j) {
      if (sm[transpose ? j * rows + i : i * cols + j] != (A)0) {
        first = min(first, j);
        last = j;
      }
    }
    lo[i] = last < 0 ? 0 : first;
    hi[i] = last + 1;
  }
  __syncthreads();
}

// Pass A: t[p, i1, i2] = sum_{j1,j2} M1[i1,j1] M2[i2,j2] x[p, j1, j2] over
// the planes p = (b, j0).
template <typename TX, typename TM, typename A>
__global__ void chain_plane_kernel(const TX* __restrict__ x,
                                   const TM* __restrict__ m1,
                                   const TM* __restrict__ m2,
                                   A* __restrict__ t, long long n_planes,
                                   int n1, int n2, int q1, int q2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sx = reinterpret_cast<A*>(smem_raw);    // [n1][n2]
  A* sm2 = sx + n1 * n2;                     // [n2][q2] (M2 transposed)
  A* sm1 = sm2 + n2 * q2;                    // [q1][n1]
  A* su = sm1 + q1 * n1;                     // [n1][q2]
  int* lo2 = reinterpret_cast<int*>(su + n1 * q2);
  int* hi2 = lo2 + q2;
  int* lo1 = hi2 + q2;
  int* hi1 = lo1 + q1;
  load_matrix(m2, q2, n2, true, sm2, lo2, hi2);
  load_matrix(m1, q1, n1, false, sm1, lo1, hi1);
  const int plane_in = n1 * n2, plane_mid = n1 * q2, plane_out = q1 * q2;
  for (long long p = blockIdx.x; p < n_planes; p += gridDim.x) {
    const TX* xp = x + p * plane_in;
    for (int idx = threadIdx.x; idx < plane_in; idx += blockDim.x)
      sx[idx] = to_acc<A>(xp[idx]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < plane_mid; idx += blockDim.x) {
      const int j1 = idx / q2, i2 = idx % q2;
      const A* row = sx + j1 * n2;
      A s = 0;
      for (int j2 = lo2[i2]; j2 < hi2[i2]; ++j2)
        s += row[j2] * sm2[j2 * q2 + i2];
      su[idx] = s;
    }
    __syncthreads();
    A* tp = t + p * plane_out;
    for (int idx = threadIdx.x; idx < plane_out; idx += blockDim.x) {
      const int i1 = idx / q2, i2 = idx % q2;
      const A* row = sm1 + i1 * n1;
      A s = 0;
      for (int j1 = lo1[i1]; j1 < hi1[i1]; ++j1)
        s += row[j1] * su[j1 * q2 + i2];
      tp[idx] = s;
    }
    __syncthreads();   // sx and su are rewritten by the next plane
  }
}

// Pass B: y[b, i0, P] = sum_{j0} M0[i0,j0] t[b, j0, P] over tiles of the
// P = q1*q2 positions.
template <typename TM, typename A, typename TO>
__global__ void chain_axis0_kernel(const A* __restrict__ t,
                                   const TM* __restrict__ m0,
                                   TO* __restrict__ y, int n0, int q0,
                                   long long P, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* st = reinterpret_cast<A*>(smem_raw);    // [n0][kTile]
  A* sm0 = st + n0 * kTile;                  // [q0][n0]
  int* lo0 = reinterpret_cast<int*>(sm0 + q0 * n0);
  int* hi0 = lo0 + q0;
  load_matrix(m0, q0, n0, false, sm0, lo0, hi0);
  const long long b = blockIdx.x / n_tiles;
  const long long p0 = (blockIdx.x % n_tiles) * kTile;
  const A* tb = t + b * n0 * P;
  for (int idx = threadIdx.x; idx < n0 * kTile; idx += blockDim.x) {
    const int j0 = idx / kTile, c = idx % kTile;
    st[idx] = p0 + c < P ? tb[j0 * P + p0 + c] : (A)0;
  }
  __syncthreads();
  TO* yb = y + b * q0 * P;
  for (int idx = threadIdx.x; idx < q0 * kTile; idx += blockDim.x) {
    const int i0 = idx / kTile, c = idx % kTile;
    if (p0 + c >= P) continue;
    const A* row = sm0 + i0 * n0;
    A s = 0;
    for (int j0 = lo0[i0]; j0 < hi0[i0]; ++j0)
      s += row[j0] * st[j0 * kTile + c];
    store(yb + i0 * P + p0 + c, s);
  }
}

template <typename A>
size_t plane_smem(int n1, int n2, int q1, int q2) {
  return sizeof(A) * ((size_t)n1 * n2 + (size_t)n2 * q2 + (size_t)q1 * n1 +
                      (size_t)n1 * q2) +
         sizeof(int) * 2 * (size_t)(q1 + q2);
}

template <typename A>
size_t axis0_smem(int n0, int q0) {
  return sizeof(A) * ((size_t)n0 * kTile + (size_t)q0 * n0) +
         sizeof(int) * 2 * (size_t)q0;
}

template <typename TX, typename TM, typename TO, typename A>
int launch(const void* x, const void* m0, const void* m1, const void* m2,
           void* t, void* y, long long nb, int n0, int n1, int n2, int q0,
           int q1, int q2, cudaStream_t st) {
  const size_t sa = plane_smem<A>(n1, n2, q1, q2);
  const size_t sb = axis0_smem<A>(n0, q0);
  if (sa > kMaxSmem || sb > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  auto* ka = chain_plane_kernel<TX, TM, A>;
  err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sa);
  if (err != cudaSuccess) return (int)err;
  const long long n_planes = nb * n0;
  const long long grid_a = n_planes < 8LL * sms ? n_planes : 8LL * sms;
  ka<<<(unsigned int)grid_a, kThreads, sa, st>>>(
      static_cast<const TX*>(x), static_cast<const TM*>(m1),
      static_cast<const TM*>(m2), static_cast<A*>(t), n_planes, n1, n2, q1,
      q2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto* kb = chain_axis0_kernel<TM, A, TO>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (err != cudaSuccess) return (int)err;
  const long long P = (long long)q1 * q2;
  const long long n_tiles = (P + kTile - 1) / kTile;
  kb<<<(unsigned int)(nb * n_tiles), kThreads, sb, st>>>(
      static_cast<const A*>(t), static_cast<const TM*>(m0),
      static_cast<TO*>(y), n0, q0, P, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float64.  x and y are bf16 or
// f32 with bf16 or f32 matrices (f32 sums, f32 intermediate t), or all f64
// (f64 sums and t).  t holds nb * n0 * q1 * q2 sums.  Returns the CUDA
// error code (0 = success; cudaErrorInvalidValue for an unsupported
// combination or a shape whose shared memory exceeds the SM's).
extern "C" int stfem_grid_chain(const void* x, const void* m0, const void* m1,
                                const void* m2, void* t, void* y,
                                long long nb, int n0, int n1, int n2, int q0,
                                int q1, int q2, int x_dtype, int m_dtype,
                                int y_dtype, void* stream) {
  if (nb <= 0 || n0 <= 0 || n1 <= 0 || n2 <= 0 || q0 <= 0 || q1 <= 0 ||
      q2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = x_dtype * 9 + m_dtype * 3 + y_dtype;
#define STFEM_CHAIN(XC, MC, YC, TX, TM, TO, A)                              \
  case XC * 9 + MC * 3 + YC:                                                \
    return launch<TX, TM, TO, A>(x, m0, m1, m2, t, y, nb, n0, n1, n2, q0,   \
                                 q1, q2, st);
  switch (code) {
    STFEM_CHAIN(1, 1, 1, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, float)
    STFEM_CHAIN(1, 1, 0, __nv_bfloat16, __nv_bfloat16, float, float)
    STFEM_CHAIN(1, 0, 1, __nv_bfloat16, float, __nv_bfloat16, float)
    STFEM_CHAIN(1, 0, 0, __nv_bfloat16, float, float, float)
    STFEM_CHAIN(0, 1, 1, float, __nv_bfloat16, __nv_bfloat16, float)
    STFEM_CHAIN(0, 1, 0, float, __nv_bfloat16, float, float)
    STFEM_CHAIN(0, 0, 1, float, float, __nv_bfloat16, float)
    STFEM_CHAIN(0, 0, 0, float, float, float, float)
    STFEM_CHAIN(2, 2, 2, double, double, double, double)
    default:
      break;
  }
#undef STFEM_CHAIN
  return (int)cudaErrorInvalidValue;
}
