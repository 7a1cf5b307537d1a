// K2: Kronecker pair (K x, M x) of the IR residual, native FP64, for Hopper
// (sm_90a), in one fused pass over all three axes.
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
// (o = 0..2k, zero off-range; stfem_tpu/ops/kronfac.py::_to_diags).
//
// What bounds it on the H100: device memory and, close behind, FP64 on the
// CUDA cores.  At the bench shape (B = 128, n = 65, k = 4) each array is
// 281 MB: reading x once and writing K x and M x once is 844 MB, 0.252 ms
// at 3.35 TB/s; the pair needs 72 FP64 FMAs per element, 0.15 ms at the
// 34 TFLOP/s of FP64 outside the tensor cores.
//
// What the design does about it: one pass, a sliding window over axis 0,
// nothing but K x and M x written.  A CTA owns one block b and a tile of
// T1 rows of axis 1 by all of axis 2, one output position per thread, and
// walks the planes j0 = 0 .. n0-1 two at a time.  Each plane's tile with a
// k-row halo on axis 1 arrives by cp.async into a ring of 6 stages, four
// planes ahead of the two in use (with one plane ahead the loads were
// latency-bound); x is read from device memory once, and the halo rows,
// read again by the neighbouring tile, come from L2.  In shared memory it
// applies axis 1 (p = M_1 x, q = A_1 x, on the T1 rows only, so no halo
// work; the taps of a row are broadcast), then axis 2 per position with
// the position's taps in registers:
//     u = M_1 M_2 x,   v = (A_1 M_2 + M_1 A_2) x.
// Axis 0 runs in registers: each thread keeps the output planes that the
// step's planes reach, Mx[i0] += M_0 u and Kx[i0] += A_0 u + M_0 v, and
// writes each plane once it is complete; the 2(2k+2) partial sums shift
// by two planes a step, with k a template parameter so that they stay in
// registers.  Two CTAs share an SM (a few registers spill).  The tile
// plan (rows per tile, threads) comes from the wrapper
// (ops/kron_pair.py::tile_plan).  What limits it at the bench shape is
// the mix of shared-memory traffic (the 2k+1 taps of axes 1 and 2 read
// from shared memory), FP64 FMAs and the barriers of the sliding window,
// not device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 384;
constexpr int kPlanes = 2;     // planes per step (one pair of barriers)
constexpr int kAhead = 4;      // planes in flight ahead of a step's
constexpr int kStages = kPlanes + kAhead;      // the staging ring
// an even ring keeps the double2 tables after it 16-byte aligned
static_assert(kStages % 2 == 0, "kStages must be even");

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest kAhead - kPlanes groups (one plane each) have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - kPlanes));
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads, 2)
kron_pair_kernel(const double* __restrict__ x, const double* __restrict__ dm,
                 const double* __restrict__ da, double* __restrict__ kx,
                 double* __restrict__ mx, int n0, int n1, int n2, int nmax,
                 int tile1, int n_tiles1) {
  constexpr int T = 2 * K + 1;
  extern __shared__ __align__(16) double sm[];
  const int tid = threadIdx.x;
  const int i1a = (blockIdx.x % n_tiles1) * tile1;
  const long long b = blockIdx.x / n_tiles1;
  const int rows = min(tile1, n1 - i1a);
  const int srows = tile1 + 2 * K, w2 = n2 + 2 * K;
  double* xs = sm;                               // [kStages][srows][n2]
  double* ps = xs + kStages * srows * n2;  // [kPlanes][tile1][w2], k-padded
  double* qs = ps + kPlanes * tile1 * w2;
  double2* ma0 =
      reinterpret_cast<double2*>(qs + kPlanes * tile1 * w2);   // [T][n0]
  double2* ma1 = ma0 + T * n0;                                   // [T][tile1]
  const long long dstride = (long long)T * nmax;

  // the staged rows i1a - k .. i1a + rows + k - 1 that lie in the grid
  const int r_lo = max(i1a - K, 0), r_hi = min(i1a + rows + K, n1);
  const int s_lo = r_lo - (i1a - K), n_in = (r_hi - r_lo) * n2;
  const long long plane = (long long)n1 * n2;
  const double* xb = x + b * n0 * plane + (long long)r_lo * n2;
  auto stage = [&](int j0) { return xs + (j0 % kStages) * srows * n2; };
  auto issue = [&](int j0) {
    if (j0 < n0) {
      double* dst = stage(j0) + s_lo * n2;
      const double* src = xb + j0 * plane;
      for (int e = tid; e < n_in; e += blockDim.x)
        cp_async8(dst + e, src + e);
    }
    cp_async_commit();         // an empty group past the last plane
  };
  for (int j0 = 0; j0 < kAhead; ++j0) issue(j0);

  // zeros: the staged rows outside the grid and the padding of p, q
  for (int e = tid; e < srows * n2; e += blockDim.x) {
    const int s = e / n2;
    if (s < s_lo || s >= s_lo + (r_hi - r_lo))
      for (int st = 0; st < kStages; ++st) xs[st * srows * n2 + e] = 0.0;
  }
  for (int e = tid; e < kPlanes * tile1 * w2; e += blockDim.x)
    ps[e] = qs[e] = 0.0;
  for (int e = tid; e < T * n0; e += blockDim.x) {
    const int o = e / n0, i = e - o * n0;
    ma0[e] = make_double2(dm[o * nmax + i], da[o * nmax + i]);
  }

  for (int e = tid; e < T * tile1; e += blockDim.x) {
    const int o = e / tile1, i = min(i1a + e - o * tile1, n1 - 1);
    ma1[e] = make_double2(dm[dstride + o * nmax + i],
                          da[dstride + o * nmax + i]);
  }

  // this thread's position and its axis-2 taps, in registers (the axis-1
  // taps are the same for a warp's lanes of one row: shared memory
  // broadcasts them)
  const bool active = tid < rows * n2;
  const int r = tid / n2, i2 = tid - r * n2;
  double m2[T], a2[T];
#pragma unroll
  for (int o = 0; o < T; ++o) {
    m2[o] = dm[2 * dstride + o * nmax + i2];
    a2[o] = da[2 * dstride + o * nmax + i2];
  }
  // output planes j0 - K .. j0 + K + kPlanes - 1
  double accM[T + kPlanes - 1], accK[T + kPlanes - 1];
#pragma unroll
  for (int s = 0; s < T + kPlanes - 1; ++s) accM[s] = accK[s] = 0.0;
  const long long out0 = b * n0 * plane + (long long)(i1a + r) * n2 + i2;

  for (int j0 = 0; j0 < n0 + K; j0 += kPlanes) {
    if (j0 < n0) {
      cp_async_wait();         // planes j0.. have landed (this thread's)
      __syncthreads();         // ... and every thread's; p, q are free, and
#pragma unroll                 // so are the stages of the previous step
      for (int pl = 0; pl < kPlanes; ++pl) issue(j0 + kAhead + pl);
      if (active) {
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          const double* xp = stage(j0 + pl);
          // two partial sums per quantity: shorter FMA chains
          double p[2] = {0.0, 0.0}, q[2] = {0.0, 0.0};
#pragma unroll
          for (int o = 0; o < T; ++o) {
            const double xv = xp[(r + o) * n2 + i2];
            const double2 c = ma1[o * tile1 + r];                // (m, a)
            p[o & 1] += c.x * xv;
            q[o & 1] += c.y * xv;
          }
          ps[(pl * tile1 + r) * w2 + K + i2] = p[0] + p[1];
          qs[(pl * tile1 + r) * w2 + K + i2] = q[0] + q[1];
        }
      }
      __syncthreads();         // p, q complete
      if (active) {
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          const double* pr = ps + (pl * tile1 + r) * w2 + i2;
          const double* qr = qs + (pl * tile1 + r) * w2 + i2;
          double uu[2] = {0.0, 0.0}, va = 0.0, vb = 0.0;
#pragma unroll
          for (int o = 0; o < T; ++o) {
            const double pv = pr[o], qv = qr[o];
            uu[o & 1] += m2[o] * pv;
            va += a2[o] * pv;
            vb += m2[o] * qv;
          }
          const double u = uu[0] + uu[1], v = va + vb;
          // plane j0 + pl reaches output planes i0 = j0 + pl - K + s
          // through tap o = 2K - s of axis 0
#pragma unroll
          for (int s = 0; s < T; ++s) {
            const int i0 = j0 + pl - K + s;
            if (i0 >= 0 && i0 < n0 && j0 + pl < n0) {
              const double2 c = ma0[(2 * K - s) * n0 + i0];   // (m, a)
              accM[pl + s] += c.x * u;
              accK[pl + s] += c.y * u + c.x * v;
            }
          }
        }
      }
    }
    // output planes j0 - K .. j0 - K + kPlanes - 1 are complete
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl) {
      const int i0 = j0 + pl - K;
      if (active && i0 >= 0 && i0 < n0) {
        const long long e = out0 + (long long)i0 * plane;
        mx[e] = accM[pl];
        kx[e] = accK[pl];
      }
    }
#pragma unroll
    for (int s = 0; s < T + kPlanes - 1; ++s) {
      accM[s] = s + kPlanes < T + kPlanes - 1 ? accM[s + kPlanes] : 0.0;
      accK[s] = s + kPlanes < T + kPlanes - 1 ? accK[s + kPlanes] : 0.0;
    }
  }
}

template <int K>
int launch(const double* x, const double* dm, const double* da, double* kx,
           double* mx, long long B, int n0, int n1, int n2, int nmax,
           int tile1, int threads, cudaStream_t st) {
  const int n_tiles1 = (n1 + tile1 - 1) / tile1;
  const size_t smem =
      sizeof(double) *
      (kStages * (size_t)(tile1 + 2 * K) * n2 +
       2 * (size_t)kPlanes * tile1 * (n2 + 2 * K) +
       2 * (size_t)(2 * K + 1) * (n0 + tile1));
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      tile1 <= 0 || (long long)tile1 * n2 > threads || smem > 232448 ||
      B * n_tiles1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kron_pair_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  kron_pair_kernel<K><<<(unsigned int)(B * n_tiles1), threads, smem, st>>>(
      x, dm, da, kx, mx, n0, n1, n2, nmax, tile1, n_tiles1);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, n0, n1, n2] f64.  dm, da: [3, 2k+1, nmax] f64 (axis d's diagonals
// in the first n_d columns).  kx, mx: outputs of x's size (K x, M x).
// tile1 rows of axis 1 per CTA, threads per CTA (a multiple of 32, <= 384,
// at least tile1 * n2).  k <= 4.  Returns the CUDA error code (0 = success;
// cudaErrorInvalidValue for a shape or plan the kernel does not take).
extern "C" int stfem_kron_pair(const void* x, const void* dm, const void* da,
                               void* kx, void* mx, long long B, int n0,
                               int n1, int n2, int nmax, int k, int tile1,
                               int threads, void* stream) {
  if (B <= 0 || n0 <= 0 || n1 <= 0 || n2 <= 0 ||
      nmax < (n0 > n1 ? (n0 > n2 ? n0 : n2) : (n1 > n2 ? n1 : n2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* x_ = static_cast<const double*>(x);
  const double* dm_ = static_cast<const double*>(dm);
  const double* da_ = static_cast<const double*>(da);
  double* kx_ = static_cast<double*>(kx);
  double* mx_ = static_cast<double*>(mx);
  switch (k) {
#define STFEM_KRON(KK)                                                      \
  case KK:                                                                  \
    return launch<KK>(x_, dm_, da_, kx_, mx_, B, n0, n1, n2, nmax, tile1,   \
                      threads, st);
    STFEM_KRON(0)
    STFEM_KRON(1)
    STFEM_KRON(2)
    STFEM_KRON(3)
    STFEM_KRON(4)
#undef STFEM_KRON
    default:
      return (int)cudaErrorInvalidValue;
  }
}
