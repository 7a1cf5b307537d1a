// K6: the level operators' Kronecker pair (K x, M x) in bfloat16 and float32
// storage, for Hopper (sm_90a), in one fused pass over all three axes.
//
// Replaces: the dense per-axis matmul chain of the low-precision branch of
// ops/kronfac.py::KronAssembled.pair (stfem_tpu/ops/kronfac.py leaves the
// float32 / bf16 pair to XLA's dense tensordots): eight contractions with
// dense (n, n) factors whose band is 2k + 1 wide, each behind a strided
// copy of the whole vector.
//
// What it computes: for a batch of 3D dof grids x[B, n0, n1, n2]
//     M x = (M_0 (x) M_1 (x) M_2) x
//     K x = (A_0 (x) M_1 (x) M_2 + M_0 (x) A_1 (x) M_2 + M_0 (x) M_1 (x) A_2) x
// with banded 1D factors stored as float32 diagonals D[o, i] = A1d[i, i+o-k]
// (o = 0..2k, zero off-range; ops/kronfac.py::to_diags), whose values the
// caller has rounded to the level's dtype.  Every tap is an FP32 FMA, the
// partial sums stay in float32, and K x and M x are rounded once to x's
// dtype when they are written, contiguous, in x's layout.
//
// What bounds it on the H100: FP32 on the CUDA cores, then device memory.
// At the finest heat level of the 32^3 march (B = 96, n = 129, k = 4, bf16)
// x is 412 MB: reading it once and writing K x and M x once is 1.24 GB,
// 0.37 ms at 3.35 TB/s; the pair needs 72 FMAs per element (16 (2k+1)
// operations), 0.44 ms at 67 TFLOP/s.
//
// What the design does about it: K2's shape (csrc/kron_pair.cu) in float32
// arithmetic over 2- or 4-byte storage.  A CTA owns one block b and a tile
// of T1 rows of axis 1 by all of axis 2, one output position per thread,
// and walks the planes of axis 0 two at a time; each plane's tile with a
// k-row halo arrives by cp.async into a ring of 6 stages, four planes ahead
// of the two in use.  Axis 1 is applied from the staged tile (the taps of a
// row are broadcast from shared memory), axis 2 from float32 planes in
// shared memory with the position's taps in registers, axis 0 in registers
// (the 2(2k+2) partial sums of the output planes in reach).  The level
// sizes are odd (n = 3 .. 129), so a bf16 plane tile, (T1 + 2k) n2
// elements contiguous in memory, may start in the middle of a 4-byte word:
// it is staged whole 4-byte words at a time, at an offset of the same
// parity in its stage (TMA and 16-byte cp.async need 16-byte aligned rows,
// which odd n never gives).  The element that an end word brings along
// from outside the tile lands in a zero row of the halo; the thread that
// copied that word zeroes it again once the copy has landed.  What limits
// it is, as in K2, the shared-memory traffic of the taps of axes 1 and 2
// and the barriers of the sliding window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPlanes = 2;     // planes per step (one pair of barriers)
constexpr int kAhead = 4;      // planes in flight ahead of a step's
constexpr int kStages = kPlanes + kAhead;      // the staging ring

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest kAhead - kPlanes groups (one plane each) have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - kPlanes));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// elements of one stage: a leading slot, the (T1 + 2k) n2 staged elements
// at an offset of 0 or 1, and a trailing slot; even, so that every stage
// starts on a 4-byte word
__host__ __device__ inline int stage_elems(int srows, int n2) {
  return (srows * n2 + 4) & ~1;
}

template <int K, typename S>
__global__ void __launch_bounds__(kMaxThreads, 2)
level_pair_kernel(const S* __restrict__ x, const float* __restrict__ dm,
                  const float* __restrict__ da, S* __restrict__ kx,
                  S* __restrict__ mx, int n0, int n1, int n2, int nmax,
                  int tile1, int n_tiles1) {
  constexpr int T = 2 * K + 1;
  constexpr int E = 4 / sizeof(S);               // elements a 4-byte word
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int i1a = (blockIdx.x % n_tiles1) * tile1;
  const long long b = blockIdx.x / n_tiles1;
  const int rows = min(tile1, n1 - i1a);
  const int srows = tile1 + 2 * K, w2 = n2 + 2 * K;
  const int sstride = stage_elems(srows, n2);
  // axis 0's taps, zero-padded by K output planes either side
  float2* ma0 = reinterpret_cast<float2*>(smem);         // [T][n0 + 2K]
  float2* ma1 = ma0 + T * (n0 + 2 * K);                  // [T][tile1]
  float* ps = reinterpret_cast<float*>(ma1 + T * tile1);  // [kPlanes][tile1][w2]
  float* qs = ps + kPlanes * tile1 * w2;                  // k-padded on axis 2
  S* xs = reinterpret_cast<S*>(qs + kPlanes * tile1 * w2);  // [kStages][sstride]
  const long long dstride = (long long)T * nmax;

  // the staged rows i1a - k .. i1a + rows + k - 1 that lie in the grid:
  // staged rows s_lo .. s_hi - 1, n_in elements from xb + j0 * plane on
  const int r_lo = max(i1a - K, 0), r_hi = min(i1a + rows + K, n1);
  const int s_lo = r_lo - (i1a - K), s_hi = s_lo + (r_hi - r_lo);
  const int n_in = (r_hi - r_lo) * n2;
  const long long plane = (long long)n1 * n2;
  const S* xb = x + b * n0 * plane + (long long)r_lo * n2;
  // elements of plane j0's tile before its first 4-byte word boundary
  auto lead = [&](int j0) -> int {
    return E == 1 ? 0
                  : (int)((reinterpret_cast<uintptr_t>(xb + j0 * plane) >>
                           1) & 1);
  };
  auto words = [&](int j0) { return (lead(j0) + n_in + E - 1) / E; };
  // staged row 0 of plane j0: its first element in the grid, s_lo n2 on,
  // sits at the parity of its address in device memory
  auto rows0 = [&](int j0) -> S* {
    const int sh = E == 1 ? 0 : (1 + s_lo * n2 + lead(j0)) & 1;
    return xs + (j0 % kStages) * sstride + 1 + sh;
  };
  auto issue = [&](int j0) {
    if (j0 < n0) {
      const int ld = lead(j0), nw = words(j0);
      const unsigned* src =
          reinterpret_cast<const unsigned*>(xb + j0 * plane - ld);
      unsigned* dst = reinterpret_cast<unsigned*>(rows0(j0) + s_lo * n2 - ld);
      for (int w = tid; w < nw; w += blockDim.x) cp_async4(dst + w, src + w);
    }
    cp_async_commit();         // an empty group past the last plane
  };
  // the zero rows next to plane j0's tile, where an end word (or the tile
  // of a plane staged at the other parity before) left an element: zeroed
  // by the thread that copied that word, after its copies have landed
  auto mend = [&](int j0) {
    if (j0 >= n0) return;
    S* r0 = rows0(j0);
    if (s_lo > 0 && tid == 0) put(r0 + s_lo * n2 - 1, 0.f);
    if (s_hi < srows && tid == (words(j0) - 1) % (int)blockDim.x)
      put(r0 + s_hi * n2, 0.f);
  };

  // zeros: every stage (the rows outside the grid stay zero) and the
  // padding of p, q; then the tables
  for (int e = tid; e < kStages * sstride; e += blockDim.x) put(xs + e, 0.f);
  for (int e = tid; e < kPlanes * tile1 * w2; e += blockDim.x)
    ps[e] = qs[e] = 0.f;
  for (int e = tid; e < T * (n0 + 2 * K); e += blockDim.x) {
    const int o = e / (n0 + 2 * K), i = e - o * (n0 + 2 * K) - K;
    ma0[e] = i >= 0 && i < n0
                 ? make_float2(dm[o * nmax + i], da[o * nmax + i])
                 : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < T * tile1; e += blockDim.x) {
    const int o = e / tile1, i = min(i1a + e - o * tile1, n1 - 1);
    ma1[e] = make_float2(dm[dstride + o * nmax + i],
                         da[dstride + o * nmax + i]);
  }
  __syncthreads();             // the stages are zero before any copy lands
  for (int j0 = 0; j0 < kAhead; ++j0) issue(j0);

  // this thread's position and its axis-2 taps, in registers
  const bool active = tid < rows * n2;
  const int r = tid / n2, i2 = tid - r * n2;
  float m2[T], a2[T];
#pragma unroll
  for (int o = 0; o < T; ++o) {
    m2[o] = dm[2 * dstride + o * nmax + i2];
    a2[o] = da[2 * dstride + o * nmax + i2];
  }
  // output planes j0 - K .. j0 + K + kPlanes - 1
  float accM[T + kPlanes - 1], accK[T + kPlanes - 1];
#pragma unroll
  for (int s = 0; s < T + kPlanes - 1; ++s) accM[s] = accK[s] = 0.f;
  const long long out0 = b * n0 * plane + (long long)(i1a + r) * n2 + i2;

  for (int j0 = 0; j0 < n0 + K; j0 += kPlanes) {
    if (j0 < n0) {
      cp_async_wait();         // planes j0.. have landed (this thread's)
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl) mend(j0 + pl);
      __syncthreads();         // ... and every thread's; p, q are free, and
#pragma unroll                 // so are the stages of the previous step
      for (int pl = 0; pl < kPlanes; ++pl) issue(j0 + kAhead + pl);
      if (active) {
        // each tap of the row read once for the step's planes
        const S* xp[kPlanes];
        float p[kPlanes], q[kPlanes];
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          xp[pl] = rows0(j0 + pl) + r * n2 + i2;
          p[pl] = q[pl] = 0.f;
        }
#pragma unroll
        for (int o = 0; o < T; ++o) {
          const float2 c = ma1[o * tile1 + r];                   // (m, a)
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl) {
            const float xv = to_f(xp[pl][o * n2]);
            p[pl] = fmaf(c.x, xv, p[pl]);
            q[pl] = fmaf(c.y, xv, q[pl]);
          }
        }
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          ps[(pl * tile1 + r) * w2 + K + i2] = p[pl];
          qs[(pl * tile1 + r) * w2 + K + i2] = q[pl];
        }
      }
      __syncthreads();         // p, q complete
      if (active) {
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          const float* pr = ps + (pl * tile1 + r) * w2 + i2;
          const float* qr = qs + (pl * tile1 + r) * w2 + i2;
          float uu[2] = {0.f, 0.f}, va = 0.f, vb = 0.f;
#pragma unroll
          for (int o = 0; o < T; ++o) {
            const float pv = pr[o], qv = qr[o];
            uu[o & 1] = fmaf(m2[o], pv, uu[o & 1]);
            va = fmaf(a2[o], pv, va);
            vb = fmaf(m2[o], qv, vb);
          }
          // a plane past the grid's last reaches nothing
          const bool in = j0 + pl < n0;
          const float u = in ? uu[0] + uu[1] : 0.f, v = in ? va + vb : 0.f;
          // plane j0 + pl reaches output planes i0 = j0 + pl - K + s
          // through tap o = 2K - s of axis 0 (zero taps for i0 outside)
          const float2* c0 = ma0 + 2 * K * (n0 + 2 * K) + j0 + pl;
#pragma unroll
          for (int s = 0; s < T; ++s) {
            const float2 c = c0[s * (1 - (n0 + 2 * K))];         // (m, a)
            accM[pl + s] = fmaf(c.x, u, accM[pl + s]);
            accK[pl + s] = fmaf(c.y, u, fmaf(c.x, v, accK[pl + s]));
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
        put(mx + e, accM[pl]);
        put(kx + e, accK[pl]);
      }
    }
#pragma unroll
    for (int s = 0; s < T + kPlanes - 1; ++s) {
      accM[s] = s + kPlanes < T + kPlanes - 1 ? accM[s + kPlanes] : 0.f;
      accK[s] = s + kPlanes < T + kPlanes - 1 ? accK[s + kPlanes] : 0.f;
    }
  }
}

template <int K, typename S>
int launch(const void* x, const void* dm, const void* da, void* kx,
           void* mx, long long B, int n0, int n1, int n2, int nmax,
           int tile1, int threads, cudaStream_t st) {
  const int n_tiles1 = (n1 + tile1 - 1) / tile1;
  const size_t smem =
      sizeof(float) * 2 * (2 * K + 1) * (size_t)(n0 + 2 * K + tile1) +
      sizeof(float) * 2 * kPlanes * (size_t)tile1 * (n2 + 2 * K) +
      sizeof(S) * kStages * (size_t)stage_elems(tile1 + 2 * K, n2);
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      tile1 <= 0 || (long long)tile1 * n2 > threads || smem > 232448 ||
      B * n_tiles1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      level_pair_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  level_pair_kernel<K, S><<<(unsigned int)(B * n_tiles1), threads, smem, st>>>(
      static_cast<const S*>(x), static_cast<const float*>(dm),
      static_cast<const float*>(da), static_cast<S*>(kx), static_cast<S*>(mx),
      n0, n1, n2, nmax, tile1, n_tiles1);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, kx and mx).  x: [B, n0, n1, n2],
// contiguous.  dm, da: [3, 2k+1, nmax] float32 (axis d's diagonals in the
// first n_d columns).  kx, mx: outputs of x's size and dtype (K x, M x).
// tile1 rows of axis 1 per CTA, threads per CTA (a multiple of 32, <= 512,
// at least tile1 * n2).  k <= 4.  Returns the CUDA error code (0 = success;
// cudaErrorInvalidValue for a shape or plan the kernel does not take).
extern "C" int stfem_level_pair(int dtype, const void* x, const void* dm,
                                const void* da, void* kx, void* mx,
                                long long B, int n0, int n1, int n2,
                                int nmax, int k, int tile1, int threads,
                                void* stream) {
  if (B <= 0 || n0 <= 0 || n1 <= 0 || n2 <= 0 || (dtype != 0 && dtype != 1) ||
      nmax < (n0 > n1 ? (n0 > n2 ? n0 : n2) : (n1 > n2 ? n1 : n2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k * 2 + dtype) {
#define STFEM_LEVEL(KK)                                                      \
  case 2 * KK:                                                               \
    return launch<KK, float>(x, dm, da, kx, mx, B, n0, n1, n2, nmax, tile1,  \
                             threads, st);                                   \
  case 2 * KK + 1:                                                           \
    return launch<KK, __nv_bfloat16>(x, dm, da, kx, mx, B, n0, n1, n2, nmax, \
                                     tile1, threads, st);
    STFEM_LEVEL(0)
    STFEM_LEVEL(1)
    STFEM_LEVEL(2)
    STFEM_LEVEL(3)
    STFEM_LEVEL(4)
#undef STFEM_LEVEL
    default:
      return (int)cudaErrorInvalidValue;
  }
}
