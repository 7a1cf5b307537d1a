// K5: the full-cell-basis quadrature middle of the slab operator,
// hand-written for Hopper (sm_90a): FP64 on the tensor cores (DMMA), f32 on
// the CUDA cores.
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
// writes 50 MB (~0.05 ms at 3.35 TB/s) but does 6.44 GFLOP: 0.096 ms at
// the 67 TFLOP/s of the FP64 tensor cores, 0.19 ms on the CUDA cores.
//
// What the FP64 design does about it: the (block t, cell c) pairs are the
// M rows of two chained GEMMs that share one B operand, PhiG, so both run
// on DMMA (mma.sync m16n8k8 f64, a shape sm_90 added: on this kernel it
// ran well ahead of sm_80's m8n8k4 and level with m16n8k16; wgmma has no
// f64).  A thread block owns a tile of 64 rows (tt blocks x cc cells, from
// the wrapper's tile plan) and streams PhiG through shared memory in
// chunks of 32 quadrature columns, as flash attention streams keys:
//     S  = U_tile @ PhiG[:, chunk]        (U = ub below Q, ua above)
//     S *= W[cell(row), chunk]
//     Y += S @ PhiG[:, chunk]^T
// The 64 x A accumulator Y stays in registers and S in shared memory: only
// ub/ua and W are read from device memory and only y is written.  One
// shared copy of each PhiG chunk serves both products (phase 2 reads it
// transposed), double-buffered with cp.async together with the tile's W
// columns, so the next chunk arrives while this one computes; ua replaces
// ub in shared memory, also by cp.async, while the last value chunk's
// phase 2 runs.  The row strides (A+4, 36 doubles) make every fragment
// load conflict-free.  The wrapper pads PhiG's rows to a
// multiple of 16 and its value and gradient column groups to multiples of
// 32 with zeros, and W with it, so no chunk straddles Q.
//
// The f32 variant (on no main path: route "quad" is FP64) stays on the
// CUDA cores; TF32 is not used (the full-precision rule): one block per
// (cell, chunk of blocks), phase 1 one quadrature column per thread with
// the chunk's ub/ua rows in shared memory, phase 2 one dof per thread
// walking the transposed PhiG.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- FP64 --

constexpr int ROWS = 64;         // M rows of a tile: tt blocks x cc cells
constexpr int NC = 32;           // quadrature columns per streamed chunk
constexpr int PS = NC + 4;       // row stride of the PhiG chunk and of S
constexpr int WS = NC + 8;       // row stride of the W chunk
constexpr int WARPS = 8;         // 4 (rows) x 2 (columns)
constexpr int DTHREADS = WARPS * 32;

// D += A B on the FP64 tensor cores, m16n8k8 (sm_90).  Fragments, with
// g = lane / 4 and l = lane % 4: A (16 x 8, row-major) a0 = A[g][l],
// a1 = A[g+8][l], a2 = A[g][l+4], a3 = A[g+8][l+4]; B (8 x 8) b0 = B[l][g],
// b1 = B[l+4][g]; C (16 x 8) c0, c1 = C[g][2l, 2l+1], c2, c3 = C[g+8][..].
__device__ __forceinline__ void dmma(double* c, double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// NTW: phase-2 n-tiles (8 dofs each) per warp; AP = 16 NTW padded dofs.
template <int NTW>
__global__ void __launch_bounds__(DTHREADS, 2)
quad_middle_dmma(const double* __restrict__ ub, const double* __restrict__ ua,
                 const double* __restrict__ phig, const double* __restrict__ w,
                 double* __restrict__ out, int Tn, int C, int A, int qp,
                 int nqp, int tt, int cc) {
  constexpr int AP = 16 * NTW;
  constexpr int US = AP + 4;      // row stride of the staged ub/ua tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* us = reinterpret_cast<double*>(smem_raw);   // [ROWS][US]
  double* ps = us + ROWS * US;                        // [2][AP][PS]
  double* ss = ps + 2 * AP * PS;                      // [ROWS][PS]
  double* ws = ss + ROWS * PS;                        // [2][cc][WS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int lr = lane >> 2, lc = lane & 3;
  const int c0 = blockIdx.x * cc, t0 = blockIdx.y * tt;
  const int rows = tt * cc, ncells = min(cc, C - c0);

  // the global row (t C + c) of tile row r, or -1 past the ragged edge
  auto grow = [&](int r) -> long long {
    if (r >= rows) return -1;
    const int t = t0 + r / cc, c = c0 + r % cc;
    return (t < Tn && c < C) ? (long long)t * C + c : -1;
  };
  // stage ub or ua rows (asynchronously); the first staging also writes
  // the zeros of the padded dofs and of the rows past the edge
  auto stage = [&](const double* u, bool zeros) {
    for (int i = threadIdx.x; i < ROWS * AP; i += DTHREADS) {
      const int r = i / AP, a = i - r * AP;
      const long long g = grow(r);
      if (g >= 0 && a < A)
        cp_async8(us + r * US + a, u + g * A + a);
      else if (zeros)
        us[r * US + a] = 0.0;
    }
  };
  // PhiG[:, q0:q0+NC] and the tile's W[:, q0:q0+NC] into buffer b
  auto load_chunk = [&](int b, int q0) {
    double* pb = ps + b * AP * PS;
    for (int i = threadIdx.x; i < AP * (NC / 2); i += DTHREADS) {
      const int a = i / (NC / 2), h = i - a * (NC / 2);
      cp_async16(pb + a * PS + 2 * h,
                 phig + (long long)a * nqp + q0 + 2 * h);
    }
    double* wb = ws + b * cc * WS;
    for (int i = threadIdx.x; i < ncells * (NC / 2); i += DTHREADS) {
      const int c = i / (NC / 2), h = i - c * (NC / 2);
      cp_async16(wb + c * WS + 2 * h,
                 w + (long long)(c0 + c) * nqp + q0 + 2 * h);
    }
  };

  // the tile's cells of this thread's two C-fragment rows
  int wcell[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) wcell[mi] = (16 * wm + 8 * mi + lr) % cc;

  // C fragments: [0], [1] row 16 wm + lr, [2], [3] row 16 wm + 8 + lr
  double y[NTW][4];
#pragma unroll
  for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[ni][i] = 0.0;
  const int r0 = 16 * wm + lr;

  const int nchunks = nqp / NC, vchunks = qp / NC;
  stage(ub, true);
  load_chunk(0, 0);
  cp_async_commit();
  for (int j = 0; j < nchunks; ++j) {
    const double* pc = ps + (j & 1) * AP * PS;
    const double* wc = ws + (j & 1) * cc * WS;
    if (j + 1 < nchunks) {
      load_chunk((j + 1) & 1, (j + 1) * NC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // phase 1: S[16 wm.., 16 wn..] = U @ PhiG[:, chunk], then * W
    double sc[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[ni][i] = 0.0;
#pragma unroll 2
    for (int k = 0; k < AP / 8; ++k) {
      const double* u0 = us + r0 * US + 8 * k + lc;
      const double a0 = u0[0], a1 = u0[8 * US], a2 = u0[4],
                   a3 = u0[8 * US + 4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const double* pb = pc + (8 * k + lc) * PS + 16 * wn + 8 * ni + lr;
        dmma(sc[ni], a0, a1, a2, a3, pb[0], pb[4 * PS]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int col = 16 * wn + 8 * ni + 2 * lc;
        const double2 wv =
            *reinterpret_cast<const double2*>(wc + wcell[mi] * WS + col);
        double* sp = ss + (r0 + 8 * mi) * PS + col;
        sp[0] = sc[ni][2 * mi] * wv.x;
        sp[1] = sc[ni][2 * mi + 1] * wv.y;
      }
    __syncthreads();
    // the last value chunk has read ub: bring ua in behind phase 2
    if (j == vchunks - 1) {
      stage(ua, false);
      cp_async_commit();
    }

    // phase 2: Y[16 wm.., (AP/2) wn..] += S @ PhiG[:, chunk]^T
#pragma unroll
    for (int k = 0; k < NC / 8; ++k) {
      const double* s0 = ss + r0 * PS + 8 * k + lc;
      const double a0 = s0[0], a1 = s0[8 * PS], a2 = s0[4],
                   a3 = s0[8 * PS + 4];
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni) {
        const double* pb =
            pc + ((AP / 2) * wn + 8 * ni + lr) * PS + 8 * k + lc;
        dmma(y[ni], a0, a1, a2, a3, pb[0], pb[4]);
      }
    }
    __syncthreads();   // S and this chunk's buffers are free again
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const long long g = grow(r0 + 8 * mi);
    if (g < 0) continue;
#pragma unroll
    for (int ni = 0; ni < NTW; ++ni) {
      const int a = (AP / 2) * wn + 8 * ni + 2 * lc;
      if (a < A) out[g * A + a] = y[ni][2 * mi];
      if (a + 1 < A) out[g * A + a + 1] = y[ni][2 * mi + 1];
    }
  }
}

template <int NTW>
int launch_dmma(const double* ub, const double* ua, const double* phig,
                const double* w, double* out, int Tn, int C, int A, int qp,
                int nqp, int tt, int cc, cudaStream_t stream) {
  constexpr int AP = 16 * NTW;
  const size_t smem =
      sizeof(double) * ((size_t)ROWS * (AP + 4) + 2 * AP * PS + ROWS * PS +
                        2 * cc * WS);
  auto kern = quad_middle_dmma<NTW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned int)((C + cc - 1) / cc),
                  (unsigned int)((Tn + tt - 1) / tt));
  kern<<<grid, DTHREADS, smem, stream>>>(ub, ua, phig, w, out, Tn, C, A, qp,
                                         nqp, tt, cc);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --

constexpr int THREADS = 256;
constexpr int GROUP = 4;        // blocks per phase-2 thread

template <int TT>
__global__ void __launch_bounds__(THREADS)
quad_middle_f32(const float* __restrict__ ub, const float* __restrict__ ua,
                const float* __restrict__ phig,
                const float* __restrict__ phigT, const float* __restrict__ w,
                float* __restrict__ out, int Tn, int C, int A, int Q,
                int NQ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* us = reinterpret_cast<float*>(smem_raw);   // [2][A][TT]: ub, ua
  float* qs = us + 2 * A * TT;                      // [NQ][TT]: weighted
  const long long c = blockIdx.x;
  const int t0 = blockIdx.y * TT;
  const int nt = min(TT, Tn - t0);

  for (int i = threadIdx.x; i < 2 * TT * A; i += THREADS) {
    const int which = i / (TT * A);
    const int r = i - which * TT * A;
    const int t = r / A, a = r - (r / A) * A;
    const float* src = which ? ua : ub;
    us[(which * A + a) * TT + t] =
        t < nt ? src[((long long)(t0 + t) * C + c) * A + a] : 0.0f;
  }
  __syncthreads();

  const float* wc = w + c * NQ;
  for (int j = threadIdx.x; j < NQ; j += THREADS) {
    const float* u = us + (j < Q ? 0 : A * TT);
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.0f;
    for (int a = 0; a < A; ++a) {
      const float p = phig[(long long)a * NQ + j];
      const float* ua_ = u + a * TT;
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] += ua_[t] * p;
    }
    const float wj = wc[j];
#pragma unroll
    for (int t = 0; t < TT; ++t) qs[j * TT + t] = acc[t] * wj;
  }
  __syncthreads();

  const int groups = (nt + GROUP - 1) / GROUP;
  for (int item = threadIdx.x; item < A * groups; item += THREADS) {
    const int a = item % A, g = item / A;
    float acc[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) acc[i] = 0.0f;
    const float* qg = qs + g * GROUP;
    for (int j = 0; j < NQ; ++j) {
      const float p = phigT[(long long)j * A + a];
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

template <int TT>
int launch_f32_tt(const float* ub, const float* ua, const float* phig,
                  const float* phigT, const float* w, float* out, int Tn,
                  int C, int A, int Q, int NQ, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * A + NQ) * TT * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = quad_middle_f32<TT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned int)C, (unsigned int)((Tn + TT - 1) / TT));
  kern<<<grid, THREADS, smem, stream>>>(ub, ua, phig, phigT, w, out, Tn, C,
                                        A, Q, NQ);
  return (int)cudaGetLastError();
}

}  // namespace

// FP64 on the tensor cores.  phig: (ap, nqp) and w: (C, nqp), zero-padded
// (ap = 16, 32, .., 128 >= A; qp and nqp - qp multiples of 32, the value
// columns first); ub, ua, out: (Tn, C, A); a tile is tt blocks x cc cells
// with tt cc <= 64.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int stfem_quad_middle_f64(const void* ub, const void* ua,
                                     const void* phig, const void* w,
                                     void* out, int Tn, int C, int A, int ap,
                                     int qp, int nqp, int tt, int cc,
                                     void* stream) {
  if (Tn <= 0 || C <= 0 || A <= 0 || A > ap || ap % 16 || qp <= 0 ||
      qp % NC || nqp <= qp || nqp % NC || tt <= 0 || cc <= 0 ||
      tt * cc > ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto u = static_cast<const double*>(ub), v = static_cast<const double*>(ua);
  auto p = static_cast<const double*>(phig);
  auto wp = static_cast<const double*>(w);
  auto o = static_cast<double*>(out);
  using Launch = int (*)(const double*, const double*, const double*,
                         const double*, double*, int, int, int, int, int,
                         int, int, cudaStream_t);
  static const Launch by_ap[] = {launch_dmma<1>, launch_dmma<2>,
                                 launch_dmma<3>, launch_dmma<4>,
                                 launch_dmma<5>, launch_dmma<6>,
                                 launch_dmma<7>, launch_dmma<8>};
  if (ap > 16 * 8) return (int)cudaErrorInvalidValue;
  return by_ap[ap / 16 - 1](u, v, p, wp, o, Tn, C, A, qp, nqp, tt, cc, st);
}

// f32 on the CUDA cores.  phig (A, NQ), phigT its contiguous transpose,
// w (C, NQ); the chunk of blocks per thread block is the fewest chunks of
// at most 16, each rounded up to a multiple of GROUP (T=24 -> 2 x 12).
extern "C" int stfem_quad_middle_f32(const void* ub, const void* ua,
                                     const void* phig, const void* phigT,
                                     const void* w, void* out, int Tn, int C,
                                     int A, int Q, int NQ, void* stream) {
  if (Tn <= 0 || C <= 0 || A <= 0 || Q <= 0 || NQ < Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto u = static_cast<const float*>(ub), v = static_cast<const float*>(ua);
  auto p = static_cast<const float*>(phig);
  auto pt = static_cast<const float*>(phigT);
  auto wp = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  const int chunks = (Tn + 15) / 16;
  const int tt = ((Tn + chunks - 1) / chunks + GROUP - 1) / GROUP * GROUP;
  switch (tt) {
    case 4: return launch_f32_tt<4>(u, v, p, pt, wp, o, Tn, C, A, Q, NQ, st);
    case 8: return launch_f32_tt<8>(u, v, p, pt, wp, o, Tn, C, A, Q, NQ, st);
    case 12: return launch_f32_tt<12>(u, v, p, pt, wp, o, Tn, C, A, Q, NQ, st);
    case 16: return launch_f32_tt<16>(u, v, p, pt, wp, o, Tn, C, A, Q, NQ, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
