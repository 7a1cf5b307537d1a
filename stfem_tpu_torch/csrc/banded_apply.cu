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
// skipped, and the taps are summed in the order t = 0..2k.
//
// What bounds it on the H100: device memory.  16 B per element (x read
// once, y written once) against 2(2k+1) FP64 flops -- far under the FP64
// roof.  At B = 128 x 65^3, k = 4 that is 562 MB, 0.168 ms at 3.35 TB/s.
//
// What the design does about it: every x is read from device memory once
// and every y written once, each by a coalesced access; the 2k+1 taps
// come from registers or shared memory, never again through the caches.
// A tile is staged in shared memory by cp.async (8-byte copies: odd n
// leaves rows unaligned for 16-byte vectors).
// - Contiguous axis (inner = 1, n <= 256): thread (i, q) of an (n, 256/n)
//   block keeps its 2k+1 diagonals D[:, i] in registers and computes
//   output i of every (256/n)-th staged row: one shared load per tap, no
//   index arithmetic.  It runs at the speed of a plain copy.
// - Short slabs (n * inner <= 4608 doubles: the middle axis of a 65^3
//   grid): a block stages whole slabs x[o, :, :] and walks them with
//   consecutive threads on consecutive elements, (i, j) advanced without
//   a division; the diagonals are a shared-memory broadcast.
// - Long slabs (the outer axis): one thread per (o, j) pencil walks i
//   with a sliding window of the 2k+1 (+3 look-ahead) values x[o, i-k..,
//   j] in registers, loading the next four values of the pencil together
//   so that loads stay in flight.  A warp covers 32 consecutive j: every
//   load and store is a 256-byte run.  The diagonals sit in shared memory
//   and are read as a broadcast (the whole warp is at the same i).  When
//   there are too few pencils to fill the card, each pencil is cut into
//   segments that re-read their 2k halo values.
// The row and pencil forms size their grids so that a small problem (the
// Stokes rhs, 3 x 17^3) still spreads over the SMs.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LOOK = 4;            // outputs per step of a pencil
constexpr int SLAB = 4608;         // longest slab (n inner doubles) staged
constexpr int TILE = 2048;         // doubles staged a block, short slabs
constexpr long long FILL = 132 * 1024;   // threads that fill the H100

template <int K>
__global__ void __launch_bounds__(THREADS)
banded_pencils(const double* __restrict__ x, const double* __restrict__ diags,
               double* __restrict__ y, long long pencils, int n,
               long long inner, int seg) {
  extern __shared__ double ds[];                    // [(2K+1) n]
  for (int e = threadIdx.x; e < (2 * K + 1) * n; e += THREADS)
    ds[e] = diags[e];
  __syncthreads();
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long s = p / pencils, q = p - s * pencils;
  const int lo = (int)s * seg, hi = min(n, lo + seg);
  if (lo >= n) return;
  const long long o = q / inner, j = q - o * inner;
  const double* xp = x + o * n * inner + j;
  double* yp = y + o * n * inner + j;

  double win[2 * K + LOOK];        // win[t] = x[i0 + t - K]
#pragma unroll
  for (int t = 0; t < 2 * K; ++t) {
    const int src = lo + t - K;
    win[t] = (src >= 0 && src < n) ? xp[(long long)src * inner] : 0.0;
  }
  for (int i0 = lo; i0 < hi; i0 += LOOK) {
#pragma unroll
    for (int u = 0; u < LOOK; ++u) {
      const int src = i0 + K + u;
      win[2 * K + u] = src < n ? xp[(long long)src * inner] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < LOOK; ++u) {
      const int i = i0 + u;
      if (i < hi) {
        double acc = 0.0;
#pragma unroll
        for (int t = 0; t <= 2 * K; ++t) {
          const int src = i + t - K;
          if (src >= 0 && src < n) acc += ds[t * n + i] * win[u + t];
        }
        yp[(long long)i * inner] = acc;
      }
    }
#pragma unroll
    for (int t = 0; t < 2 * K; ++t) win[t] = win[t + LOOK];
  }
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
banded_slabs(const double* __restrict__ x, const double* __restrict__ diags,
             double* __restrict__ y, long long outer, int n, int inner,
             int slabs) {
  extern __shared__ double sm[];
  double* ds = sm;                                  // [(2K+1) n]
  double* xs = sm + (2 * K + 1) * n;                // [slabs n inner]
  const int len = n * inner;
  const long long o0 = (long long)blockIdx.x * slabs;
  const int m = (int)min((long long)slabs, outer - o0) * len;
  const double* xb = x + o0 * len;
  for (int e = threadIdx.x; e < m; e += THREADS) cp_async8(xs + e, xb + e);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int e = threadIdx.x; e < (2 * K + 1) * n; e += THREADS)
    ds[e] = diags[e];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  // (i, j) of element e in its slab, advanced by THREADS elements a step
  // without a division: THREADS = di inner + dj (mod len)
  const int step = THREADS % len, di = step / inner, dj = step - di * inner;
  int i = (threadIdx.x % len) / inner;
  int j = threadIdx.x % len - i * inner;
  double* yb = y + o0 * len;
  for (int e = threadIdx.x; e < m; e += THREADS) {
    const double* xc = xs + (e - i * inner);        // x[o, 0, j]
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t <= 2 * K; ++t) {
      const int src = i + t - K;
      if (src >= 0 && src < n) acc += ds[t * n + i] * xc[src * inner];
    }
    yb[e] = acc;
    j += dj;
    i += di;
    if (j >= inner) { j -= inner; ++i; }
    if (i >= n) i -= n;
  }
}

// The contiguous axis (inner = 1) with n <= THREADS: thread (i, q) of a
// (n, THREADS / n) block keeps its 2K+1 diagonals in registers and
// computes output i of rows q, q + blockDim.y, .. of the staged tile.
template <int K>
__global__ void __launch_bounds__(THREADS)
banded_rows(const double* __restrict__ x, const double* __restrict__ diags,
            double* __restrict__ y, long long outer, int n, int rows) {
  extern __shared__ double xs[];                    // [rows n]
  const int i = threadIdx.x, lin = threadIdx.y * n + i;
  const int nthreads = n * blockDim.y;
  const long long o0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, outer - o0);
  const double* xb = x + o0 * n;
  for (int e = lin; e < nr * n; e += nthreads) cp_async8(xs + e, xb + e);
  asm volatile("cp.async.commit_group;\n" ::);
  double d[2 * K + 1];
#pragma unroll
  for (int t = 0; t <= 2 * K; ++t) d[t] = diags[t * n + i];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  double* yb = y + o0 * n;
  for (int r = threadIdx.y; r < nr; r += blockDim.y) {
    const double* xr = xs + r * n;
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t <= 2 * K; ++t) {
      const int src = i + t - K;
      if (src >= 0 && src < n) acc += d[t] * xr[src];
    }
    yb[r * n + i] = acc;
  }
}

int set_smem(const void* kern, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int K>
int launch(const double* x, const double* d, double* y, long long outer,
           int n, long long inner, cudaStream_t st) {
  const size_t dbytes = sizeof(double) * (2 * K + 1) * (size_t)n;
  const long long len = n * inner;
  if (inner == 1 && n <= THREADS) {
    // whole rows, about TILE doubles a block, fewer where that leaves
    // the grid too small to spread over the card
    const int rq = THREADS / n;
    const long long fill = (outer + 2 * 132 - 1) / (2 * 132);
    long long rows = TILE / n < fill ? TILE / n : fill;
    rows = ((rows + rq - 1) / rq) * rq;
    const long long blocks = (outer + rows - 1) / rows;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(double) * (size_t)(rows * n);
    const int e = set_smem((const void*)banded_rows<K>, smem);
    if (e) return e;
    banded_rows<K><<<(unsigned int)blocks, dim3(n, rq), smem, st>>>(
        x, d, y, outer, n, (int)rows);
  } else if (len <= SLAB) {
    // whole slabs, TILE doubles a block where they are short, and at
    // least one per thread
    long long slabs = (THREADS + len - 1) / len;
    if (slabs * len < TILE) slabs = TILE / len;
    slabs = slabs < 1 ? 1 : slabs;
    const long long blocks = (outer + slabs - 1) / slabs;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = dbytes + sizeof(double) * (size_t)(slabs * len);
    const int e = set_smem((const void*)banded_slabs<K>, smem);
    if (e) return e;
    banded_slabs<K><<<(unsigned int)blocks, THREADS, smem, st>>>(
        x, d, y, outer, n, (int)inner, (int)slabs);
  } else {
    const long long pencils = outer * inner;
    // segments of a pencil: enough threads to fill the card, each
    // segment at least LOOK outputs long
    long long segs = (FILL + pencils - 1) / pencils;
    const long long most = (n + LOOK - 1) / LOOK;
    segs = segs > most ? most : segs;
    const int seg = (int)((n + segs - 1) / segs);
    segs = (n + seg - 1) / seg;
    const long long blocks = (segs * pencils + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const int e = set_smem((const void*)banded_pencils<K>, dbytes);
    if (e) return e;
    banded_pencils<K><<<(unsigned int)blocks, THREADS, dbytes, st>>>(
        x, d, y, pencils, n, inner, seg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [outer, n, inner] f64 (contiguous, distinct); diags: [2k+1, n] f64;
// 0 <= k <= 5 (Q1-Q5).  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int stfem_banded_apply(const void* x, const void* diags, void* y,
                                  long long outer, int n, long long inner,
                                  int k, void* stream) {
  if (outer <= 0 || n <= 0 || inner <= 0 || k < 0 || k > 5)
    return (int)cudaErrorInvalidValue;
  auto xp = static_cast<const double*>(x);
  auto dp = static_cast<const double*>(diags);
  auto yp = static_cast<double*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: return launch<0>(xp, dp, yp, outer, n, inner, st);
    case 1: return launch<1>(xp, dp, yp, outer, n, inner, st);
    case 2: return launch<2>(xp, dp, yp, outer, n, inner, st);
    case 3: return launch<3>(xp, dp, yp, outer, n, inner, st);
    case 4: return launch<4>(xp, dp, yp, outer, n, inner, st);
    default: return launch<5>(xp, dp, yp, outer, n, inner, st);
  }
}
