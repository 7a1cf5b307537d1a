// K4: the per-block grid chain of the grid-mode Vanka down/up, for Hopper
// (sm_90a), on cell-blocked matrices.
//
// Replaces: stfem_tpu/ops/pallas_grid.py::_chain (the Pallas TPU kernel
// bodies `_down_body`, line 119, and `_up_body`, line 138; pallas_call at
// line 158), reached through chain_down (line 196) and chain_up (line 206).
//
// What it computes: for every space-time block b
//     y[b, i0, i1, i2] = sum_{j0,j1,j2} M0[i0,j0] M1[i1,j1] M2[i2,j2]
//                        x[b, j0, j1, j2]
// with sums in f32 (f64 for f64 data) from bf16/f32 data and matrices, and
// y rounded once to the output dtype (the TPU kernel's "widen at entry"
// rule), in the natural axis order.  The matrices are cell-blocked, axis by
// axis: an axis has nc cells, n = nc k + 1 dofs (cell c holds dofs
// c k .. c k + k, neighbours share a face dof) and q = nc r eigen rows
// (cell c owns rows c r .. c r + r - 1).
//   down, M_d (q_d, n_d): row c r + a reads only columns c k .. c k + k;
//   up,   M_d (n_d, q_d): the transposed pattern, so dof c k + l collects
//         cell c's rows (l < k, or l = k on the last cell) and, for l = 0
//         and c > 0, also cell c-1's rows (the overlap-add of the face).
// The Vanka has r = k + 1; any r <= 8 and k <= 7 is taken.  The caller
// checks the pattern once (ops/grid_chain.py); the kernels read only the
// in-pattern entries.  dim 2 runs as a leading axis of one cell with k = 0
// and r = 1 (m0 == nullptr: the identity).
//
// What bounds it on the H100: device memory.  At the heat fine level
// (nb = 96, 65^3 <-> 80^3, bf16) the down chain reads x (53 MB) and writes
// w (98 MB), the up chain reads w and writes y: ~302 MB, 0.090 ms at
// 3.35 TB/s, against ~30 flops per output element.
//
// What the design does about it: one pass per chain, no intermediate in
// device memory, and a CTA's loads issued before it contracts (a first
// try that walked the planes one at a time, load -> contract -> next
// plane, was latency-bound at ~1/7 of the memory rate).  A CTA owns one
// (block b, axis-0 cell c0, tile of axis-1 cells) and
//   down: loads the cell's k + 1 dof planes of its tile's dof rows (one
//   contiguous run each) and applies axis 0 on the way into shared memory
//   (r planes), then axis 2 in shared memory, then axis 1 per output
//   position, writing w once, a contiguous run per eigen plane;
//   up (owner computes, no atomics): owns dof planes c0 k .. c0 k + k - 1
//   (the last cell also n0 - 1) and the dof rows of its axis-1 cells; it
//   loads the r eigen planes of cell c0 and of cell c0 - 1 (those reach
//   dof plane c0 k only; their re-read, and that of one axis-1 cell, comes
//   from L2), bf16 two elements a load, applies axis 0 on the way in, then
//   axes 2 and 1, and writes each y element once.
// Each axis-2 and axis-1 contraction runs per (row, cell) or (cell,
// column) item with the cell's (k + 1) x r block in registers, reading
// only the in-pattern entries, from per-CTA tables fetched while the data
// loads are in flight.  At the heat fine level a CTA (4 axis-1 cells,
// 192 threads: the tile plan of ops/grid_chain.py) holds ~50 KB (down) /
// ~75 KB (up) of shared memory, so several share an SM.  Staging the runs by cp.async instead was slower (more registers,
// fewer CTAs an SM).  The coarse levels (nc = 1-2) launch few CTAs and
// leave SMs idle; they are small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxR = 8;       // eigen rows per cell, and k + 1
constexpr size_t kMaxSmem = 232448;

struct Axis {
  int nc, k, r, n, q;          // cells, degree, rows per cell, nc k + 1, nc r
};

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

// the cell that holds dof j as its local dof j - c k with j - c k < k, or
// the last cell for the last dof
__device__ __forceinline__ int dof_cell(int j, const Axis& ax) {
  return ax.k == 0 ? 0 : min(j / ax.k, ax.nc - 1);
}

// entry e of an axis' table of in-pattern entries, cell by cell from
// cell c_first: T[c][l][a] = M[c r + a, c k + l] (down) or M[c k + l,
// c r + a] (up), l <= k, a < r
template <typename TM, typename A>
__device__ __forceinline__ A block_entry(const TM* __restrict__ m,
                                         const Axis& ax, int c_first, int e,
                                         bool up) {
  const int blk = (ax.k + 1) * ax.r;
  const int cl = e / blk, rem = e - cl * blk, l = rem / ax.r;
  const long long c = c_first + cl, i = c * ax.r + (rem - l * ax.r),
                  j = c * ax.k + l;
  return to_acc<A>(up ? m[j * ax.q + i] : m[i * ax.n + j]);
}

// The tables of axis 2 (all cells) and axis 1 (cells c1 .. c1 + n1c - 1),
// one after the other in t: each thread fetches its first kTab entries
// into registers with fetch(), before the data loads, and stores them
// with put() after them, so that the two round trips overlap.
constexpr int kTab = 4;
template <typename TM, typename A>
struct Tables {
  const TM* m1;
  const TM* m2;
  Axis a1, a2;
  int c1, n1c, n2tab, ntab;
  bool up;
  A reg[kTab];
  __device__ Tables(const TM* m1_, const TM* m2_, const Axis& a1_,
                    const Axis& a2_, int c1_, int n1c_, bool up_)
      : m1(m1_), m2(m2_), a1(a1_), a2(a2_), c1(c1_), n1c(n1c_), up(up_) {
    n2tab = a2.nc * (a2.k + 1) * a2.r;
    ntab = n2tab + n1c * (a1.k + 1) * a1.r;
  }
  __device__ A entry(int e) const {
    return e < n2tab ? block_entry<TM, A>(m2, a2, 0, e, up)
                     : block_entry<TM, A>(m1, a1, c1, e - n2tab, up);
  }
  __device__ void fetch() {
#pragma unroll
    for (int i = 0; i < kTab; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      reg[i] = e < ntab ? entry(e) : (A)0;
    }
  }
  __device__ void put(A* t) const {
#pragma unroll
    for (int i = 0; i < kTab; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      if (e < ntab) t[e] = reg[i];
    }
    for (int e = threadIdx.x + kTab * blockDim.x; e < ntab; e += blockDim.x)
      t[e] = entry(e);
  }
};

// down chain: x [nb, n0, n1, n2] -> w [nb, q0, q1, q2]
template <int NR, typename TX, typename TM, typename TO, typename A>
__global__ void __launch_bounds__(kMaxThreads)
grid_chain_down_kernel(const TX* __restrict__ x, const TM* __restrict__ m0,
                       const TM* __restrict__ m1, const TM* __restrict__ m2,
                       TO* __restrict__ w, Axis a0, Axis a1, Axis a2,
                       int tile1, int n_tiles1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int t1 = blockIdx.x % n_tiles1;
  const int c0 = (blockIdx.x / n_tiles1) % a0.nc;
  const long long b = blockIdx.x / ((long long)n_tiles1 * a0.nc);
  const int c1a = t1 * tile1, nct = min(c1a + tile1, a1.nc) - c1a;
  const int n2 = a2.n, q2 = a2.q, k0 = a0.k, k1 = a1.k, k2 = a2.k;
  const int r0 = a0.r, r1 = a1.r, r2 = a2.r;
  const int rin = nct * k1 + 1, rin_max = tile1 * k1 + 1;
  const int ldt = n2 | 1, lds = q2 | 1;           // odd row strides

  A* t0 = reinterpret_cast<A*>(smem_raw);         // [r0][rin_max][ldt]
  A* s2 = t0 + r0 * rin_max * ldt;                // [r0][rin_max][lds]
  A* tb2 = s2 + r0 * rin_max * lds;               // [nc2][k2 + 1][r2]
  A* tb1 = tb2 + a2.nc * (k2 + 1) * r2;           // [nct][k1 + 1][r1]
  Tables<TM, A> tabs(m1, m2, a1, a2, c1a, nct, false);
  tabs.fetch();
  A cf0[NR][NR];                                  // cell c0's block [a][l]
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int l = 0; l < NR; ++l)
      cf0[a][l] = (a < r0 && l <= k0)
                      ? (m0 ? to_acc<A>(m0[(long long)(c0 * r0 + a) * a0.n +
                                           c0 * k0 + l])
                            : (A)1)
                      : (A)0;

  // axis 0 while loading: the cell's k0 + 1 dof planes of the tile's dof
  // rows (one contiguous run each) -> r0 planes
  const long long plane = (long long)a1.n * n2;
  const TX* xb = x + (b * a0.n + (long long)c0 * k0) * plane +
                 (long long)c1a * k1 * n2;
  const int tplane = rin_max * ldt;
  for (int e = tid; e < rin * n2; e += nthr) {
    A v[NR];
#pragma unroll
    for (int l = 0; l < NR; ++l)
      v[l] = l <= k0 ? to_acc<A>(xb[l * plane + e]) : (A)0;
    const int row = e / n2;
    A* dst = t0 + row * ldt + (e - row * n2);
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      if (a < r0) {
        A acc = (A)0;
#pragma unroll
        for (int l = 0; l < NR; ++l) acc += cf0[a][l] * v[l];
        dst[a * tplane] = acc;
      }
    }
  }
  tabs.put(tb2);
  __syncthreads();
  // axis 2, one (dof row, cell c2) per item for all r0 planes, with the
  // cell's block in registers and neighbouring lanes on neighbouring rows:
  // k2 + 1 dofs in, r2 eigen columns out
  const int splane = rin_max * lds;
  for (int it = tid; it < rin * a2.nc; it += nthr) {
    const int c2 = it / rin, row = it - c2 * rin;
    const A* tb = tb2 + c2 * (k2 + 1) * r2;
    A cf[NR][NR];
#pragma unroll
    for (int l = 0; l < NR; ++l)
#pragma unroll
      for (int a = 0; a < NR; ++a)
        cf[l][a] = l <= k2 && a < r2 ? tb[l * r2 + a] : (A)0;
    for (int pl = 0; pl < r0; ++pl) {
      const A* src = t0 + pl * tplane + row * ldt + c2 * k2;
      A v[NR];
#pragma unroll
      for (int l = 0; l < NR; ++l) v[l] = l <= k2 ? src[l] : (A)0;
      A* dst = s2 + pl * splane + row * lds + c2 * r2;
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        if (a < r2) {
          A acc = (A)0;
#pragma unroll
          for (int l = 0; l < NR; ++l) acc += cf[l][a] * v[l];
          dst[a] = acc;
        }
      }
    }
  }
  __syncthreads();
  // axis 1, one (cell c1, column i2) per item for all r0 planes, with the
  // cell's block in registers and neighbouring lanes on neighbouring
  // columns: w written once, coalesced
  TO* wb = w + ((b * a0.q + (long long)c0 * r0) * a1.q +
                (long long)c1a * r1) * q2;
  const long long wplane = (long long)a1.q * q2;
  for (int it = tid; it < nct * q2; it += nthr) {
    const int cl = it / q2, i2 = it - cl * q2;
    const A* tb = tb1 + cl * (k1 + 1) * r1;
    A cf[NR][NR];
#pragma unroll
    for (int l = 0; l < NR; ++l)
#pragma unroll
      for (int j = 0; j < NR; ++j)
        cf[l][j] = l <= k1 && j < r1 ? tb[l * r1 + j] : (A)0;
    for (int pl = 0; pl < r0; ++pl) {
      const A* src = s2 + pl * splane + cl * k1 * lds + i2;
      A v[NR];
#pragma unroll
      for (int l = 0; l < NR; ++l) v[l] = l <= k1 ? src[l * lds] : (A)0;
      TO* dst = wb + pl * wplane + (long long)cl * r1 * q2 + i2;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        if (j < r1) {
          A acc = (A)0;
#pragma unroll
          for (int l = 0; l < NR; ++l) acc += cf[l][j] * v[l];
          store(dst + j * q2, acc);
        }
      }
    }
  }
}

// v[0..P)[a] = src[0..P) as A: one 2P-byte load when paired, else one
// element (v[0][a])
template <int P, typename TX, typename A, int NR>
__device__ __forceinline__ void load_run(const TX* src, bool paired,
                                         A (&v)[P][NR], int a) {
  if (P == 2 && paired) {
    const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(src);
    v[0][a] = to_acc<A>(pr.x);
    v[P - 1][a] = to_acc<A>(pr.y);
  } else {
    v[0][a] = to_acc<A>(src[0]);
  }
}

// up chain: w [nb, q0, q1, q2] -> y [nb, n0, n1, n2]
template <int NR, typename TX, typename TM, typename TO, typename A>
__global__ void __launch_bounds__(kMaxThreads)
grid_chain_up_kernel(const TX* __restrict__ w, const TM* __restrict__ m0,
                     const TM* __restrict__ m1, const TM* __restrict__ m2,
                     TO* __restrict__ y, Axis a0, Axis a1, Axis a2,
                     int tile1, int n_tiles1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int t1 = blockIdx.x % n_tiles1;
  const int c0 = (blockIdx.x / n_tiles1) % a0.nc;
  const long long b = blockIdx.x / ((long long)n_tiles1 * a0.nc);
  const int c1a = t1 * tile1, c1b = min(c1a + tile1, a1.nc);
  const int cs = c1a > 0 ? c1a - 1 : 0;           // first source cell
  const int n2 = a2.n, q2 = a2.q, k0 = a0.k, k1 = a1.k, k2 = a2.k;
  const int r0 = a0.r, r1 = a1.r, r2 = a2.r;
  const int rsrc = (c1b - cs) * r1;               // eigen rows read
  const int nown = c0 == a0.nc - 1 ? k0 + 1 : k0; // dof planes owned
  const int rsrc_max = (tile1 + 1) * r1;
  const int ldt = q2 | 1, lds = n2 | 1;           // odd row strides

  A* t0 = reinterpret_cast<A*>(smem_raw);         // [k0+1][rsrc_max][ldt]
  A* s2 = t0 + (k0 + 1) * rsrc_max * ldt;         // [k0+1][rsrc_max][lds]
  A* tc2 = s2 + (k0 + 1) * rsrc_max * lds;        // [nc2][k2 + 1][r2]
  A* tc1 = tc2 + a2.nc * (k2 + 1) * r2;           // [c1b - cs][k1 + 1][r1]
  Tables<TM, A> tabs(m1, m2, a1, a2, cs, c1b - cs, true);
  tabs.fetch();
  // cell c0's block [o][a] (dof plane c0 k0 + o), and cell c0 - 1's row
  // for the shared face plane c0 k0
  A cf0[NR][NR], face0[NR];
#pragma unroll
  for (int o = 0; o < NR; ++o)
#pragma unroll
    for (int a = 0; a < NR; ++a)
      cf0[o][a] = (o < nown && a < r0)
                      ? (m0 ? to_acc<A>(m0[(long long)(c0 * k0 + o) * a0.q +
                                           c0 * r0 + a])
                            : (A)1)
                      : (A)0;
#pragma unroll
  for (int a = 0; a < NR; ++a)
    face0[a] = (c0 > 0 && a < r0)
                   ? to_acc<A>(m0[(long long)c0 * k0 * a0.q + (c0 - 1) * r0 +
                                  a])
                   : (A)0;

  // axis 0 while loading: the r0 eigen planes of cell c0 (and of c0 - 1)
  // of the tile's source rows (one contiguous run each) -> the owned dof
  // planes.  Two-byte data goes two elements a load where the runs allow.
  const long long wplane = (long long)a1.q * q2;
  const TX* wb = w + (b * a0.q + (long long)c0 * r0) * wplane +
                 (long long)cs * r1 * q2;
  const int tplane = rsrc_max * ldt, nin = rsrc * q2;
  constexpr int P = sizeof(TX) == 2 ? 2 : 1;      // elements a load
  const bool paired = P == 2 && q2 % 2 == 0 &&
                      (reinterpret_cast<unsigned long long>(w) & 3) == 0;
  const int step = paired ? P : 1;
  for (int e = tid * step; e < nin; e += nthr * step) {
    A v[P][NR], u[P][NR];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
#pragma unroll
      for (int h = 0; h < P; ++h) v[h][a] = u[h][a] = (A)0;
      if (a < r0) load_run<P>(wb + a * wplane + e, paired, v, a);
      if (a < r0 && c0 > 0) load_run<P>(wb + (a - r0) * wplane + e, paired, u, a);
    }
#pragma unroll
    for (int h = 0; h < P; ++h) {
      if (h < step) {
        const int row = (e + h) / q2;
        A* dst = t0 + row * ldt + (e + h - row * q2);
#pragma unroll
        for (int o = 0; o < NR; ++o) {
          if (o < nown) {
            A acc = (A)0;
#pragma unroll
            for (int a = 0; a < NR; ++a) acc += cf0[o][a] * v[h][a];
            if (o == 0) {
#pragma unroll
              for (int a = 0; a < NR; ++a) acc += face0[a] * u[h][a];
            }
            dst[o * tplane] = acc;
          }
        }
      }
    }
  }
  tabs.put(tc2);
  __syncthreads();
  // axis 2, one (eigen row, cell c2) per item for all owned planes, with
  // the cell's block in registers and neighbouring lanes on neighbouring
  // rows: the cell's r2 columns (and, for its face dof, cell c2 - 1's) in,
  // its k2 dofs (k2 + 1 on the last cell) out
  const int splane = rsrc_max * lds;
  for (int it = tid; it < rsrc * a2.nc; it += nthr) {
    const int c2 = it / rsrc, row = it - c2 * rsrc;
    const int nout = c2 == a2.nc - 1 ? k2 + 1 : k2;
    const A* tc = tc2 + c2 * (k2 + 1) * r2;
    A cf[NR][NR], fc[NR];
#pragma unroll
    for (int l = 0; l < NR; ++l)
#pragma unroll
      for (int a = 0; a < NR; ++a)
        cf[l][a] = l < nout && a < r2 ? tc[l * r2 + a] : (A)0;
#pragma unroll
    for (int a = 0; a < NR; ++a) fc[a] = c2 > 0 && a < r2 ? tc[a - r2] : (A)0;
    for (int o = 0; o < nown; ++o) {
      const A* src = t0 + o * tplane + row * ldt + c2 * r2;
      A v[NR], u[NR];
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        v[a] = a < r2 ? src[a] : (A)0;
        u[a] = a < r2 && c2 > 0 ? src[a - r2] : (A)0;
      }
      A* dst = s2 + o * splane + row * lds + c2 * k2;
#pragma unroll
      for (int l = 0; l < NR; ++l) {
        if (l < nout) {
          A acc = (A)0;
#pragma unroll
          for (int a = 0; a < NR; ++a) acc += cf[l][a] * v[a];
          if (l == 0) {
#pragma unroll
            for (int a = 0; a < NR; ++a) acc += fc[a] * u[a];
          }
          dst[l] = acc;
        }
      }
    }
  }
  __syncthreads();
  // axis 1, one (cell c1, dof column j2) per item for all owned planes,
  // with the cell's block in registers and neighbouring lanes on
  // neighbouring columns: y written once, coalesced
  const int nct = c1b - c1a;
  TO* yb = y + ((b * a0.n + (long long)c0 * k0) * a1.n +
                (long long)c1a * k1) * n2;
  const long long yplane = (long long)a1.n * n2;
  for (int it = tid; it < nct * n2; it += nthr) {
    const int cl = it / n2, j2 = it - cl * n2, c = c1a + cl;
    const int nout = c == a1.nc - 1 ? k1 + 1 : k1;
    const A* tc = tc1 + (c - cs) * (k1 + 1) * r1;
    A cf[NR][NR], fc[NR];
#pragma unroll
    for (int l = 0; l < NR; ++l)
#pragma unroll
      for (int a = 0; a < NR; ++a)
        cf[l][a] = l < nout && a < r1 ? tc[l * r1 + a] : (A)0;
#pragma unroll
    for (int a = 0; a < NR; ++a) fc[a] = c > 0 && a < r1 ? tc[a - r1] : (A)0;
    for (int o = 0; o < nown; ++o) {
      const A* src = s2 + o * splane + (c - cs) * r1 * lds + j2;
      A v[NR], u[NR];
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        v[a] = a < r1 ? src[a * lds] : (A)0;
        u[a] = a < r1 && c > 0 ? src[(a - r1) * lds] : (A)0;
      }
      TO* dst = yb + o * yplane + (long long)cl * k1 * n2 + j2;
#pragma unroll
      for (int l = 0; l < NR; ++l) {
        if (l < nout) {
          A acc = (A)0;
#pragma unroll
          for (int a = 0; a < NR; ++a) acc += cf[l][a] * v[a];
          if (l == 0) {
#pragma unroll
            for (int a = 0; a < NR; ++a) acc += fc[a] * u[a];
          }
          store(dst + l * n2, acc);
        }
      }
    }
  }
}

template <typename A>
size_t down_smem(const Axis& a0, const Axis& a1, const Axis& a2, int tile1) {
  const size_t rows = (size_t)a0.r * (tile1 * a1.k + 1);
  return sizeof(A) * (rows * ((a2.n | 1) + (a2.q | 1)) +
                      (size_t)a2.nc * (a2.k + 1) * a2.r +
                      (size_t)tile1 * (a1.k + 1) * a1.r);
}

template <typename A>
size_t up_smem(const Axis& a0, const Axis& a1, const Axis& a2, int tile1) {
  const size_t rows = (size_t)(a0.k + 1) * (tile1 + 1) * a1.r;
  return sizeof(A) * (rows * ((a2.q | 1) + (a2.n | 1)) +
                      (size_t)a2.nc * (a2.k + 1) * a2.r +
                      (size_t)(tile1 + 1) * (a1.k + 1) * a1.r);
}

bool valid(const Axis& a) {
  return a.nc > 0 && a.k >= 0 && a.k + 1 <= kMaxR && a.r > 0 &&
         a.r <= kMaxR && (a.k > 0 || a.nc == 1) && a.n == a.nc * a.k + 1 &&
         a.q == a.nc * a.r;
}

template <int NR, typename TX, typename TM, typename TO, typename A>
int launch(bool up, const void* x, const void* m0, const void* m1,
           const void* m2, void* y, long long nb, const Axis& a0,
           const Axis& a1, const Axis& a2, int tile1, int threads,
           cudaStream_t st) {
  const int n_tiles1 = (a1.nc + tile1 - 1) / tile1;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      tile1 <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = up ? up_smem<A>(a0, a1, a2, tile1)
                         : down_smem<A>(a0, a1, a2, tile1);
  const long long grid = nb * a0.nc * n_tiles1;
  if (smem > kMaxSmem || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto* kern = up ? grid_chain_up_kernel<NR, TX, TM, TO, A>
                  : grid_chain_down_kernel<NR, TX, TM, TO, A>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned int)grid, threads, smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TM*>(m0),
      static_cast<const TM*>(m1), static_cast<const TM*>(m2),
      static_cast<TO*>(y), a0, a1, a2, tile1, n_tiles1);
  return (int)cudaGetLastError();
}

// the per-item register arrays hold max(k + 1, r) <= NR values
template <typename TX, typename TM, typename TO, typename A>
int launch_nr(bool up, const void* x, const void* m0, const void* m1,
              const void* m2, void* y, long long nb, const Axis* ax,
              int tile1, int threads, cudaStream_t st) {
  int nr = 1;
  for (int d = 0; d < 3; ++d) nr = max(nr, max(ax[d].k + 1, ax[d].r));
  return nr <= 5 ? launch<5, TX, TM, TO, A>(up, x, m0, m1, m2, y, nb, ax[0],
                                           ax[1], ax[2], tile1, threads, st)
                 : launch<kMaxR, TX, TM, TO, A>(up, x, m0, m1, m2, y, nb,
                                                ax[0], ax[1], ax[2], tile1,
                                                threads, st);
}

}  // namespace

// up = 0: the down chain, x [nb, n0, n1, n2] -> y [nb, q0, q1, q2] with
// matrices (q_d, n_d); up = 1: the up chain, x [nb, q0, q1, q2] -> y
// [nb, n0, n1, n2] with matrices (n_d, q_d).  nc, k and r hold the three
// axes' cells, degrees and rows per cell (n_d = nc_d k_d + 1, q_d = nc_d
// r_d); m0 == nullptr stands for a leading axis of one cell with k = 0,
// r = 1.  tile1 axis-1 cells per CTA, threads per CTA (a multiple of 32,
// <= 256).  dtype codes:
// 0 = float32, 1 = bfloat16, 2 = float64; bf16/f32 data and matrices with
// f32 sums, or all f64.  Returns the CUDA error code (0 = success;
// cudaErrorInvalidValue for an unsupported combination or shape).
extern "C" int stfem_grid_chain(int up, const void* x, const void* m0,
                                const void* m1, const void* m2, void* y,
                                long long nb, const int* nc, const int* k,
                                const int* r, int tile1, int threads,
                                int x_dtype, int m_dtype, int y_dtype,
                                void* stream) {
  Axis ax[3];
  for (int d = 0; d < 3; ++d) {
    ax[d] = Axis{nc[d], k[d], r[d], nc[d] * k[d] + 1, nc[d] * r[d]};
    if (!valid(ax[d])) return (int)cudaErrorInvalidValue;
  }
  if (nb <= 0 || (m0 == nullptr && (ax[0].nc != 1 || ax[0].k != 0 ||
                                    ax[0].r != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = x_dtype * 9 + m_dtype * 3 + y_dtype;
#define STFEM_CHAIN(XC, MC, YC, TX, TM, TO, A)                              \
  case XC * 9 + MC * 3 + YC:                                                \
    return launch_nr<TX, TM, TO, A>(up != 0, x, m0, m1, m2, y, nb, ax,      \
                                    tile1, threads, st);
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
