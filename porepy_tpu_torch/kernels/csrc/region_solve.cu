// K10: the batched interaction-region solve of MPFA/MPSA/Biot.
//
// Replaces the jitted kernel of
// porepy_tpu/numerics/fv/local_solves.py:168-187 (_solve_chunk_device, in
// its f64 branch off the TPU): for each region b of a bucket of B regions of
// one size n,
//
//   s_i     = max_j |A_ij|  (1 where the row is zero)
//   X       = solve(A / s, RHS / s)      LU with partial pivoting
//   OUT     = W X                        (q x n)(n x m) -> (q x m)
//
// with A (B, n, n), RHS (B, n, m), W (B, q, n) and OUT (B, q, m), all f64
// and contiguous. m and q are padded with zeros to the chunk's maxima.
//
// The operations and their order are those of the plain version
// kernels/reference.py, region_solve_ordered, so the two agree to the bit:
// the row scale and every multiplier and x_k by a division (a zero numerator
// multiplied by the divisor instead, the same signed zero without the
// division's slow path: the biot region matrices are 87-96% zeros);
// products and differences rounded apart (__dmul_rn, __dsub_rn, no fused
// multiply-add); per column k the pivot is the first row, in the order of
// the swaps so far, of largest |M_ik| (NaN the largest; LAPACK's i?amax
// choice); back substitution column by column from the last row; OUT as a
// sum over j ascending from 0.0 (__dadd_rn of __dmul_rn).
//
// Rows never move on the register routes: a row's logical position (the
// plain version's swapped order) takes the swaps. Routes by size:
//
//  - n <= 32, n + m <= 64: a warp a region, up to 8 a block (fewer for a
//    small batch, so that it spreads over every SM), __syncwarp only. Lane
//    (ty, tx) of 4 x 8 holds the entries (ty + 4 a, tx + 8 b) of [A | RHS]
//    in registers (20 doubles a lane at n = 20, m = 12).
//  - n <= 96, m <= 128: a block of 16 x 16 threads a region, thread (ty, tx)
//    holding A's entries (ty + 16 a, tx + 16 b) in registers (36 doubles at
//    n = 81), the RHS in shared memory.
//
//    On both, step k = TX kk + kx is unrolled over kk, so column k's
//    entries are a fixed register and the column blocks left of kk, which
//    hold nothing live, are left out of the update. A step has one barrier:
//    every warp finds the pivot on its own from the column it keeps in
//    registers for its search rows (lane + 32 r), on integer keys (three
//    warp reductions) and ballots; the owners stage the pivot row and the
//    column k + 1 before the update into double-buffered shared memory; after
//    the barrier every thread updates its live rows (multipliers by shuffle
//    from the search lanes) and the search lanes bring their column k + 1 up
//    to date with the same operations. Then U and the transformed RHS are
//    laid out in shared memory by positions and the back substitution runs
//    down the RHS columns in registers: a lane a column on the warp route,
//    8 threads a column on the block route (x_k passed by a shuffle), so a
//    step waits on one division and no barrier. OUT = W X takes each output
//    as a sum over j ascending; a thread keeps 8 of them going at once, W
//    read from shared memory where it fits (the warp route loads it at the
//    start, the block route into U's place once U is done), else from
//    global memory.
//  - larger: [A | RHS] in shared memory (a block a region, warp 0's pivot
//    search, rows swapped), or, where it does not fit the 227 KB a block may
//    have, in a device workspace of B n (n + m) doubles that the wrapper
//    allocates (the synthetic n = 180 batch), with the same arithmetic.
//
// The dynamic shared-memory limit is raised once per process and route.
// A zero pivot divides by zero and leaves inf/NaN in the output, as the LU
// would; nothing flags or hides it.
//
// Bound: at the main bucket (3,969 regions, n 20, m 12, q 20) the bytes,
// 40.6 MB in and out, 0.012 ms at 3.35 TB/s; at the 3d bucket (1,374, 81, 32,
// 80) 200 MB and 1.9 GFLOP, 0.06 ms. An elimination step is a serial chain
// (the search, a shuffle, a division, the barrier, the dependent update),
// so the time follows the n steps and the instructions an entry issues
// (PERF.md; applications/benchmarking/region_lookup_check.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Dynamic shared memory a block may take: sm_90's opt-in limit of 232,448
// bytes, less 1 KB for the static pivot index and alignment.
constexpr int kSmemMax = 231424;
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// v / d. A zero v takes the division's slow path, so it is v * d there: the
// same signed zero for a finite nonzero d.
__device__ __forceinline__ double quotient(double v, double d) {
  return v == 0.0 && fabs(d) > 0.0 && fabs(d) < INFINITY ? __dmul_rn(v, d) : v / d;
}

// |v|'s bits + 1 (|v|'s bits order as |v| does, NaN above inf); 0: no row.
__device__ __forceinline__ unsigned long long pivot_key(double v) {
  return (unsigned long long)(__double_as_longlong(v) & 0x7fffffffffffffffLL) + 1ull;
}

// The least position among the lanes' best keys, for every lane.
__device__ __forceinline__ int best_position(unsigned long long best, unsigned bl) {
  const unsigned hi = (unsigned)(best >> 32), lo = (unsigned)best;
  const unsigned mhi = __reduce_max_sync(kFull, hi);
  const unsigned mlo = __reduce_max_sync(kFull, hi == mhi ? lo : 0u);
  return (int)__reduce_min_sync(kFull, hi == mhi && lo == mlo ? bl : 0xffffffffu);
}

// -- n <= 96: the region's A in registers ------------------------------------------

// Doubles of shared memory a region takes ahead of its U and RHS: the pivot
// row and column stages (two buffers each) and the pivots (warp route);
// the same and the positions (ints; block route).
__host__ __device__ constexpr int warp_head(int kC, int kR) { return 2 * kC + 3 * kR; }
__host__ __device__ constexpr int tile_head(int kC, int kR) { return 2 * kC + 3 * kR + (kR + 1) / 2; }

// The search rows of a lane (lane + 32 r, r < NS): their logical positions
// (-1: padding) and their entries of the current column.
template <int NS>
struct SearchRows {
  int lp[NS];
  double col[NS];
};

// Step k's pivot, found by every warp on its own from its search rows: the
// least logical position among the rows of largest |M_rk| at positions >=
// k (NaN the largest). Returns its row `sp`, the row `sk` at position k,
// the pivot's position `pl` and value; swaps the search rows' positions.
template <int NS>
__device__ __forceinline__ double pivot_step(SearchRows<NS>& sr, int k, int lane, int& sp, int& sk, int& pl) {
  unsigned long long best = 0;
  unsigned bl = kFull;
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    if (sr.lp[r] >= k) {
      const unsigned long long key = pivot_key(sr.col[r]);
      if (key > best || (key == best && (unsigned)sr.lp[r] < bl)) {
        best = key;
        bl = (unsigned)sr.lp[r];
      }
    }
  }
  pl = best_position(best, bl);
  // The rows at positions pl and k: each is one search row of one lane.
  int mp = 0, mk = 0;
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    mp = sr.lp[r] == pl ? lane + 32 * r : mp;
    mk = sr.lp[r] == k ? lane + 32 * r : mk;
  }
  sp = (int)__reduce_max_sync(kFull, (unsigned)mp);
  sk = (int)__reduce_max_sync(kFull, (unsigned)mk);
  double pc = 0.0;
#pragma unroll
  for (int r = 0; r < NS; ++r) pc = (sp >> 5) == r ? sr.col[r] : pc;
  const double piv = __shfl_sync(kFull, pc, sp & 31);
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    const int row = lane + 32 * r;
    sr.lp[r] = row == sp ? k : row == sk ? pl : sr.lp[r];
  }
  return piv;
}

// OUT = W X for one region: W row-major (q x n) in shared memory or, with
// kGlobalW, in global memory; X's row j at Xs[j * ldx + c]. Each thread sums
// up to kChains outputs at once, j ascending from 0.0 for every one.
constexpr int kChains = 8;

template <int kT, bool kGlobalW>
__device__ __forceinline__ void contract(const double* Wm, const double* Xs, int ldx, double* __restrict__ O,
                                         int t, int n, int m, int q) {
  for (int e0 = t; e0 < q * m; e0 += kT * kChains) {
    int wr[kChains], xc[kChains];
    double acc[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      const int e = min(e0 + kT * u, q * m - 1);
      wr[u] = e / m * n;
      xc[u] = e - e / m * m;
      acc[u] = 0.0;
    }
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        const double wv = kGlobalW ? __ldg(Wm + wr[u] + j) : Wm[wr[u] + j];
        acc[u] = __dadd_rn(acc[u], __dmul_rn(wv, Xs[j * ldx + xc[u]]));
      }
    }
#pragma unroll
    for (int u = 0; u < kChains; ++u)
      if (e0 + kT * u < q * m) O[e0 + kT * u] = acc[u];
  }
}

// n <= 32, n + m <= 64: a warp a region, up to 8 a block. Lane (ty, tx) of
// 4 x 8 holds [A | RHS]'s entries (ty + 4 a, tx + 8 b), a < NA, b < NB, in
// registers. After the elimination U and the transformed RHS go to shared
// memory in the order of the positions, and lane c takes RHS column c
// through the back substitution in registers. W is staged in shared memory
// while the elimination runs, or with global_w (a W too large for it) read
// from global memory by the contraction.
template <int NA, int NB>
__global__ void __launch_bounds__(kThreads, NA * NB <= 8 ? 4 : (NA * NB <= 24 ? 2 : 1))
    region_solve_warp(const double* __restrict__ a, const double* __restrict__ rhs,
                      const double* __restrict__ w, double* __restrict__ out, int batch, int n, int m,
                      int q, bool global_w) {
  constexpr int TY = 4, TX = 8;
  constexpr int kR = TY * NA;  // rows held (>= n)
  constexpr int kC = TX * NB;  // columns held (>= n + m)
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const int tx = lane % TX, ty = lane / TX;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + slot;
  if (b >= batch) return;  // a warp syncs alone: a warp without a region leaves

  const int ldu = n | 1;
  double* S = smem + (size_t)slot * (warp_head(kC, kR) + (size_t)n * (ldu + m) + (global_w ? 0 : (size_t)q * n));  // [2][kC]
  double* Cs = S + 2 * kC;     // [2][kR]: a column
  double* dg = Cs + 2 * kR;    // [kR]: the pivots
  double* Us = dg + kR;        // [n][ldu]: U by positions
  double* Ys = Us + n * ldu;   // [n][m]: the RHS by positions, then X
  double* Ws = Ys + n * m;     // [q][n]: W, loaded while the elimination runs
  const double* A = a + b * n * n;
  const double* R = rhs + b * n * m;
  const double* W = w + b * q * n;
  if (!global_w)
    for (int e = lane; e < q * n; e += 32) Ws[e] = W[e];

  double v[NA][NB];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = ty + TY * i;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = tx + TX * j;
      v[i][j] = r >= n ? 0.0 : c < n ? A[r * n + c] : c < n + m ? R[r * m + (c - n)] : 0.0;
    }
  }
  // Row equilibration: the max over the row's 8 lanes, then a division.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (tx + TX * j < n) s = fmax(s, fabs(v[i][j]));
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) s = fmax(s, __shfl_xor_sync(kFull, s, off));
    if (s == 0.0) s = 1.0;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (TX * j < n + m) v[i][j] = quotient(v[i][j], s);
  }

  int lpr[NA];  // logical positions of the own rows (-1: padding)
#pragma unroll
  for (int i = 0; i < NA; ++i) lpr[i] = ty + TY * i < n ? ty + TY * i : -1;
  SearchRows<1> sr;
  sr.lp[0] = lane < n ? lane : -1;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) Cs[kR + ty + TY * i] = v[i][0];
  }
  __syncwarp();
  sr.col[0] = lane < kR ? Cs[kR + lane] : 0.0;

  // Elimination, applied to [A | RHS]: one __syncwarp a step, the pivot row
  // and column k + 1 staged before the update in double-buffered stages.
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    if (TX * kk >= n) break;
#pragma unroll 1
    for (int kx = 0; kx < TX; ++kx) {
      const int k = TX * kk + kx;
      if (k >= n) break;
      const int buf = k & 1;
      int sp, sk, pl;
      const double piv = pivot_step(sr, k, lane, sp, sk, pl);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int row = ty + TY * i;
        lpr[i] = row == sp ? k : row == sk ? pl : lpr[i];
      }
      if (lane == 0) dg[k] = piv;
      const double fs = sr.lp[0] > k ? quotient(sr.col[0], piv) : 0.0;
      double f[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) f[i] = __shfl_sync(kFull, fs, ty + TY * i);
      if (ty == sp % TY) {
        const int ia = sp / TY;
#pragma unroll
        for (int i = 0; i < NA; ++i)
          if (i == ia) {
#pragma unroll
            for (int j = kk; j < NB; ++j) S[buf * kC + tx + TX * j] = v[i][j];
          }
      }
      if (k + 1 < n && tx == (kx + 1) % TX) {
#pragma unroll
        for (int i = 0; i < NA; ++i)
          Cs[buf * kR + ty + TY * i] = kx + 1 < TX ? v[i][kk] : v[i][kk + 1 < NB ? kk + 1 : kk];
      }
      __syncwarp();
      double s[NB];
#pragma unroll
      for (int j = kk; j < NB; ++j) s[j] = S[buf * kC + tx + TX * j];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (lpr[i] > k) {
#pragma unroll
          for (int j = kk; j < NB; ++j)
            if (TX * j < n + m) v[i][j] = __dsub_rn(v[i][j], __dmul_rn(f[i], s[j]));
        }
      if (k + 1 < n) {
        const double c = Cs[buf * kR + lane];
        sr.col[0] = sr.lp[0] > k ? __dsub_rn(c, __dmul_rn(fs, S[buf * kC + k + 1])) : c;
      }
    }
  }

  // U and the RHS to shared memory by positions.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    if (lpr[i] >= 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int c = tx + TX * j;
        if (c < n)
          Us[lpr[i] * ldu + c] = v[i][j];
        else if (c < n + m)
          Ys[lpr[i] * m + (c - n)] = v[i][j];
      }
    }
  }
  __syncwarp();

  // Back substitution, lane c on RHS column c (32 at a time): x_k = y_k /
  // u_kk, then y_i - u_ik x_k for i < k, k from the last, in registers.
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int c = c0 + lane;
    double y[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) y[i] = c < m && i < n ? Ys[i * m + c] : 0.0;
#pragma unroll
    for (int k = kR - 1; k >= 0; --k) {
      if (k < n) {
        const double x = quotient(y[k], dg[k]);
        y[k] = x;
#pragma unroll
        for (int i = 0; i < k; ++i) y[i] = __dsub_rn(y[i], __dmul_rn(Us[i * ldu + k], x));
      }
    }
    if (c < m) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if (i < n) Ys[i * m + c] = y[i];
    }
  }
  __syncwarp();
  if (global_w)
    contract<32, true>(W, Ys, m, out + b * q * m, lane, n, m, q);
  else
    contract<32, false>(Ws, Ys, m, out + b * q * m, lane, n, m, q);
}

// n <= 96, m <= 128: a block of 16 x 16 threads a region, thread (ty, tx)
// holding A's entries (ty + 16 a, tx + 16 b), a, b < NA, in registers and
// the RHS in shared memory. The back substitution: 8 threads a RHS column
// (32 columns at a time), thread g of a column holding rows g + 8 r of it
// in registers, x_k passed by a shuffle within the 8.
template <int NA>
__global__ void __launch_bounds__(kThreads, NA <= 2 ? 4 : (NA <= 3 ? 3 : 2))
    region_solve_block16(const double* __restrict__ a, const double* __restrict__ rhs,
                         const double* __restrict__ w, double* __restrict__ out, int n, int m, int q) {
  constexpr int TY = 16, TX = 16, NB = NA;
  constexpr int kR = TY * NA;  // rows held (>= n)
  constexpr int kC = TX * NB;  // columns of A held (>= n)
  constexpr int NS = (kR + 31) / 32;
  constexpr int kG = 8, kRows = kR / kG;  // the back substitution's threads a column, rows a thread
  extern __shared__ double smem[];
  const int t = threadIdx.x;
  const int tx = t % TX, ty = t / TX;
  const int lane = t & 31;
  const int64_t b = blockIdx.x;

  const int ldr = m | 1, ldu = n | 1;
  double* S = smem;        // [2][kC]: the pivot row
  double* Cs = S + 2 * kC;  // [2][kR]: a column
  double* dg = Cs + 2 * kR;  // [kR]: the pivots
  int* pos = (int*)(dg + kR);  // [kR]: the row at each position
  double* Rs = dg + kR + (kR + 1) / 2;  // [n][ldr]: the RHS by rows, then X by positions
  double* Us = Rs + n * ldr;            // [n][ldu]: U by positions
  const double* A = a + b * n * n;
  const double* R = rhs + b * n * m;

  double v[NA][NB];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = ty + TY * i;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = tx + TX * j;
      v[i][j] = r < n && c < n ? A[r * n + c] : 0.0;
    }
  }
  // Row equilibration: the max over the row's 16 threads, then a division
  // of the row's A entries in registers and of its RHS into shared memory.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = ty + TY * i;
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < NB; ++j) s = fmax(s, fabs(v[i][j]));
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) s = fmax(s, __shfl_xor_sync(kFull, s, off));
    if (s == 0.0) s = 1.0;
#pragma unroll
    for (int j = 0; j < NB; ++j) v[i][j] = quotient(v[i][j], s);
    if (r < n)
      for (int c = tx; c < m; c += TX) Rs[r * ldr + c] = quotient(R[r * m + c], s);
  }

  int lpr[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) lpr[i] = ty + TY * i < n ? ty + TY * i : -1;
  SearchRows<NS> sr;
#pragma unroll
  for (int r = 0; r < NS; ++r) sr.lp[r] = lane + 32 * r < n ? lane + 32 * r : -1;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) Cs[kR + ty + TY * i] = v[i][0];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NS; ++r) sr.col[r] = lane + 32 * r < kR ? Cs[kR + lane + 32 * r] : 0.0;

  // Elimination: one barrier a step.
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    if (TX * kk >= n) break;
#pragma unroll 1
    for (int kx = 0; kx < TX; ++kx) {
      const int k = TX * kk + kx;
      if (k >= n) break;
      const int buf = k & 1;
      int sp, sk, pl;
      const double piv = pivot_step(sr, k, lane, sp, sk, pl);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int row = ty + TY * i;
        lpr[i] = row == sp ? k : row == sk ? pl : lpr[i];
      }
      if (t == 0) dg[k] = piv;
      // Multipliers of the live search rows, then of the own rows (row
      // ty + 16 i sits on lane (ty + 16 i) & 31 at index i / 2).
      double fs[NS];
#pragma unroll
      for (int r = 0; r < NS; ++r) fs[r] = sr.lp[r] > k ? quotient(sr.col[r], piv) : 0.0;
      double f[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) f[i] = __shfl_sync(kFull, fs[i / 2], (ty + TY * i) & 31);
      // The pivot row's A part and column k + 1 before the update (the
      // pivot row's RHS is read in place: it is not live).
      if (ty == sp % TY) {
        const int ia = sp / TY;
#pragma unroll
        for (int i = 0; i < NA; ++i)
          if (i == ia) {
#pragma unroll
            for (int j = kk; j < NB; ++j) S[buf * kC + tx + TX * j] = v[i][j];
          }
      }
      if (k + 1 < n && tx == (kx + 1) % TX) {
#pragma unroll
        for (int i = 0; i < NA; ++i)
          Cs[buf * kR + ty + TY * i] = kx + 1 < TX ? v[i][kk] : v[i][kk + 1 < NB ? kk + 1 : kk];
      }
      __syncthreads();
      double s[NB];
#pragma unroll
      for (int j = kk; j < NB; ++j) s[j] = S[buf * kC + tx + TX * j];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (lpr[i] > k) {
#pragma unroll
          for (int j = kk; j < NB; ++j) v[i][j] = __dsub_rn(v[i][j], __dmul_rn(f[i], s[j]));
        }
      // The RHS of the live rows, a column block at a time: the rows'
      // entries loaded together, then updated and stored.
      const double* Rp = Rs + sp * ldr;
      for (int c = tx; c < m; c += TX) {
        const double p = Rp[c];
        double y[NA];
#pragma unroll
        for (int i = 0; i < NA; ++i) y[i] = lpr[i] > k ? Rs[(ty + TY * i) * ldr + c] : 0.0;
#pragma unroll
        for (int i = 0; i < NA; ++i)
          if (lpr[i] > k) Rs[(ty + TY * i) * ldr + c] = __dsub_rn(y[i], __dmul_rn(f[i], p));
      }
      if (k + 1 < n) {
        const double s1 = S[buf * kC + k + 1];
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          if (lane + 32 * r < kR) {
            const double c = Cs[buf * kR + lane + 32 * r];
            sr.col[r] = sr.lp[r] > k ? __dsub_rn(c, __dmul_rn(fs[r], s1)) : c;
          }
        }
      }
    }
  }

  // U to shared memory by positions; the row at each position.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    if (lpr[i] >= 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (tx + TX * j < n) Us[lpr[i] * ldu + tx + TX * j] = v[i][j];
    }
  }
  if (t < 32) {
#pragma unroll
    for (int r = 0; r < NS; ++r)
      if (sr.lp[r] >= 0) pos[sr.lp[r]] = lane + 32 * r;
  }
  __syncthreads();

  // Back substitution, 32 RHS columns at a time: thread (column c, g) holds
  // the rows at positions g + 8 r; x_k comes from thread (c, k % 8). Step
  // k = 8 kk + kx is unrolled over kk: the thread's rows r < kk lie above
  // k, row kk is above it for g < kx and is x_k's own for g = kx, and the
  // rows below kk are done.
  const int g = t % kG;
  for (int c0 = 0; c0 < m; c0 += kThreads / kG) {
    const int c = c0 + t / kG;
    double y[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = g + kG * r;
      y[r] = c < m && i < n ? Rs[pos[i] * ldr + c] : 0.0;
    }
    __syncthreads();  // every column read before X overwrites the RHS
#pragma unroll
    for (int kk = kRows - 1; kk >= 0; --kk) {
      if (kG * kk >= n) continue;
#pragma unroll 1
      for (int kx = kG - 1; kx >= 0; --kx) {
        const int k = kG * kk + kx;
        if (k >= n) continue;
        const double x = __shfl_sync(kFull, quotient(y[kk], dg[k]), (lane & ~(kG - 1)) | kx);
        const double* Uk = Us + k;
#pragma unroll
        for (int r = 0; r < kk; ++r) y[r] = __dsub_rn(y[r], __dmul_rn(Uk[(g + kG * r) * ldu], x));
        if (g < kx)
          y[kk] = __dsub_rn(y[kk], __dmul_rn(Uk[(g + kG * kk) * ldu], x));
        else if (g == kx)
          y[kk] = x;
      }
    }
    if (c < m) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (g + kG * r < n) Rs[(g + kG * r) * ldr + c] = y[r];
    }
  }
  __syncthreads();
  // W into U's place where it fits, else read from global memory.
  const double* W = w + b * q * n;
  double* O = out + b * q * m;
  if (q <= ldu) {
    for (int e = t; e < q * n; e += kThreads) Us[e] = W[e];
    __syncthreads();
    contract<kThreads, false>(Us, Rs, ldr, O, t, n, m, q);
  } else {
    contract<kThreads, true>(W, Rs, ldr, O, t, n, m, q);
  }
}

// -- larger: [A | RHS] in shared memory or a workspace ------------------------------

__global__ void region_solve_block(const double* __restrict__ a, const double* __restrict__ rhs,
                                   const double* __restrict__ w, double* __restrict__ out,
                                   double* __restrict__ work, int n, int m, int q) {
  extern __shared__ double smem[];
  __shared__ int s_p;
  const int ld = n + m;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  double* lcol = smem;  // n multipliers of the current column
  double* M = work ? work + b * (int64_t)n * ld : smem + n;
  const double* A = a + b * (int64_t)n * n;
  const double* R = rhs + b * (int64_t)n * m;
  const double* W = w + b * (int64_t)q * n;
  double* O = out + b * (int64_t)q * m;

  for (int e = tid; e < n * ld; e += nt) {
    const int i = e / ld;
    const int j = e - i * ld;
    M[e] = j < n ? A[i * n + j] : R[i * m + (j - n)];
  }
  __syncthreads();

  // Row equilibration.
  for (int i = warp; i < n; i += nwarps) {
    double s = 0.0;
    for (int j = lane; j < n; j += 32) s = fmax(s, fabs(M[i * ld + j]));
    for (int off = 16; off > 0; off >>= 1) s = fmax(s, __shfl_xor_sync(kFull, s, off));
    if (s == 0.0) s = 1.0;
    for (int j = lane; j < ld; j += 32) M[i * ld + j] = quotient(M[i * ld + j], s);
  }
  __syncthreads();

  // LU with partial pivoting, applied to [A | RHS].
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      unsigned long long best = 0;
      unsigned bi = kFull;
      for (int i = k + lane; i < n; i += 32) {
        const unsigned long long key = pivot_key(M[i * ld + k]);
        if (key > best) {
          best = key;
          bi = (unsigned)i;
        }
      }
      const int p = best_position(best, bi);
      if (lane == 0) s_p = p;
    }
    __syncthreads();
    const int p = s_p;
    if (p != k) {
      // Columns left of k hold no live values in rows k and p.
      for (int j = k + tid; j < ld; j += nt) {
        const double t = M[k * ld + j];
        M[k * ld + j] = M[p * ld + j];
        M[p * ld + j] = t;
      }
      __syncthreads();
    }
    const double piv = M[k * ld + k];
    for (int i = k + 1 + tid; i < n; i += nt) lcol[i] = quotient(M[i * ld + k], piv);
    __syncthreads();
    const int rows = n - k - 1;
    const int cols = ld - k - 1;
    for (int e = tid; e < rows * cols; e += nt) {
      const int r = e / cols;
      const int i = k + 1 + r;
      const int j = k + 1 + (e - r * cols);
      M[i * ld + j] = __dsub_rn(M[i * ld + j], __dmul_rn(lcol[i], M[k * ld + j]));
    }
    __syncthreads();
  }

  // Back substitution; X overwrites the RHS columns.
  for (int k = n - 1; k >= 0; --k) {
    const double ukk = M[k * ld + k];
    for (int c = tid; c < m; c += nt) M[k * ld + n + c] = quotient(M[k * ld + n + c], ukk);
    __syncthreads();
    for (int e = tid; e < k * m; e += nt) {
      const int i = e / m;
      const int c = e - i * m;
      M[i * ld + n + c] = __dsub_rn(M[i * ld + n + c], __dmul_rn(M[i * ld + k], M[k * ld + n + c]));
    }
    __syncthreads();
  }

  // OUT = W X.
  for (int e = tid; e < q * m; e += nt) {
    const int r = e / m;
    const int c = e - r * m;
    double acc = 0.0;
    for (int j = 0; j < n; ++j) acc = __dadd_rn(acc, __dmul_rn(W[r * n + j], M[j * ld + n + c]));
    O[e] = acc;
  }
}

// Raise the kernel's dynamic shared-memory limit to `bytes` once (the
// largest asked for so far).
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int& set, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem || (int)bytes <= set) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set = (int)bytes;
  return err;
}

template <int NA, int NB>
int launch_warp(const double* a, const double* rhs, const double* w, double* out, int batch, int n,
                int m, int q, cudaStream_t s) {
  static int set = 0;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = sms < 1 ? 1 : sms;
  }
  // W in shared memory where a region with it fits, else read from global
  // memory. Regions a block: a small batch spreads over every SM before
  // warps stack on one.
  const size_t rest = sizeof(double) * (warp_head(8 * NB, 4 * NA) + (size_t)n * ((n | 1) + m));
  const bool global_w = rest + sizeof(double) * (size_t)q * n > (size_t)kSmemMax;
  const size_t per = rest + (global_w ? 0 : sizeof(double) * (size_t)q * n);
  int regions = (batch + sms - 1) / sms;
  regions = regions < 1 ? 1 : (regions > kThreads / 32 ? kThreads / 32 : regions);
  regions = (size_t)regions * per > (size_t)kSmemMax ? (int)(kSmemMax / per) : regions;
  const size_t smem = regions * per;
  const cudaError_t err = smem_limit(region_solve_warp<NA, NB>, set, smem);
  if (err != cudaSuccess) return (int)err;
  region_solve_warp<NA, NB><<<(batch + regions - 1) / regions, regions * 32, smem, s>>>(a, rhs, w, out, batch, n, m, q,
                                                                                       global_w);
  return (int)cudaGetLastError();
}

// The warp route at NA = ceil(n / 4) rows a lane and n + m rounded up to 16,
// 32 or 64 columns.
template <int NA>
int launch_warp_cols(const double* a, const double* rhs, const double* w, double* out, int batch, int n,
                     int m, int q, cudaStream_t s) {
  if constexpr (NA <= 4) {
    if (n + m <= 16) return launch_warp<NA, 2>(a, rhs, w, out, batch, n, m, q, s);
  }
  if (n + m <= 32) return launch_warp<NA, 4>(a, rhs, w, out, batch, n, m, q, s);
  return launch_warp<NA, 8>(a, rhs, w, out, batch, n, m, q, s);
}

template <int NA>
int launch_block16(const double* a, const double* rhs, const double* w, double* out, int batch, int n,
                   int m, int q, cudaStream_t s) {
  static int set = 0;
  const size_t smem = sizeof(double) * (tile_head(16 * NA, 16 * NA) + (size_t)n * ((m | 1) + (n | 1)));
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = smem_limit(region_solve_block16<NA>, set, smem);
  if (err != cudaSuccess) return (int)err;
  region_solve_block16<NA><<<batch, kThreads, smem, s>>>(a, rhs, w, out, n, m, q);
  return (int)cudaGetLastError();
}

// The route of a bucket (ppt_region_solve_route_f64 gives it to the
// wrapper, which allocates the workspace of route 3): 0 a warp a region
// (n <= 32, n + m <= 64) with [A | RHS] in registers, 1 a block of 16 x 16
// threads a region (n <= 96, m <= 128) with A in registers and the RHS in
// shared memory; 2 a block a region with [A | RHS] in shared memory
// (8 n (n + m + 1) bytes at most kSmemMax), 3 the same on a device
// workspace of (batch, n, n + m) doubles.
int route(int n, int m) {
  if (n <= 32 && n + m <= 64) return 0;
  if (n <= 96 && m <= 128) return 1;
  return 8 * (size_t)n * (n + m + 1) <= (size_t)kSmemMax ? 2 : 3;
}

}  // namespace

// The route of regions of size n with m right-hand sides (route above).
extern "C" int ppt_region_solve_route_f64(int n, int m) { return route(n, m); }

// work: the workspace of route 3 (ignored by the others, which need none).
extern "C" int ppt_region_solve_f64(const double* a, const double* rhs,
                                    const double* w, double* out, double* work,
                                    int batch, int n, int m, int q,
                                    void* stream) {
  if (batch < 0 || n < 0 || m < 0 || q < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || m == 0 || q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (route(n, m)) {
    case 0:
      switch ((n + 3) / 4) {
        case 0:
        case 1: return launch_warp_cols<1>(a, rhs, w, out, batch, n, m, q, s);
        case 2: return launch_warp_cols<2>(a, rhs, w, out, batch, n, m, q, s);
        case 3: return launch_warp_cols<3>(a, rhs, w, out, batch, n, m, q, s);
        case 4: return launch_warp_cols<4>(a, rhs, w, out, batch, n, m, q, s);
        case 5: return launch_warp_cols<5>(a, rhs, w, out, batch, n, m, q, s);
        case 6: return launch_warp_cols<6>(a, rhs, w, out, batch, n, m, q, s);
        case 7: return launch_warp_cols<7>(a, rhs, w, out, batch, n, m, q, s);
        default: return launch_warp_cols<8>(a, rhs, w, out, batch, n, m, q, s);
      }
    case 1:
      switch ((n + 15) / 16) {
        case 0:
        case 1: return launch_block16<1>(a, rhs, w, out, batch, n, m, q, s);
        case 2: return launch_block16<2>(a, rhs, w, out, batch, n, m, q, s);
        case 3: return launch_block16<3>(a, rhs, w, out, batch, n, m, q, s);
        case 4: return launch_block16<4>(a, rhs, w, out, batch, n, m, q, s);
        case 5: return launch_block16<5>(a, rhs, w, out, batch, n, m, q, s);
        default: return launch_block16<6>(a, rhs, w, out, batch, n, m, q, s);
      }
    default: {
      const bool in_smem = route(n, m) == 2;
      if (!in_smem && !work) return (int)cudaErrorInvalidValue;
      static int set = 0;
      const size_t smem = sizeof(double) * ((size_t)n + (in_smem ? (size_t)n * (n + m) : 0));
      const cudaError_t err = smem_limit(region_solve_block, set, smem);
      if (err != cudaSuccess) return (int)err;
      const int threads = n <= 16 ? 128 : 256;
      region_solve_block<<<batch, threads, smem, s>>>(a, rhs, w, out, in_smem ? nullptr : work, n, m, q);
      return (int)cudaGetLastError();
    }
  }
}
