// K18: the Jacobi-preconditioned Krylov solves of solve_sparse.
//
// Replaces porepy_tpu/numerics/linalg/krylov.py:42-61 (_krylov), the
// jax.scipy.sparse.linalg BiCGStab and GMRES(restart 30, "batched") that XLA
// fused around the BCOO matvec, with the Jacobi preconditioner
// M x = dinv * x, all f64.
//
// K18a, one BiCGStab iteration of jax 0.9's _bicgstab_solve, the vector and
// scalar work between the matvecs, which stay with K1 (ell_spmv.cu):
//
//   bicgstab_p     p <- r + beta (p - omega q),  phat = dinv p
//   krylov_dots    block partials of one or two dot products
//   bicgstab_s     s <- r - alpha q,  shat = dinv s,  partials of <s, s>
//   bicgstab_xr    x <- x + alpha phat + omega shat (x + alpha phat on the
//                  early exit), r <- s - omega t (s), partials of <r, r>
//                  and <rhat, r>
//   bicgstab_scalars  one block: finishes the partials and runs the scalar
//                  recurrence (alpha, omega, beta, the early exit, the
//                  breakdown and the continue flag) on the device.
//
// K18b, one restart of the batched GMRES (_gmres_batched) as ONE persistent
// cooperative kernel, gmres_cycle: the matvecs run inside it, on the
// matrix in CSR form (int32 row pointers and columns, f64 values, each row
// summed in column order, as K1 sums it). One launch per restart:
//
//   30 Arnoldi steps, each: w = dinv (A v_k); the partials of V[:k+1] w and
//        of <w, w>; | grid sync | h = V^T w finished in every block, w <- w -
//        V h, partials of <w, w>; | grid sync | |w_0| and |w| finished in
//        every block, V[k + 1] = w / |w| (0 below the threshold eps |w_0|
//        of _safe_normalize), Hessenberg row k and the breakdown flag;
//        | grid sync |
//   block 0: the 30 x 30 normal equations H H^T y = beta H e_0 by Cholesky
//        and two triangular solves (_lstsq with assume_a="pos") in shared
//        memory, the solves by one warp, column by column, while the other
//        blocks wait; | grid sync |
//   x <- x + V[:restart]^T y; | grid sync |
//   w = dinv (b - A x), partials of <w, w>; | grid sync | V[0] = w / |w|,
//        the residual norm, the continue flag, H = eye, flags cleared.
//
// With arnoldi = 0 it runs the last two lines alone: the start of a solve.
//
// The iteration's _iterative_classical_gram_schmidt with max_iterations=2
// runs one projection: its loop condition k < max_iterations - 1 fails
// after the first pass, so there is no second ("twice is enough") pass
// here either. After a breakdown the iteration stops the restart's Arnoldi
// loop; here every block carries the same breakdown flag and skips the
// later steps (still writing the zero basis vector V holds there), so the
// host reads one flag per restart.
//
// Grid: blocks of 128 threads, as many as can be co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, with the
// kernel's static shared memory), at most one per 128-row tile; blocks
// stride over the tiles, so each block owns the same rows in every phase.
// A cooperative launch (cudaLaunchCooperativeKernel) is what makes
// this_grid().sync() legal: the wrapper refuses to launch otherwise.
//
// Reductions: each tile's partial sum in the fixed block_sum tree, then
// every block that needs a sum finishes the tile partials in the same
// fixed order (row_sum): no atomics, a run repeats bit for bit. Every
// operation is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn: no
// multiply-add is contracted), so the plain passes of kernels/reference.py,
// which round the same operations in the same order, give the same bits.
// Arrays written inside the kernel are read through plain pointers (no
// __restrict__ on them): the read-only cache is not coherent across the
// grid syncs.
//
// Bound: bytes, a few us: at biot 1/64 (n = 12,288, 317,026 nonzeros) a
// restart reads the matrix and writes 31 basis vectors, ~7.5 MB. Latency
// is what is left: 94 grid syncs, four block-wide reductions a step, the
// dependent gathers of each row and the Cholesky of block 0 (the matvecs
// keep four gathers in flight; the last five levels of each reduction and
// the triangular solves run in warps). Before: 94 launches and 31 K1
// launches a restart, ~45-54 us of host dispatch each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Threads per block of every kernel here; the partial sums of a vector of
// length n are ceil(n / kBlock) per dot (ops.KRYLOV_BLOCK in Python).
constexpr int kBlock = 128;
constexpr int kMaxRestart = 30;

// BiCGStab scalar slots (ops.BICG_* in Python).
enum {
  kRho = 0, kAlpha = 1, kOmega = 2, kRhoNew = 3, kBeta = 4, kAtol2 = 5,
  kAlphaNew = 6, kOmegaNew = 7, kExit = 8, kRr = 9,
};
enum { kStageInit = 0, kStageAlpha = 1, kStageOmega = 2, kStageNext = 3 };
// GMRES scalar slots (ops.GMRES_* in Python).
enum { kAtol = 0, kResNorm = 1 };

// Sum of v over the block: a fixed tree, the same order on every run.
__device__ double block_sum(double v) {
  __shared__ double sh[kBlock];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  double out = sh[0];
  __syncthreads();
  return out;
}

// The finish of one reduction: the nb partials of a row, in a fixed order.
__device__ double row_sum(const double* __restrict__ row, int nb) {
  double acc = 0.0;
  for (int b = threadIdx.x; b < nb; b += kBlock) acc += row[b];
  return block_sum(acc);
}

// -- K18a -------------------------------------------------------------------

__global__ void bicgstab_p_kernel(const double* __restrict__ r,
                                  const double* __restrict__ q,
                                  const double* __restrict__ dinv,
                                  const double* __restrict__ st,
                                  double* __restrict__ p,
                                  double* __restrict__ phat, int n) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  double beta = st[kBeta], omega = st[kOmega];
  double pi = __dadd_rn(r[i], __dmul_rn(beta, __dsub_rn(p[i], __dmul_rn(omega, q[i]))));
  p[i] = pi;
  phat[i] = __dmul_rn(dinv[i], pi);
}

__global__ void krylov_dots_kernel(const double* __restrict__ a,
                                   const double* __restrict__ b,
                                   const double* __restrict__ c,
                                   const double* __restrict__ d,
                                   double* __restrict__ partials, int n,
                                   int nb, int ndots) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  double ab = 0.0, cd = 0.0;
  if (i < n) {
    ab = a[i] * b[i];
    if (ndots > 1) cd = c[i] * d[i];
  }
  ab = block_sum(ab);
  if (ndots > 1) cd = block_sum(cd);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = ab;
    if (ndots > 1) partials[nb + blockIdx.x] = cd;
  }
}

__global__ void bicgstab_s_kernel(const double* __restrict__ r,
                                  const double* __restrict__ q,
                                  const double* __restrict__ dinv,
                                  const double* __restrict__ st,
                                  double* __restrict__ s,
                                  double* __restrict__ shat,
                                  double* __restrict__ partials, int n) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  double ss = 0.0;
  if (i < n) {
    double si = __dsub_rn(r[i], __dmul_rn(st[kAlphaNew], q[i]));
    s[i] = si;
    shat[i] = __dmul_rn(dinv[i], si);
    ss = si * si;
  }
  ss = block_sum(ss);
  if (threadIdx.x == 0) partials[blockIdx.x] = ss;
}

__global__ void bicgstab_xr_kernel(double* __restrict__ x, double* __restrict__ r,
                                   const double* __restrict__ phat,
                                   const double* __restrict__ shat,
                                   const double* __restrict__ s,
                                   const double* __restrict__ t,
                                   const double* __restrict__ rhat,
                                   const double* __restrict__ st,
                                   double* __restrict__ partials, int n, int nb) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  double rr = 0.0, hr = 0.0;
  if (i < n) {
    double alpha = st[kAlphaNew], omega = st[kOmegaNew];
    double ap = __dmul_rn(alpha, phat[i]);
    double ri;
    if (st[kExit] != 0.0) {
      x[i] = __dadd_rn(x[i], ap);
      ri = s[i];
    } else {
      x[i] = __dadd_rn(x[i], __dadd_rn(ap, __dmul_rn(omega, shat[i])));
      ri = __dsub_rn(s[i], __dmul_rn(omega, t[i]));
    }
    r[i] = ri;
    rr = ri * ri;
    hr = rhat[i] * ri;
  }
  rr = block_sum(rr);
  hr = block_sum(hr);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = rr;
    partials[nb + blockIdx.x] = hr;
  }
}

__global__ void bicgstab_scalars_kernel(const double* __restrict__ partials,
                                        int nb, double* __restrict__ st,
                                        int* __restrict__ cont, int stage) {
  const bool lead = threadIdx.x == 0;
  if (stage == kStageInit) {
    // r0 = b - A x0 and rhat = r0: rho_ of the first iteration is <r0, r0>.
    double rr = row_sum(partials, nb);
    if (lead) {
      st[kRhoNew] = rr;
      st[kRr] = rr;
      st[kBeta] = __ddiv_rn(__dmul_rn(__ddiv_rn(rr, st[kRho]), st[kAlpha]), st[kOmega]);
      cont[0] = rr > st[kAtol2];
    }
  } else if (stage == kStageAlpha) {
    double rq = row_sum(partials, nb);
    if (lead) st[kAlphaNew] = __ddiv_rn(st[kRhoNew], rq);
  } else if (stage == kStageOmega) {
    double ss = row_sum(partials, nb);
    double ts = row_sum(partials + nb, nb);
    double tt = row_sum(partials + 2 * nb, nb);
    if (lead) {
      st[kExit] = ss < st[kAtol2] ? 1.0 : 0.0;
      st[kOmegaNew] = __ddiv_rn(ts, tt);
    }
  } else {
    double rr = row_sum(partials, nb);
    double hr = row_sum(partials + nb, nb);
    if (lead) {
      double alpha = st[kAlphaNew], omega = st[kOmegaNew], rho = st[kRhoNew];
      bool breakdown = omega == 0.0 || alpha == 0.0 || rho == 0.0;
      cont[0] = (rr > st[kAtol2]) && !breakdown;
      st[kRr] = rr;
      st[kRho] = rho;
      st[kAlpha] = alpha;
      st[kOmega] = omega;
      st[kRhoNew] = hr;
      st[kBeta] = __ddiv_rn(__dmul_rn(__ddiv_rn(hr, rho), alpha), omega);
    }
  }
}

// -- K18b -------------------------------------------------------------------

constexpr int kRows = kMaxRestart + 2;  // rows summed at once: V[:k+1] w, <w, w>

// m rows of sh summed at once, each in block_sum's tree (the same pairs in
// the same order): row j's sum ends in sh[j][0].
__device__ void tree_rows(double (*sh)[kBlock], int m) {
  __syncthreads();
  for (int s = kBlock / 2; s > 16; s >>= 1) {
    for (int idx = threadIdx.x; idx < m * s; idx += kBlock) {
      int j = idx / s, t = idx - j * s;
      sh[j][t] = __dadd_rn(sh[j][t], sh[j][t + s]);
    }
    __syncthreads();
  }
  // s = 16 .. 1 inside one warp a row: lane t adds lane t + s, as above.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < m; j += kBlock / 32) {
    double v = sh[j][lane];
    for (int s = 16; s > 0; s >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, s));
    if (lane == 0) sh[j][0] = v;
  }
  __syncthreads();
}

// The sums of rows r0 .. r0 + m - 1 of partials (nb per row), each in
// row_sum's order, into out[0 .. m - 1] (shared), seen by the whole block.
__device__ void finish_rows(const double* partials, int r0, int m, int nb,
                            double (*sh)[kBlock], double* out) {
  for (int j = 0; j < m; ++j) {
    const double* row = partials + (int64_t)(r0 + j) * nb;
    double acc = 0.0;
    for (int b = threadIdx.x; b < nb; b += kBlock) acc = __dadd_rn(acc, row[b]);
    sh[j][threadIdx.x] = acc;
  }
  tree_rows(sh, m);
  if (threadIdx.x < m) out[threadIdx.x] = sh[threadIdx.x][0];
  __syncthreads();
}

// Row i of A x: the products rounded, added from 0.0 in column order.
__device__ double csr_row(const int* __restrict__ row_ptr,
                          const int* __restrict__ cols,
                          const double* __restrict__ vals, const double* x,
                          int i) {
  double acc = 0.0;
  int p = row_ptr[i];
  const int e = row_ptr[i + 1];
  // Four gathers in flight before their products are added, in order.
  for (; p + 4 <= e; p += 4) {
    const double x0 = x[cols[p]], x1 = x[cols[p + 1]], x2 = x[cols[p + 2]], x3 = x[cols[p + 3]];
    acc = __dadd_rn(acc, __dmul_rn(vals[p], x0));
    acc = __dadd_rn(acc, __dmul_rn(vals[p + 1], x1));
    acc = __dadd_rn(acc, __dmul_rn(vals[p + 2], x2));
    acc = __dadd_rn(acc, __dmul_rn(vals[p + 3], x3));
  }
  for (; p < e; ++p) acc = __dadd_rn(acc, __dmul_rn(vals[p], x[cols[p]]));
  return acc;
}

// Block 0's least squares: y from H H^T y = beta H e_0 (Cholesky in the
// lower triangle, column by column, then L u = z and L^T y = u, both by
// columns: once z[m] is final, rows below (above) it subtract their term,
// one lane a row). hs is block-shared scratch of at least R (R + 1) doubles.
__device__ void lstsq(const double* H, const double* st, double* y, int R, double* hs) {
  __shared__ double a[kMaxRestart][kMaxRestart + 1];
  __shared__ double z[kMaxRestart];
  const int ld = R + 1;
  for (int idx = threadIdx.x; idx < R * ld; idx += kBlock) hs[idx] = H[idx];
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * R; idx += kBlock) {
    int i = idx / R, j = idx % R;
    double acc = 0.0;
    for (int c = 0; c <= R; ++c) acc = __dadd_rn(acc, __dmul_rn(hs[i * ld + c], hs[j * ld + c]));
    a[i][j] = acc;
  }
  for (int i = threadIdx.x; i < R; i += kBlock) z[i] = __dmul_rn(hs[i * ld], st[kResNorm]);
  __syncthreads();
  for (int c = 0; c < R; ++c) {
    if (threadIdx.x == 0) a[c][c] = __dsqrt_rn(a[c][c]);
    __syncthreads();
    for (int i = c + 1 + threadIdx.x; i < R; i += kBlock) a[i][c] = __ddiv_rn(a[i][c], a[c][c]);
    __syncthreads();
    int m = R - c - 1;
    for (int idx = threadIdx.x; idx < m * m; idx += kBlock) {
      int i = c + 1 + idx / m, j = c + 1 + idx % m;
      if (j <= i) a[i][j] = __dsub_rn(a[i][j], __dmul_rn(a[i][c], a[j][c]));
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    // L u = z: u[m] = z[m] / a[m][m], then z[i] -= a[i][m] u[m] for i > m.
    for (int m = 0; m < R; ++m) {
      if (i == m) z[m] = __ddiv_rn(z[m], a[m][m]);
      __syncwarp();
      if (i > m && i < R) z[i] = __dsub_rn(z[i], __dmul_rn(a[i][m], z[m]));
      __syncwarp();
    }
    // L^T y = u: y[m] = u[m] / a[m][m], then u[i] -= a[m][i] y[m] for i < m.
    for (int m = R - 1; m >= 0; --m) {
      if (i == m) z[m] = __ddiv_rn(z[m], a[m][m]);
      __syncwarp();
      if (i < m) z[i] = __dsub_rn(z[i], __dmul_rn(a[m][i], z[m]));
      __syncwarp();
    }
    if (i < R) y[i] = z[i];
  }
  __syncthreads();
}

// One restart (arnoldi = 1) or the start of a solve (arnoldi = 0); see the
// head of the file. V is (restart + 1, n), H (restart, restart + 1),
// partials (restart + 3, nb): rows 0..k the projections of step k, k + 1
// the norm of w before the projection, k + 2 after it.
__global__ void __launch_bounds__(kBlock)
gmres_cycle_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                   const double* __restrict__ vals, const double* __restrict__ dinv,
                   const double* __restrict__ b, double* x, double* V, double* H,
                   double* y, double* w, double* partials, int* flags, double* st,
                   int* cont, int n, int nb, int restart, int arnoldi) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[kRows][kBlock];
  __shared__ double hs[kRows];
  const int tid = threadIdx.x;
  const bool lead = blockIdx.x == 0;
  const int ld = restart + 1;
  if (arnoldi) {
    bool done = flags[0] != 0;
    for (int k = 0; k < restart; ++k) {
      const double* vk = V + (int64_t)k * n;
      if (!done) {
        // w = dinv (A v_k); partials of <V[j], w> (j <= k) and of <w, w>.
        for (int t = blockIdx.x; t < nb; t += gridDim.x) {
          int i = t * kBlock + tid;
          double wi = 0.0;
          if (i < n) {
            wi = __dmul_rn(dinv[i], csr_row(row_ptr, cols, vals, vk, i));
            w[i] = wi;
          }
          for (int j = 0; j <= k; ++j) sh[j][tid] = i < n ? __dmul_rn(V[(int64_t)j * n + i], wi) : 0.0;
          sh[k + 1][tid] = i < n ? __dmul_rn(wi, wi) : 0.0;
          tree_rows(sh, k + 2);
          if (tid < k + 2) partials[(int64_t)tid * nb + t] = sh[tid][0];
          __syncthreads();
        }
      }
      grid.sync();
      if (!done) {
        // h = V^T w; w <- w - V h; partials of <w, w>.
        finish_rows(partials, 0, k + 1, nb, sh, hs);
        if (lead)
          for (int j = tid; j <= k; j += kBlock) H[(int64_t)k * ld + j] = hs[j];
        for (int t = blockIdx.x; t < nb; t += gridDim.x) {
          int i = t * kBlock + tid;
          double v = 0.0;
          if (i < n) {
            double acc = 0.0;
            for (int j = 0; j <= k; ++j) acc = __dadd_rn(acc, __dmul_rn(V[(int64_t)j * n + i], hs[j]));
            double wi = __dsub_rn(w[i], acc);
            w[i] = wi;
            v = __dmul_rn(wi, wi);
          }
          sh[0][tid] = v;
          tree_rows(sh, 1);
          if (tid == 0) partials[(int64_t)(k + 2) * nb + t] = sh[0][0];
          __syncthreads();
        }
      }
      grid.sync();
      // V[k + 1] = w / |w| or 0, Hessenberg row k, breakdown flag k + 1.
      double norm = 0.0;
      bool use = false;
      if (!done) {
        finish_rows(partials, k + 1, 2, nb, sh, hs);
        double norm0 = __dsqrt_rn(hs[0]);
        norm0 = norm0 > DBL_EPSILON ? norm0 : 0.0;
        norm = __dsqrt_rn(hs[1]);
        use = norm > DBL_EPSILON * norm0;
      }
      for (int t = blockIdx.x; t < nb; t += gridDim.x) {
        int i = t * kBlock + tid;
        if (i < n) V[(int64_t)(k + 1) * n + i] = use ? __ddiv_rn(w[i], norm) : 0.0;
      }
      if (lead) {
        if (!done)
          for (int j = k + 1 + tid; j <= restart; j += kBlock)
            H[(int64_t)k * ld + j] = j == k + 1 && use ? norm : 0.0;
        if (tid == 0) flags[k + 1] = done || !use || norm == 0.0;
      }
      done = done || !use || norm == 0.0;
      grid.sync();
    }
    if (lead) lstsq(H, st, y, restart, &sh[0][0]);
    grid.sync();
    // x <- x + V[:restart]^T y.
    for (int t = blockIdx.x; t < nb; t += gridDim.x) {
      int i = t * kBlock + tid;
      if (i >= n) continue;
      double dx = 0.0;
      for (int j = 0; j < restart; ++j) dx = __dadd_rn(dx, __dmul_rn(V[(int64_t)j * n + i], y[j]));
      x[i] = __dadd_rn(x[i], dx);
    }
    grid.sync();
  }
  // w = dinv (b - A x); partials of <w, w>.
  for (int t = blockIdx.x; t < nb; t += gridDim.x) {
    int i = t * kBlock + tid;
    double v = 0.0;
    if (i < n) {
      double wi = __dmul_rn(dinv[i], __dsub_rn(b[i], csr_row(row_ptr, cols, vals, x, i)));
      w[i] = wi;
      v = __dmul_rn(wi, wi);
    }
    sh[0][tid] = v;
    tree_rows(sh, 1);
    if (tid == 0) partials[t] = sh[0][0];
    __syncthreads();
  }
  grid.sync();
  // V[0] = w / |w|, the residual norm and the continue flag; H = eye, flags 0.
  finish_rows(partials, 0, 1, nb, sh, hs);
  double norm = __dsqrt_rn(hs[0]);
  bool use = norm > DBL_EPSILON;
  for (int t = blockIdx.x; t < nb; t += gridDim.x) {
    int i = t * kBlock + tid;
    if (i < n) V[i] = use ? __ddiv_rn(w[i], norm) : 0.0;
  }
  if (lead) {
    for (int idx = tid; idx < restart * ld; idx += kBlock) H[idx] = idx / ld == idx % ld ? 1.0 : 0.0;
    for (int j = tid; j <= restart; j += kBlock) flags[j] = 0;
    if (tid == 0) {
      double res = use ? norm : 0.0;
      st[kResNorm] = res;
      cont[0] = res > st[kAtol];
    }
  }
}

inline int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

inline int last_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" int ppt_bicgstab_p_f64(const double* r, const double* q,
                                  const double* dinv, const double* st,
                                  double* p, double* phat, int n, void* stream) {
  if (n == 0) return 0;
  bicgstab_p_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(r, q, dinv, st, p, phat, n);
  return last_error();
}

extern "C" int ppt_krylov_dots_f64(const double* a, const double* b,
                                   const double* c, const double* d,
                                   double* partials, int n, int ndots,
                                   void* stream) {
  if (n == 0) return 0;
  int nb = blocks_for(n);
  krylov_dots_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(a, b, c, d, partials, n, nb, ndots);
  return last_error();
}

extern "C" int ppt_bicgstab_s_f64(const double* r, const double* q,
                                  const double* dinv, const double* st,
                                  double* s, double* shat, double* partials,
                                  int n, void* stream) {
  if (n == 0) return 0;
  bicgstab_s_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(r, q, dinv, st, s, shat, partials, n);
  return last_error();
}

extern "C" int ppt_bicgstab_xr_f64(double* x, double* r, const double* phat,
                                   const double* shat, const double* s,
                                   const double* t, const double* rhat,
                                   const double* st, double* partials, int n,
                                   void* stream) {
  if (n == 0) return 0;
  int nb = blocks_for(n);
  bicgstab_xr_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(x, r, phat, shat, s, t, rhat, st, partials, n, nb);
  return last_error();
}

extern "C" int ppt_bicgstab_scalars_f64(const double* partials, double* st,
                                        int* cont, int n, int stage,
                                        void* stream) {
  bicgstab_scalars_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(partials, blocks_for(n), st, cont, stage);
  return last_error();
}

namespace {

// Blocks of one gmres_cycle launch for n rows: the co-resident maximum
// (from the kernel's registers and static shared memory), at most one per
// tile; negative: a CUDA error, or no cooperative launch on this device.
int gmres_cycle_grid(int n) {
  static int capacity[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return -(int)cudaErrorNotSupported;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gmres_cycle_kernel, kBlock, 0);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    capacity[dev] = per_sm * sms;
  }
  int nb = blocks_for(n);
  return nb < capacity[dev] ? nb : capacity[dev];
}

}  // namespace

extern "C" int ppt_gmres_cycle_grid_f64(int n, void* stream) {
  (void)stream;
  return gmres_cycle_grid(n);
}

extern "C" int ppt_gmres_cycle_f64(const int* row_ptr, const int* cols,
                                   const double* vals, const double* dinv,
                                   const double* b, double* x, double* V,
                                   double* H, double* y, double* w,
                                   double* partials, int* flags, double* st,
                                   int* cont, int n, int restart, int arnoldi,
                                   void* stream) {
  if (n == 0) return 0;
  if (restart < 1 || restart > kMaxRestart) return (int)cudaErrorInvalidValue;
  int grid = gmres_cycle_grid(n);
  if (grid < 0) return -grid;
  int nb = blocks_for(n);
  void* args[] = {&row_ptr, &cols, &vals, &dinv, &b, &x, &V, &H, &y, &w,
                  &partials, &flags, &st, &cont, &n, &nb, &restart, &arnoldi};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&gmres_cycle_kernel), dim3(grid),
                                              dim3(kBlock), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return last_error();
}
