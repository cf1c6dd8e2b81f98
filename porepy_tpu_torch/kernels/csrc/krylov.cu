// K18: the Jacobi-preconditioned Krylov solves of solve_sparse.
//
// Replaces porepy_tpu/numerics/linalg/krylov.py:42-61 (_krylov), the
// jax.scipy.sparse.linalg BiCGStab and GMRES(restart 30, "batched") that XLA
// fused around the BCOO matvec, with the Jacobi preconditioner
// M x = dinv * x, all f64.
//
// K18a, a BiCGStab solve (jax 0.9's _bicgstab_solve) as ONE persistent
// cooperative kernel, bicgstab_cycle: the two matvecs of every iteration
// run inside it on the CSR matrix, and it runs iterations until the solve
// stops or the launch's budget of iterations is spent. Each iteration:
//
//   p <- r + beta (p - omega q), phat = dinv p;            | grid sync |
//   q = A phat, partials of <rhat, q>;                      | grid sync |
//   alpha_ = rho_ / <rhat, q> in every block; s = r - alpha_ q,
//        shat = dinv s, partials of <s, s>;                 | grid sync |
//   t = A shat, partials of <t, s> and <t, t>;              | grid sync |
//   the early exit (<s, s> < atol2) and omega_ = <t, s> / <t, t> in every
//        block; x <- x + alpha_ phat + omega_ shat (x + alpha_ phat on the
//        early exit), r <- s - omega_ t (s), partials of <r, r> and
//        <rhat, r>;                                         | grid sync |
//   the rest of the scalar recurrence in every block: the breakdown
//        (rho_, alpha_ or omega_ zero), the continue flag <r, r> > atol2
//        and not breakdown, rho, alpha, omega, rho_ = <rhat, r>, beta.
//
// Every block finishes the same partials in the same order, so the scalars
// and the continue flag are the same in every block and no block skips a
// grid sync; the flag is tested on the device after every iteration.
// Block 0 writes the scalars, the flag and the count of iterations back at
// the end of the launch. With iterations = 0 a launch starts a solve from
// x: r = b - A x, rhat = p = q = r, rho_ = beta = <r, r> and the flag.
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
// Reductions: each tile's partial sum in a fixed tree (tree_rows: entry t
// adds entry t + s for s = 64 .. 1), then every block that needs a sum
// finishes the tile partials in the same fixed order (finish_rows: thread t
// adds partials t, t + 128, ..., then the tree): no atomics, a run repeats
// bit for bit. Every
// operation is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn: no
// multiply-add is contracted), so the plain passes of kernels/reference.py,
// which round the same operations in the same order, give the same bits.
// Arrays written inside the kernel are read through plain pointers (no
// __restrict__ on them): the read-only cache is not coherent across the
// grid syncs.
//
// Bound: bytes, a few us. At biot 1/64 (n = 12,288, 317,026 nonzeros) a
// GMRES restart reads the matrix and writes 31 basis vectors, ~7.5 MB; a
// BiCGStab iteration reads the matrix twice and ~14 vectors, ~9.1 MB.
// Latency is what is left: grid syncs (94 a restart, 5 an iteration),
// block-wide reductions, the dependent gathers of each row and, for GMRES,
// the Cholesky of block 0 (the matvecs keep four gathers in flight; the
// last five levels of each reduction and the triangular solves run in
// warps). Before: 94 launches and 31 K1 launches a restart, 8 launches, 2
// K1 launches and one host flag read a BiCGStab iteration, ~45-54 us of
// host dispatch each.

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

// BiCGStab scalar slots (reference.BICG_* in Python).
enum {
  kRho = 0, kAlpha = 1, kOmega = 2, kRhoNew = 3, kBeta = 4, kAtol2 = 5,
  kAlphaNew = 6, kOmegaNew = 7, kExit = 8, kRr = 9,
};
// BiCGStab partial-sum rows (reference.BICG_ROWS of them): each is read in
// one phase and written again only after the grid syncs that follow it.
enum { kPartRq = 0, kPartSs = 1, kPartTs = 2, kPartTt = 3, kPartRr = 4, kPartHr = 5 };
// GMRES scalar slots (ops.GMRES_* in Python).
enum { kAtol = 0, kResNorm = 1 };

constexpr int kRows = kMaxRestart + 2;  // rows summed at once: V[:k+1] w, <w, w>

// m rows of sh summed at once, each in the same tree (entry t adds entry
// t + s, s = 64 .. 1): row j's sum ends in sh[j][0].
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
// the same order (thread t from 0.0 over partials t, t + 128, ..., then the
// tree), into out[0 .. m - 1] (shared), seen by the whole block.
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

// Sum of one value per thread over the block (the tree of tree_rows), by
// thread 0 into row `row` of partials at tile t.
__device__ void tile_sum(double v, double (*sh)[kBlock], double* partials, int row, int nb, int t) {
  sh[0][threadIdx.x] = v;
  tree_rows(sh, 1);
  if (threadIdx.x == 0) partials[(int64_t)row * nb + t] = sh[0][0];
  __syncthreads();
}

// -- K18a -------------------------------------------------------------------

// A BiCGStab solve: the start (iterations = 0) or up to `iterations`
// iterations while cont[0] holds; see the head of the file. partials is
// (6, nb); cont is (2,): the continue flag and the iterations run so far.
__global__ void __launch_bounds__(kBlock)
bicgstab_cycle_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                      const double* __restrict__ vals, const double* __restrict__ dinv,
                      const double* __restrict__ b, double* x, double* r, double* rhat,
                      double* p, double* q, double* phat, double* s, double* shat,
                      double* t, double* partials, double* st, int* cont, int n, int nb,
                      int iterations) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[3][kBlock];
  __shared__ double sums[3];
  const int tid = threadIdx.x;
  const bool lead = blockIdx.x == 0 && tid == 0;
  if (iterations == 0) {
    // r = b - A x, rhat = p = q = r; partials of <r, r>.
    for (int tile = blockIdx.x; tile < nb; tile += gridDim.x) {
      const int i = tile * kBlock + tid;
      double v = 0.0;
      if (i < n) {
        const double ri = __dsub_rn(b[i], csr_row(row_ptr, cols, vals, x, i));
        r[i] = ri;
        rhat[i] = ri;
        p[i] = ri;
        q[i] = ri;
        v = __dmul_rn(ri, ri);
      }
      tile_sum(v, sh, partials, kPartRr, nb, tile);
    }
    grid.sync();
    if (blockIdx.x == 0) {
      finish_rows(partials, kPartRr, 1, nb, sh, sums);
      if (tid == 0) {
        const double rr = sums[0];
        st[kRhoNew] = rr;
        st[kRr] = rr;
        st[kBeta] = __ddiv_rn(__dmul_rn(__ddiv_rn(rr, st[kRho]), st[kAlpha]), st[kOmega]);
        cont[0] = rr > st[kAtol2];
        cont[1] = 0;
      }
    }
    return;
  }
  // The scalar state, the same in every thread of every block.
  double rho = st[kRho], alpha = st[kAlpha], omega = st[kOmega], rho_ = st[kRhoNew];
  double beta = st[kBeta], alpha_ = st[kAlphaNew], omega_ = st[kOmegaNew];
  double exit_early = st[kExit], rr = st[kRr];
  const double atol2 = st[kAtol2];
  bool go = cont[0] != 0;
  int done = 0;
  while (done < iterations && go) {
    // p <- r + beta (p - omega q), phat = dinv p.
    for (int tile = blockIdx.x; tile < nb; tile += gridDim.x) {
      const int i = tile * kBlock + tid;
      if (i < n) {
        const double pi = __dadd_rn(r[i], __dmul_rn(beta, __dsub_rn(p[i], __dmul_rn(omega, q[i]))));
        p[i] = pi;
        phat[i] = __dmul_rn(dinv[i], pi);
      }
    }
    grid.sync();
    // q = A phat; partials of <rhat, q>.
    for (int tile = blockIdx.x; tile < nb; tile += gridDim.x) {
      const int i = tile * kBlock + tid;
      double v = 0.0;
      if (i < n) {
        const double qi = csr_row(row_ptr, cols, vals, phat, i);
        q[i] = qi;
        v = __dmul_rn(rhat[i], qi);
      }
      tile_sum(v, sh, partials, kPartRq, nb, tile);
    }
    grid.sync();
    finish_rows(partials, kPartRq, 1, nb, sh, sums);
    alpha_ = __ddiv_rn(rho_, sums[0]);
    // s = r - alpha_ q, shat = dinv s; partials of <s, s>.
    for (int tile = blockIdx.x; tile < nb; tile += gridDim.x) {
      const int i = tile * kBlock + tid;
      double v = 0.0;
      if (i < n) {
        const double si = __dsub_rn(r[i], __dmul_rn(alpha_, q[i]));
        s[i] = si;
        shat[i] = __dmul_rn(dinv[i], si);
        v = __dmul_rn(si, si);
      }
      tile_sum(v, sh, partials, kPartSs, nb, tile);
    }
    grid.sync();
    // t = A shat; partials of <t, s> and <t, t>.
    for (int tile = blockIdx.x; tile < nb; tile += gridDim.x) {
      const int i = tile * kBlock + tid;
      double ts = 0.0, tt = 0.0;
      if (i < n) {
        const double ti = csr_row(row_ptr, cols, vals, shat, i);
        t[i] = ti;
        ts = __dmul_rn(ti, s[i]);
        tt = __dmul_rn(ti, ti);
      }
      sh[0][tid] = ts;
      sh[1][tid] = tt;
      tree_rows(sh, 2);
      if (tid < 2) partials[(int64_t)(kPartTs + tid) * nb + tile] = sh[tid][0];
      __syncthreads();
    }
    grid.sync();
    finish_rows(partials, kPartSs, 3, nb, sh, sums);
    exit_early = sums[0] < atol2 ? 1.0 : 0.0;
    omega_ = __ddiv_rn(sums[1], sums[2]);
    // x and r; partials of <r, r> and <rhat, r>.
    for (int tile = blockIdx.x; tile < nb; tile += gridDim.x) {
      const int i = tile * kBlock + tid;
      double vr = 0.0, vh = 0.0;
      if (i < n) {
        const double ap = __dmul_rn(alpha_, phat[i]);
        double ri;
        if (exit_early != 0.0) {
          x[i] = __dadd_rn(x[i], ap);
          ri = s[i];
        } else {
          x[i] = __dadd_rn(x[i], __dadd_rn(ap, __dmul_rn(omega_, shat[i])));
          ri = __dsub_rn(s[i], __dmul_rn(omega_, t[i]));
        }
        r[i] = ri;
        vr = __dmul_rn(ri, ri);
        vh = __dmul_rn(rhat[i], ri);
      }
      sh[0][tid] = vr;
      sh[1][tid] = vh;
      tree_rows(sh, 2);
      if (tid < 2) partials[(int64_t)(kPartRr + tid) * nb + tile] = sh[tid][0];
      __syncthreads();
    }
    grid.sync();
    finish_rows(partials, kPartRr, 2, nb, sh, sums);
    rr = sums[0];
    const bool breakdown = omega_ == 0.0 || alpha_ == 0.0 || rho_ == 0.0;
    go = rr > atol2 && !breakdown;
    rho = rho_;
    alpha = alpha_;
    omega = omega_;
    rho_ = sums[1];
    beta = __ddiv_rn(__dmul_rn(__ddiv_rn(rho_, rho), alpha), omega);
    ++done;
  }
  // Every block read st and cont before the first grid sync; after it the
  // lead may write them.
  if (lead && done > 0) {
    st[kRho] = rho;
    st[kAlpha] = alpha;
    st[kOmega] = omega;
    st[kRhoNew] = rho_;
    st[kBeta] = beta;
    st[kAlphaNew] = alpha_;
    st[kOmegaNew] = omega_;
    st[kExit] = exit_early;
    st[kRr] = rr;
    cont[0] = go;
    cont[1] += done;
  }
}

// -- K18b -------------------------------------------------------------------

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
          tile_sum(v, sh, partials, k + 2, nb, t);
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
    tile_sum(v, sh, partials, 0, nb, t);
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

// Blocks of one cooperative launch of `kernel` for n rows: the co-resident
// maximum (from the kernel's registers and static shared memory), at most
// one per tile; negative: a CUDA error, or no cooperative launch on this
// device. capacity caches the maximum per device.
int cycle_grid(const void* kernel, int* capacity, int n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return -(int)cudaErrorNotSupported;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    capacity[dev] = per_sm * sms;
  }
  int nb = blocks_for(n);
  return nb < capacity[dev] ? nb : capacity[dev];
}

int gmres_cycle_grid(int n) {
  static int capacity[64] = {0};
  return cycle_grid(reinterpret_cast<const void*>(&gmres_cycle_kernel), capacity, n);
}

int bicgstab_cycle_grid(int n) {
  static int capacity[64] = {0};
  return cycle_grid(reinterpret_cast<const void*>(&bicgstab_cycle_kernel), capacity, n);
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

extern "C" int ppt_bicgstab_cycle_grid_f64(int n, void* stream) {
  (void)stream;
  return bicgstab_cycle_grid(n);
}

extern "C" int ppt_bicgstab_cycle_f64(const int* row_ptr, const int* cols,
                                      const double* vals, const double* dinv,
                                      const double* b, double* x, double* r,
                                      double* rhat, double* p, double* q,
                                      double* phat, double* s, double* shat,
                                      double* t, double* partials, double* st,
                                      int* cont, int n, int iterations,
                                      void* stream) {
  if (n == 0) return 0;
  if (iterations < 0) return (int)cudaErrorInvalidValue;
  int grid = bicgstab_cycle_grid(n);
  if (grid < 0) return -grid;
  int nb = blocks_for(n);
  void* args[] = {&row_ptr, &cols, &vals, &dinv, &b, &x, &r, &rhat, &p, &q,
                  &phat, &s, &shat, &t, &partials, &st, &cont, &n, &nb, &iterations};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&bicgstab_cycle_kernel),
                                              dim3(grid), dim3(kBlock), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return last_error();
}
