// K18: the Jacobi-preconditioned Krylov solves of solve_sparse.
//
// Replaces porepy_tpu/numerics/linalg/krylov.py:42-61 (_krylov), the
// jax.scipy.sparse.linalg BiCGStab and GMRES(restart 30, "batched") that XLA
// fused around the BCOO matvec, with the Jacobi preconditioner
// M x = dinv * x. The matvecs stay with K1 (ell_spmv.cu); these kernels are
// the vector and scalar work between them, all f64.
//
// K18a, one BiCGStab iteration of jax 0.9's _bicgstab_solve:
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
// K18b, one restart of jax's _gmres_batched:
//
//   cgs_project    w = dinv (A v_k), block partials of V^T w over the k + 1
//                  basis vectors and of <w, w>
//   cgs_update     finishes h = V^T w, w <- w - V h, partials of <w, w>
//   cgs_normalize  finishes |w|, V[k + 1] = w / |w| (0 below jax's
//                  threshold eps |w_0|), the Hessenberg row k, the
//                  breakdown flag of step k + 1
//   gmres_lstsq    one block: the 30 x 30 normal equations H H^T y =
//                  beta H e_0, Cholesky and two triangular solves (jax's
//                  _lstsq with assume_a="pos")
//   gmres_correct  x <- x + V[:restart]^T y
//   gmres_residual w = dinv (b - A x), partials of <w, w>
//   gmres_restart  finishes |w|, V[0] = w / |w|, the residual norm, the
//                  continue flag, H = eye, the breakdown flags cleared.
//
// jax's _iterative_classical_gram_schmidt with max_iterations=2 runs one
// projection: its loop condition k < max_iterations - 1 fails after the
// first pass, so there is no second ("twice is enough") pass here either.
// After a breakdown jax stops the restart's Arnoldi loop; here the later
// steps of the restart read the breakdown flag on the device and skip
// (cgs_normalize still writes the zero basis vector jax's V holds), so the
// host never reads a flag inside a restart.
//
// Every reduction is two passes: the blocks write partial sums (a fixed
// tree in shared memory), and a later kernel sums them in a fixed order, in
// one block or redundantly in every block that needs the result. There
// are no atomics, so a run repeats bit for bit. The elementwise updates
// use __dmul_rn/__dadd_rn/__dsub_rn so that no multiply-add is contracted:
// they round as the plain PyTorch version does, term by term.
//
// Bound: launches. At biot 1/64 (n = 12,288) each pass moves 0.1-0.4 MB
// (the Arnoldi projection at k = 29, 31 vectors, 3 MB), 0.03-1 us at
// 3.35 TB/s, far below the ~3-5 us a launch costs; the host's enqueue rate
// and one flag read per iteration (BiCGStab) or per restart (GMRES) set
// the time.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

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

// V is (restart + 1, n), one basis vector per row; partials is
// (restart + 3, nb): rows 0..k the projections, k + 1 the norm of w before
// the projection, k + 2 after it.
__global__ void cgs_project_kernel(const double* __restrict__ av,
                                   const double* __restrict__ dinv,
                                   const double* __restrict__ V,
                                   double* __restrict__ w,
                                   double* __restrict__ partials,
                                   const int* __restrict__ flags, int n,
                                   int nb, int k) {
  if (flags[k]) return;
  int j = blockIdx.y;
  int i = blockIdx.x * kBlock + threadIdx.x;
  double v = 0.0;
  if (i < n) {
    double wi = __dmul_rn(dinv[i], av[i]);
    if (j <= k) {
      v = V[(int64_t)j * n + i] * wi;
    } else {
      v = wi * wi;
      w[i] = wi;
    }
  }
  v = block_sum(v);
  if (threadIdx.x == 0) partials[(int64_t)j * nb + blockIdx.x] = v;
}

__global__ void cgs_update_kernel(const double* __restrict__ V,
                                  double* __restrict__ w,
                                  double* __restrict__ partials,
                                  const int* __restrict__ flags, int n, int nb,
                                  int k) {
  __shared__ double h[kMaxRestart + 1];
  if (flags[k]) return;
  for (int j = 0; j <= k; ++j) {
    double hj = row_sum(partials + (int64_t)j * nb, nb);
    if (threadIdx.x == 0) h[j] = hj;
  }
  __syncthreads();
  int i = blockIdx.x * kBlock + threadIdx.x;
  double v = 0.0;
  if (i < n) {
    double acc = 0.0;
    for (int j = 0; j <= k; ++j) acc += V[(int64_t)j * n + i] * h[j];
    double wi = __dsub_rn(w[i], acc);
    w[i] = wi;
    v = wi * wi;
  }
  v = block_sum(v);
  if (threadIdx.x == 0) partials[(int64_t)(k + 2) * nb + blockIdx.x] = v;
}

__global__ void cgs_normalize_kernel(const double* __restrict__ w,
                                     double* __restrict__ V,
                                     double* __restrict__ H,
                                     const double* __restrict__ partials,
                                     int* __restrict__ flags, int n, int nb,
                                     int k, int restart) {
  const int done = flags[k];
  double norm = 0.0;
  bool use = false;
  if (!done) {
    // jax's _safe_normalize: |w_0| (0 at or below eps) sets the threshold
    // eps |w_0| under which the new vector counts as zero.
    double norm0 = sqrt(row_sum(partials + (int64_t)(k + 1) * nb, nb));
    norm0 = norm0 > DBL_EPSILON ? norm0 : 0.0;
    norm = sqrt(row_sum(partials + (int64_t)(k + 2) * nb, nb));
    use = norm > DBL_EPSILON * norm0;
  }
  int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n) V[(int64_t)(k + 1) * n + i] = use ? __ddiv_rn(w[i], norm) : 0.0;
  if (blockIdx.x != 0) return;
  if (!done) {
    double* row = H + (int64_t)k * (restart + 1);
    for (int j = 0; j <= k; ++j) {
      double hj = row_sum(partials + (int64_t)j * nb, nb);
      if (threadIdx.x == 0) row[j] = hj;
    }
    for (int j = k + 1 + threadIdx.x; j <= restart; j += kBlock)
      row[j] = j == k + 1 && use ? norm : 0.0;
  }
  if (threadIdx.x == 0) flags[k + 1] = done || !use || norm == 0.0;
}

__global__ void gmres_lstsq_kernel(const double* __restrict__ H,
                                   const double* __restrict__ st,
                                   double* __restrict__ y, int restart) {
  __shared__ double a[kMaxRestart][kMaxRestart + 1];
  __shared__ double z[kMaxRestart];
  const int R = restart, ld = restart + 1;
  // a = H H^T, z = H (beta e_0): jax's _lstsq(H^T, beta e_0).
  for (int idx = threadIdx.x; idx < R * R; idx += kBlock) {
    int i = idx / R, j = idx % R;
    double acc = 0.0;
    for (int c = 0; c <= R; ++c) acc += H[i * ld + c] * H[j * ld + c];
    a[i][j] = acc;
  }
  for (int i = threadIdx.x; i < R; i += kBlock) z[i] = H[i * ld] * st[kResNorm];
  __syncthreads();
  // Cholesky a = L L^T in the lower triangle, column by column.
  for (int c = 0; c < R; ++c) {
    if (threadIdx.x == 0) a[c][c] = sqrt(a[c][c]);
    __syncthreads();
    for (int i = c + 1 + threadIdx.x; i < R; i += kBlock) a[i][c] /= a[c][c];
    __syncthreads();
    int m = R - c - 1;
    for (int idx = threadIdx.x; idx < m * m; idx += kBlock) {
      int i = c + 1 + idx / m, j = c + 1 + idx % m;
      if (j <= i) a[i][j] -= a[i][c] * a[j][c];
    }
    __syncthreads();
  }
  // L u = z, then L^T y = u: 30 rows, one thread.
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      double acc = z[i];
      for (int m = 0; m < i; ++m) acc -= a[i][m] * z[m];
      z[i] = acc / a[i][i];
    }
    for (int i = R - 1; i >= 0; --i) {
      double acc = z[i];
      for (int m = i + 1; m < R; ++m) acc -= a[m][i] * z[m];
      z[i] = acc / a[i][i];
    }
    for (int i = 0; i < R; ++i) y[i] = z[i];
  }
}

__global__ void gmres_correct_kernel(const double* __restrict__ V,
                                     const double* __restrict__ y,
                                     double* __restrict__ x, int n, int restart) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  double dx = 0.0;
  for (int j = 0; j < restart; ++j) dx += V[(int64_t)j * n + i] * y[j];
  x[i] = __dadd_rn(x[i], dx);
}

__global__ void gmres_residual_kernel(const double* __restrict__ b,
                                      const double* __restrict__ ax,
                                      const double* __restrict__ dinv,
                                      double* __restrict__ w,
                                      double* __restrict__ partials, int n) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  double v = 0.0;
  if (i < n) {
    double wi = __dmul_rn(dinv[i], __dsub_rn(b[i], ax[i]));
    w[i] = wi;
    v = wi * wi;
  }
  v = block_sum(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

__global__ void gmres_restart_kernel(const double* __restrict__ w,
                                     double* __restrict__ V,
                                     double* __restrict__ H,
                                     const double* __restrict__ partials,
                                     int* __restrict__ flags,
                                     double* __restrict__ st,
                                     int* __restrict__ cont, int n, int nb,
                                     int restart) {
  double norm = sqrt(row_sum(partials, nb));
  bool use = norm > DBL_EPSILON;
  int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n) V[i] = use ? __ddiv_rn(w[i], norm) : 0.0;
  if (blockIdx.x != 0) return;
  const int ld = restart + 1;
  for (int idx = threadIdx.x; idx < restart * ld; idx += kBlock)
    H[idx] = idx / ld == idx % ld ? 1.0 : 0.0;
  for (int j = threadIdx.x; j <= restart; j += kBlock) flags[j] = 0;
  if (threadIdx.x == 0) {
    double res = use ? norm : 0.0;
    st[kResNorm] = res;
    cont[0] = res > st[kAtol];
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

extern "C" int ppt_cgs_project_f64(const double* av, const double* dinv,
                                   const double* V, double* w,
                                   double* partials, const int* flags, int n,
                                   int k, void* stream) {
  if (n == 0) return 0;
  int nb = blocks_for(n);
  cgs_project_kernel<<<dim3(nb, k + 2), kBlock, 0, (cudaStream_t)stream>>>(av, dinv, V, w, partials, flags, n, nb, k);
  return last_error();
}

extern "C" int ppt_cgs_update_f64(const double* V, double* w, double* partials,
                                  const int* flags, int n, int k, void* stream) {
  if (n == 0) return 0;
  int nb = blocks_for(n);
  cgs_update_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(V, w, partials, flags, n, nb, k);
  return last_error();
}

extern "C" int ppt_cgs_normalize_f64(const double* w, double* V, double* H,
                                     const double* partials, int* flags,
                                     int n, int k, int restart, void* stream) {
  if (n == 0) return 0;
  int nb = blocks_for(n);
  cgs_normalize_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(w, V, H, partials, flags, n, nb, k, restart);
  return last_error();
}

extern "C" int ppt_gmres_lstsq_f64(const double* H, const double* st, double* y,
                                   int restart, void* stream) {
  if (restart < 1 || restart > kMaxRestart) return (int)cudaErrorInvalidValue;
  gmres_lstsq_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(H, st, y, restart);
  return last_error();
}

extern "C" int ppt_gmres_correct_f64(const double* V, const double* y, double* x,
                                     int n, int restart, void* stream) {
  if (n == 0) return 0;
  gmres_correct_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(V, y, x, n, restart);
  return last_error();
}

extern "C" int ppt_gmres_residual_f64(const double* b, const double* ax,
                                      const double* dinv, double* w,
                                      double* partials, int n, void* stream) {
  if (n == 0) return 0;
  gmres_residual_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(b, ax, dinv, w, partials, n);
  return last_error();
}

extern "C" int ppt_gmres_restart_f64(const double* w, double* V, double* H,
                                     const double* partials, int* flags,
                                     double* st, int* cont, int n, int restart,
                                     void* stream) {
  if (n == 0) return 0;
  int nb = blocks_for(n);
  gmres_restart_kernel<<<nb, kBlock, 0, (cudaStream_t)stream>>>(w, V, H, partials, flags, st, cont, n, nb, restart);
  return last_error();
}
