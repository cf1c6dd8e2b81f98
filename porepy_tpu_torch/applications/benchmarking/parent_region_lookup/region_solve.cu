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
// One thread block per region, no atomics, so the result does not depend
// on the schedule. The block holds [A | RHS] (n x (n + m), row-major) in
// shared memory: 73 KB at the largest bucket of the 3d Biot grids
// (n = 81, m = 32), so the launch raises the dynamic shared-memory limit.
// Where [A | RHS] does not fit the 227 KB a block may have, the same code
// runs on a global-memory workspace of B n (n + m) doubles that the
// wrapper allocates (one slice per block); only the multipliers stay in
// shared memory. In the block:
//
// - the row scales: one warp per row, a max over the row, then the row of
//   [A | RHS] divided by it (a division, as the plain version divides);
// - elimination: per column k, warp 0 finds the first row of largest
//   |M_ik|, i >= k (LAPACK's i?amax choice), the block swaps the two rows
//   and applies the rank-1 update to the rows below, RHS columns included;
// - back substitution of all m columns, column-oriented: per row k from the
//   last, x_k = m_k / u_kk over the m columns, then the update of the rows
//   above, spread over (row, column) pairs;
// - the contraction W X, one thread per output entry, W read from global
//   memory (a warp shares its row of W) and X from the block's workspace.
//
// A zero pivot divides by zero and leaves inf/NaN in the output, as the
// LU would; nothing flags or hides it.
//
// Bound: the n sequential elimination steps and n back-substitution steps,
// each a block-wide barrier; at the 2d shapes (n <= 20) the launch and the
// host-device copies around it dominate. The TPU kept this work on the
// host because partial pivoting is sequential scalar work; here the
// scalar part (the pivot search) is one warp's reduction per column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Dynamic shared memory a block may take: sm_90's opt-in limit of 232,448
// bytes, less 1 KB for the static pivot index and alignment.
constexpr int kSmemMax = 231424;

__global__ void region_solve_kernel(const double* __restrict__ a,
                                    const double* __restrict__ rhs,
                                    const double* __restrict__ w,
                                    double* __restrict__ out,
                                    double* __restrict__ work, int n, int m,
                                    int q) {
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
    for (int off = 16; off > 0; off >>= 1)
      s = fmax(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (s == 0.0) s = 1.0;
    for (int j = lane; j < ld; j += 32) M[i * ld + j] = M[i * ld + j] / s;
  }
  __syncthreads();

  // LU with partial pivoting, applied to [A | RHS].
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      double best = -1.0;
      int bi = k;
      for (int i = k + lane; i < n; i += 32) {
        const double v = fabs(M[i * ld + k]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) s_p = bi;
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
    for (int i = k + 1 + tid; i < n; i += nt) lcol[i] = M[i * ld + k] / piv;
    __syncthreads();
    const int rows = n - k - 1;
    const int cols = ld - k - 1;
    for (int e = tid; e < rows * cols; e += nt) {
      const int r = e / cols;
      const int i = k + 1 + r;
      const int j = k + 1 + (e - r * cols);
      M[i * ld + j] -= lcol[i] * M[k * ld + j];
    }
    __syncthreads();
  }

  // Back substitution; X overwrites the RHS columns.
  for (int k = n - 1; k >= 0; --k) {
    const double ukk = M[k * ld + k];
    for (int c = tid; c < m; c += nt) M[k * ld + n + c] /= ukk;
    __syncthreads();
    for (int e = tid; e < k * m; e += nt) {
      const int i = e / m;
      const int c = e - i * m;
      M[i * ld + n + c] -= M[i * ld + k] * M[k * ld + n + c];
    }
    __syncthreads();
  }

  // OUT = W X.
  for (int e = tid; e < q * m; e += nt) {
    const int r = e / m;
    const int c = e - r * m;
    double acc = 0.0;
    for (int j = 0; j < n; ++j) acc += W[r * n + j] * M[j * ld + n + c];
    O[e] = acc;
  }
}

}  // namespace

// work == nullptr: [A | RHS] in shared memory (8 n (n + m + 1) bytes, at
// most kSmemMax); otherwise a (batch, n, n + m) workspace in device memory.
extern "C" int ppt_region_solve_f64(const double* a, const double* rhs,
                                    const double* w, double* out, double* work,
                                    int batch, int n, int m, int q,
                                    void* stream) {
  if (batch == 0 || m == 0 || q == 0) return 0;
  if (n < 0 || m < 0 || q < 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(double) * ((size_t)n + (work ? 0 : (size_t)n * (n + m)));
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      region_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n <= 16 ? 128 : 256;
  region_solve_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      a, rhs, w, out, work, n, m, q);
  return (int)cudaGetLastError();
}
