// The parent's K11 kernel ([A | I] in shared memory, warp 0's pivot search,
// four barriers a step), kept beside flash_inverse_check.py as the yardstick
// of the kernel that kernels/csrc/block_inverse.cu holds now; built by that
// script alone, never by the package.
//
// K11: inverses of a batch of dense blocks of one size, f64.
//
// Replaces porepy_tpu/numerics/linalg/matrix_operations.py:105-142
// (_invert_blocks_batched): the size-grouped batched inverse behind
// invert_diagonal_blocks, which the TPU package pins to its host CPU because
// the TPU has no f64 LU. Here each block of the (B, n, n) batch is inverted
// on the card by Gauss-Jordan elimination with partial pivoting on [A | I]:
//
//   per column k: p = the first row i >= k of largest |M_ik|, swap rows k
//   and p, divide row k by its pivot, and subtract M_ik times row k from
//   every other row i; the right half of M is then the inverse.
//
// One thread block per matrix, no atomics: the result does not depend on
// the schedule. The block holds [A | I] (n x 2n, row-major) and the n
// multipliers of the current column in shared memory while that fits the
// 227 KB a block may have (n <= 120); above that, [A | I] lives in a device
// workspace of B n 2n doubles that the wrapper allocates (one slice per
// block) and only the multipliers stay in shared memory. The elimination
// rounds the product and the difference separately (__dmul_rn, __dsub_rn,
// no fused multiply-add), as the plain PyTorch version's separate
// operations do, so that the two agree to the last bit where they pick the
// same pivots.
//
// A zero pivot divides by zero and leaves inf/NaN in the block's output,
// as the LU inverse of a singular matrix does; nothing flags or hides it.
//
// Bound: bytes at the real sizes. 1,374 blocks of 81 move 2 x 72 MB (the
// batch in, the inverses out), 0.043 ms at 3.35 TB/s, and their 2 n^3
// operations, 1.46 GFLOP, take as long at 34 TFLOP/s in f64. The kernel
// runs n elimination steps per block, each a block-wide barrier, so it is
// far from that bound: the steps are short (n - 1 rows of 2n - k entries)
// and the work per SM is one block at a time where [A | I] fills the
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Dynamic shared memory a block may take: sm_90's opt-in limit of 232,448
// bytes, less 1 KB for the static pivot index and alignment (as K10).
constexpr int kSmemMax = 231424;

__global__ void block_inverse_kernel(const double* __restrict__ a,
                                     double* __restrict__ out,
                                     double* __restrict__ work, int n) {
  extern __shared__ double smem[];
  __shared__ int s_p;
  const int ld = 2 * n;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  double* fcol = smem;  // the multipliers of column k
  double* M = work ? work + b * (int64_t)n * ld : smem + n;
  const double* A = a + b * (int64_t)n * n;
  double* O = out + b * (int64_t)n * n;

  for (int e = tid; e < n * ld; e += nt) {
    const int i = e / ld;
    const int j = e - i * ld;
    M[e] = j < n ? A[i * n + j] : (j - n == i ? 1.0 : 0.0);
  }
  __syncthreads();

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
      // Columns left of k are zero in rows k and p (both not yet pivots).
      for (int j = k + tid; j < ld; j += nt) {
        const double t = M[k * ld + j];
        M[k * ld + j] = M[p * ld + j];
        M[p * ld + j] = t;
      }
      __syncthreads();
    }
    const double piv = M[k * ld + k];
    for (int i = tid; i < n; i += nt) fcol[i] = i == k ? 0.0 : M[i * ld + k];
    __syncthreads();
    for (int j = k + tid; j < ld; j += nt) M[k * ld + j] = M[k * ld + j] / piv;
    __syncthreads();
    const int cols = ld - k;
    for (int e = tid; e < n * cols; e += nt) {
      const int i = e / cols;
      if (i == k) continue;
      const int j = k + (e - i * cols);
      M[i * ld + j] = __dsub_rn(M[i * ld + j], __dmul_rn(fcol[i], M[k * ld + j]));
    }
    __syncthreads();
  }

  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n;
    O[e] = M[i * ld + n + (e - i * n)];
  }
}

}  // namespace

// work == nullptr: [A | I] in shared memory (8 n (2 n + 1) bytes, at most
// kSmemMax); otherwise a (batch, n, 2 n) workspace in device memory.
extern "C" int ppt_block_inverse_f64(const double* a, double* out, double* work,
                                     int batch, int n, void* stream) {
  if (batch < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  const size_t smem =
      sizeof(double) * ((size_t)n + (work ? 0 : (size_t)n * 2 * n));
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n <= 16 ? 64 : (n <= 40 ? 128 : 256);
  block_inverse_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      a, out, work, n);
  return (int)cudaGetLastError();
}
