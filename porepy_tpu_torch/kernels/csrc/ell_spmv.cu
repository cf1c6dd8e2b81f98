// K1: padded-row (ELL) sparse matrix-vector product with an epilogue,
// y = c + sign (A x).
//
// Replaces porepy_tpu/numerics/linalg/amg.py:59 (ell_matvec) and its twins
// porepy_tpu/numerics/ad/compiler.py:372 (_EllMat.matvec) and
// porepy_tpu/numerics/linalg/device_solver.py:947-953 (mv_eq/mv32), and the
// subtraction or addition that follows the product at amg.py:340-341
// (r - A y, y + P z) and device_solver.py:677-697 (r_i - C y_j).
//
//   y[b, i] = c[b, i] + sign * sum_k val[i, k] * x[b, col[i, k]],
//
// col == n_cols reads 0 (the TPU design appended a zero to x; here the slot
// is skipped). c is optional (null), sign is +1 or -1. Each row is summed
// in slot order k = 0..K-1 from 0, every product rounded before it is added
// (no multiply-add is contracted), and the sum is rounded to the type
// before c is added: the result equals the two operations c - A x or
// c + A x to the bit, and the K18b kernel's CSR rows to the bit.
//
// Design. A block owns a run of R consecutive rows and stages their val and
// col in shared memory (ell_rows.cuh, shared with K19); every thread then
// computes (row, b) pairs from shared memory, so val and col leave device
// memory once per call, not once per batch row b, and their loads are
// coalesced. md 1/128's 16,969-row level runs in 266 blocks; a block has
// one thread per (row, b) pair up to 512, and each thread issues four
// gathers of x before it adds their products (in order).
//
// Bound: bytes. The matrix is read once, x once per batch row (gathers hit
// L2), y written once: at md 1/128 (n = 18,157, K = 9) 1.45 MB in f32 for
// one vector, 0.43 us at 3.35 TB/s, so one call is launch-bound; at md
// 1/256 with 17 rows of x in f64 the bytes reach ~25 MB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ell_spmv_kernel(const T* __restrict__ val, const int* __restrict__ col,
                const T* __restrict__ x, const T* __restrict__ c,
                T* __restrict__ y, int n_rows, int K, int n_cols, int batch,
                int rows_per_block, int staged, int span_bytes, T sign) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - row0);
  const T* vs;
  const int* cs;
  block_rows(val, col, row0, rows, K, staged, span_bytes, smem, &vs, &cs);
  for (int idx = threadIdx.x; idx < rows * batch; idx += blockDim.x) {
    const int r = idx % rows, bb = idx / rows;
    T acc = row_sum(vs + (int64_t)r * K, cs + (int64_t)r * K, K,
                    Dense<T>{x + (int64_t)bb * n_cols, n_cols});
    const int64_t o = (int64_t)bb * n_rows + row0 + r;
    acc = mul_rn(sign, acc);
    y[o] = c ? add_rn(c[o], acc) : acc;
  }
}

template <typename T>
int launch(const T* val, const int* col, const T* x, const T* c, T* y,
           int n_rows, int K, int n_cols, int batch, int sign, void* stream) {
  if ((int64_t)n_rows * batch == 0) return 0;
  const Tiling t = ell_tiling(n_rows, K, (int)sizeof(T));
  // One thread per (row, batch row) pair, up to 512 a block: a batched call
  // keeps more gathers in flight per staged span.
  int64_t pairs = (int64_t)t.rows * batch;
  const int threads = pairs >= kMaxThreads ? kMaxThreads : (int)((pairs + 31) / 32 * 32);
  ell_spmv_kernel<T><<<t.blocks, threads, t.smem, (cudaStream_t)stream>>>(
      val, col, x, c, y, n_rows, K, n_cols, batch, t.rows, t.staged, t.val_span,
      sign < 0 ? T(-1) : T(1));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_ell_spmv_f32(const float* val, const int* col,
                                const float* x, const float* c, float* y,
                                int n_rows, int K, int n_cols, int batch,
                                int sign, void* stream) {
  return launch<float>(val, col, x, c, y, n_rows, K, n_cols, batch, sign, stream);
}

extern "C" int ppt_ell_spmv_f64(const double* val, const int* col,
                                const double* x, const double* c, double* y,
                                int n_rows, int K, int n_cols, int batch,
                                int sign, void* stream) {
  return launch<double>(val, col, x, c, y, n_rows, K, n_cols, batch, sign, stream);
}
