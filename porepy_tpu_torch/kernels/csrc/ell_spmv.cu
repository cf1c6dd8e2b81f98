// K1: padded-row (ELL) sparse matrix-vector product, y = A x.
//
// Replaces porepy_tpu/numerics/linalg/amg.py:59 (ell_matvec) and its twins
// porepy_tpu/numerics/ad/compiler.py:372 (_EllMat.matvec) and
// porepy_tpu/numerics/linalg/device_solver.py:947-953 (mv_eq/mv32).
//
//   y[b, i] = sum_k val[i, k] * x[b, col[i, k]],   col == n_cols reads 0.
//
// The TPU design appended a zero to x so that padding slots gather it; here
// the kernel tests the column instead and skips the load. One thread per
// (batch, row); rows are fastest so that the batched form (the colored JVP
// seeds of the assembly, B = number of colors) reuses each row's val/col
// from L1/L2 across the batch.
//
// Bound: bytes. Per row it reads K values, K int32 columns and up to K
// gathered x entries, and writes one value; at md 1/128 (n = 18,157, K = 9)
// the whole operator is 1.3 MB in f64, so it lives in the 50 MB L2 and the
// kernel is launch-latency bound. A warp-per-row or sliced-ELL layout with
// coalesced val/col loads is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void ell_spmv_kernel(const T* __restrict__ val,
                                const int* __restrict__ col,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n_rows, int K, int n_cols, int batch) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n_rows * batch) return;
  int b = (int)(t / n_rows);
  int i = (int)(t - (int64_t)b * n_rows);
  const T* xb = x + (int64_t)b * n_cols;
  const T* v = val + (int64_t)i * K;
  const int* c = col + (int64_t)i * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    int j = c[k];
    if (j < n_cols) acc += v[k] * xb[j];
  }
  y[t] = acc;
}

template <typename T>
int launch(const T* val, const int* col, const T* x, T* y, int n_rows, int K,
           int n_cols, int batch, void* stream) {
  int64_t work = (int64_t)n_rows * batch;
  if (work == 0) return 0;
  const int threads = 256;
  int blocks = (int)((work + threads - 1) / threads);
  ell_spmv_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      val, col, x, y, n_rows, K, n_cols, batch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_ell_spmv_f32(const float* val, const int* col,
                                const float* x, float* y, int n_rows, int K,
                                int n_cols, int batch, void* stream) {
  return launch<float>(val, col, x, y, n_rows, K, n_cols, batch, stream);
}

extern "C" int ppt_ell_spmv_f64(const double* val, const int* col,
                                const double* x, double* y, int n_rows, int K,
                                int n_cols, int batch, void* stream) {
  return launch<double>(val, col, x, y, n_rows, K, n_cols, batch, stream);
}
