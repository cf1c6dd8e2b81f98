// K2: one fused ELL smoother sweep, out = y + sinv * (r - A y).
//
// Replaces the smoother lines of porepy_tpu/numerics/linalg/amg.py:334-340
// (Hierarchy._cycle) and the body of
// porepy_tpu/numerics/linalg/device_solver.py:256 (_jacobi_sweeps).
//
// On the TPU the sweep was three XLA ops fused by the compiler; in eager
// PyTorch it would be a matvec, a subtraction, a multiply and an add, four
// launches and three temporaries per sweep. Here it is one launch that reads
// A's row, y, r and sinv once and writes the new iterate. One thread per
// row; padding columns (col == n) contribute nothing.
//
// Bound: bytes (same row traffic as K1 plus three vectors), and at AMG
// level sizes launch latency dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void ell_jacobi_sweep_kernel(const T* __restrict__ val,
                                        const int* __restrict__ col,
                                        const T* __restrict__ sinv,
                                        const T* __restrict__ r,
                                        const T* __restrict__ y,
                                        T* __restrict__ out, int n, int K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* v = val + (int64_t)i * K;
  const int* c = col + (int64_t)i * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    int j = c[k];
    if (j < n) acc += v[k] * y[j];
  }
  out[i] = y[i] + sinv[i] * (r[i] - acc);
}

template <typename T>
int launch(const T* val, const int* col, const T* sinv, const T* r, const T* y,
           T* out, int n, int K, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  ell_jacobi_sweep_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      val, col, sinv, r, y, out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_ell_jacobi_sweep_f32(const float* val, const int* col,
                                        const float* sinv, const float* r,
                                        const float* y, float* out, int n,
                                        int K, void* stream) {
  return launch<float>(val, col, sinv, r, y, out, n, K, stream);
}

extern "C" int ppt_ell_jacobi_sweep_f64(const double* val, const int* col,
                                        const double* sinv, const double* r,
                                        const double* y, double* out, int n,
                                        int K, void* stream) {
  return launch<double>(val, col, sinv, r, y, out, n, K, stream);
}
