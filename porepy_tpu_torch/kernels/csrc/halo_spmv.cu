// K19: the row-sharded matvec of the dof-sharded Krylov solve.
//
// Replaces the matvec of porepy_tpu/numerics/linalg/device_solver.py:947-953
// (mv_eq/mv32) as it runs under with_sharding_constraint (`wsc`) on a
// device mesh (porepy_tpu/parallel/sharded.py:37-128): there GSPMD splits
// the ELL rows over the devices and inserts the gathers of the operand
// vector. Here each rank owns the contiguous rows [lo, hi) and the matching
// entries x_own = x[lo:hi]; the entries it reads from other ranks (the halo)
// arrive by one all_to_all_single between two kernels:
//
//   halo_pack:      send[k] = x_own[send_idx[k]]
//                   (the entries the other ranks read, grouped by rank);
//   ell_spmv_split: y[i] = sum_k val[i, k] * src(col[i, k]), with
//                   src(c) = x_own[c]            for c <  n_own,
//                            x_halo[c - n_own]   for n_own <= c < n_own + n_halo,
//                            0 (slot skipped)    for c == n_own + n_halo (padding).
//
// ell_spmv_split sums the slots in K1's order (csrc/ell_spmv.cu) and
// rounds as K1 does (each product rounded, then added: no contracted
// multiply-add), so that on one rank (no halo, col = the global table) it
// returns K1's result bit for bit; x_own and x_halo are read where they lie
// and never concatenated.
//
// Bound: bytes, as K1. At md 1/128 over 4 ranks a shard is ~4,540 rows of
// K = 9 (0.36 MB in f64) and its halo 600-1,200 entries, so both kernels
// are launch-latency bound; one thread per row or per sent entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void halo_pack_kernel(const T* __restrict__ x_own,
                                 const int* __restrict__ send_idx,
                                 T* __restrict__ send, int n_send) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_send) send[k] = x_own[send_idx[k]];
}

template <typename T>
__global__ void ell_spmv_split_kernel(const T* __restrict__ val,
                                      const int* __restrict__ col,
                                      const T* __restrict__ x_own,
                                      const T* __restrict__ x_halo,
                                      T* __restrict__ y, int n_rows, int K,
                                      int n_own, int n_halo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const T* v = val + (int64_t)i * K;
  const int* c = col + (int64_t)i * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int j = c[k];
    if (j < n_own) {
      acc = add_rn(acc, mul_rn(v[k], x_own[j]));
    } else if (j - n_own < n_halo) {
      acc = add_rn(acc, mul_rn(v[k], x_halo[j - n_own]));
    }
  }
  y[i] = acc;
}

constexpr int kThreads = 256;

template <typename T>
int pack(const T* x_own, const int* send_idx, T* send, int n_send,
         void* stream) {
  if (n_send <= 0) return n_send < 0 ? (int)cudaErrorInvalidValue : 0;
  halo_pack_kernel<T><<<(n_send + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(x_own, send_idx, send, n_send);
  return (int)cudaGetLastError();
}

template <typename T>
int spmv(const T* val, const int* col, const T* x_own, const T* x_halo, T* y,
         int n_rows, int K, int n_own, int n_halo, void* stream) {
  if (n_rows < 0 || K < 0 || n_own < 0 || n_halo < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  ell_spmv_split_kernel<T><<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(val, col, x_own, x_halo,
                                                     y, n_rows, K, n_own,
                                                     n_halo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_halo_pack_f32(const float* x_own, const int* send_idx,
                                 float* send, int n_send, void* stream) {
  return pack<float>(x_own, send_idx, send, n_send, stream);
}

extern "C" int ppt_halo_pack_f64(const double* x_own, const int* send_idx,
                                 double* send, int n_send, void* stream) {
  return pack<double>(x_own, send_idx, send, n_send, stream);
}

extern "C" int ppt_ell_spmv_split_f32(const float* val, const int* col,
                                      const float* x_own, const float* x_halo,
                                      float* y, int n_rows, int K, int n_own,
                                      int n_halo, void* stream) {
  return spmv<float>(val, col, x_own, x_halo, y, n_rows, K, n_own, n_halo,
                     stream);
}

extern "C" int ppt_ell_spmv_split_f64(const double* val, const int* col,
                                      const double* x_own,
                                      const double* x_halo, double* y,
                                      int n_rows, int K, int n_own, int n_halo,
                                      void* stream) {
  return spmv<double>(val, col, x_own, x_halo, y, n_rows, K, n_own, n_halo,
                      stream);
}
