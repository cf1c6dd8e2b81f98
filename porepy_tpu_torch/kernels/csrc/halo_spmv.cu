// K19: the row-sharded matvec of the dof-sharded Krylov solve.
//
// Replaces the matvec of porepy_tpu/numerics/linalg/device_solver.py:947-953
// (mv_eq/mv32) as it runs under with_sharding_constraint (`wsc`) on a
// device mesh (porepy_tpu/parallel/sharded.py:37-128): there GSPMD splits
// the ELL rows over the devices and inserts the gathers of the operand
// vector. Here each rank owns the contiguous rows [lo, hi) and the matching
// entries x_own = x[lo:hi]; the entries it reads from other ranks (the halo)
// arrive by one all_to_all_single between two launches. The shard's column
// table is remapped: c < n_own reads x_own[c], n_own <= c < n_own + n_halo
// reads x_halo[c - n_own], c = n_own + n_halo is padding (skipped). Its
// rows are split once, on the host, into interior rows (every column owned
// or padding) and boundary rows (at least one halo column):
//
//   halo_interior (launch A, before the exchange): its first blocks write
//     the send buffer send[k] = x_own[send_idx[k]], the others the interior
//     rows y[rows[i]] from x_own alone. With no halo this is the matvec.
//   halo_boundary (launch B, after it): the boundary rows from x_own and
//     the received halo, read where they lie, never concatenated.
//
// The launcher (HaloOperator in kernels/ops.py) hands both kernels the
// shard's rows reordered once per matrix, interior rows first, so that each
// block's rows are one contiguous span of val and col, staged in shared
// memory with 16-byte cp.async copies as K1 stages its rows; rows[i] is the
// place of the i-th reordered row in y. A shard with no boundary rows is not
// reordered and halo_interior gets no row list (rows == nullptr): row i goes
// to y[i], and one rank reads the bytes K1 reads. Each row is summed and rounded by
// K1's own code (ell_rows.cuh): one shard holding every row (interior rows
// in order, no reordering) returns K1's result bit for bit.
//
// Bound: bytes, as K1: val and col read once, x_own and the halo read, y
// written once. At md 1/128 over 4 ranks a shard is ~4,540 rows of K = 9
// (0.37 MB in f32) and its halo 600-1,200 entries, 0.11 us at 3.35 TB/s:
// launch-latency bound, hence one launch before the exchange, not two.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kMaxRows = 128;

template <typename T>
__global__ void __launch_bounds__(kMaxRows)
halo_interior_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const int* __restrict__ rows, const T* __restrict__ x_own,
                     const int* __restrict__ send_idx, T* __restrict__ send,
                     T* __restrict__ y, int n_rows, int K, int n_own, int n_send,
                     int pack_blocks, int rows_per_block, int staged,
                     int span_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < pack_blocks) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < n_send) send[k] = x_own[send_idx[k]];
    return;
  }
  const int row0 = (blockIdx.x - pack_blocks) * rows_per_block;
  const int nr = min(rows_per_block, n_rows - row0);
  const T* vs;
  const int* cs;
  block_rows(val, col, row0, nr, K, staged, span_bytes, smem, &vs, &cs);
  for (int r = threadIdx.x; r < nr; r += blockDim.x)
    y[rows ? rows[row0 + r] : row0 + r] = row_sum(
        vs + (int64_t)r * K, cs + (int64_t)r * K, K, Dense<T>{x_own, n_own});
}

template <typename T>
__global__ void __launch_bounds__(kMaxRows)
halo_boundary_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const int* __restrict__ rows, const T* __restrict__ x_own,
                     const T* __restrict__ x_halo, T* __restrict__ y, int n_rows,
                     int K, int n_own, int n_halo, int rows_per_block,
                     int staged, int span_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, n_rows - row0);
  const T* vs;
  const int* cs;
  block_rows(val, col, row0, nr, K, staged, span_bytes, smem, &vs, &cs);
  for (int r = threadIdx.x; r < nr; r += blockDim.x)
    y[rows[row0 + r]] = row_sum(vs + (int64_t)r * K, cs + (int64_t)r * K, K,
                                Split<T>{x_own, x_halo, n_own, n_halo});
}

template <typename T>
int interior(const T* val, const int* col, const int* rows, const T* x_own,
             const int* send_idx, T* send, T* y, int n_rows, int K, int n_own,
             int n_send, void* stream) {
  if (n_rows < 0 || K < 0 || n_own < 0 || n_send < 0) return (int)cudaErrorInvalidValue;
  const Tiling t = ell_tiling(n_rows, K, (int)sizeof(T));
  const int pack_blocks = (n_send + t.rows - 1) / t.rows;
  if (pack_blocks + t.blocks == 0) return 0;
  halo_interior_kernel<T><<<pack_blocks + t.blocks, t.rows, t.smem,
                            (cudaStream_t)stream>>>(
      val, col, rows, x_own, send_idx, send, y, n_rows, K, n_own, n_send,
      pack_blocks, t.rows, t.staged, t.val_span);
  return (int)cudaGetLastError();
}

template <typename T>
int boundary(const T* val, const int* col, const int* rows, const T* x_own,
             const T* x_halo, T* y, int n_rows, int K, int n_own, int n_halo,
             void* stream) {
  if (n_rows < 0 || K < 0 || n_own < 0 || n_halo < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const Tiling t = ell_tiling(n_rows, K, (int)sizeof(T));
  halo_boundary_kernel<T><<<t.blocks, t.rows, t.smem, (cudaStream_t)stream>>>(
      val, col, rows, x_own, x_halo, y, n_rows, K, n_own, n_halo, t.rows,
      t.staged, t.val_span);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_halo_interior_f32(const float* val, const int* col,
                                     const int* rows, const float* x_own,
                                     const int* send_idx, float* send, float* y,
                                     int n_rows, int K, int n_own, int n_send,
                                     void* stream) {
  return interior<float>(val, col, rows, x_own, send_idx, send, y, n_rows, K,
                         n_own, n_send, stream);
}

extern "C" int ppt_halo_interior_f64(const double* val, const int* col,
                                     const int* rows, const double* x_own,
                                     const int* send_idx, double* send,
                                     double* y, int n_rows, int K, int n_own,
                                     int n_send, void* stream) {
  return interior<double>(val, col, rows, x_own, send_idx, send, y, n_rows, K,
                          n_own, n_send, stream);
}

extern "C" int ppt_halo_boundary_f32(const float* val, const int* col,
                                     const int* rows, const float* x_own,
                                     const float* x_halo, float* y, int n_rows,
                                     int K, int n_own, int n_halo,
                                     void* stream) {
  return boundary<float>(val, col, rows, x_own, x_halo, y, n_rows, K, n_own,
                         n_halo, stream);
}

extern "C" int ppt_halo_boundary_f64(const double* val, const int* col,
                                     const int* rows, const double* x_own,
                                     const double* x_halo, double* y,
                                     int n_rows, int K, int n_own, int n_halo,
                                     void* stream) {
  return boundary<double>(val, col, rows, x_own, x_halo, y, n_rows, K, n_own,
                          n_halo, stream);
}
