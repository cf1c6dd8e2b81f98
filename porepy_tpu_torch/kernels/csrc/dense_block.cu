// K6: the dense frozen block inverse of the block preconditioner.
//
// Replaces porepy_tpu/numerics/linalg/device_solver.py:137-149
// (_dense_inv_fn: the COO scatter into a padded f32 matrix with an identity
// pad), the pivot inverse jax.numpy.linalg.inv(P) inside the blocked
// Gauss-Jordan loop of _dense_block_inv (:82-120), and the dense apply of
// _BlockPrecondBuilder.build.apply (:702-706).
//
// Three entry points:
//
// - ppt_dense_block_scatter: D[rows[e], cols[e]] = vals[e] for coalesced COO
//   entries (the host sums duplicates first, so every entry is a plain store:
//   no atomics, and the result does not depend on the order of the threads),
//   then D[i, i] = 1 on the pad rows ni <= i < n_pad. D is zeroed by the
//   caller. Bound: bytes of the nnz entries.
//
// - ppt_gj_pivot_inverse: the inverse of each b x b matrix of a batch, one
//   thread block per matrix, by Gauss-Jordan elimination with partial
//   pivoting inside the matrix, held in shared memory (b <= 128: 66 KB in
//   f32, so the launch raises the dynamic shared-memory limit). Row swaps
//   are recorded and undone as column swaps in reverse order at the end.
//   The TPU inverted 1024-row pivots with XLA's LU; a pivot that size does
//   not fit one SM, so the blocked driver takes 128-row pivots and this
//   kernel inverts them. Pivoting inside the pivot block matches the LU
//   with partial pivoting of jax.numpy.linalg.inv, so a pivot block with a
//   zero leading entry still inverts. flag[m] is set to 1 (never cleared) when
//   matrix m has a zero or non-finite pivot or a non-finite inverse entry;
//   the caller reads it once per build. Bound: the b sequential
//   elimination steps, each a rank-1 update of shared memory.
//
// - ppt_dense_block_apply: y[i] = sum_{j < ni} D[i, j] * float(r[j]) for
//   i < ni, accumulated in f32 and cast to r's type: the pad, the f32 cast,
//   the GEMV, the slice and the cast back of the TPU apply in one pass. One
//   warp per row, 16-byte loads of D. Bound: bytes of D (4.29 GB at
//   ni = 32,768), read once per apply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void dense_block_scatter_kernel(const T* __restrict__ vals,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ cols,
                                           int nnz, int ni, int n_pad,
                                           T* __restrict__ D) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nnz) {
    D[(int64_t)rows[t] * n_pad + cols[t]] = vals[t];
  } else {
    int64_t i = (int64_t)ni + (t - nnz);
    if (i < n_pad) D[i * n_pad + i] = T(1);
  }
}

template <typename T>
__global__ void gj_pivot_inverse_kernel(const T* __restrict__ a,
                                        T* __restrict__ out,
                                        int* __restrict__ flag, int b) {
  extern __shared__ unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // b * b, row-major
  T* fcol = A + b * b;                    // column k before elimination
  __shared__ int piv[128];
  __shared__ int s_p;
  __shared__ int s_bad;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int bb = b * b;
  const T* src = a + (int64_t)blockIdx.x * bb;
  T* dst = out + (int64_t)blockIdx.x * bb;

  for (int e = tid; e < bb; e += nt) A[e] = src[e];
  if (tid == 0) s_bad = 0;
  __syncthreads();

  for (int k = 0; k < b; ++k) {
    // Partial pivoting: the first row of largest |A[i][k]|, i >= k (the
    // choice of LAPACK's i?amax). NaN never wins a comparison; if every
    // candidate is NaN the pivot stays on the diagonal and is flagged.
    if (tid < 32) {
      T best = T(-1);
      int bi = k;
      for (int i = k + tid; i < b; i += 32) {
        T v = fabs(A[i * b + k]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        T ob = __shfl_down_sync(0xffffffffu, best, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (tid == 0) {
        s_p = bi;
        piv[k] = bi;
      }
    }
    __syncthreads();
    const int p = s_p;
    if (p != k) {
      for (int j = tid; j < b; j += nt) {
        T t = A[k * b + j];
        A[k * b + j] = A[p * b + j];
        A[p * b + j] = t;
      }
    }
    __syncthreads();
    const T pv = A[k * b + k];
    if (tid == 0 && !(fabs(pv) > T(0) && isfinite(pv))) s_bad = 1;
    const T inv = T(1) / pv;
    __syncthreads();  // every thread has read the pivot
    for (int j = tid; j < b; j += nt) {
      A[k * b + j] = (j == k) ? inv : A[k * b + j] * inv;
      fcol[j] = (j == k) ? T(0) : A[j * b + k];
    }
    __syncthreads();
    for (int e = tid; e < bb; e += nt) {
      const int i = e / b;
      if (i == k) continue;
      const int j = e - i * b;
      A[e] = (j == k ? T(0) : A[e]) - fcol[i] * A[k * b + j];
    }
    __syncthreads();
  }
  // inv(P A) P = inv(A): undo the row swaps as column swaps, last first.
  for (int k = b - 1; k >= 0; --k) {
    const int p = piv[k];
    if (p != k) {
      for (int i = tid; i < b; i += nt) {
        T t = A[i * b + k];
        A[i * b + k] = A[i * b + p];
        A[i * b + p] = t;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < bb; e += nt) {
    const T v = A[e];
    if (!isfinite(v)) s_bad = 1;
    dst[e] = v;
  }
  __syncthreads();
  if (tid == 0 && s_bad) flag[blockIdx.x] = 1;
}

template <typename T>
__global__ void dense_block_apply_kernel(const float* __restrict__ D,
                                         const T* __restrict__ r,
                                         T* __restrict__ y, int ni, int ld) {
  const int row = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= ni) return;
  const float* d = D + (int64_t)row * ld;
  const float4* d4 = reinterpret_cast<const float4*>(d);
  const int n4 = ni & ~3;
  float acc = 0.f;
  for (int j = lane * 4; j < n4; j += 128) {
    const float4 v = d4[j >> 2];
    acc += v.x * (float)r[j] + v.y * (float)r[j + 1] + v.z * (float)r[j + 2] +
           v.w * (float)r[j + 3];
  }
  for (int j = n4 + lane; j < ni; j += 32) acc += d[j] * (float)r[j];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = (T)acc;
}

template <typename T>
int scatter(const T* vals, const int* rows, const int* cols, int nnz, int ni,
            int n_pad, T* D, void* stream) {
  int64_t total = (int64_t)nnz + (n_pad - ni);
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  dense_block_scatter_kernel<T><<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(vals, rows, cols, nnz,
                                                          ni, n_pad, D);
  return (int)cudaGetLastError();
}

template <typename T>
int gj(const T* a, T* out, int* flag, int batch, int b, void* stream) {
  if (batch == 0) return 0;
  if (b < 1 || b > 128) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)(b * b + b) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gj_pivot_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gj_pivot_inverse_kernel<T><<<batch, 512, smem, (cudaStream_t)stream>>>(
      a, out, flag, b);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const float* D, const T* r, T* y, int ni, int ld, void* stream) {
  if (ni == 0) return 0;
  const int threads = 256;  // 8 rows per block
  int64_t blocks = ((int64_t)ni * 32 + threads - 1) / threads;
  dense_block_apply_kernel<T><<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(D, r, y, ni, ld);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_dense_block_scatter_f32(const float* vals, const int* rows,
                                           const int* cols, int nnz, int ni,
                                           int n_pad, float* D, void* stream) {
  return scatter<float>(vals, rows, cols, nnz, ni, n_pad, D, stream);
}

extern "C" int ppt_dense_block_scatter_f64(const double* vals, const int* rows,
                                           const int* cols, int nnz, int ni,
                                           int n_pad, double* D, void* stream) {
  return scatter<double>(vals, rows, cols, nnz, ni, n_pad, D, stream);
}

extern "C" int ppt_gj_pivot_inverse_f32(const float* a, float* out, int* flag,
                                        int batch, int b, void* stream) {
  return gj<float>(a, out, flag, batch, b, stream);
}

extern "C" int ppt_gj_pivot_inverse_f64(const double* a, double* out,
                                        int* flag, int batch, int b,
                                        void* stream) {
  return gj<double>(a, out, flag, batch, b, stream);
}

extern "C" int ppt_dense_block_apply_f32(const float* D, const float* r,
                                         float* y, int ni, int ld,
                                         void* stream) {
  return apply<float>(D, r, y, ni, ld, stream);
}

extern "C" int ppt_dense_block_apply_f64(const float* D, const double* r,
                                         double* y, int ni, int ld,
                                         void* stream) {
  return apply<double>(D, r, y, ni, ld, stream);
}
