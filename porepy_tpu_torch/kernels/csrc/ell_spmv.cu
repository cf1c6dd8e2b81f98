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
// Design. A block owns a run of R consecutive rows; their val and col are
// one contiguous span of the (n, K) row-major arrays, which the block
// copies into shared memory with 16-byte cp.async copies (the span widened
// to whole 16-byte granules, which never leave the pages the span is on).
// Every thread then computes (row, b) pairs from shared memory, so val and
// col leave device memory once per call, not once per batch row b, and
// their loads are coalesced. R (a power of two, 32..128) is the largest
// that still gives every SM two blocks, so md 1/128's 16,969-row level
// runs in 266 blocks; a block has one thread per (row, b) pair up to 512,
// and each thread issues four gathers of x before it adds their products
// (in order). When R rows of a wide matrix do not fit in 48 KB of shared
// memory with R >= 32, the block reads val and col from device memory
// instead (same order, same result).
//
// Bound: bytes. The matrix is read once, x once per batch row (gathers hit
// L2), y written once: at md 1/128 (n = 18,157, K = 9) 1.45 MB in f32 for
// one vector, 0.43 us at 3.35 TB/s, so one call is launch-bound; at md
// 1/256 with 17 rows of x in f64 the bytes reach ~25 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSmemBudget = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Copy the bytes [begin, end) of device memory, widened to 16-byte granules,
// into smem; returns where begin landed.
__device__ const unsigned char* stage(const void* begin, const void* end,
                                      unsigned char* smem) {
  uintptr_t lo = (uintptr_t)begin & ~(uintptr_t)15;
  uintptr_t hi = ((uintptr_t)end + 15) & ~(uintptr_t)15;
  int granules = (int)((hi - lo) / 16);
  for (int g = threadIdx.x; g < granules; g += blockDim.x)
    cp_async16(smem + 16 * g, (const void*)(lo + 16 * (uintptr_t)g));
  return smem + ((uintptr_t)begin - lo);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ell_spmv_kernel(const T* __restrict__ val, const int* __restrict__ col,
                const T* __restrict__ x, const T* __restrict__ c,
                T* __restrict__ y, int n_rows, int K, int n_cols, int batch,
                int rows_per_block, int staged, int span_bytes, T sign) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - row0);
  const int64_t first = (int64_t)row0 * K, count = (int64_t)rows * K;
  const T* vs = val + first;
  const int* cs = col + first;
  if (staged) {
    vs = (const T*)stage(val + first, val + first + count, smem);
    cs = (const int*)stage(col + first, col + first + count, smem + span_bytes);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * batch; idx += blockDim.x) {
    const int r = idx % rows, bb = idx / rows;
    const T* v = vs + (int64_t)r * K;
    const int* cc = cs + (int64_t)r * K;
    const T* xb = x + (int64_t)bb * n_cols;
    T acc = T(0);
    int k = 0;
    // Four gathers in flight before their products are added, in order.
    for (; k + 4 <= K; k += 4) {
      const int j0 = cc[k], j1 = cc[k + 1], j2 = cc[k + 2], j3 = cc[k + 3];
      const T x0 = j0 < n_cols ? xb[j0] : T(0), x1 = j1 < n_cols ? xb[j1] : T(0);
      const T x2 = j2 < n_cols ? xb[j2] : T(0), x3 = j3 < n_cols ? xb[j3] : T(0);
      if (j0 < n_cols) acc = add_rn(acc, mul_rn(v[k], x0));
      if (j1 < n_cols) acc = add_rn(acc, mul_rn(v[k + 1], x1));
      if (j2 < n_cols) acc = add_rn(acc, mul_rn(v[k + 2], x2));
      if (j3 < n_cols) acc = add_rn(acc, mul_rn(v[k + 3], x3));
    }
    for (; k < K; ++k) {
      const int j = cc[k];
      if (j < n_cols) acc = add_rn(acc, mul_rn(v[k], xb[j]));
    }
    const int64_t o = (int64_t)bb * n_rows + row0 + r;
    acc = mul_rn(sign, acc);
    y[o] = c ? add_rn(c[o], acc) : acc;
  }
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

template <typename T>
int launch(const T* val, const int* col, const T* x, const T* c, T* y,
           int n_rows, int K, int n_cols, int batch, int sign, void* stream) {
  if ((int64_t)n_rows * batch == 0) return 0;
  int rows = 128;
  const int want = 2 * sm_count();
  while (rows > 32 && (n_rows + rows - 1) / rows < want) rows >>= 1;
  // Shared bytes of one span (values or columns), whole granules plus one.
  const int64_t val_span = ((int64_t)rows * K * (int64_t)sizeof(T) + 31) / 16 * 16;
  const int64_t col_span = ((int64_t)rows * K * 4 + 31) / 16 * 16;
  const int staged = K > 0 && val_span + col_span <= kSmemBudget;
  const int smem = staged ? (int)(val_span + col_span) : 0;
  const int blocks = (n_rows + rows - 1) / rows;
  // One thread per (row, batch row) pair, up to 512 a block: a batched call
  // keeps more gathers in flight per staged span.
  int64_t pairs = (int64_t)rows * batch;
  const int threads = pairs >= kMaxThreads ? kMaxThreads : (int)((pairs + 31) / 32 * 32);
  ell_spmv_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      val, col, x, c, y, n_rows, K, n_cols, batch, rows, staged, (int)val_span,
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
