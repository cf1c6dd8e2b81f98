// The padded-row (ELL) rows of K1 (ell_spmv.cu) and K19 (halo_spmv.cu):
// staging a block's rows in shared memory, one row's sum, and the tiling.
//
// Both kernels include this header, so a row is summed and rounded by the
// same code in both: from 0 in slot order k = 0..K-1, every product rounded
// before it is added (no multiply-add is contracted), padding slots skipped.
// A K19 shard that holds every row therefore gives K1's result bit for bit.
//
// Staging. A block owns R consecutive rows; their val and col are one
// contiguous span of the (n, K) row-major arrays, copied into shared memory
// with 16-byte cp.async copies (the span widened to whole 16-byte granules,
// which never leave the pages the span is on). R (a power of two, 32..128)
// is the largest that still gives every SM two blocks. When R rows do not
// fit in 48 KB of shared memory, the rows are read from device memory
// instead (same order, same result).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The block's rows [row0, row0 + rows) of val and col: staged in smem (the
// values first, the columns span_bytes after) and waited for, or, when not
// staged, where they lie. Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void block_rows(const T* val, const int* col, int row0,
                                           int rows, int K, int staged,
                                           int span_bytes, unsigned char* smem,
                                           const T** vs, const int** cs) {
  const int64_t first = (int64_t)row0 * K, count = (int64_t)rows * K;
  *vs = val + first;
  *cs = col + first;
  if (staged) {
    *vs = (const T*)stage(val + first, val + first + count, smem);
    *cs = (const int*)stage(col + first, col + first + count, smem + span_bytes);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
}

// The entries a row reads: x[j] for j < n; any other column is padding.
template <typename T>
struct Dense {
  const T* x;
  int n;
  __device__ __forceinline__ bool real(int j) const { return j < n; }
  __device__ __forceinline__ T operator()(int j) const { return x[j]; }
};

// A row shard's entries: x_own below n_own, then the received halo.
template <typename T>
struct Split {
  const T* own;
  const T* halo;
  int n_own, n_halo;
  __device__ __forceinline__ bool real(int j) const { return j - n_own < n_halo; }
  __device__ __forceinline__ T operator()(int j) const {
    return j < n_own ? own[j] : halo[j - n_own];
  }
};

// sum_k v[k] * x(c[k]) from 0 in slot order, four gathers in flight before
// their products are added (in order).
template <typename T, typename Src>
__device__ __forceinline__ T row_sum(const T* v, const int* cc, int K, const Src& x) {
  T acc = T(0);
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    const int j0 = cc[k], j1 = cc[k + 1], j2 = cc[k + 2], j3 = cc[k + 3];
    const bool r0 = x.real(j0), r1 = x.real(j1), r2 = x.real(j2), r3 = x.real(j3);
    const T x0 = r0 ? x(j0) : T(0), x1 = r1 ? x(j1) : T(0);
    const T x2 = r2 ? x(j2) : T(0), x3 = r3 ? x(j3) : T(0);
    if (r0) acc = add_rn(acc, mul_rn(v[k], x0));
    if (r1) acc = add_rn(acc, mul_rn(v[k + 1], x1));
    if (r2) acc = add_rn(acc, mul_rn(v[k + 2], x2));
    if (r3) acc = add_rn(acc, mul_rn(v[k + 3], x3));
  }
  for (; k < K; ++k) {
    const int j = cc[k];
    if (x.real(j)) acc = add_rn(acc, mul_rn(v[k], x(j)));
  }
  return acc;
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

// Rows a block, blocks, and the shared bytes of n_rows rows of K slots of
// elem-byte values.
struct Tiling {
  int rows, blocks, staged, val_span, smem;
};

inline Tiling ell_tiling(int n_rows, int K, int elem) {
  Tiling t;
  t.rows = 128;
  const int want = 2 * sm_count();
  while (t.rows > 32 && (n_rows + t.rows - 1) / t.rows < want) t.rows >>= 1;
  // Shared bytes of one span (values or columns), whole granules plus one.
  const int64_t val_span = ((int64_t)t.rows * K * elem + 31) / 16 * 16;
  const int64_t col_span = ((int64_t)t.rows * K * 4 + 31) / 16 * 16;
  t.staged = K > 0 && val_span + col_span <= kSmemBudget;
  t.val_span = (int)val_span;
  t.smem = t.staged ? (int)(val_span + col_span) : 0;
  t.blocks = (n_rows + t.rows - 1) / t.rows;
  return t;
}

}  // namespace
