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
// - ppt_gj_pivot_inverse: the inverse of each b x b matrix of a batch (b <= 128),
//   one thread block per matrix, by Gauss-Jordan elimination with partial
//   pivoting inside the matrix. The TPU inverted 1024-row pivots with XLA's
//   LU; a pivot that size does not fit one SM, so the blocked driver takes
//   128-row pivots and this kernel inverts them. Pivoting inside the pivot
//   block matches the LU with partial pivoting of jax.numpy.linalg.inv, so a
//   pivot block with a zero leading entry still inverts. flag[m] is set to 1
//   (never cleared) when matrix m has a zero or non-finite pivot or a
//   non-finite inverse entry; the caller reads it once per build.
//
//   Bound: the b elimination steps are a serial chain. The arithmetic (2 b^3
//   = 4.2 MFLOP at b = 128) takes the card 0.063 us and one SM ~8 us; a grid
//   sync a step (~1.5-1.8 us) would cost more than a step's work, so one
//   block holds the matrix. Design, for the chain's latency:
//   * the matrix lives in registers: warp w owns the rows i = w (mod NW),
//     lane l the columns j = l (mod 32), with a 128 x 128 identity pad
//     around a smaller matrix (blockdiag(A, I) has the inverse
//     blockdiag(A^-1, I); only A's rows are pivot candidates, so the pad
//     never pivots and one code path serves every b);
//   * rows never move: a position table in shared memory says which row
//     holds each logical position. The pivot is the first, by position, of
//     the largest |A[i][k]| among the rows not yet eliminated (the rule of
//     LAPACK's i?amax); NaN never wins, and a pivot whose candidates are all
//     NaN is flagged. Warp 0 finds it from column k, which the owners of
//     column k published at the end of the step before, and records the
//     swap of positions (the other warps do no redundant search);
//   * a step is three barriers: the pivot is published; the pivot row,
//     scaled by 1/p (a correctly rounded reciprocal) in its owner warp's
//     registers, is published; every thread updates its registers (A[i][j]
//     -= m_i r_j by fused multiply-add, column k becoming the Gauss-Jordan
//     in-place column; only the owner warp tests for the pivot row) and the
//     owners of column k + 1 publish it for the next search;
//   * out: the inverse is written from registers, the pivoting undone in
//     the addresses (out[position of row i][pivot row of column j] = S[i][j]).
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
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t<float>(float a, float b, float c) { return fmaf(a, b, c); }
template <>
__device__ __forceinline__ double fma_t<double>(double a, double b, double c) { return fma(a, b, c); }

constexpr int kGjN = 128;  // the padded matrix; b <= kGjN

template <typename T>
__device__ __forceinline__ T rcp_rn(T x);
template <>
__device__ __forceinline__ float rcp_rn<float>(float x) { return __frcp_rn(x); }
template <>
__device__ __forceinline__ double rcp_rn<double>(double x) { return __drcp_rn(x); }

// NW warps a block (16 in f32, 8 in f64, so that a thread's 32 or 64 entries
// stay in registers).
template <typename T, int NW>
__global__ void __launch_bounds__(NW * 32)
gj_pivot_inverse_kernel(const T* __restrict__ a, T* __restrict__ out,
                        int* __restrict__ flag, int b) {
  constexpr int RS = kGjN / NW;  // rows a thread
  constexpr int CS = kGjN / 32;  // columns a thread
  __shared__ T colk[2][kGjN];    // column k of the live matrix, one step ahead
  __shared__ T rowp[kGjN];       // the scaled pivot row of step k
  __shared__ int pos_of[kGjN];   // logical position of each row
  __shared__ int row_at[kGjN];   // the row at each logical position
  __shared__ int s_pr;           // the pivot row of step k
  __shared__ T s_pv;             // and its value
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * b * b;
  bool bad = false;

  T A[RS][CS];
#pragma unroll
  for (int s = 0; s < RS; ++s) {
    const int i = w + NW * s;
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      const int j = lane + 32 * c;
      A[s][c] = (i < b && j < b) ? a[base + (int64_t)i * b + j] : T(i == j ? 1 : 0);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < RS; ++s) colk[0][w + NW * s] = A[s][0];
  }
  if (threadIdx.x < kGjN) {
    pos_of[threadIdx.x] = threadIdx.x;
    row_at[threadIdx.x] = threadIdx.x;
  }
  __syncthreads();

  for (int k = 0; k < b; ++k) {
    const int cur = k & 1;
    if (w == 0) {
      // The pivot, found by warp 0: the largest |A[r][k]| over the rows r <
      // b at a position >= k, the first by position among equals (key =
      // position * kGjN + row). It records the swap of positions.
      T best = T(-1);
      int key = 0x7fffffff;
#pragma unroll
      for (int q = 0; q < kGjN / 32; ++q) {
        const int r = lane + 32 * q;
        if (r < b) {
          const int ps = pos_of[r];
          const T v = fabs(colk[cur][r]);
          const int kk = ps * kGjN + r;
          if (ps >= k && (v > best || (v == best && kk < key))) {
            best = v;
            key = kk;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int ok = __shfl_xor_sync(0xffffffffu, key, off);
        if (ob > best || (ob == best && ok < key)) {
          best = ob;
          key = ok;
        }
      }
      if (lane == 0) {
        // Every candidate NaN: the row at position k, whose pivot is flagged.
        const int pp = (key == 0x7fffffff) ? k : key / kGjN;
        const int pr = (key == 0x7fffffff) ? row_at[k] : key % kGjN;
        const int rk = row_at[k];
        row_at[k] = pr;
        row_at[pp] = rk;
        pos_of[rk] = pp;
        pos_of[pr] = k;
        s_pr = pr;
        s_pv = colk[cur][pr];
      }
    }
    __syncthreads();  // the pivot is known
    const int pr = s_pr;
    const T pv = s_pv;
    const T inv = rcp_rn(pv);
    if (threadIdx.x == 0 && !(fabs(pv) > T(0) && isfinite(pv))) bad = true;
    // Every access to A below has a constant index once the loops are
    // unrolled (selects, no branch around an access), so that A stays in
    // registers. Only the pivot row's warp scales it and keeps it out of
    // the update.
    const bool owner = w == pr % NW;
    const int sp = pr / NW;
    if (owner) {
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int j = lane + 32 * c;
        T pub = T(0);
#pragma unroll
        for (int s = 0; s < RS; ++s) {
          const T v = (j == k) ? inv : A[s][c] * inv;
          A[s][c] = (s == sp) ? v : A[s][c];
          pub = (s == sp) ? v : pub;
        }
        rowp[j] = pub;
      }
    }
    __syncthreads();  // the pivot row is published
    T r[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) r[c] = rowp[lane + 32 * c];
    if (owner) {
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        const T m = colk[cur][w + NW * s];
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          const T x = (lane + 32 * c == k) ? T(0) : A[s][c];
          A[s][c] = (s != sp) ? fma_t(-m, r[c], x) : A[s][c];
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        const T m = colk[cur][w + NW * s];
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          const T x = (lane + 32 * c == k) ? T(0) : A[s][c];
          A[s][c] = fma_t(-m, r[c], x);
        }
      }
    }
    // Look ahead: the owners of column k + 1 publish it for the next search.
    const int k1 = k + 1;
    if (k1 < b && lane == (k1 & 31)) {
      const int c1 = k1 >> 5;
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        T v = A[s][0];
#pragma unroll
        for (int c = 1; c < CS; ++c) v = (c == c1) ? A[s][c] : v;
        colk[cur ^ 1][w + NW * s] = v;
      }
    }
    __syncthreads();  // column k + 1 is published; every thread has read the pivot row
  }

  // inv(A)[position of row i][pivot row of column j] = S[i][j]: the row
  // swaps undone in the addresses.
#pragma unroll
  for (int s = 0; s < RS; ++s) {
    const int i = w + NW * s;
    const int64_t row = base + (int64_t)pos_of[i < b ? i : 0] * b;
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      const int j = lane + 32 * c;
      const T v = A[s][c];
      const bool mine = i < b && j < b;
      bad = bad || (mine && !isfinite(v));
      if (mine) out[row + row_at[j]] = v;
    }
  }
  if (bad) flag[blockIdx.x] = 1;
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

template <typename T, int NW>
int gj(const T* a, T* out, int* flag, int batch, int b, void* stream) {
  if (batch == 0) return 0;
  if (b < 1 || b > kGjN) return (int)cudaErrorInvalidValue;
  gj_pivot_inverse_kernel<T, NW><<<batch, NW * 32, 0, (cudaStream_t)stream>>>(a, out, flag, b);
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
  return gj<float, 16>(a, out, flag, batch, b, stream);
}

extern "C" int ppt_gj_pivot_inverse_f64(const double* a, double* out,
                                        int* flag, int batch, int b,
                                        void* stream) {
  return gj<double, 8>(a, out, flag, batch, b, stream);
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
