// K11: inverses of a batch of dense blocks of one size, f64.
//
// Replaces porepy_tpu/numerics/linalg/matrix_operations.py:105-142
// (_invert_blocks_batched): the size-grouped batched inverse behind
// invert_diagonal_blocks, which the TPU package pins to its host CPU because
// the TPU has no f64 LU. Here each block of the (B, n, n) batch is inverted
// on the card by the Gauss-Jordan elimination with partial pivoting of the
// plain version (kernels/reference.py, block_inverse) on [A | I]:
//
//   per column k: p = the first row i >= k of largest |M_ik|, swap rows k
//   and p, divide row k by its pivot, and subtract M_ik times row k from
//   every other row i; the right half of M is then the inverse.
//
// In place. Only n of [A | I]'s 2n columns carry anything at a time: left
// of k the columns are unit vectors, and a column of the right half stays a
// unit vector until its row is the pivot row. So the kernel keeps an n x n
// matrix W: column k holds the active column of A until step k and, from
// step k on, the column of the inverse whose unit row was the pivot row
// (1 / pivot in that row, 0 - M_ik / pivot in the others). Rows never move:
// a table of logical positions (the plain version's swapped order) takes
// the swaps, the pivot is the first row of largest |W_ik| in that order, so
// pivots and ties are the plain version's, and the output puts rows and
// columns in their places. Each entry is computed as the plain version
// computes it: the pivot row divided by the pivot (a division, not a
// multiplication by a reciprocal; a zero entry is multiplied by the pivot,
// which gives the same signed zero without the division's slow path: the
// biot region matrices are 87-96% zeros), then the product and the
// difference rounded apart (__dmul_rn, __dsub_rn, no fused multiply-add).
// So the result equals the plain version's to the bit wherever they take
// the same pivots (zeros may differ in sign).
//
// One launch a batch; no atomics, so the result does not depend on the
// schedule. A step: every warp finds the pivot on its own (integer keys,
// three warp reductions), the pivot row's owners stage it divided by the
// pivot, a barrier, every entry's update, column k + 1 staged, a barrier.
// Three routes by n:
//  - n <= 32: a warp a matrix (8 a block, __syncwarp only); lane (ty, tx)
//    of 4 x 8 holds entries (ty + 4 a, tx + 8 b) in registers.
//  - n <= 96: a block of 16 x 16 threads a matrix, thread (ty, tx) holding
//    entries (ty + 16 a, tx + 16 b) in registers. On both register routes
//    step k = TX kk + kx is unrolled over kk, so column k's entries are a
//    fixed register of the threads with tx = kx: an entry's update is one
//    multiply and one subtraction, with no select and no index arithmetic.
//  - n > 96: W in shared memory (n x ld, ld = n rounded up to odd, so a
//    column's entries fall in distinct banks) while it fits the 227 KB a
//    block may have (n <= 167), else in a device workspace of B n ld
//    doubles that the wrapper allocates; the same 16 x 16 thread map.
//
// A zero pivot divides by zero and leaves inf/NaN in the block's output,
// as the LU inverse of a singular matrix does; nothing flags or hides it.
//
// Bound: bytes at the real sizes. 1,374 blocks of 81 move 2 x 72 MB (the
// batch in, the inverses out), 0.043 ms at 3.35 TB/s, and their 2 n^3
// operations, 1.46 GFLOP, take as long at 34 TFLOP/s in f64. A step's chain
// (the search, the division, two barriers) is serial, so the time follows
// the steps and the instructions an entry issues (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


namespace {

// Dynamic shared memory a block may take: sm_90's opt-in limit of 232,448
// bytes, less 1 KB for alignment (as K10).
constexpr int kSmemMax = 231424;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;      // a block's 16 x 16 threads above n = 32
constexpr int kTileMax = 96;   // the largest n a block holds in registers

// v / piv. A zero v takes the division's slow path, so it is v * piv there:
// the same signed zero for a finite nonzero pivot.
__device__ __forceinline__ double pivot_quotient(double v, double piv) {
  return v == 0.0 && fabs(piv) > 0.0 && fabs(piv) < INFINITY ? __dmul_rn(v, piv) : v / piv;
}

// The pivot of step k: the least logical position among the rows of
// largest |W_rk| (NaN counting as largest) at positions >= k, for every lane
// of the warp. Each lane offers the best of its rows lane + 32 q (column
// entries col[r * stride]); |v|'s bits order as |v| does, so the warp
// reduces integer keys: the high word, the low word, then the position.
__device__ __forceinline__ int pivot_position(const double* col, int stride, const int* lp, int n,
                                              int k, int lane) {
  unsigned long long best = 0;  // |v|'s bits + 1; 0: no row offered
  unsigned bl = 0xffffffffu;
  for (int r = lane; r < n; r += 32) {
    const int l = lp[r];
    if (l >= k) {
      const unsigned long long key =
          (unsigned long long)(__double_as_longlong(col[r * stride]) & 0x7fffffffffffffffLL) + 1ull;
      if (key > best || (key == best && (unsigned)l < bl)) {
        best = key;
        bl = (unsigned)l;
      }
    }
  }
  const unsigned hi = (unsigned)(best >> 32), lo = (unsigned)best;
  const unsigned mhi = __reduce_max_sync(kFull, hi);
  const unsigned mlo = __reduce_max_sync(kFull, hi == mhi ? lo : 0u);
  return (int)__reduce_min_sync(kFull, hi == mhi && lo == mlo ? bl : 0xffffffffu);
}

// -- n <= 96: the matrix in registers ----------------------------------------

// Thread (ty, tx) of a matrix's TY x TX threads holds W's entries (ty + TY a,
// tx + TX b), a < NA, b < NB, in registers. TY x TX = 32 (n <= 32): a warp a
// matrix, 256 / 32 of them a block, __syncwarp; 16 x 16: a block a matrix.
// A step: every warp finds the pivot in the staged column k, the pivot row's
// owners stage it (divided by the pivot), a barrier, every thread updates
// its entries and the owners of column k + 1 stage it, a barrier.
template <int TY, int TX, int NA, int NB>
__global__ void __launch_bounds__(256, TY * TX == 32 && NA * NB <= 15 ? 4 : 2)
    block_inverse_tile(const double* __restrict__ a, double* __restrict__ out, int batch, int n) {
  constexpr int kT = TY * TX;
  constexpr int kM = 256 / kT;
  extern __shared__ double smem[];
  const int slot = threadIdx.x / kT;
  const int t = threadIdx.x % kT;
  const int tx = t % TX, ty = t / TX;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kM + slot;
  // A warp a matrix syncs alone: a warp without one leaves. A block a
  // matrix always has one.
  if (b >= batch) return;

  // Per matrix: column k before the step, the pivot row divided by the
  // pivot (1 / pivot at k), the logical position of each row, the row at
  // each position, and the inverse's column that W's column c holds.
  double* fst = smem + slot * (2 * n + (3 * n + 1) / 2);
  double* stage = fst + n;
  int* lp = (int*)(stage + n);
  int* pos = lp + n;
  int* ck = pos + n;
  const double* A = a + b * n * n;
  double* O = out + b * n * n;

  double w[NA][NB];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = ty + TY * i;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = tx + TX * j;
      w[i][j] = r < n && c < n ? A[r * n + c] : 0.0;
    }
    if (tx == 0 && r < n) fst[r] = w[i][0];
  }
  for (int i = t; i < n; i += kT) {
    lp[i] = i;
    pos[i] = i;
  }
  if (kT == 32) __syncwarp(); else __syncthreads();

  // Step k = TX kk + kx: column k sits in w[.][kk] of the threads with
  // tx = kx, so its handling needs no per-entry select.
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
#pragma unroll 1
    for (int kx = 0; kx < TX; ++kx) {
      const int k = TX * kk + kx;
      if (k >= n) break;
      // Every warp finds the pivot on its own.
      const int bl = pivot_position(fst, 1, lp, n, k, lane);
      const int sp = pos[bl], sk = pos[k];
      const double piv = fst[sp];
      const bool owns_sp = ty == sp % TY;
      const int ia = sp / TY;
      if (owns_sp) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int c = tx + TX * j;
          double v = 0.0;
#pragma unroll
          for (int i = 0; i < NA; ++i) v = i == ia ? w[i][j] : v;
          if (c < n) stage[c] = c == k ? 1.0 / piv : pivot_quotient(v, piv);
        }
      }
      double f[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) f[i] = ty + TY * i < n ? fst[ty + TY * i] : 0.0;
      if (kT == 32) __syncwarp(); else __syncthreads();

      double sb[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) sb[j] = tx + TX * j < n ? stage[tx + TX * j] : 0.0;
      // Every entry, then column k (0 - f / pivot) and row sp (its staged
      // values) over it. Entries outside the matrix keep 0 (f or sb is 0).
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) w[i][j] = __dsub_rn(w[i][j], __dmul_rn(f[i], sb[j]));
      if (tx == kx) {
#pragma unroll
        for (int i = 0; i < NA; ++i) w[i][kk] = __dsub_rn(0.0, __dmul_rn(f[i], sb[kk]));
      }
      if (owns_sp) {
#pragma unroll
        for (int i = 0; i < NA; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) w[i][j] = i == ia ? sb[j] : w[i][j];
      }
      // Column k + 1 for the next step.
      if (kx + 1 < TX ? tx == kx + 1 : tx == 0 && kk + 1 < NB) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int r = ty + TY * i;
          if (r < n) fst[r] = kx + 1 < TX ? w[i][kk] : w[i][kk + 1 < NB ? kk + 1 : kk];
        }
      }
      if (t == 0) {
        lp[sp] = k;
        lp[sk] = bl;
        pos[k] = sp;
        pos[bl] = sk;
        ck[k] = sp;
      }
      if (kT == 32) __syncwarp(); else __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = ty + TY * i;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = tx + TX * j;
      if (r < n && c < n) O[lp[r] * n + ck[c]] = w[i][j];
    }
  }
}

// -- n > 96: the matrix in shared memory or a workspace -------------------------

// NB > 0: a thread's columns tx + 16 b, b < NB, their staged pivot-row
// entries held in registers; NB = 0: any n, read from shared memory.
template <int NB>
__global__ void __launch_bounds__(kTile * kTile)
    block_inverse_block(const double* __restrict__ a, double* __restrict__ out,
                        double* __restrict__ work, int n, int ld) {
  extern __shared__ double smem[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int tx = tid % kTile, ty = tid / kTile;

  double* W = work ? work + b * n * ld : smem;
  double* stage = work ? smem : smem + n * ld;  // the pivot row / pivot; 1 / pivot at k
  double* fst = stage + n;                      // column k before the step
  int* lp = (int*)(fst + n);                    // logical position of each row
  int* pos = lp + n;                            // the row at each logical position
  int* kc = pos + n;                            // the column of W holding inverse column c
  const double* A = a + b * n * n;
  double* O = out + b * n * n;

  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n;
    W[r * ld + (e - r * n)] = A[e];
  }
  for (int r = tid; r < n; r += nt) {
    lp[r] = r;
    pos[r] = r;
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // Every warp finds the pivot on its own.
    const int bl = pivot_position(W + k, ld, lp, n, k, lane);
    const int sp = pos[bl], sk = pos[k];
    const double piv = W[sp * ld + k];
    for (int i = tid; i < n; i += nt) {
      stage[i] = i == k ? 1.0 / piv : pivot_quotient(W[sp * ld + i], piv);
      fst[i] = W[i * ld + k];
    }
    __syncthreads();

    if (NB > 0) {
      double sb[NB > 0 ? NB : 1];
#pragma unroll
      for (int j = 0; j < NB; ++j) sb[j] = tx + kTile * j < n ? stage[tx + kTile * j] : 0.0;
      for (int r = ty; r < n; r += kTile) {
        double* Wr = W + r * ld;
        const double fr = fst[r];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int c = tx + kTile * j;
          if (c < n)
            Wr[c] = r == sp ? sb[j]
                            : __dsub_rn(c == k ? 0.0 : Wr[c], __dmul_rn(fr, sb[j]));
        }
      }
    } else {
      for (int r = ty; r < n; r += kTile) {
        double* Wr = W + r * ld;
        const double fr = fst[r];
        for (int c = tx; c < n; c += kTile)
          Wr[c] = r == sp ? stage[c] : __dsub_rn(c == k ? 0.0 : Wr[c], __dmul_rn(fr, stage[c]));
      }
    }
    if (tid == 0) {
      lp[sp] = k;
      lp[sk] = bl;
      pos[k] = sp;
      pos[bl] = sk;
      kc[sp] = k;
    }
    __syncthreads();
  }

  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n;
    O[e] = W[pos[i] * ld + kc[e - i * n]];
  }
}

template <int TY, int TX, int NA, int NB>
int launch_tile(const double* a, double* out, int batch, int n, cudaStream_t s) {
  constexpr int kM = 256 / (TY * TX);
  const int blocks = (batch + kM - 1) / kM;
  const size_t smem = sizeof(double) * kM * (2 * (size_t)n + (3 * (size_t)n + 1) / 2);
  block_inverse_tile<TY, TX, NA, NB><<<blocks, 256, smem, s>>>(a, out, batch, n);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_block(const double* a, double* out, double* work, int batch, int n, int ld,
                 size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      block_inverse_block<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_inverse_block<NB><<<batch, kTile * kTile, smem, s>>>(a, out, work, n, ld);
  return (int)cudaGetLastError();
}

}  // namespace

// The route and its shared memory: n <= 96 the matrix in registers (the
// staged rows and tables, 28 n bytes a matrix); else W (n x ld, ld = n | 1)
// and the staged rows and tables in shared memory while that fits
// kSmemMax, else W in `work` (batch, n, ld), which must then be given.
extern "C" int ppt_block_inverse_f64(const double* a, double* out, double* work,
                                     int batch, int n, void* stream) {
  if (batch < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 32) {
    switch ((n + 3) / 4) {
      case 1: return launch_tile<4, 8, 1, 1>(a, out, batch, n, s);
      case 2: return launch_tile<4, 8, 2, 1>(a, out, batch, n, s);
      case 3: return launch_tile<4, 8, 3, 2>(a, out, batch, n, s);
      case 4: return launch_tile<4, 8, 4, 2>(a, out, batch, n, s);
      case 5: return launch_tile<4, 8, 5, 3>(a, out, batch, n, s);
      case 6: return launch_tile<4, 8, 6, 3>(a, out, batch, n, s);
      case 7: return launch_tile<4, 8, 7, 4>(a, out, batch, n, s);
      default: return launch_tile<4, 8, 8, 4>(a, out, batch, n, s);
    }
  }
  if (n <= kTileMax) {
    switch ((n + kTile - 1) / kTile) {
      case 3: return launch_tile<kTile, kTile, 3, 3>(a, out, batch, n, s);
      case 4: return launch_tile<kTile, kTile, 4, 4>(a, out, batch, n, s);
      case 5: return launch_tile<kTile, kTile, 5, 5>(a, out, batch, n, s);
      default: return launch_tile<kTile, kTile, 6, 6>(a, out, batch, n, s);
    }
  }
  const int ld = n | 1;
  const size_t tables = 28 * (size_t)n;
  const size_t in_smem = tables + 8 * (size_t)n * ld;
  if (in_smem <= (size_t)kSmemMax) {
    switch ((n + kTile - 1) / kTile) {  // 7..11: n = 97..167
      case 7: return launch_block<7>(a, out, nullptr, batch, n, ld, in_smem, s);
      case 8: return launch_block<8>(a, out, nullptr, batch, n, ld, in_smem, s);
      case 9: return launch_block<9>(a, out, nullptr, batch, n, ld, in_smem, s);
      case 10: return launch_block<10>(a, out, nullptr, batch, n, ld, in_smem, s);
      default: return launch_block<11>(a, out, nullptr, batch, n, ld, in_smem, s);
    }
  }
  if (!work || tables > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  return launch_block<0>(a, out, work, batch, n, ld, tables, s);
}
