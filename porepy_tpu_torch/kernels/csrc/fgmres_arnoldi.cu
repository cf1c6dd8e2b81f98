// K4: one Arnoldi step of the inner FGMRES (everything but the
// preconditioner), fgmres_arnoldi.
//
// Replaces porepy_tpu/numerics/linalg/device_solver.py:179-212 (_fgmres's
// arnoldi_cond and arnoldi less z = M(V[j])). For the column j = *j_dev of
// a cycle of `restart` columns (V (restart + 1, n), Z (restart, n), Ht
// (restart, restart + 1): Ht[j] is column j of the Hessenberg matrix):
//
//   w = A z (A the solve's ELL matrix, each row summed as K1 sums it,
//        ell_rows.cuh), Z[j] = z;
//   h = V[:j+1] w, w -= V[:j+1]^T h, h2 = V[:j+1] w, w -= V[:j+1]^T h2
//        (CGS2), hj1 = |w|, V[j + 1] = w / max(hj1, 1e-30);
//   Ht[j][:j+1] = h + h2, Ht[j][j+1] = hj1;
//   the j old Givens rotations applied to Ht[j], the new one formed into
//        cs[j], sn[j], g[j], g[j + 1] rotated, *flag = (j + 1 < restart)
//        && |g[j + 1]| > *atol and *j_dev = j + 1.
//
// A j outside [0, restart) only clears the flag. Before this kernel a step
// was a K1 launch, 15 small torch launches (4 GEMVs, the norm and the
// copies) and a one-thread Givens kernel behind a custom operator, ~17
// launches and ~115-235 us of host time for ~1 us of work.
//
// Design. One persistent cooperative grid (cudaLaunchCooperativeKernel:
// the wrapper refuses any other launch), blocks of 128 threads, as many as
// are co-resident and at most one per 128-row tile; a block owns the same
// tiles in every phase. Three grid syncs a step:
//
//   w = A z and Z[j] for the block's tiles, V[:j+1]'s tile staged in shared
//        memory (the block's first tile), the tile partials of V w;
//        | grid sync |
//   every block finishes h, w -= V^T h, the tile partials of V w';
//        | grid sync |
//   every block finishes h2, w -= V^T h2, the tile partials of |w|^2;
//        | grid sync |
//   every block finishes |w|^2 and writes V[j + 1] for its tiles; block 0
//        writes Ht[j] and runs the Givens recurrence (sequential in i, one
//        thread, from shared memory), then the flag and j + 1.
//
// w stays in shared memory for a block's first tile and goes to device
// memory once, as V[j + 1]; V is read from device memory once a step. A
// block with more than one tile keeps the others' w in V[j + 1]'s row and
// reads their V from device memory. The V tile is dynamic shared memory,
// restart x 128 values: 36 KB in f32 at restart 70, 72 KB in f64 (above 48
// KB, so the wrapper opts in with cudaFuncSetAttribute; re-reading V in f64
// would cost three more passes over (j + 1) x n x 8 bytes a step, while the
// f64 grid still holds 3 blocks an SM, 396 tiles, above md 1/256's 540 in
// f32 only). Past 160 KB (restart > 160 in f64) nothing is staged and every
// tile reads V from device memory.
//
// Reductions: a tile's partial sums in block_partials' tree (entry t adds
// entry t + s for s = 64 .. 1: lane l forms the s = 64 and s = 32 levels of
// entries l and l + 32 from four products, the warp the rest by shuffles),
// one warp a row; then every block that needs a sum finishes the tile
// partials in finish's order (lane l sums partials t, t + 128, ... from 0
// for t = l, l + 32, l + 64, l + 96, then the same tree), two rows a warp
// with their loads in flight together. No atomics: a run repeats bit for
// bit. Every operation is rounded on its own (no multiply-add contracted),
// so reference.fgmres_arnoldi, which rounds the same operations in the
// same order, gives the same bits. Arrays written inside the kernel are
// read through plain pointers: the read-only cache is not coherent across
// the grid syncs.
//
// The sharded solve (red a DofShard) runs the same code as four launches a
// step around its three all-reduces (modes kDots, kUpdate, kNorm,
// kNormalize): w from the caller's K19 matvec, kept in V[j + 1]'s row
// between launches; each of the first three launches ends with block 0
// finishing the rank's partials into `sums`, which the host all-reduces
// before the next launch reads them. On one rank that is the fused step's
// arithmetic, so the bits are the same.
//
// Bound: bytes. At md 1/128 (n = 18,157, K = 9) a step reads the ELL
// matrix (1.31 MB in f32), z and V[:j+1] once and writes Z[j] and V[j + 1]:
// ~1.5 MB + (j + 1) x 72.6 KB, 0.5 us at j = 0, 2.0 us at j = 69. What sets
// the time is latency: three grid syncs (~1.5-1.8 us each), the finishes'
// L2 loads and the matvec's dependent gathers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;  // rows a tile and threads a block (reference.KRYLOV_BLOCK)
constexpr int kWarps = kTile / 32;
// Rows a warp finishes at once, their loads in flight together (PERF.md
// section 6 has arnoldi_check.py's times of 2, 4 and 8).
constexpr int kBatch = 2;
constexpr int64_t kStageMax = 160 * 1024;  // shared bytes the V tile may take

// The launch table (int64 words; ops.FgmresArnoldi builds it once a cycle).
enum {
  kVal, kCol, kV, kZ, kHt, kCs, kSn, kG, kJ, kAtol, kFlag, kPartials, kSums,
  kK, kN, kRestart, kGrid, kTableLen
};
// The whole step, or one of its four phases around the sharded solve's
// all-reduces (ops.ARNOLDI_* in Python).
enum { kFused = 0, kDots = 1, kUpdate = 2, kNorm = 3, kNormalize = 4 };

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T>
struct Args {
  const T* val;
  const int* col;
  const T* z;
  const T* w_in;  // the split modes' A z
  T* V;
  T* Z;
  T* Ht;
  T* cs;
  T* sn;
  T* g;
  int* j_dev;
  const T* atol;
  int* flag;
  T* partials;  // (2 (restart + 1) + 1, nb): h, h2, |w|^2
  T* sums;      // (2 (restart + 1) + 1,): the split modes' finished sums
  int K, n, nb, restart, stage;
};

// A tile of 128 rows: V[r][t] = v[r * ld + t], w[t], `valid` rows below n.
template <typename T>
struct Tile {
  const T* v;
  int64_t ld;
  T* w;
  int valid;
  __device__ __forceinline__ T vat(int r, int t) const { return t < valid ? v[r * ld + t] : T(0); }
  __device__ __forceinline__ T wat(int t) const { return t < valid ? w[t] : T(0); }
};

// Tile `tile` of step j: staged (V and w in shared memory) or in device
// memory (w in V[j + 1]'s row).
template <typename T>
__device__ __forceinline__ Tile<T> tile_of(const Args<T>& a, int j, int tile, bool staged, const T* v_s,
                                           T* w_s) {
  Tile<T> tl;
  const int row0 = tile * kTile;
  tl.valid = min(kTile, a.n - row0);
  if (staged) {
    tl.v = v_s;
    tl.ld = kTile;
    tl.w = w_s;
  } else {
    tl.v = a.V + row0;
    tl.ld = a.n;
    tl.w = a.V + (int64_t)(j + 1) * a.n + row0;
  }
  return tl;
}

// s = 16 .. 1 of the tree: lane t adds lane t + s; the sum in lane 0.
template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
  for (int s = 16; s > 0; s >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, s));
  return v;
}

// Lane l's entry after the s = 64 and s = 32 levels of the tree over
// p[t] = x[t] y[t]: (p[l] + p[l + 64]) + (p[l + 32] + p[l + 96]); x_k is
// x[l + 32 k].
template <typename T>
__device__ __forceinline__ T lane_entry(T x0, T x1, T x2, T x3, T y0, T y1, T y2, T y3) {
  return add_rn(add_rn(mul_rn(x0, y0), mul_rn(x2, y2)), add_rn(mul_rn(x1, y1), mul_rn(x3, y3)));
}

// The tile's partials of V[r] w, r < m, into partials rows row0 + r, column tile.
template <typename T>
__device__ void tile_dots(const Tile<T>& tl, int m, T* partials, int row0, int nb, int tile) {
  const int lane = threadIdx.x & 31;
  const T w0 = tl.wat(lane), w1 = tl.wat(lane + 32), w2 = tl.wat(lane + 64), w3 = tl.wat(lane + 96);
  for (int r = threadIdx.x >> 5; r < m; r += kWarps) {
    T v = lane_entry(tl.vat(r, lane), tl.vat(r, lane + 32), tl.vat(r, lane + 64), tl.vat(r, lane + 96),
                     w0, w1, w2, w3);
    v = warp_tree(v);
    if (lane == 0) partials[(int64_t)(row0 + r) * nb + tile] = v;
  }
}

// The tile's partial of |w|^2 into partials row `row`, by warp 0.
template <typename T>
__device__ void tile_norm(const Tile<T>& tl, T* partials, int row, int nb, int tile) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const T w0 = tl.wat(lane), w1 = tl.wat(lane + 32), w2 = tl.wat(lane + 64), w3 = tl.wat(lane + 96);
  const T v = warp_tree(lane_entry(w0, w1, w2, w3, w0, w1, w2, w3));
  if (lane == 0) partials[(int64_t)row * nb + tile] = v;
}

// The sums of partials rows row0 .. row0 + m - 1 (nb each) into out[0 ..
// m - 1] (shared or device memory), in finish's order; kBatch rows a warp
// with their loads in flight together. The caller syncs the block after.
template <typename T>
__device__ void finish_rows(const T* partials, int row0, int m, int nb, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp * kBatch; r0 < m; r0 += kWarps * kBatch) {
    T acc[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[b][k] = T(0);
    for (int t0 = 0; t0 < nb; t0 += kTile) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (r0 + b < m) {
          const T* row = partials + (int64_t)(row0 + r0 + b) * nb + t0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int t = lane + 32 * k;
            if (t0 + t < nb) acc[b][k] = add_rn(acc[b][k], row[t]);
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const T v = warp_tree(add_rn(add_rn(acc[b][0], acc[b][2]), add_rn(acc[b][1], acc[b][3])));
      if (lane == 0 && r0 + b < m) out[r0 + b] = v;
    }
  }
}

// w <- w - V[:m]^T h for the tile's rows: the products added from 0 in
// order of r, then subtracted.
template <typename T>
__device__ __forceinline__ void tile_update(const Tile<T>& tl, int m, const T* h) {
  const int t = threadIdx.x;
  if (t >= tl.valid) return;
  T acc = T(0);
  for (int r = 0; r < m; ++r) acc = add_rn(acc, mul_rn(tl.v[r * tl.ld + t], h[r]));
  tl.w[t] = sub_rn(tl.w[t], acc);
}

// See the head of the file. Dynamic shared memory: h, h2, the rotations
// (4 (restart + 1) values), w (128) and, with a.stage, the V tile
// (restart x 128).
template <typename T>
__global__ void __launch_bounds__(kTile) fgmres_arnoldi_kernel(Args<T> a, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R1 = a.restart + 1;
  T* h_s = reinterpret_cast<T*>(smem_raw);
  T* h2_s = h_s + R1;
  T* c_s = h2_s + R1;
  T* s_s = c_s + R1;
  T* w_s = s_s + R1;
  T* v_s = w_s + kTile;
  __shared__ T norm_s;
  const int tid = threadIdx.x;
  const bool lead = blockIdx.x == 0;
  const int j = *a.j_dev;
  if (j < 0 || j >= a.restart) {
    if (lead && tid == 0 && (mode == kFused || mode == kNormalize)) *a.flag = 0;
    return;
  }
  cg::grid_group grid = cg::this_grid();
  const int m = j + 1;
  const bool fused = mode == kFused;
  const int nb = a.nb;

  if (fused || mode == kDots) {
    // w = A z (or the caller's), Z[j] = z, the V tile staged; partials of V w.
    for (int tile = blockIdx.x, lt = 0; tile < nb; tile += gridDim.x, ++lt) {
      const bool staged = fused && lt == 0 && a.stage;
      const Tile<T> tl = tile_of(a, j, tile, staged, v_s, w_s);
      const int i = tile * kTile + tid;
      if (tid < tl.valid) {
        const T zi = a.z[i];
        a.Z[(int64_t)j * a.n + i] = zi;
        tl.w[tid] = fused ? row_sum(a.val + (int64_t)i * a.K, a.col + (int64_t)i * a.K, a.K, Dense<T>{a.z, a.n})
                          : a.w_in[i];
      }
      if (staged)
        for (int r = 0; r < m; ++r) v_s[r * kTile + tid] = tid < tl.valid ? a.V[(int64_t)r * a.n + i] : T(0);
      __syncthreads();
      tile_dots(tl, m, a.partials, 0, nb, tile);
      __syncthreads();
    }
    grid.sync();
    if (!fused) {
      if (lead) finish_rows(a.partials, 0, m, nb, a.sums);
      return;
    }
    finish_rows(a.partials, 0, m, nb, h_s);
    __syncthreads();
  }

  if (fused || mode == kUpdate) {
    // w -= V^T h; partials of V w'.
    if (!fused) {
      for (int r = tid; r < m; r += kTile) h_s[r] = a.sums[r];
      __syncthreads();
    }
    for (int tile = blockIdx.x, lt = 0; tile < nb; tile += gridDim.x, ++lt) {
      const Tile<T> tl = tile_of(a, j, tile, fused && lt == 0 && a.stage, v_s, w_s);
      tile_update(tl, m, h_s);
      __syncthreads();
      tile_dots(tl, m, a.partials, R1, nb, tile);
      __syncthreads();
    }
    grid.sync();
    if (!fused) {
      if (lead) finish_rows(a.partials, R1, m, nb, a.sums + R1);
      return;
    }
    finish_rows(a.partials, R1, m, nb, h2_s);
    __syncthreads();
  }

  if (fused || mode == kNorm) {
    // w -= V^T h2; partials of |w|^2.
    if (!fused) {
      for (int r = tid; r < m; r += kTile) h2_s[r] = a.sums[R1 + r];
      __syncthreads();
    }
    for (int tile = blockIdx.x, lt = 0; tile < nb; tile += gridDim.x, ++lt) {
      const Tile<T> tl = tile_of(a, j, tile, fused && lt == 0 && a.stage, v_s, w_s);
      tile_update(tl, m, h2_s);
      __syncthreads();
      tile_norm(tl, a.partials, 2 * R1, nb, tile);
      __syncthreads();
    }
    grid.sync();
    if (!fused) {
      if (lead) finish_rows(a.partials, 2 * R1, 1, nb, a.sums + 2 * R1);
      return;
    }
    finish_rows(a.partials, 2 * R1, 1, nb, &norm_s);
    __syncthreads();
  }

  // V[j + 1] = w / max(|w|, 1e-30) (a NaN kept, as torch.clamp keeps it).
  const T hj1 = sqrt_rn(fused ? norm_s : a.sums[2 * R1]);
  const T safe = hj1 < T(1e-30) ? T(1e-30) : hj1;
  for (int tile = blockIdx.x, lt = 0; tile < nb; tile += gridDim.x, ++lt) {
    const Tile<T> tl = tile_of(a, j, tile, fused && lt == 0 && a.stage, v_s, w_s);
    if (tid < tl.valid) a.V[(int64_t)(j + 1) * a.n + tile * kTile + tid] = div_rn(tl.w[tid], safe);
  }
  // The split launch: every block has read j before block 0 advances it.
  if (!fused) grid.sync();
  if (!lead) return;

  // Block 0: the column h + h2, hj1 and the rotations in shared memory.
  for (int r = tid; r < m; r += kTile) {
    const T h = fused ? h_s[r] : a.sums[r], h2 = fused ? h2_s[r] : a.sums[R1 + r];
    h_s[r] = add_rn(h, h2);
    c_s[r] = r < j ? a.cs[r] : T(0);
    s_s[r] = r < j ? a.sn[r] : T(0);
  }
  if (tid == 0) h_s[m] = hj1;
  __syncthreads();
  if (tid == 0) {
    // The j old rotations (h[i + 1] carried in a register), the new one,
    // g, the flag and the next column.
    T hi = h_s[0];
    for (int i = 0; i < j; ++i) {
      const T hn = h_s[i + 1], c = c_s[i], s = s_s[i];
      h_s[i] = add_rn(mul_rn(c, hi), mul_rn(s, hn));
      hi = add_rn(mul_rn(-s, hi), mul_rn(c, hn));
    }
    const T hl = hj1;  // h[j + 1], untouched by the old rotations
    const T denom = sqrt_rn(add_rn(mul_rn(hi, hi), mul_rn(hl, hl)));
    const T dsafe = denom < T(1e-30) ? T(1e-30) : denom;
    const T c = div_rn(hi, dsafe), s = div_rn(hl, dsafe);
    h_s[j] = denom;
    h_s[m] = T(0);
    a.cs[j] = c;
    a.sn[j] = s;
    const T gj = a.g[j];
    const T gn = mul_rn(-s, gj);
    a.g[j + 1] = gn;
    a.g[j] = mul_rn(c, gj);
    *a.flag = (j + 1 < a.restart) && fabs(gn) > *a.atol ? 1 : 0;
    *a.j_dev = j + 1;
  }
  __syncthreads();
  T* hc = a.Ht + (int64_t)j * R1;
  for (int r = tid; r <= m; r += kTile) hc[r] = h_s[r];
}

inline int64_t nb_of(int n) { return (n + kTile - 1) / kTile; }

template <typename T>
inline int stage_of(int restart) {
  return (int64_t)restart * kTile * (int64_t)sizeof(T) <= kStageMax;
}

template <typename T>
inline int smem_bytes(int restart) {
  const int64_t vals = 4 * (int64_t)(restart + 1) + kTile + (stage_of<T>(restart) ? (int64_t)restart * kTile : 0);
  return (int)(vals * (int64_t)sizeof(T));
}

// Blocks of one cooperative launch for n rows at `restart`: the
// co-resident maximum with the step's dynamic shared memory (opted in above
// 48 KB), at most one per tile; negative: a CUDA error, or no cooperative
// launch on this device.
template <typename T>
int arnoldi_grid(int n, int restart) {
  static int opted[64] = {0};
  static int cap_bytes[64] = {0}, cap_blocks[64] = {0};
  if (n < 1 || restart < 1) return -(int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  const void* kernel = reinterpret_cast<const void*>(&fgmres_arnoldi_kernel<T>);
  const int bytes = smem_bytes<T>(restart);
  if (bytes > opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    opted[dev] = bytes;
  }
  if (cap_bytes[dev] != bytes) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return -(int)cudaErrorNotSupported;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile, bytes);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    cap_bytes[dev] = bytes;
    cap_blocks[dev] = per_sm * sms;
  }
  const int64_t nb = nb_of(n);
  return (int)(nb < cap_blocks[dev] ? nb : cap_blocks[dev]);
}

template <typename T>
int launch(const long long* table, const T* z, const T* w_in, int mode, void* stream) {
  if (mode < kFused || mode > kNormalize) return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.val = reinterpret_cast<const T*>(table[kVal]);
  a.col = reinterpret_cast<const int*>(table[kCol]);
  a.z = z;
  a.w_in = w_in;
  a.V = reinterpret_cast<T*>(table[kV]);
  a.Z = reinterpret_cast<T*>(table[kZ]);
  a.Ht = reinterpret_cast<T*>(table[kHt]);
  a.cs = reinterpret_cast<T*>(table[kCs]);
  a.sn = reinterpret_cast<T*>(table[kSn]);
  a.g = reinterpret_cast<T*>(table[kG]);
  a.j_dev = reinterpret_cast<int*>(table[kJ]);
  a.atol = reinterpret_cast<const T*>(table[kAtol]);
  a.flag = reinterpret_cast<int*>(table[kFlag]);
  a.partials = reinterpret_cast<T*>(table[kPartials]);
  a.sums = reinterpret_cast<T*>(table[kSums]);
  a.K = (int)table[kK];
  a.n = (int)table[kN];
  a.restart = (int)table[kRestart];
  a.nb = (int)nb_of(a.n);
  a.stage = stage_of<T>(a.restart);
  const int grid = (int)table[kGrid];
  if (grid < 1 || a.restart < 1) return (int)cudaErrorInvalidValue;
  if ((mode == kFused || mode == kDots) && z == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == kFused && (a.val == nullptr || a.col == nullptr)) return (int)cudaErrorInvalidValue;
  if (mode == kDots && w_in == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&a, &mode};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&fgmres_arnoldi_kernel<T>),
                                              dim3(grid), dim3(kTile), args, smem_bytes<T>(a.restart),
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_fgmres_arnoldi_grid_f32(int n, int restart, void* stream) {
  (void)stream;
  return arnoldi_grid<float>(n, restart);
}

extern "C" int ppt_fgmres_arnoldi_grid_f64(int n, int restart, void* stream) {
  (void)stream;
  return arnoldi_grid<double>(n, restart);
}

extern "C" int ppt_fgmres_arnoldi_f32(const long long* table, const float* z, const float* w_in, int mode,
                                      void* stream) {
  return launch<float>(table, z, w_in, mode, stream);
}

extern "C" int ppt_fgmres_arnoldi_f64(const long long* table, const double* z, const double* w_in, int mode,
                                      void* stream) {
  return launch<double>(table, z, w_in, mode, stream);
}
