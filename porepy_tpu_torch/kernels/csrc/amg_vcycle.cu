// K3 and K2: the SA-AMG V-cycle and the Jacobi block's sweeps, each one
// cooperative launch.
//
// Replaces porepy_tpu/numerics/linalg/amg.py:327-341 (Hierarchy._cycle, the
// V(nu, nu) cycle) and porepy_tpu/numerics/linalg/device_solver.py:256
// (_jacobi_sweeps). On the TPU both were XLA programs; in eager PyTorch the
// V-cycle was 9 K1 launches, 9 one-sweep launches and a coarse GEMV an
// apply at md 1/128's three smoothing levels, ~0.07 ms of device work behind
// 0.4-1.1 ms of host dispatch. Here each is one launch.
//
// One device function does a sweep over the rows of a level,
//
//   out_i = y_i + sinv_i (r_i - (A y)_i),
//
// each row of A y summed from 0 in slot order, every product rounded before
// it is added (no multiply-add is contracted), so that the plain passes of
// kernels/reference.py, which round the same operations in the same order,
// give the same bits. The first sweep from y = sinv r computes its
// neighbours' y_j = sinv_j r_j where it reads them, with no pass of its own.
//
// amg_vcycle, levels l = 0 .. L-1 (L <= 6) and the coarse level L:
//   down, at each level: y = sinv r, max(nu - 1, 0) pre-sweeps (the first
//     from y = sinv r on the fly); | sync | t = r - A y; | sync |
//     r_{l+1} = R t; | sync |
//   coarse: y_L = C^{-1} r_L, each row summed in column order; | sync |
//   up, at each level: y += P y_{l+1} (in place: a row reads its own y);
//     | sync | nu post-sweeps, | sync | between them and after each but
//     the last of level 0.
// At md 1/128 (three levels and a coarse one) that is 18 grid syncs.
//
// jacobi_sweeps: s >= 1 sweeps from a given y, or from y = sinv r, with a
// grid sync between sweeps; s = 1 from a given y is one sweep
// (kernels.ell_jacobi_sweep).
//
// Rows. A phase walks the rows of one matrix (n rows of K slots) by groups
// of G lanes of a warp, G a power of two chosen per matrix in the kernel:
// as few as leave each lane at most 4 slots (the lanes the row wants), and
// no more than the grid's threads allow for one pass over the rows. Lane q
// of a group reads the
// slots q, q + G, ..., all four gathers in flight, and forms their products
// (-0.0 for padding: adding it changes no value, +0.0 and -0.0 included);
// then every lane adds the group's products from 0 in slot order, taking
// each from its lane by a shuffle, and lane 0 writes. So a long row (the
// restrictions and the coarse levels: K 24-77 at md 1/128) costs one round
// of gathers, not K / 4 dependent ones, and the sum is the slot-order sum of
// the plain version. G = 1 is one thread a row, four gathers in flight.
//
// Sweeps alternate between two buffers, placed so that the last write lands
// in the result. Grid: blocks of 512 threads, as many as the phase that
// wants the most threads (rows x lanes wanted) needs, at most the
// co-resident maximum (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the
// SM count). Measured against an earlier version of this file with one
// thread a row and blocks of 128 threads, one per 128 rows of the finest
// level (PERF.md, Findings), it is slower on md's short rows (K = 5) and
// much faster where the rows are long (biot's displacement levels,
// K = 18-138); a cooperative launch
// (cudaLaunchCooperativeKernel) makes this_grid().sync() legal, and the
// launch refuses where the card has none. Arrays written inside a launch
// are read through plain pointers (the read-only cache is not coherent
// across grid syncs).
//
// Bound: bytes. One V-cycle apply at md 1/128 in f32 reads the level ELLs
// (A, P, R), sinv and the coarse inverse once and r, and writes y: 2.82 MB,
// 0.84 us at 3.35 TB/s. What holds it back is latency: the grid syncs
// (~1.5-1.8 us each, whatever the number of blocks) and each phase's
// dependent loads (column, then gather).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLevels = 6;
// int64 entries of one level in the host's table (see launch_vcycle).
constexpr int kFields = 16;
// Slots a lane of a row group gathers at once.
constexpr int kSlots = 4;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// y_j = sinv_j r_j, formed where a row reads it.
template <typename T>
struct Smoothed {
  const T* sinv;
  const T* r;
  int n;
  __device__ __forceinline__ bool real(int j) const { return j < n; }
  __device__ __forceinline__ T operator()(int j) const { return mul_rn(sinv[j], r[j]); }
};

// The ELL rows of a matrix: val and col (n, K); a column at or past the
// operand's length is padding.
template <typename T>
struct Ell {
  const T* val;
  const int* col;
  int n, K;
  // The product of slot k of row i with x(col), -0.0 for padding.
  template <typename Src>
  __device__ __forceinline__ T term(int64_t i, int k, const Src& x) const {
    const int64_t o = i * K + k;
    const int j = col[o];
    return x.real(j) ? mul_rn(val[o], x(j)) : T(-0.0);
  }
};

// A dense square matrix (row-major, n x n) as ELL rows of n slots.
template <typename T>
struct Square {
  const T* a;
  int n, K;
  template <typename Src>
  __device__ __forceinline__ T term(int64_t i, int k, const Src& x) const {
    return mul_rn(a[i * K + k], x(k));
  }
};

// Lanes a row of K slots wants: enough for at most kSlots slots a lane.
__host__ __device__ __forceinline__ int lanes_wanted(int K) {
  int g = 1;
  while (g < 32 && g * kSlots < K) g *= 2;
  return g;
}

// Lanes a row for n rows of K slots walked by `threads` threads: those it
// wants, as far as one pass over the rows can have them.
__device__ __forceinline__ int group_lanes(int n, int K, int threads) {
  int g = 1;
  while (g < 32 && g * kSlots < K && 2 * g * n <= threads) g *= 2;
  return g;
}

// Row i of M x from 0 in slot order. G = 1: this thread alone, four
// gathers in flight; otherwise the G lanes of its group (lane q, the
// group's first lane `base`), every lane of the warp calling it together.
template <typename T, typename M, typename Src>
__device__ __forceinline__ T row_of(const M& m, int i, const Src& x, bool active, int G, int q,
                                    int base) {
  T acc = T(0);
  if (G == 1) {
    int k = 0;
    for (; k + kSlots <= m.K; k += kSlots) {
      T p[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) p[u] = m.term((int64_t)i, k + u, x);
#pragma unroll
      for (int u = 0; u < kSlots; ++u) acc = add_rn(acc, p[u]);
    }
    for (; k < m.K; ++k) acc = add_rn(acc, m.term((int64_t)i, k, x));
    return acc;
  }
  for (int k0 = 0; k0 < m.K; k0 += kSlots * G) {
    T p[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int k = k0 + u * G + q;
      p[u] = active && k < m.K ? m.term((int64_t)i, k, x) : T(-0.0);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int cnt = min(G, m.K - (k0 + u * G));
      for (int t = 0; t < cnt; ++t) acc = add_rn(acc, __shfl_sync(0xffffffffu, p[u], base + t));
    }
  }
  return acc;
}

// For each row i of m (t0: this thread's index in the grid, nt: the grid's
// threads): f(i, (M x)_i) by the row's lane 0.
template <typename T, typename M, typename Src, typename F>
__device__ __forceinline__ void rows(const M& m, const Src& x, int t0, int nt, F f) {
  const int G = group_lanes(m.n, m.K, nt);
  if (G == 1) {
    for (int i = t0; i < m.n; i += nt) f(i, row_of<T>(m, i, x, true, 1, 0, 0));
    return;
  }
  const int lane = t0 & 31, q = lane & (G - 1);
  // row0 is the same in every lane of the warp, so all take each turn.
  for (int row0 = (t0 - lane) / G; row0 < m.n; row0 += nt / G) {
    const int i = row0 + lane / G;
    const T s = row_of<T>(m, i, x, i < m.n, G, q, lane - q);
    if (i < m.n && q == 0) f(i, s);
  }
}

// out_i = y_i + sinv_i (r_i - (A y)_i).
template <typename T, typename Src>
__device__ void sweep(const Ell<T>& a, const T* sinv, const T* r, const Src& y, T* out, int t0,
                      int nt) {
  rows<T>(a, y, t0, nt, [&](int i, T ay) { out[i] = add_rn(y(i), mul_rn(sinv[i], sub_rn(r[i], ay))); });
}

template <typename T>
struct Level {
  const T* A_val;
  const int* A_col;
  const T* P_val;
  const int* P_col;
  const T* R_val;
  const int* R_col;
  const T* sinv;
  T* y[2];     // the sweeps' two buffers (level 0: the result and a scratch)
  T* t;        // r - A y
  T* r_next;   // R t, the next level's r
  int n, KA, KP, KR, n_next;
};

template <typename T>
struct Table {
  Level<T> lv[kMaxLevels];
  const T* coarse_inv;  // C^{-1}, row-major
  T* y_coarse;          // the coarse level's y (the result when L = 0)
  int levels, nc, nu;
};

// Writes to a level's y before the post-sweeps: max(nu - 1, 1) (y = sinv r
// is written by the residual phase when there is no pre-sweep).
__device__ __forceinline__ int pre_writes(int nu) { return nu > 2 ? nu - 1 : 1; }

template <typename T>
__device__ __forceinline__ const T* level_r(const Table<T>& tb, const T* r0, int l) {
  return l == 0 ? r0 : tb.lv[l - 1].r_next;
}

// Level l on the way down: pre-sweeps, t = r - A y, r_{l+1} = R t; a grid
// sync after each phase.
template <typename T>
__device__ void down(const Table<T>& tb, const T* r0, int l, int t0, int nt) {
  const Level<T>& lv = tb.lv[l];
  const T* r = level_r(tb, r0, l);
  const Ell<T> A{lv.A_val, lv.A_col, lv.n, lv.KA};
  const Smoothed<T> y0{lv.sinv, r, lv.n};
  const int pre = tb.nu > 1 ? tb.nu - 1 : 0;
  if (pre > 0) {
    sweep(A, lv.sinv, r, y0, lv.y[0], t0, nt);
    cg::this_grid().sync();
    for (int s = 1; s < pre; ++s) {
      sweep(A, lv.sinv, r, Dense<T>{lv.y[(s - 1) & 1], lv.n}, lv.y[s & 1], t0, nt);
      cg::this_grid().sync();
    }
    T* t = lv.t;
    rows<T>(A, Dense<T>{lv.y[(pre - 1) & 1], lv.n}, t0, nt, [&](int i, T ay) { t[i] = sub_rn(r[i], ay); });
  } else {
    // No pre-sweep: t = r - A (sinv r), and y = sinv r kept for the way up.
    T *t = lv.t, *y = lv.y[0];
    rows<T>(A, y0, t0, nt, [&](int i, T ay) {
      t[i] = sub_rn(r[i], ay);
      y[i] = y0(i);
    });
  }
  cg::this_grid().sync();
  T* r_next = lv.r_next;
  rows<T>(Ell<T>{lv.R_val, lv.R_col, lv.n_next, lv.KR}, Dense<T>{lv.t, lv.n}, t0, nt,
          [&](int i, T s) { r_next[i] = s; });
  cg::this_grid().sync();
}

// Level l on the way up: y += P y_{l+1}, then the post-sweeps; a grid sync
// after each phase but the very last of the cycle (`last`).
template <typename T>
__device__ void up(const Table<T>& tb, const T* r0, int l, bool last, int t0, int nt) {
  const Level<T>& lv = tb.lv[l];
  const T* r = level_r(tb, r0, l);
  const Ell<T> A{lv.A_val, lv.A_col, lv.n, lv.KA};
  const int nu = tb.nu;
  int w = pre_writes(nu);
  T* y = lv.y[(w - 1) & 1];
  const T* lower = l + 1 == tb.levels ? tb.y_coarse : tb.lv[l + 1].y[(pre_writes(nu) + nu - 1) & 1];
  rows<T>(Ell<T>{lv.P_val, lv.P_col, lv.n, lv.KP}, Dense<T>{lower, lv.n_next}, t0, nt,
          [&](int i, T py) { y[i] = add_rn(y[i], py); });
  if (!(last && nu == 0)) cg::this_grid().sync();
  for (int s = 0; s < nu; ++s, ++w) {
    T* out = lv.y[w & 1];
    sweep(A, lv.sinv, r, Dense<T>{y, lv.n}, out, t0, nt);
    y = out;
    if (!(last && s == nu - 1)) cg::this_grid().sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amg_vcycle_kernel(const __grid_constant__ Table<T> tb, const T* r0, T* out) {
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  const int L = tb.levels;
  for (int l = 0; l < L; ++l) down(tb, r0, l, t0, nt);
  // The coarse level: y_L = C^{-1} r_L.
  T* yc = L ? tb.y_coarse : out;
  rows<T>(Square<T>{tb.coarse_inv, tb.nc, tb.nc}, Dense<T>{level_r(tb, r0, L), tb.nc}, t0, nt,
          [&](int i, T s) { yc[i] = s; });
  if (L > 0) cg::this_grid().sync();
  for (int l = L - 1; l >= 0; --l) up(tb, r0, l, l == 0, t0, nt);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_sweeps_kernel(const __grid_constant__ Ell<T> a, const T* sinv, const T* r, const T* y_in,
                     T* out, T* scratch, int s) {
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  // Sweep k (0-based) writes buf[k & 1]; the last, k = s - 1, the result.
  T* buf[2] = {out, scratch};
  if ((s - 1) & 1) buf[0] = scratch, buf[1] = out;
  if (y_in)
    sweep(a, sinv, r, Dense<T>{y_in, a.n}, buf[0], t0, nt);
  else
    sweep(a, sinv, r, Smoothed<T>{sinv, r, a.n}, buf[0], t0, nt);
  for (int k = 1; k < s; ++k) {
    cg::this_grid().sync();
    sweep(a, sinv, r, Dense<T>{buf[(k - 1) & 1], a.n}, buf[k & 1], t0, nt);
  }
}

// Threads the rows of an n x K matrix want (rows x lanes wanted).
inline int64_t threads_wanted(int n, int K) { return (int64_t)n * lanes_wanted(K); }

// Blocks of one cooperative launch of `kernel` for `threads` threads: the
// co-resident maximum at most; negative: a CUDA error, or no cooperative
// launch on this device. capacity caches the maximum per device.
int cycle_grid(const void* kernel, int* capacity, int64_t threads) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int coop = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return -(int)cudaErrorNotSupported;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    capacity[dev] = per_sm * sm_count();
  }
  const int64_t nb = (threads + kThreads - 1) / kThreads;
  return nb < capacity[dev] ? (int)nb : capacity[dev];
}

int launch(const void* kernel, int* capacity, int64_t threads, void** args, void* stream) {
  const int grid = cycle_grid(kernel, capacity, threads);
  if (grid < 0) return -grid;
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// table: kFields int64 a level, in this order: A_val, A_col, P_val, P_col,
// R_val, R_col, sinv, y_a, y_b, t, r_next (pointers), n, KA, KP, KR,
// n_next. Level 0's y_a is a scratch vector and its y_b unused: the result
// `out` takes the buffer that the level's last sweep writes.
template <typename T>
int launch_vcycle(const long long* table, int levels, const T* coarse_inv, T* y_coarse, int nc,
                  int nu, const T* r, T* out, void* stream) {
  if (levels < 0 || levels > kMaxLevels || nu < 0 || nc < 1) return (int)cudaErrorInvalidValue;
  Table<T> tb = {};
  for (int l = 0; l < levels; ++l) {
    const long long* f = table + (int64_t)l * kFields;
    Level<T>& lv = tb.lv[l];
    lv.A_val = (const T*)f[0];
    lv.A_col = (const int*)f[1];
    lv.P_val = (const T*)f[2];
    lv.P_col = (const int*)f[3];
    lv.R_val = (const T*)f[4];
    lv.R_col = (const int*)f[5];
    lv.sinv = (const T*)f[6];
    lv.y[0] = (T*)f[7];
    lv.y[1] = (T*)f[8];
    lv.t = (T*)f[9];
    lv.r_next = (T*)f[10];
    lv.n = (int)f[11];
    lv.KA = (int)f[12];
    lv.KP = (int)f[13];
    lv.KR = (int)f[14];
    lv.n_next = (int)f[15];
  }
  if (levels > 0) {
    // The level's last write is its (pre_writes + nu)-th.
    const int last = ((nu > 2 ? nu - 1 : 1) + nu - 1) & 1;
    tb.lv[0].y[1 - last] = tb.lv[0].y[0];
    tb.lv[0].y[last] = out;
  }
  tb.coarse_inv = coarse_inv;
  tb.y_coarse = y_coarse;
  tb.levels = levels;
  tb.nc = nc;
  tb.nu = nu;
  if (levels > 0 && tb.lv[0].n == 0) return 0;
  int64_t threads = threads_wanted(nc, nc);
  for (int l = 0; l < levels; ++l) {
    const Level<T>& lv = tb.lv[l];
    const int64_t t[3] = {threads_wanted(lv.n, lv.KA), threads_wanted(lv.n, lv.KP),
                          threads_wanted(lv.n_next, lv.KR)};
    for (int64_t x : t) threads = x > threads ? x : threads;
  }
  void* args[] = {&tb, &r, &out};
  static int capacity[64] = {0};
  return launch(reinterpret_cast<const void*>(&amg_vcycle_kernel<T>), capacity, threads, args, stream);
}

template <typename T>
int launch_sweeps(const T* val, const int* col, const T* sinv, const T* r, const T* y, T* out,
                  T* scratch, int n, int K, int s, void* stream) {
  if (s < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Ell<T> a{val, col, n, K};
  void* args[] = {&a, &sinv, &r, &y, &out, &scratch, &s};
  static int capacity[64] = {0};
  return launch(reinterpret_cast<const void*>(&jacobi_sweeps_kernel<T>), capacity, threads_wanted(n, K),
                args, stream);
}

}  // namespace

extern "C" int ppt_amg_vcycle_f32(const long long* table, int levels, const float* coarse_inv,
                                  float* y_coarse, int nc, int nu, const float* r, float* out,
                                  void* stream) {
  return launch_vcycle<float>(table, levels, coarse_inv, y_coarse, nc, nu, r, out, stream);
}

extern "C" int ppt_amg_vcycle_f64(const long long* table, int levels, const double* coarse_inv,
                                  double* y_coarse, int nc, int nu, const double* r, double* out,
                                  void* stream) {
  return launch_vcycle<double>(table, levels, coarse_inv, y_coarse, nc, nu, r, out, stream);
}

extern "C" int ppt_jacobi_sweeps_f32(const float* val, const int* col, const float* sinv,
                                     const float* r, const float* y, float* out, float* scratch,
                                     int n, int K, int s, void* stream) {
  return launch_sweeps<float>(val, col, sinv, r, y, out, scratch, n, K, s, stream);
}

extern "C" int ppt_jacobi_sweeps_f64(const double* val, const int* col, const double* sinv,
                                     const double* r, const double* y, double* out,
                                     double* scratch, int n, int K, int s, void* stream) {
  return launch_sweeps<double>(val, col, sinv, r, y, out, scratch, n, K, s, stream);
}
