// K17: the constant-K Rachford-Rice flash, one thread per point.
//
// Replaces porepy_tpu/compositional/flash.py:80-122 (rachford_rice of
// ConstantKFlash.compute_flash), which XLA ran as whole-array passes over
// the (nc, N) fractions, 150 times. Per point, with K the nc constant
// K-values:
//
//   all liquid    sum z K <= 1        all vapor    sum z / K <= 1
//   h(V)  =  sum z (K - 1) / (1 + V (K - 1))
//   h'(V) = -sum z (K - 1)^2 / (1 + V (K - 1))^2
//   lo = (Kmax > 1 ? 1 / (1 - Kmax) : -1e10) + 1e-12
//   hi = (Kmin < 1 ? 1 / (1 - Kmin) : 1e10) - 1e-12
//   V_0 = clip(0.5, lo, hi), V_{k+1} = clip(V_k - h(V_k) / (|h'(V_k)| > 1e-30
//   ? h'(V_k) : -1), lo, hi), and V = V_max_iter
//   V = all liquid ? 0 : all vapor ? 1 : V, clipped to [0, 1]
//   x = z / (1 + V (K - 1)), y = K x, each normalised by its sum
//   converged = two-phase ? |h(clip(V, lo, hi))| < tol : true
//
// with every operation in the order the jnp code writes it, and no
// multiply-add contracted (__dmul_rn and friends), so that a point's result
// equals the plain PyTorch version's up to the order of the nc-term sums.
//
// The cycle exit. A third of the two-phase points never reach a fixed
// point: their iterate cycles in its last bits. A warp runs as long as its
// slowest lane, and every warp of 32 points holds such a point, so a kernel
// that stops only at a fixed point pays max_iter iterations a point. Here
// each thread keeps its last kRing iterates in registers (a shift register,
// statically indexed). When V_{k+1} equals V_{k+1-m} for some m <= kRing,
// the orbit is periodic from s = k + 1 - m on, since the Newton map depends
// on V alone; so V_max_iter = V_{s + (max_iter - s) mod m}, which is still
// in the ring. The thread takes it and stops: the result has the bits of
// all max_iter iterations, and iters counts the iterations the point ran
// (a fixed point is m = 1). A single-phase point runs none: the corners
// replace its V with 0 or 1 after the iterations.
//
// The tail. With the cycle exit the slowest lane of a warp still runs ~13.6
// iterations on average at nc = 3, against a mean of ~4.5 a point, and a few
// points in a thousand run all max_iter. So a flash is two launches: the
// first caps each point at kTailCap iterations, and a point still running
// then appends its index to a compact list (one atomic a warp); the second
// runs the listed points, 32 of them a warp, a grid-stride loop over the
// count read on the device. A listed point starts again from V_0 with an
// empty ring: the Newton map depends on V alone, so it repeats its first
// kTailCap iterates and then goes on as one launch would, with the same
// bits and the same count, and nothing of it is stored between the two.
//
// Each block stages K in shared memory; each thread then keeps z, K and
// K - 1 of its point in registers (instantiated for nc = 1..8); z is read
// once, x and y written once. 64 registers a thread, 4 blocks an SM.
//
// Bound: bytes. At N = 2048^2 and nc = 3, z in and V, x, y, the flags and
// the counts out are 357 MB, 0.106 ms at 3.35 TB/s; the ~4.5 iterations a
// point that the cycle exit leaves, 9 nc + 5 f64 operations each, are
// ~0.8 GFLOP, 0.024 ms at 34 TFLOP/s. What sets the time is the iterations
// the warps run, at the slowest lane's count, and their f64 divisions, each
// a sequence of several instructions (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks an SM holds: at most 64 registers a thread (88 unbounded).
constexpr int kMinBlocks = 4;
// The iterates a thread keeps for the cycle exit (reference.FLASH_RING).
constexpr int kRing = 8;
// Iterations of the first launch (on an H100 at 2048^2 points, nc = 3, 12
// timed best of 8, 12 and 16; PERF.md).
constexpr int kTailCap = 12;

template <int NC>
__device__ __forceinline__ void h_dh(const double (&z)[NC], const double (&km1)[NC],
                                     double V, double& h, double& dh) {
  h = 0.0;
  dh = 0.0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    double den = __dadd_rn(1.0, __dmul_rn(V, km1[c]));
    h = __dadd_rn(h, __ddiv_rn(__dmul_rn(z[c], km1[c]), den));
    dh = __dadd_rn(dh, __ddiv_rn(__dmul_rn(z[c], __dmul_rn(km1[c], km1[c])),
                                 __dmul_rn(den, den)));
  }
  dh = -dh;
}

// clip as jax computes it, minimum(maximum(v, lo), hi): NaN propagates.
__device__ __forceinline__ double clip(double v, double lo, double hi) {
  double m = v < lo ? lo : v;
  return m > hi ? hi : m;
}

// One point: its fractions, the K-values, the window and the phase test.
template <int NC>
struct Point {
  double z[NC], K[NC], km1[NC];
  double lo, hi;
  bool single, all_liquid, all_vapor;

  __device__ __forceinline__ void load(const double* __restrict__ zs, const double* sK,
                                       int64_t n, int64_t i) {
    double kmax = sK[0], kmin = sK[0];
    double zk = 0.0, zok = 0.0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      K[c] = sK[c];
      km1[c] = __dsub_rn(K[c], 1.0);
      z[c] = zs[(int64_t)c * n + i];
      kmax = fmax(kmax, K[c]);
      kmin = fmin(kmin, K[c]);
      zk = __dadd_rn(zk, __dmul_rn(z[c], K[c]));
      zok = __dadd_rn(zok, __ddiv_rn(z[c], K[c]));
    }
    all_liquid = zk <= 1.0;
    all_vapor = zok <= 1.0;
    single = all_liquid || all_vapor;
    lo = __dadd_rn(kmax > 1.0 ? __ddiv_rn(1.0, __dsub_rn(1.0, kmax)) : -1e10, 1e-12);
    hi = __dsub_rn(kmin < 1.0 ? __ddiv_rn(1.0, __dsub_rn(1.0, kmin)) : 1e10, 1e-12);
  }

  // Newton steps from V_0 until the count reaches limit or the iterate
  // cycles; ring[q] = V_{it - 1 - q}. Returns whether V is final (cycled:
  // V = V_max_iter, taken from the ring).
  __device__ __forceinline__ bool iterate(int& it, int limit, int max_iter, double& V) const {
    double ring[kRing];
    ring[0] = clip(0.5, lo, hi);
#pragma unroll
    for (int q = 1; q < kRing; ++q) ring[q] = __longlong_as_double(0x7ff8000000000000LL);
    it = 0;
    while (it < limit) {
      double h, dh;
      h_dh<NC>(z, km1, ring[0], h, dh);
      const double step = __ddiv_rn(h, fabs(dh) > 1e-30 ? dh : -1.0);
      const double Vn = clip(__dsub_rn(ring[0], step), lo, hi);
      ++it;
      // The least period m with V_it = V_{it - m}.
      int m = 0;
#pragma unroll
      for (int q = kRing - 1; q >= 0; --q) m = Vn == ring[q] ? q + 1 : m;
      if (m) {
        // V_max_iter = V_{s + j}, s = it - m, j = (max_iter - s) mod m,
        // which sits at ring[m - 1 - j].
        const int pos = m - 1 - (max_iter - (it - m)) % m;
#pragma unroll
        for (int q = 0; q < kRing; ++q) V = q == pos ? ring[q] : V;
        return true;
      }
#pragma unroll
      for (int q = kRing - 1; q > 0; --q) ring[q] = ring[q - 1];
      ring[0] = Vn;
    }
    V = ring[0];
    return it >= max_iter;
  }

  __device__ __forceinline__ void finish(double V, double* __restrict__ V_out,
                                         double* __restrict__ x_out, double* __restrict__ y_out,
                                         bool* __restrict__ converged, int64_t n, int64_t i,
                                         double tol) const {
    double Vf = all_liquid ? 0.0 : (all_vapor ? 1.0 : V);
    Vf = clip(Vf, 0.0, 1.0);
    double x[NC], y[NC], sx = 0.0, sy = 0.0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] = __ddiv_rn(z[c], __dadd_rn(1.0, __dmul_rn(Vf, km1[c])));
      y[c] = __dmul_rn(K[c], x[c]);
      sx = __dadd_rn(sx, x[c]);
      sy = __dadd_rn(sy, y[c]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x_out[(int64_t)c * n + i] = __ddiv_rn(x[c], sx);
      y_out[(int64_t)c * n + i] = __ddiv_rn(y[c], sy);
    }
    V_out[i] = Vf;
    double h, dh;
    h_dh<NC>(z, km1, clip(Vf, lo, hi), h, dh);
    converged[i] = single ? true : fabs(h) < tol;
  }
};

struct Out {
  double* V;
  double* x;
  double* y;
  bool* converged;
  int* iters;
};

// The tail list of the first launch: the points still running after
// kTailCap iterations.
struct Tail {
  int* count;
  int* idx;
};

template <int NC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rachford_rice_kernel(const double* __restrict__ zs, const double* __restrict__ kv, Out out,
                         Tail tail, int64_t n, int max_iter, double tol) {
  __shared__ double sK[NC];
  if (threadIdx.x < NC) sK[threadIdx.x] = kv[threadIdx.x];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  Point<NC> pt;
  double V = 0.0;
  int it = 0;
  bool done = true;
  if (valid) {
    pt.load(zs, sK, n, i);
    if (!pt.single) done = pt.iterate(it, kTailCap < max_iter ? kTailCap : max_iter, max_iter, V);
  }
  // The points that ran kTailCap iterations without a repeat go to the tail
  // list, one atomic a warp.
  const bool pending = valid && !done;
  const unsigned bal = __ballot_sync(0xffffffffu, pending);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && bal) base = atomicAdd(tail.count, __popc(bal));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (pending) tail.idx[base + __popc(bal & ((1u << lane) - 1u))] = (int)i;
  if (!valid || pending) return;
  out.iters[i] = it;
  pt.finish(V, out.V, out.x, out.y, out.converged, n, i, tol);
}

// The tail: each listed point from V_0 to its cycle or max_iter; a
// grid-stride loop over the count on the device.
template <int NC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rachford_rice_tail_kernel(const double* __restrict__ zs, const double* __restrict__ kv,
                              Out out, Tail tail, int64_t n, int max_iter, double tol) {
  __shared__ double sK[NC];
  if (threadIdx.x < NC) sK[threadIdx.x] = kv[threadIdx.x];
  __syncthreads();
  const int count = *tail.count;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < count; t += gridDim.x * kThreads) {
    const int64_t i = tail.idx[t];
    Point<NC> pt;
    pt.load(zs, sK, n, i);
    int it;
    double V;
    pt.iterate(it, max_iter, max_iter, V);
    out.iters[i] = it;
    pt.finish(V, out.V, out.x, out.y, out.converged, n, i, tol);
  }
}

template <int NC>
int launch(const double* zs, const double* kv, Out out, Tail tail, int64_t n, int max_iter,
           double tol, cudaStream_t stream) {
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  cudaError_t err = cudaMemsetAsync(tail.count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  rachford_rice_kernel<NC><<<blocks, kThreads, 0, stream>>>(zs, kv, out, tail, n, max_iter, tol);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tail_blocks = blocks < 8 * sms ? blocks : 8 * sms;
  rachford_rice_tail_kernel<NC><<<tail_blocks, kThreads, 0, stream>>>(zs, kv, out, tail, n,
                                                                      max_iter, tol);
  return (int)cudaGetLastError();
}

}  // namespace

// Two launches: kTailCap iterations a point, then the tail list (count;
// idx: n ints).
extern "C" int ppt_rachford_rice_f64(const double* zs, const double* kv, double* V,
                                     double* x, double* y, bool* converged, int* iters,
                                     int* count, int* idx, int nc, long long n, int max_iter,
                                     double tol, void* stream) {
  if (n == 0) return 0;
  if (n > 0x7fffffffLL || max_iter < 0 || !(count && idx)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Out out{V, x, y, converged, iters};
  const Tail tail{count, idx};
  switch (nc) {
    case 1: return launch<1>(zs, kv, out, tail, n, max_iter, tol, s);
    case 2: return launch<2>(zs, kv, out, tail, n, max_iter, tol, s);
    case 3: return launch<3>(zs, kv, out, tail, n, max_iter, tol, s);
    case 4: return launch<4>(zs, kv, out, tail, n, max_iter, tol, s);
    case 5: return launch<5>(zs, kv, out, tail, n, max_iter, tol, s);
    case 6: return launch<6>(zs, kv, out, tail, n, max_iter, tol, s);
    case 7: return launch<7>(zs, kv, out, tail, n, max_iter, tol, s);
    case 8: return launch<8>(zs, kv, out, tail, n, max_iter, tol, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
