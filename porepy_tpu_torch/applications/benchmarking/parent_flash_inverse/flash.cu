// The parent's K17 kernel (every two-phase point iterates until a fixed
// point or max_iter), kept beside flash_inverse_check.py as the yardstick of
// the kernel that kernels/csrc/flash.cu holds now; built by that script
// alone, never by the package.
//
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
//   V = clip(0.5, lo, hi), then max_iter times
//     V = clip(V - h(V) / (|h'(V)| > 1e-30 ? h'(V) : -1), lo, hi)
//   V = all liquid ? 0 : all vapor ? 1 : V, clipped to [0, 1]
//   x = z / (1 + V (K - 1)), y = K x, each normalised by its sum
//   converged = two-phase ? |h(clip(V, lo, hi))| < tol : true
//
// with every operation in the order the jnp code writes it, and no
// multiply-add contracted (__dmul_rn and friends), so that a point's result
// equals the plain PyTorch version's up to the order of the nc-term sums.
//
// Each block stages K in shared memory; each thread then keeps z, K and
// K - 1 of its point in registers (the kernel is instantiated for
// nc = 1..8; z is read once, x and y written once). A
// thread stops iterating once an iteration leaves V unchanged (a Newton
// step of exactly 0, one below V's last bit, or a step clipped back onto
// the same window edge): every later iteration would repeat it, so the
// result is the one that max_iter iterations give. A single-phase point
// runs none: the corners replace its V with 0 or 1 after the iterations.
// The thread records how many iterations it ran.
//
// Bound: per point and iteration about 9 nc + 5 f64 operations, two of
// them divisions per component. At N = 2048^2 and nc = 3 (~39 iterations
// per point) that is ~5.4 GFLOP, 0.16 ms at the card's 34 TFLOP/s, above
// the 0.11 ms that the 350 MB of z, V, x and y take; f64 divisions, each a
// sequence of several instructions, set the time (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <int NC>
__global__ void rachford_rice_kernel(const double* __restrict__ zs,
                                     const double* __restrict__ kv,
                                     double* __restrict__ V_out,
                                     double* __restrict__ x_out,
                                     double* __restrict__ y_out,
                                     bool* __restrict__ converged,
                                     int* __restrict__ iters, int64_t n,
                                     int max_iter, double tol) {
  __shared__ double sK[NC];
  if (threadIdx.x < NC) sK[threadIdx.x] = kv[threadIdx.x];
  __syncthreads();
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double z[NC], K[NC], km1[NC];
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
  const bool all_liquid = zk <= 1.0;
  const bool all_vapor = zok <= 1.0;
  const double lo = __dadd_rn(kmax > 1.0 ? __ddiv_rn(1.0, __dsub_rn(1.0, kmax)) : -1e10, 1e-12);
  const double hi = __dsub_rn(kmin < 1.0 ? __ddiv_rn(1.0, __dsub_rn(1.0, kmin)) : 1e10, 1e-12);

  double V = clip(0.5, lo, hi);
  int it = 0;
  while (it < max_iter && !(all_liquid || all_vapor)) {
    double h, dh;
    h_dh<NC>(z, km1, V, h, dh);
    double step = __ddiv_rn(h, fabs(dh) > 1e-30 ? dh : -1.0);
    double Vn = clip(__dsub_rn(V, step), lo, hi);
    ++it;
    if (Vn == V) break;
    V = Vn;
  }
  iters[i] = it;

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
  converged[i] = (all_liquid || all_vapor) ? true : fabs(h) < tol;
}

template <int NC>
int launch(const double* zs, const double* kv, double* V, double* x, double* y,
           bool* conv, int* iters, int64_t n, int max_iter, double tol,
           cudaStream_t stream) {
  int blocks = (int)((n + kThreads - 1) / kThreads);
  rachford_rice_kernel<NC><<<blocks, kThreads, 0, stream>>>(zs, kv, V, x, y, conv,
                                                            iters, n, max_iter, tol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_rachford_rice_f64(const double* zs, const double* kv, double* V,
                                     double* x, double* y, bool* converged,
                                     int* iters, int nc, long long n,
                                     int max_iter, double tol, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {
    case 1: return launch<1>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 2: return launch<2>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 3: return launch<3>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 4: return launch<4>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 5: return launch<5>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 6: return launch<6>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 7: return launch<7>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    case 8: return launch<8>(zs, kv, V, x, y, converged, iters, n, max_iter, tol, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
