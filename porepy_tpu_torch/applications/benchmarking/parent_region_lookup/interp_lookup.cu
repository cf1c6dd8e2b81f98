// K16: the multilinear table lookup of InterpolatedFunction, with its
// forward-mode tangents.
//
// Replaces porepy_tpu/numerics/ad/operator_functions.py:117-134 (lookup),
// which XLA ran as 2^d gathers and weighted sums over whole arrays, and the
// tangents jax traced through it. For d <= 3 parameters, a table of npt_k
// points per axis at spacing h_k from low_k (values flat, strides_k), and
// each point i with coordinates x[k, i]:
//
//   rel_k  = (x_k - low_k) / h_k
//   base_k = clip(floor(rel_k), 0, npt_k - 2)      (an integer: no tangent)
//   frac_k = rel_k - base_k                        (< 0 or > 1 outside the
//                                                   table: extrapolation)
//   f_k(0) = 1 - frac_k,  f_k(1) = frac_k
//   out    = sum over corners c of  prod_k f_k(c_k) * values[sum_k (base_k + c_k) strides_k]
//
// and, for each of B seeds dx (B, d, N), d frac_k = dx_k / h_k and
//
//   dout_b = sum_c  sum_k (+-1) (dx_bk / h_k) prod_{m != k} f_m(c_m) * values[...]
//
// (+ for c_k = 1, - for c_k = 0). Corners run in itertools.product order
// (the first axis slowest), as the jnp code sums them.
//
// One thread per point computes the value (when out is given) and the B
// tangents (when dx is given), reading each corner's table value once.
// The table (201^2 doubles, 323 KB at the bench size) stays in L2 and goes
// through the read-only cache.
//
// Bound: bytes. Per point d + B d coordinates in and 1 + B results out;
// the 2^d table reads hit the cache. At 2048^2 points, d = 2 and B = 4
// that is 470 MB, 0.14 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int D>
__global__ void interp_lookup_kernel(const double* __restrict__ values,
                                     const double* __restrict__ fgeom,
                                     const int* __restrict__ igeom,
                                     const double* __restrict__ x,
                                     const double* __restrict__ dx,
                                     double* __restrict__ out,
                                     double* __restrict__ dout, int64_t n,
                                     int batch) {
  constexpr int kCorners = 1 << D;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double f0[D], f1[D], h[D];
  int base[D], stride[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    int npt = igeom[k];
    stride[k] = igeom[D + k];
    h[k] = fgeom[D + k];
    double rel = __ddiv_rn(__dsub_rn(x[(int64_t)k * n + i], fgeom[k]), h[k]);
    int b = (int)floor(rel);
    b = b < 0 ? 0 : (b > npt - 2 ? npt - 2 : b);
    base[k] = b;
    f1[k] = __dsub_rn(rel, (double)b);
    f0[k] = __dsub_rn(1.0, f1[k]);
  }
  // The 2^d corner values, each read once.
  double v[kCorners];
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    int flat = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) flat += (base[k] + ((c >> (D - 1 - k)) & 1)) * stride[k];
    v[c] = __ldg(values + flat);
  }
  if (out != nullptr) {
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      double w = 1.0;
#pragma unroll
      for (int k = 0; k < D; ++k) w = __dmul_rn(w, ((c >> (D - 1 - k)) & 1) ? f1[k] : f0[k]);
      acc = __dadd_rn(acc, __dmul_rn(w, v[c]));
    }
    out[i] = acc;
  }
  if (dx == nullptr) return;
  for (int b = 0; b < batch; ++b) {
    double df[D];
#pragma unroll
    for (int k = 0; k < D; ++k) df[k] = __ddiv_rn(dx[((int64_t)b * D + k) * n + i], h[k]);
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      // d weight = sum_k (+-d frac_k) prod_{m != k} f_m(c_m)
      double dw = 0.0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        double term = ((c >> (D - 1 - k)) & 1) ? df[k] : -df[k];
#pragma unroll
        for (int m = 0; m < D; ++m)
          if (m != k) term = __dmul_rn(term, ((c >> (D - 1 - m)) & 1) ? f1[m] : f0[m]);
        dw = __dadd_rn(dw, term);
      }
      acc = __dadd_rn(acc, __dmul_rn(dw, v[c]));
    }
    dout[(int64_t)b * n + i] = acc;
  }
}

}  // namespace

extern "C" int ppt_interp_lookup_f64(const double* values, const double* fgeom,
                                     const int* igeom, const double* x,
                                     const double* dx, double* out, double* dout,
                                     int d, long long n, int batch, void* stream) {
  if (n == 0) return 0;
  int blocks = (int)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1:
      interp_lookup_kernel<1><<<blocks, kThreads, 0, s>>>(values, fgeom, igeom, x, dx, out, dout, n, batch);
      break;
    case 2:
      interp_lookup_kernel<2><<<blocks, kThreads, 0, s>>>(values, fgeom, igeom, x, dx, out, dout, n, batch);
      break;
    case 3:
      interp_lookup_kernel<3><<<blocks, kThreads, 0, s>>>(values, fgeom, igeom, x, dx, out, dout, n, batch);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
