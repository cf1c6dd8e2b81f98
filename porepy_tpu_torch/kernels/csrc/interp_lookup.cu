// K16: the multilinear table lookup of InterpolatedFunction, with its
// forward-mode tangents, in one kernel.
//
// Replaces porepy_tpu/numerics/ad/operator_functions.py:117-134 (lookup),
// which XLA ran as 2^d gathers and weighted sums over whole arrays, and the
// tangents jax traced through it. For d <= 3 parameters, a table of npt_k
// points per axis at spacing h_k from low_k, and each point i with
// coordinates x_k[i]:
//
//   rel_k  = (x_k - low_k) / h_k
//   base_k = clip(floor(rel_k), 0, npt_k - 2)      (an integer: no tangent)
//   frac_k = rel_k - base_k                        (< 0 or > 1 outside the
//                                                   table: extrapolation)
//   f_k(0) = 1 - frac_k,  f_k(1) = frac_k
//   out    = sum over corners c of  prod_k f_k(c_k) * corner value c
//
// and, for each of B seed rows with tangents t_k (B, N) of the coordinates,
// d frac_k = t_k / h_k and
//
//   dout_b = sum_c  sum_k (+-1) (t_bk / h_k) prod_{m != k} f_m(c_m) * corner value c
//
// (+ for c_k = 1, - for c_k = 0). Corners run in itertools.product order
// (the first axis slowest), as the jnp code sums them.
//
// One launch writes the rows of one (vrow + B, N) buffer: the value (vrow =
// 1) and the B tangent rows. A dual rule's call is the value and every
// tangent; the torch.func route's calls are the value alone (B = 0) or the
// tangent rows alone (vrow = 0). The coordinates and each coordinate's
// tangent block are read through their own pointers (the tangent rows with a
// row stride), so nothing is stacked; a constant coordinate's pointer is
// null and its tangent entry is 0.0, which goes through the same division
// and products as a zero seed row did (signed zeros as before).
//
// One thread a point; the seed rows four at a time, their loads issued
// together, and a value-only launch takes an instantiation without the
// tangent loop (its registers leave room for more threads).
//
// The table is the corner-block table of reference.corner_table, built once
// per table and device: each cell's 2^d corner values contiguous and
// aligned (32 B, one L2 sector, at d = 2), so a point reads its corners as
// one aligned block (double2 loads) where the flat table took 2^d scattered
// reads in two or four sectors. It holds 2^d times the flat table (1.28 MB
// at the 201 x 201 table), which stays in L2.
//
// Bits. The operations and their order are the parent kernel's and the
// plain version's (__ddiv_rn, __dsub_rn, __dmul_rn, __dadd_rn: nothing is
// contracted into a fused multiply-add), so every value and tangent equals
// reference.interp_lookup's and reference.interp_tangent's to the bit.
//
// Bound: bytes. Per point d coordinates and B d tangents in, 1 + B results
// out; the corner blocks hit L2. At 2048^2 points, d = 2 and B = 4 that is
// 470 MB, 0.14 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The launch table (int64 words, ops.InterpLauncher): the head is written
// once a launcher (low and h as the bits of doubles), the rest every call.
enum Word : int {
  kD = 0, kCorners, kLow0, kH0 = kLow0 + 3, kNpt0 = kH0 + 3, kStride0 = kNpt0 + 3,
  kN = kStride0 + 3, kValueRow, kTangentRows, kX0, kT0 = kX0 + 3, kTs0 = kT0 + 3, kOut = kTs0 + 3,
  kWords
};

struct Args {
  const double* corners;
  double low[3], h[3];
  int npt[3], stride[3];
  const double* x[3];
  const double* t[3];
  long long ts[3];
  double* out;
  long long n;
  int vrow, nt;
};

// The tangent of one seed row at a point: d frac_k = t_k / h_k and
// d weight = sum_k (+-d frac_k) prod_{m != k} f_m(c_m), summed over the
// corners in order.
template <int D>
__device__ __forceinline__ double tangent(const double (&t)[D], const double (&f0)[D], const double (&f1)[D],
                                          const double (&v)[1 << D], const Args& a) {
  double df[D];
#pragma unroll
  for (int k = 0; k < D; ++k) df[k] = __ddiv_rn(t[k], a.h[k]);
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
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
  return acc;
}

// kTangents: the launch has tangent rows (a value-only launch takes the
// leaner instantiation).
template <int D, bool kTangents>
__global__ void __launch_bounds__(kThreads) interp_dual_kernel(const Args a) {
  constexpr int kCorners = 1 << D;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  double f0[D], f1[D];
  long long cell = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const double rel = __ddiv_rn(__dsub_rn(a.x[k][i], a.low[k]), a.h[k]);
    int b = (int)floor(rel);
    b = b < 0 ? 0 : (b > a.npt[k] - 2 ? a.npt[k] - 2 : b);
    cell += (long long)b * a.stride[k];
    f1[k] = __dsub_rn(rel, (double)b);
    f0[k] = __dsub_rn(1.0, f1[k]);
  }
  // The cell's corner block, one aligned read.
  double v[kCorners];
  const double2* blk = reinterpret_cast<const double2*>(a.corners + cell * kCorners);
#pragma unroll
  for (int c = 0; c < kCorners / 2; ++c) {
    const double2 p = __ldg(blk + c);
    v[2 * c] = p.x;
    v[2 * c + 1] = p.y;
  }
  if (a.vrow) {
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      double w = 1.0;
#pragma unroll
      for (int k = 0; k < D; ++k) w = __dmul_rn(w, ((c >> (D - 1 - k)) & 1) ? f1[k] : f0[k]);
      acc = __dadd_rn(acc, __dmul_rn(w, v[c]));
    }
    a.out[i] = acc;
  }
  if (!kTangents) return;
  // The seed rows four at a time, their loads issued together; a null
  // tangent pointer (a constant argument) reads 0.0.
  int b = 0;
  for (; b + 4 <= a.nt; b += 4) {
    double t[4][D];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < D; ++k) t[u][k] = a.t[k] ? a.t[k][(b + u) * a.ts[k] + i] : 0.0;
#pragma unroll
    for (int u = 0; u < 4; ++u) a.out[(a.vrow + b + u) * a.n + i] = tangent<D>(t[u], f0, f1, v, a);
  }
  for (; b < a.nt; ++b) {
    double t[D];
#pragma unroll
    for (int k = 0; k < D; ++k) t[k] = a.t[k] ? a.t[k][b * a.ts[k] + i] : 0.0;
    a.out[(a.vrow + b) * a.n + i] = tangent<D>(t, f0, f1, v, a);
  }
}

template <int D>
void launch(const Args& a, unsigned blocks, cudaStream_t s) {
  if (a.nt)
    interp_dual_kernel<D, true><<<blocks, kThreads, 0, s>>>(a);
  else
    interp_dual_kernel<D, false><<<blocks, kThreads, 0, s>>>(a);
}

template <typename T>
inline T* word_ptr(const long long* w, int k) {
  return reinterpret_cast<T*>(w[k]);
}

inline double word_double(const long long* w, int k) {
  double v;
  static_assert(sizeof(v) == sizeof(w[k]), "a word holds a double");
  __builtin_memcpy(&v, &w[k], sizeof(v));
  return v;
}

}  // namespace

extern "C" int ppt_interp_dual_f64(const long long* w, void* stream) {
  Args a;
  const int d = (int)w[kD];
  if (d < 1 || d > 3) return (int)cudaErrorInvalidValue;
  a.corners = word_ptr<const double>(w, kCorners);
  for (int k = 0; k < 3; ++k) {
    a.low[k] = word_double(w, kLow0 + k);
    a.h[k] = word_double(w, kH0 + k);
    a.npt[k] = (int)w[kNpt0 + k];
    a.stride[k] = (int)w[kStride0 + k];
    a.x[k] = word_ptr<const double>(w, kX0 + k);
    a.t[k] = word_ptr<const double>(w, kT0 + k);
    a.ts[k] = w[kTs0 + k];
  }
  a.out = word_ptr<double>(w, kOut);
  a.n = w[kN];
  a.vrow = (int)w[kValueRow];
  a.nt = (int)w[kTangentRows];
  if (a.n == 0 || a.vrow + a.nt == 0) return 0;
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: launch<1>(a, (unsigned)blocks, s); break;
    case 2: launch<2>(a, (unsigned)blocks, s); break;
    default: launch<3>(a, (unsigned)blocks, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int ppt_interp_dual_words_f64(void) { return kWords; }
