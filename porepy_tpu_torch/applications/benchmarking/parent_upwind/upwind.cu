// The parent's K15 kernels (one thread a (row, face), the upstream found
// again in every row, the value and the tangents in two launches, the
// interface product a third dual_ew launch), kept beside upwind_check.py as
// the yardstick of the one-launch kernel that kernels/csrc/upwind.cu holds
// now; built by that script alone, never by the package.
//
// K15: single-point upstream weighting inside the residual, with its
// forward-mode tangents.
//
// Replaces porepy_tpu/numerics/fv/upwind.py:76-99 (upwind_apply,
// upwind_boundary_masks) and the face expression around them
// (porepy_tpu/models/constitutive_laws.py, AdvectiveFlux.advective_flux),
// which XLA ran as a chain of selects and gathers over whole arrays, and the
// two-candidate interface selections. For a face f with the cells lo[f]
// behind and hi[f] in front of it (-1 where missing):
//
//   pos      = q >= 0                    (IEEE: true for -0.0, false for NaN)
//   up       = pos ? lo : hi
//   outside  = up < 0
//   up(w)    = (outside | is_neu | (is_dir & outside)) ? 0 : w[up]
//   dir_mask = (is_dir & outside) ? 1 : 0
//   neu      = is_neu ? sgn_div : 0
//   flux     = q up(w) + dir_mask q bc + neu bc
//   dflux    = dq (up(w) + dir_mask bc) + q up(dw) + (dir_mask q + neu) dbc
//
// The selection is taken from q as data (the stop-gradient of the jnp code),
// so the tangent never differentiates it.
//
// One thread per (row, face); gathers only, no scatter, so the result is the
// same on every launch. Every float field comes with a row stride: 0 for a
// field shared by all rows of the batch, its row length (or the stride of
// the view it was sliced from) otherwise. A null seed reads 0.
//
// Bound: bytes. Per face q, bc, lo, hi, is_dir, is_neu, sgn_div in, the
// cell field once, one result out per row: about 0.5 MB at the tracer case's
// 8,500 faces with 16 seeds, far below a microsecond at 3.35 TB/s. The time
// is the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Upstream {
  long long up;   // upstream cell, -1 outside
  bool take;      // the cell field is read there
  double dir_mask;
};

__device__ __forceinline__ Upstream upstream(double q, long long lo, long long hi,
                                             bool is_dir, bool is_neu) {
  Upstream u;
  u.up = (q >= 0.0) ? lo : hi;
  bool outside = u.up < 0;
  u.take = !(outside || is_neu);
  u.dir_mask = (is_dir && outside) ? 1.0 : 0.0;
  return u;
}

__global__ void upwind_flux_kernel(
    const double* __restrict__ q, const double* __restrict__ w,
    const double* __restrict__ bc, const double* __restrict__ dq,
    const double* __restrict__ dw, const double* __restrict__ dbc, long long sq,
    long long sw, long long sbc, long long sdq, long long sdw, long long sdbc,
    const long long* __restrict__ lo, const long long* __restrict__ hi,
    const uint8_t* __restrict__ is_dir, const uint8_t* __restrict__ is_neu,
    const double* __restrict__ sgn_div, double* __restrict__ out, int nf,
    int tangent) {
  int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= nf) return;
  long long b = blockIdx.y;
  double qv = q[b * sq + f];
  double bcv = bc[b * sbc + f];
  bool neu = is_neu[f] != 0;
  Upstream u = upstream(qv, lo[f], hi[f], is_dir[f] != 0, neu);
  double neu_coeff = neu ? sgn_div[f] : 0.0;
  double res;
  if (!tangent) {
    double w_up = u.take ? w[b * sw + u.up] : 0.0;
    res = __dadd_rn(__dadd_rn(__dmul_rn(qv, w_up),
                              __dmul_rn(__dmul_rn(u.dir_mask, qv), bcv)),
                    __dmul_rn(neu_coeff, bcv));
  } else {
    res = 0.0;
    if (dq != nullptr) {
      double w_up = u.take ? w[b * sw + u.up] : 0.0;
      res = __dmul_rn(dq[b * sdq + f], __dadd_rn(w_up, __dmul_rn(u.dir_mask, bcv)));
    }
    if (dw != nullptr) {
      double dw_up = u.take ? dw[b * sdw + u.up] : 0.0;
      res = __dadd_rn(res, __dmul_rn(qv, dw_up));
    }
    if (dbc != nullptr) {
      double c = __dadd_rn(__dmul_rn(u.dir_mask, qv), neu_coeff);
      res = __dadd_rn(res, __dmul_rn(c, dbc[b * sdbc + f]));
    }
  }
  out[b * nf + f] = res;
}

__global__ void upwind_select_kernel(
    const double* __restrict__ q, const double* __restrict__ w, long long sq,
    long long sw, const long long* __restrict__ lo,
    const long long* __restrict__ hi, const uint8_t* __restrict__ is_dir,
    const uint8_t* __restrict__ is_neu, double* __restrict__ out, int nf) {
  int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= nf) return;
  long long b = blockIdx.y;
  Upstream u = upstream(q[b * sq + f], lo[f], hi[f], is_dir[f] != 0, is_neu[f] != 0);
  out[b * nf + f] = u.take ? w[b * sw + u.up] : 0.0;
}

__global__ void upwind_select_pair_kernel(
    const double* __restrict__ s, const double* __restrict__ a,
    const double* __restrict__ c, long long ss, long long sa, long long sc,
    double* __restrict__ out, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long b = blockIdx.y;
  const double* src = (s[b * ss + i] >= 0.0) ? a : c;
  long long stride = (s[b * ss + i] >= 0.0) ? sa : sc;
  out[b * n + i] = (src != nullptr) ? src[b * stride + i] : 0.0;
}

inline dim3 grid_of(int n, int batch) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)batch);
}

}  // namespace

extern "C" int ppt_upwind_flux_f64(
    const double* q, const double* w, const double* bc, const double* dq,
    const double* dw, const double* dbc, long long sq, long long sw,
    long long sbc, long long sdq, long long sdw, long long sdbc,
    const long long* lo, const long long* hi, const uint8_t* is_dir,
    const uint8_t* is_neu, const double* sgn_div, double* out, int nf, int batch,
    int tangent, void* stream) {
  if (nf == 0 || batch == 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  upwind_flux_kernel<<<grid_of(nf, batch), kThreads, 0, (cudaStream_t)stream>>>(
      q, w, bc, dq, dw, dbc, sq, sw, sbc, sdq, sdw, sdbc, lo, hi, is_dir, is_neu,
      sgn_div, out, nf, tangent);
  return (int)cudaGetLastError();
}

extern "C" int ppt_upwind_select_f64(const double* q, const double* w,
                                     long long sq, long long sw,
                                     const long long* lo, const long long* hi,
                                     const uint8_t* is_dir, const uint8_t* is_neu,
                                     double* out, int nf, int batch, void* stream) {
  if (nf == 0 || batch == 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  upwind_select_kernel<<<grid_of(nf, batch), kThreads, 0, (cudaStream_t)stream>>>(
      q, w, sq, sw, lo, hi, is_dir, is_neu, out, nf);
  return (int)cudaGetLastError();
}

extern "C" int ppt_upwind_select_pair_f64(const double* s, const double* a,
                                          const double* c, long long ss,
                                          long long sa, long long sc, double* out,
                                          int n, int batch, void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  upwind_select_pair_kernel<<<grid_of(n, batch), kThreads, 0, (cudaStream_t)stream>>>(
      s, a, c, ss, sa, sc, out, n);
  return (int)cudaGetLastError();
}
