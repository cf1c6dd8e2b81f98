// The parent's K14 flux and trace kernels (one thread a face, the value and
// the tangents in two launches, the seeds in a serial loop), kept beside
// tpfa_ad_check.py as the yardstick of the one-launch kernel that
// kernels/csrc/tpfa_ad.cu holds now; built by that script alone, never by
// the package.
//
// K14: the differentiable two-point flux approximation inside the residual
// (value and forward-mode tangents), and the fixed-order segment sums of the
// TPFA functions.
//
// Replaces porepy_tpu/models/darcys_law_ad.py:71-147 (_DiffTpfaGeometry's
// flux_fn and trace_fn over numerics/fv/tpfa.py:55-134), which XLA ran as
// gathers, an einsum and segment sums over whole half-face arrays, and
// porepy_tpu/numerics/fv/fv_mesh.py:129-145 (divergence_apply and the
// segment sums). For one subdomain with cell-major tensor entries k9,
// specific volumes vol, pressures p and the face fields bco (boundary
// operand) and lam (mortar flux on faces), per half-face h of face f with
// cell c = ci[h], outward area-weighted normal n and face-minus-cell-center
// vector d:
//
//   kv    = K_c vol_c
//   t_hf  = (n . kv . d) / |d|^2
//   t_full = 1 / sum_h 1 / t_hf              (harmonic average, h in CSC order)
//   t     = is_neu ? 0 : t_full
//   coeff = one half-face ? (is_dir ? -t sgn : is_neu ? sgn : 0) : 0
//   flux  = t sum_h sgn_h p[c_h] + coeff (bco + lam)
//   trace = is_dir_raw ? bco + lam
//         : is_neu_raw ? p[c] - (bco + lam) / t_full : 0
//
// One thread per face walks its one or two half-faces through face_ptr and
// face_hf, in the order of the grid's CSC matrix, so sums have a fixed
// order and no atomics: two launches give the same bits. The face's count
// of half-faces takes the place of the n_adj segment sum and of the
// scatter-set of the jnp code. The arithmetic keeps the jnp code's order of
// operations (round-to-nearest intrinsics, no contraction into FMAs).
//
// With seeds (batch > 0) the kernel writes the B tangents instead of the
// value, the chain rule written out in the order forward-mode autodiff takes
// it: d(1/x) = -dx (1/x)^2 at both reciprocals, so a cell of zero
// permeability gives t = 0 and a non-finite tangent on its faces, as
// differentiating the plain version does. The guarded division of the trace
// is a branch, so no such tangent leaks to faces that are not Neumann. Each
// seed comes with its row stride (seeds are slices of (B, n_total) arrays);
// a null seed reads 0.
//
// Bound: bytes. Per half-face 9 tensor entries (each cell's read about
// twice per face pair, from L2), 6 geometry doubles, 2 ints and a sign; per
// face two ints, two flags, bco, lam and one result per row. At the 3d 32^3
// grid (196,608 half-faces, 101,376 faces) about 16 MB, 0.005 ms at
// 3.35 TB/s; the tangents add 16 rows of seeds and results.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Fields {
  const double* k9;
  const double* vol;
  const double* p;
  const double* bco;
  const double* lam;
  const double* dk9;
  const double* dvol;
  const double* dp;
  const double* dbco;
  const double* dlam;
  long long sdk9, sdvol, sdp, sdbco, sdlam;
  const int* face_ptr;
  const int* face_hf;
  const int* ci;
  const double* sgn;
  const double* nrm;
  const double* dvec;
  const uint8_t* is_dir;
  const uint8_t* is_neu;
  int nf, nhf;
};

__device__ __forceinline__ double dot3(const double* a, const double* b) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a[0], b[0]), __dmul_rn(a[1], b[1])),
                   __dmul_rn(a[2], b[2]));
}

// n . M . d with M row-major 3x3: rows contracted with n first, as the
// einsum "ijh,jh->ih" followed by the sum over i of nk_i d_i does.
__device__ __forceinline__ double ndot(const double* m, const double* n,
                                       const double* d) {
  double nk[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) nk[i] = dot3(m + 3 * i, n);
  return dot3(nk, d);
}

struct HalfFace {
  int c;
  double sgn, t_hf, dist2;
  double n[3], d[3];
};

__device__ __forceinline__ HalfFace half_face(const Fields& a, int h) {
  HalfFace x;
  x.c = a.ci[h];
  x.sgn = a.sgn[h];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x.n[i] = a.nrm[(long long)i * a.nhf + h];
    x.d[i] = a.dvec[(long long)i * a.nhf + h];
  }
  double kv[9];
  double v = a.vol[x.c];
#pragma unroll
  for (int i = 0; i < 9; ++i) kv[i] = __dmul_rn(a.k9[9LL * x.c + i], v);
  x.dist2 = dot3(x.d, x.d);
  x.t_hf = __ddiv_rn(ndot(kv, x.n, x.d), x.dist2);
  return x;
}

// d t_hf for seed row b: d(kv) = dK vol + K dvol.
__device__ __forceinline__ double half_face_tangent(const Fields& a,
                                                    const HalfFace& x, long long b) {
  double dkv[9];
  double v = a.vol[x.c];
  double dv = a.dvol != nullptr ? a.dvol[b * a.sdvol + x.c] : 0.0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    double dk = a.dk9 != nullptr ? a.dk9[b * a.sdk9 + 9LL * x.c + i] : 0.0;
    dkv[i] = __dadd_rn(__dmul_rn(dk, v), __dmul_rn(a.k9[9LL * x.c + i], dv));
  }
  return __ddiv_rn(ndot(dkv, x.n, x.d), x.dist2);
}

template <bool kTrace>
__global__ void tpfa_ad_kernel(Fields a, double* __restrict__ out, int batch) {
  int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= a.nf) return;
  int h0 = a.face_ptr[f], h1 = a.face_ptr[f + 1];
  // A face has one or two half-faces; more would be a broken grid.
  HalfFace hf[2];
  int count = min(h1 - h0, 2);
  double recip = 0.0, cell_part = 0.0;
  for (int k = 0; k < count; ++k) {
    hf[k] = half_face(a, a.face_hf[h0 + k]);
    recip = __dadd_rn(recip, __ddiv_rn(1.0, hf[k].t_hf));
    cell_part = __dadd_rn(cell_part, __dmul_rn(hf[k].sgn, a.p[hf[k].c]));
  }
  if (count == 0) {
    for (int b = 0; b < max(batch, 1); ++b) out[(long long)b * a.nf + f] = 0.0;
    return;
  }
  double t_full = __ddiv_rn(1.0, recip);
  bool dir = a.is_dir[f] != 0, neu = a.is_neu[f] != 0;
  const HalfFace& last = hf[count - 1];
  double bval = __dadd_rn(a.bco[f], a.lam[f]);
  double t = neu ? 0.0 : t_full;
  double coeff = 0.0;
  if (!kTrace && count == 1) coeff = dir ? __dmul_rn(-t, last.sgn) : (neu ? last.sgn : 0.0);

  if (batch == 0) {
    double res;
    if (!kTrace) {
      res = __dadd_rn(__dmul_rn(t, cell_part), __dmul_rn(coeff, bval));
    } else {
      res = dir ? bval
                : (neu ? __dsub_rn(a.p[last.c], __ddiv_rn(bval, t_full)) : 0.0);
    }
    out[f] = res;
    return;
  }

  for (long long b = 0; b < batch; ++b) {
    double drecip = 0.0, dcell = 0.0;
    for (int k = 0; k < count; ++k) {
      double r = __ddiv_rn(1.0, hf[k].t_hf);
      double dt_hf = half_face_tangent(a, hf[k], b);
      drecip = __dadd_rn(drecip, __dmul_rn(-dt_hf, __dmul_rn(r, r)));
      if (a.dp != nullptr)
        dcell = __dadd_rn(dcell, __dmul_rn(hf[k].sgn, a.dp[b * a.sdp + hf[k].c]));
    }
    double dt_full = __dmul_rn(-drecip, __dmul_rn(t_full, t_full));
    double db = 0.0;
    if (a.dbco != nullptr) db = a.dbco[b * a.sdbco + f];
    if (a.dlam != nullptr) db = __dadd_rn(db, a.dlam[b * a.sdlam + f]);
    double res;
    if (!kTrace) {
      double dt = neu ? 0.0 : dt_full;
      double dcoeff = (count == 1 && dir) ? __dmul_rn(-dt, last.sgn) : 0.0;
      res = __dadd_rn(__dmul_rn(dt, cell_part), __dmul_rn(t, dcell));
      res = __dadd_rn(res, __dadd_rn(__dmul_rn(dcoeff, bval), __dmul_rn(coeff, db)));
    } else if (dir) {
      res = db;
    } else if (neu) {
      double dp_face = a.dp != nullptr ? a.dp[b * a.sdp + last.c] : 0.0;
      // d(b / t) = db / t - b dt / t^2
      double dquot = __dsub_rn(
          __ddiv_rn(db, t_full),
          __ddiv_rn(__dmul_rn(bval, dt_full), __dmul_rn(t_full, t_full)));
      res = __dsub_rn(dp_face, dquot);
    } else {
      res = 0.0;
    }
    out[b * a.nf + f] = res;
  }
}

__global__ void segment_sum_sorted_kernel(const double* __restrict__ x,
                                          long long sx, const int* __restrict__ ptr,
                                          const int* __restrict__ idx,
                                          double* __restrict__ out, int num) {
  int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= num) return;
  long long b = blockIdx.y;
  const double* row = x + b * sx;
  double acc = 0.0;
  for (int k = ptr[s]; k < ptr[s + 1]; ++k)
    acc = __dadd_rn(acc, row[idx != nullptr ? idx[k] : k]);
  out[b * num + s] = acc;
}

template <bool kTrace>
int launch_tpfa_ad(const double* k9, const double* vol, const double* p,
                   const double* bco, const double* lam, const double* dk9,
                   const double* dvol, const double* dp, const double* dbco,
                   const double* dlam, long long sdk9, long long sdvol,
                   long long sdp, long long sdbco, long long sdlam,
                   const int* face_ptr, const int* face_hf, const int* ci,
                   const double* sgn, const double* nrm, const double* dvec,
                   const uint8_t* is_dir, const uint8_t* is_neu, double* out,
                   int nf, int nhf, int batch, void* stream) {
  if (nf == 0) return 0;
  Fields a{k9,    vol,   p,        bco,     lam, dk9,  dvol, dp,   dbco,   dlam,
           sdk9,  sdvol, sdp,      sdbco,   sdlam,
           face_ptr, face_hf, ci, sgn, nrm, dvec, is_dir, is_neu, nf, nhf};
  int blocks = (nf + kThreads - 1) / kThreads;
  tpfa_ad_kernel<kTrace><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, out, batch);
  return (int)cudaGetLastError();
}

}  // namespace

#define PPT_TPFA_AD_ARGS                                                        \
  const double *k9, const double *vol, const double *p, const double *bco,      \
      const double *lam, const double *dk9, const double *dvol,                 \
      const double *dp, const double *dbco, const double *dlam, long long sdk9, \
      long long sdvol, long long sdp, long long sdbco, long long sdlam,         \
      const int *face_ptr, const int *face_hf, const int *ci, const double *sgn, \
      const double *nrm, const double *dvec, const uint8_t *is_dir,             \
      const uint8_t *is_neu, double *out, int nf, int nhf, int batch, void *stream
#define PPT_TPFA_AD_PASS                                                        \
  k9, vol, p, bco, lam, dk9, dvol, dp, dbco, dlam, sdk9, sdvol, sdp, sdbco,     \
      sdlam, face_ptr, face_hf, ci, sgn, nrm, dvec, is_dir, is_neu, out, nf,    \
      nhf, batch, stream

// batch == 0 writes the value (nf,), batch > 0 the tangents (batch, nf).
extern "C" int ppt_tpfa_ad_flux_f64(PPT_TPFA_AD_ARGS) {
  return launch_tpfa_ad<false>(PPT_TPFA_AD_PASS);
}

extern "C" int ppt_tpfa_ad_trace_f64(PPT_TPFA_AD_ARGS) {
  return launch_tpfa_ad<true>(PPT_TPFA_AD_PASS);
}

extern "C" int ppt_segment_sum_sorted_f64(const double* x, long long sx,
                                          const int* ptr, const int* idx,
                                          double* out, int num, int batch,
                                          void* stream) {
  if (num == 0 || batch == 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((num + kThreads - 1) / kThreads), (unsigned)batch);
  segment_sum_sorted_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, sx, ptr, idx, out, num);
  return (int)cudaGetLastError();
}
