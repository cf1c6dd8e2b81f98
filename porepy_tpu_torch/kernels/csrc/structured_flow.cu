// K12: residual and Jacobian action of the structured (Cartesian) TPFA
// single-phase flow step.
//
// Replaces porepy_tpu/parallel/structured_flow.py:69-100
// (StructuredFlowKernel.residual, with _padded at :58-67) and the tangent
// that jax.linearize derives from it inside newton_step (:116, :124).
//
// Pressure is an (nx, ny, nz) C-order array. For cell c = (i, j, k):
//   res[c] = pv[c] (rho(p[c]) - rho(p_prev[c])) / dt - div[c],
//   div[c] = (F_x[i] - F_x[i+1]) + (F_y[j] - F_y[j+1]) + (F_z[k] - F_z[k+1]),
// with the mass flux across a face between lo and hi values
//   q = t (p_lo - p_hi),  F = (q >= 0 ? rho(p_lo) : rho(p_hi)) / visc * q,
// and rho(p) = rho_ref exp(comp (p - p_ref)). A face on the domain boundary
// reads its outside value from pbc_x/pbc_y/pbc_z (Dirichlet ghosts), so no
// padded copy of p is made. coef = [rho_ref, comp, visc, p_ref, dt].
//
// ppt_structured_jvp computes J dp at p: the upwind side is fixed by the
// sign of the primal q (jax.lax.stop_gradient in the jax code), ghost
// tangents are 0, and the accumulation tangent is pv comp rho(p) dp / dt.
//
// One thread per cell; each interior face is evaluated by both of its cells
// with the same arithmetic, so the two see the same flux and no atomics or
// second pass are needed. Bound: bytes (p, the tangent, pv and six
// transmissibilities per cell; ~100 B per cell in f64), and at 32^3 launch
// latency.
//
// The Newton step's residual and refinement (newton_step, :116-143 of the
// jax code: jax.linearize keeps the primal's densities for its tangent
// map). ppt_structured_residual_rho is the residual launch that also
// writes the cell densities rho(p) (one value a cell); ppt_structured_refine
// writes out = c - J(p) dx in one launch, the interior neighbours' and the
// cell's densities read from that buffer and exp evaluated only for the
// Dirichlet ghosts, with c = -r computed once a step: a round of the step's
// f64 iterative refinement is one launch that evaluates no exp for a cell.
//
// The faces' fused multiply-adds are written out where nvcc's default
// contraction puts them (a product fused into the sum after it): a
// divergence term F_lo - F_hi is fma(-w_hi, q_hi, w_lo q_lo), a face's
// tangent dw q + w dq is fma(w, dq, dw q). So every instantiation rounds
// alike whatever the compiler decides, the refinement's c - J dx is (-r)
// - J dx to the bit, and the plain versions (kernels/reference.py, with
// reference.fma) form the same roundings.
//
// ppt_structured_linearize writes J(p) once a linearization as the 7-point
// stencil that bicgstab_kernel's StencilRows multiplies (krylov.cu), so the
// Krylov loop only multiplies and adds and exp stays here: out is (7, n),
// rows centre, x-, x+, y-, y+, z-, z+. A face between lo and hi contributes
// F' = a_lo dlo + a_hi dhi with the upwind side frozen by the sign of q =
// t (p_lo - p_hi) and w = rho(upwind) / visc:
//   q >= 0: a_lo = comp rho(p_lo) / visc q + w t, a_hi = -w t;
//   q < 0:  a_lo = w t, a_hi = comp rho(p_hi) / visc q - w t.
// The centre is pv comp rho(p_c) / dt minus the x-, y-, z- faces' a_hi and
// plus the x+, y+, z+ faces' a_lo; a neighbour's coefficient is -a_lo of
// its low face or a_hi of its high face, 0 where the neighbour is a ghost
// (its tangent is 0). Bound: bytes, ~1.2 MB in f32 at 32^3 (once a Newton
// step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T density(T p, T rho_ref, T comp, T p_ref) {
  return rho_ref * exp(comp * (p - p_ref));
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The upwind weight of a face and its flux q = t (p_lo - p_hi).
template <typename T>
__device__ __forceinline__ void face_flux(T t, T plo, T phi, T rlo, T rhi, T visc,
                                          T& w, T& q) {
  q = t * (plo - phi);
  w = (q >= T(0) ? rlo : rhi) / visc;
}

// A cell's divergence term along one axis: the mass flux w q of its low
// face less that of its high face, F_lo - F_hi = fma(-w_hi, q_hi, w_lo q_lo).
template <typename T>
__device__ __forceinline__ T flux_difference(T tl, T pl, T pc, T ph, T th, T rl, T rc,
                                             T rh, T visc) {
  T wl, ql, wh, qh;
  face_flux(tl, pl, pc, rl, rc, visc, wl, ql);
  face_flux(th, pc, ph, rc, rh, visc, wh, qh);
  return fma_rn(-wh, qh, mul_rn(wl, ql));
}

// Tangent of a face's mass flux: d/ds of F(p + s dp) with the upwind side
// frozen, dw q + w dq = fma(w, dq, dw q).
template <typename T>
__device__ __forceinline__ T mass_flux_dot(T t, T plo, T phi, T dlo, T dhi,
                                           T rlo, T rhi, T drlo, T drhi,
                                           T visc) {
  const T q = t * (plo - phi);
  const T dq = t * (dlo - dhi);
  const bool up = q >= T(0);
  const T w = (up ? rlo : rhi) / visc;
  const T dw = (up ? drlo : drhi) / visc;
  return fma_rn(w, dq, mul_rn(dw, q));
}

enum Mode : int { kResidual = 0, kJvp = 1, kRefine = 2 };

// kResidual: out = res at p with p_prev = q (and rho = rho(p) where rho is
// not null). kJvp: out = J(p) q. kRefine: out = c - J(p) q with the cell
// densities rho(p) read from rho (exp for the ghosts only).
template <typename T, int MODE>
__global__ void structured_kernel(const T* __restrict__ p,
                                  const T* __restrict__ q,
                                  const T* __restrict__ c_in,
                                  T* __restrict__ rho,
                                  const T* __restrict__ tx,
                                  const T* __restrict__ ty,
                                  const T* __restrict__ tz,
                                  const T* __restrict__ pbc_x,
                                  const T* __restrict__ pbc_y,
                                  const T* __restrict__ pbc_z,
                                  const T* __restrict__ pv,
                                  const T* __restrict__ coef,
                                  T* __restrict__ out, int nx, int ny,
                                  int nz) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t syz = (int64_t)ny * nz;
  if (c >= (int64_t)nx * syz) return;
  const int k = (int)(c % nz);
  const int j = (int)((c / nz) % ny);
  const int i = (int)(c / syz);
  const T rho_ref = coef[0], comp = coef[1], visc = coef[2], p_ref = coef[3],
          dt = coef[4];

  // The six neighbours: values, and whether each is a cell (else a ghost).
  const T pc = p[c];
  const bool in_xl = i > 0, in_xh = i < nx - 1;
  const bool in_yl = j > 0, in_yh = j < ny - 1;
  const bool in_zl = k > 0, in_zh = k < nz - 1;
  const T pxl = in_xl ? p[c - syz] : pbc_x[(int64_t)j * nz + k];
  const T pxh = in_xh ? p[c + syz] : pbc_x[syz + (int64_t)j * nz + k];
  const T pyl = in_yl ? p[c - nz] : pbc_y[(int64_t)i * nz + k];
  const T pyh = in_yh ? p[c + nz] : pbc_y[(int64_t)nx * nz + (int64_t)i * nz + k];
  const T pzl = in_zl ? p[c - 1] : pbc_z[(int64_t)i * ny + j];
  const T pzh = in_zh ? p[c + 1] : pbc_z[(int64_t)nx * ny + (int64_t)i * ny + j];

  // Face transmissibilities: tx (nx+1, ny, nz), ty (nx, ny+1, nz),
  // tz (nx, ny, nz+1).
  const int64_t iy = ((int64_t)i * (ny + 1) + j) * nz + k;
  const int64_t iz = ((int64_t)i * ny + j) * (nz + 1) + k;
  const T txl = tx[c], txh = tx[c + syz];
  const T tyl = ty[iy], tyh = ty[iy + nz];
  const T tzl = tz[iz], tzh = tz[iz + 1];

  // Densities: computed here, or, for the refinement, read from the
  // residual launch's buffer wherever the neighbour is a cell.
  const bool given = MODE == kRefine;
  const T rc = given ? rho[c] : density(pc, rho_ref, comp, p_ref);
  const T rxl = given && in_xl ? rho[c - syz] : density(pxl, rho_ref, comp, p_ref);
  const T rxh = given && in_xh ? rho[c + syz] : density(pxh, rho_ref, comp, p_ref);
  const T ryl = given && in_yl ? rho[c - nz] : density(pyl, rho_ref, comp, p_ref);
  const T ryh = given && in_yh ? rho[c + nz] : density(pyh, rho_ref, comp, p_ref);
  const T rzl = given && in_zl ? rho[c - 1] : density(pzl, rho_ref, comp, p_ref);
  const T rzh = given && in_zh ? rho[c + 1] : density(pzh, rho_ref, comp, p_ref);

  if (MODE == kResidual) {
    const T div =
        (flux_difference(txl, pxl, pc, pxh, txh, rxl, rc, rxh, visc) +
         flux_difference(tyl, pyl, pc, pyh, tyh, ryl, rc, ryh, visc)) +
        flux_difference(tzl, pzl, pc, pzh, tzh, rzl, rc, rzh, visc);
    const T acc =
        pv[c] * (rc - density(q[c], rho_ref, comp, p_ref)) / dt;
    out[c] = acc - div;
    if (rho != nullptr) rho[c] = rc;
  } else {
    const T dc = q[c];
    const T dxl = in_xl ? q[c - syz] : T(0);
    const T dxh = in_xh ? q[c + syz] : T(0);
    const T dyl = in_yl ? q[c - nz] : T(0);
    const T dyh = in_yh ? q[c + nz] : T(0);
    const T dzl = in_zl ? q[c - 1] : T(0);
    const T dzh = in_zh ? q[c + 1] : T(0);
    // rho' = comp rho; ghost tangents are 0.
    const T drc = comp * rc * dc;
    const T drxl = comp * rxl * dxl, drxh = comp * rxh * dxh;
    const T dryl = comp * ryl * dyl, dryh = comp * ryh * dyh;
    const T drzl = comp * rzl * dzl, drzh = comp * rzh * dzh;
    const T ddiv =
        ((mass_flux_dot(txl, pxl, pc, dxl, dc, rxl, rc, drxl, drc, visc) -
          mass_flux_dot(txh, pc, pxh, dc, dxh, rc, rxh, drc, drxh, visc)) +
         (mass_flux_dot(tyl, pyl, pc, dyl, dc, ryl, rc, dryl, drc, visc) -
          mass_flux_dot(tyh, pc, pyh, dc, dyh, rc, ryh, drc, dryh, visc))) +
        (mass_flux_dot(tzl, pzl, pc, dzl, dc, rzl, rc, drzl, drc, visc) -
         mass_flux_dot(tzh, pc, pzh, dc, dzh, rc, rzh, drc, drzh, visc));
    const T jv = pv[c] * drc / dt - ddiv;
    out[c] = MODE == kRefine ? c_in[c] - jv : jv;
  }
}

// The coefficients of one face's tangent on its lo and hi values.
template <typename T>
__device__ __forceinline__ void face_coefs(T t, T plo, T phi, T rlo, T rhi,
                                           T comp, T visc, T& alo, T& ahi) {
  const T q = t * (plo - phi);
  const bool up = q >= T(0);
  const T wt = (up ? rlo : rhi) / visc * t;
  if (up) {
    alo = comp * rlo / visc * q + wt;
    ahi = -wt;
  } else {
    alo = wt;
    ahi = comp * rhi / visc * q - wt;
  }
}

template <typename T>
__global__ void structured_linearize_kernel(
    const T* __restrict__ p, const T* __restrict__ tx, const T* __restrict__ ty,
    const T* __restrict__ tz, const T* __restrict__ pbc_x,
    const T* __restrict__ pbc_y, const T* __restrict__ pbc_z,
    const T* __restrict__ pv, const T* __restrict__ coef, T* __restrict__ out,
    int nx, int ny, int nz) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t syz = (int64_t)ny * nz;
  const int64_t n = (int64_t)nx * syz;
  if (c >= n) return;
  const int k = (int)(c % nz);
  const int j = (int)((c / nz) % ny);
  const int i = (int)(c / syz);
  const T rho_ref = coef[0], comp = coef[1], visc = coef[2], p_ref = coef[3],
          dt = coef[4];

  const T pc = p[c];
  const bool in_xl = i > 0, in_xh = i < nx - 1;
  const bool in_yl = j > 0, in_yh = j < ny - 1;
  const bool in_zl = k > 0, in_zh = k < nz - 1;
  const T pxl = in_xl ? p[c - syz] : pbc_x[(int64_t)j * nz + k];
  const T pxh = in_xh ? p[c + syz] : pbc_x[syz + (int64_t)j * nz + k];
  const T pyl = in_yl ? p[c - nz] : pbc_y[(int64_t)i * nz + k];
  const T pyh = in_yh ? p[c + nz] : pbc_y[(int64_t)nx * nz + (int64_t)i * nz + k];
  const T pzl = in_zl ? p[c - 1] : pbc_z[(int64_t)i * ny + j];
  const T pzh = in_zh ? p[c + 1] : pbc_z[(int64_t)nx * ny + (int64_t)i * ny + j];
  const int64_t iy = ((int64_t)i * (ny + 1) + j) * nz + k;
  const int64_t iz = ((int64_t)i * ny + j) * (nz + 1) + k;

  const T rc = density(pc, rho_ref, comp, p_ref);
  T xl_lo, xl_hi, xh_lo, xh_hi, yl_lo, yl_hi, yh_lo, yh_hi, zl_lo, zl_hi, zh_lo, zh_hi;
  face_coefs(tx[c], pxl, pc, density(pxl, rho_ref, comp, p_ref), rc, comp, visc, xl_lo, xl_hi);
  face_coefs(tx[c + syz], pc, pxh, rc, density(pxh, rho_ref, comp, p_ref), comp, visc, xh_lo, xh_hi);
  face_coefs(ty[iy], pyl, pc, density(pyl, rho_ref, comp, p_ref), rc, comp, visc, yl_lo, yl_hi);
  face_coefs(ty[iy + nz], pc, pyh, rc, density(pyh, rho_ref, comp, p_ref), comp, visc, yh_lo, yh_hi);
  face_coefs(tz[iz], pzl, pc, density(pzl, rho_ref, comp, p_ref), rc, comp, visc, zl_lo, zl_hi);
  face_coefs(tz[iz + 1], pc, pzh, rc, density(pzh, rho_ref, comp, p_ref), comp, visc, zh_lo, zh_hi);

  out[c] = pv[c] * (comp * rc) / dt - xl_hi + xh_lo - yl_hi + yh_lo - zl_hi + zh_lo;
  out[n + c] = in_xl ? -xl_lo : T(0);
  out[2 * n + c] = in_xh ? xh_hi : T(0);
  out[3 * n + c] = in_yl ? -yl_lo : T(0);
  out[4 * n + c] = in_yh ? yh_hi : T(0);
  out[5 * n + c] = in_zl ? -zl_lo : T(0);
  out[6 * n + c] = in_zh ? zh_hi : T(0);
}

template <typename T, int MODE>
int launch(const T* p, const T* q, const T* c_in, T* rho, const T* tx, const T* ty,
           const T* tz, const T* pbc_x, const T* pbc_y, const T* pbc_z, const T* pv,
           const T* coef, T* out, int nx, int ny, int nz, void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  if (n == 0) return 0;
  if (MODE == kRefine && (c_in == nullptr || rho == nullptr)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  structured_kernel<T, MODE><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      p, q, c_in, rho, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef, out, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace

#define PPT_STRUCTURED(NAME, T, MODE)                                         \
  extern "C" int NAME(const T* p, const T* q, const T* tx, const T* ty,       \
                      const T* tz, const T* pbc_x, const T* pbc_y,            \
                      const T* pbc_z, const T* pv, const T* coef, T* out,     \
                      int nx, int ny, int nz, void* stream) {                 \
    return launch<T, MODE>(p, q, nullptr, nullptr, tx, ty, tz, pbc_x, pbc_y,  \
                           pbc_z, pv, coef, out, nx, ny, nz, stream);         \
  }

PPT_STRUCTURED(ppt_structured_residual_f32, float, kResidual)
PPT_STRUCTURED(ppt_structured_residual_f64, double, kResidual)
PPT_STRUCTURED(ppt_structured_jvp_f32, float, kJvp)
PPT_STRUCTURED(ppt_structured_jvp_f64, double, kJvp)

// The residual and, into rho, the cell densities rho(p).
#define PPT_STRUCTURED_RESIDUAL_RHO(NAME, T)                                  \
  extern "C" int NAME(const T* p, const T* q, const T* tx, const T* ty,       \
                      const T* tz, const T* pbc_x, const T* pbc_y,            \
                      const T* pbc_z, const T* pv, const T* coef, T* out,     \
                      T* rho, int nx, int ny, int nz, void* stream) {         \
    if (rho == nullptr) return (int)cudaErrorInvalidValue;                    \
    return launch<T, kResidual>(p, q, nullptr, rho, tx, ty, tz, pbc_x, pbc_y, \
                                pbc_z, pv, coef, out, nx, ny, nz, stream);    \
  }

PPT_STRUCTURED_RESIDUAL_RHO(ppt_structured_residual_rho_f32, float)
PPT_STRUCTURED_RESIDUAL_RHO(ppt_structured_residual_rho_f64, double)

// out = c - J(p) dx, with rho the cell densities of the residual launch.
#define PPT_STRUCTURED_REFINE(NAME, T)                                        \
  extern "C" int NAME(const T* p, const T* dx, const T* c, const T* rho,      \
                      const T* tx, const T* ty, const T* tz,                  \
                      const T* pbc_x, const T* pbc_y, const T* pbc_z,         \
                      const T* pv, const T* coef, T* out, int nx, int ny,     \
                      int nz, void* stream) {                                 \
    return launch<T, kRefine>(p, dx, c, const_cast<T*>(rho), tx, ty, tz,      \
                              pbc_x, pbc_y, pbc_z, pv, coef, out, nx, ny, nz, \
                              stream);                                        \
  }

PPT_STRUCTURED_REFINE(ppt_structured_refine_f32, float)
PPT_STRUCTURED_REFINE(ppt_structured_refine_f64, double)

#define PPT_STRUCTURED_LINEARIZE(NAME, T)                                     \
  extern "C" int NAME(const T* p, const T* tx, const T* ty, const T* tz,      \
                      const T* pbc_x, const T* pbc_y, const T* pbc_z,         \
                      const T* pv, const T* coef, T* out, int nx, int ny,     \
                      int nz, void* stream) {                                 \
    const int64_t n = (int64_t)nx * ny * nz;                                  \
    if (n == 0) return 0;                                                     \
    const int threads = 256;                                                  \
    structured_linearize_kernel<T><<<(unsigned)((n + threads - 1) / threads), \
                                     threads, 0, (cudaStream_t)stream>>>(     \
        p, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef, out, nx, ny, nz);      \
    return (int)cudaGetLastError();                                           \
  }

PPT_STRUCTURED_LINEARIZE(ppt_structured_linearize_f32, float)
PPT_STRUCTURED_LINEARIZE(ppt_structured_linearize_f64, double)
