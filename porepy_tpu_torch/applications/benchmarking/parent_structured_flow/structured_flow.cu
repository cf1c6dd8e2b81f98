// The parent's K12 kernels, kept beside structured_refine_check.py as the
// yardstick of the residual and refinement launches that
// kernels/csrc/structured_flow.cu holds now (the refinement's c - J dx was
// a structured_jvp launch and two torch operations); built by that script
// alone, never by the package.

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

template <typename T>
__device__ __forceinline__ T mass_flux(T t, T plo, T phi, T rlo, T rhi,
                                       T visc) {
  const T q = t * (plo - phi);
  const T w = (q >= T(0) ? rlo : rhi) / visc;
  return w * q;
}

// Tangent of mass_flux: d/ds of F(p + s dp) with the upwind side frozen.
template <typename T>
__device__ __forceinline__ T mass_flux_dot(T t, T plo, T phi, T dlo, T dhi,
                                           T rlo, T rhi, T drlo, T drhi,
                                           T visc) {
  const T q = t * (plo - phi);
  const T dq = t * (dlo - dhi);
  const bool up = q >= T(0);
  const T w = (up ? rlo : rhi) / visc;
  const T dw = (up ? drlo : drhi) / visc;
  return dw * q + w * dq;
}

// JVP = false: res at p with p_prev = q. JVP = true: J(p) q.
template <typename T, bool JVP>
__global__ void structured_kernel(const T* __restrict__ p,
                                  const T* __restrict__ q,
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

  const T rc = density(pc, rho_ref, comp, p_ref);
  const T rxl = density(pxl, rho_ref, comp, p_ref);
  const T rxh = density(pxh, rho_ref, comp, p_ref);
  const T ryl = density(pyl, rho_ref, comp, p_ref);
  const T ryh = density(pyh, rho_ref, comp, p_ref);
  const T rzl = density(pzl, rho_ref, comp, p_ref);
  const T rzh = density(pzh, rho_ref, comp, p_ref);

  if (!JVP) {
    const T div =
        ((mass_flux(txl, pxl, pc, rxl, rc, visc) -
          mass_flux(txh, pc, pxh, rc, rxh, visc)) +
         (mass_flux(tyl, pyl, pc, ryl, rc, visc) -
          mass_flux(tyh, pc, pyh, rc, ryh, visc))) +
        (mass_flux(tzl, pzl, pc, rzl, rc, visc) -
         mass_flux(tzh, pc, pzh, rc, rzh, visc));
    const T acc =
        pv[c] * (rc - density(q[c], rho_ref, comp, p_ref)) / dt;
    out[c] = acc - div;
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
    out[c] = pv[c] * drc / dt - ddiv;
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

template <typename T, bool JVP>
int launch(const T* p, const T* q, const T* tx, const T* ty, const T* tz,
           const T* pbc_x, const T* pbc_y, const T* pbc_z, const T* pv,
           const T* coef, T* out, int nx, int ny, int nz, void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  structured_kernel<T, JVP><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      p, q, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef, out, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace

#define PPT_STRUCTURED(NAME, T, JVP)                                          \
  extern "C" int NAME(const T* p, const T* q, const T* tx, const T* ty,       \
                      const T* tz, const T* pbc_x, const T* pbc_y,            \
                      const T* pbc_z, const T* pv, const T* coef, T* out,     \
                      int nx, int ny, int nz, void* stream) {                 \
    return launch<T, JVP>(p, q, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef,    \
                          out, nx, ny, nz, stream);                           \
  }

PPT_STRUCTURED(ppt_structured_residual_f32, float, false)
PPT_STRUCTURED(ppt_structured_residual_f64, double, false)
PPT_STRUCTURED(ppt_structured_jvp_f32, float, true)
PPT_STRUCTURED(ppt_structured_jvp_f64, double, true)

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
