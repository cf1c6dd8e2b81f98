// K13: residual and Jacobian action of the unstructured TPFA single-phase
// flow step.
//
// Replaces porepy_tpu/parallel/flow_step.py:64-97 (TpfaFlowKernel.face_flux
// and residual) and the tangent that jax.linearize derives from them inside
// newton_step (:104).
//
// Two passes per call, both launched by one entry point:
//
// 1. face pass, one thread per face f with cells lo[f], hi[f] (-1: none,
//    the face's Dirichlet value bc_val[f] stands in):
//      q = is_neu[f] ? bc_val[f] : t[f] (p_lo - p_hi),
//      m[f] = is_neu[f] ? q : (q >= 0 ? rho(p_lo) : rho(p_hi)) / visc * q;
//    the JVP pass writes the tangent of m[f] at p along dp, with the upwind
//    side fixed by the sign of the primal q and ghost tangents 0.
// 2. cell pass, one thread per cell c, gathering its faces through a
//    host-built CSR: cell_ptr (nc + 1), cell_faces holding f for a face
//    where c = lo[f] and -f - 1 where c = hi[f] (lo faces first, then hi
//    faces, each in face order: the order of the two segment sums of the
//    jax code),
//      res[c] = pv[c] (rho(p[c]) - rho(p_prev[c])) / dt + sum (+-m[f]).
//
// The jax code scatters the face fluxes into the cells with .at[].add;
// a CUDA scatter would need atomicAdd, whose order changes from run to run.
// The gather sums every cell's faces in one fixed order, so the result is
// deterministic. m is scratch of nf entries allocated by the caller.
// coef = [rho_ref, comp, visc, p_ref, dt]. Bound: bytes and gathers of the
// face arrays (~60 B per face in f64), and at 32^3 launch latency.
//
// ppt_tpfa_linearize writes J(p) once a linearization as the values of a
// cell-cell CSR matrix on a pattern fixed by the topology (built on the
// host: the diagonal and one column per neighbour, each row's columns in
// increasing order), which bicgstab_kernel's CsrRows multiplies
// (krylov.cu). The cell-cell matrix reads fewer bytes an iteration than the
// face form (two coefficients a face gathered through cell_faces): at 32^3
// 223,232 values and columns, ~2.8 MB in f64, against ~3.2 MB of face
// coefficients, face indices and the cell-to-face list, and one dependent
// gather a product where the face form has three (entry, face, cell). A
// face's tangent is dm = a_lo d_lo + a_hi d_hi with the upwind side frozen
// by the sign of the primal q (0 on Neumann faces):
//   q >= 0: a_lo = comp rho(p_lo) / visc q + w t, a_hi = -w t;
//   q < 0:  a_lo = w t, a_hi = comp rho(p_hi) / visc q - w t;
// one thread per cell c, over its faces in cell_faces order: where c =
// lo[f] the diagonal gains a_lo and hi[f]'s column a_hi, where c = hi[f]
// the diagonal loses a_hi and lo[f]'s column a_lo; the diagonal starts from
// pv comp rho(p_c) / dt. slot[e] is the value index of entry e's neighbour
// (-1: a boundary face), diag_slot[c] that of the diagonal; the thread
// zeroes its row's slots first, so two faces between one pair of cells
// add up. Bound: bytes, ~4.4 MB in f64 at 32^3 (once a Newton step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T density(T p, T rho_ref, T comp, T p_ref) {
  return rho_ref * exp(comp * (p - p_ref));
}

template <typename T, bool JVP>
__global__ void tpfa_face_kernel(const T* __restrict__ p,
                                 const T* __restrict__ dp,
                                 const int* __restrict__ lo,
                                 const int* __restrict__ hi,
                                 const T* __restrict__ t,
                                 const unsigned char* __restrict__ is_neu,
                                 const T* __restrict__ bc_val,
                                 const T* __restrict__ coef,
                                 T* __restrict__ m, int nf) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const T rho_ref = coef[0], comp = coef[1], visc = coef[2], p_ref = coef[3];
  const int l = lo[f], h = hi[f];
  const T bc = bc_val[f];
  const bool neu = is_neu[f] != 0;
  const T plo = l >= 0 ? p[l] : bc;
  const T phi = h >= 0 ? p[h] : bc;
  const T q = neu ? bc : t[f] * (plo - phi);
  const T rlo = density(plo, rho_ref, comp, p_ref);
  const T rhi = density(phi, rho_ref, comp, p_ref);
  const bool up = q >= T(0);
  const T w = (up ? rlo : rhi) / visc;
  if (!JVP) {
    m[f] = neu ? q : w * q;
  } else {
    const T dlo = l >= 0 ? dp[l] : T(0);
    const T dhi = h >= 0 ? dp[h] : T(0);
    const T dq = neu ? T(0) : t[f] * (dlo - dhi);
    const T dw = (up ? comp * rlo * dlo : comp * rhi * dhi) / visc;
    m[f] = neu ? dq : dw * q + w * dq;
  }
}

// JVP = false: q is p_prev. JVP = true: q is dp.
template <typename T, bool JVP>
__global__ void tpfa_cell_kernel(const T* __restrict__ p,
                                 const T* __restrict__ q,
                                 const T* __restrict__ pv,
                                 const int* __restrict__ cell_ptr,
                                 const int* __restrict__ cell_faces,
                                 const T* __restrict__ coef,
                                 const T* __restrict__ m,
                                 T* __restrict__ out, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const T rho_ref = coef[0], comp = coef[1], p_ref = coef[3], dt = coef[4];
  T div = T(0);
  for (int e = cell_ptr[c]; e < cell_ptr[c + 1]; ++e) {
    const int v = cell_faces[e];
    div += v >= 0 ? m[v] : -m[-v - 1];
  }
  const T rc = density(p[c], rho_ref, comp, p_ref);
  const T acc = JVP ? pv[c] * (comp * rc * q[c]) / dt
                    : pv[c] * (rc - density(q[c], rho_ref, comp, p_ref)) / dt;
  out[c] = acc + div;
}

template <typename T>
__global__ void tpfa_linearize_kernel(
    const T* __restrict__ p, const int* __restrict__ lo,
    const int* __restrict__ hi, const T* __restrict__ t,
    const unsigned char* __restrict__ is_neu, const T* __restrict__ bc_val,
    const T* __restrict__ pv, const int* __restrict__ cell_ptr,
    const int* __restrict__ cell_faces, const T* __restrict__ coef,
    const int* __restrict__ slot, const int* __restrict__ diag_slot,
    T* __restrict__ vals, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const T rho_ref = coef[0], comp = coef[1], visc = coef[2], p_ref = coef[3],
          dt = coef[4];
  const int e0 = cell_ptr[c], e1 = cell_ptr[c + 1];
  for (int e = e0; e < e1; ++e)
    if (slot[e] >= 0) vals[slot[e]] = T(0);
  T d = pv[c] * (comp * density(p[c], rho_ref, comp, p_ref)) / dt;
  for (int e = e0; e < e1; ++e) {
    const int v = cell_faces[e];
    const int f = v >= 0 ? v : -v - 1;
    if (is_neu[f]) continue;
    const int l = lo[f], h = hi[f];
    const T bc = bc_val[f];
    const T plo = l >= 0 ? p[l] : bc;
    const T phi = h >= 0 ? p[h] : bc;
    const T rlo = density(plo, rho_ref, comp, p_ref);
    const T rhi = density(phi, rho_ref, comp, p_ref);
    const T q = t[f] * (plo - phi);
    const bool up = q >= T(0);
    const T wt = (up ? rlo : rhi) / visc * t[f];
    const T alo = up ? comp * rlo / visc * q + wt : wt;
    const T ahi = up ? -wt : comp * rhi / visc * q - wt;
    const int k = slot[e];
    if (v >= 0) {
      d += alo;
      if (k >= 0) vals[k] += ahi;
    } else {
      d -= ahi;
      if (k >= 0) vals[k] -= alo;
    }
  }
  vals[diag_slot[c]] = d;
}

template <typename T, bool JVP>
int launch(const T* p, const T* q, const int* lo, const int* hi, const T* t,
           const unsigned char* is_neu, const T* bc_val, const T* pv,
           const int* cell_ptr, const int* cell_faces, const T* coef, T* m,
           T* out, int nc, int nf, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (nf > 0) {
    tpfa_face_kernel<T, JVP><<<(nf + threads - 1) / threads, threads, 0, s>>>(
        p, q, lo, hi, t, is_neu, bc_val, coef, m, nf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nc > 0) {
    tpfa_cell_kernel<T, JVP><<<(nc + threads - 1) / threads, threads, 0, s>>>(
        p, q, pv, cell_ptr, cell_faces, coef, m, out, nc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define PPT_TPFA(NAME, T, JVP)                                                \
  extern "C" int NAME(const T* p, const T* q, const int* lo, const int* hi,   \
                      const T* t, const unsigned char* is_neu,                \
                      const T* bc_val, const T* pv, const int* cell_ptr,      \
                      const int* cell_faces, const T* coef, T* m, T* out,     \
                      int nc, int nf, void* stream) {                         \
    return launch<T, JVP>(p, q, lo, hi, t, is_neu, bc_val, pv, cell_ptr,      \
                          cell_faces, coef, m, out, nc, nf, stream);          \
  }

PPT_TPFA(ppt_tpfa_residual_f32, float, false)
PPT_TPFA(ppt_tpfa_residual_f64, double, false)
PPT_TPFA(ppt_tpfa_jvp_f32, float, true)
PPT_TPFA(ppt_tpfa_jvp_f64, double, true)

#define PPT_TPFA_LINEARIZE(NAME, T)                                           \
  extern "C" int NAME(const T* p, const int* lo, const int* hi, const T* t,   \
                      const unsigned char* is_neu, const T* bc_val,           \
                      const T* pv, const int* cell_ptr,                       \
                      const int* cell_faces, const T* coef, const int* slot,  \
                      const int* diag_slot, T* vals, int nc, void* stream) {  \
    if (nc == 0) return 0;                                                    \
    const int threads = 256;                                                  \
    tpfa_linearize_kernel<T><<<(nc + threads - 1) / threads, threads, 0,      \
                               (cudaStream_t)stream>>>(                       \
        p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot,   \
        diag_slot, vals, nc);                                                 \
    return (int)cudaGetLastError();                                           \
  }

PPT_TPFA_LINEARIZE(ppt_tpfa_linearize_f32, float)
PPT_TPFA_LINEARIZE(ppt_tpfa_linearize_f64, double)
