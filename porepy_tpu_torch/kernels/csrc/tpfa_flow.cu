// K13: the unstructured TPFA single-phase flow step's residual, Jacobian
// action, Jacobian values and Jacobi diagonal.
//
// Replaces porepy_tpu/parallel/flow_step.py:64-97 (TpfaFlowKernel.face_flux
// and residual), the tangent that jax.linearize derives from them inside
// newton_step (:104) and the Jacobi diagonal (_jacobi_diagonal, :119-137).
//
// One kernel template, one launch a call. Each cell c takes its row of the
// host-built cell-to-face CSR (cell_ptr (nc + 1), cell_faces: f for a face
// where c = lo[f], -f - 1 where c = hi[f]; lo faces first, then hi faces,
// each in face order: the order of the jax code's two segment sums) and
// evaluates each face itself, with the face's other side read from p (or
// its Dirichlet value bc_val[f] where lo/hi is -1):
//   q = is_neu[f] ? bc_val[f] : t[f] (p_lo - p_hi),
//   m = is_neu[f] ? q : w q,  w = (q >= 0 ? rho(p_lo) : rho(p_hi)) / visc,
//   res[c] = pv[c] (rho(p[c]) - rho(p_prev[c])) / dt + sum (+-m),
// adding +m where c = lo[f] and -m where c = hi[f], to 0, in the row's
// order. An interior face is evaluated by both of its cells with the same
// arithmetic, so the two see the same flux: no scratch array of face
// fluxes, no second pass and no atomics (the jax code scatters with
// .at[].add; a CUDA scatter would need atomicAdd, whose order changes from
// run to run). coef = [rho_ref, comp, visc, p_ref, dt]. Each face entry
// costs one exp, its other side's (none on a Neumann face, whose ghost value
// is a flux and whose "density" may be inf: it reaches no output).
//
// Threads: one a cell, kThreads (128) a block. A thread walks its row
// kBatch (8) entries at a time: the batch's loads issued together (the
// codes, then the faces' arrays, then the other sides' p), then its entries
// evaluated and added in order. A row of at most kBatch entries sums each
// Jacobian value in registers (from 0, by the slot's first entry); a longer
// one zeroes its slots first and adds in memory. The block size and the
// batch were chosen at 32^3 against 256 x 8, 64 x 8, 128 x 4 and 128 x 1
// (PERF.md section 6 keeps their times): the residual is ~2.5 us of launch
// and cell work and ~3 us of face work whatever the batch, the step gains
// from batching.
//
// The modes (Mode), each an extern "C" entry point per type:
// - kResidual (ppt_tpfa_residual): res above.
// - kJvp (ppt_tpfa_jvp): J(p) dp, the upwind side frozen by the sign of the
//   primal q, ghost tangents 0, a Neumann face's tangent 0 (added as +-0,
//   as the jax code's scatter adds it); the accumulation's tangent
//   pv comp rho(p) dp / dt.
// - kLinearize (ppt_tpfa_linearize): J(p) as the values of a cell-cell CSR
//   matrix on a pattern fixed by the topology (built on the host: the
//   diagonal and one column per neighbour, each row's columns in increasing
//   order), which bicgstab_kernel's CsrRows multiplies (krylov.cu). A face's
//   tangent is dm = a_lo d_lo + a_hi d_hi with the upwind side frozen by the
//   sign of q (a Neumann face is skipped):
//     q >= 0: a_lo = comp rho(p_lo) / visc q + w t, a_hi = -w t;
//     q < 0:  a_lo = w t, a_hi = comp rho(p_hi) / visc q - w t;
//   where c = lo[f] the diagonal gains a_lo and hi[f]'s column a_hi, where
//   c = hi[f] the diagonal loses a_hi and lo[f]'s column a_lo; the diagonal
//   starts from pv (comp rho(p_c)) / dt. slot[e] is the value index of entry
//   e's neighbour (-1: a boundary face), diag_slot[c] that of the diagonal;
//   two faces between one pair of cells add up, from 0, in the row's order.
// - kStep (ppt_tpfa_step): the Newton step's operands at p in one launch:
//   res, the values of kLinearize and the Jacobi diagonal
//     diag[c] = t_sum[c] (rho(p_c) / visc) + ((pv[c] comp) rho(p_c)) / dt,
//   1 where |diag| <= 1e-30 (t_sum: each cell's non-Neumann
//   transmissibilities, summed on the host). Each face's q, densities and
//   upwind choice are computed once a walk and serve all three.
//
// Rounding. Every mode rounds as the parent's kernels (a face pass writing
// m, a cell pass gathering it; and the linearization) and the torch
// composition of the diagonal did, so each equals its plain version in
// kernels/reference.py to the bit. The parent stored each residual face's
// w q before summing it: the product is __dmul_rn/__fmul_rn here, so it is
// not fused into the sum. Where nvcc's default contraction fused a product
// into the sum after it in the parent's compiled code, the fused
// multiply-add is written out (found by tpfa_step_check.py's probe: the
// parent's face tangents and Jacobian values against the plain forms with
// and without it, f64 and f32):
//   the jvp's dw q + w dq = fma(dw, q, w dq);
//   a_lo = fma(comp rho(p_lo) / visc, q, w t), with w t rounded;
// and where it did not, the product is rounded apart:
//   a_hi = (comp rho(p_hi) / visc) q - w t
// (the parent's SASS: a DFMA in the q >= 0 branch, a DMUL and a DADD in the
// other; FFMA, FMUL and FADD in f32).
// The accumulation rho(p) - rho(p_prev) is fma(rho_ref, exp(comp (p -
// p_ref)), -rho(p_prev)), as nvcc fused it in the parent's cell pass (and
// as the probe cannot see: at a random state the faces' fluxes swamp it;
// near Newton's floor and at p = p_prev it sets the residual's last bits).
// The diagonal keeps the torch association above with no contraction (its
// products are rounded apart); the linearization's centre pv (comp rho) / dt
// is another expression. Bound: bytes; at 32^3 (101,376 faces) in f64 the
// residual reads ~4.5 MB, the step ~7.7 MB (the pattern's slots and the
// values too).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;

// rho(p) = rho_ref growth(p).
template <typename T>
__device__ __forceinline__ T growth(T p, T comp, T p_ref) {
  return exp(comp * (p - p_ref));
}

template <typename T>
__device__ __forceinline__ T density(T p, T rho_ref, T comp, T p_ref) {
  return rho_ref * growth(p, comp, p_ref);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

enum Mode : int { kResidual = 0, kJvp = 1, kLinearize = 2, kStep = 3 };

// One problem's arrays (all read-only but out, vals and diag). q is p_prev
// (kResidual, kStep) or dp (kJvp); out is res or J dp.
template <typename T>
struct Problem {
  const T* p;
  const T* q;
  const int* lo;
  const int* hi;
  const T* t;
  const unsigned char* is_neu;
  const T* bc_val;
  const T* pv;
  const int* cell_ptr;
  const int* cell_faces;
  const T* coef;
  const T* t_sum;
  const int* slot;
  const int* diag_slot;
  T* out;
  T* vals;
  T* diag;
  int nc;
};

// The fluid's scalars.
template <typename T>
struct Coef {
  T rho_ref, comp, visc, p_ref, dt;
};

// The cell's own values a walk reads once: p, its growth and density, its
// tangent.
template <typename T>
struct Cell {
  T p, e, rho, dp;
};

// What one entry of a cell's row reads: its face's side (own: the cell is
// lo[f]), Neumann flag, bc_val and t, the other side's cell (-1: none), its
// p (or bc_val) and tangent, the entry's value slot.
template <typename T>
struct Face {
  T bc, t, po, dpo;
  int o, slot;
  bool own, neu;
};

// What one entry adds: to the divergence (its signed mass flux or tangent),
// to the diagonal and to its neighbour's value (lin: the entry adds to these
// two; a Neumann face does not), and that value's slot.
template <typename T>
struct Entry {
  T div, to_diag, to_other;
  int slot;
  bool lin;
};

// The loads that follow from the entry's code v = cell_faces[e].
template <typename T, int MODE>
__device__ __forceinline__ Face<T> face_arrays(const Problem<T>& P, int e, int v) {
  constexpr bool kValues = MODE == kLinearize || MODE == kStep;
  Face<T> x;
  x.own = v >= 0;
  const int f = x.own ? v : -v - 1;
  x.bc = __ldg(P.bc_val + f);
  x.neu = __ldg(P.is_neu + f) != 0;
  x.t = __ldg(P.t + f);
  x.o = __ldg(x.own ? P.hi + f : P.lo + f);
  x.slot = kValues ? __ldg(P.slot + e) : -1;
  x.po = x.bc;
  x.dpo = T(0);
  return x;
}

// The loads that follow from the other side's cell.
template <typename T, int MODE>
__device__ __forceinline__ void face_values(const Problem<T>& P, Face<T>& x) {
  if (x.neu || x.o < 0) return;
  x.po = __ldg(P.p + x.o);
  if (MODE == kJvp) x.dpo = __ldg(P.q + x.o);
}

template <typename T, int MODE>
__device__ __forceinline__ Entry<T> evaluate(const Face<T>& x, const Cell<T>& c, const Coef<T>& k) {
  constexpr bool kFlux = MODE == kResidual || MODE == kStep;
  constexpr bool kValues = MODE == kLinearize || MODE == kStep;
  Entry<T> r{T(0), T(0), T(0), x.slot, false};
  if (x.neu) {
    // The prescribed flux; its tangent 0 (added, as the jax code's scatter
    // adds it); no Jacobian value.
    const T m = MODE == kJvp ? T(0) : x.bc;
    r.div = x.own ? m : -m;
    return r;
  }
  const T plo = x.own ? c.p : x.po, phi = x.own ? x.po : c.p;
  const T ro = density(x.po, k.rho_ref, k.comp, k.p_ref);
  const T rlo = x.own ? c.rho : ro, rhi = x.own ? ro : c.rho;
  const T qf = x.t * (plo - phi);
  const bool up = qf >= T(0);
  const T w = (up ? rlo : rhi) / k.visc;
  if (kFlux) {
    const T m = mul_rn(w, qf);
    r.div = x.own ? m : -m;
  }
  if (MODE == kJvp) {
    const T dlo = x.own ? c.dp : x.dpo, dhi = x.own ? x.dpo : c.dp;
    const T dq = x.t * (dlo - dhi);
    const T dw = (up ? k.comp * rlo * dlo : k.comp * rhi * dhi) / k.visc;
    const T m = fma_rn(dw, qf, mul_rn(w, dq));
    r.div = x.own ? m : -m;
  }
  if (kValues) {
    const T wt = mul_rn(w, x.t);
    const T alo = up ? fma_rn(k.comp * rlo / k.visc, qf, wt) : wt;
    const T ahi = up ? -wt : mul_rn(k.comp * rhi / k.visc, qf) - wt;
    r.to_diag = x.own ? alo : -ahi;
    r.to_other = x.own ? ahi : -alo;
    r.lin = true;
  }
  return r;
}

// One thread's walk of a row of n entries from e0, kBatch entries at a time:
// the batch's loads issued together (codes, then face arrays, then the other
// sides), then its entries evaluated and added in order. A row of at most
// kBatch entries sums each value in registers (from 0, by the slot's first
// entry); a longer one zeroes its slots and adds to them in memory.
template <typename T, int MODE>
__device__ __forceinline__ void walk(const Problem<T>& P, int e0, int n, const Cell<T>& cell, const Coef<T>& k,
                                     T& div, T& d) {
  constexpr bool kValues = MODE == kLinearize || MODE == kStep;
  const bool whole = n <= kBatch;
  if (kValues && !whole)
    for (int e = e0; e < e0 + n; ++e) {
      const int s = __ldg(P.slot + e);
      if (s >= 0) P.vals[s] = T(0);
    }
  for (int b = 0; b < n; b += kBatch) {
    const int cnt = min(kBatch, n - b);
    int code[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) code[j] = j < cnt ? __ldg(P.cell_faces + e0 + b + j) : 0;
    Face<T> f[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < cnt) f[j] = face_arrays<T, MODE>(P, e0 + b + j, code[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < cnt) face_values<T, MODE>(P, f[j]);
    Entry<T> x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < cnt) x[j] = evaluate<T, MODE>(f[j], cell, k);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < cnt) {
        div += x[j].div;
        if (kValues && x[j].lin) d += x[j].to_diag;
      }
    if constexpr (kValues) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j >= cnt || x[j].slot < 0) continue;
        if (!whole) {
          if (x[j].lin) P.vals[x[j].slot] += x[j].to_other;
          continue;
        }
        bool first = true;
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (i >= cnt || x[i].slot != x[j].slot) continue;
          if (i < j)
            first = false;
          else if (x[i].lin)
            acc += x[i].to_other;
        }
        if (first) P.vals[x[j].slot] = acc;
      }
    }
  }
}

// One thread a cell: it walks its row (walk).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) tpfa_kernel(const Problem<T> P) {
  constexpr bool kValues = MODE == kLinearize || MODE == kStep;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.nc) return;
  const Coef<T> k{__ldg(P.coef), __ldg(P.coef + 1), __ldg(P.coef + 2), __ldg(P.coef + 3), __ldg(P.coef + 4)};
  const int e0 = __ldg(P.cell_ptr + c), n = __ldg(P.cell_ptr + c + 1) - e0;
  Cell<T> cell;
  cell.p = __ldg(P.p + c);
  cell.e = growth(cell.p, k.comp, k.p_ref);
  cell.rho = mul_rn(k.rho_ref, cell.e);
  cell.dp = MODE == kJvp ? __ldg(P.q + c) : T(0);
  T div = T(0);
  T d = kValues ? __ldg(P.pv + c) * (k.comp * cell.rho) / k.dt : T(0);
  walk<T, MODE>(P, e0, n, cell, k, div, d);
  if (MODE == kResidual || MODE == kStep) {
    const T rho_prev = mul_rn(k.rho_ref, growth(__ldg(P.q + c), k.comp, k.p_ref));
    P.out[c] = __ldg(P.pv + c) * fma_rn(k.rho_ref, cell.e, -rho_prev) / k.dt + div;
  }
  if (MODE == kJvp) P.out[c] = __ldg(P.pv + c) * (k.comp * cell.rho * cell.dp) / k.dt + div;
  if (kValues) P.vals[__ldg(P.diag_slot + c)] = d;
  if (MODE == kStep) {
    const T g = mul_rn(__ldg(P.t_sum + c), cell.rho / k.visc) + __ldg(P.pv + c) * k.comp * cell.rho / k.dt;
    P.diag[c] = fabs(g) > T(1e-30) ? g : T(1);
  }
}

template <typename T, int MODE>
int launch(const Problem<T>& P, void* stream) {
  if (P.nc <= 0) return 0;
  tpfa_kernel<T, MODE><<<(P.nc + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// res (MODE kResidual, q = p_prev) or J(p) dp (kJvp, q = dp) into out.
#define PPT_TPFA(NAME, T, MODE)                                                              \
  extern "C" int NAME(const T* p, const T* q, const int* lo, const int* hi, const T* t,      \
                      const unsigned char* is_neu, const T* bc_val, const T* pv,             \
                      const int* cell_ptr, const int* cell_faces, const T* coef, T* out,     \
                      int nc, void* stream) {                                                \
    return launch<T, MODE>(Problem<T>{p, q, lo, hi, t, is_neu, bc_val, pv, cell_ptr,         \
                                      cell_faces, coef, nullptr, nullptr, nullptr, out,      \
                                      nullptr, nullptr, nc},                                 \
                           stream);                                                          \
  }

PPT_TPFA(ppt_tpfa_residual_f32, float, kResidual)
PPT_TPFA(ppt_tpfa_residual_f64, double, kResidual)
PPT_TPFA(ppt_tpfa_jvp_f32, float, kJvp)
PPT_TPFA(ppt_tpfa_jvp_f64, double, kJvp)

#define PPT_TPFA_LINEARIZE(NAME, T)                                                          \
  extern "C" int NAME(const T* p, const int* lo, const int* hi, const T* t,                  \
                      const unsigned char* is_neu, const T* bc_val, const T* pv,             \
                      const int* cell_ptr, const int* cell_faces, const T* coef,             \
                      const int* slot, const int* diag_slot, T* vals, int nc,                \
                      void* stream) {                                                        \
    return launch<T, kLinearize>(Problem<T>{p, nullptr, lo, hi, t, is_neu, bc_val, pv,       \
                                            cell_ptr, cell_faces, coef, nullptr, slot,       \
                                            diag_slot, nullptr, vals, nullptr, nc},          \
                                 stream);                                                    \
  }

PPT_TPFA_LINEARIZE(ppt_tpfa_linearize_f32, float)
PPT_TPFA_LINEARIZE(ppt_tpfa_linearize_f64, double)

#define PPT_TPFA_STEP(NAME, T)                                                               \
  extern "C" int NAME(const T* p, const T* p_prev, const int* lo, const int* hi, const T* t, \
                      const unsigned char* is_neu, const T* bc_val, const T* pv,             \
                      const int* cell_ptr, const int* cell_faces, const T* coef,             \
                      const T* t_sum, const int* slot, const int* diag_slot, T* res,         \
                      T* vals, T* diag, int nc, void* stream) {                              \
    return launch<T, kStep>(Problem<T>{p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr,   \
                                       cell_faces, coef, t_sum, slot, diag_slot, res, vals,  \
                                       diag, nc},                                            \
                            stream);                                                         \
  }

PPT_TPFA_STEP(ppt_tpfa_step_f32, float)
PPT_TPFA_STEP(ppt_tpfa_step_f64, double)
