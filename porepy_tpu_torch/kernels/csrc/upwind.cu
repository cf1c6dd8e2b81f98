// K15: single-point upstream weighting inside the residual, with its
// forward-mode tangents, in one kernel.
//
// Replaces porepy_tpu/numerics/fv/upwind.py:76-99 (upwind_apply,
// upwind_boundary_masks) and the face expression around them
// (porepy_tpu/models/constitutive_laws.py:504-583, AdvectiveFlux.
// advective_flux), which XLA ran as a chain of selects and gathers over whole
// arrays, and the interface selection and its product (:585-619,
// lam * where(stop_gradient(lam) >= 0, wp, ws)). For a face f with the cells
// lo[f] behind and hi[f] in front of it (-1 where missing):
//
//   pos      = q >= 0                    (IEEE: true for -0.0, false for NaN)
//   up       = pos ? lo : hi
//   outside  = up < 0
//   up(w)    = (outside | is_neu) ? 0 : w[up]
//   dir_mask = (is_dir & outside) ? 1 : 0
//   neu      = is_neu ? sgn_div : 0
//
// One launch writes the rows of one (nv + nt, n) buffer: nv value rows, then
// nt tangent rows, of one of four functions (Mode):
//
//   flux       q up(w) + dir_mask q bc + neu bc, with the tangents
//              dq (up(w) + dir_mask bc) + q up(dw) + (dir_mask q + neu) dbc
//              (the terms of null seeds left out, from 0.0 as before);
//   apply      up(w), with the tangents up(dw);
//   pair       s >= 0 ? a : b (a null candidate reads 0), the tangents the
//              same choice of (da, db);
//   interface  lam sel with sel = (lam >= 0 ? a : b), the tangents
//              dlam sel + dsel lam (dual_ew's mul: one product where one
//              operand carries no seed), dsel the same choice of (da, db).
//
// The choice is taken from q (s, lam) as data, the stop-gradient of the jnp
// code, so no tangent differentiates it. A dual rule's call is nv = 1 (the
// value) and nt = B (the seed rows), its primals shared by every row (row
// stride 0); the torch.func route's calls are value rows alone or tangent
// rows alone, primals and seeds each with a row stride (0: one row for all).
//
// Design. The parent launched one thread a (row, face) for the value and
// again for the tangent rows, each finding the upstream again from q, lo,
// hi (int64), both flags and sgn_div, and the interface product was a third,
// dual_ew, launch. Here a block takes a tile of kTile faces and kRows rows:
// where q is shared by the rows, its first kTile threads find the upstream
// of each face once (the cell as int32 or -1, whether the cell field is
// read, dir_mask, the Neumann coefficient and q; q, both cells, the flags
// and sgn_div loaded side by side) into shared memory; then each thread
// takes one (row, face) pair of the tile, face fastest, so consecutive
// threads read consecutive entries of a seed row and write consecutive
// entries of the output, each pair reading only its own seed entries and
// the staged upstream. The grid's second axis runs over the row groups, so
// every pair of a call is resident at once at the main path's sizes (one
// pair a thread measured 2.4 us at tracer 1/64's flux, B = 11, against 3.6
// for a block walking all rows of its tile). lo and hi are int32 and the
// two flags one byte, copies the launcher makes once a geometry.
//
// Bits. Each expression keeps the parent's operations and order, __dmul_rn
// and __dadd_rn so that nothing is contracted into a fused multiply-add; the
// interface mode rounds as dual_ew's mul (its value pass a product, its
// tangent tape one product or the sum of two). Gathers only, no scatter:
// two launches give the same bits.
//
// Bound: bytes. At the tracer case's 8,580 faces with 16 seeds of (q, w,
// bc) the flux moves ~4.3 MB, 1.3 us at 3.35 TB/s; a launch costs ~2 us of
// device time, so the launch is the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // faces (mortar cells) a block
constexpr int kRows = kThreads / kTile;  // rows a block

enum Mode : int { kFlux = 0, kApply, kPair, kInterface };

// The launch table (int64 words, ops.UpwindLauncher): the head is written
// once a launcher (the geometry's int32 and byte copies; 0 for pair and
// interface), the rest every call.
enum Word : int {
  kMode = 0, kLo, kHi, kFlags, kSgnDiv,
  kN, kValueRows, kTangentRows,
  kP0, kP1, kP2, kPs0, kPs1, kPs2,  // primals and their row strides
  kD0, kD1, kD2, kDs0, kDs1, kDs2,  // seeds (0: none) and their row strides
  kOut,
  kWords
};

struct Args {
  const int* lo;
  const int* hi;
  const uint8_t* flags;  // bit 0 is_dir, bit 1 is_neu
  const double* sgn_div;
  const double* p[3];
  long long ps[3];
  const double* d[3];
  long long ds[3];
  double* out;
  int mode, n, nv, nt;
};

struct Up {
  int up;          // flux, apply: the upstream cell, -1 outside
  bool take;       // flux, apply: the cell field is read; pair: a is taken
  double dir_mask;
  double neu;
  double q;
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ Up find(const Args& a, int f, long long row) {
  Up u;
  u.q = a.p[0][row * a.ps[0] + f];
  const bool pos = u.q >= 0.0;
  u.up = -1;
  u.take = pos;
  u.dir_mask = 0.0;
  u.neu = 0.0;
  if (a.mode >= kPair) return u;
  const uint8_t fl = a.flags[f];
  const bool is_dir = (fl & 1) != 0, is_neu = (fl & 2) != 0;
  // Both cells, and sgn_div, are loaded beside q, not after the choice.
  const int lo = __ldg(a.lo + f), hi = __ldg(a.hi + f);
  const double sgn = (a.mode == kFlux) ? __ldg(a.sgn_div + f) : 0.0;
  u.up = pos ? lo : hi;
  const bool outside = u.up < 0;
  u.take = !(outside || is_neu);
  u.dir_mask = (is_dir && outside) ? 1.0 : 0.0;
  u.neu = is_neu ? sgn : 0.0;
  return u;
}

// up(x) of row `row` of the cell field x.
__device__ __forceinline__ double cell(const double* x, long long stride, long long row,
                                       const Up& u) {
  return u.take ? x[row * stride + u.up] : 0.0;
}

// The chosen candidate of row `row` (a null one reads 0).
__device__ __forceinline__ double pick(const double* x, long long sx, const double* y,
                                       long long sy, long long row, int i, bool first) {
  const double* src = first ? x : y;
  return (src != nullptr) ? src[row * (first ? sx : sy) + i] : 0.0;
}

__device__ __forceinline__ double value_row(const Args& a, const Up& u, int f, long long row) {
  switch (a.mode) {
    case kFlux: {
      const double w_up = cell(a.p[1], a.ps[1], row, u);
      const double bc = a.p[2][row * a.ps[2] + f];
      return add(add(mul(u.q, w_up), mul(mul(u.dir_mask, u.q), bc)), mul(u.neu, bc));
    }
    case kApply:
      return cell(a.p[1], a.ps[1], row, u);
    case kPair:
      return pick(a.p[1], a.ps[1], a.p[2], a.ps[2], row, f, u.take);
    default:
      return mul(u.q, pick(a.p[1], a.ps[1], a.p[2], a.ps[2], row, f, u.take));
  }
}

__device__ __forceinline__ double tangent_row(const Args& a, const Up& u, int f, long long row,
                                              long long seed) {
  switch (a.mode) {
    case kFlux: {
      const double bc = a.p[2][row * a.ps[2] + f];
      double res = 0.0;
      if (a.d[0] != nullptr)
        res = mul(a.d[0][seed * a.ds[0] + f], add(cell(a.p[1], a.ps[1], row, u), mul(u.dir_mask, bc)));
      if (a.d[1] != nullptr) res = add(res, mul(u.q, cell(a.d[1], a.ds[1], seed, u)));
      if (a.d[2] != nullptr)
        res = add(res, mul(add(mul(u.dir_mask, u.q), u.neu), a.d[2][seed * a.ds[2] + f]));
      return res;
    }
    case kApply:
      return cell(a.d[1], a.ds[1], seed, u);
    case kPair:
      return pick(a.d[1], a.ds[1], a.d[2], a.ds[2], seed, f, u.take);
    default: {
      const bool has_sel = a.d[1] != nullptr || a.d[2] != nullptr;
      const double dsel = pick(a.d[1], a.ds[1], a.d[2], a.ds[2], seed, f, u.take);
      if (a.d[0] == nullptr) return mul(dsel, u.q);
      const double t = mul(a.d[0][seed * a.ds[0] + f],
                           pick(a.p[1], a.ps[1], a.p[2], a.ps[2], row, f, u.take));
      return has_sel ? add(t, mul(dsel, u.q)) : t;
    }
  }
}

__global__ void __launch_bounds__(kThreads) upwind_dual_kernel(const __grid_constant__ Args a) {
  __shared__ double s_q[kTile], s_dir[kTile], s_neu[kTile];
  __shared__ int s_up[kTile];
  __shared__ bool s_take[kTile];
  const int f0 = blockIdx.x * kTile;
  const int tile = min(kTile, a.n - f0);
  const bool staged = a.ps[0] == 0;  // q shared by every row: its upstream once
  if (staged) {
    if (threadIdx.x < tile) {
      const Up u = find(a, f0 + threadIdx.x, 0);
      s_q[threadIdx.x] = u.q;
      s_dir[threadIdx.x] = u.dir_mask;
      s_neu[threadIdx.x] = u.neu;
      s_up[threadIdx.x] = u.up;
      s_take[threadIdx.x] = u.take;
    }
    __syncthreads();
  }
  // One (row, face) pair a thread: kRows rows of the tile a block.
  const int j = threadIdx.x % kTile;
  const int r = blockIdx.y * kRows + threadIdx.x / kTile;
  if (j >= tile || r >= a.nv + a.nt) return;
  {
    const int f = f0 + j;
    const bool value = r < a.nv;
    const long long row = value ? r : r - a.nv;
    Up u;
    if (staged) {
      u.q = s_q[j];
      u.dir_mask = s_dir[j];
      u.neu = s_neu[j];
      u.up = s_up[j];
      u.take = s_take[j];
    } else {
      u = find(a, f, row);
    }
    a.out[(long long)r * a.n + f] = value ? value_row(a, u, f, row) : tangent_row(a, u, f, row, r - a.nv);
  }
}

template <typename T>
inline T* word_ptr(const long long* w, int k) {
  return reinterpret_cast<T*>(w[k]);
}

}  // namespace

extern "C" int ppt_upwind_dual_f64(const long long* w, void* stream) {
  Args a;
  a.mode = (int)w[kMode];
  if (a.mode < kFlux || a.mode > kInterface) return (int)cudaErrorInvalidValue;
  a.lo = word_ptr<const int>(w, kLo);
  a.hi = word_ptr<const int>(w, kHi);
  a.flags = word_ptr<const uint8_t>(w, kFlags);
  a.sgn_div = word_ptr<const double>(w, kSgnDiv);
  for (int i = 0; i < 3; ++i) {
    a.p[i] = word_ptr<const double>(w, kP0 + i);
    a.ps[i] = w[kPs0 + i];
    a.d[i] = word_ptr<const double>(w, kD0 + i);
    a.ds[i] = w[kDs0 + i];
  }
  a.out = word_ptr<double>(w, kOut);
  a.n = (int)w[kN];
  a.nv = (int)w[kValueRows];
  a.nt = (int)w[kTangentRows];
  if (a.n == 0 || a.nv + a.nt == 0) return 0;
  const dim3 grid((a.n + kTile - 1) / kTile, (a.nv + a.nt + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  upwind_dual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ppt_upwind_dual_words_f64(void) { return kWords; }
