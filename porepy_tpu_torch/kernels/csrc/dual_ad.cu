// K8: the colored forward-mode pass of the assembly on dual numbers.
//
// Replaces porepy_tpu/numerics/ad/equation_system.py:132-135 (jax.linearize of
// one equation's residual, jax.vmap(jvp_fn)(seeds) and the compressed[gc, rj]
// gather into nonzero order), which XLA compiled into one fused program per
// equation. Here the residual's operator graph is walked once on the host and
// its arithmetic runs in three kernels on (value, B tangent rows) pairs:
//
//   dual_ew      an interpreter of a short elementwise program (the fused
//                add/sub/mul/div/pow/neg nodes and elementwise functions of
//                one subtree): one thread per element computes the value, then
//                replays the program once per tangent row by the chain rule,
//                with the registers of both passes in local memory;
//   dual_gather  the dual of the unknowns x[idx] under one-hot seeds by color
//                (tangent row c is 1 where colors[idx[i]] == c) in two
//                kernels: dual_seed_rows writes the tangent rows once per
//                color set into a buffer that the step's launcher keeps
//                (ops.DualGatherVar), dual_gather_value the value row x[idx]
//                at every assembly; and the copy of up to 32 duals into
//                slices of one output (concatenation, ops.DualGatherCopy),
//                one thread per output element: it finds its piece once
//                (binary search) and writes the value and every tangent row;
//   jac_gather   compressed[gc, rj] of up to 8 equations into the global
//                nonzero order, and the negated, concatenated residual.
//
// A value is (n,) with an element stride (0: one number for all elements); a
// tangent is B rows with a row stride, or a null pointer for a constant. A
// constant operand adds no term to a tangent (0 * inf never arises), and pow
// with a constant exponent takes no logarithm. Gathers and elementwise work
// only: no scatter, no atomics, so two launches give the same bits.
//
// Bound: bytes. Each input and output element is touched once per row; at md
// 1/128 (18,000 unknowns, 16 colors) a launch moves a few MB, microseconds at
// 3.35 TB/s. The time is the launch and the host code around it; the
// unknowns' tangent rows depend only on the gather indices and the colors,
// both fixed once the equation is compiled, so an assembly writes only the
// value row (16,969 cells of md 1/128: 0.41 MB instead of 2.65 MB).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxIn = 12;
constexpr int kMaxInstr = 36;
constexpr int kRegs = kMaxIn + kMaxInstr;
constexpr int kPieces = 8;       // equations per jac_gather launch
constexpr int kCopyPieces = 32;  // duals per dual_gather_copy launch

enum Op : int {
  LOADI = 0, ADD, SUB, MUL, DIV, POW, NEG, EXP, LOG, SIN, COS, TAN, ASIN, ACOS,
  ATAN, SINH, COSH, TANH, ASINH, ACOSH, ATANH, ABS, SIGN, SQRT, GT, GE, LEABS,
  SELECT, DETACH, CUSTOM
};

struct EwInputs {
  const double* val[kMaxIn];
  const double* tan[kMaxIn];
  long long es[kMaxIn];  // element stride of value and tangent rows
  long long rs[kMaxIn];  // row stride of the tangent
};

__device__ __forceinline__ double sign_of(double x) {
  return (x > 0.0) ? 1.0 : ((x < 0.0) ? -1.0 : ((x == 0.0) ? 0.0 : x));
}

__device__ __forceinline__ bool is_const(unsigned long long mask, int r) {
  return (mask >> r) & 1ULL;
}

__global__ void dual_ew_kernel(EwInputs in, int n_in, const int* __restrict__ code,
                               const double* __restrict__ imm, int n_instr,
                               double* __restrict__ out_v, double* __restrict__ out_t,
                               long long out_rs, int n, int batch) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double v[kRegs];
  double t[kRegs];
  // Bit r set: register r is a constant (no tangent). The same for every
  // thread, so the branches below do not diverge.
  unsigned long long cmask = 0ULL;
  for (int k = 0; k < n_in; ++k) {
    v[k] = in.val[k][(long long)i * in.es[k]];
    if (in.tan[k] == nullptr) cmask |= 1ULL << k;
  }
  for (int j = 0; j < n_instr; ++j) {
    int op = code[4 * j], a = code[4 * j + 1], b = code[4 * j + 2], c = code[4 * j + 3];
    int r = kMaxIn + j;
    bool cst;
    double x = (op == LOADI) ? 0.0 : v[a];
    double res;
    switch (op) {
      case LOADI: res = imm[a]; cst = true; break;
      case ADD: res = x + v[b]; cst = is_const(cmask, a) && is_const(cmask, b); break;
      case SUB: res = x - v[b]; cst = is_const(cmask, a) && is_const(cmask, b); break;
      case MUL: res = x * v[b]; cst = is_const(cmask, a) && is_const(cmask, b); break;
      case DIV: res = x / v[b]; cst = is_const(cmask, a) && is_const(cmask, b); break;
      case POW: res = pow(x, v[b]); cst = is_const(cmask, a) && is_const(cmask, b); break;
      case NEG: res = -x; cst = is_const(cmask, a); break;
      case EXP: res = exp(x); cst = is_const(cmask, a); break;
      case LOG: res = log(x); cst = is_const(cmask, a); break;
      case SIN: res = sin(x); cst = is_const(cmask, a); break;
      case COS: res = cos(x); cst = is_const(cmask, a); break;
      case TAN: res = tan(x); cst = is_const(cmask, a); break;
      case ASIN: res = asin(x); cst = is_const(cmask, a); break;
      case ACOS: res = acos(x); cst = is_const(cmask, a); break;
      case ATAN: res = atan(x); cst = is_const(cmask, a); break;
      case SINH: res = sinh(x); cst = is_const(cmask, a); break;
      case COSH: res = cosh(x); cst = is_const(cmask, a); break;
      case TANH: res = tanh(x); cst = is_const(cmask, a); break;
      case ASINH: res = asinh(x); cst = is_const(cmask, a); break;
      case ACOSH: res = acosh(x); cst = is_const(cmask, a); break;
      case ATANH: res = atanh(x); cst = is_const(cmask, a); break;
      case ABS: res = fabs(x); cst = is_const(cmask, a); break;
      case SQRT: res = sqrt(x); cst = is_const(cmask, a); break;
      case SIGN: res = sign_of(x); cst = true; break;
      case GT: res = (x > v[b]) ? 1.0 : 0.0; cst = true; break;
      case GE: res = (x >= v[b]) ? 1.0 : 0.0; cst = true; break;
      case LEABS: res = (fabs(x) <= v[b]) ? 1.0 : 0.0; cst = true; break;
      case SELECT:
        res = (x != 0.0) ? v[b] : v[c];
        cst = is_const(cmask, b) && is_const(cmask, c);
        break;
      case DETACH: res = x; cst = true; break;
      case CUSTOM: res = x; cst = is_const(cmask, c); break;
      default: res = nan(""); cst = true; break;
    }
    v[r] = res;
    if (cst) cmask |= 1ULL << r;
  }
  int last = kMaxIn + n_instr - 1;
  out_v[i] = v[last];
  if (batch == 0 || out_t == nullptr || is_const(cmask, last)) return;

  for (int row = 0; row < batch; ++row) {
    for (int k = 0; k < n_in; ++k)
      t[k] = (in.tan[k] != nullptr) ? in.tan[k][row * in.rs[k] + (long long)i * in.es[k]] : 0.0;
    for (int j = 0; j < n_instr; ++j) {
      int r = kMaxIn + j;
      if (is_const(cmask, r)) { t[r] = 0.0; continue; }
      int op = code[4 * j], a = code[4 * j + 1], b = code[4 * j + 2], c = code[4 * j + 3];
      bool ca = is_const(cmask, a);
      double x = v[a], ta = t[a], res = v[r];
      double d;
      switch (op) {
        case ADD: d = ca ? t[b] : (is_const(cmask, b) ? ta : ta + t[b]); break;
        case SUB: d = ca ? -t[b] : (is_const(cmask, b) ? ta : ta - t[b]); break;
        case MUL:
          if (ca) d = x * t[b];
          else if (is_const(cmask, b)) d = ta * v[b];
          else d = ta * v[b] + x * t[b];
          break;
        case DIV:
          if (is_const(cmask, b)) d = ta / v[b];
          else if (ca) d = -(t[b] * res) / v[b];
          else d = (ta - t[b] * res) / v[b];
          break;
        case POW: {
          double e = v[b];
          d = 0.0;
          bool any = false;
          if (!ca) {
            d = ta * ((e == 0.0) ? 0.0 : e * pow(x, e - 1.0));
            any = true;
          }
          if (!is_const(cmask, b)) {
            double w = (x == 0.0 && e >= 0.0) ? 0.0 : res * log(x);
            d = any ? d + t[b] * w : t[b] * w;
          }
          break;
        }
        case NEG: d = -ta; break;
        case EXP: d = ta * res; break;
        case LOG: d = ta / x; break;
        case SIN: d = ta * cos(x); break;
        case COS: d = ta * (-sin(x)); break;
        case TAN: d = ta * (1.0 + res * res); break;
        case ASIN: d = ta / sqrt(1.0 - x * x); break;
        case ACOS: d = ta / (-sqrt(1.0 - x * x)); break;
        case ATAN: d = ta / (1.0 + x * x); break;
        case SINH: d = ta * cosh(x); break;
        case COSH: d = ta * sinh(x); break;
        case TANH: d = ta * (1.0 - res * res); break;
        case ASINH: d = ta / sqrt(x * x + 1.0); break;
        case ACOSH: d = ta / sqrt(x * x - 1.0); break;
        case ATANH: d = ta / (1.0 - x * x); break;
        case ABS: d = ta * sign_of(x); break;
        case SQRT: d = ta / (2.0 * res); break;
        case SELECT: {
          int src = (x != 0.0) ? b : c;
          d = is_const(cmask, src) ? 0.0 : t[src];
          break;
        }
        case CUSTOM: d = v[b] * t[c]; break;
        default: d = 0.0; break;
      }
      t[r] = d;
    }
    out_t[row * out_rs + i] = t[last];
  }
}

// The value row of the unknowns' dual: out[i] = x[idx[i]].
__global__ void dual_gather_value_kernel(const double* __restrict__ x,
                                         const long long* __restrict__ idx,
                                         double* __restrict__ out, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = x[idx[i]];
}

// The batch one-hot tangent rows of the unknowns' dual: row c of tan (row
// stride n) is 1 where colors[idx[i]] == c, else 0. One thread an element,
// its color read once.
__global__ void dual_seed_rows_kernel(const long long* __restrict__ idx,
                                      const int* __restrict__ colors,
                                      double* __restrict__ tan, int n, int batch) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = colors[idx[i]];
  for (int row = 0; row < batch; ++row) tan[(long long)row * n + i] = (c == row) ? 1.0 : 0.0;
}

struct CopyPieces {
  const double* val[kCopyPieces];
  const double* tan[kCopyPieces];
  long long es[kCopyPieces];
  long long rs[kCopyPieces];
  long long start[kCopyPieces + 1];  // offsets in the output; start[count] is the end
};

// Copies up to 32 duals into out[row, start[k] : start[k + 1]] of the stacked
// (1 + batch, n_out) output, one thread per output element and every row;
// a constant's tangent rows read 0.
__global__ void dual_gather_copy_kernel(CopyPieces p, int count,
                                        double* __restrict__ out, long long n_out,
                                        int batch) {
  long long i = p.start[0] + (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.start[count]) return;
  // The last piece that starts at or before i: never an empty one.
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (p.start[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const long long e = (i - p.start[lo]) * p.es[lo];
  out[i] = p.val[lo][e];
  const double* tan = p.tan[lo];
  const long long rs = p.rs[lo];
  for (int row = 0; row < batch; ++row)
    out[(row + 1) * n_out + i] = (tan != nullptr) ? tan[row * rs + e] : 0.0;
}

struct JacPieces {
  const double* val[kPieces];
  const double* tan[kPieces];
  long long rs[kPieces];
  long long nnz[kPieces + 1];   // global nonzero offsets of the equations
  long long row[kPieces + 1];   // global row offsets of the equations
};

__global__ void jac_gather_kernel(JacPieces p, int count,
                                  const int* __restrict__ gather_color,
                                  const int* __restrict__ gather_row,
                                  double* __restrict__ data, double* __restrict__ rhs) {
  long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long n_nnz = p.nnz[count] - p.nnz[0];
  long long n_row = p.row[count] - p.row[0];
  if (tid < n_nnz) {
    long long k = p.nnz[0] + tid;
    int e = 0;
    while (e + 1 < count && k >= p.nnz[e + 1]) ++e;
    data[k] = (p.tan[e] != nullptr)
                  ? p.tan[e][(long long)gather_color[k] * p.rs[e] + gather_row[k]]
                  : 0.0;
  } else if (tid < n_nnz + n_row) {
    long long r = p.row[0] + (tid - n_nnz);
    int e = 0;
    while (e + 1 < count && r >= p.row[e + 1]) ++e;
    rhs[r] = -p.val[e][r - p.row[e]];
  }
}

inline unsigned blocks_of(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// ptrs: n_in value pointers then n_in tangent pointers (null: constant);
// strides: n_in element strides then n_in tangent row strides.
extern "C" int ppt_dual_ew_f64(const void* const* ptrs, const long long* strides,
                               int n_in, const int* code, const double* imm,
                               int n_instr, double* out_v, double* out_t,
                               long long out_rs, int n, int batch, void* stream) {
  if (n == 0) return 0;
  if (n_in < 1 || n_in > kMaxIn || n_instr < 1 || n_instr > kMaxInstr)
    return (int)cudaErrorInvalidValue;
  EwInputs in;
  for (int k = 0; k < kMaxIn; ++k) {
    bool live = k < n_in;
    in.val[k] = live ? (const double*)ptrs[k] : nullptr;
    in.tan[k] = live ? (const double*)ptrs[n_in + k] : nullptr;
    in.es[k] = live ? strides[k] : 0;
    in.rs[k] = live ? strides[n_in + k] : 0;
  }
  dual_ew_kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      in, n_in, code, imm, n_instr, out_v, out_t, out_rs, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int ppt_dual_gather_value_f64(const double* x, const long long* idx,
                                         double* out, int n, void* stream) {
  if (n == 0) return 0;
  dual_gather_value_kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(x, idx, out, n);
  return (int)cudaGetLastError();
}

extern "C" int ppt_dual_seed_rows_f64(const long long* idx, const int* colors,
                                      double* tan, int n, int batch, void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (batch < 0) return (int)cudaErrorInvalidValue;
  dual_seed_rows_kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(idx, colors, tan, n, batch);
  return (int)cudaGetLastError();
}

// ptrs: count value pointers then count tangent pointers; strides: count
// element strides, count row strides, then count + 1 output offsets.
extern "C" int ppt_dual_gather_copy_f64(const void* const* ptrs,
                                        const long long* strides, int count,
                                        double* out, long long n_out, int batch,
                                        void* stream) {
  if (count < 1 || count > kCopyPieces || batch < 0) return (int)cudaErrorInvalidValue;
  CopyPieces p;
  for (int k = 0; k < kCopyPieces; ++k) {
    bool live = k < count;
    p.val[k] = live ? (const double*)ptrs[k] : nullptr;
    p.tan[k] = live ? (const double*)ptrs[count + k] : nullptr;
    p.es[k] = live ? strides[k] : 0;
    p.rs[k] = live ? strides[count + k] : 0;
  }
  for (int k = 0; k <= kCopyPieces; ++k)
    p.start[k] = strides[2 * count + (k <= count ? k : count)];
  long long span = p.start[count] - p.start[0];
  if (span <= 0) return 0;
  dual_gather_copy_kernel<<<blocks_of(span), kThreads, 0, (cudaStream_t)stream>>>(p, count, out, n_out, batch);
  return (int)cudaGetLastError();
}

// ptrs: count value pointers then count tangent pointers (null: no tangent);
// offsets: count tangent row strides, count + 1 nonzero offsets, count + 1 row
// offsets.
extern "C" int ppt_jac_gather_f64(const void* const* ptrs, const long long* offsets,
                                  int count, const int* gather_color,
                                  const int* gather_row, double* data, double* rhs,
                                  void* stream) {
  if (count < 1 || count > kPieces) return (int)cudaErrorInvalidValue;
  JacPieces p;
  for (int k = 0; k < kPieces; ++k) {
    bool live = k < count;
    p.val[k] = live ? (const double*)ptrs[k] : nullptr;
    p.tan[k] = live ? (const double*)ptrs[count + k] : nullptr;
    p.rs[k] = live ? offsets[k] : 0;
  }
  for (int k = 0; k <= kPieces; ++k) {
    int kk = k <= count ? k : count;
    p.nnz[k] = offsets[count + kk];
    p.row[k] = offsets[2 * count + 1 + kk];
  }
  long long total = (p.nnz[count] - p.nnz[0]) + (p.row[count] - p.row[0]);
  if (total <= 0) return 0;
  jac_gather_kernel<<<blocks_of(total), kThreads, 0, (cudaStream_t)stream>>>(
      p, count, gather_color, gather_row, data, rhs);
  return (int)cudaGetLastError();
}
