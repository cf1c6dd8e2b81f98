// K8: the colored forward-mode pass of the assembly on dual numbers.
//
// Replaces porepy_tpu/numerics/ad/equation_system.py:132-135 (jax.linearize of
// one equation's residual, jax.vmap(jvp_fn)(seeds) and the compressed[gc, rj]
// gather into nonzero order), which XLA compiled into one fused program per
// equation. Here the residual's operator graph is walked once on the host and
// its arithmetic runs in these kernels on (value, B tangent rows) pairs:
//
//   dual_ew      an interpreter of a short elementwise program (the fused
//                add/sub/mul/div/pow/neg nodes and elementwise functions of
//                one subtree) in two passes over a tile of 32 elements: the
//                value pass, one thread an element, runs the program once and
//                leaves each instruction's partial derivatives (one or two
//                numbers an element) in shared memory; the tangent pass
//                spreads the threads over (element, tangent row), and each
//                runs the program's tape, the chain rule as multiplies, adds
//                and divides of its row's tangents by those partials, in a
//                few slots of shared memory;
//   dual_gather  the dual of the unknowns x[idx] under one-hot seeds by color
//                (tangent row c is 1 where colors[idx[i]] == c) in two
//                kernels: dual_seed_rows writes the tangent rows once per
//                color set into a buffer that the step's launcher keeps
//                (ops.DualGatherVar), dual_gather_value the value row x[idx]
//                at every assembly; and the copy of up to 32 duals into
//                slices of one output (concatenation, ops.DualGatherCopy),
//                one thread per output element: it finds its piece once
//                (binary search) and writes the value and every tangent row;
//   dual_ew_scatter  an equation's root program in the assembly's layout:
//                the value pass writes -v into the equation's rows of the
//                right-hand side, and the tangent pass runs the tape once
//                for each of the equation's Jacobian nonzeros (element
//                gather_row[k], tangent row gather_color[k]) and writes
//                data[k], so no compressed block is written and read again
//                and no pair that holds no nonzero is computed.
//
// A value is (n,) with an element stride (0: one number for all elements); a
// tangent is B rows with a row stride, or a null pointer for a constant. A
// constant operand adds no term to a tangent (0 * inf never arises), and pow
// with a constant exponent takes no logarithm. Gathers and elementwise work
// only: each output is written by one thread, no atomics, so two launches
// give the same bits.
//
// Bound: bytes. Each input and output element is touched once per row; at md
// 1/128 (18,000 unknowns, 16 colors) a launch moves a few MB, microseconds at
// 3.35 TB/s. The unknowns' tangent rows depend only on the gather indices and
// the colors, both fixed once the equation is compiled, so an assembly writes
// only the value row (16,969 cells of md 1/128: 0.41 MB instead of 2.65 MB).
//
// dual_ew's design: the host lowers a program once for each pattern of
// constant inputs into a value code (what each instruction computes and which
// partials it leaves) and a tangent tape (load an input's row, one operand
// times or over a partial, two operands with two partials, a selection, a sum
// or difference), with the tape's values placed in slots by liveness. So no
// transcendental is computed again for a tangent row, the code and the tape
// are read warp-uniformly from the kernel's parameters, and at md 1/128
// (16,969 elements, 16 rows) the tangent pass has 272K threads' work where
// one thread an element ran every row in series before. Each opcode keeps
// the plain version's form (a product by, or a quotient over, one
// derivative; mul as ta vb + va tb; div as (ta - tb r) / vb), with no
// contraction into a fused multiply-add.
//
// dual_ew_scatter's design: the nonzeros of an equation come in row-major
// order, so the nonzeros of the 32 elements of a dual_ew tile are one
// contiguous range (tile[b] .. tile[b + 1], from the host). A block takes a
// tile as dual_ew does: warp 0's value pass leaves the partials in shared
// memory, then each thread takes the tile's nonzeros k = tile[b] + tid, +
// blockDim.x, ..., loads the inputs' tangent entries at (gather_color[k],
// gather_row[k]) into its slots (the first pair's by cp.async before the
// value pass), runs the same tape with the partials of its element, and
// writes data[k]: the writes coalesce, and the loads, a tangent row each,
// hit L2 (listing a tile's pairs by tangent row instead, to coalesce the
// loads and scatter the writes, did not make md 1/128's roots faster). By the
// coloring a (row, color) pair holds at most one nonzero, so each pair the
// parent's dual_ew computed and jac_gather kept is computed once, with the
// same operations: data and rhs keep the bits of dual_ew followed by the
// gather. An output with no tangent writes zeros into its nonzeros.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxIn = 12;
constexpr int kMaxInstr = 36;
constexpr int kCopyPieces = 32;  // duals per dual_gather_copy launch
constexpr int kTile = 32;        // elements a dual_ew block
constexpr int kMaxGroups = 8;    // tangent row groups a dual_ew block (32 threads each)

enum Op : int {
  LOADI = 0, ADD, SUB, MUL, DIV, POW, NEG, EXP, LOG, SIN, COS, TAN, ASIN, ACOS,
  ATAN, SINH, COSH, TANH, ASINH, ACOSH, ATANH, ABS, SIGN, SQRT, GT, GE, LEABS,
  SELECT, DETACH, CUSTOM
};

// Tape entries: dst = f(slot x, slot y, partials p0, p1); a slot index < 0
// reads 0 (a constant operand of a selection).
enum TapeOp : int {
  T_LOAD = 0,  // dst = tangent row of input x
  T_MUL1,      // dst = x * P0
  T_DIV1,      // dst = x / P0
  T_MUL2,      // dst = x * P0 + y * P1
  T_DIVB,      // dst = -(y * P1) / P0      (div with a constant numerator)
  T_DIV2,      // dst = (x - y * P1) / P0   (div)
  T_NEG,       // dst = -x
  T_ADD,       // dst = x + y
  T_SUB,       // dst = x - y
  T_SEL        // dst = P0 != 0 ? x : y
};

constexpr int kMaxTape = kMaxIn + kMaxInstr;  // loads and tangent entries

// One launch: the operands, the output, and the lowered program itself, so
// that the kernel reads its code and constants from the constant bank (the
// parameter space, read warp-uniformly) and stages nothing.
struct EwLaunch {
  const double* val[kMaxIn];
  const double* tan[kMaxIn];
  long long es[kMaxIn];  // element stride of value and tangent rows
  long long rs[kMaxIn];  // row stride of the tangent
  double* out_v;
  double* out_t;         // null: the value alone
  long long out_rs;
  double imm[kMaxInstr];
  int vcode[kMaxInstr][6];  // op, a, b, c, p0, p1
  int tape[kMaxTape][2];    // kind | dst << 4 | (x + 1) << 10 | (y + 1) << 17, (p0 + 1) | (p1 + 1) << 8
  int n_in, n_instr, n_tape, n_load, n_part, n_slot, out_slot, n, batch, per;
  // dual_ew_scatter: per tile the first of its nonzeros (n_tiles + 1), per
  // nonzero its tangent row and its element; out_t is then the data.
  const int* tile;
  const int* gc;
  const int* gr;
};

__device__ __forceinline__ double sign_of(double x) {
  return (x > 0.0) ? 1.0 : ((x < 0.0) ? -1.0 : ((x == 0.0) ? 0.0 : x));
}

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dadd_rn(a, -b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// An 8-byte asynchronous copy from global to shared memory (sm_80+).
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// The derivative factor d of a unary opcode at x with result r (the tangent
// is t * d or t / d, as the tape says).
__device__ __forceinline__ double unary_factor(int op, double x, double r) {
  switch (op) {
    case EXP: return r;
    case LOG: return x;
    case SIN: return cos(x);
    case COS: return -sin(x);
    case TAN: return add_rn(1.0, mul_rn(r, r));
    case ASIN: return sqrt(sub_rn(1.0, mul_rn(x, x)));
    case ACOS: return -sqrt(sub_rn(1.0, mul_rn(x, x)));
    case ATAN: return add_rn(1.0, mul_rn(x, x));
    case SINH: return cosh(x);
    case COSH: return sinh(x);
    case TANH: return sub_rn(1.0, mul_rn(r, r));
    case ASINH: return sqrt(add_rn(mul_rn(x, x), 1.0));
    case ACOSH: return sqrt(sub_rn(mul_rn(x, x), 1.0));
    case ATANH: return sub_rn(1.0, mul_rn(x, x));
    case ABS: return sign_of(x);
    case SQRT: return mul_rn(2.0, r);
    default: return 0.0;
  }
}

// The value pass of element e of a tile (its inputs' values in vreg): runs
// the program, leaves each instruction's partials in part and returns the
// output's value.
__device__ __forceinline__ double value_pass(const EwLaunch& p, double* vreg, double* part, int e) {
  for (int j = 0; j < p.n_instr; ++j) {
    const int op = p.vcode[j][0], p0 = p.vcode[j][4], p1 = p.vcode[j][5];
    const double x = (op == LOADI) ? 0.0 : vreg[p.vcode[j][1] * kTile + e];
    const double y = vreg[p.vcode[j][2] * kTile + e];
    double res;
    switch (op) {
      case LOADI: res = p.imm[p.vcode[j][1]]; break;
      case ADD: res = x + y; break;
      case SUB: res = x - y; break;
      case MUL:
        res = x * y;
        if (p0 >= 0) part[p0 * kTile + e] = y;
        if (p1 >= 0) part[p1 * kTile + e] = x;
        break;
      case DIV:
        res = x / y;
        if (p0 >= 0) part[p0 * kTile + e] = y;
        if (p1 >= 0) part[p1 * kTile + e] = res;
        break;
      case POW:
        res = pow(x, y);
        if (p0 >= 0) part[p0 * kTile + e] = (y == 0.0) ? 0.0 : mul_rn(y, pow(x, y - 1.0));
        if (p1 >= 0) part[p1 * kTile + e] = (x == 0.0 && y >= 0.0) ? 0.0 : mul_rn(res, log(x));
        break;
      case NEG: res = -x; break;
      case EXP: res = exp(x); break;
      case LOG: res = log(x); break;
      case SIN: res = sin(x); break;
      case COS: res = cos(x); break;
      case TAN: res = tan(x); break;
      case ASIN: res = asin(x); break;
      case ACOS: res = acos(x); break;
      case ATAN: res = atan(x); break;
      case SINH: res = sinh(x); break;
      case COSH: res = cosh(x); break;
      case TANH: res = tanh(x); break;
      case ASINH: res = asinh(x); break;
      case ACOSH: res = acosh(x); break;
      case ATANH: res = atanh(x); break;
      case ABS: res = fabs(x); break;
      case SQRT: res = sqrt(x); break;
      case SIGN: res = sign_of(x); break;
      case GT: res = (x > y) ? 1.0 : 0.0; break;
      case GE: res = (x >= y) ? 1.0 : 0.0; break;
      case LEABS: res = (fabs(x) <= y) ? 1.0 : 0.0; break;
      case SELECT:
        res = (x != 0.0) ? y : vreg[p.vcode[j][3] * kTile + e];
        if (p0 >= 0) part[p0 * kTile + e] = (x != 0.0) ? 1.0 : 0.0;
        break;
      case DETACH: res = x; break;
      case CUSTOM:
        res = x;
        if (p0 >= 0) part[p0 * kTile + e] = y;
        break;
      default: res = nan(""); break;
    }
    if (op >= EXP && op <= SQRT && op != SIGN && p0 >= 0)
      part[p0 * kTile + e] = unary_factor(op, x, res);
    vreg[(p.n_in + j) * kTile + e] = res;
  }
  return vreg[(p.n_in + p.n_instr - 1) * kTile + e];
}

// One tape entry's tangent from its operands' tangents x, y and the
// element's partials P0, P1.
__device__ __forceinline__ double tape_value(int kind, double xv, double yv, double P0, double P1) {
  switch (kind) {
    case T_MUL1: return mul_rn(xv, P0);
    case T_DIV1: return div_rn(xv, P0);
    case T_MUL2: return add_rn(mul_rn(xv, P0), mul_rn(yv, P1));
    case T_DIVB: return div_rn(-mul_rn(yv, P1), P0);
    case T_DIV2: return div_rn(sub_rn(xv, mul_rn(yv, P1)), P0);
    case T_NEG: return -xv;
    case T_ADD: return add_rn(xv, yv);
    case T_SUB: return sub_rn(xv, yv);
    case T_SEL: return (P0 != 0.0) ? xv : yv;
    default: return nan("");
  }
}

// A block takes kTile elements with `groups` warps. Its threads first issue
// the asynchronous copies of the tape's input rows (thread (e, g): rows g, g
// + G, ... of element e, `per` of them) and warp 0 those of the inputs'
// values; warp 0 then runs the value pass, one element a thread, leaving the
// registers and partials in shared memory; after one barrier every thread
// runs the tape's arithmetic on its rows, each entry decoded once for all of
// them. Shared memory: the registers and partials of the tile and the slots
// of every thread's rows.
// Five blocks an SM (at most 51 registers a thread): md 1/128's 16,969
// elements are 531 blocks, one wave on 132 SMs.
__global__ void __launch_bounds__(kTile * kMaxGroups, 5)
dual_ew_kernel(const __grid_constant__ EwLaunch p) {
  extern __shared__ double smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int n_reg = p.n_in + p.n_instr;
  double* vreg = smem;                      // n_reg x kTile
  double* part = vreg + n_reg * kTile;      // n_part x kTile
  double* slot = part + p.n_part * kTile;   // n_slot x per x nt
  const int e = tid & (kTile - 1);
  const long long i = (long long)blockIdx.x * kTile + e;
  const bool live = i < p.n;
  const bool tangents = p.batch > 0 && p.out_t != nullptr;
  const int groups = nt / kTile;
  const int g = tid / kTile;
  double* my = slot + tid;  // slot s of the thread's row q at my[(s * per + q) * nt]

  if (live) {
    if (tangents) {
      const int left = (p.batch - g + groups - 1) / groups;
      const int rows = left < p.per ? left : p.per;
      for (int q = 0; q < p.n_load; ++q) {
        const int w0 = p.tape[q][0];
        const int dst = (w0 >> 4) & 63, x = ((w0 >> 10) & 127) - 1;
        const double* src = p.tan[x] + i * p.es[x] + g * p.rs[x];
        const long long step = groups * p.rs[x];
        double* to = my + dst * p.per * nt;
        for (int r = 0; r < rows; ++r) cp_async8(to + r * nt, src + r * step);
      }
    }
    if (tid < kTile)
      for (int k = 0; k < p.n_in; ++k) cp_async8(vreg + k * kTile + e, p.val[k] + i * p.es[k]);
  }
  cp_async_wait_all();

  if (tid < kTile && live) p.out_v[i] = value_pass(p, vreg, part, e);
  if (!tangents) return;
  __syncthreads();  // the partials and every thread's rows are in
  if (!live) return;

  for (int r0 = g; r0 < p.batch; r0 += groups * p.per) {
    const int left = (p.batch - r0 + groups - 1) / groups;
    const int rows = left < p.per ? left : p.per;
    if (r0 != g) {  // a later chunk of rows: its loads now
      for (int q = 0; q < p.n_load; ++q) {
        const int w0 = p.tape[q][0];
        const int dst = (w0 >> 4) & 63, x = ((w0 >> 10) & 127) - 1;
        const double* src = p.tan[x] + i * p.es[x] + r0 * p.rs[x];
        const long long step = groups * p.rs[x];
        double* to = my + dst * p.per * nt;
        for (int r = 0; r < rows; ++r) to[r * nt] = src[r * step];
      }
    }
    for (int q = p.n_load; q < p.n_tape; ++q) {
      const int w0 = p.tape[q][0], w1 = p.tape[q][1];
      const int kind = w0 & 15, dst = (w0 >> 4) & 63;
      const int x = ((w0 >> 10) & 127) - 1, y = ((w0 >> 17) & 127) - 1;
      const int p0 = (w1 & 255) - 1, p1 = ((w1 >> 8) & 255) - 1;
      const double P0 = (p0 >= 0) ? part[p0 * kTile + e] : 0.0;
      const double P1 = (p1 >= 0) ? part[p1 * kTile + e] : 0.0;
      const double* X = my + x * p.per * nt;
      const double* Y = my + y * p.per * nt;
      double* to = my + dst * p.per * nt;
      for (int r = 0; r < rows; ++r) {
        const double xv = (x >= 0) ? X[r * nt] : 0.0;
        const double yv = (y >= 0) ? Y[r * nt] : 0.0;
        to[r * nt] = tape_value(kind, xv, yv, P0, P1);
      }
    }
    const double* res = my + p.out_slot * p.per * nt;
    for (int r = 0; r < rows; ++r) p.out_t[(long long)(r0 + r * groups) * p.out_rs + i] = res[r * nt];
  }
}

// The tangent loads of nonzero k (element t0 + ke, tangent row kc) into the
// thread's slots, asynchronous or plain.
template <bool kAsync>
__device__ __forceinline__ void scatter_loads(const EwLaunch& p, double* my, int nt, long long i, int kc) {
  for (int q = 0; q < p.n_load; ++q) {
    const int w0 = p.tape[q][0];
    const int dst = (w0 >> 4) & 63, x = ((w0 >> 10) & 127) - 1;
    const double* src = p.tan[x] + i * p.es[x] + kc * p.rs[x];
    if (kAsync)
      cp_async8(my + dst * nt, src);
    else
      my[dst * nt] = *src;
  }
}

// dual_ew_scatter: a block a tile as dual_ew_kernel, the value pass writing
// -v (out_v is the equation's rows of the right-hand side), then the tile's
// nonzeros over the block's threads, one slot set a thread (see the design
// note at the top). A tape of no entries (an output without tangent) writes
// zeros.
__global__ void __launch_bounds__(kTile * kMaxGroups, 5)
dual_ew_scatter_kernel(const __grid_constant__ EwLaunch p) {
  extern __shared__ double smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  double* vreg = smem;                                      // (n_in + n_instr) x kTile
  double* part = vreg + (p.n_in + p.n_instr) * kTile;       // n_part x kTile
  double* my = part + p.n_part * kTile + tid;               // slot s at my[s * nt]
  const long long t0 = (long long)blockIdx.x * kTile;
  const int e = tid & (kTile - 1);
  const long long i = t0 + e;
  const bool tangents = p.batch > 0;
  const int lo = tangents ? p.tile[blockIdx.x] : 0;
  const int hi = tangents ? p.tile[blockIdx.x + 1] : 0;
  const bool tape = p.n_tape > 0;

  int k = lo + tid;
  if (tape && k < hi) scatter_loads<true>(p, my, nt, p.gr[k], p.gc[k]);
  if (tid < kTile && i < p.n)
    for (int q = 0; q < p.n_in; ++q) cp_async8(vreg + q * kTile + e, p.val[q] + i * p.es[q]);
  cp_async_wait_all();

  if (tid < kTile && i < p.n) p.out_v[i] = -value_pass(p, vreg, part, e);
  if (!tangents) return;
  if (!tape) {
    for (; k < hi; k += nt) p.out_t[k] = 0.0;
    return;
  }
  __syncthreads();  // the partials and every thread's first pair are in

  for (; k < hi; k += nt) {
    const int ke = p.gr[k] - (int)t0;
    if (k != lo + tid) scatter_loads<false>(p, my, nt, p.gr[k], p.gc[k]);
    for (int q = p.n_load; q < p.n_tape; ++q) {
      const int w0 = p.tape[q][0], w1 = p.tape[q][1];
      const int kind = w0 & 15, dst = (w0 >> 4) & 63;
      const int x = ((w0 >> 10) & 127) - 1, y = ((w0 >> 17) & 127) - 1;
      const int p0 = (w1 & 255) - 1, p1 = ((w1 >> 8) & 255) - 1;
      const double P0 = (p0 >= 0) ? part[p0 * kTile + ke] : 0.0;
      const double P1 = (p1 >= 0) ? part[p1 * kTile + ke] : 0.0;
      const double xv = (x >= 0) ? my[x * nt] : 0.0;
      const double yv = (y >= 0) ? my[y * nt] : 0.0;
      my[dst * nt] = tape_value(kind, xv, yv, P0, P1);
    }
    p.out_t[k] = my[p.out_slot * nt];
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

inline unsigned blocks_of(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// A large program's slots over many rows need the opt-in above 48 KB, set
// once a device and kernel (which: 0 dual_ew_kernel, 1 the scatter kernel).
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, int which) {
  if (smem <= 48 * 1024) return 0;
  static bool opted[2][64] = {{false}};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidValue;
  if (!opted[which][dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (err != cudaSuccess) return (int)err;
    opted[which][dev] = true;
  }
  return 0;
}

// One warp for each 32 nonzeros of the fullest tile, at most kMaxGroups,
// each thread a slot set: the tile's pairs in one round where they fit.
int launch_scatter(const EwLaunch& p, long long max_pairs, cudaStream_t stream) {
  long long groups = (max_pairs + kTile - 1) / kTile;
  if (groups < 1 || p.batch == 0) groups = 1;
  if (groups > kMaxGroups) groups = kMaxGroups;
  const int threads = kTile * (int)groups;
  const size_t smem = sizeof(double) * ((size_t)(p.n_in + p.n_instr + p.n_part) * kTile +
                                        (size_t)p.n_slot * threads);
  const int err = opt_in(dual_ew_scatter_kernel, smem, 1);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((p.n + kTile - 1) / kTile);
  dual_ew_scatter_kernel<<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// table (host memory, int64): n_in, n_instr, n_tape, n_load, n_imm, n_part,
// n_slot, out_slot (the lowered program's sizes), the host addresses of its
// code (int32: six words a value instruction, two a tape entry, the loads
// first) and of its constants (double), out_v, out_t (0: the value alone),
// out_rs, n, batch, tile, gc, gr, max_pairs, then n_in value pointers, n_in
// tangent pointers (0: constant), n_in element strides and n_in tangent row
// strides. tile 0 launches dual_ew_kernel; else dual_ew_scatter_kernel with
// the tile offsets, the nonzeros' tangent rows and elements (int32 device
// arrays) and the most nonzeros of a tile, out_v the rows of the right-hand
// side and out_t the nonzeros' data.
extern "C" int ppt_dual_ew_f64(const long long* table, void* stream) {
  EwLaunch p;
  p.n_in = (int)table[0];
  p.n_instr = (int)table[1];
  p.n_tape = (int)table[2];
  p.n_load = (int)table[3];
  const int n_imm = (int)table[4];
  p.n_part = (int)table[5];
  p.n_slot = (int)table[6];
  p.out_slot = (int)table[7];
  const int* code = (const int*)table[8];
  const double* imm = (const double*)table[9];
  p.out_v = (double*)table[10];
  p.out_t = (double*)table[11];
  p.out_rs = table[12];
  const long long n = table[13];
  p.batch = (int)table[14];
  p.tile = (const int*)table[15];
  p.gc = (const int*)table[16];
  p.gr = (const int*)table[17];
  const long long max_pairs = table[18];
  const bool scatter = p.tile != nullptr;
  if (n == 0) return 0;
  if (p.n_in < 1 || p.n_in > kMaxIn || p.n_instr < 1 || p.n_instr > kMaxInstr || p.batch < 0 ||
      n < 0 || n > 0x7fffffffLL || n_imm < 0 || n_imm > kMaxInstr || p.n_part < 0 ||
      p.n_part > 2 * kMaxInstr || p.n_slot < 0 || p.n_slot > kMaxTape || p.n_tape < 0 ||
      p.n_tape > kMaxTape || p.n_load < 0 || p.n_load > p.n_tape || p.n_load > kMaxIn ||
      (scatter && (max_pairs < 0 ||
                   (p.batch > 0 && (p.gc == nullptr || p.gr == nullptr || p.out_t == nullptr)))))
    return (int)cudaErrorInvalidValue;
  p.n = (int)n;
  const long long* ptrs = table + 19;
  const long long* strides = ptrs + 2 * p.n_in;
  for (int k = 0; k < kMaxIn; ++k) {
    bool live = k < p.n_in;
    p.val[k] = live ? (const double*)ptrs[k] : nullptr;
    p.tan[k] = live ? (const double*)ptrs[p.n_in + k] : nullptr;
    p.es[k] = live ? strides[k] : 0;
    p.rs[k] = live ? strides[p.n_in + k] : 0;
  }
  memcpy(p.vcode, code, sizeof(int) * 6 * p.n_instr);
  memcpy(p.tape, code + 6 * p.n_instr, sizeof(int) * 2 * p.n_tape);
  memcpy(p.imm, imm, sizeof(double) * n_imm);
  if (scatter) return launch_scatter(p, max_pairs, (cudaStream_t)stream);
  const bool tangents = p.out_t != nullptr && p.batch > 0;
  const int groups = !tangents ? 1 : (p.batch < kMaxGroups ? p.batch : kMaxGroups);
  const int threads = kTile * groups;
  // Rows a thread holds at once: all of its rows where the slots fit 96 KB,
  // else fewer (the tangent pass then takes the rows in chunks).
  const size_t base = sizeof(double) * (size_t)(p.n_in + p.n_instr + p.n_part) * kTile;
  const size_t row_bytes = sizeof(double) * (size_t)p.n_slot * threads;
  p.per = !tangents ? 0 : (p.batch + groups - 1) / groups;
  if (row_bytes > 0 && p.per > 1 && row_bytes * p.per > 96 * 1024) {
    p.per = (int)((96 * 1024) / row_bytes);
    if (p.per < 1) p.per = 1;
  }
  const size_t smem = base + row_bytes * p.per;
  const int err = opt_in(dual_ew_kernel, smem, 0);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  dual_ew_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
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
