// K14: the differentiable two-point flux approximation inside the residual
// (the value and all forward-mode tangents in one launch), and the
// fixed-order segment sums of the TPFA functions.
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
// and their tangents for B seed rows of (k9, vol, p, bco, lam), each row
// with its stride (seeds are slices of (B, n_total) arrays; a null seed is
// zero), written into one (1 + B, nf) buffer: row 0 the value, row 1 + b
// the tangent of seed b. The chain rule is written out in the order forward
// mode takes it: d(1/x) = -dx (1/x)^2 at both reciprocals, so a cell of zero
// permeability gives t = 0 and a non-finite tangent on its faces, as
// differentiating the plain version does; the guarded division of the trace
// is a branch, so no such tangent leaks to faces that are not Neumann.
//
// Design. The parent ran the value and the tangents as two launches of one
// thread a face, each reading the geometry and the fields again, the seeds
// in a serial loop of dependent loads with two divisions an iteration, and
// the trace over every face. Here:
//   1. One launch a call: a block of 256 threads takes a tile of faces (64
//      for the flux, 32 for the trace). Its first tile-many threads, one a
//      face, compute what no seed changes (the cells, signs, n, d, |d|^2,
//      vol, t_hf, 1/t_hf and its square, t_full and its square, t, the cell
//      part, coeff and bco + lam), write the value row and keep these in
//      shared memory (14,336 bytes for the flux's tile, 7,168 for the
//      trace's; 58 registers a thread).
//   2. Then all threads of the block run over the (seed, face) pairs of the
//      tile, face fastest, so that the dp, dbco and dlam reads and the
//      output rows are coalesced and B seeds are spread over the block
//      instead of one thread's loop: 2.5 pairs a thread at 1/128 with
//      B = 10.
//   3. 1/t_hf, its square and t_full^2 are computed once a face, not once a
//      seed; the same operations on the same values, so no bit changes.
//   4. The trace runs over the geometry's list of raw Dirichlet or Neumann
//      faces only (TpfaAdGeometry.boundary_faces); blocks past the listed
//      faces' tiles write the zeros of every other face's 1 + B entries in
//      the same launch (their tiles skip the listed faces, so no two blocks
//      write one entry).
// What sets the flux's time: each (face, seed) pair reads the 9 dK entries
// of both its cells, 72 strided bytes a cell, three 32-byte sectors, from
// L2; faces of one tile share few cells, so at 1/128 with B = 10 that
// is ~64 MB of sectors for 25 MB of bound, and at 3d 32^3 with B = 16
// ~311 MB for 104 MB. On an H100 the value alone takes ~4.5 and ~12 us and
// the seeds ~14.5 and ~99 us of the launch (tpfa_ad_check.py). Other tile
// shapes (32-128 faces x 128-256 threads), staging the tile's dK rows
// through shared memory, block-wide or a warp's own, and 16-byte loads of
// the rows were each slower or no faster there.
// The arithmetic keeps the parent's and the jnp code's order of operations
// per (face, seed): round-to-nearest intrinsics, no contraction into FMAs,
// no reassociation; a term of a null seed is left out, not added as 0
// (the plain version differentiates only the seeded inputs). Sums have a
// fixed order and there are no atomics: two launches give the same bits.
//
// Bound: bytes, each input once, only what the function needs, at 3.35 TB/s.
// The flux: the geometry (face_ptr, face_hf, ci 4 B, sgn 8, nrm and dvec 48
// a half-face; two mask bytes a face), the fields (88 B a cell, 16 a face),
// each seed row (72 + 8 + 8 B a cell and 8 + 8 a face, for the non-null
// seeds) and the (1 + B) nf result. DarcysLawAd 1/128's matrix subdomain
// (33,088 faces, 65,536 half-faces, 16,384 cells), B = 10 with dk9, dp and
// dlam: 4.39 + 1.97 + 15.75 + 2.91 = 25.0 MB, 7.47 us; 3d 32^3 with B = 16
// and every seed: 103.6 MB, 30.9 us. The trace: the listed faces' inputs and
// seeds (a Dirichlet face needs bco, lam and their seeds; a Neumann face
// also its half-face's geometry, cell fields and seed rows) and the whole
// (1 + B) nf result: 1/128, 640 listed faces, B = 3: 1.34 MB, 0.40 us (one
// launch's latency sets it); 32^3, 6,144 listed faces, B = 16: 25.1 MB,
// 7.5 us. The f64 arithmetic, ~60 operations a half-face and seed, is far
// below the card's 34 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // segment_sum_sorted
constexpr int kDualThreads = 256;  // tpfa_ad_dual
// Faces a tile: the flux's, the trace's (powers of two, at most a block).
template <bool kTrace>
__host__ __device__ constexpr int tile_of() { return kTrace ? 32 : 64; }

// The launch table's words (ops.TpfaAdLauncher writes them).
enum Word {
  kNf, kNhf, kNList, kBatch,
  kFacePtr, kFaceHf, kCi, kSgn, kNrm, kDvec, kIsDir, kIsNeu, kList,
  kK9, kVol, kP, kBco, kLam,
  kDk9, kDvol, kDp, kDbco, kDlam,
  kSdk9, kSdvol, kSdp, kSdbco, kSdlam,
  kOut, kWords
};

struct Args {
  const int* face_ptr;
  const int* face_hf;
  const int* ci;
  const double* sgn;
  const double* nrm;
  const double* dvec;
  const uint8_t* is_dir;  // effective masks for the flux, raw for the trace
  const uint8_t* is_neu;
  const int* list;        // the trace's listed faces
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
  double* out;  // (1 + batch, nf)
  int nf, nhf, n_items, batch, work_blocks;
};

// What no seed changes, a face of the tile a column. A face's one or two
// half-faces are slots 0 and 1, in CSC order.
template <int kTile>
struct Tile {
  double n[2][3][kTile];
  double d[2][3][kTile];
  double vol[2][kTile];
  double sgn[2][kTile];
  double r2[2][kTile];     // (1 / t_hf)^2
  double dist2[2][kTile];  // |d|^2
  double t[kTile];
  double t2[kTile];        // t_full^2
  double t_full[kTile];
  double cell_part[kTile];
  double coeff[kTile];
  double bval[kTile];      // bco + lam
  int cell[2][kTile];
  int face[kTile];         // -1 past the last item
  int info[kTile];         // count | dir << 2 | neu << 3
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

// Phase 1 for one face: the seed-free constants into the tile, the value
// into row 0.
template <bool kTrace>
__device__ void face_constants(const Args& a, Tile<tile_of<kTrace>()>& s, int j, int f) {
  int h0 = a.face_ptr[f], h1 = a.face_ptr[f + 1];
  // A face has one or two half-faces; more would be a broken grid.
  int count = min(h1 - h0, 2);
  bool dir = a.is_dir[f] != 0, neu = a.is_neu[f] != 0;
  double bval = __dadd_rn(a.bco[f], a.lam[f]);
  s.face[j] = f;
  s.info[j] = count | (dir << 2) | (neu << 3);
  s.bval[j] = bval;
  if (count == 0) {
    a.out[f] = 0.0;
    return;
  }
  // The trace needs no half-face on a Dirichlet face.
  bool half_faces = !kTrace || !dir;
  double recip = 0.0, cell_part = 0.0, p_last = 0.0, sgn_last = 0.0;
  if (half_faces) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k < count) {
        int h = a.face_hf[h0 + k];
        int c = a.ci[h];
        double sg = a.sgn[h];
        double n[3], d[3], kv[9];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          n[i] = a.nrm[(long long)i * a.nhf + h];
          d[i] = a.dvec[(long long)i * a.nhf + h];
        }
        double v = a.vol[c];
#pragma unroll
        for (int i = 0; i < 9; ++i) kv[i] = __dmul_rn(a.k9[9LL * c + i], v);
        double dist2 = dot3(d, d);
        double t_hf = __ddiv_rn(ndot(kv, n, d), dist2);
        double r = __ddiv_rn(1.0, t_hf);
        double pc = a.p[c];
        recip = __dadd_rn(recip, r);
        cell_part = __dadd_rn(cell_part, __dmul_rn(sg, pc));
        p_last = pc;
        sgn_last = sg;
        s.cell[k][j] = c;
        s.vol[k][j] = v;
        s.sgn[k][j] = sg;
        s.r2[k][j] = __dmul_rn(r, r);
        s.dist2[k][j] = dist2;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          s.n[k][i][j] = n[i];
          s.d[k][i][j] = d[i];
        }
      }
    }
  }
  double t_full = __ddiv_rn(1.0, recip);
  s.t_full[j] = t_full;
  s.t2[j] = __dmul_rn(t_full, t_full);
  double res;
  if (!kTrace) {
    double t = neu ? 0.0 : t_full;
    double coeff = 0.0;
    if (count == 1) coeff = dir ? __dmul_rn(-t, sgn_last) : (neu ? sgn_last : 0.0);
    s.t[j] = t;
    s.coeff[j] = coeff;
    s.cell_part[j] = cell_part;
    res = __dadd_rn(__dmul_rn(t, cell_part), __dmul_rn(coeff, bval));
  } else {
    res = dir ? bval : (neu ? __dsub_rn(p_last, __ddiv_rn(bval, t_full)) : 0.0);
  }
  a.out[f] = res;
}

// d t_hf of half-face slot k for seed row b: d(kv) = dK vol + K dvol, the
// term of a null seed left out.
template <int kTile>
__device__ __forceinline__ double half_face_tangent(const Args& a, const Tile<kTile>& s,
                                                    int k, int j, long long b) {
  int c = s.cell[k][j];
  double v = s.vol[k][j];
  double dv = a.dvol != nullptr ? a.dvol[b * a.sdvol + c] : 0.0;
  double dkv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if (a.dk9 != nullptr && a.dvol != nullptr) {
      dkv[i] = __dadd_rn(__dmul_rn(a.dk9[b * a.sdk9 + 9LL * c + i], v),
                         __dmul_rn(a.k9[9LL * c + i], dv));
    } else if (a.dk9 != nullptr) {
      dkv[i] = __dmul_rn(a.dk9[b * a.sdk9 + 9LL * c + i], v);
    } else {
      dkv[i] = __dmul_rn(a.k9[9LL * c + i], dv);
    }
  }
  double n[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    n[i] = s.n[k][i][j];
    d[i] = s.d[k][i][j];
  }
  return __ddiv_rn(ndot(dkv, n, d), s.dist2[k][j]);
}

// Phase 2 for one (face, seed) pair: the tangent.
template <bool kTrace>
__device__ double face_tangent(const Args& a, const Tile<tile_of<kTrace>()>& s, int j, long long b) {
  int info = s.info[j];
  int count = info & 3;
  bool dir = (info >> 2) & 1, neu = (info >> 3) & 1;
  int f = s.face[j];
  if (count == 0) return 0.0;
  double db = 0.0;
  if (a.dbco != nullptr) db = a.dbco[b * a.sdbco + f];
  if (a.dlam != nullptr) db = __dadd_rn(db, a.dlam[b * a.sdlam + f]);
  if (kTrace && dir) return db;
  bool seeded_kv = a.dk9 != nullptr || a.dvol != nullptr;
  double drecip = 0.0, dcell = 0.0, dp_last = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < count) {
      if (seeded_kv) {
        double dt_hf = half_face_tangent(a, s, k, j, b);
        drecip = __dadd_rn(drecip, __dmul_rn(-dt_hf, s.r2[k][j]));
      }
      if (a.dp != nullptr) {
        dp_last = a.dp[b * a.sdp + s.cell[k][j]];
        dcell = __dadd_rn(dcell, __dmul_rn(s.sgn[k][j], dp_last));
      }
    }
  }
  double t_full = s.t_full[j];
  double dt_full = __dmul_rn(-drecip, s.t2[j]);
  if (kTrace) {
    if (!neu) return 0.0;
    // d(b / t) = db / t - b dt / t^2
    double dquot = __dsub_rn(__ddiv_rn(db, t_full),
                             __ddiv_rn(__dmul_rn(s.bval[j], dt_full), s.t2[j]));
    return __dsub_rn(dp_last, dquot);
  }
  double sgn_last = s.sgn[count - 1][j];
  double dt = neu ? 0.0 : dt_full;
  double dcoeff = (count == 1 && dir) ? __dmul_rn(-dt, sgn_last) : 0.0;
  double res = __dadd_rn(__dmul_rn(dt, s.cell_part[j]), __dmul_rn(s.t[j], dcell));
  return __dadd_rn(res, __dadd_rn(__dmul_rn(dcoeff, s.bval[j]), __dmul_rn(s.coeff[j], db)));
}

template <bool kTrace>
__global__ void __launch_bounds__(kDualThreads)
    tpfa_ad_dual_kernel(Args a) {
  constexpr int kTile = tile_of<kTrace>();
  __shared__ Tile<kTile> s;
  if (kTrace && (int)blockIdx.x >= a.work_blocks) {
    // The zeros of the faces that are not listed, every row.
    int f = (blockIdx.x - a.work_blocks) * kDualThreads + threadIdx.x;
    if (f < a.nf && a.is_dir[f] == 0 && a.is_neu[f] == 0) {
      for (long long r = 0; r <= a.batch; ++r) a.out[r * a.nf + f] = 0.0;
    }
    return;
  }
  int j = threadIdx.x;
  if (j < kTile) {
    int item = blockIdx.x * kTile + j;
    if (item < a.n_items) {
      face_constants<kTrace>(a, s, j, kTrace ? a.list[item] : item);
    } else {
      s.face[j] = -1;
    }
  }
  if (a.batch == 0) return;
  __syncthreads();
  int pairs = a.batch * kTile;
  for (int i = threadIdx.x; i < pairs; i += kDualThreads) {
    int jj = i & (kTile - 1);
    int f = s.face[jj];
    if (f < 0) continue;
    long long b = i / kTile;
    a.out[(b + 1) * a.nf + f] = face_tangent<kTrace>(a, s, jj, b);
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

template <typename T>
const T* word_ptr(const long long* w, int i) {
  return reinterpret_cast<const T*>(w[i]);
}

}  // namespace

// One launch: the value row and, with batch > 0, the batch tangent rows of
// the flux (trace == 0) or of the trace, from the host launch table.
extern "C" int ppt_tpfa_ad_dual_f64(const long long* w, int trace, void* stream) {
  Args a;
  a.face_ptr = word_ptr<int>(w, kFacePtr);
  a.face_hf = word_ptr<int>(w, kFaceHf);
  a.ci = word_ptr<int>(w, kCi);
  a.sgn = word_ptr<double>(w, kSgn);
  a.nrm = word_ptr<double>(w, kNrm);
  a.dvec = word_ptr<double>(w, kDvec);
  a.is_dir = word_ptr<uint8_t>(w, kIsDir);
  a.is_neu = word_ptr<uint8_t>(w, kIsNeu);
  a.list = word_ptr<int>(w, kList);
  a.k9 = word_ptr<double>(w, kK9);
  a.vol = word_ptr<double>(w, kVol);
  a.p = word_ptr<double>(w, kP);
  a.bco = word_ptr<double>(w, kBco);
  a.lam = word_ptr<double>(w, kLam);
  a.dk9 = word_ptr<double>(w, kDk9);
  a.dvol = word_ptr<double>(w, kDvol);
  a.dp = word_ptr<double>(w, kDp);
  a.dbco = word_ptr<double>(w, kDbco);
  a.dlam = word_ptr<double>(w, kDlam);
  a.sdk9 = w[kSdk9];
  a.sdvol = w[kSdvol];
  a.sdp = w[kSdp];
  a.sdbco = w[kSdbco];
  a.sdlam = w[kSdlam];
  a.out = reinterpret_cast<double*>(w[kOut]);
  a.nf = (int)w[kNf];
  a.nhf = (int)w[kNhf];
  a.batch = (int)w[kBatch];
  a.n_items = trace ? (int)w[kNList] : a.nf;
  if (a.nf == 0) return 0;
  int tile = trace ? tile_of<true>() : tile_of<false>();
  a.work_blocks = (a.n_items + tile - 1) / tile;
  int blocks = a.work_blocks;
  if (trace) {
    blocks += (a.nf + kDualThreads - 1) / kDualThreads;
    tpfa_ad_dual_kernel<true><<<blocks, kDualThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    tpfa_ad_dual_kernel<false><<<blocks, kDualThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The launch table's length, for the launcher's check.
extern "C" int ppt_tpfa_ad_dual_words_f64(void) { return kWords; }

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
