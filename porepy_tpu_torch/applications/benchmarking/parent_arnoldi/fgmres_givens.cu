// The parent's K4g kernel (one thread: the Givens step of an FGMRES Arnoldi
// step), kept beside arnoldi_check.py as the yardstick of the composition
// that fgmres_arnoldi.cu replaced; no path of the package builds it.
//
// K4g: the Givens step of one FGMRES Arnoldi iteration, in place.
//
// Replaces porepy_tpu/numerics/linalg/device_solver.py:198-210 (the rotation
// fori_loop, the new rotation and the update of g inside _fgmres.arnoldi)
// and the early-exit test of arnoldi_cond (:179-181).
//
// With j = *j_ptr (the column being finished, kept on the device):
//   1. apply the j previous rotations (cs[i], sn[i]) to the new Hessenberg
//      column h (length restart + 1);
//   2. form the rotation that zeroes h[j + 1], store it in cs[j], sn[j], and
//      rotate g[j], g[j + 1];
//   3. write *flag = (j + 1 < restart) && |g[j + 1]| > *atol and advance
//      *j_ptr to j + 1.
// A j outside [0, restart) only clears the flag.
//
// In plain PyTorch this is O(j) dependent scalar launches per Arnoldi step;
// here it is one launch. The recurrence is sequential in i, so one thread
// does it: at restart = 70 it is a few hundred flops, and the launch is the
// whole cost. The host reads *flag to decide whether to continue.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void fgmres_givens_kernel(T* __restrict__ h, T* __restrict__ cs,
                                     T* __restrict__ sn, T* __restrict__ g,
                                     int* __restrict__ j_ptr,
                                     const T* __restrict__ atol,
                                     int* __restrict__ flag, int restart) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int j = *j_ptr;
  if (j < 0 || j >= restart) {  // no column left: never write past h
    *flag = 0;
    return;
  }
  for (int i = 0; i < j; ++i) {
    T hi = h[i];
    T hn = h[i + 1];
    h[i] = cs[i] * hi + sn[i] * hn;
    h[i + 1] = -sn[i] * hi + cs[i] * hn;
  }
  T denom = sqrt(h[j] * h[j] + h[j + 1] * h[j + 1]);
  T safe = denom > T(1e-30) ? denom : T(1e-30);
  T c = h[j] / safe;
  T s = h[j + 1] / safe;
  cs[j] = c;
  sn[j] = s;
  h[j] = denom;
  h[j + 1] = T(0);
  T gj = g[j];
  g[j + 1] = -s * gj;
  g[j] = c * gj;
  *flag = (j + 1 < restart) && (fabs(g[j + 1]) > *atol) ? 1 : 0;
  *j_ptr = j + 1;
}

template <typename T>
int launch(T* h, T* cs, T* sn, T* g, int* j, const T* atol, int* flag,
           int restart, void* stream) {
  fgmres_givens_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>(
      h, cs, sn, g, j, atol, flag, restart);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ppt_fgmres_givens_f32(float* h, float* cs, float* sn, float* g,
                                     int* j, const float* atol, int* flag,
                                     int restart, void* stream) {
  return launch<float>(h, cs, sn, g, j, atol, flag, restart, stream);
}

extern "C" int ppt_fgmres_givens_f64(double* h, double* cs, double* sn,
                                     double* g, int* j, const double* atol,
                                     int* flag, int restart, void* stream) {
  return launch<double>(h, cs, sn, g, j, atol, flag, restart, stream);
}
