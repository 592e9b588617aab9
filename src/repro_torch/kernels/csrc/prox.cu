// K1: fused prox / lambda update, y = prox_f(Dx + lam, delta),
// lam' = lam + Dx - y, elementwise over m.
//
// Replaces repro/kernels/prox/prox.py::prox_update_pallas (`_kernel`).
// Bound on the card: bytes. Five float32 streams of m (Dx, lam, aux in;
// y, lam' out), 20 bytes an element, against ~140 FP32 operations for the
// logistic kind at delta = 10 (prox.cuh: a bracket from one expf, 4
// bisection steps, 2 Newton steps and the reference's 3 clamped ones),
// under the card's FP32 rate per byte moved. Design: one grid-stride pass,
// one element per thread per step, every value in registers; the TPU's
// (rows, 1024) lane layout and its padding are gone, the ragged tail is
// the loop bound.
#include "prox.cuh"

namespace {

template <int KIND>
__global__ void prox_update_kernel(const float* __restrict__ dx,
                                   const float* __restrict__ lam,
                                   const float* __restrict__ aux,
                                   float* __restrict__ y,
                                   float* __restrict__ lam_out, long long m,
                                   float delta, int newton_iters,
                                   float param) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const float d = dx[i];
    const float l = lam[i];
    const float a = aux != nullptr ? aux[i] : 0.f;
    const float yy =
        repro::prox_body<KIND>(d + l, delta, a, newton_iters, param);
    y[i] = yy;
    lam_out[i] = l + d - yy;
  }
}

}  // namespace

extern "C" int repro_prox_update(const void* dx, const void* lam,
                                 const void* aux, void* y, void* lam_out,
                                 long long m, int kind, float delta,
                                 int newton_iters, float param, int blocks,
                                 void* stream) {
  if (m <= 0) return cudaSuccess;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_KIND(kind, prox_update_kernel<KIND><<<blocks, threads, 0, s>>>(
      static_cast<const float*>(dx), static_cast<const float*>(lam),
      static_cast<const float*>(aux), static_cast<float*>(y),
      static_cast<float*>(lam_out), m, delta, newton_iters, param));
  return cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
