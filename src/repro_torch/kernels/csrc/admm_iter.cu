// K3: one fused unwrapped-ADMM iteration over D (paper Alg. 2 lines 5-8):
//   Dx = D x;  y' = prox_f(Dx + lam);  lam' = lam + Dx - y';
//   d = D^T (y' - lam'),  w = D^T (y' - y),  v = D^T lam'.
//
// Replaces repro/kernels/admm_iter/admm_iter.py::admm_iter_pallas
// (`_kernel`), whose prox is repro/kernels/prox/prox.py::_prox_body
// (shared here through prox.cuh).
//
// Bound on the card: bytes. Each iteration must read D once (m n 4 bytes
// in f32, half that in bf16) plus five m-vectors; the 8n FLOP per row are
// ~2 FLOP per byte, far below the card's FP32 ridge.
//
// Design. The TPU kernel streamed (bm x n) panels through VMEM with the
// d/w/v accumulators resident across a sequential grid. Here:
//   * each CTA owns a contiguous range of rows and walks it in panels of
//     R <= 32 rows. A panel is contiguous in row-major D, so the whole CTA
//     copies it into shared memory with coalesced loads, upcasting bf16 to
//     f32 on the way in: D is read from device memory exactly once;
//   * Dx: each warp takes rows of the panel, its lanes stride over the
//     columns against x (in shared memory), then a butterfly shuffle;
//   * prox: one lane per row of the panel (warp 0), so the 40-step
//     bisection runs on 32 rows at once instead of once per warp; the
//     ragged end of m is masked here (no pad rows exist, so none can leak);
//     it writes y', lam' and the three row weights (y'-lam', y'-y, lam'),
//     each difference taken in registers before any reduction
//     (anti-cancellation rule, DESIGN.md section 7);
//   * Dt-sweep: thread t owns columns t, t+256, ... and adds the panel's
//     weighted rows from shared memory into a per-panel partial, then into
//     its (3, n) accumulator in shared memory.
// At the end each CTA writes one (3, n) partial; a second kernel sums the
// partials in CTA order. No atomics: bitwise repeatable for given shapes.
// Shared memory is (R n + 4 n + 128) floats, so n up to ~11k fits at
// R = 1 (the TPU comment's register limit of n ~ 2k does not apply: the
// row sits in shared memory, and the Dt-sweep's second touch of the row
// hits shared memory, not L1/L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
admm_iter_kernel(const T* __restrict__ D, const float* __restrict__ x,
                 const float* __restrict__ y, const float* __restrict__ lam,
                 const float* __restrict__ aux, float* __restrict__ y_out,
                 float* __restrict__ lam_out, float* __restrict__ part,
                 long long m, int n, int R, long long rows_per_cta,
                 float delta, float param) {
  extern __shared__ float smem[];
  float* P = smem;             // R x n panel, f32
  float* xs = P + (size_t)R * n;  // n
  float* acc = xs + n;         // 3 x n accumulators (d, w, v)
  float* u = acc + 3 * n;      // 3 x 32 row weights
  float* dxs = u + 96;         // 32 row dot products

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long r_begin = (long long)blockIdx.x * rows_per_cta;
  const long long r_end = min(m, r_begin + rows_per_cta);

  for (int c = tid; c < n; c += kThreads) {
    xs[c] = x[c];
    acc[c] = 0.f;
    acc[n + c] = 0.f;
    acc[2 * n + c] = 0.f;
  }
  __syncthreads();

  for (long long row0 = r_begin; row0 < r_end; row0 += R) {
    const int cnt = (int)min((long long)R, r_end - row0);
    const T* src = D + row0 * n;
    const int total = cnt * n;
#pragma unroll 4
    for (int e = tid; e < total; e += kThreads) P[e] = to_f32(src[e]);
    __syncthreads();

    for (int rr = warp; rr < cnt; rr += kWarps) {
      const float* prow = P + (size_t)rr * n;
      float s = 0.f;
      for (int c = lane; c < n; c += 32) s += prow[c] * xs[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) dxs[rr] = s;
    }
    __syncthreads();

    if (warp == 0) {
      float u0 = 0.f, u1 = 0.f, u2 = 0.f;
      if (lane < cnt) {
        const long long row = row0 + lane;
        const float dx = dxs[lane];
        const float l = lam[row];
        const float yo = y[row];
        const float a = aux != nullptr ? aux[row] : 0.f;
        const float yn = repro::prox_body<KIND>(dx + l, delta, a, 3, param);
        const float ln = l + dx - yn;
        y_out[row] = yn;
        lam_out[row] = ln;
        u0 = yn - ln;
        u1 = yn - yo;
        u2 = ln;
      }
      u[lane] = u0;
      u[32 + lane] = u1;
      u[64 + lane] = u2;
    }
    __syncthreads();

    for (int c = tid; c < n; c += kThreads) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int rr = 0; rr < cnt; ++rr) {
        const float v = P[(size_t)rr * n + c];
        s0 += u[rr] * v;
        s1 += u[32 + rr] * v;
        s2 += u[64 + rr] * v;
      }
      acc[c] += s0;
      acc[n + c] += s1;
      acc[2 * n + c] += s2;
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.x * 3 * n;
  for (int c = tid; c < 3 * n; c += kThreads) out[c] = acc[c];
}

__global__ void admm_reduce_kernel(const float* __restrict__ part, int n,
                                   int nctas, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * n) return;
  float s = 0.f;
  for (int b = 0; b < nctas; ++b) s += part[(size_t)b * 3 * n + e];
  out[e] = s;
}

template <typename T, int KIND>
int launch_iter(const void* D, const void* x, const void* y, const void* lam,
                const void* aux, void* y_out, void* lam_out, void* part,
                void* out, long long m, int n, int R, long long rows_per_cta,
                int nctas, float delta, float param, cudaStream_t s) {
  const size_t smem = ((size_t)R * n + 4 * (size_t)n + 128) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      admm_iter_kernel<T, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  admm_iter_kernel<T, KIND><<<nctas, kThreads, smem, s>>>(
      static_cast<const T*>(D), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(lam),
      static_cast<const float*>(aux), static_cast<float*>(y_out),
      static_cast<float*>(lam_out), static_cast<float*>(part), m, n, R,
      rows_per_cta, delta, param);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  admm_reduce_kernel<<<(3 * n + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(part), n, nctas, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 D, 1 = bfloat16 D (row-major (m, n)). x (n,), y, lam,
// aux (m,) float32; aux may be null. part holds nctas * 3 * n floats and
// out (3, n) receives d, w, v. Rows [b * rows_per_cta, (b+1) * rows_per_cta)
// belong to CTA b, walked in panels of R <= 32 rows.
extern "C" int repro_admm_iter(const void* D, int dtype, const void* x,
                               const void* y, const void* lam,
                               const void* aux, void* y_out, void* lam_out,
                               void* part, void* out, long long m, int n,
                               int R, long long rows_per_cta, int nctas,
                               int kind, float delta, float param,
                               void* stream) {
  if (R < 1 || R > 32 || n <= 0 || nctas <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_DISPATCH_KIND(kind, return launch_iter<float, KIND>(
        D, x, y, lam, aux, y_out, lam_out, part, out, m, n, R, rows_per_cta,
        nctas, delta, param, s));
  }
  if (dtype == 1) {
    REPRO_DISPATCH_KIND(kind, return launch_iter<__nv_bfloat16, KIND>(
        D, x, y, lam, aux, y_out, lam_out, part, out, m, n, R, rows_per_cta,
        nctas, delta, param, s));
  }
  return cudaErrorInvalidValue;
}
