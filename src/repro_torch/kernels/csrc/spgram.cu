// K6: one fused unwrapped-ADMM iteration over a padded block-CSR D
// (paper Alg. 2 lines 5-8, sparse data, DESIGN.md section 10):
//   Dx = D x;  y' = prox_f(Dx + lam);  lam' = lam + Dx - y';
//   d = D^T (y' - lam'),  w = D^T (y' - y),  v = D^T lam'.
//
// Replaces repro/kernels/spgram/spgram.py::sparse_iterate, which is not a
// Pallas kernel: a lax.scan of jnp gathers over the blocks. The prox is
// repro/kernels/prox/prox.py::_prox_body, shared with K1 and K3 through
// prox.cuh.
//
// Layout (repro_torch/data/sparse.py::BlockCSR): nb blocks of bm rows; per
// row kp (column id, value) slots, per block and column kc (block-local
// row id, value) slots of the block's own CSC. Pad slots are (0, 0.0).
//
// Bound on the card: bytes. Each iteration reads the CSR and the CSC once
// (every nonzero twice, with its index, padding included), five m-vectors
// and x; ~8 FLOP per nonzero is far below the FP32 ridge.
//
// One CTA of 256 threads per row block:
//   * x lives in shared memory (n floats); the CSR row gathers hit it;
//   * phase 1, a thread per row: Dx from the row's kp slots, then
//     prox_body<KIND> in registers (the same 3 clamped Newton steps as K3),
//     lam' and the three row weights u = (y'-lam', y'-y, lam'), each
//     difference formed before any reduction (the anti-cancellation rule,
//     DESIGN.md section 7). y' and lam' go to global memory; u to shared
//     memory where 4 (n + 3 bm) bytes fit in 227 KB (USMEM), else phase 2
//     forms u again from y', lam' and y, which this CTA has just written
//     or read and which sit in L2;
//   * phase 2, after __syncthreads, a warp per column: the lanes take the
//     column's kc CSC slots in turn (coalesced index and value loads),
//     gather u at the local row ids, and a butterfly sum gives the
//     column's (d, w, v) partial, written to the block's (3, n) slice of
//     `part`. Pad slots point at local row 0 (a real row) with value 0;
//   * spgram_reduce_kernel sums the partials over blocks in block order,
//     Kahan-compensated (the rule K3's d/w/v tolerance taught, PERF.md).
// No float atomics: a scatter of D^T u would add in an order that changes
// from run to run; every sum here has a fixed order, so two identical calls
// give the same bits. DUAL = false (want_dual off) computes d only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int KIND, bool DUAL, bool USMEM>
__global__ void __launch_bounds__(kThreads)
spgram_iter_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                   const int* __restrict__ cidx, const T* __restrict__ cval,
                   const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ lam,
                   const float* __restrict__ aux, float* y_out,
                   float* lam_out, float* __restrict__ part, long long m,
                   int n, int bm, int kp, int kc, float delta, float param) {
  extern __shared__ float smem[];
  float* xs = smem;      // n
  float* us = xs + n;    // (DUAL ? 3 : 1) x bm row weights (USMEM only)

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const long long row0 = (long long)b * bm;
  for (int c = tid; c < n; c += kThreads) xs[c] = x[c];
  __syncthreads();

  // phase 1: a thread per row
  const int* bidx = idx + (size_t)b * bm * kp;
  const T* bval = val + (size_t)b * bm * kp;
  for (int r = tid; r < bm; r += kThreads) {
    const long long row = row0 + r;
    float u0 = 0.f, u1 = 0.f, u2 = 0.f;
    if (row < m) {
      const int* ri = bidx + (size_t)r * kp;
      const T* rv = bval + (size_t)r * kp;
      float dx = 0.f;
      for (int k = 0; k < kp; ++k) dx += to_f32(rv[k]) * xs[ri[k]];
      const float l = lam[row];
      const float a = aux != nullptr ? aux[row] : 0.f;
      const float yn = repro::prox_body<KIND>(dx + l, delta, a, 3, param);
      const float ln = l + dx - yn;
      y_out[row] = yn;
      lam_out[row] = ln;
      u0 = yn - ln;
      if (DUAL) {
        u1 = yn - y[row];
        u2 = ln;
      }
    }
    if (USMEM) {
      us[r] = u0;
      if (DUAL) {
        us[bm + r] = u1;
        us[2 * bm + r] = u2;
      }
    }
  }
  __syncthreads();   // orders this block's y_out / lam_out writes too

  // phase 2: a warp per column of the block's local CSC
  const int lane = tid & 31, warp = tid >> 5;
  const int* bcidx = cidx + (size_t)b * n * kc;
  const T* bcval = cval + (size_t)b * n * kc;
  float* bpart = part + (size_t)b * 3 * n;
  for (int c = warp; c < n; c += kWarps) {
    const int* ci = bcidx + (size_t)c * kc;
    const T* cv = bcval + (size_t)c * kc;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < kc; j += 32) {
      const int r = ci[j];
      const float v = to_f32(cv[j]);
      if (USMEM) {
        s0 += v * us[r];
        if (DUAL) {
          s1 += v * us[bm + r];
          s2 += v * us[2 * bm + r];
        }
      } else {
        const long long row = row0 + r;
        const float yn = y_out[row], ln = lam_out[row];
        s0 += v * (yn - ln);
        if (DUAL) {
          s1 += v * (yn - y[row]);
          s2 += v * ln;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      if (DUAL) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
    }
    if (lane == 0) {
      bpart[c] = s0;
      if (DUAL) {
        bpart[n + c] = s1;
        bpart[2 * n + c] = s2;
      }
    }
  }
}

// out[e] = sum over blocks b, in block order, of part[b][e], e < rows * n;
// Kahan-compensated (no --use_fast_math, so the compensation survives).
__global__ void spgram_reduce_kernel(const float* __restrict__ part, int n,
                                     int rows, int nb,
                                     float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * n) return;
  float s = 0.f, comp = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float t = part[(size_t)b * 3 * n + e] - comp;
    const float u = s + t;
    comp = (u - s) - t;
    s = u;
  }
  out[e] = s;
}

template <typename T, int KIND, bool DUAL, bool USMEM>
int launch(const void* idx, const void* val, const void* cidx,
           const void* cval, const void* x, const void* y, const void* lam,
           const void* aux, void* y_out, void* lam_out, void* part, void* out,
           long long m, int n, int nb, int bm, int kp, int kc, float delta,
           float param, cudaStream_t s) {
  const int rows = DUAL ? 3 : 1;
  const size_t smem =
      ((size_t)n + (USMEM ? (size_t)rows * bm : 0)) * sizeof(float);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = spgram_iter_kernel<T, KIND, DUAL, USMEM>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nb, kThreads, smem, s>>>(
      static_cast<const int*>(idx), static_cast<const T*>(val),
      static_cast<const int*>(cidx), static_cast<const T*>(cval),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(lam), static_cast<const float*>(aux),
      static_cast<float*>(y_out), static_cast<float*>(lam_out),
      static_cast<float*>(part), m, n, bm, kp, kc, delta, param);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  spgram_reduce_kernel<<<(rows * n + threads - 1) / threads, threads, 0,
                         s>>>(static_cast<const float*>(part), n, rows, nb,
                              static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T, int KIND>
int dispatch(int want_dual, int u_smem, const void* idx, const void* val,
             const void* cidx, const void* cval, const void* x,
             const void* y, const void* lam, const void* aux, void* y_out,
             void* lam_out, void* part, void* out, long long m, int n,
             int nb, int bm, int kp, int kc, float delta, float param,
             cudaStream_t s) {
#define REPRO_SPGRAM_LAUNCH(DUAL, USMEM)                                  \
  return launch<T, KIND, DUAL, USMEM>(idx, val, cidx, cval, x, y, lam, aux, \
                                      y_out, lam_out, part, out, m, n, nb, \
                                      bm, kp, kc, delta, param, s)
  if (want_dual && u_smem) REPRO_SPGRAM_LAUNCH(true, true);
  if (want_dual) REPRO_SPGRAM_LAUNCH(true, false);
  if (u_smem) REPRO_SPGRAM_LAUNCH(false, true);
  REPRO_SPGRAM_LAUNCH(false, false);
#undef REPRO_SPGRAM_LAUNCH
}

}  // namespace

// One K6 iteration. idx/cidx int32; val/cval of `dtype` (0 f32, 1 bf16);
// x (n,), y, lam, aux (m,) f32 (aux may be null: 0); y_out, lam_out (m,)
// f32; part (nb, 3, n) f32 scratch; out (want_dual ? 3 : 1, n) f32.
// u_smem: keep the row weights in shared memory (4 (n + 3 bm) bytes, or
// 4 (n + bm) without want_dual, at most 227 KB).
extern "C" int repro_spgram_iter(const void* idx, const void* val,
                                 const void* cidx, const void* cval,
                                 int dtype, const void* x, const void* y,
                                 const void* lam, const void* aux,
                                 void* y_out, void* lam_out, void* part,
                                 void* out, long long m, int n, int nb,
                                 int bm, int kp, int kc, int kind,
                                 float delta, float param, int want_dual,
                                 int u_smem, void* stream) {
  if (n <= 0 || nb <= 0 || bm <= 0 || kp <= 0 || kc <= 0 || m < 0 ||
      m > (long long)nb * bm)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_DISPATCH_KIND(kind, return dispatch<float, KIND>(
        want_dual, u_smem, idx, val, cidx, cval, x, y, lam, aux, y_out,
        lam_out, part, out, m, n, nb, bm, kp, kc, delta, param, s));
  }
  if (dtype == 1) {
    REPRO_DISPATCH_KIND(kind, return dispatch<__nv_bfloat16, KIND>(
        want_dual, u_smem, idx, val, cidx, cval, x, y, lam, aux, y_out,
        lam_out, part, out, m, n, nb, bm, kp, kc, delta, param, s));
  }
  return cudaErrorInvalidValue;
}
