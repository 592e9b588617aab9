// K5: the RWKV-6 WKV recurrence over chunks,
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// with S_0 = 0 and w_t = exp(max(w_log_t, clamp)), in the chunked form of
// the reference: per chunk of L steps, with cum the inclusive prefix sum
// of the log-decay inside the chunk,
//   A[t, s] = sum_d r[t, d] e^{cum[t-1, d]} k[s, d] e^{-cum[s, d]}  (s < t)
//   y[t]    = sum_{s<t} A[t, s] v[s] + (sum_d r[t, d] u[d] k[t, d]) v[t]
//             + (r[t] e^{cum[t-1]}) S
//   S      <- diag(e^{cum[L-1]}) S + sum_s (k[s] e^{cum[L-1] - cum[s]}) v[s]^T
// r, k, v: (B, H, T, hd) f32 or bf16 (converted to f32 on load); w_log:
// (B, H, T, hd) f32; u: (H, hd) f32, contiguous; y: (B, H, T, hd) f32; every
// 4-D tensor with any strides and a unit stride along hd. The final state
// (B, H, hd, hd) f32, contiguous, is written when s_out is not null.
//
// Replaces repro/kernels/wkv/wkv.py::wkv_pallas (`_wkv_kernel`).
//
// Bound on the card: at the rwkv6-1.6b shape (B 8, H 32, T 4096, hd 64,
// chunk 16, bf16 r/k/v) the products r~ S and k~^T v over 65,536 chunks
// are ~20 GFLOP, 0.31 ms at the FP32 peak; the 0.94 GB of inputs and y take
// 0.28 ms at the HBM rate: operations bound it, narrowly (PERF.md).
//
// Design. The TPU kernel kept S in a VMEM scratch across a sequential grid
// axis over the chunks. Here:
//   * one CTA of 128 threads per (value-column group of 16, h, b): column j
//     of y and of S depends only on column j of v and of S, so the hd / 16
//     groups of one (b, h) run in parallel with no reduction across CTAs;
//     each recomputes the small L x L score tile A;
//   * the CTA loops over the chunks; its hd x 16 slice of S stays in
//     shared memory for the whole sweep and leaves it only at the end;
//   * per chunk: load r, k, w (clamped) and the v columns, f32, into shared
//     memory (row strides padded to hd + 1); one thread per channel takes
//     the prefix sum of the log-decay; all threads form r~, k~, the state
//     weights k e^{cum[L-1] - cum} and r u k; A's strictly lower entries
//     are dot products (entries above the diagonal are never formed, so an
//     overflow there cannot turn into NaN through a multiply by 0; the
//     diagonal holds sum_d r u k); y's outputs and S's entries are one
//     thread each, summed in a fixed order.
// Nothing is atomic and every sum runs in a fixed order, so two identical
// calls are bitwise equal. expf is IEEE (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 16;       // value columns per CTA
constexpr int kMaxChunk = 17;  // e^{5 L} stays below f32's largest value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Strides {
  long long b, h, t;            // elements; the stride along hd is 1
};

template <int HD>
size_t smem_bytes(int L) {
  const size_t P = HD + 1;
  return sizeof(float) * (4 * L * P + (size_t)L * kCols + (size_t)L * (L + 1) +
                          (size_t)HD * kCols + 3 * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int T_len, int L, Strides sr,
           Strides sk, Strides sv, Strides sw, Strides sy, float clamp) {
  constexpr int P = HD + 1;     // padded row stride of the L x hd tiles
  extern __shared__ float smem[];
  float* Rt = smem;             // r, then r e^{cum - w}
  float* Kt = Rt + L * P;       // k, then k e^{-cum}
  float* Kk = Kt + L * P;       // cum, then k e^{cum[L-1] - cum}
  float* Ru = Kk + L * P;       // w (clamped), then r u k
  float* Vs = Ru + L * P;       // L x 16 columns of v
  float* A = Vs + L * kCols;    // L x (L + 1); diagonal: sum_d r u k
  float* S = A + L * (L + 1);   // hd x 16 columns of the state
  float* Us = S + HD * kCols;   // u[h]
  float* Cl = Us + HD;          // cum[L-1]
  float* Dec = Cl + HD;         // e^{cum[L-1]}

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h + col0;
  const float* wb = w + b * sw.b + h * sw.h;
  float* yb = y + b * sy.b + h * sy.h + col0;

  for (int e = tid; e < HD * kCols; e += kThreads) S[e] = 0.f;
  for (int d = tid; d < HD; d += kThreads) Us[d] = u[h * HD + d];

  const int n_chunks = T_len / L;
  for (int c = 0; c < n_chunks; ++c) {
    const long long t0 = (long long)c * L;
    // 1. the chunk's r, k, w (clamped, NaN kept as jnp.maximum keeps it)
    //    and v columns, in f32
    for (int e = tid; e < L * HD; e += kThreads) {
      const int t = e / HD, d = e % HD;
      Rt[t * P + d] = to_f32(rb[(t0 + t) * sr.t + d]);
      Kt[t * P + d] = to_f32(kb[(t0 + t) * sk.t + d]);
      const float wl = wb[(t0 + t) * sw.t + d];
      Ru[t * P + d] = wl < clamp ? clamp : wl;
    }
    for (int e = tid; e < L * kCols; e += kThreads) {
      const int t = e / kCols, j = e % kCols;
      Vs[e] = to_f32(vb[(t0 + t) * sv.t + j]);
    }
    __syncthreads();
    // 2a. inclusive prefix sum of the log-decay, one thread per channel
    if (tid < HD) {
      float cum = 0.f;
      for (int t = 0; t < L; ++t) {
        cum += Ru[t * P + tid];
        Kk[t * P + tid] = cum;
      }
      Cl[tid] = cum;
      Dec[tid] = expf(cum);
    }
    __syncthreads();
    // 2b. the decay-scaled operands, one (t, d) each
    for (int e = tid; e < L * HD; e += kThreads) {
      const int t = e / HD, d = e % HD;
      const float cum = Kk[t * P + d], wl = Ru[t * P + d];
      const float rr = Rt[t * P + d], kk = Kt[t * P + d];
      Rt[t * P + d] = rr * expf(cum - wl);
      Kt[t * P + d] = kk * expf(-cum);
      Kk[t * P + d] = kk * expf(Cl[d] - cum);
      Ru[t * P + d] = rr * Us[d] * kk;
    }
    __syncthreads();
    // 3. A: strictly lower entries and the bonus diagonal
    for (int e = tid; e < L * L; e += kThreads) {
      const int t = e / L, s = e % L;
      if (s > t) continue;
      float acc = 0.f;
      if (s < t) {
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          acc = fmaf(Rt[t * P + d], Kt[s * P + d], acc);
      } else {
#pragma unroll 16
        for (int d = 0; d < HD; ++d) acc += Ru[t * P + d];
      }
      A[t * (L + 1) + s] = acc;
    }
    __syncthreads();
    // 4. y = A v + diag v + r~ S, one output each
    for (int e = tid; e < L * kCols; e += kThreads) {
      const int t = e / kCols, j = e % kCols;
      float acc = 0.f;
      for (int s = 0; s < t; ++s)
        acc = fmaf(A[t * (L + 1) + s], Vs[s * kCols + j], acc);
      acc += A[t * (L + 1) + t] * Vs[t * kCols + j];
      float inter = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d)
        inter = fmaf(Rt[t * P + d], S[d * kCols + j], inter);
      yb[(t0 + t) * sy.t + j] = acc + inter;
    }
    __syncthreads();
    // 5. S <- diag(e^{cum[L-1]}) S + kk^T v, one entry each
    for (int e = tid; e < HD * kCols; e += kThreads) {
      const int d = e / kCols, j = e % kCols;
      float acc = 0.f;
      for (int s = 0; s < L; ++s)
        acc = fmaf(Kk[s * P + d], Vs[s * kCols + j], acc);
      S[e] = Dec[d] * S[e] + acc;
    }
    __syncthreads();
  }

  if (s_out != nullptr) {
    float* so = s_out + ((long long)b * gridDim.y + h) * HD * HD + col0;
    for (int e = tid; e < HD * kCols; e += kThreads) {
      const int d = e / kCols, j = e % kCols;
      so[d * HD + j] = S[e];
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, float* y, float* s_out,
                   int B, int H, int T_len, int L, Strides sr, Strides sk,
                   Strides sv, Strides sw, Strides sy, float clamp,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(L);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(HD / kCols, H, B);
  wkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, y, s_out, T_len, L, sr, sk, sv, sw,
      sy, clamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int HD, const void* r, const void* k, const void* v,
                        const float* w, const float* u, float* y,
                        float* s_out, int B, int H, int T_len, int L,
                        Strides sr, Strides sk, Strides sv, Strides sw,
                        Strides sy, float clamp, cudaStream_t stream) {
  switch (HD) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, y, s_out, B, H, T_len, L, sr, sk,
                           sv, sw, sy, clamp, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, y, s_out, B, H, T_len, L, sr, sk,
                           sv, sw, sy, clamp, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, y, s_out, B, H, T_len, L, sr, sk,
                           sv, sw, sy, clamp, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v): 0 float32, 1 bfloat16. Strides in elements,
// (batch, head, time) for each of r, k, v, w, y. T_len % L == 0 and
// 1 <= L <= 17. s_out may be null. Returns cudaGetLastError() after the
// launch.
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* y, void* s_out,
                         int dtype, int B, int H, int T_len, int HD, int L,
                         long long rsb, long long rsh, long long rst,
                         long long ksb, long long ksh, long long kst,
                         long long vsb, long long vsh, long long vst,
                         long long wsb, long long wsh, long long wst,
                         long long ysb, long long ysh, long long yst,
                         float clamp, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return cudaSuccess;
  if (L < 1 || L > kMaxChunk || T_len % L != 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides sr{rsb, rsh, rst}, sk{ksb, ksh, kst}, sv{vsb, vsh, vst},
      sw{wsb, wsh, wst}, sy{ysb, ysh, yst};
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(HD, r, k, v, wf, uf, yf, so, B, H, T_len, L,
                              sr, sk, sv, sw, sy, clamp, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(HD, r, k, v, wf, uf, yf, so, B, H,
                                      T_len, L, sr, sk, sv, sw, sy, clamp, s);
  return cudaErrorInvalidValue;
}
