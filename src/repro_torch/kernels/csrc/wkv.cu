// K5: the RWKV-6 WKV recurrence over chunks,
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// with S_0 = 0 and w_t = exp(max(w_log_t, clamp)), in the chunked form of
// the reference: per chunk of L steps, with cum the inclusive prefix sum
// of the log-decay inside the chunk,
//   A[t, s] = sum_d r[t, d] e^{cum[t-1, d]} k[s, d] e^{-cum[s, d]}  (s < t)
//   y[t]    = sum_{s<t} A[t, s] v[s] + (sum_d r[t, d] u[d] k[t, d]) v[t]
//             + (r[t] e^{cum[t-1]}) S
//   S      <- diag(e^{cum[L-1]}) S + sum_s (k[s] e^{cum[L-1] - cum[s]}) v[s]^T
// r, k, v: (B, H, T, hd) f32 or bf16 (converted to f32 on use); w_log:
// (B, H, T, hd) f32; u: (H, hd) f32, contiguous; y: (B, H, T, hd) f32,
// rows 16-byte aligned (the wrapper allocates it); every 4-D tensor with any
// strides and a unit stride along hd. The final state (B, H, hd, hd) f32,
// contiguous, is written when s_out is not null.
//
// Replaces repro/kernels/wkv/wkv.py::wkv_pallas (`_wkv_kernel`).
//
// Bound on the card: at the rwkv6-1.6b shape (B 8, H 32, T 4096, hd 64,
// chunk 16, bf16 r/k/v) the products r~ S and k~^T v over 65,536 chunks
// are ~20 GFLOP, 0.31 ms at the FP32 peak; the 0.94 GB of inputs and y take
// 0.28 ms at the HBM rate: operations bound it, narrowly (PERF.md). The
// chunks of one (b, h) are a chain, so what a chunk waits for (loads,
// barriers, dependent sums) is paid T / L times per CTA. bf16 tensor cores
// cannot take the decay-scaled operands (factors up to e^80) within the
// 2e-5 bound, and TF32 is ruled out: FP32 FMA throughout.
//
// Design. The TPU kernel kept S in a VMEM scratch across a sequential grid
// axis over the chunks. Here one CTA of 256 threads per (h, b) walks the
// chunks with its hd x hd state on chip:
//   * the next chunk in flight: chunk c + 1's rows of r, k, v and w_log go
//     into the other of two shared-memory stages by 16-byte cp.async while
//     chunk c computes. A tensor whose base or strides are not multiples of
//     16 bytes takes the stated other route: its rows are copied into the
//     next stage by plain loads at the same point (the latency is exposed,
//     the result is the same);
//   * phase 1, all threads: thread (channel d, t-group g) owns rows
//     [g tpt, (g + 1) tpt) of channel d, one of G = 256 / hd groups. Each
//     thread sums the clamped log-decay of its channel from row 0 in
//     sequence (L broadcast loads and adds; no barrier, and the prefix sum
//     keeps the reference's order, which e^{+-cum}, |cum| up to 85, would
//     magnify), then forms its rows' r~ = r e^{cum - w}, k~ = k e^{-cum},
//     the state weights k e^{cum[L-1] - cum}, r u k and v in f32: the three
//     exps per (t, d) are done once per (b, h), not once per column group;
//   * phase 2: A's strictly lower entries and the bonus diagonal, one
//     entry a thread, float4 loads and one sequential sum over hd, the
//     plain version's order on the card (four partial sums were tried:
//     as fast, and they moved y several times further from the chunked
//     forms the model is checked against). Entries above the diagonal are
//     never formed, so an overflow there cannot turn into NaN through a
//     multiply by 0;
//   * phase 3, split by warps: warps 0-3 form y, two rows x four columns
//     a thread (six 16-byte shared loads per 32 FMA of r~ S); warps 4-7
//     hold S in registers, four rows x two column quads hd / 2 apart a
//     thread (so a quarter-warp's 16-byte loads of v cover 128 contiguous
//     bytes, free of bank conflicts), and update it (three 16-byte loads
//     per 32 FMA of kk^T v); they publish it to shared memory for the next
//     chunk's y at the start of its phase 1.
//   Three barriers a chunk (the old design had six). A warp's 16-byte
//   shared load takes as much of the SM's shared-memory pipe whether or not
//   its lanes share addresses, so that pipe, shared by the two CTAs on an
//   SM, and the latency of the chunk chain set the pace, not the FMAs
//   (PERF.md, section 7).
// Nothing is atomic and every sum runs in a fixed order, so two identical
// calls are bitwise equal. expf is IEEE (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // phase 3: y warps, then S warps
constexpr int kMaxChunk = 17;  // e^{5 L} stays below f32's largest value
constexpr int kPad = 8;        // elements of padding per shared row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Strides {
  long long b, h, t;            // elements; the stride along hd is 1
};

// Shared memory, for a chunk of L rows: two stages of raw rows ([r | k | v
// | w_log], row pitch hd + kPad elements), then f32 S (hd x hd), r~, k~,
// the state weights, r u k and v (L x (hd + kPad) each), e^{cum[L-1]} (hd)
// and A (L x (L + 1)).
template <typename T, int HD>
__host__ __device__ __forceinline__ int stage_bytes(int L) {
  return L * (HD + kPad) * (3 * (int)sizeof(T) + 4);
}

template <typename T, int HD>
size_t smem_bytes(int L) {
  const size_t P = HD + kPad;
  return 2 * (size_t)stage_bytes<T, HD>(L) +
         sizeof(float) * (HD * HD + 5 * L * P + HD + (size_t)L * (L + 1));
}

// L rows of hd elements from src (row stride st) into dst (row pitch
// hd + kPad): 16-byte cp.async pieces when the rows are 16-byte aligned,
// else plain loads and stores.
template <typename E, int HD>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           long long st, int L, bool vec,
                                           int tid) {
  constexpr int P = HD + kPad;
  if (vec) {
    constexpr int kV = 16 / sizeof(E);
    constexpr int kPer = HD / kV;   // pieces per row
    for (int p = tid; p < L * kPer; p += kThreads) {
      const int t = p / kPer, q = (p % kPer) * kV;
      const uint32_t d =
          static_cast<uint32_t>(__cvta_generic_to_shared(dst + t * P + q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(reinterpret_cast<uint64_t>(src + t * st + q))
                   : "memory");
    }
  } else {
    for (int e = tid; e < L * HD; e += kThreads) {
      const int t = e / HD, q = e % HD;
      dst[t * P + q] = src[t * st + q];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int T_len, int L, Strides sr,
           Strides sk, Strides sv, Strides sw, Strides sy, float clamp,
           int vec) {
  constexpr int P = HD + kPad;        // row pitch of the L x hd tiles
  constexpr int G = kThreads / HD;    // phase 1: t-groups per channel
  constexpr int CPW = 32 / G;         // phase 1: channels per warp
  constexpr int kMaxT = (kMaxChunk + G - 1) / G;  // rows per thread, at most
  constexpr int JQ = HD / 4;          // y: column quads per row pair
  constexpr int JO = HD / 8;          // S: column-quad pairs per row quad
  static_assert((HD / 4) * JO <= kHalf, "one S block per S thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int sbytes = stage_bytes<T, HD>(L);
  const int rkv = L * P * (int)sizeof(T);
  float* S = reinterpret_cast<float*>(smem + 2 * sbytes);
  float* Rt = S + HD * HD;      // r e^{cum - w}
  float* Kt = Rt + L * P;       // k e^{-cum}
  float* Kk = Kt + L * P;       // k e^{cum[L-1] - cum}
  float* Ru = Kk + L * P;       // r u k
  float* Vs = Ru + L * P;       // v
  float* Dec = Vs + L * P;      // e^{cum[L-1]}
  float* A = Dec + HD;          // L x (L + 1); diagonal: sum_d r u k

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  float* yb = y + b * sy.b + h * sy.h;

  // phase 1: channel d, rows [t_lo, t_hi)
  const int g = lane / CPW, d = warp * CPW + lane % CPW;
  const float ud = u[h * HD + d];
  const int tpt = (L + G - 1) / G;
  const int t_lo = min(L, g * tpt), t_hi = min(L, t_lo + tpt);
  // phase 3, S warps: rows [d0, d0 + 4) x columns [j0, j0 + 4) and
  // [j0 + hd / 2, j0 + hd / 2 + 4) of S (a quarter-warp's 16-byte loads of
  // v then cover 128 contiguous bytes: no bank conflict)
  const int su = tid - kHalf;
  const bool s_role = su >= 0 && su < (HD / 4) * JO;
  const int d0 = s_role ? 4 * (su / JO) : 0, j0 = s_role ? 4 * (su % JO) : 0;
  float Sr[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Sr[i][j] = 0.f;

  const int n_chunks = T_len / L;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      unsigned char* st = smem + (c % 2) * sbytes;
      const long long t0 = (long long)c * L;
      stage_rows<T, HD>(reinterpret_cast<T*>(st), rb + t0 * sr.t, sr.t, L,
                        vec & 1, tid);
      stage_rows<T, HD>(reinterpret_cast<T*>(st + rkv), kb + t0 * sk.t, sk.t,
                        L, vec & 2, tid);
      stage_rows<T, HD>(reinterpret_cast<T*>(st + 2 * rkv), vb + t0 * sv.t,
                        sv.t, L, vec & 4, tid);
      stage_rows<float, HD>(reinterpret_cast<float*>(st + 3 * rkv),
                            wb + t0 * sw.t, sw.t, L, vec & 8, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // maybe empty
  };

  issue(0);
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed, and every thread is done with chunk c - 1 (its
    // stage, A, the f32 tiles and S)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    issue(c + 1);
    if (s_role) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = S + (d0 + i) * HD + j0;  // and row + hd / 2
        *reinterpret_cast<float4*>(row) =
            make_float4(Sr[i][0], Sr[i][1], Sr[i][2], Sr[i][3]);
        *reinterpret_cast<float4*>(row + HD / 2) =
            make_float4(Sr[i][4], Sr[i][5], Sr[i][6], Sr[i][7]);
      }
    }

    // 1. prefix sum of the clamped log-decay (NaN kept, as jnp.maximum
    //    keeps it) and the decay-scaled operands
    const unsigned char* st = smem + (c % 2) * sbytes;
    const T* Rs = reinterpret_cast<const T*>(st);
    const T* Ks = reinterpret_cast<const T*>(st + rkv);
    const T* Vg = reinterpret_cast<const T*>(st + 2 * rkv);
    const float* Ws = reinterpret_cast<const float*>(st + 3 * rkv);
    // every thread sums its channel's log-decay from row 0 in sequence,
    // so cum has the reference's order whatever rows the thread owns
    float wl[kMaxT], cum[kMaxT];
    float run = 0.f;
    for (int t = 0; t < t_lo; ++t) {
      const float x = Ws[t * P + d];
      run += x < clamp ? clamp : x;
    }
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) {
      float x = 0.f;
      if (t_lo + i < t_hi) {
        x = Ws[(t_lo + i) * P + d];
        x = x < clamp ? clamp : x;
        run += x;
      }
      wl[i] = x;
      cum[i] = run;
    }
    for (int t = t_hi; t < L; ++t) {
      const float x = Ws[t * P + d];
      run += x < clamp ? clamp : x;
    }
    const float cl = run;
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) {
      const int t = t_lo + i;
      if (t < t_hi) {
        const float rr = to_f32(Rs[t * P + d]), kk = to_f32(Ks[t * P + d]);
        Rt[t * P + d] = rr * expf(cum[i] - wl[i]);
        Kt[t * P + d] = kk * expf(-cum[i]);
        Kk[t * P + d] = kk * expf(cl - cum[i]);
        Ru[t * P + d] = rr * ud * kk;
        Vs[t * P + d] = to_f32(Vg[t * P + d]);
      }
    }
    if (g == 0) Dec[d] = expf(cl);
    __syncthreads();

    // 2. A: strictly lower entries and the bonus diagonal
    for (int e = tid; e < L * (L + 1) / 2; e += kThreads) {
      int t = 0;
      while ((t + 1) * (t + 2) / 2 <= e) ++t;
      const int s = e - t * (t + 1) / 2;
      float acc = 0.f;
      if (s < t) {
#pragma unroll
        for (int dd = 0; dd < HD; dd += 4) {
          const float4 x = ld4(Rt + t * P + dd), z = ld4(Kt + s * P + dd);
          acc = fmaf(x.x, z.x, acc);
          acc = fmaf(x.y, z.y, acc);
          acc = fmaf(x.z, z.z, acc);
          acc = fmaf(x.w, z.w, acc);
        }
      } else {
#pragma unroll
        for (int dd = 0; dd < HD; dd += 4) {
          const float4 x = ld4(Ru + t * P + dd);
          acc += x.x;
          acc += x.y;
          acc += x.z;
          acc += x.w;
        }
      }
      A[t * (L + 1) + s] = acc;
    }
    __syncthreads();

    // 3. y = A v + diag v + r~ S (warps 0-3); S <- diag(e^{cum[L-1]}) S +
    //    kk^T v in registers (warps 4-7)
    if (tid < kHalf) {
      for (int q = tid; q < ((L + 1) / 2) * JQ; q += kHalf) {
        const int t0 = 2 * (q / JQ), j = 4 * (q % JQ);
        const bool two = t0 + 1 < L;
        const int t1 = two ? t0 + 1 : t0;
        const float* A0 = A + t0 * (L + 1);
        const float* A1 = A + t1 * (L + 1);
        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
        for (int s = 0; s < t0; ++s) {
          const float4 vv = ld4(Vs + s * P + j);
          a0 = fma4(A0[s], vv, a0);
          a1 = fma4(A1[s], vv, a1);
        }
        const float4 v0 = ld4(Vs + t0 * P + j), v1 = ld4(Vs + t1 * P + j);
        a1 = fma4(A1[t0], v0, a1);        // row t1's s = t0 (unused if !two)
        a0 = fma4(A0[t0], v0, a0);        // the bonus diagonal
        a1 = fma4(A1[t1], v1, a1);
        float4 i0 = make_float4(0.f, 0.f, 0.f, 0.f), i1 = i0;
        const float* R0 = Rt + t0 * P;
        const float* R1 = Rt + t1 * P;
#pragma unroll 4
        for (int dd = 0; dd < HD; dd += 4) {
          const float4 x0 = ld4(R0 + dd), x1 = ld4(R1 + dd);
          const float r0v[4] = {x0.x, x0.y, x0.z, x0.w};
          const float r1v[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 sv = ld4(S + (dd + i) * HD + j);
            i0 = fma4(r0v[i], sv, i0);
            i1 = fma4(r1v[i], sv, i1);
          }
        }
        const long long tg = (long long)c * L + t0;
        *reinterpret_cast<float4*>(yb + tg * sy.t + j) = make_float4(
            a0.x + i0.x, a0.y + i0.y, a0.z + i0.z, a0.w + i0.w);
        if (two)
          *reinterpret_cast<float4*>(yb + (tg + 1) * sy.t + j) = make_float4(
              a1.x + i1.x, a1.y + i1.y, a1.z + i1.z, a1.w + i1.w);
      }
    } else if (s_role) {
      float part[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float4 kq = ld4(Kk + s * P + d0);
        const float4 va = ld4(Vs + s * P + j0),
                     vc = ld4(Vs + s * P + j0 + HD / 2);
        const float kv[4] = {kq.x, kq.y, kq.z, kq.w};
        const float vv[8] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = fmaf(kv[i], vv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dec = Dec[d0 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) Sr[i][j] = dec * Sr[i][j] + part[i][j];
      }
    }
  }

  if (s_out != nullptr && s_role) {
    float* so = s_out + ((long long)b * gridDim.x + h) * HD * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = so + (d0 + i) * HD + j0;
      *reinterpret_cast<float4*>(row) =
          make_float4(Sr[i][0], Sr[i][1], Sr[i][2], Sr[i][3]);
      *reinterpret_cast<float4*>(row + HD / 2) =
          make_float4(Sr[i][4], Sr[i][5], Sr[i][6], Sr[i][7]);
    }
  }
}

// 16-byte rows: the base and every stride that offsets a row are multiples
// of 16 bytes
bool rows_aligned(const void* p, Strides s, int esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * esize) % 16 == 0 &&
         (s.h * esize) % 16 == 0 && (s.t * esize) % 16 == 0;
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, float* y, float* s_out,
                   int B, int H, int T_len, int L, Strides sr, Strides sk,
                   Strides sv, Strides sw, Strides sy, float clamp,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(L);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int es = (int)sizeof(T);
  const int vec = (rows_aligned(r, sr, es) ? 1 : 0) |
                  (rows_aligned(k, sk, es) ? 2 : 0) |
                  (rows_aligned(v, sv, es) ? 4 : 0) |
                  (rows_aligned(w, sw, 4) ? 8 : 0);
  const dim3 grid(H, B);
  wkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, y, s_out, T_len, L, sr, sk, sv, sw,
      sy, clamp, vec);
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
  // y's rows take float4 stores
  if (!rows_aligned(y, sy, 4)) return cudaErrorInvalidValue;
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
