// K4: causal / GQA flash attention forward,
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
// with f32 running max, denominator and accumulator (an online softmax over
// kv tiles), causal masking q_pos >= k_pos on absolute indices (top-left
// aligned when Sq != Skv), masked scores at -1e30 and a final divide by
// max(l, 1e-30). q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D), f32 or bf16, any
// strides with a unit stride along D; o in q's type.
//
// Replaces repro/kernels/flash_attn/flash_attn.py::flash_attention_pallas
// (`_flash_kernel`), with flash_attn_sm90.cu: this is K4's FP32-FMA route,
// taken by f32 inputs at every head dim and by bf16 at head dim 16
// (kernels/flash_attn/ops.py::route). bf16 at head dims 64 and 128, every
// bf16 call of qwen3-8b, goes to the tensor-core kernel instead. f32 stays
// here because TF32 would miss the f32 tolerance.
//
// Bound on the card: operations. A causal call does 4 D per visible
// (q, k) pair, B Hq D Sq (Sq + 1) 2 FLOP when Sq = Skv: 275 GFLOP at the
// qwen3-8b shape (B 2, Hq 32, S 4096, D 128) against 201 MB of q, k, v
// and o (bf16; twice that in f32): 4.10 ms at the FP32 peak, the rate this
// kernel's FP32 FMA can reach (PERF.md).
//
// Design. The TPU kernel ran a sequential grid whose innermost axis swept
// the kv blocks, with the statistics resident in VMEM scratch. Here:
//   * one CTA of 256 threads per (b, q head, 64-row q tile); the kv sweep
//     is a loop inside the CTA. The q tile is staged once in shared
//     memory; each 64-row K and V tile is staged per step, bf16 upcast to
//     f32 on the way in, ragged rows of q and kv zero-filled and masked;
//   * kv tiles wholly above the diagonal are never visited;
//   * thread (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 and
//     score columns tx + 16 j: S = Q K^T by FP32 FMA from shared memory
//     (row strides padded to D + 1, so neither operand's reads conflict);
//     the row max and row sum are butterfly shuffles over the 16 lanes that
//     share a row, so every lane holds its rows' m and l;
//   * P = exp(S - m) goes to shared memory over the K tile (dead by then)
//     and each thread accumulates P V into its rows x (D / 16) columns of
//     the output in registers;
//   * the kv head is h / (Hq / Hkv): no repeated K or V exists;
//   * causal q tiles are launched heaviest first.
// Every sum runs in a fixed order and nothing is atomic, so two identical
// calls are bitwise equal. expf and division are IEEE (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // q rows and kv rows per tile
constexpr int kThreads = 256;   // a 16 x 16 thread grid, 4 x 4 scores each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;            // elements; the stride along D is 1
};

template <int D>
__host__ __device__ constexpr int k_rows() {  // floats per K / P row
  return D + 1 > kTile + 1 ? D + 1 : kTile + 1;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kTile * (D + 1) + (size_t)kTile * k_rows<D>() +
          (size_t)kTile * D);
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          long long src_stride, int rows) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * stride + c] = r < rows ? to_f32(src[r * src_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int group,
                  int Sq, int Skv, Strides sq, Strides sk, Strides sv,
                  Strides so, float scale, int causal) {
  constexpr int kQS = D + 1;       // padded row stride of the Q and K tiles
  constexpr int kPS = kTile + 1;   // padded row stride of the P tile
  constexpr int kDC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // 64 x (D + 1)
  float* Ks = Qs + kTile * kQS;            // 64 x (D + 1), then P 64 x 65
  float* Vs = Ks + kTile * k_rows<D>();    // 64 x D
  float* Ps = Ks;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = iq * kTile;
  const int nq = min(kTile, Sq - q0);
  const int r0 = ty * 4;

  load_tile<T, D>(Qs, kQS, q + b * sq.b + h * sq.h + (long long)q0 * sq.s,
                  sq.s, nq);

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // kv tiles with k_start <= q_end (causal), else all of them
  const int q_end = q0 + nq - 1;
  const int kv_end = causal ? min(Skv, q_end + 1) : Skv;
  const int n_kt = (kv_end + kTile - 1) / kTile;
  const T* kbase = k + b * sk.b + hk * sk.h;
  const T* vbase = v + b * sv.b + hk * sv.h;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Skv - k0);
    __syncthreads();   // the previous step's reads of P and V are done
    load_tile<T, D>(Ks, kQS, kbase + (long long)k0 * sk.s, sk.s, nk);
    load_tile<T, D>(Vs, D, vbase + (long long)k0 * sv.s, sv.s, nk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(r0 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * kQS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = kp < Skv && (!causal || qp >= kp);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();   // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(r0 + i) * kPS + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(r0 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  T* obase = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (r < nq) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = obase + (long long)(q0 + r) * so.s;
#pragma unroll
      for (int c = 0; c < kDC; ++c)
        store(orow + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  flash_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hkv, Sq, Skv, sq,
      sk, sv, so, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sq, sk, sv, so,
                           scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sq, sk, sv, so,
                           scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sq, sk, sv, so,
                            scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32 (D 16, 64, 128), 1 bfloat16 (D 16). Strides in
// elements, (batch, head, seq) for each of q, k, v, o. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attn(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss},
      so{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, sq, sk, sv,
                             so, scale, causal, s);
  // bf16 comes here at head dim 16 only: at 64 and 128 it takes the
  // tensor-core kernel (flash_attn_sm90.cu)
  if (dtype == 1 && D == 16)
    return launch<__nv_bfloat16, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sq, sk,
                                     sv, so, scale, causal, s);
  return cudaErrorInvalidValue;
}
