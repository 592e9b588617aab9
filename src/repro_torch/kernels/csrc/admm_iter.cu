// K3: one fused unwrapped-ADMM iteration over D (paper Alg. 2 lines 5-8):
//   Dx = D x;  y' = prox_f(Dx + lam);  lam' = lam + Dx - y';
//   d = D^T (y' - lam'),  w = D^T (y' - y),  v = D^T lam';
// and the stopping rule's four sums over the rows, from the same registers
// (Dx' = (lam' - lam) + y', the quantity every other path forms):
//   r_sq = sum (lam' - lam)^2,  dx_sq = sum Dx'^2,  y_sq = sum y'^2,
//   obj = scale * sum f(Dx')    (prox.cuh::value_body; scale is hinge's C,
//                                l1's mu, else 1).
// out is (3n + 4,): d, w, v, then r_sq, dx_sq, y_sq, obj.
//
// Replaces repro/kernels/admm_iter/admm_iter.py::admm_iter_pallas
// (`_kernel`), whose prox is repro/kernels/prox/prox.py::_prox_body
// (shared here through prox.cuh).
//
// Bound on the card: bytes. Each iteration must read D once (m n 4 bytes
// in f32, half that in bf16) plus five m-vectors; the 8n FLOP per row are
// ~2 FLOP per byte, far below the card's FP32 ridge. The logistic prox
// (prox.cuh: a bracket from one expf, ceil(log2 delta) bisection steps, 2
// Newton steps and 3 clamped ones) is a dependent chain per row that must
// run under the copies, not beside them.
//
// The TPU kernel streamed (bm x n) panels through VMEM with the d/w/v
// accumulators resident across a sequential grid. Two routes here, picked
// by n and dtype alone (engine/autotune.py::iter_grid):
//
// Ring route (admm_ring_kernel; n <= 512, the main path's n = 307):
//   * one CTA per SM owns a contiguous range of rows, walked in panels of
//     R <= 32 whole rows. A panel of row-major D is one contiguous run of
//     bytes, 16-byte aligned when D's base is and R n is a multiple of 4
//     (f32) or 8 (bf16), so one elected producer thread fetches it with a
//     1-D bulk copy (cp.async.bulk) into a ring of 2-16 shared-memory
//     stages guarded by full / empty mbarriers. A row stays in its stage
//     from its Dx through the prox to the sweep, so the W stages the
//     consumer warps hold and the S - W in flight share the 227 KB: the
//     grid balances the two (engine/autotune.py::_ring_grid; n = 307 f32:
//     W 5 consumer warps, R 20, 9 stages). Bytes before the first and after
//     the last 16-byte boundary of a panel (a ragged last panel, a
//     row-offset view of D) are copied by the same thread with plain loads
//     before it arrives; the stage keeps the global address modulo 16, so
//     the bulk part lands aligned. bf16 stays bf16 in shared memory and is
//     upcast in registers at use;
//   * consumer warps take the panels in turn, warp w the panels w, w + W,
//     ..., one lane per row:
//       - Dx: lane r reads its row P[r n + c] against x (in shared memory).
//         For odd n the lanes hit distinct banks; for even n each lane
//         starts at column r, which does the same. The row's Dx lands in
//         the lane that runs its prox, with no shuffle;
//       - prox: every consumer warp runs R rows' prox_body<KIND> at once,
//         and rows of different warps hide each other's expf / division
//         latency while the producer's copies run underneath; the lane
//         writes y', lam' and the three row weights (y'-lam', y'-y, lam'),
//         each difference taken in registers before any reduction
//         (anti-cancellation rule, DESIGN.md section 7);
//       - sweep: lane l owns columns l + 32k, k < K (K = 10 at n = 307:
//         30 accumulators, an even load across lanes); the weights of four
//         rows at a time come from the warp's slot in shared memory by
//         16-byte broadcast loads. A per-panel partial first, then a
//         Kahan-compensated running sum;
//   * the lane that runs a row's prox also adds the row's four stopping
//     terms to its own Kahan-compensated running sums (stop_terms);
//   * at the end the warps' accumulators are summed in warp order into the
//     CTA's (3n + 4) partial, each warp's four sums first reduced by a
//     fixed shuffle tree.
// Wide route (admm_iter_kernel; any n up to ~11k): each CTA of 256 threads
// stages R <= 32 rows at a time synchronously (upcast on the way in), a
// warp per row for Dx with a butterfly shuffle, warp 0's lanes for the
// prox and the stopping terms, and thread t owns columns t, t + 256, ... of
// the sweep. Shared memory is (R n + 4 n + 128) floats, so n up to ~11k
// fits at R = 1.
// Both routes end in admm_reduce_kernel, which sums the CTA partials in CTA
// order and scales obj. No atomics: bitwise repeatable for given shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// s + v with the running compensation c (Kahan).
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float yv = v - c;
  const float t = s + yv;
  c = (t - s) - yv;
  s = t;
}

// A live row's four stopping terms into a lane's running sums (s, c):
// (lam' - lam)^2, Dx'^2, y'^2 and f(Dx'), Dx' = (lam' - lam) + y' rounded
// as the torch expression rounds it (no contraction).
template <int KIND>
__device__ __forceinline__ void stop_terms(float (&s)[4], float (&c)[4],
                                           float yn, float ln, float l,
                                           float a, float param) {
  const float r = __fsub_rn(ln, l);
  const float dxr = __fadd_rn(r, yn);
  kahan_add(s[0], c[0], r * r);
  kahan_add(s[1], c[1], dxr * dxr);
  kahan_add(s[2], c[2], yn * yn);
  kahan_add(s[3], c[3], repro::value_body<KIND>(dxr, a, param));
}

// The warp's four sums by a fixed tree; lane 0 holds them.
__device__ __forceinline__ void warp_sum4(float (&s)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[j] += __shfl_down_sync(0xffffffffu, s[j], off);
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
  float st[4] = {0.f, 0.f, 0.f, 0.f}, stc[4] = {0.f, 0.f, 0.f, 0.f};

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
        stop_terms<KIND>(st, stc, yn, ln, l, a, param);
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

  float* out = part + (size_t)blockIdx.x * (3 * n + 4);
  for (int c = tid; c < 3 * n; c += kThreads) out[c] = acc[c];
  if (warp == 0) {
    warp_sum4(st);
    if (lane == 0)
      for (int j = 0; j < 4; ++j) out[3 * n + j] = st[j];
  }
}

// ---------------------------------------------------------------- ring --

constexpr int kRing = 32;        // most rows per ring stage: one per lane
constexpr int kMaxStages = 16;
constexpr int kMaxWarps = 8;     // consumer warps; one producer warp more
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full[16], empty[16]

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  // A wait of more than 4 s (a copy lands in microseconds) traps, so a lost
  // arrival fails the launch instead of hanging the card. The clock is the
  // global timer: one try_wait may sleep for a while, so tries are no clock.
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (tries & 1023) == 1023) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t0 == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory; completion is counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void copy_plain(unsigned char* dst,
                                           const unsigned char* src,
                                           long long bytes) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  for (long long i = 0; i < bytes / (long long)sizeof(T); ++i) d[i] = s[i];
}

// Shared-memory bytes of the ring kernel; engine/autotune.py::ring_smem
// mirrors it.
__host__ __device__ __forceinline__ int ring_stage_bytes(int n, int dsize,
                                                        int rows) {
  return (rows * n * dsize + 16 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int ring_fixed_bytes(int n, int warps) {
  return kBarBytes + (n + 3) / 4 * 16 + warps * 3 * kRing * 4;
}

// x . row, lane-per-row: 16 partial sums over the columns in turn, then a
// pairwise tree, so no sum is a long sequential chain (about the accuracy
// of the wide route's 32-lane butterfly; four sequential sums of ~77
// products each put d/w/v 20x further from the plain version at the main
// path's size).
template <typename T>
__device__ __forceinline__ float row_dot(const T* p, const float* xs, int n,
                                         int lane) {
  constexpr int kAcc = 16;
  float a[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) a[j] = 0.f;
  int i = 0;
  if (n & 1) {  // the rows start in distinct banks: every lane reads column c
    for (; i + kAcc <= n; i += kAcc) {
      float v[kAcc];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) v[j] = to_f32(p[i + j]);
#pragma unroll
      for (int j = 0; j < kAcc; j += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + i + j);
        a[j] += v[j] * xv.x;
        a[j + 1] += v[j + 1] * xv.y;
        a[j + 2] += v[j + 2] * xv.z;
        a[j + 3] += v[j + 3] * xv.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kAcc - 1; ++j)
      if (i + j < n) a[j] += to_f32(p[i + j]) * xs[i + j];
  } else {  // lane r starts at column r (mod n), so it reads bank r + i
    int c = lane % n;
    for (; i + kAcc <= n; i += kAcc) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        a[j] += to_f32(p[c]) * xs[c];
        c = c + 1 == n ? 0 : c + 1;
      }
    }
#pragma unroll
    for (int j = 0; j < kAcc - 1; ++j)
      if (i + j < n) {
        a[j] += to_f32(p[c]) * xs[c];
        c = c + 1 == n ? 0 : c + 1;
      }
  }
#pragma unroll
  for (int w = kAcc / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] += a[j + w];
  return a[0];
}

// One row of the sweep: column l + 32k of the row times the row's three
// weights, into this lane's partials. off[k] = min(l + 32k, n - 1): every
// load is in the row and none sits behind a branch, so the K loads of a row
// are in flight together; the partials of columns past n are never stored.
template <typename T, int K>
__device__ __forceinline__ void sweep_row(float (&p)[3][K],
                                          const int (&off)[K],
                                          const T* prow, float u0, float u1,
                                          float u2) {
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = to_f32(prow[off[k]]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[0][k] += u0 * v[k];
    p[1][k] += u1 * v[k];
    p[2][k] += u2 * v[k];
  }
}

template <typename T, int KIND, int K>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32)
admm_ring_kernel(const T* __restrict__ D, const float* __restrict__ x,
                 const float* __restrict__ y, const float* __restrict__ lam,
                 const float* __restrict__ aux, float* __restrict__ y_out,
                 float* __restrict__ lam_out, float* __restrict__ part,
                 long long m, int n, long long rows_per_cta, int rows,
                 int stages, float delta, float param) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32 - 1;   // consumer warps
  const int stage_bytes = ring_stage_bytes(n, sizeof(T), rows);
  const uint32_t bar_full = smem_u32(smem_raw);
  const uint32_t bar_empty = bar_full + kMaxStages * 8;
  float* xs = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* wts = xs + (n + 3) / 4 * 4;       // per warp: 3 x 32 row weights
  unsigned char* ring = smem_raw + ring_fixed_bytes(n, warps);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long r_begin = (long long)blockIdx.x * rows_per_cta;
  const long long r_end = min(m, r_begin + rows_per_cta);
  const int npanels =
      r_end > r_begin ? (int)((r_end - r_begin + rows - 1) / rows) : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);    // the producer's arrival + bytes
      mbar_init(bar_empty + 8 * s, 1);   // the consuming warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < n; c += blockDim.x) xs[c] = x[c];
  __syncthreads();

  // running sums of the panels' partials, Kahan-compensated: a warp adds
  // ~800 partials at the main path's size, and an uncompensated f32 chain
  // that long put d/w/v 1.2e-4 from the plain version (its bound: 1e-4)
  float acc[3][K], comp[3][K];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[j][k] = comp[j][k] = 0.f;
  // this lane's rows' stopping terms, Kahan-compensated as well
  float st[4] = {0.f, 0.f, 0.f, 0.f}, stc[4] = {0.f, 0.f, 0.f, 0.f};

  if (warp == warps) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      for (int k = 0; k < npanels; ++k) {
        const int s = k % stages;
        if (k >= stages) mbar_wait(bar_empty + 8 * s, ((k / stages) - 1) & 1);
        const long long row0 = r_begin + (long long)k * rows;
        const long long bytes =
            min((long long)rows, r_end - row0) * n * (long long)sizeof(T);
        const unsigned char* g0 =
            reinterpret_cast<const unsigned char*>(D + row0 * n);
        const uintptr_t g = reinterpret_cast<uintptr_t>(g0);
        unsigned char* dst = ring + (size_t)s * stage_bytes + (g & 15);
        const uintptr_t a0 = (g + 15) & ~(uintptr_t)15;
        const uintptr_t a1 = (g + bytes) & ~(uintptr_t)15;
        uint32_t body = 0;
        if (a1 > a0) {
          body = (uint32_t)(a1 - a0);
          copy_plain<T>(dst, g0, (long long)(a0 - g));
          copy_plain<T>(dst + (a1 - g), g0 + (a1 - g),
                        (long long)(g + bytes - a1));
        } else {
          copy_plain<T>(dst, g0, bytes);
        }
        // the plain stores above are released by this arrival
        mbar_expect_tx(bar_full + 8 * s, body);
        if (body)
          bulk_load(smem_u32(dst + (a0 - g)),
                    reinterpret_cast<const void*>(a0), body,
                    bar_full + 8 * s);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: panel k goes to warp k % warps, a lane per row ----
    float* uw = wts + warp * 3 * kRing;
    int off[K];
#pragma unroll
    for (int k = 0; k < K; ++k) off[k] = min(k * 32 + lane, n - 1);
    for (int k = warp; k < npanels; k += warps) {
      const int s = k % stages;
      const long long row0 = r_begin + (long long)k * rows;
      const int cnt = (int)min((long long)rows, r_end - row0);
      const bool live = lane < cnt;
      const long long row = row0 + lane;
      float l = 0.f, yo = 0.f, a = 0.f;
      if (live) {
        l = lam[row];
        yo = y[row];
        a = aux != nullptr ? aux[row] : 0.f;
      }
      const uintptr_t g = reinterpret_cast<uintptr_t>(D + row0 * n);
      const T* P = reinterpret_cast<const T*>(ring + (size_t)s * stage_bytes +
                                              (g & 15));
      // Another warp consumed this stage's previous round. Waiting for its
      // release first means at most one fill of the stage is unseen, so the
      // parity below cannot alias an older round.
      if (k >= stages) mbar_wait(bar_empty + 8 * s, ((k / stages) - 1) & 1);
      mbar_wait(bar_full + 8 * s, (k / stages) & 1);

      float u0 = 0.f, u1 = 0.f, u2 = 0.f;
      if (live) {
        const float dx = row_dot(P + lane * n, xs, n, lane);
        const float yn = repro::prox_body<KIND>(dx + l, delta, a, 3, param);
        const float ln = l + dx - yn;
        y_out[row] = yn;
        lam_out[row] = ln;
        u0 = yn - ln;
        u1 = yn - yo;
        u2 = ln;
        stop_terms<KIND>(st, stc, yn, ln, l, a, param);
      }
      uw[lane] = u0;
      uw[kRing + lane] = u1;
      uw[2 * kRing + lane] = u2;
      __syncwarp();

      float p[3][K];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) p[j][kk] = 0.f;
      int rr = 0;
      for (; rr + 4 <= cnt; rr += 4) {
        const float4 w0 = *reinterpret_cast<const float4*>(uw + rr);
        const float4 w1 = *reinterpret_cast<const float4*>(uw + kRing + rr);
        const float4 w2 =
            *reinterpret_cast<const float4*>(uw + 2 * kRing + rr);
        const T* prow = P + rr * n;
        sweep_row<T, K>(p, off, prow, w0.x, w1.x, w2.x);
        sweep_row<T, K>(p, off, prow + n, w0.y, w1.y, w2.y);
        sweep_row<T, K>(p, off, prow + 2 * n, w0.z, w1.z, w2.z);
        sweep_row<T, K>(p, off, prow + 3 * n, w0.w, w1.w, w2.w);
      }
      for (; rr < cnt; ++rr)
        sweep_row<T, K>(p, off, P + rr * n, uw[rr], uw[kRing + rr],
                        uw[2 * kRing + rr]);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const float yv = p[j][kk] - comp[j][kk];
          const float t = acc[j][kk] + yv;
          comp[j][kk] = (t - acc[j][kk]) - yv;
          acc[j][kk] = t;
        }
      __syncwarp();   // every lane is done with the stage and the weights
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    // the weights' slot is free: it takes the warp's four sums
    warp_sum4(st);
    if (lane == 0)
      for (int j = 0; j < 4; ++j) uw[j] = st[j];
  }

  // every panel has been consumed, so no copy is in flight: the ring holds
  // the warps' accumulators (the launcher checks that they fit), summed in
  // warp order, as are the warps' four sums
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (warp < warps) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = k * 32 + lane;
        if (c < n) red[((size_t)warp * 3 + j) * n + c] = acc[j][k];
      }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * (3 * n + 4);
  for (int e = tid; e < 3 * n; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[(size_t)w * 3 * n + e];
    out[e] = s;
  }
  if (tid < 4) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += wts[w * 3 * kRing + tid];
    out[3 * n + tid] = s;
  }
}

// out[e] = sum over CTAs, in CTA order, of the (nctas, 3n + 4) partials;
// the last entry, obj, times the loss's outer scale.
__global__ void admm_reduce_kernel(const float* __restrict__ part, int n,
                                   int nctas, float scale,
                                   float* __restrict__ out) {
  const int len = 3 * n + 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.f;
  for (int b = 0; b < nctas; ++b) s += part[(size_t)b * len + e];
  out[e] = e == len - 1 ? scale * s : s;
}

int launch_reduce(const void* part, void* out, int n, int nctas, float scale,
                  cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  admm_reduce_kernel<<<(3 * n + 4 + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(part), n, nctas, scale,
      static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T, int KIND>
int launch_iter(const void* D, const void* x, const void* y, const void* lam,
                const void* aux, void* y_out, void* lam_out, void* part,
                void* out, long long m, int n, int R, long long rows_per_cta,
                int nctas, float delta, float param, float scale,
                cudaStream_t s) {
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
  return launch_reduce(part, out, n, nctas, scale, s);
}

template <typename T, int KIND, int K>
int launch_ring(const void* D, const void* x, const void* y, const void* lam,
                const void* aux, void* y_out, void* lam_out, void* part,
                void* out, long long m, int n, long long rows_per_cta,
                int rows, int nctas, int stages, int warps, float delta,
                float param, float scale, cudaStream_t s) {
  const int smem = ring_fixed_bytes(n, warps) +
                   stages * ring_stage_bytes(n, sizeof(T), rows);
  cudaError_t err = cudaFuncSetAttribute(
      admm_ring_kernel<T, KIND, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  admm_ring_kernel<T, KIND, K><<<nctas, (warps + 1) * 32, smem, s>>>(
      static_cast<const T*>(D), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(lam),
      static_cast<const float*>(aux), static_cast<float*>(y_out),
      static_cast<float*>(lam_out), static_cast<float*>(part), m, n,
      rows_per_cta, rows, stages, delta, param);
  return launch_reduce(part, out, n, nctas, scale, s);
}

// The smallest built column count per lane K >= ceil(n / 32), or 0.
int ring_k(int n) {
  constexpr int kBuilt[] = {2, 4, 8, 10, 16};
  const int need = (n + 31) / 32;
  for (int k : kBuilt)
    if (need <= k) return k;
  return 0;
}

template <typename T, int KIND>
int dispatch_ring(int K, const void* D, const void* x, const void* y,
                  const void* lam, const void* aux, void* y_out,
                  void* lam_out, void* part, void* out, long long m, int n,
                  long long rows_per_cta, int rows, int nctas, int stages,
                  int warps, float delta, float param, float scale,
                  cudaStream_t s) {
#define REPRO_RING(KK)                                                       \
  case KK:                                                                   \
    return launch_ring<T, KIND, KK>(D, x, y, lam, aux, y_out, lam_out, part, \
                                    out, m, n, rows_per_cta, rows, nctas,    \
                                    stages, warps, delta, param, scale, s);
  switch (K) {
    REPRO_RING(2)
    REPRO_RING(4)
    REPRO_RING(8)
    REPRO_RING(10)
    REPRO_RING(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RING
}

}  // namespace

// Wide route. dtype: 0 = float32 D, 1 = bfloat16 D (row-major (m, n)).
// x (n,), y, lam, aux (m,) float32; aux may be null. part holds
// nctas * (3n + 4) floats and out (3n + 4,) receives d, w, v, then r_sq,
// dx_sq, y_sq and obj (the summed loss value times scale). Rows
// [b * rows_per_cta, (b+1) * rows_per_cta) belong to CTA b, walked in
// panels of R <= 32 rows.
extern "C" int repro_admm_iter(const void* D, int dtype, const void* x,
                               const void* y, const void* lam,
                               const void* aux, void* y_out, void* lam_out,
                               void* part, void* out, long long m, int n,
                               int R, long long rows_per_cta, int nctas,
                               int kind, float delta, float param,
                               float scale, void* stream) {
  if (R < 1 || R > 32 || n <= 0 || nctas <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_DISPATCH_KIND(kind, return launch_iter<float, KIND>(
        D, x, y, lam, aux, y_out, lam_out, part, out, m, n, R, rows_per_cta,
        nctas, delta, param, scale, s));
  }
  if (dtype == 1) {
    REPRO_DISPATCH_KIND(kind, return launch_iter<__nv_bfloat16, KIND>(
        D, x, y, lam, aux, y_out, lam_out, part, out, m, n, R, rows_per_cta,
        nctas, delta, param, scale, s));
  }
  return cudaErrorInvalidValue;
}

// Ring route, the same arguments as repro_admm_iter but for the ring:
// stages of 1 <= rows <= 32 rows (rows_per_cta a multiple of it),
// 2 <= stages <= 16 stages, 1 <= warps <= 8 consumer warps (warps <
// stages), n <= 512. D's base must be aligned to its element size; any
// other alignment is handled.
extern "C" int repro_admm_iter_ring(const void* D, int dtype, const void* x,
                                    const void* y, const void* lam,
                                    const void* aux, void* y_out,
                                    void* lam_out, void* part, void* out,
                                    long long m, int n,
                                    long long rows_per_cta, int rows,
                                    int nctas, int stages, int warps,
                                    int kind,
                                    float delta, float param, float scale,
                                    void* stream) {
  const int K = ring_k(n);
  const int dsize = dtype == 0 ? 4 : 2;
  if (K == 0 || n <= 0 || nctas <= 0 || rows < 1 || rows > kRing ||
      rows_per_cta % rows != 0 || stages < 2 || stages > kMaxStages ||
      warps < 1 || warps > kMaxWarps || warps >= stages ||
      (dtype != 0 && dtype != 1) ||
      ring_fixed_bytes(n, warps) + stages * ring_stage_bytes(n, dsize, rows) >
          227 * 1024 ||
      stages * ring_stage_bytes(n, dsize, rows) < warps * 3 * n * 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    REPRO_DISPATCH_KIND(kind, return dispatch_ring<float, KIND>(
        K, D, x, y, lam, aux, y_out, lam_out, part, out, m, n, rows_per_cta,
        rows, nctas, stages, warps, delta, param, scale, s));
  }
  REPRO_DISPATCH_KIND(kind, return dispatch_ring<__nv_bfloat16, KIND>(
      K, D, x, y, lam, aux, y_out, lam_out, part, out, m, n, rows_per_cta,
      rows, nctas, stages, warps, delta, param, scale, s));
  return cudaErrorInvalidValue;
}
