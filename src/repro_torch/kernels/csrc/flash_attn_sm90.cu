// K4, tensor-core route: causal / GQA flash attention forward for bf16 q, k, v
// at head dims 64 and 128 on Hopper (sm_90a),
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
// with f32 running max, denominator and accumulator (an online softmax over
// kv tiles), causal masking q_pos >= k_pos on absolute indices (top-left
// aligned when Sq != Skv), masked scores at -1e30 and a final divide by
// max(l, 1e-30); o in bf16. q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D), any
// strides that are multiples of 8 elements with a unit stride along D.
// f32 inputs and head dim 16 take the FP32-FMA kernel in flash_attn.cu; the
// wrapper (kernels/flash_attn/ops.py::route) picks the kernel.
//
// Replaces repro/kernels/flash_attn/flash_attn.py::flash_attention_pallas
// (`_flash_kernel`).
//
// Bound on the card: operations. A causal call does 4 D per visible
// (q, k) pair: 275 GFLOP at the qwen3-8b shape (B 2, Hq 32, S 4096, D 128)
// against 201 MB of q, k, v and o, 0.278 ms at the bf16 tensor-core peak
// and 0.060 ms at the HBM rate. Only the tensor cores reach it.
//
// Design, for each (b, q head, 128-row q tile) CTA of 384 threads:
//   * warp specialisation: warpgroup 0 is the producer (one thread issues
//     every TMA load; `setmaxnreg` drops the group to 24 registers), and
//     warpgroups 1 and 2 are consumers of 64 q rows each (raised to 240);
//   * TMA: tensor maps over (D, S, H, B) are encoded on the host per call
//     from the tensors' own strides, so the model's (B, S, H, D)
//     projections are read in place. Q is loaded once; K and V tiles of
//     128 kv rows go through a ring of two stages guarded by full / empty
//     mbarriers. Each tile is stored as D / 64 blocks of 128 rows x 128
//     bytes with the 128-byte swizzle that wgmma reads. TMA zero-fills rows
//     past Sq / Skv; kv columns >= Skv are masked and rows >= Sq not
//     stored;
//   * S = Q K^T: wgmma m64n128k16 with Q and K both read from shared memory
//     (K-major descriptors), D / 16 k-steps, f32 accumulators;
//   * the online softmax works on the accumulator fragment in registers:
//     each thread holds two rows, the row max is reduced over the 4 lanes
//     of a row by shuffles, p = exp2f(s * scale log2 e - m) (IEEE exp2f,
//     no fast math), and the causal / ragged mask is applied only on tiles
//     that need it; kv tiles wholly above the diagonal are never loaded;
//   * O += P V: P is rounded to bf16 in registers (as FA2 and SDPA do) and
//     fed as wgmma's A operand from registers; V is the B operand read
//     from shared memory through an MN-major (transposed-B) descriptor, as
//     its rows are stored; the accumulator and the row sums l stay f32
//     (l sums the unrounded p);
//   * the epilogue divides by max(l, 1e-30) and writes bf16 pairs at o's
//     strides;
//   * causal q tiles are launched heaviest first.
// Every sum runs in a fixed order and nothing is atomic, so two identical
// calls are bitwise equal. Not yet done (ROADMAP): ping-pong scheduling of
// the two consumer warpgroups and overlap of softmax with the next GEMM
// inside a warpgroup.
#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;         // q rows per CTA and kv rows per tile
constexpr int kStages = 2;         // K / V ring depth
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBlockBytes = kRows * 128;  // 128 rows x 64 bf16 columns
constexpr float kNegInf = -1e30f;

// Shared-memory layout (byte offsets from a 1024-aligned base).
template <int D>
struct Smem {
  static constexpr int kTile = (D / 64) * kBlockBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

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

// Spins until the phase of the given parity has completed. A wait that
// outlasts 2^28 tries (seconds; a tile arrives in microseconds) traps, so a
// lost arrival fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of 64 D-columns x 128 rows of (D, S, H, B) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) = a (64 x 16) b^T (+ d if accumulate); a and b are
// descriptors of K-major tiles in shared memory (rows of Q and of K).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += a (64 x 16, bf16 pairs in registers) b; b is the
// descriptor of an MN-major tile in shared memory (rows of V: transposed B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;"
      "\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, bf16 pairs in registers) b; b is the
// descriptor of an MN-major tile in shared memory (rows of V: transposed B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;"
      "\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_rs_n128(acc, a, b);
  else
    wgmma_rs_n64(acc, a, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int group, int Sq,
                       int Skv, long long osb, long long osh, long long oss,
                       float scale_log2, int causal) {
  using L = Smem<D>;
  constexpr int kCB = D / 64;      // 64-column blocks of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_full = base + L::kBar;          // kStages barriers
  const uint32_t bar_empty = bar_full + 8 * kStages;  // kStages barriers
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = iq * kRows;
  const int q_end = min(q0 + kRows, Sq) - 1;
  // kv tiles with k_start <= q_end (causal), else all of them
  const int kv_end = causal ? min(Skv, q_end + 1) : Skv;
  const int n_kt = (kv_end + kRows - 1) / kRows;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int c = 0; c < kCB; ++c)
        tma_load(sQ + c * kBlockBytes, &tq, bar_q, 64 * c, q0, h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          tma_load(sK + s * L::kTile + c * kBlockBytes, &tk, full, 64 * c,
                   t * kRows, hk, b);
          tma_load(sV + s * L::kTile + c * kBlockBytes, &tv, full, 64 * c,
                   t * kRows, hk, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4 - 1;
    // this thread's rows of the q tile: r and r + 8 (the accumulator
    // fragment of wgmma), and its first column in each 8-column chunk
    const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int qp0 = q0 + r, qp1 = qp0 + 8;
    const int cq = 2 * (lane % 4);
    const int wg_first = q0 + wg * 64;    // the warpgroup's first q row

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = sQ + wg * 64 * 128;   // this warpgroup's Q rows
    mbar_wait(bar_q, 0);

    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      const int k0 = t * kRows;
      const uint32_t kb = sK + s * L::kTile, vb = sV + s * L::kTile;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

      // S = Q K^T (64 x 128 per warpgroup)
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(qa + off, 16, 1024),
                      desc_sw128(kb + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax on the fragment: sc[4j + e] is row r, column
      // k0 + 8j + cq + e; sc[4j + 2 + e] is row r + 8, the same column
      const bool edge = k0 + kRows > Skv ||
                        (causal && k0 + kRows - 1 > wg_first);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = sc[4 * j + e] * scale_log2;
          float v1 = sc[4 * j + 2 + e] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * j + cq + e;
            if (kp >= Skv || (causal && kp > qp0)) v0 = kNegInf;
            if (kp >= Skv || (causal && kp > qp1)) v1 = kNegInf;
          }
          sc[4 * j + e] = v0;
          sc[4 * j + 2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = exp2f(sc[4 * j + e] - mx0);
          sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mx1);
          ps0 += sc[4 * j + e];
          ps1 += sc[4 * j + 2 + e];
        }
      }
      l0 = c0 * l0 + ps0;    // this thread's share; the 4 lanes sum at the end
      l1 = c1 * l1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      // P in bf16, laid out as wgmma's A fragment: k-step kk covers kv
      // columns 16 kk .. 16 kk + 15, i.e. accumulator chunks 2 kk, 2 kk + 1
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: V rows are kv (K of this product), D is N (MN-major);
      // the next 64 D-columns are one block (128 rows x 128 bytes) on
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<D>(acc, pa[kk], desc_sw128(vb + kk * 16 * 128, kBlockBytes,
                                            1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + b * osb + h * osh;
    if (qp0 < Sq) {
      __nv_bfloat16* row = ob + (long long)qp0 * oss + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    }
    if (qp1 < Sq) {
      __nv_bfloat16* row = ob + (long long)qp1 * oss + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time, so the build
// needs no link to libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a bf16 (B, H, S, D) tensor as (D, S, H, B): boxes of 64
// D-columns x 128 rows, 128-byte swizzle, rows past S read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
                     int D, long long sb, long long sh, long long ss) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, kRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, B, Hq, Sq, D, st[0], st[1], st[2]);
  if (err == cudaSuccess)
    err = make_map(&mk, k, B, Hkv, Skv, D, st[3], st[4], st[5]);
  if (err == cudaSuccess)
    err = make_map(&mv, v, B, Hkv, Skv, D, st[6], st[7], st[8]);
  if (err != cudaSuccess) return err;
  const int smem = Smem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_attn_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_attn_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq / Hkv, Sq, Skv, st[9],
      st[10], st[11], scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// bf16 only, D 64 or 128. Strides in elements, (batch, head, seq) for each
// of q, k, v, o; each a multiple of 8 (16 bytes, TMA's rule), as are the
// addresses. Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attn_tc(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 || Skv <= 0)
    return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  for (long long s : st)
    if (s % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale, causal, s);
  if (D == 64)
    return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale, causal, s);
  return cudaErrorInvalidValue;
}
