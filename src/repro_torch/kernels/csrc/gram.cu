// K2: G = D^T D (K2a) and, optionally, C = D^T B in one read of D (K2b).
//
// Replaces repro/kernels/gram/gram.py::gram_pallas (`_gram_kernel`, K2a)
// and gram_rhs_pallas (`_gram_rhs_kernel`, K2b).
//
// Bound on the card: operations. m n^2 FMA-pairs (only tiles with i <= j)
// on the FP32 pipes against one read of D; at n = 307 that is ~150 FLOP
// per byte of f32 D, far above the card's FP32 ridge. TF32 tensor cores
// are not used: they miss the reference tolerances.
//
// The TPU ran the m-reduction innermost on one core, keeping each output
// tile resident. Here m is split across CTAs, and a second kernel sums the
// splits: CTA (tile, split) owns one 64x64 output tile with tile_i <=
// tile_j and a contiguous range of rows. No atomics: the result is bitwise
// repeatable for a given (m, n, splits).
//
// K2a, gram_tile_kernel (Gram only, the main path's setup):
//   * 128 threads per tile, each owning an 8x4 block of G: per staged row
//     three 16-byte shared loads feed 32 FFMA. Warp w owns the quadrant
//     (w / 2, w % 2); in a diagonal tile the strictly lower quadrant is the
//     upper one's mirror, so its warp only copies (a quarter of the FMAs of
//     the five diagonal tiles at n = 307 go; gram_reduce_kernel mirrors);
//   * 64-row panels of the tile's two column stripes go through a ring of
//     two shared-memory stages with one barrier a panel; the copy of panel
//     k+1 is in flight while panel k's FMAs run. An f32 row of n = 307 is
//     1,228 bytes, so no stripe of D is a TMA box (strides must be
//     multiples of 16 bytes) and a 16-byte copy of a stripe is aligned for
//     one row in four; 4-byte cp.async is aligned for every row and n. Each
//     thread copies one column of one stripe for 32 rows, one pointer
//     advanced by n per row; ragged rows and columns are zero-filled by the
//     copy itself (src-size 0). bf16 stripes are 2-byte aligned, which
//     cp.async cannot fetch: bf16 D is upcast by plain loads into the next
//     stage (off the main path, whose Gram is taken on f32 D). A TMA copy
//     of four-row groups (16n-byte stride) was tried: a box starts only at
//     a 16-byte boundary, so three row groups in four land shifted, and
//     the extra shared loads (or a pass that moves the rows) cost more than
//     the copy instructions they save (PERF.md, section 6);
//   * a per-panel partial first, then the running sum, so no chain adds
//     more than 64 products before it joins the total.
// K2b, the same kernel with B as a second source (Gram + right-hand sides,
// C = D^T B in the same read of D):
//   * r <= 16 (kRide): the RHS rides the diagonal tiles. A diagonal tile
//     stages one stripe of D, so the other half of each stage takes the
//     panel's rows of B (f32, 4-byte cp.async, aligned for every r), and
//     the warp that owns the mirrored quadrant, idle in K2a, forms the
//     tile's 64 x r block of C: two rows a lane, 2 RP accumulators (RP is
//     4 for r <= 4, else 16; a template argument), one float2 and
//     RP / 4 broadcast float4 loads per staged row. At r = 1 that warp
//     does 8 FMA a row to the other warps' 32, so the diagonal CTAs stay
//     lighter than the full ones and are not the tail;
//   * r > 16, and the later groups of a wide RHS (with_gram = 0): nt RHS
//     tiles per split, after the Gram tiles in the grid, each an ordinary
//     tile whose second stripe is B's 64 columns (zero past r). Their
//     work is that of the C block itself, so the diagonal tiles keep K2a's
//     balance at r = 64.
// gram_reduce_kernel: one thread per output element sums the partials over
// the splits in a fixed order and writes G[a][b] and, by mirroring the
// upper tiles (and the upper half of diagonal ones), the lower triangle;
// rhs_reduce_kernel likewise for C.
// The CTAs of one split are adjacent in launch order, so the stripes of a
// panel that several tiles read are served from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kPanel = 64;    // rows per staged panel
constexpr int kStages = 2;    // panels in the shared-memory ring
constexpr int kTM = 8, kTN = 4;  // outputs per thread (fixed: the
                                 // loads and the quadrant map assume it)
constexpr int kTileThreads = kTile * kTile / (kTM * kTN);
constexpr int kCopyRows = kPanel * kTile / kTileThreads;  // per thread
constexpr int kStageFloats = kPanel * 2 * kTile;  // [row][a | b]
constexpr int kRmax = kTile;  // RHS columns per launch (a tile's width)
constexpr int kRide = 16;     // K2b: widest RHS that rides the diagonal tiles

// Upper tile (ti, tj), ti <= tj, of the tile-th entry in row-major order
// of the upper triangle of an nt x nt tile grid.
__device__ __forceinline__ void upper_tile(int tile, int nt, int& ti,
                                           int& tj) {
  int rem = tile;
  ti = 0;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  tj = ti + rem;
}

__host__ __device__ __forceinline__ int upper_index(int ti, int tj, int nt) {
  return ti * nt - ti * (ti - 1) / 2 + (tj - ti);
}

// Rows [r0, r0 + kCopyRows) of one column of one stripe of a panel into
// shared memory: rows below `rows` from src, src + n, ...; the others, and
// every row when !col_ok, become 0.
__device__ __forceinline__ void copy_column(float* dst, const float* src,
                                            long long n, int r0, int rows,
                                            bool col_ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll 8
  for (int r = r0; r < r0 + kCopyRows; ++r) {
    const bool ok = col_ok && r < rows;
    // src-size 0 zero-fills without reading, so a masked source address is
    // never dereferenced
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     d + 4u * (2 * kTile) * r),
                 "l"(reinterpret_cast<uint64_t>(src)), "r"(ok ? 4 : 0)
                 : "memory");
    src += ok ? n : 0;
  }
}

__device__ __forceinline__ void copy_column(float* dst,
                                            const __nv_bfloat16* src,
                                            long long n, int r0, int rows,
                                            bool col_ok) {
#pragma unroll 8
  for (int r = r0; r < r0 + kCopyRows; ++r) {
    const bool ok = col_ok && r < rows;
    dst[r * (2 * kTile)] = ok ? __bfloat162float(*src) : 0.f;
    src += ok ? n : 0;
  }
}

// Blocks [0, gtiles) of a split are the upper Gram tiles (gtiles is 0 when
// only C is asked for); with own_rhs, blocks [gtiles, gtiles + nt) are the
// RHS tiles C_i = D_i^T B. RP > 0: the diagonal tiles also form their rows
// of C in the spare warp (r <= RP).
template <typename T, int RP>
__global__ void __launch_bounds__(kTileThreads)
gram_tile_kernel(const T* __restrict__ D, const float* __restrict__ B,
                 long long m, int n, int r, int nt, int gtiles,
                 long long rows_per_split, float* __restrict__ gpart,
                 float* __restrict__ cpart) {
  static_assert(2 * RP <= kTM * kTN, "a ride lane's C rows fit its acc");
  extern __shared__ __align__(16) float stage[];  // [kStages][kPanel][2 kTile]

  const int tile = blockIdx.x, split = blockIdx.y;
  const bool rhs_tile = tile >= gtiles;
  int ti, tj;
  if (rhs_tile) {
    ti = tile - gtiles;
    tj = 0;
  } else {
    upper_tile(tile, nt, ti, tj);
  }
  const bool diag = !rhs_tile && ti == tj;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(m, r_begin + rows_per_split);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warp w owns the 32x32 quadrant (w / 2, w % 2) of the tile, lane l the
  // 8x4 block at row 8 (l / 8), column 4 (l % 8) of it
  const int row_g = 32 * (warp / 2) + kTM * (lane / 8);
  const int col_g = 32 * (warp % 2) + kTN * (lane % 8);
  const bool skip = diag && warp == 2;  // the mirrored quadrant
  const bool ride = RP > 0 && skip;     // ... forms the tile's rows of C

  // the copy: this thread's column of each stripe, rows [r0, r0 +
  // kCopyRows) of the panel. Stripe a is D's tile ti; stripe b is D's tile
  // tj, or B (RHS tiles: its 64 columns; ride: its first RP), or nothing
  // (a diagonal tile without RHS)
  const int col = tid % kTile, r0 = tid / kTile * kCopyRows;
  const int ca = ti * kTile + col;
  const bool oka = ca < n;
  const bool from_b = rhs_tile || (diag && RP > 0);
  const bool copy_b = rhs_tile || !diag || (RP > 0 && col < RP);
  const int cb = from_b ? col : tj * kTile + col;
  const bool okb = from_b ? cb < r : (!diag && cb < n);
  const T* pa = D + (long long)r0 * n + (oka ? ca : 0);
  const T* pd = D + (long long)r0 * n + (okb && !from_b ? cb : 0);
  const float* pr = from_b ? B + (long long)r0 * r + (okb ? cb : 0) : nullptr;
  const int npanels = (int)((r_end - r_begin + kPanel - 1) / kPanel);

  auto issue = [&](int k) {
    if (k < npanels) {
      float* st = stage + (k % kStages) * kStageFloats + col;
      const long long row0 = r_begin + (long long)k * kPanel;
      const int rows = (int)min((long long)kPanel, r_end - row0);
      copy_column(st, pa + row0 * n, n, r0, rows, oka);
      if (copy_b) {
        if (from_b)
          copy_column(st + kTile, pr + row0 * r, r, r0, rows, okb);
        else
          copy_column(st + kTile, pd + row0 * n, n, r0, rows, okb);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // maybe empty
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < npanels; ++k) {
    // panel k has landed (at most kStages - 2 younger groups pending) and
    // every thread is done with panel k - 1, whose stage the next issue
    // refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    issue(k + kStages - 1);
    const float* st = stage + (k % kStages) * kStageFloats;
    float part[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) part[i][j] = 0.f;
    if (ride) {
      // rows 2 lane and 2 lane + 1 of the stripe against B's RP columns;
      // entry (i, q) accumulates in part[(i RP + q) / 4][(i RP + q) % 4]
      const float* A = st + 2 * lane;
      const float* Bq = st + kTile;
#pragma unroll 4
      for (int rr = 0; rr < kPanel; ++rr) {
        const float2 a = *reinterpret_cast<const float2*>(A + rr * 2 * kTile);
        float bv[RP > 0 ? RP : 1];
#pragma unroll
        for (int q = 0; q < RP; q += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(Bq + rr * 2 * kTile + q);
          bv[q] = x.x;
          bv[q + 1] = x.y;
          bv[q + 2] = x.z;
          bv[q + 3] = x.w;
        }
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          part[q / kTN][q % kTN] += a.x * bv[q];
          part[(RP + q) / kTN][(RP + q) % kTN] += a.y * bv[q];
        }
      }
    } else if (!skip) {
      const float* A = st + row_g;
      const float* Bs = st + (diag ? 0 : kTile) + col_g;
#pragma unroll 4
      for (int rr = 0; rr < kPanel; ++rr) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(A + rr * 2 * kTile);
        const float4 a1 =
            *reinterpret_cast<const float4*>(A + rr * 2 * kTile + 4);
        const float4 b =
            *reinterpret_cast<const float4*>(Bs + rr * 2 * kTile);
        const float av[kTM] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
        const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) part[i][j] += av[i] * bv[j];
      }
    } else {
      continue;
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += part[i][j];
  }

  if (ride || rhs_tile) cpart += ((size_t)split * nt + ti) * (kTile * kRmax);
  if (ride) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < RP; ++q)
        cpart[(2 * lane + i) * kRmax + q] =
            acc[(i * RP + q) / kTN][(i * RP + q) % kTN];
    return;
  }
  if (skip) return;
  float* out = rhs_tile
                   ? cpart
                   : gpart + ((size_t)split * gtiles + tile) * (kTile * kTile);
  out += row_g * kTile + col_g;  // kRmax == kTile: one tile layout
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    *reinterpret_cast<float4*>(out + i * kTile) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

__global__ void gram_reduce_kernel(const float* __restrict__ gpart, int n,
                                   int nt, int splits,
                                   float* __restrict__ G) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * n) return;
  const int a = (int)(e / n), b = (int)(e % n);
  int ti = a / kTile, tj = b / kTile, ia = a % kTile, ib = b % kTile;
  // a lower tile, or the lower half of a diagonal one: read the mirrored
  // upper element (K2a leaves the diagonal tiles' lower quadrant unset)
  if (ti > tj || (ti == tj && ia > ib)) {
    int t = ti; ti = tj; tj = t;
    t = ia; ia = ib; ib = t;
  }
  const int ntiles = nt * (nt + 1) / 2;
  const size_t off = (size_t)upper_index(ti, tj, nt) * (kTile * kTile) +
                     ia * kTile + ib;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s += gpart[(size_t)sp * ntiles * (kTile * kTile) + off];
  G[e] = s;
}

__global__ void rhs_reduce_kernel(const float* __restrict__ cpart, int n,
                                  int r, int nt, int splits, int c_ld,
                                  int c_off, float* __restrict__ C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * r) return;
  const int a = (int)(e / r), q = (int)(e % r);
  const size_t off =
      (size_t)(a / kTile) * (kTile * kRmax) + (a % kTile) * kRmax + q;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s += cpart[(size_t)sp * nt * (kTile * kRmax) + off];
  C[(size_t)a * c_ld + c_off + q] = s;
}

template <typename T, int RP>
cudaError_t launch_tile(const T* D, const float* B, long long m, int n, int r,
                        int nt, int gtiles, bool own_rhs,
                        long long rows_per_split, int splits, float* gpart,
                        float* cpart, cudaStream_t s) {
  const int smem = kStages * kStageFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gram_tile_kernel<T, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(gtiles + (own_rhs ? nt : 0), splits);
  gram_tile_kernel<T, RP><<<grid, kTileThreads, smem, s>>>(
      D, B, m, n, r, nt, gtiles, rows_per_split, gpart, cpart);
  return cudaGetLastError();
}

template <typename T>
int launch_gram(const void* Dv, const void* Bv, long long m, int n, int r,
                int with_gram, long long rows_per_split, int splits,
                void* gpart, void* cpart, void* G, void* C, int c_ld,
                int c_off, cudaStream_t s) {
  if (rows_per_split % kPanel != 0) return cudaErrorInvalidValue;
  const int nt = (n + kTile - 1) / kTile;
  const int gtiles = with_gram ? nt * (nt + 1) / 2 : 0;
  const T* D = static_cast<const T*>(Dv);
  const float* B = static_cast<const float*>(Bv);
  float* gp = static_cast<float*>(gpart);
  float* cp = static_cast<float*>(cpart);
  // a narrow RHS rides the diagonal tiles; a wide one, or C alone, has
  // tiles of its own
  const bool own = r > kRide || (r > 0 && !with_gram);
  cudaError_t err;
  if (r == 0 || own)
    err = launch_tile<T, 0>(D, B, m, n, r, nt, gtiles, own, rows_per_split,
                            splits, gp, cp, s);
  else if (r <= 4)
    err = launch_tile<T, 4>(D, B, m, n, r, nt, gtiles, false,
                            rows_per_split, splits, gp, cp, s);
  else
    err = launch_tile<T, kRide>(D, B, m, n, r, nt, gtiles, false,
                                rows_per_split, splits, gp, cp, s);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  if (with_gram) {
    const long long total = (long long)n * n;
    gram_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(gp, n, nt, splits, static_cast<float*>(G));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (r > 0) {
    const long long total = (long long)n * r;
    rhs_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, s>>>(cp, n, r, nt, splits, c_ld, c_off,
                                static_cast<float*>(C));
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 D, 1 = bfloat16 D. B is float32 (m, r) row-major with
// r <= 64; r = 0 computes the Gram alone (K2a). rows_per_split must be a
// multiple of 64. with_gram = 0 computes only C
// (the later column groups of a wide RHS). gpart holds
// splits * nt(nt+1)/2 * 64 * 64 floats, cpart splits * nt * 64 * 64
// floats. C is written at columns [c_off, c_off + r) of a row-major
// (n, c_ld) matrix.
extern "C" int repro_gram(const void* D, int dtype, const void* B,
                          long long m, int n, int r, int with_gram,
                          long long rows_per_split, int splits, void* gpart,
                          void* cpart, void* G, void* C, int c_ld, int c_off,
                          void* stream) {
  if (r < 0 || r > kRmax || n <= 0 || splits <= 0 || (r == 0 && !with_gram))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gram<float>(D, B, m, n, r, with_gram, rows_per_split,
                              splits, gpart, cpart, G, C, c_ld, c_off, s);
  if (dtype == 1)
    return launch_gram<__nv_bfloat16>(D, B, m, n, r, with_gram,
                                      rows_per_split, splits, gpart, cpart,
                                      G, C, c_ld, c_off, s);
  return cudaErrorInvalidValue;
}
