// K2: G = D^T D and, optionally, C = D^T B in one read of D.
//
// Replaces repro/kernels/gram/gram.py::gram_pallas (`_gram_kernel`, K2a)
// and gram_rhs_pallas (`_gram_rhs_kernel`, K2b).
//
// Bound on the card: operations. m n^2 FMA-pairs (only tiles with i <= j)
// on the FP32 pipes against one read of D; at n = 307 that is ~150 FLOP
// per byte of f32 D, far above the card's FP32 ridge. TF32 tensor cores
// are not used: they miss the reference tolerances.
//
// Design. The TPU ran the m-reduction innermost on one core, keeping each
// output tile resident. Here m is split across CTAs instead:
//   * pass 1: CTA (tile, split) owns one 64x64 output tile with
//     tile_i <= tile_j and a contiguous range of rows. It stages 32-row
//     panels of the two column stripes of D in shared memory (upcast to
//     f32 on the way in, ragged n and m masked to 0), and each of its 256
//     threads accumulates a 4x4 block in registers: a per-panel partial
//     first, then the running sum, so no single chain adds more than a
//     panel's worth of products. The diagonal CTAs (tile_i == tile_j) also
//     accumulate the tile's rows of C against a 32-row panel of B, so the
//     RHS rides the same read of D. Each CTA writes its partial tile.
//   * pass 2: one thread per output element sums the partials over the
//     splits in a fixed order and writes G[a][b] and, by mirroring the
//     upper tiles, the lower triangle; C likewise.
// No atomics: the result is bitwise repeatable for a given (m, n, splits).
// The CTAs of one split are adjacent in launch order, so the stripes of a
// panel that several tiles read are served from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kRows = 32;     // rows per staged panel
constexpr int kThreads = 256;
constexpr int kRmax = 64;     // RHS columns per launch

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Index of upper tile (ti, tj), ti <= tj, in row-major order of the upper
// triangle of an nt x nt tile grid.
__host__ __device__ __forceinline__ int upper_index(int ti, int tj, int nt) {
  return ti * nt - ti * (ti - 1) / 2 + (tj - ti);
}

// RHS is a compile-time switch, so the Gram-only kernel (K2a) carries
// none of the right-hand-side code and its registers.
template <typename T, bool RHS>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ D, const float* __restrict__ B,
                    long long m, int n, int r, int with_gram, int nt,
                    long long rows_per_split, float* __restrict__ gpart,
                    float* __restrict__ cpart) {
  __shared__ __align__(16) float As[kRows][kTile];
  __shared__ __align__(16) float Bs[kRows][kTile];
  __shared__ float Rs[kRows][kRmax];

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int ntiles = gridDim.x;
  int ti = 0, rem = tile;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const bool do_rhs = RHS && diag;
  if (!with_gram && !do_rhs) return;

  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(m, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // 4x4 block of G

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float cacc[kRmax / 4];
#pragma unroll
  for (int k = 0; k < kRmax / 4; ++k) cacc[k] = 0.f;

  const int col_a = ti * kTile, col_b = tj * kTile;
  for (long long row0 = r_begin; row0 < r_end; row0 += kRows) {
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile, c = e % kTile;
      const long long row = row0 + rr;
      const bool rok = row < r_end;
      As[rr][c] = (rok && col_a + c < n) ? to_f32(D[row * n + col_a + c]) : 0.f;
      if (!diag)
        Bs[rr][c] =
            (rok && col_b + c < n) ? to_f32(D[row * n + col_b + c]) : 0.f;
    }
    if (do_rhs) {
      for (int e = tid; e < kRows * r; e += kThreads) {  // columns q < r
        const int rr = e / r, q = e % r;
        const long long row = row0 + rr;
        Rs[rr][q] = row < r_end ? B[row * r + q] : 0.f;
      }
    }
    __syncthreads();
    if (with_gram) {
      const float(*Bp)[kTile] = diag ? As : Bs;
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 a = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bp[rr][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] += av[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    }
    if (do_rhs) {
      // the tile's 64 x r entries of C go round the 256 threads: entry
      // p = tid + 256 k is column p % 64, RHS p / 64; a warp whose entries
      // are all past 64 r skips the block (r = 1 keeps two warps busy)
#pragma unroll
      for (int k = 0; k < kRmax / 4; ++k) {
        const int p = tid + kThreads * k;
        if (p < kTile * r) {
          const int c = p % kTile, q = p / kTile;
          float part = 0.f;
          for (int rr = 0; rr < kRows; ++rr) part += As[rr][c] * Rs[rr][q];
          cacc[k] += part;
        }
      }
    }
    __syncthreads();
  }

  if (with_gram) {
    float* gp = gpart + ((size_t)split * ntiles + tile) * (kTile * kTile);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        gp[(ty * 4 + i) * kTile + tx * 4 + j] = acc[i][j];
  }
  if (do_rhs) {
    float* cp = cpart + ((size_t)split * nt + ti) * (kTile * kRmax);
#pragma unroll
    for (int k = 0; k < kRmax / 4; ++k) {
      const int p = tid + kThreads * k;
      if (p < kTile * r) cp[(p % kTile) * kRmax + p / kTile] = cacc[k];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ gpart, int n,
                                   int nt, int splits,
                                   float* __restrict__ G) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * n) return;
  const int a = (int)(e / n), b = (int)(e % n);
  int ti = a / kTile, tj = b / kTile, ia = a % kTile, ib = b % kTile;
  if (ti > tj) {  // lower tile: read the mirrored upper element
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

template <typename T>
int launch_gram(const void* D, const void* B, long long m, int n, int r,
                int with_gram, long long rows_per_split, int splits,
                void* gpart, void* cpart, void* G, void* C, int c_ld,
                int c_off, cudaStream_t s) {
  const int nt = (n + kTile - 1) / kTile;
  const int ntiles = nt * (nt + 1) / 2;
  dim3 grid(ntiles, splits);
  if (r > 0)
    gram_partial_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(D), static_cast<const float*>(B), m, n, r,
        with_gram, nt, rows_per_split, static_cast<float*>(gpart),
        static_cast<float*>(cpart));
  else
    gram_partial_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(D), nullptr, m, n, 0, 1, nt, rows_per_split,
        static_cast<float*>(gpart), nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  if (with_gram) {
    const long long total = (long long)n * n;
    gram_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(static_cast<const float*>(gpart), n, nt,
                                 splits, static_cast<float*>(G));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (r > 0) {
    const long long total = (long long)n * r;
    rhs_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, s>>>(static_cast<const float*>(cpart), n, r, nt,
                                splits, c_ld, c_off, static_cast<float*>(C));
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 D, 1 = bfloat16 D. B is float32 (m, r) row-major with
// r <= 64 (r = 0: Gram only). with_gram = 0 computes only C (the later
// column groups of a wide RHS). gpart holds splits * nt(nt+1)/2 * 64 * 64
// floats, cpart splits * nt * 64 * 64 floats. C is written at columns
// [c_off, c_off + r) of a row-major (n, c_ld) matrix.
extern "C" int repro_gram(const void* D, int dtype, const void* B,
                          long long m, int n, int r, int with_gram,
                          long long rows_per_split, int splits, void* gpart,
                          void* cpart, void* G, void* C, int c_ld, int c_off,
                          void* stream) {
  if (r < 0 || r > kRmax || n <= 0 || splits <= 0)
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
