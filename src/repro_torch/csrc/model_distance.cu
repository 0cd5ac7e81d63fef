// Pairwise squared-L2 distances between k flattened models.
//
// Replaces the TPU kernel repro/kernels/model_distance.py::model_distance_pallas
// (_dist_kernel, pallas_call at model_distance.py:42). For x (k, N) f32:
//
//   d[i][j] = sq_i + sq_j - 2 * dot_ij,   dot_ij = sum_n x[i][n] * x[j][n],
//   sq_i = dot_ii,
//
// as repro/kernels/ref.py::model_distance_ref computes it. The caller is
// core/anomaly.py::parameter_outlier_scores, the model-space screen of the
// alpha candidate tips (k = 5 on the paper's CNN, N = 1,663,370).
//
// Bound: device-memory bytes. A launch must read x once, k * N * 4 bytes,
// and write k * k * 4: 33.3 MB and about 10 us at 3.35 TB/s for k = 5 at
// the CNN's width. The products are k (k + 1) / 2 * N fma, 25 M at k = 5,
// under 1 us at 67 TFLOP/s f32, so the kernel is bound by bytes up to
// k ~ 20 at that rate.
//
// Design. The TPU kernel walks its grid in order and accumulates the (k, k)
// block across 16K-column steps in one output block; Hopper's blocks run in
// parallel in no order, so the Gram matrix is taken in two steps:
//
// 1. gram_partial_kernel: the rows are cut into tiles of 8, and the Gram
//    matrix into tile pairs ti <= tj (one pair for k <= 8, three for
//    k <= 16, ten for k <= 32). A block takes one pair and one chunk of
//    about 2,048 columns. Each thread walks the chunk's columns with a
//    block-wide stride (coalesced 4-byte loads: the rows of a (k, N) tensor
//    are not 16-byte aligned at N = 1,663,370), four columns a step on a
//    diagonal pair and two off it, so 32 loads are in flight per thread, and
//    keeps the pair's dot products in registers (the upper triangle's 36 on
//    a diagonal pair, 64 off it). A tile's rows past k alias its last row:
//    every load and product is unconditional, so the loops unroll without a
//    branch; the aliased loads hit that row's cache lines, and their
//    products land in accumulators no one reads. The block then reduces:
//    a warp-shuffle tree, then the warps' partials in shared memory in warp
//    order, and writes one (8, 8) partial per (chunk, pair) to a workspace.
//    One launch per tile row: its diagonal pair, then its off-diagonal ones.
// 2. gram_finish_kernel: one block per output pair (i <= j). Its threads sum
//    the chunks' partials of dot_ij, dot_ii and dot_jj in a fixed strided
//    order and a fixed shared-memory tree, then form sq_i + sq_j - 2 dot_ij
//    in f32 and write d[i][j] and d[j][i]. No atomics: the result is the
//    same bits from run to run.
//
// Tile pairs off the diagonal re-read their rows, so k = 16 reads x twice
// over; wgmma and TMA are later work. k <= 32 is checked by the wrapper and
// here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;            // rows per tile
constexpr int kMaxK = 32;           // 4 row tiles, 10 tile pairs
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerBlock = 2048; // target columns per chunk (8 per thread)
constexpr int kMaxChunks = 1024;
constexpr int kFinishThreads = 256;

// the pair index p -> (ti, tj), ti <= tj, in row-major order of the upper triangle
__device__ __forceinline__ void tile_pair(int p, int tiles, int* ti, int* tj) {
  int a = 0;
  int rest = p;
  while (rest >= tiles - a) {
    rest -= tiles - a;
    ++a;
  }
  *ti = a;
  *tj = a + rest;
}

// One column's products into the tile pair's accumulators. Rows past the
// tile's end alias its last row (see gram_partial_kernel): every load and
// product is unconditional, so the loops unroll with no branch.
template <bool DIAG>
__device__ __forceinline__ void accumulate(const float* const* pi, const float* const* pj,
                                           long long c, float (&acc)[kTile][kTile]) {
  float vi[kTile], vj[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) vi[a] = __ldg(pi[a] + c);
  if constexpr (!DIAG) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) vj[a] = __ldg(pj[a] + c);
  }
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = DIAG ? a : 0; b < kTile; ++b) {
      acc[a][b] = fmaf(vi[a], DIAG ? vi[b] : vj[b], acc[a][b]);
    }
  }
}

// DIAG: the pair is a tile with itself (the upper triangle of its 8 x 8 is
// formed); UNROLL: columns a thread loads per step (loads in flight).
template <bool DIAG, int UNROLL>
__global__ void __launch_bounds__(kThreads) gram_partial_kernel(
    const float* __restrict__ x, long long ld, int k, long long n, long long cols_per_chunk,
    int tiles, int pair0, float* __restrict__ work) {
  int ti, tj;
  tile_pair(pair0 + blockIdx.y, tiles, &ti, &tj);
  const int ri = ti * kTile;
  const int rj = tj * kTile;
  // a tile's rows past k alias its last row: their loads hit the cache
  // lines of that row, and their products land in accumulators no one reads
  const float* pi[kTile];
  const float* pj[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    pi[a] = x + min(ri + a, k - 1) * ld;
    pj[a] = x + min(rj + a, k - 1) * ld;
  }

  float acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0.0f;

  const long long c0 = static_cast<long long>(blockIdx.x) * cols_per_chunk;
  const long long c1 = min(n, c0 + cols_per_chunk);
  long long col = c0 + threadIdx.x;
  for (; col + (UNROLL - 1) * kThreads < c1; col += UNROLL * kThreads) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) accumulate<DIAG>(pi, pj, col + u * kThreads, acc);
  }
  for (; col < c1; col += kThreads) accumulate<DIAG>(pi, pj, col, acc);

  // block reduction in a fixed order: a warp tree, then the warps in order
  __shared__ float s_part[kWarps][kTile * kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = DIAG ? a : 0; b < kTile; ++b) {
      float v = acc[a][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[warp][a * kTile + b] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kTile * kTile) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_part[w][threadIdx.x];
    const long long slot =
        (static_cast<long long>(pair0 + blockIdx.y) * gridDim.x + blockIdx.x) * (kTile * kTile);
    work[slot + threadIdx.x] = v;   // below-diagonal slots of a DIAG pair: never read
  }
}

// dot_ij summed over the chunks' partials, ri <= rj, by the block's threads
// in a fixed strided order, then a fixed shared-memory tree
__device__ float sum_partials(const float* __restrict__ work, int chunks, int tiles, int r_lo,
                              int r_hi, float* s_red) {
  const int ti = r_lo / kTile, tj = r_hi / kTile;
  const int p = ti * tiles - ti * (ti - 1) / 2 + (tj - ti);   // inverse of tile_pair
  const int e = (r_lo % kTile) * kTile + (r_hi % kTile);
  float v = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kFinishThreads) {
    v += work[(static_cast<long long>(p) * chunks + c) * (kTile * kTile) + e];
  }
  s_red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (static_cast<int>(threadIdx.x) < half) s_red[threadIdx.x] += s_red[threadIdx.x + half];
    __syncthreads();
  }
  const float out = s_red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kFinishThreads) gram_finish_kernel(
    const float* __restrict__ work, int k, int chunks, int tiles, float* __restrict__ out) {
  __shared__ float s_red[kFinishThreads];
  // blockIdx.x -> (i, j), i <= j, row-major over the upper triangle
  int i = 0;
  int rest = blockIdx.x;
  while (rest >= k - i) {
    rest -= k - i;
    ++i;
  }
  const int j = i + rest;
  const float dot = sum_partials(work, chunks, tiles, i, j, s_red);
  const float sq_i = sum_partials(work, chunks, tiles, i, i, s_red);
  const float sq_j = sum_partials(work, chunks, tiles, j, j, s_red);
  if (threadIdx.x == 0) {
    const float d = __fsub_rn(__fadd_rn(sq_i, sq_j), __fmul_rn(2.0f, dot));
    out[i * k + j] = d;
    out[j * k + i] = d;
  }
}

int chunk_count(long long n) {
  long long chunks = (n + kColsPerBlock - 1) / kColsPerBlock;
  if (chunks < 1) chunks = 1;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return static_cast<int>(chunks);
}

}  // namespace

// Floats of workspace a call with these sizes needs (the wrapper allocates it).
extern "C" long long model_distance_workspace(int k, long long n) {
  if (k < 1 || k > kMaxK || n < 1) return -1;
  const int tiles = (k + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  return static_cast<long long>(pairs) * chunk_count(n) * kTile * kTile;
}

// x: (k, n) f32 rows with row stride ld (elements), unit column stride; out:
// (k, k) f32, contiguous; work: model_distance_workspace(k, n) floats. Device
// pointers; stream is a cudaStream_t. Returns the cudaError_t of the launches
// (0 on success).
extern "C" int model_distance(const float* x, long long ld, int k, long long n, float* out,
                              float* work, int device, void* stream) {
  if (k < 1 || k > kMaxK || n < 1 || ld < n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (k + kTile - 1) / kTile;
  const int chunks = chunk_count(n);
  const long long per = (n + chunks - 1) / chunks;
  // the pairs row by row: (t, t) a DIAG launch, (t, t+1 ..) one off-diagonal launch
  int pair0 = 0;
  for (int t = 0; t < tiles; ++t) {
    gram_partial_kernel<true, 4><<<dim3(chunks, 1), kThreads, 0, s>>>(x, ld, k, n, per, tiles,
                                                                      pair0, work);
    const int off = tiles - t - 1;
    if (off > 0) {
      gram_partial_kernel<false, 2><<<dim3(chunks, off), kThreads, 0, s>>>(
          x, ld, k, n, per, tiles, pair0 + 1, work);
    }
    pair0 += tiles - t;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_finish_kernel<<<k * (k + 1) / 2, kFinishThreads, 0, s>>>(work, k, chunks, tiles, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* model_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
