// Wire codec of the gossiped model bank: blocked symmetric quantisation and
// per-block top-k of a delta, over a flat payload blocked leaf by leaf.
//
// Replaces two TPU kernels of repro/kernels/delta_codec.py:
//
//   quant_blocks_pallas (_quant_kernel, pallas_call at delta_codec.py:92):
//     per codec block, scale = amax > 0 ? amax / qmax : 1.0f and
//     codes = clip(rint(x / scale), -qmax, qmax) as int8;
//   topk_blocks_pallas (_topk_kernel, pallas_call at delta_codec.py:138):
//     keep d_i iff rank_i < k, where
//     rank_i = #{j : |d_j| > |d_i| or (|d_j| == |d_i| and j < i)}, else +0.0.
//
// Both equal repro/kernels/ref.py's quant_blocks_ref and topk_blocks_ref
// bitwise: true IEEE division (no --use_fast_math, so `/` is div.rn.f32),
// rintf (round half to even, as jnp.round and torch.round), f32 compares.
// A NaN |d_j| ranks ahead of nothing and a NaN d_i has rank 0 (kept); -0.0
// ties +0.0 and is kept as -0.0; an all-zero block gets scale exactly 1.0.
// The amax propagates NaN as jnp.max does, so such a block's scale is 1.0.
//
// Blocking. The reference blocks each leaf of the model on its own, in
// sorted-name order, each zero-padded to whole blocks (at least one). The
// kernels read the flat payload in place through a table of 2 * (L + 1)
// int64: the first codec block of each leaf (then the total NB) and the
// first flat value of each leaf (then P). Codec block b finds its leaf by a
// binary search over the first row; the padding zeros are implicit. One
// launch covers every leaf. Leaf offsets are not 16-byte aligned (the CNN's
// `bout` starts at value 608, `conv1` at 618), so loads are scalar and
// coalesced.
//
// Bound at the main path's shape (the paper's CNN: P = 1,663,370 values in
// 8 leaves, NB = 12,998 blocks of 128): quantisation reads 6.65 MB and
// writes 1.66 MB of codes and 52 KB of scales, 8.37 MB or 2.5 us at 3.35
// TB/s, against about 10 M f32 operations (0.15 us): bytes. Top-k reads the
// payload and the base (13.3 MB) and writes the masked delta (6.66 MB), 20
// MB or 6.0 us, against 12,998 * 128 * 128 = 213 M rank compares (3.2 us
// at 67 TFLOP/s): bytes.
//
// Design. Quantisation: one warp per codec block; lanes stride the block
// (lane l takes values l, l + 32, ...) so each load and each byte store of
// the warp is one contiguous run; the amax is a warp shuffle reduction.
// Top-k: one thread block per codec block, one thread per value; the block
// stages its |d| in shared memory and each thread counts its rank in one
// loop over the block (a dense rank, not a sort: ties go to the earlier
// index by construction). The delta's subtraction (payload - base) is fused
// into the load. Not carried over from the TPU: its padded (nb, 128) copy
// of every leaf, its int32 codes cast to int8 outside, and its (8, 128,
// 128) compare tensor per grid step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // codec blocks per thread block in quantisation

struct Span {
  int64_t start;  // first flat value of the codec block
  int count;      // values present (the rest of the block is zero padding)
};

__device__ __forceinline__ Span block_span(const int64_t* __restrict__ table, int leaves,
                                           int64_t b, int block) {
  const int64_t* first_block = table;
  const int64_t* first_value = table + leaves + 1;
  int lo = 0, hi = leaves;  // first_block[lo] <= b < first_block[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first_block[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int64_t start = first_value[lo] + (b - first_block[lo]) * block;
  const int64_t left = first_value[lo + 1] - start;
  return {start, static_cast<int>(left < 0 ? 0 : (left < block ? left : block))};
}

// the larger of a and b, NaN if either is NaN (jnp.max, torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__global__ void __launch_bounds__(kWarps * 32) quant_blocks_kernel(
    const float* __restrict__ x, const int64_t* __restrict__ table, int leaves, int64_t nb,
    int block, float qmax, int8_t* __restrict__ codes, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (b >= nb) return;  // whole warps leave together
  const Span span = block_span(table, leaves, b, block);
  const float* src = x + span.start;

  float amax = 0.0f;
  for (int i = lane; i < span.count; i += 32) amax = nan_max(amax, fabsf(src[i]));
  for (int offset = 16; offset > 0; offset >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, offset));
  }
  const float scale = amax > 0.0f ? amax / qmax : 1.0f;

  int8_t* out = codes + b * block;
  for (int i = lane; i < block; i += 32) {
    const float v = i < span.count ? src[i] : 0.0f;
    const float q = fminf(fmaxf(rintf(v / scale), -qmax), qmax);
    out[i] = static_cast<int8_t>(static_cast<int>(q));
  }
  if (lane == 0) scales[b] = scale;
}

__global__ void topk_blocks_kernel(const float* __restrict__ x,
                                   const float* __restrict__ base,
                                   const int64_t* __restrict__ table, int leaves, int block,
                                   int k, float* __restrict__ out) {
  extern __shared__ float s_abs[];
  const int64_t b = blockIdx.x;
  const Span span = block_span(table, leaves, b, block);
  const int i = threadIdx.x;
  float d = 0.0f;
  if (i < span.count) {
    d = base != nullptr ? x[span.start + i] - base[span.start + i] : x[span.start + i];
  }
  if (i < block) s_abs[i] = fabsf(d);
  __syncthreads();
  if (i >= block) return;
  const float a = s_abs[i];
  int rank = 0;
#pragma unroll 16
  for (int j = 0; j < block; ++j) {
    const float aj = s_abs[j];
    rank += (aj > a) | ((aj == a) & (j < i));
  }
  out[b * block + i] = rank < k ? d : 0.0f;
}

cudaError_t check_args(int leaves, long long nb, int block) {
  if (leaves < 1 || nb < 1 || nb > 0x7fffffffLL || block < 1 || block > 1024) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// Pointers are device pointers, all contiguous: x the flat payload (P,) f32,
// table (2, leaves + 1) int64 as above, codes (nb, block) int8, scales (nb,)
// f32. qmax is 127 (int8) or 7 (int4). The stream is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int quant_blocks(const float* x, const long long* table, int leaves, long long nb,
                            int block, int qmax, signed char* codes, float* scales, int device,
                            void* stream) {
  cudaError_t err = check_args(leaves, nb, block);
  if (err != cudaSuccess || qmax < 1 || qmax > 127) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (nb + kWarps - 1) / kWarps;
  quant_blocks_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const int64_t*>(table), leaves, nb, block, static_cast<float>(qmax),
      reinterpret_cast<int8_t*>(codes), scales);
  return static_cast<int>(cudaGetLastError());
}

// x the flat payload (P,) f32, base the flat base (P,) f32 or null (then the
// kernel ranks x itself), table as for quant_blocks, out (nb, block) f32:
// the masked delta, padding included. k is the number kept per block.
extern "C" int topk_blocks(const float* x, const float* base, const long long* table,
                           int leaves, long long nb, int block, int k, float* out, int device,
                           void* stream) {
  cudaError_t err = check_args(leaves, nb, block);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (block + 31) / 32 * 32;
  topk_blocks_kernel<<<static_cast<unsigned>(nb), threads, block * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      x, base, reinterpret_cast<const int64_t*>(table), leaves, block, k, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* delta_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
