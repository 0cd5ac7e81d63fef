// Weighted bincount of the streaming telemetry histograms.
//
// Replaces the TPU kernel repro/kernels/hist_bincount.py::hist_bincount_pallas
// (_bincount_kernel, pallas_call at hist_bincount.py:71). For i32 indices
// idx (m,) and i32 weights w (m,):
//
//   out[b] = sum of w[i] over every i with idx[i] == b,   0 <= b < num_bins
//
// exactly as repro/kernels/ref.py::hist_bincount_ref computes it: an index
// outside [0, num_bins), negatives included, is dropped, never clamped into
// a neighbouring bin. The sums are i32 and wrap as the reference's do.
// Integer addition is associative, so the result is bitwise independent of
// the order the atomics land in.
//
// Bound at the main path's largest shape (the merge-latency batch, m = R *
// cap = 100 * 512 = 51,200, 65 bins): bytes are idx 204,800 + w 204,800 +
// out 260 = 409,860 B, 0.122 us at 3.35 TB/s; 51,200 integer additions are
// nothing beside that. A launch of this size is bound by its own latency.
//
// Design: each block walks its share of the batch with a grid-stride loop
// and folds samples into a private histogram of num_bins i32 in shared
// memory with shared-memory atomics (zero weights, the masked samples that
// make up most of a round's batch, are skipped and cost no atomic); then one
// global atomicAdd per non-zero bin per block adds the block's counts to the
// output, which the caller zeroes. Not carried over from the TPU: the
// one-hot (block_m, num_bins) compare-and-sum per grid step and the padded
// copies of idx and w.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;   // samples a thread takes per block-sized pass
constexpr int kMaxBlocks = 264;      // two blocks per SM of an H100 at most
constexpr int kMaxBins = 12288;      // 48 KB of shared memory without an opt-in

__global__ void __launch_bounds__(kThreads) hist_bincount_kernel(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ w, long long m,
    int num_bins, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_bins[];
  for (int b = threadIdx.x; b < num_bins; b += kThreads) s_bins[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < m;
       i += stride) {
    const int32_t b = idx[i];
    const int32_t v = w[i];
    // unsigned compare: a negative index wraps above num_bins and is dropped
    if (v != 0 && static_cast<uint32_t>(b) < static_cast<uint32_t>(num_bins)) {
      atomicAdd(&s_bins[b], v);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    const int32_t c = s_bins[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
}

}  // namespace

// Pointers are device pointers: idx and w (m,) int32, out (num_bins,) int32,
// all contiguous; out must hold zeros (the kernel adds into it). The stream
// is a cudaStream_t. Returns the cudaError_t of the launch (0 on success);
// m == 0 launches nothing.
extern "C" int hist_bincount(const int* idx, const int* w, long long m, int num_bins, int* out,
                             int device, void* stream) {
  if (m < 0 || num_bins < 1 || num_bins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long per_block = static_cast<long long>(kThreads) * kItemsPerThread;
  long long blocks = (m + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hist_bincount_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         static_cast<size_t>(num_bins) * sizeof(int32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int32_t*>(idx), reinterpret_cast<const int32_t*>(w), m, num_bins,
      reinterpret_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hist_bincount_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
