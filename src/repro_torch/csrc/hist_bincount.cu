// The streaming telemetry histograms' update, binning included, in one launch.
//
// Replaces the TPU kernel repro/kernels/hist_bincount.py::hist_bincount_pallas
// (_bincount_kernel, pallas_call at hist_bincount.py:71), a weighted bincount
// of i32 indices, and takes in the binning and the add around it that the
// reference's record (repro/obs/hist.py:125) runs as separate operations:
//
//   values route:  out[b] = counts[b] + sum of w[i] over i with bin(x[i]) == b
//   index route:   out[b] = (counts[b] or 0) + sum of w[i] over i with x[i] == b
//
// for 0 <= b < num_bins. The index route is the TPU kernel's contract, as
// repro/kernels/ref.py::hist_bincount_ref computes it: an index outside
// [0, num_bins), negatives included, is dropped, never clamped into a
// neighbouring bin. The weights are bool (one byte, non-zero counts 1) or
// i32, read as they are; a zero weight counts nothing and its sample is not
// binned. The sums are i32 and wrap as the reference's do; integer addition
// is associative, so the result is bitwise independent of the order the
// atomics land in. counts is read, never written: out is a fresh buffer.
//
// bin(v) is bit for bit repro_torch/obs/hist.py::bin_index, the reference's
// f32 clip(ceil(log(max(v, lo) / lo) / ratio) - 1, 0, bins) with bins =
// num_bins - 1: NaN and v <= lo go to bin 0 (log(lo / lo) is exactly 0), a
// quotient v / lo that is +inf to bin `bins`; the log is xla_log_f32 there,
// XLA's f32 log on the CPU (the Cephes polynomial, every multiply-add fused)
// with each fused multiply-add an exact f64 product of two f32 values, an
// f64 sum and one rounding to f32. nvcc contracts a * b + c into a fused
// multiply-add by default (--fmad=true), so every f32 and f64 step here is
// an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __dmul_rn, __dadd_rn, __double2float_rn): nothing contracts,
// and the divisions are IEEE quotients.
//
// Bound at the main path's largest shape (the merge-latency batch, m = R *
// cap = 100 * 512 = 51,200, 65 bins, bool weights): values 204,800 B +
// weights 51,200 B + counts and out 520 B = 256,520 B, 0.077 us at 3.35
// TB/s; the binning is about 24 f64 and 15 f32 operations a weighted sample,
// 1.2 M f64 operations even with every sample weighted (0.036 us at 34
// TFLOP/s): bytes. A launch of this size is bound by its own latency.
//
// Design, against that latency:
//   - up to 64 Ki samples (the loop's sizes): one thread block cluster of up
//     to kMaxClusterBlocks blocks of kThreads threads (16 x 1,024 where the
//     card places it, else the portable 8), each thread loading all of its
//     samples and weights (kUnroll) in one wave before it bins any: one
//     memory round trip. The binning's f64 steps and f32 <-> f64
//     conversions (16 a clock an SM) make a log costly, so a warp bins its
//     weighted samples 32 at a time across its lanes (ballots and
//     shuffles), not each where it was loaded: a batch with 2 % of its
//     samples weighted takes one pass of the log a warp, not one for each
//     of its load slots where some lane holds one; a cluster of 16 spreads
//     an all-weighted batch over twice the SMs of 8.
//   - each block bins its share into a histogram in shared memory with
//     shared-memory atomics; then every block but block 0 adds its non-zero
//     bins into block 0's histogram over distributed shared memory, between
//     a split cluster barrier that orders block 0's zeroing before them
//     (arrived at before the binning, waited on after it: no stall) and one
//     that orders them before block 0 reads its histogram, adds counts
//     (loaded before any barrier) and writes out. No zeroed buffer, no
//     global atomic, no second launch.
//   - past 64 Ki samples: out is seeded from counts (or zeroed) by a copy
//     on the stream, and a grid-stride kernel adds each block's shared
//     histogram to it with one global atomic per non-zero bin.
// Not carried over from the TPU: the one-hot (block_m, num_bins)
// compare-and-sum per grid step and the padded copies of idx and w.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;          // threads of a cluster block
constexpr int kMaxClusterBlocks = 16;   // an H100 places clusters of 16 (non-portable)
constexpr int kPortableClusterBlocks = 8;
constexpr int kUnroll = 4;              // samples a thread loads before it bins them
constexpr long long kClusterMaxM =
    static_cast<long long>(kMaxClusterBlocks) * kThreads * kUnroll;   // 65,536
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAtomicThreads = 256;     // the grid-stride route's blocks
constexpr int kMaxAtomicBlocks = 264;   // two blocks per SM of an H100 at most
constexpr int kMaxBins = 12288;         // 48 KB of shared memory without an opt-in

// XLA's f32 log on the CPU: Cephes' constants, as f32 bits (the same as
// repro_torch/obs/hist.py's _SQRT_HALF, _P, _Q1, _Q2)
constexpr uint32_t kSqrtHalfBits = 0x3F3504F3u;
constexpr uint32_t kP0Bits = 0x3D9021BBu, kP1Bits = 0xBDEBD1B8u, kP2Bits = 0x3DEF251Au;
constexpr uint32_t kP3Bits = 0xBDFE5D4Fu, kP4Bits = 0x3E11E9BFu, kP5Bits = 0xBE2AAE50u;
constexpr uint32_t kP6Bits = 0x3E4CCEACu, kP7Bits = 0xBE7FFFFCu, kP8Bits = 0x3EAAAAAAu;
constexpr uint32_t kQ1Bits = 0xB95E8083u;
constexpr uint32_t kQ2Bits = 0x3F318000u;

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

__device__ __forceinline__ double f64(uint32_t bits) {
  return static_cast<double>(__uint_as_float(bits));
}

// obs/hist.py::_fma: the exact f64 product of two f32 values, an f64 sum,
// then one rounding to f32
__device__ __forceinline__ float fma64(double a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// obs/hist.py::xla_log_f32 for a finite x >= 1 (the only arguments binning
// gives it; its clamp to the least normal is then a no-op), step for step
__device__ __forceinline__ float xla_log_f32(float x) {
  const uint32_t bits = __float_as_uint(x);
  float e = __fadd_rn(static_cast<float>(static_cast<int>(bits >> 23) - 127), 1.0f);
  const float m = __uint_as_float((bits & ~0x7F800000u) | 0x3F000000u);   // in [0.5, 1)
  const bool small = m < f32(kSqrtHalfBits);
  const float x1 = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x1, x1);
  const double x1d = static_cast<double>(x1);
  const double x3d = static_cast<double>(__fmul_rn(x2, x1));
  const float y1 = fma64(fma64(x1d, f64(kP0Bits), f64(kP1Bits)), x1d, f64(kP2Bits));
  const float y2 = fma64(fma64(x1d, f64(kP3Bits), f64(kP4Bits)), x1d, f64(kP5Bits));
  const float y3 = fma64(fma64(x1d, f64(kP6Bits), f64(kP7Bits)), x1d, f64(kP8Bits));
  const float y = fma64(fma64(y1, x3d, y2), x3d, y3);
  const float s = fma64(y, x3d, __fmul_rn(e, f32(kQ1Bits)));
  const float r = __fsub_rn(x1, __fmul_rn(x2, 0.5f));
  return fma64(e, f64(kQ2Bits), __fadd_rn(r, s));
}

// obs/hist.py::bin_index of one value: in [0, bins]
__device__ __forceinline__ int bin_of(float v, float lo, float ratio, int bins) {
  if (!(v > lo)) return 0;               // NaN, and v <= lo: the quotient is 1, its log 0
  const float q = __fdiv_rn(v, lo);
  if (q == __uint_as_float(0x7F800000u)) return bins;   // +inf, or past the f32 range
  const float x = fminf(__fdiv_rn(xla_log_f32(q), ratio), static_cast<float>(bins + 1));
  const int c = static_cast<int>(ceilf(x)) - 1;
  return c < 0 ? 0 : (c > bins ? bins : c);
}

struct Binning {
  float lo;
  float ratio;
  int values;      // 1: x holds f32 values to bin; 0: x holds i32 bin indices
};

template <typename W>
__device__ __forceinline__ int32_t weight_of(W w) {
  return static_cast<int32_t>(w);
}

template <>
__device__ __forceinline__ int32_t weight_of<uint8_t>(uint8_t w) {
  return w != 0 ? 1 : 0;                 // torch.bool: one byte, counted as 1
}

// the bin of one sample, or -1 (dropped) where an index is out of range
__device__ __forceinline__ int sample_bin(uint32_t raw, const Binning& p, int num_bins) {
  if (p.values) return bin_of(__uint_as_float(raw), p.lo, p.ratio, num_bins - 1);
  // unsigned compare: a negative index wraps above num_bins and is dropped
  return static_cast<uint32_t>(raw) < static_cast<uint32_t>(num_bins) ? static_cast<int>(raw)
                                                                      : -1;
}

__device__ __forceinline__ void cluster_arrive() {   // release: prior writes are visible
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {     // acquire: the others' writes are seen
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Bin one pass of a warp's samples into the shared histogram: lane l takes
// samples base + l + u * stride, u < kUnroll, all loaded before any is
// binned. Values are binned by the warp's lanes 32 weighted samples at a
// time, whatever lanes hold them: the warp's weighted samples are numbered
// in (u, lane) order by ballots, and lane k fetches the k-th by shuffles,
// so a batch with 2 % of its samples weighted bins in one pass of the log,
// not in one for each slot u where some lane holds one. base is
// warp-uniform, so every lane takes part in the ballots and shuffles.
template <typename W>
__device__ __forceinline__ void bin_pass(const uint32_t* __restrict__ x, const W* __restrict__ w,
                                         long long m, long long base, long long stride,
                                         const Binning& p, int num_bins, int32_t* s_bins) {
  const int lane = threadIdx.x & 31;
  uint32_t xs[kUnroll];
  int32_t ws[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + lane + u * stride;
    const bool in = i < m;
    ws[u] = in ? weight_of<W>(w[i]) : 0;
    xs[u] = in ? x[i] : 0u;
  }
  if (!p.values) {                       // indices: nothing to compact
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = sample_bin(xs[u], p, num_bins);
      if (ws[u] != 0 && b >= 0) atomicAdd(&s_bins[b], ws[u]);
    }
    return;
  }
  unsigned mask[kUnroll];
  int start[kUnroll + 1];                // the weighted samples of slots before u
  start[0] = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    mask[u] = __ballot_sync(kFull, ws[u] != 0);
    start[u + 1] = start[u] + __popc(mask[u]);
  }
  if (start[kUnroll] == 32 * kUnroll) {  // every sample weighted: each lane bins its own
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) atomicAdd(&s_bins[sample_bin(xs[u], p, num_bins)], ws[u]);
    return;
  }
  for (int r = 0; r < start[kUnroll]; r += 32) {
    const int k = r + lane;              // this lane's weighted sample
    const bool live = k < start[kUnroll];
    int slot = 0;
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) slot += k >= start[u];
    unsigned held = 0;
    int before = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (slot == u && live) {
        held = mask[u];
        before = k - start[u];
      }
    }
    int src = before;                    // in a full slot the lane is the rank
    if (held != kFull) {
      for (; before > 0; --before) held &= held - 1;   // drop the lanes before it
      src = (__ffs(held) - 1) & 31;                  // its lane (any lane past the end)
    }
    uint32_t xk = 0;
    int32_t wk = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t xu = __shfl_sync(kFull, xs[u], src);
      const int32_t wu = __shfl_sync(kFull, ws[u], src);
      if (slot == u) {
        xk = xu;
        wk = wu;
      }
    }
    if (live) atomicAdd(&s_bins[sample_bin(xk, p, num_bins)], wk);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads) hist_cluster_kernel(
    const uint32_t* __restrict__ x, const W* __restrict__ w, long long m, Binning p,
    int num_bins, const int32_t* __restrict__ counts, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_bins[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned blocks = cluster.num_blocks();
  // block 0's first bin per thread: its counts load rides with the samples'
  const bool first = rank == 0 && threadIdx.x < num_bins;
  const uint32_t c0 = first && counts != nullptr ? static_cast<uint32_t>(counts[threadIdx.x])
                                                 : 0u;
  for (int b = threadIdx.x; b < num_bins; b += kThreads) s_bins[b] = 0;
  __syncthreads();
  cluster_arrive();                      // block 0's histogram, which the others add to, is zeroed
  const long long stride = static_cast<long long>(blocks) * kThreads;
  for (long long base = static_cast<long long>(rank) * kThreads + (threadIdx.x & ~31);
       base < m; base += stride * kUnroll) {
    bin_pass<W>(x, w, m, base, stride, p, num_bins, s_bins);
  }
  __syncthreads();                       // this block's histogram is final
  cluster_wait();
  if (rank != 0) {                       // add it into block 0's
    int32_t* dst = cluster.map_shared_rank(s_bins, 0);
    for (int b = threadIdx.x; b < num_bins; b += kThreads) {
      const int32_t c = s_bins[b];
      if (c != 0) atomicAdd(&dst[b], c);
    }
  }
  cluster_arrive();                      // every block's additions have landed
  cluster_wait();
  if (rank != 0) return;
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    // unsigned: the i32 sums wrap, as the reference's do
    const uint32_t c = b == static_cast<int>(threadIdx.x)
                           ? c0
                           : (counts != nullptr ? static_cast<uint32_t>(counts[b]) : 0u);
    out[b] = static_cast<int32_t>(c + static_cast<uint32_t>(s_bins[b]));
  }
}

template <typename W>
__global__ void __launch_bounds__(kAtomicThreads) hist_atomic_kernel(
    const uint32_t* __restrict__ x, const W* __restrict__ w, long long m, Binning p,
    int num_bins, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_bins[];
  for (int b = threadIdx.x; b < num_bins; b += kAtomicThreads) s_bins[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kAtomicThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kAtomicThreads + (threadIdx.x & ~31);
       base < m; base += stride * kUnroll) {
    bin_pass<W>(x, w, m, base, stride, p, num_bins, s_bins);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += kAtomicThreads) {
    const int32_t c = s_bins[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
}

// The most blocks a cluster takes on this device: kMaxClusterBlocks where
// the card can place such a cluster of kThreads-thread blocks
// (cudaOccupancyMaxActiveClusters, with the non-portable size allowed),
// else the portable kPortableClusterBlocks. Asked once per device.
int device_cluster_blocks(int device) {
  static int known[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return kPortableClusterBlocks;
  if (known[device] == 0) {
    int blocks = kPortableClusterBlocks;
    const cudaError_t allowed = cudaFuncSetAttribute(
        hist_cluster_kernel<uint8_t>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    const cudaError_t allowed_i32 = cudaFuncSetAttribute(
        hist_cluster_kernel<int32_t>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed == cudaSuccess && allowed_i32 == cudaSuccess) {
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(kMaxClusterBlocks, 1, 1);
      config.blockDim = dim3(kThreads, 1, 1);
      config.dynamicSmemBytes = static_cast<size_t>(kMaxBins) * sizeof(int32_t);
      cudaLaunchAttribute cluster;
      cluster.id = cudaLaunchAttributeClusterDimension;
      cluster.val.clusterDim.x = kMaxClusterBlocks;
      cluster.val.clusterDim.y = 1;
      cluster.val.clusterDim.z = 1;
      config.attrs = &cluster;
      config.numAttrs = 1;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, hist_cluster_kernel<uint8_t>, &config) ==
              cudaSuccess && clusters >= 1) {
        blocks = kMaxClusterBlocks;
      }
    }
    cudaGetLastError();                  // a refused query is an answer, not a fault
    known[device] = blocks;
  }
  return known[device];
}

int cluster_blocks(long long m, int device) {
  const long long blocks = (m + kThreads - 1) / kThreads;
  const int most = device_cluster_blocks(device);
  return static_cast<int>(blocks < 1 ? 1 : (blocks < most ? blocks : most));
}

template <typename W>
cudaError_t launch(const uint32_t* x, const W* w, long long m, Binning p, int num_bins,
                   const int32_t* counts, int32_t* out, int device, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(num_bins) * sizeof(int32_t);
  if (m <= kClusterMaxM) {
    const int blocks = cluster_blocks(m, device);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks, 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = blocks;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(&config, hist_cluster_kernel<W>, x, w, m, p, num_bins, counts,
                              out);
  }
  const cudaError_t seeded =
      counts != nullptr ? cudaMemcpyAsync(out, counts, smem, cudaMemcpyDeviceToDevice, stream)
                        : cudaMemsetAsync(out, 0, smem, stream);
  if (seeded != cudaSuccess) return seeded;
  const long long per_block = static_cast<long long>(kAtomicThreads) * kUnroll;
  long long blocks = (m + per_block - 1) / per_block;
  if (blocks > kMaxAtomicBlocks) blocks = kMaxAtomicBlocks;
  hist_atomic_kernel<W><<<static_cast<unsigned>(blocks), kAtomicThreads, smem, stream>>>(
      x, w, m, p, num_bins, out);
  return cudaSuccess;
}

}  // namespace

// The blocks of the cluster one launch over m samples runs on `device` (1
// to 16), or 0 where m takes the grid-stride route.
extern "C" int hist_bincount_cluster_blocks(long long m, int device) {
  if (m > kClusterMaxM) return 0;
  const cudaError_t set = cudaSetDevice(device);
  return set == cudaSuccess ? cluster_blocks(m, device) : -static_cast<int>(set);
}

// Pointers are device pointers, all contiguous: x (m,) of 4-byte samples,
// f32 values to bin when `values` is 1 (with lo > 0 and ratio, the f32
// constants of obs/hist.py::bin_index) or i32 bin indices when it is 0; w
// (m,) of weights, bool bytes when `w_bool` is 1, else i32; counts
// (num_bins,) i32 or null (zeros); out (num_bins,) i32, written whole. The
// stream is a cudaStream_t. Returns the cudaError_t of the launch (0 on
// success): a cluster the card cannot place is refused here. m == 0 still
// launches and writes counts (or zeros) to out.
extern "C" int hist_bincount(const void* x, int values, const void* w, int w_bool, long long m,
                             float lo, float ratio, int num_bins, const int* counts, int* out,
                             int device, void* stream) {
  if (m < 0 || num_bins < 1 || num_bins > kMaxBins || (values && !(lo > 0.0f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Binning p{lo, ratio, values ? 1 : 0};
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* c = reinterpret_cast<const int32_t*>(counts);
  auto* o = reinterpret_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w_bool ? launch<uint8_t>(xs, static_cast<const uint8_t*>(w), m, p, num_bins, c, o, device, st)
             : launch<int32_t>(xs, static_cast<const int32_t*>(w), m, p, num_bins, c, o, device,
                               st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hist_bincount_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
