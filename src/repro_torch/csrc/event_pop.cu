// The head of the continuous-time event queue: a masked lexicographic argmin.
//
// Replaces the TPU kernel repro/kernels/event_pop.py::event_pop_pallas
// (_pop_kernel, pallas_call at event_pop.py:97). Over the Q slots of the
// queue (time f32, kind i32, seq i32, valid bool), the head is the valid
// slot with the lexicographically smallest (time, kind, seq), the lowest
// index on a full tie, exactly as repro/kernels/ref.py::event_pop_ref picks
// it:
//
//   - times compare as f32 (no fast math): -0.0 ties +0.0, and then kind
//     and seq decide; +inf on a valid slot is an ordinary (largest) time.
//     The fold compares an orderable 32-bit key of the time: -0.0 is made
//     +0.0 first, then the sign flip that orders IEEE bits as unsigned
//     integers. A key of the raw bits would order -0.0 before +0.0.
//   - a NaN time on a valid slot makes the reference's min NaN, so no slot
//     ties it and its argmax of an all-false mask is 0: the head is slot 0
//     (found, as some slot is valid). NaN never becomes a key: it is a flag
//     carried beside the fold. (The Pallas kernel instead drops the block
//     that holds the NaN.)
//   - nothing valid: slot 0, not found.
//
// One launch writes four 32-bit words to `out`, the event loop's one read
// back per batch: idx, found (0/1), the head's time (its f32 bits: the
// winner's own time, -0.0 kept; NaN where a valid time is NaN; +inf when
// nothing is valid) and its kind (kind[0] for slot 0). Given a host
// mirror (pinned memory, mapped into the device's address space), the same
// 16 bytes also go straight to the host, so the loop reads them after one
// stream synchronisation, with no allocation and no device-to-host copy.
//
// Bound: latency. Each slot's 13 bytes read once and 16 bytes written: at
// the event engine's queues, Q = 9,900 delivery slots (the full 100-node
// overlay), 19,800 with the bank's drain slots and 9,965 for the in-system
// tip simulation, 129 KB to 257 KB, 0.04 to 0.08 us at 3.35 TB/s; the
// compares are far less. What a launch costs is its chain of dependent
// steps: the loads' memory round trips (the queue's static kind and seq
// columns are cold in the event loop, where the round between two pops
// moves megabytes), the fold's levels and the write-back.
//
// Design, each part against one link of that chain:
//   - a thread block cluster of up to kMaxBlocks blocks of kThreads threads
//     (8 x 1,024 at the loop's sizes), so each thread issues all of its
//     slots' loads (at most 3 at Q <= 24,576; kUnroll a pass, larger Q
//     loops) in one wave before it folds any of them: one memory round
//     trip, where one block needed three;
//   - the fold carries (key, kind, seq, idx, time bits, NaN flag), so
//     nothing is reloaded after it; kind[0] is loaded up front for the NaN
//     and nothing-valid answers;
//   - a warp folds by redux.sync: the min of the keys, then of the kinds
//     among the lanes that hold that key, then seqs, then indices, one
//     instruction each, and one shuffle for the winner's time bits;
//   - the blocks meet in distributed shared memory: each block's warp 0
//     stores its partial into block 0's shared memory, one cluster barrier
//     follows, and block 0 folds the partials. No global scratch, no
//     atomics, no second launch; as only block 0's shared memory is read
//     remotely and it is the last to leave, one barrier suffices. The order
//     is a strict total order on NaN-free keys (the index breaks every
//     tie), so the fold's order does not change the winner.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;    // the portable cluster size
constexpr int kUnroll = 4;       // slots a thread loads before it folds them
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmptyKey = 0xffffffffu;   // above every valid key (+inf is 0xff800000)
constexpr int kIntMax = 0x7fffffff;

static_assert(kWarps <= 32 && kMaxBlocks <= 32, "a fold gives each partial a lane of warp 0");

struct Head {
  unsigned key;    // orderable time key; kEmptyKey: nothing valid seen
  int kind;
  int seq;
  int idx;
  unsigned bits;   // the winner's own time bits (-0.0 kept)
  int nan;         // a valid slot with a NaN time was seen
};

__device__ __forceinline__ Head empty_head() {
  return Head{kEmptyKey, kIntMax, kIntMax, kIntMax, 0u, 0};
}

// f32 order as unsigned order, -0.0 equal to +0.0 (t is not NaN)
__device__ __forceinline__ unsigned time_key(float t) {
  const unsigned u = t == 0.0f ? 0u : __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Is (key, kind, seq) strictly before h's? Slots come in increasing index,
// so a full tie keeps the earlier one.
__device__ __forceinline__ bool before(unsigned key, int kind, int seq, const Head& h) {
  if (key != h.key) return key < h.key;
  if (kind != h.kind) return kind < h.kind;
  return seq < h.seq;
}

// The warp's lexicographic min, in every lane.
__device__ __forceinline__ Head warp_fold(const Head& h) {
  Head out;
  out.key = __reduce_min_sync(kFull, h.key);
  bool tie = h.key == out.key;
  out.kind = __reduce_min_sync(kFull, tie ? h.kind : kIntMax);
  tie = tie && h.kind == out.kind;
  out.seq = __reduce_min_sync(kFull, tie ? h.seq : kIntMax);
  tie = tie && h.seq == out.seq;
  out.idx = __reduce_min_sync(kFull, tie ? h.idx : kIntMax);
  tie = tie && h.idx == out.idx;
  out.bits = __shfl_sync(kFull, h.bits, __ffs(__ballot_sync(kFull, tie)) - 1);
  out.nan = static_cast<int>(__reduce_or_sync(kFull, static_cast<unsigned>(h.nan)));
  return out;
}

__global__ void __launch_bounds__(kThreads) event_pop_kernel(
    const float* __restrict__ time, const int32_t* __restrict__ kind,
    const int32_t* __restrict__ seq, const uint8_t* __restrict__ valid, long long Q,
    int32_t* __restrict__ out, int32_t* __restrict__ mirror) {
  __shared__ Head s_warp[kWarps];
  __shared__ Head s_block[kMaxBlocks];   // block 0's: every block's partial
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned blocks = cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool writer = rank == 0 && threadIdx.x == 0;
  const int32_t kind0 = writer ? kind[0] : 0;

  Head h = empty_head();
  const long long threads = static_cast<long long>(blocks) * kThreads;
  for (long long base = rank * kThreads + threadIdx.x; base < Q; base += threads * kUnroll) {
    float t[kUnroll];
    int32_t k[kUnroll], s[kUnroll];
    bool v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * threads;
      v[u] = i < Q && valid[i] != 0;
      t[u] = i < Q ? time[i] : 0.0f;
      k[u] = i < Q ? kind[i] : 0;
      s[u] = i < Q ? seq[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!v[u]) continue;
      if (t[u] != t[u]) {
        h.nan = 1;
        continue;
      }
      const unsigned key = time_key(t[u]);
      if (before(key, k[u], s[u], h)) {
        h = Head{key, k[u], s[u], static_cast<int>(base + u * threads), __float_as_uint(t[u]),
                 h.nan};
      }
    }
  }
  h = warp_fold(h);
  if (lane == 0) s_warp[warp] = h;
  __syncthreads();
  if (warp == 0) {
    h = warp_fold(lane < kWarps ? s_warp[lane] : empty_head());
    if (lane == 0) cluster.map_shared_rank(&s_block[0], 0)[rank] = h;
  }
  cluster.sync();
  if (rank != 0 || warp != 0) return;
  h = warp_fold(lane < static_cast<int>(blocks) ? s_block[lane] : empty_head());
  if (lane != 0) return;

  const bool found = h.key != kEmptyKey || h.nan;
  const bool won = h.key != kEmptyKey && !h.nan;
  int4 words;
  words.x = won ? h.idx : 0;
  words.y = found ? 1 : 0;
  // NaN as the reference's min; +inf when nothing is valid
  words.z = static_cast<int>(h.nan ? 0x7fc00000u : (won ? h.bits : 0x7f800000u));
  words.w = won ? h.kind : kind0;
  *reinterpret_cast<int4*>(out) = words;
  if (mirror != nullptr) *reinterpret_cast<int4*>(mirror) = words;
}

int cluster_blocks(long long Q) {
  const long long blocks = (Q + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// The blocks of the cluster one launch over Q slots runs (1 to 8).
extern "C" int event_pop_cluster_blocks(long long Q) { return cluster_blocks(Q); }

// The device address of a pinned host buffer (16-byte aligned, at least 16
// bytes) that event_pop may write its words to. Returns the cudaError_t.
extern "C" int event_pop_map_host(void* host, int device, void** device_ptr) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (reinterpret_cast<uintptr_t>(host) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaHostGetDevicePointer(device_ptr, host, 0));
}

// Pointers are device pointers, each contiguous: time (Q,) f32, kind and seq
// (Q,) i32, valid (Q,) of bytes (bool, non-zero = valid), out (4,) i32 and,
// unless null, mirror: a device address from event_pop_map_host. out and
// mirror are 16-byte aligned. The stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 on success): a cluster the card cannot place
// is refused here.
extern "C" int event_pop(const float* time, const int* kind, const int* seq,
                         const unsigned char* valid, long long Q, int* out, int* mirror,
                         int device, void* stream) {
  if (Q < 1 || Q > 0x7fffffffLL || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mirror) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = cluster_blocks(Q);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, event_pop_kernel, time, reinterpret_cast<const int32_t*>(kind),
      reinterpret_cast<const int32_t*>(seq), reinterpret_cast<const uint8_t*>(valid), Q,
      reinterpret_cast<int32_t*>(out), reinterpret_cast<int32_t*>(mirror));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* event_pop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
