// The head of the continuous-time event queue: a masked lexicographic argmin.
//
// Replaces the TPU kernel repro/kernels/event_pop.py::event_pop_pallas
// (_pop_kernel, pallas_call at event_pop.py:97). Over the Q slots of the
// queue (time f32, kind i32, seq i32, valid bool), the head is the valid
// slot with the lexicographically smallest (time, kind, seq), the lowest
// index on a full tie, exactly as repro/kernels/ref.py::event_pop_ref picks
// it:
//
//   - times compare as f32 with < and == (no fast math): -0.0 ties +0.0,
//     and then kind and seq decide; +inf on a valid slot is an ordinary
//     (largest) time. Never as bit patterns: an integer key made of the
//     time's bits would order -0.0 before +0.0.
//   - a NaN time on a valid slot makes the reference's min NaN, so no slot
//     ties it and its argmax of an all-false mask is 0: the head is slot 0
//     (found, as some slot is valid). The kernel does the same. (The Pallas
//     kernel instead drops the block that holds the NaN.)
//   - nothing valid: slot 0, not found.
//
// One launch writes four 32-bit words to `out`, the event loop's one read
// back per batch: idx, found (0/1), the head's time (its f32 bits: the
// winner's own time; NaN where a valid time is NaN; +inf when nothing is
// valid) and kind[idx].
//
// Bound: bytes. Each slot's 13 bytes read once and 16 bytes written: at the
// event engine's queues, Q = 9,900 delivery slots (the full 100-node
// overlay), 19,800 with the bank's drain slots and 9,965 for the in-system
// tip simulation, 129 KB to 257 KB, 0.04 to 0.08 us at 3.35 TB/s. The work
// is a handful of compares per slot, far less. A launch's own few
// microseconds are the real cost, and the loop pays one per batch.
//
// Design: one block of kThreads threads, enough for these sizes (a pass
// over several blocks is later work). Each thread folds a strided range of
// slots (neighbouring threads on neighbouring slots, so each load is
// coalesced) into a running (time, kind, seq, idx) best and a NaN flag; it
// loads kUnroll slots' four fields unconditionally before folding any of
// them, so one SM keeps many loads in flight (the queue's static kind and
// seq columns are usually cold in the event loop, where the round between
// two pops moves megabytes). The 32 lanes of a warp then fold by shuffles,
// the warps' results meet in shared memory, and warp 0 folds those. The
// order is a strict total order on NaN-free keys (the index breaks every
// tie), so the fold's order does not change the winner.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // slots a thread loads before it folds them

struct Head {
  float t;
  int kind;
  int seq;
  int idx;     // -1: nothing valid seen
  int nan;     // a valid slot with a NaN time was seen
};

// Is a strictly before b? An empty head comes after everything.
__device__ __forceinline__ bool before(const Head& a, const Head& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  if (a.t != b.t) return a.t < b.t;
  if (a.kind != b.kind) return a.kind < b.kind;
  if (a.seq != b.seq) return a.seq < b.seq;
  return a.idx < b.idx;
}

__device__ __forceinline__ Head fold(const Head& a, const Head& b) {
  Head out = before(b, a) ? b : a;
  out.nan = a.nan | b.nan;
  return out;
}

__device__ __forceinline__ Head shuffle_down(const Head& h, int offset) {
  Head o;
  o.t = __shfl_down_sync(0xffffffffu, h.t, offset);
  o.kind = __shfl_down_sync(0xffffffffu, h.kind, offset);
  o.seq = __shfl_down_sync(0xffffffffu, h.seq, offset);
  o.idx = __shfl_down_sync(0xffffffffu, h.idx, offset);
  o.nan = __shfl_down_sync(0xffffffffu, h.nan, offset);
  return o;
}

__device__ __forceinline__ Head warp_fold(Head h) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) h = fold(h, shuffle_down(h, offset));
  return h;
}

__global__ void __launch_bounds__(kThreads) event_pop_kernel(
    const float* __restrict__ time, const int32_t* __restrict__ kind,
    const int32_t* __restrict__ seq, const uint8_t* __restrict__ valid, int Q,
    int32_t* __restrict__ out) {
  __shared__ Head s_warp[kWarps];

  Head h{0.0f, 0, 0, -1, 0};
  for (int base = threadIdx.x; base < Q; base += kThreads * kUnroll) {
    float t[kUnroll];
    int32_t k[kUnroll], s[kUnroll];
    bool v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < Q && valid[i] != 0;
      t[u] = i < Q ? time[i] : 0.0f;
      k[u] = i < Q ? kind[i] : 0;
      s[u] = i < Q ? seq[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v[u]) h = fold(h, Head{t[u], k[u], s[u], base + u * kThreads, t[u] != t[u]});
    }
  }
  h = warp_fold(h);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = h;
  __syncthreads();
  if (warp != 0) return;
  h = lane < kWarps ? s_warp[lane] : Head{0.0f, 0, 0, -1, 0};
  h = warp_fold(h);
  if (lane != 0) return;

  const bool found = h.idx >= 0;
  const int idx = found && !h.nan ? h.idx : 0;
  float t = __int_as_float(0x7f800000);                 // +inf: nothing valid
  if (h.nan) t = __int_as_float(0x7fc00000);            // NaN, as the reference's min
  else if (found) t = h.t;
  out[0] = idx;
  out[1] = found ? 1 : 0;
  out[2] = __float_as_int(t);
  out[3] = kind[idx];
}

}  // namespace

// Pointers are device pointers, each contiguous: time (Q,) f32, kind and seq
// (Q,) i32, valid (Q,) of bytes (bool, non-zero = valid), out (4,) i32. The
// stream is a cudaStream_t. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int event_pop(const float* time, const int* kind, const int* seq,
                         const unsigned char* valid, long long Q, int* out, int device,
                         void* stream) {
  if (Q < 1 || Q > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  event_pop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      time, reinterpret_cast<const int32_t*>(kind), reinterpret_cast<const int32_t*>(seq),
      reinterpret_cast<const uint8_t*>(valid), static_cast<int>(Q),
      reinterpret_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* event_pop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
