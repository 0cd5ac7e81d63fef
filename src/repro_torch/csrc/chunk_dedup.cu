// Content-addressed chunk availability of the gossiped model bank.
//
// Replaces the TPU kernel repro/kernels/chunk_transfer.py::chunk_dedup_pallas
// (_dedup_kernel, pallas_call at chunk_transfer.py:84). For receiver i, store
// slot s and chunk column c:
//
//   sat[i, s, c] = have[i, s, c]
//                  || exists p: have[i, p, c] && digest[p, c] == digest[s, c]
//
// exactly as repro/kernels/ref.py::chunk_dedup_ref computes it: digests
// compare as f32 with == (no fast math), so a NaN digest matches nothing,
// not even itself, and -0.0 matches +0.0; physical presence ORs in. Any R,
// S and C (C up to 65535, R up to 65535 * kGroup).
//
// Bound at the main path's shape (R = 100 replicas, S = 512 slots, C = 4
// chunks, bool in and out): bytes are have 204,800 + digest 8,192 + sat
// 204,800 = 417,792 B, 0.125 us at 3.35 TB/s. Slots with equal digests form
// a class within each column, so the function needs only O(R * S * C) work;
// the dense form's R * S * S * C = 104,857,600 checks is not the bound. At
// R = 1 (each gated read of one node's view) a launch moves 4 KB and its
// own cost is the whole time.
//
// Design: dense, but one check serves kGroup receivers at once. A block
// takes kThreads slots s (one per thread) of one column c for a group of
// kGroup receivers. It stages, for the candidate slots p of the column, the
// digest and a bitmask of which of its receivers hold (p, c) in shared
// memory (kTile slots per pass, so any S fits), and each thread folds
//   acc |= (digest[p] == digest[s]) ? held_bits[p] : 0
// over every p: one shared-memory broadcast load pair, a compare and a
// select per candidate for all kGroup receivers. Bit g of acc, ORed with
// the receiver's own presence, is sat for receiver g. At the main shape
// the grid is 4 x 4 x 13 = 208 blocks, one wave, 512 candidates per
// thread. Not carried over from the TPU: its 128-slot dense (bs, S, C)
// compare per grid step, and its NaN-padded copy of the digest table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // slots per block, one per thread
constexpr int kGroup = 8;       // receivers per block, one bit each
constexpr int kTile = 2048;     // candidate slots staged per pass

__global__ void __launch_bounds__(kThreads) chunk_dedup_kernel(
    const uint8_t* __restrict__ have, const float* __restrict__ digest, int64_t R, int64_t S,
    int64_t C, uint8_t* __restrict__ sat) {
  __shared__ float s_dig[kTile];
  __shared__ uint32_t s_held[kTile];

  const int64_t c = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.z) * kGroup;
  const int group = static_cast<int>(R - i0 < kGroup ? R - i0 : kGroup);
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = s < S;
  const float ds = live ? digest[s * C + c] : __int_as_float(0x7fc00000);  // NaN: no match

  uint32_t acc = 0;
  for (int64_t p0 = 0; p0 < S; p0 += kTile) {
    const int n = static_cast<int>(S - p0 < kTile ? S - p0 : kTile);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int64_t p = p0 + k;
      uint32_t bits = 0;
      for (int g = 0; g < group; ++g) {
        bits |= static_cast<uint32_t>(have[((i0 + g) * S + p) * C + c] != 0) << g;
      }
      s_held[k] = bits;
      s_dig[k] = digest[p * C + c];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      acc |= s_dig[k] == ds ? s_held[k] : 0u;
    }
  }
  if (!live) return;
  for (int g = 0; g < group; ++g) {
    const int64_t idx = ((i0 + g) * S + s) * C + c;
    sat[idx] = static_cast<uint8_t>(have[idx] != 0 || ((acc >> g) & 1u) != 0);
  }
}

}  // namespace

// Pointers are device pointers: have (R, S, C) of bytes (bool or uint8,
// non-zero = held), digest (S, C) f32, sat (R, S, C) bool written as 0/1, all
// contiguous. The stream is a cudaStream_t. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int chunk_dedup(const unsigned char* have, const float* digest, long long R,
                           long long S, long long C, unsigned char* sat, int device,
                           void* stream) {
  if (R < 1 || S < 1 || C < 1 || C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long slot_blocks = (S + kThreads - 1) / kThreads;
  const long long groups = (R + kGroup - 1) / kGroup;
  if (slot_blocks > 0x7fffffffLL || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(slot_blocks), static_cast<unsigned>(C),
                  static_cast<unsigned>(groups));
  chunk_dedup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint8_t*>(have), digest, R, S, C,
      reinterpret_cast<uint8_t*>(sat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chunk_dedup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
