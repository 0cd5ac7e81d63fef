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
// S and C (C up to 2^31 - 1, R up to 65535 * kMaxGroup).
//
// Bound at the main path's shape (R = 100 replicas, S = 512 slots, C = 4
// chunks, bool in and out): bytes are have 204,800 + digest 8,192 + sat
// 204,800 = 417,792 B, 0.125 us at 3.35 TB/s. At R = 1 (each gated read of
// one node's view) a launch moves 4 KB and its own cost is the whole time.
//
// Design: the digest classes themselves, O(R * S * C) work in one launch.
// Slots with equal digests form a class within a column; a receiver holds
// the class if it holds any of its slots. A block takes one column c and a
// group of up to kMaxGroup receivers, one bit each of a uint32 (the host
// sizes the group so the grid is about one wave of the card's SMs), and
// builds an open-addressing hash table in shared memory keyed by the
// digest's bits with -0.0 made +0.0. For every non-NaN value bit equality
// is then exactly f32 ==; a NaN slot is never inserted and never found.
//
// Pass 1 inserts every slot p: its thread loads digest[p, c] and the
// group's presence bits of (p, c) (all loads of a thread in flight at
// once), claims the key's entry (atomicCAS, linear probing from murmur3's
// finaliser) and ORs the bits into it (atomicOr). Pass 2: each slot s reads
// its key's bits, ORs its own presence, and writes sat for the group. OR
// commutes, so the result is bitwise whatever the order of the atomics.
// (A warp's lanes of one key are not met first by __match_any_sync and
// __reduce_or_sync to save atomics: on the card that cost more than the
// atomics it saved, even for one large class.)
//
// A table holds up to kTile slots at half load. A longer store goes in
// tiles: for each tile of output slots (kept in registers, kSlots a
// thread) the table is built from each tile of candidate slots in turn
// and every output slot ORs in what it finds. The gate (R = 1) is a block a
// column with O(S) work. Not carried over from the TPU: its 128-slot dense
// (bs, S, C) compare per grid step, and its NaN-padded copy of the digest
// table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 4;                     // output slots a thread keeps in registers
constexpr int kTile = kThreads * kSlots;      // slots a table holds
constexpr int kMaxGroup = 32;                 // receivers a block, one bit each
constexpr uint32_t kEmpty = 0xffffffffu;      // a NaN pattern: never a key

// the table key of one digest: its bits, -0.0 made +0.0; kEmpty for NaN
__device__ __forceinline__ uint32_t key_of(float d) {
  const uint32_t b = __float_as_uint(d);
  return d != d ? kEmpty : (d == 0.0f ? 0u : b);
}

__device__ __forceinline__ uint32_t slot_hash(uint32_t x) {  // murmur3's finaliser
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads) chunk_dedup_kernel(
    const uint8_t* __restrict__ have, const float* __restrict__ digest, int64_t R, int64_t S,
    int64_t C, int group, int table_bits, uint8_t* __restrict__ sat) {
  extern __shared__ uint32_t s_table[];
  const uint32_t size = 1u << table_bits;
  const uint32_t wrap = size - 1u;
  uint32_t* s_key = s_table;
  uint32_t* s_held = s_table + size;

  const int64_t c = blockIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * group;
  const int ng = static_cast<int>(R - i0 < group ? R - i0 : group);
  const int64_t rs = S * C;                    // one receiver's stride
  const uint8_t* hv = have + i0 * rs + c;

  // the group's presence of slot s, bit g for receiver i0 + g
  auto held = [&](int64_t s) {
    uint32_t bits = 0;
#pragma unroll 8
    for (int g = 0; g < ng; ++g) bits |= static_cast<uint32_t>(hv[g * rs + s * C] != 0) << g;
    return bits;
  };

  // the first table is cleared while the first loads are in flight
  for (uint32_t e = threadIdx.x; e < size; e += kThreads) {
    s_key[e] = kEmpty;
    s_held[e] = 0u;
  }
  for (int64_t o0 = 0; o0 < S; o0 += kTile) {
    uint32_t okey[kSlots], obits[kSlots], acc[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int64_t s = o0 + threadIdx.x + q * kThreads;
      okey[q] = s < S ? key_of(digest[s * C + c]) : kEmpty;
      obits[q] = s < S ? held(s) : 0u;
      acc[q] = 0u;
    }
    for (int64_t p0 = 0; p0 < S; p0 += kTile) {
      uint32_t ckey[kSlots], cbits[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int64_t s = p0 + threadIdx.x + q * kThreads;
        ckey[q] = p0 == o0 ? okey[q] : (s < S ? key_of(digest[s * C + c]) : kEmpty);
        cbits[q] = p0 == o0 ? obits[q] : (s < S ? held(s) : 0u);
      }
      if (p0 > 0 || o0 > 0) {  // the previous table is read, then cleared
        __syncthreads();
        for (uint32_t e = threadIdx.x; e < size; e += kThreads) {
          s_key[e] = kEmpty;
          s_held[e] = 0u;
        }
      }
      __syncthreads();
      // pass 1: every slot with a key claims its entry and ORs its bits in
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (ckey[q] == kEmpty) continue;
        uint32_t h = slot_hash(ckey[q]) & wrap;
        for (;;) {
          const uint32_t prev = atomicCAS(&s_key[h], kEmpty, ckey[q]);
          if (prev == kEmpty || prev == ckey[q]) break;
          h = (h + 1u) & wrap;
        }
        atomicOr(&s_held[h], cbits[q]);
      }
      __syncthreads();
      // pass 2: each output slot finds its key's bits
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (okey[q] == kEmpty) continue;
        for (uint32_t h = slot_hash(okey[q]) & wrap;; h = (h + 1u) & wrap) {
          const uint32_t k = s_key[h];
          if (k == okey[q]) {
            acc[q] |= s_held[h];
            break;
          }
          if (k == kEmpty) break;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int64_t s = o0 + threadIdx.x + q * kThreads;
      if (s >= S) continue;
      const uint32_t out = obits[q] | acc[q];
      uint8_t* dst = sat + i0 * rs + s * C + c;
      for (int g = 0; g < ng; ++g) dst[g * rs] = static_cast<uint8_t>((out >> g) & 1u);
    }
  }
}

int g_sms[64];                    // SMs per device, read once

}  // namespace

// Pointers are device pointers: have (R, S, C) of bytes (bool or uint8,
// non-zero = held), digest (S, C) f32, sat (R, S, C) bool written as 0/1, all
// contiguous. The stream is a cudaStream_t. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int chunk_dedup(const unsigned char* have, const float* digest, long long R,
                           long long S, long long C, unsigned char* sat, int device,
                           void* stream) {
  if (R < 1 || S < 1 || C < 1 || C > 0x7fffffffLL || device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (g_sms[device] == 0) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device] = sms;
  }
  // receivers a block: about one wave of blocks over the C columns, at most
  // kMaxGroup, and at most 65535 groups
  const long long per_column = C >= g_sms[device] ? 1 : g_sms[device] / C;
  long long group = (R + per_column - 1) / per_column;
  const long long least = (R + 65534) / 65535;
  group = group < least ? least : group;
  group = group > kMaxGroup ? kMaxGroup : group;
  const long long groups = (R + group - 1) / group;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // a table of at least twice the slots it holds, a power of two
  const long long slots = S < kTile ? S : kTile;
  int table_bits = 5;
  while ((1LL << table_bits) < 2 * slots) ++table_bits;
  const size_t smem = (size_t(2) << table_bits) * sizeof(uint32_t);
  const dim3 grid(static_cast<unsigned>(C), static_cast<unsigned>(groups));
  chunk_dedup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint8_t*>(have), digest, R, S, C, static_cast<int>(group),
      table_bits, reinterpret_cast<uint8_t*>(sat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chunk_dedup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
