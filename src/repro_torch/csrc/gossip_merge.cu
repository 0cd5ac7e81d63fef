// Per-(receiver, ledger row) gossip-merge winner selection.
//
// Replaces the TPU kernel repro/kernels/gossip_merge.py::gossip_winner_pallas
// (_winner_kernel, pallas_call at gossip_merge.py:122). For receiver i of a
// block of Rr receivers (global index gid = i + row_offset) and ledger row r,
// over the senders j that mask[i, j] admits (j == gid always admitted) and
// that hold the row (publisher[j, r] >= 0):
//
//   src[i, r] = the lowest j holding the lexicographically largest
//               (publish_time, publisher) key, or gid when gid holds that
//               key or when no candidate holds the row;
//   ac[i, r]  = the max over all R senders of (approval_count if j holds
//               the winning key, else 0): the winners' max, floored at 0
//               unless every sender is a winner; 0 when nothing wins.
//
// Keys compare as f32 (> and ==, no fast math) then i32, exactly as
// repro/kernels/ref.py::gossip_winner_ref does. A NaN time among the
// candidates makes the reference's max NaN, so nothing wins: src = gid,
// ac = 0, and the kernel does the same.
//
// Bound at the main path's shape (R = Rr = 100 replicas, cap = 512 rows):
// unique bytes are the three (R, cap) key/counter columns, 614,400 B, the
// (Rr, R) mask, 10,000 B, and the two (Rr, cap) outputs, 409,600 B: 1.03 MB,
// 0.31 us at 3.35 TB/s. The work is one candidate check per admitted
// (i, j, r): 5.12 M with every edge live (a round on the full overlay), of
// 6 compare/select operations each (occupancy, time >, time ==, publisher >,
// publisher ==, counter max), 0.46 us at 67 T op/s. Either way far below a
// launch's own few microseconds.
//
// Design: one launch, no scratch in device memory, no second pass. What
// limits it is not that bound but the sender walk: every receiver re-reads
// every sender's three columns, Rr * R * cap * 12 B = 61 MB of L2 traffic
// at the main shape, and a first version that walked all senders in one
// thread with branch-guarded loads was bound by their latency (PERF.md).
// Tiling several receivers per block, so a sender's row is loaded once for
// all of them, is the next step.
//
// A block takes 32 ledger rows (one per lane, so every sender's t[j, r],
// p[j, r] and ac[j, r] load as one coalesced 128-byte line; the columns,
// 600 KB, stay in the 50 MB L2 across the receivers that re-read them) and
// splits the senders over its 8 warps (sender slices, j = slice, slice + 8,
// ...); receivers go along blockIdx.y. The receiver's mask row is staged in
// shared memory, in chunks of kMaskChunk senders, with the receiver's own
// entry forced on (the TPU wrapper patched a copy of the mask instead; here
// nothing is copied). Each thread loads every sender of its slice
// unconditionally and folds it with selects, no branches, so an unrolled
// step keeps several loads in flight: a running key, the first index that
// reached it, the counter max and the number of winners; a strictly
// greater key resets them, an equal key raises the counter and the count.
// The 8 partial results meet in shared memory, and warp 0 combines them
// (greater key wins; on an equal key the lower first index, the larger
// counter, the summed count), then runs the self check against the
// receiver's own (t, p). Rows past cap (a ragged last block) load a clamped
// row and write nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                 // ledger rows per block, one per lane
constexpr int kSlices = 8;                // warps, each a slice of the senders
constexpr int kThreads = kRows * kSlices;
constexpr int kMaskChunk = 4096;

struct Winner {
  bool have = false;     // some admitted candidate holds the row
  bool nan = false;      // an admitted candidate's time is NaN
  float t = 0.0f;        // the running key (t, p)
  int32_t p = 0;
  int32_t first = 0;     // lowest sender index holding the key
  int32_t ac = 0;        // max approval_count over those senders
  int32_t n_win = 0;     // how many senders hold the key

  // fold one candidate (or another partial: n senders from index first)
  __device__ __forceinline__ void add(bool ok, float t2, int32_t p2, int32_t first2, int32_t ac2,
                                      int32_t n2) {
    const bool greater = ok && (!have || t2 > t || (t2 == t && p2 > p));
    const bool equal = ok && !greater && t2 == t && p2 == p;
    first = greater ? first2 : (equal && first2 < first ? first2 : first);
    ac = greater ? ac2 : (equal && ac2 > ac ? ac2 : ac);
    n_win = greater ? n2 : (equal ? n_win + n2 : n_win);
    t = greater ? t2 : t;
    p = greater ? p2 : p;
    have = have || ok;
  }
};

__global__ void __launch_bounds__(kThreads) gossip_winner_kernel(
    const float* __restrict__ t, const int32_t* __restrict__ p, const int32_t* __restrict__ ac,
    int64_t R, int64_t cap, const uint8_t* __restrict__ mask, int64_t row_offset,
    int32_t* __restrict__ src, int32_t* __restrict__ ac_out) {
  __shared__ uint8_t s_mask[kMaskChunk];
  __shared__ float s_t[kSlices][kRows];
  __shared__ int32_t s_p[kSlices][kRows];
  __shared__ int32_t s_first[kSlices][kRows];
  __shared__ int32_t s_ac[kSlices][kRows];
  __shared__ int32_t s_n[kSlices][kRows];
  __shared__ uint8_t s_flags[kSlices][kRows];

  const int lane = threadIdx.x % kRows;
  const int slice = threadIdx.x / kRows;
  const int64_t i = blockIdx.y;
  const int64_t gid = i + row_offset;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRows + lane;
  const bool live = r < cap;
  const int64_t rc = live ? r : cap - 1;  // in bounds for the unconditional loads
  const uint8_t* mrow = mask + i * R;

  Winner w;
  for (int64_t c0 = 0; c0 < R; c0 += kMaskChunk) {
    const int n = static_cast<int>(R - c0 < kMaskChunk ? R - c0 : kMaskChunk);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = threadIdx.x; k < n; k += kThreads) {
      s_mask[k] = static_cast<uint8_t>(mrow[c0 + k] != 0 || c0 + k == gid);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = slice; k < n; k += kSlices) {
      const int64_t off = (c0 + k) * cap + rc;
      const int32_t pj = __ldg(p + off);
      const float tj = __ldg(t + off);
      const int32_t aj = __ldg(ac + off);
      const bool cand = s_mask[k] != 0 && pj >= 0;
      const bool is_nan = cand && tj != tj;
      w.nan = w.nan || is_nan;
      w.add(cand && !is_nan, tj, pj, static_cast<int32_t>(c0 + k), aj, 1);
    }
  }

  s_t[slice][lane] = w.t;
  s_p[slice][lane] = w.p;
  s_first[slice][lane] = w.first;
  s_ac[slice][lane] = w.ac;
  s_n[slice][lane] = w.n_win;
  s_flags[slice][lane] = static_cast<uint8_t>(w.have) | static_cast<uint8_t>(w.nan) << 1;
  __syncthreads();
  if (slice != 0 || !live) return;
  for (int s = 1; s < kSlices; ++s) {
    const uint8_t f = s_flags[s][lane];
    w.nan = w.nan || (f & 2) != 0;
    w.add((f & 1) != 0, s_t[s][lane], s_p[s][lane], s_first[s][lane], s_ac[s][lane],
          s_n[s][lane]);
  }

  int32_t out_src = static_cast<int32_t>(gid);
  int32_t out_ac = 0;
  if (w.have && !w.nan) {
    const int64_t own = gid * cap + r;
    const int32_t own_p = p[own];
    const bool self_win = own_p >= 0 && t[own] == w.t && own_p == w.p;
    out_src = self_win ? static_cast<int32_t>(gid) : w.first;
    out_ac = (w.n_win < R && w.ac < 0) ? 0 : w.ac;  // a non-winner adds a 0
  }
  src[i * cap + r] = out_src;
  ac_out[i * cap + r] = out_ac;
}

}  // namespace

// Pointers are device pointers: publish_time (R, cap) f32, publisher and
// approval_count (R, cap) i32, mask (Rr, R) of bytes (bool or uint8, non-zero
// admits), src and ac_out (Rr, cap) i32, all contiguous. The stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int gossip_winner(const float* publish_time, const int* publisher,
                             const int* approval_count, long long R, long long cap,
                             const unsigned char* mask, long long Rr, long long row_offset,
                             int* src, int* ac_out, int device, void* stream) {
  if (R < 1 || cap < 1 || Rr < 1 || Rr > 65535 || row_offset < 0 || row_offset + Rr > R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long col_blocks = (cap + kRows - 1) / kRows;
  if (col_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(Rr));
  gossip_winner_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      publish_time, reinterpret_cast<const int32_t*>(publisher),
      reinterpret_cast<const int32_t*>(approval_count), R, cap,
      reinterpret_cast<const uint8_t*>(mask), row_offset, reinterpret_cast<int32_t*>(src),
      reinterpret_cast<int32_t*>(ac_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
