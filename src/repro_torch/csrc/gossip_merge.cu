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
// 6 compare/select operations each, 0.46 us at 67 T op/s. Either way far
// below a launch's own few microseconds: what a launch pays is its chain of
// dependent memory round trips and the issue slots of its checks. On the
// events engine a batch's mask holds the few edges that fire at one
// instant, so nearly every receiver hears only itself; on the full overlay
// every receiver hears every sender.
//
// Design: one launch, no scratch in device memory. A block takes kRows = 32
// ledger rows (one per lane) and a group of up to kMaxGroup receivers (one
// warp each); the host sizes the group so the grid is about one wave of the
// card's SMs.
//
// 1. Compact the mask. Warp g loads receiver g's mask row (every load of a
//    window in flight, then 32 senders a ballot) with its own bit forced
//    on, and its own (t, p, ac) at the row beside it. A receiver whose row
//    admits nobody else is self-only: its result is closed-form from its
//    own row, so it walks and stages nothing.
// 2. Senders go in windows of kWindow. For each window the block forms the
//    union of the senders its walking receivers admit (an OR of their bit
//    words, in registers of every warp), and each receiver's ascending
//    list of positions in that union (ballot prefix counts), padded with a
//    null position whose key is "not held".
// 3. A receiver that admits at most kDirect senders within one window (an
//    events batch's few live edges) has its warp fold them, lowest first,
//    straight from device memory, every load in flight at once, before the
//    block's first barrier, and takes no part in the windows.
// 4. For the others, warp w loads union positions w, w + 16, ... (every
//    load of the window in flight at once) as a 64-bit orderable key per
//    (sender, row) (the time's IEEE bits, -0.0 made +0.0, sign-flipped,
//    above the publisher; 0 = not held, all ones = NaN) and the counter. A
//    receiver that admits the whole union (every receiver of a round on the
//    full overlay, and the union fold, Rr = 1) takes the union's fold,
//    which the warps compute once for all of them from those registers: 16
//    partials meeting in two levels of four. Only when some receiver admits
//    part of the union are the keys and counters staged in shared memory
//    (12 bytes a line); its warp then walks its own list, lanes on rows, 4
//    positions a shared-memory read, into four running (key, first,
//    counter max, winners) folds that take the entries in turn (four
//    independent chains: the walk is bound by its issue slots and the
//    latency of each fold). L2 traffic falls from Rr * R * cap * 12 B to
//    (receiver groups) * (admitted columns). A window's result merges into
//    the running one (greater key wins; on an equal key the lower first
//    index, the larger counter, the summed count).
// 5. The result: (gid, 0) when nothing is held or a NaN was among the
//    candidates; else src = gid if the receiver's own key is the winner's,
//    else the first index, and ac = the counter max, floored at 0 unless
//    all R senders won.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                 // ledger rows per block, one per lane
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;             // receivers per block, one per warp
constexpr int kWindow = 128;              // senders per staged window
constexpr int kWords = kWindow / 32;
constexpr int kStage = kWindow / kWarps;  // staged senders per warp and window
constexpr int kNull = kWindow;            // the staged line of a list's padding
constexpr int kDirect = 8;                // a list this short is read straight from memory
constexpr uint64_t kNaNKey = ~0ull;       // above every held key
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kStageBytes = size_t(kWindow + 1) * kRows * (sizeof(uint64_t) + sizeof(int32_t));
static_assert(kMaxGroup == 16 && kWords == 4, "the union's shuffles take 16 receivers, 4 words");
static_assert(kMaxGroup == kWarps && kStage * kWarps == kWindow, "one warp a receiver");
static_assert(kWindow <= 128, "a list entry is a byte, the null line included");

// the orderable key of one (time, publisher): 0 when the row is not held,
// kNaNKey for a NaN time; -0.0 and +0.0 give one key
__device__ __forceinline__ uint64_t key_of(float t, int32_t p) {
  const uint32_t b = t == 0.0f ? 0u : __float_as_uint(t);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const uint64_t k = (static_cast<uint64_t>(o) << 32) | (static_cast<uint32_t>(p) ^ 0x80000000u);
  return p < 0 ? 0ull : (t != t ? kNaNKey : k);
}

struct Acc {
  uint64_t k = 0;      // the running key (0: nothing held yet)
  int32_t first = 0;   // lowest sender (or union position) holding it
  int32_t ac = 0;      // max approval_count over those senders
  int32_t nw = 0;      // how many senders hold it

  // one sender, in ascending order: a strictly greater key resets
  __device__ __forceinline__ void fold(uint64_t k2, int32_t a2, int32_t j) {
    const bool gt = k2 > k;
    const bool eq = k2 == k;
    first = gt ? j : first;
    ac = gt ? a2 : (eq ? max(ac, a2) : ac);
    nw = gt ? 1 : nw + static_cast<int32_t>(eq);
    k = gt ? k2 : k;
  }

  // another fold over a disjoint set of senders
  __device__ __forceinline__ void merge(const Acc& o) {
    const bool gt = o.k > k;
    const bool eq = o.k == k;
    first = gt ? o.first : (eq ? min(first, o.first) : first);
    ac = gt ? o.ac : (eq ? max(ac, o.ac) : ac);
    nw = gt ? o.nw : (eq ? nw + o.nw : nw);
    k = gt ? o.k : k;
  }
};

__device__ __forceinline__ unsigned pick(int w, unsigned u0, unsigned u1, unsigned u2,
                                         unsigned u3) {
  return w == 0 ? u0 : (w == 1 ? u1 : (w == 2 ? u2 : u3));
}

// the admitted bits of one mask row over senders [j0, j0 + kWindow), the
// receiver gid's own bit forced on: every load in flight before a ballot
__device__ __forceinline__ void window_bits(const uint8_t* __restrict__ mrow, int64_t j0,
                                            int64_t R, int64_t gid, int lane,
                                            unsigned (&b)[kWords]) {
  uint8_t m[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int64_t j = j0 + w * 32 + lane;
    m[w] = j < R ? mrow[j] : 0;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int64_t j = j0 + w * 32 + lane;
    b[w] = __ballot_sync(kFull, j < R && (j == gid || m[w] != 0));
  }
}

__global__ void __launch_bounds__(kThreads) gossip_winner_kernel(
    const float* __restrict__ t, const int32_t* __restrict__ p, const int32_t* __restrict__ ac,
    int64_t R, int64_t cap, const uint8_t* __restrict__ mask, int64_t Rr, int64_t row_offset,
    int group, int32_t* __restrict__ src, int32_t* __restrict__ ac_out) {
  extern __shared__ uint64_t s_stage[];  // keys [kWindow + 1][kRows], then counters
  int32_t* s_ac = reinterpret_cast<int32_t*>(s_stage + (kWindow + 1) * kRows);
  __shared__ __align__(4) uint8_t s_list[kMaxGroup][kWindow];  // union positions
  __shared__ uint32_t s_bits[kMaxGroup][kWords];   // admitted senders of the window
  __shared__ uint8_t s_u[kWindow];                 // window index of each union position
  __shared__ uint64_t s_pk[kWarps][kRows];         // the union fold's partials, then result
  __shared__ int32_t s_pi[kWarps][3][kRows];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRows + lane;
  const bool live = r < cap;
  const int64_t rc = live ? r : cap - 1;  // in bounds for the unconditional loads
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * group;
  const int ng = static_cast<int>(Rr - i0 < group ? Rr - i0 : group);
  const int64_t gid = i0 + warp + row_offset;  // this warp's receiver, if warp < ng

  // 1. each receiver's own row and mask row: self-only or not, window 0's bits
  float own_t = 0.0f;
  int32_t own_p = -1, own_ac = 0;
  bool walks = false, quick = false;
  int admitted = 0;
  unsigned b0[kWords] = {0u, 0u, 0u, 0u};
  Acc run;  // warp g's receiver, over the senders so far
  if (warp < ng) {
    const int64_t own = gid * cap + rc;
    own_t = __ldg(t + own);
    own_p = __ldg(p + own);
    own_ac = __ldg(ac + own);
    const uint8_t* mrow = mask + (i0 + warp) * R;
    for (int64_t j0 = 0; j0 < R; j0 += kWindow) {
      unsigned b[kWords];
      window_bits(mrow, j0, R, gid, lane, b);
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int64_t jw = j0 + w * 32;
        const unsigned self = (gid >= jw && gid < jw + 32) ? 1u << (gid - jw) : 0u;
        walks = walks || (b[w] & ~self) != 0u;
        admitted += __popc(b[w]);
        if (j0 == 0) b0[w] = b[w];
        if (j0 == 0 && lane == 0) s_bits[warp][w] = b[w];
      }
    }
    // 3. one window and a short list (an events batch's few live edges):
    //    the warp folds its admitted senders, lowest first, straight from
    //    device memory, every load in flight at once, and takes no part in
    //    the windows
    quick = walks && R <= kWindow && admitted <= kDirect;
    if (quick) {
      int32_t jq[kDirect];
      float tq[kDirect];
      int32_t pq[kDirect], aq[kDirect];
#pragma unroll
      for (int k = 0; k < kDirect; ++k) {
        const int w = b0[0] ? 0 : (b0[1] ? 1 : (b0[2] ? 2 : (b0[3] ? 3 : kWords)));
        const unsigned cur = w < kWords ? pick(w, b0[0], b0[1], b0[2], b0[3]) : 0u;
        jq[k] = w < kWords ? w * 32 + __ffs(cur) - 1 : 0;
#pragma unroll
        for (int v = 0; v < kWords; ++v) b0[v] = v == w ? b0[v] & (b0[v] - 1u) : b0[v];
        const int64_t off = jq[k] * cap + rc;
        const bool on = w < kWords;
        tq[k] = on ? __ldg(t + off) : 0.0f;
        pq[k] = on ? __ldg(p + off) : -1;
        aq[k] = on ? __ldg(ac + off) : 0;
      }
#pragma unroll
      for (int k = 0; k < kDirect; ++k) run.fold(live ? key_of(tq[k], pq[k]) : 0ull, aq[k], jq[k]);
    }
    __syncwarp();
    if ((!walks || quick) && lane < kWords) s_bits[warp][lane] = 0u;
  }
  if (warp == 0) {
    s_stage[kNull * kRows + lane] = 0ull;
    s_ac[kNull * kRows + lane] = 0;
  }
  const bool windowed = walks && !quick;   // this warp's receiver walks the windows
  const bool windows = __syncthreads_or(windowed) != 0;
  for (int64_t w0 = 0; windows && w0 < R; w0 += kWindow) {
    if (w0 > 0) {
      if (warp < ng) {
        unsigned b[kWords];
        window_bits(mask + (i0 + warp) * R, w0, R, gid, lane, b);
        if (lane < kWords) s_bits[warp][lane] = windowed ? pick(lane, b[0], b[1], b[2], b[3]) : 0u;
      }
      __syncthreads();
    }
    // 2. the union's words in every warp (lane: receiver lane % 16, words
    //    lane / 16 and lane / 16 + 2), then its senders by position
    unsigned v0 = 0u, v1 = 0u;
    if ((lane & 15) < ng) {
      v0 = s_bits[lane & 15][lane >> 4];
      v1 = s_bits[lane & 15][(lane >> 4) + 2];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      v0 |= __shfl_xor_sync(kFull, v0, off);
      v1 |= __shfl_xor_sync(kFull, v1, off);
    }
    const unsigned u0 = __shfl_sync(kFull, v0, 0), u1 = __shfl_sync(kFull, v0, 16);
    const unsigned u2 = __shfl_sync(kFull, v1, 0), u3 = __shfl_sync(kFull, v1, 16);
    const int p1 = __popc(u0), p2 = p1 + __popc(u1), p3 = p2 + __popc(u2);
    const int nu = p3 + __popc(u3);
    if (warp < kWords) {
      const unsigned u = pick(warp, u0, u1, u2, u3);
      const int pre = static_cast<int>(pick(warp, 0, p1, p2, p3));
      if ((u >> lane) & 1u) s_u[pre + __popc(u & lt)] = static_cast<uint8_t>(warp * 32 + lane);
    }
    bool whole = false;  // this warp's receiver admits the whole union
    unsigned mine[kWords] = {0u, 0u, 0u, 0u};
    if (warp < ng) {
      bool same = true;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        mine[w] = s_bits[warp][w];
        same = same && mine[w] == pick(w, u0, u1, u2, u3);
      }
      whole = windowed && same;
    }
    // one barrier, two counts: a whole receiver's warp reports one thread,
    // a walking receiver that is not whole reports 32
    const int tally = __syncthreads_count(windowed && (!whole || lane == 0));
    if (nu == 0) continue;
    const bool any_whole = tally % 32 != 0;
    const bool staged = tally >= 32;
    // the warp's own list where it walks one: ascending union positions
    // (ballot prefix counts), padded to 4 with the null line
    int listed = 0;
    if (windowed && !whole) {
      int cnt = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const unsigned u = pick(w, u0, u1, u2, u3);
        const int pre = static_cast<int>(pick(w, 0, p1, p2, p3));
        if ((mine[w] >> lane) & 1u) {
          s_list[warp][cnt + __popc(mine[w] & lt)] = static_cast<uint8_t>(pre + __popc(u & lt));
        }
        cnt += __popc(mine[w]);
      }
      listed = (cnt + 3) & ~3;
      if (cnt + lane < listed) s_list[warp][cnt + lane] = static_cast<uint8_t>(kNull);
      __syncwarp();
    }

    // 4. warp w loads union positions w, w + 16, ..., every load in flight
    //    at once, stages them for the lists that need them, and folds them
    //    for the receivers that take the whole union
    uint64_t kq[kStage];
    int32_t aq[kStage], jq[kStage];
    {
      float tq[kStage];
      int32_t pq[kStage];
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int k = warp + q * kWarps;
        const bool on = k < nu;
        jq[q] = static_cast<int32_t>(w0) + (on ? s_u[k] : 0);
        const int64_t off = jq[q] * cap + rc;
        tq[q] = on ? __ldg(t + off) : 0.0f;
        pq[q] = on ? __ldg(p + off) : -1;
        aq[q] = on ? __ldg(ac + off) : 0;
      }
#pragma unroll
      for (int q = 0; q < kStage; ++q) kq[q] = live ? key_of(tq[q], pq[q]) : 0ull;
    }
    if (staged) {
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int k = warp + q * kWarps;
        if (k < nu) {
          s_stage[k * kRows + lane] = kq[q];
          s_ac[k * kRows + lane] = aq[q];
        }
      }
    }
    if (any_whole) {  // the union's fold: 16 partials, meeting in two levels of four
      Acc part;
#pragma unroll
      for (int q = 0; q < kStage; ++q) part.fold(kq[q], aq[q], jq[q]);
      auto put = [&](int w) {
        s_pk[w][lane] = part.k;
        s_pi[w][0][lane] = part.first;
        s_pi[w][1][lane] = part.ac;
        s_pi[w][2][lane] = part.nw;
      };
      auto take = [&](int w) {
        Acc o;
        o.k = s_pk[w][lane];
        o.first = s_pi[w][0][lane];
        o.ac = s_pi[w][1][lane];
        o.nw = s_pi[w][2][lane];
        part.merge(o);
      };
      put(warp);
      __syncthreads();
      if (warp < 4) {
        take(warp + 4);
        take(warp + 8);
        take(warp + 12);
        put(warp);
      }
      __syncthreads();
      if (warp == 0) {
        take(1);
        take(2);
        take(3);
        put(0);
      }
    }
    __syncthreads();

    // each walking receiver: the union's fold, or its own list
    if (windowed) {
      Acc win;
      if (whole) {
        win.k = s_pk[0][lane];
        win.first = s_pi[0][0][lane];
        win.ac = s_pi[0][1][lane];
        win.nw = s_pi[0][2][lane];
      } else {
        Acc a1, a2, a3;  // four folds in turn: four independent chains
#pragma unroll 4
        for (int n0 = 0; n0 < listed; n0 += 4) {
          const uint32_t e = *reinterpret_cast<const uint32_t*>(&s_list[warp][n0]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = static_cast<int>((e >> (8 * k)) & 0xffu);
            (k == 0 ? win : (k == 1 ? a1 : (k == 2 ? a2 : a3)))
                .fold(s_stage[q * kRows + lane], s_ac[q * kRows + lane], q);
          }
        }
        win.merge(a1);
        win.merge(a2);
        win.merge(a3);
        win.first = static_cast<int32_t>(w0) + s_u[win.first < kWindow ? win.first : 0];
      }
      run.merge(win);
    }
  }

  // 5. one warp a receiver writes its rows
  if (warp >= ng || !live) return;
  int32_t out_src = static_cast<int32_t>(gid);
  int32_t out_ac = 0;
  if (!walks) {  // self-only: the receiver alone is a candidate
    if (own_p >= 0 && own_t == own_t) out_ac = (R == 1 || own_ac > 0) ? own_ac : 0;
  } else if (run.k != 0ull && run.k != kNaNKey) {
    out_src = key_of(own_t, own_p) == run.k ? static_cast<int32_t>(gid) : run.first;
    out_ac = (run.nw < R && run.ac < 0) ? 0 : run.ac;  // a non-winner adds a 0
  }
  src[(i0 + warp) * cap + r] = out_src;
  ac_out[(i0 + warp) * cap + r] = out_ac;
}

int g_sms[64];                    // SMs per device, read once
bool g_smem_set[64];              // the kernel's dynamic shared memory raised

}  // namespace

// Pointers are device pointers: publish_time (R, cap) f32, publisher and
// approval_count (R, cap) i32, mask (Rr, R) of bytes (bool or uint8, non-zero
// admits), src and ac_out (Rr, cap) i32, all contiguous. The stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int gossip_winner(const float* publish_time, const int* publisher,
                             const int* approval_count, long long R, long long cap,
                             const unsigned char* mask, long long Rr, long long row_offset,
                             int* src, int* ac_out, int device, void* stream) {
  if (R < 1 || cap < 1 || Rr < 1 || Rr > 65535 || row_offset < 0 || row_offset + Rr > R ||
      device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_sms[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device] = sms;
  }
  if (!g_smem_set[device]) {
    err = cudaFuncSetAttribute(gossip_winner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStageBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[device] = true;
  }
  const long long tiles = (cap + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // receivers per block: about one wave of blocks
  long long group = (Rr * tiles + g_sms[device] - 1) / g_sms[device];
  group = group < 1 ? 1 : (group > kMaxGroup ? kMaxGroup : group);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((Rr + group - 1) / group));
  gossip_winner_kernel<<<grid, kThreads, kStageBytes, static_cast<cudaStream_t>(stream)>>>(
      publish_time, reinterpret_cast<const int32_t*>(publisher),
      reinterpret_cast<const int32_t*>(approval_count), R, cap,
      reinterpret_cast<const uint8_t*>(mask), Rr, row_offset, static_cast<int>(group),
      reinterpret_cast<int32_t*>(src), reinterpret_cast<int32_t*>(ac_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gossip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
