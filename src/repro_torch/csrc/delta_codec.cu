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
// sorted-name order, each zero-padded to whole blocks (at least one); the
// padding zeros are implicit here. One launch covers every leaf (up to
// kMaxLeaves; a model with more takes one launch per kMaxLeaves leaves).
// Leaf offsets in a flat payload are not 16-byte aligned (the CNN's `bout`
// starts at value 608, `conv1` at 618).
//
// Bound at the main path's shape (the paper's CNN: P = 1,663,370 values in
// 8 leaves, NB = 12,998 blocks of 128): quantisation reads 6.65 MB and
// writes 1.66 MB of codes and 52 KB of scales, 8.37 MB or 2.5 us at 3.35
// TB/s, against about 10 M f32 operations (0.15 us): bytes; writing the
// decoded payload as well adds 6.65 MB, 15.0 MB or 4.48 us. Top-k reads the
// payload and the base (13.3 MB) and writes the masked delta (6.66 MB), 20
// MB or 6.0 us; its selection is a few integer operations a value a step:
// bytes. A dense rank (128 compares a value, 213 M in all) made the first
// design issue-bound at 56 us.
//
// Design. Quantisation (quant_leaves_kernel): the leaf table travels by
// value as a __grid_constant__ kernel parameter (each leaf's own device
// pointer, its first codec block and its first flat value), so a codec
// block finds its leaf by a binary search through the constant cache with
// no global load before its values, and the payload is read in place, leaf
// by leaf, with no flat copy. A warp takes a codec block at a time, lane l
// values 4l .. 4l + 3 of each 128 (as one 16-byte load where the leaf's
// address allows, else as four scalar loads issued together), keeps them in
// registers for the amax (a shuffle reduction) and the codes, and stores
// its four codes as one 32-bit word: 128 bytes a warp. The grid holds at
// most kQuantBlocksPerSm blocks of kQuantWarps warps an SM; each warp takes
// codec blocks a grid apart, kQuantBatch of 128 values at a time (fewer of
// larger blocks) with all their loads in flight before it reduces any: at
// the CNN's 12,998 blocks one step. The kernel is bound by memory latency
// and the launch: at the CNN it is faster than PyTorch's own copy of the
// payload (chip_smoke.py 1d); a quarter or half as many warps an SM, one
// or four codec blocks a step, streaming cache hints and a reciprocal
// multiply checked against the half-integer boundaries in place of the
// division were each no faster. Optionally the same launch writes the
// decoded payload, float(code) * scale (the IEEE product dequant_blocks
// computes), into a flat buffer at each value's own place, padding left
// out.
// Top-k: one warp per codec block too, the block's values in registers
// (lane l holds values l, l + 32, ...: V = 1 to 32 a lane for blocks of up
// to 1,024), ranked by selection, not by counting:
//   - the key of a value is the bits of |d| plus one, an unsigned integer
//     in the order of |d| (-0.0 is +0.0); a NaN, and a slot past the block,
//     has key 0 and counts for no one. A NaN is kept (for k >= 1).
//   - with k >= the block's non-NaN values everything is kept; with k = 0
//     nothing. Otherwise the warp finds T, the k-th largest key. For k <=
//     kRoundsMax and up to 8 values a lane, by rounds: each lane sorts its
//     keys (an odd-even network), and a round takes the warp's largest
//     head by one redux.sync max and drops it from every lane that holds
//     it (a ballot counts them), so at most k rounds. Otherwise by a
//     bitwise search, 31 steps of a per-lane count and one redux.sync add,
//     keeping each bit that leaves at least k keys at or above it. A round
//     costs about a quarter of the search's 31 steps at the main shape, so
//     the rounds run up to k = 32. Either is a few warp instructions a
//     step, shared by the 32 lanes, where the dense rank took 128
//     compare-and-add steps a thread.
//   - every key above T is kept, and of the keys equal to T the first
//     k - (count above) in index order: a ballot per register slot gives
//     each lane the count of equal keys before it; the rounds skip this
//     when the keys equal to T are exactly the ones needed.
// The delta's subtraction (payload - base) is fused into the load. Not
// carried over from the TPU: its padded (nb, 128) copy of every leaf, its
// int32 codes cast to int8 outside, and its (8, 128, 128) compare tensor
// per grid step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;       // leaves one quantisation launch takes
constexpr int kQuantWarps = 8;       // warps of a quantisation block
constexpr int kQuantBlocksPerSm = 8; // quantisation blocks an SM at most
constexpr int kQuantBatch = 2;       // codec blocks of 128 values a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Span {
  int64_t start;  // first flat value of the codec block
  int count;      // values present (the rest of the block is zero padding)
};

// The top-k kernel's table: 2 * (L + 1) int64 in device memory, the first
// codec block of each leaf (then the total NB) and the first flat value of
// each leaf (then P); a binary search over the first row.
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

// The quantisation kernel's table, passed by value: leaves [0, leaves) of
// one launch, first_block and first_value absolute (codes, scales and the
// decoded payload are indexed by them), src[l] leaf l's first value.
struct LeafTable {
  const float* src[kMaxLeaves];
  int64_t first_block[kMaxLeaves + 1];
  int64_t first_value[kMaxLeaves + 1];
  int leaves;
};

// One codec block of the quantisation kernel: where its values are read
// (src, count of them present) and where its decoded values go (value, the
// flat index of its first value).
struct QuantSpan {
  const float* src;
  int64_t value;
  int count;
};

__device__ __forceinline__ QuantSpan quant_span(const LeafTable& t, int64_t b, int block) {
  int lo = 0, hi = t.leaves;  // first_block[lo] <= b < first_block[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (t.first_block[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int64_t offset = (b - t.first_block[lo]) * block;   // within the leaf
  const int64_t left = t.first_value[lo + 1] - t.first_value[lo] - offset;
  return {t.src[lo] + offset, t.first_value[lo] + offset,
          static_cast<int>(left < 0 ? 0 : (left < block ? left : block))};
}

// Lane `lane`'s values of one codec block: v[4 j + k] is value 128 j + 4
// lane + k, zero past the values present.
template <int J>
__device__ __forceinline__ void load_block(const QuantSpan& s, int block, int lane,
                                           float (&v)[4 * J]) {
  const bool vec = s.count == block && (block & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(s.src) & 15) == 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = 128 * j + 4 * lane;
    if (vec && i < block) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(s.src + i));
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * j + k] = i + k < s.count ? __ldg(s.src + i + k) : 0.0f;
    }
  }
}

// the larger of a and b, NaN if either is NaN (jnp.max, torch.amax)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <int J>
__device__ __forceinline__ void quant_block(const float (&v)[4 * J], const QuantSpan& s,
                                            int64_t b, int block, float qmax, int lane,
                                            int8_t* __restrict__ codes,
                                            float* __restrict__ scales,
                                            float* __restrict__ decoded) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 4 * J; ++i) amax = nan_max(amax, fabsf(v[i]));
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(kFull, amax, offset));
  }
  const float scale = amax > 0.0f ? __fdiv_rn(amax, qmax) : 1.0f;
  int8_t* out = codes + b * block;
  float* dec = decoded != nullptr ? decoded + s.value : nullptr;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = 128 * j + 4 * lane;
    if (i >= block) continue;
    int c[4];
    uint32_t word = 0;   // the four codes, little-endian
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[4 * j + k], scale)), -qmax), qmax));
      word |= (static_cast<uint32_t>(c[k]) & 0xffu) << (8 * k);
    }
    if ((block & 3) == 0) {
      *reinterpret_cast<uint32_t*>(out + i) = word;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < block) out[i + k] = static_cast<int8_t>(c[k]);
      }
    }
    if (dec == nullptr) continue;
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __fmul_rn(static_cast<float>(c[k]), scale);
    if (i + 4 <= s.count && (reinterpret_cast<uintptr_t>(dec + i) & 15) == 0) {
      *reinterpret_cast<float4*>(dec + i) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < s.count) dec[i + k] = d[k];
      }
    }
  }
  if (lane == 0) scales[b] = scale;
}

// J: 128-value runs a lane covers (blocks of up to 128 J values)
template <int J>
__global__ void __launch_bounds__(kQuantWarps * 32) quant_leaves_kernel(
    const __grid_constant__ LeafTable t, int block, float qmax, int8_t* __restrict__ codes,
    float* __restrict__ scales, float* __restrict__ decoded) {
  constexpr int kBatch = J >= kQuantBatch ? 1 : kQuantBatch / J;   // codec blocks a step
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kQuantWarps;
  const int64_t end = t.first_block[t.leaves];
  for (int64_t b0 = t.first_block[0] + static_cast<int64_t>(blockIdx.x) * kQuantWarps +
                    threadIdx.x / 32;
       b0 < end; b0 += warps * kBatch) {   // whole warps leave together
    // every load of the step goes out before any block is reduced
    QuantSpan s[kBatch];
    float v[kBatch][4 * J];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t b = b0 + k * warps;
      if (b < end) {
        s[k] = quant_span(t, b, block);
        load_block<J>(s[k], block, lane, v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t b = b0 + k * warps;
      if (b < end) quant_block<J>(v[k], s[k], b, block, qmax, lane, codes, scales, decoded);
    }
  }
}

constexpr int kTopkWarps = 8;     // warps (each on its own codec block) per thread block
constexpr int kRoundsMax = 32;    // k up to this, and up to 8 values a lane: rounds

// The k-th largest key of the warp, T (k >= 1, fewer than the warp's
// nonzero keys), and how many of the keys equal to T are kept: those
// first in index order, k - #{key > T}; all of them when `all_ties`.
template <int V>
__device__ __forceinline__ unsigned kth_key(const unsigned (&key)[V], int k, int& ties_kept,
                                            bool& all_ties) {
  if (V <= 8 && k <= kRoundsMax) {
    // Rounds: each lane sorts its keys, largest first; a round takes the
    // warp's largest head and drops it from every lane that holds it, so
    // the keys leave in decreasing order, one round per key at most.
    unsigned s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = key[v];
#pragma unroll
    for (int pass = 0; pass < V; ++pass) {
#pragma unroll
      for (int v = pass & 1; v + 1 < V; v += 2) {
        const unsigned hi = max(s[v], s[v + 1]);
        s[v + 1] = min(s[v], s[v + 1]);
        s[v] = hi;
      }
    }
    int taken = 0, above = 0;    // keys dropped; of them, above this round's key
    unsigned last = kFull;
    while (true) {
      const unsigned m = __reduce_max_sync(kFull, s[0]);
      if (m != last) {
        above = taken;
        last = m;
      }
      const bool hit = s[0] == m;
      taken += __popc(__ballot_sync(kFull, hit));
      if (hit) {
#pragma unroll
        for (int v = 0; v + 1 < V; ++v) s[v] = s[v + 1];
        s[V - 1] = 0u;
      }
      if (taken >= k) {
        ties_kept = k - above;
        all_ties = taken == k && !__any_sync(kFull, s[0] == m);
        return m;
      }
    }
  }
  // The bitwise search: T is the largest value with at least k keys at or
  // above it, built from the top bit down (keys are below 2^31).
  unsigned t = 0;
#pragma unroll 1
  for (int bit = 30; bit >= 0; --bit) {
    const unsigned cand = t | (1u << bit);
    int c = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) c += key[v] >= cand;
    if (__reduce_add_sync(kFull, c) >= k) t = cand;
  }
  int c = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) c += key[v] > t;
  ties_kept = k - __reduce_add_sync(kFull, c);
  all_ties = false;
  return t;
}

template <int V>
__global__ void __launch_bounds__(kTopkWarps * 32) topk_blocks_kernel(
    const float* __restrict__ x, const float* __restrict__ base,
    const int64_t* __restrict__ table, int leaves, int64_t nb, int block, int k,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kTopkWarps + threadIdx.x / 32;
  if (b >= nb) return;  // whole warps leave together
  const Span span = block_span(table, leaves, b, block);
  const float* src = x + span.start;
  const float* sub = base != nullptr ? base + span.start : nullptr;

  float d[V];
  unsigned key[V];
  unsigned nan = 0;      // bit v: value v is NaN
  int live = 0;          // this lane's nonzero keys
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = lane + 32 * v;
    float dv = 0.0f;   // padding past the leaf is +0.0, and ranks
    if (i < span.count) dv = sub != nullptr ? src[i] - sub[i] : src[i];
    d[v] = dv;
    const unsigned a = __float_as_uint(dv) & 0x7fffffffu;
    const bool in = i < block;
    const bool is_nan = a > 0x7f800000u;
    key[v] = in && !is_nan ? a + 1 : 0u;
    nan |= static_cast<unsigned>(in && is_nan) << v;
    live += key[v] != 0;
  }

  unsigned keep = 0;     // bit v: value v is kept
  if (k > 0) {
    if (k >= __reduce_add_sync(kFull, live)) {
#pragma unroll
      for (int v = 0; v < V; ++v) keep |= static_cast<unsigned>(key[v] != 0) << v;
    } else {
      int ties_kept;
      bool all_ties;
      const unsigned t = kth_key<V>(key, k, ties_kept, all_ties);
      if (all_ties) {
#pragma unroll
        for (int v = 0; v < V; ++v) keep |= static_cast<unsigned>(key[v] >= t) << v;
      } else {
        const unsigned before = (1u << lane) - 1u;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const unsigned eq = __ballot_sync(kFull, key[v] == t);
          const bool tie_kept = key[v] == t && __popc(eq & before) < ties_kept;
          keep |= static_cast<unsigned>(key[v] > t || tie_kept) << v;
          ties_kept -= __popc(eq);
        }
      }
    }
    keep |= nan;
  }

  float* dst = out + b * block;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = lane + 32 * v;
    if (i < block) dst[i] = (keep >> v) & 1u ? d[v] : 0.0f;
  }
}

template <int V>
void launch_topk(const float* x, const float* base, const int64_t* table, int leaves,
                 long long nb, int block, int k, float* out, cudaStream_t stream) {
  const long long grid = (nb + kTopkWarps - 1) / kTopkWarps;
  topk_blocks_kernel<V><<<static_cast<unsigned>(grid), kTopkWarps * 32, 0, stream>>>(
      x, base, table, leaves, nb, block, k, out);
}

cudaError_t check_args(int leaves, long long nb, int block) {
  if (leaves < 1 || nb < 1 || nb > 0x7fffffffLL || block < 1 || block > 1024) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int J>
void launch_quant(const LeafTable& t, int block, float qmax, int8_t* codes, float* scales,
                  float* decoded, int sms, cudaStream_t stream) {
  const long long nb = t.first_block[t.leaves] - t.first_block[0];
  long long grid = (nb + kQuantWarps - 1) / kQuantWarps;
  if (grid > static_cast<long long>(sms) * kQuantBlocksPerSm) {
    grid = static_cast<long long>(sms) * kQuantBlocksPerSm;
  }
  quant_leaves_kernel<J><<<static_cast<unsigned>(grid), kQuantWarps * 32, 0, stream>>>(
      t, block, qmax, codes, scales, decoded);
}

}  // namespace

// The most leaves one quant_leaves launch takes.
extern "C" int quant_leaves_max_leaves() { return kMaxLeaves; }

// Quantise a payload given leaf by leaf. Host arrays: src (leaves,) of
// device pointers, each leaf's contiguous f32 values; first_block and
// first_value (leaves + 1,) int64, the first codec block and the first flat
// value of each leaf, then the totals NB and P. Device pointers, all
// contiguous: codes (NB, block) int8, scales (NB,) f32 and, unless null,
// decoded (P,) f32, which receives float(code) * scale at each value's flat
// place. qmax is 127 (int8) or 7 (int4). The stream is a cudaStream_t. One
// launch per kMaxLeaves leaves; returns the cudaError_t of the first that
// fails (0 on success).
extern "C" int quant_leaves(const void* const* src, const long long* first_block,
                            const long long* first_value, int leaves, int block, int qmax,
                            signed char* codes, float* scales, float* decoded, int device,
                            void* stream) {
  cudaError_t err = check_args(leaves, first_block[leaves], block);
  if (err != cudaSuccess || qmax < 1 || qmax > 127) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<int8_t*>(codes);
  const float q = static_cast<float>(qmax);
  for (int l0 = 0; l0 < leaves; l0 += kMaxLeaves) {
    LeafTable t = {};
    t.leaves = leaves - l0 < kMaxLeaves ? leaves - l0 : kMaxLeaves;
    for (int l = 0; l < t.leaves; ++l) t.src[l] = static_cast<const float*>(src[l0 + l]);
    for (int l = 0; l <= t.leaves; ++l) {
      t.first_block[l] = first_block[l0 + l];
      t.first_value[l] = first_value[l0 + l];
    }
    if (block <= 128) {
      launch_quant<1>(t, block, q, c, scales, decoded, sms, st);
    } else if (block <= 256) {
      launch_quant<2>(t, block, q, c, scales, decoded, sms, st);
    } else if (block <= 512) {
      launch_quant<4>(t, block, q, c, scales, decoded, sms, st);
    } else {
      launch_quant<8>(t, block, q, c, scales, decoded, sms, st);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// x the flat payload (P,) f32, base the flat base (P,) f32 or null (then the
// kernel ranks x itself), table (2, leaves + 1) int64 (the first codec
// block of each leaf, then NB; the first flat value of each leaf, then P),
// out (nb, block) f32:
// the masked delta, padding included. k is the number kept per block.
extern "C" int topk_blocks(const float* x, const float* base, const long long* table,
                           int leaves, long long nb, int block, int k, float* out, int device,
                           void* stream) {
  cudaError_t err = check_args(leaves, nb, block);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* t = reinterpret_cast<const int64_t*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  const int per_lane = (block + 31) / 32;   // values a lane holds
  if (per_lane <= 1) {
    launch_topk<1>(x, base, t, leaves, nb, block, k, out, st);
  } else if (per_lane <= 2) {
    launch_topk<2>(x, base, t, leaves, nb, block, k, out, st);
  } else if (per_lane <= 4) {
    launch_topk<4>(x, base, t, leaves, nb, block, k, out, st);
  } else if (per_lane <= 8) {
    launch_topk<8>(x, base, t, leaves, nb, block, k, out, st);
  } else if (per_lane <= 16) {
    launch_topk<16>(x, base, t, leaves, nb, block, k, out, st);
  } else {
    launch_topk<32>(x, base, t, leaves, nb, block, k, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* delta_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
