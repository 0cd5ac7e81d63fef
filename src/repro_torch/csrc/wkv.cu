// RWKV6 WKV with data-dependent decay: the chunked route (prefill and
// forward) with its products on the tensor cores, and the sequential route
// (decode and every other length).
//
// Per (b, h), with the (hd_k, hd_v) state S in f32:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//
// w_t = exp(logw_t), logw <= 0. r, k, v and u are f32 or bf16 (T), logw and
// the states f32, y is written in f32; hd is 64 or 128; the C functions
// refuse anything else. Both routes start from a given state and write the
// final one (prefill feeds decode). No atomics: the same inputs give the
// same bits.
//
// ---------------------------------------------------------------------------
// The chunked route, wkv_forward. Replaces the TPU kernel
// repro/kernels/wkv.py::wkv_pallas (_wkv_kernel, pallas_call at wkv.py:99),
// which computes, in chunks of C = 32 steps, with cum the inclusive
// cumulative sum of logw over the chunk (sequential in t, f32) and cum_prev
// = cum - logw:
//   y[t]  = sum_{s<t} (sum_d r[t,d] k[s,d] exp(cum_prev[t,d] - cum[s,d])) v[s]
//         + (sum_d r[t,d] k[t,d] u[d]) v[t] + (r[t] * exp(cum_prev[t])) S
//   S'    = exp(cum[C-1]) * S + sum_s (k[s] * exp(cum[C-1] - cum[s]))^T v[s]
// Its caller is the RWKV6 time mix (models/rwkv.py): every layer of a
// forward or prefill whose length is a positive multiple of 32.
//
// Bound on one H100 SXM (rwkv6-7b: B 1, T 8,192, H 64, hd 64, bf16): r, k,
// v (201 MB), logw (134 MB) and y (134 MB) are 470 MB, 0.141 ms at 3.35
// TB/s. The products (r_dec S, k_dec^T v and the factorised scores, 9.4
// GFLOP) take 0.019 ms at the TF32 tensor rate, the direct pairs and A v
// 0.02 ms on the CUDA cores and the 0.26 G exponentials of the factorised
// form 0.062 ms: bound by bytes (chip_smoke.py::wkv_bound).
//
// Design: two kernels, so that only what needs the state walks the chunks
// in order.
// - wkv_state_kernel walks the chunks: two blocks a (h, b), each half of the
//   value rows, so that B 1 at H 64 takes 128 SMs. Consumer warps keep S^T
//   (value rows, key columns) in registers as mma.sync accumulators for the
//   whole sequence, a warp 16 rows and half of the key columns; producer
//   warps (warp specialisation) load the chunk after next by cp.async and
//   form the next chunk's decays while the consumers multiply this one's,
//   one barrier a chunk. Producers: the cumulative sums, sequential in t
//   per channel as the plain version's, then r_dec = r e^cum_prev and k_dec
//   = k e^(total - cum) into shared memory, already split (below), one
//   thread a channel and side. Consumers: y^T = S^T r_dec^T and S'^T =
//   e^total S^T + v^T k_dec by mma.sync m16n8k8 TF32. S^T's accumulator
//   layout serves as the A operand of the next product when the depth index
//   is permuted in each step of 8 (k = q -> 2q, q + 4 -> 2q + 1, the same
//   for the B operand), so S never leaves the registers; the two warps of a
//   row tile add their halves of y through shared memory. TF32 keeps 10
//   mantissa bits, so every f32 operand is split, hi = tf32(x), lo = tf32(x
//   - hi), and a product is hi hi + hi lo + lo hi in f32 (bf16 values are
//   exact in TF32: v in bf16 takes two products). Each chunk's products
//   start from zero accumulators and join S by one f32 fma, so S carries no
//   tensor-core rounding from chunk to chunk. It writes y's inter-chunk
//   part.
// - wkv_intra_kernel, one block per (chunk, h, b), all in parallel, adds
//   the intra-chunk part: the scores by sub-chunks of 8 steps. For t in
//   sub-chunk n > 0, s in an earlier one and g = cum_prev[8 n],
//   exp(cum_prev[t] - cum[s]) = exp(cum_prev[t] - g) exp(g - cum[s]), both
//   exponents <= 0 (cum does not increase), so the blocks below the
//   diagonal are r~ k~^T on the tensor cores with the same split; the 28
//   pairs inside each sub-chunk and the bonus keep the direct form, one
//   exponential a term, a warp a sub-chunk with its lanes on the channels
//   (11.8 k exponentials a chunk where the direct form needs 31.7 k). The
//   cumulative sums are the plain version's to the bit (the boundary pairs
//   (8 n, 8 n - 1) then get their exponents exactly), and A v is f32 on the
//   CUDA cores. It runs after wkv_state_kernel on the stream and adds into
//   y, whose values it loads before it forms the scores.
//
// What holds it above the bound on the card (PERF.md, row 11): the state
// kernel's chunk, the consumers' mma.sync TF32 products and the producers'
// exponentials, 256 chunks in order at 8k; the intra-chunk kernel's score
// phase, issue-bound at four blocks an SM.
//
// ---------------------------------------------------------------------------
// The sequential route, wkv_scan_forward. Replaces no Pallas kernel: the
// reference runs its decode (and every length that is not a positive
// multiple of 32) through repro/models/rwkv.py::wkv_scan, plain JAX. It was
// added because the port's plain scan took about 25 of a 38.4 ms decode
// step of rwkv6-7b at B = 128 on the H100: about ten eager passes a layer
// over the (128, 64, 64, 64) f32 state, and a copy back into the cache.
// Bound (B 128, H 64, hd 64, T 1): the state read once and written once,
// with r, k, v, logw and y 276 MB, 0.082 ms a layer at 3.35 TB/s: bound by
// bytes (chip_smoke.py::wkv_scan_bound). One block per (h,
// b) holds its (hd, hd) slice in registers (8 rows x 4 columns a thread,
// float4 loads), steps through t, and reduces r S over the row groups in
// shared memory. A block reads its whole slice before it writes it, so the
// state may be updated in place (s_out == s_in).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 32;                       // timesteps a chunk
constexpr int kSub = 8;                      // timesteps a sub-chunk of the scores
constexpr int kSubPairs = kSub * (kSub - 1) / 2;   // strictly lower pairs of a sub-chunk: 28
// wkv_intra_kernel takes a sub-chunk as one mma tile of 8 columns, one warp
// each, and its 28 pairs and 4 of its bonus terms as the 32 lanes' sums
static_assert(kC == 4 * kSub && kSub == 8 && kSubPairs + 4 == 32, "the intra kernel's tiling");

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as an mma
// operand: cvt.rna.tf32.f32 for finite x, in two integer operations where
// the instruction takes five (it also sorts out NaN and infinity)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to about 21 bits, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// an operand of type T: bf16 is exact in TF32 (lo = 0 and unused), f32 is split
template <typename T>
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, float>::value) {
    split(x, hi, lo);
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// d += a b: one m16n8k8 TF32 product with f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const void* u;
  const float* s_in;
  float* y;
  float* s_out;
  int T, H;
  long long r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh;
};

// ---------------------------------------------------------------------------
// wkv_state_kernel: the chunks in order, the state in registers
// ---------------------------------------------------------------------------

// Warp roles and shared memory (bytes; every region a multiple of 16).
template <typename T, int HD>
struct StateLayout {
  // consumers: a block takes half of a head's value rows (two blocks a head),
  // a warp 16 of them and half of the key columns; the two warps of a row
  // tile add their halves of y through shared memory
  static constexpr int kRowTiles = HD / 32;
  static constexpr int kConsumers = 2 * kRowTiles;
  static constexpr int kProducerThreads = 128;           // 4 warps: the loads, the decays
  static constexpr int kThreads = 32 * kConsumers + kProducerThreads;
  static constexpr int kPV = HD + 8;                     // v's row pitch (elements)
  static constexpr int kPD = HD + 8;                     // r_dec's and k_dec's (words)
  static constexpr int kStageRK = kC * HD * (int)sizeof(T);
  static constexpr int kStageW = kC * HD * 4;
  static constexpr int kStageV = kC * kPV * (int)sizeof(T);
  static constexpr int kStage = 2 * kStageRK + kStageW + kStageV;
  static constexpr int kDec = kC * kPD * 4;              // one [kC][kPD] array of words
  static constexpr int kYPart = kRowTiles * 16 * 32 * 4;  // the second halves of y
  // r_dec and k_dec stored split (hi, lo arrays) where that fits beside three
  // stages, else as f32
  static constexpr bool kPreSplit = 3 * kStage + 2 * 4 * kDec + 2 * HD * 4 + kYPart <= 232448;
  static constexpr int kDecArrays = kPreSplit ? 4 : 2;   // per buffer: r, k (, r lo, k lo)
  static constexpr int kDecWords = kDecArrays * kC * kPD;
  static constexpr int kWork = 2 * kDecWords * 4 + 2 * HD * 4 + kYPart;   // two buffers
  // three stages (the loads a chunk ahead of the decays) where they fit, else two
  static constexpr int kStages = 3 * kStage + kWork <= 232448 ? 3 : 2;
  static constexpr int kBytes = kStages * kStage + kWork;
  static_assert(kStage % 16 == 0 && kDec % 16 == 0 && (kPV * (int)sizeof(T)) % 16 == 0,
                "regions and rows must stay 16-byte aligned");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// Issue the cp.async copies of chunk c's r, k, logw and v into a stage (no
// commit), by the producer threads p = 0 .. 127.
template <typename T, int HD>
__device__ __forceinline__ void load_stage(const Args& a, int b, int h, int c, char* stage,
                                           int p) {
  using L = StateLayout<T, HD>;
  constexpr int kVec = 16 / (int)sizeof(T);    // elements per 16-byte copy
  constexpr int kRow = HD / kVec;
  constexpr int kRowW = HD / 4;
  const long long t0 = static_cast<long long>(c) * kC;
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + t0 * a.r_st + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + t0 * a.k_st + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + t0 * a.v_st + h * a.v_sh;
  const float* w = a.lw + b * a.w_sb + t0 * a.w_st + h * a.w_sh;
  T* sr = reinterpret_cast<T*>(stage);
  T* sk = sr + kC * HD;
  float* sw = reinterpret_cast<float*>(stage + 2 * L::kStageRK);
  T* sv = reinterpret_cast<T*>(stage + 2 * L::kStageRK + L::kStageW);
  for (int i = p; i < kC * kRow; i += L::kProducerThreads) {
    const int t = i / kRow, q = (i % kRow) * kVec;
    cp_async16(sr + t * HD + q, r + t * a.r_st + q);
    cp_async16(sk + t * HD + q, k + t * a.k_st + q);
    cp_async16(sv + t * L::kPV + q, v + t * a.v_st + q);
  }
  for (int i = p; i < kC * kRowW; i += L::kProducerThreads) {
    const int t = i / kRowW, q = (i % kRowW) * 4;
    cp_async16(sw + t * HD + q, w + t * a.w_st + q);
  }
}

template <int kCount>
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCount) : "memory");
}

// One decayed value into its buffer: split into (hi, lo) words, or as f32.
template <bool kPreSplit>
__device__ __forceinline__ void put_dec(uint32_t* hi, uint32_t* lo, int i, float x) {
  if constexpr (kPreSplit) {
    split(x, hi[i], lo[i]);
  } else {
    reinterpret_cast<float*>(hi)[i] = x;
  }
}
// The (hi, lo) pair of a decayed value, split on load when stored as f32.
template <bool kPreSplit>
__device__ __forceinline__ void get_dec(const uint32_t* hi, const uint32_t* lo, int i,
                                        uint32_t& h, uint32_t& l) {
  if constexpr (kPreSplit) {
    h = hi[i];
    l = lo[i];
  } else {
    split(reinterpret_cast<const float*>(hi)[i], h, l);
  }
}

// The producers' part of a chunk: the cumulative sums of logw, sequential in t
// in f32 as the plain version's, and r_dec = r e^cum_prev, k_dec = k
// e^(total - cum), e^total; a thread takes a channel and side. Both sides
// share one code path, their difference selected per value and not
// branched, which keeps the kernel's code small: producers and consumers run
// different code at once. The column is read into registers first so that
// the loads are not held behind the stores.
template <typename T, int HD>
__device__ __forceinline__ void decays(const char* st, uint32_t* dec, float* etot, int p) {
  using L = StateLayout<T, HD>;
  constexpr int kPD = L::kPD;
  const T* sr = reinterpret_cast<const T*>(st);
  const T* sk = sr + kC * HD;
  const float* sw = reinterpret_cast<const float*>(st + 2 * L::kStageRK);
  for (int cs = p; cs < 2 * HD; cs += L::kProducerThreads) {
    const int d = cs % HD;
    const bool kside = cs >= HD;               // k_dec and e^total, else r_dec
    const T* src = kside ? sk : sr;
    float w[kC], x[kC], cum[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      w[t] = sw[t * HD + d];
      x[t] = to_float(src[t * HD + d]);
    }
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      acc += w[t];
      cum[t] = acc;
    }
    uint32_t* hi = dec + (kside ? kC * kPD : 0);
    uint32_t* lo = hi + 2 * kC * kPD;          // used only when pre-split
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      put_dec<L::kPreSplit>(hi, lo, t * kPD + d, x[t] * expf(kside ? acc - cum[t] : cum[t] - w[t]));
    }
    if (kside) etot[d] = expf(acc);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(StateLayout<T, HD>::kThreads, 1) wkv_state_kernel(Args a) {
  using L = StateLayout<T, HD>;
  constexpr int kPD = L::kPD, kPV = L::kPV, kDecWords = L::kDecWords;
  constexpr int kNK = HD / 16;                 // key-column tiles of S^T a warp holds
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem + L::kStages * L::kStage);   // [2][...]
  float* etot = reinterpret_cast<float*>(dec + 2 * kDecWords);                   // [2][HD]
  float* ypart = etot + 2 * HD;                // [kRowTiles][16][32]

  const int jh = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nc = a.T / kC;
  const bool producer = tid >= 32 * L::kConsumers;
  const int p = tid - 32 * L::kConsumers;       // producer thread index

  if (producer) {
    for (int c = 0; c < L::kStages - 1; ++c) {
      if (c < nc) load_stage<T, HD>(a, b, h, c, smem + c * L::kStage, p);
      cp_async_commit();
    }
    cp_async_wait<L::kStages - 2>();
    named_barrier<L::kProducerThreads>(1);
    decays<T, HD>(smem, dec, etot, p);
  }
  __syncthreads();

  if (producer) {
    for (int c = 0; c < nc; ++c) {
      const int cn = c + L::kStages - 1;       // into the stage chunk c - 1 used
      if (cn < nc) load_stage<T, HD>(a, b, h, cn, smem + (cn % L::kStages) * L::kStage, p);
      cp_async_commit();
      cp_async_wait<L::kStages - 2>();         // chunk c + 1 arrived (this thread's copies)
      named_barrier<L::kProducerThreads>(1);   // ... and every producer's
      if (c + 1 < nc) {
        decays<T, HD>(smem + ((c + 1) % L::kStages) * L::kStage, dec + ((c + 1) & 1) * kDecWords,
                      etot + ((c + 1) & 1) * HD, p);
      }
      __syncthreads();                         // chunk c + 1's decays out, chunk c's products done
    }
    return;
  }

  // the consumers: S^T in the accumulator layout, S[n] holding rows m0 + g,
  // m0 + g + 8 and key columns 8 (n0 + n) + 2 q, + 1
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;       // the mma fragments' row group and column pair
  const int tile = warp % L::kRowTiles;
  const int m0 = jh * (HD / 2) + 16 * tile;    // this warp's 16 value rows
  const int kh = warp / L::kRowTiles;          // which half of the key columns
  const int n0 = kh * kNK;
  float S[kNK][4];
  const long long state_off = (static_cast<long long>(b) * a.H + h) * HD * HD;
  const float* s_in = a.s_in + state_off;
#pragma unroll
  for (int n = 0; n < kNK; ++n) {
    const int kk = 8 * (n0 + n) + 2 * q;
    S[n][0] = s_in[kk * HD + m0 + g];
    S[n][1] = s_in[(kk + 1) * HD + m0 + g];
    S[n][2] = s_in[kk * HD + m0 + g + 8];
    S[n][3] = s_in[(kk + 1) * HD + m0 + g + 8];
  }
  const long long yt = static_cast<long long>(a.H) * HD;   // y's stride between steps
  float* yp = ypart + tile * 16 * 32 + lane;

  for (int c = 0; c < nc; ++c) {
    const uint32_t* rhi = dec + (c & 1) * kDecWords;
    const uint32_t* khi = rhi + kC * kPD;
    const uint32_t* rlo = khi + kC * kPD;
    const uint32_t* klo = rlo + kC * kPD;
    const float* et = etot + (c & 1) * HD;
    const T* sv = reinterpret_cast<const T*>(smem + (c % L::kStages) * L::kStage +
                                             2 * L::kStageRK + L::kStageW);
    // A fragments of v^T (rows j, depth s) for the four steps of 8 over s
    uint32_t vh[4][4], vl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const T* v0 = sv + (8 * ks + q) * kPV + m0 + g;
      operand<T>(to_float(v0[0]), vh[ks][0], vl[ks][0]);
      operand<T>(to_float(v0[8]), vh[ks][1], vl[ks][1]);
      operand<T>(to_float(v0[4 * kPV]), vh[ks][2], vl[ks][2]);
      operand<T>(to_float(v0[4 * kPV + 8]), vh[ks][3], vl[ks][3]);
    }
    // per key tile: y^T += S^T[:, tile] r_dec^T[tile, :] (rows j, columns t,
    // depth kk permuted in the step: k = q -> 2 q, q + 4 -> 2 q + 1), then
    // S^T[:, tile] = e^total S^T[:, tile] + v^T k_dec[:, tile] (depth s) from
    // zero accumulators
    float yb[4][4], ys[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) yb[nt][i] = ys[nt][i] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
      const int kk0 = 8 * (n0 + n);
      uint32_t ah[4], al[4];
      split(S[n][0], ah[0], al[0]);
      split(S[n][2], ah[1], al[1]);
      split(S[n][1], ah[2], al[2]);
      split(S[n][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = (8 * nt + g) * kPD + kk0 + 2 * q;
        uint32_t bh0, bl0, bh1, bl1;
        get_dec<L::kPreSplit>(rhi, rlo, i, bh0, bl0);
        get_dec<L::kPreSplit>(rhi, rlo, i + 1, bh1, bl1);
        mma_tf32(ys[nt], ah, bl0, bl1);
        mma_tf32(ys[nt], al, bh0, bh1);
        mma_tf32(yb[nt], ah, bh0, bh1);
      }
      float ub[4] = {0.0f, 0.0f, 0.0f, 0.0f}, us[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int i = (8 * ks + q) * kPD + kk0 + g;
        uint32_t bh0, bl0, bh1, bl1;
        get_dec<L::kPreSplit>(khi, klo, i, bh0, bl0);
        get_dec<L::kPreSplit>(khi, klo, i + 4 * kPD, bh1, bl1);
        if constexpr (std::is_same<T, float>::value) mma_tf32(us, vl[ks], bh0, bh1);
        mma_tf32(us, vh[ks], bl0, bl1);
        mma_tf32(ub, vh[ks], bh0, bh1);
      }
      const float2 e = *reinterpret_cast<const float2*>(et + kk0 + 2 * q);
      S[n][0] = fmaf(e.x, S[n][0], ub[0] + us[0]);
      S[n][1] = fmaf(e.y, S[n][1], ub[1] + us[1]);
      S[n][2] = fmaf(e.x, S[n][2], ub[2] + us[2]);
      S[n][3] = fmaf(e.y, S[n][3], ub[3] + us[3]);
    }
    // y's inter-chunk part (wkv_intra_kernel adds the rest): the warp on the
    // second half of the key columns hands its sum to the one on the first
    if (kh == 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) yp[(4 * nt + i) * 32] = yb[nt][i] + ys[nt][i];
      }
    }
    named_barrier<32 * L::kConsumers>(2);
    if (kh == 0) {
      float* yc = a.y + ((static_cast<long long>(b) * a.T + static_cast<long long>(c) * kC) *
                         a.H + h) * HD + m0 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long t = 8 * nt + 2 * q;
        yc[t * yt] = yb[nt][0] + ys[nt][0] + yp[(4 * nt) * 32];
        yc[(t + 1) * yt] = yb[nt][1] + ys[nt][1] + yp[(4 * nt + 1) * 32];
        yc[t * yt + 8] = yb[nt][2] + ys[nt][2] + yp[(4 * nt + 2) * 32];
        yc[(t + 1) * yt + 8] = yb[nt][3] + ys[nt][3] + yp[(4 * nt + 3) * 32];
      }
    }
    __syncthreads();                           // chunk c + 1's decays out, chunk c's products done
  }
  float* s_out = a.s_out + state_off;
#pragma unroll
  for (int n = 0; n < kNK; ++n) {
    const int kk = 8 * (n0 + n) + 2 * q;
    s_out[kk * HD + m0 + g] = S[n][0];
    s_out[(kk + 1) * HD + m0 + g] = S[n][1];
    s_out[kk * HD + m0 + g + 8] = S[n][2];
    s_out[(kk + 1) * HD + m0 + g + 8] = S[n][3];
  }
}

// ---------------------------------------------------------------------------
// wkv_intra_kernel: every chunk's intra-chunk part, in parallel
// ---------------------------------------------------------------------------

// Lane i ends with the sum over the warp's lanes of v[i]; v is consumed.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = lane & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return v[0];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in bytes; every region a multiple of 16.
template <typename T, int HD>
struct IntraLayout {
  static constexpr int kThreads = 2 * HD;                // HD / 16 warps, 4 or 8
  static constexpr int kPX = HD + 4;                     // r~ and k~ rows (mma reads)
  static constexpr int kAP = kC + 4;                     // the scores' rows (float4 reads)
  static constexpr int kRKV = kC * HD * (int)sizeof(T);  // each of r, k, v as staged
  static constexpr int kW = kC * HD * 4;                 // logw, cum_prev, cum: [kC][HD]
  static constexpr int kKX = 6 * kSub * kPX * 4;         // k~ for sub-chunks 1..3: 8 + 16 + 24
                                                         // rows; the mma's padding rows past
                                                         // them read r~
  static constexpr int kRX = (kC - kSub) * kPX * 4;      // r~ of sub-chunks 1..3: [24][kPX]
  static constexpr int kScores = kC * kAP * 4;           // in logw's place once it is read
  static_assert(kScores <= kW, "the scores take logw's place");
  static constexpr int kBytes = 3 * kRKV + 3 * kW + kKX + kRX + HD * 4;
  static_assert(kRKV % 16 == 0 && kRX % 16 == 0 && kKX % 16 == 0 && kScores % 16 == 0,
                "regions must stay 16-byte aligned");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD) wkv_intra_kernel(Args a) {
  using L = IntraLayout<T, HD>;
  constexpr int NT = L::kThreads, PX = L::kPX, AP = L::kAP, kWarps = NT / 32;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* sr = reinterpret_cast<T*>(smem);                                   // [kC][HD] as staged
  T* sk = sr + kC * HD;
  T* sv = sk + kC * HD;
  float* sw = reinterpret_cast<float*>(smem + 3 * L::kRKV);             // logw [kC][HD]
  float* A = sw;                              // then the scores [kC][AP], 0 where s > t
  float* cps = sw + kC * HD;                                            // cum_prev [kC][HD]
  float* css = cps + kC * HD;                                           // cum [kC][HD]
  float* kx = css + kC * HD;                                            // k~ sets [48][PX]
  float* rx = kx + 6 * kSub * PX;                                       // r~ [24][PX], t - 8
  float* us = rx + (kC - kSub) * PX;                                    // [HD]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = static_cast<long long>(c) * kC;
  {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kRow = HD / kVec;
    const T* r = static_cast<const T*>(a.r) + b * a.r_sb + t0 * a.r_st + h * a.r_sh;
    const T* k = static_cast<const T*>(a.k) + b * a.k_sb + t0 * a.k_st + h * a.k_sh;
    const T* v = static_cast<const T*>(a.v) + b * a.v_sb + t0 * a.v_st + h * a.v_sh;
    const float* w = a.lw + b * a.w_sb + t0 * a.w_st + h * a.w_sh;
    for (int i = tid; i < kC * kRow; i += NT) {
      const int t = i / kRow, x = (i % kRow) * kVec;
      cp_async16(sr + t * HD + x, r + t * a.r_st + x);
      cp_async16(sk + t * HD + x, k + t * a.k_st + x);
      cp_async16(sv + t * HD + x, v + t * a.v_st + x);
    }
    for (int i = tid; i < kC * HD / 4; i += NT) {
      const int t = i / (HD / 4), x = (i % (HD / 4)) * 4;
      cp_async16(sw + t * HD + x, w + t * a.w_st + x);
    }
    cp_async_commit();
  }
  // y's inter-chunk part (wkv_state_kernel's), in flight while the scores form:
  // thread (j, half) adds to y[t][j] for t = half, half + 2, ...
  const int j = tid % HD;
  float* yc = a.y + ((static_cast<long long>(b) * a.T + t0) * a.H + h) * HD + j;
  const long long yt = static_cast<long long>(a.H) * HD;
  float yv[kC / 2];
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) yv[i] = yc[(tid / HD + 2 * i) * yt];
  if (tid < HD) us[tid] = to_float(static_cast<const T*>(a.u)[h * HD + tid]);
  cp_async_wait<0>();
  __syncthreads();

  // 1. per channel and side: the cumulative sums (the plain version's, to the
  //    bit) and the factors of the blocks below the diagonal. For sub-chunk
  //    n = 1..3 (steps 8 n ..) and g_n = cum_prev[8 n]: r~[t] = r[t]
  //    e^(cum_prev[t] - g_n) for t in it, k~_n[s] = k[s] e^(g_n - cum[s]) for s
  //    < 8 n; both exponents <= 0, cum does not increase.
  {
    const int d = tid % HD;
    const bool kside = tid >= HD;
    float w[kC], x[kC], cum[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      w[t] = sw[t * HD + d];
      x[t] = to_float((kside ? sk : sr)[t * HD + d]);
    }
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      acc += w[t];
      cum[t] = acc;
    }
    if (!kside) {
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float cp = cum[t] - w[t];
        cps[t * HD + d] = cp;
        css[t * HD + d] = cum[t];
        if (t >= kSub) {
          const int n = t / kSub;
          rx[(t - kSub) * PX + d] = x[t] * expf(cp - (cum[kSub * n] - w[kSub * n]));
        }
      }
    } else {
#pragma unroll
      for (int n = 1; n < 4; ++n) {
        const float g = cum[8 * n] - w[8 * n];
        const int base = 4 * n * (n - 1);      // sets of 8, 16, 24 rows at 0, 8, 24
#pragma unroll
        for (int s = 0; s < 8 * n; ++s) kx[(base + s) * PX + d] = x[s] * expf(g - cum[s]);
      }
    }
  }
  __syncthreads();

  // 2. the scores, into logw's place: zeros above the diagonal, and
  for (int i = tid; i < kC * AP; i += NT) {
    if (i % AP > i / AP) A[i] = 0.0f;
  }
  // 2a. below the diagonal blocks, on the tensor cores with the split: job m of
  //     (n, rows) = (1, 0..15), (2, 0..15), (3, 0..15), (3, 16..31) forms
  //     A^T[s][t] = sum_d k~_n[s][d] r~[t][d] for t in sub-chunk n (rows past
  //     8 n are padding and dropped)
  {
    const int m = (warp + kWarps - 4) % kWarps;
    if (m < 4) {
      const int n = m < 2 ? m + 1 : 3;
      const int row0 = m == 3 ? 16 : 0;
      const int g = lane >> 2, q = lane & 3;
      const float* a0 = kx + (4 * n * (n - 1) + row0 + g) * PX + q;
      const float* b0 = rx + (8 * (n - 1) + g) * PX + q;
      float sb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
        split(a0[8 * ks], ah[0], al[0]);
        split(a0[8 * ks + 8 * PX], ah[1], al[1]);
        split(a0[8 * ks + 4], ah[2], al[2]);
        split(a0[8 * ks + 8 * PX + 4], ah[3], al[3]);
        split(b0[8 * ks], bh0, bl0);
        split(b0[8 * ks + 4], bh1, bl1);
        mma_tf32(ss, ah, bl0, bl1);
        mma_tf32(ss, al, bh0, bh1);
        mma_tf32(sb, ah, bh0, bh1);
      }
      const int s = row0 + g, t = 8 * n + 2 * q;
      if (s < 8 * n) {
        A[t * AP + s] = sb[0] + ss[0];
        A[(t + 1) * AP + s] = sb[1] + ss[1];
      }
      if (s + 8 < 8 * n) {
        A[t * AP + s + 8] = sb[2] + ss[2];
        A[(t + 1) * AP + s + 8] = sb[3] + ss[3];
      }
    }
  }
  // 2b. the 28 pairs inside sub-chunk `warp` (warps 0..3) and its 8 bonus terms,
  //     direct: lanes over channels, then summed across the warp
  if (warp < 4) {
    const int t0s = 8 * warp;
    float v[32], vb[4];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) vb[i] = 0.0f;
#pragma unroll
    for (int dd = lane; dd < HD; dd += 32) {
      float rr[8], kk[8], cp[8], cs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = (t0s + i) * HD + dd;
        rr[i] = to_float(sr[o]);
        kk[i] = to_float(sk[o]);
        cp[i] = cps[o];
        cs[i] = css[o];
      }
      const float u = us[dd];
      int slot = 0;
#pragma unroll
      for (int tt = 1; tt < 8; ++tt) {
#pragma unroll
        for (int s = 0; s < tt; ++s, ++slot) {
          v[slot] = fmaf(rr[tt] * kk[s], expf(cp[tt] - cs[s]), v[slot]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[28 + i] = fmaf(rr[i] * kk[i], u, v[28 + i]);
        vb[i] = fmaf(rr[4 + i] * kk[4 + i], u, vb[i]);
      }
    }
    const float mine = reduce_scatter32(v, lane);
    int tt = 1, s = lane;                      // slot lane -> (tt, s), tt > s
    while (s >= tt) {
      s -= tt;
      ++tt;
    }
    if (lane < 28) A[(t0s + tt) * AP + t0s + s] = mine;
    else A[(t0s + lane - 28) * (AP + 1)] = mine;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sum = warp_sum(vb[i]);
      if (lane == 0) A[(t0s + 4 + i) * (AP + 1)] = sum;
    }
  }
  __syncthreads();

  // 3. y[t][j] += sum_s A[t][s] v[s][j] (A is 0 above the diagonal), f32 on
  //    the CUDA cores: v's column j in registers, A's rows read 4 at a time
  float vj[kC];
#pragma unroll
  for (int s = 0; s < kC; ++s) vj[s] = to_float(sv[s * HD + j]);
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) {
    const int t = tid / HD + 2 * i;
    const float4* at = reinterpret_cast<const float4*>(A + t * AP);
    float acc = 0.0f;
#pragma unroll
    for (int s4 = 0; s4 < kC / 4; ++s4) {
      const float4 a4 = at[s4];
      acc = fmaf(a4.x, vj[4 * s4], acc);
      acc = fmaf(a4.y, vj[4 * s4 + 1], acc);
      acc = fmaf(a4.z, vj[4 * s4 + 2], acc);
      acc = fmaf(a4.w, vj[4 * s4 + 3], acc);
    }
    yc[t * yt] = yv[i] + acc;
  }
}

// ---------------------------------------------------------------------------
// wkv_scan_kernel: the recurrence step by step, the state in registers
// ---------------------------------------------------------------------------

template <int HD>
struct ScanLayout {
  static constexpr int kColGroups = HD / 4;              // 4 value columns a thread
  static constexpr int kRowGroups = HD / 8;              // 8 key rows a thread
  static constexpr int kThreads = kColGroups * kRowGroups;
  static constexpr int kBytes = 4 * (5 * HD + kRowGroups * HD);   // r, k, w, v, u; partial y
};

template <typename T, int HD>
__global__ void __launch_bounds__(HD * HD / 32) wkv_scan_kernel(Args a) {
  using L = ScanLayout<HD>;
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  float* ks = rs + HD;
  float* ws = ks + HD;
  float* vs = ws + HD;
  float* us = vs + HD;
  float* part = us + HD;                       // [kRowGroups][HD]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int j0 = 4 * (tid % L::kColGroups), rg = tid / L::kColGroups, kk0 = 8 * rg;
  const long long state_off = (static_cast<long long>(b) * a.H + h) * HD * HD;
  float4 S[8];
  {
    const float* s_in = a.s_in + state_off;
#pragma unroll
    for (int i = 0; i < 8; ++i) S[i] = *reinterpret_cast<const float4*>(s_in + (kk0 + i) * HD + j0);
  }
  if (tid < HD) us[tid] = to_float(static_cast<const T*>(a.u)[h * HD + tid]);
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* lw = a.lw + b * a.w_sb + h * a.w_sh;
  float* y = a.y + (static_cast<long long>(b) * a.T * a.H + h) * HD;
  for (int t = 0; t < a.T; ++t) {
    if (tid < HD) {
      rs[tid] = to_float(r[t * a.r_st + tid]);
      ks[tid] = to_float(k[t * a.k_st + tid]);
      ws[tid] = expf(lw[t * a.w_st + tid]);
      vs[tid] = to_float(v[t * a.v_st + tid]);
    }
    __syncthreads();
    const float4 vv = *reinterpret_cast<const float4*>(vs + j0);
    float4 yp = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = kk0 + i;
      const float rr = rs[kk], kr = ks[kk], uk = us[kk], w = ws[kk];
      const float4 kv = make_float4(kr * vv.x, kr * vv.y, kr * vv.z, kr * vv.w);
      yp.x = fmaf(rr, S[i].x + uk * kv.x, yp.x);
      yp.y = fmaf(rr, S[i].y + uk * kv.y, yp.y);
      yp.z = fmaf(rr, S[i].z + uk * kv.z, yp.z);
      yp.w = fmaf(rr, S[i].w + uk * kv.w, yp.w);
      S[i].x = w * S[i].x + kv.x;
      S[i].y = w * S[i].y + kv.y;
      S[i].z = w * S[i].z + kv.z;
      S[i].w = w * S[i].w + kv.w;
    }
    *reinterpret_cast<float4*>(part + rg * HD + j0) = yp;
    __syncthreads();
    if (tid < HD) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < L::kRowGroups; ++i) acc += part[i * HD + tid];
      y[static_cast<long long>(t) * a.H * HD + tid] = acc;
    }
    __syncthreads();                           // rs .. part are rewritten by the next step
  }
  float* s_out = a.s_out + state_off;
#pragma unroll
  for (int i = 0; i < 8; ++i) *reinterpret_cast<float4*>(s_out + (kk0 + i) * HD + j0) = S[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, int threads, int smem, const Args& a,
                          cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
int launch_chunked(const Args& a, int B, cudaStream_t s) {
  cudaError_t err = launch_kernel(wkv_state_kernel<T, HD>, dim3(2, a.H, B),
                                  StateLayout<T, HD>::kThreads, StateLayout<T, HD>::kBytes, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_kernel(wkv_intra_kernel<T, HD>, dim3(a.T / kC, a.H, B), 2 * HD,
                      IntraLayout<T, HD>::kBytes, a, s);
  return static_cast<int>(err);
}

template <typename T, int HD>
int launch_scan(const Args& a, int B, cudaStream_t s) {
  return static_cast<int>(launch_kernel(wkv_scan_kernel<T, HD>, dim3(a.H, B),
                                        ScanLayout<HD>::kThreads, ScanLayout<HD>::kBytes, a, s));
}

}  // namespace

// The two C entry points share one argument list. r, k, v: (B, T, H, hd) of
// dtype (0 f32, 1 bf16) read with strides (elements) over (b, t, h) and unit
// stride over hd, rows 16-byte aligned (the wrapper checks); logw likewise in
// f32; u (H, hd) contiguous of dtype; s_in and s_out (B, H, hd, hd) f32
// contiguous; y (B, T, H, hd) f32 contiguous; hd 64 or 128. Each returns
// the cudaError_t of its launches (0 on success).
//
// wkv_forward: the chunked route, T a positive multiple of 32; s_out must
// not overlap s_in.
extern "C" int wkv_forward(const void* r, const void* k, const void* v, const float* lw,
                           const void* u, const float* s_in, float* y, float* s_out, int dtype,
                           int B, int T, int H, int hd, long long r_sb, long long r_st,
                           long long r_sh, long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh, long long w_sb,
                           long long w_st, long long w_sh, int device, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || T < kC || T % kC != 0 ||
      (hd != 64 && hd != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a{r, k, v, lw, u, s_in, y, s_out, T, H,
         r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    return dtype == 0 ? launch_chunked<float, 64>(a, B, s)
                      : launch_chunked<__nv_bfloat16, 64>(a, B, s);
  }
  return dtype == 0 ? launch_chunked<float, 128>(a, B, s)
                    : launch_chunked<__nv_bfloat16, 128>(a, B, s);
}

// wkv_scan_forward: the sequential route, any T >= 1; s_out may be s_in
// (the state updated in place).
extern "C" int wkv_scan_forward(const void* r, const void* k, const void* v, const float* lw,
                                const void* u, const float* s_in, float* y, float* s_out,
                                int dtype, int B, int T, int H, int hd, long long r_sb,
                                long long r_st, long long r_sh, long long k_sb, long long k_st,
                                long long k_sh, long long v_sb, long long v_st, long long v_sh,
                                long long w_sb, long long w_st, long long w_sh, int device,
                                void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || T < 1 || (hd != 64 && hd != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a{r, k, v, lw, u, s_in, y, s_out, T, H,
         r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, w_sb, w_st, w_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    return dtype == 0 ? launch_scan<float, 64>(a, B, s) : launch_scan<__nv_bfloat16, 64>(a, B, s);
  }
  return dtype == 0 ? launch_scan<float, 128>(a, B, s) : launch_scan<__nv_bfloat16, 128>(a, B, s);
}

// The dynamic shared memory a kernel of this source asks for, in bytes:
// kernel 0 wkv_state_kernel, 1 wkv_intra_kernel, 2 wkv_scan_kernel; dtype and
// hd as above. -1 for anything else.
extern "C" int wkv_smem_bytes(int kernel, int dtype, int hd) {
  if ((dtype != 0 && dtype != 1) || (hd != 64 && hd != 128)) return -1;
  const bool f = dtype == 0, h64 = hd == 64;
  switch (kernel) {
    case 0:
      return f ? (h64 ? StateLayout<float, 64>::kBytes : StateLayout<float, 128>::kBytes)
               : (h64 ? StateLayout<__nv_bfloat16, 64>::kBytes
                      : StateLayout<__nv_bfloat16, 128>::kBytes);
    case 1:
      return f ? (h64 ? IntraLayout<float, 64>::kBytes : IntraLayout<float, 128>::kBytes)
               : (h64 ? IntraLayout<__nv_bfloat16, 64>::kBytes
                      : IntraLayout<__nv_bfloat16, 128>::kBytes);
    case 2:
      return h64 ? ScanLayout<64>::kBytes : ScanLayout<128>::kBytes;
    default:
      return -1;
  }
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
