// Causal GQA prefill attention and one-token GQA decode attention.
//
// Replace the TPU kernels repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel, pallas_call at flash_attention.py:113) and
// decode_attention_pallas (_decode_kernel, pallas_call at :204). Both compute
// what those compute: s = (q . k) * (1 / sqrt(hd)) in f32, masked entries
// -1e30, an online softmax over key blocks with f32 running max m, sum l and
// accumulator acc, out = acc / (l == 0 ? 1 : l) in q's dtype. Head h reads
// KV head h / G, G = H / KV. Inputs are f32 or bf16 (T), hd in {64, 128,
// 256}; the C functions refuse anything else.
//
// The caller is the model zoo's dense transformer (models/attention.py):
// flash_attention for every layer of forward and prefill, decode_attention
// for every layer of decode_step.
//
// Bounds on one H100 SXM. Prefill (qwen3-0.6b: B 1, H 16, KV 8, S 8,192,
// hd 128, bf16) does 4 * S (S + 1) / 2 * H * hd = 0.275 TFLOP for 101 MB of
// q, k, v and out: 0.28 ms at the 989 TFLOP/s bf16 tensor-core peak, so it
// is bound by operations. Decode (B 8, S 32,768, KV 8, hd 128, bf16) reads
// 1.07 GB of cache for 2.1 GFLOP: 0.32 ms at 3.35 TB/s, bound by bytes.
//
// Design, prefill (flash_prefill_kernel). One block of 128 threads per
// (b, h, block of 64 query rows), the heaviest causal blocks first. The
// q block is staged once in shared memory as f32, transposed (Qt[d][r]);
// each key block of 32 keys is staged as f32 (Kt[d][c] transposed, Vs[c][d])
// from 16-byte loads that read the given strides, so (B, S, H, hd) tensors
// are read in place. Each thread forms a 4 x 4 tile of scores from float4
// reads of Qt and Kt (16 fma per two shared loads), the row max and sum go
// over the eight threads that share the rows by warp shuffles in a fixed
// order, p goes to shared memory, and each thread then accumulates an
// 8-row x (hd / 16)-column tile of p @ v in registers. Key blocks past the
// causal frontier or before the window are skipped, as _flash_kernel's
// pl.when does. All of it runs on the CUDA cores in f32: the scores and
// probabilities must not be rounded to bf16, so the bf16 tensor cores
// (mma.sync, wgmma) are later work, and the kernel is far above its bound.
//
// Design, decode (decode_split_kernel + decode_combine_kernel). A grid of
// (B, KV) blocks alone is 64 blocks at the decode shape on 132 SMs, so S is
// split into chunks of 512 slots: one block per (chunk, KV head, up to 8 of
// its query heads, b). The block stages 64-slot tiles of k and v (32 for
// f32 at hd 256) in shared memory with cp.async, double-buffered (the next
// tile loads while this one computes), in their own dtype; the G query
// heads of one KV head share each tile, so every cache byte is read once.
// A thread scores one slot against its query heads, one warp per head takes
// the tile's max and sum, and each thread accumulates two columns of p @ v
// per head. Each block writes its (m, l, acc) to a workspace; the combine
// kernel folds the chunks of a row in chunk order: M = max m_i,
// out = sum e^(m_i - M) acc_i / sum e^(m_i - M) l_i.
// Chunks at or past a row's length are skipped. A row of length 0 attends
// to every slot with every score masked: the mean of v over all S slots, as
// repro/kernels/ref.py::decode_attention_ref gives (the Pallas kernel gives
// 0 there). No atomics anywhere: the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// prefill tiling
constexpr int kPrefillThreads = 128;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per staged tile
constexpr int kPtStride = kBQ + 4;  // Pt row stride (floats): fewer bank conflicts on writes

// decode tiling
constexpr int kDecodeThreads = 128;
constexpr int kSplit = 512;         // cache slots per block (a multiple of every tile)
constexpr int kGroup = 8;           // query heads per block at most

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;    // elements per 16-byte load
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
  __device__ static void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, G, S, window;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

template <int HD>
__host__ __device__ constexpr int prefill_smem_bytes() {
  return 4 * (HD * kBQ + HD * kBK + kBK * HD + kBK * kPtStride + 2 * kBQ);
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kPrefillThreads) flash_prefill_kernel(PrefillArgs a) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  constexpr int kChunks = HD / kVec;       // 16-byte vectors per row
  constexpr int kDCols = HD / 16;          // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);     // [HD][kBQ]
  float* Kt = Qt + HD * kBQ;                       // [HD][kBK]
  float* Vs = Kt + HD * kBK;                       // [kBK][HD]
  float* Pt = Vs + kBK * HD;                       // [kBK][kPtStride]
  float* s_alpha = Pt + kBK * kPtStride;           // [kBQ]
  float* s_l = s_alpha + kBQ;                      // [kBQ]

  const int tid = threadIdx.x;
  const int iq = gridDim.x - 1 - blockIdx.x;       // heaviest (latest) query blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int S = a.S;
  const int q_lo = iq * kBQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // stage the q block, transposed: item (r, chunk), r fastest
  for (int it = tid; it < kBQ * kChunks; it += kPrefillThreads) {
    const int r = it % kBQ, ch = it / kBQ;
    float f[kVec];
    if (q_lo + r < S) {
      E::unpack(*reinterpret_cast<const uint4*>(q + (q_lo + r) * a.q_ss + ch * kVec), f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) Qt[(ch * kVec + e) * kBQ + r] = f[e];
  }

  // score layout: rows ry*4 .. +3, columns cx*4 .. +3 of the (kBQ, kBK) tile;
  // the eight threads of a row group are eight consecutive lanes
  const int ry = tid / 8, cx = tid % 8;
  // p @ v layout: rows rg*8 .. +7, columns j*64 + dg*4 .. +3
  const int rg = tid / 16, dg = tid % 16;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
  }
  float acc[8][kDCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.0f;

  const int q_hi = min(q_lo + kBQ - 1, S - 1);
  const int kt_first = a.window ? max(0, q_lo - a.window + 1) / kBK : 0;
  const int kt_last = q_hi / kBK;
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();   // the previous tile's Kt, Vs, Pt are consumed
    for (int it = tid; it < kBK * kChunks; it += kPrefillThreads) {
      const int c = it % kBK, ch = it / kBK;       // Kt: c fastest (transposed writes)
      float f[kVec];
      if (k_lo + c < S) {
        E::unpack(*reinterpret_cast<const uint4*>(k + (k_lo + c) * a.k_ss + ch * kVec), f);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) Kt[(ch * kVec + e) * kBK + c] = f[e];
    }
    for (int it = tid; it < kBK * kChunks; it += kPrefillThreads) {
      const int ch = it % kChunks, c = it / kChunks;   // Vs: along the row
      float f[kVec];
      if (k_lo + c < S) {
        E::unpack(*reinterpret_cast<const uint4*>(v + (k_lo + c) * a.v_ss + ch * kVec), f);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(&Vs[c * HD + ch * kVec + e]) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kBQ + ry * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * kBK + cx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_lo + ry * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k_lo + cx * 4 + j;
        const bool ok = kj <= qi && (a.window == 0 || kj > qi - a.window);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = alpha * l_run[i] + sum;
      m_run[i] = m_new;
      if (cx == 0) s_alpha[ry * 4 + i] = alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&Pt[(cx * 4 + j) * kPtStride + ry * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = s_alpha[rg * 8 + i];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p0 = *reinterpret_cast<const float4*>(&Pt[c * kPtStride + rg * 8]);
      const float4 p1 = *reinterpret_cast<const float4*>(&Pt[c * kPtStride + rg * 8 + 4]);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int j = 0; j < HD / 64; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * HD + j * 64 + dg * 4]);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j * 4 + e] = fmaf(pv[i], vc[e], acc[i][j * 4 + e]);
      }
    }
  }

  if (cx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s_l[ry * 4 + i] = l_run[i];
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    if (q_lo + r >= S) continue;
    float denom = s_l[r];
    denom = denom == 0.0f ? 1.0f : denom;
#pragma unroll
    for (int j = 0; j < HD / 64; ++j) {
      E::store4(out + (q_lo + r) * a.o_ss + j * 64 + dg * 4, acc[i][j * 4] / denom,
                acc[i][j * 4 + 1] / denom, acc[i][j * 4 + 2] / denom, acc[i][j * 4 + 3] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* work;
  int H, KV, G, S, heads_per_block, head_chunks, splits;
  float scale;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
};

// cache slots per staged tile: 64, or 32 where a row is over 512 bytes (f32,
// hd 256), so that two buffers of k and v fit in shared memory
template <typename T, int HD>
__host__ __device__ constexpr int decode_tile() {
  return HD * static_cast<int>(sizeof(T)) > 512 ? 32 : 64;
}

template <typename T, int HD>
__host__ __device__ constexpr int decode_k_stride() {
  return HD + 16 / static_cast<int>(sizeof(T));   // one 16-byte vector of padding a row
}

template <typename T, int HD>
__host__ __device__ constexpr int decode_smem_bytes() {
  constexpr int tile = decode_tile<T, HD>();
  return 2 * tile * decode_k_stride<T, HD>() * static_cast<int>(sizeof(T))   // Ks, 2 buffers
         + 2 * tile * HD * static_cast<int>(sizeof(T))                       // Vs, 2 buffers
         + 4 * (kGroup * HD + kGroup * tile + 3 * kGroup);                    // qs, ps, m l alpha
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

// workspace row of one (b, kv, head chunk, split): heads_per_block entries of
// (m, l, acc[HD])
__device__ __forceinline__ float* work_row(const DecodeArgs& a, int b, int y, int split, int HD) {
  const long long row =
      (static_cast<long long>(b) * a.KV * a.head_chunks + y) * a.splits + split;
  return a.work + row * a.heads_per_block * (HD + 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeThreads) decode_split_kernel(DecodeArgs a) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  constexpr int kChunks = HD / kVec;
  constexpr int kTile = decode_tile<T, HD>();
  constexpr int kKs = decode_k_stride<T, HD>();
  constexpr int kPairs = HD / 2;                                   // column pairs a head
  constexpr int kItems = (kGroup * kPairs + kDecodeThreads - 1) / kDecodeThreads;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);                             // [2][kTile][kKs]
  T* Vs = Ks + 2 * kTile * kKs;                                    // [2][kTile][HD]
  float* qs = reinterpret_cast<float*>(Vs + 2 * kTile * HD);       // [kGroup][HD]
  float* ps = qs + kGroup * HD;                                    // [kGroup][kTile]
  float* s_m = ps + kGroup * kTile;
  float* s_l = s_m + kGroup;
  float* s_alpha = s_l + kGroup;

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int y = blockIdx.y;                      // kv * head_chunks + head chunk
  const int b = blockIdx.z;
  const int kvh = y / a.head_chunks;
  const int g0 = (y % a.head_chunks) * a.heads_per_block;
  const int gc = min(a.heads_per_block, a.G - g0);
  const int len = a.lengths[b];
  const int eff = len == 0 ? a.S : len;          // length 0: every slot, every score masked
  const int s0 = split * kSplit;
  if (s0 >= eff) return;                         // the combine skips this chunk too
  const int s1 = min(s0 + kSplit, eff);
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (kvh * a.G + g0) * a.q_sh;

  auto stage = [&](int lo, int buf) {
    const int n = min(kTile, s1 - lo);
    T* kd = Ks + buf * kTile * kKs;
    T* vd = Vs + buf * kTile * HD;
    for (int it = tid; it < n * kChunks; it += kDecodeThreads) {
      const int c = it / kChunks, ch = it % kChunks;
      cp_async16(kd + c * kKs + ch * kVec, k + (lo + c) * a.k_ss + ch * kVec);
      cp_async16(vd + c * HD + ch * kVec, v + (lo + c) * a.v_ss + ch * kVec);
    }
    cp_async_commit();
  };
  stage(s0, 0);

  for (int i = tid; i < gc * HD; i += kDecodeThreads) {
    qs[i] = E::load(q + (i / HD) * a.q_sh + i % HD);
  }
  if (tid < kGroup) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.0f;
  }
  float2 acc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) acc[i] = make_float2(0.0f, 0.0f);

  const int warp = tid / 32, lane = tid % 32;
  int buf = 0;
  for (int lo = s0; lo < s1; lo += kTile, buf ^= 1) {
    const int n = min(kTile, s1 - lo);
    if (lo + kTile < s1) {
      stage(lo + kTile, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = Ks + buf * kTile * kKs;
    const T* vt = Vs + buf * kTile * HD;

    // scores: thread -> slot c, heads g = tid / kTile + step * (threads / kTile)
    {
      const int c = tid % kTile;
      constexpr int kStep = kDecodeThreads / kTile;
      float sc[kGroup / kStep];
#pragma unroll
      for (int i = 0; i < kGroup / kStep; ++i) sc[i] = 0.0f;
      if (c < n) {
#pragma unroll 4
        for (int ch = 0; ch < kChunks; ++ch) {
          float f[kVec];
          E::unpack(*reinterpret_cast<const uint4*>(kt + c * kKs + ch * kVec), f);
#pragma unroll
          for (int i = 0; i < kGroup / kStep; ++i) {
            const int g = tid / kTile + i * kStep;
            if (g < gc) {
              const float* qg = qs + g * HD + ch * kVec;
#pragma unroll
              for (int e = 0; e < kVec; ++e) sc[i] = fmaf(qg[e], f[e], sc[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kGroup / kStep; ++i) {
          const int g = tid / kTile + i * kStep;
          if (g < gc) ps[g * kTile + c] = lo + c < len ? sc[i] * a.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // softmax over the tile: one warp a head, in a fixed order
    for (int g = warp; g < gc; g += kDecodeThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, ps[g * kTile + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < n; c += 32) {
        const float p = expf(ps[g * kTile + c] - m_new);
        ps[g * kTile + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = alpha * s_l[g] + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // p @ v: item -> (head g, column pair)
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kDecodeThreads;
      const int g = item / kPairs, d2 = item % kPairs;
      if (g < gc) {
        const float al = s_alpha[g];
        float2 r = make_float2(acc[i].x * al, acc[i].y * al);
        const float* pg = ps + g * kTile;
#pragma unroll 8
        for (int c = 0; c < n; ++c) {
          const float p = pg[c];
          const float2 vv = E::load2(vt + c * HD + 2 * d2);
          r.x = fmaf(p, vv.x, r.x);
          r.y = fmaf(p, vv.y, r.y);
        }
        acc[i] = r;
      }
    }
    __syncthreads();   // the buffer is restaged two tiles on
  }

  float* w = work_row(a, b, y, split, HD);
  if (tid < gc) {
    w[tid * (HD + 2)] = s_m[tid];
    w[tid * (HD + 2) + 1] = s_l[tid];
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = tid + i * kDecodeThreads;
    const int g = item / kPairs, d2 = item % kPairs;
    if (g < gc) {
      w[g * (HD + 2) + 2 + 2 * d2] = acc[i].x;
      w[g * (HD + 2) + 3 + 2 * d2] = acc[i].y;
    }
  }
}

// one block of HD threads per (h, b): fold the row's chunks in chunk order
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_combine_kernel(DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / a.G, g = h % a.G;
  const int y = kvh * a.head_chunks + g / a.heads_per_block;
  const int gl = g % a.heads_per_block;
  const int len = a.lengths[b];
  const int eff = len == 0 ? a.S : len;
  const int chunks = (eff + kSplit - 1) / kSplit;
  float m = kNegInf;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, work_row(a, b, y, c, HD)[gl * (HD + 2)]);
  float l = 0.0f, acc = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const float* w = work_row(a, b, y, c, HD) + gl * (HD + 2);
    const float e = expf(w[0] - m);
    l = fmaf(e, w[1], l);
    acc = fmaf(e, w[2 + d], acc);
  }
  l = l == 0.0f ? 1.0f : l;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  out[d] = from_float<T>(acc / l);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HD>
int launch_prefill(const PrefillArgs& a, int B, cudaStream_t s) {
  constexpr int smem = prefill_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_prefill_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_prefill_kernel<T, HD><<<grid, kPrefillThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_decode(const DecodeArgs& a, int B, cudaStream_t s) {
  constexpr int smem = decode_smem_bytes<T, HD>();
  cudaError_t err = allow_smem(decode_split_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T, HD>
      <<<dim3(a.splits, a.KV * a.head_chunks, B), kDecodeThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, HD><<<dim3(a.H, B), HD, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_prefill(int dtype, const PrefillArgs& a, int B, cudaStream_t s) {
  return dtype == 0 ? launch_prefill<float, HD>(a, B, s)
                    : launch_prefill<__nv_bfloat16, HD>(a, B, s);
}

template <int HD>
int dispatch_decode(int dtype, const DecodeArgs& a, int B, cudaStream_t s) {
  return dtype == 0 ? launch_decode<float, HD>(a, B, s)
                    : launch_decode<__nv_bfloat16, HD>(a, B, s);
}

// 1 / sqrt(hd) rounded once to f32, as the Pallas kernels' Python constant
float scale_of(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

bool shape_ok(int dtype, int B, int H, int KV, int S, int hd) {
  return (dtype == 0 || dtype == 1) && B >= 1 && KV >= 1 && H >= KV && H % KV == 0 && S >= 1 &&
         (hd == 64 || hd == 128 || hd == 256);
}

}  // namespace

// q, k, v, out: device pointers of dtype (0 f32, 1 bf16); q (B, H, S, hd),
// k and v (B, KV, S, hd), out (B, H, S, hd), each read with the given
// strides (elements) over (b, head, s) and unit stride over hd; 16-byte
// aligned rows (the wrapper checks). window 0: causal; > 0: sliding window.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int dtype,
                               int B, int H, int KV, int S, int hd, int window, long long q_sb,
                               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss, int device,
                               void* stream) {
  if (!shape_ok(dtype, B, H, KV, S, hd) || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  PrefillArgs a{q, k, v, out, H, H / KV, S, window, scale_of(hd),
                q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dispatch_prefill<64>(dtype, a, B, s);
  if (hd == 128) return dispatch_prefill<128>(dtype, a, B, s);
  return dispatch_prefill<256>(dtype, a, B, s);
}

// Floats of workspace a decode call with these sizes needs (the wrapper
// allocates it); -1 for sizes the kernel does not take.
extern "C" long long decode_attention_workspace(int B, int H, int KV, int S, int hd) {
  if (!shape_ok(0, B, H, KV, S, hd)) return -1;
  const int G = H / KV;
  const int per_block = G < kGroup ? G : kGroup;
  const int chunks = (G + per_block - 1) / per_block;
  const long long splits = (S + kSplit - 1) / kSplit;
  return static_cast<long long>(B) * KV * chunks * splits * per_block * (hd + 2);
}

// q (B, H, hd), k and v the cache (B, S, KV, hd), lengths (B,) int32 in
// [0, S], out (B, H, hd); strides in elements over (b, h) for q and out and
// over (b, s, kv) for k and v, unit stride over hd; work:
// decode_attention_workspace floats. Returns the cudaError_t (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const int* lengths,
                                void* out, float* work, int dtype, int B, int H, int KV, int S,
                                int hd, long long q_sb, long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, long long o_sb, long long o_sh, int device,
                                void* stream) {
  if (!shape_ok(dtype, B, H, KV, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int G = H / KV;
  const int per_block = G < kGroup ? G : kGroup;
  DecodeArgs a{q, k, v, lengths, out, work, H, KV, G, S, per_block,
               (G + per_block - 1) / per_block, (S + kSplit - 1) / kSplit,
               scale_of(hd),
               q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dispatch_decode<64>(dtype, a, B, s);
  if (hd == 128) return dispatch_decode<128>(dtype, a, B, s);
  return dispatch_decode<256>(dtype, a, B, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
