// Causal GQA prefill attention and one-token GQA decode attention.
//
// Replace the TPU kernels repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel, pallas_call at flash_attention.py:113) and
// decode_attention_pallas (_decode_kernel, pallas_call at :204). Both compute
// what those compute: s = (q . k) * (1 / sqrt(hd)) in f32, masked entries
// -1e30, an online softmax over key blocks with f32 running max m, sum l and
// accumulator acc, out = acc / (l == 0 ? 1 : l) in q's dtype. Head h reads
// KV head h / G, G = H / KV. Inputs are f32 or bf16, hd in {64, 128, 256};
// the C functions refuse anything else. The caller is the model zoo's dense
// transformer (models/attention.py): flash_attention for every layer of
// forward and prefill, decode_attention for every layer of decode_step.
//
// Two routes. bf16 runs on the tensor cores (flash_prefill_tc_kernel,
// decode_tc_kernel); f32 keeps the CUDA-core kernels (flash_prefill_kernel,
// decode_split_kernel + decode_combine_kernel), whose products would lose
// bits on the tensor cores.
//
// Bounds on one H100 SXM. Prefill (qwen3-0.6b: B 1, H 16, KV 8, S 8,192,
// hd 128, bf16) does 4 * S (S + 1) / 2 * H * hd = 0.275 TFLOP for 101 MB of
// q, k, v and out: 0.28 ms at the 989 TFLOP/s bf16 tensor-core peak, so it
// is bound by operations; the bf16 route issues 1.5 times that (p @ v
// twice, below), 0.42 ms at the peak. Decode (B 8, S 32,768, KV 8, hd 128,
// bf16) reads 1.07 GB of cache for 2.1 GFLOP: 0.32 ms at 3.35 TB/s, bound by
// bytes.
//
// Precision of the bf16 route. The kernels are held within 1e-5 of each
// output's sum_j p_j |v_j| (plus one bf16 unit of the output) of the f32
// plain version, as the Pallas kernels compute in f32. A product of two bf16
// numbers is exact in f32, so q . k on the tensor cores (bf16 in, f32
// accumulate) keeps the scores. p is not rounded to bf16 alone: it is split
// into p_hi = bf16(p) and p_lo = bf16(p - p_hi), which keep p to 2^-17 of
// itself, and p @ v = p_hi @ v + p_lo @ v, two products summed in f32; l is
// summed from the f32 p. Rounding p to bf16 alone misses the bar wherever a
// row's output cancels (tests/test_torch_attention_split.py).
//
// Prefill, bf16 (flash_prefill_tc_kernel). One block of two warpgroups per
// (b, KV head, its query heads in pairs, a tile of query positions), the
// heaviest (latest) tiles first: with G even each warpgroup takes 64
// positions of one of two heads, else 128 positions of one head, so the G
// heads of a KV head share every staged k and v tile. Thread 0 keeps a ring
// of 2 tiles of 128 keys (64 at hd 256) in flight with TMA (128-byte
// swizzle, mbarriers), the maps made by cuTensorMapEncodeTiled through the
// runtime's driver entry point, so tensors are read in place at their
// strides. S = Q K^T is wgmma m64nNk16 with Q and K K-major in shared
// memory; scale (times log2 e) and masks in f32, masks only on tiles that
// cross the diagonal or the window's edge, tiles past the frontier or before
// the window skipped; an online softmax in registers (base 2 on the
// special-function unit), the row's max over its four threads in a fixed
// shuffle order; then O += p_hi V + p_lo V by wgmma with p as the register A
// fragment (the scores' accumulator layout is that fragment's) and V
// MN-major from the ring, all hd columns in one product. The epilogue
// stores O / l in bf16 to the (B, S, H, hd) strides.
//
// Decode, bf16 (decode_tc_kernel). One block per (chunk of kTcSplit = 1,024
// cache slots, KV head, up to 8 of its query heads, b); chunks past a row's
// length exit at once. Thread 0 keeps 3 tiles of 64 slots (32 at hd 256,
// two warps) in flight with TMA; each warp takes 16 slots of a tile with
// mma.sync m16n8k16: scores Q K^T with the heads as rows (rows 8..15 zero),
// and p @ v with rows g carrying p_hi and rows g + 8 p_lo, so the split costs
// no extra product; K and V^T come from the swizzled ring by ldmatrix. Each
// warp keeps its own (m, l, O); the block folds its warps in warp order and
// writes its chunk's (m, l, acc) to the workspace; a counter in the
// workspace (zeroed on the stream before the launch) names the row's last
// block, which folds the row's chunks in chunk order, never in arrival
// order (M = max m_c, then sum e^(m_c - M) l_c and acc_c), staging them by
// bulk copies. At 96 KB a block, two blocks fit on an SM at every hd.
//
// f32 (the CUDA-core kernels). Prefill: one block of 128 threads per (b, h,
// 64 query rows); q, k and v staged in shared memory as f32, 4 x 4 score
// tiles a thread, p through shared memory. Decode: 512-slot chunks, k and v
// tiles staged by cp.async, one warp a head for the softmax, a second
// launch folds the chunks in chunk order.
//
// Every route: a row of decode length 0 attends to every slot with every
// score masked, the mean of v over all S slots, as
// repro/kernels/ref.py::decode_attention_ref gives (the Pallas kernel gives
// 0 there); no atomics on data, so the same inputs give the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int kTcSplit = 1024;      // cache slots a block of the bf16 route (two f32 chunks)

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
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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
// the bf16 route: tensor cores, TMA, mbarriers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of transactions (the TMA copies) this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier has completed the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Where the logical axes (s, head, b) of a (b, head, s, hd) tensor sit among
// the dims 1..3 of its TMA map (dim 0 is hd): the host orders them by stride.
struct MapAxes {
  int s, h, b;
};

__device__ __forceinline__ int axis_coord(const MapAxes& ax, int dim, int s, int h, int b) {
  return ax.s == dim ? s : (ax.h == dim ? h : b);
}

// TMA: the box of 64 hd columns starting at `col`, at (s, h, b), into shared
// memory at `dst` (1024-byte aligned, 128-byte swizzle), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, const MapAxes& ax,
                                         uint64_t* bar, int col, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(axis_coord(ax, 1, s, h, b)), "r"(axis_coord(ax, 2, s, h, b)),
      "r"(axis_coord(ax, 3, s, h, b))
      : "memory");
}

// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// order this thread's generic writes to shared memory before later async
// (TMA) writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The wgmma descriptor of a bf16 operand in shared memory laid out as TMA's
// 128-byte swizzle writes it: rows of 128 bytes (64 elements), 8-row groups
// 1,024 bytes apart (the SBO, of a K-major operand and an MN-major one
// alike). `lbo` is the stride from one 64-wide block of an MN-major operand
// to the next (unused by a K-major one).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads of asynchronously written registers
// above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), A and B bf16 in shared memory,
// both K-major; accumulate 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), A and B bf16 in shared memory,
// both K-major; accumulate 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragment in registers) B (16 x 64, bf16
// in shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragment in registers) B (16 x 128, bf16
// in shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 fragment in registers) B (16 x 256, bf16
// in shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "key tiles of 64 or 128");
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

// D (16 x 8, f32) += A (16 x 16, bf16) B (16 x 8, bf16), one warp
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p0, p1 (f32) as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi); hi + lo
// keeps p to 2^-17 of itself (the first element in the low half)
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// byte address of 16-byte chunk `chunk` (8 bf16 of hd) of row `row` in a tile
// stored as 64-column blocks of `block_bytes`, each 128-byte swizzled
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int block_bytes, int row, int chunk) {
  return base + (chunk >> 3) * block_bytes + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// 2^x on the special-function unit (about 2 ulp; results below 2^-126 flush
// to 0, far under the tolerance)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x HD) += p_hi V + p_lo V over a tile of kBK keys: p as register A
// fragments, V MN-major in the ring (64-column blocks `block` bytes apart,
// the LBO of the descriptor); one product a 16-key slice and part of p
template <int HD, int kBK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 64][32], const uint32_t (&hi)[kBK / 16][4],
                                         const uint32_t (&lo)[kBK / 16][4], uint32_t v_base,
                                         int block) {
#pragma unroll
  for (int t = 0; t < kBK / 16; ++t) {
    const uint64_t dv = wgmma_desc(v_base + t * 16 * 128, block);
    if constexpr (HD == 64) {
      wgmma_rs_n64(o[0], hi[t], dv);
      wgmma_rs_n64(o[0], lo[t], dv);
    } else if constexpr (HD == 128) {
      float (&ow)[64] = *reinterpret_cast<float (*)[64]>(&o[0][0]);
      wgmma_rs_n128(ow, hi[t], dv);
      wgmma_rs_n128(ow, lo[t], dv);
    } else {
      float (&ow)[128] = *reinterpret_cast<float (*)[128]>(&o[0][0]);
      wgmma_rs_n256(ow, hi[t], dv);
      wgmma_rs_n256(ow, lo[t], dv);
    }
  }
}

// --- prefill: wgmma -------------------------------------------------------

namespace tc {

constexpr int kWarpgroups = 2;               // consumer warpgroups a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64;                    // query rows of a warpgroup (one m64 tile)


template <int HD>
struct Prefill {
  static constexpr int kBK = HD <= 128 ? 128 : 64;   // keys a tile
  static constexpr int kStages = 2;                  // ring of k and v tiles
  static constexpr int kCol = HD / 64;               // 64-column blocks of a row
  static constexpr int kQBlock = kRows * 128;        // bytes of one column block of q
  static constexpr int kKVBlock = kBK * 128;         // ... of k or v
  __host__ __device__ static constexpr int q_off(int w, int c) {
    return (w * kCol + c) * kQBlock;
  }
  __host__ __device__ static constexpr int k_off(int st, int c) {
    return kWarpgroups * kCol * kQBlock + (st * kCol + c) * kKVBlock;
  }
  __host__ __device__ static constexpr int v_off(int st, int c) {
    return k_off(kStages, 0) + (st * kCol + c) * kKVBlock;
  }
  static constexpr int kBarOff = v_off(kStages, 0);
  static constexpr int kSmem = kBarOff + 8 * (2 * kStages + 1) + 1024;   // + alignment slack
};

// --- decode: mma.sync ---------------------------------------------------------

template <int HD>
struct Decode {
  static constexpr int kWarps = HD == 256 ? 2 : 4;   // each takes 16 slots of a tile
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = 16 * kWarps;          // slots a staged tile
  static constexpr int kStages = 3;
  static constexpr int kCol = HD / 64;
  static constexpr int kBlock = kTile * 128;         // bytes of one column block of k or v
  __host__ __device__ static constexpr int k_off(int st, int c) {
    return (st * kCol + c) * kBlock;
  }
  __host__ __device__ static constexpr int v_off(int st, int c) {
    return (kStages * kCol + st * kCol + c) * kBlock;
  }
  static constexpr int kBarOff = 2 * kStages * kCol * kBlock;
  static constexpr int kSmem = kBarOff + 64 + 4 * (2 + kWarps) * kGroup + 8 + 1024;
  static_assert(kTcSplit % kTile == 0 && kTcSplit % kSplit == 0, "a chunk is whole tiles");
  static_assert(kWarps * kGroup * (HD + 2) * 4 <= kBarOff, "the warps' partials fit a ring");
};

}  // namespace tc

struct TcPrefillParams {
  CUtensorMap q_map, k_map, v_map;
  MapAxes q_ax, k_ax, v_ax;
  bf16* out;
  int H, G, S, window, heads_per_block;
  float scale_log2;
  long long o_sb, o_sh, o_ss;
};

// One block of two consumer warpgroups per (b, KV head, its query heads in
// pairs, a tile of query positions); thread 0 also issues the TMA copies.
// Warpgroup w takes query head g0 + w % hb and positions r_lo .. r_lo + 63.
template <int HD>
__global__ void __launch_bounds__(tc::kThreads, 1)
    flash_prefill_tc_kernel(const __grid_constant__ TcPrefillParams p) {
  using L = tc::Prefill<HD>;
  constexpr int kBK = L::kBK;
  constexpr int kTileBytes = 2 * kBK * HD * 2;       // k and v of one tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBarOff);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  const int tid = threadIdx.x, w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int hb = p.heads_per_block;
  const int span = tc::kRows * (tc::kWarpgroups / hb);        // positions a block
  const int chunks = p.G / hb;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * hb;
  const int b = blockIdx.z;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * span;     // heaviest (latest) first
  const int S = p.S, win = p.window;
  const int kt_lo = win ? max(0, q_lo - win + 1) / kBK : 0;
  const int kt_hi = min(q_lo + span - 1, S - 1) / kBK;
  const int ntiles = kt_hi - kt_lo + 1;
  const int h = kvh * p.G + g0 + w % hb;
  const int r_lo = q_lo + (w / hb) * tc::kRows;
  const int kw_lo = win ? max(0, r_lo - win + 1) / kBK : 0;   // this warpgroup's tiles
  const int kw_hi = r_lo < S ? min(r_lo + tc::kRows - 1, S - 1) / kBK : -1;

  auto load_tile = [&](int j) {              // thread 0: tile kt_lo + j into its stage
    const int st = j % L::kStages, s0 = (kt_lo + j) * kBK;
    mbar_expect_tx(&full[st], kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kCol; ++c) {
      tma_load(sm + L::k_off(st, c), &p.k_map, p.k_ax, &full[st], c * 64, s0, kvh, b);
      tma_load(sm + L::v_off(st, c), &p.v_map, p.v_ax, &full[st], c * 64, s0, kvh, b);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], tc::kThreads / 32);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, tc::kWarpgroups * tc::kRows * HD * 2);
    for (int ww = 0; ww < tc::kWarpgroups; ++ww) {
      const int hh = kvh * p.G + g0 + ww % hb, rr = q_lo + (ww / hb) * tc::kRows;
#pragma unroll
      for (int c = 0; c < L::kCol; ++c) {
        tma_load(sm + L::q_off(ww, c), &p.q_map, p.q_ax, qbar, c * 64, rr, hh, b);
      }
    }
    for (int j = 0; j < min(L::kStages, ntiles); ++j) load_tile(j);
  }

  // accumulator layout (m64nN): rows row0 = 16 warp + lane / 4 and row0 + 8;
  // d[i] at row row0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int row0 = warp * 16 + lane / 4;
  const int qi0 = r_lo + row0, qi1 = qi0 + 8;
  float o[L::kCol][32];
#pragma unroll
  for (int c = 0; c < L::kCol; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;   // l: this thread's columns
  const uint32_t q_base = smem_u32(sm + L::q_off(w, 0));
  mbar_wait(qbar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % L::kStages, kt = kt_lo + j;
    const bool active = kt >= kw_lo && kt <= kw_hi;
    mbar_wait(&full[st], (j / L::kStages) & 1);
    float s[kBK / 2];
    if (active) {
      // scores: S = Q K^T, both K-major
      const uint32_t k_base = smem_u32(sm + L::k_off(st, 0));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * L::kQBlock + (kk % 4) * 32;
        const int koff = (kk / 4) * L::kKVBlock + (kk % 4) * 32;
        wgmma_ss<kBK>(s, wgmma_desc(q_base + off), wgmma_desc(k_base + koff), kk > 0);
      }
      wgmma_commit();
    }
    if (active) {
      wgmma_wait_all();
      fence_regs(s);

      // scale and mask in f32; the masks only where the tile crosses the
      // causal diagonal or the window's edge
      const int k_lo = kt * kBK;
      const bool edge = k_lo + kBK - 1 > r_lo || (win && k_lo <= r_lo + tc::kRows - 1 - win);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int kj = k_lo + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
        const int qi = (i / 2) % 2 ? qi1 : qi0;
        float x = s[i] * p.scale_log2;
        if (edge && !(kj <= qi && (win == 0 || kj > qi - win))) x = kNegInf;
        s[i] = x;
        if ((i / 2) % 2) {
          mx1 = fmaxf(mx1, x);
        } else {
          mx0 = fmaxf(mx0, x);
        }
      }
      // the row's four threads, in a fixed order
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if ((i / 2) % 2) {
          s[i] = ex2(s[i] - n1);
          sum1 += s[i];
        } else {
          s[i] = ex2(s[i] - n0);
          sum0 += s[i];
        }
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
#pragma unroll
      for (int c = 0; c < L::kCol; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= (i / 2) % 2 ? a1 : a0;

      // O += p_hi V + p_lo V: p as the register A fragment of each 16-key
      // slice (its layout is the accumulator's), V MN-major from the ring
      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) split_bf16x2(s[8 * t + 2 * r], s[8 * t + 2 * r + 1], hi[t][r], lo[t][r]);
      wgmma_fence();
      issue_pv<HD, kBK>(o, hi, lo, smem_u32(sm + L::v_off(st, 0)), L::kKVBlock);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < L::kCol; ++c) fence_regs(o[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (tid == 0 && j + L::kStages < ntiles) {
      mbar_wait(&empty[st], (j / L::kStages) & 1);
      load_tile(j + L::kStages);
    }
  }

  if (r_lo >= S) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 == 0.0f ? 1.0f : l0, d1 = l1 == 0.0f ? 1.0f : l1;
  bf16* out = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int c = 0; c < L::kCol; ++c) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int qi = (i / 2) % 2 ? qi1 : qi0;
      const float dn = (i / 2) % 2 ? d1 : d0;
      if (qi < S) {
        const int col = c * 64 + (i / 4) * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + qi * p.o_ss + col) =
            __floats2bfloat162_rn(o[c][i] / dn, o[c][i + 1] / dn);
      }
    }
  }
}

struct TcDecodeParams {
  CUtensorMap k_map, v_map;
  MapAxes k_ax, v_ax;
  const bf16* q;
  const int* lengths;
  bf16* out;
  float* work;
  unsigned int* counters;                  // one a (b, KV head, head chunk), zeroed
  int KV, G, S, heads_per_block, head_chunks, splits;
  float scale;
  long long q_sb, q_sh, o_sb, o_sh;
};

// One block per (chunk of kSplit slots, KV head, up to kGroup of its query
// heads, b), as the f32 route. Warp w takes slots 16 w .. 16 w + 15 of every
// staged tile and keeps its own (m, l, O); the block folds its warps, writes
// its chunk's (m, l, acc), and the last block of the row folds the chunks.
template <int HD>
__global__ void __launch_bounds__(tc::Decode<HD>::kThreads)
    decode_tc_kernel(const __grid_constant__ TcDecodeParams p) {
  using L = tc::Decode<HD>;
  constexpr int kTileBytes = 2 * L::kTile * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBarOff);
  uint64_t* empty = full + L::kStages;
  int* s_last = reinterpret_cast<int*>(empty + L::kStages);
  float* s_m = reinterpret_cast<float*>(sm + L::kBarOff + 64);      // the row's M and L a head
  float* s_l = s_m + kGroup;
  float* s_wt = s_l + kGroup;                                      // [warp][head] weights
  uint64_t* fold_bar = reinterpret_cast<uint64_t*>(s_wt + tc::Decode<HD>::kWarps * kGroup);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int kvh = y / p.head_chunks;
  const int g0 = (y % p.head_chunks) * p.heads_per_block;
  const int gc = min(p.heads_per_block, p.G - g0);
  const int len = p.lengths[b];
  const int eff = len == 0 ? p.S : len;          // length 0: every slot, every score masked
  const int s0 = split * kTcSplit;
  if (s0 >= eff) return;                         // not counted: the row's chunks end before
  const int s1 = min(s0 + kTcSplit, eff);
  const int ntiles = (s1 - s0 + L::kTile - 1) / L::kTile;
  auto load_tile = [&](int j) {
    const int st = j % L::kStages, lo = s0 + j * L::kTile;
    mbar_expect_tx(&full[st], kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kCol; ++c) {
      tma_load(sm + L::k_off(st, c), &p.k_map, p.k_ax, &full[st], c * 64, lo, kvh, b);
      tma_load(sm + L::v_off(st, c), &p.v_map, p.v_ax, &full[st], c * 64, lo, kvh, b);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], L::kWarps);
    }
    mbar_init(fold_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < min(L::kStages, ntiles); ++j) load_tile(j);
  }

  // A rows are query heads: rows g (lane / 4) take p_hi, rows g + 8 p_lo;
  // in the scores' product rows g + 8 are zero
  const int g = lane / 4, qd = (lane % 4) * 2;
  uint32_t qa[HD / 16][2];
  {
    const bf16* q = p.q + b * p.q_sb + (kvh * p.G + g0 + g) * p.q_sh;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      qa[ks][0] = g < gc ? *reinterpret_cast<const uint32_t*>(q + 16 * ks + qd) : 0u;
      qa[ks][1] = g < gc ? *reinterpret_cast<const uint32_t*>(q + 16 * ks + 8 + qd) : 0u;
    }
  }
  float o[HD / 8][4];                            // [n block][hi, hi, lo, lo]
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m = kNegInf, l = 0.0f;                   // l: this thread's slots

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % L::kStages;
    if (tid == 0 && j >= 1 && j - 1 + L::kStages < ntiles) {   // refill the stage tile j - 1 left
      mbar_wait(&empty[(j - 1) % L::kStages], ((j - 1) / L::kStages) & 1);
      load_tile(j - 1 + L::kStages);
    }
    mbar_wait(&full[st], (j / L::kStages) & 1);
    const int sb = s0 + j * L::kTile + warp * 16;
    if (sb < s1) {
      const uint32_t kt = smem_u32(sm + L::k_off(st, 0)), vt = smem_u32(sm + L::v_off(st, 0));
      // scores of slots sb .. sb + 15 (two n blocks of 8) against the heads
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const int krow = warp * 16 + (lane / 16) * 8 + lane % 8;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t r[4];
        ldsm_x4(r, swizzled(kt, L::kBlock, krow, 2 * ks + (lane / 8) % 2));
        mma_16816(sc[0], qa[ks][0], 0u, qa[ks][1], 0u, r[0], r[1]);
        mma_16816(sc[1], qa[ks][0], 0u, qa[ks][1], 0u, r[2], r[3]);
      }
      float x[2][2];
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = sb + nb * 8 + qd + e;
          x[nb][e] = slot >= s1 ? -INFINITY : (slot < len ? sc[nb][e] * p.scale : kNegInf);
          mx = fmaxf(mx, x[nb][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      float pr[2][2];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) pr[nb][e] = expf(x[nb][e] - m_new);
      l = alpha * l + (((pr[0][0] + pr[0][1]) + pr[1][0]) + pr[1][1]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha;
      uint32_t a[4];                               // {hi, lo} of slots qd.., then 8 + qd..
      split_bf16x2(pr[0][0], pr[0][1], a[0], a[1]);
      split_bf16x2(pr[1][0], pr[1][1], a[2], a[3]);
      const int vrow = warp * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, swizzled(vt, L::kBlock, vrow, 2 * dp + lane / 16));
        mma_16816(o[2 * dp], a[0], a[1], a[2], a[3], r[0], r[1]);
        mma_16816(o[2 * dp + 1], a[0], a[1], a[2], a[3], r[2], r[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // fold the warps in warp order: partials (m, l, acc[HD]) a (warp, head)
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();                               // every tile consumed: the ring is free
  float* part = reinterpret_cast<float*>(sm);
  {
    float* mine = part + (warp * kGroup + g) * (HD + 2);
    if (lane % 4 == 0) {
      mine[0] = m;
      mine[1] = l;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      mine[2 + 8 * n + qd] = o[n][0] + o[n][2];
      mine[3 + 8 * n + qd] = o[n][1] + o[n][3];
    }
  }
  // the workspace: acc [row][chunk][head][HD], then (m, l, 0, 0) [row][chunk][head]
  const int hpb = p.heads_per_block;
  const long long row = static_cast<long long>(b) * gridDim.y + y;
  const long long first = row * p.splits;        // the row's first (row, chunk) entry
  float* w_acc = p.work;
  float4* w_ml = reinterpret_cast<float4*>(
      p.work + static_cast<long long>(gridDim.z) * gridDim.y * p.splits * hpb * HD);
  __syncthreads();
  if (tid < gc) {                                // a head's M, L and its warps' weights
    float mm = kNegInf, ll = 0.0f;
#pragma unroll
    for (int ww = 0; ww < L::kWarps; ++ww) mm = fmaxf(mm, part[(ww * kGroup + tid) * (HD + 2)]);
#pragma unroll
    for (int ww = 0; ww < L::kWarps; ++ww) {
      const float* pw = part + (ww * kGroup + tid) * (HD + 2);
      const float e = expf(pw[0] - mm);
      s_wt[ww * kGroup + tid] = e;
      ll = fmaf(e, pw[1], ll);
    }
    w_ml[(first + split) * hpb + tid] = make_float4(mm, ll, 0.0f, 0.0f);
  }
  __syncthreads();
  {
    constexpr int kItems = kGroup * HD / L::kThreads;
    float acc[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {          // branch-free: items past gc are dropped
      const int it = tid + i * L::kThreads, gg = min(it / HD, gc - 1), d = it % HD;
      acc[i] = 0.0f;
#pragma unroll
      for (int ww = 0; ww < L::kWarps; ++ww) {
        acc[i] = fmaf(s_wt[ww * kGroup + gg], part[(ww * kGroup + gg) * (HD + 2) + 2 + d], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int it = tid + i * L::kThreads;
      if (it < gc * HD) w_acc[((first + split) * hpb + it / HD) * HD + it % HD] = acc[i];
    }
  }

  // the last block of the row to finish folds its chunks
  fence_proxy_async();                           // the ring is rewritten by bulk copies below
  __syncthreads();
  const int chunks = (eff + kTcSplit - 1) / kTcSplit;
  if (tid == 0) {   // the block's writes (ordered by the barrier) before the ticket, gpu-wide
    __threadfence();
    *s_last = atomicAdd(&p.counters[row], 1u) == static_cast<unsigned>(chunks - 1);
    __threadfence();
  }
  __syncthreads();
  if (!*s_last) return;
  int phase = 0;                                 // of fold_bar
  auto stage = [&](void* dst, const void* src, int bytes) {   // every thread waits
    __syncthreads();                             // the ring's last readers are done
    if (tid == 0) {
      mbar_expect_tx(fold_bar, bytes);
      bulk_load(dst, src, bytes, fold_bar);
    }
    mbar_wait(fold_bar, phase);
    phase ^= 1;
  };
  // pass 1, a warp a head: M = max_c m_c, then L = sum_c e^(m_c - M) l_c.
  // Lane j takes chunks j, j + 32, ...; the lanes fold in a fixed tree. The
  // (m, l) entries are staged in the ring, as many chunks at a time as fit.
  const float4* ml = reinterpret_cast<const float4*>(sm);
  const int ml_batch = L::kBarOff / (16 * hpb) / 32 * 32;
  constexpr int kHeads = (kGroup + L::kWarps - 1) / L::kWarps;   // heads a warp
  float mm[kHeads], ll[kHeads];
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    mm[i] = kNegInf;
    ll[i] = 0.0f;
  }
  for (int c0 = 0; c0 < chunks; c0 += ml_batch) {
    const int cb = min(ml_batch, chunks - c0);
    stage(sm, w_ml + (first + c0) * hpb, cb * hpb * 16);
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      const int gg = warp + i * L::kWarps;
      if (gg < gc) {
        for (int c = lane; c < cb; c += 32) mm[i] = fmaxf(mm[i], ml[c * hpb + gg].x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mm[i] = fmaxf(mm[i], __shfl_xor_sync(0xffffffffu, mm[i], off));
  }
  for (int c0 = 0; c0 < chunks; c0 += ml_batch) {
    const int cb = min(ml_batch, chunks - c0);
    if (chunks > ml_batch) stage(sm, w_ml + (first + c0) * hpb, cb * hpb * 16);   // else staged
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      const int gg = warp + i * L::kWarps;
      if (gg < gc) {
        for (int c = lane; c < cb; c += 32) {
          const float4 e = ml[c * hpb + gg];
          ll[i] = fmaf(expf(e.x - mm[i]), e.y, ll[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    const int gg = warp + i * L::kWarps;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ll[i] += __shfl_xor_sync(0xffffffffu, ll[i], off);
    if (lane == 0 && gg < gc) {
      s_m[gg] = mm[i];
      s_l[gg] = ll[i] == 0.0f ? 1.0f : ll[i];
    }
  }
  __syncthreads();
  // pass 2: acc = sum_c e^(m_c - M) acc_c in chunk order, the chunks' acc
  // staged in batches that fill the ring, their weights beside them. A
  // thread takes 4 columns a head at a time; items past gc repeat the last
  // head (no branch, so the loads pipeline) and are dropped.
  constexpr int kItems = kGroup * HD / 4 / L::kThreads;
  const int batch = L::kBarOff / (hpb * HD * 4 + kGroup * 4);
  float* staged = reinterpret_cast<float*>(sm);
  float* weight = staged + batch * hpb * HD;
  float4 acc[kItems];
  int off[kItems], head[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int it = tid + i * L::kThreads;
    head[i] = min(it / (HD / 4), gc - 1);
    off[i] = head[i] * HD + 4 * (it % (HD / 4));
    acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int c0 = 0; c0 < chunks; c0 += batch) {
    const int cb = min(batch, chunks - c0);
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(fold_bar, cb * hpb * HD * 4);
      bulk_load(staged, w_acc + (first + c0) * hpb * HD, cb * hpb * HD * 4, fold_bar);
    }
    for (int it = tid; it < cb * gc; it += L::kThreads) {
      const int c = it / gc, gg = it % gc;
      weight[c * kGroup + gg] = expf(__ldcg(&w_ml[(first + c0 + c) * hpb + gg].x) - s_m[gg]);
    }
    mbar_wait(fold_bar, phase);
    phase ^= 1;
    __syncthreads();
    for (int c = 0; c < cb; ++c) {
      const float4* sc = reinterpret_cast<const float4*>(staged + c * hpb * HD);
      const float* wc = weight + c * kGroup;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const float e = wc[head[i]];
        const float4 x = sc[off[i] / 4];
        acc[i].x = fmaf(e, x.x, acc[i].x);
        acc[i].y = fmaf(e, x.y, acc[i].y);
        acc[i].z = fmaf(e, x.z, acc[i].z);
        acc[i].w = fmaf(e, x.w, acc[i].w);
      }
    }
  }
  bf16* out = p.out + b * p.o_sb + (kvh * p.G + g0) * p.o_sh;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int it = tid + i * L::kThreads;
    if (it < gc * HD / 4) {
      const float dn = s_l[head[i]];
      bf16* o4 = out + head[i] * p.o_sh + (off[i] - head[i] * HD);
      *reinterpret_cast<__nv_bfloat162*>(o4) = __floats2bfloat162_rn(acc[i].x / dn, acc[i].y / dn);
      *reinterpret_cast<__nv_bfloat162*>(o4 + 2) = __floats2bfloat162_rn(acc[i].z / dn, acc[i].w / dn);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 tensor with unit-stride hd and outer axes (s, head,
// b) of the given sizes and strides (elements), read in place: boxes of 64 hd
// columns by `rows` positions, 128-byte swizzle, zeros past the edges. The
// outer axes take dims 1..3 in the order of their strides (an axis of size 1
// last), as a tensor map's dims nest.
cudaError_t make_map(CUtensorMap* map, MapAxes* ax, const void* base, int hd,
                     const long long (&size)[3], const long long (&stride)[3], int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  long long extent = hd, st[3];
  for (int i = 0; i < 3; ++i) {
    if (size[i] > 1) extent = std::max(extent, stride[i] * size[i]);
  }
  for (int i = 0; i < 3; ++i) st[i] = size[i] > 1 ? stride[i] : extent;
  int order[3] = {0, 1, 2}, pos[3];
  std::stable_sort(order, order + 3, [&](int x, int y) { return st[x] < st[y]; });
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd)}, strides[3];
  cuuint32_t box[4] = {64}, unit[4] = {1, 1, 1, 1};
  for (int k = 0; k < 3; ++k) {
    const int axis = order[k];
    dims[k + 1] = static_cast<cuuint64_t>(size[axis]);
    strides[k] = static_cast<cuuint64_t>(st[axis]) * sizeof(bf16);
    box[k + 1] = axis == 0 ? rows : 1;
    pos[axis] = k + 1;
  }
  *ax = MapAxes{pos[0], pos[1], pos[2]};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
int launch_prefill(const PrefillArgs& a, int B, cudaStream_t s) {   // f32: CUDA cores
  constexpr int smem = prefill_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_prefill_kernel<float, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  flash_prefill_kernel<float, HD><<<grid, kPrefillThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_prefill_tc(const PrefillArgs& a, int B, cudaStream_t s) {   // bf16: wgmma
  using L = tc::Prefill<HD>;
  const int KV = a.H / a.G;
  TcPrefillParams p{};
  const long long q_size[3] = {a.S, a.H, B}, q_stride[3] = {a.q_ss, a.q_sh, a.q_sb};
  const long long kv_size[3] = {a.S, KV, B};
  const long long k_stride[3] = {a.k_ss, a.k_sh, a.k_sb}, v_stride[3] = {a.v_ss, a.v_sh, a.v_sb};
  cudaError_t err = make_map(&p.q_map, &p.q_ax, a.q, HD, q_size, q_stride, tc::kRows);
  if (err == cudaSuccess) err = make_map(&p.k_map, &p.k_ax, a.k, HD, kv_size, k_stride, L::kBK);
  if (err == cudaSuccess) err = make_map(&p.v_map, &p.v_ax, a.v, HD, kv_size, v_stride, L::kBK);
  if (err == cudaSuccess) err = allow_smem(flash_prefill_tc_kernel<HD>, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.out = static_cast<bf16*>(a.out);
  p.H = a.H;
  p.G = a.G;
  p.S = a.S;
  p.window = a.window;
  p.heads_per_block = a.G % 2 == 0 ? 2 : 1;
  p.scale_log2 = static_cast<float>(a.scale * 1.4426950408889634);   // 1/sqrt(hd) log2(e)
  p.o_sb = a.o_sb;
  p.o_sh = a.o_sh;
  p.o_ss = a.o_ss;
  const int span = tc::kRows * (tc::kWarpgroups / p.heads_per_block);
  const dim3 grid((a.S + span - 1) / span, KV * (a.G / p.heads_per_block), B);
  flash_prefill_tc_kernel<HD><<<grid, tc::kThreads, L::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_decode(const DecodeArgs& a, int B, cudaStream_t s) {   // f32: CUDA cores
  constexpr int smem = decode_smem_bytes<float, HD>();
  cudaError_t err = allow_smem(decode_split_kernel<float, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<float, HD>
      <<<dim3(a.splits, a.KV * a.head_chunks, B), kDecodeThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<float, HD><<<dim3(a.H, B), HD, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// floats of the chunks' partials; the bf16 route's row counters follow them
long long decode_partial_floats(int B, int KV, int head_chunks, int splits, int per_block,
                                int hd) {
  return static_cast<long long>(B) * KV * head_chunks * splits * per_block * (hd + 4);
}

template <int HD>
int launch_decode_tc(const DecodeArgs& a, int B, cudaStream_t s) {   // bf16: mma.sync
  using L = tc::Decode<HD>;
  TcDecodeParams p{};
  const long long size[3] = {a.S, a.KV, B};
  const long long k_stride[3] = {a.k_ss, a.k_sh, a.k_sb}, v_stride[3] = {a.v_ss, a.v_sh, a.v_sb};
  cudaError_t err = make_map(&p.k_map, &p.k_ax, a.k, HD, size, k_stride, L::kTile);
  if (err == cudaSuccess) err = make_map(&p.v_map, &p.v_ax, a.v, HD, size, v_stride, L::kTile);
  if (err == cudaSuccess) err = allow_smem(decode_tc_kernel<HD>, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * a.KV * a.head_chunks;
  p.counters = reinterpret_cast<unsigned int*>(
      a.work + decode_partial_floats(B, a.KV, a.head_chunks, a.splits, a.heads_per_block, HD));
  err = cudaMemsetAsync(p.counters, 0, rows * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.q = static_cast<const bf16*>(a.q);
  p.lengths = a.lengths;
  p.out = static_cast<bf16*>(a.out);
  p.work = a.work;
  p.KV = a.KV;
  p.G = a.G;
  p.S = a.S;
  p.heads_per_block = a.heads_per_block;
  p.head_chunks = a.head_chunks;
  p.splits = (a.S + kTcSplit - 1) / kTcSplit;   // within the workspace of kSplit's chunks
  p.scale = a.scale;
  p.q_sb = a.q_sb;
  p.q_sh = a.q_sh;
  p.o_sb = a.o_sb;
  p.o_sh = a.o_sh;
  decode_tc_kernel<HD>
      <<<dim3(p.splits, a.KV * a.head_chunks, B), L::kThreads, L::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_prefill(int dtype, const PrefillArgs& a, int B, cudaStream_t s) {
  return dtype == 0 ? launch_prefill<HD>(a, B, s) : launch_prefill_tc<HD>(a, B, s);
}

template <int HD>
int dispatch_decode(int dtype, const DecodeArgs& a, int B, cudaStream_t s) {
  return dtype == 0 ? launch_decode<HD>(a, B, s) : launch_decode_tc<HD>(a, B, s);
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
// allocates it): the chunks' partials, then a 32-bit counter a (b, KV head,
// head chunk) row, which the bf16 route zeroes on the call's stream; -1 for
// sizes the kernel does not take.
extern "C" long long decode_attention_workspace(int B, int H, int KV, int S, int hd) {
  if (!shape_ok(0, B, H, KV, S, hd)) return -1;
  const int G = H / KV;
  const int per_block = G < kGroup ? G : kGroup;
  const int chunks = (G + per_block - 1) / per_block;
  const int splits = (S + kSplit - 1) / kSplit;
  return decode_partial_floats(B, KV, chunks, splits, per_block, hd) +
         static_cast<long long>(B) * KV * chunks;
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
