// Causal GQA attention's backward: dq, dk and dv of flash_attention.cu's
// prefill (optional sliding window).
//
// Replaces no Pallas kernel. The reference's training path differentiates
// repro/models/attention.py::chunked_sdpa (:112) by XLA autodiff; the port's
// forward goes through the hand-written prefill kernel (row 9,
// flash_attention.cu), which autograd cannot see through, so its gradient is
// a kernel too (kernels/flash_attention.py::flash_attention_train, the
// backward of every attention layer of Model.loss).
//
// What it computes, for each head h (KV head h / G, G = H / KV), query row i
// and key j that i sees (j <= i, and i - window < j when window > 0):
//   s_ij = (q_i . k_j) * (1 / sqrt(hd)),  p_ij = exp(s_ij - lse_i),
//   dp_ij = do_i . v_j,  ds_ij = p_ij (dp_ij - D_i),  D_i = do_i . o_i,
//   dq_i = scale sum_j ds_ij k_j,  dk_j = scale sum_{h of j's group, i} ds_ij q_i,
//   dv_j = sum_{h, i} p_ij do_i,
// with the same mask (-1e30, probabilities exactly 0) and scale as the
// forward. Everything is computed in f32 from the f32 or bf16 inputs; only
// the outputs are rounded to the inputs' dtype. hd in {64, 128, 256}, any
// H / KV, any S; the C function refuses anything else.
//
// The row statistics (lse_i and D_i) are recomputed here, not saved by the
// forward, so the serving route's kernel, bits and time are untouched. D_i
// is taken from o_i recomputed in f32 (not from the stored output): in bf16
// the stored output is rounded to 2^-8 of itself, and D_i - dp_ij cancels,
// so the rounding would move ds by far more than the kernel's bar.
//
// Two launches, no atomics, so the same inputs give the same bits:
//   bwd_dq_kernel, one block of 256 threads a (b, h, 32 query rows): a first
//     walk over the key tiles recomputes the online softmax and o (f32), then
//     lse and D, which it stores for the second launch; a second walk
//     recomputes p and dp and sums dq.
//   bwd_dkdv_kernel, one block a (b, KV head, 32 keys): walks the G query
//     heads of its KV head and their query tiles in order, recomputes p and
//     ds from the stored lse and D, and sums dk and dv.
// Tiles of 32 rows by 32 keys are staged in shared memory as f32 (16-byte
// global loads), rows padded to hd + 4 floats, and read back 16 bytes at a
// time: thread t owns query row (or key row) t / 8, the keys t % 8 + 8 j of
// a score tile and the columns 32 i + 4 (t % 8) + {0..3} of an output row,
// so the 8 lanes of a row read 8 different 16-byte words that cover the 32
// banks once, and a row's sums fold over its 8 adjacent lanes by three
// shuffles in a fixed order. Products are f32 FMAs on the CUDA cores.
//
// Bound on one H100 SXM (the training shape, qwen3-0.6b at 4 sequences of
// 128: B 4, H 16, KV 8, S 128, hd 128, bf16): the gradient needs five
// products of 2 hd operations a visible (i, j) pair, 10 hd * B H S (S + 1) /
// 2 = 0.68 GFLOP, 0.68 us at the 989 TFLOP/s bf16 tensor-core peak, against
// 10.5 MB of q, k, v, do read and dq, dk, dv written, 3.1 us at 3.35 TB/s:
// bound by bytes. This kernel issues nine products a pair (the recomputed
// softmax, o, and s and dp in both launches) on the CUDA cores, so it sits
// far from that bound; making it fast (tensor cores, fewer recomputations)
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kRows = 32;           // query rows or keys a tile
constexpr int kPStride = kRows + 1; // p and ds tile rows (floats)

// the row stride (floats) of a staged tile: 16-byte rows whose start banks
// differ by 4 from row to row
template <int HD>
__host__ __device__ constexpr int row_ld() {
  return HD + 4;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float2* stats;         // (B, H, S): (lse, D) of each query row
  int H, G, S, window;
  float scale;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
};

template <int HD>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 4 * (4 * kRows * row_ld<HD>() + kRows * kPStride);
}

template <int HD>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 4 * (4 * kRows * row_ld<HD>() + 2 * kRows * kPStride + 2 * kRows);
}

// 16 bytes of T from global memory as f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [lo, lo + 32) of a (S, HD) head at stride ss (16-byte aligned rows:
// the wrapper checks), as f32, rows past S zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int lo, int S) {
  constexpr int LD = row_ld<HD>(), V = Vec<T>::kN, kPerRow = HD / V;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += kThreads) {
    const int row = idx / kPerRow;
    const int c = idx - row * kPerRow;
    const int s = lo + row;
    float v[V];
    if (s < S) {
      Vec<T>::load(src + s * ss + c * V, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + row * LD + c * V);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      out[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
}

// acc[4 i + e] += x * row[32 i + 4 c8 + e]: an output row's columns of this thread
template <int HD>
__device__ __forceinline__ void axpy_row(float* acc, float x, const float* row, int c8) {
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
    const float4 v = ld4(row + 32 * i + 4 * c8);
    acc[4 * i] = fmaf(x, v.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(x, v.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(x, v.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(x, v.w, acc[4 * i + 3]);
  }
}

// this thread's columns of an output row, times scale, in T
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* out, const float* acc, float scale, int c8) {
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[32 * i + 4 * c8 + e] = from_f32<T>(acc[4 * i + e] * scale);
  }
}

// the sum over the 8 adjacent lanes of a row, the same order in every lane
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ bool visible(int i, int j, int S, int window) {
  return i < S && j < S && j <= i && (window == 0 || j > i - window);
}

// s (and with DP also dp) of this thread's row r against keys c8 + 8 j of
// the staged tile
template <int HD, bool DP>
__device__ __forceinline__ void scores(const float* A, const float* B, const float* dA,
                                       const float* dB, int r, int c8, float* s, float* dp) {
  constexpr int LD = row_ld<HD>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = 0.f;
    dp[j] = 0.f;
  }
  // hd 256's dk and dv take 64 registers a thread: no unrolling there, or
  // the dk/dv kernel spills
#pragma unroll(HD > 128 ? 1 : 2)
  for (int d = 0; d < HD; d += 4) {
    const float4 a = ld4(A + r * LD + d);
    float4 da = make_float4(0.f, 0.f, 0.f, 0.f);
    if (DP) da = ld4(dA + r * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = ld4(B + (c8 + 8 * j) * LD + d);
      s[j] = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s[j]))));
      if (DP) {
        const float4 db = ld4(dB + (c8 + 8 * j) * LD + d);
        dp[j] = fmaf(da.w, db.w, fmaf(da.z, db.z, fmaf(da.y, db.y, fmaf(da.x, db.x, dp[j]))));
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq_kernel(BwdArgs a) {
  constexpr int LD = row_ld<HD>();
  constexpr int kCols = HD / 8;      // output columns a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kRows * LD;
  float* Ks = dOs + kRows * LD;
  float* Vs = Ks + kRows * LD;
  float* Ps = Vs + kRows * LD;

  const int tid = threadIdx.x;
  const int r = tid >> 3, c8 = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;       // heaviest (latest) query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int S = a.S, W = a.window;
  const int q0 = qt * kRows;
  const int qi = q0 + r;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, HD>(Qs, q, a.q_ss, q0, S);
  load_tile<T, HD>(dOs, dout, a.do_ss, q0, S);
  const int k_first = W ? max(0, q0 - W + 1) / kRows * kRows : 0;
  const int k_end = min(S, q0 + kRows);

  // walk 1: the online softmax and o, in f32
  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += kRows) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, a.k_ss, k0, S);
    load_tile<T, HD>(Vs, v, a.v_ss, k0, S);
    __syncthreads();
    float s[4], unused[4];
    scores<HD, false>(Qs, Ks, nullptr, nullptr, r, c8, s, unused);
    bool ok[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = visible(qi, k0 + c8 + 8 * j, S, W);
      s[j] = ok[j] ? s[j] * a.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      Ps[r * kPStride + c8 + 8 * j] = p;
      sum += p;
    }
    l = l * alpha + row_sum(sum);
    m = m_new;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    __syncthreads();
    for (int c = 0; c < kRows; ++c) axpy_row<HD>(acc, Ps[r * kPStride + c], Vs + c * LD, c8);
  }
  // D = do . o with o = acc / l; lse = m + log l (l >= 1 on every row < S)
  const float inv_l = l > 0.f ? 1.f / l : 0.f;
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = acc[i] * inv_l;
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
    const float4 d4 = ld4(dOs + r * LD + 32 * i + 4 * c8);
    dsum = fmaf(d4.w, o[4 * i + 3], fmaf(d4.z, o[4 * i + 2],
                fmaf(d4.y, o[4 * i + 1], fmaf(d4.x, o[4 * i], dsum))));
  }
  const float D = row_sum(dsum);
  const float lse = l > 0.f ? m + logf(l) : 0.f;
  if (c8 == 0 && qi < S) {
    a.stats[(static_cast<long long>(b) * a.H + h) * S + qi] = make_float2(lse, D);
  }

  // walk 2: p and dp again, ds, dq
  float dq[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dq[i] = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += kRows) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, a.k_ss, k0, S);
    load_tile<T, HD>(Vs, v, a.v_ss, k0, S);
    __syncthreads();
    float s[4], dp[4];
    scores<HD, true>(Qs, Ks, dOs, Vs, r, c8, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = visible(qi, k0 + c8 + 8 * j, S, W) ? expf(s[j] * a.scale - lse) : 0.f;
      Ps[r * kPStride + c8 + 8 * j] = p * (dp[j] - D);
    }
    __syncthreads();
    for (int c = 0; c < kRows; ++c) axpy_row<HD>(dq, Ps[r * kPStride + c], Ks + c * LD, c8);
  }
  if (qi < S) {
    store_row<T, HD>(static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh + qi * a.dq_ss, dq,
                     a.scale, c8);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkdv_kernel(BwdArgs a) {
  constexpr int LD = row_ld<HD>();
  constexpr int kCols = HD / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kRows * LD;
  float* Qs = Vs + kRows * LD;
  float* dOs = Qs + kRows * LD;
  float* Ps = dOs + kRows * LD;
  float* dSs = Ps + kRows * kPStride;
  float* lse_s = dSs + kRows * kPStride;
  float* D_s = lse_s + kRows;

  const int tid = threadIdx.x;
  const int r = tid >> 3, c8 = tid & 7;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, W = a.window;
  const int k0 = blockIdx.x * kRows;               // the earliest key tiles see the most queries
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, HD>(Ks, k, a.k_ss, k0, S);
  load_tile<T, HD>(Vs, v, a.v_ss, k0, S);
  const int q_end = W ? min(S, k0 + kRows - 1 + W) : S;

  float dk[kCols], dv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const float2* stats = a.stats + (static_cast<long long>(b) * a.H + h) * S;
    for (int q0 = k0; q0 < q_end; q0 += kRows) {
      __syncthreads();
      load_tile<T, HD>(Qs, q, a.q_ss, q0, S);
      load_tile<T, HD>(dOs, dout, a.do_ss, q0, S);
      if (tid < kRows) {
        const float2 st = q0 + tid < S ? stats[q0 + tid] : make_float2(0.f, 0.f);
        lse_s[tid] = st.x;
        D_s[tid] = st.y;
      }
      __syncthreads();
      // query row r against keys c8 + 8 j of this block's tile
      float s[4], dp[4];
      scores<HD, true>(Qs, Ks, dOs, Vs, r, c8, s, dp);
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            visible(qi, k0 + c8 + 8 * j, S, W) ? expf(s[j] * a.scale - lse_s[r]) : 0.f;
        Ps[r * kPStride + c8 + 8 * j] = p;
        dSs[r * kPStride + c8 + 8 * j] = p * (dp[j] - D_s[r]);
      }
      __syncthreads();
      // key row r of the tile: sums over the 32 query rows, in order
      for (int row = 0; row < kRows; ++row) {
        axpy_row<HD>(dv, Ps[row * kPStride + r], dOs + row * LD, c8);
        axpy_row<HD>(dk, dSs[row * kPStride + r], Qs + row * LD, c8);
      }
    }
  }
  const int kj = k0 + r;
  if (kj < S) {
    store_row<T, HD>(static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + kj * a.dk_ss, dk,
                     a.scale, c8);
    store_row<T, HD>(static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh + kj * a.dv_ss, dv,
                     1.f, c8);
  }
}

template <typename T, int HD>
int launch(const BwdArgs& a, int B, int KV, cudaStream_t s) {
  const int tiles = (a.S + kRows - 1) / kRows;
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_smem_bytes<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem_bytes<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, HD><<<dim3(tiles, a.H, B), kThreads, dq_smem_bytes<HD>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T, HD><<<dim3(tiles, KV, B), kThreads, dkdv_smem_bytes<HD>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch(int dtype, const BwdArgs& a, int B, int KV, cudaStream_t s) {
  return dtype == 0 ? launch<float, HD>(a, B, KV, s) : launch<__nv_bfloat16, HD>(a, B, KV, s);
}

}  // namespace

// q, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, KV, S, hd); device pointers
// of dtype (0 f32, 1 bf16), each with the given strides (elements) over
// (b, head, s) and unit stride over hd; stats: B * H * S float2 of
// workspace. window 0: causal; > 0: sliding window. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   void* dq, void* dk, void* dv, void* stats, int dtype, int B,
                                   int H, int KV, int S, int hd, int window, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                   long long do_sb, long long do_sh, long long do_ss,
                                   long long dq_sb, long long dq_sh, long long dq_ss,
                                   long long dk_sb, long long dk_sh, long long dk_ss,
                                   long long dv_sb, long long dv_sh, long long dv_ss, int device,
                                   void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && B >= 1 && KV >= 1 && H >= KV && H % KV == 0 &&
                  S >= 1 && window >= 0 && (hd == 64 || hd == 128 || hd == 256);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  BwdArgs a{q, k, v, dout, dq, dk, dv, static_cast<float2*>(stats), H, H / KV, S, window,
            // 1 / sqrt(hd) rounded once to f32, the forward's scale
            static_cast<float>(1.0 / sqrt(static_cast<double>(hd))),
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
            dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dispatch<64>(dtype, a, B, KV, s);
  if (hd == 128) return dispatch<128>(dtype, a, B, KV, s);
  return dispatch<256>(dtype, a, B, KV, s);
}

// Dynamic shared memory (bytes) that the launch asks for: of the dq kernel
// (kernel 0) or the dk/dv kernel (kernel 1) at head dim hd; -1 for an hd or
// kernel it does not build.
extern "C" int flash_attention_bwd_smem_bytes(int hd, int kernel) {
  if (kernel != 0 && kernel != 1) return -1;
  if (hd == 64) return kernel == 0 ? dq_smem_bytes<64>() : dkdv_smem_bytes<64>();
  if (hd == 128) return kernel == 0 ? dq_smem_bytes<128>() : dkdv_smem_bytes<128>();
  if (hd == 256) return kernel == 0 ? dq_smem_bytes<256>() : dkdv_smem_bytes<256>();
  return -1;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
