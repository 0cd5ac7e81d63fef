// Chunk-parallel RWKV6 WKV with data-dependent decay.
//
// Replaces the TPU kernel repro/kernels/wkv.py::wkv_pallas (_wkv_kernel,
// pallas_call at wkv.py:99). Per (b, h), with the (hd_k, hd_v) state S in f32:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//
// w_t = exp(logw_t), logw <= 0, computed as _wkv_kernel computes it, in chunks
// of C = 32 steps: cum = the inclusive cumulative sum of logw over the chunk
// (sequential in t, f32), cum_prev = cum - logw;
//   y[t]  = sum_{s<t} (sum_d r[t,d] k[s,d] exp(cum_prev[t,d] - cum[s,d])) v[s]
//         + (sum_d r[t,d] k[t,d] u[d]) v[t] + (r[t] * exp(cum_prev[t])) S
//   S'    = exp(cum[C-1]) * S + sum_s (k[s] * exp(cum[C-1] - cum[s]))^T v[s]
// so every decay exponent is <= 0. Unlike the Pallas kernel it starts from a
// given state and writes the final one (prefill feeds decode), and it writes
// y in f32, as repro/models/rwkv.py::wkv_chunked returns it to time_mix.
// r, k, v and u are f32 or bf16 (T), logw and the states f32; hd is 64 or
// 128; the C function refuses anything else.
//
// The caller is the RWKV6 model's time mix (models/rwkv.py): every layer of
// a forward or prefill whose length is a multiple of 32.
//
// Bound on one H100 SXM (rwkv6-7b: B 1, T 8,192, H 64, hd 64, bf16): r, k,
// v (201 MB), logw (134 MB) and y (134 MB) are 470 MB, 0.14 ms at 3.35
// TB/s; the chunked form's 11.4 GFLOP of f32 take 0.17 ms at 67 TFLOP/s,
// and its 0.59 G exponentials (0.52 G for the masked pairs) 0.14 ms at 16
// a clock per SM: bound by operations, 0.17 ms. This kernel takes about
// 3 ms there: each chunk's five phases wait on shared-memory loads and
// barriers, one chunk after another.
//
// Design. One block of 256 threads per (value slice of 32 columns, h, b): the
// value axis is independent (S[:, j] and y[:, j] need only v[:, j]), so hd 64
// gives two blocks a head and 128 blocks at B 1, each recomputing the chunk's
// (C, C) scores. The block walks the chunks in order and keeps its (hd, 32)
// slice of S in shared memory across them, where the TPU kept the whole
// state in VMEM across grid steps. The next chunk's r, k, logw and v slice
// load by cp.async into a second stage while this chunk computes; the
// working arrays are f32 rows padded to hd + 1 floats, so threads of a warp
// that read one column of different rows hit different banks. A chunk is
// five phases between barriers: convert and cumulative sums; the 496
// strictly lower (t, s) scores, two a thread, and the 32 bonus terms on the
// diagonal; the decays of r and k in place; y = A v + r_dec S, written as
// (B, T, H, hd) f32 rows; S' = e^total S + k_dec^T v. Everything runs on
// the CUDA cores in f32; no atomics, so the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                       // timesteps a chunk
constexpr int kNV = 32;                      // value columns a block owns
constexpr int kThreads = 256;
constexpr int kLower = kC * (kC - 1) / 2;    // strictly lower (t, s) pairs: 496
// threads with one pair only (the rest have two) take the diagonal, two each
constexpr int kBonusThreads = 2 * kThreads - kLower;
static_assert(kBonusThreads * 2 == kC, "the diagonal's 32 terms go two to each of 16 threads");

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

// Shared memory, in bytes; every region a multiple of 16.
template <typename T, int HD>
struct Layout {
  static constexpr int kP = HD + 1;                      // padded f32 row
  static constexpr int kStageRK = kC * HD * (int)sizeof(T);
  static constexpr int kStageW = kC * HD * 4;
  static constexpr int kStageV = kC * kNV * (int)sizeof(T);
  static constexpr int kStage = 2 * kStageRK + kStageW + kStageV;
  static constexpr int kWork = kC * kP * 4;              // each of r, k, cum_prev, cum
  static constexpr int kBytes = 2 * kStage + 4 * kWork + kC * kNV * 4 + kC * (kC + 1) * 4 +
                                HD * kNV * 4 + 3 * HD * 4 + 2 * kLower;
  static_assert(kWork % 16 == 0 && kStage % 16 == 0, "regions must stay 16-byte aligned");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// Issue the cp.async copies of chunk c's r, k, logw and v slice into a stage.
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(const Args& a, int b, int h, int j0, int c,
                                           char* stage, int tid) {
  constexpr int kVec = 16 / (int)sizeof(T);    // elements per 16-byte copy
  constexpr int kRowRK = HD / kVec;
  constexpr int kRowW = HD / 4;
  constexpr int kRowV = kNV / kVec;
  const long long t0 = static_cast<long long>(c) * kC;
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + t0 * a.r_st + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + t0 * a.k_st + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + t0 * a.v_st + h * a.v_sh + j0;
  const float* w = a.lw + b * a.w_sb + t0 * a.w_st + h * a.w_sh;
  T* sr = reinterpret_cast<T*>(stage);
  T* sk = sr + kC * HD;
  float* sw = reinterpret_cast<float*>(stage + 2 * Layout<T, HD>::kStageRK);
  T* sv = reinterpret_cast<T*>(stage + 2 * Layout<T, HD>::kStageRK + Layout<T, HD>::kStageW);
  for (int i = tid; i < kC * kRowRK; i += kThreads) {
    const int t = i / kRowRK, q = (i % kRowRK) * kVec;
    cp_async16(sr + t * HD + q, r + t * a.r_st + q);
    cp_async16(sk + t * HD + q, k + t * a.k_st + q);
  }
  for (int i = tid; i < kC * kRowW; i += kThreads) {
    const int t = i / kRowW, q = (i % kRowW) * 4;
    cp_async16(sw + t * HD + q, w + t * a.w_st + q);
  }
  for (int i = tid; i < kC * kRowV; i += kThreads) {
    const int t = i / kRowV, q = (i % kRowV) * kVec;
    cp_async16(sv + t * kNV + q, v + t * a.v_st + q);
  }
  cp_async_commit();
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) wkv_kernel(Args a) {
  using L = Layout<T, HD>;
  constexpr int P = L::kP;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* rs = reinterpret_cast<float*>(smem + 2 * L::kStage);   // r, then r * e^cum_prev
  float* ks = rs + kC * P;                                        // k, then k * e^(total - cum)
  float* cps = ks + kC * P;                                       // cum_prev
  float* cs = cps + kC * P;                                       // cum
  float* vs = cs + kC * P;                                        // [kC][kNV]
  float* A = vs + kC * kNV;                                       // [kC][kC + 1] scores
  float* S = A + kC * (kC + 1);                                   // [HD][kNV] state slice
  float* us = S + HD * kNV;
  float* tot = us + HD;
  float* etot = tot + HD;
  uint8_t* pt = reinterpret_cast<uint8_t*>(etot + HD);           // pair p's t
  uint8_t* ps = pt + kLower;                                      // pair p's s

  const int j0 = blockIdx.x * kNV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nc = a.T / kC;

  load_chunk<T, HD>(a, b, h, j0, 0, smem, tid);

  if (tid < kC) {                      // strictly lower pairs, row by row
    const int base = tid * (tid - 1) / 2;
    for (int s = 0; s < tid; ++s) {
      pt[base + s] = static_cast<uint8_t>(tid);
      ps[base + s] = static_cast<uint8_t>(s);
    }
  }
  const T* u = static_cast<const T*>(a.u) + h * HD;
  for (int d = tid; d < HD; d += kThreads) us[d] = to_float(u[d]);
  const long long state_off = (static_cast<long long>(b) * a.H + h) * HD * HD + j0;
  for (int i = tid; i < HD * kNV; i += kThreads) {
    S[i] = a.s_in[state_off + (i / kNV) * HD + i % kNV];
  }
  for (int i = tid; i < kC * (kC + 1); i += kThreads) A[i] = 0.0f;   // upper triangle stays 0

  for (int c = 0; c < nc; ++c) {
    const char* st = smem + (c & 1) * L::kStage;
    if (c + 1 < nc) {
      load_chunk<T, HD>(a, b, h, j0, c + 1, smem + ((c + 1) & 1) * L::kStage, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 1. to f32, and the cumulative sums of logw, sequential in t
    const T* sr = reinterpret_cast<const T*>(st);
    const T* sk = sr + kC * HD;
    const float* sw = reinterpret_cast<const float*>(st + 2 * L::kStageRK);
    const T* sv = reinterpret_cast<const T*>(st + 2 * L::kStageRK + L::kStageW);
    for (int i = tid; i < kC * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      rs[t * P + d] = to_float(sr[i]);
      ks[t * P + d] = to_float(sk[i]);
    }
    for (int i = tid; i < kC * kNV; i += kThreads) vs[i] = to_float(sv[i]);
    for (int d = tid; d < HD; d += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < kC; ++t) {
        const float w = sw[t * HD + d];
        acc += w;
        cs[t * P + d] = acc;
        cps[t * P + d] = acc - w;
      }
      tot[d] = acc;
      etot[d] = expf(acc);
    }
    __syncthreads();

    // 2. scores A[t][s] = sum_d r[t,d] k[s,d] e^(cum_prev[t,d] - cum[s,d]), s < t;
    //    the bonus sum_d r[t,d] k[t,d] u[d] on the diagonal
    for (int p = tid; p < kLower; p += kThreads) {
      const int t = pt[p], s = ps[p];
      const float* rt = rs + t * P;
      const float* kr = ks + s * P;
      const float* ct = cps + t * P;
      const float* cr = cs + s * P;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc = fmaf(rt[d] * kr[d], expf(ct[d] - cr[d]), acc);
      A[t * (kC + 1) + s] = acc;
    }
    if (tid >= kThreads - kBonusThreads) {
      for (int t = 2 * (tid - (kThreads - kBonusThreads)), e = t + 2; t < e; ++t) {
        const float* rt = rs + t * P;
        const float* kt = ks + t * P;
        float acc = 0.0f;
        for (int d = 0; d < HD; ++d) acc = fmaf(rt[d] * kt[d], us[d], acc);
        A[t * (kC + 1) + t] = acc;
      }
    }
    __syncthreads();

    // 3. the decays: r * e^cum_prev and k * e^(total - cum), in place
    for (int i = tid; i < kC * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      rs[t * P + d] *= expf(cps[t * P + d]);
      ks[t * P + d] *= expf(tot[d] - cs[t * P + d]);
    }
    __syncthreads();

    // 4. y[t][j] = sum_{s<=t} A[t][s] v[s][j] + sum_k r_dec[t][k] S[k][j]
    float* yc = a.y + ((static_cast<long long>(b) * a.T + static_cast<long long>(c) * kC) * a.H +
                       h) * HD + j0;
    for (int o = tid; o < kC * kNV; o += kThreads) {
      const int t = o / kNV, j = o % kNV;
      float intra = 0.0f;
      for (int s = 0; s <= t; ++s) intra = fmaf(A[t * (kC + 1) + s], vs[s * kNV + j], intra);
      float inter = 0.0f;
#pragma unroll 8
      for (int kk = 0; kk < HD; ++kk) inter = fmaf(rs[t * P + kk], S[kk * kNV + j], inter);
      yc[static_cast<long long>(t) * a.H * HD + j] = intra + inter;
    }
    __syncthreads();

    // 5. S[k][j] = e^total[k] S[k][j] + sum_s k_dec[s][k] v[s][j]
    for (int o = tid; o < HD * kNV; o += kThreads) {
      const int kk = o / kNV, j = o % kNV;
      float acc = etot[kk] * S[o];
#pragma unroll 8
      for (int s = 0; s < kC; ++s) acc = fmaf(ks[s * P + kk], vs[s * kNV + j], acc);
      S[o] = acc;
    }
    // the next chunk's first barrier orders these writes before any read
  }
  __syncthreads();
  for (int i = tid; i < HD * kNV; i += kThreads) {
    a.s_out[state_off + (i / kNV) * HD + i % kNV] = S[i];
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr int smem = Layout<T, HD>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_kernel<T, HD><<<dim3(HD / kNV, a.H, B), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch(int dtype, const Args& a, int B, cudaStream_t s) {
  return dtype == 0 ? launch<float, HD>(a, B, s) : launch<__nv_bfloat16, HD>(a, B, s);
}

}  // namespace

// r, k, v: (B, T, H, hd) of dtype (0 f32, 1 bf16) read with strides (elements)
// over (b, t, h) and unit stride over hd, rows 16-byte aligned (the wrapper
// checks); logw likewise in f32; u (H, hd) contiguous of dtype; s_in and
// s_out (B, H, hd, hd) f32 contiguous; y (B, T, H, hd) f32 contiguous. T a
// positive multiple of 32, hd 64 or 128. Returns the cudaError_t of the
// launch (0 on success).
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
  return hd == 64 ? dispatch<64>(dtype, a, B, s) : dispatch<128>(dtype, a, B, s);
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
