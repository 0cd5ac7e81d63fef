// Eq. (1) FederatedAveraging over k rows gathered from the model bank.
//
// Replaces the TPU kernel repro/kernels/fedavg.py::fedavg_pallas
// (_fedavg_kernel, pallas_call at fedavg.py:39), which averaged k models
// already copied out of the bank into a (k, N) slab. Here each block reads
// the k bank slot indices itself, so the k models are never copied:
//
//   out[p] = sum_{j<k} w[j] * rows[slot[j], p],   k <= 8,
//
// accumulated in f32 and written in the rows' dtype (f32 or bf16, rounded
// to nearest even).
//
// Bound: device-memory bytes. A launch reads k rows and writes one row,
// (k + 1) * P * itemsize bytes, against 2 * k * P flops. On the main path
// (k = 2, P = 1,663,370 f32) that is 20.0 MB, about 6 us at 3.35 TB/s; the
// flops take under 0.1 us at 67 TFLOP/s f32.
//
// Design: the bank's rows are padded to a 16-byte stride
// (repro_torch/kernels/fedavg.py::alloc_rows), so every row can be
// streamed with 16-byte loads (4 f32 or 8 bf16 per thread step) and one
// 16-byte store per step in a grid-stride loop; the last P % VEC elements
// (the masked tail) go one per thread of block 0. Rows that are not 16-byte
// aligned (a plain (k, N) tensor with N % 4 != 0) take the same loop with
// one element per step. Slots out of [0, n_rows) are clamped, as an XLA
// gather clamps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC = 16 / sizeof(T) elements per thread step on the vector path, 1 otherwise.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) fedavg_gather_kernel(
    const T* __restrict__ rows, int64_t row_stride, int64_t n_rows,
    const int32_t* __restrict__ slots, const float* __restrict__ weights, int k,
    int64_t P, T* __restrict__ out) {
  __shared__ const T* s_row[kMaxK];
  __shared__ float s_w[kMaxK];
  if (static_cast<int>(threadIdx.x) < k) {
    int64_t s = slots[threadIdx.x];
    s = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
    s_row[threadIdx.x] = rows + s * row_stride;
    s_w[threadIdx.x] = weights[threadIdx.x];
  }
  __syncthreads();

  const int64_t n_vec = P / VEC;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < n_vec;
       v += step) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float w = s_w[j];
      if constexpr (VEC == 1) {
        acc[0] = fmaf(w, to_f32(s_row[j][v]), acc[0]);
      } else {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(s_row[j]) + v);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, to_f32(x[e]), acc[e]);
      }
    }
    if constexpr (VEC == 1) {
      out[v] = from_f32<T>(acc[0]);
    } else {
      uint4 raw;
      T* y = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = from_f32<T>(acc[e]);
      reinterpret_cast<uint4*>(out)[v] = raw;
    }
  }

  if constexpr (VEC > 1) {
    // masked tail: the P % VEC elements after the last full vector
    const int64_t p = n_vec * VEC + threadIdx.x;
    if (blockIdx.x == 0 && p < P) {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) acc = fmaf(s_w[j], to_f32(s_row[j][p]), acc);
      out[p] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* rows, int64_t row_stride, int64_t n_rows, const int32_t* slots,
           const float* weights, int k, int64_t P, void* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                       (row_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t work = aligned ? P / kVec : P;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* r = static_cast<const T*>(rows);
  T* o = static_cast<T*>(out);
  if (aligned) {
    fedavg_gather_kernel<T, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        r, row_stride, n_rows, slots, weights, k, P, o);
  } else {
    fedavg_gather_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        r, row_stride, n_rows, slots, weights, k, P, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers; the stream
// is a cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int fedavg_gather(const void* rows, long long row_stride, long long n_rows,
                             const int* slots, const float* weights, int k, long long P,
                             void* out, int dtype, int device, void* stream) {
  if (k < 1 || k > kMaxK || P < 1 || n_rows < 1 || row_stride < P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(rows, row_stride, n_rows, slots, weights, k, P, out, s);
    case 1:
      return launch<__nv_bfloat16>(rows, row_stride, n_rows, slots, weights, k, P, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
