// Pairwise squared-L2 distances between k flattened models, and the
// model-space screen's scores, in one launch.
//
// Replaces the TPU kernel repro/kernels/model_distance.py::model_distance_pallas
// (_dist_kernel, pallas_call at model_distance.py:42). For x (k, N) f32:
//
//   d[i][j] = sq_i + sq_j - 2 * dot_ij,   dot_ij = sum_n x[i][n] * x[j][n],
//   sq_i = dot_ii,
//
// as repro/kernels/ref.py::model_distance_ref computes it, and optionally
//
//   scores[i] = (sum over j != i of d[i][j], in j order) / max(k - 1, 1),
//
// as repro/core/anomaly.py::parameter_outlier_scores computes it from d. The
// caller is core/anomaly.py::parameter_outlier_scores, the model-space screen
// of the alpha candidate tips (k = 5 on the paper's CNN, N = 1,663,370).
//
// Bound: device-memory bytes. A call must read x once, k * N * 4 bytes, and
// write k * k * 4 (and k * 4 with the scores): 33.3 MB, 9.9 us at 3.35 TB/s
// for k = 5 at the CNN's width; 106.5 MB, 31.8 us for k = 16. The products
// are k (k + 1) / 2 fma a column, at most 528 (k = 32): 0.88 G fma, about
// 26 us at 67 TFLOP/s f32, for k = 32 at the CNN's width against its 63.5 us
// of bytes, so the fma never set the pace. They stay on the CUDA cores in
// full f32: a TF32 tensor-core product would miss the 1e-5 tolerance.
//
// Design: one persistent launch, x read once.
// - The columns are cut into stages (about 32 KB of all k rows: 1,576
//   columns at k = 5, 508 at k = 16 for the CNN) and the stages into chunks:
//   chunk c is stages c, c + C, c + 2C, ... with C = 132 (fewer for large k,
//   so that the finish can stage every chunk's partial in shared memory, or
//   where N has fewer stages); the stage width is set so that the chunks'
//   stage counts differ by one at most. All follow from (k, N). The
//   grid is as many blocks as fit on the card (one an SM), capped at C;
//   block b takes chunks b, b + grid, ... On an H100 each block takes one
//   chunk, and the blocks sweep the columns side by side.
// - In a block, warp 15 loads and warps 0-14 sum. The loading warp streams
//   its chunks' stages through a ring of four slots in shared memory: lane r
//   copies row r's columns of the stage with one bulk copy (cp.async.bulk,
//   completing on the slot's "full" mbarrier) of the 16-byte aligned body,
//   its head and tail columns by 4-byte cp.async tracked by the same
//   barrier. A row lands in shared memory at its offset mod 16 bytes in
//   device memory, so any row stride and any start work, and nothing
//   outside the tensor is read. It refills a slot once the summing warps
//   have arrived on its "empty" mbarrier: three stages are in flight while
//   one is summed, and no block-wide barrier stands between stages.
// - The rows are cut into tiles of 8 (the last one shorter), the upper
//   triangle of the Gram matrix into tile pairs (1, 3, 6 or 10). The 15
//   summing warps are split among the tile pairs by their cost, and a pair's
//   warps walk a stage's columns with their lanes, each lane keeping the
//   pair's dot products in registers (36 or 64 at most; rows past k are
//   neither loaded nor multiplied). At a chunk's last stage a butterfly of
//   shuffles sums each warp's lanes and a sum over the pair's warps in warp
//   order gives the chunk's partial Gram, which goes to the chunk's own
//   workspace slot.
// - The last block to finish (a ticket counter, atomic with release and
//   acquire at gpu scope) stages every partial in shared memory, sums each
//   dot product over the chunks in a fixed order, forms sq_i + sq_j -
//   2 dot_ij with __fadd_rn, __fmul_rn and __fsub_rn (nothing contracts
//   there), writes one value to d[i][j] and d[j][i], forms the scores with
//   __fadd_rn and __fdiv_rn, and resets the counter to 0 for the next call.
// So every sum's order is a function of (k, N) alone, whatever the row
// stride, the alignment, the SM count or the block that finishes last: no
// float atomics, the same bits from call to call, d symmetric bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kTile = 8;                 // rows per row tile
constexpr int kMaxTilePairs = 10;        // 4 row tiles
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSumWarps = kWarps - 1;      // warps 0..14 sum; warp 15 loads
constexpr int kSumThreads = kSumWarps * 32;
constexpr int kStages = 4;               // the ring's depth
constexpr int kStageFloats = 8192;       // k * columns a stage: about 32 KB
constexpr int kInterleave = 132;         // chunks at large N (an H100 SXM's SM count)
constexpr int kFinalFloats = 49152;      // partials the finish stages: 192 KB

// What a call does, from (k, N) alone.
struct Plan {
  int k;
  int pairs;           // k (k + 1) / 2
  int pairs4;          // a chunk's partial slot: pairs rounded up to 4 floats
  int chunks;          // chunk c: stages c, c + chunks, c + 2 chunks, ...
  long long stages;    // stage s: columns [s * stage_cols, (s + 1) * stage_cols) within N
  int stage_cols;      // columns a stage, a multiple of 4
  int pitch;           // floats a row in a stage: stage_cols + 4
  int tile_pairs;
  int tp_ri[kMaxTilePairs], tp_rj[kMaxTilePairs];   // first rows of the two tiles
  int tp_ni[kMaxTilePairs], tp_nj[kMaxTilePairs];   // rows of each
  int tp_shape[kMaxTilePairs];   // diagonal n rows: n - 1; off the diagonal 8 x n: 7 + n
  int tp_warp0[kMaxTilePairs], tp_warps[kMaxTilePairs];
  int warp_tp[kSumWarps];
};

// a stage's target width: about kStageFloats values of the k rows
long long stage_target(int k) {
  const long long cols = kStageFloats / k / 128 * 128;
  return cols < 128 ? 128 : cols;
}

Plan make_plan(int k, long long n) {
  Plan p{};
  p.k = k;
  p.pairs = k * (k + 1) / 2;
  p.pairs4 = (p.pairs + 3) & ~3;
  // chunks: one for each `target` columns, at most kInterleave, and no more
  // than the finish can stage; then each chunk's stage count rounded, and
  // the stage width (a multiple of 4 columns, within 5/4 of the target) that
  // covers N with it, so that the chunks' stage counts differ by one at most
  const long long target = stage_target(k);
  long long c = (n + target - 1) / target;
  if (c > kFinalFloats / p.pairs4) c = kFinalFloats / p.pairs4;
  if (c > kInterleave) c = kInterleave;
  long long per_chunk = (n + c * target / 2) / (c * target);
  if (per_chunk < 1) per_chunk = 1;
  long long cols = ((n + c * per_chunk - 1) / (c * per_chunk) + 3) & ~3LL;
  if (cols > target + target / 4) {
    ++per_chunk;
    cols = ((n + c * per_chunk - 1) / (c * per_chunk) + 3) & ~3LL;
  }
  p.stage_cols = static_cast<int>(cols);
  p.pitch = p.stage_cols + 4;
  p.stages = (n + p.stage_cols - 1) / p.stage_cols;
  p.chunks = static_cast<int>(c < p.stages ? c : p.stages);
  // tile pairs in row-major order of the upper triangle
  const int tiles = (k + kTile - 1) / kTile;
  int cost[kMaxTilePairs];
  p.tile_pairs = 0;
  for (int ti = 0; ti < tiles; ++ti) {
    for (int tj = ti; tj < tiles; ++tj) {
      const int t = p.tile_pairs++;
      p.tp_ri[t] = ti * kTile;
      p.tp_rj[t] = tj * kTile;
      p.tp_ni[t] = (k - ti * kTile < kTile) ? k - ti * kTile : kTile;
      p.tp_nj[t] = (k - tj * kTile < kTile) ? k - tj * kTile : kTile;
      const int ni = p.tp_ni[t], nj = p.tp_nj[t];
      if (ti == tj) {
        p.tp_shape[t] = ni - 1;
        cost[t] = ni * (ni + 1) / 2 + ni;        // fma + shared loads a column
      } else {
        p.tp_shape[t] = 7 + nj;                  // ni is 8 off the diagonal
        cost[t] = ni * nj + ni + nj;
      }
      p.tp_warps[t] = 1;
    }
  }
  // the other warps to the pair with the most work a warp (ties: the first)
  for (int used = p.tile_pairs; used < kSumWarps; ++used) {
    int best = 0;
    for (int t = 1; t < p.tile_pairs; ++t) {
      if (cost[t] * p.tp_warps[best] > cost[best] * p.tp_warps[t]) best = t;
    }
    ++p.tp_warps[best];
  }
  int w = 0;
  for (int t = 0; t < p.tile_pairs; ++t) {
    p.tp_warp0[t] = w;
    for (int u = 0; u < p.tp_warps[t]; ++u) p.warp_tp[w++] = t;
  }
  return p;
}

// the (i, j) entry's slot in a chunk's partial, i <= j: row-major upper triangle
__host__ __device__ __forceinline__ int pair_index(int i, int j, int k) {
  return i * k - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_address(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_address(smem)),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_address(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` more of bulk copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_address(bar)), "r"(bytes) : "memory");
}

// one arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_after_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_address(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_address(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* smem, const float* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_address(smem)), "l"(gmem), "r"(bytes), "r"(smem_address(bar)) : "memory");
}

__device__ __forceinline__ float lds(unsigned address) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(address));
  return v;
}

// one arrival (no bytes expected)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_address(bar)) : "memory");
}

// the summing warps' own barrier (named barrier 1), without the loading warp
__device__ __forceinline__ void sum_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSumThreads) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a row's offset mod 16 bytes, in floats: where its column c0 lands in a stage row
__device__ __forceinline__ int row_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Lane r < k of the loading warp copies columns [c0, c0 + w) of row r into a stage,
// column c0 + j to buf[r * pitch + shift_r + j]: the 16-byte aligned body in
// one bulk copy, the head and tail columns by 4-byte cp.async. The stage's
// barrier gets two arrivals a row: one that expects the body's bytes, one
// when the row's 4-byte copies have landed.
__device__ __forceinline__ void load_row(const float* __restrict__ x, long long ld, int r,
                                         long long c0, int w, float* buf, int pitch,
                                         uint64_t* bar) {
  const float* g = x + r * ld + c0;
  const int m = row_shift(g);
  const int head = min((4 - m) & 3, w);
  const int vecs = (w - head) >> 2;
  float* s = buf + r * pitch + m;
  mbar_arrive_expect(bar, 16u * vecs);
  if (vecs > 0) bulk_copy(s + head, g + head, 16u * vecs, bar);
  for (int j = 0; j < head; ++j) cp_async4(s + j, g + j);
  for (int j = head + 4 * vecs; j < w; ++j) cp_async4(s + j, g + j);
  mbar_arrive_after_cp_async(bar);
}

// One stage's columns into a tile pair's dot products: lane glane of the
// pair's gstride lanes takes columns glane, glane + gstride, ... The rows of
// tile i start at ri, those of tile j at rj; DIAG: the pair is a tile with
// itself (its upper triangle is formed).
template <int NI, int NJ, bool DIAG>
__device__ __forceinline__ void tile_columns(const float* buf, int pitch,
                                             const float* __restrict__ xc, long long ld, int ri,
                                             int rj, int w, int glane, int gstride,
                                             float (&acc)[kTile][kTile]) {
  // each row's shared-memory byte address at column 0 of the stage
  unsigned si[NI], sj[NJ];
#pragma unroll
  for (int a = 0; a < NI; ++a) {
    si[a] = smem_address(buf + (ri + a) * pitch + row_shift(xc + (ri + a) * ld));
  }
  if constexpr (!DIAG) {
#pragma unroll
    for (int b = 0; b < NJ; ++b) {
      sj[b] = smem_address(buf + (rj + b) * pitch + row_shift(xc + (rj + b) * ld));
    }
  }
#pragma unroll 1
  for (int j = glane; j < w; j += gstride) {
    const unsigned j4 = 4u * j;
    float vi[NI], vj[NJ];
#pragma unroll
    for (int a = 0; a < NI; ++a) vi[a] = lds(si[a] + j4);
    if constexpr (!DIAG) {
#pragma unroll
      for (int b = 0; b < NJ; ++b) vj[b] = lds(sj[b] + j4);
    }
#pragma unroll
    for (int a = 0; a < NI; ++a) {
#pragma unroll
      for (int b = DIAG ? a : 0; b < NJ; ++b) {
        acc[a][b] = fmaf(vi[a], DIAG ? vi[b] : vj[b], acc[a][b]);
      }
    }
  }
}

// One step of a warp's butterfly sum of 64 values a lane: lanes L and
// L ^ (H / 2) swap halves of their first 2H values, so that each keeps H
// sums. After the steps for H = 32, 16, 8, 4, 2, lane L holds the warp's
// sums of entries 2L and 2L + 1 in v[0] and v[1].
template <int H>
__device__ __forceinline__ void butterfly_step(float (&v)[kTile * kTile], int lane) {
  const bool upper = (lane & (H / 2)) != 0;
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const float send = upper ? v[e] : v[e + H];
    const float keep = upper ? v[e + H] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, H / 2);
  }
}

__device__ __forceinline__ unsigned int atomic_add_acq_rel(unsigned int* p, unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// ticket: the count of blocks done, 0 before a call and reset to 0 by the
// block that finishes it
__global__ void __launch_bounds__(kThreads, 1) model_distance_kernel(
    const float* __restrict__ x, long long ld, long long n, const __grid_constant__ Plan plan,
    float* __restrict__ work, unsigned int* __restrict__ ticket, float* __restrict__ out,
    float* __restrict__ scores) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[kSumWarps][kTile * kTile];
  __shared__ uint64_t s_full[kStages];     // a stage has landed
  __shared__ uint64_t s_empty[kStages];    // the summing warps are done with a slot
  __shared__ int s_chunk[kStages];         // the chunk of the stage in a slot; -1: none left
  __shared__ long long s_stage[kStages];   // its stage
  __shared__ unsigned int s_last;

  const int k = plan.k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pitch = plan.pitch;
  const int stage_floats = k * pitch;
  const int W = plan.stage_cols;
  const long long stages = plan.stages;
  const int chunks = plan.chunks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&s_full[s], 2 * k);
      mbar_init(&s_empty[s], kSumWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kSumWarps) {
    // the loading warp: lane r copies row r of each stage of the block's
    // chunks, in order, into the ring; then the mark that none is left
    for (int c = blockIdx.x, i = 0;; c += gridDim.x) {
      for (long long st = c; c < chunks && st < stages; st += chunks, ++i) {
        const int slot = i % kStages;
        if (i >= kStages) mbar_wait(&s_empty[slot], static_cast<unsigned>(i / kStages - 1) & 1u);
        if (lane == 0) {
          s_chunk[slot] = c;
          s_stage[slot] = st;
        }
        __syncwarp();
        if (lane < k) {
          const long long col = st * W;
          load_row(x, ld, lane, col, static_cast<int>(min(static_cast<long long>(W), n - col)),
                   smem + slot * stage_floats, pitch, &s_full[slot]);
        }
      }
      if (c >= chunks) {
        const int slot = i % kStages;
        if (i >= kStages) mbar_wait(&s_empty[slot], static_cast<unsigned>(i / kStages - 1) & 1u);
        if (lane == 0) s_chunk[slot] = -1;
        __syncwarp();
        if (lane < k) {
          mbar_arrive(&s_full[slot]);
          mbar_arrive(&s_full[slot]);
        }
        break;
      }
    }
  } else {
    const int tp = plan.warp_tp[warp];
    const int ri = plan.tp_ri[tp], rj = plan.tp_rj[tp];
    const int shape = plan.tp_shape[tp];
    const int glane = (warp - plan.tp_warp0[tp]) * 32 + lane;
    const int gstride = plan.tp_warps[tp] * 32;

    float acc[kTile][kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) acc[a][b] = 0.0f;

#pragma unroll 1
    for (int it = 0;; ++it) {
      const int slot = it % kStages;
      mbar_wait(&s_full[slot], static_cast<unsigned>(it / kStages) & 1u);
      const int chunk = s_chunk[slot];
      const long long stage = s_stage[slot];
      if (chunk < 0) break;

      const long long col = stage * W;
      const int w = static_cast<int>(min(static_cast<long long>(W), n - col));
      const float* buf = smem + slot * stage_floats;
      const float* xc = x + col;
      switch (shape) {
#define MD_DIAG(N) \
  case N - 1: tile_columns<N, N, true>(buf, pitch, xc, ld, ri, rj, w, glane, gstride, acc); break;
#define MD_OFF(N) \
  case 7 + N: tile_columns<8, N, false>(buf, pitch, xc, ld, ri, rj, w, glane, gstride, acc); break;
        MD_DIAG(1) MD_DIAG(2) MD_DIAG(3) MD_DIAG(4) MD_DIAG(5) MD_DIAG(6) MD_DIAG(7) MD_DIAG(8)
        MD_OFF(1) MD_OFF(2) MD_OFF(3) MD_OFF(4) MD_OFF(5) MD_OFF(6) MD_OFF(7) MD_OFF(8)
#undef MD_DIAG
#undef MD_OFF
        default: break;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_empty[slot]);

      if (stage + chunks >= stages) {
        // the chunk's last stage: its partial Gram. A warp's lanes first, by
        // a butterfly that halves the values a lane holds at each step (lane
        // L ends with entries 2L and 2L + 1 of the 8 x 8 tile), then the
        // pair's warps in order.
        float v[kTile * kTile];
#pragma unroll
        for (int e = 0; e < kTile * kTile; ++e) {
          v[e] = acc[e / kTile][e % kTile];
          acc[e / kTile][e % kTile] = 0.0f;
        }
        butterfly_step<32>(v, lane);
        butterfly_step<16>(v, lane);
        butterfly_step<8>(v, lane);
        butterfly_step<4>(v, lane);
        butterfly_step<2>(v, lane);
        s_red[warp][2 * lane] = v[0];
        s_red[warp][2 * lane + 1] = v[1];
        sum_warps_sync();
        float* slot_out = work + static_cast<long long>(chunk) * plan.pairs4;
        for (int e = tid; e < plan.tile_pairs * kTile * kTile; e += kSumThreads) {
          const int t = e / (kTile * kTile);
          const int a = (e / kTile) % kTile;
          const int b = e % kTile;
          if (a < plan.tp_ni[t] && b < plan.tp_nj[t] &&
              (plan.tp_ri[t] != plan.tp_rj[t] || b >= a)) {
            float sum = 0.0f;
            for (int u = plan.tp_warp0[t]; u < plan.tp_warp0[t] + plan.tp_warps[t]; ++u) {
              sum += s_red[u][a * kTile + b];
            }
            slot_out[pair_index(plan.tp_ri[t] + a, plan.tp_rj[t] + b, k)] = sum;
          }
        }
        sum_warps_sync();   // s_red is free for the next chunk
      }
    }
  }

  // the last block to finish sums the chunks' partials: the block's writes,
  // then the ticket with release and acquire at gpu scope
  __syncthreads();
  if (tid == 0) s_last = atomic_add_acq_rel(ticket, 1u) == gridDim.x - 1 ? 1u : 0u;
  __syncthreads();
  if (!s_last) return;

  // each dot product over the chunks in a fixed order: `sets` (about the
  // root of the chunk count) interleaved sets of chunks, each summed in
  // chunk order, then the sets in order
  const int pairs = plan.pairs, pairs4 = plan.pairs4;
  const int partial_floats = chunks * pairs4;
  for (int v = tid; v < partial_floats / 4; v += kThreads) cp_async16(smem + 4 * v, work + 4 * v);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  int sets = 1;
  while (sets * sets < chunks && (sets + 1) * pairs <= kThreads) ++sets;
  float* set_sums = smem + partial_floats;            // sets * pairs <= kThreads + pairs4
  float* gram = set_sums + kThreads + pairs4;
  float* dmat = gram + pairs4;
  for (int t = tid; t < sets * pairs; t += kThreads) {
    const int p = t % pairs;
    float sum = 0.0f;
    for (int c = t / pairs; c < chunks; c += sets) sum += smem[c * pairs4 + p];
    set_sums[t] = sum;
  }
  __syncthreads();
  for (int p = tid; p < pairs; p += kThreads) {
    float sum = 0.0f;
    for (int q = 0; q < sets; ++q) sum += set_sums[q * pairs + p];
    gram[p] = sum;
  }
  __syncthreads();
  for (int p = tid; p < pairs; p += kThreads) {
    int i = 0, rest = p;
    while (rest >= k - i) {
      rest -= k - i;
      ++i;
    }
    const int j = i + rest;
    const float sq_i = gram[pair_index(i, i, k)];
    const float sq_j = gram[pair_index(j, j, k)];
    const float d = __fsub_rn(__fadd_rn(sq_i, sq_j), __fmul_rn(2.0f, gram[p]));
    out[i * k + j] = d;
    out[j * k + i] = d;
    dmat[i * k + j] = d;
    dmat[j * k + i] = d;
  }
  if (scores != nullptr) {
    __syncthreads();
    if (tid < k) {
      float sum = 0.0f;
      for (int j = 0; j < k; ++j) {
        if (j != tid) sum = __fadd_rn(sum, dmat[tid * k + j]);
      }
      scores[tid] = __fdiv_rn(sum, static_cast<float>(k > 1 ? k - 1 : 1));
    }
  }
  if (tid == 0) *ticket = 0u;   // ready for the next call on this counter
}

size_t smem_bytes(const Plan& p) {
  const long long ring = static_cast<long long>(kStages) * p.k * p.pitch;
  const long long finish =
      static_cast<long long>(p.chunks) * p.pairs4 + kThreads + 2 * p.pairs4 + p.k * p.k;
  return static_cast<size_t>(4 * (ring > finish ? ring : finish));
}

// the most dynamic shared memory any (k, N) asks for: the widest ring, or
// the finish with the most chunks
size_t max_smem_bytes() {
  size_t most = 0;
  for (int k = 1; k <= kMaxK; ++k) {
    const long long target = stage_target(k);
    const long long cols = target + target / 4 + 4;
    const long long pairs4 = (k * (k + 1) / 2 + 3) & ~3;
    long long chunks = kFinalFloats / pairs4;
    if (chunks > kInterleave) chunks = kInterleave;
    const long long ring = static_cast<long long>(kStages) * k * (cols + 4);
    const long long finish = chunks * pairs4 + kThreads + 2 * pairs4 + k * k;
    const size_t b = static_cast<size_t>(4 * (ring > finish ? ring : finish));
    if (b > most) most = b;
  }
  return most;
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];       // 0: not set up on that device yet

cudaError_t setup(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[device] != 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(model_distance_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(max_smem_bytes()));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  g_sms[device] = sms;
  return cudaSuccess;
}

cudaError_t grid_size(int device, const Plan& p, int* grid) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, model_distance_kernel, kThreads, smem_bytes(p));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * g_sms[device];
  *grid = static_cast<int>(resident < p.chunks ? resident : p.chunks);
  return cudaSuccess;
}

}  // namespace

// Floats of workspace a call with these sizes needs (the wrapper allocates it).
extern "C" long long model_distance_workspace(int k, long long n) {
  if (k < 1 || k > kMaxK || n < 1) return -1;
  const Plan p = make_plan(k, n);
  return static_cast<long long>(p.chunks) * p.pairs4;
}

// The plan of a call, for reports: info[0] chunks, [1] stages, [2]
// columns a stage, [3] dynamic shared memory bytes, [4] blocks in the grid,
// [5] tile pairs. Returns the cudaError_t of the device queries.
extern "C" int model_distance_info(int k, long long n, int device, long long* info) {
  if (k < 1 || k > kMaxK || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = setup(device);
  const Plan p = make_plan(k, n);
  int grid = 0;
  if (err == cudaSuccess) err = grid_size(device, p, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = p.chunks;
  info[1] = p.stages;
  info[2] = p.stage_cols;
  info[3] = static_cast<long long>(smem_bytes(p));
  info[4] = grid;
  info[5] = p.tile_pairs;
  return 0;
}

// x: (k, n) f32 rows with row stride ld (elements), unit column stride; out:
// (k, k) f32, contiguous; scores: (k,) f32 or null; work:
// model_distance_workspace(k, n) floats, 16-byte aligned; ticket: one
// unsigned int, 0 before the first call and reset by each call (calls that
// share it must not overlap). Device pointers; stream is a cudaStream_t.
// One launch; returns its cudaError_t (0 on success).
extern "C" int model_distance(const float* x, long long ld, int k, long long n, float* out,
                              float* scores, float* work, unsigned int* ticket, int device,
                              void* stream) {
  if (k < 1 || k > kMaxK || n < 1 || ld < n) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(work) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = setup(device);
  const Plan plan = make_plan(k, n);
  int grid = 0;
  if (err == cudaSuccess) err = grid_size(device, plan, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  model_distance_kernel<<<grid, kThreads, smem_bytes(plan), static_cast<cudaStream_t>(stream)>>>(
      x, ld, n, plan, work, ticket, out, scores);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* model_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
