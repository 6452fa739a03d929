// Fused stage A for Hopper (sm_90a) on the CUDA cores, for an f32 corpus
// wider than the tensor-core kernel takes: dense scores of one corpus tile
// for a group of queries, and each query's 16 best rows of the tile, in one
// pass. A bf16 corpus, and an f32 one of D <= 2,912, take
// stage_a_wgmma.cu (the f32 products as 3xTF32), whose queries (hi and lo
// copies) no longer fit its shared memory beyond that width.
//
// Replaces _stage_a_kernel of review_recommender_tpu/ops/pallas/
// stage_a_kernel.py (stage_a_fused_pallas) for f32. For each 2048-row tile
// t and query b:
//   score[r] = f32 sum over k of emb[r][k] * q_b[k];
//   score[r] = -3.4e38f where valid[r] == 0 or r >= n (the tail of the last
//              tile, which the TPU function receives as zero padding);
//   16 rounds: (the largest remaining score, the lowest local index among
//              equal ones), then that row's score becomes -3.4e38f;
//   out_s[t][m][b], out_i[t][m][b] = round m's score and local index.
// Once a tile has no valid row left, a round finds -3.4e38f and returns the
// lowest index holding it, often one chosen before, so ids repeat, as they
// do in the TPU kernel. The global merge, the postings gather and the BM25
// sum stay in torch (ops/stage_a.py), as the JAX package keeps them in XLA.
//
// What bounds it: one read of the corpus (N * D * 4 bytes, 2.47 GB at N =
// 200,704, D = 3,072: ~0.74 ms of HBM) against 2 * N * D * B FLOP of
// products (39.5 GFLOP at B = 32: ~0.59 ms on the f32 CUDA cores at 67
// TFLOP/s). This design (the port's first, from when it took bf16 and
// every f32 width too) spends CUDA-core FMAs on them: a block of 256
// threads takes one tile and a group of 8 queries (blockIdx.x = group, so
// the blocks that share a tile run side by side and all but one read it
// from L2).
// The group's query vectors sit in shared memory as f32 (8 * D * 4
// bytes) and are read as broadcast 16-byte loads; each thread scores whole
// rows with 16-byte loads along the row, four in flight, 8 accumulators.
// The 2048 x 8 scores go to shared memory (64 KB), and each warp then runs
// one query's 16 rounds: a strided scan for each lane's first maximum and
// a 5-step shuffle reduction of (score, index) pairs, ties to the lower
// index.
//
// The kernel allocates nothing and does not synchronise; it launches on the
// stream it is given and the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 2048;
constexpr int kRounds = 16;  // M_PER_TILE
constexpr int kGroup = 8;    // queries per block, one selecting warp each
constexpr int kThreads = kGroup * 32;
constexpr float kNeg = -3.4e38f;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may take
// The widest f32 corpus stage_a_wgmma.cu takes (rrt_stage_a_tf32_max_dim);
// this route takes the wider ones only.
constexpr int kTf32MaxDim = 2912;

template <typename T>
struct Row;

// 16 bytes = 4 f32 values.
template <>
struct Row<float> {
  static constexpr int kPerVec = 4;
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void widen(const uint4 v, float (&x)[kPerVec]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

// acc[j] += row elements of vector v * query j's matching elements. q_v
// points at element v * kPerVec of query 0; query j is d floats further.
template <typename T>
__device__ __forceinline__ void fma_vec(const uint4 v, const float* __restrict__ q_v, int d,
                                        float (&acc)[kGroup]) {
  constexpr int E = Row<T>::kPerVec;
  float x[E];
  Row<T>::widen(v, x);
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float4* q4 = reinterpret_cast<const float4*>(q_v + (size_t)j * d);
#pragma unroll
    for (int e4 = 0; e4 < E / 4; ++e4) {
      const float4 q = q4[e4];  // the same address in every lane: a broadcast
      acc[j] = fmaf(x[4 * e4 + 0], q.x, acc[j]);
      acc[j] = fmaf(x[4 * e4 + 1], q.y, acc[j]);
      acc[j] = fmaf(x[4 * e4 + 2], q.z, acc[j]);
      acc[j] = fmaf(x[4 * e4 + 3], q.w, acc[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stage_a_tile_kernel(const T* __restrict__ emb, const uint8_t* __restrict__ valid,
                    const float* __restrict__ qvecs, float* __restrict__ out_s,
                    int32_t* __restrict__ out_i, int n, int d, int b) {
  constexpr int E = Row<T>::kPerVec;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                // [kGroup][d], rounded to T
  float* s_sc = smem + kGroup * d;  // [kGroup][kTileN]
  const int g0 = blockIdx.x * kGroup;
  const int tile = blockIdx.y;
  const int row0 = tile * kTileN;
  const int nq = min(kGroup, b - g0);

  for (int i = threadIdx.x; i < kGroup * d; i += kThreads) {
    const int j = i / d;
    s_q[i] = j < nq ? Row<T>::round(qvecs[(size_t)(g0 + j) * d + (i - j * d)]) : 0.0f;
  }
  __syncthreads();

  // scores: one thread per row, rows tid, tid + 256, ...
  const int nvec = d / E;  // 16-byte vectors per row
  for (int r = threadIdx.x; r < kTileN; r += kThreads) {
    const int row = row0 + r;
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
    const bool live = row < n && valid[row] != 0;
    if (live) {
      const uint4* p = reinterpret_cast<const uint4*>(emb + (size_t)row * d);
      int v = 0;
      for (; v + 4 <= nvec; v += 4) {
        uint4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = __ldg(p + v + u);
#pragma unroll
        for (int u = 0; u < 4; ++u) fma_vec<T>(w[u], s_q + (v + u) * E, d, acc);
      }
      for (; v < nvec; ++v) fma_vec<T>(__ldg(p + v), s_q + v * E, d, acc);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) s_sc[j * kTileN + r] = live ? acc[j] : kNeg;
  }
  __syncthreads();

  // selection: warp j runs query g0 + j's rounds over its 2048 scores
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= nq) return;
  float* sc = s_sc + warp * kTileN;
  for (int m = 0; m < kRounds; ++m) {
    float best = sc[lane];
    int arg = lane;
    for (int i = lane + 32; i < kTileN; i += 32) {  // ascending: strict > keeps the first
      const float s = sc[i];
      if (s > best) {
        best = s;
        arg = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (lane == 0) {
      const size_t o = ((size_t)tile * kRounds + m) * b + g0 + warp;
      out_s[o] = best;
      out_i[o] = arg;
      sc[arg] = kNeg;
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* emb, const void* valid, const void* qvecs, void* out_s,
                   void* out_i, int n, int d, int b, cudaStream_t stream) {
  const size_t smem = (size_t)kGroup * (d + kTileN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stage_a_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kGroup - 1) / kGroup, (n + kTileN - 1) / kTileN);
  stage_a_tile_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(emb), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(qvecs), static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i), n, d, b);
  return cudaGetLastError();
}

}  // namespace

// emb (N, D) f32, 16-byte aligned with D a multiple of 4 and D > 2,912
// (narrower corpora take rrt_stage_a_tf32); valid (N,) bool;
// qvecs (B, D) f32, 16-byte aligned; out_s (n_tiles, 16, B) f32 and out_i
// (n_tiles, 16, B) int32 with n_tiles = ceil(N / 2048) <= 65535; all
// contiguous on one device. Returns a cudaError_t (0 = launched).
extern "C" int rrt_stage_a_fma(const void* emb, const void* valid, const void* qvecs,
                               void* out_s, void* out_i, int n, int d, int b, void* stream) {
  const long long n_tiles = ((long long)n + kTileN - 1) / kTileN;
  if (n <= 0 || d <= kTf32MaxDim || b <= 0 || d % 4 != 0 || n_tiles > 65535 ||
      (long long)kGroup * (d + kTileN) * 4 > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)launch<float>(emb, valid, qvecs, out_s, out_i, n, d, b,
                            static_cast<cudaStream_t>(stream));
}
