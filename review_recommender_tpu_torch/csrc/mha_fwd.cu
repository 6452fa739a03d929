// Fused multi-head attention forward for the BERT towers, for Hopper (sm_90a).
//
// Replaces the TPU kernel review_recommender_tpu/ops/pallas/attention_kernel.py
// (_mha_kernel, reached through mha_pallas). For each (batch, head) it computes
//   softmax(Q K^T * 1/sqrt(d) + key_bias) V
// in the same order and precision as that kernel and its XLA reference:
//   1. f32 logits (bf16/f16 products are exact in f32), times 1/sqrt(d);
//   2. + key_bias in f32 (0 keep, -1e30 drop);
//   3. row max, exp, sum and divide, all f32;
//   4. probabilities rounded to the input type;
//   5. P V accumulated in f32, rounded to the input type on store.
// A row whose keys are all masked has equal logits (-1e30 + x == -1e30 in f32)
// and comes out uniform, as on the TPU; no key is skipped.
//
// Layout: q, k, v and out are (B, S, H*D) row-major, as the Linear layers
// write them; each block finds its head's columns from blockIdx and the row
// stride H*D, so no transpose to (B, H, S, D) is made. key_bias is (B, S) f32.
//
// What bounds it: at the cross-encoder's rerank shape (B=64, S=512, H=12,
// D=32) QK^T and PV are 4*B*H*S*S*D = 25.8 GFLOP against ~100 MB of q, k, v
// and out, about 256 FLOP per byte -- near the H100's bf16 ridge (~295), so
// neither HBM nor the tensor cores alone bound a good kernel. This first
// design keeps everything that is S x S out of device memory (the plain torch
// version writes and re-reads a (B, H, S, S) f32 tensor, 805 MB at that
// shape) and spends f32 CUDA-core FMAs on the two contractions, fed from
// shared memory: it is bound by shared-memory loads and FP32 issue, not by
// HBM. A block holds 32 query rows' full f32 logit rows (S <= 512 fits), so
// the softmax needs no online rescaling and rounds like the TPU kernel.
// Register micro-tiles (4 rows x 2-4 keys or 4 rows x 4 keys per lane) cut the
// shared-memory loads per FMA; K/V rows use an odd 32-bit word stride so the
// column walks are bank-conflict free. wgmma/TMA tiling is later work.
//
// The kernel allocates nothing and does not synchronise; it launches on the
// stream it is given and the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 4
constexpr int kMaxSeq = 512;

template <typename T>
struct Cvt;

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float2 pair(uint32_t w) {
    __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w);
    return __bfloat1622float2(p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float2 pair(uint32_t w) {
    __half2 p = *reinterpret_cast<const __half2*>(&w);
    return __half22float2(p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 p = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy S rows of one head (D values of type T each, 16-byte chunks) from a
// (B, S, H*D) tensor into shared memory as 32-bit pairs with row stride kvw
// words; rows S..Sp-1 are zero-filled so padding contributes exactly 0.
template <int D>
__device__ __forceinline__ void load_head(uint32_t* dst, const uint16_t* src, long row_stride,
                                          int S, int Sp, int kvw) {
  constexpr int kChunks = D / 8;  // uint4 = 8 elements
  for (int i = threadIdx.x; i < Sp * kChunks; i += kThreads) {
    const int j = i / kChunks, c = i % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (j < S) x = *reinterpret_cast<const uint4*>(src + (long)j * row_stride + c * 8);
    uint32_t* row = dst + j * kvw + c * 4;
    row[0] = x.x;
    row[1] = x.y;
    row[2] = x.z;
    row[3] = x.w;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const float* __restrict__ key_bias,
               uint16_t* __restrict__ out, int S, int H, float scale) {
  using C = Cvt<T>;
  constexpr int kPairs = D / 2;
  constexpr int kvw = kPairs + 1;  // odd word stride: conflict-free column walks
  // PV lane layout: lanes cover pairs, and for D = 32 (16 pairs) two lane
  // groups split each 32-key chunk into halves 16 rows apart (16 * 17 words
  // = bank offset 16, so the two halves hit disjoint banks).
  constexpr int kLanesP = kPairs < 32 ? kPairs : 32;
  constexpr int kPairsPerLane = kPairs / kLanesP;
  constexpr int kSplit = 32 / kLanesP;  // 1 or 2
  constexpr int kKeysPerSplit = 32 / kSplit;

  const int Sp = (S + 31) & ~31;
  extern __shared__ __align__(16) unsigned char smem[];
  float* logits = reinterpret_cast<float*>(smem);  // kRows x Sp
  float* q_s = logits + kRows * Sp;                // kRows x D
  float* bias_s = q_s + kRows * D;                 // Sp
  uint32_t* kv = reinterpret_cast<uint32_t*>(bias_s + Sp);  // Sp x kvw

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long HD = (long)H * D;
  const long head0 = (long)b * S * HD + (long)h * D;  // element (b, 0, h*D)

  // ---- stage Q (as f32), the bias row and K ----
  for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    float* dst = q_s + r * D + c * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) x = *reinterpret_cast<const uint4*>(q + head0 + (long)(row0 + r) * HD + c * 8);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = C::pair(w[t]);
      dst[2 * t] = f.x;
      dst[2 * t + 1] = f.y;
    }
  }
  for (int j = threadIdx.x; j < Sp; j += kThreads) bias_s[j] = j < S ? key_bias[(long)b * S + j] : 0.f;
  load_head<D>(kv, k + head0, HD, S, Sp, kvw);
  __syncthreads();

  const int r0 = warp * kRowsPerWarp;  // this warp's first local query row

  // ---- logits = (Q K^T) * scale + bias: one key per lane, 4 rows ----
  for (int j = lane; j < S; j += 32) {
    float acc[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t* krow = kv + j * kvw;
#pragma unroll 4
    for (int p = 0; p < kPairs; p += 2) {
      const float2 k0 = C::pair(krow[p]);
      const float2 k1 = C::pair(krow[p + 1]);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (r0 + rr) * D + 2 * p);
        acc[rr] += qv.x * k0.x;
        acc[rr] += qv.y * k0.y;
        acc[rr] += qv.z * k1.x;
        acc[rr] += qv.w * k1.y;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
      logits[(r0 + rr) * Sp + j] = __fadd_rn(__fmul_rn(acc[rr], scale), bias_s[j]);
  }
  __syncwarp();

  // ---- row softmax in f32; probabilities rounded to T; padding keys 0 ----
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    float* row = logits + (r0 + rr) * Sp;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Sp; j += 32) row[j] = j < S ? C::round(__fdiv_rn(row[j], sum)) : 0.f;
  }
  __syncthreads();  // every warp is done with K

  load_head<D>(kv, v + head0, HD, S, Sp, kvw);
  __syncthreads();

  // ---- out = P V: 4 rows x kPairsPerLane pairs per lane, keys by 4 ----
  const int lp = lane % kLanesP, split = lane / kLanesP;
  float2 acc[kRowsPerWarp][kPairsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int c = 0; c < kPairsPerLane; ++c) acc[rr][c] = make_float2(0.f, 0.f);

  for (int j0 = 0; j0 < Sp; j0 += 32) {
#pragma unroll
    for (int g = 0; g < kKeysPerSplit; g += 4) {
      const int j = j0 + split * kKeysPerSplit + g;
      float4 prob[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        prob[rr] = *reinterpret_cast<const float4*>(logits + (r0 + rr) * Sp + j);
#pragma unroll
      for (int c = 0; c < kPairsPerLane; ++c) {
        const int p = lp + c * kLanesP;
        const float2 v0 = C::pair(kv[(j + 0) * kvw + p]);
        const float2 v1 = C::pair(kv[(j + 1) * kvw + p]);
        const float2 v2 = C::pair(kv[(j + 2) * kvw + p]);
        const float2 v3 = C::pair(kv[(j + 3) * kvw + p]);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          float2& a = acc[rr][c];
          a.x += prob[rr].x * v0.x;
          a.y += prob[rr].x * v0.y;
          a.x += prob[rr].y * v1.x;
          a.y += prob[rr].y * v1.y;
          a.x += prob[rr].z * v2.x;
          a.y += prob[rr].z * v2.y;
          a.x += prob[rr].w * v3.x;
          a.y += prob[rr].w * v3.y;
        }
      }
    }
  }
  if (kSplit == 2) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int c = 0; c < kPairsPerLane; ++c) {
        acc[rr][c].x += __shfl_down_sync(0xffffffffu, acc[rr][c].x, 16);
        acc[rr][c].y += __shfl_down_sync(0xffffffffu, acc[rr][c].y, 16);
      }
  }
  if (split == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int s = row0 + r0 + rr;
      if (s >= S) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(out + head0 + (long)s * HD);
#pragma unroll
      for (int c = 0; c < kPairsPerLane; ++c) {
        const int p = lp + c * kLanesP;
        orow[p] = C::pack(acc[rr][c].x, acc[rr][c].y);
      }
    }
  }
}

size_t smem_bytes(int S, int D) {
  const int Sp = (S + 31) & ~31;
  return sizeof(float) * ((size_t)kRows * Sp + (size_t)kRows * D + Sp) +
         sizeof(uint32_t) * (size_t)Sp * (D / 2 + 1);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int S, int H, cudaStream_t stream) {
  auto kern = mha_fwd_kernel<T, D>;
  const size_t smem = smem_bytes(S, D);
  static size_t smem_set = 0;  // the opt-in is per kernel instance, not per call
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), bias, static_cast<uint16_t*>(out), S, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const float* bias, void* out,
                       int B, int S, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, bias, out, B, S, H, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, B, S, H, stream);
    case 128: return launch<T, 128>(q, k, v, bias, out, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Shapes: q, k, v, out (B, S, H*D)
// contiguous and 16-byte aligned; key_bias (B, S) f32 contiguous.
// Returns a cudaError_t (0 = launched).
extern "C" int rrt_mha_fwd(int dtype, const void* q, const void* k, const void* v,
                           const void* key_bias, void* out, int B, int S, int H, int D,
                           void* stream) {
  if (B <= 0 || S <= 0 || S > kMaxSeq || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(key_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<__nv_bfloat16>(q, k, v, bias, out, B, S, H, D, st);
    case 1: return (int)dispatch_d<__half>(q, k, v, bias, out, B, S, H, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory the kernel asks for at (S, D), for the wrapper's
// checks and reports.
extern "C" long long rrt_mha_fwd_smem_bytes(int S, int D) { return (long long)smem_bytes(S, D); }
