// Multi-head attention forward for Hopper (sm_90a) on the CUDA cores: the
// types, head widths and layouts that the tensor-core kernel (mha_fwd.cu)
// does not take.
//
// Replaces, beside mha_fwd.cu, the TPU kernel
// review_recommender_tpu/ops/pallas/attention_kernel.py (_mha_kernel,
// reached through mha_pallas), which runs one (batch, head) in the input
// type for any float type, head width and sequence length. mha_fwd.cu
// takes bf16/f16 at D in {32, 64, 128}; this kernel takes the rest:
//   - f32, bf16 and f16 inputs (ops/attention.py:kernel_route sends f32
//     and every other head width here);
//   - any head width D from 1 to 256 and any H*D row stride: a TMA box row
//     must be a multiple of 16 bytes (D = 26 is 52 bytes in bf16), wgmma
//     needs K in steps of 16, and the columns past D in a row belong to the
//     next head, so neither TMA nor a zero-padded wgmma can read such a
//     head; this kernel reads it with masked element loads;
//   - any S >= 1.
// For each (batch, head) it computes softmax(Q K^T * 1/sqrt(d) + key_bias)
// V with q, k, v and out (B, S, H*D) row-major, read in place, and key_bias
// (B, S) f32 (0 keep, -1e30 drop).
//
// Design. One CTA of 128 threads takes BQ query rows of one (b, h) and
// walks the keys in tiles of BK. Every tile is converted to f32 on its way
// into shared memory and padded with zeros to a compile-time width DP (16,
// 32, 64, 128 or 256 >= D). The threads form a 16 x 8 grid: thread (ty, tx)
// owns RM query rows (ty*RM ..) and, of each key tile, the keys
// 4*tx + 32*j + e (e < 4), and of the output the columns VW*tx + 8*VW*j + e;
// rows stay with one thread row, so the row max and sum live in registers
// and reduce over the 8 threads of a row by shuffles.
//   - S = Q K^T in full f32 FMA (no TF32: f32 towers are held to the plain
//     version within 1e-5). Q and K are stored transposed (d-major), so a
//     thread reads its RM rows and its keys as float4s.
//   - Softmax in two passes, as mha_fwd.cu and as the plain version rounds:
//     pass 1 computes S for every tile and keeps the running row max and
//     sum (the sum rescaled by exp(m_old - m_new) when the max moves);
//     pass 2 computes S again and P = exp(s - m) / l, the f32 probability,
//     rounded to the input type (a no-op in f32) and written to shared
//     memory, then O += P V in f32 with V read as it lies (keys, D).
//   - The logits follow the plain version's op order: (q . k) * scale,
//     then + bias, each rounded alone (no FMA contraction), exp and an
//     IEEE division.
// Semantics kept from mha_fwd.cu:
//   - an all-masked row (every bias -1e30) comes out uniform over the S
//     real keys: (q.k)*scale - 1e30 == -1e30 in f32;
//   - keys from S to the tile edge get logit -inf and zero V rows;
//   - query rows >= S and columns >= D are not stored.
//
// What bounds it. f32 at the cross-encoder's rerank shape (B=64, S=512,
// H=12, D=32) on an H100 SXM: 4*B*H*S*S*D = 25.8 GFLOP at the 67 TFLOP/s
// of f32 FMA is 0.385 ms, against 201 MB of HBM traffic, 0.060 ms; the two
// passes compute Q K^T twice (1.5x the flops). At D = 26 in bf16 the same
// work runs on the CUDA cores too, padded to DP = 32. Several CTAs are
// resident on an SM (31-111 KB of shared memory), so one CTA's loads
// overlap another's arithmetic; the tile loads themselves are synchronous.
//
// The kernel allocates nothing and does not synchronise; it launches on the
// stream it is given and the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 8;   // threads across keys and output columns
constexpr int kTY = 16;  // threads across query rows
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// N consecutive floats from shared memory (N in {1, 2, 4}, aligned to N).
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

template <int N>
__device__ __forceinline__ void sts(float* dst, const float (&src)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// Reduce over the 8 threads of a row (lanes differing in their low 3 bits).
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Tile geometry at padded head width DP: RM query rows a thread, BK keys a
// tile. Shared memory in floats: Q^T (DP, BQ+4), K^T (DP, BK+4), V (BK, DP),
// P^T (BK, BQ+4), the tile's bias (BK). The +4 keeps rows 16-byte aligned
// and spreads the transposing stores over more banks.
template <int DP>
struct Cfg {
  static constexpr int RM = DP == 256 ? 2 : 4;
  static constexpr int BQ = kTY * RM;
  static constexpr int BK = DP >= 128 ? 32 : 64;
  static constexpr int KJ = BK / 32;          // float4 groups of keys a thread
  static constexpr int KPT = 4 * KJ;          // keys a thread
  static constexpr int CPT = DP / kTX;        // output columns a thread
  static constexpr int VW = CPT < 4 ? CPT : 4;
  static constexpr int CJ = CPT / VW;
  static constexpr int QS = BQ + 4;
  static constexpr int KS = BK + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + DP * QS;
  static constexpr int kV = kK + DP * KS;
  static constexpr int kP = kV + BK * DP;
  static constexpr int kB = kP + BK * QS;
  static constexpr int kFloats = kB + BK;
  static constexpr int kSmemBytes = kFloats * 4;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
mha_generic_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ key_bias, T* __restrict__ out, int S, int H, int D,
                   float scale) {
  using C = Cfg<DP>;
  constexpr int RM = C::RM, BQ = C::BQ, BK = C::BK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + C::kQ;
  float* sK = smem + C::kK;
  float* sV = smem + C::kV;
  float* sP = smem + C::kP;
  float* sB = smem + C::kB;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const long long HD = (long long)H * D;
  const long long base = (long long)b * S * HD + (long long)h * D;  // (b, row 0, head h)
  const int ntiles = (S + BK - 1) / BK;

  // Q^T: element (row r, column d) at sQ[d * QS + r], zero past S and D
  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, row = q0 + r;
    sQ[d * C::QS + r] = (row < S && d < D) ? to_f32(q[base + row * HD + d]) : 0.f;
  }

  // one key tile into shared memory: K^T, V (pass 2) and the bias, with
  // keys past S zero in K and V and -inf in the bias
  auto load_tile = [&](int t, bool with_v) {
    const int k0 = t * BK;
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int j = i / DP, d = i % DP, key = k0 + j;
      const bool in = key < S && d < D;
      const long long at = base + key * HD + d;
      sK[d * C::KS + j] = in ? to_f32(k[at]) : 0.f;
      if (with_v) sV[j * DP + d] = in ? to_f32(v[at]) : 0.f;
    }
    for (int j = tid; j < BK; j += kThreads) {
      const int key = k0 + j;
      sB[j] = key < S ? key_bias[(long long)b * S + key] : -INFINITY;
    }
  };

  // S = Q K^T for this thread's RM rows and KPT keys, as logits
  auto logits = [&](float (&s)[RM][C::KPT]) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < C::KPT; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RM], kv[C::KPT];
      lds<RM>(qv, sQ + d * C::QS + ty * RM);
#pragma unroll
      for (int j = 0; j < C::KJ; ++j) {
        float t4[4];
        lds<4>(t4, sK + d * C::KS + 32 * j + 4 * tx);
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[4 * j + e] = t4[e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < C::KPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int j = 0; j < C::KJ; ++j) {
      float bb[4];
      lds<4>(bb, sB + 32 * j + 4 * tx);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[i][4 * j + e] = __fadd_rn(__fmul_rn(s[i][4 * j + e], scale), bb[e]);
    }
  };

  // ---- pass 1: running row max and row sum ----
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // the previous tile is read (and, before tile 0, Q is stored)
    load_tile(t, false);
    __syncthreads();
    float s[RM][C::KPT];
    logits(s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < C::KPT; ++c) mx = fmaxf(mx, s[i][c]);
      mx = row_max(mx);
      // tile 0 holds key 0 (finite bias), so mx is finite and
      // exp(-inf - mx) = 0 clears the empty sum
      l[i] *= expf(m[i] - mx);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < C::KPT; ++c) l[i] += expf(s[i][c] - mx);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) l[i] = row_sum(l[i]);

  // ---- pass 2: P = exp(s - m) / l, rounded to T; O += P V ----
  float o[RM][C::CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) o[i][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile(t, true);
    __syncthreads();
    float s[RM][C::KPT];
    logits(s);
#pragma unroll
    for (int c = 0; c < C::KPT; ++c) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        p[i] = to_f32(from_f32<T>(__fdiv_rn(expf(s[i][c] - m[i]), l[i])));
      const int key = 32 * (c / 4) + 4 * tx + c % 4;
      sts<RM>(sP + key * C::QS + ty * RM, p);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RM];
      lds<RM>(pv, sP + j * C::QS + ty * RM);
#pragma unroll
      for (int cj = 0; cj < C::CJ; ++cj) {
        float vv[C::VW];
        lds<C::VW>(vv, sV + j * DP + 8 * C::VW * cj + C::VW * tx);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < C::VW; ++e)
            o[i][C::VW * cj + e] = fmaf(pv[i], vv[e], o[i][C::VW * cj + e]);
      }
    }
  }

  // ---- out = O, rows >= S and columns >= D not stored ----
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= S) continue;
    T* orow = out + base + row * HD;
#pragma unroll
    for (int cj = 0; cj < C::CJ; ++cj)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) {
        const int d = 8 * C::VW * cj + C::VW * tx + e;
        if (d < D) orow[d] = from_f32<T>(o[i][C::VW * cj + e]);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int S, int H, int D, cudaStream_t stream) {
  using C = Cfg<DP>;
  auto kern = mha_generic_kernel<T, DP>;
  if (C::kSmemBytes > 48 * 1024) {
    // set on every call: the opt-in belongs to the current device
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);  // the plain version's f32 1/sqrt(d)
  kern<<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), S, H, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const float* bias, void* out,
                       int B, int S, int H, int D, cudaStream_t stream) {
  if (D <= 16) return launch<T, 16>(q, k, v, bias, out, B, S, H, D, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, bias, out, B, S, H, D, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, bias, out, B, S, H, D, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, bias, out, B, S, H, D, stream);
  return launch<T, 256>(q, k, v, bias, out, B, S, H, D, stream);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16, 2 = float32. Shapes: q, k, v, out
// (B, S, H*D) contiguous; key_bias (B, S) f32 contiguous; 1 <= D <= 256.
// Returns a cudaError_t (0 = launched).
extern "C" int rrt_mha_generic(int dtype, const void* q, const void* k, const void* v,
                               const void* key_bias, void* out, int B, int S, int H, int D,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxHeadDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(key_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<__nv_bfloat16>(q, k, v, bias, out, B, S, H, D, st);
    case 1: return (int)dispatch_d<__half>(q, k, v, bias, out, B, S, H, D, st);
    case 2: return (int)dispatch_d<float>(q, k, v, bias, out, B, S, H, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
