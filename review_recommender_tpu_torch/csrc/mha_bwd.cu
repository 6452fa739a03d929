// Multi-head attention backward for Hopper (sm_90a): the q, k and v
// gradients of softmax(Q K^T * 1/sqrt(d) + key_bias) V.
//
// Replaces the backward of the TPU kernel's custom_vjp:
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_bwd (:142),
// which re-runs mha_xla under jax.vjp (XLA, not Pallas) and returns the
// gradients of q, k, v (and of the key bias, which the towers build from
// the mask and never differentiate: none here). Its domain is the
// forward's (mha_fwd.cu, mha_generic.cu): f32, bf16 and f16, any head
// width D from 1 to 256, any S >= 1, q, k, v, dout and the gradients
// (B, S, H*D) row-major, read and written in place, key_bias (B, S) f32
// (0 keep, -1e30 drop).
//
// The formula is the plain version's (ops/attention.py:
// mha_backward_reference), which keeps the roundings of autograd through
// mha_reference:
//   P  = exp(s - m) / l in f32 (s = (q . k) * scale + bias, m the row max,
//        l the row sum);
//   dV = round_T(P)^T dO;
//   dP = round_T(dO V^T) (the backward of the probabilities' cast to T);
//   dS = P * (dP - Delta), Delta = sum_k P dP in f32;
//   dQ = dS K * scale, dK = dS^T Q * scale; each gradient rounded to T once.
// Delta is not rowsum(dO * O) from the forward's output, which equals it but
// for rounding: in a row masked but for one key (P = 1) the exact dS is 0,
// sum_k P dP gives 0, and rowsum(dO * O) leaves dP's rounding to T in every
// query row, which a key's dK sums over the queries (0.17 of max |dK| in
// bf16 at S = 1024 on an H100).
//
// Two kernels a call, deterministic (no atomics), in the order A, B on one
// stream; a workspace of 3 * B * H * S floats carries each query row's m,
// 1/l (f32 route: l) and Delta from A to B.
//   A (per (b, h, 64 query rows)): pass 1 over the key tiles computes S
//     and dP and keeps the running row max, the row sum of e = exp(s - m)
//     and the row sum of e * dP, both rescaled by exp(m_old - m_new) when
//     the max moves (Delta = the second over the first); pass 2 computes S,
//     P, dP and dS again per key tile and dQ += dS K. Writes dQ and the row
//     statistics.
//   B (per (b, h, 64 key rows)): walks the query tiles with their stored
//     statistics: S^T = K Q^T, P^T, dV += round_T(P^T) dO, dP^T = V dO^T,
//     dS^T, dK += dS^T Q. Writes dK and dV.
// The two kernels take nine products of the forward's size between them
// (A's pass 1 computes Q K^T and dO V^T for the statistics), 18 * B*H*S*S*D
// operations against the 10 * B*H*S*S*D of the five products the backward
// needs.
//
// What bounds it on an H100 SXM (published peaks at 700 W), at the
// cross-encoder trainer's shape (B=32, S=256, H=12, D=32, bf16): q, k, v,
// dout read and dq, dk, dv written once, 44.0 MB at 3.35 TB/s, 13 us;
// the five products, 8.1 GFLOP at 989 TFLOP/s, 8.1 us; this design's
// exponentials, 3 * B*H*S*S = 75 M at 16 per SM per clock (4.2 T/s), 18
// us. At D = 32 the exponentials and the softmax's elementwise work in
// registers are the floor, not the tensor cores.
//
// Tensor-core route, bf16/f16 at D <= 128 (mha_bwd_dq_kernel,
// mha_bwd_dkv_kernel): one CTA of one warpgroup, 64 rows, tiles of 64 in
// shared memory in wgmma's canonical no-swizzle layout with columns padded
// from D to DP in {16, 32, 64, 128} (zeroed once, never written again), a
// 2-stage ring filled by cp.async in the widest granule the pointers allow,
// as mha_generic.cu's mha_tc_kernel. Every tile serves as a K-major operand
// (S = Q K^T, dP = dO V^T: wgmma m64n64k16, both operands from shared
// memory) and through the transpose bit as an N-major one (dQ += dS K,
// dV += P^T dO, dK += dS^T Q: wgmma m64nDPk16 with the left operand, P or
// dS rounded to T, straight from the S / dP accumulators in registers).
// Logits are in log2 units as in the forward (one FMA with scale*log2(e)
// and bias*log2(e), ex2.approx, a multiply by 1/l): an f32 probability
// moves by an ulp or two. dS is rounded to T for the tensor cores (one
// rounding of a product's operand that the f32 plain version does not
// make); the scale is applied to dQ and dK in f32 at the end.
// Kernel B's row statistics for query rows >= S are m = +inf and 1/l = 0,
// so zero-filled Q and dO rows give P = 0 and add nothing to dK or dV.
//
// FMA route, f32 at any D and bf16/f16 at D 129-256 (mha_bwd_dq_fma_kernel,
// mha_bwd_dkv_fma_kernel): the same two kernels on the CUDA cores in full
// f32 FMA (no TF32), as mha_generic.cu's mha_fma_kernel: 128 threads as 16
// x 8, 64 rows a CTA (32 at D > 128) against tiles of 32, synchronous loads
// converted to f32 in shared memory at DP in {32, 64, 128, 256}; the
// plain version's op order for the logits ((q . k) * scale, then + bias,
// each rounded), expf and IEEE divisions; dS * scale in f32 before its
// products, as autograd applies it.
//
// Semantics, both routes:
//   - an all-masked row (every bias -1e30) has equal logits, P = 1/S over
//     the S real keys (m = -1e30, l = S), and its gradients flow uniformly;
//   - keys from S to the tile edge get logit -inf, P = 0 and zero K and V
//     rows: they add nothing to dQ, and their dK and dV are not stored;
//   - query rows >= S add nothing to dK or dV and are not stored.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given and the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows a CTA and a tile on the tensor-core route: wgmma's M and N
constexpr int kStages = 2;     // tile ring
constexpr float kLog2e = 1.4426950408889634f;
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

// ---- shared memory, asynchronous copies, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) from global to shared memory; src_bytes = 0 writes
// N zero bytes and reads nothing.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
                 "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before the async proxy's reads (wgmma's operands).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: start, leading (K-direction)
// and stride (M/N-direction) byte offsets between core matrices, in 16-byte
// units; layout type 0 in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
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

// Pin register operands of an asynchronous wgmma in program order around
// wgmma.fence and wgmma.wait_group.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- wgmma wrappers, bf16/f16 with f32 accumulators ----

// SS, S = Q K^T and dP = dO V^T (and their transposes): A and B K-major
// from shared memory, m64n64k16.

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_f16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// RS, dQ += dS K, dV += P^T dO and dK += dS^T Q: A from registers, B from
// shared memory N-major through the transpose bit, N = DP.

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// qk: the SS products; pv: the RS products; pack: two f32 into the A
// registers' two 16-bit halves.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void qk(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    wgmma_ss_bf16(d, da, db, acc);
  }
  template <int N>
  static __device__ __forceinline__ void pv(float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_bf16(d, a, db);
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 p = __floats2bfloat162_rn(x, y);  // x in the low half
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void qk(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    wgmma_ss_f16(d, da, db, acc);
  }
  template <int N>
  static __device__ __forceinline__ void pv(float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_f16(d, a, db);
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 p = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

// Rows [r0, r0 + R) of one head (row stride HD elements from `src`, the
// head's row 0) into a K-major tile at `dst`, in G-byte granules; rows >= S
// zero-filled, columns >= D never written. The 128 threads stand as 8 rows
// x 16 granule columns: 8 lanes fill one 128-byte core matrix, and each
// thread keeps its row and column, stepping down the tile by pointer
// increments.
template <typename T, int DP, int R, int G>
__device__ __forceinline__ void load_rows_g(uint32_t dst, const T* src, long long HD, int r0,
                                            int S, int D, int tid) {
  constexpr int E = sizeof(T);
  constexpr int kGran = DP * E / G;                // granules in a padded row
  constexpr int kCols = kGran < 16 ? kGran : 16;   // granule columns a pass covers
  constexpr int kStep = 16 / kCols;                // 8-row groups a pass covers
  constexpr int kPasses = R / 8 / kStep;
  const int real = D * E / G;                      // granules of the D real columns
  const int r8 = tid % 8, col = (tid / 8) % kCols, rg0 = tid / (8 * kCols);
  const char* zero = reinterpret_cast<const char*>(src);  // read by no copy
#pragma unroll 1
  for (int gc = col; gc < real; gc += kCols) {
    int row = r0 + 8 * rg0 + r8;
    const char* from = reinterpret_cast<const char*>(src + (long long)row * HD) + gc * G;
    uint32_t at = dst + rg0 * (8 * DP * E) + (gc * G / 16) * 128 + r8 * 16 + (gc * G) % 16;
#pragma unroll
    for (int n = 0; n < kPasses; ++n) {
      const bool in = row < S;
      if constexpr (G >= 4) {
        cp_async<G>(at, in ? from : zero, in ? G : 0);
      } else {
        const unsigned short x = in ? __ldg(reinterpret_cast<const unsigned short*>(from)) : 0;
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at), "h"(x) : "memory");
      }
      row += 8 * kStep;
      from += 8 * kStep * HD * E;
      at += kStep * (8 * DP * E);
    }
  }
}

template <typename T, int DP, int R>
__device__ __forceinline__ void load_rows(int gran, uint32_t dst, const T* src, long long HD,
                                          int r0, int S, int D, int tid) {
  switch (gran) {
    case 16: load_rows_g<T, DP, R, 16>(dst, src, HD, r0, S, D, tid); break;
    case 8: load_rows_g<T, DP, R, 8>(dst, src, HD, r0, S, D, tid); break;
    case 4: load_rows_g<T, DP, R, 4>(dst, src, HD, r0, S, D, tid); break;
    default:
      if constexpr (sizeof(T) == 2) load_rows_g<T, DP, R, 2>(dst, src, HD, r0, S, D, tid);
      break;
  }
}

// The tile's key bias; -inf for keys >= S.
template <int BK>
__device__ __forceinline__ void load_bias(uint32_t dst, const float* brow, int k0, int S,
                                          int tid) {
  for (int j = tid; j < BK; j += kThreads) {
    const int key = k0 + j;
    if (key < S) {
      cp_async<4>(dst + 4 * j, brow + key, 4);
    } else {
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4 * j), "f"(-INFINITY) : "memory");
    }
  }
}

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

// ---- the tensor-core route: bf16/f16 at D <= 128 ----

// Shared-memory plan at padded head width DP. A tile of 64 rows x DP
// columns is 8 groups of kGroup bytes; row r, 16-byte chunk c at
// (r / 8) * kGroup + c * 128 + (r % 8) * 16. Kernel A: Q | dO | kStages x
// (K, V, the tile's 64 key biases); kernel B: K | V | kStages x (Q, dO, the
// tile's 64 m, 1/l and Delta).
template <typename T, int DP>
struct BwdPlan {
  static constexpr int kGroup = 8 * DP * sizeof(T);
  static constexpr int kTile = kRows * DP * sizeof(T);
  static constexpr int kStage0 = 2 * kTile;
  static constexpr int kStageA = 2 * kTile + kRows * 4;
  static constexpr int kStageB = 2 * kTile + 3 * kRows * 4;
  static constexpr int kBytesA = kStage0 + kStages * kStageA;
  static constexpr int kBytesB = kStage0 + kStages * kStageB;
  static_assert(kTile % 2048 == 0 && kStageA % 128 == 0 && kStageB % 128 == 0, "tile alignment");
};

// A query tile's row statistics into shared memory: m, 1/l and Delta of
// rows [q0, q0 + 64) from the workspace (at `stats`, `bhs` floats apart);
// rows >= S get m = +inf, 1/l = 0 and Delta = 0 (P = 0).
__device__ __forceinline__ void load_stats(uint32_t dst, const float* stats, long long bhs,
                                           int q0, int S, int tid) {
  for (int j = tid; j < 3 * kRows; j += kThreads) {
    const int which = j / kRows, row = q0 + j % kRows;
    if (row < S) {
      cp_async<4>(dst + 4 * j, stats + which * bhs + row, 4);
    } else {
      const float x = which == 0 ? INFINITY : 0.f;
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4 * j), "f"(x) : "memory");
    }
  }
}

// Kernel A: dQ and the row statistics of 64 query rows of one (b, h).
// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// warp w holds rows 16w..16w+15; with g = lane/4 and c = lane%4, element
// 4i+0/4i+1 is (row g, columns 8i+2c, 8i+2c+1) and 4i+2/4i+3 the same
// columns of row g+8.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ key_bias, const T* __restrict__ dout,
                  T* __restrict__ dq, float* __restrict__ ws, int S, int H, int D, int gran,
                  float scale, float dscale) {
  using P = BwdPlan<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;  // (b, row 0, head h)
  const float* brow = key_bias + (long long)b * S;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;  // this head's m; 1/l and Delta bhs apart
  const int ntiles = (S + kRows - 1) / kRows;
  const int nsteps = 2 * ntiles;  // pass 1, pass 2: K and V each

  for (int i = tid; i < P::kBytesA / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kStages) * P::kStageA;
    const int k0 = (u >= ntiles ? u - ntiles : u) * kRows;
    load_rows<T, DP, kRows>(gran, st, k + head, HD, k0, S, D, tid);
    load_rows<T, DP, kRows>(gran, st + P::kTile, v + head, HD, k0, S, D, tid);
    load_bias<kRows>(st + 2 * P::kTile, brow, k0, S, tid);
  };
  load_rows<T, DP, kRows>(gran, base, q + head, HD, qt * kRows, S, D, tid);
  load_rows<T, DP, kRows>(gran, base + P::kTile, dout + head, HD, qt * kRows, S, D, tid);
  load_step(0);
  cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // rows g and g+8: max, sum of e, sum of e * dP (then Delta), 1/l
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  float i0 = 0.f, i1 = 0.f;

  for (int u = 0; u < nsteps; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // step u's tile is in; every thread is done with step u - 1
    if (u + 1 < nsteps) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kStages) * P::kStageA;
    const uint32_t kt = base + st_off, vt = kt + P::kTile;
    const float* bt = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);
    const bool pass2 = u >= ntiles;

    // S = Q K^T and dP = dO V^T, dP rounded to T
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      Mma<T>::qk(s, smem_desc(base + 256 * j, 128, P::kGroup), smem_desc(kt + 256 * j, 128, P::kGroup),
                 j > 0);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      Mma<T>::qk(dp, smem_desc(base + P::kTile + 256 * j, 128, P::kGroup),
                 smem_desc(vt + 256 * j, 128, P::kGroup), j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = to_f32(from_f32<T>(dp[i]));

    // logits in log2 units: (q . k) * scale*log2(e) + bias*log2(e)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
      const float b0 = bb.x * kLog2e, b1 = bb.y * kLog2e;
      s[4 * i + 0] = fmaf(s[4 * i + 0], scale, b0);
      s[4 * i + 1] = fmaf(s[4 * i + 1], scale, b1);
      s[4 * i + 2] = fmaf(s[4 * i + 2], scale, b0);
      s[4 * i + 3] = fmaf(s[4 * i + 3], scale, b1);
    }

    if (!pass2) {
      // running row max, sum of e and sum of e * dP; tile 0 holds key 0
      // (finite bias), so the max is finite and 2^(-inf - mx) = 0 clears
      // the empty sums
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = ex2_approx(m0 - mx0), a1 = ex2_approx(m1 - mx1);
      l0 *= a0;
      dl0 *= a0;
      l1 *= a1;
      dl1 *= a1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ex2_approx(s[4 * i + e] - (e < 2 ? m0 : m1));
          if (e < 2) {
            l0 += x;
            dl0 = fmaf(x, dp[4 * i + e], dl0);
          } else {
            l1 += x;
            dl1 = fmaf(x, dp[4 * i + e], dl1);
          }
        }
      if (u == ntiles - 1) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        i0 = 1.f / l0;
        i1 = 1.f / l1;
        dl0 = quad_sum(dl0) * i0;
        dl1 = quad_sum(dl1) * i1;
      }
      continue;
    }

    // pass 2: P = 2^(s - m) / l, dS = P (dP - Delta) rounded to T as the A
    // registers of dQ += dS K
    uint32_t a[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        const float p = ex2_approx(s[4 * i + e] - (top ? m0 : m1)) * (top ? i0 : i1);
        x[e] = p * (dp[4 * i + e] - (top ? dl0 : dl1));
      }
      a[2 * i] = Mma<T>::pack(x[0], x[1]);
      a[2 * i + 1] = Mma<T>::pack(x[2], x[3]);
    }
    // K as the N-major B operand (transpose bit): LBO steps 8 keys, SBO 8
    // columns; four k-steps of 16 keys
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t aj[4] = {a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]};
      Mma<T>::pv(acc, aj, smem_desc(kt + 2 * j * P::kGroup, P::kGroup, 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // dQ = acc * scale; rows >= S and columns >= D not stored; the row
  // statistics by one thread of each quad
  const int r0 = qt * kRows + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * i + 2 * c + e;
      if (d >= D) continue;
      if (r0 < S) dq[head + r0 * HD + d] = from_f32<T>(acc[4 * i + e] * dscale);
      if (r1 < S) dq[head + r1 * HD + d] = from_f32<T>(acc[4 * i + 2 + e] * dscale);
    }
  if (c == 0) {
    if (r0 < S) {
      stats[r0] = m0;
      stats[bhs + r0] = i0;
      stats[2 * bhs + r0] = dl0;
    }
    if (r1 < S) {
      stats[r1] = m1;
      stats[bhs + r1] = i1;
      stats[2 * bhs + r1] = dl1;
    }
  }
}

// Kernel B: dK and dV of 64 key rows of one (b, h), over the query tiles.
// The accumulators' rows are keys and their columns queries (S^T, dP^T).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ key_bias, const T* __restrict__ dout,
                   T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ ws, int S,
                   int H, int D, int gran, float scale, float dscale) {
  using P = BwdPlan<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* stats = ws + ((long long)b * H + h) * S;
  const int ntiles = (S + kRows - 1) / kRows;

  for (int i = tid; i < P::kBytesB / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kStages) * P::kStageB;
    load_rows<T, DP, kRows>(gran, st, q + head, HD, u * kRows, S, D, tid);
    load_rows<T, DP, kRows>(gran, st + P::kTile, dout + head, HD, u * kRows, S, D, tid);
    load_stats(st + 2 * P::kTile, stats, bhs, u * kRows, S, tid);
  };
  load_rows<T, DP, kRows>(gran, base, k + head, HD, kt * kRows, S, D, tid);
  load_rows<T, DP, kRows>(gran, base + P::kTile, v + head, HD, kt * kRows, S, D, tid);
  load_step(0);
  cp_async_commit();

  // this thread's key rows and their biases in log2 units (-inf past S)
  const int r0 = kt * kRows + warp * 16 + g, r1 = r0 + 8;
  const float kb0 = r0 < S ? key_bias[(long long)b * S + r0] * kLog2e : -INFINITY;
  const float kb1 = r1 < S ? key_bias[(long long)b * S + r1] * kLog2e : -INFINITY;

  float acc_v[DP / 2], acc_k[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_v[i] = acc_k[i] = 0.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (u + 1 < ntiles) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kStages) * P::kStageB;
    const uint32_t qs = base + st_off, os = qs + P::kTile;
    const float* sm = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);

    // S^T = K Q^T and dP^T = V dO^T, K-major operands from shared memory
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      Mma<T>::qk(s, smem_desc(base + 256 * j, 128, P::kGroup), smem_desc(qs + 256 * j, 128, P::kGroup),
                 j > 0);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      Mma<T>::qk(dp, smem_desc(base + P::kTile + 256 * j, 128, P::kGroup),
                 smem_desc(os + 256 * j, 128, P::kGroup), j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T rounded to T (the A registers of dV += P^T dO) and dS^T (of
    // dK += dS^T Q), each query column with its own statistics
    uint32_t ap[16], ad[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * c;
      const float2 mm = *reinterpret_cast<const float2*>(sm + col);
      const float2 il = *reinterpret_cast<const float2*>(sm + kRows + col);
      const float2 dl = *reinterpret_cast<const float2*>(sm + 2 * kRows + col);
      float p[4], x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float logit = fmaf(s[4 * i + e], scale, e < 2 ? kb0 : kb1);
        p[e] = ex2_approx(logit - (odd ? mm.y : mm.x)) * (odd ? il.y : il.x);
        const float dpr = to_f32(from_f32<T>(dp[4 * i + e]));
        x[e] = p[e] * (dpr - (odd ? dl.y : dl.x));
      }
      ap[2 * i] = Mma<T>::pack(p[0], p[1]);
      ap[2 * i + 1] = Mma<T>::pack(p[2], p[3]);
      ad[2 * i] = Mma<T>::pack(x[0], x[1]);
      ad[2 * i + 1] = Mma<T>::pack(x[2], x[3]);
    }
    // dO and Q as N-major B operands (transpose bit): four k-steps of 16
    // queries
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(ap);
    fence_regs(ad);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t aj[4] = {ap[4 * j], ap[4 * j + 1], ap[4 * j + 2], ap[4 * j + 3]};
      Mma<T>::pv(acc_v, aj, smem_desc(os + 2 * j * P::kGroup, P::kGroup, 128));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t aj[4] = {ad[4 * j], ad[4 * j + 1], ad[4 * j + 2], ad[4 * j + 3]};
      Mma<T>::pv(acc_k, aj, smem_desc(qs + 2 * j * P::kGroup, P::kGroup, 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  // dK = acc_k * scale, dV = acc_v; key rows >= S and columns >= D not stored
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * i + 2 * c + e;
      if (d >= D) continue;
      if (r0 < S) {
        dk[head + r0 * HD + d] = from_f32<T>(acc_k[4 * i + e] * dscale);
        dv[head + r0 * HD + d] = from_f32<T>(acc_v[4 * i + e]);
      }
      if (r1 < S) {
        dk[head + r1 * HD + d] = from_f32<T>(acc_k[4 * i + 2 + e] * dscale);
        dv[head + r1 * HD + d] = from_f32<T>(acc_v[4 * i + 2 + e]);
      }
    }
}

// ---- the FMA route: f32 at any D, bf16/f16 at D 129-256 ----

constexpr int kTX = 8;   // threads across a tile's columns and the output columns
constexpr int kTY = 16;  // threads across rows

// Geometry at padded head width DP: RM rows a thread, BR rows a CTA (query
// rows in kernel A, key rows in kernel B), tiles of BC columns (keys in A,
// queries in B), 4 a thread. Shared memory in floats, a transposed tile
// (DP, R + 4) keeping rows 16-byte aligned:
//   A: Q^T, dO^T (DP, RS); K^T, V^T (DP, CS); K (BC, DP); dS^T (BC, RS);
//      the tile's key bias (BC);
//   B: K^T, V^T (DP, RS); Q^T, dO^T (DP, CS); Q, dO (BC, DP); P^T, dS^T
//      (BC, RS); the tile's m, l and Delta (BC each).
template <int DP>
struct FmaPlan {
  static constexpr int RM = DP == 256 ? 2 : 4;
  static constexpr int BR = kTY * RM;
  static constexpr int BC = 4 * kTX;
  static constexpr int RS = BR + 4;
  static constexpr int CS = BC + 4;
  static constexpr int CPT = DP / kTX;  // output columns a thread
  static constexpr int VW = CPT < 4 ? CPT : 4;
  static constexpr int CJ = CPT / VW;
  static constexpr int kA_Ot = DP * RS, kA_Kt = 2 * DP * RS, kA_Vt = kA_Kt + DP * CS;
  static constexpr int kA_K = kA_Vt + DP * CS, kA_Ds = kA_K + BC * DP, kA_B = kA_Ds + BC * RS;
  static constexpr int kBytesA = (kA_B + BC) * 4;
  static constexpr int kB_Vt = DP * RS, kB_Qt = 2 * DP * RS, kB_Ot = kB_Qt + DP * CS;
  static constexpr int kB_Q = kB_Ot + DP * CS, kB_O = kB_Q + BC * DP, kB_P = kB_O + BC * DP;
  static constexpr int kB_Ds = kB_P + BC * RS, kB_St = kB_Ds + BC * RS;
  static constexpr int kBytesB = (kB_St + 3 * BC) * 4;
  static_assert(kBytesA <= 232448 && kBytesB <= 232448, "shared memory of one block");
};

// Rows [r0, r0 + R) of one head into shared memory as f32, zero past S and
// D: transposed (element (r, d) at dst[d * ld + r]) or row-major (at
// dst[r * DP + d]).
template <typename T, int DP, bool kTransposed>
__device__ __forceinline__ void load_f32(float* dst, int ld, const T* src, long long HD, int r0,
                                         int R, int S, int D, int tid) {
  for (int i = tid; i < R * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, row = r0 + r;
    const float x = (row < S && d < D) ? to_f32(src[row * HD + d]) : 0.f;
    if constexpr (kTransposed) dst[d * ld + r] = x;
    else dst[r * DP + d] = x;
  }
}

// out[i][e] = sum over d < D of At[d][ty*RM + i] * Bt[d][4*tx + e]
template <int RM>
__device__ __forceinline__ void dot_tile(float (&out)[RM][4], const float* At, int as,
                                         const float* Bt, int bs, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[i][e] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RM], bb[4];
    lds<RM>(a, At + d * as + ty * RM);
    lds<4>(bb, Bt + d * bs + 4 * tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[i][e] = fmaf(a[i], bb[e], out[i][e]);
  }
}

// acc[i][VW*cj + e] += sum over j < BC of Pt[j][ty*RM + i] * X[j][8*VW*cj + VW*tx + e]
template <int DP>
__device__ __forceinline__ void acc_tile(float (&acc)[FmaPlan<DP>::RM][FmaPlan<DP>::CPT],
                                         const float* Pt, const float* X, int ty, int tx) {
  using C = FmaPlan<DP>;
#pragma unroll 4
  for (int j = 0; j < C::BC; ++j) {
    float p[C::RM];
    lds<C::RM>(p, Pt + j * C::RS + ty * C::RM);
#pragma unroll
    for (int cj = 0; cj < C::CJ; ++cj) {
      float x[C::VW];
      lds<C::VW>(x, X + j * DP + 8 * C::VW * cj + C::VW * tx);
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
#pragma unroll
        for (int e = 0; e < C::VW; ++e)
          acc[i][C::VW * cj + e] = fmaf(p[i], x[e], acc[i][C::VW * cj + e]);
    }
  }
}

// Rows [r0, r0 + BR) of a gradient from acc * mul, rows >= S and columns
// >= D not stored.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[FmaPlan<DP>::RM][FmaPlan<DP>::CPT],
                                           float mul, long long HD, int r0, int S, int D, int ty,
                                           int tx) {
  using C = FmaPlan<DP>;
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int row = r0 + ty * C::RM + i;
    if (row >= S) continue;
#pragma unroll
    for (int cj = 0; cj < C::CJ; ++cj)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) {
        const int d = 8 * C::VW * cj + C::VW * tx + e;
        if (d < D) dst[row * HD + d] = from_f32<T>(acc[i][C::VW * cj + e] * mul);
      }
  }
}

// Kernel A on the CUDA cores: dQ and the row statistics (m, l, Delta) of
// BR query rows of one (b, h).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ key_bias, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ ws, int S, int H, int D,
                      float scale) {
  using C = FmaPlan<DP>;
  constexpr int RM = C::RM, BC = C::BC;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);
  float* sOt = sQt + C::kA_Ot;
  float* sKt = sQt + C::kA_Kt;
  float* sVt = sQt + C::kA_Vt;
  float* sK = sQt + C::kA_K;
  float* sDs = sQt + C::kA_Ds;
  float* sB = sQt + C::kA_B;

  const int r0 = blockIdx.x * C::BR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;
  const int ntiles = (S + BC - 1) / BC;

  load_f32<T, DP, true>(sQt, C::RS, q + head, HD, r0, C::BR, S, D, tid);
  load_f32<T, DP, true>(sOt, C::RS, dout + head, HD, r0, C::BR, S, D, tid);

  auto load_tile = [&](int t, bool pass2) {
    const int k0 = t * BC;
    load_f32<T, DP, true>(sKt, C::CS, k + head, HD, k0, BC, S, D, tid);
    load_f32<T, DP, true>(sVt, C::CS, v + head, HD, k0, BC, S, D, tid);
    if (pass2) load_f32<T, DP, false>(sK, 0, k + head, HD, k0, BC, S, D, tid);
    for (int j = tid; j < BC; j += kThreads)
      sB[j] = k0 + j < S ? key_bias[(long long)b * S + k0 + j] : -INFINITY;
  };
  // the plain version's logits: (q . k) * scale, then + bias, each rounded
  auto logits = [&](float (&s)[RM][4]) {
    dot_tile<RM>(s, sQt, C::RS, sKt, C::CS, D, ty, tx);
    float bb[4];
    lds<4>(bb, sB + 4 * tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = __fadd_rn(__fmul_rn(s[i][e], scale), bb[e]);
  };

  // dP = dO V^T of this tile, rounded to T
  auto grad_logits = [&](float (&dp)[RM][4]) {
    dot_tile<RM>(dp, sOt, C::RS, sVt, C::CS, D, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[i][e] = to_f32(from_f32<T>(dp[i][e]));
  };

  // ---- pass 1: running row max, sum of e = exp(s - m), sum of e * dP ----
  float m[RM], l[RM], dl[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = dl[i] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // the previous tile is read (and, before tile 0, Q and dO are stored)
    load_tile(t, false);
    __syncthreads();
    float s[RM][4], dp[RM][4];
    logits(s);
    grad_logits(dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = m[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, s[i][e]);
      mx = row_max(mx);
      // tile 0 holds key 0 (finite bias): mx is finite, exp(-inf - mx) = 0
      const float a = expf(m[i] - mx);
      l[i] *= a;
      dl[i] *= a;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[i][e] - mx);
        l[i] += x;
        dl[i] = fmaf(x, dp[i][e], dl[i]);
      }
    }
  }
  // the row sums, and Delta = sum_k P dP
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    l[i] = row_sum(l[i]);
    dl[i] = __fdiv_rn(row_sum(dl[i]), l[i]);
  }

  // ---- pass 2: dS = P (dP - Delta) * scale; dQ += dS K ----
  float acc[RM][C::CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile(t, true);
    __syncthreads();
    float s[RM][4], dp[RM][4];
    logits(s);
    grad_logits(dp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = __fdiv_rn(expf(s[i][e] - m[i]), l[i]);
        x[i] = __fmul_rn(p * (dp[i][e] - dl[i]), scale);
      }
      sts<RM>(sDs + (4 * tx + e) * C::RS + ty * RM, x);
    }
    __syncthreads();
    acc_tile<DP>(acc, sDs, sK, ty, tx);
  }

  store_rows<T, DP>(dq + head, acc, 1.f, HD, r0, S, D, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + ty * RM + i;
      if (row < S) {
        stats[row] = m[i];
        stats[bhs + row] = l[i];
        stats[2 * bhs + row] = dl[i];
      }
    }
  }
}

// Kernel B on the CUDA cores: dK and dV of BR key rows of one (b, h), over
// the query tiles with their stored statistics.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ key_bias, const T* __restrict__ dout,
                       T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ ws,
                       int S, int H, int D, float scale) {
  using C = FmaPlan<DP>;
  constexpr int RM = C::RM, BC = C::BC;
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);
  float* sVt = sKt + C::kB_Vt;
  float* sQt = sKt + C::kB_Qt;
  float* sOt = sKt + C::kB_Ot;
  float* sQ = sKt + C::kB_Q;
  float* sO = sKt + C::kB_O;
  float* sP = sKt + C::kB_P;
  float* sDs = sKt + C::kB_Ds;
  float* sSt = sKt + C::kB_St;  // m | l | Delta

  const int r0 = blockIdx.x * C::BR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* stats = ws + ((long long)b * H + h) * S;
  const int ntiles = (S + BC - 1) / BC;

  load_f32<T, DP, true>(sKt, C::RS, k + head, HD, r0, C::BR, S, D, tid);
  load_f32<T, DP, true>(sVt, C::RS, v + head, HD, r0, C::BR, S, D, tid);
  float kb[RM];  // this thread's key rows' biases, -inf past S
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty * RM + i;
    kb[i] = row < S ? key_bias[(long long)b * S + row] : -INFINITY;
  }

  float acc_k[RM][C::CPT], acc_v[RM][C::CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * BC;
    __syncthreads();  // the previous tile is read
    load_f32<T, DP, true>(sQt, C::CS, q + head, HD, q0, BC, S, D, tid);
    load_f32<T, DP, true>(sOt, C::CS, dout + head, HD, q0, BC, S, D, tid);
    load_f32<T, DP, false>(sQ, 0, q + head, HD, q0, BC, S, D, tid);
    load_f32<T, DP, false>(sO, 0, dout + head, HD, q0, BC, S, D, tid);
    for (int j = tid; j < 3 * BC; j += kThreads) {
      const int which = j / BC, row = q0 + j % BC;
      sSt[j] = row < S ? stats[which * bhs + row] : (which == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    float s[RM][4], dp[RM][4];
    dot_tile<RM>(s, sKt, C::RS, sQt, C::CS, D, ty, tx);
    dot_tile<RM>(dp, sVt, C::RS, sOt, C::CS, D, ty, tx);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * tx + e;
      const bool in = q0 + col < S;  // query rows >= S: P = 0
      const float mm = sSt[col], ll = sSt[BC + col], dd = sSt[2 * BC + col];
      float pr[RM], x[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float logit = __fadd_rn(__fmul_rn(s[i][e], scale), kb[i]);
        const float p = in ? __fdiv_rn(expf(logit - mm), ll) : 0.f;
        const float dpr = to_f32(from_f32<T>(dp[i][e]));
        pr[i] = to_f32(from_f32<T>(p));
        x[i] = __fmul_rn(p * (dpr - dd), scale);
      }
      sts<RM>(sP + col * C::RS + ty * RM, pr);
      sts<RM>(sDs + col * C::RS + ty * RM, x);
    }
    __syncthreads();
    acc_tile<DP>(acc_v, sP, sO, ty, tx);
    acc_tile<DP>(acc_k, sDs, sQ, ty, tx);
  }

  store_rows<T, DP>(dk + head, acc_k, 1.f, HD, r0, S, D, ty, tx);
  store_rows<T, DP>(dv + head, acc_v, 1.f, HD, r0, S, D, ty, tx);
}

// ---- launches ----

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  // set on every call: the opt-in belongs to the current device
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float* bias;
  void *dq, *dk, *dv;
  float* ws;
  int B, S, H, D;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch_tc(const Args& a) {
  using P = BwdPlan<T, DP>;
  auto ka = mha_bwd_dq_kernel<T, DP>;
  auto kb = mha_bwd_dkv_kernel<T, DP>;
  cudaError_t err = allow_smem(ka, P::kBytesA);
  if (err == cudaSuccess) err = allow_smem(kb, P::kBytesB);
  if (err != cudaSuccess) return err;
  // the widest copy granule every row of q, k, v and dout starts on
  const uintptr_t w = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout |
                      (uintptr_t)(a.D * sizeof(T)) | 16u;
  const int gran = (int)(w & (~w + 1));
  const dim3 grid((a.S + kRows - 1) / kRows, a.H, a.B);
  const float scale = kLog2e / sqrtf((float)a.D), dscale = 1.0f / sqrtf((float)a.D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  ka<<<grid, kThreads, P::kBytesA, a.stream>>>(q, k, v, a.bias, dout, static_cast<T*>(a.dq), a.ws,
                                                a.S, a.H, a.D, gran, scale, dscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<grid, kThreads, P::kBytesB, a.stream>>>(q, k, v, a.bias, dout, static_cast<T*>(a.dk),
                                                static_cast<T*>(a.dv), a.ws, a.S, a.H, a.D, gran,
                                                scale, dscale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fma(const Args& a) {
  using C = FmaPlan<DP>;
  auto ka = mha_bwd_dq_fma_kernel<T, DP>;
  auto kb = mha_bwd_dkv_fma_kernel<T, DP>;
  cudaError_t err = allow_smem(ka, C::kBytesA);
  if (err == cudaSuccess) err = allow_smem(kb, C::kBytesB);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::BR - 1) / C::BR, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)a.D);  // the plain version's f32 1/sqrt(d)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  ka<<<grid, kThreads, C::kBytesA, a.stream>>>(q, k, v, a.bias, dout, static_cast<T*>(a.dq), a.ws,
                                                a.S, a.H, a.D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<grid, kThreads, C::kBytesB, a.stream>>>(q, k, v, a.bias, dout, static_cast<T*>(a.dk),
                                                static_cast<T*>(a.dv), a.ws, a.S, a.H, a.D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a) {
  if constexpr (!std::is_same<T, float>::value) {
    if (a.D <= 16) return launch_tc<T, 16>(a);
    if (a.D <= 32) return launch_tc<T, 32>(a);
    if (a.D <= 64) return launch_tc<T, 64>(a);
    if (a.D <= 128) return launch_tc<T, 128>(a);
    return launch_fma<T, 256>(a);
  } else {
    if (a.D <= 32) return launch_fma<T, 32>(a);
    if (a.D <= 64) return launch_fma<T, 64>(a);
    if (a.D <= 128) return launch_fma<T, 128>(a);
    return launch_fma<T, 256>(a);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16, 2 = float32. q, k, v, dout (the
// gradient of the forward's output), dq, dk, dv: (B, S, H*D) contiguous; key_bias (B, S) f32 contiguous; ws: 3 * B * H * S floats of
// scratch. 1 <= D <= 256. Route: bf16/f16 at D <= 128 on the tensor cores,
// everything else on the CUDA cores (ops/attention.py:backward_route).
// Returns a cudaError_t (0 = launched).
extern "C" int rrt_mha_bwd(int dtype, const void* q, const void* k, const void* v,
                           const void* key_bias, const void* dout, void* dq, void* dk, void* dv,
                           void* ws, int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxHeadDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(key_bias), dq, dk, dv,
               static_cast<float*>(ws), B, S, H, D, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_d<__nv_bfloat16>(a);
    case 1: return (int)dispatch_d<__half>(a);
    case 2: return (int)dispatch_d<float>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
