// Multi-head attention backward for Hopper (sm_90a): the q, k and v
// gradients of softmax(Q K^T * 1/sqrt(d) + key_bias) V.
//
// Replaces the backward of the TPU kernel's custom_vjp:
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_bwd (:142),
// which re-runs mha_xla under jax.vjp (XLA, not Pallas) and returns the
// gradients of q, k, v (and of the key bias, which the towers build from
// the mask and never differentiate: none here). Its domain is the
// forward's (mha_fwd.cu, mha_generic.cu): f32, bf16 and f16, any head
// width D from 1 to 256 (wider heads are csrc/mha_wide_bwd.cu's), any S >=
// 1, q, k, v, dout and the gradients
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
// 1/l and Delta from A to B.
//   A (per (b, h, 64 query rows)): pass 1 over the key tiles computes S
//     and dP and keeps the running row max, the row sum of e = 2^(s - m)
//     and the row sum of e * dP, both rescaled by 2^(m_old - m_new) when
//     the max moves (Delta = the second over the first); pass 2 computes S,
//     P, dP and dS again per key tile and dQ += dS K. Writes dQ and the row
//     statistics.
//   B (per (b, h, 64 key rows)): walks the query tiles with their stored
//     statistics: S^T = K Q^T, P^T, dV += round_T(P^T) dO, dP^T = V dO^T,
//     dS^T, dK += dS^T Q. Writes dK and dV.
// Kernel B is a programmatic dependent launch (launch_after): its CTAs
// start as kernel A's last ones finish, load (f32: and split) their K and
// V rows, and wait (griddepcontrol.wait) only before they read kernel A's
// statistics.
//
// What bounds it on an H100 SXM (published peaks at 700 W), at the
// cross-encoder trainer's shape (B=32, S=256, H=12, D=32, bf16): q, k, v,
// dout read and dq, dk, dv written once, 44.0 MB at 3.35 TB/s, 13 us;
// the five products the backward needs, 8.1 GFLOP at 989 TFLOP/s, 8.1 us
// (the two kernels take nine); this design's exponentials, 3 * B*H*S*S =
// 75 M at 16 per SM per clock (4.2 T/s), 18 us. At D = 32 no unit is near
// its peak: each CTA walks 2-16 tiles one after another and 3-4 CTAs an SM
// hide each other's latencies (examples/torch_attention_backward.py's
// breakdown: taking out the products, the exponentials or the next tile's
// copies each saves 5-20%, and the f32 kernels' clock64 phases put 40-50%
// of a step in the copies and the hi/lo split, 13-21% in issuing the
// products). So the design keeps each kernel at the registers that fit
// 3-4 CTAs an SM (kMinBlocksA / B, kMinBlocksTf32A / B), overlaps softmax
// work with products only where that costs no registers, and starts kernel
// B during kernel A's tail.
//
// Tensor-core route, bf16/f16 at every D (mha_bwd_dq_kernel,
// mha_bwd_dkv_kernel): one CTA of one warpgroup, 64 rows, tiles of 64 in
// shared memory in wgmma's canonical no-swizzle layout with columns padded
// from D to DP in {16, 32, 64, 128, 192, 256} (zeroed once where D < DP), a
// 2-stage ring filled by cp.async in the widest granule the pointers allow,
// as mha_generic.cu's mha_tc_kernel. Every tile serves as a K-major operand
// (S = Q K^T, dP = dO V^T: wgmma m64nNk16, both operands from shared
// memory) and through the transpose bit as an N-major one (dQ += dS K,
// dV += P^T dO, dK += dS^T Q: wgmma m64nNk16 over the gradient's columns,
// at most 128 a product, with the left operand, P or dS rounded to T,
// straight from the S / dP accumulators in registers). Above DP = 128 the
// accumulators set the plan (BwdPlan): kernel A's dQ takes DP/2 registers
// a thread (96 or 128), so its key tiles are 32 rows (S, dP and their
// logits 16 each); kernel B's dK and dV would take DP together, so each
// CTA of a 64-row block takes NC of their columns, 96 at DP = 192 and 64 at
// DP = 256 (two or four CTAs a block, each computing S^T and dP^T over the
// whole D again: 6 or 10 products' work where one CTA would do 4, against
// no atomics and no register spills). Each kernel's streamed tiles come
// from L2 (a head's K and V, or Q and dO, are read by every block of its
// rows), so above DP = 128 two warpgroups a CTA, each with 64 rows of its
// own, share one ring, and each tile is read once for 128 rows (kernel B
// keeps one warpgroup at DP = 256, where two would need 257.5 KB): at (64,
// 512, 2, 192) kernels A and B take 330 and 484 us, 232 and 350 without
// the next tile's copies, 456 and 653 with one warpgroup a CTA
// (examples/torch_attention_backward.py --breakdown, H100). Shared memory:
// kernel A 147,712 / 196,864 bytes at DP = 192 / 256, kernel B 198,144.
// The products of a tile are issued so that softmax work runs while the
// tensor cores do: kernel A commits S apart from dP and works on S (the
// row max, the exponentials) while dP is in flight; kernel B issues each
// query tile as two halves of 32 queries, a commit group each, the second
// half's S^T and dP^T in flight during the first half's work, and each
// half's dV and dK products in flight during the next half's work.
// Logits are in log2 units as in the forward (one FMA with scale*log2(e)
// and bias*log2(e), ex2.approx, a multiply by 1/l): an f32 probability
// moves by an ulp or two. dS is rounded to T for the tensor cores (one
// rounding of a product's operand that the f32 plain version does not
// make); the scale is applied to dQ and dK in f32 at the end. Kernel B's
// row statistics for query rows >= S are m = +inf and 1/l = 0, so
// zero-filled Q and dO rows give P = 0 and add nothing to dK or dV.
//
// 3xTF32 route, f32 at D <= 128 (mha_bwd_dq_tf32_kernel,
// mha_bwd_dkv_tf32_kernel): the two kernels on wgmma, kernel A in one
// pass over the keys (dQ by linearity, at the kernel), with each f32
// product taken as three TF32 ones, as mha_generic.cu's f32 route: every
// operand x split as hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest with ties away from zero (lo by cvt.rna; hi by adding half the
// dropped bits' weight and clearing them, which is cvt.rna's result for
// every x but a NaN, whose lo is then a NaN), a product as lo*hi + hi*lo
// (in accumulators of their own) + hi*hi, the lo*lo term (2^-22 of the
// product) dropped. TF32 wgmma reads both operands K-major (there is no
// transpose bit), so the N-major operands of the gradient products (K in
// kernel A, Q and dO in kernel B) are staged transposed: the split of a
// landed row tile writes its hi and lo a second time, transposed, in the
// key order the S accumulators hand their columns to the A registers of a
// tf32 product (split_rows, tf32_frags). Streamed tiles of 32 keys
// (kernel A) or 16 queries (kernel B, whose four dK / dV accumulators leave
// fewer registers; 32 at DP = 16), dK and dV columns in chunks of 64 a CTA
// above DP = 64 (the accumulators' registers), hi in place and one work
// area for the lo halves and the transposed tiles, so that each kernel
// keeps 3 CTAs an SM at DP = 32. Logits in log2 units with ex2.approx and a
// multiply by 1/l, as the 16-bit route (an f32 probability moves by an ulp
// or two; the gradients stay within 1e-4 of max(1, max |ref|) of the plain
// version, 2.6e-6 in the example's checks); dP and P are not rounded (f32
// is the input type); the scale is applied to dQ and dK at the end.
//
// 3xTF32 route, f32 at D 129-256 (mha_bwd_dq_tf32_wide_kernel,
// mha_bwd_dkv_tf32_wide_kernel; Tf32WidePlan): the D <= 128 plan keeps four
// resident 64-row tiles (Q, Q lo, dO, dO lo), 192 / 256 KB at DP = 192 /
// 256, and its 64 gradient columns a CTA would compute S and dP three or
// four times over for one block of rows. Here one CTA of two warpgroups
// takes a 64-row block and all DP columns. Its 64-row tiles stay raw f32,
// the A operands of S and dP (S^T and dP^T in kernel B): each k-step's A
// elements are loaded from the raw tile and split in registers with the
// rounding above (tf32_wgmma.cuh:tf32_rs3_split, two k-steps a commit
// group, each group waited on before its registers are reused); the
// streamed tiles (16 rows, 8 at DP = 256) keep hi in place, lo and the
// transposed copies in the work area. Warpgroup 0 computes S (S^T) while
// warpgroup 1 computes dP (dP^T); the probabilities cross to warpgroup 1
// through shared memory; in kernel A warpgroup 0 accumulates Y = sum e K
// and warpgroup 1 X = sum e dP K (Y crosses at the end), in kernel B
// warpgroup 0 dV and warpgroup 1 dK, each over all DP columns in one
// accumulator with the three terms in it (two would not fit beside the
// tile's products: DP/2 registers a thread each). Shared memory: kernel A
// 203,904 / 201,792 bytes, kernel B 225,664 / 215,232. At (64, 512, 2,
// 192) the two kernels take 2.905-2.907 ms against the CUDA-core kernels
// they replaced at 18.27-18.40, the recompute at 4.60-4.69 and SDPA's
// backward alone at 2.48-2.55 (examples/torch_attention_ab.py --kernel
// wide_heads, H100); the S and dP products take 1.09 ms of kernel A's and
// B's 2.86 and the split of the streamed tiles 0.55
// (examples/torch_attention_backward.py --breakdown). At (64, 512, 1, 256)
// the 8-row tiles leave the pair at 2.63, slower than the recompute's
// 2.43-2.52.
//
// Semantics, every route:
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

#include "tf32_wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows a CTA and a tile on the tensor-core route: wgmma's M and N
constexpr int kStages = 2;     // tile ring of the 16-bit route
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
// wait until at most N of the warpgroup's committed product groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// SS at N = 32: one half of a 64-row tile.

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_f16(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

// ---- wgmma wrappers, tf32 with f32 accumulators (k8; both operands
// K-major: tf32 has no transpose bit) ----

// SS, S = Q K^T, dP = dO V^T and their transposes, N = the streamed tile's rows.

// RS, dQ += dS K, dV += P^T dO, dK += dS^T Q: A from registers, B the
// transposed tile (K^T, dO^T, Q^T) K-major, N = the gradient columns.

// qk: the SS products; pv: the RS products; pack: two f32 into the A
// registers' two 16-bit halves.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  template <int N>
  static __device__ __forceinline__ void qk(float (&d)[N], uint64_t da, uint64_t db, int acc) {
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
  template <int N>
  static __device__ __forceinline__ void qk(float (&d)[N], uint64_t da, uint64_t db, int acc) {
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

// d += A B at N = 2M columns, as products of at most 128 columns: the
// accumulator elements of columns [2j, 2j + 2P) are d[j, j + P), and B's
// 8-column groups of an N-major tile are 128 bytes apart (P/4 of them in P
// elements), so the rest's descriptor starts 32P bytes further.
template <typename T, int M>
__device__ __forceinline__ void pv_wide(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
  constexpr int P = M >= 64 ? 64 : M >= 32 ? 32 : M >= 16 ? 16 : 8;
  if constexpr (P == M) {
    Mma<T>::pv(d, a, db);
  } else {
    Mma<T>::pv(*reinterpret_cast<float(*)[P]>(&d[0]), a, db);
    pv_wide<T, M - P>(*reinterpret_cast<float(*)[M - P]>(&d[P]), a, db + ((32 * P) >> 4));
  }
}

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

// ---- the tensor-core route: bf16/f16 at every D ----

// Each kernel's resident CTAs an SM by head width, chosen from the
// breakdown (examples/torch_attention_backward.py): a register cap where it
// pays (ptxas given no minimum raises kernel B to 178 registers at DP = 32,
// 2 CTAs an SM, while at DP = 64 its 187 registers ran faster than a cap).
template <int DP>
constexpr int kMinBlocksA = DP <= 64 ? 4 : 1;
template <int DP>
constexpr int kMinBlocksB = DP <= 32 ? 4 : 1;

// Shared-memory plan at padded head width DP. A tile of R rows x DP
// columns is R/8 groups of kGroup bytes; row r, 16-byte chunk c at
// (r / 8) * kGroup + c * 128 + (r % 8) * 16; rows 32..63 of a 64-row tile
// (the second half) start 4 groups in. Kernel A: Q | dO | kStages x (K, V,
// the tile's BKA key biases), key tiles of BKA rows (32 above DP = 128, for
// the dQ accumulator's registers); kernel B: K | V | kStages x (Q, dO, the
// tile's 64 m, 1/l and Delta), NC gradient columns a CTA (96 at DP = 192, 64
// at DP = 256, for the dK and dV accumulators' registers: NCH CTAs a block
// of rows; 128 columns at DP = 256 spilled). Above DP = 128, WGA / WGB
// warpgroups a CTA (each with its own 64 rows and resident tiles, Q | dO or
// K | V, one after the other) share one ring, which halves the bytes each
// row streams from L2; kernel B keeps one at DP = 256, where two would
// need 257.5 KB.
template <typename T, int DP>
struct BwdPlan {
  static constexpr int BKA = DP > 128 ? 32 : 64;
  static constexpr int NC = DP > 192 ? 64 : DP > 128 ? DP / 2 : DP;
  static constexpr int NCH = DP / NC;
  static constexpr int kGroup = 8 * DP * sizeof(T);
  static constexpr int kHalf = 4 * kGroup;  // rows 32..63 of a tile
  static constexpr int kTile = kRows * DP * sizeof(T);
  static constexpr int kKeyTile = BKA * DP * sizeof(T);  // kernel A's K or V tile
  static constexpr int kStageA = 2 * kKeyTile + BKA * 4;
  static constexpr int kStageB = 2 * kTile + 3 * kRows * 4;
  static constexpr int WGA = DP > 128 ? 2 : 1;
  static constexpr int WGB = DP > 128 && 4 * kTile + kStages * kStageB <= 232448 ? 2 : 1;
  static constexpr int kStage0A = WGA * 2 * kTile;
  static constexpr int kStage0B = WGB * 2 * kTile;
  static constexpr int kBytesA = kStage0A + kStages * kStageA;
  static constexpr int kBytesB = kStage0B + kStages * kStageB;
  static_assert(kTile % 2048 == 0 && kStageA % 128 == 0 && kStageB % 128 == 0, "tile alignment");
  static_assert(kBytesA <= 232448 && kBytesB <= 232448, "shared memory of one block");
};

// A tile's row statistics into shared memory: m, 1/l and Delta of rows
// [q0, q0 + R) from the workspace (at `stats`, `bhs` floats apart); rows >=
// S get m = +inf, 1/l = 0 and Delta = 0, so that P = 0. NT threads copy.
template <int R, int NT>
__device__ __forceinline__ void load_stats(uint32_t dst, const float* stats, long long bhs,
                                           int q0, int S, int tid) {
  for (int j = tid; j < 3 * R; j += NT) {
    const int which = j / R, row = q0 + j % R;
    if (row < S) {
      cp_async<4>(dst + 4 * j, stats + which * bhs + row, 4);
    } else {
      const float x = which == 0 ? INFINITY : 0.f;
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4 * j), "f"(x) : "memory");
    }
  }
}

// Kernel B launches while kernel A finishes (programmatic dependent launch,
// launch_after): kernel A lets it in at its start, and kernel B waits here,
// before its first read of the row statistics, for kernel A's grid to
// complete and its writes to be visible. Launched in the ordinary way,
// both are no-ops.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Kernel A: dQ and the row statistics of 64 query rows of one (b, h).
// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// warp w holds rows 16w..16w+15; with g = lane/4 and c = lane%4, element
// 4i+0/4i+1 is (row g, columns 8i+2c, 8i+2c+1) and 4i+2/4i+3 the same
// columns of row g+8.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads * BwdPlan<T, DP>::WGA, kMinBlocksA<DP>)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ key_bias, const T* __restrict__ dout,
                  T* __restrict__ dq, float* __restrict__ ws, int S, int H, int D, int gran,
                  float scale, float dscale) {
  using P = BwdPlan<T, DP>;
  constexpr int BK = P::BKA, WG = P::WGA;  // keys a tile, warpgroups
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  allow_dependent_launch();

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // the warpgroup and its thread (compile-time 0 and tid with one warpgroup)
  const int tid = threadIdx.x, wg = WG > 1 ? tid / kThreads : 0;
  const int wtid = WG > 1 ? tid % kThreads : tid, warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;  // (b, row 0, head h)
  const float* brow = key_bias + (long long)b * S;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;  // this head's m; 1/l and Delta bhs apart
  const int ntiles = (S + BK - 1) / BK;
  const int nsteps = 2 * ntiles;  // pass 1, pass 2: K and V each

  if (D < DP) {  // the pad columns, zeroed once (copies fill the rest)
    for (int i = tid; i < P::kBytesA / 16; i += kThreads * WG)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // each warpgroup copies RW of a key tile's rows, and its own query rows
  constexpr int RW = BK / WG;
  const uint32_t rows_at = wg * (RW / 8) * P::kGroup;
  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0A + (u % kStages) * P::kStageA;
    const int k0 = (u >= ntiles ? u - ntiles : u) * BK;
    load_rows<T, DP, RW>(gran, st + rows_at, k + head, HD, k0 + wg * RW, S, D, wtid);
    load_rows<T, DP, RW>(gran, st + P::kKeyTile + rows_at, v + head, HD, k0 + wg * RW, S, D,
                         wtid);
    load_bias<BK>(st + 2 * P::kKeyTile, brow, k0, S, tid);
  };
  const int q0 = (qt * WG + wg) * kRows;  // this warpgroup's query rows
  const uint32_t own = base + wg * 2 * P::kTile;
  load_rows<T, DP, kRows>(gran, own, q + head, HD, q0, S, D, wtid);
  load_rows<T, DP, kRows>(gran, own + P::kTile, dout + head, HD, q0, S, D, wtid);
  load_step(0);
  cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // rows g and g+8: max, sum of e, sum of e * dP (then Delta), 1/l
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  float i0 = 0.f, i1 = 0.f;
  // wgmma descriptors of Q and dO; a descriptor's address field is the
  // byte address / 16, so an offset of n bytes adds n / 16
  const uint64_t dq_ = smem_desc(own, 128, P::kGroup);
  const uint64_t do_ = smem_desc(own + P::kTile, 128, P::kGroup);

  // Step u: its tile in, the next one's copies issued; S = Q K^T, then
  // dP = dO V^T, a commit group each, so that the work on S runs while dP
  // is in flight. Returns the stage's offset.
  auto begin_step = [&](int u, float (&s)[BK / 2], float (&dp)[BK / 2]) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // step u's tile is in; every thread is done with step u - 1
    if (u + 1 < nsteps) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0A + (u % kStages) * P::kStageA;
    const uint64_t dk = smem_desc(base + st_off, 128, P::kGroup);
    const uint64_t dv = smem_desc(base + st_off + P::kKeyTile, 128, P::kGroup);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) Mma<T>::qk(s, dq_ + 16 * j, dk + 16 * j, j > 0);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) Mma<T>::qk(dp, do_ + 16 * j, dv + 16 * j, j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S; dP stays in flight
    fence_regs(s);
    return st_off;
  };
  // logits in log2 units, (q . k) * scale*log2(e) + bias*log2(e), in
  // registers of their own (a product's accumulators are written by
  // nothing else)
  auto logits = [&](const float (&s)[BK / 2], const float* bt, float (&x)[BK / 2]) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
      const float b0 = bb.x * kLog2e, b1 = bb.y * kLog2e;
      x[4 * i + 0] = fmaf(s[4 * i + 0], scale, b0);
      x[4 * i + 1] = fmaf(s[4 * i + 1], scale, b1);
      x[4 * i + 2] = fmaf(s[4 * i + 2], scale, b0);
      x[4 * i + 3] = fmaf(s[4 * i + 3], scale, b1);
    }
  };

  // pass 1: the running row max, sum of e and sum of e * dP; tile 0 holds
  // key 0 (finite bias), so the max is finite and 2^(-inf - mx) = 0 clears
  // the empty sums
  for (int u = 0; u < ntiles; ++u) {
    float s[BK / 2], dp[BK / 2], x[BK / 2];
    const int st_off = begin_step(u, s, dp);
    logits(s, reinterpret_cast<const float*>(smem + st_off + 2 * P::kKeyTile), x);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(x[4 * i + 0], x[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(x[4 * i + 2], x[4 * i + 3]));
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
    for (int i = 0; i < BK / 2; ++i) {
      x[i] = ex2_approx(x[i] - ((i & 2) ? m1 : m0));  // e
      if (i & 2) l1 += x[i];
      else l0 += x[i];
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {  // dP rounded to T
      const float y = to_f32(from_f32<T>(dp[i]));
      if (i & 2) dl1 = fmaf(x[i], y, dl1);
      else dl0 = fmaf(x[i], y, dl0);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  i0 = 1.f / l0;
  i1 = 1.f / l1;
  dl0 = quad_sum(dl0) * i0;
  dl1 = quad_sum(dl1) * i1;

  // pass 2: P = 2^(s - m) / l, dS = P (dP - Delta) rounded to T as the A
  // registers of dQ += dS K
  for (int u = ntiles; u < nsteps; ++u) {
    float s[BK / 2], dp[BK / 2], x[BK / 2];
    const int st_off = begin_step(u, s, dp);
    logits(s, reinterpret_cast<const float*>(smem + st_off + 2 * P::kKeyTile), x);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      x[i] = ex2_approx(x[i] - ((i & 2) ? m1 : m0)) * ((i & 2) ? i1 : i0);  // P
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t a[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        z[e] = x[4 * i + e] * (to_f32(from_f32<T>(dp[4 * i + e])) - (e < 2 ? dl0 : dl1));
      a[2 * i] = Mma<T>::pack(z[0], z[1]);
      a[2 * i + 1] = Mma<T>::pack(z[2], z[3]);
    }
    // K as the N-major B operand (transpose bit): LBO steps 8 keys, SBO 8
    // columns; k-steps of 16 keys
    const uint64_t dkt = smem_desc(base + st_off, P::kGroup, 128);
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t aj[4] = {a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]};
      pv_wide<T>(acc, aj, dkt + ((2 * j * P::kGroup) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // dQ = acc * scale; rows >= S and columns >= D not stored; the row
  // statistics by one thread of each quad
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
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

// Kernel B: dK and dV of 64 key rows of one (b, h), columns [c0, c0 + NC),
// over the query tiles, each in two halves of 32 queries. The accumulators'
// rows are keys and their columns queries (S^T, dP^T, over all DP columns
// in every CTA of a 64-row block).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads * BwdPlan<T, DP>::WGB, kMinBlocksB<DP>)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ key_bias, const T* __restrict__ dout,
                   T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ ws, int S,
                   int H, int D, int gran, float scale, float dscale) {
  using P = BwdPlan<T, DP>;
  constexpr int NC = P::NC, WG = P::WGB;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int kt = blockIdx.x / P::NCH, c0 = (blockIdx.x % P::NCH) * NC;
  const int h = blockIdx.y, b = blockIdx.z;
  // the warpgroup and its thread (compile-time 0 and tid with one warpgroup)
  const int tid = threadIdx.x, wg = WG > 1 ? tid / kThreads : 0;
  const int wtid = WG > 1 ? tid % kThreads : tid, warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* stats = ws + ((long long)b * H + h) * S;
  const int ntiles = (S + kRows - 1) / kRows;

  if (D < DP) {  // the pad columns, zeroed once (copies fill the rest)
    for (int i = tid; i < P::kBytesB / 16; i += kThreads * WG)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // each warpgroup copies RW of a query tile's rows, and its own key rows
  constexpr int RW = kRows / WG;
  const uint32_t rows_at = wg * (RW / 8) * P::kGroup;
  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0B + (u % kStages) * P::kStageB;
    const int r = u * kRows + wg * RW;
    load_rows<T, DP, RW>(gran, st + rows_at, q + head, HD, r, S, D, wtid);
    load_rows<T, DP, RW>(gran, st + P::kTile + rows_at, dout + head, HD, r, S, D, wtid);
    load_stats<kRows, kThreads * WG>(st + 2 * P::kTile, stats, bhs, u * kRows, S, tid);
  };
  // this thread's key rows and their biases in log2 units (-inf past S)
  const int k0 = (kt * WG + wg) * kRows;  // this warpgroup's key rows
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const float kb0 = r0 < S ? key_bias[(long long)b * S + r0] * kLog2e : -INFINITY;
  const float kb1 = r1 < S ? key_bias[(long long)b * S + r1] * kLog2e : -INFINITY;
  const uint32_t own = base + wg * 2 * P::kTile;
  load_rows<T, DP, kRows>(gran, own, k + head, HD, k0, S, D, wtid);
  load_rows<T, DP, kRows>(gran, own + P::kTile, v + head, HD, k0, S, D, wtid);
  wait_for_prior_grid();  // kernel A's row statistics
  load_step(0);
  cp_async_commit();

  float acc_v[NC / 2], acc_k[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
  // wgmma descriptors of K and V (an offset of n bytes adds n / 16)
  const uint64_t dk_ = smem_desc(own, 128, P::kGroup);
  const uint64_t dv_ = smem_desc(own + P::kTile, 128, P::kGroup);

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile u is in; every thread is done with tile u - 1
    if (u + 1 < ntiles) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0B + (u % kStages) * P::kStageB;
    const uint32_t qs = base + st_off, os = qs + P::kTile;
    const float* sm = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);

    // S^T = K Q^T and dP^T = V dO^T by halves of 32 queries, a commit group
    // each: the second half's products run during the first half's work
    float s[2][16], dp[2][16];
    const uint64_t dqs = smem_desc(qs, 128, P::kGroup), dos = smem_desc(os, 128, P::kGroup);
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        Mma<T>::qk(s[hf], dk_ + 16 * j, dqs + (hf * P::kHalf >> 4) + 16 * j, j > 0);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        Mma<T>::qk(dp[hf], dv_ + 16 * j, dos + (hf * P::kHalf >> 4) + 16 * j, j > 0);
      wgmma_commit();
    }
    // dO and Q as N-major B operands (transpose bit) from column c0 (8
    // columns a 128-byte step: c0 * 16 bytes, c0 in the descriptor)
    const uint64_t dot = smem_desc(os, P::kGroup, 128) + c0;
    const uint64_t dqt = smem_desc(qs, P::kGroup, 128) + c0;

    uint32_t ap[2][8], ad[2][8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // in flight after this: the next half's products (hf = 0) or the
      // previous half's dV and dK products (hf = 1)
      wgmma_wait<1>();
      fence_regs(s[hf]);
      fence_regs(dp[hf]);
      // P^T rounded to T (the A registers of dV += P^T dO), each query
      // column with its own statistics; then dS^T, dP^T rounded to T (of
      // dK += dS^T Q)
      float p[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * hf + 8 * i + 2 * c;
        const float2 mm = *reinterpret_cast<const float2*>(sm + col);
        const float2 il = *reinterpret_cast<const float2*>(sm + kRows + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float logit = fmaf(s[hf][4 * i + e], scale, e < 2 ? kb0 : kb1);
          p[4 * i + e] = ex2_approx(logit - (odd ? mm.y : mm.x)) * (odd ? il.y : il.x);
        }
        ap[hf][2 * i] = Mma<T>::pack(p[4 * i + 0], p[4 * i + 1]);
        ap[hf][2 * i + 1] = Mma<T>::pack(p[4 * i + 2], p[4 * i + 3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 dl = *reinterpret_cast<const float2*>(sm + 2 * kRows + 32 * hf + 8 * i + 2 * c);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = p[4 * i + e] * (to_f32(from_f32<T>(dp[hf][4 * i + e])) - ((e & 1) ? dl.y : dl.x));
        ad[hf][2 * i] = Mma<T>::pack(x[0], x[1]);
        ad[hf][2 * i + 1] = Mma<T>::pack(x[2], x[3]);
      }
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(ap[hf]);
      fence_regs(ad[hf]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // the half's two k-steps of 16 queries
        const uint32_t aj[4] = {ap[hf][4 * j], ap[hf][4 * j + 1], ap[hf][4 * j + 2], ap[hf][4 * j + 3]};
        pv_wide<T>(acc_v, aj, dot + ((2 * (2 * hf + j) * P::kGroup) >> 4));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t aj[4] = {ad[hf][4 * j], ad[hf][4 * j + 1], ad[hf][4 * j + 2], ad[hf][4 * j + 3]};
        pv_wide<T>(acc_k, aj, dqt + ((2 * (2 * hf + j) * P::kGroup) >> 4));
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  // dK = acc_k * scale, dV = acc_v; key rows >= S and columns >= D not stored
#pragma unroll
  for (int i = 0; i < NC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + 8 * i + 2 * c + e;
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

// ---- the 3xTF32 route: f32 at D <= 128 ----

constexpr int kRingTf32 = 2;  // streamed-tile ring

// Streamed tiles' rows: keys in kernel A, queries in kernel B, whose four
// dK / dV accumulators leave fewer registers (16 rows; 32 at DP = 16, the
// least a tile of 16-byte granules at that width takes).
template <int DP>
constexpr int kBtA = DP <= 32 ? 32 : 16;
template <int DP>
constexpr int kBtB = DP == 16 ? 32 : 16;

// Geometry at padded head width DP and streamed tiles of BT rows: NC
// gradient columns a CTA (DP / NC CTAs a 64-row block, for the
// accumulators' registers). Shared memory: the CTA's 64-row tiles, split
// once (hi in place, lo beside); a ring of the streamed tiles (K-major rows
// x DP, for S and dP) with the tile's key bias or row statistics; and one
// work area that each step's split fills: the streamed tiles' lo halves and
// their NC columns transposed (hi and lo; the K-major B operand of the
// gradient products).
//   A: Q | Q lo | dO | dO lo | 2 x (K, V, bias) | K lo, V lo, K^T, K^T lo
//   B: K | K lo | V | V lo | 2 x (Q, dO, m, 1/l, Delta) |
//      Q lo, dO lo, Q^T, Q^T lo, dO^T, dO^T lo
template <int DP, int BT_>
struct Tf32Plan {
  static constexpr int NC = DP < 64 ? DP : 64;
  static constexpr int NCH = DP / NC;
  static constexpr int BT = BT_;
  static constexpr int kGroup = 8 * DP * 4;   // 8-row group of a K-major tile
  static constexpr int kRowTile = kRows * DP * 4;
  static constexpr int kTile = BT * DP * 4;
  static constexpr int kTTile = NC * BT * 4;
  static constexpr int kStage0 = 4 * kRowTile;
  static constexpr int kStageA = 2 * kTile + BT * 4;
  static constexpr int kLoA = kStage0 + kRingTf32 * kStageA;
  static constexpr int kBytesA = kLoA + 2 * kTile + 2 * kTTile;
  static constexpr int kStageB = 2 * kTile + 3 * BT * 4;
  static constexpr int kLoB = kStage0 + kRingTf32 * kStageB;
  static constexpr int kBytesB = kLoB + 2 * kTile + 4 * kTTile;
  static_assert(kBytesA <= 232448 && kBytesB <= 232448, "shared memory of one block");
  static_assert((BT * 4) % 16 == 0 && kTile % 16 == 0 && kTTile % 16 == 0, "16-byte tiles");
};

// An f32 K-major tile of R rows x DP columns at `at` split in place into
// hi = tf32(x), with lo = tf32(x - hi) at `lo`. With kT, its columns
// [c0, c0 + NC) also go transposed, hi to `t_hi` and lo to `t_lo`: a
// K-major tile of NC rows (the columns) x R (the rows), within each group of
// 8 rows K position kk holding row 2*kk (kk < 4) or 2*(kk-4) + 1, the order
// in which an S accumulator hands its columns to the A registers of a tf32
// product (tf32_frags). Each thread takes 16-byte chunks (4 columns of one
// row) and writes their 4 transposed elements.
template <int R, int DP, int NC, bool kT>
__device__ __forceinline__ void split_rows(unsigned char* at, unsigned char* lo, unsigned char* t_hi,
                                           unsigned char* t_lo, int c0, int tid) {
  constexpr int kBytes = R * DP * 4, kGroup = 8 * DP * 4;
#pragma unroll 2
  for (int off = 16 * tid; off < kBytes; off += 16 * kThreads) {
    const float4 x4 = *reinterpret_cast<const float4*>(at + off);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = tf32_hi(x[e]);
      l[e] = tf32_rna(x[e] - __uint_as_float(h[e]));
    }
    *reinterpret_cast<uint4*>(at + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    if constexpr (kT) {
      const int row = (off / kGroup) * 8 + (off % 128) / 16;
      const int d0 = ((off % kGroup) / 128) * 4 - c0;  // the chunk's first column in the part
      if (d0 >= 0 && d0 < NC) {
        const int r8 = row % 8;
        const int at_t = (row / 8) * 256 + (r8 & 1) * 128 + (r8 >> 1) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dd = d0 + e, t = (dd / 8) * (8 * R * 4) + at_t + (dd % 8) * 16;
          *reinterpret_cast<uint32_t*>(t_hi + t) = h[e];
          *reinterpret_cast<uint32_t*>(t_lo + t) = l[e];
        }
      }
    }
  }
}

// X = A B^T as 3xTF32 over the DP/8 k-steps: A (64 rows) hi at `a`, lo at
// `alo`; B (BT rows) hi at `bh`, lo at `blo`; the small terms lo*hi +
// hi*lo in x_lo, hi*hi in x (each accumulator starts at zero). No commit.
template <int DP, int N>
__device__ __forceinline__ void tf32_ss3(float (&x)[N], float (&x_lo)[N], uint32_t a, uint32_t alo,
                                         uint32_t bh, uint32_t blo) {
  constexpr int G = 8 * DP * 4;
  const uint64_t da = smem_desc(a, 128, G), dal = smem_desc(alo, 128, G);
  const uint64_t db = smem_desc(bh, 128, G), dbl = smem_desc(blo, 128, G);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) wgmma_ss_tf32(x_lo, dal + 16 * j, db + 16 * j, j > 0);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) wgmma_ss_tf32(x_lo, da + 16 * j, dbl + 16 * j, 1);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) wgmma_ss_tf32(x, da + 16 * j, db + 16 * j, j > 0);
}

// The A registers of a tf32 product from the f32 values of an m64nK
// accumulator: k-step j's (row g, K c), (g+8, c), (g, c+4), (g+8, c+4) are
// columns 8j+2c and 8j+2c+1 (split_rows' transposed order), split into hi
// and lo.
template <int K>
__device__ __forceinline__ void tf32_frags(const float (&x)[K / 2], uint32_t (&hi)[K / 2],
                                           uint32_t (&lo)[K / 2]) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const float y[4] = {x[4 * j + 0], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[4 * j + e] = tf32_hi(y[e]);
      lo[4 * j + e] = tf32_rna(y[e] - __uint_as_float(hi[4 * j + e]));
    }
  }
}

// acc += A B as 3xTF32 over K/8 k-steps, A from registers (hi, lo), B K
// columns of a transposed tile of BT columns (hi at `bh`, lo at `blo`):
// small terms into acc_lo, hi*hi into acc. No commit.
template <int K, int BT, int N>
__device__ __forceinline__ void tf32_rs3(float (&acc)[N], float (&acc_lo)[N],
                                         const uint32_t (&hi)[K / 2], const uint32_t (&lo)[K / 2],
                                         uint32_t bh, uint32_t blo) {
  constexpr int G = 8 * BT * 4;
  const uint64_t db = smem_desc(bh, 128, G), dbl = smem_desc(blo, 128, G);
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const uint32_t a[4] = {lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3]};
    wgmma_rs_tf32(acc_lo, a, db + 16 * j);
  }
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const uint32_t a[4] = {hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]};
    wgmma_rs_tf32(acc_lo, a, dbl + 16 * j);
  }
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const uint32_t a[4] = {hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]};
    wgmma_rs_tf32(acc, a, db + 16 * j);
  }
}

// Each kernel's resident CTAs an SM (a register cap).
template <int DP>
constexpr int kMinBlocksTf32B = DP <= 32 ? 3 : 1;
template <int DP>
constexpr int kMinBlocksTf32A = DP <= 32 ? 3 : 1;

// Kernel A in 3xTF32: dQ (columns [c0, c0 + NC)) and the row statistics
// (m, 1/l, Delta; stored by column chunk 0) of 64 query rows of one (b, h),
// in one pass over the key tiles. dQ = sum_k dS_k K_k with dS = P (dP -
// Delta) is taken by linearity as (X - Delta Y) / l, X = sum_k e_k dP_k K_k
// and Y = sum_k e_k K_k (e = 2^(s - m), unnormalised; X, Y, l and the sum
// of e * dP rescaled by 2^(m_old - m_new) when the running max moves), so
// that Delta is not needed before the last tile and each key tile is
// loaded, split and multiplied once. X and Y hold their small terms in
// accumulators of their own; their difference carries the f32 rounding of
// both (examples/torch_attention_backward.py's f32 checks: within 2.6e-6
// of max(1, max |ref|) of the plain version and autograd).
// Logits in log2 units and ex2.approx, as the 16-bit route.
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocksTf32A<DP>)
mha_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ key_bias,
                       const float* __restrict__ dout, float* __restrict__ dq,
                       float* __restrict__ ws, int S, int H, int D, int gran, float scale,
                       float dscale) {
  using P = Tf32Plan<DP, kBtA<DP>>;
  constexpr int BT = P::BT, NC = P::NC;
  constexpr int kQ = 0, kQlo = P::kRowTile, kO = 2 * P::kRowTile, kOlo = 3 * P::kRowTile;
  constexpr int kKlo = P::kLoA, kVlo = kKlo + P::kTile, kKT = kVlo + P::kTile;
  constexpr int kKTlo = kKT + P::kTTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  allow_dependent_launch();

  const int qt = blockIdx.x / P::NCH, c0 = (blockIdx.x % P::NCH) * NC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const float* brow = key_bias + (long long)b * S;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;  // m; 1/l and Delta bhs apart
  const int ntiles = (S + BT - 1) / BT;

  if (D < DP) {  // the pad columns, zeroed once (copies fill the rest)
    for (int i = tid; i < P::kBytesA / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kRingTf32) * P::kStageA;
    load_rows<float, DP, BT>(gran, st, k + head, HD, u * BT, S, D, tid);
    load_rows<float, DP, BT>(gran, st + P::kTile, v + head, HD, u * BT, S, D, tid);
    load_bias<BT>(st + 2 * P::kTile, brow, u * BT, S, tid);
  };
  load_rows<float, DP, kRows>(gran, base + kQ, q + head, HD, qt * kRows, S, D, tid);
  load_rows<float, DP, kRows>(gran, base + kO, dout + head, HD, qt * kRows, S, D, tid);
  load_step(0);
  cp_async_commit();

  // X and Y (columns [c0, c0 + NC)), hi*hi and small terms apart
  float xa[NC / 2], xa_lo[NC / 2], ya[NC / 2], ya_lo[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) xa[i] = xa_lo[i] = ya[i] = ya_lo[i] = 0.f;
  // rows g and g+8: max, sum of e, sum of e * dP
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, dl0 = 0.f, dl1 = 0.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile u is in; every thread is done with tile u - 1
    if (u + 1 < ntiles) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kRingTf32) * P::kStageA;
    const float* bt = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);
    if (u == 0) {
      split_rows<kRows, DP, NC, false>(smem + kQ, smem + kQlo, nullptr, nullptr, 0, tid);
      split_rows<kRows, DP, NC, false>(smem + kO, smem + kOlo, nullptr, nullptr, 0, tid);
    }
    split_rows<BT, DP, NC, true>(smem + st_off, smem + kKlo, smem + kKT, smem + kKTlo, c0, tid);
    split_rows<BT, DP, NC, false>(smem + st_off + P::kTile, smem + kVlo, nullptr, nullptr, 0, tid);
    fence_async_smem();
    __syncthreads();  // hi and lo of this tile are stored

    // S = Q K^T, then dP = dO V^T, a commit group each: the work on S runs
    // while dP is in flight
    float s[BT / 2], s_lo[BT / 2], dp[BT / 2], dp_lo[BT / 2];
    wgmma_fence();
    tf32_ss3<DP>(s, s_lo, base + kQ, base + kQlo, base + st_off, base + kKlo);
    wgmma_commit();
    tf32_ss3<DP>(dp, dp_lo, base + kO, base + kOlo, base + st_off + P::kTile, base + kVlo);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(s_lo);

    // logits in log2 units, (q . k) * scale*log2(e) + bias*log2(e); the
    // running max, and X, Y, l and the sum of e * dP rescaled to it; tile 0
    // holds key 0 (finite bias): the max is finite, 2^(-inf - mx) = 0
    float e[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
      const float b0 = bb.x * kLog2e, b1 = bb.y * kLog2e;
      e[4 * i + 0] = fmaf(s[4 * i + 0] + s_lo[4 * i + 0], scale, b0);
      e[4 * i + 1] = fmaf(s[4 * i + 1] + s_lo[4 * i + 1], scale, b1);
      e[4 * i + 2] = fmaf(s[4 * i + 2] + s_lo[4 * i + 2], scale, b0);
      e[4 * i + 3] = fmaf(s[4 * i + 3] + s_lo[4 * i + 3], scale, b1);
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(e[4 * i + 0], e[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(e[4 * i + 2], e[4 * i + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = ex2_approx(m0 - mx0), a1 = ex2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    dl0 *= a0;
    l1 *= a1;
    dl1 *= a1;
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      const float a = (i & 2) ? a1 : a0;
      xa[i] *= a;
      xa_lo[i] *= a;
      ya[i] *= a;
      ya_lo[i] *= a;
    }
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      e[i] = ex2_approx(e[i] - ((i & 2) ? m1 : m0));
      if (i & 2) l1 += e[i];
      else l0 += e[i];
    }

    // dP: f = e * dP, its sum, and X += f K, Y += e K (K^T the B operand)
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dp_lo);
    float f[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      f[i] = e[i] * (dp[i] + dp_lo[i]);
      if (i & 2) dl1 += f[i];
      else dl0 += f[i];
    }
    uint32_t fh[BT / 2], fl[BT / 2], eh[BT / 2], el[BT / 2];
    tf32_frags<BT>(f, fh, fl);
    tf32_frags<BT>(e, eh, el);
    fence_regs(xa);
    fence_regs(xa_lo);
    fence_regs(ya);
    fence_regs(ya_lo);
    fence_regs(fh);
    fence_regs(fl);
    fence_regs(eh);
    fence_regs(el);
    wgmma_fence();
    tf32_rs3<BT, BT>(xa, xa_lo, fh, fl, base + kKT, base + kKTlo);
    tf32_rs3<BT, BT>(ya, ya_lo, eh, el, base + kKT, base + kKTlo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(xa);
    fence_regs(xa_lo);
    fence_regs(ya);
    fence_regs(ya_lo);
  }

  // the row sums, Delta = sum_k P dP, and dQ = (X - Delta Y) / l * scale;
  // rows >= S and columns >= D not stored; the row statistics by one
  // thread of each quad of column chunk 0
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  dl0 = quad_sum(dl0) * i0;
  dl1 = quad_sum(dl1) * i1;
  const int r0 = qt * kRows + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < NC / 8; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int d = c0 + 8 * i + 2 * c + e2, j0 = 4 * i + e2, j1 = j0 + 2;
      if (d >= D) continue;
      if (r0 < S)
        dq[head + r0 * HD + d] = (xa[j0] + xa_lo[j0] - dl0 * (ya[j0] + ya_lo[j0])) * (i0 * dscale);
      if (r1 < S)
        dq[head + r1 * HD + d] = (xa[j1] + xa_lo[j1] - dl1 * (ya[j1] + ya_lo[j1])) * (i1 * dscale);
    }
  if (c == 0 && c0 == 0) {
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

// Kernel B in 3xTF32: dK and dV (columns [c0, c0 + NC)) of 64 key rows of
// one (b, h), over the query tiles with their stored statistics. The
// accumulators' rows are keys and their columns queries (S^T, dP^T).
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocksTf32B<DP>)
mha_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ key_bias,
                        const float* __restrict__ dout, float* __restrict__ dk,
                        float* __restrict__ dv, const float* __restrict__ ws, int S, int H,
                        int D, int gran, float scale, float dscale) {
  using P = Tf32Plan<DP, kBtB<DP>>;
  constexpr int BT = P::BT, NC = P::NC;
  constexpr int kK = 0, kKlo = P::kRowTile, kV = 2 * P::kRowTile, kVlo = 3 * P::kRowTile;
  constexpr int kQlo = P::kLoB, kOlo = kQlo + P::kTile, kQT = kOlo + P::kTile;
  constexpr int kQTlo = kQT + P::kTTile, kOT = kQTlo + P::kTTile, kOTlo = kOT + P::kTTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int kt = blockIdx.x / P::NCH, c0 = (blockIdx.x % P::NCH) * NC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* stats = ws + ((long long)b * H + h) * S;
  const int ntiles = (S + BT - 1) / BT;

  if (D < DP) {  // the pad columns, zeroed once (copies fill the rest)
    for (int i = tid; i < P::kBytesB / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kRingTf32) * P::kStageB;
    const int q0 = u * BT;
    load_rows<float, DP, BT>(gran, st, q + head, HD, q0, S, D, tid);
    load_rows<float, DP, BT>(gran, st + P::kTile, dout + head, HD, q0, S, D, tid);
    load_stats<BT, kThreads>(st + 2 * P::kTile, stats, bhs, q0, S, tid);
  };
  // this thread's key rows and their biases in log2 units (-inf past S)
  const int r0 = kt * kRows + warp * 16 + g, r1 = r0 + 8;
  const float kb0 = r0 < S ? key_bias[(long long)b * S + r0] * kLog2e : -INFINITY;
  const float kb1 = r1 < S ? key_bias[(long long)b * S + r1] * kLog2e : -INFINITY;
  // K and V in and split before kernel A's statistics are waited on
  load_rows<float, DP, kRows>(gran, base + kK, k + head, HD, kt * kRows, S, D, tid);
  load_rows<float, DP, kRows>(gran, base + kV, v + head, HD, kt * kRows, S, D, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<kRows, DP, NC, false>(smem + kK, smem + kKlo, nullptr, nullptr, 0, tid);
  split_rows<kRows, DP, NC, false>(smem + kV, smem + kVlo, nullptr, nullptr, 0, tid);
  wait_for_prior_grid();
  load_step(0);
  cp_async_commit();

  float acc_v[NC / 2], acc_v_lo[NC / 2], acc_k[NC / 2], acc_k_lo[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc_v[i] = acc_v_lo[i] = acc_k[i] = acc_k_lo[i] = 0.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (u + 1 < ntiles) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kRingTf32) * P::kStageB;
    const uint32_t qs = base + st_off, os = qs + P::kTile, qts = base + kQT, ots = base + kOT;
    const float* sm = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);
    split_rows<BT, DP, NC, true>(smem + st_off, smem + kQlo, smem + kQT, smem + kQTlo, c0, tid);
    split_rows<BT, DP, NC, true>(smem + st_off + P::kTile, smem + kOlo, smem + kOT, smem + kOTlo, c0,
                                 tid);
    fence_async_smem();
    __syncthreads();

    // S^T = K Q^T, then dP^T = V dO^T, a commit group each: the work on
    // S^T runs while dP^T is in flight
    float s[BT / 2], s_lo[BT / 2], dp[BT / 2], dp_lo[BT / 2];
    wgmma_fence();
    tf32_ss3<DP>(s, s_lo, base + kK, base + kKlo, qs, base + kQlo);
    wgmma_commit();
    tf32_ss3<DP>(dp, dp_lo, base + kV, base + kVlo, os, base + kOlo);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(s_lo);
    // P^T, each query column with its own statistics, in registers of its
    // own
    float pt[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const int col = 8 * i + 2 * c;
      const float2 mm = *reinterpret_cast<const float2*>(sm + col);
      const float2 il = *reinterpret_cast<const float2*>(sm + BT + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float logit = fmaf(s[4 * i + e] + s_lo[4 * i + e], scale, e < 2 ? kb0 : kb1);
        pt[4 * i + e] = ex2_approx(logit - (odd ? mm.y : mm.x)) * (odd ? il.y : il.x);
      }
    }
    uint32_t ph[BT / 2], pl[BT / 2], dh[BT / 2], dl[BT / 2];
    tf32_frags<BT>(pt, ph, pl);
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dp_lo);
    // dS^T = P^T (dP^T - Delta)
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const float2 dd = *reinterpret_cast<const float2*>(sm + 2 * BT + 8 * i + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pt[4 * i + e] *= dp[4 * i + e] + dp_lo[4 * i + e] - ((e & 1) ? dd.y : dd.x);
    }
    tf32_frags<BT>(pt, dh, dl);
    fence_regs(acc_v);
    fence_regs(acc_v_lo);
    fence_regs(acc_k);
    fence_regs(acc_k_lo);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    wgmma_fence();
    tf32_rs3<BT, BT>(acc_v, acc_v_lo, ph, pl, ots, base + kOTlo);
    tf32_rs3<BT, BT>(acc_k, acc_k_lo, dh, dl, qts, base + kQTlo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_v_lo);
    fence_regs(acc_k);
    fence_regs(acc_k_lo);
  }

  // dK = (acc_k + acc_k_lo) * scale, dV = acc_v + acc_v_lo; key rows >= S
  // and columns >= D not stored
#pragma unroll
  for (int i = 0; i < NC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + 8 * i + 2 * c + e;
      if (d >= D) continue;
      if (r0 < S) {
        dk[head + r0 * HD + d] = (acc_k[4 * i + e] + acc_k_lo[4 * i + e]) * dscale;
        dv[head + r0 * HD + d] = acc_v[4 * i + e] + acc_v_lo[4 * i + e];
      }
      if (r1 < S) {
        dk[head + r1 * HD + d] = (acc_k[4 * i + 2 + e] + acc_k_lo[4 * i + 2 + e]) * dscale;
        dv[head + r1 * HD + d] = acc_v[4 * i + 2 + e] + acc_v_lo[4 * i + 2 + e];
      }
    }
}

// ---- the 3xTF32 route above 128 columns: f32 at D 129-256 ----

// Streamed tiles' rows above DP = 128 (8 at DP = 256, for shared memory).
template <int DP>
constexpr int kBtWide = DP == 256 ? 8 : 16;
// k-steps a commit group of the products whose A is split in registers
constexpr int kSplitSteps = 2;

// Geometry at DP = 192 / 256: one CTA of two warpgroups takes a 64-row
// block and all DP gradient columns. The 64-row tiles stay raw f32 (no lo
// tile): they are the A operands of S and dP (S^T and dP^T), each k-step's
// A elements split in registers (tf32_rs3_split, the same rounding as
// split_rows). Warpgroup 0 takes S (S^T), warpgroup 1 dP (dP^T), at once;
// the probabilities cross to warpgroup 1 through shared memory; each
// warpgroup then owns one gradient accumulator over all DP columns.
//   A: Q | dO | 2 x (K, V, bias) | K lo, V lo, K^T, K^T lo | e, the rescale
//      (warpgroup 0 -> 1), the row statistics at the end
//   B: K | V | 2 x (Q, dO, m, 1/l, Delta) | Q lo, dO lo, Q^T, Q^T lo, dO^T,
//      dO^T lo | P^T (warpgroup 0 -> 1)
// Bytes at DP = 192 / 256: A 203,904 / 201,792, B 225,664 / 215,232.
template <int DP>
struct Tf32WidePlan {
  static constexpr int BT = kBtWide<DP>;
  static constexpr int kGroup = 8 * DP * 4;
  static constexpr int kRowTile = kRows * DP * 4;
  static constexpr int kTile = BT * DP * 4;  // a streamed tile, and its transpose
  static constexpr int kStage0 = 2 * kRowTile;
  static constexpr int kX = kRows * BT * 4;  // a tile's probabilities, one float a thread each
  static constexpr int kStageA = 2 * kTile + BT * 4;
  static constexpr int kLoA = kStage0 + kRingTf32 * kStageA;
  static constexpr int kXA = kLoA + 4 * kTile;
  static constexpr int kBytesA = kXA + kX + 2 * kThreads * 4 + 4 * kThreads * 4;
  static constexpr int kStageB = 2 * kTile + 3 * BT * 4;
  static constexpr int kLoB = kStage0 + kRingTf32 * kStageB;
  static constexpr int kXB = kLoB + 6 * kTile;
  static constexpr int kBytesB = kXB + kX;
  static_assert(kBytesA <= 232448 && kBytesB <= 232448, "shared memory of one block");
  static_assert((BT * 4) % 16 == 0 && kTile % 128 == 0, "16-byte tiles");
};

// acc += A B over K/8 k-steps as 3xTF32 into one accumulator (lo*hi and
// hi*lo, then hi*hi): A from registers (hi, lo), B the NCOLS columns of a
// transposed tile of BT columns (hi at `bh`, lo at `blo`), as products of
// 64 columns (a chunk's accumulators are acc[32 ch, 32 ch + 32); its 8-row
// groups of the transposed tile 64 * BT * 4 bytes further on). No commit.
template <int K, int BT, int NCOLS>
__device__ __forceinline__ void tf32_rs3_cols(float (&acc)[NCOLS / 2], const uint32_t (&hi)[K / 2],
                                              const uint32_t (&lo)[K / 2], uint32_t bh,
                                              uint32_t blo) {
  constexpr int G = 8 * BT * 4;
#pragma unroll
  for (int ch = 0; ch < NCOLS / 64; ++ch) {
    float(&d)[32] = *reinterpret_cast<float(*)[32]>(&acc[32 * ch]);
    const uint64_t db = smem_desc(bh + ch * 64 * BT * 4, 128, G);
    const uint64_t dbl = smem_desc(blo + ch * 64 * BT * 4, 128, G);
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      const uint32_t a[4] = {lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3]};
      wgmma_rs_tf32(d, a, db + 16 * j);
    }
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      const uint32_t a[4] = {hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]};
      wgmma_rs_tf32(d, a, dbl + 16 * j);
    }
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      const uint32_t a[4] = {hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]};
      wgmma_rs_tf32(d, a, db + 16 * j);
    }
  }
}

// Kernel A above 128 columns: dQ (all DP columns) and the row statistics of
// 64 query rows of one (b, h), in one pass over the key tiles, dQ by
// linearity as (X - Delta Y) / l as mha_bwd_dq_tf32_kernel. Warpgroup 0
// computes S, the running max, l and e = 2^(s - m) and accumulates Y =
// sum e K; warpgroup 1 computes dP, takes e and the rescale from shared
// memory, and accumulates X = sum e dP K and the sum of e * dP. X and Y
// keep their three terms in one accumulator each (two would not fit in a
// thread's registers beside the tile's products); Y crosses to warpgroup
// 1 at the end.
template <int DP>
__global__ void __launch_bounds__(2 * kThreads, 1)
mha_bwd_dq_tf32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ key_bias,
                            const float* __restrict__ dout, float* __restrict__ dq,
                            float* __restrict__ ws, int S, int H, int D, int gran, float scale,
                            float dscale) {
  using P = Tf32WidePlan<DP>;
  constexpr int BT = P::BT;
  constexpr int kQ = 0, kO = P::kRowTile;
  constexpr int kKlo = P::kLoA, kVlo = kKlo + P::kTile, kKT = kVlo + P::kTile;
  constexpr int kKTlo = kKT + P::kTile, kXe = P::kXA, kXa = kXe + P::kX;
  constexpr int kXs = kXa + 2 * kThreads * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  allow_dependent_launch();

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kThreads, wtid = tid % kThreads;
  const int warp = wtid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const float* brow = key_bias + (long long)b * S;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;  // m; 1/l and Delta bhs apart
  const int ntiles = (S + BT - 1) / BT;
  float* xe = reinterpret_cast<float*>(smem + kXe);
  float* xa = reinterpret_cast<float*>(smem + kXa);
  float* xs = reinterpret_cast<float*>(smem + kXs);

  if (D < DP) {  // the pad columns, zeroed once (copies fill the rest)
    for (int i = tid; i < P::kBytesA / 16; i += 2 * kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // warpgroup 0 copies K and the bias, warpgroup 1 V
  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kRingTf32) * P::kStageA;
    if (wg == 0) {
      load_rows<float, DP, BT>(gran, st, k + head, HD, u * BT, S, D, wtid);
      load_bias<BT>(st + 2 * P::kTile, brow, u * BT, S, wtid);
    } else {
      load_rows<float, DP, BT>(gran, st + P::kTile, v + head, HD, u * BT, S, D, wtid);
    }
  };
  load_rows<float, DP, kRows>(gran, base + (wg ? kO : kQ), (wg ? dout : q) + head, HD,
                              qt * kRows, S, D, wtid);
  load_step(0);
  cp_async_commit();

  // warpgroup 0: Y, row max and sum of e; warpgroup 1: X, sum of e * dP
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile u is in; every thread is done with tile u - 1
    if (u + 1 < ntiles) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kRingTf32) * P::kStageA;
    if (wg == 0)
      split_rows<BT, DP, DP, true>(smem + st_off, smem + kKlo, smem + kKT, smem + kKTlo, 0, wtid);
    else
      split_rows<BT, DP, DP, false>(smem + st_off + P::kTile, smem + kVlo, nullptr, nullptr, 0,
                                    wtid);
    fence_async_smem();
    __syncthreads();  // hi and lo of this tile are stored

    // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
    float x[BT / 2], x_lo[BT / 2];
    {
      constexpr int G = P::kGroup;
      const uint32_t bh = base + st_off + (wg ? P::kTile : 0), blo = base + (wg ? kVlo : kKlo);
      tf32_rs3_split<DP, kSplitSteps>(x, x_lo, smem + (wg ? kO : kQ), smem_desc(bh, 128, G),
                                      smem_desc(blo, 128, G), tid);
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(x_lo);
    }
    float e[BT / 2], a0, a1;
    if (wg == 0) {
      // logits in log2 units, (q . k) * scale*log2(e) + bias*log2(e); the
      // running max, l rescaled to it; tile 0 holds key 0 (finite bias): the
      // max is finite, 2^(-inf - mx) = 0
      const float* bt = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
        const float b0 = bb.x * kLog2e, b1 = bb.y * kLog2e;
        e[4 * i + 0] = fmaf(x[4 * i + 0] + x_lo[4 * i + 0], scale, b0);
        e[4 * i + 1] = fmaf(x[4 * i + 1] + x_lo[4 * i + 1], scale, b1);
        e[4 * i + 2] = fmaf(x[4 * i + 2] + x_lo[4 * i + 2], scale, b0);
        e[4 * i + 3] = fmaf(x[4 * i + 3] + x_lo[4 * i + 3], scale, b1);
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(e[4 * i + 0], e[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(e[4 * i + 2], e[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      a0 = ex2_approx(m0 - mx0);
      a1 = ex2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        e[i] = ex2_approx(e[i] - ((i & 2) ? m1 : m0));
        if (i & 2) l1 += e[i];
        else l0 += e[i];
        xe[i * kThreads + wtid] = e[i];
      }
      xa[wtid] = a0;
      xa[kThreads + wtid] = a1;
    }
    __syncthreads();  // e and the rescale of tile u are in shared memory
    if (wg == 1) {
      // f = e * dP and its row sums (l0, l1 hold them in warpgroup 1)
      a0 = xa[wtid];
      a1 = xa[kThreads + wtid];
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        e[i] = xe[i * kThreads + wtid] * (x[i] + x_lo[i]);
        if (i & 2) l1 += e[i];
        else l0 += e[i];
      }
    }
    // acc = acc * 2^(m_old - m_new) + (e or f) K, K^T the B operand
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
    uint32_t eh[BT / 2], el[BT / 2];
    tf32_frags<BT>(e, eh, el);
    fence_regs(acc);
    fence_regs(eh);
    fence_regs(el);
    wgmma_fence();
    tf32_rs3_cols<BT, BT, DP>(acc, eh, el, base + kKT, base + kKTlo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // Y and the row max and sum cross to warpgroup 1 (Q's tile is free: only
  // warpgroup 0 read it); there Delta = sum_k P dP and dQ = (X - Delta Y)
  // / l * scale, rows >= S and columns >= D not stored, and the row
  // statistics by one thread of each quad
  float* xy = reinterpret_cast<float*>(smem + kQ);
  if (wg == 0) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) xy[i * kThreads + wtid] = acc[i];
    xs[wtid] = m0;
    xs[kThreads + wtid] = m1;
    xs[2 * kThreads + wtid] = l0;
    xs[3 * kThreads + wtid] = l1;
  }
  __syncthreads();
  if (wg == 0) return;
  m0 = xs[wtid];
  m1 = xs[kThreads + wtid];
  const float i0 = 1.f / xs[2 * kThreads + wtid], i1 = 1.f / xs[3 * kThreads + wtid];
  const float dl0 = quad_sum(l0) * i0, dl1 = quad_sum(l1) * i1;
  const int r0 = qt * kRows + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int d = 8 * i + 2 * c + e2, j0 = 4 * i + e2, j1 = j0 + 2;
      if (d >= D) continue;
      if (r0 < S) dq[head + r0 * HD + d] = (acc[j0] - dl0 * xy[j0 * kThreads + wtid]) * (i0 * dscale);
      if (r1 < S) dq[head + r1 * HD + d] = (acc[j1] - dl1 * xy[j1 * kThreads + wtid]) * (i1 * dscale);
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

// Kernel B above 128 columns: dK and dV (all DP columns) of 64 key rows of
// one (b, h), over the query tiles with their stored statistics.
// Warpgroup 0 computes S^T and P^T and accumulates dV = sum P^T dO;
// warpgroup 1 computes dP^T, takes P^T from shared memory and accumulates
// dK = sum dS^T Q, dS^T = P^T (dP^T - Delta). One accumulator each, the
// three terms in it.
template <int DP>
__global__ void __launch_bounds__(2 * kThreads, 1)
mha_bwd_dkv_tf32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ key_bias,
                             const float* __restrict__ dout, float* __restrict__ dk,
                             float* __restrict__ dv, const float* __restrict__ ws, int S, int H,
                             int D, int gran, float scale, float dscale) {
  using P = Tf32WidePlan<DP>;
  constexpr int BT = P::BT;
  constexpr int kK = 0, kV = P::kRowTile;
  constexpr int kQlo = P::kLoB, kOlo = kQlo + P::kTile, kQT = kOlo + P::kTile;
  constexpr int kQTlo = kQT + P::kTile, kOT = kQTlo + P::kTile, kOTlo = kOT + P::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kThreads, wtid = tid % kThreads;
  const int warp = wtid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* stats = ws + ((long long)b * H + h) * S;
  const int ntiles = (S + BT - 1) / BT;
  float* xp = reinterpret_cast<float*>(smem + P::kXB);

  if (D < DP) {  // the pad columns, zeroed once (copies fill the rest)
    for (int i = tid; i < P::kBytesB / 16; i += 2 * kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // warpgroup 0 copies Q and the statistics, warpgroup 1 dO
  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kRingTf32) * P::kStageB;
    const int q0 = u * BT;
    if (wg == 0) {
      load_rows<float, DP, BT>(gran, st, q + head, HD, q0, S, D, wtid);
      load_stats<BT, kThreads>(st + 2 * P::kTile, stats, bhs, q0, S, wtid);
    } else {
      load_rows<float, DP, BT>(gran, st + P::kTile, dout + head, HD, q0, S, D, wtid);
    }
  };
  // this thread's key rows and their biases in log2 units (-inf past S)
  const int r0 = kt * kRows + warp * 16 + g, r1 = r0 + 8;
  const float kb0 = r0 < S ? key_bias[(long long)b * S + r0] * kLog2e : -INFINITY;
  const float kb1 = r1 < S ? key_bias[(long long)b * S + r1] * kLog2e : -INFINITY;
  // K and V in before kernel A's statistics are waited on
  load_rows<float, DP, kRows>(gran, base + (wg ? kV : kK), (wg ? v : k) + head, HD, kt * kRows,
                              S, D, wtid);
  cp_async_commit();
  wait_for_prior_grid();
  load_step(0);
  cp_async_commit();

  // warpgroup 0: dV; warpgroup 1: dK
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (u + 1 < ntiles) load_step(u + 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kRingTf32) * P::kStageB;
    const float* sm = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTile);
    if (wg == 0)
      split_rows<BT, DP, DP, true>(smem + st_off, smem + kQlo, smem + kQT, smem + kQTlo, 0, wtid);
    else
      split_rows<BT, DP, DP, true>(smem + st_off + P::kTile, smem + kOlo, smem + kOT,
                                   smem + kOTlo, 0, wtid);
    fence_async_smem();
    __syncthreads();

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
    float x[BT / 2], x_lo[BT / 2];
    {
      constexpr int G = P::kGroup;
      const uint32_t bh = base + st_off + (wg ? P::kTile : 0), blo = base + (wg ? kOlo : kQlo);
      tf32_rs3_split<DP, kSplitSteps>(x, x_lo, smem + (wg ? kV : kK), smem_desc(bh, 128, G),
                                      smem_desc(blo, 128, G), tid);
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(x_lo);
    }
    float pt[BT / 2];
    if (wg == 0) {
      // P^T, each query column with its own statistics
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const int col = 8 * i + 2 * c;
        const float2 mm = *reinterpret_cast<const float2*>(sm + col);
        const float2 il = *reinterpret_cast<const float2*>(sm + BT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float logit = fmaf(x[4 * i + e] + x_lo[4 * i + e], scale, e < 2 ? kb0 : kb1);
          pt[4 * i + e] = ex2_approx(logit - (odd ? mm.y : mm.x)) * (odd ? il.y : il.x);
          xp[(4 * i + e) * kThreads + wtid] = pt[4 * i + e];
        }
      }
    }
    __syncthreads();  // P^T of tile u is in shared memory
    if (wg == 1) {
      // dS^T = P^T (dP^T - Delta)
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const float2 dd = *reinterpret_cast<const float2*>(sm + 2 * BT + 8 * i + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[4 * i + e] = xp[(4 * i + e) * kThreads + wtid] *
                          (x[4 * i + e] + x_lo[4 * i + e] - ((e & 1) ? dd.y : dd.x));
      }
    }
    // warpgroup 0: dV += P^T dO (dO^T the B operand); 1: dK += dS^T Q (Q^T)
    uint32_t ph[BT / 2], pl[BT / 2];
    tf32_frags<BT>(pt, ph, pl);
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    tf32_rs3_cols<BT, BT, DP>(acc, ph, pl, base + (wg ? kQT : kOT), base + (wg ? kQTlo : kOTlo));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // dV = acc (warpgroup 0), dK = acc * scale (warpgroup 1); key rows >= S
  // and columns >= D not stored
  float* out = wg ? dk : dv;
  const float mul = wg ? dscale : 1.f;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * i + 2 * c + e;
      if (d >= D) continue;
      if (r0 < S) out[head + r0 * HD + d] = acc[4 * i + e] * mul;
      if (r1 < S) out[head + r1 * HD + d] = acc[4 * i + 2 + e] * mul;
    }
}

// ---- launches ----

// Kernel B on the stream after kernel A, as a programmatic dependent
// launch: its CTAs may start while kernel A's last ones run, and wait in
// wait_for_prior_grid for kernel A's results.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kern)(Params...), dim3 grid, int threads, int smem_bytes,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

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

// the widest copy granule every row of q, k, v and dout starts on
inline int granule(const Args& a, size_t itemsize) {
  const uintptr_t w = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout |
                      (uintptr_t)(a.D * itemsize) | 16u;
  return (int)(w & (~w + 1));
}

// the padded head width of the instance the last call launched (host side;
// read by rrt_mha_bwd_last_dp)
int g_last_dp = 0;

template <typename T, int DP>
cudaError_t launch_tc(const Args& a) {
  using P = BwdPlan<T, DP>;
  auto ka = mha_bwd_dq_kernel<T, DP>;
  auto kb = mha_bwd_dkv_kernel<T, DP>;
  cudaError_t err = allow_smem(ka, P::kBytesA);
  if (err == cudaSuccess) err = allow_smem(kb, P::kBytesB);
  if (err != cudaSuccess) return err;
  const int gran = granule(a, sizeof(T));
  const dim3 grid((a.S + kRows * P::WGA - 1) / (kRows * P::WGA), a.H, a.B);
  const dim3 grid_b((a.S + kRows * P::WGB - 1) / (kRows * P::WGB) * P::NCH, a.H, a.B);
  const float scale = kLog2e / sqrtf((float)a.D), dscale = 1.0f / sqrtf((float)a.D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  ka<<<grid, kThreads * P::WGA, P::kBytesA, a.stream>>>(
      q, k, v, a.bias, dout, static_cast<T*>(a.dq), a.ws, a.S, a.H, a.D, gran, scale, dscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  g_last_dp = DP;
  return launch_after(kb, grid_b, kThreads * P::WGB, P::kBytesB, a.stream, q, k, v, a.bias, dout,
                      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.ws, a.S, a.H, a.D, gran,
                      scale, dscale);
}

template <int DP>
cudaError_t launch_tf32(const Args& a) {
  using PA = Tf32Plan<DP, kBtA<DP>>;
  using PB = Tf32Plan<DP, kBtB<DP>>;
  auto ka = mha_bwd_dq_tf32_kernel<DP>;
  auto kb = mha_bwd_dkv_tf32_kernel<DP>;
  cudaError_t err = allow_smem(ka, PA::kBytesA);
  if (err == cudaSuccess) err = allow_smem(kb, PB::kBytesB);
  if (err != cudaSuccess) return err;
  const int gran = granule(a, sizeof(float));
  const dim3 grid(((a.S + kRows - 1) / kRows) * PA::NCH, a.H, a.B);
  const float scale = kLog2e / sqrtf((float)a.D), dscale = 1.0f / sqrtf((float)a.D);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  ka<<<grid, kThreads, PA::kBytesA, a.stream>>>(q, k, v, a.bias, dout, static_cast<float*>(a.dq),
                                                a.ws, a.S, a.H, a.D, gran, scale, dscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  g_last_dp = DP;
  return launch_after(kb, grid, kThreads, PB::kBytesB, a.stream, q, k, v, a.bias, dout,
                      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.ws, a.S, a.H, a.D,
                      gran, scale, dscale);
}

template <int DP>
cudaError_t launch_tf32_wide(const Args& a) {
  using P = Tf32WidePlan<DP>;
  auto ka = mha_bwd_dq_tf32_wide_kernel<DP>;
  auto kb = mha_bwd_dkv_tf32_wide_kernel<DP>;
  cudaError_t err = allow_smem(ka, P::kBytesA);
  if (err == cudaSuccess) err = allow_smem(kb, P::kBytesB);
  if (err != cudaSuccess) return err;
  const int gran = granule(a, sizeof(float));
  const dim3 grid((a.S + kRows - 1) / kRows, a.H, a.B);
  const float scale = kLog2e / sqrtf((float)a.D), dscale = 1.0f / sqrtf((float)a.D);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  ka<<<grid, 2 * kThreads, P::kBytesA, a.stream>>>(q, k, v, a.bias, dout,
                                                   static_cast<float*>(a.dq), a.ws, a.S, a.H,
                                                   a.D, gran, scale, dscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  g_last_dp = DP;
  return launch_after(kb, grid, 2 * kThreads, P::kBytesB, a.stream, q, k, v, a.bias, dout,
                      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.ws, a.S, a.H, a.D,
                      gran, scale, dscale);
}

template <typename T>
cudaError_t dispatch_d(const Args& a) {
  if constexpr (!std::is_same<T, float>::value) {
    if (a.D <= 16) return launch_tc<T, 16>(a);
    if (a.D <= 32) return launch_tc<T, 32>(a);
    if (a.D <= 64) return launch_tc<T, 64>(a);
    if (a.D <= 128) return launch_tc<T, 128>(a);
    if (a.D <= 192) return launch_tc<T, 192>(a);
    return launch_tc<T, 256>(a);
  } else {
    if (a.D <= 16) return launch_tf32<16>(a);
    if (a.D <= 32) return launch_tf32<32>(a);
    if (a.D <= 64) return launch_tf32<64>(a);
    if (a.D <= 128) return launch_tf32<128>(a);
    if (a.D <= 192) return launch_tf32_wide<192>(a);
    return launch_tf32_wide<256>(a);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16, 2 = float32. q, k, v, dout (the
// gradient of the forward's output), dq, dk, dv: (B, S, H*D) contiguous;
// key_bias (B, S) f32 contiguous; ws: 3 * B * H * S floats of scratch.
// 1 <= D <= 256. Route (ops/attention.py:backward_route): bf16/f16 on
// wgmma at every D; f32 as 3xTF32 on wgmma at every D. Returns a
// cudaError_t (0 = launched).
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

// The padded head width DP of the kernels (route, DP) that the last
// rrt_mha_bwd call launched (0 before any).
extern "C" int rrt_mha_bwd_last_dp() { return g_last_dp; }
