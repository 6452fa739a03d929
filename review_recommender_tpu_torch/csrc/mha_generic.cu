// Multi-head attention forward for Hopper (sm_90a): the types, head widths
// and layouts that csrc/mha_fwd.cu does not take, on the tensor cores.
//
// Replaces, beside mha_fwd.cu, the TPU kernel
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_kernel (:64,
// reached through mha_pallas :92), which runs one (batch, head) in the input
// type for any float type, head width and length. mha_fwd.cu takes bf16/f16
// at D in {32, 64, 128}; ops/attention.py:kernel_route sends the rest here:
//   - f32, bf16 and f16 inputs;
//   - any head width D from 1 to 256 (wider heads are csrc/mha_wide.cu's)
//     and any H*D row stride;
//   - any S >= 1.
// For each (batch, head) it computes softmax(Q K^T * 1/sqrt(d) + key_bias)
// V with q, k, v and out (B, S, H*D) row-major, read in place, and key_bias
// (B, S) f32 (0 keep, -1e30 drop).
//
// What bounds it on an H100 SXM (the published peaks at 700 W):
//   - f32 at the f32 cross-encoder's shape (B=64, S=512, H=12, D=32):
//     4*B*H*S*S*D = 25.8 GFLOP. Exact f32 products on the tensor cores take
//     three TF32 products each (3xTF32 below): 3 x 25.8 GFLOP at 495 TFLOP/s
//     is 0.156 ms (on the CUDA cores, 67 TFLOP/s: 0.385 ms). One softmax
//     pass takes B*H*S*S = 201 M exponentials, 0.048 ms at 16 per SM per
//     clock; HBM 201 MB, 0.060 ms.
//   - bf16 at TinyBERT-4L-312D's heads (64, 512, 12, 26): 100.7 MB of q, k, v
//     and out at 3.35 TB/s, 0.0245 ms; two passes of exponentials 0.097 ms,
//     which is the real floor; the tensor cores at D padded to 32 take
//     0.032 ms.
//
//   - bf16 at 2 heads of 192 (64, 512, 2, 192): q, k, v and out 100.7 MB,
//     0.030 ms; the two passes' three products, 38.7 GFLOP at 989 TFLOP/s,
//     0.039 ms.
//
// Design (mha_tc_kernel): every dtype and D. One CTA of one warpgroup (128
// threads; two above DP = 128, below) takes 64 query rows of one (b, h) a
// warpgroup and walks the keys in tiles of BK = 64 (32 in f32 at D > 32, 16
// in f32 above DP = 128, for shared memory):
//   - Tiles live in shared memory in wgmma's canonical no-swizzle layout:
//     core matrices of 8 rows x 16 bytes, 128 contiguous bytes each, the
//     16-byte column chunks of an 8-row group 128 bytes apart, the groups
//     8 * DP * itemsize apart. Columns are padded from D to DP in {16, 32,
//     64, 128, 192, 256}; the pad is zeroed once at kernel start and never
//     written again, so it adds zeros to Q K^T and fills discarded columns
//     of P V.
//     (TMA cannot read such a head: its box rows are multiples of 16
//     bytes, and D = 26 in bf16 is 52; copies into shared memory can.)
//   - Loads: a 2-stage ring of key tiles (K, V and the tile's key bias),
//     filled by cp.async in the widest granule of 16, 8 or 4 bytes that the
//     pointers and D * itemsize allow; keys past S are zero-filled (their
//     bias is -inf). Where only 2-byte alignment holds (an odd D in
//     bf16/f16) the same ring is filled by element loads and stores. Step
//     u + 1's copies are issued right after step u's barrier and overlap
//     step u's products.
//   - bf16/f16: S = Q K^T by wgmma m64n64k16 (Q and K K-major, DP/16
//     k-steps); two softmax passes over the key tiles, as mha_fwd.cu, so
//     that P = exp(s - m) / l is rounded to the input type before P V as
//     the plain version rounds it: pass 1 keeps the running row max and
//     sum (the sum rescaled by exp(m_old - m_new)), pass 2 computes S again
//     and O += P V by wgmma m64nDPk16 (above DP = 128 as products of 128
//     columns and the rest), P from the S accumulators in registers, V
//     from shared memory N-major through the transpose bit.
//     As in mha_fwd.cu the logits are taken in log2 units (one FMA:
//     (q . k) * log2(e)/sqrt(d) + bias * log2(e)), exponentials by
//     ex2.approx and the division as a multiply by 1/l, which moves an f32
//     probability by an ulp or two before it is rounded to 16 bits.
//   - bf16/f16 at D 129-256 (DP 192 or 256, so that D = 192 pads nothing):
//     O takes DP/2 f32 registers a thread (96 or 128) beside S (32) and P
//     (16). Two warpgroups a CTA, each with 64 query rows and its own Q
//     tile, share one ring of 64-key tiles (147,968 / 197,120 bytes of
//     shared memory, one CTA an SM), each warpgroup copying half of every
//     tile. The ring's tiles come from L2, read again by every block of a
//     head's query rows, and those copies bound the kernel: at (64, 512,
//     2, 192) it takes 0.2367 ms, 0.1522 with the next tile's copies taken
//     out, and 0.3765 with one warpgroup a CTA copying every tile itself
//     (examples/torch_generic_breakdown.py, H100). At (32, 128, 2, 192)
//     the 64 CTAs of 128 rows leave SMs idle: 0.0267 against 0.0247.
//   - f32 (3xTF32): each operand x is split as hi = tf32(x), lo = tf32(x -
//     hi) (cvt.rna); a product is lo*hi + hi*lo + hi*hi, the small terms
//     first, in f32 accumulators (the lo*lo term, 2^-22 of the product, is
//     dropped): wgmma m64n64k8 (m64n32k8) for Q K^T and m64nDPk8 for P V.
//     TF32 wgmma reads both operands K-major, so V is copied transposed, a
//     4-byte cp.async an element, into V^T (d rows, keys along K). The S
//     accumulators hand P to the P V wgmma as its A registers when the keys
//     of each group of 8 are taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
//     which is the order V^T stores them in. Each landed tile is split in
//     place (hi) with lo beside it, Q once. One softmax pass (online): the
//     row max, the sum and O rescaled by exp(m_old - m_new) each tile and O
//     divided by the row sum at the end; the probabilities are not rounded
//     (f32 is the input type), so this equals the two-pass result up to
//     the order of the f32 sums. The tensor cores truncate each sum they
//     add to an accumulator, so the small terms (lo*hi + hi*lo) and the
//     large ones (hi*hi) of Q K^T and of a tile's P V go to accumulators of
//     their own, summed in registers, and the tile's P V is added to O by
//     FMA. On an H100 a chain of tiles into one O gave 2.6 times the error
//     against the plain version (5.2e-6 against 2.0e-6 at the shape
//     above), and one accumulator for all three terms moved the f32
//     bi-encoder's query vectors further from those of the plain version:
//     enough that, once rounded to a bf16 corpus's type, they changed a
//     search's fused scores by 1.1e-4. The logits keep the plain version's op order: (q . k) * scale, then
//     + bias, each rounded alone, expf (not ex2.approx) and IEEE divisions.
//
//   - f32 at D 129-256 (DP 192 or 256): Q and its lo half resident would
//     take 96 / 128 KB a warpgroup, so Q stays raw f32 and each k-step of
//     S = Q K^T loads its A elements from the raw tile (32 consecutive
//     words a warp load, no bank conflict) and splits them in registers,
//     hi = tf32(x) by adding half the dropped bits' weight and clearing
//     them (cvt.rna's result but for a NaN) and lo = cvt.rna(x - hi): the
//     same three RS products (tf32_wgmma.cuh:tf32_rs3_split), two k-steps a
//     commit group, each group waited on before its A registers are reused.
//     Two warpgroups a CTA, 64 query rows each, share one ring of 16-key
//     tiles (warpgroup 0 copies and splits K, 1 transposes and splits V;
//     172,160 / 229,504 bytes, one CTA an SM). O takes DP/2 registers a
//     thread, so a tile's P V is taken in chunks of 64 columns (kPvCols),
//     each in its own pv / pv_lo accumulators of 32 registers, added to O
//     by FMA before the next chunk is issued: the accumulators stay apart
//     as the accuracy needs. At (64, 512, 2, 192) this takes 0.661-0.663
//     ms against the CUDA-core kernel it replaced at 3.63-3.64, its plain
//     version at 1.49-1.52 and SDPA at 0.76-0.81 (examples/
//     torch_attention_ab.py --kernel wide_heads, parent and change in one
//     call, H100); one warpgroup a CTA, each copying and splitting every
//     tile itself, takes 1.057 (examples/torch_generic_breakdown.py).
//
// Semantics, every route:
//   - an all-masked row (every bias -1e30) comes out uniform over the S
//     real keys: (q.k)*scale - 1e30 == -1e30 in f32;
//   - keys from S to the tile edge get logit -inf and zero V rows;
//   - query rows >= S and columns >= D are not stored.
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
constexpr int kRows = 64;      // query rows a warpgroup of mha_tc_kernel: wgmma's M
constexpr int kStages = 2;     // key-tile ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHeadDim = 256;

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

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^x for f32 (expf, as the plain version), 2^x for 16-bit types, whose
// logits are in log2 units
template <bool kTF32>
__device__ __forceinline__ float exp_(float x) {
  if constexpr (kTF32) return expf(x);
  else return ex2_approx(x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- wgmma wrappers (m64nNk16 for bf16/f16, m64nNk8 for tf32; f32
// accumulators) ----

// SS, Q K^T: A and B K-major from shared memory (N = 64 keys; tf32 also 32).

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

// RS, P V: A (P) from registers, B (V) from shared memory, N = DP; 16-bit
// types read V N-major through the transpose bit, tf32 reads V^T K-major.

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

// ---- mha_tc_kernel: bf16/f16 at every D, f32 at D <= 128, on the tensor
// cores ----

// Shared-memory plan at padded head width DP. A K-major tile of R rows x
// DP columns is R/8 groups of kGroup bytes; row r, 16-byte chunk c at
// (r / 8) * kGroup + c * 128 + (r % 8) * 16. Q (a 64-row tile a warpgroup)
// | Q lo (f32) | kStages x (K, V or V^T, bias) | K lo, V^T lo (f32). WG
// warpgroups a CTA share the ring, each with its own 64 query rows. f32
// above DP = 128 (kSplitQ) keeps Q raw, with no Q lo: each k-step of S
// splits its A elements in registers (tf32_rs3_split); two warpgroups a
// CTA on 16-key tiles, 172,160 bytes at DP = 192, 229,504 at DP = 256.
template <typename T, int DP>
struct Plan {
  static constexpr bool kTF32 = std::is_same<T, float>::value;
  static constexpr bool kWide = !kTF32 && DP > 128;
  static constexpr bool kSplitQ = kTF32 && DP > 128;
  static constexpr int E = sizeof(T);
  static constexpr int WG = kWide || kSplitQ ? 2 : 1;
  static constexpr int kCtaThreads = WG * kThreads;
  // keys a tile
  static constexpr int BK = kSplitQ ? 16 : (kTF32 && DP >= 64) ? 32 : 64;
  static constexpr int kGroup = 8 * DP * E;                 // Q, K (V: 16-bit) row groups
  static constexpr int kQBytes = kRows * DP * E;
  static constexpr int kTileBytes = BK * DP * E;
  static constexpr int kStageBytes = 2 * kTileBytes + BK * 4;
  static constexpr int kQ = 0;
  static constexpr int kQlo = WG * kQBytes;
  static constexpr int kStage0 = kQlo + (kTF32 && !kSplitQ ? kQBytes : 0);
  static constexpr int kKlo = kStage0 + kStages * kStageBytes;
  static constexpr int kVlo = kKlo + kTileBytes;
  static constexpr int kBytes = kTF32 ? kVlo + kTileBytes : kKlo;
  static_assert(kTileBytes % 2048 == 0 && kQBytes % 2048 == 0, "split loop granularity");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// f32 above DP = 128: the tile's P V in chunks of this many columns, each
// in accumulators of its own (two of 32 registers a thread), so that P V's
// accumulators and O (DP/2) fit in a thread's 255 registers
constexpr int kPvCols = 64;
// k-steps a commit group of S = Q K^T where Q is split in registers
constexpr int kSplitSteps = 2;

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

// f32 V rows [k0, k0 + BK) transposed into V^T (DP d rows x BK keys,
// K-major for the P V product), one 4-byte copy an element. Within each
// group of 8 keys, K position kk holds key 2*kk (kk < 4) or 2*(kk-4) + 1:
// lane (dr, kc) of a warp copies keys 2*kc and 2*kc + 1 of column 8*cn + dr
// into the group's two core matrices (8 d rows x 4 keys). Keys >= S
// zero-filled, d >= D never written.
template <int DP, int BK>
__device__ __forceinline__ void load_vt(uint32_t dst, const float* src, long long HD, int k0,
                                        int S, int D, int tid) {
  constexpr int kDG = DP / 8;              // 8-column groups
  constexpr int kWd = kDG < 4 ? kDG : 4;   // warps across column groups
  constexpr int kWk = 4 / kWd;             // warps across key groups
  const int warp = tid / 32, lane = tid % 32, dr = lane % 8, kc = lane / 8;
  const int wd = warp % kWd, wk = warp / kWd;
#pragma unroll 1
  for (int cn = wd; cn < kDG; cn += kWd) {
    const int d = 8 * cn + dr;
    if (d >= D) break;
    int row = k0 + 8 * wk + 2 * kc;
    const float* from = src + (long long)row * HD + d;
    uint32_t at = dst + cn * (8 * BK * 4) + 2 * wk * 128 + dr * 16 + kc * 4;
#pragma unroll
    for (int n = 0; n < BK / 8 / kWk; ++n) {
      cp_async<4>(at, row < S ? from : src, row < S ? 4 : 0);
      cp_async<4>(at + 128, row + 1 < S ? from + HD : src, row + 1 < S ? 4 : 0);
      row += 8 * kWk;
      from += 8 * kWk * HD;
      at += 2 * kWk * 128;
    }
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

// n bytes of f32 at `at` split in place into hi = tf32(x), with lo =
// tf32(x - hi) at `lo`.
template <int N>
__device__ __forceinline__ void split_tf32(unsigned char* at, unsigned char* lo, int tid) {
#pragma unroll 4
  for (int off = 16 * tid; off < N; off += 16 * kThreads) {
    const float4 x = *reinterpret_cast<const float4*>(at + off);
    const uint32_t h0 = tf32_rna(x.x), h1 = tf32_rna(x.y), h2 = tf32_rna(x.z), h3 = tf32_rna(x.w);
    *reinterpret_cast<uint4*>(at + off) = make_uint4(h0, h1, h2, h3);
    *reinterpret_cast<uint4*>(lo + off) =
        make_uint4(tf32_rna(x.x - __uint_as_float(h0)), tf32_rna(x.y - __uint_as_float(h1)),
                   tf32_rna(x.z - __uint_as_float(h2)), tf32_rna(x.w - __uint_as_float(h3)));
  }
}

// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// warp w holds rows 16w..16w+15; with g = lane/4 and c = lane%4, element
// 4i+0/4i+1 is (row g, columns 8i+2c, 8i+2c+1) and 4i+2/4i+3 the same
// columns of row g+8.
template <typename T, int DP>
__global__ void __launch_bounds__(Plan<T, DP>::kCtaThreads)
mha_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ key_bias, T* __restrict__ out, int S, int H, int D,
              int gran, float scale) {
  using P = Plan<T, DP>;
  constexpr int BK = P::BK, WG = P::WG;
  constexpr bool kTF32 = P::kTF32;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // the warpgroup and its thread (compile-time 0 and tid with one warpgroup)
  const int tid = threadIdx.x, wg = WG > 1 ? tid / kThreads : 0;
  const int wtid = WG > 1 ? tid % kThreads : tid, warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;  // (b, row 0, head h)
  const float* brow = key_bias + (long long)b * S;
  const int ntiles = (S + BK - 1) / BK;
  // f32: one pass over the tiles (K and V); 16-bit: pass 1 (K), pass 2 (K, V)
  const int nsteps = kTF32 ? ntiles : 2 * ntiles;

  // zero the pad columns (and everything else) once
  for (int i = tid; i < P::kBytes / 16; i += P::kCtaThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // each warpgroup copies RW of a tile's rows, and its own query rows
  constexpr int RW = BK / WG;
  const uint32_t rows_at = wg * (RW / 8) * P::kGroup;
  auto load_step = [&](int u) {
    const uint32_t st = base + P::kStage0 + (u % kStages) * P::kStageBytes;
    const int k0 = (u >= ntiles ? u - ntiles : u) * BK;
    load_rows<T, DP, RW>(gran, st + rows_at, k + head, HD, k0 + wg * RW, S, D, wtid);
    if constexpr (kTF32 && WG > 1) {
      // each warpgroup transposes half of V's columns
      constexpr int H2 = DP / 2;
      load_vt<H2, BK>(st + P::kTileBytes + wg * (H2 / 8) * (8 * BK * 4), v + head + wg * H2, HD,
                      k0, S, D - wg * H2, wtid);
    } else if constexpr (kTF32) {
      load_vt<DP, BK>(st + P::kTileBytes, v + head, HD, k0, S, D, tid);
    } else {
      if (u >= ntiles)
        load_rows<T, DP, RW>(gran, st + P::kTileBytes + rows_at, v + head, HD, k0 + wg * RW, S,
                             D, wtid);
    }
    load_bias<BK>(st + 2 * P::kTileBytes, brow, k0, S, tid);
  };
  const uint32_t q_at = base + P::kQ + wg * P::kQBytes;
  load_rows<T, DP, kRows>(gran, q_at, q + head, HD, (qt * WG + wg) * kRows, S, D, wtid);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < nsteps) load_step(u);
    cp_async_commit();
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g+8

  for (int u = 0; u < nsteps; ++u) {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();  // step u's tile is in; every thread is done with step u - 1
    if (u + kStages - 1 < nsteps) load_step(u + kStages - 1);
    cp_async_commit();
    const int st_off = P::kStage0 + (u % kStages) * P::kStageBytes;
    const uint32_t kt = base + st_off, vt = kt + P::kTileBytes;
    const float* bt = reinterpret_cast<const float*>(smem + st_off + 2 * P::kTileBytes);
    if constexpr (kTF32) {
      if constexpr (WG > 1) {  // warpgroup 0 splits K, 1 V^T
        if (wg == 0) split_tf32<P::kTileBytes>(smem + st_off, smem + P::kKlo, wtid);
        else split_tf32<P::kTileBytes>(smem + st_off + P::kTileBytes, smem + P::kVlo, wtid);
      } else {
        if (!P::kSplitQ && u == 0) split_tf32<P::kQBytes>(smem + P::kQ, smem + P::kQlo, tid);
        split_tf32<P::kTileBytes>(smem + st_off, smem + P::kKlo, tid);
        split_tf32<P::kTileBytes>(smem + st_off + P::kTileBytes, smem + P::kVlo, tid);
      }
      fence_async_smem();
      __syncthreads();  // hi and lo of this tile are stored
    }

    // ---- S = Q K^T ----
    float s[BK / 2];
    wgmma_fence();
    if constexpr (P::kSplitQ) {
      // Q split a k-step at a time in registers; the same three products
      float s_lo[BK / 2];
      tf32_rs3_split<DP, kSplitSteps>(s, s_lo, smem + P::kQ + wg * P::kQBytes,
                                      smem_desc(kt, 128, P::kGroup),
                                      smem_desc(base + P::kKlo, 128, P::kGroup), tid);
      wgmma_wait_all();
      fence_regs(s_lo);
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += s_lo[i];
    } else if constexpr (kTF32) {
      // lo*hi and hi*lo in accumulators of their own, hi*hi in s; summed
      // after the wait
      float s_lo[BK / 2];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        wgmma_ss_tf32(s_lo, smem_desc(base + P::kQlo + 256 * j, 128, P::kGroup),
                      smem_desc(kt + 256 * j, 128, P::kGroup), j > 0);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        wgmma_ss_tf32(s_lo, smem_desc(base + P::kQ + 256 * j, 128, P::kGroup),
                      smem_desc(base + P::kKlo + 256 * j, 128, P::kGroup), 1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        wgmma_ss_tf32(s, smem_desc(base + P::kQ + 256 * j, 128, P::kGroup),
                      smem_desc(kt + 256 * j, 128, P::kGroup), j > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_lo);
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += s_lo[i];
    } else {
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        Mma<T>::qk(s, smem_desc(q_at + 256 * j, 128, P::kGroup),
                   smem_desc(kt + 256 * j, 128, P::kGroup), j > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
    }

    // ---- logits. f32: (q . k) * scale, then + bias, each rounded alone, as
    // the plain version; 16-bit: in log2 units, (q . k) * scale*log2(e) +
    // bias*log2(e) in one FMA, as mha_fwd.cu ----
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
      if constexpr (kTF32) {
        s[4 * i + 0] = __fadd_rn(__fmul_rn(s[4 * i + 0], scale), bb.x);
        s[4 * i + 1] = __fadd_rn(__fmul_rn(s[4 * i + 1], scale), bb.y);
        s[4 * i + 2] = __fadd_rn(__fmul_rn(s[4 * i + 2], scale), bb.x);
        s[4 * i + 3] = __fadd_rn(__fmul_rn(s[4 * i + 3], scale), bb.y);
      } else {
        const float b0 = bb.x * kLog2e, b1 = bb.y * kLog2e;
        s[4 * i + 0] = fmaf(s[4 * i + 0], scale, b0);
        s[4 * i + 1] = fmaf(s[4 * i + 1], scale, b1);
        s[4 * i + 2] = fmaf(s[4 * i + 2], scale, b0);
        s[4 * i + 3] = fmaf(s[4 * i + 3], scale, b1);
      }
    }

    const bool pass1 = !kTF32 && u < ntiles;
    if (kTF32 || pass1) {
      // running row max and sum; tile 0 holds key 0 (finite bias), so the
      // max is finite and exp(-inf - mx) = 0 clears the empty sums
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float a0 = exp_<kTF32>(m0 - mx0), a1 = exp_<kTF32>(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[4 * i + 0] = exp_<kTF32>(s[4 * i + 0] - m0);
        s[4 * i + 1] = exp_<kTF32>(s[4 * i + 1] - m0);
        s[4 * i + 2] = exp_<kTF32>(s[4 * i + 2] - m1);
        s[4 * i + 3] = exp_<kTF32>(s[4 * i + 3] - m1);
        l0 += s[4 * i + 0] + s[4 * i + 1];
        l1 += s[4 * i + 2] + s[4 * i + 3];
      }
      if constexpr (!kTF32) {
        if (u == ntiles - 1) {
          l0 = quad_sum(l0);
          l1 = quad_sum(l1);
        }
      } else {
        // ---- O = O * exp(m_old - m_new) + P V, 3xTF32 ----
        // k-step j's A registers: (row g, K c), (g+8, c), (g, c+4), (g+8,
        // c+4), i.e. keys 8j+2c and 8j+2c+1 (V^T's key order)
        uint32_t ph[BK / 2], pl[BK / 2];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float x[4] = {s[4 * j + 0], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ph[4 * j + e] = tf32_rna(x[e]);
            pl[4 * j + e] = tf32_rna(x[e] - __uint_as_float(ph[4 * j + e]));
          }
        }
        // the tile's P V in accumulators of its own (pv_lo: lo*hi and
        // hi*lo, pv: hi*hi), summed after the wait and added to O by FMA;
        // V^T's 8-column groups are 8 * BK * 4 bytes apart. Above DP = 128
        // in chunks of kPvCols columns (a chunk's 8 groups further on in
        // V^T and V^T lo; its accumulators are O's elements [NP*ch, NP*ch +
        // NP)), each chunk added to O before the next is issued.
        constexpr int kVtGroup = 8 * BK * 4;
        constexpr int NCOL = DP > 128 ? kPvCols : DP, NP = NCOL / 2;
        fence_regs(ph);
        fence_regs(pl);
#pragma unroll
        for (int ch = 0; ch < DP / NCOL; ++ch) {
          const uint32_t vc = vt + ch * NCOL * BK * 4, vlc = base + P::kVlo + ch * NCOL * BK * 4;
          float pv[NP], pv_lo[NP];
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const uint32_t a[4] = {pl[4 * j], pl[4 * j + 1], pl[4 * j + 2], pl[4 * j + 3]};
            wgmma_rs_tf32(pv_lo, a, smem_desc(vc + 256 * j, 128, kVtGroup), j > 0);
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const uint32_t a[4] = {ph[4 * j], ph[4 * j + 1], ph[4 * j + 2], ph[4 * j + 3]};
            wgmma_rs_tf32(pv_lo, a, smem_desc(vlc + 256 * j, 128, kVtGroup));
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const uint32_t a[4] = {ph[4 * j], ph[4 * j + 1], ph[4 * j + 2], ph[4 * j + 3]};
            wgmma_rs_tf32(pv, a, smem_desc(vc + 256 * j, 128, kVtGroup), j > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(pv_lo);
          fence_regs(pv);
#pragma unroll
          for (int i = 0; i < NP / 4; ++i) {
            const int at = NP * ch + 4 * i;
            o[at + 0] = fmaf(o[at + 0], a0, pv[4 * i + 0] + pv_lo[4 * i + 0]);
            o[at + 1] = fmaf(o[at + 1], a0, pv[4 * i + 1] + pv_lo[4 * i + 1]);
            o[at + 2] = fmaf(o[at + 2], a1, pv[4 * i + 2] + pv_lo[4 * i + 2]);
            o[at + 3] = fmaf(o[at + 3], a1, pv[4 * i + 3] + pv_lo[4 * i + 3]);
          }
        }
      }
    } else {
      if constexpr (!kTF32) {
        // ---- pass 2: P = 2^(s - m) / l rounded to T; O += P V ----
        uint32_t p[BK / 4];
        const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          p[2 * i] = Mma<T>::pack(exp_<kTF32>(s[4 * i + 0] - m0) * i0,
                                  exp_<kTF32>(s[4 * i + 1] - m0) * i0);
          p[2 * i + 1] = Mma<T>::pack(exp_<kTF32>(s[4 * i + 2] - m1) * i1,
                                      exp_<kTF32>(s[4 * i + 3] - m1) * i1);
        }
        // BK/16 k-steps of 16 keys; V N-major (transpose bit): LBO steps 8
        // keys, SBO 8 columns
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const uint32_t a[4] = {p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]};
          pv_wide<T>(o, a, smem_desc(vt + 2 * j * P::kGroup, P::kGroup, 128));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
    }
  }

  // ---- out = O (f32: / l), rows >= S and columns >= D not stored ----
  if constexpr (kTF32) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }
  const int r0 = (qt * WG + wg) * kRows + warp * 16 + g, r1 = r0 + 8;
  T* ob = out + head;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * i + 2 * c + e;
      if (d >= D) continue;
      float x0 = o[4 * i + e], x1 = o[4 * i + 2 + e];
      if constexpr (kTF32) {
        x0 = __fdiv_rn(x0, l0);
        x1 = __fdiv_rn(x1, l1);
      }
      if (r0 < S) ob[r0 * HD + d] = from_f32<T>(x0);
      if (r1 < S) ob[r1 * HD + d] = from_f32<T>(x1);
    }
}

// the padded head width of the instance the last launch ran (host side;
// read by rrt_mha_generic_last_dp)
int g_last_dp = 0;

template <typename T, int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* bias, void* out,
                      int B, int S, int H, int D, int gran, cudaStream_t stream) {
  constexpr int smem = Plan<T, DP>::kBytes;
  auto kern = mha_tc_kernel<T, DP>;
  if (smem > 48 * 1024) {
    // set on every call: the opt-in belongs to the current device
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int rows = Plan<T, DP>::WG * kRows;  // query rows a CTA
  const dim3 grid((S + rows - 1) / rows, H, B);
  // f32: the plain version's f32 1/sqrt(d); 16-bit: log2(e)/sqrt(d)
  const float scale = (std::is_same<T, float>::value ? 1.0f : kLog2e) / sqrtf((float)D);
  kern<<<grid, Plan<T, DP>::kCtaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), S, H, D, gran, scale);
  g_last_dp = DP;
  return cudaGetLastError();
}

// The widest copy granule (16, 8, 4 or 2 bytes) that every row of q, k and
// v starts on: their addresses and the head's byte width D * itemsize
// (which divides the head offset h * D and the row stride H * D).
int granule(const void* q, const void* k, const void* v, int row_bytes) {
  const uintptr_t a = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)row_bytes | 16u;
  return (int)(a & (~a + 1));
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const float* bias, void* out,
                       int B, int S, int H, int D, cudaStream_t stream) {
  const int gran = granule(q, k, v, D * (int)sizeof(T));
  if (D <= 16) return launch_tc<T, 16>(q, k, v, bias, out, B, S, H, D, gran, stream);
  if (D <= 32) return launch_tc<T, 32>(q, k, v, bias, out, B, S, H, D, gran, stream);
  if (D <= 64) return launch_tc<T, 64>(q, k, v, bias, out, B, S, H, D, gran, stream);
  if (D <= 128) return launch_tc<T, 128>(q, k, v, bias, out, B, S, H, D, gran, stream);
  if (D <= 192) return launch_tc<T, 192>(q, k, v, bias, out, B, S, H, D, gran, stream);
  return launch_tc<T, 256>(q, k, v, bias, out, B, S, H, D, gran, stream);
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

// The padded head width DP of the mha_tc_kernel instance (T, DP) that the
// last rrt_mha_generic call launched (0 before any): every dtype and D runs
// on the tensor cores, f32 as 3xTF32.
extern "C" int rrt_mha_generic_last_dp() { return g_last_dp; }
