// Fused multi-head attention forward for the BERT towers, for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the TPU kernel review_recommender_tpu/ops/pallas/attention_kernel.py
// (_mha_kernel, reached through mha_pallas). For each (batch, head) it computes
//   softmax(Q K^T * 1/sqrt(d) + key_bias) V
// with q, k, v and out (B, S, H*D) row-major, as the Linear layers write them,
// read in place (no transpose), and key_bias (B, S) f32 (0 keep, -1e30 drop).
//
// Design. One CTA of one warpgroup (128 threads) takes 64 query rows of one
// (b, h) and walks the keys in tiles of 64:
//   - TMA brings the Q tile once and each K/V tile into a 2-stage ring in
//     shared memory; an mbarrier per stage reports the bytes. The tensor maps
//     are 3-D over (B, S, H*D) with a box of (1, 64, min(D, 64)) at column
//     h*D, so rows from S to the tile edge arrive zero-filled and never come
//     from the next batch. A row of the box is 64 bytes at D=32 (64B swizzle)
//     and 128 bytes at D=64 and D=128 (128B swizzle; D=128 is two boxes);
//     the wgmma descriptors name the same swizzle.
//   - S = Q K^T: wgmma m64n64k16, Q and K both K-major from shared memory,
//     f32 accumulators in registers.
//   - Softmax in two passes over the key tiles, so that each probability is
//     rounded as the plain version rounds it. Pass 1 computes S for every
//     tile and keeps a running row max and row sum in f32 (the sum rescaled
//     by exp2(m_old - m_new) when the max moves). Pass 2 computes S again
//     and P = exp2(s - m) / l, the exact probabilities in f32, rounded to
//     the input type only then. Logits are taken in log2 units (scale and
//     bias times log2(e), then ex2.approx), which moves some roundings by
//     an ulp of f32; the division is a multiply by 1/l.
//   - O += P V (pass 2): P straight from the S accumulators (their layout
//     is wgmma's A-register layout); V is the B operand from shared
//     memory, read with the transpose bit since V is (keys, D) row-major.
//     wgmma m64nDk16. O needs no rescale and no final division.
//   - The ring streams 2 x ntiles steps: K alone for pass 1, then K and V
//     for pass 2.
//   - The key bias (in log2 units) comes from shared memory. Up to
//     kMaxRow = 512 keys the whole row is stored once, before the first
//     step. Longer rows (the TPU kernel takes any length) take the kRing
//     instance: a second ring of the K/V ring's depth holds each step's
//     64 biases, stored by threads 0-63 from global memory two steps
//     ahead, at the end of a step, so shared memory does not grow with S.
//     The ring alone would serve every S, but at S <= 512 it cost 7-17% in
//     A/Bs on an H100 (the loop's registers and scheduling), so those
//     shapes keep the whole row.
//
// Rounding against the TPU kernel and the plain version (mha_reference):
// both divide the exponentials by the f32 row sum and round the
// probabilities to the input type before P V, as this kernel does; what
// differs is the order of the f32 sums and ex2.approx against expf, so a
// probability differs only where its f32 value lies within an ulp or two of
// a rounding boundary of the input type. (The single-pass design before
// rounded the exponentials before the division: up to one ulp of the input
// type on every probability, which the towers' scores carried through.)
//
// Semantics kept from the first kernel:
//   - an all-masked row (the batch-bucket padding row, every bias -1e30)
//     comes out uniform over the S real keys: (q.k)*scale - 1e30 == -1e30
//     in f32 (also in log2 units), so its logits are all equal;
//   - keys from S to the tile edge get logit -inf (probability exactly 0)
//     and zero-filled V rows, never -1e30, so such a row never spreads its
//     weight over the padding;
//   - query rows >= S are not stored.
//
// What bounds it, at the cross-encoder's rerank shape (B=64, S=512, H=12,
// D=32), on an H100 SXM:
//   tensor cores  4*B*H*S*S*D = 25.8 GFLOP at 989 TFLOP/s          26 us
//   HBM           q, k, v and out once each, 100.7 MB at 3.35 TB/s  30 us
//   exponentials  B*H*S*S = 201 M at the MUFU rate of 16 per SM per
//                 clock, 132 x 16 x 1.98 GHz = 4.2 T/s               48 us
// At D=32 the exponential rate is the highest floor, not the tensor cores;
// the two passes take each exponential twice (96 us) and Q K^T twice.
// Several 128-thread CTAs are resident on an SM (~24 KB of shared memory at
// D=32), so one CTA's softmax overlaps another's wgmma and TMA.
//
// The kernel allocates nothing and does not synchronise; it launches on the
// stream it is given and the C entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows per CTA: wgmma's M
constexpr int kKeys = 64;      // keys per K/V tile: N of Q K^T
constexpr int kStages = 2;     // K/V ring
constexpr int kMaxRow = 512;  // longest key row kept whole in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry at head dim D: a tile (64 rows, D columns) is
// kBoxes boxes of 64 rows x kBoxCols columns, each a swizzle atom column.
// kRing: the bias ring (S > kMaxRow) instead of the whole row.
template <int D, bool kRing>
struct Geo {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;  // 64 or 128
  static constexpr int kBoxBytes = 64 * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // 64 x D x 2
  static constexpr int kKStepsPerBox = kBoxCols / 16;    // k16 steps in one box
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: B128 = 1, B64 = 2
  static constexpr int kBiasFloats = kRing ? kStages * kKeys : kMaxRow;
  // Q, the K ring, the V ring, the bias row or ring, 3 mbarriers, and
  // slack to align the tiles to 1024 bytes (the 128B swizzle's period)
  static constexpr int kSmemBytes =
      (1 + 2 * kStages) * kTileBytes + kBiasFloats * 4 + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box from a 3-D tensor map (column, row, batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units), layout type in bits 62-63.
template <uint64_t kLayout>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (kLayout << 62);
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

__device__ __forceinline__ float ex2(float x) {
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

// ---- wgmma wrappers (m64nNk16, f32 accumulators) ----
// SS: A and B K-major from shared memory. RS: A from registers, B from
// shared memory with the transpose bit (N-major).

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
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

__device__ __forceinline__ void wgmma_ss_f16(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
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

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
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
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
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

// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// warp w holds rows 16w..16w+15; with g = lane/4 and c = lane%4, element
// 4i+0/4i+1 is (row g, columns 8i+2c, 8i+2c+1) and 4i+2/4i+3 the same
// columns of row g+8. Two neighbouring 8-column blocks, packed to pairs of
// the input type, are the A registers of one k16 step of the next wgmma.
template <typename T, int D, bool kRing>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : 4)
mha_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ key_bias,
               T* __restrict__ out, int S, int H, float scale_log2) {
  using G = Geo<D, kRing>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = base + G::kTileBytes;               // stage s at + s * kTileBytes
  const uint32_t sV = sK + kStages * G::kTileBytes;
  float* bias_s = reinterpret_cast<float*>(gbase + (1 + 2 * kStages) * G::kTileBytes);
  const uint32_t bar_q = smem_u32(bias_s + G::kBiasFloats);  // then one per stage, 8 bytes each
  const uint32_t bar_kv = bar_q + 8;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int ntiles = (S + kKeys - 1) / kKeys;
  const int col = h * D;

  // step u < ntiles: pass 1 over tile u (K only); u >= ntiles: pass 2 over
  // tile u - ntiles (K and V)
  auto load_step = [&](int stage, int u) {
    const uint32_t bar = bar_kv + 8 * stage;
    const bool with_v = u >= ntiles;
    const int tile = with_v ? u - ntiles : u;
    mbar_expect_tx(bar, (with_v ? 2 : 1) * G::kTileBytes);
#pragma unroll
    for (int x = 0; x < G::kBoxes; ++x) {
      const uint32_t off = stage * G::kTileBytes + x * G::kBoxBytes;
      tma_load(sK + off, &tm_k, bar, col + x * G::kBoxCols, tile * kKeys, b);
      if (with_v) tma_load(sV + off, &tm_v, bar, col + x * G::kBoxCols, tile * kKeys, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the bias in log2 units; keys from S to the tile edge get -inf
  if constexpr (kRing) {
    // steps 0 .. kStages-1 read tiles 0 .. kStages-1 (S > kMaxRow: ntiles
    // > kStages); one key a thread (kKeys <= kThreads)
    for (int u = 0; u < kStages; ++u) {
      const int j = u * kKeys + tid;
      if (tid < kKeys) bias_s[u * kKeys + tid] = key_bias[(long)b * S + j] * kLog2e;
    }
  } else {
    for (int j = tid; j < ntiles * kKeys; j += kThreads)
      bias_s[j] = j < S ? key_bias[(long)b * S + j] * kLog2e : -INFINITY;
  }
  __syncthreads();

  const int nsteps = 2 * ntiles;
  if (tid == 0) {
    mbar_expect_tx(bar_q, G::kTileBytes);
#pragma unroll
    for (int x = 0; x < G::kBoxes; ++x)
      tma_load(sQ + x * G::kBoxBytes, &tm_q, bar_q, col + x * G::kBoxCols, qt * kRows, b);
    for (int u = 0; u < kStages && u < nsteps; ++u) load_step(u, u);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g+8
  float inv0 = 0.f, inv1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int u = 0; u < nsteps; ++u) {
    const int st = u % kStages;
    const bool pass2 = u >= ntiles;
    const int t = pass2 ? u - ntiles : u;
    mbar_wait(bar_kv + 8 * st, (u / kStages) & 1);
    const uint32_t k_tile = sK + st * G::kTileBytes, v_tile = sV + st * G::kTileBytes;

    // ---- S = Q K^T, K-major operands, D/16 k-steps ----
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const uint32_t off = (j / G::kKStepsPerBox) * G::kBoxBytes + (j % G::kKStepsPerBox) * 32;
      Mma<T>::qk(s, smem_desc<G::kLayout>(sQ + off, 16, 8 * G::kRowBytes),
                 smem_desc<G::kLayout>(k_tile + off, 16, 8 * G::kRowBytes), j > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // ---- logits in log2 units ----
    const float* bt = bias_s + (kRing ? st : t) * kKeys;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
      s[4 * i + 0] = fmaf(s[4 * i + 0], scale_log2, bb.x);
      s[4 * i + 1] = fmaf(s[4 * i + 1], scale_log2, bb.y);
      s[4 * i + 2] = fmaf(s[4 * i + 2], scale_log2, bb.x);
      s[4 * i + 3] = fmaf(s[4 * i + 3], scale_log2, bb.y);
    }

    if (!pass2) {
      // ---- pass 1: running row max and row sum ----
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      // the first tile always holds key 0 (finite bias), so mx is finite
      // and exp2(-inf - mx) = 0 clears the empty sums
      l0 *= ex2(m0 - mx0);
      l1 *= ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        l0 += ex2(s[4 * i + 0] - m0) + ex2(s[4 * i + 1] - m0);
        l1 += ex2(s[4 * i + 2] - m1) + ex2(s[4 * i + 3] - m1);
      }
      if (u == ntiles - 1) {
        inv0 = 1.f / quad_sum(l0);
        inv1 = 1.f / quad_sum(l1);
      }
    } else {
      // ---- pass 2: P = exp2(s - m) / l, rounded; O += P V ----
      uint32_t p[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[2 * i] = Mma<T>::pack(ex2(s[4 * i + 0] - m0) * inv0, ex2(s[4 * i + 1] - m0) * inv0);
        p[2 * i + 1] =
            Mma<T>::pack(ex2(s[4 * i + 2] - m1) * inv1, ex2(s[4 * i + 3] - m1) * inv1);
      }
      // four k16 steps of 16 keys, V N-major
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        const uint32_t a[4] = {p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]};
        Mma<T>::pv(o, a, smem_desc<G::kLayout>(v_tile + j * 16 * G::kRowBytes, G::kBoxBytes,
                                               8 * G::kRowBytes));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && u + kStages < nsteps) load_step(st, u + kStages);
    if constexpr (kRing) {
      // step u + kStages's tile bias, read after the barrier that ends
      // step u + 1
      const int v = u + kStages, j = (v >= ntiles ? v - ntiles : v) * kKeys + tid;
      if (tid < kKeys && v < nsteps)
        bias_s[st * kKeys + tid] = j < S ? key_bias[(long)b * S + j] * kLog2e : -INFINITY;
    }
  }

  // ---- out = O (already normalised), rows >= S not stored ----
  const long HD = (long)H * D;
  const int r0 = qt * kRows + warp * 16 + g, r1 = r0 + 8;
  T* ob = out + (long)b * S * HD + col + 2 * c;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * HD + 8 * i) =
          Mma<T>::pack(o[4 * i + 0], o[4 * i + 1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * HD + 8 * i) =
          Mma<T>::pack(o[4 * i + 2], o[4 * i + 3]);
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled (CUDA 12.0 ABI), looked up through the runtime, so
// that the library does not link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a (B, S, H*D) tensor: innermost H*D columns, then S rows,
// then B; box (kBoxCols, 64, 1) with the swizzle of a kRowBytes row.
template <typename T, int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H) {
  using G = Geo<D, false>;  // the box does not depend on the bias layout
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * sizeof(T), (cuuint64_t)S * H * D * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)G::kBoxCols, 64u, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle swz =
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, Mma<T>::kMapType, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int S, int H, cudaStream_t stream) {
  auto kern = mha_fwd_kernel<T, D, kRing>;
  constexpr int smem = Geo<D, kRing>::kSmemBytes;
  static bool smem_set = false;  // the opt-in is per kernel instance, not per call
  if (smem > 48 * 1024 && !smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap mq, mk, mv;
  if (!make_map<T, D>(&mq, q, B, S, H) || !make_map<T, D>(&mk, k, B, S, H) ||
      !make_map<T, D>(&mv, v, B, S, H))
    return cudaErrorInvalidValue;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, bias, static_cast<T*>(out), S, H, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_s(const void* q, const void* k, const void* v, const float* bias, void* out,
                       int B, int S, int H, cudaStream_t stream) {
  return S <= kMaxRow ? launch<T, D, false>(q, k, v, bias, out, B, S, H, stream)
                      : launch<T, D, true>(q, k, v, bias, out, B, S, H, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const float* bias, void* out,
                       int B, int S, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_s<T, 32>(q, k, v, bias, out, B, S, H, stream);
    case 64: return dispatch_s<T, 64>(q, k, v, bias, out, B, S, H, stream);
    case 128: return dispatch_s<T, 128>(q, k, v, bias, out, B, S, H, stream);
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
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(key_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<__nv_bfloat16>(q, k, v, bias, out, B, S, H, D, st);
    case 1: return (int)dispatch_d<__half>(q, k, v, bias, out, B, S, H, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
