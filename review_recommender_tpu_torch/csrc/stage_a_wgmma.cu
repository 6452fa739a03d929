// Fused stage A for Hopper (sm_90a) on the tensor cores: dense scores of
// one 2048-row corpus tile for a batch of queries, and each query's 16 best
// rows of the tile, in one pass. One kernel template takes a bf16 corpus
// (rrt_stage_a_wgmma) and an f32 one (rrt_stage_a_tf32, the products as
// 3xTF32), at any D >= 1.
//
// Replaces _stage_a_kernel of review_recommender_tpu/ops/pallas/
// stage_a_kernel.py (reached through stage_a_fused_pallas). For each
// 2048-row tile t and query b:
//   score[r] = f32 sum over k of emb[r][k] * q_b[k] (q_b rounded to bf16
//              first for a bf16 corpus; bf16 products are exact in f32);
//   rows where valid[r] == 0 or r >= n score -3.4e38f and never win;
//   16 rounds: (the largest remaining score, the lowest local index among
//              equal ones), then that row is out;
//   out_s[t][m][b], out_i[t][m][b] = round m's score and local index.
// When fewer than 16 rows of the tile are valid, round m >= that count
// returns (-3.4e38f, 0), as the TPU kernel's rounds do (every score left is
// -3.4e38f, and row 0 is the lowest index holding it).
//
// What bounds it: reading the corpus once, N * D * itemsize bytes over 3.35
// TB/s of HBM: at N = 200,704, D = 384 0.0459 ms in bf16 and 0.0920 ms in
// f32, at D = 3,072 in f32 0.735 ms. The products, 2 * N * D * B, at the
// 989 TFLOP/s of the bf16 tensor cores or the f32-exact rate of 3xTF32, 495
// / 3 TFLOP/s, stay under the bytes up to B of about 32 in f32 (at B = 128
// they bound it: 0.120 ms at D = 384, 0.96 ms at D = 3,072). The port's
// first design was CUDA-core FMAs, a corpus read per group of 8 queries:
// 5.151 ms at D = 3,072, B = 32, slower than its plain version (PERF.md).
//
// Design, one CTA of 416 threads per (tile, chunk of NC queries), the warps
// specialised (examples/torch_stage_a_breakdown.py times its parts on the
// card; PERF.md has the numbers):
//   - Queries. A chunk is the smallest NC that holds B (bf16 16, 32, 64 or
//     128; f32 8, 16 or 32, for registers), zero past B and past D; a wider
//     batch is more chunks, each reading the tile again. A first kernel
//     (stage_a_query_boxes) writes every chunk's queries to a workspace
//     once a call, box by box, in the layout wgmma reads its B operand from
//     (N = query, K = the embedding dim, 128-byte rows, 128-byte swizzle):
//     in bf16 rounded to bf16, in f32 split (below). Each ring stage
//     carries the chunk's query box (NC x 128 bytes, f32 2 NC) beside the
//     corpus box it multiplies, one bulk copy from L2 beside the box's
//     load. Shared memory then holds the ring, the lists and the score
//     buffers whatever D is, so every chunk fits at every D, and a tile is
//     read once for 32 f32 or 128 bf16 queries. The main kernel is a
//     programmatic dependent launch: its CTAs set up while the first
//     kernel runs, and the producer waits for that kernel's writes before
//     its first load. (The port's first layout kept the chunk's queries in
//     shared memory for the whole D: past 2,912 f32 columns only chunks of
//     8 fit, past 4,096 bf16 columns none; PERF.md has the A/B of the two
//     at D = 384.)
//   - Corpus (a producer warp). The tile streams through a ring of 8 KB
//     boxes (64 rows x one 128-byte swizzled row: 64 bf16 or 32 f32
//     columns) and their query boxes, as many stages as shared memory
//     leaves (ring_stages: 20, 14, 9 and 5 at bf16 NC = 16 to 128; 21, 16
//     and 11 at f32 NC = 8 to 32), each completed on an mbarrier. TMA loads each box
//     where the rows start on 16 bytes (D * itemsize a multiple of 16) and
//     zero-fills rows past N and columns past D. Other widths (bf16 D = 60:
//     120-byte rows) cannot be described to TMA; there the producer's 32
//     lanes copy the box by cp.async in the widest granule the rows allow
//     (8 or 4 bytes; 2 by loads and stores), into the same swizzled layout,
//     zeros past N and D, kCopyDepth = 3 boxes in flight a lane; each lane
//     fences its copies for the async proxy and arrives on a box once its
//     copies of it are done, which is after it has issued the copies of the
//     third box on. The MMA warpgroup frees box t - 1 only once box t is
//     full, so the ring needs kCopyDepth + 2 stages (static_assert in
//     launch). No copy of the corpus is made.
//   - Products, bf16 (one MMA warpgroup). wgmma m64nNCk16 (A = a slab of 64
//     corpus rows, B = the queries, both K-major from shared memory, f32
//     accumulators in registers), 4 k-steps per box; each box goes back to
//     the producer once the wgmma that read it is done. A wgmma costs ~80
//     cycles whatever N is (8 to 64), so the whole chunk is one N: the 24
//     wgmmas of a slab at D = 384 take ~1.1 us, under the ~1.4 us its bytes
//     take at the bound.
//   - Products, f32 (3xTF32). A product is hi*q_hi + hi*q_lo + lo*q_hi (the
//     lo*lo term, under 2^-20 of the product, is dropped), 4 k-steps of wgmma
//     m64nNk8 a box. The queries are split once, q_hi = tf32(q) and q_lo =
//     tf32(q - q_hi) (cvt.rna): each box holds the chunk's NC hi rows, then
//     its NC lo rows. The corpus is not split in shared memory: the tensor
//     cores read the box's f32 values as TF32 by their top 10 mantissa bits, so
//     hi = trunc(x) costs nothing, and one wgmma with A = the box (shared
//     memory) and N = 2 NC takes hi*q_hi and hi*q_lo. lo = x - trunc(x) (exact
//     in f32; the tensor cores read its top 10 bits too, which costs at most
//     2^-20 |x|) is formed in registers and feeds a wgmma with A from registers
//     (the RS form) and N = NC: lo*q_hi. Each MMA thread loads its two rows (g,
//     g + 8) of the box, columns 8kk + c and 8kk + c + 4 for k-step kk (4-byte
//     loads, no bank conflict); the next box's lo is formed while a box's
//     products run, and a box goes back to the producer once they are done. (On
//     the card, trunc matches the hardware's reading: rounding there would
//     leave single-TF32 errors, above 1e-5 at D = 384, and the tile pass's
//     largest error is 4.9e-7.) The tensor cores truncate each sum they add, so
//     the small terms have accumulators of their own, apart from hi*q_hi (in
//     the attention kernel, one accumulator for the three terms moved an f32
//     search's scores by 1.1e-4). The first f32 design split hi and lo in registers and fed
//     both as A (two RS wgmmas a k-step): 0.213 ms at B = 32 against 0.150
//     for this one (PERF.md). The chunks of a tile are neighbours in the
//     grid (blockIdx.x), so they run side by side and all but one read the
//     tile from L2.
//   - Scores. Each slab's scores go to a score buffer in shared memory
//     (query-major, 64 rows; two buffers where they fit, else one), NaN on
//     invalid rows (no compare passes NaN), -0 made +0 (so that the key
//     order below is the float order of the plain version).
//   - Selection without rescans (8 selection warps; warp w owns queries w,
//     w + 8, ...). Each query keeps a threshold (-inf at first) and a count
//     in the warp's registers, and a list of candidate keys in shared
//     memory: order-preserving score bits << 32 | ~row, so one u64 compare
//     is (score desc, row asc). The warp reads its queries' 64 scores of
//     the slab (rows lane and lane + 32), hands the buffer back, and appends
//     the values >= the threshold with a ballot: no atomics, no block-wide
//     barrier. A list that could not take another 32 is pruned: t = the 16th
//     largest of the 32 lanes' maxima (a bitonic sort of 32 keys); at least
//     16 keys are >= t, so none below it is among the 16 best; the rest is
//     dropped (about 20 keys stay) and the threshold rises to t's score. In
//     random order about 16 ln(2048 / 16) ~ 80 rows of a tile pass per
//     query, most in its first slabs. At the end of the tile the warp prunes
//     once more, sorts what is left (32 or 64 keys) and writes 16 rounds.
//     Lists hold 128 keys up to NC = 32, 64 at NC = 64 and 128, where the
//     query boxes take 8-16 KB a stage.
//   - Ties. A value equal to the threshold passes (>=), so a row that ties
//     the 16th best with a lower index always reaches the sort, which
//     decides by the full key: the result does not depend on the order in
//     which rows arrive. 17 or more copies of the best row give the 16
//     lowest indices.
// One tile per CTA: at N = 200,704 that is 98 CTAs on 132 SMs. Designs
// that were measured and replaced: one warpgroup doing products and
// selection in turn (the selection's latency in series with the wgmmas),
// two warpgroups splitting the queries (twice the wgmmas a slab), and the
// queries resident in shared memory (above), which for wide f32 corpora
// meant chunks narrowed to 8 queries (D <= 2,912) and the CUDA-core kernel
// beyond.

// The kernel allocates nothing and does not synchronise; it launches on the
// stream it is given and the C entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kTileN = 2048;
constexpr int kRounds = 16;   // M_PER_TILE
constexpr int kSlab = 64;     // corpus rows per wgmma: its M
constexpr int kSlabs = kTileN / kSlab;
constexpr int kBoxBytes = kSlab * 128;  // 8 KB: one 128-byte swizzled row a corpus row
constexpr int kSelWarps = 8;                         // selection warps
constexpr int kConsumers = 128 + 32 * kSelWarps;     // the MMA warpgroup + them
constexpr int kThreads = kConsumers + 32;            // + the producer warp
// Floats a query's 64 slab scores take: 68 spreads the MMA warps' stores
// over all 32 banks; 66 (2-way conflicts) lets one buffer fit at 128 queries.
__host__ __device__ constexpr int pitch(int nc) { return nc == 128 ? 66 : 68; }
constexpr int kHalf = 32;  // rows of a slab a half adds per query at most
constexpr int kMaxStages = 24;
constexpr int kCopyDepth = 3;  // boxes of copies a producer lane keeps in flight
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may take
constexpr float kNeg = -3.4e38f;

// What the corpus type decides: the columns of a box (one 128-byte row),
// the copies of the queries (f32: hi and lo), the narrowest and the widest
// chunk (f32: 8, and 32, for registers) and the TMA element type.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kBoxCols = 64, kCopies = 1, kMinChunk = 16, kMaxChunk = 128;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<float> {
  static constexpr int kBoxCols = 32, kCopies = 2, kMinChunk = 8, kMaxChunk = 32;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// Keys a query's candidate list holds: 128 (4 a lane) up to 32 queries a
// chunk, 64 (2 a lane) from 64.
__host__ __device__ constexpr int list_cap(int nc) { return nc <= 32 ? 128 : 64; }

// A ring stage: the corpus box and the chunk's query rows of the same 32
// or 64 columns (copies * nc rows x 128 bytes).
__host__ __device__ constexpr int stage_bytes(int nc, int copies) {
  return kBoxBytes + copies * nc * 128;
}

// Shared memory (from a 1024-byte aligned base): the ring, the candidate
// lists, nbuf slab score buffers (nc x pitch(nc) floats), then a full and
// an empty mbarrier per stage and per score buffer; 1024 bytes of slack to
// align the base.
__host__ __device__ constexpr int smem_bytes(int nc, int stages, int nbuf, int copies) {
  return 1024 + stages * stage_bytes(nc, copies) + nc * list_cap(nc) * 8 +
         nbuf * nc * pitch(nc) * 4 + stages * 16 + 32;
}

// Score buffers: 2 where they fit beside 8 ring stages, else 1; then as
// many ring stages as the rest of shared memory holds, up to kMaxStages.
__host__ __device__ constexpr int score_buffers(int nc, int copies) {
  return smem_bytes(nc, 8, 2, copies) <= kMaxSmem ? 2 : 1;
}
__host__ __device__ constexpr int ring_stages(int nc, int copies) {
  const int fit = (kMaxSmem - smem_bytes(nc, 0, score_buffers(nc, copies), copies)) /
                  (stage_bytes(nc, copies) + 16);
  return fit < kMaxStages ? fit : kMaxStages;
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// `bytes` (a multiple of 16) from global memory, 16-byte aligned, into
// shared memory, completed on an mbarrier (a bulk copy, no tensor map).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// G bytes (8 or 4) from global to shared memory by cp.async; in == false
// writes G zero bytes and reads nothing.
template <int G>
__device__ __forceinline__ void copy_granule(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(G),
               "r"(in ? G : 0)
               : "memory");
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

// One TMA box of a 2-D tensor map (column, row) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzled
// rows: start address, leading byte offset 16, stride byte offset 1024 (8
// rows), layout type 1 (128B swizzle); 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// wgmma m64nNk16, bf16 inputs, f32 accumulators; A and B K-major from
// shared memory; scale_d = 0 starts the sum.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// Two floats to a bf16 pair, rounded to nearest even (torch's .to(bfloat16)),
// x in the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---- candidate keys: one u64 compare orders (score desc, local row asc) ----
__device__ __forceinline__ uint64_t make_key(float s, int row) {
  const uint32_t u = __float_as_uint(s);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)o << 32) | (uint32_t)(0xFFFFFFFFu - (uint32_t)row);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t o = (uint32_t)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ int key_row(uint64_t key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int m) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)v, m);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(v >> 32), m);
  return ((uint64_t)hi << 32) | lo;
}

// Bitonic sort of G independent sets of 32 keys, one key of each a lane,
// into descending order (lane l ends with rank l of each set); the G
// chains of shuffles are independent, so they overlap.
template <int G>
__device__ __forceinline__ void sort32_desc(uint64_t (&x)[G]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      // the lower lane of a pair keeps the larger key in a descending block
      // ((lane & k) == 0), the upper one in an ascending block
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const uint64_t p = shfl_xor64(x[q], j);
        x[q] = keep_max == (x[q] > p) ? x[q] : p;
      }
    }
  }
}

// The same for 64 keys, element `lane` in a and `lane + 32` in b.
__device__ __forceinline__ void sort64_desc(uint64_t& a, uint64_t& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // partners in one lane; k == 64, a descending block
        const uint64_t hi = a > b ? a : b, lo = a > b ? b : a;
        a = hi;
        b = lo;
      } else {
        const uint64_t pa = shfl_xor64(a, j), pb = shfl_xor64(b, j);
        const int eb = lane + 32;
        const bool ka = ((lane & j) == 0) == ((lane & k) == 0);
        const bool kb = ((eb & j) == 0) == ((eb & k) == 0);
        a = ka == (a > pa) ? a : pa;
        b = kb == (b > pb) ? b : pb;
      }
    }
  }
}

// The main kernel launches while stage_a_query_boxes runs (a programmatic
// dependent launch, launch()): the first kernel lets it in at its start,
// and the main kernel's producer waits here, before its first read of the
// query boxes, for that grid to complete and its writes to be visible.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Named barrier 1: every thread but the producer's.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Prune G queries' lists across their warp, list q at list0 + q * stride
// holding n[q] <= 32 P keys (P a lane): t = the 16th largest of the 32
// lanes' maxima; at least 16 keys are >= t (one in each of 16 lanes), so
// no key below t is among the 16 best, and the keys >= t (at most 16 P,
// about 20 on random scores) are kept, packed at the front. The threshold
// rises to t's score. t is 0 (nothing pruned) while fewer than 16 lanes
// hold a key. n and th are warp-uniform.
template <int P, int G>
__device__ __forceinline__ void prune_lists(uint64_t* list0, int stride, int (&n)[G],
                                            float (&th)[G]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the appends are in shared memory
  uint64_t k[G][P], mx[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    mx[q] = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      k[q][p] = lane + 32 * p < n[q] ? list0[q * stride + lane + 32 * p] : 0ull;  // 0: below any key
      mx[q] = k[q][p] > mx[q] ? k[q][p] : mx[q];
    }
  }
  sort32_desc<G>(mx);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const uint64_t t = __shfl_sync(0xffffffffu, mx[q], kRounds - 1);
    int kept = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool keep = k[q][p] != 0 && k[q][p] >= t;
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      if (keep) list0[q * stride + kept + __popc(ball & below)] = k[q][p];
      kept += __popc(ball);
    }
    n[q] = kept;
    if (t != 0) th[q] = key_score(t);
  }
  __syncwarp();
}

// A query's 16 rounds for the tile: prune, sort what is left, and write
// out_s / out_i[o + m * stride] for m < 16; rounds past the list's length
// are (-3.4e38, 0).
template <int P>
__device__ __forceinline__ void write_rounds(uint64_t* list, int n, float th, float* out_s,
                                             int32_t* out_i, size_t o, int stride) {
  const int lane = threadIdx.x & 31;
  int nn[1] = {n};
  float tt[1] = {th};
  prune_lists<P, 1>(list, 0, nn, tt);
  n = nn[0];
  uint64_t a = lane < n ? list[lane] : 0ull;
  if (n <= 32) {
    uint64_t x[1] = {a};
    sort32_desc<1>(x);
    a = x[0];
  } else {
    uint64_t b = lane + 32 < n ? list[lane + 32] : 0ull;
    sort64_desc(a, b);
  }
  if (lane < kRounds) {
    const bool live = lane < n;
    out_s[o + (size_t)lane * stride] = live ? key_score(a) : kNeg;
    out_i[o + (size_t)lane * stride] = live ? key_row(a) : 0;
  }
}

// The producer warp where TMA cannot describe the corpus rows (D * itemsize
// not a multiple of 16 bytes): each lane copies its G-byte granules (8 or 4
// by cp.async, 2 by loads and stores) of box t (rows in turn, zeros past N
// and past D) into the 128-byte swizzled layout TMA gives, keeps kCopyDepth
// boxes of copies in flight, and arrives on box t's full barrier once its
// copies of it are done and fenced for wgmma. Lane 0 arms the stage first
// with the box's query bytes, by a bulk copy: 33 arrivals a stage.
template <int G>
__device__ void produce_rows(const unsigned char* emb, size_t row_bytes, int n, int row0, int kc,
                             int n_boxes, int stages, uint32_t s_ring, uint32_t stage_b,
                             uint32_t bar_full, uint32_t bar_empty, const unsigned char* qsrc,
                             uint32_t qbytes) {
  constexpr int kPerRow = 128 / G;  // granules of a box row
  constexpr int kIters = kSlab * kPerRow / 32;
  constexpr int kBatch = G == 2 ? 8 : 1;  // 2-byte loads a lane has in flight before it stores
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < n_boxes; ++t) {
    const int st = t % stages, r = t / stages;
    if (r > 0) mbar_wait(bar_empty + 8 * st, (r - 1) & 1);
    const uint32_t dst0 = s_ring + st * stage_b;
    if (lane == 0) {
      mbar_expect_tx(bar_full + 8 * st, qbytes);
      bulk_load(dst0 + kBoxBytes, qsrc + (size_t)(t % kc) * qbytes, qbytes, bar_full + 8 * st);
    }
    const int slab_row = row0 + (t / kc) * kSlab;
    const size_t col = (size_t)(t % kc) * 128;  // the box's first byte in a corpus row
    for (int i0 = 0; i0 < kIters; i0 += kBatch) {
      uint32_t dst[kBatch];
      const unsigned char* src[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int u = lane + 32 * (i0 + k), rr = u / kPerRow, gb = (u % kPerRow) * G;
        in[k] = slab_row + rr < n && col + gb < row_bytes;
        src[k] = in[k] ? emb + (size_t)(slab_row + rr) * row_bytes + col + gb : emb;
        dst[k] = dst0 + rr * 128 + (((gb >> 4) ^ (rr & 7)) << 4) + (gb & 15);
      }
      if constexpr (G == 2) {
        unsigned short v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          v[k] = in[k] ? __ldg(reinterpret_cast<const unsigned short*>(src[k])) : 0;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst[k]), "h"(v[k]) : "memory");
      } else {
        copy_granule<G>(dst[0], src[0], in[0]);
      }
    }
    cp_async_commit();
    if (t >= kCopyDepth) {
      cp_async_wait<kCopyDepth>();
      fence_async_smem();
      mbar_arrive(bar_full + 8 * ((t - kCopyDepth) % stages));
    }
  }
  cp_async_wait<0>();
  fence_async_smem();
  for (int t = n_boxes > kCopyDepth ? n_boxes - kCopyDepth : 0; t < n_boxes; ++t)
    mbar_arrive(bar_full + 8 * (t % stages));
}

// A CTA of T's corpus and NC queries (bf16: 16, 32, 64 or 128; f32: 8, 16
// or 32). The queries come with each corpus box through the ring from
// `qbox` (stage_a_query_boxes' layout). gran: 0 where TMA loads the corpus
// (map `tm`), else the granule (8, 4 or 2 bytes) in which the producer warp
// copies it from `emb`. Slab s's scores use score buffer s % kNbuf.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
stage_a_wgmma_kernel(const __grid_constant__ CUtensorMap tm, const T* __restrict__ emb, int gran,
                     const uint8_t* __restrict__ valid, const unsigned char* __restrict__ qbox,
                     float* __restrict__ out_s, int32_t* __restrict__ out_i, int n, int d, int b,
                     int kc) {
  constexpr bool kF32 = Elem<T>::kCopies == 2;
  constexpr int kBoxCols = Elem<T>::kBoxCols;
  constexpr int kQBytes = Elem<T>::kCopies * NC * 128;  // a box's query rows
  constexpr int kStage = stage_bytes(NC, Elem<T>::kCopies);
  constexpr int kStages = ring_stages(NC, Elem<T>::kCopies);
  constexpr int kNbuf = score_buffers(NC, Elem<T>::kCopies);
  constexpr int kCap = list_cap(NC), kP = kCap / 32, kPitch = pitch(NC);
  constexpr int kOwn = NC / kSelWarps;  // queries each selection warp owns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_ring = (raw + 1023u) & ~1023u;  // stage s at + s * kStage
  unsigned char* gring = smem_raw + (s_ring - raw);
  uint64_t* cand = reinterpret_cast<uint64_t*>(gring + kStages * kStage);
  float* sbuf = reinterpret_cast<float*>(cand + NC * kCap);  // [kNbuf][NC][kPitch]
  const uint32_t bar_full = smem_u32(sbuf + kNbuf * NC * kPitch);  // stage s at + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_sfull = bar_empty + 8 * kStages;  // score buffer u at + 8 u
  const uint32_t bar_sempty = bar_sfull + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // f32: a tile's chunks are neighbours in the grid, so they run side by side
  const int tile = kF32 ? blockIdx.y : blockIdx.x;
  const int q0 = (kF32 ? blockIdx.x : blockIdx.y) * NC;
  const int row0 = tile * kTileN;
  const int nq = min(NC, b - q0);
  const int n_slabs = min(kSlabs, (n - row0 + kSlab - 1) / kSlab);
  const int n_boxes = n_slabs * kc;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, gran == 0 ? 1 : 33);  // lane 0's loads; or lane 0 and 32 copiers
      // every MMA thread: no divergent path among the wgmmas in flight (one
      // made ptxas serialize them, C7520)
      mbar_init(bar_empty + 8 * s, 128);
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(bar_sfull + 8 * u, 128);                  // every MMA thread
      mbar_init(bar_sempty + 8 * u, 32 * kSelWarps);      // every selection thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ---- producer: box t = (slab t / kc, column box t % kc)
    // the chunk's query boxes: box x at + x * kQBytes, written by the kernel
    // this one was launched after
    const unsigned char* qsrc = qbox + (size_t)(q0 / NC) * kc * kQBytes;
    wait_for_prior_grid();
    if (gran == 0) {
      if (lane == 0) {
        for (int t = 0; t < n_boxes; ++t) {
          const int st = t % kStages, r = t / kStages;
          if (r > 0) mbar_wait(bar_empty + 8 * st, (r - 1) & 1);
          mbar_expect_tx(bar_full + 8 * st, kStage);
          tma_load(s_ring + st * kStage, &tm, bar_full + 8 * st, (t % kc) * kBoxCols,
                   row0 + (t / kc) * kSlab);
          bulk_load(s_ring + st * kStage + kBoxBytes, qsrc + (size_t)(t % kc) * kQBytes, kQBytes,
                    bar_full + 8 * st);
        }
      }
    } else {
      auto rows = reinterpret_cast<const unsigned char*>(emb);
      const size_t row_bytes = (size_t)d * sizeof(T);
      auto produce = [&](auto g) {
        produce_rows<decltype(g)::value>(rows, row_bytes, n, row0, kc, n_boxes, kStages, s_ring,
                                         kStage, bar_full, bar_empty, qsrc, kQBytes);
      };
      if (gran == 8) produce(std::integral_constant<int, 8>());
      else if (gran == 4) produce(std::integral_constant<int, 4>());
      else produce(std::integral_constant<int, 2>());
    }
    return;
  }

  // ---- the tile's valid flags (0 past N), staged in the list area, which
  // is free until the first slab's selection
  uint8_t* v_tile = reinterpret_cast<uint8_t*>(cand);
  for (int i = tid; i < kTileN; i += kConsumers) v_tile[i] = row0 + i < n ? valid[row0 + i] : 0;
  consumers_sync();

  if (warp < 4) {  // ---- the MMA warpgroup: scores of slab s into buffer s % kNbuf
    const int g = lane >> 2, c = lane & 3;
    // bit 2 s + h: this thread's row s * 64 + warp * 16 + g + 8 h is valid
    uint64_t vmask = 0;
    for (int s = 0; s < kSlabs; ++s) {
      vmask |= (uint64_t)(v_tile[s * kSlab + warp * 16 + g] != 0) << (2 * s);
      vmask |= (uint64_t)(v_tile[s * kSlab + warp * 16 + g + 8] != 0) << (2 * s + 1);
    }
    // bf16: NC columns; f32: 2 NC (hi*q_hi, then hi*q_lo) and acc_lo's NC (lo*q_hi)
    float acc[kF32 ? NC : NC / 2] = {};
    float acc_lo[kF32 ? NC / 2 : 1] = {};
    // f32: lo = x - trunc(x) of box t's rows g and g + 8 into A registers
    // for k-steps kk = 0..3: (row g, K c), (g + 8, c), (g, c + 4), (g + 8,
    // c + 4) are columns 8kk + c and 8kk + c + 4 (4-byte loads, no bank
    // conflict); trunc(x) clears the 13 low mantissa bits, so lo is exact
    auto split_lo = [&](uint32_t (&lo)[16], int st) {
      const unsigned char* box = gring + st * kStage;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (row g, K c), (g + 8, c), (g, c + 4), (g + 8, c + 4)
          const int h = e & 1, col4 = e >> 1;
          const unsigned char* row = box + (warp * 16 + g + 8 * h) * 128;  // (row & 7) == g
          const float v = *reinterpret_cast<const float*>(
              row + (((2 * kk + col4) ^ g) << 4) + 4 * c);
          lo[4 * kk + e] = __float_as_uint(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
        }
      }
    };
    // f32: box x's products, one group: trunc(x) * [q_hi; q_lo] from shared
    // memory (the tensor cores read the box's f32 as TF32, dropping the 13
    // low mantissa bits) and lo * q_hi from registers
    auto mma_box = [&](uint32_t (&lo)[16], int x, int st) {
      const uint32_t a = s_ring + st * kStage, bq = a + kBoxBytes;  // bq: the box's queries
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(bq + kk * 32);
        const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
        if constexpr (kF32) {
          wgmma_ss_tf32(acc, desc_sw128(a + kk * 32), db, (x | kk) != 0);  // N = 2 NC
          wgmma_rs_tf32(acc_lo, al, db, (x | kk) != 0);                     // N = NC
        }
      }
      wgmma_commit();
    };
    uint32_t lo0[16], lo1[16];
    for (int s = 0; s < n_slabs; ++s) {
      fence_regs(acc);
      fence_regs(acc_lo);
      if constexpr (kF32) {
        // box x's lo is split while box x - 1's products run; a box goes back
        // to the producer once the products that read it are done
        auto step = [&](uint32_t (&lo)[16], int x) {
          const int t = s * kc + x, st = t % kStages;
          mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
          split_lo(lo, st);
          mma_box(lo, x, st);
          if (x > 0) {
            wgmma_wait<1>();
            mbar_arrive(bar_empty + 8 * ((t - 1) % kStages));
          }
        };
        for (int x = 0; x < kc; x += 2) {
          step(lo0, x);
          if (x + 1 < kc) step(lo1, x + 1);
        }
        wgmma_wait<0>();
        mbar_arrive(bar_empty + 8 * ((s * kc + kc - 1) % kStages));
      } else {
        for (int x = 0; x < kc; ++x) {
          const int t = s * kc + x, st = t % kStages;
          mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
          const uint32_t a = s_ring + st * kStage, bq = a + kBoxBytes;  // bq: the box's queries
          fence_regs(acc);
          wgmma_fence();  // after the wait's branch, so ptxas needs no fence of its own there
#pragma unroll
          for (int kk = 0; kk < kBoxCols / 16; ++kk)
            Wgmma<NC>::mma(acc, desc_sw128(a + kk * 32), desc_sw128(bq + kk * 32), (x | kk) != 0);
          wgmma_commit();
          if (x > 0) {  // the box before this one is read: back to the producer
            wgmma_wait<1>();
            mbar_arrive(bar_empty + 8 * ((t - 1) % kStages));
          }
        }
        wgmma_wait<0>();
        mbar_arrive(bar_empty + 8 * ((s * kc + kc - 1) % kStages));
      }
      fence_regs(acc);
      fence_regs(acc_lo);
      // accumulator element 4i + 2h + e is (row warp * 16 + g + 8h, query
      // 8i + 2c + e; f32: its hi*q_lo is element 4i + 2h + e + NC / 2 and
      // its lo*q_hi acc_lo's 4i + 2h + e); an invalid row scores NaN, which
      // no compare passes, and -0 becomes +0 (the key order is then the
      // float order)
      const int u = s % kNbuf;
      if (s >= kNbuf) mbar_wait(bar_sempty + 8 * u, (s / kNbuf - 1) & 1);
      float* out = sbuf + u * NC * kPitch + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < NC / 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool v = (vmask >> (2 * s + h)) & 1;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * i + 2 * h + e;
            float sc = acc[k];
            if constexpr (kF32) sc += acc[k + NC / 2] + acc_lo[k];
            out[(8 * i + 2 * c + e) * kPitch + 8 * h] =
                v ? __fadd_rn(sc, 0.0f) : __int_as_float(0x7fc00000);
          }
        }
      }
      mbar_arrive(bar_sfull + 8 * u);
    }
    return;
  }

  // ---- selection warp sw owns queries j = sw + 8 m: their thresholds and
  // counts (warp-uniform registers) and lists. It reads their 64 scores of
  // each slab (rows lane and lane + 32), hands the buffer back, then
  // appends the values >= the threshold in two halves of 32 rows and
  // prunes a list that could not take another half.
  // Its queries are pruned in groups of kG (queries sw + 8 (g kG + q)): a
  // whole group whenever one of its lists is full, the sorts interleaved.
  constexpr int kG = kOwn < 4 ? kOwn : 4;
  const int sw = warp - 4;
  const unsigned below = (1u << lane) - 1u;
  float th[kOwn / kG][kG];
  int cnt[kOwn / kG][kG];
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    th[m / kG][m % kG] = -INFINITY;
    cnt[m / kG][m % kG] = 0;
  }
  for (int s = 0; s < n_slabs; ++s) {
    const int u = s % kNbuf;
    mbar_wait(bar_sfull + 8 * u, (s / kNbuf) & 1);
    float sc[kOwn][2];
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      const float* col = sbuf + (u * NC + sw + 8 * m) * kPitch;
      sc[m][0] = col[lane];
      sc[m][1] = col[lane + 32];
    }
    mbar_arrive(bar_sempty + 8 * u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        const int j = sw + 8 * m;
        float& t = th[m / kG][m % kG];
        int& n_j = cnt[m / kG][m % kG];
        const bool pass = j < nq && sc[m][h] >= t;  // false for NaN (invalid rows)
        const unsigned ball = __ballot_sync(0xffffffffu, pass);
        if (ball == 0) continue;
        if (pass) cand[j * kCap + n_j + __popc(ball & below)] =
            make_key(sc[m][h], s * kSlab + 32 * h + lane);
        n_j += __popc(ball);
      }
#pragma unroll
      for (int g = 0; g < kOwn / kG; ++g) {
        bool full = false;
#pragma unroll
        for (int q = 0; q < kG; ++q) full = full || cnt[g][q] > kCap - kHalf;
        if (full) prune_lists<kP, kG>(cand + (sw + 8 * g * kG) * kCap, 8 * kCap, cnt[g], th[g]);
      }
    }
  }
  // the tile's rounds: out[(tile * 16 + m) * b + q0 + j]
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    const int j = sw + 8 * m;
    if (j < nq)
      write_rounds<kP>(cand + j * kCap, cnt[m / kG][m % kG], th[m / kG][m % kG], out_s, out_i,
                       (size_t)tile * kRounds * b + q0 + j, b);
  }
}

// The queries, once a call: chunk c's box x (columns x * kBoxCols ..) at
// ws + (c * kc + x) * kQRows * 128, in the layout wgmma reads from shared
// memory (query j's 16-byte piece p at row j, ((p ^ (j & 7)) << 4); f32: hi
// at row j and lo at row NC + j), so that one bulk copy puts it beside its
// corpus box. Zero past B and past D; any D (element loads). One thread a
// 16-byte piece of a row. It lets the main kernel launch at once
// (stage_a_wgmma_kernel waits for its writes in wait_for_prior_grid).
template <typename T, int NC>
__global__ void stage_a_query_boxes(const float* __restrict__ qvecs, unsigned char* __restrict__ ws,
                                    int d, int b, int kc, long long pieces) {
  allow_dependent_launch();
  constexpr bool kF32 = Elem<T>::kCopies == 2;
  constexpr int kQRows = Elem<T>::kCopies * NC;
  constexpr int kPer = 16 / sizeof(T);  // columns a piece holds: 4 f32, 8 bf16
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pieces; i += stride) {
    const int p = (int)(i % 8), j = (int)(i / 8 % NC);
    const long long cx = i / (8 * NC);  // c * kc + x
    const int q = (int)(cx / kc) * NC + j, k0 = (int)(cx % kc) * Elem<T>::kBoxCols + p * kPer;
    float e[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      e[u] = q < b && k0 + u < d ? __ldg(qvecs + (size_t)q * d + k0 + u) : 0.f;
    unsigned char* at = ws + cx * kQRows * 128 + j * 128 + ((p ^ (j & 7)) << 4);
    if constexpr (kF32) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        hi[u] = tf32_rna(e[u]);
        lo[u] = tf32_rna(e[u] - __uint_as_float(hi[u]));
      }
      *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(at + NC * 128) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      *reinterpret_cast<uint4*>(at) = make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]),
                                                 pack_bf16(e[4], e[5]), pack_bf16(e[6], e[7]));
    }
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

// The corpus (N, D) of T as a 2-D map: D columns innermost, N rows; boxes
// of one 128-byte row (64 bf16 or 32 f32 columns) x 64 rows, 128-byte
// swizzle; zero fill past the edges.
template <typename T>
bool make_map(CUtensorMap* map, const void* emb, int n, int d) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Elem<T>::kBoxCols, (cuuint32_t)kSlab};
  const cuuint32_t elem[2] = {1u, 1u};
  return fn(map, Elem<T>::kMap, 2, const_cast<void*>(emb), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The chunk widths the kernel has an instance for: powers of 2 from the
// type's narrowest to its widest.
template <typename T>
bool chunk_taken(int nc) {
  return nc >= Elem<T>::kMinChunk && nc <= Elem<T>::kMaxChunk && (nc & (nc - 1)) == 0;
}

// The query boxes, then the main kernel as a programmatic dependent launch
// on the same stream.
template <typename T, int NC>
cudaError_t launch(const CUtensorMap& map, const T* emb, int gran, const uint8_t* valid,
                   const float* qvecs, unsigned char* ws, float* out_s, int32_t* out_i, int n,
                   int d, int b, int kc, cudaStream_t stream) {
  constexpr int copies = Elem<T>::kCopies;
  constexpr int smem = smem_bytes(NC, ring_stages(NC, copies), score_buffers(NC, copies), copies);
  static_assert(smem <= kMaxSmem, "shared memory");
  // the copy loader arrives on box t after issuing box t + kCopyDepth, and
  // the MMA warpgroup frees box t - 1 after box t is full
  static_assert(ring_stages(NC, copies) >= kCopyDepth + 2, "the copy loader needs the stages");
  const int chunks = (b + NC - 1) / NC;
  const long long pieces = (long long)chunks * kc * NC * 8;
  const int blocks = (int)(pieces < 256LL * 4096 ? (pieces + 255) / 256 : 4096);
  stage_a_query_boxes<T, NC><<<blocks, 256, 0, stream>>>(qvecs, ws, d, b, kc, pieces);
  if (cudaError_t err = cudaGetLastError(); err != cudaSuccess) return err;
  auto kern = stage_a_wgmma_kernel<T, NC>;
  static bool smem_set = false;  // the opt-in is per kernel instance, not per call
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int tiles = (n + kTileN - 1) / kTileN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = copies == 2 ? dim3(chunks, tiles) : dim3(tiles, chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, map, emb, gran, valid,
                            static_cast<const unsigned char*>(ws), out_s, out_i, n, d, b, kc);
}

template <typename T>
int run(const void* emb, const void* valid, const void* qvecs, void* ws, void* out_s, void* out_i,
        int n, int d, int b, int nc, void* stream) {
  if (n <= 0 || d <= 0 || b <= 0 || !chunk_taken<T>(nc) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const int kc = (d + Elem<T>::kBoxCols - 1) / Elem<T>::kBoxCols;
  const long long tiles = ((long long)n + kTileN - 1) / kTileN, chunks = (b + nc - 1) / nc;
  if ((Elem<T>::kCopies == 2 ? tiles : chunks) > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  // TMA where the rows start on 16 bytes, else copies in the widest
  // granule the row width allows
  if ((uintptr_t)emb % 16 || (uintptr_t)ws % 16) return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)d * sizeof(T);
  const int low = (int)((row_bytes | 16u) & (~(row_bytes | 16u) + 1));
  const int gran = low == 16 ? 0 : low;
  CUtensorMap map{};
  if (gran == 0 && !make_map<T>(&map, emb, n, d)) return (int)cudaErrorInvalidValue;
  auto e = static_cast<const T*>(emb);
  auto v = static_cast<const uint8_t*>(valid);
  auto q = static_cast<const float*>(qvecs);
  auto w = static_cast<unsigned char*>(ws);
  auto os = static_cast<float*>(out_s);
  auto oi = static_cast<int32_t*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (Elem<T>::kMinChunk == 8) {
    if (nc == 8) return (int)launch<T, 8>(map, e, gran, v, q, w, os, oi, n, d, b, kc, st);
  }
  if (nc == 16) return (int)launch<T, 16>(map, e, gran, v, q, w, os, oi, n, d, b, kc, st);
  if constexpr (Elem<T>::kMaxChunk == 128) {
    if (nc == 64) return (int)launch<T, 64>(map, e, gran, v, q, w, os, oi, n, d, b, kc, st);
    if (nc == 128) return (int)launch<T, 128>(map, e, gran, v, q, w, os, oi, n, d, b, kc, st);
  }
  return (int)launch<T, 32>(map, e, gran, v, q, w, os, oi, n, d, b, kc, st);
}

}  // namespace

// emb (N, D) bf16, any D >= 1, 16-byte aligned; valid (N,) bool; qvecs (B,
// D) f32; nc the chunk width (16, 32, 64 or 128 queries a CTA); ws a
// workspace of ceil(B / nc) * nc * ceil(D / 64) * 128 bytes, 16-byte
// aligned, for the query boxes; out_s (n_tiles, 16, B) f32 and out_i
// (n_tiles, 16, B) int32, n_tiles = ceil(N / 2048); all contiguous on one
// device. Returns a cudaError_t (0 = launched).
extern "C" int rrt_stage_a_wgmma(const void* emb, const void* valid, const void* qvecs, void* ws,
                                 void* out_s, void* out_i, int n, int d, int b, int nc,
                                 void* stream) {
  return run<__nv_bfloat16>(emb, valid, qvecs, ws, out_s, out_i, n, d, b, nc, stream);
}

// The same for emb (N, D) f32 (the products as 3xTF32): nc 8, 16 or 32, ws
// ceil(B / nc) * nc * ceil(D / 32) * 256 bytes (hi and lo); n_tiles <= 65535.
extern "C" int rrt_stage_a_tf32(const void* emb, const void* valid, const void* qvecs, void* ws,
                                void* out_s, void* out_i, int n, int d, int b, int nc,
                                void* stream) {
  return run<float>(emb, valid, qvecs, ws, out_s, out_i, n, d, b, nc, stream);
}
