// Helpers and kernels of the attention past 256 head columns: the bf16/f16
// forward (csrc/mha_wide.cu) and backward (csrc/mha_wide_bwd.cu), and the
// mbarrier, TMA, register-split and tensor-map helpers of the f32 kernels
// (csrc/mha_wide_f32.cu).
//
// The 16-bit kernels store the scores once. A score kernel contracts each
// 64 x 64 tile of S = Q K^T (and, in the backward, of dP = dO V^T) once per
// row block over the whole D, a 64-column box at a time, and writes it to a
// workspace: the logits in f32 (log2 units, as the other routes form
// them), dP rounded to the input type T (the plain version rounds it so).
// Product kernels then read those tiles back by TMA beside the chunk
// boxes of V, K, or Q and dO, and form P = 2^(L - m) / l (or dS = P (dP -
// Delta)) a k-step of 16 at a time as wgmma's A fragments in registers:
// no score is contracted twice, and no two CTAs need to meet. A CTA is two
// consumer warpgroups and a producer warpgroup whose first thread issues
// every TMA box into a ring of slots, each slot a whole tile's boxes (an
// mbarrier operation costs a few hundred cycles: one slot a box made the
// producer the bottleneck), completed on a full mbarrier and handed back on
// an empty one; setmaxnreg gives the producer 40 registers a thread and the
// consumers 232.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kMinWideD = 257;  // the wide kernels take D >= this
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, wgmma plumbing ----

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
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma's operands, TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// at most one committed group still in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// wgmma descriptor of a K-major box with 128-byte rows and the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), layout type 1; a k-step is
// 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same box read N-major (through wgmma's transpose bit): its rows are
// the contraction, 8-row groups 1024 bytes apart (SBO), its 64 columns the
// product's N; a k-step of 16 rows is 2048 bytes further.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// a producer warpgroup gives registers back, the consumers take them
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A phase that has not completed 10 s after the wait began is a fault of
// the kernel (a barrier that can never complete): trap, so that the launch
// fails and the card is freed, rather than hang.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 4095) == 0) {  // the timer read is slow: rarely
      const uint64_t now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 10000000000ull) {
        __trap();
      }
    }
  }
}

// ---- host side: tensor maps, shared memory opt-in ----

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled (CUDA 12.0 ABI), looked up through the runtime, so
// that the library does not link against libcuda.
inline EncodeTiled encode_tiled() {
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

inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  // set on every call: the opt-in belongs to the current device
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---- rows TMA cannot read in place (every dtype) ----

// The row width, in values of `elem` bytes, at which TMA reads rows of D
// values: D up to a multiple of 16 bytes.
inline int row_pad(int D, int elem) { return (D * elem + 15) / 16 * 16 / elem; }

// Whether TMA reads the rows in place: a head stride of ld values a
// multiple of 16 bytes and 16-byte aligned bases.
inline bool rows_in_place(int ld, int elem, const void* const* ptrs, int n) {
  if (ld * elem % 16) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

// Rows of D values of E (head stride ld) copied into rows of Dst >= D, zero
// past D. A block a row at a time.
template <typename E>
__global__ void wide_pad_kernel(const E* __restrict__ src, E* __restrict__ dst, long long rows,
                                int D, int ld, int Dst) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x)
    for (int d = threadIdx.x; d < Dst; d += blockDim.x)
      dst[r * Dst + d] = d < D ? src[r * ld + d] : E(0);
}

// The n row tensors of nrows rows a call reads: in place (padded false;
// head stride ld), or each src[i] copied by wide_pad_kernel into dst[i] as
// rows of row_pad(D). Returns the head stride of what it hands back.
template <typename E>
int wide_rows(const void** rows, const void* const* src, void* const* dst, int n, long long nrows,
              int D, int ld, bool padded, cudaStream_t stream) {
  if (!padded) {
    for (int i = 0; i < n; ++i) rows[i] = src[i];
    return ld;
  }
  const int Dst = row_pad(D, sizeof(E)), grid = nrows < 8192 ? (int)nrows : 8192;
  for (int i = 0; i < n; ++i) {
    wide_pad_kernel<E><<<grid, 128, 0, stream>>>(static_cast<const E*>(src[i]),
                                                 static_cast<E*>(dst[i]), nrows, D, ld, Dst);
    rows[i] = dst[i];
  }
  return Dst;
}

// ---- the 16-bit kernels: types and wgmma ----

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define RRT_OUT_16(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define RRT_OUT_32(d)                                                                          \
  RRT_OUT_16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// SS m64n64k16: A and B K-major from shared memory; scale_d = 0 starts
// the sum.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d,
                                         __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RRT_OUT_32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d,
                                         __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RRT_OUT_32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// RS m64n64k16: A from registers, B N-major from shared memory (transpose
// bit); accumulates.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RRT_OUT_32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RRT_OUT_32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef RRT_OUT_32
#undef RRT_OUT_16

// two f32 into the A registers' two 16-bit halves (x in the low half)
__device__ __forceinline__ uint32_t pack2(float x, float y, __nv_bfloat16) {
  __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack2(float x, float y, __half) {
  __half2 p = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <typename T>
struct MapType;
template <>
struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct MapType<__half> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// ---- the 16-bit kernels ----

constexpr int kWideWg = 128;                   // threads of a warpgroup
constexpr int kWideConsumers = 2;              // consumer warpgroups a CTA
constexpr int kWideThreads = (kWideConsumers + 1) * kWideWg;  // and the producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 64K
constexpr int kWideProducerRegs = 40, kWideConsumerRegs = 232;
constexpr int kBoxCols = 64;                   // 16-bit columns of one 128-byte box row
constexpr int kBlockRows = 64;                 // a row block: wgmma's M
constexpr int kTile = 64;                      // streamed rows a tile: the score tile's N
constexpr int kBoxBytes = kBlockRows * 128;    // a box of 64 rows x 128 bytes: 8 KB
constexpr int kChunk = 192;                    // output / gradient columns a warpgroup
constexpr int kMaxStages = 28;
constexpr int kWideSmem = 232448;              // one CTA an SM
constexpr int kMaxOwnBytes = 160 * 1024;       // resident own rows at most

__host__ __device__ inline int div_up(int a, int b) { return (a + b - 1) / b; }

// The stored scores: a (B*H, S, SK) array of f32 logits in log2 units (L)
// and, in the backward, of dP rounded to T; SK = S up to a multiple of 64.
__host__ __device__ inline int score_cols(int S) { return (S + kTile - 1) / kTile * kTile; }

// byte offset of (row r, column x) in a box of 128-byte rows under the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), x in
// bytes
__device__ __forceinline__ int swz_byte(int r, int x) {
  return r * 128 + ((((x >> 4) ^ (r & 7)) << 4) | (x & 15));
}

// The ring's and the own rows' mbarriers, after the slots: full[stages]
// (a slot landed), empty[stages] (the consumers' eight warps are done with
// it), own (the resident own rows landed).
struct WideBars {
  uint32_t at;
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const { return at + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return at + 8 * (stages + s); }
  __device__ __forceinline__ uint32_t own() const { return at + 16 * stages; }
  static constexpr int bytes(int stages) { return 16 * stages + 8; }
};

// A launch's shared memory: resident own rows [0, ring_at), the ring of
// `stages` slots of `slot` bytes, the barriers; and slack to align the base
// to the 1024 bytes of the swizzle's period.
struct WideSmem {
  int ring_at, slot, stages, bar_at, bytes;
};

inline WideSmem wide_smem(int own_bytes, int slot) {
  WideSmem m{};
  m.ring_at = (own_bytes + 1023) / 1024 * 1024;
  m.slot = slot;
  const int room = kWideSmem - 1024 - m.ring_at - WideBars::bytes(kMaxStages);
  m.stages = room / slot < kMaxStages ? room / slot : kMaxStages;
  if (m.stages < 2) m.stages = 0;
  m.bar_at = m.ring_at + m.stages * slot;
  m.bytes = m.bar_at + WideBars::bytes(m.stages) + 1024;
  return m;
}

// The CTA's shared memory aligned to 1024 bytes; thread 0 sets up the
// barriers (full_count: the arrivals that complete a slot beside its
// bytes).
__device__ __forceinline__ unsigned char* wide_setup(unsigned char* raw, const WideSmem& m,
                                                     WideBars* bars, int full_count = 1) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bars->at = smem_u32(smem) + m.bar_at;
  bars->stages = m.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < m.stages; ++s) {
      mbar_init(bars->full(s), full_count);
      mbar_init(bars->empty(s), 4 * kWideConsumers);
    }
    mbar_init(bars->own(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem;
}

// The consumers' walk over the ring: slot n % stages, phase n / stages.
// Both consumer warpgroups wait for and hand back every slot.
struct RingWalk {
  WideBars bars;
  uint32_t base;
  int slot_bytes;
  int n = 0;
  __device__ __forceinline__ uint32_t wait() const {
    mbar_wait_bounded(bars.full(n % bars.stages), (n / bars.stages) & 1);
    return base + (n % bars.stages) * slot_bytes;
  }
  // slot m goes back to the producer (lane 0 of each warp, after the
  // warp's own wgmma reads of it completed)
  __device__ __forceinline__ void release(int m) const {
    if (threadIdx.x % 32 == 0) mbar_arrive(bars.empty(m % bars.stages));
  }
};

// The producer's walk: wait for the slot to be free, expect its bytes.
struct RingFill {
  WideBars bars;
  uint32_t base;
  int slot_bytes;
  int n = 0;
  __device__ __forceinline__ uint32_t next(uint32_t bytes, uint32_t* bar) {
    const int s = n % bars.stages;
    if (n >= bars.stages) mbar_wait_bounded(bars.empty(s), (n / bars.stages - 1) & 1);
    *bar = bars.full(s);
    mbar_expect_tx(*bar, bytes);
    ++n;
    return base + s * slot_bytes;
  }
};

// K-major score product over one landed box of 64 columns: x (+)= A B, 4
// k-steps of 16 columns; `first` starts the sum.
template <typename T, int N>
__device__ __forceinline__ void score_box(float (&x)[N], uint32_t a, uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(x, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), !first || kk > 0, T{});
}

// the 32 accumulators of box b of a chunk accumulator
template <int N>
__device__ __forceinline__ float (&box_acc(float (&acc)[N], int b))[32] {
  return *reinterpret_cast<float(*)[32]>(&acc[32 * b]);
}

// A (B, S, H, ld) 16-bit tensor's heads as 4-D (D, H, S, B), box 64
// columns x `rows` rows: zero past D and past S.
template <typename T>
bool map_heads(CUtensorMap* map, const void* p, int B, int S, int H, int D, int ld, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ld * 2, (cuuint64_t)H * ld * 2,
                                 (cuuint64_t)S * H * ld * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1u, (cuuint32_t)rows, 1u};
  return encode(map, MapType<T>::kType, 4, p, dims, strides, box);
}

// A stored score array (B*H, S, SK) of `elem` bytes an entry, box 128
// bytes of a row (32 f32 or 64 16-bit keys) x `rows` rows: zero past S.
inline bool map_scores(CUtensorMap* map, const void* p, CUtensorMapDataType type, int elem, int BH,
                       int S, int rows) {
  const int SK = score_cols(S);
  const cuuint64_t dims[3] = {(cuuint64_t)SK, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)SK * elem, (cuuint64_t)S * SK * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows, 1u};
  return encode(map, type, 3, p, dims, strides, box);
}

// The workspace of a 16-bit call, in bytes, each region 256-byte aligned:
// the row statistics (nstats floats a row), the stored logits (f32), in
// the backward dP (T), then, where the rows are copied, n tensors of rows
// of row_pad(D, 2).
struct WideWs {
  long long stats, logits, dp, rows, total;
  WideWs(bool backward, int B, int S, int H, int D, bool padded) {
    const auto r256 = [](long long n) { return (n + 255) / 256 * 256; };
    const long long bhs = (long long)B * H * S, sk = score_cols(S);
    stats = r256((backward ? 3 : 2) * bhs * 4);
    logits = r256(bhs * sk * 4);
    dp = backward ? r256(bhs * sk * 2) : 0;
    rows = padded ? r256(bhs * row_pad(D, 2) * 2) : 0;
    total = stats + logits + dp + (backward ? 4 : 3) * rows;
  }
  float* stats_at(void* ws) const { return static_cast<float*>(ws); }
  float* logits_at(void* ws) const {
    return reinterpret_cast<float*>(static_cast<unsigned char*>(ws) + stats);
  }
  void* dp_at(void* ws) const { return static_cast<unsigned char*>(ws) + stats + logits; }
  void* rows_at(void* ws, int i) const {
    return static_cast<unsigned char*>(ws) + stats + logits + dp + i * rows;
  }
};

// ---- the score kernel ----

// The score tiles the score kernel contracted, by MODE (0: S, 1: dP), since
// the count was last taken (take_score_tiles): each consumer warpgroup whose
// row block holds a row < S adds, at its end, the tiles its walk
// contracted. A count of its translation unit's own launches; no output
// depends on it.
__device__ unsigned long long g_wide_score_tiles[2];

// g_wide_score_tiles[mode] of this translation unit, then zero (waits for
// the device); -1 where the copy fails.
inline long long take_score_tiles(int mode) {
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  const size_t at = (mode ? 1 : 0) * sizeof n;
  if (cudaMemcpyFromSymbol(&n, g_wide_score_tiles, sizeof n, at) != cudaSuccess ||
      cudaMemcpyToSymbol(g_wide_score_tiles, &zero, sizeof zero, at) != cudaSuccess)
    return -1;
  return (long long)n;
}

// The tiles of S one contraction covers at a call's shape: B * H row blocks
// of S by its key tiles, from the score kernel's grid of (pairs, H, B) CTAs.
inline long long score_tiles(int B, int S, int H) {
  const int pairs = div_up(S, kWideConsumers * kBlockRows), blocks = div_up(S, kBlockRows);
  const int own = pairs * kWideConsumers < blocks ? pairs * kWideConsumers : blocks;
  return (long long)B * H * own * (score_cols(S) / kTile);
}

// MODE 0: S = Q K^T over the whole D (ma: Q's rows, mb: K's), the logits
// L = s * scale + bias in log2 units (-inf at keys >= S) stored to
// `logits` for rows < S, the running row max and sum, m and 1/l to
// stats. MODE 1 (the backward): dP = dO V^T over the whole D (ma: dO, mb:
// V), rounded to T and stored to `dpw`; P = 2^(L - m) / l from the stored
// logits and statistics; Delta = sum_k P dP to stats. A CTA takes two
// blocks of 64 rows of one (b, h), one a consumer warpgroup, and walks the
// keys in tiles of 64, each contracted a 64-column box at a time: the
// warpgroups share every streamed box; their own rows' boxes are resident
// (res) or stream beside each streamed box. A ring slot takes gb boxes.
template <typename T, int MODE>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_score_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const float* __restrict__ key_bias, float* __restrict__ stats,
                  float* __restrict__ logits, T* __restrict__ dpw, const WideSmem sm, int S, int H,
                  int D, float scale, int res, int gb) {
  constexpr int N = kTile / 2;  // score accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  WideBars bars;
  unsigned char* smem = wide_setup(smem_raw, sm, &bars);
  const uint32_t base = smem_u32(smem);
  const int pair0 = blockIdx.x * kWideConsumers * kBlockRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = div_up(D, kBoxCols), SK = score_cols(S), ntiles = SK / kTile;
  const int ownb = res ? 0 : kWideConsumers * kBoxBytes;  // a slot: [both own boxes][streamed box]

  if (threadIdx.x >= kWideConsumers * kWideWg) {  // the producer: its first thread issues the boxes
    setmaxnreg_dec<kWideProducerRegs>();
    if (threadIdx.x == kWideConsumers * kWideWg) {
      if (res) {
        mbar_expect_tx(bars.own(), kWideConsumers * nk * kBoxBytes);
        for (int w = 0; w < kWideConsumers; ++w)
          for (int j = 0; j < nk; ++j)
            tma_4d(base + (w * nk + j) * kBoxBytes, &ma, bars.own(), j * kBoxCols, h,
                   pair0 + w * kBlockRows, b);
      }
      RingFill fill{bars, base + sm.ring_at, sm.slot};
      uint32_t bar;
      for (int t = 0; t < ntiles; ++t)
        for (int j0 = 0; j0 < nk; j0 += gb) {
          const int n = nk - j0 < gb ? nk - j0 : gb;
          const uint32_t st = fill.next(n * (ownb + kBoxBytes), &bar);
          for (int j = 0; j < n; ++j) {
            const uint32_t at = st + j * (ownb + kBoxBytes);
            if (!res)
              for (int w = 0; w < kWideConsumers; ++w)
                tma_4d(at + w * kBoxBytes, &ma, bar, (j0 + j) * kBoxCols, h, pair0 + w * kBlockRows,
                       b);
            tma_4d(at + ownb, &mb, bar, (j0 + j) * kBoxCols, h, t * kTile, b);
          }
        }
    }
    return;
  }
  setmaxnreg_inc<kWideConsumerRegs>();

  const int wg = threadIdx.x / kWideWg, wtid = threadIdx.x % kWideWg;
  const int warp = wtid / 32, lane = wtid % 32, g = lane / 4, c = lane % 4;
  const int r0 = pair0 + wg * kBlockRows + warp * 16 + g, r1 = r0 + 8;
  const long long bh = (long long)b * H + h, bhs = (long long)gridDim.z * H * S;
  float* st = stats + bh * S;  // m; 1/l bhs further; Delta 2 bhs further
  float* lrow = logits + bh * S * SK;  // row r at r * SK
  T* drow = MODE == 1 ? dpw + bh * S * SK : nullptr;
  const float* brow = key_bias + (long long)b * S;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // MODE 1: m, 1/l; l0, l1 Delta
  float il0 = 0.f, il1 = 0.f;
  if constexpr (MODE == 1) {
    m0 = r0 < S ? st[r0] : 0.f;
    m1 = r1 < S ? st[r1] : 0.f;
    il0 = r0 < S ? st[bhs + r0] : 0.f;
    il1 = r1 < S ? st[bhs + r1] : 0.f;
  }
  RingWalk walk{bars, base + sm.ring_at, sm.slot};
  const uint32_t own = base + wg * nk * kBoxBytes;
  if (res) mbar_wait_bounded(bars.own(), 0);

  // MODE 0: the tile's key bias in log2 units (-inf past S); MODE 1: its
  // logits of rows r0, r1
  auto prefetch = [&](int t, float2 (&pre)[2][kTile / 8]) {
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int key = t * kTile + 8 * i + 2 * c;
      if constexpr (MODE == 0) {
        pre[0][i] = make_float2(key < S ? __ldg(brow + key) * kLog2e : -INFINITY,
                                key + 1 < S ? __ldg(brow + key + 1) * kLog2e : -INFINITY);
      } else {
        pre[0][i] = r0 < S ? *reinterpret_cast<const float2*>(lrow + (long long)r0 * SK + key)
                           : make_float2(0.f, 0.f);
        pre[1][i] = r1 < S ? *reinterpret_cast<const float2*>(lrow + (long long)r1 * SK + key)
                           : make_float2(0.f, 0.f);
      }
    }
  };

  // the tile's scores (columns 8i + 2c + e of rows r0, elements 4i + e,
  // and r1, 4i + 2 + e): MODE 0 the logits stored, the running max and sum;
  // MODE 1 dP rounded to T (as the plain version takes it) stored, Delta +=
  // P dP
  auto epilogue = [&](int t, float (&x)[N], const float2 (&pre)[2][kTile / 8]) {
    if constexpr (MODE == 0) {
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int key = t * kTile + 8 * i + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * i + e] = fmaf(x[4 * i + e], scale, (e & 1) ? pre[0][i].y : pre[0][i].x);
        if (r0 < S)
          *reinterpret_cast<float2*>(lrow + (long long)r0 * SK + key) =
              make_float2(x[4 * i], x[4 * i + 1]);
        if (r1 < S)
          *reinterpret_cast<float2*>(lrow + (long long)r1 * SK + key) =
              make_float2(x[4 * i + 2], x[4 * i + 3]);
        mx0 = fmaxf(mx0, fmaxf(x[4 * i + 0], x[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(x[4 * i + 2], x[4 * i + 3]));
      }
      // running row max and sum; tile 0 holds key 0 (finite bias), so the
      // max is finite and 2^(-inf - mx) = 0 clears the empty sums
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      l0 *= ex2_approx(m0 - mx0);
      l1 *= ex2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        l0 += ex2_approx(x[4 * i + 0] - m0) + ex2_approx(x[4 * i + 1] - m0);
        l1 += ex2_approx(x[4 * i + 2] - m1) + ex2_approx(x[4 * i + 3] - m1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int key = t * kTile + 8 * i + 2 * c;
        const uint32_t y0 = pack2(x[4 * i], x[4 * i + 1], T{});
        const uint32_t y1 = pack2(x[4 * i + 2], x[4 * i + 3], T{});
        if (r0 < S) *reinterpret_cast<uint32_t*>(drow + (long long)r0 * SK + key) = y0;
        if (r1 < S) *reinterpret_cast<uint32_t*>(drow + (long long)r1 * SK + key) = y1;
        l0 = fmaf(ex2_approx(pre[0][i].x - m0) * il0, to_f32(from_f32<T>(x[4 * i])), l0);
        l0 = fmaf(ex2_approx(pre[0][i].y - m0) * il0, to_f32(from_f32<T>(x[4 * i + 1])), l0);
        l1 = fmaf(ex2_approx(pre[1][i].x - m1) * il1, to_f32(from_f32<T>(x[4 * i + 2])), l1);
        l1 = fmaf(ex2_approx(pre[1][i].y - m1) * il1, to_f32(from_f32<T>(x[4 * i + 3])), l1);
      }
    }
  };

  // a tile's products: every slot's boxes issued as it lands, the slot
  // handed back once the products that read it are done (the ring's
  // mbarrier operations cost hundreds of cycles each: a slot takes gb boxes)
  float x[N];
  float2 pre[2][kTile / 8];
  unsigned long long done = 0;  // tiles contracted (g_wide_score_tiles)
  for (int t = 0; t < ntiles; ++t, ++done) {
    prefetch(t, pre);
    for (int j0 = 0; j0 < nk; j0 += gb) {
      const int n = nk - j0 < gb ? nk - j0 : gb;
      const uint32_t sl = walk.wait();
      fence_regs(x);
      wgmma_fence();
      for (int j = 0; j < n; ++j) {
        const uint32_t at = sl + j * (ownb + kBoxBytes);
        score_box<T>(x, res ? own + (j0 + j) * kBoxBytes : at + wg * kBoxBytes, at + ownb,
                     j0 + j == 0);
      }
      wgmma_commit();
      if (j0 > 0) {
        wgmma_wait_one();
        walk.release(walk.n - 1);
      }
      ++walk.n;
    }
    wgmma_wait_all();
    fence_regs(x);
    walk.release(walk.n - 1);
    epilogue(t, x, pre);
  }

  // the row statistics, by one thread of each quad
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (c == 0) {
    if constexpr (MODE == 0) {
      if (r0 < S) {
        st[r0] = m0;
        st[bhs + r0] = 1.f / l0;
      }
      if (r1 < S) {
        st[r1] = m1;
        st[bhs + r1] = 1.f / l1;
      }
    } else {
      if (r0 < S) st[2 * bhs + r0] = l0;
      if (r1 < S) st[2 * bhs + r1] = l1;
    }
  }
  if (wtid == 0 && pair0 + wg * kBlockRows < S) atomicAdd(&g_wide_score_tiles[MODE], done);
}

// ---- the product kernels ----

// What a product kernel's CTA takes: KIND 0 (O = P V) and KIND 1 (dQ = dS
// K * scale) a block of 64 query rows and two chunks of kChunk columns, one
// a warpgroup; KIND 2 a block of 64 key rows and one chunk of kChunk
// columns, dV = P^T dO in warpgroup 0 and dK = dS^T Q * scale in warpgroup
// 1. Each walks the other side in tiles of 64 rows: a tile brings the
// stored logits' two boxes of 32 keys (KIND 0, 1: the block's rows; KIND
// 2: the tile's query rows at the block's keys), for KIND 1 and 2 the
// stored dP box, and the chunk's boxes of V, K, or dO and Q, all in one
// ring slot.
template <int KIND>
struct Prod {
  static constexpr int kScoreSlots = KIND == 0 ? 2 : 3;  // L's two boxes, dP's
  static constexpr int kTileBoxes = kScoreSlots + 2 * kChunk / kBoxCols;
  // bytes of a tile's slot: its boxes, and KIND 2's query statistics
  static constexpr int kSlot =
      (kTileBoxes * kBoxBytes + (KIND == 2 ? 3 * kTile * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int kNb = kChunk / kBoxCols;  // a chunk's boxes
};

// A k-step of 16 keys (KIND 2: queries) at a time, the A fragment is formed
// from the landed score boxes (P, or dS = P (dP - Delta)) and multiplied
// into each of the warpgroup's chunk boxes read N-major; NB = Prod::kNb.
template <typename T, int KIND, int NB>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_product_kernel(const __grid_constant__ CUtensorMap ml, const __grid_constant__ CUtensorMap mdp,
                    const __grid_constant__ CUtensorMap mb1, const __grid_constant__ CUtensorMap mb2,
                    const float* __restrict__ stats, T* __restrict__ o1, T* __restrict__ o2,
                    const WideSmem sm, int S, int H, int D, float dscale) {
  using P = Prod<KIND>;
  extern __shared__ unsigned char smem_raw[];
  WideBars bars;
  // KIND 2: a slot is complete when its boxes land and the producer's
  // second warp has written the tile's query statistics beside them
  unsigned char* smem = wide_setup(smem_raw, sm, &bars, KIND == 2 ? 2 : 1);
  const uint32_t base = smem_u32(smem);
  const int nk = div_up(D, kBoxCols), SK = score_cols(S), ntiles = SK / kTile;
  // the CTA's block and chunk(s)
  const int ncta = KIND == 2 ? div_up(D, kChunk) : div_up(D, 2 * kChunk);
  const int blk = blockIdx.x / ncta, cj = blockIdx.x % ncta;
  const int r_base = blk * kBlockRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  // chunk c0 / nbc of each warpgroup (KIND 2: both the same)
  auto chunk0 = [&](int w) { return KIND == 2 ? cj * kChunk : (2 * cj + w) * kChunk; };
  auto nbc_of = [&](int w) {
    const int c0 = chunk0(w);
    return c0 < D ? min(P::kNb, nk - c0 / kBoxCols) : 0;
  };

  if (threadIdx.x >= kWideConsumers * kWideWg) {  // the producer: its first thread issues the boxes
    setmaxnreg_dec<kWideProducerRegs>();
    if (threadIdx.x == kWideConsumers * kWideWg) {
      RingFill fill{bars, base + sm.ring_at, sm.slot};
      uint32_t bar;
      const int n0 = nbc_of(0), n1 = nbc_of(1);
      const int nbox = P::kScoreSlots + (KIND == 2 ? 2 * n0 : n0 + n1);
      for (int t = 0; t < ntiles; ++t) {
        // one slot a tile: the stored scores (KIND 0, 1 rows of the block
        // at keys of the tile; KIND 2 query rows of the tile at the
        // block's keys), then the chunks' boxes
        const uint32_t st = fill.next(nbox * kBoxBytes, &bar);
        const int srow = KIND == 2 ? t * kTile : r_base;
        const int scol = KIND == 2 ? r_base : t * kTile;
        for (int x = 0; x < 2; ++x) tma_3d(st + x * kBoxBytes, &ml, bar, scol + 32 * x, srow, bh);
        if (KIND > 0) tma_3d(st + 2 * kBoxBytes, &mdp, bar, scol, srow, bh);
        uint32_t at = st + P::kScoreSlots * kBoxBytes;
        const CUtensorMap* second = KIND == 2 ? &mb2 : &mb1;
        for (int x = 0; x < n0; ++x, at += kBoxBytes)
          tma_4d(at, &mb1, bar, chunk0(0) + x * kBoxCols, h, t * kTile, b);
        for (int x = 0; x < (KIND == 2 ? n0 : n1); ++x, at += kBoxBytes)
          tma_4d(at, second, bar, chunk0(KIND == 2 ? 0 : 1) + x * kBoxCols, h, t * kTile, b);
      }
    } else if (KIND == 2 && threadIdx.x / 32 == kWideConsumers * 4 + 1) {
      // the second producer warp: each tile's m, 1/l and Delta of its 64
      // query rows (+inf, 0, 0 past S) into the slot after its boxes
      const int lane = threadIdx.x % 32;
      const float* stq = stats + (long long)bh * S;
      const long long bhs = (long long)gridDim.z * H * S;
      WideBars wb = bars;
      for (int t = 0; t < ntiles; ++t) {
        const int s_ = t % wb.stages;
        if (t >= wb.stages) mbar_wait_bounded(wb.empty(s_), (t / wb.stages - 1) & 1);
        float* dst = reinterpret_cast<float*>(smem + sm.ring_at + s_ * sm.slot +
                                              P::kTileBoxes * kBoxBytes);
        for (int j = lane; j < kTile; j += 32) {
          const int q = t * kTile + j;
          const bool in = q < S;
          dst[j] = in ? stq[q] : INFINITY;
          dst[kTile + j] = in ? stq[bhs + q] : 0.f;
          dst[2 * kTile + j] = in ? stq[2 * bhs + q] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(wb.full(s_));
      }
    }
    return;
  }
  setmaxnreg_inc<kWideConsumerRegs>();

  const int wg = threadIdx.x / kWideWg, wtid = threadIdx.x % kWideWg;
  const int warp = wtid / 32, lane = wtid % 32, g = lane / 4, c = lane % 4;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // this thread's rows in the block
  const int r0 = r_base + lr0, r1 = r_base + lr1;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* st = stats + (long long)bh * S;
  const int n0 = nbc_of(0), n1 = nbc_of(1), nbc = nbc_of(wg);
  // the warpgroup's first chunk box in a tile's slots, after the score
  // slots: KIND 0, 1 its own chunk's; KIND 2 dO's (warpgroup 0: dV) or
  // Q's (warpgroup 1: dK)
  const int my_box = P::kScoreSlots + (wg ? n0 : 0);

  // KIND 0, 1: the rows' m and 1/l (KIND 1: and Delta; rows >= S take P
  // = 0); KIND 2: the key rows' biases come with the stored logits
  float m0 = 0.f, m1 = 0.f, il0 = 0.f, il1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if constexpr (KIND < 2) {
    const float inf = KIND == 1 ? INFINITY : 0.f;
    m0 = r0 < S ? st[r0] : inf;
    m1 = r1 < S ? st[r1] : inf;
    il0 = r0 < S ? st[bhs + r0] : 0.f;
    il1 = r1 < S ? st[bhs + r1] : 0.f;
    if constexpr (KIND == 1) {
      dl0 = r0 < S ? st[2 * bhs + r0] : 0.f;
      dl1 = r1 < S ? st[2 * bhs + r1] : 0.f;
    }
  }
  float acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  RingWalk walk{bars, base + sm.ring_at, sm.slot};
  const bool grad_k = KIND == 2 && wg == 1;  // dK: dS^T; dV: P^T

  // A tile: its slots landed (both warpgroups wait for all of them), its
  // A fragments formed, a k-step of 16 keys (KIND 2: queries) at a time,
  // from the landed score boxes (P, or dS = P (dP - Delta)), then every
  // product issued (the fragments stay untouched while they run).
  for (int t = 0; t < ntiles; ++t) {
    uint32_t a[kTile / 4];
    const uint32_t sl = walk.wait();  // the tile's slot: box x at x * kBoxBytes
    const unsigned char* lbox0 = smem + (sl - base);
    const unsigned char* lbox1 = lbox0 + kBoxBytes;
    const unsigned char* dbox = lbox0 + (KIND > 0 ? 2 : 0) * kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // columns 16 kk + 8 hh + 2c + e of rows lr0 (a[4 kk + 2 hh]) and
        // lr1 (a[4 kk + 2 hh + 1])
        const int col = 16 * kk + 8 * hh + 2 * c;  // within the tile
        float v[2][2];                             // [row lr0 / lr1][e]
        if constexpr (KIND < 2) {
          // P = 2^(L - m) / l from the stored logits of rows lr0, lr1 at
          // keys col, col + 1 (box col / 32)
          const unsigned char* lb = col < 32 ? lbox0 : lbox1;
          const float2 L0 = *reinterpret_cast<const float2*>(lb + swz_byte(lr0, (col % 32) * 4));
          const float2 L1 = *reinterpret_cast<const float2*>(lb + swz_byte(lr1, (col % 32) * 4));
          v[0][0] = ex2_approx(L0.x - m0) * il0;
          v[0][1] = ex2_approx(L0.y - m0) * il0;
          v[1][0] = ex2_approx(L1.x - m1) * il1;
          v[1][1] = ex2_approx(L1.y - m1) * il1;
          if constexpr (KIND == 1) {
            // dS = P (dP - Delta)
            const uint32_t y0 = *reinterpret_cast<const uint32_t*>(dbox + swz_byte(lr0, col * 2));
            const uint32_t y1 = *reinterpret_cast<const uint32_t*>(dbox + swz_byte(lr1, col * 2));
            const T* t0 = reinterpret_cast<const T*>(&y0);
            const T* t1 = reinterpret_cast<const T*>(&y1);
            v[0][0] *= to_f32(t0[0]) - dl0;
            v[0][1] *= to_f32(t0[1]) - dl0;
            v[1][0] *= to_f32(t1[0]) - dl1;
            v[1][1] *= to_f32(t1[1]) - dl1;
          }
        } else {
          // rows are keys, columns queries: P^T = 2^(L - m_q) / l_q from
          // the stored logits read transposed (query row col + e, key row
          // lr); dK: dS^T = P^T (dP^T - Delta_q)
          const float* qs = reinterpret_cast<const float*>(lbox0 + P::kTileBoxes * kBoxBytes);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lq = col + e;
            const float mq = qs[lq], iq = qs[kTile + lq], dq = qs[2 * kTile + lq];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int kr = rr ? lr1 : lr0;
              const unsigned char* lb = kr < 32 ? lbox0 : lbox1;
              const float L = *reinterpret_cast<const float*>(lb + swz_byte(lq, (kr % 32) * 4));
              const float pv = ex2_approx(L - mq) * iq;
              const T y = *reinterpret_cast<const T*>(dbox + swz_byte(lq, kr * 2));
              v[rr][e] = grad_k ? pv * (to_f32(y) - dq) : pv;
            }
          }
        }
        a[4 * kk + 2 * hh] = pack2(v[0][0], v[0][1], T{});
        a[4 * kk + 2 * hh + 1] = pack2(v[1][0], v[1][1], T{});
      }
    fence_regs(a);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t(&ak)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * kk]);
      // every box of a full chunk, without a branch (wgmma under one is
      // serialized): a box past the chunk's end reads a landed slot of the
      // tile and feeds accumulators that are never stored
#pragma unroll
      for (int x = 0; x < NB; ++x)
        wgmma_rs(box_acc(acc, x), ak,
                 desc_sw128_mn(sl + (x < nbc ? my_box + x : 0) * kBoxBytes + 2048 * kk), T{});
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    walk.release(walk.n++);
  }

  // ---- the warpgroup's chunk: KIND 0 out = O; KIND 1 dq = acc * scale;
  // KIND 2 dv = acc (warpgroup 0), dk = acc * scale (warpgroup 1); rows >=
  // S and columns >= D not stored ----
  T* dst = KIND == 2 && wg == 0 ? o2 : o1;
  const float sc = KIND == 0 || (KIND == 2 && wg == 0) ? 1.f : dscale;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
  const int c0 = chunk0(wg);
#pragma unroll
  for (int i = 0; i < 8 * NB; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + 8 * i + 2 * c + e;
      if (d >= D || i >= 8 * nbc) continue;
      if (r0 < S) dst[head + r0 * HD + d] = from_f32<T>(acc[4 * i + e] * sc);
      if (r1 < S) dst[head + r1 * HD + d] = from_f32<T>(acc[4 * i + 2 + e] * sc);
    }
}

// The opt-in to a block's whole shared memory, once per kernel and
// device (the opt-in belongs to the device; setting it costs host time
// on every call otherwise).
template <typename Kern>
cudaError_t allow_wide_smem(Kern kern) {
  static std::mutex lock;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kern), dev);
  std::lock_guard<std::mutex> guard(lock);
  if (done.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (err == cudaSuccess) done.insert(key);
  return err;
}

// Launch a wide kernel with `sm.bytes` of shared memory.
template <typename Kern, typename... Args>
cudaError_t launch_wide_kernel(Kern kern, const WideSmem& sm, dim3 grid, cudaStream_t stream,
                               Args... args) {
  cudaError_t err = allow_wide_smem(kern);
  if (err != cudaSuccess) return err;
  kern<<<grid, kWideThreads, sm.bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
