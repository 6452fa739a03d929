// Helpers of the bf16/f16 wide-head attention kernels (csrc/mha_wide.cu,
// forward; csrc/mha_wide_bwd.cu, backward): head widths D > 256, which the
// instances of csrc/mha_generic.cu and csrc/mha_bwd.cu do not take (f32
// there is csrc/mha_wide_f32.cu's, which does not use this header).
//
// Every wide kernel contracts Q K^T (and, in the backward, dO V^T) over
// the whole D in k-chunks of KC columns (128, 64 in the dQ kernel): each
// step of a CTA's walk
// over the streamed tiles lands one 64-column sub-tile of its own 64 rows
// and one of the streamed tile's rows in a ring in shared memory, and the
// products of that chunk add into the score accumulators. The output (or
// gradient) columns are split into chunks of DC, one chunk a CTA, so that
// the accumulators fit a thread's registers whatever D is; each chunk's
// CTAs compute the scores again.
//
// Sub-tiles are K-major in wgmma's canonical no-swizzle layout, KC columns
// wide: row r, 16-byte chunk c at (r / 8) * 8 * KC * E + c * 128 + (r % 8)
// * 16. Columns at and past D, and rows at and past S, are zero-filled on
// every load (the ring's buffers are reused for every chunk). The gradient
// and P V products read a chunk of DC columns of the streamed rows as a
// K-major tile of DC columns read N-major through the transpose bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup a CTA
constexpr int kRows = 64;      // the CTA's own rows: wgmma's M
// columns of a k-chunk sub-tile: a step's work (the copies from L2 bound
// the kernels; fewer, larger steps move more bytes a step)
constexpr int kChunkCols = 128;
constexpr int kMinWideD = 257; // the wide kernels take D >= this
constexpr float kLog2e = 1.4426950408889634f;
// shared memory that lets two CTAs share an SM (228 KB, 1 KB reserved a CTA)
constexpr int kTwoCtaBytes = (233472 - 2 * 1024) / 2;

// ring stages that fit `budget` bytes beside `fixed` ones: 2 to 4
constexpr int ring_stages(int fixed, int stage, int budget = kTwoCtaBytes) {
  return (budget - fixed) / stage >= 4 ? 4 : (budget - fixed) / stage >= 3 ? 3 : 2;
}

// The deepest ring of resident-row instances: the stages, up to kMaxRing,
// that fit one block's shared memory beside `fixed` bytes and `own` bytes of
// resident rows (fewer than 2: the rows do not fit, and stream).
constexpr int kMaxRing = 6;
inline int resident_ring(int fixed, int stage, int own) {
  const int n = (232448 - fixed - own) / stage;
  return n > kMaxRing ? kMaxRing : n;
}

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

// wait until the oldest step of a ring of `stages` (2 to kMaxRing) has
// landed: at most stages - 2 groups in flight
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  switch (stages) {
    case 2: cp_async_wait<0>(); break;
    case 3: cp_async_wait<1>(); break;
    case 4: cp_async_wait<2>(); break;
    case 5: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- wgmma, bf16/f16 with f32 accumulators ----

// SS: A and B K-major from shared memory, m64nNk16 (N = 64 or 32 by the
// accumulator's size).
#define RRT_OUT_16(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define RRT_OUT_32(d)                                                                          \
  RRT_OUT_16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RRT_OUT_32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_f16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RRT_OUT_32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : RRT_OUT_16(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_f16(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : RRT_OUT_16(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// RS: A from registers, B from shared memory N-major through the transpose
// bit (m64n64k16 / m64n128k16 by the accumulator's size).

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RRT_OUT_32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RRT_OUT_32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define RRT_OUT_64(d)                                                                           \
  RRT_OUT_32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),             \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),             \
      "+f"(d[62]), "+f"(d[63])

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RRT_OUT_64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RRT_OUT_64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef RRT_OUT_64
#undef RRT_OUT_32
#undef RRT_OUT_16

// qk: the SS products; pv: the RS products; pack: two f32 into the A
// registers' two 16-bit halves (x in the low half).
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
    __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
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
// 8-column groups of an N-major tile are 128 bytes apart, so the rest's
// descriptor starts 32P bytes further.
template <typename T, int M>
__device__ __forceinline__ void pv_wide(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
  static_assert(M % 32 == 0, "columns in products of 64 or 128");
  constexpr int P = M >= 64 ? 64 : 32;
  if constexpr (P == M) {
    Mma<T>::pv(d, a, db);
  } else {
    Mma<T>::pv(*reinterpret_cast<float(*)[P]>(&d[0]), a, db);
    pv_wide<T, M - P>(*reinterpret_cast<float(*)[M - P]>(&d[P]), a, db + ((32 * P) >> 4));
  }
}

// ---- loads ----

// Rows [r0, r0 + R) and columns [c0, c0 + KC) of one head (row stride HD
// elements from `src`, the head's row 0) into a K-major sub-tile at `dst`,
// in G-byte granules; rows >= S and columns >= D zero-filled. The 128
// threads stand as 8 rows x kCols granule columns (x kStep row groups).
template <typename T, int R, int G, int KC>
__device__ __forceinline__ void load_sub_g(uint32_t dst, const T* src, long long HD, int r0,
                                           int c0, int S, int D, int tid) {
  constexpr int E = sizeof(T);
  constexpr int kGran = KC * E / G;               // granules in a row of the sub-tile
  constexpr int kCols = kGran < 16 ? kGran : 16;  // granule columns a pass covers
  constexpr int kStep = 16 / kCols;               // 8-row groups a pass covers
  constexpr int kPasses = R / 8 / kStep;
  static_assert(kPasses >= 1 && (R / 8) % kStep == 0, "sub-tile rows");
  const int cols = D - c0 < KC ? D - c0 : KC;
  const int real = cols * E / G;  // granules of the real columns
  const int r8 = tid % 8, col = (tid / 8) % kCols, rg0 = tid / (8 * kCols);
  const char* zero = reinterpret_cast<const char*>(src);  // read by no copy
#pragma unroll
  for (int gc = col; gc < kGran; gc += kCols) {
    int row = r0 + 8 * rg0 + r8;
    const char* from = reinterpret_cast<const char*>(src + (long long)row * HD + c0) + gc * G;
    uint32_t at = dst + rg0 * (8 * KC * E) + (gc * G / 16) * 128 + r8 * 16 + (gc * G) % 16;
#pragma unroll
    for (int n = 0; n < kPasses; ++n) {
      const bool in = gc < real && row < S;
      if constexpr (G >= 4) {
        cp_async<G>(at, in ? from : zero, in ? G : 0);
      } else {
        const unsigned short x = in ? __ldg(reinterpret_cast<const unsigned short*>(from)) : 0;
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at), "h"(x) : "memory");
      }
      row += 8 * kStep;
      from += 8 * kStep * HD * E;
      at += kStep * (8 * KC * E);
    }
  }
}

template <typename T, int R, int KC = kChunkCols>
__device__ __forceinline__ void load_sub(int gran, uint32_t dst, const T* src, long long HD,
                                         int r0, int c0, int S, int D, int tid) {
  switch (gran) {
    case 16: load_sub_g<T, R, 16, KC>(dst, src, HD, r0, c0, S, D, tid); break;
    case 8: load_sub_g<T, R, 8, KC>(dst, src, HD, r0, c0, S, D, tid); break;
    case 4: load_sub_g<T, R, 4, KC>(dst, src, HD, r0, c0, S, D, tid); break;
    default:
      if constexpr (sizeof(T) == 2) load_sub_g<T, R, 2, KC>(dst, src, HD, r0, c0, S, D, tid);
      break;
  }
}

// Rows [r0, r0 + R) of a head's columns [0, D) (the caller offsets `src`
// to the chunk's first column and passes the chunk's real width as D)
// into a K-major tile DP columns wide, in G-byte granules; rows >= S
// zero-filled, columns >= D not written (they feed only output columns
// that are not stored).
template <typename T, int DP, int R, int G>
__device__ __forceinline__ void load_rows_g(uint32_t dst, const T* src, long long HD, int r0,
                                            int S, int D, int tid) {
  constexpr int E = sizeof(T);
  constexpr int kGran = DP * E / G;
  constexpr int kCols = kGran < 16 ? kGran : 16;
  constexpr int kStep = 16 / kCols;
  constexpr int kPasses = R / 8 / kStep;
  static_assert(kPasses >= 1 && (R / 8) % kStep == 0, "tile rows");
  const int real = D * E / G;
  const int r8 = tid % 8, col = (tid / 8) % kCols, rg0 = tid / (8 * kCols);
  const char* zero = reinterpret_cast<const char*>(src);
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

// One k-chunk's share of a score product X (64 own rows x N streamed rows)
// over the KC columns of the landed sub-tiles: `a` the own rows' sub-tile,
// `b` the streamed rows', SS wgmma into x. `first`: the first chunk, which
// starts the sums. Commits; the caller waits.
template <typename T, int KC = kChunkCols, int N>
__device__ __forceinline__ void chunk_product(float (&x)[N], uint32_t base, int a, int b,
                                              bool first) {
  constexpr int G = 8 * KC * 2;
  const uint64_t da = smem_desc(base + a, 128, G), db = smem_desc(base + b, 128, G);
#pragma unroll
  for (int j = 0; j < KC / 16; ++j) Mma<T>::qk(x, da + 16 * j, db + 16 * j, !first || j > 0);
  wgmma_commit();
}

// the widest copy granule (16, 8, 4 or 2 bytes) that every row of the
// given tensors starts on: their addresses and the head's byte width
// D * itemsize (which divides the head offset h * D and the row stride H * D)
inline int granule(uintptr_t ptrs, int row_bytes) {
  const uintptr_t a = ptrs | (uintptr_t)row_bytes | 16u;
  return (int)(a & (~a + 1));
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  // set on every call: the opt-in belongs to the current device
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
