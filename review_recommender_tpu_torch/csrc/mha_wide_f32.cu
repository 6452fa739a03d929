// Multi-head attention in f32 for Hopper (sm_90a) at head widths past 256,
// forward and backward, on the tensor cores as 3xTF32: softmax(Q K^T *
// 1/sqrt(d) + key_bias) V and its q, k and v gradients, any D >= 257, any
// S >= 1.
//
// Replaces, for f32 past D = 256, the TPU kernel
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_kernel (:64,
// reached through mha_pallas :92) and the backward of its custom_vjp,
// _mha_bwd (:142), which re-runs mha_xla under jax.vjp. ops/attention.py
// sends f32 there (kernel_route "wide", backward_route "wide_tf32"); bf16
// and f16 past 256 columns are csrc/mha_wide.cu's and csrc/mha_wide_bwd.cu's,
// whose header (csrc/mha_wide.cuh) also holds this file's mbarrier, TMA,
// setmaxnreg and tensor-map helpers.
// q, k, v, dout and the outputs are (B, S, H*D) row-major; key_bias (B, S)
// f32 (0 keep, -1e30 drop).
//
// Why the scores live in device memory. A 64-row accumulator of D columns
// does not fit a thread's registers past 256 columns, so the output (and
// gradient) columns go in chunks; if every chunk recomputed the scores, as
// the first f32 design did, S and dP would be contracted over the whole D
// up to seven times a call. Here each is contracted once and written to a
// workspace of B * H * S * SK f32 (SK = S rounded up to 128): at D = 384
// each stored score feeds 2 * D multiply-adds a gradient product (768
// operations per 4 bytes, three times that as 3xTF32), above the card's
// 148 TF32 operations a byte, so the products that read it back stay bound
// by the tensor cores. The TPU kernel holds the same S x S block per (b, h)
// in VMEM, and _mha_bwd materialises the probabilities of the whole batch.
//
// Kernels (each launch counts one call in ops/attention.py):
//   forward   transpose V -> V^T; score (mode 0): L = (q . k) * scale +
//             bias, -inf past S, the running row max and sum, m and 1/l;
//             product (kind 0): O[:, chunk] = sum_k exp(L - m) / l V.
//   backward  transpose K, Q, dO; score (mode 0) as above; score (mode 1):
//             dP = dO V^T, P = exp(L - m) / l written over L, Delta = sum_k
//             P dP; product (kind 1): dQ = dS K * scale; product (kind 2):
//             dK = dS^T Q * scale and dV = P^T dO, dS = P (dP - Delta).
//   Where D % 4 != 0 or a row tensor is not 16-byte aligned, the rows the
//   score kernels read are first copied into rows of D rounded up to 4
//   (csrc/mha_wide.cuh's wide_pad_kernel, which the 16-bit kernels share):
//   the widths that TMA cannot describe.
//
// The score and product kernels are one Hopper shape: a CTA of 128 rows,
// two consumer warpgroups of 64 rows and one producer warpgroup, whose
// first thread keeps TMA boxes in flight through a ring of stages in
// shared memory, each stage completed on a full mbarrier and handed back on
// an empty one. setmaxnreg gives the producer 40 registers a thread and the
// consumers 232: with three warps on a quarter of the SM's register file
// ptxas caps every thread at 168, and the consumers spilled (a producer
// warp alone, 288 threads, caps the same way). Boxes
// are 32 f32 columns (one 128-byte row, 128-byte swizzle) by 128 or 32 rows;
// the 4-D maps over (D, H, S, B) zero-fill past D and past S. The products
// are wgmma m64nNk8 with A from registers: each k-step the consumer loads
// its four A elements from the landed box (swizzled: no bank conflict on
// row-major reads), transforms them (exp and 1/l, or P (dP - Delta)), and
// splits them into hi = tf32(x) and lo = tf32(x - hi). B is the landed box
// itself, which the tensor cores read as TF32 by truncation (hi), and a lo
// box = x - trunc(x) that the producer warpgroup's other three warps write
// as the boxes land (a ready mbarrier a stage), so that each consumer
// warpgroup runs on its own, its softmax and stores beside the other's
// products. A product is a_lo b_hi + a_hi b_lo into one
// accumulator and a_hi b_hi into another (the tensor cores truncate what
// they add, so the scores keep the small terms apart, and the forward adds
// each 32-key step's P V into O in f32); the gradient products take the
// three terms in one accumulator, within their 1e-4. TF32 wgmma has no
// transpose bit, so every B operand must be K-major:
//   S = Q K^T, dP = dO V^T  Q, dO, K, V rows are K-major as they are.
//   O = P V, dQ = dS K      V^T, K^T: the transpose kernel writes V^T (K^T)
//                           per (b, h) as D rows of SK keys, zero past S.
//   dK = dS^T Q, dV = P^T dO  Q^T, dO^T likewise; A = P^T and dS^T come
//                           from the stored [q][k] boxes read transposed
//                           into registers (two-way bank conflicts).
// Bytes at (64, 512, 1, 384): forward L 67.1 MB and V^T 50.3 MB; backward P
// and dP 134.2 MB, K^T, Q^T and dO^T 151.0 MB; the wrapper slices the
// batch so that one slice's workspace stays under a cap.
//
// What bounds it on an H100 SXM (published peaks at 700 W) at (64, 512, 1,
// 384): forward Q K^T and P V, 25.8 GFLOP at the f32-exact 495 / 3 TFLOP/s,
// 0.156 ms; the workspace's 67 MB written and read, 0.040 ms at 3.35 TB/s;
// backward the five products, 64.4 GFLOP, 0.390 ms; the workspace's writes
// and reads (P and dP once by each gradient kernel, 3 chunks each), about
// 0.2 ms spread over the kernels. Measured there (examples/
// torch_attention_ab.py --kernel wide_heads, H100 at 700 W; PERF.md):
// forward 0.42-0.47 ms, backward 1.12-1.20, against 1.81-1.84 / 10.62 for
// the first design's f32 instances of csrc/mha_wide.cu / mha_wide_bwd.cu
// in the same call; with the products taken out the backward still takes
// 0.78 of 1.13 ms (examples/torch_attention_backward.py --breakdown): the
// consumers' own work (A fragments loaded, transformed and split, the
// stores) sets the time, not the tensor cores or the copies. Three
// changes took it there: setmaxnreg (the consumers spilled at 168
// registers), the producer's split of the B boxes (the consumers had split
// them together, in lockstep), and the dP kernel loading a tile's logits
// before overwriting them (in series, one load at a time, before).
//
// Roundings: the logits (q . k) * scale, then + bias, each rounded alone,
// exp by expf and a multiply by 1/l, as the plain version and the other f32
// routes (mha_reference); dS = P (dP - Delta) with Delta = sum_k P dP, the
// gradients scaled once at the end.
//
// Semantics:
//   - an all-masked row (every bias -1e30) comes out uniform over the S
//     real keys: (q.k)*scale - 1e30 == -1e30 in f32;
//   - keys from S to SK get logit -inf (P = 0) and zero K, V rows;
//   - query rows >= S are not stored, and add nothing to dK or dV (their P
//     and dP boxes are zero-filled, their Delta taken as 0).
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given and the C entries return cudaGetLastError().

#include "mha_wide.cuh"

namespace {

constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kConsumers = 2 * kWg;        // the two consumer warpgroups
constexpr int kThreads = kConsumers + kWg;  // and the producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 64K
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the producer warpgroup's warps 1-3 form the landed B boxes' lo
constexpr int kSplitters = kWg - 32;
constexpr int kRows = 64;                  // rows of a consumer warpgroup: wgmma's M
constexpr int kBlock = 2 * kRows;          // rows of a CTA
constexpr int kKc = 32;                    // f32 columns of a 128-byte swizzled row
constexpr int kDc = 128;                   // output columns of a product CTA
constexpr int kKeyPad = 128;               // the workspace's key rows padded to this
constexpr int kBox = kBlock * kKc * 4;     // a 128-row box: 16 KB
constexpr int kSubBox = kKc * kKc * 4;     // a 32-row box: 4 KB
constexpr int kMaxSmem = 232448;

// the four warps of consumer warpgroup wg meet (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWg) : "memory");
}

// byte offset of (row r, column x < 32) in a box of 128-byte swizzled rows
__device__ __forceinline__ int swz(int r, int x) {
  return r * 128 + ((((x >> 2) ^ (r & 7)) << 4) | ((x & 3) << 2));
}

__device__ __forceinline__ float box_at(const unsigned char* box, int r, int x) {
  return *reinterpret_cast<const float*>(box + swz(r, x));
}

// x rounded to TF32 by dropping its low 13 bits: how the tensor cores read
// an f32 operand in shared memory
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// lo = x - trunc(x) of a landed box (exact in f32), written at the same
// offsets of the lo box; the kSplitters threads take 16 bytes each a pass
template <int kBytes>
__device__ __forceinline__ void split_lo(const unsigned char* raw, unsigned char* lo, int t) {
#pragma unroll 4
  for (int off = 16 * t; off < kBytes; off += 16 * kSplitters) {
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(x.x - tf32_trunc(x.x), x.y - tf32_trunc(x.y), x.z - tf32_trunc(x.z),
                    x.w - tf32_trunc(x.w));
  }
}

// an A fragment's hi and lo (tf32_hi: round to nearest; lo rounded too)
__device__ __forceinline__ void split_frag(const float (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_hi(x[e]);
    lo[e] = tf32_rna(x[e] - __uint_as_float(hi[e]));
  }
}

// one k-step of a 3xTF32 product: sm += a_lo b + a_hi b_lo, hh += a_hi b
// (b read as TF32 by truncation); scale_d = 0 starts both sums. sm and hh
// may be one array.
template <int N>
__device__ __forceinline__ void mma3(float (&hh)[N], float (&sm)[N], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t db, uint64_t dblo,
                                     int scale_d) {
  wgmma_rs_tf32(sm, lo, db, scale_d);
  wgmma_rs_tf32(sm, hi, dblo, 1);
  wgmma_rs_tf32(hh, hi, db, scale_d);
}

// the producer warpgroup gives registers back, the consumers take them
__device__ __forceinline__ void producer_regs() { setmaxnreg_dec<kProducerRegs>(); }
__device__ __forceinline__ void consumer_regs() { setmaxnreg_inc<kConsumerRegs>(); }

// The ring's barriers, 8 bytes each, after the stages: full[kStages] (the
// boxes landed), ready[kStages] (their lo formed), empty[kStages] (both
// consumer warpgroups done with the stage).
template <int kStages, int kStage>
struct Ring {
  uint32_t at;
  __device__ __forceinline__ uint32_t full(int s) const { return at + 8 * s; }
  __device__ __forceinline__ uint32_t ready(int s) const { return at + 8 * (kStages + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return at + 8 * (2 * kStages + s); }
  static constexpr int kBytes = kStages * kStage + 24 * kStages;
};

// The CTA's shared memory, aligned to the 1024 bytes of the swizzle's
// period; thread 0 sets up the ring's barriers.
template <int kStages, int kStage>
__device__ __forceinline__ unsigned char* ring_setup(unsigned char* raw, Ring<kStages, kStage>* ring) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  ring->at = smem_u32(smem) + kStages * kStage;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring->full(s), 1);
      mbar_init(ring->ready(s), kSplitters);
      mbar_init(ring->empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem;
}

// ---- score kernel ----

constexpr int kScoreStages = 4;
constexpr int kScoreStage = 3 * kBox;  // own rows' box, key rows' box, its lo

// MODE 0: S = Q K^T over the whole D (ma = Q's rows, mb = K's), logits L =
// (s * scale) + bias (-inf past S) to `sc`, the running row max and sum, m
// and 1/l to stats. MODE 1: dP = dO V^T (ma = dO, mb = V) to `dpw`; P =
// exp(L - m) / l written over L; Delta = sum_k P dP to stats. A CTA takes
// 128 query rows of one (b, h) and walks the keys in tiles of 128, each
// contracted in steps of 32 columns; warpgroup w owns rows 64w..64w+63.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
wide_f32_score_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                      const float* __restrict__ key_bias, float* __restrict__ sc,
                      float* __restrict__ dpw, float* __restrict__ stats, int S, int H, int D,
                      int SK, float scale) {
  using R = Ring<kScoreStages, kScoreStage>;
  extern __shared__ unsigned char smem_raw[];
  R ring;
  unsigned char* smem = ring_setup(smem_raw, &ring);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int nkc = (D + kKc - 1) / kKc, nsteps = nkc * (SK / kBlock);

  if (tid >= kConsumers) {  // the producer warpgroup: its first thread issues the boxes
    producer_regs();
    const int ptid = tid - kConsumers;
    if (ptid == 0) {
      for (int u = 0; u < nsteps; ++u) {
        const int s = u % kScoreStages, t = u / nkc, j = u % nkc;
        if (u >= kScoreStages) mbar_wait(ring.empty(s), (u / kScoreStages - 1) & 1);
        mbar_expect_tx(ring.full(s), 2 * kBox);
        const uint32_t st = base + s * kScoreStage;
        tma_4d(st, &ma, ring.full(s), j * kKc, h, q0, b);
        tma_4d(st + kBox, &mb, ring.full(s), j * kKc, h, t * kBlock, b);
      }
    } else if (ptid >= 32) {  // warps 1-3: the key rows' lo
      for (int u = 0; u < nsteps; ++u) {
        const int s = u % kScoreStages;
        mbar_wait(ring.full(s), (u / kScoreStages) & 1);
        unsigned char* st = smem + s * kScoreStage;
        split_lo<kBox>(st + kBox, st + 2 * kBox, ptid - 32);
        fence_async_smem();
        mbar_arrive(ring.ready(s));
      }
    }
    return;
  }
  consumer_regs();

  const int wg = tid / kWg, warp = (tid % kWg) / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int arow = wg * kRows + warp * 16 + g;  // this thread's rows in the box: arow, arow + 8
  const int r0 = q0 + arow, r1 = r0 + 8;
  const long long bh = (long long)b * H + h, bhs = (long long)gridDim.z * H * S;
  float* srow = sc + bh * S * SK;  // this head's L (P): row r at r * SK
  float* drow = MODE == 1 ? dpw + bh * S * SK : nullptr;
  float* st = stats + bh * S;      // m; 1/l bhs further; Delta 2 bhs further
  const float* brow = key_bias + (long long)b * S;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if constexpr (MODE == 1) {  // m, 1/l; l0, l1 become Delta
    m0 = r0 < S ? st[r0] : 0.f;
    m1 = r1 < S ? st[r1] : 0.f;
  }
  const float il0 = MODE == 1 && r0 < S ? st[bhs + r0] : 0.f;
  const float il1 = MODE == 1 && r1 < S ? st[bhs + r1] : 0.f;
  float hh[64], sm[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) hh[i] = sm[i] = 0.f;

  for (int u = 0; u < nsteps; ++u) {
    const int s = u % kScoreStages, t = u / nkc, j = u % nkc;
    mbar_wait(ring.full(s), (u / kScoreStages) & 1);
    mbar_wait(ring.ready(s), (u / kScoreStages) & 1);
    const unsigned char* box = smem + s * kScoreStage;
    const uint32_t bb = base + s * kScoreStage + kBox;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float x[4] = {box_at(box, arow, 8 * kk + c), box_at(box, arow + 8, 8 * kk + c),
                          box_at(box, arow, 8 * kk + c + 4), box_at(box, arow + 8, 8 * kk + c + 4)};
      split_frag(x, ahi[kk], alo[kk]);
      fence_regs(ahi[kk]);
      fence_regs(alo[kk]);
    }
    fence_regs(hh);
    fence_regs(sm);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3(hh, sm, ahi[kk], alo[kk], desc_sw128(bb + 32 * kk), desc_sw128(bb + kBox + 32 * kk),
           j > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(hh);
    fence_regs(sm);
    warpgroup_sync(wg);  // this warpgroup is done with stage s
    if (tid % kWg == 0) mbar_arrive(ring.empty(s));
    if (j < nkc - 1) continue;

    // ---- key tile t is complete: columns 8i + 2c + e of rows r0 (elements
    // 4i + e) and r1 (4i + 2 + e) ----
    if constexpr (MODE == 0) {
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * kBlock + 8 * i + 2 * c + e;
          const float bias = key < S ? brow[key] : 0.f;
          const float x0 = __fadd_rn(__fmul_rn(hh[4 * i + e] + sm[4 * i + e], scale), bias);
          const float x1 = __fadd_rn(__fmul_rn(hh[4 * i + 2 + e] + sm[4 * i + 2 + e], scale), bias);
          hh[4 * i + e] = key < S ? x0 : -INFINITY;
          hh[4 * i + 2 + e] = key < S ? x1 : -INFINITY;
          mx0 = fmaxf(mx0, hh[4 * i + e]);
          mx1 = fmaxf(mx1, hh[4 * i + 2 + e]);
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = t * kBlock + 8 * i + 2 * c;
        if (r0 < S)
          *reinterpret_cast<float2*>(srow + (long long)r0 * SK + key) =
              make_float2(hh[4 * i], hh[4 * i + 1]);
        if (r1 < S)
          *reinterpret_cast<float2*>(srow + (long long)r1 * SK + key) =
              make_float2(hh[4 * i + 2], hh[4 * i + 3]);
      }
      // running row max and sum; tile 0 holds key 0 (finite bias), so the
      // max is finite and exp(-inf - mx) = 0 clears the empty sums
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      l0 *= expf(m0 - mx0);
      l1 *= expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        l0 += expf(hh[4 * i] - m0) + expf(hh[4 * i + 1] - m0);
        l1 += expf(hh[4 * i + 2] - m1) + expf(hh[4 * i + 3] - m1);
      }
    } else {
      // the tile's logits first, all loads in flight together (each is
      // overwritten by its P below, so the compiler would not hoist them)
      float2 lx0[16], lx1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = t * kBlock + 8 * i + 2 * c;
        lx0[i] = r0 < S ? *reinterpret_cast<const float2*>(srow + (long long)r0 * SK + key)
                        : make_float2(0.f, 0.f);
        lx1[i] = r1 < S ? *reinterpret_cast<const float2*>(srow + (long long)r1 * SK + key)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = t * kBlock + 8 * i + 2 * c;
        const float2 dp0 = make_float2(hh[4 * i] + sm[4 * i], hh[4 * i + 1] + sm[4 * i + 1]);
        const float2 dp1 =
            make_float2(hh[4 * i + 2] + sm[4 * i + 2], hh[4 * i + 3] + sm[4 * i + 3]);
        if (r0 < S) {
          float2* at = reinterpret_cast<float2*>(srow + (long long)r0 * SK + key);
          const float2 x = lx0[i];
          const float2 p = make_float2(expf(x.x - m0) * il0, expf(x.y - m0) * il0);
          *at = p;
          *reinterpret_cast<float2*>(drow + (long long)r0 * SK + key) = dp0;
          l0 = fmaf(p.x, dp0.x, l0);
          l0 = fmaf(p.y, dp0.y, l0);
        }
        if (r1 < S) {
          float2* at = reinterpret_cast<float2*>(srow + (long long)r1 * SK + key);
          const float2 x = lx1[i];
          const float2 p = make_float2(expf(x.x - m1) * il1, expf(x.y - m1) * il1);
          *at = p;
          *reinterpret_cast<float2*>(drow + (long long)r1 * SK + key) = dp1;
          l1 = fmaf(p.x, dp1.x, l1);
          l1 = fmaf(p.y, dp1.y, l1);
        }
      }
    }
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
}

// ---- product kernels ----

// KIND 0: O = P V, P = exp(L - m) / l from the logits; 1: dQ = dS K *
// scale, dS = P (dP - Delta_row); 2: dK = dS^T Q * scale and dV = P^T dO,
// dS^T = P^T (dP^T - Delta_col). A CTA takes 128 rows (queries for 0 and
// 1, keys for 2) and kDc output columns, and walks the other side in steps
// of 32. A stage: the A boxes (L, or P and dP; kind 2 four 32-key boxes of
// 32 query rows each), then each B box (V^T, K^T, or dO^T and Q^T: kDc rows
// of the transposed copy by 32) and its lo.
template <int KIND>
struct ProdPlan {
  static constexpr int kA = KIND == 0 ? 1 : 2;  // A tensors
  static constexpr int kB = KIND == 2 ? 2 : 1;  // B tensors
  static constexpr int kStage = kA * kBox + 2 * kB * kBox;
  static constexpr int kStages = (kMaxSmem - 1024 - 256) / kStage;
  static constexpr int kTx = (kA + kB) * kBox;  // bytes TMA lands a step
  __host__ __device__ static constexpr int b_at(int i) { return kA * kBox + 2 * i * kBox; }
  static constexpr int kSmem = kStages * kStage + 24 * kStages + 1024;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "shared memory of one block");
};

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
wide_f32_product_kernel(const __grid_constant__ CUtensorMap mp, const __grid_constant__ CUtensorMap mdp,
                        const __grid_constant__ CUtensorMap mb1, const __grid_constant__ CUtensorMap mb2,
                        const float* __restrict__ stats, float* __restrict__ o1,
                        float* __restrict__ o2, int S, int H, int D, float dscale) {
  using P = ProdPlan<KIND>;
  using R = Ring<P::kStages, P::kStage>;
  extern __shared__ unsigned char smem_raw[];
  R ring;
  unsigned char* smem = ring_setup(smem_raw, &ring);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int nch = (D + kDc - 1) / kDc;
  const int r_base = (blockIdx.x / nch) * kBlock, c0 = (blockIdx.x % nch) * kDc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int nsteps = (S + kKc - 1) / kKc;

  if (tid >= kConsumers) {  // the producer warpgroup: its first thread issues the boxes
    producer_regs();
    const int ptid = tid - kConsumers;
    if (ptid >= 32) {  // warps 1-3: the B boxes' lo
      for (int u = 0; u < nsteps; ++u) {
        const int s = u % P::kStages;
        mbar_wait(ring.full(s), (u / P::kStages) & 1);
        unsigned char* st = smem + s * P::kStage;
#pragma unroll
        for (int i = 0; i < P::kB; ++i)
          split_lo<kBox>(st + P::b_at(i), st + P::b_at(i) + kBox, ptid - 32);
        fence_async_smem();
        mbar_arrive(ring.ready(s));
      }
    }
    if (ptid == 0) {
      for (int u = 0; u < nsteps; ++u) {
        const int s = u % P::kStages;
        if (u >= P::kStages) mbar_wait(ring.empty(s), (u / P::kStages - 1) & 1);
        mbar_expect_tx(ring.full(s), P::kTx);
        const uint32_t st = base + s * P::kStage;
        if constexpr (KIND == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tma_3d(st + i * kSubBox, &mp, ring.full(s), r_base + kKc * i, u * kKc, bh);
            tma_3d(st + kBox + i * kSubBox, &mdp, ring.full(s), r_base + kKc * i, u * kKc, bh);
          }
          tma_3d(st + P::b_at(1), &mb2, ring.full(s), u * kKc, c0, bh);
        } else {
          tma_3d(st, &mp, ring.full(s), u * kKc, r_base, bh);
          if constexpr (KIND == 1) tma_3d(st + kBox, &mdp, ring.full(s), u * kKc, r_base, bh);
        }
        tma_3d(st + P::b_at(0), &mb1, ring.full(s), u * kKc, c0, bh);
      }
    }
    return;
  }
  consumer_regs();

  const int wg = tid / kWg, warp = (tid % kWg) / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int arow = wg * kRows + warp * 16 + g;  // this thread's rows: arow, arow + 8
  const int r0 = r_base + arow, r1 = r0 + 8;
  const long long bhs = (long long)gridDim.z * H * S;
  const float* st = stats + (long long)bh * S;
  // row statistics: kind 0 m and 1/l, kind 1 Delta (rows >= S: P = 0)
  const float m0 = KIND == 0 && r0 < S ? st[r0] : 0.f;
  const float m1 = KIND == 0 && r1 < S ? st[r1] : 0.f;
  const float il0 = KIND == 0 && r0 < S ? st[bhs + r0] : 0.f;
  const float il1 = KIND == 0 && r1 < S ? st[bhs + r1] : 0.f;
  const float dl0 = KIND == 1 && r0 < S ? st[2 * bhs + r0] : 0.f;
  const float dl1 = KIND == 1 && r1 < S ? st[2 * bhs + r1] : 0.f;
  float acc1[64], acc2[KIND == 2 ? 64 : 1];  // kind 0: O; 1: dQ; 2: dK, dV
#pragma unroll
  for (int i = 0; i < 64; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (KIND == 2 ? 64 : 1); ++i) acc2[i] = 0.f;

  for (int u = 0; u < nsteps; ++u) {
    const int s = u % P::kStages;
    mbar_wait(ring.full(s), (u / P::kStages) & 1);
    mbar_wait(ring.ready(s), (u / P::kStages) & 1);
    const unsigned char* box = smem + s * P::kStage;
    const uint32_t b1 = base + s * P::kStage + P::b_at(0);
    if constexpr (KIND == 0) {
      // P = exp(L - m) / l; each half of the chunk's columns as its own
      // 32-key product (small terms apart), added to O in f32
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int x0 = 8 * kk + c, x1 = x0 + 4;
        const float x[4] = {expf(box_at(box, arow, x0) - m0) * il0,
                            expf(box_at(box, arow + 8, x0) - m1) * il1,
                            expf(box_at(box, arow, x1) - m0) * il0,
                            expf(box_at(box, arow + 8, x1) - m1) * il1};
        split_frag(x, ahi[kk], alo[kk]);
        fence_regs(ahi[kk]);
        fence_regs(alo[kk]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float pv[32], pv_sm[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) pv[i] = pv_sm[i] = 0.f;
        fence_regs(pv);
        fence_regs(pv_sm);
        wgmma_fence();
        const uint32_t bh_half = b1 + hf * (kDc / 2) * 128;  // rows 64 hf.. of the box
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(pv, pv_sm, ahi[kk], alo[kk], desc_sw128(bh_half + 32 * kk),
               desc_sw128(bh_half + kBox + 32 * kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(pv);
        fence_regs(pv_sm);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc1[32 * hf + i] += pv[i] + pv_sm[i];
      }
    } else if constexpr (KIND == 1) {
      // dS = P (dP - Delta); dQ += dS K (three terms, one accumulator)
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int x0 = 8 * kk + c, x1 = x0 + 4;
        const unsigned char* pb = box;
        const unsigned char* db = box + kBox;
        const float x[4] = {box_at(pb, arow, x0) * (box_at(db, arow, x0) - dl0),
                            box_at(pb, arow + 8, x0) * (box_at(db, arow + 8, x0) - dl1),
                            box_at(pb, arow, x1) * (box_at(db, arow, x1) - dl0),
                            box_at(pb, arow + 8, x1) * (box_at(db, arow + 8, x1) - dl1)};
        split_frag(x, ahi[kk], alo[kk]);
        fence_regs(ahi[kk]);
        fence_regs(alo[kk]);
      }
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma3(acc1, acc1, ahi[kk], alo[kk], desc_sw128(b1 + 32 * kk),
             desc_sw128(b1 + kBox + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc1);
    } else {
      // rows are keys, the contraction runs over this step's 32 queries:
      // P^T and dS^T = P^T (dP^T - Delta_q) read transposed from the [q][k]
      // boxes (key row kr in 32-key box kr / 32, column kr % 32)
      const int sub = (arow / kKc) * kSubBox, kx = arow % kKc;
      const unsigned char* pb = box + sub;
      const unsigned char* db = box + kBox + sub;
      const float* delta = st + 2 * bhs + u * kKc;  // the step's Delta by query
      uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int q0 = 8 * kk + c, q1 = q0 + 4;
        const float d0 = u * kKc + q0 < S ? delta[q0] : 0.f;
        const float d1 = u * kKc + q1 < S ? delta[q1] : 0.f;
        const float p[4] = {box_at(pb, q0, kx), box_at(pb, q0, kx + 8), box_at(pb, q1, kx),
                            box_at(pb, q1, kx + 8)};
        const float ds[4] = {p[0] * (box_at(db, q0, kx) - d0), p[1] * (box_at(db, q0, kx + 8) - d0),
                             p[2] * (box_at(db, q1, kx) - d1), p[3] * (box_at(db, q1, kx + 8) - d1)};
        split_frag(p, phi[kk], plo[kk]);
        split_frag(ds, shi[kk], slo[kk]);
        fence_regs(phi[kk]);
        fence_regs(plo[kk]);
        fence_regs(shi[kk]);
        fence_regs(slo[kk]);
      }
      const uint32_t b2 = base + s * P::kStage + P::b_at(1);
      fence_regs(acc1);
      fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma3(acc2, acc2, phi[kk], plo[kk], desc_sw128(b1 + 32 * kk),
             desc_sw128(b1 + kBox + 32 * kk), 1);
        mma3(acc1, acc1, shi[kk], slo[kk], desc_sw128(b2 + 32 * kk),
             desc_sw128(b2 + kBox + 32 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc1);
      fence_regs(acc2);
    }
    warpgroup_sync(wg);  // this warpgroup is done with stage s
    if (tid % kWg == 0) mbar_arrive(ring.empty(s));
  }

  // ---- o1 (O, dQ or dK) and o2 (dV) at columns c0 + 8i + 2c + e; rows >=
  // S and columns >= D not stored ----
  const float s1 = KIND == 0 ? 1.f : dscale;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;
#pragma unroll
  for (int i = 0; i < kDc / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + 8 * i + 2 * c + e;
      if (d >= D) continue;
      if (r0 < S) {
        o1[head + r0 * HD + d] = acc1[4 * i + e] * s1;
        if constexpr (KIND == 2) o2[head + r0 * HD + d] = acc2[4 * i + e];
      }
      if (r1 < S) {
        o1[head + r1 * HD + d] = acc1[4 * i + 2 + e] * s1;
        if constexpr (KIND == 2) o2[head + r1 * HD + d] = acc2[4 * i + 2 + e];
      }
    }
}

// ---- layout kernels ----

// X^T of one (B, S, H*D) tensor: per (b, h) D rows of SK keys, zero at keys
// >= S, through a 32 x 32 tile in shared memory (reads along D, writes
// along the keys); grid (key tiles x column tiles, H, B)
__global__ void __launch_bounds__(256)
wide_f32_transpose_kernel(const float* __restrict__ src, float* __restrict__ dst, int S, int H,
                          int D, int SK) {
  __shared__ float tile[32][33];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const int nst = SK / 32;
  const int s0 = (blockIdx.x % nst) * 32, d0 = (blockIdx.x / nst) * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int s = s0 + i, d = d0 + tx;
    tile[i][tx] = s < S && d < D ? src[((long long)b * S + s) * H * D + (long long)h * D + d] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int d = d0 + i;
    if (d < D) dst[(bh * D + d) * SK + s0 + tx] = tile[tx][i];
  }
}

// ---- host side ----

// a (B, S, H*Dst) tensor's heads as 4-D (D, H, S, B), box 32 columns x 128
// rows: zero past D and past S
bool map_rows(CUtensorMap* map, const void* p, int B, int S, int H, int D, int Dst) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dst * 4, (cuuint64_t)H * Dst * 4,
                                 (cuuint64_t)S * H * Dst * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kKc, 1u, (cuuint32_t)kBlock, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p, dims, strides, box);
}

// (outer, rows, inner) f32, box 32 inner x box_rows rows: the scores
// (B*H, S, SK) and the transposed copies (B*H, D, SK)
bool map_3d(CUtensorMap* map, const float* p, int inner, int rows, int outer, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)rows * inner * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kKc, (cuuint32_t)box_rows, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p, dims, strides, box);
}

long long round64(long long n) { return (n + 63) / 64 * 64; }

int key_pad(int S) { return (S + kKeyPad - 1) / kKeyPad * kKeyPad; }

// The workspace's regions in floats (each a multiple of 64, so that every
// region starts 256-byte aligned): scores (L, or P and dP), the row
// statistics, the transposed copies, and the padded rows where asked for.
struct Ws {
  long long score, stats, trans, rows;
  int n_score, n_trans, n_rows;
  Ws(bool backward, int B, int S, int H, int D, bool padded) {
    const long long bh = (long long)B * H;
    score = round64(bh * S * key_pad(S));
    stats = round64((backward ? 3 : 2) * bh * S);
    trans = round64(bh * D * key_pad(S));
    rows = padded ? round64((long long)B * S * H * row_pad(D, 4)) : 0;
    n_score = backward ? 2 : 1;
    n_trans = backward ? 3 : 1;
    n_rows = backward ? 4 : 2;
  }
  long long floats() const { return n_score * score + stats + n_trans * trans + n_rows * rows; }
  float* score_at(float* ws, int i) const { return ws + i * score; }
  float* stats_at(float* ws) const { return ws + n_score * score; }
  float* trans_at(float* ws, int i) const { return stats_at(ws) + stats + i * trans; }
  float* rows_at(float* ws, int i) const { return trans_at(ws, n_trans) + i * rows; }
};

bool args_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && H > 0 && D >= kMinWideD && B <= 65535 && H <= 65535;
}


cudaError_t transpose(const void* src, float* dst, int B, int S, int H, int D, cudaStream_t stream) {
  const int SK = key_pad(S);
  wide_f32_transpose_kernel<<<dim3(SK / 32 * ((D + 31) / 32), H, B), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(src), dst, S, H, D, SK);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_score(const CUtensorMap& ma, const CUtensorMap& mb, const float* bias,
                         float* sc, float* dpw, float* stats, int B, int S, int H, int D,
                         cudaStream_t stream) {
  constexpr int smem = Ring<kScoreStages, kScoreStage>::kBytes + 1024;
  static_assert(smem <= kMaxSmem, "shared memory of one block");
  cudaError_t err = allow_smem(wide_f32_score_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  wide_f32_score_kernel<MODE><<<dim3((S + kBlock - 1) / kBlock, H, B), kThreads, smem, stream>>>(
      ma, mb, bias, sc, dpw, stats, S, H, D, key_pad(S), scale);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_product(const CUtensorMap& mp, const CUtensorMap& mdp, const CUtensorMap& mb1,
                           const CUtensorMap& mb2, const float* stats, void* o1, void* o2, int B,
                           int S, int H, int D, cudaStream_t stream) {
  using P = ProdPlan<KIND>;
  cudaError_t err = allow_smem(wide_f32_product_kernel<KIND>, P::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (S + kBlock - 1) / kBlock, nch = (D + kDc - 1) / kDc;
  wide_f32_product_kernel<KIND><<<dim3(blocks * nch, H, B), kThreads, P::kSmem, stream>>>(
      mp, mdp, mb1, mb2, stats, static_cast<float*>(o1), static_cast<float*>(o2), S, H, D,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace a call takes (backward 0 or 1; padded 1 where the
// rows are copied: D % 4 != 0 or a row tensor not 16-byte aligned).
extern "C" long long rrt_mha_wide_f32_ws_floats(int backward, int B, int S, int H, int D,
                                                int padded) {
  return Ws(backward != 0, B, S, H, D, padded != 0).floats();
}

// The output (and gradient) columns a CTA of the product kernels takes.
extern "C" int rrt_mha_wide_f32_dc() { return kDc; }

// Forward. q, k, v, out (B, S, H*D) f32 contiguous; key_bias (B, S) f32
// contiguous; ws rrt_mha_wide_f32_ws_floats(0, ...) floats, 256-byte
// aligned; padded as the workspace was sized (0 only where rows_in_place).
// D >= 257; B, H <= 65535. Returns a cudaError_t (0 = launched).
extern "C" int rrt_mha_wide_f32(const void* q, const void* k, const void* v, const void* key_bias,
                                void* out, void* ws, int B, int S, int H, int D, int padded,
                                void* stream) {
  const void* src[2] = {q, k};
  if (!args_ok(B, S, H, D) || (!padded && !rows_in_place(D, 4, src, 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const Ws lay(false, B, S, H, D, padded != 0);
  const int SK = key_pad(S);
  void* const dst[2] = {lay.rows_at(w, 0), lay.rows_at(w, 1)};
  const void* rows[2];
  const int Dst = wide_rows<float>(rows, src, dst, 2, (long long)B * S * H, D, D, padded != 0, st);
  float* vt = lay.trans_at(w, 0);
  cudaError_t err = transpose(v, vt, B, S, H, D, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, ml, mvt;
  float* sc = lay.score_at(w, 0);
  float* stats = lay.stats_at(w);
  if (!map_rows(&mq, rows[0], B, S, H, D, Dst) || !map_rows(&mk, rows[1], B, S, H, D, Dst) ||
      !map_3d(&ml, sc, SK, S, B * H, kBlock) || !map_3d(&mvt, vt, SK, D, B * H, kDc))
    return (int)cudaErrorInvalidValue;
  err = launch_score<0>(mq, mk, static_cast<const float*>(key_bias), sc, nullptr, stats, B, S, H,
                        D, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_product<0>(ml, ml, mvt, mvt, stats, out, nullptr, B, S, H, D, st);
}

// Backward: dq, dk, dv of the forward at (q, k, v, key_bias) against dout
// (the gradient of its output); all (B, S, H*D) f32 contiguous; ws
// rrt_mha_wide_f32_ws_floats(1, ...) floats. Same domain as the forward.
extern "C" int rrt_mha_wide_f32_bwd(const void* q, const void* k, const void* v,
                                    const void* key_bias, const void* dout, void* dq, void* dk,
                                    void* dv, void* ws, int B, int S, int H, int D, int padded,
                                    void* stream) {
  const void* src[4] = {q, k, v, dout};
  if (!args_ok(B, S, H, D) || (!padded && !rows_in_place(D, 4, src, 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const Ws lay(true, B, S, H, D, padded != 0);
  const int SK = key_pad(S);
  void* const dst[4] = {lay.rows_at(w, 0), lay.rows_at(w, 1), lay.rows_at(w, 2), lay.rows_at(w, 3)};
  const void* rows[4];
  const int Dst = wide_rows<float>(rows, src, dst, 4, (long long)B * S * H, D, D, padded != 0, st);
  float* kt = lay.trans_at(w, 0);
  float* qt = lay.trans_at(w, 1);
  float* ot = lay.trans_at(w, 2);
  cudaError_t err = transpose(k, kt, B, S, H, D, st);
  if (err == cudaSuccess) err = transpose(q, qt, B, S, H, D, st);
  if (err == cudaSuccess) err = transpose(dout, ot, B, S, H, D, st);
  if (err != cudaSuccess) return (int)err;
  float* sc = lay.score_at(w, 0);
  float* dpw = lay.score_at(w, 1);
  float* stats = lay.stats_at(w);
  CUtensorMap mq, mk, mv, mo, mp, mdp, mp32, mdp32, mkt, mqt, mot;
  if (!map_rows(&mq, rows[0], B, S, H, D, Dst) || !map_rows(&mk, rows[1], B, S, H, D, Dst) ||
      !map_rows(&mv, rows[2], B, S, H, D, Dst) || !map_rows(&mo, rows[3], B, S, H, D, Dst) ||
      !map_3d(&mp, sc, SK, S, B * H, kBlock) || !map_3d(&mdp, dpw, SK, S, B * H, kBlock) ||
      !map_3d(&mp32, sc, SK, S, B * H, kKc) || !map_3d(&mdp32, dpw, SK, S, B * H, kKc) ||
      !map_3d(&mkt, kt, SK, D, B * H, kDc) || !map_3d(&mqt, qt, SK, D, B * H, kDc) ||
      !map_3d(&mot, ot, SK, D, B * H, kDc))
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(key_bias);
  err = launch_score<0>(mq, mk, bias, sc, nullptr, stats, B, S, H, D, st);
  if (err == cudaSuccess) err = launch_score<1>(mo, mv, bias, sc, dpw, stats, B, S, H, D, st);
  if (err == cudaSuccess)
    err = launch_product<1>(mp, mdp, mkt, mkt, stats, dq, nullptr, B, S, H, D, st);
  if (err == cudaSuccess)
    err = launch_product<2>(mp32, mdp32, mot, mqt, stats, dk, dv, B, S, H, D, st);
  return (int)err;
}
