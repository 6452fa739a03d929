// Multi-head attention forward for Hopper (sm_90a) at head widths past 256:
// softmax(Q K^T * 1/sqrt(d) + key_bias) V for bf16 and f16 at any D >= 257,
// any S >= 1 (f32 past 256 is csrc/mha_wide_f32.cu's).
//
// Replaces, beside csrc/mha_fwd.cu and csrc/mha_generic.cu (which take D
// up to 256), the TPU kernel
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_kernel (:64,
// reached through mha_pallas :92), which blocks each (batch, head) as (1,
// 1, S, D) whatever D is. ops/attention.py:kernel_route sends D > 256 here
// (route "wide"). q, k, v and out are (B, S, H*D) row-major, read in place;
// key_bias (B, S) f32 (0 keep, -1e30 drop).
//
// Why the D <= 256 kernels cannot take a wider instance: a warpgroup's O
// for 64 rows takes DP/2 f32 registers a thread (192 at DP = 384, past 255
// beside S and P), and a 64-row Q tile plus a two-stage ring of K and V
// tiles passes the 227 KB of one block (bf16 at DP = 384: 48 KB of Q, 96
// KB a stage). So the output columns are split and the contraction is
// chunked (csrc/mha_wide.cuh):
//
//   - Two kernels a call. The statistics pass (DC = 0) takes 64 query rows
//     of one (b, h) a CTA and walks the tiles of 64 keys, each tile's S =
//     Q K^T contracted over the whole D in k-chunks of KC columns (128 in
//     bf16/f16) streamed through a ring (cp.async, zero-filled
//     past D and S); it keeps the running row max and sum and writes m and
//     1/l to a workspace of 2 * B * H * S floats.
//     The output pass takes 64 query rows and two chunks of DC output
//     columns a CTA, one a warpgroup (grid.x = row blocks x chunk pairs,
//     so B and H need no new cap): both warpgroups compute each tile's S
//     from the same landed sub-tiles, again in the statistics pass's chunk
//     order (the same values bit for bit), P = exp(s - m) / l from the
//     stored statistics, and O[:, chunk] += P V[:, chunk], each chunk of V
//     landed once a tile beside the tile's key bias (double-buffered by
//     tile parity). Sharing the sub-tiles halves what each chunk streams.
//   - bf16/f16: S on wgmma m64n64k16 (Q and K sub-tiles K-major); logits in
//     log2 units and ex2.approx as csrc/mha_generic.cu; P rounded to T
//     before P V as the plain version rounds it; P V by wgmma m64nDCk16
//     (products of at most 128 columns), V's chunk N-major through the
//     transpose bit. DC = 192 or 256 (O takes DC/2 registers a thread):
//     the fewest chunks of at most 256 columns, 192 where they hold D.
//   - The copies from L2 bound the passes: where the CTA's own 64 rows fit
//     in shared memory beside the ring (RES), all their sub-tiles are
//     loaded once at the start and the ring streams the key sub-tiles
//     alone, as deep (2-6 stages) as fits beside them; otherwise both
//     stream, the ring as deep (2-4 stages) as keeps two CTAs an SM.
//
// What bounds it on an H100 SXM (published peaks at 700 W), at (B, S, H,
// D) = (64, 512, 1, 384), the work of (64, 512, 2, 192): 100.7 MB of q, k,
// v and out in bf16 at 3.35 TB/s, 0.030 ms; 25.8 GFLOP of Q K^T and P V at
// 989 TFLOP/s, 0.026 ms. This design's own work is larger: the statistics
// pass and each pair of chunks compute Q K^T again (three S products and P
// V at D = 384), and each step's sub-tiles come from L2. With the streamed
// own rows of the first design and one chunk a CTA the pass took 0.8945
// ms in bf16; resident rows and paired chunks take it to 0.4016, against
// the plain version's 1.1472 (examples/torch_attention_ab.py --kernel
// wide_heads, H100 at 700 W; PERF.md).
//
// Semantics, both dtypes:
//   - an all-masked row (every bias -1e30) comes out uniform over the S
//     real keys: (q.k)*scale - 1e30 == -1e30 in f32;
//   - keys from S to the tile edge get logit -inf and zero K and V rows;
//   - query rows >= S and columns >= D are not stored.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given and the C entry returns cudaGetLastError().

#include "mha_wide.cuh"

namespace {

// Geometry at dtype T, output column chunk DC (0: the statistics pass) and
// residency RES; WG warpgroups a CTA, one a column chunk (one in the
// statistics pass). Shared memory: 2 side buffers by tile parity (each
// warpgroup's chunk of V, a K-major tile of BT rows x DC columns; then the
// tile's key bias) | the ring (RES: K sub-tiles of BT rows, `stages` of
// them; else kStages of a Q sub-tile of 64 rows and a K sub-tile) | RES:
// Q's D / KC sub-tiles.
template <typename T, int DC, bool RES>
struct FwdPlan {
  static constexpr int E = sizeof(T), KC = kChunkCols;
  static constexpr int BT = 64;  // keys a tile
  static constexpr int WG = DC > 0 ? 2 : 1;
  static constexpr int kCtaThreads = WG * kThreads;
  static constexpr int kSubA = kRows * KC * E;
  static constexpr int kSubB = BT * KC * E;
  static constexpr int kB = RES ? 0 : kSubA;  // the K sub-tile in a stage
  static constexpr int kStage = kB + kSubB;
  static constexpr int kVTile = BT * DC * E;
  static constexpr int kBias = WG * kVTile;  // the key bias in a side buffer
  static constexpr int kSide = kBias + BT * 4;
  static constexpr int kSide0 = 0;
  static constexpr int kStage0 = kSide0 + 2 * kSide;
  static constexpr int kStages = ring_stages(kStage0, kStage);  // RES: a launch argument
  static constexpr int kBytes = kStage0 + kStages * kStage;
  static int own_bytes(int D) { return RES ? (D + KC - 1) / KC * kSubA : 0; }
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(kSide % 128 == 0 && kStage % 128 == 0, "tile alignment");
};

// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// warp w holds rows 16w..16w+15; with g = lane/4 and c = lane%4, element
// 4i+0/4i+1 is (row g, columns 8i+2c, 8i+2c+1) and 4i+2/4i+3 the same
// columns of row g+8.
template <typename T, int DC, bool RES>
__global__ void __launch_bounds__(FwdPlan<T, DC, RES>::kCtaThreads, 1)
mha_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ key_bias, T* __restrict__ out,
                    float* __restrict__ ws, int S, int H, int D, int gran, float scale,
                    int stages) {
  using P = FwdPlan<T, DC, RES>;
  constexpr int KC = P::KC;
  constexpr int BT = P::BT, WG = P::WG;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  // the warpgroup, its thread, and its chunk of columns (one past D when
  // the chunks are odd in number: it computes and stores nothing of use)
  const int tid = threadIdx.x, wg = WG > 1 ? tid / kThreads : 0;
  const int wtid = WG > 1 ? tid % kThreads : tid, warp = wtid / 32, lane = tid % 32;
  const int npair = DC > 0 ? (D + WG * DC - 1) / (WG * DC) : 1;
  const int q0 = (blockIdx.x / npair) * kRows, c0 = ((blockIdx.x % npair) * WG + wg) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;  // (b, row 0, head h)
  const float* brow = key_bias + (long long)b * S;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;  // this head's m; 1/l bhs further
  const int nk = (D + KC - 1) / KC, ntiles = (S + BT - 1) / BT, nsteps = nk * ntiles;
  if constexpr (!RES) stages = P::kStages;  // a constant where it is one
  const int own_at = P::kStage0 + stages * P::kStage;  // RES: Q's sub-tiles

  // zero everything once: the chunk tiles' columns past D are never written
  for (int i = tid; i < own_at / 16; i += P::kCtaThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // RES: Q's sub-tiles, all of them, with step 0's copies (the warpgroups
  // take turns)
  if constexpr (RES) {
    for (int j = wg; j < nk; j += WG)
      load_sub<T, kRows>(gran, base + own_at + j * P::kSubA, q + head, HD, q0, j * KC, S, D,
                         wtid);
  }

  // step u = (tile u / nk, k-chunk u % nk): the last warpgroup copies Q's
  // sub-tile, the first K's; the tile's last chunk also brings each
  // warpgroup's chunk of V and the key bias into the side buffer of its
  // parity
  auto load_step = [&](int u) {
    const int t = u / nk, j = u % nk;
    const uint32_t st = base + P::kStage0 + (u % stages) * P::kStage;
    if constexpr (!RES) {
      if (wg == WG - 1) load_sub<T, kRows>(gran, st, q + head, HD, q0, j * KC, S, D, wtid);
    }
    if (wg == 0) load_sub<T, BT>(gran, st + P::kB, k + head, HD, t * BT, j * KC, S, D, wtid);
    if (j == nk - 1) {
      const uint32_t sd = base + P::kSide0 + (t % 2) * P::kSide;
      if constexpr (DC > 0) {
        const int dc = D - c0 < DC ? D - c0 : DC;
        const uint32_t vt = sd + wg * P::kVTile;
        load_rows<T, DC, BT>(gran, vt, v + head + c0, HD, t * BT, S, dc, wtid);
      }
      if (wg == 0) load_bias<BT>(sd + P::kBias, brow, t * BT, S, wtid);
    }
  };
  for (int u = 0; u < stages - 1; ++u) {
    if (u < nsteps) load_step(u);
    cp_async_commit();
  }

  // rows g and g+8 of this thread: the running max and sum (statistics
  // pass), or the stored m and 1/l (output pass; rows >= S take P = 0)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if constexpr (DC > 0) {
    m0 = r0 < S ? stats[r0] : 0.f;
    l0 = r0 < S ? stats[bhs + r0] : 0.f;
    m1 = r1 < S ? stats[r1] : 0.f;
    l1 = r1 < S ? stats[bhs + r1] : 0.f;
  }
  constexpr int NO = DC > 0 ? DC / 2 : 1;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float s[BT / 2];

  for (int u = 0; u < nsteps; ++u) {
    const int t = u / nk, j = u % nk;
    cp_async_wait_ring(stages);
    fence_async_smem();
    __syncthreads();  // step u is in; every thread is done with step u - 1
    if (u + stages - 1 < nsteps) load_step(u + stages - 1);
    cp_async_commit();
    const int st = P::kStage0 + (u % stages) * P::kStage;
    const int sd = P::kSide0 + (t % 2) * P::kSide;
    wgmma_fence();
    const int own = RES ? own_at + j * P::kSubA : st;  // Q's sub-tile j
    chunk_product<T>(s, base, own, st + P::kB, j == 0);
    wgmma_wait_all();
    fence_regs(s);
    if (j < nk - 1) continue;

    // ---- tile t's scores are complete: logits in log2 units in one FMA ----
    const float* bt = reinterpret_cast<const float*>(smem + sd + P::kBias);
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bias = (e & 1) ? bb.y : bb.x;
        s[4 * i + e] = fmaf(s[4 * i + e], scale, bias * kLog2e);
      }
    }

    if constexpr (DC == 0) {
      // running row max and sum; tile 0 holds key 0 (finite bias), so the
      // max is finite and exp(-inf - mx) = 0 clears the empty sums
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i + 0], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      l0 *= ex2_approx(m0 - mx0);
      l1 *= ex2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        l0 += ex2_approx(s[4 * i + 0] - m0) + ex2_approx(s[4 * i + 1] - m0);
        l1 += ex2_approx(s[4 * i + 2] - m1) + ex2_approx(s[4 * i + 3] - m1);
      }
    } else {
      // ---- P = 2^(s - m) / l rounded to T; O += P V[:, chunk] ----
      uint32_t p[BT / 4];
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        p[2 * i] = Mma<T>::pack(ex2_approx(s[4 * i + 0] - m0) * l0,
                                ex2_approx(s[4 * i + 1] - m0) * l0);
        p[2 * i + 1] = Mma<T>::pack(ex2_approx(s[4 * i + 2] - m1) * l1,
                                    ex2_approx(s[4 * i + 3] - m1) * l1);
      }
      // BT/16 k-steps of 16 keys; V's chunk N-major (transpose bit): LBO
      // steps 8 keys, SBO 8 columns
      constexpr int kGroupV = 8 * DC * P::E;
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < BT / 16; ++jj) {
        const uint32_t a[4] = {p[4 * jj], p[4 * jj + 1], p[4 * jj + 2], p[4 * jj + 3]};
        pv_wide<T>(o, a, smem_desc(base + sd + wg * P::kVTile + 2 * jj * kGroupV, kGroupV, 128));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
  }

  if constexpr (DC == 0) {
    // the row statistics by one thread of each quad
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (c == 0) {
      if (r0 < S) {
        stats[r0] = m0;
        stats[bhs + r0] = 1.f / l0;
      }
      if (r1 < S) {
        stats[r1] = m1;
        stats[bhs + r1] = 1.f / l1;
      }
    }
  } else {
    // ---- out[:, chunk] = O; rows >= S and columns >= D not stored ----
    T* ob = out + head;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c0 + 8 * i + 2 * c + e;
        if (d >= D) continue;
        if (r0 < S) ob[r0 * HD + d] = from_f32<T>(o[4 * i + e]);
        if (r1 < S) ob[r1 * HD + d] = from_f32<T>(o[4 * i + 2 + e]);
      }
  }
}

// the output column chunk of the last launch (host side; read by
// rrt_mha_wide_last_dc)
int g_last_dc = 0;

template <typename T, int DC>
using FwdKernel = decltype(&mha_wide_fwd_kernel<T, DC, false>);

// A pass's kernel, its shared memory and its ring: resident Q where it
// fits beside a ring of 2 or more stages.
template <typename T, int DC>
void pick_pass(int D, FwdKernel<T, DC>* kern, int* bytes, int* stages) {
  using R = FwdPlan<T, DC, true>;
  const int n = resident_ring(R::kStage0, R::kStage, R::own_bytes(D));
  if (n >= 2) {
    *kern = mha_wide_fwd_kernel<T, DC, true>;
    *bytes = R::kStage0 + n * R::kStage + R::own_bytes(D);
    *stages = n;
  } else {
    *kern = mha_wide_fwd_kernel<T, DC, false>;
    *bytes = FwdPlan<T, DC, false>::kBytes;
    *stages = FwdPlan<T, DC, false>::kStages;
  }
}

// whether the last launch's passes kept Q resident (bit 0 statistics, bit 1
// output; host side, read by rrt_mha_wide_last_resident)
int g_last_resident = 0;

template <typename T, int DC>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const float* bias, void* out,
                        float* ws, int B, int S, int H, int D, cudaStream_t stream) {
  FwdKernel<T, 0> kstats;
  FwdKernel<T, DC> kout;
  int stats_bytes, out_bytes, stats_stages, out_stages;
  pick_pass<T, 0>(D, &kstats, &stats_bytes, &stats_stages);
  pick_pass<T, DC>(D, &kout, &out_bytes, &out_stages);
  cudaError_t err = allow_smem(kstats, stats_bytes);
  if (err == cudaSuccess) err = allow_smem(kout, out_bytes);
  if (err != cudaSuccess) return err;
  const int gran = granule((uintptr_t)q | (uintptr_t)k | (uintptr_t)v, D * (int)sizeof(T));
  const float scale = kLog2e / sqrtf((float)D);  // logits in log2 units
  const int blocks = (S + kRows - 1) / kRows, npair = (D + 2 * DC - 1) / (2 * DC);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  kstats<<<dim3(blocks, H, B), FwdPlan<T, 0, false>::kCtaThreads, stats_bytes, stream>>>(
      qq, kk, vv, bias, static_cast<T*>(out), ws, S, H, D, gran, scale, stats_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kout<<<dim3(blocks * npair, H, B), FwdPlan<T, DC, false>::kCtaThreads, out_bytes, stream>>>(
      qq, kk, vv, bias, static_cast<T*>(out), ws, S, H, D, gran, scale, out_stages);
  g_last_dc = DC;
  g_last_resident = (kstats == mha_wide_fwd_kernel<T, 0, true>) |
                    (kout == mha_wide_fwd_kernel<T, DC, true>) << 1;
  return cudaGetLastError();
}

// 16-bit output chunks: the fewest of at most 256 columns, 192 wide where
// they hold D (O takes DC/2 registers a thread)
template <typename T>
cudaError_t dispatch_16(const void* q, const void* k, const void* v, const float* bias, void* out,
                        float* ws, int B, int S, int H, int D, cudaStream_t stream) {
  const int nch = (D + 255) / 256;
  if (D <= 192 * nch) return launch_wide<T, 192>(q, k, v, bias, out, ws, B, S, H, D, stream);
  return launch_wide<T, 256>(q, k, v, bias, out, ws, B, S, H, D, stream);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16 (float32 past 256 columns is
// csrc/mha_wide_f32.cu's rrt_mha_wide_f32). Shapes: q, k, v, out
// (B, S, H*D) contiguous; key_bias (B, S) f32 contiguous; ws: 2 * B * H * S
// floats of scratch (each row's m and 1/l); D >= 257 (narrower heads are
// mha_fwd.cu's and mha_generic.cu's); B, H <= 65535. Returns a cudaError_t
// (0 = launched).
extern "C" int rrt_mha_wide(int dtype, const void* q, const void* k, const void* v,
                            const void* key_bias, void* out, void* ws, int B, int S, int H, int D,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D < kMinWideD || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(key_bias);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_16<__nv_bfloat16>(q, k, v, bias, out, w, B, S, H, D, st);
    case 1: return (int)dispatch_16<__half>(q, k, v, bias, out, w, B, S, H, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The output column chunk DC of the rrt_mha_wide call last launched (0
// before any): the columns each CTA of the output pass takes.
extern "C" int rrt_mha_wide_last_dc() { return g_last_dc; }

// Which of the last call's passes kept Q resident in shared memory: bit 0
// the statistics pass, bit 1 the output pass.
extern "C" int rrt_mha_wide_last_resident() { return g_last_resident; }
