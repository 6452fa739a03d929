// Multi-head attention backward for Hopper (sm_90a) at head widths past
// 256: the q, k and v gradients of softmax(Q K^T * 1/sqrt(d) + key_bias) V
// for bf16 and f16 at any D >= 257, any S >= 1 (f32 past 256 is
// csrc/mha_wide_f32.cu's).
//
// Replaces, beside csrc/mha_bwd.cu (which takes D up to 256), the backward
// of the TPU kernel's custom_vjp:
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_bwd (:142),
// which re-runs mha_xla under jax.vjp at any D. ops/attention.py:
// backward_route sends bf16/f16 at D > 256 here (route "wide"). q, k, v,
// dout (the gradient of the forward's output) and the
// gradients (B, S, H*D) row-major, key_bias (B, S) f32 (0 keep, -1e30 drop).
//
// The formula is csrc/mha_bwd.cu's (its :14-27; ops/attention.py:
// mha_backward_reference), with the roundings of autograd through the
// plain version:
//   P  = exp(s - m) / l in f32; dV = round_T(P)^T dO;
//   dP = round_T(dO V^T); dS = P * (dP - Delta), Delta = sum_k P dP in f32
//   (not rowsum(dO * O): mha_bwd.cu:22-27 says why);
//   dQ = dS K * scale, dK = dS^T Q * scale; each gradient rounded to T once.
//
// A 64-row accumulator of D columns does not fit a thread's registers past
// 256 columns, and S and dP must still be contracted over the whole D, so
// the contraction is chunked and the gradient columns split
// (csrc/mha_wide.cuh). Three kernels a call on one stream, deterministic (no
// atomics), one template (mha_wide_bwd_kernel, KIND):
//   0 statistics (64 query rows a CTA): over the key tiles, S and dP over
//     the whole D in k-chunks of KC (ring of Q, K, dO, V sub-tiles), the
//     running row max, the row sum of e = 2^(s - m) and of e * dP, both
//     rescaled when the max moves; writes m, 1/l and Delta to a workspace
//     of 3 * B * H * S floats (csrc/mha_bwd.cu's layout).
//   1 dQ (64 query rows and two chunks of DCA gradient columns a CTA, one a
//     warpgroup, both on the same landed sub-tiles): S and dP again per key
//     tile, P and dS from the stored statistics, dQ[:, c] += dS K[:, c],
//     each chunk of K landed once a tile beside the key bias.
//   2 dK and dV (64 key rows and two chunks of DCB columns a CTA, one a
//     warpgroup): over the query tiles,
//     S^T = K Q^T and dP^T = V dO^T over the whole D, P^T and dS^T from the
//     query rows' statistics, dV[:, c] += round_T(P^T) dO[:, c] and
//     dK[:, c] += round_T(dS^T) Q[:, c].
// Logits in log2 units, ex2.approx and a multiply by 1/l, as
// csrc/mha_bwd.cu. On wgmma (S, dP from shared memory; the gradient
// products with P or dS, rounded to T, straight from the accumulators as A
// registers, the chunk N-major through the transpose bit): streamed tiles
// of 64 keys (kernels 0, 1) and 32 queries (kernel 2), DCA = 192, DCB =
// 128 (dQ 96 registers a thread; dK and dV 64 each). k-chunks of KC = 128
// columns in kernels 0 and 2 (fewer, larger steps), 64 in kernel 1, whose
// chunks of K leave no room for resident rows beside 128-column sub-tiles
// at D = 384. The copies from L2 bound every kernel (the first
// design, own rows streamed and one chunk a CTA, took 3.09 ms at (64, 512,
// 1, 384) bf16 and 0.60 without the next steps' copies, 3.17 without the
// S / dP products, 3.19 without the gradient products: examples/
// torch_attention_backward.py --breakdown, H100), so where the CTA's two
// own row blocks fit in shared memory beside the ring (RES), all their
// sub-tiles are loaded once at the start and the ring streams the streamed
// rows' sub-tiles alone, as deep (2-6 stages) as fits beside them;
// otherwise all four stream, the ring as deep (2-4 stages) as keeps two
// CTAs an SM, 2 where one CTA is all that fits; and kernels 1 and 2 pair
// their column chunks in one CTA, so that each streamed sub-tile serves
// two. That takes bf16 to 1.5371 ms (0.81 without the next steps'
// copies), against the recompute's 3.3719 (examples/torch_attention_ab.py
// --kernel wide_heads, H100 at 700 W; PERF.md).
//
// What bounds it on an H100 SXM (published peaks at 700 W), at (64, 512,
// 1, 384), the work of (64, 512, 2, 192): the five products, 64.4 GFLOP at
// 989 TFLOP/s, 0.065 ms in bf16; q, k, v, dout read and dq, dk, dv written
// once, 176 MB, 0.053 ms. This design computes S and dP again in the
// statistics pass and in each pair of column chunks of kernels 1 and 2,
// in both warpgroups (bf16 at D = 384: 2 + 2 x 2 + 4 x 2 = 14 score
// products beside the 3 gradient ones).
//
// Semantics:
//   - an all-masked row has equal logits, P = 1/S over the S real keys,
//     and its gradients flow uniformly;
//   - keys from S to the tile edge get logit -inf, P = 0 and zero K and V
//     rows; their dK and dV are not stored;
//   - query rows >= S get m = +inf and 1/l = 0 in kernel 2 (P = 0) and add
//     nothing to dK or dV; they are not stored.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given and the C entry returns cudaGetLastError().

#include "mha_wide.cuh"

namespace {

// Geometry of kernel KIND at dtype T and gradient column chunk DC; WG
// warpgroups a CTA, one a column chunk (one in the statistics kernel). Own
// rows: Q and dO (KIND 0, 1) or K and V (KIND 2), 64 of them; streamed
// rows: K and V, or Q and dO, BT a tile. Shared memory: 2 side buffers by
// tile parity (each warpgroup's chunks: KIND 1 K's, KIND 2 Q's then dO's,
// K-major tiles of BT rows x DC columns; then the tile's key bias, or its
// query rows' m, 1/l and Delta) | the ring of (own 1, streamed 1, own 2,
// streamed 2) sub-tiles, kStages of them (RES: `stages` of (streamed 1,
// streamed 2)) | RES: own 1's and own 2's D / 64 sub-tiles each.
template <typename T, int KIND, int DC, bool RES>
struct BwdPlan {
  // k-chunk columns: 64 in the dQ kernel, whose chunks of K leave too
  // little shared memory for resident rows beside 128-column sub-tiles
  static constexpr int E = sizeof(T), KC = KIND == 1 ? 64 : kChunkCols;
  static constexpr int BT = KIND == 2 ? 32 : 64;
  static constexpr int NCHUNK = KIND == 2 ? 2 : KIND == 1 ? 1 : 0;  // chunk tiles a warpgroup
  static constexpr int WG = KIND > 0 ? 2 : 1;
  static constexpr int kCtaThreads = WG * kThreads;
  static constexpr int kSubA = kRows * KC * E;
  static constexpr int kSubB = BT * KC * E;
  static constexpr int kA1 = 0, kB1 = RES ? 0 : kSubA, kA2 = kSubA + kSubB;
  static constexpr int kB2 = RES ? kSubB : 2 * kSubA + kSubB;
  static constexpr int kStage = RES ? 2 * kSubB : 2 * (kSubA + kSubB);
  static constexpr int kCTile = BT * DC * E;
  static constexpr int kWgChunks = NCHUNK * kCTile;  // a warpgroup's chunks in a side buffer
  static constexpr int kStat = WG * kWgChunks;  // the bias or statistics in a side buffer
  static constexpr int kSide = kStat + (KIND == 2 ? 3 : 1) * BT * 4;
  static constexpr int kSide0 = 0;
  static constexpr int kStage0 = kSide0 + 2 * kSide + 127 - (2 * kSide + 127) % 128;
  static constexpr int kStages = ring_stages(kStage0, kStage);  // RES: a launch argument
  static constexpr int kBytes = kStage0 + kStages * kStage;
  static int own_bytes(int D) { return RES ? 2 * ((D + KC - 1) / KC) * kSubA : 0; }
  static_assert(kBytes <= 232448, "shared memory of one block");
  static_assert(kStage % 128 == 0 && kCTile % 128 == 0, "tile alignment");
};

// A tile's query statistics into shared memory: m, 1/l and Delta of rows
// [q0, q0 + R) from the workspace (at `stats`, `bhs` floats apart); rows >=
// S get m = +inf, 1/l = 0 and Delta = 0, so that P = 0.
template <int R>
__device__ __forceinline__ void load_stats(uint32_t dst, const float* stats, long long bhs,
                                           int q0, int S, int tid) {
  for (int j = tid; j < 3 * R; j += kThreads) {
    const int which = j / R, row = q0 + j % R;
    if (row < S) {
      cp_async<4>(dst + 4 * j, stats + which * bhs + row, 4);
    } else {
      const float x = which == 0 ? INFINITY : 0.f;
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4 * j), "f"(x) : "memory");
    }
  }
}

// Rows [r0, r0 + R) of columns [c0, c0 + DC) of a head: a K-major tile of
// DC columns (read N-major through the transpose bit).
template <typename T, int DC, int R>
__device__ __forceinline__ void load_chunk(int gran, uint32_t dst, const T* head_src, long long HD,
                                           int r0, int c0, int S, int D, int tid) {
  const int dc = D - c0 < DC ? D - c0 : DC;
  load_rows<T, DC, R>(gran, dst, head_src + c0, HD, r0, S, dc, tid);
}

// acc += A B over the BT streamed rows, A the m64nBT accumulator values x
// (P, dS, or their transposes) rounded to T in registers, B the chunk tile
// at `ct`. Commits and waits.
template <typename T, int BT, int NA>
__device__ __forceinline__ void grad_product(float (&acc)[NA], const float (&x)[BT / 2],
                                             uint32_t ct) {
  constexpr int kGroupC = 8 * (2 * NA) * 2;  // the chunk's 8-row groups (DC = 2 NA columns)
  uint32_t a[BT / 4];
#pragma unroll
  for (int i = 0; i < BT / 8; ++i) {
    a[2 * i] = Mma<T>::pack(x[4 * i + 0], x[4 * i + 1]);
    a[2 * i + 1] = Mma<T>::pack(x[4 * i + 2], x[4 * i + 3]);
  }
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    const uint32_t aj[4] = {a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]};
    pv_wide<T>(acc, aj, smem_desc(ct + 2 * j * kGroupC, kGroupC, 128));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// Accumulator layout of wgmma m64nN (f32), per thread of the warpgroup:
// warp w holds rows 16w..16w+15; with g = lane/4 and c = lane%4, element
// 4i+0/4i+1 is (row g, columns 8i+2c, 8i+2c+1) and 4i+2/4i+3 the same
// columns of row g+8. g1 is dQ (KIND 1) or dK (KIND 2), g2 dV (KIND 2).
template <typename T, int KIND, int DC, bool RES>
__global__ void __launch_bounds__(BwdPlan<T, KIND, DC, RES>::kCtaThreads, 1)
mha_wide_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ key_bias, const T* __restrict__ dout,
                    T* __restrict__ g1, T* __restrict__ g2, float* __restrict__ ws, int S, int H,
                    int D, int gran, float scale, float dscale, int stages) {
  using P = BwdPlan<T, KIND, DC, RES>;
  constexpr int KC = P::KC;
  constexpr int BT = P::BT, WG = P::WG;
  constexpr int NA = DC > 0 ? DC / 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  // the warpgroup, its thread, and its chunk of columns (one past D when
  // the chunks are odd in number: it computes and stores nothing of use);
  // the first warpgroup copies own 1's and streamed 1's sub-tiles, the last
  // own 2's and streamed 2's
  const int tid = threadIdx.x, wg = WG > 1 ? tid / kThreads : 0;
  const int wtid = WG > 1 ? tid % kThreads : tid, warp = wtid / 32, lane = tid % 32;
  const bool first = wg == 0, last = wg == WG - 1;
  const int npair = DC > 0 ? (D + WG * DC - 1) / (WG * DC) : 1;
  const int r_own = (blockIdx.x / npair) * kRows, c0 = ((blockIdx.x % npair) * WG + wg) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = lane / 4, c = lane % 4;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * S * HD + (long long)h * D;  // (b, row 0, head h)
  const float* brow = key_bias + (long long)b * S;
  const long long bhs = (long long)gridDim.z * H * S;
  float* stats = ws + ((long long)b * H + h) * S;  // m; 1/l and Delta bhs apart
  const T* own1 = (KIND == 2 ? k : q) + head;
  const T* str1 = (KIND == 2 ? q : k) + head;
  const T* own2 = (KIND == 2 ? v : dout) + head;
  const T* str2 = (KIND == 2 ? dout : v) + head;
  const int nk = (D + KC - 1) / KC, ntiles = (S + BT - 1) / BT, nsteps = nk * ntiles;
  if constexpr (!RES) stages = P::kStages;  // a constant where it is one
  const int own_at = P::kStage0 + stages * P::kStage;  // RES: the own rows' sub-tiles

  // zero everything once: the chunk tiles' columns past D are never written
  for (int i = tid; i < own_at / 16; i += P::kCtaThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // RES: the own rows' sub-tiles, all of them, with step 0's copies (own
  // 1's chunk j at own_at + j * kSubA, own 2's nk sub-tiles further)
  if constexpr (RES) {
    for (int j = 0; j < nk; ++j) {
      if (first)
        load_sub<T, kRows, KC>(gran, base + own_at + j * P::kSubA, own1, HD, r_own, j * KC, S,
                               D, wtid);
      if (last)
        load_sub<T, kRows, KC>(gran, base + own_at + (nk + j) * P::kSubA, own2, HD, r_own,
                               j * KC, S, D, wtid);
    }
  }

  // step u = (tile u / nk, k-chunk u % nk); the tile's last chunk also
  // brings each warpgroup's chunks and the key bias or query statistics
  // into the side buffer of its parity
  auto load_step = [&](int u) {
    const int t = u / nk, j = u % nk;
    const uint32_t st = base + P::kStage0 + (u % stages) * P::kStage;
    if (first) {
      if constexpr (!RES)
        load_sub<T, kRows, KC>(gran, st + P::kA1, own1, HD, r_own, j * KC, S, D, wtid);
      load_sub<T, BT, KC>(gran, st + P::kB1, str1, HD, t * BT, j * KC, S, D, wtid);
    }
    if (last) {
      if constexpr (!RES)
        load_sub<T, kRows, KC>(gran, st + P::kA2, own2, HD, r_own, j * KC, S, D, wtid);
      load_sub<T, BT, KC>(gran, st + P::kB2, str2, HD, t * BT, j * KC, S, D, wtid);
    }
    if (j == nk - 1) {
      const uint32_t sd = base + P::kSide0 + (t % 2) * P::kSide;
      const uint32_t ch = sd + wg * P::kWgChunks;  // this warpgroup's chunks
      if constexpr (KIND == 0) {
        load_bias<BT>(sd + P::kStat, brow, t * BT, S, wtid);
      } else if constexpr (KIND == 1) {
        load_chunk<T, DC, BT>(gran, ch, k + head, HD, t * BT, c0, S, D, wtid);
        if (first) load_bias<BT>(sd + P::kStat, brow, t * BT, S, wtid);
      } else {
        load_chunk<T, DC, BT>(gran, ch, q + head, HD, t * BT, c0, S, D, wtid);
        load_chunk<T, DC, BT>(gran, ch + P::kCTile, dout + head, HD, t * BT, c0, S, D, wtid);
        if (first) load_stats<BT>(sd + P::kStat, stats, bhs, t * BT, S, wtid);
      }
    }
  };
  for (int u = 0; u < stages - 1; ++u) {
    if (u < nsteps) load_step(u);
    cp_async_commit();
  }

  // this thread's own rows g and g+8: KIND 0 the running max, sum of e and
  // sum of e * dP; KIND 1 the stored m, 1/l, Delta (rows >= S: P = 0);
  // KIND 2 the key rows' biases in log2 units (-inf past S)
  const int r0 = r_own + warp * 16 + g, r1 = r0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if constexpr (KIND == 1) {
    m0 = r0 < S ? stats[r0] : INFINITY;
    l0 = r0 < S ? stats[bhs + r0] : 0.f;
    dl0 = r0 < S ? stats[2 * bhs + r0] : 0.f;
    m1 = r1 < S ? stats[r1] : INFINITY;
    l1 = r1 < S ? stats[bhs + r1] : 0.f;
    dl1 = r1 < S ? stats[2 * bhs + r1] : 0.f;
  } else if constexpr (KIND == 2) {
    m0 = r0 < S ? brow[r0] * kLog2e : -INFINITY;
    m1 = r1 < S ? brow[r1] * kLog2e : -INFINITY;
  }
  float acc1[NA], acc2[KIND == 2 ? NA : 1];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (KIND == 2 ? NA : 1); ++i) acc2[i] = 0.f;
  float s[BT / 2], dp[BT / 2];

  for (int u = 0; u < nsteps; ++u) {
    const int t = u / nk, j = u % nk;
    cp_async_wait_ring(stages);
    fence_async_smem();
    __syncthreads();  // step u is in; every thread is done with step u - 1
    if (u + stages - 1 < nsteps) load_step(u + stages - 1);
    cp_async_commit();
    const int st = P::kStage0 + (u % stages) * P::kStage;
    const int sd = P::kSide0 + (t % 2) * P::kSide;
    const int ch = sd + wg * P::kWgChunks;
    const int a1 = RES ? own_at + j * P::kSubA : st + P::kA1;  // own 1's sub-tile j
    const int a2 = RES ? own_at + (nk + j) * P::kSubA : st + P::kA2;
    wgmma_fence();
    chunk_product<T, KC>(s, base, a1, st + P::kB1, j == 0);
    chunk_product<T, KC>(dp, base, a2, st + P::kB2, j == 0);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    if (j < nk - 1) continue;

    // ---- the tile's S and dP are complete: logits in log2 units, dP as the
    // plain version takes it (rounded to T) ----
    float x[BT / 2], y[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      y[i] = to_f32(from_f32<T>(dp[i]));
      x[i] = s[i];
    }
    if constexpr (KIND < 2) {
      const float* bt = reinterpret_cast<const float*>(smem + sd + P::kStat);
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * i + e] = fmaf(x[4 * i + e], scale, ((e & 1) ? bb.y : bb.x) * kLog2e);
      }
    }

    if constexpr (KIND == 0) {
      // the running max, sum of e and sum of e * dP; tile 0 holds key 0
      // (finite bias): the max is finite, 2^(-inf - mx) = 0
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
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
      for (int i = 0; i < BT / 2; ++i) {
        const float e = ex2_approx(x[i] - ((i & 2) ? m1 : m0));
        if (i & 2) {
          l1 += e;
          dl1 = fmaf(e, y[i], dl1);
        } else {
          l0 += e;
          dl0 = fmaf(e, y[i], dl0);
        }
      }
    } else if constexpr (KIND == 1) {
      // P = 2^(s - m) / l; dS = P (dP - Delta); dQ[:, c] += dS K[:, c]
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const bool hi_row = i & 2;
        const float p = ex2_approx(x[i] - (hi_row ? m1 : m0)) * (hi_row ? l1 : l0);
        x[i] = p * (y[i] - (hi_row ? dl1 : dl0));
      }
      grad_product<T, BT>(acc1, x, base + ch);
    } else {
      // rows are keys, columns queries: P^T = 2^(s - m_q) / l_q with the
      // key row's bias; dS^T = P^T (dP^T - Delta_q); dV[:, c] += P^T dO[:, c],
      // dK[:, c] += dS^T Q[:, c]
      const float* sm = reinterpret_cast<const float*>(smem + sd + P::kStat);
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const int col = 8 * i + 2 * c;
        const float2 mm = *reinterpret_cast<const float2*>(sm + col);
        const float2 il = *reinterpret_cast<const float2*>(sm + BT + col);
        const float2 dl = *reinterpret_cast<const float2*>(sm + 2 * BT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const float logit = fmaf(x[4 * i + e], scale, e < 2 ? m0 : m1);
          const float p = ex2_approx(logit - (odd ? mm.y : mm.x)) * (odd ? il.y : il.x);
          x[4 * i + e] = p;
          y[4 * i + e] = p * (y[4 * i + e] - (odd ? dl.y : dl.x));
        }
      }
      grad_product<T, BT>(acc2, x, base + ch + P::kCTile);
      grad_product<T, BT>(acc1, y, base + ch);
    }
  }

  if constexpr (KIND == 0) {
    // Delta = sum(e dP) / l; the row statistics by one thread of each quad
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    dl0 = quad_sum(dl0) * i0;
    dl1 = quad_sum(dl1) * i1;
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
  } else {
    // g1 = acc1 * scale (dQ or dK), g2 = acc2 (dV); rows >= S and columns
    // >= D not stored
#pragma unroll
    for (int i = 0; i < DC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c0 + 8 * i + 2 * c + e;
        if (d >= D) continue;
        if (r0 < S) {
          g1[head + r0 * HD + d] = from_f32<T>(acc1[4 * i + e] * dscale);
          if constexpr (KIND == 2) g2[head + r0 * HD + d] = from_f32<T>(acc2[4 * i + e]);
        }
        if (r1 < S) {
          g1[head + r1 * HD + d] = from_f32<T>(acc1[4 * i + 2 + e] * dscale);
          if constexpr (KIND == 2) g2[head + r1 * HD + d] = from_f32<T>(acc2[4 * i + 2 + e]);
        }
      }
  }
}

// the gradient column chunks of the last launch, dQ's and dK / dV's, and
// which kernels kept their own rows resident (bit KIND) (host side; read by
// rrt_mha_wide_bwd_last_dc, rrt_mha_wide_bwd_last_resident)
int g_last_dc[2] = {0, 0};
int g_last_resident = 0;

template <typename T, int KIND, int DC>
using BwdKernel = decltype(&mha_wide_bwd_kernel<T, KIND, DC, false>);

// Kernel KIND, its shared memory and its ring: resident own rows where they
// fit beside a ring of 2 or more stages.
template <typename T, int KIND, int DC>
bool pick_kind(int D, BwdKernel<T, KIND, DC>* kern, int* bytes, int* stages) {
  using R = BwdPlan<T, KIND, DC, true>;
  using N = BwdPlan<T, KIND, DC, false>;
  const int n = resident_ring(R::kStage0, R::kStage, R::own_bytes(D));
  *kern = n >= 2 ? mha_wide_bwd_kernel<T, KIND, DC, true> : mha_wide_bwd_kernel<T, KIND, DC, false>;
  *bytes = n >= 2 ? R::kStage0 + n * R::kStage + R::own_bytes(D) : N::kBytes;
  *stages = n >= 2 ? n : N::kStages;
  return n >= 2;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float* bias;
  void *dq, *dk, *dv;
  float* ws;
  int B, S, H, D;
  cudaStream_t stream;
};

template <typename T, int DCA, int DCB>
cudaError_t launch_wide_bwd(const Args& a) {
  BwdKernel<T, 0, 0> k0;
  BwdKernel<T, 1, DCA> k1;
  BwdKernel<T, 2, DCB> k2;
  int b0, b1, b2, n0, n1, n2;
  const int res = pick_kind<T, 0, 0>(a.D, &k0, &b0, &n0) |
                  pick_kind<T, 1, DCA>(a.D, &k1, &b1, &n1) << 1 |
                  pick_kind<T, 2, DCB>(a.D, &k2, &b2, &n2) << 2;
  cudaError_t err = allow_smem(k0, b0);
  if (err == cudaSuccess) err = allow_smem(k1, b1);
  if (err == cudaSuccess) err = allow_smem(k2, b2);
  if (err != cudaSuccess) return err;
  const int gran = granule((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout,
                           a.D * (int)sizeof(T));
  const float scale = kLog2e / sqrtf((float)a.D), dscale = 1.0f / sqrtf((float)a.D);
  const int blocks = (a.S + kRows - 1) / kRows;
  const int pairs_a = (a.D + 2 * DCA - 1) / (2 * DCA), pairs_b = (a.D + 2 * DCB - 1) / (2 * DCB);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  k0<<<dim3(blocks, a.H, a.B), BwdPlan<T, 0, 0, false>::kCtaThreads, b0, a.stream>>>(
      q, k, v, a.bias, dout, nullptr, nullptr, a.ws, a.S, a.H, a.D, gran, scale, dscale, n0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1<<<dim3(blocks * pairs_a, a.H, a.B), BwdPlan<T, 1, DCA, false>::kCtaThreads, b1,
       a.stream>>>(q, k, v, a.bias, dout, static_cast<T*>(a.dq), nullptr, a.ws, a.S, a.H, a.D,
                   gran, scale, dscale, n1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3(blocks * pairs_b, a.H, a.B), BwdPlan<T, 2, DCB, false>::kCtaThreads, b2,
       a.stream>>>(q, k, v, a.bias, dout, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.ws,
                   a.S, a.H, a.D, gran, scale, dscale, n2);
  g_last_dc[0] = DCA;
  g_last_dc[1] = DCB;
  g_last_resident = res;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16 (float32 past 256 columns is
// csrc/mha_wide_f32.cu's rrt_mha_wide_f32_bwd). q, k, v, dout (the
// gradient of the forward's output), dq, dk, dv: (B, S, H*D) contiguous;
// key_bias (B, S) f32 contiguous; ws: 3 * B * H * S floats of scratch.
// D >= 257 (narrower heads are mha_bwd.cu's); B, H <= 65535. Route
// (ops/attention.py:backward_route): "wide". Returns a cudaError_t (0 =
// launched).
extern "C" int rrt_mha_wide_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* key_bias, const void* dout, void* dq, void* dk,
                                void* dv, void* ws, int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D < kMinWideD || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(key_bias), dq, dk, dv,
               static_cast<float*>(ws), B, S, H, D, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)launch_wide_bwd<__nv_bfloat16, 192, 128>(a);
    case 1: return (int)launch_wide_bwd<__half, 192, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient column chunk of the rrt_mha_wide_bwd call last launched (0
// before any): which = 0 the dQ kernel's, 1 the dK / dV kernel's.
extern "C" int rrt_mha_wide_bwd_last_dc(int which) { return g_last_dc[which ? 1 : 0]; }

// Which of the last call's kernels kept their own rows resident in shared
// memory: bit 0 the statistics kernel, 1 the dQ kernel, 2 the dK / dV one.
extern "C" int rrt_mha_wide_bwd_last_resident() { return g_last_resident; }
