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
// dout (the gradient of the forward's output) and the gradients (B, S,
// H*D) row-major, key_bias (B, S) f32 (0 keep, -1e30 drop).
//
// The formula is csrc/mha_bwd.cu's (its :14-27; ops/attention.py:
// mha_backward_reference), with the roundings of autograd through the
// plain version:
//   P  = exp(s - m) / l in f32; dV = round_T(P)^T dO;
//   dP = round_T(dO V^T); dS = P * (dP - Delta), Delta = sum_k P dP in f32
//   (not rowsum(dO * O): mha_bwd.cu:22-27 says why);
//   dQ = dS K * scale, dK = dS^T Q * scale; each gradient rounded to T once.
//
// The first design contracted S and dP again in each of its three kernels
// and in each warpgroup of them (14 score products beside the 3 gradient
// ones at D = 384). Here each is contracted once (csrc/mha_wide.cuh), four
// kernels a call on one stream, deterministic (no atomics on any result):
//   1 score, MODE 0 (csrc/mha_wide.cu's forward score kernel): S, the
//     logits stored, each row's m and 1/l;
//   2 score, MODE 1: dP = dO V^T over the whole D, stored rounded to T;
//     Delta = sum_k P dP with P from the stored logits;
//   3 dQ (wide_product_kernel, KIND 1: a 64-row block and two chunks of
//     192 columns a CTA): dS = P (dP - Delta) from the stored tiles,
//     dQ[:, c] += dS K[:, c];
//   4 dK and dV (KIND 2: 64 key rows and one chunk of 192 columns a CTA,
//     dV in one warpgroup, dK in the other; two CTAs at D = 384, none
//     idle): over the query tiles, P^T and dS^T from the stored tiles read
//     transposed and the query rows' statistics (the producer's second warp
//     writes them into the tile's slot), dV[:, c] += round_T(P^T) dO[:, c],
//     dK[:, c] += round_T(dS^T) Q[:, c].
// The workspace: m, 1/l, Delta (3 * B * H * S floats), the logits (B * H *
// S * SK f32), dP (B * H * S * SK in T), and, where TMA cannot read the
// rows in place, their copies (csrc/mha_wide.cuh's WideWs).
//
// What bounds it on an H100 SXM (published peaks at 700 W), at (64, 512,
// 1, 384): the five products, 64.4 GFLOP at 989 TFLOP/s, 0.065 ms in
// bf16; q, k, v, dout read and dq, dk, dv written once, 176 MB, 0.053 ms.
// The stored scores add 101 MB written and read back by each kernel that
// uses them. Measured there: 80 + 66 + 102 + 212 us, 0.49 ms in all, against
// the first design's 1.54 and SDPA's backward's 2.65 (PERF.md).
//
// Semantics:
//   - an all-masked row has equal logits, P = 1/S over the S real keys,
//     and its gradients flow uniformly;
//   - keys from S to SK get logit -inf, P = 0 and zero K and V rows; their
//     dK and dV are not stored;
//   - query rows >= S get m = +inf and 1/l = 0 in kernel 4 (P = 0) and add
//     nothing to dK or dV; they are not stored.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given and the C entry returns cudaGetLastError().

#include "mha_wide.cuh"

namespace {

// the last call's plan (host side; read by the rrt_mha_wide_bwd_last_*
// entries): own rows resident, the tiles of S (and of dP) of one
// contraction, the dQ and dK / dV kernels' CTAs a block and columns a
// warpgroup, TMA in place
int g_last_res = 0, g_last_ctas[2] = {0, 0}, g_last_dc[2] = {0, 0}, g_last_tma = 0;
long long g_last_tiles = 0;

struct Args {
  const void *q, *k, *v, *dout;
  const float* bias;
  void *dq, *dk, *dv, *ws;
  int B, S, H, D, ld;
  bool padded;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_wide_bwd(const Args& a) {
  const int B = a.B, S = a.S, H = a.H, D = a.D;
  const WideWs w(true, B, S, H, D, a.padded);
  const int nk = div_up(D, kBoxCols);
  const bool res = kWideConsumers * nk * kBoxBytes <= kMaxOwnBytes;
  // a score slot takes gb boxes (and, where not resident, both own boxes
  // beside each): as many as leave room for two slots
  const int own = res ? kWideConsumers * nk * kBoxBytes : 0;
  const int per_box = (res ? 0 : kWideConsumers * kBoxBytes) + kBoxBytes;
  const int room = kWideSmem - 2048 - (own + 1023) / 1024 * 1024 - WideBars::bytes(kMaxStages);
  int gb = room / (2 * per_box);
  gb = gb < nk ? (gb < 1 ? 1 : gb) : nk;
  const WideSmem ss = wide_smem(own, gb * per_box);
  const WideSmem sp = wide_smem(0, Prod<1>::kSlot);
  const WideSmem skv = wide_smem(0, Prod<2>::kSlot);
  if (ss.stages == 0 || sp.stages == 0 || skv.stages == 0)
    return cudaErrorInvalidValue;
  const void* src[4] = {a.q, a.k, a.v, a.dout};
  void* const dst[4] = {w.rows_at(a.ws, 0), w.rows_at(a.ws, 1), w.rows_at(a.ws, 2),
                        w.rows_at(a.ws, 3)};
  const void* rows[4];
  const int lds = wide_rows<uint16_t>(rows, src, dst, 4, (long long)B * S * H, D, a.ld, a.padded,
                                      a.stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* stats = w.stats_at(a.ws);
  float* logits = w.logits_at(a.ws);
  T* dpw = static_cast<T*>(w.dp_at(a.ws));
  CUtensorMap mq, mk, mv, mo, ml, mdp;
  if (!map_heads<T>(&mq, rows[0], B, S, H, D, lds, kBlockRows) ||
      !map_heads<T>(&mk, rows[1], B, S, H, D, lds, kBlockRows) ||
      !map_heads<T>(&mv, rows[2], B, S, H, D, lds, kBlockRows) ||
      !map_heads<T>(&mo, rows[3], B, S, H, D, lds, kBlockRows) ||
      !map_scores(&ml, logits, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B * H, S, kTile) ||
      !map_scores(&mdp, dpw, MapType<T>::kType, 2, B * H, S, kTile))
    return cudaErrorInvalidValue;
  const float scale = kLog2e / sqrtf((float)D), dscale = 1.0f / sqrtf((float)D);
  const int pairs = div_up(S, kWideConsumers * kBlockRows), blocks = div_up(S, kBlockRows);
  const int nq = div_up(D, 2 * kChunk), nkv = div_up(D, kChunk);
  const float* cstats = stats;
  // S once (the logits, m, 1/l), dP once (dP, Delta), then the gradients
  // from the stored scores
  err = launch_wide_kernel(wide_score_kernel<T, 0>, ss, dim3(pairs, H, B), a.stream, mq, mk,
                           a.bias, stats, logits, dpw, ss, S, H, D, scale, (int)res, gb);
  if (err == cudaSuccess)
    err = launch_wide_kernel(wide_score_kernel<T, 1>, ss, dim3(pairs, H, B), a.stream, mo, mv,
                             a.bias, stats, logits, dpw, ss, S, H, D, scale, (int)res, gb);
  if (err == cudaSuccess)
    err = launch_wide_kernel(wide_product_kernel<T, 1, Prod<1>::kNb>, sp, dim3(blocks * nq, H, B),
                             a.stream, ml, mdp, mk, mk, cstats, static_cast<T*>(a.dq),
                             static_cast<T*>(a.dq), sp, S, H, D, dscale);
  if (err == cudaSuccess)
    err = launch_wide_kernel(wide_product_kernel<T, 2, Prod<2>::kNb>, skv,
                             dim3(blocks * nkv, H, B), a.stream, ml, mdp, mo, mq, cstats,
                             static_cast<T*>(a.dk), static_cast<T*>(a.dv), skv, S, H, D, dscale);
  g_last_res = res;
  g_last_tiles = score_tiles(B, S, H);
  g_last_ctas[0] = nq;
  g_last_ctas[1] = nkv;
  g_last_dc[0] = g_last_dc[1] = kChunk;
  g_last_tma = !a.padded;
  return err;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16 (float32 past 256 columns is
// csrc/mha_wide_f32.cu's rrt_mha_wide_f32_bwd). q, k, v, dout (the
// gradient of the forward's output): (B, S, H, ld) contiguous, the head's
// D values first (ld = D: (B, S, H*D)); dq, dk, dv (B, S, H*D); key_bias
// (B, S) f32 contiguous; ws: rrt_mha_wide_ws_floats(1, ..., padded) floats,
// 256-byte aligned; padded as for rrt_mha_wide. D >= 257 (narrower heads
// are mha_bwd.cu's); B, H <= 65535. Route (ops/attention.py:
// backward_route): "wide". Returns a cudaError_t (0 = launched).
extern "C" int rrt_mha_wide_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* key_bias, const void* dout, void* dq, void* dk,
                                void* dv, void* ws, int B, int S, int H, int D, int ld, int padded,
                                void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  if (B <= 0 || S <= 0 || H <= 0 || D < kMinWideD || ld < D || B > 65535 || H > 65535 ||
      (!padded && !rows_in_place(ld, 2, ptrs, 4)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(key_bias), dq, dk, dv, ws,
               B, S, H, D, ld, padded != 0, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)launch_wide_bwd<__nv_bfloat16>(a);
    case 1: return (int)launch_wide_bwd<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient columns a warpgroup of the last call's dQ kernel (which =
// 0) or dK / dV kernel (1) stored.
extern "C" int rrt_mha_wide_bwd_last_dc(int which) { return g_last_dc[which ? 1 : 0]; }

// Whether the last call's score kernels kept their own rows (Q's, dO's
// boxes) resident in shared memory (bit 0; the gradient kernels have no
// own rows).
extern "C" int rrt_mha_wide_bwd_last_resident() { return g_last_res; }

// How the last call shared each row block's S and dP, for kernel = 0 (dQ)
// or 1 (dK / dV): what = 0 the tiles of S (and of dP) one contraction
// covers at its shape (rrt_mha_wide_bwd_score_tiles counts those the
// kernels contracted), 1 the kernel's CTAs that read them back, 2 whether
// TMA read the rows in place (1) or from the padded copies (0).
extern "C" long long rrt_mha_wide_bwd_last_split(int kernel, int what) {
  return what == 0 ? g_last_tiles : what == 1 ? g_last_ctas[kernel ? 1 : 0] : g_last_tma;
}

// The tiles the backward's score kernels contracted since this was last
// called for `mode` (0: S, 1: dP; then zero; waits for the device).
extern "C" long long rrt_mha_wide_bwd_score_tiles(int mode) { return take_score_tiles(mode); }
