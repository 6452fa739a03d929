// Multi-head attention forward for Hopper (sm_90a) at head widths past 256:
// softmax(Q K^T * 1/sqrt(d) + key_bias) V for bf16 and f16 at any D >= 257,
// any S >= 1 (f32 past 256 is csrc/mha_wide_f32.cu's).
//
// Replaces, beside csrc/mha_fwd.cu and csrc/mha_generic.cu (which take D
// up to 256), the TPU kernel
// review_recommender_tpu/ops/pallas/attention_kernel.py:_mha_kernel (:64,
// reached through mha_pallas :92), which blocks each (batch, head) as (1,
// 1, S, D) whatever D is. ops/attention.py:kernel_route sends D > 256 here
// (route "wide"). q, k, v and out are (B, S, H*D) row-major; key_bias (B,
// S) f32 (0 keep, -1e30 drop).
//
// A 64-row O of D columns does not fit a warpgroup's registers past 256
// columns, so the output columns go in chunks of kChunk = 192, one a
// warpgroup. The first design gave each chunk's warpgroup the whole
// contraction of S again (three S products beside one P V at D = 384), its
// operands copied from L2 by cp.async. This one (csrc/mha_wide.cuh) takes
// two kernels a call:
//   - the score kernel (wide_score_kernel, MODE 0): two 64-row blocks a
//     CTA, Q's boxes resident (streamed beside K's past 640 columns), K's
//     streamed by TMA, contracts each tile of S once over the whole D,
//     writes the logits s * scale + bias in log2 units (-inf at keys >= S)
//     to a workspace of B * H * S * SK f32 (SK = S up to a multiple of 64)
//     and each row's m and 1/l;
//   - the output kernel (wide_product_kernel, KIND 0): a 64-row block and
//     two chunks a CTA, one a warpgroup; each key tile's stored logits and
//     both chunks' V boxes land in one ring slot; P = 2^(L - m) / l, rounded
//     to T as the plain version rounds it (the two-pass rule), is formed
//     a k-step at a time as wgmma's A registers, and O[:, chunk] += P
//     V[:, chunk] reads V's boxes N-major through the transpose bit.
// So S is contracted once per row block in the whole call. Rows TMA cannot
// read in place (D * 2 bytes not a multiple of 16, or a base not 16-byte
// aligned) are first copied into rows of D rounded up to 8
// (wide_pad_kernel) in the workspace. The design that split each tile's
// contraction across a thread-block cluster and summed the partial tiles
// through distributed shared memory contracted S once per row block in
// each kernel but spent 4-7K cycles a tile on the cluster's signals and
// reads, and took 0.54-0.57 ms (PERF.md).
//
// What bounds it on an H100 SXM (published peaks at 700 W), at (B, S, H,
// D) = (64, 512, 1, 384): 100.7 MB of q, k, v and out in bf16 at 3.35
// TB/s, 0.030 ms; 25.8 GFLOP of Q K^T and P V at 989 TFLOP/s, 0.026 ms.
// The stored logits add 67 MB written and read once (0.040 ms at 3.35
// TB/s). Measured there: score 80 us, output 94 us, 0.180 ms in all against
// SDPA's 0.219 and the first design's 0.40 (PERF.md; examples/
// torch_attention_ab.py --kernel wide_heads, H100 at 700 W).
//
// Semantics, both dtypes:
//   - an all-masked row (every bias -1e30) comes out uniform over the S
//     real keys: (q.k)*scale - 1e30 == -1e30 in f32;
//   - keys from S to SK get logit -inf and zero V rows (TMA fills past S
//     and past D with zeros);
//   - query rows >= S and columns >= D are not stored.
//
// The kernels allocate nothing and do not synchronise; they launch on the
// stream they are given and the C entry returns cudaGetLastError().

#include "mha_wide.cuh"

namespace {

// the last call's plan (host side; read by the rrt_mha_wide_last_* entries):
// own rows resident, the tiles of S of one contraction, the output kernel's
// CTAs a block and columns a warpgroup, TMA in place
int g_last_res = 0, g_last_ctas = 0, g_last_dc = 0, g_last_tma = 0;
long long g_last_tiles = 0;

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const float* bias, void* out,
                        void* ws, int B, int S, int H, int D, int ld, bool padded,
                        cudaStream_t stream) {
  const WideWs w(false, B, S, H, D, padded);
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
  const WideSmem sp = wide_smem(0, Prod<0>::kSlot);
  if (ss.stages == 0 || sp.stages == 0)
    return cudaErrorInvalidValue;
  const void* src[3] = {q, k, v};
  void* const dst[3] = {w.rows_at(ws, 0), w.rows_at(ws, 1), w.rows_at(ws, 2)};
  const void* rows[3];
  const int lds =
      wide_rows<uint16_t>(rows, src, dst, 3, (long long)B * S * H, D, ld, padded, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* stats = w.stats_at(ws);
  float* logits = w.logits_at(ws);
  CUtensorMap mq, mk, mv, ml;
  if (!map_heads<T>(&mq, rows[0], B, S, H, D, lds, kBlockRows) ||
      !map_heads<T>(&mk, rows[1], B, S, H, D, lds, kTile) ||
      !map_heads<T>(&mv, rows[2], B, S, H, D, lds, kTile) ||
      !map_scores(&ml, logits, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B * H, S, kBlockRows))
    return cudaErrorInvalidValue;
  const float scale = kLog2e / sqrtf((float)D);  // logits in log2 units
  const int pairs = div_up(S, kWideConsumers * kBlockRows), blocks = div_up(S, kBlockRows);
  const int ncta = div_up(D, 2 * kChunk);
  T* o = static_cast<T*>(out);
  err = launch_wide_kernel(wide_score_kernel<T, 0>, ss, dim3(pairs, H, B), stream, mq, mk, bias,
                           stats, logits, static_cast<T*>(nullptr), ss, S, H, D, scale, (int)res, gb);
  if (err == cudaSuccess)
    err = launch_wide_kernel(wide_product_kernel<T, 0, Prod<0>::kNb>, sp,
                             dim3(blocks * ncta, H, B), stream, ml, ml, mv, mv,
                             static_cast<const float*>(stats), o, o, sp, S, H, D, 1.f);
  g_last_res = res;
  g_last_tiles = score_tiles(B, S, H);
  g_last_ctas = ncta;
  g_last_dc = kChunk;
  g_last_tma = !padded;
  return err;
}

}  // namespace

// Floats of workspace a call takes (backward 0: this forward; 1: csrc/
// mha_wide_bwd.cu's): the row statistics, the stored scores, and, where
// padded, the copied rows (csrc/mha_wide.cuh's WideWs).
extern "C" long long rrt_mha_wide_ws_floats(int backward, int B, int S, int H, int D, int padded) {
  return WideWs(backward != 0, B, S, H, D, padded != 0).total / 4;
}

// dtype: 0 = bfloat16, 1 = float16 (float32 past 256 columns is
// csrc/mha_wide_f32.cu's rrt_mha_wide_f32). Shapes: q, k, v (B, S, H, ld)
// contiguous, the head's D values first (ld = D: (B, S, H*D)); out (B, S,
// H*D); key_bias (B, S) f32 contiguous; ws: rrt_mha_wide_ws_floats(0, ...,
// padded) floats, 256-byte aligned; padded: copy the rows first (required
// where ld * 2 is not a multiple of 16 or a base is not 16-byte aligned).
// D >= 257 (narrower heads are mha_fwd.cu's and mha_generic.cu's); B, H <=
// 65535. Returns a cudaError_t (0 = launched).
extern "C" int rrt_mha_wide(int dtype, const void* q, const void* k, const void* v,
                            const void* key_bias, void* out, void* ws, int B, int S, int H, int D,
                            int ld, int padded, void* stream) {
  const void* ptrs[3] = {q, k, v};
  if (B <= 0 || S <= 0 || H <= 0 || D < kMinWideD || ld < D || B > 65535 || H > 65535 ||
      (!padded && !rows_in_place(ld, 2, ptrs, 3)))
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(key_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_wide<__nv_bfloat16>(q, k, v, bias, out, ws, B, S, H, D, ld, padded, st);
    case 1: return (int)launch_wide<__half>(q, k, v, bias, out, ws, B, S, H, D, ld, padded, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The output columns each warpgroup of the last call's output kernel
// stored.
extern "C" int rrt_mha_wide_last_dc() { return g_last_dc; }

// Whether the last call's score kernel kept its own rows (Q's boxes)
// resident in shared memory (bit 0; the output kernel has no own rows).
extern "C" int rrt_mha_wide_last_resident() { return g_last_res; }

// How the last call shared each row block's scores: what = 0 the tiles of
// S one contraction covers at its shape (rrt_mha_wide_score_tiles counts
// those the kernels contracted), 1 the output kernel's CTAs that read them
// back, 2 whether TMA read the rows in place (1) or from the padded copies
// (0).
extern "C" long long rrt_mha_wide_last_split(int what) {
  return what == 0 ? g_last_tiles : what == 1 ? g_last_ctas : g_last_tma;
}

// The tiles of S the forward's score kernel contracted since this was
// last called (then zero; waits for the device): rrt_mha_wide_last_split(0)
// a call where each tile is contracted once.
extern "C" long long rrt_mha_wide_score_tiles() { return take_score_tiles(0); }
