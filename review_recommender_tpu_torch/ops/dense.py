"""Dense cosine pool: matmul + stable top-k, exact or striped, over a
bf16/f16/f32 corpus or a per-row int8 one.

Counterparts of `review_recommender_tpu/ops/dense.py:19-288`, the int8
forms with one corpus-wide scale (`:229-288`, which the JAX package's
examples/int8_scan_tuning.py and examples/roofline.py measure) included.
The JAX package computes these products in XLA outside any Pallas
kernel, so here they stay library matmuls: torch.mm for the float
corpora (f32 result) and torch._int_mm for int8 (int32 result, exact).
Top-k is a stable descending sort cut to k, which keeps `lax.top_k`'s
order on ties (lower index first); `torch.topk` does not promise that.

The int8 forms quantize each query symmetrically (round half to even, as
jnp.round), accumulate int8 x int8 in int32 and rescale as the JAX
package does, `acc.f32 * (row_scale * q_scale)`, so ids and scores are
bit-equal to it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, descending, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result. On CUDA, bf16/f16 operands go to the GEMM
    as they are with an f32 output; elsewhere both are upcast (bf16/f16
    products are exact in f32, so the sums are f32 sums either way)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def dense_scores(emb: torch.Tensor, qvec: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cosine scores (..., N_pad) f32 for qvec (D,) or (B, D); padding rows
    are -inf."""
    q = qvec.to(emb.dtype)
    sims = matmul_f32(q.reshape(-1, q.shape[-1]), emb.T).reshape(*q.shape[:-1], -1)
    return torch.where(valid, sims, NEG_INF)


def dense_topk(emb: torch.Tensor, qvec: torch.Tensor, valid: torch.Tensor,
               pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-`pool` rows by cosine score: (scores, idx) descending; tail
    scores are -inf when fewer than `pool` rows are valid. qvec (D,) or
    (B, D): one (N, D) x (D, B) product for the batch."""
    sims = dense_scores(emb, qvec, valid)
    return stable_topk(sims, min(int(pool), sims.shape[-1]))


def dense_topk_batched(emb: torch.Tensor, qvecs: torch.Tensor, valid: torch.Tensor,
                       pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """qvecs (B, D) -> (B, pool) scores and row ids (`ops/dense.py:
    dense_topk_batched` of the JAX package): dense_topk on a batch."""
    return dense_topk(emb, qvecs, valid, pool)


def striped_topk(sims: torch.Tensor, pool: int,
                 stripes: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stripe max/argmax over contiguous stripes, then an exact top-k
    over the stripe maxima. Scores are exact; membership loses a true
    top-pool row only when another pool row shares its stripe."""
    n = sims.shape[-1]
    g = min(int(stripes), n)
    s = -(-n // g)
    padded = g * s
    if padded != n:
        sims = torch.nn.functional.pad(sims, (0, padded - n), value=NEG_INF)
    x = sims.reshape(*sims.shape[:-1], g, s)
    smax = x.amax(dim=-1)
    sarg = x.argmax(dim=-1)
    top, gi = stable_topk(smax, min(int(pool), g))
    idx = gi * s + torch.gather(sarg, -1, gi)
    return top, idx


def slice_corpus_for_striped(emb: torch.Tensor, valid: torch.Tensor,
                             stripes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad the corpus to s*G rows and view it as (s, G, D) slices and (s, G)
    validity. Stripe g is the strided row set {g, G+g, 2G+g, ...}."""
    n, d = emb.shape
    g = min(int(stripes), n)
    s = -(-n // g)
    pad = s * g - n
    if pad:
        emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return emb.reshape(s, g, d), valid.reshape(s, g)


def dense_striped_topk_scan(emb_s: torch.Tensor, valid_s: torch.Tensor,
                            qvec: torch.Tensor,
                            pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Striped pool over the (s, G, D) slices for qvec (D,) or a batch
    (B, D).

    The JAX scan folds slice r into running per-stripe (max, argmax) with a
    strict `>`, so the first slice wins ties and an all-invalid stripe keeps
    (-inf, 0). Scoring every slice at once, in one (s*G, D) x (D, B)
    product, and taking argmax over the slice axis (first maximum) gives
    the same pair for each query. Returns (scores (..., pool) f32
    descending, rows (..., pool) int64 with row = r*G + g)."""
    s, g, d = emb_s.shape
    q = qvec.to(emb_s.dtype).reshape(-1, d)  # (B, D)
    sims = matmul_f32(emb_s.reshape(s * g, d), q.T).reshape(s, g, -1)
    sims = torch.where(valid_s[..., None], sims, NEG_INF)
    best_r = sims.argmax(dim=0)  # (G, B)
    best = torch.gather(sims, 0, best_r[None]).squeeze(0)
    top, gi = stable_topk(best.T, min(int(pool), g))  # (B, pool)
    rows = torch.gather(best_r.T, 1, gi) * g + gi
    return top.reshape(*qvec.shape[:-1], -1), rows.reshape(*qvec.shape[:-1], -1)


# ------------------------------------------------------------------- int8
def quantize_corpus_int8(emb) -> tuple:
    """Symmetric per-row int8 quantization of a unit-row corpus (host):
    (emb_q (N, D) int8, row_scale (N,) f32) as numpy, op for op the JAX
    package's."""
    emb = np.asarray(emb, dtype=np.float32)
    scale = np.abs(emb).max(axis=1) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(emb / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_query_int8(qvec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """qvec (..., D) -> (q_q (..., D) int8, q_scale (..., 1) f32): one
    symmetric scale per query."""
    q = qvec.to(torch.float32)
    amax = q.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which can land one ulp away from the JAX package's division
    q_scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q_q = torch.clamp(torch.round(q / q_scale), -127, 127).to(torch.int8)
    return q_q, q_scale


def int8_matmul(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b_rows (N, K).T int8 -> (M, N) int32, exact.

    torch._int_mm (cuBLASLt on CUDA) wants more than 16 rows in a and K, N
    multiples of 8, so a is padded to 17+ rows and K and N up to multiples
    of 8 with zeros (which add nothing), on every device; b_rows is read as
    a column-major (K, N) view, without a copy where no padding is
    needed."""
    m, k = a.shape
    n = b_rows.shape[0]
    pad_k, pad_n = (-k) % 8, (-n) % 8
    pad_m = max(17 - m, 0)
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b_rows = F.pad(b_rows, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a, b_rows.T)
    return out[:m, :n] if (pad_m or pad_n) else out


def dense_scores_int8(emb_q: torch.Tensor, row_scale: torch.Tensor, qvec: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Cosine scores (..., N) f32 over an int8 corpus for qvec (D,) or
    (B, D): the query quantized, int8 x int8 -> int32, rescaled in f32;
    padding rows -inf."""
    q_q, q_scale = quantize_query_int8(qvec.reshape(-1, qvec.shape[-1]))
    acc = int8_matmul(q_q, emb_q)  # (B, N)
    sims = acc.to(torch.float32) * (row_scale[None, :] * q_scale)
    sims = torch.where(valid, sims, NEG_INF)
    return sims.reshape(*qvec.shape[:-1], -1)


def dense_topk_int8(emb_q: torch.Tensor, row_scale: torch.Tensor, qvec: torch.Tensor,
                    valid: torch.Tensor, pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-`pool` rows of dense_scores_int8: (scores, idx) descending."""
    sims = dense_scores_int8(emb_q, row_scale, qvec, valid)
    return stable_topk(sims, min(int(pool), sims.shape[-1]))


def slice_corpus_for_striped_int8(emb_q: torch.Tensor, row_scale: torch.Tensor,
                                  valid: torch.Tensor, stripes: int):
    """int8 slice_corpus_for_striped: (s, G, D) int8 slices, (s, G) row
    scales and (s, G) validity."""
    n, d = emb_q.shape
    g = min(int(stripes), n)
    s = -(-n // g)
    pad = s * g - n
    if pad:
        emb_q = F.pad(emb_q, (0, 0, 0, pad))
        row_scale = F.pad(row_scale, (0, pad))
        valid = F.pad(valid, (0, pad))
    return emb_q.reshape(s, g, d), row_scale.reshape(s, g), valid.reshape(s, g)


def dense_striped_topk_scan_int8(emb_qs: torch.Tensor, scale_s: torch.Tensor,
                                 valid_s: torch.Tensor, qvec: torch.Tensor,
                                 pool: int) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 dense_striped_topk_scan for qvec (D,) or (B, D): the query
    quantizes once, every slice is scored in one int8 product and rescaled
    in f32, then each stripe keeps its first maximum over the slices.
    Returns (scores (..., pool) f32, rows (..., pool) int64, row = r*G+g)."""
    s, g, d = emb_qs.shape
    q_q, q_scale = quantize_query_int8(qvec.reshape(-1, d))  # (B, D), (B, 1)
    acc = int8_matmul(q_q, emb_qs.reshape(s * g, d)).reshape(-1, s, g)
    sims = acc.to(torch.float32) * (scale_s[None] * q_scale[:, :, None])
    sims = torch.where(valid_s[None], sims, NEG_INF)
    best_r = sims.argmax(dim=1)  # (B, G), the first maximum
    best = torch.gather(sims, 1, best_r[:, None]).squeeze(1)
    top, gi = stable_topk(best, min(int(pool), g))
    rows = torch.gather(best_r, 1, gi) * g + gi
    return top.reshape(*qvec.shape[:-1], -1), rows.reshape(*qvec.shape[:-1], -1)


# ------------------------------------------------------- int8, one scale
# the accumulator of an invalid row and the carries' start (JAX's
# _INT32_MIN): one above int32's minimum, below any real accumulator
INT32_SENTINEL = -2**31 + 1


def quantize_corpus_int8_global(emb) -> tuple:
    """Symmetric int8 quantization with ONE corpus-wide scale (host): (emb_q
    (N, D) int8 numpy, scale float), op for op the JAX package's. Coarser
    than the per-row scheme, but the scan's stripe carries can then compare
    raw int32 accumulators."""
    emb = np.asarray(emb, dtype=np.float32)
    scale = max(float(np.abs(emb).max()) / 127.0, 1e-12)
    q = np.clip(np.rint(emb / scale), -127, 127).astype(np.int8)
    return q, scale


def dense_striped_topk_scan_int8_global(emb_qs: torch.Tensor, valid_s: torch.Tensor,
                                        qvec: torch.Tensor, pool: int,
                                        corpus_scale) -> tuple[torch.Tensor, torch.Tensor]:
    """Global-scale int8 striped pool for qvec (D,) or (B, D) over the
    (s, G, D) int8 slices of slice_corpus_for_striped_int8 (its row scales
    unused) and their (s, G) validity.

    The JAX scan folds slice r's int32 accumulators, INT32_SENTINEL where
    the row is invalid, into per-stripe (max, argmax) carries that start at
    (INT32_SENTINEL, 0) under a strict `>`; here every slice is scored in
    one int8 product and each stripe takes its first maximum over the
    slices, the same pair. Only the pool's winners convert to float: a
    sentinel becomes -inf, any other accumulator acc.f32 * (f32(corpus_scale)
    * q_scale). Returns (scores (..., pool) f32, rows (..., pool) int64,
    row = r*G + g)."""
    s, g, d = emb_qs.shape
    q_q, q_scale = quantize_query_int8(qvec.reshape(-1, d))  # (B, D), (B, 1)
    acc = int8_matmul(q_q, emb_qs.reshape(s * g, d)).reshape(-1, s, g)
    acc = torch.where(valid_s[None], acc, INT32_SENTINEL)
    best_r = acc.argmax(dim=1)  # (B, G), the first maximum
    best = torch.gather(acc, 1, best_r[:, None]).squeeze(1)
    top, gi = stable_topk(best, min(int(pool), g))
    scale = torch.full_like(q_scale, float(np.float32(corpus_scale))) * q_scale
    scores = torch.where(top <= INT32_SENTINEL, NEG_INF, top.to(torch.float32) * scale)
    rows = torch.gather(best_r, 1, gi) * g + gi
    return scores.reshape(*qvec.shape[:-1], -1), rows.reshape(*qvec.shape[:-1], -1)
