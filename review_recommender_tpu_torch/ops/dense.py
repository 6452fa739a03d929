"""Dense cosine pool: matmul + stable top-k, exact or striped.

Counterparts of `review_recommender_tpu/ops/dense.py:19-139`. The JAX
package computes these products in XLA outside any Pallas kernel, so here
they stay library matmuls (a hand-written fused scan comes later). Scores
are f32: bf16 corpora multiply into an f32 result. Top-k is a stable
descending sort cut to k, which keeps `lax.top_k`'s order on ties (lower
index first); `torch.topk` does not promise that.
"""
from __future__ import annotations

import torch

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
