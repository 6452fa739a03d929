"""BM25 Okapi over the candidate pool and over the whole corpus.

Counterparts of `review_recommender_tpu/ops/bm25.py` (k1 = 1.5, b = 0.75).
Inputs use the index layout: per-doc padded unique-term ids (0 = PAD) with
term frequencies or eager contributions; the query side is (Q,) padded term
ids with per-term idf (0 for PAD / unknown terms).

The full-corpus scans (`bm25_full_scores`, `bm25_full_scores_eager`) loop
over the query slots in slot order with the JAX scan's expression order, so
scores match it bit for bit: per slot the matched tf values are integers,
whose f32 sum is exact in any order. The hand-written kernels for the same
scores live in ops/bm25_kernel.py.
"""
from __future__ import annotations

import torch

from review_recommender_tpu_torch.ops.dense import NEG_INF, stable_topk

K1 = 1.5
B = 0.75


def _tf_norm(doc_len: torch.Tensor, avgdl) -> torch.Tensor:
    """k1 * (1 - b + b * dl/avgdl). avgdl becomes an f32 tensor on doc_len's
    device: on CUDA, division by a host scalar is a multiply by its
    reciprocal, which rounds differently."""
    avgdl = torch.as_tensor(avgdl, dtype=torch.float32, device=doc_len.device)
    return K1 * (1.0 - B + B * doc_len / avgdl)


def bm25_candidate_scores(
    doc_terms: torch.Tensor,  # (..., P, L) int32
    doc_tf: torch.Tensor,  # (..., P, L) f32
    doc_len: torch.Tensor,  # (..., P) f32
    q_terms: torch.Tensor,  # (..., Q) int32, 0 = pad
    q_idf: torch.Tensor,  # (..., Q) f32
    avgdl,  # scalar f32 tensor
) -> torch.Tensor:
    """BM25 scores (..., P) of a small candidate pool, via a (..., P, L, Q)
    match; leading axes are a batch of queries, each with its own terms."""
    match = doc_terms[..., :, :, None] == q_terms[..., None, None, :]
    tf = torch.where(match, doc_tf[..., :, :, None], 0.0).sum(dim=-2)  # (..., P, Q)
    norm = _tf_norm(doc_len, avgdl)[..., None]
    contrib = q_idf[..., None, :] * tf * (K1 + 1.0) / (tf + norm)
    return contrib.sum(dim=-1).to(torch.float32)


def bm25_candidate_scores_eager(
    doc_terms: torch.Tensor,  # (..., P, L) int32
    doc_bm25: torch.Tensor,  # (..., P, L) f32 precomputed contributions
    q_terms: torch.Tensor,  # (..., Q) int32, 0 = pad
) -> torch.Tensor:
    """Eager BM25 (..., P): the masked sum of precomputed contributions.
    PAD query slots match only PAD doc lanes, whose contribution is 0."""
    match = doc_terms[..., :, :, None] == q_terms[..., None, None, :]
    return torch.where(match, doc_bm25[..., :, :, None], 0.0).sum(dim=(-2, -1)).to(torch.float32)


def bm25_full_scores(
    doc_terms: torch.Tensor,  # (N, L) int32, or (L, N) with lane_dim=0
    doc_tf: torch.Tensor,  # f32, doc_terms' shape
    doc_len: torch.Tensor,  # (N,) f32
    q_terms: torch.Tensor,  # (Q,) int32
    q_idf: torch.Tensor,  # (Q,) f32
    avgdl,
    lane_dim: int = 1,
) -> torch.Tensor:
    """BM25 scores (N,) over the whole corpus: one masked sum per query slot.
    lane_dim=0 takes transposed (L, N) postings (the packed layout)."""
    norm = _tf_norm(doc_len, avgdl)
    scores = torch.zeros(doc_len.shape[0], dtype=torch.float32, device=doc_len.device)
    for tid, idf in zip(q_terms, q_idf):
        tf = torch.where(doc_terms == tid, doc_tf, 0.0).sum(dim=lane_dim)
        scores = scores + idf * tf * (K1 + 1.0) / (tf + norm)
    return scores


def bm25_full_scores_eager(
    doc_terms: torch.Tensor,  # (N, L) int32
    doc_bm25: torch.Tensor,  # (N, L) f32
    q_terms: torch.Tensor,  # (Q,) int32
) -> torch.Tensor:
    """Full-corpus eager BM25 (N,): one masked sum of contributions per slot."""
    scores = torch.zeros(doc_terms.shape[0], dtype=torch.float32, device=doc_terms.device)
    for tid in q_terms:
        scores = scores + torch.where(doc_terms == tid, doc_bm25, 0.0).sum(dim=1)
    return scores


def masked_topk(scores: torch.Tensor, valid: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Invalid rows to -inf, then a stable top-k: (scores, idx), ties in
    row order as `lax.top_k` breaks them."""
    scores = torch.where(valid, scores, NEG_INF)
    return stable_topk(scores, min(int(k), scores.shape[0]))


def bm25_topk(doc_terms, doc_tf, doc_len, valid, q_terms, q_idf, avgdl,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Standalone sparse retrieval: full-corpus BM25 + top-k."""
    return masked_topk(bm25_full_scores(doc_terms, doc_tf, doc_len, q_terms, q_idf, avgdl),
                       valid, k)
