"""BM25 Okapi over the candidate pool.

Counterparts of `review_recommender_tpu/ops/bm25.py:39-92` (k1 = 1.5,
b = 0.75). Inputs use the index layout: per-doc padded unique-term ids
(0 = PAD) with term frequencies or eager contributions; the query side is
(Q,) padded term ids with per-term idf (0 for PAD / unknown terms).
"""
from __future__ import annotations

import torch

K1 = 1.5
B = 0.75


def _tf_norm(doc_len: torch.Tensor, avgdl) -> torch.Tensor:
    """k1 * (1 - b + b * dl/avgdl)."""
    return K1 * (1.0 - B + B * doc_len / avgdl)


def bm25_candidate_scores(
    doc_terms: torch.Tensor,  # (P, L) int32
    doc_tf: torch.Tensor,  # (P, L) f32
    doc_len: torch.Tensor,  # (P,) f32
    q_terms: torch.Tensor,  # (Q,) int32, 0 = pad
    q_idf: torch.Tensor,  # (Q,) f32
    avgdl,  # scalar f32 tensor
) -> torch.Tensor:
    """BM25 scores of a small candidate pool, via a (P, L, Q) match."""
    match = doc_terms[:, :, None] == q_terms[None, None, :]
    tf = torch.where(match, doc_tf[:, :, None], 0.0).sum(dim=1)  # (P, Q)
    norm = _tf_norm(doc_len, avgdl)[:, None]
    contrib = q_idf[None, :] * tf * (K1 + 1.0) / (tf + norm)
    return contrib.sum(dim=1).to(torch.float32)


def bm25_candidate_scores_eager(
    doc_terms: torch.Tensor,  # (P, L) int32
    doc_bm25: torch.Tensor,  # (P, L) f32 precomputed contributions
    q_terms: torch.Tensor,  # (Q,) int32, 0 = pad
) -> torch.Tensor:
    """Eager BM25: the masked sum of precomputed contributions. PAD query
    slots match only PAD doc lanes, whose contribution is 0."""
    match = doc_terms[:, :, None] == q_terms[None, None, :]
    return torch.where(match, doc_bm25[:, :, None], 0.0).sum(dim=(1, 2)).to(torch.float32)
