"""Fused candidate scoring and the final stable top-k.

Counterpart of `review_recommender_tpu/ops/fusion.py:34-150`:

  dense   = minmax(pool cosine scores)
  bm25    = minmax(bm25 raw)
  prior   = minmax(bayes(avg_stars, n, C)) * 0.7 + 0.3 * log1p(n)/max(log1p(n))
  rerank  = minmax over the rerank lanes, zeros elsewhere
  best    = minmax(best-snippet sims) if snippets were computed else zeros
            (has_snippets: a bool, or one flag per query of a batch)
  trust   = 0.6*ramp(n/min_reviews) + 0.4*log-saturation(n, 80)
  final   = (w . signals) * trust * gate, -inf on invalid lanes

Statistics run over valid lanes only. A NaN avg_stars in a valid lane makes
the Bayesian mean NaN and zeroes the prior's minmax lane, as in the JAX
package and the reference.

Every input may carry leading batch axes, (B, P) for B queries: each
statistic reduces over the pool axis (the last) of its own row, which is
what the JAX package gets from vmap. The weights are Python floats shared
by the batch, or (B, 1) f32 tensors, one set per query.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from review_recommender_tpu_torch.ops.dense import stable_topk
from review_recommender_tpu_torch.utils.numerics import minmax_normalize_masked


class FusionWeights(NamedTuple):
    """Fusion knobs as plain floats (torch takes Python scalars in f32 ops,
    so there are no device scalars to cache), or as (B, 1) f32 tensors for
    per-query knobs (engine/query_forms.py:_fused_packed_pw)."""

    w_dense: float
    w_bm25: float
    w_rerank: float
    w_prior: float
    w_best: float
    prior_c: float
    min_reviews: float
    gate_penalty: float

    @classmethod
    def make(cls, w_dense=0.55, w_bm25=0.20, w_rerank=0.20, w_prior=0.20,
             w_best=0.10, prior_c=20.0, min_reviews=8, gate_penalty=0.5):
        return cls(float(w_dense), float(w_bm25), float(w_rerank),
                   float(w_prior), float(w_best), float(prior_c),
                   float(min_reviews), float(gate_penalty))


class FusionResult(NamedTuple):
    final: torch.Tensor  # (..., P) f32, -inf on invalid lanes
    dense: torch.Tensor
    bm25: torch.Tensor
    rerank: torch.Tensor
    prior: torch.Tensor
    best: torch.Tensor
    trust: torch.Tensor
    gate: torch.Tensor


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float or a (B, 1) tensor as f32 on like's device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _trust(n: torch.Tensor, min_reviews, sat: float = 80.0) -> torch.Tensor:
    """Trust with the engine's saturation of 80 reviews."""
    ramp = torch.clamp(n / torch.clamp(_f32(min_reviews, n), min=1.0), 0.0, 1.0)
    satv = torch.clamp(torch.log1p(n) / torch.log1p(_f32(sat, n)), max=1.0)
    return (0.6 * ramp + 0.4 * satv).to(torch.float32)


def fuse_candidates(
    dense_raw: torch.Tensor,  # (..., P) pool cosine scores
    bm25_raw: torch.Tensor,  # (..., P)
    rerank_raw: torch.Tensor,  # (..., P) cross-encoder scores in the first lanes
    rerank_mask: torch.Tensor,  # (..., P) bool
    best_raw: torch.Tensor,  # (..., P)
    has_snippets,  # bool, or a (..., 1) bool tensor: one flag per query
    n_reviews: torch.Tensor,  # (..., P) f32
    avg_stars: torch.Tensor,  # (..., P) f32, NaN allowed
    gate: torch.Tensor,  # (..., P) f32
    cand_valid: torch.Tensor,  # (..., P) bool
    w: FusionWeights,
) -> FusionResult:
    valid = cand_valid

    dense = minmax_normalize_masked(dense_raw, valid)
    bm25 = minmax_normalize_masked(bm25_raw, valid)

    stars_masked = torch.where(valid, avg_stars, float("nan"))
    gmean = torch.nanmean(stars_masked, dim=-1, keepdim=True)
    prior_c = _f32(w.prior_c, dense_raw)
    prior_rating = ((avg_stars * n_reviews) + (gmean * prior_c)) / (
        n_reviews + prior_c + 1e-9
    )
    log_n = torch.log1p(n_reviews)
    max_log_n = torch.where(valid, log_n, 0.0).amax(dim=-1, keepdim=True)
    prior_volume = log_n / (max_log_n + 1e-9)
    prior = minmax_normalize_masked(prior_rating, valid) * 0.7 + 0.3 * prior_volume
    prior = torch.where(valid, prior, 0.0).to(torch.float32)

    rr_mask = rerank_mask & valid
    rerank = torch.where(rr_mask, minmax_normalize_masked(rerank_raw, rr_mask), 0.0)

    # best snippet: minmax over the whole pool, zero lanes included
    if isinstance(has_snippets, torch.Tensor):
        best = torch.where(has_snippets, minmax_normalize_masked(best_raw, valid), 0.0)
    elif has_snippets:
        best = minmax_normalize_masked(best_raw, valid)
    else:
        best = torch.zeros_like(dense)

    trust = _trust(n_reviews, w.min_reviews)

    final = (
        w.w_dense * dense
        + w.w_bm25 * bm25
        + w.w_rerank * rerank
        + w.w_prior * prior
        + w.w_best * best
    ).to(torch.float32)
    final = final * trust * gate
    final = torch.where(valid, final, float("-inf"))
    return FusionResult(final, dense, bm25, rerank, prior, best, trust, gate)


def final_topk(result: FusionResult, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable descending top-k of the fused scores over the pool axis: ties
    keep pool order (dense-score order), like pandas' stable sort in the
    reference and `lax.top_k` in the JAX package."""
    return stable_topk(result.final, min(int(k), result.final.shape[-1]))
