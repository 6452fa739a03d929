"""Attribute-gate factors on the device.

Counterpart of `review_recommender_tpu/ops/gate.py:34-57`: known phrases hit
through the per-doc gate bitset, dynamic query tokens through membership of
their vocabulary expansion in the candidate's term ids.
"""
from __future__ import annotations

import torch


def gate_factors_device(
    gate_bits: torch.Tensor,  # (..., P, G_phrases) bool
    doc_terms: torch.Tensor,  # (..., P, L) int32
    group_phrase_mask: torch.Tensor,  # (..., G_max, G_phrases) bool
    group_term_ids: torch.Tensor,  # (..., G_max, T_cap) int32, -1 pad
    group_valid: torch.Tensor,  # (..., G_max) bool
    penalty,  # scalar
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (factor (..., P) f32 = penalty^misses, hits (..., P) int32);
    leading axes are a batch of queries, each with its own groups."""
    phrase_hit = (gate_bits[..., :, None, :] & group_phrase_mask[..., None, :, :]).any(dim=-1)
    term_match = doc_terms[..., :, :, None, None] == group_term_ids[..., None, None, :, :]
    term_hit = term_match.any(dim=-1).any(dim=-2)  # (..., P, G_max)
    hit = phrase_hit | term_hit
    g_valid = group_valid[..., None, :]
    n_miss = (g_valid & ~hit).to(torch.int32).sum(dim=-1)
    base = torch.as_tensor(penalty, dtype=torch.float32, device=doc_terms.device)
    factor = torch.pow(base, n_miss.to(torch.float32))
    hits = (g_valid & hit).to(torch.int32).sum(dim=-1)
    return factor.to(torch.float32), hits.to(torch.int32)
