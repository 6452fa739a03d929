"""Best-review snippet scoring: per-product segment max over review sims.

Counterpart of `review_recommender_tpu/ops/segment.py:23-50`. One (M, D) x
(D, B) product of the review embeddings with the query vectors (an f32
result from a bf16 corpus, as `ops/dense.py:dense_scores`), then a segment
max keyed by each review's product row: `scatter_reduce("amax")` over
num_products + 1 segments, the last a discard bucket for invalid rows and
reviews of unknown products. In the JAX package both steps are XLA code
(`jnp.dot`, `jax.ops.segment_max`), not a Pallas kernel, so they stay plain
torch here.

A product with no valid review gets -inf (segment_max's identity), which
lies below the engine's SNIPPET_NONE (-1e30), so the `> SNIPPET_NONE`
filters drop it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from review_recommender_tpu_torch.ops.dense import matmul_f32

NEG = -3.4e38


def best_review_scores(
    rev_emb: torch.Tensor,  # (M_pad, D)
    rev_product: torch.Tensor,  # (M_pad,) int32 segment ids, num_products = discard
    rev_valid: torch.Tensor,  # (M_pad,) bool
    qvec: torch.Tensor,  # (D,) or (B, D)
    num_products: int,
) -> torch.Tensor:
    """(..., num_products) best review cosine sim per product for qvec (D,)
    or each row of a batch (B, D); -inf where a product has no valid
    review."""
    d = qvec.shape[-1]
    q = qvec.to(rev_emb.dtype).reshape(-1, d)  # (B, D)
    sims = matmul_f32(rev_emb, q.T)  # (M, B) f32
    sims = torch.where(rev_valid[:, None], sims, NEG)
    seg = torch.where(rev_valid, rev_product.to(torch.int64), num_products)
    best = torch.full((num_products + 1, q.shape[0]), float("-inf"), dtype=torch.float32,
                      device=sims.device)
    best.scatter_reduce_(0, seg[:, None].expand_as(sims), sims, "amax", include_self=True)
    return best[:num_products].T.reshape(*qvec.shape[:-1], num_products)


def best_review_argmax_host(sims, rev_product, product_row: int) -> Optional[int]:
    """Host helper: index of the best review for one product row (None
    when the product has no review)."""
    mask = np.asarray(rev_product) == product_row
    if not mask.any():
        return None
    idxs = np.nonzero(mask)[0]
    return int(idxs[np.argmax(np.asarray(sims)[idxs])])
