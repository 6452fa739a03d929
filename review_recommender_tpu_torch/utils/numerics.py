"""Numeric primitives of the fusion, in torch, and the result fetch.

Counterparts of `review_recommender_tpu/utils/numerics.py:22-104`, op for
op in float32 so the port agrees with the JAX package to float32 rounding,
and of its `device_fetch` (:107-129).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from review_recommender_tpu_torch.ops.dense import matmul_f32, stable_topk

_BIG = 3.4e38


def l2_normalize(x: torch.Tensor, axis: int = 1, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize along `axis` with an epsilon floor on the norm."""
    n = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=eps)


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to [0, 1] in float32; all zeros on degenerate input
    (every value equal within 1e-12, or a non-finite min or max). An empty
    input comes back empty, as float32."""
    xf = x.to(torch.float32)
    if xf.numel() == 0:
        return xf
    lo, hi = xf.min(), xf.max()
    good = torch.isfinite(lo) & torch.isfinite(hi) & ((hi - lo) >= 1e-12)
    scaled = (xf - lo) / (hi - lo + 1e-12)
    return torch.where(good, scaled, torch.zeros_like(xf))


def minmax_normalize_masked(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max over the `valid` positions of the last axis only; invalid
    positions give 0. A non-finite bound (a NaN or inf in a valid lane) or
    a range below 1e-12 gives the row all zeros, as in the reference.
    Leading axes are a batch: each row has its own bounds (the JAX
    package's vmap)."""
    xf = x.to(torch.float32)
    lo = torch.where(valid, xf, _BIG).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, xf, -_BIG).amax(dim=-1, keepdim=True)
    good = (valid.any(dim=-1, keepdim=True) & torch.isfinite(lo) & torch.isfinite(hi)
            & ((hi - lo) >= 1e-12))
    scaled = (xf - lo) / (hi - lo + 1e-12)
    out = torch.where(good, scaled, torch.zeros_like(xf))
    return torch.where(valid, out, 0.0).to(torch.float32)


def bayesian_prior(
    avg_ratings: torch.Tensor,
    review_counts: torch.Tensor,
    prior_strength: Union[float, torch.Tensor] = 20.0,
    global_mean: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bayesian-shrunk average rating; global_mean defaults to the nanmean
    of avg_ratings."""
    if global_mean is None:
        global_mean = torch.nanmean(avg_ratings)
    return ((avg_ratings * review_counts) + (global_mean * prior_strength)) / (
        review_counts + prior_strength + 1e-9
    )


def trust_score_from_reviews(
    review_counts: torch.Tensor, min_reviews: int = 8, saturation: int = 50
) -> torch.Tensor:
    """Trust: 0.6 * linear ramp + 0.4 * log saturation."""
    ramp = torch.clamp(review_counts / max(min_reviews, 1), 0, 1)
    sat = torch.log1p(torch.tensor(float(max(saturation, 1)), dtype=torch.float32))
    satv = torch.clamp(torch.log1p(review_counts) / sat.to(review_counts.device), max=1.0)
    return (0.6 * ramp + 0.4 * satv).to(torch.float32)


def cosine_similarity_search(query_vector: torch.Tensor, embeddings_matrix: torch.Tensor,
                             top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force cosine top-k: (indices int32, scores f32), descending,
    ties in index order (`lax.top_k`'s), top_k clamped to N. The query is cast to
    the matrix's dtype and the products summed in f32 (a library matmul, as
    JAX leaves `jnp.dot` to XLA)."""
    q = query_vector.to(embeddings_matrix.dtype)
    sims = matmul_f32(embeddings_matrix, q[:, None])[:, 0]
    scores, idx = stable_topk(sims, min(int(top_k), sims.shape[0]))
    return idx.to(torch.int32), scores


def device_fetch(*tensors) -> List[np.ndarray]:
    """Device tensors -> numpy arrays in argument order, with every
    device->host copy started before the one wait: each CUDA tensor is
    copied into a pinned host buffer without blocking, then each device's
    current stream is synchronized once. CPU tensors and other inputs pass
    through np.asarray."""
    pending, waits = [], {}
    for t in tensors:
        if torch.is_tensor(t) and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            waits.setdefault(t.device, torch.cuda.current_stream(t.device))
            pending.append(host)
        else:
            pending.append(t)
    for stream in waits.values():
        stream.synchronize()
    return [t.numpy() if torch.is_tensor(t) else np.asarray(t) for t in pending]
