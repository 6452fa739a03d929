"""Coalesced live-rerank serving path.

Counterpart of `review_recommender_tpu/engine/rerank_coalesce.py:42-147`.
Concurrent /search riders with rerank_k > 0 share three steps (a server's
micro-batcher routes them in):

  device  one batched stage A for every rider: pool, BM25, gate, snippet
          lane (SearchEngine._rerank_stage_a)
  host    ONE cross-encoder pass over every rider's (query, doc) pairs
          (CrossEncoder.score_pairs: length-sorted chunks of 64 packed into
          sequence buckets), or one call per rider of a generic
          (query, texts) hook
  device  one batched stage B: fusion with per-rider (B, 1) weights, top-k

Each rider's result equals run_search with the same knobs in device-gate
mode. Riders with rerank_k = 0 contribute no pairs. The reference's
degraded behaviour is kept: with no cross-encoder, or ENABLE_RERANKING off,
zero scores still occupy the first rr_k rerank lanes.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.engine.hooks import breakdown
from review_recommender_tpu_torch.ops.fusion import FusionWeights, final_topk, fuse_candidates


def _rerank_b_batched(st, rerank_raw, rerank_mask, best_raw, has_snips, gate,
                      wmat: torch.Tensor, *, k: int):
    """Batched stage B with per-rider weights wmat (B, 8) and the host-filled
    rerank columns (B, P). Returns (rows (B, k), scores (B, k), breakdown
    (B, k, 7)), as query_fused_batched_pw does."""
    w = FusionWeights(*(wmat[:, i, None] for i in range(8)))
    res = fuse_candidates(
        st["dense_raw"], st["bm25_raw"], rerank_raw, rerank_mask, best_raw, has_snips,
        st["n_reviews"], st["avg_stars"], gate, st["cand_valid"], w,
    )
    scores, pos = final_topk(res, k)
    return st["idx"].gather(-1, pos), scores, breakdown(res, pos)


class RerankCoalesceMixin:
    """`query_rerank_batched_pw` for an engine with `_rerank_stage_a`, a
    featurizer, `n_rows` (the rows a pool can take), `products`,
    `cross_encoder`, `device` and `_upload`."""

    def query_rerank_batched_pw(self, qvecs, queries: List[str], weights: List,
                                rerank_ks: List[int], pool: int, k: int,
                                use_snips: bool = False):
        """Coalesced batched search with the live cross-encoder rerank:
        `weights` holds one 8-float sequence per rider in FusionWeights
        field order, `rerank_ks` one rerank_k per rider. Returns (rows
        (B, k), scores (B, k), breakdown (B, k, 7)), device tensors."""
        c = config
        use_snips = bool(use_snips) and c.ENABLE_SNIPPETS
        pool = min(int(pool), self.n_rows)
        packed = self.featurizer.featurize_packed_batch(list(queries))
        wmat = np.asarray([tuple(map(float, w)) for w in weights], np.float32)
        qp = self._upload(np.concatenate([np.asarray(qvecs, np.float32), packed, wmat], axis=1))
        st, best_raw, has_snips, gate = self._rerank_stage_a(qp, use_snips, pool)
        idx_h = st["idx"].cpu().numpy()
        valid_h = st["cand_valid"].cpu().numpy()
        B, P = idx_h.shape

        rr_raw = np.zeros((B, P), np.float32)
        rr_mask = np.zeros((B, P), bool)
        ce = self.cross_encoder
        n_docs = len(self.products.agg_texts)
        pair_q: List[str] = []
        pair_d: List[str] = []
        slots: List[tuple] = []
        for i in range(B):
            rk = int(rerank_ks[i])
            if rk <= 0:
                continue
            rr_k = min(rk, int(valid_h[i].sum()))
            rr_mask[i, :rr_k] = True  # set with no model too (the reference's lanes)
            if ce is None or not c.ENABLE_RERANKING:
                continue
            for j in range(rr_k):
                row = int(idx_h[i, j])
                if row >= n_docs:  # padding rows past the corpus
                    continue
                pair_q.append(queries[i])
                pair_d.append(self.products.agg_texts[row][:2000])
                slots.append((i, j))
        if slots:
            if hasattr(ce, "score_pairs"):
                scores = np.asarray(ce.score_pairs(pair_q, pair_d), np.float32)
            else:
                # a generic (query, texts) hook: one call per rider's run of pairs
                scores = np.empty(len(slots), np.float32)
                lo = 0
                while lo < len(slots):
                    hi = lo
                    while hi < len(slots) and slots[hi][0] == slots[lo][0]:
                        hi += 1
                    scores[lo:hi] = np.asarray(ce(pair_q[lo], pair_d[lo:hi]), np.float32)
                    lo = hi
            for (i, j), s in zip(slots, scores):
                rr_raw[i, j] = s

        to_dev = lambda x: torch.from_numpy(x).to(self.device)
        return _rerank_b_batched(st, to_dev(rr_raw), to_dev(rr_mask), best_raw, has_snips,
                                 gate, qp[:, -8:], k=min(int(k), P))
