"""The query forms that SearchEngine (engine/search.py) and
ShardedSearchEngine (parallel/sharded.py) share: `encode_query`,
`query_fused`, `query_fused_batched`, `query_fused_batched_pw`,
`query_e2e` and `run_search` (fast and split paths), written once over
each engine's device part:

  _fused_packed(qp, w, use_snips, *, pool, k)   the fused pass from
      [qvec | packed features] rows, (L,) or (B, L): (rows, final,
      breakdown (..., k, 7)) on the engine's (lead) device
  _stage_a_for(qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid, *, pool)
      the split path's stage A for a query vector on that device
  _e2e_impl(q_raw, q_len, packed, w, *, pool, k, rr_k)   query_e2e's pass
  _has_rerank_tokens()   whether doc_tokens were placed for query_e2e
  _debug_fields()        the engine's extra debug keys (n_shards)

and the attributes device, n_rows (the rows a pool can take), products,
reviews, featurizer, gate_mode, query_encoder, cross_encoder, _be.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.engine.featurize import unpack_features
from review_recommender_tpu_torch.engine.hooks import (
    SIGNAL_ORDER,
    assemble_result_rows,
    breakdown,
    resolve_search_knobs,
)
from review_recommender_tpu_torch.ops.fusion import FusionWeights, final_topk, fuse_candidates
from review_recommender_tpu_torch.utils.profiling import StageTimer

E2E_QUERY_TOKENS = 30  # query_e2e's query budget: [CLS] + 30 + [SEP] = 32 lanes


class QueryFormsMixin:
    def _debug_fields(self) -> dict:
        return {}

    # ------------------------------------------------------------- helpers
    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    @staticmethod
    def _combined(qvec, packed) -> np.ndarray:
        return np.concatenate([np.asarray(qvec, np.float32).reshape(-1), packed])

    def _unpack(self, packed: torch.Tensor):
        return unpack_features(packed, self.featurizer.query_terms_cap,
                               self.featurizer.gate_terms_cap)

    def _use_snips(self, use_snips) -> bool:
        """The JAX engine's snippet switch: use_snips with ENABLE_SNIPPETS on
        a bundle with reviews; anything else runs as use_snips=False."""
        return bool(use_snips) and config.ENABLE_SNIPPETS and self.reviews is not None

    @staticmethod
    def _device_gate(gate_penalty, st) -> torch.Tensor:
        """penalty ** (groups - hits): a float, or (B, 1) per-query penalties."""
        base = torch.as_tensor(gate_penalty, dtype=torch.float32, device=st["idx"].device)
        return torch.pow(base, (st["n_groups"] - st["gate_hits"]).to(torch.float32))

    @staticmethod
    def _row_weights(qp: torch.Tensor) -> FusionWeights:
        """The 8 per-query knobs at the tail of each (B, L + 8) row, in
        FusionWeights field order, each as (B, 1)."""
        return FusionWeights(*(qp[:, i - 8, None] for i in range(8)))

    @staticmethod
    def _result_buffer(rows, scores, bd) -> torch.Tensor:
        """(k, 9) f32 [row id, final, 7 signals]: one fetch for a query's
        results (row ids are exact in f32 below 2^24 rows)."""
        return torch.cat([rows.to(torch.float32)[..., None], scores[..., None], bd], dim=-1)

    @staticmethod
    def _stage_b_impl(st, rerank_raw, rerank_mask, best_raw, has_snippets, gate, w, *, k):
        """Fusion and the stable final top-k over stage A's pool."""
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"], rerank_raw, rerank_mask,
            best_raw, has_snippets, st["n_reviews"], st["avg_stars"],
            gate, st["cand_valid"], w,
        )
        scores, pos = final_topk(res, k)
        return res, scores, pos

    def _rows(self, buf: np.ndarray):
        """(k, 9) [row id, final, 7 signals] -> result rows in rank order."""
        sig = {name: buf[:, 2 + i] for i, name in enumerate(SIGNAL_ORDER)}
        return assemble_result_rows(self.products, buf[:, 0], buf[:, 1], sig)

    # ---------------------------------------------------------- fused query
    def _fused_packed_pw(self, qp: torch.Tensor, use_snips: bool, *, pool, k):
        """Per-query fusion weights: each (B, L + 8) row carries its own 8
        knobs at the tail [qvec | features | weights], so a batch of requests
        with different knobs is still one pass with one input copy."""
        return self._fused_packed(qp[:, :-8], self._row_weights(qp), use_snips, pool=pool, k=k)

    def query_fused(self, qvec, query: str, w: FusionWeights, pool: int, k: int,
                    use_snips: bool = False):
        """Single-pass query (no rerank): (corpus row ids (k,), final scores
        (k,)) as device tensors. The query vector and all features travel
        in one buffer, one host->device copy."""
        qp = self._upload(self._combined(qvec, self.featurizer.featurize_packed(query)))
        rows, scores, _bd = self._fused_packed(qp, w, self._use_snips(use_snips),
                                               pool=min(pool, self.n_rows), k=k)
        return rows, scores

    def query_fused_batched(self, qvecs, queries: List[str], w: FusionWeights, pool: int,
                            k: int, use_snips: bool = False):
        """Batched single-pass hybrid search (no rerank): qvecs (B, D), B
        query strings -> (row ids (B, k), scores (B, k)), device tensors."""
        packed = self.featurizer.featurize_packed_batch(list(queries))
        qp = self._upload(np.concatenate([np.asarray(qvecs, np.float32), packed], axis=1))
        rows, scores, _bd = self._fused_packed(qp, w, self._use_snips(use_snips),
                                               pool=min(pool, self.n_rows), k=k)
        return rows, scores

    def query_fused_batched_pw(self, qvecs, queries: List[str], weights, pool: int, k: int,
                               use_snips: bool = False):
        """Batched fused search with per-query fusion weights (a server's
        micro-batcher coalesces requests with different knobs): `weights`
        holds one 8-float sequence per query in FusionWeights field order.
        Returns (rows (B, k), scores (B, k), breakdown (B, k, 7) [dense,
        bm25, rerank, prior, best, trust, gate]), device tensors."""
        packed = self.featurizer.featurize_packed_batch(list(queries))
        wmat = np.asarray([tuple(map(float, w)) for w in weights], np.float32)
        qp = self._upload(np.concatenate([np.asarray(qvecs, np.float32), packed, wmat],
                                         axis=1))
        return self._fused_packed_pw(qp, self._use_snips(use_snips),
                                     pool=min(pool, self.n_rows), k=k)

    # ------------------------------------------------------------ e2e lane
    def query_e2e(self, query: str, w: FusionWeights, pool: int, k: int, rr_k: int = 0):
        """The query on the device from its token ids: bi-encoder forward,
        pool, BM25, gate, the cross-encoder over the first rr_k candidates
        (pairs built on the device), fusion, top-k. Needs attach_models();
        rr_k > 0 needs an index built with attach_rerank_tokens. Returns
        (row ids (k,), final scores (k,)), device tensors. One host->device
        copy: the query ids ride in front of the packed features."""
        if self._be is None:
            raise RuntimeError("call attach_models(biencoder[, crossencoder]) first")
        if not config.ENABLE_RERANKING:
            rr_k = 0
        if rr_k > 0 and not self._has_rerank_tokens():
            raise RuntimeError("index has no doc_tokens; build with attach_rerank_tokens()")
        ids = self._be.tokenizer.token_ids(query)[:E2E_QUERY_TOKENS]
        q_raw = np.zeros(E2E_QUERY_TOKENS, np.float32)  # ids are exact in f32
        q_raw[: len(ids)] = ids
        buf = self._upload(np.concatenate([q_raw, self.featurizer.featurize_packed(query)]))
        pool = min(pool, self.n_rows)
        with torch.inference_mode():
            rows, scores, _q = self._e2e_impl(
                buf[:E2E_QUERY_TOKENS].to(torch.int32), len(ids), buf[E2E_QUERY_TOKENS:], w,
                pool=pool, k=k, rr_k=min(int(rr_k), pool))
        return rows, scores

    # ---------------------------------------------------------------- public
    def encode_query(self, query: str) -> np.ndarray:
        if self.query_encoder is None:
            raise RuntimeError(
                f"No query encoder configured: pass query_encoder= to {type(self).__name__} "
                "or a precomputed vector as run_search(qvec=...)")
        v = np.asarray(self.query_encoder(query), dtype=np.float32).reshape(-1)
        return v / max(np.linalg.norm(v), 1e-12)

    def run_search(
        self,
        query: str,
        k: int = None,
        rerank_k: int = None,
        w_dense: float = None,
        w_bm25: float = None,
        w_rerank: float = None,
        w_prior: float = None,
        w_best: float = None,
        prior_C: float = None,
        use_snips: bool = False,
        max_scan: int = 0,
        min_reviews: int = None,
        gate_penalty: float = None,
        qvec: Optional[np.ndarray] = None,
    ):
        """Hybrid search. Returns (rows, snippets, debug): rows is the list
        of result dicts in rank order, in the JAX package's column order;
        snippets maps a result's sku to its best review {score, text,
        stars} when the snippet lane ran.

        The device gate without a live cross-encoder, snippets or max_scan
        takes the fused pass: one packed input copy, one (k, 9) result
        fetch. Otherwise stage A, the host hooks (engine/hooks.py) and
        stage B. max_scan: 0 (the default) scores every review on the
        device; max_scan > 0 takes the reference's truncated host scan
        (candidate review rows in file order, cut at max_scan), -1 the same
        at MAX_REVIEWS_SCAN rows."""
        c = config
        k, rerank_k, gate_pen_h, w = resolve_search_knobs(
            k, rerank_k, w_dense, w_bm25, w_rerank, w_prior, w_best,
            prior_C, min_reviews, gate_penalty,
        )
        max_scan = int(max_scan or 0)
        timer = StageTimer()
        if qvec is None:
            with timer.stage("encode_query"):
                qvec = self.encode_query(query)
        qvec_h = np.asarray(qvec, dtype=np.float32).reshape(-1)
        with timer.stage("featurize"):
            qf = self.featurizer.featurize(query)
        pool = min(max(k, rerank_k, c.DEFAULT_POOL_SIZE), self.n_rows)
        debug = {
            "bm25_active": bool(np.any(qf.q_idf > 0)),
            "tokens": qf.tokens,
            "groups": [sorted(g) for g in qf.groups],
            "pool": pool,
            "gate_mode": self.gate_mode,
            **self._debug_fields(),
        }

        rerank_live = rerank_k > 0 and self.cross_encoder is not None and c.ENABLE_RERANKING
        use_snips_eff = self._use_snips(use_snips)
        if (self.gate_mode == "device" and not rerank_live and not use_snips_eff
                and max_scan == 0):
            with timer.stage("fused_query"):
                qp = self._upload(self._combined(qvec_h, qf.pack()))
                out = self._result_buffer(
                    *self._fused_packed(qp, w, False, pool=pool, k=min(k, pool)))
            with timer.stage("fetch"):
                buf = out.cpu().numpy()
            rows = self._rows(buf)
            debug.update(n_results=len(rows), fused=True)
            return rows, {}, self._with_stages(debug, timer)

        to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with timer.stage("retrieve"):
            st = self._stage_a_for(
                to_dev(qvec_h), to_dev(qf.q_terms), to_dev(qf.q_idf),
                to_dev(qf.group_phrase_mask), to_dev(qf.group_term_ids),
                to_dev(qf.group_valid), pool=pool,
            )
            idx = st["idx"].cpu().numpy()
            cand_valid_h = st["cand_valid"].cpu().numpy()
        n_cand = int(cand_valid_h.sum())
        n_pool = idx.shape[0]
        rerank_raw, rerank_mask, gate, best_raw, has_snips, snips = self._split_host_hooks(
            query, qf.groups, qvec_h, idx[:n_cand], n_pool, rerank_k=rerank_k,
            gate_pen_h=gate_pen_h, use_snips_eff=use_snips_eff, max_scan=max_scan,
            gate_hits=st["gate_hits"], n_groups=st["n_groups"], timer=timer,
        )
        with timer.stage("fuse"):
            res, scores, pos = self._stage_b_impl(
                st, to_dev(rerank_raw), to_dev(rerank_mask), to_dev(best_raw), has_snips,
                gate, w, k=min(k, n_pool),
            )
            buf = self._result_buffer(st["idx"][pos], scores, breakdown(res, pos)).cpu().numpy()
        debug["n_candidates"] = n_cand
        return self._rows(buf), snips, self._with_stages(debug, timer)

    @staticmethod
    def _with_stages(debug: dict, timer: StageTimer) -> dict:
        debug["stage_ms"] = {name: v["total_ms"] for name, v in timer.summary().items()}
        return debug
