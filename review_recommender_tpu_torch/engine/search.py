"""SearchEngine: the hybrid query path on one device.

Counterpart of `review_recommender_tpu/engine/search.py` (`__init__`,
`_dense_topk`, `_stage_a_impl`, `_stage_b_impl`, `_fused_impl`,
`encode_query`, `run_search`, the fused query forms). Per query:

  host    encode the query (bi-encoder hook)               encode_query
  host    featurize: term ids + idf, gate masks             engine/featurize
  device  dense pool -> candidate gather -> BM25 -> gate    _stage_a_impl
  host    cross-encoder scores for the first rr_k rows,     engine/hooks
          exact host gate (GATE_MODE=host)
  device  fusion -> stable top-k                            _stage_b_impl

Without a live cross-encoder and with the device gate, the whole query runs
as one device pass with one packed input copy and one (k, 9) result fetch
(`_fused_packed1`), as in the JAX package's single-program path.

The same pass answers a batch (`query_fused_batched`, and
`query_fused_batched_pw` with per-query fusion weights, for a server's
micro-batcher): one (B, D) x (D, N) dense product, then each query's
pool, BM25, gate and fusion with every statistic reduced within its own
row, which is what the JAX package gets from vmap. `query_fused` and
`query_fused1` are the single-query forms. None of them routes through the
stage-A kernel (ops/stage_a.py), as the JAX engine does not.

Standalone retrieval (`search_dense`, `search_bm25`; BASELINE configs 1
and 2) scores the whole corpus. On CUDA, `search_bm25` runs the
hand-written BM25 scans of ops/bm25_kernel.py: the packed kernel whenever
the postings pack (eager or classic bundle), else the plain eager scan for
an eager bundle, else the unpacked kernel. On the CPU it takes the JAX
package's CPU branches (plain eager scan or plain classic scan). Unlike the
JAX package, the port does not read USE_PALLAS: on CUDA the kernels are
the path.

Not ported yet, and refused with NotImplementedError rather than run some
other way: the snippet lane (use_snips=True with ENABLE_SNIPPETS on a
bundle with reviews, and max_scan != 0; ROADMAP Queue 1 item 7), the IVF
pool (item 10) and the int8 corpus (item 11). As in the JAX engine,
use_snips=True with ENABLE_SNIPPETS off or on a bundle without reviews
runs as use_snips=False: no snippet lane, empty snippets.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.engine.featurize import QueryFeaturizer, unpack_features
from review_recommender_tpu_torch.engine.hooks import (
    SIGNAL_ORDER,
    SplitPathHooksMixin,
    assemble_result_rows,
    resolve_search_knobs,
)
from review_recommender_tpu_torch.index.schema import (
    IndexBundle,
    check_hbm_fit,
    enforce_hbm_fit,
)
from review_recommender_tpu_torch.ops.bm25 import (
    bm25_candidate_scores,
    bm25_candidate_scores_eager,
    bm25_full_scores_eager,
    bm25_topk,
    masked_topk,
)
from review_recommender_tpu_torch.ops.bm25_kernel import (
    MAX_QUERY_SLOTS,
    bm25_topk_packed,
    bm25_topk_unpacked,
    pack_postings,
)
from review_recommender_tpu_torch.ops.dense import (
    dense_scores,
    dense_striped_topk_scan,
    slice_corpus_for_striped,
    stable_topk,
)
from review_recommender_tpu_torch.ops.fusion import FusionWeights, final_topk, fuse_candidates
from review_recommender_tpu_torch.ops.gate import gate_factors_device
from review_recommender_tpu_torch.utils.profiling import StageTimer

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


class SearchEngine(SplitPathHooksMixin):
    def __init__(
        self,
        bundle: IndexBundle,
        *,
        device="cuda",
        emb_dtype: Optional[str] = None,
        query_encoder: Optional[Callable[[str], np.ndarray]] = None,
        cross_encoder: Optional[Callable[[str, List[str]], np.ndarray]] = None,
        gate_mode: Optional[str] = None,
        dense_pool: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and config.QUERY_TERMS_CAP > MAX_QUERY_SLOTS:
            # every query has QUERY_TERMS_CAP slots; the BM25 kernels take
            # at most MAX_QUERY_SLOTS, so refuse here rather than at each query
            raise ValueError(f"QUERY_TERMS_CAP={config.QUERY_TERMS_CAP} is over the BM25 "
                             f"kernels' {MAX_QUERY_SLOTS} query slots")
        self.bundle = bundle
        self.products = bundle.products
        raw_dtype = emb_dtype or config.EMB_DTYPE
        if raw_dtype == "int8":
            raise NotImplementedError(
                "EMB_DTYPE=int8 is not ported yet (ROADMAP Queue 1 item 11)")
        if raw_dtype not in _DTYPES:
            raise ValueError(f"unsupported emb_dtype {raw_dtype!r}")
        self.dtype = _DTYPES[raw_dtype]
        self.gate_mode = gate_mode or config.GATE_MODE
        if self.gate_mode not in ("device", "host"):
            raise ValueError(f"gate_mode must be 'device' or 'host', got {self.gate_mode!r}")
        self.dense_pool = config.resolve_pool_mode(
            dense_pool or config.DENSE_POOL_MODE, self.products.n_padded)
        if self.dense_pool == "ivf":
            raise NotImplementedError(
                "DENSE_POOL_MODE=ivf is not ported yet (ROADMAP Queue 1 item 10)")
        if self.dense_pool not in ("exact", "striped"):
            raise ValueError(f"unknown dense pool mode {self.dense_pool!r}")
        self.dense_stripes = config.DENSE_POOL_STRIPES
        self.query_encoder = query_encoder
        self.cross_encoder = cross_encoder

        # own the device-memory budget before placing anything
        self.hbm_report = enforce_hbm_fit(bundle, self.device, self.dtype,
                                          striped=self.dense_pool == "striped")
        self.arrays = self.products.device_arrays(self.device, self.dtype)
        if self.dense_pool == "striped":
            # one-time (s, G, D) slicing; the flat emb stays for the exact path
            self.arrays["emb_s"], self.arrays["valid_s"] = slice_corpus_for_striped(
                self.arrays["emb"], self.arrays["valid"], self.dense_stripes)
        self.avgdl = torch.tensor(self.products.avgdl or 1.0, dtype=torch.float32,
                                  device=self.device)
        # the same f32 value on the host, for the BM25 kernels' launch argument
        self.avgdl_h = float(np.float32(self.products.avgdl or 1.0))
        self._bm25_packed_cache = False  # False = unresolved, None = not packed
        self.featurizer = QueryFeaturizer(self.products,
                                          query_terms_cap=config.QUERY_TERMS_CAP)

    # ------------------------------------------------------------ dense pool
    def _dense_topk(self, a, qvec, pool):
        """Exact (stable top-k over the corpus) or striped pool. Striped ids
        are clamped into [0, n_padded): -inf tail lanes can carry stripe
        padding rows past the corpus."""
        n_hi = self.products.n_padded - 1
        if self.dense_pool == "striped":
            s, i = dense_striped_topk_scan(a["emb_s"], a["valid_s"], qvec, pool)
            return s, torch.clamp(i, max=n_hi)
        sims = dense_scores(a["emb"], qvec, a["valid"])
        return stable_topk(sims, min(int(pool), sims.shape[-1]))

    # --------------------------------------------------------------- stage A
    def _stage_a_impl(self, a, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid, *, pool):
        """Pool, candidate gather, BM25 and gate hit counts for qvec (D,), or
        for a batch (B, D) whose features carry the same leading axis; every
        output then has it too."""
        dense_raw, idx = self._dense_topk(a, qvec, pool)
        cand_valid = torch.isfinite(dense_raw)
        take = lambda arr: arr[idx]
        doc_terms = take(a["doc_terms"])
        if "doc_bm25" in a:
            bm25_raw = bm25_candidate_scores_eager(doc_terms, take(a["doc_bm25"]), q_terms)
        else:
            bm25_raw = bm25_candidate_scores(
                doc_terms, take(a["doc_tf"]), take(a["doc_len"]), q_terms, q_idf,
                self.avgdl)
        _factor, gate_hits = gate_factors_device(
            take(a["gate_bits"]), doc_terms, gp_mask, gt_ids, g_valid,
            1.0,  # the penalty is applied in stage B: only the hit counts are used
        )
        return {
            "idx": idx,
            "dense_raw": dense_raw,
            "cand_valid": cand_valid,
            "bm25_raw": bm25_raw,
            "gate_hits": gate_hits,
            "n_groups": g_valid.to(torch.int32).sum(dim=-1, keepdim=True),
            "n_reviews": take(a["n_reviews"]),
            "avg_stars": take(a["avg_stars"]),
        }

    # --------------------------------------------------------------- stage B
    def _stage_b_impl(self, st, rerank_raw, rerank_mask, best_raw, has_snippets,
                      gate, w, *, k):
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"], rerank_raw, rerank_mask,
            best_raw, has_snippets, st["n_reviews"], st["avg_stars"],
            gate, st["cand_valid"], w,
        )
        scores, pos = final_topk(res, k)
        return res, scores, pos

    # ------------------------------------------------------------ fused path
    @staticmethod
    def _breakdown(res, pos) -> torch.Tensor:
        """(..., k, 7) signal columns at the winners, SIGNAL_ORDER."""
        return torch.stack([getattr(res, name).gather(-1, pos) for name in SIGNAL_ORDER],
                           dim=-1)

    def _fused_impl(self, a, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                    w: FusionWeights, *, pool, k):
        """One pass without the cross-encoder, device gate, for one query or
        a batch (a leading axis on every query input; `w` shared floats or
        (B, 1) tensors). Returns (rows (..., k), final (..., k), breakdown
        (..., k, 7))."""
        st = self._stage_a_impl(a, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                                pool=pool)
        shape = st["idx"].shape
        zeros = torch.zeros(shape, dtype=torch.float32, device=self.device)
        base = torch.as_tensor(w.gate_penalty, dtype=torch.float32, device=self.device)
        gate = torch.pow(base, (st["n_groups"] - st["gate_hits"]).to(torch.float32))
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"], zeros,
            torch.zeros(shape, dtype=torch.bool, device=self.device),
            zeros, False, st["n_reviews"], st["avg_stars"],
            gate, st["cand_valid"], w,
        )
        scores, pos = final_topk(res, k)
        return st["idx"].gather(-1, pos), scores, self._breakdown(res, pos)

    def _fused_packed(self, qp: torch.Tensor, w: FusionWeights, *, pool, k):
        """The fused query from combined rows [qvec | packed features]: (L,)
        for one query, (B, L) for a batch with shared weights (the JAX
        engine's _fused_packed_impl and its vmap, _fused_packed_batch_impl).
        One input copy per call."""
        d = self.products.dim
        feats = unpack_features(qp[..., d:], self.featurizer.query_terms_cap,
                                self.featurizer.gate_terms_cap)
        return self._fused_impl(self.arrays, qp[..., :d], *feats, w, pool=pool, k=k)

    def _fused_packed_pw(self, qp: torch.Tensor, *, pool, k):
        """Per-query fusion weights: each (B, L + 8) row carries its own 8
        knobs at the tail [qvec | features | weights], in FusionWeights
        field order, so a batch of requests with different knobs is still
        one pass with one input copy."""
        w = FusionWeights(*(qp[:, i - 8, None] for i in range(8)))  # each (B, 1)
        return self._fused_packed(qp[:, :-8], w, pool=pool, k=k)

    @staticmethod
    def _result_buffer(rows, scores, bd) -> torch.Tensor:
        """(k, 9) f32 [row id, final, 7 signals]: one fetch for a query's
        results (row ids are exact in f32 below 2^24 rows)."""
        return torch.cat([rows.to(torch.float32)[..., None], scores[..., None], bd], dim=-1)

    def _fused_packed1(self, qp: torch.Tensor, w: FusionWeights, *, pool, k):
        """The fused query from ONE input buffer [qvec | packed features] to
        ONE (k, 9) f32 output (_result_buffer)."""
        return self._result_buffer(*self._fused_packed(qp, w, pool=pool, k=k))

    # ------------------------------------------------------------ fused query
    def _refuse_snippets(self, use_snips) -> None:
        """Raise where the JAX engine would run its snippet lane (its
        use_snips_eff): use_snips with ENABLE_SNIPPETS on a bundle with
        reviews. Anything else runs as use_snips=False."""
        if bool(use_snips) and config.ENABLE_SNIPPETS and self.bundle.reviews is not None:
            raise NotImplementedError(
                "use_snips=True: the snippet lane is not ported yet (ROADMAP Queue 1 item 7)")

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def _combined(self, qvec, packed) -> np.ndarray:
        qv = np.asarray(qvec, np.float32).reshape(-1)
        return np.concatenate([qv, packed])

    def query_fused(self, qvec, query: str, w: FusionWeights, pool: int, k: int,
                    use_snips: bool = False):
        """Single-pass query (no rerank): (corpus row ids (k,), final scores
        (k,)) as device tensors. The query vector and all features travel
        in one buffer, one host->device copy."""
        self._refuse_snippets(use_snips)
        qp = self._upload(self._combined(qvec, self.featurizer.featurize_packed(query)))
        rows, scores, _bd = self._fused_packed(
            qp, w, pool=min(pool, self.products.n_padded), k=k)
        return rows, scores

    def query_fused1(self, qvec, query: str, w: FusionWeights, pool: int, k: int,
                     use_snips: bool = False) -> torch.Tensor:
        """query_fused returning ONE (k, 9) f32 device tensor [row id, final,
        7 signals]; split it on the host with split_fused1. One copy in, one
        read out."""
        self._refuse_snippets(use_snips)
        qp = self._upload(self._combined(qvec, self.featurizer.featurize_packed(query)))
        return self._fused_packed1(qp, w, pool=min(pool, self.products.n_padded), k=k)

    @staticmethod
    def split_fused1(out):
        """(k, 9) result, a tensor or a host array -> (row ids (k,) int64,
        final scores (k,)) on the host."""
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        return out[:, 0].astype(np.int64), out[:, 1]

    def query_fused_batched(self, qvecs, queries: List[str], w: FusionWeights,
                            pool: int, k: int, use_snips: bool = False):
        """Batched single-pass hybrid search (no rerank): qvecs (B, D), B
        query strings -> (row ids (B, k), scores (B, k)), device tensors."""
        self._refuse_snippets(use_snips)
        packed = self.featurizer.featurize_packed_batch(queries)
        qp = self._upload(np.concatenate([np.asarray(qvecs, np.float32), packed], axis=1))
        rows, scores, _bd = self._fused_packed(
            qp, w, pool=min(pool, self.products.n_padded), k=k)
        return rows, scores

    def query_fused_batched_pw(self, qvecs, queries: List[str], weights, pool: int,
                               k: int, use_snips: bool = False):
        """Batched fused search with per-query fusion weights (a server's
        micro-batcher coalesces requests with different knobs): `weights`
        holds one 8-float sequence per query in FusionWeights field order.
        Returns (rows (B, k), scores (B, k), breakdown (B, k, 7) [dense,
        bm25, rerank, prior, best, trust, gate]), device tensors."""
        self._refuse_snippets(use_snips)
        packed = self.featurizer.featurize_packed_batch(queries)
        wmat = np.asarray([tuple(map(float, w)) for w in weights], np.float32)
        qp = self._upload(np.concatenate([np.asarray(qvecs, np.float32), packed, wmat],
                                         axis=1))
        return self._fused_packed_pw(qp, pool=min(pool, self.products.n_padded), k=k)

    # ------------------------------------------------- standalone retrieval
    def search_dense(self, qvec, k: int):
        """Pure dense retrieval (BASELINE config 1): (row ids, scores)."""
        q = torch.from_numpy(np.asarray(qvec, dtype=np.float32).reshape(-1)).to(self.device)
        scores, idx = self._dense_topk(self.arrays, q, min(int(k), self.products.n_padded))
        return idx, scores

    def search_bm25(self, query: str, k: int):
        """Sparse retrieval over the full corpus (BASELINE config 2): (row
        ids, scores), the JAX engine's branch order (see module docstring)."""
        qf = self.featurizer.featurize(query)
        a = self.arrays
        kk = min(int(k), self.products.n_padded)
        q_terms = torch.from_numpy(qf.q_terms).to(self.device)
        q_idf = torch.from_numpy(qf.q_idf).to(self.device)
        packed = self._bm25_packed() if self._kernels_ok() else None
        if packed is not None:
            pk_t, dl_p, valid_p = packed
            scores, idx = bm25_topk_packed(pk_t, dl_p, valid_p, q_terms, q_idf,
                                           self.avgdl_h, k=kk)
            # -inf tail slots may index the 512-alignment pad rows; clamp
            # into the bundle's row space, as the striped pool does
            idx = torch.clamp(idx, max=self.products.n_padded - 1)
        elif "doc_bm25" in a:
            scores, idx = masked_topk(
                bm25_full_scores_eager(a["doc_terms"], a["doc_bm25"], q_terms), a["valid"], kk)
        elif self._kernels_ok():
            scores, idx = bm25_topk_unpacked(a["doc_terms"], a["doc_tf"], a["doc_len"],
                                             a["valid"], q_terms, q_idf, self.avgdl_h, k=kk)
        else:
            scores, idx = bm25_topk(a["doc_terms"], a["doc_tf"], a["doc_len"], a["valid"],
                                    q_terms, q_idf, self.avgdl, k=kk)
        return idx, scores

    def _kernels_ok(self) -> bool:
        """The BM25 kernels run on CUDA tensors, at any corpus size."""
        return self.device.type == "cuda"

    def _bm25_packed(self):
        """Lazy packed postings for search_bm25: (packed (L, N_pad) int32,
        doc_len (N_pad,) f32, valid (N_pad,) bool) on the engine's device,
        packed on the host from doc_tf/doc_len (which every bundle keeps
        there). None, logged, when the postings cannot pack losslessly or
        the extra array would not fit the device; search_bm25 then takes
        the unpacked branches. A failure to pack or place raises."""
        if self._bm25_packed_cache is False:
            self._bm25_packed_cache = None
            p = self.products
            pk = pack_postings(p.doc_terms, p.doc_tf)
            if pk is None:
                logger.warning("packed BM25 postings unavailable: a tf is not an integer "
                               "in 0..255 or a term id is >= 2^24; search_bm25 scans "
                               "the unpacked postings")
                return None
            fit = check_hbm_fit(self.hbm_report["total_bytes"] + pk.nbytes, self.device)
            if not fit["fits"]:
                logger.warning("skipping packed BM25 postings: +%d MiB would exceed the "
                               "device memory", pk.nbytes >> 20)
                return None
            pad = pk.shape[1] - p.n_padded
            self._bm25_packed_cache = (
                torch.from_numpy(pk).to(self.device),
                torch.from_numpy(np.pad(p.doc_len, (0, pad)).astype(np.float32)).to(self.device),
                torch.from_numpy(np.pad(p.valid, (0, pad)).astype(bool)).to(self.device),
            )
        return self._bm25_packed_cache

    # ---------------------------------------------------------------- public
    def encode_query(self, query: str) -> np.ndarray:
        if self.query_encoder is None:
            raise RuntimeError(
                "No query encoder configured: pass query_encoder= to SearchEngine "
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
        of result dicts in rank order, in the JAX package's column order."""
        self._refuse_snippets(use_snips)
        if int(max_scan or 0) != 0:
            raise NotImplementedError(
                "max_scan != 0: the exact host snippet scan is not ported yet "
                "(ROADMAP Queue 1 item 7)")
        c = config
        k, rerank_k, gate_pen_h, w = resolve_search_knobs(
            k, rerank_k, w_dense, w_bm25, w_rerank, w_prior, w_best,
            prior_C, min_reviews, gate_penalty,
        )
        timer = StageTimer()
        if qvec is None:
            with timer.stage("encode_query"):
                qvec = self.encode_query(query)
        qvec_h = np.asarray(qvec, dtype=np.float32).reshape(-1)

        with timer.stage("featurize"):
            qf = self.featurizer.featurize(query)
        pool = min(max(k, rerank_k, c.DEFAULT_POOL_SIZE), self.products.n_padded)

        rerank_live = (rerank_k > 0 and self.cross_encoder is not None
                       and c.ENABLE_RERANKING)
        if self.gate_mode == "device" and not rerank_live:
            with timer.stage("fused_query"):
                qp = self._upload(self._combined(qvec_h, qf.pack()))
                out = self._fused_packed1(qp, w, pool=pool, k=min(k, pool))
            with timer.stage("fetch"):
                buf = out.cpu().numpy()
            return self._rows_from_fused1(buf, qf, pool, timer)

        to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with timer.stage("retrieve"):
            st = self._stage_a_impl(
                self.arrays, to_dev(qvec_h), to_dev(qf.q_terms), to_dev(qf.q_idf),
                to_dev(qf.group_phrase_mask), to_dev(qf.group_term_ids),
                to_dev(qf.group_valid), pool=pool,
            )
            idx = st["idx"].cpu().numpy()
            cand_valid_h = st["cand_valid"].cpu().numpy()
        n_cand = int(cand_valid_h.sum())
        cand_rows = idx[:n_cand]
        P = idx.shape[0]

        rerank_raw, rerank_mask, gate = self._split_host_hooks(
            query, qf.groups, cand_rows, P, rerank_k=rerank_k, gate_pen_h=gate_pen_h,
            gate_hits=st["gate_hits"], n_groups=st["n_groups"], timer=timer,
        )

        with timer.stage("fuse"):
            zeros = torch.zeros(P, dtype=torch.float32, device=self.device)
            res, scores, pos = self._stage_b_impl(
                st, to_dev(rerank_raw), to_dev(rerank_mask), zeros, False, gate, w,
                k=min(k, P),
            )
            buf = self._result_buffer(st["idx"][pos], scores,
                                      self._breakdown(res, pos)).cpu().numpy()
        sig = {name: buf[:, 2 + i] for i, name in enumerate(SIGNAL_ORDER)}
        rows = assemble_result_rows(self.products, buf[:, 0], buf[:, 1], sig)
        debug = {
            "bm25_active": bool(np.any(qf.q_idf > 0)),
            "tokens": qf.tokens,
            "groups": [sorted(g) for g in qf.groups],
            "pool": pool,
            "gate_mode": self.gate_mode,
            "n_candidates": n_cand,
            "stage_ms": {name: v["total_ms"] for name, v in timer.summary().items()},
        }
        return rows, {}, debug

    def _rows_from_fused1(self, buf: np.ndarray, qf, pool: int, timer):
        """(k, 9) fused output -> (rows, snippets, debug)."""
        sig = {name: buf[:, 2 + i] for i, name in enumerate(SIGNAL_ORDER)}
        rows = assemble_result_rows(self.products, buf[:, 0], buf[:, 1], sig)
        debug = {
            "bm25_active": bool(np.any(qf.q_idf > 0)),
            "tokens": qf.tokens,
            "groups": [sorted(g) for g in qf.groups],
            "pool": pool,
            "gate_mode": self.gate_mode,
            "n_results": len(rows),
            "fused": True,
            "stage_ms": {name: v["total_ms"] for name, v in timer.summary().items()},
        }
        return rows, {}, debug
