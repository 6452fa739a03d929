"""SearchEngine: the hybrid query path on one device.

Counterpart of `review_recommender_tpu/engine/search.py` (`__init__`,
`_dense_topk`, `_stage_a_impl`, `_stage_b_impl`, `_fused_impl`,
`encode_query`, `run_search`). Per query:

  host    encode the query (bi-encoder hook)               encode_query
  host    featurize: term ids + idf, gate masks             engine/featurize
  device  dense pool -> candidate gather -> BM25 -> gate    _stage_a_impl
  host    cross-encoder scores for the first rr_k rows,     engine/hooks
          exact host gate (GATE_MODE=host)
  device  fusion -> stable top-k                            _stage_b_impl

Without a live cross-encoder and with the device gate, the whole query runs
as one device pass with one packed input copy and one (k, 9) result fetch
(`_fused_packed1`), as in the JAX package's single-program path.

Standalone retrieval (`search_dense`, `search_bm25`; BASELINE configs 1
and 2) scores the whole corpus. On CUDA, `search_bm25` runs the
hand-written BM25 scans of ops/bm25_kernel.py: the packed kernel whenever
the postings pack (eager or classic bundle), else the plain eager scan for
an eager bundle, else the unpacked kernel. On the CPU it takes the JAX
package's CPU branches (plain eager scan or plain classic scan). Unlike the
JAX package, the port does not read USE_PALLAS: on CUDA the kernels are
the path.

Not ported yet, and refused with NotImplementedError rather than run some
other way: snippets (use_snips=True, max_scan != 0; ROADMAP Queue 1 item 7),
the IVF pool (item 10) and the int8 corpus (item 11).
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from review_recommender_tpu.config import config
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
        device,
        emb_dtype: Optional[str] = None,
        query_encoder: Optional[Callable[[str], np.ndarray]] = None,
        cross_encoder: Optional[Callable[[str, List[str]], np.ndarray]] = None,
        gate_mode: Optional[str] = None,
        dense_pool: Optional[str] = None,
    ):
        self.device = resolve_device(device)
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
        dense_raw, idx = self._dense_topk(a, qvec, pool)
        cand_valid = torch.isfinite(dense_raw)
        take = lambda arr: arr.index_select(0, idx)
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
            "n_groups": g_valid.to(torch.int32).sum(),
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
        """(k, 7) signal columns at the winners, SIGNAL_ORDER."""
        return torch.stack([getattr(res, name)[pos] for name in SIGNAL_ORDER], dim=-1)

    def _fused_impl(self, a, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                    w: FusionWeights, *, pool, k):
        """One pass without the cross-encoder, device gate."""
        st = self._stage_a_impl(a, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                                pool=pool)
        P = st["idx"].shape[0]
        zeros = torch.zeros(P, dtype=torch.float32, device=self.device)
        base = torch.tensor(w.gate_penalty, dtype=torch.float32, device=self.device)
        gate = torch.pow(base, (st["n_groups"] - st["gate_hits"]).to(torch.float32))
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"], zeros,
            torch.zeros(P, dtype=torch.bool, device=self.device),
            zeros, False, st["n_reviews"], st["avg_stars"],
            gate, st["cand_valid"], w,
        )
        scores, pos = final_topk(res, k)
        return st["idx"][pos], scores, self._breakdown(res, pos)

    def _fused_packed1(self, qp: torch.Tensor, w: FusionWeights, *, pool, k):
        """The fused query from ONE input buffer [qvec | packed features] to
        ONE (k, 9) f32 output [row id, final, 7 signals] (row ids are exact
        in f32 below 2^24 rows)."""
        d = self.products.dim
        feats = unpack_features(qp[d:], self.featurizer.query_terms_cap,
                                self.featurizer.gate_terms_cap)
        rows, scores, bd = self._fused_impl(self.arrays, qp[:d], *feats, w,
                                            pool=pool, k=k)
        return torch.cat([rows.to(torch.float32)[:, None], scores[:, None], bd], dim=1)

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
        if use_snips:
            raise NotImplementedError(
                "use_snips=True: the snippet lane is not ported yet (ROADMAP Queue 1 item 7)")
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
                qp = torch.from_numpy(np.concatenate([qvec_h, qf.pack()])).to(self.device)
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
            buf = torch.cat([st["idx"][pos].to(torch.float32)[:, None], scores[:, None],
                             self._breakdown(res, pos)], dim=1).cpu().numpy()
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
