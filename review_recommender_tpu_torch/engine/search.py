"""SearchEngine: the hybrid query path on one device.

Counterpart of `review_recommender_tpu/engine/search.py` (`__init__`,
`_dense_topk`, `_stage_a_impl`, `_stage_b_impl`, `_fused_impl`,
`encode_query`, `run_search`, the fused query forms, the on-device rerank
lane `query_e2e` and the coalesced rerank stage A). `run_search`,
`encode_query`, `query_e2e` and the fused query forms but `query_fused1`
are written once for this engine and the sharded one
(engine/query_forms.py), over this engine's `_stage_a_for`,
`_fused_packed` and `_e2e_impl`. Per query of `run_search`:

  host    encode the query (bi-encoder hook)               encode_query
  host    featurize: term ids + idf, gate masks             engine/featurize
  device  dense pool -> candidate gather -> BM25 -> gate    _stage_a_impl
  host    cross-encoder scores for the first rr_k rows,     engine/hooks
          exact host gate (GATE_MODE=host), snippets
  device  fusion -> stable top-k                            _stage_b_impl

Without a live cross-encoder, snippets or max_scan and with the device
gate, the whole query runs as one device pass with one packed input copy
and one (k, 9) result fetch (`_result_buffer`), as in the JAX package's
single-program path.

The same pass answers a batch (`query_fused_batched`, and
`query_fused_batched_pw` with per-query fusion weights, for a server's
micro-batcher): one (B, D) x (D, N) dense product, then each query's
pool, BM25, gate and fusion with every statistic reduced within its own
row, which is what the JAX package gets from vmap. `query_fused` and
`query_fused1` are the single-query forms. None of them routes through the
stage-A kernel (ops/stage_a.py), as the JAX engine does not.

The rerank lane has two more forms. `query_e2e` (after `attach_models`)
runs the whole query on the device from the query's token ids: the
bi-encoder forward at (1, 32), the pool, and the cross-encoder over
[CLS] q [SEP] d [SEP] pairs built on the device (`build_pairs_device`)
from the document tokens stored at index time
(index/build.py:attach_rerank_tokens), then fusion; both towers run the
attention kernel on CUDA. `query_rerank_batched_pw`
(engine/rerank_coalesce.py) serves concurrent rerank requests with one
batched stage A (`_rerank_a_impl`), one host cross-encoder pass over every
rider's pairs and one batched stage B.

The snippet lane (use_snips=True with ENABLE_SNIPPETS on a bundle with
reviews) scores every review against the query on the device and keeps
each product's best (ops/segment.py:best_review_scores), in run_search's
split path and in every fused form; run_search(max_scan > 0 or -1) takes
the reference's truncated host scan instead (engine/snippets.py). With
use_snips off no review is touched. On the CPU, in the tests, every form
runs the plain torch versions; on CUDA the towers launch the attention
kernel.

Standalone retrieval (`search_dense`, `search_bm25`; BASELINE configs 1
and 2) scores the whole corpus. On CUDA, `search_bm25` runs the
hand-written BM25 scans of ops/bm25_kernel.py: the packed kernel whenever
the postings pack (eager or classic bundle), else the plain eager scan for
an eager bundle, else the unpacked kernel. On the CPU it takes the JAX
package's CPU branches (plain eager scan or plain classic scan). Unlike the
JAX package, the port does not read USE_PALLAS: on CUDA the kernels are
the path.

The host featurizer is the port's C++ one (engine/featurize.py) unless the
caller passes featurizer="python", the plain version.

The dense pool is exact, striped, or IVF (ops/ivf.py: k-means blocks
built once at init on the engine's device, probed by centroid score; a
pool-recall self-check against the exact pool warns below
IVF_SELFCHECK_MIN), over a bf16/f16/f32 corpus or, with EMB_DTYPE=int8, a
per-row int8 one (ops/dense.py: emb_q + emb_scale in place of emb,
exact or striped; the rest of the engine's tensors stay bf16). IVF needs a
float corpus and refuses int8 with ValueError, as the JAX engine does.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.engine.featurize import QueryFeaturizer
from review_recommender_tpu_torch.engine.hooks import SNIPPET_NONE, SplitPathHooksMixin, breakdown
from review_recommender_tpu_torch.engine.query_forms import QueryFormsMixin
from review_recommender_tpu_torch.engine.rerank_coalesce import RerankCoalesceMixin
from review_recommender_tpu_torch.engine.snippets import HostSnippetsMixin
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
    dense_scores_int8,
    dense_striped_topk_scan,
    dense_striped_topk_scan_int8,
    slice_corpus_for_striped,
    slice_corpus_for_striped_int8,
    stable_topk,
)
from review_recommender_tpu_torch.ops.fusion import FusionWeights, final_topk, fuse_candidates
from review_recommender_tpu_torch.ops.gate import gate_factors_device
from review_recommender_tpu_torch.ops.segment import best_review_scores

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _query_head(cls_id: int, sep_id: int, q_raw: torch.Tensor, q_len: int,
                width: int) -> torch.Tensor:
    """(width,) int32 [CLS] q [SEP] followed by zeros: q_raw's padding past
    q_len is zeroed BEFORE the sep is placed (the order matters)."""
    lq = q_raw.shape[0]
    pos = torch.arange(width, device=q_raw.device)
    head = torch.zeros(width, dtype=torch.int32, device=q_raw.device)
    head[0] = cls_id
    head[1 : 1 + lq] = q_raw
    head = torch.where((pos > q_len) & (pos < 1 + lq), 0, head)
    return torch.where(pos == 1 + q_len, sep_id, head)


def build_pairs_device(cls_id: int, sep_id: int, q_raw: torch.Tensor, q_len: int,
                       d_tok: torch.Tensor, d_len: torch.Tensor):
    """[CLS] q [SEP] d [SEP] for each of R documents in the exact HF layout,
    without gaps: q_raw (Lq,) int32 query ids (padding past q_len, an int in
    0..Lq), d_tok (R, Sd) document ids, d_len (R,) their lengths in 0..Sd.
    Returns (ids, attention mask, token types), each (R, Lq + Sd + 3)
    int32; token types are 1 on [q_len + 2, total). Batched over the rows
    with arange comparisons and one gather."""
    r, sd = d_tok.shape
    width = q_raw.shape[0] + sd + 3
    dev = d_tok.device
    pos = torch.arange(width, device=dev)
    head = _query_head(cls_id, sep_id, q_raw, q_len, width)
    # each document zeroed at and past d_len, THEN its sep placed
    col = torch.arange(sd + 1, device=dev)
    dl = d_len.to(torch.int64)[:, None]
    dd = torch.cat([d_tok.to(torch.int32), torch.zeros(r, 1, dtype=torch.int32, device=dev)], 1)
    dd = torch.where(col >= dl, 0, dd)
    dd = torch.where(col == dl, sep_id, dd)
    off = q_len + 2
    j = pos - off
    doc = torch.gather(dd, 1, j.clamp(0, sd).expand(r, width))
    ids = torch.where((j >= 0) & (j <= sd), doc, head)
    total = off + dl + 1  # (R, 1)
    mask = (pos < total).to(torch.int32)
    types = ((pos >= off) & (pos < total)).to(torch.int32)
    return ids, mask, types


def encode_query_ids_device(cls_id: int, sep_id: int, q_raw: torch.Tensor, q_len: int):
    """[CLS] q [SEP] input of the bi-encoder's query forward: (ids, mask),
    each (Lq + 2,) int32."""
    width = q_raw.shape[0] + 2
    ids = _query_head(cls_id, sep_id, q_raw, q_len, width)
    mask = (torch.arange(width, device=q_raw.device) < q_len + 2).to(torch.int32)
    return ids, mask


def _same_device(a: torch.device, b: torch.device) -> bool:
    index = lambda d: (d.index if d.index is not None
                       else torch.cuda.current_device() if d.type == "cuda" else None)
    return a.type == b.type and index(a) == index(b)


class SearchEngine(QueryFormsMixin, HostSnippetsMixin, RerankCoalesceMixin,
                   SplitPathHooksMixin):
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
        featurizer: str = "native",
    ):
        self.device = resolve_device(device)
        if featurizer not in ("native", "python"):
            raise ValueError(f"featurizer must be 'native' or 'python', got {featurizer!r}")
        if self.device.type == "cuda" and config.QUERY_TERMS_CAP > MAX_QUERY_SLOTS:
            # every query has QUERY_TERMS_CAP slots; the BM25 kernels take
            # at most MAX_QUERY_SLOTS, so refuse here rather than at each query
            raise ValueError(f"QUERY_TERMS_CAP={config.QUERY_TERMS_CAP} is over the BM25 "
                             f"kernels' {MAX_QUERY_SLOTS} query slots")
        self.bundle = bundle
        self.products = bundle.products
        self.reviews = bundle.reviews
        self.n_docs = self.products.n_docs
        self.n_rows = self.products.n_padded  # the rows a pool can take
        raw_dtype = emb_dtype or config.EMB_DTYPE
        self.int8_mode = raw_dtype == "int8"
        if not self.int8_mode and raw_dtype not in _DTYPES:
            raise ValueError(f"unsupported emb_dtype {raw_dtype!r}")
        # an int8 engine keeps everything but the corpus rows in bf16
        self.dtype = torch.bfloat16 if self.int8_mode else _DTYPES[raw_dtype]
        self.gate_mode = gate_mode or config.GATE_MODE
        if self.gate_mode not in ("device", "host"):
            raise ValueError(f"gate_mode must be 'device' or 'host', got {self.gate_mode!r}")
        self.dense_pool = config.resolve_pool_mode(
            dense_pool or config.DENSE_POOL_MODE, self.products.n_padded)
        if self.dense_pool not in ("exact", "striped", "ivf"):
            raise ValueError(f"unknown dense pool mode {self.dense_pool!r}")
        if self.dense_pool == "ivf" and self.int8_mode:
            raise ValueError(
                "DENSE_POOL_MODE=ivf needs a bf16/f32 corpus (the block "
                "tensor is packed from `emb`); use EMB_DTYPE=bfloat16 or "
                "the striped pool for int8 corpora")
        self.dense_stripes = config.DENSE_POOL_STRIPES
        self.query_encoder = query_encoder
        self.cross_encoder = cross_encoder

        # own the device-memory budget before placing anything
        ivf = self.dense_pool == "ivf"
        self.hbm_report = enforce_hbm_fit(
            bundle, self.device, self.dtype, quantize_int8=self.int8_mode,
            striped=self.dense_pool == "striped", ivf=ivf,
            ivf_centroids=config.IVF_CENTROIDS, ivf_block_rows=config.IVF_BLOCK_ROWS)
        self.arrays = self.products.device_arrays(self.device, self.dtype,
                                                  quantize_int8=self.int8_mode)
        a = self.arrays
        if self.dense_pool == "striped" and self.int8_mode:
            a["emb_qs"], a["emb_scale_s"], a["valid_s"] = slice_corpus_for_striped_int8(
                a["emb_q"], a["emb_scale"], a["valid"], self.dense_stripes)
        elif self.dense_pool == "striped":
            # one-time (s, G, D) slicing; the flat emb stays for the exact path
            a["emb_s"], a["valid_s"] = slice_corpus_for_striped(
                a["emb"], a["valid"], self.dense_stripes)
        elif ivf:
            self._build_ivf()
        self.avgdl = torch.tensor(self.products.avgdl or 1.0, dtype=torch.float32,
                                  device=self.device)
        # the same f32 value on the host, for the BM25 kernels' launch argument
        self.avgdl_h = float(np.float32(self.products.avgdl or 1.0))
        self._bm25_packed_cache = False  # False = unresolved, None = not packed
        self.rev_arrays = (self.reviews.device_arrays(self.device, self.dtype)
                           if self.reviews is not None else None)
        self._build_rev_csr()  # host CSR over reviews, for the snippet texts
        self.featurizer = QueryFeaturizer(self.products, query_terms_cap=config.QUERY_TERMS_CAP,
                                          native=featurizer == "native")
        self._be = None  # towers of query_e2e (attach_models)
        self._ce = None

    def _build_ivf(self) -> None:
        """One-time k-means and block packing on the engine's device
        (ops/ivf.py), its tensors added to self.arrays, and the pool-recall
        self-check against the exact pool (a warning below
        IVF_SELFCHECK_MIN)."""
        from review_recommender_tpu_torch.ops.ivf import (
            IVF_KEYS,
            build_ivf,
            ivf_device_arrays,
            ivf_device_bytes,
            measure_pool_recall,
        )

        a = self.arrays
        self.ivf = build_ivf(self.products.emb, self.products.valid,
                             n_centroids=config.IVF_CENTROIDS,
                             block_rows=config.IVF_BLOCK_ROWS, device=self.device)
        self.ivf_nprobe = config.IVF_NPROBE
        a.update(ivf_device_arrays(self.ivf, a["emb"]))
        # the block tensor's real size, beside the bound enforce_hbm_fit used
        self.ivf.stats["device_bytes"] = ivf_device_bytes(a)
        logger.info("IVF on %s: %d bytes (%d blocks x %d rows, fill %.2f)", self.device,
                    self.ivf.stats["device_bytes"], self.ivf.n_blocks, self.ivf.block_rows,
                    self.ivf.stats["fill"])
        self.ivf_pool_recall = None
        if config.IVF_SELFCHECK_QUERIES > 0:
            self.ivf_pool_recall = measure_pool_recall(
                a["emb"], a["valid"], tuple(a[k] for k in IVF_KEYS),
                pool=min(config.DEFAULT_POOL_SIZE, self.products.n_padded),
                nprobe=self.ivf_nprobe, n_queries=config.IVF_SELFCHECK_QUERIES)
            if self.ivf_pool_recall < config.IVF_SELFCHECK_MIN:
                logger.warning(
                    "IVF pool recall self-check: %.3f < %.2f on this corpus (recall is "
                    "data-dependent; this embedding space may be weakly clustered). Raise "
                    "IVF_NPROBE (now %d) or use the exact/striped pool.",
                    self.ivf_pool_recall, config.IVF_SELFCHECK_MIN, self.ivf_nprobe)
            else:
                logger.info("IVF pool recall self-check: %.3f (nprobe=%d)",
                            self.ivf_pool_recall, self.ivf_nprobe)

    # ------------------------------------------------------------ dense pool
    def _dense_topk(self, a, qvec, pool):
        """The pool for qvec (D,) or (B, D): exact (stable top-k over the
        corpus), striped or IVF, over the float or int8 corpus, by what
        the arrays hold. Striped and IVF ids are clamped into [0, n_padded):
        -inf tail lanes can carry padding ids."""
        n_hi = self.products.n_padded - 1
        if self.dense_pool == "ivf":
            from review_recommender_tpu_torch.ops.ivf import ivf_topk

            s, i = ivf_topk(a["ivf_centroids"], a["ivf_blocks"], a["ivf_block_valid"],
                            a["ivf_block_rows"], a["ivf_block_centroid"], qvec, pool,
                            self.ivf_nprobe)
            return s, torch.clamp(i, max=n_hi)
        if self.dense_pool == "striped":
            if self.int8_mode:
                s, i = dense_striped_topk_scan_int8(a["emb_qs"], a["emb_scale_s"],
                                                    a["valid_s"], qvec, pool)
            else:
                s, i = dense_striped_topk_scan(a["emb_s"], a["valid_s"], qvec, pool)
            return s, torch.clamp(i, max=n_hi)
        if self.int8_mode:
            sims = dense_scores_int8(a["emb_q"], a["emb_scale"], qvec, a["valid"])
        else:
            sims = dense_scores(a["emb"], qvec, a["valid"])
        return stable_topk(sims, min(int(pool), sims.shape[-1]))

    # --------------------------------------------------------------- stage A
    def _stage_a_for(self, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid, *, pool):
        """QueryFormsMixin hook: run_search's stage A on this engine's arrays."""
        return self._stage_a_impl(self.arrays, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                                  pool=pool)

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

    # ------------------------------------------------------------- snippets
    def _snippet_scores_impl(self, rev, qvec):
        """(..., n_docs) best review sim per product for qvec (D,) or (B, D)."""
        return best_review_scores(rev["rev_emb"], rev["rev_product"], rev["rev_valid"], qvec,
                                  self.n_docs)

    def _snippet_scores_full(self, qvec):
        """SplitPathHooksMixin hook: (n_docs,) for a host query vector."""
        q = torch.from_numpy(np.asarray(qvec, np.float32).reshape(-1)).to(self.device)
        return self._snippet_scores_impl(self.rev_arrays, q)

    def _snippet_lane(self, rev, qvec, idx, use_snips: bool):
        """(best_raw (..., P), has_snips) for the pool rows idx: each row's
        best review sim (0 where it has none), and per query whether any is
        nonzero, a (..., 1) bool tensor. Off: zeros and False, and no review
        is read."""
        if not use_snips or rev is None:
            return torch.zeros(idx.shape, dtype=torch.float32, device=self.device), False
        best_full = self._snippet_scores_impl(rev, qvec)
        best_pad = torch.zeros(*idx.shape[:-1], self.products.n_padded, dtype=torch.float32,
                               device=self.device)
        best_pad[..., : self.n_docs] = torch.where(best_full > SNIPPET_NONE, best_full, 0.0)
        best_raw = best_pad.gather(-1, idx)
        # != 0, not > 0: the split path keeps all-negative sims as a computed
        # lane ((best_raw != 0).any()) and the fusion minmaxes them
        return best_raw, (best_raw != 0).any(dim=-1, keepdim=True)

    # ------------------------------------------------------------ fused path
    def _fused_impl(self, a, rev, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                    w: FusionWeights, use_snips: bool, *, pool, k):
        """One pass without the cross-encoder, device gate, for one query or
        a batch (a leading axis on every query input; `w` shared floats or
        (B, 1) tensors). Returns (rows (..., k), final (..., k), breakdown
        (..., k, 7))."""
        st = self._stage_a_impl(a, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid,
                                pool=pool)
        shape = st["idx"].shape
        best_raw, has_snips = self._snippet_lane(rev, qvec, st["idx"], use_snips)
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"],
            torch.zeros(shape, dtype=torch.float32, device=self.device),
            torch.zeros(shape, dtype=torch.bool, device=self.device),
            best_raw, has_snips, st["n_reviews"], st["avg_stars"],
            self._device_gate(w.gate_penalty, st), st["cand_valid"], w,
        )
        scores, pos = final_topk(res, k)
        return st["idx"].gather(-1, pos), scores, breakdown(res, pos)

    def _fused_packed(self, qp: torch.Tensor, w: FusionWeights, use_snips: bool, *, pool, k):
        """The fused query from combined rows [qvec | packed features]: (L,)
        for one query, (B, L) for a batch with shared weights (the JAX
        engine's _fused_packed_impl and its vmap, _fused_packed_batch_impl).
        One input copy per call."""
        d = self.products.dim
        return self._fused_impl(self.arrays, self.rev_arrays, qp[..., :d],
                                *self._unpack(qp[..., d:]), w, use_snips, pool=pool, k=k)

    @staticmethod
    def split_fused1(out):
        """(k, 9) result, a tensor or a host array -> (row ids (k,) int64,
        final scores (k,)) on the host."""
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        return out[:, 0].astype(np.int64), out[:, 1]

    def _fused_packed1(self, qp: torch.Tensor, w: FusionWeights, use_snips: bool, *, pool, k):
        """The fused query from ONE input buffer [qvec | packed features] to
        ONE (k, 9) f32 output (_result_buffer)."""
        return self._result_buffer(*self._fused_packed(qp, w, use_snips, pool=pool, k=k))

    def query_fused1(self, qvec, query: str, w: FusionWeights, pool: int, k: int,
                     use_snips: bool = False) -> torch.Tensor:
        """query_fused returning ONE (k, 9) f32 device tensor [row id, final,
        7 signals]; split it on the host with split_fused1. One copy in, one
        read out."""
        qp = self._upload(self._combined(qvec, self.featurizer.featurize_packed(query)))
        return self._fused_packed1(qp, w, self._use_snips(use_snips),
                                   pool=min(pool, self.products.n_padded), k=k)

    # ------------------------------------------------- coalesced rerank, stage A
    def _rerank_a_impl(self, a, rev, qp: torch.Tensor, use_snips: bool, *, pool):
        """Batched stage A of the coalesced rerank path: everything the fused
        pass computes before fusion (pool, BM25, gate, snippet lane), for
        (B, L + 8) rows [qvec | packed features | 8 weights], as
        _fused_packed_pw reads them. Returns (st, best_raw, has_snips,
        gate), each with the batch axis."""
        d = self.products.dim
        qvec = qp[:, :d]
        st = self._stage_a_impl(a, qvec, *self._unpack(qp[:, d:-8]), pool=pool)
        best_raw, has_snips = self._snippet_lane(rev, qvec, st["idx"], use_snips)
        gate = self._device_gate(self._row_weights(qp).gate_penalty, st)
        return st, best_raw, has_snips, gate

    def _rerank_stage_a(self, qp: torch.Tensor, use_snips: bool, pool: int):
        """RerankCoalesceMixin hook: one batched stage A on this engine's
        arrays (query_rerank_batched_pw lives in engine/rerank_coalesce.py)."""
        return self._rerank_a_impl(self.arrays, self.rev_arrays, qp, use_snips, pool=pool)

    # ------------------------------------------------ the rerank lane on device
    def attach_models(self, biencoder, crossencoder=None) -> None:
        """Attach the towers of query_e2e: the bi-encoder encodes the query on
        the device and the cross-encoder reranks pairs built on the device
        from the index's doc_tokens (index/build.py:attach_rerank_tokens).
        Also wires them as run_search's hooks where none were given. The
        towers must live on the engine's device; nothing is moved."""
        for name, tower in (("biencoder", biencoder), ("crossencoder", crossencoder)):
            if tower is not None and not _same_device(tower.device, self.device):
                raise ValueError(f"attach_models: the {name} is on {tower.device}, the engine "
                                 f"on {self.device}; build the tower on the engine's device")
        self._be = biencoder
        self._ce = crossencoder
        if self.query_encoder is None:
            self.query_encoder = biencoder
        if self.cross_encoder is None and crossencoder is not None:
            self.cross_encoder = crossencoder

    def _build_pairs(self, q_raw, q_len, d_tok, d_len):
        """Pairs with the bi-encoder's tokenizer ids (the JAX engine's choice)."""
        tok = self._be.tokenizer
        return build_pairs_device(tok.cls_id, tok.sep_id, q_raw, q_len, d_tok, d_len)

    def _has_rerank_tokens(self) -> bool:
        return "doc_tokens" in self.arrays

    def _e2e_impl(self, q_raw, q_len: int, packed, w: FusionWeights, *, pool, k, rr_k):
        """The whole query on the device from the query's token ids: returns
        (rows (k,), final (k,), qvec (D,))."""
        a = self.arrays
        tok = self._be.tokenizer
        b_ids, b_mask = encode_query_ids_device(tok.cls_id, tok.sep_id, q_raw, q_len)
        qvec = self._be.model(b_ids[None], b_mask[None])[0]
        st = self._stage_a_impl(a, qvec, *self._unpack(packed), pool=pool)
        p = st["idx"].shape[0]
        rerank_raw = torch.zeros(p, dtype=torch.float32, device=self.device)
        rerank_mask = torch.zeros(p, dtype=torch.bool, device=self.device)
        if rr_k > 0 and self._ce is not None:
            rows = st["idx"][:rr_k]
            d_tok, d_len = a["doc_tokens"][rows], a["doc_token_len"][rows]
            # the pair [CLS] q [SEP] d [SEP] must fit the cross-encoder's positions
            sd_max = self._ce.cfg.max_position - q_raw.shape[0] - 3
            if sd_max < d_tok.shape[1]:
                d_tok, d_len = d_tok[:, :sd_max], torch.clamp(d_len, max=sd_max)
            # the (rr_k, Lq + Sd + 3) block as it is: no bucketing, as in JAX
            rerank_raw[:rr_k] = self._ce.model(*self._build_pairs(q_raw, q_len, d_tok, d_len))
            rerank_mask = (torch.arange(p, device=self.device) < rr_k) & st["cand_valid"]
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"], rerank_raw, rerank_mask,
            torch.zeros(p, dtype=torch.float32, device=self.device), False,
            st["n_reviews"], st["avg_stars"], self._device_gate(w.gate_penalty, st),
            st["cand_valid"], w,
        )
        scores, pos = final_topk(res, min(k, p))
        return st["idx"][pos], scores, qvec

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
