"""ShardedSearchEngine: the hybrid engine over a corpus sharded row-wise
across a list of devices.

Counterpart of `review_recommender_tpu/parallel/sharded.py`. The JAX
engine is one shard_map program over a 1-D mesh driven by one process;
the port keeps the single controller: one process holds the engine, each
shard's rows live on that shard's device, a device may repeat (four
shards on one card), and the collectives become explicit copies to the
lead device, shard 0's:

  each shard   dense scores over its rows -> local top-pool           _pool
  all_gather   each shard's (score, global row) pairs concatenated in
               shard order on the lead device; a stable top-pool of them
               keeps lax.top_k's order (ties to the lower global row)
  psum         candidate features: each shard writes the rows it owns
               into one lead tensor (torch.where, so the owner's value
               arrives as it is, a NaN avg_stars included)          _assemble
  lead         BM25 + gate + fusion + final top-k over the merged pool
  pmax         snippet lane: each shard's best review sim per product,
               an elementwise max on the lead device

Rows keep the JAX layout: per = max(ceil(n_padded / n), 8) rows a shard,
rows padded to per * n, review rows padded into the discard bucket n_docs.
The striped pool slices each shard's own rows into its (s_l, Gs, D) view
with DENSE_POOL_STRIPES // n stripes (raised to DEFAULT_POOL_SIZE, with a
warning); IVF clusters each shard's rows on its device with
ceil(IVF_NPROBE / n) probes a shard. Unlike JAX (`sharded.py:254`, which
takes shard 0's block size for all and fails when the auto sizes differ),
every shard's blocks are padded to the largest block size, the padded
slots invalid, so each shard keeps the clustering it would get alone.

The query vector is encoded once on the lead device and copied to each
shard's device (JAX runs the bi-encoder on every chip). `query_e2e`
keeps JAX's pair-sharded rerank: rr_pad = ceil(rr_k / n) * n pairs, the
pool padded with empty documents, shard s scoring pairs [s*per, (s+1)*per)
on its device, with one copy of each tower per distinct device. On CUDA
tensors every shard launches the port's kernels: `bm25_topk` the packed
BM25 kernel over its own (L, per_p) postings (or the unpacked one on an
unpackable classic bundle), the towers the attention kernel; on CPU
tensors the plain versions run. Batches of any size run as one pass (no
batch buckets: those exist for XLA's compiles).
"""
from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.device import resolve_devices
from review_recommender_tpu_torch.engine.featurize import QueryFeaturizer
from review_recommender_tpu_torch.engine.hooks import SNIPPET_NONE, SplitPathHooksMixin, breakdown
from review_recommender_tpu_torch.engine.query_forms import QueryFormsMixin
from review_recommender_tpu_torch.engine.rerank_coalesce import RerankCoalesceMixin
from review_recommender_tpu_torch.engine.search import (
    _same_device,
    build_pairs_device,
    encode_query_ids_device,
)
from review_recommender_tpu_torch.engine.snippets import HostSnippetsMixin
from review_recommender_tpu_torch.index.schema import IndexBundle, check_hbm_fit, enforce_hbm_fit
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
    striped_topk,
)
from review_recommender_tpu_torch.ops.fusion import FusionWeights, final_topk, fuse_candidates
from review_recommender_tpu_torch.ops.gate import gate_factors_device
from review_recommender_tpu_torch.ops.segment import best_review_scores

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _pad_rows_to(arr, n_rows: int, fill=0):
    """arr (numpy or torch) with rows appended up to n_rows, filled with `fill`."""
    extra = n_rows - arr.shape[0]
    if extra == 0:
        return arr
    if torch.is_tensor(arr):
        return torch.cat([arr, arr.new_full((extra,) + tuple(arr.shape[1:]), fill)])
    return np.concatenate([arr, np.full((extra,) + arr.shape[1:], fill, arr.dtype)])


def _tower_on(tower, device: torch.device):
    """The tower itself where it lives on `device`, else a copy there."""
    if _same_device(tower.device, device):
        return tower
    moved = copy.copy(tower)
    moved.model = copy.deepcopy(tower.model).to(device)
    moved.device, moved.devices, moved.models = device, [device], {device: moved.model}
    return moved


def _widen_blocks(ivf, block_rows: int):
    """The IVF layout with each block padded to `block_rows` slots, the
    padded slots invalid (row id 0): the same clustering, probed alike."""
    extra = block_rows - ivf.block_rows
    if extra == 0:
        return ivf
    pad = ((0, 0), (0, extra))
    return dataclasses.replace(
        ivf, block_row_ids=np.pad(ivf.block_row_ids, pad),
        block_valid=np.pad(ivf.block_valid, pad),
        stats={**ivf.stats, "block_rows": block_rows,
               "fill": float(ivf.block_valid.sum()) / (ivf.n_blocks * block_rows)})


@dataclasses.dataclass
class Shard:
    """One shard: its device, the global row of its local row 0, and its
    tensors over local rows (`rev`: its slice of the review rows)."""

    device: torch.device
    offset: int
    arrays: dict
    rev: Optional[dict] = None


class ShardedSearchEngine(QueryFormsMixin, HostSnippetsMixin, RerankCoalesceMixin,
                          SplitPathHooksMixin):
    """The hybrid engine over a corpus sharded across `devices` (or
    `n_shards` shards on `device`'s type, default MESH_SHARDS;
    device.resolve_devices). The surface and contracts of the JAX
    engine: run_search (fast and split paths, debug["n_shards"]),
    query_fused, query_fused_batched(_pw), query_rerank_batched_pw,
    attach_models / query_e2e, dense_topk, bm25_topk, encode_query, and
    `dtype` / `n_shards` for the server's info. run_search, encode_query,
    query_e2e and the query_fused forms are SearchEngine's
    (engine/query_forms.py) over this engine's _stage_a_for,
    _fused_packed and _e2e_impl. serve/api.py and serve/native_server.py
    run over it as over SearchEngine."""

    def __init__(
        self,
        bundle: IndexBundle,
        *,
        devices: Optional[Sequence] = None,
        n_shards: Optional[int] = None,
        device="cuda",
        emb_dtype: Optional[str] = None,
        dense_pool: Optional[str] = None,
        query_encoder: Optional[Callable[[str], np.ndarray]] = None,
        cross_encoder: Optional[Callable[[str, List[str]], np.ndarray]] = None,
        gate_mode: Optional[str] = None,
    ):
        self.devices = resolve_devices(devices, n_shards or config.MESH_SHARDS, device)
        self.n_shards = len(self.devices)
        self.device = self.devices[0]  # the lead device: merge, fusion, stage B
        if self._kernels_ok() and config.QUERY_TERMS_CAP > MAX_QUERY_SLOTS:
            raise ValueError(f"QUERY_TERMS_CAP={config.QUERY_TERMS_CAP} is over the BM25 "
                             f"kernels' {MAX_QUERY_SLOTS} query slots")
        self.bundle = bundle
        self.products = bundle.products
        self.reviews = bundle.reviews
        self.n_docs = self.products.n_docs
        raw_dtype = emb_dtype or config.EMB_DTYPE
        self.int8_mode = raw_dtype == "int8"
        if not self.int8_mode and raw_dtype not in _DTYPES:
            raise ValueError(f"unsupported emb_dtype {raw_dtype!r}")
        self.dtype = torch.bfloat16 if self.int8_mode else _DTYPES[raw_dtype]
        self.gate_mode = gate_mode or config.GATE_MODE
        if self.gate_mode not in ("device", "host"):
            raise ValueError(f"gate_mode must be 'device' or 'host', got {self.gate_mode!r}")
        # "auto" resolves by the global corpus size, as the single engine's
        self.dense_pool = config.resolve_pool_mode(
            dense_pool or config.DENSE_POOL_MODE, self.products.n_padded)
        if self.dense_pool not in ("exact", "striped", "ivf"):
            raise ValueError(f"unknown dense pool mode {self.dense_pool!r}")
        if self.dense_pool == "ivf" and self.int8_mode:
            raise ValueError("DENSE_POOL_MODE=ivf needs a bf16/f32 corpus (same constraint "
                             "as the single engine)")
        self.query_encoder = query_encoder
        self.cross_encoder = cross_encoder
        self.dense_stripes = config.DENSE_POOL_STRIPES
        # each shard's striped pool yields at most its stripe count, so a
        # stripe count under the pool would shrink the merged pool
        self._shard_stripes = max(1, self.dense_stripes // self.n_shards)
        if self.dense_pool == "striped" and self._shard_stripes < config.DEFAULT_POOL_SIZE:
            logger.warning(
                "DENSE_POOL_STRIPES=%d // %d shards = %d < pool %d: raising per-shard "
                "stripes to %d to preserve the merged pool size", self.dense_stripes,
                self.n_shards, self._shard_stripes, config.DEFAULT_POOL_SIZE,
                config.DEFAULT_POOL_SIZE)
            self._shard_stripes = config.DEFAULT_POOL_SIZE

        # own the memory budget of every device before placing anything
        self.hbm_report = enforce_hbm_fit(
            bundle, self.devices, self.dtype, quantize_int8=self.int8_mode,
            striped=self.dense_pool == "striped", ivf=self.dense_pool == "ivf",
            ivf_centroids=config.IVF_CENTROIDS, ivf_block_rows=config.IVF_BLOCK_ROWS)
        self.per = max(-(-self.products.n_padded // self.n_shards), 8)
        self.n_rows = self.per * self.n_shards
        logger.info("%d shards over %s: %d rows a shard, %s pool", self.n_shards,
                    [str(d) for d in self.devices], self.per, self.dense_pool)
        self.shards = self._place_products()
        if self.dense_pool == "ivf":
            self._build_ivf()
        self._place_reviews()
        self.avgdl = torch.tensor(self.products.avgdl or 1.0, dtype=torch.float32,
                                  device=self.device)
        self.avgdl_h = float(np.float32(self.products.avgdl or 1.0))
        self._bm25_packed_cache = False  # False = unresolved, None = not packed
        self._build_rev_csr()
        self.featurizer = QueryFeaturizer(self.products, query_terms_cap=config.QUERY_TERMS_CAP)
        self._be = None  # towers of query_e2e (attach_models)
        self._ce = None
        self._ces: List = []

    # ------------------------------------------------------------ placement
    def _place_products(self) -> List[Shard]:
        """Each shard's rows [s*per, (s+1)*per) of the query path's tensors,
        contiguous on its device, plus its striped slices."""
        host = self.products.device_arrays(torch.device("cpu"), self.dtype,
                                           quantize_int8=self.int8_mode)
        host = {k: _pad_rows_to(v, self.n_rows) for k, v in host.items()}
        shards = []
        for s, dev in enumerate(self.devices):
            lo = s * self.per
            a = {k: v[lo:lo + self.per].to(dev) for k, v in host.items()}
            if self.dense_pool == "striped" and self.int8_mode:
                a["emb_qs"], a["emb_scale_s"], a["valid_s"] = slice_corpus_for_striped_int8(
                    a["emb_q"], a["emb_scale"], a["valid"], self._shard_stripes)
            elif self.dense_pool == "striped":
                a["emb_s"], a["valid_s"] = slice_corpus_for_striped(
                    a["emb"], a["valid"], self._shard_stripes)
            shards.append(Shard(dev, lo, a))
        return shards

    def _build_ivf(self) -> None:
        """Per-shard IVF over each shard's own rows, k-means on its device;
        block ids stay local rows. Blocks are padded to the largest block
        size of any shard (the auto size follows a shard's valid rows)."""
        from review_recommender_tpu_torch.ops.ivf import build_ivf, ivf_device_arrays

        p = self.products
        emb = _pad_rows_to(np.asarray(p.emb, np.float32), self.n_rows)
        valid = _pad_rows_to(np.asarray(p.valid, bool), self.n_rows)
        ivfs = [build_ivf(emb[sh.offset:sh.offset + self.per],
                          valid[sh.offset:sh.offset + self.per],
                          n_centroids=config.IVF_CENTROIDS,
                          block_rows=config.IVF_BLOCK_ROWS, device=sh.device)
                for sh in self.shards]
        self.ivf_auto_block_rows = [iv.block_rows for iv in ivfs]  # each shard's own
        self.ivf_block_rows = max(self.ivf_auto_block_rows)
        self.ivfs = [_widen_blocks(iv, self.ivf_block_rows) for iv in ivfs]
        for sh, iv in zip(self.shards, self.ivfs):
            sh.arrays.update(ivf_device_arrays(iv, sh.arrays["emb"]))
        self.ivf_nprobe_local = -(-config.IVF_NPROBE // self.n_shards)
        logger.info("IVF over %d shards: block sizes %s -> %d, nprobe %d a shard",
                    self.n_shards, self.ivf_auto_block_rows, self.ivf_block_rows,
                    self.ivf_nprobe_local)

    def _place_reviews(self) -> None:
        """Each shard's slice of the review rows; pad rows point at the
        discard bucket n_docs, not product 0."""
        self.has_reviews = self.reviews is not None
        if not self.has_reviews:
            return
        host = self.reviews.device_arrays(torch.device("cpu"), self.dtype)
        rper = max(-(-self.reviews.m_padded // self.n_shards), 8)
        m_rows = rper * self.n_shards
        host = {k: _pad_rows_to(v, m_rows, self.n_docs if k == "rev_product" else 0)
                for k, v in host.items()}
        for s, sh in enumerate(self.shards):
            sh.rev = {k: v[s * rper:(s + 1) * rper].to(sh.device) for k, v in host.items()}

    def _replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """t on each shard's device, one copy per distinct device."""
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d)
        return [copies[d] for d in self.devices]

    def _kernels_ok(self) -> bool:
        """The BM25 kernels run where every shard's tensors are on CUDA."""
        return all(d.type == "cuda" for d in self.devices)

    # ------------------------------------------------------- pool and merge
    def _merge(self, parts, k: int):
        """(scores, global rows) of each shard -> the stable top-k of their
        concatenation in shard order on the lead device (JAX: all_gather,
        then lax.top_k)."""
        all_s = torch.cat([s.to(self.device) for s, _ in parts], dim=-1)
        all_i = torch.cat([i.to(self.device) for _, i in parts], dim=-1)
        top, sel = stable_topk(all_s, min(int(k), all_s.shape[-1]))
        return top, all_i.gather(-1, sel)

    def _local_scores(self, a: dict, q: torch.Tensor) -> torch.Tensor:
        if self.int8_mode:
            return dense_scores_int8(a["emb_q"], a["emb_scale"], q, a["valid"])
        return dense_scores(a["emb"], q, a["valid"])

    def _local_pool(self, sh: Shard, q: torch.Tensor, p_local: int):
        """One shard's pool: (scores, local rows). Striped and IVF -inf
        lanes can carry ids past the local rows; they are clamped into
        them, or they would alias the next shard's rows once offset."""
        a = sh.arrays
        if self.dense_pool == "ivf":
            from review_recommender_tpu_torch.ops.ivf import IVF_KEYS, ivf_topk

            s, i = ivf_topk(*(a[key] for key in IVF_KEYS), q, p_local, self.ivf_nprobe_local)
        elif self.dense_pool == "striped" and self.int8_mode:
            s, i = dense_striped_topk_scan_int8(a["emb_qs"], a["emb_scale_s"], a["valid_s"],
                                                q, p_local)
        elif self.dense_pool == "striped":
            s, i = dense_striped_topk_scan(a["emb_s"], a["valid_s"], q, p_local)
        else:
            return stable_topk(self._local_scores(a, q), p_local)
        return s, torch.clamp(i, max=self.per - 1)

    def _pool(self, qs: List[torch.Tensor], pool: int):
        """The merged pool for a query (D,) or batch (B, D), given on each
        shard's device in `qs`: (scores, global rows), each (..., P), on
        the lead device."""
        p_local = min(int(pool), self.per)
        parts = []
        for sh, q in zip(self.shards, qs):
            s, i = self._local_pool(sh, q, p_local)
            parts.append((s, i + sh.offset))
        return self._merge(parts, pool)

    def _owners(self, idx: torch.Tensor):
        """Per shard, (mine, local): which pool rows it owns (on the lead
        device) and their local rows (0 elsewhere) on the shard's device."""
        out = []
        for sh in self.shards:
            local = idx - sh.offset
            mine = (local >= 0) & (local < self.per)
            out.append((mine, torch.where(mine, local, 0).to(sh.device)))
        return out

    def _assemble(self, owners, name: str) -> torch.Tensor:
        """The pool rows of the shards' `name` on the lead device, each row
        its owner's value as it is (JAX: owner-contributes, psum)."""
        out = None
        for sh, (mine, local) in zip(self.shards, owners):
            g = sh.arrays[name][local].to(self.device)
            m = mine.reshape(mine.shape + (1,) * (g.ndim - mine.ndim))
            out = torch.where(m, g, torch.zeros_like(g) if out is None else out)
        return out

    def _debug_fields(self) -> dict:
        return {"n_shards": self.n_shards}

    # --------------------------------------------------------------- stage A
    def _stage_a_for(self, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid, *, pool):
        """QueryFormsMixin hook: run_search's stage A for a query vector on
        the lead device."""
        return self._stage_a(self._replicate(qvec), q_terms, q_idf, gp_mask, gt_ids, g_valid,
                             pool=pool)

    def _stage_a(self, qs, q_terms, q_idf, gp_mask, gt_ids, g_valid, *, pool) -> dict:
        """Sharded pool + candidate features + BM25 + gate hit counts, on
        the lead device, with the keys of SearchEngine._stage_a_impl (the
        split path's and the coalesced rerank's stage A)."""
        dense_raw, idx = self._pool(qs, pool)
        owners = self._owners(idx)
        take = lambda name: self._assemble(owners, name)
        doc_terms = take("doc_terms")
        if "doc_bm25" in self.shards[0].arrays:
            bm25_raw = bm25_candidate_scores_eager(doc_terms, take("doc_bm25"), q_terms)
        else:
            bm25_raw = bm25_candidate_scores(doc_terms, take("doc_tf"), take("doc_len"),
                                             q_terms, q_idf, self.avgdl)
        _factor, gate_hits = gate_factors_device(take("gate_bits"), doc_terms, gp_mask,
                                                 gt_ids, g_valid, 1.0)
        return {
            "idx": idx,
            "dense_raw": dense_raw,
            "cand_valid": torch.isfinite(dense_raw),
            "bm25_raw": bm25_raw,
            "gate_hits": gate_hits,
            "n_groups": g_valid.to(torch.int32).sum(dim=-1, keepdim=True),
            "n_reviews": take("n_reviews"),
            "avg_stars": take("avg_stars"),
        }

    # ------------------------------------------------------------- snippets
    def _snippet_scores(self, qs) -> torch.Tensor:
        """(..., n_docs) best review sim per product on the lead device:
        each shard's segment max over its own reviews, then their
        elementwise max (JAX: pmax); -inf where no shard holds one."""
        best = None
        for sh, q in zip(self.shards, qs):
            b = best_review_scores(sh.rev["rev_emb"], sh.rev["rev_product"],
                                   sh.rev["rev_valid"], q, self.n_docs).to(self.device)
            best = b if best is None else torch.maximum(best, b)
        return best

    def _snippet_scores_full(self, qvec):
        """SplitPathHooksMixin hook: (n_docs,) for a host query vector."""
        return self._snippet_scores(self._replicate(
            self._upload(np.asarray(qvec, np.float32).reshape(-1))))

    def _snippet_lane(self, qs, st: dict, use_snips: bool):
        """(best_raw (..., P), has_snips) of the pool: each valid
        candidate's best review sim (0 where it has none), and per query
        whether any is nonzero. Off: zeros and False, no review read."""
        idx = st["idx"]
        if not (use_snips and self.has_reviews):
            return torch.zeros(idx.shape, dtype=torch.float32, device=self.device), False
        best = self._snippet_scores(qs).gather(-1, idx.clamp(0, self.n_docs - 1))
        keep = (best > SNIPPET_NONE) & st["cand_valid"] & (idx < self.n_docs)
        best_raw = torch.where(keep, best, 0.0)
        # != 0, not > 0: the split path keeps all-negative sims as a lane
        return best_raw, (best_raw != 0).any(dim=-1, keepdim=True)

    # ------------------------------------------------------------ fused path
    def _fused_impl(self, qvec, q_terms, q_idf, gp_mask, gt_ids, g_valid, w: FusionWeights,
                    use_snips: bool, *, pool, k):
        """One pass without the cross-encoder, device gate, for a query or a
        batch (a leading axis on every query input). Returns (rows (..., k),
        final (..., k), breakdown (..., k, 7))."""
        qs = self._replicate(qvec)
        st = self._stage_a(qs, q_terms, q_idf, gp_mask, gt_ids, g_valid, pool=pool)
        shape = st["idx"].shape
        best_raw, has_snips = self._snippet_lane(qs, st, use_snips)
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
        """The fused query from rows [qvec | packed features], (L,) or (B, L)."""
        d = self.products.dim
        return self._fused_impl(qp[..., :d], *self._unpack(qp[..., d:]), w, use_snips,
                                pool=pool, k=k)

    def _rerank_stage_a(self, qp: torch.Tensor, use_snips: bool, pool: int):
        """RerankCoalesceMixin hook: the batched sharded stage A of the
        coalesced rerank riders, rows [qvec | features | 8 weights]."""
        d = self.products.dim
        qs = self._replicate(qp[:, :d])
        st = self._stage_a(qs, *self._unpack(qp[:, d:-8]), pool=pool)
        best_raw, has_snips = self._snippet_lane(qs, st, use_snips)
        gate = self._device_gate(self._row_weights(qp).gate_penalty, st)
        return st, best_raw, has_snips, gate

    # -------------------------------------------------------------- e2e lane
    def attach_models(self, biencoder, crossencoder=None) -> None:
        """Attach the towers of query_e2e: the bi-encoder on the lead device
        (the query is encoded once), the cross-encoder on every shard's
        device (its pairs are sharded), one copy per distinct device. Also
        wires them as run_search's hooks where none were given."""
        self._be = _tower_on(biencoder, self.device)
        self._ce = crossencoder
        placed = {}
        if crossencoder is not None:
            for d in self.devices:
                if d not in placed:
                    placed[d] = _tower_on(crossencoder, d)
        self._ces = [placed[d] for d in self.devices] if placed else []
        if self.query_encoder is None:
            self.query_encoder = biencoder
        if self.cross_encoder is None and crossencoder is not None:
            self.cross_encoder = crossencoder

    def _has_rerank_tokens(self) -> bool:
        return "doc_tokens" in self.shards[0].arrays

    def _pair_scores(self, q_raw, q_len: int, st: dict, rr_k: int) -> torch.Tensor:
        """Cross-encoder scores of the first rr_pad pool rows, rr_pad =
        ceil(rr_k / n) * n, the pool padded with empty documents: shard s
        scores pairs [s*m, (s+1)*m) on its device (m = rr_pad / n)."""
        m = -(-rr_k // self.n_shards)
        rr_pad = m * self.n_shards
        owners = self._owners(st["idx"])
        d_tok = self._assemble(owners, "doc_tokens")
        d_len = self._assemble(owners, "doc_token_len")
        if rr_pad > d_tok.shape[0]:
            d_tok = _pad_rows_to(d_tok, rr_pad)
            d_len = _pad_rows_to(d_len, rr_pad)
        d_tok, d_len = d_tok[:rr_pad], d_len[:rr_pad]
        sd_max = self._ce.cfg.max_position - q_raw.shape[0] - 3
        if sd_max < d_tok.shape[1]:
            d_tok, d_len = d_tok[:, :sd_max], torch.clamp(d_len, max=sd_max)
        tok = self._be.tokenizer
        scores = []
        for s, (dev, ce) in enumerate(zip(self.devices, self._ces)):
            lo = s * m
            pairs = build_pairs_device(tok.cls_id, tok.sep_id, q_raw.to(dev), q_len,
                                       d_tok[lo:lo + m].to(dev), d_len[lo:lo + m].to(dev))
            scores.append(ce.model(*pairs).to(self.device))
        return torch.cat(scores)

    def _e2e_impl(self, q_raw, q_len: int, packed, w: FusionWeights, *, pool, k, rr_k):
        """Encode once on the lead, the sharded pool and features, the
        pair-sharded rerank, fusion: (rows (k,), final (k,), qvec (D,))."""
        tok = self._be.tokenizer
        b_ids, b_mask = encode_query_ids_device(tok.cls_id, tok.sep_id, q_raw, q_len)
        qvec = self._be.model(b_ids[None], b_mask[None])[0]
        st = self._stage_a(self._replicate(qvec), *self._unpack(packed), pool=pool)
        p = st["idx"].shape[0]
        lanes = torch.arange(p, device=self.device)
        rerank_raw = torch.zeros(p, dtype=torch.float32, device=self.device)
        rerank_mask = torch.zeros(p, dtype=torch.bool, device=self.device)
        if rr_k > 0 and self._ce is not None:
            scores = self._pair_scores(q_raw, q_len, st, rr_k)
            n = min(scores.shape[0], p)
            rerank_raw[:n] = scores[:n]
            rerank_mask = (lanes < rr_k) & st["cand_valid"]
            rerank_raw = torch.where(rerank_mask, rerank_raw, 0.0)
        res = fuse_candidates(
            st["dense_raw"], st["bm25_raw"], rerank_raw, rerank_mask,
            torch.zeros(p, dtype=torch.float32, device=self.device), False,
            st["n_reviews"], st["avg_stars"], self._device_gate(w.gate_penalty, st),
            st["cand_valid"], w,
        )
        scores, pos = final_topk(res, min(k, p))
        return st["idx"][pos], scores, qvec

    # ------------------------------------------------- standalone retrieval
    def dense_topk(self, qvec, k: int):
        """Pure dense retrieval over every shard's rows: (row ids, scores).
        The striped engine takes each shard's stripe maxima over contiguous
        stripes (ops/dense.py:striped_topk), as JAX's dense_topk does."""
        q = self._upload(np.asarray(qvec, np.float32).reshape(-1))
        kl = min(int(k), self.per)
        parts = []
        for sh, qd in zip(self.shards, self._replicate(q)):
            sims = self._local_scores(sh.arrays, qd)
            if self.dense_pool == "striped":
                s, i = striped_topk(sims, kl, self._shard_stripes)
                i = torch.clamp(i, max=self.per - 1)
            else:
                s, i = stable_topk(sims, kl)
            parts.append((s, i + sh.offset))
        scores, idx = self._merge(parts, k)
        return idx, scores

    def bm25_topk(self, query: str, k: int):
        """Sparse retrieval over every shard's rows: (row ids, scores). Per
        shard the single engine's branch order (engine/search.py:
        search_bm25): on CUDA the packed kernel over the shard's own
        postings, else the plain eager scan for an eager bundle, else the
        unpacked kernel; on the CPU the plain scans."""
        qf = self.featurizer.featurize(query)
        terms = self._replicate(torch.from_numpy(qf.q_terms))
        idfs = self._replicate(torch.from_numpy(qf.q_idf))
        kl = min(int(k), self.per)
        packed = self._bm25_packed() if self._kernels_ok() else None
        parts = []
        for s, sh in enumerate(self.shards):
            a, qt, qi = sh.arrays, terms[s], idfs[s]
            if packed is not None:
                pk, dl, vd = packed[s]
                sc, i = bm25_topk_packed(pk, dl, vd, qt, qi, self.avgdl_h, k=k)
                # the pack's pad columns score -inf but lie past the shard's
                # rows: clamp them into the shard before the offset
                i = torch.clamp(i, max=self.per - 1)
            elif "doc_bm25" in a:
                sc, i = masked_topk(bm25_full_scores_eager(a["doc_terms"], a["doc_bm25"], qt),
                                    a["valid"], kl)
            elif self._kernels_ok():
                sc, i = bm25_topk_unpacked(a["doc_terms"], a["doc_tf"], a["doc_len"],
                                           a["valid"], qt, qi, self.avgdl_h, k=kl)
            else:
                sc, i = bm25_topk(a["doc_terms"], a["doc_tf"], a["doc_len"], a["valid"], qt,
                                  qi, self.avgdl_h, k=kl)
            parts.append((sc, i + sh.offset))
        scores, idx = self._merge(parts, k)
        if packed is not None:
            # -inf tails may carry re-padded rows past the bundle's rows
            idx = torch.clamp(idx, max=self.products.n_padded - 1)
        return idx, scores

    def _bm25_packed(self):
        """Lazy packed postings per shard: (packed (L, per_p) int32, doc_len
        (per_p,) f32, valid (per_p,) bool) on its device, each shard's rows
        packed alone (per_p = per rounded up to TILE_N_PACKED), so a
        kernel's column j is the shard's local row j. None, logged, when
        the postings cannot pack losslessly or would not fit."""
        if self._bm25_packed_cache is False:
            self._bm25_packed_cache = None
            p, per = self.products, self.per
            terms = _pad_rows_to(np.asarray(p.doc_terms), self.n_rows)
            tf = _pad_rows_to(np.asarray(p.doc_tf), self.n_rows)
            blocks = []
            for sh in self.shards:
                pk = pack_postings(terms[sh.offset:sh.offset + per], tf[sh.offset:sh.offset + per])
                if pk is None:
                    logger.warning("packed BM25 postings unavailable: a tf is not an integer "
                                   "in 0..255 or a term id is >= 2^24; bm25_topk scans the "
                                   "unpacked postings")
                    return None
                blocks.append(pk)
            extra = sum(b.nbytes for b in blocks)
            if not check_hbm_fit(self.hbm_report["total_bytes"] + extra, self.devices)["fits"]:
                logger.warning("skipping packed BM25 postings over %d shards: +%d MiB would "
                               "exceed the device memory", self.n_shards, extra >> 20)
                return None
            dl = _pad_rows_to(np.asarray(p.doc_len, np.float32), self.n_rows)
            valid = _pad_rows_to(np.asarray(p.valid, bool), self.n_rows)
            out = []
            for sh, pk in zip(self.shards, blocks):
                pad = pk.shape[1] - per
                rows = slice(sh.offset, sh.offset + per)
                put = lambda x: torch.from_numpy(np.pad(x[rows], (0, pad))).to(sh.device)
                out.append((torch.from_numpy(pk).to(sh.device), put(dl), put(valid)))
            self._bm25_packed_cache = out
        return self._bm25_packed_cache
