"""Split-path host hooks, result rows and search knobs.

A jax-free copy of `review_recommender_tpu/engine/hooks.py:38-184`
(`SNIPPET_NONE`, `_split_host_hooks`, `SIGNAL_ORDER`,
`assemble_result_rows`, `resolve_search_knobs`). Reference semantics:

  rerank    zero scores still occupy the rerank lanes when the model is
            missing or disabled; texts are cut to 2000 characters;
            rr_k = min(rerank_k, n_cand)
  gate      host mode = exact substring match over text[:6000]; device
            mode = penalty^misses from the stage-A group-hit counters
  snippets  max_scan > 0 / -1 = the reference's truncated host scan
            (engine/snippets.py:_exact_snippets); max_scan 0 = the device
            lane over every review (ops/segment.py), negative sims kept:
            (best_raw != 0).any() decides whether the lane was computed
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.utils.text import calculate_gate_factor

SIGNAL_ORDER = ("dense", "bm25", "rerank", "prior", "best", "trust", "gate")
SNIPPET_NONE = -1e30  # sentinel: the product has no scored review


def breakdown(res, pos: torch.Tensor) -> torch.Tensor:
    """(..., k, 7) signal columns of a FusionResult at the winners `pos`,
    in SIGNAL_ORDER."""
    return torch.stack([getattr(res, name).gather(-1, pos) for name in SIGNAL_ORDER], dim=-1)


class SplitPathHooksMixin:
    """Requires self.products, self.cross_encoder, self.gate_mode,
    self.device, HostSnippetsMixin (_exact_snippets, _snippet_texts) and
    `_snippet_scores_full(qvec) -> (n_docs,) tensor` (each product's best
    review sim, at or below SNIPPET_NONE where it has none)."""

    def _split_host_hooks(
        self,
        query: str,
        groups,
        qvec: np.ndarray,
        cand_rows: np.ndarray,
        n_pool: int,
        *,
        rerank_k: int,
        gate_pen_h: float,
        use_snips_eff: bool,
        max_scan: int,
        gate_hits=None,
        n_groups=None,
        timer=None,
    ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor, np.ndarray, bool, Dict]:
        """Returns (rerank_raw, rerank_mask, gate, best_raw, has_snips,
        snips). `qvec` is the host query vector; `gate_hits`/`n_groups` are
        the stage-A counters, read only in device-gate mode."""
        stage = timer.stage if timer is not None else (
            lambda _name: contextlib.nullcontext())
        cand_texts = [self.products.agg_texts[int(i)] for i in cand_rows]
        n_cand = len(cand_texts)

        rerank_raw = np.zeros(n_pool, np.float32)
        rerank_mask = np.zeros(n_pool, bool)
        if rerank_k > 0:
            rr_k = min(int(rerank_k), n_cand)
            if rr_k > 0:
                if self.cross_encoder is not None and config.ENABLE_RERANKING:
                    texts = [t[:2000] for t in cand_texts[:rr_k]]
                    with stage("rerank"):
                        rerank_raw[:rr_k] = np.asarray(
                            self.cross_encoder(query, texts), dtype=np.float32)
                rerank_mask[:rr_k] = True

        if self.gate_mode == "host":
            gate_h = np.ones(n_pool, np.float32)
            for i, text in enumerate(cand_texts):
                gf, _, _ = calculate_gate_factor(text[:6000], groups, gate_pen_h)
                gate_h[i] = gf
            gate = torch.from_numpy(gate_h).to(self.device)
        else:
            base = torch.tensor(gate_pen_h, dtype=torch.float32, device=self.device)
            gate = torch.pow(base, (n_groups - gate_hits).to(torch.float32))

        best_raw = np.zeros(n_pool, np.float32)
        snips: Dict[str, dict] = {}
        has_snips = False
        n_cand = len(cand_rows)
        if use_snips_eff and max_scan != 0:
            cap = max_scan if max_scan > 0 else config.MAX_REVIEWS_SCAN
            with stage("snippets_exact"):
                best_by_row, snips = self._exact_snippets(qvec, cand_rows, cap)
            best_raw[:n_cand] = [best_by_row.get(int(r), 0.0) for r in cand_rows]
            has_snips = bool((best_raw != 0).any())
        elif use_snips_eff:
            with stage("snippets"):
                best_full = self._snippet_scores_full(qvec).cpu().numpy()
                v = best_full[np.asarray(cand_rows, np.int64)]
                best_raw[:n_cand] = np.where(v > SNIPPET_NONE, v, 0.0)
                has_snips = bool((best_raw != 0).any())
                if has_snips:
                    snips = self._snippet_texts(qvec, cand_rows)
        return rerank_raw, rerank_mask, gate, best_raw, has_snips, snips


def assemble_result_rows(products, row_ids, finals, signals):
    """Result rows (dicts) in rank order, stopping at the first non-finite
    final (top-k pads with -inf). `signals` maps each SIGNAL_ORDER name to
    a rank-aligned array. Field order is the JAX package's DataFrame
    column order."""
    last_ts = products.last_ts
    rows = []
    for rank in range(len(row_ids)):
        s = float(finals[rank])
        if not math.isfinite(s):
            break
        ridx = int(row_ids[rank])
        rows.append({
            "sku": products.skus[ridx],
            "n_reviews": float(products.n_reviews[ridx]),
            "avg_stars": float(products.avg_stars[ridx]),
            **({"last_ts": last_ts[ridx]} if last_ts else {}),
            "agg_text": products.agg_texts[ridx],
            **{f"_{name}": float(signals[name][rank]) for name in SIGNAL_ORDER},
            "_final": s,
        })
    return rows


def resolve_search_knobs(k, rerank_k, w_dense, w_bm25, w_rerank, w_prior,
                         w_best, prior_C, min_reviews, gate_penalty):
    """run_search's knob defaults (config.py). Returns (k, rerank_k,
    gate_pen_h, FusionWeights)."""
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    c = config
    k = c.DEFAULT_K if k is None else int(k)
    rerank_k = c.DEFAULT_RERANK_K if rerank_k is None else int(rerank_k)
    gate_pen_h = float(c.DEFAULT_GATE_PENALTY if gate_penalty is None else gate_penalty)
    w = FusionWeights.make(
        c.DEFAULT_W_DENSE if w_dense is None else w_dense,
        c.DEFAULT_W_BM25 if w_bm25 is None else w_bm25,
        c.DEFAULT_W_RERANK if w_rerank is None else w_rerank,
        c.DEFAULT_W_PRIOR if w_prior is None else w_prior,
        c.DEFAULT_W_BEST if w_best is None else w_best,
        c.DEFAULT_PRIOR_C if prior_C is None else prior_C,
        c.DEFAULT_MIN_REVIEWS if min_reviews is None else min_reviews,
        gate_pen_h,
    )
    return k, rerank_k, gate_pen_h, w
