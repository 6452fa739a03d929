"""Host-side snippet recovery.

A copy of `review_recommender_tpu/engine/snippets.py:25-104`. The device
computes only each product's best review score (ops/segment.py); the text
shown is recovered on the host from a CSR over the review table:

  _snippet_texts    best review text/stars per candidate product (the device
                    lane's mode: argmax over each product's reviews)
  _exact_snippets   the reference's truncated scan for eval-parity runs:
                    candidate products' review rows in original file order,
                    cut at `cap` rows, scored on the host; ties keep the
                    first row in file order

Texts are cut to 600 characters. Host state: `_rev_order` (review rows
stable-sorted by product) and `_rev_offsets` (CSR offsets per product),
built once at engine init.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class HostSnippetsMixin:
    """Requires self.products, self.reviews, self.n_docs."""

    def _build_rev_csr(self) -> None:
        """The host CSR over reviews (None without a review index)."""
        self._rev_order = None
        self._rev_offsets = None
        if self.reviews is not None:
            m = self.reviews.n_reviews_total
            seg = np.asarray(self.reviews.rev_product[:m])
            self._rev_order = np.argsort(seg, kind="stable")
            counts = np.bincount(seg, minlength=self.n_docs + 1)
            self._rev_offsets = np.concatenate([[0], np.cumsum(counts)])

    def _snippet(self, ridx: int, score: float) -> dict:
        return {"score": score, "text": self.reviews.rev_texts[ridx][:600],
                "stars": float(self.reviews.rev_stars[ridx])}

    def _snippet_texts(self, qvec, cand_rows) -> Dict[str, dict]:
        """Best snippet text/stars for each candidate product with reviews
        (host argmax over its reviews, CSR-indexed)."""
        out: Dict[str, dict] = {}
        if self._rev_order is None:
            return out
        emb = self.reviews.rev_emb
        q = np.asarray(qvec, dtype=np.float32).reshape(-1)
        for row in cand_rows:
            row = int(row)
            lo, hi = self._rev_offsets[row], self._rev_offsets[row + 1]
            if hi <= lo:
                continue
            ridx = self._rev_order[lo:hi]
            sims = emb[ridx] @ q
            j = int(np.argmax(sims))
            out[self.products.skus[row]] = self._snippet(int(ridx[j]), float(sims[j]))
        return out

    def _exact_snippets(self, qvec, cand_rows, cap: int):
        """The reference's truncated snippet scan: candidate products' review
        rows in original file order, cut at `cap` rows, cosine-scored on the
        host, per-product argmax. Returns ({product row: best score},
        {sku: snippet dict})."""
        m = self.reviews.n_reviews_total
        seg = np.asarray(self.reviews.rev_product[:m])
        parts = [self._rev_order[self._rev_offsets[int(r)]:self._rev_offsets[int(r) + 1]]
                 for r in cand_rows]
        if not parts:
            return {}, {}
        # each slice is ascending (a stable sort by product); one global sort
        # restores file order across products, the order the cap cuts in
        rows = np.sort(np.concatenate(parts))[: int(cap)]
        if rows.size == 0:
            return {}, {}
        q = np.asarray(qvec, dtype=np.float32).reshape(-1)
        sims = (self.reviews.rev_emb[rows] @ q).astype(np.float32)
        prods = seg[rows]
        # per-product argmax; ties keep the first row in file order
        o = np.lexsort((-sims, prods))
        firsts = np.ones(len(o), dtype=bool)
        firsts[1:] = prods[o[1:]] != prods[o[:-1]]
        scores: Dict[int, float] = {}
        snips: Dict[str, dict] = {}
        for w in o[firsts]:
            prow = int(prods[w])
            scores[prow] = float(sims[w])
            snips[self.products.skus[prow]] = self._snippet(int(rows[w]), float(sims[w]))
        return scores, snips
