"""Deterministic text scorers on the host: a random-projection bag-of-words
encoder and an idf-weighted overlap cross-scorer.

A copy of `review_recommender_tpu/models/bow.py` (host numpy in both
packages, so one text gives bit-equal embeddings and scores). They stand
in for trained towers where there are none: the quality table's bow lane
encodes its corpus and queries with BowProjectionEncoder and reranks with
OverlapCrossScorer. Both plug into SearchEngine's hooks (`query_encoder`,
`cross_encoder`) as the transformer towers of models/encoder.py do, and
neither touches the device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from review_recommender_tpu_torch.models.tokenizer import HashTokenizer


class BowProjectionEncoder:
    """text -> L2-normalised sum of per-token random unit vectors, each
    weighted by the square root of the token's count. Deterministic in
    (vocab_size, dim, seed); an empty text maps to the first basis vector."""

    def __init__(self, dim: int = 384, vocab_size: int = 30522, seed: int = 0,
                 tokenizer=None):
        self.dim = dim
        self.tokenizer = tokenizer or HashTokenizer(vocab_size)
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((vocab_size, dim)).astype(np.float32)
        self._proj /= np.linalg.norm(self._proj, axis=1, keepdims=True)

    def encode(self, texts: Sequence[str], batch_size: int = 0) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            ids = self.tokenizer.token_ids(str(t))
            if not ids:
                out[i, 0] = 1.0
                continue
            uniq, counts = np.unique(ids, return_counts=True)
            vec = (np.sqrt(counts.astype(np.float32))[:, None] * self._proj[uniq]).sum(axis=0)
            out[i] = vec / max(np.linalg.norm(vec), 1e-12)
        return out

    def __call__(self, text: str) -> np.ndarray:
        return self.encode([text])[0]


class OverlapCrossScorer:
    """(query, doc) relevance as idf-weighted coverage of the query's terms:
    coverage = sum(w(t) for t in q & d) / sum(w(t) for t in q), with w(t)
    = idf(t) ** idf_power (1 without an idf map; a term outside the map
    takes the median weight), and score = min(coverage / cap, 1) ** power.
    The defaults (idf_power 2, cap 1, power 2) are the JAX package's."""

    def __init__(self, tokenizer=None, doc_prefix_chars: int = 2000,
                 idf=None, cap: float = 1.0, power: float = 2.0,
                 idf_power: float = 2.0):
        self.tokenizer = tokenizer or HashTokenizer()
        self.doc_prefix_chars = doc_prefix_chars
        self.idf = dict(idf) if idf else None
        self.cap = float(cap)
        self.power = float(power)
        self.idf_power = float(idf_power)
        vals = sorted(self.idf.values()) if self.idf else [1.0]
        self._default_w = float(vals[len(vals) // 2])

    def _w(self, token: str) -> float:
        if self.idf is None:
            return 1.0
        return float(self.idf.get(token, self._default_w)) ** self.idf_power

    def score_pairs(self, queries: Sequence[str], docs: Sequence[str]) -> np.ndarray:
        out = np.zeros(len(docs), np.float32)
        for i, (q, d) in enumerate(zip(queries, docs)):
            qs = set(self.tokenizer.tokenize(str(q)))
            ds = set(self.tokenizer.tokenize(str(d)[: self.doc_prefix_chars]))
            if not qs or not ds:
                continue
            denom = sum(self._w(t) for t in qs)
            if denom > 0:
                out[i] = sum(self._w(t) for t in qs & ds) / denom
        return np.minimum(out / self.cap, 1.0) ** self.power

    def __call__(self, query: str, texts: Sequence[str]) -> np.ndarray:
        return self.score_pairs([query] * len(texts), texts)
