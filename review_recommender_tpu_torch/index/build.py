"""Index build helpers: BM25 statistics, rerank tokens, the review index
and the synthetic corpus.

`compute_idf`, `eager_bm25_scores`, `attach_rerank_tokens` and
`build_review_index` copy `review_recommender_tpu/index/build.py` (that
module imports the jax-loading schema). `synth_product_index` is a numpy
port of `bench.py:_synth_index`: the same random draws in the same order,
so one seed gives the same corpus in both packages, plus eager BM25
contributions and deterministic texts for the rerank lane.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from review_recommender_tpu_torch.index.schema import ProductIndex, ReviewIndex, pad_rows
from review_recommender_tpu_torch.utils.text import GATE_PHRASES

BM25_K1 = 1.5
BM25_B = 0.75
BM25_EPSILON = 0.25


def compute_idf(df: np.ndarray, n_docs: int, epsilon: float = BM25_EPSILON) -> np.ndarray:
    """rank_bm25 BM25Okapi idf: ln((N-df+0.5)/(df+0.5)), negatives floored at
    epsilon * mean(raw idf). Index 0 (PAD) stays 0."""
    idf = np.zeros_like(df, dtype=np.float64)
    real = df > 0
    idf[real] = np.log(n_docs - df[real] + 0.5) - np.log(df[real] + 0.5)
    if real.any():
        avg = idf[real].mean()
        idf[real & (idf < 0)] = epsilon * avg
    return idf.astype(np.float32)


def eager_bm25_scores(
    doc_terms: np.ndarray, doc_tf: np.ndarray, doc_len: np.ndarray,
    idf: np.ndarray, avgdl: float,
) -> np.ndarray:
    """Per-(term, doc) Okapi contribution idf*tf*(k1+1)/(tf + k1*(1-b+b*dl/
    avgdl)), so query scoring is a masked sum. PAD lanes get 0."""
    norm = BM25_K1 * (1.0 - BM25_B + BM25_B * doc_len / max(avgdl, 1e-9))
    contrib = (idf[doc_terms] * doc_tf * (BM25_K1 + 1.0)
               / (doc_tf + norm[:, None] + 1e-30))
    return np.where(doc_tf > 0, contrib, 0.0).astype(np.float32)


def _l2_normalize_np(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, eps)


def attach_rerank_tokens(index: ProductIndex, tokenizer, max_tokens: int = 254,
                         text_prefix_chars: int = 2000) -> ProductIndex:
    """Pre-tokenize each agg_text with the model tokenizer into padded
    doc_tokens (N_pad, max_tokens) int32 and doc_token_len (N_pad,) int32,
    for the on-device rerank of engine/search.py:query_e2e. Texts are cut
    to the rerank window (text_prefix_chars, the host path's 2000) before
    tokenizing; padding is the tokenizer's pad_id."""
    n_pad = index.n_padded
    toks = np.full((n_pad, max_tokens), getattr(tokenizer, "pad_id", 0), np.int32)
    lens = np.zeros(n_pad, np.int32)
    for i in range(index.n_docs):
        ids = tokenizer.token_ids(str(index.agg_texts[i])[:text_prefix_chars])[:max_tokens]
        toks[i, : len(ids)] = ids
        lens[i] = len(ids)
    index.doc_tokens = toks
    index.doc_token_len = lens
    return index


def build_review_index(rev_skus: Sequence[str], rev_texts: Sequence[str],
                       rev_stars: Sequence[float], rev_embeddings: np.ndarray,
                       product_skus: Sequence[str], *, pad_multiple: int = 256) -> ReviewIndex:
    """Per-review unit embeddings (f32, padded to pad_multiple rows) with
    their product rows as segment ids. A review whose sku is not a product
    maps to segment len(product_skus), the discard bucket. A list or tuple
    of texts is copied as str; any other sequence (texts built on access)
    is kept as given. Stars: None or NaN -> NaN."""
    m = len(rev_texts)
    if rev_embeddings.shape[0] != m:
        raise ValueError(f"{rev_embeddings.shape[0]} review embeddings for {m} texts")
    sku_to_row = {str(s): i for i, s in enumerate(product_skus)}
    n_products = len(product_skus)
    m_pad = pad_rows(m, pad_multiple)
    emb = np.zeros((m_pad, rev_embeddings.shape[1]), dtype=np.float32)
    emb[:m] = _l2_normalize_np(np.asarray(rev_embeddings, dtype=np.float32))
    seg = np.full(m_pad, n_products, dtype=np.int32)
    seg[:m] = [sku_to_row.get(str(s), n_products) for s in rev_skus]
    if isinstance(rev_stars, np.ndarray):
        stars = rev_stars.astype(np.float32)
    else:
        stars = np.asarray([np.nan if s is None or (isinstance(s, float) and math.isnan(s))
                            else float(s) for s in rev_stars], dtype=np.float32)
    return ReviewIndex(
        rev_emb=emb, rev_product=seg, rev_valid=np.arange(m_pad) < m,
        rev_texts=([str(t) for t in rev_texts] if isinstance(rev_texts, (list, tuple))
                   else rev_texts),
        rev_stars=stars, n_reviews_total=m,
    )


class SynthTexts(Sequence[str]):
    """Read-only texts of a synthetic corpus, built on access: item i is
    row i's term words ("t{id}") repeated up to `text_chars` characters.
    Nothing corpus-sized is held beyond the term array itself."""

    def __init__(self, doc_terms: np.ndarray, n_docs: int, text_chars: int):
        self._terms = doc_terms
        self._n = int(n_docs)
        self._chars = int(text_chars)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> str:
        i = int(i)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(f"text index {i} out of range for {self._n} docs")
        words = " ".join(f"t{t}" for t in self._terms[i] if t > 0)
        if not words or self._chars <= 0:
            return words
        reps = -(-self._chars // (len(words) + 1))
        return " ".join([words] * reps)[: self._chars]


def synth_product_index(n_docs: int, dim: int, vocab_size: int,
                        terms_per_doc: int, seed: int = 0,
                        text_chars: int = 0) -> ProductIndex:
    """Synthetic ProductIndex with Zipf term statistics (bench.py:_synth_index
    draw for draw), with eager BM25 attached and SynthTexts as agg_texts."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_docs, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    raw = rng.zipf(1.3, size=(n_docs, terms_per_doc)).astype(np.int64)
    terms = (raw % vocab_size + 1).astype(np.int32)
    srt = np.sort(terms, axis=1)
    dup = np.concatenate(
        [np.zeros((n_docs, 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1
    )
    terms = np.where(dup, 0, srt).astype(np.int32)
    tf = np.where(terms > 0, rng.integers(1, 6, size=terms.shape), 0).astype(np.float32)
    doc_len = tf.sum(axis=1).astype(np.float32)

    df = np.zeros(vocab_size + 1, np.int32)
    ids, counts = np.unique(terms[terms > 0], return_counts=True)
    df[ids] = counts
    idf = compute_idf(df, n_docs)

    n_pad = pad_rows(n_docs, 256)
    pad2 = lambda a: np.pad(a, [(0, n_pad - n_docs)] + [(0, 0)] * (a.ndim - 1))
    n_reviews = rng.integers(0, 400, n_docs).astype(np.float32)
    avg_stars = rng.uniform(1, 5, n_docs).astype(np.float32)

    vocab = {f"t{i}": i for i in range(1, vocab_size + 1)}
    doc_terms, doc_tf, dl = pad2(terms), pad2(tf), pad2(doc_len)
    avgdl = float(doc_len.mean())
    return ProductIndex(
        emb=pad2(emb), n_reviews=pad2(n_reviews), avg_stars=pad2(avg_stars),
        doc_terms=doc_terms, doc_tf=doc_tf, doc_len=dl,
        gate_bits=np.zeros((n_pad, len(GATE_PHRASES)), bool),
        valid=np.arange(n_pad) < n_docs,
        skus=[f"S{i}" for i in range(n_docs)],
        agg_texts=SynthTexts(doc_terms, n_docs, text_chars),
        vocab=vocab, idf=idf, df=df, avgdl=avgdl, n_docs=n_docs,
        doc_bm25=eager_bm25_scores(doc_terms, doc_tf, dl, idf, avgdl),
    )
