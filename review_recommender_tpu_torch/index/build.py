"""Offline index build: products -> ProductIndex / IndexBundle, BM25
statistics, rerank tokens, the review index and the synthetic corpus.

`build_product_index`, `derive_doc_terms_cap`, `compute_idf`,
`eager_bm25_scores`, `attach_eager_bm25`, `attach_rerank_tokens`,
`build_review_index` and `build_bundle_from_products` copy
`review_recommender_tpu/index/build.py` (that module imports the
jax-loading schema): one corpus gives bit-equal arrays, vocabulary and
statistics in both packages. Tokenization is the index tokenizer
("simple_en_v1"); each document's unique terms are packed by descending
tf (stable), so a doc_terms_cap truncation drops its lowest-tf terms, and
the gate bitset records which GATE_PHRASES occur in the first
GATE_TEXT_PREFIX characters of the lowered text. The postings come from
the C++ pass of native/tokenizer.cc unless the caller asks for
tokenizer="python"; the JAX builder's quiet switch to Python when its
library is missing is not copied. Pre-tokenized documents (`token_lists`,
a reference deployment's BM25 pickle) take the Python pass over their
tokens, as in JAX.

`synth_product_index` is a numpy port of `bench.py:_synth_index`: the
same random draws in the same order, so one seed gives the same corpus in
both packages, plus eager BM25 contributions and deterministic texts for
the rerank lane.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from review_recommender_tpu_torch.index.schema import (
    PAD_TERM_ID,
    IndexBundle,
    ProductIndex,
    ReviewIndex,
    pad_rows,
)
from review_recommender_tpu_torch.utils.text import GATE_PHRASES, tokenize_document

logger = logging.getLogger(__name__)

BM25_K1 = 1.5
BM25_B = 0.75
BM25_EPSILON = 0.25
GATE_TEXT_PREFIX = 6000  # characters of agg_text the online gate inspects
# doc_terms_cap "auto" (or 0) builds at this ceiling, then trims to the P99
AUTO_CAP_CEILING = 512


def derive_doc_terms_cap(unique_counts: np.ndarray, floor: int = 32,
                         ceiling: int = AUTO_CAP_CEILING) -> int:
    """The postings width for a corpus: the P99 of its per-document unique
    term counts, rounded up to a multiple of 8, clamped to [floor, ceiling]."""
    p99 = int(np.percentile(np.asarray(unique_counts), 99))
    cap = ((max(p99, 1) + 7) // 8) * 8
    return int(min(max(cap, floor), ceiling))


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


def attach_eager_bm25(index: ProductIndex) -> ProductIndex:
    """Store the eager BM25 contributions in the index (the device then
    takes doc_bm25 in place of doc_tf and doc_len)."""
    index.doc_bm25 = eager_bm25_scores(index.doc_terms, index.doc_tf, index.doc_len,
                                       index.idf, index.avgdl)
    return index


def _postings_python(token_lists: Iterable[Sequence[str]], n: int, L: int):
    """build_postings_native's result from the token lists of n documents."""
    vocab: Dict[str, int] = {}
    df_counts: List[int] = [0]  # index 0 = PAD
    terms = np.zeros((n, L), np.int32)
    tf = np.zeros((n, L), np.float32)
    doc_lens = np.zeros(n, np.float32)
    truncated = 0
    for i, toks in enumerate(token_lists):
        doc_lens[i] = len(toks)
        freqs: Dict[str, int] = {}
        for t in toks:
            freqs[t] = freqs.get(t, 0) + 1
        ids = np.empty(len(freqs), np.int32)
        tfs = np.empty(len(freqs), np.float32)
        for j, (term, cnt) in enumerate(freqs.items()):
            tid = vocab.get(term)
            if tid is None:
                tid = vocab[term] = len(vocab) + 1
                df_counts.append(0)
            df_counts[tid] += 1
            ids[j], tfs[j] = tid, cnt
        order = np.argsort(-tfs, kind="stable")
        if len(order) > L:
            truncated += 1
            order = order[:L]
        terms[i, : len(order)] = ids[order]
        tf[i, : len(order)] = tfs[order]
    return terms, tf, doc_lens, np.asarray(df_counts, np.int32), vocab, truncated


def build_product_index(
    skus: Sequence[str],
    agg_texts: Sequence[str],
    n_reviews: Sequence[float],
    avg_stars: Sequence[float],
    embeddings: np.ndarray,
    *,
    doc_terms_cap=512,
    pad_multiple: int = 256,
    last_ts: Optional[Sequence] = None,
    tokenizer: str = "native",
    token_lists: Optional[Sequence[Sequence[str]]] = None,
) -> ProductIndex:
    """The ProductIndex of host columns: embeddings L2-normalised and every
    array padded to a multiple of `pad_multiple` rows. doc_terms_cap 0,
    None or "auto" builds at AUTO_CAP_CEILING, then trims the postings to
    derive_doc_terms_cap of the corpus (df and idf count every term).
    tokenizer: "native" (C++, the default) or "python"; `token_lists`, one
    token list per document, takes the place of the tokenizer."""
    n = len(skus)
    if embeddings.shape[0] != n or not (len(agg_texts) == len(n_reviews) == len(avg_stars) == n):
        raise ValueError(f"columns of unequal length: {n} skus, {len(agg_texts)} texts, "
                         f"{len(n_reviews)} n_reviews, {len(avg_stars)} avg_stars, "
                         f"{embeddings.shape[0]} embeddings")
    if tokenizer not in ("native", "python"):
        raise ValueError(f"tokenizer must be 'native' or 'python', got {tokenizer!r}")
    auto_cap = doc_terms_cap in ("auto", 0, None)
    L = AUTO_CAP_CEILING if auto_cap else int(doc_terms_cap)
    n_pad = pad_rows(n, pad_multiple)

    if token_lists is not None:
        if len(token_lists) != n:
            raise ValueError(f"{len(token_lists)} token lists for {n} documents")
        nt, ntf, doc_lens, df, vocab, truncated = _postings_python(token_lists, n, L)
    elif tokenizer == "native":
        from review_recommender_tpu_torch.native import build_postings_native

        nt, ntf, doc_lens, df, vocab, truncated = build_postings_native(agg_texts, L)
    else:
        nt, ntf, doc_lens, df, vocab, truncated = _postings_python(
            (tokenize_document(str(t), native=False) for t in agg_texts), n, L)
    terms = np.full((n_pad, L), PAD_TERM_ID, np.int32)
    tf = np.zeros((n_pad, L), np.float32)
    terms[:n] = nt
    tf[:n] = ntf

    if auto_cap and n:
        unique_counts = (terms[:n] != PAD_TERM_ID).sum(axis=1)
        L_auto = derive_doc_terms_cap(unique_counts)
        if L_auto < L:
            truncated = int((unique_counts > L_auto).sum())
            logger.info("doc_terms_cap=auto: L=%d (was %d), %d/%d docs truncated",
                        L_auto, L, truncated, n)
            terms = np.ascontiguousarray(terms[:, :L_auto])
            tf = np.ascontiguousarray(tf[:, :L_auto])
            L = L_auto
    if truncated:
        logger.warning("doc_terms_cap=%d truncated %d/%d docs (their dropped terms score 0 "
                       "in BM25)", L, truncated, n)

    emb = np.zeros((n_pad, embeddings.shape[1]), np.float32)
    emb[:n] = _l2_normalize_np(np.asarray(embeddings, dtype=np.float32))
    nrev = np.zeros(n_pad, np.float32)
    nrev[:n] = np.nan_to_num(np.asarray(n_reviews, dtype=np.float32), nan=0.0)
    stars = np.zeros(n_pad, np.float32)
    stars[:n] = np.asarray(avg_stars, dtype=np.float32)
    dl = np.zeros(n_pad, np.float32)
    dl[:n] = doc_lens

    gate_bits = np.zeros((n_pad, len(GATE_PHRASES)), bool)
    for i, text in enumerate(agg_texts):
        tl = str(text)[:GATE_TEXT_PREFIX].lower()
        gate_bits[i] = [phrase in tl for phrase in GATE_PHRASES]

    idx = ProductIndex(
        emb=emb, n_reviews=nrev, avg_stars=stars, doc_terms=terms, doc_tf=tf, doc_len=dl,
        gate_bits=gate_bits, valid=np.arange(n_pad) < n,
        skus=[str(s) for s in skus], agg_texts=[str(t) for t in agg_texts],
        vocab=vocab, idf=compute_idf(df, n), df=df,
        avgdl=float(np.asarray(doc_lens).mean()) if n else 0.0, n_docs=n,
        last_ts=([None if t is None else str(t) for t in last_ts]
                 if last_ts is not None else None),
    )
    idx.validate()
    return idx


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


def build_bundle_from_products(
    products: Iterable[dict],
    embeddings: np.ndarray,
    reviews: Optional[Iterable[dict]] = None,
    review_embeddings: Optional[np.ndarray] = None,
    **kwargs,
) -> IndexBundle:
    """A bundle from row dicts: products with sku / agg_text / n_reviews /
    avg_stars, reviews with sku / text / stars. kwargs go to
    build_product_index."""
    rows = list(products)
    pidx = build_product_index(
        [r["sku"] for r in rows],
        [r.get("agg_text", "") for r in rows],
        [r.get("n_reviews", 0.0) for r in rows],
        [r.get("avg_stars", float("nan")) for r in rows],
        embeddings, **kwargs,
    )
    ridx = None
    if reviews is not None:
        if review_embeddings is None:
            raise ValueError("reviews given without review_embeddings")
        rrows = list(reviews)
        ridx = build_review_index(
            [r["sku"] for r in rrows], [r.get("text", "") for r in rrows],
            [r.get("stars", float("nan")) for r in rrows], review_embeddings, pidx.skus,
        )
    return IndexBundle(products=pidx, reviews=ridx)


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
