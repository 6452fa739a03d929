"""Training-pair mining and batch iteration for contrastive fine-tuning.

A jax-free copy of `review_recommender_tpu/train/data.py` (numpy host
code): mine_pairs, mine_triples, iterate_batches (batch_order_only,
start_step) and train_biencoder. Queries are keyword samples from one
review of a product, positives the product's indexed text; every rng
call is made in the JAX order, which is part of the resume contract
(a trainer restored at step N skips N batches and sees the killed run's
stream). Deterministic in `seed`.
"""
from __future__ import annotations

import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from review_recommender_tpu_torch.train.optim import materialize

_WORD = re.compile(r"[a-z]{3,}")
_GENERIC = {
    "the", "and", "this", "that", "with", "for", "was", "are", "but",
    "have", "has", "had", "not", "very", "really", "just", "great", "good",
    "nice", "love", "like", "would", "recommend", "product", "item",
}


def mine_pairs(
    review_texts: Sequence[str],
    review_skus: Sequence[str],
    product_skus: Sequence[str],
    product_texts: Sequence[str],
    *,
    keywords_per_query: int = 4,
    max_pairs_per_product: int = 4,
    seed: int = 0,
) -> List[Tuple[str, str]]:
    """(query, positive) pairs: keyword queries from reviews, positives from
    the owning product's indexed text."""
    rng = np.random.default_rng(seed)
    by_sku = dict(zip([str(s) for s in product_skus], product_texts))
    counts: dict = {}
    pairs: List[Tuple[str, str]] = []
    order = rng.permutation(len(review_texts))
    for i in order:
        sku = str(review_skus[i])
        doc = by_sku.get(sku)
        if doc is None or counts.get(sku, 0) >= max_pairs_per_product:
            continue
        words = [w for w in _WORD.findall(str(review_texts[i]).lower())
                 if w not in _GENERIC]
        uniq: List[str] = []
        for w in words:
            if w not in uniq:
                uniq.append(w)
        if len(uniq) < keywords_per_query:
            continue
        pick = rng.choice(len(uniq), size=keywords_per_query, replace=False)
        query = " ".join(uniq[j] for j in sorted(pick))
        pairs.append((query, str(doc)))
        counts[sku] = counts.get(sku, 0) + 1
    return pairs


def mine_triples(
    pairs: Sequence[Tuple[str, str]],
    corpus_texts: Sequence[str],
    *,
    n_negatives: int = 3,
    hard_negative_fn=None,
    seed: int = 0,
) -> List[Tuple[str, str, float]]:
    """(query, doc, label) triples for pointwise cross-encoder training
    (train/cross_encoder.py).

    Each (query, positive) pair yields one label-1 triple plus
    `n_negatives` label-0 triples. Negatives come from `hard_negative_fn`
    when given — `fn(query, k) -> k candidate doc texts` (e.g. the engine's
    BM25/dense pool, which surfaces the confusable docs that carry the
    training signal) — with any candidate identical to the positive text
    skipped; remaining slots fill with uniform random corpus docs.
    Deterministic in `seed`.
    """
    rng = np.random.default_rng(seed)
    triples: List[Tuple[str, str, float]] = []
    n_corpus = len(corpus_texts)
    for query, pos in pairs:
        triples.append((query, pos, 1.0))
        negs: List[str] = []
        if hard_negative_fn is not None:
            for cand in hard_negative_fn(query, n_negatives + 1):
                if str(cand) != pos and len(negs) < n_negatives:
                    negs.append(str(cand))
        while len(negs) < n_negatives and n_corpus:
            cand = str(corpus_texts[int(rng.integers(n_corpus))])
            if cand != pos:
                negs.append(cand)
        triples.extend((query, d, 0.0) for d in negs)
    return triples


def iterate_batches(
    pairs: Sequence[Tuple[str, str]],
    tokenizer,
    batch_size: int,
    *,
    max_len: int = 128,
    seed: int = 0,
    epochs: int = 1,
    drop_remainder: bool = True,
    batch_order_only: bool = False,
    start_step: int = 0,
) -> Iterator[tuple]:
    """Shuffled token batches (q_ids, q_mask, d_ids, d_mask) for the trainer.
    Fixed pad width => one compiled train step.

    batch_order_only=True keeps each CONSECUTIVE batch_size block of `pairs`
    together and shuffles only the block order per epoch. With pairs
    pre-sorted so confusable items are adjacent (e.g. same product theme),
    every in-batch negative becomes a HARD negative — the InfoNCE loss then
    teaches document-level discrimination instead of the easy topic-level
    split that a globally shuffled batch asks for.

    start_step skips the first N batches WITHOUT tokenizing them (rng
    consumption is identical), so a trainer resumed at step N continues the
    exact batch stream of the killed run.
    """
    from review_recommender_tpu_torch.train.contrastive import make_pair_batch

    rng = np.random.default_rng(seed)
    n = len(pairs)
    n_blocks = n // batch_size if drop_remainder else -(-n // batch_size)
    produced = 0
    for _ in range(epochs):
        if batch_order_only:
            starts = [int(b) * batch_size
                      for b in rng.permutation(max(n_blocks, 0))]
        else:
            order = rng.permutation(n)
            starts = list(range(0, n, batch_size))
        for lo in starts:
            sel = (np.arange(lo, min(lo + batch_size, n))
                   if batch_order_only else order[lo : lo + batch_size])
            if drop_remainder and len(sel) < batch_size:
                break
            produced += 1
            if produced <= start_step:
                continue
            qs = [pairs[i][0] for i in sel]
            ds = [pairs[i][1] for i in sel]
            yield make_pair_batch(tokenizer, qs, ds, max_len=max_len,
                                  pad_to=max_len)


def train_biencoder(
    trainer,
    pairs: Sequence[Tuple[str, str]],
    tokenizer,
    *,
    batch_size: int = 32,
    epochs: int = 1,
    max_len: int = 128,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    log_every: int = 50,
    batch_order_only: bool = False,
) -> List[dict]:
    """Epoch loop over mined pairs. Resume-aware: the loop skips the first
    trainer.step batches (identical shuffle stream), so restoring a
    checkpoint continues where the killed run stopped. checkpoint_every > 0
    saves mid-run every N steps; a final save always happens when
    checkpoint_path is set. Returns the per-step metrics history."""
    import logging

    logger = logging.getLogger(__name__)
    history: List[dict] = []
    for batch in iterate_batches(pairs, tokenizer, batch_size,
                                 max_len=max_len, seed=seed, epochs=epochs,
                                 batch_order_only=batch_order_only,
                                 start_step=trainer.step):
        # async steps: metrics materialize only at log points / the end,
        # so training never pays a per-step device sync
        m = trainer.train_step_async(*batch)
        history.append(m)
        if log_every and m["step"] % log_every == 0:
            logger.info("step %d loss %.4f acc %.3f", m["step"],
                        float(m["loss"]), float(m["in_batch_acc"]))
        if (checkpoint_path is not None and checkpoint_every
                and m["step"] % checkpoint_every == 0):
            trainer.save(checkpoint_path)
    history = materialize(history)
    if checkpoint_path is not None:
        trainer.save(checkpoint_path)
    return history
