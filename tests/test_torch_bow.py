"""The port's bag-of-words models (review_recommender_tpu_torch/models/
bow.py) against the JAX package's: BowProjectionEncoder embeddings and
OverlapCrossScorer scores are host numpy in both, so they must be
bit-equal on the same texts, for each parameter setting."""
import numpy as np
import pytest

from review_recommender_tpu.models.bow import BowProjectionEncoder as JaxBow
from review_recommender_tpu.models.bow import OverlapCrossScorer as JaxOverlap
from review_recommender_tpu_torch.models.bow import BowProjectionEncoder, OverlapCrossScorer
from tests.torch_bundle_cases import EXTRA_TEXTS, corpus

TEXTS = EXTRA_TEXTS + ["", "   ", "socks socks socks yellow", "Ünïcödé ÇAFÉ 42"]


@pytest.mark.parametrize("dim,vocab,seed", [(384, 30522, 7), (64, 1000, 0), (16, 50, 3)])
def test_bow_encoder_matches_jax(dim, vocab, seed):
    products, _q, _e = corpus()
    texts = TEXTS + [p["agg_text"] for p in products]
    got = BowProjectionEncoder(dim=dim, vocab_size=vocab, seed=seed)
    want = JaxBow(dim=dim, vocab_size=vocab, seed=seed)
    a, b = got.encode(texts), want.encode(texts)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(got(texts[0]), want(texts[0]))
    assert np.array_equal(a[len(EXTRA_TEXTS)], np.eye(dim, dtype=np.float32)[0])  # empty text


@pytest.mark.parametrize("params", [
    {}, dict(idf_power=1.0, cap=1.0, power=1.0), dict(cap=0.5, power=3.0),
    dict(doc_prefix_chars=20)], ids=["default", "raw", "capped", "short_prefix"])
@pytest.mark.parametrize("with_idf", [True, False], ids=["idf", "no_idf"])
def test_overlap_scorer_matches_jax(params, with_idf):
    products, queries, _e = corpus()
    docs = TEXTS + [p["agg_text"] for p in products]
    idf = None
    if with_idf:
        words = sorted({w for d in docs for w in d.lower().split()})
        idf = {w: 0.5 + (i % 7) * 0.75 for i, w in enumerate(words)}
    got, want = OverlapCrossScorer(idf=idf, **params), JaxOverlap(idf=idf, **params)
    for q in [qq["query"] for qq in queries] + ["yellow socks", "", "unseenword cat"]:
        a, b = got(q, docs), want(q, docs)
        assert a.dtype == b.dtype and np.array_equal(a, b), q
