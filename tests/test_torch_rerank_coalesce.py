"""The port's coalesced live-rerank path (query_rerank_batched_pw,
engine/rerank_coalesce.py, with SearchEngine._rerank_a_impl) against the
JAX SearchEngine, and each rider against the port's own run_search.

Both engines get the same corpus (tests/test_microbatch.py's: make_corpus
at 48 products with reviews through the JAX package's
build_bundle_from_products) and the same cross-encoder, in four forms:
  pair   a deterministic fake with score_pairs (one coalesced call)
  hook   the same fake as a plain (query, texts) hook (one call per rider)
  tower  tiny f32 towers made by the JAX package and carried to the port
         by params_from_flax (CrossEncoder.score_pairs on both sides)
  none   no cross-encoder: the rerank lanes stay, with zero scores
Riders mix rerank_k values, 0 included, and carry their own weights. Row
ids must be equal; scores and the (B, k, 7) breakdown agree to 1e-5 with
the fakes and to 1e-4 with the towers (f32 forwards, sums in another
order). Each rider equals run_search with its knobs and qvec: ids equal,
finals within tests/test_microbatch.py's 1e-4 relative, 1e-5 absolute.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import CrossEncoder as JaxCrossEncoder
from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex, ReviewIndex
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from tests.test_engine_parity import make_corpus

DIM = 64
QUERIES = ["yellow cat socks", "wireless headphones", "kitchen knife", "running shoes",
           "usb charging cable long"]
RERANK_KS = [8, 0, 5, 20, 3]
WEIGHTS = [
    (0.4, 0.2, 0.25, 0.15, 0.0, 20.0, 5.0, 0.5),
    (0.5, 0.3, 0.0, 0.2, 0.0, 20.0, 8.0, 0.5),
    (0.3, 0.1, 0.5, 0.1, 0.0, 10.0, 1.0, 1.0),
    (0.4, 0.2, 0.25, 0.05, 0.1, 20.0, 5.0, 0.3),
    (0.0, 0.0, 1.0, 0.0, 0.0, 20.0, 1.0, 1.0),
]
FAKE_TOL = dict(rtol=1e-5, atol=1e-5)
TOWER_TOL = dict(rtol=1e-4, atol=1e-4)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
POOL, K = 48, 10


def _fake_ce(query, texts):
    """tests/test_microbatch.py's deterministic (query, text) scorer."""
    return np.asarray([(zlib.crc32((query + "\x00" + t[:50]).encode()) % 1000) / 1000.0
                       for t in texts], np.float32)


class _FakePairCE:
    def __call__(self, query, texts):
        return _fake_ce(query, texts)

    def score_pairs(self, queries, docs):
        return np.asarray([_fake_ce(q, [d])[0] for q, d in zip(queries, docs)], np.float32)


def _tower_ces():
    cfg = JaxBertConfig.tiny(vocab_size=512)
    jce = JaxCrossEncoder.random_init(cfg, tokenizer=JaxHashTokenizer(512), seed=4,
                                      dtype=jnp.float32)
    flat = jax.tree.map(np.asarray, jce.params)
    tce = CrossEncoder(BertConfig(**vars(cfg)), params_from_flax(flat, cfg, "crossencoder"),
                       HashTokenizer(512), device="cpu", dtype=torch.float32)
    return jce, tce


@pytest.fixture(scope="module")
def bundle():
    products, emb, reviews, remb = make_corpus(n=48, dim=DIM, seed=3)
    return build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                      pad_multiple=16, doc_terms_cap=64)


@pytest.fixture(scope="module", params=["pair", "hook", "tower", "none"])
def engines(request, bundle):
    kind = request.param
    if kind == "tower":
        jce, tce = _tower_ces()
    else:
        jce = tce = {"pair": _FakePairCE(), "hook": _fake_ce, "none": None}[kind]
    je = JaxEngine(bundle, emb_dtype="float32", gate_mode="device", cross_encoder=jce)
    je.featurizer._native = None  # the Python path, which the port copies
    je.featurizer._vocab_blob = None
    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    te = SearchEngine(IndexBundle(products=ProductIndex(**fields(ProductIndex, bundle.products)),
                                  reviews=ReviewIndex(**fields(ReviewIndex, bundle.reviews))),
                      device="cpu", emb_dtype="float32", gate_mode="device", cross_encoder=tce)
    return kind, je, te


def _qvecs(seed, b=len(QUERIES)):
    q = np.random.default_rng(seed).standard_normal((b, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _compare(got, ref, tol):
    (tr, ts, tbd), (jr, js, jbd) = got, ref
    assert tr.shape == ts.shape == (len(QUERIES), K) and tbd.shape == (len(QUERIES), K, 7)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **tol)
    np.testing.assert_allclose(tbd.numpy(), np.asarray(jbd), **tol)


@pytest.mark.parametrize("use_snips", [False, True])
def test_query_rerank_batched_pw_matches_jax(engines, use_snips):
    kind, je, te = engines
    qv = _qvecs(1)
    args = (qv, QUERIES, WEIGHTS, RERANK_KS, POOL, K)
    got = te.query_rerank_batched_pw(*args, use_snips=use_snips)
    _compare(got, je.query_rerank_batched_pw(*args, use_snips=use_snips),
             TOWER_TOL if kind == "tower" else FAKE_TOL)
    rerank = got[2][..., 2].numpy()  # the rerank lane of the breakdown
    assert not rerank[1].any()  # rerank_k = 0
    assert rerank[[0, 2, 3, 4]].any(axis=1).all() == (kind != "none")
    if use_snips:
        assert got[2][..., 4].any()  # the best lane of the rider with w_best on


def test_each_rider_matches_run_search(engines):
    _kind, _je, te = engines
    qv = _qvecs(2)
    rows, scores, _bd = te.query_rerank_batched_pw(qv, QUERIES, WEIGHTS, RERANK_KS, 150, K)
    names = ("w_dense", "w_bm25", "w_rerank", "w_prior", "w_best", "prior_C", "min_reviews",
             "gate_penalty")
    for i, q in enumerate(QUERIES):
        host, _snips, _dbg = te.run_search(q, qvec=qv[i], k=K, rerank_k=RERANK_KS[i],
                                           **dict(zip(names, WEIGHTS[i])))
        assert [r["sku"] for r in host] == [te.products.skus[int(j)] for j in rows[i]], q
        np.testing.assert_allclose(scores[i].numpy(), [r["_final"] for r in host], **RUN_TOL)


def test_reranking_disabled_keeps_the_lanes(engines, monkeypatch):
    """ENABLE_RERANKING=false: no cross-encoder call, the first rr_k lanes
    still set with zero scores (the reference's degraded behaviour)."""
    _kind, je, te = engines
    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "ENABLE_RERANKING", False)
    qv = _qvecs(3)
    args = (qv, QUERIES, WEIGHTS, RERANK_KS, POOL, K)
    got = te.query_rerank_batched_pw(*args)
    _compare(got, je.query_rerank_batched_pw(*args), FAKE_TOL)
    assert not got[2][..., 2].any()


def test_single_rider_rerank_k_past_the_pool(bundle):
    """A batch of one whose rerank_k (200) exceeds the pool and the corpus:
    rr_k is cut to the valid candidates, all scored in one score_pairs
    call."""
    seen = []

    class Spy(_FakePairCE):
        def score_pairs(self, queries, docs):
            seen.append(len(docs))
            return super().score_pairs(queries, docs)

    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    te = SearchEngine(IndexBundle(products=ProductIndex(**fields(ProductIndex, bundle.products))),
                      device="cpu", emb_dtype="float32", cross_encoder=Spy())
    je = JaxEngine(bundle, emb_dtype="float32", gate_mode="device", cross_encoder=_FakePairCE())
    je.featurizer._native = None
    je.featurizer._vocab_blob = None
    qv = _qvecs(4, b=1)
    args = (qv, QUERIES[:1], WEIGHTS[:1], [200], 200, K)
    tr, ts, tbd = te.query_rerank_batched_pw(*args)
    jr, js, jbd = je.query_rerank_batched_pw(*args)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FAKE_TOL)
    np.testing.assert_allclose(tbd.numpy(), np.asarray(jbd), **FAKE_TOL)
    assert seen == [bundle.products.n_docs]  # valid rows only, in one call
