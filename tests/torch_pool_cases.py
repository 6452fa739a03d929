"""Engine pairs (JAX SearchEngine, the port's) over one corpus for the pool
and corpus-dtype tests (tests/test_torch_int8.py, tests/test_torch_ivf.py),
and the checks both files run on them.

The corpus is tests/test_engine_parity.make_corpus at 320 x 64 through the
JAX builder with rerank tokens (hash ids, width 48), its numpy fields
handed to the port; both engines get the same tiny f32 towers (flax
parameters carried over by params_from_flax, attached for query_e2e) and
see 160 stripes, so the striped pool is approximate at this size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import attach_rerank_tokens, build_bundle_from_products
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import BiEncoder as JaxBiEncoder
from review_recommender_tpu.models.encoder import CrossEncoder as JaxCrossEncoder
from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from review_recommender_tpu.ops.fusion import FusionWeights as JaxWeights
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex, ReviewIndex
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.ops.fusion import FusionWeights
from tests.test_engine_parity import QUERIES, make_corpus

TOL = dict(rtol=1e-5, atol=1e-5)
TOWER_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_e2e.py's and _rerank_coalesce.py's
SIGNALS = ("_dense", "_bm25", "_rerank", "_prior", "_best", "_trust", "_gate", "_final")
RUN_KNOBS = dict(w_dense=0.5, w_bm25=0.2, w_rerank=0.2, w_prior=0.1, w_best=0.0,
                 prior_C=20.0, min_reviews=5, gate_penalty=0.5)
KNOB_ORDER = ("w_dense", "w_bm25", "w_rerank", "w_prior", "w_best", "prior_C", "min_reviews",
              "gate_penalty")


def port_bundle(jb):
    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    return IndexBundle(products=ProductIndex(**fields(ProductIndex, jb.products)),
                       reviews=ReviewIndex(**fields(ReviewIndex, jb.reviews)))


def make_engines(variants, knobs=None):
    """{name: (jax engine, port engine)} for each name -> (emb_dtype,
    dense_pool) of `variants`, with `knobs` patched on both configs while
    the engines are built."""
    products, emb, reviews, remb = make_corpus(n=320, dim=64, seed=0)
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=16, doc_terms_cap=64)
    cfg = JaxBertConfig.tiny()
    attach_rerank_tokens(jb.products, JaxHashTokenizer(cfg.vocab_size), max_tokens=48)
    jbe = JaxBiEncoder.random_init(cfg, seed=1, dtype=jnp.float32)
    jce = JaxCrossEncoder.random_init(cfg, seed=2, dtype=jnp.float32)
    tcfg = BertConfig(**vars(cfg))
    tok = HashTokenizer(cfg.vocab_size)
    flat = lambda m: jax.tree.map(np.asarray, m.params)
    tbe = BiEncoder(tcfg, params_from_flax(flat(jbe), cfg, "biencoder"), tok,
                    device="cpu", dtype=torch.float32)
    tce = CrossEncoder(tcfg, params_from_flax(flat(jce), cfg, "crossencoder"), tok,
                       device="cpu", dtype=torch.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, port_config):
            mp.setattr(c, "DENSE_POOL_STRIPES", 160)
            for name, value in (knobs or {}).items():
                mp.setattr(c, name, value)
        for name, (dtype, pool) in variants.items():
            je = JaxEngine(jb, emb_dtype=dtype, query_encoder=jbe, cross_encoder=jce,
                           dense_pool=pool)
            te = SearchEngine(port_bundle(jb), device="cpu", emb_dtype=dtype,
                              query_encoder=tbe, cross_encoder=tce, dense_pool=pool)
            assert je.dense_pool == te.dense_pool == pool
            je.attach_models(jbe, jce)
            te.attach_models(tbe, tce)
            out[name] = (je, te)
    return out


def check_run_search(je, te, rerank_k):
    """run_search on three queries: the same SKU order, every signal column
    within 1e-5, the same debug keys."""
    for query in QUERIES[:3]:
        df, _snips, jdbg = je.run_search(query, k=20, rerank_k=rerank_k, use_snips=False,
                                         **RUN_KNOBS)
        rows, _s, tdbg = te.run_search(query, k=20, rerank_k=rerank_k, use_snips=False,
                                       **RUN_KNOBS)
        ref = df.to_dict(orient="records")
        assert [r["sku"] for r in rows] == [r["sku"] for r in ref], query
        for col in SIGNALS:
            np.testing.assert_allclose([r[col] for r in rows], [r[col] for r in ref],
                                       err_msg=f"{query} {col}", **TOL)
        for key in ("tokens", "groups", "pool", "gate_mode", "bm25_active"):
            assert tdbg[key] == jdbg[key], key
    if rerank_k:
        assert any(r["_rerank"] != 0 for r in rows)


def check_fused_forms(je, te):
    """query_fused_batched (B = 3), query_fused and query_fused1: the same
    row ids, scores within 1e-5; each batched row equal to its single
    query."""
    jw = JaxWeights.make(*(RUN_KNOBS[k] for k in KNOB_ORDER))
    tw = FusionWeights.make(*(RUN_KNOBS[k] for k in KNOB_ORDER))
    qs = QUERIES[:3]
    qv = np.stack([te.encode_query(q) for q in qs])
    jr, js = je.query_fused_batched(qv, qs, jw, 150, 10)
    tr, ts = te.query_fused_batched(qv, qs, tw, 150, 10)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    for b in range(len(qs)):
        r1, s1 = te.query_fused(qv[b], qs[b], tw, 150, 10)
        np.testing.assert_array_equal(r1.numpy(), tr[b].numpy())
        np.testing.assert_allclose(s1.numpy(), ts[b].numpy(), **TOL)
    j1 = np.asarray(je.query_fused1(qv[1], qs[1], jw, 150, 10))
    t1 = te.query_fused1(qv[1], qs[1], tw, 150, 10).numpy()
    np.testing.assert_array_equal(t1[:, 0], j1[:, 0])
    np.testing.assert_allclose(t1, j1, **TOL)


def check_search_dense(je, te):
    """search_dense at k 10 and 150: equal ids, scores within 1e-5."""
    for q in QUERIES[:3]:
        qv = te.encode_query(q)
        for k in (10, 150):
            ji, js = je.search_dense(qv, k)
            ti, ts = te.search_dense(qv, k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def check_e2e_and_coalesced(je, te):
    """query_e2e at rr_k 0 and 8, and query_rerank_batched_pw with three
    riders (rerank_k 8, 0, 20): the same row ids, scores within 1e-4 (f32
    towers in both)."""
    jw = JaxWeights.make(*(RUN_KNOBS[k] for k in KNOB_ORDER))
    tw = FusionWeights.make(*(RUN_KNOBS[k] for k in KNOB_ORDER))
    for q in QUERIES[:2]:
        for rr_k in (0, 8):
            jr, js = je.query_e2e(q, jw, 150, 10, rr_k=rr_k)
            tr, ts = te.query_e2e(q, tw, 150, 10, rr_k=rr_k)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOWER_TOL)
    qs = QUERIES[:3]
    qv = np.stack([te.encode_query(q) for q in qs])
    knobs = [tuple(RUN_KNOBS[k] for k in KNOB_ORDER)] * 3
    args = (qv, qs, knobs, [8, 0, 20], 64, 10)
    (tr, ts, tbd), (jr, js, jbd) = te.query_rerank_batched_pw(*args), \
        je.query_rerank_batched_pw(*args)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOWER_TOL)
    np.testing.assert_allclose(tbd.numpy(), np.asarray(jbd), **TOWER_TOL)
    assert tbd[0, :, 2].numpy().any() and not tbd[1, :, 2].numpy().any()
