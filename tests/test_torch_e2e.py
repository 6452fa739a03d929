"""The port's on-device rerank lane (review_recommender_tpu_torch:
attach_rerank_tokens, build_pairs_device, encode_query_ids_device,
attach_models, query_e2e) against the JAX SearchEngine, and against the
port's own run_search with the same towers.

The setup is tests/test_e2e.py's: a 24-product corpus (make_corpus, texts
cut to 120 characters so that nothing truncates on the host path), a
shared HashTokenizer(512), tiny f32 towers made by the JAX package and
carried to the port by params_from_flax, doc tokens of width 48 (cut to
the cross-encoder's 64 positions: 31 document tokens beside a 30-token
query). Pair ids, masks and token types must equal the JAX ones as
integers; query_e2e row ids must be equal and scores agree to 1e-4 (two
towers in f32, sums in another order); against run_search, whose towers
see the same pairs bucketed to other shapes, the JAX test's bound holds:
5e-4 relative, 5e-5 absolute, a differing id only at a near tie (1e-3).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.engine.search import build_pairs_device as j_build_pairs
from review_recommender_tpu.engine.search import encode_query_ids_device as j_encode_ids
from review_recommender_tpu.index.build import attach_rerank_tokens as j_attach
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import BiEncoder as JaxBiEncoder
from review_recommender_tpu.models.encoder import CrossEncoder as JaxCrossEncoder
from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from review_recommender_tpu.ops.fusion import FusionWeights as JaxWeights
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine.query_forms import E2E_QUERY_TOKENS
from review_recommender_tpu_torch.engine.search import (
    SearchEngine,
    build_pairs_device,
    encode_query_ids_device,
)
from review_recommender_tpu_torch.index.build import attach_rerank_tokens
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.ops import attention
from review_recommender_tpu_torch.ops.fusion import FusionWeights
from tests.test_engine_parity import make_corpus

KNOBS = (0.5, 0.2, 0.3, 0.1, 0.0, 20.0, 5, 0.5)
JW, TW = JaxWeights.make(*KNOBS), FusionWeights.make(*KNOBS)
RUN_KNOBS = dict(w_dense=0.5, w_bm25=0.2, w_rerank=0.3, w_prior=0.1, w_best=0.0, prior_C=20.0,
                 min_reviews=5, gate_penalty=0.5)
QUERIES = ["yellow cat socks", "wireless bluetooth headphones", "stainless steel kitchen knife"]
E2E_TOL = dict(rtol=1e-4, atol=1e-4)
HOST_TOL = dict(rtol=5e-4, atol=5e-5)


def _towers():
    cfg = JaxBertConfig.tiny(vocab_size=512)
    jtok, ttok = JaxHashTokenizer(vocab_size=512), HashTokenizer(vocab_size=512)
    jbe = JaxBiEncoder.random_init(cfg, tokenizer=jtok, seed=0, dtype=jnp.float32)
    jce = JaxCrossEncoder.random_init(cfg, tokenizer=jtok, seed=1, dtype=jnp.float32)
    tcfg = BertConfig(**vars(cfg))
    flat = lambda m: jax.tree.map(np.asarray, m.params)
    tbe = BiEncoder(tcfg, params_from_flax(flat(jbe), cfg, "biencoder"), ttok, device="cpu",
                    dtype=torch.float32)
    tce = CrossEncoder(tcfg, params_from_flax(flat(jce), cfg, "crossencoder"), ttok,
                       device="cpu", dtype=torch.float32)
    return (jbe, jce, jtok), (tbe, tce, ttok)


def _port_products(jp):
    return ProductIndex(**{f: getattr(jp, f) for f in ProductIndex.__dataclass_fields__})


@pytest.fixture(scope="module")
def setup():
    (jbe, jce, jtok), (tbe, tce, ttok) = _towers()
    products, _emb, _r, _re = make_corpus(n=24, dim=64, seed=17)
    texts = [p["agg_text"][:120] for p in products]  # short: no truncation
    for p, t in zip(products, texts):
        p["agg_text"] = t
    emb = jbe.encode(texts)
    jb = build_bundle_from_products(products, emb, pad_multiple=8, doc_terms_cap=64)
    tp = _port_products(jb.products)  # before the JAX tokens are attached
    j_attach(jb.products, jtok, max_tokens=48)
    attach_rerank_tokens(tp, ttok, max_tokens=48)
    out = {"towers": (jbe, jce, tbe, tce), "jb": jb, "tp": tp}
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, port_config):  # striped: 24 rows over 8 stripes
            mp.setattr(c, "DENSE_POOL_STRIPES", 8)
        for pool in ("exact", "striped"):
            je = JaxEngine(jb, emb_dtype="float32", gate_mode="device", dense_pool=pool)
            je.featurizer._native = None  # the Python path, which the port copies
            je.featurizer._vocab_blob = None
            je.attach_models(jbe, jce)
            te = SearchEngine(IndexBundle(products=tp), device="cpu", emb_dtype="float32",
                              gate_mode="device", dense_pool=pool)
            te.attach_models(tbe, tce)
            out[pool] = (je, te)
    return out


# ----------------------------------------------------------- pair assembly
LQ, SD = 6, 5


@pytest.mark.parametrize("q_len", [0, 1, LQ])
def test_build_pairs_matches_jax(q_len):
    rng = np.random.default_rng(q_len)
    q_raw = rng.integers(5, 500, LQ).astype(np.int32)  # padding past q_len is not zero
    d_tok = rng.integers(5, 500, (4, SD)).astype(np.int32)
    d_len = np.array([0, 2, SD, SD], np.int32)  # 0 and Sd at the ends
    ref = j_build_pairs(2, 3, jnp.asarray(q_raw), jnp.int32(q_len), jnp.asarray(d_tok),
                        jnp.asarray(d_len))
    got = build_pairs_device(2, 3, torch.from_numpy(q_raw), q_len, torch.from_numpy(d_tok),
                             torch.from_numpy(d_len))
    for name, g, r in zip(("ids", "mask", "types"), got, ref):
        assert g.dtype == torch.int32 and g.shape == (4, LQ + SD + 3), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    ids, mask, types = (g.numpy() for g in got)
    for r, dl in enumerate(d_len):  # [CLS] q [SEP] d [SEP], no gaps
        total = q_len + dl + 3
        want = [2, *q_raw[:q_len], 3, *d_tok[r, :dl], 3]
        assert list(ids[r, :total]) == want and not ids[r, total:].any()
        assert mask[r].sum() == total and types[r].sum() == dl + 1


@pytest.mark.parametrize("q_len", [0, 1, LQ])
def test_encode_query_ids_matches_jax(q_len):
    q_raw = np.arange(7, 7 + LQ, dtype=np.int32)
    ref = j_encode_ids(2, 3, jnp.asarray(q_raw), jnp.int32(q_len))
    got = encode_query_ids_device(2, 3, torch.from_numpy(q_raw), q_len)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (LQ + 2,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_attach_rerank_tokens_matches_jax(setup):
    jp, tp = setup["jb"].products, setup["tp"]
    np.testing.assert_array_equal(tp.doc_tokens, jp.doc_tokens)
    np.testing.assert_array_equal(tp.doc_token_len, jp.doc_token_len)
    assert tp.doc_tokens.shape == (tp.n_padded, 48) and tp.doc_tokens.dtype == np.int32
    assert (tp.doc_token_len[tp.n_docs:] == 0).all() and (tp.doc_token_len[:tp.n_docs] > 0).all()
    tp.validate()


def test_attach_rerank_tokens_pad_id_and_text_cut():
    """A tokenizer whose pad_id is not 0 fills the padding with it, and each
    text is cut to text_prefix_chars before tokenizing, as in JAX."""
    class PadOne:
        pad_id = 1

        def __init__(self, base):
            self.base = base

        def token_ids(self, text):
            return self.base.token_ids(text)

    products, emb, _r, _re = make_corpus(n=12, dim=16, seed=3)
    jb = build_bundle_from_products(products, emb, pad_multiple=8, doc_terms_cap=32)
    tp = _port_products(jb.products)
    j_attach(jb.products, PadOne(JaxHashTokenizer(512)), max_tokens=12, text_prefix_chars=30)
    attach_rerank_tokens(tp, PadOne(HashTokenizer(512)), max_tokens=12, text_prefix_chars=30)
    np.testing.assert_array_equal(tp.doc_tokens, jb.products.doc_tokens)
    np.testing.assert_array_equal(tp.doc_token_len, jb.products.doc_token_len)
    assert (tp.doc_tokens[tp.n_docs:] == 1).all() and tp.doc_token_len.max() < 12


def test_validate_checks_doc_tokens(setup):
    tp = setup["tp"]
    with pytest.raises(ValueError, match="doc_token_len"):
        dataclasses.replace(tp, doc_token_len=tp.doc_token_len[:-1]).validate()
    with pytest.raises(ValueError, match="come together"):
        dataclasses.replace(tp, doc_token_len=None).validate()


# ------------------------------------------------------------- query_e2e
@pytest.mark.parametrize("rr_k", [0, 6])
@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_query_e2e_matches_jax(setup, pool, rr_k):
    je, te = setup[pool]
    for query in QUERIES:
        jr, js = je.query_e2e(query, JW, pool=16, k=8, rr_k=rr_k)
        tr, ts = te.query_e2e(query, TW, pool=16, k=8, rr_k=rr_k)
        assert tr.shape == ts.shape == (8,) and ts.dtype == torch.float32
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=query)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), err_msg=query, **E2E_TOL)
    assert attention.mha_kernel_launches == 0


@pytest.mark.parametrize("query", QUERIES)
def test_query_e2e_matches_own_run_search(setup, query):
    """The device pairs equal the host path's tokenized pairs: run_search
    with the same towers (host cross-encoder over the texts) gives the same
    rows at the same pool."""
    _je, te = setup["exact"]
    rows, scores = te.query_e2e(query, TW, pool=te.products.n_padded, k=8, rr_k=6)
    got, fin = [te.products.skus[int(i)] for i in rows], scores.numpy()
    host, _snips, dbg = te.run_search(query, k=8, rerank_k=6, **RUN_KNOBS)
    assert not dbg.get("fused") and dbg["pool"] == te.products.n_padded
    want = np.array([r["_final"] for r in host])
    np.testing.assert_allclose(fin, want, **HOST_TOL)
    for i, (a, b) in enumerate(zip(got, (r["sku"] for r in host))):
        if a != b:  # near-tie rank swaps only
            assert abs(fin[i] - want[i]) < 1e-3
    assert any(r["_rerank"] > 0 for r in host)


def test_query_e2e_without_rerank_matches_query_fused(setup):
    _je, te = setup["exact"]
    _jbe, _jce, tbe, _tce = setup["towers"]
    query = "comfortable running shoes"
    rd, sd = te.query_e2e(query, TW, pool=24, k=8, rr_k=0)
    rf, sf = te.query_fused(tbe(query), query, TW, pool=24, k=8)
    np.testing.assert_allclose(sd.numpy(), sf.numpy(), rtol=1e-4, atol=1e-5)


def test_query_e2e_reranking_disabled(setup, monkeypatch):
    """ENABLE_RERANKING=false makes rr_k 0, as in JAX."""
    je, te = setup["exact"]
    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "ENABLE_RERANKING", False)
    tr, ts = te.query_e2e(QUERIES[0], TW, pool=16, k=8, rr_k=6)
    jr, js = je.query_e2e(QUERIES[0], JW, pool=16, k=8, rr_k=6)
    r0, s0 = te.query_e2e(QUERIES[0], TW, pool=16, k=8, rr_k=0)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **E2E_TOL)
    np.testing.assert_array_equal(tr.numpy(), r0.numpy())
    np.testing.assert_array_equal(ts.numpy(), s0.numpy())


def test_query_e2e_truncates_long_queries(setup):
    """Queries past E2E_QUERY_TOKENS tokens keep the first 30, as in JAX."""
    je, te = setup["exact"]
    query = " ".join(f"word{i}" for i in range(45))
    assert len(te._be.tokenizer.token_ids(query)) > E2E_QUERY_TOKENS
    jr, js = je.query_e2e(query, JW, pool=16, k=8, rr_k=6)
    tr, ts = te.query_e2e(query, TW, pool=16, k=8, rr_k=6)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **E2E_TOL)


# ------------------------------------------------------------------ errors
def test_query_e2e_requires_attach_models(setup):
    te = SearchEngine(IndexBundle(products=setup["tp"]), device="cpu", emb_dtype="float32")
    with pytest.raises(RuntimeError, match="attach_models"):
        te.query_e2e("x", TW, pool=8, k=4)


def test_rerank_requires_doc_tokens(setup):
    _jbe, _jce, tbe, tce = setup["towers"]
    tp = dataclasses.replace(setup["tp"], doc_tokens=None, doc_token_len=None)
    te = SearchEngine(IndexBundle(products=tp), device="cpu", emb_dtype="float32")
    te.attach_models(tbe, tce)
    assert te.query_encoder is tbe and te.cross_encoder is tce
    with pytest.raises(RuntimeError, match="doc_tokens"):
        te.query_e2e("x", TW, pool=8, k=4, rr_k=4)
    rows, _scores = te.query_e2e("x", TW, pool=8, k=4, rr_k=0)  # no rerank: no tokens needed
    assert rows.shape == (4,)


def test_attach_models_refuses_a_tower_on_another_device(setup):
    _jbe, _jce, tbe, tce = setup["towers"]
    te = SearchEngine(IndexBundle(products=setup["tp"]), device="cpu", emb_dtype="float32")
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="engine's device"):
        te.attach_models(elsewhere, tce)
    with pytest.raises(ValueError, match="crossencoder"):
        te.attach_models(tbe, elsewhere)
    assert te._be is None and te.query_encoder is None
