"""The port's snippet lane (review_recommender_tpu_torch) against the JAX
SearchEngine: the segment max of ops/segment.py, build_review_index, the
host recoveries of engine/snippets.py, run_search(use_snips=True) at every
max_scan mode, the four fused forms and the coalesced rerank's stage A.

Both engines get the same corpus (tests/test_engine_parity.make_corpus
through the JAX package's build_bundle_from_products, its numpy fields
handed to the port's dataclasses), f32 embeddings and the device gate. The
reviews are edited so that every edge of the lane shows: products with no
review (an empty segment, -inf), reviews of unknown skus (the discard
bucket), and a product with two equal best reviews (a tie, which keeps the
first row in file order). The JAX featurizer takes its Python path, which
the port copies. Row ids and snippet dicts must be equal; signals agree to
1e-5 (f32 sums in another order leave ~1e-6 after the minmax
normalisations); segment maxima to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.index.build import build_review_index as j_build_review_index
from review_recommender_tpu.ops import segment as jseg
from review_recommender_tpu.ops.fusion import FusionWeights as JaxWeights
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine import search as tsearch
from review_recommender_tpu_torch.engine.hooks import SNIPPET_NONE
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.build import build_review_index
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex, ReviewIndex
from review_recommender_tpu_torch.ops import segment as tseg
from review_recommender_tpu_torch.ops.fusion import FusionWeights
from tests.test_engine_parity import QUERIES, make_corpus

TOL = dict(rtol=1e-5, atol=1e-5)
SIGNALS = ("_dense", "_bm25", "_rerank", "_prior", "_best", "_trust", "_gate", "_final")
# reference-style knobs with the best-snippet weight on
SNIP_KNOBS = {
    "hybrid_best": dict(k=20, rerank_k=0, w_dense=0.5, w_bm25=0.2, w_rerank=0.0, w_prior=0.1,
                        w_best=0.2, prior_C=20.0, min_reviews=5, gate_penalty=0.3),
    "best_only": dict(k=10, rerank_k=0, w_dense=0.0, w_bm25=0.0, w_rerank=0.0, w_prior=0.0,
                      w_best=1.0, prior_C=20.0, min_reviews=1, gate_penalty=1.0),
}
ORDER = ("w_dense", "w_bm25", "w_rerank", "w_prior", "w_best", "prior_C", "min_reviews",
         "gate_penalty")
N_DOCS, DIM = 96, 64


def _edited_corpus(seed=4):
    """make_corpus with the lane's edges: products 0-9 lose their reviews,
    six reviews point at an unknown sku, and product 12's second review is
    a copy of its first (a tie wherever one of them is its best)."""
    products, emb, reviews, remb = make_corpus(n=N_DOCS, dim=DIM, seed=seed)
    keep = [i for i, r in enumerate(reviews) if int(r["sku"][3:]) >= 10]
    reviews = [reviews[i] for i in keep]
    remb = remb[keep]
    for j in range(6):
        reviews[5 * j + 3] = dict(reviews[5 * j + 3], sku=f"NOPE{j}")
    first = [i for i, r in enumerate(reviews) if r["sku"] == "SKU0012"][:2]
    remb[first[1]] = remb[first[0]]
    return products, emb, reviews, remb


def _port_bundle(jb):
    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    return IndexBundle(products=ProductIndex(**fields(ProductIndex, jb.products)),
                       reviews=ReviewIndex(**fields(ReviewIndex, jb.reviews)))


def _engine_pair(jb, **kw):
    je = JaxEngine(jb, emb_dtype="float32", gate_mode="device", dense_pool="exact", **kw)
    je.featurizer._native = None  # the Python path, which the port copies
    je.featurizer._vocab_blob = None
    te = SearchEngine(_port_bundle(jb), device="cpu", emb_dtype="float32", gate_mode="device",
                      dense_pool="exact", **kw)
    return je, te


@pytest.fixture(scope="module")
def corpus():
    return _edited_corpus()


@pytest.fixture(scope="module")
def engines(corpus):
    products, emb, reviews, remb = corpus
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=16, doc_terms_cap=64)
    return _engine_pair(jb)


def _qvecs(seed, b=4, d=DIM):
    q = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _weights(knobs):
    vals = [knobs[k] for k in ORDER]
    return JaxWeights.make(*vals), FusionWeights.make(*vals)


# ---------------------------------------------------------------- the index
def test_build_review_index_matches_jax(corpus):
    products, _emb, reviews, remb = corpus
    args = ([r["sku"] for r in reviews], [r["text"] for r in reviews],
            [r["stars"] if i % 7 else None for i, r in enumerate(reviews)], remb,
            [p["sku"] for p in products])
    j = j_build_review_index(*args, pad_multiple=16)
    t = build_review_index(*args, pad_multiple=16)
    np.testing.assert_array_equal(t.rev_emb, j.rev_emb)
    np.testing.assert_array_equal(t.rev_product, j.rev_product)
    np.testing.assert_array_equal(t.rev_valid, j.rev_valid)
    np.testing.assert_array_equal(t.rev_stars, j.rev_stars)  # NaN where None
    assert list(t.rev_texts) == list(j.rev_texts)
    assert t.n_reviews_total == j.n_reviews_total and t.m_padded == j.m_padded
    assert int((t.rev_product == N_DOCS).sum()) == 6 + t.m_padded - t.n_reviews_total
    assert np.isnan(t.rev_stars).sum() == len(range(0, len(reviews), 7))


def test_review_device_arrays(engines):
    _je, te = engines
    r = te.bundle.reviews
    dev = r.device_arrays(torch.device("cpu"), torch.bfloat16)
    assert dev["rev_emb"].dtype == torch.bfloat16 and dev["rev_emb"].shape == r.rev_emb.shape
    assert dev["rev_product"].dtype == torch.int32 and dev["rev_valid"].dtype == torch.bool
    np.testing.assert_array_equal(dev["rev_product"].numpy(), r.rev_product)
    fp = te.bundle.device_footprint(torch.bfloat16)
    assert fp["rev_emb"] == dev["rev_emb"].numel() * 2
    assert set(te.rev_arrays) == {"rev_emb", "rev_product", "rev_valid"}


# ---------------------------------------------------------- the segment max
def _segment_case(name, seed=0, m=40, d=16, n=7):
    """(rev_emb, rev_product, rev_valid, qvec) for one edge case."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((m, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    prod = rng.integers(0, n, m).astype(np.int32)
    valid = np.ones(m, bool)
    q = rng.standard_normal(d).astype(np.float32)
    if name == "empty_segment":  # product 3 has no review, product 5 only invalid ones
        prod[prod == 3] = 4
        valid[prod == 5] = False
    elif name == "discard_bucket":  # reviews of no product, some of them the best
        prod[::3] = n
        emb[0] = q / np.linalg.norm(q)
        valid[-4:] = False
    elif name == "all_negative":  # every review scores below 0
        q = -emb.mean(axis=0)
        emb = np.where((emb @ q)[:, None] > 0, -emb, emb).astype(np.float32)
    return emb, prod, valid, q


@pytest.mark.parametrize("name", ["random", "empty_segment", "discard_bucket", "all_negative"])
def test_best_review_scores_matches_jax(name):
    emb, prod, valid, q = _segment_case(name)
    n = 7
    ref = np.asarray(jseg.best_review_scores(jnp.asarray(emb), jnp.asarray(prod),
                                             jnp.asarray(valid), jnp.asarray(q), n))
    got = tseg.best_review_scores(torch.from_numpy(emb), torch.from_numpy(prod),
                                  torch.from_numpy(valid), torch.from_numpy(q), n).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)
    assert (got[~fin] <= SNIPPET_NONE).all()  # dropped by the > SNIPPET_NONE filters
    if name == "empty_segment":
        assert not fin[3] and not fin[5] and fin.sum() == n - 2
    if name == "all_negative":
        assert (got[fin] < 0).all() and fin.any()
    # the batched form: each row as its own query
    qs = np.stack([q, -q, 0.5 * q])
    gotb = tseg.best_review_scores(torch.from_numpy(emb), torch.from_numpy(prod),
                                   torch.from_numpy(valid), torch.from_numpy(qs), n).numpy()
    assert gotb.shape == (3, n)
    for i in range(3):
        one = tseg.best_review_scores(torch.from_numpy(emb), torch.from_numpy(prod),
                                      torch.from_numpy(valid), torch.from_numpy(qs[i]), n)
        np.testing.assert_allclose(gotb[i], one.numpy(), rtol=1e-6, atol=1e-6)


def test_best_review_scores_bf16_corpus_keeps_f32_sums():
    """A bf16 review table multiplies into f32, as the JAX dot with
    preferred_element_type=f32 does: equal to the f32 sums of the bf16
    values, not to a bf16-rounded result."""
    emb, prod, valid, q = _segment_case("random", seed=3, m=64, d=48)
    e16 = torch.from_numpy(emb).to(torch.bfloat16)
    got = tseg.best_review_scores(e16, torch.from_numpy(prod), torch.from_numpy(valid),
                                  torch.from_numpy(q), 7)
    assert got.dtype == torch.float32
    ref = jseg.best_review_scores(jnp.asarray(emb, jnp.bfloat16), jnp.asarray(prod),
                                  jnp.asarray(valid), jnp.asarray(q), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_best_review_argmax_host_matches_jax():
    emb, prod, valid, q = _segment_case("random", seed=5)
    sims = emb @ q
    for row in range(8):  # row 7 has no review
        assert tseg.best_review_argmax_host(sims, prod, row) == \
            jseg.best_review_argmax_host(sims, prod, row)
    assert tseg.best_review_argmax_host(sims, prod, 7) is None


# ---------------------------------------------------------- host recoveries
def test_rev_csr_matches_jax(engines):
    je, te = engines
    np.testing.assert_array_equal(te._rev_order, je._rev_order)
    np.testing.assert_array_equal(te._rev_offsets, je._rev_offsets)


def test_snippet_texts_match_jax(engines):
    je, te = engines
    rows = np.arange(N_DOCS)
    for q in _qvecs(8):
        got, ref = te._snippet_texts(q, rows), je._snippet_texts(q, rows)
        assert got == ref
        assert len(got) == N_DOCS - 10  # products 0-9 have no review
        assert all(len(s["text"]) <= 600 for s in got.values())


@pytest.mark.parametrize("cap", [1, 5, 13, 40, 10**6])
def test_exact_snippets_match_jax(engines, cap):
    """Truncation at `cap` review rows in original file order, over
    candidates given in another order, ties included."""
    je, te = engines
    rows = np.random.default_rng(cap % 97).permutation(N_DOCS)[:40]
    rows = np.concatenate([[12], rows[rows != 12]])  # the product with the tie
    for q in _qvecs(9, b=3):
        (gs, gn), (js, jn) = te._exact_snippets(q, rows, cap), je._exact_snippets(q, rows, cap)
        assert gs == js and gn == jn
    # the tie: both copies score alike; the first in file order wins
    r = te.reviews
    first = np.nonzero(r.rev_product[: r.n_reviews_total] == 12)[0][:2]
    q = r.rev_emb[first[0]]
    _s, snips = te._exact_snippets(q, np.array([12]), 10**6)
    assert snips["SKU0012"]["text"] == r.rev_texts[first[0]][:600]


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("knobs", list(SNIP_KNOBS))
@pytest.mark.parametrize("max_scan", [0, -1, 5])
def test_run_search_snippets_match_jax(engines, max_scan, knobs):
    je, te = engines
    for i, query in enumerate(QUERIES[:3]):
        qv = _qvecs(20 + i, b=1)[0]
        df, jsnips, jdbg = je.run_search(query, use_snips=True, max_scan=max_scan, qvec=qv,
                                         **SNIP_KNOBS[knobs])
        rows, snips, tdbg = te.run_search(query, use_snips=True, max_scan=max_scan, qvec=qv,
                                          **SNIP_KNOBS[knobs])
        assert [r["sku"] for r in rows] == list(df["sku"]), query
        for col in SIGNALS:
            np.testing.assert_allclose([r[col] for r in rows], df[col].to_numpy(),
                                       err_msg=f"{query} {col}", **TOL)
        assert snips.keys() == jsnips.keys()
        for sku, s in snips.items():
            assert (s["text"], s["stars"]) == (jsnips[sku]["text"], jsnips[sku]["stars"])
            np.testing.assert_allclose(s["score"], jsnips[sku]["score"], rtol=1e-6, atol=1e-6)
        assert snips
        if max_scan != 5:  # 5 review rows in file order may miss every result
            assert any(r["_best"] > 0 for r in rows)
        assert not tdbg.get("fused") and not jdbg.get("fused")
        for key in ("tokens", "groups", "pool", "gate_mode", "bm25_active", "n_candidates"):
            assert tdbg[key] == jdbg[key], key
    if max_scan == 5:  # 5 review rows in file order cover few candidates
        assert len(snips) <= 5


def _fused_forms(engine, knobs, qv, queries):
    w = _weights(knobs)[1 if isinstance(engine, SearchEngine) else 0]
    wl = [tuple(knobs[k] for k in ORDER)] * len(queries)
    return {
        "query_fused": lambda: engine.query_fused(qv[0], queries[0], w, 48, 10, use_snips=True),
        "query_fused1": lambda: engine.query_fused1(qv[1], queries[1], w, 48, 10,
                                                    use_snips=True),
        "query_fused_batched": lambda: engine.query_fused_batched(qv, queries, w, 48, 10,
                                                                  use_snips=True),
        "query_fused_batched_pw": lambda: engine.query_fused_batched_pw(qv, queries, wl, 48, 10,
                                                                        use_snips=True),
    }


@pytest.mark.parametrize("knobs", list(SNIP_KNOBS))
def test_fused_forms_with_snippets_match_jax(engines, knobs):
    je, te = engines
    qv, queries = _qvecs(30), QUERIES[:4]
    jforms = _fused_forms(je, SNIP_KNOBS[knobs], qv, queries)
    for name, tcall in _fused_forms(te, SNIP_KNOBS[knobs], qv, queries).items():
        got, ref = tcall(), jforms[name]()
        if name == "query_fused1":  # one (k, 9) buffer: row ids in column 0
            got, ref = (got[:, 0], got), (np.asarray(ref)[:, 0], ref)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), err_msg=name)
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)
    _r, _s, bd = te.query_fused_batched_pw(
        qv, queries, [tuple(SNIP_KNOBS[knobs][k] for k in ORDER)] * 4, 48, 10, use_snips=True)
    assert (bd[..., 4] > 0).any(dim=-1).all()  # the best lane is live in every row


def test_fused_forms_with_snippets_match_run_search(engines):
    """query_fused1 with snippets and run_search's split path agree: the
    device lane and the host filter of _split_host_hooks are one lane."""
    _je, te = engines
    knobs = SNIP_KNOBS["hybrid_best"]
    qv = _qvecs(31, b=1)[0]
    rows, _snips, _dbg = te.run_search(QUERIES[1], use_snips=True, qvec=qv, **knobs)
    out = te.query_fused1(qv, QUERIES[1], _weights(knobs)[1], 150, knobs["k"],
                          use_snips=True).numpy()
    assert [r["sku"] for r in rows] == [te.products.skus[int(i)] for i in out[:, 0]]
    np.testing.assert_allclose([r["_final"] for r in rows], out[:, 1], **TOL)


def test_rerank_stage_a_with_snippets_matches_jax(engines):
    je, te = engines
    qv = _qvecs(32)
    packed = te.featurizer.featurize_packed_batch(QUERIES[:4])
    wmat = np.asarray([[0.4, 0.2, 0.2, 0.1, 0.3, 20.0, 5.0, 0.5]] * 4, np.float32)
    wmat[1, 7] = 0.25
    qp = np.concatenate([qv, packed, wmat], axis=1)
    jst, jbest, jhas, jgate = je._rerank_stage_a(qp, True, 48)
    tst, tbest, thas, tgate = te._rerank_stage_a(te._upload(qp), True, 48)
    np.testing.assert_array_equal(tst["idx"].numpy(), np.asarray(jst["idx"]))
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), **TOL)
    np.testing.assert_array_equal(thas.numpy()[:, 0], np.asarray(jhas))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate), **TOL)
    for key in ("dense_raw", "bm25_raw", "cand_valid", "n_reviews", "avg_stars"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), err_msg=key, **TOL)
    _st, best0, has0, _g = te._rerank_stage_a(te._upload(qp), False, 48)
    assert has0 is False and not best0.any()


def test_all_negative_sims_keep_the_lane():
    """Every review scores below 0: best_raw is nonzero, so the lane counts
    as computed (!= 0, not > 0) and the fusion minmaxes the negative sims,
    in run_search's split path and in the fused forms alike."""
    products, emb, reviews, remb = make_corpus(n=40, dim=DIM, seed=6)
    v = np.random.default_rng(6).standard_normal(DIM).astype(np.float32)
    v /= np.linalg.norm(v)
    remb = v[None, :] + 0.5 * remb / np.linalg.norm(remb, axis=1, keepdims=True)
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=16, doc_terms_cap=64)
    je, te = _engine_pair(jb)
    qv = -v
    knobs = SNIP_KNOBS["hybrid_best"]
    df, jsnips, _ = je.run_search(QUERIES[0], use_snips=True, qvec=qv, **knobs)
    rows, snips, _ = te.run_search(QUERIES[0], use_snips=True, qvec=qv, **knobs)
    assert [r["sku"] for r in rows] == list(df["sku"])
    np.testing.assert_allclose([r["_best"] for r in rows], df["_best"].to_numpy(), **TOL)
    assert snips.keys() == jsnips.keys() and all(s["score"] < 0 for s in snips.values())
    assert any(r["_best"] > 0 for r in rows)
    jw, tw = _weights(knobs)
    jr, js = je.query_fused(qv, QUERIES[0], jw, 48, 10, use_snips=True)
    tr, ts = te.query_fused(qv, QUERIES[0], tw, 48, 10, use_snips=True)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_snippets_off_read_no_review(engines, monkeypatch):
    """use_snips=False (the default path of run_search and the batched
    forms) never runs the review pass: the same zeros and False."""
    _je, te = engines

    def boom(*_a, **_k):
        raise AssertionError("the review pass ran with use_snips off")

    monkeypatch.setattr(tsearch, "best_review_scores", boom)
    qv = _qvecs(33)
    rows, snips, dbg = te.run_search(QUERIES[0], qvec=qv[0], rerank_k=0)
    assert snips == {} and dbg["fused"] and not any(r["_best"] for r in rows)
    te.run_search(QUERIES[0], qvec=qv[0], rerank_k=0, max_scan=5)  # split path, no snippets
    w = FusionWeights.make()
    te.query_fused_batched(qv, QUERIES[:4], w, 48, 10)
    te.query_fused_batched_pw(qv, QUERIES[:4], [tuple(w)] * 4, 48, 10)
    te.query_fused(qv[0], QUERIES[0], w, 48, 10)
    te.query_fused1(qv[0], QUERIES[0], w, 48, 10)
    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "ENABLE_SNIPPETS", False)
    te.query_fused_batched(qv, QUERIES[:4], w, 48, 10, use_snips=True)
    assert te.run_search(QUERIES[0], qvec=qv[0], use_snips=True)[1] == {}
