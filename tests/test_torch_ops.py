"""Query-path ops of the port (review_recommender_tpu_torch) against the
JAX package, on the same numpy inputs.

Indices, pool membership and packed feature vectors must be exactly equal;
float scores agree to 1e-6 (f32 sums taken in another order differ in the
last bit: ~1e-7 relative at unit scale, ~1e-6 at BM25 scores of ~10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.engine import featurize as jfeat
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.index.build import compute_idf as j_compute_idf
from review_recommender_tpu.index.build import eager_bm25_scores as j_eager
from review_recommender_tpu.ops import bm25 as jbm25
from review_recommender_tpu.ops import dense as jdense
from review_recommender_tpu.ops import fusion as jfusion
from review_recommender_tpu.ops.gate import gate_factors_device as j_gate
from review_recommender_tpu.utils import numerics as jnum
from review_recommender_tpu.utils import text as jtext
from review_recommender_tpu_torch.engine import featurize as tfeat
from review_recommender_tpu_torch.index import build as tbuild
from review_recommender_tpu_torch.index.schema import ProductIndex
from review_recommender_tpu_torch.ops import bm25 as tbm25
from review_recommender_tpu_torch.ops import dense as tdense
from review_recommender_tpu_torch.ops import fusion as tfusion
from review_recommender_tpu_torch.ops.gate import gate_factors_device as t_gate
from review_recommender_tpu_torch.utils import numerics as tnum
from review_recommender_tpu_torch.utils import text as ttext
from tests.test_engine_parity import make_corpus

TOL = dict(rtol=1e-6, atol=1e-6)
T = torch.from_numpy


def _corpus(seed=0, n=300, d=32):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.arange(n) < n - 7  # a padding tail
    q = rng.standard_normal(d).astype(np.float32)
    return emb, valid, q / np.linalg.norm(q)


def test_dense_scores_and_topk():
    emb, valid, q = _corpus()
    ref = np.asarray(jdense.dense_scores(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(valid)))
    got = tdense.dense_scores(T(emb), T(q), T(valid)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.array_equal(np.isinf(got), ~valid)
    rs, ri = jdense.dense_topk(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(valid), 150)
    gs, gi = tdense.dense_topk(T(emb), T(q), T(valid), 150)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("stripes", [16, 37, 4096])
def test_striped_topk(stripes):
    emb, valid, q = _corpus(seed=1)
    sims = np.array(jdense.dense_scores(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(valid)))
    rs, ri = jdense.striped_topk(jnp.asarray(sims), 150, stripes)
    gs, gi = tdense.striped_topk(T(sims), 150, stripes)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))


@pytest.mark.parametrize("stripes", [16, 64, 300])
def test_striped_scan(stripes):
    """(s, G, D) slicing + the striped scan; 16 stripes over 300 rows gives
    19 rows per stripe, so pool membership differs from the exact pool."""
    emb, valid, q = _corpus(seed=2)
    je, jv = jdense.slice_corpus_for_striped(jnp.asarray(emb), jnp.asarray(valid), stripes)
    te, tv = tdense.slice_corpus_for_striped(T(emb), T(valid), stripes)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    pool = 150
    rs, ri = jdense.dense_striped_topk_scan(je, jv, jnp.asarray(q), pool)
    gs, gi = tdense.dense_striped_topk_scan(te, tv, T(q), pool)
    assert np.array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **TOL)
    if stripes == 16:
        exact = set(np.asarray(jdense.dense_topk(jnp.asarray(emb), jnp.asarray(q),
                                                 jnp.asarray(valid), 16)[1]))
        assert set(gi.numpy()) != exact


def _postings(seed=3, p=40, L=24, vocab=60):
    rng = np.random.default_rng(seed)
    terms = rng.integers(0, vocab, size=(p, L)).astype(np.int32)
    tf = np.where(terms > 0, rng.integers(1, 6, size=(p, L)), 0).astype(np.float32)
    dl = tf.sum(axis=1).astype(np.float32) + 1.0
    q_terms = np.array([3, 7, 7, 0, 19, 59, 0, 0], np.int32)
    q_idf = np.where(q_terms > 0, rng.uniform(0.1, 3.0, q_terms.shape), 0).astype(np.float32)
    return terms, tf, dl, q_terms, q_idf


def test_bm25_candidate_scores():
    terms, tf, dl, q_terms, q_idf = _postings()
    avgdl = np.float32(dl.mean())
    ref = jbm25.bm25_candidate_scores(jnp.asarray(terms), jnp.asarray(tf), jnp.asarray(dl),
                                      jnp.asarray(q_terms), jnp.asarray(q_idf), jnp.float32(avgdl))
    got = tbm25.bm25_candidate_scores(T(terms), T(tf), T(dl), T(q_terms), T(q_idf),
                                      torch.tensor(avgdl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert (got.numpy() > 0).any()


def test_bm25_eager_scores():
    terms, tf, dl, q_terms, _ = _postings(seed=4)
    df = np.bincount(terms[terms > 0], minlength=60).astype(np.int32)
    idf = j_compute_idf(df, terms.shape[0])
    np.testing.assert_array_equal(tbuild.compute_idf(df, terms.shape[0]), idf)
    bm = j_eager(terms, tf, dl, idf, float(dl.mean()))
    np.testing.assert_array_equal(tbuild.eager_bm25_scores(terms, tf, dl, idf, float(dl.mean())), bm)
    ref = jbm25.bm25_candidate_scores_eager(jnp.asarray(terms), jnp.asarray(bm), jnp.asarray(q_terms))
    got = tbm25.bm25_candidate_scores_eager(T(terms), T(bm), T(q_terms))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gate_factors_device():
    rng = np.random.default_rng(5)
    p, g, L = 30, len(jtext.GATE_PHRASES), 16
    bits = rng.random((p, g)) < 0.05
    terms = rng.integers(0, 40, size=(p, L)).astype(np.int32)
    gp = np.zeros((6, g), bool)
    gp[0, [1, 5]] = True
    gp[2, 9] = True
    gt = np.full((6, 8), -1, np.int32)
    gt[1, :3] = [4, 9, 33]
    gt[3, :1] = [12]
    gv = np.array([1, 1, 1, 1, 0, 0], bool)
    rf, rh = j_gate(jnp.asarray(bits), jnp.asarray(terms), jnp.asarray(gp), jnp.asarray(gt),
                    jnp.asarray(gv), jnp.float32(0.3))
    tf_, th = t_gate(T(bits), T(terms), T(gp), T(gt), T(gv), 0.3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(rh))
    np.testing.assert_allclose(tf_.numpy(), np.asarray(rf), **TOL)
    assert len(set(th.numpy().tolist())) > 1


def _fusion_inputs(seed=6, P=40):
    rng = np.random.default_rng(seed)
    valid = np.arange(P) < P - 5
    dense = np.sort(rng.uniform(0.1, 0.9, P).astype(np.float32))[::-1].copy()
    dense[~valid] = -np.inf
    bm25 = rng.uniform(0, 8, P).astype(np.float32)
    rr = np.zeros(P, np.float32)
    rr[:12] = rng.standard_normal(12)
    rr_mask = np.arange(P) < 12
    n = rng.integers(0, 300, P).astype(np.float32)
    stars = rng.uniform(1, 5, P).astype(np.float32)
    gate = rng.choice([1.0, 0.5, 0.25], P).astype(np.float32)
    return dense, bm25, rr, rr_mask, n, stars, gate, valid


@pytest.mark.parametrize("nan_lane", [False, True])
def test_fuse_candidates(nan_lane):
    """With one NaN avg_stars lane the Bayesian mean is NaN and the prior's
    minmax lane collapses to zeros on both sides."""
    dense, bm25, rr, rr_mask, n, stars, gate, valid = _fusion_inputs()
    if nan_lane:
        stars[3] = np.nan
    best = np.zeros_like(dense)
    knobs = (0.5, 0.3, 0.2, 0.2, 0.0, 20.0, 5, 0.5)
    jw = jfusion.FusionWeights.make(*knobs)
    tw = tfusion.FusionWeights.make(*knobs)
    ref = jfusion.fuse_candidates(*(jnp.asarray(x) for x in (dense, bm25, rr, rr_mask, best)),
                                  jnp.bool_(False), *(jnp.asarray(x) for x in (n, stars, gate, valid)), jw)
    got = tfusion.fuse_candidates(*(T(x) for x in (dense, bm25, rr, rr_mask, best)), False,
                                  *(T(x) for x in (n, stars, gate, valid)), tw)
    for name in jfusion.FusionResult._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    prior = got.prior.numpy()[valid]
    if nan_lane:  # only the 0.3 * volume term survives
        np.testing.assert_allclose(prior, 0.3 * np.log1p(n[valid]) / (np.log1p(n[valid]).max() + 1e-9),
                                   rtol=1e-5)
    for name in ("final", "dense", "prior"):
        assert np.isfinite(getattr(got, name).numpy()[valid]).all()


def test_final_topk_keeps_pool_order_on_ties():
    P = 64
    final = np.repeat(np.array([0.9, 0.5, 0.5, 0.2], np.float32), P // 4)
    np.random.default_rng(7).shuffle(final)
    final[-3:] = -np.inf
    res_j = jfusion.FusionResult(*(jnp.asarray(final) for _ in range(8)))
    res_t = tfusion.FusionResult(*(T(final) for _ in range(8)))
    for k in (10, 40, 64):
        rs, rp = jfusion.final_topk(res_j, k)
        gs, gp = tfusion.final_topk(res_t, k)
        assert np.array_equal(gp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))


def test_numerics():
    rng = np.random.default_rng(8)
    x = rng.standard_normal(50).astype(np.float32)
    valid = rng.random(50) < 0.7
    np.testing.assert_allclose(tnum.minmax_normalize_masked(T(x), T(valid)).numpy(),
                               np.asarray(jnum.minmax_normalize_masked(jnp.asarray(x), jnp.asarray(valid))),
                               **TOL)
    x[4] = np.nan
    valid[4] = True
    assert not tnum.minmax_normalize_masked(T(x), T(valid)).numpy().any()
    stars = rng.uniform(1, 5, 50).astype(np.float32)
    n = rng.integers(0, 200, 50).astype(np.float32)
    np.testing.assert_allclose(tnum.bayesian_prior(T(stars), T(n)).numpy(),
                               np.asarray(jnum.bayesian_prior(jnp.asarray(stars), jnp.asarray(n))), **TOL)
    np.testing.assert_allclose(tnum.trust_score_from_reviews(T(n)).numpy(),
                               np.asarray(jnum.trust_score_from_reviews(jnp.asarray(n))), **TOL)


def test_text_helpers_match():
    assert ttext.GATE_PHRASES == jtext.GATE_PHRASES
    for q in ("Yellow cat socks for the DOG", "noise-cancelling wireless headphones",
              "grey design keyboard with gold print", "a of the"):
        assert ttext.tokenize_query(q) == jtext.tokenize_query(q)
        assert ttext.build_gate_groups(q) == jtext.build_gate_groups(q)
        groups = jtext.build_gate_groups(q)
        for text in ("a yellow kitten sock", "navy blue bluetooth headset"):
            assert ttext.calculate_gate_factor(text, groups, 0.3) == \
                jtext.calculate_gate_factor(text, groups, 0.3)


@pytest.fixture(scope="module")
def featurizers():
    products, emb, _r, _re = make_corpus(n=40, dim=16, seed=9)
    jb = build_bundle_from_products(products, emb, pad_multiple=16, doc_terms_cap=64)
    jp = jb.products
    tp = ProductIndex(**{f: getattr(jp, f) for f in ProductIndex.__dataclass_fields__})
    jf = jfeat.QueryFeaturizer(jp, query_terms_cap=32)
    jf._native = None  # the JAX package's Python path, which the port copies
    jf._vocab_blob = None
    return jf, tfeat.QueryFeaturizer(tp, query_terms_cap=32)


@pytest.mark.parametrize("query", ["yellow cat socks", "wireless headphones noise cancelling",
                                   "stainless steel kitchen knife shoes", "zzz unknown", ""])
def test_featurize_pack_unpack(featurizers, query):
    jf, tf_ = featurizers
    jq, tq = jf.featurize(query), tf_.featurize(query)
    packed = tq.pack()
    np.testing.assert_array_equal(packed, jq.pack())
    assert packed.shape == (tfeat.packed_len(32, 64),) == (jfeat.packed_len(32, 64),)
    ref = jfeat.unpack_features(jnp.asarray(packed), 32, 64)
    got = tfeat.unpack_features(T(packed), 32, 64)
    for a, b, orig in zip(got, ref, (tq.q_terms, tq.q_idf, tq.group_phrase_mask,
                                     tq.group_term_ids, tq.group_valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), orig)
        assert a.numpy().dtype == np.asarray(b).dtype


def test_synth_index_matches_bench():
    """synth_product_index draws what bench.py:_synth_index draws."""
    import bench

    ref = bench._synth_index(700, 16, 500, 12, seed=3)
    got = tbuild.synth_product_index(700, 16, 500, 12, seed=3, text_chars=200)
    for f in ("emb", "n_reviews", "avg_stars", "doc_terms", "doc_tf", "doc_len",
              "gate_bits", "valid", "idf", "df"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.skus == ref.skus and got.avgdl == ref.avgdl and got.vocab == ref.vocab
    np.testing.assert_array_equal(
        got.doc_bm25, j_eager(ref.doc_terms, ref.doc_tf, ref.doc_len, ref.idf, ref.avgdl))
    got.validate()
    text = got.agg_texts[5]
    words = [f"t{t}" for t in got.doc_terms[5] if t > 0]
    assert len(text) == 200 and text.split()[: len(words)] == words
    assert got.agg_texts[5] == text and len(got.agg_texts) == 700
    with pytest.raises(IndexError):
        got.agg_texts[700]
