"""The port's batched fused query (review_recommender_tpu_torch) against the
JAX SearchEngine, and the batch axis of the shared ops against jax.vmap.

Both engines get the same corpus (tests/test_engine_parity.make_corpus
through the JAX package's build_bundle_from_products, its numpy fields
handed to the port's dataclasses), f32 embeddings, the device gate, and
both pool modes; 320 documents over 160 stripes make the striped pool's
membership differ from the exact pool's. The JAX featurizer takes its
Python path, which the port copies. Row ids must be equal; scores and
signal columns agree to 1e-5 (f32 sums in another order leave ~1e-6 after
the minmax normalisations).

A batched product may sum in another order than a single one (on the card,
cuBLAS may pick another algorithm for (B, D) than for (1, D)), so the
port's batched rows are held to its own single-query rows with the JAX
test's allowance (tests/test_batched.py): scores within 1e-4 relative and
1e-5 absolute, a differing id only between scores within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.featurize import unpack_features as j_unpack
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.ops import bm25 as jbm25
from review_recommender_tpu.ops import dense as jdense
from review_recommender_tpu.ops import fusion as jfusion
from review_recommender_tpu.ops.gate import gate_factors_device as j_gate
from review_recommender_tpu.utils import text as jtext
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine.featurize import unpack_features as t_unpack
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex
from review_recommender_tpu_torch.ops import bm25 as tbm25
from review_recommender_tpu_torch.ops import dense as tdense
from review_recommender_tpu_torch.ops import fusion as tfusion
from review_recommender_tpu_torch.ops.gate import gate_factors_device as t_gate
from review_recommender_tpu_torch.utils.numerics import minmax_normalize_masked
from tests.test_engine_parity import CONFIGS, QUERIES, make_corpus

TOL = dict(rtol=1e-5, atol=1e-5)
SINGLE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_batched.py's batched-vs-single bound
NEAR_TIE = 1e-3
T = torch.from_numpy
BATCH = QUERIES + ["yellow socks", "a b", "zzz unknown words"]
KNOB_SETS = [  # tests/test_batched.py:105-110
    (1.0, 0.0, 0.0, 0.0, 0.0, 20.0, 1.0, 1.0),
    (0.0, 1.0, 0.0, 0.0, 0.0, 20.0, 1.0, 1.0),
    (0.5, 0.3, 0.0, 0.2, 0.0, 20.0, 5.0, 0.3),
    (0.4, 0.2, 0.0, 0.1, 0.0, 10.0, 8.0, 0.5),
]
HYBRID = (0.5, 0.3, 0.0, 0.2, 0.0, 20.0, 8.0, 0.5)


@pytest.fixture(scope="module")
def engines():
    products, emb, _r, _re = make_corpus(n=320, dim=64, seed=0)
    jb = build_bundle_from_products(products, emb, pad_multiple=16, doc_terms_cap=64)
    tp = ProductIndex(**{f: getattr(jb.products, f) for f in ProductIndex.__dataclass_fields__})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, port_config):  # both engines see 160 stripes
            mp.setattr(c, "DENSE_POOL_STRIPES", 160)
        for pool in ("exact", "striped"):
            je = JaxEngine(jb, emb_dtype="float32", gate_mode="device", dense_pool=pool)
            je.featurizer._native = None  # the Python path, which the port copies
            je.featurizer._vocab_blob = None
            te = SearchEngine(IndexBundle(products=tp), device="cpu", emb_dtype="float32",
                              gate_mode="device", dense_pool=pool)
            assert je.dense_pool == te.dense_pool == pool
            out[pool] = (je, te)
    return out


def _qvecs(seed, b=len(BATCH), d=64):
    q = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _weights(knobs):
    return jfusion.FusionWeights.make(*knobs), tfusion.FusionWeights.make(*knobs)


@pytest.mark.parametrize("pool_size", [48, 150])
@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_query_fused_batched_matches_jax(engines, pool, pool_size):
    je, te = engines[pool]
    qv = _qvecs(1)
    jw, tw = _weights(HYBRID)
    jr, js = je.query_fused_batched(qv, BATCH, jw, pool=pool_size, k=10)
    tr, ts = te.query_fused_batched(qv, BATCH, tw, pool=pool_size, k=10)
    assert tr.shape == ts.shape == (len(BATCH), 10)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_query_fused_batched_pw_matches_jax(engines, pool):
    """Four knob sets in one batch, the breakdown (B, k, 7) included."""
    je, te = engines[pool]
    qv = _qvecs(7, b=4)
    queries = BATCH[:4]
    jr, js, jbd = je.query_fused_batched_pw(qv, queries, KNOB_SETS, pool=48, k=10)
    tr, ts, tbd = te.query_fused_batched_pw(qv, queries, KNOB_SETS, pool=48, k=10)
    assert tbd.shape == (4, 10, 7)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tbd.numpy(), np.asarray(jbd), **TOL)
    for i, knobs in enumerate(KNOB_SETS):  # each row is the query with its own knobs
        r1, s1 = te.query_fused(qv[i], queries[i], tfusion.FusionWeights.make(*knobs),
                                pool=48, k=10)
        np.testing.assert_allclose(ts[i].numpy(), s1.numpy(), **SINGLE_TOL)


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_query_fused1_and_split_match_jax(engines, pool):
    je, te = engines[pool]
    qv = _qvecs(2)
    jw, tw = _weights(HYBRID)
    for i, query in enumerate(BATCH[:4]):
        jout = np.asarray(je.query_fused1(qv[i], query, jw, pool=150, k=10))
        tout = te.query_fused1(qv[i], query, tw, pool=150, k=10)
        assert tout.shape == (10, 9) and tout.dtype == torch.float32
        np.testing.assert_array_equal(tout[:, 0].numpy(), jout[:, 0])
        np.testing.assert_allclose(tout.numpy(), jout, **TOL)
        (tr, ts), (jr, js) = te.split_fused1(tout), je.split_fused1(jout)
        assert tr.dtype == jr.dtype == np.int64
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(ts, js, **TOL)
        rows, scores = te.query_fused(qv[i], query, tw, pool=150, k=10)
        np.testing.assert_array_equal(rows.numpy(), tr)
        np.testing.assert_array_equal(scores.numpy(), ts)


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_batched_rows_match_own_query_fused(engines, pool):
    _je, te = engines[pool]
    qv = _qvecs(3)
    _jw, tw = _weights(HYBRID)
    rb, sb = te.query_fused_batched(qv, BATCH, tw, pool=48, k=10)
    for i, query in enumerate(BATCH):
        r1, s1 = te.query_fused(qv[i], query, tw, pool=48, k=10)
        np.testing.assert_allclose(sb[i].numpy(), s1.numpy(), **SINGLE_TOL)
        for j, (a, b) in enumerate(zip(r1.tolist(), rb[i].tolist())):
            if a != b:  # a rank swap only between near-ties
                assert abs(float(s1[j]) - float(sb[i, j])) < NEAR_TIE


def test_run_search_fused_path_is_query_fused1(engines):
    """run_search's single-query fused path and query_fused1 are one pass."""
    _je, te = engines["exact"]
    qv = _qvecs(4, b=1)[0]
    knobs = dict(w_dense=0.5, w_bm25=0.3, w_rerank=0.0, w_prior=0.2, w_best=0.0,
                 prior_C=20.0, min_reviews=8, gate_penalty=0.5)
    rows, _snips, debug = te.run_search(BATCH[0], k=10, rerank_k=0, qvec=qv, **knobs)
    assert debug["fused"]
    out = te.query_fused1(qv, BATCH[0], tfusion.FusionWeights.make(*knobs.values()),
                          pool=150, k=10).numpy()
    assert [r["sku"] for r in rows] == [te.products.skus[int(i)] for i in out[:, 0]]
    np.testing.assert_array_equal([r["_final"] for r in rows], out[:, 1])


def _fused_forms(engine, w, use_snips):
    """The four fused forms on one small batch, each with `use_snips`."""
    qv = _qvecs(5, b=2)
    q2 = ["yellow socks", "stainless steel kitchen knife"]
    return {
        "query_fused": lambda: engine.query_fused(qv[0], q2[0], w, 150, 10, use_snips=use_snips),
        "query_fused1": lambda: engine.query_fused1(qv[0], q2[0], w, 150, 10,
                                                    use_snips=use_snips),
        "query_fused_batched": lambda: engine.query_fused_batched(qv, q2, w, 150, 10,
                                                                  use_snips=use_snips),
        "query_fused_batched_pw": lambda: engine.query_fused_batched_pw(
            qv, q2, KNOB_SETS[:2], 150, 10, use_snips=use_snips),
    }


@pytest.mark.parametrize("enable_snippets", [True, False])
def test_snippets_without_reviews_match_jax(engines, monkeypatch, enable_snippets):
    """A bundle without reviews (this file's engines): use_snips=True runs
    as use_snips=False on both engines, whatever ENABLE_SNIPPETS says (the
    JAX engine's zero snippet lane). The four fused forms and run_search
    against the JAX engine: ids equal, scores and signals within 1e-5."""
    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "ENABLE_SNIPPETS", enable_snippets)
    je, te = engines["exact"]
    assert te.bundle.reviews is None and je.reviews is None
    jw, tw = _weights(HYBRID)
    jforms, tforms = _fused_forms(je, jw, True), _fused_forms(te, tw, True)
    for name, tcall in tforms.items():
        got, ref = tcall(), jforms[name]()
        if name == "query_fused1":  # one (k, 9) buffer: row ids in column 0
            got, ref = (got[:, 0], got), (np.asarray(ref)[:, 0], ref)
        assert len(got) == len(ref)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), err_msg=name)
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)
    qv = _qvecs(6, b=1)[0]
    for cfg in ("hybrid", "hybrid_rerank"):
        df, jsnips, jdbg = je.run_search(BATCH[1], use_snips=True, qvec=qv, **CONFIGS[cfg])
        rows, snips, tdbg = te.run_search(BATCH[1], use_snips=True, qvec=qv, **CONFIGS[cfg])
        assert snips == jsnips == {}
        assert [r["sku"] for r in rows] == list(df["sku"])
        for col in ("_dense", "_bm25", "_best", "_final"):
            np.testing.assert_allclose([r[col] for r in rows], df[col].to_numpy(), **TOL)
        assert not any(r["_best"] for r in rows)
        for key in ("tokens", "groups", "pool", "gate_mode", "bm25_active"):
            assert tdbg[key] == jdbg[key], key
        assert tdbg.get("fused") == jdbg.get("fused")


# ------------------------------------------------------ shared ops, batched
def _fusion_batch(seed=11, b=3, p=40):
    """B pools whose score ranges differ by orders of magnitude: a statistic
    taken across the batch would mix them."""
    rng = np.random.default_rng(seed)
    scale = np.array([1e-3, 1.0, 1e3], np.float32)[:b, None]
    valid = rng.random((b, p)) < 0.85
    dense = np.where(valid, rng.uniform(0.1, 0.9, (b, p)) * scale, -np.inf).astype(np.float32)
    bm25 = (rng.uniform(0, 8, (b, p)) * scale[::-1]).astype(np.float32)
    zeros = np.zeros((b, p), np.float32)
    n = (rng.integers(0, 300, (b, p)) * np.array([1, 10, 100])[:b, None]).astype(np.float32)
    stars = rng.uniform(1, 5, (b, p)).astype(np.float32)
    gate = rng.choice([1.0, 0.5, 0.25], (b, p)).astype(np.float32)
    return dense, bm25, zeros, zeros.astype(bool), zeros, n, stars, gate, valid


@pytest.mark.parametrize("per_query", [False, True])
def test_fusion_reduces_within_each_row(per_query):
    """Each row of a batched fusion equals that row fused alone and the JAX
    package's vmap; the shared or per-query (B, 1) weights give the same."""
    dense, bm25, rr, rr_mask, best, n, stars, gate, valid = _fusion_batch()
    knobs = [(0.5, 0.3, 0.2, 0.2, 0.0, 20.0, 5, 0.5), (0.1, 0.6, 0.0, 0.3, 0.0, 10.0, 8, 0.3),
             (0.9, 0.0, 0.0, 0.1, 0.0, 40.0, 1, 1.0)]
    if per_query:
        wmat = np.asarray(knobs, np.float32)
        tw = tfusion.FusionWeights(*(T(wmat[:, i:i + 1]) for i in range(8)))
        jw = jfusion.FusionWeights(*(jnp.asarray(wmat[:, i]) for i in range(8)))
        w_axis = 0
    else:
        tw, jw, w_axis = tfusion.FusionWeights.make(*knobs[0]), \
            jfusion.FusionWeights.make(*knobs[0]), None
    arrays = (dense, bm25, rr, rr_mask, best, n, stars, gate, valid)
    got = tfusion.fuse_candidates(*(T(x) for x in arrays[:5]), False,
                                  *(T(x) for x in arrays[5:]), tw)
    fuse = lambda d, b, r, m, be, n_, s, g, v, w: jfusion.fuse_candidates(
        d, b, r, m, be, jnp.bool_(False), n_, s, g, v, w)
    ref = jax.vmap(fuse, in_axes=(0,) * 9 + (w_axis,))(*(jnp.asarray(x) for x in arrays), jw)
    for name in tfusion.FusionResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    for i in range(dense.shape[0]):
        wi = tfusion.FusionWeights.make(*knobs[i if per_query else 0])
        one = tfusion.fuse_candidates(*(T(x[i]) for x in arrays[:5]), False,
                                      *(T(x[i]) for x in arrays[5:]), wi)
        for name in tfusion.FusionResult._fields:
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          getattr(one, name).numpy(), err_msg=name)
    assert float(got.dense[0][T(valid[0])].max()) == pytest.approx(1.0)
    s, p = tfusion.final_topk(got, 10)
    rs, rp = jax.vmap(lambda f: jax.lax.top_k(f, 10))(ref.final)
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))


def test_minmax_rows_have_their_own_bounds():
    x = np.array([[0.001, 0.002, 0.003, 5.0], [100.0, 300.0, 200.0, -7.0]], np.float32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
    got = minmax_normalize_masked(T(x), T(valid)).numpy()
    np.testing.assert_allclose(got, [[0, 0.5, 1, 0], [0, 1, 0.5, 0]], atol=1e-6)


def test_dense_topk_batched_and_striped_scan():
    rng = np.random.default_rng(12)
    n, d, b = 300, 32, 5
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.arange(n) < n - 7
    qv = _qvecs(13, b=b, d=d)
    rs, ri = jdense.dense_topk_batched(jnp.asarray(emb), jnp.asarray(qv), jnp.asarray(valid), 150)
    gs, gi = tdense.dense_topk_batched(T(emb), T(qv), T(valid), 150)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **TOL)
    je, jv = jdense.slice_corpus_for_striped(jnp.asarray(emb), jnp.asarray(valid), 16)
    te, tv = tdense.slice_corpus_for_striped(T(emb), T(valid), 16)
    scan = jax.vmap(jdense.dense_striped_topk_scan, in_axes=(None, None, 0, None))
    rs, ri = scan(je, jv, jnp.asarray(qv), 150)
    gs, gi = tdense.dense_striped_topk_scan(te, tv, T(qv), 150)
    assert gi.shape == (b, 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **TOL)
    for i in range(b):  # each row equals the single-query scan
        s1, i1 = tdense.dense_striped_topk_scan(te, tv, T(qv[i]), 150)
        np.testing.assert_array_equal(i1.numpy(), gi[i].numpy())


def test_bm25_and_gate_batched():
    rng = np.random.default_rng(14)
    b, p, L, Q, G, T_cap = 3, 20, 12, 6, len(jtext.GATE_PHRASES), 8
    terms = rng.integers(0, 40, (b, p, L)).astype(np.int32)
    tf = np.where(terms > 0, rng.integers(1, 6, (b, p, L)), 0).astype(np.float32)
    dl = tf.sum(-1).astype(np.float32) + 1.0
    bm = rng.random((b, p, L)).astype(np.float32)
    qt = rng.integers(0, 40, (b, Q)).astype(np.int32)
    qi = np.where(qt > 0, rng.uniform(0.1, 3, (b, Q)), 0).astype(np.float32)
    avgdl = np.float32(dl.mean())
    ref = jax.vmap(jbm25.bm25_candidate_scores, in_axes=(0, 0, 0, 0, 0, None))(
        *(jnp.asarray(x) for x in (terms, tf, dl, qt, qi)), jnp.float32(avgdl))
    got = tbm25.bm25_candidate_scores(*(T(x) for x in (terms, tf, dl, qt, qi)),
                                      torch.tensor(avgdl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref = jax.vmap(jbm25.bm25_candidate_scores_eager)(*(jnp.asarray(x) for x in (terms, bm, qt)))
    got = tbm25.bm25_candidate_scores_eager(T(terms), T(bm), T(qt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    bits = rng.random((b, p, G)) < 0.05
    gp = rng.random((b, 6, G)) < 0.1
    gt = np.where(rng.random((b, 6, T_cap)) < 0.3, rng.integers(1, 40, (b, 6, T_cap)), -1)
    gt = gt.astype(np.int32)
    gv = rng.random((b, 6)) < 0.7
    rf, rh = jax.vmap(j_gate, in_axes=(0, 0, 0, 0, 0, None))(
        *(jnp.asarray(x) for x in (bits, terms, gp, gt, gv)), jnp.float32(0.3))
    tf_, th = t_gate(*(T(x) for x in (bits, terms, gp, gt, gv)), 0.3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(rh))
    np.testing.assert_allclose(tf_.numpy(), np.asarray(rf), **TOL)
    assert len(set(th.numpy().ravel().tolist())) > 1


def test_unpack_features_batched(engines):
    je, te = engines["exact"]
    packed = te.featurizer.featurize_packed_batch(BATCH)
    np.testing.assert_array_equal(packed, je.featurizer.featurize_packed_batch(BATCH))
    assert packed.shape == (len(BATCH), 2 * 32 + 6 * len(jtext.GATE_PHRASES) + 6 * 64 + 6)
    ref = jax.vmap(lambda x: j_unpack(x, 32, 64))(jnp.asarray(packed))
    got = t_unpack(T(packed), 32, 64)
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
        assert a.shape[0] == len(BATCH)
