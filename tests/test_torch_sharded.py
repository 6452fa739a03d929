"""The port's corpus-sharded engine (review_recommender_tpu_torch/parallel/
sharded.py) on devices=["cpu"] * 8 against the JAX ShardedSearchEngine on
the 8 virtual CPU devices of tests/conftest.py, both over one bundle of
tests/test_engine_parity.make_corpus(n=96, dim=64) in f32 (12 rows a
shard) built by the JAX builder, with hash rerank tokens and, for
query_e2e, the same tiny f32 towers (flax parameters carried over by
params_from_flax).

Ids must be equal, signal columns within 1e-5; two ids may swap only
where their `_final` (or pool score) differs by under 1e-5. Covered:
dense_topk (exact, striped with the pad-stripe alias case of
tests/test_sharded.py, int8 bit-equal), bm25_topk (scores bit-equal to
JAX's packed kernel in interpret mode and to its XLA block, on packable,
unpackable and eager bundles: the port's packed and unpacked layouts run
their plain scans on CPU tensors), query_fused, query_fused_batched at
B = 1, 3, 33, 130 and _pw, run_search on both paths (host gate, a fake
cross-encoder, use_snips at max_scan 0 and 5), query_e2e at rr_k 0 and
at an rr_k that is not a multiple of 8, int8 and striped engines, IVF at
equal auto sizes, the coalesced rerank, and query_e2e without
attach_models. The fault test: shards whose auto IVF block sizes differ
make JAX raise at `sharded.py:264`; the port serves, and with nprobe past
the block count its pool is the exact pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import (
    attach_eager_bm25,
    attach_rerank_tokens,
    build_bundle_from_products,
)
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import BiEncoder as JaxBiEncoder
from review_recommender_tpu.models.encoder import CrossEncoder as JaxCrossEncoder
from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from review_recommender_tpu.ops.fusion import FusionWeights as JaxWeights
from review_recommender_tpu.parallel import sharded as jax_sharded
from review_recommender_tpu.parallel.sharded import ShardedSearchEngine as JaxSharded
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex, ReviewIndex
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.ops import attention
from review_recommender_tpu_torch.ops import bm25_kernel as tbk
from review_recommender_tpu_torch.ops.dense import quantize_corpus_int8
from review_recommender_tpu_torch.ops.fusion import FusionWeights
from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine
from tests.test_engine_parity import QUERIES, make_corpus
from tests.test_microbatch import _FakePairCE
from tests.torch_bundle_cases import one_torch_thread  # noqa: F401

N_SHARDS = 8
CPU8 = ["cpu"] * N_SHARDS
TOL = dict(rtol=1e-5, atol=1e-5)
NEAR = 1e-5
SIGNALS = ("_dense", "_bm25", "_rerank", "_prior", "_best", "_trust", "_gate", "_final")
KNOBS = (0.5, 0.25, 0.15, 0.1, 0.1, 20.0, 5, 0.5)  # FusionWeights.make order
RUN_KNOBS = dict(w_dense=0.5, w_bm25=0.25, w_rerank=0.2, w_prior=0.1, w_best=0.1,
                 prior_C=20.0, min_reviews=5, gate_penalty=0.5)


def port_bundle(jb):
    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    reviews = ReviewIndex(**fields(ReviewIndex, jb.reviews)) if jb.reviews else None
    return IndexBundle(products=ProductIndex(**fields(ProductIndex, jb.products)),
                       reviews=reviews)


def qvec(seed, dim=64):
    v = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def assert_ranked_alike(t_ids, t_scores, j_ids, j_scores, what=""):
    """Equal ids and scores within TOL; ids at a rank may differ only where
    the JAX ranking has another score within NEAR of that rank's (a near
    tie), or at the last rank (a near tie with a row past the cut)."""
    t_ids, j_ids = np.asarray(t_ids), np.asarray(j_ids)
    t_scores, j_scores = np.asarray(t_scores, np.float64), np.asarray(j_scores, np.float64)
    assert t_ids.shape == j_ids.shape, what
    np.testing.assert_allclose(t_scores, j_scores, err_msg=str(what), **TOL)
    fin = np.isfinite(j_scores)
    for i in np.flatnonzero((t_ids != j_ids) & fin):
        others = np.abs(np.delete(j_scores, i) - j_scores[i])
        assert i == len(j_ids) - 1 or others.min() < NEAR, (what, i, t_ids, j_ids)


def assert_rows_alike(rows, df, what=""):
    """run_search rows of the port against the JAX DataFrame."""
    ref = df.to_dict(orient="records")
    assert len(rows) == len(ref), what
    assert_ranked_alike([r["sku"] for r in rows], [r["_final"] for r in rows],
                        [r["sku"] for r in ref], [r["_final"] for r in ref], what)
    for col in SIGNALS[:-1]:
        same = [i for i, (a, b) in enumerate(zip(rows, ref)) if a["sku"] == b["sku"]]
        np.testing.assert_allclose([rows[i][col] for i in same], [ref[i][col] for i in same],
                                   err_msg=f"{what} {col}", **TOL)


@pytest.fixture(scope="module")
def jax_bundle():
    assert len(jax.devices()) == N_SHARDS, "conftest must provide 8 virtual devices"
    products, emb, reviews, remb = make_corpus(n=96, dim=64, seed=4)
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=16, doc_terms_cap=64)
    attach_rerank_tokens(jb.products, JaxHashTokenizer(JaxBertConfig.tiny().vocab_size),
                         max_tokens=48)
    return jb


@pytest.fixture(scope="module")
def towers():
    cfg = JaxBertConfig.tiny()
    jbe = JaxBiEncoder.random_init(cfg, seed=1, dtype=jnp.float32)
    jce = JaxCrossEncoder.random_init(cfg, seed=2, dtype=jnp.float32)
    tcfg, tok = BertConfig(**vars(cfg)), HashTokenizer(cfg.vocab_size)
    flat = lambda m: jax.tree.map(np.asarray, m.params)
    tbe = BiEncoder(tcfg, params_from_flax(flat(jbe), cfg, "biencoder"), tok, device="cpu",
                    dtype=torch.float32)
    tce = CrossEncoder(tcfg, params_from_flax(flat(jce), cfg, "crossencoder"), tok,
                       device="cpu", dtype=torch.float32)
    return (jbe, jce), (tbe, tce)


@pytest.fixture(scope="module")
def engines(jax_bundle):
    """engines(dtype, pool) -> (JAX engine, port engine) over the bundle,
    each pair built once per module."""
    built = {}

    def get(dtype="float32", pool="exact"):
        if (dtype, pool) not in built:
            je = JaxSharded(jax_bundle, n_shards=N_SHARDS, emb_dtype=dtype, dense_pool=pool)
            te = ShardedSearchEngine(port_bundle(jax_bundle), devices=CPU8, emb_dtype=dtype,
                                     dense_pool=pool)
            assert je.dense_pool == te.dense_pool == pool and te.n_shards == N_SHARDS
            built[dtype, pool] = je, te
        return built[dtype, pool]

    return get


@pytest.fixture(scope="module")
def exact(engines):
    return engines()


# ------------------------------------------------------------------ layout
def test_layout_is_the_jax_layout(exact):
    je, te = exact
    assert te.per == je._local_rows == 12 and te.n_rows == int(je.arrays["valid"].shape[0])
    assert te.device == torch.device("cpu") and te.n_shards == je.n_shards == 8
    for s, sh in enumerate(te.shards):
        assert sh.offset == s * te.per and sh.arrays["emb"].shape == (te.per, 64)
        np.testing.assert_array_equal(
            sh.arrays["doc_terms"].numpy(),
            np.asarray(je.arrays["doc_terms"])[s * te.per:(s + 1) * te.per])
    rev = np.concatenate([sh.rev["rev_product"].numpy() for sh in te.shards])
    np.testing.assert_array_equal(rev, np.asarray(je.rev_arrays["rev_product"]))


# ------------------------------------------------------------ dense / bm25
@pytest.mark.parametrize("variant", ["exact", "striped", "int8", "int8_striped"])
def test_dense_topk_matches_jax(jax_bundle, engines, variant):
    dtype = "int8" if "int8" in variant else "float32"
    pool = "striped" if "striped" in variant else "exact"
    je, te = engines(dtype, pool)
    single = JaxEngine(jax_bundle, emb_dtype=dtype, dense_pool=pool) if dtype == "int8" else None
    for seed in (11, 12, 13):
        for k in (10, 40, 96):
            ji, js = je.dense_topk(qvec(seed), k)
            ti, ts = te.dense_topk(qvec(seed), k)
            if single is None:
                assert_ranked_alike(ti, ts, ji, js, (variant, seed, k))
                continue
            # the same int8 products: bit-equal to the JAX single engine; the
            # JAX sharded form is one ulp off on some queries (the fault test)
            si, ss = single.search_dense(qvec(seed), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(si))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(ss))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.4e-7, atol=0)


def test_fault_jax_sharded_int8_scales_the_query_by_a_reciprocal(jax_bundle, engines):
    """JAX's sharded int8 scores come out as if the query scale were
    max|q| * (1/127), one ulp from the division its single engine and the
    port do (query 12 here); the port's sharded scores are the division's."""
    je, te = engines("int8")
    q = qvec(12)
    emb_q, row_scale = quantize_corpus_int8(jax_bundle.products.emb)

    def scores(q_scale):
        q_scale = np.float32(q_scale)
        q_q = np.clip(np.rint(q / q_scale), -127, 127).astype(np.int32)
        return (emb_q.astype(np.int32) @ q_q).astype(np.float32) * (row_scale * q_scale)

    divided = scores(np.abs(q).max() / np.float32(127.0))
    by_reciprocal = scores(np.abs(q).max() * np.float32(1 / 127.0))
    assert (divided != by_reciprocal).any()
    ji, js = je.dense_topk(q, 10)
    ti, ts = te.dense_topk(q, 10)
    np.testing.assert_array_equal(np.asarray(js), by_reciprocal[np.asarray(ji)])
    np.testing.assert_array_equal(ts.numpy(), divided[ti.numpy()])


def test_dense_topk_pad_stripe_cannot_alias_next_shard(engines):
    """tests/test_sharded.py's geometry: 12 local rows in 5 contiguous
    stripes leave stripe 4 all padding; k=96 selects its -inf lanes, whose
    ids must stay in their own shard (clamped before the offset)."""
    je, te = engines(pool="striped")
    stripes = (je._shard_stripes, te._shard_stripes)
    je._shard_stripes = te._shard_stripes = 5
    je._compiled.pop(("dense", 96), None)
    try:
        ji, js = je.dense_topk(qvec(29), 96)
        ti, ts = te.dense_topk(qvec(29), 96)
    finally:
        je._shard_stripes, te._shard_stripes = stripes
        je._compiled.pop(("dense", 96), None)
    assert_ranked_alike(ti, ts, ji, js)
    finite = np.isfinite(ts.numpy())
    np.testing.assert_array_equal(ti.numpy()[~finite], np.asarray(ji)[~finite])
    assert int(ti.max()) < te.products.n_padded and not finite.all()
    assert len(set(ti.numpy()[finite].tolist())) == int(finite.sum())


def _bm25_bundle(jb, kind):
    """The bundle with its postings made unpackable (one tf of 300) or
    eager (contributions precomputed)."""
    p = dataclasses.replace(jb.products, doc_tf=jb.products.doc_tf.copy(),
                            doc_len=jb.products.doc_len.copy())
    if kind == "unpackable":
        p.doc_len[4] += 300.0 - p.doc_tf[4, 0]
        p.doc_tf[4, 0] = 300.0
    elif kind == "eager":
        attach_eager_bm25(p)
    return dataclasses.replace(jb, products=p)


@pytest.mark.parametrize("kind", ["packable", "unpackable", "eager"])
def test_bm25_topk_bit_equal_to_jax(jax_bundle, monkeypatch, kind):
    """Ids and scores bit-equal to JAX's packed Pallas kernel per shard in
    interpret mode where the postings pack, and to the XLA scan of JAX's
    single engine; the port on its CPU branch and on the kernels' branches
    (the packed layout per shard, or the unpacked postings), whose
    wrappers run the plain scans on CPU tensors. JAX's sharded XLA block
    gives the same ids, its scores within two ulps (the fault test below)."""
    jb = _bm25_bundle(jax_bundle, kind)
    single = JaxEngine(jb, emb_dtype="float32")
    je_xla = JaxSharded(jb, n_shards=N_SHARDS, emb_dtype="float32")
    je_pk = JaxSharded(jb, n_shards=N_SHARDS, emb_dtype="float32")
    je_pk._pallas_interpret = True
    te = ShardedSearchEngine(port_bundle(jb), devices=CPU8, emb_dtype="float32")
    tk = ShardedSearchEngine(port_bundle(jb), devices=CPU8, emb_dtype="float32")
    monkeypatch.setattr(tk, "_kernels_ok", lambda: True)
    # the packed layout keeps k a shard (JAX: the shard's per_p columns),
    # the others min(k, 12) a shard: past 96 rows their lengths differ
    pairs = ((te, single.search_bm25),
             (tk, single.search_bm25 if kind == "unpackable" else je_pk.bm25_topk))
    for query in QUERIES[:4] + ["cat", "zzz unknown words"]:
        for k in (10, 100):  # 100: past the 96 rows, into the -inf tail
            for eng, ref in pairs:
                ti, ts = eng.bm25_topk(query, k)
                ji, js = ref(query, k)
                np.testing.assert_array_equal(ts.numpy(), np.asarray(js), str((query, k)))
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), str((query, k)))
            ji, js = je_xla.bm25_topk(query, k)
            ti, ts = te.bm25_topk(query, k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.4e-7, atol=0)
    packed = tk._bm25_packed_cache
    assert te._bm25_packed_cache is False and (packed is None) == (kind == "unpackable")
    if packed is not None:
        assert len(packed) == N_SHARDS and packed[0][0].shape == (64, tbk.TILE_N_PACKED)
        assert sum(int(v.sum()) for _pk, _dl, v in packed) == te.n_docs
    assert tbk.bm25_packed_kernel_launches == tbk.bm25_unpacked_kernel_launches == 0


def test_fault_jax_sharded_bm25_block_rounds_one_score_apart(exact, jax_bundle):
    """JAX's sharded XLA BM25 block rounds one of this query's 60 scores two
    ulps from its own single engine's scan (and its packed kernel), which
    the port's sharded scan equals bit for bit."""
    je, te = exact
    query = "wireless bluetooth headphones noise cancelling"
    single = JaxEngine(jax_bundle, emb_dtype="float32")
    si, ss = (np.asarray(x) for x in single.search_bm25(query, 60))
    ji, js = (np.asarray(x) for x in je.bm25_topk(query, 60))
    ti, ts = (x.numpy() for x in te.bm25_topk(query, 60))
    np.testing.assert_array_equal(ji, si)
    off = np.flatnonzero(js != ss)
    assert len(off) == 1 and abs(js[off] - ss[off])[0] <= 2 * np.spacing(ss[off])[0]
    np.testing.assert_array_equal(ti, si)
    np.testing.assert_array_equal(ts, ss)


# ------------------------------------------------------------- fused forms
def _weights():
    return JaxWeights.make(*KNOBS), FusionWeights.make(*KNOBS)


@pytest.mark.parametrize("use_snips", [False, True])
def test_query_fused_matches_jax(exact, use_snips):
    je, te = exact
    jw, tw = _weights()
    for i, query in enumerate(QUERIES[:4]):
        for pool, k in ((64, 10), (200, 96)):
            jr, js = je.query_fused(qvec(20 + i), query, jw, pool, k, use_snips=use_snips)
            tr, ts = te.query_fused(qvec(20 + i), query, tw, pool, k, use_snips=use_snips)
            assert_ranked_alike(tr, ts, jr, js, (query, pool, k))


@pytest.mark.parametrize("batch", [1, 3, 33, 130])
def test_query_fused_batched_matches_jax(exact, batch):
    je, te = exact
    jw, tw = _weights()
    qv = np.stack([qvec(300 + i) for i in range(batch)])
    queries = [QUERIES[i % len(QUERIES)] for i in range(batch)]
    jr, js = je.query_fused_batched(qv, queries, jw, 48, 8, use_snips=True)
    tr, ts = te.query_fused_batched(qv, queries, tw, 48, 8, use_snips=True)
    assert tr.shape == (batch, 8)
    for b in range(batch):
        assert_ranked_alike(tr[b], ts[b], np.asarray(jr)[b], np.asarray(js)[b], b)


def test_query_fused_batched_pw_matches_jax(exact):
    je, te = exact
    weights = [KNOBS, (0.7, 0.1, 0.0, 0.2, 0.0, 10.0, 3, 0.9), (0.3, 0.5, 0.0, 0.1, 0.3, 30.0,
                                                                   8, 0.2)] * 2
    qv = np.stack([qvec(400 + i) for i in range(6)])
    queries = [QUERIES[i % len(QUERIES)] for i in range(6)]
    jr, js, jb = (np.asarray(x) for x in je.query_fused_batched_pw(qv, queries, weights, 48, 8,
                                                                   use_snips=True))
    tr, ts, tb = te.query_fused_batched_pw(qv, queries, weights, 48, 8, use_snips=True)
    for b in range(6):
        assert_ranked_alike(tr[b], ts[b], jr[b], js[b], b)
        same = tr[b].numpy() == jr[b]
        np.testing.assert_allclose(tb[b].numpy()[same], jb[b][same], **TOL)


# -------------------------------------------------------------- run_search
RUN_CASES = {
    "fused": dict(gate_mode="device", rerank_k=0, use_snips=False, max_scan=0),
    "host_gate": dict(gate_mode="host", rerank_k=0, use_snips=False, max_scan=0),
    "rerank": dict(gate_mode="device", rerank_k=12, use_snips=False, max_scan=0),
    "snips_device": dict(gate_mode="device", rerank_k=0, use_snips=True, max_scan=0),
    "snips_scan5": dict(gate_mode="host", rerank_k=12, use_snips=True, max_scan=5),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_search_matches_jax(exact, case):
    je, te = exact
    c = dict(RUN_CASES[case])
    je.gate_mode = te.gate_mode = c.pop("gate_mode")
    je.cross_encoder = te.cross_encoder = _FakePairCE()
    try:
        for i, query in enumerate(QUERIES[:3]):
            kw = dict(RUN_KNOBS, k=10, qvec=qvec(50 + i), **c)
            df, jsnips, jdbg = je.run_search(query, **kw)
            rows, snips, tdbg = te.run_search(query, **kw)
            assert_rows_alike(rows, df, (case, query))
            assert list(rows[0]) == list(df.columns)
            assert sorted(snips) == sorted(jsnips) and bool(snips) == c["use_snips"]
            for sku, snip in jsnips.items():
                assert snips[sku]["text"] == snip["text"]
                assert snips[sku]["score"] == pytest.approx(snip["score"], abs=NEAR)
            for key in ("tokens", "groups", "pool", "gate_mode", "bm25_active", "n_shards"):
                assert tdbg[key] == jdbg[key], key
            assert tdbg.get("fused") == jdbg.get("fused") and tdbg["n_shards"] == N_SHARDS
            if c["rerank_k"]:
                assert any(r["_rerank"] != 0 for r in rows)
    finally:
        je.gate_mode = te.gate_mode = "device"
        je.cross_encoder = te.cross_encoder = None


# -------------------------------------------------------------------- e2e
@pytest.mark.parametrize("rr_k", [0, 13])
def test_query_e2e_matches_jax(exact, towers, rr_k):
    """rr_k 13 over 8 shards: 16 pairs, 2 a shard, the pool's lanes 13-15
    scored and masked."""
    je, te = exact
    (jbe, jce), (tbe, tce) = towers
    je.attach_models(jbe, jce)
    te.attach_models(tbe, tce)
    jw, tw = _weights()
    before = attention.mha_kernel_launches
    try:
        for query in QUERIES[:3]:
            jr, js = je.query_e2e(query, jw, 64, 10, rr_k=rr_k)
            tr, ts = te.query_e2e(query, tw, 64, 10, rr_k=rr_k)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    finally:
        je.query_encoder = je.cross_encoder = te.query_encoder = te.cross_encoder = None
    assert attention.mha_kernel_launches == before  # CPU: the plain attention


def test_query_e2e_without_attach_models_raises(jax_bundle):
    te = ShardedSearchEngine(port_bundle(jax_bundle), devices=CPU8, emb_dtype="float32")
    with pytest.raises(RuntimeError, match="attach_models"):
        te.query_e2e("x", FusionWeights.make(), 16, 4)


# ------------------------------------------------------ int8, striped, IVF
@pytest.mark.parametrize("variant", ["int8", "int8_striped", "striped"])
def test_pool_variants_match_jax(engines, variant):
    """Equal ids and finals within TOL (the int8 pools themselves are
    bit-equal: test_dense_topk_matches_jax); striped is exact at this
    size (the stripes cover each shard's 12 rows)."""
    dtype = "int8" if "int8" in variant else "float32"
    pool = "striped" if "striped" in variant else "exact"
    je, te = engines(dtype, pool)
    jw, tw = _weights()
    for i, query in enumerate(QUERIES[:3]):
        jr, js = je.query_fused(qvec(80 + i), query, jw, 48, 10)
        tr, ts = te.query_fused(qvec(80 + i), query, tw, 48, 10)
        assert_ranked_alike(tr, ts, jr, js, query)
    if pool == "striped":
        assert ("emb_qs" if dtype == "int8" else "emb_s") in te.shards[0].arrays


def test_ivf_at_equal_auto_sizes_matches_jax(engines):
    je, te = engines(pool="ivf")
    assert te.ivf_block_rows == int(je.arrays["ivf_blocks"].shape[1])
    assert {iv.block_rows for iv in te.ivfs} == {te.ivf_block_rows}
    assert te.ivf_nprobe_local == je._ivf_nprobe_local
    jw, tw = _weights()
    for i, query in enumerate(QUERIES[:3]):
        jr, js = je.query_fused(qvec(90 + i), query, jw, 48, 10)
        tr, ts = te.query_fused(qvec(90 + i), query, tw, 48, 10)
        assert_ranked_alike(tr, ts, jr, js, query)


def test_fault_ivf_block_sizes_differ_across_shards(monkeypatch):
    """300 products padded to 512 rows over 2 shards: 256 and 44 valid
    rows, 2 centroids each, so the auto block sizes are 128 and 64. JAX
    takes shard 0's 128 for both and raises assigning shard 1's (nb, 64)
    ids; the port pads shard 1's blocks to 128 and, with nprobe past every
    shard's block count, its pool is the exact pool."""
    products, emb, _r, _re = make_corpus(n=300, dim=64, seed=8)
    jb = build_bundle_from_products(products, emb, pad_multiple=256, doc_terms_cap=64)
    for c in (jax_sharded.config, port_config):  # the objects the engines read
        monkeypatch.setattr(c, "IVF_CENTROIDS", 2)
        monkeypatch.setattr(c, "IVF_NPROBE", 64)
    with pytest.raises(ValueError):
        JaxSharded(jb, n_shards=2, emb_dtype="float32", dense_pool="ivf")
    ivf = ShardedSearchEngine(port_bundle(jb), devices=["cpu"] * 2, emb_dtype="float32",
                              dense_pool="ivf")
    exact_e = ShardedSearchEngine(port_bundle(jb), devices=["cpu"] * 2, emb_dtype="float32",
                                  dense_pool="exact")
    assert [iv.stats["block_rows"] for iv in ivf.ivfs] == [128, 128]
    assert ivf.ivf_nprobe_local >= max(iv.n_blocks for iv in ivf.ivfs)
    w = FusionWeights.make()
    for i, query in enumerate(QUERIES[:3]):
        q = torch.from_numpy(qvec(110 + i))
        si, ii = ivf._pool(ivf._replicate(q), 150)
        se, ie = exact_e._pool(exact_e._replicate(q), 150)
        assert_ranked_alike(ii, si, ie, se, query)
        fin = torch.isfinite(se)
        assert int(fin.sum()) == 150 and torch.isfinite(si).sum() == fin.sum()
        a = ivf.query_fused(qvec(110 + i), query, w, 150, 10)
        b = exact_e.query_fused(qvec(110 + i), query, w, 150, 10)
        assert_ranked_alike(*a, *b, query)


# ------------------------------------------------------------ coalesced rerank
@pytest.mark.parametrize("use_snips", [False, True])
def test_coalesced_rerank_matches_jax(jax_bundle, use_snips):
    je = JaxSharded(jax_bundle, n_shards=N_SHARDS, emb_dtype="float32",
                    cross_encoder=_FakePairCE())
    te = ShardedSearchEngine(port_bundle(jax_bundle), devices=CPU8, emb_dtype="float32",
                             cross_encoder=_FakePairCE())
    qv = np.stack([qvec(120 + i) for i in range(4)])
    weights = [(0.4, 0.2, 0.25, 0.15, 0.1, 20.0, 5.0, 0.5)] * 4
    args = (qv, QUERIES[:4], weights, [6, 0, 8, 3])
    jr, js, jbd = (np.asarray(x) for x in je.query_rerank_batched_pw(*args, pool=24, k=8,
                                                                     use_snips=use_snips))
    tr, ts, tbd = te.query_rerank_batched_pw(*args, pool=24, k=8, use_snips=use_snips)
    for b in range(4):
        assert_ranked_alike(tr[b], ts[b], jr[b], js[b], b)
    np.testing.assert_allclose(tbd.numpy(), jbd, **TOL)
    assert (tbd[..., 2] != 0).any() and (tbd[1, :, 2] == 0).all()
    assert bool((tbd[..., 4] != 0).any()) == use_snips
