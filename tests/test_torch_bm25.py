"""Full-corpus BM25 of the port (review_recommender_tpu_torch) against the
JAX package, on the same numpy inputs: the host packer, the plain versions
of the two BM25 kernels (against the Pallas kernels in interpret mode), the
plain full-corpus scans, and SearchEngine.search_bm25 / search_dense.

Scores must be bitwise equal: per query slot the matched tf values are
integers (or, in the eager scan, one contribution per unique doc term),
whose f32 sum is exact in any order, and every other step runs in the JAX
expression order. Row ids must be exactly equal, ties included. The dense
scores of search_dense agree to 1e-6 (f32 dot products summed in another
order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import attach_eager_bm25, build_bundle_from_products
from review_recommender_tpu.ops import bm25 as jbm25
from review_recommender_tpu.ops.pallas import bm25_kernel as jbk
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex
from review_recommender_tpu_torch.ops import bm25 as tbm25
from review_recommender_tpu_torch.ops import bm25_kernel as tbk
from tests.test_engine_parity import QUERIES, make_corpus
from tests.torch_bm25_cases import CASES, bm25_edge_case, pack

T = torch.from_numpy


def _postings(seed, n, l, v=500, unique=False):
    """Random (N, L) postings with PAD lanes (term 0, tf 0), tf 255/200
    lanes (the packed word's sign bit), doc_len = sum of tf, and a (Q,)
    query with PAD slots (id 0, idf 0) and repeated slots."""
    rng = np.random.default_rng(seed)
    if unique:  # the index's layout: each doc's term ids are distinct
        terms = np.stack([rng.permutation(np.arange(1, v))[:l] for _ in range(n)]).astype(np.int32)
    else:
        terms = rng.integers(1, v, (n, l)).astype(np.int32)
    terms[:, -(l // 4):] = 0  # PAD tail lanes
    tf = rng.integers(1, 5, (n, l)).astype(np.float32)
    tf[terms == 0] = 0
    tf[0, 0], tf[1, :2] = 255.0, 200.0
    dl = tf.sum(1).astype(np.float32)
    q = 12
    qt = rng.integers(1, v, q).astype(np.int32)
    qt[0], qt[1], qt[2] = terms[0, 0], terms[1, 1], terms[1, 1]  # a tf-255 lane, a repeat
    qt[-3:] = 0
    qi = rng.uniform(0.5, 3, q).astype(np.float32)
    qi[-3:] = 0
    return terms, tf, dl, qt, qi, np.float32(dl.mean())


# ------------------------------------------------------------------ packer
def test_pack_postings_is_the_jax_packer():
    terms, tf, *_ = _postings(0, 700, 40)
    got, ref = tbk.pack_postings(terms, tf), jbk.pack_postings(terms, tf)
    assert got.dtype == ref.dtype == np.int32 and got.shape == ref.shape == (40, 1024)
    np.testing.assert_array_equal(got, ref)
    assert (got < 0).any()  # tf >= 128 lanes carry the sign bit


@pytest.mark.parametrize("terms,tf", [
    ([[1, 2, 0]], [[256.0, 1, 0]]),  # tf > 255
    ([[1, 2, 0]], [[1.5, 1, 0]]),  # non-integer tf
    ([[1 << 24, 2, 0]], [[1.0, 1, 0]]),  # term id overflows 24 bits
    ([[1, 2, 0]], [[255.0, 1, 0]]),  # the largest tf that packs
])
def test_pack_postings_guards(terms, tf):
    terms, tf = np.array(terms, np.int32), np.array(tf, np.float32)
    got, ref = tbk.pack_postings(terms, tf), jbk.pack_postings(terms, tf)
    assert (got is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)


# ----------------------------------------------- plain versions vs Pallas
def _assert_edge_case(got, pallas, terms, tf, dl, qt, qi, avgdl):
    """A plain version's scores on an edge case: bitwise equal to the JAX
    package's XLA scan, and to its Pallas kernel in interpret mode (none at
    L = 0: the kernel's grid divides by L). At Q = 1 XLA's CPU compile of the
    interpret-mode kernel rounds one step otherwise (1 ulp on 3 of 777 rows),
    where the XLA scan and step-by-step numpy f32 agree with the plain
    version bitwise: there the Pallas kernel is held to 1 ulp."""
    xla = np.asarray(jbm25.bm25_full_scores(
        *(jnp.asarray(a) for a in (terms, tf, dl, qt, qi)), jnp.float32(avgdl)))
    np.testing.assert_array_equal(got, xla)
    if pallas is None:
        assert terms.shape[1] == 0
    elif qt.shape[0] == 1:
        np.testing.assert_array_max_ulp(got, pallas, maxulp=1)
    else:
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("n,l,case", [
    pytest.param(256, 64, None, id="256-64"), pytest.param(700, 96, None, id="700-96"),
    pytest.param(1024, 33, None, id="1024-33")] + [pytest.param(0, 0, c, id=c) for c in CASES])
def test_packed_reference_matches_pallas(n, l, case):
    """N not 512-aligned is padded by the packer; pad rows score exactly 0.
    The lookup's edge cases (tests/torch_bm25_cases.py) too, see
    _assert_edge_case."""
    if case is None:
        terms, tf, dl, qt, qi, avgdl = _postings(n + l, n, l)
        pk = tbk.pack_postings(terms, tf)
    else:
        terms, tf, dl, qt, qi, avgdl = bm25_edge_case(case)
        n, l = terms.shape
        pk = pack(terms, tf, -(-n // tbk.TILE_N_PACKED) * tbk.TILE_N_PACKED)
        if l:
            np.testing.assert_array_equal(pk, tbk.pack_postings(terms, tf))
    dl_p = np.pad(dl, (0, pk.shape[1] - n))
    got = tbk.bm25_full_scores_packed_reference(T(pk), T(dl_p), T(qt), T(qi), avgdl).numpy()
    ref = None
    if l:
        ref = np.asarray(jbk.bm25_full_scores_packed_pallas(
            jnp.asarray(pk), jnp.asarray(dl_p), jnp.asarray(qt), jnp.asarray(qi),
            jnp.float32(avgdl), interpret=True))
    if case is None:
        np.testing.assert_array_equal(got, ref)
    else:
        _assert_edge_case(got[:n], None if ref is None else ref[:n], terms, tf, dl, qt, qi, avgdl)
    assert not got[n:].any() and (got[:n].any() or l == 0)


@pytest.mark.parametrize("n,l,case", [
    pytest.param(256, 64, None, id="256-64"), pytest.param(512, 40, None, id="512-40")]
    + [pytest.param(0, 0, c, id=c) for c in CASES])
def test_unpacked_reference_matches_pallas(n, l, case):
    """The edge cases' rows are padded to the Pallas kernel's 256-row tile
    (pad rows: no lanes in use, doc_len 0); see _assert_edge_case."""
    if case is None:
        terms, tf, dl, qt, qi, avgdl = _postings(n * 7 + l, n, l)
        tf[2, 3] = 300.0  # past the packed field: only the unpacked scan takes it
        dl = tf.sum(1).astype(np.float32)
    else:
        terms, tf, dl, qt, qi, avgdl = bm25_edge_case(case)
        pad = -terms.shape[0] % tbk.TILE_N
        terms, tf = (np.pad(a, ((0, pad), (0, 0))) for a in (terms, tf))
        dl = np.pad(dl, (0, pad))
        l = terms.shape[1]
    got = tbm25.bm25_full_scores(T(terms), T(tf), T(dl), T(qt), T(qi), avgdl).numpy()
    ref = None
    if l:
        ref = np.asarray(jbk.bm25_full_scores_pallas(
            *(jnp.asarray(a) for a in (terms, tf, dl, qt, qi)), jnp.float32(avgdl),
            interpret=True))
    if case is None:
        np.testing.assert_array_equal(got, ref)
    else:
        _assert_edge_case(got, ref, terms, tf, dl, qt, qi, avgdl)


def test_packed_and_unpacked_references_agree():
    terms, tf, dl, qt, qi, avgdl = _postings(5, 600, 48)
    pk = tbk.pack_postings(terms, tf)
    dl_p = np.pad(dl, (0, pk.shape[1] - 600))
    a = tbk.bm25_full_scores_packed_reference(T(pk), T(dl_p), T(qt), T(qi), avgdl)
    b = tbm25.bm25_full_scores(T(terms), T(tf), T(dl), T(qt), T(qi), avgdl)
    np.testing.assert_array_equal(a[:600].numpy(), b.numpy())


# ------------------------------------------------------ plain full scans
def test_bm25_full_scores_and_topk_match_jax():
    terms, tf, dl, qt, qi, avgdl = _postings(11, 900, 64)
    valid = np.arange(900) < 890
    j = [jnp.asarray(x) for x in (terms, tf, dl)]
    ref = np.asarray(jbm25.bm25_full_scores(*j, jnp.asarray(qt), jnp.asarray(qi),
                                            jnp.float32(avgdl)))
    got = tbm25.bm25_full_scores(T(terms), T(tf), T(dl), T(qt), T(qi), T(np.array(avgdl)))
    np.testing.assert_array_equal(got.numpy(), ref)
    for k in (10, 895, 2000):  # 895 and 2000 reach the -inf rows; ties among zeros
        rs, ri = jbm25.bm25_topk(*j, jnp.asarray(valid), jnp.asarray(qt), jnp.asarray(qi),
                                 jnp.float32(avgdl), k)
        gs, gi = tbm25.bm25_topk(T(terms), T(tf), T(dl), T(valid), T(qt), T(qi),
                                 T(np.array(avgdl)), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))


def test_bm25_full_scores_eager_matches_jax():
    terms, tf, dl, qt, qi, avgdl = _postings(12, 400, 48, unique=True)
    contrib = np.where(tf > 0, np.random.default_rng(3).uniform(0.1, 4, tf.shape), 0.0)
    contrib = contrib.astype(np.float32)
    ref = np.asarray(jbm25.bm25_full_scores_eager(jnp.asarray(terms), jnp.asarray(contrib),
                                                  jnp.asarray(qt)))
    got = tbm25.bm25_full_scores_eager(T(terms), T(contrib), T(qt))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------- engine: search_bm25
def _engines(n=75, seed=3, pad_multiple=16, eager=False, unpackable=False):
    products, emb, _r, _re = make_corpus(n=n, dim=32, seed=seed)
    jb = build_bundle_from_products(products, emb, pad_multiple=pad_multiple,
                                    doc_terms_cap=64)
    jp = jb.products
    if unpackable:  # one lane past the 8-bit tf field: pack_postings refuses
        jp.doc_tf = jp.doc_tf.copy()
        jp.doc_len = jp.doc_len.copy()
        jp.doc_len[4] += 300.0 - jp.doc_tf[4, 0]
        jp.doc_tf[4, 0] = 300.0
    if eager:
        attach_eager_bm25(jp)
    tp = ProductIndex(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(ProductIndex)})
    je = JaxEngine(jb, emb_dtype="float32", gate_mode="device")
    te = SearchEngine(IndexBundle(products=tp), device="cpu", emb_dtype="float32")
    return je, te


def _interpret(monkeypatch, name):
    """Run the JAX engine's Pallas wrapper `name` in interpret mode."""
    import review_recommender_tpu.ops.pallas as ppkg

    orig = getattr(ppkg, name)
    monkeypatch.setattr(ppkg, name, lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _assert_same_search(je, te, ks=(10, 60, 80)):
    n_pad = te.products.n_padded
    for query in QUERIES + ["cat", "zzz unknown words"]:
        for k in ks:
            ji, js = je.search_bm25(query, k)
            ti, ts = te.search_bm25(query, k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"{query} k={k}")
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=f"{query} k={k}")
            assert int(ti.max()) < n_pad


@pytest.mark.parametrize("eager", [False, True], ids=["classic", "eager"])
def test_search_bm25_cpu_branches_match_jax(eager):
    """Neither engine takes a kernel on the CPU: the plain classic scan, or
    the plain eager scan. k=60 and 80 reach the zero-score ties and the
    five -inf padding rows."""
    je, te = _engines(eager=eager)
    assert not te._kernels_ok()
    _assert_same_search(je, te)
    assert te._bm25_packed_cache is False  # never packed
    assert tbk.bm25_packed_kernel_launches == tbk.bm25_unpacked_kernel_launches == 0


@pytest.mark.parametrize("eager", [False, True], ids=["classic", "eager"])
def test_search_bm25_packed_branch_matches_jax(monkeypatch, eager):
    """The packed branch on both sides: the JAX packed Pallas kernel in
    interpret mode, the port's packed scan + top-k on CPU tensors."""
    je, te = _engines(eager=eager)
    monkeypatch.setattr(je, "_pallas_ok", lambda: True)
    monkeypatch.setattr(te, "_kernels_ok", lambda: True)
    _interpret(monkeypatch, "bm25_topk_packed_pallas")
    _assert_same_search(je, te)
    assert te._bm25_packed_cache is not None and je._bm25_packed_cache is not None
    pk, dl_p, valid_p = te._bm25_packed_cache
    assert pk.shape == (te.products.terms_cap, 512) and dl_p.shape == valid_p.shape == (512,)
    assert int(valid_p.sum()) == te.products.n_docs


def test_search_bm25_unpacked_branch_matches_jax(monkeypatch):
    """A classic bundle whose postings cannot pack (one tf of 300) takes the
    unpacked kernel's branch; pad_multiple=256 meets the JAX kernel's tile
    assert."""
    je, te = _engines(pad_multiple=tbk.TILE_N, unpackable=True)
    monkeypatch.setattr(je, "_pallas_ok", lambda: True)
    monkeypatch.setattr(te, "_kernels_ok", lambda: True)
    _interpret(monkeypatch, "bm25_topk_pallas")
    _assert_same_search(je, te, ks=(10, 80, 300))
    assert te._bm25_packed_cache is None and je._bm25_packed_cache is None
    assert "doc_tf" in te.arrays


def _long_query(te):
    """Every distinct word of the corpus in one query (49 words here: more
    live slots than the default cap of 32)."""
    return " ".join(sorted({w for text in te.products.agg_texts for w in text.lower().split()}))


@pytest.mark.parametrize("branch", ["cpu", "packed", "unpacked"])
def test_search_bm25_long_queries_match_jax(monkeypatch, branch):
    """QUERY_TERMS_CAP=80 (more slots than one kernel launch takes): the
    port's CPU engine does not refuse it, and search_bm25 matches the JAX
    engine bit for bit on its CPU branch and on the packed and unpacked
    branches (the Pallas kernels in interpret mode loop over any Q). The
    kernels' windows of 64 slots are held to their plain versions on the
    card (tests/test_torch_gpu.py)."""
    from review_recommender_tpu.config import config as jax_config
    from review_recommender_tpu_torch.config import config as port_config

    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "QUERY_TERMS_CAP", 80)
    kw = dict(pad_multiple=tbk.TILE_N, unpackable=True) if branch == "unpacked" else {}
    je, te = _engines(**kw)
    assert te.featurizer.query_terms_cap == je.featurizer.query_terms_cap == 80
    if branch != "cpu":
        monkeypatch.setattr(je, "_pallas_ok", lambda: True)
        monkeypatch.setattr(te, "_kernels_ok", lambda: True)
        _interpret(monkeypatch, f"bm25_topk_{'packed_' if branch == 'packed' else ''}pallas")
    query = _long_query(te)
    qf = te.featurizer.featurize(query)
    assert qf.q_terms.shape == (80,) and int((qf.q_idf > 0).sum()) > 32
    for q in (query, QUERIES[0]):
        for k in (10, 60):
            ji, js = je.search_bm25(q, k)
            ti, ts = te.search_bm25(q, k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    cache = te._bm25_packed_cache  # False: never packed; None: cannot pack
    assert cache is False if branch == "cpu" else (cache is None) == (branch == "unpacked")
    assert tbk.MAX_QUERY_SLOTS >= 1024


def test_cpu_engine_takes_query_terms_cap_above_the_kernel_limit(monkeypatch):
    """The BM25 kernels' slot limit binds only on CUDA: a CPU engine takes a
    QUERY_TERMS_CAP above it and answers search_bm25 on the plain scan."""
    from review_recommender_tpu_torch.config import config as port_config

    monkeypatch.setattr(port_config, "QUERY_TERMS_CAP", tbk.MAX_QUERY_SLOTS + 1)
    _je, te = _engines()
    idx, scores = te.search_bm25(QUERIES[0], 10)
    assert idx.shape == scores.shape == (10,) and bool((scores > 0).any())


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_search_dense_matches_jax(monkeypatch, pool):
    from review_recommender_tpu.config import config as jax_config
    from review_recommender_tpu_torch.config import config as port_config

    for c in (jax_config, port_config):  # both engines see 24 stripes
        monkeypatch.setattr(c, "DENSE_POOL_STRIPES", 24)
    products, emb, _r, _re = make_corpus(n=75, dim=32, seed=4)
    jb = build_bundle_from_products(products, emb, pad_multiple=16, doc_terms_cap=32)
    tp = ProductIndex(**{f.name: getattr(jb.products, f.name)
                         for f in dataclasses.fields(ProductIndex)})
    je = JaxEngine(jb, emb_dtype="float32", dense_pool=pool)
    te = SearchEngine(IndexBundle(products=tp), device="cpu", emb_dtype="float32",
                      dense_pool=pool)
    q = np.random.default_rng(9).standard_normal(32).astype(np.float32)
    for k in (5, 20, 200):
        ji, js = je.search_dense(q, k)
        ti, ts = te.search_dense(q, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ dispatchers
def test_dispatch_takes_no_kernel_on_cpu_and_refuses_cpu_kernels():
    """bm25_topk_packed/_unpacked take the plain scans for CPU tensors; the
    kernel wrappers refuse CPU tensors rather than fall back."""
    terms, tf, dl, qt, qi, avgdl = _postings(1, 64, 16)
    pk = tbk.pack_postings(terms, tf)
    dl_p = np.pad(dl, (0, pk.shape[1] - 64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tbk.bm25_full_scores_packed_kernel(T(pk), T(dl_p), T(qt), T(qi), avgdl)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tbk.bm25_full_scores_kernel(T(terms), T(tf), T(dl), T(qt), T(qi), avgdl)
    before = (tbk.bm25_packed_kernel_launches, tbk.bm25_unpacked_kernel_launches)
    s1 = tbk.bm25_topk_packed(T(pk), T(dl_p), T(np.arange(512) < 64), T(qt), T(qi), avgdl, 8)
    s2 = tbk.bm25_topk_unpacked(T(terms), T(tf), T(dl), T(np.ones(64, bool)), T(qt), T(qi),
                                avgdl, 8)
    assert (tbk.bm25_packed_kernel_launches, tbk.bm25_unpacked_kernel_launches) == before
    s3 = tbm25.bm25_topk(T(terms), T(tf), T(dl), T(np.ones(64, bool)), T(qt), T(qi), avgdl, 8)
    for a, b in ((s1, s2), (s2, s3)):
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
