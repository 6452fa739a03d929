"""The port's int8 corpus (review_recommender_tpu_torch/ops/dense.py,
EMB_DTYPE=int8) against the JAX package's.

Accumulation is exact in int32 and both frameworks round half to even, so
quantization, scores and ids are expected bit-equal to the JAX functions,
single and batched (jax.vmap), exact and striped. int8_matmul pads the
shapes cuBLASLt refuses (17+ rows, K and N multiples of 8) on every
device; its padding is held to an int64 product. The engines (exact and
striped int8) match the JAX engine's SKU order and signal columns within
1e-5 in run_search, the fused forms and search_dense, and within 1e-4 in
query_e2e and the coalesced rerank (tests/torch_pool_cases.py); ivf with
int8 raises ValueError in both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.ops import dense as jd
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.ops import dense as td
from tests import torch_pool_cases as cases

N, D = 300, 64


def _corpus(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[7] = 0.0  # an all-zero row: the 1e-12 scale floor
    valid = np.arange(n) < n - 10
    qs = rng.standard_normal((5, d)).astype(np.float32)
    qs[2] *= 1e-3  # a short query: its own scale
    return emb, valid, qs


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def engines():
    return cases.make_engines({"exact": ("int8", "exact"), "striped": ("int8", "striped")})


def test_quantize_is_bit_equal():
    emb, _v, _q = _corpus()
    (jq, js), (tq, ts) = jd.quantize_corpus_int8(emb), td.quantize_corpus_int8(emb)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, np.asarray(jq))
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert ts[7] == np.float32(1e-12) and not tq[7].any()


def test_query_quantization_matches_jax_including_half_ties():
    """Values at exactly k + 0.5 steps round to even in both."""
    q = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.0, 0.0], np.float32) / 127.0
    q_q, q_scale = td.quantize_query_int8(_t(q))
    j_scale = jnp.maximum(jnp.max(jnp.abs(q)) / 127.0, 1e-12)
    j_q = jnp.clip(jnp.round(q / j_scale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q_q.numpy(), np.asarray(j_q))
    assert q_scale.item() == float(j_scale)


@pytest.mark.parametrize("batched", [False, True])
def test_dense_scores_int8_bit_equal(batched):
    emb, valid, qs = _corpus(1)
    jq, js = jd.quantize_corpus_int8(emb)
    args = (jnp.asarray(jq), jnp.asarray(js))
    one = lambda q: jd.dense_scores_int8(*args, q, jnp.asarray(valid))
    want = np.asarray(jax.vmap(one)(jnp.asarray(qs)) if batched else one(jnp.asarray(qs[0])))
    got = td.dense_scores_int8(_t(jq), _t(js), _t(qs if batched else qs[0]), _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isneginf(got.numpy()[..., -10:]).all()


@pytest.mark.parametrize("pool", [1, 40, 400])
def test_dense_topk_int8_bit_equal(pool):
    emb, valid, qs = _corpus(2)
    jq, js = jd.quantize_corpus_int8(emb)
    for b in range(len(qs)):
        jsc, jid = jd.dense_topk_int8(jnp.asarray(jq), jnp.asarray(js), jnp.asarray(qs[b]),
                                      jnp.asarray(valid), pool)
        tsc, tid = td.dense_topk_int8(_t(jq), _t(js), _t(qs[b]), _t(valid), pool)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    bs, bi = td.dense_topk_int8(_t(jq), _t(js), _t(qs), _t(valid), pool)
    np.testing.assert_array_equal(bi[4].numpy(), tid.numpy())


@pytest.mark.parametrize("stripes", [32, 64, 300, 1000])
def test_striped_int8_bit_equal(stripes):
    """Slices and the striped scan for every query and the batch; a stripe
    count that does not divide N pads the last slice."""
    emb, valid, qs = _corpus(3)
    jq, js = jd.quantize_corpus_int8(emb)
    jsl = jd.slice_corpus_for_striped_int8(jnp.asarray(jq), jnp.asarray(js),
                                           jnp.asarray(valid), stripes)
    tsl = td.slice_corpus_for_striped_int8(_t(jq), _t(js), _t(valid), stripes)
    for a, b in zip(jsl, tsl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    f = jax.vmap(lambda q: jd.dense_striped_topk_scan_int8(*jsl, q, 50))
    want_s, want_i = (np.asarray(x) for x in f(jnp.asarray(qs)))
    got_s, got_i = td.dense_striped_topk_scan_int8(*tsl, _t(qs), 50)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    for b in range(len(qs)):
        s1, i1 = td.dense_striped_topk_scan_int8(*tsl, _t(qs[b]), 50)
        np.testing.assert_array_equal(i1.numpy(), want_i[b])
        np.testing.assert_array_equal(s1.numpy(), want_s[b])


@pytest.mark.parametrize("m,k,n", [(1, 384, 256), (16, 64, 320), (17, 24, 8), (3, 20, 13),
                                   (33, 7, 1), (128, 384, 1000)])
def test_int8_matmul_pads_to_what_cublaslt_takes(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = td.int8_matmul(_t(a), _t(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_device_arrays_and_footprint_int8(engines):
    """emb_q + emb_scale in place of emb, as the JAX package's, with the
    same footprint per array."""
    from review_recommender_tpu_torch.index.schema import footprint_total

    _je, te = engines["exact"]
    p = te.bundle.products
    arrays = p.device_arrays(torch.device("cpu"), torch.bfloat16, quantize_int8=True)
    assert "emb" not in arrays and arrays["emb_q"].dtype == torch.int8
    assert arrays["emb_scale"].dtype == torch.float32
    jarrays = _je.arrays
    np.testing.assert_array_equal(arrays["emb_q"].numpy(), np.asarray(jarrays["emb_q"]))
    np.testing.assert_array_equal(arrays["emb_scale"].numpy(), np.asarray(jarrays["emb_scale"]))
    fp = te.bundle.device_footprint(torch.bfloat16, quantize_int8=True)
    jfp = _je.bundle.device_footprint(jnp.bfloat16, quantize_int8=True)
    assert fp == jfp
    _fp, total = footprint_total(te.bundle, torch.bfloat16, quantize_int8=True, striped=True)
    assert total == sum(fp.values()) + fp["emb_q"] + fp["emb_scale"]
    assert te.rev_arrays["rev_emb"].dtype == torch.bfloat16  # the rest stays bf16


@pytest.mark.parametrize("rerank_k", [0, 50])
@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_run_search_int8_matches_jax(engines, pool, rerank_k):
    je, te = engines[pool]
    assert te.int8_mode and je.int8_mode and "emb" not in te.arrays
    cases.check_run_search(je, te, rerank_k)


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_fused_forms_int8_match_jax(engines, pool):
    cases.check_fused_forms(*engines[pool])


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_search_dense_int8_matches_jax(engines, pool):
    cases.check_search_dense(*engines[pool])


@pytest.mark.parametrize("pool", ["exact", "striped"])
def test_e2e_and_coalesced_rerank_int8_match_jax(engines, pool):
    cases.check_e2e_and_coalesced(*engines[pool])


def test_striped_int8_pool_is_approximate(engines):
    """At 320 rows over 160 stripes the striped int8 pool keeps a different
    row set from the exact int8 pool, with the same scores for the rows it
    keeps."""
    q = torch.from_numpy(engines["exact"][1].encode_query(cases.QUERIES[0]))
    (es, ei), (ss, si) = (engines[p][1]._dense_topk(engines[p][1].arrays, q, 150)
                          for p in ("exact", "striped"))
    assert set(ei.tolist()) != set(si.tolist())
    exact_by_row = dict(zip(ei.tolist(), es.tolist()))
    shared = [(exact_by_row[r], s) for r, s in zip(si.tolist(), ss.tolist()) if r in exact_by_row]
    assert len(shared) > 100
    assert all(a == b for a, b in shared)


def test_ivf_with_int8_raises_as_in_jax(engines):
    je, te = engines["exact"]
    with pytest.raises(ValueError, match="ivf needs a bf16/f32 corpus"):
        JaxEngine(je.bundle, emb_dtype="int8", dense_pool="ivf")
    with pytest.raises(ValueError, match="ivf needs a bf16/f32 corpus"):
        SearchEngine(te.bundle, device="cpu", emb_dtype="int8", dense_pool="ivf")
