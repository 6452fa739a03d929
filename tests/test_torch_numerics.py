"""The port's last public functions of the JAX package held to it on the
same numpy inputs: `utils/numerics.py`'s l2_normalize, minmax_normalize
and cosine_similarity_search, and `evals/metrics.py`'s
evaluate_ranking_methods, each imported as the package exports it.

Tolerances: the normalizations and the cosine scores are f32 op for op
(1e-6 relative, 1e-7 absolute: sums and divisions rounded in another
order); minmax's degenerate, non-finite and empty inputs come out exactly;
cosine ids, their order on ties (lower index first, as lax.top_k) and the
metrics are exact (the JAX sweep's means by pandas, the port's by numpy:
1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import review_recommender_tpu.evals as jevals
import review_recommender_tpu.utils as jutils
import review_recommender_tpu_torch.evals as tevals
import review_recommender_tpu_torch.utils as tutils

TOL = dict(rtol=1e-6, atol=1e-7)


def _rows(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("axis", [1, 0, -1])
def test_l2_normalize(axis):
    x = _rows(0, 40, 24)
    x[3] = 0.0  # a zero row: the eps floor
    x[5] *= 1e-20  # a norm below eps
    want = np.asarray(jutils.l2_normalize(jnp.asarray(x), axis=axis))
    got = tutils.l2_normalize(torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(jutils.l2_normalize(jnp.asarray(x), axis=axis, eps=1e-3))
    np.testing.assert_allclose(tutils.l2_normalize(torch.from_numpy(x), axis=axis, eps=1e-3)
                               .numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["random", "matrix", "ints", "constant", "near_constant",
                                  "inf", "nan", "empty", "one"])
def test_minmax_normalize(case):
    x = {"random": _rows(1, 1, 300)[0] * 5.0,
         "matrix": _rows(2, 7, 9),
         "ints": np.arange(-3, 9, dtype=np.int32),
         "constant": np.full(16, 2.5, np.float32),
         "near_constant": np.float32(1.0) + np.array([0, 1e-13, 0], np.float32),
         "inf": np.array([0.0, 1.0, np.inf], np.float32),
         "nan": np.array([0.0, np.nan, 2.0], np.float32),
         "empty": np.zeros((0,), np.float32),
         "one": np.array([7.0], np.float32)}[case]
    want = np.asarray(jutils.minmax_normalize(jnp.asarray(x)))
    got = tutils.minmax_normalize(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if case in ("random", "matrix", "ints"):
        np.testing.assert_allclose(got, want, **TOL)
        assert got.min() == 0.0 and got.max() <= 1.0
    else:  # degenerate, non-finite, empty: all zeros (or nothing), exactly
        assert np.array_equal(got, want) and not got.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 10, 64, 500])
def test_cosine_similarity_search(dtype, top_k):
    emb = _rows(3, 64, 32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[[10, 20, 30]] = emb[5]  # four equal rows: ties in index order
    q = emb[5] + 0.05 * _rows(4, 1, 32)[0]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ji, js = jutils.cosine_similarity_search(jnp.asarray(q), jnp.asarray(emb, jdt), top_k)
    ti, ts = tutils.cosine_similarity_search(torch.from_numpy(q), torch.from_numpy(emb).to(tdt),
                                             top_k)
    assert ti.shape == ts.shape == (min(top_k, 64),)  # top_k clamped to N
    assert ti.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert ti[:4].tolist() == [5, 10, 20, 30][:top_k]


_RANKED = {"alpha beta": ["s1", "s2", "s3", "s9"], "gamma": ["s7", "s4"], "delta": []}


def _sweep_inputs():
    queries = [{"id": "q1", "query": "alpha beta", "relevant_skus": ["s2", "s9", "s5"]},
               {"query": "gamma", "relevant_skus": ["s4"]},
               {"id": "q3", "query": "delta", "relevant_skus": ["s1"]}]
    configs = {"plain": {}, "cut": {"k": 2}, "tuple": {"as_tuple": True}}
    return queries, configs


def _search(form):
    """search_fn over _RANKED: ids, a tuple led by them, or rows (the port's
    dicts with a "sku" key, the JAX package's DataFrame)."""
    def fn(text, k=None, as_tuple=False):
        ids = _RANKED[text][:k]
        if as_tuple:
            return ids, {"stage_ms": {}}
        if form == "rows_jax":
            return pd.DataFrame({"sku": ids, "_final": np.linspace(1, 0, len(ids))})
        if form == "rows_port":
            return [{"sku": s, "_final": 1.0} for s in ids]
        return ids
    return fn


@pytest.mark.parametrize("form", ["ids", "rows"])
@pytest.mark.parametrize("k_values", [(5, 10, 20), (1, 3)])
def test_evaluate_ranking_methods(form, k_values):
    queries, configs = _sweep_inputs()
    want = jevals.evaluate_ranking_methods(
        _search("rows_jax" if form == "rows" else "ids"), queries, configs, k_values)
    got = tevals.evaluate_ranking_methods(
        _search("rows_port" if form == "rows" else "ids"), queries, configs, k_values)
    assert list(got) == list(want) == list(configs)
    for method in configs:
        wa, ga = want[method]["aggregate"], got[method]["aggregate"]
        assert list(ga) == list(wa) and ga["n_queries"] == wa["n_queries"] == 3
        for key in wa:
            assert ga[key] == pytest.approx(wa[key], abs=1e-12)
        assert got[method]["detail"] == want[method]["detail"].to_dict("records")
