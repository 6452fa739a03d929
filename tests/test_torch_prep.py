"""The port's product aggregation and snippet filter
(review_recommender_tpu_torch/data/prep.py) against the JAX package's
`data/prep.py`, on the merged tables of every case of
tests/torch_raw_cases.py (each package's own normalize_merge, held equal in
tests/test_torch_etl.py).

`build_products`: skus, n_reviews, avg_stars (bit-equal, NaN where pandas
holds NA), last_ts (None where pandas holds NaN) and agg_text equal.
`filter_reviews_for_snippets` at caps 0 (off), 2 and the config default:
every column of the kept rows equal, in the same order. `normalize_text`
and `looks_spammy` equal on edge strings.
"""
import numpy as np
import pytest

from review_recommender_tpu.data import etl as J
from review_recommender_tpu.data import prep as JP
from review_recommender_tpu_torch.data import etl as T
from review_recommender_tpu_torch.data import prep as TP
from tests import torch_raw_cases as RC
from tests.test_torch_etl import assert_tables_equal

PRODUCT_COLUMNS = ["sku", "n_reviews", "avg_stars", "last_ts", "agg_text"]
_MERGED = {}


def merged(case, tmp_path_factory):
    """(JAX DataFrame, port table) of a case, made once per case."""
    if case not in _MERGED:
        d = tmp_path_factory.mktemp(case)
        inputs, _ = RC.write_case(case, d / "in")
        _MERGED[case] = (J.normalize_merge(inputs, d / "j.parquet"),
                         T.normalize_merge(inputs, d / "t.npz"))
    return _MERGED[case]


@pytest.mark.parametrize("case", RC.CASES)
def test_build_products_equal_jax(case, tmp_path_factory):
    jm, tm = merged(case, tmp_path_factory)
    jp, tp = JP.build_products(jm), TP.build_products(tm)
    assert len(jp) == len(tp["sku"]) > 0
    assert tp["n_reviews"].dtype == np.int64
    assert_tables_equal(jp, tp, PRODUCT_COLUMNS)


@pytest.mark.parametrize("cap", [0, 2, None])
@pytest.mark.parametrize("case", RC.CASES)
def test_filter_reviews_for_snippets_equal_jax(case, cap, tmp_path_factory):
    jm, tm = merged(case, tmp_path_factory)
    jf, tf = JP.filter_reviews_for_snippets(jm, cap), TP.filter_reviews_for_snippets(tm, cap)
    assert len(jf) == len(tf["id"])
    assert_tables_equal(jf, tf)


def test_top_k_and_cap_cut_the_big_sku(tmp_path_factory):
    """The 270-review sku keeps 80 texts in agg_text (under the 4,000
    character cap) and at most the cap in the snippet set."""
    jm, tm = merged("top80_and_cap", tmp_path_factory)
    products = TP.build_products(tm, agg_char_cap=100_000)
    big = products["sku"].index("BIG")
    assert products["n_reviews"][big] == 270
    assert products["agg_text"][big].count("review number") == 80
    assert products["agg_text"][big] == JP.build_products(jm, agg_char_cap=100_000)["agg_text"][big]
    for cap in (5, 256):
        kept = TP.filter_reviews_for_snippets(tm, cap)["sku"]
        assert kept.count("BIG") == min(cap, 270)


@pytest.mark.parametrize("text", ["  Hello\tWORLD\n again ", "ÀÉÎ  ÕÜ", "", "a b c",
                                  "x" * 9 + " " * 3, "İstanbul ǅ"])
def test_normalize_text_equal_jax(text):
    assert TP.normalize_text(text) == JP.normalize_text(text)


@pytest.mark.parametrize("text", ["visit https://x.example", "WWW.example.com", "www.ok",
                                  "Promo Code inside", "aaaaaaa", "aaaaaaaa", "!!!!!!!!",
                                  "an honest review", "AFFILIATE", "sponsor", 12345678])
def test_looks_spammy_equal_jax(text):
    assert TP.looks_spammy(text) == JP.looks_spammy(text)
