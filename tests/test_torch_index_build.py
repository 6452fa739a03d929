"""The port's offline index builder (review_recommender_tpu_torch/index/
build.py, the document tokenizer of utils/text.py and its C++ route in
native/) against the JAX package's, on the same inputs.

build_product_index on both of the port's routes (tokenizer="native",
the default, and "python") must give every array bit-equal (dtype and
shape included), the same vocabulary, df, idf and avgdl as the JAX
build_product_index: on the quality table's corpus, and on edge inputs
(an empty text, non-ASCII texts, a document over doc_terms_cap,
doc_terms_cap 0 = auto and 4, pad_multiple 16 and 256, last_ts).
build_bundle_from_products with reviews likewise.
"""
import numpy as np
import pytest

from review_recommender_tpu.index import build as jax_build
from review_recommender_tpu.native import build_postings_native as jax_postings
from review_recommender_tpu.native import tokenize_corpus_native as jax_tokenize_corpus
from review_recommender_tpu.utils import text as jax_text
from review_recommender_tpu_torch import native
from review_recommender_tpu_torch.index import build as port_build
from review_recommender_tpu_torch.utils import text as port_text
from tests.torch_bundle_cases import (
    EXTRA_TEXTS,
    assert_bundles_equal,
    assert_products_equal,
    corpus,
    reviews,
)

ROUTES = ["native", "python"]
LONG_DOC = " ".join(f"term{i}x" for i in range(300)) + " term1x term2x term2x"
EDGE_CASES = {
    "empty_text": dict(texts={0: "", 5: "   "}),
    "non_ascii": dict(texts={0: "café crème Socks naïve résumé", 1: "Kelvin wood été"}),
    "over_cap": dict(texts={0: LONG_DOC}, doc_terms_cap=64),
    "auto_cap": dict(texts={0: LONG_DOC}, doc_terms_cap=0),
    "cap_4": dict(doc_terms_cap=4),
    "pad_16": dict(pad_multiple=16),
    "pad_256": dict(pad_multiple=256),
    "last_ts": dict(last_ts=True),
}


def _columns(products, texts=None):
    rows = [dict(p) for p in products]
    for i, t in (texts or {}).items():
        rows[i]["agg_text"] = t
    return ([r["sku"] for r in rows], [r["agg_text"] for r in rows],
            [r["n_reviews"] for r in rows], [r["avg_stars"] for r in rows])


@pytest.fixture(scope="module")
def small():
    return corpus()


@pytest.mark.parametrize("route", ROUTES)
def test_build_matches_jax_on_the_quality_corpus(route):
    products, _q, emb = corpus(n_themes=8, per_theme=32, n_queries=12, dim=384)
    cols = _columns(products)
    jp = jax_build.build_product_index(*cols, emb, doc_terms_cap=128, pad_multiple=256)
    tp = port_build.build_product_index(*cols, emb, doc_terms_cap=128, pad_multiple=256,
                                        tokenizer=route)
    assert_products_equal(tp, jp)
    assert tp.gate_bits[: len(EXTRA_TEXTS)].any(axis=1).all()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_build_matches_jax_on_edge_inputs(small, case, route):
    products, _q, emb = small
    spec = dict(EDGE_CASES[case])
    cols = _columns(products, spec.pop("texts", None))
    if spec.pop("last_ts", False):
        spec["last_ts"] = [None if i % 3 == 0 else f"2024-01-{1 + i % 28:02d}"
                           for i in range(len(products))]
    kw = {"doc_terms_cap": 64, "pad_multiple": 32, **spec}
    jp = jax_build.build_product_index(*cols, emb, **kw)
    tp = port_build.build_product_index(*cols, emb, tokenizer=route, **kw)
    assert_products_equal(tp, jp)
    if case == "auto_cap":  # trimmed to the corpus P99, a multiple of 8
        assert tp.terms_cap % 8 == 0 and 32 <= tp.terms_cap < port_build.AUTO_CAP_CEILING
    if case == "over_cap":
        assert (tp.doc_terms[0] != 0).all() and tp.doc_tf[0, :3].tolist() == [3.0, 2.0, 1.0]


@pytest.mark.parametrize("route", ROUTES)
def test_bundle_with_reviews_matches_jax(small, route):
    products, _q, emb = small
    rrows, remb = reviews(products)
    jb = jax_build.build_bundle_from_products(products, emb, reviews=rrows,
                                              review_embeddings=remb, doc_terms_cap=64,
                                              pad_multiple=16)
    tb = port_build.build_bundle_from_products(products, emb, reviews=rrows,
                                               review_embeddings=remb, doc_terms_cap=64,
                                               pad_multiple=16, tokenizer=route)
    assert_bundles_equal(tb, jb)
    jax_build.attach_eager_bm25(jb.products)
    port_build.attach_eager_bm25(tb.products)
    assert_bundles_equal(tb, jb)


@pytest.mark.parametrize("counts", [[1], list(range(1, 200)), [600] * 50, [3] * 99 + [400]])
def test_derive_doc_terms_cap_matches_jax(counts):
    counts = np.asarray(counts)
    assert port_build.derive_doc_terms_cap(counts) == jax_build.derive_doc_terms_cap(counts)


TEXTS = EXTRA_TEXTS + ["", "a I x y", "The THE the", LONG_DOC, "it's cat's 42 4x4 don't-stop",
                       "naïve café", "Kelvin"]


@pytest.mark.parametrize("cap", [5000, 3])
def test_document_tokenizer_routes_match_jax(cap):
    """Both routes of tokenize_document and tokenize_corpus_native give the
    JAX package's tokens."""
    want = [jax_text._tokenize_document_py(t, cap) for t in TEXTS]
    assert [port_text.tokenize_document(t, cap, native=False) for t in TEXTS] == want
    assert [port_text.tokenize_document(t, cap) for t in TEXTS] == want
    assert native.tokenize_corpus_native(TEXTS, cap) == jax_tokenize_corpus(TEXTS, cap) == want
    assert port_text.DOC_STOP_WORDS == jax_text.DOC_STOP_WORDS
    assert port_text.DOC_TOKEN_CAP == jax_text.DOC_TOKEN_CAP


@pytest.mark.parametrize("cap", [64, 2])
def test_build_postings_native_matches_jax(cap):
    got, want = native.build_postings_native(TEXTS, cap), jax_postings(TEXTS, cap)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


def test_native_route_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path, small):
    """No quiet switch to Python: without a compiler the native route raises."""
    products, _q, emb = small
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-c++")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="not found"):
        port_build.build_product_index(*_columns(products), emb)
    with pytest.raises(RuntimeError, match="not found"):
        port_text.tokenize_document("wireless headphones")
    assert port_text.tokenize_document("wireless headphones", native=False) == [
        "wireless", "headphones"]


def test_build_rejects_unequal_columns_and_unknown_routes(small):
    products, _q, emb = small
    sku, text, nrev, stars = _columns(products)
    with pytest.raises(ValueError, match="unequal"):
        port_build.build_product_index(sku, text[:-1], nrev, stars, emb)
    with pytest.raises(ValueError, match="tokenizer"):
        port_build.build_product_index(sku, text, nrev, stars, emb, tokenizer="spacy")
    with pytest.raises(ValueError, match="review_embeddings"):
        port_build.build_bundle_from_products(products, emb, reviews=[])
