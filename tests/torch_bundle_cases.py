"""Shared inputs and comparisons of the index-bundle tests of the port
(tests/test_torch_index_build.py, test_torch_io.py, test_torch_cli.py):
a small themed corpus from the port's copy of the quality table's
generator, seeded reviews, and field-by-field bundle equality; and a
fixture that runs a module's torch ops on one thread."""
import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.evals.quality_table import build_corpus
from review_recommender_tpu_torch.models.bow import BowProjectionEncoder

PRODUCT_ARRAYS = ("emb", "n_reviews", "avg_stars", "doc_terms", "doc_tf", "doc_len",
                  "gate_bits", "valid", "idf", "df", "doc_tokens", "doc_token_len", "doc_bm25")
PRODUCT_HOST = ("skus", "agg_texts", "vocab", "avgdl", "n_docs", "last_ts")
REVIEW_ARRAYS = ("rev_emb", "rev_product", "rev_valid", "rev_stars")
# texts that reach the gate phrases, the stop list and the non-ASCII route
EXTRA_TEXTS = [
    "Noise-Canceling YELLOW wireless headphones with a cat print, gold trim",
    "café crème socks for the naïve kitten",
    "Kelvin wood chair, won't squeak; it's the best 42 of 'em, in black",
]


def corpus(n_themes=4, per_theme=16, n_queries=4, seed=0, dim=64):
    """(products, queries, embeddings): the generator's products with
    EXTRA_TEXTS written over the first ones, embedded by the bow encoder."""
    products, queries = build_corpus(n_themes, per_theme, n_queries, seed=seed)
    for i, text in enumerate(EXTRA_TEXTS):
        products[i] = {**products[i], "agg_text": text}
    emb = BowProjectionEncoder(dim=dim, seed=7).encode([p["agg_text"] for p in products])
    return products, queries, emb


def reviews(products, n=300, seed=1, dim=64):
    """Review rows (sku, text, stars with NaNs; some skus not in the
    corpus) and their embeddings."""
    rng = np.random.default_rng(seed)
    skus = [p["sku"] for p in products] + ["NOT-A-SKU"]
    rows = [{"sku": skus[int(rng.integers(len(skus)))],
             "text": f"review {i} of {'great' if i % 3 else 'poor'} quality",
             "stars": float("nan") if i % 17 == 0 else float(rng.integers(1, 6))}
            for i in range(n)]
    return rows, rng.standard_normal((n, dim)).astype(np.float32)


def assert_products_equal(a, b):
    """Every array bit-equal (dtype and shape included), every host field equal."""
    for f in PRODUCT_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=True), f
    for f in PRODUCT_HOST:
        x, y = getattr(a, f), getattr(b, f)
        assert (list(x) if f == "agg_texts" else x) == (list(y) if f == "agg_texts" else y), f


def assert_bundles_equal(a, b):
    assert_products_equal(a.products, b.products)
    assert (a.reviews is None) == (b.reviews is None)
    if a.reviews is not None:
        for f in REVIEW_ARRAYS:
            x, y = getattr(a.reviews, f), getattr(b.reviews, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(x, y, equal_nan=True), f
        assert list(a.reviews.rev_texts) == list(b.reviews.rev_texts)
        assert a.reviews.n_reviews_total == b.reviews.n_reviews_total
    assert a.version == b.version and a.meta == b.meta


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the importing module's tests: the suite runs
    files in parallel workers, and a thread pool in every worker
    oversubscribes the cores, where small ops wait on each other (the
    shard sweep took 93 s against 11 s under such load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
