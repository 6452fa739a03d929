"""The port's raw-review pipeline (`run_full_pipeline`,
`build_index_from_reviews` in review_recommender_tpu_torch/data/
pipeline.py) against the JAX package's, with tiny f32 towers carried from a
JAX BiEncoder by params_from_flax (tests/test_torch_embed_job.py).

Both bundles are read back with the port's `load_bundle` (the JAX one from
its parquet). Held equal: skus, n_reviews, avg_stars, last_ts, agg_text,
the postings, df, idf, eager BM25 arrays, gate bits and the review index
(texts, stars, segments, mask); the embeddings within 1e-5; the work
directory's merged table against the JAX parquet.

The JAX pipeline raises where a snippet review has a null star or a
product has none (pandas' NA reaches float(): ROADMAP Queue 3), so on
dumps with null stars the JAX side runs its own stages with the merged
table's stars cast to float64 first, the one change that lets it run;
that fault is pinned by a test of its own, as is the "nan" last_ts of a
product whose reviews carry no timestamp. The resume test deletes two
shards, leaves a torn temp file and checks that only those shards are
encoded again and the bundle is unchanged.
"""
import functools
import logging

import numpy as np
import pandas as pd
import pytest

from review_recommender_tpu.data import etl as J
from review_recommender_tpu.data import pipeline as JPipe
from review_recommender_tpu_torch.data import embed_job as TE
from review_recommender_tpu_torch.data import pipeline as TPipe
from review_recommender_tpu_torch.data.pipeline import read_table
from review_recommender_tpu_torch.index.io import load_bundle
from review_recommender_tpu_torch.ops import attention
from tests import torch_raw_cases as RC
from tests.test_torch_embed_job import EMB_TOL, carried_towers
from tests.test_torch_etl import assert_tables_equal
from tests.torch_bundle_cases import PRODUCT_ARRAYS

CAP = 64


@pytest.fixture(scope="module")
def towers():
    return carried_towers()


def _has_null_stars(merged: pd.DataFrame) -> bool:
    return bool(merged["stars"].isna().any())


def _jax_build(inputs, jbe, out):
    """JAX run_full_pipeline; on dumps with a null star its stages with
    the stars cast to float64 (module docstring)."""
    merged = J.normalize_merge(inputs, out / "_work" / "reviews_merged.parquet")
    if not _has_null_stars(merged):
        return JPipe.run_full_pipeline(inputs, jbe, out, doc_terms_cap=CAP)
    merged["stars"] = merged["stars"].astype("float64")
    return JPipe.build_index_from_reviews(merged, jbe, out, doc_terms_cap=CAP)


def assert_built_bundles_equal(a, b):
    """a, b: bundles read by the port's load_bundle. Embeddings within
    EMB_TOL, everything else equal."""
    pa, pb = a.products, b.products
    for f in PRODUCT_ARRAYS:
        x, y = getattr(pa, f), getattr(pb, f)
        assert (x is None) == (y is None), f
        if x is None:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if f == "emb":
            np.testing.assert_allclose(x, y, rtol=0, atol=EMB_TOL)
        else:
            assert np.array_equal(x, y, equal_nan=True), f
    for f in ("skus", "agg_texts", "last_ts", "vocab", "avgdl", "n_docs"):
        assert getattr(pa, f) == getattr(pb, f), f
    ra, rb = a.reviews, b.reviews
    assert (ra is None) == (rb is None)
    if ra is not None:
        np.testing.assert_allclose(ra.rev_emb, rb.rev_emb, rtol=0, atol=EMB_TOL)
        for f in ("rev_product", "rev_valid", "rev_stars"):
            assert np.array_equal(getattr(ra, f), getattr(rb, f), equal_nan=True), f
        assert list(ra.rev_texts) == list(rb.rev_texts)
        assert ra.n_reviews_total == rb.n_reviews_total
    assert a.meta == b.meta == {"built_from": "pipeline"}


@pytest.mark.parametrize("case", RC.FULL_PIPELINE_CASES)
def test_run_full_pipeline_equal_jax(case, towers, tmp_path):
    jbe, tbe = towers
    inputs, _ = RC.write_case(case, tmp_path / "in")
    _jax_build(inputs, jbe, tmp_path / "j")
    TPipe.run_full_pipeline(inputs, tbe, tmp_path / "t", doc_terms_cap=CAP)
    a, b = load_bundle(tmp_path / "j"), load_bundle(tmp_path / "t", verify_checksums=True)
    assert_built_bundles_equal(a, b)
    assert b.products.doc_bm25 is not None and b.reviews is not None
    assert_tables_equal(pd.read_parquet(tmp_path / "j" / "_work" / "reviews_merged.parquet"),
                        read_table(tmp_path / "t" / "_work" / "reviews_merged.npz", None))
    for job in ("product_emb", "review_emb"):
        assert TE.job_status(tmp_path / "t" / "_work" / job)["complete"]


@pytest.mark.parametrize("options", [dict(with_snippets=False), dict(eager_bm25=False),
                                     dict(doc_terms_cap=0)])
def test_build_options_equal_jax(options, towers, tmp_path):
    jbe, tbe = towers
    inputs, _ = RC.write_case("ties", tmp_path / "in")
    jm = J.normalize_merge(inputs, tmp_path / "j.parquet")
    jm["stars"] = jm["stars"].astype("float64")
    tm = TPipe.normalize_merge(inputs, tmp_path / "t.npz")
    kw = {"doc_terms_cap": CAP, **options}
    JPipe.build_index_from_reviews(jm, jbe, tmp_path / "j", **kw)
    TPipe.build_index_from_reviews(tm, tbe, tmp_path / "t", **kw)
    assert_built_bundles_equal(load_bundle(tmp_path / "j"), load_bundle(tmp_path / "t"))


def test_fault_null_stars_raise_in_jax_nan_in_the_port(towers, tmp_path):
    """ROADMAP Queue 3: JAX hands pandas' NA to float() for a product with
    no star (avg_stars) and for a snippet review without one; the port
    gives NaN there, and the product is still built."""
    jbe, tbe = towers
    inputs, _ = RC.write_case("all_null_stars", tmp_path / "in")
    with pytest.raises(TypeError, match="NAType"):
        JPipe.run_full_pipeline(inputs, jbe, tmp_path / "j", doc_terms_cap=CAP)
    ties, _ = RC.write_case("ties", tmp_path / "ties")  # null stars beside stars
    jm = J.normalize_merge(ties, tmp_path / "m.parquet")
    JPipe.build_index_from_reviews(jm, jbe, tmp_path / "j2", doc_terms_cap=CAP,
                                   with_snippets=False)
    with pytest.raises(TypeError, match="NAType"):
        JPipe.build_index_from_reviews(jm, jbe, tmp_path / "j3", doc_terms_cap=CAP)
    b = TPipe.run_full_pipeline(inputs, tbe, tmp_path / "t", doc_terms_cap=CAP)
    row = b.products.skus.index("N0")
    assert np.isnan(b.products.avg_stars[row]) and b.products.n_reviews[row] == 2
    assert np.isnan(b.reviews.rev_stars[: b.reviews.n_reviews_total]).sum() == 2


def test_fault_product_without_timestamps_gets_last_ts_nan(towers, tmp_path):
    """ROADMAP Queue 3: a product whose reviews carry no timestamp has a
    null last_ts in build_products, which the JAX builder stores as str of
    NaN, "nan"; the port stores the same."""
    jbe, tbe = towers
    inputs, _ = RC.write_case("all_null_stars", tmp_path / "in")
    jm = J.normalize_merge(inputs, tmp_path / "j.parquet")
    jm["stars"] = jm["stars"].astype("float64")
    JPipe.build_index_from_reviews(jm, jbe, tmp_path / "j", doc_terms_cap=CAP)
    TPipe.run_full_pipeline(inputs, tbe, tmp_path / "t", doc_terms_cap=CAP)
    a, b = load_bundle(tmp_path / "j"), load_bundle(tmp_path / "t")
    row = b.products.skus.index("N1")
    assert a.products.last_ts[row] == b.products.last_ts[row] == "nan"


def test_resume_encodes_only_the_missing_shards(towers, tmp_path, monkeypatch):
    """Two shards of the product job deleted and a torn temp file left:
    job_status reports them missing, the rebuild encodes exactly those
    shards (their batches, each a tower forward of 2 attention calls) and
    the bundle is unchanged."""
    _, tbe = towers
    inputs, _ = RC.write_case("random-2", tmp_path / "in")
    out = tmp_path / "t"
    # the jobs in shards of 8 rows (the pipeline keeps run_embed_job's 20,000)
    monkeypatch.setattr(TPipe, "run_embed_job",
                        functools.partial(TE.run_embed_job, shard_rows=8))
    TPipe.run_full_pipeline(inputs, tbe, out, doc_terms_cap=CAP)
    first = load_bundle(out)
    reviews = read_table(out / "_work" / "reviews_merged.npz", None)
    work = out / "_work" / "product_emb"
    n_shards = TE.job_status(work)["n_shards"]
    assert n_shards >= 3
    gone = [n_shards - 2, n_shards - 1]
    for i in gone:
        (work / f"emb_shard_{i:05d}.npy").unlink()
    np.save(work / f"emb_shard_{gone[0]:05d}.tmp.npy", np.zeros((3, 4), np.float32))
    status = TE.job_status(work)
    assert status["missing"] == gone and not status["complete"]
    n_rows = len(first.products.skus)
    rows = [min(8, n_rows - i * 8) for i in gone]
    calls = []
    real = attention.mha_reference
    monkeypatch.setattr(attention, "mha_reference",
                        lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    TPipe.build_index_from_reviews(reviews, tbe, out, doc_terms_cap=CAP)
    assert calls == [b for r in rows for b in [8 if r > 1 else 1] * tbe.cfg.num_layers]
    again = load_bundle(out)
    assert_built_bundles_equal(first, again)
    assert np.array_equal(first.products.emb, again.products.emb)


def test_each_stage_logs_one_record_in_order(towers, tmp_path, caplog):
    """run_full_pipeline ends each stage with one INFO record whose `stage`
    attribute names it (the records a handler times the stages by), and
    with_snippets=False skips the review stages."""
    _, tbe = towers
    inputs, _ = RC.write_case("random-2", tmp_path / "in")
    with caplog.at_level(logging.INFO, logger=TPipe.logger.name):
        TPipe.run_full_pipeline(inputs, tbe, tmp_path / "a", doc_terms_cap=CAP)
        TPipe.run_full_pipeline(inputs, tbe, tmp_path / "b", doc_terms_cap=CAP,
                                with_snippets=False)
    stages = [r.stage for r in caplog.records if r.name == TPipe.logger.name]
    first = ["etl", "aggregate", "product_encode", "build", "snippet_filter",
             "review_encode", "build", "save"]
    assert stages == first + ["etl", "aggregate", "product_encode", "build", "save"]
