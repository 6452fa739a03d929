"""The quality table's bow lane on the port
(review_recommender_tpu_torch/evals/quality_table.py, evals/benchmark.py,
evals/queries.py) against the JAX lane (examples/quality_table.py --lane
bow and the JAX evals package).

The port's copy of the corpus generator equals the example's (products and
judged queries, two seeds; keyword_query's draws), and its lane at 8
themes x 32 products x 12 queries on the CPU gives the JAX lane's
aggregate metrics exactly for all four methods, with the same table rows
and CSV columns, under the exact pool and under --dense-pool ivf:8.
The trained lane at that size (4 MLM steps, 64 pairs) runs on the port and
in JAX (XLA attention on the CPU): the same training sets, the three
methods without rerank equal to JAX's, and finite numbers with the port's
trained cross-encoder; make_family_positives equals the example's.
"""
import argparse
import csv
import json

import numpy as np
import pytest

from examples import quality_table as jax_qt
from review_recommender_tpu.evals import benchmark as jax_bench
from review_recommender_tpu.evals import queries as jax_queries
from review_recommender_tpu_torch.evals import benchmark as port_bench
from review_recommender_tpu_torch.evals import queries as port_queries
from review_recommender_tpu_torch.evals import quality_table as port_qt


@pytest.mark.parametrize("seed", [0, 3])
def test_build_corpus_copy_equals_the_example(seed):
    assert port_qt.build_corpus(6, 24, 9, seed=seed) == jax_qt.build_corpus(6, 24, 9, seed=seed)
    products, _q = port_qt.build_corpus(6, 24, 9, seed=seed)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    texts = [p["agg_text"] for p in products[:40]] + ["too few words"]
    assert [port_qt.keyword_query(r1, t) for t in texts] == \
        [jax_qt.keyword_query(r2, t) for t in texts]


def test_query_suite_matches_jax():
    assert port_queries.BENCHMARK_CONFIGS == jax_queries.BENCHMARK_CONFIGS
    assert port_queries.TEST_QUERIES == jax_queries.TEST_QUERIES
    products, _q = port_qt.build_corpus(4, 16, 2)
    skus, texts = [p["sku"] for p in products], [p["agg_text"] for p in products]
    for kw in (dict(n_queries=5), dict(n_queries=3, keywords_per_query=2, relevant_per_query=3,
                                       seed=4)):
        got = port_queries.synthetic_ground_truth(skus, texts, **kw)
        assert got == jax_queries.synthetic_ground_truth(skus, texts, **kw)
    judged = port_queries.attach_ground_truth(port_queries.TEST_QUERIES, {"q01": [skus[0], "X"]})
    assert judged == jax_queries.attach_ground_truth(jax_queries.TEST_QUERIES,
                                                     {"q01": [skus[0], "X"]})
    assert port_queries.validate_ground_truth(judged, skus) == \
        jax_queries.validate_ground_truth(judged, skus)


def test_bow_lane_matches_the_jax_lane(tmp_path):
    args = ["--themes", "8", "--per-theme", "32", "--queries", "12"]
    assert port_qt.main(args + ["--device", "cpu", "--out", str(tmp_path / "port")]) == 0
    assert jax_qt.main(args + ["--lane", "bow", "--out", str(tmp_path / "jax")]) == 0
    got, want = (json.loads((tmp_path / d / "benchmark_results.json").read_text())
                 for d in ("port", "jax"))
    assert list(got) == list(want) == list(port_queries.BENCHMARK_CONFIGS)
    for method in want:
        assert got[method]["aggregate"] == want[method]["aggregate"], method
    rows = lambda d: (tmp_path / d / "readme_table.md").read_text().splitlines()[:5]
    assert rows("port") == rows("jax")
    header = lambda d: next(csv.reader(open(tmp_path / d / "detailed_results.csv")))
    assert header("port") == header("jax")


def test_bow_lane_under_ivf_matches_the_jax_lane(tmp_path, monkeypatch):
    """--dense-pool ivf:8 (IVF_NPROBE=8 for the lane) gives the JAX lane's
    aggregates and table; the port restores IVF_NPROBE after its lane (the
    JAX example leaves its knob changed, so it is put back here). The JAX
    example sets the knob on `review_recommender_tpu.config.config`, which
    tests/test_config.py replaces by reloading the module while the JAX
    engine keeps the object it imported, so that module attribute is
    pointed at the engine's object for this test."""
    from review_recommender_tpu import config as jax_config_module
    from review_recommender_tpu.engine import search as jax_search
    from review_recommender_tpu_torch.config import config as port_config

    jax_config = jax_search.config
    monkeypatch.setattr(jax_config_module, "config", jax_config)

    args = ["--themes", "8", "--per-theme", "32", "--queries", "12", "--dense-pool", "ivf:8"]
    knob = lambda: (port_config.IVF_NPROBE, vars(port_config).get("IVF_NPROBE"))
    before = knob()  # the value, and the instance's own value if it has one
    jax_before = jax_config.IVF_NPROBE
    try:
        assert port_qt.main(args + ["--device", "cpu", "--out", str(tmp_path / "port")]) == 0
        assert knob() == before
        assert jax_qt.main(args + ["--lane", "bow", "--out", str(tmp_path / "jax")]) == 0
        assert jax_config.IVF_NPROBE == 8
    finally:
        vars(jax_config).pop("IVF_NPROBE", None)
    assert jax_config.IVF_NPROBE == jax_before
    got, want = (json.loads((tmp_path / d / "benchmark_results.json").read_text())
                 for d in ("port", "jax"))
    for method in want:
        assert got[method]["aggregate"] == want[method]["aggregate"], method
    rows = lambda d: (tmp_path / d / "readme_table.md").read_text().splitlines()[:5]
    assert rows("port") == rows("jax")


@pytest.mark.parametrize("spec,ok", [("ivf:16", True), ("exact", True), ("ivf:0", False),
                                     ("striped:4", False), ("hnsw", False)])
def test_dense_pool_spec(spec, ok):
    if ok:
        assert port_qt._pool_spec(spec) == spec
    else:
        with pytest.raises(argparse.ArgumentTypeError):
            port_qt._pool_spec(spec)


def test_family_positives_copy_equals_the_example():
    from examples.rerank_experiments import make_family_positives

    products, _q = port_qt.build_corpus(4, 16, 2)
    vocab = sorted({w for p in products[:16] for w in p["agg_text"].split()})
    for n in (1, 2, 3):
        r1, r2 = np.random.default_rng(n), np.random.default_rng(n)
        for p in products[:8]:
            assert port_qt.make_family_positives(p["agg_text"], vocab, r1, n_variants=n) == \
                make_family_positives(p["agg_text"], vocab, r2, n_variants=n)


def test_trained_lane_runs_beside_the_jax_lane(tmp_path, monkeypatch, capsys):
    import functools

    few = dict(mlm_steps=4, n_pairs=64)
    monkeypatch.setattr(port_qt, "build_trained_towers",
                        functools.partial(port_qt.build_trained_towers, **few))
    monkeypatch.setattr(jax_qt, "build_trained_towers",
                        functools.partial(jax_qt.build_trained_towers, **few))
    args = ["--themes", "8", "--per-theme", "32", "--queries", "12", "--lane", "trained"]
    assert port_qt.main(args + ["--device", "cpu", "--out", str(tmp_path / "port")]) == 0
    port_log = capsys.readouterr().err
    assert jax_qt.main(args + ["--out", str(tmp_path / "jax")]) == 0
    jax_log = capsys.readouterr().err
    sizes = lambda log: [line for line in log.splitlines() if "family-variant" in line]
    assert sizes(port_log) == sizes(jax_log) and len(sizes(port_log)) == 1
    got, want = (json.loads((tmp_path / d / "benchmark_results.json").read_text())
                 for d in ("port", "jax"))
    assert list(got) == list(want) == list(port_queries.BENCHMARK_CONFIGS)
    for method in want:
        if "Rerank" not in method:
            assert got[method]["aggregate"] == want[method]["aggregate"], method
    rerank = got["Hybrid + Rerank"]["aggregate"]
    assert all(np.isfinite(rerank[k]) for k in ("ndcg@10", "mrr", "recall@20"))
    table = (tmp_path / "port" / "readme_table.md").read_text()
    assert "Hybrid + Rerank" in table and "nan" not in table.lower()


def test_benchmark_runner_matches_jax_on_fixed_rankings():
    """run_performance_benchmark over a search function with fixed
    rankings (rows, or run_search's triple) aggregates as the JAX one."""
    products, queries = port_qt.build_corpus(4, 16, 6)
    skus = [p["sku"] for p in products]
    rng = np.random.default_rng(0)
    ranking = {q["query"]: [skus[i] for i in rng.permutation(len(skus))[:20]] + q["relevant_skus"]
               for q in queries}
    port_fn = lambda q, **cfg: ([{"sku": s} for s in ranking[q][cfg["k"] // 10:]], {}, {})
    jax_fn = lambda q, **cfg: ranking[q][cfg["k"] // 10:]
    got = port_bench.run_performance_benchmark(port_fn, queries, rpc_floor_ms=0.5)
    want = jax_bench.run_performance_benchmark(jax_fn, queries, rpc_floor_ms=0.5)
    for m in want:
        assert got[m]["aggregate"] == want[m]["aggregate"]
        assert got[m]["detail"] == want[m]["detail"].to_dict(orient="records")
        assert set(got[m]["latency"]) == set(want[m]["latency"])


def test_benchmark_main_matches_jax_main(tmp_path, capsys):
    """evals/benchmark.py:main on a bundle the JAX package saved: its index
    and ground-truth lines equal the JAX main's, and BM25 Only, which reads
    no tower, gives the JAX aggregates and per-query rows. The other
    methods rank with each framework's own random tower, so they are held
    to the same methods and finite metrics."""
    from review_recommender_tpu.index.build import build_bundle_from_products
    from review_recommender_tpu.index.io import save_bundle
    from tests.torch_bundle_cases import corpus

    products, _q, emb = corpus(dim=32)
    d = tmp_path / "bundle"
    save_bundle(build_bundle_from_products(products, emb, doc_terms_cap=64, pad_multiple=16), d)
    args = ["--index-dir", str(d), "--synthetic-queries", "4"]
    assert jax_bench.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert port_bench.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert port_lines[:2] == jax_lines[:2]
    assert json.loads(port_lines[0])["index"]["ok"]
    got, want = (json.loads((tmp_path / o / "benchmark_results.json").read_text())
                 for o in ("port", "jax"))
    assert list(got) == list(want) == list(port_queries.BENCHMARK_CONFIGS)
    assert got["BM25 Only"]["aggregate"] == want["BM25 Only"]["aggregate"]
    assert all(np.isfinite(v) for m in got for v in got[m]["aggregate"].values())
    detail = lambda o: [r for r in csv.DictReader(open(tmp_path / o / "detailed_results.csv"))
                        if r["method"] == "BM25 Only"]
    assert detail("port") == detail("jax") and len(detail("port")) == 4
