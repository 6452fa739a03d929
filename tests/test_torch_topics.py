"""The port's topic pipeline (review_recommender_tpu_torch/topics/ and the
CLI's `topics`) against the JAX package's, on the same seeded inputs,
torch on the CPU.

Host functions are held equal: TF-IDF terms and names (the port builds
each topic's rows dense on their own, so its means are the JAX means bit
for bit), LLM naming with its cache and retries, aspect rules, votes and
metrics with and without LLM aspects, quotes, cards (JSONL rows and the
returned rows equal to the JAX DataFrame's records, resume included),
the generator benchmark's report keys, and `kmeans_sanity` (exact on
planted clusters). `rrt topics` of both packages runs on one bundle the
JAX package saved (parquet meta: this machine has pyarrow), whose 180
reviews are four planted blobs of topic words plus noise: the k-means
lane, the density lane, `--llm dry`, and `--bench`; topic_cards.jsonl,
aspect_metrics.json and the parquet views are equal, and --bench prints
the same keys. Without pyarrow the port writes the same JSON files and
says on stderr which parquet files it skipped; `--shards 2` refuses.
"""
import json
import sys

import numpy as np
import pytest

from review_recommender_tpu import topics as J
from review_recommender_tpu.index.build import build_bundle_from_products as jax_build
from review_recommender_tpu.index.io import save_bundle as jax_save
from review_recommender_tpu.serve import cli as jax_cli
from review_recommender_tpu_torch import topics as T
from review_recommender_tpu_torch.index.io import convert
from review_recommender_tpu_torch.serve import cli as port_cli
from review_recommender_tpu_torch.topics import cards as port_cards
from review_recommender_tpu_torch.topics import naming as port_naming
from tests.test_engine_parity import make_corpus
from tests.test_topics import planted_clusters
from tests.torch_topic_cases import topic_reviews


@pytest.fixture(scope="module")
def jax_bundle_dir(tmp_path_factory):
    products, emb, _r, _re = make_corpus(n=24, dim=32, seed=11)
    rows, remb = topic_reviews([p["sku"] for p in products])
    d = tmp_path_factory.mktemp("topics") / "jax_bundle"
    jax_save(jax_build(products, emb, reviews=rows, review_embeddings=remb, pad_multiple=8,
                       doc_terms_cap=32), d)
    return d


TEXTS = ["battery life battery charge power great", "battery charging power bank charge",
         "sound quality bass audio great sound", "audio sound volume bass excellent",
         "", "the of and", "great great great value"]


@pytest.mark.parametrize("tids,kw", [
    ([0, 0, 1, 1, 2, 2, 3], {}),
    ([0, 0, 1, 1, 2, 2, 3], {"min_df": 1}),
    ([5, 5, 5, 1, 1, 1, 1], {"min_df": 1, "top_terms": 3}),
    ([0] * 7, {"min_df": 3}),
])
def test_tfidf_terms_and_names_match_jax(tids, kw):
    got = T.tfidf_topic_terms(TEXTS, tids, **kw)
    assert got == J.tfidf_topic_terms(TEXTS, tids, **kw)
    assert T.name_topics(got) == J.name_topics(got)


def test_tfidf_of_wordless_texts_matches_jax():
    texts, tids = ["", "a i", "!!"], [2, 0, 2]
    assert T.tfidf_topic_terms(texts, tids) == J.tfidf_topic_terms(texts, tids) == {0: [], 2: []}


def test_tfidf_on_review_sized_input_matches_jax():
    rows, _emb = topic_reviews([f"S{i}" for i in range(10)])
    texts = [r["text"] for r in rows]
    tids = np.random.default_rng(0).integers(0, 6, len(texts))
    assert T.tfidf_topic_terms(texts, tids) == J.tfidf_topic_terms(texts, tids)


def test_llm_naming_cache_and_fallback_match_jax(tmp_path):
    def flaky_factory():
        calls = {"n": 0}

        def flaky(terms):
            calls["n"] += 1
            if calls["n"] in (1, 4, 5, 6):
                raise RuntimeError("transient")
            return f"{terms[0].title()} & Co"
        return flaky, calls

    topic_terms = {0: ["battery", "charge"], 1: ["sound", "bass", "audio"], 2: []}
    outs = []
    for name, fn in (("port", T.name_topics_llm), ("jax", J.name_topics_llm)):
        flaky, calls = flaky_factory()
        cache = tmp_path / f"{name}.json"
        first = fn(topic_terms, flaky, cache_path=cache)
        n = calls["n"]
        again = fn(topic_terms, flaky, cache_path=cache)
        outs.append((first, again, n, calls["n"], json.loads(cache.read_text())))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == "Battery & Co" and outs[0][2] == outs[0][3]


def test_aspects_and_metrics_match_jax():
    for label in ("battery charge life", "weird unknown thing", "Shipping box", "great LOOKS"):
        assert T.map_label_to_aspect(label) == J.map_label_to_aspect(label)
    tids = [0, 0, 1, 1, 2, 3, 3, 7]
    stars = [1.0, 2.0, 5.0, float("nan"), float("nan"), 4.0, 3.0, 2.0]
    labels = {0: "battery charge", 1: "sound bass", 2: "soft fit", 3: "worth the price",
              9: "never used"}
    for aspects in (None, {0: "quality", 3: "pricing"}, {1: "", 2: "misc"}):
        got = T.aspect_metrics(tids, stars, labels, aspects=aspects)
        assert got == J.aspect_metrics(tids, stars, labels, aspects=aspects)
    assert T.aspect_metrics(tids, stars, labels)[0]["aspect"] == "battery"


def test_classify_aspects_llm_matches_jax(tmp_path):
    answers = iter(["quality", "Quality ", "sound", "nonsense", "boom", "price"] * 4)

    def voter(topic):
        a = next(answers)
        if a == "boom":
            raise RuntimeError("down")
        return a
    topics = {0: {"label": "battery"}, 1: {"label": "cheap price", "quotes": ["q"]}}
    port = port_naming.classify_aspects_llm(topics, voter, cache_path=tmp_path / "p.json")
    answers = iter(["quality", "Quality ", "sound", "nonsense", "boom", "price"] * 4)
    from review_recommender_tpu.topics.naming import classify_aspects_llm

    assert port == classify_aspects_llm(topics, voter, cache_path=tmp_path / "j.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


def test_pick_quotes_match_jax():
    emb, _ = planted_clusters(n_per=12, k=1, d=8)
    texts = [f"  quote number {i} about the product  " for i in range(12)]
    texts[3] = texts[2]
    texts[5] = ""
    texts[7] = "x" * 500
    center = emb.mean(axis=0)
    for kw in ({}, {"n_quotes": 5}, {"n_quotes": 20, "max_chars": 40}):
        assert T.pick_quotes(texts, emb, center, **kw) == J.pick_quotes(texts, emb, center, **kw)
    assert T.pick_quotes([], emb[:0], center) == []


def _topics(n=11):
    return [{"topic_id": (i * 7) % n, "label": f"label {i}", "n_reviews": i + 1,
             "quotes": [f" quote {i} " + "w" * (i * 30), f"second {i}"][: 1 + i % 2]}
            for i in range(n)]


def test_cards_rows_jsonl_and_resume_match_jax(tmp_path):
    topics = _topics()
    T.generate_topic_cards(topics[:6], tmp_path / "p" / "cards.jsonl",
                           parquet_out=tmp_path / "p.parquet")
    rows = T.generate_topic_cards(topics, tmp_path / "p" / "cards.jsonl", flush_every=2,
                                  parquet_out=tmp_path / "p.parquet")
    J.generate_topic_cards(topics[:6], tmp_path / "j" / "cards.jsonl",
                           parquet_out=tmp_path / "j.parquet")
    df = J.generate_topic_cards(topics, tmp_path / "j" / "cards.jsonl", flush_every=2,
                                parquet_out=tmp_path / "j.parquet")
    assert rows == df.to_dict("records")
    assert [r["topic_id"] for r in rows] == sorted(t["topic_id"] for t in topics)
    assert (tmp_path / "p" / "cards.jsonl").read_text() == \
        (tmp_path / "j" / "cards.jsonl").read_text()
    import pyarrow.parquet as pq

    assert pq.read_table(tmp_path / "p.parquet").to_pylist() == rows
    again = T.generate_topic_cards(topics, tmp_path / "p" / "cards.jsonl")  # nothing new
    assert again == rows


def test_cards_without_pyarrow_say_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    rows = port_cards.generate_topic_cards(_topics(3), tmp_path / "cards.jsonl",
                                           parquet_out=tmp_path / "cards.parquet")
    assert len(rows) == 3 and not (tmp_path / "cards.parquet").exists()
    assert "cards.parquet is not written" in capsys.readouterr().err


def test_benchmark_generator_report_keys_match_jax():
    configs = {"default": {}, "fast": {"n_quotes": 1, "max_chars": 12}}
    for topics in (_topics(), []):
        got = T.cards.benchmark_generator(topics, configs=configs, n_topics=3)
        from review_recommender_tpu.topics.cards import benchmark_generator

        want = benchmark_generator(topics, configs=configs, n_topics=3)
        assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in want.items()}
        assert [v["n_sampled"] for v in got.values()] == [v["n_sampled"] for v in want.values()]


def test_kmeans_sanity_matches_jax():
    emb, _ = planted_clusters()
    for kw in ({"k": 4, "sample": 100}, {"k": 6, "sample": 1000, "seed": 3}):
        assert T.kmeans_sanity(emb, device="cpu", **kw) == J.kmeans_sanity(emb, **kw)


def _run_topics(cli, bundle, out, extra, capsys):
    code = cli.main(["topics", "--index-dir", str(bundle), "--out", str(out), *extra])
    return code, capsys.readouterr()


LANES = {
    "kmeans": ["--k", "4", "--iters", "8", "--min-reviews", "1"],
    "density": ["--cluster", "density", "--min-samples", "5", "--min-cluster-size", "20",
                "--min-reviews", "1"],
    "kmeans_llm_dry": ["--k", "5", "--iters", "8", "--min-reviews", "3", "--n-quotes", "2",
                       "--llm", "dry"],
    "density_llm_dry": ["--cluster", "density", "--min-samples", "5", "--min-cluster-size",
                        "20", "--llm", "dry"],
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_rrt_topics_writes_what_the_jax_cli_writes(jax_bundle_dir, tmp_path, capsys, lane):
    import pyarrow.parquet as pq

    outs = {}
    for name, cli, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / name
        code, _io = _run_topics(cli, jax_bundle_dir, out, LANES[lane] + extra, capsys)
        assert code == 0, name
        outs[name] = out
    for f in ("topic_cards.jsonl", "aspect_metrics.json"):
        assert (outs["port"] / f).read_text() == (outs["jax"] / f).read_text(), f
    for f in ("topic_cards.parquet", "topics.parquet"):
        assert pq.read_table(outs["port"] / f).to_pylist() == \
            pq.read_table(outs["jax"] / f).to_pylist(), f
    cards = [json.loads(line) for line in (outs["port"] / "topic_cards.jsonl").open()]
    assert len(cards) >= 3 and len({c["label"] for c in cards}) == len(cards)
    if "llm" in lane:
        cache = json.loads((outs["port"] / "_llm_topic_cache.json").read_text())
        assert cache == json.loads((outs["jax"] / "_llm_topic_cache.json").read_text())


def test_rrt_topics_bench_prints_the_jax_keys(jax_bundle_dir, capsys):
    reports = []
    for cli, extra in ((jax_cli, []), (port_cli, ["--device", "cpu"])):
        code, io = _run_topics(cli, jax_bundle_dir, "unused",
                               ["--bench", "--k", "4", "--iters", "8", "--min-reviews", "1",
                                "--sample-bench", "2", *extra], capsys)
        assert code == 0
        reports.append(json.loads(io.out))
    port, jax = reports
    assert port["n_topics"] == jax["n_topics"] >= 1
    assert {k: set(v) for k, v in port["configs"].items()} == \
        {k: set(v) for k, v in jax["configs"].items()} and set(port["configs"]) == {"default",
                                                                                     "fast"}


def test_rrt_topics_without_pyarrow_and_resume(jax_bundle_dir, tmp_path, capsys, monkeypatch):
    port_dir = convert(jax_bundle_dir, tmp_path / "port_bundle")
    _run_topics(jax_cli, jax_bundle_dir, tmp_path / "jax", LANES["kmeans"], capsys)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    argv = LANES["kmeans"] + ["--device", "cpu"]
    code, io = _run_topics(port_cli, port_dir, tmp_path / "port", argv, capsys)
    assert code == 0
    assert "topic_cards.parquet is not written" in io.err and "topics.parquet" in io.err
    assert not list((tmp_path / "port").glob("*.parquet"))
    for f in ("topic_cards.jsonl", "aspect_metrics.json"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f
    before = (tmp_path / "port" / "topic_cards.jsonl").read_text()
    assert _run_topics(port_cli, port_dir, tmp_path / "port", argv, capsys)[0] == 0
    assert (tmp_path / "port" / "topic_cards.jsonl").read_text() == before  # resumed


def test_rrt_topics_refusals(jax_bundle_dir, tmp_path, capsys):
    """Too large a min cluster size finds no clusters and exits 1, on one
    shard and over two (the sharded graph, which --shards 2 now builds)."""
    for shards in ("1", "2"):
        code, io = _run_topics(port_cli, jax_bundle_dir, tmp_path / "none",
                               ["--cluster", "density", "--min-cluster-size", "1000",
                                "--shards", shards, "--device", "cpu"], capsys)
        assert code == 1 and "no clusters" in io.err, shards
