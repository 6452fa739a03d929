"""The port's CLI (review_recommender_tpu_torch/serve/cli.py) on a tiny
saved bundle, on the CPU (--device cpu).

`search --json-out` writes the rows of an in-process run_search on the
engine `_load_engine` builds (random towers of the JAX CLI's shapes,
seeded); `eval` gives run_performance_benchmark's aggregates; `audit`
exits 0 on a good bundle and 1 on a damaged one; `bench` prints its JSON;
`serve` in a subprocess answers /healthz, /readyz, /search and `health`,
and stops on SIGTERM, for both front ends, and over 2 shards (--shards
2); --native without a buildable library raises (`topics`
and `import` themselves: tests/test_torch_topics.py, test_torch_import.py).
`search --shards 2` and MESH_SHARDS=2 (on the CPU: no cap) print and write
what the JAX CLI does with MESH_SHARDS=2 and what the port's --shards 1
does, on tower directories; `topics --cluster density --shards 2` writes
what --shards 1 writes. `train
--cross --mlm-steps 4` and the JAX CLI's on one JAX-saved bundle with
reviews mine the same pairs and print the same JSON keys; each one's
towers load in both packages' loaders and serve the port's `search` at
rerank_k 8.

Towers from disk: `search` with EMB_MODEL_DIR and RERANK_MODEL_DIR at tiny
HF snapshots and at native towers (written by transformers and by the JAX
package's save_native_tower) prints and writes what the JAX CLI does on
the same JAX-saved bundle (both loaders pinned to f32); a loaded
cross-encoder re-tokenizes the bundle's rerank tokens with its WordPiece
vocab, and query_e2e on that engine equals the JAX engine's on the bundle
re-tokenized by the JAX package; a directory without weights, or a
bi-encoder narrower than the bundle, exits non-zero naming it.
`search --dense-pool ivf` and EMB_DTYPE=int8 (exact and striped) write
the rows of run_search on the engine `_load_engine` builds, and `audit`
reports their footprints.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from review_recommender_tpu_torch import native
from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.evals.benchmark import run_performance_benchmark
from review_recommender_tpu_torch.index.build import build_bundle_from_products
from review_recommender_tpu_torch.index.io import save_bundle
from review_recommender_tpu_torch.serve import cli
from tests.torch_bundle_cases import corpus, reviews

REPO = Path(__file__).resolve().parents[1]
QUERY = "yellow wireless headphones"


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    products, queries, emb = corpus(n_themes=4, per_theme=16, n_queries=3)
    rrows, remb = reviews(products)
    d = tmp_path_factory.mktemp("cli") / "bundle"
    save_bundle(build_bundle_from_products(products, emb, reviews=rrows, review_embeddings=remb,
                                           doc_terms_cap=64, pad_multiple=16), d)
    with open(d.parent / "judged.jsonl", "w") as f:
        for q in queries:
            f.write(json.dumps(q) + "\n")
    return d


@pytest.mark.parametrize("rerank_k", [0, 4])
def test_search_json_out_equals_run_search(bundle_dir, tmp_path, rerank_k):
    out = tmp_path / "search.json"
    assert cli.main(["search", QUERY, "--index-dir", str(bundle_dir), "--device", "cpu",
                     "--rerank-k", str(rerank_k), "--json-out", str(out)]) == 0
    got = json.loads(out.read_text())
    engine = cli._load_engine(str(bundle_dir), with_rerank=rerank_k > 0, device="cpu")
    rows, snips, _debug = engine.run_search(QUERY, k=config.DEFAULT_K, rerank_k=rerank_k)
    assert got["results"] == rows and got["snippets"] == snips and len(rows) == config.DEFAULT_K
    if rerank_k:
        assert any(r["_rerank"] != 0 for r in rows)


def test_eval_equals_run_performance_benchmark(bundle_dir, tmp_path):
    judged = bundle_dir.parent / "judged.jsonl"
    assert cli.main(["eval", "--index-dir", str(bundle_dir), "--queries", str(judged),
                     "--device", "cpu", "--out", str(tmp_path / "eval")]) == 0
    got = json.loads((tmp_path / "eval" / "benchmark_results.json").read_text())
    engine = cli._load_engine(str(bundle_dir), with_rerank=True, device="cpu")
    want = run_performance_benchmark(engine.run_search, cli.read_judged_queries(judged))
    assert list(got) == list(want)
    for method in want:
        assert got[method]["aggregate"] == want[method]["aggregate"], method
    assert cli.main(["eval", "--index-dir", str(bundle_dir), "--queries", str(judged),
                     "--device", "cpu", "--method", "No Such Method"]) == 1


def test_audit_exit_codes(bundle_dir, tmp_path, capsys):
    assert cli.main(["audit", "--index-dir", str(bundle_dir), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["n_docs"] == 64
    damaged = tmp_path / "damaged"
    damaged.mkdir()
    for f in bundle_dir.iterdir():
        (damaged / f.name).write_bytes(f.read_bytes())
    (damaged / "review_meta.npz").unlink()
    assert cli.main(["audit", "--index-dir", str(damaged), "--device", "cpu"]) == 1
    (damaged / "vocab.txt").unlink()
    assert cli.main(["audit", "--index-dir", str(damaged), "--device", "cpu"]) == 1


def test_bench_prints_its_json(bundle_dir, capsys):
    assert cli.main(["bench", "--index-dir", str(bundle_dir), "--n-queries", "8",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_docs"] == 64 and line["qps"] > 0 and line["device"] == "cpu"


TRAIN_ARGV = ["--cross", "--epochs", "1", "--batch-size", "8", "--max-len", "32",
              "--hidden", "32", "--head-dim", "16", "--layers", "1", "--vocab-size", "512",
              "--mlm-steps", "4", "--checkpoint-every", "0"]


@pytest.fixture(scope="module")
def train_bundle(tmp_path_factory):
    """A JAX-saved bundle of dim 32 whose reviews are word samples of their
    products' texts (mine_pairs needs 4 distinct keywords a review)."""
    from review_recommender_tpu.index.build import build_bundle_from_products as jax_build
    from review_recommender_tpu.index.io import save_bundle as jax_save

    products, _queries, emb = corpus(n_themes=4, per_theme=16, n_queries=3, dim=TOWER_DIM)
    rng = np.random.default_rng(2)
    rrows = [{"sku": p["sku"], "text": " ".join(rng.choice(p["agg_text"].split(), size=8)),
              "stars": 4.0} for p in products for _ in range(2)]
    remb = rng.standard_normal((len(rrows), TOWER_DIM)).astype(np.float32)
    d = tmp_path_factory.mktemp("train") / "bundle"
    jax_save(jax_build(products, emb, reviews=rrows, review_embeddings=remb, doc_terms_cap=64,
                       pad_multiple=16), d)
    return d


def test_train_equals_the_jax_cli_and_both_serve_the_towers(train_bundle, tmp_path,
                                                             monkeypatch, capsys):
    from review_recommender_tpu.models import load as jax_load
    from review_recommender_tpu.serve import cli as jax_cli
    from review_recommender_tpu_torch.models import load as port_load

    _tower_dirs(monkeypatch, "", "")
    argv = ["train", "--index-dir", str(train_bundle)] + TRAIN_ARGV
    assert cli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(port) == sorted(theirs) and port["pairs"] == theirs["pairs"] > 8
    assert sorted(port["serve_env"]) == ["EMB_MODEL_DIR", "RERANK_MODEL_DIR"]
    for d in (tmp_path / "port", tmp_path / "jax"):
        bi, ce = d / "biencoder", d / "crossencoder"
        for load in (jax_load, port_load):
            kw = {} if load is jax_load else {"device": "cpu"}
            emb = load.load_biencoder(bi, **kw).encode(["soft yellow socks"])
            scores = load.load_crossencoder(ce, **kw).score_pairs(["socks"], ["soft socks"])
            assert emb.shape == (1, TOWER_DIM) and np.isfinite(emb).all()
            assert np.isfinite(scores).all()
    search = ["search", QUERY, "--index-dir", str(train_bundle), "--rerank-k", "8",
              "--device", "cpu"]
    for trained_by in ("port", "jax"):
        _tower_dirs(monkeypatch, tmp_path / trained_by / "biencoder",
                    tmp_path / trained_by / "crossencoder")
        out = tmp_path / f"{trained_by}_served.json"
        assert cli.main(search + ["--json-out", str(out)]) == 0
        rows = json.loads(out.read_text())["results"]
        assert rows and all(np.isfinite(r["_final"]) for r in rows)
        assert any(r["_rerank"] != 0 for r in rows)
    capsys.readouterr()


def test_native_serve_without_the_library_raises(bundle_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-c++")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(type(config), "LOG_FILE", str(tmp_path / "logs" / "app.log"))
    with pytest.raises(RuntimeError, match="not found"):
        cli.main(["serve", "--index-dir", str(bundle_dir), "--device", "cpu", "--native",
                  "--port", "0"])


def _get(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


@pytest.mark.parametrize("front_end", ["stdlib", "native"])
def test_serve_subprocess_answers_and_stops_on_sigterm(bundle_dir, tmp_path, front_end):
    env = {**os.environ, "PYTHONPATH": str(REPO), "LOG_FILE": str(tmp_path / "app.log")}
    cmd = [sys.executable, "-m", "review_recommender_tpu_torch.serve.cli", "serve",
           "--index-dir", str(bundle_dir), "--host", "127.0.0.1", "--port", "0",
           "--device", "cpu"] + (["--native"] if front_end == "native" else [])
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (line, proc.stderr.read()[-2000:]
                                                                 if proc.poll() is not None else "")
        port = int(line.split(":")[2].split()[0])
        assert _get(port, "/healthz")[0] == 200
        deadline = time.time() + 120
        while _get(port, "/readyz")[0] != 200:
            assert time.time() < deadline, "not ready after 120 s"
            time.sleep(0.2)
        code, answer = _get(port, "/search", {"query": QUERY, "k": 5, "rerank_k": 0})
        assert code == 200 and len(answer["results"]) == 5
        assert cli.main(["health", "--url", f"http://127.0.0.1:{port}"]) == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "stopped" in proc.stdout.read()
        assert cli.main(["health", "--url", f"http://127.0.0.1:{port}", "--timeout", "2"]) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()



def test_serve_over_shards_answers_as_one_shard(bundle_dir, tmp_path):
    """`serve --shards 2` in a subprocess serves the sharded engine: its
    /search rows equal `search --shards 1` run in process on the same
    request (MESH_SHARDS=2 reaches the same _load_engine branch:
    test_sharded_search_equals_the_jax_cli_and_one_shard)."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "LOG_FILE": str(tmp_path / "app.log")}
    cmd = [sys.executable, "-m", "review_recommender_tpu_torch.serve.cli", "serve",
           "--index-dir", str(bundle_dir), "--host", "127.0.0.1", "--port", "0",
           "--device", "cpu", "--shards", "2"]
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), line
        port = int(line.split(":")[2].split()[0])
        deadline = time.time() + 120
        while _get(port, "/readyz")[0] != 200:
            assert time.time() < deadline, "not ready after 120 s"
            time.sleep(0.2)
        code, answer = _get(port, "/search", {"query": QUERY, "k": 5, "rerank_k": 0})
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    out = tmp_path / "one_shard.json"
    assert cli.main(["search", QUERY, "--index-dir", str(bundle_dir), "--device", "cpu",
                     "--k", "5", "--shards", "1", "--json-out", str(out)]) == 0
    want = json.loads(out.read_text())["results"]
    assert code == 200 and [r["sku"] for r in answer["results"]] == [r["sku"] for r in want]
    np.testing.assert_allclose([r["_final"] for r in answer["results"]],
                               [r["_final"] for r in want], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ towers from disk
TOWER_DIM = 32


@pytest.fixture(scope="module")
def tower_case(tmp_path_factory):
    """A JAX-saved bundle of dim 32 with hash-tokenized rerank tokens, and
    tower directories of hidden size 32 over a WordPiece vocab of the
    corpus's words: {"hf": (bi, cross), "native": (bi, cross)}."""
    import jax.numpy as jnp

    from review_recommender_tpu.index.build import attach_rerank_tokens as jax_attach
    from review_recommender_tpu.index.build import build_bundle_from_products as jax_build
    from review_recommender_tpu.index.io import save_bundle as jax_save
    from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
    from review_recommender_tpu.models.bert import init_biencoder, init_crossencoder
    from review_recommender_tpu.models.load import save_native_tower
    from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHash
    from review_recommender_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
    from review_recommender_tpu_torch.models.tokenizer import basic_tokenize

    root = tmp_path_factory.mktemp("towers")
    products, _queries, emb = corpus(n_themes=4, per_theme=16, n_queries=3, dim=TOWER_DIM)
    rrows, remb = reviews(products, dim=TOWER_DIM)
    jb = jax_build(products, emb, reviews=rrows, review_embeddings=remb, doc_terms_cap=64,
                   pad_multiple=16)
    jax_attach(jb.products, JaxHash(vocab_size=512), max_tokens=24)
    jax_save(jb, root / "bundle")
    words = sorted({t for p in products for t in basic_tokenize(p["agg_text"])}
                   | set(basic_tokenize(QUERY)))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words[: len(words) // 2]
    vocab += ["##" + w[1:] for w in words[len(words) // 2:] if len(w) > 1]
    vocab = list(dict.fromkeys(vocab))
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    tiny = dict(vocab_size=len(vocab), hidden_size=TOWER_DIM, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
                initializer_range=0.2)  # logits spread enough for the minmax
    out = {}
    transformers = pytest.importorskip("transformers")
    import torch

    torch.manual_seed(0)
    hf = {"bi": transformers.BertModel(transformers.BertConfig(**tiny),
                                       add_pooling_layer=False),
          "ce": transformers.BertForSequenceClassification(
              transformers.BertConfig(**tiny, num_labels=1))}
    for name, model in hf.items():
        model.eval().save_pretrained(root / f"hf_{name}")
        (root / f"hf_{name}" / "vocab.txt").write_text((root / "vocab.txt").read_text())
    out["hf"] = (root / "hf_bi", root / "hf_ce")
    cfg = JaxBertConfig(vocab_size=len(vocab), hidden_size=TOWER_DIM, num_layers=2,
                        num_heads=4, intermediate_size=64, max_position=64)
    tok = JaxWordPiece.from_vocab_file(root / "vocab.txt")
    for name, init, kind in (("bi", init_biencoder, "biencoder"),
                             ("ce", init_crossencoder, "crossencoder")):
        _m, params = init(cfg, seed=3, dtype=jnp.float32)
        save_native_tower(root / f"native_{name}", kind, cfg, params, tok)
    out["native"] = (root / "native_bi", root / "native_ce")
    return root / "bundle", out


@pytest.fixture
def f32_loaders(monkeypatch):
    """Both packages' loaders pinned to f32 towers for the comparison."""
    import functools

    import jax.numpy as jnp
    import torch

    from review_recommender_tpu.models import load as jax_load
    from review_recommender_tpu_torch.models import load as port_load

    for mod, dt in ((jax_load, jnp.float32), (port_load, torch.float32)):
        for name in ("load_biencoder", "load_crossencoder"):
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), dtype=dt))


def _tower_dirs(monkeypatch, bi, ce):
    """Both CLIs' tower knobs; the JAX CLI's config is the object its module
    imported (tests/test_config.py may have reloaded the config module)."""
    from review_recommender_tpu.serve import cli as jax_cli

    for c in (config, jax_cli.config):
        monkeypatch.setattr(type(c), "EMB_MODEL_DIR", str(bi))
        monkeypatch.setattr(type(c), "RERANK_MODEL_DIR", str(ce))


@pytest.mark.parametrize("layout", ["hf", "native"])
def test_search_with_tower_dirs_equals_the_jax_cli(tower_case, layout, monkeypatch, tmp_path,
                                                   capsys, f32_loaders):
    from review_recommender_tpu.serve import cli as jax_cli

    bundle, dirs = tower_case
    _tower_dirs(monkeypatch, *dirs[layout])
    argv = ["search", QUERY, "--index-dir", str(bundle), "--rerank-k", "8", "--k", "10"]
    assert cli.main(argv + ["--device", "cpu", "--json-out", str(tmp_path / "port.json")]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert jax_cli.main(argv + ["--json-out", str(tmp_path / "jax.json")]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert port_lines[:-1] == jax_lines[:-1]  # the last line holds the time taken
    got, want = (json.loads((tmp_path / f).read_text())["results"]
                 for f in ("port.json", "jax.json"))
    assert [r["sku"] for r in got] == [r["sku"] for r in want] and len(got) == 10
    for col in ("_dense", "_bm25", "_rerank", "_prior", "_final"):
        assert [r[col] for r in got] == pytest.approx([r[col] for r in want], rel=1e-5,
                                                      abs=1e-5), col
    assert any(r["_rerank"] != 0 for r in got)



@pytest.mark.parametrize("how", ["flag", "mesh_shards"])
def test_sharded_search_equals_the_jax_cli_and_one_shard(tower_case, how, monkeypatch,
                                                          tmp_path, capsys, f32_loaders):
    """`search --shards 2 --device cpu` (or MESH_SHARDS=2) prints and writes
    what the JAX CLI does with MESH_SHARDS=2 (its search has no --shards)
    on the 8 virtual devices, and what the port's --shards 1 does."""
    from review_recommender_tpu.serve import cli as jax_cli

    bundle, dirs = tower_case
    _tower_dirs(monkeypatch, *dirs["native"])
    monkeypatch.setattr(type(jax_cli.config), "MESH_SHARDS", 2)
    argv = ["search", QUERY, "--index-dir", str(bundle), "--rerank-k", "8", "--k", "10"]
    port_argv = argv + ["--device", "cpu"]
    if how == "flag":
        sharded = port_argv + ["--shards", "2"]
    else:
        monkeypatch.setattr(type(config), "MESH_SHARDS", 2)
        sharded = port_argv
    runs = {}
    for name, main, args in (("port", cli.main, sharded), ("jax", jax_cli.main, argv),
                             ("one", cli.main, port_argv + ["--shards", "1"])):
        assert main(args + ["--json-out", str(tmp_path / f"{name}.json")]) == 0
        lines = capsys.readouterr().out.splitlines()
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        runs[name] = lines[:-1], doc["results"], doc.get("debug", {})  # last line: time
    assert runs["port"][2]["n_shards"] == 2 and "n_shards" not in runs["one"][2]
    for other in ("jax", "one"):
        assert runs["port"][0] == runs[other][0], other
        got, want = runs["port"][1], runs[other][1]
        assert [r["sku"] for r in got] == [r["sku"] for r in want] and len(got) == 10
        for col in ("_dense", "_bm25", "_rerank", "_prior", "_final"):
            assert [r[col] for r in got] == pytest.approx([r[col] for r in want], rel=1e-5,
                                                          abs=1e-5), (other, col)
    assert any(r["_rerank"] != 0 for r in runs["port"][1])


@pytest.fixture(scope="module")
def topics_bundle_dir(tmp_path_factory):
    """A bundle whose 180 reviews form four blobs and noise
    (tests/torch_topic_cases.py:topic_reviews)."""
    from tests.torch_topic_cases import topic_reviews

    products, _queries, emb = corpus(n_themes=4, per_theme=6, n_queries=1, dim=32)
    rows, remb = topic_reviews([p["sku"] for p in products])
    d = tmp_path_factory.mktemp("topics") / "bundle"
    save_bundle(build_bundle_from_products(products, emb, reviews=rows, review_embeddings=remb,
                                           doc_terms_cap=32, pad_multiple=8), d)
    return d


def test_topics_density_over_shards_writes_what_one_shard_writes(topics_bundle_dir, tmp_path,
                                                                 capsys):
    outs = {}
    for shards in ("1", "2"):
        out = tmp_path / f"shards_{shards}"
        assert cli.main(["topics", "--index-dir", str(topics_bundle_dir), "--out", str(out),
                         "--cluster", "density", "--min-samples", "5", "--min-cluster-size",
                         "20", "--min-reviews", "1", "--shards", shards,
                         "--device", "cpu"]) == 0
        outs[shards] = out, capsys.readouterr().err
    assert "density: 4 clusters" in outs["2"][1]
    for f in ("topic_cards.jsonl", "aspect_metrics.json"):
        assert (outs["2"][0] / f).read_text() == (outs["1"][0] / f).read_text(), f


def test_loaded_cross_tower_retokenizes_the_rerank_tokens(tower_case, monkeypatch, f32_loaders):
    """The bundle's hash-tokenized doc tokens are replaced with the loaded
    cross-encoder's WordPiece ids, as the JAX package's attach_rerank_tokens
    gives them; query_e2e on that engine equals the JAX engine's with the
    same towers on the re-tokenized bundle."""
    import jax.numpy as jnp

    from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
    from review_recommender_tpu.index.build import attach_rerank_tokens as jax_attach
    from review_recommender_tpu.index.io import load_bundle as jax_load_bundle
    from review_recommender_tpu.models import load as jax_load
    from review_recommender_tpu.ops.fusion import FusionWeights as JaxWeights
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    bundle, dirs = tower_case
    bi, ce = dirs["native"]
    _tower_dirs(monkeypatch, bi, ce)
    engine = cli._load_engine(str(bundle), with_rerank=True, device="cpu")
    jbe, jce = jax_load.load_biencoder(bi), jax_load.load_crossencoder(ce)
    jb = jax_load_bundle(bundle)
    hashed = jb.products.doc_tokens.copy()
    jax_attach(jb.products, jce.tokenizer, max_tokens=hashed.shape[1])
    got = engine.arrays["doc_tokens"].numpy()
    assert (got != hashed).any()
    assert (got == jb.products.doc_tokens).all()
    assert (engine.arrays["doc_token_len"].numpy() == jb.products.doc_token_len).all()
    je = JaxEngine(jb, query_encoder=jbe, cross_encoder=jce)
    je.attach_models(jbe, jce)
    assert engine._be is engine.query_encoder and engine._ce is engine.cross_encoder
    knobs = (0.5, 0.2, 0.3, 0.1, 0.0, 20.0, 5, 0.5)
    for q in (QUERY, "socks for a cat"):
        jr, js = je.query_e2e(q, JaxWeights.make(*knobs), 32, 10, rr_k=8)
        tr, ts = engine.query_e2e(q, FusionWeights.make(*knobs), 32, 10, rr_k=8)
        assert tr.tolist() == np.asarray(jr).tolist()
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("knob", ["EMB_MODEL_DIR", "RERANK_MODEL_DIR"])
def test_tower_dir_without_weights_exits_non_zero(tower_case, monkeypatch, tmp_path, knob):
    bundle, dirs = tower_case
    empty = tmp_path / "no_weights"
    empty.mkdir()
    src = dirs["hf"][0 if knob == "EMB_MODEL_DIR" else 1]
    for f in ("config.json", "vocab.txt"):
        (empty / f).write_text((src / f).read_text())
    monkeypatch.setattr(type(config), knob, str(empty))
    with pytest.raises(SystemExit, match=f"{knob}=.*no_weights.*no model.safetensors") as exc:
        cli.main(["search", QUERY, "--index-dir", str(bundle), "--device", "cpu",
                  "--rerank-k", "4"])
    assert exc.value.code not in (0, None)


def test_tower_narrower_than_the_bundle_exits_non_zero(bundle_dir, tower_case, monkeypatch):
    _bundle, dirs = tower_case
    monkeypatch.setattr(type(config), "EMB_MODEL_DIR", str(dirs["hf"][0]))
    with pytest.raises(SystemExit, match="hidden size 32 is not the bundle's dim 64") as exc:
        cli.main(["search", QUERY, "--index-dir", str(bundle_dir), "--device", "cpu"])
    assert exc.value.code not in (0, None)


POOL_CASES = {"ivf": ({}, ["--dense-pool", "ivf"]),
              "int8_exact": ({"EMB_DTYPE": "int8"}, ["--dense-pool", "exact"]),
              "int8_striped": ({"EMB_DTYPE": "int8"}, ["--dense-pool", "striped"])}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_search_on_ivf_and_int8_equals_run_search(bundle_dir, tmp_path, monkeypatch, case):
    knobs, extra = POOL_CASES[case]
    for name, value in knobs.items():
        monkeypatch.setattr(type(config), name, value)
    out = tmp_path / "search.json"
    assert cli.main(["search", QUERY, "--index-dir", str(bundle_dir), "--device", "cpu",
                     "--rerank-k", "4", "--json-out", str(out)] + extra) == 0
    got = json.loads(out.read_text())
    engine = cli._load_engine(str(bundle_dir), with_rerank=True, dense_pool=extra[1],
                              device="cpu")
    assert engine.dense_pool == extra[1] and engine.int8_mode == ("int8" in case)
    rows, snips, _debug = engine.run_search(QUERY, k=config.DEFAULT_K, rerank_k=4)
    assert got["results"] == rows and got["snippets"] == snips and len(rows) == config.DEFAULT_K


@pytest.mark.parametrize("knobs,key", [({"EMB_DTYPE": "int8"}, "emb_q"),
                                       ({"DENSE_POOL_MODE": "ivf"}, "ivf_bound")])
def test_audit_reports_the_int8_and_ivf_footprints(bundle_dir, monkeypatch, capsys, knobs, key):
    for name, value in knobs.items():
        monkeypatch.setattr(type(config), name, value)
    assert cli.main(["audit", "--index-dir", str(bundle_dir), "--device", "cpu"]) == 0
    fp = json.loads(capsys.readouterr().out)["device_footprint"]
    assert key in fp["bytes_per_array"] and fp["total_bytes"] == sum(
        fp["bytes_per_array"].values())
