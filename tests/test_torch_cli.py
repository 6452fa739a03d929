"""The port's CLI (review_recommender_tpu_torch/serve/cli.py) on a tiny
saved bundle, on the CPU (--device cpu).

`search --json-out` writes the rows of an in-process run_search on the
engine `_load_engine` builds (random towers of the JAX CLI's shapes,
seeded); `eval` gives run_performance_benchmark's aggregates; `audit`
exits 0 on a good bundle and 1 on a damaged one; `bench` prints its JSON;
`serve` in a subprocess answers /healthz, /readyz, /search and `health`,
and stops on SIGTERM, for both front ends. Every refusal exits non-zero
and names its ROADMAP item: EMB_MODEL_DIR or RERANK_MODEL_DIR set (5b),
--shards 2 or MESH_SHARDS=2 (12), train (13), topics (14), import (18);
--native without a buildable library raises.
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


REFUSALS = {
    "emb_model_dir": (["search", QUERY], {"EMB_MODEL_DIR": "/towers/bi"}, "item 5b"),
    "rerank_model_dir": (["search", QUERY], {"RERANK_MODEL_DIR": "/towers/ce"}, "item 5b"),
    "shards_2": (["serve", "--shards", "2"], {}, "item 12"),
    "mesh_shards_2": (["serve"], {"MESH_SHARDS": 2}, "item 12"),
    "train": (["train", "--out", "x"], {}, "item 13"),
    "topics": (["topics"], {}, "item 14"),
    "import": (["import", "--data-dir", "d", "--out", "x"], {}, "item 18"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_exit_non_zero_naming_their_item(bundle_dir, monkeypatch, case):
    argv, knobs, item = REFUSALS[case]
    for name, value in knobs.items():
        monkeypatch.setattr(type(config), name, value)
    if argv[0] in ("search", "serve"):
        argv = argv + ["--index-dir", str(bundle_dir), "--device", "cpu"]
    with pytest.raises(SystemExit, match=item) as exc:
        cli.main(argv)
    assert exc.value.code not in (0, None)


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
