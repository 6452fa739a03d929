"""The port's stdlib HTTP server (review_recommender_tpu_torch/serve/api.py)
against the JAX package's, each on a live socket (port=0), on the same
bundle and the same tiny f32 towers.

Both engines get tests/test_engine_parity.make_corpus at 48 products with
reviews through the JAX package's build_bundle_from_products (the port's
dataclasses take its numpy fields) and the JAX bi- and cross-encoders,
carried to the port by params_from_flax. Both servers coalesce /search in
their micro-batchers (MICROBATCH_MAX 8, a 20 ms window, on both configs).

/search with and without qvec, at rerank_k 0 and 6, with use_snips, and
with max_scan (the uncoalesced route): skus in equal order, every float
field within 1e-5, snippets equal (score within 1e-5), and debug tokens,
groups and bm25_active equal. /search_batch the same; /eval aggregates
within 1e-6; /healthz, /readyz, the keys of /debug/info, the names in
/metrics and the 400 / 404 answers equal. Concurrent requests coalesce;
format_search_result_bytes is byte-identical to json.dumps of
format_search_result; IRMetrics, LatencyStats, device_fetch and the retry
rule are held to their JAX counterparts; every engine call a server thread
makes runs under inference mode.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.evals.metrics import IRMetrics as JaxIRMetrics
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import BiEncoder as JaxBiEncoder
from review_recommender_tpu.models.encoder import CrossEncoder as JaxCrossEncoder
from review_recommender_tpu.serve import api as jax_api
from review_recommender_tpu.utils.numerics import device_fetch as jax_device_fetch
from review_recommender_tpu.utils.profiling import LatencyStats as JaxLatencyStats
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.evals.metrics import IRMetrics
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex, ReviewIndex
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.serve import api
from review_recommender_tpu_torch.utils.numerics import device_fetch
from review_recommender_tpu_torch.utils.profiling import LatencyStats
from tests.test_engine_parity import QUERIES, make_corpus

DIM = 64
TOL = 1e-5
EVAL_TOL = 1e-6
SEARCHES = [
    {"query": QUERIES[0], "k": 5, "rerank_k": 0},
    {"query": QUERIES[1], "k": 8, "rerank_k": 6, "w_rerank": 0.3, "w_dense": 0.4},
    {"query": QUERIES[2], "k": 5, "rerank_k": 0, "use_snips": True, "w_best": 0.2},
    {"query": QUERIES[3], "k": 6, "rerank_k": 6, "use_snips": True, "prior_C": 15.0},
    {"query": QUERIES[4], "k": 5, "rerank_k": 0, "use_snips": True, "max_scan": 7},
    {"query": QUERIES[0], "k": 4, "rerank_k": 6, "max_scan": -1, "use_snips": True},
    {"query": "zzz qqq nothing", "k": 3, "rerank_k": 0, "gate_penalty": 0.3},
]


def _port_bundle(jb):
    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    return IndexBundle(products=ProductIndex(**fields(ProductIndex, jb.products)),
                       reviews=ReviewIndex(**fields(ReviewIndex, jb.reviews)))


def _engines():
    products, emb, reviews, remb = make_corpus(n=48, dim=DIM, seed=3)
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=16, doc_terms_cap=64)
    cfg = JaxBertConfig.tiny()
    jbe = JaxBiEncoder.random_init(cfg, seed=1, dtype=jnp.float32)
    jce = JaxCrossEncoder.random_init(cfg, seed=2, dtype=jnp.float32)
    tcfg, tok = BertConfig(**vars(cfg)), HashTokenizer(cfg.vocab_size)
    flat = lambda m: jax.tree.map(np.asarray, m.params)
    tbe = BiEncoder(tcfg, params_from_flax(flat(jbe), cfg, "biencoder"), tok, device="cpu",
                    dtype=torch.float32)
    tce = CrossEncoder(tcfg, params_from_flax(flat(jce), cfg, "crossencoder"), tok,
                       device="cpu", dtype=torch.float32)
    je = JaxEngine(jb, emb_dtype="float32", gate_mode="device", query_encoder=jbe,
                   cross_encoder=jce)
    te = SearchEngine(_port_bundle(jb), device="cpu", emb_dtype="float32", gate_mode="device",
                      query_encoder=tbe, cross_encoder=tce)
    return je, te


def _start(serve_fn, engine):
    srv = serve_fn(engine, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def servers():
    je, te = _engines()
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, port_config):  # read when the micro-batchers start
            mp.setattr(c, "MICROBATCH_MAX", 8)
            mp.setattr(c, "MICROBATCH_WINDOW_MS", 20.0)
        jsrv, tsrv = _start(jax_api.serve, je), _start(api.serve, te)
    yield jsrv, tsrv
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.service.close()


def _call(port, method, path, payload=None, raw=None):
    data = raw if raw is not None else (json.dumps(payload).encode() if payload is not None
                                        else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _both(servers, method, path, payload=None, raw=None):
    """(port answer, JAX answer), each (status, body bytes, content type)."""
    jsrv, tsrv = servers
    return (_call(tsrv.server_address[1], method, path, payload, raw),
            _call(jsrv.server_address[1], method, path, payload, raw))


def _close(a, b, what):
    if isinstance(b, float):
        assert isinstance(a, float) and abs(a - b) <= TOL, (what, a, b)
    else:
        assert a == b, (what, a, b)


def assert_same_search(got: dict, want: dict):
    assert [r["sku"] for r in got["results"]] == [r["sku"] for r in want["results"]]
    for a, b in zip(got["results"], want["results"]):
        assert list(a) == list(b)
        for key in b:
            _close(a[key], b[key], (b["sku"], key))
    assert sorted(got["snippets"]) == sorted(want["snippets"])
    for sku, snip in want["snippets"].items():
        assert list(got["snippets"][sku]) == list(snip)
        for key in snip:
            _close(got["snippets"][sku][key], snip[key], (sku, key))
    for key in ("tokens", "groups", "bm25_active"):
        assert got["debug"][key] == want["debug"][key], key


def _qvec(i):
    v = np.random.default_rng(100 + i).standard_normal(DIM).astype(np.float32)
    return (v / np.linalg.norm(v)).tolist()


@pytest.mark.parametrize("with_qvec", [False, True], ids=["encoded", "qvec"])
@pytest.mark.parametrize("i", range(len(SEARCHES)))
def test_search_matches_jax(servers, i, with_qvec):
    payload = dict(SEARCHES[i], **({"qvec": _qvec(i)} if with_qvec else {}))
    (tc, tb, tt), (jc, jb, jt) = _both(servers, "POST", "/search", payload)
    assert (tc, tt) == (jc, jt) == (200, "application/json"), tb
    got, want = json.loads(tb), json.loads(jb)
    assert got["results"] and list(got) == list(want)
    assert_same_search(got, want)
    coalesced = "max_scan" not in payload
    assert ("coalesced" in got["debug"]) == ("coalesced" in want["debug"]) == coalesced
    if payload.get("use_snips") and not coalesced:
        assert got["snippets"]


@pytest.mark.parametrize("with_qvecs", [False, True], ids=["encoded", "qvecs"])
def test_search_batch_matches_jax(servers, with_qvecs):
    payload = {"queries": QUERIES[:4], "k": 6, "w_dense": 0.5, "w_bm25": 0.3}
    if with_qvecs:
        payload["qvecs"] = [_qvec(i) for i in range(4)]
    (tc, tb, _), (jc, jb, _) = _both(servers, "POST", "/search_batch", payload)
    assert tc == jc == 200
    got, want = json.loads(tb), json.loads(jb)
    assert got["batch"] == want["batch"] == 4 and sorted(got) == sorted(want)
    for g, w in zip(got["results"], want["results"]):
        assert [r["sku"] for r in g] == [r["sku"] for r in w] and len(g) == 6
        np.testing.assert_allclose([r["_final"] for r in g], [r["_final"] for r in w],
                                   rtol=TOL, atol=TOL)


def test_eval_matches_jax(servers):
    payload = {"queries": [
        {"id": "q1", "query": QUERIES[0], "relevant_skus": ["SKU0001", "SKU0007"]},
        {"id": "q2", "query": QUERIES[1], "relevant_skus": ["SKU0002", "SKU0003", "SKU0040"]},
        {"query": QUERIES[2], "relevant_skus": []},
    ], "k": 10, "rerank_k": 0}
    (tc, tb, _), (jc, jb, _) = _both(servers, "POST", "/eval", payload)
    assert tc == jc == 200
    got, want = json.loads(tb), json.loads(jb)
    assert list(got["aggregate"]) == list(want["aggregate"])
    for key, v in want["aggregate"].items():
        assert abs(got["aggregate"][key] - v) <= EVAL_TOL, key
    assert got["aggregate"]["n_queries"] == 3
    assert [r["query_id"] for r in got["per_query"]] == [r["query_id"] for r in want["per_query"]]


def test_health_readiness_info_and_metrics_match_jax(servers):
    for path in ("/healthz", "/readyz"):
        t, j = _both(servers, "GET", path)
        assert t == j and t[0] == 200, path
    _both(servers, "POST", "/search", {"query": "blue mouse", "k": 3, "rerank_k": 0})
    t, j = _both(servers, "GET", "/debug/info")
    got, want = json.loads(t[1]), json.loads(j[1])
    assert sorted(got) == sorted(want)
    assert sorted(got["microbatch"]) == sorted(want["microbatch"])
    for key in ("n_docs", "n_padded", "dim", "vocab_size", "has_reviews", "gate_mode", "ready",
                "native_server"):
        assert got[key] == want[key], key
    assert got["emb_dtype"] == "float32" and got["stats"]["requests"] >= 1
    t, j = _both(servers, "GET", "/metrics")
    assert t[2] == j[2] and t[2].startswith("text/plain")
    names = lambda body: {line.split()[0].split("{")[0] for line in body.decode().splitlines()
                          if line and not line.startswith("#")}
    assert names(t[1]) == names(j[1])
    assert "rrt_microbatch_windows_total" in names(t[1])
    t, j = _both(servers, "GET", "/")
    assert t[0] == j[0] == 200 and t[2] == j[2] and b"Review Search Copilot" in t[1]


@pytest.mark.parametrize("method,path,raw", [
    ("POST", "/search", b"{}"), ("POST", "/search", b"garbage"), ("POST", "/search", b"[1, 2]"),
    ("POST", "/eval", b"{}"), ("POST", "/search_batch", b"{}"), ("POST", "/nope", b"{}"),
    ("GET", "/nope", None),
])
def test_errors_match_jax(servers, method, path, raw):
    t, j = _both(servers, method, path, raw=raw)
    assert t[0] == j[0] and t[0] in (400, 404)
    if t[0] == 404:
        assert t[1] == j[1]
    else:
        assert "error" in json.loads(t[1]) and "error" in json.loads(j[1])


def test_concurrent_requests_coalesce(servers):
    _jsrv, tsrv = servers
    port, batcher = tsrv.server_address[1], tsrv.service.batcher
    n = 12
    barrier, out = threading.Barrier(n), [None] * n

    def client(i):
        barrier.wait()
        out[i] = _call(port, "POST", "/search", {"query": f"{QUERIES[i % 5]} q{i}", "k": 3,
                                                 "rerank_k": 0, "qvec": _qvec(i)})

    before = (batcher.batches, batcher.coalesced)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(o[0] == 200 for o in out)
    windows, riders = batcher.batches - before[0], batcher.coalesced - before[1]
    assert riders == n and windows < n
    assert max(json.loads(o[1])["debug"]["coalesced"] for o in out) > 1


def test_trace_writes_under_the_log_dir(servers, tmp_path, monkeypatch):
    from review_recommender_tpu_torch.utils.profiling import TRACE_FILE

    monkeypatch.setattr(port_config, "LOG_FILE", str(tmp_path / "logs" / "app.log"))
    _jsrv, tsrv = servers
    code, body, _ = _call(tsrv.server_address[1], "POST", "/debug/trace",
                          {"query": QUERIES[0], "n": 2, "log_dir": str(tmp_path / "evil")})
    assert code == 200
    out = json.loads(body)
    assert out["n"] == 2 and out["ms_per_query"] > 0
    assert out["log_dir"].startswith(str(tmp_path / "logs" / "traces"))
    events = json.loads((tmp_path / "logs" / "traces" / out["log_dir"].rsplit("/", 1)[1]
                         / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_format_search_result_bytes_is_byte_identical(servers):
    _jsrv, tsrv = servers
    engine = tsrv.service.engine
    service = api.SearchService(engine)
    try:
        payloads = [{"query": "yellow socks", "k": 4, "qvec": _qvec(0)},
                    {"query": "wireless headphones", "k": 3, "w_dense": 0.7, "prior_C": 15.0,
                     "use_snips": True, "qvec": _qvec(1)},
                    {"query": "zzz qqq nothing", "k": 2, "qvec": _qvec(2)},
                    {"query": "kitchen knife", "k": 5, "rerank_k": 4, "qvec": _qvec(3)}]
        captured = []

        def capturing(eng, req, rows, scores, bd, n, took):
            captured.append((req, rows, scores, bd, n, took))
            return api.format_search_result(eng, req, rows, scores, bd, n, took)

        api.run_coalesced_batch(engine, [service.parse_search_payload(p) for p in payloads],
                                formatter=capturing)
        assert len(captured) == len(payloads)
        assert any(c[0].use_snips for c in captured) and any(c[0].rerank_k for c in captured)
        for args in captured:
            want = json.dumps(api.format_search_result(engine, *args)).encode()
            assert api.format_search_result_bytes(engine, *args) == want
            assert api.format_search_result_bytes(engine, *args) == want  # warm fragment cache
    finally:
        service.close()


def test_server_threads_run_under_inference_mode(servers, monkeypatch):
    """Inference mode is thread-local: every engine call reached from a
    handler thread, the micro-batcher's thread or a route runs inside it."""
    _jsrv, tsrv = servers
    engine, seen = tsrv.service.engine, []
    for name in ("encode_query", "run_search", "query_fused_batched_pw",
                 "query_rerank_batched_pw", "query_fused_batched"):
        fn = getattr(engine, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, torch.is_inference_mode_enabled()))
            return _fn(*a, **kw)

        monkeypatch.setattr(engine, name, spy)
    port = tsrv.server_address[1]
    for payload in ({"query": QUERIES[0], "k": 3, "rerank_k": 0},
                    {"query": QUERIES[1], "k": 3, "rerank_k": 4},
                    {"query": QUERIES[2], "k": 3, "rerank_k": 0, "max_scan": 3}):
        assert _call(port, "POST", "/search", payload)[0] == 200
    assert _call(port, "POST", "/search_batch", {"queries": QUERIES[:2], "k": 3})[0] == 200
    assert {name for name, _ in seen} == {"encode_query", "run_search", "query_fused_batched_pw",
                                          "query_rerank_batched_pw", "query_fused_batched"}
    assert all(mode for _name, mode in seen), seen


def test_ir_metrics_match_jax():
    rng = np.random.default_rng(5)
    mine, ref = IRMetrics(), JaxIRMetrics()
    skus = [f"S{i}" for i in range(40)]
    for q in range(9):
        ranked = list(rng.permutation(skus)[: int(rng.integers(0, 25))])
        relevant = set(rng.choice(skus, size=int(rng.integers(0, 6)), replace=False))
        assert mine.evaluate_query(f"q{q}", ranked, relevant) == \
            ref.evaluate_query(f"q{q}", ranked, relevant)
    got, want = mine.aggregate_metrics(), ref.aggregate_metrics()
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12, key
    assert IRMetrics().aggregate_metrics() == JaxIRMetrics().aggregate_metrics() == {}


def test_latency_stats_match_jax():
    samples = np.random.default_rng(6).exponential(0.02, size=5000)
    mine, ref = LatencyStats(capacity=1024), JaxLatencyStats(capacity=1024)
    assert mine.summary() == ref.summary() == {"count": 0}
    for s in samples:
        mine.record(float(s))
        ref.record(float(s))
    got, want = mine.summary(), ref.summary()
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "qps"} == \
        {k: v for k, v in want.items() if k != "qps"}


def test_device_fetch_matches_jax():
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal((3, 5)).astype(np.float32),
              rng.integers(0, 100, (3, 5)).astype(np.int64), np.float32(2.5)]
    got = device_fetch(*(torch.from_numpy(np.asarray(a)) for a in arrays[:2]), arrays[2],
                       [1, 2])
    want = jax_device_fetch(*(jnp.asarray(a) for a in arrays[:2]), arrays[2], [1, 2])
    assert len(got) == len(want) == 4
    for g, w, a in zip(got, want, arrays + [np.asarray([1, 2])]):
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("exc,transient", [
    (ConnectionResetError("peer reset"), True),
    (TimeoutError("slow"), True),
    (RuntimeError("FAILED_PRECONDITION: readback"), True),
    (RuntimeError("UNAVAILABLE: socket closed"), True),
    (ValueError("bad payload"), False),
    (TypeError("shape"), False),
    (RuntimeError("shape mismatch"), False),
])
def test_retry_rule_matches_jax(exc, transient):
    assert api._is_transient_device_error(exc) is jax_api._is_transient_device_error(exc) \
        is transient


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure\nCUDA kernel errors might be asynchronously "
    "reported at some other API call; internal stack trace",
    "CUBLAS_STATUS_INTERNAL_ERROR when calling `cublasGemmEx( handle, ...)`",
    "mha_fwd kernel launch failed: cudaError 700 at B=64 S=512 H=12 D=32",
])
def test_cuda_faults_are_not_retried(msg):
    """A CUDA fault is sticky; the JAX rule would retry some of these
    messages ("internal"), the port's does not."""
    assert not api._is_transient_device_error(RuntimeError(msg))
