"""The port's HTTP front ends over its corpus-sharded engine against the
JAX mesh server: tests/test_serve_mesh.py's routes, with the port's
ShardedSearchEngine on devices=["cpu"] * 8 behind its stdlib server
(serve/api.py) and its native front end (serve/native_server.py), and the
JAX ShardedSearchEngine on the 8 virtual CPU devices behind the JAX
stdlib server, on one bundle (make_corpus(n=24, dim=32) through the JAX
builder), one crc32-seeded query encoder and one fake cross-encoder with
score_pairs (tests/test_microbatch.py:_FakePairCE).

/search (with snippets too), /search_batch, a concurrent burst that rides
the micro-batcher, concurrent live-rerank riders that coalesce, and /eval:
each port answer equals the JAX server's (skus in order, every float
within 1e-5, snippets, debug tokens; /eval aggregates within 1e-6), and
the native front end answers as the port's stdlib server does. serve/
api.py and serve/native_server.py run over the sharded engine unchanged.
"""
import json
import threading
import zlib

import numpy as np
import pytest

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.parallel.sharded import ShardedSearchEngine as JaxSharded
from review_recommender_tpu.serve import api as jax_api
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine
from review_recommender_tpu_torch.serve import api
from review_recommender_tpu_torch.serve.native_server import serve_native
from tests.test_engine_parity import make_corpus
from tests.test_microbatch import _FakePairCE
from tests.test_torch_serve import _call, assert_same_search
from tests.test_torch_sharded import port_bundle
from tests.torch_bundle_cases import one_torch_thread  # noqa: F401

EVAL_TOL = 1e-6
SEARCHES = [
    {"query": "wireless headphones", "k": 5, "rerank_k": 0},
    {"query": "yellow socks", "k": 8, "rerank_k": 0, "w_dense": 0.7, "w_bm25": 0.2,
     "prior_C": 30.0, "gate_penalty": 0.4},
    {"query": "usb cable", "k": 5, "rerank_k": 0, "use_snips": True},
    {"query": "kitchen knife", "k": 6, "rerank_k": 6, "w_rerank": 0.25},
]


def _enc(text):
    rng = np.random.default_rng(zlib.crc32(text.encode()))  # stable per text
    v = rng.standard_normal(32).astype(np.float32)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def servers():
    """{"jax": port number, "stdlib": ..., "native": ...} and the port's
    stdlib server object."""
    products, emb, reviews, remb = make_corpus(n=24, dim=32, seed=9)
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=8, doc_terms_cap=32)
    je = JaxSharded(jb, n_shards=8, emb_dtype="float32", query_encoder=_enc,
                    cross_encoder=_FakePairCE())
    te = ShardedSearchEngine(port_bundle(jb), devices=["cpu"] * 8, emb_dtype="float32",
                             query_encoder=_enc, cross_encoder=_FakePairCE())
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, jax_api.config, port_config):  # read when the batchers start
            mp.setattr(c, "MICROBATCH_MAX", 8)
            mp.setattr(c, "MICROBATCH_WINDOW_MS", 20.0)
        jsrv, tsrv = jax_api.serve(je, host="127.0.0.1", port=0), api.serve(
            te, host="127.0.0.1", port=0)
        nsrv = serve_native(te, host="127.0.0.1", port=0)
    for srv in (jsrv, tsrv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield {"jax": jsrv.server_address[1], "stdlib": tsrv.server_address[1],
           "native": nsrv.port}, tsrv
    nsrv.close()
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.service.close()


def _post(port, path, payload):
    code, body, _ctype = _call(port, "POST", path, payload)
    assert code == 200, body
    return json.loads(body)


def _untimed(out: dict) -> dict:
    out = dict(out, debug=dict(out["debug"]))
    out.pop("took_ms", None)
    for key in ("batch_ms", "coalesced", "stage_ms"):
        out["debug"].pop(key, None)
    return out


def _concurrent(port, payloads):
    """POST every payload at once; the answers in payload order."""
    out, errors = [None] * len(payloads), []

    def worker(i):
        try:
            out[i] = _post(port, "/search", payloads[i])
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


def test_ready_and_microbatcher_active(servers):
    ports, tsrv = servers
    for front in ("stdlib", "native"):
        code, body, _ = _call(ports[front], "GET", "/readyz")
        assert code == 200 and json.loads(body)["ready"], front
    assert tsrv.service.batcher is not None
    code, body, _ = _call(ports["stdlib"], "GET", "/debug/info")
    info = json.loads(body)
    assert code == 200 and info["microbatch"] is not None and info["emb_dtype"] == "float32"


@pytest.mark.parametrize("i", range(len(SEARCHES)))
def test_search_matches_the_jax_mesh_server(servers, i):
    ports, _ = servers
    want = _post(ports["jax"], "/search", SEARCHES[i])
    got = _post(ports["stdlib"], "/search", SEARCHES[i])
    assert got["results"] and list(got) == list(want)
    assert_same_search(got, want)
    assert _untimed(_post(ports["native"], "/search", SEARCHES[i])) == _untimed(got)


def test_search_batch_matches_the_jax_mesh_server(servers):
    ports, _ = servers
    payload = {"queries": ["wireless headphones", "yellow socks", "usb cable"], "k": 5}
    want = _post(ports["jax"], "/search_batch", payload)
    got = _post(ports["stdlib"], "/search_batch", payload)
    assert got["batch"] == want["batch"] == 3
    for g, w in zip(got["results"], want["results"]):
        assert [r["sku"] for r in g] == [r["sku"] for r in w] and len(g) == 5
        np.testing.assert_allclose([r["_final"] for r in g], [r["_final"] for r in w],
                                   rtol=1e-5, atol=1e-5)
    native = _post(ports["native"], "/search_batch", payload)
    native.pop("took_ms"), got.pop("took_ms")
    assert native == got


@pytest.mark.parametrize("rerank", [False, True], ids=["burst", "rerank_riders"])
def test_concurrent_requests_coalesce_and_match_jax(servers, rerank):
    """A concurrent burst rides each port front end's micro-batcher (live
    rerank riders through query_rerank_batched_pw on the shards); every
    rider gets the JAX mesh server's answer to it alone."""
    ports, tsrv = servers
    payloads = [{"query": f"{'rerank burst' if rerank else 'query number'} {i} socks",
                 "k": 5, "rerank_k": 6 if rerank else 0, "w_rerank": 0.25}
                for i in range(12)]
    want = [_post(ports["jax"], "/search", p) for p in payloads]
    before = tsrv.service.batcher.coalesced
    for front in ("stdlib", "native"):
        for got, w in zip(_concurrent(ports[front], payloads), want):
            assert_same_search(got, w)
    assert tsrv.service.batcher.coalesced - before >= len(payloads)
    if rerank:
        assert any(r["_rerank"] != 0.0 for w in want for r in w["results"])


def test_eval_matches_the_jax_mesh_server(servers):
    ports, _ = servers
    payload = {"queries": [
        {"id": "q1", "query": "wireless headphones", "relevant_skus": ["SKU0001"]},
        {"id": "q2", "query": "yellow socks", "relevant_skus": ["SKU0002", "SKU0010"]},
    ], "k": 10, "rerank_k": 0}
    want = _post(ports["jax"], "/eval", payload)
    for front in ("stdlib", "native"):
        got = _post(ports[front], "/eval", payload)
        assert list(got["aggregate"]) == list(want["aggregate"]), front
        for key, value in want["aggregate"].items():
            assert got["aggregate"][key] == pytest.approx(value, abs=EVAL_TOL), (front, key)
