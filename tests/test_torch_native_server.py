"""The port's native HTTP front end (review_recommender_tpu_torch/serve/
native_server.py on the port's own build of native/server.cc) against the
port's stdlib server, on a live socket.

Both front ends share route_request and run_coalesced_batch, so a /search
answer must equal the stdlib server's apart from the timing fields
(took_ms, debug.batch_ms) and debug.coalesced; every other route answers
alike. /healthz is answered in C++ while a /search window is held; one
native server runs per process, so a second start raises. The engine is
tests/test_torch_serve.py's (tiny f32 towers, 48 products with reviews);
each test starts and closes its own native server.
"""
import json
import socket
import threading
import time

import pytest

from review_recommender_tpu_torch.serve.api import serve
from review_recommender_tpu_torch.serve.native_server import NativeSearchServer, serve_native
from tests.test_engine_parity import QUERIES
from tests.test_torch_serve import SEARCHES, _call, _engines, _qvec


@pytest.fixture(scope="module")
def engine():
    return _engines()[1]


@pytest.fixture(scope="module")
def stdlib_port(engine):
    srv = serve(engine, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.service.close()


@pytest.fixture
def native(engine):
    srv = serve_native(engine, host="127.0.0.1", port=0)
    yield srv
    srv.close()


def _untimed(body: bytes) -> dict:
    out = json.loads(body)
    out.pop("took_ms")
    for key in ("batch_ms", "coalesced"):
        out["debug"].pop(key, None)
    out["debug"].pop("stage_ms", None)  # the uncoalesced route's stage timer
    return out


@pytest.mark.parametrize("with_qvec", [False, True], ids=["encoded", "qvec"])
@pytest.mark.parametrize("i", range(len(SEARCHES)))
def test_search_answers_like_the_stdlib_server(native, stdlib_port, i, with_qvec):
    payload = dict(SEARCHES[i], **({"qvec": _qvec(i)} if with_qvec else {}))
    n_code, n_body, n_type = _call(native.port, "POST", "/search", payload)
    s_code, s_body, s_type = _call(stdlib_port, "POST", "/search", payload)
    assert (n_code, n_type) == (s_code, s_type) == (200, "application/json")
    assert _untimed(n_body) == _untimed(s_body)


@pytest.mark.parametrize("method,path,payload", [
    ("GET", "/healthz", None), ("GET", "/readyz", None), ("GET", "/", None),
    ("POST", "/search_batch", {"queries": QUERIES[:3], "k": 4}),
    ("POST", "/eval", {"queries": [{"query": QUERIES[0], "relevant_skus": ["SKU0001"]}],
                       "k": 5, "rerank_k": 0}),
    ("POST", "/search", {}), ("POST", "/nope", {}), ("GET", "/nope", None),
])
def test_other_routes_answer_like_the_stdlib_server(native, stdlib_port, method, path, payload):
    n = _call(native.port, method, path, payload)
    s = _call(stdlib_port, method, path, payload)
    assert (n[0], n[2]) == (s[0], s[2])
    if path == "/search_batch":
        a, b = json.loads(n[1]), json.loads(s[1])
        a.pop("took_ms"), b.pop("took_ms")
        assert a == b
    elif path != "/search":  # the 400's text names the same fault either way
        assert n[1] == s[1]


def test_info_and_metrics_carry_the_native_counters(native):
    assert _call(native.port, "POST", "/search", {"query": "blue mouse", "k": 3})[0] == 200
    info = json.loads(_call(native.port, "GET", "/debug/info")[1])
    ns = info["native_server"]
    assert ns["requests"] >= 1 and ns["windows"] >= 1 and ns["device_batches"] >= 1
    assert info["microbatch"] is None and info["ready"]
    text = _call(native.port, "GET", "/metrics")[1].decode()
    assert "rrt_native_windows" in text and "rrt_native_device_coalesced" in text


def test_concurrent_requests_share_windows(native):
    n = 12
    barrier, out = threading.Barrier(n), [None] * n

    def client(i):
        barrier.wait()
        out[i] = _call(native.port, "POST", "/search",
                       {"query": f"{QUERIES[i % 5]} q{i}", "k": 3, "rerank_k": 0,
                        "qvec": _qvec(i)})

    before = native.batch_stats.coalesced, native.batch_stats.batches
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(o[0] == 200 for o in out)
    assert native.batch_stats.coalesced - before[0] == n
    assert native.batch_stats.batches - before[1] < n


def test_healthz_answers_while_a_window_is_held(engine):
    """A 1.5 s window holds a /search; /healthz answers from C++ meanwhile."""
    srv = NativeSearchServer(engine, host="127.0.0.1", port=0, window_ms=1500.0)
    srv.start()
    try:
        srv.warmup()
        done = {}
        search = threading.Thread(target=lambda: done.setdefault(
            "search", _call(srv.port, "POST", "/search", {"query": QUERIES[0], "k": 3})))
        search.start()
        time.sleep(0.2)  # the rider sits in the window
        t0 = time.perf_counter()
        code, body, _ = _call(srv.port, "GET", "/healthz")
        took = time.perf_counter() - t0
        assert code == 200 and json.loads(body) == {"status": "ok"}
        assert search.is_alive() and took < 1.0
        search.join(timeout=60)
        assert not search.is_alive() and done["search"][0] == 200
    finally:
        srv.close()


def test_second_start_raises(native, engine):
    other = NativeSearchServer(engine, host="127.0.0.1", port=0)
    with pytest.raises(OSError, match="another native server"):
        other.start()
    other.service.close()
    assert _call(native.port, "GET", "/healthz")[0] == 200  # the first one still serves


def test_close_frees_the_port(engine):
    srv = serve_native(engine, host="127.0.0.1", port=0, warmup=False)
    port = srv.port
    assert _call(port, "GET", "/readyz")[0] == 503  # not warmed
    srv.close()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
