"""HTTP serving: a dependency-free JSON API over one SearchEngine.

Counterpart of `review_recommender_tpu/serve/api.py:62-920`, with the same
routes, payloads and answers: a thread-per-request stdlib server in front of
one engine, whose concurrent /search requests coalesce in a micro-batcher
into one batched pass (`query_fused_batched_pw`, or
`query_rerank_batched_pw` for riders with a live rerank).

Endpoints:
  GET  /                  the web page (serve/ui.py)
  GET  /healthz           liveness: {"status": "ok"}
  GET  /readyz            readiness: 200 once warmup is done, else 503
  GET  /debug/info        corpus stats, rolling latency percentiles
  GET  /metrics           Prometheus text exposition of the same counters
  POST /search            {"query": "...", "k": 10, ...engine knobs...}
                          -> {"results": [...], "snippets": {...},
                              "debug": {...}, "took_ms": float}
  POST /eval              {"queries": [{"query", "relevant_skus"}...],
                           ...engine knobs...} -> IR metrics
  POST /search_batch      {"queries": [...], "k": 10, shared fusion knobs}
                          -> one batched pass for the whole request; no
                          cross-encoder rerank (w_rerank is forced 0) and
                          one shared weight set; results carry sku + final
  POST /debug/trace       {"query": "...", "n": 8, "host_profile": false}
                          -> n warm queries under torch.profiler; returns
                          the trace directory + timings

Where the port differs: `run_search` returns a list of row dicts (the JAX
engine a DataFrame), so /search answers them as they are; every engine call
a server thread makes runs under `torch.inference_mode()`, which is
thread-local; a CUDA fault is never retried (it is sticky); warmup has no
compile to wait for, but loads the CUDA kernels (on a card) and runs each
coalesced bucket once, so /readyz turns 200 only when no request can
trigger a build.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.engine.hooks import SIGNAL_ORDER, assemble_result_rows
from review_recommender_tpu_torch.utils.numerics import device_fetch
from review_recommender_tpu_torch.utils.text import build_gate_groups, tokenize_query

logger = logging.getLogger(__name__)

SEARCH_KNOBS = (
    "k", "rerank_k", "w_dense", "w_bm25", "w_rerank", "w_prior", "w_best",
    "prior_C", "use_snips", "max_scan", "min_reviews", "gate_penalty",
)

_TRANSIENT_PATTERNS = (
    "failed_precondition", "unavailable", "deadline_exceeded", "internal",
    "connection", "socket", "timed out", "transport", "resource_exhausted",
)
# a CUDA fault (an illegal address, a failed launch, a cuBLAS status after
# one) leaves the context unusable: retrying it only fails every rider twice
_DEVICE_FAULT_PATTERNS = (
    "cuda error", "cudaerror", "cublas_status", "cudnn_status", "illegal memory",
    "illegal address", "device-side assert", "kernel launch failed",
)


def _is_transient_device_error(e: BaseException) -> bool:
    """Retryable transport hiccup vs deterministic failure: OS-level
    connection and timeout errors, and RuntimeErrors whose message names a
    transient status. A CUDA fault is never transient. Anything else (bad
    payload shape -> TypeError/ValueError) fails deterministically."""
    if isinstance(e, (ConnectionError, TimeoutError, OSError)):
        return True
    if isinstance(e, RuntimeError):
        msg = str(e).lower()
        if any(p in msg for p in _DEVICE_FAULT_PATTERNS):
            return False
        return any(p in msg for p in _TRANSIENT_PATTERNS)
    return False


class _Pending:
    __slots__ = ("query", "qvec", "weights", "k", "pool", "use_snips",
                 "rerank_k", "event", "result", "error")

    def __init__(self, query, qvec, weights, k, pool, use_snips, rerank_k=0):
        self.query = query
        self.qvec = qvec
        self.weights = weights
        self.k = k
        self.pool = pool
        self.use_snips = use_snips
        self.rerank_k = rerank_k  # >0 => live cross-encoder lane
        self.event = threading.Event()
        self.result = None
        self.error = None


# each padded batch size is one shape of the batched pass; a window pays
# one device sync, so wider windows raise throughput under load (light
# load still closes windows at window_ms)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# cap on cached escaped row fragments (~4 KB each at 2000-char texts)
ROW_FRAG_CACHE_MAX = 32768


def _debug_fields(engine, req, batch_n, took_ms) -> dict:
    p = engine.products
    tokens = tokenize_query(req.query)
    bm25_active = config.ENABLE_BM25 and any(
        p.idf[p.vocab[t]] > 0 for t in tokens if t in p.vocab)
    return {
        "bm25_active": bool(bm25_active),
        "tokens": tokens,
        "groups": [sorted(g) for g in build_gate_groups(req.query)],
        "pool": req.pool,
        "gate_mode": engine.gate_mode,
        "coalesced": batch_n,
        "batch_ms": round(took_ms, 3),
    }


def _result_snippets(engine, req, rows, n_out) -> dict:
    """Snippet texts of the first n_out result rows (host CSR argmax)."""
    if not (req.use_snips and engine.reviews is not None and n_out):
        return {}
    result_rows = np.asarray([int(r) for r in rows[:n_out]], np.int64)
    return engine._snippet_texts(req.qvec, result_rows)


def format_search_result(engine, req, rows, scores, bd, batch_n, took_ms) -> dict:
    """One /search response dict from a coalesced pass's outputs (shared by
    the Python MicroBatcher and the native front end). Row dicts come from
    the engine's assemble_result_rows; `bd` is the (k, len(SIGNAL_ORDER))
    signal block."""
    bd = np.asarray(bd)
    out_rows = assemble_result_rows(
        engine.products, rows, scores, {name: bd[:, i] for i, name in enumerate(SIGNAL_ORDER)})
    return {
        "results": out_rows,
        "snippets": _result_snippets(engine, req, rows, len(out_rows)),
        "debug": _debug_fields(engine, req, batch_n, took_ms),
        "took_ms": round(took_ms, 3),
    }


def _row_fragment(engine, ridx: int) -> str:
    """JSON fragment (no braces) of a result row's static fields (sku,
    n_reviews, avg_stars, last_ts, agg_text), cached per engine: escaping
    the multi-KB agg_text is the expensive part of a response, and top rows
    repeat across queries. Built with json.dumps, so the bytes equal the
    dict path's."""
    cache = engine.__dict__.setdefault("_row_json_frag", {})
    frag = cache.get(ridx)
    if frag is None:
        p = engine.products
        d = {"sku": p.skus[ridx], "n_reviews": float(p.n_reviews[ridx]),
             "avg_stars": float(p.avg_stars[ridx])}
        if p.last_ts:
            d["last_ts"] = p.last_ts[ridx]
        d["agg_text"] = p.agg_texts[ridx]
        frag = json.dumps(d)[1:-1]
        # bounded: a periodic clear re-warms in a few windows
        if len(cache) >= ROW_FRAG_CACHE_MAX:
            cache.clear()
        cache[ridx] = frag
    return frag


# built from SIGNAL_ORDER so the byte path cannot desync from the dict path
_SIG_FMT = "".join(f', "_{name}": %r' for name in SIGNAL_ORDER) + ', "_final": %r}'


def format_search_result_bytes(engine, req, rows, scores, bd, batch_n, took_ms) -> bytes:
    """format_search_result serialized: the response body, byte-identical
    to json.dumps(format_search_result(...)), with the static row fields
    from the _row_fragment cache and only the eight per-row floats
    formatted fresh (%r of a float is what json.dumps writes). The native
    front end's window callback uses it."""
    parts = []
    for rank in range(len(rows)):
        s = float(scores[rank])
        if not math.isfinite(s):
            # top-k pads the tail with -inf; a non-finite score before the
            # pad tail is a numerics fault upstream: say so
            if any(math.isfinite(float(scores[r])) for r in range(rank + 1, len(rows))):
                logger.warning("non-finite score at rank %d of %d (finite rows follow): "
                               "response truncated; query=%r", rank, len(rows), req.query)
            break
        sig = bd[rank]
        parts.append("{" + _row_fragment(engine, int(rows[rank])) + _SIG_FMT % (
            tuple(float(sig[i]) for i in range(len(SIGNAL_ORDER))) + (s,)))
    tail = json.dumps({
        "snippets": _result_snippets(engine, req, rows, len(parts)),
        "debug": _debug_fields(engine, req, batch_n, took_ms),
        "took_ms": round(took_ms, 3),
    })[1:-1]
    return ('{"results": [' + ", ".join(parts) + "], " + tail + "}").encode()


@torch.inference_mode()
def run_coalesced_batch(engine, batch, buckets=BATCH_BUCKETS, stats=None,
                        formatter=format_search_result):
    """Run a window of _Pending search requests as batched passes, setting
    each request's .result or .error (events are not touched: the
    MicroBatcher does that; the native server has none). stats, if given,
    gets .batches/.coalesced bumped. formatter: format_search_result (dict
    results, the Python server) or format_search_result_bytes (the native
    front end)."""
    # group by pass shape (k, pool, use_snips, rerank lane); weights are
    # per-query. Rerank riders share one coalesced cross-encoder pass.
    groups: dict = {}
    for r in batch:
        groups.setdefault((r.k, r.pool, r.use_snips, r.rerank_k > 0), []).append(r)
    for (k, pool, use_snips, rerank), reqs in groups.items():
        n = len(reqs)
        bucket = next(b for b in buckets if b >= n)
        pad = bucket - n
        qvecs = np.stack([r.qvec for r in reqs] + [reqs[-1].qvec] * pad)
        queries = [r.query for r in reqs] + [reqs[-1].query] * pad
        weights = [r.weights for r in reqs] + [reqs[-1].weights] * pad
        if rerank:
            # padding riders carry rerank_k=0: no cross-encoder pairs
            rerank_ks = [r.rerank_k for r in reqs] + [0] * pad
            call = lambda: engine.query_rerank_batched_pw(
                qvecs, queries, weights, rerank_ks, pool, k, use_snips=use_snips)
        else:
            call = lambda: engine.query_fused_batched_pw(
                qvecs, queries, weights, pool, k, use_snips=use_snips)
        t0 = time.perf_counter()
        try:
            rows, scores, bd = device_fetch(*call())
        except Exception as e:
            # one retry of a transient transport error before failing every
            # rider; deterministic errors and CUDA faults fail at once
            if not _is_transient_device_error(e):
                for r in reqs:
                    r.error = e
                continue
            logger.warning("micro-batch device call failed; retrying", exc_info=True)
            try:
                rows, scores, bd = device_fetch(*call())
            except Exception as e2:
                for r in reqs:
                    r.error = e2
                continue
        took = (time.perf_counter() - t0) * 1e3
        if stats is not None:
            stats.batches += 1
            stats.coalesced += n
        for i, r in enumerate(reqs):
            try:
                r.result = formatter(engine, r, rows[i], scores[i], bd[i], n, took)
            except Exception as e:  # a formatting fault fails its own rider only
                r.error = e


@torch.inference_mode()
def warmup_coalesced_buckets(engine, k, pool, dim, max_batch, use_snips=False,
                             buckets=BATCH_BUCKETS):
    """Run the coalesced pass once at every bucket size up to max_batch
    (and the coalesced rerank pass, with no pairs, when a cross-encoder is
    attached): allocator pools and library handles are set up before the
    first burst. Shared by the Python micro-batcher and the native front
    end."""
    qvec = np.zeros(dim, np.float32)
    qvec[0] = 1.0
    weights = (0.5, 0.2, 0.0, 0.2, 0.1, 20.0, 0.0, 0.5)
    warm_rerank = engine.cross_encoder is not None
    for b in buckets:
        if b > max_batch:
            break
        device_fetch(*engine.query_fused_batched_pw(
            np.stack([qvec] * b), ["warmup query"] * b, [weights] * b, pool, k,
            use_snips=use_snips))
        if warm_rerank:
            device_fetch(*engine.query_rerank_batched_pw(
                np.stack([qvec] * b), ["warmup query"] * b, [weights] * b, [0] * b, pool, k,
                use_snips=use_snips))


class MicroBatcher:
    """Cross-request micro-batching: concurrent /search requests arriving
    within a short window coalesce into ONE batched pass
    (query_fused_batched_pw: per-query fusion weights ride in the combined
    buffer), so concurrent clients reach the engine's batched throughput.
    Batch sizes are padded up to fixed buckets."""

    BUCKETS = BATCH_BUCKETS  # one ladder for both front ends

    def __init__(self, engine, window_ms: float = None, max_batch: int = None):
        self.engine = engine
        self.window = (config.MICROBATCH_WINDOW_MS if window_ms is None else window_ms) / 1e3
        self.max_batch = min(max_batch or config.MICROBATCH_MAX, self.BUCKETS[-1])
        self._cv = threading.Condition()
        self._pending: list = []
        self._closed = False
        self.batches = 0  # passes dispatched
        self.coalesced = 0  # requests served through them
        self._thread = threading.Thread(target=self._loop, daemon=True, name="rrt-microbatcher")
        self._thread.start()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def warmup_buckets(self, k: int, pool: int, dim: int, use_snips: bool = False) -> None:
        warmup_coalesced_buckets(self.engine, k, pool, dim, self.max_batch,
                                 use_snips=use_snips, buckets=self.BUCKETS)

    def search(self, query: str, qvec, weights, k: int, pool: int, use_snips: bool,
               rerank_k: int = 0, timeout: Optional[float] = None) -> dict:
        req = _Pending(query, qvec, weights, k, pool, use_snips, rerank_k)
        with self._cv:
            self._pending.append(req)
            self._cv.notify()
        if not req.event.wait(config.MICROBATCH_TIMEOUT_S if timeout is None else timeout):
            raise TimeoutError("micro-batch execution timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------- internals
    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                # collect within the window; close() flushes immediately
                deadline = time.perf_counter() + self.window
                while len(self._pending) < self.max_batch and not self._closed:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._pending[: self.max_batch]
                del self._pending[: len(batch)]
            try:
                run_coalesced_batch(self.engine, batch, buckets=self.BUCKETS, stats=self)
            except Exception as e:  # the loop must keep serving: fail this window
                logger.exception("micro-batch failed")
                for r in batch:
                    r.error = e
            for r in batch:
                r.event.set()


def _env_trace_enabled() -> bool:
    return os.getenv("ENABLE_DEBUG_TRACE", "false").lower() == "true"


class SearchService:
    """Engine wrapper with warmup and request stats; one engine serves all
    handler threads."""

    def __init__(self, engine):
        from review_recommender_tpu_torch.utils.profiling import LatencyStats

        self.engine = engine
        self.ready = False
        self.stats = {"requests": 0, "errors": 0, "total_ms": 0.0}
        self.latency = LatencyStats()
        self._lock = threading.Lock()
        self.native_stats = None  # set by serve/native_server.py
        self.batcher = None
        if config.ENABLE_MICROBATCH and engine.gate_mode == "device":
            self.batcher = MicroBatcher(engine)

    def close(self):
        if self.batcher is not None:
            self.batcher.close()

    def count_error(self) -> None:
        with self._lock:
            self.stats["errors"] += 1

    def count_requests(self, n: int, took_ms: float) -> None:
        with self._lock:
            self.stats["requests"] += n
            self.stats["total_ms"] += took_ms

    def coalesce_eligible(self, payload: dict) -> bool:
        """A /search request can ride a coalesced pass unless it needs the
        exact-mode snippet scan (max_scan) or the host gate mode. Rerank
        requests coalesce too (query_rerank_batched_pw)."""
        if self.engine.gate_mode != "device":
            return False
        return int(payload.get("max_scan", 0) or 0) == 0

    def _batchable(self, payload: dict) -> bool:
        return self.batcher is not None and self.coalesce_eligible(payload)

    def _rerank_k_live(self, payload: dict) -> int:
        """Live-rerank depth of the coalesced path: 0 when the
        cross-encoder is absent or disabled (those requests ride the plain
        fused pass, whose zero rerank column matches run_search's degraded
        lanes)."""
        rerank_k = int(payload.get("rerank_k", config.DEFAULT_RERANK_K))
        if rerank_k > 0 and self.engine.cross_encoder is not None and config.ENABLE_RERANKING:
            return rerank_k
        return 0

    def parse_search_payload(self, payload: dict) -> _Pending:
        """A /search payload as a coalesced-path request (shared by the
        Python micro-batcher and the native front end); encodes the query
        when no qvec is given."""
        c = config
        g = lambda name, dflt: payload.get(name, dflt)
        k = int(g("k", c.DEFAULT_K))
        pool = max(k, int(g("rerank_k", c.DEFAULT_RERANK_K)), c.DEFAULT_POOL_SIZE)
        pool = min(pool, self.engine.products.n_padded)
        weights = (
            float(g("w_dense", c.DEFAULT_W_DENSE)),
            float(g("w_bm25", c.DEFAULT_W_BM25)),
            float(g("w_rerank", c.DEFAULT_W_RERANK)),
            float(g("w_prior", c.DEFAULT_W_PRIOR)),
            float(g("w_best", c.DEFAULT_W_BEST)),
            float(g("prior_C", c.DEFAULT_PRIOR_C)),
            float(g("min_reviews", c.DEFAULT_MIN_REVIEWS)),
            float(g("gate_penalty", c.DEFAULT_GATE_PENALTY)),
        )
        if "qvec" in payload:
            qvec = np.asarray(payload["qvec"], dtype=np.float32)
        else:
            qvec = self.engine.encode_query(payload["query"])
        use_snips = bool(g("use_snips", False)) and config.ENABLE_SNIPPETS
        return _Pending(payload["query"], qvec, weights, k, pool, use_snips,
                        rerank_k=self._rerank_k_live(payload))

    WARMUP_KS = (5, 10, 20)  # common top-k values

    @torch.inference_mode()
    def warmup(self, qvec_dim: Optional[int] = None,
               coalesce_max_batch: Optional[int] = None) -> None:
        """Load the CUDA kernels (on a card), run run_search at the common
        k values, and run the coalesced pass at every bucket (even without
        a Python micro-batcher when coalesce_max_batch is given: the native
        front end dispatches the same passes). /readyz turns 200 after."""
        if self.engine.device.type == "cuda":
            from review_recommender_tpu_torch import kernels

            kernels.load()
        dim = qvec_dim or self.engine.products.dim
        qvec = np.zeros(dim, np.float32)
        qvec[0] = 1.0
        for k in sorted(set(self.WARMUP_KS) | {config.DEFAULT_K}):
            self.engine.run_search("warmup query", qvec=qvec, k=k, rerank_k=0)
        if self.batcher is not None or coalesce_max_batch:
            pool = min(max(config.DEFAULT_K, config.DEFAULT_RERANK_K, config.DEFAULT_POOL_SIZE),
                       self.engine.products.n_padded)
            if self.batcher is not None:
                self.batcher.warmup_buckets(config.DEFAULT_K, pool, dim)
                self.search({"query": "warmup query", "qvec": qvec.tolist(), "rerank_k": 0})
            else:
                warmup_coalesced_buckets(self.engine, config.DEFAULT_K, pool, dim,
                                         coalesce_max_batch)
        self.ready = True

    def search(self, payload: dict) -> dict:
        query = payload.get("query", "")
        if not query:
            raise ValueError("missing 'query'")
        t0 = time.perf_counter()
        if self._batchable(payload):
            r = self.parse_search_payload(payload)
            out = self.batcher.search(r.query, r.qvec, r.weights, r.k, r.pool, r.use_snips,
                                      rerank_k=r.rerank_k)
            took_s = time.perf_counter() - t0
            out["took_ms"] = round(took_s * 1e3, 3)
            self.latency.record(took_s)
            self.count_requests(1, out["took_ms"])
            return out
        kwargs = {k: payload[k] for k in SEARCH_KNOBS if k in payload}
        if "qvec" in payload:
            kwargs["qvec"] = np.asarray(payload["qvec"], dtype=np.float32)
        rows, snips, debug = self.engine.run_search(query, **kwargs)
        took_s = time.perf_counter() - t0
        self.latency.record(took_s)
        self.count_requests(1, took_s * 1e3)
        return {"results": rows, "snippets": snips, "debug": debug,
                "took_ms": round(took_s * 1e3, 3)}

    def search_batch(self, payload: dict) -> dict:
        """Batched retrieval: one batched pass for all queries."""
        from review_recommender_tpu_torch.ops.fusion import FusionWeights

        queries = payload.get("queries") or []
        if not queries:
            raise ValueError("missing 'queries'")
        c = config
        g = lambda name, dflt: payload.get(name, dflt)
        k = int(g("k", c.DEFAULT_K))
        pool = int(g("pool", max(k, c.DEFAULT_POOL_SIZE)))
        w = FusionWeights.make(
            g("w_dense", c.DEFAULT_W_DENSE), g("w_bm25", c.DEFAULT_W_BM25),
            0.0,  # rerank is a per-query host hook; not on the batch path
            g("w_prior", c.DEFAULT_W_PRIOR), g("w_best", c.DEFAULT_W_BEST),
            g("prior_C", c.DEFAULT_PRIOR_C), g("min_reviews", c.DEFAULT_MIN_REVIEWS),
            g("gate_penalty", c.DEFAULT_GATE_PENALTY),
        )
        if "qvecs" in payload:
            qvecs = np.asarray(payload["qvecs"], dtype=np.float32)
        else:
            enc = self.engine.query_encoder
            if enc is None:
                raise ValueError("no query encoder; pass 'qvecs'")
            if hasattr(enc, "encode"):
                qvecs = np.asarray(enc.encode(queries), dtype=np.float32)
            else:
                qvecs = np.stack([np.asarray(enc(q), np.float32) for q in queries])
        t0 = time.perf_counter()
        rows, scores = device_fetch(*self.engine.query_fused_batched(
            qvecs, queries, w, pool, k, use_snips=bool(g("use_snips", False))))
        took = (time.perf_counter() - t0) * 1e3
        skus = self.engine.products.skus
        results = [[{"sku": skus[int(r)], "_final": float(s)}
                    for r, s in zip(rows[b], scores[b]) if np.isfinite(s)]
                   for b in range(len(queries))]
        self.count_requests(len(queries), took)
        return {"results": results, "took_ms": round(took, 3), "batch": len(queries)}

    def evaluate(self, payload: dict) -> dict:
        """BYO dev-set eval: run the engine over judged queries."""
        from review_recommender_tpu_torch.evals.metrics import IRMetrics

        queries = payload.get("queries") or []
        if not queries:
            raise ValueError("missing 'queries'")
        kwargs = {k: payload[k] for k in SEARCH_KNOBS if k in payload}
        metrics = IRMetrics()
        for q in queries:
            if "query" not in q:
                raise ValueError("each entry needs a 'query'")
            rows, _s, _d = self.engine.run_search(q["query"], **kwargs)
            metrics.evaluate_query(q.get("id", q["query"]), [r["sku"] for r in rows],
                                   set(q.get("relevant_skus", [])))
        return {"aggregate": metrics.aggregate_metrics(), "per_query": metrics.rows}

    def trace(self, payload: dict) -> dict:
        """POST /debug/trace: a torch.profiler trace around n warm serving
        queries, written as a Chrome trace (utils/profiling.py:TRACE_FILE)
        into a directory under LOG_FILE's parent, never a client-supplied
        path. Disabled in production unless ENABLE_DEBUG_TRACE=true."""
        from review_recommender_tpu_torch.utils.profiling import device_trace

        if config.is_production() and not _env_trace_enabled():
            raise ValueError("/debug/trace is disabled in production "
                             "(set ENABLE_DEBUG_TRACE=true to allow it)")
        query = str(payload.get("query", "wireless noise cancelling headphones"))
        n = max(1, min(int(payload.get("n", 8)), 64))
        log_dir = str(Path(config.LOG_FILE).parent / "traces" / time.strftime("%Y%m%d-%H%M%S"))
        req = {k: payload[k] for k in SEARCH_KNOBS if k in payload}
        req["query"] = query
        self.search(req)  # warm outside the trace window
        t0 = time.perf_counter()
        with device_trace(log_dir, host_profile=bool(payload.get("host_profile"))):
            for _ in range(n):
                out = self.search(req)
        took = (time.perf_counter() - t0) * 1e3
        return {"log_dir": log_dir, "n": n, "total_ms": round(took, 3),
                "ms_per_query": round(took / n, 3),
                "stage_ms": out.get("debug", {}).get("stage_ms", {})}

    def info(self) -> dict:
        p = self.engine.products
        return {
            "n_docs": p.n_docs,
            "n_padded": p.n_padded,
            "dim": p.dim,
            "vocab_size": len(p.vocab),
            "has_reviews": self.engine.reviews is not None,
            "gate_mode": self.engine.gate_mode,
            "emb_dtype": str(self.engine.dtype).removeprefix("torch."),
            "ready": self.ready,
            "stats": dict(self.stats),
            "latency": self.latency.summary(),
            "microbatch": (
                {"batches": self.batcher.batches, "coalesced": self.batcher.coalesced,
                 "window_ms": self.batcher.window * 1e3, "max_batch": self.batcher.max_batch}
                if self.batcher is not None else None),
            # set when the C++ front end fields the requests
            "native_server": self.native_stats() if self.native_stats is not None else None,
        }

    def metrics_text(self) -> str:
        """GET /metrics: Prometheus text exposition (format 0.0.4) of the
        serving counters."""
        lines = []

        def emit(name, value, mtype, help_=None, labels=""):
            if help_:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name}{labels} {value}")

        emit("rrt_requests_total", int(self.stats["requests"]), "counter",
             "Search requests served")
        emit("rrt_errors_total", int(self.stats["errors"]), "counter",
             "Requests that returned an error")
        emit("rrt_request_seconds_sum", round(self.stats["total_ms"] / 1e3, 6), "counter",
             "Total request wall time")
        lat = self.latency.summary()
        if lat.get("count"):
            lines.append("# HELP rrt_request_latency_seconds Rolling "
                         "request latency (4096-sample reservoir)")
            lines.append("# TYPE rrt_request_latency_seconds summary")
            for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"), ("0.99", "p99_ms")):
                lines.append(f'rrt_request_latency_seconds{{quantile="{q}"}} '
                             f'{lat[key] / 1e3:.6f}')
            lines.append(f"rrt_request_latency_seconds_count {lat['count']}")
        emit("rrt_ready", int(bool(self.ready)), "gauge", "1 once warmup completed")
        p = self.engine.products
        emit("rrt_index_docs", int(p.n_docs), "gauge", "Corpus documents")
        emit("rrt_index_has_reviews", int(self.engine.reviews is not None), "gauge",
             "1 when review embeddings are loaded")
        if self.batcher is not None:
            emit("rrt_microbatch_windows_total", int(self.batcher.batches), "counter",
                 "Micro-batch windows executed")
            emit("rrt_microbatch_coalesced_total", int(self.batcher.coalesced), "counter",
                 "Requests that rode a shared window")
        if self.native_stats is not None:
            for k, v in sorted((self.native_stats() or {}).items()):
                if isinstance(v, (int, float)):
                    emit(f"rrt_native_{k}", v, "counter")
        return "\n".join(lines) + "\n"


POST_ROUTES = {"/search": "search", "/eval": "evaluate",
               "/search_batch": "search_batch", "/debug/trace": "trace"}


@torch.inference_mode()
def route_request(service: SearchService, method: str, path: str, body: bytes):
    """Route one HTTP request -> (status, body bytes, content type). The
    single source of routing for both servers: the stdlib handler below and
    the native front end's fallback callback."""
    js = lambda code, obj: (code, json.dumps(obj).encode(), "application/json")
    if method == "GET":
        if path in ("/", "/index.html"):
            from review_recommender_tpu_torch.serve.ui import page

            return (200, page(metrics_tab=config.ENABLE_METRICS_TAB).encode(),
                    "text/html; charset=utf-8")
        if path == "/healthz":
            return js(200, {"status": "ok"})
        if path == "/readyz":
            return js(200 if service.ready else 503, {"ready": service.ready})
        if path == "/debug/info":
            return js(200, service.info())
        if path == "/metrics":
            return (200, service.metrics_text().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        return js(404, {"error": "not found"})
    if method == "POST":
        handler_name = POST_ROUTES.get(path)
        if handler_name is None:
            return js(404, {"error": "not found"})
        if path == "/eval" and not config.ENABLE_METRICS_TAB:
            return js(404, {"error": "metrics endpoint disabled (ENABLE_METRICS_TAB=false)"})
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
            return js(200, getattr(service, handler_name)(payload))
        except ValueError as e:
            service.count_error()
            return js(400, {"error": str(e)})
        except Exception as e:  # the server answers 500 and keeps serving
            logger.exception("search failed")
            service.count_error()
            return js(500, {"error": f"{type(e).__name__}: {e}"})
    return js(404, {"error": "not found"})


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            self._reply(*route_request(service, "GET", self.path, b""))

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            self._reply(*route_request(service, "POST", self.path, body))

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

    return Handler


def serve(engine, host: Optional[str] = None, port: Optional[int] = None,
          warmup: bool = True, warmup_async: bool = False) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever()). The socket
    binds before warmup, so /healthz answers during it; /readyz turns 200
    when warmup completes. port=0 takes an ephemeral port."""
    service = SearchService(engine)

    class _Server(ThreadingHTTPServer):
        # the stdlib listen backlog of 5 resets a burst of concurrent clients
        request_queue_size = 128
        daemon_threads = True

    srv = _Server((host or config.APP_HOST, config.APP_PORT if port is None else port),
                  make_handler(service))
    srv.service = service  # for tests/introspection
    if warmup:
        if warmup_async:
            threading.Thread(target=service.warmup, daemon=True).start()
        else:
            service.warmup()
    return srv
