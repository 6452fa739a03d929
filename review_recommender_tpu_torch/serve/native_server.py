"""Python side of the native HTTP front end (native/server.cc).

Counterpart of `review_recommender_tpu/serve/native_server.py:54-261`, on
the port's own library (native/__init__.py). The C++ event loop owns every
socket: accept, HTTP/1.1 parse, keep-alive, micro-batch window assembly,
response writes. Python is entered twice per unit of work:

  - once per /search WINDOW (the batch callback): json-decode each rider,
    run them through the micro-batcher's coalesced path
    (serve/api.py:run_coalesced_batch) with pre-serialized responses
    (format_search_result_bytes);
  - once per other request (the fallback callback), routed through
    serve/api.py:route_request, so every other route answers as the
    stdlib server does.

GET /healthz never reaches Python (answered in C++), so liveness answers
while a window is held or the GIL is busy. One server per process (the C++
side holds a single instance). The library builds or the constructor
raises: there is no fallback to the stdlib server here.
"""
from __future__ import annotations

import atexit
import ctypes
import json
import logging
import socket
import threading
import time
import types
from typing import Optional

import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.native import (
    RRT_BATCH_CB,
    RRT_FALLBACK_CB,
    _lib,
    native_server_available,
)
from review_recommender_tpu_torch.serve.api import (
    BATCH_BUCKETS,
    SearchService,
    format_search_result_bytes,
    route_request,
    run_coalesced_batch,
)

logger = logging.getLogger(__name__)


class NativeSearchServer:
    """Owns the native event loop's lifetime and its two Python callbacks.
    start() raises if another native server is live in this process."""

    def __init__(self, engine_or_service, host: Optional[str] = None,
                 port: Optional[int] = None, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        if not native_server_available():
            raise RuntimeError("the port's native library has no HTTP server entry points")
        self.service = (engine_or_service if isinstance(engine_or_service, SearchService)
                        else SearchService(engine_or_service))
        # the native loop does its own windowing and calls run_coalesced_batch
        # directly: a Python micro-batcher would only add a second rendezvous
        if self.service.batcher is not None:
            self.service.batcher.close()
            self.service.batcher = None
        self.host = host or config.APP_HOST
        self.port = config.APP_PORT if port is None else port
        self.window_ms = config.MICROBATCH_WINDOW_MS if window_ms is None else window_ms
        # clamp like MicroBatcher: a window wider than the largest bucket
        # would fail the bucket lookup for every rider of a full window
        self.max_batch = min(max_batch or config.MICROBATCH_MAX, BATCH_BUCKETS[-1])
        # device-pass counters (the C++ side counts HTTP-level units)
        self.batch_stats = types.SimpleNamespace(batches=0, coalesced=0)
        self.service.native_stats = self.stats  # /debug/info hook
        self._lib = _lib()
        # callback objects stay referenced for the server's lifetime: a
        # collected CFUNCTYPE leaves the C++ side with a dangling pointer
        self._batch_cb = RRT_BATCH_CB(self._on_batch)
        self._fallback_cb = RRT_FALLBACK_CB(self._on_fallback)
        self._started = False
        # serializes the callbacks' engine use against other threads
        self._dispatch_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Bind and start the event loop thread; returns the bound port."""
        # the C++ side parses a dotted quad (inet_addr): resolve names here
        try:
            host_ip = socket.gethostbyname(self.host)
        except OSError:
            host_ip = self.host  # bind() reports the real error
        port = self._lib.rrt_server_start(host_ip.encode(), int(self.port),
                                          float(self.window_ms), int(self.max_batch),
                                          self._batch_cb, self._fallback_cb)
        if port < 0:
            raise OSError(f"native server failed to bind {self.host}:{self.port} (port in "
                          "use, or another native server is running in this process)")
        self.port = int(port)
        self._started = True
        atexit.register(self.close)  # never leave the loop calling into a
        # tearing-down interpreter
        logger.info("native server on http://%s:%d", self.host, self.port)
        return self.port

    def close(self) -> None:
        if self._started:
            self._lib.rrt_server_stop()
            self._started = False
            atexit.unregister(self.close)
        self.service.close()

    def warmup(self) -> None:
        # also runs the coalesced bucket passes the C++ windowing dispatches
        self.service.warmup(coalesce_max_batch=self.max_batch)

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 4)()
        self._lib.rrt_server_stats(out)
        return {"requests": int(out[0]), "windows": int(out[1]),
                "coalesced": int(out[2]), "fallbacks": int(out[3]),
                "device_batches": self.batch_stats.batches,
                "device_coalesced": self.batch_stats.coalesced,
                "window_ms": self.window_ms, "max_batch": self.max_batch}

    # ------------------------------------------------------------ callbacks
    def _reply(self, i: int, status: int, obj, ctype=b"application/json"):
        body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
        self._lib.rrt_server_reply(i, status, ctype, body, len(body))

    def _on_batch(self, bodies, lens, n):
        """One window of raw POST /search bodies -> one coalesced device
        dispatch. Riders the coalesced path cannot serve (max_scan, host
        gate) run service.search one by one, as the stdlib server does."""
        try:
            with self._dispatch_lock, torch.inference_mode():
                self._run_window(bodies, lens, int(n))
        except Exception as e:  # a raise cannot cross the ctypes boundary
            logger.exception("native batch callback failed")
            for i in range(int(n)):
                self._reply(i, 500, {"error": f"{type(e).__name__}: {e}"})

    def _run_window(self, bodies, lens, n):
        service = self.service
        pendings = []  # (index, _Pending)
        for i in range(n):
            try:
                payload = json.loads(ctypes.string_at(bodies[i], lens[i]) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
                if not payload.get("query"):
                    raise ValueError("missing 'query'")
                if service.coalesce_eligible(payload):
                    pendings.append((i, service.parse_search_payload(payload)))
                else:
                    self._reply(i, 200, service.search(payload))
            except ValueError as e:
                service.count_error()
                self._reply(i, 400, {"error": str(e)})
            except Exception as e:  # this rider fails; the window goes on
                logger.exception("native /search failed")
                service.count_error()
                self._reply(i, 500, {"error": f"{type(e).__name__}: {e}"})
        if not pendings:
            return
        # time only the coalesced dispatch: the ineligible riders above
        # recorded their own latency. The embedded took_ms is the device
        # batch's time (a timing field, outside the server-equality contract)
        t0 = time.perf_counter()
        run_coalesced_batch(service.engine, [p for _, p in pendings], stats=self.batch_stats,
                            formatter=format_search_result_bytes)
        took_s = time.perf_counter() - t0
        for i, p in pendings:
            if p.error is not None:
                service.count_error()
                self._reply(i, 500, {"error": f"{type(p.error).__name__}: {p.error}"})
                continue
            service.latency.record(took_s)
            service.count_requests(1, round(took_s * 1e3, 3))
            self._reply(i, 200, p.result)

    def _on_fallback(self, method, path, body, body_len):
        try:
            with self._dispatch_lock:
                status, payload, ctype = route_request(
                    self.service, method.decode(), path.decode(),
                    ctypes.string_at(body, body_len) if body_len else b"")
            self._reply(0, status, payload, ctype.encode())
        except Exception as e:  # a raise cannot cross the ctypes boundary
            logger.exception("native fallback callback failed")
            self._reply(0, 500, {"error": f"{type(e).__name__}: {e}"})


def serve_native(engine, host: Optional[str] = None, port: Optional[int] = None,
                 warmup: bool = True, warmup_async: bool = False) -> NativeSearchServer:
    """serve/api.py:serve's native twin: bind first (/healthz answers from
    C++ during warmup), then warm up; /readyz turns 200 when done. Raises
    when the native library cannot be built."""
    srv = NativeSearchServer(engine, host=host, port=port)
    srv.start()
    if warmup:
        if warmup_async:
            threading.Thread(target=srv.warmup, daemon=True).start()
        else:
            srv.warmup()
    return srv
