"""ctypes binding of the port's native host library (librrt_native).

`tokenizer.cc`, `featurizer.cc` and `server.cc` here are byte-for-byte
copies of `review_recommender_tpu/native/` (a test holds them equal). They
are built on first use into one shared library:

    g++ -O3 -march=native -fPIC -std=c++17 -pthread -shared
        -o build/torch_native/librrt_native_<hash>.so <the three sources>

The name carries a hash of the sources and flags, so an edit rebuilds it;
`build/` is ignored by git. Concurrent builds (test workers, two
processes) serialise on a file lock and each builds to a temporary name
that `os.replace` moves into place, so every process loads one complete
library. Nothing here runs at import time.

There is no fallback: a missing compiler, a failed build or a failed load
raises with the compiler's output. The Python featurizer and document
tokenizer run only when a caller asks for them
(`QueryFeaturizer(native=False)`, `tokenize_document(native=False)`,
`build_product_index(tokenizer="python")`).

Parity contract (as in the JAX package): the native scanners are byte-level
ASCII, so callers route non-ASCII queries and tokens to the Python path;
Unicode lowercasing can make ASCII letters (U+212A KELVIN SIGN lowers to
'k') that a byte scanner cannot see.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from numpy.ctypeslib import ndpointer

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = ("tokenizer.cc", "featurizer.cc", "server.cc")
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_load_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
build_info: dict = {}

# native HTTP server callback signatures (server.cc): the batch callback
# receives a window of raw POST /search bodies; the fallback callback one
# (method, path, body) request. Both reply via rrt_server_reply DURING the
# call (the server copies bytes immediately).
RRT_BATCH_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
)
RRT_FALLBACK_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_int64,
)


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"librrt_native_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the three sources into the hashed library unless it exists
    (or `force`). Returns its path; `build_info` records the seconds taken
    and the compiler's output. Raises RuntimeError when there is no
    compiler or the build fails."""
    out = library_path()
    if out.exists() and not force:
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"C++ compiler {CXX!r} not found on PATH: the port's native "
                           "host library (featurizer, HTTP front end) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists() and not force:  # another process built it meanwhile
            build_info.update(path=str(out), seconds=0.0, cached=True)
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}".strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native library build failed (rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs, cached=False, compiler_output=log)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry the port calls."""
    c_i64, c_p = ctypes.c_int64, ctypes.c_char_p
    lib.rrt_tokenize_batch.restype = c_i64
    lib.rrt_tokenize_batch.argtypes = [c_p, ndpointer(np.int64, flags="C"), c_i64, c_p, c_i64,
                                       c_i64, ndpointer(np.int64, flags="C,W")]
    lib.rrt_build_postings.restype = c_i64
    lib.rrt_build_postings.argtypes = [
        c_p, ndpointer(np.int64, flags="C"), c_i64, c_i64, c_i64,
        ndpointer(np.int32, flags="C,W"), ndpointer(np.float32, flags="C,W"),
        ndpointer(np.float32, flags="C,W"), ndpointer(np.int32, flags="C,W"),
        c_p, c_i64, c_i64, ctypes.POINTER(c_i64),
    ]
    lib.rrt_substring_scan.restype = c_i64
    lib.rrt_substring_scan.argtypes = [c_p, c_i64, c_p, c_i64,
                                       ndpointer(np.int32, flags="C,W"), c_i64]
    lib.rrt_featurizer_create.restype = ctypes.c_void_p
    lib.rrt_featurizer_create.argtypes = [
        c_p, c_i64, ndpointer(np.int32, flags="C"), ndpointer(np.float32, flags="C"), c_i64,
        c_p, c_i64,  # phrases
        c_p, c_i64,  # colors
        c_p, c_i64,  # synonyms
        c_p, c_i64,  # stopwords
        c_i64, c_i64,  # q_cap, t_cap
    ]
    lib.rrt_featurizer_destroy.restype = None
    lib.rrt_featurizer_destroy.argtypes = [ctypes.c_void_p]
    lib.rrt_featurizer_packed_len.restype = c_i64
    lib.rrt_featurizer_packed_len.argtypes = [ctypes.c_void_p]
    lib.rrt_featurize.restype = c_i64
    lib.rrt_featurize.argtypes = [ctypes.c_void_p, c_p, c_i64,
                                  ndpointer(np.float32, flags="C,W")]
    lib.rrt_featurizer_expand.restype = c_i64
    lib.rrt_featurizer_expand.argtypes = [ctypes.c_void_p, c_p, c_i64,
                                          ndpointer(np.int32, flags="C,W"), c_i64]
    lib.rrt_featurize_batch.restype = c_i64
    lib.rrt_featurize_batch.argtypes = [ctypes.c_void_p, c_p, ndpointer(np.int64, flags="C"),
                                        c_i64, ndpointer(np.float32, flags="C,W")]
    lib.rrt_server_start.restype = c_i64
    lib.rrt_server_start.argtypes = [c_p, ctypes.c_int32, ctypes.c_double, c_i64,
                                     RRT_BATCH_CB, RRT_FALLBACK_CB]
    lib.rrt_server_reply.restype = None
    lib.rrt_server_reply.argtypes = [c_i64, ctypes.c_int32, c_p, c_p, c_i64]
    lib.rrt_server_stop.restype = None
    lib.rrt_server_stop.argtypes = []
    lib.rrt_server_port.restype = ctypes.c_int32
    lib.rrt_server_port.argtypes = []
    lib.rrt_server_running.restype = ctypes.c_int32
    lib.rrt_server_running.argtypes = []
    lib.rrt_server_stats.restype = None
    lib.rrt_server_stats.argtypes = [ctypes.POINTER(ctypes.c_int64)]


def _lib() -> ctypes.CDLL:
    """The library, built on first call, with every entry declared."""
    global _LIB
    with _load_lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _LIB = lib
        return _LIB


def native_server_available() -> bool:
    """True once the library is built and exports the HTTP front end (a
    failed build raises instead)."""
    return hasattr(_lib(), "rrt_server_start")


def _ascii_blobs(texts: Sequence[str], cap: int) -> List[bytes]:
    """Each text as ASCII bytes for the postings build. A non-ASCII text is
    tokenized in Python and its tokens joined by spaces: tokens are ASCII
    ([a-z0-9']), so the byte scanner finds them again in the same order."""
    from review_recommender_tpu_torch.utils.text import tokenize_document

    return [(t if t.isascii() else " ".join(tokenize_document(t, cap, native=False)))
            .encode("ascii") for t in map(str, texts)]


def _offsets(blobs: List[bytes]) -> np.ndarray:
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return offsets


def tokenize_document_native(text: str, cap: int = 5000) -> List[str]:
    """The index tokenizer in C++ (utils/text.py:tokenize_document)."""
    return tokenize_corpus_native([text], cap)[0]


def tokenize_corpus_native(texts: Sequence[str], cap: int = 5000) -> List[List[str]]:
    """tokenize_document_native of every text, the ASCII ones in one call;
    a non-ASCII text takes the Python tokenizer (see the module's parity
    contract)."""
    from review_recommender_tpu_torch.utils.text import tokenize_document

    texts = [str(t) for t in texts]
    results: List[Optional[List[str]]] = [
        None if t.isascii() else tokenize_document(t, cap, native=False) for t in texts]
    ascii_idx = [i for i, r in enumerate(results) if r is None]
    if ascii_idx:
        blobs = [texts[i].encode("ascii") for i in ascii_idx]
        offsets = _offsets(blobs)
        out_cap = int(offsets[-1]) + 2 * len(blobs) + 16  # tokens + separators fit
        out = ctypes.create_string_buffer(out_cap)
        counts = np.zeros(len(blobs), np.int64)
        total = _lib().rrt_tokenize_batch(b"".join(blobs), offsets, len(blobs), out, out_cap,
                                          cap, counts)
        if total < 0:
            raise RuntimeError("native tokenizer output buffer overflow")
        toks = out.value.decode("ascii").split("\n") if total else []
        start = 0
        for i, c in zip(ascii_idx, counts.tolist()):
            results[i] = toks[start: start + c]
            start += c
    return results


def build_postings_native(texts: Sequence[str], doc_terms_cap: int, cap: int = 5000):
    """Tokenize, number terms in first-seen order, count tf and df, and pack
    each document's terms by descending tf (stable) into `doc_terms_cap`
    lanes, in one C++ pass. Returns (doc_terms (N, L) i32, doc_tf (N, L)
    f32, doc_len (N,) f32, df (V+1,) i32, vocab {term: id}, number of
    documents with more than L unique terms)."""
    lib = _lib()
    blobs = _ascii_blobs(texts, cap)
    n, L = len(blobs), int(doc_terms_cap)
    blob = b"".join(blobs)
    doc_terms = np.zeros((max(n, 1), L), np.int32)
    doc_tf = np.zeros((max(n, 1), L), np.float32)
    doc_len = np.zeros(max(n, 1), np.float32)
    vocab_cap = max(len(blob) // 2 + 16, 1024)  # a term takes >= 2 bytes + a separator
    df = np.zeros(vocab_cap + 1, np.int32)
    vocab_out = ctypes.create_string_buffer(len(blob) + 16)
    n_trunc = ctypes.c_int64(0)
    v = lib.rrt_build_postings(blob, _offsets(blobs), n, cap, L, doc_terms, doc_tf, doc_len,
                               df, vocab_out, len(blob) + 16, vocab_cap, ctypes.byref(n_trunc))
    if v < 0:
        raise RuntimeError("native postings build overflowed its buffers")
    terms = vocab_out.value.decode("ascii").split("\n")[:v] if v else []
    vocab = {t: i + 1 for i, t in enumerate(terms)}
    return (doc_terms[:n], doc_tf[:n], doc_len[:n], df[: v + 1].copy(), vocab,
            int(n_trunc.value))


def substring_scan_native(vocab_blob: bytes, token: str, max_hits: int = 4096) -> np.ndarray:
    """int32 ids (1-based line index) of vocab terms containing `token`."""
    lib = _lib()
    needle = token.encode("utf-8", "replace")
    # double the buffer until the hits fit: every vocab line can match (a
    # 1-char token on a large vocab), so the ceiling is the line count, at
    # which point the scan cannot return -1
    cap = max_hits
    while True:
        out = np.zeros(cap, np.int32)
        n = lib.rrt_substring_scan(vocab_blob, len(vocab_blob), needle, len(needle), out, cap)
        if n >= 0:
            return out[: int(n)].copy()
        cap *= 2


class NativeQueryFeaturizer:
    """C++ query featurizer handle: one FFI crossing per query (or batch)
    for tokenize, vocab/idf lookup, gate groups, dynamic-token expansion
    and packing (engine/featurize.py semantics). The attribute tables are
    serialized from utils/text.py at construction, so Python stays the
    single source of truth. ASCII queries only: callers route non-ASCII to
    the Python path. The handle's expansion cache is not thread-safe, so
    calls take a lock (ctypes releases the GIL inside them)."""

    def __init__(self, vocab_blob: bytes, df, idf, query_terms_cap: int, gate_terms_cap: int):
        import weakref

        from review_recommender_tpu_torch.utils.text import (
            COLORS,
            GATE_PHRASES,
            STOP_WORDS,
            SYNONYMS,
        )

        lib = _lib()
        self._lib = lib
        self._lock = threading.Lock()
        self._df = np.ascontiguousarray(df, dtype=np.int32)
        self._idf = np.ascontiguousarray(idf, dtype=np.float32)
        phrases = "\n".join(GATE_PHRASES).encode()
        colors = "\n".join("\t".join(sorted(m)) for m in COLORS.values()).encode()
        synonyms = "\n".join(t + "\t" + "\t".join(sorted(m))
                             for t, m in SYNONYMS.items()).encode()
        stop = "\n".join(sorted(STOP_WORDS)).encode()
        self._h = lib.rrt_featurizer_create(
            vocab_blob, len(vocab_blob), self._df, self._idf, len(self._df),
            phrases, len(phrases), colors, len(colors), synonyms, len(synonyms),
            stop, len(stop), query_terms_cap, gate_terms_cap,
        )
        if not self._h:
            raise RuntimeError("rrt_featurizer_create returned no handle")
        self._finalizer = weakref.finalize(self, lib.rrt_featurizer_destroy, self._h)
        self.packed_len = int(lib.rrt_featurizer_packed_len(self._h))
        self.gate_terms_cap = int(gate_terms_cap)

    def expand_token(self, token: str) -> np.ndarray:
        """Trigram-index dynamic-gate expansion (<= gate_terms_cap int32
        ids), in the Python scan's order."""
        out = np.empty(self.gate_terms_cap, np.int32)
        raw = token.encode("ascii")
        with self._lock:
            n = self._lib.rrt_featurizer_expand(self._h, raw, len(raw), out, self.gate_terms_cap)
        return out[: int(n)].copy()

    def featurize_packed(self, query: str) -> np.ndarray:
        out = np.empty(self.packed_len, np.float32)
        raw = query.encode("ascii")
        with self._lock:
            self._lib.rrt_featurize(self._h, raw, len(raw), out)
        return out

    def featurize_packed_batch(self, queries) -> np.ndarray:
        blobs = [q.encode("ascii") for q in queries]
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        out = np.empty((len(blobs), self.packed_len), np.float32)
        with self._lock:
            self._lib.rrt_featurize_batch(self._h, b"".join(blobs), offsets, len(blobs), out)
        return out
