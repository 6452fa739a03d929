"""The knobs the port reads, from the environment.

The same variable names and defaults as the JAX package's config
(`review_recommender_tpu/config.py`), limited to what the engine reads:
embedding dtype, gate and dense-pool modes (with the IVF pool's knobs),
the query- and document-term caps, the feature flags, the least candidate pool, the search defaults,
the tower directories and mesh width the CLI checks, the reference
deployment's artifact names and postings width that `rrt import` reads, the snippet
index's reviews per product that the offline pipeline keeps, and the server's
address, log path and level, environment and micro-batch knobs. Each knob
is read once, when this module is imported, after `.env` and then
`.env.<ENVIRONMENT>` in the working directory are layered into the
environment as the JAX config layers them (a variable the process already
has is never overridden); tests patch the `config` singleton.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path


def _load_env_file(path: Path, *, override: bool = False) -> None:
    """KEY=VALUE lines of `path` into os.environ (python-dotenv's simple
    case): blank lines and '#' comment lines skipped, an optional 'export '
    prefix, one pair of matching quotes stripped, an inline comment (a '#'
    at the start or after a blank) cut from an unquoted value, and a
    variable the process already has kept unless override=True."""
    if not path.is_file():
        return
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export "):
            line = line[len("export "):]
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        else:
            for i, ch in enumerate(value):
                if ch == "#" and (i == 0 or value[i - 1] in " \t"):
                    value = value[:i].rstrip()
                    break
        if key and (override or key not in os.environ):
            os.environ[key] = value


def load_env_files() -> None:
    """`.env`, then `.env.<ENVIRONMENT>` when the process or `.env` names an
    environment, into os.environ; the process's own variables win."""
    _load_env_file(Path(".env"))
    env = os.getenv("ENVIRONMENT", "")
    if env:
        _load_env_file(Path(f".env.{env.lower()}"))


load_env_files()


def _env_bool(name: str, default: str = "false") -> bool:
    return os.getenv(name, default).lower() == "true"


def _env_int(name: str, default: str) -> int:
    return int(os.getenv(name, default))


def _env_float(name: str, default: str) -> float:
    return float(os.getenv(name, default))


class Config:
    # "production" disables /debug/trace unless ENABLE_DEBUG_TRACE=true
    ENVIRONMENT = os.getenv("ENVIRONMENT", "development")
    APP_HOST = os.getenv("APP_HOST", "0.0.0.0")
    APP_PORT = _env_int("APP_PORT", "8501")
    # /debug/trace writes under this file's directory
    LOG_FILE = os.getenv("LOG_FILE", "logs/app.log")
    LOG_LEVEL = os.getenv("LOG_LEVEL", "INFO").upper()
    LOG_FORMAT = os.getenv(
        "LOG_FORMAT", "%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    # tower directories the CLI loads (models/load.py: an HF snapshot or a
    # native tower); empty = random towers of the JAX CLI's shapes
    EMB_MODEL_DIR = os.getenv("EMB_MODEL_DIR", "")
    RERANK_MODEL_DIR = os.getenv("RERANK_MODEL_DIR", "")

    # device dtype of the corpus embedding matrix: bfloat16, float32,
    # float16, or int8 (per-row symmetric, ops/dense.py:quantize_corpus_int8)
    EMB_DTYPE = os.getenv("EMB_DTYPE", "bfloat16")
    # "device" (term-membership gate, no host sync) or "host" (exact
    # substring semantics, computed on the candidate pool host-side)
    GATE_MODE = os.getenv("GATE_MODE", "device")
    # dense candidate pool: "exact", "striped", "ivf" or "auto" (striped
    # from DENSE_POOL_AUTO_MIN padded rows on, exact below; never ivf)
    DENSE_POOL_MODE = os.getenv("DENSE_POOL_MODE", "auto")
    DENSE_POOL_AUTO_MIN = _env_int("DENSE_POOL_AUTO_MIN", "65536")
    DENSE_POOL_STRIPES = _env_int("DENSE_POOL_STRIPES", "8192")
    # the IVF pool (ops/ivf.py): blocks probed per query; rows per block and
    # centroids, 0 = auto (mean cluster size; ~4*sqrt(N))
    IVF_NPROBE = _env_int("IVF_NPROBE", "64")
    IVF_BLOCK_ROWS = _env_int("IVF_BLOCK_ROWS", "0")
    IVF_CENTROIDS = _env_int("IVF_CENTROIDS", "0")
    # the engine's init self-check of IVF pool recall against the exact
    # pool, on this many corpus rows as queries (0 = off); warns below MIN
    IVF_SELFCHECK_QUERIES = _env_int("IVF_SELFCHECK_QUERIES", "16")
    IVF_SELFCHECK_MIN = _env_float("IVF_SELFCHECK_MIN", "0.95")
    # padded query terms for the BM25 and gate device ops
    QUERY_TERMS_CAP = _env_int("QUERY_TERMS_CAP", "32")
    # padded unique terms per document of an imported bundle's postings;
    # 0 = auto (index/build.py:derive_doc_terms_cap)
    DOC_TERMS_CAP = _env_int("DOC_TERMS_CAP", "512")
    # a reference deployment's artifact names in its data directory
    # (data/pipeline.py:import_reference_artifacts)
    PRODUCT_EMB_FILE = os.getenv("PRODUCT_EMB_FILE", "product_emb.npy")
    PRODUCT_META_FILE = os.getenv("PRODUCT_META_FILE", "product_emb_meta.parquet")
    REVIEWS_EMB_FILE = os.getenv("REVIEWS_EMB_FILE", "reviews_with_embeddings.parquet")
    BM25_FILE = os.getenv("BM25_FILE", "product_bm25.pkl")
    # reviews kept per product for the snippet index
    # (data/prep.py:filter_reviews_for_snippets); 0 disables the cap
    SNIPPET_REVIEWS_CAP = _env_int("SNIPPET_REVIEWS_CAP", "256")
    # devices the corpus is sharded over (parallel/sharded.py; the CLI's
    # --shards); "1" = one device
    MESH_SHARDS = _env_int("MESH_SHARDS", "1")
    # JAX's MESH_AXIS (the shard_map axis name) has no counterpart: the
    # port has no mesh, its shards are a list of devices

    ENABLE_BM25 = _env_bool("ENABLE_BM25", "true")
    ENABLE_RERANKING = _env_bool("ENABLE_RERANKING", "true")
    ENABLE_SNIPPETS = _env_bool("ENABLE_SNIPPETS", "true")
    # the web page's Metrics tab and POST /eval
    ENABLE_METRICS_TAB = _env_bool("ENABLE_METRICS_TAB", "true")

    # the snippet scan's row cap of run_search(max_scan=-1) (the exact host
    # path); the default device path scores every review
    MAX_REVIEWS_SCAN = _env_int("MAX_REVIEWS_SCAN", "300000")

    # least candidate pool of run_search (max with k and rerank_k)
    DEFAULT_POOL_SIZE = _env_int("DEFAULT_POOL_SIZE", "150")
    DEFAULT_K = _env_int("DEFAULT_K", "10")
    DEFAULT_RERANK_K = _env_int("DEFAULT_RERANK_K", "50")
    DEFAULT_MIN_REVIEWS = _env_int("DEFAULT_MIN_REVIEWS", "8")
    DEFAULT_W_DENSE = _env_float("DEFAULT_W_DENSE", "0.55")
    DEFAULT_W_BM25 = _env_float("DEFAULT_W_BM25", "0.20")
    DEFAULT_W_RERANK = _env_float("DEFAULT_W_RERANK", "0.20")
    DEFAULT_W_PRIOR = _env_float("DEFAULT_W_PRIOR", "0.20")
    DEFAULT_W_BEST = _env_float("DEFAULT_W_BEST", "0.10")
    DEFAULT_GATE_PENALTY = _env_float("DEFAULT_GATE_PENALTY", "0.5")
    DEFAULT_PRIOR_C = _env_float("DEFAULT_PRIOR_C", "20.0")

    # cross-request micro-batching (serve/api.py:MicroBatcher): concurrent
    # /search requests within the window share one batched pass
    ENABLE_MICROBATCH = _env_bool("ENABLE_MICROBATCH", "true")
    # the CLI's switch to the C++ epoll front end (serve/native_server.py)
    SERVE_NATIVE = _env_bool("SERVE_NATIVE", "false")
    MICROBATCH_WINDOW_MS = _env_float("MICROBATCH_WINDOW_MS", "2.0")
    MICROBATCH_MAX = _env_int("MICROBATCH_MAX", "128")
    # per-rider wait bound on the coalesced path
    MICROBATCH_TIMEOUT_S = _env_float("MICROBATCH_TIMEOUT_S", "180.0")

    @classmethod
    def validate(cls) -> None:
        """Raise ValueError on a knob outside its range (the JAX config's
        checks of the knobs the port reads)."""
        if cls.DOC_TERMS_CAP < 0:
            raise ValueError("DOC_TERMS_CAP must be >= 0 (0 = auto-derive)")
        if cls.QUERY_TERMS_CAP <= 0:
            raise ValueError("QUERY_TERMS_CAP must be positive")
        if cls.GATE_MODE not in ("device", "host"):
            raise ValueError(f"GATE_MODE must be 'device' or 'host', got {cls.GATE_MODE!r}")
        if cls.EMB_DTYPE not in ("bfloat16", "float32", "float16", "int8"):
            raise ValueError(f"Unsupported EMB_DTYPE: {cls.EMB_DTYPE!r}")
        if cls.DENSE_POOL_MODE not in ("auto", "exact", "striped", "ivf"):
            raise ValueError(
                f"DENSE_POOL_MODE must be 'auto', 'exact', 'striped' or "
                f"'ivf', got {cls.DENSE_POOL_MODE!r}"
            )
        if cls.DENSE_POOL_STRIPES <= 0:
            raise ValueError("DENSE_POOL_STRIPES must be positive")
        if cls.IVF_NPROBE <= 0:
            raise ValueError("IVF_NPROBE must be positive")
        if cls.IVF_BLOCK_ROWS < 0 or cls.IVF_CENTROIDS < 0:
            raise ValueError(
                "IVF_BLOCK_ROWS and IVF_CENTROIDS must be >= 0 (0 = auto)"
            )
        if cls.DENSE_POOL_AUTO_MIN <= 0:
            raise ValueError("DENSE_POOL_AUTO_MIN must be positive")

    @classmethod
    def setup_logging(cls) -> None:
        """Log to LOG_FILE and the console at LOG_LEVEL."""
        Path(cls.LOG_FILE).parent.mkdir(parents=True, exist_ok=True)
        logging.basicConfig(
            level=getattr(logging, cls.LOG_LEVEL, logging.INFO), format=cls.LOG_FORMAT,
            handlers=[logging.FileHandler(cls.LOG_FILE), logging.StreamHandler()],
        )

    @classmethod
    def is_production(cls) -> bool:
        return cls.ENVIRONMENT.lower() == "production"

    @classmethod
    def is_development(cls) -> bool:
        return cls.ENVIRONMENT.lower() == "development"

    @classmethod
    def resolve_pool_mode(cls, mode: str, n_padded: int) -> str:
        """'auto' -> 'striped' from DENSE_POOL_AUTO_MIN padded rows on,
        'exact' below; any other mode unchanged."""
        if mode != "auto":
            return mode
        return "striped" if n_padded >= cls.DENSE_POOL_AUTO_MIN else "exact"


config = Config()
