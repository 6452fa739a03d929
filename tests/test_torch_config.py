"""The port's config against the JAX package's: every knob the port reads
has the same value on the same environment, in this process and, with
overrides set, in a fresh interpreter; and the same `.env` /
`.env.<ENVIRONMENT>` files read alike by an interpreter that imports only
the port and one that imports only the JAX config."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu_torch.config import config as port_config

REPO = Path(__file__).resolve().parents[1]
KNOBS = (
    "EMB_DTYPE", "GATE_MODE", "DENSE_POOL_MODE", "DENSE_POOL_AUTO_MIN", "DENSE_POOL_STRIPES",
    "QUERY_TERMS_CAP", "ENABLE_BM25", "ENABLE_RERANKING", "ENABLE_SNIPPETS", "DEFAULT_K",
    "DEFAULT_RERANK_K", "DEFAULT_MIN_REVIEWS", "DEFAULT_W_DENSE", "DEFAULT_W_BM25",
    "DEFAULT_W_RERANK", "DEFAULT_W_PRIOR", "DEFAULT_W_BEST", "DEFAULT_GATE_PENALTY",
    "DEFAULT_PRIOR_C", "DEFAULT_POOL_SIZE", "MAX_REVIEWS_SCAN",
    # the server's (serve/api.py, serve/native_server.py)
    "APP_HOST", "APP_PORT", "LOG_FILE", "ENVIRONMENT", "ENABLE_METRICS_TAB", "ENABLE_MICROBATCH",
    "SERVE_NATIVE", "MICROBATCH_WINDOW_MS", "MICROBATCH_MAX", "MICROBATCH_TIMEOUT_S",
    # the CLI's and the index builder's
    "EMB_MODEL_DIR", "RERANK_MODEL_DIR", "MESH_SHARDS", "LOG_LEVEL", "LOG_FORMAT",
    # the IVF pool's
    "IVF_NPROBE", "IVF_BLOCK_ROWS", "IVF_CENTROIDS", "IVF_SELFCHECK_QUERIES", "IVF_SELFCHECK_MIN",
    # rrt import's
    "DOC_TERMS_CAP", "PRODUCT_EMB_FILE", "PRODUCT_META_FILE", "REVIEWS_EMB_FILE", "BM25_FILE",
    # the raw-review pipeline's (data/prep.py:filter_reviews_for_snippets)
    "SNIPPET_REVIEWS_CAP",
)
OVERRIDES = {"DENSE_POOL_STRIPES": "77", "GATE_MODE": "host", "ENABLE_BM25": "false",
             "DEFAULT_W_DENSE": "0.3", "DENSE_POOL_AUTO_MIN": "1024", "APP_PORT": "9123",
             "MICROBATCH_WINDOW_MS": "5.5", "ENVIRONMENT": "Production", "SERVE_NATIVE": "true",
             "EMB_MODEL_DIR": "/towers/bi", "MESH_SHARDS": "4",
             "LOG_LEVEL": "debug", "EMB_DTYPE": "int8", "DENSE_POOL_MODE": "ivf",
             "IVF_NPROBE": "128", "IVF_BLOCK_ROWS": "256", "IVF_CENTROIDS": "900",
             "IVF_SELFCHECK_QUERIES": "0", "IVF_SELFCHECK_MIN": "0.9", "DOC_TERMS_CAP": "0",
             "PRODUCT_META_FILE": "meta.parquet", "BM25_FILE": "bm25.pkl",
             "SNIPPET_REVIEWS_CAP": "12"}

_FRESH = """
import json
from review_recommender_tpu.config import config as j
from review_recommender_tpu_torch.config import config as t
knobs = {knobs!r}
modes = [(m, n) for m in ("auto", "exact", "striped") for n in (512, 1024, 70000)]
print(json.dumps({{"port": {{k: getattr(t, k) for k in knobs}},
                   "jax": {{k: getattr(j, k) for k in knobs}},
                   "production": [t.is_production(), j.is_production()],
                   "modes": [[t.resolve_pool_mode(m, n), j.resolve_pool_mode(m, n)]
                             for m, n in modes]}}))
"""


@pytest.mark.parametrize("name", KNOBS)
def test_knob_matches_jax_config(name):
    assert getattr(port_config, name) == getattr(jax_config, name)
    assert type(getattr(port_config, name)) is type(getattr(jax_config, name))


def test_is_production_matches_jax_config(monkeypatch):
    for env in ("development", "production", "PRODUCTION", "staging"):
        for c in (port_config, jax_config):
            monkeypatch.setattr(type(c), "ENVIRONMENT", env)
        assert port_config.is_production() == jax_config.is_production() == \
            (env.lower() == "production")


def test_is_development_matches_jax_config(monkeypatch):
    for env in ("development", "DEVELOPMENT", "production", "staging"):
        for c in (port_config, jax_config):
            monkeypatch.setattr(type(c), "ENVIRONMENT", env)
        assert port_config.is_development() == jax_config.is_development() == \
            (env.lower() == "development")


# .env, then .env.<ENVIRONMENT>: full-line and inline comments, 'export ',
# quotes (a '#' inside quotes kept), a variable the process has (not
# overridden), one only the layered file sets, and a bare '#' in a value
ENV_FILES = {
    ".env": "# deployment knobs\nEMB_DTYPE=int8\nDENSE_POOL_MODE=ivf  # the IVF pool\n"
            "export IVF_NPROBE=128\nENVIRONMENT=production\nIVF_BLOCK_ROWS=512\n"
            "LOG_FORMAT='%(message)s # kept'\nGATE_MODE=host\n\n",
    ".env.production": "GATE_MODE=device\nDENSE_POOL_STRIPES=\"4096\"\nAPP_PORT=9100 #port\n"
                       "EMB_MODEL_DIR=/towers/a#b\n",
}
ENV_KNOBS = ("EMB_DTYPE", "DENSE_POOL_MODE", "IVF_NPROBE", "ENVIRONMENT", "IVF_BLOCK_ROWS",
             "LOG_FORMAT", "GATE_MODE", "DENSE_POOL_STRIPES", "APP_PORT", "EMB_MODEL_DIR")
_ONE_CONFIG = """
import json, sys
from {module} import config as c
print(json.dumps({{"knobs": {{k: getattr(c, k) for k in {knobs!r}}},
                   "development": c.is_development(),
                   "jax": [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                           or m.startswith("review_recommender_tpu.")]}}))
"""


def test_env_files_read_alike_by_a_port_only_interpreter(tmp_path):
    """In a directory holding .env and .env.production, a fresh interpreter
    that imports only the port's config reads what one that imports only
    the JAX config reads; a variable the process has wins over the files."""
    for name, text in ENV_FILES.items():
        (tmp_path / name).write_text(text)
    env = {k: v for k, v in os.environ.items() if k not in KNOBS + ENV_KNOBS}
    env.update(PYTHONPATH=str(REPO), IVF_BLOCK_ROWS="256")
    res = {}
    for module in ("review_recommender_tpu_torch.config", "review_recommender_tpu.config"):
        proc = subprocess.run([sys.executable, "-c", _ONE_CONFIG.format(module=module,
                                                                         knobs=ENV_KNOBS)],
                              cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        res[module.split(".")[0]] = json.loads(proc.stdout.strip().splitlines()[-1])
    port, theirs = res["review_recommender_tpu_torch"], res["review_recommender_tpu"]
    assert port["jax"] == []  # the port's interpreter imported nothing of JAX
    assert port["knobs"] == theirs["knobs"] and port["development"] is theirs["development"] is False
    assert port["knobs"] == {
        "EMB_DTYPE": "int8", "DENSE_POOL_MODE": "ivf", "IVF_NPROBE": 128,
        "ENVIRONMENT": "production", "IVF_BLOCK_ROWS": 256, "LOG_FORMAT": "%(message)s # kept",
        "GATE_MODE": "host", "DENSE_POOL_STRIPES": 4096, "APP_PORT": 9100,
        "EMB_MODEL_DIR": "/towers/a#b"}


@pytest.mark.parametrize("mode", ["auto", "exact", "striped"])
def test_resolve_pool_mode_matches_jax_config(mode):
    for n in (16, 65535, 65536, 200_000):
        assert port_config.resolve_pool_mode(mode, n) == jax_config.resolve_pool_mode(mode, n)


def test_overrides_read_alike_in_a_fresh_interpreter():
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(OVERRIDES, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _FRESH.format(knobs=KNOBS)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["port"] == res["jax"]
    assert res["port"]["DENSE_POOL_STRIPES"] == 77 and res["port"]["GATE_MODE"] == "host"
    assert res["port"]["ENABLE_BM25"] is False and res["port"]["DEFAULT_W_DENSE"] == 0.3
    assert res["port"]["APP_PORT"] == 9123 and res["port"]["MICROBATCH_WINDOW_MS"] == 5.5
    assert res["port"]["SERVE_NATIVE"] is True and res["production"] == [True, True]
    assert res["port"]["EMB_MODEL_DIR"] == "/towers/bi"
    assert res["port"]["MESH_SHARDS"] == 4 and res["port"]["LOG_LEVEL"] == "DEBUG"
    assert res["port"]["EMB_DTYPE"] == "int8" and res["port"]["DENSE_POOL_MODE"] == "ivf"
    assert res["port"]["IVF_NPROBE"] == 128 and res["port"]["IVF_SELFCHECK_MIN"] == 0.9
    assert res["port"]["DOC_TERMS_CAP"] == 0 and res["port"]["BM25_FILE"] == "bm25.pkl"
    assert res["port"]["PRODUCT_META_FILE"] == "meta.parquet"
    assert res["port"]["SNIPPET_REVIEWS_CAP"] == 12
    assert all(p == j for p, j in res["modes"])
    assert ["striped", "striped"] in res["modes"] and ["exact", "exact"] in res["modes"]


@pytest.mark.parametrize("name,value,ok", [
    ("QUERY_TERMS_CAP", 0, False), ("GATE_MODE", "hybrid", False),
    ("DENSE_POOL_STRIPES", 0, False), ("DENSE_POOL_AUTO_MIN", -5, False),
    ("QUERY_TERMS_CAP", 64, True), ("GATE_MODE", "host", True), ("DENSE_POOL_STRIPES", 128, True),
    ("EMB_DTYPE", "int8", True), ("EMB_DTYPE", "int4", False), ("DENSE_POOL_MODE", "ivf", True),
    ("DENSE_POOL_MODE", "hnsw", False), ("IVF_NPROBE", 0, False), ("IVF_NPROBE", 1, True),
    ("IVF_BLOCK_ROWS", -1, False), ("IVF_CENTROIDS", -3, False), ("IVF_CENTROIDS", 0, True),
    ("DOC_TERMS_CAP", -1, False), ("DOC_TERMS_CAP", 0, True), ("DOC_TERMS_CAP", 64, True)])
def test_validate_refuses_what_the_jax_config_refuses(monkeypatch, tmp_path, name, value, ok):
    """The port's validate raises for a knob exactly where the JAX
    config's does (its production-only and log-directory side left out)."""
    monkeypatch.setattr(type(jax_config), "LOG_FILE", str(tmp_path / "logs" / "app.log"))
    monkeypatch.setattr(type(jax_config), "ENVIRONMENT", "development")
    outcomes = []
    for c in (port_config, jax_config):
        monkeypatch.setattr(type(c), name, value)
        try:
            c.validate()
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == ok


def test_setup_logging_writes_to_log_file(monkeypatch, tmp_path):
    import logging

    log = tmp_path / "logs" / "app.log"
    monkeypatch.setattr(type(port_config), "LOG_FILE", str(log))
    root = logging.getLogger()
    saved = root.handlers[:]
    root.handlers = []
    try:
        port_config.setup_logging()
        logging.getLogger("rrt.test").warning("hello from the port")
        for h in root.handlers:
            h.flush()
        assert "hello from the port" in log.read_text()
    finally:
        for h in root.handlers:
            h.close()
        root.handlers = saved
