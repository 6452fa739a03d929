"""The port's config against the JAX package's: every knob the port reads
has the same value on the same environment, in this process and, with
overrides set, in a fresh interpreter."""
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
)
OVERRIDES = {"DENSE_POOL_STRIPES": "77", "GATE_MODE": "host", "ENABLE_BM25": "false",
             "DEFAULT_W_DENSE": "0.3", "DENSE_POOL_AUTO_MIN": "1024", "APP_PORT": "9123",
             "MICROBATCH_WINDOW_MS": "5.5", "ENVIRONMENT": "Production", "SERVE_NATIVE": "true"}

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
    assert all(p == j for p, j in res["modes"])
    assert ["striped", "striped"] in res["modes"] and ["exact", "exact"] in res["modes"]
