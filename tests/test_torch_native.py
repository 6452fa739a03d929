"""The port's native host library (review_recommender_tpu_torch/native):
its sources against the JAX package's, its query featurizer against both
Python paths, and its build.

The three .cc files are byte-for-byte copies of review_recommender_tpu/
native/. featurize_packed and featurize_packed_batch on the native route
must be byte-equal to the port's Python route and to the JAX
QueryFeaturizer forced onto its Python path, on the same bundle (the JAX
package's build_bundle_from_products): ASCII and non-ASCII queries, an
empty query, one past QUERY_TERMS_CAP, repeated tokens, tokens matching
more terms than gate_terms_cap, ENABLE_BM25 off. The C++ expand_token probe
returns the Python scan's ids in its order. Two processes building at once
load one library; a build that cannot run raises.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.featurize import QueryFeaturizer as JaxFeaturizer
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu_torch import native
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.engine.featurize import QueryFeaturizer, packed_len
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex
from tests.test_engine_parity import WORDS

REPO = Path(__file__).resolve().parents[1]
# "wood" is a substring of 100+ vocabulary terms: more than gate_terms_cap
WOOD = [f"wood{i}" for i in range(90)] + [f"{i}wood" for i in range(12)] + [
    "wooden", "woodland", "driftwood", "woods"]
QUERIES = [
    "yellow cat socks",
    "wireless bluetooth headphones noise cancelling",
    "Wooden WOOD wood wood chair",  # repeated tokens, upper case
    "wood",
    "",
    " ".join(f"wood{i}" for i in range(40)) + " socks",  # past QUERY_TERMS_CAP
    "the and of",  # stop words only
    "noise-canceling red headset with kittens",
    "cat's wood's 42",
    "café crème socks",  # non-ASCII
    "\u212aelvin wood",  # KELVIN SIGN lowers to ASCII 'k'
    "zzzz qqqq",
]
GATE_CAPS = (64, 4)


@pytest.fixture(scope="module")
def products():
    rng = np.random.default_rng(7)
    rows = []
    for i in range(120):
        words = list(rng.choice(WORDS, size=int(rng.integers(5, 20))))
        words += list(rng.choice(WOOD, size=int(rng.integers(1, 8))))
        rows.append({"sku": f"SKU{i:04d}", "agg_text": " ".join(words),
                     "n_reviews": float(rng.integers(0, 300)),
                     "avg_stars": float(rng.uniform(1, 5))})
    emb = rng.standard_normal((len(rows), 32)).astype(np.float32)
    jp = build_bundle_from_products(rows, emb, pad_multiple=16, doc_terms_cap=64).products
    return ProductIndex(**{f: getattr(jp, f) for f in ProductIndex.__dataclass_fields__})


def _jax_python(index, gate_cap):
    jf = JaxFeaturizer(index, query_terms_cap=port_config.QUERY_TERMS_CAP,
                       gate_terms_cap=gate_cap)
    jf._native = None  # the JAX package's Python path
    jf._vocab_blob = None
    return jf


@pytest.fixture(scope="module", params=GATE_CAPS, ids=lambda c: f"gate{c}")
def featurizers(request, products):
    cap = request.param
    q = port_config.QUERY_TERMS_CAP
    return (QueryFeaturizer(products, q, cap), QueryFeaturizer(products, q, cap, native=False),
            _jax_python(products, cap))


@pytest.mark.parametrize("name", native.SOURCES)
def test_sources_are_copies_of_the_jax_package(name):
    mine = (REPO / "review_recommender_tpu_torch" / "native" / name).read_bytes()
    assert mine == (REPO / "review_recommender_tpu" / "native" / name).read_bytes()


def test_vocabulary_has_terms_past_the_gate_cap(products):
    assert sum("wood" in t for t in products.vocab) > max(GATE_CAPS)


@pytest.mark.parametrize("query", QUERIES)
def test_featurize_packed_is_byte_equal(featurizers, query):
    nat, py, jx = featurizers
    assert (nat.route, py.route) == ("native", "python")
    got = nat.featurize_packed(query)
    assert got.shape == (packed_len(nat.query_terms_cap, nat.gate_terms_cap),)
    assert got.tobytes() == py.featurize_packed(query).tobytes() == \
        jx.featurize_packed(query).tobytes(), query


@pytest.mark.parametrize("with_non_ascii", [False, True])
def test_featurize_packed_batch_is_byte_equal(featurizers, with_non_ascii):
    nat, py, jx = featurizers
    queries = [q for q in QUERIES if with_non_ascii or q.isascii()]
    got = nat.featurize_packed_batch(queries)
    assert got.shape == (len(queries), packed_len(nat.query_terms_cap, nat.gate_terms_cap))
    assert got.tobytes() == py.featurize_packed_batch(queries).tobytes() == \
        np.asarray(jx.featurize_packed_batch(queries)).tobytes()


def test_bm25_off_is_byte_equal(products, monkeypatch):
    """ENABLE_BM25=false zero-fills the term lanes; the native route hands
    every query to the Python code, which reads the flag per call."""
    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "ENABLE_BM25", False)
    q = port_config.QUERY_TERMS_CAP
    nat, py, jx = QueryFeaturizer(products, q), QueryFeaturizer(products, q, native=False), \
        _jax_python(products, 64)
    ascii_q = [x for x in QUERIES if x.isascii()]
    got = nat.featurize_packed_batch(ascii_q)
    assert not got[:, :2 * q].any()
    assert got.tobytes() == py.featurize_packed_batch(ascii_q).tobytes() == \
        np.asarray(jx.featurize_packed_batch(ascii_q)).tobytes()
    for query in QUERIES:
        assert nat.featurize_packed(query).tobytes() == jx.featurize_packed(query).tobytes()


@pytest.mark.parametrize("token", ["wood", "wood1", "1wood", "woo", "cat", "s", "zzzz", "kelvin"])
def test_expand_token_ids_equal_in_order(featurizers, token):
    nat, py, jx = featurizers
    got = nat._expand_token(token)
    assert got.dtype == np.int32 and len(got) <= nat.gate_terms_cap
    np.testing.assert_array_equal(got, py._expand_token(token))
    np.testing.assert_array_equal(got, jx._expand_token(token))


def test_engine_takes_the_route_it_is_given(products):
    bundle = IndexBundle(products=products)
    assert SearchEngine(bundle, device="cpu").featurizer.route == "native"
    assert SearchEngine(bundle, device="cpu", featurizer="python").featurizer.route == "python"
    with pytest.raises(ValueError, match="featurizer"):
        SearchEngine(bundle, device="cpu", featurizer="cpp")


def test_native_featurizer_under_concurrent_threads(products):
    """16 threads (more than the cores) featurize queries with tokens no
    call has seen, so the C++ expansion cache grows under them; a short
    switch interval interleaves them. Every row equals the Python route's."""
    q = port_config.QUERY_TERMS_CAP
    nat, py = QueryFeaturizer(products, q), QueryFeaturizer(products, q, native=False)
    queries = [f"wood{i} {i}wood woods cat" for i in range(90)] + ["wooden driftwood"] * 10
    want = py.featurize_packed_batch(queries)
    got, errors = [None] * len(queries), []

    def work(lo):
        try:
            for i in range(lo, len(queries), 16):
                got[i] = nat._native.featurize_packed(queries[i])
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(lo,)) for lo in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert np.stack(got).tobytes() == want.tobytes()


_BUILD = """
import json, sys
from pathlib import Path
from review_recommender_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native._lib()
path = Path(native.build_info["path"])
print(json.dumps({"path": str(path), "ino": path.stat().st_ino,
                  "built": not native.build_info["cached"],
                  "server": native.native_server_available()}))
"""


def test_two_processes_building_at_once_load_one_library(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    res = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    assert res[0]["path"] == res[1]["path"] and res[0]["ino"] == res[1]["ino"]
    assert sorted(r["built"] for r in res) == [False, True]  # one built, one waited
    assert all(r["server"] for r in res)
    assert [p.name for p in tmp_path.glob("*.so")] == [Path(res[0]["path"]).name]


@pytest.mark.parametrize("fault", ["no_compiler", "bad_flag"])
def test_a_build_that_cannot_run_raises(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    if fault == "no_compiler":
        monkeypatch.setattr(native, "CXX", "no-such-c++-compiler")
        match = "not found"
    else:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-flag"])
        match = "no-such-flag"
    with pytest.raises(RuntimeError, match=match):
        native.build()
    assert not list(tmp_path.glob("*.so"))
