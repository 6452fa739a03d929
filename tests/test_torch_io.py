"""The port's bundle IO (review_recommender_tpu_torch/index/io.py) and audit
(serve/audit.py) against the JAX package's.

The port writes the JAX manifest, array files and vocabulary, and its host
columns as numpy files in place of parquet. A save then load through the
port is bit-equal to the bundle saved. A bundle the JAX package saved
(parquet meta; this machine has pyarrow) reads through the port equal to
the JAX load_bundle, and `convert` rewrites it into the port's layout with
equal contents. A tampered file fails verify_checksums, a newer schema
raises, a remote path raises without fsspec (and is never written to),
and a parquet bundle without pyarrow raises naming it. audit_index_dir gives the JAX check names and verdicts on a
good bundle, a bundle missing a file and a tampered one, in both layouts.
"""
import json
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from review_recommender_tpu.index import io as jax_io
from review_recommender_tpu.index.build import build_bundle_from_products as jax_bundle
from review_recommender_tpu.serve.audit import audit_index_dir as jax_audit
from review_recommender_tpu_torch.index import io as port_io
from review_recommender_tpu_torch.index.build import (
    attach_eager_bm25,
    attach_rerank_tokens,
    build_bundle_from_products,
)
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.serve.audit import audit_index_dir
from tests.torch_bundle_cases import assert_bundles_equal, corpus, reviews

REPO = Path(__file__).resolve().parents[1]


def _bundles(with_reviews=True, last_ts=True):
    products, _q, emb = corpus()
    rrows, remb = reviews(products) if with_reviews else (None, None)
    kw = dict(reviews=rrows, review_embeddings=remb, doc_terms_cap=64, pad_multiple=16)
    if last_ts:
        for i, p in enumerate(products):
            p["last_ts"] = None if i % 4 == 0 else f"2024-02-{1 + i % 28:02d}"
    ts = [p.get("last_ts") for p in products] if last_ts else None
    tb = build_bundle_from_products(products, emb, last_ts=ts, **kw)
    jb = jax_bundle(products, emb, last_ts=ts, **kw)
    tb.meta = jb.meta = {"source": "quality corpus", "seed": 0}
    return tb, jb


@pytest.mark.parametrize("extras", ["plain", "eager_and_tokens", "no_reviews"])
def test_port_round_trip_is_bit_equal(tmp_path, extras):
    tb, _jb = _bundles(with_reviews=extras != "no_reviews", last_ts=extras != "no_reviews")
    if extras == "eager_and_tokens":
        attach_eager_bm25(tb.products)
        attach_rerank_tokens(tb.products, HashTokenizer(500), max_tokens=24)
    port_io.save_bundle(tb, tmp_path / "b")
    files = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert not any(f.endswith(".parquet") for f in files)
    loaded = port_io.load_bundle(tmp_path / "b", verify_checksums=True)
    assert_bundles_equal(loaded, tb)
    manifest = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert sorted(manifest["checksums"]) == sorted(f for f in files if f != "manifest.json")


def test_jax_bundle_reads_equal_and_converts(tmp_path):
    _tb, jb = _bundles()
    jax_io.save_bundle(jb, tmp_path / "jax")
    want = jax_io.load_bundle(str(tmp_path / "jax"))
    got = port_io.load_bundle(tmp_path / "jax", verify_checksums=True)
    assert_bundles_equal(got, want)
    env_path = str(REPO)
    proc = subprocess.run([sys.executable, "-m", "review_recommender_tpu_torch.index.io",
                           "convert", str(tmp_path / "jax"), str(tmp_path / "port")],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert not list((tmp_path / "port").glob("*.parquet"))
    assert_bundles_equal(port_io.load_bundle(tmp_path / "port", verify_checksums=True), want)
    # the manifest's shared keys and the array files' keys are the JAX package's
    jm, pm = (json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("jax", "port"))
    assert {k: v for k, v in jm.items() if k != "checksums"} == \
        {k: v for k, v in pm.items() if k != "checksums"}


def test_port_bundle_equals_the_jax_bundle_saved_alike(tmp_path):
    tb, jb = _bundles()
    port_io.save_bundle(tb, tmp_path / "port")
    jax_io.save_bundle(jb, tmp_path / "jax")
    assert_bundles_equal(port_io.load_bundle(tmp_path / "port"),
                         jax_io.load_bundle(str(tmp_path / "jax")))
    for f in ("vocab.txt",):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _tamper(path: Path) -> None:
    """Upper-case the first vocabulary term: same length, still loads."""
    lines = path.read_text().split("\n")
    lines[0] = lines[0].upper()
    path.write_text("\n".join(lines))


def test_tampered_file_and_newer_schema_are_refused(tmp_path):
    tb, _jb = _bundles()
    port_io.save_bundle(tb, tmp_path / "b")
    _tamper(tmp_path / "b" / "vocab.txt")
    port_io.load_bundle(tmp_path / "b")  # loads without the check
    with pytest.raises(ValueError, match="checksum mismatch for vocab.txt"):
        port_io.load_bundle(tmp_path / "b", verify_checksums=True)
    manifest = json.loads((tmp_path / "b" / "manifest.json").read_text())
    manifest["schema_version"] += 1
    (tmp_path / "b" / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="newer than supported"):
        port_io.load_bundle(tmp_path / "b")


def test_remote_path_and_missing_reader_are_refused(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="local directories only"):
        port_io.save_bundle(None, "hf://datasets/org/name/index")
    monkeypatch.setitem(sys.modules, "fsspec", None)  # the card's machine: no fsspec
    with pytest.raises(RuntimeError, match="needs fsspec"):
        port_io.load_bundle("hf://datasets/org/name/index")
    _tb, jb = _bundles()
    jax_io.save_bundle(jb, tmp_path / "jax")
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(RuntimeError, match="pyarrow.*convert"):
        port_io.load_bundle(tmp_path / "jax")
    (tmp_path / "jax" / "product_meta.parquet").unlink()
    with pytest.raises(FileNotFoundError, match="product_meta.npz"):
        port_io.load_bundle(tmp_path / "jax")


def _verdicts(report):
    return [(c["check"], c["passed"]) for c in report["checks"]], report["ok"]


@pytest.mark.parametrize("damage", ["none", "missing_vocab", "missing_meta", "tampered"])
def test_audit_matches_jax(tmp_path, damage):
    tb, jb = _bundles()
    port_io.save_bundle(tb, tmp_path / "port")
    jax_io.save_bundle(jb, tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "jax_read_by_port")
    for d, meta in (("port", "product_meta.npz"), ("jax", "product_meta.parquet"),
                    ("jax_read_by_port", "product_meta.parquet")):
        if damage == "missing_vocab":
            (tmp_path / d / "vocab.txt").unlink()
        elif damage == "missing_meta":
            (tmp_path / d / meta).unlink()
        elif damage == "tampered":
            _tamper(tmp_path / d / "vocab.txt")
    want = _verdicts(jax_audit(tmp_path / "jax"))
    assert _verdicts(audit_index_dir(tmp_path / "port", device="cpu")) == want
    assert _verdicts(audit_index_dir(tmp_path / "jax_read_by_port", device="cpu")) == want
    assert want[1] is (damage == "none")


def test_bundle_archives_load_as_savez_compressed_ones(tmp_path):
    """save_bundle's .npz writer (deflate level 1) gives the arrays, dtypes
    and entry names np.savez_compressed gives, every entry deflated."""
    rng = np.random.default_rng(0)
    arrays = {"emb": rng.standard_normal((300, 16)).astype(np.float32),
              "doc_terms": rng.integers(0, 500, (300, 8)).astype(np.int32),
              "valid": rng.random(300) < 0.9, "empty": np.zeros((0, 3), np.float64)}
    port_io._savez(tmp_path / "fast.npz", **arrays)
    np.savez_compressed(tmp_path / "ref.npz", **arrays)
    with np.load(tmp_path / "fast.npz") as fast, np.load(tmp_path / "ref.npz") as ref:
        assert fast.files == ref.files == list(arrays)
        for k in arrays:
            assert fast[k].dtype == ref[k].dtype and np.array_equal(fast[k], ref[k])
    with zipfile.ZipFile(tmp_path / "fast.npz") as zf:
        assert {i.compress_type for i in zf.infolist()} == {zipfile.ZIP_DEFLATED}
