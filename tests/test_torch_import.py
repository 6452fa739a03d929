"""The port's reference import (review_recommender_tpu_torch/data/pipeline.py
and the CLI's `import`) against the JAX package's.

The reference data directory is tests/test_reference_ingest.py's
(`ref_data_dir`: product_emb.npy, product_emb_meta.parquet,
product_bm25.pkl, reviews_with_embeddings.parquet). Held bit-equal to
JAX `import_reference_artifacts` (every array, dtype and shape; host
columns equal): from parquet, from the numpy form that `convert` writes,
from `memory://` fsspec URLs, without the optional artifacts, at
doc_terms_cap 0 (auto) and at the config default, and with null meta
values (a null last_ts, agg_text or sku becomes "nan" in both, the JAX
import's reading under pandas 3). The restricted unpickler refuses a
foreign global in both packages. `rrt import` of both CLIs writes
bundles that load equal (with --no-reviews too), and `rrt search` on
each, with the same native towers (f32, written by the JAX package),
prints the same rows and snippets. The port's load_bundle reads a
bundle at a memory:// URL equal to the local one.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from review_recommender_tpu.data.pipeline import import_reference_artifacts as jax_import
from review_recommender_tpu.index.io import load_bundle as jax_load
from review_recommender_tpu.serve import cli as jax_cli
from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.data import pipeline as P
from review_recommender_tpu_torch.data.pipeline import import_reference_artifacts as port_import
from review_recommender_tpu_torch.index.io import load_bundle
from review_recommender_tpu_torch.serve import cli as port_cli
from tests.test_reference_ingest import WORDS, ref_data_dir  # noqa: F401 (the fixture)
from tests.test_torch_cli import f32_loaders  # noqa: F401 (the fixture)
from tests.torch_bundle_cases import assert_bundles_equal

FILES = {"emb": "product_emb.npy", "meta": "product_emb_meta.parquet",
         "bm25": "product_bm25.pkl", "reviews": "reviews_with_embeddings.parquet"}


def _paths(d, forms=None, **drop):
    forms = forms or {}
    return {k: (None if drop.get(k) else f"{d}/{forms.get(k, v)}") for k, v in FILES.items()}


def _import_both(paths, **kw):
    args = (paths["emb"], paths["meta"])
    kws = dict(bm25_pkl=paths["bm25"], reviews_parquet=paths["reviews"], **kw)
    return port_import(*args, **kws), jax_import(*args, **kws)


@pytest.mark.parametrize("case", ["all", "no_bm25", "no_reviews", "required_only",
                                  "cap_auto", "cap_default"])
def test_import_is_bit_equal_to_jax(ref_data_dir, case):  # noqa: F811
    d, raw = ref_data_dir
    drop = {"no_bm25": {"bm25": 1}, "no_reviews": {"reviews": 1},
            "required_only": {"bm25": 1, "reviews": 1}}.get(case, {})
    cap = {"cap_auto": 0, "cap_default": None}.get(case, 64)
    tb, jb = _import_both(_paths(d, **drop), doc_terms_cap=cap)
    assert_bundles_equal(tb, jb)
    p = tb.products
    assert p.n_docs == len(raw["skus"]) and p.skus == raw["skus"]
    assert tb.meta == {"built_from": "reference_artifacts"}
    assert (tb.reviews is None) == bool(drop.get("reviews"))
    if case == "cap_default":
        assert p.terms_cap == config.DOC_TERMS_CAP
    if case == "cap_auto":
        assert p.terms_cap < 64


def test_bm25_pickle_in_another_sku_order(ref_data_dir, tmp_path):  # noqa: F811
    d, raw = ref_data_dir
    for f in FILES.values():
        shutil.copy(d / f, tmp_path / f)
    blob = dict(raw["blob"])
    order = np.random.default_rng(0).permutation(len(blob["skus"]))[:-3]  # 3 skus absent
    blob["skus"] = np.asarray([blob["skus"][i] for i in order])
    blob["corpus"] = [blob["corpus"][i] for i in order]
    with open(tmp_path / FILES["bm25"], "wb") as f:
        pickle.dump(blob, f)
    tb, jb = _import_both(_paths(tmp_path), doc_terms_cap=64)
    assert_bundles_equal(tb, jb)


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_restricted_unpickler_refuses_a_foreign_global(ref_data_dir, tmp_path):  # noqa: F811
    d, _raw = ref_data_dir
    for f in FILES.values():
        shutil.copy(d / f, tmp_path / f)
    with open(tmp_path / FILES["bm25"], "wb") as f:
        pickle.dump({"skus": [], "corpus": [], "tokenizer": _Evil()}, f)
    for fn in (port_import, jax_import):
        with pytest.raises(pickle.UnpicklingError, match="refusing to unpickle global"):
            fn(**dict(zip(("emb_npy", "meta_parquet", "bm25_pkl"),
                          (str(tmp_path / FILES[k]) for k in ("emb", "meta", "bm25")))))


def test_convert_round_trips(ref_data_dir, tmp_path):  # noqa: F811
    d, _raw = ref_data_dir
    out = tmp_path / "converted"
    assert P.main(["convert", str(d), str(out)]) == 0
    assert sorted(f.name for f in out.iterdir()) == sorted(
        [FILES["emb"], FILES["bm25"], "product_emb_meta.npz", "reviews_with_embeddings.npz"])
    for name, cols in (("meta", P.META_COLUMNS), ("reviews", P.REVIEW_COLUMNS)):
        a = P.read_table(d / FILES[name], cols)
        b = P.read_table(out / P.numpy_form(FILES[name]), cols)
        assert a.keys() == b.keys()
        for c in a:
            if isinstance(a[c], np.ndarray):
                assert a[c].dtype == b[c].dtype and np.array_equal(a[c], b[c], equal_nan=True)
            else:
                assert a[c] == b[c], c
    forms = {k: P.numpy_form(v) for k, v in FILES.items()}
    tb, jb = port_import(*[_paths(out, forms)[k] for k in ("emb", "meta")],
                         bm25_pkl=_paths(out)["bm25"], reviews_parquet=_paths(out, forms)["reviews"],
                         doc_terms_cap=64), _import_both(_paths(d), doc_terms_cap=64)[1]
    assert_bundles_equal(tb, jb)


@pytest.fixture
def null_meta_dir(ref_data_dir, tmp_path):  # noqa: F811
    """The reference dir with nulls in last_ts, agg_text and sku, and an
    integer n_reviews column with a null."""
    import pandas as pd

    d, _raw = ref_data_dir
    for f in FILES.values():
        shutil.copy(d / f, tmp_path / f)
    meta = pd.read_parquet(d / FILES["meta"])
    meta["last_ts"] = [None if i % 3 == 0 else t for i, t in enumerate(meta["last_ts"])]
    meta.loc[4, "agg_text"] = None
    meta.loc[7, "sku"] = None
    meta["n_reviews"] = pd.array([None if i == 2 else int(v) for i, v in
                                  enumerate(meta["n_reviews"])], dtype="Int64")
    meta.to_parquet(tmp_path / FILES["meta"])
    return tmp_path


def test_null_meta_values_import_as_the_jax_import_stores_them(null_meta_dir, tmp_path):
    tb, jb = _import_both(_paths(null_meta_dir), doc_terms_cap=64)
    assert_bundles_equal(tb, jb)
    p = tb.products
    assert p.last_ts[0] == p.last_ts[3] == "nan" and p.last_ts[1] == "2023-05-01T00:00:00Z"
    assert p.agg_texts[4] == "nan" and p.skus[7] == "nan" and p.n_reviews[2] == 0.0
    P.convert(null_meta_dir, tmp_path / "npz")
    forms = {"meta": P.numpy_form(FILES["meta"])}
    again = port_import(*[_paths(tmp_path / "npz", forms)[k] for k in ("emb", "meta")],
                        bm25_pkl=_paths(tmp_path / "npz")["bm25"], doc_terms_cap=64)
    assert_bundles_equal(again, jax_import(*[_paths(null_meta_dir)[k] for k in ("emb", "meta")],
                                           bm25_pkl=_paths(null_meta_dir)["bm25"],
                                           doc_terms_cap=64))


def test_memory_urls(ref_data_dir, tmp_path):  # noqa: F811
    fsspec = pytest.importorskip("fsspec")
    d, _raw = ref_data_dir
    fs = fsspec.filesystem("memory")
    for f in FILES.values():
        fs.pipe(f"/ref/{f}", (d / f).read_bytes())
    tb, jb = _import_both(_paths("memory://ref"), doc_terms_cap=64)
    assert_bundles_equal(tb, jb)
    P.convert("memory://ref", tmp_path / "conv")  # a remote source, local numpy forms
    assert (tmp_path / "conv" / "product_emb_meta.npz").exists()
    assert port_cli.main(["import", "--data-dir", "memory://ref", "--out",
                          str(tmp_path / "b"), "--doc-terms-cap", "64"]) == 0
    for f in (tmp_path / "b").iterdir():
        fs.pipe(f"/bundle/{f.name}", f.read_bytes())
    assert_bundles_equal(load_bundle("memory://bundle", verify_checksums=True),
                         load_bundle(tmp_path / "b"))
    fs.rm("/ref", recursive=True)
    fs.rm("/bundle", recursive=True)


def _native_towers(root):
    """Bi- and cross-encoder native towers of hidden size 32 written by the
    JAX package over a WordPiece vocab of the fixture's words."""
    import jax.numpy as jnp

    from review_recommender_tpu.models.bert import BertConfig, init_biencoder, init_crossencoder
    from review_recommender_tpu.models.load import save_native_tower
    from review_recommender_tpu.models.tokenizer import WordPieceTokenizer

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(WORDS))
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    tok = WordPieceTokenizer.from_vocab_file(root / "vocab.txt")
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_layers=1, num_heads=4,
                     intermediate_size=64, max_position=64)
    for name, init, kind in (("bi", init_biencoder, "biencoder"),
                             ("ce", init_crossencoder, "crossencoder")):
        save_native_tower(root / name, kind, cfg, init(cfg, seed=5, dtype=jnp.float32)[1], tok)
    return root / "bi", root / "ce"


@pytest.mark.parametrize("no_reviews", [False, True])
def test_rrt_import_then_search_equals_the_jax_cli(ref_data_dir, tmp_path, monkeypatch,  # noqa: F811
                                                   capsys, f32_loaders, no_reviews):  # noqa: F811
    d, _raw = ref_data_dir
    extra = ["--no-reviews"] if no_reviews else []
    lines = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        assert cli.main(["import", "--data-dir", str(d), "--out", str(tmp_path / name),
                         "--doc-terms-cap", "0", *extra]) == 0
        lines[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines["port"] == {**lines["jax"], "out": str(tmp_path / "port")}
    assert lines["port"]["n_reviews"] == (0 if no_reviews else 120)
    assert_bundles_equal(load_bundle(tmp_path / "port", verify_checksums=True),
                         jax_load(tmp_path / "jax"))

    bi, ce = _native_towers(tmp_path)
    for c in (config, jax_cli.config):
        monkeypatch.setattr(type(c), "EMB_MODEL_DIR", str(bi))
        monkeypatch.setattr(type(c), "RERANK_MODEL_DIR", str(ce))
    for query in ("yellow kitten sock", "wireless headphone noise battery"):
        argv = [query, "--rerank-k", "6", "--k", "8", "--min-reviews", "1"]
        argv += [] if no_reviews else ["--snippets"]
        assert port_cli.main(["search", *argv, "--index-dir", str(tmp_path / "port"),
                              "--device", "cpu", "--json-out", str(tmp_path / "p.json")]) == 0
        assert jax_cli.main(["search", *argv, "--index-dir", str(tmp_path / "jax"),
                             "--json-out", str(tmp_path / "j.json")]) == 0
        got, want = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "j.json"))
        assert [r["sku"] for r in got["results"]] == [r["sku"] for r in want["results"]]
        for col in ("_dense", "_bm25", "_rerank", "_prior", "_final"):
            assert [r[col] for r in got["results"]] == pytest.approx(
                [r[col] for r in want["results"]], rel=1e-5, abs=1e-5), col
        assert got["snippets"].keys() == want["snippets"].keys()
        assert bool(got["snippets"]) == (not no_reviews)
        for sku, s in got["snippets"].items():
            assert s["text"] == want["snippets"][sku]["text"]
            assert s["score"] == pytest.approx(want["snippets"][sku]["score"], rel=1e-5,
                                               abs=1e-5)
    capsys.readouterr()


def test_rrt_import_prefers_the_numpy_form_and_names_a_missing_artifact(
        ref_data_dir, tmp_path, capsys):  # noqa: F811
    d, _raw = ref_data_dir
    P.convert(d, tmp_path / "conv")
    shutil.copy(d / FILES["meta"], tmp_path / "conv" / FILES["meta"])  # both forms present
    assert port_cli.main(["import", "--data-dir", str(tmp_path / "conv"), "--out",
                          str(tmp_path / "b"), "--doc-terms-cap", "64"]) == 0
    capsys.readouterr()
    assert_bundles_equal(load_bundle(tmp_path / "b"),
                         _import_both(_paths(d), doc_terms_cap=64)[1])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="missing required artifact.*product_emb.npy"):
        port_cli.main(["import", "--data-dir", str(tmp_path / "empty"), "--out",
                       str(tmp_path / "x")])


def test_parquet_without_pyarrow_names_the_convert_step(ref_data_dir, monkeypatch):  # noqa: F811
    import sys

    d, _raw = ref_data_dir
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(RuntimeError, match="pyarrow.*data.pipeline convert"):
        port_import(str(d / FILES["emb"]), str(d / FILES["meta"]))
