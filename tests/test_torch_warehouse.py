"""The port's warehouse and archiver (review_recommender_tpu_torch/data/
warehouse.py, tools/archiver.py) against the JAX package's `Warehouse`
(tests/test_tools_warehouse.py's store) and `tools/archiver.py`.

Warehouse, on merged tables of tests/torch_raw_cases.py (each package's
own normalize_merge): the same operations in the same order give the same
row counts, stored columns, star distribution (null stars a group of their
own, last), source breakdown and sku back-join (ids unknown to the store,
repeated ids, a table that has a sku column already). A second load of an
overlapping batch keeps the first writer's rows in both. The archiver:
the same actions, moves and printed lines on the same directory trees.
"""
import numpy as np
import pandas as pd
import pytest

from review_recommender_tpu.data import etl as J
from review_recommender_tpu.data import warehouse as JW
from review_recommender_tpu.tools import archiver as JA
from review_recommender_tpu_torch.data import etl as T
from review_recommender_tpu_torch.data import warehouse as TW
from review_recommender_tpu_torch.tools import archiver as TA
from tests import torch_raw_cases as RC
from tests.test_torch_etl import assert_tables_equal, jax_column

CASES = ["random-0", "random-3", "na_strings", "all_null_stars", "chunk_boundaries", "ties"]


def _merged(case, d):
    inputs, _ = RC.write_case(case, d / "in")
    return J.normalize_merge(inputs, d / "j.parquet"), T.normalize_merge(inputs, d / "t.npz")


def _halves(jm, tm):
    """The first half of each table, then the whole (overlapping) table."""
    h = len(jm) // 2
    return [(jm.iloc[:h], T.take_rows(tm, range(h))), (jm, tm)]


@pytest.mark.parametrize("case", CASES)
def test_loads_and_views_equal_jax(case, tmp_path):
    jm, tm = _merged(case, tmp_path)
    jw, tw = JW.Warehouse(tmp_path / "jw"), TW.make_warehouse(tmp_path / "tw")
    assert isinstance(tw, TW.Warehouse)
    for jbatch, tbatch in _halves(jm, tm) + [(jm, tm)]:
        assert jw.load(jbatch) == tw.load(tbatch)
    assert_tables_equal(jw.read(), tw.read())
    assert_tables_equal(jw.read(columns=["id", "stars"]), tw.read(columns=["id", "stars"]),
                        ["id", "stars"])
    assert list(tw.read(columns=["stars", "id"])) == ["stars", "id"]
    js, ts = jw.star_distribution(), tw.star_distribution()
    assert np.array_equal(jax_column(js, "stars"), ts["stars"], equal_nan=True)
    assert jax_column(js, "n").tolist() == ts["n"].tolist()
    jb, tb = jw.source_breakdown(), tw.source_breakdown()
    assert jax_column(jb, "source") == tb["source"] and jb["n"].tolist() == tb["n"].tolist()


@pytest.mark.parametrize("case", CASES)
def test_attach_skus_equal_jax(case, tmp_path):
    jm, tm = _merged(case, tmp_path)
    jw, tw = JW.Warehouse(tmp_path / "jw"), TW.Warehouse(tmp_path / "tw")
    jw.load(jm)
    tw.load(tm)
    ids = tm["id"][::2] + ["no-such-id", tm["id"][0], tm["id"][0]]
    scores = np.arange(len(ids), dtype=np.float64)
    jout = jw.attach_skus(pd.DataFrame({"id": ids, "score": scores}))
    tout = tw.attach_skus({"id": ids, "score": scores})
    assert list(jout.columns) == list(tout) == ["id", "score", "sku"]
    assert_tables_equal(jout, tout, ["id", "sku"])
    assert jout["score"].tolist() == tout["score"].tolist()
    jout = jw.attach_skus(pd.DataFrame({"id": ids, "sku": ["mine"] * len(ids)}))
    tout = tw.attach_skus({"id": ids, "sku": ["mine"] * len(ids)})
    assert list(jout.columns) == list(tout) == ["id", "sku", "sku_wh"]
    assert_tables_equal(jout.rename(columns={"sku_wh": "x"}), {**tout, "x": tout["sku_wh"]},
                        ["id", "sku", "x"])


def test_first_writer_wins_and_empty_store_equal_jax(tmp_path):
    rows = {"id": ["a", "b", "a"], "sku": ["S1", "S2", "S9"],
            "stars": np.array([5.0, np.nan, 1.0]), "source": ["x", "y", "x"]}
    jw, tw = JW.Warehouse(tmp_path / "jw"), TW.Warehouse(tmp_path / "tw")
    for w in (jw, tw):
        assert len(w.star_distribution()["n"]) == len(w.source_breakdown()["n"]) == 0
    assert jw.load(pd.DataFrame(rows)) == tw.load(rows) == 2
    later = {"id": ["b", "c"], "sku": ["S7", "S3"], "stars": np.array([2.0, 2.0]),
             "source": ["z", "z"]}
    assert jw.load(pd.DataFrame(later)) == tw.load(later) == 3
    assert jw.read()["sku"].tolist() == tw.read()["sku"] == ["S1", "S2", "S3"]
    assert tw.source_breakdown()["source"] == jax_column(jw.source_breakdown(), "source")
    with pytest.raises(ValueError, match="id"):
        jw.load(pd.DataFrame({"sku": ["x"]}))
    with pytest.raises(ValueError, match="id"):
        tw.load({"sku": ["x"]})
    assert TW.duckdb_available() == JW.duckdb_available()


# ---- the archiver ----

def _tree(d):
    d.mkdir()
    for name in ("a.py", "b.py", "keep_me.py", "notes.txt", "c.csv"):
        (d / name).write_text(name)
    (d / "sub").mkdir()
    (d / "sub" / "d.py").write_text("d")
    return d


def _rel(actions, root):
    return [{k: (v.replace(str(root), "ROOT") if isinstance(v, str) else v)
             for k, v in a.items()} for a in actions]


@pytest.mark.parametrize("dry_run", [True, False])
@pytest.mark.parametrize("patterns,keep", [(("*.py",), ()), (("*.py", "*.csv"), ("keep_*",)),
                                           (("*",), ("notes.txt", "*.csv"))])
def test_archive_files_equal_jax(tmp_path, patterns, keep, dry_run):
    out = []
    for name, mod in (("j", JA), ("t", TA)):
        root = _tree(tmp_path / name)
        actions = mod.archive_files(root, patterns, keep, dry_run=dry_run)
        files = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
        out.append((_rel(actions, root), files))
    assert out[0] == out[1] and out[1][0]


def test_archiver_main_and_collisions_equal_jax(tmp_path, capsys):
    printed = []
    for name, mod in (("j", JA), ("t", TA)):
        root = _tree(tmp_path / name)
        (root / "_archive").mkdir()
        (root / "_archive" / "a.py").write_text("older")
        assert mod.main([str(root), "--dry-run", "--keep", "b.py"]) == 0
        assert mod.main([str(root), "--patterns", "*.py", "*.txt"]) == 0
        printed.append(capsys.readouterr().out.replace(str(root), "ROOT"))
        moved = sorted(p.name for p in (root / "_archive").iterdir())
        stamped = [m for m in moved if m.startswith("a.") and m != "a.py"]
        assert len(stamped) == 1 and stamped[0].endswith(".py")  # a.<timestamp>.py
        assert [m for m in moved if m not in stamped] == ["a.py", "b.py", "keep_me.py",
                                                          "notes.txt"]
    strip = [[line for line in p.splitlines() if "a." not in line.split("->")[-1]]
             for p in printed]
    assert strip[0] == strip[1] and "4 file(s) archived" in printed[1]
