"""The port's ETL (review_recommender_tpu_torch/data/etl.py) against the JAX
package's `data/etl.py`, on the raw dumps of tests/torch_raw_cases.py.

Every value equal: text columns value for value (a pandas null is None),
stars bit-equal as float64 with NaN where pandas holds NA. Chunks are
compared one by one at each case's chunk size (3 for the chunk-boundary
cases), then `normalize_merge` at its default, with the written numpy form
read back and the sample CSV byte-equal to pandas' `to_csv`. Seeded random
CSVs and JSON rows hold the column typing of `pd.read_csv` and
`pd.DataFrame(rows)` and the conversions `clean_chunk` makes from it. The
timestamp parser is held to `pd.to_datetime(format="mixed")` on every
supported format, and the strings the module docstring lists as not
supported are pinned: JAX parses them, the port gives None. Two faults of
the reference are pinned as the port copies them (ROADMAP Queue 3): the
leading zero of an all-digit ASIN chunk, and a missing sku kept as a
review with an id hashed from "nan".
"""
import csv
import io
import math
import random
import warnings

import numpy as np
import pandas as pd
import pytest

from review_recommender_tpu.data import etl as J
from review_recommender_tpu_torch.data import etl as T
from review_recommender_tpu_torch.data.pipeline import read_table
from tests import torch_raw_cases as RC

FMT = "%Y-%m-%dT%H:%M:%SZ"


def _null(v) -> bool:
    return v is None or v is pd.NA or (isinstance(v, float) and math.isnan(v))


def jax_column(df: pd.DataFrame, c: str):
    """A JAX table's column as the port holds it: stars as float64 with
    NaN, other columns as lists with None for a null."""
    if c in ("stars", "n_reviews", "avg_stars", "n"):
        return df[c].astype("Float64").to_numpy(dtype=np.float64, na_value=np.nan)
    return [None if _null(v) else v for v in df[c].tolist()]


def assert_tables_equal(jdf: pd.DataFrame, table: dict, columns=None):
    for c in columns or J.CANONICAL_COLUMNS:
        want, got = jax_column(jdf, c), table[c]
        if isinstance(want, np.ndarray):
            got = np.asarray(got, np.float64)
            assert want.shape == got.shape and np.array_equal(want, got, equal_nan=True), c
        else:
            assert want == list(got), (c, [(a, b) for a, b in zip(want, got) if a != b][:5])


def _iters(kind):
    return (J.iter_csv, T.iter_csv) if kind == "csv" else (J.iter_jsonl, T.iter_jsonl)


@pytest.mark.parametrize("case", RC.CASES)
def test_chunks_equal_jax(case, tmp_path):
    inputs, chunksize = RC.write_case(case, tmp_path)
    n_chunks = 0
    for path, kind, source in inputs:
        jit, tit = _iters(kind)
        jchunks = list(jit(path, source, chunksize=chunksize))
        tchunks = list(tit(path, source, chunksize=chunksize))
        assert len(jchunks) == len(tchunks)
        for a, b in zip(jchunks, tchunks):
            assert_tables_equal(a, b)
        n_chunks += len(tchunks)
    assert n_chunks >= 1


@pytest.mark.parametrize("case", RC.CASES)
def test_normalize_merge_equal_jax(case, tmp_path):
    inputs, _ = RC.write_case(case, tmp_path / "in")
    jm = J.normalize_merge(inputs, tmp_path / "j.parquet", sample_csv=tmp_path / "j.csv",
                           sample_rows=7)
    tm = T.normalize_merge(inputs, tmp_path / "t.npz", sample_csv=tmp_path / "t.csv",
                           sample_rows=7)
    assert len(jm) == len(tm["id"]) > 0
    assert_tables_equal(jm, tm)
    written = read_table(tmp_path / "t.npz", None)
    assert_tables_equal(pd.read_parquet(tmp_path / "j.parquet"), written)
    assert list(written) == J.CANONICAL_COLUMNS
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()


def test_no_rows_and_missing_columns_equal_jax(tmp_path):
    assert len(J.clean_chunk(pd.DataFrame({"foo": [1]}), "x")) == 0
    assert T.n_rows(T.clean_chunk({"foo": [1]}, "x")) == 0
    path = tmp_path / "short.csv"
    path.write_text("asin,reviewText\nA1,short\nA2,tiny\n")
    jm = J.normalize_merge([(path, "csv", "k")], tmp_path / "j.parquet")
    tm = T.normalize_merge([(path, "csv", "k")], tmp_path / "t.npz")
    assert len(jm) == len(tm["id"]) == 0
    assert read_table(tmp_path / "t.npz", None)["id"] == []


def test_a_row_longer_than_the_header_raises_in_both(tmp_path):
    path = tmp_path / "long.csv"
    path.write_text("asin,reviewText\nA1,a long enough text\nA2,a long enough text,extra\n")
    with pytest.raises(Exception):
        list(J.iter_csv(path, "k"))
    with pytest.raises(ValueError, match="fields"):
        list(T.iter_csv(path, "k"))


# ---- column typing: seeded random CSVs and JSON rows ----

CSV_TOKENS = ["1", "22", "007", "-3", "+4", " 5", "6 ", "2.5", "3.5", ".5", "5.", "1e3", "1E-2",
              "inf", "-Infinity", "INF", "True", "false", "TRUE", "tRUE", "", "NA", "nan", "null",
              "None", "N/A", "#N/A", "NaN", " NA", "nan ", "abc", "B00X", "0439023483", "  ",
              "1_0", "0x1f", "-0", "4.0", "1.2.3", "٣", "3e", "e3", "+-1", "NAN", "-", "+"]
JSON_VALUES = [None, 1, 5, 0, -2, 2.5, 3.5, 4.0, "4", " 3 ", "abc", True, False, "2015-08-31",
               "09 13, 2009", 1600000000, 1.6e9, 1600000000.5, "long enough review text",
               "  short  ", "NA", "", [1, 2], {"a": 1}, "0439023483", 439023483,
               "café crème brûlée!!", float("nan")]


def _read_csv_column_checks(jdf, table):
    for c in jdf.columns:
        values = table[c]
        kind = T._kind(values)
        want_str = [None if _null(v) else v for v in jdf[c].astype(str).tolist()]
        assert want_str == T._as_str(values, kind), c
        want_stars = (pd.to_numeric(jdf[c], errors="coerce").round().clip(1, 5).astype("Int64")
                      .astype("Float64").to_numpy(dtype=np.float64, na_value=np.nan))
        assert np.array_equal(want_stars, T._stars(values), equal_nan=True), c
        if len(jdf):  # a column with no rows has no values to convert
            assert pd.api.types.is_numeric_dtype(jdf[c]) == (kind in ("int", "float", "bool",
                                                                       "null"))


@pytest.mark.parametrize("seed", range(4))
def test_csv_column_typing_matches_read_csv(seed, tmp_path):
    """astype(str), the stars conversion and the numeric test of every
    column of 150 random CSVs, as read_csv types them."""
    rng = random.Random(seed)
    for trial in range(150):
        ncol, nrow = rng.randint(1, 3), rng.randint(1, 6)
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow([f"c{i}" for i in range(ncol)])
        w.writerows([[rng.choice(CSV_TOKENS) for _ in range(ncol)] for _ in range(nrow)])
        path = tmp_path / f"t{trial}.csv"
        path.write_text(buf.getvalue(), encoding="utf-8")
        try:
            jdf = pd.read_csv(path, low_memory=False)
        except pd.errors.EmptyDataError:
            with pytest.raises(StopIteration):
                next(T.read_csv_chunks(path))
            continue
        _read_csv_column_checks(jdf, next(T.read_csv_chunks(path)))


@pytest.mark.parametrize("seed", range(4))
def test_json_chunks_match_dataframe_rows(seed):
    """clean_chunk of pd.DataFrame(rows) and of the port's rows_to_table,
    on 300 random chunks of JSON values of every type."""
    rng = random.Random(100 + seed)
    texts = JSON_VALUES[:3] + ["long enough review text", "café crème brûlée!!",
                               "  padded long text  "]
    for _ in range(300):
        rows = []
        for _ in range(rng.randint(1, 5)):
            r = {k: rng.choice(JSON_VALUES) for k in ("asin", "overall", "reviewText",
                                                       "unixReviewTime") if rng.random() < 0.85}
            if rng.random() < 0.8:
                r["reviewText"] = rng.choice(texts)
            rows.append(r)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jout = J.clean_chunk(pd.DataFrame(rows), "s")
        assert_tables_equal(jout, T.clean_chunk(T.rows_to_table(rows), "s"))


def test_csv_header_names_and_blank_lines_match_read_csv(tmp_path):
    path = tmp_path / "h.csv"
    path.write_text('﻿a,a,,b,a\n1,2,3,4,5\n\n   \n""\n6,7\n', encoding="utf-8")
    jdf = pd.read_csv(path, low_memory=False)
    table = next(T.read_csv_chunks(path))
    assert list(jdf.columns) == list(table)
    for c in jdf.columns:
        assert [None if _null(v) else v for v in jdf[c].tolist()] == \
            [None if _null(v) else v for v in table[c]]


# ---- timestamps ----

SUPPORTED = [v for values in RC.DATES.values() for v in values
             if not v.lstrip("-").replace(".", "").isdigit() and v]
UNSUPPORTED = ["20150831", "2015", "2015-08", "08/31/2015", "2015/08/31", "Sep 13, 09",
               "September 13, 2009 10:00", "2015-08-31 10:11:12 UTC", "Sep 13th, 2009",
               "Sep 13,2009"]


def _jax_ts(value: str):
    t = pd.to_datetime(pd.Series([value], dtype="str"), utc=True, errors="coerce",
                       format="mixed")
    out = t.dt.strftime(FMT).iloc[0]
    return None if _null(out) else out


@pytest.mark.parametrize("value", SUPPORTED)
def test_timestamp_formats_equal_jax(value):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert T.format_utc(T.parse_timestamp(value)) == _jax_ts(value)


@pytest.mark.parametrize("seed", range(3))
def test_timestamp_numbers_in_every_format_equal_jax(seed):
    """1,000 random month, day, time and zone numbers in each supported
    format, invalid ones included (month 0-35, hour 0-25, +14:00)."""
    rng = random.Random(seed)
    months = ["Jan", "january", "FEBRUARY", "mar", "Apr", "May", "jun", "July", "Aug", "Sept.",
              "september", "Oct", "nov", "December"]
    for _ in range(1000):
        y = rng.choice([1969, 1970, 1999, 2000, 2015, 2016, 2100])
        a, b = rng.randint(0, 35), rng.randint(0, 35)
        h, mi, s = rng.randint(0, 25), rng.randint(0, 61), rng.randint(0, 61)
        tz = rng.choice(["", "Z", "z", "+02:00", "-0530", "+01", " +02:00", "-12:00", "+14:00"])
        value = rng.choice([
            f"{y}-{a:02d}-{b:02d}", f"{y}-{a}-{b}{rng.choice('T t')}{h:02d}:{mi:02d}:{s:02d}{tz}",
            f"{y}-{a:02d}-{b:02d}T{h:02d}:{mi:02d}{tz}", f"{a:02d} {b:02d}, {y}", f"{a} {b} {y}",
            f"{rng.choice(months)} {b}, {y}", f"{b} {rng.choice(months)} {y}",
            f"{y}-{a:02d}-{b:02d}T{h:02d}:{mi:02d}:{s:02d}.{rng.randint(0, 999999)}{tz}"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert T.format_utc(T.parse_timestamp(value)) == _jax_ts(value), value


@pytest.mark.parametrize("value", UNSUPPORTED)
def test_strings_jax_parses_and_the_port_turns_to_null(value):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _jax_ts(value) is not None
    assert T.parse_timestamp(value) is None


def test_a_year_past_9999_is_null_where_jax_raises():
    s = pd.Series([253402300800], dtype="int64")  # 10000-01-01 in unix seconds
    with pytest.raises(Exception):
        pd.to_datetime(s, unit="s", utc=True, errors="coerce").dt.strftime(FMT)
    assert T._timestamps([253402300800], "int") == [None]
    assert T._timestamps([253402300799], "int") == ["9999-12-31T23:59:59Z"]


@pytest.mark.parametrize("value", [1600000000.7, 1600000000.9999995, -1.5, -1e-7, -1e-10, 0.0,
                                   1262304000, 946684799])
def test_unix_seconds_equal_jax(value):
    t = pd.to_datetime(pd.to_numeric(pd.Series([value])), unit="s", utc=True, errors="coerce")
    kind = "int" if isinstance(value, int) else "float"
    assert T._timestamps([value], kind) == [t.dt.strftime(FMT).iloc[0]]


# ---- ids and the reference's faults ----

@pytest.mark.parametrize("text", ["short text", "x" * 300, "café " * 80, "\ud800 lone surrogate",
                                  ""])
def test_stable_id_equal_jax(text):
    assert T.stable_id("snap", "B001", text) == J.stable_id("snap", "B001", text)


def test_fault_all_digit_asin_chunk_loses_its_leading_zero(tmp_path):
    """ROADMAP Queue 3: read_csv types a chunk whose ASINs are all digits
    as int64, and astype(str) drops the leading zero; a chunk with a
    letter in it keeps the zero. The port copies both."""
    inputs, chunksize = RC.write_case("leading_zero_alone", tmp_path)
    (path, _, source), = inputs
    jchunks = list(J.iter_csv(path, source, chunksize=chunksize))
    tchunks = list(T.iter_csv(path, source, chunksize=chunksize))
    for chunks in (tchunks, [{"sku": jax_column(c, "sku")} for c in jchunks]):
        assert chunks[0]["sku"] == ["439023483", "439023483", "1"]
        assert chunks[1]["sku"] == ["0439023483", "B00LETTERS", "0000000001"]


def test_fault_missing_sku_is_kept_with_an_id_of_nan(tmp_path):
    """ROADMAP Queue 3: a missing sku passes the empty-sku filter as a null
    and its id hashes the string "nan"; `build_products` then drops it
    (groupby), while the review index maps it to a product named "nan"."""
    inputs, _ = RC.write_case("na_strings", tmp_path)
    jm = J.normalize_merge(inputs, tmp_path / "j.parquet")
    tm = T.normalize_merge(inputs, tmp_path / "t.npz")
    assert_tables_equal(jm, tm)
    nulls = [i for i, s in enumerate(tm["sku"]) if s is None]
    assert len(nulls) >= 2
    for i in nulls:
        assert tm["id"][i] == J.stable_id(tm["source"][i], "nan", tm["text"][i])
