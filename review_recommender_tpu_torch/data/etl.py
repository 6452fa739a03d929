"""Raw review dumps -> the canonical reviews table, without pandas.

Counterpart of `review_recommender_tpu/data/etl.py`: the same column
aliases, stable ids, 10-character rule, first-wins dedup by id and
chunked streaming. The JAX module works on pandas DataFrames; this one on
a column table, a dict of column name -> list of values (or a numpy
array), and gives the values the JAX functions give under pandas 3, column
for column:

- Reading. `iter_csv` types each column of a chunk of 100,000 rows as
  `pd.read_csv` does: the default NA strings (`NA_STRINGS`) become None; a
  column whose other values are all integer literals becomes int (float
  where one is missing), then float literals (inf and infinity included),
  then true/false in any case, else str (an integer literal past the
  int64 range, which pandas types otherwise, is not copied; nor is its
  parse of a float literal of 19 digits or more, which can differ from the
  correctly rounded value by an ulp). So a chunk whose ASINs are all digits
  stores "0439023483" as the sku "439023483", and "123" beside an empty
  cell as "123.0" (ROADMAP Queue 3 lists the lost zero as a fault of the
  reference; the port copies it). Blank lines are skipped, short rows
  padded with None, repeated header names get ".1", ".2", empty ones
  "Unnamed: i"; a row longer than the header raises. `iter_jsonl` builds
  its chunk as `pd.DataFrame(rows)` would: the keys in first-seen order,
  a missing key None.
- A column's pandas dtype is read from its values (`_kind`): all bool ->
  bool (with a None: object); int and float -> int64 (a float or a None:
  float64; an int past int64 -> object, where pandas' typing of such
  ints is not copied in full); str -> str; nothing -> null; a mix ->
  object.
- `astype(str).str.strip()`: a null stays null (a missing sku is kept as
  a review with a null sku whose id hashes "nan": a fault of the
  reference, copied and listed in ROADMAP); floats print as Python's
  repr; then the whitespace `str.strip` strips.
- Stars: `to_numeric(errors="coerce")` (strings as the float grammar with
  ASCII blanks around, bools as 0/1), rounded half to even, clipped to
  1..5, null where no number. The table holds them as float64 with NaN.
- Timestamps: a numeric column is unix seconds (floored to the second);
  strings go through `parse_timestamp` below; output "%Y-%m-%dT%H:%M:%SZ"
  in UTC, null where nothing parses.
- The 10-character rule counts code points, after the strip.

`parse_timestamp` replaces pandas' `to_datetime(format="mixed")`, which
falls back to dateutil. It reads the formats Amazon dumps use:
  ISO-8601 dates and times   "2015-08-31", "2015-8-31", "2015-08-31T10:11",
                             "2015-08-31 10:11:12.5", with "Z", "+02:00",
                             "+0200", "+02" or naive (read as UTC)
  SNAP reviewTime            "09 13, 2009" or "09 13 2009": month first;
                             a first number above 12 is the day when the
                             second is a month (dateutil's swap)
  month names                "Sep 13, 2009", "September 13 2009",
                             "Sept. 13, 2009", "13 September 2009"
The JAX function parses these strings and the port turns them to null:
compact ISO ("20150831"), a year or year-month alone ("2015", "2015-08"),
slashed dates ("08/31/2015", "2015/08/31"), two-digit years ("Sep 13,
09"), a time after a month-name date, zone names ("UTC"), ordinals
("13th") and anything else dateutil reads; "Sep 13,2009" (no blank after
the comma), which JAX reads as the year 1. A year outside 1..9999 is null
here; JAX raises on one (strftime). In an object column (strings mixed
with numbers) JAX reads a number as nanoseconds since the epoch; so does
the port.
"""
from __future__ import annotations

import csv
import datetime as _dt
import hashlib
import json
import logging
import math
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

CANONICAL_COLUMNS = ["id", "sku", "ts", "stars", "text", "source"]
MIN_TEXT_CHARS = 10

# Column-name variants seen across Amazon review dumps.
COLUMN_ALIASES: Dict[str, Sequence[str]] = {
    "sku": ("sku", "asin", "product_id", "productid", "item_id"),
    "stars": ("stars", "rating", "overall", "star_rating", "score"),
    "text": ("text", "review_text", "reviewtext", "review_body", "body",
             "reviews.text"),
    "ts": ("ts", "timestamp", "unixreviewtime", "review_date", "date",
           "reviews.date", "review_time"),
}

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT_RE = re.compile(r"[ \t\n\r\v\f]*[+-]?[0-9]+[ \t\n\r\v\f]*\Z")
_INT64 = (-(1 << 63), (1 << 63) - 1)
_FLOAT_RE = re.compile(
    r"[ \t\n\r\v\f]*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|(?i:inf|infinity))[ \t\n\r\v\f]*\Z")


def stable_id(source: str, sku: str, text: str) -> str:
    """Content-addressed review id: stable across re-ingests."""
    h = hashlib.sha256()
    h.update(f"{source}|{sku}|{text[:256]}".encode("utf-8", "replace"))
    return h.hexdigest()[:24]


# ---- column typing (the pandas dtype a column of values would get) ----

def is_missing(v) -> bool:
    """None or a float NaN: a null cell."""
    return v is None or (isinstance(v, float) and v != v)


def _kind(values: list) -> str:
    """The pandas dtype `pd.DataFrame` gives a column of these values:
    null, bool, int, float, str or object."""
    present = [v for v in values if not is_missing(v)]
    if not present:
        return "null"
    gaps = len(present) < len(values)
    if all(type(v) is bool for v in present):
        return "object" if gaps else "bool"
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
        if any(isinstance(v, int) and not _INT64[0] <= v <= _INT64[1] for v in present):
            return "object"
        return "int" if not gaps and all(isinstance(v, int) for v in present) else "float"
    if all(isinstance(v, str) for v in present):
        return "str"
    return "object"


def _column_values(col) -> list:
    return col.tolist() if isinstance(col, np.ndarray) else list(col)


def _as_str(values: list, kind: str) -> List[Optional[str]]:
    """`astype(str)`: null stays null, a float column prints float(v)."""
    if kind == "float":
        return [None if is_missing(v) else str(float(v)) for v in values]
    return [None if is_missing(v) else (v if isinstance(v, str) else str(v)) for v in values]


def _strip(values: List[Optional[str]]) -> List[Optional[str]]:
    return [None if v is None else v.strip() for v in values]


def _parse_number(s: str) -> float:
    """`pd.to_numeric(errors="coerce")` of one string."""
    return float(s) if _FLOAT_RE.match(s) else math.nan


def _as_number(values: list) -> List[float]:
    """`pd.to_numeric(values, errors="coerce")` as floats (NaN for null)."""
    out = []
    for v in values:
        if is_missing(v):
            out.append(math.nan)
        elif isinstance(v, bool):
            out.append(1.0 if v else 0.0)
        elif isinstance(v, (int, float)):
            out.append(float(v))
        elif isinstance(v, str):
            out.append(_parse_number(v))
        else:
            out.append(math.nan)
    return out


def _stars(values: list) -> np.ndarray:
    """`to_numeric(...).round().clip(1, 5)` (half to even), NaN for null."""
    out = np.full(len(values), np.nan)
    for i, x in enumerate(_as_number(values)):
        if x != x:
            continue
        out[i] = 5.0 if x >= 5 else 1.0 if x <= 1 else float(round(x))
    return out


# ---- timestamps ----

_EPOCH_DAYS = _dt.date(1970, 1, 1).toordinal()
_MONTHS = {name: i + 1 for i, names in enumerate((
    ("jan", "january"), ("feb", "february"), ("mar", "march"), ("apr", "april"),
    ("may",), ("jun", "june"), ("jul", "july"), ("aug", "august"),
    ("sep", "sept", "september"), ("oct", "october"), ("nov", "november"),
    ("dec", "december"))) for name in names}
_ISO_RE = re.compile(
    r"(\d{4})-(\d{1,2})-(\d{1,2})"
    r"(?:[Tt ](\d{1,2})(?::(\d{2})(?::(\d{2})(?:\.\d+)?)?)?)?"
    r"(?: ?([Zz]|[+-]\d{2}(?::?\d{2})?))?\Z", re.ASCII)
_MDY_RE = re.compile(r"(\d{1,2})\s+(\d{1,2}),?\s+(\d{4})\Z", re.ASCII)
_NAMED_MDY_RE = re.compile(r"([A-Za-z]+)\.?\s+(\d{1,2}),?\s+(\d{4})\Z", re.ASCII)
_NAMED_DMY_RE = re.compile(r"(\d{1,2})\s+([A-Za-z]+)\.?,?\s+(\d{4})\Z", re.ASCII)


def _seconds(year, month, day, hour=0, minute=0, second=0, offset=0) -> Optional[int]:
    """Unix seconds of a UTC wall time less `offset` seconds; None where
    the date or time does not exist."""
    try:
        days = _dt.date(year, month, day).toordinal() - _EPOCH_DAYS
        _dt.time(hour, minute, second)
    except ValueError:
        return None
    return days * 86400 + hour * 3600 + minute * 60 + second - offset


def _offset(tz: Optional[str]) -> Optional[int]:
    """Seconds east of UTC of "Z", "+HH", "+HHMM" or "+HH:MM"."""
    if tz is None or tz in "Zz":
        return 0
    digits = tz[1:].replace(":", "")
    hours, minutes = int(digits[:2]), int(digits[2:] or 0)
    if hours > 23 or minutes > 59:
        return None
    return (-1 if tz[0] == "-" else 1) * (hours * 3600 + minutes * 60)


def _month_day(first: int, second: int):
    """dateutil's reading of two numbers before the year: month first,
    swapped when only the second can be a month."""
    return (second, first) if first > 12 and second <= 12 else (first, second)


def parse_timestamp(text: str) -> Optional[int]:
    """Unix seconds of one timestamp string in a supported format (module
    docstring), None otherwise."""
    s = text.strip()
    m = _ISO_RE.match(s)
    if m:
        y, mo, d, hh, mi, ss, tz = m.groups()
        off = _offset(tz)
        if off is None:
            return None
        return _seconds(int(y), int(mo), int(d), int(hh or 0), int(mi or 0), int(ss or 0), off)
    m = _MDY_RE.match(s)
    if m:
        month, day = _month_day(int(m.group(1)), int(m.group(2)))
        return _seconds(int(m.group(3)), month, day)
    m = _NAMED_MDY_RE.match(s)
    if m and m.group(1).lower() in _MONTHS:
        return _seconds(int(m.group(3)), _MONTHS[m.group(1).lower()], int(m.group(2)))
    m = _NAMED_DMY_RE.match(s)
    if m and m.group(2).lower() in _MONTHS:
        return _seconds(int(m.group(3)), _MONTHS[m.group(2).lower()], int(m.group(1)))
    return None


def _unix_seconds(x) -> Optional[int]:
    """`to_datetime(unit="s")` of a number, floored to the second: the
    fraction taken to whole nanoseconds first, as pandas does."""
    if isinstance(x, int):
        return x
    if not math.isfinite(x):
        return None
    base = math.trunc(x)
    return base + math.floor(round((x - base) * 1e9) / 1e9)


def format_utc(seconds: Optional[int]) -> Optional[str]:
    """"%Y-%m-%dT%H:%M:%SZ" of unix seconds (the year unpadded, as glibc's
    strftime prints it), None outside the years 1..9999."""
    if seconds is None:
        return None
    days, rest = divmod(seconds, 86400)
    ordinal = days + _EPOCH_DAYS
    if not 1 <= ordinal <= _dt.date.max.toordinal():
        return None
    d = _dt.date.fromordinal(ordinal)
    return (f"{d.year}-{d.month:02d}-{d.day:02d}T{rest // 3600:02d}:"
            f"{rest // 60 % 60:02d}:{rest % 60:02d}Z")


def _timestamps(values: list, kind: str) -> List[Optional[str]]:
    if kind in ("int", "float"):
        return [None if is_missing(v) else format_utc(_unix_seconds(v)) for v in values]
    if kind == "bool":
        return [None] * len(values)
    out = []
    for v in values:
        if isinstance(v, str):
            out.append(format_utc(parse_timestamp(v)))
        elif (isinstance(v, (int, float)) and not isinstance(v, bool) and not is_missing(v)
              and _INT64[0] < v < _INT64[1]):  # nanoseconds, as datetime64[ns] holds them
            out.append(format_utc(math.floor(v / 1e9) if isinstance(v, float) else v // 10**9))
        else:
            out.append(None)
    return out


# ---- the chunk ----

def empty_table() -> Dict[str, object]:
    """A reviews table with no rows."""
    return {c: (np.zeros(0) if c == "stars" else []) for c in CANONICAL_COLUMNS}


def n_rows(table: Dict[str, object]) -> int:
    return len(next(iter(table.values()))) if table else 0


def _find_column(table: Dict[str, object], aliases: Sequence[str]) -> Optional[str]:
    lower = {c.lower(): c for c in table}
    for a in aliases:
        if a in lower:
            return lower[a]
    return None


def clean_chunk(table: Dict[str, object], source: str) -> Dict[str, object]:
    """Canonicalize one raw chunk (a column table) to the contract schema."""
    cols = {}
    for canon, aliases in COLUMN_ALIASES.items():
        found = _find_column(table, aliases)
        if found is not None:
            values = _column_values(table[found])
            cols[canon] = (values, _kind(values))
    if "sku" not in cols or "text" not in cols:
        logger.warning("%s chunk missing sku/text (have %s) — skipped",
                       source, list(table)[:8])
        return empty_table()

    sku = _strip(_as_str(*cols["sku"]))
    text = _strip(_as_str(*cols["text"]))
    n = len(sku)
    stars = _stars(cols["stars"][0]) if "stars" in cols else np.full(n, np.nan)
    ts = _timestamps(*cols["ts"]) if "ts" in cols else [None] * n

    keep = [i for i in range(n) if sku[i] != "" and text[i] is not None
            and len(text[i]) >= MIN_TEXT_CHARS]
    out_sku = [sku[i] for i in keep]
    out_text = [text[i] for i in keep]
    return {
        "id": [stable_id(source, "nan" if s is None else s, t) for s, t in zip(out_sku, out_text)],
        "sku": out_sku,
        "ts": [ts[i] for i in keep],
        "stars": stars[np.asarray(keep, np.int64)],
        "text": out_text,
        "source": [source] * len(keep),
    }


# ---- readers ----

def _csv_header(names: Sequence[str]) -> List[str]:
    """read_csv's column names: empty -> "Unnamed: i", repeats -> "x.1"."""
    out: List[str] = []
    seen: Dict[str, int] = {}
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        base, k = name, seen.get(name, 0)
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen[base] = k
        seen[name] = 0
        out.append(name)
    return out


def _csv_column(raw: List[Optional[str]]) -> list:
    """One column of a read_csv chunk: NA strings -> None, then int,
    float, bool or str values, as the C parser types the column."""
    vals = [None if v is None or v in NA_STRINGS else v for v in raw]
    present = [v for v in vals if v is not None]
    if not present:
        return [math.nan] * len(vals)
    if all(_INT_RE.match(v) for v in present):
        ints = [None if v is None else int(v) for v in vals]
        if len(present) < len(vals):
            return [math.nan if v is None else float(v) for v in ints]
        return ints
    if all(_FLOAT_RE.match(v) for v in present):
        return [math.nan if v is None else float(v) for v in vals]
    if all(v.upper() in ("TRUE", "FALSE") for v in present):
        return [None if v is None else v.upper() == "TRUE" for v in vals]
    return vals


def _csv_chunk(names: List[str], rows: List[List[str]]) -> Dict[str, list]:
    width = len(names)
    cols: List[List[Optional[str]]] = [[] for _ in range(width)]
    for row in rows:
        for j in range(width):
            cols[j].append(row[j] if j < len(row) else None)
    return {name: _csv_column(col) for name, col in zip(names, cols)}


def read_csv_chunks(path: str | Path, chunksize: int = 100_000) -> Iterator[Dict[str, list]]:
    """The raw column tables of `pd.read_csv(path, chunksize=chunksize,
    low_memory=False)` (module docstring)."""
    with open(path, encoding="utf-8-sig", newline="") as f:
        reader = csv.reader(f)
        names = None
        rows: List[List[str]] = []
        chunks = 0
        for row in reader:
            if not row or (len(row) == 1 and row[0] and not row[0].strip(" \t")):
                continue  # a blank line (a quoted "" is a row of one NA)
            if names is None:
                names = _csv_header(row)
                continue
            if len(row) > len(names):
                raise ValueError(f"{path}: line {reader.line_num} has {len(row)} fields, "
                                 f"the header {len(names)}")
            rows.append(row)
            if len(rows) >= chunksize:
                yield _csv_chunk(names, rows)
                rows, chunks = [], chunks + 1
        if names is not None and (rows or not chunks):  # a header alone: one empty chunk
            yield _csv_chunk(names, rows)


def iter_csv(path: str | Path, source: str, chunksize: int = 100_000
             ) -> Iterator[Dict[str, object]]:
    for chunk in read_csv_chunks(path, chunksize):
        yield clean_chunk(chunk, source)


def rows_to_table(rows: Sequence[dict]) -> Dict[str, list]:
    """`pd.DataFrame(rows)`'s columns: keys in first-seen order, a key a
    row lacks None."""
    names: Dict[str, None] = {}
    for r in rows:
        if not isinstance(r, dict):
            raise ValueError(f"a JSON line holds {type(r).__name__}, not an object")
        names.update(dict.fromkeys(r))
    return {k: [r.get(k) for r in rows] for k in names}


def iter_jsonl(path: str | Path, source: str, chunksize: int = 100_000
               ) -> Iterator[Dict[str, object]]:
    """Stream newline-delimited JSON (SNAP-style dumps) in chunks."""
    rows = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
            if len(rows) >= chunksize:
                yield clean_chunk(rows_to_table(rows), source)
                rows = []
    if rows:
        yield clean_chunk(rows_to_table(rows), source)


# ---- merge ----

def concat_tables(tables: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Column tables one after another (`pd.concat`): the union of their
    columns in first-seen order, a column a table lacks null there (NaN
    in an array column, None in a list one)."""
    names = list(dict.fromkeys(c for t in tables for c in t))
    out: Dict[str, object] = {}
    for c in names:
        if any(isinstance(t.get(c), np.ndarray) for t in tables):
            out[c] = np.concatenate([np.asarray(t[c], np.float64) if c in t
                                     else np.full(n_rows(t), np.nan) for t in tables])
        else:
            out[c] = [v for t in tables for v in (t[c] if c in t else [None] * n_rows(t))]
    return out


def take_rows(table: Dict[str, object], rows: Sequence[int]) -> Dict[str, object]:
    """The rows `rows` of a column table, in that order."""
    idx = np.asarray(rows, np.int64)
    return {c: (v[idx] if isinstance(v, np.ndarray) else [v[i] for i in rows])
            for c, v in table.items()}


def dedup_ids(table: Dict[str, object]) -> Dict[str, object]:
    """The rows whose id is new, the first of each kept (drop_duplicates)."""
    seen = set()
    keep = []
    for i, rid in enumerate(table["id"]):
        if rid not in seen:
            seen.add(rid)
            keep.append(i)
    return table if len(keep) == len(table["id"]) else take_rows(table, keep)


def _csv_cell(v) -> str:
    if v is None or (isinstance(v, float) and v != v):
        return ""
    return str(int(v)) if isinstance(v, float) else v


def write_sample_csv(table: Dict[str, object], path: str | Path, rows: int) -> None:
    """`df.head(rows).to_csv(path, index=False)` of a reviews table."""
    n = min(rows, n_rows(table))
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(CANONICAL_COLUMNS)
        for i in range(n):
            w.writerow([_csv_cell(table[c][i]) for c in CANONICAL_COLUMNS])


def normalize_merge(
    inputs: Iterable[tuple],  # (path, kind "csv"|"jsonl", source_tag)
    out_path: str | Path,
    sample_csv: Optional[str | Path] = None,
    sample_rows: int = 100_000,
) -> Dict[str, object]:
    """Stream all inputs, concat, dedup by id (first wins), write the table
    in the numpy form at `out_path` (data/pipeline.py:write_numpy_form)."""
    from review_recommender_tpu_torch.data.pipeline import write_numpy_form

    frames = []
    for path, kind, source in inputs:
        it = iter_csv(path, source) if kind == "csv" else iter_jsonl(path, source)
        frames.extend(chunk for chunk in it if len(chunk["id"]))
    merged = dedup_ids(concat_tables(frames)) if frames else empty_table()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_numpy_form(merged, out_path)
    if sample_csv is not None:
        write_sample_csv(merged, sample_csv, sample_rows)
    logger.info("merged %d reviews -> %s", len(merged["id"]), out_path)
    return merged
