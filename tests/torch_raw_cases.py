"""Raw review dumps for the raw-pipeline tests of the port
(tests/test_torch_etl.py, test_torch_prep.py, test_torch_warehouse.py,
test_torch_raw_pipeline.py and the card tests), jax- and pandas-free.

`write_case(name, dir)` writes one case's dump files and returns
(inputs, chunksize): the `(path, kind, source)` list `normalize_merge`
takes and the chunk size to read them at. The cases:

  alias-<canon>-<name>  one CSV whose <canon> column is named <name>
                        (every alias of etl.COLUMN_ALIASES, in mixed case)
  leading_zero_alone    chunks of 3 rows whose ASINs are all digits with a
                        leading zero, then a chunk that mixes in letters
  leading_zero_nulls    digit ASINs beside an empty cell (-> "123.0")
  int_stars_nulls       integer stars with empty cells and NA strings
  float_stars_nulls     float stars, x.5 halves, out-of-range, junk
  half_stars            0.5 .. 5.5 in JSONL, ties to even
  dates-<format>        one timestamp format per case (ISO with Z, with an
                        offset, naive; SNAP "MM DD, YYYY"; "Month D, YYYY";
                        "YYYY-MM-DD"; unix seconds, int and float with nulls)
  na_strings            every default NA string in every column
  text_edges            non-ASCII, sub-10-character texts, blanks to strip
  chunk_boundaries      a JSONL and a CSV read 3 rows at a time, repeats
                        across chunks and files
  top80_and_cap         one sku past the top-80 and past a snippet cap
  ties                  ties in stars and in ts within skus
  all_null_stars        one sku whose every star is null, one with no ts
  spam                  URLs, promo codes and character runs
  random-<seed>         a seeded random dump pair in the SNAP and the
                        customer-reviews shapes, Zipf reviews per sku

`FULL_PIPELINE_CASES` are the ones the whole-pipeline test runs.
"""
import csv
import json
from pathlib import Path

import numpy as np

ALIASES = {  # data/etl.py:COLUMN_ALIASES, some written in another case
    "sku": ("SKU", "asin", "Product_ID", "productid", "ITEM_ID"),
    "stars": ("stars", "Rating", "overall", "star_rating", "score"),
    "text": ("text", "review_text", "reviewText", "review_body", "Body", "reviews.text"),
    "ts": ("ts", "timestamp", "unixReviewTime", "review_date", "Date", "reviews.date",
           "review_time"),
}
NA = ["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
      "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"]
DATES = {
    "iso_z": ["2015-08-31T10:11:12Z", "2016-01-02T00:00:00Z", "2015-08-31t23:59:59.75z",
              "2009-09-13T01:02:03.123456Z"],
    "iso_offset": ["2015-08-31T10:11:12+02:00", "2015-08-31T01:00:00-05:30",
                   "2016-02-29T23:30:00+0100", "2015-12-31T23:00:00-02",
                   "2015-06-01 08:00:00 +01:00"],
    "iso_naive": ["2015-08-31T10:11:12", "2015-08-31 10:11", "2015-8-3T7:05:09", "2015-08-31T10",
                  " 2015-08-31 10:11:12.999 "],
    "snap_reviewtime": ["09 13, 2009", "9 3, 2009", "13 09, 2009", "12 31 2014", "02 29, 2016",
                        "02 30, 2016", "00 10, 2016"],
    "month_name": ["September 13, 2009", "Sep 13, 2009", "sept. 1, 2010", "MAY 5 2011",
                   "13 September 2009", "Feb 29, 2015", "Jan 1, 2012"],
    "ymd": ["2015-08-31", "2016-02-29", "2015-02-30", "1999-12-31", "2015-13-01"],
    "unix_int": ["1600000000", "0", "1262304000", "946684799", "1400000000"],
    "unix_float": ["1600000000.7", "", "1262304000", "-1.5", "1400000000.25"],
}
WORDS = ("great sound battery lasts long cheap plastic broke after week love it works fine "
         "would buy again shipping fast colour fades quickly excellent value terrible "
         "customer service comfortable fits well").split()


def _texts(rng, n, lo=3, hi=30):
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi)))) for _ in range(n)]


def _write_csv(path, header, rows):
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def _write_jsonl(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _alias(d: Path, canon: str, name: str):
    rng = np.random.default_rng(len(name))
    cols = {"sku": "asin", "stars": "overall", "text": "reviewText", "ts": "review_date"}
    cols[canon] = name
    header = [cols[c] for c in ("sku", "stars", "text", "ts")] + ["helpful"]
    rows = [[f"B00{i % 4}", str(1 + i % 5), t, f"2015-0{1 + i % 9}-1{i % 10}", str(i)]
            for i, t in enumerate(_texts(rng, 12))]
    path = d / "alias.csv"
    _write_csv(path, header, rows)
    return [(path, "csv", "kaggle")], 100_000


def _leading_zero_alone(d: Path):
    rows = [["0439023483", "2.5", "a fine long book review", "2015-08-31"],
            ["0439023483", "3.5", "another long book review", "2015-09-01"],
            ["0000000001", "4", "third long book review here", "2015-09-02"],
            ["0439023483", "5", "a mixed chunk long review", "2015-09-03"],
            ["B00LETTERS", "1", "letters chunk long review", "2015-09-04"],
            ["0000000001", "2", "zero padded in mixed chunk", "2015-09-05"]]
    path = d / "zeros.csv"
    _write_csv(path, ["product_id", "star_rating", "review_body", "review_date"], rows)
    return [(path, "csv", "kaggle")], 3


def _leading_zero_nulls(d: Path):
    rows = [["0123", "5", "digits beside an empty sku"], ["", "4", "the empty sku cell here"],
            ["0123", "3", "digits again beside empty"], ["123", "2", "no leading zero at all"]]
    path = d / "zeros_null.csv"
    _write_csv(path, ["asin", "overall", "reviewText"], rows)
    return [(path, "csv", "kaggle")], 100_000


def _stars(d: Path, values, name):
    rng = np.random.default_rng(3)
    rows = [[f"S{i % 3}", v, t] for i, (v, t) in enumerate(zip(values, _texts(rng, len(values))))]
    path = d / f"{name}.csv"
    _write_csv(path, ["sku", "stars", "text"], rows)
    return [(path, "csv", "kaggle")], 100_000


def _half_stars(d: Path):
    rng = np.random.default_rng(4)
    vals = [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 2.4999, 3.0, None, 4.51]
    rows = [{"asin": f"H{i % 2}", "overall": v, "reviewText": t}
            for i, (v, t) in enumerate(zip(vals, _texts(rng, len(vals))))]
    path = d / "half.jsonl"
    _write_jsonl(path, rows)
    return [(path, "jsonl", "snap")], 100_000


def _dates(d: Path, fmt: str):
    rng = np.random.default_rng(5)
    values = DATES[fmt]
    if fmt == "unix_int":
        rows = [{"asin": f"D{i % 2}", "overall": 4, "reviewText": t, "unixReviewTime": int(v)}
                for i, (v, t) in enumerate(zip(values, _texts(rng, len(values))))]
        path = d / "dates.jsonl"
        _write_jsonl(path, rows)
        return [(path, "jsonl", "snap")], 100_000
    texts = _texts(rng, len(values))
    rows = [[f"D{i % 2}", "4", t, v] for i, (v, t) in enumerate(zip(values, texts))]
    path = d / "dates.csv"
    _write_csv(path, ["asin", "overall", "reviewText", "ts"], rows)
    return [(path, "csv", "kaggle")], 100_000


def _na_strings(d: Path):
    rng = np.random.default_rng(6)
    texts = _texts(rng, len(NA), lo=4)
    rows = [[v, v, t, v] for v, t in zip(NA, texts)]
    rows += [["N1", "3", v, "2015-01-01"] for v in NA]
    rows += [[" NA ", "4", "padded NA sku text", " nan "]]
    path = d / "na.csv"
    _write_csv(path, ["asin", "overall", "reviewText", "review_date"], rows)
    jrows = [{"asin": None, "overall": None, "reviewText": "a null sku in json lines"},
             {"asin": "nan", "overall": "4", "reviewText": "the string nan as a sku"},
             {"asin": "J1", "reviewText": None}, {"asin": "J1", "reviewText": "NA"}]
    jpath = d / "na.jsonl"
    _write_jsonl(jpath, jrows)
    return [(path, "csv", "kaggle"), (jpath, "jsonl", "snap")], 100_000


def _text_edges(d: Path):
    rows = [["E1", "5", "café crème brûlée, très bon", "2015-01-01"],
            ["E1", "4", "短いけど十文字以上のレビューです", "2015-01-02"],
            ["E1", "3", "naïve", "2015-01-03"],
            ["E2", "2", "exactly10!", "2015-01-04"],
            ["E2", "1", "  nine 9 c  ", "2015-01-05"],
            ["  E3  ", "5", "\t surrounded by blanks and tabs \t", "2015-01-06"],
            ["E4", "4", "multi\nline\r\nreview text", "2015-01-07"],
            ["E4", "4", "emoji 🎧🎧 headphones rock", "2015-01-08"],
            ["   ", "3", "a blank sku is dropped here", "2015-01-09"],
            ["E5", "2", 'quotes "inside" the text, and commas', "2015-01-10"]]
    path = d / "edges.csv"
    _write_csv(path, ["asin", "overall", "reviewText", "review_date"], rows)
    return [(path, "csv", "kaggle")], 100_000


def _chunk_boundaries(d: Path):
    rng = np.random.default_rng(7)
    texts = _texts(rng, 8, lo=4)
    jrows = [{"asin": f"C{i % 3}", "overall": float(1 + i % 5), "reviewText": texts[i % 5],
              "unixReviewTime": 1400000000 + 86400 * i, "reviewTime": "01 02, 2014",
              "helpful": [i, i + 1], "style": {"Color": "red"}} for i in range(10)]
    jpath = d / "chunks.jsonl"
    _write_jsonl(jpath, jrows)
    rows = [[f"C{i % 3}", str(1 + i % 5), texts[i % 5], f"2014-05-{10 + i}"] for i in range(8)]
    path = d / "chunks.csv"
    _write_csv(path, ["product_id", "star_rating", "review_body", "review_date"], rows)
    return [(jpath, "jsonl", "snap"), (path, "csv", "kaggle")], 3


def _top80_and_cap(d: Path):
    rng = np.random.default_rng(8)
    n = 300
    rows = [{"asin": "BIG" if i < 270 else f"SMALL{i % 3}", "overall": int(rng.integers(1, 6)),
             "reviewText": f"review number {i} " + " ".join(rng.choice(WORDS, 6)),
             "unixReviewTime": int(1300000000 + rng.integers(0, 10) * 86400)} for i in range(n)]
    path = d / "big.jsonl"
    _write_jsonl(path, rows)
    return [(path, "jsonl", "snap")], 100_000


def _ties(d: Path):
    rows = [["T1", "5", f"tie review {i} same stars", "2015-01-01" if i % 2 else "2015-01-02"]
            for i in range(6)]
    rows += [["T1", "", f"null star tie {i} here", "2015-01-01"] for i in range(3)]
    rows += [["T2", "4", f"same ts and stars {i}!", ""] for i in range(4)]
    path = d / "ties.csv"
    _write_csv(path, ["asin", "overall", "reviewText", "review_date"], rows)
    return [(path, "csv", "kaggle")], 100_000


def _all_null_stars(d: Path):
    rows = [["N0", "", "no stars on this one", "2015-01-01"],
            ["N0", "NA", "no stars again here", "2015-02-01"],
            ["N1", "4", "a starred review here", ""],
            ["N1", "2", "another starred review", ""],
            ["N2", "3", "has stars and dates ok", "2015-03-01"]]
    path = d / "nulls.csv"
    _write_csv(path, ["asin", "overall", "reviewText", "review_date"], rows)
    return [(path, "csv", "kaggle")], 100_000


def _spam(d: Path):
    texts = ["visit https://deals.example.com now", "check www.example.com for more",
             "use code SAVE20 at checkout", "I got a COUPON in the box", "sponsored review text",
             "this is soooooooooo good", "!!!!!!!!!! amazing product", "a normal honest review",
             "a normal honest review", "A  Normal   honest REVIEW", "affiliate link below"]
    rows = [{"asin": f"P{i % 2}", "overall": 1 + i % 5, "reviewText": t}
            for i, t in enumerate(texts)]
    path = d / "spam.jsonl"
    _write_jsonl(path, rows)
    return [(path, "jsonl", "snap")], 100_000


def random_dumps(d: Path, seed: int, n: int = 400, n_skus: int = 40, chunksize: int = 64):
    """A seeded dump pair: a SNAP-shaped JSONL and a customer-reviews CSV
    with Zipf reviews per sku, digit ASINs with leading zeros, null and
    half stars, mixed date formats, short texts, spam, repeats across the
    two files."""
    rng = np.random.default_rng(seed)
    skus = [f"{int(rng.integers(0, 10**9)):010d}" if k % 4 == 0 else f"B0{k:07d}X"
            for k in range(n_skus)]
    p = 1.0 / np.arange(1, n_skus + 1) ** 1.1
    pick = rng.choice(n_skus, n, p=p / p.sum())
    texts = _texts(rng, n, lo=1, hi=40)
    spam = ["see https://x.example", "promo code A1B2", "wowwwwwwwww"]
    jrows, crows = [], []
    for i in range(n):
        text = texts[i] if i % 23 else spam[i % 3] + " " + texts[i]
        star = int(rng.integers(1, 6))
        unix = int(1_200_000_000 + rng.integers(0, 300_000_000))
        if i % 2:
            jrows.append({"asin": skus[pick[i]], "overall": None if i % 17 == 0 else float(star),
                          "reviewText": text, "unixReviewTime": None if i % 19 == 0 else unix,
                          "reviewTime": "09 13, 2009", "reviewerID": f"R{i}", "verified": True})
        else:
            date = ["2015-08-31", "09 13, 2009", "March 5, 2011", "", "2014-02-03T04:05:06Z"][i % 5]
            crows.append(["US", f"C{i}", skus[pick[i]], "" if i % 13 == 0 else
                          (f"{star}.5" if i % 29 == 0 else str(star)), text, date])
    dup = [r for r in jrows[:5]]  # the first JSON reviews again, in the CSV's shape
    crows += [["US", "C-dup", r["asin"], "" if r["overall"] is None else str(int(r["overall"])),
               r["reviewText"], ""] for r in dup]
    jpath, cpath = d / f"snap_{seed}.jsonl", d / f"us_{seed}.csv"
    _write_jsonl(jpath, jrows + dup)
    _write_csv(cpath, ["marketplace", "customer_id", "product_id", "star_rating", "review_body",
                       "review_date"], crows)
    return [(jpath, "jsonl", "snap"), (cpath, "csv", "kaggle")], chunksize


CASES = ([f"alias-{c}-{a}" for c, names in ALIASES.items() for a in names]
         + ["leading_zero_alone", "leading_zero_nulls", "int_stars_nulls", "float_stars_nulls",
            "half_stars"] + [f"dates-{f}" for f in DATES]
         + ["na_strings", "text_edges", "chunk_boundaries", "top80_and_cap", "ties",
            "all_null_stars", "spam"] + [f"random-{s}" for s in range(4)])
FULL_PIPELINE_CASES = ["random-0", "random-1", "top80_and_cap", "text_edges"]


def write_case(name: str, d) -> tuple:
    """(inputs, chunksize) of case `name`, its files written under `d`."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    kind, _, arg = name.partition("-")
    if kind == "alias":
        canon, _, alias = arg.partition("-")
        return _alias(d, canon, alias)
    if kind == "dates":
        return _dates(d, arg)
    if kind == "random":
        return random_dumps(d, int(arg))
    if name == "int_stars_nulls":
        return _stars(d, ["1", "", "5", "NA", "3", "null", "2", "4"], name)
    if name == "float_stars_nulls":
        return _stars(d, ["4.5", "", "2.5", "0.4", "7", "3.5", "N/A", "1e0", " 4 ", "inf"], name)
    return {"leading_zero_alone": _leading_zero_alone, "leading_zero_nulls": _leading_zero_nulls,
            "half_stars": _half_stars, "na_strings": _na_strings, "text_edges": _text_edges,
            "chunk_boundaries": _chunk_boundaries, "top80_and_cap": _top80_and_cap,
            "ties": _ties, "all_null_stars": _all_null_stars, "spam": _spam}[name](d)
