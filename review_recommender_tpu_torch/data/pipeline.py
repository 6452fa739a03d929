"""The offline pipeline: raw reviews -> an index bundle, and a reference
deployment's artifacts -> an index bundle (`rrt import`).

Counterpart of `review_recommender_tpu/data/pipeline.py`:
`_resolve_doc_terms_cap` :44, the restricted unpickler :54-82,
`build_index_from_reviews` :85, `run_full_pipeline` :142 and
`import_reference_artifacts` :154.

`run_full_pipeline` runs the JAX stages in order, each checkpointed under
`out/_work/`: data/etl.py:normalize_merge (raw CSV / JSONL -> the reviews
table, written as `reviews_merged.npz` in the numpy form below), then
`build_index_from_reviews`: data/prep.py:build_products, the product
embedding job (`product_emb/`), the eager BM25 arrays, the snippet filter
and the review embedding job (`review_emb/`), and save_bundle. Where JAX
hands pandas values to the builder, the port hands the values they become
there: a product with no timestamp gets last_ts "nan" (str of NaN, a fault
of the reference copied and listed in ROADMAP Queue 3). JAX raises on a
null star (pandas' NA reaches float()): a product whose reviews have no
star, or a snippet review without one; the port gives NaN (Queue 3).
Each stage ends with one INFO record of this module's logger (etl,
aggregate, product_encode, build, snippet_filter, review_encode, build,
save) with its rows; the record's `stage` attribute names the stage, so a
handler times the stages from the records' `created`.

The artifacts of a reference data directory (names from config.py, as in
JAX):

  product_emb.npy                  (N, D) float, row-aligned with the meta
  product_emb_meta.parquet         sku, n_reviews, avg_stars[, last_ts, agg_text]
  product_bm25.pkl                 (optional) pickle {skus, corpus: [[tok]], tokenizer}
  reviews_with_embeddings.parquet  (optional) sku, stars, text, embedding (list<float>)

Each path may be local or an fsspec URL (index/io.py:open_artifact). The
pickle is read by an unpickler that admits builtins and a numpy allowlist
only. The two parquet files need pyarrow, which the card's machine lacks:
`python -m review_recommender_tpu_torch.data.pipeline convert SRC DST`,
run where pyarrow imports, writes DST as a copy of the data directory
with each parquet file replaced by its numpy form (the same stem,
`.npz`): text columns as UTF-8 bytes with int64 offsets and a null mask
(`<col>_utf8`, `<col>_offsets`, `<col>_null`, as `product_meta.npz` holds
strings), numeric columns as float64 with NaN for null, the review
embeddings as one (M, D) float32 array. `import_reference_artifacts`
reads either form, by the file's suffix; the CLI takes the numpy form
where both exist.

The JAX import reads the tables with pandas and turns columns into
strings with `astype(str)`, numbers with `to_numeric(errors="coerce")`.
The port gives the same values: under pandas 3 (the version the tests run
with) `astype(str)` leaves a null as NaN, which then becomes the string
"nan" (a null sku, agg_text or last_ts is stored as "nan", and a null
agg_text indexes the term "nan": ROADMAP Queue 3 lists it as a fault of
the reference, and the port copies it). Other values become str() of
their pyarrow value, an integer column with nulls first turned to floats
as pandas does; n_reviews nulls become 0 and other numeric nulls NaN.
"""
from __future__ import annotations

import argparse
import json
import logging
import pickle
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from review_recommender_tpu_torch.data.embed_job import run_embed_job
from review_recommender_tpu_torch.data.etl import normalize_merge
from review_recommender_tpu_torch.data.prep import build_products, filter_reviews_for_snippets
from review_recommender_tpu_torch.index.build import (
    attach_eager_bm25,
    build_product_index,
    build_review_index,
)
from review_recommender_tpu_torch.index.io import (
    artifact_exists,
    join_path,
    open_artifact,
    pack_nullable_strings,
    read_parquet,
    save_bundle,
    unpack_nullable_strings,
)
from review_recommender_tpu_torch.index.schema import IndexBundle

logger = logging.getLogger(__name__)

NUMERIC_COLUMNS = ("n_reviews", "avg_stars", "stars")
META_COLUMNS = ("sku", "n_reviews", "avg_stars", "last_ts", "agg_text")
REVIEW_COLUMNS = ("sku", "stars", "text", "embedding")


def numpy_form(name: str) -> str:
    """The file name of a parquet artifact's numpy form (stem + .npz)."""
    return name[: -len(".parquet")] + ".npz" if name.endswith(".parquet") else name


def _resolve_doc_terms_cap(cap):
    """None -> config.DOC_TERMS_CAP; 0 -> "auto" (derive_doc_terms_cap)."""
    if cap is None:
        from review_recommender_tpu_torch.config import config

        cap = config.DOC_TERMS_CAP
    return cap if cap else "auto"


# the globals a product_bm25.pkl ({skus, corpus, tokenizer} of builtins,
# numpy scalars or arrays for skus) may name; unpickling any other global
# could run code, so it is refused
_PICKLE_ALLOWED = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    """product_bm25.pkl's unpickler: builtins and the numpy allowlist only;
    any other global raises instead of importing."""

    def find_class(self, module, name):
        if (module, name) in _PICKLE_ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle global {module}.{name}: product_bm25.pkl "
            "should contain only builtins/numpy ({skus, corpus, tokenizer})"
        )


def _load_bm25_pickle(f) -> dict:
    return _RestrictedUnpickler(f).load()


def _text_values(column) -> list:
    """A pyarrow column's values as str, None for null (an integer column
    with nulls as floats first, as pandas reads it)."""
    import pyarrow as pa

    values = column.to_pylist()
    if pa.types.is_integer(column.type) and column.null_count:
        values = [None if v is None else float(v) for v in values]
    return [None if v is None else str(v) for v in values]


def _float(v) -> float:
    """pd.to_numeric(errors="coerce") of one value."""
    if v is None:
        return float("nan")
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _embedding_rows(column) -> np.ndarray:
    """A list<float> column as one (M, D) float32 array."""
    import pyarrow.compute as pc

    m = len(column)
    lengths = pc.list_value_length(column).to_numpy(zero_copy_only=False) if m else np.zeros(0)
    if m and (column.null_count or (lengths != lengths[0]).any()):
        raise ValueError("the embedding column has null or ragged rows")
    flat = pc.list_flatten(column).to_numpy(zero_copy_only=False).astype(np.float32)
    return flat.reshape(m, int(lengths[0]) if m else 0)


def _parquet_table(path, columns: Sequence[str]) -> Dict[str, object]:
    """The columns of a reference parquet file: text columns as lists of
    str or None, numeric ones as float64 (NaN for null), the embedding as
    (M, D) float32."""
    table = read_parquet(path, columns, "Rewrite the data directory on a machine with pyarrow: "
                         "python -m review_recommender_tpu_torch.data.pipeline convert SRC DST")
    out: Dict[str, object] = {}
    for c in table.column_names:
        col = table.column(c).combine_chunks()
        if c == "embedding":
            out[c] = _embedding_rows(col)
        elif c in NUMERIC_COLUMNS:
            out[c] = np.asarray([_float(v) for v in col.to_pylist()], np.float64)
        else:
            out[c] = _text_values(col)
    return out


def table_columns(arrs: Dict[str, np.ndarray]) -> List[str]:
    """The column names of a numpy form, in the order they were written."""
    names = []
    for key in arrs:
        if key.endswith("_utf8"):
            names.append(key[: -len("_utf8")])
        elif not any(key.endswith(s) and key[: -len(s)] + "_utf8" in arrs
                     for s in ("_offsets", "_null")):
            names.append(key)
    return names


def _npz_table(path, columns: Optional[Sequence[str]]) -> Dict[str, object]:
    """The same columns (None: all of them) from a table's numpy form."""
    with open_artifact(path) as f, np.load(f) as z:
        arrs = dict(z)
    out: Dict[str, object] = {}
    for c in table_columns(arrs) if columns is None else columns:
        if f"{c}_utf8" in arrs:
            out[c] = unpack_nullable_strings(arrs, c)
        elif c in arrs:
            out[c] = arrs[c]
    return out


def read_table(path, columns: Optional[Sequence[str]]) -> Dict[str, object]:
    """A reference table (parquet, or its numpy form by the .npz suffix;
    columns None reads every column of a numpy form)."""
    return (_npz_table if str(path).endswith(".npz") else _parquet_table)(path, columns)


def write_numpy_form(table: Dict[str, object], path) -> None:
    """A column table as the numpy form at `path`: a list column holds
    str or None (packed as text), an array column is stored as it is."""
    arrs: Dict[str, np.ndarray] = {}
    for c, values in table.items():
        if isinstance(values, np.ndarray):
            arrs[c] = values
        else:
            arrs.update(pack_nullable_strings(c, values))
    np.savez(path, **arrs)


def _str_column(values) -> list:
    """pandas `astype(str).tolist()` then str(): a null becomes "nan"."""
    return ["nan" if v is None else v for v in values]


def _stage_done(stage: str, msg: str, *args) -> None:
    logger.info(f"{stage}: {msg}", *args, extra={"stage": stage})


def _column(table: Dict[str, object], name: str, what: str):
    if name not in table:
        raise KeyError(f"{what} has no {name!r} column")
    return table[name]


def build_index_from_reviews(
    reviews: Dict[str, object],
    encoder,
    out_dir,
    *,
    with_snippets: bool = True,
    work_dir=None,
    doc_terms_cap: Optional[int] = None,  # None -> config.DOC_TERMS_CAP (0 = auto)
    resume: bool = True,
    eager_bm25: bool = True,
) -> IndexBundle:
    """Stages 2-5 on a reviews table (data/etl.py's columns): aggregation,
    the embedding jobs, the bundle built and saved to `out_dir`.

    eager_bm25 bakes per-(term, doc) BM25 contributions into the index
    (BM25S-style): query scoring becomes a masked sum."""
    out = Path(out_dir)
    work = Path(work_dir) if work_dir else out / "_work"
    doc_terms_cap = _resolve_doc_terms_cap(doc_terms_cap)

    products = build_products(reviews)
    _stage_done("aggregate", "%d reviews kept, %d products",
                int(products["n_reviews"].sum()), len(products["sku"]))
    prod_emb = run_embed_job(products["agg_text"], encoder, work / "product_emb",
                             resume=resume)
    _stage_done("product_encode", "%d rows", len(prod_emb))
    pidx = build_product_index(
        products["sku"], products["agg_text"], products["n_reviews"].tolist(),
        products["avg_stars"].tolist(), prod_emb, doc_terms_cap=doc_terms_cap,
        last_ts=_str_column(products["last_ts"]),
    )
    if eager_bm25:
        attach_eager_bm25(pidx)
    _stage_done("build", "product index of %d docs", pidx.n_docs)

    ridx = None
    if with_snippets and len(reviews["id"]):
        snip = filter_reviews_for_snippets(reviews)
        _stage_done("snippet_filter", "%d reviews", len(snip["id"]))
        rev_emb = run_embed_job(snip["text"], encoder, work / "review_emb", resume=resume)
        _stage_done("review_encode", "%d rows", len(rev_emb))
        ridx = build_review_index(_str_column(snip["sku"]), snip["text"],
                                  np.asarray(snip["stars"], np.float64), rev_emb, pidx.skus)
        _stage_done("build", "review index of %d reviews", len(snip["id"]))

    bundle = IndexBundle(products=pidx, reviews=ridx, meta={"built_from": "pipeline"})
    save_bundle(bundle, out)
    _stage_done("save", "%s", out)
    return bundle


def run_full_pipeline(
    inputs: Sequence[tuple],  # (path, "csv"|"jsonl", source_tag)
    encoder,
    out_dir,
    **kwargs,
) -> IndexBundle:
    """Stage 1 (normalize_merge into out/_work/reviews_merged.npz), then
    build_index_from_reviews."""
    out = Path(out_dir)
    reviews = normalize_merge(inputs, out / "_work" / "reviews_merged.npz")
    _stage_done("etl", "%d reviews", len(reviews["id"]))
    return build_index_from_reviews(reviews, encoder, out, **kwargs)


def import_reference_artifacts(emb_npy, meta_parquet, bm25_pkl=None, reviews_parquet=None,
                               out_dir=None, doc_terms_cap: Optional[int] = None) -> IndexBundle:
    """A bundle from reference artifacts (see the module docstring), saved
    to `out_dir` when given. meta_parquet / reviews_parquet may be parquet
    files or their numpy forms. doc_terms_cap: None -> DOC_TERMS_CAP, 0 ->
    auto. With a BM25 pickle the postings come from its token lists (in
    the meta's sku order when its skus differ); else agg_text is
    tokenized."""
    doc_terms_cap = _resolve_doc_terms_cap(doc_terms_cap)
    with open_artifact(emb_npy) as f:
        emb = np.load(f)
    meta = read_table(meta_parquet, META_COLUMNS)
    skus = _str_column(_column(meta, "sku", str(meta_parquet)))
    if len(skus) != emb.shape[0]:
        raise ValueError(f"{len(skus)} meta rows for {emb.shape[0]} embeddings")

    token_lists = None
    if bm25_pkl is not None:
        with open_artifact(bm25_pkl) as f:
            blob = _load_bm25_pickle(f)
        corpus, b_skus = blob.get("corpus"), [str(s) for s in blob.get("skus", [])]
        if b_skus and b_skus != skus:
            by_sku = dict(zip(b_skus, corpus))
            token_lists = [by_sku.get(s, []) for s in skus]
        else:
            token_lists = list(corpus)

    n_reviews = _column(meta, "n_reviews", str(meta_parquet))
    n_reviews = np.where(np.isnan(n_reviews), 0.0, n_reviews)  # fillna(0)
    pidx = build_product_index(
        skus,
        _str_column(meta["agg_text"]) if "agg_text" in meta else [""] * len(skus),
        n_reviews.tolist(),
        _column(meta, "avg_stars", str(meta_parquet)).tolist(),
        emb,
        doc_terms_cap=doc_terms_cap,
        token_lists=token_lists,
        last_ts=_str_column(meta["last_ts"]) if "last_ts" in meta else None,
    )

    ridx = None
    if reviews_parquet is not None:
        rev = read_table(reviews_parquet, REVIEW_COLUMNS)
        what = str(reviews_parquet)
        ridx = build_review_index(
            _str_column(_column(rev, "sku", what)), _str_column(_column(rev, "text", what)),
            _column(rev, "stars", what).tolist(), _column(rev, "embedding", what), pidx.skus,
        )

    bundle = IndexBundle(products=pidx, reviews=ridx, meta={"built_from": "reference_artifacts"})
    if out_dir is not None:
        save_bundle(bundle, out_dir)
    return bundle


def convert(src, dst) -> Path:
    """Copy the reference data directory `src` (local or fsspec) to the
    local `dst`, each parquet artifact rewritten in its numpy form; the
    .npy and .pkl artifacts are copied as they are. Needs pyarrow."""
    from review_recommender_tpu_torch.config import config as c

    out = Path(dst)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, columns in ((c.PRODUCT_META_FILE, META_COLUMNS),
                          (c.REVIEWS_EMB_FILE, REVIEW_COLUMNS)):
        path = join_path(src, name)
        if artifact_exists(path):
            write_numpy_form(_parquet_table(path, columns), out / numpy_form(name))
            written.append(numpy_form(name))
    for name in (c.PRODUCT_EMB_FILE, c.BM25_FILE):
        path = join_path(src, name)
        if artifact_exists(path):
            with open_artifact(path) as f_in, open(out / name, "wb") as f_out:
                shutil.copyfileobj(f_in, f_out)
            written.append(name)
    logger.info("converted %s -> %s: %s", src, out, written)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m review_recommender_tpu_torch.data.pipeline",
                                 description="reference data directory tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cv = sub.add_parser("convert", help="copy a reference data directory with its parquet "
                                        "artifacts in the numpy form (needs pyarrow)")
    cv.add_argument("src", help="local directory or fsspec URL")
    cv.add_argument("dst")
    args = ap.parse_args(argv)
    out = convert(args.src, args.dst)
    print(json.dumps({"converted": str(args.src), "out": str(out),
                      "files": sorted(p.name for p in out.iterdir())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
