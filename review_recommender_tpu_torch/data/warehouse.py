"""Reviews warehouse: the bronze-table layer over merged reviews.

Counterpart of `review_recommender_tpu/data/warehouse.py`'s `Warehouse`,
over the numpy form (`reviews_raw.npz`: text columns as UTF-8 bytes with
offsets and a null mask, stars as float64 with NaN) and column tables
instead of parquet and DataFrames, with the same surface:

  make_warehouse(path).load(table)  idempotent load, first writer wins on id
  .read(columns)                    the stored columns
  .star_distribution()              v_star_dist: reviews per star value
  .source_breakdown()               v_source_breakdown: reviews per source
  .attach_skus(table, on="id")      the archive's sku back-join (left join)

The JAX package's `DuckWarehouse` (DuckDB-backed, chosen by its
`make_warehouse` when duckdb imports) is not ported: no machine the port
is tested on has duckdb (ROADMAP, "Not ported"). The port's
`make_warehouse` returns `Warehouse` whether or not duckdb imports.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from review_recommender_tpu_torch.data.etl import (
    concat_tables,
    dedup_ids,
    is_missing,
    n_rows,
    take_rows,
)
from review_recommender_tpu_torch.data.pipeline import read_table, write_numpy_form

logger = logging.getLogger(__name__)


def _import_duckdb():
    try:
        import duckdb  # noqa: PLC0415 — optional dependency

        return duckdb
    except Exception:  # noqa: BLE001 — missing/broken install both mean "no"
        return None


def duckdb_available() -> bool:
    return _import_duckdb() is not None


def make_warehouse(root) -> "Warehouse":
    """The numpy-form store. The JAX factory returns its DuckDB store where
    duckdb imports; that store is not ported (module docstring)."""
    if duckdb_available():
        logger.info("duckdb imports, but the port has no DuckDB warehouse: "
                    "using the numpy-form Warehouse")
    return Warehouse(root)


class Warehouse:
    """Numpy-form bronze store for raw reviews."""

    TABLE = "reviews_raw.npz"

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.path = self.root / self.TABLE

    def load(self, reviews: Dict[str, object]) -> int:
        """Idempotent load: union with the stored rows, unique ids (the
        first writer wins, as the reference's unique index with INSERT OR
        IGNORE). Returns the total row count."""
        if "id" not in reviews:
            raise ValueError("reviews need an 'id' column")
        stored = self.read()
        merged = dedup_ids(concat_tables([stored, reviews]) if stored else dict(reviews))
        tmp = self.path.with_name(self.path.stem + ".tmp.npz")
        write_numpy_form(merged, tmp)
        tmp.replace(self.path)
        logger.info("warehouse now holds %d reviews", n_rows(merged))
        return n_rows(merged)

    def read(self, columns: Optional[List[str]] = None) -> Dict[str, object]:
        """The stored columns (all of them by default); {} before a load."""
        if not self.path.exists():
            return {}
        table = read_table(self.path, columns)
        missing = [c for c in columns or () if c not in table]
        if missing:
            raise KeyError(f"{self.path} has no column {missing}")
        return table

    def star_distribution(self) -> Dict[str, object]:
        """v_star_dist: review count per star value, ascending, the null
        stars a group of their own, last."""
        table = self.read(columns=["stars"])
        if not table:
            return {"stars": np.zeros(0), "n": np.zeros(0, np.int64)}
        stars = np.asarray(table["stars"], np.float64)
        values, counts = np.unique(stars[~np.isnan(stars)], return_counts=True)
        nulls = int(np.isnan(stars).sum())
        if nulls:
            values, counts = np.append(values, np.nan), np.append(counts, nulls)
        return {"stars": values, "n": counts.astype(np.int64)}

    def source_breakdown(self) -> Dict[str, object]:
        """v_source_breakdown: review count per ingest source, largest
        first, ties in source order."""
        table = self.read(columns=["source"])
        if not table:
            return {"source": [], "n": np.zeros(0, np.int64)}
        counts: Dict[str, int] = {}
        for s in table["source"]:
            if s is not None:
                counts[s] = counts.get(s, 0) + 1
        order = sorted(counts, key=lambda s: (-counts[s], s))
        return {"source": order, "n": np.asarray([counts[s] for s in order], np.int64)}

    def attach_skus(self, table: Dict[str, object], on: str = "id") -> Dict[str, object]:
        """Join `sku` onto rows that only carry review ids (archive 12a):
        `merge(how="left")`, each row once per stored match in stored
        order, once with a null sku where none matches; the column is
        "sku_wh" when the table has a "sku" already."""
        raw = self.read(columns=[on, "sku"])
        matches: Dict[object, List[int]] = {}
        for j, key in enumerate(raw.get(on, [])):
            matches.setdefault(None if is_missing(key) else key, []).append(j)
        keys = table[on].tolist() if isinstance(table[on], np.ndarray) else table[on]
        rows, skus = [], []
        for i, key in enumerate(keys):
            hits = matches.get(None if is_missing(key) else key)
            for j in hits or [None]:
                rows.append(i)
                skus.append(None if j is None else raw["sku"][j])
        out = take_rows(table, rows)
        if on != "sku":
            out["sku_wh" if "sku" in table else "sku"] = skus
        return out
