"""Product aggregation: the reviews table -> per-product rows for indexing.

Counterpart of `review_recommender_tpu/data/prep.py`, over the column
tables of data/etl.py instead of DataFrames, with the values the pandas
group-bys give:

- `build_products`: dedup on (sku, normalized text), first wins; one row
  per non-null sku in sorted order (a null sku has no product, as
  `groupby` drops it); n_reviews; avg_stars the mean of the non-null
  stars, NaN when none; last_ts the largest ts string, None when none;
  agg_text the first 4,000 characters of the top 80 texts by stars
  descending (nulls last), then ts-or-"" descending, ties in table order.
- `filter_reviews_for_snippets`: the spam filter, dedup on (sku,
  normalized text), then at most SNIPPET_REVIEWS_CAP reviews per sku,
  newest first (ties in table order), returned in table order. With a cap
  a null-sku review is dropped (its group number is NaN in pandas); with
  the cap off (0) it is kept.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional

import numpy as np

from review_recommender_tpu_torch.data.etl import n_rows, take_rows

logger = logging.getLogger(__name__)

TOP_REVIEWS_PER_SKU = 80
AGG_TEXT_CHAR_CAP = 4000  # matches the embed-time truncation (nlp/11:23,36)
_WS = re.compile(r"\s+")


def normalize_text(s: str) -> str:
    return _WS.sub(" ", str(s)).strip().lower()


def _dedup_sku_text(skus: List[Optional[str]], texts: List[str], rows: List[int]) -> List[int]:
    """The rows whose (sku, normalized text) is new, in order."""
    seen = set()
    keep = []
    for i in rows:
        key = (skus[i], normalize_text(texts[i]))
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return keep


def _groups(skus: List[Optional[str]], rows: List[int]) -> Dict[str, List[int]]:
    """Rows by non-null sku, in table order within each."""
    groups: Dict[str, List[int]] = {}
    for i in rows:
        if skus[i] is not None:
            groups.setdefault(skus[i], []).append(i)
    return groups


def _ts_key(ts: List[Optional[str]], i: int) -> str:
    return ts[i] if ts[i] is not None else ""


def build_products(
    reviews: Dict[str, object],
    top_k: int = TOP_REVIEWS_PER_SKU,
    agg_char_cap: int = AGG_TEXT_CHAR_CAP,
) -> Dict[str, object]:
    """reviews(id, sku, ts, stars, text, ...) -> products(sku, n_reviews,
    avg_stars, last_ts, agg_text)."""
    skus = reviews["sku"]
    texts = [str(t) for t in reviews["text"]]
    ts = reviews["ts"]
    stars = np.asarray(reviews["stars"], np.float64)
    keep = _dedup_sku_text(skus, texts, list(range(n_rows(reviews))))
    groups = _groups(skus, keep)

    out_sku = sorted(groups)
    n_reviews = np.zeros(len(out_sku), np.int64)
    avg_stars = np.full(len(out_sku), np.nan)
    last_ts: List[Optional[str]] = []
    agg_text: List[str] = []
    for j, sku in enumerate(out_sku):
        rows = groups[sku]
        n_reviews[j] = len(rows)
        rated = [stars[i] for i in rows if stars[i] == stars[i]]
        if rated:
            avg_stars[j] = float(sum(rated)) / len(rated)
        stamps = [ts[i] for i in rows if ts[i] is not None]
        last_ts.append(max(stamps) if stamps else None)
        # stable passes, least significant key first: ts desc, then stars
        # desc with the nulls after every star
        ranked = sorted(rows, key=lambda i: _ts_key(ts, i), reverse=True)
        ranked.sort(key=lambda i: -stars[i] if stars[i] == stars[i] else np.inf)
        agg_text.append(" ".join(texts[i] for i in ranked[:top_k])[:agg_char_cap])
    logger.info("aggregated %d reviews -> %d products", n_rows(reviews), len(out_sku))
    return {"sku": out_sku, "n_reviews": n_reviews, "avg_stars": avg_stars,
            "last_ts": last_ts, "agg_text": agg_text}


# ---- review-side filters for the snippet index (nlp/11:39-44 semantics) ----
_URL = re.compile(r"https?://|www\.")
_PROMO = re.compile(
    r"(discount code|use code|coupon|promo code|affiliate|sponsored)", re.I
)
_REPEAT = re.compile(r"(.)\1{7,}")


def looks_spammy(text: str) -> bool:
    t = str(text)
    return bool(_URL.search(t) or _PROMO.search(t) or _REPEAT.search(t))


def filter_reviews_for_snippets(
    reviews: Dict[str, object], per_sku_cap: Optional[int] = None
) -> Dict[str, object]:
    """Spam filter + (sku, text) dedup for the review-embedding job.

    per_sku_cap (default config.SNIPPET_REVIEWS_CAP) bounds reviews kept per
    product, newest first, so the snippet index stays bounded in device
    memory on review-heavy SKUs. 0 disables the cap."""
    if per_sku_cap is None:
        from review_recommender_tpu_torch.config import config

        per_sku_cap = config.SNIPPET_REVIEWS_CAP
    skus = reviews["sku"]
    texts = [str(t) for t in reviews["text"]]
    rows = [i for i in range(n_rows(reviews)) if not looks_spammy(texts[i])]
    keep = _dedup_sku_text(skus, texts, rows)
    if per_sku_cap and per_sku_cap > 0:
        ts = reviews.get("ts") or [None] * n_rows(reviews)
        kept = []
        for group in _groups(skus, keep).values():
            kept += sorted(group, key=lambda i: _ts_key(ts, i), reverse=True)[:per_sku_cap]
        keep = sorted(kept)
    return take_rows(reviews, keep)
