"""IR quality metrics: DCG/nDCG@k, MRR, Recall@k, Precision@k, the
per-query accumulator and the sweep of ranking methods.

A pandas-free copy of `review_recommender_tpu/evals/metrics.py:19-152`:
the same DCG (rel / log2(rank + 1) over 1-indexed ranks), the same ideal
DCG from the full judgment set in IRMetrics, and `aggregate_metrics` with
the same keys (numpy means over the per-query rows, `n_queries`). Where the
JAX package hands back a pandas DataFrame (`detailed_report`, the sweep's
"detail"), the port hands back the list of per-query row dicts that the
DataFrame is built from.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np


def dcg_at_k(relevances: Sequence[float], k: int) -> float:
    """Discounted cumulative gain: sum_i rel_i / log2(i+1), ranks 1-indexed."""
    rel = np.asarray(relevances, dtype=np.float64)[: int(k)]
    if rel.size == 0:
        return 0.0
    discounts = np.log2(np.arange(2, rel.size + 2))
    return float(np.sum(rel / discounts))


def ndcg_at_k(relevances: Sequence[float], k: int,
              ideal_relevances: Sequence[float] | None = None) -> float:
    """DCG@k / ideal DCG@k (0 when there is no relevance). Without
    `ideal_relevances` the ideal ranking is the retrieved relevances
    sorted; IRMetrics passes the full judgment set's."""
    ideal = sorted(relevances if ideal_relevances is None else ideal_relevances, reverse=True)
    best = dcg_at_k(ideal, k)
    if best <= 0.0:
        return 0.0
    return dcg_at_k(relevances, k) / best


def mrr_score(ranked_ids: Sequence[str], relevant: set, k: int | None = None) -> float:
    """Reciprocal rank of the first relevant item (0 if none in top-k)."""
    ids = list(ranked_ids)[: int(k)] if k is not None else list(ranked_ids)
    for i, rid in enumerate(ids, start=1):
        if rid in relevant:
            return 1.0 / i
    return 0.0


def recall_at_k(ranked_ids: Sequence[str], relevant: set, k: int) -> float:
    if not relevant:
        return 0.0
    hits = sum(1 for rid in list(ranked_ids)[: int(k)] if rid in relevant)
    return hits / len(relevant)


def precision_at_k(ranked_ids: Sequence[str], relevant: set, k: int) -> float:
    if k <= 0:
        return 0.0
    top = list(ranked_ids)[: int(k)]
    if not top:
        return 0.0
    hits = sum(1 for rid in top if rid in relevant)
    return hits / len(top)


class IRMetrics:
    """Per-query metric accumulator with an aggregate."""

    def __init__(self, k_values: Sequence[int] = (5, 10, 20)):
        self.k_values = tuple(int(k) for k in k_values)
        self.rows: List[Dict] = []

    def evaluate_query(self, query_id: str, ranked_ids: Sequence[str],
                       relevant: set) -> Dict[str, float]:
        rels = [1.0 if rid in relevant else 0.0 for rid in ranked_ids]
        # ideal DCG from the FULL relevant set: a relevant item the engine
        # did not retrieve still counts against the ideal
        ideal = [1.0] * len(relevant)
        row: Dict[str, float] = {"query_id": query_id}
        for k in self.k_values:
            row[f"ndcg@{k}"] = ndcg_at_k(rels, k, ideal_relevances=ideal)
            row[f"recall@{k}"] = recall_at_k(ranked_ids, relevant, k)
            row[f"precision@{k}"] = precision_at_k(ranked_ids, relevant, k)
        row["mrr"] = mrr_score(ranked_ids, relevant)
        self.rows.append(row)
        return row

    def aggregate_metrics(self) -> Dict[str, float]:
        """Mean of each metric over the queries, and `n_queries`."""
        if not self.rows:
            return {}
        out = {col: float(np.mean([r[col] for r in self.rows]))
               for col in self.rows[0] if col != "query_id"}
        out["n_queries"] = len(self.rows)
        return out

    def detailed_report(self) -> List[Dict]:
        """The per-query rows, one dict each (the JAX package's DataFrame
        rows)."""
        return [dict(r) for r in self.rows]

    def reset(self) -> None:
        self.rows = []


def evaluate_ranking_methods(
    search_fn: Callable[..., Sequence[str]],
    queries: Sequence[Mapping],
    method_configs: Mapping[str, Mapping],
    k_values: Sequence[int] = (5, 10, 20),
) -> Dict[str, Dict]:
    """Sweep method configs x queries: {method: {"aggregate": the means,
    "detail": the per-query rows}}. search_fn(query_text, **config) returns
    ranked ids, a tuple whose first item is them, or the port's search rows
    (dicts with a "sku" key, as `run_search` returns). Each query mapping
    needs "query" and "relevant_skus"; "id" names it (the query text
    otherwise)."""
    results: Dict[str, Dict] = {}
    for method, cfg in method_configs.items():
        metrics = IRMetrics(k_values)
        for q in queries:
            ranked = search_fn(q["query"], **dict(cfg))
            if isinstance(ranked, tuple):
                ranked = ranked[0]
            ranked = [r["sku"] if isinstance(r, Mapping) else r for r in ranked]
            metrics.evaluate_query(q.get("id", q["query"]), ranked, set(q["relevant_skus"]))
        results[method] = {"aggregate": metrics.aggregate_metrics(),
                           "detail": metrics.detailed_report()}
    return results
