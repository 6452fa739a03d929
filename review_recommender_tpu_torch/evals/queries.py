"""Benchmark query suite: the four method configs, the hand-written query
templates, ground-truth coverage, synthetic judgments.

A copy of `review_recommender_tpu/evals/queries.py` (pure Python and
numpy, so one seed gives the same synthetic judgments in both packages).
`synthetic_ground_truth` samples products and builds each query from its
anchor product's own text, so the anchor is relevant by construction.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence

import numpy as np

# Hand-written query templates: text + category + attributes the gate should
# pick up. Relevance sets are filled per-index (see attach_ground_truth).
TEST_QUERIES: List[Dict] = [
    {"id": "q01", "query": "wireless bluetooth headphones with noise cancelling",
     "category": "electronics", "expected_attributes": ["wireless", "noise"]},
    {"id": "q02", "query": "yellow socks with cat design",
     "category": "apparel", "expected_attributes": ["yellow", "cat", "sock"]},
    {"id": "q03", "query": "mechanical gaming keyboard rgb backlit",
     "category": "electronics", "expected_attributes": ["keyboard"]},
    {"id": "q04", "query": "stainless steel kitchen knife set",
     "category": "kitchen", "expected_attributes": []},
    {"id": "q05", "query": "comfortable running shoes lightweight",
     "category": "sports", "expected_attributes": []},
    {"id": "q06", "query": "usb c fast charging cable durable",
     "category": "electronics", "expected_attributes": []},
    {"id": "q07", "query": "red leather wallet for men",
     "category": "accessories", "expected_attributes": ["red"]},
    {"id": "q08", "query": "waterproof phone case shockproof",
     "category": "electronics", "expected_attributes": []},
    {"id": "q09", "query": "organic green tea loose leaf",
     "category": "grocery", "expected_attributes": ["green"]},
    {"id": "q10", "query": "dog toys for puppies durable chew",
     "category": "pets", "expected_attributes": ["dog"]},
]

# The four reference benchmark methods (weights per evals/test_queries.py:
# 255-312): dense-only, bm25-only, hybrid fusion, hybrid + cross-encoder.
BENCHMARK_CONFIGS: Dict[str, Dict] = {
    "Dense Only": dict(k=20, rerank_k=0, w_dense=1.0, w_bm25=0.0,
                       w_rerank=0.0, w_prior=0.0, w_best=0.0),
    "BM25 Only": dict(k=20, rerank_k=0, w_dense=0.0, w_bm25=1.0,
                      w_rerank=0.0, w_prior=0.0, w_best=0.0),
    "Hybrid": dict(k=20, rerank_k=0, w_dense=0.55, w_bm25=0.25,
                   w_rerank=0.0, w_prior=0.20, w_best=0.0),
    "Hybrid + Rerank": dict(k=20, rerank_k=50, w_dense=0.45, w_bm25=0.20,
                            w_rerank=0.25, w_prior=0.10, w_best=0.0),
}

_WORD = re.compile(r"[a-z]{4,}")


def validate_ground_truth(
    queries: Sequence[Mapping], available_skus: Sequence[str]
) -> Dict:
    """Coverage check: how many judged SKUs exist in the index."""
    have = set(available_skus)
    total, found = 0, 0
    missing: List[str] = []
    for q in queries:
        for sku in q.get("relevant_skus", []):
            total += 1
            if sku in have:
                found += 1
            else:
                missing.append(sku)
    return {
        "total_judged": total,
        "found": found,
        "coverage": (found / total) if total else 0.0,
        "missing": missing[:20],
    }


def synthetic_ground_truth(
    skus: Sequence[str],
    texts: Sequence[str],
    n_queries: int = 10,
    keywords_per_query: int = 4,
    relevant_per_query: int = 1,
    seed: int = 0,
) -> List[Dict]:
    """Sample products and derive a query from their own text.

    Each synthetic query's keywords come from one 'anchor' product; that
    product (plus any others sampled into the same query) forms the relevant
    set — honest by construction, unlike the reference's recycled ASINs.
    """
    rng = np.random.default_rng(seed)
    n = len(skus)
    out: List[Dict] = []
    order = rng.permutation(n)
    qi = 0
    for row in order:
        if qi >= n_queries:
            break
        words = _WORD.findall(str(texts[row]).lower())
        uniq: List[str] = []
        for w in words:
            if w not in uniq:
                uniq.append(w)
        if len(uniq) < keywords_per_query:
            continue
        pick = rng.choice(len(uniq), size=keywords_per_query, replace=False)
        query = " ".join(uniq[i] for i in sorted(pick))
        relevant = {str(skus[row])}
        if relevant_per_query > 1:
            extra = rng.choice(n, size=relevant_per_query - 1, replace=False)
            relevant |= {str(skus[i]) for i in extra}
        out.append({
            "id": f"syn{qi:02d}",
            "query": query,
            "relevant_skus": sorted(relevant),
            "category": "synthetic",
            "expected_attributes": [],
        })
        qi += 1
    return out


def attach_ground_truth(
    queries: Sequence[Mapping],
    judgments: Mapping[str, Sequence[str]],
) -> List[Dict]:
    """Attach relevance sets {query_id: [skus]} to the query templates."""
    out = []
    for q in queries:
        q = dict(q)
        q["relevant_skus"] = list(judgments.get(q["id"], q.get("relevant_skus", [])))
        out.append(q)
    return out
