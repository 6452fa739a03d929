"""Benchmark runner: index check, method sweep with latency, the README
table, JSON/CSV outputs.

Counterpart of `review_recommender_tpu/evals/benchmark.py` without pandas:
a search function returns the port's result rows (a list of dicts, or the
(rows, snippets, debug) of `run_search`) and the per-query detail is a list
of dicts, written with the `csv` module. `measure_rpc_floor` times a
synchronised scalar round trip on the engine's device instead of a jitted
one. Latencies are host wall-clock around each call, which ends in a
device-to-host copy.
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.evals.metrics import IRMetrics
from review_recommender_tpu_torch.evals.queries import (
    BENCHMARK_CONFIGS,
    synthetic_ground_truth,
    validate_ground_truth,
)


def check_index_availability(bundle) -> Dict:
    """Index-bundle health: doc counts, vocab, review sidecar."""
    p = bundle.products
    return {
        "n_docs": p.n_docs,
        "n_padded": p.n_padded,
        "dim": p.dim,
        "vocab_size": len(p.vocab),
        "has_reviews": bundle.reviews is not None,
        "ok": p.n_docs > 0 and len(p.vocab) > 0,
    }


def measure_rpc_floor(device="cuda", n: int = 15) -> float:
    """Median ms of a trivial device round trip: one scalar add launched
    and read back (the read synchronises). Every per-query latency of this
    module includes it."""
    x = torch.zeros((), device=resolve_device(device))
    float(x + 1.0)  # the first launch is excluded
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        float(x + 1.0)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _skus(ranked) -> list:
    if isinstance(ranked, tuple):  # run_search's (rows, snippets, debug)
        ranked = ranked[0]
    return [r["sku"] if isinstance(r, dict) else r for r in ranked]


def run_performance_benchmark(
    search_fn: Callable,
    queries: Sequence[Mapping],
    method_configs: Optional[Mapping[str, Mapping]] = None,
    k_values: Sequence[int] = (5, 10, 20),
    warmup: bool = False,
    rpc_floor_ms: Optional[float] = None,
) -> Dict[str, Dict]:
    """Sweep methods x queries, recording quality and latency per method.
    warmup=True runs each method once, untimed, before its sweep;
    rpc_floor_ms adds the round-trip floor and p50 less it to each
    latency dict."""
    method_configs = method_configs or BENCHMARK_CONFIGS
    results: Dict[str, Dict] = {}
    for method, cfg in method_configs.items():
        if warmup and queries:
            search_fn(queries[0]["query"], **dict(cfg))
        metrics = IRMetrics(k_values)
        lat: list = []
        for q in queries:
            t0 = time.perf_counter()
            ranked = search_fn(q["query"], **dict(cfg))
            lat.append(time.perf_counter() - t0)
            metrics.evaluate_query(q.get("id", q["query"]), _skus(ranked),
                                   set(q["relevant_skus"]))
        lat_arr = np.asarray(lat)
        latency = {
            "qps": float(1.0 / lat_arr.mean()) if lat_arr.size else 0.0,
            "p50_ms": float(np.percentile(lat_arr, 50) * 1e3),
            "p99_ms": float(np.percentile(lat_arr, 99) * 1e3),
            "mean_ms": float(lat_arr.mean() * 1e3),
        }
        if rpc_floor_ms is not None:
            latency["rpc_floor_ms"] = float(rpc_floor_ms)
            latency["engine_p50_ms"] = max(0.0, latency["p50_ms"] - float(rpc_floor_ms))
        results[method] = {
            "aggregate": metrics.aggregate_metrics(),
            "detail": [dict(r) for r in metrics.rows],
            "latency": latency,
        }
    return results


def format_results_table(results: Mapping[str, Dict],
                         metrics=("ndcg@10", "mrr", "recall@20")) -> str:
    """Markdown README table: metric rows x method columns."""
    methods = list(results)
    lines = ["| Metric | " + " | ".join(methods) + " |",
             "|" + "---|" * (len(methods) + 1)]
    label = {"mrr": "MRR@10"}
    for m in metrics:
        cells = [f"{results[meth]['aggregate'].get(m, float('nan')):.3f}" for meth in methods]
        lines.append(f"| {label.get(m, m.upper())} | " + " | ".join(cells) + " |")
    lats = [results[m]["latency"] for m in methods]
    lines.append("| p50 latency (ms) | " + " | ".join(f"{l['p50_ms']:.1f}" for l in lats) + " |")
    if all("engine_p50_ms" in l for l in lats):
        lines.append("| engine-side p50 (ms, −RTT) | "
                     + " | ".join(f"{l['engine_p50_ms']:.1f}" for l in lats) + " |")
    lines.append("| QPS | " + " | ".join(f"{l['qps']:.1f}" for l in lats) + " |")
    if all("rpc_floor_ms" in l for l in lats):
        lines.append(
            f"\nLatency columns are single-stream request-response and include a "
            f"measured ~{lats[0]['rpc_floor_ms']:.3f} ms host-device round trip per "
            f"query; the engine-side row subtracts it.")
    return "\n".join(lines)


def save_benchmark_results(results: Mapping[str, Dict], out_dir) -> None:
    """benchmark_results.json (aggregate + latency per method),
    detailed_results.csv (one row per method and query) and
    readme_table.md."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    summary = {m: {"aggregate": r["aggregate"], "latency": r["latency"]}
               for m, r in results.items()}
    (out / "benchmark_results.json").write_text(json.dumps(summary, indent=2))
    rows = [{**row, "method": m} for m, r in results.items() for row in r["detail"]]
    with open(out / "detailed_results.csv", "w", newline="", encoding="utf-8") as f:
        if rows:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    (out / "readme_table.md").write_text(format_results_table(results) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run the retrieval benchmark on a bundle")
    ap.add_argument("--index-dir", required=True)
    ap.add_argument("--out-dir", default="build/evals_out")
    ap.add_argument("--synthetic-queries", type=int, default=10,
                    help="generate N synthetic judged queries from the index")
    ap.add_argument("--gate-mode", default="host", choices=["host", "device"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.io import load_bundle
    from review_recommender_tpu_torch.models.encoder import BiEncoder

    bundle = load_bundle(args.index_dir)
    avail = check_index_availability(bundle)
    print(json.dumps({"index": avail}))
    if not avail["ok"]:
        return 1

    encoder = BiEncoder.random_for_dim(bundle.products.dim, device=args.device)
    engine = SearchEngine(bundle, device=args.device, query_encoder=encoder,
                          gate_mode=args.gate_mode)
    p = bundle.products
    queries = synthetic_ground_truth(p.skus, p.agg_texts, n_queries=args.synthetic_queries)
    print(json.dumps({"ground_truth": validate_ground_truth(queries, p.skus)}))
    results = run_performance_benchmark(engine.run_search, queries,
                                        rpc_floor_ms=measure_rpc_floor(args.device))
    save_benchmark_results(results, args.out_dir)
    print(format_results_table(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
