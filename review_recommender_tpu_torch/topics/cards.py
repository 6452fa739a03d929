"""Resume-safe topic cards, on the host.

Counterpart of `review_recommender_tpu/topics/cards.py`: the model-free
card (`extractive_card` :23), central deduplicated quotes (`pick_quotes`
:34), card generation that appends each new card to a JSONL file and
skips topics the file already holds (`generate_topic_cards` :63), and
the generator throughput estimate (`benchmark_generator` :119).

The JAX `generate_topic_cards` returns a pandas DataFrame (its pace in
the frame's attrs, which no caller reads) and writes a parquet view. The
card's machine has neither pandas nor pyarrow, so the port returns the
same rows as a list of dicts sorted by topic id, and
writes the parquet view (`parquet_out`) only where pyarrow imports,
saying on stderr when it skips it; the JSONL file is the same.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def extractive_card(topic: dict) -> Dict[str, str]:
    """Model-free card: the label as headline, the first two quotes as
    summary."""
    quotes = topic.get("quotes", [])[:2]
    summary = " … ".join(q.strip()[:160] for q in quotes) if quotes else ""
    return {
        "headline": str(topic.get("label", f"topic {topic.get('topic_id')}")),
        "summary": summary,
    }


def pick_quotes(texts: Sequence[str], embeddings: np.ndarray, center: np.ndarray,
                n_quotes: int = 3, max_chars: int = 300) -> List[str]:
    """The topic's texts nearest its center (cosine, stable order), cut to
    `max_chars`, without empty ones or repeats of a 60-character
    lowercase prefix, at most `n_quotes`."""
    if len(texts) == 0:
        return []
    e = np.asarray(embeddings, np.float32)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    c = np.asarray(center, np.float32)
    c = c / max(np.linalg.norm(c), 1e-12)
    order = np.argsort(-(e @ c), kind="stable")
    out, seen = [], set()
    for i in order:
        t = str(texts[i]).strip()[:max_chars]
        key = t[:60].lower()
        if key in seen or not t:
            continue
        seen.add(key)
        out.append(t)
        if len(out) >= n_quotes:
            break
    return out


def parquet_writer(path) -> Optional[Callable[[List[dict]], None]]:
    """A function writing a list of row dicts to `path` as parquet, where
    pyarrow imports; else None, after a line on stderr naming the file
    that is not written."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        print(f"pyarrow is not installed: {path} is not written (its rows are in the JSON "
              "outputs)", file=sys.stderr)
        return None
    return lambda rows: pq.write_table(pa.Table.from_pylist(rows), str(path))


def generate_topic_cards(topics: Sequence[dict], out_jsonl: str | Path,
                         generator: Optional[Callable[[dict], Dict[str, str]]] = None,
                         flush_every: int = 8,
                         parquet_out: Optional[str | Path] = None) -> List[dict]:
    """Cards for `topics` (topic_id, label, quotes, n_reviews), resume-safe:
    a topic the JSONL already holds is skipped, each new card is appended
    and flushed at once, and the parquet view (where pyarrow imports) is
    rebuilt every `flush_every` new cards and at the end. Returns every
    card of the file, sorted by topic id."""
    generator = generator or extractive_card
    out_path = Path(out_jsonl)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    done: Dict[int, dict] = {}
    if out_path.exists():
        for line in out_path.read_text().splitlines():
            if line.strip():
                row = json.loads(line)
                done[int(row["topic_id"])] = row

    write = parquet_writer(parquet_out) if parquet_out is not None else None

    def rebuild() -> List[dict]:
        rows = sorted(done.values(), key=lambda r: r["topic_id"])
        if write is not None and rows:
            write(rows)
        return rows

    n_new = 0
    with open(out_path, "a") as f:
        for topic in topics:
            tid = int(topic["topic_id"])
            if tid in done:
                continue
            card = generator(dict(topic))
            row = {
                "topic_id": tid,
                "label": topic.get("label", ""),
                "n_reviews": int(topic.get("n_reviews", 0)),
                "headline": card.get("headline", ""),
                "summary": card.get("summary", ""),
            }
            f.write(json.dumps(row) + "\n")
            f.flush()
            done[tid] = row
            n_new += 1
            if n_new % flush_every == 0:
                rebuild()

    return rebuild()


def benchmark_generator(topics: Sequence[dict],
                        generator: Optional[Callable[[dict], Dict[str, str]]] = None, *,
                        configs: Optional[Dict[str, dict]] = None, n_topics: int = 8,
                        total_topics: Optional[int] = None) -> Dict[str, dict]:
    """Card-generation throughput without writing anything: `generator`
    timed over the first `n_topics` topics for each knob config ({name:
    {"n_quotes", "max_chars"}}, applied by cutting each topic's quotes),
    with the ETA for `total_topics` (default: all of them). Returns
    {config: {s_per_card, cards_per_s, eta_s_for_total, n_sampled}}."""
    generator = generator or extractive_card
    configs = configs or {"default": {}}
    sample = list(topics)[: max(1, n_topics)]
    if not sample:  # empty topic set: an empty report, not a divide-by-zero
        return {name: {"s_per_card": 0.0, "cards_per_s": 0.0, "eta_s_for_total": 0.0,
                       "n_sampled": 0} for name in configs}
    total = total_topics if total_topics is not None else len(topics)
    report: Dict[str, dict] = {}
    for name, knobs in configs.items():
        nq = int(knobs.get("n_quotes", 0))
        mc = int(knobs.get("max_chars", 0))
        t0 = time.perf_counter()
        for topic in sample:
            t = dict(topic)
            if nq:
                t["quotes"] = list(t.get("quotes", []))[:nq]
            if mc:
                t["quotes"] = [q[:mc] for q in t.get("quotes", [])]
            generator(t)
        pace = (time.perf_counter() - t0) / len(sample)
        report[name] = {
            "s_per_card": round(pace, 4),
            "cards_per_s": round(1.0 / pace, 2) if pace > 0 else float("inf"),
            "eta_s_for_total": round(pace * total, 1),
            "n_sampled": len(sample),
        }
    return report
