"""Topic naming and aspect metrics over clustered reviews, on the host.

Counterpart of `review_recommender_tpu/topics/naming.py`: TF-IDF terms
per topic (`tfidf_topic_terms` :29), names of the top three terms
(`name_topics` :68), LLM naming with a resume cache and retries
(`name_topics_llm` :74), the rule-based aspect taxonomy
(`map_label_to_aspect` :120), LLM aspect votes (`classify_aspects_llm`
:128) and per-aspect review counts, mean stars and lost rating
(`aspect_metrics` :169).

`tfidf_topic_terms` gives the JAX function's terms bit for bit without
its dense (reviews x vocabulary) f64 matrix, which at 300,000 reviews
takes gigabytes: document frequencies come from the sparse counts, and
each topic's rows are made dense on their own, in the same order and
with the same f32 x f64 products, so `mean(axis=0)` sums the same values
in the same order. Tokens come from the port's `utils/text.py:
tokenize_document`.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from review_recommender_tpu_torch.utils.text import tokenize_document

logger = logging.getLogger(__name__)


def tfidf_topic_terms(texts: Sequence[str], topic_ids: Sequence[int], top_terms: int = 8,
                      min_df: int = 2) -> Dict[int, List[str]]:
    """Per-topic mean TF-IDF top terms over a shared vocabulary (terms in
    at least `min_df` texts), best first; a term of zero mean is left out."""
    vocab: Dict[str, int] = {}
    rows, cols, vals = [], [], []
    for i, text in enumerate(texts):
        freqs: Dict[str, int] = {}
        for t in tokenize_document(text):
            freqs[t] = freqs.get(t, 0) + 1
        for term, c in freqs.items():
            rows.append(i)
            cols.append(vocab.setdefault(term, len(vocab)))
            vals.append(c)
    n, v = len(texts), len(vocab)
    if v == 0:
        return {int(t): [] for t in set(topic_ids)}
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    df = np.bincount(cols, minlength=v)  # one entry per (text, term)
    keep = df >= min_df
    idf = np.log((1 + n) / (1 + df)) + 1.0

    inv = {j: t for t, j in vocab.items()}
    out: Dict[int, List[str]] = {}
    tids = np.asarray(topic_ids)
    for t in np.unique(tids):
        in_topic = tids == t
        rank = np.cumsum(in_topic) - 1  # a text's row among the topic's
        e = in_topic[rows]
        tfm = np.zeros((int(in_topic.sum()), v), np.float32)
        tfm[rank[rows[e]], cols[e]] = vals[e]
        mean = (tfm * idf[None, :] * keep[None, :]).mean(axis=0)
        top = np.argsort(-mean, kind="stable")[:top_terms]
        out[int(t)] = [inv[j] for j in top if mean[j] > 0]
    return out


def name_topics(topic_terms: Dict[int, List[str]]) -> Dict[int, str]:
    """label = the top three TF-IDF terms joined."""
    return {t: " ".join(terms[:3]) if terms else f"topic {t}" for t, terms in topic_terms.items()}


def name_topics_llm(topic_terms: Dict[int, List[str]], labeler: Callable[[List[str]], str],
                    cache_path: Optional[str | Path] = None, retries: int = 3) -> Dict[int, str]:
    """Labels from `labeler(terms)` (an LLM client, typically), resumed from
    and written to a JSON cache keyed by topic id, `retries` tries each,
    the top three terms when every try fails."""
    cache: Dict[str, str] = {}
    if cache_path and Path(cache_path).exists():
        cache = json.loads(Path(cache_path).read_text())
    out: Dict[int, str] = {}
    for t, terms in sorted(topic_terms.items()):
        key = str(t)
        if key in cache:
            out[t] = cache[key]
            continue
        label = None
        for attempt in range(retries):
            try:
                label = str(labeler(terms)).strip()
                break
            except Exception as e:  # any labeler failure is retried, then falls back
                logger.warning("labeler failed for topic %d (try %d): %s", t, attempt + 1, e)
        out[t] = label or " ".join(terms[:3])
        cache[key] = out[t]
        if cache_path:
            Path(cache_path).write_text(json.dumps(cache, indent=0))
    return out


# the rule-based eight-aspect taxonomy
ASPECT_RULES: Dict[str, List[str]] = {
    "quality": ["quality", "durable", "sturdy", "cheap", "broke", "broken", "defect", "flimsy"],
    "comfort": ["comfort", "comfortable", "soft", "fit", "fits", "cozy"],
    "sound": ["sound", "audio", "bass", "noise", "volume"],
    "battery": ["battery", "charge", "charging", "power"],
    "shipping": ["shipping", "delivery", "arrived", "package", "packaging"],
    "price": ["price", "value", "worth", "expensive", "cost"],
    "appearance": ["color", "design", "look", "looks", "style", "pattern"],
    "usability": ["easy", "setup", "install", "instructions", "use"],
}


def map_label_to_aspect(label: str) -> str:
    low = str(label).lower()
    for aspect, words in ASPECT_RULES.items():
        if any(w in low for w in words):
            return aspect
    return "other"


def classify_aspects_llm(topics: Dict[int, dict], voter: Callable[[dict], str], votes: int = 3,
                         cache_path: Optional[str | Path] = None,
                         taxonomy: Optional[Sequence[str]] = None) -> Dict[int, str]:
    """Aspect of each topic ({"label", "quotes"}) by a majority of `votes`
    calls of `voter(topic)`, resumed from a JSON cache; answers outside the
    taxonomy do not count, and a topic with no valid vote takes the rule
    mapping of its label."""
    taxonomy = list(taxonomy or list(ASPECT_RULES) + ["other"])
    cache: Dict[str, str] = {}
    if cache_path and Path(cache_path).exists():
        cache = json.loads(Path(cache_path).read_text())
    out: Dict[int, str] = {}
    for t, topic in sorted(topics.items()):
        key = str(t)
        if key in cache:
            out[t] = cache[key]
            continue
        tally: Dict[str, int] = {}
        for _ in range(votes):
            try:
                a = str(voter(dict(topic))).strip().lower()
            except Exception as e:  # a failed vote is skipped, as a non-answer
                logger.warning("aspect voter failed for topic %d: %s", t, e)
                continue
            if a in taxonomy:
                tally[a] = tally.get(a, 0) + 1
        if tally:
            out[t] = max(tally.items(), key=lambda kv: kv[1])[0]
        else:
            out[t] = map_label_to_aspect(topic.get("label", ""))
        cache[key] = out[t]
        if cache_path:
            Path(cache_path).write_text(json.dumps(cache, indent=0))
    return out


def aspect_metrics(topic_ids: Sequence[int], stars: Sequence[float], labels: Dict[int, str],
                   aspects: Optional[Dict[int, str]] = None) -> List[dict]:
    """Per aspect: reviews, mean stars (NaN stars left out) and the
    lost-rating proxy reviews x (5 - mean stars), sorted by lost rating.
    `aspects` overrides a topic's rule-based aspect (LLM answers)."""
    tids = np.asarray(topic_ids)
    st = np.asarray(stars, np.float64)
    by_aspect: Dict[str, list] = {}
    for t, label in labels.items():
        mask = tids == t
        if not mask.any():
            continue
        aspect = (aspects or {}).get(t) or map_label_to_aspect(label)
        by_aspect.setdefault(aspect, []).append(mask)
    out = []
    for aspect, masks in by_aspect.items():
        m = np.logical_or.reduce(masks)
        s = st[m]
        s = s[~np.isnan(s)]
        avg = float(s.mean()) if len(s) else float("nan")
        n = int(m.sum())
        out.append({
            "aspect": aspect,
            "n_reviews": n,
            "avg_stars": round(avg, 3) if s.size else None,
            "lost_rating": round(n * (5.0 - avg), 1) if s.size else 0.0,
        })
    return sorted(out, key=lambda r: -(r["lost_rating"] or 0))
