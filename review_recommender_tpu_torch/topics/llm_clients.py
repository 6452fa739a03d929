"""LLM backends for topic naming and aspect votes, on the standard library.

Counterpart of `review_recommender_tpu/topics/llm_clients.py`, which
re-implements the reference's three archived LLM integrations
(nlp/_archive/06_cluster_topics_ollama.py, 06_name_topics_llama.py,
06_name_topics_opnai.py) as two urllib adapters and a dry-run client:

  - OllamaClient: reachability ping (GET /api/tags), model pull (POST
    /api/pull, streamed), strict-JSON generation (POST /api/generate with
    ``format: "json"``, NDJSON chunks reassembled until ``done``);
  - OpenAIChatClient: POST {base}/v1/chat/completions with
    ``response_format: json_object`` (OpenAI, Groq, vLLM and any other
    server of that wire protocol); dry-run without a key on the official
    endpoint only;
  - DryRunClient: labels a topic from its first quote, no network.

All share one retry engine (RetryPolicy: base * 2**attempt + jitter,
Retry-After honoured, 429/5xx retried, other statuses raised, the
reference's fallback JSON once retries run out), and the topic naming on
top: the strict-JSON prompt, defensive parsing, an evidence-hash resume
cache that never stores a non-answer, a prompt character budget and the
aspect voter. The code is the JAX module's, which imports neither jax nor
anything else of its package; the port keeps its own copy.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import re
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

# The reference's 8-aspect taxonomy (06_cluster_topics_ollama.py:21).
ASPECTS = ["Shipping", "Quality", "Sizing", "Packaging", "Service",
           "Pricing", "Usability", "Misc"]

FALLBACK = {"topic_label": "Misc", "aspect": "Misc",
            "rationale": "retry_exhausted"}


class LLMHTTPError(Exception):
    """Non-retryable HTTP failure from an LLM backend."""

    def __init__(self, status: int, body: str = ""):
        super().__init__(f"HTTP {status}: {body[:200]}")
        self.status = status


@dataclass
class RetryPolicy:
    """Backoff schedule shared by every adapter (the archive scripts all
    use base * 2**attempt + jitter, honouring Retry-After when present —
    06_name_topics_llama.py:39-73)."""

    max_retries: int = 8
    base_s: float = 1.5
    transient_s: float = 1.0
    jitter_s: float = 0.7
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def wait_http(self, attempt: int, retry_after: Optional[str]) -> float:
        w = self.base_s * (2 ** attempt) + self.rng.uniform(0, self.jitter_s)
        if retry_after:
            try:
                w = max(w, float(retry_after))
            except ValueError:
                pass
        return w

    def wait_transient(self) -> float:
        return self.transient_s + self.rng.uniform(0, 0.5)


class BaseLLMClient:
    """Retry/backoff engine around a subclass-provided ``_call``.

    ``complete`` returns the model's raw text; HTTP 429/5xx back off
    exponentially, other HTTP statuses raise immediately, network errors
    sleep briefly and retry, and exhausted retries return the reference's
    fallback JSON rather than raising (the pipeline must finish)."""

    def __init__(self, retry: Optional[RetryPolicy] = None,
                 timeout: float = 120.0):
        self.retry = retry or RetryPolicy()
        self.timeout = timeout
        self.calls = 0  # observability: network calls actually made

    def _call(self, prompt: str, system: Optional[str]) -> str:
        raise NotImplementedError

    def complete(self, prompt: str, system: Optional[str] = None) -> str:
        for attempt in range(self.retry.max_retries):
            last = attempt == self.retry.max_retries - 1
            try:
                self.calls += 1
                return self._call(prompt, system)
            except LLMHTTPError as e:
                if e.status == 429 or 500 <= e.status < 600:
                    if last:  # no point sleeping AFTER the final attempt
                        break
                    w = self.retry.wait_http(attempt, getattr(e, "retry_after",
                                                              None))
                    logger.warning("LLM HTTP %d, backoff %.1fs (try %d/%d)",
                                   e.status, w, attempt + 1,
                                   self.retry.max_retries)
                    self.retry.sleep(w)
                    continue
                raise
            except (urllib.error.URLError, OSError, json.JSONDecodeError,
                    KeyError, IndexError) as e:
                if last:
                    break
                w = self.retry.wait_transient()
                logger.warning("LLM transient error: %s -> sleep %.1fs", e, w)
                self.retry.sleep(w)
        return json.dumps(FALLBACK)

    # -- shared HTTP plumbing (stdlib only; in-process fakes in tests) ----
    def _post(self, url: str, payload: dict,
              headers: Optional[dict] = None):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST")
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            err = LLMHTTPError(e.code, e.read().decode("utf-8", "replace"))
            err.retry_after = e.headers.get("Retry-After")
            raise err from None


class OllamaClient(BaseLLMClient):
    """Local Ollama daemon adapter (06_cluster_topics_ollama.py semantics).

    ``ping`` checks reachability via GET /api/tags; ``ensure_model``
    streams POST /api/pull (safe if already present); ``_call`` POSTs
    /api/generate with ``format: "json"`` + ``stream: true`` and
    re-assembles the NDJSON "response" chunks until ``done``."""

    def __init__(self, host: str = "http://localhost:11434",
                 model: str = "qwen2.5:7b", temperature: float = 0.0,
                 **kw):
        super().__init__(**kw)
        self.host = host.rstrip("/")
        self.model = model
        self.temperature = temperature

    def ping(self) -> bool:
        try:
            with urllib.request.urlopen(f"{self.host}/api/tags",
                                        timeout=5) as r:
                return 200 <= r.status < 300
        except (urllib.error.URLError, OSError):
            return False

    def ensure_model(self) -> None:
        try:
            with self._post(f"{self.host}/api/pull",
                            {"name": self.model}) as r:
                for line in r:
                    if not line.strip():
                        continue
                    try:
                        msg = json.loads(line)
                        if "status" in msg:
                            logger.info("[MODEL] %s", msg["status"])
                    except json.JSONDecodeError:
                        pass
        except (LLMHTTPError, urllib.error.URLError, OSError) as e:
            logger.warning("could not auto-pull model %r: %s", self.model, e)

    def _call(self, prompt: str, system: Optional[str]) -> str:
        payload = {
            "model": self.model,
            "prompt": prompt,
            "format": "json",
            "stream": True,
            "options": {"temperature": self.temperature},
        }
        if system:
            payload["system"] = system
        chunks: List[str] = []
        with self._post(f"{self.host}/api/generate", payload) as r:
            for line in r:
                if not line.strip():
                    continue
                data = json.loads(line)
                if "response" in data:
                    chunks.append(data["response"])
                if data.get("done"):
                    break
        return "".join(chunks)


class OpenAIChatClient(BaseLLMClient):
    """OpenAI-wire chat adapter: POST {base}/v1/chat/completions.

    One adapter covers OpenAI, Groq and any other compatible server
    (06_name_topics_llama.py uses the same protocol through the Groq SDK;
    06_name_topics_opnai.py through the OpenAI SDK). Dry-run mode (the
    OpenAI script's default: LLM_DRY_RUN=1 or a missing key) answers
    without touching the network."""

    def __init__(self, base_url: str = "https://api.openai.com",
                 model: str = "gpt-4o-mini", api_key: Optional[str] = None,
                 temperature: float = 0.0,
                 dry_run: Optional[bool] = None,
                 json_mode: bool = True, **kw):
        super().__init__(**kw)
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.temperature = temperature
        # dry_run=None -> auto: dry without a key ONLY for the official
        # endpoint (the OpenAI script's default). A custom base_url means a
        # local/keyless OpenAI-wire server (vLLM, llama.cpp) — contact it
        # for real; a missing-but-required key then fails loudly with 401
        # instead of silently writing dry-run labels.
        if dry_run is None:
            dry_run = not api_key and "api.openai.com" in self.base_url
        self.dry_run = bool(dry_run)
        if self.dry_run:
            logger.warning(
                "OpenAI adapter in DRY-RUN mode (no API key): replies are "
                "canned placeholders, no network calls are made")
        self.json_mode = json_mode

    def _call(self, prompt: str, system: Optional[str]) -> str:
        if self.dry_run:
            return json.dumps({"topic_label": "misc", "aspect": "Misc",
                               "rationale": "dry_run"})
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        payload: dict = {"model": self.model, "messages": messages,
                         "temperature": self.temperature}
        if self.json_mode:
            payload["response_format"] = {"type": "json_object"}
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        with self._post(f"{self.base_url}/v1/chat/completions", payload,
                        headers) as r:
            body = json.loads(r.read())
        return body["choices"][0]["message"]["content"].strip()


class DryRunClient(BaseLLMClient):
    """No-network stand-in: labels a topic from its own evidence (first
    quote's leading words). Lets the full pipeline run end-to-end in CI
    and zero-egress environments."""

    def __init__(self, **kw):
        super().__init__(**kw)

    def _call(self, prompt: str, system: Optional[str]) -> str:
        m = re.search(r'- "([^"\n]+)"', prompt)
        words = (m.group(1).split()[:3] if m else ["misc"])
        return json.dumps({"topic_label": " ".join(words) or "misc",
                           "aspect": "Misc", "rationale": "dry_run"})


def from_spec(spec: str, model: Optional[str] = None,
              **kw) -> BaseLLMClient:
    """Build a client from a CLI/env spec string.

    - ``dry``                          -> DryRunClient
    - ``ollama[:http://host:11434]``   -> OllamaClient (OLLAMA_MODEL env)
    - ``openai[:http://host[:port]]``  -> OpenAIChatClient
      (OPENAI_API_KEY / GROQ_API_KEY env; LLM_DRY_RUN=1 forces dry-run)
    """
    kind, _, url = spec.partition(":")
    kind = kind.strip().lower()
    if kind in ("dry", "none", ""):
        return DryRunClient(**kw)
    if kind == "ollama":
        return OllamaClient(
            host=url or os.getenv("OLLAMA_HOST", "http://localhost:11434"),
            model=model or os.getenv("OLLAMA_MODEL", "qwen2.5:7b"), **kw)
    if kind in ("openai", "groq"):
        key = os.getenv("OPENAI_API_KEY") or os.getenv("GROQ_API_KEY")
        return OpenAIChatClient(
            base_url=url or "https://api.openai.com",
            model=model or os.getenv("LLM_MODEL", "gpt-4o-mini"),
            api_key=key,
            # LLM_DRY_RUN=1 forces dry; otherwise auto (dry only for the
            # official endpoint without a key — an explicit URL is a real,
            # possibly keyless, server)
            dry_run=True if os.getenv("LLM_DRY_RUN", "0") == "1" else None,
            **kw)
    raise ValueError(f"unknown LLM spec {spec!r} "
                     "(expected dry | ollama[:url] | openai[:url])")


# ---------------------------------------------------------------------------
# Topic naming on top of a client: strict-JSON prompt, defensive parsing,
# evidence-hash cache, char budget.

SYSTEM_MSG = (
    "You are a precise classification assistant. "
    "You MUST reply with a single valid JSON object and nothing else. "
    'Keys: "topic_label", "aspect", "rationale". '
    f"Aspect must be one of: {ASPECTS}. Rationale <= 30 words."
)


def build_prompt(quotes: Sequence[str], max_examples: int = 12,
                 max_quote_chars: int = 160) -> str:
    """The archive scripts' evidence prompt: up to N quotes, whitespace
    collapsed, truncated to 160 chars each, strict-JSON instructions."""
    ex = [" ".join(str(q).split())[:max_quote_chars]
          for q in quotes[:max_examples]]
    examples = "\n".join(f'- "{t}"' for t in ex)
    return (
        'Return STRICT JSON with keys EXACTLY: "topic_label", "aspect", '
        f'"rationale".\nASPECT must be one of: {ASPECTS}.\n'
        "Keep rationale <= 30 words. Use only the quotes below.\n\n"
        f"EXAMPLES:\n{examples}\n\n"
        "Output only the JSON object. No backticks, no extra text."
    )


def parse_topic_json(raw: str) -> Dict[str, str]:
    """Defensive normalization of the model reply (all three archive
    scripts): JSON first, then a LABEL: regex fallback, then Misc."""
    meta = None
    s = raw.strip()
    if s.startswith("{"):
        try:
            meta = json.loads(s)
        except json.JSONDecodeError:
            meta = None
    if meta is None:
        m = re.search(r"label\s*[:=]\s*([^\n;]+)", s, re.IGNORECASE)
        label = m.group(1).strip().strip('"')[:40] if m else "Misc"
        return {"topic_label": label or "Misc", "aspect": "Misc",
                "rationale": "parse_fallback"}
    tl = str(meta.get("topic_label") or meta.get("label") or "Misc").strip()
    asp = str(meta.get("aspect", "Misc")).strip()
    if asp not in ASPECTS:
        # case-insensitive salvage before falling back to Misc
        by_low = {a.lower(): a for a in ASPECTS}
        asp = by_low.get(asp.lower(), "Misc")
    return {"topic_label": tl or "Misc", "aspect": asp,
            "rationale": str(meta.get("rationale", "")).strip()[:200]}


def evidence_key(quotes: Sequence[str]) -> str:
    """sha256 over the evidence quotes (06_name_topics_opnai.py:27-31) —
    cache survives topic-id renumbering across re-clustering runs."""
    h = hashlib.sha256()
    for q in quotes:
        h.update(str(q).encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()[:32]


def label_topics(
    client: BaseLLMClient,
    topic_quotes: Dict[int, Sequence[str]],
    cache_path: Optional[str | Path] = None,
    max_examples: int = 12,
    char_budget: Optional[int] = None,
    pacing_s: float = 0.0,
    flush_every: int = 10,
) -> Dict[int, Dict[str, str]]:
    """Name every topic through the client: strict-JSON prompting,
    evidence-hash resume cache with periodic flush, optional prompt char
    budget (the OpenAI script's CHAR_BUDGET guard), optional pacing sleep.

    Returns topic_id -> {"topic_label", "aspect", "rationale"}.
    """
    cache: Dict[str, Dict[str, str]] = {}
    cp = Path(cache_path) if cache_path else None
    if cp and cp.exists():
        try:
            cache = json.loads(cp.read_text())
        except (json.JSONDecodeError, OSError):
            cache = {}

    def flush():
        if cp:
            cp.parent.mkdir(parents=True, exist_ok=True)
            cp.write_text(json.dumps(cache, indent=0))

    out: Dict[int, Dict[str, str]] = {}
    spent = 0
    processed = 0
    for tid in sorted(topic_quotes):
        quotes = list(topic_quotes[tid])
        key = evidence_key(quotes[:max_examples])
        if key in cache:
            out[tid] = dict(cache[key])
            continue
        prompt = build_prompt(quotes, max_examples=max_examples)
        if char_budget is not None and spent + len(prompt) > char_budget:
            meta = {"topic_label": "misc", "aspect": "Misc",
                    "rationale": "char_budget"}
        else:
            raw = client.complete(prompt, system=SYSTEM_MSG)
            spent += len(prompt)
            meta = parse_topic_json(raw)
            if pacing_s:
                time.sleep(pacing_s)
        # non-answers must NOT poison the resume cache: a cached
        # retry_exhausted/char_budget entry would pin the topic at Misc
        # after the backend recovers / the budget is raised; a cached
        # dry_run placeholder would survive into runs WITH a real key; a
        # parse_fallback deserves a fresh attempt next run. They still
        # flow to the caller for this run.
        if meta.get("rationale") not in (
                "retry_exhausted", "char_budget", "dry_run",
                "parse_fallback"):
            cache[key] = meta
        out[tid] = dict(meta)
        processed += 1
        if processed % flush_every == 0:
            flush()
            logger.info("[PROGRESS] labeled %d topics", processed)
    flush()
    return out


def make_aspect_voter(client: BaseLLMClient) -> Callable[[dict], str]:
    """Adapter for topics.naming.classify_aspects_llm: one LLM vote per
    call, answering with a bare aspect from the reference taxonomy
    (07_aspect_ollama.py semantics)."""

    def voter(topic: dict) -> str:
        quotes = topic.get("quotes", [])
        prompt = build_prompt(quotes) + (
            f"\n\nTopic label: {topic.get('label', '')!r}. "
            f'Answer with JSON {{"aspect": "..."}} only.')
        meta = parse_topic_json(client.complete(prompt, system=SYSTEM_MSG))
        return meta["aspect"].lower()

    return voter
