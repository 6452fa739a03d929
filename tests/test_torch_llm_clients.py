"""The port's LLM clients (review_recommender_tpu_torch/topics/llm_clients.py)
against the JAX package's, on the cases of tests/test_llm_clients.py.

Each case runs the port's client and the JAX client against the same
in-process fake server on 127.0.0.1 (tests/test_llm_clients.py:
FakeLLMServer, which speaks the Ollama and the OpenAI wire protocols) and
compares what each returned, the requests the server saw, and the waits
each retry policy asked for (no real sleeping; the policies' jitter comes
from the same seeded random.Random). Covered: Ollama ping, pull and the
streamed NDJSON reply cut at `done`; backoff on 5xx and 429 with
Retry-After; retry exhaustion to the fallback JSON; a non-retryable
status raised; the chat protocol and its headers; dry-run only for the
official endpoint; parsing fallbacks; prompts; the evidence-keyed resume
cache, the character budget, non-answers kept out of the cache; the
aspect voter; `from_spec`; the dry client. Nothing leaves the machine.
"""
import json
import random

import pytest

from review_recommender_tpu.topics import llm_clients as J
from review_recommender_tpu.topics import naming as jax_naming
from review_recommender_tpu_torch.topics import llm_clients as T
from review_recommender_tpu_torch.topics import naming as port_naming
from tests.test_llm_clients import FakeLLMServer

PACKAGES = {"jax": (J, jax_naming), "port": (T, port_naming)}


@pytest.fixture
def srv():
    s = FakeLLMServer()
    yield s
    s.close()


def _reset(srv, fail=0, status=500, retry_after=None):
    h = srv.httpd
    h.fail_remaining, h.fail_status, h.retry_after = fail, status, retry_after
    h.hits.clear()
    h.last_request = h.last_headers = None


def _policy(mod, **kw):
    waits = []
    pol = mod.RetryPolicy(sleep=waits.append, rng=random.Random(0), **kw)
    return pol, waits


def _both(srv, run, fail=0, status=500, retry_after=None):
    """run(module, naming) for each package against a freshly reset server:
    {package: (result, hits, last request)}."""
    out = {}
    for name, (mod, naming) in PACKAGES.items():
        _reset(srv, fail, status, retry_after)
        res = run(mod, naming)
        req = dict(srv.httpd.last_request or {})
        out[name] = (res, list(srv.httpd.hits), req)
    return out


def test_module_constants_and_prompts_equal():
    assert T.ASPECTS == J.ASPECTS and T.FALLBACK == J.FALLBACK and T.SYSTEM_MSG == J.SYSTEM_MSG
    quotes = ["  a   b " * 200, "q2", 'quote "with" marks', "x" * 300]
    for kw in ({}, {"max_examples": 1}, {"max_quote_chars": 20}):
        assert T.build_prompt(quotes, **kw) == J.build_prompt(quotes, **kw)
    assert T.evidence_key(quotes) == J.evidence_key(quotes)
    assert T.evidence_key(["a"]) != T.evidence_key(["b"])


@pytest.mark.parametrize("raw", [
    "LABEL: Loose Threads; REASONS: meh", "{not json", "", "   ",
    json.dumps({"topic_label": "x", "aspect": "quality"}),
    json.dumps({"topic_label": "x", "aspect": "Nonsense"}),
    json.dumps({"label": "y", "aspect": "Misc", "rationale": "r" * 999}),
    json.dumps({"topic_label": "", "aspect": "SHIPPING"}),
])
def test_parse_topic_json_matches_jax(raw):
    assert T.parse_topic_json(raw) == J.parse_topic_json(raw)


def test_ollama_ping_pull_and_streamed_reply(srv):
    def run(mod, _naming):
        c = mod.OllamaClient(host=srv.url, model="m1", retry=_policy(mod)[0])
        alive = c.ping()
        c.ensure_model()
        raw = c.complete(mod.build_prompt(["battery died fast"]), system="sys")
        return alive, raw
    out = _both(srv, run)
    assert out["port"] == out["jax"]
    (alive, raw), hits, req = out["port"]
    assert alive and hits == ["/api/pull", "/api/generate"] and "IGNORED" not in raw
    assert req["format"] == "json" and req["options"]["temperature"] == 0.0
    assert req["system"] == "sys" and req["stream"] is True
    assert not T.OllamaClient(host="http://127.0.0.1:1", timeout=0.5).ping()


@pytest.mark.parametrize("fail,status,retry_after,max_retries", [
    (2, 500, None, 8),   # backoff then success
    (99, 503, None, 3),  # exhausted: the fallback JSON
    (1, 429, 7, 8),      # Retry-After honoured
])
def test_retry_schedule_matches_jax(srv, fail, status, retry_after, max_retries):
    for kind in ("ollama", "openai"):
        def run(mod, _naming):
            pol, waits = _policy(mod, max_retries=max_retries)
            c = (mod.OllamaClient(host=srv.url, model="m1", retry=pol) if kind == "ollama"
                 else mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=pol))
            return c.complete("p"), waits, c.calls
        out = _both(srv, run, fail, status, retry_after)
        assert out["port"] == out["jax"], kind
        (raw, waits, calls), hits, _req = out["port"]
        if fail > max_retries:
            assert json.loads(raw) == T.FALLBACK and len(waits) == max_retries - 1
        else:
            assert T.parse_topic_json(raw)["topic_label"] == "battery life"
            assert len(waits) == fail == calls - 1
        if retry_after:
            assert waits[0] >= retry_after
        if len(waits) > 1:
            assert waits[1] > waits[0]


def test_non_retryable_status_raises(srv):
    for mod in (T, J):
        _reset(srv, fail=1, status=400)
        c = mod.OllamaClient(host=srv.url, model="m1", retry=_policy(mod)[0])
        with pytest.raises(mod.LLMHTTPError) as exc:
            c.complete("p")
        assert exc.value.status == 400


def test_no_sleep_after_the_final_failed_attempt():
    for mod in (T, J):
        class Always429(mod.OpenAIChatClient):
            def _call(self, prompt, system, mod=mod):
                raise mod.LLMHTTPError(429)
        pol, waits = _policy(mod, max_retries=3)
        raw = Always429(api_key="k", retry=pol).complete("p")
        assert mod.parse_topic_json(raw)["rationale"] == "retry_exhausted"
        assert len(waits) == 2


def test_chat_protocol_and_headers(srv):
    def run(mod, _naming):
        c = mod.OpenAIChatClient(base_url=srv.url, model="gpt-x", api_key="sk-test",
                                 retry=_policy(mod)[0])
        return c.complete("label this", system="sys"), srv.httpd.last_headers["Authorization"]
    out = _both(srv, run)
    assert out["port"] == out["jax"]
    (raw, auth), hits, req = out["port"]
    assert auth == "Bearer sk-test" and hits == ["/v1/chat/completions"]
    assert req["messages"][0] == {"role": "system", "content": "sys"}
    assert req["response_format"] == {"type": "json_object"} and req["model"] == "gpt-x"


def test_dry_run_only_for_the_official_endpoint(srv):
    for mod in (T, J):
        official = mod.OpenAIChatClient(api_key=None)
        assert official.dry_run
        assert mod.parse_topic_json(official.complete("p"))["rationale"] == "dry_run"
        _reset(srv)
        local = mod.OpenAIChatClient(base_url=srv.url, api_key=None)
        assert not local.dry_run
        local.complete("p")
        assert len(srv.httpd.hits) == 1
        _reset(srv)
        forced = mod.OpenAIChatClient(base_url=srv.url, api_key=None, dry_run=True)
        forced.complete("p")
        assert srv.httpd.hits == []


def test_label_topics_cache_resume_is_evidence_keyed(srv, tmp_path):
    def run(mod, _naming):
        cache = tmp_path / f"{mod.__name__}.json"
        c = mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0])
        first = mod.label_topics(c, {0: ["battery died"], 1: ["socks ripped"]}, cache_path=cache)
        n = len(srv.httpd.hits)
        c2 = mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0])
        again = mod.label_topics(c2, {7: ["battery died"], 9: ["socks ripped"]},
                                 cache_path=cache)
        return first, again, n, len(srv.httpd.hits), json.loads(cache.read_text())
    out = _both(srv, run)
    assert out["port"][0] == out["jax"][0]
    first, again, n, n_after, cache = out["port"][0]
    assert n == n_after == 2 and again[7] == first[0] and len(cache) == 2


def test_char_budget_and_non_answers_stay_out_of_the_cache(srv, tmp_path):
    def run(mod, _naming):
        c = mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0])
        budget = mod.label_topics(c, {0: ["q" * 50], 1: ["r" * 50]}, char_budget=1)
        hits_budget = len(srv.httpd.hits)
        cache = tmp_path / f"{mod.__name__}.json"
        srv.httpd.fail_remaining = 99
        down = mod.label_topics(
            mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0]),
            {0: ["battery died"]}, cache_path=cache)
        srv.httpd.fail_remaining = 0
        up = mod.label_topics(
            mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0]),
            {0: ["battery died"]}, cache_path=cache)
        n = len(srv.httpd.hits)
        cached = mod.label_topics(
            mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0]),
            {0: ["battery died"]}, cache_path=cache)
        return budget, hits_budget, down, up, cached, len(srv.httpd.hits) - n
    out = _both(srv, run)
    assert out["port"][0] == out["jax"][0]
    budget, hits_budget, down, up, cached, new_hits = out["port"][0]
    assert hits_budget == 0 and budget[0]["rationale"] == "char_budget"
    assert down[0]["rationale"] == "retry_exhausted" and up[0]["rationale"] != "retry_exhausted"
    assert cached == up and new_hits == 0


def test_aspect_voter_plugs_into_classify(srv):
    def run(mod, naming):
        c = mod.OpenAIChatClient(base_url=srv.url, api_key="k", retry=_policy(mod)[0])
        return naming.classify_aspects_llm(
            {0: {"label": "battery", "quotes": ["died fast"]}, 1: {"label": "cheap price"}},
            mod.make_aspect_voter(c), votes=3)
    out = _both(srv, run)
    assert out["port"] == out["jax"]
    assert out["port"][0] == {0: "quality", 1: "quality"} and len(out["port"][1]) == 6


def test_from_spec_and_dry_client(monkeypatch):
    monkeypatch.delenv("LLM_DRY_RUN", raising=False)
    for mod in (T, J):
        assert isinstance(mod.from_spec("dry"), mod.DryRunClient)
        c = mod.from_spec("ollama:http://h:1", model="m")
        assert isinstance(c, mod.OllamaClient) and (c.host, c.model) == ("http://h:1", "m")
        o = mod.from_spec("openai:http://h:2", model="g")
        assert isinstance(o, mod.OpenAIChatClient) and (o.base_url, o.model) == ("http://h:2", "g")
        with pytest.raises(ValueError):
            mod.from_spec("wat:x")
    monkeypatch.setenv("LLM_DRY_RUN", "1")
    assert T.from_spec("openai:http://h:2").dry_run and J.from_spec("openai:http://h:2").dry_run
    prompts = [T.build_prompt(["battery died fast again"]), "no quotes here"]
    for p in prompts:
        assert T.DryRunClient().complete(p) == J.DryRunClient().complete(p)
    assert T.parse_topic_json(T.DryRunClient().complete(prompts[0]))["topic_label"] == \
        "battery died fast"
