"""Shard-count invariance of the port's ShardedSearchEngine alone (no JAX):
at 1, 2, 4, 8 and 16 shards on the CPU, sharding must not change an
answer. The corpus is tests/torch_bundle_cases.py's themed corpus (96
products, reviews with NaN stars and a sku outside the corpus) through
the port's builder.

- run_search (fused path, host gate, a fake cross-encoder, the device
  snippet lane and the truncated scan) equals SearchEngine's: skus in
  order, every signal within 1e-5, the same snippets;
- the striped pool's scores are exact where each shard's stripes cover
  its rows (dense_topk against the numpy cosine top-k);
- bm25_topk is bit-equal to SearchEngine.search_bm25, on the CPU branch
  and on the kernels' branch (the packed layout per shard; its wrapper's
  plain scan on CPU tensors);
- device.resolve_devices caps n_shards to the CUDA devices present, with
  a warning (torch.cuda's counts faked), takes a device list as given and
  refuses one that mixes CUDA and the CPU (the engine and the graph too);
  the CLI's search, serve and topics print the JAX CLI's cap line by the
  same rule (device.shard_count).

16 shards need no subprocess here: the CPU device repeats
(tests/test_shard_sweep.py needs a process with 16 virtual devices).
"""
import logging

import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.device import resolve_devices
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.build import build_bundle_from_products
from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine
from tests.torch_bundle_cases import corpus, one_torch_thread, reviews  # noqa: F401

SHARD_COUNTS = (1, 2, 4, 8, 16)
TOL = dict(rtol=1e-5, atol=1e-5)
QUERY = "yellow wireless headphones with a cat print"
SIGNALS = ("_dense", "_bm25", "_rerank", "_prior", "_best", "_trust", "_gate", "_final")
CASES = {
    "fused": dict(rerank_k=0),
    "host_gate": dict(rerank_k=0, gate_mode="host"),
    "rerank": dict(rerank_k=10),
    "snips": dict(rerank_k=0, use_snips=True),
    "snips_scan": dict(rerank_k=10, use_snips=True, max_scan=40, gate_mode="host"),
}


def _fake_cross(query, texts):
    return np.asarray([(len(t) % 97) / 97.0 + 0.01 * len(query) for t in texts], np.float32)


@pytest.fixture(scope="module")
def bundle():
    products, _queries, emb = corpus(n_themes=6, per_theme=16, n_queries=2)
    rows, remb = reviews(products)
    return build_bundle_from_products(products, emb, reviews=rows, review_embeddings=remb,
                                      doc_terms_cap=64, pad_multiple=16)


@pytest.fixture(scope="module")
def single(bundle):
    return SearchEngine(bundle, device="cpu", emb_dtype="float32", cross_encoder=_fake_cross)


def _qvec(seed, dim=64):
    v = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_run_search_equals_the_single_engine(bundle, single, n_shards):
    eng = ShardedSearchEngine(bundle, devices=["cpu"] * n_shards, emb_dtype="float32",
                              cross_encoder=_fake_cross)
    assert eng.n_shards == n_shards and eng.n_rows >= bundle.products.n_padded
    for name, case in CASES.items():
        case = dict(case)
        eng.gate_mode = single.gate_mode = case.pop("gate_mode", "device")
        try:
            a, sa, da = eng.run_search(QUERY, k=12, qvec=_qvec(5), **case)
            b, sb, db = single.run_search(QUERY, k=12, qvec=_qvec(5), **case)
        finally:
            eng.gate_mode = single.gate_mode = "device"
        assert [r["sku"] for r in a] == [r["sku"] for r in b], name
        for col in SIGNALS:
            np.testing.assert_allclose([r[col] for r in a], [r[col] for r in b],
                                       err_msg=f"{name} {col}", **TOL)
        assert sorted(sa) == sorted(sb), name
        for sku, snip in sb.items():
            assert sa[sku]["text"] == snip["text"]
            assert sa[sku]["score"] == pytest.approx(snip["score"], abs=1e-5)
        assert da["n_shards"] == n_shards and da.get("fused") == db.get("fused"), name


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_striped_pool_scores_are_exact(bundle, n_shards):
    """At most 96 / n rows a shard against 8192 / n stripes (at least the
    pool, 150): every shard's stripes hold one row each."""
    eng = ShardedSearchEngine(bundle, devices=["cpu"] * n_shards, emb_dtype="float32",
                              dense_pool="striped")
    p = bundle.products
    assert eng._shard_stripes >= eng.per
    emb = p.emb[: p.n_docs] / np.linalg.norm(p.emb[: p.n_docs], axis=1, keepdims=True)
    for seed in (1, 2):
        q = _qvec(seed)
        sims = emb @ q
        order = np.argsort(-sims, kind="stable")[:10]
        idx, scores = eng.dense_topk(q, 10)
        np.testing.assert_allclose(scores.numpy(), sims[order], rtol=1e-5, atol=1e-6)
        assert set(idx.tolist()) == set(order.tolist())
        rows, _s, _d = eng.run_search(QUERY, k=10, qvec=q, rerank_k=0)
        exact_rows, _s, _d = ShardedSearchEngine(
            bundle, devices=["cpu"] * n_shards, emb_dtype="float32").run_search(
            QUERY, k=10, qvec=q, rerank_k=0)
        assert [r["sku"] for r in rows] == [r["sku"] for r in exact_rows]


@pytest.mark.parametrize("kernels", [False, True], ids=["cpu_branch", "kernel_branch"])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_bm25_bit_equal_to_the_single_engine(bundle, single, monkeypatch, n_shards, kernels):
    eng = ShardedSearchEngine(bundle, devices=["cpu"] * n_shards, emb_dtype="float32")
    if kernels:
        monkeypatch.setattr(eng, "_kernels_ok", lambda: True)
        monkeypatch.setattr(single, "_kernels_ok", lambda: True)
    for query in (QUERY, "socks", "zzz nothing here"):
        for k in (10, 50):
            ti, ts = eng.bm25_topk(query, k)
            si, ss = single.search_bm25(query, k)
            np.testing.assert_array_equal(ts.numpy(), ss.numpy(), (query, k))
            np.testing.assert_array_equal(ti.numpy(), si.numpy(), (query, k))
    assert (eng._bm25_packed_cache is False) != kernels


def test_resolve_devices_caps_to_the_cuda_devices_present(monkeypatch, caplog):
    """n_shards alone on CUDA takes the first n devices, capped to those
    present with a warning naming both counts; a device list is taken as
    given, repeats included; on the CPU n shards share the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with caplog.at_level(logging.WARNING, logger="review_recommender_tpu_torch.device"):
        got = resolve_devices(None, 4, "cuda")
    assert got == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert "4 shards requested but only 2 CUDA devices" in caplog.text
    assert resolve_devices(None, None, "cuda") == got
    assert resolve_devices(["cuda"] * 3) == [torch.device("cuda", 0)] * 3
    assert resolve_devices(None, 3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="empty"):
        resolve_devices([])


def _fake_cuda(monkeypatch, count: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("entry", ["resolve_devices", "engine", "knn_graph"])
def test_a_device_list_mixing_cuda_and_the_cpu_is_refused(bundle, monkeypatch, entry):
    """An engine picks the BM25 kernels or their plain versions for all its
    shards at once, so its shards are all on CUDA or all on the CPU."""
    from review_recommender_tpu_torch.topics.density import knn_graph_sharded

    _fake_cuda(monkeypatch, 1)
    mixed = ["cuda:0", "cpu"]
    call = {"resolve_devices": lambda: resolve_devices(mixed),
            "engine": lambda: ShardedSearchEngine(bundle, devices=mixed),
            "knn_graph": lambda: knn_graph_sharded(np.eye(4, dtype=np.float32), 2,
                                                   devices=mixed)}[entry]
    with pytest.raises(ValueError, match="mix types"):
        call()


class _Loaded(Exception):
    """Raised in place of reading the bundle: the cap comes before it."""


@pytest.mark.parametrize("argv", [
    ["search", "q", "--index-dir", "B", "--shards", "4"],
    ["serve", "--index-dir", "B", "--shards", "4"],
    ["topics", "--index-dir", "B", "--cluster", "density", "--shards", "4"],
], ids=["search", "serve", "topics"])
def test_cli_caps_shards_to_the_devices_present_on_stderr(monkeypatch, capsys, argv):
    """Above the CUDA devices present each subcommand prints the JAX CLI's
    line and goes on with those there are (cli._capped_shards)."""
    from review_recommender_tpu_torch.index import io
    from review_recommender_tpu_torch.serve import cli

    _fake_cuda(monkeypatch, 1)
    monkeypatch.setattr(cli.config, "setup_logging", lambda: None)

    def load_bundle(_path):
        raise _Loaded

    monkeypatch.setattr(io, "load_bundle", load_bundle)
    with pytest.raises(_Loaded):
        cli.main(argv + ["--device", "cuda"])
    assert "--shards 4 > 1 available devices; using 1" in capsys.readouterr().err
    assert cli._capped_shards(4, "cpu") == 4 and cli._capped_shards(1, "cuda") == 1
