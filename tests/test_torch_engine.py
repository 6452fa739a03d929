"""The port's run_search (review_recommender_tpu_torch) against the JAX
SearchEngine, end to end: query encoder, retrieval, cross-encoder rerank
lane, gate and fusion.

Both engines get the same corpus (tests/test_engine_parity.make_corpus
through the JAX package's build_bundle_from_products, its numpy fields
handed to the port's dataclasses) and the same tiny f32 towers (flax
parameters carried over by params_from_flax). For the four reference configs x 3 queries, both gate
modes and both pool modes, the SKU order must be equal and every signal
column agree to 1e-5 (f32 sums in another order leave ~1e-6 after the
minmax normalisations). 320 documents with 160 stripes make the striped
pool's membership differ from the exact pool's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.config import config as jax_config
from review_recommender_tpu.engine.search import SearchEngine as JaxEngine
from review_recommender_tpu.index.build import build_bundle_from_products
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import BiEncoder as JaxBiEncoder
from review_recommender_tpu.models.encoder import CrossEncoder as JaxCrossEncoder
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.schema import IndexBundle, ProductIndex, ReviewIndex
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.ops import attention
from tests.test_engine_parity import CONFIGS, QUERIES, make_corpus

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
SIGNALS = ("_dense", "_bm25", "_rerank", "_prior", "_best", "_trust", "_gate", "_final")


def _port_bundle(jb):
    fields = lambda cls, obj: {f: getattr(obj, f) for f in cls.__dataclass_fields__}
    return IndexBundle(products=ProductIndex(**fields(ProductIndex, jb.products)),
                       reviews=ReviewIndex(**fields(ReviewIndex, jb.reviews)))


@pytest.fixture(scope="module")
def engines():
    products, emb, reviews, remb = make_corpus(n=320, dim=64, seed=0)
    jb = build_bundle_from_products(products, emb, reviews=reviews, review_embeddings=remb,
                                    pad_multiple=16, doc_terms_cap=64)
    cfg = JaxBertConfig.tiny()
    jbe = JaxBiEncoder.random_init(cfg, seed=1, dtype=jnp.float32)
    jce = JaxCrossEncoder.random_init(cfg, seed=2, dtype=jnp.float32)
    tcfg = BertConfig(**vars(cfg))
    tok = HashTokenizer(cfg.vocab_size)
    flat = lambda m: jax.tree.map(np.asarray, m.params)
    tbe = BiEncoder(tcfg, params_from_flax(flat(jbe), cfg, "biencoder"), tok,
                    device="cpu", dtype=torch.float32)
    tce = CrossEncoder(tcfg, params_from_flax(flat(jce), cfg, "crossencoder"), tok,
                       device="cpu", dtype=torch.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, port_config):  # both engines see 160 stripes
            mp.setattr(c, "DENSE_POOL_STRIPES", 160)
        for pool in ("exact", "striped"):
            je = JaxEngine(jb, emb_dtype="float32", query_encoder=jbe, cross_encoder=jce,
                           dense_pool=pool)
            te = SearchEngine(_port_bundle(jb), device="cpu", emb_dtype="float32",
                              query_encoder=tbe, cross_encoder=tce, dense_pool=pool)
            assert je.dense_pool == te.dense_pool == pool
            out[pool] = (je, te)
    return out


@pytest.mark.integration
@pytest.mark.parametrize("gate_mode", ["device", "host"])
@pytest.mark.parametrize("pool", ["exact", "striped"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_run_search_matches_jax(engines, pool, gate_mode, cfg_name):
    je, te = engines[pool]
    je.gate_mode = te.gate_mode = gate_mode
    for query in QUERIES[:3]:
        df, _snips, jdbg = je.run_search(query, use_snips=False, **CONFIGS[cfg_name])
        rows, snips, tdbg = te.run_search(query, use_snips=False, **CONFIGS[cfg_name])
        ref = df.to_dict(orient="records")
        assert snips == {}
        assert [r["sku"] for r in rows] == [r["sku"] for r in ref], query
        assert list(rows[0]) == list(df.columns)
        for col in SIGNALS:
            np.testing.assert_allclose([r[col] for r in rows], [r[col] for r in ref],
                                       err_msg=f"{query} {col}", **TOL)
        for r, s in zip(rows, ref):
            assert (r["n_reviews"], r["avg_stars"], r["agg_text"]) == \
                (s["n_reviews"], s["avg_stars"], s["agg_text"])
        for key in ("tokens", "groups", "pool", "gate_mode", "bm25_active"):
            assert tdbg[key] == jdbg[key], key
        assert tdbg.get("fused") == jdbg.get("fused")
    if CONFIGS[cfg_name]["rerank_k"]:
        assert any(r["_rerank"] > 0 for r in rows)
    assert attention.mha_kernel_launches == 0


@pytest.mark.parametrize("cfg_name", ["hybrid", "hybrid_rerank"])
def test_snippets_disabled_match_jax(engines, monkeypatch, cfg_name):
    """ENABLE_SNIPPETS=false on a bundle with reviews: both engines turn
    use_snips=True off (the JAX engine's use_snips_eff) and return no
    snippets. run_search and the four fused forms against the JAX engine:
    same SKUs and ids, signals within 1e-5."""
    from review_recommender_tpu.ops.fusion import FusionWeights as JaxWeights
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    for c in (jax_config, port_config):
        monkeypatch.setattr(c, "ENABLE_SNIPPETS", False)
    je, te = engines["exact"]
    assert te.bundle.reviews is not None and je.reviews is not None
    for query in QUERIES[:2]:
        df, jsnips, jdbg = je.run_search(query, use_snips=True, **CONFIGS[cfg_name])
        rows, snips, tdbg = te.run_search(query, use_snips=True, **CONFIGS[cfg_name])
        assert snips == jsnips == {}
        assert [r["sku"] for r in rows] == list(df["sku"]), query
        for col in SIGNALS:
            np.testing.assert_allclose([r[col] for r in rows], df[col].to_numpy(),
                                       err_msg=f"{query} {col}", **TOL)
        for key in ("tokens", "groups", "pool", "gate_mode", "bm25_active"):
            assert tdbg[key] == jdbg[key], key
        assert tdbg.get("fused") == jdbg.get("fused")
    knobs = {k: v for k, v in CONFIGS[cfg_name].items() if k not in ("k", "rerank_k")}
    order = ("w_dense", "w_bm25", "w_rerank", "w_prior", "w_best", "prior_C", "min_reviews",
             "gate_penalty")
    jw, tw = JaxWeights.make(*(knobs[k] for k in order)), FusionWeights.make(
        *(knobs[k] for k in order))
    qv = np.stack([te.encode_query(q) for q in QUERIES[:2]])
    jr, js = je.query_fused(qv[0], QUERIES[0], jw, 150, 10, use_snips=True)
    tr, ts = te.query_fused(qv[0], QUERIES[0], tw, 150, 10, use_snips=True)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    j1 = np.asarray(je.query_fused1(qv[1], QUERIES[1], jw, 150, 10, use_snips=True))
    t1 = te.query_fused1(qv[1], QUERIES[1], tw, 150, 10, use_snips=True).numpy()
    np.testing.assert_array_equal(t1[:, 0], j1[:, 0])
    np.testing.assert_allclose(t1, j1, **TOL)
    jr, js = je.query_fused_batched(qv, QUERIES[:2], jw, 150, 10, use_snips=True)
    tr, ts = te.query_fused_batched(qv, QUERIES[:2], tw, 150, 10, use_snips=True)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    wl = [tuple(knobs[k] for k in order)] * 2
    jr, js, jbd = je.query_fused_batched_pw(qv, QUERIES[:2], wl, 150, 10, use_snips=True)
    tr, ts, tbd = te.query_fused_batched_pw(qv, QUERIES[:2], wl, 150, 10, use_snips=True)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tbd.numpy(), np.asarray(jbd), **TOL)


def test_striped_pool_membership_differs_from_exact(engines):
    """At 320 rows over 160 stripes the striped pool is approximate: same
    exact scores for the rows it keeps, a different row set."""
    q = torch.from_numpy(engines["exact"][1].encode_query(QUERIES[0]))
    (es, ei), (ss, si) = (engines[p][1]._dense_topk(engines[p][1].arrays, q, 150)
                          for p in ("exact", "striped"))
    assert set(ei.tolist()) != set(si.tolist())
    exact_by_row = dict(zip(ei.tolist(), es.tolist()))
    shared = [(exact_by_row[r], s) for r, s in zip(si.tolist(), ss.tolist()) if r in exact_by_row]
    assert len(shared) > 100
    np.testing.assert_allclose(*zip(*shared), rtol=1e-6)


def test_refuses_what_is_not_ported(engines):
    """ivf over an int8 corpus raises ValueError, as in the JAX engine (int8
    and ivf each run: tests/test_torch_int8.py, test_torch_ivf.py)."""
    je, te = engines["exact"]
    with pytest.raises(ValueError, match="ivf needs a bf16/f32 corpus"):
        JaxEngine(je.bundle, emb_dtype="int8", dense_pool="ivf")
    with pytest.raises(ValueError, match="ivf needs a bf16/f32 corpus"):
        SearchEngine(te.bundle, device="cpu", emb_dtype="int8", dense_pool="ivf")
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")



def test_entry_points_default_to_the_card(engines):
    """Without a device argument SearchEngine and the towers ask for "cuda":
    on a machine without CUDA they raise instead of running on the CPU."""
    bundle, cfg = engines["exact"][1].bundle, BertConfig.tiny()
    makers = {"SearchEngine": lambda: SearchEngine(bundle),
              "BiEncoder.random_init": lambda: BiEncoder.random_init(cfg),
              "BiEncoder.random_for_dim": lambda: BiEncoder.random_for_dim(64),
              "CrossEncoder.random_init": lambda: CrossEncoder.random_init(cfg)}
    for name, make in makers.items():
        if torch.cuda.is_available():
            assert make().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()


_HYGIENE = """
import json, sys, numpy as np, torch
sys.modules.update(pandas=None, pyarrow=None, fsspec=None)  # the card's machine: not installed
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.build import (attach_rerank_tokens, build_review_index,
                                                      synth_product_index)
from review_recommender_tpu_torch.index.schema import IndexBundle
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.ops import attention, bm25_kernel, stage_a
from review_recommender_tpu_torch.ops.fusion import FusionWeights
p = synth_product_index(400, 64, 300, 12, seed=0, text_chars=200)
cfg = BertConfig.tiny(vocab_size=300)
be = BiEncoder.random_init(cfg, seed=1, device="cpu")
ce = CrossEncoder.random_init(cfg, seed=2, device="cpu")
attach_rerank_tokens(p, be.tokenizer, max_tokens=24)
rng = np.random.default_rng(1)
rev = build_review_index([f"S{i % 400}" for i in range(1200)], [f"r{i}" for i in range(1200)],
                         rng.integers(1, 6, 1200).astype(np.float32),
                         rng.standard_normal((1200, 64)).astype(np.float32), p.skus)
eng = SearchEngine(IndexBundle(products=p, reviews=rev), device="cpu",
                   query_encoder=be, cross_encoder=ce)
eng.attach_models(be, ce)
n = [len(eng.run_search("t12 t345 t7 t1234", k=10, rerank_k=r)[0]) for r in (0, 50)]
rows, snips, _ = eng.run_search("t12 t345 t7 t1234", k=10, rerank_k=0, use_snips=True)
n += [len(rows), len(snips)]
w = FusionWeights.make()
n += [int(torch.isfinite(eng.query_e2e("t12 t345 t7", w, 150, 10, rr_k=r)[1]).sum())
      for r in (0, 4)]
qv2 = np.random.default_rng(2).standard_normal((2, 64)).astype(np.float32)
n.append(int(torch.isfinite(eng.query_rerank_batched_pw(
    qv2, ["t12 t345", "t7 t1234"], [tuple(w)] * 2, [4, 0], 150, 10)[1]).sum()))
idx, scores = eng.search_bm25("t12 t345 t7 t1234", k=10)
n.append(int((scores > 0).sum()))
qv = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32))
rows, finals = eng.query_fused_batched(qv.numpy(), ["t12 t345", "t7 t1234"],
                                       FusionWeights.make(), 150, 10)
n.append(int(torch.isfinite(finals).sum()))
a = eng.arrays
_d, ids, _b = stage_a.stage_a_fused(a["emb"], a["valid"], a["doc_terms"], a["doc_bm25"], qv,
                                    torch.tensor([[12, 345], [7, 1234]], dtype=torch.int32), 16)
n.append(ids.numel())
import threading, urllib.request
from review_recommender_tpu_torch import native
from review_recommender_tpu_torch.evals.metrics import IRMetrics
from review_recommender_tpu_torch.serve.api import serve
from review_recommender_tpu_torch.serve.native_server import serve_native
post = lambda port, obj: json.loads(urllib.request.urlopen(urllib.request.Request(
    f"http://127.0.0.1:{port}/search", data=json.dumps(obj).encode()), timeout=60).read())
srv = serve(eng, host="127.0.0.1", port=0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
n.append(len(post(srv.server_address[1], {"query": "t12 t345", "k": 5, "rerank_k": 4})["results"]))
srv.shutdown(); srv.service.close()
nat = serve_native(eng, host="127.0.0.1", port=0)
n.append(len(post(nat.port, {"query": "t7 t1234", "k": 5, "rerank_k": 0})["results"]))
nat.close()
m = IRMetrics(); m.evaluate_query("q", ["S1", "S2"], {"S2"})
n.append(m.aggregate_metrics()["n_queries"] + int(native.native_server_available()))
import tempfile
from review_recommender_tpu_torch.index.build import build_bundle_from_products
from review_recommender_tpu_torch.index.io import load_bundle, save_bundle
from review_recommender_tpu_torch.serve import cli
prods = [{"sku": f"P{i}", "agg_text": f"yellow socks number {i} t{i}", "n_reviews": 10.0,
          "avg_stars": 4.0} for i in range(40)]
bdir = tempfile.mkdtemp()
save_bundle(build_bundle_from_products(
    prods, np.random.default_rng(3).standard_normal((40, 64)).astype(np.float32),
    pad_multiple=16), bdir)
n.append(load_bundle(bdir, verify_checksums=True).products.n_docs)
n += [cli.main([cmd, *arg, "--index-dir", bdir, "--device", "cpu"])
      for cmd, arg in (("search", ["yellow socks", "--k", "5"]), ("audit", []))]
import pickle
from review_recommender_tpu_torch import data, topics
from review_recommender_tpu_torch.data.pipeline import write_numpy_form
ref, idir, rng = tempfile.mkdtemp(), tempfile.mkdtemp(), np.random.default_rng(4)
np.save(f"{ref}/product_emb.npy", rng.standard_normal((40, 64)).astype(np.float32))
write_numpy_form({"sku": [p["sku"] for p in prods], "n_reviews": np.full(40, 10.0),
                  "avg_stars": np.full(40, 4.0), "last_ts": [None] * 40,
                  "agg_text": [p["agg_text"] for p in prods]}, f"{ref}/product_emb_meta.npz")
with open(f"{ref}/product_bm25.pkl", "wb") as f:
    pickle.dump({"skus": [p["sku"] for p in prods], "tokenizer": "simple_en_v1",
                 "corpus": [p["agg_text"].split() for p in prods]}, f)
centers = rng.standard_normal((4, 64))
write_numpy_form({"sku": [f"P{i % 40}" for i in range(240)],
                  "text": [f"theme{i // 60} word{i // 60} great {i}" for i in range(240)],
                  "stars": rng.integers(1, 6, 240).astype(np.float64),
                  "embedding": (np.repeat(centers, 60, 0)
                                + 0.1 * rng.standard_normal((240, 64))).astype(np.float32)},
                 f"{ref}/reviews_with_embeddings.npz")
n.append(cli.main(["import", "--data-dir", ref, "--out", idir]))
for lane in (["--k", "4"], ["--cluster", "density", "--min-samples", "5",
                            "--min-cluster-size", "20", "--llm", "dry"]):
    out = tempfile.mkdtemp()
    n.append(cli.main(["topics", "--index-dir", idir, "--out", out, "--device", "cpu", *lane]))
    n.append(len(open(f"{out}/topic_cards.jsonl").readlines()))
from review_recommender_tpu_torch.data import embed_job, etl, prep, warehouse
from review_recommender_tpu_torch.data.pipeline import run_full_pipeline
from review_recommender_tpu_torch.tools import archiver
raw = tempfile.mkdtemp()
with open(f"{raw}/r.jsonl", "w") as f:
    f.writelines(json.dumps({"asin": f"0{i % 6:03d}", "overall": 1 + i % 5,
                             "reviewText": f"review {i} t{i % 9} t{i % 4} words",
                             "unixReviewTime": 1400000000 + i}) + "\\n" for i in range(60))
with open(f"{raw}/r.csv", "w") as f:
    f.write("product_id,star_rating,review_body,review_date\\n" + "".join(
        f"P{i % 5},{1 + i % 5},csv review {i} t{i % 7} here,2015-08-{1 + i % 28:02d}\\n"
        for i in range(40)))
pb = run_full_pipeline([(f"{raw}/r.jsonl", "jsonl", "snap"), (f"{raw}/r.csv", "csv", "kaggle")],
                       be, f"{raw}/out", doc_terms_cap=32)
n += [pb.products.n_docs, pb.reviews.n_reviews_total,
      embed_job.job_status(f"{raw}/out/_work/product_emb")["done_shards"],
      len(prep.filter_reviews_for_snippets(etl.normalize_merge(
          [(f"{raw}/r.jsonl", "jsonl", "snap")], f"{raw}/m.npz"), 4)["id"]),
      warehouse.make_warehouse(f"{raw}/wh").load(etl.normalize_merge(
          [(f"{raw}/r.csv", "csv", "kaggle")], f"{raw}/m2.npz")),
      len(archiver.archive_files(raw, ("*.csv",), dry_run=True))]
bad = [m for m in ("jax", "flax", "pandas", "pyarrow", "fsspec") if sys.modules.get(m)]
bad += sorted(m for m in sys.modules
              if m == "review_recommender_tpu" or m.startswith("review_recommender_tpu."))
launches = (attention.mha_kernel_launches + bm25_kernel.bm25_packed_kernel_launches
            + bm25_kernel.bm25_unpacked_kernel_launches + stage_a.stage_a_kernel_launches)
print(json.dumps({"rows": n, "bad": bad, "launches": launches}))
"""


def test_port_imports_no_jax_pandas_or_pyarrow():
    """A fresh interpreter imports the port and runs a tiny CPU run_search
    (bf16 towers and corpus, both rerank settings, and with snippets on a
    review index), query_e2e at rr_k 0 and 4 on attach_rerank_tokens'
    tokens, query_rerank_batched_pw with 2 riders, search_bm25,
    query_fused_batched and stage_a_fused, then starts the stdlib and the
    native HTTP servers on that engine (one /search each) and computes IR
    metrics, then builds a bundle from products (native tokenizer), saves
    and loads it in the port's layout and runs the CLI's search and audit
    on it, then `import`s a reference data directory in the numpy form and
    runs `topics` on it in both lanes (--llm dry in the density one),
    then runs the raw-review pipeline (run_full_pipeline on a JSONL and a
    CSV dump, the snippet filter, the warehouse and the archiver: the
    modules data.etl, data.prep, data.embed_job, data.warehouse and
    tools.archiver), where pandas, pyarrow and fsspec cannot be imported
    (as on the card's machine), without loading jax, flax or any module of
    the JAX package, and without a kernel launch."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"rows": [10, 10, 10, 150, 10, 10, 20, 10, 20, 32, 5, 5, 2, 40, 0, 0,
                            0, 0, 4, 0, 4, 11, 100, 1, 24, 40, 1], "bad": [],
                   "launches": 0}
