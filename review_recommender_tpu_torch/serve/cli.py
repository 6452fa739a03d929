"""The command line: one engine behind search / serve / audit / health /
bench / eval / train, with topics and import beside it.

Counterpart of `review_recommender_tpu/serve/cli.py`, with its parser's
arguments and defaults, plus `--device` (default "cuda"; the tests pass
"cpu"). `_load_engine` reads a bundle through index/io.py (either layout)
and builds SearchEngine with the towers of EMB_MODEL_DIR / RERANK_MODEL_DIR
(models/load.py: an HF snapshot or a native tower), or, where those are
unset, random towers of the JAX CLI's shapes (`BiEncoder.random_for_dim(
dim)`: bge-small at 384; `CrossEncoder.random_init()`: MiniLM-L6). A
bi-encoder whose width is not the bundle's dim, or a directory that does
not load, exits non-zero naming it. A loaded cross-encoder re-tokenizes
the bundle's rerank tokens (index/build.py:attach_rerank_tokens) with its
own tokenizer before the engine places them, so query_e2e never feeds it
another tokenizer's ids; with both towers loaded the engine has them
attached for query_e2e.

  python -m review_recommender_tpu_torch.serve.cli search "query" --index-dir DIR
  ... serve  --index-dir DIR [--host H --port P] [--native] [--with-rerank]
  ... audit  --index-dir DIR     (exit code 0/1 gates a deploy)
  ... health [--url http://host:port]
  ... bench  --index-dir DIR [--n-queries 64]
  ... eval   --index-dir DIR --queries judged.jsonl [--out DIR]
  ... train  --index-dir DIR --out TOWERS [--cross] [--mlm-steps N] [--resume]
  ... topics --index-dir DIR --out D [--cluster kmeans|density] [--llm dry|ollama|openai]
  ... import --data-dir REF --out DIR [--doc-terms-cap N] [--no-reviews]

`train` is the JAX command's flow (review_recommender_tpu/serve/cli.py
cmd_train) on the port's trainers (train/): pairs mined from the bundle's
reviews, an optional MLM-pretrained trunk, the bi-encoder fine-tuned from
EMB_MODEL_DIR (its f32 weights: models/load.py:load_tower_params) or
trained from scratch, with --cross the cross-encoder from
RERANK_MODEL_DIR, the MLM trunk grafted in, or from scratch; stage
checkpoints in --out (--resume continues them), native tower directories
that this CLI's and the JAX CLI's loaders serve, and one JSON line.

`topics` is the JAX cmd_topics on the port's topic modules (topics/):
the bundle's review embeddings clustered by spherical k-means or, with
--cluster density, by density clustering (the kNN graph on --device),
TF-IDF names or an LLM's (--llm), aspect metrics, resume-safe cards in
topic_cards.jsonl and aspect_metrics.json, and the parquet views
(topic_cards.parquet, topics.parquet) where pyarrow imports (a line on
stderr says when they are skipped); --bench times card generation
instead. `import` is the JAX cmd_import on data/pipeline.py: a reference
data directory (local or an fsspec URL) into a bundle, each table read
from its numpy form where that exists, else from parquet.

What the port cannot do yet exits non-zero and names its ROADMAP Queue 1
item, where the JAX CLI would run something else: `--shards` /
MESH_SHARDS above 1 (item 12). `serve --native` (or SERVE_NATIVE) raises
when the native library cannot be built; it never falls back to the
stdlib server.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from review_recommender_tpu_torch.config import config

def _refuse(msg: str):
    raise SystemExit(f"rrt: {msg}")


def _load_tower(kind: str, knob: str, device):
    """The tower in the directory of config.<knob>, on `device`; exits
    non-zero naming the knob and directory when it does not load."""
    from review_recommender_tpu_torch.models import load

    path = getattr(config, knob)
    loader = load.load_biencoder if kind == "biencoder" else load.load_crossencoder
    try:
        return loader(path, device=device)
    except (OSError, ValueError, KeyError) as e:
        _refuse(f"{knob}={path}: cannot load a {kind} ({type(e).__name__}: {e})")


def _load_engine(index_dir: str, gate_mode: Optional[str] = None, with_models: bool = True,
                 with_rerank: bool = False, dense_pool: Optional[str] = None,
                 shards: Optional[int] = None, device="cuda"):
    """SearchEngine on `device` over the bundle at index_dir, with the
    towers of EMB_MODEL_DIR / RERANK_MODEL_DIR or random ones (or none:
    with_models=False, with_rerank=False)."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import attach_rerank_tokens
    from review_recommender_tpu_torch.index.io import load_bundle
    from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder

    n_shards = config.MESH_SHARDS if shards is None else int(shards)
    if n_shards > 1:
        _refuse(f"--shards {n_shards}: the sharded engine is not ported yet "
                "(ROADMAP Queue 1 item 12)")
    bundle = load_bundle(index_dir)
    encoder = cross = None
    if with_models and config.EMB_MODEL_DIR:
        encoder = _load_tower("biencoder", "EMB_MODEL_DIR", device)
        if encoder.cfg.hidden_size != bundle.products.dim:
            _refuse(f"EMB_MODEL_DIR={config.EMB_MODEL_DIR}: the bi-encoder's hidden size "
                    f"{encoder.cfg.hidden_size} is not the bundle's dim {bundle.products.dim}")
    elif with_models:
        encoder = BiEncoder.random_for_dim(bundle.products.dim, device=device)
    if with_rerank and config.ENABLE_RERANKING and config.RERANK_MODEL_DIR:
        cross = _load_tower("crossencoder", "RERANK_MODEL_DIR", device)
        p = bundle.products
        if p.doc_tokens is not None:
            attach_rerank_tokens(p, cross.tokenizer, max_tokens=p.doc_tokens.shape[1])
    elif with_rerank and config.ENABLE_RERANKING:
        cross = CrossEncoder.random_init(device=device)
    engine = SearchEngine(bundle, device=device, query_encoder=encoder, cross_encoder=cross,
                          gate_mode=gate_mode, dense_pool=dense_pool)
    if encoder is not None and cross is not None and config.EMB_MODEL_DIR \
            and config.RERANK_MODEL_DIR:  # both loaded: tokens and towers agree
        engine.attach_models(encoder, cross)
    return engine


def cmd_search(args) -> int:
    engine = _load_engine(args.index_dir, args.gate_mode, with_rerank=args.rerank_k > 0,
                          dense_pool=args.dense_pool, device=args.device)
    t0 = time.perf_counter()
    rows, snips, debug = engine.run_search(
        args.query, k=args.k, rerank_k=args.rerank_k,
        w_dense=args.w_dense, w_bm25=args.w_bm25, w_rerank=args.w_rerank,
        w_prior=args.w_prior, w_best=args.w_best, prior_C=args.prior_c,
        use_snips=args.snippets, min_reviews=args.min_reviews,
        gate_penalty=args.gate_penalty,
    )
    took = time.perf_counter() - t0
    for rank, row in enumerate(rows, 1):
        print(f"{rank:2d}. {row['sku']}  final={row['_final']:.4f} "
              f"dense={row['_dense']:.3f} bm25={row['_bm25']:.3f} "
              f"prior={row['_prior']:.3f} stars={row['avg_stars']:.2f} "
              f"n={int(row['n_reviews'])}")
    print(f"-- {len(rows)} results in {took:.3f}s "
          f"(pool={debug['pool']}, bm25_active={debug['bm25_active']})")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps({
            "query": args.query, "results": rows, "snippets": snips, "debug": debug,
            "took_s": took,
        }, indent=2))
    return 0


def cmd_serve(args) -> int:
    from review_recommender_tpu_torch import native

    config.setup_logging()
    use_native = args.native or config.SERVE_NATIVE
    if use_native:
        native.native_server_available()  # builds the library now, or raises
    engine = _load_engine(args.index_dir, args.gate_mode, with_rerank=args.with_rerank,
                          dense_pool=args.dense_pool, shards=args.shards, device=args.device)
    if use_native:
        from review_recommender_tpu_torch.serve.native_server import serve_native

        srv = serve_native(engine, host=args.host, port=args.port, warmup_async=True)
        port, stop, front = srv.port, srv.close, "native front end"
    else:
        from review_recommender_tpu_torch.serve.api import serve

        srv = serve(engine, host=args.host, port=args.port, warmup_async=True)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port, front = srv.server_address[1], "stdlib server"

        def stop():
            srv.shutdown()
            srv.service.close()
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    print(f"serving on http://{args.host}:{port} (docs={engine.products.n_docs}, {front}, "
          f"{engine.device}); warming up in background", flush=True)
    done.wait()
    stop()
    print("stopped", flush=True)
    return 0


def cmd_audit(args) -> int:
    from review_recommender_tpu_torch.serve.audit import audit_index_dir

    report = audit_index_dir(args.index_dir, device=args.device)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


def cmd_health(args) -> int:
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/") + "/healthz"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            ok = r.status == 200
    except (urllib.error.URLError, OSError) as e:
        print(f"health check failed: {e}", file=sys.stderr)
        return 1
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    engine = _load_engine(args.index_dir, gate_mode="device", with_models=False,
                          dense_pool=args.dense_pool, device=args.device)
    dim = engine.products.dim
    rng = np.random.default_rng(0)
    texts = [t for t in list(engine.products.agg_texts[:64]) if t] or ["test query"]
    qvecs = rng.standard_normal((args.n_queries, dim)).astype(np.float32)
    qvecs /= np.linalg.norm(qvecs, axis=1, keepdims=True)
    w = FusionWeights.make()
    engine.query_fused(qvecs[0], texts[0], w, pool=150, k=10)[0].cpu()  # first call untimed
    lat = []
    for i in range(args.n_queries):
        t0 = time.perf_counter()
        rows, _scores = engine.query_fused(qvecs[i], texts[i % len(texts)], w, pool=150, k=10)
        rows.cpu()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    print(json.dumps({
        "qps": round(1 / lat.mean(), 2),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
        "n_docs": engine.products.n_docs,
        "device": str(engine.device),
    }))
    return 0


def read_judged_queries(path) -> list:
    """JSONL, one {"query", "relevant_skus"[, "id"]} per line."""
    queries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                row = json.loads(line)
                queries.append({"id": row.get("id", f"q{len(queries)}"), "query": row["query"],
                                "relevant_skus": row["relevant_skus"]})
    return queries


def cmd_eval(args) -> int:
    """IR metrics of the bundle's engine over judged queries: the four
    method configs (or --method) through run_search, printed as the
    markdown table; --out also writes benchmark_results.json and the CSV."""
    from review_recommender_tpu_torch.evals.benchmark import (
        format_results_table,
        measure_rpc_floor,
        run_performance_benchmark,
        save_benchmark_results,
    )
    from review_recommender_tpu_torch.evals.queries import BENCHMARK_CONFIGS

    queries = read_judged_queries(args.queries)
    if not queries:
        print("eval: no queries in file", file=sys.stderr)
        return 1
    method_configs = None
    if args.method:
        if args.method not in BENCHMARK_CONFIGS:
            print(f"eval: unknown method {args.method!r} (have: {sorted(BENCHMARK_CONFIGS)})",
                  file=sys.stderr)
            return 1
        method_configs = {args.method: BENCHMARK_CONFIGS[args.method]}
    engine = _load_engine(args.index_dir, args.gate_mode, with_rerank=True,
                          dense_pool=args.dense_pool, device=args.device)
    results = run_performance_benchmark(engine.run_search, queries,
                                        method_configs=method_configs,
                                        warmup=not args.no_warmup,
                                        rpc_floor_ms=measure_rpc_floor(engine.device))
    print(format_results_table(results))
    if args.out:
        save_benchmark_results(results, args.out)
        print(f"wrote {args.out}/benchmark_results.json", file=sys.stderr)
    return 0


def _scratch_cfg(args, hidden: int, intermediate: int, max_position: int):
    from review_recommender_tpu_torch.models.bert import BertConfig

    return BertConfig(vocab_size=args.vocab_size, hidden_size=hidden, num_layers=args.layers,
                      num_heads=max(1, hidden // args.head_dim),
                      intermediate_size=intermediate, max_position=max_position)


def cmd_train(args) -> int:
    """Domain-adapt the towers on the bundle's own reviews and save native
    tower directories (the JAX cmd_train's stages, flags and output)."""
    from review_recommender_tpu_torch.index.io import load_bundle
    from review_recommender_tpu_torch.models.bert import init_state_dict
    from review_recommender_tpu_torch.models.load import load_tower_params, save_native_tower
    from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
    from review_recommender_tpu_torch.train import (
        ContrastiveTrainer,
        CrossEncoderTrainer,
        CrossTrainConfig,
        MLMTrainConfig,
        MLMTrainer,
        TrainConfig,
        init_mlm,
        mine_pairs,
        mine_triples,
        pretrain_mlm,
        train_biencoder,
        train_crossencoder,
    )
    from review_recommender_tpu_torch.train.cross_encoder import warm_start_from_biencoder

    config.setup_logging()
    say = lambda msg: print(msg, file=sys.stderr, flush=True)
    bundle = load_bundle(args.index_dir)
    if bundle.reviews is None:
        say("train: the index bundle has no review texts to mine pairs from "
            "(rebuild with reviews)")
        return 1
    rev, prod = bundle.reviews, bundle.products
    valid = np.asarray(rev.rev_valid, bool)
    seg = np.asarray(rev.rev_product, np.int64)
    review_texts = [t for t, v in zip(rev.rev_texts, valid) if v]
    review_skus = [prod.skus[int(s)] for s, v in zip(seg, valid) if v]
    pairs = mine_pairs(review_texts, review_skus, prod.skus, prod.agg_texts,
                       max_pairs_per_product=args.pairs_per_product, seed=args.seed)
    if not pairs:
        say("train: no minable (query, positive) pairs")
        return 1
    say(f"mined {len(pairs)} (query, positive) pairs from {len(review_texts)} reviews")

    out = Path(args.out)
    dev = args.device
    mlm_trunk = None
    if args.mlm_steps > 0:  # a from-scratch cross-encoder learns only on a pretrained trunk
        cfg_mlm = _scratch_cfg(args, args.hidden, 2 * args.hidden, 2 * args.max_len)
        mtr = MLMTrainer(cfg_mlm, init_mlm(cfg_mlm, seed=args.seed)[1], device=dev,
                         train_cfg=MLMTrainConfig(learning_rate=args.lr, seed=args.seed,
                                                  total_steps=args.mlm_steps))
        ckpt_mlm = out / "mlm_trunk.ckpt"
        if args.resume and ckpt_mlm.exists():
            mtr.restore(ckpt_mlm)
            say(f"mlm: resumed from {ckpt_mlm} at step {mtr.step}")
        mhist = pretrain_mlm(mtr, prod.agg_texts, HashTokenizer(vocab_size=args.vocab_size),
                             batch_size=args.batch_size, steps=args.mlm_steps,
                             max_len=args.max_len, seed=args.seed,
                             checkpoint_path=str(ckpt_mlm),
                             checkpoint_every=args.checkpoint_every)
        if mhist:
            say(f"mlm pretrain: {len(mhist)} steps (at {mtr.step}/{args.mlm_steps}), masked acc "
                f"{np.mean([m['masked_acc'] for m in mhist[-100:]]):.3f}")
        mlm_trunk = mtr.params

    if config.EMB_MODEL_DIR:
        cfg_bi, params_bi, tok, _pooling = load_tower_params(config.EMB_MODEL_DIR, "biencoder")
    else:
        cfg_bi = _scratch_cfg(args, args.hidden, 2 * args.hidden, args.max_len)
        params_bi = init_state_dict(cfg_bi, "biencoder", args.seed)
        tok = HashTokenizer(vocab_size=args.vocab_size)
        if mlm_trunk is not None:
            params_bi = warm_start_from_biencoder(params_bi, mlm_trunk)
    trainer = ContrastiveTrainer(cfg_bi, params_bi, device=dev,
                                 train_cfg=TrainConfig(learning_rate=args.lr, seed=args.seed))
    ckpt_bi = out / "biencoder.ckpt"
    if args.resume and ckpt_bi.exists():
        trainer.restore(ckpt_bi)
        say(f"bi-encoder: resumed from {ckpt_bi} at step {trainer.step}")
    hist = train_biencoder(trainer, pairs, tok, batch_size=args.batch_size, epochs=args.epochs,
                           max_len=args.max_len, seed=args.seed, checkpoint_path=str(ckpt_bi),
                           checkpoint_every=args.checkpoint_every)
    if hist:
        say(f"bi-encoder: {len(hist)} steps, final loss {hist[-1]['loss']:.4f} in-batch acc "
            f"{hist[-1]['in_batch_acc']:.3f}")
    save_native_tower(out / "biencoder", "biencoder", cfg_bi, trainer.params, tok)

    if args.cross:
        triples = mine_triples(pairs, prod.agg_texts, n_negatives=args.negatives,
                               seed=args.seed + 1)
        if config.RERANK_MODEL_DIR:
            cfg_xe, params_xe, tok_xe, _ = load_tower_params(config.RERANK_MODEL_DIR,
                                                             "crossencoder")
        elif mlm_trunk is not None:
            # the trunk's dims and its hash tokenizer: a loaded bi-encoder's
            # WordPiece ids would come from another id space
            cfg_xe = _scratch_cfg(args, args.hidden, 2 * args.hidden, 2 * args.max_len)
            params_xe = warm_start_from_biencoder(
                init_state_dict(cfg_xe, "crossencoder", args.seed), mlm_trunk)
            tok_xe = HashTokenizer(vocab_size=args.vocab_size)
        else:
            hidden = max(64, args.hidden // 2)
            cfg_xe = _scratch_cfg(args, hidden, args.hidden, 2 * args.max_len)
            params_xe = init_state_dict(cfg_xe, "crossencoder", args.seed)
            tok_xe = tok
        xtr = CrossEncoderTrainer(cfg_xe, params_xe, device=dev,
                                  train_cfg=CrossTrainConfig(learning_rate=args.lr,
                                                             seed=args.seed))
        ckpt_xe = out / "crossencoder.ckpt"
        if args.resume and ckpt_xe.exists():
            xtr.restore(ckpt_xe)
            say(f"cross-encoder: resumed from {ckpt_xe} at step {xtr.step}")
        xhist = train_crossencoder(xtr, triples, tok_xe, batch_size=args.batch_size,
                                   epochs=args.epochs, max_len=2 * args.max_len, seed=args.seed,
                                   checkpoint_path=str(ckpt_xe),
                                   checkpoint_every=args.checkpoint_every)
        if xhist:
            say(f"cross-encoder: {len(xhist)} steps, final loss {xhist[-1]['loss']:.4f} acc "
                f"{xhist[-1]['acc']:.3f}")
        save_native_tower(out / "crossencoder", "crossencoder", cfg_xe, xtr.params, tok_xe)

    print(json.dumps({
        "pairs": len(pairs),
        "biencoder": str(out / "biencoder"),
        "crossencoder": str(out / "crossencoder") if args.cross else None,
        "serve_env": {"EMB_MODEL_DIR": str(out / "biencoder"),
                      **({"RERANK_MODEL_DIR": str(out / "crossencoder")} if args.cross else {})},
    }))
    return 0


def cmd_import(args) -> int:
    """A reference deployment's data directory (local or an fsspec URL)
    into an index bundle: the artifact names of config.py, each parquet
    table taken in its numpy form where that exists."""
    from review_recommender_tpu_torch.data.pipeline import import_reference_artifacts, numpy_form
    from review_recommender_tpu_torch.index.io import artifact_exists, join_path

    def resolve(name: str, required: bool = False):
        for cand in dict.fromkeys((numpy_form(name), name)):
            path = join_path(args.data_dir, cand)
            if artifact_exists(path):
                return path
        if required:
            raise SystemExit(f"missing required artifact: {join_path(args.data_dir, name)}")
        return None

    emb = resolve(config.PRODUCT_EMB_FILE, required=True)
    meta = resolve(config.PRODUCT_META_FILE, required=True)
    bm25 = resolve(config.BM25_FILE)
    reviews = resolve(config.REVIEWS_EMB_FILE) if not args.no_reviews else None
    bundle = import_reference_artifacts(emb, meta, bm25_pkl=bm25, reviews_parquet=reviews,
                                        out_dir=args.out, doc_terms_cap=args.doc_terms_cap)
    print(json.dumps({
        "out": str(args.out),
        "n_docs": bundle.products.n_docs,
        "has_bm25_tokens": bm25 is not None,
        "n_reviews": bundle.reviews.n_reviews_total if bundle.reviews is not None else 0,
    }))
    return 0


def cmd_topics(args) -> int:
    """Cluster the bundle's reviews, name the topics, compute aspect metrics
    and write resume-safe cards (the JAX cmd_topics, flag for flag);
    --bench prints the card-generation estimate instead."""
    from review_recommender_tpu_torch.index.io import load_bundle
    from review_recommender_tpu_torch.topics.cards import (
        benchmark_generator,
        generate_topic_cards,
        parquet_writer,
        pick_quotes,
    )
    from review_recommender_tpu_torch.topics.cluster import spherical_kmeans
    from review_recommender_tpu_torch.topics.naming import (
        aspect_metrics,
        map_label_to_aspect,
        name_topics,
        tfidf_topic_terms,
    )

    if args.cluster == "density" and (args.shards or 1) > 1:  # k-means ignores it, as in JAX
        _refuse(f"topics --shards {args.shards}: the sharded kNN graph is not ported yet "
                "(ROADMAP Queue 1 item 12)")
    bundle = load_bundle(args.index_dir)
    if bundle.reviews is None:
        print("topics: index has no review embeddings (build with reviews + review_embeddings)",
              file=sys.stderr)
        return 1
    rev = bundle.reviews
    m = int(rev.n_reviews_total)  # valid rows come first (index/build.py)
    emb = np.asarray(rev.rev_emb, np.float32)[:m]
    texts = list(rev.rev_texts)[:m]
    stars = np.asarray(rev.rev_stars, np.float32)[:m]
    if len(texts) == 0:
        print("topics: no valid reviews in index", file=sys.stderr)
        return 1

    if args.cluster == "density":
        from review_recommender_tpu_torch.topics.density import density_cluster

        topic_ids, dinfo = density_cluster(emb, min_samples=args.min_samples,
                                           min_cluster_size=args.min_cluster_size,
                                           device=args.device)
        k = int(dinfo["n_clusters"])
        print(f"density: {k} clusters, {dinfo['noise']} noise reviews "
              f"(eps={dinfo['eps']:.4f})", file=sys.stderr)
        if k == 0:
            print("topics: density clustering found no clusters (corpus too sparse for "
                  f"min_cluster_size={args.min_cluster_size})", file=sys.stderr)
            return 1
        centers = np.zeros((k, emb.shape[1]), np.float32)
        for tid in range(k):
            c = emb[topic_ids == tid].mean(axis=0)
            centers[tid] = c / max(float(np.linalg.norm(c)), 1e-12)
        # noise (-1) leaves here: naming, metrics and cards see clustered reviews only
        clustered = topic_ids >= 0
        emb = emb[clustered]
        stars = stars[clustered]
        texts = [texts[i] for i in np.flatnonzero(clustered)]
        topic_ids = topic_ids[clustered]
    else:
        k = min(int(args.k), len(texts))
        topic_ids, centers = spherical_kmeans(emb, k=k, iters=args.iters, seed=args.seed,
                                              device=args.device)

    labels = name_topics(tfidf_topic_terms(texts, topic_ids))
    topics = []
    for tid in sorted(labels):  # topics under --min-reviews are dropped
        mask = topic_ids == tid
        n = int(mask.sum())
        if n < args.min_reviews:
            continue
        topics.append({
            "topic_id": int(tid),
            "label": labels[tid],
            "aspect": map_label_to_aspect(labels[tid]),
            "n_reviews": n,
            "quotes": pick_quotes([texts[i] for i in np.flatnonzero(mask)], emb[mask],
                                  centers[tid], n_quotes=args.n_quotes),
        })

    # an LLM's names over the rolled-up topics; the TF-IDF labels stay the fallback
    llm_aspects = None
    if args.llm:
        from review_recommender_tpu_torch.topics.llm_clients import (
            OllamaClient,
            from_spec,
            label_topics,
        )

        client = from_spec(args.llm, model=args.llm_model)
        if isinstance(client, OllamaClient):
            if not client.ping():
                print(f"topics: can't reach Ollama at {client.host} (start it with "
                      "'ollama serve')", file=sys.stderr)
                return 1
            client.ensure_model()
        cache = args.llm_cache or str(Path(args.out) / "_llm_topic_cache.json")
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        metas = label_topics(client, {t["topic_id"]: t["quotes"] for t in topics},
                             cache_path=cache)
        llm_aspects = {}
        for t in topics:
            meta = metas.get(t["topic_id"])
            if not meta:
                continue
            t["label"] = meta["topic_label"]
            t["aspect"] = meta["aspect"].lower()
            t["rationale"] = meta.get("rationale", "")
            llm_aspects[t["topic_id"]] = t["aspect"]
        labels = {**labels, **{t["topic_id"]: t["label"] for t in topics}}
        # one vocabulary per run: topics without an LLM answer map into the
        # LLM taxonomy, not the rule-based one
        rule_to_llm = {"price": "pricing", "shipping": "shipping", "quality": "quality",
                       "usability": "usability"}
        for tid, label in labels.items():
            if tid not in llm_aspects:
                llm_aspects[tid] = rule_to_llm.get(map_label_to_aspect(label), "misc")

    metrics = aspect_metrics(topic_ids, stars, labels, aspects=llm_aspects)

    if args.bench:
        report = benchmark_generator(
            topics, configs={"default": {}, "fast": {"n_quotes": 1, "max_chars": 120}},
            n_topics=args.sample_bench, total_topics=len(topics))
        print(json.dumps({"n_topics": len(topics), "configs": report}, indent=2))
        return 0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cards = generate_topic_cards(topics, out / "topic_cards.jsonl",
                                 parquet_out=out / "topic_cards.parquet")
    (out / "aspect_metrics.json").write_text(json.dumps(metrics, indent=2))
    write = parquet_writer(out / "topics.parquet")
    if write is not None:
        write([{k2: t[k2] for k2 in ("topic_id", "label", "aspect", "n_reviews")}
               for t in topics])
    print(f"{len(cards)} topic cards -> {out}/topic_cards.jsonl "
          f"(+parquet, aspects in aspect_metrics.json)")
    for row in metrics[:5]:
        print(f"  aspect={row['aspect']:<12} n={row['n_reviews']:<6} "
              f"avg_stars={row['avg_stars']} lost={row['lost_rating']}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rrt", description="review-recommender CLI (PyTorch port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = config
    pools = [None, "auto", "exact", "striped", "ivf"]

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device of the engine and towers (default cuda)")

    s = sub.add_parser("search", help="run one query")
    s.add_argument("query")
    s.add_argument("--index-dir", required=True)
    s.add_argument("--k", type=int, default=c.DEFAULT_K)
    s.add_argument("--rerank-k", type=int, default=0)
    s.add_argument("--w-dense", type=float, default=c.DEFAULT_W_DENSE)
    s.add_argument("--w-bm25", type=float, default=c.DEFAULT_W_BM25)
    s.add_argument("--w-rerank", type=float, default=c.DEFAULT_W_RERANK)
    s.add_argument("--w-prior", type=float, default=c.DEFAULT_W_PRIOR)
    s.add_argument("--w-best", type=float, default=c.DEFAULT_W_BEST)
    s.add_argument("--prior-c", type=float, default=c.DEFAULT_PRIOR_C)
    s.add_argument("--min-reviews", type=int, default=c.DEFAULT_MIN_REVIEWS)
    s.add_argument("--gate-penalty", type=float, default=c.DEFAULT_GATE_PENALTY)
    s.add_argument("--gate-mode", default=None, choices=[None, "host", "device"])
    s.add_argument("--dense-pool", default=None, choices=pools,
                   help="exact, striped or ivf stage-A pool (default: DENSE_POOL_MODE, "
                        "auto = striped from DENSE_POOL_AUTO_MIN padded rows up)")
    s.add_argument("--snippets", action="store_true")
    s.add_argument("--json-out")
    device_arg(s)
    s.set_defaults(fn=cmd_search)

    v = sub.add_parser("serve", help="start the HTTP API")
    v.add_argument("--index-dir", required=True)
    v.add_argument("--host", default=c.APP_HOST)
    v.add_argument("--port", type=int, default=c.APP_PORT, help="0 takes a free port")
    v.add_argument("--gate-mode", default=None)
    v.add_argument("--dense-pool", default=None, choices=pools)
    v.add_argument("--with-rerank", action="store_true",
                   help="load the cross-encoder for rerank_k>0 requests")
    v.add_argument("--shards", type=int, default=None,
                   help="corpus shards (default MESH_SHARDS; above 1 is not ported yet)")
    v.add_argument("--native", action="store_true",
                   help="the C++ epoll front end (native/server.cc; also SERVE_NATIVE)")
    device_arg(v)
    v.set_defaults(fn=cmd_serve)

    a = sub.add_parser("audit", help="validate index artifacts")
    a.add_argument("--index-dir", required=True)
    device_arg(a)
    a.set_defaults(fn=cmd_audit)

    h = sub.add_parser("health", help="probe a running server")
    h.add_argument("--url", default=f"http://localhost:{c.APP_PORT}")
    h.add_argument("--timeout", type=float, default=5.0)
    h.set_defaults(fn=cmd_health)

    b = sub.add_parser("bench", help="QPS/p50 on the loaded index")
    b.add_argument("--index-dir", required=True)
    b.add_argument("--n-queries", type=int, default=64)
    b.add_argument("--dense-pool", default=None, choices=pools)
    device_arg(b)
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval", help="IR metrics over judged queries (JSONL) on an index")
    e.add_argument("--index-dir", required=True)
    e.add_argument("--queries", required=True, help='JSONL: {"query", "relevant_skus"} per line')
    e.add_argument("--method", default=None,
                   help="run one BENCHMARK_CONFIGS method instead of all 4")
    e.add_argument("--out", default=None, help="also write benchmark_results.json/CSV here")
    e.add_argument("--gate-mode", default=None)
    e.add_argument("--dense-pool", default=None, choices=pools)
    e.add_argument("--no-warmup", action="store_true")
    device_arg(e)
    e.set_defaults(fn=cmd_eval)

    t = sub.add_parser("train", help="domain-adapt the towers on the index's reviews")
    t.add_argument("--index-dir", required=True)
    t.add_argument("--out", required=True, help="output dir; writes biencoder/ (+ crossencoder/)")
    t.add_argument("--cross", action="store_true", help="also train the rerank cross-encoder")
    t.add_argument("--epochs", type=int, default=2)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--max-len", type=int, default=96)
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--pairs-per-product", type=int, default=4)
    t.add_argument("--negatives", type=int, default=3)
    t.add_argument("--vocab-size", type=int, default=8192,
                   help="hash-tokenizer id space (from-scratch towers)")
    t.add_argument("--hidden", type=int, default=256)
    t.add_argument("--head-dim", type=int, default=64,
                   help="attention head dim of from-scratch towers")
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--mlm-steps", type=int, default=0,
                   help="MLM-pretrain a trunk on the corpus docs for N steps first "
                        "(a from-scratch cross-encoder needs it to learn)")
    t.add_argument("--resume", action="store_true",
                   help="restore the stage checkpoints in --out and continue")
    t.add_argument("--checkpoint-every", type=int, default=200,
                   help="save each stage's checkpoint every N steps (0 = at stage end)")
    device_arg(t)
    t.set_defaults(fn=cmd_train)

    imp = sub.add_parser("import", help="convert a reference deployment's data dir into an "
                                        "index bundle (product_emb.npy + product_emb_meta "
                                        "[+ product_bm25.pkl + reviews_with_embeddings])")
    imp.add_argument("--data-dir", required=True, help="local dir or fsspec URL (hf://...)")
    imp.add_argument("--out", required=True, help="bundle output dir")
    imp.add_argument("--doc-terms-cap", type=int, default=None,
                     help="postings width (default DOC_TERMS_CAP; 0 = auto)")
    imp.add_argument("--no-reviews", action="store_true",
                     help="skip reviews_with_embeddings")
    imp.set_defaults(fn=cmd_import)

    tp = sub.add_parser("topics", help="cluster reviews into named topics + cards")
    tp.add_argument("--index-dir", required=True)
    tp.add_argument("--out", default="topics_out",
                    help="output dir (cards JSONL/parquet, aspect metrics)")
    tp.add_argument("--k", type=int, default=24, help="number of clusters")
    tp.add_argument("--iters", type=int, default=25)
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--cluster", choices=("kmeans", "density"), default="kmeans",
                    help="kmeans: fixed-K spherical k-means; density: HDBSCAN-semantics "
                         "kNN-graph clustering (data-derived count, noise=-1)")
    tp.add_argument("--min-samples", type=int, default=10,
                    help="density: core-point neighbour count")
    tp.add_argument("--min-cluster-size", type=int, default=40,
                    help="density: dissolve smaller clusters into noise")
    tp.add_argument("--shards", type=int, default=None,
                    help="density: corpus shards of the kNN graph (above 1 is not ported yet)")
    tp.add_argument("--min-reviews", type=int, default=5, help="drop topics smaller than this")
    tp.add_argument("--n-quotes", type=int, default=3)
    tp.add_argument("--bench", action="store_true",
                    help="time card generation + project the full-run ETA instead of "
                         "writing cards")
    tp.add_argument("--sample-bench", type=int, default=8, help="topics to time with --bench")
    tp.add_argument("--llm", default=None,
                    help="LLM naming backend: dry | ollama[:url] | openai[:url] (TF-IDF "
                         "naming when omitted)")
    tp.add_argument("--llm-model", default=None,
                    help="model name for --llm (default: OLLAMA_MODEL / LLM_MODEL env)")
    tp.add_argument("--llm-cache", default=None,
                    help="resume cache path (default: OUT/_llm_topic_cache.json)")
    device_arg(tp)
    tp.set_defaults(fn=cmd_topics)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    config.validate()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
