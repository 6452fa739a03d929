"""The quality table on the port: build a themed synthetic corpus with
planted relevant families, index it, run the four method configs and
write the README table, with the bow lane's rerank or a cross-encoder
trained on the corpus (the trained lane).

Counterpart of `examples/quality_table.py` (its main, :318-409), with its
own copy of the corpus generator (`_pseudo_word`, `build_corpus`,
`keyword_query`, :53-160; a test holds the copy equal to the example) and
of `examples/rerank_experiments.py:make_family_positives`:

  - corpus: `themes` x `per_theme` products (80 x 640 = 51,200 by
    default), each theme a bank of 14 words from a shared pseudo-word
    vocabulary, plus filler. Each of `queries` anchor products gets 4
    near-duplicates in its theme that keep ~60% of its tokens; its query
    is 5 of its keywords, and exactly the 5 family members are relevant.
  - dense signal: BowProjectionEncoder(dim=384, seed=7); rerank: the
    idf-weighted OverlapCrossScorer over the index vocabulary (host code,
    as in the JAX lane; no tower, so no attention launch).
  - index: doc_terms_cap=128, pad_multiple=256; engine with gate_mode
    host and the exact pool by default (striped, ivf or ivf:N on request:
    "ivf:128" runs the lane with IVF_NPROBE=128, and the knob is restored
    when the lane ends, where the JAX example leaves it changed). Latencies are warm (one untimed
    query per method first) and include the measured round trip of a
    scalar to the device and back.

The trained lane (`build_trained_towers`, the example's :162-315) keeps
the BoW dense signal and trains the rerank cross-encoder on the corpus,
every document of an eval family held out: a 2-layer trunk (256 wide, 4
heads, vocab 8,192, hash tokenizer) MLM-pretrained for `mlm_steps` (2,000)
at lr 5e-4, grafted into the cross-encoder, then BCE at lr 1e-4 with batch
64: one epoch of easy (random-negative) triples, two of hard ones (2
same-theme negatives and 1 random a positive, plus 2 family-variant
positives a pair). Seeded runs of the two frameworks' optimizers do not
match step for step, so its table is held to the JAX lane's within a band.

Run: python -m review_recommender_tpu_torch.evals.quality_table --lane bow|trained
     [--themes 80 --per-theme 640 --queries 60 --seed 0]
     [--out build/quality_table/<lane>] [--device cuda] [--dense-pool ivf:64]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

FILLER = ("great good product quality really nice love works perfect "
          "recommend value price happy bought using daily sturdy arrived "
          "fast packaging exactly described month year still").split()

_CONS = list("bcdfghjklmnpqrstvwz")
_VOW = list("aeiou")

BOW_DIM, BOW_SEED = 384, 7
TRAINED_VOCAB, TRAINED_BATCH = 8192, 64
DOC_TERMS_CAP, PAD_MULTIPLE = 128, 256
GATE_MODE, DENSE_POOL = "host", "exact"


def _pseudo_word(rng) -> str:
    n = int(rng.integers(2, 5))
    return "".join(
        _CONS[int(rng.integers(len(_CONS)))] + _VOW[int(rng.integers(len(_VOW)))]
        for _ in range(n)
    )


def build_corpus(n_themes: int, per_theme: int, n_queries: int, family: int = 5,
                 seed: int = 0):
    """(products, queries): product row dicts (sku, agg_text, n_reviews,
    avg_stars) and judged queries (id, query, relevant_skus), draw for draw
    as examples/quality_table.py:build_corpus without paraphrase."""
    rng = np.random.default_rng(seed)
    vocab = sorted({_pseudo_word(rng) for _ in range(3000)})
    theme_words = [list(rng.choice(vocab, size=14, replace=False)) for _ in range(n_themes)]

    products = []
    for t in range(n_themes):
        words = theme_words[t]
        for j in range(per_theme):
            n_words = int(rng.integers(24, 64))
            toks = (list(rng.choice(words, size=n_words // 2))
                    + list(rng.choice(FILLER, size=n_words // 4))
                    + list(rng.choice(vocab, size=n_words // 4)))
            rng.shuffle(toks)
            products.append({
                "sku": f"T{t:03d}P{j:04d}",
                "agg_text": " ".join(toks),
                "n_reviews": float(rng.integers(3, 300)),
                "avg_stars": float(np.clip(rng.normal(4.1, 0.6), 1, 5)),
            })

    # anchor families: the anchor + (family - 1) near-duplicates that keep
    # ~60% of its tokens, written over other products of its theme
    queries = []
    anchor_rows = rng.choice(len(products), size=n_queries, replace=False)
    for qi, row in enumerate(anchor_rows):
        anchor = products[int(row)]
        toks = anchor["agg_text"].split()
        fam = [anchor["sku"]]
        theme = int(anchor["sku"][1:4])
        for v in range(family - 1):
            victim = theme * per_theme + int(rng.integers(per_theme))
            while victim == int(row) or "V" in products[victim]["sku"]:
                victim = theme * per_theme + int(rng.integers(per_theme))
            keep = rng.random(len(toks)) < 0.6
            vtoks = ([t for t, k in zip(toks, keep) if k]
                     + list(rng.choice(theme_words[theme], size=max(1, (~keep).sum() // 2))))
            rng.shuffle(vtoks)
            sku = f"T{theme:03d}V{qi:03d}{v}"
            products[victim] = {**products[victim], "sku": sku, "agg_text": " ".join(vtoks)}
            fam.append(sku)
        kw = sorted({t for t in toks if len(t) >= 4})
        pick = rng.choice(len(kw), size=min(5, len(kw)), replace=False)
        queries.append({
            "id": f"q{qi:03d}",
            "query": " ".join(kw[i] for i in sorted(pick)),
            "relevant_skus": sorted(set(fam)),
        })
    return products, queries


def keyword_query(rng, text):
    """A 5-keyword query for a document, mined as the eval queries are
    (sorted unique tokens of >= 4 characters, 5 drawn, joined in sorted
    order); None under 5 such tokens. One rng.choice per usable text."""
    toks = sorted({t for t in text.split() if len(t) >= 4})
    if len(toks) < 5:
        return None
    pick = rng.choice(len(toks), size=5, replace=False)
    return " ".join(toks[j] for j in sorted(pick))


def make_family_positives(pos_text, theme_vocab, rng, n_variants=2):
    """Near-duplicates of a positive made as the corpus's family variants
    are (keep ~60% of its tokens, pad with theme words), so training sees
    positives with the ~3/5 keyword coverage of the eval families."""
    toks = pos_text.split()
    out = []
    for _ in range(n_variants):
        keep = rng.random(len(toks)) < 0.6
        kept = [t for t, k in zip(toks, keep) if k]
        pad = list(rng.choice(theme_vocab, size=max(1, int((~keep).sum()) // 2)))
        v = kept + pad
        rng.shuffle(v)
        out.append(" ".join(v))
    return out


def build_trained_towers(products, queries, *, seed: int = 0, n_pairs: int = 8192,
                         mlm_steps: int = 2000, device="cuda", log=print):
    """(BoW encoder, trained CrossEncoder) as the JAX lane trains them:
    MLM-pretrain the trunk on the training documents, mine pairs and easy
    and hard triples (plus family-variant positives), graft the trunk into
    the cross-encoder, then the easy and the hard BCE curriculum. Every
    document of an eval family is held out of all training. Each stage
    draws from its own seeded numpy Generator, in the JAX lane's order."""
    from collections import defaultdict

    from review_recommender_tpu_torch.models.bert import BertConfig, init_state_dict
    from review_recommender_tpu_torch.models.bow import BowProjectionEncoder
    from review_recommender_tpu_torch.models.encoder import CrossEncoder
    from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
    from review_recommender_tpu_torch.train import (
        CrossEncoderTrainer,
        CrossTrainConfig,
        MLMTrainConfig,
        MLMTrainer,
        init_mlm,
        mine_triples,
        pretrain_mlm,
        train_crossencoder,
    )
    from review_recommender_tpu_torch.train.cross_encoder import warm_start_from_biencoder

    fam: set = set()
    for q in queries:
        fam.update(q["relevant_skus"])
    train_docs = [p for p in products if p["sku"] not in fam]
    texts = [p["agg_text"] for p in train_docs]
    tok = HashTokenizer(vocab_size=TRAINED_VOCAB)
    cfg = BertConfig(vocab_size=TRAINED_VOCAB, hidden_size=256, num_layers=2, num_heads=4,
                     intermediate_size=512, max_position=128)
    batch = TRAINED_BATCH

    t0 = time.perf_counter()
    mtr = MLMTrainer(cfg, init_mlm(cfg, seed=seed)[1], device=device,
                     train_cfg=MLMTrainConfig(learning_rate=5e-4, seed=seed,
                                              total_steps=mlm_steps))
    hist = pretrain_mlm(mtr, texts, tok, batch_size=batch, steps=mlm_steps, max_len=96,
                        seed=seed)
    log(f"mlm pretrain: {mlm_steps} steps, masked acc "
        f"{np.mean([m['masked_acc'] for m in hist[-100:]]):.3f} "
        f"({time.perf_counter() - t0:.1f}s)")

    rng = np.random.default_rng(seed + 101)
    sample = rng.choice(len(train_docs), size=min(n_pairs, len(train_docs)), replace=False)
    pairs, theme_of = [], {}
    for i in sample:
        p = train_docs[int(i)]
        q = keyword_query(rng, p["agg_text"])
        if q is None:
            continue
        pairs.append((q, p["agg_text"]))
        theme_of[q] = int(p["sku"][1:4])

    easy = mine_triples(pairs, texts, n_negatives=1, seed=seed + 7)
    by_theme = defaultdict(list)
    for p in train_docs:
        by_theme[int(p["sku"][1:4])].append(p["agg_text"])
    neg_rng = np.random.default_rng(seed + 202)

    def same_theme_negatives(query, k):
        docs = by_theme[theme_of[query]]
        n = min(2, k, len(docs))  # 2 hard + 1 random a positive
        idx = neg_rng.choice(len(docs), size=n, replace=False)
        return [docs[int(j)] for j in idx]

    hard = mine_triples(pairs, texts, n_negatives=3, hard_negative_fn=same_theme_negatives,
                        seed=seed + 303)
    by_theme_words = {t: sorted({w for d in docs for w in d.split()})
                      for t, docs in by_theme.items()}
    fam_rng = np.random.default_rng(seed + 404)
    extra = [(q, v, 1.0) for q, pos in pairs
             for v in make_family_positives(pos, by_theme_words[theme_of[q]], fam_rng,
                                            n_variants=2)]
    hard = list(hard) + extra
    log(f"+{len(extra)} family-variant positives ({len(hard)} hard triples)")

    t0 = time.perf_counter()
    params_xe = warm_start_from_biencoder(init_state_dict(cfg, "crossencoder", seed),
                                          mtr.params)
    tr = CrossEncoderTrainer(cfg, params_xe, device=device,
                             train_cfg=CrossTrainConfig(learning_rate=1e-4, seed=seed,
                                                        total_steps=len(easy) // batch))
    h1 = train_crossencoder(tr, easy, tok, batch_size=batch, epochs=1, max_len=128, seed=seed)
    tr2 = CrossEncoderTrainer(cfg, tr.params, device=device,
                              train_cfg=CrossTrainConfig(learning_rate=1e-4, seed=seed,
                                                         total_steps=(len(hard) // batch) * 2))
    h2 = train_crossencoder(tr2, hard, tok, batch_size=batch, epochs=2, max_len=128, seed=seed)
    log(f"cross-encoder: easy acc {np.mean([m['acc'] for m in h1[-50:]]):.3f} (base 0.5), "
        f"hard acc {np.mean([m['acc'] for m in h2[-50:]]):.3f} (base 0.75) "
        f"({time.perf_counter() - t0:.1f}s)")
    xe = CrossEncoder(cfg, tr2.params, tok, device=device, max_len=128)
    return BowProjectionEncoder(dim=BOW_DIM, seed=BOW_SEED), xe


def overlap_scorer(products):
    """The lane's rerank: OverlapCrossScorer weighted by the index idf."""
    from review_recommender_tpu_torch.models.bow import OverlapCrossScorer

    return OverlapCrossScorer(idf={t: float(products.idf[i]) for t, i in products.vocab.items()})


def run_lane(bundle, encoder, queries, device="cuda", gate_mode=GATE_MODE,
             dense_pool=DENSE_POOL, cross_encoder=None):
    """The lane on a built or loaded bundle: an engine with the encoder's
    dense signal and the rerank of `cross_encoder` (the trained lane's) or
    else the overlap scorer, and run_performance_benchmark of the four
    configs over `queries`, warm, with the device round trip measured.
    dense_pool "ivf:N" sets IVF_NPROBE=N for this lane only. Returns
    (engine, results)."""
    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.evals.benchmark import (
        measure_rpc_floor,
        run_performance_benchmark,
    )

    pool_mode, _, nprobe = dense_pool.partition(":")
    shadowed = vars(config).get("IVF_NPROBE")  # an instance value over the class's
    if nprobe:
        config.IVF_NPROBE = int(nprobe)
    try:
        cross = cross_encoder if cross_encoder is not None else overlap_scorer(bundle.products)
        engine = SearchEngine(bundle, device=device, query_encoder=encoder,
                              cross_encoder=cross,
                              gate_mode=gate_mode, dense_pool=pool_mode)
        results = run_performance_benchmark(engine.run_search, queries, warmup=True,
                                            rpc_floor_ms=measure_rpc_floor(engine.device))
    finally:  # the knob as it was before the lane
        if shadowed is None:
            vars(config).pop("IVF_NPROBE", None)
        else:
            config.IVF_NPROBE = shadowed
    return engine, results


def _pool_spec(spec: str) -> str:
    """argparse type of --dense-pool: exact, striped, ivf or ivf:N."""
    mode, sep, nprobe = spec.partition(":")
    if mode not in ("exact", "striped", "ivf") or (sep and not (mode == "ivf"
                                                               and nprobe.isdigit()
                                                               and int(nprobe) > 0)):
        raise argparse.ArgumentTypeError(f"expected exact, striped, ivf or ivf:N, got {spec!r}")
    return spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--themes", type=int, default=80)
    ap.add_argument("--per-theme", type=int, default=640)
    ap.add_argument("--queries", type=int, default=60)
    ap.add_argument("--out", default=None, help="default build/quality_table/<lane>")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gate-mode", default=GATE_MODE, choices=["host", "device"])
    ap.add_argument("--dense-pool", default=DENSE_POOL, type=_pool_spec,
                    help="exact, striped, ivf, or ivf:N (IVF_NPROBE=N for the lane)")
    ap.add_argument("--lane", default="bow", choices=["bow", "trained"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = args.out or f"build/quality_table/{args.lane}"

    from review_recommender_tpu_torch.evals.benchmark import (
        format_results_table,
        save_benchmark_results,
    )
    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.models.bow import BowProjectionEncoder

    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    products, queries = build_corpus(args.themes, args.per_theme, args.queries, seed=args.seed)
    log(f"corpus: {len(products)} docs, {len(queries)} judged queries "
        f"({time.perf_counter() - t0:.1f}s)")
    cross = None
    if args.lane == "trained":
        encoder, cross = build_trained_towers(products, queries, seed=args.seed,
                                              device=args.device, log=log)
    else:
        encoder = BowProjectionEncoder(dim=BOW_DIM, seed=BOW_SEED)
    t0 = time.perf_counter()
    emb = encoder.encode([p["agg_text"] for p in products])
    log(f"encode: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    bundle = build_bundle_from_products(products, emb, doc_terms_cap=DOC_TERMS_CAP,
                                        pad_multiple=PAD_MULTIPLE)
    log(f"index: {time.perf_counter() - t0:.1f}s")
    _engine, results = run_lane(bundle, encoder, queries, args.device, args.gate_mode,
                                args.dense_pool, cross_encoder=cross)
    save_benchmark_results(results, out)
    print(format_results_table(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
