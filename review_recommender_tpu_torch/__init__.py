"""review_recommender_tpu_torch — the hybrid query path in PyTorch/CUDA.

A port of `review_recommender_tpu` (the JAX/Pallas reference, which stays
in the repository unchanged) to PyTorch on an NVIDIA Hopper GPU. Module
names mirror the JAX package so each counterpart is easy to find:

    config        the knobs the engine reads (environment variables, the
                  JAX package's names and defaults)
    device        explicit device resolution (no silent CPU fallback)
    utils         text + numeric helpers, stage timer
    index         numpy index dataclasses, the index builder (products ->
                  bundle), bundle save/load (numpy host columns, a JAX
                  bundle's parquet where pyarrow is installed), synthetic
                  corpus, BM25 stats, rerank tokens, the review index
    ops           dense pool (exact, striped, IVF; float or int8 corpus),
                  BM25, gate, fusion, review segment max (plain torch); the
                  fused attention, the full-corpus BM25 scans and the fused
                  stage A (hand-written CUDA kernels, csrc/)
    models        BERT towers as nn.Modules (bf16 serving weights, or f32
                  masters for training), HF and flax <-> torch weight
                  mapping, checkpoint loading (HF snapshots, native towers)
                  and native tower saving,
                  WordPiece and hash tokenizers, bucketed bi-/cross-encoder
                  wrappers, the bag-of-words encoder and overlap scorer
    train         contrastive bi-encoder, cross-encoder and MLM trainers on
                  one device with the JAX trainers' optax chain; pair,
                  triple and mask mining
    topics        spherical k-means (the IVF pool's clustering)
    engine        featurizer, host hooks, snippet recovery, SearchEngine:
                  run_search, the fused and batched forms, query_e2e,
                  query_rerank_batched_pw, search_bm25 and search_dense
    native        the C++ host library (document tokenizer and postings,
                  query featurizer, epoll HTTP front end), built with g++ on
                  first use, bound by ctypes
    serve         the CLI (`train` included), the bundle audit, the HTTP API: stdlib server
                  with the micro-batcher, the native front end, the web page
    evals         IR metrics, the method configs and judged queries, the
                  benchmark runner, the quality table's bow and trained
                  lanes

The package imports torch, numpy and the standard library, and nothing of
the JAX package, jax, flax, msgpack, safetensors, pandas or pyarrow (index/io.py imports pyarrow
only to read a JAX bundle's parquet files). Its entry points
(`SearchEngine`, `BiEncoder`, `CrossEncoder`, the trainers, the CLI) run on "cuda"
unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
