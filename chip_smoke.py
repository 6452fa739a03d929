#!/usr/bin/env python3
"""Drive the PyTorch port (review_recommender_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
line, and nothing is caught and passed over:

  1 device   torch.cuda must be available; card name and power limit
             (nvidia-smi), torch/CUDA/nvcc versions
  2 build    compile csrc/*.cu with nvcc for sm_90a (build/torch_kernels/) and,
             alongside, the native host library (native/*.cc with g++:
             build/torch_native/): its path, build seconds, g++ --version
  3 kernel   the fused-attention kernel against its plain torch version at
             the main path's shapes: max abs error (tolerance 2e-2, bf16) and
             the median of 50 CUDA-event-timed runs of each, from an idle
             device and behind a device spin; beside them
             scaled_dot_product_attention with the key bias as an additive
             mask (a yardstick the port never calls: library_ms, its error
             against the plain version, the kernel's speed-up over it), the
             roofline bound and the exponential floor (exp_floor_ms: B*H*S*S
             exponentials at the MUFU rate)
  4 slice    SearchEngine.run_search at full width: 200k-doc synthetic corpus
             (D=384, 64 Zipf terms/doc, vocab 30k, 2000-char texts), random
             bge-small bi-encoder and MiniLM-L6 cross-encoder in bf16,
             100 queries at rerank_k=0 and rerank_k=50; kernel launch counts
             (12 per query without rerank, 18 with), every rerank query again
             on reference attention (the largest _final difference over all
             100), latency percentiles, stage split and peak device memory
  5 bm25_kernel  the packed and unpacked BM25 kernels against their plain
             torch versions at (N=200,192, L=64, Q=32) and (N=1,000,448,
             L=512, Q=32), postings drawn on the card from a seeded
             torch.Generator (tf >= 128 lanes, PAD query slots): bitwise-equal
             share, max abs/rel error (tolerance 1e-6 relative, bitwise
             expected), top-100 ids, medians of 50 CUDA-event-timed runs
             (L2 warm, L2 flushed, and from an idle device), the bytes bound
             and its share of the cold time, the issue-slot share of the
             kernels' SASS instructions per posting; then both kernels at
             Q=128 on 200k (two launches of 64 slots each), bitwise equal to
             their plain versions
  6 bm25_slice   SearchEngine.search_bm25 on phase 4's corpus, 100 queries,
             k=10, three bundles: (a) eager -> packed kernel, (b) classic ->
             packed kernel, (c) classic with one tf of 300 -> unpacked
             kernel; exact launch counts (100 per bundle, no plain-version
             call), a kernel-vs-plain cross-check on two queries, latency
             percentiles of a first pass over unseen queries and of a
             repeat pass, peak device memory, the profiler window's device
             time split into scan, sort and the rest; search_dense against
             dense_scores + stable_topk. Every engine runs the native
             featurizer (printed; the Python route fails the phase)
  7 batched_slice  the batched fused query on phase 4's engine, 256 queries
             as bench.py:_queries draws them, pool 150, k 10, the bench's
             fusion weights: query_fused_batched QPS over 10 reps
             (bench.py:_batched_qps) and per-batch p50/p90 at B=32 and
             B=128; query_fused_batched_pw at B=32 with 4 knob sets in
             turn; query_fused1 request-response p50/p90 at B=1; every
             batched row against query_fused of its query (near-tie swaps
             within 1e-3 only); no kernel launch (the engine does not route
             through stage A); a profiler window; peak device memory; the
             native featurizer, as in phase 6
  8 stage_a  the fused stage-A kernel as bench.py's stage-A section drives
             it: phase 4's bf16 corpus (98 tiles of 2048 rows, the tail
             masked), eager BM25, B=32 with per-query term ids, pool 150.
             The tile-pass kernel (bf16: csrc/stage_a_wgmma.cu) against its
             plain version (scores within 1e-5, a differing id only at a
             near tie), stage_a_fused against stage_a_fused_reference, a
             2-tile case with an exhausted tile (ids equal, repeats
             included), medians of 50 CUDA-event-timed runs behind a device
             spin (plain, stage_a_fused, the exact stage A); the kernel at
             B = 1, 8, 32, 128 behind the spin and behind an L2 flush, each
             with its bound (bytes or operations, whichever is larger) and
             share of it; the f32 route (the CUDA-core kernel) at B=32 on
             the same corpus in f32, against its plain version and timed;
             then the counted main path: stage_a_fused on the 256 queries
             in batches of 32, with pool recall against the exact stage A
             (>= 0.99), every launch on the bf16 kernel
  9 e2e_slice  query_e2e on phase 4's engine and towers (bench.py's
             fabricated doc tokens: width 254, 128 live): 100 queries at
             rr_k=0 and rr_k=50, p50/p90, exactly 12 and 18 attention launches
             per query and no reference-attention call; every query again on
             reference attention (the largest _final difference over all 100,
             ROADMAP F3's margin); host preparation per query and a profiler window;
             then query_e2e against run_search with the same towers on a
             4,096-product corpus of 600-character texts tokenized by
             attach_rerank_tokens (no truncation)
 10 rerank_coalesce  bench.py's coalesced-rerank measure: 16 riders at
             rerank_k=50 with the bench's rerank weights, one
             query_rerank_batched_pw call against 16 one-rider calls,
             interleaved, 3 repeats, medians; attention launches per call
             (6 per chunk of 64 pairs); every rider against run_search
 11 snippets  a 1,000,000-review table on phase 4's corpus (products drawn
             in proportion to n_reviews, seeded unit rows, 768 MB in bf16 on
             the card, stars with 1% NaN): run_search(use_snips=True) at
             max_scan 0 and -1 (100 queries, p50/p90, stage split),
             query_fused_batched with snippets at B=32, the review pass alone
             (profiler and CUDA events, B=1 and 32, with its bytes bound), and
             the device segment max against numpy on 3 queries (1e-5)
 12 serve    both HTTP front ends on phase 4's engine. The stdlib server
             (serve/api.py, micro-batcher): /healthz, /readyz after warmup,
             /debug/info, /metrics; 256 /search requests without qvec (the
             server encodes: 12 attention launches each) from 32 closed-loop
             clients, bench.py's queries and fusion weights, k=10: requests/s,
             p50/p90/p99, windows and riders per window, every answer against
             query_fused of its query (near-tie swaps within 1e-3 only); 16
             concurrent rerank riders (phase 10's) in fewer than 16 windows,
             each against run_search; /search_batch of 32 against
             query_fused_batched; /eval of 10 judged queries against IRMetrics
             in process; /debug/trace (its CUDA kernels hold attention); 16
             requests one at a time. Then the native front end
             (serve/native_server.py): the same 256 requests and 16 one at a
             time, whose results and snippets must equal the stdlib server's
             (under load, where windows differ, phase 7's allowance). Host
             featurize time per query, Python and native, unseen then repeat
 13 offline  the offline path at the quality table's published size:
             build_corpus(80 themes x 640, 60 judged queries, seed 0) ->
             BowProjectionEncoder(384, seed 7) -> build_bundle_from_products
             (native tokenizer, doc_terms_cap 128, pad 256) -> save_bundle
             (bytes on disk) -> load_bundle, each timed, the reload bit-equal;
             the bow quality lane on the loaded bundle (host gate, exact pool,
             idf-weighted overlap rerank, no custom kernel) through
             run_performance_benchmark, its 12 numbers (nDCG@10, MRR@10,
             Recall@20 x 4 methods) within 0.01 of the JAX lane's
             (evals_out/bow/benchmark_results.json, read only), per-method
             p50 and QPS; the CLI in process on random bge-small / MiniLM-L6
             towers in bf16: audit, search at rerank_k 50 (exactly 18
             attention launches, rows equal to run_search), bench, eval of
             the 60 judged queries (equal to run_performance_benchmark); the
             CLI as subprocesses: audit, search, and serve on a free port for
             each front end (/healthz, /readyz, one /search, exit 0 on
             SIGTERM); phase 4's 200k bundle saved and loaded (seconds, bytes)
 14 configurations  the serving configurations on phase 4's corpus:
             EMB_DTYPE=int8 engines, exact and striped (init, corpus bytes
             on the card, each pool held bit-equal to the same code on the
             CPU over 16 queries, pool recall against the bf16 exact pool);
             a DENSE_POOL_MODE=ivf engine at the auto sizes on phase 4's
             products with bench.py's clustered rows (seeding and k-means
             seconds, blocks, fill, the init self-check held to
             IVF_SELFCHECK_MIN, recall at nprobe 64 and 256, the true
             block bytes beside the bound and JAX's 1.25x estimate,
             ivf_topk held to its CPU run on the card-built index), then
             the self-check on the isotropic rows (reported); for each
             engine run_search at rerank_k 0 (100 queries, 12 attention
             launches each), search_dense and batched QPS at B=32 and 128
             with peak memory. Towers from disk: the full-size golden's
             weights (tests/golden_utils.py) written as an HF snapshot in
             safetensors (this script's writer, checked against a .bin of
             the same weights), in .bin and as a native tower, with a
             30,522-line WordPiece vocab; each loaded through
             models/load.py (seconds), the bf16 forward on the golden's
             inputs with the CUDA attention and with mha_reference against
             the golden's f32 HF outputs (ROADMAP F3 at the full-size
             layout), forward times at (1, 16), (50, 287), (64, 512);
             run_search at rerank_k 50 on 200k (20 queries, cut from 100:
             WordPiece tokenization of 50 pairs a query; 18 launches each,
             the reference-attention cross-check), and the CLI's
             _load_engine with EMB_MODEL_DIR / RERANK_MODEL_DIR on a saved
             4,096-product bundle (its rerank tokens re-tokenized by the
             loaded cross-encoder), query_e2e and run_search there (20
             queries each, 18 launches each, against each other)
 15 training  `rrt train --cross` in process at full width: the golden's
             bge-small and MiniLM-L6 weights (phase 14's) saved as native
             towers by models/load.py:save_native_tower with a 30,522-line
             WordPiece vocab of the corpus's words, as EMB_MODEL_DIR /
             RERANK_MODEL_DIR, on a 4,096-product bundle of the quality
             table's generator (pseudo-words: mine_pairs keeps letter
             words only, so phase 14's synthetic "t123" texts give no pair)
             with one 10-word review for each of 640 products; batch 32,
             --max-len 128 (the cross-encoder at 256), one epoch, bf16
             compute on f32 masters. Per tower: step ms p50/p90 (CUDA
             events at each optimizer step's end, by torch.optim's global
             post-step hook; the host's p50 between the same calls),
             padded tokens/s, the host's tokenization of one batch, and a
             torch.profiler window of 5 steps: the device's step span,
             busy time, the attention recompute's kernel time, the host
             syncs a step by op (none allowed); peak
             max_memory_allocated; exactly 24 (bi-encoder) and
             6 (cross-encoder) kernel launches a step and as many backward
             recomputes. Then 8 steps on one repeated batch from each
             trained tower (the bi-encoder's loss must fall; all finite),
             the trained towers loaded through models/load.py serving
             run_search at rerank_k 50 (20 queries, 18 launches each) and
             again on reference attention (F3's margin with a trained
             cross-encoder); the quality table's trained lane at the
             published corpus size with its depth cut (200 MLM steps, 1,024
             pairs; printed): its 12 numbers, the three without rerank
             within 0.01 of the bow lane's. Before all that, the attention
             at the four shapes the trainers give it (bi-encoder,
             cross-encoder, the lane's MLM and BCE stages): the kernel
             forward (held to the plain version within 2e-2), the plain
             version, SDPA, and the backward recompute (autograd through
             mha_reference) beside SDPA's forward and backward, each timed
             behind a device spin, with their bounds
 16 topics_import  the topic pipeline and the reference import. The
             review set of topics/density.py's docstring: 300,000 x 384 f32
             rows, 40 planted clusters of 7,250 and 10,000 noise rows, drawn
             as tests/test_density.py:blobs_with_noise draws them (spread
             scaled by sqrt(24/384)). knn_graph on the card at k 17, blocks
             of 1,024 rows, chunks of 32,768 columns: seconds, the
             profiler's device busy share, peak max_memory_allocated, the
             bound 2*N^2*D / 67 TFLOP/s and its share; 1,024 sampled rows
             against one exact full-row product and a stable sort on the
             card, and a 20,000-row subset against the port's CPU path
             (similarities within 1e-5, ids equal but for near ties).
             density_cluster (clusters, noise, eps, core points, the host
             seconds of graph, union-find, border adoption, renumbering,
             purity against the planted clusters) and spherical_kmeans
             (k 24, 25 iterations). rrt topics in process in both lanes
             with --llm dry on a port bundle of every third of those
             reviews (pseudo-word texts per cluster; 4,096 products): save seconds and bytes,
             the TF-IDF naming alone on the density clusters (names all
             distinct), each lane's seconds, cards, labels and aspect rows.
             rrt import of a reference data directory in the numpy form
             written from phase 4's corpus (200,000 products x 384, one
             token per unique term in product_bm25.pkl, 100,000 reviews):
             the imported bundle equal to build_product_index on the same
             columns; then its main path, counted: the CLI's search at
             rerank_k 50 (18 launches) and, on the engine _load_engine
             builds, run_search at rerank_k 0 (12 launches each) and
             search_bm25 (one packed-BM25 launch each) over 20 queries,
             every row equal to the same calls on the in-process bundle

The last two lines are the kernels summary and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports no jax and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

KERNEL_TOL = 2e-2  # bf16: one ulp at magnitude 2-4 (tests/test_attention.py's bound)
FINAL_TOL = 2e-2  # _final with kernel vs reference attention in both bf16 towers
# the rerank batch, the query encode, two other head dims, then query_e2e's
# encode and rerank (287 keys: a ragged last key tile)
SHAPES = [(64, 512, 12, 32), (1, 16, 12, 32), (8, 128, 6, 64), (4, 256, 3, 128),
          (1, 32, 12, 32), (50, 287, 12, 32)]
N_DOCS, DIM, TERMS, VOCAB, TEXT_CHARS = 200_000, 384, 64, 30_000, 2000
# 100 queries per setting: p90 then has 10 samples beyond it
N_QUERIES, K, RERANK_K, REPS = 100, 10, 50, 50
# published H100 SXM dense bf16 peak, HBM3 bandwidth and f32 CUDA-core peak
# (at the 700 W limit)
PEAK_BF16_FLOPS, PEAK_HBM_BYTES, PEAK_FP32_FLOPS = 989e12, 3.35e12, 67e12
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate, same data sheet
# attention's exponentials: 16 MUFU ex2 per SM per clock (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0), 132 SMs at
# the 1.98 GHz maximum boost clock (assumed: the clock under load is not read)
PEAK_EXP_RATE = 132 * 16 * 1.98e9
# BM25 scan instructions per posting, from the SASS of csrc/bm25_full.cu
# (examples/torch_bm25_breakdown.py's "sass" lines: cuobjdump -sass, the
# one-probe posting loop from its head to the batch's last add): 585
# instructions per batch of 32 postings (packed: 8 rows x 4 documents a
# thread) and 485 per chunk of 16 (unpacked: 16 lanes of a thread's row),
# loads, copies and loop bookkeeping included. Neither depends on Q. Each
# takes an issue slot: one warp instruction per scheduler per clock, 132 SMs
# x 4 x 32 lanes at the 1.98 GHz maximum boost clock (assumed: the clock
# under load is not read).
BM25_SASS_PER_POSTING = {"bm25_packed": 585 / 32, "bm25_unpacked": 485 / 16}
PEAK_ISSUE_OPS = 132 * 4 * 32 * 1.98e9
L2_FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
SPIN_CYCLES = 200_000  # ~0.1 ms of device spin: longer than a kernel's host launch
DEV = "cuda"  # the device of the BM25 phases and of phase 13
BM25_SHAPES = [(200_192, 64, 32), (1_000_448, 512, 32)]  # (N, L, Q)
BM25_REL_TOL = 1e-6  # bitwise expected: integer tf_q sums, each step rounded alone
BM25_LONG_Q = 128  # slots past one kernel launch's 64: two launches per call
BM25_TOPN = 100
# phases 7-8: the bench's headline batch (bench.py:506-532)
BENCH_QUERIES, BATCHES, POOL, QPS_REPS = 256, (32, 128), 150, 10
BENCH_W = (0.5, 0.3, 0.0, 0.2, 0.0, 20.0, 8, 1.0)  # FusionWeights.make order
KNOB_SETS = [  # tests/test_batched.py:105-110
    (1.0, 0.0, 0.0, 0.0, 0.0, 20.0, 1.0, 1.0),
    (0.0, 1.0, 0.0, 0.0, 0.0, 20.0, 1.0, 1.0),
    (0.5, 0.3, 0.0, 0.2, 0.0, 20.0, 5.0, 0.3),
    (0.4, 0.2, 0.0, 0.1, 0.0, 10.0, 8.0, 0.5),
]
SINGLE_RTOL, SINGLE_ATOL, NEAR_TIE = 1e-4, 1e-5, 1e-3  # tests/test_batched.py's allowance
STAGE_A_TOL = 1e-5  # bf16 products, exact in f32, summed in another order
STAGE_A_BATCHES = (1, 8, 32, 128)
STAGE_A_MIN_RECALL = 0.99
# phases 9-10: bench.py's e2e tokens (bench.py:464-467) and coalesced-rerank
# settings (bench.py:1336-1400)
DOC_TOKENS, DOC_TOKEN_LEN = 254, 128
RERANK_W = (0.4, 0.25, 0.2, 0.1, 0.0, 20.0, 8.0, 1.0)  # FusionWeights.make order
RERANK_KNOBS = dict(zip(("w_dense", "w_bm25", "w_rerank", "w_prior", "w_best", "prior_C",
                         "min_reviews", "gate_penalty"), RERANK_W))
SMALL_DOCS, SMALL_TEXT_CHARS, SMALL_QUERIES = 4096, 600, 10
RIDERS, COAL_REPS = 16, 3
# phase 11: the review table
N_REVIEWS, SNIP_TOL, SNIP_CHECK_QUERIES = 1_000_000, 1e-5, 3
# phase 12: the HTTP front ends, 256 closed-loop requests from 32 clients
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_SEQUENTIAL, EVAL_QUERIES, TRACE_N = 256, 32, 16, 10, 8
SERVE_KNOBS = dict(zip(RERANK_KNOBS, BENCH_W))  # the bench's fusion weights as /search knobs
# phase 13: the quality table's published size (examples/quality_table.py
# defaults), its metrics and the JAX lane's numbers they are held to
QT_THEMES, QT_PER_THEME, QT_QUERIES, QT_SEED = 80, 640, 60, 0
QT_METRICS, QT_TOL = ("ndcg@10", "mrr", "recall@20"), 0.01
QT_REFERENCE = "evals_out/bow/benchmark_results.json"  # read, never written
REPO_DIR = Path(__file__).resolve().parent
OFFLINE_DIR = REPO_DIR / "build" / "chip_smoke_offline"
# phase 14: the serving configurations. run_search at rerank_k 0 on each
# int8 / IVF engine over CFG_QUERIES queries; CFG_CHECK queries' pools held
# to the plain version on the CPU; IVF pool recall at two probe widths on
# bench.py's clustered geometry (its IVF section: 256 unit centers, noise of
# norm 0.7, seed 7); the loaded towers at rerank_k 50 over TOWER_QUERIES
# queries (cut from 100: host tokenization of 50 2000-character texts per
# query); the full-size golden's manifest and seeds (tests/golden_utils.py)
CFG_QUERIES, CFG_CHECK, IVF_NPROBES = 100, 16, (64, 256)
IVF_CLUSTERS, IVF_NOISE, IVF_SEED = 256, 0.7, 7
TOWER_QUERIES, WP_VOCAB = 20, 30_522
TOWER_DIR = REPO_DIR / "build" / "chip_smoke_towers"
GOLDEN = REPO_DIR / "tests" / "goldens" / "bert_fullsize.npz"
# kind -> (input/output prefix, manifest prefix, weight seed)
GOLDEN_SEEDS = {"biencoder": ("be_", "be_man.", 100), "crossencoder": ("ce_", "ce_man.", 200)}
# phase 15: `rrt train --cross` at full width (bge-small at batch 32 and
# --max-len 128; MiniLM-L6 at sequence 256) on a 4,096-product bundle whose
# first TRAIN_REVIEWED products have a review each (a pair each: ~20
# bi-encoder steps, ~40 cross-encoder steps at one negative a pair); the
# trained lane at the published corpus size with its depth cut
TRAIN_DOCS, TRAIN_THEMES, TRAIN_REVIEWED, TRAIN_REVIEW_WORDS, TRAIN_SEED = 4096, 8, 640, 10, 15
TRAIN_BATCH, TRAIN_MAX_LEN, TRAIN_QUERIES, REPEAT_STEPS = 32, 128, 20, 8
TRAIN_ARGS = ["--epochs", "1", "--batch-size", str(TRAIN_BATCH), "--max-len", str(TRAIN_MAX_LEN),
              "--pairs-per-product", "1", "--negatives", "1", "--lr", "5e-5",
              "--checkpoint-every", "0"]
TRAIN_DIR = REPO_DIR / "build" / "chip_smoke_training"
TRAINED_LANE_MLM_STEPS, TRAINED_LANE_PAIRS = 200, 1024  # published: 2,000 and 8,192
# the attention at the trainers' shapes (B, S, H, D): the bi-encoder's,
# the cross-encoder's, and the trained lane's MLM (a ragged 96-key tile)
# and BCE stages
TRAIN_SHAPES = [(32, 128, 12, 32), (32, 256, 12, 32), (64, 96, 4, 64), (64, 128, 4, 64)]
TRAINED_LANE_JAX = {"ndcg@10": 0.656, "mrr": 0.880, "recall@20": 0.630}  # evals_out/readme_table.md


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(ok: bool, phase: str, msg: str) -> None:
    if not ok:
        raise PhaseError(f"{phase}: {msg}")


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (proc.stdout + proc.stderr).strip()


def phase_device(torch):
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    from review_recommender_tpu_torch import kernels

    nvcc = _run([kernels.nvcc_path(), "--version"]).splitlines()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc[-1] if nvcc else "",
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0))})


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from review_recommender_tpu_torch import kernels, native

    # from the checkout's sources, every run: the host library (featurizer,
    # HTTP front end) with g++ while nvcc builds the kernels
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build, True)
        path = kernels.build(force=True)
        npath = host_lib.result()
    native_s = native.build_info["seconds"]  # a later cached build() resets it
    kernels.load()
    emit({"phase": "build", "library": str(path.relative_to(kernels.PKG_DIR.parent)),
          "seconds": kernels.build_info["seconds"], "cached": kernels.build_info["cached"],
          "flags": kernels.NVCC_FLAGS})
    check(native.native_server_available(), "build", "native library lacks the server")
    gxx = _run([native.CXX, "--version"]).splitlines()
    emit({"phase": "build_native", "library": str(npath.relative_to(kernels.PKG_DIR.parent)),
          "seconds": native_s, "flags": native.CXX_FLAGS,
          "compiler": gxx[0] if gxx else ""})


def _attn_inputs(torch, seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    lens = rng.integers(1, s + 1, size=b)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
    if b > 1:
        bias[-1] = -1e30  # a batch-bucket padding row: every key masked
    return q, k, v, torch.from_numpy(bias).to("cuda")


def _median_ms(torch, fn, reps, before=None):
    """Median CUDA-event time of fn(); `before()` runs outside the timed
    span of each rep (an L2 flush, for a cold-cache time)."""
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _sdpa(torch, q, k, v, bias, h):
    """The library call that computes mha_kernel's function: q/k/v viewed
    as (B, H, S, D), the key bias as an additive mask in the input type."""
    b, s, hd = q.shape
    split = lambda t: t.view(b, s, h, hd // h).transpose(1, 2)
    out = torch.nn.functional.scaled_dot_product_attention(
        split(q), split(k), split(v), attn_mask=bias[:, None, None, :].to(q.dtype))
    return out.transpose(1, 2).reshape(b, s, hd)


def phase_kernel(torch):
    """Each time twice: from an idle device (the host launch included, as in
    earlier runs: ms, plain_ms, library_ms) and queued behind a device spin
    (the device's work only: *device_ms, which the shares use)."""
    from review_recommender_tpu_torch.ops import attention as A

    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    results = []
    for i, (b, s, h, d) in enumerate(SHAPES):
        q, k, v, bias = _attn_inputs(torch, 100 + i, b, s, h, d)
        with torch.inference_mode():
            got = A.mha_kernel(q, k, v, bias, h)
            ref = A.mha_reference(q, k, v, bias, h)
            lib = _sdpa(torch, q, k, v, bias, h)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == torch.bfloat16, "kernel",
                  f"output {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got.float()).all()), "kernel", "non-finite output")
            err = float((got.float() - ref.float()).abs().max())
            lib_err = float((lib.float() - ref.float()).abs().max())
            for _ in range(3):  # warm-up
                A.mha_kernel(q, k, v, bias, h)
                A.mha_reference(q, k, v, bias, h)
                _sdpa(torch, q, k, v, bias, h)
            runs = {"": lambda: A.mha_kernel(q, k, v, bias, h),
                    "plain_": lambda: A.mha_reference(q, k, v, bias, h),
                    "library_": lambda: _sdpa(torch, q, k, v, bias, h)}
            times = {}
            for name, fn in runs.items():
                times[f"{name}ms"] = _median_ms(torch, fn, REPS)
                times[f"{name}device_ms"] = _median_ms(torch, fn, REPS, before=spin)
        flops = A.attention_flops(b, s, h, d)
        nbytes = A.attention_bytes(b, s, h, d, q.element_size())
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        exp_floor_ms = b * h * s * s / PEAK_EXP_RATE * 1e3
        dev = times["device_ms"]
        row = {"B": b, "S": s, "H": h, "D": d, "max_abs_err": err, "tol": KERNEL_TOL, **times,
               "library_max_abs_err": lib_err,
               "speedup_vs_library": times["library_device_ms"] / dev,
               "kernel_tflops": flops / dev / 1e9, "flops": flops, "bytes": nbytes,
               "bound_ms": bound_ms, "roofline_share": bound_ms / dev,
               "bound": "compute" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES
               else "memory", "exp_floor_ms": exp_floor_ms,
               "exp_floor_share": exp_floor_ms / dev, "reps": REPS}
        emit({"phase": "kernel", **row})
        check(err <= KERNEL_TOL, "kernel", f"max abs error {err} > {KERNEL_TOL} at {row}")
        check(lib_err <= KERNEL_TOL, "kernel",
              f"scaled_dot_product_attention differs from the plain version by {lib_err}")
        results.append(row)
    return results


def _bench_queries(n_q, dim, vocab, n_terms=5, seed=42):
    """bench.py:_queries' draws: unit query vectors (n_q, D) f32, term ids
    (n_q, n_terms) int32 and the query strings."""
    rng = np.random.default_rng(seed)
    qvecs = rng.standard_normal((n_q, dim)).astype(np.float32)
    qvecs /= np.linalg.norm(qvecs, axis=1, keepdims=True)
    ids = (rng.zipf(1.3, size=(n_q, n_terms)) % vocab + 1).astype(np.int32)
    return qvecs, ids, [" ".join(f"t{t}" for t in row) for row in ids]


def _queries(n_q, dim, vocab, n_terms=5, seed=42):
    """bench.py:_queries' strings (the bi-encoder encodes them; the drawn
    vectors go unused)."""
    return _bench_queries(n_q, dim, vocab, n_terms, seed)[2]


def _check_rows(rows, phase):
    check(len(rows) == K, phase, f"{len(rows)} rows, expected {K}")
    finals = [r["_final"] for r in rows]
    check(all(np.isfinite(finals)), phase, f"non-finite _final {finals}")
    check(all(a >= b for a, b in zip(finals, finals[1:])), phase, "rows not sorted")


def _profile(torch, run, classify=None):
    """Device busy share of run() under torch.profiler: the union of CUDA
    kernel intervals over the host wall-clock of the window, and the
    kernels that take most device time; with `classify` (kernel name ->
    class), the device time of each class. None when the profiler shows no
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_busy_share": None,
                "note": "profiler recorded no device events: not measured"}
    busy, cur_s, cur_e, by_name = 0.0, spans[0][0], spans[0][1], {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "kernels": len(spans),
           "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top]}
    if classify is not None:
        by_class = {}
        for name, us in by_name.items():
            c = classify(name)
            by_class[c] = by_class.get(c, 0.0) + us / 1e3
        out["device_ms_by_class"] = by_class
    return out


def _bm25_device_class(name: str) -> str:
    """search_bm25's device kernels: the BM25 scan, the stable sort of
    stable_topk (radix-sort passes), or the rest (masking, gathers, copies)."""
    low = name.lower()
    if "bm25" in low:
        return "scan"
    return "sort" if "sort" in low or "radix" in low else "rest"


def _profile_window(torch, engine, queries, rerank_k):
    """_profile over a few run_search queries."""
    def run():
        for q in queries:
            engine.run_search(q, k=K, rerank_k=rerank_k)

    return {"rerank_k": rerank_k, "queries": len(queries), **_profile(torch, run)}


def _tower_times(torch, engine, be, ce, query):
    """Layer metrics: host tokenization of the 50 rerank pairs, and the
    towers' device forward at the main path's shapes (CUDA events)."""
    from review_recommender_tpu_torch.models.tokenizer import encode_seqs, pack_seqs

    rows = engine.run_search(query, k=RERANK_K, rerank_k=0)[0]
    texts = [r["agg_text"][:2000] for r in rows]
    t0 = time.perf_counter()
    seqs = encode_seqs(ce.tokenizer, [query] * len(texts), pairs=texts, max_len=ce.max_len)
    ids, mask, tt = pack_seqs(ce.tokenizer, seqs)
    tok_ms = (time.perf_counter() - t0) * 1e3
    pad = lambda a, b, s: torch.from_numpy(np.pad(a, ((0, b - a.shape[0]), (0, s - a.shape[1]))))
    ce_in = [pad(a, 64, 512).cuda() for a in (ids, mask, tt)]
    be_in = [torch.ones(1, 16, dtype=torch.int32, device="cuda")] * 2
    with torch.inference_mode():
        for _ in range(3):
            ce.model(*ce_in)
            be.model(*be_in)
        ce_ms = _median_ms(torch, lambda: ce.model(*ce_in), 10)
        be_ms = _median_ms(torch, lambda: be.model(*be_in), 20)
    return {"rerank_pairs": len(texts), "pair_tokens_max": int(ids.shape[1]),
            "host_tokenize_ms": tok_ms, "cross_encoder_forward_ms_B64_S512": ce_ms,
            "biencoder_forward_ms_B1_S16": be_ms}


def _synth_doc_tokens(products) -> None:
    """bench.py:_make_e2e_engine's fabricated rerank tokens: seeded ids in
    [5, 30000), width 254, 128 of them live in every row (tokenizing 200k
    2000-character texts on the host would take minutes)."""
    rng = np.random.default_rng(0)
    products.doc_tokens = rng.integers(5, 30000, size=(products.n_padded, DOC_TOKENS),
                                       dtype=np.int32)
    products.doc_token_len = np.full(products.n_padded, DOC_TOKEN_LEN, np.int32)


def _crosscheck(rows_k, rows_r, phase):
    """Two runs of the same queries (kernel against reference attention, or
    two query paths), query by query: the largest _final difference of a
    product in both top-k lists (the margin of ROADMAP F3), and the rank-wise one. A
    product in one list only must be a near tie at the cut: its final
    within FINAL_TOL of the other list's last. Emits before it checks."""
    worst, worst_rank, swapped, cut = 0.0, 0.0, [], []
    for i, (rk, rr) in enumerate(zip(rows_k, rows_r)):
        fk = {r["sku"]: r["_final"] for r in rk}
        fr = {r["sku"]: r["_final"] for r in rr}
        shared = fk.keys() & fr.keys()
        worst = max([worst] + [abs(fk[s] - fr[s]) for s in shared])
        worst_rank = max([worst_rank] + [abs(a["_final"] - b["_final"]) for a, b in zip(rk, rr)])
        if [r["sku"] for r in rk] != [r["sku"] for r in rr]:
            swapped.append(i)
        for mine, other in ((fk, rr), (fr, rk)):
            for sku in mine.keys() - shared:
                cut.append({"query": i, "sku": sku, "final": mine[sku],
                            "other_last": other[-1]["_final"] if other else None})
    bad_cut = [c for c in cut if c["other_last"] is None
               or abs(c["final"] - c["other_last"]) > FINAL_TOL]
    out = {"queries": len(rows_k), "max_final_diff": worst, "tol": FINAL_TOL,
           "margin": FINAL_TOL - worst, "max_final_diff_by_rank": worst_rank,
           "queries_with_swaps": swapped, "products_across_the_cut": len(cut),
           "beyond_a_near_tie": bad_cut[:5]}
    emit({"phase": phase, **out})
    check(worst <= FINAL_TOL, phase, f"_final differs by {worst} > {FINAL_TOL}")
    check(not bad_cut, phase, f"rows differ beyond a near tie at the cut: {bad_cut[:5]}")
    return out


def phase_slice(torch):
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
    from review_recommender_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    products = synth_product_index(N_DOCS, DIM, VOCAB, TERMS, seed=0, text_chars=TEXT_CHARS)
    _synth_doc_tokens(products)  # query_e2e's (phase 9)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    be = BiEncoder.random_init(BertConfig.bge_small(), seed=1, device="cuda",
                               dtype=torch.bfloat16)
    ce = CrossEncoder.random_init(BertConfig.minilm_l6_cross(), seed=2, device="cuda",
                                  dtype=torch.bfloat16)
    engine = SearchEngine(IndexBundle(products=products), device="cuda",
                          query_encoder=be, cross_encoder=ce)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    check(engine.dense_pool == "striped", "slice", f"pool mode {engine.dense_pool}")
    check(engine.dtype == torch.bfloat16 and engine.gate_mode == "device", "slice",
          f"engine dtype {engine.dtype} gate {engine.gate_mode}")
    check(all(t.device.type == "cuda" for t in engine.arrays.values()), "slice",
          "engine tensors not on cuda")
    check(all(p.device.type == "cuda" for m in (be.model, ce.model) for p in m.parameters()),
          "slice", "tower weights not on cuda")
    emit({"phase": "slice_setup", "n_docs": N_DOCS, "n_padded": products.n_padded,
          "dim": DIM, "terms_per_doc": TERMS, "pool_mode": engine.dense_pool,
          "stripes": engine.dense_stripes, "corpus_s": t_corpus, "setup_s": t_setup,
          "fit": {k: engine.hbm_report[k] for k in ("total_bytes", "limit_bytes", "frac")}})

    queries = _queries(N_QUERIES, DIM, VOCAB)
    for rk in (0, RERANK_K):  # warm-up: cuBLAS handles, allocator, first launches
        _check_rows(engine.run_search(queries[0], k=K, rerank_k=rk)[0], "slice")
    torch.cuda.synchronize()

    A.mha_kernel_launches = 0
    lat, stages, launches, kept = {}, {}, {}, {}
    for rk in (0, RERANK_K):
        before = A.mha_kernel_launches
        lat[rk], stages[rk], kept[rk] = [], {}, []
        for q in queries:
            t0 = time.perf_counter()
            rows, _snips, debug = engine.run_search(q, k=K, rerank_k=rk)
            lat[rk].append((time.perf_counter() - t0) * 1e3)
            kept[rk].append(rows)
            _check_rows(rows, "slice")
            check(bool(debug.get("fused")) == (rk == 0), "slice", f"path {debug}")
            for name, ms in debug["stage_ms"].items():
                stages[rk].setdefault(name, []).append(ms)
        launches[rk] = A.mha_kernel_launches - before
    total_launches = A.mha_kernel_launches
    peak = torch.cuda.max_memory_allocated()
    expect = {0: 12 * N_QUERIES, RERANK_K: 18 * N_QUERIES}
    for rk in (0, RERANK_K):
        emit({"phase": "slice", "rerank_k": rk, "queries": N_QUERIES, "k": K,
              "p50_ms": float(np.percentile(lat[rk], 50)),
              "p90_ms": float(np.percentile(lat[rk], 90)),
              "mean_ms": float(np.mean(lat[rk])),
              "stage_ms_mean": {n: float(np.mean(v)) for n, v in stages[rk].items()},
              "kernel_launches": launches[rk], "expected_launches": expect[rk]})
        check(launches[rk] == expect[rk], "slice",
              f"rerank_k={rk}: {launches[rk]} kernel launches, expected {expect[rk]}")

    emit({"phase": "memory", "peak_allocated_bytes": peak,
          "what": "engine arrays + towers + activations of the main path's runs"})
    emit({"phase": "towers", **_tower_times(torch, engine, be, ce, queries[2])})
    for rk in (0, RERANK_K):
        emit({"phase": "profile", **_profile_window(torch, engine, queries[:4], rk)})

    # every query again with both towers on the plain attention (ROADMAP F3)
    rows_k = kept[RERANK_K]
    be.set_attn_impl("reference")
    ce.set_attn_impl("reference")
    before = A.mha_kernel_launches
    rows_r = [engine.run_search(q, k=K, rerank_k=RERANK_K)[0] for q in queries]
    check(A.mha_kernel_launches == before, "crosscheck", "reference run launched the kernel")
    be.set_attn_impl("auto")
    ce.set_attn_impl("auto")
    _crosscheck(rows_k, rows_r, "crosscheck")
    return total_launches, engine


def _bm25_postings(torch, n, l, q, seed):
    """Postings drawn on the card: log-uniform (Zipf-like) term ids below
    30,000 so that query terms match, 25-100% of the L lanes used (PAD
    lanes: term 0, tf 0), tf 1..5 with 1% of lanes at 128..255 (the packed
    word's sign bit); a query of q slots with one repeated slot and q/4 PAD
    slots (id 0, idf 0). Returns terms, tf, doc_len, packed (L, N), q_terms,
    q_idf, avgdl."""
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
    terms = torch.floor(VOCAB ** rand(n, l)).to(torch.int32).clamp_(1, VOCAB - 1)
    used = torch.randint(l // 4, l + 1, (n, 1), generator=g, device=dev)
    pad = torch.arange(l, device=dev)[None, :] >= used
    tfi = torch.randint(1, 6, (n, l), generator=g, device=dev, dtype=torch.int32)
    hot = torch.randint(128, 256, (n, l), generator=g, device=dev, dtype=torch.int32)
    tfi = torch.where(rand(n, l) < 0.01, hot, tfi)
    del hot
    terms.masked_fill_(pad, 0)
    tfi.masked_fill_(pad, 0)
    del pad
    word = (tfi.to(torch.int64) << 24) | terms.to(torch.int64)
    word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    packed = word.T.contiguous()
    del word
    tf = tfi.to(torch.float32)
    del tfi
    doc_len = tf.sum(dim=1)
    q_terms = torch.floor(VOCAB ** (0.5 * rand(q))).to(torch.int32).clamp_(1, VOCAB - 1)
    q_terms[1] = q_terms[0]
    q_idf = 0.5 + 2.5 * rand(q)
    q_terms[q - q // 4:] = 0
    q_idf[q - q // 4:] = 0.0
    avgdl = float(doc_len.mean().to(torch.float32))
    return terms, tf, doc_len, packed, q_terms, q_idf, avgdl


def scan_cost(n: int, l: int, name: str) -> tuple[int, float]:
    """(bytes, kernel instructions) of one full BM25 scan: each input read
    once and the scores written once (packed N*L*4 + N*8, unpacked N*L*8 +
    N*8), and N*L times the kernel's SASS instructions per posting."""
    nbytes = n * l * (4 if name == "bm25_packed" else 8) + n * 8
    return nbytes, n * l * BM25_SASS_PER_POSTING[name]


def _score_diff(torch, got, ref):
    err = (got - ref).abs()
    return {"bit_equal_share": float((got == ref).float().mean()),
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / ref.abs().clamp_min(1e-30)).max())}


def phase_bm25_kernel(torch):
    """Each BM25 kernel against its plain version on the same inputs. Each
    timed launch is queued behind a busy step, so that the event interval
    holds the device's work and not the host's launch: a spin (L2 stays
    warm; at 200k the 51 MB of packed postings mostly stay in the 50 MB
    L2) or an L2 flush (cold; the HBM share is read from this time). A
    third time starts from an idle device, host launch included."""
    from review_recommender_tpu_torch.ops import bm25_kernel as BK
    from review_recommender_tpu_torch.ops.bm25 import bm25_full_scores, masked_topk

    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEV)
    flush = lambda: flush_buf.fill_(1.0)
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    rows = []
    for i, (n, l, q) in enumerate(BM25_SHAPES):
        terms, tf, doc_len, packed, qt, qi, avgdl = _bm25_postings(torch, n, l, q, 300 + i)
        if i == 0:  # the device packing above is the host packer's
            ref_pk = BK.pack_postings(terms.cpu().numpy(), tf.cpu().numpy())
            check(ref_pk is not None and np.array_equal(ref_pk[:, :n], packed.cpu().numpy()),
                  "bm25_kernel", "device-packed words differ from pack_postings")
        valid = torch.arange(n, device=DEV) < n - 64  # a padding tail
        cases = {
            "bm25_packed": (BK.bm25_full_scores_packed_kernel,
                            BK.bm25_full_scores_packed_reference,
                            (packed, doc_len, qt, qi, avgdl)),
            "bm25_unpacked": (BK.bm25_full_scores_kernel, bm25_full_scores,
                              (terms, tf, doc_len, qt, qi, avgdl)),
        }
        for name, (kern, plain, args) in cases.items():
            got = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (n,) and got.dtype == torch.float32, "bm25_kernel",
                  f"{name} output {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()) and bool((got > 0).any()), "bm25_kernel",
                  f"{name}: non-finite or all-zero scores")
            diff = _score_diff(torch, got, ref)
            ids_equal = torch.equal(masked_topk(got, valid, BM25_TOPN)[1],
                                    masked_topk(ref, valid, BM25_TOPN)[1])
            for _ in range(3):  # warm-up
                kern(*args)
                plain(*args)
            ms = _median_ms(torch, lambda: kern(*args), REPS, before=spin)
            plain_ms = _median_ms(torch, lambda: plain(*args), REPS, before=spin)
            cold_ms = _median_ms(torch, lambda: kern(*args), REPS, before=flush)
            idle_ms = _median_ms(torch, lambda: kern(*args), REPS)
            nbytes, instrs = scan_cost(n, l, name)
            bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
            row = {"kernel": name, "N": n, "L": l, "Q": q, **diff, "tol_rel": BM25_REL_TOL,
                   f"top{BM25_TOPN}_ids_equal": ids_equal, "ms": ms, "plain_ms": plain_ms,
                   "cold_l2_ms": cold_ms, "from_idle_ms": idle_ms, "bytes": nbytes,
                   "bound_ms": bound_ms, "bound_by": "bytes",
                   "share_of_bound_cold_l2": bound_ms / cold_ms,
                   "sass_instructions": instrs,
                   "issue_share": instrs / PEAK_ISSUE_OPS / (ms / 1e3), "reps": REPS}
            emit({"phase": "bm25_kernel", **row})
            check(diff["max_rel_err"] <= BM25_REL_TOL and ids_equal, "bm25_kernel",
                  f"{name} disagrees with its plain version at {row}")
            rows.append(row)
        del terms, tf, doc_len, packed, cases, args
        torch.cuda.empty_cache()
    del flush_buf
    _bm25_long_query(torch)
    return rows


def _bm25_long_query(torch):
    """Both kernels at Q = BM25_LONG_Q on the 200k postings: more slots
    than one launch takes, so each call is two launches, the second adding
    to the first's scores. Bitwise equal to the plain versions."""
    from review_recommender_tpu_torch.ops import bm25_kernel as BK
    from review_recommender_tpu_torch.ops.bm25 import bm25_full_scores

    n, l, _q = BM25_SHAPES[0]
    terms, tf, doc_len, packed, qt, qi, avgdl = _bm25_postings(torch, n, l, BM25_LONG_Q, 310)
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    for name, kern, plain, args in (
            ("bm25_packed", BK.bm25_full_scores_packed_kernel,
             BK.bm25_full_scores_packed_reference, (packed, doc_len, qt, qi, avgdl)),
            ("bm25_unpacked", BK.bm25_full_scores_kernel, bm25_full_scores,
             (terms, tf, doc_len, qt, qi, avgdl))):
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        diff = _score_diff(torch, got, ref)
        kern(*args)
        ms = _median_ms(torch, lambda: kern(*args), REPS, before=spin)
        emit({"phase": "bm25_kernel_long_query", "kernel": name, "N": n, "L": l,
              "Q": BM25_LONG_Q, "live_slots": int((qi > 0).sum()), **diff, "ms": ms,
              "launches_per_call": -(-BM25_LONG_Q // 64), "reps": REPS})
        check(diff["bit_equal_share"] == 1.0 and bool((got > 0).any()), "bm25_kernel",
              f"{name} at Q={BM25_LONG_Q} disagrees with its plain version: {diff}")


def _bm25_bundles(products):
    """(a) the eager bundle as built, (b) the same ProductIndex classic,
    (c) classic with one lane's tf at 300 (that row's doc_len updated), so
    that pack_postings refuses it."""
    doc_tf, doc_len = products.doc_tf.copy(), products.doc_len.copy()
    doc_len[0] += 300.0 - doc_tf[0, 0]
    doc_tf[0, 0] = 300.0
    classic = dataclasses.replace(products, doc_bm25=None, doc_tokens=None,
                                  doc_token_len=None)
    return {"a_eager": products, "b_classic": classic,
            "c_unpackable": dataclasses.replace(classic, doc_tf=doc_tf, doc_len=doc_len)}


def _count_plain_calls(modules_and_names):
    """Wrap the plain versions so that a call counts; returns (counter,
    restore)."""
    counter = {"calls": 0}
    saved = []
    for mod, name in modules_and_names:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, **kw):
            counter["calls"] += 1
            return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return counter, restore


def _bm25_crosscheck(torch, engine, queries, bundle):
    """Kernel scores against the plain version on the same device tensors,
    for the branch the bundle takes."""
    from review_recommender_tpu_torch.ops import bm25_kernel as BK
    from review_recommender_tpu_torch.ops.bm25 import bm25_full_scores, masked_topk

    out = []
    for query in queries:
        qf = engine.featurizer.featurize(query)
        qt = torch.from_numpy(qf.q_terms).to(DEV)
        qi = torch.from_numpy(qf.q_idf).to(DEV)
        if bundle == "c_unpackable":
            a = engine.arrays
            args = (a["doc_terms"], a["doc_tf"], a["doc_len"], qt, qi, engine.avgdl_h)
            kern, plain, valid = BK.bm25_full_scores_kernel, bm25_full_scores, a["valid"]
        else:
            pk, dl_p, valid = engine._bm25_packed()
            args = (pk, dl_p, qt, qi, engine.avgdl_h)
            kern, plain = BK.bm25_full_scores_packed_kernel, BK.bm25_full_scores_packed_reference
        got, ref = kern(*args), plain(*args)
        idx_k = masked_topk(got, valid, K)[1]
        idx_p = masked_topk(ref, valid, K)[1]
        idx_e = engine.search_bm25(query, K)[0]
        row = {"query": query, **_score_diff(torch, got, ref),
               "same_ids": torch.equal(idx_k, idx_p) and torch.equal(
                   torch.clamp(idx_k, max=engine.products.n_padded - 1), idx_e)}
        check(row["same_ids"] and row["max_rel_err"] <= BM25_REL_TOL, "bm25_slice",
              f"{bundle}: kernel vs plain {row}")
        out.append(row)
    return out


def _bm25_pass(engine, queries, bundle, n_pad):
    """search_bm25 on each query, to the ids and scores on the host:
    latencies (ms), with each result checked."""
    lat = []
    for q in queries:
        t0 = time.perf_counter()
        idx, scores = engine.search_bm25(q, K)
        idx_h, scores_h = idx.cpu().numpy(), scores.cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1e3)
        check(idx_h.shape == scores_h.shape == (K,), "bm25_slice",
              f"{bundle}: shapes {idx_h.shape} {scores_h.shape}")
        check(bool(np.isfinite(scores_h).all()) and bool(np.all(np.diff(scores_h) <= 0)),
              "bm25_slice", f"{bundle}: scores not finite and sorted for {q!r}")
        check(int(idx_h.max()) < n_pad and bool(engine.products.valid[idx_h].all()),
              "bm25_slice", f"{bundle}: row ids {idx_h}")
    return lat


def phase_bm25_slice(torch, engine_a):
    """search_bm25 through the engine on three bundles of phase 4's corpus,
    and search_dense once. Each bundle answers 100 queries it has not seen
    (the main path, whose launches are counted), then the same 100 again
    with the featurizer's expansion cache warm (timed only)."""
    from review_recommender_tpu_torch.engine import search as S
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.ops import attention as A
    from review_recommender_tpu_torch.ops import bm25_kernel as BK
    from review_recommender_tpu_torch.ops.dense import dense_scores, stable_topk

    torch.cuda.reset_peak_memory_stats()
    warm_query = _queries(1, DIM, VOCAB)[0]  # phase 4's first query
    # queries that neither phase 4 nor the warm-up sent: the first pass pays
    # the featurizer's vocabulary expansion of each token not seen before
    queries = _queries(N_QUERIES, DIM, VOCAB, seed=43)
    n_pad = engine_a.products.n_padded
    expect = {"a_eager": (N_QUERIES, 0), "b_classic": (N_QUERIES, 0),
              "c_unpackable": (0, N_QUERIES)}
    totals = {"bm25_packed": 0, "bm25_unpacked": 0}
    max_err = {"bm25_packed": 0.0, "bm25_unpacked": 0.0}
    engines, split = {}, {}
    n_prof = 10
    for bundle, products in _bm25_bundles(engine_a.products).items():
        t0 = time.perf_counter()
        engine = engine_a if bundle == "a_eager" else SearchEngine(
            IndexBundle(products=products), device=DEV, dense_pool="exact")
        engine.search_bm25(warm_query, K)  # warm-up; packs the postings on first use
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(("doc_bm25" in engine.arrays) == (bundle == "a_eager"), "bm25_slice",
              f"{bundle}: arrays {sorted(engine.arrays)}")
        check((engine._bm25_packed() is None) == (bundle == "c_unpackable"), "bm25_slice",
              f"{bundle}: packed postings {engine._bm25_packed_cache is not None}")

        counter, restore = _count_plain_calls(
            [(BK, "bm25_full_scores_packed_reference"), (BK, "bm25_full_scores"),
             (S, "bm25_full_scores_eager"), (S, "bm25_topk")])
        A.mha_kernel_launches = 0
        BK.bm25_packed_kernel_launches = BK.bm25_unpacked_kernel_launches = 0
        try:
            lat = _bm25_pass(engine, queries, bundle, n_pad)
        finally:
            restore()
        launches = (BK.bm25_packed_kernel_launches, BK.bm25_unpacked_kernel_launches)
        mha, plain_calls = A.mha_kernel_launches, counter["calls"]
        lat_repeat = _bm25_pass(engine, queries, bundle, n_pad)  # expansion cache warm
        totals["bm25_packed"] += launches[0]
        totals["bm25_unpacked"] += launches[1]
        prof = _profile(torch, lambda: [engine.search_bm25(q, K)[0].cpu()
                                        for q in queries[:n_prof]], _bm25_device_class)
        if prof.get("device_ms_by_class") is not None:
            split[bundle] = {c: prof["device_ms_by_class"].get(c, 0.0) / n_prof * 1e3
                             for c in ("scan", "sort", "rest")}
        cross = _bm25_crosscheck(torch, engine, queries[1:3], bundle)
        kname = "bm25_unpacked" if bundle == "c_unpackable" else "bm25_packed"
        max_err[kname] = max([max_err[kname]] + [r["max_abs_err"] for r in cross])
        check(engine.featurizer.route == "native", "bm25_slice",
              f"{bundle}: the {engine.featurizer.route} featurizer ran")
        emit({"phase": "bm25_slice", "bundle": bundle, "queries": N_QUERIES, "k": K,
              "featurizer": engine.featurizer.route, "setup_s": setup_s, "p50_ms": float(np.percentile(lat, 50)),
              "p90_ms": float(np.percentile(lat, 90)), "mean_ms": float(np.mean(lat)),
              "repeat_p50_ms": float(np.percentile(lat_repeat, 50)),
              "repeat_p90_ms": float(np.percentile(lat_repeat, 90)),
              "packed_launches": launches[0], "unpacked_launches": launches[1],
              "expected": list(expect[bundle]), "mha_launches": mha,
              "plain_calls": plain_calls, "crosscheck": cross,
              "profile_10_queries": prof})
        check(launches == expect[bundle] and mha == 0 and plain_calls == 0, "bm25_slice",
              f"{bundle}: launches {launches} (expected {expect[bundle]}), mha {mha}, "
              f"plain calls {plain_calls}")
        engines[bundle] = engine
    emit({"phase": "bm25_device_split", "queries": n_prof,
          "what": "search_bm25 device time per query (us) by kernel class, from each "
                  "bundle's profiler window; null where the profiler saw no device events",
          "per_query_us": {b: split.get(b) for b in expect}})

    # search_dense: exact pool on (b), striped pool on (a)
    rng = np.random.default_rng(7)
    qv = rng.standard_normal(DIM).astype(np.float32)
    qv /= np.linalg.norm(qv)
    dense = {}
    for bundle in ("b_classic", "a_eager"):
        eng = engines[bundle]
        idx, scores = eng.search_dense(qv, K)
        sims = dense_scores(eng.arrays["emb"], torch.from_numpy(qv).to(DEV), eng.arrays["valid"])
        ref_s, ref_i = stable_topk(sims, K)
        at_rows = sims[idx]
        dense[bundle] = {"pool": eng.dense_pool, "same_ids_as_exact": torch.equal(idx, ref_i),
                         "max_score_diff_at_rows": float((scores - at_rows).abs().max())}
        check(dense[bundle]["max_score_diff_at_rows"] <= 1e-5, "bm25_slice",
              f"search_dense {bundle}: {dense[bundle]}")
    check(dense["b_classic"]["same_ids_as_exact"], "bm25_slice",
          f"search_dense (exact pool) differs from dense_scores + stable_topk: {dense}")
    emit({"phase": "search_dense", "k": K, **dense})
    emit({"phase": "bm25_memory", "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "what": "phase 4's engine and towers + bundles (b), (c) + packed postings"})
    del engines
    return totals, max_err


def _bm25_kernel_entries(rows, launches, err):
    """The kernels-line entries of the two BM25 kernels: launches of phase
    6's main path, the largest error of every comparison, and the times at
    the headline shape (the first of BM25_SHAPES). The bound is the posting
    bytes over HBM bandwidth: the function needs one membership test and one
    add per posting, far below any peak (the SASS instructions per posting
    of scan_cost are the kernel's, not the function's). No single PyTorch
    call computes a BM25 scan: library_ms is null."""
    out = []
    for name, line in (("bm25_packed", 167), ("bm25_unpacked", 35)):
        mine = [r for r in rows if r["kernel"] == name]
        out.append({
            "name": name, "route": "cuda",
            "source": "review_recommender_tpu_torch/csrc/bm25_full.cu",
            "replaces": f"review_recommender_tpu/ops/pallas/bm25_kernel.py:{line}",
            "launches": launches[name],
            "max_abs_err": max([err[name]] + [r["max_abs_err"] for r in mine]),
            "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"],
            "bound_ms": mine[0]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
        })
    return out


def _kernel_modules():
    from review_recommender_tpu_torch.ops import attention as A
    from review_recommender_tpu_torch.ops import bm25_kernel as BK
    from review_recommender_tpu_torch.ops import stage_a as SA

    return {"mha_fwd": (A, "mha_kernel_launches"),
            "bm25_packed": (BK, "bm25_packed_kernel_launches"),
            "bm25_unpacked": (BK, "bm25_unpacked_kernel_launches"),
            "stage_a_fused": (SA, "stage_a_kernel_launches"),
            "stage_a_f32": (SA, "stage_a_f32_kernel_launches")}


def _zero_counts() -> None:
    for mod, attr in _kernel_modules().values():
        setattr(mod, attr, 0)


def _counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _kernel_modules().items()}


def _pct(lat) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)), "p90_ms": float(np.percentile(lat, 90)),
            "mean_ms": float(np.mean(lat)), "n": len(lat)}


def _batched_qps(engine, qvecs, qstrings, w, batch):
    """bench.py:_batched_qps: QPS_REPS passes over the queries in batches,
    the results read to the host after the last batch."""
    t0 = time.perf_counter()
    outs = []
    for _ in range(QPS_REPS):
        for lo in range(0, len(qstrings), batch):
            outs.append(engine.query_fused_batched(qvecs[lo:lo + batch], qstrings[lo:lo + batch],
                                                   w, POOL, K))
    host = [(r.cpu(), s.cpu()) for r, s in outs]
    qps = QPS_REPS * len(qstrings) / (time.perf_counter() - t0)
    check(all(r.shape == (min(batch, len(qstrings)), K) for r, _s in host), "batched_slice",
          f"batch {batch}: result shapes")
    return qps


def _batch_latencies(run, n_q, batch):
    """Per-batch wall time of run(lo, hi) -> device tensors, each batch read
    to the host before the next starts; returns (latencies ms, host results)."""
    lat, res = [], []
    for lo in range(0, n_q, batch):
        t0 = time.perf_counter()
        out = [t.cpu() for t in run(lo, lo + batch)]
        lat.append((time.perf_counter() - t0) * 1e3)
        res.append(out)
    return lat, res


def _check_batch_rows(rows, scores, phase):
    check(bool(scores.isfinite().all()), phase, "non-finite scores")
    check(bool((scores[:, 1:] <= scores[:, :-1]).all()), phase, "rows not sorted")
    check(int(rows.min()) >= 0, phase, f"row ids {rows.min()}")


def _singles(engine, qvecs, qstrings, w):
    """query_fused of each query, on the host."""
    return [tuple(t.cpu().numpy() for t in engine.query_fused(qvecs[i], q, w, POOL, K))
            for i, q in enumerate(qstrings)]


def _against_single(singles, rows, scores, phase="batched_slice"):
    """Each batched row against query_fused of its query: scores within
    tests/test_batched.py's allowance, a differing id only at a near tie.
    Returns (max score diff, rank swaps)."""
    diff, swaps = 0.0, 0
    for i, (r1, s1) in enumerate(singles):
        rb, sb = np.asarray(rows[i]), np.asarray(scores[i])
        check(rb.shape == r1.shape, phase, f"query {i}: {rb.shape} rows, expected {r1.shape}")
        d = np.abs(sb - s1)
        check(bool((d <= SINGLE_ATOL + SINGLE_RTOL * np.abs(s1)).all()), phase,
              f"query {i}: batched scores {sb} vs single {s1}")
        bad = (rb != r1) & (np.abs(s1 - sb) >= NEAR_TIE)
        check(not bad.any(), phase, f"query {i}: ids {rb} vs {r1} beyond near ties")
        diff = max(diff, float(d.max()))
        swaps += int((rb != r1).sum())
    return diff, swaps


def phase_batched_slice(torch, engine):
    """query_fused_batched / _pw / query_fused1 on phase 4's engine."""
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    qvecs, qterms, qstrings = _bench_queries(BENCH_QUERIES, DIM, VOCAB)
    w = FusionWeights.make(*BENCH_W)
    check(engine.featurizer.route == "native", "batched_slice",
          f"the {engine.featurizer.route} featurizer ran")
    torch.cuda.reset_peak_memory_stats()
    # warm-up (bench.py:551-565), then every query once at each batch size:
    # the featurizer then holds every token, and the rows feed the cross-check
    engine.query_fused(qvecs[0], qstrings[0], w, POOL, K)[0].cpu()
    first = {}
    for b in BATCHES:
        first[b] = _batch_latencies(
            lambda lo, hi: engine.query_fused_batched(qvecs[lo:hi], qstrings[lo:hi], w, POOL, K),
            BENCH_QUERIES, b)[1]
    torch.cuda.synchronize()

    _zero_counts()
    rows = {}
    for b in BATCHES:
        qps = _batched_qps(engine, qvecs, qstrings, w, b)
        lat, res = _batch_latencies(
            lambda lo, hi: engine.query_fused_batched(qvecs[lo:hi], qstrings[lo:hi], w, POOL, K),
            BENCH_QUERIES, b)
        r = torch.cat([x[0] for x in res])
        sc = torch.cat([x[1] for x in res])
        _check_batch_rows(r, sc, "batched_slice")
        check(torch.equal(r, torch.cat([x[0] for x in first[b]])), "batched_slice",
              f"B={b}: rows differ between two passes")
        rows[b] = (r, sc)
        emit({"phase": "batched_slice", "form": "query_fused_batched", "B": b,
              "featurizer": engine.featurizer.route, "queries": BENCH_QUERIES, "pool": POOL, "k": K, "qps": qps, "reps": QPS_REPS,
              "per_batch": _pct(lat)})
    pw_w = [KNOB_SETS[i % len(KNOB_SETS)] for i in range(BENCH_QUERIES)]
    lat, res = _batch_latencies(
        lambda lo, hi: engine.query_fused_batched_pw(qvecs[lo:hi], qstrings[lo:hi], pw_w[lo:hi],
                                                     POOL, K), BENCH_QUERIES, BATCHES[0])
    pw_rows, pw_sc, pw_bd = (torch.cat([x[i] for x in res]) for i in range(3))
    _check_batch_rows(pw_rows, pw_sc, "batched_slice")
    check(pw_bd.shape == (BENCH_QUERIES, K, 7), "batched_slice", f"breakdown {pw_bd.shape}")
    emit({"phase": "batched_slice", "form": "query_fused_batched_pw", "B": BATCHES[0],
          "knob_sets": len(KNOB_SETS), "per_batch": _pct(lat),
          "qps": BENCH_QUERIES / (sum(lat) / 1e3)})
    lat = []
    for i in range(N_QUERIES):
        t0 = time.perf_counter()
        ids, fin = engine.split_fused1(engine.query_fused1(qvecs[i], qstrings[i], w, POOL, K))
        lat.append((time.perf_counter() - t0) * 1e3)
        check(ids.shape == (K,) and bool(np.isfinite(fin).all()), "batched_slice",
              f"query_fused1 {i}: {ids} {fin}")
    emit({"phase": "batched_slice", "form": "query_fused1", "B": 1, **_pct(lat)})
    launches = _counts()
    check(not any(launches.values()), "batched_slice",
          f"kernel launches on a path that has none: {launches}")

    singles = _singles(engine, qvecs, qstrings, w)
    cross = {b: _against_single(singles, *rows[b]) for b in BATCHES}
    pw_diff, pw_swaps = 0.0, 0
    for i in range(8):  # the per-query knobs against query_fused with those knobs
        one = _singles(engine, qvecs[i:i + 1], qstrings[i:i + 1], FusionWeights.make(*pw_w[i]))
        d, sw = _against_single(one, pw_rows[i:i + 1], pw_sc[i:i + 1])
        pw_diff, pw_swaps = max(pw_diff, d), pw_swaps + sw
    prof = _profile(torch, lambda: [engine.query_fused_batched(
        qvecs[lo:lo + 32], qstrings[lo:lo + 32], w, POOL, K)[0].cpu()
        for lo in range(0, BENCH_QUERIES, 32)])
    emit({"phase": "batched_crosscheck", "against": "query_fused of each query",
          **{f"B{b}": {"max_score_diff": cross[b][0], "rank_swaps": cross[b][1]}
             for b in BATCHES},
          "pw_first_8": {"max_score_diff": pw_diff, "rank_swaps": pw_swaps},
          "rtol": SINGLE_RTOL, "atol": SINGLE_ATOL, "near_tie": NEAR_TIE,
          "kernel_launches": launches})
    emit({"phase": "batched_profile", "batches": BENCH_QUERIES // 32, "B": 32, **prof})
    emit({"phase": "batched_memory", "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "what": "phase 4's engine and towers + the batched passes at B=32 and B=128"})
    return qvecs, qterms


def _plain_tile_scores(torch, emb, valid, qvecs, local_ids):
    """The plain version's score at each winner id: (n_tiles, 16, B)."""
    from review_recommender_tpu_torch.ops import stage_a as SA
    from review_recommender_tpu_torch.ops.dense import matmul_f32

    n, b = emb.shape[0], qvecs.shape[0]
    tiles = -(-n // SA.TILE_N)
    sims = torch.where(valid[:, None], matmul_f32(emb, qvecs.to(emb.dtype).T), SA.NEG)
    sims = torch.nn.functional.pad(sims, (0, 0, 0, tiles * SA.TILE_N - n), value=SA.NEG)
    return torch.gather(sims.reshape(tiles, SA.TILE_N, b), 1, local_ids.long())


def _tile_winners_diff(torch, emb, valid, qv, phase):
    """Kernel tile pass against the plain one on the same inputs."""
    from review_recommender_tpu_torch.ops import stage_a as SA

    ks, ki = SA.stage_a_tile_winners_kernel(emb, valid, qv)
    ps, pi = SA.stage_a_tile_winners_reference(emb, valid, qv)
    torch.cuda.synchronize()
    check(ks.shape == ps.shape and ki.dtype == pi.dtype == torch.int32, phase,
          f"shapes {tuple(ks.shape)} {tuple(ps.shape)}")
    differ = ki != pi
    gap = 0.0
    if bool(differ.any()):
        g = (_plain_tile_scores(torch, emb, valid, qv, ki)
             - _plain_tile_scores(torch, emb, valid, qv, pi))[differ]
        gap = float(g.abs().max())
    row = {"ids_equal_share": float((~differ).float().mean()), "ids_differing": int(differ.sum()),
           "max_abs_err": float((ks - ps).abs().max()), "near_tie_gap": gap,
           "tol": STAGE_A_TOL}
    check(row["max_abs_err"] <= STAGE_A_TOL and gap <= STAGE_A_TOL, phase,
          f"tile pass disagrees with its plain version: {row}")
    return row, (ks, ki, ps, pi)


def _exhausted_case(torch):
    """2 tiles at D=384 bf16, N = 2048 + 1000 with 10 valid rows in tile 1:
    from round 10 on, tile 1 returns -3.4e38 and local row 0 (repeats)."""
    from review_recommender_tpu_torch.ops import stage_a as SA

    rng = np.random.default_rng(8)
    n = SA.TILE_N + 1000
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[SA.TILE_N:] = False
    valid[SA.TILE_N + rng.choice(1000, 10, replace=False)] = True
    qv = rng.standard_normal((8, DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(x).cuda()
    row, (ks, ki, _ps, pi) = _tile_winners_diff(torch, t(emb).to(torch.bfloat16), t(valid),
                                                t(qv), "stage_a")
    repeats = bool((ki[1, 10:] == 0).all()) and bool((ks[1, 10:] == SA.NEG).all())
    check(torch.equal(ki, pi) and repeats, "stage_a",
          f"exhausted-tile case: ids equal {torch.equal(ki, pi)}, repeats {repeats}")
    return {"N": n, "B": 8, "valid_in_tile1": 10, "ids_equal": True,
            "repeats_from_round": 10, "max_abs_err": row["max_abs_err"]}


def _recall(a, b) -> float:
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / len(x)
                          for x, y in zip(a, b)]))


def phase_stage_a(torch, engine, qvecs, qterms):
    """bench.py's fused stage-A section on the port."""
    from review_recommender_tpu_torch.ops import stage_a as SA
    from review_recommender_tpu_torch.ops.bm25 import bm25_candidate_scores_eager
    from review_recommender_tpu_torch.ops.dense import dense_topk_batched

    a = engine.arrays
    emb, valid, terms, bm25 = a["emb"], a["valid"], a["doc_terms"], a["doc_bm25"]
    n = emb.shape[0]
    tiles = -(-n // SA.TILE_N)
    check(emb.dtype == torch.bfloat16 and tiles == 98, "stage_a", f"{emb.dtype}, {tiles} tiles")
    b = BATCHES[0]
    qv = torch.from_numpy(qvecs[:b]).cuda()
    qt = torch.from_numpy(qterms[:b]).cuda()

    def exact(q, q_terms):  # bench.py:1553-1561
        d, idx = dense_topk_batched(emb, q, valid, POOL)
        return d, idx, bm25_candidate_scores_eager(terms[idx], bm25[idx], q_terms)

    tile_row, _ = _tile_winners_diff(torch, emb, valid, qv, "stage_a")
    kd, ki, kb = SA.stage_a_fused(emb, valid, terms, bm25, qv, qt, POOL)
    rd, ri, rb = SA.stage_a_fused_reference(emb, valid, terms, bm25, qv, qt, POOL)
    torch.cuda.synchronize()
    check(kd.shape == ki.shape == kb.shape == (b, POOL), "stage_a", f"shape {tuple(kd.shape)}")
    same = ki == ri
    fused_row = {"ids_equal_share": float(same.float().mean()),
                 "max_abs_err_dense": float((kd - rd).abs().max()),
                 "max_abs_err_bm25_same_ids": float((kb - rb)[same].abs().max())}
    check(fused_row["max_abs_err_dense"] <= STAGE_A_TOL
          and fused_row["max_abs_err_bm25_same_ids"] <= STAGE_A_TOL, "stage_a",
          f"stage_a_fused against stage_a_fused_reference: {fused_row}")
    small = _exhausted_case(torch)

    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    runs = {"plain": lambda: SA.stage_a_tile_winners_reference(emb, valid, qv),
            "stage_a_fused": lambda: SA.stage_a_fused(emb, valid, terms, bm25, qv, qt, POOL),
            "exact": lambda: exact(qv, qt)}
    for fn in runs.values():  # warm-up
        for _ in range(3):
            fn()
    ms = {name: _median_ms(torch, fn, REPS, before=spin) for name, fn in runs.items()}
    by_b = _stage_a_by_batch(torch, emb, valid, qvecs)
    ms["kernel"] = by_b[b]["ms"]
    f32 = _stage_a_f32_route(torch, emb, valid, qv)
    emit({"phase": "stage_a", "N": n, "tiles": tiles, "D": emb.shape[1], "B": b, "pool": POOL,
          "tile_pass": tile_row, "stage_a_fused_vs_reference": fused_row,
          "exhausted_tile_case": small, **{f"{k}_ms": v for k, v in ms.items()},
          "kernel_speedup_vs_plain": ms["plain"] / ms["kernel"],
          "kernel_by_B": {str(k): v for k, v in by_b.items()}, "f32_route": f32,
          "reps": REPS, "timing": "CUDA events, each run queued behind a 0.1 ms device spin "
                                  "(cold_l2_ms: behind a 256 MB L2 flush)"})

    # the main path, counted: the batch of the batched query, 32 at a time
    _zero_counts()
    got = [SA.stage_a_fused(emb, valid, terms, bm25, torch.from_numpy(qvecs[lo:lo + b]).cuda(),
                            torch.from_numpy(qterms[lo:lo + b]).cuda(), POOL)
           for lo in range(0, len(qvecs), b)]
    torch.cuda.synchronize()
    launches = _counts()
    ref = [exact(torch.from_numpy(qvecs[lo:lo + b]).cuda(), torch.from_numpy(qterms[lo:lo + b]).cuda())
           for lo in range(0, len(qvecs), b)]
    dense = torch.cat([g[0] for g in got]).cpu()
    ids = torch.cat([g[1] for g in got]).cpu().numpy()
    ids_x = torch.cat([r[1] for r in ref]).cpu().numpy()
    recall = _recall(ids_x, ids)
    check(bool(torch.isfinite(dense).all()) and bool((dense[:, 1:] <= dense[:, :-1]).all()),
          "stage_a", "stage_a_fused dense scores not finite and sorted")
    check(bool((torch.cat([g[2] for g in got]) >= 0).all()), "stage_a", "negative BM25")
    emit({"phase": "stage_a_main", "queries": len(qvecs), "B": b, "pool": POOL,
          "pool_recall_vs_exact": recall, "min_recall": STAGE_A_MIN_RECALL,
          "kernel_launches": launches, "query_chunk": SA.stage_a_query_chunk(emb.shape[1], b)})
    check(recall >= STAGE_A_MIN_RECALL, "stage_a", f"pool recall {recall} < {STAGE_A_MIN_RECALL}")
    # every launch of the bf16 main path on the tensor-core kernel, none on the f32 one
    check(launches["stage_a_fused"] == len(got) and sum(launches.values()) == len(got),
          "stage_a", f"launches {launches}, expected {len(got)} stage_a_fused")
    return {"name": "stage_a_fused", "route": "cuda",
            "source": "review_recommender_tpu_torch/csrc/stage_a_wgmma.cu",
            "replaces": "review_recommender_tpu/ops/pallas/stage_a_kernel.py:61",
            "launches": launches["stage_a_fused"],
            "max_abs_err": max(tile_row["max_abs_err"], small["max_abs_err"]),
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": by_b[b]["bound_ms"], "bound_by": by_b[b]["bound_by"],
            "library_ms": None}  # no single PyTorch call computes stage A


def _stage_a_bound(n, d, b, itemsize, peak_flops):
    """(bound ms, "bytes" or "operations") of one tile pass: the corpus,
    valid mask and queries read once and the (tiles, 16, B) scores and ids
    written once, over HBM bandwidth; 2 N D B product operations over the
    type's peak."""
    tiles = -(-n // 2048)
    nbytes = n * d * itemsize + n + b * d * 4 + tiles * 16 * b * 8
    bound = {"bytes": nbytes / PEAK_HBM_BYTES * 1e3,
             "operations": 2 * n * d * b / peak_flops * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by, nbytes


def _stage_a_by_batch(torch, emb, valid, qvecs):
    """The bf16 tile-pass kernel at each of STAGE_A_BATCHES on phase 4's
    corpus: behind the spin and behind an L2 flush, the query chunk it ran
    at, its bound and the share of it each time reaches."""
    from review_recommender_tpu_torch.ops import stage_a as SA

    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    flush = lambda: flush_buf.fill_(1.0)
    n, d = emb.shape
    out = {}
    for nb in STAGE_A_BATCHES:
        q_nb = torch.from_numpy(qvecs[:nb]).cuda()
        run = lambda: SA.stage_a_tile_winners_kernel(emb, valid, q_nb)
        for _ in range(3):
            run()
        spun = _median_ms(torch, run, REPS, before=spin)
        cold = _median_ms(torch, run, REPS, before=flush)
        bound_ms, by, nbytes = _stage_a_bound(n, d, nb, emb.element_size(), PEAK_BF16_FLOPS)
        out[nb] = {"ms": spun, "cold_l2_ms": cold, "query_chunk": SA.stage_a_query_chunk(d, nb),
                   "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / spun,
                   "share_of_bound_cold_l2": bound_ms / cold,
                   "hbm_share": nbytes / PEAK_HBM_BYTES / (spun / 1e3)}
    del flush_buf
    return out


def _stage_a_f32_route(torch, emb, valid, qv):
    """The f32 route at the same shape: the corpus in f32 through the
    CUDA-core kernel, against its plain version, timed behind the spin."""
    from review_recommender_tpu_torch.ops import stage_a as SA

    emb32 = emb.float()
    before = (SA.stage_a_kernel_launches, SA.stage_a_f32_kernel_launches)
    row, _ = _tile_winners_diff(torch, emb32, valid, qv, "stage_a")
    check((SA.stage_a_kernel_launches, SA.stage_a_f32_kernel_launches)
          == (before[0], before[1] + 1), "stage_a", "the f32 corpus did not take the f32 kernel")
    run = lambda: SA.stage_a_tile_winners_kernel(emb32, valid, qv)
    run()
    ms = _median_ms(torch, run, REPS, before=lambda: torch.cuda._sleep(SPIN_CYCLES))
    bound_ms, by, _ = _stage_a_bound(*emb32.shape, qv.shape[0], 4, PEAK_FP32_FLOPS)
    del emb32
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / ms,
            "max_abs_err": row["max_abs_err"], "ids_equal_share": row["ids_equal_share"]}


def _e2e_rows(engine, rows, scores):
    """query_e2e's device result as run_search-like rows (sku, _final)."""
    return [{"sku": engine.products.skus[int(i)], "_final": float(f)}
            for i, f in zip(rows.cpu().tolist(), scores.cpu().tolist())]


def _e2e_pass(engine, queries, w, rr_k):
    """query_e2e on each query, read to the host: (latencies ms, rows)."""
    lat, out = [], []
    for q in queries:
        t0 = time.perf_counter()
        rows, scores = engine.query_e2e(q, w, POOL, K, rr_k=rr_k)
        got = _e2e_rows(engine, rows, scores)
        lat.append((time.perf_counter() - t0) * 1e3)
        _check_rows(got, "e2e_slice")
        out.append(got)
    return lat, out


def _e2e_small_corpus(torch, be, ce, w):
    """query_e2e against run_search with the same towers on a corpus whose
    texts do not truncate (600 characters: ~110 tokens of the 254 kept),
    tokenized for real by attach_rerank_tokens: the device pairs against the
    host's tokenized pairs. A check, not a timing."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import (attach_rerank_tokens,
                                                          synth_product_index)
    from review_recommender_tpu_torch.index.schema import IndexBundle

    t0 = time.perf_counter()
    small = synth_product_index(SMALL_DOCS, DIM, VOCAB, TERMS, seed=5, text_chars=SMALL_TEXT_CHARS)
    attach_rerank_tokens(small, be.tokenizer, max_tokens=DOC_TOKENS)
    tok_s = time.perf_counter() - t0
    longest = int(small.doc_token_len.max())
    check(longest < DOC_TOKENS, "e2e_slice", f"small corpus texts truncate ({longest} tokens)")
    eng = SearchEngine(IndexBundle(products=small), device=DEV, query_encoder=be,
                       cross_encoder=ce)
    eng.attach_models(be, ce)
    queries = _queries(SMALL_QUERIES, DIM, VOCAB, seed=44)
    e2e = [_e2e_rows(eng, *eng.query_e2e(q, w, POOL, K, rr_k=RERANK_K)) for q in queries]
    host = [eng.run_search(q, k=K, rerank_k=RERANK_K, **RERANK_KNOBS)[0] for q in queries]
    emit({"phase": "e2e_small_corpus", "docs": SMALL_DOCS, "text_chars": SMALL_TEXT_CHARS,
          "longest_doc_tokens": longest, "tokenize_s": tok_s, "queries": SMALL_QUERIES})
    return _crosscheck(e2e, host, "e2e_vs_run_search")


def phase_e2e_slice(torch, engine):
    """query_e2e on phase 4's engine and towers: bi-encoder at (1, 32), the
    pool, the cross-encoder at (rr_k, 287) on pairs built on the device."""
    from review_recommender_tpu_torch.ops import attention as A
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    be, ce = engine.query_encoder, engine.cross_encoder
    engine.attach_models(be, ce)
    w = FusionWeights.make(*RERANK_W)
    queries = _queries(N_QUERIES, DIM, VOCAB)
    for rk in (0, RERANK_K):  # warm-up
        _e2e_pass(engine, queries[:1], w, rk)
    torch.cuda.synchronize()

    counter, restore = _count_plain_calls([(A, "mha_reference")])
    _zero_counts()
    lat, kept, launches = {}, {}, {}
    try:
        for rk in (0, RERANK_K):
            before = A.mha_kernel_launches
            lat[rk], kept[rk] = _e2e_pass(engine, queries, w, rk)
            launches[rk] = A.mha_kernel_launches - before
    finally:
        restore()
    total = A.mha_kernel_launches
    for rk in (0, RERANK_K):
        per_query = launches[rk] / N_QUERIES
        emit({"phase": "e2e_slice", "rr_k": rk, "queries": N_QUERIES, "k": K, "pool": POOL,
              **_pct(lat[rk]), "kernel_launches": launches[rk],
              "launches_per_query": per_query, "reference_attention_calls": counter["calls"],
              "pair_width": 30 + DOC_TOKENS + 3 if rk else None})
        check(per_query == (18 if rk else 12) and counter["calls"] == 0, "e2e_slice",
              f"rr_k={rk}: {launches[rk]} launches, {counter['calls']} reference calls")
    t0 = time.perf_counter()
    for q in queries:
        be.tokenizer.token_ids(q)
        engine.featurizer.featurize_packed(q)
    host_ms = (time.perf_counter() - t0) * 1e3 / N_QUERIES
    prof = _profile(torch, lambda: _e2e_pass(engine, queries[:8], w, RERANK_K))

    # ROADMAP F3 at the new shapes: every query again on the plain attention
    be.set_attn_impl("reference")
    ce.set_attn_impl("reference")
    try:
        before = A.mha_kernel_launches
        _lat, rows_r = _e2e_pass(engine, queries, w, RERANK_K)
        check(A.mha_kernel_launches == before, "e2e_slice", "reference run launched the kernel")
    finally:
        be.set_attn_impl("auto")
        ce.set_attn_impl("auto")
    emit({"phase": "e2e_host", "host_prep_ms_per_query": host_ms,
          "what": "query token ids + packed features on the host",
          "profile_8_queries_rr_k50": prof})
    _crosscheck(kept[RERANK_K], rows_r, "e2e_crosscheck")
    _e2e_small_corpus(torch, be, ce, w)
    return total


def _rider_check(engine, qvecs, qstrings, out, phase="rerank_coalesce"):
    """Each coalesced rider against run_search with its knobs and qvec:
    ids equal up to near-tie swaps (finals within NEAR_TIE), finals within
    FINAL_TOL (the two paths chunk the same pairs differently)."""
    rows, scores = np.asarray(out[0]), np.asarray(out[1])
    worst, swaps = 0.0, 0
    for i, q in enumerate(qstrings):
        host = engine.run_search(q, qvec=qvecs[i], k=K, rerank_k=RERANK_K, **RERANK_KNOBS)[0]
        want = np.array([r["_final"] for r in host])
        check(len(host) == K and len(rows[i]) == K, phase, f"rider {i}: {len(rows[i])} rows")
        d = np.abs(scores[i] - want)
        same = [engine.products.skus[int(j)] == r["sku"] for j, r in zip(rows[i], host)]
        check(all(s or d[j] <= NEAR_TIE for j, s in enumerate(same)),
              phase, f"rider {i}: rows differ from run_search beyond a near tie")
        worst, swaps = max(worst, float(d.max())), swaps + same.count(False)
    check(worst <= FINAL_TOL, phase, f"riders' _final differs by {worst}")
    return {"riders": len(qstrings), "max_final_diff": worst, "rank_swaps": swaps,
            "near_tie": NEAR_TIE, "tol": FINAL_TOL}


def phase_rerank_coalesce(torch, engine, qvecs):
    """bench.py's coalesced-rerank measure: 16 riders at rerank_k=50 with
    the bench's weights on phase 4's engine (2000-character texts, so the
    pairs fill the S=512 bucket), one coalesced call against 16 calls of
    one rider, interleaved, 3 repeats, medians."""
    from review_recommender_tpu_torch.ops import attention as A

    _qv, _qt, qstrings = _bench_queries(BENCH_QUERIES, DIM, VOCAB)
    qv, qs = qvecs[:RIDERS], qstrings[:RIDERS]
    wts = [RERANK_W] * RIDERS

    def coal():
        return [t.cpu() for t in engine.query_rerank_batched_pw(
            qv, qs, wts, [RERANK_K] * RIDERS, POOL, K)]

    def seq():
        return [[t.cpu() for t in engine.query_rerank_batched_pw(
            qv[i:i + 1], qs[i:i + 1], wts[:1], [RERANK_K], POOL, K)] for i in range(RIDERS)]

    seq(), coal()  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t_seq, t_coal, n_seq, n_coal = [], [], [], []
    for _ in range(COAL_REPS):
        before = A.mha_kernel_launches
        t0 = time.perf_counter()
        seq_out = seq()
        t_seq.append((time.perf_counter() - t0) * 1e3)
        n_seq.append(A.mha_kernel_launches - before)
        before = A.mha_kernel_launches
        t0 = time.perf_counter()
        out = coal()
        t_coal.append((time.perf_counter() - t0) * 1e3)
        n_coal.append(A.mha_kernel_launches - before)
    total = A.mha_kernel_launches
    ms_seq, ms_coal = float(np.median(t_seq)), float(np.median(t_coal))
    check(out[0].shape == (RIDERS, K) and out[2].shape == (RIDERS, K, 7), "rerank_coalesce",
          f"shapes {out[0].shape} {out[2].shape}")
    same_as_single = sum(torch.equal(out[0][i], seq_out[i][0][0]) for i in range(RIDERS))
    chunks = -(-RIDERS * RERANK_K // 64)
    emit({"phase": "rerank_coalesce", "riders": RIDERS, "rerank_k": RERANK_K, "pool": POOL,
          "k": K, "sequential_ms": ms_seq, "coalesced_ms": ms_coal,
          "speedup": ms_seq / ms_coal, "rerank_qps": RIDERS / (ms_coal / 1e3),
          "sequential_runs_ms": t_seq, "coalesced_runs_ms": t_coal,
          "launches_per_coalesced_call": n_coal, "launches_per_sequential_pass": n_seq,
          "expected_coalesced": 6 * chunks, "reps": COAL_REPS,
          "riders_equal_to_their_single_call": same_as_single,
          "rider_check": _rider_check(engine, qv, qs, out)})
    check(all(n == 6 * chunks for n in n_coal) and all(n == 6 * RIDERS for n in n_seq),
          "rerank_coalesce", f"launches {n_coal} / {n_seq}")
    return total


class _ReviewTexts:
    """Review texts built on access from the review's row and product."""

    def __init__(self, prod):
        self._prod = prod

    def __len__(self):
        return len(self._prod)

    def __getitem__(self, i):
        return f"review {int(i)} of S{int(self._prod[i])}: " + " ".join(
            f"t{(int(i) * 7919 + j * 104729) % VOCAB + 1}" for j in range(24))


def _review_index(torch, products):
    """1,000,000 reviews of phase 4's products, each product drawn in
    proportion to its n_reviews; seeded unit rows (drawn on the card, kept
    in f32 on the host for the snippet texts), stars 1-5 with 1% NaN."""
    from review_recommender_tpu_torch.index.build import build_review_index

    rng = np.random.default_rng(11)
    n = products.n_docs
    p = products.n_reviews[:n].astype(np.float64)
    prod = rng.choice(n, size=N_REVIEWS, p=p / p.sum())
    stars = rng.integers(1, 6, N_REVIEWS).astype(np.float32)
    stars[rng.random(N_REVIEWS) < 0.01] = np.nan
    g = torch.Generator(device=DEV).manual_seed(11)
    emb = torch.randn(N_REVIEWS, products.dim, generator=g, device=DEV)
    emb = (emb / emb.norm(dim=1, keepdim=True)).cpu().numpy()
    skus = products.skus
    return build_review_index([skus[j] for j in prod], _ReviewTexts(prod), stars, emb, skus)


def phase_snippets(torch, engine):
    """The snippet lane on phase 4's corpus with a 1M-review table."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rev = _review_index(torch, engine.products)
    eng = SearchEngine(IndexBundle(products=engine.products, reviews=rev), device=DEV,
                       query_encoder=engine.query_encoder, cross_encoder=engine.cross_encoder)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    m = rev.n_reviews_total
    check(eng.rev_arrays["rev_emb"].dtype == torch.bfloat16, "snippets", "review table dtype")
    queries = _queries(N_QUERIES, DIM, VOCAB)
    qvecs = eng.query_encoder.encode(queries)  # encoded once: the lane is what is timed
    bq, _bt, bs = _bench_queries(BENCH_QUERIES, DIM, VOCAB)
    # a new engine has a cold featurizer: expand every token first, so that
    # the timings below hold the snippet lane and not the vocabulary expansion
    eng.featurizer.featurize_packed_batch(list(queries) + list(bs))
    eng.run_search(queries[0], qvec=qvecs[0], k=K, rerank_k=0, use_snips=True)  # warm-up

    out = {}
    for max_scan in (0, -1):
        lat, stages, n_snips = [], {}, []
        for i, q in enumerate(queries):
            t0 = time.perf_counter()
            rows, snips, dbg = eng.run_search(q, qvec=qvecs[i], k=K, rerank_k=0,
                                              use_snips=True, max_scan=max_scan)
            lat.append((time.perf_counter() - t0) * 1e3)
            _check_rows(rows, "snippets")
            check(not dbg.get("fused") and any(r["_best"] > 0 for r in rows), "snippets",
                  f"max_scan={max_scan}: no snippet lane in {dbg}")
            n_snips.append(len(snips))
            for name, ms in dbg["stage_ms"].items():
                stages.setdefault(name, []).append(ms)
        out[max_scan] = {**_pct(lat), "stage_ms_mean": {n: float(np.mean(v))
                                                        for n, v in stages.items()},
                         "snippets_per_query_mean": float(np.mean(n_snips))}
    w = FusionWeights.make(*BENCH_W[:4], 0.1, *BENCH_W[5:])  # the bench's, w_best 0.1
    lat, res = _batch_latencies(
        lambda lo, hi: eng.query_fused_batched(bq[lo:hi], bs[lo:hi], w, POOL, K, use_snips=True),
        BENCH_QUERIES, BATCHES[0])
    r = torch.cat([x[0] for x in res])
    sc = torch.cat([x[1] for x in res])
    _check_batch_rows(r, sc, "snippets")
    plain_lat, plain_res = _batch_latencies(
        lambda lo, hi: eng.query_fused_batched(bq[lo:hi], bs[lo:hi], w, POOL, K),
        BENCH_QUERIES, BATCHES[0])
    check(not torch.equal(plain_res[0][1], sc[:BATCHES[0]]), "snippets",
          "the batched snippet lane changed no score")
    prof_b = _profile(torch, lambda: [eng.query_fused_batched(
        bq[lo:lo + BATCHES[0]], bs[lo:lo + BATCHES[0]], w, POOL, K, use_snips=True)[0].cpu()
        for lo in range(0, BENCH_QUERIES, BATCHES[0])])

    # the review pass alone: profiler device time and CUDA-event medians
    q1 = torch.from_numpy(qvecs[0]).to(DEV)
    q32 = torch.from_numpy(qvecs[:32]).to(DEV)
    prof = _profile(torch, lambda: [eng._snippet_scores_impl(eng.rev_arrays, q1).cpu()
                                    for _ in range(10)])
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    pass_ms = {f"B{b}": _median_ms(torch, lambda: eng._snippet_scores_impl(eng.rev_arrays, qq),
                                   REPS, before=spin) for b, qq in ((1, q1), (32, q32))}
    n = eng.n_docs
    nbytes = m * eng.products.dim * 2 + m * 5 + n * 4  # rows, ids, flags read; maxima written

    # the device lane against a host segment max on a few queries
    e16 = torch.from_numpy(rev.rev_emb[:m]).to(torch.bfloat16).float().numpy()
    seg = rev.rev_product[:m]
    worst = 0.0
    for i in range(SNIP_CHECK_QUERIES):
        q16 = torch.from_numpy(qvecs[i]).to(torch.bfloat16).float().numpy()
        host = np.full(n + 1, -np.inf, np.float32)
        np.maximum.at(host, seg, e16 @ q16)
        dev = eng._snippet_scores_full(qvecs[i]).cpu().numpy()
        fin = np.isfinite(host[:n])
        check(bool(np.array_equal(np.isfinite(dev), fin)), "snippets",
              "products without reviews differ between the device and the host")
        worst = max(worst, float(np.abs(dev[fin] - host[:n][fin]).max()))
    check(worst <= SNIP_TOL, "snippets", f"device segment max differs by {worst}")
    del e16
    emit({"phase": "snippets", "reviews": m, "products_with_reviews": int(fin.sum()),
          "setup_s": setup_s, "queries": N_QUERIES, "k": K, "pool": POOL,
          "run_search_max_scan_0": out[0], "run_search_max_scan_-1": out[-1],
          "query_fused_batched_B32": {"per_batch": _pct(lat),
                                      "qps": BENCH_QUERIES / (sum(lat) / 1e3),
                                      "without_snippets_per_batch": _pct(plain_lat),
                                      "profile_8_batches": prof_b},
          "review_pass": {"device_ms_spun": pass_ms, "bytes": nbytes,
                          "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                          "profile_10_calls_B1": prof},
          "host_check": {"queries": SNIP_CHECK_QUERIES, "max_abs_err": worst, "tol": SNIP_TOL},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})


def _http(port, method, path, obj=None):
    """One request to a server on this host: (status, body). An error
    status is returned for the caller to check, not raised."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _ok_json(answer, what):
    check(answer is not None, "serve", f"{what}: no answer")
    code, body = answer
    check(code == 200, "serve", f"{what}: HTTP {code} {body[:300]!r}")
    return json.loads(body)


def _concurrent(port, payloads, clients):
    """`clients` threads in a closed loop: each sends the next payload to
    /search when its previous answer has arrived. Returns (answers in
    payload order, latencies ms, wall s)."""
    import threading

    answers, lat = [None] * len(payloads), [0.0] * len(payloads)
    order, lock = iter(range(len(payloads))), threading.Lock()
    start = threading.Barrier(clients)

    def client():
        start.wait()
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            t0 = time.perf_counter()
            answers[i] = _http(port, "POST", "/search", payloads[i])
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "serve", "a client did not finish")
    return [_ok_json(a, f"/search {i}") for i, a in enumerate(answers)], lat, wall


def _served(outs, sku_row):
    """Answers -> (row ids (n, K), finals (n, K))."""
    for i, o in enumerate(outs):
        check(len(o["results"]) == K, "serve", f"answer {i}: {len(o['results'])} rows")
    return (np.array([[sku_row[r["sku"]] for r in o["results"]] for o in outs], np.int64),
            np.array([[r["_final"] for r in o["results"]] for o in outs], np.float32))


def _load_run(front, port, payloads, windows, check_against, sku_row):
    """Step 2 on one front end: the payloads from SERVE_CLIENTS closed-loop
    clients, each answer checked against query_fused of its query; windows()
    reads the front end's (windows, riders) counters."""
    from review_recommender_tpu_torch.ops import attention as A

    w0, r0 = windows()
    before = A.mha_kernel_launches
    outs, lat, wall = _concurrent(port, payloads, SERVE_CLIENTS)
    launches = A.mha_kernel_launches - before
    w1, r1 = windows()
    rows, finals = _served(outs, sku_row)
    diff, swaps = _against_single(check_against, rows, finals, phase="serve")
    row = {"front_end": front, "requests": len(payloads), "clients": SERVE_CLIENTS,
           "requests_per_s": len(payloads) / wall, **_pct(lat),
           "p99_ms": float(np.percentile(lat, 99)), "windows": w1 - w0,
           "riders_per_window": (r1 - r0) / max(w1 - w0, 1), "attention_launches": launches,
           "expected_launches": 12 * len(payloads),
           "vs_query_fused": {"max_score_diff": diff, "rank_swaps": swaps}}
    emit({"phase": "serve", "step": "load", **row})
    check(launches == 12 * len(payloads) and r1 - r0 == len(payloads), "serve",
          f"{front}: {launches} attention launches, {r1 - r0} riders for {len(payloads)} requests")
    return outs, launches


def _sequential(port, payloads):
    """One request at a time: every window holds one rider."""
    return [_ok_json(_http(port, "POST", "/search", p), f"sequential /search {i}")
            for i, p in enumerate(payloads)]


def _featurize_times(products, queries):
    """Host featurize time per query (us), Python and native routes, each
    on a fresh featurizer: unseen queries first, then the same again."""
    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.featurize import QueryFeaturizer

    out, packed = {}, {}
    for route in ("python", "native"):
        f = QueryFeaturizer(products, query_terms_cap=config.QUERY_TERMS_CAP,
                            native=route == "native")
        check(f.route == route, "serve", f"featurizer route {f.route}")
        for pass_ in ("unseen", "repeat"):
            t0 = time.perf_counter()
            rows = [f.featurize_packed(q) for q in queries]
            out[f"{route}_{pass_}_us"] = (time.perf_counter() - t0) * 1e6 / len(queries)
        packed[route] = np.stack(rows)
    check(packed["python"].tobytes() == packed["native"].tobytes(), "serve",
          "the native featurizer's rows differ from the Python route's")
    return out


def phase_serve(torch, engine, qvecs):
    """Both HTTP front ends on phase 4's engine: the stdlib server with the
    micro-batcher, then the C++ epoll front end. Returns the attention
    launches of the served traffic (the in-process checks excluded)."""
    import threading

    from review_recommender_tpu_torch.ops import attention as A
    from review_recommender_tpu_torch.ops.fusion import FusionWeights
    from review_recommender_tpu_torch.serve.api import serve
    from review_recommender_tpu_torch.serve.native_server import serve_native
    from review_recommender_tpu_torch.evals.metrics import IRMetrics
    from review_recommender_tpu_torch.utils.profiling import TRACE_FILE

    _qv, _qt, qstrings = _bench_queries(BENCH_QUERIES, DIM, VOCAB)
    sku_row = {sku: i for i, sku in enumerate(engine.products.skus)}
    payloads = [{"query": q, "k": K, "rerank_k": 0, **SERVE_KNOBS}
                for q in qstrings[:SERVE_REQUESTS]]
    served = 0

    # 1. start, health, readiness (after warmup), info, metrics
    t0 = time.perf_counter()
    srv = serve(engine, host="127.0.0.1", port=0)
    warm_s = time.perf_counter() - t0
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port, batcher = srv.server_address[1], srv.service.batcher
    check(_ok_json(_http(port, "GET", "/healthz"), "/healthz") == {"status": "ok"}, "serve",
          "/healthz")
    check(_ok_json(_http(port, "GET", "/readyz"), "/readyz") == {"ready": True}, "serve",
          "/readyz")
    info = _ok_json(_http(port, "GET", "/debug/info"), "/debug/info")
    check(info["n_docs"] == N_DOCS and info["microbatch"] is not None, "serve", f"info {info}")
    code, metrics = _http(port, "GET", "/metrics")
    check(code == 200 and b"rrt_ready 1" in metrics, "serve", "/metrics")
    emit({"phase": "serve", "step": "start", "front_end": "stdlib", "warmup_s": warm_s,
          "info": {k: info[k] for k in ("n_docs", "dim", "gate_mode", "emb_dtype", "microbatch")}})

    # 2. 256 requests without qvec from 32 closed-loop clients (the
    # references first: launches of the checks are not counted)
    encoded = np.stack([engine.encode_query(q) for q in qstrings[:SERVE_REQUESTS]])
    w = FusionWeights.make(*BENCH_W)
    singles = _singles(engine, encoded, qstrings[:SERVE_REQUESTS], w)
    _zero_counts()
    std_outs, n = _load_run("stdlib", port, payloads,
                            lambda: (batcher.batches, batcher.coalesced), singles, sku_row)
    served += n

    # 3. 16 concurrent rerank riders (phase 10's texts, vectors and weights)
    riders = [{"query": q, "qvec": qvecs[i].tolist(), "k": K, "rerank_k": RERANK_K,
               **RERANK_KNOBS} for i, q in enumerate(qstrings[:RIDERS])]
    w0, before = batcher.batches, A.mha_kernel_launches
    outs, lat, wall = _concurrent(port, riders, RIDERS)
    launches, windows = A.mha_kernel_launches - before, batcher.batches - w0
    served += launches
    rows, finals = _served(outs, sku_row)
    rider = _rider_check(engine, qvecs[:RIDERS], qstrings[:RIDERS], (rows, finals), "serve")
    emit({"phase": "serve", "step": "rerank", "riders": RIDERS, "rerank_k": RERANK_K,
          "windows": windows, "wall_ms": wall * 1e3, **_pct(lat),
          "attention_launches": launches, "rider_check": rider})
    check(windows < RIDERS and launches > 0, "serve",
          f"{RIDERS} rerank riders took {windows} windows, {launches} attention launches")

    # 4. /search_batch of 32 queries, /eval of 10 judged queries
    batch_q = qstrings[:BATCHES[0]]
    before = A.mha_kernel_launches
    got = _ok_json(_http(port, "POST", "/search_batch",
                         {"queries": batch_q, "k": K, **SERVE_KNOBS}), "/search_batch")
    served += A.mha_kernel_launches - before
    check(got["batch"] == len(batch_q), "serve", f"/search_batch answered {got['batch']}")
    ref_r, ref_s = engine.query_fused_batched(engine.query_encoder.encode(batch_q), batch_q, w,
                                              POOL, K)
    ref = list(zip(ref_r.cpu().numpy(), ref_s.cpu().numpy()))
    b_rows, b_finals = _served([{"results": r} for r in got["results"]], sku_row)
    b_diff, b_swaps = _against_single(ref, b_rows, b_finals, phase="serve")
    judged_q = qstrings[BATCHES[0]:BATCHES[0] + EVAL_QUERIES]
    lists = [[r["sku"] for r in engine.run_search(q, k=K, rerank_k=0)[0]] for q in judged_q]
    rng = np.random.default_rng(12)
    judged = [{"id": f"q{i}", "query": q,
               "relevant_skus": [lists[i][1], lists[i][4], engine.products.skus[
                   int(rng.integers(N_DOCS))]]} for i, q in enumerate(judged_q)]
    before = A.mha_kernel_launches
    ev = _ok_json(_http(port, "POST", "/eval", {"queries": judged, "k": K, "rerank_k": 0}),
                  "/eval")
    served += A.mha_kernel_launches - before
    mine = IRMetrics()
    for j, ranked in zip(judged, lists):
        mine.evaluate_query(j["id"], ranked, set(j["relevant_skus"]))
    want = mine.aggregate_metrics()
    eval_diff = max(abs(ev["aggregate"][k] - v) for k, v in want.items())
    emit({"phase": "serve", "step": "batch_and_eval", "search_batch": len(batch_q),
          "vs_query_fused_batched": {"max_score_diff": b_diff, "rank_swaps": b_swaps},
          "eval_queries": EVAL_QUERIES, "eval_aggregate": ev["aggregate"],
          "eval_max_diff_vs_in_process": eval_diff})
    check(list(ev["aggregate"]) == list(want) and eval_diff <= 1e-12, "serve",
          f"/eval {ev['aggregate']} vs in-process {want}")

    # 5. /debug/trace: a Chrome trace whose CUDA kernels include attention
    before = A.mha_kernel_launches
    tr = _ok_json(_http(port, "POST", "/debug/trace",
                        {"query": qstrings[0], "n": TRACE_N, "k": K, "rerank_k": 0}),
                  "/debug/trace")
    served += A.mha_kernel_launches - before
    path = f"{tr['log_dir']}/{TRACE_FILE}"
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    attn = sum("mha_fwd_kernel" in k for k in kernels)
    emit({"phase": "serve", "step": "trace", "trace": path, "queries": TRACE_N,
          "ms_per_query": tr["ms_per_query"], "cuda_kernels": len(kernels),
          "attention_kernels": attn})
    check(attn > 0, "serve", f"the trace's {len(kernels)} CUDA kernels hold no attention kernel")

    sequential = [dict(p, qvec=qvecs[i].tolist()) for i, p in enumerate(payloads[:SERVE_SEQUENTIAL])]
    std_seq = _sequential(port, sequential)
    srv.shutdown()
    srv.server_close()
    srv.service.close()

    # 6. the same through the native front end
    t0 = time.perf_counter()
    nat = serve_native(engine, host="127.0.0.1", port=0)
    warm_s = time.perf_counter() - t0
    try:
        check(_ok_json(_http(nat.port, "GET", "/readyz"), "/readyz") == {"ready": True},
              "serve", "native /readyz")
        emit({"phase": "serve", "step": "start", "front_end": "native", "warmup_s": warm_s})
        bs = nat.batch_stats
        nat_outs, n = _load_run("native", nat.port, payloads, lambda: (bs.batches, bs.coalesced),
                                singles, sku_row)
        served += n
        nat_seq = _sequential(nat.port, sequential)
        stats = nat.stats()
    finally:
        nat.close()
    same = lambda a, b: (a["results"], a["snippets"]) == (b["results"], b["snippets"])
    seq_equal = sum(same(a, b) for a, b in zip(nat_seq, std_seq))
    load_equal = sum(same(a, b) for a, b in zip(nat_outs, std_outs))
    n_rows, n_fin = _served(nat_outs, sku_row)
    s_rows, s_fin = _served(std_outs, sku_row)
    diff, swaps = _against_single(list(zip(s_rows, s_fin)), n_rows, n_fin, phase="serve")
    emit({"phase": "serve", "step": "native_vs_stdlib", "native_stats": stats,
          "sequential_equal": seq_equal, "sequential": len(sequential),
          "load_equal": load_equal, "load": len(payloads),
          "load_max_score_diff": diff, "load_rank_swaps": swaps,
          "what": "results and snippets of each answer; one at a time both front ends run "
                  "windows of one rider, under load the windows differ"})
    check(seq_equal == len(sequential), "serve",
          f"native answers equal the stdlib's for {seq_equal} of {len(sequential)} requests")

    # 7. host featurize time per query, both routes
    emit({"phase": "serve", "step": "featurize", "queries": SERVE_REQUESTS,
          **_featurize_times(engine.products, qstrings[:SERVE_REQUESTS])})
    return served


def _bundle_diffs(a, b) -> list:
    """Fields of two bundles that differ: arrays bit for bit (dtype and
    shape included), host columns by equality."""
    out = []
    for name, x, y in (("products", a.products, b.products), ("reviews", a.reviews, b.reviews)):
        if x is None or y is None:
            out += [] if x is None and y is None else [name]
            continue
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                same = (isinstance(u, np.ndarray) and isinstance(v, np.ndarray)
                        and u.dtype == v.dtype and u.shape == v.shape
                        and np.array_equal(u, v, equal_nan=u.dtype.kind == "f"))
            elif f.name in ("agg_texts", "rev_texts"):
                same = len(u) == len(v) and all(str(p) == str(q) for p, q in zip(u, v))
            else:
                same = u == v
            if not same:
                out.append(f"{name}.{f.name}")
    return out


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


def _cli(argv):
    """cli.main(argv) in process: (exit code, what it printed)."""
    import contextlib
    import io

    from review_recommender_tpu_torch.serve import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    return code, buf.getvalue()


def _cli_process(args, timeout=600):
    """`python -m review_recommender_tpu_torch.serve.cli ARGS` from the repo
    root, run to its end: (exit code, stdout, stderr)."""
    import os

    env = {**os.environ, "PYTHONPATH": str(REPO_DIR), "LOG_FILE": str(OFFLINE_DIR / "app.log")}
    proc = subprocess.run([sys.executable, "-m", "review_recommender_tpu_torch.serve.cli", *args],
                          cwd=REPO_DIR, env=env, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def _serve_process(index_dir, native: bool, query: str) -> dict:
    """`serve` in a subprocess on a free port: /healthz, /readyz (polled
    until 200), one /search, then SIGTERM; it must exit 0."""
    import os
    import signal
    import threading

    env = {**os.environ, "PYTHONPATH": str(REPO_DIR), "LOG_FILE": str(OFFLINE_DIR / "app.log")}
    cmd = [sys.executable, "-m", "review_recommender_tpu_torch.serve.cli", "serve",
           "--index-dir", str(index_dir), "--host", "127.0.0.1", "--port", "0", "--device", DEV]
    front = "native" if native else "stdlib"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + (["--native"] if native else []), cwd=REPO_DIR, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(600, proc.kill)  # a hung start ends the read below
    watchdog.start()
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on http://127.0.0.1:"):
            proc.kill()
            raise PhaseError(f"offline_serve {front}: no 'serving on' line ({line!r}): "
                             f"{proc.stderr.read()[-1500:]}")
        port = int(line.split(":")[2].split()[0])
        bound_s = time.perf_counter() - t0
        health = _http(port, "GET", "/healthz")[0]
        check(health == 200, "offline_serve", f"{front} /healthz {health}")
        deadline = time.time() + 300
        while _http(port, "GET", "/readyz")[0] != 200:
            check(time.time() < deadline, "offline_serve", f"{front} not ready after 300 s")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        code, body = _http(port, "POST", "/search", {"query": query, "k": K, "rerank_k": 0})
        check(code == 200, "offline_serve", f"{front} /search HTTP {code} {body[:300]!r}")
        _check_rows(json.loads(body)["results"], "offline_serve")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, "offline_serve", f"{front} exited {rc} after SIGTERM: "
                                        f"{proc.stderr.read()[-1500:]}")
        return {"front_end": front, "port": port, "bound_s": bound_s, "ready_s": ready_s,
                "healthz": health, "readyz": 200, "search_rows": K, "exit_code": rc}
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def _round_trip(bundle, out_dir, phase):
    """save_bundle then load_bundle (checksums verified): seconds, bytes on
    disk, and the fields that differ (none expected)."""
    from review_recommender_tpu_torch.index.io import load_bundle, save_bundle

    t0 = time.perf_counter()
    save_bundle(bundle, out_dir)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_bundle(out_dir)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_bundle(out_dir, verify_checksums=True)
    verified_load_s = time.perf_counter() - t0
    diffs = _bundle_diffs(bundle, loaded)
    check(not diffs, phase, f"the reloaded bundle differs in {diffs}")
    return loaded, {"save_s": save_s, "load_s": load_s, "verified_load_s": verified_load_s,
                    "bytes": _dir_bytes(out_dir),
                    "files": {f.name: f.stat().st_size for f in sorted(out_dir.iterdir())},
                    "bit_equal": True}


def phase_offline(torch, engine_200k):
    """Phase 13: the offline path at the quality table's size, the quality
    lane on the card, the CLI in process and as a subprocess, and phase 4's
    bundle saved and loaded. Returns the attention launches of the CLI's
    counted search."""
    import shutil

    from review_recommender_tpu_torch.evals import quality_table as QT
    from review_recommender_tpu_torch.evals.benchmark import run_performance_benchmark
    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models.bow import BowProjectionEncoder
    from review_recommender_tpu_torch.serve import cli

    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0] if card else "nvidia-smi: no output"
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    OFFLINE_DIR.mkdir(parents=True)
    bdir = OFFLINE_DIR / "quality_bundle"

    # 1. build, save, load
    t0 = time.perf_counter()
    products, queries = QT.build_corpus(QT_THEMES, QT_PER_THEME, QT_QUERIES, seed=QT_SEED)
    corpus_s = time.perf_counter() - t0
    encoder = BowProjectionEncoder(dim=QT.BOW_DIM, seed=QT.BOW_SEED)
    t0 = time.perf_counter()
    emb = encoder.encode([p["agg_text"] for p in products])
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = build_bundle_from_products(products, emb, doc_terms_cap=QT.DOC_TERMS_CAP,
                                       pad_multiple=QT.PAD_MULTIPLE)
    build_s = time.perf_counter() - t0
    loaded, rt = _round_trip(built, bdir, "offline_build")
    p = loaded.products
    emit({"phase": "offline_build", "card": card, "products": p.n_docs, "n_padded": p.n_padded,
          "queries": len(queries), "dim": p.dim, "terms_cap": p.terms_cap,
          "vocab": len(p.vocab), "corpus_s": corpus_s, "bow_encode_s": encode_s,
          "build_s": build_s, "tokenizer": "native", **rt})

    # 2. the quality lane on the loaded bundle, on the card
    with open(REPO_DIR / QT_REFERENCE) as f:
        reference = json.load(f)
    _zero_counts()
    engine, results = QT.run_lane(loaded, encoder, queries, DEV)
    lane_counts = _counts()
    floor = next(iter(results.values()))["latency"]["rpc_floor_ms"]
    table, worst = {}, 0.0
    for method, res in results.items():
        row = {}
        for m in QT_METRICS:
            got, want = res["aggregate"][m], reference[method]["aggregate"][m]
            row[m] = {"port": got, "jax": want, "delta": got - want}
            worst = max(worst, abs(got - want))
        lat = res["latency"]
        table[method] = {**row, "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
                         "qps": lat["qps"], "engine_p50_ms": lat["engine_p50_ms"]}
    emit({"phase": "offline_quality", "card": card, "device": str(engine.device),
          "gate_mode": engine.gate_mode, "dense_pool": engine.dense_pool,
          "emb_dtype": str(engine.dtype), "rpc_floor_ms": floor, "reference": QT_REFERENCE,
          "tol": QT_TOL, "max_abs_delta": worst, "methods": table,
          "kernel_launches": lane_counts})
    check(worst <= QT_TOL, "offline_quality",
          f"a quality number differs from the JAX lane's by {worst} > {QT_TOL}")
    check(not any(lane_counts.values()), "offline_quality",
          f"the bow lane launched a custom kernel: {lane_counts}")
    del engine

    # 3. the CLI in process, on random bge-small / MiniLM-L6 towers in bf16
    query = queries[0]["query"]
    dev = ["--device", DEV]
    code, out = _cli(["audit", "--index-dir", str(bdir), *dev])
    audit = json.loads(out)
    check(code == 0 and audit["ok"], "offline_cli", f"audit exit {code}: {audit['checks']}")
    _zero_counts()
    code, out = _cli(["search", query, "--index-dir", str(bdir), "--rerank-k", str(RERANK_K),
                      "--json-out", str(OFFLINE_DIR / "search.json"), *dev])
    search_counts = _counts()
    check(code == 0, "offline_cli", f"search exit {code}")
    cli_rows = json.loads((OFFLINE_DIR / "search.json").read_text())["results"]
    ref_engine = cli._load_engine(str(bdir), with_rerank=True, device=DEV)
    rows = ref_engine.run_search(query, k=K, rerank_k=RERANK_K)[0]
    _check_rows(cli_rows, "offline_cli")
    worst_row = max(abs(a[c] - b[c]) for a, b in zip(cli_rows, rows)
                    for c in a if isinstance(a[c], float) and np.isfinite(a[c]))
    same = json.dumps(cli_rows) == json.dumps(rows)  # every field exact, NaN included
    want = {**{n: 0 for n in search_counts}, "mha_fwd": 12 + 6}
    code_b, out_b = _cli(["bench", "--index-dir", str(bdir), "--n-queries", "64", *dev])
    bench = json.loads(out_b.strip().splitlines()[-1])
    judged = OFFLINE_DIR / "judged.jsonl"
    judged.write_text("".join(json.dumps(q) + "\n" for q in queries))
    code_e, _out_e = _cli(["eval", "--index-dir", str(bdir), "--queries", str(judged),
                           "--out", str(OFFLINE_DIR / "eval"), *dev])
    evaluated = json.loads((OFFLINE_DIR / "eval" / "benchmark_results.json").read_text())
    direct = run_performance_benchmark(ref_engine.run_search, queries, warmup=True)
    eval_diff = max(abs(evaluated[m]["aggregate"][k] - direct[m]["aggregate"][k])
                    for m in direct for k in direct[m]["aggregate"])
    emit({"phase": "offline_cli", "card": card, "query": query, "audit_ok": audit["ok"],
          "audit_checks": len(audit["checks"]), "search_rows": len(cli_rows),
          "search_equals_run_search": same, "search_max_abs_diff": worst_row,
          "search_launches": search_counts, "expected_launches": want,
          "bench": bench, "bench_exit": code_b, "eval_exit": code_e,
          "eval_max_abs_diff_vs_run_performance_benchmark": eval_diff,
          "eval": {m: {k: evaluated[m]["aggregate"][k] for k in QT_METRICS} for m in evaluated}})
    check(same, "offline_cli", f"CLI search rows differ from run_search (max {worst_row})")
    check(search_counts == want, "offline_cli", f"search launches {search_counts}, want {want}")
    check(code_b == 0 and bench["n_docs"] == p.n_docs, "offline_cli", f"bench {code_b} {bench}")
    check(code_e == 0 and eval_diff == 0.0, "offline_cli",
          f"eval exit {code_e}, differs from run_performance_benchmark by {eval_diff}")
    del ref_engine

    # 4. the CLI as a subprocess, then both serve front ends
    steps = {}
    for name, args in (("audit", ["audit", "--index-dir", str(bdir), *dev]),
                       ("search", ["search", query, "--index-dir", str(bdir), *dev])):
        t0 = time.perf_counter()
        rc, out, err = _cli_process(args)
        steps[name] = {"exit_code": rc, "seconds": time.perf_counter() - t0}
        check(rc == 0, "offline_subprocess", f"{name} exited {rc}: {err[-1500:]}")
    emit({"phase": "offline_subprocess", "card": card, **steps})
    for native in (False, True):
        emit({"phase": "offline_serve", "card": card, **_serve_process(bdir, native, query)})

    # 5. phase 4's 200k bundle saved and loaded: a server's start-up read
    big = IndexBundle(products=engine_200k.products)
    _loaded_200k, rt = _round_trip(big, OFFLINE_DIR / "bundle_200k", "offline_200k")
    emit({"phase": "offline_200k", "card": card, "n_docs": big.products.n_docs,
          "dim": big.products.dim, "terms_cap": big.products.terms_cap,
          "has_doc_bm25": big.products.doc_bm25 is not None,
          "has_doc_tokens": big.products.doc_tokens is not None, **rt})
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    return search_counts["mha_fwd"]


def _card() -> str:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return smi.splitlines()[0] if smi else "nvidia-smi: no output"


def _pool_on_cpu(engine, q):
    """engine._dense_topk on CPU copies of its tensors (the plain version)."""
    return engine._dense_topk({k: v.cpu() for k, v in engine.arrays.items()}, q.cpu(), POOL)


def _exact_bf16_pool(torch, emb, valid, qv):
    """The exact bf16 pool of qv (B, D) over a placed corpus, on the card."""
    from review_recommender_tpu_torch.ops.dense import dense_topk

    return dense_topk(emb, torch.from_numpy(qv).to(DEV), valid, POOL)[1].cpu().numpy()


def _config_engine_pass(torch, engine, qvecs, qstrings, name, w):
    """The numbers of one int8 / IVF engine on the main path: run_search at
    rerank_k 0 (CFG_QUERIES queries, 12 attention launches each),
    search_dense, query_fused_batched QPS at B = 32 and 128 with the peak
    device memory of each. Returns the attention launches."""
    queries = qstrings[:CFG_QUERIES]
    _check_rows(engine.run_search(queries[0], k=K, rerank_k=0)[0], name)
    engine.search_dense(qvecs[0], K)[0].cpu()
    torch.cuda.synchronize()
    _zero_counts()
    lat = []
    for q in queries:
        t0 = time.perf_counter()
        rows = engine.run_search(q, k=K, rerank_k=0)[0]
        lat.append((time.perf_counter() - t0) * 1e3)
        _check_rows(rows, name)
    counts = _counts()
    want = {**{n: 0 for n in counts}, "mha_fwd": 12 * len(queries)}
    check(counts == want, name, f"run_search launches {counts}, want {want}")
    dense = []
    for i in range(CFG_QUERIES):
        t0 = time.perf_counter()
        ids, sc = engine.search_dense(qvecs[i], K)
        ids.cpu()
        dense.append((time.perf_counter() - t0) * 1e3)
    qps, peak = {}, {}
    for b in BATCHES:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        qps[b] = _batched_qps(engine, qvecs, qstrings, w, b)
        peak[b] = torch.cuda.max_memory_allocated() - base
    emit({"phase": name, "card": _card(), "dense_pool": engine.dense_pool,
          "int8": engine.int8_mode, "run_search_rerank_k0": _pct(lat),
          "search_dense": _pct(dense), "batched_qps": {f"B{b}": qps[b] for b in BATCHES},
          "peak_bytes_over_resident": {f"B{b}": peak[b] for b in BATCHES},
          "attention_launches": counts["mha_fwd"], "queries_cut_to": CFG_QUERIES})
    return counts["mha_fwd"]


def _op_row(torch, name, fn, nbytes, ops, peak_ops, reps=20):
    """One line of device work that is not a Pallas kernel: the median of
    `reps` CUDA-event-timed calls behind a warm-up, and its bound: the
    larger of the bytes over the HBM rate and the operations over their
    type's peak."""
    fn()
    torch.cuda.synchronize()
    ms = _median_ms(torch, fn, reps)
    by_bytes, by_ops = nbytes / PEAK_HBM_BYTES * 1e3, ops / peak_ops * 1e3
    return {"op": name, "ms": ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def _int8_op_rows(torch, eng, qvecs):
    """dense_scores_int8 alone (the int8 product, rescale and mask) at
    B = 1, 32, 128 on the engine's corpus."""
    from review_recommender_tpu_torch.ops.dense import dense_scores_int8

    a = eng.arrays
    n, d = a["emb_q"].shape
    rows = []
    for b in (1,) + BATCHES:
        q = torch.from_numpy(qvecs[:b]).to(DEV)
        q = q[0] if b == 1 else q
        nbytes = n * d + n * 4 + n + b * d * 4 + b * n * 4
        rows.append({"B": b, **_op_row(torch, "dense_scores_int8", lambda: dense_scores_int8(
            a["emb_q"], a["emb_scale"], q, a["valid"]), nbytes, 2 * b * n * d, PEAK_INT8_OPS)})
    return rows


def _ivf_op_rows(torch, eng, cq):
    """ivf_topk alone at B = 1, 32, 128 (nprobe 64, pool 150), and one
    k-means assignment of a 65,536-row block against the centroids (f32)."""
    from review_recommender_tpu_torch.ops.ivf import IVF_KEYS, ivf_topk
    from review_recommender_tpu_torch.topics.cluster import _assign

    a = eng.arrays
    dev = tuple(a[k] for k in IVF_KEYS)
    nb, mb, d = a["ivf_blocks"].shape
    c = a["ivf_centroids"].shape[0]
    it = a["ivf_blocks"].element_size()
    npb = min(eng.ivf_nprobe, nb)
    rows = []
    for b in (1,) + BATCHES:
        q = torch.from_numpy(cq[:b]).to(DEV)
        q = q[0] if b == 1 else q
        nbytes = c * d * it + nb * 8 + nb * mb + b * npb * mb * (d * it + 5) + b * d * 4 \
            + b * POOL * 12
        ops = 2 * b * c * d + 2 * b * npb * mb * d
        rows.append({"B": b, "nprobe": npb, **_op_row(
            torch, "ivf_topk", lambda: ivf_topk(*dev, q, POOL, npb), nbytes, ops,
            PEAK_BF16_FLOPS)})
    blk = a["emb"][:65536].float()
    cen = a["ivf_centroids"].float()
    ok = torch.ones(blk.shape[0], dtype=torch.bool, device=DEV)
    r = blk.shape[0]
    nbytes = r * d * 4 + c * d * 4 + r + r * 8 + c * 4 + c * d * 4
    rows.append({"rows": r, "centroids": c, **_op_row(
        torch, "kmeans_assign", lambda: _assign(blk, cen, ok, c), nbytes, 2 * r * c * d,
        PEAK_FP32_FLOPS, reps=10)})
    return rows


def _int8_configs(torch, engine_bf16, be, qvecs, qstrings, w):
    """EMB_DTYPE=int8, exact and striped, on phase 4's corpus."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.schema import IndexBundle

    p = engine_bf16.products
    ref = _exact_bf16_pool(torch, engine_bf16.arrays["emb"], engine_bf16.arrays["valid"], qvecs)
    launches = 0
    for pool in ("exact", "striped"):
        t0 = time.perf_counter()
        eng = SearchEngine(IndexBundle(products=p), device=DEV, emb_dtype="int8",
                           dense_pool=pool, query_encoder=be)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        name = f"config_int8_{pool}"
        check(eng.int8_mode and "emb" not in eng.arrays and eng.dense_pool == pool, name,
              f"engine {eng.dense_pool} int8={eng.int8_mode} arrays {sorted(eng.arrays)}")
        corpus = {k: v.numel() * v.element_size() for k, v in eng.arrays.items()
                  if k in ("emb_q", "emb_scale", "emb_qs", "emb_scale_s", "valid_s")}
        # held to the plain version on the CPU: ids and scores bit-equal
        q16 = torch.from_numpy(qvecs[:CFG_CHECK]).to(DEV)
        s_dev, i_dev = eng._dense_topk(eng.arrays, q16, POOL)
        s_cpu, i_cpu = _pool_on_cpu(eng, q16)
        bit_equal = bool(torch.equal(i_dev.cpu(), i_cpu) and torch.equal(s_dev.cpu(), s_cpu))
        pool_ids = eng._dense_topk(eng.arrays, torch.from_numpy(qvecs).to(DEV), POOL)[1]
        recall = _recall(ref, pool_ids.cpu().numpy())
        emit({"phase": f"{name}_setup", "card": _card(), "init_s": init_s,
              "corpus_device_bytes": corpus, "corpus_total_bytes": sum(corpus.values()),
              "bf16_emb_bytes": engine_bf16.arrays["emb"].numel() * 2,
              "hbm_estimate_bytes": eng.hbm_report["total_bytes"],
              "check_queries": CFG_CHECK, "bit_equal_to_cpu": bit_equal,
              "max_abs_err": float((s_dev.cpu() - s_cpu).abs().max()),
              "pool_recall_vs_bf16_exact": recall, "recall_queries": len(qvecs)})
        check(bit_equal, name, "card pool differs from the plain version on the CPU")
        if pool == "exact":
            emit({"phase": "config_device_ops", "card": _card(),
                  "rows": _int8_op_rows(torch, eng, qvecs)})
        launches += _config_engine_pass(torch, eng, qvecs, qstrings, name, w)
        del eng
    return launches


def _clustered_products(torch, products):
    """Phase 4's products with bench.py's clustered geometry in place of its
    isotropic rows (same shape; bench.py's IVF section, seed 7: 256 unit
    centers, noise of norm 0.7 per row), and 256 queries drawn near rows."""
    rng = np.random.default_rng(IVF_SEED)
    n, d = products.n_docs, products.dim
    centers = rng.standard_normal((IVF_CLUSTERS, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = centers[rng.integers(0, IVF_CLUSTERS, n)] + (IVF_NOISE / np.sqrt(d)) * \
        rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    qs = emb[rng.integers(0, n, BENCH_QUERIES)] + (0.5 / np.sqrt(d)) * \
        rng.standard_normal((BENCH_QUERIES, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    full = np.zeros_like(products.emb)
    full[:n] = emb
    return dataclasses.replace(products, emb=full), qs.astype(np.float32)


def _ivf_config(torch, engine_bf16, be, qvecs, qstrings, w):
    """DENSE_POOL_MODE=ivf at the auto sizes on the clustered corpus, and
    the self-check on phase 4's isotropic corpus (reported, not held)."""
    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.ops.ivf import IVF_KEYS, ivf_footprint_bound, ivf_topk

    products, cq = _clustered_products(torch, engine_bf16.products)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = SearchEngine(IndexBundle(products=products), device=DEV, dense_pool="ivf",
                       query_encoder=be)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base  # engine, k-means, self-check
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    name = "config_ivf"
    st = eng.ivf.stats
    a = eng.arrays
    emb_bytes = a["emb"].numel() * a["emb"].element_size()
    bound = ivf_footprint_bound(products.n_docs, products.dim, a["emb"].element_size(),
                                config.IVF_CENTROIDS, config.IVF_BLOCK_ROWS)
    ref = _exact_bf16_pool(torch, a["emb"], a["valid"], cq)
    recall = {}
    for nprobe in IVF_NPROBES:
        eng.ivf_nprobe = nprobe
        recall[nprobe] = _recall(ref, eng._dense_topk(a, torch.from_numpy(cq).to(DEV),
                                                      POOL)[1].cpu().numpy())
    eng.ivf_nprobe = config.IVF_NPROBE
    recall_peak = torch.cuda.max_memory_allocated() - base  # B=256 at nprobe 64 and 256
    # held to ivf_topk's plain version on the CPU, given the card-built index
    dev = tuple(a[k] for k in IVF_KEYS)
    q16 = torch.from_numpy(cq[:CFG_CHECK]).to(DEV)
    s_dev, i_dev = ivf_topk(*dev, q16, POOL, eng.ivf_nprobe)
    s_cpu, i_cpu = ivf_topk(*(t.cpu() for t in dev), q16.cpu(), POOL, eng.ivf_nprobe)
    s_dev, i_dev = s_dev.cpu(), i_dev.cpu()
    err = float((s_dev - s_cpu).abs().max())
    differ = (i_dev != i_cpu)
    near = differ & ((s_dev - s_cpu).abs() <= STAGE_A_TOL)
    emit({"phase": f"{name}_setup", "card": _card(), "corpus": "phase 4's products, "
          "bench.py's clustered rows (256 centers, noise 0.7, seed 7)",
          "init_s": init_s, "seed_s": st["seed_s"], "kmeans_iters_s": st["iters_s"],
          "kmeans_iters": st["iters"], "centroids": st["n_centroids"],
          "block_rows": st["block_rows"], "blocks": st["n_blocks"], "fill": st["fill"],
          "nprobe": eng.ivf_nprobe, "selfcheck_recall": eng.ivf_pool_recall,
          "selfcheck_min": config.IVF_SELFCHECK_MIN,
          "pool_recall_vs_bf16_exact": {f"nprobe{k}": v for k, v in recall.items()},
          "ivf_device_bytes": st["device_bytes"], "jax_estimate_bytes": int(1.25 * emb_bytes),
          "bound_bytes": bound,
          "emb_bytes": emb_bytes,
          "init_peak_bytes_over_resident": init_peak,
          "recall_pass_peak_bytes_over_resident": recall_peak,
          "check_queries": CFG_CHECK, "max_abs_err_vs_cpu": err,
          "ids_differ": int(differ.sum()), "ids_differ_beyond_near_tie": int((differ & ~near).sum())})
    check(eng.ivf_pool_recall >= config.IVF_SELFCHECK_MIN, name,
          f"self-check recall {eng.ivf_pool_recall} < {config.IVF_SELFCHECK_MIN}")
    check(err <= STAGE_A_TOL and not (differ & ~near).any(), name,
          f"card ivf_topk differs from the CPU run: {err}, {int((differ & ~near).sum())} ids")
    check(st["device_bytes"] <= bound, name, f"IVF bytes {st['device_bytes']} over the bound {bound}")
    emit({"phase": "config_device_ops", "card": _card(), "rows": _ivf_op_rows(torch, eng, cq)})
    launches = _config_engine_pass(torch, eng, cq, qstrings, name, w)
    del eng
    t0 = time.perf_counter()
    iso = SearchEngine(IndexBundle(products=engine_bf16.products), device=DEV, dense_pool="ivf")
    emit({"phase": "config_ivf_isotropic", "card": _card(), "init_s": time.perf_counter() - t0,
          "corpus": "phase 4's isotropic rows (IVF's worst case)",
          "selfcheck_recall": iso.ivf_pool_recall, "blocks": iso.ivf.n_blocks,
          "fill": iso.ivf.stats["fill"], "warned": iso.ivf_pool_recall < config.IVF_SELFCHECK_MIN})
    del iso
    return launches


def _write_safetensors(path, arrays) -> None:
    """The safetensors layout, written here rather than by the reader's
    package: 8-byte little-endian header length, JSON header, raw f32."""
    header, off, blobs = {}, 0, []
    for name, arr in arrays.items():
        b = np.ascontiguousarray(arr, dtype="<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape), "data_offsets": [off, off + len(b)]}
        off += len(b)
        blobs.append(b)
    head = json.dumps(header).encode()
    head += b" " * ((-len(head)) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for b in blobs:
            f.write(b)


def _golden_vocab(path) -> None:
    """A 30,522-line WordPiece vocab in bert-base-uncased's layout ([PAD] 0,
    [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103), then the
    synthetic corpus's words t1..tN whole and the '##' digit pieces that
    split the rest (t29500 -> t2950 ##0)."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                               "[MASK]", "t"]
    lines += [f"##{i}" for i in range(10)] + [f"##{i:02d}" for i in range(100)]
    lines += [f"##{i:03d}" for i in range(1000)]
    lines += [f"t{i}" for i in range(1, WP_VOCAB - len(lines) + 1)]
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")


def _write_towers(torch) -> dict:
    """The full-size golden's towers on disk, from its manifest and seeds
    (tests/golden_utils.py): per kind an HF snapshot with model.safetensors
    (written here), one with pytorch_model.bin, and a native tower
    (params.msgpack, config.json with the rrt-native-v1 marker), each with
    the 30,522-line vocab. Returns {(kind, layout): dir} and the seconds."""
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.convert import convert_biencoder, convert_crossencoder
    from review_recommender_tpu_torch.models.load import write_flax_msgpack
    from tests.golden_utils import manifest_from_npz, synth_state_arrays

    import shutil

    shutil.rmtree(TOWER_DIR, ignore_errors=True)
    TOWER_DIR.mkdir(parents=True)
    g = np.load(GOLDEN)
    vocab = TOWER_DIR / "vocab.txt"
    _golden_vocab(vocab)
    out, secs = {}, {}
    for kind, (_io, manifest, seed) in GOLDEN_SEEDS.items():
        t0 = time.perf_counter()
        sd = synth_state_arrays(manifest_from_npz(g, manifest), seed=seed)
        cfg = BertConfig.bge_small() if kind == "biencoder" else BertConfig.minilm_l6_cross()
        hf_cfg = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                  "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                  "intermediate_size": cfg.intermediate_size,
                  "max_position_embeddings": cfg.max_position, "type_vocab_size": 2,
                  "layer_norm_eps": 1e-12, "hidden_act": "gelu", "pad_token_id": 0}
        for layout in ("safetensors", "bin", "native"):
            d = TOWER_DIR / f"{kind}_{layout}"
            d.mkdir()
            shutil.copy(vocab, d / "vocab.txt")
            if layout == "safetensors":
                _write_safetensors(d / "model.safetensors", sd)
            elif layout == "bin":
                torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                           d / "pytorch_model.bin")
            else:
                conv = convert_biencoder if kind == "biencoder" else convert_crossencoder
                (d / "params.msgpack").write_bytes(write_flax_msgpack(conv(sd, cfg)))
                hf = {"format": "rrt-native-v1", "kind": kind, "pooling": "cls",
                      "tokenizer": {"type": "wordpiece", "lowercase": True},
                      **dataclasses.asdict(cfg)}
                (d / "config.json").write_text(json.dumps(hf))
                out[kind, layout] = d
                continue
            (d / "config.json").write_text(json.dumps(hf_cfg))
            out[kind, layout] = d
        secs[kind] = time.perf_counter() - t0
    return out, secs


def _golden_forward(torch, tower, kind, g):
    """The tower's forward on the golden's inputs, f32 numpy."""
    prefix = GOLDEN_SEEDS[kind][0]
    ids, mask, tt = (torch.from_numpy(g[f"{prefix}in_{k}"].astype(np.int32)).to(DEV)
                     for k in ("ids", "mask", "tt"))
    with torch.inference_mode():
        return tower.model(ids, mask, tt).float().cpu().numpy()


def _tower_configs(torch, engine_bf16, w):
    """Towers from disk: write the golden's snapshots, load each through
    models/load.py on the card, F3's measurement against the golden's f32
    HF outputs, forward times, then run_search and query_e2e at rerank_k
    50. Returns the attention launches of the counted runs."""
    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.io import save_bundle
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models import load
    from review_recommender_tpu_torch.models.load import read_safetensors
    from review_recommender_tpu_torch.ops import attention as A
    from review_recommender_tpu_torch.serve import cli

    import shutil

    card = _card()
    dirs, write_s = _write_towers(torch)
    # the writer is not trusted to check itself: its file against the .bin
    for kind in GOLDEN_SEEDS:
        st = read_safetensors(dirs[kind, "safetensors"] / "model.safetensors")
        bn = torch.load(dirs[kind, "bin"] / "pytorch_model.bin", weights_only=True)
        check(sorted(st) == sorted(bn) and all(np.array_equal(st[k], bn[k].numpy()) for k in st),
              "config_towers", f"{kind}: safetensors and .bin weights differ")
    g = np.load(GOLDEN)
    towers, load_s, golden = {}, {}, {}
    for kind in GOLDEN_SEEDS:
        loader = load.load_biencoder if kind == "biencoder" else load.load_crossencoder
        outs = {}
        for layout in ("safetensors", "bin", "native"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tower = loader(dirs[kind, layout], device=DEV)
            torch.cuda.synchronize()
            load_s[f"{kind}_{layout}"] = time.perf_counter() - t0
            outs[layout] = _golden_forward(torch, tower, kind, g)
            towers[kind] = tower
        check(all(np.array_equal(outs["safetensors"], o) for o in outs.values()),
              "config_towers", f"{kind}: the three layouts load different towers")
        tower = towers[kind]
        want = g[f"{GOLDEN_SEEDS[kind][0]}out"]
        tower.set_attn_impl("reference")
        ref = _golden_forward(torch, tower, kind, g)
        tower.set_attn_impl("auto")
        golden[kind] = {"kernel_max_abs_diff": float(np.abs(outs["safetensors"] - want).max()),
                        "reference_max_abs_diff": float(np.abs(ref - want).max()),
                        "kernel_vs_reference": float(np.abs(outs["safetensors"] - ref).max()),
                        "hf_out_range": [float(want.min()), float(want.max())]}
    be, ce = towers["biencoder"], towers["crossencoder"]
    fwd = {}
    with torch.inference_mode():
        for name, tower, (b, s) in (("biencoder_B1_S16", be, (1, 16)),
                                    ("crossencoder_B50_S287", ce, (50, 287)),
                                    ("crossencoder_B64_S512", ce, (64, 512))):
            ids = torch.randint(1000, WP_VOCAB, (b, s), device=DEV, dtype=torch.int32)
            mask = torch.ones_like(ids)
            tower.model(ids, mask, mask)
            fwd[name] = _median_ms(torch, lambda: tower.model(ids, mask, mask), 20)
    emit({"phase": "config_towers", "card": card, "write_s": write_s, "load_s": load_s,
          "golden_bf16_vs_hf_f32": golden, "forward_ms": fwd, "dtype": str(be.model.encoder.dtype),
          "what": "F3 at the full-size layout: the loaded towers in bf16 with the CUDA "
                  "attention and with mha_reference, against the golden's f32 HF outputs"})
    check(all(v["kernel_vs_reference"] <= KERNEL_TOL for v in golden.values()), "config_towers",
          f"kernel and reference attention differ beyond {KERNEL_TOL}: {golden}")

    # run_search at rerank_k 50 on phase 4's corpus with the loaded towers
    queries = _queries(TOWER_QUERIES, DIM, VOCAB, seed=46)
    eng = SearchEngine(IndexBundle(products=engine_bf16.products), device=DEV,
                       query_encoder=be, cross_encoder=ce)
    _check_rows(eng.run_search(queries[0], k=K, rerank_k=RERANK_K)[0], "config_towers")
    _zero_counts()
    lat, kept = [], []
    for q in queries:
        t0 = time.perf_counter()
        rows = eng.run_search(q, k=K, rerank_k=RERANK_K)[0]
        lat.append((time.perf_counter() - t0) * 1e3)
        _check_rows(rows, "config_towers")
        kept.append(rows)
    counts = _counts()
    want = {**{n: 0 for n in counts}, "mha_fwd": 18 * TOWER_QUERIES}
    check(counts == want, "config_towers", f"run_search launches {counts}, want {want}")
    launches = counts["mha_fwd"]
    be.set_attn_impl("reference")
    ce.set_attn_impl("reference")
    try:
        rows_r = [eng.run_search(q, k=K, rerank_k=RERANK_K)[0] for q in queries]
    finally:
        be.set_attn_impl("auto")
        ce.set_attn_impl("auto")
    emit({"phase": "config_towers_run_search", "card": card, "n_docs": N_DOCS,
          "rerank_k": RERANK_K, "run_search": _pct(lat), "attention_launches": launches,
          "queries_cut_to": TOWER_QUERIES})
    _crosscheck(kept, rows_r, "config_towers_crosscheck")
    del eng

    # the CLI's loader: EMB_MODEL_DIR / RERANK_MODEL_DIR on a saved bundle
    # whose rerank tokens it re-tokenizes, then query_e2e on it
    small = synth_product_index(SMALL_DOCS, DIM, VOCAB, TERMS, seed=5, text_chars=SMALL_TEXT_CHARS)
    # another tokenizer's ids, which the loader must replace
    small.doc_tokens = np.full((small.n_padded, DOC_TOKENS), 7, np.int32)
    small.doc_token_len = np.full(small.n_padded, 3, np.int32)
    bdir = TOWER_DIR / "bundle"
    save_bundle(IndexBundle(products=small), bdir)
    saved = {n: getattr(config, n) for n in ("EMB_MODEL_DIR", "RERANK_MODEL_DIR")}
    config.EMB_MODEL_DIR = str(dirs["biencoder", "safetensors"])
    config.RERANK_MODEL_DIR = str(dirs["crossencoder", "native"])
    try:
        t0 = time.perf_counter()
        cli_eng = cli._load_engine(str(bdir), with_rerank=True, device=DEV)
        cli_s = time.perf_counter() - t0
    finally:
        for n, v in saved.items():
            setattr(config, n, v)
    toks = cli_eng.arrays["doc_tokens"].cpu().numpy()
    lens = cli_eng.arrays["doc_token_len"].cpu().numpy()
    first = cli_eng._ce.tokenizer.token_ids(str(small.agg_texts[0])[:2000])[:DOC_TOKENS]
    check(toks[0, :len(first)].tolist() == first and lens[0] == len(first), "config_towers_e2e",
          "the CLI engine's rerank tokens are not the cross-encoder's")
    check(int(lens.max()) < DOC_TOKENS, "config_towers_e2e", "rerank tokens truncate")
    wq = _queries(TOWER_QUERIES, DIM, VOCAB, seed=47)
    _e2e_rows(cli_eng, *cli_eng.query_e2e(wq[0], w, POOL, K, rr_k=RERANK_K))
    counter, restore = _count_plain_calls([(A, "mha_reference")])
    _zero_counts()
    try:
        lat_e2e, e2e_rows = [], []
        for q in wq:
            t0 = time.perf_counter()
            e2e_rows.append(_e2e_rows(cli_eng, *cli_eng.query_e2e(q, w, POOL, K, rr_k=RERANK_K)))
            lat_e2e.append((time.perf_counter() - t0) * 1e3)
            _check_rows(e2e_rows[-1], "config_towers_e2e")
        lat_rs, host_rows = [], []
        for q in wq:
            t0 = time.perf_counter()
            host_rows.append(cli_eng.run_search(q, k=K, rerank_k=RERANK_K, **RERANK_KNOBS)[0])
            lat_rs.append((time.perf_counter() - t0) * 1e3)
    finally:
        restore()
    counts = _counts()
    want = {**{n: 0 for n in counts}, "mha_fwd": 2 * 18 * TOWER_QUERIES}
    emit({"phase": "config_towers_e2e", "card": card, "docs": SMALL_DOCS,
          "emb_model_dir": "biencoder_safetensors", "rerank_model_dir": "crossencoder_native",
          "load_engine_s": cli_s, "longest_doc_tokens": int(lens.max()),
          "query_e2e": _pct(lat_e2e), "run_search": _pct(lat_rs),
          "attention_launches": counts["mha_fwd"], "reference_calls": counter["calls"],
          "queries_cut_to": TOWER_QUERIES})
    check(counts == want and counter["calls"] == 0, "config_towers_e2e",
          f"launches {counts} (want {want}), {counter['calls']} reference calls")
    _crosscheck(e2e_rows, host_rows, "config_towers_e2e_vs_run_search")
    del cli_eng
    shutil.rmtree(TOWER_DIR, ignore_errors=True)
    return launches + counts["mha_fwd"]


def phase_configurations(torch, engine, qvecs):
    """Phase 14: the int8 corpus (exact, striped) and the IVF pool on phase
    4's 200k data, and towers loaded from disk. Returns the attention
    launches of its counted runs."""
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    _q, _t, qstrings = _bench_queries(BENCH_QUERIES, DIM, VOCAB)
    w = FusionWeights.make(*BENCH_W)
    be = engine.query_encoder
    launches = _int8_configs(torch, engine, be, qvecs, qstrings, w)
    launches += _ivf_config(torch, engine, be, qvecs, qstrings, w)
    launches += _tower_configs(torch, engine, FusionWeights.make(*RERANK_W))
    return launches


def _training_corpus():
    """TRAIN_DOCS products of the quality table's generator (pseudo-words,
    TRAIN_THEMES themes), one review of TRAIN_REVIEW_WORDS words drawn from
    its product's text for each of the first TRAIN_REVIEWED products, and
    a WordPiece vocab of WP_VOCAB lines: bert-base-uncased's specials, the
    corpus's words whole, then unused slots."""
    from review_recommender_tpu_torch.evals import quality_table as QT

    products, _q = QT.build_corpus(TRAIN_THEMES, TRAIN_DOCS // TRAIN_THEMES, 0, seed=TRAIN_SEED)
    rng = np.random.default_rng(TRAIN_SEED)
    step = len(products) // TRAIN_REVIEWED
    reviews = [{"sku": p["sku"], "stars": 4.0,
                "text": " ".join(rng.choice(p["agg_text"].split(), size=TRAIN_REVIEW_WORDS))}
               for p in products[::step][:TRAIN_REVIEWED]]
    words = sorted({w for p in products for w in p["agg_text"].split()})
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                "[MASK]"] + words)
    vocab += [f"[unused{i}]" for i in range(99, 99 + WP_VOCAB - len(vocab))]
    return products, reviews, {t: i for i, t in enumerate(vocab)}


def _golden_native_towers(tokenizer, out_dir):
    """The full-size golden's bi-encoder (bge-small) and cross-encoder
    (MiniLM-L6) weights, as phase 14 writes them, saved through the
    package's save_native_tower with `tokenizer`'s vocab."""
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.convert import (
        convert_biencoder,
        convert_crossencoder,
        params_from_flax,
    )
    from review_recommender_tpu_torch.models.load import save_native_tower
    from tests.golden_utils import manifest_from_npz, synth_state_arrays

    g = np.load(GOLDEN)
    dirs = {}
    for kind, (_io, manifest, seed) in GOLDEN_SEEDS.items():
        sd = synth_state_arrays(manifest_from_npz(g, manifest), seed=seed)
        cfg = BertConfig.bge_small() if kind == "biencoder" else BertConfig.minilm_l6_cross()
        conv = convert_biencoder if kind == "biencoder" else convert_crossencoder
        dirs[kind] = save_native_tower(out_dir / f"golden_{kind}", kind, cfg,
                                       params_from_flax(conv(sd, cfg), cfg, kind), tokenizer)
    return dirs


STEP_MARK = "chip_smoke.step_end"


def _trace_window(path) -> dict:
    """What a chrome trace of a few trainer steps shows of their device
    timeline. A step ends on the device with the last kernel, copy or set
    launched before its STEP_MARK annotation (the trace's host clock); over
    the steps between the first marked end and the last: the mean step
    span, the device's busy time a step (the union of its kernels, copies
    and sets) and its share of the span, the time a step of the kernels
    launched inside the attention's backward recompute (the
    MhaKernelFnBackward autograd node), and the host syncs a step by the
    innermost op that made them. A launch happens at its runtime call's
    start."""
    with open(path) as f:
        trace = json.load(f)
    evs = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
           if e.get("ph") == "X"]
    end = lambda e: e["ts"] + e.get("dur", 0)
    gpu = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    runtime = [e for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in runtime
                   if "correlation" in e.get("args", {})}
    launch = lambda g: launched_at.get(g.get("args", {}).get("correlation"))
    marks = sorted(e["ts"] for e in evs if e.get("name") == STEP_MARK)
    bounds = []
    for m in marks:
        ends = [end(g) for g in gpu if launch(g) is not None and launch(g) < m]
        check(bool(ends), "training", f"no device work before a step's end in {path.name}")
        bounds.append(max(ends))
    check(len(bounds) >= 2, "training", f"{len(bounds)} marked steps in {path.name}")
    lo, hi, n = bounds[0], bounds[-1], len(bounds) - 1
    clip = lambda e: max(0.0, min(end(e), hi) - max(e["ts"], lo))
    busy, cur = 0.0, None
    for s_, e_ in sorted((max(g["ts"], lo), min(end(g), hi)) for g in gpu if clip(g) > 0):
        if cur is None or s_ > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s_, e_]
        else:
            cur[1] = max(cur[1], e_)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    recompute = []
    for a, b in sorted((e["ts"], end(e)) for e in evs
                       if e.get("cat") == "cpu_op" and e.get("name") == "MhaKernelFnBackward"):
        if recompute and a <= recompute[-1][1]:
            recompute[-1][1] = max(recompute[-1][1], b)
        else:
            recompute.append([a, b])
    check(bool(recompute), "training", f"no MhaKernelFnBackward in {path.name}")
    starts = [r[0] for r in recompute]

    def in_recompute(g):
        t = launch(g)
        i = int(np.searchsorted(starts, t, side="right")) - 1 if t is not None else -1
        return i >= 0 and t <= recompute[i][1]

    rec_us = sum(clip(g) for g in gpu if in_recompute(g))
    host_lo, host_hi = marks[0], marks[-1]
    ops = [e for e in evs if e.get("cat") == "cpu_op"]
    syncs = {}
    for e in runtime:
        if ("Synchronize" in e["name"] or e["name"] == "cudaMemcpy") \
                and host_lo <= e["ts"] <= host_hi:
            inner = [o for o in ops if o["ts"] <= e["ts"] <= end(o)]
            name = min(inner, key=lambda o: o.get("dur", 0))["name"] if inner else e["name"]
            syncs[name] = syncs.get(name, 0) + 1 / n
    span_ms = (hi - lo) / n / 1e3
    return {"window_steps": n, "device_step_ms": span_ms, "device_busy_ms": busy / n / 1e3,
            "device_busy_share": busy / (hi - lo), "recompute_ms": rec_us / n / 1e3,
            "recompute_share": rec_us / (hi - lo),
            "host_syncs_per_step": syncs}


class _StepWindow:
    """Step times and one profiler window for each trainer of a run, read
    with torch's public optimizer hook and nothing changed in the package.
    torch.optim's global step post-hook records a CUDA event at the end of
    each optimizer step; trainers are named TOWERS in the order they first
    step. From the end of a trainer's PROFILE_AFTER-th step, torch.profiler
    records PROFILE_STEPS steps (the queue drained at both ends), each
    step's end marked by a STEP_MARK annotation, and _trace_window reads
    the spans between the marks. Step times are the intervals between
    consecutive step ends on the device, those touched by the profiler
    left out."""

    TOWERS, PROFILE_AFTER, PROFILE_STEPS = ("biencoder", "crossencoder"), 4, 5

    def __init__(self, torch, trace_dir):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.torch, self.trace_dir = torch, trace_dir
        self.tower_of, self.ends, self.host, self.windows, self.prof = {}, {}, {}, {}, None
        self.handle = register_optimizer_step_post_hook(self._after_step)

    def _after_step(self, opt, _args, _kwargs):
        from torch.profiler import ProfilerActivity, profile, record_function

        if id(opt) not in self.tower_of:
            check(len(self.tower_of) < len(self.TOWERS), "training",
                  "more trainers stepped than the run has towers")
            self.tower_of[id(opt)] = self.TOWERS[len(self.tower_of)]
        tower = self.tower_of[id(opt)]
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        ends = self.ends.setdefault(tower, [])
        ends.append(e)
        self.host.setdefault(tower, []).append(time.perf_counter())
        if self.prof is not None:
            with record_function(STEP_MARK):
                pass
        if len(ends) == self.PROFILE_AFTER:
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        elif len(ends) == self.PROFILE_AFTER + self.PROFILE_STEPS:
            self.torch.cuda.synchronize()
            self.prof.stop()
            path = self.trace_dir / f"trace_{tower}.json"
            self.prof.export_chrome_trace(str(path))
            self.prof = None
            self.windows[tower] = _trace_window(path)
            path.unlink()

    def close(self):
        self.handle.remove()
        if self.prof is not None:
            self.prof.stop()

    def report(self, tower, tokens_per_step):
        """Step interval p50/p90 in ms over the steps the profiler did not
        touch (on the device; the host's p50 between the same hook calls
        beside it), padded tokens/s at the p50, and the profiler window's
        device timeline (_trace_window) with its busy and recompute time
        over the p50."""
        self.torch.cuda.synchronize()
        ends = self.ends[tower]
        touched = range(self.PROFILE_AFTER, self.PROFILE_AFTER + self.PROFILE_STEPS + 1)
        steps = [a.elapsed_time(b) for i, (a, b) in enumerate(zip(ends, ends[1:]), 1)
                 if i not in touched]
        host = self.host[tower]
        host_steps = [(b - a) * 1e3 for i, (a, b) in enumerate(zip(host, host[1:]), 1)
                      if i not in touched]
        check(tower in self.windows and len(steps) >= 4, "training",
              f"{tower}: {len(ends)} steps, too few for the profiler window and the timing")
        p50 = float(np.percentile(steps, 50))
        w = self.windows[tower]
        return {"steps": len(ends), "timed_steps": len(steps), "step_ms_p50": p50,
                "step_ms_p90": float(np.percentile(steps, 90)),
                "host_step_ms_p50": float(np.percentile(host_steps, 50)),
                "padded_tokens_per_step": tokens_per_step,
                "tokens_per_s_at_p50": tokens_per_step / p50 * 1e3,
                "profiled": w, "device_busy_ms_over_step_p50": w["device_busy_ms"] / p50,
                "recompute_ms_over_step_p50": w["recompute_ms"] / p50}


def _cross_score_range(engine, ce, queries):
    """The median over queries of the range (max - min) of the
    cross-encoder's raw scores over a query's first RERANK_K candidates:
    the spread that the rerank lane's min-max stretches (ROADMAP F3)."""
    ranges = []
    for q in queries:
        rows = engine.run_search(q, k=RERANK_K, rerank_k=0)[0]
        scores = ce(q, [r["agg_text"][:2000] for r in rows])
        ranges.append(float(scores.max() - scores.min()))
    return float(np.median(ranges))


def _repeated_batch_losses(trainer_cls, cfg, sd, batch, steps, **kw):
    """Losses of `steps` trainer steps on one batch (lr 1e-4, constant)."""
    tr = trainer_cls(cfg, sd, device=DEV, **kw)
    losses = [tr.train_step(*batch)["loss"] for _ in range(steps)]
    del tr
    return losses


def _trained_lane(card):
    """The quality table's trained lane at the published corpus size, its
    depth cut to TRAINED_LANE_MLM_STEPS MLM steps and TRAINED_LANE_PAIRS
    pairs: its 12 numbers, the three without rerank held to the bow lane's
    (the trained lane keeps the BoW dense signal and BM25)."""
    from review_recommender_tpu_torch.evals import quality_table as QT
    from review_recommender_tpu_torch.index.build import build_bundle_from_products

    from review_recommender_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    products, queries = QT.build_corpus(QT_THEMES, QT_PER_THEME, QT_QUERIES, seed=QT_SEED)
    lines = []
    _zero_counts()
    A.mha_backward_recomputes = 0
    encoder, cross = QT.build_trained_towers(products, queries, seed=QT_SEED,
                                             n_pairs=TRAINED_LANE_PAIRS,
                                             mlm_steps=TRAINED_LANE_MLM_STEPS, device=DEV,
                                             log=lines.append)
    train_s = time.perf_counter() - t0
    emb = encoder.encode([p["agg_text"] for p in products])
    bundle = build_bundle_from_products(products, emb, doc_terms_cap=QT.DOC_TERMS_CAP,
                                        pad_multiple=QT.PAD_MULTIPLE)
    engine, results = QT.run_lane(bundle, encoder, queries, DEV, cross_encoder=cross)
    lane_counts, recomputes = _counts(), A.mha_backward_recomputes
    with open(REPO_DIR / QT_REFERENCE) as f:
        reference = json.load(f)
    table, worst = {}, 0.0
    for method, res in results.items():
        table[method] = {m: res["aggregate"][m] for m in QT_METRICS}
        if "Rerank" not in method:
            worst = max([worst] + [abs(res["aggregate"][m] - reference[method]["aggregate"][m])
                                   for m in QT_METRICS])
    emit({"phase": "training_lane", "card": card, "corpus": [QT_THEMES, QT_PER_THEME, QT_QUERIES],
          "mlm_steps": TRAINED_LANE_MLM_STEPS, "mlm_steps_published": 2000,
          "n_pairs": TRAINED_LANE_PAIRS, "n_pairs_published": 8192, "log": lines,
          "train_s": train_s, "wall_s": time.perf_counter() - t0, "methods": table,
          "jax_full_lane_hybrid_rerank": TRAINED_LANE_JAX, "attention_launches": lane_counts,
          "backward_recomputes": recomputes, "without_rerank_vs_bow_lane": worst})
    check(all(np.isfinite(v) for row in table.values() for v in row.values()), "training_lane",
          f"non-finite quality numbers {table}")
    check(worst <= QT_TOL, "training_lane",
          f"a method without rerank differs from the bow lane's by {worst} > {QT_TOL}")
    check(lane_counts["mha_fwd"] > recomputes > 0, "training_lane",
          f"{lane_counts} launches and {recomputes} recomputes: the lane's training and rerank "
          "must run the kernel")
    del engine, cross
    return lane_counts["mha_fwd"], recomputes


def _training_kernel_rows(torch):
    """The attention at each TRAIN_SHAPES shape, timed behind a device spin
    (medians of REPS CUDA-event runs): the kernel forward against its plain
    version and SDPA (row 1), and MhaKernelFn's backward recompute
    (autograd through mha_reference: its forward and the q, k, v
    gradients) against SDPA's forward and backward (row 1b). Bounds: the
    forward's as phase 3's; the backward's operations are the recomputed
    forward's 4BHS^2D plus 8BHS^2D for dV, dP, dQ, dK, its bytes q, k, v
    and the upstream gradient read and dq, dk, dv written."""
    from review_recommender_tpu_torch.ops import attention as A

    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    rows = []
    for i, (b, s, h, d) in enumerate(TRAIN_SHAPES):
        rng = np.random.default_rng(300 + i)
        q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
                      .to(DEV, torch.bfloat16) for _ in range(4))
        lens = rng.integers(1, s + 1, size=b)
        bias = torch.from_numpy(np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30)
                                .astype(np.float32)).to(DEV)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def recompute():
            with torch.enable_grad():
                return torch.autograd.grad(A.mha_reference(*leaves, bias, h), leaves, g)

        def sdpa_backward():
            with torch.enable_grad():
                return torch.autograd.grad(_sdpa(torch, *leaves, bias, h), leaves, g)

        with torch.no_grad():
            got = A.mha_kernel(q, k, v, bias, h)
            err = float((got.float() - A.mha_reference(q, k, v, bias, h).float()).abs().max())
        runs = {"ms": lambda: A.mha_kernel(q, k, v, bias, h),
                "plain_ms": lambda: A.mha_reference(q, k, v, bias, h),
                "library_ms": lambda: _sdpa(torch, q, k, v, bias, h)}
        times = {}
        with torch.no_grad():
            for name, fn in runs.items():
                fn()
                times[name] = _median_ms(torch, fn, REPS, before=spin)
        for name, fn in (("recompute_ms", recompute), ("library_backward_ms", sdpa_backward)):
            fn()
            times[name] = _median_ms(torch, fn, REPS, before=spin)
        flops = A.attention_flops(b, s, h, d)
        nbytes = A.attention_bytes(b, s, h, d, 2)
        bwd_flops, bwd_bytes = 3 * flops, 7 * b * s * h * d * 2 + 4 * b * s
        rows.append({"B": b, "S": s, "H": h, "D": d, "max_abs_err": err, **times,
                     "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
                     "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES
                     else "bytes",
                     "backward_bound_ms": max(bwd_flops / PEAK_BF16_FLOPS,
                                              bwd_bytes / PEAK_HBM_BYTES) * 1e3,
                     "backward_bound_by": "operations"
                     if bwd_flops / PEAK_BF16_FLOPS > bwd_bytes / PEAK_HBM_BYTES else "bytes",
                     "reps": REPS})
        check(err <= KERNEL_TOL, "training_kernel", f"max abs error {err} at {rows[-1]}")
    return rows


def phase_training(torch):
    """Phase 15: `rrt train --cross` at full width from the golden towers on
    a 4,096-product bundle with reviews, timed per step; the loss on a
    repeated batch; the trained towers served by run_search at rerank_k 50
    with the F3 cross-check; the trained lane at a cut depth. Returns the
    attention launches (of `rrt train`, the counted run_search and the
    lane) and the backward recomputes (of `rrt train` and the lane)."""
    import shutil

    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.evals import quality_table as QT
    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import load_bundle, save_bundle
    from review_recommender_tpu_torch.models import load
    from review_recommender_tpu_torch.models.tokenizer import WordPieceTokenizer
    from review_recommender_tpu_torch.train import (
        ContrastiveTrainer,
        CrossEncoderTrainer,
        TrainConfig,
        CrossTrainConfig,
        make_pair_batch,
        make_triple_batch,
        mine_pairs,
    )

    card = _card()
    kernel_rows = _training_kernel_rows(torch)
    for row in kernel_rows:
        emit({"phase": "training_kernel", "card": card, **row})
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    products, reviews, vocab = _training_corpus()
    tok = WordPieceTokenizer(vocab)
    golden = _golden_native_towers(tok, TRAIN_DIR)
    be = load.load_biencoder(golden["biencoder"], device=DEV)
    emb = be.encode([p["agg_text"] for p in products])
    rng = np.random.default_rng(TRAIN_SEED)
    bdir = TRAIN_DIR / "bundle"
    save_bundle(build_bundle_from_products(
        products, emb, reviews=reviews,
        review_embeddings=rng.standard_normal((len(reviews), DIM)).astype(np.float32),
        doc_terms_cap=QT.DOC_TERMS_CAP, pad_multiple=QT.PAD_MULTIPLE), bdir)
    del be
    setup_s = time.perf_counter() - t0

    # the main path: rrt train --cross, counted and timed per step
    out = TRAIN_DIR / "towers"
    saved = {n: getattr(config, n) for n in ("EMB_MODEL_DIR", "RERANK_MODEL_DIR")}
    config.EMB_MODEL_DIR = str(golden["biencoder"])
    config.RERANK_MODEL_DIR = str(golden["crossencoder"])
    clock = _StepWindow(torch, TRAIN_DIR)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    from review_recommender_tpu_torch.ops import attention as A

    _zero_counts()
    A.mha_backward_recomputes = 0
    try:
        t0 = time.perf_counter()
        code, printed = _cli(["train", "--index-dir", str(bdir), "--out", str(out), "--cross",
                              "--device", DEV, *TRAIN_ARGS])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts, recomputes = _counts(), A.mha_backward_recomputes
        peak = torch.cuda.max_memory_allocated()
    finally:
        clock.close()
        for n, v in saved.items():
            setattr(config, n, v)
    check(code == 0, "training", f"rrt train exit {code}")
    line = json.loads(printed.strip().splitlines()[-1])
    bi_steps, xe_steps = len(clock.ends["biencoder"]), len(clock.ends["crossencoder"])
    bi = clock.report("biencoder", 2 * TRAIN_BATCH * TRAIN_MAX_LEN)
    xe = clock.report("crossencoder", TRAIN_BATCH * 2 * TRAIN_MAX_LEN)

    # the host's tokenization of one batch, a part of each step's host work
    pairs = mine_pairs([r["text"] for r in reviews], [r["sku"] for r in reviews],
                       [p["sku"] for p in products], [p["agg_text"] for p in products])
    qs, ds = [q for q, _ in pairs[:TRAIN_BATCH]], [d for _, d in pairs[:TRAIN_BATCH]]
    labels = [1.0 if i % 2 == 0 else 0.0 for i in range(TRAIN_BATCH)]
    xdocs = [d if i % 2 == 0 else ds[(i + 7) % len(ds)] for i, d in enumerate(ds)]
    make_bi = lambda t: make_pair_batch(t, qs, ds, max_len=TRAIN_MAX_LEN, pad_to=TRAIN_MAX_LEN)
    make_xe = lambda t: make_triple_batch(t, qs, xdocs, labels, max_len=2 * TRAIN_MAX_LEN,
                                          pad_to=2 * TRAIN_MAX_LEN)
    for report, make in ((bi, make_bi), (xe, make_xe)):
        took = []
        for _ in range(5):
            t0 = time.perf_counter()
            make(tok)
            took.append((time.perf_counter() - t0) * 1e3)
        report["host_tokenize_batch_ms_p50"] = float(np.median(took))
    want = {**{n: 0 for n in counts}, "mha_fwd": 24 * bi_steps + 6 * xe_steps}
    emit({"phase": "training", "card": card, "products": len(products),
          "reviews": len(reviews), "pairs": line["pairs"], "setup_s": setup_s,
          "train_s": train_s, "biencoder": {"config": "bge_small, bf16, f32 masters",
                                            "batch": TRAIN_BATCH, "max_len": TRAIN_MAX_LEN, **bi},
          "crossencoder": {"config": "minilm_l6_cross, bf16, f32 masters",
                           "batch": TRAIN_BATCH, "max_len": 2 * TRAIN_MAX_LEN, **xe},
          "peak_allocated_bytes": peak, "resident_bytes": resident,
          "peak_over_resident_bytes": peak - resident, "attention_launches": counts["mha_fwd"],
          "backward_recomputes": recomputes, "args": TRAIN_ARGS})
    check(not bi["profiled"]["host_syncs_per_step"] and not xe["profiled"]["host_syncs_per_step"],
          "training", f"the trainers' steps sync with the host: {bi['profiled']} {xe['profiled']}")
    check(counts == want and recomputes == counts["mha_fwd"], "training",
          f"launches {counts} and {recomputes} recomputes, want {want} and as many recomputes")

    # the loss on a repeated batch, each trained tower
    cfg_bi, sd_bi, tok_bi, _ = load.load_tower_params(out / "biencoder", "biencoder")
    cfg_xe, sd_xe, tok_xe, _ = load.load_tower_params(out / "crossencoder", "crossencoder")
    losses = {
        "biencoder": _repeated_batch_losses(ContrastiveTrainer, cfg_bi, sd_bi, make_bi(tok_bi),
                                            REPEAT_STEPS, train_cfg=TrainConfig(learning_rate=1e-4)),
        "crossencoder": _repeated_batch_losses(
            CrossEncoderTrainer, cfg_xe, sd_xe, make_xe(tok_xe), REPEAT_STEPS,
            train_cfg=CrossTrainConfig(learning_rate=1e-4)),
    }
    emit({"phase": "training_repeated_batch", "card": card, "steps": REPEAT_STEPS,
          "losses": losses, "label_base_rate_loss": float(np.log(2)),
          "what": "the bi-encoder must fall; the cross-encoder from the golden's random "
                  "trunk sits at the label base rate (train/mlm.py), reported"})
    check(all(np.isfinite(ls).all() for ls in losses.values()), "training_repeated_batch",
          f"a non-finite loss: {losses}")
    ls = losses["biencoder"]
    check(ls[-1] < ls[0], "training_repeated_batch",
          f"the bi-encoder's loss does not fall on a repeated batch: {ls}")

    # the trained towers from disk through models/load.py, run_search at
    # rerank_k 50, and F3's margin with the trained cross-encoder
    be = load.load_biencoder(out / "biencoder", device=DEV)
    ce = load.load_crossencoder(out / "crossencoder", device=DEV)
    engine = SearchEngine(load_bundle(bdir), device=DEV, query_encoder=be, cross_encoder=ce)
    queries = [q for q, _ in pairs[TRAIN_BATCH:TRAIN_BATCH + TRAIN_QUERIES]]
    _check_rows(engine.run_search(queries[0], k=K, rerank_k=RERANK_K)[0], "training_serve")
    _zero_counts()
    lat, rows_k = [], []
    for q in queries:
        t0 = time.perf_counter()
        rows_k.append(engine.run_search(q, k=K, rerank_k=RERANK_K)[0])
        lat.append((time.perf_counter() - t0) * 1e3)
        _check_rows(rows_k[-1], "training_serve")
    serve_counts = _counts()
    be.set_attn_impl("reference")
    ce.set_attn_impl("reference")
    try:
        rows_r = [engine.run_search(q, k=K, rerank_k=RERANK_K)[0] for q in queries]
    finally:
        be.set_attn_impl("auto")
        ce.set_attn_impl("auto")
    golden_ce = load.load_crossencoder(golden["crossencoder"], device=DEV)
    emit({"phase": "training_serve", "card": card, "queries": len(queries),
          "rerank_k": RERANK_K, "run_search": _pct(lat), "attention_launches": serve_counts,
          "cross_score_range_median": {"trained": _cross_score_range(engine, ce, queries),
                                       "golden": _cross_score_range(engine, golden_ce, queries)}})
    del golden_ce
    check(serve_counts["mha_fwd"] == 18 * len(queries), "training_serve",
          f"run_search launches {serve_counts}, want 18 a query")
    _crosscheck(rows_k, rows_r, "training_f3")
    del engine, be, ce
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    lane_launches, lane_recomputes = _trained_lane(card)
    return (counts["mha_fwd"] + serve_counts["mha_fwd"] + lane_launches,
            recomputes + lane_recomputes)


# ---------------------------------------------------------------- phase 16
# the reference's review set (topics/density.py's 300k x 384): 40 planted
# clusters of 7,250 rows and 10,000 isotropic noise rows, drawn as
# tests/test_density.py:blobs_with_noise draws them, with its spread scaled
# by sqrt(24 / 384) so a blob keeps the test's geometry at D = 384
TOPIC_ROWS, TOPIC_CLUSTERS, TOPIC_NOISE, TOPIC_SEED = 300_000, 40, 10_000, 16
TOPIC_SPREAD = 0.08 * (24 / DIM) ** 0.5
TOPIC_K, TOPIC_BATCH, TOPIC_CHUNK = 17, 1024, 32_768  # density_cluster's graph: 16 + self
TOPIC_TOL = 1e-5  # f32 products summed in another order (cuBLAS, the CPU GEMM, the sort)
TOPIC_SAMPLE, TOPIC_CPU_ROWS = 1024, 20_000
TOPIC_KMEANS = dict(k=24, iters=25)  # rrt topics' defaults
TOPIC_WORDS_PER, TOPIC_PRODUCTS = 10, 4096
# rrt topics' review set: every third of the 300,000 rows (all 40 clusters),
# cut so that the phase's host stages (bundle save, two lanes) stay near two minutes
TOPIC_CLI_REVIEWS = 100_000
# rrt import at phase 4's corpus: skus, n_reviews, avg_stars, embeddings,
# one token per unique term (no tf repeats, no 2,000-char texts)
IMPORT_REVIEWS, IMPORT_QUERIES, IMPORT_CAP = 100_000, 20, TERMS
TOPICS_DIR = REPO_DIR / "build" / "chip_smoke_topics"
SYLLABLES = ("ba be bi bo bu da de di do du fa fe fi fo fu ga ge gi go gu ka ke ki ko ku "
             "la le li lo lu ma me mi mo mu na ne ni no nu").split()
COMMON_WORDS = "really very product item good bought works nice okay great".split()


def _topic_rows():
    """(rows (N, D) f32 unit, truth (N,) int with -1 for noise)."""
    rng = np.random.default_rng(TOPIC_SEED)
    centers = rng.standard_normal((TOPIC_CLUSTERS, DIM))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    for i in range(1, TOPIC_CLUSTERS):  # keep blob centers well separated
        while (centers[:i] @ centers[i]).max() > 0.3:
            c = rng.standard_normal(DIM)
            centers[i] = c / np.linalg.norm(c)
    n_per = (TOPIC_ROWS - TOPIC_NOISE) // TOPIC_CLUSTERS
    truth = np.concatenate([np.repeat(np.arange(TOPIC_CLUSTERS), n_per),
                            np.full(TOPIC_NOISE, -1)])
    rows = np.empty((TOPIC_ROWS, DIM), np.float32)
    rows[: n_per * TOPIC_CLUSTERS] = (np.repeat(centers, n_per, axis=0)
                                      + TOPIC_SPREAD * rng.standard_normal((n_per * TOPIC_CLUSTERS,
                                                                            DIM)))
    rows[n_per * TOPIC_CLUSTERS:] = rng.standard_normal((TOPIC_NOISE, DIM))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows, truth


def _topic_texts(truth):
    """Review texts: six of the cluster's ten pseudo-words (Zipf-weighted:
    the cluster's first syllable, then the word's) and two common words;
    noise rows take common words only. Stars 1-5 around a per-cluster
    mean, 1% NaN."""
    rng = np.random.default_rng(TOPIC_SEED + 1)
    w = 1.0 / np.arange(1, TOPIC_WORDS_PER + 1)
    picks = rng.choice(TOPIC_WORDS_PER, size=(len(truth), 6), p=w / w.sum())
    common = rng.choice(len(COMMON_WORDS), size=(len(truth), 2))
    texts = []
    for t, row, cw in zip(truth.tolist(), picks.tolist(), common.tolist()):
        words = [COMMON_WORDS[c] for c in cw]
        if t >= 0:
            words += [SYLLABLES[t] + SYLLABLES[j] + "n" for j in row]
        else:
            words += [COMMON_WORDS[j % len(COMMON_WORDS)] for j in row[:3]]
        texts.append(" ".join(words))
    mean = rng.uniform(1.5, 4.5, TOPIC_CLUSTERS + 1)[truth]
    stars = np.clip(np.round(mean + rng.normal(0, 0.8, len(truth))), 1, 5)
    stars[rng.random(len(truth)) < 0.01] = np.nan
    return texts, stars


def _graph_diff(sims, idx, want_sims, want_idx, sim):
    """The largest |sim difference|, the ids that differ, and those whose
    two rows' similarities to the row (sim(r, a, b) -> the gap) are further
    apart than TOPIC_TOL."""
    err = float(np.abs(sims - want_sims).max())
    differ = list(zip(*np.nonzero(idx != want_idx)))
    bad = sum(sim(int(r), int(idx[r, c]), int(want_idx[r, c])) > TOPIC_TOL for r, c in differ)
    return err, len(differ), int(bad)


def _knn_phase(torch, card, rows):
    """Phase 16a: the graph on the card, timed, profiled and cross-checked."""
    from review_recommender_tpu_torch.topics.density import knn_graph

    n = len(rows)
    kw = dict(k=TOPIC_K, batch_rows=TOPIC_BATCH, col_chunk=TOPIC_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sims, idx = knn_graph(rows, device=DEV, **kw)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prof = _profile(torch, lambda: knn_graph(rows, device=DEV, **kw))
    flops = 2.0 * n * n * DIM
    bound_s = max(flops / PEAK_FP32_FLOPS, (n * DIM * 4 + n * TOPIC_K * 8) / PEAK_HBM_BYTES)

    # 1,024 sampled rows against one exact full-row product and a stable sort on the card
    pick = np.sort(np.random.default_rng(TOPIC_SEED + 2).choice(n, TOPIC_SAMPLE, replace=False))
    emb_d = torch.from_numpy(rows).to(DEV)
    full = emb_d[torch.from_numpy(pick).to(DEV)] @ emb_d.T
    vals, ids = torch.sort(full, dim=1, descending=True, stable=True)
    want_s, want_i = vals[:, :TOPIC_K].cpu().numpy(), ids[:, :TOPIC_K].int().cpu().numpy()
    s_err, s_diff, s_bad = _graph_diff(
        sims[pick], idx[pick], want_s, want_i,
        lambda r, a, b: abs(full[r, a].item() - full[r, b].item()))
    del emb_d, full, vals, ids
    # a 20,000-row subset on the card against the port's CPU path
    sub = rows[:: n // TOPIC_CPU_ROWS][:TOPIC_CPU_ROWS]
    gs, gi = knn_graph(sub, device=DEV, **kw)
    cs, ci = knn_graph(sub, device="cpu", **kw)
    e64 = sub.astype(np.float64)
    c_err, c_diff, c_bad = _graph_diff(gs, gi, cs, ci,
                                       lambda r, a, b: abs(e64[r] @ (e64[a] - e64[b])))
    out = {"phase": "topics_knn", "card": card, "rows": n, "dim": DIM, "k": TOPIC_K,
           "batch_rows": TOPIC_BATCH, "col_chunk": TOPIC_CHUNK, "seconds": seconds,
           "peak_allocated_bytes": peak, "flops": flops, "bound_s": bound_s,
           "bound_by": "operations", "share_of_bound": bound_s / seconds,
           "profiled": prof, "tol": TOPIC_TOL,
           "sampled_rows": {"rows": TOPIC_SAMPLE, "max_abs_err": s_err, "ids_differ": s_diff,
                            "ids_differ_beyond_tol": s_bad},
           "cpu_subset": {"rows": len(sub), "max_abs_err": c_err, "ids_differ": c_diff,
                          "ids_differ_beyond_tol": c_bad}}
    emit(out)
    check(np.isfinite(sims).all() and (idx >= 0).all(), "topics_knn", "a non-finite slot")
    check(s_err <= TOPIC_TOL and s_bad == 0, "topics_knn",
          f"sampled rows: {s_err} > {TOPIC_TOL} or {s_bad} ids differ beyond a near tie")
    check(c_err <= TOPIC_TOL and c_bad == 0, "topics_knn",
          f"CPU subset: {c_err} > {TOPIC_TOL} or {c_bad} ids differ beyond a near tie")
    return out


def _clusters_phase(card, rows, truth):
    """Phase 16b: density clustering and k-means on the card's graph."""
    from review_recommender_tpu_torch.topics.cluster import spherical_kmeans
    from review_recommender_tpu_torch.topics.density import density_cluster

    stats, kstats = {}, {}
    t0 = time.perf_counter()
    labels, info = density_cluster(rows, device=DEV, batch_rows=TOPIC_BATCH,
                                   col_chunk=TOPIC_CHUNK, stats=stats)
    density_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, _centers = spherical_kmeans(rows, device=DEV, stats=kstats, **TOPIC_KMEANS)
    kmeans_s = time.perf_counter() - t0

    def purity(pred):
        """Share of clustered rows whose cluster's majority truth is theirs."""
        keep = (pred >= 0) & (truth >= 0)
        pairs = pred[keep].astype(np.int64) * (TOPIC_CLUSTERS + 1) + truth[keep]
        counts = np.bincount(pairs)
        best = np.zeros(pred.max() + 1, np.int64)
        np.maximum.at(best, np.arange(len(counts)) // (TOPIC_CLUSTERS + 1), counts)
        return float(best.sum() / max(keep.sum(), 1))

    noise_kept = float((labels[truth < 0] == -1).mean())
    out = {"phase": "topics_cluster", "card": card, "density": {
        **info, "seconds": density_s, "stage_s": stats, "purity": purity(labels),
        "planted": TOPIC_CLUSTERS, "noise_rows_labelled_noise": noise_kept},
        "kmeans": {**TOPIC_KMEANS, "seconds": kmeans_s, "stage_s": kstats,
                   "purity": purity(ids)}}
    emit(out)
    check(abs(info["n_clusters"] - TOPIC_CLUSTERS) <= TOPIC_CLUSTERS // 4, "topics_cluster",
          f"{info['n_clusters']} density clusters for {TOPIC_CLUSTERS} planted")
    check(out["density"]["purity"] >= 0.95 and noise_kept >= 0.8, "topics_cluster",
          f"purity {out['density']['purity']}, noise kept {noise_kept}")
    return labels


def _topics_cli_phase(card, rows, truth, density_labels):
    """Phase 16c: rrt topics in both lanes with --llm dry on a port bundle
    of these reviews, in process; the naming stage timed alone on the
    density clusters of phase 16b."""
    import shutil

    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import save_bundle
    from review_recommender_tpu_torch.topics.naming import name_topics, tfidf_topic_terms

    n = TOPIC_CLI_REVIEWS
    pick = np.arange(0, len(rows), len(rows) // n)[:n]
    t0 = time.perf_counter()
    texts, stars = _topic_texts(truth[pick])
    rng = np.random.default_rng(TOPIC_SEED + 3)
    products = [{"sku": f"P{i:05d}", "agg_text": f"product {i}", "n_reviews": 10.0,
                 "avg_stars": 4.0} for i in range(TOPIC_PRODUCTS)]
    skus = rng.integers(0, TOPIC_PRODUCTS, n)
    reviews = [{"sku": f"P{s:05d}", "text": t, "stars": float(st)}
               for s, t, st in zip(skus.tolist(), texts, stars.tolist())]
    bundle = build_bundle_from_products(
        products, rng.standard_normal((TOPIC_PRODUCTS, DIM)).astype(np.float32),
        reviews=reviews, review_embeddings=rows[pick], doc_terms_cap=16)
    build_s = time.perf_counter() - t0
    bdir = TOPICS_DIR / "reviews_bundle"
    t0 = time.perf_counter()
    save_bundle(bundle, bdir)
    save_s = time.perf_counter() - t0

    # the naming stage alone, on the density clusters (noise left out, as the lane does)
    labels = density_labels[pick]
    keep = np.flatnonzero(labels >= 0)
    t0 = time.perf_counter()
    names = name_topics(tfidf_topic_terms([texts[i] for i in keep], labels[keep]))
    naming_s = time.perf_counter() - t0

    lanes = {"kmeans": ["--k", str(TOPIC_KMEANS["k"]), "--iters", str(TOPIC_KMEANS["iters"])],
             "density": ["--cluster", "density"]}
    out = {"phase": "topics_cli", "card": card, "reviews": n, "products": TOPIC_PRODUCTS,
           "build_s": build_s, "save_s": save_s, "bundle_bytes": _dir_bytes(bdir),
           "naming_s_density_clusters": naming_s, "tfidf_names_distinct": len(set(names.values())),
           "tfidf_topics": len(names), "lanes": {}}
    for lane, extra in lanes.items():
        lane_dir = TOPICS_DIR / f"topics_{lane}"
        t0 = time.perf_counter()
        code, printed = _cli(["topics", "--index-dir", str(bdir), "--out", str(lane_dir),
                              "--llm", "dry", "--device", DEV, *extra])
        seconds = time.perf_counter() - t0
        check(code == 0, "topics_cli", f"{lane}: exit {code}")
        cards = [json.loads(line) for line in (lane_dir / "topic_cards.jsonl").open()]
        metrics = json.loads((lane_dir / "aspect_metrics.json").read_text())
        out["lanes"][lane] = {"seconds": seconds, "cards": len(cards),
                              "labels_distinct": len({c["label"] for c in cards}),
                              "aspects": len(metrics),
                              "reviews_in_metrics": sum(m["n_reviews"] for m in metrics),
                              "printed": printed.strip().splitlines()[0]}
        check(len(cards) >= TOPIC_KMEANS["k"] and metrics, "topics_cli",
              f"{lane}: {len(cards)} cards, {len(metrics)} aspect rows")
    emit(out)
    check(out["tfidf_names_distinct"] == len(names), "topics_cli",
          f"{out['tfidf_names_distinct']} distinct TF-IDF names of {len(names)} topics")
    shutil.rmtree(bdir, ignore_errors=True)
    return out


def _write_reference_dir(products, ref):
    """A reference deployment's data directory in the numpy form, from
    phase 4's corpus: product_emb.npy, product_emb_meta.npz, product_bm25.pkl
    (one token per unique term), reviews_with_embeddings.npz. Returns the
    columns for the in-process build."""
    import pickle

    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.data.pipeline import numpy_form, write_numpy_form

    n = products.n_docs
    ref.mkdir(parents=True)
    tokens = [[f"t{t}" for t in row if t > 0] for row in products.doc_terms[:n].tolist()]
    cols = {"sku": list(products.skus[:n]), "agg_text": [" ".join(t) for t in tokens],
            "n_reviews": products.n_reviews[:n].astype(np.float64),
            "avg_stars": products.avg_stars[:n].astype(np.float64),
            "last_ts": [None if i % 50 == 0 else f"2024-{1 + i % 12:02d}-01" for i in range(n)]}
    np.save(ref / config.PRODUCT_EMB_FILE, products.emb[:n])
    write_numpy_form(cols, ref / numpy_form(config.PRODUCT_META_FILE))
    with open(ref / config.BM25_FILE, "wb") as f:
        pickle.dump({"skus": cols["sku"], "corpus": tokens, "tokenizer": "simple_en_v1"}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    rng = np.random.default_rng(TOPIC_SEED + 4)
    rsku = rng.integers(0, n, IMPORT_REVIEWS)
    review_cols = {"sku": [cols["sku"][i] for i in rsku.tolist()],
                   "text": [f"review {i} of {cols['agg_text'][s][:60]}"
                            for i, s in enumerate(rsku.tolist())],
                   "stars": rng.integers(1, 6, IMPORT_REVIEWS).astype(np.float64),
                   "embedding": rng.standard_normal((IMPORT_REVIEWS, DIM)).astype(np.float32)}
    write_numpy_form(review_cols, ref / numpy_form(config.REVIEWS_EMB_FILE))
    return cols, tokens, review_cols


def _import_phase(torch, card, products):
    """Phase 16d: rrt import at phase 4's corpus, then the imported
    bundle's main path (CLI search, run_search, search_bm25: counted)
    against a bundle built in process from the same columns."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import build_product_index, build_review_index
    from review_recommender_tpu_torch.index.io import load_bundle
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
    from review_recommender_tpu_torch.serve import cli

    ref, bdir = TOPICS_DIR / "reference_data", TOPICS_DIR / "imported"
    t0 = time.perf_counter()
    cols, tokens, rcols = _write_reference_dir(products, ref)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    code, printed = _cli(["import", "--data-dir", str(ref), "--out", str(bdir),
                          "--doc-terms-cap", str(IMPORT_CAP)])
    import_s = time.perf_counter() - t0
    check(code == 0, "topics_import", f"import exit {code}")
    line = json.loads(printed.strip().splitlines()[-1])

    # the same columns built in process: the bundle the import must equal
    t0 = time.perf_counter()
    pidx = build_product_index(cols["sku"], cols["agg_text"], cols["n_reviews"].tolist(),
                               cols["avg_stars"].tolist(), products.emb[: products.n_docs],
                               doc_terms_cap=IMPORT_CAP, token_lists=tokens,
                               last_ts=["nan" if t is None else t for t in cols["last_ts"]])
    ridx = build_review_index(rcols["sku"], rcols["text"], rcols["stars"].tolist(),
                              rcols["embedding"], pidx.skus)
    want = IndexBundle(products=pidx, reviews=ridx, meta={"built_from": "reference_artifacts"})
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_bundle(bdir, verify_checksums=True)
    load_s = time.perf_counter() - t0
    diffs = _bundle_diffs(want, loaded)
    check(not diffs, "topics_import", f"the imported bundle differs in {diffs}")

    queries = _queries(IMPORT_QUERIES, DIM, VOCAB, seed=16)
    _zero_counts()
    code, _out = _cli(["search", queries[0], "--index-dir", str(bdir), "--rerank-k",
                       str(RERANK_K), "--json-out", str(TOPICS_DIR / "search.json"),
                       "--device", DEV])
    check(code == 0, "topics_import", f"search exit {code}")
    engine = cli._load_engine(str(bdir), with_rerank=True, device=DEV)
    rows_imp = [engine.run_search(q, k=K, rerank_k=0)[0] for q in queries]
    bm25_imp = [engine.search_bm25(q, K) for q in queries]
    bm25_imp = [(i.cpu().numpy(), s.cpu().numpy()) for i, s in bm25_imp]
    counts = _counts()
    want_counts = {**{name: 0 for name in counts}, "mha_fwd": 18 + 12 * IMPORT_QUERIES,
                   "bm25_packed": IMPORT_QUERIES}
    cli_rows = json.loads((TOPICS_DIR / "search.json").read_text())["results"]
    del engine

    ref_engine = SearchEngine(want, device=DEV,
                              query_encoder=BiEncoder.random_for_dim(DIM, device=DEV),
                              cross_encoder=CrossEncoder.random_init(device=DEV))
    same_cli = json.dumps(cli_rows) == json.dumps(
        ref_engine.run_search(queries[0], k=K, rerank_k=RERANK_K)[0])
    same_rows = all(json.dumps(a) == json.dumps(ref_engine.run_search(q, k=K, rerank_k=0)[0])
                    for q, a in zip(queries, rows_imp))
    same_bm25 = all(np.array_equal(i, ref_engine.search_bm25(q, K)[0].cpu().numpy())
                    and np.array_equal(s, ref_engine.search_bm25(q, K)[1].cpu().numpy())
                    for q, (i, s) in zip(queries, bm25_imp))
    for rows in rows_imp + [cli_rows]:
        _check_rows(rows, "topics_import")
    emit({"phase": "topics_import", "card": card, "products": products.n_docs,
          "reviews": IMPORT_REVIEWS, "dim": DIM, "doc_terms_cap": IMPORT_CAP,
          "write_reference_dir_s": write_s, "reference_dir_bytes": _dir_bytes(ref),
          "import_s": import_s, "import_line": line, "bundle_bytes": _dir_bytes(bdir),
          "build_in_process_s": build_s, "verified_load_s": load_s, "bundle_equal": True,
          "queries": IMPORT_QUERIES, "cli_search_equal": same_cli,
          "run_search_equal": same_rows, "search_bm25_equal": same_bm25,
          "launches": counts, "expected_launches": want_counts})
    check(same_cli and same_rows and same_bm25, "topics_import",
          f"imported-bundle rows differ: cli {same_cli}, run_search {same_rows}, "
          f"search_bm25 {same_bm25}")
    check(counts == want_counts, "topics_import", f"launches {counts}, want {want_counts}")
    return counts


def phase_topics_import(torch, products):
    """Phase 16: the topic pipeline and the reference import. Returns the
    kernel launches of the import's main path."""
    import shutil

    card = _card()
    shutil.rmtree(TOPICS_DIR, ignore_errors=True)
    TOPICS_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    rows, truth = _topic_rows()
    emit({"phase": "topics_data", "rows": len(rows), "clusters": TOPIC_CLUSTERS,
          "noise": TOPIC_NOISE, "spread": TOPIC_SPREAD, "seconds": time.perf_counter() - t0})
    _knn_phase(torch, card, rows)
    labels = _clusters_phase(card, rows, truth)
    _topics_cli_phase(card, rows, truth, labels)
    del rows
    counts = _import_phase(torch, card, products)
    shutil.rmtree(TOPICS_DIR, ignore_errors=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        import review_recommender_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run it from the root of "
              "a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        phase_device(torch)
        phase_build()
        kernel_rows = phase_kernel(torch)
        launches, engine = phase_slice(torch)
        bm25_rows = phase_bm25_kernel(torch)
        bm25_launches, bm25_err = phase_bm25_slice(torch, engine)
        qvecs, qterms = phase_batched_slice(torch, engine)
        stage_a_entry = phase_stage_a(torch, engine, qvecs, qterms)
        launches += phase_e2e_slice(torch, engine)
        launches += phase_rerank_coalesce(torch, engine, qvecs)
        phase_snippets(torch, engine)
        launches += phase_serve(torch, engine, qvecs)
        launches += phase_offline(torch, engine)
        launches += phase_configurations(torch, engine, qvecs)
        products = engine.products
        del engine
        train_launches, recomputes = phase_training(torch)
        launches += train_launches
        import_launches = phase_topics_import(torch, products)
        launches += import_launches["mha_fwd"]
        bm25_launches["bm25_packed"] += import_launches["bm25_packed"]
    except PhaseError as exc:
        emit({"phase": "failed", "error": str(exc)})
        return 3
    main_shape = kernel_rows[0]
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{
        "name": "mha_fwd", "route": "cuda",
        "source": "review_recommender_tpu_torch/csrc/mha_fwd.cu",
        "replaces": "review_recommender_tpu/ops/pallas/attention_kernel.py:64",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": main_shape["device_ms"], "plain_ms": main_shape["plain_device_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "operations" if main_shape["bound"] == "compute" else "bytes",
        "library_ms": main_shape["library_device_ms"],
        "backward_recomputes": recomputes,
    }] + _bm25_kernel_entries(bm25_rows, bm25_launches, bm25_err) + [stage_a_entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
