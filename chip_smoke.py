#!/usr/bin/env python3
"""Drive the PyTorch port (review_recommender_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
line, and nothing is caught and passed over:

  1 device   torch.cuda must be available; card name and power limit
             (nvidia-smi), torch/CUDA/nvcc versions
  2 build    compile csrc/*.cu with nvcc for sm_90a (build/torch_kernels/)
  3 kernel   the fused-attention kernel against its plain torch version at
             the main path's shapes: max abs error (tolerance 2e-2, bf16) and
             the median of 50 CUDA-event-timed runs of each
  4 slice    SearchEngine.run_search at full width: 200k-doc synthetic corpus
             (D=384, 64 Zipf terms/doc, vocab 30k, 2000-char texts), random
             bge-small bi-encoder and MiniLM-L6 cross-encoder in bf16,
             100 queries at rerank_k=0 and rerank_k=50; kernel launch counts
             (12 per query without rerank, 18 with), a cross-check against
             reference attention, latency percentiles, stage split and peak
             device memory
  5 bm25_kernel  the packed and unpacked BM25 kernels against their plain
             torch versions at (N=200,192, L=64, Q=32) and (N=1,000,448,
             L=512, Q=32), postings drawn on the card from a seeded
             torch.Generator (tf >= 128 lanes, PAD query slots): bitwise-equal
             share, max abs/rel error (tolerance 1e-6 relative, bitwise
             expected), top-100 ids, medians of 50 CUDA-event-timed runs
             (L2 warm, L2 flushed, and from an idle device), HBM-bytes share
             of the cold time, issue-slot and INT32-pipe shares
  6 bm25_slice   SearchEngine.search_bm25 on phase 4's corpus, 100 queries,
             k=10, three bundles: (a) eager -> packed kernel, (b) classic ->
             packed kernel, (c) classic with one tf of 300 -> unpacked
             kernel; exact launch counts (100 per bundle, no plain-version
             call), a kernel-vs-plain cross-check on two queries, latency
             percentiles of a first pass over unseen queries and of a
             repeat pass, peak device memory; search_dense against
             dense_scores + stable_topk

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

import numpy as np

KERNEL_TOL = 2e-2  # bf16: one ulp at magnitude 2-4 (tests/test_attention.py's bound)
FINAL_TOL = 2e-2  # _final with kernel vs reference attention in both bf16 towers
SHAPES = [(64, 512, 12, 32), (1, 16, 12, 32), (8, 128, 6, 64), (4, 256, 3, 128)]
N_DOCS, DIM, TERMS, VOCAB, TEXT_CHARS = 200_000, 384, 64, 30_000, 2000
# 100 queries per setting: p90 then has 10 samples beyond it
N_QUERIES, K, RERANK_K, REPS = 100, 10, 50, 50
# published H100 SXM dense bf16 peak and HBM3 bandwidth (at the 700 W limit)
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
# BM25 scan ceilings, at the 1.98 GHz maximum boost clock (assumed: the
# clock under load is not read). The SASS of csrc/bm25_full.cu spends three
# instructions per (posting, query slot) compare: ISETP, FSEL, FADD. Each
# takes an issue slot (one warp instruction per scheduler per clock: 132 SMs
# x 4 x 32 lanes); ISETP also runs on the INT32 pipe, 64 lanes per SM per
# clock on compute capability 9.0 (the CUDA C++ Programming Guide's
# throughput table).
PEAK_ISSUE_OPS = 132 * 4 * 32 * 1.98e9
PEAK_INT32_OPS = 132 * 64 * 1.98e9
L2_FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
SPIN_CYCLES = 200_000  # ~0.1 ms of device spin: longer than a kernel's host launch
DEV = "cuda"  # the BM25 phases' device
BM25_SHAPES = [(200_192, 64, 32), (1_000_448, 512, 32)]  # (N, L, Q)
BM25_REL_TOL = 1e-6  # bitwise expected: integer tf_q sums, each step rounded alone
BM25_TOPN = 100


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
    from review_recommender_tpu_torch import kernels

    path = kernels.build(force=True)  # from the checkout's sources, every run
    kernels.load()
    emit({"phase": "build", "library": str(path.relative_to(kernels.PKG_DIR.parent)),
          "seconds": kernels.build_info["seconds"], "cached": kernels.build_info["cached"],
          "flags": kernels.NVCC_FLAGS})


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


def phase_kernel(torch):
    from review_recommender_tpu_torch.ops import attention as A

    results = []
    for i, (b, s, h, d) in enumerate(SHAPES):
        q, k, v, bias = _attn_inputs(torch, 100 + i, b, s, h, d)
        with torch.inference_mode():
            got = A.mha_kernel(q, k, v, bias, h)
            ref = A.mha_reference(q, k, v, bias, h)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == torch.bfloat16, "kernel",
                  f"output {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got.float()).all()), "kernel", "non-finite output")
            err = float((got.float() - ref.float()).abs().max())
            for _ in range(3):  # warm-up
                A.mha_kernel(q, k, v, bias, h)
                A.mha_reference(q, k, v, bias, h)
            ms = _median_ms(torch, lambda: A.mha_kernel(q, k, v, bias, h), REPS)
            plain_ms = _median_ms(torch, lambda: A.mha_reference(q, k, v, bias, h), REPS)
        flops = A.attention_flops(b, s, h, d)
        nbytes = A.attention_bytes(b, s, h, d, q.element_size())
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        row = {"B": b, "S": s, "H": h, "D": d, "max_abs_err": err, "tol": KERNEL_TOL,
               "ms": ms, "plain_ms": plain_ms, "kernel_tflops": flops / ms / 1e9,
               "flops": flops, "bytes": nbytes, "roofline_share": bound_ms / ms,
               "bound": "compute" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES
               else "memory", "reps": REPS}
        emit({"phase": "kernel", **row})
        check(err <= KERNEL_TOL, "kernel", f"max abs error {err} > {KERNEL_TOL} at {row}")
        results.append(row)
    return results


def _queries(n_q, dim, vocab, n_terms=5, seed=42):
    """bench.py:_queries' draws (query vectors are drawn and unused: the
    bi-encoder encodes the strings)."""
    rng = np.random.default_rng(seed)
    rng.standard_normal((n_q, dim))
    ids = (rng.zipf(1.3, size=(n_q, n_terms)) % vocab + 1).astype(np.int32)
    return [" ".join(f"t{t}" for t in row) for row in ids]


def _check_rows(rows, phase):
    check(len(rows) == K, phase, f"{len(rows)} rows, expected {K}")
    finals = [r["_final"] for r in rows]
    check(all(np.isfinite(finals)), phase, f"non-finite _final {finals}")
    check(all(a >= b for a, b in zip(finals, finals[1:])), phase, "rows not sorted")


def _profile(torch, run):
    """Device busy share of run() under torch.profiler: the union of CUDA
    kernel intervals over the host wall-clock of the window, and the
    kernels that take most device time. None when the profiler shows no
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
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us, "kernels": len(spans),
            "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top]}


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
    lat, stages, launches = {}, {}, {}
    for rk in (0, RERANK_K):
        before = A.mha_kernel_launches
        lat[rk], stages[rk] = [], {}
        for q in queries:
            t0 = time.perf_counter()
            rows, _snips, debug = engine.run_search(q, k=K, rerank_k=rk)
            lat[rk].append((time.perf_counter() - t0) * 1e3)
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

    # the same query with both towers on the plain attention
    rows_k = engine.run_search(queries[1], k=K, rerank_k=RERANK_K)[0]
    be.set_attn_impl("reference")
    ce.set_attn_impl("reference")
    before = A.mha_kernel_launches
    rows_r = engine.run_search(queries[1], k=K, rerank_k=RERANK_K)[0]
    check(A.mha_kernel_launches == before, "crosscheck", "reference run launched the kernel")
    be.set_attn_impl("auto")
    ce.set_attn_impl("auto")
    _check_rows(rows_r, "crosscheck")
    fk = np.array([r["_final"] for r in rows_k])
    fr = np.array([r["_final"] for r in rows_r])
    same = [a["sku"] == b["sku"] for a, b in zip(rows_k, rows_r)]
    diff = float(np.abs(fk - fr).max())
    emit({"phase": "crosscheck", "query": queries[1], "same_rows": all(same),
          "swapped_ranks": [i for i, s in enumerate(same) if not s],
          "max_final_diff": diff, "tol": FINAL_TOL})
    check(diff <= FINAL_TOL, "crosscheck", f"_final differs by {diff}")
    check(all(s or abs(fk[i] - fr[i]) <= FINAL_TOL for i, s in enumerate(same)),
          "crosscheck", "rows differ beyond a near-tie swap")
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


def scan_cost(n: int, l: int, q: int, packed: bool) -> tuple[int, int]:
    """(bytes read, integer/select operations) of one full BM25 scan: packed
    N*L*4 + N*8, unpacked N*L*8 + N*8; operations N*L*(3 + 3Q) (bench.py's
    model)."""
    nbytes = n * l * (4 if packed else 8) + n * 8
    return nbytes, n * l * (3 + 3 * q)


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
                            (packed, doc_len, qt, qi, avgdl), True),
            "bm25_unpacked": (BK.bm25_full_scores_kernel, bm25_full_scores,
                              (terms, tf, doc_len, qt, qi, avgdl), False),
        }
        for name, (kern, plain, args, is_packed) in cases.items():
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
            nbytes, ops = scan_cost(n, l, q, packed=is_packed)
            row = {"kernel": name, "N": n, "L": l, "Q": q, **diff, "tol_rel": BM25_REL_TOL,
                   f"top{BM25_TOPN}_ids_equal": ids_equal, "ms": ms, "plain_ms": plain_ms,
                   "cold_l2_ms": cold_ms, "from_idle_ms": idle_ms, "bytes": nbytes, "ops": ops,
                   "hbm_share_cold_l2": nbytes / PEAK_HBM_BYTES / (cold_ms / 1e3),
                   "issue_share": ops / PEAK_ISSUE_OPS / (ms / 1e3),
                   "int32_pipe_share": n * l * q / PEAK_INT32_OPS / (ms / 1e3),
                   "bound": "operations" if ops / PEAK_ISSUE_OPS > nbytes / PEAK_HBM_BYTES
                   else "bytes", "reps": REPS}
            emit({"phase": "bm25_kernel", **row})
            check(diff["max_rel_err"] <= BM25_REL_TOL and ids_equal, "bm25_kernel",
                  f"{name} disagrees with its plain version at {row}")
            rows.append(row)
        del terms, tf, doc_len, packed, cases, args
        torch.cuda.empty_cache()
    del flush_buf
    return rows


def _bm25_bundles(products):
    """(a) the eager bundle as built, (b) the same ProductIndex classic,
    (c) classic with one lane's tf at 300 (that row's doc_len updated), so
    that pack_postings refuses it."""
    doc_tf, doc_len = products.doc_tf.copy(), products.doc_len.copy()
    doc_len[0] += 300.0 - doc_tf[0, 0]
    doc_tf[0, 0] = 300.0
    return {"a_eager": products,
            "b_classic": dataclasses.replace(products, doc_bm25=None),
            "c_unpackable": dataclasses.replace(products, doc_bm25=None, doc_tf=doc_tf,
                                                doc_len=doc_len)}


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
    engines = {}
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
        prof = _profile(torch, lambda: [engine.search_bm25(q, K)[0].cpu() for q in queries[:10]])
        cross = _bm25_crosscheck(torch, engine, queries[1:3], bundle)
        kname = "bm25_unpacked" if bundle == "c_unpackable" else "bm25_packed"
        max_err[kname] = max([max_err[kname]] + [r["max_abs_err"] for r in cross])
        emit({"phase": "bm25_slice", "bundle": bundle, "queries": N_QUERIES, "k": K,
              "setup_s": setup_s, "p50_ms": float(np.percentile(lat, 50)),
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
    the headline shape (the first of BM25_SHAPES)."""
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
        })
    return out


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
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
    }] + _bm25_kernel_entries(bm25_rows, bm25_launches, bm25_err)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
