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

The last two lines are the kernels summary and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports no jax and nothing of the JAX package.
"""
from __future__ import annotations

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


def _median_ms(torch, fn, reps):
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def _profile_window(torch, engine, queries, rerank_k):
    """Device busy share of a few queries under torch.profiler: the union
    of CUDA kernel intervals over the host wall-clock of the window, and
    the kernels that take most device time. None when the profiler shows
    no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries:
            engine.run_search(q, k=K, rerank_k=rerank_k)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"rerank_k": rerank_k, "device_busy_share": None,
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
    return {"rerank_k": rerank_k, "queries": len(queries), "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
            "kernels": len(spans),
            "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top]}


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
    return total_launches


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
        launches = phase_slice(torch)
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
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
