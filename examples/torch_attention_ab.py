#!/usr/bin/env python3
"""Time one checkout's attention, BM25 or stage-A kernels, or its host
featurizer on the engine paths (review_recommender_tpu_torch), on one NVIDIA
GPU, for an A/B of two versions on the same card.

    python3 examples/torch_attention_ab.py [ROOT] [--tag NAME]
        [--kernel attention|bm25|stage_a|featurize] [--parent PARENT]

ROOT is the root of a checkout (default: this one). Its port is imported
from there and its kernels are built there, so two checkouts can be timed
in turns within one session (A, B, B, A), each run in its own process.

--kernel attention (the default): for each of chip_smoke.py's attention
shapes (bf16), then each of its ROUTE_SHAPES in its own dtype (this
checkout's chip_smoke.py, the same seeded inputs as its phase 3), one JSON
line with the dtype and the route (ops/attention.py:kernel_route):

  device_ms  median of 50 CUDA-event times of one launch queued behind a
             0.1 ms device spin: the device's work only
  idle_ms    median of 50 CUDA-event times of one call from an idle device,
             host launch included (chip_smoke.py phase 3's "ms")
  host_us    host wall-clock per call over 200 back-to-back calls, ended by
             a synchronize (the enqueue rate)
  library_device_ms  scaled_dot_product_attention on the same inputs,
             timed as device_ms (chip_smoke.py's yardstick; the port never
             calls it)

--kernel bm25: for each of chip_smoke.py's BM25 shapes, the packed and the
unpacked kernel on phase 5's postings (drawn on the card by this script's
own chip_smoke.py, so both checkouts get the same inputs), one JSON line
each: device_ms as above, and cold_l2_ms, each launch queued behind a 256
MB fill that flushes the 50 MB L2.

--kernel stage_a: the stage-A tile pass (stage_a_tile_winners_kernel) on
one 200,704 x 384 corpus of unit rows drawn on the card from a seeded
torch.Generator (3% of rows invalid), in bf16 and then in f32, at B = 1, 8,
32 and 128 seeded unit queries, one JSON line each with the route
(ops/stage_a.py:stage_a_route): device_ms and cold_l2_ms as above. With
--parent PARENT (another checkout, e.g. a `git archive` of the parent
commit unpacked under build/), PARENT's csrc/stage_a_*.cu are built into
build/stage_a_ab/ and called through their own C entries
(rrt_stage_a_wgmma for bf16, rrt_stage_a_tf32 or else rrt_stage_a_f32 for
f32) in the same process, in the order parent, change, change, parent:
device_ms of each, their ratio and the largest score difference.

--kernel featurize: chip_smoke.py's phase 4 corpus (200k products, D=384)
in an engine with ROOT's default featurizer (the Python route before the
native one existed), no towers. Phase 4's 100 queries featurized first (its
run_search), then phase 6's measure on the eager bundle: search_bm25 over
100 unseen queries, then the same 100 again (p50, p90 of each pass); then
phase 7's: query_fused_batched QPS over 10 passes of 256 queries at B=32
and B=128, after one pass at each B. One JSON line each, with the route.

The first line has the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SHAPES = [(64, 512, 12, 32), (1, 16, 12, 32), (8, 128, 6, 64), (4, 256, 3, 128),
          (1, 32, 12, 32), (50, 287, 12, 32)]
REPS, HOST_CALLS, SPIN_CYCLES = 50, 200, 200_000
HERE = Path(__file__).resolve().parents[1]


def _median_ms(torch, fn, before=None) -> float:
    times = []
    for _ in range(REPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _own_chip_smoke():
    """This checkout's chip_smoke.py, loaded by path: its BM25 shapes and
    postings, whatever ROOT is."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attention(torch, tag: str) -> None:
    from review_recommender_tpu_torch.ops import attention as A

    cs = _own_chip_smoke()
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    # phase 3's rows and seeds: its bf16 shapes, then its route shapes
    rows = [(100 + i, b, s, h, d, "bfloat16") for i, (b, s, h, d) in enumerate(SHAPES)]
    rows += [(100 + len(cs.SHAPES) + j, b, s, h, d, dtype_name)
             for j, (b, s, h, d, dtype_name, _tol) in enumerate(cs.ROUTE_SHAPES)]
    for seed, b, s, h, d, dtype_name in rows:
        dtype = getattr(torch, dtype_name)
        rng = np.random.default_rng(seed)  # chip_smoke.py:_attn_inputs
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
                   .to("cuda", dtype) for _ in range(3))
        lens = rng.integers(1, s + 1, size=b)
        bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
        if b > 1:
            bias[-1] = -1e30
        bias = torch.from_numpy(bias).to("cuda")
        run = lambda: A.mha_kernel(q, k, v, bias, h)
        lib = lambda: cs._sdpa(torch, q, k, v, bias, h)
        with torch.inference_mode():
            for _ in range(3):
                run()
                lib()
            device_ms = _median_ms(torch, run, before=spin)
            idle_ms = _median_ms(torch, run)
            library_ms = _median_ms(torch, lib, before=spin)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                run()
            torch.cuda.synchronize()
            host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        print(json.dumps({"tag": tag, "B": b, "S": s, "H": h, "D": d, "dtype": dtype_name,
                          "route": A.kernel_route(dtype, d, s), "device_ms": device_ms,
                          "idle_ms": idle_ms, "host_us": host_us,
                          "library_device_ms": library_ms, "reps": REPS}), flush=True)


def _bm25(torch, tag: str) -> None:
    from review_recommender_tpu_torch.ops import bm25_kernel as BK

    cs = _own_chip_smoke()
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    flush_buf = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    flush = lambda: flush_buf.fill_(1.0)
    for i, (n, l, q) in enumerate(cs.BM25_SHAPES):
        terms, tf, doc_len, packed, qt, qi, avgdl = cs._bm25_postings(torch, n, l, q, 300 + i)
        cases = (("bm25_packed", BK.bm25_full_scores_packed_kernel,
                  (packed, doc_len, qt, qi, avgdl)),
                 ("bm25_unpacked", BK.bm25_full_scores_kernel,
                  (terms, tf, doc_len, qt, qi, avgdl)))
        for name, fn, args in cases:
            for _ in range(3):
                fn(*args)
            device_ms = _median_ms(torch, lambda: fn(*args), before=spin)
            cold_ms = _median_ms(torch, lambda: fn(*args), before=flush)
            print(json.dumps({"tag": tag, "kernel": name, "N": n, "L": l, "Q": q,
                              "device_ms": device_ms, "cold_l2_ms": cold_ms, "reps": REPS}),
                  flush=True)
        del terms, tf, doc_len, packed, cases, args
        torch.cuda.empty_cache()


def _parent_stage_a(parent: Path):
    """PARENT's stage-A kernels in a library of their own, with the C entry
    each corpus type goes to there."""
    import ctypes

    from review_recommender_tpu_torch import kernels

    csrc = parent / "review_recommender_tpu_torch" / "csrc"
    out = HERE / "build" / "stage_a_ab" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels.nvcc_path(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-I", str(csrc), "-shared", "-o", str(out), *map(str, sorted(csrc.glob("stage_a_*.cu")))]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    f32 = getattr(lib, "rrt_stage_a_tf32", None) or lib.rrt_stage_a_f32
    for fn in (lib.rrt_stage_a_wgmma, f32):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return {"bfloat16": lib.rrt_stage_a_wgmma, "float32": f32}


def _stage_a(torch, tag: str, parent=None) -> None:
    from review_recommender_tpu_torch.ops import stage_a as SA

    n, d = 200_704, 384
    g = torch.Generator(device="cuda").manual_seed(600)
    emb32 = torch.randn(n, d, generator=g, device="cuda")
    emb32 = emb32 / emb32.norm(dim=1, keepdim=True)
    valid = torch.rand(n, generator=g, device="cuda") >= 0.03
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    flush_buf = torch.empty((256 << 20) // 4, dtype=torch.float32, device="cuda")
    flush = lambda: flush_buf.fill_(1.0)
    entries = _parent_stage_a(Path(parent).resolve()) if parent else None
    tiles = -(-n // 2048)
    for dtype in ("bfloat16", "float32"):
        emb = emb32.to(getattr(torch, dtype))
        rng = np.random.default_rng(601)
        for b in (1, 8, 32, 128):
            q = rng.standard_normal((b, d)).astype(np.float32)
            qv = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to("cuda")
            run = lambda: SA.stage_a_tile_winners_kernel(emb, valid, qv)
            row = {"tag": tag, "kernel": "stage_a", "dtype": dtype, "N": n, "D": d, "B": b,
                   "route": SA.stage_a_route(emb.dtype, d, b), "reps": REPS}
            for _ in range(3):
                got = run()
            if entries is None:
                row.update(device_ms=_median_ms(torch, run, before=spin),
                           cold_l2_ms=_median_ms(torch, run, before=flush))
            else:
                out_s = torch.empty(tiles, 16, b, device="cuda")
                out_i = torch.empty(tiles, 16, b, dtype=torch.int32, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                fn = entries[dtype]
                prun = lambda: fn(emb.data_ptr(), valid.data_ptr(), qv.data_ptr(),
                                  out_s.data_ptr(), out_i.data_ptr(), n, d, b, stream)
                for _ in range(3):
                    if prun() != 0:
                        raise SystemExit(f"parent stage A failed to launch ({dtype}, B={b})")
                t = [_median_ms(torch, f, before=spin) for f in (prun, run, run, prun)]
                row.update(parent_ms=[t[0], t[3]], change_ms=[t[1], t[2]],
                           change_over_parent=(t[1] + t[2]) / (t[0] + t[3]),
                           max_abs_diff_vs_parent=float((got[0] - out_s).abs().max()))
            print(json.dumps(row), flush=True)


def _featurize(torch, tag: str) -> None:
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    cs = _own_chip_smoke()
    products = synth_product_index(cs.N_DOCS, cs.DIM, cs.VOCAB, cs.TERMS, seed=0,
                                   text_chars=cs.TEXT_CHARS)
    engine = SearchEngine(IndexBundle(products=products), device="cuda")
    route = getattr(engine.featurizer, "route", "python")
    for q in cs._queries(cs.N_QUERIES, cs.DIM, cs.VOCAB):  # phase 4's run_search
        engine.featurizer.featurize(q)
    engine.search_bm25(cs._queries(1, cs.DIM, cs.VOCAB)[0], cs.K)  # phase 6's warm-up
    torch.cuda.synchronize()
    queries = cs._queries(cs.N_QUERIES, cs.DIM, cs.VOCAB, seed=43)
    for pass_ in ("unseen", "repeat"):
        lat = cs._bm25_pass(engine, queries, "a_eager", products.n_padded)
        print(json.dumps({"tag": tag, "measure": "search_bm25", "pass": pass_, "route": route,
                          **cs._pct(lat)}), flush=True)
    qvecs, _qt, qstrings = cs._bench_queries(cs.BENCH_QUERIES, cs.DIM, cs.VOCAB)
    w = FusionWeights.make(*cs.BENCH_W)
    engine.query_fused(qvecs[0], qstrings[0], w, cs.POOL, cs.K)[0].cpu()
    for b in cs.BATCHES:  # phase 7's first pass at each B
        cs._batch_latencies(lambda lo, hi: engine.query_fused_batched(
            qvecs[lo:hi], qstrings[lo:hi], w, cs.POOL, cs.K), cs.BENCH_QUERIES, b)
    for b in cs.BATCHES:
        qps = cs._batched_qps(engine, qvecs, qstrings, w, b)
        print(json.dumps({"tag": tag, "measure": "query_fused_batched", "B": b, "route": route,
                          "qps": qps, "reps": cs.QPS_REPS}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--kernel", choices=("attention", "bm25", "stage_a", "featurize"),
                    default="attention")
    ap.add_argument("--parent", default=None,
                    help="--kernel stage_a: a checkout whose stage-A kernels run in turns "
                         "with ROOT's in this process")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    from review_recommender_tpu_torch import kernels

    if not str(Path(kernels.__file__).resolve()).startswith(str(root)):
        print(f"torch_attention_ab: imported {kernels.__file__}, not from {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    kernels.build()
    print(json.dumps({"tag": args.tag, "root": str(root), "card": smi, "kernel": args.kernel}),
          flush=True)
    if args.kernel == "stage_a":
        _stage_a(torch, args.tag, args.parent)
    else:
        {"attention": _attention, "bm25": _bm25,
         "featurize": _featurize}[args.kernel](torch, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
