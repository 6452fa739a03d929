#!/usr/bin/env python3
"""Time one checkout's attention, BM25 or stage-A kernels, or its host
featurizer on the engine paths (review_recommender_tpu_torch), on one NVIDIA
GPU, for an A/B of two versions on the same card.

    python3 examples/torch_attention_ab.py [ROOT] [--tag NAME]
        [--kernel attention|wide_heads|bm25|stage_a|featurize] [--parent PARENT]

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

--kernel wide_heads: the attention routes for head widths past 128, at
chip_smoke.py phase 19 (g)'s WIDE_SHAPE (32, 128, 2, 192), at (64, 512,
2, 192), at (64, 512, 1, 256), and past 256 at (64, 512, 1, 384) (phase
19 (h)'s kernel rows), (2, 64, 1, 1,024) and (50, 287, 1, 384) (phase 20
(c)'s rerank), in bf16 and f32, and f16 at (4, 200, 2, 257) (phase 3's
rows that TMA cannot read in place): ROOT's chip_smoke.py's
_training_kernel_rows (the forward kernel, csrc/mha_generic.cu at 192 or
256 columns or csrc/mha_wide.cu past 256, against its plain version and
SDPA's forward; the backward kernel, csrc/mha_bwd.cu or
csrc/mha_wide_bwd.cu by backward_route, against the recompute and SDPA's
forward and backward together; the bounds), and beside them SDPA's
backward alone (autograd.grad through one saved SDPA forward,
sdpa_backward_ms), all behind a 0.1 ms spin, with the backend SDPA took
(sdpa_backend: the kernels a torch.profiler window of its forward and
backward saw, flash, efficient, cudnn or math; flash takes no head past
256) and each kernel's device µs of the forward and of the backward
(forward_kernel_us, backward_kernel_us: a profiler window of 20 calls);
first, ptxas's registers and spill stores of each instance of the wide
kernels (a side build with -Xptxas -v: csrc/mha_wide*.cu, the f32 ones
csrc/mha_wide_f32.cu's score, product and layout kernels).
Each row names the routes it ran: backward_route (a checkout before bf16
went to the tensor cores at these widths reports "fma" for both dtypes,
one before f32 did for f32), and the padded width of the instances the
forward and the backward launched (forward_dp, backward_dp:
rrt_mha_generic_last_dp and rrt_mha_bwd_last_dp; null in a checkout that
does not export them, whose f32 forward at these widths is the CUDA-core
kernel) or, past 256 columns, the wide kernels' column chunks
(forward_dc, backward_dc: rrt_mha_wide_last_dc and
rrt_mha_wide_bwd_last_dc, dQ's and dK / dV's; f32 in a checkout with
csrc/mha_wide_f32.cu, rrt_mha_wide_f32_dc), which of their passes
kept the CTA's own rows resident in shared memory (forward_resident,
backward_resident: bit masks, rrt_mha_wide_last_resident and
rrt_mha_wide_bwd_last_resident; null for f32 there), and how the 16-bit
kernels shared each row block's scores (forward_split, backward_split:
rrt_mha_wide_last_split and rrt_mha_wide_bwd_last_split; null in a
checkout without them). With --parent
PARENT (a `git archive` of the parent unpacked under build/) the script
runs itself four times, in the order PARENT, ROOT, ROOT, PARENT, each in
its own process (tags "parent" and "change"), and then prints one "ab"
line per dtype and shape: the forward and backward device ms of each
run, their means and change_over_parent.

--kernel bm25: for each of chip_smoke.py's BM25 shapes, the packed and the
unpacked kernel on phase 5's postings (drawn on the card by this script's
own chip_smoke.py, so both checkouts get the same inputs), one JSON line
each: device_ms as above, and cold_l2_ms, each launch queued behind a 256
MB fill that flushes the 50 MB L2.

--kernel stage_a: the stage-A tile pass (stage_a_tile_winners_kernel) on
corpora of 200,704 unit rows drawn on the card from a seeded
torch.Generator (3% of rows invalid), at each (dtype, D, batches) of
STAGE_A_CELLS: phase 8's D = 384 in bf16 and f32 at B = 1, 8, 32, 128;
f32 at D = 3,072 and 4,096 at B = 1, 32, 128; widths the first routes
refused, bf16 D = 60 and 5,000 and f32 D = 6 and 4,100, at B = 32; and
widths where the first layout (queries resident in shared memory) ran
narrowed chunks, f32 D = 768 and 1,536 at B = 32 and 128 and bf16 D =
1,024 and 4,096 at B = 128. One
JSON line each with the route (ops/stage_a.py:stage_a_route): device_ms
and cold_l2_ms as above, plain_ms (the plain tile pass, behind the spin),
bound_ms (the corpus, mask and queries read once and the winners written
once over 3.35 TB/s, against 2 N D B products at 989 TFLOP/s in bf16 or
495 / 3 in f32) and share_of_bound. With --parent PARENT (another
checkout, e.g. a `git archive` of the parent commit unpacked under
build/), PARENT's csrc/stage_a_*.cu are built into build/stage_a_ab/ and
called through their own C entries (bf16 rrt_stage_a_wgmma; f32
rrt_stage_a_tf32, or rrt_stage_a_fma at the widths that one took, or else
rrt_stage_a_f32; with a workspace where PARENT's entries take one) in the
same process, in the order parent, change,
change, parent: device_ms of each, their ratio and the largest score
difference (and whether the winners are bit-equal); where no entry of
PARENT takes the width, the change alone. --dims D [D ...] keeps the cells
of those widths only; --phase4 times chip_smoke.py phase 4's corpus
instead (200,192 synthetic rows of D = 384 in bf16, and cast to f32 as
phase 8 does, at B = 1, 32, 128 of its bench queries).

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
import ctypes
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


def _own_chip_smoke(root: Path = HERE):
    """This checkout's chip_smoke.py (or `root`'s), loaded by path: its BM25
    shapes and postings, whatever ROOT is."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", root / "chip_smoke.py")
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


# (dtype, D, batch widths) of --kernel stage_a
STAGE_A_CELLS = [("bfloat16", 384, (1, 8, 32, 128)), ("float32", 384, (1, 8, 32, 128)),
                 ("float32", 3072, (1, 32, 128)), ("float32", 4096, (1, 32, 128)),
                 ("bfloat16", 60, (32,)), ("bfloat16", 5000, (32,)), ("float32", 6, (32,)),
                 ("float32", 4100, (32,)), ("float32", 768, (32, 128)),
                 ("float32", 1536, (32, 128)), ("bfloat16", 1024, (128,)),
                 ("bfloat16", 4096, (128,))]
PEAK_HBM, PEAK_BF16, PEAK_F32_EXACT = 3.35e12, 989e12, 495e12 / 3


def _parent_stage_a(parent: Path):
    """PARENT's stage-A kernels in a library of their own: a function of
    (dtype, D) giving a call (emb, valid, qvecs, out_s, out_i, N, D, B,
    stream) -> cudaError of PARENT's C entry that takes that width, or
    None. Entries of three generations: with a workspace sized by PARENT's
    rrt_stage_a_*_workspace (any D), or without one (bf16 and f32 up to
    rrt_stage_a_tf32_max_dim, then rrt_stage_a_fma, or rrt_stage_a_f32)."""
    import torch

    from review_recommender_tpu_torch import kernels

    csrc = parent / "review_recommender_tpu_torch" / "csrc"
    out = HERE / "build" / "stage_a_ab" / "parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels.nvcc_path(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-I", str(csrc), "-shared", "-o", str(out), *map(str, sorted(csrc.glob("stage_a_*.cu")))]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "rrt_stage_a_wgmma_workspace"):
        def with_workspace(entry: str):
            fn, size = getattr(lib, f"rrt_stage_a_{entry}"), getattr(lib, f"rrt_stage_a_{entry}_workspace")
            fn.argtypes, fn.restype = [P] * 6 + [I] * 3 + [P], I
            size.argtypes, size.restype = [I, I], ctypes.c_longlong

            def call(emb, valid, qv, out_s, out_i, n, d, b, stream):
                ws = torch.empty(max(size(d, b), 16), dtype=torch.uint8, device="cuda")
                return fn(emb, valid, qv, ws.data_ptr(), out_s, out_i, n, d, b, stream)
            return call
        calls = {"bfloat16": with_workspace("wgmma"), "float32": with_workspace("tf32")}
        return lambda dtype, d: calls[dtype]
    tf32 = getattr(lib, "rrt_stage_a_tf32", None)
    fma = getattr(lib, "rrt_stage_a_fma", None)
    f32 = getattr(lib, "rrt_stage_a_f32", None)
    for fn in (lib.rrt_stage_a_wgmma, tf32, fma, f32):
        if fn is not None:
            fn.argtypes = [P] * 5 + [I] * 3 + [P]
            fn.restype = I
    tf32_max = lib.rrt_stage_a_tf32_max_dim() if tf32 is not None else 0

    def entry(dtype: str, d: int):
        if dtype == "bfloat16":
            return lib.rrt_stage_a_wgmma if d % 8 == 0 and d <= 4096 else None
        if d % 4 or d > 4096:
            return None
        if tf32 is not None:
            return tf32 if d <= tf32_max else fma
        return f32
    return entry


def _stage_a_corpora(torch, dims=None, phase4=False):
    """(corpus, dtype, emb, valid, batch widths, queries of a width) for each
    cell: STAGE_A_CELLS on seeded unit rows, or chip_smoke.py phase 4's
    corpus (bf16, then cast to f32 as its phase 8 does) and its bench
    queries."""
    if phase4:
        from review_recommender_tpu_torch.engine.search import SearchEngine
        from review_recommender_tpu_torch.index.build import synth_product_index
        from review_recommender_tpu_torch.index.schema import IndexBundle

        cs = _own_chip_smoke()
        products = synth_product_index(cs.N_DOCS, cs.DIM, cs.VOCAB, cs.TERMS, seed=0,
                                       text_chars=cs.TEXT_CHARS)
        arrays = SearchEngine(IndexBundle(products=products), device="cuda").arrays
        qvecs = cs._bench_queries(cs.BENCH_QUERIES, cs.DIM, cs.VOCAB)[0]
        for dtype in ("bfloat16", "float32"):
            yield ("phase4", dtype, arrays["emb"].to(getattr(torch, dtype)), arrays["valid"],
                   (1, 32, 128), lambda b: qvecs[:b])
        return
    n = 200_704
    for dtype, d, batches in STAGE_A_CELLS:
        if dims and d not in dims:
            continue
        g = torch.Generator(device="cuda").manual_seed(600 if d == 384 else 600 + d)
        emb = torch.randn(n, d, generator=g, device="cuda")
        emb = emb / emb.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=g, device="cuda") >= 0.03
        rng = np.random.default_rng(601)

        def queries(b, rng=rng, d=d):  # drawn in turn, as the cell's widths come
            q = rng.standard_normal((b, d)).astype(np.float32)
            return q / np.linalg.norm(q, axis=1, keepdims=True)
        yield "unit", dtype, emb.to(getattr(torch, dtype)), valid, batches, queries
        del emb, valid
        torch.cuda.empty_cache()


def _stage_a(torch, tag: str, parent=None, dims=None, phase4=False) -> None:
    from review_recommender_tpu_torch.ops import stage_a as SA

    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    flush_buf = torch.empty((256 << 20) // 4, dtype=torch.float32, device="cuda")
    flush = lambda: flush_buf.fill_(1.0)
    entry = _parent_stage_a(Path(parent).resolve()) if parent else None
    for corpus, dtype, emb, valid, batches, queries in _stage_a_corpora(torch, dims, phase4):
        n, d = emb.shape
        tiles = -(-n // 2048)
        itemsize = emb.element_size()
        fn = entry(dtype, d) if entry else None
        for b in batches:
            qv = torch.from_numpy(np.ascontiguousarray(queries(b))).to("cuda")
            run = lambda: SA.stage_a_tile_winners_kernel(emb, valid, qv)
            plain = lambda: SA.stage_a_tile_winners_reference(emb, valid, qv)
            nbytes = n * d * itemsize + n + b * d * 4 + tiles * 16 * b * 8
            bounds = {"bytes": nbytes / PEAK_HBM * 1e3,
                      "operations": 2 * n * d * b / (PEAK_BF16 if dtype == "bfloat16"
                                                     else PEAK_F32_EXACT) * 1e3}
            by = max(bounds, key=bounds.get)
            row = {"tag": tag, "kernel": "stage_a", "corpus": corpus, "dtype": dtype, "N": n,
                   "D": d, "B": b, "route": SA.stage_a_route(emb.dtype, d, b),
                   "query_chunk": SA.stage_a_query_chunk(d, b, emb.dtype),
                   "bound_ms": bounds[by], "bound_by": by, "reps": REPS}
            for _ in range(3):
                got = run()
                plain()
            if fn is None:
                row.update(device_ms=_median_ms(torch, run, before=spin),
                           cold_l2_ms=_median_ms(torch, run, before=flush))
            else:
                out_s = torch.empty(tiles, 16, b, device="cuda")
                out_i = torch.empty(tiles, 16, b, dtype=torch.int32, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                prun = lambda: fn(emb.data_ptr(), valid.data_ptr(), qv.data_ptr(),
                                  out_s.data_ptr(), out_i.data_ptr(), n, d, b, stream)
                for _ in range(3):
                    if prun() != 0:
                        raise SystemExit(f"parent stage A failed to launch ({dtype}, D={d}, B={b})")
                t = [_median_ms(torch, f, before=spin) for f in (prun, run, run, prun)]
                row.update(parent_ms=[t[0], t[3]], change_ms=[t[1], t[2]],
                           device_ms=(t[1] + t[2]) / 2,
                           change_over_parent=(t[1] + t[2]) / (t[0] + t[3]),
                           max_abs_diff_vs_parent=float((got[0] - out_s).abs().max()),
                           equal_to_parent=bool(torch.equal(got[0], out_s)
                                                and torch.equal(got[1], out_i)))
            row["plain_ms"] = _median_ms(torch, plain, before=spin)
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            row["max_abs_err_vs_plain"] = float((got[0] - plain()[0]).abs().max())
            print(json.dumps(row), flush=True)


WIDE_HEAD_SHAPES = [(32, 128, 2, 192), (64, 512, 2, 192), (64, 512, 1, 256), (64, 512, 1, 384),
                    (2, 64, 1, 1024), (50, 287, 1, 384)]
# float16 rows past 256 columns: chip_smoke.py phase 3's odd width (H * D * 2
# = 1,028 bytes: the rows TMA cannot read in place)
WIDE_F16_SHAPES = [(4, 200, 2, 257)]


def _last_dp(lib, name: str):
    """The padded width of the instance the last call of a C entry
    launched, where the library exports it (None where not)."""
    try:
        fn = getattr(lib, name)
    except AttributeError:
        return None
    fn.restype = ctypes.c_int
    return int(fn())


def _kernel_us(torch, fn, n=20) -> dict:
    """Device µs a call of fn spends in each CUDA kernel it launches, from a
    torch.profiler window of n calls, by kernel name (template arguments
    kept: the wide kernels' passes differ only there)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t:
            key = re.sub(r"\(.*$", "", e.key.replace("(anonymous namespace)::", ""))[-80:]
            out[key] = out.get(key, 0.0) + t / n
    return out


def _sdpa_backend(names) -> str:
    """The SDPA backend whose kernels a profiler window saw."""
    text = " ".join(names).lower()
    for backend, marks in (("flash", ("flash",)), ("cudnn", ("cudnn",)),
                           ("efficient", ("fmha", "efficient", "mem_eff"))):
        if any(m in text for m in marks):
            return backend
    return "math"


def _split(lib, entry: str, *args):
    """A rrt_mha_wide*_last_split reading, where the library exports it."""
    try:
        fn = getattr(lib, entry)
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_longlong
    return int(fn(*args))


def _wide_registers(tag: str) -> None:
    """ptxas's registers and spills for each instance of the wide kernels
    (csrc/mha_wide*.cu), from a side build with -Xptxas -v (a library of
    its own name; the timed one is not touched). A checkout without the
    wide kernels prints nothing."""
    import re

    from review_recommender_tpu_torch import kernels

    kernels.build(extra_flags=("-Xptxas", "-v"))
    name = None
    for line in kernels.build_info.get("nvcc_output", "").splitlines():
        m = re.search(r"Compiling entry function '\w*?(wide_f32_(?:score|product)_kernel)ILi(\d)E",
                      line)
        if m:  # csrc/mha_wide_f32.cu: score MODE 0/1, product KIND 0/1/2
            name = f"{m.group(1)} {'MODE' if 'score' in m.group(1) else 'KIND'}={m.group(2)}"
            continue
        m = re.search(r"Compiling entry function '\w*?(wide_f32_\w+?_kernel)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Compiling entry function '\w*?(wide_(?:score|product)_kernel)I(\w+?)Li(\d)E",
                      line)
        if m:  # the 16-bit kernels: score MODE 0/1, product KIND 0/1/2
            dtype = "bfloat16" if "bfloat16" in m.group(2) else "float16"
            name = f"{m.group(1)} {dtype} {'MODE' if 'score' in m.group(1) else 'KIND'}={m.group(3)}"
            continue
        m = re.search(r"Compiling entry function '(\w*mha_wide\w*)'", line)
        if m:
            k = re.search(r"(mha_wide_(?:fwd|bwd)_kernel)I(\w*?)Li(\d+)E(?:Li(\d+)E)?Lb(\d)",
                          m.group(1))
            dtype = ("" if not k else "bfloat16" if "bfloat16" in k.group(2)
                     else "float16" if "half" in k.group(2) else "float32")
            name = (f"{k.group(1)} {dtype} {'KIND=' + k.group(3) + ' DC=' + k.group(4) if k.group(4) else 'DC=' + k.group(3)} RES={k.group(5)}"
                    if k else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(json.dumps({"tag": tag, "kernel": "wide_heads", "instance": name,
                              "registers": int(m.group(1)), "spill_stores": spills}), flush=True)
            name = None


def _wide_heads(torch, tag: str, root: Path) -> None:
    from review_recommender_tpu_torch import kernels
    from review_recommender_tpu_torch.ops import attention as A

    cs = _own_chip_smoke(root)  # ROOT's rows: its backward's exponential count is its own
    _wide_registers(tag)
    lib = kernels.load()
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        shapes = []  # the widths ROOT's port takes (a checkout before the wide route: <= 256)
        for shape in (WIDE_F16_SHAPES if dtype == torch.float16 else WIDE_HEAD_SHAPES):
            try:
                A.kernel_route(dtype, shape[3], shape[1])
                shapes.append(shape)
            except ValueError:
                print(json.dumps({"tag": tag, "kernel": "wide_heads", "skipped": shape,
                                  "dtype": str(dtype)}), flush=True)
        rows = cs._training_kernel_rows(torch, shapes, dtype)
        for i, row in enumerate(rows):
            b, s, h, d = shapes[i]
            rng = np.random.default_rng(300 + i)  # _training_kernel_rows' inputs
            q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
                          .to("cuda", dtype) for _ in range(4))
            lens = rng.integers(1, s + 1, size=b)
            bias = torch.from_numpy(np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30)
                                    .astype(np.float32)).to("cuda")
            with torch.no_grad():
                A.mha_kernel(q, k, v, bias, h)
                row["forward_dp"] = _last_dp(lib, "rrt_mha_generic_last_dp")
                A._launch_bwd(q, k, v, bias, g, h)
                row["backward_dp"] = _last_dp(lib, "rrt_mha_bwd_last_dp")
                if d > 256 and dtype == torch.float32 and hasattr(lib, "rrt_mha_wide_f32_dc"):
                    row["forward_dc"] = _last_dp(lib, "rrt_mha_wide_f32_dc")
                    row["backward_dc"] = [row["forward_dc"]] * 2
                    row["forward_resident"] = row["backward_resident"] = None
                elif d > 256:
                    row["forward_dc"] = _last_dp(lib, "rrt_mha_wide_last_dc")
                    row["forward_resident"] = _last_dp(lib, "rrt_mha_wide_last_resident")
                    A._launch_bwd(q, k, v, bias, g, h)
                    wide_bwd = lib.rrt_mha_wide_bwd_last_dc
                    row["backward_dc"] = [wide_bwd(0), wide_bwd(1)]
                    row["backward_resident"] = _last_dp(lib, "rrt_mha_wide_bwd_last_resident")
                    # the tiles of S of one contraction, CTAs reading
                    # them back, TMA in place (a checkout before these
                    # entries: null)
                    row["forward_split"] = [_split(lib, "rrt_mha_wide_last_split", i)
                                            for i in range(3)]
                    row["backward_split"] = [[_split(lib, "rrt_mha_wide_bwd_last_split", k, i)
                                              for i in range(3)] for k in range(2)]
                row["forward_kernel_us"] = _kernel_us(torch, lambda: A.mha_kernel(q, k, v, bias, h))
                row["backward_kernel_us"] = _kernel_us(
                    torch, lambda: A._launch_bwd(q, k, v, bias, g, h))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            with torch.enable_grad():
                out = cs._sdpa(torch, *leaves, bias, h)
                backward = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
                backward()
                row["sdpa_backward_ms"] = _median_ms(torch, backward, before=spin)
                row["sdpa_backend"] = _sdpa_backend(_kernel_us(
                    torch, lambda: torch.autograd.grad(cs._sdpa(torch, *leaves, bias, h), leaves,
                                                       g), n=2))
            print(json.dumps({"tag": tag, "kernel": "wide_heads", **row}), flush=True)


def _wide_heads_ab(root: Path, parent: Path) -> int:
    """--kernel wide_heads --parent: this script on PARENT, ROOT, ROOT,
    PARENT, a process each (their lines passed through), then an "ab" line
    per (dtype, shape) with each run's forward and backward device ms."""
    runs = {}
    for tag, at in (("parent", parent), ("change", root), ("change", root), ("parent", parent)):
        proc = subprocess.run([sys.executable, __file__, str(at), "--kernel", "wide_heads",
                               "--tag", tag], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        for line in proc.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if "backward_ms" in row:
                key = (row["dtype"], row["B"], row["S"], row["H"], row["D"])
                runs.setdefault(key, {}).setdefault(tag, []).append(
                    (row["ms"], row["backward_ms"]))
    for (dtype, b, s, h, d), sides in runs.items():
        if len(sides) < 2:
            continue
        out = {"ab": "wide_heads", "dtype": dtype, "B": b, "S": s, "H": h, "D": d}
        for i, what in enumerate(("forward", "backward")):
            par = [t[i] for t in sides["parent"]]
            chg = [t[i] for t in sides["change"]]
            out.update({f"{what}_parent_ms": par, f"{what}_change_ms": chg,
                        f"{what}_change_over_parent": float(np.mean(chg) / np.mean(par))})
        print(json.dumps(out), flush=True)
    return 0


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
    ap.add_argument("--kernel", choices=("attention", "wide_heads", "bm25", "stage_a", "featurize"),
                    default="attention")
    ap.add_argument("--parent", default=None,
                    help="--kernel stage_a: a checkout whose stage-A kernels run in turns "
                         "with ROOT's in this process; --kernel wide_heads: a checkout run "
                         "in turns with ROOT, a process each")
    ap.add_argument("--dims", type=int, nargs="+", default=None,
                    help="--kernel stage_a: only the cells of these widths")
    ap.add_argument("--phase4", action="store_true",
                    help="--kernel stage_a: chip_smoke.py phase 4's corpus in place of the cells")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.kernel == "wide_heads" and args.parent:
        return _wide_heads_ab(root, Path(args.parent).resolve())
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
        _stage_a(torch, args.tag, args.parent, args.dims, args.phase4)
    elif args.kernel == "wide_heads":
        _wide_heads(torch, args.tag, root)
    else:
        {"attention": _attention, "bm25": _bm25,
         "featurize": _featurize}[args.kernel](torch, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
