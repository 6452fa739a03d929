#!/usr/bin/env python3
"""Where the BM25 scan kernels' time goes, on one NVIDIA GPU.

    python3 examples/torch_bm25_breakdown.py

Run from the root of a checkout; prints JSON lines:

  floor      the median CUDA-event time of a near-empty kernel launch
             (torch.cuda._sleep(0)) queued behind a 0.1 ms device spin: the
             least any timed launch below can take
  sweep      both kernels at N = 200,192 (chip_smoke.py phase 5's postings)
             for (L, Q) in SWEEP, behind a spin and behind an L2 flush; L = 0
             leaves only the per-block work (table, epilogue, launch)
  phases     median over blocks of the clock64 cycles each block spends in
             table build, accumulator zeroing, its first tile's postings,
             that tile's epilogue, and the rest, from an instrumented copy of
             csrc/bm25_full.cu (built into build/bm25_breakdown/, timestamps
             taken by each block's thread 0) at (200,192, 0 or 64, 32); the
             copy may use more registers than the kernel and fit fewer
             blocks on an SM ("blocks" says how many ran), so read its
             phases as shares, not as the kernel's times
  sass       SASS instructions of each kernel's one-probe posting loop
             (cuobjdump -sass): from the loop head to the batch's last add,
             per posting (packed: a batch is 8 rows x 4 documents; unpacked:
             a chunk is 16 lanes of a row)

The first line is the card's name and power limit. The copy's
instrumentation finds its places by text; it fails loudly if the source
has moved on.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SWEEP = [(0, 32), (8, 32), (64, 8), (64, 32), (64, 64)]  # (L, Q)
N_DOCS = 200_192
SLOTS = 8  # clock64 stamps per block
STAMP = ("if (threadIdx.x == 0) {{ long long c_; asm volatile(\"mov.u64 %0, %%clock64;\" "
         ": \"=l\"(c_)); g_stamp[blockIdx.x * 8 + {k}] = c_; }}\n")


def _insert_after(src: str, anchor: str, text: str, start: int = 0) -> tuple[str, int]:
    a = src.index(anchor, start)
    e = src.index(";\n", a) + 2 if not anchor.endswith("\n") else a + len(anchor)
    return src[:e] + text + src[e:], e


def instrumented_source() -> str:
    """csrc/bm25_full.cu with a clock64 stamp at each phase boundary of both
    kernels, a stamp buffer and a C entry that copies it out."""
    src = (ROOT / "review_recommender_tpu_torch" / "csrc" / "bm25_full.cu").read_text()
    src = src.replace("namespace {\n", "__device__ long long g_stamp[8 * 8192];\nnamespace {\n", 1)
    for kern in ("bm25_packed_kernel(const int32_t*", "bm25_unpacked_kernel(const int32_t*"):
        a = src.index(kern)
        body = src.index("{\n", a) + 2
        src = src[:body] + STAMP.format(k=0) + src[body:]
        src, e = _insert_after(src, "  build_table(t, key", STAMP.format(k=1), body)
        src, e = _insert_after(src, "  zero_shared(", STAMP.format(k=2), e)
        a = src.index("  if (t.probes == 1)", e)
        end = src.index("\n}\n", a) + 1
        src = src[:end] + STAMP.format(k=5) + src[end:]
    first = "if (i + 1 == {n}) {{ " + "{stamp}" + "}}\n"
    for anchor, k, n in (
            ("    packed_batch<kOne>(t, mult, probes, acc, q * kPkRowBytes, cur);", 3, "batches"),
            ("      packed_epilogue<kPkDocs>(t, acc, q, l, dl, avgdl, out, col, n, i + 1 == items)",
             4, "batches"),
            ("      if (c == chunks - 1) {  // the row's last lanes", 3, "chunks"),
            ("        out[row] = score[0];\n", 4, "chunks")):
        anchor = src[src.index(anchor):src.index("\n", src.index(anchor)) + 1]
        src, _ = _insert_after(src, anchor, first.format(n=n, stamp=STAMP.format(k=k)))
    src += ('\nextern "C" int rrt_stamps(void* host) '
            '{ return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp)); }\n'
            'extern "C" int rrt_stamps_clear() { void* p; cudaGetSymbolAddress(&p, g_stamp); '
            'return (int)cudaMemset(p, 0, sizeof(g_stamp)); }\n')
    return src


def _inputs(torch, cs, l, q):
    terms, tf, doc_len, packed, qt, qi, avgdl = cs._bm25_postings(torch, N_DOCS, max(l, 4), q, 300)
    if l == 0:
        terms, tf = terms[:, :0].contiguous(), tf[:, :0].contiguous()
        packed = packed[:0].contiguous()
    return terms, tf, doc_len, packed, qt, qi, avgdl


def sweep(torch, cs, BK, spin, flush) -> None:
    for l, q in SWEEP:
        terms, tf, doc_len, packed, qt, qi, avgdl = _inputs(torch, cs, l, q)
        row = {"what": "sweep", "N": N_DOCS, "L": l, "Q": q}
        for name, fn, args in (("packed", BK.bm25_full_scores_packed_kernel,
                                (packed, doc_len, qt, qi, avgdl)),
                               ("unpacked", BK.bm25_full_scores_kernel,
                                (terms, tf, doc_len, qt, qi, avgdl))):
            for _ in range(3):
                fn(*args)
            run = lambda: fn(*args)
            row[f"{name}_ms"] = cs._median_ms(torch, run, cs.REPS, before=spin)
            row[f"{name}_cold_l2_ms"] = cs._median_ms(torch, run, cs.REPS, before=flush)
        print(json.dumps(row), flush=True)


def phases(torch, cs, nvcc: str, spin) -> None:
    out = ROOT / "build" / "bm25_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bm25_stamped.cu").write_text(instrumented_source())
    lib_path = out / "libbm25_stamped.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib_path),
                    str(out / "bm25_stamped.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rrt_bm25_packed.argtypes = [P, P, P, P, F, P, I, I, I, P]
    lib.rrt_bm25_unpacked.argtypes = [P, P, P, P, P, F, P, I, I, I, P]
    lib.rrt_stamps.argtypes = [P]
    stream = torch.cuda.current_stream().cuda_stream
    for l in (0, 64):
        terms, tf, doc_len, packed, qt, qi, avgdl = _inputs(torch, cs, l, 32)
        out_t = torch.empty(N_DOCS, device="cuda")
        calls = {
            "packed": lambda: lib.rrt_bm25_packed(
                packed.data_ptr(), doc_len.data_ptr(), qt.data_ptr(), qi.data_ptr(), avgdl,
                out_t.data_ptr(), N_DOCS, l, 32, stream),
            "unpacked": lambda: lib.rrt_bm25_unpacked(
                terms.data_ptr(), tf.data_ptr(), doc_len.data_ptr(), qt.data_ptr(),
                qi.data_ptr(), avgdl, out_t.data_ptr(), N_DOCS, l, 32, stream)}
        for name, call in calls.items():
            stamps = np.zeros(8 * 8192, np.int64)
            torch.cuda.synchronize()
            if lib.rrt_stamps_clear() != 0:
                raise RuntimeError("stamp buffer not cleared")
            for _ in range(3):
                spin()
                if call() != 0:
                    raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            lib.rrt_stamps(stamps.ctypes.data)
            d = stamps.reshape(-1, SLOTS)
            d = d[d[:, 0] != 0]  # the blocks that ran
            span = {"table": d[:, 1] - d[:, 0], "zero": d[:, 2] - d[:, 1],
                    "first_tile_postings": d[:, 3] - d[:, 2],
                    "first_tile_epilogue": d[:, 4] - d[:, 3], "rest": d[:, 5] - d[:, 4],
                    "total": d[:, 5] - d[:, 0]}
            print(json.dumps({"what": "phases", "kernel": name, "N": N_DOCS, "L": l, "Q": 32,
                              "blocks": int(d.shape[0]),
                              "median_cycles": {k: int(np.median(v)) for k, v in span.items()}}),
                  flush=True)


def _loop_counts(ops: list[str], adds: list[int], per: int) -> list[dict]:
    """For each group of `per` posting adds (one per instantiation of the
    posting loop: one-probe and probing), the instructions from the loop
    head (the latest backward-branch target at or before the group's
    lookups) to the group's last add. The one-probe loop is the shorter."""
    addr = {o.split()[0]: i for i, o in enumerate(ops) if o}
    lookups = [i for i, o in enumerate(ops) if "LDS.64" in o]
    out = []
    for g in range(0, len(adds) - per + 1, per):
        first, last = adds[g], adds[g + per - 1]
        before = [i for i in lookups if i < first]
        start = before[-per] if len(before) >= per else 0
        heads = []
        for i, o in enumerate(ops):
            m = re.search(r"BRA 0x([0-9a-f]+)", o)
            if m and i > last:
                j = addr.get(m.group(1).lstrip("0").rjust(4, "0"))
                if j is not None and j <= start:
                    heads.append(j)
        head = max(heads) if heads else start
        n = last - head + 1
        out.append({"instructions": n, "postings": per, "per_posting": n / per})
    return out


def sass(lib_path: Path) -> None:
    text = subprocess.run(["cuobjdump", "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    for fn in re.split(r"\n\s+Function : ", text)[1:]:
        name = fn.split("\n", 1)[0]
        if "bm25" not in name:
            continue
        ops = [re.sub(r"^\s*/\*([0-9a-f]+)\*/\s*", r"\1 ", line).split(";")[0].strip()
               for line in fn.split("\n") if re.search(r"/\*[0-9a-f]{4,5}\*/", line)]
        if "unpacked" in name:  # a load, an add and a store: the stores after an FADD
            adds = [i for i, o in enumerate(ops) if re.search(r" STS \[", o)
                    and any(" FADD " in ops[k] for k in range(max(0, i - 6), i))]
            per = 16
        else:  # integer shared reductions
            adds = [i for i, o in enumerate(ops) if "ATOMS.ADD" in o]
            per = 32
        loops = _loop_counts(ops, adds, per)
        print(json.dumps({"what": "sass", "function": name[:90], "loops": loops,
                          "one_probe_per_posting": min(x["per_posting"] for x in loops)
                          if loops else None}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bm25_breakdown: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from review_recommender_tpu_torch import kernels
    from review_recommender_tpu_torch.ops import bm25_kernel as BK

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    lib_path = kernels.build()
    spin = lambda: torch.cuda._sleep(cs.SPIN_CYCLES)
    flush_buf = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    flush = lambda: flush_buf.fill_(1.0)
    print(json.dumps({"what": "floor", "empty_launch_ms":
                      cs._median_ms(torch, lambda: torch.cuda._sleep(0), cs.REPS, before=spin)}),
          flush=True)
    sweep(torch, cs, BK, spin, flush)
    phases(torch, cs, kernels.nvcc_path(), spin)
    sass(lib_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
