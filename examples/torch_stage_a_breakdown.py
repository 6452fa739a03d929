#!/usr/bin/env python3
"""Where the stage-A tile pass spends its time on the card: the kernel of
csrc/stage_a_wgmma.cu, bf16 and f32 (3xTF32), against copies with parts
taken out.

    python3 examples/torch_stage_a_breakdown.py

Each copy is made from the source by text edits (the script finds its
places by text and fails loudly when they move), built with nvcc into
build/stage_a_breakdown/ and loaded on its own:

  full          the kernel as it is (both types)
  no_select     the selection warps read each slab's scores and hand the
                buffer back, but append nothing (no lists, no pruning;
                both types)
  loads_only    no_select without the wgmmas: the loads (corpus boxes by
                TMA, query boxes by bulk copy), the query-box kernel and
                the handshakes alone, the floor of this structure (in f32
                also the loads of lo into registers and its split, which
                stay: the registers are pinned); no_select less
                loads_only is the products' time (without them every
                score is 0 and the selection would append every row)
  chunk64       chunks of at most 64 queries (B = 128 runs as two chunks,
                reading the corpus twice; bf16)
  no_split      f32 with lo = 0: no loads into registers and no split
                (both products and the selection still run; the scores
                are off by up to 2^-10 of a product)

On one 200,704 x 384 corpus of unit rows drawn on the card from a seeded
torch.Generator (3% invalid), in bf16 and in f32, at B = 1, 8, 32 and 128
seeded unit queries (the inputs of examples/torch_attention_ab.py --kernel
stage_a): one JSON line per dtype and B with each copy's median of 50
CUDA-event times, each launch queued behind a 0.1 ms device spin. The
first line has the card's name and power limit. Needs one NVIDIA Hopper
GPU with nvcc (~40 s).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SRC = ROOT / "review_recommender_tpu_torch" / "csrc" / "stage_a_wgmma.cu"
OUT = ROOT / "build" / "stage_a_breakdown"
N, D, BATCHES, REPS, SPIN_CYCLES = 200_704, 384, (1, 8, 32, 128), 50, 200_000
MMA = "            Wgmma<NC>::mma(acc, desc_sw128(a + kk * 32), desc_sw128(bq + kk * 32), (x | kk) != 0);"
MMA_TF32 = ("          wgmma_ss_tf32(acc, desc_sw128(a + kk * 32), db, (x | kk) != 0);  // N = 2 NC\n"
            "          wgmma_rs_tf32(acc_lo, al, db, (x | kk) != 0);                     // N = NC\n")
SPLIT = ("          lo[4 * kk + e] = __float_as_uint(v - __uint_as_float(__float_as_uint(v) & "
         "0xFFFFE000u));\n")
# the copies each corpus type runs
COPIES = {"bfloat16": ("full", "no_select", "loads_only", "chunk64"),
          "float32": ("full", "no_select", "loads_only", "no_split")}


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SRC.name} changed: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def variants() -> dict:
    src = SRC.read_text()
    no_select = _sub(src, "        const bool pass = j < nq && sc[m][h] >= t;",
                     "        const bool pass = j < 0 && sc[m][h] >= t;")
    loads_only = _sub(_sub(no_select, MMA, MMA.replace("Wgmma", "if (kk < 0) Wgmma")),
                      MMA_TF32, MMA_TF32.replace("wgmma_rs", "if (kk < 0) wgmma_rs"))
    return {
        "full": src,
        "no_select": no_select,
        "loads_only": loads_only,
        "chunk64": _sub(src, "kBoxCols = 64, kCopies = 1, kMinChunk = 16, kMaxChunk = 128;",
                        "kBoxCols = 64, kCopies = 1, kMinChunk = 16, kMaxChunk = 64;"),
        "no_split": _sub(src, SPLIT, "          lo[4 * kk + e] = 0u;\n"),
    }


def build(texts: dict) -> dict:
    """One nvcc per copy, all started together; returns the loaded libraries."""
    from review_recommender_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.rrt_stage_a_wgmma, lib.rrt_stage_a_tf32):
            fn.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
            fn.restype = I
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_a_breakdown: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "N": N, "D": D, "reps": REPS}), flush=True)
    libs = build(variants())
    g = torch.Generator(device="cuda").manual_seed(600)  # torch_attention_ab.py's corpus
    emb32 = torch.randn(N, D, generator=g, device="cuda")
    emb32 = emb32 / emb32.norm(dim=1, keepdim=True)
    valid = torch.rand(N, generator=g, device="cuda") >= 0.03
    from review_recommender_tpu_torch.ops import stage_a as SA

    tiles = -(-N // 2048)
    ws = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")  # the query boxes: 393 KB at most
    for dtype, names in COPIES.items():
        emb = emb32.to(getattr(torch, dtype))
        rng = np.random.default_rng(601)
        for b in BATCHES:
            q = rng.standard_normal((b, D)).astype(np.float32)
            qv = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).cuda()
            out_s = torch.empty(tiles, 16, b, device="cuda")
            out_i = torch.empty(tiles, 16, b, dtype=torch.int32, device="cuda")
            row = {"dtype": dtype, "B": b}
            for name in names:
                nc = SA.stage_a_query_chunk(D, b, emb.dtype)
                nc = min(nc, 64) if name == "chunk64" else nc
                row[f"{name}_ms"] = _time(torch, libs[name], dtype, emb, valid, qv, nc, ws,
                                          out_s, out_i)
            print(json.dumps(row), flush=True)
    return 0


def _time(torch, lib, dtype, emb, valid, qv, nc, ws, out_s, out_i) -> float:
    """Median of REPS CUDA-event times of one launch, in chunks of nc
    queries, behind the spin."""
    fn = lib.rrt_stage_a_wgmma if dtype == "bfloat16" else lib.rrt_stage_a_tf32
    stream = torch.cuda.current_stream().cuda_stream
    b = qv.shape[0]
    run = lambda: fn(emb.data_ptr(), valid.data_ptr(), qv.data_ptr(), ws.data_ptr(),
                     out_s.data_ptr(), out_i.data_ptr(), N, D, b, nc, stream)
    for _ in range(3):
        if run() != 0:
            raise RuntimeError(f"{dtype}: launch failed at B={b}")
    times = []
    for _ in range(REPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


if __name__ == "__main__":
    sys.exit(main())
