#!/usr/bin/env python3
"""Where the stage-A tile pass spends its time on the card: the kernel of
csrc/stage_a_wgmma.cu against copies with parts taken out.

    python3 examples/torch_stage_a_breakdown.py

Each copy is made from the source by text edits (the script finds its
places by text and fails loudly when they move), built with nvcc into
build/stage_a_breakdown/ and loaded on its own:

  full        the kernel as it is
  no_select   the selection warps read each slab's scores and hand the
              buffer back, but append nothing (no lists, no pruning)
  loads_only  no_select without the wgmmas: the TMA stream and the
              handshakes alone, the floor of this structure
  chunk64     chunks of at most 64 queries (B = 128 runs as two chunks,
              reading the corpus twice)

On one 200,704 x 384 bf16 corpus of unit rows drawn on the card from a
seeded torch.Generator (3% invalid), at B = 1, 8, 32 and 128 seeded unit
queries (the inputs of examples/torch_attention_ab.py --kernel stage_a):
one JSON line per B with each copy's median of 50 CUDA-event times, each
launch queued behind a 0.1 ms device spin. The first line has the card's
name and power limit. Needs one NVIDIA Hopper GPU with nvcc (~30 s).
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
MMA = "          Wgmma<NC>::mma(acc, desc_sw128(a + kk * 32), desc_sw128(bq + kk * 32), (x | kk) != 0);"


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SRC.name} changed: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def variants() -> dict:
    src = SRC.read_text()
    no_select = _sub(src, "        const bool pass = j < nq && sc[m][h] >= t;",
                     "        const bool pass = j < 0 && sc[m][h] >= t;")
    return {
        "full": src,
        "no_select": no_select,
        "loads_only": _sub(no_select, MMA, MMA.replace("Wgmma", "if (kk < 0) Wgmma")),
        "chunk64": _sub(src, "  while (nc < 128 && nc < b) nc *= 2;",
                        "  while (nc < 64 && nc < b) nc *= 2;"),
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
        lib.rrt_stage_a_wgmma.argtypes = [P, P, P, P, P, I, I, I, P]
        lib.rrt_stage_a_wgmma.restype = I
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
    emb = torch.randn(N, D, generator=g, device="cuda")
    emb = (emb / emb.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    valid = torch.rand(N, generator=g, device="cuda") >= 0.03
    rng = np.random.default_rng(601)
    tiles = -(-N // 2048)
    for b in BATCHES:
        q = rng.standard_normal((b, D)).astype(np.float32)
        qv = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).cuda()
        out_s = torch.empty(tiles, 16, b, device="cuda")
        out_i = torch.empty(tiles, 16, b, dtype=torch.int32, device="cuda")
        row = {"B": b}
        for name, lib in libs.items():
            stream = torch.cuda.current_stream().cuda_stream
            run = lambda: lib.rrt_stage_a_wgmma(emb.data_ptr(), valid.data_ptr(), qv.data_ptr(),
                                                out_s.data_ptr(), out_i.data_ptr(), N, D, b,
                                                stream)
            for _ in range(3):
                if run() != 0:
                    raise RuntimeError(f"{name}: launch failed at B={b}")
            times = []
            for _ in range(REPS):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda._sleep(SPIN_CYCLES)
                e0.record()
                run()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            row[f"{name}_ms"] = float(np.median(times))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
