#!/usr/bin/env python3
"""The attention backward kernel (csrc/mha_bwd.cu) on the card: its
registers, its gradients against the plain versions at the trainers'
shapes and at the edge cases, and its time beside the recompute it
replaced and SDPA's backward.

    python3 examples/torch_attention_backward.py [--no-time]

Lines, after the card's name and power limit:

  registers  per kernel instance of csrc/mha_bwd.cu: registers a thread,
             spill stores and loads, shared memory (nvcc -Xptxas -v)
  check      per case (dtype, B, S, H, D, masks): the kernel's dq, dk, dv
             against mha_backward_reference and against autograd through
             mha_reference on the same CUDA tensors, as the largest error
             over max(1, max |ref|) (limits 2e-2 in bf16/f16, 1e-4 in f32),
             the route, one launch of it, and whether two launches are
             bit-equal; then, at the trainers' shapes, how far Delta =
             rowsum(dO * O) (the forward's output in bf16) lies from
             autograd's sum_k P dP (P in f32, dP rounded to bf16), the
             shortcut the kernel does not take
  time       chip_smoke.py phase 15's rows (its _training_kernel_rows): at
             the trainers' four shapes in bf16, medians of 50 CUDA-event
             times behind a 0.1 ms device spin of the forward and the
             backward kernel (backward_ms) beside the recompute it
             replaced (plain_backward_ms), SDPA's forward and backward
             (library_backward_ms) and the bounds

Exits non-zero if a check fails. Needs one NVIDIA Hopper GPU with nvcc.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SRC = ROOT / "review_recommender_tpu_torch" / "csrc" / "mha_bwd.cu"


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location("bwd_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
# (dtype, B, S, H, D): the trainers' shapes in bf16, TinyBERT's D = 26, the
# pad edges of D on both routes, S at and around the 64-row tiles and past
# 512 keys
CASES = ([("bfloat16", *s) for s in CS.TRAIN_SHAPES]
         + [("float16", 4, 65, 2, 64), ("bfloat16", 4, 70, 12, 26), ("float32", 8, 128, 12, 32),
            ("float32", 2, 600, 4, 16), ("bfloat16", 2, 1, 2, 1), ("bfloat16", 3, 63, 2, 15),
            ("float16", 3, 129, 2, 17), ("bfloat16", 2, 600, 1, 31), ("float16", 2, 64, 2, 33),
            ("bfloat16", 2, 1024, 2, 127), ("float16", 2, 65, 1, 129), ("bfloat16", 2, 129, 1, 256),
            ("float32", 3, 65, 2, 1), ("float32", 2, 129, 1, 256), ("float32", 2, 1024, 1, 33)])
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}


def registers() -> list:
    from review_recommender_tpu_torch import kernels

    out = ROOT / "build" / "attention_backward"
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                           str(SRC), "-o", str(out / "mha_bwd.o")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    rows, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and name:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def _inputs(torch, seed, b, s, h, d, dtype):
    """chip_smoke.py's _attn_inputs and a random upstream gradient: seeded
    normal q, k, v, random key lengths, the last row all masked, row 0
    masked but for one key."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
                  .to("cuda", dtype) for _ in range(4))
    lens = rng.integers(1, s + 1, size=b)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
    if b > 1:
        bias[-1] = -1e30
        bias[0] = -1e30
        bias[0, min(1, s - 1)] = 0.0
    return q, k, v, torch.from_numpy(bias).to("cuda"), g


def check(torch, case) -> dict:
    from review_recommender_tpu_torch.ops import attention as A

    name, b, s, h, d = case
    dtype = getattr(torch, name)
    q, k, v, bias, g = _inputs(torch, b * s + d, b, s, h, d, dtype)
    route = A.backward_route(dtype, d, s)
    counter = "mha_backward_kernel_launches" if route == "wgmma" else "mha_backward_fma_launches"
    before = getattr(A, counter)
    got = A._launch_bwd(q, k, v, bias, g, h)
    again = A._launch_bwd(q, k, v, bias, g, h)
    torch.cuda.synchronize()
    launches = getattr(A, counter) - before
    plain = A.mha_backward_reference(q, k, v, bias, g, h)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        auto = torch.autograd.grad(A.mha_reference(*leaves, bias, h), leaves, g)
    row = {"dtype": name, "B": b, "S": s, "H": h, "D": d, "route": route, "launches": launches,
           "bit_equal_twice": all(torch.equal(x, y) for x, y in zip(got, again))}
    ok = launches == 2 and row["bit_equal_twice"]
    for ref_name, refs in (("plain", plain), ("autograd", auto)):
        for t, x, r in zip("qkv", got, refs):
            r = r.float()
            err = float((x.float() - r).abs().max()) / max(1.0, float(r.abs().max()))
            finite = bool(torch.isfinite(x.float()).all())
            row[f"{ref_name}_d{t}"] = err
            ok = ok and finite and err <= TOL[name]
    row["ok"] = ok
    return row


def delta_rows(torch) -> list:
    """Delta = rowsum(dO * O) from the bf16 output against autograd's sum_k
    P dP (P in f32, dP rounded to the input type), at the trainers' bf16
    shapes: the largest difference and the largest |Delta|."""
    from review_recommender_tpu_torch.ops import attention as A

    rows = []
    for b, s, h, d in CS.TRAIN_SHAPES:
        q, k, v, bias, g = _inputs(torch, b + s, b, s, h, d, torch.bfloat16)
        split = lambda t: t.reshape(b, s, h, d).float()
        out = A.mha_reference(q, k, v, bias, h)
        p = A._probs(split(q), split(k), bias, d)
        dp = torch.einsum("bqhd,bkhd->bhqk", split(g), split(v)).bfloat16().float()
        auto = (p * dp).sum(-1)
        mine = (split(g) * split(out)).sum(-1).transpose(1, 2)
        rows.append({"B": b, "S": s, "H": h, "D": d,
                     "max_abs_diff": float((auto - mine).abs().max()),
                     "max_abs_delta": float(auto.abs().max())})
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-time", action="store_true", help="checks only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    for row in registers():
        print(json.dumps({"registers": row}), flush=True)
    failed = 0
    for case in CASES:
        row = check(torch, case)
        failed += not row["ok"]
        print(json.dumps({"check": row}), flush=True)
    for row in delta_rows(torch):
        print(json.dumps({"delta": row}), flush=True)
    if not args.no_time:
        for row in CS._training_kernel_rows(torch):
            print(json.dumps({"time": row}), flush=True)
    print(json.dumps({"failed_checks": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
