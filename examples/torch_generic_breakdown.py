#!/usr/bin/env python3
"""Where the generic attention kernel (csrc/mha_generic.cu) spends its time,
and what the f32 route's accumulators do to its accuracy, on the card: the
kernel against copies with parts taken out or changed.

    python3 examples/torch_generic_breakdown.py

Each copy is made from the source by text edits (the script finds its
places by text and fails loudly when they move), built with nvcc into
build/generic_breakdown/ and loaded on its own:

  full             the kernel as it is
  no_loads         the next key tile is never copied: the ring's copies go
                   (results wrong; the time without the loads)
  no_split         f32: the landed tiles are not split into hi and lo
                   (results wrong; the time without the split pass; above
                   128 columns Q's k-steps are still split in registers)
  one_accumulator  f32: lo*hi, hi*lo and hi*hi of Q K^T (up to 128
                   columns), and of a tile's P V, summed in one accumulator
                   each, small terms first
  exp_ieee         bf16/f16: the exponentials by expf and the division by
                   the row sum an IEEE one, as the f32 route and the plain
                   version take them, not ex2.approx and a multiply
  one_warpgroup    above DP = 128: one warpgroup of 64 query rows a CTA,
                   each CTA copying (f32: and splitting) every key tile
                   itself (timed at the D = 192 and 256 shapes only)

Lines, after the card's name and power limit:

  registers  each copy's registers a thread and spill stores in bytes,
             per instance (ptxas -v)
  time       per copy and shape, the median of 50 CUDA-event times of one
             launch queued behind a 0.1 ms device spin, and the largest
             error against mha_reference, at (64, 512, 12, 32) and (64, 512,
             12, 64) in f32, (64, 512, 12, 26) and (64, 512, 12, 50) in
             bf16, bf16 at 2 heads of 192, (64, 512, 2, 192) and (32, 128,
             2, 192), and f32 at (64, 512, 2, 192) and (64, 512, 1, 256)
             (chip_smoke.py's _attn_inputs: seeded normal q,
             k, v, random lengths, an all-masked row)
  accuracy   for full and one_accumulator: chip_smoke.py phase 20's f32
             bge-small (seed 1) and its 20 queries. The query vectors
             against reference attention (largest and mean difference, and
             the elements whose bf16 rounding differs: the engine rounds a
             query to its bf16 corpus), then run_search at rerank_k 0 on
             phase 4's 200k corpus against reference attention (phase 20's
             cross-check: its largest _final difference, or its failure)

Needs one NVIDIA Hopper GPU with nvcc (~1 min).
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SRC = ROOT / "review_recommender_tpu_torch" / "csrc" / "mha_generic.cu"
OUT = ROOT / "build" / "generic_breakdown"
SHAPES = [(64, 512, 12, 32, "float32"), (64, 512, 12, 64, "float32"),
          (64, 512, 12, 26, "bfloat16"), (64, 512, 12, 50, "bfloat16"),
          (64, 512, 2, 192, "bfloat16"), (32, 128, 2, 192, "bfloat16"),
          (64, 512, 2, 192, "float32"), (64, 512, 1, 256, "float32")]
REPS, SPIN_CYCLES = 50, 200_000
DTYPE_CODE = {"bfloat16": 0, "float16": 1, "float32": 2}


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SRC.name} changed: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def variants() -> dict:
    src = SRC.read_text()
    no_split = _sub(src, "  for (int off = 16 * tid; off < N; off += 16 * kThreads) {",
                    "  for (int off = 16 * tid; off < 0; off += 16 * kThreads) {")
    one = src
    for old, new in (
            ("        wgmma_ss_tf32(s, smem_desc(base + P::kQ + 256 * j, 128, P::kGroup),\n"
             "                      smem_desc(kt + 256 * j, 128, P::kGroup), j > 0);",
             "        wgmma_ss_tf32(s, smem_desc(base + P::kQ + 256 * j, 128, P::kGroup),\n"
             "                      smem_desc(kt + 256 * j, 128, P::kGroup), 1);"),
            ("        wgmma_ss_tf32(s_lo, smem_desc(base + P::kQlo",
             "        wgmma_ss_tf32(s, smem_desc(base + P::kQlo"),
            ("        wgmma_ss_tf32(s_lo, smem_desc(base + P::kQ + 256 * j",
             "        wgmma_ss_tf32(s, smem_desc(base + P::kQ + 256 * j"),
            ("      wgmma_commit();\n      wgmma_wait_all();\n      fence_regs(s_lo);\n"
             "      fence_regs(s);\n#pragma unroll\n"
             "      for (int i = 0; i < BK / 2; ++i) s[i] += s_lo[i];",
             "      wgmma_commit();\n      wgmma_wait_all();\n      fence_regs(s);"),
            ("            wgmma_rs_tf32(pv, a, smem_desc(vc + 256 * j, 128, kVtGroup), j > 0);",
             "            wgmma_rs_tf32(pv, a, smem_desc(vc + 256 * j, 128, kVtGroup));"),
            ("            wgmma_rs_tf32(pv_lo, a, smem_desc(vc + 256 * j, 128, kVtGroup), j > 0);",
             "            wgmma_rs_tf32(pv, a, smem_desc(vc + 256 * j, 128, kVtGroup), j > 0);"),
            ("            wgmma_rs_tf32(pv_lo, a, smem_desc(vlc + 256 * j",
             "            wgmma_rs_tf32(pv, a, smem_desc(vlc + 256 * j")):
        one = _sub(one, old, new)
    for i in range(4):
        one = _sub(one, f"pv[4 * i + {i}] + pv_lo[4 * i + {i}]", f"pv[4 * i + {i}]")
    one = _sub(one, "          fence_regs(pv_lo);\n", "")
    ieee = _sub(src, "  else return ex2_approx(x);", "  else return expf(x * 0.6931471805599453f);")
    for e, (m, inv, l) in enumerate((("m0", "i0", "l0"),) * 2 + (("m1", "i1", "l1"),) * 2):
        ieee = _sub(ieee, f"exp_<kTF32>(s[4 * i + {e}] - {m}) * {inv}",
                    f"__fdiv_rn(exp_<kTF32>(s[4 * i + {e}] - {m}), {l})")
    return {"full": src,
            "no_loads": _sub(src, "    if (u + kStages - 1 < nsteps) load_step(u + kStages - 1);",
                             "    if (u + kStages - 1 < 0) load_step(u + kStages - 1);"),
            "no_split": no_split, "one_accumulator": one, "exp_ieee": ieee,
            "one_warpgroup": _sub(src, "  static constexpr int WG = kWide || kSplitQ ? 2 : 1;",
                                  "  static constexpr int WG = 1;")}


def build(texts: dict) -> dict:
    """One nvcc per copy, all started together; prints each copy's registers
    and returns the loaded libraries."""
    from review_recommender_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs, entry, spill = {}, None, 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and "mha_tc_kernel" in entry:
                t = "f32" if "IfLi" in entry else ("bf16" if "bfloat16" in entry else "f16")
                regs[f"{t} DP={re.search(r'Li(\d+)E', entry).group(1)}"] = [int(m.group(1)), spill]
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rrt_mha_generic.argtypes = [I, P, P, P, P, P, I, I, I, I, P]
        lib.rrt_mha_generic.restype = I
        libs[name] = lib
    return libs


def _launch(torch, lib, q, k, v, bias, h):
    b, s, hd = q.shape
    out = torch.empty_like(q)
    err = lib.rrt_mha_generic(DTYPE_CODE[str(q.dtype).split(".")[1]], q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, h, hd // h,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rrt_mha_generic: cudaError {err}")
    return out


def _median_ms(torch, fn) -> float:
    times = []
    for _ in range(REPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("breakdown_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _accuracy(torch, cs, libs: dict) -> None:
    """Phase 20's f32 bi-encoder setting under each library in `libs`."""
    from review_recommender_tpu_torch import kernels
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.encoder import BiEncoder

    products = synth_product_index(cs.N_DOCS, cs.DIM, cs.VOCAB, cs.TERMS, seed=0,
                                   text_chars=cs.TEXT_CHARS)
    queries = cs._queries(cs.GENERIC_QUERIES, cs.DIM, cs.VOCAB)
    be = BiEncoder.random_init(BertConfig.bge_small(), seed=1, device="cuda", dtype=torch.float32)
    engine = SearchEngine(IndexBundle(products=products), device="cuda", query_encoder=be)
    be.set_attn_impl("reference")
    ref_q = np.stack([engine.encode_query(q) for q in queries])
    ref_rows = [engine.run_search(q, k=cs.K, rerank_k=0)[0] for q in queries]
    be.set_attn_impl("auto")
    load = kernels.load
    try:
        for name, lib in libs.items():
            kernels.load = lambda lib=lib: lib
            got_q = np.stack([engine.encode_query(q) for q in queries])
            flips = int((torch.from_numpy(got_q).bfloat16()
                         != torch.from_numpy(ref_q).bfloat16()).sum())
            rows = [engine.run_search(q, k=cs.K, rerank_k=0)[0] for q in queries]
            try:
                check = cs._crosscheck(rows, ref_rows, f"breakdown_{name}", tol=cs.F32_FINAL_TOL,
                                       by_rank=True)
                verdict = {"max_final_diff": check["max_final_diff"], "passed": True}
            except cs.PhaseError as exc:
                verdict = {"passed": False, "error": str(exc)}
            print(json.dumps({"accuracy": name, "query_max_abs_diff": float(np.abs(got_q - ref_q).max()),
                              "query_mean_abs_diff": float(np.abs(got_q - ref_q).mean()),
                              "bf16_flips": flips, "elements": int(ref_q.size), **verdict}),
                  flush=True)
    finally:
        kernels.load = load


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_generic_breakdown: needs a CUDA GPU", file=sys.stderr)
        return 1
    from review_recommender_tpu_torch.ops import attention as A

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    libs = build(variants())
    cs = _chip_smoke()
    for i, (b, s, h, d, dtype_name) in enumerate(SHAPES):
        dtype = getattr(torch, dtype_name)
        q, k, v, bias = cs._attn_inputs(torch, 200 + i, b, s, h, d, dtype)
        with torch.inference_mode():
            ref = A.mha_reference(q, k, v, bias, h).float()
            for name, lib in libs.items():
                if dtype == torch.float32 and name == "exp_ieee":
                    continue  # the f32 route takes expf and IEEE divisions already
                if dtype != torch.float32 and name in ("no_split", "one_accumulator"):
                    continue  # f32 only
                if name == "one_warpgroup" and d <= 128:
                    continue  # the same kernel as full at these widths
                run = lambda: _launch(torch, lib, q, k, v, bias, h)
                err = float((run().float() - ref).abs().max())
                for _ in range(3):
                    run()
                print(json.dumps({"variant": name, "B": b, "S": s, "H": h, "D": d,
                                  "dtype": dtype_name, "device_ms": _median_ms(torch, run),
                                  "max_abs_err": err, "reps": REPS}), flush=True)
    _accuracy(torch, cs, {n: libs[n] for n in ("full", "one_accumulator")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
