#!/usr/bin/env python3
"""The attention backward kernels (csrc/mha_bwd.cu; past 256 columns
csrc/mha_wide_bwd.cu, and csrc/mha_wide_f32.cu in f32) on the card: their registers, their gradients
against the plain versions at the trainers' shapes and at the edge cases,
their time beside the recompute they replaced and SDPA's backward, where
the time goes, and an A/B against another checkout's kernel.

    python3 examples/torch_attention_backward.py [--no-time] [--breakdown]
        [--parent ROOT] [--sass]

Lines, after the card's name and power limit:

  registers  per kernel instance of csrc/mha_bwd.cu: registers a thread,
             spill stores and loads, stack frame, shared memory (nvcc
             -Xptxas -v), and any ptxas warning about wgmma
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
             (library_backward_ms) and the bounds; then phase 19's f32 row
             at a tp shard's (32, 128, 6, 32)
  breakdown  (--breakdown [NAMES]) copies of csrc/mha_bwd.cu made by text
             edits (the script finds its places by text and fails loudly
             when they move), built into build/attention_backward/, each
             timed through its own rrt_mha_bwd (the inputs of the time
             lines): device ms behind a spin, each kernel's device µs from
             a torch.profiler window, host µs a call. bf16 copies at the
             trainers' four shapes and at 2 heads of 192 ((32, 128, 2, 192),
             (64, 512, 2, 192)), f32 ones at the tp shard's, wide ones at f32
             (64, 512, 2, 192) and (64, 512, 1, 256), "full" at all nine. A
             name is "full" or edits joined by "+"; the
             knobs (csrc/mha_bwd.cu's constexprs) and the parts taken out:
               no_overlap     bf16: kernel A waits on dP before its work on
                              S, kernel B on both halves' products before
                              the first half's work
               min1           bf16 kernel A with no register cap
               a_min5, b_min5 bf16 kernel A / B capped for 5 CTAs an SM up
                              to DP = 32; b_min1 kernel B with no cap
               no_pdl         kernel B launched after kernel A completes
                              (no programmatic dependent launch)
               no_exp         ex2.approx replaced by its argument
               softmax_only   the bf16 products out: no wgmma
               no_loads       the bf16 rings' copies of the next tiles out
               a_only         kernel A alone; kernel B's time is full less
                              a_only
               one_warpgroup  bf16 above DP = 128: one warpgroup a CTA in
                              both kernels, each copying its ring's tiles
               f32_a_min1     f32 kernel A with no register cap
               f32_b_min4     f32 kernel B for 4 CTAs an SM up to DP = 32
               f32_roll       the f32 S / dP k-step loops not unrolled
               f32_lo_trunc   the split's lo fed to the tensor cores
                              unrounded (they drop its low 13 bits)
               f32_a_bt16     f32 kernel A's key tiles at 16 rows
               f32_b_bt32     f32 kernel B's query tiles at 32 rows
               f32_no_lo      3xTF32 down to its hi*hi products
               f32_no_split   the landed f32 tiles not split into hi, lo
               f32_no_loads   the f32 rings' copies of the next tiles out
               f32_prof       the f32 kernels with clock64 stamps: a "prof"
                              line with each kernel's cycles a CTA in each
                              phase of its steps (waits and barriers,
                              copies, split, products, the rest)
               wide_no_loads  f32 above 128 columns: the rings' copies of
                              the next tiles out
               wide_no_split  f32 above 128 columns: the landed tiles not
                              split (the 64-row tiles' k-steps still are)
               wide_no_sdp    f32 above 128 columns: no S / dP (S^T / dP^T)
                              products, their accumulators zero
               wide_no_grad   f32 above 128 columns: no X, Y (dK, dV)
                              products
               wide_a_only    f32 above 128 columns: kernel A alone
               wide_kc1, wide_kc4  f32 above 128 columns: one or four
                              k-steps a commit group of the split products
                              (two in the kernel)
             and a copy of csrc/mha_wide_bwd.cu (D > 256, bf16/f16)
             through its own rrt_mha_wide_bwd at one head of 384 ((64,
             512, 1, 384), the work of (64, 512, 2, 192)) in bf16, its
             four kernels' device µs apart (wide_score, wide_dp, wide_dq,
             wide_dkv):
               widebwd_full      the source as it is
             and copies of csrc/mha_wide_f32.cu (D > 256, f32), each through
             its own rrt_mha_wide_f32_bwd at (64, 512, 1, 384), its kernels'
             device µs apart (f32_transpose, f32_score_0, f32_score_1,
             f32_product_1, f32_product_2):
               widef32_full      the source as it is
               widef32_no_loads  the producer's boxes past the ring's first
                              fill not loaded (each stage handed over
                              as it stands)
               widef32_no_split  the landed B boxes' lo not formed
               widef32_no_lo     3xTF32 down to its hi*hi products
               widef32_no_mma    no products at all (loads, splits,
                              softmax and stores alone)
             (every edit but the knobs leaves the results wrong)
  sass       (--sass) static SASS instructions per kernel by opcode
             (cuobjdump -sass of the "full" copy)
  ab         (--parent ROOT) ROOT's csrc/mha_bwd.cu (another checkout,
             e.g. the parent unpacked by git archive into build/) built
             beside this one's, both through rrt_mha_bwd on the same
             inputs in the order parent, change, change, parent at the four
             bf16 shapes and the f32 tp shape: each run's median device ms
             and the mean of each side

Exits non-zero if a check fails. Needs one NVIDIA Hopper GPU with nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = Path("review_recommender_tpu_torch") / "csrc" / "mha_bwd.cu"
SRC = ROOT / CSRC
WIDE_SRC = ROOT / "review_recommender_tpu_torch" / "csrc" / "mha_wide_bwd.cu"
F32_SRC = ROOT / "review_recommender_tpu_torch" / "csrc" / "mha_wide_f32.cu"
OUT = ROOT / "build" / "attention_backward"


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
            ("float32", 3, 65, 2, 1), ("float32", 2, 129, 1, 256), ("float32", 2, 1024, 1, 33),
            ("float32", 4, 200, 2, 128), ("float32", 2, 300, 3, 64),
            ("float32", 2, 1, 1, 129), ("float32", 4, 70, 2, 192), ("float32", 3, 40, 1, 256),
            ("float32", 2, 300, 1, 193), ("float32", 2, 1024, 1, 200),
            # past 256 columns: csrc/mha_wide_bwd.cu
            ("bfloat16", 2, 130, 1, 384), ("float16", 3, 65, 2, 257), ("float32", 2, 130, 1, 384),
            ("float32", 2, 63, 1, 1024), ("bfloat16", 2, 513, 1, 512)])
# bf16 at 2 heads of 192, past the 128 columns of one warpgroup's tiles:
# phase 19 (g)'s shape and the rerank batch's
WIDE_SHAPES = [(32, 128, 2, 192), (64, 512, 2, 192)]
# f32 above 128 columns: the rerank batch at 2 heads of 192 and at one of 256
F32_WIDE_SHAPES = [(64, 512, 2, 192), (64, 512, 1, 256)]
# past 256 columns (the widebwd copies): one head of 384, both types
WIDE384_SHAPE = (64, 512, 1, 384)
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
DTYPE_CODE = {"bfloat16": 0, "float16": 1, "float32": 2}
REPS, SPIN_CYCLES = 50, 200_000


def _ptxas_rows(log: str) -> list:
    """Per kernel entry in nvcc -Xptxas -v output: registers, spills, stack
    frame, shared memory; and ptxas's warnings about wgmma."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows.append({"kernel": name})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
        if "wgmma" in line and ("warning" in line.lower() or "serialized" in line):
            rows.append({"ptxas_warning": line.strip()})
    return rows


SECTIONS = {"tc": ("// ---- the tensor-core route", "// ---- the 3xTF32 route: f32 at D <= 128"),
            "tf32": ("// ---- the 3xTF32 route: f32 at D <= 128",
                     "// ---- the 3xTF32 route above 128 columns"),
            "wide": ("// ---- the 3xTF32 route above 128 columns", "// ---- launches"),
            "launch_tc": ("cudaError_t launch_tc(", "cudaError_t launch_tf32(")}


def _sub(text: str, old: str, new: str, section: str = None) -> str:
    """text with `old` replaced by `new`, where `old` occurs once (in
    SECTIONS[section] when given); raises if the source moved."""
    lo, hi = 0, len(text)
    if section:
        lo, hi = text.index(SECTIONS[section][0]), text.index(SECTIONS[section][1])
    part = text[lo:hi]
    if part.count(old) != 1:
        raise RuntimeError(f"{SRC.name} changed: {old!r} found {part.count(old)} times")
    return text[:lo] + part.replace(old, new) + text[hi:]


def _knob(old: str, new: str):
    return lambda src: _sub(src, old, new)


def _no_exp(src: str) -> str:
    """ex2.approx replaced by its argument (results wrong)."""
    return _sub(src, '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "  y = x;")


def _softmax_only(src: str) -> str:
    src = _sub(src, "    wgmma_ss_bf16(d, da, db, acc);\n", "")
    return _sub(src, "    wgmma_rs_bf16(d, a, db);\n", "")


def _no_loads(src: str) -> str:
    old, new = "    if (u + 1 < {}) load_step(u + 1);", "    if (u + 1 < 0) load_step(u + 1);"
    return _sub(_sub(src, old.format("nsteps"), new, "tc"), old.format("ntiles"), new, "tc")


def _a_only(src: str) -> str:
    old = "  return launch_after(kb, grid_b, kThreads * P::WGB, P::kBytesB, a.stream,"
    return _sub(src, old, "  if (a.B > 0) return cudaGetLastError();\n" + old, "launch_tc")


def _one_warpgroup(src: str) -> str:
    """bf16/f16 above DP = 128: one warpgroup a CTA in both kernels, each
    CTA copying every tile of its ring itself."""
    src = _sub(src, "  static constexpr int WGA = DP > 128 ? 2 : 1;", "  static constexpr int WGA = 1;")
    return _sub(src, "  static constexpr int WGB = DP > 128 && 4 * kTile + kStages * kStageB <= 232448"
                " ? 2 : 1;", "  static constexpr int WGB = 1;")


def _f32_no_lo(src: str) -> str:
    """3xTF32 down to its hi*hi products (results less exact)."""
    for old in ("wgmma_ss_tf32(x_lo, dal + 16 * j, db + 16 * j, j > 0);",
                "wgmma_ss_tf32(x_lo, da + 16 * j, dbl + 16 * j, 1);",
                "    wgmma_rs_tf32(acc_lo, a, db + 16 * j);",
                "    wgmma_rs_tf32(acc_lo, a, dbl + 16 * j);"):
        src = _sub(src, old, ";")
    return src


def _f32_no_split(src: str) -> str:
    return _sub(src, "  for (int off = 16 * tid; off < kBytes; off += 16 * kThreads) {",
                "  for (int off = 16 * tid; off < 0; off += 16 * kThreads) {")


def _replace_n(src: str, old: str, new: str, n: int, section: str = "tf32") -> str:
    """_sub for an `old` that occurs exactly n times in the section."""
    lo, hi = src.index(SECTIONS[section][0]), src.index(SECTIONS[section][1])
    if src[lo:hi].count(old) != n:
        raise RuntimeError(f"{SRC.name} changed: {old!r} not found {n} times")
    return src[:lo] + src[lo:hi].replace(old, new) + src[hi:]


def _f32_no_loads(src: str) -> str:
    return _replace_n(src, "    if (u + 1 < ntiles) load_step(u + 1);",
                      "    if (u + 1 < 0) load_step(u + 1);", 2)


WIDE_FAKE_SPLIT = """
template <int DP, int KC, int N>
__device__ __forceinline__ void no_products(float (&x)[N], float (&x_lo)[N], const unsigned char*,
                                            uint64_t, uint64_t, int) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x_lo[i] = 0.f;
}
"""


def _wide_no_sdp(src: str) -> str:
    """f32 above DP = 128: S and dP (S^T and dP^T) not multiplied, their
    accumulators zero (results wrong; the time of the rest)."""
    src = _sub(src, '#include "tf32_wgmma.cuh"\n', '#include "tf32_wgmma.cuh"\n' + WIDE_FAKE_SPLIT)
    return _replace_n(src, "tf32_rs3_split<DP, kSplitSteps>(", "no_products<DP, kSplitSteps>(",
                      2, "wide")


def _f32_roll(src: str) -> str:
    old = "#pragma unroll\n  for (int j = 0; j < DP / 8; ++j) wgmma_ss_tf32("
    return _replace_n(src, old, old.replace("unroll", "unroll 1"), 3)


PROF_PHASES = ["wait_barrier", "copies", "split", "fence_barrier", "products_issue", "rest",
               "wait_s"]


def _f32_prof(src: str) -> str:
    """The f32 kernels with clock64 stamps: per phase of a step, cycles
    summed over the steps of thread 0 of every CTA, added into g_prof
    (kernel A at 0, B at 16; the CTA count at 8 and 24), read by
    rrt_prof_read and cleared by rrt_prof_reset."""
    def tick(i):
        return f"    {{ const long long n_ = clock64(); pf[{i}] += n_ - pt; pt = n_; }}\n"

    def flush(at):
        return ("  if (threadIdx.x == 0) {\n    for (int i_ = 0; i_ < 8; ++i_)\n"
                f"      atomicAdd(&g_prof[{at} + i_], (unsigned long long)pf[i_]);\n"
                f"    atomicAdd(&g_prof[{at} + 8], 1ull);\n  }}\n")

    def mark(src, anchor, before="", after=""):
        return _sub(src, anchor, before + anchor + after, "tf32")

    decl = "  long long pf[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long pt = clock64();\n"
    src = _sub(src, "namespace {\n",
               "__device__ unsigned long long g_prof[32];\n"
               'extern "C" int rrt_prof_read(void* out) {\n'
               "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n"
               'extern "C" int rrt_prof_reset() {\n  unsigned long long z[32] = {};\n'
               "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n\nnamespace {\n")
    wait_bar = "    cp_async_wait<0>();\n    fence_async_smem();\n    __syncthreads();"
    # kernel A
    src = mark(src, "  allow_dependent_launch();\n", after=decl)
    src = mark(src, wait_bar + "  // tile u is in; every thread is done with tile u - 1\n",
               before=tick(5), after=tick(0))
    src = mark(src, "    if (u + 1 < ntiles) load_step(u + 1);\n    cp_async_commit();\n"
               "    const int st_off = P::kStage0 + (u % kRingTf32) * P::kStageA;\n", after=tick(1))
    src = mark(src, "    fence_async_smem();\n    __syncthreads();  // hi and lo of this tile are stored\n",
               before=tick(2), after=tick(3))
    src = mark(src, "base + st_off + P::kTile, base + kVlo);\n    wgmma_commit();\n", after=tick(4))
    src = mark(src, "    wgmma_wait<1>();\n    fence_regs(s);\n    fence_regs(s_lo);\n\n    // logits",
               before=tick(6))
    src = mark(src, "  // the row sums, Delta = sum_k P dP, and dQ", before=tick(5) + flush(0))
    # kernel B
    src = mark(src, "acc_v[i] = acc_v_lo[i] = acc_k[i] = acc_k_lo[i] = 0.f;\n", after=decl)
    load_b = ("\n    if (u + 1 < ntiles) load_step(u + 1);\n    cp_async_commit();\n"
              "    const int st_off = P::kStage0 + (u % kRingTf32) * P::kStageB;\n")
    src = mark(src, wait_bar + load_b, before=tick(5), after=tick(1))
    src = _sub(src, wait_bar + load_b, wait_bar + "\n" + tick(0) + load_b[1:], "tf32")
    split_b = "                                 tid);\n"
    src = mark(src, split_b + "    fence_async_smem();\n    __syncthreads();\n", after=tick(3))
    src = mark(src, split_b, after=tick(2))
    src = mark(src, "base + kOlo);\n    wgmma_commit();\n", after=tick(4))
    src = mark(src, "    fence_regs(s);\n    fence_regs(s_lo);\n    // P^T, each query column",
               before=tick(6))
    return mark(src, "  // dK = (acc_k + acc_k_lo) * scale,", before=tick(5) + flush(16))


def _no_overlap(src: str) -> str:
    """bf16: kernel A waits on dP before its work on S, kernel B on both
    halves' products before the first half's work."""
    src = _sub(src, "    wgmma_wait<1>();  // S; dP stays in flight", "    wgmma_wait<0>();", "tc")
    old = "      // previous half's dV and dK products (hf = 1)\n      wgmma_wait<1>();"
    return _sub(src, old, old.replace("<1>", "<0>"), "tc")


EDITS = {
    "f32_prof": _f32_prof,
    "no_overlap": _no_overlap,
    "min1": _knob("constexpr int kMinBlocksA = DP <= 64 ? 4 : 1;", "constexpr int kMinBlocksA = 1;"),
    "a_min5": _knob("constexpr int kMinBlocksA = DP <= 64 ? 4 : 1;",
                    "constexpr int kMinBlocksA = DP <= 32 ? 5 : DP <= 64 ? 4 : 1;"),
    "b_min5": _knob("constexpr int kMinBlocksB = DP <= 32 ? 4 : 1;",
                    "constexpr int kMinBlocksB = DP <= 32 ? 5 : 1;"),
    "b_min1": _knob("constexpr int kMinBlocksB = DP <= 32 ? 4 : 1;",
                    "constexpr int kMinBlocksB = 1;"),
    "no_pdl": _knob("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),
    "no_exp": _no_exp, "softmax_only": _softmax_only, "no_loads": _no_loads, "a_only": _a_only,
    "one_warpgroup": _one_warpgroup,
    "f32_a_min1": _knob("constexpr int kMinBlocksTf32A = DP <= 32 ? 3 : 1;",
                        "constexpr int kMinBlocksTf32A = 1;"),
    "f32_b_min4": _knob("constexpr int kMinBlocksTf32B = DP <= 32 ? 3 : 1;",
                        "constexpr int kMinBlocksTf32B = DP <= 32 ? 4 : 1;"),
    "f32_a_bt16": _knob("constexpr int kBtA = DP <= 32 ? 32 : 16;",
                        "constexpr int kBtA = DP == 16 ? 32 : 16;"),
    "f32_b_bt32": _knob("constexpr int kBtB = DP == 16 ? 32 : 16;",
                        "constexpr int kBtB = DP <= 32 ? 32 : 16;"),
    "f32_roll": _f32_roll,
    "f32_lo_trunc": lambda src: _sub(src, "      l[e] = tf32_rna(x[e] - __uint_as_float(h[e]));",
                                     "      l[e] = __float_as_uint(x[e] - __uint_as_float(h[e]));"),
    "f32_no_lo": _f32_no_lo, "f32_no_split": _f32_no_split, "f32_no_loads": _f32_no_loads,
    "wide_no_loads": lambda src: _replace_n(src, "    if (u + 1 < ntiles) load_step(u + 1);",
                                            "    if (u + 1 < 0) load_step(u + 1);", 2, "wide"),
    "wide_no_split": lambda src: _replace_n(src, "      split_rows<BT, DP, DP, ",
                                            "      if (0) split_rows<BT, DP, DP, ", 4, "wide"),
    "wide_no_sdp": _wide_no_sdp,
    "wide_no_grad": lambda src: _replace_n(src, "    tf32_rs3_cols<BT, BT, DP>(",
                                           "    if (0) tf32_rs3_cols<BT, BT, DP>(", 2, "wide"),
    "wide_kc1": _knob("constexpr int kSplitSteps = 2;", "constexpr int kSplitSteps = 1;"),
    "wide_kc4": _knob("constexpr int kSplitSteps = 2;", "constexpr int kSplitSteps = 4;"),
    "wide_a_only": lambda src: _sub(src, "  return launch_after(kb, grid, 2 * kThreads,",
                                    "  if (a.B > 0) return cudaGetLastError();\n"
                                    "  return launch_after(kb, grid, 2 * kThreads,"),
}
BREAKDOWN = ["no_overlap", "no_pdl", "no_exp", "softmax_only", "no_loads", "a_only",
             "a_only+no_loads", "one_warpgroup", "f32_no_lo", "f32_no_split", "f32_no_loads",
             "wide_no_loads", "wide_no_split", "wide_no_sdp", "wide_no_grad", "wide_a_only",
             "widebwd_full",
             "widef32_full", "widef32_no_loads", "widef32_no_split", "widef32_no_lo",
             "widef32_no_mma"]


def _wide_cut(src: str, lines: list, new: str = "") -> str:
    """A wide source with each of `lines` (found exactly once) replaced by
    `new` (taken out by default); raises if the source moved."""
    for line in lines:
        if src.count(line) != 1:
            raise RuntimeError(f"wide source changed: {line!r} found {src.count(line)} times")
        src = src.replace(line, new)
    return src


def _f32_no_loads(src: str) -> str:
    """csrc/mha_wide_f32.cu's producers hand each stage past the ring's
    first fill over without loading it (an arrive in place of the copies)."""
    src = _wide_cut(src, ["        mbar_expect_tx(ring.full(s), 2 * kBox);\n"],
                    "        if (u >= kScoreStages) { mbar_arrive(ring.full(s)); continue; }\n"
                    "        mbar_expect_tx(ring.full(s), 2 * kBox);\n")
    return _wide_cut(src, ["        mbar_expect_tx(ring.full(s), P::kTx);\n"],
                     "        if (u >= P::kStages) { mbar_arrive(ring.full(s)); continue; }\n"
                     "        mbar_expect_tx(ring.full(s), P::kTx);\n")


WIDE_EDITS = {"widebwd_full": lambda src: src}
# csrc/mha_wide_f32.cu's copies
F32_EDITS = {
    "widef32_full": lambda src: src,
    "widef32_no_loads": _f32_no_loads,
    "widef32_no_split": lambda src: _wide_cut(
        src, ["  for (int off = 16 * t; off < kBytes; off += 16 * kSplitters) {\n"],
        "  for (int off = 16 * t; off < 0; off += 16 * kSplitters) {\n"),
    "widef32_no_lo": lambda src: _wide_cut(src, ["  wgmma_rs_tf32(sm, lo, db, scale_d);\n",
                                                 "  wgmma_rs_tf32(sm, hi, dblo, 1);\n"]),
    "widef32_no_mma": lambda src: _wide_cut(src, ["  wgmma_rs_tf32(sm, lo, db, scale_d);\n",
                                                  "  wgmma_rs_tf32(sm, hi, dblo, 1);\n",
                                                  "  wgmma_rs_tf32(hh, hi, db, scale_d);\n"]),
}


def variants(src: str, names: list) -> dict:
    """The breakdown's copies of mha_bwd.cu: each name is "full" or edits
    joined by "+" (e.g. "no_overlap+a_only"); a "widebwd" name is a copy of
    csrc/mha_wide_bwd.cu (WIDE_EDITS)."""
    out = {}
    for name in names:
        if name.startswith("widebwd"):
            out[name] = WIDE_EDITS[name](WIDE_SRC.read_text())
            continue
        if name.startswith("widef32"):
            out[name] = F32_EDITS[name](F32_SRC.read_text())
            continue
        text = src
        if name != "full":
            for edit in name.split("+"):
                text = EDITS[edit](text)
        out[name] = text
    return out


def sass_counts(lib_path: Path) -> dict:
    """Static SASS instructions per kernel of a built library, by opcode
    class (cuobjdump -sass)."""
    from review_recommender_tpu_torch import kernels

    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(mha_bwd_\w+?kernel)I(\w*?)Li(\d+)E", m.group(1))
            name = f"{k.group(1)} {k.group(2)[-6:]} DP={k.group(3)}" if k else None
            if name:
                counts[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            op = m.group(1)
            counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def build(texts: dict, headers: dict = None) -> dict:
    """One nvcc per copy, all started together, each into its own library
    under OUT; returns (ctypes library, ptxas rows) by name. A copy named in
    `headers` is built beside that directory's csrc/*.cuh (another
    checkout's), which its quoted includes then find first."""
    from review_recommender_tpu_torch import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        if name in (headers or {}):
            cu = OUT / name / f"{name}.cu"
            cu.parent.mkdir(exist_ok=True)
            for h in headers[name].glob("*.cuh"):
                (cu.parent / h.name).write_text(h.read_text())
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        if name.startswith("widef32"):
            lib.rrt_mha_wide_f32_bwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
            lib.rrt_mha_wide_f32_bwd.restype = I
            out[name] = (lib, _ptxas_rows(log))
            continue
        if name.startswith("widebwd"):  # its rows' head stride and copy flag beside
            lib.rrt_mha_wide_bwd.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
            lib.rrt_mha_wide_bwd.restype = I
            out[name] = (lib, _ptxas_rows(log))
            continue
        entry = lib.rrt_mha_bwd
        entry.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, P]
        entry.restype = I
        out[name] = (lib, _ptxas_rows(log))
    return out


def _launch(torch, lib, q, k, v, bias, g, h, entry="rrt_mha_bwd"):
    """(dq, dk, dv) from one library's rrt_mha_bwd (or rrt_mha_wide_bwd), as
    ops/attention.py's _launch_bwd calls it."""
    from review_recommender_tpu_torch.ops import attention as A

    b, s, hd = q.shape
    d = hd // h
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    wide = entry == "rrt_mha_wide_bwd"  # rows read in place: head stride d, no copy
    ws = torch.empty(A.wide_workspace_floats(True, b, s, h, d, False) if wide else 3 * b * h * s,
                     dtype=torch.float32, device=q.device)
    err = getattr(lib, entry)(DTYPE_CODE[str(q.dtype).split(".")[1]], q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), bias.data_ptr(), g.data_ptr(), dq.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, s, h, d,
                          *((d, 0) if wide else ()), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: cudaError {err}")
    return dq, dk, dv


def _launch_f32(torch, lib, q, k, v, bias, g, h):
    """(dq, dk, dv) from one library's rrt_mha_wide_f32_bwd, as
    ops/attention.py's _launch_wide calls it (one slice)."""
    from review_recommender_tpu_torch.ops import attention as A

    b, s, hd = q.shape
    d = hd // h
    padded = A._wide_padded(torch.float32, d, q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ws = torch.empty(A.wide_f32_workspace_floats(True, b, s, h, d, padded), device=q.device)
    err = lib.rrt_mha_wide_f32_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                   g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                   ws.data_ptr(), b, s, h, d, int(padded),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rrt_mha_wide_f32_bwd: cudaError {err}")
    return dq, dk, dv


def _timing_inputs(torch, i, b, s, h, d, dtype):
    """_training_kernel_rows' inputs for its i-th shape: seeded normal q,
    k, v and upstream gradient, random key lengths."""
    rng = np.random.default_rng(300 + i)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
                  .to("cuda", dtype) for _ in range(4))
    lens = rng.integers(1, s + 1, size=b)
    bias = torch.from_numpy(np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30)
                            .astype(np.float32)).to("cuda")
    return q, k, v, bias, g


def _device_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    return CS._median_ms(torch, fn, REPS, before=lambda: torch.cuda._sleep(SPIN_CYCLES))


def _timed_shapes(torch):
    """(name, shape, inputs): the trainers' four bf16 shapes (seeds of
    phase 15's rows), bf16 at 2 heads of 192 (WIDE_SHAPES: phase 19 (g)'s
    and the rerank batch's), the f32 tp shard's (phase 19's f32 row) and
    f32 at the wide shapes (F32_WIDE_SHAPES)."""
    rows = [("bfloat16", shape, _timing_inputs(torch, i, *shape, torch.bfloat16))
            for i, shape in enumerate(CS.TRAIN_SHAPES + WIDE_SHAPES)]
    f32 = CS.MESH_SHAPES[0]
    rows.append(("float32", f32, _timing_inputs(torch, 0, *f32, torch.float32)))
    return rows + [("float32", shape, _timing_inputs(torch, i, *shape, torch.float32))
                   for i, shape in enumerate(F32_WIDE_SHAPES)]


def _family(name: str, shape) -> str:
    """The variants a timed shape serves: "wide" (f32 above 128 columns),
    "f32" or "bf16"."""
    return "wide" if name == "float32" and shape[3] > 128 else "f32" if name == "float32" else "bf16"


def _kernel_us(torch, fn, n=20) -> dict:
    """Device µs a call of each csrc/mha_bwd.cu kernel fn launches, from a
    torch.profiler window of n calls (the kernels' own durations: no host
    gap between launches counts)."""
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
        wide = re.search(r"wide_(score|product)_kernel<[^,]+, (\d)", e.key)
        f32 = re.search(r"wide_f32_(\w+?)_kernel(?:<(\d)>)?", e.key)
        m = re.search(r"(mha_bwd_\w*?kernel)", e.key)
        wide_names = {("score", "0"): "wide_score", ("score", "1"): "wide_dp",
                      ("product", "1"): "wide_dq", ("product", "2"): "wide_dkv"}
        name = (wide_names.get(wide.groups()) if wide
                else "f32_" + "_".join(x for x in f32.groups() if x) if f32
                else m.group(1) if m else None)
        if t and name:
            out[name] = out.get(name, 0.0) + t / n
    return out


def _host_us(torch, fn, n=50) -> float:
    """Host µs a call takes to enqueue, over n calls ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _prof_cycles(torch, lib, fn, n=20) -> dict:
    """An f32_prof copy's clock64 phases: cycles a CTA of each kernel spends
    in each phase, summed over its steps, averaged over the CTAs of n calls."""
    lib.rrt_prof_reset.restype = lib.rrt_prof_read.restype = ctypes.c_int
    lib.rrt_prof_read.argtypes = [ctypes.c_void_p]
    torch.cuda.synchronize()
    lib.rrt_prof_reset()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    lib.rrt_prof_read(buf)
    out = {}
    for kern, at in (("A", 0), ("B", 16)):
        ctas = max(1, buf[at + 8])
        out[kern] = {ph: buf[at + i] / ctas for i, ph in enumerate(PROF_PHASES)}
        out[kern]["ctas"] = ctas
    return out


def breakdown(torch, libs: dict) -> None:
    """Each copy at the shapes of its dtype ("f32" copies at the f32 tp
    shape, the others at the four bf16 shapes, "full" at all five): device
    ms behind a spin, each kernel's device µs from the profiler, host µs."""
    for name, shape, (q, k, v, bias, g) in _timed_shapes(torch):
        for variant, (lib, _rows) in libs.items():
            if variant.startswith(("widebwd", "widef32")):
                continue
            fam = variant.split("_")[0] if variant.startswith(("f32", "wide")) else "bf16"
            if variant not in ("full", "parent") and fam != _family(name, shape):
                continue
            fn = lambda lib=lib: _launch(torch, lib, q, k, v, bias, g, shape[2])
            print(json.dumps({"breakdown": variant, "dtype": name, "B": shape[0], "S": shape[1],
                              "H": shape[2], "D": shape[3], "device_ms": _device_ms(torch, fn),
                              "kernel_us": _kernel_us(torch, fn), "host_us": _host_us(torch, fn),
                              "reps": REPS}), flush=True)
            if "prof" in variant:
                print(json.dumps({"prof": variant, "D": shape[3], **_prof_cycles(torch, lib, fn)}),
                      flush=True)
    for name in ("bfloat16", "float32"):  # csrc/mha_wide_bwd.cu's and csrc/mha_wide_f32.cu's copies
        q, k, v, bias, g = _timing_inputs(torch, 0, *WIDE384_SHAPE, getattr(torch, name))
        for variant, (lib, _rows) in libs.items():
            if not variant.startswith("widebwd" if name == "bfloat16" else "widef32"):
                continue
            fn = (lambda lib=lib: _launch(torch, lib, q, k, v, bias, g, WIDE384_SHAPE[2],
                                          entry="rrt_mha_wide_bwd")) if name == "bfloat16" else (
                lambda lib=lib: _launch_f32(torch, lib, q, k, v, bias, g, WIDE384_SHAPE[2]))
            b, s, h, d = WIDE384_SHAPE
            print(json.dumps({"breakdown": variant, "dtype": name, "B": b, "S": s, "H": h,
                              "D": d, "device_ms": _device_ms(torch, fn),
                              "kernel_us": _kernel_us(torch, fn), "host_us": _host_us(torch, fn),
                              "reps": REPS}), flush=True)


def ab(torch, parent, change) -> None:
    """parent, change, change, parent at each timed shape; the gradients of
    both held to each other (bit-equal is not expected across designs)."""
    for name, shape, (q, k, v, bias, g) in _timed_shapes(torch):
        h = shape[2]
        times = {}
        for side, lib in (("parent", parent), ("change", change), ("change", change),
                          ("parent", parent)):
            times.setdefault(side, []).append(
                _device_ms(torch, lambda lib=lib: _launch(torch, lib, q, k, v, bias, g, h)))
        a, b = _launch(torch, parent, q, k, v, bias, g, h), _launch(torch, change, q, k, v, bias, g, h)
        diff = max(float((x.float() - y.float()).abs().max()) / max(1.0, float(x.float().abs().max()))
                   for x, y in zip(a, b))
        print(json.dumps({"ab": name, "B": shape[0], "S": shape[1], "H": h, "D": shape[3],
                          "parent_ms": times["parent"], "change_ms": times["change"],
                          "parent_mean_ms": float(np.mean(times["parent"])),
                          "change_mean_ms": float(np.mean(times["change"])),
                          "change_over_parent": float(np.mean(times["change"]) / np.mean(times["parent"])),
                          "grads_diff_over_max": diff, "reps": REPS}), flush=True)


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
    counter = A.BACKWARD_COUNTERS[route]
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
    ap.add_argument("--breakdown", nargs="?", const=",".join(BREAKDOWN), default=None,
                    help="time these copies (comma-separated; default: %(const)s)")
    ap.add_argument("--parent", type=Path, help="root of a checkout to A/B against")
    ap.add_argument("--sass", action="store_true", help="SASS opcode counts per kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    src = SRC.read_text()
    texts = variants(src, ["full"] + (args.breakdown.split(",") if args.breakdown else []))
    if args.parent:
        texts["parent"] = (args.parent / CSRC).read_text()
    libs = build(texts, {"parent": (args.parent / CSRC).parent} if args.parent else None)
    if args.sass:
        for name, ops in sass_counts(OUT / "full.so").items():
            print(json.dumps({"sass": name, "total": sum(ops.values()),
                              **dict(sorted(ops.items(), key=lambda kv: -kv[1]))}), flush=True)
    for row in libs["full"][1]:
        print(json.dumps({"registers": row}), flush=True)
    for name, (_lib, rows) in libs.items():  # each copy's tensor-core kernels, compactly
        brief = {}
        for r in rows:
            m = re.search(r"(mha_bwd_\w+?kernel)I(\w*?)Li(\d+)E", r.get("kernel", ""))
            if m:
                brief[f"{m.group(1)} {m.group(2)[-6:]} DP={m.group(3)}"] = [
                    r.get("registers"), r.get("spill_stores")]
            m = re.search(r"(wide_(?:score|product)_kernel)I(\w*?)Li(\d)E", r.get("kernel", ""))
            if m:
                brief[f"{m.group(1)} {m.group(2)[-6:]} {m.group(3)}"] = [
                    r.get("registers"), r.get("spill_stores")]
            m = re.search(r"(wide_f32_\w+?_kernel)(?:ILi(\d)E)?", r.get("kernel", ""))
            if m:
                brief[f"{m.group(1)} {m.group(2) or ''}".strip()] = [
                    r.get("registers"), r.get("spill_stores")]
        print(json.dumps({"variant_registers": name, **brief}), flush=True)
    failed = 0
    for case in CASES:
        row = check(torch, case)
        failed += not row["ok"]
        print(json.dumps({"check": row}), flush=True)
    for row in delta_rows(torch):
        print(json.dumps({"delta": row}), flush=True)
    if args.parent:
        ab(torch, libs["parent"][0], libs["full"][0])
    if args.breakdown:
        breakdown(torch, libs)
    if not args.no_time:
        for row in CS._training_kernel_rows(torch):
            print(json.dumps({"time": row}), flush=True)
        for row in CS._training_kernel_rows(torch, CS.MESH_SHAPES[:1], torch.float32):
            print(json.dumps({"time": row}), flush=True)
    print(json.dumps({"failed_checks": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
