"""Fused stage A: dense scores and per-tile winners in one pass over the
corpus, then a global merge, the winners' postings and eager BM25.

Counterpart of `review_recommender_tpu/ops/pallas/stage_a_kernel.py`:

  stage_a_tile_winners_reference   plain torch version of the tile pass
  stage_a_tile_winners_kernel      the CUDA tile pass, replacing
                                   `_stage_a_kernel`: csrc/stage_a_wgmma.cu
                                   (tensor cores, threshold-filtered
                                   selection; f32 as 3xTF32) at any D
  stage_a_fused                    `stage_a_fused_pallas`: the tile pass
                                   (the kernel for CUDA tensors, the plain
                                   version for CPU tensors), then the merge
  stage_a_fused_reference          the same with the plain tile pass

The tile pass, per 2048-row tile and query: score = the f32 sum of the
products of the corpus row and the query rounded to the corpus dtype;
invalid rows score -3.4e38 (not -inf); then M_PER_TILE rounds of (max,
lowest index among equal maxima, set the winner to -3.4e38). Once a tile has
no valid row left, every score in it is -3.4e38, so every later round
returns -3.4e38 and local index 0, whether chosen before or invalid: ids
repeat as they do in the TPU kernel. Outputs (n_tiles, M_PER_TILE, B)
scores and local ids.

The merge is plain torch in both paths, as the JAX package keeps it in XLA
outside the kernel: a stable descending top-`pool` over the n_tiles * 16
winners in (tile, round) order, a gather of the winners' postings and the
masked sum of their eager BM25 contributions. The result is approximate: a
true top-`pool` row is lost only when its tile holds more than 16 of them.

Any N: the JAX function asserts N % TILE_N == 0; here rows from N up to the
next multiple of TILE_N count as invalid (the kernel masks them, the plain
version pads its score matrix), which equals zero padding with valid=False.
No id reaches that tail: a tail row never wins on a score, and an exhausted
round returns its tile's row 0, which is below N.

The engine does not route its queries through this op, as the JAX engine
does not; it is driven on a batch of query vectors as bench.py drives it.
"""
from __future__ import annotations

import torch

from review_recommender_tpu_torch import kernels
from review_recommender_tpu_torch.ops.bm25 import bm25_candidate_scores_eager
from review_recommender_tpu_torch.ops.dense import matmul_f32, stable_topk

TILE_N = 2048
M_PER_TILE = 16
NEG = -3.4e38  # the TPU kernel's mask value, as f32 (-3.3999999521e38)
MAX_TILES = 65535  # grid.y of the f32 routes

# Launches of each route's CUDA kernel in this process; a run reads them
# before and after its main path to show that the path went through the
# kernels. The routes are csrc/stage_a_wgmma.cu's two instances: bf16
# (stage_a_kernel_launches, the main path's) and f32 as 3xTF32
# (stage_a_tf32_kernel_launches).
stage_a_kernel_launches = 0
stage_a_tf32_kernel_launches = 0
ROUTE_COUNTERS = {"wgmma": "stage_a_kernel_launches", "tf32": "stage_a_tf32_kernel_launches"}

# Per corpus dtype: the narrowest and the widest query chunk the kernel has
# an instance for, and the columns of one of its 128-byte boxes.
_CHUNKS = {torch.bfloat16: (16, 128, 64), torch.float32: (8, 32, 32)}


def _n_tiles(n: int) -> int:
    return -(-n // TILE_N)


def stage_a_route(dtype: torch.dtype, d: int, b: int) -> str:
    """The kernel a CUDA tile pass of B queries over an (N, D) corpus of
    `dtype` runs, both in csrc/stage_a_wgmma.cu: "wgmma" (bf16) or "tf32"
    (f32, the products as 3xTF32), at any D. Raises for another dtype, D <
    1 or B < 1."""
    if dtype not in _CHUNKS:
        raise ValueError(f"stage_a_fused: emb must be bfloat16 or float32, got {dtype}")
    if d < 1 or b < 1:
        raise ValueError(f"stage_a_fused: D={d}, B={b} not taken (D >= 1, B >= 1)")
    return "tf32" if dtype == torch.float32 else "wgmma"


def stage_a_query_chunk(d: int, b: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The queries one CTA of the kernel scores from one read of its tile,
    for B queries of D dims: the smallest of bf16 16, 32, 64, 128 or f32 8,
    16, 32 that holds B (the widest otherwise). A batch wider than this
    reads the corpus once per chunk."""
    stage_a_route(dtype, d, b)
    nc, widest, _cols = _CHUNKS[dtype]
    while nc < widest and nc < b:
        nc *= 2
    return nc


def _workspace_bytes(dtype: torch.dtype, d: int, b: int, nc: int) -> int:
    """The query boxes the kernel reads: every chunk's queries, 128 bytes a
    query and box of columns (f32: a hi and a lo copy)."""
    cols = _CHUNKS[dtype][2]
    copies = 2 if dtype == torch.float32 else 1
    return -(-b // nc) * nc * -(-d // cols) * copies * 128


def stage_a_tile_rounds(sims: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rounds of the plain tile pass over given scores: sims (N, B) f32,
    valid (N,) bool -> (scores (n_tiles, 16, B) f32, local ids (n_tiles,
    16, B) int32). `max` over a dim returns the first of equal maxima, as
    argmax does in the Pallas kernel."""
    n, b = sims.shape
    tiles = _n_tiles(n)
    sims = torch.where(valid[:, None], sims, NEG)
    if tiles * TILE_N != n:
        sims = torch.nn.functional.pad(sims, (0, 0, 0, tiles * TILE_N - n), value=NEG)
    x = sims.reshape(tiles, TILE_N, b)  # our own tensor: masked in place
    out_s = torch.empty((tiles, M_PER_TILE, b), dtype=torch.float32, device=sims.device)
    out_i = torch.empty((tiles, M_PER_TILE, b), dtype=torch.int32, device=sims.device)
    for m in range(M_PER_TILE):
        best, arg = x.max(dim=1)  # (tiles, B)
        out_s[:, m] = best
        out_i[:, m] = arg
        x.scatter_(1, arg[:, None, :], NEG)
    return out_s, out_i


def stage_a_tile_winners_reference(emb: torch.Tensor, valid: torch.Tensor,
                                   qvecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain tile pass: emb (N, D) bf16/f32, valid (N,) bool, qvecs (B, D)
    -> (scores (n_tiles, 16, B) f32, local ids (n_tiles, 16, B) int32)."""
    return stage_a_tile_rounds(matmul_f32(emb, qvecs.to(emb.dtype).T), valid)


def stage_a_tile_winners_kernel(emb: torch.Tensor, valid: torch.Tensor,
                                qvecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA tile pass: same contract as the plain version, CUDA tensors
    only, bf16 or f32, any N, D and B. csrc/stage_a_wgmma.cu on the tensor
    cores, in chunks of `stage_a_query_chunk` queries, whose boxes a
    workspace holds, made by the same call. Launches on the current stream
    and raises if the launch fails; nothing falls back to another route or
    to the plain version."""
    name = "stage_a_fused"
    dev = kernels.check_tensors(name, dict(emb=emb, valid=valid, qvecs=qvecs),
                                dict(emb=emb.dtype, valid=torch.bool, qvecs=torch.float32))
    if emb.dim() != 2 or valid.shape != (emb.shape[0],) or qvecs.dim() != 2 \
            or qvecs.shape[1] != emb.shape[1]:
        raise ValueError(f"{name}: emb must be (N, D), valid (N,) and qvecs (B, D), got "
                         f"{tuple(emb.shape)}/{tuple(valid.shape)}/{tuple(qvecs.shape)}")
    n, d = emb.shape
    b = qvecs.shape[0]
    if not (0 < n and _n_tiles(n) <= MAX_TILES):
        raise ValueError(f"{name}: N={n} not taken (N in 1..{MAX_TILES * TILE_N})")
    route = stage_a_route(emb.dtype, d, b)
    if emb.data_ptr() % 16:
        raise ValueError(f"{name}: emb must be 16-byte aligned")
    nc = stage_a_query_chunk(d, b, emb.dtype)
    lib = kernels.load()
    ws = torch.empty(_workspace_bytes(emb.dtype, d, b, nc), dtype=torch.uint8, device=dev)
    tiles = _n_tiles(n)
    out_s = torch.empty((tiles, M_PER_TILE, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((tiles, M_PER_TILE, b), dtype=torch.int32, device=dev)
    launch = lib.rrt_stage_a_tf32 if route == "tf32" else lib.rrt_stage_a_wgmma
    with torch.cuda.device(dev):
        err = launch(emb.data_ptr(), valid.data_ptr(), qvecs.data_ptr(), ws.data_ptr(),
                     out_s.data_ptr(), out_i.data_ptr(), n, d, b, nc,
                     torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(name, err, f"N={n} D={d} B={b} {emb.dtype} ({route}, {nc} a chunk)")
    globals()[ROUTE_COUNTERS[route]] += 1
    return out_s, out_i


def _merge(out_s, out_i, doc_terms, doc_bm25, q_terms, pool: int):
    """Global stable top-`pool` over the winners in (tile, round) order,
    the winners' postings and the masked eager-BM25 sum."""
    tiles, _m, b = out_s.shape
    base = torch.arange(tiles, dtype=torch.int64, device=out_i.device) * TILE_N
    flat_s = out_s.reshape(-1, b).T  # (B, n_tiles * 16)
    flat_i = (out_i.to(torch.int64) + base[:, None, None]).reshape(-1, b).T
    dense, sel = stable_topk(flat_s, min(int(pool), flat_s.shape[1]))
    idx = torch.gather(flat_i, 1, sel)
    if q_terms.dim() == 1:
        q_terms = q_terms.expand(b, -1)
    bm25 = bm25_candidate_scores_eager(doc_terms[idx], doc_bm25[idx], q_terms)
    return dense, idx.to(torch.int32), bm25


def stage_a_fused(emb, valid, doc_terms, doc_bm25, qvecs, q_terms, pool: int):
    """Fused stage A with the JAX signature: emb (N, D) bf16/f32, valid (N,)
    bool, doc_terms (N, L) int32, doc_bm25 (N, L) f32 eager contributions,
    qvecs (B, D) f32, q_terms (Q,) shared or (B, Q) per query -> (dense
    (B, pool) f32, idx (B, pool) int32, bm25 (B, pool) f32). The tile pass
    is the kernel for CUDA tensors, the plain version for CPU tensors."""
    winners = (stage_a_tile_winners_reference if emb.device.type == "cpu"
               else stage_a_tile_winners_kernel)
    out_s, out_i = winners(emb, valid, qvecs)
    return _merge(out_s, out_i, doc_terms, doc_bm25, q_terms, pool)


def stage_a_fused_reference(emb, valid, doc_terms, doc_bm25, qvecs, q_terms, pool: int):
    """stage_a_fused with the plain tile pass on any device."""
    out_s, out_i = stage_a_tile_winners_reference(emb, valid, qvecs)
    return _merge(out_s, out_i, doc_terms, doc_bm25, q_terms, pool)
