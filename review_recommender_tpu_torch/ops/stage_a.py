"""Fused stage A: dense scores and per-tile winners in one pass over the
corpus, then a global merge, the winners' postings and eager BM25.

Counterpart of `review_recommender_tpu/ops/pallas/stage_a_kernel.py`:

  stage_a_tile_winners_reference   plain torch version of the tile pass
  stage_a_tile_winners_kernel      the CUDA tile pass, replacing
                                   `_stage_a_kernel`: a bf16 corpus takes
                                   csrc/stage_a_wgmma.cu (tensor cores,
                                   TMA, threshold-filtered selection), an
                                   f32 corpus csrc/stage_a_fused.cu (CUDA
                                   cores; wgmma has no f32 input)
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
MAX_DIM = 4096  # both kernels keep a chunk of the queries in shared memory
MAX_TILES = 65535  # grid.y of the f32 kernel

# Launches of each CUDA kernel in this process; a run reads them before and
# after its main path to show that the path went through the kernels:
# stage_a_kernel_launches the bf16 tensor-core kernel (the main path's),
# stage_a_f32_kernel_launches the f32 CUDA-core kernel.
stage_a_kernel_launches = 0
stage_a_f32_kernel_launches = 0


def _n_tiles(n: int) -> int:
    return -(-n // TILE_N)


def stage_a_tile_winners_reference(emb: torch.Tensor, valid: torch.Tensor,
                                   qvecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain tile pass: emb (N, D) bf16/f32, valid (N,) bool, qvecs (B, D)
    -> (scores (n_tiles, 16, B) f32, local ids (n_tiles, 16, B) int32).
    `max` over a dim returns the first of equal maxima, as argmax does in
    the Pallas kernel."""
    n = emb.shape[0]
    b = qvecs.shape[0]
    tiles = _n_tiles(n)
    sims = matmul_f32(emb, qvecs.to(emb.dtype).T)  # (N, B)
    sims = torch.where(valid[:, None], sims, NEG)
    if tiles * TILE_N != n:
        sims = torch.nn.functional.pad(sims, (0, 0, 0, tiles * TILE_N - n), value=NEG)
    x = sims.reshape(tiles, TILE_N, b)  # our own tensor: masked in place
    out_s = torch.empty((tiles, M_PER_TILE, b), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((tiles, M_PER_TILE, b), dtype=torch.int32, device=emb.device)
    for m in range(M_PER_TILE):
        best, arg = x.max(dim=1)  # (tiles, B)
        out_s[:, m] = best
        out_i[:, m] = arg
        x.scatter_(1, arg[:, None, :], NEG)
    return out_s, out_i


def stage_a_tile_winners_kernel(emb: torch.Tensor, valid: torch.Tensor,
                                qvecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA tile pass: same contract as the plain version, CUDA tensors
    only, any N and B; D * itemsize must be a multiple of 16 bytes, D <=
    4096. The route is the corpus dtype alone: bf16 takes the tensor-core
    kernel (csrc/stage_a_wgmma.cu), which holds every such shape (its query
    chunk narrows to 16 at D = 4096, and a wider batch runs as more chunks);
    f32 takes the CUDA-core kernel (csrc/stage_a_fused.cu). Launches on the
    current stream and raises if the launch fails; nothing falls back."""
    global stage_a_kernel_launches, stage_a_f32_kernel_launches
    name = "stage_a_fused"
    if emb.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: emb must be bfloat16 or float32, got {emb.dtype}")
    dev = kernels.check_tensors(name, dict(emb=emb, valid=valid, qvecs=qvecs),
                                dict(emb=emb.dtype, valid=torch.bool, qvecs=torch.float32))
    if emb.dim() != 2 or valid.shape != (emb.shape[0],) or qvecs.dim() != 2 \
            or qvecs.shape[1] != emb.shape[1]:
        raise ValueError(f"{name}: emb must be (N, D), valid (N,) and qvecs (B, D), got "
                         f"{tuple(emb.shape)}/{tuple(valid.shape)}/{tuple(qvecs.shape)}")
    n, d = emb.shape
    b = qvecs.shape[0]
    if not (0 < n and 0 < b and _n_tiles(n) <= MAX_TILES and 0 < d <= MAX_DIM
            and d * emb.element_size() % 16 == 0):
        raise ValueError(f"{name}: N={n}, D={d}, B={b} not taken (N in 1..{MAX_TILES * TILE_N}, "
                         f"D in 1..{MAX_DIM} with D * itemsize a multiple of 16, B >= 1)")
    if emb.data_ptr() % 16 or qvecs.data_ptr() % 16:
        raise ValueError(f"{name}: emb and qvecs must be 16-byte aligned")
    lib = kernels.load()
    tiles = _n_tiles(n)
    out_s = torch.empty((tiles, M_PER_TILE, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((tiles, M_PER_TILE, b), dtype=torch.int32, device=dev)
    args = (emb.data_ptr(), valid.data_ptr(), qvecs.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), n, d, b)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bf16 = emb.dtype == torch.bfloat16
        err = (lib.rrt_stage_a_wgmma if bf16 else lib.rrt_stage_a_f32)(*args, stream)
    kernels.check_launch(name, err, f"N={n} D={d} B={b} {emb.dtype}")
    if bf16:
        stage_a_kernel_launches += 1
    else:
        stage_a_f32_kernel_launches += 1
    return out_s, out_i


def stage_a_query_chunk(d: int, b: int) -> int:
    """The queries one CTA of the bf16 kernel scores from one read of its
    tile, for B queries of D dims (16, 32, 64 or 128; the rule lives in
    csrc/stage_a_wgmma.cu). A batch wider than this reads the corpus once
    per chunk."""
    return kernels.load().rrt_stage_a_wgmma_chunk(d, b)


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
