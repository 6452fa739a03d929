"""Full-corpus BM25 in one pass over the postings: two CUDA kernels.

Counterpart of `review_recommender_tpu/ops/pallas/bm25_kernel.py`:

  pack_postings                            host packer, a numpy copy of the
                                           JAX one: (N, L) terms + tf ->
                                           (L, N_pad) words (tf << 24) | term
  bm25_full_scores_packed_reference        the packed kernel's plain torch
                                           version (the unpacked kernel's is
                                           ops/bm25.py:bm25_full_scores)
  bm25_full_scores_packed_kernel           csrc/bm25_full.cu, replacing
  bm25_full_scores_kernel                  `_bm25_packed_kernel` and
                                           `_bm25_kernel`
  bm25_topk_packed / bm25_topk_unpacked    scan -> valid mask -> stable
                                           top-k (engine/search.py:
                                           search_bm25): the kernel for CUDA
                                           tensors, the plain version for
                                           CPU tensors

Per document both compute, for each query slot in slot order,
tf_q = sum of the tf values whose term equals the slot's id, then
acc += idf * tf_q * (k1+1) / (tf_q + norm), norm = k1 * (1 - b + b*dl/avgdl),
in the expression order of `ops/bm25.py`. The kernels round each step
alone (no FMA contraction, IEEE division), so their scores equal the plain
versions' bit for bit, and with them the JAX package's.

On a CUDA tensor a kernel launches or the call raises; nothing falls back
to the plain version. A query of Q slots is one launch for Q <= 64, and
ceil(Q / 64) launches (each a full scan) up to Q = MAX_QUERY_SLOTS; the
launch counters count calls, not launches. Unlike the TPU kernels, the
CUDA ones take any N (no 256/512 tile alignment); TILE_N and TILE_N_PACKED
keep the JAX package's padding contracts for the host packer and the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from review_recommender_tpu_torch import kernels
from review_recommender_tpu_torch.ops.bm25 import bm25_full_scores, masked_topk

# Launches of each CUDA kernel in this process; a run reads them before and
# after its main path to show that the path went through the kernels.
bm25_packed_kernel_launches = 0
bm25_unpacked_kernel_launches = 0

TILE_N = 256
TILE_N_PACKED = 512
# The kernels take up to 64 query slots a launch (their query table and
# shared tf_q rows); a longer query runs in launches of 64 slots, each
# adding to the scores of the one before (csrc/bm25_full.cu), up to this many
MAX_QUERY_SLOTS = 1024
_TF_BITS = 8
_TERM_MASK = (1 << 24) - 1


def pack_postings(doc_terms, doc_tf):
    """Host-side pack: (N, L) i32 terms + f32 tf -> (L, N_pad) int32, where
    N_pad rounds N up to TILE_N_PACKED. Returns None when the corpus cannot
    be packed losslessly (non-integer tf, tf > 255, or term ids >= 2^24)."""
    terms = np.asarray(doc_terms)
    tf = np.asarray(doc_tf)
    tfi = tf.astype(np.int32)
    if not (
        (tfi == tf).all()
        and 0 <= tfi.min()
        and tfi.max() <= (1 << _TF_BITS) - 1
        and terms.min() >= 0
        and terms.max() <= _TERM_MASK
    ):
        return None
    packed = (tfi << 24) | terms  # tf >= 128 sets the sign bit
    n = packed.shape[0]
    n_pad = -(-n // TILE_N_PACKED) * TILE_N_PACKED
    if n_pad != n:
        packed = np.pad(packed, ((0, n_pad - n), (0, 0)))
    return np.ascontiguousarray(packed.T.astype(np.int32))  # (L, N_pad)


# ----------------------------------------------------------- plain versions
def bm25_full_scores_packed_reference(packed_t: torch.Tensor, doc_len: torch.Tensor,
                                      q_terms: torch.Tensor, q_idf: torch.Tensor,
                                      avgdl) -> torch.Tensor:
    """Plain BM25 over packed (L, N) words: scores (N,) f32. The shift is
    arithmetic on int32, so the tf field is masked after it."""
    terms = packed_t & _TERM_MASK
    tf = ((packed_t >> 24) & ((1 << _TF_BITS) - 1)).to(torch.float32)
    return bm25_full_scores(terms, tf, doc_len, q_terms, q_idf, avgdl, lane_dim=0)


# ------------------------------------------------------------------ kernels
def _check_query(name: str, q_terms: torch.Tensor, q_idf: torch.Tensor) -> int:
    if q_terms.dim() != 1 or q_idf.shape != q_terms.shape:
        raise ValueError(f"{name}: q_terms and q_idf must share a (Q,) shape, got "
                         f"{tuple(q_terms.shape)}/{tuple(q_idf.shape)}")
    q = q_terms.shape[0]
    if not 0 < q <= MAX_QUERY_SLOTS:
        raise ValueError(f"{name}: {q} query slots not in 1..{MAX_QUERY_SLOTS}")
    return q


def _check_sizes(name: str, n: int, l: int) -> None:
    """The kernels take N and L as C ints (offsets are 64-bit)."""
    if not (0 < n < 2**31 and 0 <= l < 2**31):
        raise ValueError(f"{name}: N={n}, L={l} not in 1..2^31-1, 0..2^31-1")


def bm25_full_scores_packed_kernel(packed_t: torch.Tensor, doc_len: torch.Tensor,
                                   q_terms: torch.Tensor, q_idf: torch.Tensor,
                                   avgdl) -> torch.Tensor:
    """The packed CUDA kernel: same contract as the plain version, CUDA
    tensors only, any N. avgdl is a float (or a tensor read once on the
    host). Launches on the current stream and raises if the launch fails."""
    global bm25_packed_kernel_launches
    name = "bm25_packed"
    dev = kernels.check_tensors(
        name, dict(packed_t=packed_t, doc_len=doc_len, q_terms=q_terms, q_idf=q_idf),
        dict(packed_t=torch.int32, doc_len=torch.float32, q_terms=torch.int32,
             q_idf=torch.float32))
    q = _check_query(name, q_terms, q_idf)
    if packed_t.dim() != 2 or doc_len.shape != (packed_t.shape[1],):
        raise ValueError(f"{name}: packed_t must be (L, N) and doc_len (N,), got "
                         f"{tuple(packed_t.shape)}/{tuple(doc_len.shape)}")
    l, n = packed_t.shape
    _check_sizes(name, n, l)
    lib = kernels.load()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rrt_bm25_packed(packed_t.data_ptr(), doc_len.data_ptr(), q_terms.data_ptr(),
                                  q_idf.data_ptr(), float(avgdl), out.data_ptr(), n, l, q,
                                  stream)
    kernels.check_launch(name, err, f"L={l} N={n} Q={q}")
    bm25_packed_kernel_launches += 1
    return out


def bm25_full_scores_kernel(doc_terms: torch.Tensor, doc_tf: torch.Tensor,
                            doc_len: torch.Tensor, q_terms: torch.Tensor,
                            q_idf: torch.Tensor, avgdl) -> torch.Tensor:
    """The unpacked CUDA kernel over row-major (N, L) postings: same
    contract as the plain version, CUDA tensors only, any N."""
    global bm25_unpacked_kernel_launches
    name = "bm25_unpacked"
    dev = kernels.check_tensors(
        name, dict(doc_terms=doc_terms, doc_tf=doc_tf, doc_len=doc_len, q_terms=q_terms,
                   q_idf=q_idf),
        dict(doc_terms=torch.int32, doc_tf=torch.float32, doc_len=torch.float32,
             q_terms=torch.int32, q_idf=torch.float32))
    q = _check_query(name, q_terms, q_idf)
    if doc_terms.dim() != 2 or doc_tf.shape != doc_terms.shape \
            or doc_len.shape != (doc_terms.shape[0],):
        raise ValueError(f"{name}: doc_terms/doc_tf must share an (N, L) shape and doc_len "
                         f"be (N,), got {tuple(doc_terms.shape)}/{tuple(doc_tf.shape)}/"
                         f"{tuple(doc_len.shape)}")
    n, l = doc_terms.shape
    _check_sizes(name, n, l)
    lib = kernels.load()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rrt_bm25_unpacked(doc_terms.data_ptr(), doc_tf.data_ptr(), doc_len.data_ptr(),
                                    q_terms.data_ptr(), q_idf.data_ptr(), float(avgdl),
                                    out.data_ptr(), n, l, q, stream)
    kernels.check_launch(name, err, f"N={n} L={l} Q={q}")
    bm25_unpacked_kernel_launches += 1
    return out


# ------------------------------------------------------------- scan + top-k
def bm25_topk_packed(packed_t, doc_len, valid, q_terms, q_idf, avgdl,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed scan + top-k: the kernel on CUDA tensors, the plain version
    on CPU tensors. `valid`/`doc_len` are padded to packed_t's N (pad rows
    False/0); pad rows score -inf and win only a tail slot when k exceeds
    the valid rows."""
    scan = (bm25_full_scores_packed_reference if packed_t.device.type == "cpu"
            else bm25_full_scores_packed_kernel)
    return masked_topk(scan(packed_t, doc_len, q_terms, q_idf, avgdl), valid, k)


def bm25_topk_unpacked(doc_terms, doc_tf, doc_len, valid, q_terms, q_idf, avgdl,
                       k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpacked scan + top-k: the kernel on CUDA tensors, ops/bm25.py's
    plain scan on CPU tensors."""
    scan = bm25_full_scores if doc_terms.device.type == "cpu" else bm25_full_scores_kernel
    return masked_topk(scan(doc_terms, doc_tf, doc_len, q_terms, q_idf, avgdl), valid, k)
