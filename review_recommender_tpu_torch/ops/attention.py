"""Fused multi-head attention for the BERT towers.

Counterpart of `review_recommender_tpu/ops/pallas/attention_kernel.py`:

  mha_reference        the plain torch version (mha_xla's math: f32 logits
                       from upcast q and k, f32 softmax, probabilities in
                       the input dtype, f32-accumulated PV), of both routes
  kernel_route         which hand-written kernel takes (dtype, D, S):
                       "wgmma" = csrc/mha_fwd.cu (tensor cores, TMA;
                       bf16/f16 at D in {32, 64, 128}), "generic" =
                       csrc/mha_generic.cu (f32, bf16 and f16 at any D
                       from 1 to 256, on the tensor cores from tiles
                       zero-padded to padded_head_dim(D): bf16/f16 in two
                       softmax passes, f32 as 3xTF32 in one online pass),
                       "wide" = every D past 256: bf16/f16
                       csrc/mha_wide.cu (a score kernel contracts each row
                       block's S once over the whole D and stores the f32
                       logits in a workspace; an output kernel forms P
                       from them and adds P V, a column chunk a
                       warpgroup; TMA), f32 csrc/mha_wide_f32.cu (3xTF32,
                       the logits computed once into a workspace, then
                       the output from them); any S >= 1 on all three.
                       Together they replace the TPU kernel `_mha_kernel`,
                       which takes any float type, head width and length
  mha_kernel           the route's CUDA kernel; where a gradient is asked
                       for it runs through MhaKernelFn
  mha_backward_reference  the plain torch version of the backward kernel's
                       formula: the q, k, v gradients from the saved
                       inputs and the upstream gradient, written out with
                       the roundings of autograd through mha_reference
  backward_route       which backward kernel takes (dtype, D, S): up to
                       D = 256 csrc/mha_bwd.cu, "wgmma" (bf16/f16: wgmma,
                       products in flight during the softmax work) or
                       "tf32" (f32: wgmma as 3xTF32); past 256 "wide"
                       (bf16/f16, csrc/mha_wide_bwd.cu) or "wide_tf32"
                       (f32, csrc/mha_wide_f32.cu: S and dP computed
                       once into a workspace), gradient columns in chunks
  padded_head_dim      the padded width of the generic and backward
                       kernels' instance for a head width up to 256 (the C
                       entries rrt_mha_generic_last_dp / rrt_mha_bwd_last_dp
                       report the instance a launch ran)
  wide_column_chunks   the column chunks of the wide kernels for a head
                       width past 256: the forward's output columns, the
                       dQ kernel's and the dK / dV kernel's a CTA (the C
                       entries rrt_mha_wide_last_dc / rrt_mha_wide_bwd_last_dc
                       report the last 16-bit launch's, rrt_mha_wide_f32_dc
                       the f32 kernels')
  wide_split           how the bf16/f16 wide kernels share a row block's
                       scores: contracted once a call (the score kernels
                       count the tiles they contract) and read back by so
                       many CTAs of each kernel (rrt_mha_wide_last_split,
                       rrt_mha_wide_bwd_last_split)
  wide_workspace_floats  the bf16/f16 wide kernels' workspace (row
                       statistics, the stored logits and dP, the rows
                       copied where TMA cannot read them in place)
  wide_f32_workspace_floats  the f32 wide kernels' workspace (logits or
                       P and dP, row statistics, transposed copies)
  multihead_attention  the towers' entry point: impl "auto" launches the
                       kernel for CUDA tensors and takes the reference for
                       CPU tensors (autograd through its torch ops);
                       "kernel" and "reference" force one

On a CUDA tensor the route's kernel launches or the call raises; the route
depends on dtype and shape alone, every head width D >= 1 has one, and
nothing falls back to the reference. A batch past the kernels' grid limit
of 65,535 runs as launches on contiguous slices of at most 65,535 rows
(each slice a launch, counted); more than 65,535 heads are refused (the
TPU kernel's grid takes them, no tower has them); the wide kernels' batch
also runs by slices whose workspace stays under WIDE_WORKSPACE_BYTES.
The gradient follows the JAX custom_vjp
(attention_kernel.py:132-154) in what it returns, the q, k and v gradients
(the key bias, built from the mask, gets none), but not in how: where JAX
re-runs the plain attention under jax.vjp, MhaKernelFn's backward is the
hand-written kernel csrc/mha_bwd.cu on CUDA tensors and
mha_backward_reference on CPU tensors. The wide kernels take a workspace
that grows with B * H * S^2 (at least one batch row a slice, within the
grid's slices: _batch_slices).
"""
from __future__ import annotations

import threading

import torch

from review_recommender_tpu_torch import kernels

# Launches of each CUDA kernel in this process (the tensor-core route's,
# then the generic route's); a run reads them before and after its main
# path to show that the path went through the kernels. A server's handler
# threads encode concurrently, so the counts are bumped under a lock.
mha_kernel_launches = 0
mha_generic_kernel_launches = 0
# csrc/mha_wide.cu (bf16/f16): a call's score and output kernels (and pad
# kernels, at rows TMA cannot read) count one
mha_wide_kernel_launches = 0
# csrc/mha_wide_f32.cu's forward (f32 past 256): a call's transpose, score
# and output kernels (and pad kernels, at widths TMA cannot read) count one
mha_wide_f32_kernel_launches = 0
# Launches of the backward kernel (csrc/mha_bwd.cu), by route (backward_route:
# "wgmma", "tf32"): one per kernel forward that a training step
# differentiates. With remat (per-layer checkpointing) the backward first
# re-runs each layer's forward, so a step launches the forward twice for
# each backward.
mha_backward_kernel_launches = 0
mha_backward_tf32_launches = 0
# past D = 256, a call counting one: csrc/mha_wide_bwd.cu's four kernels
# (bf16/f16: the score and dP kernels, the dQ and dK / dV kernels);
# csrc/mha_wide_f32.cu's backward (f32: three transposes, the score and dP
# kernels, the dQ and dK / dV kernels)
mha_backward_wide_launches = 0
mha_backward_wide_tf32_launches = 0
_count_lock = threading.Lock()

WGMMA_HEAD_DIMS = (32, 64, 128)  # csrc/mha_fwd.cu's TMA boxes and wgmma k-steps
# the widest head of the padded instances of csrc/mha_generic.cu and
# csrc/mha_bwd.cu; wider heads take the wide kernels' column chunks
MAX_HEAD_DIM = 256
# the padded widths of the instances of csrc/mha_generic.cu and csrc/mha_bwd.cu
PADDED_HEAD_DIMS = (16, 32, 64, 128, 192, 256)
MAX_GRID_BATCH = 65535  # the kernels' grid.z: larger batches launch by slices
# the wide kernels' workspace a batch slice may take, every dtype's (tests
# monkeypatch it)
WIDE_WORKSPACE_BYTES = 1 << 30
WIDE_F32_CHUNK = 128  # csrc/mha_wide_f32.cu's kDc: the output columns of a CTA
# the bf16/f16 wide kernels' columns a warpgroup: csrc/mha_wide.cuh's
# kChunk (the output and dQ kernels) and kChunkKV (the dK / dV kernel)
WIDE_CHUNKS = (192, 192, 192)
BACKWARD_COUNTERS = {"wgmma": "mha_backward_kernel_launches",
                     "tf32": "mha_backward_tf32_launches",
                     "wide": "mha_backward_wide_launches",
                     "wide_tf32": "mha_backward_wide_tf32_launches"}  # backward_route -> counter
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def kernel_route(dtype: torch.dtype, d: int, s: int) -> str:
    """The hand-written kernel that takes attention over q/k/v of `dtype`
    with head width `d` and `s` keys: "wgmma" (csrc/mha_fwd.cu) for
    bf16/f16 at d in WGMMA_HEAD_DIMS, "generic" (csrc/mha_generic.cu) for
    every other f32, bf16 or f16 case with 1 <= d <= MAX_HEAD_DIM (on the
    tensor cores at every d, f32 as three TF32 products a product, in the
    instance of padded_head_dim(d) columns), "wide" (csrc/mha_wide.cu) for
    all three at d > MAX_HEAD_DIM (output columns in wide_column_chunks).
    Any s >= 1 runs on all three. Raises ValueError for another dtype, d < 1
    or s < 1."""
    _check_domain(dtype, d, s)
    if d > MAX_HEAD_DIM:
        return "wide"
    if dtype != torch.float32 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "generic"


def backward_route(dtype: torch.dtype, d: int, s: int) -> str:
    """The backward kernel's route for attention over q/k/v of `dtype` with
    head width `d` and `s` keys. Up to d = MAX_HEAD_DIM csrc/mha_bwd.cu:
    "wgmma" for bf16/f16 and "tf32" for f32 (each product as three TF32
    ones on the tensor cores; above 128 columns the 64-row tiles split a
    k-step at a time in registers), in the instance of padded_head_dim(d)
    columns. Past it csrc/mha_wide_bwd.cu: "wide" for bf16/f16 and
    "wide_tf32" for f32, gradient columns in wide_column_chunks. Same
    domain as kernel_route; raises ValueError outside it."""
    _check_domain(dtype, d, s)
    if d > MAX_HEAD_DIM:
        return "wide" if dtype != torch.float32 else "wide_tf32"
    return "wgmma" if dtype != torch.float32 else "tf32"


def padded_head_dim(d: int) -> int:
    """The padded head width DP of the instance of csrc/mha_generic.cu and
    csrc/mha_bwd.cu that takes head width d (1 <= d <= MAX_HEAD_DIM): the
    least of PADDED_HEAD_DIMS that holds d. Raises ValueError outside
    (wider heads take the wide kernels: wide_column_chunks)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"mha_kernel: head dim {d} not in 1..{MAX_HEAD_DIM} of the padded "
                         f"instances (past it the wide route: wide_column_chunks)")
    return next(w for w in PADDED_HEAD_DIMS if d <= w)


def wide_column_chunks(dtype: torch.dtype, d: int) -> tuple[int, int, int]:
    """The column chunks of the wide kernels at head width d > MAX_HEAD_DIM,
    one chunk a CTA: (the forward's output columns, the dQ kernel's, the
    dK / dV kernel's), one a warpgroup. bf16/f16: WIDE_CHUNKS, 192 each (a
    CTA of the forward's or the dQ kernel takes two chunks, one of the dK /
    dV kernel one: dV in one warpgroup, dK in the other; wide_split). f32
    (csrc/mha_wide_f32.cu): 128 columns a CTA in all three. Raises
    ValueError for d <= MAX_HEAD_DIM or another dtype."""
    _check_domain(dtype, d, 1)
    if d <= MAX_HEAD_DIM:
        raise ValueError(f"mha_kernel: head dim {d} takes a padded instance (padded_head_dim)")
    if dtype == torch.float32:
        return WIDE_F32_CHUNK, WIDE_F32_CHUNK, WIDE_F32_CHUNK
    return WIDE_CHUNKS


def wide_split(dtype: torch.dtype, d: int) -> tuple[tuple[int, int], ...]:
    """How the bf16/f16 wide kernels (csrc/mha_wide.cu, csrc/mha_wide_bwd.cu)
    share each 64-row block's score tiles at head width d > MAX_HEAD_DIM:
    for the forward's output kernel, the dQ kernel and the dK / dV kernel,
    (times a call contracts each tile of S (and dP): once, in the score
    kernel, which counts them: rrt_mha_wide_score_tiles,
    rrt_mha_wide_bwd_score_tiles; CTAs of the kernel that read the stored
    tiles back: one a pair of wide_column_chunks' chunks, or a dK / dV
    chunk). Raises ValueError where wide_column_chunks does, and for f32
    (csrc/mha_wide_f32.cu stores the scores too, with its own chunks)."""
    fwd, dq, dkv = wide_column_chunks(dtype, d)
    if dtype == torch.float32:
        raise ValueError("mha_kernel: the f32 wide kernels are csrc/mha_wide_f32.cu's")
    return (1, -(-d // (2 * fwd))), (1, -(-d // (2 * dq))), (1, -(-d // dkv))


def wide_workspace_floats(backward: bool, b: int, s: int, h: int, d: int, padded: bool) -> int:
    """Floats of workspace the bf16/f16 wide kernels take for a batch of b
    rows (csrc/mha_wide.cuh's WideWs; its C entry rrt_mha_wide_ws_floats,
    which the card tests check): each row's m and 1/l (backward also
    Delta), the stored logits in f32 (S rows by S rounded up to 64 keys a
    (b, h)), in the backward dP in the input type, then, where `padded`,
    the rows TMA reads copied at D rounded up to 8 (forward q, k, v;
    backward also dO). Each region is rounded up to 256 bytes."""
    r256 = lambda n: -(-n // 256) * 256
    bhs, sk = b * h * s, -(-s // 64) * 64
    nbytes = r256((3 if backward else 2) * bhs * 4) + r256(bhs * sk * 4)
    if backward:
        nbytes += r256(bhs * sk * 2)
    if padded:
        nbytes += (4 if backward else 3) * r256(bhs * (-(-d // 8) * 8) * 2)
    return nbytes // 4


def _check_domain(dtype: torch.dtype, d: int, s: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"mha_kernel takes float32, bfloat16 or float16, got {dtype}")
    if d < 1:
        raise ValueError(f"mha_kernel: head dim {d} < 1")
    if s < 1:
        raise ValueError(f"mha_kernel: sequence length {s} < 1")


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain multi-head attention. q/k/v: (B, S, H*D); key_bias: (B, S) f32
    additive mask over keys. Returns (B, S, H*D) in q.dtype."""
    b, s, hd = q.shape
    d = hd // num_heads
    split = lambda t: t.reshape(b, s, num_heads, d).to(torch.float32)
    probs = _probs(split(q), split(k), key_bias, d).to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32), split(v))
    return ctx.to(q.dtype).reshape(b, s, hd)


def _probs(qf: torch.Tensor, kf: torch.Tensor, key_bias: torch.Tensor, d: int) -> torch.Tensor:
    """softmax(q k^T * scale + key_bias) in f32, (B, H, S, S), from f32
    (B, S, H, D) heads: the exponentials divided by the f32 row sum."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * _scale(d)
    logits = logits + key_bias.to(torch.float32)[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _scale(d: int) -> float:
    # the f32 1/sqrt(d) as a host number: a host tensor moved to the card
    # is a blocking copy, which would drain the queue in every call
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def mha_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_bias: torch.Tensor, g: torch.Tensor,
                           num_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q, k and v gradients of mha_reference at (q, k, v, key_bias)
    against the upstream gradient `g`, written out (no autograd) as
    csrc/mha_bwd.cu computes them, with the roundings of autograd through
    mha_reference: P in f32; dV from P rounded to the input type; dP =
    g V^T rounded to the input type (the backward of the probabilities'
    cast); Delta = sum over the keys of P * dP; dS = P * (dP - Delta) in
    f32 times the scale; each gradient rounded to the input type once.
    Returns (dq, dk, dv), (B, S, H*D) each."""
    b, s, hd = q.shape
    d = hd // num_heads
    split = lambda t: t.reshape(b, s, num_heads, d).to(torch.float32)
    qf, kf, vf, gf = split(q), split(k), split(v), split(g)
    p = _probs(qf, kf, key_bias, d)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(torch.float32), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf).to(q.dtype).to(torch.float32)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * _scale(d)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(t.to(q.dtype).reshape(b, s, hd) for t in (dq, dk, dv))


def _check_kernel_args(q, k, v, key_bias, num_heads) -> tuple[int, int, int, int]:
    """The checks every route shares: CUDA tensors on one device, one q/k/v
    dtype, an f32 key bias, (B, S, H*D) shapes, contiguity, at most 65,535
    heads (the kernels' grid.y; any batch runs, by slices of grid.z)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and key_bias.is_cuda):
        raise ValueError("mha_kernel needs CUDA tensors (use mha_reference on the CPU)")
    if len({q.device, k.device, v.device, key_bias.device}) != 1:
        raise ValueError("mha_kernel: q, k, v and key_bias must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mha_kernel: q, k, v must share a dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if key_bias.dtype != torch.float32:
        raise ValueError(f"mha_kernel: key_bias must be float32, got {key_bias.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mha_kernel: q, k, v must share a (B, S, H*D) shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    b, s, hd = q.shape
    if key_bias.shape != (b, s):
        raise ValueError(f"mha_kernel: key_bias must be ({b}, {s}), got {tuple(key_bias.shape)}")
    if num_heads <= 0 or hd % num_heads:
        raise ValueError(f"mha_kernel: width {hd} is not a multiple of num_heads={num_heads}")
    if num_heads > 65535:
        raise ValueError("mha_kernel: heads must be <= 65535")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_bias", key_bias)):
        if not t.is_contiguous():
            raise ValueError(f"mha_kernel: {name} must be contiguous")
    return b, s, num_heads, hd // num_heads


def _batch_slices(b: int, row_bytes: int = 0) -> list[tuple[int, int]]:
    """[b0, b1) slices that cover a batch: at most MAX_GRID_BATCH rows each
    and, where a batch row takes `row_bytes` of workspace, at most as many
    rows as fit WIDE_WORKSPACE_BYTES, but never fewer than one."""
    rows = MAX_GRID_BATCH
    if row_bytes:
        rows = max(1, min(rows, WIDE_WORKSPACE_BYTES // row_bytes))
    return [(b0, min(b, b0 + rows)) for b0 in range(0, b, rows)]


def wide_f32_workspace_floats(backward: bool, b: int, s: int, h: int, d: int,
                              padded: bool) -> int:
    """Floats of workspace csrc/mha_wide_f32.cu takes for a batch of b rows
    (its C entry rrt_mha_wide_f32_ws_floats, which the card tests check):
    the logits (backward: P and dP) of S rows by S rounded up to 128 keys a
    (b, h), the row statistics (m, 1/l; backward also Delta), the
    transposed copies (V^T; backward K^T, Q^T, dO^T: D rows of those keys),
    and, where `padded`, the rows the score kernels read copied at D rounded
    up to 4 (forward q, k; backward q, k, v, dO). Each region is rounded up
    to 64 floats."""
    r64 = lambda n: -(-n // 64) * 64
    sk = -(-s // 128) * 128
    scores, stats, trans, rows = (2, 3, 3, 4) if backward else (1, 2, 1, 2)
    total = scores * r64(b * h * s * sk) + r64(stats * b * h * s) + trans * r64(b * h * d * sk)
    return total + (rows * r64(b * s * h * (-(-d // 4) * 4)) if padded else 0)


def _wide_padded(dtype: torch.dtype, d: int, *tensors) -> bool:
    """Whether the wide kernels copy the rows first: TMA reads them in place
    where D values of `dtype` are a multiple of 16 bytes and every base is
    16-byte aligned."""
    return d * dtype.itemsize % 16 != 0 or any(t.data_ptr() % 16 for t in tensors)


def _wide_workspace(dtype: torch.dtype):
    """The workspace count of the dtype's wide kernels."""
    return wide_f32_workspace_floats if dtype == torch.float32 else wide_workspace_floats


def _wide_slices(dtype: torch.dtype, backward: bool, b: int, s: int, h: int, d: int,
                 padded: bool) -> list[tuple[int, int]]:
    """The batch slices of the dtype's wide kernels: _batch_slices at the
    workspace of one batch row."""
    return _batch_slices(b, 4 * _wide_workspace(dtype)(backward, 1, s, h, d, padded))


_FORWARD = {"wgmma": ("rrt_mha_fwd", "mha_kernel_launches"),
            "generic": ("rrt_mha_generic", "mha_generic_kernel_launches")}  # route -> entry, counter


def _launch_wide(q, k, v, key_bias, g, b, s, h, d, outs) -> None:
    """The wide kernels' forward (g None: outs = (out,)) or backward (outs =
    (dq, dk, dv)) on CUDA tensors, by workspace slices, one workspace
    reused by each slice in turn: bf16/f16 csrc/mha_wide.cu /
    csrc/mha_wide_bwd.cu (their C entries take the dtype and the rows'
    head stride), f32 csrc/mha_wide_f32.cu (whose forward reads q and k by
    TMA, v through its transpose)."""
    backward, f32 = g is not None, q.dtype == torch.float32
    reads = (q, k, v, g) if backward else (q, k) if f32 else (q, k, v)
    padded = _wide_padded(q.dtype, d, *reads)
    slices = _wide_slices(q.dtype, backward, b, s, h, d, padded)
    n = max(b1 - b0 for b0, b1 in slices)
    ws = torch.empty(_wide_workspace(q.dtype)(backward, n, s, h, d, padded),
                     dtype=torch.float32, device=q.device)
    entry_name = "rrt_mha_wide" + ("_f32" if f32 else "") + ("_bwd" if backward else "")
    entry = getattr(kernels.load(), entry_name)
    counter = (BACKWARD_COUNTERS[backward_route(q.dtype, d, s)] if backward else
               "mha_wide_f32_kernel_launches" if f32 else "mha_wide_kernel_launches")
    head, tail = ((), (d, int(padded))) if f32 else ((_DTYPE_CODE[q.dtype],), (d, d, int(padded)))
    ins = (q, k, v, key_bias, g) if backward else (q, k, v, key_bias)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for b0, b1 in slices:
            ptrs = [t[b0:b1].data_ptr() for t in (*ins, *outs)]
            err = entry(*head, *ptrs, ws.data_ptr(), b1 - b0, s, h, *tail, stream)
            kernels.check_launch(entry_name[4:], err, f"B={b1 - b0} (rows {b0}-{b1} of {b}) "
                                 f"S={s} H={h} D={d} {q.dtype}")
            with _count_lock:
                globals()[counter] += 1


def _launch(q, k, v, key_bias, num_heads: int) -> torch.Tensor:
    b, s, h, d = _check_kernel_args(q, k, v, key_bias, num_heads)
    route = kernel_route(q.dtype, d, s)
    out = torch.empty_like(q)
    if route == "wide":
        _launch_wide(q, k, v, key_bias, None, b, s, h, d, (out,))
        return out
    if route == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:  # TMA's global address
                raise ValueError(f"mha_kernel: {name} must be 16-byte aligned")
    entry_name, counter = _FORWARD[route]
    entry = getattr(kernels.load(), entry_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for b0, b1 in _batch_slices(b):
            ptrs = [t[b0:b1].data_ptr() for t in (q, k, v, key_bias, out)]
            err = entry(_DTYPE_CODE[q.dtype], *ptrs, b1 - b0, s, h, d, stream)
            kernels.check_launch(entry_name[4:], err,
                                 f"B={b1 - b0} (rows {b0}-{b1} of {b}) S={s} H={h} D={d} {q.dtype}")
            with _count_lock:
                globals()[counter] += 1
    return out


def _launch_bwd(q, k, v, key_bias, g, num_heads: int):
    """csrc/mha_bwd.cu on CUDA tensors: (dq, dk, dv) of attention at (q, k,
    v, key_bias) against the upstream gradient `g` (contiguous, q's dtype
    and shape); past D = 256 the wide kernels (_launch_wide:
    csrc/mha_wide_bwd.cu for bf16/f16, csrc/mha_wide_f32.cu for f32).
    Launches on torch.cuda.current_stream(), by batch slices of at most
    MAX_GRID_BATCH rows; raises if a launch fails, never falls back to the
    reference."""
    b, s, h, d = _check_kernel_args(q, k, v, key_bias, num_heads)
    route = backward_route(q.dtype, d, s)
    if g.device != q.device or g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError(f"mha_bwd: g must be {q.dtype} of shape {tuple(q.shape)} on "
                         f"{q.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("mha_bwd: g must be contiguous")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if route in ("wide", "wide_tf32"):
        _launch_wide(q, k, v, key_bias, g, b, s, h, d, (dq, dk, dv))
        return dq, dk, dv
    entry = kernels.load().rrt_mha_bwd
    # m, 1/l, Delta of each query row, reused by each slice in turn
    slices = _batch_slices(b)
    n = max(b1 - b0 for b0, b1 in slices)
    ws = torch.empty(3 * n * h * s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for b0, b1 in slices:
            ptrs = [t[b0:b1].data_ptr() for t in (q, k, v, key_bias, g, dq, dk, dv)]
            err = entry(_DTYPE_CODE[q.dtype], *ptrs, ws.data_ptr(), b1 - b0, s, h, d, stream)
            kernels.check_launch("mha_bwd", err, f"B={b1 - b0} (rows {b0}-{b1} of {b}) "
                                 f"S={s} H={h} D={d} {q.dtype} ({route} route)")
            with _count_lock:
                globals()[BACKWARD_COUNTERS[route]] += 1
    return dq, dk, dv


class MhaKernelFn(torch.autograd.Function):
    """The kernel's forward and the backward kernel (csrc/mha_bwd.cu) as
    one autograd node; CPU tensors take mha_backward_reference."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads):
        ctx.save_for_backward(q, k, v, key_bias)
        ctx.num_heads = num_heads
        return _launch(q, k, v, key_bias, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias = ctx.saved_tensors
        # g may be expanded (stride 0) or a view: the kernel reads it dense
        fn = _launch_bwd if q.is_cuda else mha_backward_reference
        dq, dk, dv = fn(q, k, v, key_bias, g.contiguous(), ctx.num_heads)
        return dq, dk, dv, None, None


def mha_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The route's CUDA kernel (kernel_route): same contract as
    mha_reference, CUDA tensors only. Launches on
    torch.cuda.current_stream() and raises if the launch fails;
    where grad mode is on and q, k or v requires a gradient, the launch is
    MhaKernelFn's forward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return MhaKernelFn.apply(q, k, v, key_bias, num_heads)
    return _launch(q, k, v, key_bias, num_heads)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_bias: torch.Tensor, num_heads: int,
                        impl: str = "auto") -> torch.Tensor:
    """The towers' attention entry point (see module docstring for impl)."""
    if impl == "reference":
        return mha_reference(q, k, v, key_bias, num_heads)
    if impl == "kernel":
        return mha_kernel(q, k, v, key_bias, num_heads)
    if impl != "auto":
        raise ValueError(f"attn impl must be 'auto', 'kernel' or 'reference', got {impl!r}")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, key_bias, num_heads)
    return mha_kernel(q, k, v, key_bias, num_heads)


def attention_flops(b: int, s: int, h: int, d: int) -> int:
    """QK^T plus PV: 2 * (2*B*H*S*S*D)."""
    return 4 * b * h * s * s * d


def attention_bytes(b: int, s: int, h: int, d: int, itemsize: int) -> int:
    """q, k, v read and out written once, plus the f32 bias."""
    return 4 * b * s * h * d * itemsize + 4 * b * s


def attention_backward_flops(b: int, s: int, h: int, d: int) -> int:
    """The five products the backward needs (Q K^T again, dV, dP, dQ, dK):
    2.5 times attention_flops."""
    return 10 * b * h * s * s * d


def attention_backward_bytes(b: int, s: int, h: int, d: int, itemsize: int) -> int:
    """q, k, v and the upstream gradient read and dq, dk, dv written once,
    plus the f32 bias."""
    return 7 * b * s * h * d * itemsize + 4 * b * s
