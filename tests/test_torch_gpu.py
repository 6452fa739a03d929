"""The CUDA kernels (fused attention, packed and unpacked BM25, the fused
stage-A tile pass) against their plain torch versions, on the card.

Needs an NVIDIA Hopper GPU with nvcc; every test skips where
torch.cuda.is_available() is false. The file imports no jax, so on a
machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Attention: tolerance 2e-2 in bf16/f16 (tests/test_attention.py's bf16
bound) and 1e-5 in f32 (its f32 bound: the generic route's 3xTF32 products,
and full f32 FMA past D = 128, sum in another order than the reference's
einsum); both kernels divide
the exponentials by the f32 row sum before they round the probabilities to
the input type, as the reference does, so a probability differs from the
reference's only where its f32 value lies within an ulp or two of a
rounding boundary. The tensor-core route (bf16/f16 at D = 32, 64, 128) runs
past 512 keys; the generic route takes f32/bf16/f16 at any D from 1 to 256,
the wide route every D past 256 (bf16/f16 csrc/mha_wide.cu and
csrc/mha_wide_bwd.cu, f32 csrc/mha_wide_f32.cu), forward and backward (D
= 257-1,024, S = 1-513, the column chunks each launch reports, the scores
contracted once a row block (the C entries' split), 16-bit rows TMA cannot
read copied first and bit-equal to rows it reads in place, f32 off the
TMA path and by workspace slices, a tower trained through `rrt train
--hidden 384 --head-dim 384`), and a batch past 65,535 rows runs as
launches on slices. BM25: bitwise equal scores (tf_q
sums integers; every other step is rounded alone, in the reference's order).
Stage A: winner scores within 1e-5 (exact bf16/f32 products summed in f32 in
another order than cuBLAS's); a winner id may differ only where the plain
version's scores of the two rows are within that tolerance (a near tie);
rounds past a tile's valid rows are exactly (-3.4e38, 0). Every D >= 1 of
both types runs on the tensor cores (f32 as 3xTF32), the chunk's queries
streamed through the ring (ops/stage_a.py:stage_a_route); each launch
moves its route's counter by one, at the f32 chunk edges (B = 32, 33, 65
at D = 384), at the widths each loader takes (rows of 16-byte multiples by
TMA, others by cp.async or 2-byte loads, in one box or many), past 4,096
and with an all-invalid tile. Serving:
device_fetch reads CUDA tensors through pinned buffers, and both HTTP
front ends answer a /search on a small CUDA engine, encoding on the card.
Offline path: a bundle built, saved and loaded, then the CLI's search on
it on the card. Serving configurations: the int8 scores and pools
(torch._int_mm on padded shapes) bit-equal to the CPU int8 path; ivf_topk
on the card against its CPU run on the same index (scores within 1e-5, ids
equal but for near ties); a bge-small-shaped tower loaded from disk within
2e-2 of its CPU f32 forward. Training: the attention's gradient
(MhaKernelFn: the kernel forward, the backward kernel csrc/mha_bwd.cu)
against mha_backward_reference and autograd through mha_reference within
2e-2 (bf16/f16) and 1e-4 (f32) of max(1, max |ref|) at the trainers'
shapes, a row masked but for one key, and an S off the key tile; the
backward kernel at the pad edges of D, S from 1 to 1,024, every dtype,
and bit-equal from launch to launch; one bf16 ContrastiveTrainer step
against the CPU f32 step from the same init.
Topics: the kNN graph on the card against its CPU path at 5,000 x 384 and
on the duplicate, negative-similarity, ragged-chunk and zero-row cases
(similarities within 1e-5, ids equal but for near ties), also with TF32
turned on by the caller; density labels on the card equal the CPU's on a
well-separated mixture; `rrt topics --device cuda` writes the cards and
aspect metrics of `--device cpu` in both lanes. The raw-review pipeline: the
attention kernel at its embedding jobs' shapes, (256, 512, 12, 32) and
(256, 64, 12, 32), and a 4-shard embedding job resumed after two shards
are deleted and a torn temp file left. The corpus-sharded engine on
["cuda:0"] * 4: bm25_topk through the packed and the unpacked kernel per
shard (4 launches a query) bit-equal to the same engine on ["cpu"] * 4,
the int8 pools and scores bit-equal CPU against card, and query_e2e's
attention launches: the bi-encoder's layers once a query, plus the
cross-encoder's layers once a shard at rr_k > 0 (12 and 12 + 6 * 4 with
bge-small and MiniLM-L6, chip_smoke.py phase 18; 2 and 2 + 2 * 4 here).
The dp x tp trainers on TrainMesh(["cuda:0"] * 4, 2, 2): one bf16 step of
each against the f32 step of the same mesh on the CPU (loss within
2e-2), the attention
kernel once per cell, layer and tower forward (and as many backward
kernel launches),
no host sync in a mesh step, fresh or restored; BiEncoder(devices=
["cuda:0"] * 4) against the one-device encode; the global-scale int8 scan
on the card bit-equal to the CPU.
"""
from pathlib import Path
import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.ops import attention as tatt
from review_recommender_tpu_torch.ops import bm25_kernel as tbk
from review_recommender_tpu_torch.ops import stage_a as tsa
from review_recommender_tpu_torch.ops.bm25 import bm25_full_scores, masked_topk
from review_recommender_tpu_torch.ops.dense import matmul_f32
from tests.torch_bm25_cases import CASES, bm25_edge_case, pack
from tests.torch_stage_a_cases import CASES as STAGE_A_CASES
from tests.torch_stage_a_cases import stage_a_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, s, hd, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, hd)).astype(np.float32))
               .to(device=device, dtype=dtype) for _ in range(3))
    lens = rng.integers(1, s + 1, size=b)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
    if b > 1:
        bias[-1] = -1e30
    return q, k, v, torch.from_numpy(bias).to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,heads,d", [
    (64, 512, 12, 32), (1, 16, 12, 32), (8, 128, 6, 64), (4, 256, 3, 128),
    (3, 40, 2, 32), (2, 1, 4, 64), (2, 511, 1, 128), (5, 100, 3, 64),
    (1, 32, 12, 32), (50, 287, 12, 32),  # query_e2e: encode, then rerank (a ragged key tile)
])
def test_kernel_matches_reference(cuda, dtype, b, s, heads, d):
    q, k, v, bias = _inputs(b * 1000 + s, b, s, heads * d, dtype, cuda)
    before = tatt.mha_kernel_launches
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert tatt.mha_kernel_launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_all_masked_row_is_uniform(cuda, dtype, d):
    """A batch-bucket padding row (every key bias -1e30) averages V's first
    S rows: the padding keys from S to the key-tile edge get nothing."""
    b, s, heads = 2, 100, 3
    q, k, v, _ = _inputs(d + s, b, s, heads * d, dtype, cuda)
    bias = torch.zeros(b, s, device=cuda)
    bias[1] = -1e30
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
    torch.cuda.synchronize()
    mean_v = v[1].float().mean(dim=0)  # (H*D,)
    err = (got[1].float() - mean_v[None, :]).abs().max().item()
    assert err <= 2e-2, err


@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_at_key_tile_edges(cuda, s, d):
    """S just below, at and above a 64-key tile edge (and the query tile's)."""
    b, heads = 3, 2
    q, k, v, bias = _inputs(s * 7 + d, b, s, heads * d, torch.bfloat16, cuda)
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def test_kernel_matches_sdpa_at_rerank_shape(cuda):
    """A second opinion: scaled_dot_product_attention with the key bias as
    an additive mask, at the cross-encoder's rerank shape."""
    b, s, heads, d = 64, 512, 12, 32
    q, k, v, bias = _inputs(7, b, s, heads * d, torch.bfloat16, cuda)
    split = lambda t: t.view(b, s, heads, d).transpose(1, 2)
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        lib = torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=bias[:, None, None, :].to(q.dtype))
    torch.cuda.synchronize()
    lib = lib.transpose(1, 2).reshape(b, s, heads * d)
    err = (got.float() - lib.float()).abs().max().item()
    assert err <= 2e-2, err


def _launches():
    return tatt.mha_kernel_launches, tatt.mha_generic_kernel_launches


def _wide_counts():
    """The wide forward's calls: csrc/mha_wide.cu (bf16/f16), csrc/mha_wide_f32.cu (f32)."""
    return tatt.mha_wide_kernel_launches, tatt.mha_wide_f32_kernel_launches


def test_kernel_rejects_what_it_does_not_take(cuda):
    """D = 16, f32 and S = 513, refused by the first kernel, now run (the
    generic route, the generic route, the tensor-core route past 512 keys),
    and so does a head wider than 256, refused before the wide route (one
    launch of csrc/mha_wide.cu); a non-contiguous input is refused."""
    q, k, v, bias = _inputs(0, 2, 16, 4 * 32, torch.bfloat16, cuda)
    for args, heads, tol, route in (((q, k, v), 8, 2e-2, "generic"),  # D = 16
                                    ((q.float(), k.float(), v.float()), 4, 1e-5, "generic")):
        before = _launches()
        with torch.inference_mode():
            got = tatt.mha_kernel(*args, bias, heads)
            ref = tatt.mha_reference(*args, bias, heads)
        torch.cuda.synchronize()
        assert got.dtype == args[0].dtype
        assert (got.float() - ref.float()).abs().max().item() <= tol
        assert _launches() == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.mha_kernel(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, bias, 4)
    long_q, long_b = _inputs(1, 1, 513, 64, torch.bfloat16, cuda)[0], torch.zeros(1, 513, device=cuda)
    before = _launches()
    with torch.inference_mode():
        got = tatt.mha_kernel(long_q, long_q, long_q, long_b, 2)
        ref = tatt.mha_reference(long_q, long_q, long_q, long_b, 2)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert _launches() == (before[0] + 1, before[1])
    wide = _inputs(2, 1, 4, 257, torch.bfloat16, cuda)[0]
    wide_launches = tatt.mha_wide_kernel_launches
    with torch.inference_mode():
        got = tatt.mha_kernel(wide, wide, wide, torch.zeros(1, 4, device=cuda), 1)
        ref = tatt.mha_reference(wide, wide, wide, torch.zeros(1, 4, device=cuda), 1)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert tatt.mha_wide_kernel_launches == wide_launches + 1
    assert _launches() == (before[0] + 1, before[1])
    qg = q.clone().requires_grad_(True)
    launches, backward = tatt.mha_kernel_launches, _bwd_launches()
    tatt.mha_kernel(qg, k, v, bias, 4).float().sum().backward()  # an expanded (stride 0) g
    torch.cuda.synchronize()
    assert qg.grad is not None and torch.isfinite(qg.grad.float()).all()
    assert tatt.mha_kernel_launches == launches + 1
    assert _bwd_launches() == _bwd_plus(backward, "wgmma")
    want = tatt.mha_backward_reference(q, k, v, bias, torch.ones_like(q), 4)[0]
    assert (qg.grad.float() - want.float()).abs().max().item() <= 2e-2 * max(
        1.0, want.float().abs().max().item())


BWD_ROUTES = ("wgmma", "tf32", "wide", "wide_tf32")


def _bwd_launches():
    """The backward kernels' launches by route (BWD_ROUTES' order)."""
    return tuple(getattr(tatt, tatt.BACKWARD_COUNTERS[r]) for r in BWD_ROUTES)


def _bwd_plus(counts, route, n=1):
    """`counts` (of _bwd_launches) with n more launches of `route`."""
    return tuple(c + n * (r == route) for c, r in zip(counts, BWD_ROUTES))


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _check_grads(got, refs, dtype, what):
    """Each of the kernel's q, k, v gradients within BWD_TOL of
    max(1, max |ref|) of each reference's."""
    for ref_name, ref in refs.items():
        for name, x, r in zip("qkv", got, ref):
            x, r = x.float(), r.float()
            assert torch.isfinite(x).all(), (what, name)
            err = (x - r).abs().max().item()
            assert err <= BWD_TOL[dtype] * max(1.0, r.abs().max().item()), (what, ref_name, name, err)


def _grads_three_ways(q, k, v, bias, heads, g):
    """(outputs, grads) of multihead_attention with impl "auto" (the kernel
    forward and the backward kernel) and "reference" (autograd through
    mha_reference), and mha_backward_reference's gradients, on the same
    CUDA tensors."""
    outs, grads = [], []
    for impl in ("auto", "reference"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tatt.multihead_attention(*leaves, bias, heads, impl=impl)
        out.backward(g)
        outs.append(out.detach().float())
        grads.append([t.grad for t in leaves])
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    return outs, grads[0], {"autograd": grads[1], "plain": plain}


def _masked_but_one(bias):
    """Row 0: every key masked but one (key 1, or key 0 where S = 1)."""
    bias = bias.clone()
    bias[0] = -1e30
    bias[0, min(1, bias.shape[1] - 1)] = 0.0
    return bias


GENERIC_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _check_generic(q, k, v, bias, heads):
    """One generic launch, none of the tensor-core one; within the route's
    tolerance of mha_reference; batch row 2 (all keys masked) the mean of
    its V rows."""
    dtype = q.dtype
    before = _launches()
    with torch.inference_mode():
        got = tatt.multihead_attention(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= GENERIC_TOL[dtype], err
    mean_v = v[2].float().mean(dim=0)
    assert (got[2].float() - mean_v[None, :]).abs().max().item() <= 2 * GENERIC_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [8, 16, 26, 50, 96, 129, 192, 193, 256])
@pytest.mark.parametrize("s", [1, 63, 65, 287, 1024])
def test_generic_kernel_matches_reference(cuda, dtype, d, s):
    """The generic route (csrc/mha_generic.cu) against mha_reference: row 0
    masked but one key, row 2 every key masked (uniform over the S keys),
    row 1 a random length; one launch of the generic kernel, none of the
    tensor-core one."""
    b, heads = 3, 2
    q, k, v, bias = _inputs(d * 7919 + s, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    assert tatt.kernel_route(dtype, d, s) == "generic"
    _check_generic(q, k, v, bias, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [1, 15, 17, 31, 33, 127, 129, 192, 193, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 600, 1024])
def test_generic_kernel_at_pipeline_edges(cuda, dtype, d, s):
    """The generic kernel's edges: S at and past one 64-key tile and over
    three or more tiles (the 2-stage ring of key tiles wraps; above D = 128
    in bf16/f16 two warpgroups of 64 query rows share it, the second with
    no real row at S <= 64); D at the pad boundaries of its
    16/32/64/128/192/256-wide tiles (two warpgroups sharing the ring past
    128 in every dtype, f32 on 16-key tiles split in registers). Row 0
    masked but one key, row 2 every key masked
    (uniform over the S keys); one generic launch."""
    b, heads = 3, 2
    q, k, v, bias = _inputs(d * 131 + s, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    assert tatt.kernel_route(dtype, d, s) == "generic"
    _check_generic(q, k, v, bias, heads)


@pytest.mark.parametrize("dtype,d,offset", [
    (torch.float16, 25, 0),  # 50-byte heads: 2-byte alignment only, element loads
    (torch.bfloat16, 26, 0),  # 4-byte copies
    (torch.float32, 26, 0),  # 8-byte copies
    (torch.float32, 32, 1), (torch.float32, 32, 2),  # q, k, v 4 / 8 bytes into a line
    (torch.bfloat16, 40, 1),  # 16-byte heads, 2 bytes in: element loads
    (torch.bfloat16, 48, 4),  # 8 bytes in: 8-byte copies
    (torch.float16, 129, 0),  # 258-byte heads past 128: element loads
    (torch.bfloat16, 200, 4),  # 400-byte heads, 8 bytes in: 8-byte copies
])
def test_generic_kernel_copy_granules(cuda, dtype, d, offset):
    """Each copy width of the generic kernel's loads, which the head's byte
    width and the tensors' addresses decide: q, k and v are views that
    start `offset` elements into their storage."""
    b, s, heads = 3, 100, 2
    _q, _k, _v, bias = _inputs(d + offset, b, s, heads * d, dtype, cuda)
    rng = np.random.default_rng(offset * 1000 + d)
    n = b * s * heads * d

    def shifted():
        buf = torch.from_numpy(rng.standard_normal(n + offset).astype(np.float32))
        return buf.to(device=cuda, dtype=dtype)[offset:].view(b, s, heads * d)

    q, k, v = shifted(), shifted(), shifted()
    assert q.is_contiguous() and q.storage_offset() == offset
    _check_generic(q, k, v, _masked_but_one(bias), heads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [513, 1024, 2048])
def test_wgmma_kernel_past_512_keys(cuda, dtype, d, s):
    """The tensor-core route past the first kernel's 512 keys (its key bias
    now read a tile at a time), a row masked but one and an all-masked row
    included."""
    b, heads = 3, 2
    q, k, v, bias = _inputs(s + d, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    before = _launches()
    with torch.inference_mode():
        got = tatt.multihead_attention(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1])
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,heads,d", [
    (32, 128, 12, 32), (64, 96, 4, 64), (8, 256, 12, 32),  # bi-encoder, lane, cross-encoder
    (3, 100, 2, 128),  # S not a multiple of the 64-key tile
])
def test_gradients_match_autograd_through_the_reference(cuda, dtype, b, s, heads, d):
    """MhaKernelFn (the kernel forward, the backward kernel) through
    multihead_attention against mha_backward_reference and autograd through
    mha_reference on the same CUDA tensors: the output within 2e-2, the q,
    k, v gradients within 2e-2 of max(1, max |ref|), one forward launch and
    one backward launch on the tensor-core route, a row with every key
    masked but one included."""
    q, k, v, bias = _inputs(b + s + d, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(s),
                    device=cuda).to(dtype)
    launches, backward = tatt.mha_kernel_launches, _bwd_launches()
    outs, got, refs = _grads_three_ways(q, k, v, bias, heads, g)
    assert tatt.mha_kernel_launches == launches + 1
    assert _bwd_launches() == _bwd_plus(backward, "wgmma")
    assert (outs[0] - outs[1]).abs().max().item() <= 2e-2
    _check_grads(got, refs, dtype, (b, s, heads, d))


@pytest.mark.parametrize("dtype,b,s,heads,d", [
    (torch.float32, 8, 128, 12, 32),  # an f32 bi-encoder step's shape
    (torch.float32, 2, 600, 4, 16),
    (torch.bfloat16, 4, 70, 12, 26),  # TinyBERT-4L-312D's heads
    (torch.float16, 3, 40, 2, 50),
    (torch.bfloat16, 4, 70, 2, 192),  # bge-small's width in 2 heads
    (torch.float16, 3, 40, 1, 256),
    (torch.float32, 4, 70, 2, 192),  # the same in f32: the split-in-registers instances
    (torch.float32, 3, 40, 1, 256),
])
def test_gradients_through_the_generic_route(cuda, dtype, b, s, heads, d):
    """MhaKernelFn on the generic route: the forward is the generic kernel,
    the backward the backward kernel's route for the dtype and width (3xTF32
    for f32, wgmma for bf16/f16, at every D), held to
    mha_backward_reference and autograd through mha_reference on the same
    inputs (within 1e-4 in f32, 2e-2 in bf16/f16, of max(1, max |ref|)),
    and the output within the forward's tolerance."""
    q, k, v, bias = _inputs(b * s + d, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d),
                    device=cuda).to(dtype)
    before, backward = _launches(), _bwd_launches()
    outs, got, refs = _grads_three_ways(q, k, v, bias, heads, g)
    assert _launches() == (before[0], before[1] + 1)
    assert _bwd_launches() == _bwd_plus(backward, tatt.backward_route(dtype, d, s))
    assert (outs[0] - outs[1]).abs().max().item() <= GENERIC_TOL[dtype]
    _check_grads(got, refs, dtype, (b, s, heads, d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d", [1, 15, 17, 31, 33, 127, 129, 192, 193, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 600, 1024])
def test_backward_kernel_edge_cases(cuda, dtype, d, s):
    """The backward kernel alone (_launch_bwd) at the pad edges of D (each
    wgmma instance's, to DP = 256 with kernel B's columns in chunks past
    128, and each 3xTF32 instance's, to DP = 256 with two warpgroups a CTA
    past 128), S at and around
    the 64-row tiles (kernel A's 32-key tiles past D = 128), past 512 keys
    and S = 1, in every dtype: its q, k, v
    gradients against mha_backward_reference and autograd through
    mha_reference. Row 0 is masked but for one key (P = 1: dS = 0 exactly
    in the reference), the last row fully masked (the batch-bucket padding
    row: P = 1/S, gradients flowing uniformly), keys past S in a tile give
    P = 0, query rows past S in a tile add nothing to dK and dV."""
    b, heads = 3, 2 if d < 128 else 1
    q, k, v, bias = _inputs(7 * s + d, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(s + d),
                    device=cuda).to(dtype)
    backward = _bwd_launches()
    got = tatt._launch_bwd(q, k, v, bias, g, heads)
    assert _bwd_launches() == _bwd_plus(backward, tatt.backward_route(dtype, d, s))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tatt.mha_reference(*leaves, bias, heads).backward(g)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    _check_grads(got, {"autograd": [t.grad for t in leaves], "plain": plain}, dtype, (s, d))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32), (torch.float16, 26),
                                     (torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 200), (torch.float32, 200)])
def test_backward_kernel_is_deterministic(cuda, dtype, d):
    """Two backward launches on the same inputs give bit-equal gradients
    (no atomics: kernel A writes dQ and the row statistics, kernel B dK and
    dV, each element by one thread), on every route: wgmma (bf16 at 32,
    f16 at 26, bf16 at 200 with kernel B's columns in chunks) and tf32 (f32
    at 64, 128 in two column halves, and 200 on the instance at 256
    columns, two warpgroups a CTA that hand the probabilities from one to
    the other through shared memory)."""
    q, k, v, bias = _inputs(d, 4, 300, 4 * d, dtype, cuda)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d),
                    device=cuda).to(dtype)
    first = tatt._launch_bwd(q, k, v, bias, g, 4)
    second = tatt._launch_bwd(q, k, v, bias, g, 4)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("d,dp", [(129, 192), (160, 192), (192, 192), (193, 256), (256, 256)])
def test_f32_wide_heads_launch_the_tensor_core_instances(cuda, d, dp):
    """f32 at head widths 129-256 runs on the tensor cores, forward and
    backward: the C entries report the padded width of the mha_tc_kernel /
    3xTF32 instance each launch ran (padded_head_dim), the launch counters
    name the generic kernel and the tf32 backward route, and nothing else
    is launched."""
    from review_recommender_tpu_torch import kernels

    b, s, heads = 2, 70, 2
    q, k, v, bias = _inputs(d, b, s, heads * d, torch.float32, cuda)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda)
    lib = kernels.load()
    assert tatt.padded_head_dim(d) == dp
    assert tatt.kernel_route(torch.float32, d, s) == "generic"
    assert tatt.backward_route(torch.float32, d, s) == "tf32"
    before, backward = _launches(), _bwd_launches()
    with torch.inference_mode():
        tatt.mha_kernel(q, k, v, bias, heads)
    assert lib.rrt_mha_generic_last_dp() == dp
    tatt._launch_bwd(q, k, v, bias, g, heads)
    assert lib.rrt_mha_bwd_last_dp() == dp
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1)
    assert _bwd_launches() == _bwd_plus(backward, "tf32")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d", [257, 320, 384, 511, 512, 1024])
@pytest.mark.parametrize("s", [1, 63, 65, 513])
def test_wide_kernels_match_the_plain_versions(cuda, dtype, d, s):
    """The wide route past 256 columns (bf16/f16: csrc/mha_wide.cu forward,
    csrc/mha_wide_bwd.cu backward; f32: csrc/mha_wide_f32.cu both ways)
    against mha_reference and mha_backward_reference: the output within
    2e-2 (bf16/f16) / 1e-5 (f32), the all-masked row (batch row 2) uniform
    over the S keys, the gradients within 2e-2 / 1e-4 of max(1, max |ref|)
    of the plain version and of autograd through mha_reference (row 0
    masked but one key); one call of the dtype's wide kernels each way,
    none of another, and the column chunks the C entries report are
    wide_column_chunks'."""
    from review_recommender_tpu_torch import kernels

    b, heads = 3, 2 if d <= 512 else 1
    q, k, v, bias = _inputs(d * 17 + s, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d + s),
                    device=cuda).to(dtype)
    assert tatt.kernel_route(dtype, d, s) == "wide"
    route = tatt.backward_route(dtype, d, s)
    before, wide, backward = _launches(), _wide_counts(), _bwd_launches()
    with torch.inference_mode():
        got = tatt.multihead_attention(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    grads = tatt._launch_bwd(q, k, v, bias, g, heads)
    lib = kernels.load()
    f32 = dtype == torch.float32
    chunks = ((lib.rrt_mha_wide_f32_dc(),) * 3 if f32 else
              (lib.rrt_mha_wide_last_dc(), lib.rrt_mha_wide_bwd_last_dc(0),
               lib.rrt_mha_wide_bwd_last_dc(1)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tatt.mha_reference(*leaves, bias, heads).backward(g)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    assert chunks == tatt.wide_column_chunks(dtype, d)
    assert _launches() == before and _wide_counts() == (wide[0] + (not f32), wide[1] + f32)
    assert _bwd_launches() == _bwd_plus(backward, route)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - ref.float()).abs().max().item() <= GENERIC_TOL[dtype]
    mean_v = v[2].float().mean(dim=0)
    assert (got[2].float() - mean_v[None, :]).abs().max().item() <= 2 * GENERIC_TOL[dtype]
    _check_grads(grads, {"autograd": [t.grad for t in leaves], "plain": plain}, dtype, (d, s))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_route_through_autograd(cuda, dtype):
    """MhaKernelFn at one head of 384: the forward is the dtype's wide
    kernels, the backward the wide backward's route, held to autograd
    through mha_reference and mha_backward_reference."""
    b, s, heads, d = 4, 70, 1, 384
    q, k, v, bias = _inputs(b * s + d, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d),
                    device=cuda).to(dtype)
    wide, backward = _wide_counts(), _bwd_launches()
    outs, got, refs = _grads_three_ways(q, k, v, bias, heads, g)
    f32 = dtype == torch.float32
    assert _wide_counts() == (wide[0] + (not f32), wide[1] + f32)
    assert _bwd_launches() == _bwd_plus(backward, tatt.backward_route(dtype, d, s))
    assert (outs[0] - outs[1]).abs().max().item() <= GENERIC_TOL[dtype]
    _check_grads(got, refs, dtype, (b, s, heads, d))


def test_wide_16bit_kernels_contract_the_scores_once_by_tma(cuda):
    """bf16 past 256 columns (csrc/mha_wide.cu, csrc/mha_wide_bwd.cu) at
    (2, 512, 1, 384): one forward and one backward call contract each
    64 x 64 tile of S (and of dP) once, counted by the score kernels
    themselves (rrt_mha_wide_score_tiles, rrt_mha_wide_bwd_score_tiles:
    2 * 8 * 8 tiles each, as wide_split's once and the C entries' tiles of
    a contraction say); the stored tiles are read back by the CTAs
    wide_split counts, in wide_column_chunks' chunks, the own rows resident
    and the rows read in place by TMA; the workspace the C entry counts is
    ops/attention.py's."""
    from review_recommender_tpu_torch import kernels

    b, s, heads, d = 2, 512, 1, 384
    tiles = b * heads * (s // 64) ** 2
    q, k, v, bias = _inputs(23, b, s, heads * d, torch.bfloat16, cuda)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(torch.bfloat16)
    lib = kernels.load()
    split = tatt.wide_split(torch.bfloat16, d)
    fwd_dc, dq_dc, dkv_dc = tatt.wide_column_chunks(torch.bfloat16, d)
    assert not tatt._wide_padded(torch.bfloat16, d, q, k, v, g)
    torch.cuda.synchronize()
    for take in (lib.rrt_mha_wide_score_tiles, lambda: lib.rrt_mha_wide_bwd_score_tiles(0),
                 lambda: lib.rrt_mha_wide_bwd_score_tiles(1)):
        assert take() >= 0  # the counts start from zero here
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert lib.rrt_mha_wide_score_tiles() == split[0][0] * tiles
    assert tuple(lib.rrt_mha_wide_last_split(i) for i in range(3)) == (tiles, split[0][1], 1)
    assert lib.rrt_mha_wide_last_dc() == fwd_dc and lib.rrt_mha_wide_last_resident() == 1
    grads = tatt._launch_bwd(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    assert lib.rrt_mha_wide_bwd_score_tiles(0) == split[1][0] * tiles
    assert lib.rrt_mha_wide_bwd_score_tiles(1) == split[2][0] * tiles
    assert lib.rrt_mha_wide_score_tiles() == 0  # the backward's count is its own
    for kernel, want in ((0, split[1]), (1, split[2])):
        assert tuple(lib.rrt_mha_wide_bwd_last_split(kernel, i) for i in range(3)) == \
            (tiles, want[1], 1)
    assert (lib.rrt_mha_wide_bwd_last_dc(0), lib.rrt_mha_wide_bwd_last_dc(1)) == (dq_dc, dkv_dc)
    assert lib.rrt_mha_wide_bwd_last_resident() == 1
    ref = tatt.mha_reference(q, k, v, bias, heads)
    assert (got.float() - ref.float()).abs().max().item() <= GENERIC_TOL[torch.bfloat16]
    _check_grads(grads, {"plain": tatt.mha_backward_reference(q, k, v, bias, g, heads)},
                 torch.bfloat16, "tma")
    for bb, ss, hh, dd in ((64, 512, 1, 384), (3, 1, 2, 257), (5, 513, 3, 1024), (1, 130, 1, 511)):
        for backward in (0, 1):
            for padded in (0, 1):
                assert lib.rrt_mha_wide_ws_floats(backward, bb, ss, hh, dd, padded) == \
                    tatt.wide_workspace_floats(bool(backward), bb, ss, hh, dd, bool(padded))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["misaligned", "sliced"])
def test_wide_16bit_kernels_off_the_tma_path_and_by_slices(cuda, monkeypatch, dtype, case):
    """csrc/mha_wide.cu and csrc/mha_wide_bwd.cu at (5, 65, 1, 384) where
    TMA cannot read the rows in place (a base 2 bytes off 16: the copy
    path) and with the batch sliced by a small monkeypatched workspace cap
    (two forward rows: the forward in slices of 2, 2 and 1 rows, the
    backward, whose row takes more, one row a slice; one workspace reused
    by each slice): within 2e-2 of the plain versions, one call a slice on
    each counter, the score kernels contracting each tile of S and dP once
    over the whole batch."""
    from review_recommender_tpu_torch import kernels

    b, s, heads, d = 5, 65, 1, 384
    q, k, v, bias = _inputs(len(case) + 7, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(11),
                    device=cuda).to(dtype)
    if case == "misaligned":  # contiguous views one value into their buffers
        q, k, v, g = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
                      for t in (q, k, v, g))
        assert all(t.data_ptr() % 16 == 2 for t in (q, k, v, g))
    n_fwd = n_bwd = 1
    if case == "sliced":
        row = 4 * tatt.wide_workspace_floats(False, 1, s, heads, d, False)
        monkeypatch.setattr(tatt, "WIDE_WORKSPACE_BYTES", 2 * row)
        n_fwd, n_bwd = 3, 5
    assert tatt._wide_padded(dtype, d, q, k, v, g) == (case == "misaligned")
    lib = kernels.load()
    tiles = b * heads * 2 * 2  # two row blocks by two key tiles a (b, h)
    torch.cuda.synchronize()
    for take in (lib.rrt_mha_wide_score_tiles, lambda: lib.rrt_mha_wide_bwd_score_tiles(0),
                 lambda: lib.rrt_mha_wide_bwd_score_tiles(1)):
        assert take() >= 0
    wide, backward = _wide_counts(), _bwd_launches()
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert lib.rrt_mha_wide_last_split(2) == (case != "misaligned")
    grads = tatt._launch_bwd(q, k, v, bias, g, heads)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    assert _wide_counts() == (wide[0] + n_fwd, wide[1])
    assert _bwd_launches() == _bwd_plus(backward, "wide", n_bwd)
    assert lib.rrt_mha_wide_score_tiles() == tiles
    assert (lib.rrt_mha_wide_bwd_score_tiles(0), lib.rrt_mha_wide_bwd_score_tiles(1)) == \
        (tiles, tiles)
    assert (got.float() - ref.float()).abs().max().item() <= GENERIC_TOL[dtype]
    _check_grads(grads, {"plain": plain}, dtype, case)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [257, 511])
def test_wide_16bit_copy_path_equals_rows_tma_reads_in_place(cuda, dtype, d):
    """D * 2 bytes not a multiple of 16: the 16-bit wide kernels copy the
    rows into rows of D rounded up to 8 and read those by TMA; the same
    values placed by the caller in such rows (head stride 264 / 512, read
    in place) give bit-equal outputs and gradients through the C entries,
    and the entries report the copy path for the first and TMA in place
    for the second; the copy path's results are within the route's
    tolerance of the plain versions."""
    from review_recommender_tpu_torch import kernels

    b, s, heads = 3, 70, 2
    q, k, v, bias = _inputs(d + 3, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d),
                    device=cuda).to(dtype)
    lib = kernels.load()
    code = {torch.bfloat16: 0, torch.float16: 1}[dtype]
    ld = -(-d // 8) * 8
    placed = []
    for t in (q, k, v, g):
        p = torch.zeros(b, s, heads, ld, dtype=dtype, device=cuda)
        p[..., :d] = t.view(b, s, heads, d)
        placed.append(p)
    assert tatt._wide_padded(dtype, d, q, k, v, g)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.inference_mode():
        copied = tatt.mha_kernel(q, k, v, bias, heads)
        torch.cuda.synchronize()
        assert lib.rrt_mha_wide_last_split(2) == 0
        in_place = torch.empty_like(q)
        ws = torch.empty(tatt.wide_workspace_floats(False, b, s, heads, d, False),
                         dtype=torch.float32, device=cuda)
        err = lib.rrt_mha_wide(code, *(t.data_ptr() for t in placed[:3]), bias.data_ptr(),
                               in_place.data_ptr(), ws.data_ptr(), b, s, heads, d, ld, 0, stream)
        torch.cuda.synchronize()
        assert err == 0 and lib.rrt_mha_wide_last_split(2) == 1
        assert torch.equal(copied, in_place)
        grads = tatt._launch_bwd(q, k, v, bias, g, heads)
        torch.cuda.synchronize()
        assert lib.rrt_mha_wide_bwd_last_split(0, 2) == 0
        outs = [torch.empty_like(q) for _ in range(3)]
        ws = torch.empty(tatt.wide_workspace_floats(True, b, s, heads, d, False),
                         dtype=torch.float32, device=cuda)
        err = lib.rrt_mha_wide_bwd(code, *(t.data_ptr() for t in placed[:3]), bias.data_ptr(),
                                   placed[3].data_ptr(), *(t.data_ptr() for t in outs),
                                   ws.data_ptr(), b, s, heads, d, ld, 0, stream)
        torch.cuda.synchronize()
        assert err == 0 and lib.rrt_mha_wide_bwd_last_split(0, 2) == 1
        assert all(torch.equal(x, y) for x, y in zip(grads, outs))
        ref = tatt.mha_reference(q, k, v, bias, heads)
    assert (copied.float() - ref.float()).abs().max().item() <= GENERIC_TOL[dtype]
    _check_grads(grads, {"plain": tatt.mha_backward_reference(q, k, v, bias, g, heads)}, dtype, d)


@pytest.mark.parametrize("s", [1, 33, 64, 65, 511, 513])
@pytest.mark.parametrize("d", [257, 320, 384, 511, 1024])
def test_wide_f32_kernels_compute_the_scores_once(cuda, d, s):
    """f32 past 256 columns (csrc/mha_wide_f32.cu: S and dP contracted
    once into the workspace, the outputs and gradients from them) against
    the plain versions: the output within 1e-5 of mha_reference, the
    all-masked row (batch row 2) uniform over the S keys, row 0 masked but
    one key, the gradients within 1e-4 of max(1, max |ref|) of
    mha_backward_reference; one call each way on the f32 counters, no
    other kernel."""
    b, heads = 3, 2 if d <= 512 else 1
    q, k, v, bias = _inputs(d * 7 + s, b, s, heads * d, torch.float32, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d * s),
                    device=cuda)
    before, wide, backward = _launches(), _wide_counts(), _bwd_launches()
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    grads = tatt._launch_bwd(q, k, v, bias, g, heads)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    assert _launches() == before and _wide_counts() == (wide[0], wide[1] + 1)
    assert _bwd_launches() == _bwd_plus(backward, "wide_tf32")
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5
    assert (got[2] - v[2].mean(dim=0)[None, :]).abs().max().item() <= 2e-5
    _check_grads(grads, {"plain": plain}, torch.float32, (d, s))


@pytest.mark.parametrize("case", ["odd_width", "misaligned", "sliced"])
def test_wide_f32_kernels_off_the_tma_path_and_by_slices(cuda, monkeypatch, case):
    """csrc/mha_wide_f32.cu where TMA cannot read the rows in place (H * D
    = 771: rows of 1,028 bytes; a base 4 bytes off 16) and with the batch
    sliced by a small monkeypatched workspace cap (two forward rows: the
    forward in slices of 2, 2 and 1 rows, the backward, whose row takes
    more, one row a slice): the plain versions' tolerances, one call a
    slice on each counter."""
    b, s, heads, d = (2, 70, 3, 257) if case == "odd_width" else (5, 65, 1, 384)
    q, k, v, bias = _inputs(len(case), b, s, heads * d, torch.float32, cuda)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    if case == "misaligned":  # contiguous views one float into their buffers
        q, k, v, g = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
                      for t in (q, k, v, g))
        assert all(t.data_ptr() % 16 for t in (q, k, v, g))
    n_fwd = n_bwd = 1
    if case == "sliced":
        row = 4 * tatt.wide_f32_workspace_floats(False, 1, s, heads, d, False)
        monkeypatch.setattr(tatt, "WIDE_WORKSPACE_BYTES", 2 * row)
        n_fwd, n_bwd = 3, 5
    assert tatt._wide_padded(torch.float32, d, q, k, v, g) == (case != "sliced")
    wide, backward = _wide_counts(), _bwd_launches()
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    grads = tatt._launch_bwd(q, k, v, bias, g, heads)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    assert _wide_counts() == (wide[0], wide[1] + n_fwd)
    assert _bwd_launches() == _bwd_plus(backward, "wide_tf32", n_bwd)
    assert (got - ref).abs().max().item() <= 1e-5
    _check_grads(grads, {"plain": plain}, torch.float32, case)


def test_wide_f32_workspace_matches_the_c_entry(cuda):
    """ops/attention.py:wide_f32_workspace_floats, which sizes the slices,
    against csrc/mha_wide_f32.cu's own count of what it carves."""
    from review_recommender_tpu_torch import kernels

    lib = kernels.load()
    for b, s, h, d in ((64, 512, 1, 384), (3, 1, 2, 257), (5, 513, 3, 1024), (1, 130, 1, 511)):
        for backward in (0, 1):
            for padded in (0, 1):
                assert lib.rrt_mha_wide_f32_ws_floats(backward, b, s, h, d, padded) == \
                    tatt.wide_f32_workspace_floats(bool(backward), b, s, h, d, bool(padded))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_past_the_grid_limit_runs_by_slices(cuda, dtype):
    """B = 65,537 at (S, H, D) = (2, 1, 16): the forward and the backward
    launch twice each (slices of 65,535 and 2 rows) and match their plain
    versions."""
    b, s, heads, d = 65_537, 2, 1, 16
    q, k, v, bias = _inputs(65, b, s, heads * d, dtype, cuda)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(dtype)
    before, backward = _launches(), _bwd_launches()
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    grads = tatt._launch_bwd(q, k, v, bias, g, heads)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 2)
    assert _bwd_launches() == _bwd_plus(backward, tatt.backward_route(dtype, d, s), 2)
    assert (got.float() - ref.float()).abs().max().item() <= GENERIC_TOL[dtype]
    _check_grads(grads, {"plain": plain}, dtype, (b, s, heads, d))


def test_rrt_train_with_one_head_of_384_runs_the_wide_routes(cuda, tmp_path):
    """`rrt train --hidden 384 --head-dim 384 --layers 2` on the card: the
    towers have one head of 384, and their steps go through the wide
    forward and the wide backward (bf16 compute: route "wide"), no other
    attention kernel in the backward."""
    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import save_bundle
    from review_recommender_tpu_torch.serve import cli
    from tests.torch_bundle_cases import corpus

    products, _q, emb = corpus(n_themes=4, per_theme=16, n_queries=3, dim=384)
    rng = np.random.default_rng(2)
    rrows = [{"sku": p["sku"], "text": " ".join(rng.choice(p["agg_text"].split(), size=8)),
              "stars": 4.0} for p in products for _ in range(2)]
    remb = rng.standard_normal((len(rrows), 384)).astype(np.float32)
    save_bundle(build_bundle_from_products(products, emb, reviews=rrows, review_embeddings=remb,
                                           doc_terms_cap=64, pad_multiple=16), tmp_path / "b")
    wide, backward = tatt.mha_wide_kernel_launches, _bwd_launches()
    argv = ["train", "--index-dir", str(tmp_path / "b"), "--out", str(tmp_path / "t"),
            "--epochs", "1", "--batch-size", "8", "--max-len", "32", "--hidden", "384",
            "--head-dim", "384", "--layers", "2", "--vocab-size", "512",
            "--checkpoint-every", "0"]
    assert cli.main(argv) == 0
    torch.cuda.synchronize()
    fwd = tatt.mha_wide_kernel_launches - wide
    bwd = [n - m for n, m in zip(_bwd_launches(), backward)]
    assert fwd >= 4 and bwd[BWD_ROUTES.index("wide")] >= 4, (fwd, bwd)
    assert bwd[BWD_ROUTES.index("wide")] == sum(bwd), bwd


def test_backward_kernel_refuses_what_it_does_not_take(cuda):
    """A gradient of another dtype, shape or device, or a non-contiguous
    one, is refused at the launch (MhaKernelFn makes it contiguous)."""
    q, k, v, bias = _inputs(3, 2, 16, 64, torch.bfloat16, cuda)
    g = torch.ones_like(q)
    for bad, match in ((g.float(), "g must be"), (g[:1], "g must be"), (g.cpu(), "g must be"),
                       (g.transpose(0, 1).contiguous().transpose(0, 1), "contiguous")):
        with pytest.raises(ValueError, match=match):
            tatt._launch_bwd(q, k, v, bias, bad, 2)


def _tiny_pair_batch():
    """A 2-layer, 128-wide bi-encoder init and one 16-pair batch at 32 tokens."""
    from review_recommender_tpu_torch.models.bert import BertConfig, init_state_dict
    from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
    from review_recommender_tpu_torch.train import make_pair_batch

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, max_position=64)
    sd = init_state_dict(cfg, "biencoder", seed=3)
    rng = np.random.default_rng(0)
    words = [f"word{i}" for i in range(80)]
    docs = [" ".join(rng.choice(words, size=20)) for _ in range(16)]
    queries = [" ".join(d.split()[:4]) for d in docs]
    return cfg, sd, make_pair_batch(HashTokenizer(512), queries, docs, max_len=32, pad_to=32)


def _update_cosine(a, b, sd):
    """Cosine of two trainers' parameter updates from the init `sd`."""
    d_a = torch.cat([(a.params[n].cpu() - sd[n]).flatten() for n in sd])
    d_b = torch.cat([(b.params[n].cpu() - sd[n]).flatten() for n in sd])
    return torch.nn.functional.cosine_similarity(d_a, d_b, dim=0).item()


def test_contrastive_step_on_cuda_matches_the_cpu_f32_step(cuda):
    """One bf16 ContrastiveTrainer step on the card (attention through the
    kernel forward and the backward kernel) against the CPU f32 step
    from the same init: loss within 2e-2 (bf16 products), and the update
    points the same way (cosine of the two parameter updates >= 0.95; a
    first AdamW step is lr * g / (|g| + eps), so elements whose gradient is
    rounding noise take either sign)."""
    from review_recommender_tpu_torch.train import ContrastiveTrainer, TrainConfig

    cfg, sd, batch = _tiny_pair_batch()
    tc = TrainConfig(learning_rate=1e-3)
    cpu = ContrastiveTrainer(cfg, sd, train_cfg=tc, dtype=torch.float32, device="cpu")
    gpu = ContrastiveTrainer(cfg, sd, train_cfg=tc, device="cuda")
    launches, backward = tatt.mha_kernel_launches, _bwd_launches()
    m_gpu = gpu.train_step(*batch)
    assert tatt.mha_kernel_launches == launches + 4  # 2 layers x (queries, docs)
    assert _bwd_launches() == _bwd_plus(backward, "wgmma", 4)
    m_cpu = cpu.train_step(*batch)
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 2e-2, (m_gpu, m_cpu)
    cos = _update_cosine(gpu, cpu, sd)
    assert cos >= 0.95, cos
    assert all(p.dtype == torch.float32 for p in gpu.params.values())  # f32 masters


def test_remat_step_on_cuda_relaunches_the_kernel(cuda):
    """remat=True (torch.utils.checkpoint per layer) on the card: the
    backward re-runs each layer's forward, kernel included, before the
    backward kernel, so a step launches the forward twice for each
    backward (8 forward and 4 backward launches for 2 layers x queries and
    docs, against 4 and 4 without remat). The step is the same step: the
    loss within 1e-6 and the cosine of the two parameter updates >= 0.9999
    (the re-run forward gives the same activations)."""
    from review_recommender_tpu_torch.train import ContrastiveTrainer, TrainConfig

    cfg, sd, batch = _tiny_pair_batch()
    counts, trainers, losses = {}, {}, {}
    for remat in (False, True):
        tr = ContrastiveTrainer(cfg, sd, train_cfg=TrainConfig(learning_rate=1e-3, remat=remat),
                                device="cuda")
        launches, backward = tatt.mha_kernel_launches, sum(_bwd_launches())
        losses[remat] = tr.train_step(*batch)["loss"]
        counts[remat] = (tatt.mha_kernel_launches - launches, sum(_bwd_launches()) - backward)
        trainers[remat] = tr
    assert counts == {False: (4, 4), True: (8, 4)}, counts
    assert abs(losses[True] - losses[False]) <= 1e-6, losses
    cos = _update_cosine(trainers[True], trainers[False], sd)
    assert cos >= 0.9999, cos


def test_training_steps_do_not_sync_fresh_or_restored(cuda, tmp_path):
    """A trainer's step (batch upload, forward through the kernel, the
    backward kernel, clip and AdamW) queues on the device without a
    host sync (torch's sync debug mode raises on one), fresh and restored
    from a checkpoint; the restored AdamW step counts stay on the host,
    where a fresh optimizer keeps them."""
    from review_recommender_tpu_torch.train import ContrastiveTrainer

    cfg, sd, batch = _tiny_pair_batch()
    fresh = ContrastiveTrainer(cfg, sd, device="cuda")
    fresh.train_step(*batch)
    fresh.save(tmp_path / "ck.pt")
    restored = ContrastiveTrainer(cfg, sd, device="cuda")
    restored.restore(tmp_path / "ck.pt")
    assert all(st["step"].device.type == "cpu" for st in restored.optim.opt.state.values())
    for tr in (fresh, restored):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = [tr.train_step_async(*batch) for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(np.isfinite(float(m["loss"])) for m in metrics)
        assert tr.step == 3


def _postings(seed, n, l, q, device):
    """(N, L) postings with PAD tails, tf >= 128 lanes, and a query with
    repeated and PAD (id 0, idf 0) slots; plus the packed (L, N) words."""
    rng = np.random.default_rng(seed)
    terms = rng.integers(1, 400, (n, l)).astype(np.int32)
    terms[:, l - l // 4:] = 0
    tf = rng.integers(1, 6, (n, l)).astype(np.float32)
    tf[rng.random((n, l)) < 0.05] = 200.0
    tf[terms == 0] = 0
    dl = tf.sum(1).astype(np.float32)
    qt = rng.integers(1, 400, q).astype(np.int32)
    qt[0] = terms[0, 0]  # at least one scored lane, even at N=3, L=1
    qt[1] = qt[0]
    qt[q - q // 4:] = 0
    qi = rng.uniform(0.5, 3, q).astype(np.float32)
    qi[q - q // 4:] = 0
    packed = (tf.astype(np.int64) << 24 | terms).astype(np.uint32).view(np.int32).T
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(terms), put(tf), put(dl), put(qt), put(qi), put(packed),
            float(np.float32(dl.mean())))


@pytest.mark.parametrize("n,l,q", [(200_192, 64, 32), (1000, 64, 32), (777, 33, 5),
                                   (4096, 512, 32), (3, 1, 64), (513, 100, 17),
                                   (20_000, 64, 65), (20_000, 64, 128), (5000, 48, 1024)])
def test_bm25_kernels_match_reference(cuda, n, l, q):
    terms, tf, dl, qt, qi, packed, avgdl = _postings(n + l + q, n, l, q, cuda)
    p0, u0 = tbk.bm25_packed_kernel_launches, tbk.bm25_unpacked_kernel_launches
    got_p = tbk.bm25_full_scores_packed_kernel(packed, dl, qt, qi, avgdl)
    got_u = tbk.bm25_full_scores_kernel(terms, tf, dl, qt, qi, avgdl)
    ref_p = tbk.bm25_full_scores_packed_reference(packed, dl, qt, qi, avgdl)
    ref_u = bm25_full_scores(terms, tf, dl, qt, qi, avgdl)
    valid = torch.arange(n, device=cuda) < max(1, n - 7)
    k = min(n, 50)
    top_p = tbk.bm25_topk_packed(packed, dl, valid, qt, qi, avgdl, k)  # CUDA: the kernels
    top_u = tbk.bm25_topk_unpacked(terms, tf, dl, valid, qt, qi, avgdl, k)
    torch.cuda.synchronize()
    assert tbk.bm25_packed_kernel_launches == p0 + 2
    assert tbk.bm25_unpacked_kernel_launches == u0 + 2
    assert torch.equal(ref_p, ref_u)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_u, ref_u)
    assert bool((got_p > 0).any())
    ref_top = masked_topk(ref_p, valid, k)
    for top in (top_p, top_u):
        assert torch.equal(top[1], ref_top[1]) and torch.equal(top[0], ref_top[0])


@pytest.mark.parametrize("min_q", [0, 130], ids=["q", "q130"])
@pytest.mark.parametrize("case", CASES)
def test_bm25_kernels_lookup_edge_cases(cuda, case, min_q):
    """The query-term lookup's edge cases (tests/torch_bm25_cases.py), the
    packed postings at the unpadded N: bitwise equal scores, equal top-k;
    each also with its query lengthened to 130 slots (three launches of
    64, 64 and 2 slots)."""
    terms, tf, dl, qt, qi, avgdl = bm25_edge_case(case, min_q)
    n = terms.shape[0]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    args_p = (put(pack(terms, tf)), put(dl), put(qt), put(qi), float(avgdl))
    args_u = (put(terms), put(tf), put(dl), put(qt), put(qi), float(avgdl))
    got_p = tbk.bm25_full_scores_packed_kernel(*args_p)
    got_u = tbk.bm25_full_scores_kernel(*args_u)
    ref_p = tbk.bm25_full_scores_packed_reference(*args_p)
    ref_u = bm25_full_scores(*args_u)
    torch.cuda.synchronize()
    assert torch.equal(ref_p, ref_u)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_u, ref_u)
    valid = torch.arange(n, device=cuda) < n
    k = min(n, 50)
    ref_ids = masked_topk(ref_p, valid, k)[1]
    for got in (got_p, got_u):
        assert torch.equal(masked_topk(got, valid, k)[1], ref_ids)


def test_bm25_kernels_reject_what_they_do_not_take(cuda):
    terms, tf, dl, qt, qi, packed, avgdl = _postings(0, 64, 16, 8, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.bm25_full_scores_packed_kernel(packed.cpu(), dl.cpu(), qt.cpu(), qi.cpu(), avgdl)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.bm25_full_scores_kernel(terms, tf, dl.cpu(), qt, qi, avgdl)
    with pytest.raises(ValueError, match="int32"):
        tbk.bm25_full_scores_packed_kernel(packed.long(), dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="float32"):
        tbk.bm25_full_scores_kernel(terms, tf.double(), dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bm25_full_scores_packed_kernel(packed.T.contiguous().T, dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bm25_full_scores_kernel(terms.T.contiguous().T, tf, dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="shape"):
        tbk.bm25_full_scores_kernel(terms, tf[:, :8].contiguous(), dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="N=0"):
        tbk.bm25_full_scores_packed_kernel(packed[:, :0].contiguous(), dl[:0], qt, qi, avgdl)
    with pytest.raises(ValueError, match="query slots"):
        long_q = torch.zeros(tbk.MAX_QUERY_SLOTS + 1, dtype=torch.int32, device=cuda)
        tbk.bm25_full_scores_packed_kernel(packed, dl, long_q, long_q.float(), avgdl)


def test_engine_refuses_query_terms_cap_above_the_kernel_limit(cuda, monkeypatch):
    """On the card every query has QUERY_TERMS_CAP slots: above the BM25
    kernels' limit SearchEngine refuses at construction, naming the knob."""
    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.schema import IndexBundle

    bundle = IndexBundle(products=synth_product_index(300, 64, 200, 8, seed=0, text_chars=50))
    monkeypatch.setattr(config, "QUERY_TERMS_CAP", tbk.MAX_QUERY_SLOTS + 1)
    with pytest.raises(ValueError, match="QUERY_TERMS_CAP"):
        SearchEngine(bundle, device="cuda")
    monkeypatch.setattr(config, "QUERY_TERMS_CAP", tbk.MAX_QUERY_SLOTS)
    eng = SearchEngine(bundle, device="cuda")
    idx, scores = eng.search_bm25("t12 t34 t56", 10)
    torch.cuda.synchronize()
    assert idx.shape == (10,) and bool(torch.isfinite(scores).all())


def _e2e_engine(device):
    """A 2,000-product engine with attach_rerank_tokens' tokens and 2-layer
    bf16 towers of 4 heads of 32 (the kernel's head dims), the same seeded
    weights on either device."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import (attach_rerank_tokens,
                                                          synth_product_index)
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, max_position=128)
    be = BiEncoder.random_init(cfg, seed=1, device=device, dtype=torch.bfloat16)
    ce = CrossEncoder.random_init(cfg, seed=2, device=device, dtype=torch.bfloat16)
    products = synth_product_index(2000, 128, 300, 12, seed=0, text_chars=200)
    attach_rerank_tokens(products, be.tokenizer, max_tokens=64)
    eng = SearchEngine(IndexBundle(products=products), device=device)
    eng.attach_models(be, ce)
    return eng


def test_query_e2e_on_cuda_matches_cpu(cuda):
    """query_e2e on the card (both towers on the attention kernel: 2 + 2
    launches a query at rr_k=8) against the port on the CPU (reference
    attention) with the same weights and corpus: rows equal up to near-tie
    swaps, finals within 2e-2 (bf16 towers, the phase-4 bound of
    chip_smoke.py)."""
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    w = FusionWeights.make(0.4, 0.25, 0.2, 0.1, 0.0, 20.0, 8.0, 1.0)
    gpu, cpu = _e2e_engine("cuda"), _e2e_engine("cpu")
    for query in ("t12 t34 t56", "t7 t250 t3", "t99"):
        before = tatt.mha_kernel_launches
        rg, sg = gpu.query_e2e(query, w, 150, 10, rr_k=8)
        torch.cuda.synchronize()
        assert tatt.mha_kernel_launches == before + 4
        rc, sc = cpu.query_e2e(query, w, 150, 10, rr_k=8)
        sg, sc = sg.cpu().numpy(), sc.numpy()
        assert np.isfinite(sg).all() and np.abs(sg - sc).max() <= 2e-2, (sg, sc)
        for i, (a, b) in enumerate(zip(rg.cpu().tolist(), rc.tolist())):
            if a != b:
                assert abs(sg[i] - sc[i]) <= 2e-2


def test_device_fetch_on_cuda(cuda):
    """device_fetch copies CUDA tensors through pinned buffers and waits
    once: every value equals a plain .cpu() read, right after a kernel
    that wrote it."""
    from review_recommender_tpu_torch.utils.numerics import device_fetch

    a = torch.arange(1 << 20, device=cuda, dtype=torch.float32).mul_(3.0)
    b = torch.arange(1000, device=cuda).remainder_(7)
    got_a, got_b, got_c = device_fetch(a, b, np.ones(3))
    assert got_a.dtype == np.float32 and got_b.dtype == np.int64
    np.testing.assert_array_equal(got_a, a.cpu().numpy())
    np.testing.assert_array_equal(got_b, b.cpu().numpy())
    np.testing.assert_array_equal(got_c, np.ones(3))


@pytest.mark.parametrize("front_end", ["stdlib", "native"])
def test_server_answers_a_search_on_cuda(cuda, front_end):
    """serve / serve_native on a small CUDA engine: one /search without a
    query vector encodes on the card (2 attention launches, one per layer)
    and answers 10 finite, sorted rows."""
    import json
    import threading
    import urllib.request

    from review_recommender_tpu_torch.serve.api import serve
    from review_recommender_tpu_torch.serve.native_server import serve_native

    eng = _e2e_engine("cuda")
    if front_end == "stdlib":
        srv = serve(eng, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
    else:
        srv = serve_native(eng, host="127.0.0.1", port=0)
        port = srv.port
    try:
        before = tatt.mha_kernel_launches
        req = urllib.request.Request(f"http://127.0.0.1:{port}/search", data=json.dumps(
            {"query": "t12 t34 t56", "k": 10, "rerank_k": 0}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert tatt.mha_kernel_launches == before + 2
        finals = [row["_final"] for row in out["results"]]
        assert len(finals) == 10 and all(np.isfinite(finals))
        assert finals == sorted(finals, reverse=True)
    finally:
        if front_end == "stdlib":
            srv.shutdown()
            srv.service.close()
        else:
            srv.close()


def test_cli_search_on_a_saved_bundle_on_cuda(cuda, tmp_path):
    """Build a bundle (native tokenizer), save and load it, then the CLI's
    search on cuda: its rows equal run_search on the engine _load_engine
    builds, and it launches the attention kernel once per bi-encoder layer
    (4 at D=64) plus once per cross-encoder layer (6) for 4 rerank pairs."""
    import json

    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import load_bundle, save_bundle
    from review_recommender_tpu_torch.serve import cli
    from tests.torch_bundle_cases import assert_bundles_equal, corpus

    products, _q, emb = corpus()
    built = build_bundle_from_products(products, emb, doc_terms_cap=64, pad_multiple=16)
    save_bundle(built, tmp_path / "b")
    assert_bundles_equal(load_bundle(tmp_path / "b", verify_checksums=True), built)
    before = tatt.mha_kernel_launches
    argv = ["search", "yellow wireless headphones", "--index-dir", str(tmp_path / "b"),
            "--rerank-k", "4", "--json-out", str(tmp_path / "out.json")]
    assert cli.main(argv) == 0
    assert tatt.mha_kernel_launches == before + 4 + 6
    engine = cli._load_engine(str(tmp_path / "b"), with_rerank=True)
    rows, _s, _d = engine.run_search("yellow wireless headphones", k=10, rerank_k=4)
    assert json.loads((tmp_path / "out.json").read_text())["results"] == rows


def _stage_a_inputs(seed, n, d, b, dtype, device):
    """Unit-norm rows and queries; holes in the validity; when there is a
    second tile, it keeps 5 valid rows only (its later rounds repeat ids)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = rng.random(n) < 0.97
    if n > tsa.TILE_N:
        hi = min(n, 2 * tsa.TILE_N)
        valid[tsa.TILE_N:hi] = False
        valid[tsa.TILE_N + rng.choice(hi - tsa.TILE_N, 5, replace=False)] = True
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (torch.from_numpy(emb).to(device, dtype), torch.from_numpy(valid).to(device),
            torch.from_numpy(q).to(device))


WIDE_N = 3 * 2048 - 1000  # tile 0 with holes, tile 1 with 5 valid rows, tile 2 ragged


def _wide_inputs(seed, d, b, dtype, device):
    """_stage_a_inputs at WIDE_N with its third (ragged) tile all invalid:
    every round of that tile is (-3.4e38, 0)."""
    emb, valid, qvecs = _stage_a_inputs(seed, WIDE_N, d, b, dtype, device)
    valid[2 * tsa.TILE_N:] = False
    return emb, valid, qvecs


def _plain_tile_scores(emb, valid, qvecs, local_ids):
    """The plain version's score of each winner id: (n_tiles, 16, B)."""
    n, b = emb.shape[0], qvecs.shape[0]
    tiles = -(-n // tsa.TILE_N)
    sims = torch.where(valid[:, None], matmul_f32(emb, qvecs.to(emb.dtype).T), tsa.NEG)
    sims = torch.nn.functional.pad(sims, (0, 0, 0, tiles * tsa.TILE_N - n), value=tsa.NEG)
    return torch.gather(sims.reshape(tiles, tsa.TILE_N, b), 1, local_ids.long())


def _stage_a_counts():
    return {route: getattr(tsa, counter) for route, counter in tsa.ROUTE_COUNTERS.items()}


def _check_tile_pass(emb, valid, qvecs, route=None):
    """The kernel's tile pass against the plain one; returns both. The
    launch goes to the route of the dtype and D (`route` when given) and
    moves that route's counter, and no other, by one."""
    want = tsa.stage_a_route(emb.dtype, emb.shape[1], qvecs.shape[0])
    assert route in (None, want)
    before = _stage_a_counts()
    ks, ki = tsa.stage_a_tile_winners_kernel(emb, valid, qvecs)
    ps, pi = tsa.stage_a_tile_winners_reference(emb, valid, qvecs)
    torch.cuda.synchronize()
    assert _stage_a_counts() == {r: n + (r == want) for r, n in before.items()}
    n, b = emb.shape[0], qvecs.shape[0]
    tiles = -(-n // tsa.TILE_N)
    assert ks.shape == ki.shape == (tiles, tsa.M_PER_TILE, b)
    assert ks.dtype == torch.float32 and ki.dtype == torch.int32
    assert (ks - ps).abs().max().item() <= 1e-5
    differ = ki != pi
    assert differ.float().mean().item() <= 0.01
    if differ.any():  # near ties only
        gap = _plain_tile_scores(emb, valid, qvecs, ki) - _plain_tile_scores(emb, valid, qvecs, pi)
        assert gap[differ].abs().max().item() <= 1e-5
    exhausted = ps == tsa.NEG  # rounds past a tile's valid rows: exactly (-3.4e38, 0)
    assert torch.equal(ks == tsa.NEG, exhausted) and (ki[exhausted] == 0).all()
    return (ks, ki), (ps, pi)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,b", [(200_704, 384, 32), (2 * 2048 + 10, 64, 1),
                                   (10_000, 128, 128), (5000, 72, 5), (3000, 8, 3),
                                   (4100, 4096, 20), (9000, 384, 300)])
def test_stage_a_kernel_matches_reference(cuda, dtype, n, d, b):
    emb, valid, qvecs = _stage_a_inputs(n + d + b, n, d, b, dtype, cuda)
    (ks, ki), (ps, pi) = _check_tile_pass(emb, valid, qvecs)
    if n > tsa.TILE_N:  # the exhausted tile repeats local row 0, as the plain version does
        assert torch.equal(ki[1, 5:], pi[1, 5:]) and (ki[1, 5:] == 0).all()
        assert (ks[1, 5:] == tsa.NEG).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", STAGE_A_CASES)
def test_stage_a_kernel_on_shared_cases(cuda, case, dtype):
    """tests/torch_stage_a_cases.py on the card: ties to the lower row
    across slabs, more than 16 copies of the best row, exhausted and
    all-invalid tiles, ragged N, B in {1, 5, 33, 130}."""
    emb, valid, qvecs = (torch.from_numpy(x).to(cuda) for x in stage_a_case(case))
    (ks, ki), (ps, pi) = _check_tile_pass(emb.to(dtype), valid, qvecs)
    if case == "dup_best":  # the 16 lowest of the 40 copies, on both sides
        assert torch.equal(ki[0, :, 0], pi[0, :, 0])
    if case == "tie_across_slabs":
        assert int(ki[0, -1, 0]) == 63


@pytest.mark.parametrize("b", [1, 8, 32, 128])
def test_stage_a_kernel_at_main_shape(cuda, b):
    """The main shape, (200,704, 384) bf16, at each batch width phase 8
    times; one launch reads the corpus once (a single query chunk)."""
    emb, valid, qvecs = _stage_a_inputs(b, 200_704, 384, b, torch.bfloat16, cuda)
    _check_tile_pass(emb, valid, qvecs)
    assert tsa.stage_a_query_chunk(384, b) >= b


@pytest.mark.parametrize("n,d,b", [
    (200_704, 384, 1), (200_704, 384, 128),  # phase 8's f32 widths
    (9000, 384, 32), (9000, 384, 33), (9000, 384, 65),  # chunk edges
    (5000, 1536, 9), (5000, 2912, 17), (5000, 2916, 17), (5000, 3072, 3)] + [
    (WIDE_N, d, b) for d in (4, 6, 2912, 2916, 3072, 4096, 4100, 8192)
    for b in (1, 8, 32, 33, 128)])
def test_stage_a_f32_routes_at_their_edges(cuda, n, d, b):
    """The f32 route: chunks of 32 queries at D = 384 (B = NC, NC + 1, 2 NC
    + 1), D = 2,912 (the widest the first layout, queries resident in
    shared memory, took) and past it, widths TMA cannot take (D = 6:
    24-byte rows, by cp.async), past 4,096 and at every chunk width, with
    an all-invalid tile at WIDE_N; the route's counter moves by one."""
    if n == WIDE_N:
        emb, valid, qvecs = _wide_inputs(d + b, d, b, torch.float32, cuda)
    else:
        emb, valid, qvecs = _stage_a_inputs(n + d + b, n, d, b, torch.float32, cuda)
    _check_tile_pass(emb, valid, qvecs, "tf32")
    if d == 384:
        assert tsa.stage_a_query_chunk(d, b, torch.float32) == (8 if b <= 8 else 16 if b <= 16
                                                                else 32)


@pytest.mark.parametrize("b", [1, 8, 32, 33, 128])
@pytest.mark.parametrize("d", [7, 8, 60, 4096, 4104, 5000])
def test_stage_a_bf16_at_every_width(cuda, d, b):
    """bf16 past 4,096 and at widths TMA cannot take (D = 7: 2-byte
    granules; D = 60: 120-byte rows, 8-byte granules), with an all-invalid
    tile at a ragged N; the route's counter moves by one."""
    emb, valid, qvecs = _wide_inputs(d * b, d, b, torch.bfloat16, cuda)
    _check_tile_pass(emb, valid, qvecs, "wgmma")


@pytest.mark.parametrize("b", [1, 32, 128])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 100), (torch.bfloat16, 4100),
                                     (torch.float32, 38), (torch.float32, 4097)])
def test_stage_a_copy_loader_across_boxes(cuda, dtype, d, b):
    """The cp.async loader where a row spans more than one 128-byte box:
    bf16 D = 100 (2 boxes) and 4,100 (65), f32 D = 38 (2) and 4,097 (129,
    4-byte granules), so box x > 0's column offset, the swizzle past the
    first 128 bytes and the ring's turns (boxes past its stages, the
    producer arriving kCopyDepth boxes late) all run; chunks of every width
    from the narrowest to the widest (bf16 NC = 128: the ring's fewest
    stages), with an all-invalid tile at a ragged N."""
    emb, valid, qvecs = _wide_inputs(d + 7 * b, d, b, dtype, cuda)
    _check_tile_pass(emb, valid, qvecs, "tf32" if dtype == torch.float32 else "wgmma")


def test_stage_a_tf32_width_limit_matches_the_kernel(cuda):
    """The C entries take what the wrapper passes and refuse the rest: a
    chunk width of the type with no instance (f32 64, bf16 8, 0, 48), a
    missing workspace, D < 1; the wrapper's chunk is an instance at every
    width and batch of both types (no limit on D: the first f32 route
    ended at 2,912)."""
    from review_recommender_tpu_torch import kernels

    lib = kernels.load()
    emb, valid, qvecs = _stage_a_inputs(0, 4096, 64, 8, torch.float32, cuda)
    out_s = torch.empty(2, 16, 8, device=cuda)
    out_i = torch.empty(2, 16, 8, dtype=torch.int32, device=cuda)
    ws = torch.empty(1 << 16, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, fn, taken in ((torch.bfloat16, lib.rrt_stage_a_wgmma, (16, 32, 64, 128)),
                             (torch.float32, lib.rrt_stage_a_tf32, (8, 16, 32))):
        x = emb.to(dtype)
        for nc, ws_ptr, d in [(nc, ws.data_ptr(), 64) for nc in (0, 8, 48, 64)
                              if nc not in taken] + [(taken[0], 0, 64), (taken[0], ws.data_ptr(), 0)]:
            assert fn(x.data_ptr(), valid.data_ptr(), qvecs.data_ptr(), ws_ptr, out_s.data_ptr(),
                      out_i.data_ptr(), 4096, d, 8, nc, stream) != 0, (dtype, nc, ws_ptr, d)
        for d in (1, 6, 384, 2912, 2916, 4096, 8192):
            for b in (1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 300):
                assert tsa.stage_a_query_chunk(d, b, dtype) in taken, (dtype, d, b)
    torch.cuda.synchronize()


def test_stage_a_kernel_rejects_what_it_does_not_take(cuda):
    emb, valid, qvecs = _stage_a_inputs(0, 4096, 64, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsa.stage_a_tile_winners_kernel(emb.cpu(), valid.cpu(), qvecs.cpu())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tsa.stage_a_tile_winners_kernel(emb.half(), valid, qvecs)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tsa.stage_a_tile_winners_kernel(emb.double(), valid, qvecs)
    with pytest.raises(ValueError, match="qvecs must be torch.float32"):
        tsa.stage_a_tile_winners_kernel(emb, valid, qvecs.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tsa.stage_a_tile_winners_kernel(emb.T.contiguous().T, valid, qvecs)
    with pytest.raises(ValueError, match="not taken"):
        tsa.stage_a_tile_winners_kernel(emb, valid, qvecs[:0])
    with pytest.raises(ValueError, match="not taken"):
        tsa.stage_a_tile_winners_kernel(emb[:, :0].contiguous(), valid, qvecs[:, :0].contiguous())
    with pytest.raises(ValueError, match="shape|must be"):
        tsa.stage_a_tile_winners_kernel(emb, valid[:100], qvecs)
    # each C entry refuses an empty shape, and a call without its workspace
    from review_recommender_tpu_torch import kernels

    lib = kernels.load()
    for fn, dtype in ((lib.rrt_stage_a_wgmma, torch.bfloat16), (lib.rrt_stage_a_tf32, torch.float32)):
        e = torch.zeros(64, 3072, dtype=dtype, device=cuda)
        q = torch.zeros(32, 3072, device=cuda)
        ws = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
        out_s = torch.empty(1, 16, 32, device=cuda)
        out_i = torch.empty(1, 16, 32, dtype=torch.int32, device=cuda)
        stream = torch.cuda.current_stream().cuda_stream
        for n, d, b, w in ((0, 3072, 32, ws), (64, 0, 32, ws), (64, 3072, 0, ws),
                           (64, 3072, 32, None)):
            assert fn(e.data_ptr(), valid.data_ptr(), q.data_ptr(), None if w is None else w.data_ptr(),
                      out_s.data_ptr(), out_i.data_ptr(), n, d, b, 32, stream) != 0


# ------------------------------------------------ the int8 corpus, the IVF pool
def _unit_rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,b", [(200_192, 1), (200_192, 16), (200_192, 128), (1003, 5)])
def test_int8_scores_on_cuda_bit_equal_to_cpu(cuda, n, b):
    """torch._int_mm on the padded single-query (1 row -> 17) and batched
    shapes, and N not a multiple of 8: scores, exact and striped pools
    bit-equal to the CPU int8 path."""
    from review_recommender_tpu_torch.ops import dense as td

    emb = _unit_rows(0, n, 384)
    q = torch.from_numpy(_unit_rows(1, b, 384))
    q = q[0] if b == 1 else q
    e_q, scale = (torch.from_numpy(a) for a in td.quantize_corpus_int8(emb))
    valid = torch.arange(n) < n - 7
    got = td.dense_scores_int8(e_q.to(cuda), scale.to(cuda), q.to(cuda), valid.to(cuda))
    want = td.dense_scores_int8(e_q, scale, q, valid)
    assert torch.equal(got.cpu(), want)
    sl_dev = td.slice_corpus_for_striped_int8(e_q.to(cuda), scale.to(cuda), valid.to(cuda), 8192)
    sl_cpu = td.slice_corpus_for_striped_int8(e_q, scale, valid, 8192)
    gs, gi = td.dense_striped_topk_scan_int8(*sl_dev, q.to(cuda), 150)
    ws, wi = td.dense_striped_topk_scan_int8(*sl_cpu, q, 150)
    assert torch.equal(gi.cpu(), wi) and torch.equal(gs.cpu(), ws)


def test_ivf_topk_on_cuda_matches_cpu(cuda):
    """ivf_topk on the card against its CPU run on the same index (bf16
    blocks): scores within 1e-5, an id differing only at a near tie; the
    batched rows equal their single queries."""
    from review_recommender_tpu_torch.ops import ivf as tivf

    rng = np.random.default_rng(2)
    centers = _unit_rows(3, 64, 128)
    emb = centers[rng.integers(0, 64, 20_000)] + 0.05 * rng.standard_normal((20_000, 128))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    valid = np.arange(20_000) < 19_990
    ix = tivf.build_ivf(emb, valid, device=cuda)
    dev = tivf.ivf_device_arrays(ix, torch.from_numpy(emb).to(cuda, torch.bfloat16))
    cpu = {k: v.cpu() for k, v in dev.items()}
    q = torch.from_numpy(emb[:32] + 0.01)
    for nprobe in (4, 64, 10_000):
        gs, gi = tivf.ivf_topk(*(dev[k] for k in tivf.IVF_KEYS), q.to(cuda), 150, nprobe)
        ws, wi = tivf.ivf_topk(*(cpu[k] for k in tivf.IVF_KEYS), q, 150, nprobe)
        gs, gi = gs.cpu(), gi.cpu()
        live = torch.isfinite(ws)
        assert torch.equal(torch.isfinite(gs), live)  # the same -inf padding
        gap = torch.where(live, gs - ws, 0.0).abs()
        assert gap.max().item() <= 1e-5
        differ = (gi != wi) & live
        assert (gap[differ] <= 1e-5).all()
        for i in (0, 31):
            s1, i1 = tivf.ivf_topk(*(dev[k] for k in tivf.IVF_KEYS), q[i].to(cuda), 150, nprobe)
            assert torch.equal(i1.cpu(), gi[i])


def test_loaded_tower_on_cuda_matches_cpu_f32(cuda, tmp_path):
    """A bge-small-shaped HF snapshot (the full-size golden's manifest and
    seed, written as pytorch_model.bin) loaded through models/load.py on the
    card in bf16, against its CPU f32 forward: within 2e-2; the attention
    kernel runs once per layer."""
    import json

    from review_recommender_tpu_torch.models import load
    from tests.golden_utils import manifest_from_npz, synth_state_arrays

    g = np.load(Path(__file__).parent / "goldens" / "bert_fullsize.npz")
    sd = synth_state_arrays(manifest_from_npz(g, "be_man."), seed=100)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 30522, "hidden_size": 384, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 1536}))
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(30517)]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    gpu = load.load_biencoder(tmp_path)
    cpu = load.load_biencoder(tmp_path, device="cpu", dtype=torch.float32)
    texts = [" ".join(f"w{i}" for i in range(j, j + 20 * (j + 1))) for j in range(6)]
    before = tatt.mha_kernel_launches
    got = gpu.encode(texts)
    torch.cuda.synchronize()
    assert tatt.mha_kernel_launches > before
    assert np.abs(got - cpu.encode(texts)).max() <= 2e-2


# ------------------------------------------------------------ topic pipeline
TOPIC_TOL = 1e-5  # f32 products summed in another order by cuBLAS and the CPU GEMM


def _knn_case(case):
    from tests.torch_topic_cases import GRAPH_CASES, rand_rows

    if case == "wide_5000":
        return rand_rows(5000, 384, 11), 17, dict(batch_rows=1024, col_chunk=2048)
    make, k, kw = GRAPH_CASES[case]
    return make(), k, kw


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("case", ["wide_5000", "duplicates", "negative_tails", "ragged_chunks",
                                  "zero_rows"])
def test_knn_graph_on_cuda_matches_cpu(cuda, case, tf32):
    """The graph on the card against the CPU path: sims within TOPIC_TOL,
    ids equal but for near ties; with TF32 turned on by the caller too
    (knn_graph computes in IEEE f32 whatever the process set)."""
    from review_recommender_tpu_torch.topics.density import knn_graph
    from tests.torch_topic_cases import assert_ids_differ_only_at_near_ties

    emb, k, kw = _knn_case(case)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        gs, gi = knn_graph(emb, k=k, device="cuda", **kw)
        # the caller's setting restored (read through the current API: reading the
        # legacy switch raises once both were used)
        assert torch.backends.cuda.matmul.fp32_precision == ("tf32" if tf32 else "ieee")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cs, ci = knn_graph(emb, k=k, device="cpu", **kw)
    assert gs.dtype == np.float32 and gi.dtype == np.int32 and gs.shape == cs.shape
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(cs))
    np.testing.assert_allclose(gs, cs, atol=TOPIC_TOL, rtol=0)
    assert_ids_differ_only_at_near_ties(emb, gi, ci, TOPIC_TOL)
    if case == "duplicates":
        assert (gi[:25] == np.arange(11)).all()


def test_density_cluster_on_cuda_labels_equal_cpu(cuda):
    from review_recommender_tpu_torch.topics.density import density_cluster
    from tests.torch_topic_cases import blobs_with_noise

    emb, truth = blobs_with_noise(n_per=400, k=6, d=64, noise=300, spread=0.06, seed=5)
    kw = dict(min_samples=10, min_cluster_size=40, batch_rows=512, col_chunk=1000)
    gl, ginfo = density_cluster(emb, device="cuda", **kw)
    cl, cinfo = density_cluster(emb, device="cpu", **kw)
    np.testing.assert_array_equal(gl, cl)
    assert ginfo["n_clusters"] == cinfo["n_clusters"] == 6
    assert ginfo["eps"] == pytest.approx(cinfo["eps"], abs=TOPIC_TOL)


def test_rrt_topics_on_cuda_writes_the_cpu_cards(cuda, tmp_path, capsys):
    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import save_bundle
    from review_recommender_tpu_torch.serve import cli
    from tests.torch_topic_cases import rand_rows, topic_reviews

    products = [{"sku": f"P{i}", "agg_text": f"product {i} socks", "n_reviews": 10.0,
                 "avg_stars": 4.0} for i in range(24)]
    rows, remb = topic_reviews([p["sku"] for p in products])
    save_bundle(build_bundle_from_products(products, rand_rows(24, 32, 0), reviews=rows,
                                           review_embeddings=remb, pad_multiple=8,
                                           doc_terms_cap=32), tmp_path / "b")
    lanes = (["--k", "4", "--iters", "8", "--min-reviews", "1"],
             ["--cluster", "density", "--min-samples", "5", "--min-cluster-size", "20",
              "--llm", "dry"])
    for i, lane in enumerate(lanes):
        for dev in ("cuda", "cpu"):
            assert cli.main(["topics", "--index-dir", str(tmp_path / "b"), "--out",
                             str(tmp_path / f"{dev}{i}"), "--device", dev, *lane]) == 0
        for f in ("topic_cards.jsonl", "aspect_metrics.json"):
            assert (tmp_path / f"cuda{i}" / f).read_text() == (tmp_path / f"cpu{i}" / f).read_text()
        assert len((tmp_path / f"cuda{i}" / "topic_cards.jsonl").read_text().splitlines()) >= 3
    capsys.readouterr()


@pytest.mark.parametrize("b,s", [(256, 512), (256, 64)])
def test_embed_job_attention_shapes_match_reference(cuda, b, s):
    """The raw-review pipeline's embedding jobs run the bi-encoder at batch
    256: products at 512 keys, reviews at short buckets (12 heads x 32)."""
    q, k, v, bias = _inputs(b + s, b, s, 12 * 32, torch.bfloat16, cuda)
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, 12)
        ref = tatt.mha_reference(q, k, v, bias, 12)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def test_embed_job_resumes_two_shards_on_cuda(cuda, tmp_path):
    """A 4-shard job on the card; two shards deleted and a torn temp file
    left: job_status reports them missing, the resumed job encodes those
    two shards only (one kernel launch per layer per batch) and returns
    the first run's embeddings (within 1e-6)."""
    from review_recommender_tpu_torch.data.embed_job import job_status, run_embed_job
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.encoder import BiEncoder

    cfg = BertConfig(vocab_size=30522, hidden_size=384, num_layers=2, num_heads=12,
                     intermediate_size=1536, max_position=512)
    enc = BiEncoder.random_init(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(0)
    texts = [" ".join(f"w{t}" for t in rng.integers(0, 5000, int(rng.integers(3, 700))))
             for _ in range(70)]
    first = run_embed_job(texts, enc, tmp_path, shard_rows=20, batch_size=8)
    for i in (2, 3):
        (tmp_path / f"emb_shard_{i:05d}.npy").unlink()
    np.save(tmp_path / "emb_shard_00002.tmp.npy", np.zeros((1, 1), np.float32))
    assert job_status(tmp_path)["missing"] == [2, 3]
    before = tatt.mha_kernel_launches
    again = run_embed_job(texts, enc, tmp_path, shard_rows=20, batch_size=8)
    # shard 2 (20 rows) is 3 batches of 8, shard 3 (10 rows) 2
    assert tatt.mha_kernel_launches - before == cfg.num_layers * (3 + 2)
    assert job_status(tmp_path)["complete"]
    assert np.abs(again - first).max() <= 1e-6


def _sharded_bundle(unpackable=False, seed=0):
    """A 3,000-product bundle (eager BM25 dropped: the classic postings),
    with one tf of 300 where it must not pack."""
    import dataclasses

    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.schema import IndexBundle

    p = synth_product_index(3000, 128, 500, 16, seed=seed, text_chars=80)
    p = dataclasses.replace(p, doc_bm25=None)
    if unpackable:
        p.doc_len[0] += 300.0 - p.doc_tf[0, 0]
        p.doc_tf[0, 0] = 300.0
    return IndexBundle(products=p)


@pytest.mark.parametrize("kind", ["packed", "unpacked"])
def test_sharded_bm25_kernels_bit_equal_to_cpu_shards(cuda, kind):
    from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine

    bundle = _sharded_bundle(unpackable=kind == "unpacked")
    gpu = ShardedSearchEngine(bundle, devices=["cuda:0"] * 4, dense_pool="exact")
    cpu = ShardedSearchEngine(bundle, devices=["cpu"] * 4, dense_pool="exact")
    assert gpu._kernels_ok() and not cpu._kernels_ok()  # the CPU shards: the plain scans
    counter = f"bm25_{kind}_kernel_launches"
    for query in ("t12 t34 t56", "t7 t250 t3 t3", "t99", "zzz"):
        for k in (10, 100):
            before = getattr(tbk, counter)
            gi, gs = gpu.bm25_topk(query, k)
            assert getattr(tbk, counter) == before + 4
            ci, cs = cpu.bm25_topk(query, k)
            assert torch.equal(gs.cpu(), cs) and torch.equal(gi.cpu(), ci)
    assert (gpu._bm25_packed_cache is None) == (kind == "unpacked")


def test_sharded_int8_pools_bit_equal_to_cpu(cuda):
    from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine

    bundle = _sharded_bundle(seed=3)
    q = torch.from_numpy(_unit_rows(5, 16, 128))
    for pool in ("exact", "striped"):
        gpu = ShardedSearchEngine(bundle, devices=["cuda:0"] * 4, emb_dtype="int8",
                                  dense_pool=pool)
        cpu = ShardedSearchEngine(bundle, devices=["cpu"] * 4, emb_dtype="int8", dense_pool=pool)
        for qq in (q[0], q):
            gs, gi = gpu._pool(gpu._replicate(qq.to(cuda)), 150)
            cs, ci = cpu._pool(cpu._replicate(qq), 150)
            assert torch.equal(gs.cpu(), cs) and torch.equal(gi.cpu(), ci), pool
        gi, gs = gpu.dense_topk(q[3].numpy(), 20)
        ci, cs = cpu.dense_topk(q[3].numpy(), 20)
        assert torch.equal(gs.cpu(), cs) and torch.equal(gi.cpu(), ci), pool


def test_sharded_query_e2e_launches(cuda):
    """query_e2e over 4 shards on the card with the kernel's head dims: the
    query encoded once (2 launches of the 2-layer bi-encoder), each shard's
    pairs through the 2-layer cross-encoder (2 launches a shard); finals
    within 2e-2 of the single engine's on the same card."""
    from review_recommender_tpu_torch.ops.fusion import FusionWeights
    from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine

    single = _e2e_engine("cuda")
    sh = ShardedSearchEngine(single.bundle, devices=["cuda:0"] * 4)
    sh.attach_models(single._be, single._ce)
    w = FusionWeights.make(0.4, 0.25, 0.2, 0.1, 0.0, 20.0, 8.0, 1.0)
    for rr_k, expect in ((0, 2), (50, 2 + 2 * 4)):
        for query in ("t12 t34 t56", "t99"):
            before = tatt.mha_kernel_launches
            rs, ss = sh.query_e2e(query, w, 150, 10, rr_k=rr_k)
            torch.cuda.synchronize()
            assert tatt.mha_kernel_launches == before + expect, rr_k
            r1, s1 = single.query_e2e(query, w, 150, 10, rr_k=rr_k)
            assert np.abs(ss.cpu().numpy() - s1.cpu().numpy()).max() <= 2e-2


# ------------------------------------------------ dp x tp training, the dp encoder
def _mesh_batches():
    """The tiny 2-layer config of _tiny_pair_batch and one batch of each
    trainer (16 rows)."""
    from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
    from review_recommender_tpu_torch.train import make_mlm_batch, make_triple_batch

    cfg, _sd, pairs = _tiny_pair_batch()
    rng = np.random.default_rng(1)
    words = [f"word{i}" for i in range(80)]
    docs = [" ".join(rng.choice(words, size=20)) for _ in range(16)]
    tok = HashTokenizer(512)
    triples = make_triple_batch(tok, [d[:24] for d in docs], docs,
                                (np.arange(16) % 2).astype(np.float32), max_len=48, pad_to=48)
    mlm = make_mlm_batch(tok, docs, max_len=32, rng=rng)
    return cfg, {"biencoder": pairs, "crossencoder": triples, "mlm": mlm}


@pytest.mark.parametrize("kind", ["biencoder", "crossencoder", "mlm"])
def test_mesh_step_on_cuda_matches_the_cpu_mesh(cuda, kind):
    """One bf16 step of each trainer on a (2, 2) mesh of one card against
    the f32 step of the same mesh of CPUs from the same init: loss within
    2e-2 (bf16 products); 4 kernel launches (the 4 cells) per layer and
    tower forward, as many backward kernel launches."""
    from review_recommender_tpu_torch.models.bert import init_state_dict
    from review_recommender_tpu_torch.parallel.mesh import TrainMesh
    from review_recommender_tpu_torch.train import (ContrastiveTrainer, CrossEncoderTrainer,
                                                    MLMTrainer)

    cls = {"biencoder": ContrastiveTrainer, "crossencoder": CrossEncoderTrainer,
           "mlm": MLMTrainer}[kind]
    cfg, batches = _mesh_batches()
    sd = init_state_dict(cfg, kind, seed=4)
    cpu = cls(cfg, sd, dtype=torch.float32, mesh=TrainMesh(["cpu"] * 4, 2, 2))
    gpu = cls(cfg, sd, mesh=TrainMesh([cuda] * 4, 2, 2))
    assert all(p.is_cuda for ps in gpu.shards.values() for p in ps)
    launches, backward = tatt.mha_kernel_launches, _bwd_launches()
    m_gpu = gpu.train_step(*batches[kind])
    towers = 2 if kind == "biencoder" else 1
    assert tatt.mha_kernel_launches - launches == 4 * cfg.num_layers * towers
    assert _bwd_launches() == _bwd_plus(backward, "wgmma", 4 * cfg.num_layers * towers)
    m_cpu = cpu.train_step(*batches[kind])
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 2e-2, (m_gpu, m_cpu)


def test_mesh_steps_do_not_sync_fresh_or_restored(cuda, tmp_path):
    """A bf16 mesh step (dp slices up from pinned memory, the cells'
    copies, the gathers, the clip over the shards, AdamW) queues without a
    host sync, fresh and restored from a one-device checkpoint."""
    from review_recommender_tpu_torch.parallel.mesh import TrainMesh
    from review_recommender_tpu_torch.train import ContrastiveTrainer

    cfg, sd, batch = _tiny_pair_batch()
    one = ContrastiveTrainer(cfg, sd, device="cuda")
    one.train_step(*batch)
    one.save(tmp_path / "ck.pt")
    fresh = ContrastiveTrainer(cfg, sd, mesh=TrainMesh([cuda] * 4, 2, 2))
    restored = ContrastiveTrainer(cfg, sd, mesh=TrainMesh([cuda] * 4, 2, 2))
    restored.restore(tmp_path / "ck.pt")
    fresh.train_step(*batch)
    for tr in (fresh, restored):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = [tr.train_step_async(*batch) for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(np.isfinite(float(m["loss"])) for m in metrics)
        assert tr.step == 3


def test_data_parallel_encode_on_cuda_matches_one_device(cuda):
    """BiEncoder(devices=[cuda] * 4): every batch in 4 slices, each slice's
    forward through the kernel (2 layers x 4 slices a batch), equal to the
    one-device encode within 2e-2 (bf16; other batch shapes)."""
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.encoder import BiEncoder

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, max_position=64)
    texts = [" ".join(f"w{(i * 5 + j) % 70}" for j in range(i % 23 + 1)) for i in range(40)]
    one = BiEncoder.random_init(cfg, seed=5, device="cuda")
    dp = BiEncoder.random_init(cfg, seed=5, devices=[cuda] * 4)
    launches = tatt.mha_kernel_launches
    got = dp.encode(texts, batch_size=16)
    assert tatt.mha_kernel_launches - launches == 3 * 4 * cfg.num_layers  # 3 batches
    want = one.encode(texts, batch_size=16)
    assert np.abs(got - want).max() <= 2e-2


def test_global_int8_scan_on_cuda_bit_equal_to_cpu(cuda):
    from review_recommender_tpu_torch.ops import dense as td

    emb = _unit_rows(0, 200_192, 384)
    q = torch.from_numpy(_unit_rows(1, 16, 384))
    e_q, scale = td.quantize_corpus_int8_global(emb)
    valid = torch.arange(200_192) < 200_192 - 9
    sl_cpu = td.slice_corpus_for_striped_int8(torch.from_numpy(e_q), torch.zeros(200_192),
                                              valid, 8192)
    sl_dev = [t.to(cuda) for t in sl_cpu]
    gs, gi = td.dense_striped_topk_scan_int8_global(sl_dev[0], sl_dev[2], q.to(cuda), 150, scale)
    ws, wi = td.dense_striped_topk_scan_int8_global(sl_cpu[0], sl_cpu[2], q, 150, scale)
    assert torch.equal(gi.cpu(), wi) and torch.equal(gs.cpu(), ws)
