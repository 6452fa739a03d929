"""The port's attention (review_recommender_tpu_torch/ops/attention.py)
against the JAX package's fused attention.

The same numpy inputs go to `mha_pallas(..., interpret=True)` (the TPU
kernel run as the JAX package's own tests run it on the CPU), to `mha_xla`
and to the port's `mha_reference`. Tolerances are those of
tests/test_attention.py: 1e-5 in float32, 2e-2 in bfloat16 (one bf16 ulp at
magnitude ~2-4, where the two frameworks may round a probability or an
output on opposite sides). The shapes include the head widths and lengths
that only the generic CUDA route takes (D = 16, 26, 50; S = 600) and the
wide route's (D = 257, 384), towers at TinyBERT_General_4L_312D's widths
(D = 26) held to flax in f32, and random_for_dim(514)'s tower (2 heads of
257) held to the JAX tower.
The CUDA kernels themselves are held against `mha_reference` on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.models import bert as jbert
from review_recommender_tpu.models import encoder as jenc
from review_recommender_tpu.ops.pallas.attention_kernel import mha_pallas, mha_xla
from review_recommender_tpu_torch.models import bert as tbert
from review_recommender_tpu_torch.models import encoder as tenc
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.ops import attention as tatt


def _inputs(seed, b, s, hd, all_masked_row=True):
    """q, k, v ~ N(0, 1); random key-padding lengths; the last batch row
    fully masked (a batch-bucket padding row) when b > 1."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, hd)).astype(np.float32) for _ in range(3))
    lens = rng.integers(1, s + 1, size=b)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
    if all_masked_row and b > 1:
        bias[-1] = -1e30
    return q, k, v, bias


def _jax(arrs, dtype):
    q, k, v, bias = arrs
    return (*(jnp.asarray(x, dtype=dtype) for x in (q, k, v)), jnp.asarray(bias))


def _torch(arrs, dtype):
    q, k, v, bias = arrs
    return (*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), torch.from_numpy(bias))


SHAPES = [(2, 16, 4, 32), (3, 64, 12, 32), (1, 128, 6, 64), (4, 32, 2, 16),
          (2, 64, 2, 128)]


@pytest.mark.parametrize("b,s,heads,head_dim", SHAPES)
def test_reference_f32_matches_jax(b, s, heads, head_dim):
    arrs = _inputs(b * 100 + s, b, s, heads * head_dim)
    ref_xla = np.asarray(mha_xla(*_jax(arrs, jnp.float32), heads))
    ref_pallas = np.asarray(mha_pallas(*_jax(arrs, jnp.float32), heads, interpret=True))
    got = tatt.mha_reference(*_torch(arrs, torch.float32), heads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref_xla, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,heads,head_dim", [(2, 64, 4, 32), (2, 128, 2, 64),
                                                (2, 32, 2, 128)])
def test_reference_bf16_matches_jax(b, s, heads, head_dim):
    arrs = _inputs(7 + s, b, s, heads * head_dim)
    ref = np.asarray(mha_pallas(*_jax(arrs, jnp.bfloat16), heads, interpret=True),
                     dtype=np.float32)
    ref_xla = np.asarray(mha_xla(*_jax(arrs, jnp.bfloat16), heads), dtype=np.float32)
    got = tatt.mha_reference(*_torch(arrs, torch.bfloat16), heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), ref_xla, rtol=2e-2, atol=2e-2)


# (head width, length): BertConfig.tiny()'s D = 16, TinyBERT-4L-312D's
# D = 26, random_for_dim(100)'s D = 50, 600 keys (past the first kernel's
# 512), the widest padded heads, D = 192 (bge-small's width in 2 heads) and
# 256, which the generic kernel pads to 192 / 256 columns in bf16/f16, and
# the wide route's D = 257 (random_for_dim(514)) and 384 (bge-small's width
# in one head)
GENERIC_SHAPES = [(16, 64), (26, 40), (50, 70), (32, 600), (192, 40), (256, 33), (257, 65),
                  (384, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,s", GENERIC_SHAPES)
def test_reference_matches_jax_at_generic_route_shapes(dtype, head_dim, s):
    """The plain version of the CUDA routes against the TPU kernel in
    interpret mode and mha_xla, at the widths and lengths only the generic
    route (and, at S = 600, the wgmma route past 512 keys) or the wide route
    (D > 256) takes."""
    b, heads = 2, (2 if s > 512 else 3)
    arrs = _inputs(head_dim * 1000 + s, b, s, heads * head_dim)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(mha_pallas(*_jax(arrs, jdt), heads, interpret=True), dtype=np.float32)
    ref_xla = np.asarray(mha_xla(*_jax(arrs, jdt), heads), dtype=np.float32)
    got = tatt.mha_reference(*_torch(arrs, tdt), heads)
    assert got.dtype == tdt and got.shape == (b, s, heads * head_dim)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), ref_xla, rtol=tol, atol=tol)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32 on the card."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum(eq, a, b) as csrc/mha_generic.cu's f32 route forms it on the
    tensor cores: hi = tf32(x), lo = tf32(x - hi), lo*hi + hi*lo first, then
    hi*hi, in f32 (TF32 products are exact in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def _mha_3xtf32(q, k, v, bias, heads, mm=_mm_3xtf32):
    """The f32 route's arithmetic in torch: 3xTF32 products, one online
    softmax pass over key tiles of 64 (32 at D > 32, 16 at D > 128, as the
    kernel's Plan), O rescaled by exp(m_old - m_new) and divided by the row
    sum at the end."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # (B, H, S, D)
    qh, kh, vh = split(q), split(k), split(v)
    scale = float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))
    tile = 16 if d > 128 else 32 if d > 32 else 64
    m = torch.full((b, heads, s, 1), float("-inf"))
    l = torch.zeros(b, heads, s, 1)
    o = torch.zeros(b, heads, s, d)
    for k0 in range(0, s, tile):
        logits = mm(qh, kh[:, :, k0:k0 + tile], "bhqd,bhkd->bhqk") * scale
        logits = logits + bias[:, None, None, k0:k0 + tile]
        mx = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - mx)
        m = mx
        p = torch.exp(logits - m)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + mm(p, vh[:, :, k0:k0 + tile], "bhqk,bhkd->bhqd")
    return (o / l).permute(0, 2, 1, 3).reshape(b, s, hd)


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 by dropping its low 13 bits: how the tensor
    cores read an f32 operand in shared memory (csrc/mha_wide_f32.cu's B
    boxes and their lo = x - trunc(x))."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32_tc(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum(eq, a, b) as csrc/mha_wide_f32.cu's products form it: a (the
    registers' operand) split hi = tf32(a), lo = tf32(a - hi) rounded; b
    (the landed box) read as trunc(b) with lo = trunc(b - trunc(b)); the
    small terms a_lo b_hi + a_hi b_lo, then a_hi b_hi."""
    ah, bh = _tf32(a), _trunc_tf32(b)
    al, bl = _tf32(a - ah), _trunc_tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def _mm_3xtf32_chunked(a: torch.Tensor, b: torch.Tensor, eq: str, kc: int = 32) -> torch.Tensor:
    """einsum(eq, a, b) contracted over the last axis of both as the f32
    wide score kernel (csrc/mha_wide_f32.cu) forms S and dP: steps of 32
    columns, each split as _mm_3xtf32_tc, the small terms and hi*hi each
    summed over every step in a sum of its own, the two added at the end."""
    small = big = 0.0
    for c0 in range(0, a.shape[-1], kc):
        ac, bc = a[..., c0:c0 + kc], b[..., c0:c0 + kc]
        ah, bh = _tf32(ac), _trunc_tf32(bc)
        al, bl = _tf32(ac - ah), _trunc_tf32(bc - bh)
        small = small + (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl))
        big = big + torch.einsum(eq, ah, bh)
    return big + small


def _wide_f32_stats(logits: torch.Tensor, tile: int = 128):
    """The score kernel's running row max and sum over key tiles of 128
    (the sum rescaled by exp(m_old - m_new)), and 1/l."""
    shape = (*logits.shape[:-1], 1)
    m = torch.full(shape, float("-inf"))
    l = torch.zeros(shape)
    for k0 in range(0, logits.shape[-1], tile):
        x = logits[..., k0:k0 + tile]
        mx = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - mx) + torch.exp(x - mx).sum(dim=-1, keepdim=True)
        m = mx
    return m, 1.0 / l


def _wide_f32_logits(qh, kh, bias, d, score_mm):
    """L = (q . k) * scale + bias, the product and the sum each rounded
    alone, S contracted once over the whole D."""
    scale = float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))
    return score_mm(qh, kh, "bhqd,bhkd->bhqk") * scale + bias[:, None, None, :]


def _mha_wide_3xtf32(q, k, v, bias, heads, mm=_mm_3xtf32_tc, score_mm=_mm_3xtf32_chunked):
    """csrc/mha_wide_f32.cu's forward arithmetic in torch: the score kernel
    contracts S once (steps of 32 columns, small terms and hi*hi apart) and
    stores the logits, with the running max and sum over key tiles of 128;
    the output kernel forms P = exp(L - m) * (1/l) from the stored logits
    and adds each 32-key step's P V (3xTF32, its own sum) to O in f32."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # (B, H, S, D)
    qh, kh, vh = split(q), split(k), split(v)
    logits = _wide_f32_logits(qh, kh, bias, d, score_mm)
    m, inv_l = _wide_f32_stats(logits)
    o = torch.zeros(b, heads, s, d)
    for k0 in range(0, s, 32):
        p = torch.exp(logits[..., k0:k0 + 32] - m) * inv_l
        o = o + mm(p, vh[:, :, k0:k0 + 32], "bhqk,bhkd->bhqd")
    return o.permute(0, 2, 1, 3).reshape(b, s, hd)


@pytest.mark.parametrize("head_dim,s", [(16, 64), (26, 40), (50, 70), (256, 129), (26, 600),
                                        (192, 130), (129, 65), (384, 65), (1024, 40)])
def test_3xtf32_split_holds_the_f32_tolerance(head_dim, s):
    """The f32 route's 3xTF32 products and softmax, emulated in torch on the
    CPU, against mha_reference within the route's 1e-5 (no card is needed to
    show that the split can hold it), a row masked but one key and an
    all-masked row included; plain single TF32 products do not hold it.
    Past 256 columns csrc/mha_wide_f32.cu's order: the scores contracted
    once in steps of 32 with the small terms and hi*hi apart and stored,
    then the output from the stored logits, 32 keys a product."""
    b, heads = 2, (2 if s > 512 else 1 if head_dim > 512 else 3)
    q, k, v, bias = _torch(_inputs(head_dim * 31 + s, b, s, heads * head_dim), torch.float32)
    bias[0] = -1e30
    bias[0, 1] = 0.0
    ref = tatt.mha_reference(q, k, v, bias, heads)
    emulate = _mha_wide_3xtf32 if head_dim > tatt.MAX_HEAD_DIM else _mha_3xtf32
    got = emulate(q, k, v, bias, heads)
    assert (got - ref).abs().max().item() <= 1e-5
    mean_v = v[1].mean(dim=0)
    assert (got[1] - mean_v[None, :]).abs().max().item() <= 1e-5
    single = lambda a, c, eq: torch.einsum(eq, _tf32(a), _tf32(c))
    one = (_mha_wide_3xtf32(q, k, v, bias, heads, mm=single, score_mm=single)
           if head_dim > tatt.MAX_HEAD_DIM else _mha_3xtf32(q, k, v, bias, heads, mm=single))
    assert (one - ref).abs().max().item() > 1e-5


LOG2E = np.float32(1.4426950408889634)


def _wide16_logits(qh, kh, bias, d):
    """csrc/mha_wide.cuh's score kernel in torch: S contracted once over the
    whole D from the 16-bit inputs (each product exact in f32, summed in
    f32), the logits in log2 units s * (log2 e / sqrt d) + bias * log2 e as
    one f32 FMA (a single rounding: formed in f64), stored in f32."""
    scale = np.float64(LOG2E / np.sqrt(np.float32(d), dtype=np.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()).double()
    lb = (bias.float() * torch.tensor(LOG2E)).double()[:, None, None, :]
    return (s * scale + lb).float()


def _wide16_stats(logits, tile=64):
    """The score kernel's running row max and sum of 2^(L - m) over key
    tiles of 64 (the sum rescaled by 2^(m_old - m_new)), and 1/l."""
    shape = (*logits.shape[:-1], 1)
    m = torch.full(shape, float("-inf"))
    l = torch.zeros(shape)
    for k0 in range(0, logits.shape[-1], tile):
        x = logits[..., k0:k0 + tile]
        mx = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        l = l * torch.exp2(m - mx) + torch.exp2(x - mx).sum(dim=-1, keepdim=True)
        m = mx
    return m, 1.0 / l


def _mha_wide16(q, k, v, bias, heads):
    """csrc/mha_wide.cu's forward arithmetic in torch (bf16/f16 past 256
    columns): the logits stored once, m and 1/l from them; the output
    kernel's P = 2^(L - m) / l rounded to the input type, then each key
    tile of 64's P V summed into O in f32, O rounded once."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # (B, H, S, D)
    qh, kh, vh = split(q), split(k), split(v)
    logits = _wide16_logits(qh, kh, bias, d)
    m, inv_l = _wide16_stats(logits)
    p = (torch.exp2(logits - m) * inv_l).to(q.dtype).float()
    o = torch.zeros(b, heads, s, d)
    for k0 in range(0, s, 64):
        o = o + torch.einsum("bhqk,bhkd->bhqd", p[..., k0:k0 + 64], vh[:, :, k0:k0 + 64].float())
    return o.to(q.dtype).permute(0, 2, 1, 3).reshape(b, s, hd)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("head_dim,s,heads", [(257, 65, 2), (384, 40, 1), (384, 130, 1)])
def test_wide16_arithmetic_matches_jax(dtype, head_dim, s, heads):
    """The bf16/f16 wide route's arithmetic (csrc/mha_wide.cu: S contracted
    once and stored as f32 logits in log2 units, m and 1/l over key tiles
    of 64, P rounded to the input type before P V), emulated in torch on
    the CPU, against the TPU kernel in interpret mode and mha_xla at the
    widths only that route takes, a row masked but one key and an
    all-masked row included: within 2e-2 (the repo's 16-bit bound, one ulp
    at magnitude 2-4); the all-masked row the mean of its V rows."""
    b = 3
    arrs = list(_inputs(head_dim * 7 + s, b, s, heads * head_dim))
    arrs[3][0] = -1e30
    arrs[3][0, 1] = 0.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(mha_pallas(*_jax(arrs, jdt), heads, interpret=True), dtype=np.float32)
    ref_xla = np.asarray(mha_xla(*_jax(arrs, jdt), heads), dtype=np.float32)
    q, k, v, bias = _torch(arrs, tdt)
    got = _mha_wide16(q, k, v, bias, heads)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), ref_xla, rtol=2e-2, atol=2e-2)
    mean_v = v[-1].float().mean(dim=0)
    assert (got[-1].float() - mean_v[None, :]).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [1, 16, 26, 31, 32, 33, 64, 96, 128, 129, 256])
def test_kernel_route_by_dtype_and_head_width(dtype, d):
    """bf16/f16 take the tensor-core route at D = 32, 64, 128 only; f32
    takes the generic route at every width; the length never matters."""
    want = "wgmma" if d in (32, 64, 128) else "generic"
    for s in (1, 63, 64, 65, 512, 513, 1024, 4096):
        assert tatt.kernel_route(dtype, d, s) == want
        assert tatt.kernel_route(torch.float32, d, s) == "generic"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d", [257, 320, 384, 512, 1024])
def test_kernel_route_past_256_is_the_wide_route(dtype, d):
    """Every dtype past 256 columns takes the wide route at every length:
    bf16/f16 csrc/mha_wide.cu forward and csrc/mha_wide_bwd.cu backward,
    f32 csrc/mha_wide_f32.cu both ways, in the column chunks the C entries
    use; bf16/f16 contract each row block's scores once (wide_split)."""
    for s in (1, 63, 65, 512, 4096):
        assert tatt.kernel_route(dtype, d, s) == "wide"
        assert tatt.backward_route(dtype, d, s) == ("wide_tf32" if dtype == torch.float32
                                                    else "wide")
    fwd, dq, dkv = tatt.wide_column_chunks(dtype, d)
    if dtype == torch.float32:
        assert (fwd, dq, dkv) == (128, 128, 128)  # csrc/mha_wide_f32.cu: a CTA's columns
        with pytest.raises(ValueError, match="f32"):
            tatt.wide_split(dtype, d)
    else:
        # a warpgroup's columns; the output and dQ kernels' CTAs take two
        # chunks, the dK / dV kernel's one (dV and dK side by side)
        assert (fwd, dq, dkv) == (192, 192, 192)
        # each row block's S (and dP) contracted by one warpgroup, once,
        # and read back by these CTAs
        ctas = {257: (1, 1, 2), 320: (1, 1, 2), 384: (1, 1, 2), 512: (2, 2, 3),
                1024: (3, 3, 6)}[d]
        assert tatt.wide_split(dtype, d) == tuple((1, n) for n in ctas)


@pytest.mark.parametrize("b", [1, 65_535, 65_536, 65_537, 200_000])
def test_batch_slices_cover_any_batch(b):
    """A batch past the kernels' grid limit (grid.z <= 65,535) launches on
    contiguous slices of at most MAX_GRID_BATCH rows that cover it once, in
    order."""
    slices = tatt._batch_slices(b)
    assert slices[0][0] == 0 and slices[-1][1] == b
    assert all(hi - lo <= tatt.MAX_GRID_BATCH and hi > lo for lo, hi in slices)
    assert all(a[1] == z[0] for a, z in zip(slices, slices[1:]))
    assert len(slices) == -(-b // 65_535)


# (backward, B, S, H, D, padded, the workspace cap in batch rows' worth or
# None for the module's 1 GiB, the slices wanted)
WIDE_F32_PLANS = [
    (False, 64, 512, 1, 384, False, None, 1),  # phase 19 (h)'s shape: one slice
    (True, 64, 512, 1, 384, False, None, 1),
    (True, 10, 65, 2, 257, True, 3, 4),  # a small cap: several slices of 3 rows
    (False, 7, 130, 1, 1024, False, 2.5, 4),
    (True, 5, 33, 1, 320, False, 0.5, 5),  # a row past the cap: one row a slice
    (False, 3, 1, 2, 511, True, 0.0, 3),
    (False, 70_000, 1, 1, 260, False, 100_000, 2),  # and never past MAX_GRID_BATCH
]


@pytest.mark.parametrize("backward,b,s,h,d,padded,cap_rows,want", WIDE_F32_PLANS)
def test_wide_f32_workspace_slices(monkeypatch, backward, b, s, h, d, padded, cap_rows, want):
    """The f32 wide kernels' batch slices: contiguous, covering the batch
    once in order, each slice's workspace (wide_f32_workspace_floats, 4
    bytes a float) within WIDE_WORKSPACE_BYTES unless a single row
    passes it (then one row a slice), never more than MAX_GRID_BATCH rows;
    the whole of (64, 512, 1, 384) in one slice of 117.7 MB forward and
    285.6 MB backward."""
    row = 4 * tatt.wide_f32_workspace_floats(backward, 1, s, h, d, padded)
    if cap_rows is not None:
        monkeypatch.setattr(tatt, "WIDE_WORKSPACE_BYTES", int(cap_rows * row))
    slices = tatt._wide_slices(torch.float32, backward, b, s, h, d, padded)
    assert len(slices) == want
    assert slices[0][0] == 0 and slices[-1][1] == b
    assert all(a[1] == z[0] for a, z in zip(slices, slices[1:]))
    for lo, hi in slices:
        assert 0 < hi - lo <= tatt.MAX_GRID_BATCH
        nbytes = 4 * tatt.wide_f32_workspace_floats(backward, hi - lo, s, h, d, padded)
        assert nbytes <= tatt.WIDE_WORKSPACE_BYTES or hi - lo == 1
    if (b, s, h, d) == (64, 512, 1, 384):
        full = 4 * tatt.wide_f32_workspace_floats(backward, b, s, h, d, padded)
        assert full == (285_605_888 if backward else 117_702_656)


def test_wide_f32_rows_copied_only_where_tma_cannot_read_them():
    """The f32 wide kernels read q, k (v, dO) in place by TMA where D is a
    multiple of 4 and every base is 16-byte aligned, else from padded
    copies in the workspace."""
    x = torch.zeros(2, 3, 2 * 384)
    assert not tatt._wide_padded(torch.float32, 384, x, x)
    assert tatt._wide_padded(torch.float32, 257, x, x)
    assert tatt._wide_padded(torch.float32, 384, x, x.view(-1)[1:].view(-1)[:-1])
    assert (tatt.wide_f32_workspace_floats(False, 2, 3, 2, 257, True)
            > tatt.wide_f32_workspace_floats(False, 2, 3, 2, 257, False))


def test_kernel_route_refusals():
    """D < 1, S < 1 and other dtypes are refused; D = 257 and 512, refused
    before the wide kernels, take the wide route."""
    for d in (0, -1):
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head dim"):
                tatt.kernel_route(dtype, d, 16)
    for d in (257, 512):
        for dtype in (torch.float32, torch.bfloat16):
            assert tatt.kernel_route(dtype, d, 16) == "wide"
    for dtype in (torch.float64, torch.int32, torch.float8_e4m3fn):
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            tatt.kernel_route(dtype, 32, 16)
    with pytest.raises(ValueError, match="sequence length"):
        tatt.kernel_route(torch.bfloat16, 32, 0)
    assert tatt.MAX_HEAD_DIM == 256 and tatt.WGMMA_HEAD_DIMS == (32, 64, 128)


def _tinybert_cfg():
    """huawei-noah/TinyBERT_General_4L_312D's widths (config.json: hidden
    312, 12 heads, intermediate 1200), cut to 2 layers and a 128-word
    vocab."""
    return jbert.BertConfig(vocab_size=128, hidden_size=312, num_layers=2, num_heads=12,
                            intermediate_size=1200, max_position=64)


@pytest.mark.parametrize("kind", ["biencoder", "crossencoder"])
def test_tinybert_width_towers_match_flax(kind):
    """Both towers at D = 26 (the generic route's width on the card) through
    the port's CPU path against flax with the TPU kernel in interpret mode,
    in f32, with the flax weights carried over by params_from_flax: within
    1e-4 (tests/test_torch_models.py's tower bound)."""
    cfg = _tinybert_cfg()
    init = jbert.init_biencoder if kind == "biencoder" else jbert.init_crossencoder
    _, params = init(cfg, seed=26, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(312)
    b, s = 3, 40
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.array([s, 17, 1])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    tt = (np.arange(s)[None, :] >= lens[:, None] // 2).astype(np.int32) * mask
    jcls = jbert.BiEncoderModel if kind == "biencoder" else jbert.CrossEncoderModel
    ref = jcls(cfg, dtype=jnp.float32, attn_impl="pallas").apply(
        {"params": params}, ids, mask, tt)
    tcls = tbert.BiEncoderModel if kind == "biencoder" else tbert.CrossEncoderModel
    model = tcls(tbert.BertConfig(**vars(cfg)), dtype=torch.float32)
    model.load_state_dict(params_from_flax(params, cfg, kind), strict=True)
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(x) for x in (ids, mask, tt)))
    assert got.shape == ((b, 312) if kind == "biencoder" else (b,))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_random_for_dim_514_tower_matches_jax():
    """BiEncoder.random_for_dim(514) (2 heads of 257, the wide route's on
    the card) through the port's CPU path against the JAX tower with its
    weights carried over by params_from_flax, in f32: within 1e-4
    (tests/test_torch_models.py's tower bound)."""
    jbe = jenc.BiEncoder.random_for_dim(514, seed=5, dtype=jnp.float32)
    assert (jbe.cfg.hidden_size, jbe.cfg.num_heads) == (514, 2)
    cfg = tbert.BertConfig(**vars(jbe.cfg))
    tbe = tenc.BiEncoder(cfg, params_from_flax(jax.tree.map(np.asarray, jbe.params), jbe.cfg,
                                               "biencoder"),
                         HashTokenizer(cfg.vocab_size), device="cpu", dtype=torch.float32)
    port = tenc.BiEncoder.random_for_dim(514, seed=5, device="cpu")
    assert (port.cfg.hidden_size, port.cfg.num_heads) == (514, 2)
    texts = ["wireless headphones with a long battery", "t12 t345", "yellow socks"]
    got, want = tbe.encode(texts), jbe.encode(texts)
    assert got.shape == (3, 514)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_all_masked_rows_are_uniform():
    """Every key masked: all logits equal (-1e30 + x == -1e30 in f32), so the
    softmax is uniform and the output is the mean of V, on both sides."""
    b, s, heads, d = 2, 32, 4, 16
    q, k, v, _ = _inputs(3, b, s, heads * d)
    bias = np.full((b, s), -1e30, np.float32)
    arrs = (q, k, v, bias)
    ref = np.asarray(mha_pallas(*_jax(arrs, jnp.float32), heads, interpret=True))
    got = tatt.mha_reference(*_torch(arrs, torch.float32), heads).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape),
                               rtol=1e-5, atol=1e-5)


def test_multihead_attention_takes_reference_on_cpu():
    arrs = _inputs(11, 2, 32, 4 * 32)
    q, k, v, bias = _torch(arrs, torch.float32)
    before = tatt.mha_kernel_launches
    got = tatt.multihead_attention(q, k, v, bias, 4)
    assert torch.equal(got, tatt.mha_reference(q, k, v, bias, 4))
    assert torch.equal(tatt.multihead_attention(q, k, v, bias, 4, impl="reference"), got)
    assert tatt.mha_kernel_launches == before == 0


def test_kernel_refuses_cpu_tensors_and_bad_impl():
    q, k, v, bias = _torch(_inputs(12, 1, 16, 2 * 32), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.multihead_attention(q, k, v, bias, 2, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tatt.multihead_attention(q, k, v, bias, 2, impl="pallas")
    assert tatt.mha_kernel_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recompute_backward_equals_autograd_through_the_reference(monkeypatch, dtype):
    """MhaKernelFn with its forward launch swapped for mha_reference (the
    kernels run only on the card) and its backward launch refused: on CPU
    tensors the backward is mha_backward_reference, whose q, k, v gradients
    are autograd's through mha_reference within 1e-5 (f32) / 2e-2 (bf16)
    of max(1, max |ref|); key_bias gets none, no backward kernel launch is
    counted, and with q needing no gradient only k and v get one. An
    expanded (stride 0) upstream gradient, as .sum().backward() gives,
    yields the dense one's gradients exactly."""
    def refuse(*_args):
        raise AssertionError("the backward kernel's launch on CPU tensors")

    monkeypatch.setattr(tatt, "_launch", tatt.mha_reference)
    monkeypatch.setattr(tatt, "_launch_bwd", refuse)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}[dtype]
    q, k, v, bias = _torch(_inputs(5, 3, 20, 64), dtype)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(q.shape).astype(np.float32))
    counts = lambda: [getattr(tatt, name) for name in tatt.BACKWARD_COUNTERS.values()]
    before = counts()
    for needs in ((True, True, True), (False, True, True)):
        grads = []
        for fn in (tatt.MhaKernelFn.apply, tatt.mha_reference):
            leaves = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
            b_leaf = bias.clone().requires_grad_(False)
            fn(*leaves, b_leaf, 2).backward(g.to(dtype))
            grads.append([t.grad for t in leaves])
            assert b_leaf.grad is None
        for got, want in zip(*grads):
            assert (got is None) == (want is None)
            if got is not None:
                assert got.dtype == want.dtype == dtype
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol * max(1.0, want.float().abs().max().item()), err
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tatt.MhaKernelFn.apply(*leaves, bias, 2).sum().backward()
    dense = tatt.mha_backward_reference(q, k, v, bias, torch.ones_like(q), 2)
    assert all(torch.equal(leaf.grad, want) for leaf, want in zip(leaves, dense))
    assert counts() == before
