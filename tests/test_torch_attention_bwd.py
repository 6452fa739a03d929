"""The port's attention backward (review_recommender_tpu_torch/ops/attention.py:
mha_backward_reference, backward_route) against the JAX package's custom_vjp backward and against autograd.

The same numpy inputs go to JAX's `_mha_bwd` (attention_kernel.py:142: the
residuals (q, k, v, key_bias) and the upstream gradient; it re-runs
mha_xla under jax.vjp) and to `mha_backward_reference`, which computes the
q, k and v gradients as the CUDA kernel csrc/mha_bwd.cu does. Tolerances,
as the largest error over max(1, max |ref|): 1e-5 in f32 (sums in another
order), 2e-2 in bf16 (one bf16 ulp at magnitude 2-4: the frameworks may
round dP, P and the gradients on opposite sides). The kernel
itself is held to the same function on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 15); its f32 route's arithmetic (3xTF32 products,
log2 units, kernel A's one pass and kernel B's query tiles), and past 256
columns that of csrc/mha_wide_f32.cu (S and dP contracted once and stored,
P and dS formed from them, dQ and dK / dV in steps of 32), is emulated in
torch here and held to the card tests' 1e-4.
A ContrastiveTrainer step with one head of 384 (the wide route's on the
card) is held to the JAX trainer's step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.models import bert as jbert
from review_recommender_tpu.ops.pallas.attention_kernel import _mha_bwd
from review_recommender_tpu.train import contrastive as jcon
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import flax_from_params, params_from_flax
from review_recommender_tpu_torch.ops import attention as tatt
from review_recommender_tpu_torch.train import contrastive as pcon
from tests import torch_train_cases as C
from tests.test_torch_attention import (_mm_3xtf32, _mm_3xtf32_chunked, _mm_3xtf32_tc, _tf32,
                                        _wide16_logits, _wide16_stats, _wide_f32_logits,
                                        _wide_f32_stats)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _inputs(seed, b, s, hd):
    """q, k, v and the upstream gradient ~ N(0, 1); random key lengths;
    row 0 masked but for one key, the last row fully masked (a batch-bucket
    padding row)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, hd)).astype(np.float32) for _ in range(4))
    lens = rng.integers(1, s + 1, size=b)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
    bias[0] = -1e30
    bias[0, min(1, s - 1)] = 0.0
    bias[-1] = -1e30
    return q, k, v, bias, g


def _torch(arrs, dtype):
    q, k, v, bias, g = arrs
    return (*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), torch.from_numpy(bias),
            torch.from_numpy(g).to(dtype))


def _assert_close(got, ref, tol, what):
    ref = np.asarray(ref, dtype=np.float32)
    err = np.abs(np.asarray(got, dtype=np.float32) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 20, 65, 130])
# 192, 256: the widest padded heads; 257, 384: the wide route's
@pytest.mark.parametrize("d", [16, 26, 32, 64, 192, 256, 257, 384])
def test_backward_reference_matches_jax_mha_bwd(dtype, s, d):
    heads, b = 2, 3
    arrs = _inputs(1000 * d + s, b, s, heads * d)
    q, k, v, bias, g = _torch(arrs, dtype)
    got = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    jq, jk, jv, jg = (jnp.asarray(x, dtype=JNP[dtype]) for x in (arrs[0], arrs[1], arrs[2], arrs[4]))
    ref = _mha_bwd(heads, True, (jq, jk, jv, jnp.asarray(arrs[3])), jg)
    for name, x, r in zip("qkv", got, ref[:3]):
        assert x.dtype == dtype and x.shape == q.shape
        _assert_close(x.float().numpy(), np.asarray(r.astype(jnp.float32)), TOL[dtype], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,d", [(3, 20, 2, 16), (2, 65, 4, 32), (3, 130, 1, 64)])
def test_backward_reference_matches_autograd_through_the_reference(dtype, b, s, heads, d):
    q, k, v, bias, g = _torch(_inputs(b * s + d, b, s, heads * d), dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tatt.mha_reference(*leaves, bias, heads)
    out.backward(g)
    got = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    for name, x, leaf in zip("qkv", got, leaves):
        _assert_close(x.float().numpy(), leaf.grad.float().numpy(), TOL[dtype], name)


def test_all_masked_row_gradients_flow_uniformly():
    """The batch-bucket padding row (every bias -1e30): its logits are all
    equal, P = 1/S over the S keys, so every key's dv is the mean of g over
    the queries, and dq and dk are finite."""
    b, s, heads, d = 2, 20, 2, 16
    q, k, v, bias, g = _torch(_inputs(7, b, s, heads * d), torch.float32)
    out = tatt.mha_reference(q, k, v, bias, heads)
    dq, dk, dv = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    want = g[-1].mean(dim=0, keepdim=True).expand(s, -1)
    torch.testing.assert_close(dv[-1], want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[-1], v[-1].mean(dim=0, keepdim=True).expand(s, -1),
                               rtol=1e-5, atol=1e-6)


def test_masked_key_gets_no_value_gradient():
    """A key masked in every row of its batch (bias -1e30 beside a real
    key) has P = 0 in every query row: its dv and dk are zero."""
    b, s, heads, d = 1, 12, 2, 16
    q, k, v, _bias, g = _torch(_inputs(8, b, s, heads * d), torch.float32)
    bias = torch.zeros(b, s)
    bias[0, 5] = -1e30
    _dq, dk, dv = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    assert torch.equal(dv[0, 5], torch.zeros_like(dv[0, 5]))
    assert torch.equal(dk[0, 5], torch.zeros_like(dk[0, 5]))


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 32, "wgmma"), (torch.float16, 64, "wgmma"), (torch.bfloat16, 26, "wgmma"),
    (torch.bfloat16, 1, "wgmma"), (torch.float16, 128, "wgmma"), (torch.bfloat16, 129, "wgmma"),
    (torch.float16, 256, "wgmma"), (torch.float32, 32, "tf32"), (torch.float32, 1, "tf32"),
    (torch.float32, 128, "tf32"), (torch.float32, 129, "tf32"), (torch.float32, 256, "tf32"),
    (torch.bfloat16, 257, "wide"), (torch.float16, 384, "wide"), (torch.bfloat16, 1024, "wide"),
    (torch.float32, 257, "wide_tf32"), (torch.float32, 384, "wide_tf32"),
    (torch.float32, 1024, "wide_tf32"),
])
def test_backward_route_table(dtype, d, route):
    assert tatt.backward_route(dtype, d, 1) == route
    assert tatt.backward_route(dtype, d, 4096) == route
    assert tatt.BACKWARD_COUNTERS[route].startswith("mha_backward_")


def _bwd_tiles(d: int) -> tuple[int, int]:
    """csrc/mha_bwd.cu's streamed tiles at head width d (kBtA, kBtB at the
    padded width DP): key rows a tile of kernel A, query rows of kernel B."""
    dp = tatt.padded_head_dim(d)
    bt_a = 32 if dp <= 32 else 8 if dp == 256 else 16
    bt_b = 32 if dp == 16 else 8 if dp == 256 else 16
    return bt_a, bt_b


def _mha_bwd_3xtf32(q, k, v, bias, g, heads, mm=_mm_3xtf32):
    """The f32 route of csrc/mha_bwd.cu in torch: logits in log2 units, 3xTF32
    products. Kernel A walks the key tiles once: the running max m, l = sum
    of e = 2^(s - m) and the sum of e * dP, X = sum e dP K and Y = sum e K
    (each rescaled by 2^(m_old - m_new)); Delta = sum(e dP) / l and dQ = (X -
    Delta Y) / l * scale. Kernel B walks the query tiles with those row
    statistics: P^T = 2^(s - m) / l, dV += P^T dO, dS^T = P^T (dP^T - Delta),
    dK += dS^T Q * scale. Returns (dq, dk, dv), (B, S, H*D)."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # (B, H, S, D)
    qh, kh, vh, gh = split(q), split(k), split(v), split(g)
    log2e = 1.4426950408889634
    scale = torch.tensor(log2e, dtype=torch.float32) / torch.sqrt(torch.tensor(float(d)))
    dscale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    kb = (bias * log2e)[:, None, None, :]  # (B, 1, 1, S): the keys' bias, log2 units
    bt_a, bt_b = _bwd_tiles(d)
    m = torch.full((b, heads, s, 1), float("-inf"))
    l = torch.zeros(b, heads, s, 1)
    dl = torch.zeros(b, heads, s, 1)
    x = torch.zeros(b, heads, s, d)
    y = torch.zeros(b, heads, s, d)
    for k0 in range(0, s, bt_a):
        kt, vt = kh[:, :, k0:k0 + bt_a], vh[:, :, k0:k0 + bt_a]
        logit = mm(qh, kt, "bhqd,bhkd->bhqk") * scale + kb[..., k0:k0 + bt_a]
        dp = mm(gh, vt, "bhqd,bhkd->bhqk")
        mx = torch.maximum(m, logit.amax(dim=-1, keepdim=True))
        a = torch.exp2(m - mx)
        m = mx
        e = torch.exp2(logit - m)
        f = e * dp
        l = l * a + e.sum(dim=-1, keepdim=True)
        dl = dl * a + f.sum(dim=-1, keepdim=True)
        x = x * a + mm(f, kt, "bhqk,bhkd->bhqd")
        y = y * a + mm(e, kt, "bhqk,bhkd->bhqd")
    inv_l = 1.0 / l
    delta = dl * inv_l
    dq = (x - delta * y) * (inv_l * dscale)
    dk = torch.zeros(b, heads, s, d)
    dv = torch.zeros(b, heads, s, d)
    for q0 in range(0, s, bt_b):
        qt, gt = qh[:, :, q0:q0 + bt_b], gh[:, :, q0:q0 + bt_b]
        st = mm(kh, qt, "bhkd,bhqd->bhkq") * scale + kb.transpose(-1, -2)
        mt, it, dt = (t[:, :, q0:q0 + bt_b].transpose(-1, -2) for t in (m, inv_l, delta))
        pt = torch.exp2(st - mt) * it
        dv = dv + mm(pt, gt, "bhkq,bhqd->bhkd")
        dst = pt * (mm(vh, gt, "bhkd,bhqd->bhkq") - dt)
        dk = dk + mm(dst, qt, "bhkq,bhqd->bhkd")
    dk = dk * dscale
    join = lambda t: t.permute(0, 2, 1, 3).reshape(b, s, hd)
    return join(dq), join(dk), join(dv)


def _mha_wide_bwd_3xtf32(q, k, v, bias, g, heads, mm=_mm_3xtf32_tc,
                         score_mm=_mm_3xtf32_chunked):
    """csrc/mha_wide_f32.cu's backward arithmetic in torch: the score
    kernel stores the logits L once (as the forward), with m and 1/l over
    key tiles of 128; the dP kernel contracts dP = dO V^T once (steps of 32
    columns, small terms and hi*hi apart), writes P = exp(L - m) * (1/l)
    over L and Delta = sum_k P dP; the dQ kernel adds dS K over steps of 32
    keys, the dK / dV kernel dS^T Q and P^T dO over steps of 32 queries
    (3xTF32, the three terms in one sum), dS = P (dP - Delta); dQ and dK
    scaled at the end. Returns (dq, dk, dv), (B, S, H*D)."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # (B, H, S, D)
    qh, kh, vh, gh = split(q), split(k), split(v), split(g)
    dscale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    logits = _wide_f32_logits(qh, kh, bias, d, score_mm)
    m, inv_l = _wide_f32_stats(logits)
    p = torch.exp(logits - m) * inv_l
    dp = score_mm(gh, vh, "bhqd,bhkd->bhqk")
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq, dk, dv = (torch.zeros(b, heads, s, d) for _ in range(3))
    for t0 in range(0, s, 32):
        dq = dq + mm(ds[..., t0:t0 + 32], kh[:, :, t0:t0 + 32], "bhqk,bhkd->bhqd")
        dk = dk + mm(ds[:, :, t0:t0 + 32].transpose(-1, -2), qh[:, :, t0:t0 + 32],
                     "bhkq,bhqd->bhkd")
        dv = dv + mm(p[:, :, t0:t0 + 32].transpose(-1, -2), gh[:, :, t0:t0 + 32],
                     "bhkq,bhqd->bhkd")
    join = lambda t: t.permute(0, 2, 1, 3).reshape(b, s, hd)
    return join(dq * dscale), join(dk * dscale), join(dv)


@pytest.mark.parametrize("s", [1, 65, 130])
@pytest.mark.parametrize("d", [129, 192, 256, 384, 1024])
def test_3xtf32_backward_holds_the_f32_tolerance(d, s):
    """The f32 route of csrc/mha_bwd.cu at head widths 129-256 (the key and
    query tiles its plans take there), and of csrc/mha_wide_f32.cu past 256
    (S and dP once, P and dS from them, the gradient kernels' steps),
    emulated in torch on the CPU, against mha_backward_reference and JAX's
    _mha_bwd within the card
    tests' 1e-4 of max(1, max |ref|), a row masked but one key and an
    all-masked row included; single TF32 products miss that bar."""
    heads, b = (2, 3) if d <= 512 else (1, 2)
    arrs = _inputs(700 * d + s, b, s, heads * d)
    q, k, v, bias, g = _torch(arrs, torch.float32)
    wide = d > tatt.MAX_HEAD_DIM
    got = (_mha_wide_bwd_3xtf32 if wide else _mha_bwd_3xtf32)(q, k, v, bias, g, heads)
    plain = tatt.mha_backward_reference(q, k, v, bias, g, heads)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (arrs[0], arrs[1], arrs[2], arrs[4]))
    jax_ref = _mha_bwd(heads, True, (jq, jk, jv, jnp.asarray(arrs[3])), jg)
    for name, x, r, jr in zip("qkv", got, plain, jax_ref[:3]):
        assert torch.isfinite(x).all()
        _assert_close(x.numpy(), r.numpy(), 1e-4, name)
        _assert_close(x.numpy(), np.asarray(jr), 1e-4, name)
    single = lambda a, c, eq: torch.einsum(eq, _tf32(a), _tf32(c))
    one = (_mha_wide_bwd_3xtf32(q, k, v, bias, g, heads, mm=single, score_mm=single) if wide
           else _mha_bwd_3xtf32(q, k, v, bias, g, heads, mm=single))
    worst = max(float((x - r).abs().max()) / max(1.0, float(r.abs().max()))
                for x, r in zip(one, plain))
    assert worst > 1e-4


def _mha_wide16_bwd(q, k, v, bias, g, heads):
    """csrc/mha_wide_bwd.cu's arithmetic in torch (bf16/f16 past 256
    columns): the logits stored once with m and 1/l (the forward's score
    kernel); dP = dO V^T contracted once, rounded to the input type T and
    stored; P = 2^(L - m) / l in f32 and Delta = sum_k P dP; dS = P (dP -
    Delta); the gradient products from P and dS rounded to T (wgmma's A
    registers), summed in f32 a tile of 64 at a time; dQ and dK times
    1/sqrt(d) once, each gradient rounded to T once."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # (B, H, S, D)
    qh, kh, vh, gh = (split(t).float() for t in (q, k, v, g))
    logits = _wide16_logits(split(q), split(k), bias, d)
    m, inv_l = _wide16_stats(logits)
    p = torch.exp2(logits - m) * inv_l
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh).to(q.dtype).float()
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    pt = p.to(q.dtype).float()
    dscale = float(np.float32(1.0) / np.sqrt(np.float32(d), dtype=np.float32))
    dq, dk, dv = (torch.zeros(b, heads, s, d) for _ in range(3))
    for k0 in range(0, s, 64):
        sl = slice(k0, k0 + 64)
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds[..., sl], kh[:, :, sl])
        dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds[:, :, sl], qh[:, :, sl])
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", pt[:, :, sl], gh[:, :, sl])
    merge = lambda t: t.to(q.dtype).permute(0, 2, 1, 3).reshape(b, s, hd)
    return merge(dq * dscale), merge(dk * dscale), merge(dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,s,heads", [(257, 65, 2), (384, 40, 1), (384, 130, 1)])
def test_wide16_backward_arithmetic_matches_jax(dtype, d, s, heads):
    """The bf16/f16 wide backward's arithmetic (S and dP each contracted
    once and stored, P and dS formed from the stored tiles), emulated in
    torch on the CPU, against JAX's _mha_bwd (jax.vjp of mha_xla) on the
    same numpy inputs, a row masked but one key and an all-masked row
    included: within 2e-2 of max(1, max |ref|) (the 16-bit bound of
    tests/test_torch_attention_bwd.py)."""
    b = 3
    arrs = _inputs(d * 13 + s, b, s, heads * d)
    q, k, v, bias, g = _torch(arrs, dtype)
    got = _mha_wide16_bwd(q, k, v, bias, g, heads)
    jq, jk, jv, jg = (jnp.asarray(x, dtype=JNP[dtype]) for x in (arrs[0], arrs[1], arrs[2], arrs[4]))
    ref = _mha_bwd(heads, True, (jq, jk, jv, jnp.asarray(arrs[3])), jg)
    for name, x, r in zip("qkv", got, ref[:3]):
        assert x.dtype == dtype and x.shape == q.shape
        _assert_close(x.float().numpy(), np.asarray(r.astype(jnp.float32)), TOL[dtype], name)


@pytest.mark.parametrize("d,dp", [(1, 16), (16, 16), (17, 32), (26, 32), (33, 64), (64, 64),
                                  (65, 128), (128, 128), (129, 192), (192, 192), (193, 256),
                                  (256, 256)])
def test_padded_head_dim(d, dp):
    """The padded width of the instance of both kernels that takes head
    width d (the C entries' rrt_*_last_dp report it on the card)."""
    assert tatt.padded_head_dim(d) == dp


def test_padded_head_dim_refuses_what_the_kernels_refuse():
    """D < 1 is refused by every kernel; D = 257 and 512 have no padded
    instance: the wide kernels take them in column chunks, which
    wide_column_chunks reports (and refuses for a padded width)."""
    for d in (0, -1, 257, 512):
        with pytest.raises(ValueError, match="head dim"):
            tatt.padded_head_dim(d)
    assert tatt.wide_column_chunks(torch.bfloat16, 257) == (192, 192, 192)
    assert tatt.wide_column_chunks(torch.float16, 512) == (192, 192, 192)
    assert tatt.wide_column_chunks(torch.float32, 512) == (128, 128, 128)
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 1), (torch.float64, 384)):
        with pytest.raises(ValueError):
            tatt.wide_column_chunks(dtype, d)


def test_backward_route_refuses_what_the_forward_refuses():
    """Other dtypes, D < 1 and S < 1 are refused by both routes; D = 257,
    refused before the wide kernels, takes the wide route both ways."""
    for dtype, d, s in ((torch.int32, 32, 8), (torch.float64, 32, 8), (torch.bfloat16, 0, 8),
                        (torch.float32, 32, 0)):
        with pytest.raises(ValueError):
            tatt.backward_route(dtype, d, s)
        with pytest.raises(ValueError):
            tatt.kernel_route(dtype, d, s)
    assert tatt.backward_route(torch.bfloat16, 257, 8) == "wide"
    assert tatt.kernel_route(torch.bfloat16, 257, 8) == "wide"


def test_backward_cost_model():
    b, s, h, d = 32, 256, 12, 32
    assert tatt.attention_backward_flops(b, s, h, d) == 2.5 * tatt.attention_flops(b, s, h, d)
    assert tatt.attention_backward_bytes(b, s, h, d, 2) == 7 * b * s * h * d * 2 + 4 * b * s


def test_contrastive_step_with_one_head_of_384_matches_jax():
    """One ContrastiveTrainer step of a 2-layer tower with one head of 384
    (rrt train --hidden 384 --head-dim 384's geometry; the wide route on
    the card) on the port's CPU path against the JAX trainer from the same
    flax init carried over by params_from_flax: loss within 1e-5, every
    gradient within tests/test_torch_train.py's 1e-5 rel / 1e-6 abs."""
    jcfg = dataclasses.replace(C.JCFG, hidden_size=384, num_layers=2, num_heads=1,
                               intermediate_size=384)
    cfg = BertConfig(**vars(jcfg))
    _, params = jbert.init_biencoder(jcfg, seed=7, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    tc = {"learning_rate": 1e-3}
    jtr = jcon.ContrastiveTrainer(jcfg, jax.tree.map(jnp.asarray, params),
                                  train_cfg=jcon.TrainConfig(**tc), dtype=jnp.float32)
    ptr = pcon.ContrastiveTrainer(cfg, params_from_flax(params, cfg, "biencoder"),
                                  train_cfg=pcon.TrainConfig(**tc), dtype=torch.float32,
                                  device="cpu")
    batch = C.batch("contrastive")
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss, has_aux=True))(
        jtr.params, *map(jnp.asarray, batch))
    ploss, _ = ptr._loss(*ptr._tensors(batch))
    ploss.backward()
    pgrads = flax_from_params({n: p.grad for n, p in ptr.model.named_parameters()}, cfg,
                              "biencoder")
    assert abs(ploss.item() - float(jloss)) <= 1e-5
    C.assert_trees_close(pgrads, jax.tree.map(np.asarray, jgrads), rtol=1e-5, atol=1e-6)
