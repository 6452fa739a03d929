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
chip_smoke.py phase 15).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.ops.pallas.attention_kernel import _mha_bwd
from review_recommender_tpu_torch.ops import attention as tatt

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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
@pytest.mark.parametrize("d", [16, 26, 32, 64, 192, 256])  # 192, 256: the widest heads
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
    (torch.float32, 128, "tf32"), (torch.float32, 129, "fma"), (torch.float32, 256, "fma"),
])
def test_backward_route_table(dtype, d, route):
    assert tatt.backward_route(dtype, d, 1) == route
    assert tatt.backward_route(dtype, d, 4096) == route
    assert tatt.BACKWARD_COUNTERS[route].startswith("mha_backward_")


def test_backward_route_refuses_what_the_forward_refuses():
    for dtype, d, s in ((torch.int32, 32, 8), (torch.float64, 32, 8), (torch.bfloat16, 0, 8),
                        (torch.bfloat16, 257, 8), (torch.float32, 32, 0)):
        with pytest.raises(ValueError):
            tatt.backward_route(dtype, d, s)
        with pytest.raises(ValueError):
            tatt.kernel_route(dtype, d, s)


def test_backward_cost_model():
    b, s, h, d = 32, 256, 12, 32
    assert tatt.attention_backward_flops(b, s, h, d) == 2.5 * tatt.attention_flops(b, s, h, d)
    assert tatt.attention_backward_bytes(b, s, h, d, 2) == 7 * b * s * h * d * 2 + 4 * b * s
