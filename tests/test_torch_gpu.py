"""The CUDA attention kernel against its plain torch version, on the card.

Needs an NVIDIA Hopper GPU with nvcc; every test skips where
torch.cuda.is_available() is false. The file imports no jax, so on a
machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance 2e-2 in bf16/f16 (tests/test_attention.py's bf16 bound); the
kernel rounds like the reference except where the f32 sum order moves a
value across a rounding boundary.
"""
import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.ops import attention as tatt

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


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bias = _inputs(0, 2, 16, 4 * 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        tatt.mha_kernel(q, k, v, bias, 8)  # D = 16
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        tatt.mha_kernel(q.float(), k.float(), v.float(), bias, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.mha_kernel(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, bias, 4)
    long_q = torch.zeros(1, 513, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="sequence length"):
        tatt.mha_kernel(long_q, long_q, long_q, torch.zeros(1, 513, device=cuda), 2)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        tatt.mha_kernel(qg, k, v, bias, 4)
