"""The precision plan of the stage-A tile pass's f32 route on the tensor
cores (csrc/stage_a_wgmma.cu as rrt_stage_a_tf32), emulated in numpy on the
CPU, and the rule that picks a route (ops/stage_a.py:stage_a_route).

The emulation repeats the kernel's arithmetic: each query value is split
as hi = tf32(q), lo = tf32(q - hi) (cvt.rna.tf32.f32: round to nearest at
10 mantissa bits, ties away from zero); a corpus value x enters the tensor
cores as f32 bits, of which they read the top 10 mantissa bits (hi =
trunc(x)), and as lo = x - trunc(x), exact in f32 and truncated the same
way; hi*q_hi and hi*q_lo are summed in f32 accumulators of their own,
lo*q_hi in a third (TF32 products are exact in f32), and the score is
hi*q_hi + (hi*q_lo + lo*q_hi). Its tile winners must meet the card
tests' bar (tests/test_torch_gpu.py:_check_tile_pass) against the plain
tile pass, which tests/test_torch_stage_a.py holds to
`stage_a_fused_pallas(interpret=True)`: scores within 1e-5, at most 1% of
ids differing and those only at near ties within 1e-5, rounds past a
tile's valid rows exactly (-3.4e38, 0). Plain single TF32 products do not
hold 1e-5 at D = 384, so the bar tells the two apart; the 3xTF32 sums hold
it at D = 3,072 and 4,096 too.
"""
import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.ops import stage_a as SA
from tests.torch_stage_a_cases import CASES, stage_a_case

TOL = 1e-5


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32 on the card."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _truncate_tf32(x: np.ndarray) -> np.ndarray:
    """The TF32 value the tensor cores read from f32 bits: the low 13
    mantissa bits dropped."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _scores_3xtf32(emb: np.ndarray, q: np.ndarray, small_terms: bool = True) -> np.ndarray:
    """(N, B) scores as the kernel forms them: sum_k hi*q_hi, sum_k hi*q_lo
    and sum_k lo*q_hi each in an f32 accumulator, then hi*q_hi + (hi*q_lo
    + lo*q_hi); `small_terms=False` keeps hi*q_hi alone (single TF32)."""
    eh, qh = _truncate_tf32(emb), _tf32(q)
    el, ql = _truncate_tf32(emb - eh), _tf32(q - qh)
    big = np.zeros((emb.shape[0], q.shape[0]), np.float32)
    small1, small2 = np.zeros_like(big), np.zeros_like(big)
    for k in range(emb.shape[1]):
        big += eh[:, k, None] * qh[None, :, k]
        if small_terms:
            small1 += eh[:, k, None] * ql[None, :, k]
            small2 += el[:, k, None] * qh[None, :, k]
    return big + (small1 + small2)


def _plain_scores(emb, valid, q, ids):
    """The plain version's score of each winner id: (n_tiles, 16, B)."""
    sims = torch.where(torch.from_numpy(valid)[:, None],
                       torch.from_numpy(emb) @ torch.from_numpy(q).T, SA.NEG)
    tiles = -(-emb.shape[0] // SA.TILE_N)
    sims = torch.nn.functional.pad(sims, (0, 0, 0, tiles * SA.TILE_N - emb.shape[0]),
                                   value=SA.NEG)
    return torch.gather(sims.reshape(tiles, SA.TILE_N, -1), 1, ids.long())


def _tile_pass_error(emb, valid, q, small_terms=True):
    """The emulated tile pass against the plain one: (max score error,
    share of ids differing, largest plain-score gap at a differing id),
    after checking the exhausted rounds."""
    ks, ki = SA.stage_a_tile_rounds(torch.from_numpy(_scores_3xtf32(emb, q, small_terms)),
                                    torch.from_numpy(valid))
    ps, pi = SA.stage_a_tile_winners_reference(torch.from_numpy(emb), torch.from_numpy(valid),
                                               torch.from_numpy(q))
    exhausted = ps == SA.NEG
    assert torch.equal(ks == SA.NEG, exhausted) and (ki[exhausted] == 0).all()
    differ = ki != pi
    gap = 0.0
    if differ.any():
        g = _plain_scores(emb, valid, q, ki) - _plain_scores(emb, valid, q, pi)
        gap = float(g[differ].abs().max())
    return float((ks - ps).abs().max()), float(differ.float().mean()), gap


def _check(emb, valid, q):
    err, share, gap = _tile_pass_error(emb, valid, q)
    assert err <= TOL and share <= 0.01 and gap <= TOL, (err, share, gap)


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's last place at 1.0
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23, -(1.0 + 2.0 ** -11),
                  1.0 + 3 * 2.0 ** -11, 0.0, -0.0], np.float32)
    got = _tf32(x)
    want = np.array([one, one + ulp, one, -(one + ulp), one + 2 * ulp, 0.0, -0.0], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    r = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    assert (_tf32(r).view(np.uint32) & 0x1FFF == 0).all()
    assert np.abs(_tf32(r) - r).max() <= np.abs(r).max() * 2.0 ** -11


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_tile_pass_on_shared_cases(case):
    """Every case of tests/torch_stage_a_cases.py (ties across slabs, 40
    copies of the best row, exhausted and all-invalid tiles, ragged N, B up
    to 130), as the card tests run them through the f32 route."""
    _check(*stage_a_case(case))


def test_3xtf32_tile_pass_at_the_main_width():
    """2 tiles at D = 384 (phase 8's width), B = 33 (one query past a chunk
    of 32), holes in the validity; single TF32 products miss the bar."""
    rng = np.random.default_rng(20)
    n, d, b = 2 * SA.TILE_N, 384, 33
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) < 0.97
    _check(emb, valid, q)
    err, _share, _gap = _tile_pass_error(emb, valid, q, small_terms=False)
    assert err > TOL


@pytest.mark.parametrize("d", [3072, 4096])
def test_3xtf32_tile_pass_past_the_resident_width(d):
    """One tile at D = 3,072 and 4,096 (past the widths at which the first
    f32 route held its queries in shared memory; the kernel adds the same
    products in the same order, box by box), B = 33,
    holes in the validity: the bar holds over sums 8 to 11 times longer
    than at the main width."""
    rng = np.random.default_rng(d)
    n, b = SA.TILE_N, 33
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _check(emb, rng.random(n) < 0.97, q)


@pytest.mark.parametrize("dtype,d,b,route", [
    (torch.bfloat16, 384, 32, "wgmma"), (torch.bfloat16, 8, 1, "wgmma"),
    (torch.bfloat16, 4096, 300, "wgmma"), (torch.float32, 4, 1, "tf32"),
    (torch.float32, 384, 33, "tf32"), (torch.float32, 1536, 64, "tf32"),
    (torch.float32, 2912, 1, "tf32"),
    (torch.float32, 2916, 1, "tf32"), (torch.float32, 4096, 20, "tf32"),
    # widths the Pallas kernel takes (its blocks hold the whole D) that TMA
    # cannot describe (D * itemsize not a multiple of 16 bytes) or past 4,096
    (torch.bfloat16, 60, 1, "wgmma"), (torch.float32, 6, 1, "tf32"),
    (torch.bfloat16, 4104, 1, "wgmma"), (torch.float32, 4100, 1, "tf32")])
def test_stage_a_route(dtype, d, b, route):
    assert SA.stage_a_route(dtype, d, b) == route
    narrowest, widest = (8, 32) if dtype == torch.float32 else (16, 128)
    chunk = next(c for c in (8, 16, 32, 64, 128) if c >= max(narrowest, min(b, widest)))
    assert SA.stage_a_query_chunk(d, b, dtype) == chunk


@pytest.mark.parametrize("dtype,d,b,match", [
    (torch.float16, 64, 1, "bfloat16 or float32"), (torch.float64, 64, 1, "bfloat16 or float32"),
    (torch.float32, 0, 1, "not taken"), (torch.float32, 64, 0, "not taken")])
def test_stage_a_route_refuses_what_the_wrapper_refuses(dtype, d, b, match):
    with pytest.raises(ValueError, match=match):
        SA.stage_a_route(dtype, d, b)


def test_kernel_wrapper_raises_on_cpu_tensors_and_counts_nothing():
    emb, valid, q = (torch.from_numpy(x) for x in stage_a_case("b5"))
    before = {r: getattr(SA, c) for r, c in SA.ROUTE_COUNTERS.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        SA.stage_a_tile_winners_kernel(emb, valid, q)
    assert before == {r: getattr(SA, c) for r, c in SA.ROUTE_COUNTERS.items()}
