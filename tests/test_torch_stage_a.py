"""The port's fused stage A (review_recommender_tpu_torch/ops/stage_a.py,
its plain tile pass on the CPU) against `stage_a_fused_pallas` in interpret
mode, as tests/test_stage_a_kernel.py runs it, on the same numpy inputs.

Row ids must be equal, repeats included: tile 1 keeps fewer than 16 valid
rows, so once it is exhausted every round returns -3.4e38 and its local
row 0 (the lowest index holding -3.4e38), chosen before or not. Dense
scores and BM25 agree to 1e-5 (unit-norm rows and queries: f32 sums of 64
products in another order differ by ~1e-7; BM25 sums of at most 16 x 8
contributions below 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.ops.pallas.stage_a_kernel import M_PER_TILE as J_M
from review_recommender_tpu.ops.pallas.stage_a_kernel import TILE_N as J_TILE
from review_recommender_tpu.ops.pallas.stage_a_kernel import stage_a_fused_pallas
from review_recommender_tpu_torch.ops import stage_a as SA
from tests.torch_stage_a_cases import CASES, stage_a_case

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, B, L, Q = 2 * SA.TILE_N, 64, 4, 16, 8
LIVE_IN_TILE1 = 5  # tile 1 is exhausted after 5 rounds
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.ones(N, bool)
    valid[SA.TILE_N:] = False
    valid[SA.TILE_N + rng.choice(SA.TILE_N, LIVE_IN_TILE1, replace=False)] = True
    valid[rng.choice(SA.TILE_N, 40, replace=False)] = False  # holes in tile 0
    terms = rng.integers(1, 500, (N, L)).astype(np.int32)
    terms[:, -3:] = 0  # PAD lanes (contribution 0)
    bm25 = np.where(terms > 0, rng.random((N, L)), 0).astype(np.float32)
    qvecs = rng.standard_normal((B, D)).astype(np.float32)
    qvecs /= np.linalg.norm(qvecs, axis=1, keepdims=True)
    q_shared = rng.integers(1, 500, Q).astype(np.int32)
    q_shared[[2, 5]] = terms[0, 0], 0  # one sure match, one PAD slot
    q_batch = rng.integers(1, 500, (B, Q)).astype(np.int32)
    q_batch[:, 0] = terms[np.arange(B), 1]
    return emb, valid, terms, bm25, qvecs, {"shared": q_shared, "per_query": q_batch}


def _jax(emb, valid, terms, bm25, qvecs, q_terms, pool, dtype):
    out = stage_a_fused_pallas(jnp.asarray(emb, dtype), jnp.asarray(valid), jnp.asarray(terms),
                               jnp.asarray(bm25), jnp.asarray(qvecs), jnp.asarray(q_terms),
                               pool=pool, interpret=True)
    return [np.asarray(x) for x in out]


def _port(emb, valid, terms, bm25, qvecs, q_terms, pool, dtype):
    t = torch.from_numpy
    out = SA.stage_a_fused(t(emb).to(dtype), t(valid), t(terms), t(bm25), t(qvecs),
                           t(q_terms), pool)
    return [x.numpy() for x in out]


def test_constants_match_the_tpu_kernel():
    assert (SA.TILE_N, SA.M_PER_TILE) == (J_TILE, J_M) == (2048, 16)
    assert np.float32(SA.NEG) == np.float32(-3.4e38)


@pytest.mark.parametrize("pool", [12, 16, 24])
@pytest.mark.parametrize("q_kind", ["shared", "per_query"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stage_a_fused_matches_pallas(data, dtype, q_kind, pool):
    emb, valid, terms, bm25, qvecs, q_terms = data
    jdt, tdt = DTYPES[dtype]
    rd, ri, rb = _jax(emb, valid, terms, bm25, qvecs, q_terms[q_kind], pool, jdt)
    gd, gi, gb = _port(emb, valid, terms, bm25, qvecs, q_terms[q_kind], pool, tdt)
    assert gd.shape == gi.shape == gb.shape == (B, pool)
    assert (gd.dtype, gi.dtype, gb.dtype) == (np.float32, np.int32, np.float32)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gd, rd, **TOL)
    np.testing.assert_allclose(gb, rb, **TOL)
    assert (gb > 0).any()
    if pool == 24:  # 16 + 5 real winners, then tile 1's exhausted rounds
        assert (gd[:, -3:] == np.float32(SA.NEG)).all()
        assert all(len(set(row[-4:].tolist())) < 4 for row in gi)  # repeated ids


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_winners_repeat_in_an_exhausted_tile(data, dtype):
    """The tile pass alone: tile 1's rounds past its 5 valid rows return
    -3.4e38 and local row 0, the lowest index holding it, again and again."""
    emb, valid, _terms, _bm25, qvecs, _q = data
    t = torch.from_numpy
    out_s, out_i = SA.stage_a_tile_winners_reference(t(emb).to(DTYPES[dtype][1]), t(valid),
                                                     t(qvecs))
    assert out_s.shape == out_i.shape == (2, SA.M_PER_TILE, B)
    assert (out_s[1, LIVE_IN_TILE1:].numpy() == np.float32(SA.NEG)).all()
    assert (out_i[1, LIVE_IN_TILE1:].numpy() == 0).all()
    live = set((np.flatnonzero(valid[SA.TILE_N:])).tolist())
    for b in range(B):
        assert set(out_i[1, :LIVE_IN_TILE1, b].tolist()) == live


@pytest.mark.parametrize("pool", [16, 24])
def test_unaligned_corpus_matches_zero_padded_pallas(data, pool):
    """N = 2048 + 5: the port masks the tail of tile 1; the JAX function gets
    the corpus zero-padded to 4096 rows with valid=False there. Exhausted
    rounds return row 2048, below N, on both sides."""
    emb, _valid, terms, bm25, qvecs, q_terms = data
    n = SA.TILE_N + LIVE_IN_TILE1
    valid = np.ones(n, bool)
    pad = lambda a: np.pad(a[:n], [(0, N - n)] + [(0, 0)] * (a.ndim - 1))
    rd, ri, rb = _jax(pad(emb), pad(valid), pad(terms), pad(bm25), qvecs,
                      q_terms["per_query"], pool, jnp.float32)
    gd, gi, gb = _port(emb[:n], valid, terms[:n], bm25[:n], qvecs, q_terms["per_query"],
                       pool, torch.float32)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gd, rd, **TOL)
    np.testing.assert_allclose(gb, rb, **TOL)
    if pool == 24:
        assert (gi[:, -3:] == SA.TILE_N).all() and (gi < n).all()


def test_recall_against_exact_topk(data):
    """The approximation contract: at pool <= 16 over two tiles the pool is
    the exact top-pool unless a tile holds more than 16 of it."""
    emb, valid, terms, bm25, qvecs, q_terms = data
    pool = SA.M_PER_TILE
    _d, idx, _b = _port(emb, valid, terms, bm25, qvecs, q_terms["shared"], pool, torch.float32)
    sims = qvecs @ emb.T
    sims[:, ~valid] = -np.inf
    recalls = [len(set(np.argsort(-sims[b])[:pool].tolist()) & set(idx[b].tolist())) / pool
               for b in range(B)]
    assert np.mean(recalls) >= 0.9, recalls


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_tile_pass_matches_pallas_on_shared_cases(case, dtype):
    """The shared edge cases (tests/torch_stage_a_cases.py), every tile
    winner in the pool (pool = n_tiles * 16): ids equal, repeats of
    exhausted tiles included, except between two f32 rows whose exact
    scores are within 1e-6 (at B = 130 XLA's product and torch's sum in
    other orders and swap such a pair); dense scores within 1e-5. The JAX
    function gets the corpus zero-padded to whole tiles with valid=False
    there."""
    emb, valid, qvecs = stage_a_case(case)
    n, b = emb.shape[0], qvecs.shape[0]
    tiles = -(-n // SA.TILE_N)
    pool = tiles * SA.M_PER_TILE
    terms = np.zeros((n, 1), np.int32)
    bm25 = np.zeros((n, 1), np.float32)
    q_terms = np.zeros(1, np.int32)
    pad = lambda a: np.pad(a, [(0, tiles * SA.TILE_N - n)] + [(0, 0)] * (a.ndim - 1))
    jdt, tdt = DTYPES[dtype]
    rd, ri, _ = _jax(pad(emb), pad(valid), pad(terms), pad(bm25), qvecs, q_terms, pool, jdt)
    gd, gi, _ = _port(emb, valid, terms, bm25, qvecs, q_terms, pool, tdt)
    assert gi.shape == (b, pool)
    np.testing.assert_allclose(gd, rd, **TOL)
    differ = gi != ri  # only where two rows' scores tie to f32 summation order
    assert differ.mean() <= 1e-3, differ.sum()
    if differ.any():
        e64 = emb.astype(np.float64)
        exact = lambda ids: np.take_along_axis(qvecs.astype(np.float64) @ e64.T, ids, axis=1)
        gap = np.abs(exact(gi.astype(np.int64)) - exact(ri.astype(np.int64)))[differ]
        assert dtype == "float32" and gap.max() <= 1e-6, gap.max()
    out_s, out_i = (x.numpy() for x in SA.stage_a_tile_winners_reference(
        torch.from_numpy(emb).to(tdt), torch.from_numpy(valid), torch.from_numpy(qvecs)))
    live = [int(valid[t * SA.TILE_N:(t + 1) * SA.TILE_N].sum()) for t in range(tiles)]
    for t, v in enumerate(live):  # rounds past a tile's valid rows: (-3.4e38, row 0)
        assert (out_s[t, v:] == np.float32(SA.NEG)).all() and (out_i[t, v:] == 0).all()
        assert (out_s[t, :v] > np.float32(SA.NEG)).all()
    if case == "dup_best":  # the 16 lowest indices of the 40 copies
        copies = np.flatnonzero((emb[:SA.TILE_N] == qvecs[0]).all(axis=1))
        np.testing.assert_array_equal(out_i[0, :, 0], copies[:SA.M_PER_TILE])
    if case == "tie_across_slabs":  # the tie at the 16th place goes to row 63
        assert out_i[0, -1, 0] == 63 and 64 not in out_i[0, :, 0]


def test_kernel_wrapper_refuses_cpu_tensors(data):
    emb, valid, _terms, _bm25, qvecs, _q = data
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensors"):
        SA.stage_a_tile_winners_kernel(t(emb), t(valid), t(qvecs))
    assert SA.stage_a_kernel_launches == 0


@pytest.mark.parametrize("dtype,d", [("bfloat16", 60), ("bfloat16", 5000), ("float32", 6),
                                     ("float32", 4100)])
def test_stage_a_fused_matches_pallas_at_every_width(dtype, d):
    """Widths the Pallas kernel takes (its blocks hold the whole D) that the
    card's first routes refused: rows of 120 and 24 bytes (not a multiple
    of 16) and D past 4,096. Two tiles, the second exhausted after 5 rounds,
    every winner in the pool (pool = 32): ids equal, repeats included, and
    dense scores within 1e-5 (unit rows and queries, f32 sums of up to
    5,000 products in another order than XLA's)."""
    rng = np.random.default_rng(d)
    emb = rng.standard_normal((N, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.ones(N, bool)
    valid[SA.TILE_N:] = False
    valid[SA.TILE_N + rng.choice(SA.TILE_N, LIVE_IN_TILE1, replace=False)] = True
    valid[rng.choice(SA.TILE_N, 40, replace=False)] = False
    qvecs = rng.standard_normal((B, d)).astype(np.float32)
    qvecs /= np.linalg.norm(qvecs, axis=1, keepdims=True)
    terms = rng.integers(1, 500, (N, L)).astype(np.int32)
    bm25 = rng.random((N, L)).astype(np.float32)
    q_terms = terms[:B, 0].copy()
    pool = 2 * SA.M_PER_TILE
    jdt, tdt = DTYPES[dtype]
    rd, ri, rb = _jax(emb, valid, terms, bm25, qvecs, q_terms, pool, jdt)
    gd, gi, gb = _port(emb, valid, terms, bm25, qvecs, q_terms, pool, tdt)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gd, rd, **TOL)
    np.testing.assert_allclose(gb, rb, **TOL)
    assert (gd[:, -(SA.M_PER_TILE - LIVE_IN_TILE1):] == np.float32(SA.NEG)).all()
    assert all(len(set(row[-4:].tolist())) < 4 for row in gi)  # repeated ids
