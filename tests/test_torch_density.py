"""The port's density clustering (review_recommender_tpu_torch/topics/
density.py) against the JAX package's, on the same seeded numpy inputs,
torch on the CPU.

`knn_graph`: similarities within SIM_TOL (1e-6; -inf tails in the same
places) and neighbour ids equal except swaps between two neighbours
whose exact (f64) similarities to the row are within SIM_TOL: the two
packages sum the f32 products in another order. `density_cluster`:
labels equal, and the info's counts equal with eps within SIM_TOL. The
cases are those of tests/test_density.py's single-device classes (exact
against brute force, self at rank 0, empty, negative-similarity tails,
the pad leak, n < k, one row, more than k exact duplicates, explicit
eps, too few neighbours, runts dissolved, size order, the planted
blobs), at batch and chunk sizes that do not divide N, and the sharded
forms refused naming ROADMAP item 12.
"""
import numpy as np
import pytest

from review_recommender_tpu.topics import density as jax_density
from review_recommender_tpu_torch.topics import density as port_density
from tests.test_density import blobs_with_noise as jax_blobs
from tests.torch_topic_cases import (
    GRAPH_CASES,
    assert_ids_differ_only_at_near_ties,
    blobs_with_noise,
    rand_rows,
    unit,
)

SIM_TOL = 1e-6


def assert_graphs_match(emb, k, **kw):
    """Both graphs of emb: sims within SIM_TOL, ids equal but for near ties."""
    js, ji = jax_density.knn_graph(emb, k=k, **kw)
    ts, ti = port_density.knn_graph(emb, k=k, device="cpu", **kw)
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    np.testing.assert_allclose(ts, js, atol=SIM_TOL, rtol=0)
    assert_ids_differ_only_at_near_ties(emb, ti, ji, SIM_TOL)
    return ts, ti


def assert_clusters_match(emb, **kw):
    jl, jinfo = jax_density.density_cluster(emb, **kw)
    tl, tinfo = port_density.density_cluster(emb, device="cpu", **kw)
    assert tl.dtype == np.int32
    np.testing.assert_array_equal(tl, jl)
    assert set(tinfo) == set(jinfo)
    assert {k: v for k, v in tinfo.items() if k != "eps"} == \
        {k: v for k, v in jinfo.items() if k != "eps"}
    assert tinfo["eps"] == pytest.approx(jinfo["eps"], abs=SIM_TOL)
    return tl, tinfo


def test_shared_blobs_are_the_jax_tests_blobs():
    for kw in ({}, {"n_per": 40, "k": 4, "d": 32, "noise": 20, "seed": 3}):
        for a, b in zip(blobs_with_noise(**kw), jax_blobs(**kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_knn_graph_matches_jax(case):
    make, k, kw = GRAPH_CASES[case]
    emb = make()
    sims, idx = assert_graphs_match(emb, k, **kw)
    k_eff = min(k, len(emb))
    assert sims.shape == (len(emb), k_eff)
    full = unit(emb) @ unit(emb).T if case != "zero_rows" else None
    if full is not None:  # every slot holds a real neighbour, scored exactly
        assert (idx >= 0).all() and np.isfinite(sims).all()
        want = -np.sort(-full, axis=1)[:, :k_eff]
        np.testing.assert_allclose(sims, want, atol=1e-5)
        np.testing.assert_allclose(np.take_along_axis(full, idx, 1), want, atol=1e-5)
    if case == "self_rank0":
        assert (idx[:, 0] == np.arange(40)).all()
    if case == "duplicates":  # 25 equal rows: each takes the lowest 11 ids, self or not
        assert (idx[:25] == np.arange(11)).all()


def test_knn_graph_of_empty_corpus():
    for fn, kw in ((jax_density.knn_graph, {}), (port_density.knn_graph, {"device": "cpu"})):
        sims, idx = fn(np.zeros((0, 8), np.float32), k=4, **kw)
        assert sims.shape == idx.shape == (0, 4)
        assert sims.dtype == np.float32 and idx.dtype == np.int32


def test_order_keys_round_trip_and_order():
    """The int64 keys order (value desc, column asc) with no ties, -0.0 as
    +0.0, and decode to the same values and columns."""
    import torch

    vals = torch.tensor([[0.5, -0.0, 0.0, -0.25, float("-inf"), 0.5, 1.0, -1.0]])
    cols = torch.tensor([[3, 4, 2, 7, -1, 1, 9, 0]])
    keys = port_density._order_keys(vals, cols)
    back_v, back_c = port_density._from_keys(keys)
    assert torch.equal(back_c, cols)
    assert torch.equal(back_v, vals + 0.0)
    order = torch.argsort(keys[0], descending=True).tolist()
    assert [cols[0, i].item() for i in order] == [9, 1, 3, 2, 4, 7, 0, -1]


CLUSTER_CASES = {
    "blobs": (lambda: blobs_with_noise()[0], dict(min_samples=5, min_cluster_size=30, knn=12)),
    "runts_dissolve": (lambda: blobs_with_noise(n_per=120, k=3)[0],
                       dict(min_samples=5, min_cluster_size=500, knn=12)),
    "size_order": (lambda: unit(np.concatenate([
        np.random.default_rng(7).standard_normal((60, 16)) * 0.05 - 1.0,
        np.random.default_rng(8).standard_normal((200, 16)) * 0.05 + 1.0])),
        dict(min_samples=4, min_cluster_size=10, knn=8)),
    "explicit_eps": (lambda: blobs_with_noise()[0],
                     dict(min_samples=5, min_cluster_size=10, eps=0.25)),
    "pad_leak": (lambda: rand_rows(24, 8, 0), dict(min_samples=3, min_cluster_size=2)),
    "too_few_neighbours": (lambda: rand_rows(8, 384, 0), dict(min_samples=10)),
    "one_row": (lambda: np.ones((1, 8), np.float32), {}),
    "duplicates": (lambda: np.concatenate([np.tile(rand_rows(1, 12, 1), (25, 1)), rand_rows(200, 12, 2)]),
                   dict(min_samples=10, min_cluster_size=20)),
    # batch and chunk sizes that divide neither N = 420 nor each other
    "ragged_chunks": (lambda: blobs_with_noise(seed=9)[0],
                      dict(min_samples=5, min_cluster_size=20, batch_rows=48, col_chunk=100)),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_density_cluster_matches_jax(case):
    make, kw = CLUSTER_CASES[case]
    labels, info = assert_clusters_match(make(), **kw)
    if case == "blobs":
        assert info["n_clusters"] == 3
    if case in ("runts_dissolve", "too_few_neighbours", "one_row"):
        assert info["n_clusters"] == 0 and (labels == -1).all()
    if case == "explicit_eps":
        assert info["eps"] == 0.25
    if case == "duplicates":
        assert (labels[:25] >= 0).all() and len(set(labels[:25].tolist())) == 1
    if case == "size_order":
        sizes = np.bincount(labels[labels >= 0])
        assert info["n_clusters"] == 2 and sizes[0] >= sizes[1]


def test_density_cluster_of_empty_corpus_and_stage_seconds():
    labels, info = port_density.density_cluster(np.zeros((0, 8), np.float32), device="cpu")
    assert labels.shape == (0,) and info == {"n_clusters": 0, "noise": 0, "eps": 0.0}
    stats = {}
    port_density.density_cluster(blobs_with_noise()[0], min_samples=5, device="cpu",
                                 stats=stats)
    assert set(stats) == {"graph_s", "union_find_s", "border_s", "renumber_s", "edges"}
    assert stats["edges"] > 0 and all(v >= 0 for v in stats.values())


@pytest.mark.parametrize("kw", [{"n_shards": 2}, {"mesh": object()}])
def test_sharded_density_is_refused_naming_item_12(kw):
    with pytest.raises(NotImplementedError, match="item 12"):
        port_density.density_cluster(rand_rows(10, 8, 0), device="cpu", **kw)


def test_cuda_is_the_default_device():
    """Without an argument the graph runs on CUDA, or raises where there is none."""
    import torch

    if torch.cuda.is_available():
        assert port_density.knn_graph(rand_rows(4, 8, 0), k=2)[1].shape == (4, 2)
        return
    for fn in (lambda e: port_density.knn_graph(e, k=2), port_density.density_cluster):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(rand_rows(4, 8, 0))
