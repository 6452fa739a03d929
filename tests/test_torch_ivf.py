"""The port's IVF pool (review_recommender_tpu_torch/ops/ivf.py,
topics/cluster.py, DENSE_POOL_MODE=ivf) against the JAX package's.

k-means: the farthest-point seeds are bit-equal (the same numpy code on the
same rng stream); ids equal except rows whose two best similarities lie
within 1e-5; centers within 1e-5. ivf_topk, given the same IVFIndex (built
by the JAX package, passed as numpy to both): equal ids, scores within
1e-5, for dead blocks, nprobe >= NB (equal to the exact pool), a pool
longer than nprobe * Mb (padded with -inf) and each batched row against
its single query. measure_pool_recall equals the JAX value. The engines
(f32 and bf16 corpora) build the JAX engine's blocks and match its SKU
order and signal columns within 1e-5 (query_e2e and the coalesced rerank
within 1e-4; tests/torch_pool_cases.py). The
footprint bound is the true worst case, where the JAX audit's flat 1.25x
of the corpus is not (the one stated exception to audit parity)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.ops import dense as jd
from review_recommender_tpu.ops import ivf as jivf
from review_recommender_tpu.topics import cluster as jcluster
from review_recommender_tpu_torch.config import config as port_config
from review_recommender_tpu_torch.ops import ivf as tivf
from review_recommender_tpu_torch.topics import cluster as tcluster
from tests import torch_pool_cases as cases

TOL = dict(rtol=1e-5, atol=1e-5)


def _clustered(seed=0, n=3000, d=32, n_clusters=40, spread=0.3, n_invalid=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d))
    emb = (centers[rng.integers(0, n_clusters, n)]
           + spread * rng.standard_normal((n, d))).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.arange(n) < n - n_invalid
    emb[~valid] = 0.0
    qs = (emb[rng.integers(0, n - n_invalid, 7)]
          + 0.1 * rng.standard_normal((7, d))).astype(np.float32)
    return emb, valid, qs


def _dev(jix, emb, dtype=jnp.float32):
    """Both packages' ivf_topk tensors for the JAX-built index jix."""
    jdev = jivf.ivf_device_arrays(jix, emb, dtype)
    tix = tivf.IVFIndex(*(np.asarray(getattr(jix, f)) for f in
                          ("centroids", "block_row_ids", "block_valid", "block_centroid")))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tdev = tivf.ivf_device_arrays(tix, torch.from_numpy(emb).to(tdt))
    return tuple(jdev[k] for k in tivf.IVF_KEYS), tuple(tdev[k] for k in tivf.IVF_KEYS)


def _jax_ivf_topk(jdev, qs, pool, nprobe):
    f = jax.vmap(lambda q: jivf.ivf_topk(*jdev, q, pool, nprobe))
    return (np.asarray(x) for x in f(jnp.asarray(qs)))


def _check_topk(jdev, tdev, qs, pool, nprobe):
    js, ji = _jax_ivf_topk(jdev, qs, pool, nprobe)
    ts, ti = tivf.ivf_topk(*tdev, torch.from_numpy(qs), pool, nprobe)
    assert ts.shape == ti.shape == (len(qs), pool)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, **TOL)
    for b in range(len(qs)):
        s1, i1 = tivf.ivf_topk(*tdev, torch.from_numpy(qs[b]), pool, nprobe)
        np.testing.assert_array_equal(i1.numpy(), ti[b].numpy())
        np.testing.assert_array_equal(s1.numpy(), ts[b].numpy())
    return ts.numpy(), ti.numpy()


# ------------------------------------------------------------------ k-means
def test_seeding_is_bit_equal():
    emb, valid, _q = _clustered(1)
    _ji, jc = jcluster.spherical_kmeans(emb[valid], k=50, iters=0, seed=3)
    _ti, tc = tcluster.spherical_kmeans(emb[valid], k=50, iters=0, seed=3, device="cpu")
    np.testing.assert_array_equal(tc, np.asarray(jc))


def test_seeding_pads_a_tiny_input_with_jitter():
    emb, valid, _q = _clustered(2, n=12, n_invalid=0)
    _ji, jc = jcluster.spherical_kmeans(emb, k=20, iters=0, seed=0)
    _ti, tc = tcluster.spherical_kmeans(emb, k=20, iters=0, seed=0, device="cpu")
    np.testing.assert_array_equal(tc, np.asarray(jc))


@pytest.mark.parametrize("k,iters,batch_rows", [(60, 10, 65536), (25, 5, 512), (200, 3, 1000)])
def test_kmeans_matches_jax(k, iters, batch_rows):
    emb, valid, _q = _clustered(4)
    x = emb[valid]
    ji, jc = jcluster.spherical_kmeans(x, k=k, iters=iters, batch_rows=batch_rows, seed=0)
    stats = {}
    ti, tc = tcluster.spherical_kmeans(x, k=k, iters=iters, batch_rows=batch_rows, seed=0,
                                       device="cpu", stats=stats)
    np.testing.assert_allclose(tc, np.asarray(jc), **TOL)
    ji = np.asarray(ji)
    sims = x @ np.asarray(jc).T
    top2 = np.sort(sims, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-5
    assert ((ti == ji) | near_tie).all()
    assert 1 <= stats["iters"] <= iters and stats["seed_s"] >= 0 and stats["iters_s"] >= 0


def test_kmeans_empty_input():
    ti, tc = tcluster.spherical_kmeans(np.zeros((0, 8), np.float32), k=4, device="cpu")
    assert ti.shape == (0,) and tc.shape == (4, 8)


# ---------------------------------------------------------------- the build
@pytest.mark.parametrize("n_centroids,block_rows", [(0, 0), (30, 16), (200, 0)])
def test_build_ivf_matches_jax(n_centroids, block_rows):
    """The same centroids (1e-5) and the same blocks on a clustered corpus;
    padding rows are in no block."""
    emb, valid, _q = _clustered(5)
    jix = jivf.build_ivf(emb, valid, n_centroids=n_centroids, block_rows=block_rows)
    tix = tivf.build_ivf(emb, valid, n_centroids=n_centroids, block_rows=block_rows,
                         device="cpu")
    np.testing.assert_allclose(tix.centroids, jix.centroids, **TOL)
    for f in ("block_row_ids", "block_valid", "block_centroid"):
        np.testing.assert_array_equal(getattr(tix, f), getattr(jix, f), err_msg=f)
    placed = tix.block_row_ids[tix.block_valid]
    assert sorted(placed.tolist()) == np.nonzero(valid)[0].tolist()
    assert tix.stats["n_blocks"] == tix.n_blocks and 0 < tix.stats["fill"] <= 1


def test_auto_sizes_match_jax():
    for n in (0, 1, 100, 5000, 200_000, 10**7):
        assert tivf.auto_centroids(n) == jivf.auto_centroids(n)
        for c in (1, 16, 1788):
            assert tivf.auto_block_rows(n, c) == jivf.auto_block_rows(n, c)


def test_build_ivf_without_valid_rows():
    emb = np.zeros((16, 8), np.float32)
    jix = jivf.build_ivf(emb, np.zeros(16, bool), block_rows=4)
    tix = tivf.build_ivf(emb, np.zeros(16, bool), block_rows=4, device="cpu")
    for f in ("centroids", "block_row_ids", "block_valid", "block_centroid"):
        np.testing.assert_array_equal(getattr(tix, f), getattr(jix, f))


# ------------------------------------------------------------------ the probe
@pytest.mark.parametrize("pool,nprobe", [(50, 4), (150, 8), (150, 1), (10, 32)])
def test_ivf_topk_matches_jax_on_a_shared_index(pool, nprobe):
    emb, valid, qs = _clustered(6)
    jix = jivf.build_ivf(emb, valid)
    _check_topk(*_dev(jix, emb), qs, pool, nprobe)


def test_ivf_topk_bf16_blocks_match_jax():
    emb, valid, qs = _clustered(7)
    jix = jivf.build_ivf(emb, valid)
    _check_topk(*_dev(jix, emb, jnp.bfloat16), qs, 100, 6)


def test_nprobe_over_the_block_count_is_the_exact_pool():
    emb, valid, qs = _clustered(8)
    jix = jivf.build_ivf(emb, valid)
    jdev, tdev = _dev(jix, emb)
    ts, ti = _check_topk(jdev, tdev, qs, 150, jix.n_blocks + 5)
    es, ei = jd.dense_topk_batched(jnp.asarray(emb), jnp.asarray(qs), jnp.asarray(valid), 150)
    np.testing.assert_array_equal(ti, np.asarray(ei))
    np.testing.assert_allclose(ts, np.asarray(es), **TOL)


def test_pool_longer_than_the_probed_rows_is_padded():
    emb, valid, qs = _clustered(9)
    jix = jivf.build_ivf(emb, valid, block_rows=16)
    ts, ti = _check_topk(*_dev(jix, emb), qs, 100, 2)  # 2 x 16 slots < 100
    assert np.isneginf(ts[:, 32:]).all() and (ti[:, 32:] == 0).all()


def test_dead_blocks_never_win_a_probe_slot():
    """Blocks with no valid slot (as a mesh shard pads them) score -inf:
    with one live block per query direction left, the probe still finds
    the live rows, as in JAX."""
    emb, valid, qs = _clustered(10)
    jix = jivf.build_ivf(emb, valid)
    nb, mb = jix.block_row_ids.shape
    dead = 6
    jix.block_row_ids = np.concatenate([jix.block_row_ids, np.zeros((dead, mb), np.int32)])
    jix.block_valid = np.concatenate([jix.block_valid, np.zeros((dead, mb), bool)])
    # dead blocks claim the centroid every query likes best
    jix.block_centroid = np.concatenate(
        [jix.block_centroid, np.full(dead, int(np.argmax(jix.centroids @ qs[0])), np.int32)])
    jdev, tdev = _dev(jix, emb)
    ts, ti = _check_topk(jdev, tdev, qs, 60, 4)
    cs = torch.from_numpy(qs) @ tdev[0].T
    bids = torch.sort(torch.where(tdev[2].any(1), cs[:, tdev[4]], float("-inf")), dim=1,
                      descending=True, stable=True)[1][:, :4]
    assert (bids < nb).all()
    assert np.isfinite(ts[:, 0]).all()


def test_measure_pool_recall_matches_jax():
    emb, valid, _q = _clustered(11)
    jix = jivf.build_ivf(emb, valid)
    jdev, tdev = _dev(jix, emb)
    for nprobe, n_queries in ((2, 16), (8, 5), (10_000, 16)):
        want = jivf.measure_pool_recall(jnp.asarray(emb), jnp.asarray(valid), jdev, 150, nprobe,
                                        n_queries=n_queries)
        got = tivf.measure_pool_recall(torch.from_numpy(emb), torch.from_numpy(valid), tdev,
                                       150, nprobe, n_queries=n_queries)
        assert got == want
    assert got == 1.0  # nprobe over the block count: exact


def test_footprint_bound_holds_and_the_jax_estimate_does_not():
    """After the build, the real ivf_* bytes stay within the bound the
    engine enforced before it; on a corpus of many small clusters the
    blocks outgrow the JAX audit's 1.25x of the corpus, the stated
    exception to audit parity."""
    emb, valid, _q = _clustered(12, n=3000, n_clusters=400, spread=0.05)
    for c, mb in ((0, 0), (400, 64), (50, 16)):
        tix = tivf.build_ivf(emb, valid, n_centroids=c, block_rows=mb, device="cpu")
        dev = tivf.ivf_device_arrays(tix, torch.from_numpy(emb).to(torch.bfloat16))
        real = tivf.ivf_device_bytes(dev)
        bound = tivf.ivf_footprint_bound(int(valid.sum()), emb.shape[1], 2, c, mb)
        assert real <= bound, (c, mb, real, bound)
    tix = tivf.build_ivf(emb, valid, n_centroids=400, block_rows=64, device="cpu")
    blocks_bytes = tix.n_blocks * tix.block_rows * emb.shape[1] * 2
    assert blocks_bytes > 1.25 * emb.shape[0] * emb.shape[1] * 2


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def engines():
    return cases.make_engines({"f32": ("float32", "ivf"), "bf16": ("bfloat16", "ivf")},
                              knobs={"IVF_NPROBE": 8})


def test_engine_builds_the_jax_blocks(engines):
    for je, te in engines.values():
        assert te.ivf_nprobe == je.ivf_nprobe == 8
        np.testing.assert_allclose(te.ivf.centroids, je.ivf.centroids, **TOL)
        for f in ("block_row_ids", "block_valid", "block_centroid"):
            np.testing.assert_array_equal(getattr(te.ivf, f), getattr(je.ivf, f), err_msg=f)
        assert te.ivf_pool_recall == je.ivf_pool_recall
        assert te.ivf.n_blocks > te.ivf_nprobe  # the probe is approximate here
        assert te.ivf.stats["device_bytes"] <= te.hbm_report["total_bytes"]


@pytest.mark.parametrize("rerank_k", [0, 50])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_run_search_ivf_matches_jax(engines, dtype, rerank_k):
    cases.check_run_search(*engines[dtype], rerank_k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_forms_ivf_match_jax(engines, dtype):
    cases.check_fused_forms(*engines[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_search_dense_ivf_matches_jax(engines, dtype):
    cases.check_search_dense(*engines[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_e2e_and_coalesced_rerank_ivf_match_jax(engines, dtype):
    cases.check_e2e_and_coalesced(*engines[dtype])


def test_selfcheck_warns_below_its_minimum(engines, monkeypatch, caplog):
    from review_recommender_tpu_torch.engine.search import SearchEngine

    _je, te = engines["f32"]
    for name, value in (("IVF_NPROBE", 1), ("IVF_SELFCHECK_MIN", 0.999)):
        monkeypatch.setattr(port_config, name, value)
    with caplog.at_level("WARNING"):
        low = SearchEngine(te.bundle, device="cpu", emb_dtype="float32", dense_pool="ivf")
    assert low.ivf_pool_recall < 0.999
    assert "IVF pool recall self-check" in caplog.text
    monkeypatch.setattr(port_config, "IVF_SELFCHECK_QUERIES", 0)
    assert SearchEngine(te.bundle, device="cpu", emb_dtype="float32",
                        dense_pool="ivf").ivf_pool_recall is None
