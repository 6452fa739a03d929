"""Shared inputs of the density tests of the port (tests/test_torch_density.py
on the CPU against JAX, tests/test_torch_gpu.py on the card against the
CPU), importing no jax: seeded unit rows, a copy of tests/test_density.py's
`blobs_with_noise` (draw for draw), the kNN graph cases, the near-tie
check of neighbour ids, and reviews of four planted topics for the topic
pipeline's tests (tests/test_torch_topics.py, the card's CLI test)."""
import numpy as np


def unit(rows):
    rows = np.asarray(rows, np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def rand_rows(n, d, seed):
    return unit(np.random.default_rng(seed).standard_normal((n, d)))


def blobs_with_noise(n_per=120, k=3, d=24, noise=60, spread=0.08, seed=0):
    """k tight spherical blobs + isotropic noise points: (emb unit rows,
    truth with -1 for noise)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    for i in range(1, k):  # keep blob centers well separated
        while max(centers[i] @ centers[j] for j in range(i)) > 0.3:
            c = rng.standard_normal(d)
            centers[i] = c / np.linalg.norm(c)
    emb, truth = [], []
    for c in range(k):
        emb.append(centers[c] + spread * rng.standard_normal((n_per, d)))
        truth += [c] * n_per
    emb.append(rng.standard_normal((noise, d)))
    truth += [-1] * noise
    emb = np.concatenate(emb).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, np.asarray(truth)


# name -> (rows, k, knn_graph keywords)
GRAPH_CASES = {
    # multi-block rows and columns, neither dividing 73
    "ragged_chunks": (lambda: rand_rows(73, 12, 3), 7, dict(batch_rows=16, col_chunk=32)),
    "self_rank0": (lambda: rand_rows(40, 8, 4), 3, {}),
    # 19 real neighbours with negative sims: no pad may displace them
    "negative_tails": (lambda: rand_rows(20, 64, 3), 19, dict(batch_rows=8, col_chunk=16)),
    "n_below_k": (lambda: rand_rows(5, 8, 1), 10, dict(batch_rows=2, col_chunk=3)),
    "one_row": (lambda: rand_rows(1, 8, 2), 4, {}),
    "duplicates": (lambda: np.concatenate([np.tile(rand_rows(1, 12, 1), (25, 1)),
                                           rand_rows(200, 12, 2)]),
                   11, dict(batch_rows=64, col_chunk=50)),
    "wide_rows": (lambda: rand_rows(300, 384, 0), 13, dict(batch_rows=64, col_chunk=100)),
    "zero_rows": (lambda: np.concatenate([rand_rows(30, 16, 5), np.zeros((3, 16), np.float32)]),
                  6, dict(batch_rows=7, col_chunk=11)),
}


def assert_ids_differ_only_at_near_ties(emb, ids, want_ids, tol):
    """ids and want_ids (N, k) equal except where the two rows' exact (f64)
    similarities to the query row are within tol."""
    e = np.asarray(emb, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    for r, c in zip(*np.nonzero(ids != want_ids)):
        assert ids[r, c] >= 0 and want_ids[r, c] >= 0, (r, c)
        assert abs(e[r] @ e[ids[r, c]] - e[r] @ e[want_ids[r, c]]) <= tol, (r, c)


TOPIC_WORDS = [
    "battery charge charging power cable drains hours".split(),
    "shipping delivery arrived package box late courier".split(),
    "comfortable soft fit cozy fabric warm stretchy".split(),
    "price value worth expensive cheap cost deal".split(),
]
COMMON = "really very product item good bad ok great".split()


def topic_reviews(skus, seed=3):
    """Four blobs of 40 reviews (texts of their topic's words) and 20 noise
    reviews of common words; stars 1-5 with a few NaN."""
    emb, truth = blobs_with_noise(n_per=40, k=4, d=32, noise=20, spread=0.1, seed=seed)
    rng = np.random.default_rng(seed)
    rows = []
    for i, t in enumerate(truth):
        words = list(rng.choice(TOPIC_WORDS[t], 4)) if t >= 0 else []
        words += list(rng.choice(COMMON, 3))
        rng.shuffle(words)
        rows.append({"sku": skus[int(rng.integers(len(skus)))], "text": " ".join(words),
                     "stars": float("nan") if i % 23 == 0 else float(rng.integers(1, 6))})
    return rows, emb
