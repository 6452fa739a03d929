"""Edge cases of the stage-A tile pass, shared by the card tests
(tests/test_torch_gpu.py: the CUDA kernels against the plain version) and
the CPU parity tests (tests/test_torch_stage_a.py: the plain version
against the Pallas kernel in interpret mode).

Each case is a corpus (N, D) f32, its valid mask (N,) and queries (B, D)
f32 as numpy arrays, D = 64:

  dup_best          40 copies of query 0's best row in tile 0: its 16
                    rounds are the 16 lowest of their indices
  tie_across_slabs  query 0's 16th best score held by 5 equal rows, two of
                    them at rows 63 and 64 (the first two 64-row slabs) and
                    the others later: the 16th round is row 63
  all_invalid_tile  tile 1 has no valid row: every round (-3.4e38, 0)
  valid_16          tile 1 has exactly 16 valid rows
  valid_17          tile 1 has 17
  ragged_n          N = 2 * 2048 + 37: not a multiple of 64 or 2048
  b1, b5, b33, b130 B queries on a 2-tile corpus with a ragged tail and holes
"""
import numpy as np

TILE_N = 2048
DIM = 64
CASES = ["dup_best", "tie_across_slabs", "all_invalid_tile", "valid_16", "valid_17",
         "ragged_n", "b1", "b5", "b33", "b130"]


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def stage_a_case(name: str):
    """(emb (N, D) f32, valid (N,) bool, qvecs (B, D) f32) for one of CASES."""
    rng = np.random.default_rng(CASES.index(name) + 31)
    n = {"ragged_n": 2 * TILE_N + 37, "tie_across_slabs": TILE_N}.get(
        name, 2 * TILE_N + (100 if name.startswith("b") else 0))
    b = int(name[1:]) if name.startswith("b") else 4
    emb = _unit(rng, (n, DIM))
    valid = np.ones(n, bool)
    q = _unit(rng, (b, DIM))
    if name == "dup_best":
        emb[rng.choice(TILE_N, 40, replace=False)] = q[0]  # score 1 against query 0
    elif name == "tie_across_slabs":
        tops = rng.choice(np.arange(200, TILE_N), 15, replace=False)
        emb[tops] = q[0] * (2.0 - 0.03 * np.arange(15, dtype=np.float32))[:, None]
        emb[[1500, 64, 1000, 63, 700]] = q[0] * np.float32(1.5)  # below every top, above the rest
    elif name == "all_invalid_tile":
        valid[TILE_N:] = False
    elif name in ("valid_16", "valid_17"):
        valid[TILE_N:] = False
        valid[TILE_N + rng.choice(n - TILE_N, int(name[-2:]), replace=False)] = True
    if name == "ragged_n" or name.startswith("b"):
        valid[rng.choice(n, n // 20, replace=False)] = False  # holes
    return emb, valid, q
