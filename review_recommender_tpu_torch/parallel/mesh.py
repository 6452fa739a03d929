"""The training mesh: a (dp, tp) grid of devices.

Counterpart of the JAX trainers' `Mesh(devices.reshape(dp, tp), ("dp",
"tp"))`. One process drives every cell, as the corpus-sharded engine
does (parallel/sharded.py): cell (i, r) runs dp row i's slice of the
batch on tp rank r's shards. A device may repeat, so one card stands in
for a grid (four cells on one H100), and each cell still runs its own
slice of the work.

Cell (0, r) is the home of tp rank r's master shards; cell (0, 0) is the
lead device, which holds the replicated masters and computes the loss.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from review_recommender_tpu_torch.device import resolve_devices


class TrainMesh:
    """`devices` in row-major order: cell (i, r) is devices[i * tp + r]."""

    def __init__(self, devices: Sequence, dp: int, tp: int):
        dp, tp = int(dp), int(tp)
        if dp < 1 or tp < 1:
            raise ValueError(f"dp and tp must be at least 1, got dp={dp} tp={tp}")
        devs = resolve_devices(list(devices))  # refuses an empty list and mixed types
        if len(devs) != dp * tp:
            raise ValueError(f"a (dp={dp}, tp={tp}) mesh needs {dp * tp} devices, "
                             f"got {len(devs)}")
        self.dp, self.tp = dp, tp
        self.grid: List[List[torch.device]] = [devs[i * tp:(i + 1) * tp] for i in range(dp)]

    @property
    def lead(self) -> torch.device:
        return self.grid[0][0]

    def home(self, rank: int) -> torch.device:
        """The device of tp rank `rank`'s master shards."""
        return self.grid[0][rank]

    def __repr__(self) -> str:
        return f"TrainMesh(dp={self.dp}, tp={self.tp}, grid={self.grid})"
