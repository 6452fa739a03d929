"""Device resolution: an explicit torch.device, never a silent fallback."""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple, Union

import torch

logger = logging.getLogger(__name__)


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """Map a device name to a torch.device. Asking for "cuda" (or "cuda:N")
    on a machine without CUDA raises: a caller that wants the card never
    ends up on the CPU without knowing it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev


def shard_count(n_shards: Optional[int], device: Union[str, torch.device] = "cuda"
                ) -> Tuple[int, int]:
    """(n, present) for `n_shards` shards on `device`'s type: on CUDA the
    shards used, capped to the CUDA devices present (n_shards None takes
    them all), and that count of devices; on the CPU n_shards (default 1)
    twice, as every CPU shard shares the one CPU device. The one rule of
    the cap: resolve_devices warns by it, the CLI prints the JAX CLI's
    line by it."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = max(int(n_shards or 1), 1)
        return n, n
    avail = torch.cuda.device_count()
    n = avail if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be at least 1, got {n}")
    return min(n, avail), avail


def resolve_devices(devices: Optional[Sequence] = None, n_shards: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda") -> List[torch.device]:
    """The devices of a corpus-sharded engine or graph, one per shard;
    shard 0's is the lead device.

    `devices` is taken as given; a device may repeat (four shards on one
    card), but all must be of one type: an engine picks its kernels or
    their plain versions for all its shards at once. Otherwise `n_shards`
    shards go on `device`'s type (shard_count): the first n CUDA devices,
    or, where fewer exist, those there are, with a warning that names both
    counts; on the CPU, n shards on the one CPU device. A CUDA device
    always carries its index, so equal devices compare equal."""
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("devices is empty")
        if len({d.type for d in out}) > 1:
            raise ValueError(f"devices mix types {sorted({d.type for d in out})}: the shards "
                             "of one engine are all on CUDA or all on the CPU")
        return [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda"
                and d.index is None else d for d in out]
    n, avail = shard_count(n_shards, device)
    if resolve_device(device).type == "cpu":
        return [torch.device("cpu")] * n
    if n_shards is not None and n < int(n_shards):
        logger.warning("%d shards requested but only %d CUDA devices are present: "
                       "using %d", int(n_shards), avail, avail)
    return [torch.device("cuda", i) for i in range(n)]
