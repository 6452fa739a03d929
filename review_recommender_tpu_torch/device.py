"""Device resolution: an explicit torch.device, never a silent fallback."""
from __future__ import annotations

from typing import Union

import torch


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
