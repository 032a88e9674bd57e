"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a card raises.

    Only an explicit CPU device runs on the CPU: nothing falls back to it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tdal_torch: CUDA requested but no CUDA device is available "
            "(pass device='cpu' to run the plain versions on the CPU)"
        )
    return dev
