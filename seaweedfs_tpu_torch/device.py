"""Device resolution for the port's entry points.

Every public entry point runs on `cuda` unless the caller passes
`device="cpu"` (as the CPU tests do).  With no card and no explicit CPU
request it raises: the port never quietly runs its device path on the
host.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """torch.device for `device` (None means "cuda"); raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
