"""Device resolution for the port's entry points.

Every public entry point runs on `cuda` unless the caller passes
`device="cpu"` (as the CPU tests do).  With no card and no explicit CPU
request it raises: the port never quietly runs its device path on the
host.

Fork rule: nothing here creates a CUDA context or calls `cuInit`.  A
volume server builds its Store (and so resolves the devices of its EC
volumes and read-cache tier) before its prefork workers fork, and a
context made in the parent would poison every worker's first kernel
("Cannot re-initialize CUDA in forked subprocess").  The card is found
through NVML (`torch.cuda.device_count()` asks NVML while CUDA is not
initialized), and the context is created by the first dispatch, in the
process that dispatches.
"""

from __future__ import annotations

import torch


def cuda_present() -> bool:
    """True when a CUDA card is visible, found without a CUDA context
    (NVML) while CUDA is not yet initialized in this process."""
    return torch.cuda.device_count() > 0


def resolve(device=None) -> torch.device:
    """torch.device for `device` (None means "cuda"); raises when a CUDA
    device is asked for and none is available.  An unindexed "cuda" is
    the current device once CUDA is initialized, else card 0 (the current
    device of a process that has not chosen one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not cuda_present():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_initialized() else 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
