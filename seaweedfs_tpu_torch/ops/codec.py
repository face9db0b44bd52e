"""Backend-selectable Reed-Solomon codec: the `reedsolomon.Encoder` seam.

`new_encoder(...)` is the port's `reedsolomon.New(10, 4)`:

  * "cuda"  (default) TorchEncoder on the card, kernel K1
  * "torch" TorchEncoder on the CPU, K1's plain version
  * "numpy" the pure NumPy reference

`reconstruct_span` rebuilds one shard's span with one cached decode row,
always on the device it is given (K1 on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from .rs_numpy import (NumpyEncoder, ReconstructError,  # noqa: F401
                       RSCodecBase, decode_rows, gf_apply_matrix)
from .rs_torch import TorchEncoder, apply_matrix


def reconstruct_span(survivors, inputs: np.ndarray, target: int,
                     data_shards: int = 10, total_shards: int = 14,
                     device=None) -> np.ndarray:
    """Rebuild ONE shard's span from the (d, L) survivor stack through the
    cached decode plan: one GF mat-vec, never a full Reconstruct.
    `inputs[i]` is the span read from `survivors[i]`; L may be many spans
    laid end to end, since the math is column-wise."""
    rows = decode_rows(data_shards, total_shards, survivors, (target,))
    dev = device_mod.resolve(device)
    data = torch.from_numpy(np.ascontiguousarray(inputs, dtype=np.uint8))
    return apply_matrix(rows, data.to(dev))[0].cpu().numpy()


def new_encoder(data_shards: int = 10, parity_shards: int = 4,
                backend: str = "cuda"):
    if backend == "cuda":
        return TorchEncoder(data_shards, parity_shards, device="cuda")
    if backend == "torch":
        return TorchEncoder(data_shards, parity_shards, device="cpu")
    if backend == "numpy":
        return NumpyEncoder(data_shards, parity_shards)
    raise ValueError(f"unknown backend {backend!r}")
