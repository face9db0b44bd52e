"""Backend-selectable Reed-Solomon codec: the `reedsolomon.Encoder` seam.

`new_encoder(...)` is the port's `reedsolomon.New(10, 4)`:

  * "cuda"  (default) TorchEncoder on the card, kernel K1
  * "torch" TorchEncoder on the CPU, K1's plain version
  * "numpy" the pure NumPy reference

`reconstruct_span` rebuilds one shard's span with one cached decode row,
the degraded read's decode.  It routes by size: a survivor stack of at
least WEED_EC_RECOVER_DEVICE_MIN_KB goes to K1 on the device, a smaller
one to the host codec (native library, else NumPy), since below that a
trip over the link costs more than the mat-vec.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import device as device_mod
from . import native
from .rs_numpy import (NumpyEncoder, ReconstructError,  # noqa: F401
                       RSCodecBase, decode_rows, gf_apply_matrix)
from .rs_torch import TorchEncoder, apply_matrix

_RECOVER_DEVICE_MIN_KB = 512


def recover_device_min_bytes() -> int:
    """WEED_EC_RECOVER_DEVICE_MIN_KB (default 512), read per call so
    daemons and tests can flip it live."""
    kb = os.environ.get("WEED_EC_RECOVER_DEVICE_MIN_KB", "")
    try:
        return (int(kb) if kb else _RECOVER_DEVICE_MIN_KB) << 10
    except ValueError:
        return _RECOVER_DEVICE_MIN_KB << 10


def recover_device_enabled(dev: torch.device) -> bool:
    """Whether reconstruct_span may decode on `dev` (a resolved device).
    WEED_EC_RECOVER_DEVICE: unset/"auto" -> only when `dev` is a CUDA
    card; "1" forces it on (on the CPU that is K1's plain version, as the
    tests use it); "0" disables."""
    v = os.environ.get("WEED_EC_RECOVER_DEVICE", "auto").lower()
    if v in ("1", "true", "yes", "force"):
        return True
    if v in ("0", "false", "no"):
        return False
    return dev.type == "cuda"


def _apply_rows_host(rows: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """(t, d) decode rows x (d, L) survivor spans on the host: the native
    library's GF apply when it is built, else NumPy tables."""
    lib = native.lib()
    if lib is None:
        return gf_apply_matrix(rows, inputs)
    t, d = rows.shape
    length = inputs.shape[1]
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    inputs = np.ascontiguousarray(inputs, dtype=np.uint8)
    out = np.zeros((t, length), dtype=np.uint8)
    lib.sw_gf_apply_matrix(
        rows.ctypes.data_as(ctypes.c_char_p), t, d,
        inputs.ctypes.data_as(ctypes.c_char_p), length,
        out.ctypes.data_as(ctypes.c_char_p))
    return out


def reconstruct_span(survivors, inputs: np.ndarray, target: int,
                     data_shards: int = 10, total_shards: int = 14,
                     slab_key=None, family=None,
                     device=None) -> np.ndarray:
    """Rebuild ONE shard's span from the (d, L) survivor stack through the
    cached decode plan: one GF mat-vec, never a full Reconstruct.
    `inputs[i]` is the span read from `survivors[i]`; L may be many spans
    laid end to end, since the math is column-wise.

    The route is chosen by size and knob only (module docstring,
    `recover_device_enabled`); a failing launch raises.  `device` is
    resolved first in any case, so without a card and without
    device="cpu" this raises even for a span the host would serve.

    slab_key: the content identity of `inputs`, which the reference uses
    to keep survivor stacks resident in a device pool.  The port has no
    device pool yet; the key is accepted and unused, and the output never
    depends on it.

    family: an erasure_coding.codes CodeFamily; None is RS(data, total)
    on the shared decode-plan cache.  A family supplies its own cached
    decode plan and lane view of the stack."""
    del slab_key
    dev = device_mod.resolve(device)
    if family is None:
        rows = decode_rows(data_shards, total_shards, survivors, (target,))
        stack = inputs
    else:
        rows = family.decode_rows(tuple(survivors), (target,))
        stack = family.to_lanes(np.ascontiguousarray(inputs))
    if inputs.nbytes >= recover_device_min_bytes() \
            and recover_device_enabled(dev):
        data = torch.from_numpy(np.ascontiguousarray(stack, dtype=np.uint8))
        out = apply_matrix(rows, data.to(dev)).cpu().numpy()
    else:
        out = _apply_rows_host(rows, stack)
    return out[0] if family is None else family.from_lanes(out)[0]


def new_encoder(data_shards: int = 10, parity_shards: int = 4,
                backend: str = "cuda"):
    if backend == "cuda":
        return TorchEncoder(data_shards, parity_shards, device="cuda")
    if backend == "torch":
        return TorchEncoder(data_shards, parity_shards, device="cpu")
    if backend == "numpy":
        return NumpyEncoder(data_shards, parity_shards)
    raise ValueError(f"unknown backend {backend!r}")
