"""PyTorch Reed-Solomon codec: GF(2^8) matrix application on tensors.

Counterpart of seaweedfs_tpu/ops/rs_jax.py.  Encode, decode and rebuild
are all `apply_matrix` with different small host-built matrices; on a CUDA
tensor it launches kernel K1 (rs_cuda.gf_apply), on a CPU tensor it runs
K1's plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as device_mod
from . import gf256
from .rs_cuda import _matrix_key, gf_apply  # noqa: F401
from .rs_numpy import RSCodecBase


@functools.lru_cache(maxsize=64)
def _bit_matrix_cached(matrix_bytes: bytes, p: int, d: int) -> np.ndarray:
    """The (8p, 8d) GF(2) bit matrix of a coefficient matrix, int8."""
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(p, d)
    return gf256.coeff_bit_matrix(matrix).astype(np.int8)


def apply_matrix(matrix: np.ndarray, data: torch.Tensor,
                 out: torch.Tensor = None) -> torch.Tensor:
    """out[i] = XOR_j gf_mul(matrix[i, j], data[j]): (p, d) host matrix,
    (d, L) uint8 tensor -> (p, L) uint8 tensor on the same device
    (written into `out` when given)."""
    return gf_apply(np.ascontiguousarray(matrix, dtype=np.uint8), data, out)


class TorchEncoder(RSCodecBase):
    """reedsolomon.Encoder-compatible codec whose GF math runs on a torch
    device: K1 on "cuda" (the default), its plain version on "cpu".
    Shard lists are host buffers; each call moves its inputs to the device
    and the result back."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 device=None):
        super().__init__(data_shards, parity_shards)
        self.device = device_mod.resolve(device)

    def _apply(self, matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
        data = torch.from_numpy(np.ascontiguousarray(inputs, dtype=np.uint8))
        return apply_matrix(matrix, data.to(self.device)).cpu().numpy()

