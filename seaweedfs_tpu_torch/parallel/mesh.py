"""Batched EC steps on one device, over kernel K2.

Counterpart of the one-device part of seaweedfs_tpu/parallel/mesh.py:

  make_sharded_encoder  the encode step: (B, d, L) data -> parity and the
                        raw CRC32C images of all d + p rows (K2 with the
                        parity matrix);
  make_sharded_apply    the rebuild step: (B, d, L) survivors -> the t
                        missing rows and their raw CRC images (K2 with a
                        reconstruction matrix; K2 also CRCs the inputs,
                        the step keeps the last t);
  encode_batch          host convenience over the encode step.

A kernel that fails raises; there is no fallback step.  The multi-device
mesh, the pooled step and the device pool wait for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..ops import gf256
from ..ops.crc_device import finalize
from ..ops.rs_cuda import fused_apply_crc


def make_sharded_encoder(data_shards: int = 10, parity_shards: int = 4):
    """step(data (B, d, L) uint8 tensor) -> (parity (B, p, L) uint8,
    crc_raw (B, d + p) int64), on data's device."""
    matrix = np.ascontiguousarray(
        gf256.parity_matrix(data_shards, data_shards + parity_shards))

    def step(data: torch.Tensor):
        return fused_apply_crc(matrix, data)
    return step


def make_sharded_apply(matrix: np.ndarray):
    """step(data (B, d, L) uint8 tensor) -> (out (B, t, L) uint8, crc_raw
    (B, t) int64) for a (t, d) reconstruction matrix."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    d = m.shape[1]

    def step(data: torch.Tensor):
        out, crc = fused_apply_crc(m, data)
        return out, crc[:, d:]
    return step


def encode_batch(data: np.ndarray, device=None):
    """(B, 10, L) host batch -> (parity (B, 4, L) uint8, crcs (B, 14)
    uint32) with the CRCs finalized to standard CRC32C of each row."""
    dev = device_mod.resolve(device)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    parity, crc_raw = make_sharded_encoder()(torch.from_numpy(data).to(dev))
    return parity.cpu().numpy(), finalize(crc_raw, data.shape[-1])
