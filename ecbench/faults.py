"""Faults planted under the timed path, for the control and the tests.

`--fault NAME` (never passed in a measured run) replaces one program
entry with a broken copy before set-up, so that a run shows `correct`
false when the program breaks the guarantee that the entry keeps:

  flip_decode  the decode route returns a span with one byte altered
  flip_read    an EC needle read returns its data with one byte altered
  stale_k1     the decode's K1 returns its output slot unwritten
  half_k1      the decode's K1 computes half of its columns
  flip_k1      the decode's K1 output has one byte altered
  stale_k5     the scrub's parity step leaves its output slot unwritten
  half_k5      the parity step computes half of its columns
  flip_k5      the parity step's output has one byte altered
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _flip_array(out):
    out = np.array(out, copy=True)
    out.reshape(-1)[out.size // 2] ^= 0x5A
    return out


def _k1_fault(real, kind: str):
    @functools.wraps(real)
    def broken(matrix, data, out=None):
        p, length = matrix.shape[0], data.shape[-1]
        if out is None:
            out = torch.zeros((p, length), dtype=torch.uint8,
                              device=data.device)
        if kind == "stale":
            return out
        if kind == "half":
            half = max(1, length // 2)
            out[:, :half] = real(matrix, data[:, :half])
            return out
        res = real(matrix, data, out=out)
        res[0, length // 2] ^= 0x5A
        return res
    return broken


def install(name: str) -> None:
    from seaweedfs_tpu_torch.ops import codec, rs_torch
    from seaweedfs_tpu_torch.parallel import mesh
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume

    if name == "flip_decode":
        real = codec.reconstruct_span

        @functools.wraps(real)
        def flipped(*args, **kwargs):
            return _flip_array(real(*args, **kwargs))
        codec.reconstruct_span = flipped
    elif name == "flip_read":
        real = EcVolume.read_needle

        @functools.wraps(real)
        def read(self, *args, **kwargs):
            n = real(self, *args, **kwargs)
            if n.data:
                data = bytearray(n.data)
                data[len(data) // 2] ^= 0x5A
                n.data = bytes(data)
            return n
        EcVolume.read_needle = read
    elif name in ("stale_k1", "half_k1", "flip_k1"):
        rs_torch.gf_apply = _k1_fault(rs_torch.gf_apply, name.split("_")[0])
    elif name in ("stale_k5", "half_k5", "flip_k5"):
        mesh.gf_apply = _k1_fault(mesh.gf_apply, name.split("_")[0])
    else:
        raise ValueError(f"unknown fault {name!r}")
