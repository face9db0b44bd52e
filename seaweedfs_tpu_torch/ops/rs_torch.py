"""PyTorch Reed-Solomon codec: GF(2^8) matrix application on tensors.

Counterpart of seaweedfs_tpu/ops/rs_jax.py.  Encode, decode and rebuild
are all `apply_matrix` with different small host-built matrices.  Its
`method` names the reference's formulations (the portable step forms,
"K7"):

  "pallas"  the hand kernel: K1 (rs_cuda.gf_apply) on a CUDA tensor, K1's
            plain version on a CPU tensor; the port's default
  "swar"    bytes packed 4 per int32 word, mul-by-constant decomposed over
            the input bits (apply_matrix_swar)
  "mxu"     the (8p, 8d) GF(2) bit matrix times the bit-sliced data, mod 2
            (apply_matrix_mxu)

On a CUDA tensor every method launches K1; on a CPU tensor each keeps a
plain version of its own formulation.  All three are bit-exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as device_mod
from . import gf256
from .rs_cuda import _matrix_key, gf_apply  # noqa: F401
from .rs_numpy import RSCodecBase

_SPREAD = 0x01010101  # one set bit per packed byte
METHODS = ("pallas", "swar", "mxu")


@functools.lru_cache(maxsize=64)
def _bit_matrix_cached(matrix_bytes: bytes, p: int, d: int) -> np.ndarray:
    """The (8p, 8d) GF(2) bit matrix of a coefficient matrix, int8."""
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(p, d)
    return gf256.coeff_bit_matrix(matrix).astype(np.int8)


@functools.lru_cache(maxsize=64)
def _bit_constants_cached(matrix_bytes: bytes, p: int, d: int) -> np.ndarray:
    """K[i, j, b] = gf_mul(matrix[i, j], 1 << b), shape (p, d, 8) int32."""
    matrix = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(p, d)
    powers = (1 << np.arange(8)).astype(np.uint8)
    return gf256.mul_table()[matrix[:, :, None],
                             powers[None, None, :]].astype(np.int32)


def swar_words(consts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """consts (p, d, 8) int32, words (..., d, W) int32 packed bytes ->
    (..., p, W) int32: each byte of a word is multiplied on its own
    (a 0/1 bit per byte times a constant < 256 never carries across
    bytes; int32 products wrap, which leaves the bits as they are)."""
    p, d = consts.shape[0], consts.shape[1]
    acc = words.new_zeros(words.shape[:-2] + (p, words.shape[-1]))
    for j in range(d):
        x = words[..., j, :].unsqueeze(-2)
        for b in range(8):
            # an arithmetic shift fills only bits above 31 - b; the mask
            # keeps bits 0, 8, 16, 24, which all come from x itself
            t = (x >> b) & _SPREAD
            acc ^= t * consts[:, j, b].view(p, 1)
    return acc


def apply_matrix_swar(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out[i] = XOR_j gf_mul(matrix[i, j], data[j]); data (d, L) uint8.
    K1 on a CUDA tensor; SWAR over packed int32 words on the CPU."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if data.device.type == "cuda":
        return gf_apply(m, data)
    d, length = data.shape
    pad = (-length) % 4
    x = data.contiguous()
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    consts = torch.from_numpy(_bit_constants_cached(*_matrix_key(m)))
    out = swar_words(consts, x.view(torch.int32))
    return out.view(torch.uint8)[:, :length].contiguous()


def bits_matmul(bit_matrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(8p, 8d) 0/1 matrix times the bit-sliced (..., d, L) uint8 data, mod
    2 -> (..., p, L) uint8.  The products are float32 sums of at most 8d
    ones, exact below 2^24."""
    *lead, d, length = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data.unsqueeze(-2) >> shifts.view(8, 1)) & 1).reshape(
        *lead, d * 8, length).to(torch.float32)
    prod = torch.matmul(bit_matrix.to(torch.float32), bits)
    out_bits = (prod.to(torch.int32) & 1).to(torch.uint8).reshape(
        *lead, -1, 8, length)
    weights = (1 << shifts.to(torch.int32)).view(8, 1)
    return (out_bits.to(torch.int32) * weights).sum(-2).to(torch.uint8)


def apply_matrix_mxu(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """As apply_matrix_swar: K1 on a CUDA tensor; the GF(2) bit-matmul on
    the CPU."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if data.device.type == "cuda":
        return gf_apply(m, data)
    bm = torch.from_numpy(_bit_matrix_cached(*_matrix_key(m)))
    return bits_matmul(bm, data)


def apply_matrix(matrix: np.ndarray, data: torch.Tensor,
                 out: torch.Tensor = None,
                 method: str = "pallas") -> torch.Tensor:
    """out[i] = XOR_j gf_mul(matrix[i, j], data[j]): (p, d) host matrix,
    (d, L) uint8 tensor -> (p, L) uint8 tensor on the same device
    (written into `out` when given), by `method` (see the module)."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if method == "pallas" or data.device.type == "cuda":
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        return gf_apply(m, data, out)
    if method == "swar":
        res = apply_matrix_swar(m, data)
    elif method == "mxu":
        res = apply_matrix_mxu(m, data)
    else:
        raise ValueError(f"unknown method {method!r}")
    if out is None:
        return res
    out.copy_(res)
    return out


class TorchEncoder(RSCodecBase):
    """reedsolomon.Encoder-compatible codec whose GF math runs on a torch
    device: K1 on "cuda" (the default), on "cpu" the plain version of
    `method`'s formulation.  Shard lists are host buffers; each call
    moves its inputs to the device and the result back."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 device=None, method: str = "pallas"):
        super().__init__(data_shards, parity_shards)
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.device = device_mod.resolve(device)
        self.method = method

    def _apply(self, matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
        data = torch.from_numpy(np.ascontiguousarray(inputs, dtype=np.uint8))
        return apply_matrix(matrix, data.to(self.device),
                            method=self.method).cpu().numpy()
