"""The port's two Reed-Solomon kernels, each beside its plain version.

  gf_apply         K1, csrc/gf_apply.cu: out (p, L) = M (p, d) x X (d, L)
                   over GF(2^8).  Replaces the TPU kernel
                   seaweedfs_tpu/ops/rs_pallas.py:_gf_apply_kernel.
  fused_apply_crc  K2, csrc/fused_apply_crc.cu: (B, d, L) -> output rows
                   (B, p, L) plus the raw CRC32C image of every input and
                   output row, in one pass.  Replaces
                   seaweedfs_tpu/ops/rs_pallas.py:_fused_words_kernel.

Both are bound by device-memory bytes on an H100; the sources say what
each design does about that.  A wrapper takes the plain PyTorch version
only for a tensor that lies on the CPU; for a CUDA tensor it launches its
kernel or raises.  `launches` counts kernel launches per wrapper, so a run
can show which path it went through.

The GF(2^8) matrix is always a host (p, d) uint8 numpy array, as in the
JAX functions.  Raw CRC values come back as int64 tensors holding the
uint32 images (torch.uint32 supports too few operations).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import crc32c as crc_host
from . import gf256
from .crc_device import batched_crc32c_raw

MAX_ROWS = 16        # output rows per launch (csrc/gf_core.cuh kMaxRows)
MAX_SMEM = 232448    # dynamic shared memory a Hopper block may take
K2_THREADS = 256     # threads of a K2 tile block
K2_MAX_TILE = 4096   # bytes of a K2 column tile

launches = {"gf_apply": 0, "fused_apply_crc": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# -- host tables --------------------------------------------------------------


def _matrix_key(matrix: np.ndarray) -> tuple[bytes, int, int]:
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return m.tobytes(), m.shape[0], m.shape[1]


@functools.lru_cache(maxsize=64)
def _product_table(matrix_bytes: bytes, p: int, d: int,
                   device: torch.device) -> torch.Tensor:
    """(p, d, 256) uint8: gf_mul(M[i, j], x) for every byte x, on device."""
    m = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(p, d)
    return torch.from_numpy(np.ascontiguousarray(gf256.mul_table()[m])) \
        .to(device)


def _adv_columns(n: int) -> np.ndarray:
    """Adv_n as 32 uint32 columns: column i packs Adv_n[:, i]."""
    adv = crc_host.advance_matrix(n).astype(np.uint64)
    return (adv << np.arange(32, dtype=np.uint64)[:, None]).sum(axis=0) \
        .astype(np.uint32)


@functools.lru_cache(maxsize=64)
def _crc_tables(tile: int, sub: int, ntiles: int,
                device: torch.device) -> tuple[torch.Tensor, ...]:
    """K2's CRC constants on device, as int32 words: the (4, 256) slicing
    tables, Adv_{T/S}, and the fold operators Adv_T, Adv_{m T 2^k}
    (k = 0..4, m = ceil(ntiles / 32))."""
    m = -(-ntiles // 32)
    fold = [_adv_columns(tile)] + [_adv_columns(m * tile << k)
                                   for k in range(5)]

    def dev(a):
        return torch.from_numpy(
            np.array(a, dtype=np.uint32).view(np.int32)).to(device)
    return (dev(crc_host.tables()[:4]), dev(_adv_columns(tile // sub)),
            dev(np.concatenate(fold)))


def _smem_bytes(p: int, d: int, tile: int, sub: int) -> int:
    """Shared memory of one K2 tile block (csrc smem_bytes)."""
    rows = d + p
    return (rows * (tile // 4 + sub) + 1024 + 32 + rows * sub) * 4 \
        + p * d * 256


def k2_geometry(p: int, d: int, length: int) -> tuple[int, int]:
    """(T, S) for K2: S sub-segments per row so that (d + p) * S CRC
    threads fit the block, T the column tile, shrunk for short rows and
    until the block's shared memory fits."""
    rows = d + p
    if rows > K2_THREADS:
        raise ValueError(f"fused_apply_crc takes at most {K2_THREADS} rows")
    sub = 1
    while rows * sub * 2 <= K2_THREADS and sub < 64:
        sub *= 2
    tile = K2_MAX_TILE
    while tile > 16 * sub and (tile // 2 >= length or
                               _smem_bytes(p, d, tile, sub) > MAX_SMEM):
        tile //= 2
    if _smem_bytes(p, d, tile, sub) > MAX_SMEM:
        raise ValueError(f"fused_apply_crc: ({p}, {d}) matrix too large")
    return tile, sub


# -- launch plumbing -----------------------------------------------------------


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


@functools.lru_cache(maxsize=1)
def _k1():
    from ._build import load

    fn = load("gf_apply").sw_gf_apply
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=1)
def _k2():
    from ._build import load

    fn = load("fused_apply_crc").sw_fused_apply_crc
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int] + [ctypes.c_void_p] * 4)
    return fn


def _check_bytes(data: torch.Tensor, ndim: int, d: int, name: str):
    if data.dtype != torch.uint8 or data.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d uint8 tensor, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if data.shape[-2] != d:
        raise ValueError(f"{name}: matrix has {d} columns, data has "
                         f"{data.shape[-2]} rows")
    if data.shape[-1] < 1:
        raise ValueError(f"{name}: empty rows")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {data.device}")


# -- K1 -------------------------------------------------------------------------


def gf_apply_plain(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """K1's plain version: a gather on the multiplication table.
    data (..., d, L) uint8 -> (..., p, L) uint8."""
    m = torch.from_numpy(np.array(matrix, dtype=np.uint8)).long()
    rows = torch.from_numpy(gf256.mul_table().copy()).to(data.device)[m]
    out = torch.zeros(m.shape[0], *data.shape[:-2], data.shape[-1],
                      dtype=torch.uint8, device=data.device)
    for j in range(m.shape[1]):
        out ^= rows[:, j][:, data[..., j, :].long()]
    return out.movedim(0, -2)


def gf_apply(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out[i] = XOR_j gf_mul(matrix[i, j], data[j]): (p, d) host matrix,
    (d, L) uint8 tensor -> (p, L) uint8 on the same device, any L >= 1."""
    p, d = matrix.shape
    _check_bytes(data, 2, d, "gf_apply")
    if data.device.type == "cpu":
        return gf_apply_plain(matrix, data)
    data = data.contiguous()
    length = data.shape[1]
    out = torch.empty((p, length), dtype=torch.uint8, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    # row groups that fit one launch's register accumulators and tables
    step = max(1, min(MAX_ROWS, MAX_SMEM // (d * 256)))
    for r0 in range(0, p, step):
        sub = np.ascontiguousarray(matrix[r0:r0 + step], dtype=np.uint8)
        tab = _product_table(*_matrix_key(sub), data.device)
        _check(_k1()(tab.data_ptr(), sub.shape[0], d, data.data_ptr(),
                     length, out[r0:].data_ptr(), stream), "gf_apply")
        launches["gf_apply"] += 1
    return out


# -- K2 -------------------------------------------------------------------------


def fused_apply_crc_plain(matrix: np.ndarray, data: torch.Tensor):
    """K2's plain version: K1's plain version plus the plain batched CRC."""
    out = gf_apply_plain(matrix, data)
    return out, batched_crc32c_raw(torch.cat([data, out], dim=1))


def fused_apply_crc(matrix: np.ndarray, data: torch.Tensor):
    """(p, d) host matrix, (B, d, L) uint8 tensor -> (out (B, p, L) uint8,
    crc_raw (B, d + p) int64) with crc_raw[b, s] = raw_update(0, row s)
    over the data rows then the output rows.  Any L >= 1."""
    p, d = matrix.shape
    _check_bytes(data, 3, d, "fused_apply_crc")
    if data.device.type == "cpu":
        return fused_apply_crc_plain(matrix, data)
    if p > MAX_ROWS:
        raise ValueError(f"fused_apply_crc takes at most {MAX_ROWS} rows")
    data = data.contiguous()
    b, _, length = data.shape
    tile, sub = k2_geometry(p, d, length)
    ntiles = -(-length // tile)
    dev = data.device
    tab = _product_table(*_matrix_key(matrix), dev)
    crc_t, adv_sub, adv_fold = _crc_tables(tile, sub, ntiles, dev)
    out = torch.empty((b, p, length), dtype=torch.uint8, device=dev)
    partial = torch.empty((b, d + p, ntiles), dtype=torch.int32, device=dev)
    crc = torch.empty((b, d + p), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_k2()(tab.data_ptr(), p, d, crc_t.data_ptr(), adv_sub.data_ptr(),
                 adv_fold.data_ptr(), data.data_ptr(), b, length, tile, sub,
                 out.data_ptr(), partial.data_ptr(), crc.data_ptr(), stream),
           "fused_apply_crc")
    launches["fused_apply_crc"] += 1
    return out, crc.to(torch.int64) & 0xFFFFFFFF


def fused_encode_words(matrix: np.ndarray, words: torch.Tensor):
    """Words view over K2, as the JAX function's contract: words (B, d,
    L/4) int32 little-endian packed bytes -> (parity words (B, p, L/4)
    int32, crc_raw (B, d + p) int64).  Both views are free."""
    b, d, w = words.shape
    data = words.contiguous().view(torch.uint8).reshape(b, d, 4 * w)
    out, crc = fused_apply_crc(matrix, data)
    return out.view(torch.int32), crc
