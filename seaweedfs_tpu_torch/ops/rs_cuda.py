"""The port's Reed-Solomon and CRC kernels, each beside its plain version.

  gf_apply         K1, csrc/gf_apply.cu: out (p, L) = M (p, d) x X (d, L)
                   over GF(2^8).  Replaces the TPU kernel
                   seaweedfs_tpu/ops/rs_pallas.py:_gf_apply_kernel.
  fused_apply_crc  K2, csrc/fused_apply_crc.cu: (B, d, L) -> output rows
                   (B, p, L) plus the raw CRC32C image of every input and
                   output row, in one pass.  Replaces
                   seaweedfs_tpu/ops/rs_pallas.py:_fused_words_kernel.
  crc32c_rows      K8, csrc/crc32c_rows.cu: (B, R, L) -> the raw CRC32C
                   image of every row, K2's CRC half alone (the deep
                   scrub's shard and recomputed parity rows).

All are device-memory-bound in principle and, as designed, bound by the
SM's shared-memory and integer pipes on an H100; the sources say what
each design does about that and PERF.md what was measured.  A wrapper
takes the plain PyTorch version only for a tensor that lies on the CPU;
for a CUDA tensor it launches its kernel or raises.  `launches` counts
kernel launches per wrapper, so a run can show which path it went
through; `count_launch` keeps the counts exact when several threads
launch at once (concurrent degraded reads).

The GF(2^8) matrix is always a host (p, d) uint8 numpy array, as in the
JAX functions.  Raw CRC values come back as int64 tensors holding the
uint32 images (torch.uint32 supports too few operations).

Both kernels take strided views: bytes within a row are contiguous, and
rows (and K2's batch items) may lie any number of bytes apart, so a
permuted or sliced view reaches the kernel as strides, never as a hidden
copy.  `out=` (and K2's `crc=` / `partial=` scratch) let a caller that
holds preallocated slots launch without allocating device memory.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import crc32c as crc_host
from . import gf256
from .crc_device import batched_crc32c_raw

MAX_ROWS = 16        # output rows per launch (csrc/gf_core.cuh kMaxRows)
MAX_SMEM = 232448    # dynamic shared memory a Hopper block may take
K2_THREADS = 256     # threads of a K2 tile block
K2_MAX_TILE = 4096   # bytes of a K2 column tile
K2_STREAMS = 4       # interleaved CRC streams per sub-segment (kStreams)
K2_MAPS = 8          # nibble maps K2 reserves shared memory for (kMapsWords)
K8_THREADS = 256     # threads of a K8 block
K8_MAX_TILE = 4096   # bytes of a K8 row tile

launches = {"gf_apply": 0, "fused_apply_crc": 0, "crc32c_rows": 0}
_launches_lock = threading.Lock()


def count_launch(name: str):
    """Add one launch of kernel `name`; called where a wrapper launches
    its kernel and nowhere else."""
    with _launches_lock:
        launches[name] += 1


def reset_launches():
    with _launches_lock:
        for k in launches:
            launches[k] = 0


# -- host tables --------------------------------------------------------------


def _matrix_key(matrix: np.ndarray) -> tuple[bytes, int, int]:
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return m.tobytes(), m.shape[0], m.shape[1]


def gf_tables(matrix: np.ndarray) -> np.ndarray:
    """The kernels' row-packed nibble tables of a (p, d) matrix, (d, G,
    2, 16) uint32 with G = ceil(p / 4): word n of table (j, g, h) holds
    gf_mul(M[4g + q, j], n << 4h) in byte q (csrc/gf_core.cuh)."""
    m = np.asarray(matrix, dtype=np.uint8)
    p, d = m.shape
    groups = -(-p // 4)
    padded = np.zeros((4 * groups, d), dtype=np.uint8)
    padded[:p] = m
    nib = np.arange(16)
    mt = gf256.mul_table()
    prod = np.stack([mt[padded[:, :, None], nib],
                     mt[padded[:, :, None], nib << 4]], axis=2)
    prod = prod.reshape(groups, 4, d, 2, 16).astype(np.uint32)
    shift = (8 * np.arange(4, dtype=np.uint32))[None, :, None, None, None]
    packed = np.bitwise_or.reduce(prod << shift, axis=1)  # (G, d, 2, 16)
    return np.ascontiguousarray(packed.transpose(1, 0, 2, 3))


def nibble_map(cols: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map of 32-bit words, given as its 32 columns, in
    the kernels' nibble form (8, 16) uint32: map[k, n] = f(n << 4k)."""
    cols = np.asarray(cols, dtype=np.uint32)
    n = np.arange(16)
    bits = ((n[:, None] >> np.arange(4)) & 1).astype(bool)  # (16, 4)
    out = np.zeros((8, 16), dtype=np.uint32)
    for k in range(8):
        for b in range(4):
            out[k, bits[:, b]] ^= cols[4 * k + b]
    return out


def _adv_columns(n: int) -> np.ndarray:
    """Adv_n as 32 uint32 columns: column i packs Adv_n[:, i]."""
    adv = crc_host.advance_matrix(n).astype(np.uint64)
    return (adv << np.arange(32, dtype=np.uint64)[:, None]).sum(axis=0) \
        .astype(np.uint32)


def crc_maps(tile: int, sub: int) -> np.ndarray:
    """K2's nibble maps, (3 + log2 S, 8, 16) uint32: the CRC step over one
    4-byte word, Adv_4; Adv_{T/4S} and Adv_{T/2S}, which join the four
    interleaved streams of a sub-segment; then the sub-segment fold
    operators Adv_{T/S 2^k}, k = 0 .. log2(S) - 1."""
    seg = tile // sub
    lengths = [4, seg // K2_STREAMS, seg // 2] + \
        [seg << k for k in range(sub.bit_length() - 1)]
    return np.stack([nibble_map(_adv_columns(n)) for n in lengths])


def _device_words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _gf_tables_on(matrix_bytes: bytes, p: int, d: int,
                  device: torch.device) -> torch.Tensor:
    m = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(p, d)
    return _device_words(gf_tables(m), device)


@functools.lru_cache(maxsize=64)
def _crc_tables(tile: int, sub: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's CRC constants on device, as int32 words: crc_maps(T, S), and
    the tile fold operators Adv_{32 T}, Adv_{T 2^k} (k = 0..4) as nibble
    maps."""
    fold = [32 * tile] + [tile << k for k in range(5)]
    return (_device_words(crc_maps(tile, sub), device),
            _device_words(np.stack([nibble_map(_adv_columns(n))
                                    for n in fold]), device))


def _smem_bytes(p: int, d: int, tile: int, sub: int) -> int:
    """Shared memory of one K2 block (csrc smem_bytes): tables, maps, two
    input stages and the output rows, each row T bytes plus a 16-byte skew
    per sub-segment."""
    words = d * -(-p // 4) * 32 + K2_MAPS * 128
    return words * 4 + (2 * d + p) * (tile + 16 * sub)


def k2_geometry(p: int, d: int, length: int) -> tuple[int, int]:
    """(T, S) for K2: S sub-segments per row (a power of two up to 32, a
    warp's lanes) so that (d + p) * S CRC threads fit the block, T the
    column tile (at least 16 bytes per CRC stream), shrunk for short rows
    and until the block's shared memory fits."""
    rows = d + p
    if rows > K2_THREADS:
        raise ValueError(f"fused_apply_crc takes at most {K2_THREADS} rows")
    sub = 1
    while rows * sub * 2 <= K2_THREADS and sub < 32:
        sub *= 2
    tile = K2_MAX_TILE
    while tile > 16 * K2_STREAMS * sub and (tile // 2 >= length or
                               _smem_bytes(p, d, tile, sub) > MAX_SMEM):
        tile //= 2
    if _smem_bytes(p, d, tile, sub) > MAX_SMEM:
        raise ValueError(f"fused_apply_crc: ({p}, {d}) matrix too large")
    return tile, sub


# -- launch plumbing -----------------------------------------------------------


def k8_geometry(length: int) -> tuple[int, int]:
    """(T, S) for K8: the row tile T (a power of two, 4 KiB, halved while
    half a tile still covers the row, down to 64 bytes) and S sub-segments
    per tile row, 32 (a warp per row) or fewer in tiles under 2 KiB, so
    each CRC stream keeps whole 16-byte chunks."""
    tile = K8_MAX_TILE
    while tile > 16 * K2_STREAMS and tile // 2 >= length:
        tile //= 2
    return tile, min(32, tile // (16 * K2_STREAMS))


def _k8_smem_bytes(tile: int, sub: int) -> int:
    """Shared memory of one K8 block (csrc smem_bytes): room for 8 nibble
    maps, then two stages of K8_THREADS / S rows, each T bytes plus a
    16-byte skew per sub-segment."""
    return K2_MAPS * 128 * 4 + 2 * (K8_THREADS // sub) * (tile + 16 * sub)


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


@functools.lru_cache(maxsize=1)
def _k1():
    from ._build import load

    fn = load("gf_apply").sw_gf_apply
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=1)
def _k2():
    from ._build import load

    fn = load("fused_apply_crc").sw_fused_apply_crc
    fn.restype = ctypes.c_int
    ll = ctypes.c_longlong
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ll, ll]
                   + [ctypes.c_int, ll, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p, ll, ll] + [ctypes.c_void_p] * 3)
    return fn


@functools.lru_cache(maxsize=1)
def _k8():
    from ._build import load

    fn = load("crc32c_rows").sw_crc32c_rows
    fn.restype = ctypes.c_int
    ll = ctypes.c_longlong
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ll, ll, ctypes.c_int,
                                            ctypes.c_int, ll, ctypes.c_int,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
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
    if data.stride(-1) != 1 and data.shape[-1] > 1:
        raise ValueError(f"{name}: bytes within a row must be contiguous "
                         f"(strides {data.stride()})")


def _check_out(out: torch.Tensor, shape: tuple, dtype, data: torch.Tensor,
               name: str, contiguous: bool = False):
    if out.dtype != dtype or tuple(out.shape) != shape or \
            out.device != data.device:
        raise ValueError(f"{name}: out must be {dtype} {shape} on "
                         f"{data.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if contiguous and not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous")
    if out.stride(-1) != 1 and out.shape[-1] > 1:
        raise ValueError(f"{name}: bytes within an output row must be "
                         "contiguous")


# -- K1 -------------------------------------------------------------------------


def gf_apply_plain(matrix: np.ndarray, data: torch.Tensor,
                   out: torch.Tensor = None) -> torch.Tensor:
    """K1's plain version: a gather on the multiplication table.
    data (..., d, L) uint8 -> (..., p, L) uint8, written into `out` when
    given."""
    m = torch.from_numpy(np.array(matrix, dtype=np.uint8)).long()
    rows = torch.from_numpy(gf256.mul_table().copy()).to(data.device)[m]
    res = torch.zeros(m.shape[0], *data.shape[:-2], data.shape[-1],
                      dtype=torch.uint8, device=data.device)
    for j in range(m.shape[1]):
        res ^= rows[:, j][:, data[..., j, :].long()]
    res = res.movedim(0, -2)
    if out is None:
        return res
    out.copy_(res)
    return out


def gf_apply(matrix: np.ndarray, data: torch.Tensor,
             out: torch.Tensor = None) -> torch.Tensor:
    """out[i] = XOR_j gf_mul(matrix[i, j], data[j]): (p, d) host matrix,
    (d, L) uint8 tensor (rows any stride apart) -> (p, L) uint8 on the
    same device, any L >= 1.  `out`, when given, is a contiguous (p, L)
    uint8 tensor on data's device that receives the result (no device
    allocation)."""
    p, d = matrix.shape
    _check_bytes(data, 2, d, "gf_apply")
    length = data.shape[1]
    if out is not None:
        _check_out(out, (p, length), torch.uint8, data, "gf_apply",
                   contiguous=True)
    if data.device.type == "cpu":
        return gf_apply_plain(matrix, data, out)
    if out is None:
        out = torch.empty((p, length), dtype=torch.uint8, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    # row groups of at most MAX_ROWS, one launch's register accumulators
    for r0 in range(0, p, MAX_ROWS):
        sub = np.ascontiguousarray(matrix[r0:r0 + MAX_ROWS], dtype=np.uint8)
        tab = _gf_tables_on(*_matrix_key(sub), data.device)
        _check(_k1()(tab.data_ptr(), sub.shape[0], d, data.data_ptr(),
                     data.stride(0), length, out[r0:].data_ptr(),
                     out.stride(0), stream), "gf_apply")
        count_launch("gf_apply")
    return out


# -- K2 -------------------------------------------------------------------------


def fused_apply_crc_plain(matrix: np.ndarray, data: torch.Tensor,
                          out: torch.Tensor = None, crc: torch.Tensor = None):
    """K2's plain version: K1's plain version plus the plain batched CRC
    (written into `out` and `crc` when given)."""
    res = gf_apply_plain(matrix, data, out)
    raw = batched_crc32c_raw(torch.cat([data, res], dim=1))
    if crc is None:
        return res, raw
    crc.copy_(raw)
    return res, crc


def k2_scratch_shape(p: int, d: int, batch: int,
                     length: int) -> tuple[int, int, int]:
    """Shape of K2's int32 `partial` scratch for a (batch, d, L) input."""
    tile, _ = k2_geometry(p, d, length)
    return batch, d + p, -(-length // tile)


def fused_apply_crc(matrix: np.ndarray, data: torch.Tensor,
                    out: torch.Tensor = None, crc: torch.Tensor = None,
                    partial: torch.Tensor = None):
    """(p, d) host matrix, (B, d, L) uint8 tensor -> (out (B, p, L) uint8,
    crc_raw (B, d + p) int64) with crc_raw[b, s] = raw_update(0, row s)
    over the data rows then the output rows.  Any L >= 1.

    `data` and `out` may be any views whose rows are contiguous: batch
    and row strides reach the kernel as they are (the (B, k, L) permute
    of a (k, B, L) buffer costs nothing).  `out`, `crc` (contiguous) and
    `partial` (contiguous int32 of k2_scratch_shape) are optional
    preallocated outputs and scratch; with all three the launch allocates
    no device memory."""
    p, d = matrix.shape
    _check_bytes(data, 3, d, "fused_apply_crc")
    b, _, length = data.shape
    if out is not None:
        _check_out(out, (b, p, length), torch.uint8, data, "fused_apply_crc")
    if crc is not None:
        _check_out(crc, (b, d + p), torch.int64, data, "fused_apply_crc",
                   contiguous=True)
    if data.device.type == "cpu":
        return fused_apply_crc_plain(matrix, data, out, crc)
    if p > MAX_ROWS:
        raise ValueError(f"fused_apply_crc takes at most {MAX_ROWS} rows")
    tile, sub = k2_geometry(p, d, length)
    ntiles = -(-length // tile)
    dev = data.device
    tab = _gf_tables_on(*_matrix_key(matrix), dev)
    maps, adv_fold = _crc_tables(tile, sub, dev)
    if out is None:
        out = torch.empty((b, p, length), dtype=torch.uint8, device=dev)
    if partial is None:
        partial = torch.empty((b, d + p, ntiles), dtype=torch.int32,
                              device=dev)
    elif (partial.dtype != torch.int32 or not partial.is_contiguous()
          or tuple(partial.shape) != (b, d + p, ntiles)
          or partial.device != dev):
        raise ValueError("fused_apply_crc: partial must be a contiguous "
                         f"int32 {(b, d + p, ntiles)} tensor on {dev}")
    if crc is None:
        crc = torch.empty((b, d + p), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(_k2()(tab.data_ptr(), p, d, maps.data_ptr(), adv_fold.data_ptr(),
                 data.data_ptr(), data.stride(0), data.stride(1), b, length,
                 tile, sub, out.data_ptr(), out.stride(0), out.stride(1),
                 partial.data_ptr(), crc.data_ptr(), stream),
           "fused_apply_crc")
    count_launch("fused_apply_crc")
    return out, crc


def fused_encode_words(matrix: np.ndarray, words: torch.Tensor):
    """Words view over K2, as the JAX function's contract: words (B, d,
    L/4) int32 little-endian packed bytes -> (parity words (B, p, L/4)
    int32, crc_raw (B, d + p) int64).  Both views are free."""
    b, d, w = words.shape
    data = words.view(torch.uint8).view(b, d, 4 * w)
    out, crc = fused_apply_crc(matrix, data)
    return out.view(torch.int32), crc


# -- K8 -------------------------------------------------------------------------


def crc32c_rows_plain(data: torch.Tensor,
                      out: torch.Tensor = None) -> torch.Tensor:
    """K8's plain version, for a CPU tensor: the native host CRC of each
    row turned into its raw image, crc32c(row) ^ crc32c(0^L) (written into
    `out` when given)."""
    b, r, length = data.shape
    zeros = crc_host.crc32c_zeros(length)
    rows = data.numpy()
    raw = torch.tensor([[crc_host.crc32c(rows[i, j]) ^ zeros
                         for j in range(r)] for i in range(b)],
                       dtype=torch.int64).view(b, r)
    if out is None:
        return raw
    out.copy_(raw)
    return out


_K8_SCRATCH: "dict[tuple, torch.Tensor]" = {}
_K8_SCRATCH_MAX = 64
_k8_lock = threading.Lock()


def _k8_partial(dev: torch.device, stream: int, shape: tuple) -> torch.Tensor:
    """K8's int32 tile-partial scratch, kept per (device, stream, shape):
    launches on one stream run in order, so they may share it, and a
    steady caller allocates nothing."""
    key = (dev, stream, shape)
    with _k8_lock:
        buf = _K8_SCRATCH.pop(key, None)
        if buf is None:
            buf = torch.empty(shape, dtype=torch.int32, device=dev)
        _K8_SCRATCH[key] = buf  # newest last
        while len(_K8_SCRATCH) > _K8_SCRATCH_MAX:
            del _K8_SCRATCH[next(iter(_K8_SCRATCH))]
    return buf


def crc32c_rows(data: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """(B, R, L) uint8 tensor -> (B, R) int64 raw CRC32C images,
    crc[b, r] = raw_update(0, data[b, r]); crc32c of the row is that image
    ^ crc32c_zeros(L) (crc32c.finalize_raw).  Any L >= 1.

    `data` may be any view whose rows are contiguous: batch and row
    strides reach the kernel as they are (the (B, R, L) permute of an
    (R, B, L) slab costs nothing).  `out`, a contiguous (B, R) int64
    tensor on data's device, receives the images; with it a steady caller
    allocates no device memory (the tile partials live in a scratch kept
    per device, stream and shape).  Launches on the current stream."""
    _check_bytes(data, 3, data.shape[-2] if data.dim() == 3 else -1,
                 "crc32c_rows")
    b, r, length = data.shape
    if b < 1 or r < 1:
        raise ValueError(f"crc32c_rows: empty batch {tuple(data.shape)}")
    if out is not None:
        _check_out(out, (b, r), torch.int64, data, "crc32c_rows",
                   contiguous=True)
    if data.device.type == "cpu":
        return crc32c_rows_plain(data, out)
    if b > 65535:
        raise ValueError("crc32c_rows takes at most 65535 batch items")
    tile, sub = k8_geometry(length)
    dev = data.device
    maps, adv_fold = _crc_tables(tile, sub, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = _k8_partial(dev, stream, (b, r, -(-length // tile)))
    if out is None:
        out = torch.empty((b, r), dtype=torch.int64, device=dev)
    _check(_k8()(maps.data_ptr(), adv_fold.data_ptr(), data.data_ptr(),
                 data.stride(0), data.stride(1), b, r, length, tile, sub,
                 partial.data_ptr(), out.data_ptr(), stream), "crc32c_rows")
    count_launch("crc32c_rows")
    return out
