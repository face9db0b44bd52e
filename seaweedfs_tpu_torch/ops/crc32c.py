"""CRC32C (Castagnoli) on the host, and its GF(2) algebra.

The needle and shard-file checksum.  `crc32c` runs the native library
(ops/native.py) when it is built, else a pure-Python slicing-by-8 loop.
Needles store the raw CRC of their data; `value` is the legacy rotated
form (Go's CRC.Value()) that reads also accept.
The algebra below (raw images, advance matrices, combine) is what lets the
device kernels return raw per-chunk images that the host finalizes and
chains with O(1) work per chunk.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import native

_POLY = 0x82F63B78  # reflected Castagnoli


@functools.lru_cache(maxsize=1)
def tables() -> np.ndarray:
    """(8, 256) uint32 slicing tables: tables[s][i] is the state update of
    byte i followed by s zero bytes."""
    t = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        t[0, i] = crc
    for s in range(1, 8):
        for i in range(256):
            crc = int(t[s - 1, i])
            t[s, i] = t[0, crc & 0xFF] ^ (crc >> 8)
    t.setflags(write=False)
    return t


def _crc32c_py(crc: int, data: bytes) -> int:
    t = tables()
    crc = ~crc & 0xFFFFFFFF
    mv = memoryview(data)
    n8 = len(mv) - (len(mv) % 8)
    for k in range(0, n8, 8):
        word = int.from_bytes(mv[k:k + 8], "little") ^ crc
        crc = (int(t[7, word & 0xFF]) ^ int(t[6, (word >> 8) & 0xFF])
               ^ int(t[5, (word >> 16) & 0xFF])
               ^ int(t[4, (word >> 24) & 0xFF])
               ^ int(t[3, (word >> 32) & 0xFF])
               ^ int(t[2, (word >> 40) & 0xFF])
               ^ int(t[1, (word >> 48) & 0xFF])
               ^ int(t[0, (word >> 56) & 0xFF]))
    for b in mv[n8:]:
        crc = int(t[0, (crc ^ b) & 0xFF]) ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of `data` (bytes-like or ndarray), seeded with `crc`."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    else:
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    cdll = native.lib()
    if cdll is not None:
        return cdll.sw_crc32c(crc, data.ctypes.data_as(ctypes.c_char_p),
                              data.nbytes)
    return _crc32c_py(crc, data.tobytes())


def value(crc: int) -> int:
    """Legacy CRC.Value(): rotate right by 15, add a constant; needles
    written by old versions store this form."""
    crc &= 0xFFFFFFFF
    rotated = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rotated + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# GF(2) view: the state update s' = (s >> 8) ^ T[(s ^ byte) & 0xFF] is
# jointly linear in (state, byte), so advancing the state over n zero bytes
# is a 32x32 bit matrix Adv_n = A1^n, and raw(A||B) = Adv_|B|(raw(A)) ^
# raw(B) with raw(M) = raw_update(0, M).
# ---------------------------------------------------------------------------


def raw_update(state: int, data: bytes) -> int:
    """CRC state machine with NO init/final inversion (the linear core)."""
    t0 = tables()[0]
    state &= 0xFFFFFFFF
    for b in data:
        state = int(t0[(state ^ b) & 0xFF]) ^ (state >> 8)
    return state


_BIT32 = np.arange(32, dtype=np.uint64)


def bits_of(x: int) -> np.ndarray:
    return ((np.uint64(x) >> _BIT32) & np.uint64(1)).astype(np.uint8)


def pack_bits(bits: np.ndarray) -> int:
    return int((bits.astype(np.uint64) << _BIT32).sum()
               & np.uint64(0xFFFFFFFF))


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def advance_one() -> np.ndarray:
    """A1[:, i] = bits of raw_update(1 << i, b"\\x00"): one zero byte."""
    return np.stack([bits_of(raw_update(1 << i, b"\x00"))
                     for i in range(32)], axis=1)


@functools.lru_cache(maxsize=128)
def _advance_pow2(k: int) -> np.ndarray:
    if k == 0:
        return advance_one()
    m = _advance_pow2(k - 1)
    return _gf2_matmul(m, m)


@functools.lru_cache(maxsize=4096)
def advance_matrix(n: int) -> np.ndarray:
    """Adv_n: raw_update(s, 0^n) == Adv_n @ bits(s)."""
    m = np.eye(32, dtype=np.uint8)
    k = 0
    while n:
        if n & 1:
            m = _gf2_matmul(_advance_pow2(k), m)
        n >>= 1
        k += 1
    return m


def advance(state: int, n: int) -> int:
    """raw_update(state, b"\\x00" * n) without touching data bytes."""
    return pack_bits(_gf2_matmul(advance_matrix(n),
                                 bits_of(state)[:, None]).reshape(-1))


@functools.lru_cache(maxsize=4096)
def crc32c_zeros(n: int) -> int:
    """crc32c of n zero bytes (standard init/final inversion applied)."""
    return advance(0xFFFFFFFF, n) ^ 0xFFFFFFFF


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC32C of A||B from crc32c(A), crc32c(B) and len(B), as zlib's
    crc32_combine: the inversions cancel, leaving Adv_len_b(a) ^ b."""
    return advance(crc_a, len_b) ^ (crc_b & 0xFFFFFFFF)


def finalize_raw(raw: int, length: int) -> int:
    """Standard crc32c of an n-byte chunk from its raw image g(M):
    crc32c(M) = g(M) ^ crc32c(0^n)."""
    return (raw & 0xFFFFFFFF) ^ crc32c_zeros(length)
