"""ctypes loader for the repo's host C++ library (native/ec_native.cpp).

Bound: CRC32C (needle checksums, cold edges of the encode); the host
GF(2^8) matrix apply, which serves degraded-read decodes too small to be
worth a trip to the card, and its kernel-pinned form behind the "cpu"
codec backend; the fused span encode (parity plus chained shard
CRCs) of the host encode pipeline; and the inline-EC append's scatter of
one needle over the data-shard logs.  `lib()` runs
`make` in native/ once (a no-op when the library is fresh) and returns None
when no toolchain and no prebuilt library exist; callers then take the
pure-Python path.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libseaweedec.so")


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL | None:
    try:
        subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        cdll = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    cdll.sw_crc32c.restype = ctypes.c_uint32
    cdll.sw_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_size_t]
    cdll.sw_gf_apply_matrix.restype = None
    cdll.sw_gf_apply_matrix.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_char_p]
    cdll.sw_gf_apply_matrix_force.restype = None
    cdll.sw_gf_apply_matrix_force.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
    cdll.sw_encode_rows.restype = None
    cdll.sw_encode_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32)]
    if hasattr(cdll, "sw_inline_scatter"):  # absent in stale prebuilt libs
        cdll.sw_inline_scatter.restype = ctypes.c_int
        cdll.sw_inline_scatter.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64]
    return cdll
