"""Backend-selectable Reed-Solomon codec: the `reedsolomon.Encoder` seam.

`new_encoder(...)` is the port's `reedsolomon.New(10, 4)`:

  * "cuda"  (default) TorchEncoder on the card, kernel K1
  * "jax", "tpu"  the JAX package's names for its device codec: the
            TorchEncoder on `device` (the card unless device="cpu"), so
            one `-ec.backend` setting drives either package
  * "torch" TorchEncoder on the CPU, K1's plain version
  * "cpu"   NativeEncoder, the host C++ kernel ladder (native/)
  * "numpy" the pure NumPy reference
  * "auto"  cuda with a card, else cpu when the native library is built,
            else numpy

`reconstruct_span` rebuilds one shard's span with one cached decode row,
the degraded read's decode.  It routes by size: a survivor stack of at
least WEED_EC_RECOVER_DEVICE_MIN_KB goes to K1 on the device, a smaller
one to the host codec (native library, else NumPy), since below that a
trip over the link costs more than the mat-vec.  A caller that assembles
the stack asks `survivor_stack` where to put it: in a pinned slab leased
from the DevicePool when the route will send it to the card, so it
crosses the link with non_blocking=True and no staging copy (EcVolume's
read ladder does).  Any other stack crosses straight from its own memory.
With a `slab_key` the uploaded stack stays resident in the pool for the
next decode against the same survivors.
"""

from __future__ import annotations

import contextlib
import ctypes
import os

import numpy as np
import torch

from .. import device as device_mod
from . import native
from .device_pool import get_pool, lease_tensor
from .rs_numpy import (NumpyEncoder, ReconstructError,  # noqa: F401
                       RSCodecBase, decode_rows, gf_apply_matrix)
from .rs_torch import TorchEncoder, apply_matrix

_RECOVER_DEVICE_MIN_KB = 512


class NativeEncoder(RSCodecBase):
    """Host codec over the C++ kernel ladder of native/ec_native.cpp
    (GFNI+AVX-512 > GFNI+AVX2 > AVX2-PSHUFB > scalar, chosen at run time).
    `level` pins one kernel: 1 is the AVX2 PSHUFB nibble-table kernel;
    -1 (default) the best available."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 level: int = -1):
        super().__init__(data_shards, parity_shards)
        self._lib = native.lib()
        self._level = level
        if self._lib is None:
            raise RuntimeError("native library unavailable")

    def _apply(self, matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
        p, d = matrix.shape
        length = inputs.shape[1]
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        inputs = np.ascontiguousarray(inputs, dtype=np.uint8)
        out = np.zeros((p, length), dtype=np.uint8)
        self._lib.sw_gf_apply_matrix_force(
            matrix.ctypes.data_as(ctypes.c_char_p), p, d,
            inputs.ctypes.data_as(ctypes.c_char_p), length,
            out.ctypes.data_as(ctypes.c_char_p), self._level)
        return out

    def encode_rows(self, parity_matrix: np.ndarray, data: np.ndarray,
                    parity_out: np.ndarray) -> list[int]:
        """Fused span encode: data (R, d, L) -> parity_out (R, p, L) in one
        call; returns the per-shard CRC32Cs chained across the R rows (the
        rolling file CRC of the span's R * L-byte shard slice).  The caller
        owns both buffers; nothing is retained after the call.  All three
        arrays must be C-contiguous uint8."""
        for name, arr in (("parity_matrix", parity_matrix),
                          ("data", data), ("parity_out", parity_out)):
            if arr.dtype != np.uint8 or not arr.flags["C_CONTIGUOUS"]:
                raise ValueError(
                    f"encode_rows: {name} must be C-contiguous uint8 "
                    f"(got dtype={arr.dtype}, "
                    f"contiguous={arr.flags['C_CONTIGUOUS']})")
        p, d = parity_matrix.shape
        rows, _, length = data.shape
        if parity_out.shape != (rows, p, length):
            raise ValueError(
                f"encode_rows: parity_out shape {parity_out.shape} != "
                f"{(rows, p, length)}")
        crcs = (ctypes.c_uint32 * (d + p))()
        self._lib.sw_encode_rows(
            parity_matrix.ctypes.data_as(ctypes.c_char_p), p, d,
            data.ctypes.data_as(ctypes.c_char_p), length, rows,
            parity_out.ctypes.data_as(ctypes.c_char_p), crcs)
        return list(crcs)


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


def _device_route(nbytes: int, dev: torch.device) -> bool:
    """Whether reconstruct_span decodes a stack of `nbytes` on `dev` (a
    resolved device): the size threshold and the knob."""
    return nbytes >= recover_device_min_bytes() and \
        recover_device_enabled(dev)


@contextlib.contextmanager
def survivor_stack(shape: tuple, dev: torch.device):
    """Where to assemble a (d, L) survivor stack bound for
    reconstruct_span on `dev` (a resolved device), as np.stack's `out=`.
    When the route sends a stack of this size to a card, yields a uint8
    view of a pinned host slab leased from the DevicePool: the stack then
    crosses the link from it asynchronously, with no staging copy.  Else
    yields None, and np.stack builds an ordinary array.  The slab goes
    back to the pool when the block exits, so the decode must have
    returned by then."""
    n = shape[0] * shape[1]
    if dev.type != "cuda" or not _device_route(n, dev):
        yield None
        return
    pool = get_pool()
    ls = _lease_host(pool, n, dev)
    try:
        yield ls.payload[:n].numpy().reshape(shape)
    finally:
        pool.release(ls)


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


def _bucket(nbytes: int) -> int:
    """Slab size for `nbytes`: the next power of two (at least 64 KiB), so
    the pool keeps a few staging sizes, not one per span length."""
    return 1 << max(16, (nbytes - 1).bit_length())


def _lease_host(pool, nbytes: int, dev: torch.device):
    """A flat uint8 host staging slab of at least `nbytes`, pinned when
    it feeds a card."""
    return lease_tensor(pool, "recover-host", (_bucket(nbytes),),
                        torch.uint8, pinned=dev.type == "cuda")


def _lease_device(pool, tag: str, nbytes: int, dev: torch.device):
    return lease_tensor(pool, tag, (_bucket(nbytes),), torch.uint8, dev)


def _upload(pool, stack: np.ndarray, dev: torch.device,
            into: torch.Tensor) -> torch.Tensor:
    """Copy the host stack into `into` (a flat device slab) on the current
    stream and return its (d, L) view.  A stack in pinned memory (a
    `survivor_stack` slab) crosses asynchronously.  Any other crosses
    straight from its pageable memory, which the driver stages in pipelined
    chunks: an explicit copy into a pinned slab first is not overlapped
    with anything and measured slower on the H100 (PERF.md section 5)."""
    d, length = stack.shape
    src = torch.from_numpy(stack)
    din = into[:stack.nbytes].view(d, length)
    din.copy_(src, non_blocking=dev.type == "cuda" and src.is_pinned())
    pool.note_h2d(stack.nbytes, device=dev)
    return din


def _device_decode(rows: np.ndarray, stack: np.ndarray, dev: torch.device,
                   resident_key=None) -> np.ndarray:
    """rows (t, d) x stack (d, L) with K1 on `dev`: the stack crosses the
    link into a leased device slab (or stays resident under
    `resident_key`), K1 writes into a leased device slab, and the result
    comes back through a pinned slab."""
    pool = get_pool()
    d, length = stack.shape
    t = rows.shape[0]
    # synchronized once on success; on an exception the finally clause
    # waits instead, so no slab goes back while a queued copy reads it
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    held = []
    resident = False
    try:
        if resident_key is None:
            din_slab = _lease_device(pool, "recover-in", stack.nbytes, dev)
            held.append(din_slab)
            din = _upload(pool, stack, dev, din_slab.payload)
        else:
            def make():
                flat = torch.empty(stack.nbytes, dtype=torch.uint8,
                                   device=dev)
                return _upload(pool, stack, dev, flat)
            din = pool.acquire_resident(resident_key, make, stack.nbytes)
            resident = True
        dout_slab = _lease_device(pool, "recover-out", t * length, dev)
        held.append(dout_slab)
        dout = apply_matrix(rows, din,
                            out=dout_slab.payload[:t * length].view(
                                t, length))
        hout_slab = _lease_host(pool, t * length, dev)
        held.append(hout_slab)
        hout = hout_slab.payload[:t * length].view(t, length)
        hout.copy_(dout, non_blocking=True)
        if stream is not None:
            stream.synchronize()
            stream = None
        pool.note_d2h(t * length, device=dev)
        return hout.numpy().copy()
    finally:
        if stream is not None:
            stream.synchronize()
        if resident:
            pool.release_resident(resident_key)
        for ls in held:
            pool.release(ls)


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

    slab_key: an identity of `inputs`: equal keys must mean equal
    stacks (EcVolume keys by its mount and the spans' positions, which
    its immutable shard files make sound).  On the device route the upload then goes through
    the DevicePool's resident slabs under ("recover", family, survivors,
    slab_key): consecutive decodes against the same survivor spans (a
    different missing target, or a block recovered again after cache
    eviction) reuse the device copy instead of crossing the link again.

    family: an erasure_coding.codes CodeFamily; None is RS(data, total)
    on the shared decode-plan cache.  A family supplies its own cached
    decode plan and lane view of the stack."""
    dev = device_mod.resolve(device)
    fam_name = getattr(family, "name", None)
    if family is None:
        rows = decode_rows(data_shards, total_shards, survivors, (target,))
        stack = inputs
    else:
        rows = family.decode_rows(tuple(survivors), (target,))
        stack = family.to_lanes(np.ascontiguousarray(inputs))
    stack = np.ascontiguousarray(stack, dtype=np.uint8)
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if _device_route(inputs.nbytes, dev):
        key = None if slab_key is None else \
            ("recover", fam_name, tuple(survivors), slab_key)
        out = _device_decode(rows, stack, dev, key)
    else:
        out = _apply_rows_host(rows, stack)
    return out[0] if family is None else family.from_lanes(out)[0]


def new_host_encoder(data_shards: int = 10, parity_shards: int = 4):
    """The best HOST codec (native, else NumPy), never a device backend:
    the link-throughput auto-selection falls back to this when the link
    would cap the device path below the host rate."""
    if native.lib() is not None:
        return NativeEncoder(data_shards, parity_shards)
    return NumpyEncoder(data_shards, parity_shards)


def new_encoder(data_shards: int = 10, parity_shards: int = 4,
                backend: str = "cuda", device=None):
    if backend == "auto":
        if torch.cuda.is_available():
            backend = "cuda"
        elif native.lib() is not None:
            backend = "cpu"
        else:
            backend = "numpy"
    if backend == "cuda":
        return TorchEncoder(data_shards, parity_shards, device="cuda")
    if backend in ("jax", "tpu"):
        return TorchEncoder(data_shards, parity_shards, device=device)
    if backend == "torch":
        return TorchEncoder(data_shards, parity_shards, device="cpu")
    if backend == "cpu":
        return NativeEncoder(data_shards, parity_shards)
    if backend == "numpy":
        return NumpyEncoder(data_shards, parity_shards)
    raise ValueError(f"unknown backend {backend!r}")
