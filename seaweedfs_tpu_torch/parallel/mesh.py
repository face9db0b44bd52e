"""Batched EC steps over kernels K1 and K2, on one device or a list.

Counterpart of seaweedfs_tpu/parallel/mesh.py:

  make_mesh             every device (or the given ones) as a "mesh": here
                        a list of torch devices, batches split on their B
                        axis, one launch per device;
  shard_devices / make_ec_mesh  the devices the EC dispatch splits batches
                        over (WEED_EC_DEVICE_SHARD);
  make_sharded_encoder  the encode step: (B, d, L) data -> parity and the
                        raw CRC32C images of all d + p rows; words=True is
                        K2 with the parity matrix, words=False the portable
                        step (batched_encode_step / batched_swar_encode_step);
  batched_encode_step / batched_swar_encode_step / _parity_bits_matmul
                        the reference's portable step forms ("K7"): K2 (K1
                        for the parity-only form) on a CUDA tensor; on a
                        CPU tensor each keeps its own plain formulation, the
                        GF(2) bit-matmul or SWAR over packed int32 words,
                        with K4's plain CRC;
  make_sharded_apply    the rebuild step: (B, d, L) survivors -> the t
                        missing rows and their raw CRC images (K2 with a
                        reconstruction matrix; K2 also CRCs the inputs,
                        the step keeps the last t);
  make_parity_step      the pooled step (the JAX package's XLA step, "K5"):
                        (k, B, L) data -> (p, B, L) parity written into a
                        leased output slot, and with fused_crc the raw CRCs
                        of all k + p rows, over K1 or K2
                        (parity_step_plain: its plain version);
  words_capable         whether the words route (K2 on (B, 10, L)) serves;
  step_cost_analysis    the analytic cost of a step geometry;
  encode_batch          host convenience over the encode step.

A kernel that fails raises; there is no fallback step.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from .. import device as device_mod
from .. import profiling
from ..ops import gf256, rs_cuda
from ..ops.crc_device import batched_crc32c_raw, finalize
from ..ops.rs_cuda import (_matrix_key, fused_apply_crc, gf_apply,
                           k2_scratch_shape)
from ..ops.rs_torch import (_bit_constants_cached, _bit_matrix_cached,
                            bits_matmul, swar_words)


def make_mesh(devices=None) -> list:
    """The reference's mesh over all devices, as the port's list of torch
    devices: every CUDA card when None (raising without one), else
    `devices` (one device or a list) resolved.  Unlike make_ec_mesh it is
    not cut by WEED_EC_DEVICE_SHARD."""
    if devices is None:
        device_mod.resolve(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [device_mod.resolve(d) for d in devices]


def shard_devices(devices: list) -> list:
    """The devices the EC dispatch splits batches over, governed by
    WEED_EC_DEVICE_SHARD:

      <int>          exactly that many devices (clamped to the list)
      "auto" / unset every device of the list; for CPU devices at most
                     one per usable core, since more only add splitting
                     overhead
    """
    raw = os.environ.get("WEED_EC_DEVICE_SHARD", "").strip().lower()
    n = len(devices)
    if raw and raw != "auto":
        try:
            n = max(1, min(len(devices), int(raw)))
        except ValueError:
            pass
    elif devices[0].type == "cpu":
        from ..util.platform import available_cpu_count

        n = max(1, min(len(devices), available_cpu_count()))
    return list(devices)[:n]


def make_ec_mesh(devices=None) -> list:
    """The EC dispatch devices: `devices` (one device or a list) resolved,
    or every CUDA card when None (raising without one), cut by
    shard_devices."""
    if devices is None:
        device_mod.resolve(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    return shard_devices([device_mod.resolve(d) for d in devices])


def split_batch(b: int, n: int) -> list[tuple[int, int]]:
    """The [lo, hi) B ranges of n devices for a batch of b (b % n == 0)."""
    per = b // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def words_capable(devices: list, chunk_len: int) -> bool:
    """True when the words route serves: one CUDA card and a chunk that
    packs into 4-byte words.  K2 takes any L, so no self-test is needed."""
    return (len(devices) == 1 and devices[0].type == "cuda"
            and chunk_len % 4 == 0)


def _coefficients(bit_matrix) -> np.ndarray:
    """The (p, d) GF(2^8) matrix behind a (8p, 8d) bit matrix: column 8j
    of row block i holds the bits of gf_mul(M[i, j], 1) = M[i, j]."""
    bm = np.asarray(bit_matrix.cpu() if isinstance(bit_matrix, torch.Tensor)
                    else bit_matrix, dtype=np.uint8)
    p8, d8 = bm.shape
    col0 = bm[:, 0::8].reshape(p8 // 8, 8, d8 // 8).astype(np.uint32)
    return np.ascontiguousarray(
        (col0 << np.arange(8, dtype=np.uint32)[None, :, None]).sum(1),
        dtype=np.uint8)


def _parity_bits_matmul(bit_matrix, data: torch.Tensor) -> torch.Tensor:
    """(B, d, L) uint8 -> (B, p, L) uint8 parity for a (8p, 8d) bit
    matrix: K1 over the (d, B*L) stack on a CUDA tensor, the GF(2)
    bit-matmul on the CPU."""
    b, d, length = data.shape
    if data.device.type == "cuda":
        m = _coefficients(bit_matrix)
        stack = data.permute(1, 0, 2).reshape(d, b * length).contiguous()
        return gf_apply(m, stack).view(-1, b, length).permute(1, 0, 2)
    bm = torch.as_tensor(np.asarray(bit_matrix.cpu() if isinstance(
        bit_matrix, torch.Tensor) else bit_matrix))
    return bits_matmul(bm, data)


def batched_swar_encode_step(consts, data: torch.Tensor):
    """The reference's CPU-mesh step: SWAR parity over packed int32 words
    plus the raw CRC32C images of all rows.  consts (p, d, 8) int32 =
    gf_mul(M[i, j], 1 << b); data (B, d, L) uint8 with L % 4 == 0 ->
    (parity (B, p, L) uint8, crc_raw (B, d + p) int64).  K2 on a CUDA
    tensor."""
    c = torch.as_tensor(np.asarray(consts.cpu() if isinstance(
        consts, torch.Tensor) else consts, dtype=np.int32))
    if data.device.type == "cuda":
        m = np.ascontiguousarray(c[:, :, 0].numpy(), dtype=np.uint8)
        return fused_apply_crc(m, data)
    b, d, length = data.shape
    words = data.contiguous().view(torch.int32)
    parity = swar_words(c, words).view(torch.uint8).view(b, -1, length)
    return parity, batched_crc32c_raw(torch.cat([data, parity], dim=1))


def batched_encode_step(bit_matrix, data: torch.Tensor):
    """The reference's flagship step: (B, d, L) uint8 -> (parity (B, p, L),
    crc_raw (B, d + p) int64), the raw CRC32C images of every data and
    parity row.  K2 on a CUDA tensor; on the CPU the bit-matmul parity
    and K4's plain CRC."""
    if data.device.type == "cuda":
        return fused_apply_crc(_coefficients(bit_matrix), data)
    parity = _parity_bits_matmul(bit_matrix, data)
    return parity, batched_crc32c_raw(torch.cat([data, parity], dim=1))


def make_sharded_encoder(data_shards: int = 10, parity_shards: int = 4,
                         words: bool = False, matrix=None):
    """The encode step on data's device: (B, d, L) uint8 tensor ->
    (parity (B, p, L) uint8, crc_raw (B, d + p) int64).

    words=True   K2 with the parity matrix; step(data, out=None, crc=None,
                 partial=None) takes K2's preallocated outputs and scratch
                 (the words route of parallel/batched_encode).
    words=False  the portable step: batched_encode_step on a CUDA tensor
                 (K2) and on the CPU for odd L, batched_swar_encode_step
                 on the CPU when L % 4 == 0, as the reference picks on a
                 CPU mesh.
    matrix: another (p, d) parity matrix (a code family of RS's
    geometry); None for the RS Vandermonde rows."""
    matrix = np.ascontiguousarray(
        gf256.parity_matrix(data_shards, data_shards + parity_shards)
        if matrix is None else matrix, dtype=np.uint8)
    if words:
        def step(data: torch.Tensor, out=None, crc=None, partial=None):
            return fused_apply_crc(matrix, data, out, crc, partial)
        return step
    key = _matrix_key(matrix)
    bit_matrix = _bit_matrix_cached(*key)
    consts = _bit_constants_cached(*key)

    def step(data: torch.Tensor):
        if data.device.type == "cpu" and data.shape[-1] % 4 == 0:
            return batched_swar_encode_step(consts, data)
        return batched_encode_step(bit_matrix, data)
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


class ParityStep:
    """The pooled parity step: step(data, out) with data (k, B, L) uint8
    and out (p, B, L) uint8, a leased slot the parity is written into.
    k is the compacted data-row count (trailing all-zero rows sliced off),
    so the step uses the matrix's first k columns, each slice with its own
    cached kernel tables.

      fused_crc=False  K1 over the (k, B*L) byte stack into out viewed as
                       (p, B*L); data must be contiguous.  Returns None.
      fused_crc=True   K2 reading the buffer as (B, k, L) through strides,
                       writing out through strides; returns the raw CRC32C
                       images (k + p, B) int64 of every data and parity
                       row (a transposed view of K2's (B, k + p) output).

    On n >= 2 devices, data and out are lists of per-device shards split
    on the B axis (split_batch) and the step launches once per device,
    returning a list of CRC views.  Neither form copies or allocates on
    the device in its steady state: K2's CRC and scratch buffers are kept
    per output slot (keyed by its address and k), so a CRC view stays
    valid until its slot is stepped again."""

    _SCRATCH_MAX = 256

    def __init__(self, devices: list, matrix: np.ndarray, fused_crc: bool):
        self.devices = list(devices)
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        self.fused_crc = fused_crc
        self.parity_shards = self.matrix.shape[0]
        self._scratch: "OrderedDict[tuple, tuple]" = OrderedDict()

    def _columns(self, k: int) -> np.ndarray:
        if not 1 <= k <= self.matrix.shape[1]:
            raise ValueError(f"parity step: k = {k} outside 1.."
                             f"{self.matrix.shape[1]}")
        return np.ascontiguousarray(self.matrix[:, :k])

    def _crc_buffers(self, data: torch.Tensor, out: torch.Tensor):
        k, b, length = data.shape
        p = self.parity_shards
        key = (out.device, out.data_ptr(), k, b, length)
        bufs = self._scratch.get(key)
        if bufs is None:
            bufs = (torch.empty((b, k + p), dtype=torch.int64,
                                device=out.device),
                    torch.empty(k2_scratch_shape(p, k, b, length),
                                dtype=torch.int32, device=out.device))
            self._scratch[key] = bufs
            while len(self._scratch) > self._SCRATCH_MAX:
                self._scratch.popitem(last=False)
        else:
            self._scratch.move_to_end(key)
        return bufs

    def _one(self, data: torch.Tensor, out: torch.Tensor):
        k, b, length = data.shape
        p = self.parity_shards
        if tuple(out.shape) != (p, b, length):
            raise ValueError(f"parity step: out {tuple(out.shape)} for "
                             f"data {tuple(data.shape)}")
        m = self._columns(k)
        if not self.fused_crc:
            if not (data.is_contiguous() and out.is_contiguous()):
                raise ValueError("parity step: data and out must be "
                                 "contiguous (k, B, L) / (p, B, L) buffers")
            gf_apply(m, data.view(k, b * length), out=out.view(p, b * length))
            return None
        crc, partial = self._crc_buffers(data, out)
        fused_apply_crc(m, data.permute(1, 0, 2), out.permute(1, 0, 2),
                        crc, partial)
        return crc.t()

    def __call__(self, data, out):
        if isinstance(data, torch.Tensor):
            return self._one(data, out)
        if len(data) != len(out):
            raise ValueError("parity step: one data and one out shard per "
                             "device")
        return [self._one(x, o) for x, o in zip(data, out)]


def parity_step_plain(matrix: np.ndarray, data: torch.Tensor,
                      fused_crc: bool = False):
    """The parity step's plain version (the kernels' plain versions on any
    device): data (k, B, L) -> (parity (p, B, L), raw CRCs (k + p, B) or
    None)."""
    k, b, length = data.shape
    m = np.ascontiguousarray(np.asarray(matrix, dtype=np.uint8)[:, :k])
    if not fused_crc:
        par = rs_cuda.gf_apply_plain(m, data.reshape(k, b * length))
        return par.view(m.shape[0], b, length), None
    par, crc = rs_cuda.fused_apply_crc_plain(m, data.permute(1, 0, 2))
    return par.permute(1, 0, 2), crc.t()


_PARITY_STEP_CACHE: dict = {}


def make_parity_step(devices: list, data_shards: int = 10,
                     parity_shards: int = 4, matrix=None, key=None,
                     fused_crc: bool = False) -> ParityStep:
    """The persistent pooled parity step for `devices` (ParityStep).
    matrix / key: another GF(2^8) coefficient matrix (a code family's
    parity rows) with an optional hashable cache identity; omitted, the
    RS Vandermonde parity rows.  Cached per (devices, matrix, fused_crc)."""
    devs = tuple(str(d) for d in devices)
    if matrix is None:
        cache_key = (devs, data_shards, parity_shards, fused_crc)
        matrix = gf256.parity_matrix(data_shards,
                                     data_shards + parity_shards)
    else:
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        cache_key = (devs, key if key is not None else
                     (matrix.tobytes(), matrix.shape), fused_crc)
    step = _PARITY_STEP_CACHE.get(cache_key)
    if step is None:
        step = _PARITY_STEP_CACHE[cache_key] = ParityStep(devices, matrix,
                                                          fused_crc)
    return step


_COST_CACHE: dict = {}


def step_cost_analysis(key: str, k: int, b: int, length: int,
                       parity_shards: int = 4,
                       fused_crc: bool = False) -> dict:
    """The analytic cost of one parity-step geometry, recorded once per
    `key` in profiling's kernel-cost table: GF(2^8) multiply-adds
    (p * k * B * L, reported as "flops") and device bytes (the k data rows
    read, the p parity rows written, and with fused_crc the int64 CRC
    images)."""
    cached = _COST_CACHE.get(key)
    if cached is not None:
        return cached
    p = parity_shards
    flops = float(p * k * b * length)
    nbytes = float((k + p) * b * length + (8 * (k + p) * b if fused_crc
                                           else 0))
    entry = {"flops": flops, "bytes_accessed": nbytes}
    _COST_CACHE[key] = entry
    profiling.record_kernel_cost(key, flops, nbytes)
    return entry


def encode_batch(data: np.ndarray, device=None):
    """(B, 10, L) host batch -> (parity (B, 4, L) uint8, crcs (B, 14)
    uint32) with the CRCs finalized to standard CRC32C of each row."""
    dev = device_mod.resolve(device)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    parity, crc_raw = make_sharded_encoder(words=True)(
        torch.from_numpy(data).to(dev))
    return parity.cpu().numpy(), finalize(crc_raw, data.shape[-1])
