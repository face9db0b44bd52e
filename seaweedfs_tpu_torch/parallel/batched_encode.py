"""Streaming batched EC encode and rebuild: .dat files -> 14 shard files.

Counterpart of seaweedfs_tpu/parallel/batched_encode.py.  The striped rows
of many volumes are tiled into batches and pushed through the device with
a pipeline:

  reader thread     fills staging slots (pinned on a card) from the .dat
                    files, and writes the data-shard bytes to .ec00-.ec09
                    (data shards are a re-interleaving of the .dat;
                    all-zero padding rows are skipped, the files are
                    ftruncate()d to final size);
  main thread       yields to foreground decodes (LANES), copies a slot to
                    the device on a copy stream into a leased input slab,
                    runs the step on the compute stream into a leased
                    output slot once the copy landed, and queues the D2H
                    copies into leased pinned host buffers, with up to
                    WEED_EC_DEVICE_INFLIGHT batches in flight;
  completion thread frees a staging slot once its copy completed, waits for
                    the batch, reads its dispatch-to-ready time from CUDA
                    events, finalizes the per-chunk CRCs and chains them
                    into per-shard-file CRC32Cs, and hands parity to
  writer thread     which writes .ec10-.ec13.

Two device routes (`stage_stats["backend"]`):

  device-words      one card and 4-byte chunks (mesh.words_capable): K2 on
                    (B, 10, L) staging, parity and every row's CRC in one
                    pass;
  device-pooled     otherwise: (10, B, L) staging with trailing all-zero
                    rows compacted to the batch's k_max, the pooled parity
                    step (mesh.make_parity_step) writing into a leased
                    out-ring of depth + 1 slots, split on the B axis over
                    n >= 1 devices; WEED_EC_FUSED_CRC picks device CRCs
                    (K2, "device-pooled-fused-crc") or the host crc32c
                    walk (K1, the CPU default).

Every buffer (staging slots, device input slabs, output slots, pinned host
outputs) is leased from the DevicePool and released at the end, so a
second encode of the same geometry allocates nothing.  On a CPU device the
same pipeline runs the kernels' plain versions without copies.

`encode_volumes(host_codec=...)` runs the host pipeline instead
(`_encode_units_host`): a reader thread, codec workers on the native fused
parity+CRC call, and a writer pool.

`encode_volumes(parity=...)` encodes with another (4, 10) parity matrix
over the same stripe layout: a code family of RS's geometry (the Cauchy
MDS code) runs on both routes, the card's through K2 or K1, where the
reference encodes it in its family host loop; the files are the same.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from .. import profiling, tracing
from ..ops import crc32c as crc_host
from ..ops.crc_device import finalize
from ..ops.device_pool import get_pool, lease_tensor
from ..qos import lanes as _lanes
from ..stats import metrics as _stats
from ..util.platform import available_cpu_count
from .mesh import (k2_scratch_shape, make_ec_mesh, make_parity_step,
                   make_sharded_apply, make_sharded_encoder, split_batch,
                   step_cost_analysis, words_capable)

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = 14

# per-dispatch target: B * 10 * L bytes of data-shard input
TARGET_BATCH_BYTES = 64 << 20
MAX_CHUNK_BYTES = 1 << 20
_SLOTS = 4     # host staging buffers in flight
_INFLIGHT = 3  # device dispatches queued before the completion side drains


@dataclass
class _Unit:
    """One (volume, row, column-chunk): a (10, L) slice of work."""
    vol: int
    row_start: int     # byte offset of the row in the .dat
    shard_off: int     # byte offset of this chunk in each shard file
    col: int           # column offset within the row's blocks
    block_size: int
    real_rows: int = DATA_SHARDS  # rows holding any .dat bytes


@dataclass
class _VolumePlan:
    base: str
    dat_size: int
    rows: list[tuple[int, int, int]] = field(default_factory=list)
    # (row_start_in_dat, shard_offset, block_size)


def _plan_volume(base: str, large_block: int, small_block: int) -> _VolumePlan:
    """Row plan of WriteEcFiles striping: large rows while more than 10
    large blocks remain, then small rows, zero-padded."""
    dat_size = os.path.getsize(base + ".dat")
    plan = _VolumePlan(base, dat_size)
    remaining = dat_size
    row_start = shard_off = 0
    while remaining > large_block * DATA_SHARDS:
        plan.rows.append((row_start, shard_off, large_block))
        row_start += large_block * DATA_SHARDS
        shard_off += large_block
        remaining -= large_block * DATA_SHARDS
    while remaining > 0:
        plan.rows.append((row_start, shard_off, small_block))
        row_start += small_block * DATA_SHARDS
        shard_off += small_block
        remaining -= small_block * DATA_SHARDS
    return plan


def _chunk_len(large_block: int, small_block: int) -> int:
    """Column-chunk width L: divides every block size in the plan."""
    cand = min(small_block, MAX_CHUNK_BYTES)
    if large_block % cand == 0 and small_block % cand == 0:
        return cand
    return math.gcd(large_block, small_block)


def _make_units(plans: list[_VolumePlan], chunk: int) -> list[_Unit]:
    units = []
    for vi, plan in enumerate(plans):
        for row_start, shard_off, block in plan.rows:
            for col in range(0, block, chunk):
                # rows i with row_start + i*block + col < dat_size carry
                # real bytes; the rest are the format's zero padding
                avail = plan.dat_size - row_start - col
                real = 0 if avail <= 0 else min(DATA_SHARDS,
                                                 -(-avail // block))
                units.append(_Unit(vi, row_start, shard_off + col, col,
                                   block, real))
    return units


# -- the write stage's plumbing: checked vectored writes, writeback pacing
# and the raw shard fd set ---------------------------------------------------

_IOV_MAX = 1024       # the kernel's cap on iovecs per pwritev
_SFR_WAIT_BEFORE = 1  # SYNC_FILE_RANGE_WAIT_BEFORE
_SFR_WRITE = 2        # SYNC_FILE_RANGE_WRITE
_SFR_WAIT_AFTER = 4   # SYNC_FILE_RANGE_WAIT_AFTER


def _sync_file_range():
    """ctypes handle to sync_file_range(2), or None where libc lacks it."""
    try:
        fn = ctypes.CDLL(None, use_errno=True).sync_file_range
    except (OSError, AttributeError):
        return None
    fn.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_uint]
    fn.restype = ctypes.c_int
    return fn


def _write_knobs() -> tuple[bool, int, int, bool]:
    """The WEED_EC_WRITE_* knobs, read per call:
    (write_behind, writers, flush_bytes, drop_cache).

      WEED_EC_WRITE_BEHIND     0 disables the host pipeline's writer stage
                               (codec workers write synchronously)
      WEED_EC_WRITERS          the host pipeline's writer-pool size (0 =
                               auto: workers / 2, at most 4)
      WEED_EC_WRITE_FLUSH_MB   writeback pacing window in MiB (0 disables
                               pacing; default 32)
      WEED_EC_WRITE_DROP_CACHE 1 = drop synced windows from the page cache
    """
    behind = os.environ.get("WEED_EC_WRITE_BEHIND", "1").lower() \
        not in ("0", "false", "no")
    writers = int(os.environ.get("WEED_EC_WRITERS", "0") or 0)
    mb = os.environ.get("WEED_EC_WRITE_FLUSH_MB", "")
    flush_bytes = int(float(mb) * (1 << 20)) if mb else (32 << 20)
    drop = os.environ.get("WEED_EC_WRITE_DROP_CACHE", "0").lower() \
        not in ("", "0", "false", "no")
    return behind, writers, flush_bytes, drop


def _pwritev_full(fd: int, bufs, offset: int) -> int:
    """pwritev that writes every byte or raises OSError: a short write
    must fail the encode, not truncate a shard whose CRC is already
    computed.  Partial progress is retried; zero progress raises."""
    iovs = [memoryview(b).cast("B") for b in bufs]
    total = sum(v.nbytes for v in iovs)
    written = 0
    while written < total:
        n = os.pwritev(fd, iovs, offset + written)
        if n <= 0:
            raise OSError(
                "pwritev made no progress: %d of %d bytes at offset %d "
                "(shard would be truncated)" % (written, total, offset))
        written += n
        if written >= total:
            break
        while n >= iovs[0].nbytes:  # drop fully-written iovecs
            n -= iovs[0].nbytes
            iovs.pop(0)
        if n:
            iovs[0] = iovs[0][n:]
    return total


class _WritebackPacer:
    """After every `flush_bytes` written to an fd, start the kernel's
    writeback of the new window (sync_file_range WRITE), so dirty pages
    drain steadily instead of stalling every writer at vm.dirty_ratio.
    With drop_cache the window is synced and evicted: shard bytes are
    written once and not read back by this process."""

    def __init__(self, flush_bytes: int, drop_cache: bool):
        self.flush_bytes = flush_bytes
        self.drop_cache = drop_cache
        self._sfr = _sync_file_range() if flush_bytes > 0 else None
        self._lock = threading.Lock()
        self._state: dict[int, list[int]] = {}  # fd -> [acc, cursor, hi]
        self.flush_seconds = 0.0
        self.flushes = 0

    def wrote(self, fd: int, offset: int, n: int):
        if self.flush_bytes <= 0 or n <= 0:
            return
        with self._lock:
            st = self._state.setdefault(fd, [0, 0, 0])
            st[0] += n
            st[2] = max(st[2], offset + n)
            if st[0] < self.flush_bytes:
                return
            st[0] = 0
            lo, hi = st[1], st[2]
            st[1] = hi
        self._flush_window(fd, lo, hi)

    def _flush_window(self, fd: int, lo: int, hi: int):
        if hi <= lo:
            return
        t0 = time.perf_counter()
        try:
            if self._sfr is not None:
                self._sfr(fd, lo, hi - lo, _SFR_WRITE)
            if self.drop_cache:
                if self._sfr is not None:
                    self._sfr(fd, lo, hi - lo,
                              _SFR_WAIT_BEFORE | _SFR_WRITE | _SFR_WAIT_AFTER)
                os.posix_fadvise(fd, lo, hi - lo, os.POSIX_FADV_DONTNEED)
        except OSError:
            self.flush_bytes = 0  # the filesystem refuses; stop pacing
            return
        with self._lock:
            self.flush_seconds += time.perf_counter() - t0
            self.flushes += 1

    def forget(self, fds):
        """Drop per-fd state on close: fd numbers get recycled."""
        with self._lock:
            for fd in fds:
                self._state.pop(fd, None)


class _ShardFileSet:
    """One volume's 14 shard files as raw O_WRONLY fds, ftruncate()d to
    their final size up front, with rolling per-file CRC32Cs.  pwritev is
    positional, so reader and writer threads write concurrently."""

    def __init__(self, base: str, to_ext, shard_size: int = 0,
                 pacer: Optional[_WritebackPacer] = None):
        self.fds = [os.open(base + to_ext(i),
                            os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644)
                    for i in range(TOTAL_SHARDS)]
        if shard_size:
            for fd in self.fds:
                os.ftruncate(fd, shard_size)
        self.crcs = [0] * TOTAL_SHARDS
        self.pacer = pacer

    def write(self, shard: int, bufs, offset: int) -> int:
        fd = self.fds[shard]
        n = _pwritev_full(fd, bufs, offset)
        if self.pacer is not None:
            self.pacer.wrote(fd, offset, n)
        return n

    def close(self):
        if self.pacer is not None:
            self.pacer.forget(self.fds)
        for fd in self.fds:
            os.close(fd)


# -- pool leases --------------------------------------------------------------


def _wait(event):
    if event is not None:
        event.synchronize()


def _device_inflight() -> int:
    """WEED_EC_DEVICE_INFLIGHT: device dispatches in flight before the
    completion side must drain one (default 3)."""
    try:
        return max(1, int(
            os.environ.get("WEED_EC_DEVICE_INFLIGHT", "") or _INFLIGHT))
    except ValueError:
        return _INFLIGHT


def _fused_crc_on(device_type: str) -> bool:
    """WEED_EC_FUSED_CRC: whether the pooled route also computes every
    shard row's CRC32C on the device ("1"/"0" force it; "auto", the
    default, fuses on a card and keeps the host crc32c walk on the CPU,
    where the native CRC is far faster than the plain bit-matmul CRC)."""
    raw = os.environ.get("WEED_EC_FUSED_CRC", "auto").strip().lower()
    if raw in ("1", "on", "true", "fused", "yes"):
        return True
    if raw in ("0", "off", "false", "host", "no"):
        return False
    return device_type != "cpu"


# -- encode -------------------------------------------------------------------


def encode_volumes(bases: list[str], large_block: Optional[int] = None,
                   small_block: Optional[int] = None,
                   batch_units: Optional[int] = None,
                   stage_stats: Optional[dict] = None,
                   device=None, mesh=None,
                   host_codec=None,
                   parity=None) -> dict[str, list[int]]:
    """Encode every `base` (.dat) into 14 shard files.  Returns {base:
    [crc32c of each shard file] * 14}.  Chunks of all volumes share the
    device dispatches.

    device / mesh: the device (or list of devices) the batches run on;
    neither given means every CUDA card (make_ec_mesh), raising without
    one.  host_codec: an encoder object, or True for the best host codec,
    runs the host pipeline instead (no device).  parity: a (4, 10)
    parity matrix replacing the RS Vandermonde rows (a code family of
    RS's geometry); None for RS.

    stage_stats: filled with per-stage busy seconds (read, dispatch,
    encode_crc, write), their fractions of wall time, the route and the
    pipeline's shape (module docstring)."""
    from ..storage.erasure_coding import (LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                                          to_ext)

    devices = None if host_codec else \
        make_ec_mesh(mesh if mesh is not None else device)
    large_block = large_block or LARGE_BLOCK_SIZE
    small_block = small_block or SMALL_BLOCK_SIZE
    plans = [_plan_volume(b, large_block, small_block) for b in bases]
    chunk = _chunk_len(large_block, small_block)
    units = _make_units(plans, chunk)
    if not units:
        for p in plans:
            _ShardFileSet(p.base, to_ext).close()
        return {p.base: [0] * TOTAL_SHARDS for p in plans}
    if host_codec:
        return _encode_units_host(plans, host_codec, stage_stats, parity)
    _, _, flush_bytes, drop_cache = _write_knobs()
    pacer = _WritebackPacer(flush_bytes, drop_cache)
    writers = {vi: _ShardFileSet(
                   p.base, to_ext,
                   (p.rows[-1][1] + p.rows[-1][2]) if p.rows else 0, pacer)
               for vi, p in enumerate(plans)}
    return _encode_units_device(plans, units, chunk, writers, devices,
                                batch_units, stage_stats, parity)


class _PipelineIO:
    """Reader/writer scaffolding of the streaming encode: staging slots
    leased from the pool, backpressure queues, the reader thread (fills
    slots and writes data shards), the writer thread (writes parity
    shards) and the shutdown sequencing.  Two staging layouts:

      "bk"  (B, 10, L), the words route's input;
      "kb"  (10, B, L), the pooled route's: slicing [:k_max] off axis 0
            compacts trailing all-zero rows as one contiguous view, and
            each shard row of a unit stays contiguous.

    `ready` items carry the batch's compacted row count k_max ("bk"
    reports the full 10)."""

    def __init__(self, plans, units, chunk, writers, b, layout, pool,
                 n_slots, pinned, on_written):
        self.plans, self.units, self.chunk = plans, units, chunk
        self.writers, self.b = writers, b
        self.layout = layout
        self.pool = pool
        self.n_batches = (len(units) + b - 1) // b
        self.dats = [open(p.base + ".dat", "rb") for p in plans]
        self.timers = {"read": 0.0, "dispatch": 0.0, "encode_crc": 0.0,
                       "write": 0.0}
        self.tlock = threading.Lock()
        shape = (b, DATA_SHARDS, chunk) if layout == "bk" \
            else (DATA_SHARDS, b, chunk)
        self._slot_leases = [
            lease_tensor(pool, "ec-stage-" + layout, shape, torch.uint8,
                         pinned=pinned) for _ in range(n_slots)]
        self.free_slots: "queue.Queue" = queue.Queue()
        for ls in self._slot_leases:
            self.free_slots.put(ls)
        self.ready: "queue.Queue" = queue.Queue(maxsize=n_slots)
        self.parity_q: "queue.Queue" = queue.Queue(maxsize=n_slots)
        self.errors: list[BaseException] = []
        self.stop = threading.Event()
        self._rt = threading.Thread(target=self._reader, daemon=True)
        self._wt = threading.Thread(target=self._writer, daemon=True)
        self.on_written = on_written  # callback(item) once it is written

    def put(self, q, item) -> bool:
        while not self.stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def get(self, q):
        while not self.stop.is_set():
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                continue
        return None

    def _fill_row(self, u: _Unit, i: int, row: np.ndarray) -> int:
        """Read shard row i of the unit into `row`, zero-padding a short
        read; returns the count of real .dat bytes in the row."""
        dat = self.dats[u.vol]
        start = u.row_start + i * u.block_size + u.col
        dat.seek(start)
        got = dat.readinto(memoryview(row))
        if got < self.chunk:
            row[got:] = 0
        return min(self.chunk, self.plans[u.vol].dat_size - start)

    def _reader(self):
        try:
            kb = self.layout == "kb"
            for n in range(self.n_batches):
                batch = self.units[n * self.b:(n + 1) * self.b]
                slot = self.get(self.free_slots)
                if slot is None:
                    return
                buf = slot.payload.numpy()
                t0 = time.perf_counter()
                k_max = max(u.real_rows for u in batch) if kb \
                    else DATA_SHARDS
                for k, u in enumerate(batch):
                    w = self.writers[u.vol]
                    for i in range(u.real_rows):
                        row = buf[i, k] if kb else buf[k, i]
                        real = self._fill_row(u, i, row)
                        w.write(i, [row[:real]], u.shard_off)
                    # zero padding rows up to the compacted height feed
                    # the parity math but neither files (ftruncate zeros)
                    # nor writes
                    for i in range(u.real_rows, k_max):
                        (buf[i, k] if kb else buf[k, i]).fill(0)
                with self.tlock:
                    self.timers["read"] += time.perf_counter() - t0
                if not self.put(self.ready, (slot, batch, k_max)):
                    return
            self.put(self.ready, None)
        except BaseException as e:  # propagate to the main thread
            self.errors.append(e)
            self.stop.set()

    def _writer(self):
        try:
            while True:
                item = self.get(self.parity_q)
                if item is None:
                    return
                parity, batch = item[0], item[1]
                t0 = time.perf_counter()
                for k, u in enumerate(batch):
                    if u.real_rows == 0:
                        continue  # zero parity is already on disk
                    w = self.writers[u.vol]
                    for i in range(PARITY_SHARDS):
                        w.write(DATA_SHARDS + i, [parity[k, i]],
                                u.shard_off)
                with self.tlock:
                    self.timers["write"] += time.perf_counter() - t0
                self.on_written(item)
        except BaseException as e:
            self.errors.append(e)
            self.stop.set()

    def start(self):
        self._rt.start()
        self._wt.start()

    def finish(self):
        self.put(self.parity_q, None)
        self._wt.join(timeout=60)
        self.stop.set()
        self._rt.join(timeout=30)
        for f in self.dats:
            f.close()
        for w in self.writers.values():
            w.close()
        for ls in self._slot_leases:
            self.pool.release(ls)
        self._slot_leases = []

    def result(self) -> dict[str, list[int]]:
        if self.errors:
            raise self.errors[0]
        _stats.EcEncodeBytesCounter.inc(
            sum(p.dat_size for p in self.plans))
        return {p.base: self.writers[vi].crcs
                for vi, p in enumerate(self.plans)}


class _Batch:
    """One dispatched batch on its way to the completion thread."""
    __slots__ = ("slot", "units", "k", "out", "hout", "h2d", "done",
                 "t_event", "t_host")

    def __init__(self, slot, units, k):
        self.slot, self.units, self.k = slot, units, k
        self.out = self.hout = None
        self.h2d: list = []
        self.done: list = []
        self.t_event = None
        self.t_host = time.perf_counter()


def _encode_units_device(plans, units, chunk, writers, devices, batch_units,
                         stage_stats: Optional[dict] = None, parity=None
                         ) -> dict[str, list[int]]:
    wall0 = time.perf_counter()
    n_dev = len(devices)
    cuda = devices[0].type == "cuda"
    use_words = words_capable(devices, chunk)
    pooled = not use_words
    fused = pooled and _fused_crc_on(devices[0].type)
    host_crc = pooled and not fused
    if batch_units is None:
        batch_units = max(1, TARGET_BATCH_BYTES // (DATA_SHARDS * chunk))
    # one fixed shape for every batch of the call (a short tail batch
    # leaves stale columns that are never read back)
    b = min(batch_units, len(units))
    b = max(n_dev, -(-b // n_dev) * n_dev)
    parts = split_batch(b, n_dev)
    depth = _device_inflight()
    pool = get_pool()
    dev_label = str(devices[0]) if n_dev == 1 else f"sharded:{n_dev}"
    # a CPU device computes straight from the staging slot
    zero_copy = not cuda and n_dev == 1
    layout = "kb" if pooled else "bk"
    if pooled:
        pstep = make_parity_step(devices, matrix=parity, fused_crc=fused)
        backend = "device-pooled-fused-crc" if fused else "device-pooled"
    else:
        wstep = make_sharded_encoder(words=True, matrix=parity)
        backend = "device-words"

    n_slots = max(_SLOTS, depth + 1)
    free_hout: "queue.Queue" = queue.Queue()
    io = _PipelineIO(plans, units, chunk, writers, b, layout, pool, n_slots,
                     pinned=cuda, on_written=lambda it: free_hout.put(it[2]))
    timers = io.timers
    leases: list = []

    def lease(ls):
        leases.append(ls)
        return ls

    # device input ring (depth + 1 slabs per device) and output ring
    ring = depth + 1
    din_ring = [] if zero_copy else [
        [lease(lease_tensor(pool, "ec-din-" + layout,
                            (b, DATA_SHARDS, chunk) if not pooled else
                            (DATA_SHARDS, hi - lo, chunk), torch.uint8, dev))
         for dev, (lo, hi) in zip(devices, parts)] for _ in range(ring)]
    ring_done: list = [None] * ring
    out_q: "queue.Queue" = queue.Queue()
    for _ in range(ring):
        if pooled:
            slot = [lease(lease_tensor(pool, "ec-out",
                                       (PARITY_SHARDS, hi - lo, chunk),
                                       torch.uint8, dev))
                    for dev, (lo, hi) in zip(devices, parts)]
        else:
            dev = devices[0]
            slot = [lease(lease_tensor(pool, "ec-out-words",
                                       (b, PARITY_SHARDS, chunk),
                                       torch.uint8, dev)),
                    lease(lease_tensor(pool, "ec-crc-words",
                                       (b, TOTAL_SHARDS), torch.int64, dev)),
                    lease(lease_tensor(pool, "ec-k2-scratch",
                                       k2_scratch_shape(PARITY_SHARDS,
                                                        DATA_SHARDS, b,
                                                        chunk),
                                       torch.int32, dev))]
        out_q.put(slot)
    # pinned host outputs: depth in flight, one completing, one writing
    for _ in range(depth + 2):
        par_shape = (b, PARITY_SHARDS, chunk) if not pooled \
            else (PARITY_SHARDS, b, chunk)
        free_hout.put((
            lease(lease_tensor(pool, "ec-hout-" + layout, par_shape,
                               torch.uint8, pinned=cuda)),
            [lease(lease_tensor(pool, "ec-hcrc",
                                ((hi - lo) * TOTAL_SHARDS,), torch.int64,
                                pinned=cuda)) for lo, hi in parts]))

    copy_streams = [torch.cuda.Stream(d) for d in devices] if cuda else []
    computes = [torch.cuda.current_stream(d) for d in devices] \
        if cuda else []
    zcrc = crc_host.crc32c_zeros(chunk)
    done_q: "queue.Queue" = queue.Queue(maxsize=depth)
    k_shapes: set = set()
    lats: list = []
    n_disp = 0

    def _h2d(bt: _Batch, r: int):
        """Copy the slot's first k rows to the devices' input slabs (on
        the copy streams); returns the per-device input views."""
        stage = bt.slot.payload
        k = bt.k
        if zero_copy:
            return [stage[:k] if pooled else stage]
        dins = []
        for i, (dev, (lo, hi)) in enumerate(zip(devices, parts)):
            slab = din_ring[r][i].payload
            with (torch.cuda.stream(copy_streams[i]) if cuda
                  else contextlib.nullcontext()):
                if cuda:
                    if ring_done[r] is not None:  # ring slab still read
                        copy_streams[i].wait_event(ring_done[r][i])
                    if i == 0:
                        bt.t_event = torch.cuda.Event(enable_timing=True)
                        bt.t_event.record(copy_streams[0])
                if not pooled:
                    slab.copy_(stage, non_blocking=True)
                    dins.append(slab)
                elif n_dev == 1:
                    slab[:k].copy_(stage[:k], non_blocking=True)
                    dins.append(slab[:k])
                else:
                    for j in range(k):  # row j of (10, B, L) is contiguous
                        slab[j].copy_(stage[j, lo:hi], non_blocking=True)
                    dins.append(slab[:k])
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(copy_streams[i])
                    bt.h2d.append(ev)
        pool.note_h2d(stage[:k].numel() if pooled else stage.numel(),
                      device=dev_label)
        return dins

    def _launch(bt: _Batch, dins: list, r: int):
        """The step on the compute streams, then the D2H copies of parity
        and CRCs into the batch's pinned host buffers."""
        hpar, hcrcs = bt.hout[0].payload, [ls.payload for ls in bt.hout[1]]
        k = bt.k
        kdone = []
        for i, (dev, (lo, hi)) in enumerate(zip(devices, parts)):
            with (torch.cuda.stream(computes[i]) if cuda
                  else contextlib.nullcontext()):
                if cuda:
                    computes[i].wait_event(bt.h2d[i])
                if pooled:
                    out = bt.out[i].payload
                    crc = pstep(dins[i], out)
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(computes[i])
                        kdone.append(ev)
                    if n_dev == 1:
                        hpar.copy_(out, non_blocking=True)
                    else:
                        for j in range(PARITY_SHARDS):
                            hpar[j, lo:hi].copy_(out[j], non_blocking=True)
                    if crc is not None:
                        dst = hcrcs[i][:(hi - lo) * (k + PARITY_SHARDS)]
                        dst.view(hi - lo, k + PARITY_SHARDS).copy_(
                            crc.t(), non_blocking=True)
                else:
                    par, crc, partial = (ls.payload for ls in bt.out)
                    wstep(dins[i], out=par, crc=crc, partial=partial)
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(computes[i])
                        kdone.append(ev)
                    hpar.copy_(par, non_blocking=True)
                    hcrcs[i].view(b, TOTAL_SHARDS).copy_(crc,
                                                         non_blocking=True)
                if cuda:
                    ev = torch.cuda.Event(enable_timing=i == 0)
                    ev.record(computes[i])
                    bt.done.append(ev)
        if cuda:
            ring_done[r] = kdone

    def _complete(bt: _Batch):
        t0 = time.perf_counter()
        for ev in bt.h2d:
            _wait(ev)
        if not host_crc:
            io.free_slots.put(bt.slot)  # its copy to the device completed
        if bt.out is None:  # an all-padding batch: nothing ran
            crc_np = parity = None
        else:
            for ev in bt.done:
                _wait(ev)
            lat = (bt.t_event.elapsed_time(bt.done[0]) / 1e3 if cuda
                   else time.perf_counter() - bt.t_host)
            lats.append(lat)
            profiling.record_device_batch(lat, units=len(bt.units), k=bt.k,
                                          devices=n_dev)
            out_q.put(bt.out)  # the slot's D2H completed
            hpar = bt.hout[0].payload.numpy()
            pool.note_d2h(hpar.nbytes, device=dev_label)
            parity = hpar if not pooled else hpar.transpose(1, 0, 2)
            rows = TOTAL_SHARDS if not pooled else bt.k + PARITY_SHARDS
            crc_np = None
            if not host_crc:
                crc_np = np.concatenate(
                    [ls.payload[:(hi - lo) * rows].numpy().reshape(
                        hi - lo, rows)
                     for ls, (lo, hi) in zip(bt.hout[1], parts)])
        nb = len(bt.units)
        if crc_np is not None:
            # padding rows were zeroed in staging, so every row's device
            # CRC is its chunk's CRC; only the combines remain
            fin = finalize(crc_np[:nb], chunk)
            k_rows = DATA_SHARDS if not pooled else bt.k
            for k, u in enumerate(bt.units):
                w = writers[u.vol]
                for i in range(DATA_SHARDS):
                    c = int(fin[k, i]) if i < k_rows else zcrc
                    w.crcs[i] = crc_host.crc32c_combine(w.crcs[i], c, chunk)
                for j in range(PARITY_SHARDS):
                    c = int(fin[k, k_rows + j]) if u.real_rows or \
                        not pooled else zcrc
                    w.crcs[DATA_SHARDS + j] = crc_host.crc32c_combine(
                        w.crcs[DATA_SHARDS + j], c, chunk)
        elif host_crc:
            t_crc = time.perf_counter()
            buf = bt.slot.payload.numpy()
            for k, u in enumerate(bt.units):
                w = writers[u.vol]
                r = u.real_rows
                for i in range(DATA_SHARDS):
                    c = crc_host.crc32c(buf[i, k]) if i < r else zcrc
                    w.crcs[i] = crc_host.crc32c_combine(w.crcs[i], c, chunk)
                for j in range(PARITY_SHARDS):
                    c = crc_host.crc32c(parity[k, j]) if r else zcrc
                    w.crcs[DATA_SHARDS + j] = crc_host.crc32c_combine(
                        w.crcs[DATA_SHARDS + j], c, chunk)
            with io.tlock:
                timers["host_crc"] = timers.get("host_crc", 0.0) + \
                    time.perf_counter() - t_crc
            io.free_slots.put(bt.slot)
        else:  # fused, all padding: every chunk CRC is the zeros CRC
            for u in bt.units:
                w = writers[u.vol]
                for s in range(TOTAL_SHARDS):
                    w.crcs[s] = crc_host.crc32c_combine(w.crcs[s], zcrc,
                                                        chunk)
        with io.tlock:
            timers["encode_crc"] += time.perf_counter() - t0
        if parity is None:
            if bt.hout is not None:
                free_hout.put(bt.hout)
        else:
            io.put(io.parity_q, (parity[:nb], bt.units, bt.hout))

    def _completion():
        try:
            while True:
                bt = io.get(done_q)
                if bt is None:
                    return
                _complete(bt)
        except BaseException as e:
            io.errors.append(e)
            io.stop.set()

    ct = threading.Thread(target=_completion, daemon=True)
    io.start()
    ct.start()
    try:
        while not io.stop.is_set():
            item = io.get(io.ready)
            if item is None:
                break
            bt = _Batch(*item)
            # background lane: bulk encode yields to in-flight foreground
            # (degraded-read) decodes, a batch at a time
            lane_wait = _lanes.LANES.background_checkpoint()
            if lane_wait:
                with io.tlock:
                    timers["lane_wait"] = timers.get("lane_wait", 0.0) + \
                        lane_wait
            t0 = time.perf_counter()
            if bt.k > 0:
                if pooled:
                    k_shapes.add(bt.k)
                bt.out = io.get(out_q)  # backpressure at `depth`
                bt.hout = io.get(free_hout)
                if bt.out is None or bt.hout is None:
                    break
                r = n_disp % ring
                n_disp += 1
                _launch(bt, _h2d(bt, r), r)
            with io.tlock:
                timers["dispatch"] += time.perf_counter() - t0
            if not io.put(done_q, bt):
                break
        io.put(done_q, None)
        ct.join(timeout=600)
    except BaseException:
        io.stop.set()
        raise
    finally:
        if ct.is_alive():
            io.stop.set()
            ct.join(timeout=30)
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)
        io.finish()
        for ls in leases:
            pool.release(ls)
    result = io.result()
    wall = time.perf_counter() - wall0
    kernel_cost = {}
    if pooled:
        for k in sorted(k_shapes):
            geom = f"k{k}xb{b}xw{chunk}" + ("f" if fused else "")
            kernel_cost[geom] = step_cost_analysis(
                geom, k, b, chunk, PARITY_SHARDS, fused)
    if stage_stats is not None:
        stage_stats.update({k: round(v, 3) for k, v in timers.items()})
        stage_stats["wall"] = round(wall, 3)
        stage_stats["backend"] = backend
        stage_stats["batches"] = io.n_batches
        stage_stats["batch_units"] = b
        stage_stats["k_shapes"] = sorted(k_shapes)
        stage_stats["inflight"] = depth
        stage_stats["staging_slots"] = n_slots
        stage_stats["zero_copy_h2d"] = zero_copy
        stage_stats["devices"] = n_dev
        stage_stats["device_shard"] = dev_label
        stage_stats["crc_path"] = "host" if host_crc else "fused-device"
        for k in ("read", "dispatch", "encode_crc", "write"):
            stage_stats[f"{k}_frac"] = (
                round(timers[k] / wall, 3) if wall > 0 else 0.0)
        if lats:
            lats.sort()
            stage_stats["kernel"] = {
                "batches": len(lats),
                "dispatch_ready_p50_ms": round(lats[len(lats) // 2] * 1e3,
                                               3),
                "dispatch_ready_p95_ms": round(
                    lats[min(len(lats) - 1, int(len(lats) * 0.95))] * 1e3,
                    3),
                "dispatch_ready_max_ms": round(lats[-1] * 1e3, 3),
            }
        if kernel_cost:
            stage_stats["kernel_cost"] = kernel_cost
        stage_stats["pool"] = pool.snapshot()
    for k, v in timers.items():
        _stats.EcEncodeStageSeconds.labels(k).set(round(v, 3))
    return result


# -- the host route -----------------------------------------------------------

# A span batches consecutive equal-block rows into one contiguous .dat read
# (striped rows are adjacent on disk, so R rows = one preadv of R*10*block
# bytes, and each shard's R blocks land adjacently in its file = one
# pwritev).  ~30 MB spans amortize syscalls while the span is still warm
# in cache when the fused kernel walks it.
_HOST_SPAN_BYTES = 30 << 20    # target bytes of .dat per work item
_HOST_SPAN_MAX_BLOCK = 8 << 20  # rows above this get column-chunked
_HOST_COL_CHUNK = 4 << 20       # column width for large-block rows
_GROUP_MAX = 8                  # spans per coalesced writer group


@dataclass
class _HostWork:
    """One host-pipeline work item: a contiguous span of `rows` equal-size
    striped rows ((rows, 10, length) straight out of the .dat), or one
    column chunk of a large row (10 strided preads)."""
    vol: int
    kind: str        # "span" | "col"
    dat_off: int     # span: contiguous byte start; col: row start
    shard_off: int
    length: int      # per-shard width L of one row (span) / chunk (col)
    rows: int        # span: R; col: 1
    block_size: int  # col: the row's block size (pread stride)
    col: int = 0     # col: byte offset of the chunk within the block


def _host_work_items(plans) -> list[_HostWork]:
    items: list[_HostWork] = []
    for vi, plan in enumerate(plans):
        pending: Optional[_HostWork] = None
        for row_start, shard_off, block in plan.rows:
            if block <= _HOST_SPAN_MAX_BLOCK:
                # IOV_MAX caps a pwritev at 1024 iovecs (one per row)
                rmax = max(1, min(
                    _IOV_MAX, _HOST_SPAN_BYTES // (DATA_SHARDS * block)))
                if (pending is not None and pending.block_size == block
                        and pending.rows < rmax):
                    pending.rows += 1
                    continue
                if pending is not None:
                    items.append(pending)
                pending = _HostWork(vi, "span", row_start, shard_off,
                                    block, 1, block)
            else:
                if pending is not None:
                    items.append(pending)
                    pending = None
                for col in range(0, block, _HOST_COL_CHUNK):
                    width = min(_HOST_COL_CHUNK, block - col)
                    items.append(_HostWork(vi, "col", row_start,
                                           shard_off + col, width, 1,
                                           block, col))
        if pending is not None:
            items.append(pending)
    return items


def _preadv_full(fd: int, buf: np.ndarray, offset: int, want: int) -> int:
    """Read up to `want` bytes into buf from `offset`; returns the count
    (short only at EOF)."""
    got = 0
    while got < want:
        n = os.preadv(fd, [buf[got:want]], offset + got)
        if n == 0:
            break
        got += n
    return got


def _encode_units_host(plans, host_codec, stage_stats=None,
                       parity=None) -> dict[str, list[int]]:
    """The host encode route as a three-stage pipeline over work items
    (multi-row spans or column chunks):

      read    a reader thread fills staging slots with contiguous
              preadv()s of the .dat;
      encode  codec workers (WEED_EC_HOST_WORKERS, default one per usable
              core, at most 16) encode into pooled parity slots, each in
              one native parity + CRC call that releases the interpreter
              lock;
      write   a writer pool (WEED_EC_WRITERS) drains a bounded hand-off
              queue, coalescing adjacent spans into one pwritev per shard
              file and pacing writeback.

    With one worker everything runs inline in the calling thread (threads
    on one core only convoy on the interpreter lock).
    WEED_EC_WRITE_BEHIND=0 has the workers write synchronously.  Every
    form is byte- and CRC-identical.  stage_stats gets per-stage busy
    seconds and fractions (read / encode_crc / write / flush)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..ops import codec as codec_mod
    from ..storage.erasure_coding import to_ext

    enc = host_codec if hasattr(host_codec, "_apply") \
        else codec_mod.new_host_encoder(DATA_SHARDS, PARITY_SHARDS)
    parity_matrix = np.ascontiguousarray(np.asarray(
        enc.matrix[DATA_SHARDS:] if parity is None else parity,
        dtype=np.uint8))
    fused = hasattr(enc, "encode_rows")

    nworkers = int(os.environ.get("WEED_EC_HOST_WORKERS", "0") or 0)
    if nworkers <= 0:
        nworkers = max(1, min(16, available_cpu_count()))
    write_behind, nwriters, flush_bytes, drop_cache = _write_knobs()
    write_behind = write_behind and nworkers > 1
    if nwriters <= 0:
        nwriters = max(1, min(4, nworkers // 2))
    if not write_behind:
        nwriters = 0

    items = _host_work_items(plans)
    slot_bytes = max(i.rows * DATA_SHARDS * i.length for i in items)
    parity_bytes = max(i.rows * PARITY_SHARDS * i.length for i in items)
    # pooled parity slots (with write-behind a slot outlives its compute
    # call until the writer stage releases it)
    n_pslots = 1 if nworkers == 1 else nworkers + 2 * nwriters + 2
    parity_free: "queue.Queue[np.ndarray]" = queue.Queue()
    for _ in range(n_pslots):
        parity_free.put(np.empty(parity_bytes, dtype=np.uint8))

    stop = threading.Event()
    errors: list[BaseException] = []
    pacer = _WritebackPacer(flush_bytes, drop_cache)
    dat_fds = [os.open(p.base + ".dat", os.O_RDONLY) for p in plans]
    vols = {vi: _ShardFileSet(
                p.base, to_ext,
                (p.rows[-1][1] + p.rows[-1][2]) if p.rows else 0, pacer)
            for vi, p in enumerate(plans)}
    timers = {"read": 0.0, "encode_crc": 0.0, "write": 0.0, "flush": 0.0}
    tlock = threading.Lock()

    def read_item(w: _HostWork, flat: np.ndarray) -> np.ndarray:
        """Fill (and return) the item's (rows, 10, length) view of the
        flat slot buffer, zero-padding past the .dat's EOF."""
        dat_size = plans[w.vol].dat_size
        fd = dat_fds[w.vol]
        nbytes = w.rows * DATA_SHARDS * w.length
        view = flat[:nbytes].reshape(w.rows, DATA_SHARDS, w.length)
        if w.kind == "span":
            span = view.reshape(-1)
            got = _preadv_full(fd, span, w.dat_off,
                               min(nbytes, max(0, dat_size - w.dat_off)))
            if got < nbytes:
                span[got:] = 0
        else:
            row = view[0]
            for i in range(DATA_SHARDS):
                # shard i's chunk inside the large striped row
                start = w.dat_off + i * w.block_size + w.col
                got = _preadv_full(fd, row[i], start,
                                   min(w.length, max(0, dat_size - start)))
                if got < w.length:
                    row[i, got:] = 0
        return view

    def encode_item(w: _HostWork, data: np.ndarray):
        """Parity + CRC into a pooled parity slot, which travels with the
        item to the writer stage (write-behind) or is released right
        after the inline write."""
        t0 = time.perf_counter()
        while True:  # stop-aware: an error elsewhere must not wedge us
            try:
                pbuf = parity_free.get(timeout=0.5)
                break
            except queue.Empty:
                if stop.is_set():
                    raise RuntimeError("encode pipeline stopped")
        need = w.rows * PARITY_SHARDS * w.length
        parity = pbuf[:need].reshape(w.rows, PARITY_SHARDS, w.length)
        if fused:
            crcs = enc.encode_rows(parity_matrix, data, parity)
        else:
            crcs = [0] * TOTAL_SHARDS
            for r in range(w.rows):
                parity[r] = enc._apply(parity_matrix, data[r])
                for i in range(DATA_SHARDS):
                    crcs[i] = crc_host.crc32c(data[r, i], crcs[i])
                for i in range(PARITY_SHARDS):
                    crcs[DATA_SHARDS + i] = crc_host.crc32c(
                        parity[r, i], crcs[DATA_SHARDS + i])
        with tlock:
            timers["encode_crc"] += time.perf_counter() - t0
        return pbuf, parity, crcs

    def write_item(w: _HostWork, data: np.ndarray, parity: np.ndarray):
        t0 = time.perf_counter()
        v = vols[w.vol]
        for i in range(DATA_SHARDS):
            v.write(i, [data[r, i] for r in range(w.rows)], w.shard_off)
        for i in range(PARITY_SHARDS):
            v.write(DATA_SHARDS + i,
                    [parity[r, i] for r in range(w.rows)], w.shard_off)
        with tlock:
            timers["write"] += time.perf_counter() - t0

    def encode_write_item(w: _HostWork, data: np.ndarray) -> list[int]:
        """The two-stage form (WEED_EC_WRITE_BEHIND=0): the codec worker
        writes synchronously."""
        pbuf, parity, crcs = encode_item(w, data)
        write_item(w, data, parity)
        parity_free.put(pbuf)
        return crcs

    def combine(w: _HostWork, crcs: list[int]):
        v = vols[w.vol]
        for s in range(TOTAL_SHARDS):
            v.crcs[s] = crc_host.crc32c_combine(
                v.crcs[s], crcs[s], w.rows * w.length)

    def qput(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def qget(q):
        while not stop.is_set():
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                continue
        return None

    wall0 = time.perf_counter()
    try:
        if nworkers == 1:
            flat = np.empty(slot_bytes, dtype=np.uint8)
            for w in items:
                t0 = time.perf_counter()
                data = read_item(w, flat)
                timers["read"] += time.perf_counter() - t0
                pbuf, parity, crcs = encode_item(w, data)
                write_item(w, data, parity)
                parity_free.put(pbuf)
                combine(w, crcs)
        else:
            n_slots = max(_SLOTS, nworkers + 2 * nwriters + 2)
            free_slots: "queue.Queue[np.ndarray]" = queue.Queue()
            for _ in range(n_slots):
                free_slots.put(np.empty(slot_bytes, dtype=np.uint8))
            ready: "queue.Queue" = queue.Queue(maxsize=n_slots)
            write_q: "queue.Queue" = queue.Queue(maxsize=2 * nwriters + 2)

            def reader():
                try:
                    for w in items:
                        flat = qget(free_slots)
                        if flat is None:
                            return
                        t0 = time.perf_counter()
                        data = read_item(w, flat)
                        with tlock:
                            timers["read"] += time.perf_counter() - t0
                        if not qput(ready, (flat, data, w)):
                            return
                    qput(ready, None)
                except BaseException as e:
                    errors.append(e)
                    stop.set()

            def write_group(group):
                t0 = time.perf_counter()
                v = vols[group[0][0].vol]
                base_off = group[0][0].shard_off
                for s in range(TOTAL_SHARDS):
                    iovs = []
                    for (w, _flat, data, parity, _pbuf) in group:
                        src = data if s < DATA_SHARDS else parity
                        j = s if s < DATA_SHARDS else s - DATA_SHARDS
                        for r in range(w.rows):
                            iovs.append(src[r, j])
                    v.write(s, iovs, base_off)
                with tlock:
                    timers["write"] += time.perf_counter() - t0
                for (_w, flat, _data, _parity, pbuf) in group:
                    free_slots.put(flat)
                    parity_free.put(pbuf)

            def writer_loop():
                # items arrive in stripe order (the main loop combines and
                # enqueues in submission order), so a writer coalesces the
                # adjacent spans queued behind its current item
                carry = None
                try:
                    while True:
                        if carry is not None:
                            item, carry = carry, None
                        else:
                            item = qget(write_q)
                        if item is None:
                            return
                        group = [item]
                        rows = item[0].rows
                        while len(group) < _GROUP_MAX:
                            try:
                                nxt = write_q.get_nowait()
                            except queue.Empty:
                                break
                            if nxt is None:
                                write_q.put(None)  # a sibling's sentinel
                                break
                            lw, nw = group[-1][0], nxt[0]
                            if (nw.vol != lw.vol
                                    or nw.shard_off != lw.shard_off
                                    + lw.rows * lw.length
                                    or rows + nw.rows > _IOV_MAX):
                                carry = nxt
                                break
                            group.append(nxt)
                            rows += nw.rows
                        write_group(group)
                except BaseException as e:
                    errors.append(e)
                    stop.set()

            rt = threading.Thread(target=reader, daemon=True)
            rt.start()
            wthreads = [threading.Thread(target=writer_loop, daemon=True)
                        for _ in range(nwriters)]
            for wt in wthreads:
                wt.start()
            pool = ThreadPoolExecutor(max_workers=nworkers)
            # up to nworkers + 1 items in flight; combined in order (file
            # CRCs chain in stripe order, and in-order hand-off lets the
            # writers coalesce adjacent spans)
            pending: list = []
            try:
                done = False
                while not done and not stop.is_set():
                    try:
                        item = ready.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    if item is None:
                        done = True
                    else:
                        flat, data, w = item
                        fn = encode_item if write_behind else \
                            encode_write_item
                        pending.append(
                            (w, flat, data, pool.submit(fn, w, data)))
                    while pending and (len(pending) > nworkers or done):
                        w, flat, data, fut = pending.pop(0)
                        if write_behind:
                            pbuf, parity, crcs = fut.result()
                            combine(w, crcs)
                            if not qput(write_q,
                                        (w, flat, data, parity, pbuf)):
                                break
                        else:
                            combine(w, fut.result())
                            free_slots.put(flat)
                for _ in range(nwriters):
                    qput(write_q, None)
                for wt in wthreads:
                    wt.join(timeout=600)
                if errors:
                    raise errors[0]
            except BaseException:
                stop.set()
                if errors:  # the root cause, not a secondary unwind
                    raise errors[0] from None
                raise
            finally:
                stop.set()
                pool.shutdown(wait=True)
                rt.join(timeout=30)
                for wt in wthreads:
                    wt.join(timeout=5)
    finally:
        for fd in dat_fds:
            os.close(fd)
        for v in vols.values():
            v.close()

    wall = time.perf_counter() - wall0
    # the pacer flushes inside timed write sections: its time goes to the
    # flush stage, not twice
    timers["flush"] = pacer.flush_seconds
    timers["write"] = max(0.0, timers["write"] - pacer.flush_seconds)
    if stage_stats is not None:
        stage_stats.update({k: round(v, 3) for k, v in timers.items()})
        stage_stats["wall"] = round(wall, 3)
        stage_stats["backend"] = "host-pipeline"
        stage_stats["workers"] = nworkers
        stage_stats["writers"] = nwriters
        stage_stats["write_behind"] = write_behind
        stage_stats["fused"] = fused
        stage_stats["items"] = len(items)
        stage_stats["flushes"] = pacer.flushes
        for k in ("read", "encode_crc", "write", "flush"):
            stage_stats[f"{k}_frac"] = (
                round(timers[k] / wall, 3) if wall > 0 else 0.0)
    _stats.EcEncodeBytesCounter.inc(sum(p.dat_size for p in plans))
    for k, v in timers.items():
        _stats.EcEncodeStageSeconds.labels(k).set(round(v, 3))
    if pacer.flushes:
        _stats.EcWritebackFlushCounter.inc(pacer.flushes)
    # the stage timers aggregate busy seconds across worker threads, so
    # they become synthesised child spans of one encode root (recorded
    # before the root finishes: retention is decided at the root)
    root = tracing.start(
        "ec.encode_volumes",
        tags={"volumes": len(plans), "workers": nworkers,
              "writers": nwriters, "items": len(items)})
    root.backdate(wall)
    for k, v in timers.items():
        tracing.record_span(f"ec.encode.{k}", v, parent=root)
    root.finish(duration=wall)
    return {p.base: vols[vi].crcs for vi, p in enumerate(plans)}


# -- rebuild ------------------------------------------------------------------


def rebuild_matrix(present: list[int], missing: list[int],
                   data_shards: int = DATA_SHARDS,
                   total_shards: int = TOTAL_SHARDS):
    """(survivor_ids, M): M (len(missing) x data_shards) maps the chosen
    survivors straight to the missing shards, from the cached decode
    plans of ops.rs_numpy.decode_rows."""
    from ..ops.rs_numpy import decode_rows

    chosen = present[:data_shards]
    rows = decode_rows(data_shards, total_shards, chosen, tuple(missing))
    return chosen, np.array(rows, dtype=np.uint8, copy=True)


def rebuild_shards(base: str, batch_units: Optional[int] = None,
                   device=None) -> dict[int, int]:
    """Regenerate every missing .ecNN from survivors: survivor chunks
    batch into (B, 10, L) dispatches of K2 with the reconstruction matrix,
    which also returns the rebuilt rows' raw CRCs.  Returns {shard_id:
    crc32c of the rebuilt file}.  The staging slots, device input slabs
    and pinned host outputs are leased from the DevicePool, so a second
    rebuild of the same geometry re-leases them.

    A short final chunk is placed at the END of its zeroed staging row:
    its rebuilt row then carries the same leading zeros, which leave a raw
    CRC image unchanged, so the device CRC serves every chunk."""
    from ..storage.erasure_coding import to_ext

    dev = device_mod.resolve(device)
    present = [i for i in range(TOTAL_SHARDS)
               if os.path.exists(base + to_ext(i))]
    missing = [i for i in range(TOTAL_SHARDS) if i not in present]
    if not missing:
        return {}
    if len(present) < DATA_SHARDS:
        raise ValueError(
            f"too few shards to rebuild: {len(present)} < {DATA_SHARDS}")
    chosen, matrix = rebuild_matrix(present, missing)
    sizes = {os.path.getsize(base + to_ext(i)) for i in chosen}
    if len(sizes) != 1:
        raise ValueError(f"survivor shard sizes differ: {sorted(sizes)}")
    shard_size = sizes.pop()
    if shard_size == 0:
        for sid in missing:
            open(base + to_ext(sid), "wb").close()
        return {sid: 0 for sid in missing}

    chunk = min(MAX_CHUNK_BYTES, shard_size)
    offsets = list(range(0, shard_size, chunk))
    if batch_units is None:
        batch_units = max(1, TARGET_BATCH_BYTES // (DATA_SHARDS * chunk))
    b = min(batch_units, len(offsets))
    t = len(missing)
    cuda = dev.type == "cuda"
    step = make_sharded_apply(matrix)
    pool = get_pool()
    shape = (b, DATA_SHARDS, chunk)
    # two staging slots: a slot is refilled only after its batch drained;
    # on a card each has its own device input slab
    leases = [lease_tensor(pool, "rebuild-stage", shape, torch.uint8,
                           pinned=cuda) for _ in range(2)]
    if cuda:
        leases += [lease_tensor(pool, "rebuild-din", shape, torch.uint8,
                                dev) for _ in range(2)]
    free_out: "queue.Queue" = queue.Queue()
    for _ in range(4):
        pair = (lease_tensor(pool, "rebuild-hout", (b, t, chunk),
                             torch.uint8, pinned=cuda),
                lease_tensor(pool, "rebuild-hcrc", (b, t), torch.int64,
                             pinned=cuda))
        leases += pair
        free_out.put(pair)
    slots, dins = leases[:2], leases[2:4] if cuda else [None, None]

    inputs = [open(base + to_ext(i), "rb") for i in chosen]
    _, _, flush_bytes, drop_cache = _write_knobs()
    pacer = _WritebackPacer(flush_bytes, drop_cache)
    out_fds = {sid: os.open(base + to_ext(sid),
                            os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644)
               for sid in missing}
    for fd in out_fds.values():
        os.ftruncate(fd, shard_size)
    crcs = {sid: 0 for sid in missing}
    werrs: list[BaseException] = []
    wq: "queue.Queue" = queue.Queue(maxsize=2)

    def wb_writer():
        try:
            while True:
                item = wq.get()
                if item is None:
                    return
                batch_offs, out = item
                rebuilt = out[0].payload.numpy()
                for k, off in enumerate(batch_offs):
                    width = min(chunk, shard_size - off)
                    for j, sid in enumerate(missing):
                        fd = out_fds[sid]
                        _pwritev_full(fd, [rebuilt[k, j, chunk - width:]],
                                      off)
                        pacer.wrote(fd, off, width)
                free_out.put(out)
        except BaseException as e:
            werrs.append(e)

    def take_out():
        while True:
            if werrs:
                raise werrs[0]
            try:
                return free_out.get(timeout=0.5)
            except queue.Empty:
                continue

    def submit(slot, din, out, nb):
        """K2 over the slot's first nb units; the rebuilt rows and CRCs
        land in the pinned host pair `out`.  Returns the done event."""
        src = slot.payload[:nb]
        hrows, hcrc = out[0].payload[:nb], out[1].payload[:nb]
        if not cuda:
            o, c = step(src)
            hrows.copy_(o)
            hcrc.copy_(c)
            return None
        x = din.payload[:nb]
        x.copy_(src, non_blocking=True)
        pool.note_h2d(x.numel(), device=dev)
        o, c = step(x)
        hrows.copy_(o, non_blocking=True)
        hcrc.copy_(c, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return done

    wt = threading.Thread(target=wb_writer, daemon=True)
    wt.start()
    try:
        inflight: list = []

        def drain_one():
            batch_offs, out, done = inflight.pop(0)
            _wait(done)
            fin = out[1].payload.numpy()
            for k, off in enumerate(batch_offs):
                width = min(chunk, shard_size - off)
                fk = finalize(fin[k], width)
                for j, sid in enumerate(missing):
                    crcs[sid] = crc_host.crc32c_combine(
                        crcs[sid], int(fk[j]), width)
            while True:
                if werrs:
                    raise werrs[0]
                try:
                    wq.put((batch_offs, out), timeout=0.5)
                    return
                except queue.Full:
                    continue

        for step_i, start in enumerate(range(0, len(offsets), b)):
            if len(inflight) >= 2:
                drain_one()  # frees this step's staging slot
            slot = slots[step_i % 2]
            buf = slot.payload.numpy()
            batch_offs = offsets[start:start + b]
            for k, off in enumerate(batch_offs):
                width = min(chunk, shard_size - off)
                for i, f in enumerate(inputs):
                    if width < chunk:
                        buf[k, i, :chunk - width] = 0
                    f.seek(off)
                    got = f.readinto(memoryview(buf[k, i, chunk - width:]))
                    if got < width:
                        raise ValueError(
                            f"short read of survivor {chosen[i]} at {off}")
            out = take_out()
            done = submit(slot, dins[step_i % 2], out, len(batch_offs))
            inflight.append((batch_offs, out, done))
        while inflight:
            drain_one()
    finally:
        if cuda:
            torch.cuda.synchronize(dev)
        try:
            wq.put(None, timeout=5)
        except queue.Full:
            pass
        wt.join(timeout=120)
        for f in inputs:
            f.close()
        for fd in out_fds.values():
            os.close(fd)
        for ls in leases:
            pool.release(ls)
    if werrs:
        raise werrs[0]
    return crcs
