"""Streaming batched EC encode and rebuild on one device, through K2.

Counterpart of the device route of seaweedfs_tpu/parallel/batched_encode.py.
The striped rows of many volumes are tiled into (B, 10, L) uint8 batches
and pushed through the fused parity + CRC32C kernel (rs_cuda.
fused_apply_crc) with a pipeline:

  reader thread     fills pinned staging slots from the .dat files through
                    their numpy views, and writes the data-shard bytes to
                    .ec00-.ec09 (data shards are a re-interleaving of the
                    .dat; all-zero padding rows are skipped, the files are
                    ftruncate()d to final size);
  main thread       copies a slot to the card on a copy stream, launches K2
                    on the compute stream once the copy landed, and queues
                    the D2H copies of parity and raw CRCs into pinned host
                    buffers, with up to WEED_EC_DEVICE_INFLIGHT batches in
                    flight;
  completion thread returns a slot to the free list once the event after
                    its copy completed, waits for the batch, finalizes the
                    per-chunk CRCs and chains them into per-shard-file
                    CRC32Cs, and hands parity to
  writer thread     which writes .ec10-.ec13.

On a CPU device (the tests) the same pipeline runs K2's plain version in
place of the copies and the kernel.  The host route, the pooled compacted-k
path, the multi-device mesh, the device pool and the QoS lanes wait for a
later slice.
"""

from __future__ import annotations

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
from ..ops import crc32c as crc_host
from ..ops.crc_device import finalize
from .mesh import make_sharded_apply, make_sharded_encoder

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


def _write_knobs() -> tuple[int, int]:
    """The writeback knobs of the device route, read per call (the host
    route's WEED_EC_WRITE_BEHIND and WEED_EC_WRITERS are not ported):

      WEED_EC_WRITE_FLUSH_MB   writeback pacing window in MiB (0 disables
                               pacing; default 32)
      WEED_EC_WRITE_DROP_CACHE 1 = drop synced windows from the page cache

    Returns (flush_bytes, drop_cache)."""
    mb = os.environ.get("WEED_EC_WRITE_FLUSH_MB", "")
    flush_bytes = int(float(mb) * (1 << 20)) if mb else (32 << 20)
    drop = os.environ.get("WEED_EC_WRITE_DROP_CACHE", "0").lower() \
        not in ("", "0", "false", "no")
    return flush_bytes, drop


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


# -- device plumbing -------------------------------------------------------------


def _host_buffer(shape, dtype, dev: torch.device) -> torch.Tensor:
    """A host tensor, pinned when the device is a card (so copies to and
    from it can run asynchronously)."""
    return torch.zeros(shape, dtype=dtype, pin_memory=dev.type == "cuda")


class _DeviceStage:
    """Runs `step` on host batches: on a card, the H2D copy runs on a copy
    stream into a ring of device input buffers, the kernel and the D2H
    copies into pinned host buffers on the compute stream; `submit` returns
    the events after the copy and after the D2H.  On the CPU the step runs
    in place and both events are None."""

    def __init__(self, dev: torch.device, step, shape, depth: int):
        self.dev = dev
        self.step = step
        self.cuda = dev.type == "cuda"
        self.n = 0
        if self.cuda:
            ring = depth + 1
            self.din = [torch.empty(shape, dtype=torch.uint8, device=dev)
                        for _ in range(ring)]
            self.kernel_done: list = [None] * ring
            self.copy_stream = torch.cuda.Stream(dev)
            self.compute = torch.cuda.current_stream(dev)

    def submit(self, src: torch.Tensor, out: torch.Tensor,
               crc: torch.Tensor):
        """src (nb, d, L) host batch -> out (nb, t, L), crc (nb, r) host."""
        nb = src.shape[0]
        if not self.cuda:
            o, c = self.step(src)
            out[:nb].copy_(o)
            crc[:nb].copy_(c)
            return None, None
        r = self.n % len(self.din)
        self.n += 1
        din = self.din[r][:nb]
        with torch.cuda.stream(self.copy_stream):
            if self.kernel_done[r] is not None:  # ring slot still read
                self.copy_stream.wait_event(self.kernel_done[r])
            din.copy_(src, non_blocking=True)
            h2d = torch.cuda.Event()
            h2d.record(self.copy_stream)
        with torch.cuda.stream(self.compute):
            self.compute.wait_event(h2d)
            o, c = self.step(din)
            self.kernel_done[r] = torch.cuda.Event()
            self.kernel_done[r].record(self.compute)
            out[:nb].copy_(o, non_blocking=True)
            crc[:nb].copy_(c, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.compute)
        return h2d, done

    def close(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)


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


# -- encode -------------------------------------------------------------------------


def encode_volumes(bases: list[str], large_block: Optional[int] = None,
                   small_block: Optional[int] = None,
                   batch_units: Optional[int] = None,
                   stage_stats: Optional[dict] = None,
                   device=None) -> dict[str, list[int]]:
    """Encode every `base` (.dat) into 14 shard files through the device
    pipeline.  Returns {base: [crc32c of each shard file] * 14}.  Chunks
    of all volumes share the device dispatches.

    stage_stats: filled with per-stage busy seconds (read, dispatch,
    encode_crc, write), their fractions of wall time, and the route."""
    from ..storage.erasure_coding import (LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                                          to_ext)

    dev = device_mod.resolve(device)
    large_block = large_block or LARGE_BLOCK_SIZE
    small_block = small_block or SMALL_BLOCK_SIZE
    plans = [_plan_volume(b, large_block, small_block) for b in bases]
    chunk = _chunk_len(large_block, small_block)
    units = _make_units(plans, chunk)
    if not units:
        for p in plans:
            _ShardFileSet(p.base, to_ext).close()
        return {p.base: [0] * TOTAL_SHARDS for p in plans}
    pacer = _WritebackPacer(*_write_knobs())
    writers = {vi: _ShardFileSet(
                   p.base, to_ext,
                   (p.rows[-1][1] + p.rows[-1][2]) if p.rows else 0, pacer)
               for vi, p in enumerate(plans)}
    return _encode_units_device(plans, units, chunk, writers, dev,
                                batch_units, stage_stats)


class _PipelineIO:
    """Reader/writer scaffolding of the streaming encode: staging slots
    (B, 10, L) with backpressure queues, the reader thread (fills slots
    and writes data shards), the writer thread (writes parity shards) and
    the shutdown sequencing."""

    def __init__(self, plans, units, chunk, writers, b, dev, n_slots,
                 on_written):
        self.plans, self.units, self.chunk = plans, units, chunk
        self.writers, self.b = writers, b
        self.n_batches = (len(units) + b - 1) // b
        self.dats = [open(p.base + ".dat", "rb") for p in plans]
        self.timers = {"read": 0.0, "dispatch": 0.0, "encode_crc": 0.0,
                       "write": 0.0}
        self.tlock = threading.Lock()
        self.free_slots: "queue.Queue" = queue.Queue()
        for _ in range(n_slots):
            self.free_slots.put(
                _host_buffer((b, DATA_SHARDS, chunk), torch.uint8, dev))
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
            for n in range(self.n_batches):
                batch = self.units[n * self.b:(n + 1) * self.b]
                slot = self.get(self.free_slots)
                if slot is None:
                    return
                buf = slot.numpy()
                t0 = time.perf_counter()
                for k, u in enumerate(batch):
                    w = self.writers[u.vol]
                    for i in range(u.real_rows):
                        real = self._fill_row(u, i, buf[k, i])
                        w.write(i, [buf[k, i, :real]], u.shard_off)
                    # zero padding rows feed the parity math but neither
                    # files (ftruncate zeros) nor writes
                    buf[k, u.real_rows:].fill(0)
                with self.tlock:
                    self.timers["read"] += time.perf_counter() - t0
                if not self.put(self.ready, (slot, batch)):
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

    def result(self) -> dict[str, list[int]]:
        if self.errors:
            raise self.errors[0]
        return {p.base: self.writers[vi].crcs
                for vi, p in enumerate(self.plans)}


def _encode_units_device(plans, units, chunk, writers, dev, batch_units,
                         stage_stats: Optional[dict] = None
                         ) -> dict[str, list[int]]:
    wall0 = time.perf_counter()
    if batch_units is None:
        batch_units = max(1, TARGET_BATCH_BYTES // (DATA_SHARDS * chunk))
    b = min(batch_units, len(units))
    depth = _device_inflight()
    n_slots = max(_SLOTS, depth + 1)
    # pinned (parity, raw crc) pairs: depth in flight, one completing, one
    # being written
    free_out: "queue.Queue" = queue.Queue()
    for _ in range(depth + 2):
        free_out.put((_host_buffer((b, PARITY_SHARDS, chunk), torch.uint8,
                                   dev),
                      _host_buffer((b, TOTAL_SHARDS), torch.int64, dev)))
    io = _PipelineIO(plans, units, chunk, writers, b, dev, n_slots,
                     on_written=lambda item: free_out.put(item[2]))
    timers = io.timers
    stage = _DeviceStage(dev, make_sharded_encoder(),
                         (b, DATA_SHARDS, chunk), depth)
    done_q: "queue.Queue" = queue.Queue(maxsize=depth)
    lats: list = []

    def _complete(slot, batch, out, h2d, done, t_disp):
        t0 = time.perf_counter()
        _wait(h2d)
        io.free_slots.put(slot)  # its copy to the card has completed
        _wait(done)
        lats.append(time.perf_counter() - t_disp)
        nb = len(batch)
        parity, crc = out
        # padding rows were zeroed in staging, so every row's device CRC
        # is its chunk's CRC; only the O(1)-per-chunk combines remain
        fin = finalize(crc[:nb].numpy(), chunk)  # (nb, 14)
        for k, u in enumerate(batch):
            w = writers[u.vol]
            for s in range(TOTAL_SHARDS):
                w.crcs[s] = crc_host.crc32c_combine(w.crcs[s],
                                                    int(fin[k, s]), chunk)
        with io.tlock:
            timers["encode_crc"] += time.perf_counter() - t0
        io.put(io.parity_q, (parity.numpy()[:nb], batch, out))

    def _completion():
        try:
            while True:
                item = io.get(done_q)
                if item is None:
                    return
                _complete(*item)
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
            slot, batch = item
            out = io.get(free_out)
            if out is None:
                break
            t0 = time.perf_counter()
            h2d, done = stage.submit(slot[:len(batch)], *out)
            with io.tlock:
                timers["dispatch"] += time.perf_counter() - t0
            if not io.put(done_q, (slot, batch, out, h2d, done, t0)):
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
        stage.close()
        io.finish()
    result = io.result()
    wall = time.perf_counter() - wall0
    if stage_stats is not None:
        stage_stats.update({k: round(v, 3) for k, v in timers.items()})
        stage_stats["wall"] = round(wall, 3)
        stage_stats["backend"] = f"{dev.type}-fused-apply-crc"
        stage_stats["crc_path"] = "fused-device"
        stage_stats["batches"] = io.n_batches
        stage_stats["batch_units"] = b
        stage_stats["inflight"] = depth
        stage_stats["staging_slots"] = n_slots
        stage_stats["device"] = str(dev)
        for k in ("read", "dispatch", "encode_crc", "write"):
            stage_stats[f"{k}_frac"] = (
                round(timers[k] / wall, 3) if wall > 0 else 0.0)
        if lats:
            lats.sort()
            stage_stats["kernel"] = {
                "batches": len(lats),
                "dispatch_ready_p50_ms": round(lats[len(lats) // 2] * 1e3,
                                               3),
                "dispatch_ready_max_ms": round(lats[-1] * 1e3, 3),
            }
    return result


# -- rebuild ------------------------------------------------------------------------


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
    crc32c of the rebuilt file}.

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
    stage = _DeviceStage(dev, make_sharded_apply(matrix),
                         (b, DATA_SHARDS, chunk), 2)
    # two staging slots: a slot is refilled only after its batch drained
    slots = [_host_buffer((b, DATA_SHARDS, chunk), torch.uint8, dev)
             for _ in range(2)]
    free_out: "queue.Queue" = queue.Queue()
    for _ in range(4):
        free_out.put((_host_buffer((b, t, chunk), torch.uint8, dev),
                      _host_buffer((b, t), torch.int64, dev)))

    inputs = [open(base + to_ext(i), "rb") for i in chosen]
    pacer = _WritebackPacer(*_write_knobs())
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
                rebuilt = out[0].numpy()
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

    wt = threading.Thread(target=wb_writer, daemon=True)
    wt.start()
    try:
        inflight: list = []

        def drain_one():
            batch_offs, out, done = inflight.pop(0)
            _wait(done)
            fin = out[1].numpy()
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
            slot = slots[step_i % 2]
            buf = slot.numpy()
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
            _, done = stage.submit(slot[:len(batch_offs)], *out)
            inflight.append((batch_offs, out, done))
            if len(inflight) >= 2:
                drain_one()
        while inflight:
            drain_one()
    finally:
        stage.close()
        try:
            wq.put(None, timeout=5)
        except queue.Full:
            pass
        wt.join(timeout=120)
        for f in inputs:
            f.close()
        for fd in out_fds.values():
            os.close(fd)
    if werrs:
        raise werrs[0]
    return crcs
