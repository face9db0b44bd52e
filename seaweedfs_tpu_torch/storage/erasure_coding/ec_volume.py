"""EC volume runtime: shard handles, sorted-index search, EC reads, deletes.

Parity with ec_volume.go / ec_shard.go / ec_volume_delete.go / store_ec.go:
  * .ecx binary search over 16-byte sorted entries (SearchNeedleFromSortedIndex,
    ec_volume.go:230-255)
  * read ladder per interval: local shard pread, else remote fetch (hook),
    else reconstruct the interval from >=10 other shards
    (readOneEcShardInterval/recoverOneRemoteEcShardInterval,
    store_ec.go:188-218,328-382)
  * delete = tombstone the size field inside .ecx in place + append the id to
    the .ecj journal (ec_volume_delete.go:13-50); RebuildEcxFile replays the
    journal (ec_volume_delete.go:53-98)

Degraded reads decode through `ops.codec.reconstruct_span` on the
volume's device (kernel K1 on the card); the survivor stack is assembled
where `ops.codec.survivor_stack` says, so a stack bound for the card
crosses the link from pinned memory.  Survivor fetches from other
servers go through the `remote_reader` hook, and an inline-EC volume
(inline.py) serves spans past its shard logs' durable extent through the
`tail_reader` hook.  A degraded read is an ``ec.recover.serve`` span
and each block's survivor fetch an ``ec.recover.fetch`` span under it;
each remote fetch carries the caller's deadline and QoS class.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import os
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from ... import device as device_mod
from ... import tracing
from ...ops import codec as codec_mod
from ...rpc.http_rpc import in_caller_context
from .. import idx as idx_mod
from .. import types as t
from ..needle import Needle, get_actual_size
from . import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, TOTAL_SHARDS_COUNT, to_ext
from .codes import get_family
from .encoder import load_volume_info
from .locate import Interval, locate_data
from .recover import (STATS as RECOVER_STATS, RecoveredBlockCache,
                      SpanDecodeBatcher, recover_knobs)

_recover_pool_lock = threading.Lock()
_recover_pool_inst = None

# one number per mounted EcVolume: the first part of its resident slab
# keys, so a volume mounted again never meets the uploads of an earlier
# mount of the same id
_mounts = itertools.count()


def _recover_pool():
    """Shared fan-out pool for degraded-read survivor fetches: built
    once, sized for a few concurrent recoveries, never rebuilt on the
    hot path of an outage."""
    global _recover_pool_inst
    with _recover_pool_lock:
        if _recover_pool_inst is None:
            _recover_pool_inst = cf.ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="ec-recover")
        return _recover_pool_inst


class EcError(Exception):
    pass


class EcNotFoundError(EcError):
    pass


class EcDeletedError(EcError):
    pass


class ShardBits:
    """uint32 bitmask of shard ids (ec_volume_info.go:65-117)."""

    def __init__(self, bits: int = 0):
        self.bits = bits & 0xFFFFFFFF

    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self.bits & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(TOTAL_SHARDS_COUNT) if self.has(i)]

    def count(self) -> int:
        return bin(self.bits).count("1")

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits & ~other.bits)

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits | other.bits)

    def __eq__(self, other):
        return isinstance(other, ShardBits) and self.bits == other.bits

    def __hash__(self):
        return hash(self.bits)

    def __repr__(self):
        return f"ShardBits({self.shard_ids()})"


def pread_into(fd: int, view, offset: int) -> int:
    """Fill the writable buffer `view` from `fd` at `offset` with preadv,
    again after a partial read, until it is full or the file ends;
    returns the bytes filled."""
    mv = memoryview(view).cast("B")
    done = 0
    while done < len(mv):
        n = os.preadv(fd, [mv[done:]], offset + done)
        if n == 0:
            break
        done += n
    return done


class EcVolumeShard:
    """One open .ecNN file (ec_shard.go:17-97)."""

    def __init__(self, directory: str, collection: str, vid: int,
                 shard_id: int):
        self.dir = directory
        self.collection = collection
        self.volume_id = vid
        self.shard_id = shard_id
        self._f = open(self.file_name(), "rb")
        self.ecd_file_size = os.path.getsize(self.file_name())

    def base_file_name(self) -> str:
        base = (f"{self.collection}_{self.volume_id}" if self.collection
                else str(self.volume_id))
        return os.path.join(self.dir, base)

    def file_name(self) -> str:
        return self.base_file_name() + to_ext(self.shard_id)

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._f.fileno(), size, offset)

    def read_into(self, view, offset: int) -> int:
        """Fill `view` from `offset`; returns the bytes filled (short at
        EOF)."""
        return pread_into(self._f.fileno(), view, offset)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def destroy(self):
        self.close()
        os.remove(self.file_name())


# Remote fetch hook: (shard_id, offset, size) -> bytes | None
ShardReader = Callable[[int, int, int], Optional[bytes]]


def search_sorted_index(fileno: int, n_entries: int,
                        needle_id: int) -> Optional[int]:
    """Binary search 16-byte sorted entries by pread; returns entry index
    (SearchNeedleFromSortedIndex, ec_volume.go:230-255)."""
    lo, hi = 0, n_entries
    while lo < hi:
        mid = (lo + hi) // 2
        buf = os.pread(fileno, t.NEEDLE_MAP_ENTRY_SIZE,
                       mid * t.NEEDLE_MAP_ENTRY_SIZE)
        key, _, _ = idx_mod.unpack_entry(buf)
        if key == needle_id:
            return mid
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    return None


class EcVolume:
    """A mounted EC volume: local shard subset + .ecx/.ecj handles.

    `device` is where degraded reads decode: the CUDA card unless the
    caller passes "cpu".  It is resolved at mount, so a mount without a
    card and without device="cpu" raises."""

    # inline EC volumes install a hook serving shard-log spans from the
    # in-memory tail stripe: (shard_id, offset, size) -> bytes | None.
    # Sealed volumes leave it None and the classic ladder applies.
    tail_reader: Optional[ShardReader] = None

    def __init__(self, directory: str, collection: str, vid: int,
                 version: int = 3,
                 large_block_size: int = LARGE_BLOCK_SIZE,
                 small_block_size: int = SMALL_BLOCK_SIZE, device=None):
        self.dir = directory
        self.collection = collection
        self.volume_id = vid
        self.version = version
        self.large_block_size = large_block_size
        self.small_block_size = small_block_size
        self.device = device_mod.resolve(device)
        self.shards: dict[int, EcVolumeShard] = {}
        self.remote_reader: Optional[ShardReader] = None
        self.shard_locations: dict[int, list[str]] = {}  # shard id -> addrs
        # code family rides in .vif metadata: volumes encoded before the
        # coding tier existed have no record and resolve to the RS default
        info = load_volume_info(self.base_file_name()) or {}
        self.family = get_family(info.get("code_family"))
        self._mount = next(_mounts)
        # degraded-read machinery: per-volume recovered-block LRU (keys
        # are shard offsets, which only mean anything within one volume)
        # + the same-survivor-set span-decode batcher
        self._recover_cache = RecoveredBlockCache()
        self._recover_batcher = SpanDecodeBatcher(self._decode_span)
        self._ecx_lock = threading.Lock()
        self._ecj_lock = threading.Lock()
        base = self.base_file_name()
        self._ecx = open(base + ".ecx", "r+b")
        self.ecx_file_size = os.path.getsize(base + ".ecx")
        self._ecj = open(base + ".ecj", "a+b")
        self.ecj_file_size = os.path.getsize(base + ".ecj")

    def base_file_name(self) -> str:
        base = (f"{self.collection}_{self.volume_id}" if self.collection
                else str(self.volume_id))
        return os.path.join(self.dir, base)

    # -- shard management ----------------------------------------------------
    def add_shard(self, shard: EcVolumeShard) -> bool:
        if shard.shard_id in self.shards:
            return False
        self.shards[shard.shard_id] = shard
        return True

    def delete_shard(self, shard_id: int) -> Optional[EcVolumeShard]:
        return self.shards.pop(shard_id, None)

    def shard_bits(self) -> ShardBits:
        bits = ShardBits()
        for sid in self.shards:
            bits = bits.add(sid)
        return bits

    @property
    def shard_size(self) -> int:
        if not self.shards:
            return 0
        return next(iter(self.shards.values())).ecd_file_size

    # -- sorted-index search -------------------------------------------------
    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """Binary search the sorted .ecx -> (offset, size); raises
        EcNotFoundError when absent."""
        entry_pos = self._search_ecx(needle_id)
        if entry_pos is None:
            raise EcNotFoundError(f"needle {needle_id:x} not found")
        _, offset, size = self._read_ecx_entry(entry_pos)
        return offset, size

    def _read_ecx_entry(self, pos: int) -> tuple[int, int, int]:
        buf = os.pread(self._ecx.fileno(), t.NEEDLE_MAP_ENTRY_SIZE,
                       pos * t.NEEDLE_MAP_ENTRY_SIZE)
        return idx_mod.unpack_entry(buf)

    def _search_ecx(self, needle_id: int) -> Optional[int]:
        return search_sorted_index(
            self._ecx.fileno(),
            self.ecx_file_size // t.NEEDLE_MAP_ENTRY_SIZE, needle_id)

    # -- needle read (store_ec.go ReadEcShardNeedle:125-163) ------------------
    def locate_needle(self, needle_id: int
                      ) -> tuple[int, int, list[Interval]]:
        offset, size = self.find_needle_from_ecx(needle_id)
        if t.size_is_deleted(size):
            raise EcDeletedError(f"needle {needle_id:x} deleted")
        intervals = locate_data(
            self.large_block_size, self.small_block_size,
            self.family.data_shards * self.shard_size,
            offset, get_actual_size(size, self.version),
            data_shards=self.family.data_shards)
        return offset, size, intervals

    def read_needle(self, needle_id: int,
                    cookie: Optional[int] = None) -> Needle:
        offset, size, intervals = self.locate_needle(needle_id)
        parts = [self._read_interval(iv) for iv in intervals]
        blob = b"".join(parts)
        n = Needle()
        n.read_bytes(blob, offset, size, self.version)
        if cookie is not None and n.cookie != cookie:
            raise EcError(f"cookie mismatch for needle {needle_id:x}")
        return n

    def _read_interval(self, iv: Interval) -> bytes:
        shard_id, inner_offset = iv.to_shard_id_and_offset(
            self.large_block_size, self.small_block_size,
            data_shards=self.family.data_shards)
        return self.read_shard_span(shard_id, inner_offset, iv.size)

    def read_shard_span(self, shard_id: int, offset: int, size: int) -> bytes:
        """Read ladder: local shard -> in-memory tail stripe (inline
        volumes) -> remote hook -> reconstruct."""
        shard = self.shards.get(shard_id)
        if shard is not None:
            data = shard.read_at(size, offset)
            if len(data) == size:
                return data
            if self.tail_reader is not None:
                # the span runs past the shard log's durable extent: the
                # remainder lives in the partially-filled tail stripe
                # (data still buffered, or parity not yet committed for
                # the current row)
                rest = self.tail_reader(shard_id, offset + len(data),
                                        size - len(data))
                if rest is None:
                    # the flusher committed the row between the pread
                    # and the tail lookup: the bytes are on disk now
                    data = shard.read_at(size, offset)
                    if len(data) == size:
                        return data
                else:
                    return data + rest
            raise EcError(
                f"short read shard {shard_id} at {offset}+{size}")
        if self.tail_reader is not None:
            data = self.tail_reader(shard_id, offset, size)
            if data is not None:
                return data
        if self.remote_reader is not None:
            try:
                data = self.remote_reader(shard_id, offset, size)
            except Exception:
                data = None  # unreachable holder: degrade, don't fail
            if data is not None and len(data) == size:
                return data
            # a truncated remote answer degrades to reconstruction too:
            # the holder is damaged, but >=10 survivors can still serve
        return self._recover_span(shard_id, offset, size)

    def recover_stats(self) -> dict:
        """This volume's recovered-block cache occupancy + the process'
        cumulative degraded-read stage stats."""
        out = RECOVER_STATS.snapshot()
        out["cache_blocks"] = len(self._recover_cache)
        out["cache_bytes"] = self._recover_cache.size_bytes
        return out

    # -- degraded reads -------------------------------------------------------
    def _recover_span(self, target_shard: int, offset: int,
                      size: int) -> bytes:
        """Serve a missing shard's span by reconstruction — the fast
        degraded-read path.  Recovery is block-aligned: the span's
        covering WEED_EC_RECOVER_BLOCK_KB blocks are recovered (not the
        exact span), cached in the bounded per-volume LRU, and served
        from cache for every later read that lands in them.  Concurrent
        misses on one block are single-flighted; misses on different
        blocks that picked the same survivors decode in one stacked GF
        mat-vec (recover.py).  With no local shard to size blocks
        against (shard_size unknown) the exact span becomes the unit —
        still coalesced and cached."""
        self._tls.busy = 0.0
        with tracing.span(
                "ec.recover.serve",
                tags={"shard": target_shard, "offset": offset,
                      "size": size}) as sp:
            cache_bytes, block, coalesce = recover_knobs()
            shard_size = self.shard_size
            # recovery units must be sub-shard-aligned so vector codes
            # (alpha > 1) see whole interleaved lane groups; the KB-sized
            # block knob is always a multiple of alpha already
            align = self.family.sub_shards
            if block <= 0 or shard_size <= 0:
                lo = (offset // align) * align
                end = -(-(offset + size) // align) * align
                spans = [(lo, end - lo)]
            else:
                lo = (offset // block) * block
                end = max(offset + size,
                          min(shard_size,
                              -(-(offset + size) // block) * block))
                end = -(-end // align) * align
                spans = [(s, min(block, end - s))
                         for s in range(lo, end, block)]
            parts = []
            for bstart, blen in spans:
                key = (target_shard, bstart, blen)
                parts.append(self._recover_cache.get_or_recover(
                    key, lambda bs=bstart, bl=blen: self._recover_block(
                        target_shard, bs, bl),
                    cache_bytes, coalesce))
            blob = parts[0] if len(parts) == 1 else b"".join(parts)
            out = blob[offset - spans[0][0]:offset - spans[0][0] + size]
            if len(out) != size:
                raise EcError(
                    f"recovered span short for shard {target_shard} at "
                    f"{offset}+{size}: got {len(out)}")
        # the span measured the whole degraded read; the serve stage is
        # that wall minus this thread's fetch+decode busy seconds
        RECOVER_STATS.add_stage(
            "serve", max(0.0, (sp.duration or 0.0) - self._tls.busy))
        return out

    # per-thread fetch+decode busy seconds inside the current span, so
    # the serve stage reports assembly/wait overhead, not a double count
    _tls = threading.local()

    def _recover_block(self, target_shard: int, offset: int,
                       size: int) -> bytes:
        """One block's survivor fan-out + decode (the single-flight
        leader's job): fetch >=10 survivor spans, then reconstruct ONLY
        the target row through the decode-plan cache and the span-decode
        batcher."""
        blk0 = time.perf_counter()
        try:
            with codec_mod.survivor_stack((self.family.data_shards, size),
                                          self.device) as slab:
                with tracing.span(
                        "ec.recover.fetch",
                        tags={"shard": target_shard, "bytes": size}) as fsp:
                    survivors, inputs, sealed = self._fetch_survivors(
                        target_shard, offset, size, out=slab)
                RECOVER_STATS.add_stage("fetch", fsp.duration or 0.0)
                out = self._recover_batcher.decode(
                    survivors, target_shard, inputs,
                    span=(offset, size) if sealed else None)
            return np.ascontiguousarray(out).tobytes()
        finally:
            self._tls.busy = (getattr(self._tls, "busy", 0.0)
                              + (time.perf_counter() - blk0))

    def _fetch_survivors(self, target_shard: int, offset: int,
                         size: int, out: Optional[np.ndarray] = None
                         ) -> tuple[tuple, np.ndarray, bool]:
        """Collect exactly data_shards survivor spans for one recovery
        (recoverOneRemoteEcShardInterval, store_ec.go:328-382).

        Local shards are read synchronously (disk, cheap, first-k-wins),
        then the remaining remote candidates are requested at once on a
        SHARED pool and the first arrivals win — a degraded read during
        an outage costs ~one RPC round-trip, not ten serial ones.  Queued
        stragglers are cancelled; in-flight ones drain on the shared pool
        (remote_reader calls carry their own timeouts).  Returns (sorted
        survivor ids, (k, L) stack in that order, sealed) — the
        decode-plan cache key and its matching input, stacked into `out`
        when given; `sealed` is False when the tail stripe or zero fill
        supplied part of the stack."""
        k = self.family.data_shards
        shards: dict[int, np.ndarray] = {}
        sealed = True
        remote_candidates: list[int] = []
        for sid in range(TOTAL_SHARDS_COUNT):
            if sid == target_shard:
                continue
            shard = self.shards.get(sid)
            if shard is not None:
                if len(shards) >= k:
                    continue  # reconstruct needs exactly k survivors
                data = shard.read_at(size, offset)
                if len(data) != size and self.tail_reader is not None:
                    # inline volume: the span runs past the shard log's
                    # durable extent.  The tail stripe serves pending
                    # rows; past that a DATA shard's content is zero by
                    # definition (parity rows are encoded over the
                    # zero-padded row), while a parity shard without tail
                    # coverage is not a survivor
                    rest = self.tail_reader(sid, offset + len(data),
                                            size - len(data))
                    if rest is None and sid < k:
                        rest = b"\x00" * (size - len(data))
                    if rest is not None:
                        data += rest
                        sealed = False
                if len(data) == size:
                    shards[sid] = np.frombuffer(data, dtype=np.uint8)
            elif self.remote_reader is not None:
                remote_candidates.append(sid)
        if len(shards) < k and remote_candidates:
            # survivor RPCs stay inside the budget the client handed us
            # and keep their class downstream
            fetch = in_caller_context(
                lambda sid: self.remote_reader(sid, offset, size))

            pool = _recover_pool()
            futs = {pool.submit(fetch, sid): sid
                    for sid in remote_candidates}
            try:
                for fut in cf.as_completed(futs):
                    try:
                        data = fut.result()
                    except Exception:
                        data = None  # unreachable holder: try the others
                    if data is not None and len(data) == size:
                        shards[futs[fut]] = np.frombuffer(data,
                                                          dtype=np.uint8)
                        if len(shards) >= k:
                            break
            finally:
                for fut in futs:
                    fut.cancel()
        if len(shards) < k:
            raise EcError(
                f"need {k} shards to recover shard "
                f"{target_shard}, only {len(shards)} available")
        survivors = tuple(sorted(shards))[:k]
        return survivors, np.stack([shards[sid] for sid in survivors],
                                   out=out), sealed

    def _decode_span(self, survivors: tuple, target: int,
                     inputs: np.ndarray, spans: tuple) -> np.ndarray:
        """The batcher's decode hook: one cached decode row applied to
        the (possibly multi-span) survivor stack on this volume's
        device.  `spans` holds each stacked request's (offset, size), or
        None for a span the tail stripe helped fill.

        The device route keeps the upload resident in the slab pool under
        this mount and these spans (the codec adds the survivor ids):
        another missing shard of the same row, or a block recovered
        again after the block LRU evicted it, reuses the copy on the
        card.  Position is identity because a mounted volume's shard
        files are never rewritten; only a tail-filled span can change,
        and a stack with one is not kept."""
        slab_key = None if None in spans else (self._mount, spans)
        return codec_mod.reconstruct_span(
            survivors, inputs, target,
            self.family.data_shards, TOTAL_SHARDS_COUNT,
            slab_key=slab_key, family=self.family, device=self.device)

    # -- delete (ec_volume_delete.go) -----------------------------------------
    def delete_needle(self, needle_id: int):
        """Tombstone the .ecx entry in place + journal the id in .ecj."""
        with self._ecx_lock:
            pos = self._search_ecx(needle_id)
            if pos is None:
                return
            self._mark_ecx_deleted(pos)
        with self._ecj_lock:
            self._ecj.seek(0, 2)
            self._ecj.write(struct.pack(">Q", needle_id))
            self._ecj.flush()
            self.ecj_file_size += t.NEEDLE_ID_SIZE

    def _mark_ecx_deleted(self, pos: int):
        size_off = (pos * t.NEEDLE_MAP_ENTRY_SIZE
                    + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE)
        os.pwrite(self._ecx.fileno(),
                  struct.pack(">i", t.TOMBSTONE_FILE_SIZE), size_off)

    # -- lifecycle ------------------------------------------------------------
    def close(self):
        for shard in self.shards.values():
            shard.close()
        self.shards.clear()
        self._recover_cache.clear()
        if self._ecx:
            self._ecx.close()
            self._ecx = None
        if self._ecj:
            self._ecj.close()
            self._ecj = None

    def destroy(self):
        base = self.base_file_name()
        for shard in list(self.shards.values()):
            shard.destroy()
        self.shards.clear()
        self.close()
        for ext in (".ecx", ".ecj", ".vif"):
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass


def rebuild_ecx_file(base_file_name: str):
    """Replay .ecj tombstones into .ecx then remove the journal
    (RebuildEcxFile, ec_volume_delete.go:53-98)."""
    if not os.path.exists(base_file_name + ".ecj"):
        return
    with open(base_file_name + ".ecx", "r+b") as ecx:
        ecx_size = os.path.getsize(base_file_name + ".ecx")
        n_entries = ecx_size // t.NEEDLE_MAP_ENTRY_SIZE

        with open(base_file_name + ".ecj", "rb") as ecj:
            while True:
                buf = ecj.read(t.NEEDLE_ID_SIZE)
                if len(buf) != t.NEEDLE_ID_SIZE:
                    break
                pos = search_sorted_index(
                    ecx.fileno(), n_entries, struct.unpack(">Q", buf)[0])
                if pos is not None:
                    size_off = (pos * t.NEEDLE_MAP_ENTRY_SIZE
                                + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE)
                    os.pwrite(ecx.fileno(),
                              struct.pack(">i", t.TOMBSTONE_FILE_SIZE),
                              size_off)
    os.remove(base_file_name + ".ecj")
