"""Volume: one append-only .dat + .idx pair with an in-RAM needle index.

Semantics parity with the reference's weed/storage/volume*.go:
  * write: dedup identical re-writes (volume_write.go isFileUnchanged:34-53),
    cookie check against existing needle (doWriteRequest:143-160), append-only
    with monotonic needle-map updates
  * delete: append a zero-data tombstone needle, record TombstoneFileSize in
    the index (doDeleteRequest:211-231)
  * read: index lookup -> one pread -> CRC verify (volume_read.go:19-60)
  * load: superblock read + index/dat integrity check that truncates a
    corrupt tail (volume_checking.go:17-60)
  * vacuum: Compact2 copy-live-by-index into .cpd/.cpx with bumped compaction
    revision, then CommitCompact with makeupDiff replaying writes that raced
    the copy (volume_vacuum.go:67,102,190)
  * zero-copy reads: read_needle_slice hands the payload's .dat range and a
    dup'd fd to the HTTP layer's sendfile

The "memory" map kind becomes the native engine's map when its library
builds (storage/native_engine.py; SW_NATIVE=0 keeps the Python maps), and
read_only and the append/modify timestamps then merge the engine's view:
its TCP fast path writes volumes without entering Python.  A volume whose
.vif records remote tier files is served read-only from that tier
(storage/tier.py) when its local .dat is gone.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
from typing import Optional

from .. import tracing
from ..stats import metrics as _stats
from . import idx as idx_mod
from . import native_engine
from . import types as t
from .backend import DiskFile
from .needle import (CURRENT_VERSION, FLAG_HAS_TTL, Needle, NeedleError,
                     get_actual_size, read_needle_header)
from .needle_map import BaseNeedleMap, new_needle_map
from .super_block import ReplicaPlacement, SuperBlock
from .ttl import EMPTY_TTL, TTL
from .volume_info import load_volume_info


class VolumeError(Exception):
    pass


class NotFoundError(VolumeError):
    pass


class DeletedError(VolumeError):
    pass


class CookieMismatchError(VolumeError):
    pass


class _FsyncBatcher:
    """Group-commit fsync worker (volume_write.go:233-306 semantics):
    writers append under the volume lock, then park here until one fsync
    covers their append — N concurrent writers share a single fsync
    instead of paying one each."""

    def __init__(self, sync_fn):
        self._sync_fn = sync_fn
        self._cond = threading.Condition()
        self._pending = 0
        self._synced = 0
        self._failed_upto = 0
        self._error: Optional[Exception] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def wait_durable(self):
        with self._cond:
            self._pending += 1
            ticket = self._pending
            self._cond.notify_all()
            while (self._synced < ticket and self._failed_upto < ticket
                   and not self._closed):
                self._cond.wait(1.0)
            if self._synced < ticket and self._failed_upto >= ticket:
                # the group commit covering this write failed: surface it
                # to the writer instead of acknowledging a lost write
                raise VolumeError(f"fsync failed: {self._error}")

    def _run(self):
        while True:
            with self._cond:
                while self._pending <= max(self._synced,
                                           self._failed_upto) \
                        and not self._closed:
                    self._cond.wait(0.5)
                if self._closed:
                    return
                target = self._pending
            try:
                self._sync_fn()  # outside the condition: appends continue
            except Exception as e:
                # a dead worker must never strand waiters: fail only the
                # tickets this batch covered and keep serving later ones
                # (the next sync may succeed, e.g. after ENOSPC clears)
                with self._cond:
                    self._error = e
                    self._failed_upto = target
                    self._cond.notify_all()
                continue
            with self._cond:
                self._synced = target
                self._cond.notify_all()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5)


class Volume:
    def __init__(self, directory: str, collection: str, vid: int,
                 replica_placement: Optional[ReplicaPlacement] = None,
                 ttl: TTL = EMPTY_TTL, needle_map_kind: str = "memory",
                 fsync: bool = False):
        self.dir = directory
        self.collection = collection
        self.id = vid
        self.needle_map_kind = needle_map_kind
        self.fsync = fsync
        self._batcher: Optional[_FsyncBatcher] = None
        self.lock = threading.RLock()
        self.data: Optional[DiskFile] = None
        self.nm: Optional[BaseNeedleMap] = None
        self._last_append_at_ns = 0
        self._last_modified_ts = 0
        self._read_only = False
        self.is_compacting = False
        self.last_compact_index_offset = 0
        self.last_compact_revision = 0
        self._load(replica_placement or ReplicaPlacement(), ttl)

    # -- naming --------------------------------------------------------------
    def file_name(self, ext: str = "") -> str:
        base = (f"{self.collection}_{self.id}" if self.collection
                else str(self.id))
        return os.path.join(self.dir, base + ext)

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def ttl(self) -> TTL:
        return self.super_block.ttl

    # -- native-engine coupling ----------------------------------------------
    # read_only and the append/modify timestamps are mirrored with the
    # native engine: its TCP fast path writes volumes without entering
    # Python, so these views merge both sides.

    @property
    def read_only(self) -> bool:
        return self._read_only

    @read_only.setter
    def read_only(self, value: bool):
        self._read_only = value
        nm = getattr(self, "nm", None)
        if isinstance(nm, native_engine.NativeNeedleMap):
            nm.set_flags(read_only=value)

    @property
    def last_append_at_ns(self) -> int:
        nm = getattr(self, "nm", None)
        if isinstance(nm, native_engine.NativeNeedleMap):
            return max(self._last_append_at_ns, nm.last_append_ns())
        return self._last_append_at_ns

    @last_append_at_ns.setter
    def last_append_at_ns(self, value: int):
        self._last_append_at_ns = value

    @property
    def last_modified_ts(self) -> int:
        nm = getattr(self, "nm", None)
        if isinstance(nm, native_engine.NativeNeedleMap):
            return max(self._last_modified_ts, nm.last_modified())
        return self._last_modified_ts

    @last_modified_ts.setter
    def last_modified_ts(self, value: int):
        self._last_modified_ts = value

    def _append_blob(self, blob: bytes) -> int:
        """Append one record to the .dat.  In native mode the engine's
        per-volume mutex serializes this with TCP fast-path writes."""
        if isinstance(self.nm, native_engine.NativeNeedleMap):
            return self.nm.append_dat(blob)
        return self.data.append(blob)

    def _native_writable(self) -> bool:
        """Whether the native fast path may write this volume directly.
        Replicated and TTL volumes qualify too: the engine fans writes
        out to the vid's published replica set (svn_set_replicas; 307
        when unconfigured) and stamps lastModified for the TTL read
        check, so neither bypasses production semantics."""
        return self.version == CURRENT_VERSION

    # -- load/create ---------------------------------------------------------
    def _load(self, replica_placement: ReplicaPlacement, ttl: TTL):
        dat = self.file_name(".dat")
        exists = os.path.exists(dat)
        tiered = None
        # a .vif recording remote tier files means the volume was tiered
        # (volume.tier.upload).  The remote is authoritative and the
        # volume is readonly: a kept local .dat (keep_local=True) is only
        # a read cache, never a write target, so the two can't diverge
        # across restarts.
        vif = load_volume_info(self.file_name(".vif"))
        if vif is not None and vif.files:
            self.read_only = True
            if not exists:
                from .tier import open_tiered_dat

                tiered = open_tiered_dat(vif)
        if tiered is not None:
            self.data = tiered
            self.super_block = SuperBlock.from_file(
                io.BytesIO(self.data.read_at(1024, 0)))
        elif not exists:
            self.data = DiskFile(dat, create=True)
            self.super_block = SuperBlock(
                version=CURRENT_VERSION,
                replica_placement=replica_placement, ttl=ttl)
            self.data.write_at(self.super_block.to_bytes(), 0)
        else:
            self.data = DiskFile(dat)
            with open(dat, "rb") as f:
                self.super_block = SuperBlock.from_file(f)
        idx_path = self.file_name(".idx")
        if exists or tiered is not None:
            self.last_append_at_ns = self._check_integrity(idx_path)
        if exists:
            # seed quiescence tracking from the .dat mtime so -quietFor
            # gates survive a restart (volume_loading.go:63 semantics)
            self.last_modified_ts = int(os.path.getmtime(dat))
        self.nm = self._new_needle_map(dat, idx_path, tiered)

    def _new_needle_map(self, dat: str, idx_path: str, tiered):
        """Pick the index implementation.  The in-memory kinds upgrade to
        the native engine's shared map when the library is available (one
        index serves both the Python handlers and the native TCP fast
        path); sqlite and tiered volumes keep their Python maps."""
        want_native = (self.needle_map_kind in ("memory", "native")
                       and tiered is None
                       and native_engine.available()
                       and isinstance(self.data, DiskFile))
        if want_native:
            try:
                return native_engine.NativeNeedleMap(
                    dat, idx_path, self.version, self._native_writable(),
                    self.read_only, self.fsync,
                    ttl_sec=self.ttl.minutes() * 60 if self.ttl else 0,
                    extra_copies=(
                        self.super_block.replica_placement.copy_count()
                        - 1),
                    ttl_raw=self.ttl.to_uint32() if self.ttl else 0)
            except (OSError, RuntimeError):
                pass
        kind = ("memory" if self.needle_map_kind == "native"
                else self.needle_map_kind)
        return new_needle_map(kind, idx_path)

    def _check_integrity(self, idx_path: str) -> int:
        """Verify index<->dat consistency; truncate corrupt tails.
        Mirrors CheckAndFixVolumeDataIntegrity (volume_checking.go:17-46)."""
        if not os.path.exists(idx_path):
            if self.data.size() > self.super_block.block_size:
                raise VolumeError(f"idx file {idx_path} does not exist")
            return 0
        index_size = os.path.getsize(idx_path)
        if index_size % t.NEEDLE_MAP_ENTRY_SIZE != 0:
            index_size -= index_size % t.NEEDLE_MAP_ENTRY_SIZE
            with open(idx_path, "r+b") as f:
                f.truncate(index_size)
        if index_size == 0:
            return 0
        healthy = index_size
        last_ns = 0
        with open(idx_path, "rb") as f:
            for i in range(1, 11):
                off = index_size - i * t.NEEDLE_MAP_ENTRY_SIZE
                if off < 0:
                    break
                f.seek(off)
                nid, a_off, size = idx_mod.unpack_entry(
                    f.read(t.NEEDLE_MAP_ENTRY_SIZE))
                try:
                    last_ns = self._verify_entry(nid, a_off, size)
                    break
                except EOFError:
                    healthy = off
                    continue
                except VolumeError:
                    break
        if healthy < index_size:
            with open(idx_path, "r+b") as f:
                f.truncate(healthy)
        return last_ns

    def _verify_entry(self, nid: int, offset: int, size: int) -> int:
        if offset == 0:
            return 0
        if size < 0:
            # deletion entry: tombstone needle sits at EOF
            disk = get_actual_size(0, self.version)
            blob = self.data.read_at(disk, self.data.size() - disk)
            if len(blob) < disk:
                raise EOFError
            n = Needle()
            n.read_bytes(blob, self.data.size() - disk, 0, self.version)
            if n.id != nid:
                raise VolumeError(
                    f"index key {nid:x} != needle id {n.id:x}")
            return n.append_at_ns
        header = self.data.read_at(t.NEEDLE_HEADER_SIZE, offset)
        if len(header) < t.NEEDLE_HEADER_SIZE:
            raise EOFError
        n, _ = read_needle_header(header)
        if n.size != size:
            raise VolumeError("size mismatch")
        ts_off = (offset + t.NEEDLE_HEADER_SIZE + size
                  + t.NEEDLE_CHECKSUM_SIZE)
        ts = self.data.read_at(t.TIMESTAMP_SIZE, ts_off)
        if len(ts) < t.TIMESTAMP_SIZE:
            raise EOFError
        append_at_ns = int.from_bytes(ts, "big")
        tail = offset + get_actual_size(size, self.version)
        if self.data.size() > tail:
            self.data.truncate(tail)
        return append_at_ns

    # -- write ---------------------------------------------------------------
    def _is_file_unchanged(self, n: Needle) -> bool:
        if self.ttl:
            return False
        nv = self.nm.get(n.id)
        if nv is None or nv.offset == 0 or not t.size_is_valid(nv.size):
            return False
        old = Needle()
        try:
            blob = self.data.read_at(
                get_actual_size(nv.size, self.version), nv.offset)
            old.read_bytes(blob, nv.offset, nv.size, self.version)
        except (NeedleError, struct.error, IndexError):
            return False
        return (old.cookie == n.cookie and old.checksum == n.checksum
                and old.data == n.data)

    def write_needle(self, n: Needle, check_cookie: bool = True
                     ) -> tuple[int, int, bool]:
        """Append a needle; returns (offset, size, is_unchanged)."""
        with self.lock:
            if self.read_only:
                raise VolumeError(f"volume {self.id} is read only")
            actual = get_actual_size(len(n.data), self.version)
            if self.nm.content_size() + actual > t.MAX_POSSIBLE_VOLUME_SIZE:
                raise VolumeError(
                    f"volume size limit {t.MAX_POSSIBLE_VOLUME_SIZE} exceeded")
            if not n.has_ttl and self.ttl:
                n.ttl = self.ttl
                n._set_flag(FLAG_HAS_TTL)
            if self._is_file_unchanged(n):
                return 0, len(n.data), True
            nv = self.nm.get(n.id)
            if nv is not None:
                header = self.data.read_at(t.NEEDLE_HEADER_SIZE, nv.offset)
                existing, _ = read_needle_header(header)
                if n.cookie == 0 and not check_cookie:
                    n.cookie = existing.cookie
                if existing.cookie != n.cookie:
                    raise CookieMismatchError(
                        f"mismatching cookie {n.cookie:x}")
            n.append_at_ns = time.time_ns()
            blob = n.to_bytes(self.version)
            offset = self._append_blob(blob)
            self.last_append_at_ns = n.append_at_ns
            if isinstance(self.nm, native_engine.NativeNeedleMap):
                # the "newer offset wins" check must read the map under
                # its own lock: a native-port write to the same id may
                # have landed after our pre-append lookup
                self.nm.put_if_newer(n.id, offset, n.size)
            elif nv is None or nv.offset < offset:
                self.nm.put(n.id, offset, n.size)
            if n.last_modified > self.last_modified_ts:
                self.last_modified_ts = n.last_modified
        if self.fsync:
            # outside the lock: other writers append while this one waits
            # for the shared group-commit fsync
            with tracing.span("fsync.group_commit", tags={"vid": self.id}):
                self._fsync_batcher().wait_durable()
        return offset, n.size, False

    def delete_needle(self, n: Needle) -> int:
        """Tombstone-append; returns the freed size (0 if absent)."""
        with self.lock:
            if self.read_only:
                raise VolumeError(f"volume {self.id} is read only")
            nv = self.nm.get(n.id)
            if nv is None or not t.size_is_valid(nv.size):
                return 0
            size = nv.size
            n.data = b""
            n.append_at_ns = time.time_ns()
            blob = n.to_bytes(self.version)
            offset = self._append_blob(blob)
            self.last_append_at_ns = n.append_at_ns
            self.nm.delete(n.id, offset)
        if self.fsync:
            with tracing.span("fsync.group_commit", tags={"vid": self.id}):
                self._fsync_batcher().wait_durable()
        return size

    # -- read ----------------------------------------------------------------
    def read_needle(self, nid: int, cookie: Optional[int] = None) -> Needle:
        with self.lock:
            nv = self.nm.get(nid)
            if nv is None or nv.offset == 0:
                raise NotFoundError(f"needle {nid:x} not found")
            if t.size_is_deleted(nv.size):
                raise DeletedError(f"needle {nid:x} already deleted")
            blob = self.data.read_at(
                get_actual_size(nv.size, self.version), nv.offset)
            n = Needle()
            n.read_bytes(blob, nv.offset, nv.size, self.version)
            if cookie is not None and n.cookie != cookie:
                raise CookieMismatchError(
                    f"cookie mismatch for needle {nid:x}")
            if n.has_ttl and self.ttl and n.last_modified:
                expiry = n.last_modified + self.ttl.minutes() * 60
                if time.time() >= expiry:
                    raise NotFoundError(f"needle {nid:x} expired")
            return n

    # -- scan (export/fsck support; volume_read.go:213-232) ------------------
    def read_needle_blob(self, offset: int, size: int) -> bytes:
        return self.data.read_at(get_actual_size(size, self.version), offset)

    def read_needle_slice(self, nid: int, cookie: Optional[int] = None,
                          min_size: int = 0):
        """Zero-copy read: ``(needle, data_offset, data_length, fd)``
        where `needle` carries full metadata (flags/name/mime/etag/TTL)
        but an EMPTY data field — the payload is meant to go straight
        from the .dat to the socket via sendfile.  Returns None when the
        record is not eligible (v1 volume, remote tier, compressed or
        manifest payload, below `min_size`) so the caller falls back to
        read_needle(); raises the same errors as read_needle for
        missing/deleted/expired needles.  The returned fd is dup'd — the
        caller owns it and must close it — so a racing vacuum commit that
        swaps the .dat cannot invalidate an in-flight transfer."""
        from .needle import VERSION1, VERSION3

        with self.lock:
            if self.version == VERSION1:
                return None
            fileno = getattr(self.data, "fileno", None)
            raw_fd = fileno() if fileno is not None else None
            if raw_fd is None:
                return None  # remote tier (or closed handle)
            nv = self.nm.get(nid)
            if nv is None or nv.offset == 0:
                raise NotFoundError(f"needle {nid:x} not found")
            if t.size_is_deleted(nv.size):
                raise DeletedError(f"needle {nid:x} already deleted")
            if nv.size <= 0:
                return None  # empty payload: nothing to sendfile
            head = self.data.read_at(t.NEEDLE_HEADER_SIZE + 4, nv.offset)
            if len(head) < t.NEEDLE_HEADER_SIZE + 4:
                raise NotFoundError(f"needle {nid:x}: truncated record")
            n = Needle()
            n.parse_header(head)
            if n.size != nv.size:
                return None  # index/data divergence: read_needle reports it
            data_size = int.from_bytes(
                head[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + 4], "big")
            if data_size < min_size or data_size == 0:
                return None
            # the metadata sections, CRC and (v3) appendAtNs trail the data
            meta_len = n.size - 4 - data_size
            tail_len = meta_len + t.NEEDLE_CHECKSUM_SIZE
            if self.version == VERSION3:
                tail_len += t.TIMESTAMP_SIZE
            tail_off = nv.offset + t.NEEDLE_HEADER_SIZE + 4 + data_size
            tail = self.data.read_at(tail_len, tail_off)
            if len(tail) < tail_len:
                raise NotFoundError(f"needle {nid:x}: truncated record")
            # a synthetic zero-length dataSize prefix parses just the
            # metadata sections into the needle, skipping the payload
            n._parse_body_v2(b"\x00\x00\x00\x00" + tail[:meta_len])
            n.data = b""
            # stored CRC, unverified (the payload never enters memory);
            # the write path stores the raw value, so the etag matches
            n.checksum = int.from_bytes(tail[meta_len:meta_len + 4], "big")
            if self.version == VERSION3:
                n.append_at_ns = int.from_bytes(tail[meta_len + 4:], "big")
            if cookie is not None and n.cookie != cookie:
                raise CookieMismatchError(
                    f"cookie mismatch for needle {nid:x}")
            if n.is_compressed or n.is_chunk_manifest:
                return None  # the response path needs these in memory
            if n.has_ttl and self.ttl and n.last_modified:
                expiry = n.last_modified + self.ttl.minutes() * 60
                if time.time() >= expiry:
                    raise NotFoundError(f"needle {nid:x} expired")
            fd = os.dup(raw_fd)
        return n, nv.offset + t.NEEDLE_HEADER_SIZE + 4, data_size, fd

    def scan(self):
        """Yield (needle, offset) for every record in the .dat, in file order."""
        pos = self.super_block.block_size
        end = self.data.size()
        while pos < end:
            header = self.data.read_at(t.NEEDLE_HEADER_SIZE, pos)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                break
            n, _ = read_needle_header(header)
            body_len = (get_actual_size(n.size, self.version)
                        - t.NEEDLE_HEADER_SIZE)
            body = self.data.read_at(body_len, pos + t.NEEDLE_HEADER_SIZE)
            n.read_needle_body(body, self.version)
            yield n, pos
            pos += t.NEEDLE_HEADER_SIZE + body_len

    # -- stats ---------------------------------------------------------------
    def content_size(self) -> int:
        return self.nm.content_size()

    def deleted_size(self) -> int:
        return self.nm.deleted_size()

    def file_count(self) -> int:
        return self.nm.file_count

    def deleted_count(self) -> int:
        return self.nm.deleted_count

    def max_file_key(self) -> int:
        return self.nm.max_file_key()

    # -- lifecycle -----------------------------------------------------------
    def garbage_level(self) -> float:
        if self.content_size() == 0:
            return 0.0
        return self.deleted_size() / self.content_size()

    def index_file_size(self) -> int:
        return self.file_stat()[1]

    # -- vacuum --------------------------------------------------------------
    def compact(self):
        """Copy live needles (by index) into .cpd/.cpx with a bumped
        compaction revision (Compact2, volume_vacuum.go:67-100)."""
        with self.lock:
            self.is_compacting = True
            # flush buffered idx appends before snapshotting the watermark,
            # or makeupDiff would replay the whole index
            self.nm.flush()
            self.data.sync()
            self.last_compact_index_offset = self.index_file_size()
            self.last_compact_revision = self.super_block.compaction_revision
            # snapshot the live map: writes may race the copy (makeupDiff
            # replays them at commit) and would otherwise mutate the dict
            # mid-iteration
            snapshot = [(nid, nv.offset, nv.size)
                        for nid, nv in self.nm.items_ascending()]
        try:
            self._copy_data_based_on_index(snapshot)
        finally:
            self.is_compacting = False

    def _copy_data_based_on_index(self, snapshot):
        new_sb = SuperBlock(
            version=self.super_block.version,
            replica_placement=self.super_block.replica_placement,
            ttl=self.super_block.ttl,
            compaction_revision=self.super_block.compaction_revision + 1,
            extra=self.super_block.extra,
        )
        now = time.time()
        with DiskFile(self.file_name(".cpd"), create=True) as dst, \
                open(self.file_name(".cpx"), "wb") as new_idx:
            dst.truncate(0)
            dst.write_at(new_sb.to_bytes(), 0)
            new_offset = new_sb.block_size
            for nid, offset, size in snapshot:
                if offset == 0 or t.size_is_deleted(size):
                    continue
                blob = self.read_needle_blob(offset, size)
                n = Needle()
                n.read_bytes(blob, offset, size, self.version)
                if (n.has_ttl and self.ttl and n.last_modified
                        and now >= n.last_modified + self.ttl.minutes() * 60):
                    continue
                dst.write_at(blob, new_offset)
                new_idx.write(idx_mod.pack_entry(nid, new_offset, n.size))
                new_offset += len(blob)

    def commit_compact(self):
        """Swap in .cpd/.cpx, replaying any writes that raced the copy
        (CommitCompact + makeupDiff, volume_vacuum.go:102-190)."""
        with self.lock:
            self.nm.flush()
            if isinstance(self.nm, native_engine.NativeNeedleMap):
                # barrier: no native fast-path write may land after the
                # diff replay reads the idx tail (clients get a 307 and
                # retry over HTTP, which blocks on self.lock)
                self.nm.quiesce()
            try:
                self._makeup_diff()
            except VolumeError:
                os.remove(self.file_name(".cpd"))
                os.remove(self.file_name(".cpx"))
                if isinstance(self.nm, native_engine.NativeNeedleMap):
                    # aborted commit: the old files stay live, so native
                    # writes may resume
                    self.nm.set_flags(writable=self._native_writable())
                raise
            self.nm.close()
            self.data.close()
            os.replace(self.file_name(".cpd"), self.file_name(".dat"))
            os.replace(self.file_name(".cpx"), self.file_name(".idx"))
            self._load(self.super_block.replica_placement,
                       self.super_block.ttl)

    def _makeup_diff(self):
        idx_path = self.file_name(".idx")
        index_size = os.path.getsize(idx_path)
        if index_size <= self.last_compact_index_offset:
            return
        # newest-first unique entries appended after the compaction snapshot
        updated: dict[int, tuple[int, int]] = {}
        with open(idx_path, "rb") as f:
            off = index_size - t.NEEDLE_MAP_ENTRY_SIZE
            while off >= self.last_compact_index_offset:
                f.seek(off)
                nid, a_off, size = idx_mod.unpack_entry(
                    f.read(t.NEEDLE_MAP_ENTRY_SIZE))
                updated.setdefault(nid, (a_off, size))
                off -= t.NEEDLE_MAP_ENTRY_SIZE
        if not updated:
            return
        with open(self.file_name(".cpd"), "rb") as f:
            new_sb = SuperBlock.from_file(f)
        if new_sb.compaction_revision != self.last_compact_revision + 1:
            raise VolumeError(
                f"compact revision {new_sb.compaction_revision} != "
                f"{self.last_compact_revision + 1}")
        with DiskFile(self.file_name(".cpd")) as dst, \
                open(self.file_name(".cpx"), "ab") as new_idx:
            for nid, (a_off, size) in updated.items():
                offset = dst.size()
                if offset % t.NEEDLE_PADDING_SIZE != 0:
                    offset += (t.NEEDLE_PADDING_SIZE
                               - offset % t.NEEDLE_PADDING_SIZE)
                if a_off != 0 and t.size_is_valid(size):
                    blob = self.read_needle_blob(a_off, size)
                    dst.write_at(blob, offset)
                    new_idx.write(idx_mod.pack_entry(nid, offset, size))
                else:
                    tomb = Needle(id=nid, cookie=0x12345678,
                                  append_at_ns=time.time_ns())
                    dst.write_at(tomb.to_bytes(self.version), offset)
                    new_idx.write(idx_mod.pack_entry(
                        nid, 0, t.TOMBSTONE_FILE_SIZE))

    # -- lifecycle -----------------------------------------------------------
    def _fsync_batcher(self) -> _FsyncBatcher:
        with self.lock:
            if self._batcher is None:
                self._batcher = _FsyncBatcher(self._durable_sync)
            return self._batcher

    def _durable_sync(self):
        """One group commit: .dat fsync + .idx flush+fsync — an
        acknowledged write must survive a host crash, so the index entry
        must be as durable as the data it points at."""
        with self.lock:
            self.nm.sync()
            self.data.sync()
        _stats.VolumeFsyncBatchCounter.inc()

    def sync(self):
        with self.lock:
            self.nm.flush()
            self.data.sync()

    def file_stat(self) -> tuple[int, int]:
        """(.dat size, .idx size), under the volume lock."""
        with self.lock:
            idx_path = self.file_name(".idx")
            return (self.data.size(),
                    os.path.getsize(idx_path)
                    if os.path.exists(idx_path) else 0)

    def destroy(self):
        """Close and delete the volume's files.  The .vif stays when shard
        files exist: it doubles as the EC volume's sidecar."""
        with self.lock:
            self.close()
            from .erasure_coding import TOTAL_SHARDS_COUNT, to_ext

            exts = [".dat", ".idx", ".vif", ".cpd", ".cpx", ".note"]
            if any(os.path.exists(self.file_name(to_ext(i)))
                   for i in range(TOTAL_SHARDS_COUNT)):
                exts.remove(".vif")
            for ext in exts:
                try:
                    os.remove(self.file_name(ext))
                except FileNotFoundError:
                    pass

    def close(self):
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        with self.lock:
            if self.nm is not None:
                self.nm.close()
            if self.data is not None:
                self.data.close()
