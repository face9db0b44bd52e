"""Needle index kinds: id -> (offset, size), plus volume statistics.

Equivalent of the reference's NeedleMapper family (weed/storage/
needle_map.go:15-38: memory / leveldb / leveldbMedium / leveldbLarge):

  * NeedleMap        — dict-backed (kind "memory"): simplest, ~100 B/entry
                       under CPython; fine for small volumes.
  * CompactNeedleMap — numpy struct-of-arrays (kind "compact"): 16 bytes
                       per entry like the reference's CompactMap sectioned
                       arrays (compact_map.go:10-48), with a sorted bulk
                       region + small overflow dict merged in batches, and
                       a fully vectorised .idx bulk loader.
  * SqliteNeedleMap  — disk-backed (kind "sqlite"): the leveldb-variant
                       analogue for RAM-constrained servers; the .idx
                       remains the durable log, the DB is the lookup
                       structure, rebuilt from .idx when stale
                       (needle_map_leveldb.go semantics).

All kinds share the same bookkeeping the reference's mapMetric maintains
(cumulative file/deleted counts and byte totals, max key), an append-log
.idx writer, and ascending iteration for .ecx generation (memdb.go
AscendingVisit).

The port's own copy of seaweedfs_tpu/storage/needle_map.py.  The native
engine's map (storage/native_engine.py NativeNeedleMap) replaces the
"memory" kind when the engine's library builds, as in the JAX package.
"""

from __future__ import annotations

import io
import os
import sqlite3
from typing import Callable, Iterator, Optional

import numpy as np

from . import idx as idx_mod
from . import types as t

_IDX_DTYPE = np.dtype([("key", ">u8"), ("off", ">u4"), ("size", ">i4")])

# prefork gateways: the parent process serves all writes while forked
# workers serve reads from their fork-time map snapshot.  Flushing every
# idx append lets workers tail the file (refresh_from_idx) to pick up
# needles written after the fork without any IPC.
FLUSH_APPENDS = False


class NeedleValue:
    __slots__ = ("offset", "size")

    def __init__(self, offset: int, size: int):
        self.offset = offset  # actual byte offset
        self.size = size

    def __repr__(self):
        return f"NeedleValue(offset={self.offset}, size={self.size})"


class BaseNeedleMap:
    """Shared statistics bookkeeping + .idx append log."""

    def __init__(self, index_path: Optional[str] = None):
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.content_bytes = 0
        self.max_key = 0
        self._index_file: Optional[io.BufferedWriter] = None
        self.index_path = index_path
        self._idx_tail = 0  # bytes of the .idx this map has consumed
        if index_path is not None:
            if os.path.exists(index_path):
                self._load_from_idx(index_path)
                self._idx_tail = os.path.getsize(index_path)
            self._index_file = open(index_path, "ab")

    # kind-specific storage hooks -------------------------------------------
    def _get(self, nid: int) -> Optional[tuple[int, int]]:
        """-> (actual_offset, size) or None; negative size = deleted."""
        raise NotImplementedError

    def _set(self, nid: int, offset: int, size: int):
        raise NotImplementedError

    def _mark_deleted(self, nid: int):
        """Negate the stored size in place, keeping the offset."""
        raise NotImplementedError

    def _visit_ascending(self) -> Iterator[tuple[int, int, int]]:
        """Yield (nid, actual_offset, size) in ascending id order."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # -- load ---------------------------------------------------------------
    def _load_from_idx(self, path: str):
        idx_mod.walk_index_file(path, self._apply)

    def _apply(self, nid: int, offset: int, size: int):
        """Replay one idx entry (needle_map_memory.go doLoading semantics):
        a zero offset or tombstone size marks a deletion; deletions keep the
        entry with negated size so reads distinguish deleted from absent
        (compact_map.go Delete; volume_read.go:27-35)."""
        self.max_key = max(self.max_key, nid)
        if offset > 0 and size != t.TOMBSTONE_FILE_SIZE:
            prev = self._get(nid)
            if prev is not None and prev[1] > 0:
                self.deleted_count += 1
                self.deleted_bytes += prev[1]
            self._set(nid, offset, size)
            self.file_count += 1
            self.content_bytes += size
        else:
            prev = self._get(nid)
            if prev is not None and prev[1] > 0:
                self.deleted_count += 1
                self.deleted_bytes += prev[1]
                self._mark_deleted(nid)

    # -- mutate -------------------------------------------------------------
    def put(self, nid: int, offset: int, size: int):
        self._apply(nid, offset, size)
        self._append_idx(nid, offset, size)

    def delete(self, nid: int, offset: int):
        """Record a tombstone; offset is where the tombstone needle landed."""
        self._apply(nid, 0, t.TOMBSTONE_FILE_SIZE)
        self._append_idx(nid, offset, t.TOMBSTONE_FILE_SIZE)

    def set_in_memory(self, nid: int, offset: int, size: int):
        """Update the map without touching the idx log (for rebuilds)."""
        self._apply(nid, offset, size)

    def _append_idx(self, nid: int, offset: int, size: int):
        if self._index_file is not None:
            self._index_file.write(idx_mod.pack_entry(nid, offset, size))
            self._idx_tail += t.NEEDLE_MAP_ENTRY_SIZE
            if FLUSH_APPENDS:
                self._index_file.flush()

    def refresh_from_idx(self) -> int:
        """Replay entries another process appended to the .idx since this
        map last read it (prefork workers tailing the parent's writes).
        Returns the number of entries applied.  Only valid for maps that
        are not appending concurrently themselves — the prefork design
        guarantees that by forwarding all writes to the parent."""
        if self.index_path is None or not os.path.exists(self.index_path):
            return 0
        size = os.path.getsize(self.index_path)
        size -= size % t.NEEDLE_MAP_ENTRY_SIZE
        if size <= self._idx_tail:
            return 0
        applied = 0
        with open(self.index_path, "rb") as f:
            f.seek(self._idx_tail)
            while self._idx_tail + t.NEEDLE_MAP_ENTRY_SIZE <= size:
                entry = f.read(t.NEEDLE_MAP_ENTRY_SIZE)
                if len(entry) < t.NEEDLE_MAP_ENTRY_SIZE:
                    break
                nid, off, sz = idx_mod.unpack_entry(entry)
                self._apply(nid, off, sz)
                self._idx_tail += t.NEEDLE_MAP_ENTRY_SIZE
                applied += 1
        return applied

    # -- query --------------------------------------------------------------
    def get(self, nid: int) -> Optional[NeedleValue]:
        got = self._get(nid)
        return None if got is None else NeedleValue(got[0], got[1])

    def __contains__(self, nid: int) -> bool:
        return self._get(nid) is not None

    def ascending_visit(self, fn: Callable[[int, NeedleValue], None]):
        """Visit entries in ascending id order (memdb.go:100-123): the
        ordering contract .ecx files depend on."""
        for nid, offset, size in self._visit_ascending():
            fn(nid, NeedleValue(offset, size))

    def items_ascending(self) -> Iterator[tuple[int, NeedleValue]]:
        for nid, offset, size in self._visit_ascending():
            yield nid, NeedleValue(offset, size)

    # -- stats (needle_map.go mapMetric interface) ---------------------------
    def content_size(self) -> int:
        return self.content_bytes

    def deleted_size(self) -> int:
        return self.deleted_bytes

    def max_file_key(self) -> int:
        return self.max_key

    # -- lifecycle ----------------------------------------------------------
    def flush(self):
        if self._index_file is not None:
            self._index_file.flush()

    def sync(self):
        """Durably flush the .idx append log (fsync write path)."""
        if self._index_file is not None:
            self._index_file.flush()
            os.fsync(self._index_file.fileno())

    def close(self):
        if self._index_file is not None:
            self._index_file.flush()
            os.fsync(self._index_file.fileno())
            self._index_file.close()
            self._index_file = None


class NeedleMap(BaseNeedleMap):
    """dict-backed map (kind "memory")."""

    def __init__(self, index_path: Optional[str] = None):
        self._m: dict[int, NeedleValue] = {}
        super().__init__(index_path)

    def _get(self, nid):
        nv = self._m.get(nid)
        return None if nv is None else (nv.offset, nv.size)

    def _set(self, nid, offset, size):
        self._m[nid] = NeedleValue(offset, size)

    def _mark_deleted(self, nid):
        nv = self._m[nid]
        nv.size = -nv.size

    def _visit_ascending(self):
        for nid in sorted(self._m):
            nv = self._m[nid]
            yield nid, nv.offset, nv.size

    def __len__(self):
        return len(self._m)


class CompactNeedleMap(BaseNeedleMap):
    """numpy struct-of-arrays map (kind "compact"): 16 bytes/entry.

    Layout mirrors the on-disk idx entry: u64 key + u32 stored offset (÷8,
    the reference's Offset type, offset.go:24) + i32 size.  Lookups are a
    binary search over the sorted bulk region (np.searchsorted), new keys
    land in a small overflow dict merged in batches — the same
    sorted-arrays-plus-overflow shape as the reference's CompactMap
    (compact_map.go:10-48, 194-263) without per-section Python objects.
    """

    _MERGE_MIN = 4096

    def __init__(self, index_path: Optional[str] = None):
        self._keys = np.empty(0, dtype=np.uint64)
        self._offs = np.empty(0, dtype=np.uint32)   # stored form (÷8)
        self._sizes = np.empty(0, dtype=np.int32)
        self._overflow: dict[int, tuple[int, int]] = {}  # nid -> (stored, sz)
        super().__init__(index_path)

    # -- bulk load ----------------------------------------------------------
    def _load_from_idx(self, path: str):
        """Vectorised replay of the whole .idx — no per-entry Python loop.

        Resolves last-writer-wins per key, delete-negates-size semantics,
        and the cumulative mapMetric counters in O(n) numpy passes.
        """
        raw = np.fromfile(path, dtype=_IDX_DTYPE)
        if raw.size == 0:
            return
        keys = raw["key"].astype(np.uint64)
        offs = raw["off"].astype(np.uint32)
        sizes = raw["size"].astype(np.int64)
        puts = (offs > 0) & (sizes != t.TOMBSTONE_FILE_SIZE)

        uniq, inv = np.unique(keys, return_inverse=True)
        n = uniq.size
        order = np.arange(raw.size, dtype=np.int64)
        last_put = np.full(n, -1, dtype=np.int64)
        np.maximum.at(last_put, inv[puts], order[puts])
        last_del = np.full(n, -1, dtype=np.int64)
        np.maximum.at(last_del, inv[~puts], order[~puts])

        valid = last_put >= 0
        deleted = valid & (last_del > last_put)
        lp = last_put[valid]
        final_off = offs[lp]
        final_size = sizes[lp].astype(np.int32)
        final_size = np.where(deleted[valid], -final_size, final_size)

        # cumulative metrics (mapMetric semantics: every put counts toward
        # file_count/content_bytes; a put only counts as *deleted* when a
        # later put/delete supersedes it while live with size > 0 — the
        # sequential _apply guards on prev.size > 0, so size-0 puts never
        # increment the deleted counters)
        pos_puts = puts & (sizes > 0)
        pos_per_key = np.zeros(n, dtype=np.int64)
        np.add.at(pos_per_key, inv[pos_puts], 1)
        pos_size_sums = np.zeros(n, dtype=np.int64)
        np.add.at(pos_size_sums, inv[pos_puts], sizes[pos_puts])
        last_sizes = sizes[lp]
        last_pos = last_sizes > 0
        self.file_count += int(puts.sum())
        self.content_bytes += int(sizes[puts].sum())
        superseded = pos_per_key[valid] - last_pos.astype(np.int64)
        trailing = deleted[valid] & last_pos
        self.deleted_count += int(superseded.sum() + trailing.sum())
        self.deleted_bytes += int(
            (pos_size_sums[valid] - last_sizes * last_pos).sum()
            + last_sizes[trailing].sum())
        self.max_key = max(self.max_key, int(keys.max()))

        self._keys = uniq[valid]
        self._offs = final_off
        self._sizes = final_size

    # -- storage hooks ------------------------------------------------------
    def _find_sorted(self, nid: int) -> int:
        i = int(np.searchsorted(self._keys, np.uint64(nid)))
        if i < self._keys.size and int(self._keys[i]) == nid:
            return i
        return -1

    def _get(self, nid):
        got = self._overflow.get(nid)
        if got is not None:
            return t.from_stored_offset(got[0]), got[1]
        i = self._find_sorted(nid)
        if i < 0:
            return None
        return t.from_stored_offset(int(self._offs[i])), int(self._sizes[i])

    def _set(self, nid, offset, size):
        stored = t.to_stored_offset(offset)
        i = self._find_sorted(nid)
        if i >= 0 and nid not in self._overflow:
            self._offs[i] = stored
            self._sizes[i] = size
        else:
            self._overflow[nid] = (stored, size)
            self._maybe_merge()

    def _mark_deleted(self, nid):
        got = self._overflow.get(nid)
        if got is not None:
            self._overflow[nid] = (got[0], -got[1])
            return
        i = self._find_sorted(nid)
        if i >= 0:
            self._sizes[i] = -self._sizes[i]

    def _maybe_merge(self, force: bool = False):
        if not self._overflow:
            return
        if not force and len(self._overflow) < max(self._MERGE_MIN,
                                                   self._keys.size // 8):
            return
        ov_keys = np.fromiter(self._overflow.keys(), dtype=np.uint64,
                              count=len(self._overflow))
        ov_vals = np.array(list(self._overflow.values()), dtype=np.int64)
        order = np.argsort(ov_keys)
        ov_keys = ov_keys[order]
        ov_offs = ov_vals[order, 0].astype(np.uint32)
        ov_sizes = ov_vals[order, 1].astype(np.int32)
        # overflow keys are disjoint from the sorted region by construction
        keys = np.concatenate([self._keys, ov_keys])
        offs = np.concatenate([self._offs, ov_offs])
        sizes = np.concatenate([self._sizes, ov_sizes])
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._offs = offs[order]
        self._sizes = sizes[order]
        self._overflow.clear()

    def _visit_ascending(self):
        self._maybe_merge(force=True)
        for i in range(self._keys.size):
            yield (int(self._keys[i]),
                   t.from_stored_offset(int(self._offs[i])),
                   int(self._sizes[i]))

    def __len__(self):
        return int(self._keys.size) + len(self._overflow)

    def bytes_per_entry(self) -> float:
        n = len(self)
        if n == 0:
            return 0.0
        core = (self._keys.nbytes + self._offs.nbytes + self._sizes.nbytes)
        return core / max(1, self._keys.size)


class SqliteNeedleMap(BaseNeedleMap):
    """sqlite-backed map (kind "sqlite") for RAM-constrained servers.

    The .idx append log stays authoritative; the DB (at index_path +
    ".sqlite") is a lookup structure rebuilt from the .idx whenever its
    recorded idx size is stale — needle_map_leveldb.go's recovery story.
    Cumulative metrics persist in a meta table on flush/close; after a
    crash they are re-derived from live rows (same degradation as the
    reference's metric recomputation).
    """

    def __init__(self, index_path: Optional[str] = None,
                 db_path: Optional[str] = None):
        if db_path is None:
            db_path = (index_path + ".sqlite") if index_path else ":memory:"
        # volume-server handlers run on per-connection threads; access is
        # serialised by Volume.lock, so cross-thread use is safe
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS needles ("
            "key INTEGER PRIMARY KEY, off INTEGER, size INTEGER)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)")
        self._pending = 0
        super().__init__(index_path)

    def _meta(self, k: str) -> Optional[int]:
        row = self._db.execute("SELECT v FROM meta WHERE k=?", (k,)).fetchone()
        return None if row is None else int(row[0])

    def _set_meta(self, k: str, v: int):
        self._db.execute(
            "INSERT INTO meta(k, v) VALUES(?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v", (k, v))

    def _load_from_idx(self, path: str):
        idx_size = os.path.getsize(path)
        if self._meta("idx_size") == idx_size:
            # DB is current: restore metrics, skip the replay
            for attr in ("file_count", "deleted_count", "deleted_bytes",
                         "content_bytes", "max_key"):
                v = self._meta(attr)
                if v is not None:
                    setattr(self, attr, v)
            return
        self._db.execute("DELETE FROM needles")
        super()._load_from_idx(path)
        self._persist_meta(idx_size)

    def _persist_meta(self, idx_size: Optional[int] = None):
        if idx_size is None and self.index_path:
            if self._index_file is not None:
                self._index_file.flush()
            idx_size = (os.path.getsize(self.index_path)
                        if os.path.exists(self.index_path) else 0)
        self._set_meta("idx_size", idx_size or 0)
        for attr in ("file_count", "deleted_count", "deleted_bytes",
                     "content_bytes", "max_key"):
            self._set_meta(attr, getattr(self, attr))
        self._db.commit()

    @staticmethod
    def _sql_key(nid: int) -> int:
        # sqlite INTEGER is signed 64-bit; wrap u64 keys into its range
        return nid - (1 << 64) if nid >= (1 << 63) else nid

    @staticmethod
    def _from_sql_key(k: int) -> int:
        return k + (1 << 64) if k < 0 else k

    def _get(self, nid):
        row = self._db.execute(
            "SELECT off, size FROM needles WHERE key=?",
            (self._sql_key(nid),)).fetchone()
        if row is None:
            return None
        return t.from_stored_offset(int(row[0])), int(row[1])

    def _set(self, nid, offset, size):
        self._db.execute(
            "INSERT INTO needles(key, off, size) VALUES(?, ?, ?) "
            "ON CONFLICT(key) DO UPDATE SET off=excluded.off, "
            "size=excluded.size",
            (self._sql_key(nid), t.to_stored_offset(offset), size))
        self._bump()

    def _mark_deleted(self, nid):
        self._db.execute("UPDATE needles SET size=-size WHERE key=?",
                         (self._sql_key(nid),))
        self._bump()

    def _bump(self):
        self._pending += 1
        if self._pending >= 1024:
            self._db.commit()
            self._pending = 0

    def _visit_ascending(self):
        # two passes ordered by the unsigned key value (negative sql keys
        # are the u64 upper half)
        for clause in ("key >= 0", "key < 0"):
            cur = self._db.execute(
                f"SELECT key, off, size FROM needles WHERE {clause} "
                "ORDER BY key")
            for k, off, size in cur:
                yield (self._from_sql_key(int(k)),
                       t.from_stored_offset(int(off)), int(size))

    def __len__(self):
        return int(self._db.execute(
            "SELECT COUNT(*) FROM needles").fetchone()[0])

    def flush(self):
        super().flush()
        self._persist_meta()

    def close(self):
        super().close()
        self._persist_meta(
            os.path.getsize(self.index_path)
            if self.index_path and os.path.exists(self.index_path) else 0)
        self._db.close()


_KINDS = {
    "memory": NeedleMap,
    "compact": CompactNeedleMap,
    "sqlite": SqliteNeedleMap,
}


def new_needle_map(kind: str = "memory",
                   index_path: Optional[str] = None) -> BaseNeedleMap:
    """Factory mirroring NeedleMapKind selection (needle_map.go:15-22)."""
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown needle map kind {kind!r}") from None
    return cls(index_path)


def load_needle_map_from_idx(path: str, kind: str = "memory"
                             ) -> BaseNeedleMap:
    """Read-only map from an existing .idx (no append log) — the shape
    WriteSortedFileFromIdx consumes (ec_encoder.go:27-54, readNeedleMap)."""
    nm = _KINDS[kind]()
    nm._load_from_idx(path)
    return nm
