"""Incremental volume backup/tail: follow another replica's appends.

Parity with weed/storage/volume_backup.go: ``binary_search_by_append_at_ns``
(:171) locates the first .dat offset whose needle was appended after a
timestamp by binary-searching the .idx (append order == timestamp order);
``incremental_backup`` (:66) pulls the delta from a source replica and
replays it locally; the tail side streams raw needle records from that
offset (volume_grpc_tail.go).

Counterpart of seaweedfs_tpu/storage/volume_backup.py.
"""

from __future__ import annotations

import os
from typing import Callable

from . import idx as idx_mod
from . import types as t
from .needle import Needle, get_actual_size, read_needle_header
from .volume import Volume, VolumeError


def _append_at_ns_of(v: Volume, offset: int, size: int) -> int:
    """Read a needle's append timestamp straight from the .dat."""
    if size < 0:
        size = 0  # tombstones store no data
    ts_off = (offset + t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE)
    blob = v.data.read_at(t.TIMESTAMP_SIZE, ts_off)
    if len(blob) < t.TIMESTAMP_SIZE:
        raise VolumeError(f"short read at {ts_off}")
    return int.from_bytes(blob, "big")


def binary_search_by_append_at_ns(v: Volume, since_ns: int) -> int:
    """First .dat offset with append_at_ns > since_ns, or the .dat size if
    fully caught up (BinarySearchByAppendAtNs, volume_backup.go:171-222)."""
    if v.nm is not None:
        v.nm.flush()  # the idx appends are buffered; search reads the file
    idx_path = v.file_name(".idx")
    if not os.path.exists(idx_path):
        return v.super_block.block_size
    entry_count = os.path.getsize(idx_path) // t.NEEDLE_MAP_ENTRY_SIZE
    if entry_count == 0:
        return v.super_block.block_size
    with open(idx_path, "rb") as f:
        def entry(i: int) -> tuple[int, int, int]:
            f.seek(i * t.NEEDLE_MAP_ENTRY_SIZE)
            return idx_mod.unpack_entry(f.read(t.NEEDLE_MAP_ENTRY_SIZE))

        lo, hi = 0, entry_count  # invariant: ts(lo-1) <= since < ts(hi)
        while lo < hi:
            mid = (lo + hi) // 2
            _, offset, size = entry(mid)
            if offset == 0:
                # unrecorded deletion entry; skip forward linearly
                lo_scan = mid + 1
                while lo_scan < hi:
                    _, o2, s2 = entry(lo_scan)
                    if o2 != 0:
                        offset, size = o2, s2
                        mid = lo_scan
                        break
                    lo_scan += 1
                else:
                    hi = mid
                    continue
            if _append_at_ns_of(v, offset, size) <= since_ns:
                lo = mid + 1
            else:
                hi = mid
        if lo >= entry_count:
            return v.data.size()
        _, offset, size = entry(lo)
        if offset == 0:
            return v.data.size()
        return offset


def read_appended_bytes(v: Volume, since_ns: int,
                        limit: int = 64 << 20) -> tuple[bytes, int]:
    """-> (raw needle records appended after since_ns, resume cursor).

    The cursor is the append_at_ns of the LAST record actually included —
    a truncated read must not skip the unsent tail — and the blob is cut
    at a whole-record boundary."""
    with v.lock:
        start = binary_search_by_append_at_ns(v, since_ns)
        end = min(v.data.size(), start + limit)
        blob = v.data.read_at(end - start, start)
    # cut at the last complete record and find its timestamp
    version = v.version
    pos = 0
    cursor = since_ns
    while pos + t.NEEDLE_HEADER_SIZE <= len(blob):
        n, _ = read_needle_header(blob[pos:pos + t.NEEDLE_HEADER_SIZE])
        size = max(n.size, 0)  # tombstones carry no data
        actual = get_actual_size(size, version)
        if pos + actual > len(blob):
            break
        ts_off = pos + t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
        cursor = int.from_bytes(
            blob[ts_off:ts_off + t.TIMESTAMP_SIZE], "big")
        pos += actual
    return blob[:pos], cursor


def iter_appended_bytes(v: Volume, since_ns: int, limit: int = 64 << 20,
                        chunk_size: int = 4 << 20):
    """Streaming read_appended_bytes: -> (chunk iterator, length, cursor).

    The record boundary and resume cursor are found by a header-only walk
    (pread of each needle header, skipping the data), so the server never
    buffers the payload; chunks are then read lazily.

    The walk and chunk reads go through a dedicated fd opened on the .dat
    PATH while the volume lock is held: a vacuum commit that os.replace()s
    the .dat mid-stream leaves this fd on the old inode, so the stream
    stays internally consistent instead of serving bytes from the new,
    differently-laid-out file.  Non-file backends (tiered volumes) fall
    back to one locked buffered read."""
    dat_path = v.file_name(".dat")
    with v.lock:
        if not os.path.exists(dat_path):
            blob, cursor = read_appended_bytes(v, since_ns, limit)
            return iter([blob]), len(blob), cursor
        f = open(dat_path, "rb")
        start = binary_search_by_append_at_ns(v, since_ns)
        end = min(v.data.size(), start + limit)
    version = v.version
    fd = f.fileno()
    pos = start
    cursor = since_ns
    while pos + t.NEEDLE_HEADER_SIZE <= end:
        header = os.pread(fd, t.NEEDLE_HEADER_SIZE, pos)
        if len(header) < t.NEEDLE_HEADER_SIZE:
            break
        n, _ = read_needle_header(header)
        size = max(n.size, 0)  # tombstones carry no data
        actual = get_actual_size(size, version)
        if pos + actual > end:
            break
        ts_off = pos + t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
        ts = os.pread(fd, t.TIMESTAMP_SIZE, ts_off)
        cursor = int.from_bytes(ts, "big")
        pos += actual
    length = pos - start

    def gen():
        try:
            at = start
            left = length
            while left > 0:
                chunk = os.pread(fd, min(chunk_size, left), at)
                if not chunk:
                    return
                at += len(chunk)
                left -= len(chunk)
                yield chunk
        finally:
            f.close()

    return gen(), length, cursor


def replay_appended_bytes(v: Volume, blob: bytes) -> int:
    """Append raw needle records fetched from a replica, updating the
    index (tombstones delete).  Returns the number of records applied."""
    applied = 0
    pos = 0
    version = v.version
    with v.lock:
        while pos + t.NEEDLE_HEADER_SIZE <= len(blob):
            n, _ = read_needle_header(blob[pos:pos + t.NEEDLE_HEADER_SIZE])
            actual = get_actual_size(n.size, version)
            record = blob[pos:pos + actual]
            if len(record) < actual:
                break
            full = Needle()
            full.read_bytes(record, 0, n.size, version)
            offset = v.data.append(record)
            if full.size > 0 or full.data:
                v.nm.put(full.id, offset, n.size)
            else:
                # zero-size append records a deletion
                v.nm.delete(full.id, offset)
            if full.append_at_ns > v.last_append_at_ns:
                v.last_append_at_ns = full.append_at_ns
            applied += 1
            pos += actual
    return applied


def incremental_backup(dst: Volume,
                       fetch: Callable[[int], bytes],
                       max_rounds: int = 1024) -> int:
    """Pull appended records from a source replica until caught up.
    ``fetch(since_ns)`` returns raw bytes after that timestamp (empty when
    caught up).  Mirrors IncrementalBackup (volume_backup.go:66-131)."""
    total = 0
    for _ in range(max_rounds):
        blob = fetch(dst.last_append_at_ns)
        if not blob:
            break
        applied = replay_appended_bytes(dst, blob)
        if applied == 0:
            break
        total += applied
    return total
