"""Disk tier: size-classed on-disk FIFO ring layers.

Counterpart of seaweedfs_tpu/cache/disk.py.  Parity with
weed/util/chunk_cache (on_disk_cache_layer.go,
chunk_cache_on_disk.go): each layer is a ring of append-only cache
volumes — a flat data file plus an in-RAM fid index — and when the
front volume fills, the oldest volume is reset and rotated to the
front, giving FIFO eviction in volume-sized steps with no per-entry
bookkeeping on disk.  Restarts rebuild nothing: cache volumes restart
empty (the index is RAM-only), which is correct for a cache and avoids
the reference's leveldb sidecar.

Chunks larger than a layer's segment can never fit; they are dropped at
admission and counted in ``SeaweedFS_chunk_cache_oversize_drops_total``
(historically they vanished silently).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..stats import metrics as stats


class CacheVolume:
    """One append-only cache segment: flat file + RAM index."""

    def __init__(self, file_name: str, size_limit: int):
        self.file_name = file_name
        self.size_limit = size_limit
        self._index: dict[str, tuple[int, int]] = {}  # fid -> (off, len)
        # unbuffered: reads go through os.pread, which sees only what has
        # actually reached the fd
        self._file = open(file_name, "wb+", buffering=0)
        self.file_size = 0

    def get(self, fid: str) -> Optional[bytes]:
        loc = self._index.get(fid)
        if loc is None:
            return None
        return os.pread(self._file.fileno(), loc[1], loc[0])

    def get_slice(self, fid: str) -> Optional[tuple]:
        """(dup'd fd, offset, length) for zero-copy sendfile, or None.
        The dup keeps the bytes readable even if this segment rotates
        (reset() swaps in a NEW inode) or the cache closes mid-send;
        the consumer owns — and must close — the returned fd."""
        loc = self._index.get(fid)
        if loc is None:
            return None
        return os.dup(self._file.fileno()), loc[0], loc[1]

    def has_room(self, n: int) -> bool:
        return self.file_size + n <= self.size_limit

    def put(self, fid: str, data) -> None:
        off = self.file_size
        self._file.seek(off)
        self._file.write(data)
        self.file_size = off + len(data)
        self._index[fid] = (off, len(data))

    def drop(self, fid: str) -> bool:
        """Forget the fid; the bytes stay until the segment rotates."""
        return self._index.pop(fid, None) is not None

    def drop_prefix(self, prefix: str) -> int:
        stale = [k for k in self._index if k.startswith(prefix)]
        for k in stale:
            del self._index[k]
        return len(stale)

    def reset(self):
        # replace the inode instead of truncating it: in-flight
        # sendfile slices hold dup'd fds to the OLD inode and must keep
        # seeing their bytes until the transfer finishes
        self._file.close()
        try:
            os.unlink(self.file_name)
        except OSError:
            pass
        self._file = open(self.file_name, "wb+", buffering=0)
        self._index.clear()
        self.file_size = 0

    def close(self):
        try:
            self._file.close()
            os.unlink(self.file_name)
        except OSError:
            pass


class OnDiskCacheLayer:
    """Ring of cache volumes with rotate-on-full FIFO eviction
    (on_disk_cache_layer.go setChunk)."""

    def __init__(self, directory: str, prefix: str, total_bytes: int,
                 segments: int):
        self.seg_size = max(1, total_bytes // segments)
        self.volumes = [
            CacheVolume(os.path.join(directory, f"{prefix}_{i}.dat"),
                        self.seg_size)
            for i in range(segments)]
        self._lock = threading.Lock()  # per-layer, not cache-global
        self.oversize_drops = 0

    def get(self, fid: str) -> Optional[bytes]:
        with self._lock:
            for v in self.volumes:
                data = v.get(fid)
                if data is not None:
                    return data
            return None

    def get_slice(self, fid: str) -> Optional[tuple]:
        """(dup'd fd, offset, length) under the layer lock, so the dup
        happens before any concurrent rotation can reset the segment."""
        with self._lock:
            for v in self.volumes:
                s = v.get_slice(fid)
                if s is not None:
                    return s
            return None

    def put(self, fid: str, data) -> None:
        if len(data) > self.seg_size:
            # can never fit; don't wipe a segment discovering that —
            # but don't let the drop vanish silently either
            with self._lock:
                self.oversize_drops += 1
            stats.ChunkCacheOversizeDropsCounter.inc()
            return
        with self._lock:
            if not self.volumes[0].has_room(len(data)):
                oldest = self.volumes.pop()
                oldest.reset()
                self.volumes.insert(0, oldest)
            self.volumes[0].put(fid, data)

    def invalidate(self, fid: str) -> bool:
        with self._lock:
            dropped = False
            for v in self.volumes:
                dropped = v.drop(fid) or dropped
            return dropped

    def drop_prefix(self, prefix: str) -> int:
        with self._lock:
            return sum(v.drop_prefix(prefix) for v in self.volumes)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return sum(v.file_size for v in self.volumes)

    def clear(self):
        with self._lock:
            for v in self.volumes:
                v.reset()

    def close(self):
        with self._lock:
            for v in self.volumes:
                v.close()
