"""Storage backend abstraction: positional-IO file objects.

Equivalent of the reference's BackendStorageFile interface
(weed/storage/backend/backend.go:15-23): ReadAt/WriteAt/Truncate/Close/
GetStat/Sync over a local file (DiskFile), an mmap-read file (MmapFile)
and a read-only file over a remote tier (TieredFile, storage/tier.py).
The port's own copy of seaweedfs_tpu/storage/backend.py.
"""

from __future__ import annotations

import os

from ..util import faults as _faults


class DiskFile:
    """Positional-IO wrapper over one OS file (backend/disk_file.go).
    Every operation passes the fault-injection disk hook first (a no-op
    module-bool check while no rules are loaded), so chaos tests can
    make a specific .dat file start throwing EIO and watch the volume
    demote itself to read-only."""

    def __init__(self, path: str, create: bool = False):
        self.path = path
        flags = os.O_RDWR
        if create:
            flags |= os.O_CREAT
        self._fd = os.open(path, flags, 0o644)

    def read_at(self, size: int, offset: int) -> bytes:
        if _faults.ACTIVE:
            _faults.on_disk(self.path, "read")
        return os.pread(self._fd, size, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        if _faults.ACTIVE:
            _faults.on_disk(self.path, "write")
        return os.pwrite(self._fd, data, offset)

    def append(self, data: bytes) -> int:
        """Write at EOF; returns the offset the data landed at."""
        if _faults.ACTIVE:
            _faults.on_disk(self.path, "write")
        end = self.size()
        os.pwrite(self._fd, data, end)
        return end

    def truncate(self, size: int):
        os.ftruncate(self._fd, size)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def sync(self):
        if _faults.ACTIVE:
            _faults.on_disk(self.path, "sync")
        os.fsync(self._fd)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def fileno(self) -> "int | None":
        """Raw fd for zero-copy sendfile; None once closed."""
        return self._fd

    @property
    def name(self) -> str:
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MmapFile:
    """mmap-backed reads + positional writes (backend/memory_map/):
    reads hit the page cache mapping directly; the map is regrown lazily
    when appends extend the file."""

    def __init__(self, path: str, create: bool = False):
        import mmap as _mmap

        self._mmap_mod = _mmap
        self.path = path
        flags = os.O_RDWR
        if create:
            flags |= os.O_CREAT
        self._fd = os.open(path, flags, 0o644)
        self._map = None
        self._remap()

    def _remap(self):
        size = os.fstat(self._fd).st_size
        if self._map is not None:
            self._map.close()
            self._map = None
        if size > 0:
            self._map = self._mmap_mod.mmap(self._fd, size,
                                            access=self._mmap_mod.ACCESS_READ)

    def read_at(self, size: int, offset: int) -> bytes:
        end = offset + size
        if self._map is None or end > len(self._map):
            self._remap()
        if self._map is None:
            return b""
        return bytes(self._map[offset:min(end, len(self._map))])

    def write_at(self, data: bytes, offset: int) -> int:
        if _faults.ACTIVE:
            _faults.on_disk(self.path, "write")
        n = os.pwrite(self._fd, data, offset)
        if self._map is not None and offset + n <= len(self._map):
            self._remap()  # overwrite within the mapped range: refresh
        return n

    def append(self, data: bytes) -> int:
        if _faults.ACTIVE:
            _faults.on_disk(self.path, "write")
        end = os.fstat(self._fd).st_size
        os.pwrite(self._fd, data, end)
        return end

    def truncate(self, size: int):
        os.ftruncate(self._fd, size)
        self._remap()

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def sync(self):
        os.fsync(self._fd)

    def close(self):
        if self._map is not None:
            self._map.close()
            self._map = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def fileno(self) -> "int | None":
        """Raw fd for zero-copy sendfile; None once closed."""
        return self._fd

    @property
    def name(self) -> str:
        return self.path


class TieredFile:
    """Read-only BackendStorageFile over a remote tier
    (backend/s3_backend/s3_backend.go S3BackendStorageFile): ranged
    reads against the remote object, LRU block cache in front."""

    BLOCK = 1 << 20

    def __init__(self, fetch_range, total_size: int, name: str = "",
                 cache_blocks: int = 32):
        from collections import OrderedDict

        self._fetch = fetch_range  # (offset, size) -> bytes
        self._size = total_size
        self._name = name
        self._cache: "OrderedDict[int, bytes]" = OrderedDict()
        self._cache_blocks = cache_blocks

    def _block(self, index: int) -> bytes:
        if index in self._cache:
            self._cache.move_to_end(index)
            return self._cache[index]
        offset = index * self.BLOCK
        data = self._fetch(offset, min(self.BLOCK, self._size - offset))
        self._cache[index] = data
        if len(self._cache) > self._cache_blocks:
            self._cache.popitem(last=False)
        return data

    def read_at(self, size: int, offset: int) -> bytes:
        if offset >= self._size:
            return b""
        size = min(size, self._size - offset)
        parts = []
        while size > 0:
            index, inner = divmod(offset, self.BLOCK)
            chunk = self._block(index)[inner:inner + size]
            if not chunk:
                break
            parts.append(chunk)
            offset += len(chunk)
            size -= len(chunk)
        return b"".join(parts)

    def write_at(self, data: bytes, offset: int) -> int:
        raise OSError("tiered volume file is read-only")

    def append(self, data: bytes) -> int:
        raise OSError("tiered volume file is read-only")

    def truncate(self, size: int):
        raise OSError("tiered volume file is read-only")

    def size(self) -> int:
        return self._size

    def sync(self):
        pass

    def close(self):
        self._cache.clear()

    def fileno(self) -> "int | None":
        return None  # remote tier: no local fd to sendfile from

    @property
    def name(self) -> str:
        return self._name
