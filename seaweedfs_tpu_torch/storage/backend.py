"""Storage backend: positional-IO file objects.

Equivalent of the reference's BackendStorageFile interface
(weed/storage/backend/backend.go:15-23): ReadAt/WriteAt/Truncate/Close/
GetStat/Sync over a local file.  The port has the local disk file only;
fault-injection hooks and the tiered (remote) file come with later
slices.
"""

from __future__ import annotations

import os


class DiskFile:
    """Positional-IO wrapper over one OS file (backend/disk_file.go)."""

    def __init__(self, path: str, create: bool = False):
        self.path = path
        flags = os.O_RDWR
        if create:
            flags |= os.O_CREAT
        self._fd = os.open(path, flags, 0o644)

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._fd, size, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        return os.pwrite(self._fd, data, offset)

    def append(self, data: bytes) -> int:
        """Write at EOF; returns the offset the data landed at."""
        end = self.size()
        os.pwrite(self._fd, data, end)
        return end

    def truncate(self, size: int):
        os.ftruncate(self._fd, size)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def sync(self):
        os.fsync(self._fd)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def fileno(self) -> "int | None":
        """Raw fd; None once closed."""
        return self._fd

    @property
    def name(self) -> str:
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
