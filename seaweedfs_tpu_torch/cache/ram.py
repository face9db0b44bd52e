"""Host-RAM tier: LRU bounded by byte budget.

Counterpart of seaweedfs_tpu/cache/ram.py.  Parity with
weed/filer/reader_cache.go + weed/util/chunk_cache —
recently fetched chunks are kept in RAM so sequential and repeated
reads avoid re-fetching from volume servers.  Payloads are usually
immutable ``bytes`` but any object may be cached by passing an explicit
``nbytes`` (the volume server caches parsed needles this way).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional


class RamCache:
    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity = capacity_bytes
        self._data: OrderedDict[str, tuple[Any, int]] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, fid: str) -> Optional[Any]:
        with self._lock:
            entry = self._data.get(fid)
            if entry is None:
                return None
            self._data.move_to_end(fid)
            return entry[0]

    def put(self, fid: str, data: Any, nbytes: Optional[int] = None):
        n = len(data) if nbytes is None else nbytes
        if n > self.capacity:
            return  # oversized: never cache (chunk_cache size gate)
        with self._lock:
            old = self._data.pop(fid, None)
            if old is not None:
                self._bytes -= old[1]
            self._data[fid] = (data, n)
            self._bytes += n
            while self._bytes > self.capacity:
                _, (_, evicted) = self._data.popitem(last=False)
                self._bytes -= evicted

    def pop(self, fid: str) -> bool:
        with self._lock:
            old = self._data.pop(fid, None)
            if old is None:
                return False
            self._bytes -= old[1]
            return True

    def drop_prefix(self, prefix: str) -> int:
        with self._lock:
            stale = [k for k in self._data if k.startswith(prefix)]
            for k in stale:
                self._bytes -= self._data.pop(k)[1]
            return len(stale)

    def clear(self):
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def __len__(self) -> int:
        return len(self._data)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def close(self):
        """No resources to release; shares the tiered cache's interface."""
