"""In-RAM change-log buffer with time-windowed flushing.

Parity with weed/util/log_buffer/log_buffer.go:24-50: mutations append
timestamped entries to a memory buffer; a flush function persists the
buffered window (start_ts, stop_ts, entries) either when the flush
interval elapses or on demand.  Readers tail the in-RAM buffer for events
newer than what has been flushed.

The port's own copy of seaweedfs_tpu/util/log_buffer.py.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

FlushFn = Callable[[int, int, list], None]


class LogBuffer:
    def __init__(self, flush_fn: Optional[FlushFn] = None,
                 flush_interval: float = 60.0,
                 max_entries: Optional[int] = None):
        self.flush_fn = flush_fn
        self.flush_interval = flush_interval
        self.max_entries = max_entries  # ring-buffer cap when not flushing
        # (ts_ns, payload), ts_ns ascending.  A deque, NOT a list: the
        # ring-buffer trim on a full list costs a full copy per append
        # (O(cap) on every filer mutation once the buffer fills)
        self._entries: deque = deque()
        self._flushing: list = []  # batch being persisted, still readable
        self._lock = threading.Lock()
        self._flush_gate = threading.Lock()  # serializes flushers
        self._last_flushed_ns = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, ts_ns: int, payload) -> None:
        with self._lock:
            entries = self._entries
            entries.append((ts_ns, payload))
            if self.max_entries is not None \
                    and len(entries) > self.max_entries:
                entries.popleft()

    def read_since(self, since_ns: int = 0) -> list:
        """In-RAM entries strictly newer than since_ns.  Entries mid-flush
        stay visible until the flush function has persisted them, so a
        cursoring subscriber never observes a gap."""
        with self._lock:
            return [p for ts, p in self._flushing + list(self._entries)
                    if ts > since_ns]

    @property
    def last_flushed_ns(self) -> int:
        return self._last_flushed_ns

    def flush(self) -> int:
        """Persist and drop everything buffered; returns entry count."""
        with self._flush_gate:
            with self._lock:
                if not self._entries:
                    return 0
                batch, self._entries = list(self._entries), deque()
                self._flushing = batch
            try:
                if self.flush_fn is not None:
                    self.flush_fn(batch[0][0], batch[-1][0],
                                  [p for _, p in batch])
                self._last_flushed_ns = batch[-1][0]
            except Exception:
                with self._lock:  # persist failed: keep entries buffered
                    self._entries = deque(batch + list(self._entries))
                    self._flushing = []
                raise
            with self._lock:
                self._flushing = []
            return len(batch)

    # -- background flusher (filer_notify loopFlush analogue) ---------------
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.flush()
        except Exception:
            pass  # entries stay buffered; caller is shutting down anyway

    def _loop(self):
        while not self._stop.wait(self.flush_interval):
            try:
                self.flush()
            except Exception:
                # transient persist failure: entries were re-queued by
                # flush(); keep the flusher alive for the next interval
                pass
