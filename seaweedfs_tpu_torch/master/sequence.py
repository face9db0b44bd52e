"""File-id sequencers (weed/sequence/): monotonically increasing needle keys.

MemorySequencer mirrors memory_sequencer.go (master-local counter, bumped by
heartbeat max_file_key); SnowflakeSequencer mirrors snowflake_sequencer.go
(time-ordered 64-bit ids for multi-master setups without shared state).

The port's own copy of seaweedfs_tpu/master/sequence.py.
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_batch(self, count: int) -> int:
        """Reserve `count` ids; returns the first."""
        with self._lock:
            first = self._counter
            self._counter += count
            return first

    def set_max(self, seen: int):
        with self._lock:
            if seen >= self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit node id | 12-bit sequence."""

    EPOCH_MS = 1_577_836_800_000  # 2020-01-01

    def __init__(self, node_id: int):
        if not 0 <= node_id < 1024:
            raise ValueError("snowflake node id must be in [0, 1024)")
        self.node_id = node_id
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_batch(self, count: int) -> int:
        with self._lock:
            first = None
            for _ in range(count):
                now = int(time.time() * 1000) - self.EPOCH_MS
                if now == self._last_ms:
                    self._seq = (self._seq + 1) & 0xFFF
                    if self._seq == 0:
                        while now <= self._last_ms:
                            now = int(time.time() * 1000) - self.EPOCH_MS
                else:
                    self._seq = 0
                self._last_ms = now
                value = (now << 22) | (self.node_id << 12) | self._seq
                if first is None:
                    first = value
            return first

    def set_max(self, seen: int):
        pass  # time-ordered; no catch-up needed
