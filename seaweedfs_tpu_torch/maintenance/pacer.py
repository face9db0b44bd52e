"""Byte-rate pacer for background maintenance I/O.

A token bucket that debits every chunk a maintenance worker reads (or
fetches from a peer) and sleeps once the bucket runs dry — so a deep
scrub or vacuum never streams faster than the configured rate.  The
effective rate additionally backs off against *foreground* load: the
volume server wires `load_fn` to its request shedder (in-flight /
limit), so a busy front end squeezes maintenance down to a floor
fraction instead of competing with user reads.

`throttle(nbytes)` is the hook `storage.tools.shard_file_crc32c` and
`verify_shard_files` accept, and what the deep-scrub reader calls per
span — one signature everywhere.

The port's own copy of seaweedfs_tpu/maintenance/pacer.py.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..stats import metrics


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class BytePacer:
    """Token-bucket byte-rate limiter with foreground-load backoff."""

    def __init__(self, rate_bytes: Optional[float] = None,
                 load_fn: Optional[Callable[[], float]] = None,
                 floor_frac: Optional[float] = None,
                 burst_seconds: float = 0.25):
        self._rate_bytes = rate_bytes
        self.load_fn = load_fn
        self._floor_frac = floor_frac
        self.burst_seconds = burst_seconds
        self._lock = threading.Lock()
        self._bucket = 0.0
        self._last = None  # lazily initialised on first throttle
        self.throttled_seconds = 0.0
        self.paced_bytes = 0
        # injectable for fake-clock tests (rpc.policy convention)
        self.sleep = time.sleep
        self.now = time.monotonic

    def base_rate(self) -> float:
        """Configured ceiling, bytes/second (WEED_MAINT_RATE_MB)."""
        if self._rate_bytes is not None:
            return float(self._rate_bytes)
        return _env_float("WEED_MAINT_RATE_MB", 32.0) * (1 << 20)

    def floor_frac(self) -> float:
        if self._floor_frac is not None:
            return float(self._floor_frac)
        return _env_float("WEED_MAINT_FLOOR", 0.1)

    def effective_rate(self) -> float:
        """Ceiling scaled down by foreground load (0..1), never below
        the floor fraction — maintenance always makes *some* progress
        so repairs cannot be starved forever."""
        rate = self.base_rate()
        if self.load_fn is not None:
            try:
                load = min(1.0, max(0.0, float(self.load_fn())))
            except Exception:
                load = 0.0
            rate *= max(self.floor_frac(), 1.0 - load)
        return max(1.0, rate)

    def throttle(self, nbytes: int):
        """Debit `nbytes`; sleep whatever the bucket cannot cover."""
        if nbytes <= 0:
            return
        rate = self.effective_rate()
        with self._lock:
            now = self.now()
            if self._last is None:
                self._last = now
                self._bucket = rate * self.burst_seconds
            self._bucket = min(rate * self.burst_seconds,
                               self._bucket + (now - self._last) * rate)
            self._last = now
            self._bucket -= nbytes
            debt = -self._bucket
            self.paced_bytes += nbytes
        metrics.MaintPacerRateGauge.set(rate)
        if debt > 0:
            delay = debt / rate
            self.throttled_seconds += delay
            self.sleep(delay)

    def snapshot(self) -> dict:
        return {"rate": round(self.effective_rate()),
                "base_rate": round(self.base_rate()),
                "paced_bytes": self.paced_bytes,
                "throttled_seconds": round(self.throttled_seconds, 3)}
