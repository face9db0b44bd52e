"""Priority device lanes for the EC pipeline.

Counterpart of seaweedfs_tpu/qos/lanes.py.  The device dispatch loops of
`parallel/batched_encode.py` and `maintenance/deep_scrub.py` push work a
batch at a time, so lane priority is enforced at batch boundaries:
background dispatchers (bulk encode, scrub re-encode) call
`DeviceLanes.background_checkpoint` before every device step and stall
while any foreground work (degraded-read decodes, wrapped in
`DeviceLanes.foreground`) is in flight.  A starvation floor
(WEED_QOS_BG_MAX_STALL_MS, default 2000) lets background work proceed once
it has waited that long, so a read storm paces a scrub instead of parking
it forever.

The clock is injectable (`self.now`); the condition variable wakes on
foreground exit, so tests never sleep.
"""

from __future__ import annotations

import os
import threading
import time

from ..stats import metrics as _stats
from . import classify

FOREGROUND = "foreground"
BACKGROUND = "background"


def _max_stall_seconds() -> float:
    try:
        ms = float(os.environ.get("WEED_QOS_BG_MAX_STALL_MS", "")
                   or 2000.0)
    except ValueError:
        ms = 2000.0
    return max(0.0, ms / 1000.0)


def lanes_enabled() -> bool:
    if not classify.enabled():
        return False
    return os.environ.get("WEED_QOS_LANES", "1") != "0"


class _FgCtx:
    __slots__ = ("lanes",)

    def __init__(self, lanes: "DeviceLanes"):
        self.lanes = lanes

    def __enter__(self):
        self.lanes._fg_enter()
        return self.lanes

    def __exit__(self, *exc):
        self.lanes._fg_exit()
        return False


class DeviceLanes:
    def __init__(self, now=time.monotonic):
        self.now = now
        self._cond = threading.Condition()
        self._fg_active = 0
        self.fg_batches = 0
        self.bg_batches = 0
        self.preemptions = 0
        self.bg_wait_seconds = 0.0

    def foreground(self) -> _FgCtx:
        """Wrap a foreground (degraded-read decode) device step; queued
        background batches yield until it exits."""
        return _FgCtx(self)

    def _fg_enter(self):
        with self._cond:
            self._fg_active += 1
            self.fg_batches += 1
        _stats.QosLaneActiveGauge.labels(FOREGROUND).set(self._fg_active)
        _stats.QosLaneBatchesCounter.labels(FOREGROUND).inc()

    def _fg_exit(self):
        with self._cond:
            self._fg_active = max(0, self._fg_active - 1)
            if self._fg_active == 0:
                self._cond.notify_all()
        _stats.QosLaneActiveGauge.labels(FOREGROUND).set(self._fg_active)

    def background_checkpoint(self) -> float:
        """Called by background dispatch loops before each device batch;
        blocks while foreground work is active (up to the starvation
        floor).  Returns the seconds waited."""
        if not lanes_enabled():
            return 0.0
        waited = 0.0
        with self._cond:
            if self._fg_active > 0:
                self.preemptions += 1
                _stats.QosLanePreemptionsCounter.inc()
                t0 = self.now()
                deadline = t0 + _max_stall_seconds()
                while self._fg_active > 0:
                    remaining = deadline - self.now()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                waited = max(0.0, self.now() - t0)
                self.bg_wait_seconds += waited
            self.bg_batches += 1
        if waited:
            _stats.QosLaneWaitSecondsCounter.inc(waited)
        _stats.QosLaneBatchesCounter.labels(BACKGROUND).inc()
        return waited

    def snapshot(self) -> dict:
        with self._cond:
            return {"enabled": lanes_enabled(),
                    "foreground_active": self._fg_active,
                    "foreground_batches": self.fg_batches,
                    "background_batches": self.bg_batches,
                    "preemptions": self.preemptions,
                    "background_wait_seconds":
                        round(self.bg_wait_seconds, 6)}

    def reset(self):
        """Zero the counters (the process-wide lanes outlive any test)."""
        with self._cond:
            self.fg_batches = 0
            self.bg_batches = 0
            self.preemptions = 0
            self.bg_wait_seconds = 0.0


# process-wide: one device, one pair of lanes
LANES = DeviceLanes()
