"""Device telemetry of the EC pipeline: the batch timeline and the cost
table of each parity-step geometry.

Counterpart of the device part of seaweedfs_tpu/profiling.py (:298-345).
A batch's latency is what the card measured between two CUDA events, from
the dispatch of its H2D copy to its parity being ready on the host; the
caller passes it in seconds.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

_tl_lock = threading.Lock()
_DEVICE_TIMELINE: "deque[dict]" = deque(maxlen=512)
_KERNEL_COST: dict[str, dict] = {}


def record_device_batch(latency_s: float, units: int = 0, k: int = 0,
                        devices: int = 1):
    """One EC device batch completed after `latency_s` seconds (dispatch
    to parity ready) over `devices` devices, with `units` chunks of `k`
    data rows."""
    with _tl_lock:
        _DEVICE_TIMELINE.append({
            "ts": round(time.time(), 3),
            "dispatch_ready_ms": round(latency_s * 1e3, 3),
            "units": units, "k": k, "devices": devices})


def record_kernel_cost(geometry: str, flops: float, bytes_accessed: float,
                       extra: Optional[dict] = None):
    """The analytic cost of one step geometry: GF(2^8) multiply-adds and
    the device bytes it reads and writes."""
    entry = {"flops": float(flops), "bytes_accessed": float(bytes_accessed)}
    if extra:
        entry.update(extra)
    with _tl_lock:
        _KERNEL_COST[geometry] = entry


def device_timeline() -> dict:
    """Recent batch latencies, per-geometry step cost, and the device
    pool's snapshot (when a pool exists)."""
    from .ops import device_pool

    pool = device_pool._pool  # do not materialize a pool just to report
    with _tl_lock:
        timeline = list(_DEVICE_TIMELINE)
        cost = {k: dict(v) for k, v in _KERNEL_COST.items()}
    return {"timeline": timeline, "kernel_cost": cost,
            "pool": pool.snapshot() if pool is not None else {}}


def reset_device_telemetry():
    """Drop the timeline and the cost table."""
    with _tl_lock:
        _DEVICE_TIMELINE.clear()
        _KERNEL_COST.clear()
