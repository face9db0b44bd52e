"""Slab pool for the EC device path: leased transfer and compute slots,
and ref-counted resident content slabs.

Counterpart of seaweedfs_tpu/ops/device_pool.py.  A dispatch layer that
allocates fresh buffers per batch spends its time in the allocator and in
page-locking host memory; here every buffer the device path touches comes
from a pool of fixed-shape slabs, so a steady state performs no per-batch
allocation and a second encode of the same geometry re-leases the first
one's buffers.

Two kinds of slab, one accounting domain:

  leases    fixed-shape slots keyed by an opaque caller key (shape, dtype,
            placement).  `lease()` hands out a free slab of the key or
            builds one with the caller's factory (pinned host staging
            buffers, device input rings, parity output rings); `release()`
            returns it for reuse.
  residents ref-counted content slabs (`acquire_resident`): device uploads
            that outlive one call, so repeated degraded reads against the
            same survivor stack decode from device memory instead of
            crossing the link again.  A resident with refs == 0 stays
            cached until the byte cap evicts it.

`WEED_EC_DEVICE_POOL_MB` caps the bytes the pool retains for idle slabs
(free leases and unreferenced residents); leased or referenced slabs are
never evicted, so the cap bounds retention, not admission.  Idle slabs
leave least recently used first, free leases and idle residents alike.
The JAX package's pool evicts every free lease before any idle resident,
so once degraded reads have filled its cap with residents, each released
lease is dropped at once and the next batch allocates again; the port
does not copy that (ROADMAP §3, R2).  The default,
1024, is above the JAX package's 256 because here the pool also holds the
pinned host side: one encode at the default geometry (64 MiB batches,
WEED_EC_DEVICE_INFLIGHT=3) leases ~0.7 GiB of pinned staging, device
input and output rings and pinned parity buffers, and a repeat encode
should find all of them.  Payloads are whatever the factories build
(pinned host tensors, CUDA tensors); the pool owns identity, reuse and
accounting.  Device labels are `str(torch.device)`; None is the host.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from typing import Any, Callable, Optional

from ..stats import metrics as _stats

DEFAULT_POOL_MB = 1024


def _cap_bytes() -> int:
    """Retention cap, re-read per operation (tests and daemons flip the
    knob without re-importing)."""
    mb = os.environ.get("WEED_EC_DEVICE_POOL_MB", "")
    try:
        return int(float(mb) * (1 << 20)) if mb else DEFAULT_POOL_MB << 20
    except ValueError:
        return DEFAULT_POOL_MB << 20


class Lease:
    """One leased slab.  `payload` is what the factory built; a caller
    may swap it while holding the lease and the swap travels back into
    the pool on release.  `device` is the placement label the slab was
    leased for, part of its free-list identity: a slab leased for one
    device is never handed to a caller staging for another."""

    __slots__ = ("key", "payload", "nbytes", "device", "last_used")

    def __init__(self, key, payload, nbytes: int, device=None):
        self.key = key
        self.payload = payload
        self.nbytes = nbytes
        self.device = device
        self.last_used = 0


class _Resident:
    __slots__ = ("key", "payload", "nbytes", "refs", "last_used")

    def __init__(self, key, payload, nbytes: int):
        self.key = key
        self.payload = payload
        self.nbytes = nbytes
        self.refs = 0
        self.last_used = 0


class DevicePool:
    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[Any, list[Lease]] = {}   # key -> idle leases
        self._free_order: list[Lease] = []        # LRU over idle leases
        self._residents: dict[Any, _Resident] = {}
        self._leased_bytes = 0
        self._free_bytes = 0
        self._resident_bytes = 0
        self._idle_resident_bytes = 0             # of refs == 0 residents
        self._leased_count = 0
        # use order of idle slabs: a release stamps a lease, an acquire
        # stamps a resident; eviction takes the lowest stamp first
        self._uses = itertools.count(1)
        # monotonic counters
        self.allocs = 0
        self.lease_hits = 0
        self.resident_hits = 0
        self.resident_misses = 0
        self.evictions = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # per-device breakdowns (label -> bytes): slab residency from the
        # lease accounting, link traffic from note_h2d / note_d2h
        self._dev_bytes: dict[str, int] = {}
        self._dev_h2d: dict[str, int] = {}
        self._dev_d2h: dict[str, int] = {}
        self._evictions_published = 0
        # occupancy telemetry: the peak bytes ever held, and the wall time
        # spent at >= 95% of that peak (a pool pinned at its watermark
        # asks for a larger WEED_EC_DEVICE_POOL_MB or a smaller batch)
        self._hwm_bytes = 0
        self._hwm_seconds = 0.0
        self._occ_ts = time.monotonic()
        self._occ_bytes = 0

    # -- transfer / compute slots -------------------------------------

    @staticmethod
    def _dev_label(device) -> str:
        return "host" if device is None else str(device)

    def lease(self, key, factory: Callable[[], Any], nbytes: int,
              device=None) -> Lease:
        """A slab for `(key, device)`: a previously released one, else
        `factory()`, which runs outside the lock (allocation may be slow
        and may re-enter the pool)."""
        bucket_key = (key, self._dev_label(device))
        with self._lock:
            bucket = self._free.get(bucket_key)
            if bucket:
                ls = bucket.pop()
                self._free_order.remove(ls)
                self._free_bytes -= ls.nbytes
                self._leased_bytes += ls.nbytes
                self._leased_count += 1
                self.lease_hits += 1
                self._publish()
                return ls
        payload = factory()
        ls = Lease(bucket_key, payload, nbytes, self._dev_label(device))
        with self._lock:
            self.allocs += 1
            self._leased_bytes += nbytes
            self._dev_bytes[ls.device] = \
                self._dev_bytes.get(ls.device, 0) + nbytes
            self._leased_count += 1
            self._publish()
        return ls

    def release(self, lease: Lease):
        with self._lock:
            self._leased_bytes -= lease.nbytes
            self._leased_count -= 1
            lease.last_used = next(self._uses)
            self._free.setdefault(lease.key, []).append(lease)
            self._free_order.append(lease)
            self._free_bytes += lease.nbytes
            self._evict_locked()
            self._publish()

    def discard(self, lease: Lease):
        """Release without retaining (the slab's geometry won't recur)."""
        with self._lock:
            self._leased_bytes -= lease.nbytes
            self._leased_count -= 1
            self._drop_dev_bytes_locked(lease)
            self._publish()

    def _drop_dev_bytes_locked(self, lease: Lease):
        dev = lease.device or "host"
        left = self._dev_bytes.get(dev, 0) - lease.nbytes
        if left > 0:
            self._dev_bytes[dev] = left
        else:
            self._dev_bytes.pop(dev, None)

    # -- ref-counted resident content slabs ---------------------------

    def acquire_resident(self, key, factory: Callable[[], Any],
                         nbytes: int) -> Any:
        """The resident payload for `key`, built by `factory()` on a miss.
        Pairs with `release_resident`; the slab survives refs == 0 (the
        next degraded read against the same survivor stack skips the
        upload) until the byte cap evicts it."""
        with self._lock:
            res = self._residents.get(key)
            if res is not None:
                self._ref_locked(res)
                res.last_used = next(self._uses)
                self.resident_hits += 1
                self._publish()
                return res.payload
        payload = factory()
        with self._lock:
            res = self._residents.get(key)
            if res is None:  # the first writer wins; duplicates dropped
                res = _Resident(key, payload, nbytes)
                self._residents[key] = res
                self._resident_bytes += nbytes
                self._idle_resident_bytes += nbytes  # until _ref_locked
                self.resident_misses += 1
                self.allocs += 1
            else:
                self.resident_hits += 1
            self._ref_locked(res)
            res.last_used = next(self._uses)
            self._evict_locked()
            self._publish()
            return res.payload

    def release_resident(self, key, drop: bool = False):
        """Drop one reference to `key`.  With `drop`, a resident left with
        no references leaves the pool at once instead of idling until the
        byte cap evicts it: its content will never be asked for again
        (the read cache's HBM tier keys each upload by a fresh
        generation)."""
        with self._lock:
            res = self._residents.get(key)
            if res is not None and res.refs > 0:
                res.refs -= 1
                if drop and res.refs == 0:
                    del self._residents[key]
                    self._resident_bytes -= res.nbytes
                elif res.refs == 0:
                    self._idle_resident_bytes += res.nbytes
            self._publish()

    def _ref_locked(self, res: _Resident):
        if res.refs == 0:
            self._idle_resident_bytes -= res.nbytes
        res.refs += 1

    def residents_under(self, prefix: tuple) -> dict:
        """{key: (refs, nbytes)} of the residents whose tuple key starts
        with `prefix`."""
        n = len(prefix)
        with self._lock:
            return {k: (r.refs, r.nbytes) for k, r in self._residents.items()
                    if isinstance(k, tuple) and k[:n] == prefix}

    # -- eviction / accounting ----------------------------------------

    def _evict_locked(self):
        """Drop idle bytes (free leases and refs == 0 residents, least
        recently used first) until under the cap."""
        cap = _cap_bytes()
        idle = self._free_bytes + self._idle_resident_bytes
        if idle <= cap:
            return  # the common case: no sort of the idle residents
        residents = sorted(
            (r for r in self._residents.values() if r.refs == 0),
            key=lambda r: r.last_used)
        while idle > cap and (self._free_order or residents):
            if residents and (not self._free_order or
                              residents[0].last_used <
                              self._free_order[0].last_used):
                v = residents.pop(0)
                del self._residents[v.key]
                self._resident_bytes -= v.nbytes
                self._idle_resident_bytes -= v.nbytes
                idle -= v.nbytes
            else:
                ls = self._free_order.pop(0)
                self._free[ls.key].remove(ls)
                if not self._free[ls.key]:
                    del self._free[ls.key]
                self._free_bytes -= ls.nbytes
                self._drop_dev_bytes_locked(ls)
                idle -= ls.nbytes
            self.evictions += 1

    def note_h2d(self, nbytes: int, device=None):
        dev = self._dev_label(device)
        with self._lock:
            self.h2d_bytes += nbytes
            self._dev_h2d[dev] = self._dev_h2d.get(dev, 0) + nbytes
        _stats.EcDeviceH2dBytesCounter.labels(dev).inc(nbytes)

    def note_d2h(self, nbytes: int, device=None):
        dev = self._dev_label(device)
        with self._lock:
            self.d2h_bytes += nbytes
            self._dev_d2h[dev] = self._dev_d2h.get(dev, 0) + nbytes
        _stats.EcDeviceD2hBytesCounter.labels(dev).inc(nbytes)

    def _note_occupancy_locked(self):
        """Advance the watermark clock (lock held): the time since the last
        byte change is charged to the previous occupancy level, so
        `hwm_seconds` is exact piecewise accounting, not sampling."""
        now = time.monotonic()
        if self._hwm_bytes > 0 and \
                self._occ_bytes >= 0.95 * self._hwm_bytes:
            self._hwm_seconds += now - self._occ_ts
        self._occ_ts = now
        self._occ_bytes = (self._free_bytes + self._leased_bytes
                           + self._resident_bytes)
        if self._occ_bytes > self._hwm_bytes:
            self._hwm_bytes = self._occ_bytes

    def _publish(self):
        """Mirror the pool's state into the Prometheus families (lock
        held)."""
        self._note_occupancy_locked()
        _stats.DevicePoolHwmBytesGauge.set(self._hwm_bytes)
        _stats.DevicePoolHwmSecondsGauge.set(self._hwm_seconds)
        for dev, nbytes in self._dev_bytes.items():
            _stats.DevicePoolDeviceBytesGauge.labels(dev).set(nbytes)
        _stats.DevicePoolSlotsGauge.labels("free").set(
            len(self._free_order))
        _stats.DevicePoolSlotsGauge.labels("leased").set(self._leased_count)
        _stats.DevicePoolSlotsGauge.labels("resident").set(
            len(self._residents))
        _stats.DevicePoolBytesGauge.set(
            self._free_bytes + self._leased_bytes + self._resident_bytes)
        if self.evictions > self._evictions_published:
            _stats.DevicePoolEvictionsCounter.inc(
                self.evictions - self._evictions_published)
            self._evictions_published = self.evictions

    def snapshot(self) -> dict:
        # the QoS device lanes gate dispatch into this pool's slots, so
        # their state belongs in the same snapshot
        from ..qos.lanes import LANES

        with self._lock:
            self._note_occupancy_locked()
            return {
                "hwm_bytes": self._hwm_bytes,
                "hwm_seconds": round(self._hwm_seconds, 3),
                "free_slots": len(self._free_order),
                "leased_slots": self._leased_count,
                "resident_slabs": len(self._residents),
                "bytes": self._free_bytes + self._leased_bytes
                + self._resident_bytes,
                "allocs": self.allocs,
                "lease_hits": self.lease_hits,
                "resident_hits": self.resident_hits,
                "resident_misses": self.resident_misses,
                "evictions": self.evictions,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "devices": {
                    dev: {
                        "bytes": self._dev_bytes.get(dev, 0),
                        "h2d_bytes": self._dev_h2d.get(dev, 0),
                        "d2h_bytes": self._dev_d2h.get(dev, 0),
                    }
                    for dev in sorted(set(self._dev_bytes)
                                      | set(self._dev_h2d)
                                      | set(self._dev_d2h))
                },
                "lanes": LANES.snapshot(),
            }


_pool: Optional[DevicePool] = None
_pool_lock = threading.Lock()


def get_pool() -> DevicePool:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = DevicePool()
    return _pool


def lease_tensor(pool: DevicePool, tag: str, shape, dtype, device=None,
                 pinned: bool = False) -> Lease:
    """A tensor slab of `shape` and `dtype` leased from `pool`: on `device`
    (a torch device), or on the host when device is None, page-locked when
    `pinned` (a host buffer that feeds a card, so copies to and from it
    run asynchronously)."""
    import torch

    shape = tuple(shape)
    nbytes = math.prod(shape) * dtype.itemsize
    if device is None:
        return pool.lease((tag, shape, dtype, pinned),
                          lambda: torch.zeros(shape, dtype=dtype,
                                              pin_memory=pinned), nbytes)
    return pool.lease((tag, shape, dtype),
                      lambda: torch.empty(shape, dtype=dtype, device=device),
                      nbytes, device=device)


def reset_pool():
    """Drop the process pool (tests; frees any retained device memory)."""
    global _pool
    with _pool_lock:
        _pool = None
