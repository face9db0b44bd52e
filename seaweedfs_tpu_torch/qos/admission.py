"""Weighted-fair admission control for the daemon front ends.

Replaces the flat ``WEED_VS_MAX_INFLIGHT`` shed gate with per-class
bounded queues drained by deficit-round-robin, per-tenant token
buckets, and class-aware load shedding:

* every request is admitted immediately while in-flight work is under
  the limit; beyond it, waiters park in their class queue and a DRR
  scheduler (quantum = class weight) picks the next one on each
  release — interactive drains ~weights[interactive] requests for
  every one background request under full backlog;
* queues are bounded per class, and classes additionally shed at a
  total-occupancy watermark — background sheds first (50 % of total
  queue capacity), standard at 85 %, interactive only when its own
  queue is full;
* per-tenant token buckets (WEED_QOS_TENANT_RPS/_BURST) bound any one
  access key / collection before it reaches the queues.

All time flows through injectable ``now`` seams (the repo's fake-clock
convention from rpc/policy.py), so the scheduler and buckets are
deterministic under test with zero sleeps.

Counterpart of seaweedfs_tpu/qos/admission.py.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from ..stats import metrics as _stats
from . import classify
from . import shm as _shm
from .classify import BACKGROUND, CLASSES, INTERACTIVE, STANDARD


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class TokenBucket:
    """Classic token bucket with an injectable clock.  ``rate <= 0``
    means unlimited (every take succeeds)."""

    __slots__ = ("rate", "burst", "tokens", "t_last", "denied", "taken",
                 "now")

    def __init__(self, rate: float, burst: float,
                 now=time.monotonic):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.t_last: Optional[float] = None
        self.denied = 0
        self.taken = 0
        self.now = now

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            self.taken += 1
            return True
        t = self.now()
        if self.t_last is None:
            self.t_last = t
        self.tokens = min(self.burst,
                          self.tokens + (t - self.t_last) * self.rate)
        self.t_last = t
        if self.tokens >= n:
            self.tokens -= n
            self.taken += 1
            return True
        self.denied += 1
        return False


class TenantBuckets:
    """Lazily-created per-tenant buckets, bounded to the most recently
    seen ``cap`` tenants so an access-key scan can't grow the map
    unboundedly."""

    def __init__(self, rate_env: str = "WEED_QOS_TENANT_RPS",
                 burst_env: str = "WEED_QOS_TENANT_BURST",
                 cap: int = 1024, now=time.monotonic):
        self.rate_env = rate_env
        self.burst_env = burst_env
        self.cap = cap
        self.now = now
        self._buckets: "Dict[str, TokenBucket]" = {}
        self._lock = threading.Lock()

    def try_take(self, tenant: str, n: float = 1.0) -> bool:
        if not tenant:
            return True  # unattributed traffic is bounded by the queues
        rate = _env_float(self.rate_env, 0.0)
        if rate <= 0:
            return True
        s = _shm.ACTIVE
        if s is not None:
            # fleet-wide bucket: every prefork worker draws from one
            # shared-memory slot, so the rate stays per-tenant rather
            # than silently becoming per-tenant-per-worker
            return s.tenant_take(
                "t:" + tenant, rate,
                _env_float(self.burst_env, max(rate, 1.0)), n)
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                if len(self._buckets) >= self.cap:
                    self._buckets.pop(next(iter(self._buckets)))
                b = TokenBucket(rate, _env_float(self.burst_env,
                                                 max(rate, 1.0)),
                                now=self.now)
                self._buckets[tenant] = b
            b.rate = rate  # live knob: tests flip it mid-process
            return b.try_take(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"tenants": len(self._buckets),
                    "denied": sum(b.denied
                                  for b in self._buckets.values()),
                    "taken": sum(b.taken
                                 for b in self._buckets.values())}


def class_weights() -> Dict[str, int]:
    """WEED_QOS_WEIGHTS="interactive=8,standard=3,background=1" —
    weights clamp to >= 1 so every class stays work-conserving."""
    weights = {INTERACTIVE: 8, STANDARD: 3, BACKGROUND: 1}
    spec = os.environ.get("WEED_QOS_WEIGHTS", "")
    for part in spec.split(",") if spec else ():
        k, _, v = part.partition("=")
        k = k.strip()
        if k in weights:
            try:
                weights[k] = max(1, int(v))
            except ValueError:
                pass
    return weights


class _ShmDeficit:
    """Mapping view over one service's shared DRR deficit slots.
    Caller holds that service's cross-process drr lock for the whole
    pop."""

    __slots__ = ("_s", "_svc")

    def __init__(self, s: "_shm.QosShm", service: str = ""):
        self._s = s
        self._svc = service

    def __getitem__(self, cls: str) -> float:
        return self._s.drr_get(cls, service=self._svc)

    def __setitem__(self, cls: str, value: float):
        self._s.drr_set(cls, value, service=self._svc)


class DrrQueue:
    """Deficit-round-robin over the per-class waiter queues.  Unit-cost
    items; each visit to a backlogged class tops its deficit up by the
    class quantum (= weight) and drains while the deficit lasts.  Not
    thread-safe — the owning gate serializes access under its lock."""

    def __init__(self, weights: Optional[Dict[str, int]] = None,
                 service: str = ""):
        self.queues: Dict[str, deque] = {c: deque() for c in CLASSES}
        self.weights = dict(weights) if weights else class_weights()
        self.deficit: Dict[str, float] = {c: 0.0 for c in CLASSES}
        self.service = service  # selects this queue's shared DRR slots
        self._i = 0

    def push(self, cls: str, item) -> None:
        self.queues[cls].append(item)

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def depth(self, cls: str) -> int:
        return len(self.queues[cls])

    def pop(self):
        """Next item under DRR, or None when all queues are empty."""
        if not len(self):
            return None
        s = _shm.ACTIVE
        if s is None or s.service_index(self.service) < 0:
            return self._pop_from(self.deficit)
        # prefork: deficits live in shared memory (per service, so
        # combined daemons don't cross-couple) and weight fidelity
        # holds across the whole worker fleet, not per process
        with s.drr_lock(self.service):
            return self._pop_from(_ShmDeficit(s, self.service))

    def _pop_from(self, deficit):
        n = len(CLASSES)
        # weights >= 1 guarantee a backlogged class dispatches on its
        # visit, so two passes always yield an item
        for _ in range(2 * n):
            cls = CLASSES[self._i % n]
            q = self.queues[cls]
            if not q:
                # an idle class must not bank deficit for later bursts
                deficit[cls] = 0.0
                self._i += 1
                continue
            if deficit[cls] < 1.0:
                deficit[cls] = deficit[cls] + self.weights.get(cls, 1)
            deficit[cls] = deficit[cls] - 1.0
            item = q.popleft()
            if not q:
                deficit[cls] = 0.0
                self._i += 1
            elif deficit[cls] < 1.0:
                self._i += 1
            return item
        return None  # unreachable with weights >= 1


class _Waiter:
    __slots__ = ("cls", "event", "cancelled")

    def __init__(self, cls: str):
        self.cls = cls
        self.event = threading.Event()
        self.cancelled = False


class _Release:
    """Idempotent release handle so a ``finally: release()`` racing an
    exception path can't double-free an admission slot."""

    __slots__ = ("_gate", "_cls", "_done")

    def __init__(self, gate: "AdmissionGate", cls: str):
        self._gate = gate
        self._cls = cls
        self._done = False

    def __call__(self):
        if not self._done:
            self._done = True
            if self._gate is not None:
                self._gate._release(self._cls)


_NOOP_RELEASE = _Release(None, STANDARD)
_NOOP_RELEASE._done = True

# shed watermarks: fraction of TOTAL queue capacity at which a class
# stops queuing — background gives way first, interactive last
_SHED_WATERMARK = {BACKGROUND: 0.50, STANDARD: 0.85, INTERACTIVE: 1.01}

_QUEUE_ENV = {INTERACTIVE: ("WEED_QOS_QUEUE_INTERACTIVE", 64),
              STANDARD: ("WEED_QOS_QUEUE_STANDARD", 32),
              BACKGROUND: ("WEED_QOS_QUEUE_BACKGROUND", 8)}

class AdmissionGate:
    """Per-daemon front-end admission: weighted-fair queues over a
    bounded in-flight limit.

    ``limit_env`` is read live on every admit (tests flip it
    mid-process); ``fallback_env`` names the deprecated flat knob
    (``WEED_VS_MAX_INFLIGHT``) honored when the new one is unset.
    Limit <= 0 disables queuing entirely — the gate still classifies
    and counts, so /debug/qos and the pacer signal stay live."""

    def __init__(self, service: str, limit_env: str = "",
                 fallback_env: str = "", default_limit: int = 0,
                 now=time.monotonic):
        self.service = service
        self.limit_env = limit_env
        self.fallback_env = fallback_env
        self.default_limit = int(default_limit)
        self.now = now
        self._lock = threading.Lock()
        self._drr = DrrQueue(service=service)
        self.inflight: Dict[str, int] = {c: 0 for c in CLASSES}
        self.admitted: Dict[str, int] = {c: 0 for c in CLASSES}
        self.queued: Dict[str, int] = {c: 0 for c in CLASSES}
        self.shed: Dict[str, int] = {c: 0 for c in CLASSES}
        self.tenants = TenantBuckets(now=now)

    # -- knobs (live reads) ---------------------------------------------------
    def effective_limit(self) -> int:
        for env in (self.limit_env, self.fallback_env):
            if env:
                raw = os.environ.get(env)
                if raw is not None and raw != "":
                    try:
                        return int(raw)
                    except ValueError:
                        pass
        return self.default_limit

    def queue_cap(self, cls: str) -> int:
        env, default = _QUEUE_ENV[cls]
        return max(0, _env_int(env, default))

    def total_queue_cap(self) -> int:
        return sum(self.queue_cap(c) for c in CLASSES)

    # -- admission ------------------------------------------------------------
    def admit(self, cls: Optional[str] = None, tenant: Optional[str] = None,
              wait: bool = True):
        """Admit one request; returns a release callable.  Raises
        RpcError 503 (with a jittered Retry-After) when shed."""
        # deferred: rpc.http_rpc imports this package for header
        # propagation, so the dependency must stay one-way at load time
        from ..rpc.http_rpc import RpcError, current_deadline

        cls = classify.normalize(cls if cls is not None
                                 else classify.current_class())
        if tenant is None:
            tenant = classify.current_tenant()
        if not self.tenants.try_take(tenant):
            self.shed[cls] += 1
            self._mirror(cls)
            _stats.QosTenantThrottledCounter.labels(self.service,
                                                    cls).inc()
            self._count(cls, "shed_tenant")
            raise RpcError(
                f"tenant {tenant!r} over its {cls} request rate", 429,
                headers={"Retry-After": classify.retry_after(1, 3)})
        limit = self.effective_limit()
        if limit <= 0:
            self.admitted[cls] += 1
            self._mirror(cls)
            self._count(cls, "admit")
            return _NOOP_RELEASE
        waiter = None
        with self._lock:
            if self.total_inflight() < limit and not len(self._drr):
                self.inflight[cls] += 1
                self.admitted[cls] += 1
            else:
                waiter = self._try_enqueue(cls, wait)
        if waiter is None:
            self._count(cls, "admit")
            self._gauges(cls)
            return _Release(self, cls)
        # parked: wait for a release to dispatch us (bounded by the
        # queue timeout and any propagated deadline)
        t0 = self.now()
        timeout = _env_float("WEED_QOS_QUEUE_TIMEOUT", 5.0)
        dl = current_deadline()
        if dl is not None:
            timeout = max(0.0, min(timeout, dl - time.time()))
        dispatched = waiter.event.wait(timeout)
        _stats.QosQueueWaitHistogram.labels(cls).observe(
            max(0.0, self.now() - t0))
        if dispatched:
            self.admitted[cls] += 1
            self._count(cls, "admit")
            self._gauges(cls)
            return _Release(self, cls)
        with self._lock:
            if waiter.event.is_set():
                # dispatch raced the timeout: the slot is ours after all
                self.admitted[cls] += 1
            else:
                waiter.cancelled = True
                self.queued[cls] -= 1
                waiter = None
        if waiter is not None:
            self._count(cls, "admit")
            self._gauges(cls)
            return _Release(self, cls)
        self.shed[cls] += 1
        self._count(cls, "shed_timeout")
        self._gauges(cls)
        raise RpcError(
            f"{self.service} {cls} queue wait exceeded", 503,
            headers={"Retry-After": classify.retry_after(1, 3)})

    def _try_enqueue(self, cls: str, wait: bool):
        """Under self._lock: park a waiter, or raise the shed error."""
        from ..rpc.http_rpc import RpcError

        cap = self.queue_cap(cls)
        total = len(self._drr)
        watermark = _SHED_WATERMARK[cls] * self.total_queue_cap()
        if (not wait or self._drr.depth(cls) >= cap
                or total >= watermark):
            self.shed[cls] += 1
            self._count(cls, "shed_queue")
            self._gauges(cls)
            raise RpcError(
                f"{self.service} overloaded: {cls} queue full", 503,
                headers={"Retry-After": classify.retry_after(1, 3)})
        waiter = _Waiter(cls)
        self._drr.push(cls, waiter)
        self.queued[cls] += 1
        self._mirror(cls)
        self._count(cls, "queued")
        return waiter

    def _release(self, cls: str):
        with self._lock:
            self.inflight[cls] = max(0, self.inflight[cls] - 1)
            self._dispatch_locked()
        self._gauges(cls)

    def _dispatch_locked(self):
        limit = self.effective_limit()
        while self.total_inflight() < limit:
            w = self._drr.pop()
            if w is None:
                return
            if w.cancelled:
                continue
            self.queued[w.cls] -= 1
            self.inflight[w.cls] += 1
            self._mirror(w.cls)
            w.event.set()

    def _mirror(self, cls: str):
        """Publish this gate's counters for `cls` to its own
        (service, worker) row — single writer, so no lock.  Rows are
        partitioned by service so the gates of a combined daemon
        (weed.py server) never clobber each other, and each gate's
        limit is enforced against its OWN service's fleet sum rather
        than the cross-service total."""
        s = _shm.ACTIVE
        if s is None:
            return
        for field in ("inflight", "queued", "admitted", "shed"):
            s.gate_set(self.service, cls, field,
                       getattr(self, field).get(cls, 0))

    def _fleet_total(self, field: str, local: Dict[str, int]) -> int:
        s = _shm.ACTIVE
        if s is not None and s.service_index(self.service) >= 0:
            return s.gate_total(field, service=self.service)
        return sum(local.values())

    # -- introspection --------------------------------------------------------
    def total_inflight(self) -> int:
        """This service's fleet-wide in-flight when the shared segment
        is active (prefork), else this process's sum — the admission
        limit is enforced against this value, so limits are fleet-wide
        per service (never coupled across a combined daemon's gates)."""
        return self._fleet_total("inflight", self.inflight)

    def total_queued(self) -> int:
        return self._fleet_total("queued", self.queued)

    def occupancy(self) -> float:
        """(in-flight + queued) / limit, clamped to [0, 1] — the
        foreground-load signal the maintenance pacer consumes."""
        limit = self.effective_limit()
        if limit <= 0:
            return 0.0
        return min(1.0, (self.total_inflight() + self.total_queued())
                   / float(limit))

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "service": self.service,
                "limit": self.effective_limit(),
                "weights": dict(self._drr.weights),
                "inflight": dict(self.inflight),
                "queued": dict(self.queued),
                "admitted": dict(self.admitted),
                "shed": dict(self.shed),
                "queue_caps": {c: self.queue_cap(c) for c in CLASSES},
                "occupancy": round(self.occupancy(), 4),
                "tenants": self.tenants.snapshot(),
            }
            if _shm.ACTIVE is not None:
                snap["shm"] = _shm.ACTIVE.snapshot()
            return snap

    def _count(self, cls: str, outcome: str):
        _stats.QosRequestsCounter.labels(self.service, cls,
                                         outcome).inc()

    def _gauges(self, cls: str):
        _stats.QosInflightGauge.labels(self.service, cls).set(
            self.inflight[cls])
        _stats.QosQueueDepthGauge.labels(self.service, cls).set(
            max(0, self.queued[cls]))
        self._mirror(cls)
        if _shm.ACTIVE is not None:
            _stats.QosSharedGateOccupancyGauge.labels(self.service).set(
                round(self.occupancy(), 4))
