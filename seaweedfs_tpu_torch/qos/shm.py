"""Cross-process QoS state (prefork gateway workers).

With `WEED_HTTP_WORKERS=N` every gateway worker is its own interpreter,
so the per-process dicts in admission.py/quota.py would silently turn
"tenant X gets 100 rps" into "tenant X gets 100 rps *per worker*".
This module moves the cross-process-critical state into one
`multiprocessing.shared_memory` segment:

  * a hash-addressed tenant token-bucket table (integer micro-token
    arithmetic, `CLOCK_MONOTONIC` refill — system-wide on Linux, so
    every process refills against the same clock);
  * per-(service, class) DRR deficit slots, mutated only under the
    service's shared "drr" lock so weight fidelity holds across
    workers;
  * per-(service, worker) admission-gate rows (inflight/queued/
    admitted/shed per class).  Each row has exactly ONE writer — the
    owning gate in the owning worker — so row updates need no lock;
    fleet totals are a read-side sum over one service's rows.

Gate rows and DRR slots are partitioned by SERVICE (a small name
registry in the segment) because a combined `weed server` runs several
PreforkGroups against the one process-global segment, each numbering
its workers 1..N-1 independently: the volume group's worker 1 and the
filer group's worker 1 are different processes, and keying rows by
worker id alone would let them clobber each other — and would couple
every gate's admission limit to the cross-service fleet sum.

Cross-process mutual exclusion uses `fcntl` byte-range locks on a
sidecar lock file rather than `multiprocessing.Lock`: record locks work
between *unrelated* processes (the test harness attaches from fresh
interpreters, and respawned workers must re-acquire cleanly), which
SemLock-based locks cannot.  fcntl locks do not exclude threads of the
same process, so every byte range is paired with an in-process
`threading.Lock`.

Known (documented) slack: the admission limit itself is checked
per-worker against its service's fleet-wide row sum without a global
lock, so the fleet can transiently overshoot the limit by at most one
request per worker.  Tenant buckets and DRR deficits are exact.

Counterpart of seaweedfs_tpu/qos/shm.py.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import struct
import tempfile
import threading
import time
from contextlib import contextmanager
from multiprocessing import shared_memory
from typing import Optional

from . import classify

MAX_WORKERS = 32
MAX_SERVICES = 8
N_STRIPES = 16
TENANT_SLOTS = 1024
_SLOTS_PER_STRIPE = TENANT_SLOTS // N_STRIPES
MICRO = 1_000_000  # tokens are stored as integer micro-tokens

_MAGIC = 0x5153484D  # "QSHM"
_HDR = struct.Struct("<IIII")              # magic, version, nworkers, pad
_SLOT = struct.Struct("<QqQQQ")            # hash, micro_tokens, last_ns,
_FIELDS = ("inflight", "queued", "admitted", "shed")       # taken, denied
_NCLASS = len(classify.CLASSES)
_CLS_INDEX = {c: i for i, c in enumerate(classify.CLASSES)}

_HDR_SIZE = 32
_SVC_NAME_LEN = 16                         # service registry entry
_SVC_OFF = _HDR_SIZE
_ROW_SIZE = _NCLASS * len(_FIELDS) * 8     # one (service, worker) row
_SVC_BLOCK = MAX_WORKERS * _ROW_SIZE       # one service's worker rows
_ROWS_OFF = _SVC_OFF + MAX_SERVICES * _SVC_NAME_LEN
_DRR_OFF = _ROWS_OFF + MAX_SERVICES * _SVC_BLOCK
_DRR_SIZE = MAX_SERVICES * _NCLASS * 8
_TENANT_OFF = _DRR_OFF + _DRR_SIZE
_TOTAL_SIZE = _TENANT_OFF + TENANT_SLOTS * _SLOT.size

# lock-byte indexes in the sidecar file: one per tenant stripe, then
# the service registry, then one DRR lock per service slot
_SVC_LOCK = N_STRIPES
_DRR_LOCK0 = N_STRIPES + 1
_N_LOCKS = N_STRIPES + 1 + MAX_SERVICES

ACTIVE: Optional["QosShm"] = None
_worker_id = 0


def set_worker_id(wid: int):
    global _worker_id
    _worker_id = min(max(0, wid), MAX_WORKERS - 1)


def worker_id() -> int:
    return _worker_id


def enabled_env() -> str:
    return os.environ.get("WEED_QOS_SHM", "auto")


class QosShm:
    def __init__(self, name: Optional[str] = None, create: bool = False,
                 nworkers: int = 1):
        if create:
            self.shm = shared_memory.SharedMemory(create=True,
                                                  size=_TOTAL_SIZE)
            self.shm.buf[:_TOTAL_SIZE] = b"\x00" * _TOTAL_SIZE
            _HDR.pack_into(self.shm.buf, 0, _MAGIC, 1,
                           min(nworkers, MAX_WORKERS), 0)
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            # CPython (< 3.13 track=False) registers even attached
            # segments with this process's resource tracker, which
            # unlinks them at exit — an external attacher (probe, test,
            # sideband client) exiting would destroy the fleet's live
            # segment out from under every worker.  We never own a
            # segment we merely attached, so untrack it.
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(self.shm._name,
                                            "shared_memory")
            except Exception:
                pass
            magic, _ver, nworkers, _ = _HDR.unpack_from(self.shm.buf, 0)
            if magic != _MAGIC:
                self.shm.close()
                raise ValueError(f"{name}: not a QoS segment")
        self.name = self.shm.name
        self.nworkers = nworkers
        self._owner = create
        # sidecar byte-range lock file; one fd per instance, kept open
        # for the segment's whole life (closing ANY fd to a file drops
        # every fcntl lock this process holds on it)
        self.lock_path = os.path.join(
            tempfile.gettempdir(),
            f"weed-qos-{self.name.lstrip('/')}.lock")
        self._lock_fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR,
                                0o644)
        self._tlocks = [threading.Lock() for _ in range(_N_LOCKS)]
        self._svc_cache: dict[str, int] = {}

    def reinit_after_fork(self):
        """Replace (never acquire) the in-process stripe locks: the
        parent keeps serving while forking, so a child can inherit one
        mid-hold and would deadlock on its first bucket/DRR access.
        The fcntl byte-range locks need no reset — record locks are
        per-process and a child holds none at birth."""
        self._tlocks = [threading.Lock() for _ in range(_N_LOCKS)]

    # -- locking --------------------------------------------------------

    @contextmanager
    def _locked(self, idx: int):
        with self._tlocks[idx]:
            fcntl.lockf(self._lock_fd, fcntl.LOCK_EX, 1, idx)
            try:
                yield
            finally:
                fcntl.lockf(self._lock_fd, fcntl.LOCK_UN, 1, idx)

    @contextmanager
    def drr_lock(self, service: str = ""):
        with self._locked(_DRR_LOCK0 + max(0, self.service_index(service))):
            yield

    # -- service registry ------------------------------------------------

    def service_index(self, service: str, register: bool = True) -> int:
        """Slot index of `service` in the segment's name registry,
        claiming a free slot on first sight (register=True).  -1 when
        the service is absent (register=False) or the registry is full
        — callers then degrade to per-process state rather than share
        another service's rows."""
        if not service:
            service = "_"
        idx = self._svc_cache.get(service)
        if idx is not None:
            return idx
        raw = service.encode()[:_SVC_NAME_LEN].ljust(_SVC_NAME_LEN, b"\x00")
        with self._locked(_SVC_LOCK):
            for i in range(MAX_SERVICES):
                off = _SVC_OFF + i * _SVC_NAME_LEN
                cur = bytes(self.shm.buf[off:off + _SVC_NAME_LEN])
                if cur == raw:
                    self._svc_cache[service] = i
                    return i
                if cur == b"\x00" * _SVC_NAME_LEN:
                    if not register:
                        return -1
                    self.shm.buf[off:off + _SVC_NAME_LEN] = raw
                    self._svc_cache[service] = i
                    return i
        return -1

    def services(self) -> list:
        """(slot, name) for every registered service."""
        out = []
        for i in range(MAX_SERVICES):
            off = _SVC_OFF + i * _SVC_NAME_LEN
            raw = bytes(self.shm.buf[off:off + _SVC_NAME_LEN]) \
                .rstrip(b"\x00")
            if raw:
                out.append((i, raw.decode(errors="replace")))
        return out

    # -- gate rows (single writer: the owning service's worker) ---------

    def _field_off(self, sidx: int, wid: int, cls: str,
                   field: str) -> int:
        ci = _CLS_INDEX.get(cls, 1)
        fi = _FIELDS.index(field)
        return (_ROWS_OFF + sidx * _SVC_BLOCK + wid * _ROW_SIZE
                + (ci * len(_FIELDS) + fi) * 8)

    def gate_set(self, service: str, cls: str, field: str, value: int):
        sidx = self.service_index(service)
        if sidx < 0:
            return  # registry full: this gate stays per-process
        off = self._field_off(sidx, _worker_id, cls, field)
        struct.pack_into("<q", self.shm.buf, off, max(0, int(value)))

    def gate_read(self, service, wid: int, cls: str, field: str) -> int:
        sidx = (self.service_index(service, register=False)
                if isinstance(service, str) else service)
        if sidx < 0:
            return 0
        return struct.unpack_from(
            "<q", self.shm.buf, self._field_off(sidx, wid, cls, field))[0]

    def gate_total(self, field: str, cls: Optional[str] = None,
                   service: Optional[str] = None) -> int:
        """Sum a field over one service's worker rows (the value each
        gate enforces its limit against), or over every registered
        service when `service` is None (segment-wide debug totals)."""
        classes = (cls,) if cls else classify.CLASSES
        if service is None:
            sidxs = [i for i, _ in self.services()]
        else:
            i = self.service_index(service, register=False)
            sidxs = [i] if i >= 0 else []
        total = 0
        for sidx in sidxs:
            for wid in range(MAX_WORKERS):
                for c in classes:
                    total += self.gate_read(sidx, wid, c, field)
        return total

    def reset_worker(self, wid: int, service: Optional[str] = None):
        """Zero a (re)spawned worker's row: a crashed worker's stuck
        inflight/queued counts must not poison the fleet occupancy.
        Scoped to `service` when given — in a combined daemon each
        service numbers its workers independently, so one service's
        respawn must not zero another service's live counters."""
        if service is None:
            sidxs = range(MAX_SERVICES)
        else:
            i = self.service_index(service)
            sidxs = [i] if i >= 0 else []
        for sidx in sidxs:
            off = _ROWS_OFF + sidx * _SVC_BLOCK + wid * _ROW_SIZE
            self.shm.buf[off:off + _ROW_SIZE] = b"\x00" * _ROW_SIZE

    # -- DRR deficits ----------------------------------------------------

    def _drr_off(self, cls: str, service: str) -> int:
        sidx = max(0, self.service_index(service))
        return _DRR_OFF + (sidx * _NCLASS + _CLS_INDEX.get(cls, 1)) * 8

    def drr_get(self, cls: str, service: str = "") -> float:
        off = self._drr_off(cls, service)
        return struct.unpack_from("<q", self.shm.buf, off)[0] / MICRO

    def drr_set(self, cls: str, value: float, service: str = ""):
        off = self._drr_off(cls, service)
        struct.pack_into("<q", self.shm.buf, off, int(value * MICRO))

    # -- tenant token buckets -------------------------------------------

    @staticmethod
    def _hash(key: str) -> int:
        h = int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")
        return h or 1  # 0 means "slot empty"

    def _slot_off(self, idx: int) -> int:
        return _TENANT_OFF + idx * _SLOT.size

    def tenant_take(self, key: str, rate: float, burst: float,
                    n: float = 1.0) -> bool:
        """Take `n` tokens from `key`'s fleet-wide bucket; refill at
        `rate`/s up to `burst`.  rate <= 0 means unlimited."""
        if rate <= 0:
            return True
        h = self._hash(key)
        stripe = h % N_STRIPES
        base = stripe * _SLOTS_PER_STRIPE
        start = (h // N_STRIPES) % _SLOTS_PER_STRIPE
        burst_u = int(burst * MICRO)
        rate_u = int(rate * MICRO)
        need = int(n * MICRO)
        now = time.monotonic_ns()
        with self._locked(stripe):
            idx = None
            # probing stays inside the stripe's contiguous region, so
            # every claim in it is serialized by this stripe's lock
            for i in range(_SLOTS_PER_STRIPE):
                off = self._slot_off(base + (start + i) % _SLOTS_PER_STRIPE)
                slot_hash = struct.unpack_from("<Q", self.shm.buf, off)[0]
                if slot_hash == h:
                    idx = off
                    break
                if slot_hash == 0:
                    # slots are never freed, so a key always sits before
                    # the first empty slot on its probe path: claim it
                    idx = off
                    break
            if idx is None:
                return True  # stripe full (>64 live tenants hashing
                # here): fail open rather than starve an unlucky tenant
            sh, tokens, last_ns, taken, denied = _SLOT.unpack_from(
                self.shm.buf, idx)
            if sh != h:  # claiming a fresh slot
                tokens, last_ns, taken, denied = burst_u, now, 0, 0
            else:
                tokens = min(burst_u,
                             tokens + (now - last_ns) * rate_u // 10**9)
            ok = tokens >= need
            if ok:
                tokens -= need
                taken += 1
            else:
                denied += 1
            _SLOT.pack_into(self.shm.buf, idx, h, tokens, now,
                            taken, denied)
        return ok

    def tenant_stats(self, key: str) -> Optional[dict]:
        h = self._hash(key)
        base = (h % N_STRIPES) * _SLOTS_PER_STRIPE
        start = (h // N_STRIPES) % _SLOTS_PER_STRIPE
        for i in range(_SLOTS_PER_STRIPE):
            off = self._slot_off(base + (start + i) % _SLOTS_PER_STRIPE)
            sh, tokens, _last, taken, denied = _SLOT.unpack_from(
                self.shm.buf, off)
            if sh == h:
                return {"tokens": tokens / MICRO, "taken": taken,
                        "denied": denied}
            if sh == 0:
                return None
        return None

    # -- snapshot / lifecycle -------------------------------------------

    def snapshot(self) -> dict:
        services = {}
        for sidx, name in self.services():
            per_worker = {}
            for wid in range(MAX_WORKERS):
                row = {c: {f: self.gate_read(sidx, wid, c, f)
                           for f in _FIELDS}
                       for c in classify.CLASSES}
                if any(v for cls in row.values() for v in cls.values()):
                    per_worker[str(wid)] = row
            services[name] = {
                "inflight": self.gate_total("inflight", service=name),
                "queued": self.gate_total("queued", service=name),
                "drr_deficit": {c: self.drr_get(c, service=name)
                                for c in classify.CLASSES},
                "workers": per_worker,
            }
        return {
            "segment": self.name,
            "nworkers": self.nworkers,
            "fleet_inflight": self.gate_total("inflight"),
            "fleet_queued": self.gate_total("queued"),
            "services": services,
        }

    def close(self):
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass
        try:
            os.close(self._lock_fd)
        except OSError:
            pass

    def unlink(self):
        try:
            self.shm.unlink()
        except OSError:
            pass
        try:
            os.unlink(self.lock_path)
        except OSError:
            pass


def create(nworkers: int) -> QosShm:
    """Create the segment and make it ACTIVE in this process (the
    prefork parent calls this before forking so children inherit)."""
    global ACTIVE
    if ACTIVE is not None:
        return ACTIVE
    ACTIVE = QosShm(create=True, nworkers=nworkers)
    return ACTIVE


def attach(name: str) -> QosShm:
    """Attach to an existing segment by name (unrelated processes —
    tests, external probes) and make it ACTIVE."""
    global ACTIVE
    ACTIVE = QosShm(name=name)
    return ACTIVE


def destroy():
    """Close and (if owner) unlink the ACTIVE segment."""
    global ACTIVE
    shm = ACTIVE
    ACTIVE = None
    if shm is None:
        return
    owner = shm._owner
    shm.close()
    if owner:
        shm.unlink()
