"""Per-collection byte/ops quotas, enforced at master assign and S3 PUT.

WEED_QOS_QUOTA is a comma-separated spec of
``<collection>=<ops>ops[+<mb>mb]`` entries; ``*`` matches any
collection without its own entry:

    WEED_QOS_QUOTA="photos=200ops+64mb,logs=50ops,*=1000ops"

Ops quotas meter assigns (master) and object PUTs (S3); byte quotas
meter uploaded bytes at S3 PUT.  Both are token buckets with a burst
of one second's allowance (bursts scale with the rate), refilled on the
injectable clock so tests stay deterministic.  A drained bucket sheds
with 503 + jittered Retry-After (master) or SlowDown (S3).

Counterpart of seaweedfs_tpu/qos/quota.py.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..stats import metrics as _stats
from . import shm as _shm
from .admission import TokenBucket


def _parse_spec(spec: str) -> Dict[str, Tuple[float, float]]:
    """``{collection: (ops_per_s, bytes_per_s)}``; 0 = unlimited."""
    out: Dict[str, Tuple[float, float]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, limits = part.partition("=")
        ops = byts = 0.0
        for tok in limits.split("+"):
            tok = tok.strip().lower()
            try:
                if tok.endswith("ops"):
                    ops = float(tok[:-3])
                elif tok.endswith("mb"):
                    byts = float(tok[:-2]) * (1 << 20)
            except ValueError:
                pass
        out[name.strip()] = (ops, byts)
    return out


class CollectionQuotas:
    """Lazily-built buckets per (collection, kind), re-parsing the spec
    only when the env knob changes (live knob, near-zero steady cost)."""

    def __init__(self, now=time.monotonic):
        self.now = now
        self._lock = threading.Lock()
        self._spec_raw: Optional[str] = None
        self._spec: Dict[str, Tuple[float, float]] = {}
        self._buckets: Dict[Tuple[str, str], TokenBucket] = {}
        self.rejects = {"ops": 0, "bytes": 0}

    def _limits_for(self, collection: str) -> Tuple[float, float]:
        raw = os.environ.get("WEED_QOS_QUOTA", "")
        if raw != self._spec_raw:
            self._spec_raw = raw
            self._spec = _parse_spec(raw)
            self._buckets.clear()
        return self._spec.get(collection, self._spec.get("*", (0.0, 0.0)))

    def allow(self, collection: str, ops: float = 1.0,
              nbytes: float = 0.0) -> bool:
        """Charge one operation (and its bytes) against the collection's
        quota; False means shed."""
        with self._lock:
            ops_rate, byte_rate = self._limits_for(collection or "")
            if ops_rate > 0 and ops > 0:
                if not self._take(collection, "ops", ops_rate, ops):
                    self.rejects["ops"] += 1
                    _stats.QosQuotaRejectsCounter.labels("ops").inc()
                    return False
            if byte_rate > 0 and nbytes > 0:
                if not self._take(collection, "bytes", byte_rate,
                                  nbytes):
                    self.rejects["bytes"] += 1
                    _stats.QosQuotaRejectsCounter.labels("bytes").inc()
                    return False
        return True

    def _take(self, collection: str, kind: str, rate: float,
              n: float) -> bool:
        s = _shm.ACTIVE
        if s is not None:
            # prefork: one shared bucket per (collection, kind), so the
            # quota bounds the fleet rather than each worker
            return s.tenant_take(f"q:{collection}:{kind}", rate,
                                 max(rate, 1.0), n)
        return self._bucket(collection, kind, rate).try_take(n)

    def _bucket(self, collection: str, kind: str,
                rate: float) -> TokenBucket:
        key = (collection, kind)
        b = self._buckets.get(key)
        if b is None or b.rate != rate:
            b = TokenBucket(rate, burst=rate, now=self.now)
            self._buckets[key] = b
        return b

    def snapshot(self) -> dict:
        with self._lock:
            self._limits_for("")  # refresh the parsed spec
            return {"spec": {k: {"ops_per_s": v[0],
                                 "bytes_per_s": v[1]}
                             for k, v in self._spec.items()},
                    "rejects": dict(self.rejects),
                    "collections_metered":
                        len({c for c, _ in self._buckets})}


# process-wide singleton, shared by master assign and the s3 gateway
QUOTAS = CollectionQuotas()
