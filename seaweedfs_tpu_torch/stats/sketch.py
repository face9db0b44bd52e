"""Bounded-memory mergeable workload sketches.

Counterpart of seaweedfs_tpu/stats/sketch.py.

Three summaries, all with the same contract: bounded memory, an
associative/commutative ``merge()`` so per-daemon (and per-prefork-
worker) summaries compose into a fleet view the way
``metrics.merge_expositions`` / ``profiling.merge_folded`` already
compose text expositions, and a canonical JSON-able ``to_dict()`` /
``from_dict()`` wire form so summaries can ride heartbeats and scrape
responses without pickling.

- :class:`SpaceSaving` — top-K heavy hitters (Metwally et al.), used
  for hot fids / hot tenants.  Counts are floats so exponential decay
  is a single ``scale()``.
- :class:`HyperLogLog` — distinct-key cardinality with register-wise
  max merge (exactly associative).  Hashing is blake2b, so estimates
  are stable across processes regardless of ``PYTHONHASHSEED``.
- :class:`LogQuantile` — DDSketch-style log-bucketed histogram for
  latency / size quantiles with guaranteed relative error; merge is a
  bucket-wise add (exactly associative).
"""

from __future__ import annotations

import hashlib
import heapq
import math
import struct
from typing import Dict, List, Optional, Tuple


def _hash64(key: str) -> int:
    """Deterministic 64-bit hash (process/seed independent)."""
    digest = hashlib.blake2b(key.encode("utf-8", "surrogatepass"),
                             digest_size=8).digest()
    return struct.unpack(">Q", digest)[0]


# ---------------------------------------------------------------------------
# Space-Saving heavy hitters


class SpaceSaving:
    """Top-K heavy hitters over a weighted key stream.

    Keeps at most ``capacity`` counters.  When a new key arrives at a
    full table it replaces the minimum counter and inherits its count
    as overestimation ``error`` (the classic Space-Saving move), so
    ``estimate(key) - error(key)`` is a guaranteed lower bound and
    keys whose weight exceeds total/capacity are never lost.

    ``merge`` is the Misra-Gries-style union: sum counts and errors
    over the key union, then truncate back to capacity dropping the
    smallest counters (deterministic ``(-count, key)`` order, so merge
    is commutative; it is associative up to the usual truncation error
    bound, and exact whenever the union fits in ``capacity``).
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        # key -> [count, error]; floats so decay composes
        self.counts: Dict[str, List[float]] = {}
        self.total = 0.0       # total offered weight (decays too)
        # lazy min-heap of (count, key): entries go stale when a key is
        # incremented (count too low) or evicted, and are repaired on
        # pop — keeps eviction O(log n) instead of a full min() scan on
        # every miss, which dominates record() cost on a full table
        self._heap: List[Tuple[float, str]] = []

    def __len__(self) -> int:
        return len(self.counts)

    def _rebuild_heap(self) -> None:
        self._heap = [(slot[0], key)
                      for key, slot in self.counts.items()]
        heapq.heapify(self._heap)

    def offer(self, key: str, weight: float = 1.0) -> None:
        if weight <= 0:
            return
        self.total += weight
        slot = self.counts.get(key)
        if slot is not None:
            slot[0] += weight
            return
        if len(self.counts) < self.capacity:
            self.counts[key] = [weight, 0.0]
            heapq.heappush(self._heap, (weight, key))
            return
        # repair the heap top until it names the true minimum counter
        # (ties break toward the smaller key, matching top()'s order)
        heap = self._heap
        while True:
            vcount, vkey = heap[0]
            cur = self.counts.get(vkey)
            if cur is None:
                heapq.heappop(heap)
            elif cur[0] != vcount:
                heapq.heapreplace(heap, (cur[0], vkey))
            else:
                break
        del self.counts[vkey]
        self.counts[key] = [vcount + weight, vcount]
        heapq.heapreplace(heap, (vcount + weight, key))

    def estimate(self, key: str) -> float:
        slot = self.counts.get(key)
        return slot[0] if slot is not None else 0.0

    def error(self, key: str) -> float:
        slot = self.counts.get(key)
        return slot[1] if slot is not None else 0.0

    def top(self, k: int = 0) -> List[Tuple[str, float, float]]:
        """``[(key, count, error)]`` best-first, deterministic order."""
        items = sorted(self.counts.items(),
                       key=lambda kv: (-kv[1][0], kv[0]))
        if k:
            items = items[:k]
        return [(key, slot[0], slot[1]) for key, slot in items]

    def scale(self, factor: float, floor: float = 1e-3) -> None:
        """Exponential decay: multiply every counter (and the total)
        by ``factor``, dropping counters that decayed below ``floor``
        so an idle sketch drains to empty instead of pinning stale
        keys forever."""
        if factor >= 1.0:
            return
        self.total *= factor
        dead = []
        for key, slot in self.counts.items():
            slot[0] *= factor
            slot[1] *= factor
            if slot[0] < floor:
                dead.append(key)
        for key in dead:
            del self.counts[key]
        self._rebuild_heap()

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        self.total += other.total
        for key, (count, err) in other.counts.items():
            slot = self.counts.get(key)
            if slot is not None:
                slot[0] += count
                slot[1] += err
            else:
                self.counts[key] = [count, err]
        if len(self.counts) > self.capacity:
            keep = sorted(self.counts.items(),
                          key=lambda kv: (-kv[1][0], kv[0]))
            self.counts = {k: v for k, v in keep[:self.capacity]}
        self._rebuild_heap()
        return self

    def to_dict(self) -> dict:
        return {"kind": "space_saving", "capacity": self.capacity,
                "total": round(self.total, 6),
                "counts": {k: [round(v[0], 6), round(v[1], 6)]
                           for k, v in sorted(self.counts.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "SpaceSaving":
        sk = cls(int(d.get("capacity", 256) or 256))
        sk.total = float(d.get("total", 0.0) or 0.0)
        for key, slot in (d.get("counts") or {}).items():
            sk.counts[str(key)] = [float(slot[0]), float(slot[1])]
        sk._rebuild_heap()
        return sk


# ---------------------------------------------------------------------------
# HyperLogLog cardinality


class HyperLogLog:
    """Distinct-count sketch with ``2**p`` 6-bit registers.

    Standard-error ~= 1.04 / sqrt(2**p); the default p=10 (1 KiB of
    registers) gives ~3.2% which is plenty for "how many distinct fids
    did this collection touch".  ``merge`` is a register-wise max —
    exactly associative and commutative, and idempotent, so re-merging
    a summary is harmless.
    """

    def __init__(self, p: int = 10):
        self.p = min(18, max(4, int(p)))
        self.m = 1 << self.p
        self.registers = bytearray(self.m)
        self._shift = 64 - self.p
        self._mask = (1 << self._shift) - 1

    def add(self, key: str) -> None:
        self.add_hash(_hash64(key))

    def add_hash(self, h: int) -> None:
        """Add a pre-computed ``_hash64`` value — callers feeding the
        same key to several sketches hash once and share it."""
        idx = h >> self._shift
        # rank = leading zeros of the remaining bits, + 1
        rank = self._shift - (h & self._mask).bit_length() + 1
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    def estimate(self) -> float:
        m = self.m
        inv_sum = 0.0
        zeros = 0
        for r in self.registers:
            inv_sum += 2.0 ** -r
            if r == 0:
                zeros += 1
        alpha = 0.7213 / (1.0 + 1.079 / m)
        raw = alpha * m * m / inv_sum
        if raw <= 2.5 * m and zeros:
            return m * math.log(m / zeros)   # linear counting
        return raw

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.p != self.p:
            raise ValueError(f"HLL precision mismatch: {self.p} vs {other.p}")
        for i, r in enumerate(other.registers):
            if r > self.registers[i]:
                self.registers[i] = r
        return self

    def to_dict(self) -> dict:
        # hex-pack the registers: canonical, compact, JSON-safe
        return {"kind": "hll", "p": self.p,
                "registers": bytes(self.registers).hex()}

    @classmethod
    def from_dict(cls, d: dict) -> "HyperLogLog":
        hll = cls(int(d.get("p", 10) or 10))
        raw = bytes.fromhex(d.get("registers") or "")
        if len(raw) == hll.m:
            hll.registers = bytearray(raw)
        return hll


# ---------------------------------------------------------------------------
# Log-bucketed quantiles


class LogQuantile:
    """Mergeable quantile sketch over positive values (latency, size).

    Values land in geometric buckets ``gamma**i`` with
    ``gamma = (1+alpha)/(1-alpha)``, bounding the relative error of
    any reported quantile by ``alpha`` (DDSketch's guarantee).
    Bucket counts are floats so the access plane's exponential decay
    applies uniformly; merge adds bucket-wise and is exact.
    """

    def __init__(self, alpha: float = 0.01):
        self.alpha = min(0.5, max(1e-4, float(alpha)))
        self.gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._lg = math.log(self.gamma)
        self._inv_lg = 1.0 / self._lg
        self.buckets: Dict[int, float] = {}
        self.zeros = 0.0
        self.count = 0.0
        self.sum = 0.0

    def observe(self, value: float, weight: float = 1.0) -> None:
        if weight <= 0:
            return
        self.count += weight
        self.sum += value * weight
        if value <= 0:
            self.zeros += weight
            return
        idx = math.ceil(math.log(value) * self._inv_lg)
        self.buckets[idx] = self.buckets.get(idx, 0.0) + weight

    def quantile(self, q: float) -> float:
        if self.count <= 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        target = q * self.count
        seen = self.zeros
        if seen >= target and self.zeros > 0:
            return 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= target:
                # bucket midpoint in log space: gamma**idx is the
                # upper edge, divide by (1+alpha)-ish for the center
                return (self.gamma ** idx) * 2.0 / (1.0 + self.gamma)
        top = max(self.buckets) if self.buckets else 0
        return self.gamma ** top

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def scale(self, factor: float, floor: float = 1e-3) -> None:
        if factor >= 1.0:
            return
        self.count *= factor
        self.sum *= factor
        self.zeros *= factor
        dead = []
        for idx in self.buckets:
            self.buckets[idx] *= factor
            if self.buckets[idx] < floor:
                dead.append(idx)
        for idx in dead:
            del self.buckets[idx]

    def merge(self, other: "LogQuantile") -> "LogQuantile":
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError("LogQuantile alpha mismatch")
        self.count += other.count
        self.sum += other.sum
        self.zeros += other.zeros
        for idx, w in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0.0) + w
        return self

    def to_dict(self) -> dict:
        return {"kind": "log_quantile", "alpha": self.alpha,
                "count": round(self.count, 6), "sum": round(self.sum, 6),
                "zeros": round(self.zeros, 6),
                "buckets": {str(i): round(w, 6)
                            for i, w in sorted(self.buckets.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "LogQuantile":
        lq = cls(float(d.get("alpha", 0.01) or 0.01))
        lq.count = float(d.get("count", 0.0) or 0.0)
        lq.sum = float(d.get("sum", 0.0) or 0.0)
        lq.zeros = float(d.get("zeros", 0.0) or 0.0)
        for idx, w in (d.get("buckets") or {}).items():
            lq.buckets[int(idx)] = float(w)
        return lq


_KINDS = {"space_saving": SpaceSaving, "hll": HyperLogLog,
          "log_quantile": LogQuantile}


def from_dict(d: Optional[dict]):
    """Polymorphic loader keyed on the wire form's ``kind`` tag."""
    if not d:
        return None
    cls = _KINDS.get(d.get("kind", ""))
    return cls.from_dict(d) if cls else None
