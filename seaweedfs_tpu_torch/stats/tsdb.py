"""Bounded in-memory ring TSDB for the master-resident health plane.

The leader's scrape loop (master/health.py) polls every registered
daemon's ``/metrics`` and feeds the text exposition here.  Each series
is a fixed-interval ring: slot ``i`` holds the sample whose timestamp
falls in ``[i*interval, (i+1)*interval)``, so retention is
``slots * interval`` seconds and memory is strictly bounded — there is
no per-sample allocation after warm-up.  Counters are delta-aware: the
ring stores the raw cumulative value and the query layer sums
monotone increases (a restart that resets a counter to zero contributes
nothing negative).

Knobs (read live, like every WEED_* knob in this tree):

* ``WEED_TSDB_RETENTION``  — seconds of history per series (default 900)
* ``WEED_TSDB_MAX_SERIES`` — cardinality cap; series past the cap are
  dropped and counted in ``SeaweedFS_cluster_tsdb_dropped_total``

The port's own copy of seaweedfs_tpu/stats/tsdb.py.
"""

from __future__ import annotations

import os
import threading
import time
from array import array
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import metrics as _stats

GAUGE = "gauge"
COUNTER = "counter"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def retention_seconds() -> float:
    return max(10.0, _env_float("WEED_TSDB_RETENTION", 900.0))


def max_series() -> int:
    return max(16, int(_env_float("WEED_TSDB_MAX_SERIES", 4096)))


# -- text exposition parsing --------------------------------------------------
def _parse_labels(raw: str) -> Dict[str, str]:
    """``a="x",b="y"`` -> dict.  Handles escaped quotes/backslashes the
    way our own expose() emits them; a malformed pair is skipped rather
    than poisoning the whole scrape."""
    out: Dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        eq = raw.find("=", i)
        if eq < 0:
            break
        name = raw[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if i >= n or raw[i] != '"':
            break
        i += 1
        buf = []
        while i < n:
            c = raw[i]
            if c == "\\" and i + 1 < n:
                nxt = raw[i + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                break
            buf.append(c)
            i += 1
        out[name] = "".join(buf)
        i += 1  # closing quote
    return out


def parse_exposition(text: str):
    """Parse prometheus text format into ``(types, samples)`` where
    ``types`` maps family -> declared TYPE and ``samples`` is a list of
    ``(sample_name, labels_dict, value)``."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            words = line.split(None, 3)
            if len(words) >= 4 and words[1] == "TYPE":
                types[words[2]] = words[3].strip()
            continue
        sample, _, value = line.rpartition(" ")
        if not sample:
            continue
        try:
            val = float(value)
        except ValueError:
            continue
        if sample.endswith("}"):
            brace = sample.find("{")
            if brace < 0:
                continue
            name = sample[:brace]
            labels = _parse_labels(sample[brace + 1:-1])
        else:
            name, labels = sample, {}
        samples.append((name, labels, val))
    return types, samples


def kind_for(sample_name: str, types: Dict[str, str]) -> str:
    """Sample kind from the family TYPE declarations.  Histogram and
    summary components (`_bucket`/`_count`/`_sum`) are cumulative, so
    they are counters for delta purposes."""
    if sample_name in types:
        return COUNTER if types[sample_name] == "counter" else GAUGE
    for suffix in ("_bucket", "_count", "_sum", "_total"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in types or suffix == "_total":
                return COUNTER
    return GAUGE


# -- the ring -----------------------------------------------------------------
class _Ring:
    """Fixed-interval ring of (slot_index, value).  ``idx[p]`` records
    which absolute interval the slot currently holds, so stale laps are
    distinguishable without a sweep."""

    __slots__ = ("interval", "slots", "idx", "vals", "kind", "last")

    def __init__(self, interval: float, slots: int, kind: str):
        self.interval = interval
        self.slots = slots
        # array, not list: 16 bytes/slot keeps a full-cardinality TSDB
        # (WEED_TSDB_MAX_SERIES rings) in tens of MB, not hundreds
        self.idx = array("q", [-1]) * slots
        self.vals = array("d", [0.0]) * slots
        self.kind = kind
        self.last = 0.0  # most recent raw value (counters: cumulative)

    def put(self, ts: float, value: float):
        i = int(ts // self.interval)
        p = i % self.slots
        self.idx[p] = i
        self.vals[p] = value
        self.last = value

    def window(self, now: float, seconds: float) -> List[Tuple[float, float]]:
        """Samples with timestamps in ``[now - seconds, now]``, oldest
        first (timestamps reconstructed at slot start)."""
        lo = int((now - seconds) // self.interval)
        hi = int(now // self.interval)
        out = []
        # clamp at 0: negative absolute indices would collide with the
        # -1 empty-slot sentinel in ``idx``
        for i in range(max(lo, hi - self.slots + 1, 0), hi + 1):
            p = i % self.slots
            if self.idx[p] == i:
                out.append((i * self.interval, self.vals[p]))
        return out

    def delta(self, now: float, seconds: float) -> float:
        """Summed monotone increase over the window (counter reset
        contributes zero, not a negative swing)."""
        pts = self.window(now, seconds)
        total, prev = 0.0, None
        for _, v in pts:
            if prev is not None and v >= prev:
                total += v - prev
            prev = v
        return total


class Tsdb:
    """Bounded map of series key -> ring.  The series key is the sample
    name plus its sorted label items, so histogram buckets, _sum and
    _count each get their own ring."""

    def __init__(self, interval: float = 5.0,
                 now: Callable[[], float] = time.time):
        self.interval = max(0.05, float(interval))
        self.now = now  # fake-clock seam
        self.lock = threading.Lock()
        self.series: Dict[tuple, _Ring] = {}
        self.dropped = 0

    def _slots(self) -> int:
        return max(4, int(retention_seconds() / self.interval) + 1)

    def _ring(self, name: str, labels: Dict[str, str], kind: str):
        key = (name, tuple(sorted(labels.items())))
        ring = self.series.get(key)
        if ring is None:
            if len(self.series) >= max_series():
                self.dropped += 1
                _stats.ClusterTsdbDroppedCounter.inc()
                return None
            ring = self.series[key] = _Ring(self.interval, self._slots(),
                                            kind)
        return ring

    def put(self, name: str, labels: Dict[str, str], value: float,
            kind: str = GAUGE, ts: Optional[float] = None):
        with self.lock:
            ring = self._ring(name, labels, kind)
            if ring is not None:
                ring.put(self.now() if ts is None else ts, value)

    SELF_FAMILY_PREFIX = "SeaweedFS_cluster_"

    def ingest(self, target: str, text: str, ts: Optional[float] = None,
               priority: Optional[set] = None,
               skip_prefix: Optional[str] = SELF_FAMILY_PREFIX):
        """Parse one scrape and store every sample with a ``target``
        label stamped on (the scrape loop's equivalent of prometheus's
        ``instance``).  ``priority`` names sample families that must
        claim series slots before the rest of the scrape — the health
        plane passes the families its SLO rules reference, so a
        cardinality cap can never starve the alert evaluator.

        ``skip_prefix`` drops the health plane's OWN derived families
        from scraped text: the leader exports its liveness/SLO gauges
        on /metrics, and re-ingesting them would feed the evaluator its
        own output — a stale ``cluster_target_up 0`` series scraped
        back in can hold an availability alert firing forever."""
        types, samples = parse_exposition(text)
        stamp = self.now() if ts is None else ts
        if skip_prefix:
            samples = [s for s in samples
                       if not s[0].startswith(skip_prefix)]
        if priority:
            samples.sort(key=lambda s: 0 if s[0] in priority
                         or s[0].rsplit("_", 1)[0] in priority else 1)
        with self.lock:
            for name, labels, value in samples:
                labels = dict(labels)
                labels["target"] = target
                ring = self._ring(name, labels, kind_for(name, types))
                if ring is not None:
                    ring.put(stamp, value)
        _stats.ClusterTsdbSeriesGauge.set(float(len(self.series)))

    # -- queries -------------------------------------------------------------
    def _match(self, name: str, match: Optional[Dict[str, str]]):
        for (sname, items), ring in list(self.series.items()):
            if sname != name:
                continue
            if match:
                labels = dict(items)
                if any(labels.get(k) != v for k, v in match.items()):
                    continue
            yield items, ring

    def latest(self, name: str, match: Optional[Dict[str, str]] = None
               ) -> Dict[tuple, float]:
        with self.lock:
            return {items: ring.last
                    for items, ring in self._match(name, match)}

    def avg(self, name: str, seconds: float,
            match: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Mean of every matching sample in the window (gauges)."""
        now = self.now()
        total, count = 0.0, 0
        with self.lock:
            for _, ring in self._match(name, match):
                for _, v in ring.window(now, seconds):
                    total += v
                    count += 1
        return (total / count) if count else None

    def delta(self, name: str, seconds: float,
              match: Optional[Dict[str, str]] = None) -> float:
        """Summed counter increase across matching series."""
        now = self.now()
        with self.lock:
            return sum(ring.delta(now, seconds)
                       for _, ring in self._match(name, match))

    def histogram_window(self, family: str, seconds: float,
                         match: Optional[Dict[str, str]] = None):
        """Windowed delta of a histogram family, merged across targets
        and workers: ``(sorted [(le, cumulative_delta)], count_delta)``."""
        buckets: Dict[float, float] = {}
        now = self.now()
        with self.lock:
            for items, ring in self._match(family + "_bucket", match):
                labels = dict(items)
                try:
                    le = float(labels.get("le", "+Inf").replace(
                        "+Inf", "inf"))
                except ValueError:
                    continue
                d = ring.delta(now, seconds)
                buckets[le] = buckets.get(le, 0.0) + d
            count = sum(ring.delta(now, seconds)
                        for _, ring in self._match(family + "_count",
                                                   match))
        return sorted(buckets.items()), count

    def families(self) -> set:
        with self.lock:
            return {name for (name, _) in self.series}

    def stats(self) -> dict:
        with self.lock:
            return {"series": len(self.series), "dropped": self.dropped,
                    "interval": self.interval,
                    "retention": retention_seconds()}


def quantile(buckets: Iterable[Tuple[float, float]], count: float,
             q: float) -> Optional[float]:
    """Prometheus-style histogram_quantile over cumulative le-buckets
    (linear interpolation inside the straddling bucket)."""
    pts = sorted(buckets)
    if not pts or count <= 0:
        return None
    rank = q * count
    prev_le, prev_c = 0.0, 0.0
    for le, c in pts:
        if c >= rank:
            if le == float("inf"):
                return prev_le
            span = c - prev_c
            frac = ((rank - prev_c) / span) if span > 0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_c = le, c
    return prev_le
