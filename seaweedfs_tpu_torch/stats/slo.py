"""SLO engine: availability + per-QoS-class p99-latency burn rates.

Runs on the master leader against the health plane's ring TSDB
(stats/tsdb.py).  Each rule defines a service-level objective; the
engine computes the fraction of "bad" events over a fast (5 min) and a
slow (1 h) window, converts them to error-budget **burn rates**
(bad_fraction / allowed_fraction — the Google SRE formulation), and
fires an alert only when BOTH windows burn hot (multi-window
multi-burn-rate: the fast window gives reaction speed, the slow window
suppresses blips).  Alerts clear once the fast window drops back under
a burn of 1.0.

Rule kinds:

* ``availability`` — over the scrape loop's liveness series
  (``SeaweedFS_cluster_target_up``): bad fraction is the time-averaged
  share of down targets in the window.
* ``latency`` — over any request histogram: bad fraction is the share
  of requests slower than the rule's threshold (``le`` seconds), from
  windowed le-bucket deltas.  The defaults watch the per-QoS-class
  queue-wait histogram, one rule per class.

Rules come from ``WEED_SLO_RULES`` (fs.configure-style compact spec:
rules split on ``;``, fields on ``,``, first bare field is the name,
e.g. ``p99-get,kind=latency,family=SeaweedFS_volumeServer_request_seconds,match.type=get,le=0.1,objective=0.99``)
or fall back to the built-in defaults below.

The port's own copy of seaweedfs_tpu/stats/slo.py.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

from . import metrics as _stats
from . import events as _events
from . import tsdb as _tsdb

LIVENESS_FAMILY = "SeaweedFS_cluster_target_up"
DEFAULT_LATENCY_FAMILY = "SeaweedFS_qos_queue_wait_seconds"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def fast_window() -> float:
    return max(1.0, _env_float("WEED_SLO_FAST_S", 300.0))


def slow_window() -> float:
    return max(1.0, _env_float("WEED_SLO_SLOW_S", 3600.0))


class Rule:
    __slots__ = ("name", "kind", "family", "match", "objective", "le",
                 "burn_fast", "burn_slow")

    def __init__(self, name: str, kind: str, family: str,
                 match: Optional[Dict[str, str]] = None,
                 objective: float = 0.999, le: float = 0.1,
                 burn_fast: Optional[float] = None,
                 burn_slow: Optional[float] = None):
        self.name = name
        self.kind = kind  # availability | latency
        self.family = family
        self.match = dict(match or {})
        self.objective = min(max(objective, 0.0), 0.999999)
        self.le = le
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow

    @property
    def budget(self) -> float:
        return max(1e-6, 1.0 - self.objective)

    def thresholds(self) -> tuple:
        bf = self.burn_fast if self.burn_fast is not None \
            else _env_float("WEED_SLO_BURN_FAST", 14.4)
        bs = self.burn_slow if self.burn_slow is not None \
            else _env_float("WEED_SLO_BURN_SLOW", 6.0)
        return bf, bs

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "family": self.family, "match": self.match,
                "objective": self.objective,
                "le": self.le if self.kind == "latency" else None}


def parse_rules(spec: str) -> List[Rule]:
    """Compact rule spec -> rules; malformed entries are skipped (a bad
    knob must never take the health plane down)."""
    rules: List[Rule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, kind, family = "", "availability", LIVENESS_FAMILY
        match: Dict[str, str] = {}
        kw: Dict[str, float] = {}
        ok = True
        for field in part.split(","):
            field = field.strip()
            if not field:
                continue
            if "=" not in field:
                name = field
                continue
            k, _, v = field.partition("=")
            k, v = k.strip(), v.strip()
            if k == "kind":
                kind = v
            elif k == "family":
                family = v
            elif k.startswith("match."):
                match[k[len("match."):]] = v
            elif k == "name":
                name = v
            elif k in ("objective", "le", "burn_fast", "burn_slow"):
                try:
                    kw[k] = float(v)
                except ValueError:
                    ok = False
            else:
                ok = False
        if not name or kind not in ("availability", "latency") or not ok:
            continue
        rules.append(Rule(name, kind, family, match=match, **kw))
    return rules


def default_rules() -> List[Rule]:
    avail_obj = _env_float("WEED_SLO_AVAILABILITY", 0.999)
    inter_s = _env_float("WEED_SLO_INTERACTIVE_MS", 100.0) / 1000.0
    std_s = _env_float("WEED_SLO_STANDARD_MS", 500.0) / 1000.0
    return [
        Rule("availability", "availability", LIVENESS_FAMILY,
             objective=avail_obj),
        Rule("p99-interactive", "latency", DEFAULT_LATENCY_FAMILY,
             match={"class": "interactive"}, objective=0.99, le=inter_s),
        Rule("p99-standard", "latency", DEFAULT_LATENCY_FAMILY,
             match={"class": "standard"}, objective=0.99, le=std_s),
    ]


def active_rules() -> List[Rule]:
    spec = os.environ.get("WEED_SLO_RULES", "")
    return parse_rules(spec) if spec.strip() else default_rules()


class SloEngine:
    """Evaluates the active rules against a Tsdb.  Pure apart from the
    registry gauges and journal events it feeds — ``now`` is injectable
    so the multi-window evaluator unit-tests under a fake clock."""

    def __init__(self, tsdb: "_tsdb.Tsdb",
                 rules: Optional[List[Rule]] = None,
                 now: Callable[[], float] = time.time,
                 on_transition: Optional[Callable] = None,
                 journal: Optional["_events.EventJournal"] = None):
        self.tsdb = tsdb
        self._rules = rules
        self.now = now  # fake-clock seam
        self.on_transition = on_transition  # fn(rule, alert, firing)
        self.journal = journal or _events.JOURNAL
        self.state: Dict[str, dict] = {}  # name -> {firing, since}

    def rules(self) -> List[Rule]:
        return self._rules if self._rules is not None else active_rules()

    # -- per-rule SLI --------------------------------------------------------
    def _bad_fraction(self, rule: Rule, seconds: float):
        """(bad_fraction, detail) over the window."""
        if rule.kind == "availability":
            up = self.tsdb.avg(rule.family, seconds, rule.match)
            if up is None:
                return 0.0, {}
            down = sorted(
                dict(items).get("target", "?")
                for items, v in self.tsdb.latest(rule.family,
                                                 rule.match).items()
                if v < 1.0)
            return max(0.0, 1.0 - up), {"down": down}
        buckets, count = self.tsdb.histogram_window(rule.family, seconds,
                                                    rule.match)
        if count <= 0:
            return 0.0, {"requests": 0}
        good = 0.0
        for le, c in buckets:
            if le >= rule.le - 1e-12:
                good = c
                break
        else:
            good = count
        p99 = _tsdb.quantile(buckets, count, 0.99)
        return (max(0.0, 1.0 - good / count),
                {"requests": int(count),
                 "p99_ms": round(p99 * 1000, 2) if p99 is not None
                 else None})

    def evaluate(self) -> dict:
        """One evaluator pass: burn rates per window, transition logic,
        gauges, events.  Returns the full SLO status rollup."""
        out: Dict[str, dict] = {}
        fast_s, slow_s = fast_window(), slow_window()
        for rule in self.rules():
            bad_fast, detail = self._bad_fraction(rule, fast_s)
            bad_slow, _ = self._bad_fraction(rule, slow_s)
            burn_fast = bad_fast / rule.budget
            burn_slow = bad_slow / rule.budget
            _stats.ClusterSloBurnRateGauge.labels(rule.name, "fast").set(
                round(burn_fast, 4))
            _stats.ClusterSloBurnRateGauge.labels(rule.name, "slow").set(
                round(burn_slow, 4))
            st = self.state.setdefault(rule.name,
                                       {"firing": False, "since": 0.0})
            bf_thr, bs_thr = rule.thresholds()
            alert = {"rule": rule.name, "kind": rule.kind,
                     "objective": rule.objective,
                     "burn_fast": round(burn_fast, 4),
                     "burn_slow": round(burn_slow, 4),
                     "thresholds": {"fast": bf_thr, "slow": bs_thr},
                     "detail": detail}
            if not st["firing"] and burn_fast >= bf_thr \
                    and burn_slow >= bs_thr:
                st["firing"], st["since"] = True, self.now()
                self._transition(rule, alert, True)
            elif st["firing"] and burn_fast < 1.0:
                st["firing"] = False
                self._transition(rule, alert, False)
            alert["firing"] = st["firing"]
            alert["since"] = round(st["since"], 3) if st["firing"] else None
            _stats.ClusterSloAlertGauge.labels(rule.name).set(
                1.0 if st["firing"] else 0.0)
            out[rule.name] = alert
        return out

    def _transition(self, rule: Rule, alert: dict, firing: bool):
        to = "fire" if firing else "clear"
        _stats.ClusterSloTransitionsCounter.labels(rule.name, to).inc()
        self.journal.emit(
            _events.ALERT_FIRE if firing else _events.ALERT_CLEAR,
            service="master", node=rule.name,
            detail={"kind": rule.kind,
                    "burn_fast": alert["burn_fast"],
                    "burn_slow": alert["burn_slow"],
                    "detail": alert["detail"]})
        if self.on_transition is not None:
            try:
                self.on_transition(rule, alert, firing)
            except Exception:
                pass  # a push hook must never kill the evaluator

    def firing(self) -> List[str]:
        return sorted(n for n, st in self.state.items() if st["firing"])
