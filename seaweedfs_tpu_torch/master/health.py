"""Leader-resident cluster health plane.

One thread on the raft leader scrapes every registered daemon's
``/metrics`` (already fleet-merged across prefork workers by the
aggregation route) into the bounded ring TSDB, runs the SLO burn-rate
evaluator, and folds remote event journals into the leader's — so
``GET /cluster/health`` answers "is the cluster healthy" from a single
place, ``GET /cluster/alerts`` lists firing burn-rate alerts, and
``GET /cluster/events`` is the ordered cluster history.

Resilience: each target gets its own deadline (``rpc/policy.py``
deadline machinery) so one daemon hanging mid-exposition cannot stall
the round; failures count in
``SeaweedFS_cluster_scrape_errors_total{target}`` and flip the
target's liveness series, which is exactly what the availability SLO
rule watches.

Knobs: ``WEED_HEALTH_SCRAPE_MS`` (cadence, default 5000),
``WEED_HEALTH_DEADLINE_MS`` (per-target budget, default 1000).

The port's own copy of seaweedfs_tpu/master/health.py.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..maintenance import detectors
from ..maintenance.jobs import (TYPE_DEEP_SCRUB, TYPE_EC_REBUILD,
                                TYPE_FIX_REPLICATION)
from ..rpc import policy
from ..stats import access as access_mod
from ..stats import events as events_mod
from ..stats import metrics as _stats
from ..stats import slo as slo_mod
from ..stats import tsdb as tsdb_mod
from ..util import glog


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def scrape_interval() -> float:
    return max(0.05, _env_float("WEED_HEALTH_SCRAPE_MS", 5000.0) / 1000.0)


def target_deadline() -> float:
    return max(0.05, _env_float("WEED_HEALTH_DEADLINE_MS", 1000.0) / 1000.0)


class HealthPlane:
    def __init__(self, master):
        self.master = master
        self.now = time.time  # fake-clock seam
        self.tsdb = tsdb_mod.Tsdb(interval=scrape_interval(), now=self.now)
        self.journal = events_mod.JOURNAL
        self.slo = slo_mod.SloEngine(self.tsdb, now=self.now,
                                     on_transition=self._on_transition,
                                     journal=self.journal)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # workload analytics: one access summary per daemon, merged on
        # demand behind GET /cluster/usage (stats/access.py)
        self.usage = access_mod.UsageAggregator(now=self.now)
        self._up: Dict[str, int] = {}      # target -> last liveness
        self._evt_cursor: Dict[str, int] = {}   # target -> remote seq
        self._evt_skip: set = set()        # same-process targets
        self.rounds = 0
        self.busy_seconds = 0.0
        self._duty = 0.0
        self._last_slo: Dict[str, dict] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="health-plane", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(scrape_interval()):
            if not self.master.raft.is_leader:
                continue
            try:
                self.scrape_round()
            except Exception as e:  # the plane must outlive any scrape
                glog.warning(f"health plane round failed: {e}")

    # -- scraping ------------------------------------------------------------
    def targets(self) -> Dict[str, str]:
        """address -> kind, from every registry the master keeps:
        raft peers (masters), the heartbeat topology (volume servers)
        and /cluster/register members (filers, s3 gateways)."""
        out: Dict[str, str] = {}
        for peer in self.master.raft.peers:
            out[peer] = "master"
        with self.master.topo.lock:
            for url in self.master.topo.nodes:
                out.setdefault(url, "volume")
        for (typ, addr) in list(self.master._members):
            out.setdefault(addr, typ)
        return out

    def _priority_families(self) -> set:
        fams = {slo_mod.LIVENESS_FAMILY}
        for rule in self.slo.rules():
            fams.add(rule.family)
        return fams

    def scrape_round(self) -> dict:
        """One pass: scrape every target under its own deadline, feed
        the TSDB, fold remote journals in, evaluate SLO rules."""
        t0 = time.perf_counter()
        ts = self.now()
        targets = self.targets()
        budget = target_deadline()
        priority = self._priority_families()
        # a reaped/deregistered target must stop exporting liveness:
        # its stale gauge series would otherwise read as a permanent 0
        for gone in set(self._up) - set(targets):
            del self._up[gone]
            _stats.ClusterTargetUpGauge.remove(gone)
            self._evt_cursor.pop(gone, None)
            self._evt_skip.discard(gone)
        for addr, kind in targets.items():
            up = 0
            try:
                with policy.deadline_scope(timeout=budget):
                    text = policy.call_policy(
                        addr, "/metrics", timeout=budget, parse=False,
                        retries=0, breaker=False)
                if isinstance(text, bytes):
                    text = text.decode("utf-8", "replace")
                self.tsdb.ingest(addr, text, ts=ts, priority=priority)
                up = 1
            except Exception:
                _stats.ClusterScrapeErrorsCounter.labels(addr).inc()
            self.tsdb.put(slo_mod.LIVENESS_FAMILY,
                          {"target": addr, "kind": kind}, float(up),
                          tsdb_mod.GAUGE, ts=ts)
            _stats.ClusterTargetUpGauge.labels(addr, kind).set(float(up))
            prev = self._up.get(addr)
            if prev is not None and prev != up:
                self.journal.emit(
                    events_mod.NODE_UP if up else events_mod.NODE_DOWN,
                    service=kind, node=addr)
            self._up[addr] = up
            if up:
                self._pull_events(addr, budget)
                if kind != "volume":
                    # filer / S3 summaries come over the scrape loop;
                    # volume servers' ride their heartbeat (below)
                    self._pull_access(addr, budget)
        with self.master.topo.lock:
            beats = {url: dict(node.access)
                     for url, node in self.master.topo.nodes.items()
                     if getattr(node, "access", None)}
        for url, summary in beats.items():
            self.usage.ingest(url, summary)
        # the hot-key check merges every part's sketches — do it every
        # few rounds, not per-scrape (usage_view also checks on demand)
        if self.rounds % 5 == 0:
            try:
                self.usage.maybe_emit_hot_key(node=self.master.address)
            except Exception as e:
                glog.warning(f"hot-key check failed: {e}")
        self._last_slo = self.slo.evaluate()
        self.rounds += 1
        busy = time.perf_counter() - t0
        self.busy_seconds += busy
        self._duty = 0.7 * self._duty + 0.3 * (busy / scrape_interval())
        _stats.ClusterScrapeRoundsCounter.inc()
        _stats.ClusterScrapeDutyGauge.set(round(self._duty, 6))
        return self._last_slo

    def _pull_events(self, addr: str, budget: float):
        """Merge a remote daemon's journal (per-target cursor; a target
        sharing this process's global journal is detected by its token
        and skipped forever)."""
        if addr in self._evt_skip:
            return
        try:
            with policy.deadline_scope(timeout=budget):
                resp = policy.call_policy(
                    addr,
                    f"/cluster/events?since={self._evt_cursor.get(addr, 0)}",
                    timeout=budget, retries=0, breaker=False)
        except Exception:
            return
        if not isinstance(resp, dict):
            return
        if resp.get("journal") == self.journal.token:
            self._evt_skip.add(addr)
            return
        self.journal.merge(resp.get("events") or [])
        self._evt_cursor[addr] = int(resp.get("seq") or 0)

    def _pull_access(self, addr: str, budget: float):
        """Fetch a non-heartbeating daemon's access-sketch summary
        (GET /debug/access) into the usage aggregator.  Daemons
        without the route (older builds, masters) are just skipped."""
        try:
            with policy.deadline_scope(timeout=budget):
                resp = policy.call_policy(addr, "/debug/access",
                                          timeout=budget, retries=0,
                                          breaker=False)
        except Exception:
            return
        if isinstance(resp, dict) and "hot" in resp:
            self.usage.ingest(addr, resp)

    # -- alert push-downs ----------------------------------------------------
    def firing(self) -> List[str]:
        """Names of firing alerts — the curator passes these into
        scan_scale() as the opt-in WEED_SCALE_ON_ALERT trigger."""
        return self.slo.firing()

    def _on_transition(self, rule, alert, firing: bool):
        """An availability alert is actionable now, not on the next
        curator interval: run the repair detectors immediately and
        push their specs (fix.replication / ec.rebuild / deep.scrub of
        volumes on down servers) into the maintenance queue."""
        if not firing or rule.kind != "availability":
            return
        curator = getattr(self.master, "curator", None)
        if curator is None or not curator.enabled:
            return
        try:
            snap = detectors.snapshot(self.master.topo)
            specs = [s for s in detectors.scan(
                snap, now=self.now(), last_scrub=curator.last_scrub,
                vacuum_enabled=False, scale_enabled=False)
                if s["type"] in (TYPE_FIX_REPLICATION, TYPE_EC_REBUILD)]
            if alert.get("detail", {}).get("down"):
                # a down server may hold any shard: verify EC parity
                # now, bounded — the periodic sweep owns the long tail
                for e in snap.get("ec", [])[:8]:
                    specs.append({"type": TYPE_DEEP_SCRUB,
                                  "volume": e["id"],
                                  "collection": e["collection"],
                                  "params": {"from": rule.name}})
            for spec in specs:
                jid = curator.queue.enqueue(
                    spec["type"], spec["volume"], spec["collection"],
                    dict(spec["params"], alert=rule.name))
                if jid is not None:
                    self.journal.emit(events_mod.JOB_ENQUEUED,
                                      service="master",
                                      node=spec["type"],
                                      detail={"volume": spec["volume"],
                                              "alert": rule.name})
        except Exception as e:
            glog.warning(f"alert push to curator failed: {e}")

    # -- HTTP surface --------------------------------------------------------
    def health(self) -> dict:
        """The single JSON rollup behind GET /cluster/health."""
        targets = self.targets()
        liveness = {addr: bool(self._up.get(addr, 1))
                    for addr in targets}
        alerts = [a for a in self._last_slo.values() if a.get("firing")]
        status = "ok"
        if any(not up for up in liveness.values()) or alerts:
            status = "degraded"
        if any(a.get("kind") == "availability" for a in alerts):
            status = "critical"
        return {
            "status": status,
            "is_leader": self.master.raft.is_leader,
            "leader": self.master.raft.leader or "",
            "now": round(self.now(), 3),
            "nodes": {addr: {"kind": targets[addr], "up": liveness[addr]}
                      for addr in targets},
            "slo": self._last_slo,
            "alerts": alerts,
            "events": self.journal.since(limit=20),
            "scrape": {"interval_ms": scrape_interval() * 1000,
                       "deadline_ms": target_deadline() * 1000,
                       "rounds": self.rounds,
                       "duty": round(self._duty, 6)},
            "tsdb": self.tsdb.stats(),
        }

    def alerts(self) -> dict:
        return {"alerts": [a for a in self._last_slo.values()
                           if a.get("firing")],
                "rules": self._last_slo,
                "firing": self.firing()}

    def usage_view(self, req) -> dict:
        try:
            topk = int(req.param("topk", 0) or 0)
        except (TypeError, ValueError):
            topk = 0
        usage = self.usage.usage(topk=topk or None)
        try:
            self.usage.maybe_emit_hot_key(usage=usage,
                                          node=self.master.address)
        except Exception as e:
            glog.warning(f"hot-key check failed: {e}")
        return usage

    def mount(self, server):
        server.add("GET", "/cluster/health", lambda r: self.health())
        server.add("GET", "/cluster/alerts", lambda r: self.alerts())
        server.add("GET", "/cluster/usage", self.usage_view)
        events_mod.mount(server, self.journal)
