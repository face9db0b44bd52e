"""The curator: leader-resident continuous maintenance scheduler.

Runs next to the master's topology: a detector pass every
WEED_MAINT_INTERVAL seconds (leader only) snapshots heartbeat state,
turns anomalies into typed jobs, and feeds the persistent deduped
priority queue.  Volume servers lease jobs over /maintenance/lease,
renew while executing, and report complete/fail; a worker that dies
mid-job simply stops renewing and the lease expiry requeues the work.

The curator also owns the last-deep-scrub clock per EC volume (the
heartbeats carry no scrub timestamps) and converts deep-scrub findings
into rebuild jobs — detect once, repair automatically.

The port's own copy of seaweedfs_tpu/maintenance/curator.py.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..util import glog
from . import detectors
from .jobs import (JOB_TYPES, LEASED, TYPE_SHARD_SPLIT,
                   TYPE_BALANCE, TYPE_DEEP_SCRUB,
                   TYPE_EC_REBUILD, TYPE_SCALE_DRAIN, TYPE_SCALE_UP,
                   TYPE_TIER_MOVE, Job)
from .queue import JobQueue


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class RaftQueueProxy:
    """JobQueue facade that commits every mutation through the raft log
    before acknowledging it.  Reads come straight from the local FSM's
    queue (each replica applies the same committed commands, so the view
    is the replicated truth); writes become `curator.*` commands whose
    knob-derived inputs (lease duration, attempt cap, backoff) are
    pinned by THIS proposer, keeping the apply deterministic across
    replicas with drifted env config.

    On a follower, every mutation raises the raft 409 with a leader
    hint — exactly what /maintenance/* should return there."""

    def __init__(self, raft):
        self.raft = raft
        self.now = time.time  # fake-clock seam, mirrors JobQueue

    @property
    def _q(self) -> JobQueue:
        return self.raft.fsm.queue

    # -- replicated mutations -------------------------------------------------
    def enqueue(self, type_: str, volume: int = 0, collection: str = "",
                params: Optional[dict] = None,
                priority: Optional[int] = None) -> Optional[str]:
        return self.raft.propose({
            "type": "curator.enqueue", "now": self.now(),
            "job_type": type_, "volume": int(volume),
            "collection": collection, "params": dict(params or {}),
            "priority": priority})

    def lease(self, worker: str, types: Optional[list] = None,
              limit: int = 1,
              ec_volumes: Optional[list] = None) -> list[dict]:
        return self.raft.propose({
            "type": "curator.lease", "now": self.now(),
            "worker": worker, "types": types, "limit": int(limit),
            "ec_volumes": ec_volumes,
            "lease_seconds": self.lease_seconds}) or []

    def renew(self, job_id: str, worker: str) -> bool:
        return bool(self.raft.propose({
            "type": "curator.renew", "now": self.now(),
            "id": job_id, "worker": worker,
            "lease_seconds": self.lease_seconds}))

    def complete(self, job_id: str, worker: str,
                 outcome: str = "ok") -> Optional[Job]:
        d = self.raft.propose({
            "type": "curator.done", "now": self.now(),
            "id": job_id, "worker": worker, "outcome": outcome})
        return Job.from_dict(d) if d else None

    def fail(self, job_id: str, worker: str, error: str) -> Optional[Job]:
        d = self.raft.propose({
            "type": "curator.fail", "now": self.now(),
            "id": job_id, "worker": worker, "error": str(error),
            "max_attempts": self._q.max_attempts,
            "backoff": self._q.retry_backoff})
        return Job.from_dict(d) if d else None

    def expire_leases(self) -> list[str]:
        # probe locally first: proposing an expire command on every tick
        # would grow the log with no-ops, so only pay a quorum round when
        # some lease has actually lapsed
        now = self.now()
        q = self._q
        with q._lock:
            any_expired = any(
                j.state == LEASED and j.lease_expires < now
                for j in q._jobs.values())
        if not any_expired:
            return []
        return self.raft.propose(
            {"type": "curator.expire", "now": now}) or []

    @property
    def paused(self) -> bool:
        return self._q.paused

    @paused.setter
    def paused(self, value: bool):
        self.raft.propose({"type": "curator.pause", "now": self.now(),
                           "paused": bool(value)})

    # -- read-through views ---------------------------------------------------
    @property
    def lease_seconds(self) -> float:
        return self._q.lease_seconds

    @property
    def history(self):
        return self._q.history

    def get(self, job_id: str) -> Optional[Job]:
        return self._q.get(job_id)

    def stats(self) -> dict:
        return self._q.stats()

    def jobs(self) -> list[dict]:
        return self._q.jobs()


class Curator:
    def __init__(self, master, journal_dir: str = "",
                 interval: Optional[float] = None):
        self.master = master
        self._interval = interval
        raft = getattr(master, "raft", None)
        if getattr(raft, "fsm", None) is not None \
                and hasattr(raft, "propose"):
            # the raft log IS the journal: a failed-over leader resumes
            # with the exact pending/leased set, committed before ack
            self.queue = RaftQueueProxy(raft)
        else:
            journal = (os.path.join(journal_dir, "maintenance.jlog")
                       if journal_dir else "")
            self.queue = JobQueue(journal_path=journal)
        self.last_scrub: dict[int, float] = {}
        self._recent: dict[tuple, float] = {}  # (type, vid) -> done at
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.enabled = os.environ.get("WEED_MAINT", "1") != "0"
        self.scans = 0
        self.enqueued = 0
        self.now = time.time  # fake-clock seam
        # health plane seam: returns the names of firing SLO alerts so
        # scan_scale() can use them as an opt-in scale-up trigger
        self.alerts_fn = None

    @property
    def interval(self) -> float:
        if self._interval is not None:
            return self._interval
        return _env_float("WEED_MAINT_INTERVAL", 30.0)

    def cooldown(self) -> float:
        return _env_float("WEED_MAINT_COOLDOWN", 60.0)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="curator", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval):
            if not self.master.raft.is_leader:
                continue
            try:
                self.tick()
            except Exception as e:  # detector bugs must not kill the loop
                glog.warning(f"curator tick failed: {e}")

    # -- one detector pass ---------------------------------------------------
    def tick(self) -> list[str]:
        """Expire dead-worker leases, scan topology, enqueue.  Returns
        the ids enqueued this pass (for /maintenance/run)."""
        self.queue.expire_leases()
        snap = detectors.snapshot(self.master.topo)
        now = self.now()
        vacuum_on = getattr(self.master, "auto_vacuum_interval", 0) > 0
        alerts = None
        if self.alerts_fn is not None:
            try:
                alerts = self.alerts_fn()
            except Exception:
                alerts = None
        specs = detectors.scan(
            snap, now=now, last_scrub=self.last_scrub,
            garbage_threshold=getattr(self.master, "garbage_threshold",
                                      0.3),
            vacuum_enabled=vacuum_on, alerts=alerts)
        if detectors.heat_tier_enabled():
            # heat-driven placement hints over the leader's merged
            # access-sketch view (stats/access.py UsageAggregator)
            usage = None
            health = getattr(self.master, "health", None)
            if health is not None:
                try:
                    usage = health.usage.usage()
                except Exception:
                    usage = None
            specs.extend(detectors.scan_temperature(snap, usage))
        self.scans += 1
        ids = []
        cooldown = self.cooldown()
        for spec in specs:
            done_at = self._recent.get((spec["type"], spec["volume"]), 0)
            if now - done_at < cooldown:
                continue  # just repaired; wait for heartbeats to settle
            jid = self.queue.enqueue(spec["type"], spec["volume"],
                                     spec["collection"], spec["params"])
            if jid is not None:
                ids.append(jid)
                self.enqueued += 1
                from ..stats import events as events_mod

                if spec["type"] in (TYPE_SCALE_UP, TYPE_SCALE_DRAIN):
                    from ..stats import metrics as stats

                    action = ("up" if spec["type"] == TYPE_SCALE_UP
                              else "drain")
                    stats.ScaleEventsCounter.labels(action).inc()
                    events_mod.emit(
                        events_mod.SCALE_UP if action == "up"
                        else events_mod.SCALE_DRAIN,
                        service="master", node=spec["type"],
                        detail=dict(spec["params"]))
                elif spec["type"] == TYPE_TIER_MOVE:
                    events_mod.emit(
                        events_mod.TIER_MOVE, service="master",
                        node=spec["type"],
                        detail=dict(spec["params"],
                                    volume=spec["volume"]))
                else:
                    events_mod.emit(events_mod.JOB_ENQUEUED,
                                    service="master", node=spec["type"],
                                    detail={"id": jid,
                                            "volume": spec["volume"]})
        self._scan_shard_scale(now, cooldown)
        return ids

    def _scan_shard_scale(self, now: float, cooldown: float):
        """Shard-count elasticity: unlike volume-server jobs these are
        not queued for workers — the curator proposes the filer.resize
        directly and the master's driver completes the two-phase flip."""
        raft = getattr(self.master, "raft", None)
        if raft is None or getattr(raft, "fsm", None) is None \
                or not hasattr(raft, "lock"):
            return
        with raft.lock:
            m = raft.fsm.shard_map
            shards = {"slots": m.slots,
                      "holders": sum(1 for exp in m.members.values()
                                     if exp > now),
                      "resize": m.resize is not None}
        for spec in detectors.scan_shard_scale(shards):
            if now - self._recent.get((spec["type"], 0), 0) < cooldown:
                continue
            try:
                r = raft.propose({"type": "filer.resize", "op": "start",
                                  "to": int(spec["params"]["to"]),
                                  "now": now})
            except Exception:
                continue  # lost leadership mid-tick: next leader rescans
            if isinstance(r, dict) and r.get("error"):
                continue
            self._recent[(spec["type"], 0)] = now
            from ..stats import events as events_mod

            events_mod.emit(
                events_mod.SHARD_SPLIT
                if spec["type"] == TYPE_SHARD_SPLIT
                else events_mod.SHARD_MERGE,
                service="master", node="curator",
                detail=dict(spec["params"], phase="prepare"))

    # -- completion hook -----------------------------------------------------
    def on_complete(self, job, report: Optional[dict]):
        self._recent[(job.type, job.volume)] = self.now()
        from ..stats import events as events_mod

        events_mod.emit(events_mod.JOB_DONE, service="master",
                        node=job.type,
                        detail={"id": job.id, "volume": job.volume,
                                "outcome": job.outcome})
        if job.type == TYPE_DEEP_SCRUB:
            self.last_scrub[job.volume] = self.now()
            # scrub findings close the loop: corruption becomes a
            # rebuild job right now, not on the next detector pass
            if report and (report.get("corrupt")
                           or report.get("parity_mismatch")
                           or report.get("missing")):
                self.queue.enqueue(
                    TYPE_EC_REBUILD, job.volume, job.collection,
                    {"from": "deep.scrub",
                     "corrupt": report.get("corrupt", []),
                     "missing": report.get("missing", [])})
        if job.type == TYPE_SCALE_UP:
            # the newcomer joins empty: immediately re-shard hot
            # collections onto it under live traffic (the balance
            # worker runs as background QoS, so interactive isolation
            # bounds hold during the move)
            self.queue.enqueue(
                TYPE_BALANCE, 0, "",
                {"from": "scale.up", "kinds": ["ec", "volume"]})

    # -- admin surface -------------------------------------------------------
    def status(self) -> dict:
        return {"enabled": self.enabled,
                "leader": bool(self.master.raft.is_leader),
                "interval": self.interval,
                "scans": self.scans, "enqueued": self.enqueued,
                "autoscale": {
                    "enabled": os.environ.get("WEED_SCALE", "0")
                    not in ("0", "", "false", "no"),
                    "up_occupancy": _env_float("WEED_SCALE_UP_OCC", 0.75),
                    "drain_occupancy": _env_float(
                        "WEED_SCALE_DRAIN_OCC", 0.15),
                    "min_nodes": int(_env_float(
                        "WEED_SCALE_MIN_NODES", 1))},
                "queue": self.queue.stats(),
                "last_scrub": {str(k): round(v, 3)
                               for k, v in self.last_scrub.items()}}

    def mount(self, server, guard):
        """Register /maintenance/* on the master's RpcServer.  Worker
        endpoints (lease/renew/complete/fail) are open like
        /api/heartbeat; operator endpoints go through the IP guard."""
        s = server

        def status(req):
            return self.status()

        def queue_view(req):
            return {"jobs": self.queue.jobs(),
                    "history": list(self.queue.history)[-50:]}

        def lease(req):
            d = req.json()
            types = d.get("types") or list(JOB_TYPES)
            jobs = self.queue.lease(d.get("worker", ""), types,
                                    int(d.get("limit", 1)),
                                    ec_volumes=d.get("ec_volumes"))
            return {"jobs": jobs,
                    "lease_seconds": self.queue.lease_seconds}

        def renew(req):
            d = req.json()
            return {"ok": self.queue.renew(d.get("id", ""),
                                           d.get("worker", ""))}

        def complete(req):
            d = req.json()
            job = self.queue.complete(d.get("id", ""),
                                      d.get("worker", ""),
                                      d.get("outcome", "ok"))
            if job is not None:
                self.on_complete(job, d.get("report"))
            return {"ok": job is not None}

        def fail(req):
            d = req.json()
            job = self.queue.fail(d.get("id", ""), d.get("worker", ""),
                                  d.get("error", ""))
            return {"ok": job is not None,
                    "state": job.state if job else "lost"}

        def pause(req):
            d = req.json()
            self.queue.paused = bool(d.get("paused", True))
            return {"paused": self.queue.paused}

        def run(req):
            d = req.json()
            if d.get("type"):  # enqueue one explicit job
                jid = self.queue.enqueue(
                    d["type"], int(d.get("volume", 0)),
                    d.get("collection", ""), d.get("params") or {})
                return {"enqueued": [jid] if jid else []}
            return {"enqueued": self.tick()}

        s.add("GET", "/maintenance/status", status)
        s.add("GET", "/maintenance/queue", guard(queue_view))
        s.add("POST", "/maintenance/lease", lease)
        s.add("POST", "/maintenance/renew", renew)
        s.add("POST", "/maintenance/complete", complete)
        s.add("POST", "/maintenance/fail", fail)
        s.add("POST", "/maintenance/pause", guard(pause))
        s.add("POST", "/maintenance/run", guard(run))
