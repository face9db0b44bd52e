"""The master's replicated state machine (command-typed FSM).

The reference fork runs hashicorp/raft with a MaxVolumeId-only FSM
(raft_server.go:78).  This FSM generalizes that into a command-typed
log covering everything a failed-over leader must resume with exactly:

  volume.assign     MaxVolumeId allocation (SetMax fold)
  topology.epoch    placement-generation bump (volume growth)
  curator.*         every maintenance/queue.py mutation
  filer.lease       the directory-prefix shard map for filer metadata
  filer.resize      online shard split/merge (two-phase prepare/commit)

Commands are plain JSON dicts carrying their own `now` timestamp, so
replaying the same log (or a snapshot + suffix) on a fresh node yields
a byte-identical FSM — the determinism the failover guarantees rest
on.  The curator queue inside the FSM runs journal-less: the raft log
and snapshots ARE its durability, so a journal replay never
double-applies on top of log replay.

The port's own copy of seaweedfs_tpu/master/fsm.py.
"""

from __future__ import annotations

from typing import Optional

from ..filer.shard_map import ShardMap
from ..maintenance.jobs import Job
from ..maintenance.queue import JobQueue


class ControlFSM:
    """Deterministic apply target for the raft log.  Not thread-safe by
    itself — the RaftNode applies commands under its own lock."""

    def __init__(self, shard_slots: Optional[int] = None):
        self.max_volume_id = 0
        self.topology_epoch = 0
        self._now = 0.0
        # journal-less queue: raft persistence replaces the jlog
        self.queue = JobQueue()
        self.queue.now = lambda: self._now
        self.shard_map = ShardMap(slots=shard_slots)

    # -- dispatch ------------------------------------------------------------
    def apply(self, cmd: dict):
        """Apply one committed command; returns the command's result
        (handed back to the proposer by RaftNode.propose).  Must never
        raise — a poisoned command would diverge replicas that handle
        the exception differently."""
        try:
            self._now = float(cmd.get("now", self._now))
            handler = self._HANDLERS.get(cmd.get("type", ""))
            if handler is None:
                return None
            return handler(self, cmd)
        except Exception:
            return None

    def _apply_volume_assign(self, cmd: dict):
        value = int(cmd.get("value", 0))
        if value > self.max_volume_id:
            self.max_volume_id = value
        return value

    def _apply_topology_epoch(self, cmd: dict):
        self.topology_epoch += 1
        return self.topology_epoch

    # -- curator queue mutations ---------------------------------------------
    # Knob-derived values (lease duration, attempt caps) ride in the
    # command, pinned by the proposing leader — two nodes with drifted
    # env config still apply identically.

    def _apply_curator_enqueue(self, cmd: dict):
        return self.queue.enqueue(
            cmd.get("job_type", ""), int(cmd.get("volume", 0)),
            cmd.get("collection", ""), cmd.get("params") or {},
            priority=cmd.get("priority"))

    def _with_lease_seconds(self, cmd: dict, fn):
        prev = self.queue._lease_seconds
        if cmd.get("lease_seconds") is not None:
            self.queue._lease_seconds = float(cmd["lease_seconds"])
        try:
            return fn()
        finally:
            self.queue._lease_seconds = prev

    def _apply_curator_lease(self, cmd: dict):
        return self._with_lease_seconds(cmd, lambda: self.queue.lease(
            cmd.get("worker", ""), cmd.get("types"),
            int(cmd.get("limit", 1)), ec_volumes=cmd.get("ec_volumes")))

    def _apply_curator_renew(self, cmd: dict):
        return self._with_lease_seconds(cmd, lambda: self.queue.renew(
            cmd.get("id", ""), cmd.get("worker", "")))

    def _apply_curator_done(self, cmd: dict):
        job = self.queue.complete(cmd.get("id", ""),
                                  cmd.get("worker", ""),
                                  cmd.get("outcome", "ok"))
        return job.to_dict() if job is not None else None

    def _apply_curator_fail(self, cmd: dict):
        prev_attempts = self.queue._max_attempts
        prev_backoff = self.queue.retry_backoff
        if cmd.get("max_attempts") is not None:
            self.queue._max_attempts = int(cmd["max_attempts"])
        if cmd.get("backoff") is not None:
            self.queue.retry_backoff = float(cmd["backoff"])
        try:
            job = self.queue.fail(cmd.get("id", ""),
                                  cmd.get("worker", ""),
                                  cmd.get("error", ""))
        finally:
            self.queue._max_attempts = prev_attempts
            self.queue.retry_backoff = prev_backoff
        return job.to_dict() if job is not None else None

    def _apply_curator_expire(self, cmd: dict):
        return self.queue.expire_leases()

    def _apply_curator_pause(self, cmd: dict):
        self.queue.paused = bool(cmd.get("paused", True))
        return self.queue.paused

    # -- filer shard leases ---------------------------------------------------
    def _apply_filer_lease(self, cmd: dict):
        if cmd.get("release"):
            return self.shard_map.release(cmd.get("holder", ""),
                                          self._now)
        return self.shard_map.lease(cmd.get("holder", ""), self._now,
                                    float(cmd.get("ttl", 10.0)))

    def _apply_filer_resize(self, cmd: dict):
        """Online shard split/merge, two-phase: start opens the prepare
        window (holders dual-write + re-shard locally), ack records one
        holder's readiness, commit flips the map, abort cancels."""
        op = cmd.get("op", "")
        if op == "start":
            return self.shard_map.resize_start(int(cmd.get("to", 0)),
                                               self._now)
        if op == "ack":
            return self.shard_map.resize_ack(cmd.get("holder", ""),
                                             self._now)
        if op == "commit":
            return self.shard_map.resize_commit(self._now)
        if op == "abort":
            return self.shard_map.resize_abort(self._now)
        return {"error": f"unknown resize op {op!r}"}

    _HANDLERS = {
        "volume.assign": _apply_volume_assign,
        "topology.epoch": _apply_topology_epoch,
        "curator.enqueue": _apply_curator_enqueue,
        "curator.lease": _apply_curator_lease,
        "curator.renew": _apply_curator_renew,
        "curator.done": _apply_curator_done,
        "curator.fail": _apply_curator_fail,
        "curator.expire": _apply_curator_expire,
        "curator.pause": _apply_curator_pause,
        "filer.lease": _apply_filer_lease,
        "filer.resize": _apply_filer_resize,
    }

    # -- snapshot / restore ----------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic JSON state: two FSMs that applied the same
        command sequence produce identical snapshots (sorted job order,
        no wall-clock reads)."""
        q = self.queue

        def _jid(job_id: str) -> int:
            try:
                return int(job_id[1:])
            except ValueError:
                return 0

        return {
            "max_volume_id": self.max_volume_id,
            "topology_epoch": self.topology_epoch,
            "now": self._now,
            "queue": {
                "seq": q._seq,
                "paused": q.paused,
                "jobs": [q._jobs[i].to_dict()
                         for i in sorted(q._jobs, key=_jid)],
                "history": list(q.history)[-64:],
            },
            "shards": self.shard_map.to_dict(),
        }

    def restore(self, snap: dict):
        snap = snap or {}
        self.max_volume_id = int(snap.get("max_volume_id", 0))
        self.topology_epoch = int(snap.get("topology_epoch", 0))
        self._now = float(snap.get("now", 0.0))
        qs = snap.get("queue", {})
        q = JobQueue()
        q.now = lambda: self._now
        q._seq = int(qs.get("seq", 0))
        q.paused = bool(qs.get("paused", False))
        for d in qs.get("jobs", []):
            job = Job.from_dict(d)
            q._jobs[job.id] = job
            q._by_key[job.key] = job.id
        for h in qs.get("history", []):
            q.history.append(dict(h))
        self.queue = q
        self.shard_map = ShardMap.from_dict(snap.get("shards", {}))
