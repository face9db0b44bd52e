"""Persistent, deduped, priority job queue for the curator.

Every mutation appends one JSON line to a journal file, so a restarted
(or newly elected) master replays the journal and resumes with the
same pending/leased set — jobs survive failover.  The journal is
compacted in place once it grows well past the live set.

Leases carry an expiry: a worker that stops renewing (crashed,
partitioned) loses the job, which silently returns to pending for the
next `lease()` call.  `self.now` is a monkeypatchable seam (like
rpc.policy.now) so lease-expiry tests run on a fake clock.

The port's own copy of seaweedfs_tpu/maintenance/queue.py.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from ..stats import metrics
from .jobs import DONE, LEASED, PENDING, PRIORITIES, Job


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class JobQueue:
    def __init__(self, journal_path: str = "",
                 lease_seconds: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 retry_backoff: float = 5.0):
        self.now = time.time  # fake-clock seam for tests
        self.journal_path = journal_path
        self._lease_seconds = lease_seconds
        self._max_attempts = max_attempts
        self.retry_backoff = retry_backoff
        self._lock = threading.RLock()
        self._jobs: dict[str, Job] = {}       # live (pending/leased)
        self._by_key: dict[tuple, str] = {}   # dedupe index
        self._seq = 0
        self._journal_lines = 0
        self.paused = False
        self.history: deque = deque(maxlen=256)  # finished job dicts
        if journal_path:
            self._replay()

    # -- knobs (re-read at use time, WEED_* convention) ----------------------
    @property
    def lease_seconds(self) -> float:
        if self._lease_seconds is not None:
            return self._lease_seconds
        return _env_float("WEED_MAINT_LEASE", 60.0)

    @property
    def max_attempts(self) -> int:
        if self._max_attempts is not None:
            return self._max_attempts
        return int(_env_float("WEED_MAINT_ATTEMPTS", 5))

    # -- journal -------------------------------------------------------------
    def _replay(self):
        if not os.path.exists(self.journal_path):
            return
        with open(self.journal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail write from a crash
                self._journal_lines += 1
                if rec.get("op") == "set":
                    job = Job.from_dict(rec["job"])
                    self._jobs[job.id] = job
                    self._by_key[job.key] = job.id
                    try:
                        self._seq = max(self._seq, int(job.id[1:]))
                    except ValueError:
                        pass
                elif rec.get("op") == "del":
                    job = self._jobs.pop(rec["id"], None)
                    if job is not None and \
                            self._by_key.get(job.key) == job.id:
                        del self._by_key[job.key]
        # a replayed lease belongs to a worker from before the restart;
        # let it expire naturally (the worker may still be running it)

    def _append(self, rec: dict):
        if not self.journal_path:
            return
        with open(self.journal_path, "a") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._journal_lines += 1
        if self._journal_lines > max(64, 8 * (len(self._jobs) + 1)):
            self._compact()

    def _compact(self):
        # crash-atomic: the live set is fully durable in the tmp file
        # BEFORE the rename swaps it in, so a kill at any instant leaves
        # either the complete old journal or the complete new one
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w") as f:
            for job in self._jobs.values():
                f.write(json.dumps({"op": "set", "job": job.to_dict()},
                                   separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.journal_path)
        try:
            dir_fd = os.open(os.path.dirname(self.journal_path) or ".",
                             os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except OSError:
            pass  # the rename itself is still atomic without the dir sync
        self._journal_lines = len(self._jobs)

    def _sync_metrics(self):
        counts = {PENDING: 0, LEASED: 0}
        for job in self._jobs.values():
            counts[job.state] = counts.get(job.state, 0) + 1
        for state, n in counts.items():
            metrics.MaintQueueJobsGauge.labels(state).set(n)

    # -- producer side -------------------------------------------------------
    def enqueue(self, type_: str, volume: int = 0, collection: str = "",
                params: Optional[dict] = None,
                priority: Optional[int] = None) -> Optional[str]:
        """Add a job unless one is already live for the same target.
        Returns the job id, or None when deduped."""
        with self._lock:
            key = (type_, volume, collection)
            if key in self._by_key:
                return None
            self._seq += 1
            job = Job(id=f"j{self._seq}", type=type_, volume=volume,
                      collection=collection, params=dict(params or {}),
                      priority=(PRIORITIES.get(type_, 9)
                                if priority is None else priority),
                      created_at=self.now())
            self._jobs[job.id] = job
            self._by_key[key] = job.id
            self._append({"op": "set", "job": job.to_dict()})
            self._sync_metrics()
            return job.id

    # -- worker side ---------------------------------------------------------
    def lease(self, worker: str, types: Optional[list] = None,
              limit: int = 1,
              ec_volumes: Optional[list] = None) -> list[dict]:
        """Hand out up to `limit` pending jobs, best priority first.
        `ec_volumes` (the worker's locally-held EC volumes) scopes
        deep-scrub jobs to holders — scrubbing needs the local .vif
        CRC record and most shard bytes on local disk; every other
        job type executes via RPC and goes to any worker."""
        with self._lock:
            if self.paused:
                return []
            now = self.now()
            held = set(ec_volumes) if ec_volumes is not None else None
            ready = [j for j in self._jobs.values()
                     if j.state == PENDING and j.not_before <= now
                     and (not types or j.type in types)
                     and (j.type != "deep.scrub" or held is None
                          or j.volume in held)]
            ready.sort(key=lambda j: (j.priority, j.created_at, j.id))
            out = []
            for job in ready[:max(0, limit)]:
                job.state = LEASED
                job.worker = worker
                job.attempts += 1
                job.lease_expires = now + self.lease_seconds
                self._append({"op": "set", "job": job.to_dict()})
                out.append(job.to_dict())
            if out:
                self._sync_metrics()
            return out

    def renew(self, job_id: str, worker: str) -> bool:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != LEASED or job.worker != worker:
                return False
            job.lease_expires = self.now() + self.lease_seconds
            # heartbeat only — not worth a journal line per renewal
            return True

    def complete(self, job_id: str, worker: str,
                 outcome: str = "ok") -> Optional[Job]:
        """Finish a job; returns the job (for completion hooks) or
        None when the lease was lost (stale worker)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.worker != worker:
                return None
            return self._finish(job, outcome)

    def fail(self, job_id: str, worker: str, error: str) -> Optional[Job]:
        """Record a failure: requeue with backoff, or finish as
        'failed' once attempts are exhausted."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.worker != worker:
                return None
            job.last_error = str(error)[:500]
            if job.attempts >= self.max_attempts:
                return self._finish(job, "failed")
            job.state = PENDING
            job.worker = ""
            job.lease_expires = 0.0
            job.not_before = self.now() + self.retry_backoff
            self._append({"op": "set", "job": job.to_dict()})
            self._sync_metrics()
            return job

    def _finish(self, job: Job, outcome: str) -> Job:
        job.state = DONE
        job.outcome = outcome
        del self._jobs[job.id]
        if self._by_key.get(job.key) == job.id:
            del self._by_key[job.key]
        self._append({"op": "del", "id": job.id})
        self.history.append({**job.to_dict(), "finished_at": self.now()})
        metrics.MaintJobsCounter.labels(job.type, outcome).inc()
        self._sync_metrics()
        return job

    def expire_leases(self) -> list[str]:
        """Requeue jobs whose worker stopped renewing (dead/partitioned).
        Called from the curator tick."""
        with self._lock:
            now = self.now()
            expired = []
            for job in self._jobs.values():
                if job.state == LEASED and job.lease_expires < now:
                    job.state = PENDING
                    job.worker = ""
                    job.lease_expires = 0.0
                    job.last_error = job.last_error or "lease expired"
                    self._append({"op": "set", "job": job.to_dict()})
                    expired.append(job.id)
            if expired:
                self._sync_metrics()
            return expired

    # -- views ---------------------------------------------------------------
    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def stats(self) -> dict:
        with self._lock:
            by_state: dict[str, int] = {}
            by_type: dict[str, int] = {}
            for job in self._jobs.values():
                by_state[job.state] = by_state.get(job.state, 0) + 1
                by_type[job.type] = by_type.get(job.type, 0) + 1
            return {"live": len(self._jobs), "by_state": by_state,
                    "by_type": by_type, "paused": self.paused,
                    "finished": len(self.history)}

    def jobs(self) -> list[dict]:
        with self._lock:
            live = sorted(self._jobs.values(),
                          key=lambda j: (j.priority, j.created_at, j.id))
            return [j.to_dict() for j in live]
