"""Structured cluster event journal.

Every daemon appends noteworthy transitions — leader elections,
scale.up/drain, curator job transitions, fault-injection activations,
prefork worker respawns, read-only demotions — to a process-global
bounded ring.  Each event carries the active trace id when one is
live, so an operator can pivot from "what happened" straight into
``/debug/traces``.

Counterpart of seaweedfs_tpu/stats/events.py.  A leader merges remote
daemons' journals with a per-origin cursor; every journal carries a
random ``origin`` token so a merge never re-ingests its own events
(all-in-one processes share this module's global JOURNAL).  Every
daemon serves ``GET /cluster/events?since=<seq>`` (``follow=<seconds>``
streams) through :func:`mount`.

Knob: ``WEED_EVENTS_MAX`` — ring capacity per process (default 2048).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

from . import metrics as _stats

# event kinds emitted around the tree (free-form, these are the core set)
LEADER_ELECTED = "raft.leader"
LEADER_STEPDOWN = "raft.stepdown"
MEMBERSHIP = "raft.membership"
NODE_DOWN = "node.down"
NODE_UP = "node.up"
SCRAPE_ERROR = "scrape.error"
ALERT_FIRE = "alert.fire"
ALERT_CLEAR = "alert.clear"
JOB_ENQUEUED = "job.enqueued"
JOB_DONE = "job.done"
SCALE_UP = "scale.up"
SCALE_DRAIN = "scale.drain"
SHARD_SPLIT = "filer.shard_split"
SHARD_MERGE = "filer.shard_merge"
DRAIN = "vs.drain"
READONLY_DEMOTION = "vs.readonly"
WORKER_RESPAWN = "worker.respawn"
FAULTS_ACTIVE = "faults.active"
HOT_KEY = "access.hotkey"
TIER_MOVE = "tier.move"


def _cap() -> int:
    try:
        return max(16, int(os.environ.get("WEED_EVENTS_MAX", "") or 2048))
    except ValueError:
        return 2048


class EventJournal:
    def __init__(self, now: Callable[[], float] = time.time):
        self.token = uuid.uuid4().hex[:12]
        self.now = now  # fake-clock seam
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.events: deque = deque()
        self.seq = 0

    def emit(self, kind: str, service: str = "", node: str = "",
             detail: Optional[dict] = None,
             trace_id: Optional[str] = None,
             origin: Optional[str] = None,
             origin_seq: Optional[int] = None) -> dict:
        if trace_id is None:
            from .. import tracing

            span = tracing.current()
            trace_id = span.trace_id if span is not None else ""
        with self.cond:
            self.seq += 1
            ev = {"seq": self.seq, "ts": round(self.now(), 3),
                  "kind": kind, "service": service, "node": node,
                  "detail": detail or {}, "trace": trace_id or "",
                  "origin": origin or self.token,
                  "origin_seq": origin_seq if origin_seq is not None
                  else self.seq}
            self.events.append(ev)
            cap = _cap()
            while len(self.events) > cap:
                self.events.popleft()
            self.cond.notify_all()
        _stats.ClusterEventsCounter.labels(kind).inc()
        return ev

    def since(self, seq: int = 0, limit: int = 0) -> List[dict]:
        with self.lock:
            out = [e for e in self.events if e["seq"] > seq]
        return out[-limit:] if limit else out

    def wait(self, seq: int, timeout: float) -> List[dict]:
        """Block until an event newer than ``seq`` lands (or timeout);
        the chunked streaming handler's long-poll primitive."""
        deadline = time.time() + timeout
        with self.cond:
            while self.seq <= seq:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return []
                self.cond.wait(min(remaining, 0.5))
            return [e for e in self.events if e["seq"] > seq]

    def merge(self, events: List[dict]) -> int:
        """Fold a remote journal's events in (preserving their origin
        token + seq so cursors stay exact); returns how many landed.
        Events whose origin is this journal are skipped — in-process
        daemons all share the global JOURNAL and would echo forever."""
        n = 0
        cursors = self._origin_cursors()
        for e in events:
            origin = e.get("origin") or ""
            if not origin or origin == self.token:
                continue
            if e.get("origin_seq", 0) <= cursors.get(origin, 0):
                continue
            self.emit(e.get("kind", "event"), service=e.get("service", ""),
                      node=e.get("node", ""), detail=e.get("detail"),
                      trace_id=e.get("trace", ""), origin=origin,
                      origin_seq=e.get("origin_seq"))
            cursors[origin] = e.get("origin_seq", 0)
            n += 1
        return n

    def _origin_cursors(self) -> Dict[str, int]:
        with self.lock:
            out: Dict[str, int] = {}
            for e in self.events:
                o = e.get("origin", "")
                if e.get("origin_seq", 0) > out.get(o, 0):
                    out[o] = e["origin_seq"]
            return out

    def cursor_for(self, origin: str) -> int:
        return self._origin_cursors().get(origin, 0)


JOURNAL = EventJournal()


def emit(kind: str, service: str = "", node: str = "",
         detail: Optional[dict] = None, **kw) -> dict:
    """Module-level convenience: append to the process journal."""
    return JOURNAL.emit(kind, service=service, node=node, detail=detail,
                        **kw)


def events_handler(req, journal: Optional[EventJournal] = None):
    """``GET /cluster/events?since=N[&limit=M][&follow=seconds]``.

    Plain mode returns a JSON snapshot; ``follow`` streams newline-
    delimited JSON events over chunked transfer-encoding until the
    window elapses (Response iterator bodies already stream)."""
    from ..rpc.http_rpc import Response

    j = journal or JOURNAL
    try:
        since = int(req.param("since", 0) or 0)
        limit = int(req.param("limit", 0) or 0)
        follow = float(req.param("follow", 0) or 0)
    except (TypeError, ValueError):
        return Response(b'{"error": "bad cursor"}', status=400,
                        content_type="application/json")
    if follow <= 0:
        return {"journal": j.token, "seq": j.seq,
                "events": j.since(since, limit)}

    def stream():
        cursor = since
        deadline = time.time() + min(follow, 300.0)
        # first line identifies the journal so pollers learn the token
        yield (json.dumps({"journal": j.token, "seq": j.seq})
               + "\n").encode()
        while time.time() < deadline:
            fresh = j.wait(cursor, min(1.0, deadline - time.time()))
            for e in fresh:
                cursor = max(cursor, e["seq"])
                yield (json.dumps(e) + "\n").encode()

    return Response(stream(), content_type="application/x-ndjson")


def mount(server, journal: Optional[EventJournal] = None):
    """Register GET /cluster/events on an RpcServer (the faults.mount /
    qos.mount pattern) — every daemon serves its local journal; the
    master leader additionally serves the merged cluster view."""
    server.add("GET", "/cluster/events",
               lambda req: events_handler(req, journal))
