"""The Replicator: apply one metadata event to a sink.

Parity with weed/replication/replicator.go:40-100: path filtering against
the source dir and exclude list, incremental-sink date prefixes, and the
create/update/delete/rename dispatch — a rename arrives as one event with
both old and new entries whose paths differ, which fans out to
delete+create on the sink.

The port's own copy of seaweedfs_tpu/replication/replicator.py.  An
event whose entry the source no longer serves (`SourceGone`) is skipped,
not retried: the feed's later delete or rename of that path settles it.
"""

from __future__ import annotations

import time
from typing import Optional

from ..util import glog
from .sink import ReplicationSink, SourceGone
from .source import FilerSource


def _event_path(event: dict) -> str:
    return ((event.get("new_entry") or event.get("old_entry") or {})
            .get("full_path", ""))


def _is_dir(entry: Optional[dict]) -> bool:
    if not entry:
        return False
    return bool(entry.get("attr", {}).get("mode", 0) & 0o40000)


class Replicator:
    def __init__(self, source: FilerSource, sink: ReplicationSink,
                 exclude_dirs: Optional[list[str]] = None,
                 signature: int = 0):
        self.source = source
        self.sink = sink
        self.sink.set_source(source)
        self.exclude_dirs = exclude_dirs or []
        # events carrying this signature were produced by the opposite
        # direction of an active-active sync pair — skip them to break
        # replication loops (replicator.go IsFromOtherCluster check)
        self.signature = signature

    def _translate(self, key: str, entry: Optional[dict]) -> str:
        """Source path -> sink path, honoring the incremental date dir."""
        date_key = ""
        if self.sink.is_incremental:
            mtime = (entry or {}).get("attr", {}).get("mtime", 0) \
                or time.time()
            date_key = "/" + time.strftime("%Y-%m-%d", time.gmtime(mtime))
        return date_key + key[len(self.source.path) - 1:]

    def replicate(self, event: dict) -> bool:
        """Apply one metadata event; returns False if filtered out or if
        the source no longer serves the entry's content."""
        try:
            return self._replicate(event)
        except SourceGone as e:
            glog.infof("replicate %s: gone from the source, skipped", e)
            return False

    def _replicate(self, event: dict) -> bool:
        if self.signature and self.signature in event.get("signatures", []):
            return False
        old_entry, new_entry = event.get("old_entry"), event.get("new_entry")
        key = None
        for entry in (new_entry, old_entry):
            if entry:
                key = entry["full_path"]
                break
        if key is None or not key.startswith(self.source.path) \
                and key + "/" != self.source.path:
            return False
        for exclude in self.exclude_dirs:
            if key == exclude or key.startswith(exclude.rstrip("/") + "/"):
                return False

        if old_entry and not new_entry:
            self.sink.delete_entry(self._translate(key, old_entry),
                                   _is_dir(old_entry))
            return True
        if new_entry and not old_entry:
            self.sink.create_entry(self._translate(key, new_entry),
                                   new_entry, _is_dir(new_entry))
            return True
        if new_entry and old_entry:
            old_key = old_entry["full_path"]
            if old_key != key:  # rename: delete old location, create new
                if old_key.startswith(self.source.path):
                    self.sink.delete_entry(
                        self._translate(old_key, old_entry),
                        _is_dir(old_entry))
                self.sink.create_entry(self._translate(key, new_entry),
                                       new_entry, _is_dir(new_entry))
            else:
                self.sink.update_entry(self._translate(key, new_entry),
                                       old_entry, new_entry,
                                       _is_dir(new_entry))
            return True
        return False

    def run_once(self, since_ns: int = 0,
                 concurrency: int = 1) -> tuple[int, int]:
        """Poll the source feed once, apply everything; returns
        (events applied, new cursor).  On a sink failure the cursor stops
        *before* the failed event so the next poll retries it — a
        persisted cursor must never skip unreplicated data (the reference
        retries failed events instead of advancing).

        With concurrency > 1, events partition into lanes by path hash
        (filer_sync_jobs.go): per-path ordering is preserved inside a
        lane while lanes apply in parallel.  After a partial failure the
        cursor rolls back to just before the earliest failed event;
        later events that already succeeded re-apply idempotently."""
        if concurrency <= 1:
            applied, cursor = 0, since_ns
            for event in self.source.subscribe(since_ns):
                try:
                    if self.replicate(event):
                        applied += 1
                except Exception as e:
                    glog.errorf("replicate %s: %s (will retry)",
                                _event_path(event), e)
                    return applied, cursor
                cursor = max(cursor, event["ts_ns"])
            return applied, cursor

        from concurrent.futures import ThreadPoolExecutor

        events = list(self.source.subscribe(since_ns))
        if not events:
            return 0, since_ns
        applied = 0

        def run_lane(lane_events: list[dict]) -> tuple[int, int]:
            """(applied, ts of first failure or 0); lane stays serial."""
            n = 0
            for event in lane_events:
                try:
                    if self.replicate(event):
                        n += 1
                except Exception as e:
                    glog.errorf("replicate %s: %s (will retry)",
                                _event_path(event), e)
                    return n, event["ts_ns"]
            return n, 0

        def flush(batch: list[dict]) -> int:
            """Apply a batch of plain-FILE events in parallel lanes;
            returns ts of the earliest failure or 0."""
            nonlocal applied
            if not batch:
                return 0
            lanes: dict[int, list[dict]] = {}
            for event in batch:
                lanes.setdefault(
                    hash(_event_path(event)) % concurrency,
                    []).append(event)
            with ThreadPoolExecutor(max_workers=concurrency) as pool:
                results = list(pool.map(run_lane, lanes.values()))
            applied += sum(n for n, _ in results)
            fails = [ts for _, ts in results if ts]
            return min(fails) if fails else 0

        def is_barrier(event: dict) -> bool:
            """Renames span TWO paths and directory events order against
            their whole subtree (recursive deletes) — neither can fan
            out by single-path hash; they serialize at batch edges."""
            old_e, new_e = event.get("old_entry"), event.get("new_entry")
            if old_e and new_e and \
                    old_e.get("full_path") != new_e.get("full_path"):
                return True
            return _is_dir(new_e or old_e)

        batch: list[dict] = []
        for event in events:
            if not is_barrier(event):
                batch.append(event)
                continue
            fail_ts = flush(batch)
            batch = []
            if fail_ts:
                return applied, fail_ts - 1
            try:
                if self.replicate(event):
                    applied += 1
            except Exception as e:
                glog.errorf("replicate %s: %s (will retry)",
                            _event_path(event), e)
                return applied, event["ts_ns"] - 1
        fail_ts = flush(batch)
        if fail_ts:
            return applied, fail_ts - 1
        return applied, max(e["ts_ns"] for e in events)


def run_from_queue(queue_input, replicator: Replicator,
                   once: bool = False, idle_sleep: float = 1.0,
                   stop_event=None) -> int:
    """`weed filer.replicate` core loop (filer_replication.go:80-100):
    consume metadata events from a notification INPUT and apply each
    through the replicator, acking only after a successful apply so a
    crash retries the in-flight event.  Returns events applied (loops
    forever unless `once`, which drains the queue and returns)."""
    applied = 0
    while stop_event is None or not stop_event.is_set():
        msg = queue_input.receive_message()
        if msg is None:
            if once:
                return applied
            time.sleep(idle_sleep)
            continue
        key, event = msg
        try:
            if replicator.replicate(event):
                applied += 1
        except Exception as e:
            glog.errorf("filer.replicate %s: %s (will retry)", key, e)
            if once:
                return applied
            time.sleep(idle_sleep)
            continue  # NOT acked: the message replays next poll
        queue_input.ack()
    return applied
