"""Multi-filer HA: aggregate peer filers' metadata change feeds.

Parity with weed/filer/meta_aggregator.go + meta_replay.go: each filer
follows its peers' metadata subscriptions, merging their events into one
aggregated feed that downstream subscribers (replication, backup, other
filers) consume; a fresh filer bootstraps its store by replaying a peer's
feed from the beginning (filer.go:75-105).

The port's own copy of seaweedfs_tpu/filer/meta_aggregator.py.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..rpc.http_rpc import RpcError, call
from .entry import Entry
from .filer import LOG_BUFFER_CAPACITY, Filer
from .filer_store import NotFoundError


def apply_meta_event(filer: Filer, event: dict):
    """Replay one change event into a local filer (meta_replay.go
    ReplayMetadataEvent): create/update/delete/rename all reduce to
    delete-old + insert-new."""
    old, new = event.get("old_entry"), event.get("new_entry")
    if old and (not new or old["full_path"] != new["full_path"]):
        try:
            filer.store.delete_entry(old["full_path"])
        except NotFoundError:
            pass
    if new:
        entry = Entry.from_dict(new)
        filer._ensure_parents(entry.parent)
        filer.store.insert_entry(entry)


class MetaAggregator:
    def __init__(self, peers: list[str],
                 on_event: Optional[Callable[[str, dict], None]] = None,
                 poll_interval: float = 0.5):
        self.peers = list(peers)
        self.on_event = on_event
        self.poll_interval = poll_interval
        self._events: list[tuple[str, dict]] = []  # (peer, event)
        self._cursor: dict[str, int] = {p: 0 for p in self.peers}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self):
        for peer in self.peers:
            t = threading.Thread(target=self._follow, args=(peer,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    def poll_once(self, peer: str) -> int:
        """One subscription pull from a peer; returns new-event count."""
        since = self._cursor.get(peer, 0)
        r = call(peer, f"/metadata/subscribe?since={since}", timeout=10)
        events = r.get("events", [])
        if not events:
            return 0
        with self._lock:
            for e in events:
                self._events.append((peer, e))
                self._cursor[peer] = max(self._cursor.get(peer, 0),
                                         e["ts_ns"])
            if len(self._events) > LOG_BUFFER_CAPACITY:
                self._events = self._events[-LOG_BUFFER_CAPACITY:]
        if self.on_event:
            for e in events:
                self.on_event(peer, e)
        return len(events)

    def _follow(self, peer: str):
        while not self._stop.is_set():
            try:
                self.poll_once(peer)
            except RpcError:
                pass
            self._stop.wait(self.poll_interval)

    def events(self, since_ns: int = 0) -> list[dict]:
        """Merged feed across peers, timestamp-ordered."""
        with self._lock:
            merged = [e for _, e in self._events if e["ts_ns"] > since_ns]
        return sorted(merged, key=lambda e: e["ts_ns"])

    @staticmethod
    def bootstrap_from_peer(peer: str, filer: Filer) -> int:
        """Fresh-store catch-up: replay a peer's full feed into the local
        store (filer.go:75-94 maybeBootstrapFromPeers).  Returns count."""
        r = call(peer, "/metadata/subscribe?since=0", timeout=60)
        events = r.get("events", [])
        for e in events:
            apply_meta_event(filer, e)
        return len(events)
