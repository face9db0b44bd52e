"""Cluster-distributed filer store client.

`-store cluster`: the filer keeps no local metadata; it fetches the
slot→holder shard map from the masters (`/filer/shards`, served from
the replicated FSM so any master answers identically) and routes each
operation straight to the holder's store server.  On a routing miss —
holder gone, map rotated, lease moved — the map is refreshed once and
the operation retried; the store servers themselves proxy one hop, so
a slightly stale map still lands (filer/store_server.py).

This is the lease-based metadata partitioning of the "decoupled
metadata" lineage in PAPERS.md: the map is tiny and replicated, the
metadata bytes stay sharded on the holders.

The port's own copy of seaweedfs_tpu/filer/cluster_store.py.
"""

from __future__ import annotations

import threading
import urllib.parse
from typing import Optional

from ..rpc.http_rpc import RpcError, call
from .entry import Entry
from .filer_store import FilerStore, NotFoundError
from .shard_map import default_slots, slot_of


class ClusterStore(FilerStore):
    def __init__(self, masters: list[str] | str, timeout: float = 20.0):
        self.masters = ([masters] if isinstance(masters, str)
                        else list(masters))
        self.timeout = timeout
        self._lock = threading.Lock()
        self._map: dict[int, str] = {}
        self._slots = default_slots()
        self._epoch = -1

    # -- shard map ------------------------------------------------------------
    def _refresh_map(self):
        last: Optional[RpcError] = None
        for addr in self.masters:
            try:
                r = call(addr, "/filer/shards", timeout=5)
            except RpcError as e:
                last = e
                continue
            with self._lock:
                self._slots = int(r.get("slots") or self._slots)
                self._map = {int(k): v
                             for k, v in (r.get("map") or {}).items()}
                self._epoch = int(r.get("epoch", 0))
            return
        raise last or RpcError("no master reachable for shard map", 503)

    def _holder(self, dir_path: str, refresh: bool = False) -> str:
        with self._lock:
            empty = not self._map
        if refresh or empty:
            self._refresh_map()
        with self._lock:
            holder = self._map.get(slot_of(dir_path, self._slots), "")
        if not holder:
            raise RpcError(
                f"no store server holds the shard for {dir_path!r}", 503)
        return holder

    def _call(self, dir_path: str, path: str, payload=None,
              method: str = "GET"):
        """Route to the slot holder; one refresh+retry on failure (the
        holder may have crashed or the lease moved since our map read)."""
        refreshed = False
        while True:
            holder = self._holder(dir_path, refresh=refreshed)
            try:
                return call(holder, path, payload=payload,
                            method=method, timeout=self.timeout)
            except RpcError as e:
                if e.status == 404:
                    raise NotFoundError(str(e))
                if refreshed:
                    raise
                refreshed = True

    # -- FilerStore interface -------------------------------------------------
    def insert_entry(self, entry: Entry):
        self._call(entry.parent, "/store/insert",
                   payload=entry.to_dict(), method="POST")

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        parent = path.rsplit("/", 1)[0] or "/"
        return Entry.from_dict(self._call(
            parent,
            "/store/find?path=" + urllib.parse.quote(path, safe="/")))

    def delete_entry(self, path: str):
        parent = path.rsplit("/", 1)[0] or "/"
        self._call(parent, "/store/delete", payload={"path": path},
                   method="POST")

    def delete_folder_children(self, path: str):
        # descendants hash anywhere: every holder prunes its local
        # shards (the hop guard keeps holders from re-broadcasting)
        try:
            self._refresh_map()
        except RpcError:
            pass
        with self._lock:
            holders = sorted(set(self._map.values()))
        errs = []
        for holder in holders:
            try:
                call(holder, "/store/delete_children",
                     payload={"path": path}, method="POST",
                     timeout=self.timeout,
                     headers={"X-Shard-Hop": "1"})
            except RpcError as e:
                errs.append(e)
        if errs and len(errs) == len(holders):
            raise errs[0]

    def rename_entry(self, path: str, new_path: str):
        parent = path.rsplit("/", 1)[0] or "/"
        self._call(parent, "/store/rename",
                   payload={"path": path, "new_path": new_path},
                   method="POST")

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        q = urllib.parse.urlencode({
            "dir": dir_path, "start": start_file,
            "include_start": "true" if include_start else "false",
            "limit": str(limit), "prefix": prefix})
        out = self._call(dir_path, "/store/list?" + q)
        return [Entry.from_dict(d) for d in out.get("entries", [])]
