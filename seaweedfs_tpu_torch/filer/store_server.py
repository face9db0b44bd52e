"""Shared out-of-process filer store: a store SERVICE + a client store.

The reference's redis family (weed/filer/redis/universal_redis_store.go:
20-130, redis2/, redis_lua/) lets many STATELESS filers share one
metadata store — an HA mode the embedded stores (filer_store.py) cannot
provide.  No redis server exists in this image, so the same capability is
built on the repo's own RPC substrate: `weed filer.store` hosts any
embedded store kind behind HTTP/JSON routes, and RemoteStore is a
FilerStore client speaking to it over pooled keep-alive connections.
Filers configured with `-store remote -storeAddress host:port` keep no
local metadata at all — kill one, start another, same namespace.

Cluster mode (`-master` given): multiple store servers split the
directory-hash shard space.  The authoritative slot→holder map lives in
the MASTER's replicated FSM (filer/shard_map.py): each server leases its
fair share through `/filer/shard_lease` (a raft-committed command), so
a failed-over master serves the identical assignment.  Requests for a
slot held elsewhere are proxied to the holder (one hop, loop-guarded by
X-Shard-Hop); newly-acquired slots pull a handover dump from the
previous holder when it is still alive.

The port's own copy of seaweedfs_tpu/filer/store_server.py.
"""

from __future__ import annotations

import os
import threading
import urllib.parse
from typing import Optional

from ..rpc.http_rpc import Request, RpcError, RpcServer, call
from ..util import glog
from .entry import Entry
from .filer_store import (FilerStore, MemoryStore, NotFoundError,
                          PerBucketStoreRouter, ShardedSqliteStore,
                          SqliteStore)
from .shard_map import default_slots, slot_of

HOP_HEADER = "X-Shard-Hop"  # one proxy hop max, never a forwarding loop


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def make_store(kind: str, directory: Optional[str] = None) -> FilerStore:
    """Construct an embedded store by kind name (shared by the filer CLI
    and the store service)."""
    import os

    if kind in ("memory", ""):
        return MemoryStore()
    if directory is None:
        raise ValueError(f"store kind {kind!r} needs a directory")
    os.makedirs(directory, exist_ok=True)
    if kind == "sqlite":
        return SqliteStore(os.path.join(directory, "filer.db"))
    if kind == "sharded":
        return ShardedSqliteStore(os.path.join(directory, "meta"))
    if kind == "perbucket":
        return PerBucketStoreRouter(os.path.join(directory, "meta"))
    raise ValueError(f"unknown store kind {kind!r}")


class FilerStoreServer:
    """`weed filer.store`: host one embedded store for many filers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: Optional[FilerStore] = None,
                 masters: Optional[list[str]] = None):
        self.store = store or MemoryStore()
        self.masters = [m for m in (masters or []) if m]
        # one writer lock: the embedded stores are already thread-safe,
        # but insert/update of the SAME path from two filers must not
        # interleave partially (universal_redis_store serialises per key
        # through redis itself)
        self._lock = threading.RLock()
        # cluster-mode shard state (all under _lock)
        self._slots = getattr(self.store, "shard_count", 0) \
            or default_slots()
        self._held: set[int] = set()
        self._map: dict[int, str] = {}
        self._epoch = 0
        self._lease_ttl = _env_float("WEED_FILER_SHARD_LEASE", 10.0)
        self._lease_stop = threading.Event()
        self._lease_thread: Optional[threading.Thread] = None
        self._pulled: set[int] = set()  # slots already handover-filled
        # online split/merge (two-phase): while a resize is in prepare,
        # a STAGING store holds the target layout; every write lands in
        # both (dual-write) and held slots are copied over, so at commit
        # the staging store simply becomes the store
        self._resize: Optional[dict] = None
        self._staging: Optional[FilerStore] = None
        self._staging_to = 0
        self._staged: set[int] = set()   # slots copied into staging
        self._retired_stores: list = []  # pre-flip stores, kept open
                                         # for readers already inside
        self.server = RpcServer(host, port)
        self.server.add("POST", "/store/insert", self._h_insert)
        self.server.add("POST", "/store/update", self._h_insert)
        self.server.add("GET", "/store/find", self._h_find)
        self.server.add("POST", "/store/delete", self._h_delete)
        self.server.add("POST", "/store/delete_children",
                        self._h_delete_children)
        self.server.add("GET", "/store/list", self._h_list)
        self.server.add("POST", "/store/rename", self._h_rename)
        self.server.add("GET", "/store/dump", self._h_dump)
        self.server.add("GET", "/store/status", self._h_status)

    @property
    def address(self) -> str:
        return self.server.address

    def start(self):
        self.server.start()
        if self.masters:
            try:
                self._lease_once()  # serve with slots from the start
            except RpcError as e:
                glog.warningf("filer.store: initial shard lease "
                              "failed: %s", e)
            self._lease_thread = threading.Thread(
                target=self._lease_loop, daemon=True)
            self._lease_thread.start()

    def stop(self):
        self._lease_stop.set()
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=5)
            self._lease_thread = None
        if self.masters:
            try:  # graceful: free slots now so peers take over instantly
                self._master_call("/filer/shard_lease",
                                  {"holder": self.address,
                                   "release": True})
            except RpcError:
                pass  # the lease TTL frees them anyway
        self.server.stop()
        self.store.close()
        if self._staging is not None:
            self._staging.close()
        for s in self._retired_stores:
            s.close()

    # -- shard-lease protocol -------------------------------------------------
    def _master_call(self, path: str, payload: dict) -> dict:
        last: Optional[RpcError] = None
        for addr in self.masters:
            try:
                return call(addr, path, payload=payload, method="POST",
                            timeout=5)
            except RpcError as e:
                # a follower names the leader: honor the hint directly
                hint = (e.headers or {}).get("X-Raft-Leader", "")
                if hint and hint != addr:
                    try:
                        return call(hint, path, payload=payload,
                                    method="POST", timeout=5)
                    except RpcError as e2:
                        last = e2
                        continue
                last = e
        raise last or RpcError("no master reachable", 503)

    def _lease_once(self):
        r = self._master_call("/filer/shard_lease",
                              {"holder": self.address,
                               "ttl": self._lease_ttl})
        total = int(r.get("slots_total") or self._slots)
        if total != self._slots:
            # the slot map flipped to a new count: adopt the staged
            # layout BEFORE interpreting slot numbers from this reply
            self._adopt_layout(total)
        granted = set(int(s) for s in r.get("slots", []))
        prev = {int(k): v
                for k, v in (r.get("prev") or {}).items() if v}
        with self._lock:
            fresh = granted - self._held
        # pull handovers BEFORE exposing the slots as held: a freshly
        # granted slot must not answer "not found" for entries its
        # previous holder still has (requests 503 until then — the
        # clients' retry window, not a wrong answer)
        not_ready: set[int] = set()
        for slot in sorted(fresh):
            if not self._pull_handover(slot, prev.get(slot) or []):
                not_ready.add(slot)
        with self._lock:
            self._held = granted - not_ready
            self._map = {int(k): v
                         for k, v in (r.get("map") or {}).items()}
            self._epoch = int(r.get("epoch", 0))
            self._resize = r.get("resize")
        rz = r.get("resize")
        if rz and rz.get("phase") == "prepare":
            self._prepare_resize(int(rz["to"]))

    def _pull_handover(self, slot: int, sources) -> bool:
        """Best-effort: copy a newly-granted slot's entries from its
        previous holder(s) — a merge can fold several (graceful
        rebalance keeps data; after a crash the slot starts empty but
        WRITABLE — availability over history).  Returns False when a
        live source is still on a different slot layout (409): the slot
        is withheld this cycle and retried, never served half-filled."""
        if isinstance(sources, str):  # pre-resize masters send one addr
            sources = [sources] if sources else []
        sources = [s for s in sources if s and s != self.address]
        if not sources or slot in self._pulled:
            return True
        if not hasattr(self.store, "load_slot"):
            return True
        ok = True
        for src in sources:
            try:
                r = call(src,
                         f"/store/dump?slot={slot}&slots={self._slots}",
                         timeout=30)
                self.store.load_slot(slot, r.get("entries", []))
                glog.infof("filer.store: slot %d handover from %s "
                           "(%d entries)", slot, src,
                           len(r.get("entries", [])))
            except RpcError as e:
                if e.status == 409:
                    # source still dumping the OLD layout: copying now
                    # would interleave two hash spaces — wait it out
                    ok = False
                    continue
                pass  # holder gone: take over without its entries
        if ok:
            self._pulled.add(slot)
        return ok

    # -- online split / merge participation ------------------------------------
    def _staging_dir(self, to: int) -> str:
        return getattr(self.store, "directory", "") + f".r{to}"

    def _prepare_resize(self, to: int):
        """Prepare phase: stand up the target-layout staging store,
        dual-write into it (enabled the moment _staging is set), copy
        every held slot's entries across, then ack to the master.
        Idempotent — runs once per lease cycle until the commit."""
        if not hasattr(self.store, "dump_slot"):
            # nothing local to re-shard (memory store): ready at once
            self._ack_resize()
            return
        with self._lock:
            if self._staging is None or self._staging_to != to:
                self._staging = ShardedSqliteStore(
                    self._staging_dir(to), shard_count=to)
                self._staging_to = to
                self._staged = set()
        while True:
            with self._lock:
                todo = sorted(self._held - self._staged)
                if not todo:
                    break
                slot = todo[0]
                # the whole slot copy holds the write lock, so no entry
                # can slip between the dump and the dual-write window
                for d in self.store.dump_slot(slot):
                    self._staging.insert_entry(Entry.from_dict(d))
                self._staged.add(slot)
        self._ack_resize()

    def _ack_resize(self):
        try:
            self._master_call("/filer/shard_resize",
                              {"op": "ack", "holder": self.address})
        except RpcError as e:
            glog.v(1).infof("filer.store: resize ack failed: %s", e)

    def _adopt_layout(self, total: int):
        """Commit phase: the map flipped — the staging store becomes THE
        store.  A holder that crashed during prepare (no staging)
        rebuilds the target layout from its local shards first; local
        re-sharding is lossless because the new count divides (or is a
        multiple of) the old one."""
        with self._lock:
            if total == self._slots:
                return
            if hasattr(self.store, "dump_slot"):
                if self._staging is None or self._staging_to != total:
                    glog.warningf(
                        "filer.store: layout flip to %d slots without "
                        "staged data; re-sharding locally", total)
                    staging = ShardedSqliteStore(
                        self._staging_dir(total), shard_count=total)
                    for slot in range(
                            getattr(self.store, "shard_count", 0)):
                        for d in self.store.dump_slot(slot):
                            staging.insert_entry(Entry.from_dict(d))
                    self._staging = staging
                self._retired_stores.append(self.store)
                self.store = self._staging
            self._staging = None
            self._staging_to = 0
            self._staged = set()
            self._slots = total
            self._held = set()
            self._pulled = set()
            self._resize = None
        glog.infof("filer.store: %s adopted %d-slot layout",
                   self.address, total)

    def _lease_loop(self):
        period = max(0.5, self._lease_ttl / 3.0)
        while not self._lease_stop.wait(period):
            try:
                self._lease_once()
            except RpcError as e:
                glog.v(1).infof("filer.store: shard lease renewal "
                                "failed: %s", e)

    # -- shard routing ---------------------------------------------------------
    def _owner(self, dir_path: str) -> Optional[str]:
        """None = serve locally; otherwise the holder to proxy to.
        Raises 503 for an unheld, unassigned slot (a holder's lease must
        land before writes for it can be accepted anywhere)."""
        if not self.masters:
            return None  # standalone mode: this server owns everything
        slot = slot_of(dir_path, self._slots)
        with self._lock:
            if slot in self._held:
                return None
            owner = self._map.get(slot, "")
        if owner and owner != self.address:
            return owner
        raise RpcError(f"shard slot {slot} has no lease holder", 503)

    def _proxy(self, req: Request, owner: str, path: str,
               payload: Optional[dict] = None, method: str = "POST"):
        if req.headers.get(HOP_HEADER):
            # already one hop deep: the map is in flux between us and the
            # first server; fail fast instead of bouncing around
            raise RpcError(
                f"shard map disagreement proxying {path}", 503)
        return call(owner, path, payload=payload, method=method,
                    timeout=20, headers={HOP_HEADER: "1"})

    # -- handlers --------------------------------------------------------------
    def _h_insert(self, req: Request):
        d = req.json()
        entry = Entry.from_dict(d)
        owner = self._owner(entry.parent)
        if owner:
            return self._proxy(req, owner, "/store/insert", payload=d)
        with self._lock:
            self.store.insert_entry(entry)
            if self._staging is not None:
                self._staging.insert_entry(entry)
        return {}

    def _h_find(self, req: Request):
        path = req.param("path", "") or "/"
        parent = path.rsplit("/", 1)[0] or "/"
        owner = self._owner(parent)
        if owner:
            return self._proxy(
                req, owner,
                "/store/find?path=" + urllib.parse.quote(path, safe="/"),
                method="GET")
        try:
            return self.store.find_entry(path).to_dict()
        except NotFoundError:
            raise RpcError(f"{path} not found", 404)

    def _h_delete(self, req: Request):
        d = req.json()
        path = d.get("path", "")
        parent = path.rsplit("/", 1)[0] or "/"
        owner = self._owner(parent)
        if owner:
            return self._proxy(req, owner, "/store/delete", payload=d)
        with self._lock:
            self.store.delete_entry(path)
            if self._staging is not None:
                self._staging.delete_entry(path)
        return {}

    def _h_delete_children(self, req: Request):
        d = req.json()
        with self._lock:
            self.store.delete_folder_children(d.get("path", ""))
            if self._staging is not None:
                self._staging.delete_folder_children(d.get("path", ""))
            holders = (set(self._map.values()) - {self.address}
                       if not req.headers.get(HOP_HEADER) else set())
        # descendant dirs hash to arbitrary slots: fan out to every
        # holder (each fans over its LOCAL shards only — hop guard stops
        # re-broadcast)
        for holder in sorted(holders):
            try:
                call(holder, "/store/delete_children", payload=d,
                     method="POST", timeout=30,
                     headers={HOP_HEADER: "1"})
            except RpcError as e:
                glog.warningf("filer.store: delete_children fan-out to "
                              "%s failed: %s", holder, e)
        return {}

    def _h_list(self, req: Request):
        dir_path = req.param("dir", "") or "/"
        owner = self._owner(dir_path)
        if owner:
            q = urllib.parse.urlencode({
                "dir": dir_path,
                "start": req.param("start", "") or "",
                "include_start": req.param("include_start") or "false",
                "limit": req.param("limit", "1024"),
                "prefix": req.param("prefix", "") or ""})
            return self._proxy(req, owner, "/store/list?" + q,
                               method="GET")
        entries = self.store.list_directory(
            dir_path,
            start_file=req.param("start", "") or "",
            include_start=req.param("include_start") == "true",
            limit=int(req.param("limit", "1024")),
            prefix=req.param("prefix", "") or "")
        return {"entries": [e.to_dict() for e in entries]}

    def _h_rename(self, req: Request):
        """Cross-shard rename: src and dst may live on different
        holders; read src (routed), write dst (routed), delete src
        (routed).  Not atomic across holders — same contract as the
        reference's cross-store moves, where the filer retries."""
        d = req.json()
        src, dst = d.get("path", ""), d.get("new_path", "")
        if not src or not dst:
            raise RpcError("path and new_path required", 400)
        found = self._h_find_path(req, src)
        found["full_path"] = dst
        self._h_insert_routed(req, found)
        self._h_delete_routed(req, src)
        return {"renamed": src, "to": dst}

    def _h_find_path(self, req: Request, path: str) -> dict:
        parent = path.rsplit("/", 1)[0] or "/"
        owner = self._owner(parent)
        if owner:
            return self._proxy(
                req, owner,
                "/store/find?path=" + urllib.parse.quote(path, safe="/"),
                method="GET")
        try:
            return self.store.find_entry(path).to_dict()
        except NotFoundError:
            raise RpcError(f"{path} not found", 404)

    def _h_insert_routed(self, req: Request, d: dict):
        entry = Entry.from_dict(d)
        owner = self._owner(entry.parent)
        if owner:
            self._proxy(req, owner, "/store/insert", payload=d)
            return
        with self._lock:
            self.store.insert_entry(entry)
            if self._staging is not None:
                self._staging.insert_entry(entry)

    def _h_delete_routed(self, req: Request, path: str):
        parent = path.rsplit("/", 1)[0] or "/"
        owner = self._owner(parent)
        if owner:
            self._proxy(req, owner, "/store/delete",
                        payload={"path": path})
            return
        with self._lock:
            self.store.delete_entry(path)
            if self._staging is not None:
                self._staging.delete_entry(path)

    def _h_dump(self, req: Request):
        """Slot handover source: every entry in one local shard slot.
        The caller declares its slot layout (`slots=`); a mismatch is a
        409 — serving slot s of an N-slot space from an M-slot store
        would silently hand over the wrong hash range."""
        slot = int(req.param("slot", "-1"))
        if slot < 0:
            raise RpcError("slot required", 400)
        expected = req.param("slots", "") or ""
        if expected and int(expected) != self._slots:
            raise RpcError(
                f"shard layout mismatch: have {self._slots} slots, "
                f"caller expects {expected}", 409)
        if not hasattr(self.store, "dump_slot"):
            raise RpcError(
                f"{type(self.store).__name__} is not slot-addressable",
                400)
        return {"slot": slot, "slots": self._slots,
                "entries": self.store.dump_slot(slot)}

    def _h_status(self, req: Request):
        with self._lock:
            return {"store": type(self.store).__name__,
                    "cluster": bool(self.masters),
                    "slots": self._slots,
                    "held": sorted(self._held),
                    "epoch": self._epoch,
                    "resize": dict(self._resize) if self._resize
                    else None,
                    "staged": sorted(self._staged),
                    "map": {str(k): v
                            for k, v in sorted(self._map.items())}}


class RemoteStore(FilerStore):
    """FilerStore client against a FilerStoreServer — the stateless-filer
    mode.  Every operation is one pooled keep-alive round trip (the
    substrate retries per rpc/http_rpc's phase-split policy)."""

    def __init__(self, address: str, timeout: float = 20.0):
        self.address = address
        self.timeout = timeout

    def _call(self, path: str, payload=None, method: str = "GET"):
        try:
            return call(self.address, path, payload=payload,
                        method=method, timeout=self.timeout)
        except RpcError as e:
            if e.status == 404:
                raise NotFoundError(str(e))
            raise

    def insert_entry(self, entry: Entry):
        self._call("/store/insert", payload=entry.to_dict(),
                   method="POST")

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        import urllib.parse

        return Entry.from_dict(self._call(
            "/store/find?path=" + urllib.parse.quote(path, safe="/")))

    def delete_entry(self, path: str):
        self._call("/store/delete", payload={"path": path}, method="POST")

    def delete_folder_children(self, path: str):
        self._call("/store/delete_children", payload={"path": path},
                   method="POST")

    def rename_entry(self, path: str, new_path: str):
        """Server-side (possibly cross-shard) rename."""
        self._call("/store/rename",
                   payload={"path": path, "new_path": new_path},
                   method="POST")

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        import urllib.parse

        q = urllib.parse.urlencode({
            "dir": dir_path, "start": start_file,
            "include_start": "true" if include_start else "false",
            "limit": str(limit), "prefix": prefix})
        out = self._call("/store/list?" + q)
        return [Entry.from_dict(d) for d in out.get("entries", [])]
