"""Filer core: path -> Entry CRUD with directory management + change log.

Parity with weed/filer/filer.go:34-105: auto-creation of parent
directories on insert, recursive delete with chunk reclamation hooks,
rename, hardlink indirection (filer/filerstore_wrapper.go), and the
metadata change log (filer_notify.go:19-111): every mutation appends an
EventNotification to a LogBuffer that is flushed into date-partitioned
segment files under /topics/.system/log stored in the filer itself;
subscribers replay the persisted log then tail the in-RAM buffer
(filer_grpc_server_sub_meta.go).

The port's own copy of seaweedfs_tpu/filer/filer.py.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Callable, Optional

from ..util.log_buffer import LogBuffer
from .entry import Attr, Entry, FileChunk, new_directory_entry
from .filer_store import FilerStore, MemoryStore, NotFoundError

LOG_BUFFER_CAPACITY = 10000
SYSTEM_LOG_DIR = "/topics/.system/log"  # filer_notify.go SystemLogDir
HARDLINK_DIR = "/etc/.hardlinks"  # hardlink indirection records


class MetaEvent:
    __slots__ = ("ts_ns", "directory", "old_entry", "new_entry")

    def __init__(self, directory: str, old_entry: Optional[dict],
                 new_entry: Optional[dict], ts_ns: Optional[int] = None):
        self.ts_ns = ts_ns if ts_ns is not None else time.time_ns()
        self.directory = directory
        self.old_entry = old_entry
        self.new_entry = new_entry

    def to_dict(self) -> dict:
        return {"ts_ns": self.ts_ns, "directory": self.directory,
                "old_entry": self.old_entry, "new_entry": self.new_entry}


class Filer:
    def __init__(self, store: Optional[FilerStore] = None,
                 meta_log_flush_interval: float = 60.0):
        self.store = store or MemoryStore()
        self.lock = threading.RLock()
        self.on_delete_chunks: Optional[Callable[[list[FileChunk]], None]] \
            = None
        # change-log buffer; flushed into /topics/.system/log segments.
        # Until persistence is enabled it acts as a capped ring buffer.
        self.meta_log_enabled = False
        self._log_buffer = LogBuffer(self._flush_meta_segment,
                                     meta_log_flush_interval,
                                     max_entries=LOG_BUFFER_CAPACITY)
        self._last_event_ns = 0
        # optional external sink for every change event
        # (weed/notification; wired from notification.toml)
        self.notification_queue = None
        # per-thread signature list stamped onto emitted events; a sync
        # client sets its own cluster signature so active-active
        # replication can skip events it produced itself
        # (filer_pb EventNotification.signatures / IsFromOtherCluster)
        self._sig_local = threading.local()

    def set_event_signatures(self, signatures: Optional[list]):
        self._sig_local.value = signatures or None

    # -- change log (filer_notify.go NotifyUpdateEvent) ----------------------
    def _notify(self, directory: str, old_entry: Optional[Entry],
                new_entry: Optional[Entry]):
        if (directory + "/").startswith(SYSTEM_LOG_DIR + "/"):
            return  # never log the log (filer_notify.go:21 guard)
        # strictly-monotonic event timestamps so since_ns cursors never skip
        ts = time.time_ns()
        if ts <= self._last_event_ns:
            ts = self._last_event_ns + 1
        self._last_event_ns = ts
        event = MetaEvent(
            directory,
            old_entry.to_dict() if old_entry else None,
            new_entry.to_dict() if new_entry else None, ts_ns=ts)
        record = event.to_dict()
        sigs = getattr(self._sig_local, "value", None)
        if sigs:
            record["signatures"] = list(sigs)
        self._log_buffer.add(ts, record)
        if self.notification_queue is not None:
            key = ((new_entry or old_entry).full_path
                   if (new_entry or old_entry) else directory)
            try:
                self.notification_queue.send(key, record)
            except Exception as e:  # a broken sink must not fail writes
                from ..util import glog

                glog.errorf("notification send %s: %s", key, e)

    def enable_meta_log(self, background: bool = True):
        """Turn on persistence of the change log into date-partitioned
        segment files under /topics/.system/log (filer_notify.go:62-111)."""
        self.meta_log_enabled = True
        self._log_buffer.max_entries = None  # flushes bound RAM instead
        if background:
            self._log_buffer.start()

    def flush_meta_log(self) -> int:
        return self._log_buffer.flush()

    def _flush_meta_segment(self, start_ns: int, stop_ns: int,
                            events: list[dict]):
        if not self.meta_log_enabled:
            return
        # /topics/.system/log/2026-07-29/11-30-05.123456 (one file per flush)
        t = time.gmtime(start_ns / 1e9)
        day = time.strftime("%Y-%m-%d", t)
        name = time.strftime("%H-%M-%S", t) + f".{start_ns % 10**9:09d}"
        body = "\n".join(json.dumps(e) for e in events).encode()
        entry = Entry(
            full_path=f"{SYSTEM_LOG_DIR}/{day}/{name}",
            attr=Attr(mtime=time.time(), crtime=time.time(),
                      file_size=len(body)),
            content=body,
            extended={"start_ns": start_ns, "stop_ns": stop_ns})
        self.create_entry(entry)

    def read_persisted_meta(self, since_ns: int = 0) -> list[dict]:
        """Replay flushed events from the date-partitioned segment files
        (ReadPersistedLogBuffer, filer_notify.go:88-111).  Whole days older
        than the cursor's date are skipped without listing their segments."""
        out: list[dict] = []
        try:
            days = self.store.list_directory(SYSTEM_LOG_DIR, limit=100000)
        except NotFoundError:
            return out
        since_day = time.strftime("%Y-%m-%d",
                                  time.gmtime(since_ns / 1e9)) \
            if since_ns else ""
        for day in sorted(days, key=lambda e: e.name):
            if day.name < since_day:
                continue
            segments = self.store.list_directory(day.full_path, limit=100000)
            for seg in sorted(segments, key=lambda e: e.name):
                if seg.extended.get("stop_ns", 1 << 63) <= since_ns:
                    continue
                for line in seg.content.decode().splitlines():
                    event = json.loads(line)
                    if event["ts_ns"] > since_ns:
                        out.append(event)
        return out

    def subscribe_metadata(self, since_ns: int = 0,
                           path_prefix: str = "/") -> list[dict]:
        """Replay persisted segments, then the in-RAM tail — the reference's
        replay-then-tail subscription contract
        (filer_grpc_server_sub_meta.go).  Events stay visible in RAM while
        a flush is persisting them, so dedupe on the (unique, strictly
        monotonic) ts_ns."""
        events = self.read_persisted_meta(since_ns) \
            + self._log_buffer.read_since(since_ns)
        prefix = path_prefix.rstrip("/") + "/"
        seen: set[int] = set()
        out = []
        for e in events:
            if e["ts_ns"] in seen or \
                    not (e["directory"] + "/").startswith(prefix):
                continue
            seen.add(e["ts_ns"])
            out.append(e)
        return out

    def close(self):
        """Flush any buffered change-log events and stop the flusher."""
        self._log_buffer.stop()

    # -- hardlinks (filerstore_wrapper.go hardlink indirection) --------------
    def create_hard_link(self, src_path: str, dst_path: str):
        """Make dst share src's content: both entries carry the same
        hard_link_id pointing at a shared record holding attr+chunks with a
        refcount; deletes reclaim chunks only at refcount zero."""
        src_path = self._norm(src_path)
        dst_path = self._norm(dst_path)
        with self.lock:
            src = self.store.find_entry(src_path)
            if src.is_directory:
                raise ValueError("cannot hardlink a directory")
            existing_dst = self._find_or_none(dst_path)
            if existing_dst is not None and existing_dst.is_directory:
                raise ValueError(f"{dst_path} is a directory")
            if not src.hard_link_id:
                src_before = Entry.from_dict(src.to_dict())
                src.hard_link_id = uuid.uuid4().hex
                self._write_hardlink(src.hard_link_id, src, refcount=1)
                # the entry itself becomes a pointer; replicas following the
                # change feed must see the conversion
                src.chunks, src.content = [], b""
                self.store.update_entry(src)
                self._notify(src.parent, src_before, src)
            record = self._read_hardlink(src.hard_link_id)
            record["refcount"] += 1
            self._put_hardlink(src.hard_link_id, record)
            try:
                dst = Entry(full_path=dst_path,
                            attr=Attr(mtime=time.time(), crtime=time.time(),
                                      mode=src.attr.mode),
                            hard_link_id=src.hard_link_id)
                self.create_entry(dst)
            except Exception:
                record["refcount"] -= 1  # roll back the reference bump
                self._put_hardlink(src.hard_link_id, record)
                raise

    def _hardlink_path(self, link_id: str) -> str:
        return f"{HARDLINK_DIR}/{link_id}"

    def _write_hardlink(self, link_id: str, src: Entry, refcount: int):
        self._put_hardlink(link_id, {
            "refcount": refcount,
            "attr": src.to_dict()["attr"],
            "chunks": [c.to_dict() for c in src.chunks],
            "content": src.content.hex() if src.content else "",
            "extended": src.extended,
        })

    def _put_hardlink(self, link_id: str, record: dict):
        body = json.dumps(record).encode()
        self._ensure_parents(HARDLINK_DIR)
        entry = Entry(full_path=self._hardlink_path(link_id),
                      attr=Attr(mtime=time.time(), crtime=time.time(),
                                file_size=len(body)),
                      content=body)
        old = self._find_or_none(entry.full_path)
        self.store.insert_entry(entry)
        # shared records ride the change log so feed replicas can resolve
        # hardlinked entries (they'd otherwise read back empty)
        self._notify(HARDLINK_DIR, old, entry)

    def _read_hardlink(self, link_id: str) -> dict:
        return json.loads(
            self.store.find_entry(self._hardlink_path(link_id)).content)

    def _resolve_hardlink(self, entry: Entry) -> Entry:
        """Materialize a hardlink pointer entry from its shared record.
        Returns a fresh Entry — never mutates the store's object (the
        MemoryStore hands out its stored instances)."""
        if not entry.hard_link_id:
            return entry
        try:
            record = self._read_hardlink(entry.hard_link_id)
        except NotFoundError:
            return entry
        resolved = Entry.from_dict(entry.to_dict())
        a = record["attr"]
        resolved.attr.mime = a.get("mime", resolved.attr.mime)
        resolved.attr.md5 = a.get("md5", "")
        resolved.attr.file_size = a.get("file_size", 0)
        resolved.chunks = [FileChunk.from_dict(c) for c in record["chunks"]]
        resolved.content = bytes.fromhex(record["content"]) \
            if record.get("content") else b""
        resolved.extended = record.get("extended", {}) or resolved.extended
        return resolved

    # -- CRUD ----------------------------------------------------------------
    def create_entry(self, entry: Entry):
        pending: list[FileChunk] = []
        with self.lock:
            self._ensure_parents(entry.parent)
            old = self._find_or_none(entry.full_path)
            if old is not None and old.is_directory and not entry.is_directory:
                raise ValueError(
                    f"{entry.full_path} is a directory")
            self.store.insert_entry(entry)
            self._notify(entry.parent, old, entry)
            if old is None:
                return
            if old.hard_link_id:
                # overwrote a hardlink pointer: drop its reference (even
                # when both point at the same record — the new entry holds
                # its own freshly-counted reference from create_hard_link)
                self._release_file(old, pending)
            elif old.chunks:
                # overwritten file: reclaim chunks no longer referenced
                kept = {c.fid for c in entry.chunks}
                pending += [c for c in old.chunks if c.fid not in kept]
        self._reclaim(pending)

    def _ensure_parents(self, dir_path: str):
        if dir_path in ("", "/"):
            return
        try:
            existing = self.store.find_entry(dir_path)
            if not existing.is_directory:
                raise ValueError(f"{dir_path} is a file")
            return
        except NotFoundError:
            pass
        self._ensure_parents(dir_path.rsplit("/", 1)[0] or "/")
        d = new_directory_entry(dir_path)
        self.store.insert_entry(d)
        self._notify(d.parent, None, d)

    @staticmethod
    def _expired(entry: Entry) -> bool:
        """TTL'd file entries expire ttl_sec after creation
        (entry.go Entry.IsExpired semantics); directories never do."""
        return (entry.attr.ttl_sec > 0 and not entry.is_directory
                and entry.attr.crtime + entry.attr.ttl_sec < time.time())

    def find_entry(self, path: str) -> Entry:
        entry = self._resolve_hardlink(
            self.store.find_entry(self._norm(path)))
        if self._expired(entry):
            # lazily reap the metadata; the TTL volume holding the
            # chunks expires wholesale on the cluster side, so no
            # per-chunk delete RPCs on the read path — and re-verify
            # under the lock so a concurrent re-create of the same path
            # is never deleted.  Any release RPCs (hardlink refcount
            # drop) run AFTER the lock: a slow volume server must not
            # stall every metadata operation behind a read
            pending: list[FileChunk] = []
            with self.lock:
                current = self._find_or_none(entry.full_path)
                if current is not None and self._expired(current):
                    try:
                        # hardlinked entries must still release their
                        # refcount; plain files skip per-chunk delete
                        # RPCs (the TTL volume expires them wholesale)
                        pending = self._delete_entry_locked(
                            entry.full_path,
                            delete_chunks=bool(current.hard_link_id))
                    except (NotFoundError, ValueError):
                        pass
            self._reclaim(pending)
            raise NotFoundError(path)
        return entry

    def _find_or_none(self, path: str) -> Optional[Entry]:
        try:
            return self.store.find_entry(path)
        except NotFoundError:
            return None

    def update_entry(self, entry: Entry):
        with self.lock:
            old = self._find_or_none(entry.full_path)
            if old is not None and old.hard_link_id:
                # write-through to the shared record so every link sees it
                entry.hard_link_id = old.hard_link_id
                record = self._read_hardlink(old.hard_link_id)
                self._write_hardlink(old.hard_link_id, entry,
                                     refcount=record["refcount"])
                entry = Entry(full_path=entry.full_path, attr=entry.attr,
                              extended=entry.extended,
                              hard_link_id=old.hard_link_id)
            self.store.update_entry(entry)
            self._notify(entry.parent, old, entry)

    def delete_entry(self, path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False,
                     delete_chunks: bool = True):
        """filer_delete_entry.go semantics: directories need recursive=True
        unless empty; file deletion reclaims chunks unless the caller opts
        out (the HTTP skipChunkDelete param, used by metadata-only
        restores).  Chunk-delete RPCs are issued after the filer lock is
        released — a slow volume server must not stall metadata ops."""
        with self.lock:
            pending = self._delete_entry_locked(path, recursive,
                                                delete_chunks)
        self._reclaim(pending)

    def _delete_entry_locked(self, path: str, recursive: bool = False,
                             delete_chunks: bool = True
                             ) -> list[FileChunk]:
        """Metadata-side delete under self.lock; returns the chunks to
        reclaim once the caller has dropped the lock."""
        path = self._norm(path)
        pending: list[FileChunk] = []
        entry = self.store.find_entry(path)
        if entry.is_directory:
            children = self.store.list_directory(path, limit=1)
            if children and not recursive:
                raise ValueError(f"{path} is not empty")
            self._delete_recursive(path, delete_chunks, pending)
            self.store.delete_entry(path)
        else:
            self.store.delete_entry(path)
            if delete_chunks:
                self._release_file(entry, pending)
        self._notify(entry.parent, entry, None)
        return pending

    def _reclaim(self, chunks: list[FileChunk]):
        """Fire the chunk-delete callback (volume-server RPCs) — call
        with the filer lock RELEASED."""
        if chunks and self.on_delete_chunks:
            self.on_delete_chunks(chunks)

    def _release_file(self, entry: Entry, pending: list[FileChunk]):
        """Collect a deleted file's reclaimable chunks into `pending`,
        honoring hardlink refcounts.  Store mutations happen here (under
        the caller's lock); the delete RPCs happen later via _reclaim."""
        if entry.hard_link_id:
            try:
                record = self._read_hardlink(entry.hard_link_id)
            except NotFoundError:
                return
            record["refcount"] -= 1
            if record["refcount"] > 0:
                self._put_hardlink(entry.hard_link_id, record)
                return
            record_path = self._hardlink_path(entry.hard_link_id)
            record_entry = self._find_or_none(record_path)
            self.store.delete_entry(record_path)
            if record_entry is not None:
                self._notify(HARDLINK_DIR, record_entry, None)
            pending += [FileChunk.from_dict(c) for c in record["chunks"]]
        else:
            pending += entry.chunks

    def _delete_recursive(self, dir_path: str, delete_chunks: bool,
                          pending: list[FileChunk]):
        while True:
            children = self.store.list_directory(dir_path, limit=1024)
            if not children:
                break
            for child in children:
                if child.is_directory:
                    self._delete_recursive(child.full_path, delete_chunks,
                                           pending)
                    self.store.delete_entry(child.full_path)
                else:
                    self.store.delete_entry(child.full_path)
                    if delete_chunks:
                        self._release_file(child, pending)

    def list_directory(self, path: str, start_file: str = "",
                       limit: int = 1024, prefix: str = "",
                       include_start: bool = False,
                       name_pattern: str = "",
                       name_pattern_exclude: str = "") -> list[Entry]:
        """List children, filtering expired entries BEFORE the limit
        counts them (a page of expired entries must not truncate
        pagination) and applying optional glob patterns the way the
        reference's filer_search.go does: a literal pattern head becomes
        a store-side prefix, the rest matches fnmatch-style, and
        name_pattern_exclude drops matching names."""
        import fnmatch

        path = self._norm(path)
        if name_pattern and not prefix:
            # split the pattern at the first wildcard: the literal head
            # narrows the store scan (splitPattern, filer_search.go:11-21)
            cut = len(name_pattern)
            for wc in "*?[":
                pos = name_pattern.find(wc)
                if pos >= 0:
                    cut = min(cut, pos)
            prefix = name_pattern[:cut]
        out: list[Entry] = []
        cursor, inc = start_file, include_start
        while len(out) < limit:
            want = limit - len(out)
            batch = self.store.list_directory(
                path, start_file=cursor, limit=want, prefix=prefix,
                include_start=inc)
            if not batch:
                break
            for e in batch:
                if self._expired(e):
                    continue
                if name_pattern and not fnmatch.fnmatchcase(
                        e.name, name_pattern):
                    continue
                if name_pattern_exclude and fnmatch.fnmatchcase(
                        e.name, name_pattern_exclude):
                    continue
                out.append(self._resolve_hardlink(e)
                           if e.hard_link_id else e)
            cursor, inc = batch[-1].name, False
            if len(batch) < want:
                break
        return out

    # -- generic KV (filer_grpc_server_kv.go KvGet/KvPut) ---------------------
    # Clients use this for small cluster-wide state.  Stored as raw
    # store entries under a reserved prefix (every store kind inherits
    # it); store-level access skips event notification like the
    # reference's Store.KvPut does.
    KV_DIR = "/etc/seaweedfs/kv"

    def _kv_path(self, key: bytes) -> str:
        return f"{self.KV_DIR}/{key.hex()}"

    def kv_put(self, key: bytes, value: bytes):
        """Set key -> value; empty value deletes (KvPut semantics)."""
        if not value:
            self.kv_delete(key)
            return
        entry = Entry(full_path=self._kv_path(key),
                      attr=Attr(crtime=time.time(), mtime=time.time()))
        entry.content = value
        with self.lock:
            self.store.insert_entry(entry)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        """Value for key, or None when absent (ErrKvNotFound -> empty)."""
        try:
            return bytes(self.store.find_entry(
                self._kv_path(key)).content)
        except NotFoundError:
            return None

    def kv_delete(self, key: bytes):
        with self.lock:
            try:
                self.store.delete_entry(self._kv_path(key))
            except NotFoundError:
                pass

    def rename(self, old_path: str, new_path: str):
        """Atomic single-entry rename + recursive subtree move
        (filer_rename.go).  The change event carries both the old and new
        entry so feed replicas delete the old path (meta_replay.go)."""
        pending: list[FileChunk] = []
        with self.lock:
            self._rename_locked(self._norm(old_path), self._norm(new_path),
                                pending)
        self._reclaim(pending)

    def _rename_locked(self, old_path: str, new_path: str,
                       pending: list[FileChunk]):
        entry = self.store.find_entry(old_path)
        dst = self._find_or_none(new_path)
        if dst is not None:
            if dst.is_directory and not entry.is_directory:
                raise ValueError(f"{new_path} is a directory")
            # overwrite drops one reference; RPCs deferred past the lock
            self._release_file(dst, pending)
        self._ensure_parents(new_path.rsplit("/", 1)[0] or "/")
        if entry.is_directory:
            for child in self.store.list_directory(old_path,
                                                   limit=100000):
                self._rename_locked(child.full_path,
                                    new_path + "/" + child.name, pending)
        old_snapshot = Entry.from_dict(entry.to_dict())
        entry.full_path = new_path
        self.store.insert_entry(entry)
        self.store.delete_entry(old_path)
        self._notify(entry.parent, old_snapshot, entry)

    @staticmethod
    def _norm(path: str) -> str:
        if not path.startswith("/"):
            path = "/" + path
        if len(path) > 1:
            path = path.rstrip("/")
        return path
