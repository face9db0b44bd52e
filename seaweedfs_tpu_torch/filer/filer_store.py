"""Pluggable filer metadata stores.

Parity with weed/filer/filerstore.go:21-44: insert/update/find/delete/
delete-children/list-directory over Entries.  The reference ships leveldb
(3 variants) and redis backends; here the in-process equivalents are a
dict-backed MemoryStore and a persistent SqliteStore (stdlib sqlite3 —
this image has no leveldb binding), both behind the same interface and
exercised by the shared conformance tests (tests/test_filer.py), matching
the reference's per-store test harness (filer/store_test/).

The port's own copy of seaweedfs_tpu/filer/filer_store.py.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Iterator, Optional

from .entry import Entry


class FilerStoreError(Exception):
    pass


class NotFoundError(FilerStoreError):
    pass


class FilerStore:
    """Interface — all paths are absolute, "/"-separated, no trailing "/"."""

    def insert_entry(self, entry: Entry):
        raise NotImplementedError

    def update_entry(self, entry: Entry):
        raise NotImplementedError

    def find_entry(self, path: str) -> Entry:
        raise NotImplementedError

    def delete_entry(self, path: str):
        raise NotImplementedError

    def delete_folder_children(self, path: str):
        raise NotImplementedError

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        raise NotImplementedError

    def close(self):
        pass

    def forget_connections(self):
        """Drop (without closing) any backend handle opened before a
        prefork fork().  Sqlite connections must not be used from two
        processes; serving threads in the child are brand-new threads
        that lazily open their own, so dropping the reference suffices.
        Closing the inherited handle from the child would run sqlite
        shutdown against the parent's live database, so leak it."""


class MemoryStore(FilerStore):
    def __init__(self):
        # dir path -> {name -> Entry}
        self._dirs: dict[str, dict[str, Entry]] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry):
        with self._lock:
            self._dirs.setdefault(entry.parent, {})[entry.name] = entry

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        if path == "/":
            from .entry import new_directory_entry

            return new_directory_entry("/")
        parent, name = path.rsplit("/", 1)
        with self._lock:
            entry = self._dirs.get(parent or "/", {}).get(name)
            if entry is None:
                raise NotFoundError(path)
            return entry

    def delete_entry(self, path: str):
        parent, name = path.rsplit("/", 1)
        with self._lock:
            self._dirs.get(parent or "/", {}).pop(name, None)

    def delete_folder_children(self, path: str):
        with self._lock:
            for d in [d for d in self._dirs
                      if d == path or d.startswith(path.rstrip("/") + "/")]:
                del self._dirs[d]

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        with self._lock:
            names = sorted(self._dirs.get(dir_path, {}))
            out = []
            for name in names:
                if prefix and not name.startswith(prefix):
                    continue
                if start_file:
                    if name < start_file:
                        continue
                    if name == start_file and not include_start:
                        continue
                out.append(self._dirs[dir_path][name])
                if len(out) >= limit:
                    break
            return out


class SqliteStore(FilerStore):
    """Persistent store: one table keyed by (dir, name)."""

    def __init__(self, path: str):
        self._path = path
        self._local = threading.local()
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS filemeta ("
                " dir TEXT NOT NULL, name TEXT NOT NULL,"
                " meta TEXT NOT NULL, PRIMARY KEY (dir, name))")
            c.execute("CREATE INDEX IF NOT EXISTS idx_dir"
                      " ON filemeta (dir, name)")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path)
            conn.isolation_level = None  # autocommit
            self._local.conn = conn
        return conn

    def forget_connections(self):
        self._local = threading.local()

    def insert_entry(self, entry: Entry):
        self._conn().execute(
            "INSERT OR REPLACE INTO filemeta (dir, name, meta)"
            " VALUES (?, ?, ?)",
            (entry.parent, entry.name, json.dumps(entry.to_dict())))

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        if path == "/":
            from .entry import new_directory_entry

            return new_directory_entry("/")
        parent, name = path.rsplit("/", 1)
        row = self._conn().execute(
            "SELECT meta FROM filemeta WHERE dir = ? AND name = ?",
            (parent or "/", name)).fetchone()
        if row is None:
            raise NotFoundError(path)
        return Entry.from_dict(json.loads(row[0]))

    def delete_entry(self, path: str):
        parent, name = path.rsplit("/", 1)
        self._conn().execute(
            "DELETE FROM filemeta WHERE dir = ? AND name = ?",
            (parent or "/", name))

    @staticmethod
    def _escape_like(s: str) -> str:
        return (s.replace("\\", "\\\\").replace("%", "\\%")
                .replace("_", "\\_"))

    def delete_folder_children(self, path: str):
        base = path.rstrip("/")
        self._conn().execute(
            "DELETE FROM filemeta WHERE dir = ? OR dir LIKE ? ESCAPE '\\'",
            (base or "/", self._escape_like(base + "/") + "%"))

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        op = ">=" if include_start else ">"
        sql = (f"SELECT meta FROM filemeta WHERE dir = ? AND name {op} ?")
        args: list = [dir_path, start_file]
        if prefix:
            sql += " AND name LIKE ? ESCAPE '\\'"
            args.append(self._escape_like(prefix) + "%")
        sql += " ORDER BY name LIMIT ?"
        args.append(limit)
        rows = self._conn().execute(sql, args).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


class ShardedSqliteStore(FilerStore):
    """Directory-hashed shards, one sqlite file each.

    The analogue of the reference's leveldb2 store (filer/leveldb2: 256
    hashed sub-DBs) — spreading directories over independent databases
    keeps per-file lock contention and compaction local to a shard."""

    def __init__(self, directory: str, shard_count: Optional[int] = None):
        import os

        from .shard_map import default_slots

        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.shard_count = shard_count or default_slots()
        self._shards = [
            SqliteStore(os.path.join(directory, f"meta_{i:02x}.db"))
            for i in range(self.shard_count)]

    def _shard(self, dir_path: str) -> SqliteStore:
        from .shard_map import slot_of

        return self._shards[slot_of(dir_path, self.shard_count)]

    # -- slot-level access (cluster mode: handover + dump) --------------------
    def slot_store(self, slot: int) -> SqliteStore:
        return self._shards[slot % self.shard_count]

    def dump_slot(self, slot: int, limit: int = 100_000) -> list[dict]:
        """Every entry in one shard slot, for lease handover to the next
        holder.  Slot i is exactly the local meta_{i:02x}.db file, since
        the cluster shard map hashes with the same function."""
        rows = self.slot_store(slot)._conn().execute(
            "SELECT meta FROM filemeta ORDER BY dir, name LIMIT ?",
            (limit,)).fetchall()
        return [json.loads(r[0]) for r in rows]

    def load_slot(self, slot: int, entries: list[dict]):
        store = self.slot_store(slot)
        for d in entries:
            store.insert_entry(Entry.from_dict(d))

    def insert_entry(self, entry: Entry):
        self._shard(entry.parent).insert_entry(entry)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        if path == "/":
            from .entry import new_directory_entry

            return new_directory_entry("/")
        parent = path.rsplit("/", 1)[0] or "/"
        return self._shard(parent).find_entry(path)

    def delete_entry(self, path: str):
        parent = path.rsplit("/", 1)[0] or "/"
        self._shard(parent).delete_entry(path)

    def delete_folder_children(self, path: str):
        # children may hash to any shard (each child dir hashes by its
        # own parent path): fan the prefix delete out to all shards
        for shard in self._shards:
            shard.delete_folder_children(path)

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        return self._shard(dir_path).list_directory(
            dir_path, start_file=start_file,
            include_start=include_start, limit=limit, prefix=prefix)

    def close(self):
        for shard in self._shards:
            shard.close()

    def forget_connections(self):
        for shard in self._shards:
            shard.forget_connections()


class PerBucketStoreRouter(FilerStore):
    """Route /buckets/<name>/ subtrees to dedicated stores.

    The analogue of the reference's leveldb3 (per-bucket DBs,
    filer/leveldb3): dropping a bucket is dropping its store, and one
    bucket's scan load cannot slow another's."""

    def __init__(self, directory: str, buckets_root: str = "/buckets"):
        import os

        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.buckets_root = buckets_root.rstrip("/")
        self.default = SqliteStore(os.path.join(directory, "default.db"))
        self._buckets: dict[str, SqliteStore] = {}
        self._lock = threading.Lock()
        for name in sorted(os.listdir(directory)):
            if name.startswith("bucket_") and name.endswith(".db"):
                bucket = name[len("bucket_"):-3]
                self._buckets[bucket] = SqliteStore(
                    os.path.join(directory, name))

    def _bucket_of(self, path: str) -> Optional[str]:
        if not path.startswith(self.buckets_root + "/"):
            return None
        rest = path[len(self.buckets_root) + 1:]
        return rest.split("/", 1)[0] if rest else None

    def _store_for(self, path: str) -> SqliteStore:
        import os

        bucket = self._bucket_of(path)
        if not bucket:
            return self.default
        with self._lock:
            store = self._buckets.get(bucket)
            if store is None:
                store = SqliteStore(os.path.join(
                    self.directory, f"bucket_{bucket}.db"))
                self._buckets[bucket] = store
            return store

    def insert_entry(self, entry: Entry):
        self._store_for(entry.full_path).insert_entry(entry)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        return self._store_for(path).find_entry(path)

    def delete_entry(self, path: str):
        self._store_for(path).delete_entry(path)
        # deleting a bucket root drops its whole store file
        bucket = self._bucket_of(path)
        if bucket and path == f"{self.buckets_root}/{bucket}":
            self._drop_bucket(bucket)

    def forget_connections(self):
        self.default.forget_connections()
        with self._lock:
            stores = list(self._buckets.values())
        for store in stores:
            store.forget_connections()

    def _drop_bucket(self, bucket: str):
        import os

        with self._lock:
            store = self._buckets.pop(bucket, None)
        if store is not None:
            store.close()
            try:
                os.remove(os.path.join(self.directory,
                                       f"bucket_{bucket}.db"))
            except FileNotFoundError:
                pass

    def delete_folder_children(self, path: str):
        bucket = self._bucket_of(path)
        if bucket and path.rstrip("/") == f"{self.buckets_root}/{bucket}":
            # whole-bucket delete: clear the dedicated store
            self._store_for(path + "/x").delete_folder_children(path)
            return
        self._store_for(path).delete_folder_children(path)
        if path.rstrip("/") in ("", "/", self.buckets_root):
            for b in list(self._buckets):
                self._drop_bucket(b)

    def list_directory(self, dir_path: str, start_file: str = "",
                       include_start: bool = False, limit: int = 1024,
                       prefix: str = "") -> list[Entry]:
        if dir_path.rstrip("/") == self.buckets_root:
            # bucket roots live in their own stores; merge their REAL
            # stored entries with default-store entries (a fabricated
            # listing would lose attributes and misreport plain files)
            out = [e for e in self.default.list_directory(
                dir_path, start_file=start_file,
                include_start=include_start, limit=limit, prefix=prefix)]
            have = {e.name for e in out}
            for b in sorted(self._buckets):
                if b in have or (prefix and not b.startswith(prefix)):
                    continue
                if start_file and (b < start_file or
                                   (b == start_file
                                    and not include_start)):
                    continue
                try:
                    out.append(self._buckets[b].find_entry(
                        f"{self.buckets_root}/{b}"))
                except NotFoundError:
                    continue  # store file exists but root entry gone
            out.sort(key=lambda e: e.name)
            return out[:limit]
        return self._store_for(dir_path + "/x").list_directory(
            dir_path, start_file=start_file,
            include_start=include_start, limit=limit, prefix=prefix)

    def close(self):
        self.default.close()
        for store in self._buckets.values():
            store.close()
