"""Metadata-only backup: mirror a filer's entry tree into a local store.

Parity with weed/command/filer_meta_backup.go: subscribe to the source
filer's metadata feed and apply every event to a self-contained local
store (sqlite here), so the namespace can be inspected or restored even
if the source filer's store is lost.  File *content* is not copied —
that is `weed filer.backup`'s job.

The port's own copy of seaweedfs_tpu/replication/meta_backup.py.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..filer.filer import Filer
from ..filer.filer_store import SqliteStore
from ..filer.meta_aggregator import apply_meta_event
from .source import FilerSource


class MetaBackup:
    def __init__(self, filer_address: str, path: str, store_path: str):
        self.source = FilerSource(filer_address, path)
        self.store_path = store_path
        self.filer = Filer(store=SqliteStore(store_path))
        self._cursor_path = store_path + ".cursor"
        self.cursor = self._load_cursor()

    def _load_cursor(self) -> int:
        try:
            with open(self._cursor_path) as f:
                return json.load(f)["since_ns"]
        except (OSError, ValueError, KeyError):
            return 0

    def _save_cursor(self):
        tmp = self._cursor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"since_ns": self.cursor}, f)
        os.replace(tmp, self._cursor_path)

    def run_once(self) -> int:
        """One poll: apply new events to the local store; returns count."""
        applied = 0
        for event in self.source.subscribe(self.cursor):
            key = ((event.get("new_entry") or event.get("old_entry")
                    or {}).get("full_path", ""))
            if key and (key.startswith(self.source.path)
                        or key + "/" == self.source.path):
                apply_meta_event(self.filer, event)
                applied += 1
            self.cursor = max(self.cursor, event["ts_ns"])
        if applied:
            self._save_cursor()
        return applied

    def close(self):
        self._save_cursor()
        self.filer.store.close()


def restore_listing(store_path: str, path: str = "/",
                    recursive: bool = True) -> list[dict]:
    """Read back entries from a meta-backup store (the `-restore` side)."""
    filer = Filer(store=SqliteStore(store_path))
    out: list[dict] = []

    def walk(dir_path: str):
        for entry in filer.list_directory(dir_path):
            out.append(entry.to_dict())
            if entry.is_directory and recursive:
                walk(entry.full_path)

    walk(path)
    filer.store.close()
    return out
