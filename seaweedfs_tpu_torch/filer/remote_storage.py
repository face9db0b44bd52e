"""Remote-storage mounts on the filer namespace.

Parity with weed/filer/remote_storage.go + remote_mapping.go +
read_remote.go and the shell's remote.* commands: storage configurations
and the dir->remote-location mapping persist inside the filer under
/etc/remote/, mounted directories hold metadata-only entries stamped
with a remote_entry, reads through such an entry proxy to the remote
object, and cache/uncache materialise or drop local chunk copies.

The port's own copy of seaweedfs_tpu/filer/remote_storage.py.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..remote_storage import (RemoteConf, RemoteLocation, RemoteObject,
                              RemoteStorageClient, make_remote_client)
from .entry import Attr, Entry
from .filer import Filer
from .filer_store import NotFoundError

REMOTE_CONF_DIR = "/etc/remote"
MOUNT_MAPPING_PATH = f"{REMOTE_CONF_DIR}/mount.mapping"


def _read_json(filer: Filer, path: str) -> dict:
    try:
        entry = filer.find_entry(path)
    except NotFoundError:
        return {}
    try:
        return json.loads(entry.content.decode())
    except ValueError:
        return {}


def _write_json(filer: Filer, path: str, doc: dict):
    now = time.time()
    filer.create_entry(Entry(
        full_path=path,
        attr=Attr(mtime=now, crtime=now, mime="application/json",
                  file_size=0),
        content=json.dumps(doc, indent=2).encode()))


# -- storage configurations (remote.configure) -------------------------------

def save_remote_conf(filer: Filer, conf: RemoteConf):
    _write_json(filer, f"{REMOTE_CONF_DIR}/{conf.name}.conf",
                conf.to_dict())


def load_remote_conf(filer: Filer, name: str) -> RemoteConf:
    doc = _read_json(filer, f"{REMOTE_CONF_DIR}/{name}.conf")
    if not doc:
        raise NotFoundError(f"remote storage {name!r} not configured")
    return RemoteConf.from_dict(doc)


def delete_remote_conf(filer: Filer, name: str):
    try:
        filer.delete_entry(f"{REMOTE_CONF_DIR}/{name}.conf")
    except NotFoundError:
        pass


def list_remote_confs(filer: Filer) -> list[RemoteConf]:
    try:
        entries = filer.list_directory(REMOTE_CONF_DIR, limit=1000)
    except NotFoundError:
        return []
    out = []
    for e in entries:
        if e.full_path.endswith(".conf"):
            doc = _read_json(filer, e.full_path)
            if doc:
                out.append(RemoteConf.from_dict(doc))
    return out


def client_for(filer: Filer, name: str) -> RemoteStorageClient:
    return make_remote_client(load_remote_conf(filer, name))


# -- mount mapping (remote.mount / remote.unmount) ---------------------------

def read_mount_mappings(filer: Filer) -> dict[str, str]:
    """dir -> 'name/bucket/path'."""
    return _read_json(filer, MOUNT_MAPPING_PATH).get("mappings", {})


def insert_mount_mapping(filer: Filer, directory: str, remote: str):
    mappings = read_mount_mappings(filer)
    mappings[directory.rstrip("/") or "/"] = remote
    _write_json(filer, MOUNT_MAPPING_PATH, {"mappings": mappings})


def delete_mount_mapping(filer: Filer, directory: str):
    mappings = read_mount_mappings(filer)
    mappings.pop(directory.rstrip("/") or "/", None)
    _write_json(filer, MOUNT_MAPPING_PATH, {"mappings": mappings})


def mapped_location(filer: Filer,
                    path: str) -> Optional[tuple[str, RemoteLocation]]:
    """Find the mount covering `path`; returns (mount_dir, remote loc of
    this exact path) or None."""
    mappings = read_mount_mappings(filer)
    best = ""
    for directory in mappings:
        if (path == directory or path.startswith(
                directory.rstrip("/") + "/")) and \
                len(directory) > len(best):
            best = directory
    if not best:
        return None
    root = RemoteLocation.parse(mappings[best])
    rel = path[len(best):].lstrip("/")
    loc = RemoteLocation(root.name, root.bucket,
                         (root.path.rstrip("/") + "/" + rel)
                         if rel else root.path)
    return best, loc


# -- metadata sync (remote.mount initial pull, remote.meta.sync) -------------

def sync_metadata(filer: Filer, directory: str) -> int:
    """Pull the remote listing into metadata-only entries under the
    mount (remote.meta.sync / the pull phase of remote.mount)."""
    directory = directory.rstrip("/") or "/"
    mappings = read_mount_mappings(filer)
    if directory not in mappings:
        raise NotFoundError(f"{directory} is not a remote mount")
    loc = RemoteLocation.parse(mappings[directory])
    client = client_for(filer, loc.name)
    count = 0
    now = time.time()
    seen: set[str] = set()
    for obj in client.traverse(loc):
        full = f"{directory}/{obj.key}"
        seen.add(full)
        try:
            existing = filer.find_entry(full)
            remote = existing.remote_entry
            if remote and remote.get("remote_e_tag") == obj.etag \
                    and remote.get("remote_size") == obj.size:
                continue  # unchanged
        except NotFoundError:
            existing = None
        entry = Entry(
            full_path=full,
            attr=Attr(mtime=obj.mtime or now, crtime=obj.mtime or now,
                      file_size=obj.size),
            remote_entry=obj.to_remote_entry(loc.name))
        if existing is not None and existing.chunks:
            # local cache out of date relative to the remote: drop it
            entry.chunks = []
        filer.create_entry(entry)
        count += 1
    # reconcile deletions: a metadata-only entry (never locally written)
    # whose remote object vanished must go too, or reads through it 404
    stack = [directory]
    while stack:
        d = stack.pop()
        try:
            children = filer.list_directory(d, limit=100000)
        except NotFoundError:
            continue
        for child in children:
            if child.is_directory:
                stack.append(child.full_path)
            elif child.remote_entry and not child.chunks \
                    and not child.content and child.full_path not in seen:
                filer.delete_entry(child.full_path)
                count += 1
    return count


def read_through(filer: Filer, entry: Entry) -> bytes:
    """Serve a metadata-only remote entry by fetching the remote object
    (read_remote.go ReadRemote)."""
    found = mapped_location(filer, entry.full_path)
    if found is None:
        raise NotFoundError(f"{entry.full_path} has no remote mount")
    _, loc = found
    return client_for(filer, loc.name).read_file(loc)
