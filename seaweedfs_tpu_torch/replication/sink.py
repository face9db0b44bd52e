"""Replication sinks: filer / local / s3.

Parity with weed/replication/sink/replication_sink.go's ReplicationSink
interface (CreateEntry/UpdateEntry/DeleteEntry/GetSinkToDirectory/
IsIncremental) and its three implementations: filersink (another
SeaweedFS cluster), localsink (local filesystem tree), s3sink (any
S3-compatible endpoint — here usually this framework's own gateway).

The port's own copy of seaweedfs_tpu/replication/sink.py.  One
departure: an entry whose path the source no longer serves (a part of a
completed multipart upload, a file deleted or renamed since its event)
raises `SourceGone` instead of the source's 404, and the Replicator
skips it; a later event of the same feed removes or renames that path.
A 404 for an entry the source still lists (a chunk it cannot read now)
stays an error, so the cursor does not move past it.
"""

from __future__ import annotations

import os
import urllib.parse
from typing import Optional

from ..rpc.http_rpc import RpcError, call
from .source import FilerSource


class SourceGone(Exception):
    """The source no longer has the entry's path: its content cannot be
    read, and a later event of the feed deletes or renames it."""


class ReplicationSink:
    """One replication target; data bytes come from the FilerSource."""

    name = "sink"
    is_incremental = False  # incremental sinks file changes under date dirs
    sink_dir = "/"

    def set_source(self, source: FilerSource):
        self.source = source

    def create_entry(self, key: str, entry: dict, is_directory: bool):
        raise NotImplementedError

    def update_entry(self, key: str, old_entry: dict, new_entry: dict,
                     is_directory: bool):
        # default: re-create (sinks that can diff override this)
        self.create_entry(key, new_entry, is_directory)

    def delete_entry(self, key: str, is_directory: bool):
        raise NotImplementedError

    # -- helpers -------------------------------------------------------------
    def _entry_bytes(self, entry: dict) -> bytes:
        """Materialise an entry's content: inlined bytes or a source read."""
        content = entry.get("content", "")
        if content:
            return bytes.fromhex(content)
        if not entry.get("chunks"):
            return b""
        try:
            return self.source.read_entry_bytes(entry["full_path"])
        except RpcError as e:
            # a 404 for an entry that still exists (a chunk with no
            # locations while its volume server is down) must be retried
            if e.status == 404 and \
                    not self.source.has_entry(entry["full_path"]):
                raise SourceGone(entry["full_path"]) from None
            raise


class FilerSink(ReplicationSink):
    """Replicate into another filer over its HTTP API
    (sink/filersink/filer_sink.go)."""

    name = "filer"
    is_incremental = False

    def __init__(self, filer_address: str, sink_dir: str = "/",
                 signature: int = 0):
        self.address = filer_address
        self.sink_dir = sink_dir.rstrip("/") or ""
        self.signature = signature

    def _headers(self) -> dict:
        if self.signature:
            return {"X-Sw-Signature": str(self.signature)}
        return {}

    def _target(self, key: str) -> str:
        return urllib.parse.quote(self.sink_dir + key)

    def create_entry(self, key: str, entry: dict, is_directory: bool):
        if is_directory:
            call(self.address, self._target(key) + "/", raw=b"",
                 method="POST", headers=self._headers(), timeout=60)
            return
        data = self._entry_bytes(entry)
        mime = entry.get("attr", {}).get("mime", "") \
            or "application/octet-stream"
        headers = {"Content-Type": mime, **self._headers()}
        call(self.address, self._target(key), raw=data, method="POST",
             headers=headers, timeout=120)

    def update_entry(self, key: str, old_entry: dict, new_entry: dict,
                     is_directory: bool):
        # skip no-op updates: same chunk list + same inlined content means
        # only metadata moved (filer_sink.go compareChunks fast path)
        if old_entry and new_entry and \
                old_entry.get("chunks") == new_entry.get("chunks") and \
                old_entry.get("content") == new_entry.get("content"):
            return
        self.create_entry(key, new_entry, is_directory)

    def delete_entry(self, key: str, is_directory: bool):
        path = self._target(key)
        if is_directory:
            path += "?recursive=true"
        try:
            call(self.address, path, method="DELETE",
                 headers=self._headers(), timeout=60)
        except RpcError as e:
            if e.status != 404:
                raise


class LocalSink(ReplicationSink):
    """Mirror files into a local directory tree
    (sink/localsink/local_sink.go; used by `weed filer.backup`)."""

    name = "local"

    def __init__(self, directory: str, is_incremental: bool = False):
        self.directory = directory
        self.is_incremental = is_incremental
        self.sink_dir = ""

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key.lstrip("/"))

    def create_entry(self, key: str, entry: dict, is_directory: bool):
        path = self._path(key)
        if is_directory:
            os.makedirs(path, exist_ok=True)
            return
        # read before open: a failed read leaves no empty file behind
        data = self._entry_bytes(entry)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def delete_entry(self, key: str, is_directory: bool):
        path = self._path(key)
        try:
            if is_directory:
                import shutil

                shutil.rmtree(path)
            else:
                os.remove(path)
        except FileNotFoundError:
            pass


class S3Sink(ReplicationSink):
    """Replicate objects into an S3-compatible endpoint
    (sink/s3sink/s3_sink.go)."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, directory: str = "",
                 access_key: str = "", secret_key: str = "",
                 is_incremental: bool = False):
        from ..wdclient.s3_client import S3Client

        self.client = S3Client(endpoint, access_key, secret_key)
        self.bucket = bucket
        self.sink_dir = directory.rstrip("/")
        self.is_incremental = is_incremental

    def _key(self, key: str) -> str:
        return (self.sink_dir + key).lstrip("/")

    def create_entry(self, key: str, entry: dict, is_directory: bool):
        if is_directory:
            return  # S3 has no directories
        mime = entry.get("attr", {}).get("mime", "") \
            or "application/octet-stream"
        self.client.put_object(self.bucket, self._key(key),
                               self._entry_bytes(entry), mime)

    def delete_entry(self, key: str, is_directory: bool):
        if is_directory:
            for k in self.client.list_keys(
                    self.bucket, self._key(key).rstrip("/") + "/"):
                self.client.delete_object(self.bucket, k)
            return
        self.client.delete_object(self.bucket, self._key(key))


def make_sink(spec: str, access_key: str = "", secret_key: str = "",
              signature: int = 0,
              is_incremental: bool = False) -> ReplicationSink:
    """Build a sink from a URI-ish spec:
    ``filer://host:port/dir``, ``local:///backup/dir``,
    ``s3://bucket/dir?endpoint=host:port``."""
    parsed = urllib.parse.urlparse(spec)
    if parsed.scheme == "filer":
        return FilerSink(parsed.netloc, parsed.path or "/",
                         signature=signature)
    if parsed.scheme == "local":
        return LocalSink(parsed.path, is_incremental=is_incremental)
    if parsed.scheme == "s3":
        query = dict(urllib.parse.parse_qsl(parsed.query))
        endpoint = query.get("endpoint", "")
        if not endpoint:
            raise ValueError("s3 sink needs ?endpoint=host:port")
        return S3Sink(endpoint, parsed.netloc, parsed.path,
                      access_key=access_key, secret_key=secret_key,
                      is_incremental=is_incremental)
    raise ValueError(f"unknown sink spec {spec!r} "
                     "(want filer://, local://, or s3://)")
