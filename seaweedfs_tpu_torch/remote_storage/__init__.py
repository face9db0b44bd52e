"""Remote storage providers (weed/remote_storage).

A RemoteStorageClient abstracts an external object store that filer
directories can be mounted onto: traverse its namespace, read/write/
delete objects, and stat them.  The reference ships an S3 provider
(remote_storage/s3/s3_storage_client.go) built on the AWS SDK; here the
S3 provider speaks SigV4 through the framework's own client (works
against any S3-compatible endpoint, including this framework's gateway),
and a `local` directory-tree provider exists for tests and air-gapped
use.

A remote location string is `name/bucket/path` where `name` identifies
a configured storage (remote_pb.RemoteStorageLocation).

The port's own copy of seaweedfs_tpu/remote_storage/__init__.py.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional


@dataclass
class RemoteConf:
    """One configured remote storage (remote.conf entry)."""

    name: str
    type: str = "s3"  # s3 | local
    endpoint: str = ""
    access_key: str = ""
    secret_key: str = ""
    directory: str = ""  # local provider root

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.type,
                "endpoint": self.endpoint, "access_key": self.access_key,
                "secret_key": self.secret_key,
                "directory": self.directory}

    @classmethod
    def from_dict(cls, d: dict) -> "RemoteConf":
        return cls(**{k: d[k] for k in
                      ("name", "type", "endpoint", "access_key",
                       "secret_key", "directory") if k in d})


@dataclass
class RemoteLocation:
    """Parsed `name/bucket/path` location."""

    name: str
    bucket: str = ""
    path: str = "/"

    @classmethod
    def parse(cls, s: str) -> "RemoteLocation":
        parts = s.strip("/").split("/", 2)
        return cls(name=parts[0],
                   bucket=parts[1] if len(parts) > 1 else "",
                   path="/" + (parts[2] if len(parts) > 2 else ""))

    def __str__(self) -> str:
        return f"{self.name}/{self.bucket}{self.path}"

    def child(self, name: str) -> "RemoteLocation":
        base = self.path.rstrip("/")
        return RemoteLocation(self.name, self.bucket, f"{base}/{name}")


@dataclass
class RemoteObject:
    """One remote object's metadata (remote_pb.RemoteEntry)."""

    key: str  # path relative to the traversal root, no leading /
    size: int = 0
    mtime: float = 0.0
    etag: str = ""

    def to_remote_entry(self, storage_name: str) -> dict:
        return {"storage_name": storage_name, "remote_size": self.size,
                "remote_mtime": self.mtime, "remote_e_tag": self.etag,
                "last_local_sync_ts_ns": time.time_ns()}


class RemoteStorageClient:
    def traverse(self, loc: RemoteLocation) -> Iterator[RemoteObject]:
        raise NotImplementedError

    def read_file(self, loc: RemoteLocation) -> bytes:
        raise NotImplementedError

    def write_file(self, loc: RemoteLocation, data: bytes) -> RemoteObject:
        raise NotImplementedError

    def delete_file(self, loc: RemoteLocation):
        raise NotImplementedError

    def delete_prefix(self, loc: RemoteLocation):
        """Delete every object under a prefix (directory delete)."""
        for obj in list(self.traverse(loc)):
            self.delete_file(loc.child(obj.key))

    def read_range(self, loc: RemoteLocation, offset: int,
                   size: int) -> bytes:
        """Ranged read; default slices a whole-object fetch."""
        return self.read_file(loc)[offset:offset + size]

    def write_file_from(self, loc: RemoteLocation, read_chunk,
                        total_size: int) -> "RemoteObject":
        """Streaming write from a chunk reader.  The default accumulates
        (single-PUT stores); file-backed providers override to stream."""
        parts = []
        while True:
            chunk = read_chunk()
            if not chunk:
                break
            parts.append(chunk)
        return self.write_file(loc, b"".join(parts))

    def stat(self, loc: RemoteLocation) -> Optional[RemoteObject]:
        """Metadata of one object, or None when absent."""
        raise NotImplementedError


class LocalRemoteStorage(RemoteStorageClient):
    """A directory tree as a 'remote' (tests, NFS mounts, air-gap)."""

    def __init__(self, conf: RemoteConf):
        self.root = conf.directory

    def _abs(self, loc: RemoteLocation) -> str:
        return os.path.join(self.root, loc.bucket,
                            loc.path.lstrip("/"))

    def traverse(self, loc: RemoteLocation) -> Iterator[RemoteObject]:
        base = self._abs(loc)
        for dirpath, _, files in os.walk(base):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                st = os.stat(full)
                yield RemoteObject(
                    key=os.path.relpath(full, base),
                    size=st.st_size, mtime=st.st_mtime,
                    etag=f"{st.st_mtime_ns:x}-{st.st_size:x}")

    def read_file(self, loc: RemoteLocation) -> bytes:
        with open(self._abs(loc), "rb") as f:
            return f.read()

    def write_file(self, loc: RemoteLocation, data: bytes) -> RemoteObject:
        path = self._abs(loc)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        st = os.stat(path)
        return RemoteObject(key=loc.path.lstrip("/"), size=len(data),
                            mtime=st.st_mtime,
                            etag=f"{st.st_mtime_ns:x}-{st.st_size:x}")

    def delete_file(self, loc: RemoteLocation):
        try:
            os.remove(self._abs(loc))
        except FileNotFoundError:
            pass

    def read_range(self, loc: RemoteLocation, offset: int,
                   size: int) -> bytes:
        with open(self._abs(loc), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def write_file_from(self, loc: RemoteLocation, read_chunk,
                        total_size: int) -> RemoteObject:
        path = self._abs(loc)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            while True:
                chunk = read_chunk()
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, path)
        st = os.stat(path)
        return RemoteObject(key=loc.path.lstrip("/"), size=st.st_size,
                            mtime=st.st_mtime,
                            etag=f"{st.st_mtime_ns:x}-{st.st_size:x}")

    def stat(self, loc: RemoteLocation) -> Optional[RemoteObject]:
        try:
            st = os.stat(self._abs(loc))
        except FileNotFoundError:
            return None
        return RemoteObject(key=loc.path.lstrip("/"), size=st.st_size,
                            mtime=st.st_mtime,
                            etag=f"{st.st_mtime_ns:x}-{st.st_size:x}")


class S3RemoteStorage(RemoteStorageClient):
    """Any S3-compatible endpoint via the SigV4 client
    (remote_storage/s3/s3_storage_client.go)."""

    def __init__(self, conf: RemoteConf):
        from ..wdclient.s3_client import S3Client

        self.client = S3Client(conf.endpoint, conf.access_key,
                               conf.secret_key)

    def traverse(self, loc: RemoteLocation) -> Iterator[RemoteObject]:
        import calendar

        prefix = loc.path.lstrip("/")
        for obj in self.client.list_objects(loc.bucket, prefix):
            key = obj["key"]
            data_key = key[len(prefix):].lstrip("/") if prefix else key
            mtime = 0.0
            if obj.get("last_modified"):
                try:
                    mtime = calendar.timegm(time.strptime(
                        obj["last_modified"], "%Y-%m-%dT%H:%M:%S.000Z"))
                except ValueError:
                    pass
            yield RemoteObject(key=data_key or key, size=obj["size"],
                              mtime=mtime, etag=obj.get("etag", ""))

    def read_file(self, loc: RemoteLocation) -> bytes:
        return self.client.get_object(loc.bucket, loc.path.lstrip("/"))

    def write_file(self, loc: RemoteLocation, data: bytes) -> RemoteObject:
        self.client.put_object(loc.bucket, loc.path.lstrip("/"), data)
        return RemoteObject(key=loc.path.lstrip("/"), size=len(data),
                            mtime=time.time())

    def delete_file(self, loc: RemoteLocation):
        self.client.delete_object(loc.bucket, loc.path.lstrip("/"))

    def read_range(self, loc: RemoteLocation, offset: int,
                   size: int) -> bytes:
        return self.client.get_object_range(
            loc.bucket, loc.path.lstrip("/"), offset, size)

    def stat(self, loc: RemoteLocation) -> Optional[RemoteObject]:
        import calendar

        key = loc.path.lstrip("/")
        # exact-key prefix listing: the full key is the prefix, so the
        # page holds the object itself plus at most same-prefix siblings
        for obj in self.client.list_objects(loc.bucket, key):
            if obj["key"] == key:
                mtime = 0.0
                if obj.get("last_modified"):
                    try:
                        mtime = calendar.timegm(time.strptime(
                            obj["last_modified"],
                            "%Y-%m-%dT%H:%M:%S.000Z"))
                    except ValueError:
                        pass
                return RemoteObject(key=key, size=obj["size"],
                                    mtime=mtime,
                                    etag=obj.get("etag", ""))
        return None


def make_remote_client(conf: RemoteConf) -> RemoteStorageClient:
    if conf.type == "local":
        return LocalRemoteStorage(conf)
    if conf.type == "s3":
        return S3RemoteStorage(conf)
    raise ValueError(f"unknown remote storage type {conf.type!r}")
