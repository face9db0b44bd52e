"""Filer entry model: a path plus attributes plus a chunk list.

Parity with weed/filer/entry.go:11-45 + filer.proto Entry/FuseAttributes:
an Entry is either a directory (no chunks) or a file assembled from
FileChunks, each pointing at a needle (fid) in a volume, with offset/size
describing where the chunk sits in the logical file.  Small files may be
inlined in `content` (filer_server_handlers_write_autochunk.go
saveSmallContentToMetadata).

The port's own copy of seaweedfs_tpu/filer/entry.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FileChunk:
    fid: str  # "vid,keyhexcookiehex"
    offset: int  # position in the logical file
    size: int  # PLAINTEXT size (ciphered blobs are larger on the volume)
    etag: str = ""
    modified_ts_ns: int = 0
    is_chunk_manifest: bool = False  # chunk holds a serialized chunk list
    # per-chunk AES key for encrypt-at-rest (filer.proto FileChunk
    # cipher_key); lives only in filer metadata, never on volume servers
    cipher_key: bytes = b""

    def to_dict(self) -> dict:
        d = {"fid": self.fid, "offset": self.offset, "size": self.size,
             "etag": self.etag, "modified_ts_ns": self.modified_ts_ns}
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key.hex()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(fid=d["fid"], offset=d["offset"], size=d["size"],
                   etag=d.get("etag", ""),
                   modified_ts_ns=d.get("modified_ts_ns", 0),
                   is_chunk_manifest=d.get("is_chunk_manifest", False),
                   cipher_key=bytes.fromhex(d["cipher_key"])
                   if d.get("cipher_key") else b"")


@dataclass
class Attr:
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: list = field(default_factory=list)
    md5: str = ""
    file_size: int = 0

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & 0o40000)  # os.ModeDir analogue


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict = field(default_factory=dict)
    content: bytes = b""  # inlined small-file content
    hard_link_id: str = ""
    symlink_target: str = ""
    # remote-storage mount bookkeeping (filer.proto RemoteEntry): set on
    # entries under a mounted directory; a file with a remote_entry and
    # no chunks reads through to the remote object
    remote_entry: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.full_path.rsplit("/", 1)[-1]

    @property
    def parent(self) -> str:
        parent = self.full_path.rsplit("/", 1)[0]
        return parent or "/"

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    def size(self) -> int:
        if self.content:
            return len(self.content)
        return max(self.attr.file_size,
                   total_size(self.chunks))

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "attr": {
                "mtime": self.attr.mtime, "crtime": self.attr.crtime,
                "mode": self.attr.mode, "uid": self.attr.uid,
                "gid": self.attr.gid, "mime": self.attr.mime,
                "ttl_sec": self.attr.ttl_sec, "md5": self.attr.md5,
                "file_size": self.attr.file_size,
            },
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
            "content": self.content.hex() if self.content else "",
            "hard_link_id": self.hard_link_id,
            "symlink_target": self.symlink_target,
            **({"remote_entry": self.remote_entry}
               if self.remote_entry else {}),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        a = d.get("attr", {})
        return cls(
            full_path=d["full_path"],
            attr=Attr(mtime=a.get("mtime", 0), crtime=a.get("crtime", 0),
                      mode=a.get("mode", 0o660), uid=a.get("uid", 0),
                      gid=a.get("gid", 0), mime=a.get("mime", ""),
                      ttl_sec=a.get("ttl_sec", 0), md5=a.get("md5", ""),
                      file_size=a.get("file_size", 0)),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
            content=bytes.fromhex(d["content"]) if d.get("content") else b"",
            hard_link_id=d.get("hard_link_id", ""),
            symlink_target=d.get("symlink_target", ""),
            remote_entry=d.get("remote_entry", {}),
        )


def new_directory_entry(path: str, mode: int = 0o770) -> Entry:
    now = time.time()
    return Entry(full_path=path,
                 attr=Attr(mtime=now, crtime=now, mode=mode | 0o40000))


def total_size(chunks: list[FileChunk]) -> int:
    """Logical file size = max chunk end (filechunks.go TotalSize)."""
    size = 0
    for c in chunks:
        size = max(size, c.offset + c.size)
    return size
