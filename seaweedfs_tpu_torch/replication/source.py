"""Source-cluster accessors for replication.

Parity with weed/replication/source/filer_source.go: the FilerSource
resolves a source entry's bytes — via the source filer's HTTP read path,
which already handles chunk-manifest resolution, inlined content, and
volume lookup — and exposes the metadata feed cursor.

The port's own copy of seaweedfs_tpu/replication/source.py.
"""

from __future__ import annotations

import urllib.parse
from typing import Iterator, Optional

from ..rpc.http_rpc import RpcError, call


class FilerSource:
    def __init__(self, filer_address: str, path: str = "/"):
        self.address = filer_address
        self.path = path if path.endswith("/") else path + "/"

    def read_entry_bytes(self, full_path: str) -> bytes:
        """Fetch assembled file content from the source filer (the filer
        read path resolves chunks/manifests server-side, the equivalent of
        filer_source.go ReadPart fetching each chunk from volume
        servers)."""
        quoted = urllib.parse.quote(full_path)
        # parse=False: a stored .json object must come back as bytes
        body = call(self.address, quoted, timeout=120, parse=False)
        if isinstance(body, bytes):
            return body
        raise RpcError(f"{full_path} is not a file", 400)

    def has_entry(self, full_path: str) -> bool:
        """Whether the source filer still holds the entry: a HEAD reads
        its metadata only, so a 404 here means the path itself is gone,
        not that one of its chunks cannot be read."""
        try:
            call(self.address, urllib.parse.quote(full_path),
                 method="HEAD", timeout=60, parse=False)
        except RpcError as e:
            if e.status == 404:
                return False
            raise
        return True

    def subscribe(self, since_ns: int = 0,
                  prefix: Optional[str] = None) -> list[dict]:
        """One poll of the metadata feed (SubscribeMetadata replay+tail)."""
        prefix = prefix or self.path
        resp = call(
            self.address,
            f"/metadata/subscribe?since={since_ns}"
            f"&pathPrefix={urllib.parse.quote(prefix)}",
            timeout=60)
        return resp.get("events", [])

    def iter_events(self, since_ns: int = 0) -> Iterator[dict]:
        for event in self.subscribe(since_ns):
            yield event
