"""Recursive chunk manifests for huge files.

Parity with weed/filer/filechunk_manifest.go: when a file accumulates more
than ManifestBatch chunks, batches of chunks are serialized and stored as
chunks themselves (flagged is_chunk_manifest); readers expand manifests
recursively before resolving visible intervals.  This keeps entry metadata
bounded no matter how large the file grows.

The port's own copy of seaweedfs_tpu/filer/filechunk_manifest.py.
"""

from __future__ import annotations

import json
from typing import Callable

from .entry import FileChunk, total_size

MANIFEST_BATCH = 1000  # filechunk_manifest.go ManifestBatch

SaveFn = Callable[[bytes], FileChunk]  # persist blob, return its chunk
FetchFn = Callable[[str], bytes]  # fetch a chunk's bytes by fid


def has_chunk_manifest(chunks: list[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def separate_manifest_chunks(chunks: list[FileChunk]
                             ) -> tuple[list[FileChunk], list[FileChunk]]:
    manifests = [c for c in chunks if c.is_chunk_manifest]
    plain = [c for c in chunks if not c.is_chunk_manifest]
    return manifests, plain


def maybe_manifestize(save: SaveFn, chunks: list[FileChunk],
                      batch: int = MANIFEST_BATCH) -> list[FileChunk]:
    """Fold runs of `batch` plain chunks into manifest chunks
    (doMaybeManifestize, filechunk_manifest.go).  Already-manifest chunks
    pass through; the fold repeats so manifests themselves roll up."""
    manifests, plain = separate_manifest_chunks(chunks)
    if len(plain) < batch:
        return chunks
    out = list(manifests)
    for i in range(0, len(plain) - len(plain) % batch, batch):
        group = plain[i:i + batch]
        body = json.dumps([c.to_dict() for c in group]).encode()
        saved = save(body)
        start = min(c.offset for c in group)
        out.append(FileChunk(
            fid=saved.fid,
            offset=start,
            size=total_size(group) - start,
            etag=saved.etag,
            modified_ts_ns=max(c.modified_ts_ns for c in group),
            is_chunk_manifest=True,
            cipher_key=saved.cipher_key))
    out.extend(plain[len(plain) - len(plain) % batch:])
    return maybe_manifestize(save, out, batch)


def resolve_chunk_manifest(fetch: FetchFn, chunks: list[FileChunk],
                           keep_manifests: bool = False
                           ) -> list[FileChunk]:
    """Expand manifest chunks (recursively) into the full plain chunk list
    (ResolveChunkManifest).  With keep_manifests, the manifest chunks
    themselves stay in the output — deletion needs every fid, including
    intermediate manifest blobs."""
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        if keep_manifests:
            out.append(c)
        blob = fetch(c.fid)
        if c.cipher_key:  # manifest blobs encrypt like data chunks
            from ..util.cipher import decrypt
            blob = decrypt(blob, c.cipher_key)
        nested = [FileChunk.from_dict(d)
                  for d in json.loads(blob.decode())]
        out.extend(resolve_chunk_manifest(fetch, nested, keep_manifests))
    return out
