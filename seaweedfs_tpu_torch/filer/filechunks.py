"""Chunked-file model: overlapping chunk resolution into visible intervals.

Parity with weed/filer/filechunks.go: a file's chunk list may contain
overlapping writes (later mtime wins); readers need the non-overlapping
"visible" view, and range reads need (chunk, offset-in-chunk, size) spans.
ETag of a multi-chunk file = md5 of the concatenated chunk md5s
(filer/filechunks.go ETagChunks).

The port's own copy of seaweedfs_tpu/filer/filechunks.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .entry import FileChunk


@dataclass
class VisibleInterval:
    start: int
    stop: int
    fid: str
    modified_ts_ns: int
    chunk_offset: int  # where `start` falls inside the chunk
    chunk_size: int
    cipher_key: bytes = b""


def non_overlapping_visible_intervals(chunks: list[FileChunk]
                                      ) -> list[VisibleInterval]:
    """Resolve overlapping chunks: later-modified chunks shadow earlier
    ones (NonOverlappingVisibleIntervals, filechunks.go:14-80)."""
    visibles: list[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: (c.modified_ts_ns, c.fid)):
        new_v = VisibleInterval(
            start=chunk.offset, stop=chunk.offset + chunk.size,
            fid=chunk.fid, modified_ts_ns=chunk.modified_ts_ns,
            chunk_offset=0, chunk_size=chunk.size,
            cipher_key=chunk.cipher_key)
        out: list[VisibleInterval] = []
        for v in visibles:
            if v.stop <= new_v.start or v.start >= new_v.stop:
                out.append(v)  # no overlap
                continue
            if v.start < new_v.start:
                out.append(VisibleInterval(
                    start=v.start, stop=new_v.start, fid=v.fid,
                    modified_ts_ns=v.modified_ts_ns,
                    chunk_offset=v.chunk_offset,
                    chunk_size=v.chunk_size,
                    cipher_key=v.cipher_key))
            if v.stop > new_v.stop:
                out.append(VisibleInterval(
                    start=new_v.stop, stop=v.stop, fid=v.fid,
                    modified_ts_ns=v.modified_ts_ns,
                    chunk_offset=v.chunk_offset + (new_v.stop - v.start),
                    chunk_size=v.chunk_size,
                    cipher_key=v.cipher_key))
        out.append(new_v)
        visibles = sorted(out, key=lambda v: v.start)
    return visibles


@dataclass
class ChunkView:
    fid: str
    offset_in_chunk: int
    size: int
    logic_offset: int
    cipher_key: bytes = b""


def read_chunk_views(chunks: list[FileChunk], offset: int,
                     size: int) -> list[ChunkView]:
    """Spans to fetch for a [offset, offset+size) read
    (ViewFromChunks/ReadFromChunks, filechunks_read.go)."""
    views: list[ChunkView] = []
    stop = offset + size
    for v in non_overlapping_visible_intervals(chunks):
        if v.stop <= offset or v.start >= stop:
            continue
        start = max(offset, v.start)
        end = min(stop, v.stop)
        views.append(ChunkView(
            fid=v.fid,
            offset_in_chunk=v.chunk_offset + (start - v.start),
            size=end - start,
            logic_offset=start,
            cipher_key=v.cipher_key))
    return views


def etag_of_chunks(chunks: list[FileChunk]) -> str:
    """md5-of-md5s for multi-chunk files (filechunks.go ETagChunks)."""
    if len(chunks) == 1:
        return chunks[0].etag
    h = hashlib.md5()
    for c in sorted(chunks, key=lambda c: c.offset):
        h.update(bytes.fromhex(c.etag) if c.etag else b"")
    return f"{h.hexdigest()}-{len(chunks)}"
