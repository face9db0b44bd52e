""".idx file handling: a flat stream of 16-byte entries.

Entry = needle_id(8 BE) | offset(4 BE, ÷8) | size(4 BE signed) — the same
16-byte records the reference appends per write and replays on load
(weed/storage/idx/walk.go:12-50).  A zero offset or tombstone size records a
deletion.
"""

from __future__ import annotations

import struct
from typing import Callable, Iterator

from . import types as t

_ENTRY = struct.Struct(">QIi")


def pack_entry(needle_id: int, actual_offset: int, size: int) -> bytes:
    return _ENTRY.pack(
        needle_id, t.to_stored_offset(actual_offset), size
    )


def unpack_entry(b: bytes) -> tuple[int, int, int]:
    """-> (needle_id, actual_offset, size)"""
    nid, stored, size = _ENTRY.unpack(b)
    return nid, t.from_stored_offset(stored), size


def iter_index(data: bytes, start: int = 0) -> Iterator[tuple[int, int, int]]:
    for pos in range(start, len(data) - len(data) % t.NEEDLE_MAP_ENTRY_SIZE,
                     t.NEEDLE_MAP_ENTRY_SIZE):
        yield unpack_entry(data[pos:pos + t.NEEDLE_MAP_ENTRY_SIZE])


def walk_index_file(path: str,
                    fn: Callable[[int, int, int], None],
                    start_from: int = 0):
    """Stream entries from an .idx file, calling fn(id, actual_offset, size)."""
    with open(path, "rb") as f:
        f.seek(start_from)
        while True:
            chunk = f.read(t.NEEDLE_MAP_ENTRY_SIZE * 4096)
            if not chunk:
                break
            for entry in iter_index(chunk):
                fn(*entry)
