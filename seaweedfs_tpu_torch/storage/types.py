"""Core storage types: needle ids, offsets, sizes, cookies, file ids.

Layout parity with the reference's weed/storage/types package:
  * NeedleId — uint64 (needle_id_type.go:9-14)
  * Cookie   — uint32 (needle_types.go:19)
  * Offset   — 4 bytes on disk, stored as actual_offset/8, capping volumes at
    32 GB (offset.go:24,61-68); big-endian byte order on disk
  * Size     — int32; negative or -1 means deleted; -1 is the tombstone
    (needle_types.go:10-17)
  * idx entry = 8 (id) + 4 (offset) + 4 (size) = 16 bytes (needle_types.go:25)
"""

from __future__ import annotations

import struct

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
TOMBSTONE_FILE_SIZE = -1
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32 GB

NEEDLE_ID_EMPTY = 0


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def offset_to_bytes(actual_offset: int) -> bytes:
    """Actual byte offset -> 4-byte on-disk form (divided by padding unit)."""
    return struct.pack(">I", actual_offset // NEEDLE_PADDING_SIZE)


def offset_from_bytes(b: bytes) -> int:
    """4-byte on-disk form -> actual byte offset."""
    return struct.unpack(">I", b)[0] * NEEDLE_PADDING_SIZE


def to_stored_offset(actual_offset: int) -> int:
    return actual_offset // NEEDLE_PADDING_SIZE


def from_stored_offset(stored: int) -> int:
    return stored * NEEDLE_PADDING_SIZE


def size_to_bytes(size: int) -> bytes:
    return struct.pack(">I", size & 0xFFFFFFFF)


def size_from_bytes(b: bytes) -> int:
    v = struct.unpack(">I", b)[0]
    return v - (1 << 32) if v >= (1 << 31) else v


def needle_id_to_bytes(nid: int) -> bytes:
    return struct.pack(">Q", nid)


def needle_id_from_bytes(b: bytes) -> int:
    return struct.unpack(">Q", b)[0]


def cookie_to_bytes(cookie: int) -> bytes:
    return struct.pack(">I", cookie)


def cookie_from_bytes(b: bytes) -> int:
    return struct.unpack(">I", b)[0]


# -- file id strings ("vid,idhex[cookiehex]") --------------------------------


def format_file_id(volume_id: int, needle_id: int, cookie: int) -> str:
    """fid string: "<vid>,<idhex><cookie8hex>" (needle.go formatNeedleIdCookie)."""
    return f"{volume_id},{needle_id:x}{cookie:08x}"


def parse_needle_id_cookie(key_hash: str) -> tuple[int, int]:
    """Parse "<idhex><cookie8hex>" -> (needle_id, cookie); needle.go:141-158."""
    if len(key_hash) <= COOKIE_SIZE * 2:
        raise ValueError("key hash too short")
    if len(key_hash) > (NEEDLE_ID_SIZE + COOKIE_SIZE) * 2:
        raise ValueError("key hash too long")
    split = len(key_hash) - COOKIE_SIZE * 2
    return int(key_hash[:split], 16), int(key_hash[split:], 16)


def parse_file_id(fid: str) -> tuple[int, int, int]:
    """Parse "vid,<idhex><cookiehex>[_delta]" -> (vid, needle_id, cookie)."""
    if "," not in fid:
        raise ValueError(f"invalid fid {fid!r}")
    vid_s, key_hash = fid.split(",", 1)
    delta = 0
    if "_" in key_hash:
        key_hash, delta_s = key_hash.rsplit("_", 1)
        delta = int(delta_s)
    nid, cookie = parse_needle_id_cookie(key_hash)
    return int(vid_s), nid + delta, cookie
