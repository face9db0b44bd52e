"""Offline shard-file checks: whole-file CRC32Cs against the `.vif` record.

Counterpart of the shard-scrub part of seaweedfs_tpu/storage/tools.py,
which `maintenance/deep_scrub.deep_scrub_host` needs.
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def shard_file_crc32c(path: str, chunk_size: int = 4 << 20,
                      throttle: Optional[Callable[[int], None]] = None
                      ) -> int:
    """Whole-file CRC32C, streamed in bounded chunks.  `throttle` is called
    with each chunk's byte count before the bytes are hashed, so a pacer
    can hold a background scrub to its rate."""
    from ..ops.crc32c import crc32c

    chunk_size = max(64 << 10, int(chunk_size))
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            if throttle is not None:
                throttle(len(chunk))
            crc = crc32c(chunk, crc)
    return crc


def verify_shard_files(base: str, stored,
                       chunk_size: int = 4 << 20,
                       throttle: Optional[Callable[[int], None]] = None
                       ) -> tuple[list, list, list]:
    """Classify the .ecNN files at `base` against the recorded CRCs:
    -> (clean, corrupt, absent) shard-id lists.  Raises ValueError when
    the .vif carries no CRC record."""
    from .erasure_coding import TOTAL_SHARDS_COUNT, to_ext

    if not isinstance(stored, list) or len(stored) != TOTAL_SHARDS_COUNT:
        raise ValueError(
            f"{base}.vif has no shard_crc32c record to scrub against")
    clean, corrupt, absent = [], [], []
    for sid in range(TOTAL_SHARDS_COUNT):
        path = base + to_ext(sid)
        if not os.path.exists(path):
            absent.append(sid)
        elif shard_file_crc32c(path, chunk_size=chunk_size,
                               throttle=throttle) == stored[sid]:
            clean.append(sid)
        else:
            corrupt.append(sid)
    return clean, corrupt, absent
