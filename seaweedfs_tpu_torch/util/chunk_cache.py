"""Tiered chunk cache: RAM LRU plus size-classed on-disk FIFO layers.

The implementation moved into the unified read-through cache package
(`seaweedfs_tpu_torch/cache/` — HBM -> host RAM -> disk, shared by the volume
server, filer and s3api GET paths).  This module keeps the historical
import surface: `CacheVolume` and `OnDiskCacheLayer` re-export the disk
tier, and `TieredChunkCache` preserves the old positional-`directory`
constructor over `cache.TieredReadCache`.

The port's own copy of seaweedfs_tpu/util/chunk_cache.py.
"""

from __future__ import annotations

from ..cache.disk import CacheVolume, OnDiskCacheLayer  # noqa: F401
from ..cache.read_cache import TieredReadCache


class TieredChunkCache(TieredReadCache):
    """RAM LRU + three size-classed disk layers (chunk_cache.go)."""

    def __init__(self, directory: str, mem_bytes: int = 64 << 20,
                 disk_bytes: int = 1 << 30, unit_size: int = 1 << 20):
        super().__init__(mem_bytes=mem_bytes, directory=directory,
                         disk_bytes=disk_bytes, unit_size=unit_size)
