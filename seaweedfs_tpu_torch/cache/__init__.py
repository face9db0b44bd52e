"""Unified tiered read-through cache for object GETs.

Counterpart of seaweedfs_tpu/cache/.

One cache subsystem shared by the volume-server needle-read path, the
filer chunk-fetch path and the s3api GET path, replacing the two
historical disjoint caches (``util/chunk_cache.py`` and
``filer/reader_cache.py``, both of which now re-export from here):

  HBM   — hottest chunks held in `DevicePool` resident slabs on the
          card (``WEED_READ_CACHE_HBM_MB``, default off)
  RAM   — warm chunks in a host LRU bounded by byte budget
          (``WEED_READ_CACHE_MB``)
  disk  — cold chunks in size-classed append-only FIFO ring volumes
          (``WEED_READ_CACHE_DISK_MB``)

Admission is QoS-class-aware: interactive/standard traffic fills on
miss, background traffic (scrubs, rebuilds) bypasses the fill so
maintenance sweeps cannot wash the cache (override with
``WEED_READ_CACHE_BG_FILL=1``).  Hits serve via zero-copy `memoryview`
writeback into the socket send; invalidation hooks ride the existing
delete / vacuum / ec.rebuild paths.  The filer's and volume server's
re-exports (``util/chunk_cache.py``, ``filer/reader_cache.py``) come with
those modules.
"""

from .ram import RamCache
from .disk import CacheVolume, OnDiskCacheLayer
from .hbm import HbmTier
from .read_cache import (ChunkCache, TieredReadCache, background_fills,
                         default_disk_bytes, default_hbm_bytes,
                         default_mem_bytes)

__all__ = [
    "CacheVolume",
    "ChunkCache",
    "HbmTier",
    "OnDiskCacheLayer",
    "RamCache",
    "TieredReadCache",
    "background_fills",
    "default_disk_bytes",
    "default_hbm_bytes",
    "default_mem_bytes",
]
