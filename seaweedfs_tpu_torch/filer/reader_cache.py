"""Chunk-level read cache for streaming filer reads.

Parity with weed/filer/reader_cache.go + weed/util/chunk_cache:
recently fetched chunks are kept in RAM (bounded by byte budget, LRU
eviction) so sequential and repeated reads of the same file avoid
re-fetching from volume servers.

The implementation now lives in the unified read-through cache package
(`seaweedfs_tpu_torch/cache/`); this module keeps the public `ChunkCache`
name for its importers.

The port's own copy of seaweedfs_tpu/filer/reader_cache.py.
"""

from __future__ import annotations

from ..cache.read_cache import ChunkCache  # noqa: F401
