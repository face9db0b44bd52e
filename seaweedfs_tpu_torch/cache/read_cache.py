"""The unified tiered read-through cache (HBM -> host RAM -> disk).

Counterpart of seaweedfs_tpu/cache/read_cache.py.  `TieredReadCache` merges the historical `util/chunk_cache.py`
TieredChunkCache (RAM LRU + size-classed disk rings) and the filer's
private reader `ChunkCache` (RAM-only LRU) into one object shared by
every GET path.  Semantics preserved from both ancestors:

  * with disk layers: small chunks (<= unit_size) live in RAM AND the
    small disk layer; medium/large chunks go to their own disk layers
    only (chunk_cache.go routing);
  * without disk layers: everything lives in RAM under the byte budget
    (reader_cache.go behaviour — important because default filer chunks
    are 4 MiB, above the small-class limit).

New here: an optional HBM tier fed by promotion (a chunk that keeps
hitting in RAM gets pinned in a `DevicePool` resident slab on the card,
or on the CPU when the cache was asked for device="cpu"), QoS-aware
admission (background traffic bypasses the fill path), explicit
invalidation (`invalidate` / `invalidate_volume`) wired to the
delete/vacuum/rebuild paths, and per-tier hit/fill accounting exported
through the metrics registry.  With no HBM budget
(``WEED_READ_CACHE_HBM_MB`` unset or 0) the cache touches no device.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from .. import qos
from ..stats import metrics as stats
from ..stats.sketch import SpaceSaving
from .disk import OnDiskCacheLayer
from .hbm import HbmTier
from .ram import RamCache

# RAM hits before a chunk is considered hot enough to pin in HBM
_PROMOTE_AFTER = 2
# hard ceiling on promotion-heat counters regardless of knobs
_HEAT_MAX = 65536


def _heat_capacity() -> int:
    """Promotion heat is a Space-Saving sketch bounded by the same
    WEED_HEAT_MAX_KEYS knob as the access recorder: under pressure it
    evicts the *coldest* counter instead of (as the old dict did)
    dropping every fid's accumulated heat at once."""
    try:
        knob = int(os.environ.get("WEED_HEAT_MAX_KEYS", "") or 4096)
    except ValueError:
        knob = 4096
    return max(16, min(_HEAT_MAX, knob))


def _heat_epoch_s() -> float:
    try:
        return max(0.25, float(
            os.environ.get("WEED_HEAT_EPOCH_S", "") or 60.0))
    except ValueError:
        return 60.0


def _heat_decay() -> float:
    try:
        return min(1.0, max(0.0, float(
            os.environ.get("WEED_HEAT_DECAY", "") or 0.5)))
    except ValueError:
        return 0.5


def _env_mb(name: str, default_mb: int) -> int:
    raw = os.environ.get(name, "")
    if raw:
        try:
            return int(float(raw) * (1 << 20))
        except ValueError:
            pass
    return default_mb << 20


def default_mem_bytes() -> int:
    return _env_mb("WEED_READ_CACHE_MB", 64)


def default_disk_bytes() -> int:
    return _env_mb("WEED_READ_CACHE_DISK_MB", 1024)


def default_hbm_bytes() -> int:
    return _env_mb("WEED_READ_CACHE_HBM_MB", 0)


def background_fills() -> bool:
    """Whether background-class traffic may fill the cache (off by
    default so scrub/rebuild sweeps cannot wash out interactive heat)."""
    return os.environ.get("WEED_READ_CACHE_BG_FILL", "0") == "1"


class TieredReadCache:
    """HBM -> RAM -> disk read-through cache with QoS-aware admission."""

    def __init__(self, mem_bytes: Optional[int] = None, directory: str = "",
                 disk_bytes: Optional[int] = None, unit_size: int = 1 << 20,
                 hbm_bytes: Optional[int] = None, device=None):
        if mem_bytes is None:
            mem_bytes = default_mem_bytes()
        if disk_bytes is None:
            disk_bytes = default_disk_bytes()
        if hbm_bytes is None:
            hbm_bytes = default_hbm_bytes()
        self.limit0 = unit_size          # small
        self.limit1 = 4 * unit_size      # medium
        self.mem = RamCache(mem_bytes)
        self.layers: list[OnDiskCacheLayer] = []
        if directory:
            os.makedirs(directory, exist_ok=True)
            # same 1/8 : 3/8 : 1/2 split and segment counts as the reference
            self.layers = [
                OnDiskCacheLayer(directory, "c0_2", disk_bytes // 8, 2),
                OnDiskCacheLayer(directory, "c1_3", disk_bytes * 3 // 8, 3),
                OnDiskCacheLayer(directory, "c2_2", disk_bytes // 2, 2),
            ]
        self.hbm: Optional[HbmTier] = (
            HbmTier(hbm_bytes, device=device) if hbm_bytes > 0 else None)
        # layers lock themselves; this guards counters + the heat sketch
        self._stat_lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.tier_hits = {"hbm": 0, "ram": 0, "disk": 0}
        self.fills = {"admitted": 0, "qos_bypass": 0}
        self._heat = SpaceSaving(_heat_capacity())
        self._heat_epoch = time.monotonic()

    # -- accounting ----------------------------------------------------

    def _count_hit(self, tier: str):
        with self._stat_lock:
            self.hits += 1
            self.tier_hits[tier] += 1
        stats.ReadCacheRequestsCounter.inc(labels=(tier,))

    def _count_miss(self):
        with self._stat_lock:
            self.misses += 1
        stats.ReadCacheRequestsCounter.inc(labels=("miss",))

    def _publish_resident(self):
        stats.ReadCacheResidentBytesGauge.labels("ram").set(
            self.mem.size_bytes)
        if self.layers:
            stats.ReadCacheResidentBytesGauge.labels("disk").set(
                sum(layer.size_bytes for layer in self.layers))
        if self.hbm is not None:
            stats.ReadCacheResidentBytesGauge.labels("hbm").set(
                self.hbm.size_bytes)

    def stats_snapshot(self) -> dict:
        with self._stat_lock:
            snap = {
                "hits": self.hits,
                "misses": self.misses,
                "tier_hits": dict(self.tier_hits),
                "fills": dict(self.fills),
            }
        lookups = snap["hits"] + snap["misses"]
        snap["hit_ratio"] = snap["hits"] / lookups if lookups else 0.0
        snap["resident_bytes"] = {"ram": self.mem.size_bytes}
        if self.layers:
            snap["resident_bytes"]["disk"] = sum(
                layer.size_bytes for layer in self.layers)
        if self.hbm is not None:
            snap["resident_bytes"]["hbm"] = self.hbm.size_bytes
        return snap

    # -- promotion -----------------------------------------------------

    def _note_ram_hit(self, fid: str, data: Any):
        if self.hbm is None:
            return
        with self._stat_lock:
            # epoch-windowed exponential decay: heat from the last
            # epoch counts at WEED_HEAT_DECAY weight, so yesterday's
            # hot chunk must re-earn its HBM slot
            now = time.monotonic()
            epoch = _heat_epoch_s()
            elapsed = now - self._heat_epoch
            if elapsed >= epoch:
                self._heat.scale(_heat_decay() ** int(elapsed // epoch))
                self._heat_epoch = now
            self._heat.offer(fid)
            if self._heat.estimate(fid) < _PROMOTE_AFTER:
                return
            # promoted: retire its counter so steady hitters don't
            # re-put into HBM on every RAM hit
            self._heat.counts.pop(fid, None)
        self.hbm.put(fid, data)

    # -- the read-through interface ------------------------------------

    def get(self, fid: str) -> Optional[Any]:
        data = self.mem.get(fid)
        if data is not None:
            self._count_hit("ram")
            self._note_ram_hit(fid, data)
            return data
        if self.hbm is not None:
            data = self.hbm.get(fid)
            if data is not None:
                # re-warm RAM so the next hit is a host-memory hit
                self.mem.put(fid, data)
                self._count_hit("hbm")
                return data
        for layer in self.layers:
            data = layer.get(fid)
            if data is not None:
                self._count_hit("disk")
                return data
        self._count_miss()
        return None

    def get_slice(self, fid: str) -> Optional[tuple]:
        """Zero-copy variant for the sendfile reply path: a (dup'd fd,
        offset, length) triple when the fid sits in a DISK layer, else
        None.  RAM/HBM tiers have no backing fd and stay on the
        in-memory reply path, which is already faster for them."""
        if not self.layers:
            return None
        if self.mem.get(fid) is not None or (
                self.hbm is not None and self.hbm.get(fid) is not None):
            return None
        for layer in self.layers:
            s = layer.get_slice(fid)
            if s is not None:
                self._count_hit("disk")
                return s
        return None

    def put(self, fid: str, data: Any, nbytes: Optional[int] = None):
        if qos.enabled() and qos.current_class() == qos.BACKGROUND \
                and not background_fills():
            with self._stat_lock:
                self.fills["qos_bypass"] += 1
            stats.ReadCacheFillCounter.inc(labels=("qos_bypass",))
            return
        with self._stat_lock:
            self.fills["admitted"] += 1
        stats.ReadCacheFillCounter.inc(labels=("admitted",))
        n = len(data) if nbytes is None else nbytes
        if not self.layers:
            self.mem.put(fid, data, nbytes=n)
            self._publish_resident()
            return
        if n <= self.limit0:
            self.mem.put(fid, data, nbytes=n)
            layer = self.layers[0]
        elif n <= self.limit1:
            layer = self.layers[1]
        else:
            layer = self.layers[2]
        if isinstance(data, (bytes, bytearray, memoryview)):
            layer.put(fid, data)
        self._publish_resident()

    # -- invalidation --------------------------------------------------

    def invalidate(self, fid: str, reason: str = "delete") -> bool:
        dropped = self.mem.pop(fid)
        if self.hbm is not None:
            dropped = self.hbm.pop(fid) or dropped
        for layer in self.layers:
            dropped = layer.invalidate(fid) or dropped
        with self._stat_lock:
            self._heat.counts.pop(fid, None)
        if dropped:
            stats.ReadCacheInvalidationsCounter.inc(labels=(reason,))
            self._publish_resident()
        return dropped

    def invalidate_volume(self, vid: int, reason: str = "vacuum") -> int:
        """Drop every cached entry belonging to volume `vid` (fids are
        canonically ``"<vid>,<needle-hex>"``)."""
        prefix = f"{vid},"
        dropped = self.mem.drop_prefix(prefix)
        if self.hbm is not None:
            dropped += self.hbm.drop_prefix(prefix)
        for layer in self.layers:
            dropped += layer.drop_prefix(prefix)
        with self._stat_lock:
            for k in [k for k in self._heat.counts if k.startswith(prefix)]:
                del self._heat.counts[k]
        if dropped:
            stats.ReadCacheInvalidationsCounter.inc(dropped, labels=(reason,))
            self._publish_resident()
        return dropped

    # -- housekeeping --------------------------------------------------

    def clear(self):
        self.mem.clear()
        if self.hbm is not None:
            self.hbm.clear()
        for layer in self.layers:
            layer.clear()
        with self._stat_lock:
            self._heat = SpaceSaving(self._heat.capacity)
        self._publish_resident()

    def __len__(self) -> int:
        return len(self.mem)

    @property
    def capacity(self) -> int:
        return self.mem.capacity

    @property
    def size_bytes(self) -> int:
        return self.mem.size_bytes

    def close(self):
        if self.hbm is not None:
            self.hbm.close()
        for layer in self.layers:
            layer.close()


class ChunkCache(TieredReadCache):
    """RAM-only unified cache keeping `filer/reader_cache.py`'s public
    interface (``ChunkCache(capacity_bytes)``)."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        super().__init__(mem_bytes=capacity_bytes)
