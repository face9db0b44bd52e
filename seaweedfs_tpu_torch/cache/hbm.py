"""HBM tier: the hottest chunks held in `DevicePool` resident slabs on the
card.

Counterpart of seaweedfs_tpu/cache/hbm.py.  Each cached chunk is one
``uint8`` tensor on the tier's device (the CUDA card unless the caller
asks for the CPU), uploaded with one host-to-device copy and held as one
resident reference in the process-wide pool: held references do not
count against ``WEED_EC_DEVICE_POOL_MB`` idle-byte eviction, so pinned
read traffic and EC scratch coexist.  The tier keeps its own LRU bounded
by ``WEED_READ_CACHE_HBM_MB``.  A hit is one device-to-host copy into a
pinned staging slab leased from the same pool, then into ``bytes``.

Every upload is keyed by the fid and a fresh generation of this tier, and
a slab whose fid is popped, invalidated or evicted leaves the pool with
its last reference.  So a later `put` of the same fid never finds the old
slab, and the pool's resident references under the tier's key prefix
equal the tier's live keys.  (The JAX package keys a slab by the fid
alone and lets a released one idle in the pool, where the next `put` of
that fid finds it: after an overwrite its tier serves the old bytes.)

A failing CUDA call raises: there is no quiet miss on the device path.
"""

from __future__ import annotations

import itertools
import threading
import warnings
from collections import OrderedDict
from typing import Optional

import torch

from .. import device as device_mod
from ..ops.device_pool import get_pool, lease_tensor

_TIER_IDS = itertools.count(1)
_STAGING_MIN = 64 << 10


class _ResidentLost(Exception):
    """The pool no longer holds the slab (a concurrent pop dropped it)."""


def _no_refill():
    raise _ResidentLost()


def _host_view(data) -> torch.Tensor:
    """A uint8 tensor over `data`'s own memory (no copy); it is only ever
    read, so a read-only buffer is fine."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8)


class HbmTier:
    def __init__(self, capacity_bytes: int, device=None):
        self.capacity = capacity_bytes
        self.device = device_mod.resolve(device)
        self._tier = next(_TIER_IDS)
        self._gen = itertools.count(1)
        # fid -> (generation, nbytes)
        self._keys: OrderedDict[str, tuple[int, int]] = OrderedDict()
        self._bytes = 0
        self.evictions = 0  # fids pushed out by the capacity
        self._lock = threading.Lock()

    @property
    def pool_prefix(self) -> tuple:
        """The leading items of every pool key this tier holds."""
        return ("read_cache", self._tier)

    def _pool_key(self, fid: str, gen: int) -> tuple:
        return ("read_cache", self._tier, fid, gen)

    def _upload(self, data, nbytes: int) -> torch.Tensor:
        host = _host_view(data)
        if self.device.type == "cpu":
            return host.clone()
        dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        dev.copy_(host)  # pageable source: returns once the copy is done
        get_pool().note_h2d(nbytes, device=self.device)
        return dev

    def put(self, fid: str, data) -> bool:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            return False
        nbytes = len(data)
        if nbytes == 0 or nbytes > self.capacity:
            return False
        with self._lock:
            if fid in self._keys:
                self._keys.move_to_end(fid)
                return True
            gen = next(self._gen)
        pool = get_pool()
        key = self._pool_key(fid, gen)
        pool.acquire_resident(key, lambda: self._upload(data, nbytes),
                              nbytes)
        evicted = []
        with self._lock:
            if fid in self._keys:  # lost the publish race: drop our slab
                self._keys.move_to_end(fid)
                evicted.append(key)
            else:
                self._keys[fid] = (gen, nbytes)
                self._bytes += nbytes
                while self._bytes > self.capacity and len(self._keys) > 1:
                    old, (ogen, n) = self._keys.popitem(last=False)
                    self._bytes -= n
                    self.evictions += 1
                    evicted.append(self._pool_key(old, ogen))
        for k in evicted:
            pool.release_resident(k, drop=True)
        return True

    def get(self, fid: str) -> Optional[bytes]:
        with self._lock:
            entry = self._keys.get(fid)
            if entry is None:
                return None
            self._keys.move_to_end(fid)
        gen, nbytes = entry
        pool = get_pool()
        key = self._pool_key(fid, gen)
        try:
            payload = pool.acquire_resident(key, _no_refill, 0)
        except _ResidentLost:
            return None
        try:
            if self.device.type == "cpu":
                return payload.numpy().tobytes()
            return self._download(pool, payload, nbytes)
        finally:
            pool.release_resident(key, drop=True)

    def _download(self, pool, payload: torch.Tensor, nbytes: int) -> bytes:
        # staging slabs come in power-of-two sizes, so chunks of nearby
        # sizes share them
        cap = max(_STAGING_MIN, 1 << (nbytes - 1).bit_length())
        ls = lease_tensor(pool, "read_cache_d2h", (cap,), torch.uint8,
                          pinned=True)
        try:
            stage = ls.payload[:nbytes]
            stage.copy_(payload, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            pool.note_d2h(nbytes, device=self.device)
            return stage.numpy().tobytes()
        finally:
            pool.release(ls)

    def pop(self, fid: str) -> bool:
        with self._lock:
            entry = self._keys.pop(fid, None)
            if entry is None:
                return False
            self._bytes -= entry[1]
        get_pool().release_resident(self._pool_key(fid, entry[0]), drop=True)
        return True

    def drop_prefix(self, prefix: str) -> int:
        with self._lock:
            stale = [(k, self._keys.pop(k)) for k in list(self._keys)
                     if k.startswith(prefix)]
            for _, (_, n) in stale:
                self._bytes -= n
        pool = get_pool()
        for k, (gen, _) in stale:
            pool.release_resident(self._pool_key(k, gen), drop=True)
        return len(stale)

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def held_bytes(self) -> int:
        """Bytes of this tier's slabs the pool holds with references."""
        return sum(n for refs, n in
                   get_pool().residents_under(self.pool_prefix).values()
                   if refs > 0)

    def clear(self):
        with self._lock:
            stale = list(self._keys.items())
            self._keys.clear()
            self._bytes = 0
        pool = get_pool()
        for k, (gen, _) in stale:
            pool.release_resident(self._pool_key(k, gen), drop=True)

    def close(self):
        self.clear()
