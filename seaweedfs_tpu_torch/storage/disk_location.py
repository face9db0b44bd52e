"""DiskLocation: one storage directory with its volumes and EC shards.

Counterpart of seaweedfs_tpu/storage/disk_location.py: volume discovery
from .dat/.idx pairs, EC shard discovery from .ecx + .ecNN files, a
persisted directory UUID for duplicate-mount fencing, and free-slot
accounting.  EC volumes mount on `device` (where their degraded reads
decode), resolved when the first shard mounts.  An inline-EC volume (shard
logs as the primary write path, a `.scl` commit log beside them) mounts
as one `InlineEcVolume` on `device`, which runs its crash-recovery replay.

A volume that fails to load from disk (a truncated or unknown superblock,
a damaged `.vif`, an unknown code family, a missing file) is logged and
skipped, so one damaged volume does not stop the server from starting.
Only load errors are caught, by type: a failing CUDA call is not a
damaged volume and raises.
"""

from __future__ import annotations

import logging
import os
import re
import struct
import threading
import uuid as uuid_mod
from typing import Optional

from .erasure_coding import TOTAL_SHARDS_COUNT
from .erasure_coding.ec_volume import EcError, EcVolume, EcVolumeShard
from .needle import NeedleError
from .super_block import SuperBlockError
from .volume import Volume, VolumeError

_log = logging.getLogger(__name__)

# what a damaged or unported volume on disk raises while it loads
# (JSONDecodeError of a bad .vif is a ValueError)
_LOAD_ERRORS = (OSError, ValueError, NotImplementedError, struct.error,
                SuperBlockError, NeedleError, VolumeError, EcError)

_DAT_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.dat$")
_VIF_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.vif$")
_SHARD_RE = re.compile(
    r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.ec(?P<shard>\d{2})$")


class DiskLocation:
    def __init__(self, directory: str, max_volume_count: int = 8,
                 min_free_space_ratio: float = 0.0,
                 needle_map_kind: str = "memory", fsync: bool = False,
                 device=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.min_free_space_ratio = min_free_space_ratio
        self.needle_map_kind = needle_map_kind
        self.fsync = fsync
        self.device = device
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self.lock = threading.RLock()
        self.uuid = self._load_or_create_uuid()

    # -- uuid fencing ---------------------------------------------------------
    def _load_or_create_uuid(self) -> str:
        path = os.path.join(self.directory, "vol_dir.uuid")
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip()
        new_uuid = str(uuid_mod.uuid4())
        with open(path, "w") as f:
            f.write(new_uuid)
        return new_uuid

    # -- discovery ------------------------------------------------------------
    def load_existing_volumes(self):
        with self.lock:
            for name in sorted(os.listdir(self.directory)):
                m = _DAT_RE.match(name) or _VIF_RE.match(name)
                if not m:
                    continue
                vid = int(m.group("vid"))
                collection = m.group("collection") or ""
                if name.endswith(".vif") and not os.path.exists(
                        os.path.join(self.directory, name[:-4] + ".dat")):
                    # a .vif without a .dat is an EC sidecar, stale, or a
                    # tiered volume, which the port does not load yet
                    continue
                if vid not in self.volumes:
                    try:
                        self.volumes[vid] = Volume(
                            self.directory, collection, vid,
                            needle_map_kind=self.needle_map_kind,
                            fsync=self.fsync)
                    except _LOAD_ERRORS as e:
                        _log.warning("skipping volume %d in %s: %r", vid,
                                     self.directory, e)
            self.load_all_ec_shards()

    def load_all_ec_shards(self):
        """Discover .ecNN files and mount them."""
        with self.lock:
            found: dict[tuple[str, int], list[int]] = {}
            for name in sorted(os.listdir(self.directory)):
                m = _SHARD_RE.match(name)
                if m:
                    key = (m.group("collection") or "", int(m.group("vid")))
                    found.setdefault(key, []).append(int(m.group("shard")))
            for (collection, vid), shard_ids in found.items():
                base = self._base_name(collection, vid)
                if not os.path.exists(base + ".ecx"):
                    continue
                if vid in self.volumes:
                    continue  # a normal volume takes precedence
                if os.path.exists(base + ".scl"):
                    # inline EC volume: mounting runs the stripe-commit
                    # replay, so a crashed server comes back consistent
                    if vid in self.ec_volumes:
                        continue
                    from .erasure_coding.inline import InlineEcVolume

                    try:
                        self.ec_volumes[vid] = InlineEcVolume(
                            self.directory, collection, vid,
                            device=self.device)
                    except _LOAD_ERRORS as e:
                        _log.warning("skipping inline EC volume %d in %s: "
                                     "%r", vid, self.directory, e)
                    continue
                for shard_id in shard_ids:
                    try:
                        self.mount_ec_shard(collection, vid, shard_id)
                    except _LOAD_ERRORS as e:
                        _log.warning("skipping EC shard %d.%02d in %s: %r",
                                     vid, shard_id, self.directory, e)

    def _base_name(self, collection: str, vid: int) -> str:
        base = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(self.directory, base)

    # -- volumes --------------------------------------------------------------
    def add_volume(self, vid: int, collection: str = "",
                   replica_placement=None, ttl=None) -> Volume:
        from .super_block import ReplicaPlacement
        from .ttl import EMPTY_TTL

        with self.lock:
            if vid in self.volumes:
                raise ValueError(f"volume {vid} already exists")
            v = Volume(self.directory, collection, vid,
                       replica_placement=replica_placement
                       or ReplicaPlacement(), ttl=ttl or EMPTY_TTL,
                       needle_map_kind=self.needle_map_kind,
                       fsync=self.fsync)
            self.volumes[vid] = v
            return v

    def add_inline_volume(self, vid: int, collection: str = "",
                          family: str = None):
        """Create an inline EC volume on `device`: shard logs are the
        primary write path, no .dat ever exists
        (storage/erasure_coding/inline.py)."""
        from .erasure_coding.inline import InlineEcVolume

        with self.lock:
            if vid in self.volumes or vid in self.ec_volumes:
                raise ValueError(f"volume {vid} already exists")
            ev = InlineEcVolume(self.directory, collection, vid,
                                family=family, create=True,
                                device=self.device)
            self.ec_volumes[vid] = ev
            return ev

    def delete_volume(self, vid: int):
        with self.lock:
            v = self.volumes.pop(vid, None)
            if v is not None:
                v.destroy()

    def unload_volume(self, vid: int) -> Optional[Volume]:
        with self.lock:
            v = self.volumes.pop(vid, None)
            if v is not None:
                v.close()
            return v

    # -- EC shards ------------------------------------------------------------
    def mount_ec_shard(self, collection: str, vid: int,
                       shard_id: int) -> EcVolumeShard:
        with self.lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                ev = EcVolume(self.directory, collection, vid,
                              device=self.device)
                self.ec_volumes[vid] = ev
            shard = EcVolumeShard(self.directory, collection, vid, shard_id)
            if not ev.add_shard(shard):
                shard.close()
                raise ValueError(f"shard {vid}.{shard_id} already mounted")
            return shard

    def unmount_ec_shard(self, vid: int, shard_id: int) -> bool:
        with self.lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                return False
            shard = ev.delete_shard(shard_id)
            if shard is not None:
                shard.close()
            if not ev.shards:
                ev.close()
                del self.ec_volumes[vid]
            return shard is not None

    # -- counts ---------------------------------------------------------------
    def volume_count(self) -> int:
        with self.lock:
            return len(self.volumes)

    def ec_shard_count(self) -> int:
        with self.lock:
            return sum(len(ev.shards) for ev in self.ec_volumes.values())

    def free_slots(self) -> int:
        with self.lock:
            used = len(self.volumes) + self.ec_shard_count() / float(
                TOTAL_SHARDS_COUNT)
            return max(0, int(self.max_volume_count - used))

    def close(self):
        with self.lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
            self.volumes.clear()
            self.ec_volumes.clear()
