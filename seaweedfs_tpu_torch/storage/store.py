"""Store: the volume server's registry of disk locations and volumes.

Counterpart of seaweedfs_tpu/storage/store.py: owns the DiskLocations,
routes reads, writes and deletes to volumes, runs the EC admin entry
points (`ec_generate`, `ec_generate_batch`, `ec_rebuild`, mount and
unmount), and assembles heartbeat payloads.  Under WEED_EC_INLINE=1 an
EC-policy collection's new volume is an inline-EC volume
(storage/erasure_coding/inline.py): its needles stream straight into
shard logs, it reports as a writable volume, and parity follows per
stripe row.

`device` is where the store's EC work runs: the CUDA card unless the
caller passes device="cpu".  It is resolved where EC work happens (an
encode, a rebuild, a mounted EC volume), so a store of plain volumes opens
without a card, and its EC entry points raise without one.

`ec_encoder_backend` is the `-ec.backend` setting:

  "cuda", "tpu"   force the batched device pipeline ("tpu" is the JAX
                  package's name, so one configuration drives either)
  a codec name    ("cpu", "numpy", "torch", "jax", "auto") the host loop
                  with that codec, through ops.codec.new_encoder on the
                  store's device ("jax" is the device codec there)
  None            auto-select through util/platform.prefer_batched_encode
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

from ..stats import metrics as _stats
from .disk_location import DiskLocation
from .erasure_coding import encoder as ec_encoder
from .erasure_coding.ec_volume import EcVolume
from .erasure_coding.inline import inline_family_for
from .needle import Needle
from .super_block import ReplicaPlacement
from .ttl import TTL
from .volume import NotFoundError, Volume, VolumeError

_DEVICE_BACKENDS = ("cuda", "tpu")

_log = logging.getLogger(__name__)


class Store:
    def __init__(self, directories: list[str],
                 max_volume_counts: Optional[list[int]] = None,
                 ip: str = "127.0.0.1", port: int = 0,
                 public_url: str = "", data_center: str = "",
                 rack: str = "", ec_encoder_backend=None,
                 needle_map_kind: str = "memory", fsync: bool = False,
                 device=None):
        counts = max_volume_counts or [8] * len(directories)
        self.device = device
        self.locations = [DiskLocation(d, c,
                                       needle_map_kind=needle_map_kind,
                                       fsync=fsync, device=device)
                          for d, c in zip(directories, counts)]
        for loc in self.locations:
            loc.load_existing_volumes()
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.data_center = data_center
        self.rack = rack
        # the master's soft volume size cap, refreshed from each heartbeat
        # response; the master, not the store, stops assigning to
        # oversized volumes
        self.volume_size_limit = 0
        self.lock = threading.RLock()
        self.ec_encoder_backend = ec_encoder_backend
        # called with the vid after a disk-failure read-only demotion, so
        # the owning daemon can push a heartbeat at once
        self.on_demote: Optional[Callable[[int], None]] = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    # -- lookup ---------------------------------------------------------------
    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def location_of(self, vid: int) -> Optional[DiskLocation]:
        for loc in self.locations:
            if vid in loc.volumes or vid in loc.ec_volumes:
                return loc
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    # -- volume admin ---------------------------------------------------------
    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "000", ttl: str = ""):
        with self.lock:
            if self.find_volume(vid) is not None \
                    or self.find_ec_volume(vid) is not None:
                raise VolumeError(f"volume {vid} already exists")
            loc = max(self.locations, key=lambda l: l.free_slots())
            if loc.free_slots() <= 0:
                raise VolumeError("no free volume slots")
            # assign-time policy: an EC-policy collection under
            # WEED_EC_INLINE=1 gets shard logs as its primary write path
            family = inline_family_for(collection)
            if family is not None:
                return loc.add_inline_volume(vid, collection, family=family)
            return loc.add_volume(
                vid, collection,
                replica_placement=ReplicaPlacement.parse(replication),
                ttl=TTL.parse(ttl))

    def delete_volume(self, vid: int):
        with self.lock:
            for loc in self.locations:
                if vid in loc.volumes:
                    loc.delete_volume(vid)
                    return
                ev = loc.ec_volumes.get(vid)
                if ev is not None and getattr(ev, "writer", None):
                    loc.ec_volumes.pop(vid)
                    ev.destroy()
                    return
            raise NotFoundError(f"volume {vid} not found")

    def mark_volume_readonly(self, vid: int, read_only: bool = True):
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        v.read_only = read_only

    # -- data path ------------------------------------------------------------
    def write_needle(self, vid: int, n: Needle,
                     check_cookie: bool = True) -> tuple[int, bool]:
        v = self.find_volume(vid)
        if v is None:
            ev = self.find_ec_volume(vid)
            if ev is not None and getattr(ev, "writer", None):
                # inline EC volume: the needle streams straight into the
                # striped shard logs, parity follows per stripe
                _, size, unchanged = ev.write_needle(
                    n, check_cookie=check_cookie)
                return size, unchanged
            raise NotFoundError(f"volume {vid} not found")
        try:
            _, size, unchanged = v.write_needle(n, check_cookie=check_cookie)
        except OSError as e:
            # a failing disk write demotes the volume to read-only on the
            # spot: reads still serve, the next heartbeat reports it
            self._demote_readonly(vid, v, e)
            raise VolumeError(
                f"volume {vid} demoted read-only: "
                f"disk write failed: {e}") from e
        return size, unchanged

    def _demote_readonly(self, vid: int, v: Volume, err: Exception):
        v.read_only = True
        _stats.VolumeReadonlyDemotions.inc()
        _log.error("volume %d demoted read-only after disk error: %s",
                   vid, err)
        if self.on_demote is not None:
            # the heartbeat push is best-effort: the caller gets the
            # write's VolumeError whatever the hook does
            try:
                self.on_demote(vid)
            except Exception:
                _log.exception("on_demote hook failed for volume %d", vid)

    def read_needle(self, vid: int, nid: int,
                    cookie: Optional[int] = None) -> Needle:
        v = self.find_volume(vid)
        if v is not None:
            return v.read_needle(nid, cookie=cookie)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return ev.read_needle(nid, cookie=cookie)
        raise NotFoundError(f"volume {vid} not found")

    def delete_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is not None:
            return v.delete_needle(n)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            ev.delete_needle(n.id)
            return 0
        raise NotFoundError(f"volume {vid} not found")

    # -- EC admin -------------------------------------------------------------
    def _forced_device(self) -> bool:
        return self.ec_encoder_backend in _DEVICE_BACKENDS

    def _resolve_ec_encoder(self):
        """-ec.backend: None or a device backend select the batched device
        pipeline (encoder=None downstream); a codec name resolves to that
        host codec; an encoder object passes through."""
        backend = self.ec_encoder_backend
        if backend is None or backend in _DEVICE_BACKENDS:
            return None
        if isinstance(backend, str):
            from ..ops import codec
            from .erasure_coding import (DATA_SHARDS_COUNT,
                                         PARITY_SHARDS_COUNT)

            return codec.new_encoder(DATA_SHARDS_COUNT,
                                     PARITY_SHARDS_COUNT, backend=backend,
                                     device=self.device)
        return backend

    def ec_generate(self, vid: int, encoder=None, code_family: str = None,
                    stage_stats: Optional[dict] = None):
        """VolumeEcShardsGenerate: encode a local volume into shard files,
        write its .ecx, and record the shard-file CRC32Cs (from the
        batched and host pipelines) and the code family in its .vif.

        code_family: None resolves the per-collection policy
        (codes.family_for_collection); a family of RS's geometry (cauchy)
        takes the same pipelines with its parity rows, any other encodes
        through its host loop (encoder._write_ec_files_family)."""
        from .erasure_coding import codes as ec_codes

        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        family = code_family or ec_codes.family_for_collection(v.collection)
        base = v.file_name()
        v.sync()
        forced = True if (encoder is None and self._forced_device()) \
            else None
        crcs = ec_encoder.write_ec_files(
            base, family=family, device=self.device,
            encoder=encoder or self._resolve_ec_encoder(), batched=forced,
            stage_stats=stage_stats)
        ec_encoder.write_sorted_file_from_idx(base)
        extra = {"code_family": family}
        if crcs:
            extra["shard_crc32c"] = [int(c) for c in crcs]
        ec_encoder.save_volume_info(base, version=v.version, extra=extra)

    def ec_generate_batch(self, vids: list[int],
                          stage_stats: Optional[dict] = None):
        """Batched VolumeEcShardsGenerate: encode many local volumes in one
        device pipeline, their row chunks sharing dispatches.  Taken when
        the backend forces the device or the auto-selection predicts the
        device pipeline wins; otherwise each volume encodes on its own."""
        from ..util.platform import prefer_batched_encode
        from .erasure_coding import codes as ec_codes

        use_batched = self._forced_device() or (
            self.ec_encoder_backend is None
            and prefer_batched_encode(self.device))
        if not use_batched:
            enc = self._resolve_ec_encoder()  # resolve the codec once
            for vid in vids:
                self.ec_generate(vid, encoder=enc)
            return
        from ..parallel.batched_encode import encode_volumes

        vols = []
        for vid in vids:
            v = self.find_volume(vid)
            if v is None:
                raise NotFoundError(f"volume {vid} not found")
            # the shared pipeline speaks the RS layout; another family's
            # collection encodes on its own, through the family host loop
            if (ec_codes.family_for_collection(v.collection)
                    != ec_codes.DEFAULT_FAMILY):
                self.ec_generate(vid)
                continue
            v.sync()
            vols.append(v)
        if not vols:
            return
        crc_map = encode_volumes([v.file_name() for v in vols],
                                 stage_stats=stage_stats, device=self.device)
        for v in vols:
            base = v.file_name()
            ec_encoder.write_sorted_file_from_idx(base)
            ec_encoder.save_volume_info(
                base, version=v.version,
                extra={"shard_crc32c": [int(c) for c in crc_map[base]],
                       "code_family": ec_codes.DEFAULT_FAMILY})

    def ec_rebuild(self, vid: int, collection: str = "") -> list[int]:
        """VolumeEcShardsRebuild: regenerate missing local shard files.

        When the rebuild returns CRCs and the .vif records the original
        shard CRCs, the rebuilt values are verified against the record: a
        correct rebuild reproduces the original bytes, so a mismatch means
        a survivor is silently corrupt, and it raises VolumeError rather
        than laundering the bytes into the volume.  The survivor bytes
        read per rebuilt byte go to codes.note_rebuild."""
        from .erasure_coding import TOTAL_SHARDS_COUNT, to_ext
        from .erasure_coding import codes as ec_codes

        loc = self.location_of(vid)
        base = (loc._base_name(collection, vid) if loc
                else self.locations[0]._base_name(collection, vid))
        info = ec_encoder.load_volume_info(base) or {}
        family = info.get("code_family") or ec_codes.DEFAULT_FAMILY
        if family != ec_codes.DEFAULT_FAMILY:
            # the family's planned rebuild counts what it reads
            rb_stats: dict = {}
            crcs = ec_encoder.rebuild_ec_files(base, family=family,
                                               device=self.device,
                                               stats=rb_stats)
            if rb_stats.get("rebuilt_bytes"):
                ec_codes.note_rebuild(family, rb_stats["read_bytes"],
                                      rb_stats["rebuilt_bytes"])
        else:
            # the RS rebuild reads every present survivor in full
            present_bytes = sum(
                os.path.getsize(base + to_ext(i))
                for i in range(TOTAL_SHARDS_COUNT)
                if os.path.exists(base + to_ext(i)))
            crcs = ec_encoder.rebuild_ec_files(
                base, device=self.device,
                encoder=self._resolve_ec_encoder(),
                batched=True if self._forced_device() else None)
            rebuilt_bytes = sum(
                os.path.getsize(base + to_ext(sid)) for sid in crcs
                if os.path.exists(base + to_ext(sid)))
            if crcs and rebuilt_bytes:
                ec_codes.note_rebuild(family, present_bytes, rebuilt_bytes)
        stored = info.get("shard_crc32c")
        if isinstance(stored, list) and len(stored) == TOTAL_SHARDS_COUNT:
            bad = [sid for sid, crc in crcs.items()
                   if crc is not None and crc != stored[sid]]
            if bad:
                raise VolumeError(
                    f"rebuilt shards {bad} of volume {vid} do not match "
                    "the recorded CRCs: a survivor shard is corrupt")
        return sorted(crcs)

    def ec_mount(self, collection: str, vid: int, shard_ids: list[int]):
        loc = self.location_of(vid) or self.locations[0]
        for sid in shard_ids:
            loc.mount_ec_shard(collection, vid, sid)

    def ec_unmount(self, vid: int, shard_ids: list[int]):
        for loc in self.locations:
            if vid in loc.ec_volumes:
                for sid in shard_ids:
                    loc.unmount_ec_shard(vid, sid)
                return

    # -- heartbeat ------------------------------------------------------------
    def collect_heartbeat(self) -> dict:
        volumes = []
        ec_shards = []
        max_file_key = 0
        max_volume_count = 0
        for loc in self.locations:
            max_volume_count += loc.max_volume_count
            with loc.lock:
                for vid, v in loc.volumes.items():
                    max_file_key = max(max_file_key, v.max_file_key())
                    dat_size, _ = v.file_stat()
                    volumes.append({
                        "id": vid,
                        "collection": v.collection,
                        "size": dat_size,
                        "file_count": v.file_count(),
                        "delete_count": v.deleted_count(),
                        "deleted_byte_count": v.deleted_size(),
                        "read_only": v.read_only,
                        "replica_placement":
                            v.super_block.replica_placement.to_byte(),
                        "ttl": v.ttl.to_uint32(),
                        "compact_revision":
                            v.super_block.compaction_revision,
                        "modified_at_second": int(v.last_modified_ts),
                    })
                for vid, ev in loc.ec_volumes.items():
                    if getattr(ev, "writer", None):
                        # inline EC volume: a WRITABLE volume to the
                        # master, which keeps assigning fids to it; parity
                        # is current, there is nothing to seal or encode
                        max_file_key = max(max_file_key, ev.max_file_key())
                        volumes.append({
                            "id": vid,
                            "collection": ev.collection,
                            "size": ev.writer.logical_size,
                            "file_count": ev.file_count(),
                            "delete_count": ev.deleted_count(),
                            "deleted_byte_count": ev.deleted_size(),
                            "read_only": ev.read_only,
                            "replica_placement": 0,
                            "ttl": 0,
                            "compact_revision": 0,
                            "modified_at_second": int(ev.last_modified_ts),
                        })
                        continue
                    ec_shards.append({
                        "id": vid,
                        "collection": ev.collection,
                        "ec_index_bits": ev.shard_bits().bits,
                    })
        return {
            "ip": self.ip,
            "port": self.port,
            "public_url": self.public_url,
            "data_center": self.data_center,
            "rack": self.rack,
            "max_volume_count": max_volume_count,
            "max_file_key": max_file_key,
            "volumes": volumes,
            "ec_shards": ec_shards,
        }

    def status(self) -> dict:
        hb = self.collect_heartbeat()
        hb["free_slots"] = sum(l.free_slots() for l in self.locations)
        hb["volume_size_limit"] = self.volume_size_limit
        return hb

    def close(self):
        for loc in self.locations:
            loc.close()
