"""Volume tiering: move a sealed volume's .dat to a remote backend.

Parity with weed/storage/backend/s3_backend + volume_grpc_tier_upload.go /
_download.go and shell volume.tier.{upload,download,move}: the .dat bytes
live on the remote store, the .idx stays local (index lookups stay RAM/
disk-fast), reads issue ranged fetches through a block-cached TieredFile,
and the .vif sidecar records the remote location so a restarted server
re-opens the tier without the .dat present.

Backends are registered process-wide by name (the reference wires them
from master.toml [storage.backend.*]); `register_tier_backend` is called
by the volume server at startup.

The port's own copy of seaweedfs_tpu/storage/tier.py.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..remote_storage import (RemoteConf, RemoteLocation,
                              make_remote_client)
from .backend import TieredFile
from .native_engine import NativeNeedleMap
from .volume_info import RemoteFile, VolumeInfo, load_volume_info, \
    save_volume_info

_BACKENDS: dict[str, RemoteConf] = {}

UPLOAD_CHUNK = 8 << 20


def register_tier_backend(conf: RemoteConf):
    _BACKENDS[conf.name] = conf


def tier_backends() -> dict[str, RemoteConf]:
    return dict(_BACKENDS)


def _client(backend_id: str):
    conf = _BACKENDS.get(backend_id)
    if conf is None:
        raise ValueError(f"tier backend {backend_id!r} not configured")
    return make_remote_client(conf)


def _location(remote: RemoteFile) -> RemoteLocation:
    bucket, _, path = remote.key.partition("/")
    return RemoteLocation(remote.backend_id, bucket, "/" + path)


def open_tiered_dat(vif: VolumeInfo) -> Optional[TieredFile]:
    """Open the remote .dat recorded in a .vif (volume load path)."""
    if not vif.files:
        return None
    remote = vif.files[0]
    client = _client(remote.backend_id)
    loc = _location(remote)
    return TieredFile(
        lambda off, size: client.read_range(loc, off, size),
        remote.file_size, name=f"{remote.backend_id}:{remote.key}")


def tier_upload(volume, backend_id: str, bucket: str,
                keep_local: bool = False) -> RemoteFile:
    """Ship the volume's .dat to the tier; volume turns readonly and
    serves reads through ranged fetches (or the kept local copy).

    The lock is held only to seal the volume and for the final cutover —
    the volume is readonly during the transfer, so reads keep flowing
    while the bytes move."""
    conf = _BACKENDS.get(backend_id)
    if conf is None:
        raise ValueError(f"tier backend {backend_id!r} not configured")
    client = make_remote_client(conf)
    with volume.lock:
        existing = load_volume_info(volume.file_name(".vif"))
        if existing is not None and existing.files:
            raise ValueError(f"volume {volume.id} is already tiered "
                             f"to {existing.files[0].backend_id}")
        was_read_only = volume.read_only
        volume.read_only = True  # seal: the .dat can no longer change
        volume.data.sync()
        size = volume.data.size()
        data_file = volume.data
    base = os.path.basename(volume.file_name(".dat"))
    key = f"{bucket}/{base}"
    loc = RemoteLocation(backend_id, bucket, "/" + base)
    try:
        offset = 0

        def read_chunk():
            nonlocal offset
            chunk = data_file.read_at(
                min(UPLOAD_CHUNK, size - offset), offset)
            offset += len(chunk)
            return chunk

        client.write_file_from(loc, read_chunk, size)
    except Exception:
        with volume.lock:
            volume.read_only = was_read_only
        raise
    with volume.lock:
        remote = RemoteFile(
            backend_type=conf.type, backend_id=backend_id, key=key,
            file_size=size, modified_time=int(time.time()),
            extension=".dat")
        vif = VolumeInfo(
            version=volume.version,
            replica_placement=str(volume.super_block.replica_placement),
            ttl=str(volume.ttl),
            compaction_revision=volume.super_block.compaction_revision,
            files=[remote])
        save_volume_info(volume.file_name(".vif"), vif)
        if not keep_local:
            volume.data.close()
            volume.data = TieredFile(
                lambda off, sz: client.read_range(loc, off, sz),
                size, name=f"{backend_id}:{key}")
            os.remove(volume.file_name(".dat"))
        # keep_local: the sealed local .dat keeps serving reads as a cache
        return remote


def tier_download(volume) -> int:
    """Bring the .dat back local; volume becomes writable again."""
    from .backend import DiskFile, TieredFile as _TieredFile

    vif = load_volume_info(volume.file_name(".vif"))
    if vif is None or not vif.files:
        raise ValueError(f"volume {volume.id} has no tiered files")
    remote = vif.files[0]
    client = _client(remote.backend_id)
    loc = _location(remote)
    dat_path = volume.file_name(".dat")
    if not os.path.exists(dat_path):
        # fetch outside the lock: the tiered volume is readonly so the
        # remote object is stable
        tmp = dat_path + ".tierdl"
        with open(tmp, "wb") as f:
            offset = 0
            while offset < remote.file_size:
                chunk = client.read_range(
                    loc, offset,
                    min(UPLOAD_CHUNK, remote.file_size - offset))
                if not chunk:
                    raise OSError(
                        f"short tier read at {offset} from {remote.key}")
                f.write(chunk)
                offset += len(chunk)
        os.replace(tmp, dat_path)
    # else: keep_local cache IS current (volume was sealed readonly)
    with volume.lock:
        if isinstance(volume.data, _TieredFile):
            volume.data.close()
            volume.data = DiskFile(dat_path)
            if isinstance(volume.nm, NativeNeedleMap):
                # the engine still appends to the .dat it was registered
                # with, which the upload unlinked: register the
                # downloaded file (the JAX package keeps the old one, so
                # its writes after a download cannot be read back)
                volume.nm.close()
                volume.nm = volume._new_needle_map(
                    dat_path, volume.file_name(".idx"), None)
        volume.read_only = False
        vif.files = []
        save_volume_info(volume.file_name(".vif"), vif)
    client.delete_file(loc)
    return remote.file_size
