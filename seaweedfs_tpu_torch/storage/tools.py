"""Offline volume tooling: index repair, export, offline compaction.

Parity with the reference's maintenance commands that operate on volume
files directly, without a running server: `weed fix` (rebuild .idx by
scanning the .dat; command/fix.go), `weed export` (dump live needles to
a tar; command/export.go), `weed compact` (offline vacuum;
command/compact.go), and `weed backup`'s local volume copy
(command/backup.go).

Counterpart of seaweedfs_tpu/storage/tools.py.  `scrub_ec_volume` rebuilds
on `device` (the CUDA card unless the caller passes device="cpu").
"""

from __future__ import annotations

import io
import os
import tarfile
import time
from typing import Callable, Optional

from . import types as t
from .backend import DiskFile
from .needle import get_actual_size, read_needle_header
from .needle_map import NeedleMap
from .super_block import SuperBlock


def _base(directory: str, collection: str, vid: int) -> str:
    name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(directory, name)


def scan_dat(dat_path: str):
    """Yield (needle, offset) for every record in a .dat, without
    loading an index (the `weed fix`/`weed export` walk)."""
    data = DiskFile(dat_path)
    try:
        with open(dat_path, "rb") as f:
            sb = SuperBlock.from_file(f)
        pos = sb.block_size
        end = data.size()
        while pos < end:
            header = data.read_at(t.NEEDLE_HEADER_SIZE, pos)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                break
            n, _ = read_needle_header(header)
            body_len = (get_actual_size(n.size, sb.version)
                        - t.NEEDLE_HEADER_SIZE)
            body = data.read_at(body_len, pos + t.NEEDLE_HEADER_SIZE)
            n.read_needle_body(body, sb.version)
            yield n, pos
            pos += t.NEEDLE_HEADER_SIZE + body_len
    finally:
        data.close()


def rebuild_index(directory: str, collection: str, vid: int) -> int:
    """`weed fix`: reconstruct the .idx from the .dat append log.  A
    record with data is a put; a zero-size record is a tombstone."""
    base = _base(directory, collection, vid)
    dat, idx = base + ".dat", base + ".idx"
    tmp = idx + ".rebuild"
    if os.path.exists(tmp):
        os.remove(tmp)
    nm = NeedleMap(tmp)
    count = 0
    for n, offset in scan_dat(dat):
        if n.size > 0 and n.data:
            nm.put(n.id, offset, n.size)
        else:
            nm.delete(n.id, offset)
        count += 1
    nm.close()
    os.replace(tmp, idx)
    return count


def export_volume(directory: str, collection: str, vid: int,
                  output_tar: str = "",
                  newer_than_ts: float = 0.0,
                  include_deleted: bool = False) -> list[dict]:
    """`weed export`: list (and optionally tar) the live needles."""
    base = _base(directory, collection, vid)
    live: dict[int, tuple] = {}
    for n, offset in scan_dat(base + ".dat"):
        if n.size > 0 and n.data:
            live[n.id] = (n, offset)
        elif not include_deleted:
            live.pop(n.id, None)
    records = []
    tar = tarfile.open(output_tar, "w") if output_tar else None
    try:
        for nid, (n, offset) in sorted(live.items()):
            last_modified = getattr(n, "last_modified", 0)
            if newer_than_ts and last_modified \
                    and last_modified < newer_than_ts:
                continue
            name = (n.name.decode(errors="replace")
                    if getattr(n, "has_name", False) and n.name
                    else f"{vid}_{nid}")
            records.append({"id": nid, "name": name,
                            "size": len(n.data), "offset": offset})
            if tar is not None:
                info = tarfile.TarInfo(name=name)
                info.size = len(n.data)
                info.mtime = last_modified or int(time.time())
                tar.addfile(info, io.BytesIO(n.data))
    finally:
        if tar is not None:
            tar.close()
    return records


def compact_offline(directory: str, collection: str, vid: int) -> dict:
    """`weed compact`: run the copy-live-data vacuum on an offline
    volume directory."""
    from .volume import Volume

    v = Volume(directory, collection, vid)
    try:
        before = v.data.size()
        v.compact()
        v.commit_compact()
        after = v.data.size()
    finally:
        v.close()
    return {"volume": vid, "before_bytes": before, "after_bytes": after,
            "reclaimed": before - after}


def shard_file_crc32c(path: str, chunk_size: int = 4 << 20,
                      throttle: Optional[Callable[[int], None]] = None
                      ) -> int:
    """Whole-file CRC32C, streamed in bounded chunks.  `throttle` is
    called with each chunk's byte count *before* the bytes are hashed —
    the curator's BytePacer plugs in here so a background scrub never
    streams a shard file faster than the paced rate (an unthrottled
    whole-file read stalls foreground I/O on the same spindle)."""
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
    -> (clean, corrupt, absent) shard-id lists.  Shared by the offline
    `weed scrub` and the volume server's /admin/ec/scrub handler (where
    'absent' just means not held locally).  Raises ValueError when the
    .vif carries no CRC record."""
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


def scrub_ec_volume(directory: str, collection: str, vid: int,
                    repair: bool = False, device=None) -> dict:
    """Verify every local .ecNN against the CRC32Cs the batched encode
    fused on device and persisted in the .vif sidecar (no reference
    analogue — the reference has no stored shard checksums to scrub
    against).  With repair=True, corrupt/missing shards are deleted and
    regenerated from survivors via the batched rebuild pipeline.

    Returns {"checked": [...], "corrupt": [...], "missing": [...],
    "repaired": [...]}."""
    from .erasure_coding import to_ext
    from .erasure_coding.encoder import load_volume_info

    base = _base(directory, collection, vid)
    info = load_volume_info(base) or {}
    stored = info.get("shard_crc32c")
    checked, corrupt, missing = verify_shard_files(base, stored)
    repaired: list[int] = []
    if repair and (corrupt or missing):
        from .erasure_coding.codes import get_family
        from .erasure_coding.encoder import rebuild_ec_files

        # clean-survivor bound is the volume's code family's data_shards
        # (10 for RS/Cauchy, 5 for pm_msr), recorded in the .vif
        family = get_family(info.get("code_family"))
        if len(checked) < family.data_shards:
            raise ValueError(
                f"only {len(checked)} clean shards — cannot rebuild "
                f"{sorted(corrupt + missing)}; corrupt files left in place")
        # move corrupt shards ASIDE (never destroy potentially-useful
        # bytes before the rebuild is known to succeed)
        for sid in corrupt:
            os.replace(base + to_ext(sid), base + to_ext(sid) + ".corrupt")
        try:
            if family.name != "rs_vandermonde":
                crcs = rebuild_ec_files(base, family=family, device=device)
            else:
                # the route write_ec_files would take on this device
                crcs = rebuild_ec_files(base, device=device)
        except Exception:
            for sid in corrupt:  # restore the evidence
                os.replace(base + to_ext(sid) + ".corrupt",
                           base + to_ext(sid))
            raise
        # verify EVERY rebuilt shard against the record; host-path
        # rebuilds (crc None) hash the produced file
        bad = []
        for sid, crc in crcs.items():
            if crc is None:
                crc = shard_file_crc32c(base + to_ext(sid))
            if crc != stored[sid]:
                bad.append(sid)
        if bad:
            for sid in corrupt:
                os.replace(base + to_ext(sid) + ".corrupt",
                           base + to_ext(sid))
            raise ValueError(
                f"rebuilt shards {bad} still mismatch the recorded CRCs "
                "— survivors are corrupt beyond the stored checksums")
        for sid in corrupt:
            os.remove(base + to_ext(sid) + ".corrupt")
        repaired = sorted(crcs)
    return {"checked": checked, "corrupt": corrupt,
            "missing": missing, "repaired": repaired}
