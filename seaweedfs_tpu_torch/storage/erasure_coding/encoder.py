"""EC encode/rebuild: volume .dat -> 14 shard files, GF math on the card,
plus the .ecx sorted index and the .vif sidecar.

Counterpart of seaweedfs_tpu/storage/erasure_coding/encoder.py, batched
route only.  Layout is WriteEcFiles': the .dat is striped row-major over 10
data shards, 1 GB x 10 rows while more than 10 GB remain, then 1 MB x 10
rows, zero-padding the tail.  Because RS parity is columnwise, each row's
column chunks batch into device dispatches (parallel/batched_encode.py).
"""

from __future__ import annotations

import json
from typing import Optional

from .. import idx as idx_mod
from ..needle_map import load_needle_map_from_idx
from . import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE

_FAMILY = "rs_vandermonde"


def write_sorted_file_from_idx(base_file_name: str):
    """Generate .ecx (ascending-id sorted copy of live .idx entries) —
    WriteSortedFileFromIdx (ec_encoder.go:27-54).  Entries whose latest
    state is a deletion are omitted (readNeedleMap drops them).  The
    compact map's vectorised bulk loader keeps this array work."""
    nm = load_needle_map_from_idx(base_file_name + ".idx", kind="compact")
    with open(base_file_name + ".ecx", "wb") as f:
        for nid, nv in nm.items_ascending():
            if nv.offset > 0 and nv.size >= 0:
                f.write(idx_mod.pack_entry(nid, nv.offset, nv.size))


def _check_family(family):
    name = getattr(family, "name", family)
    if name is not None and name != _FAMILY:
        raise NotImplementedError(
            f"code family {name!r} is not ported; only {_FAMILY!r} is")


def write_ec_files(base_file_name: str,
                   large_block_size: int = LARGE_BLOCK_SIZE,
                   small_block_size: int = SMALL_BLOCK_SIZE,
                   stage_stats: Optional[dict] = None,
                   family=None, device=None) -> list[int]:
    """Generate .ec00..ec13 from .dat on the device pipeline.  Returns the
    14 shard-file CRC32Cs.  stage_stats: see batched_encode.encode_volumes."""
    from ...parallel.batched_encode import encode_volumes

    _check_family(family)
    crcs = encode_volumes([base_file_name], large_block=large_block_size,
                          small_block=small_block_size,
                          stage_stats=stage_stats, device=device)
    return crcs[base_file_name]


def rebuild_ec_files(base_file_name: str, family=None,
                     device=None) -> dict:
    """Regenerate missing .ecNN files from survivors on the device
    pipeline.  Returns {shard_id: crc32c} of the generated shards."""
    from ...parallel.batched_encode import rebuild_shards

    _check_family(family)
    return rebuild_shards(base_file_name, device=device)


def save_volume_info(base_file_name: str, version: int,
                     extra: Optional[dict] = None):
    """Persist the .vif sidecar: JSON carrying the version field."""
    info = {"version": version}
    if extra:
        info.update(extra)
    with open(base_file_name + ".vif", "w") as f:
        json.dump(info, f)


def load_volume_info(base_file_name: str) -> Optional[dict]:
    try:
        with open(base_file_name + ".vif") as f:
            return json.load(f)
    except FileNotFoundError:
        return None
