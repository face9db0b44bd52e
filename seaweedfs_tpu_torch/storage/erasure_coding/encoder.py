"""EC encode/rebuild: volume .dat -> 14 shard files, plus the .ecx sorted
index and the .vif sidecar.

Counterpart of seaweedfs_tpu/storage/erasure_coding/encoder.py.  Layout is
WriteEcFiles': the .dat is striped row-major over 10 data shards, 1 GB x
10 rows while more than 10 GB remain, then 1 MB x 10 rows, zero-padding
the tail.  Because RS parity is columnwise, each row's column chunks batch
into device dispatches (parallel/batched_encode.py).  Three routes:

  batched device pipeline  the default when the link can carry it
                           (util/platform.prefer_batched_encode), or
                           batched=True (-ec.backend=cuda);
  host pipeline            the auto-selected route on a link-capped
                           machine (encode_volumes(host_codec=True));
  host loop                an explicit `encoder` or batched=False: the
                           reference's synchronous per-row loop.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ...ops import codec as codec_mod
from .. import idx as idx_mod
from ..needle_map import load_needle_map_from_idx
from . import (DATA_SHARDS_COUNT, LARGE_BLOCK_SIZE, PARITY_SHARDS_COUNT,
               SMALL_BLOCK_SIZE, TOTAL_SHARDS_COUNT, to_ext)

DEFAULT_CHUNK_BYTES = 64 * 1024 * 1024  # per-shard column chunk per apply

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
                   family=None, device=None, encoder=None,
                   batched: Optional[bool] = None,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES):
    """Generate .ec00..ec13 from .dat.  Returns the 14 shard-file
    CRC32Cs, or None from the host loop.

    Route (module docstring): with no `encoder` and batched=None, the
    batched device pipeline on `device` when prefer_batched_encode
    predicts it beats the host codec over this machine's link, else the
    host pipeline; batched=True forces the device pipeline; an explicit
    `encoder` or batched=False runs the host loop.  `device` is resolved
    first, so without a card and without device="cpu" this raises.
    stage_stats: see batched_encode.encode_volumes."""
    from ...parallel.batched_encode import encode_volumes

    _check_family(family)
    auto_host = False
    if batched is None:
        from ...util.platform import prefer_batched_encode

        batched = encoder is None and prefer_batched_encode(device)
        auto_host = encoder is None and not batched
    if batched or auto_host:
        crcs = encode_volumes([base_file_name], large_block=large_block_size,
                              small_block=small_block_size,
                              stage_stats=stage_stats, device=device,
                              host_codec=True if auto_host else None)
        return crcs[base_file_name]
    if encoder is None:
        # explicit batched=False: the synchronous host loop with a host
        # codec ("auto" would pick the card right back)
        encoder = codec_mod.new_host_encoder(DATA_SHARDS_COUNT,
                                             PARITY_SHARDS_COUNT)
    dat_size = os.path.getsize(base_file_name + ".dat")
    outputs = [open(base_file_name + to_ext(i), "wb")
               for i in range(TOTAL_SHARDS_COUNT)]
    try:
        with open(base_file_name + ".dat", "rb") as dat:
            remaining = dat_size
            while remaining > large_block_size * DATA_SHARDS_COUNT:
                _encode_one_row(dat, encoder, large_block_size, outputs,
                                chunk_bytes)
                remaining -= large_block_size * DATA_SHARDS_COUNT
            while remaining > 0:
                _encode_one_row(dat, encoder, small_block_size, outputs,
                                chunk_bytes)
                remaining -= small_block_size * DATA_SHARDS_COUNT
    finally:
        for f in outputs:
            f.close()
    return None


def _encode_one_row(dat, encoder, block_size: int, outputs,
                    chunk_bytes: int):
    """Encode one striped row: 10 consecutive blocks -> 14 shard appends."""
    blocks = []
    for _ in range(DATA_SHARDS_COUNT):
        block = dat.read(block_size)
        if len(block) < block_size:
            block = block + b"\x00" * (block_size - len(block))
        blocks.append(np.frombuffer(block, dtype=np.uint8))
    data = np.stack(blocks)  # (10, block_size)
    parity_matrix = encoder.matrix[DATA_SHARDS_COUNT:]
    for start in range(0, block_size, chunk_bytes):
        end = min(start + chunk_bytes, block_size)
        parity = encoder._apply(parity_matrix, data[:, start:end])
        for i in range(DATA_SHARDS_COUNT):
            outputs[i].write(data[i, start:end].tobytes())
        for i in range(PARITY_SHARDS_COUNT):
            outputs[DATA_SHARDS_COUNT + i].write(
                np.ascontiguousarray(parity[i]).tobytes())


def rebuild_ec_files(base_file_name: str, family=None, device=None,
                     encoder=None, batched: Optional[bool] = None,
                     buffer_size: int = SMALL_BLOCK_SIZE) -> dict:
    """Regenerate missing .ecNN files from survivors.  Returns {shard_id:
    crc32c} of the generated shards from the device pipeline, {shard_id:
    None} from the host loop.  Route as write_ec_files: the device
    pipeline (rebuild_shards) unless prefer_batched_encode rejects the
    link, an explicit `encoder` or batched=False, which run the
    synchronous host loop over `buffer_size` spans."""
    from ...parallel.batched_encode import rebuild_shards

    _check_family(family)
    if batched is None:
        from ...util.platform import prefer_batched_encode

        batched = encoder is None and prefer_batched_encode(device)
    if batched:
        return rebuild_shards(base_file_name, device=device)
    if encoder is None:
        encoder = codec_mod.new_host_encoder(DATA_SHARDS_COUNT,
                                             PARITY_SHARDS_COUNT)
    has_data = [os.path.exists(base_file_name + to_ext(i))
                for i in range(TOTAL_SHARDS_COUNT)]
    generated = [i for i in range(TOTAL_SHARDS_COUNT) if not has_data[i]]
    if not generated:
        return {}
    inputs = {i: open(base_file_name + to_ext(i), "rb")
              for i in range(TOTAL_SHARDS_COUNT) if has_data[i]}
    outputs = {i: open(base_file_name + to_ext(i), "wb") for i in generated}
    try:
        offset = 0
        while True:
            shards: list = [None] * TOTAL_SHARDS_COUNT
            n = 0
            for i, f in inputs.items():
                f.seek(offset)
                buf = f.read(buffer_size)
                if not buf:
                    return {i: None for i in generated}
                if n == 0:
                    n = len(buf)
                elif len(buf) != n:
                    raise ValueError(
                        f"ec shard size expected {n} actual {len(buf)}")
                shards[i] = np.frombuffer(buf, dtype=np.uint8)
            restored = encoder.reconstruct(shards)
            for i in generated:
                outputs[i].write(np.ascontiguousarray(restored[i]).tobytes())
            offset += n
    finally:
        for f in inputs.values():
            f.close()
        for f in outputs.values():
            f.close()


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
