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

A code family other than RS (`family=`, storage/erasure_coding/codes)
stripes over its own data-shard count and encodes through its generator on
the native host kernel, as in the JAX package; its rebuild runs the
family's repair plan (k survivors, or pm_msr's d helper projections).  A
family of RS's geometry (the Cauchy MDS code) instead takes the two
pipelines with its parity rows, so `-ec.backend=cuda` encodes it through
K2 on the card; its shard files and CRCs equal the host loop's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ... import device as device_mod
from ...ops import codec as codec_mod
from .. import idx as idx_mod
from ..needle_map import load_needle_map_from_idx
from . import (DATA_SHARDS_COUNT, LARGE_BLOCK_SIZE, PARITY_SHARDS_COUNT,
               SMALL_BLOCK_SIZE, TOTAL_SHARDS_COUNT, to_ext)

DEFAULT_CHUNK_BYTES = 64 * 1024 * 1024  # per-shard column chunk per apply



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


def _resolve_family(family):
    """A family name, a CodeFamily, or None (the RS default)."""
    from .codes import get_family

    if hasattr(family, "data_shards"):
        return family
    return get_family(family)


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
    stage_stats: see batched_encode.encode_volumes.

    family: a code-family name or CodeFamily.  A family of RS's geometry
    (10 + 4 shards, one lane: the Cauchy MDS code) takes the same routes
    with its parity rows, the card's through K2 or K1; the reference
    encodes it in its family host loop, and the files are the same.  Any
    other family, an explicit `encoder` without batched=True, or
    batched=False takes the family host loop (`_write_ec_files_family`).
    Both return the 14 shard CRC32Cs."""
    from ...parallel.batched_encode import encode_volumes

    parity = None
    if family is not None:
        fam = _resolve_family(family)
        if fam.name != "rs_vandermonde":
            device_mod.resolve(device)
            rs_geometry = (fam.data_shards, fam.parity_shards,
                           fam.sub_shards) == (DATA_SHARDS_COUNT,
                                               PARITY_SHARDS_COUNT, 1)
            if not rs_geometry or batched is False or (
                    encoder is not None and not batched):
                return _write_ec_files_family(base_file_name, fam,
                                              large_block_size,
                                              small_block_size, chunk_bytes)
            parity = fam.parity_matrix()
    auto_host = False
    if batched is None:
        from ...util.platform import prefer_batched_encode

        batched = encoder is None and prefer_batched_encode(device)
        auto_host = encoder is None and not batched
    if batched or auto_host:
        crcs = encode_volumes([base_file_name], large_block=large_block_size,
                              small_block=small_block_size,
                              stage_stats=stage_stats, device=device,
                              host_codec=True if auto_host else None,
                              parity=parity)
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
                     buffer_size: int = SMALL_BLOCK_SIZE,
                     stats: Optional[dict] = None) -> dict:
    """Regenerate missing .ecNN files from survivors.  Returns {shard_id:
    crc32c} of the generated shards from the device pipeline, {shard_id:
    None} from the host loop.  Route as write_ec_files: the device
    pipeline (rebuild_shards) unless prefer_batched_encode rejects the
    link, an explicit `encoder` or batched=False, which run the
    synchronous host loop over `buffer_size` spans.

    family / stats: a family other than RS, or any request for read
    accounting (a `stats` dict), takes the planned rebuild
    (`rebuild_ec_files_planned`)."""
    from ...parallel.batched_encode import rebuild_shards

    if family is not None or stats is not None:
        fam = _resolve_family(family)
        if fam.name != "rs_vandermonde" or stats is not None:
            device_mod.resolve(device)
            return rebuild_ec_files_planned(base_file_name, fam,
                                            buffer_size, stats)
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


def _write_ec_files_family(base_file_name: str, fam,
                           large_block_size: int, small_block_size: int,
                           chunk_bytes: int) -> list:
    """Host encode loop for a family other than RS: stripe the .dat over
    the family's k data shards and run its generator on the native host
    kernel (the host codec's _apply takes any matrix).  Returns the 14
    shard CRC32Cs, chained as the shards are written, the record the RS
    pipeline fuses, so the .vif scrub check works the same."""
    from ...ops.crc32c import crc32c

    fam.check_block(large_block_size)
    fam.check_block(small_block_size)
    chunk_bytes = max(fam.sub_shards,
                      (chunk_bytes // fam.sub_shards) * fam.sub_shards)
    kernel = codec_mod.new_host_encoder(fam.data_shards, fam.parity_shards)
    k = fam.data_shards
    dat_size = os.path.getsize(base_file_name + ".dat")
    outputs = [open(base_file_name + to_ext(i), "wb")
               for i in range(TOTAL_SHARDS_COUNT)]
    crcs = [0] * TOTAL_SHARDS_COUNT
    try:
        with open(base_file_name + ".dat", "rb") as dat:
            remaining = dat_size
            while remaining > 0:
                block_size = (large_block_size
                              if remaining > large_block_size * k
                              else small_block_size)
                blocks = []
                for _ in range(k):
                    block = dat.read(block_size)
                    if len(block) < block_size:
                        block = block + b"\x00" * (block_size - len(block))
                    blocks.append(np.frombuffer(block, dtype=np.uint8))
                data = np.stack(blocks)  # (k, block_size)
                for start in range(0, block_size, chunk_bytes):
                    end = min(start + chunk_bytes, block_size)
                    parity = fam.encode_blocks(data[:, start:end],
                                               apply_fn=kernel._apply)
                    for i in range(k):
                        chunk = data[i, start:end].tobytes()
                        outputs[i].write(chunk)
                        crcs[i] = crc32c(chunk, crcs[i])
                    for i in range(fam.parity_shards):
                        chunk = np.ascontiguousarray(parity[i]).tobytes()
                        outputs[k + i].write(chunk)
                        crcs[k + i] = crc32c(chunk, crcs[k + i])
                remaining -= block_size * k
    finally:
        for f in outputs:
            f.close()
    return crcs


def _read_same(files, ids, n: int) -> tuple[list, int]:
    """`n` bytes from each of `files[i]` for i in `ids`, in that order;
    every read must return the same length (the shards' sizes agree)."""
    bufs, got = [], None
    for i in ids:
        buf = files[i].read(n)
        if got is None:
            got = len(buf)
        elif len(buf) != got:
            raise ValueError(f"ec shard size expected {got} actual "
                             f"{len(buf)}")
        bufs.append(buf)
    return bufs, got or 0


def rebuild_ec_files_planned(base_file_name: str, fam,
                             buffer_size: int = SMALL_BLOCK_SIZE,
                             stats: Optional[dict] = None) -> dict:
    """Rebuild driven by the family's repair plan: read only what the
    planner asks for.  MDS decode plans read k full survivors; pm_msr's
    single-shard plans read the d helper projections, 1/alpha of each
    helper.  Returns {shard_id: crc32c}; fills `stats` with the plan
    kind and read / rebuilt byte counts, where read_bytes counts
    survivor bytes consumed (after projection: what a distributed
    rebuild moves over the network)."""
    from ...ops.crc32c import crc32c

    a = fam.sub_shards
    buffer_size = max(a, (buffer_size // a) * a)
    has_data = [os.path.exists(base_file_name + to_ext(i))
                for i in range(TOTAL_SHARDS_COUNT)]
    generated = [i for i in range(TOTAL_SHARDS_COUNT) if not has_data[i]]
    present = [i for i in range(TOTAL_SHARDS_COUNT) if has_data[i]]
    out_stats = stats if stats is not None else {}
    out_stats.update({"plan": None, "read_bytes": 0, "rebuilt_bytes": 0,
                      "read_amp": None, "helpers": ()})
    if not generated:
        return {}
    plan = None
    if len(generated) == 1:
        plan = fam.repair_plan(generated[0], present)
    kernel = codec_mod.new_host_encoder(fam.data_shards, fam.parity_shards)
    read_bytes = rebuilt_bytes = 0
    crcs = {i: 0 for i in generated}
    if plan is not None and plan.kind == "projection":
        lost = generated[0]
        chosen = plan.helpers
        inputs = {h: open(base_file_name + to_ext(h), "rb") for h in chosen}
        try:
            with open(base_file_name + to_ext(lost), "wb") as out:
                while True:
                    chunks, n = _read_same(inputs, chosen, buffer_size)
                    if not n:
                        break
                    projs = np.stack([
                        fam.project(np.frombuffer(c, dtype=np.uint8),
                                    plan.vector) for c in chunks])
                    restored = np.ascontiguousarray(
                        fam.combine_projections(plan, projs)).tobytes()
                    out.write(restored)
                    crcs[lost] = crc32c(restored, crcs[lost])
                    read_bytes += projs.nbytes
                    rebuilt_bytes += n
        finally:
            for f in inputs.values():
                f.close()
    else:
        chosen = (plan.helpers if plan is not None
                  else fam.choose_survivors(present))
        inputs = {i: open(base_file_name + to_ext(i), "rb") for i in chosen}
        outputs = {i: open(base_file_name + to_ext(i), "wb")
                   for i in generated}
        try:
            while True:
                chunks, n = _read_same(inputs, chosen, buffer_size)
                if not n:
                    break
                stack = np.stack([np.frombuffer(c, dtype=np.uint8)
                                  for c in chunks])
                restored = fam.decode_blocks(chosen, stack, generated,
                                             apply_fn=kernel._apply)
                for idx, i in enumerate(generated):
                    chunk = np.ascontiguousarray(restored[idx]).tobytes()
                    outputs[i].write(chunk)
                    crcs[i] = crc32c(chunk, crcs[i])
                read_bytes += n * len(chosen)
                rebuilt_bytes += n * len(generated)
        finally:
            for f in inputs.values():
                f.close()
            for f in outputs.values():
                f.close()
    out_stats.update({
        "plan": plan.kind if plan is not None else "decode",
        "read_bytes": read_bytes,
        "rebuilt_bytes": rebuilt_bytes,
        "read_amp": (round(read_bytes / rebuilt_bytes, 4)
                     if rebuilt_bytes else None),
        "helpers": (plan.helpers if plan is not None
                    else tuple(sorted(chosen))),
    })
    return crcs


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
