"""EC decode: shard files back to a normal volume (.dat/.idx).

Parity with ec_decoder.go: the data shards are systematic, so .dat recovery
is a pure interleaved copy of .ec00-.ec09 (no GF math); .idx = .ecx entries
plus tombstones replayed from .ecj.
"""

from __future__ import annotations

import os
import struct

from .. import idx as idx_mod
from .. import types as t
from ..needle import get_actual_size
from ..super_block import SuperBlock
from . import DATA_SHARDS_COUNT, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext


def iterate_ecx_file(base_file_name: str, fn):
    """fn(needle_id, actual_offset, size) over every .ecx entry."""
    with open(base_file_name + ".ecx", "rb") as f:
        while True:
            buf = f.read(t.NEEDLE_MAP_ENTRY_SIZE)
            if len(buf) != t.NEEDLE_MAP_ENTRY_SIZE:
                return
            fn(*idx_mod.unpack_entry(buf))


def iterate_ecj_file(base_file_name: str, fn):
    """fn(needle_id) over every deletion-journal entry."""
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            buf = f.read(t.NEEDLE_ID_SIZE)
            if len(buf) != t.NEEDLE_ID_SIZE:
                return
            fn(struct.unpack(">Q", buf)[0])


def write_idx_file_from_ec_index(base_file_name: str):
    """.ecx + .ecj -> .idx (WriteIdxFileFromEcIndex, ec_decoder.go:18-43):
    a byte copy of .ecx followed by a tombstone entry per journalled id."""
    with open(base_file_name + ".ecx", "rb") as src, \
            open(base_file_name + ".idx", "wb") as dst:
        while True:
            chunk = src.read(1 << 20)
            if not chunk:
                break
            dst.write(chunk)
        iterate_ecj_file(
            base_file_name,
            lambda nid: dst.write(
                idx_mod.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE)))


def read_ec_volume_version(base_file_name: str) -> int:
    """Volume version from the superblock at the head of .ec00
    (shard 0 starts with the original .dat's first bytes)."""
    with open(base_file_name + to_ext(0), "rb") as f:
        return SuperBlock.from_file(f).version


def find_dat_file_size(data_base_file_name: str,
                       index_base_file_name: str) -> int:
    """Max (offset + actual size) over live .ecx entries
    (FindDatFileSize, ec_decoder.go:48-70)."""
    version = read_ec_volume_version(data_base_file_name)
    dat_size = 0

    def visit(nid, offset, size):
        nonlocal dat_size
        if t.size_is_deleted(size):
            return
        stop = offset + get_actual_size(size, version)
        dat_size = max(dat_size, stop)

    iterate_ecx_file(index_base_file_name, visit)
    return dat_size


def write_dat_file(base_file_name: str, dat_file_size: int,
                   large_block_size: int = LARGE_BLOCK_SIZE,
                   small_block_size: int = SMALL_BLOCK_SIZE,
                   data_shards: int = DATA_SHARDS_COUNT):
    """Reassemble .dat by interleaved copy of the data shards
    (WriteDatFile, ec_decoder.go:154-195).  All code families are
    systematic, so this is a pure copy regardless of family — only the
    stripe width (``data_shards``) differs."""
    inputs = [open(base_file_name + to_ext(i), "rb")
              for i in range(data_shards)]
    try:
        with open(base_file_name + ".dat", "wb") as dat:
            remaining = dat_file_size
            while remaining >= data_shards * large_block_size:
                for f in inputs:
                    block = f.read(large_block_size)
                    if len(block) != large_block_size:
                        raise IOError("short large-block read during decode")
                    dat.write(block)
                    remaining -= large_block_size
            while remaining > 0:
                for f in inputs:
                    to_read = min(remaining, small_block_size)
                    if to_read <= 0:
                        break
                    block = f.read(small_block_size)[:to_read]
                    if len(block) != to_read:
                        raise IOError("short small-block read during decode")
                    dat.write(block)
                    remaining -= to_read
    finally:
        for f in inputs:
            f.close()
