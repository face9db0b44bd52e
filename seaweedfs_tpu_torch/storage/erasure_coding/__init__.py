"""Erasure coding: RS(10,4) over striped volume blocks.

File taxonomy per volume v: v.dat -> v.ec00..v.ec13 (shards) and v.vif
(volume info sidecar), the same files the JAX package writes and reads.
"""

DATA_SHARDS_COUNT = 10
PARITY_SHARDS_COUNT = 4
TOTAL_SHARDS_COUNT = DATA_SHARDS_COUNT + PARITY_SHARDS_COUNT
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1 GB
SMALL_BLOCK_SIZE = 1024 * 1024  # 1 MB


def to_ext(ec_index: int) -> str:
    return f".ec{ec_index:02d}"
