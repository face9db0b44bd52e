"""Needle -> shard interval math, matching ec_locate.go bit for bit.

A volume's logical .dat is striped row-major over the family's data shards
(10 for RS/Cauchy, the default): first nLargeRows rows of 1 GB blocks, then
rows of 1 MB blocks (zero-padded).  A (offset, size) span in the .dat maps
to one or more Intervals, each naming a block index + inner offset;
ToShardIdAndOffset then maps a block to (shard id, offset within the .ecNN
file).  The large/small two-tier scheme exists so the large-row count is
derivable from a shard's file size (ec_locate.go:18-19).

``data_shards`` defaults to the classic 10 so existing callers and volumes
are untouched; repair-efficient code families with a different stripe width
(pm_msr stripes over 5) pass their own.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import DATA_SHARDS_COUNT


@dataclass
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, large_block_size: int,
                               small_block_size: int,
                               data_shards: int = DATA_SHARDS_COUNT,
                               ) -> tuple[int, int]:
        ec_file_offset = self.inner_block_offset
        row_index = self.block_index // data_shards
        if self.is_large_block:
            ec_file_offset += row_index * large_block_size
        else:
            ec_file_offset += (self.large_block_rows_count * large_block_size
                               + row_index * small_block_size)
        ec_file_index = self.block_index % data_shards
        return ec_file_index, ec_file_offset


def locate_data(large_block_length: int, small_block_length: int,
                dat_size: int, offset: int, size: int,
                data_shards: int = DATA_SHARDS_COUNT) -> list[Interval]:
    block_index, is_large, inner_offset = _locate_offset(
        large_block_length, small_block_length, dat_size, offset, data_shards)
    # +k*small ensures the large-row count is derivable from shard size
    n_large_rows = (dat_size + data_shards * small_block_length) // (
        large_block_length * data_shards)

    intervals: list[Interval] = []
    while size > 0:
        interval = Interval(
            block_index=block_index,
            inner_block_offset=inner_offset,
            size=0,
            is_large_block=is_large,
            large_block_rows_count=n_large_rows,
        )
        block_remaining = (large_block_length if is_large
                           else small_block_length) - inner_offset
        if size <= block_remaining:
            interval.size = size
            intervals.append(interval)
            return intervals
        interval.size = block_remaining
        intervals.append(interval)
        size -= interval.size
        block_index += 1
        if is_large and block_index == n_large_rows * data_shards:
            is_large = False
            block_index = 0
        inner_offset = 0
    return intervals


def inline_shard_extent(logical_size: int, unit: int, data_shards: int,
                        shard_id: int) -> int:
    """Valid byte extent of one data shard's append-only log when
    ``logical_size`` stream bytes have been striped row-major in
    ``unit``-sized blocks over ``data_shards`` shards (the inline EC
    layout: small blocks only, zero large rows).

    Shards before the block the stream head is in have a full block in
    the current row; the head shard has the partial remainder; later
    shards end at the previous row."""
    full_rows, rem = divmod(logical_size, unit * data_shards)
    head_block, head_rem = divmod(rem, unit)
    extent = full_rows * unit
    if shard_id < head_block:
        extent += unit
    elif shard_id == head_block:
        extent += head_rem
    return extent


def _locate_offset(large_block_length: int, small_block_length: int,
                   dat_size: int, offset: int,
                   data_shards: int = DATA_SHARDS_COUNT,
                   ) -> tuple[int, bool, int]:
    large_row_size = large_block_length * data_shards
    n_large_rows = dat_size // large_row_size
    if offset < n_large_rows * large_row_size:
        return (offset // large_block_length, True,
                offset % large_block_length)
    offset -= n_large_rows * large_row_size
    return (offset // small_block_length, False,
            offset % small_block_length)
