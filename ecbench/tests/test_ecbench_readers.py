"""Per-layer metric readers over hand-made window contexts."""

from __future__ import annotations

import pytest

from ecbench import spec


def _calls(*stats):
    return {"window_calls": [{"stats": s} for s in stats]}


def test_scrub_card_crc_share_sums_the_window_calls():
    read = spec.reader("scrub_card_crc_share")
    assert read(_calls({"crc_card_bytes": 300, "crc_host_bytes": 0},
                       {"crc_card_bytes": 100, "crc_host_bytes": 0})) == 100.0
    assert read(_calls({"crc_card_bytes": 300, "crc_host_bytes": 100},
                       {"crc_card_bytes": 0, "crc_host_bytes": 0})) == \
        pytest.approx(75.0)


@pytest.mark.parametrize("ctx", [{}, {"window_calls": []},
                                 _calls({"wall": 1.0, "span_crc": 0.2}),
                                 _calls({"crc_card_bytes": 0,
                                         "crc_host_bytes": 0})])
def test_scrub_card_crc_share_is_silent_without_counts(ctx):
    """A program without the counts (the parent of the change that added
    them), or a window that CRC'd nothing, reads nothing."""
    assert spec.reader("scrub_card_crc_share")(ctx) is None
