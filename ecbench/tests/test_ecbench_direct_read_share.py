"""The scrub_direct_read_share reader over hand-made window contexts."""

from __future__ import annotations

import pytest

from ecbench import spec


def _calls(*stats):
    return {"window_calls": [{"stats": s} for s in stats]}


def test_scrub_direct_read_share_sums_the_window_calls():
    read = spec.reader("scrub_direct_read_share")
    assert read(_calls({"read_direct_bytes": 300, "read_copied_bytes": 0},
                       {"read_direct_bytes": 100,
                        "read_copied_bytes": 0})) == 100.0
    # a volume spread over peers stages every span through `bytes`
    assert read(_calls({"read_direct_bytes": 0,
                        "read_copied_bytes": 500})) == 0.0
    assert read(_calls({"read_direct_bytes": 300, "read_copied_bytes": 100},
                       {"read_direct_bytes": 0,
                        "read_copied_bytes": 0})) == pytest.approx(75.0)


@pytest.mark.parametrize("ctx", [{}, {"window_calls": []},
                                 _calls({"wall": 1.0, "stage_copy": 0.2}),
                                 _calls({"read_direct_bytes": 0,
                                         "read_copied_bytes": 0})])
def test_scrub_direct_read_share_is_silent_without_counts(ctx):
    """A program without the counts (the parent of the change that added
    them), or a window that staged nothing, reads nothing."""
    assert spec.reader("scrub_direct_read_share")(ctx) is None
