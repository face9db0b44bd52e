"""The card's busy time per GiB (an end-to-end metric, so every run on the
card traces its window) and the two host rates beside it."""

from __future__ import annotations

import time

import pytest

from ecbench import harness, spec

GIB = 1 << 30
CELL = "volume_warm_ec.deep_scrub"


def test_card_time_is_the_busy_milliseconds_per_gib():
    read = spec.reader("scrub_card_ms_per_gib")
    ctx = {"trace": {"busy_s": 2.0, "window_s": 51.0}, "scrub_bytes": 4 * GIB}
    assert read(ctx) == pytest.approx(500.0)


@pytest.mark.parametrize("ctx", [
    {"scrub_bytes": GIB},
    {"trace": None, "scrub_bytes": GIB},
    {"trace": {"busy_s": 1.0, "window_s": 1.0}, "scrub_bytes": 0},
    {"trace": {"busy_s": 0.0, "window_s": 1.0}, "scrub_bytes": GIB}])
def test_card_time_is_silent_without_a_trace_or_work(ctx):
    assert spec.reader("scrub_card_ms_per_gib")(ctx) is None


def _calls(*seconds):
    return [{"bytes": GIB, "s": s} for s in seconds]


def test_a_stalled_call_moves_the_window_rate_and_not_the_median():
    calls = _calls(0.1, 0.1, 0.1, 0.1, 0.1, 2.0)
    ctx = {"window_calls": calls, "scrub_bytes": 6 * GIB, "scrub_s": 2.5}
    assert spec.reader("scrub_call_p50_gib_s")(ctx) == pytest.approx(10.0)
    assert spec.reader("scrub_window_gib_s")(ctx) == pytest.approx(2.4)


@pytest.mark.parametrize("ctx", [{}, {"window_calls": []},
                                 {"window_calls": [{"bytes": GIB}]}])
def test_the_call_median_is_silent_without_the_calls_seconds(ctx):
    assert spec.reader("scrub_call_p50_gib_s")(ctx) is None


class _Timeline:
    made: list = []

    def __init__(self, path):
        self.prepared = self.started = self.opened = self.closed = False
        _Timeline.made.append(self)

    def prepare(self):
        self.prepared = True

    def start(self):
        assert self.prepared
        self.started = True

    def open(self):
        self.opened = True

    def close(self):
        self.closed = True

    def read(self, spans, priority):
        return {"busy_s": 0.5, "window_s": 1.0, "device_ops": {"k": 0.5},
                "idle_by_span": {"no harness span": 0.5}}


class _Dep:
    def build(self):
        pass

    def stop(self):
        pass

    def cleanup(self):
        pass

    def shard_files(self):
        return []

    def snapshot(self):
        return {"pool": {"allocs": 0, "evictions": 0}, "gc": [0, 0, 0]}

    def sites(self):
        return {"kernels": [], "spans": []}

    def scrub_once(self):
        time.sleep(0.01)
        return {"bytes": GIB // 4, "stats": {}}


@pytest.mark.parametrize("trace", [False, True])
def test_every_run_on_the_card_traces_its_window(monkeypatch, trace):
    """An untraced run on the card reads the card's busy time too, and
    prints its end-to-end metrics without a breakdown."""
    _Timeline.made.clear()
    monkeypatch.setattr(harness, "Timeline", _Timeline)
    monkeypatch.setattr(harness, "_deployment", lambda *a: _Dep())
    monkeypatch.setattr(harness, "_device_info", lambda d: {
        "platform": "gpu", "kind": "card", "count": 1,
        "memory_peak_bytes": 1})
    monkeypatch.setattr(harness, "verify", lambda *a: {"wrong": (0, 0)})
    result = harness.run(CELL, 1, 0.2, trace=trace, device="cuda")
    (tl,) = _Timeline.made
    assert tl.prepared and tl.started and tl.opened and tl.closed
    assert result["correct"]
    if trace:
        assert "breakdown" in result and result["device"]["busy_s"] == 0.5
        assert "scrub_window_gib_s" in result["metrics"]
    else:
        assert "breakdown" not in result and "busy_s" not in result["device"]
        card = result["metrics"]["scrub_card_ms_per_gib"]
        gib = result["attempted"] / 4
        assert card["value"] == pytest.approx(500.0 / gib)
        assert set(result["metrics"]) == {"scrub_card_ms_per_gib", "setup_s"}
