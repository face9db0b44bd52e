"""The host readings a run prints beside its result (host.py) and the call
loop's per-call record they are taken from."""

from __future__ import annotations

import os
import time

import pytest

from ecbench import harness, host


class _Dep:
    """A deployment whose calls each take `pause` seconds and return
    `nbytes` bytes."""

    def __init__(self, pause: float, nbytes: int, files: list = ()):
        self.pause, self.nbytes, self.files = pause, nbytes, list(files)

    def scrub_once(self) -> dict:
        time.sleep(self.pause)
        return {"bytes": self.nbytes, "stats": {}}

    def snapshot(self) -> dict:
        return {}

    def shard_files(self) -> list:
        return self.files


def test_the_per_call_record_adds_up_to_the_window(tmp_path):
    dep = _Dep(0.01, 3 << 20)
    window = harness.Window(dep, None, None)
    out = harness.call_loop(dep, {"warmup_calls": 2}, {}, 1, 0.3, window,
                            str(tmp_path))
    calls = out["window_calls"]
    assert len(out["calls"]) == len(calls) + 2 and len(calls) >= 10
    assert sum(c["bytes"] for c in calls) == out["scrub_bytes"]
    assert sum(c["s"] for c in calls) == pytest.approx(out["scrub_s"],
                                                       abs=2e-3)
    assert calls[0]["t0"] == window.t_open
    for a, b in zip(calls, calls[1:]):
        assert b["t0"] == pytest.approx(a["t0"] + a["s"])
    assert window.host_open and window.host_close


def test_host_readings_of_a_run_hold_every_part(tmp_path):
    path = tmp_path / "shard"
    path.write_bytes(os.urandom(1 << 20))
    dep = _Dep(0.005, 1 << 20, [str(path)])
    window = harness.Window(dep, None, None)
    out = harness.call_loop(dep, {"warmup_calls": 1}, {}, 1, 0.2, window,
                            str(tmp_path))
    got = harness._host_readings(window, out, 1.0, 0.2)
    assert got["resident_share_open"] == 1.0
    assert set(got["open"]) == {"Cached_kib", "Dirty_kib", "Writeback_kib"}
    shares = got["cpu_share"]
    assert all(0.0 <= v <= 1.0 for v in shares.values())
    assert not shares or sum(shares.values()) == pytest.approx(1.0)
    assert got["rusage"]["utime_s"] >= 0 and "nivcsw" in got["rusage"]
    assert got["calls"]["n"] == out["attempted"]
    assert got["calls"]["gib_s"] == pytest.approx(
        out["scrub_bytes"] / host.GIB / out["scrub_s"], rel=0.02)
    q1, q2, q3 = got["calls"]["gib_s_quartiles"]
    assert 0 < q1 <= q2 <= q3
    assert len(got["calls"]["gib_s_by_tenth"]) == 10


def test_a_file_just_written_and_read_is_resident(tmp_path):
    path = tmp_path / "f"
    data = os.urandom(3 << 20)
    path.write_bytes(data)
    assert path.read_bytes() == data
    resident, pages = host.residency(str(path))
    assert pages == -(-len(data) // os.sysconf("SC_PAGE_SIZE"))
    assert resident == pages
    assert host.resident_share([str(path), str(path)]) == 1.0


def test_an_empty_file_has_no_pages(tmp_path):
    path = tmp_path / "empty"
    path.write_bytes(b"")
    assert host.residency(str(path)) == (0, 0)
    assert host.resident_share([str(path)]) == 0.0


def test_calls_split_the_window_by_tenth():
    calls = [{"t0": 10.0 + i, "s": 1.0, "bytes": 1 << 30} for i in range(8)]
    calls.append({"t0": 18.0, "s": 2.0, "bytes": 1 << 30})
    got = host.calls(calls, 10.0, 10.0)
    assert got["n"] == 9
    assert got["gib_s_by_tenth"][:8] == [1.0] * 8
    assert got["gib_s_by_tenth"][8] == 0.5 and got["gib_s_by_tenth"][9] is None
    assert got["gib_s_quartiles"][1] == 1.0


def test_between_reads_the_window_deltas():
    a = host.sample()
    sum(range(200000))
    b = host.sample()
    got = host.between(a, b)
    assert got["rusage"]["utime_s"] >= 0.0
    assert all(v >= 0 for v in got["vmstat"].values())
    assert all(0.0 <= v for v in got.get("pressure_share", {}).values())


def test_a_direct_read_is_spanned_as_the_scrub_read(monkeypatch):
    from seaweedfs_tpu_torch.maintenance import deep_scrub as ds

    from ecbench.deploy import volume_server

    spans = volume_server.sites()["spans"]
    assert (ds, "_read_span", "scrub.read_span") in spans
    assert (ds, "_fill_span", "scrub.read_span") in spans
    monkeypatch.delattr(ds, "_fill_span")
    assert all(attr != "_fill_span"
               for _, attr, _ in volume_server.sites()["spans"])


def test_a_span_name_two_sites_share_labels_its_idle_time_once(tmp_path):
    import json

    from ecbench.trace import END, START, Timeline

    sites = {"spans": [(None, "a", "k5.launch"), (None, "b", "read"),
                       (None, "c", "read")]}
    priority = harness.span_priority(sites)
    assert priority == ["k5.launch", "read"]
    tl = Timeline.__new__(Timeline)
    tl.path, tl.host0 = str(tmp_path / "trace.json"), 0
    with open(tl.path, "w") as f:
        json.dump({"traceEvents": [
            {"cat": "user_annotation", "name": START, "ts": 0},
            {"cat": "user_annotation", "name": END, "ts": 1000}]}, f)
    spans = [("read", 100_000, 300_000), ("read", 500_000, 600_000)]
    got = tl.read(spans, priority)["idle_by_span"]
    assert got["read"] == pytest.approx(300e-6)
    assert got["no harness span"] == pytest.approx(700e-6)


def test_a_kernel_without_the_proc_files_leaves_their_readings_out(
        tmp_path, monkeypatch):
    monkeypatch.setattr(host, "PROC", str(tmp_path))
    a, b = host.sample(), host.sample()
    assert a["mem"] == a["cpu"] == a["vmstat"] == a["pressure_us"] == {}
    got = host.between(a, b)
    assert got["cpu_share"] == {} and got["vmstat"] == {}
    assert got["pressure_share"] == {}
    assert "utime_s" in got["rusage"]
