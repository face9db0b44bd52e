"""The port's tracing against the JAX package's: the same span trees
(names, parent links, services, statuses and tags; ids and times left
out), the same propagation headers, the same retention decisions and
recorder bounds under the same knobs.  No case asserts a wall-clock
time: slowness is given to a span as an explicit duration."""

import threading

import pytest

from seaweedfs_tpu import tracing as j_tr
from seaweedfs_tpu_torch import tracing as t_tr

BOTH = pytest.mark.parametrize("tr", [j_tr, t_tr], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv("WEED_TRACE_SLOW_MS", "1e9")
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    for tr in (j_tr, t_tr):
        tr.RECORDER.reset()
    yield
    for tr in (j_tr, t_tr):
        tr.RECORDER.reset()


def _canon(node):
    kids = sorted((_canon(c) for c in node["children"]), key=repr)
    return (node["name"], node["service"], node["status"],
            tuple(sorted((node.get("tags") or {}).items())), tuple(kids))


def _forest(tr) -> list:
    out = []
    for entry in tr.RECORDER.index(limit=10_000):
        tree = tr.RECORDER.get(entry["trace_id"])
        out.append((tuple(sorted((_canon(n) for n in tree["tree"]),
                                 key=repr)), tree["truncated"],
                    entry["services"], entry["spans"], entry["slow"]))
    return sorted(out, key=repr)


def _request(tr, i: int):
    """A request span with nested, tagged, failing and synthesised
    children, as the server's dispatch and the EC paths open them."""
    with tr.span(f"GET /{i}", service="volume", tags={"i": i}) as root:
        tr.tag_qos(root, "background" if i % 2 else "interactive",
                   tenant="t1")
        with tr.span("needle.read", tags={"vid": 3}):
            with tr.span("ec.recover.serve", tags={"shard": i % 14}):
                pass
        try:
            with tr.span("fsync.group_commit"):
                raise OSError("disk")
        except OSError:
            pass
        tr.record_span("ec.encode.read", 0.002, tags={"stage": "read"})
        hdrs = tr.inject({})
    return hdrs


def test_span_trees_equal_jax():
    for tr in (j_tr, t_tr):
        for i in range(6):
            _request(tr, i)
    assert _forest(j_tr) == _forest(t_tr)
    assert len(_forest(t_tr)) == 6


def test_header_inject_and_extract_equal_jax():
    got = []
    for tr in (j_tr, t_tr):
        with tr.span("client", service="filer") as sp:
            hdrs = tr.inject({})
            assert hdrs[tr.TRACE_HEADER] == sp.trace_id
            assert hdrs[tr.SPAN_HEADER] == sp.span_id
        server = tr.from_headers("POST /x", "volume", hdrs)
        assert server.trace_id == sp.trace_id
        assert server.parent_id == sp.span_id
        got.append((sorted(hdrs), hdrs[tr.SAMPLED_HEADER],
                    hdrs[tr.SRC_HEADER], server.sampled, server.is_root))
        fresh = tr.from_headers("GET /y", "volume", {})
        assert fresh.is_root and fresh.parent_id is None
        assert tr.inject({}) == {}  # no span on this thread
    assert got[0] == got[1]


@BOTH
def test_thread_local_context_and_mirror(tr):
    """swap/restore keep the thread-local span and the cross-thread
    mirror in step; other threads see no span of this one."""
    sp = tr.start("outer", service="s")
    prev = tr.swap(sp)
    assert tr.current() is sp
    assert tr.span_for_thread(threading.get_ident()) is sp
    seen = []
    t = threading.Thread(target=lambda: seen.append(tr.current()))
    t.start()
    t.join()
    assert seen == [None]
    child = tr.start("inner")
    assert child.parent_id == sp.span_id and child.service == "s"
    assert child.route == sp.route
    tr.restore(prev)
    assert tr.current() is prev
    tr.prune_thread_spans(set())
    assert tr.span_for_thread(threading.get_ident()) is None


@pytest.mark.parametrize("sample", ["0", "1"])
def test_retention_decisions_equal_jax(monkeypatch, sample):
    """Unsampled fast traces are dropped; a span slower than
    WEED_TRACE_SLOW_MS keeps its trace from that span on."""
    monkeypatch.setenv("WEED_TRACE_SAMPLE", sample)
    monkeypatch.setenv("WEED_TRACE_SLOW_MS", "50")
    out = []
    for tr in (j_tr, t_tr):
        for i in range(4):
            with tr.span("root", service="s"):
                tr.record_span("fast", 0.001)
                if i % 2:
                    tr.record_span("slow", 0.2)
        out.append(_forest(tr))
    assert out[0] == out[1]
    assert len(out[1]) == (4 if sample == "1" else 2)


@pytest.mark.parametrize("caps", [(3, 512), (256, 4)])
def test_recorder_bounds_equal_jax(caps):
    """Trace and per-trace span caps: old traces are evicted, extra spans
    counted as truncated."""
    out = []
    for tr in (j_tr, t_tr):
        rec = tr.Recorder(max_traces=caps[0], max_spans=caps[1])
        old = tr.RECORDER
        tr.RECORDER = rec
        try:
            for i in range(6):
                with tr.span(f"r{i}", service="s"):
                    for j in range(6):
                        tr.record_span(f"c{j}", 0.001)
            out.append((_forest(tr),
                        {k: v["count"] for k, v in rec.aggregate().items()}))
        finally:
            tr.RECORDER = old
    assert out[0] == out[1]


@BOTH
def test_live_knobs(tr, monkeypatch):
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "0.25")
    assert tr.sample_rate() == 0.25
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "7")
    assert tr.sample_rate() == 1.0
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "bogus")
    assert tr.sample_rate() == 0.01
    monkeypatch.setenv("WEED_TRACE_SLOW_MS", "12.5")
    assert tr.slow_ms() == 12.5
    monkeypatch.setenv("WEED_TRACE_MAX_TRACES", "9")
    assert tr.RECORDER._caps()[0] == 9


def test_aggregate_equal_jax():
    for tr in (j_tr, t_tr):
        for i in range(5):
            _request(tr, i)
    agg = [{k: v["count"] for k, v in tr.RECORDER.aggregate().items()}
           for tr in (j_tr, t_tr)]
    assert agg[0] == agg[1]
    assert agg[1]["ec.recover.serve"] == 5
    prefixed = t_tr.RECORDER.aggregate("ec.")
    assert set(prefixed) == {"ec.recover.serve", "ec.encode.read"}


def test_error_status_and_qos_route():
    for tr in (j_tr, t_tr):
        with tr.span("GET /bg", service="s") as root:
            tr.tag_qos(root, "background")
            child = tr.start("work")
            assert child.route == "GET /bg [bg]"
            child.finish(status="error: X")
    trees = [tr.RECORDER.get(tr.RECORDER.index()[0]["trace_id"])
             for tr in (j_tr, t_tr)]
    assert [_canon(n) for n in trees[0]["tree"]] == \
        [_canon(n) for n in trees[1]["tree"]]
