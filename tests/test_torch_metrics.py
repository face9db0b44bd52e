"""The port's metrics registry against the JAX package's: the same
families, and the same samples after the same operations.

Each case takes an exposition of both registries before and after running
one operation through both packages, parses all four with the strict
parser of tests/test_metrics_exposition.py, and compares the deltas.

Tolerance: counters, gauges of bytes and of counts, and histogram
``_count`` samples are exact.  Excluded: histogram ``_sum`` and
``_bucket`` samples (all the registry's histograms are of seconds),
every family of seconds (``*_seconds``, ``*_seconds_total``), the process
self-metrics (RSS, open fds, threads, GC collections, uptime, start time)
and the sampler's own gauges (overhead ratio, interned stacks), which are
functions of the wall clock.  A ``device`` label's value is a placement
name that differs by package (a JAX device against a torch device), so
the comparison maps every value but ``host`` to ``dev``.  No case asserts
a wall-clock time.
"""

import importlib
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from test_metrics_exposition import check_histograms, strict_parse

from seaweedfs_tpu import tracing as j_tracing
from seaweedfs_tpu.ops import device_pool as j_pool
from seaweedfs_tpu.qos import lanes as j_lanes
from seaweedfs_tpu.stats import access as j_access
from seaweedfs_tpu.stats import events as j_events
from seaweedfs_tpu.stats import metrics as j_metrics
from seaweedfs_tpu.stats import sketch as j_sketch
from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import store as j_store
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.storage.erasure_coding import codes as j_codes
from seaweedfs_tpu.storage.erasure_coding import ec_volume as j_ecv
from seaweedfs_tpu.storage.erasure_coding import encoder as j_enc
from seaweedfs_tpu.storage.erasure_coding import inline as j_inline
from seaweedfs_tpu.storage.erasure_coding import recover as j_recover
from seaweedfs_tpu.util import faults as j_faults
from seaweedfs_tpu_torch import tracing as t_tracing
from seaweedfs_tpu_torch.maintenance import deep_scrub as t_scrub
from seaweedfs_tpu_torch.ops import device_pool as t_pool
from seaweedfs_tpu_torch.qos import lanes as t_lanes
from seaweedfs_tpu_torch.stats import access as t_access
from seaweedfs_tpu_torch.stats import events as t_events
from seaweedfs_tpu_torch.stats import metrics as t_metrics
from seaweedfs_tpu_torch.stats import sketch as t_sketch
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import store as t_store
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.storage.erasure_coding import codes as t_codes
from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume as t_ecv
from seaweedfs_tpu_torch.storage.erasure_coding import inline as t_inline
from seaweedfs_tpu_torch.storage.erasure_coding import recover as t_recover
from seaweedfs_tpu_torch.util import faults as t_faults

# the JAX package's maintenance/__init__ exports a deep_scrub function
j_scrub = importlib.import_module("seaweedfs_tpu.maintenance.deep_scrub")
LARGE, SMALL = 10000, 100
LOST = (0, 5, 11, 13)
_EXCLUDED_FAMILIES = ("SeaweedFS_process_", "SeaweedFS_profiler_")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    t_pool.reset_pool()


@pytest.fixture(autouse=True)
def _quiet_tracing(monkeypatch):
    """No slow-span promotion: a trace is kept only when it is sampled."""
    monkeypatch.setenv("WEED_TRACE_SLOW_MS", "1e9")
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "0")


def _comparable(family: str, kind: str, sname: str) -> bool:
    if family.startswith(_EXCLUDED_FAMILIES):
        return False
    if family.endswith(("_seconds", "_seconds_total")):
        return kind == "histogram" and sname.endswith("_count")
    if kind == "histogram":
        return sname.endswith("_count")
    return True


def _samples(text: str) -> dict:
    fams = strict_parse(text)
    check_histograms(fams)
    out = {}
    for family, fam in fams.items():
        for sname, labels, value in fam["samples"]:
            if not _comparable(family, fam["type"], sname):
                continue
            if "device" in labels and labels["device"] != "host":
                labels = dict(labels, device="dev")
            key = (sname, tuple(sorted(labels.items())))
            out[key] = out.get(key, 0.0) + value
    return out


class _Delta:
    """Expositions of both registries around a block; `jax` and `port`
    are the per-sample deltas, restricted to `families` when given."""

    def __init__(self, families=None):
        self.families = families

    def __enter__(self):
        self._j0 = _samples(j_metrics.REGISTRY.expose())
        self._t0 = _samples(t_metrics.REGISTRY.expose())
        return self

    def _diff(self, before, after):
        out = {}
        for key in set(before) | set(after):
            if self.families is not None and not any(
                    key[0].startswith(f) for f in self.families):
                continue
            d = after.get(key, 0.0) - before.get(key, 0.0)
            if d:
                out[key] = round(d, 9)
        return out

    def __exit__(self, *exc):
        self.jax = self._diff(self._j0,
                              _samples(j_metrics.REGISTRY.expose()))
        self.port = self._diff(self._t0,
                               _samples(t_metrics.REGISTRY.expose()))
        return False

    def value(self, which: str, sname: str, **labels) -> float:
        d = getattr(self, which)
        return d.get((sname, tuple(sorted(labels.items()))), 0.0)


def _both(d: _Delta):
    assert d.jax == d.port
    assert d.port, "the operation moved no sample"


# -- the registry itself ------------------------------------------------------

# the remote reader's peer fetches, which the JAX package does not count
PORT_ONLY_FAMILIES = {"SeaweedFS_volumeServer_ec_peer_read_bytes_total",
                      "SeaweedFS_volumeServer_ec_peer_read_seconds_total",
                      "SeaweedFS_volumeServer_ec_peer_read_errors_total"}



def _headers(reg) -> dict:
    out = {}
    for line in reg.expose().splitlines():
        if line.startswith("# "):
            out.setdefault(line.split(" ", 3)[2], []).append(line)
    return out


def test_every_family_registered_with_equal_help_type_and_labels():
    """One dashboard reads either package: every family of the JAX
    registry exists in the port's, with the same HELP and TYPE lines, the
    same label names and the same histogram buckets; the port adds only
    its EC peer-read families."""
    jh, th = _headers(j_metrics.REGISTRY), _headers(t_metrics.REGISTRY)
    assert set(jh) <= set(th)
    for name in jh:
        assert jh[name] == th[name], name
        jm = j_metrics.REGISTRY._metrics[name]
        tm = t_metrics.REGISTRY._metrics[name]
        assert (jm.kind, jm.label_names) == (tm.kind, tm.label_names), name
        if jm.kind == "histogram":
            assert jm.buckets == tm.buckets, name
    assert set(th) - set(jh) == PORT_ONLY_FAMILIES


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_private_registry_expositions_equal(kind):
    """The same updates through a private registry of each package give
    the same exposition text, byte for byte."""
    texts = []
    for mod in (j_metrics, t_metrics):
        reg = mod.Registry()
        if kind == "counter":
            c = reg.counter("t_total", "things", ("code",))
            c.labels("200").inc()
            c.labels('a"b\\c\nd').inc(2.5)
            c.labels("200").set_cumulative(7)
            c.labels("200").set_cumulative(3)  # never goes backwards
            reg.counter("t_bare_total", "no labels")
        elif kind == "gauge":
            g = reg.gauge("t_g", "gauge", ("dst", "x"))
            g.labels("a", "1").set(-3.5)
            g.labels("a", "2").inc(2)
            g.labels("b", "1").dec(1)
            g.remove("a")
            reg.gauge("t_fn", "callback", fn=lambda: 42.0)
        else:
            h = reg.histogram("t_seconds", "latency", ("op",),
                              buckets=(0.001, 0.01, 0.1, 1))
            for v in (0.0005, 0.002, 0.02, 0.2, 2, 200):
                h.labels("read").observe(v)
            h.observe(0.05, labels=("write",))
        texts.append(reg.expose())
    assert texts[0] == texts[1]
    fams = strict_parse(texts[1])
    assert check_histograms(fams) == (2 if kind == "histogram" else 0)


def test_merge_expositions_equal_jax():
    parts = []
    for mod in (j_metrics, t_metrics):
        reg = mod.Registry()
        reg.counter("t_total", "things", ("code",)).labels("200").inc(3)
        reg.histogram("t_seconds", "lat").observe(0.2)
        parts.append(reg.expose())
    merged = [mod.merge_expositions([("w0", parts[i]), ("w1", parts[i])])
              for i, mod in enumerate((j_metrics, t_metrics))]
    assert merged[0] == merged[1]
    fams = strict_parse(merged[1])
    assert {s[1]["worker"] for s in fams["t_total"]["samples"]} == \
        {"w0", "w1"}


def test_whole_exposition_parses_strictly():
    fams = strict_parse(t_metrics.REGISTRY.expose())
    assert len(fams) == len(t_metrics.REGISTRY._metrics)
    check_histograms(fams)


# -- the wired sites ----------------------------------------------------------


def _write_needles(vol, needle_mod, count, seed):
    rng = np.random.default_rng(seed)
    live = {}
    for i in range(1, count + 1):
        data = rng.bytes(int(rng.integers(1, 1500)))
        n = needle_mod.Needle.create(data, name=f"f{i}".encode())
        n.id, n.cookie = i, 0x1000 + i
        vol.write_needle(n)
        live[i] = (n.cookie, data)
    return live


@pytest.fixture(scope="module")
def ec_volume_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("metrics_ec"))
    v = j_volume.Volume(d, "", 1)
    live = _write_needles(v, j_needle, 40, seed=5)
    base = v.file_name()
    v.close()
    crcs = j_enc.write_ec_files(base, large_block_size=LARGE,
                                small_block_size=SMALL, batched=True)
    j_enc.write_sorted_file_from_idx(base)
    j_enc.save_volume_info(base, version=3,
                           extra={"shard_crc32c": [int(c) for c in crcs]})
    return d, live


def _mount(mod, d, lost=(), **kw):
    ev = mod.EcVolume(d, "", 1, large_block_size=LARGE,
                      small_block_size=SMALL, **kw)
    for i in range(14):
        if i not in lost:
            ev.add_shard(mod.EcVolumeShard(d, "", 1, i))
    return ev


@pytest.mark.parametrize("block_kb", ["0", "0.5"])
def test_degraded_reads_move_recover_families_equally(ec_volume_dir,
                                                      tmp_path, monkeypatch,
                                                      block_kb):
    """Every needle read with four shards lost, in the same order through
    both packages' EcVolume: the recover cache, span and byte counters
    move equally, and each mirror equals its own RecoverStats."""
    d, live = ec_volume_dir
    monkeypatch.setenv("WEED_EC_RECOVER_BLOCK_KB", block_kb)
    dirs = []
    for name in ("jax", "port"):
        dirs.append(str(tmp_path / name))
        shutil.copytree(d, dirs[-1])
    j_recover.STATS.reset()
    t_recover.STATS.reset()
    jev = _mount(j_ecv, dirs[0], LOST)
    tev = _mount(t_ecv, dirs[1], LOST, device="cpu")
    with _Delta(("SeaweedFS_volumeServer_ec_recover_",)) as delta:
        for ev in (jev, tev):
            for nid, (cookie, data) in live.items():
                assert ev.read_needle(nid, cookie=cookie).data == data
    _both(delta)
    snap = t_recover.STATS.snapshot()
    prefix = "SeaweedFS_volumeServer_ec_recover_"
    assert delta.value("port", prefix + "bytes_total") == \
        snap["recovered_bytes"]
    assert delta.value("port", prefix + "cache_total", result="hit") == \
        snap["cache_hits"]
    assert delta.value("port", prefix + "cache_total", result="miss") == \
        snap["cache_misses"]
    assert delta.value("port", prefix + "spans_total", mode="solo") + \
        delta.value("port", prefix + "spans_total", mode="batched") == \
        snap["spans"]
    jev.close()
    tev.close()


def _span_forest(recorder) -> list:
    """Every kept trace as a tree of (name, service, status, tags,
    children), ids and times left out, in a canonical order."""
    def canon(node):
        kids = sorted((canon(c) for c in node["children"]), key=repr)
        return (node["name"], node["service"], node["status"],
                tuple(sorted((node.get("tags") or {}).items())), tuple(kids))

    out = []
    for entry in recorder.index(limit=10_000):
        tree = recorder.get(entry["trace_id"])
        out.append(tuple(sorted((canon(n) for n in tree["tree"]), key=repr)))
    return sorted(out, key=repr)


def test_degraded_read_spans_equal_jax(ec_volume_dir, tmp_path,
                                       monkeypatch):
    """With every trace sampled, one request span around each needle read
    holds the same ec.recover.serve / fetch / decode spans, with the same
    parents, services and tags, in both packages."""
    d, live = ec_volume_dir
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    monkeypatch.setenv("WEED_TRACE_MAX_TRACES", "10000")
    forests = []
    for mod, tr, name, kw in ((j_ecv, j_tracing, "jax", {}),
                              (t_ecv, t_tracing, "port",
                               {"device": "cpu"})):
        dd = str(tmp_path / name)
        shutil.copytree(d, dd)
        ev = _mount(mod, dd, LOST, **kw)
        tr.RECORDER.reset()
        for nid, (cookie, _) in sorted(live.items())[:12]:
            with tr.span("GET /read", service="volume",
                         tags={"fid": f"1,{nid:x}"}):
                ev.read_needle(nid, cookie=cookie)
        forests.append(_span_forest(tr.RECORDER))
        ev.close()
    assert forests[0] == forests[1]
    names = {n for f in forests[1] for tree in f for n in _names(tree)}
    assert {"ec.recover.serve", "ec.recover.fetch",
            "ec.recover.decode"} <= names


def _names(node):
    yield node[0]
    for kid in node[4]:
        yield from _names(kid)


def _store_pair(tmp_path, backends, vids=(1, 2), count=30):
    js = j_store.Store([str(tmp_path / "jax")],
                       ec_encoder_backend=backends[0])
    ts = t_store.Store([str(tmp_path / "port")],
                       ec_encoder_backend=backends[1], device="cpu")
    for store, mod in ((js, j_needle), (ts, t_needle)):
        for vid in vids:
            store.add_volume(vid)
            rng = np.random.default_rng(vid)
            for i in range(1, count + 1):
                n = mod.Needle.create(rng.bytes(int(rng.integers(1, 20000))))
                n.id, n.cookie = i, 7
                store.write_needle(vid, n)
    return js, ts


@pytest.mark.parametrize("backends", [("tpu", "cuda"), ("cpu", "cpu")])
def test_store_encode_moves_encode_bytes_equally(tmp_path, backends):
    """ec_generate_batch through the batched device pipeline (the port's
    on the CPU) and the host codec: EcEncodeBytesCounter moves by the
    volumes' .dat bytes in both packages."""
    js, ts = _store_pair(tmp_path, backends)
    dat = sum(os.path.getsize(ts.find_volume(v).file_name() + ".dat")
              for v in (1, 2))
    with _Delta(("SeaweedFS_volumeServer_ec_encode_bytes_total",)) as delta:
        js.ec_generate_batch([1, 2])
        ts.ec_generate_batch([1, 2])
    if backends[1] == "cuda":
        _both(delta)
        assert delta.value(
            "port", "SeaweedFS_volumeServer_ec_encode_bytes_total") == dat
    else:  # the per-volume host loop is not the batched pipeline
        assert delta.jax == delta.port == {}
    js.close()
    ts.close()


def test_host_pipeline_encode_counters_and_spans_equal_jax(tmp_path,
                                                          monkeypatch):
    """The host route of encode_volumes (the native codec's pipeline)
    counts its bytes and its write-back flushes, and records one
    ec.encode_volumes root with a child span per stage, in both."""
    from seaweedfs_tpu.ops import codec as j_codec
    from seaweedfs_tpu.parallel import batched_encode as j_be
    from seaweedfs_tpu_torch.ops import codec as t_codec
    from seaweedfs_tpu_torch.parallel import batched_encode as t_be

    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    monkeypatch.setenv("WEED_EC_WRITE_FLUSH_MB", "0.015625")  # 16 KiB
    rng = np.random.default_rng(3)
    blob = rng.bytes(300_000)
    bases = {}
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        bases[name] = str(tmp_path / name / "1")
        with open(bases[name] + ".dat", "wb") as f:
            f.write(blob)
    j_tracing.RECORDER.reset()
    t_tracing.RECORDER.reset()
    with _Delta(("SeaweedFS_volumeServer_ec_encode_bytes_total",
                 "SeaweedFS_volumeServer_ec_writeback_flushes_total")) \
            as delta:
        jc = j_be.encode_volumes([bases["jax"]], LARGE, SMALL,
                                 host_codec=j_codec.new_host_encoder())
        tc = t_be.encode_volumes([bases["port"]], LARGE, SMALL,
                                 host_codec=t_codec.new_host_encoder())
    assert jc[bases["jax"]] == tc[bases["port"]]
    _both(delta)
    assert delta.value(
        "port", "SeaweedFS_volumeServer_ec_encode_bytes_total") == len(blob)
    assert delta.value(
        "port", "SeaweedFS_volumeServer_ec_writeback_flushes_total") > 0
    jspans = j_tracing.RECORDER.aggregate("ec.encode")
    tspans = t_tracing.RECORDER.aggregate("ec.encode")
    assert {k: v["count"] for k, v in jspans.items()} == \
        {k: v["count"] for k, v in tspans.items()}
    assert "ec.encode_volumes" in tspans


def test_device_pool_families_mirror_the_pool():
    """The same lease / release / resident sequence through fresh pools
    of both packages moves the device-pool families equally, and the port's
    gauges equal its own snapshot."""
    pools = (j_pool.DevicePool(), t_pool.DevicePool())
    with _Delta(("SeaweedFS_volumeServer_device_pool_",
                 "SeaweedFS_volumeServer_ec_device_")) as delta:
        for pool in pools:
            a = pool.lease(("a", 4), lambda: bytearray(4 << 20), 4 << 20)
            b = pool.lease(("b", 2), lambda: bytearray(2 << 20), 2 << 20)
            pool.release(a)
            pool.lease(("a", 4), lambda: bytearray(4 << 20), 4 << 20)
            pool.acquire_resident(("r", 1), lambda: b"x", 1 << 20)
            pool.acquire_resident(("r", 1), lambda: b"x", 1 << 20)
            pool.release_resident(("r", 1))
            pool.discard(b)
            pool.note_h2d(123)
            pool.note_d2h(45)
    p = "SeaweedFS_volumeServer_device_pool_"
    # counters by delta; the gauges hold what the last pool published
    assert {k: v for k, v in delta.jax.items() if k[0].endswith("_total")} \
        == {k: v for k, v in delta.port.items() if k[0].endswith("_total")}
    assert delta.value("port", "SeaweedFS_volumeServer_ec_device_h2d_bytes"
                       "_total", device="host") == 123
    # (a device gauge of another placement keeps what an earlier pool
    # published there)
    gauges = [{k: v for k, v in _samples(m.REGISTRY.expose()).items()
               if k[0].startswith(p) and not k[0].endswith("_total")
               and ("device", "dev") not in k[1]}
              for m in (j_metrics, t_metrics)]
    assert gauges[0] == gauges[1]
    snap = pools[1].snapshot()
    text = _samples(t_metrics.REGISTRY.expose())
    assert text[(p + "bytes", ())] == snap["bytes"]
    assert text[(p + "hwm_bytes", ())] == snap["hwm_bytes"]
    for state, key in (("free", "free_slots"), ("leased", "leased_slots"),
                       ("resident", "resident_slabs")):
        assert text[(p + "slots", (("state", state),))] == snap[key]


def test_lanes_families_move_equally():
    """The same foreground and background calls on fresh lanes of both
    packages move the lane families equally."""
    lanes = (j_lanes.DeviceLanes(), t_lanes.DeviceLanes())
    with _Delta(("SeaweedFS_qos_lane_",)) as delta:
        for ln in lanes:
            with ln.foreground():
                pass
            for _ in range(3):
                ln.background_checkpoint()
    _both(delta)
    assert delta.value("port", "SeaweedFS_qos_lane_batches_total",
                       lane="background") == 3


def test_inline_writer_families_move_equally(tmp_path, monkeypatch):
    """The same needles through both packages' inline writers (host codec
    in the JAX package, K1's plain version in the port): committed stripes
    by kind, logical and physical bytes, the commit histogram's count and
    the write amplification move equally."""
    monkeypatch.setenv("WEED_EC_STRIPE_KB", "4")
    monkeypatch.setenv("WEED_EC_INLINE_FLUSH_MS", "100000")
    rng = np.random.default_rng(9)
    blobs = []
    for i in range(1, 60):
        n = t_needle.Needle.create(rng.bytes(int(rng.integers(10, 3000))))
        n.id, n.cookie = i, 3
        blobs.append((i, n.size, n.to_bytes()))
    writers = (j_inline.InlineEcWriter(str(tmp_path / "j"), create=True),
               t_inline.InlineEcWriter(str(tmp_path / "t"), create=True,
                                       device="cpu"))
    # the write-amp gauge holds whichever writer of the process committed
    # last, so its delta matches across packages only from equal starts:
    # earlier tests of the same process (test_torch_inline_ec.py drives
    # the packages through different sequences) leave the two registries'
    # gauges apart.  Both start from 0 here, so the deltas are the values.
    for mod in (j_metrics, t_metrics):
        mod.EcInlineWriteAmp.set(0.0)
    with _Delta(("SeaweedFS_ec_inline_",)) as delta:
        for w in writers:
            for nid, size, blob in blobs:
                w.append(nid, size, blob)
            w.drain(tail=True)
    # how many rows one commit batch takes depends on when the flusher
    # wakes, so the commit histogram's count is held against each
    # writer's own batches instead of across packages
    hist = ("SeaweedFS_ec_inline_stripe_commit_seconds_count", ())
    jn, tn = delta.jax.pop(hist), delta.port.pop(hist)
    _both(delta)
    tail = delta.value("port", "SeaweedFS_ec_inline_stripes_committed_total",
                       kind="tail")
    assert tn == writers[1].commit_batches + tail
    assert jn >= tail + 1
    tw = writers[1]
    assert delta.value("port", "SeaweedFS_ec_inline_stripes_committed_total",
                       kind="full") + \
        delta.value("port", "SeaweedFS_ec_inline_stripes_committed_total",
                    kind="tail") == tw.stripes_committed
    text = _samples(t_metrics.REGISTRY.expose())
    assert text[("SeaweedFS_ec_inline_write_amp", ())] == \
        round(tw.status()["write_amp"], 4)
    assert delta.value("port", "SeaweedFS_ec_inline_bytes_total",
                       kind="logical") == tw.logical_size
    for w in writers:
        w.close()


def test_rebuild_read_amp_families_move_equally():
    with _Delta(("SeaweedFS_volumeServer_maintenance_ec_rebuild_",)) \
            as delta:
        for codes in (j_codes, t_codes):
            codes.note_rebuild("pm_msr", 4096 * 9, 4096 * 3)
            codes.note_rebuild("pm_msr", 4096, 4096)
    assert {k: v for k, v in delta.jax.items() if "read_amp" not in k[0]} \
        == {k: v for k, v in delta.port.items() if "read_amp" not in k[0]}
    assert delta.value("port", "SeaweedFS_volumeServer_maintenance_ec_"
                       "rebuild_read_bytes_total", family="pm_msr") == \
        4096 * 10
    text = _samples(t_metrics.REGISTRY.expose())
    key = ("SeaweedFS_volumeServer_maintenance_ec_rebuild_read_amp",
           (("family", "pm_msr"),))
    assert abs(text[key] - t_codes.rebuild_read_amp_snapshot()[
        "pm_msr"]["read_amp"]) < 1e-4


def test_demotion_counts_equally(tmp_path):
    js, ts = _store_pair(tmp_path, (None, None), vids=(1,), count=2)

    def eio(*a, **kw):
        raise OSError(5, "Input/output error")

    with _Delta(("SeaweedFS_volume_readonly_demotions_total",)) as delta:
        for store, mod, err in ((js, j_needle, j_volume.VolumeError),
                                (ts, t_needle, t_volume.VolumeError)):
            store.find_volume(1).write_needle = eio
            n = mod.Needle.create(b"x")
            n.id, n.cookie = 50, 1
            with pytest.raises(err):
                store.write_needle(1, n)
    _both(delta)
    js.close()
    ts.close()


def test_fsync_group_commits_count_and_span_equally(tmp_path, monkeypatch):
    """Writes and deletes on an fsync volume, one writer: one group
    commit (and one fsync.group_commit span) per write in both."""
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    j_tracing.RECORDER.reset()
    t_tracing.RECORDER.reset()
    with _Delta(("SeaweedFS_volumeServer_fsync_batches_total",)) as delta:
        for mod, nmod, name in ((j_volume, j_needle, "j"),
                                (t_volume, t_needle, "t")):
            os.makedirs(tmp_path / name)
            v = mod.Volume(str(tmp_path / name), "", 1, fsync=True)
            _write_needles(v, nmod, 5, seed=2)
            v.delete_needle(nmod.Needle(id=3, cookie=0x1003))
            v.close()
    _both(delta)
    assert delta.value(
        "port", "SeaweedFS_volumeServer_fsync_batches_total") == 6
    assert j_tracing.RECORDER.aggregate("fsync")["fsync.group_commit"][
        "count"] == t_tracing.RECORDER.aggregate("fsync")[
        "fsync.group_commit"]["count"] == 6


def test_deep_scrub_counts_scrubbed_bytes_equally(ec_volume_dir, tmp_path):
    d, _ = ec_volume_dir
    reports = []
    with _Delta(("SeaweedFS_volumeServer_maintenance_scrubbed_bytes_total",)
                ) as delta:
        for mod, name, kw in ((j_scrub, "jax", {}),
                              (t_scrub, "port", {"device": "cpu"})):
            dd = str(tmp_path / name)
            shutil.copytree(d, dd)
            reports.append(mod.deep_scrub(
                [mod.local_target(os.path.join(dd, "1"), 1)], **kw))
    _both(delta)
    assert reports[0]["scrubbed_bytes"] == reports[1]["scrubbed_bytes"] == \
        delta.value("port",
                    "SeaweedFS_volumeServer_maintenance_scrubbed_bytes_total")


def test_injected_faults_count_and_journal_equally(tmp_path):
    """Loading fault rules writes a faults.active event, and each fired
    disk fault counts under its kind and rule, in both packages."""
    spec = "disk_error,side=disk,pct=50,route=write"
    with _Delta(("SeaweedFS_faults_injected_total",
                 "SeaweedFS_cluster_events_total")) as delta:
        for faults in (j_faults, t_faults):
            reg = faults.FaultRegistry()
            reg.configure(spec, seed=7)
            for i in range(40):
                try:
                    reg.on_disk(f"/v/{i}.ec00", "write")
                except OSError:
                    pass
            faults._set_active(False)
    _both(delta)
    assert delta.value("port", "SeaweedFS_cluster_events_total",
                       kind="faults.active") == 1
    assert delta.value("port", "SeaweedFS_faults_injected_total",
                       kind="disk_error", rule="disk_error#0") > 0


def test_event_journal_counts_equally():
    with _Delta(("SeaweedFS_cluster_events_total",)) as delta:
        for ev in (j_events, t_events):
            j = ev.EventJournal()
            for kind in (ev.NODE_UP, ev.NODE_DOWN, ev.NODE_UP):
                j.emit(kind, service="volume", node="n1")
    _both(delta)


def test_access_recorder_counts_equally():
    """The same 200 accesses through a fresh recorder of each package:
    the per-op record counter and the tracked-keys and sketch-bytes
    gauges move equally, and the summaries are equal."""
    recs = (j_access.AccessRecorder(node="n", now=lambda: 100.0),
            t_access.AccessRecorder(node="n", now=lambda: 100.0))
    rng = np.random.default_rng(4)
    ops = [("read" if rng.random() < 0.7 else "write",
            f"1,{int(rng.zipf(1.3)) % 50:x}", int(rng.integers(1, 5000)))
           for _ in range(200)]
    with _Delta(("SeaweedFS_access_",)) as delta:
        for rec in recs:
            for op, fid, n in ops:
                rec.record(op, collection="c", volume=1, fid=fid, nbytes=n,
                           latency_s=0.001, qos_class="interactive")
            rec.summary()
    _both(delta)
    assert recs[0].summary() == recs[1].summary()


def test_trace_retention_counts_equally(monkeypatch):
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    with _Delta(("SeaweedFS_trace_traces_total",)) as delta:
        for tr in (j_tracing, t_tracing):
            for _ in range(3):
                with tr.span("root", service="s"):
                    with tr.span("child"):
                        pass
    _both(delta)
    assert delta.value("port", "SeaweedFS_trace_traces_total",
                       result="kept") == 3


def test_metric_updates_are_thread_safe():
    """Eight threads incrementing one counter child and observing one
    histogram lose no update."""
    reg = t_metrics.Registry()
    c = reg.counter("t_total", "n", ("k",))
    h = reg.histogram("t_seconds", "lat")

    def work():
        child = c.labels("a")
        for _ in range(500):
            child.inc()
            h.observe(0.01)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fams = strict_parse(reg.expose())
    assert fams["t_total"]["samples"][0][2] == 4000
    assert [s for s in fams["t_seconds"]["samples"]
            if s[0] == "t_seconds_count"][0][2] == 4000


# -- sketches -----------------------------------------------------------------


def _stream(seed: int, n: int = 5000, keys: int = 800):
    rng = np.random.default_rng(seed)
    return [f"3,{int(k) % keys:x}" for k in rng.zipf(1.2, n)]


@pytest.mark.parametrize("seed", range(3))
def test_space_saving_equal_jax(seed):
    """Top-K heavy hitters: the same seeded Zipf stream (more keys than
    counters, so evictions happen), decay and merge give the same
    counters, errors and wire form."""
    out = []
    for mod in (j_sketch, t_sketch):
        a, b = mod.SpaceSaving(64), mod.SpaceSaving(64)
        for i, key in enumerate(_stream(seed)):
            (a if i % 3 else b).offer(key, 1.0 + (i % 5) / 4)
        a.scale(0.5)
        a.merge(b)
        out.append((a.top(20), a.to_dict(),
                    mod.SpaceSaving.from_dict(a.to_dict()).top(20),
                    a.estimate("3,1"), a.error("3,1")))
    assert out[0] == out[1]


@pytest.mark.parametrize("p", [4, 10, 14])
def test_hyperloglog_equal_jax(p):
    out = []
    for mod in (j_sketch, t_sketch):
        a, b = mod.HyperLogLog(p), mod.HyperLogLog(p)
        for i, key in enumerate(_stream(p, keys=3000)):
            (a if i % 2 else b).add(key)
        a.merge(b)
        out.append((a.estimate(), a.to_dict(),
                    mod.HyperLogLog.from_dict(a.to_dict()).estimate()))
    assert out[0] == out[1]
    assert mod._hash64("3,1") == j_sketch._hash64("3,1")


@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_log_quantile_equal_jax(alpha):
    rng = np.random.default_rng(int(alpha * 100))
    values = np.concatenate([rng.lognormal(-7, 1.5, 3000), [0.0, 0.0]])
    out = []
    for mod in (j_sketch, t_sketch):
        a, b = mod.LogQuantile(alpha), mod.LogQuantile(alpha)
        for i, v in enumerate(values):
            (a if i % 2 else b).observe(float(v), 1.0 + i % 3)
        a.merge(b)
        a.scale(0.75)
        out.append(([a.quantile(q) for q in (0, .5, .9, .99, 1)], a.mean(),
                    a.to_dict(), mod.from_dict(a.to_dict()).quantile(0.5)))
    assert out[0] == out[1]
