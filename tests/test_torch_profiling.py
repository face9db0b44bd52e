"""The port's profiling module against the JAX package's: folded stacks
tagged with thread and route, the sampler's bookkeeping, the cluster merge,
and the device telemetry with its metric families.  Samples are taken by
calling the sampler's tick directly on a parked thread, so no case depends
on a timer firing or asserts a wall-clock time (the JAX package's
profiler-overhead ceilings are not ported)."""

import threading

import pytest

from seaweedfs_tpu import profiling as j_prof
from seaweedfs_tpu import tracing as j_tr
from seaweedfs_tpu.stats import metrics as j_metrics
from seaweedfs_tpu_torch import profiling as t_prof
from seaweedfs_tpu_torch import tracing as t_tr
from seaweedfs_tpu_torch.stats import metrics as t_metrics

BOTH = pytest.mark.parametrize("prof,tr", [(j_prof, j_tr), (t_prof, t_tr)],
                               ids=["jax", "port"])


def _parked_frame(ready, release):
    ready.set()
    release.wait(30)


class _Parked:
    """A named thread parked in `_parked_frame`, with `span` installed."""

    def __init__(self, tr, name: str, route: str = ""):
        self.ready, self.release = threading.Event(), threading.Event()

        def run():
            sp = tr.start(route, service="volume") if route else None
            prev = tr.swap(sp) if sp is not None else None
            try:
                _parked_frame(self.ready, self.release)
            finally:
                if sp is not None:
                    tr.restore(prev)

        self.thread = threading.Thread(target=run, name=name)

    def __enter__(self):
        self.thread.start()
        self.ready.wait(30)
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.thread.join(30)


def _keys_of(sampler, thread_name):
    return {k: v for k, v in sampler.samples.items()
            if k.startswith(thread_name + ";")}


def test_folded_stacks_equal_jax():
    """One tick over a parked thread gives the same folded key, tagged
    with the thread's name and its span's route, in both packages."""
    keys = []
    for prof, tr in ((j_prof, j_tr), (t_prof, t_tr)):
        with _Parked(tr, "parked-reader", route="GET /1,ab") as p:
            s = prof.StackSampler(hz=1, publish=False)
            s._sample_once(threading.get_ident())
            keys.append(_keys_of(s, "parked-reader"))
            assert p.thread.is_alive()
    assert keys[0] == keys[1]
    (key, count), = keys[1].items()
    assert count == 1
    parts = key.split(";")
    assert parts[:2] == ["parked-reader", "GET /1,ab"]
    assert any(part.startswith("_parked_frame (test_torch_profiling.py:")
               for part in parts)


@BOTH
def test_sampler_caps_and_publishes_routes(prof, tr, monkeypatch):
    """Past WEED_PROF_MAX_STACKS new stacks fold into "(truncated)"; a
    publishing sampler counts per-route samples in its registry."""
    metrics = j_metrics if prof is j_prof else t_metrics
    monkeypatch.setenv("WEED_PROF_MAX_STACKS", "1")
    route = f"GET /route-{prof.__name__}"
    before = metrics.ProfilerRouteSamplesCounter._values.get((route,), 0)
    with _Parked(tr, "a-thread", route=route), _Parked(tr, "b-thread"):
        s = prof.StackSampler(hz=1, publish=True)
        for _ in range(3):
            s._sample_once(threading.get_ident())
    assert len(s.samples) == 2 and s.truncated > 0
    assert s.samples[prof._TRUNCATED] == s.truncated
    assert s.route_samples[route] == 3
    assert metrics.ProfilerRouteSamplesCounter._values[(route,)] - \
        before == 3
    snap = s.snapshot()
    assert snap["samples"] == s.total and snap["stacks"] == 2
    folded = s.folded()
    assert folded.splitlines()[0].endswith(" %d" % max(s.samples.values()))
    top = s.top_frames(3)
    assert sum(t["samples"] for t in top) <= s.total


def test_merge_folded_equal_jax():
    profiles = {"volume": "a;b;c 3\na;b 2\n# comment\nbad line\n",
                "filer": "a;b;c 1\nx;y 5\n", "master": ""}
    assert j_prof.merge_folded(profiles) == t_prof.merge_folded(profiles)
    merged = t_prof.merge_folded(profiles)
    assert merged.splitlines()[0] == "filer;x;y 5"
    assert "volume;a;b;c 3" in merged


@BOTH
def test_fold_stack_depth_and_labels(prof, tr):
    def deep(n):
        if n == 0:
            import sys

            return prof.fold_stack(sys._getframe())
        return deep(n - 1)

    folded = deep(80)
    parts = folded.split(";")
    assert len(parts) == prof._MAX_DEPTH
    assert parts[-1].startswith("deep (test_torch_profiling.py:")
    assert all(";" not in p for p in parts)


@BOTH
def test_always_on_profiler_lifecycle(prof, tr, monkeypatch):
    """ensure_started is idempotent and follows WEED_PROF_HZ live (0
    parks the sampler); the gauges read it; stop joins it."""
    monkeypatch.setenv("WEED_PROF_HZ", "0")
    monkeypatch.setattr(prof, "_PROFILER", None)
    assert prof.profiler() is None
    assert prof.overhead_ratio() == 0.0 and prof.stack_count() == 0.0
    first = prof.ensure_started()
    try:
        assert prof.ensure_started() is first is prof.profiler()
        assert first._interval() == 0.0
        monkeypatch.setenv("WEED_PROF_HZ", "50")
        assert first._interval() == pytest.approx(0.02)
        assert prof.stack_count() == float(len(first.samples))
    finally:
        assert first.stop(timeout=5.0)


@BOTH
def test_profile_burst_returns_folded_text(prof, tr):
    text = prof.profile_burst(0.05, 100.0)
    assert isinstance(text, str)
    for line in text.splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack and int(count) > 0


def _kernel_samples(metrics):
    out = {}
    for name in ("SeaweedFS_volumeServer_ec_kernel_dispatch_ready_seconds",
                 "SeaweedFS_volumeServer_ec_kernel_flops",
                 "SeaweedFS_volumeServer_ec_kernel_bytes_accessed"):
        fam = metrics.REGISTRY._metrics[name]
        if fam.kind == "histogram":
            out[name] = {k: sum(v) for k, v in fam._counts.items()}
        else:
            out[name] = dict(fam._values)
    return out


def test_device_telemetry_and_kernel_families_equal_jax():
    """record_device_batch feeds the dispatch histogram (labelled by the
    device count) and the timeline; record_kernel_cost the flops and
    bytes gauges and the cost table, equally in both packages."""
    before = [_kernel_samples(m) for m in (j_metrics, t_metrics)]
    for prof in (j_prof, t_prof):
        prof.reset_device_telemetry()
        for i, devices in enumerate((1, 1, 2)):
            prof.record_device_batch(0.001 * (i + 1), units=4, k=10,
                                     devices=devices)
        prof.record_kernel_cost("k10xb6xw1048576", 2.5e8, 8.8e7,
                                extra={"route": "k1"})
    after = [_kernel_samples(m) for m in (j_metrics, t_metrics)]
    deltas = []
    for b, a in zip(before, after):
        hist = "SeaweedFS_volumeServer_ec_kernel_dispatch_ready_seconds"
        deltas.append({k: a[hist][k] - b[hist].get(k, 0) for k in a[hist]
                       if a[hist][k] != b[hist].get(k, 0)})
        for name in ("SeaweedFS_volumeServer_ec_kernel_flops",
                     "SeaweedFS_volumeServer_ec_kernel_bytes_accessed"):
            assert a[name][("k10xb6xw1048576",)] in (2.5e8, 8.8e7)
    assert deltas[0] == deltas[1] == {("1",): 2, ("2",): 1}
    timelines = [prof.device_timeline() for prof in (j_prof, t_prof)]
    for tl in timelines:
        for entry in tl["timeline"]:
            entry.pop("ts")
    assert timelines[0]["timeline"] == timelines[1]["timeline"]
    assert timelines[0]["kernel_cost"] == timelines[1]["kernel_cost"]
    assert [e["dispatch_ready_ms"] for e in timelines[1]["timeline"]] == \
        [1.0, 2.0, 3.0]
    for prof in (j_prof, t_prof):
        prof.reset_device_telemetry()
        assert prof.device_timeline()["timeline"] == []


def test_encode_pipeline_records_device_batches(tmp_path):
    """The port's batched encode on the CPU records one timeline entry per
    device batch and sets the cost gauges of its parity-step geometry."""
    import numpy as np

    from seaweedfs_tpu_torch.parallel import batched_encode

    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(1).bytes(200_000))
    t_prof.reset_device_telemetry()
    before = sum(sum(v) for v in t_metrics.EcKernelDispatchHistogram
                 ._counts.values())
    stats = {}
    batched_encode.encode_volumes([base], 10000, 100, mesh=["cpu"],
                                  stage_stats=stats)
    tl = t_prof.device_timeline()
    assert len(tl["timeline"]) == stats["kernel"]["batches"] > 0
    after = sum(sum(v) for v in t_metrics.EcKernelDispatchHistogram
                ._counts.values())
    assert after - before == stats["kernel"]["batches"]
    for geom in stats.get("kernel_cost", {}):
        assert t_metrics.EcKernelFlopsGauge._values[(geom,)] > 0
