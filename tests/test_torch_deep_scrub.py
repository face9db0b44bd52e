"""The port's deep scrub against the JAX package's: the cases of
tests/test_deep_scrub.py, each scrubbing the same files with both
packages and requiring equal verdicts.  The port recomputes parity
through its pooled parity step on the CPU (K1's plain version)."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.maintenance import deep_scrub as t_ds
from seaweedfs_tpu_torch.storage.erasure_coding import TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.storage.erasure_coding.encoder import (
    save_volume_info, write_ec_files)
from seaweedfs_tpu_torch.storage.tools import (shard_file_crc32c,
                                               verify_shard_files)

# the JAX package's maintenance/__init__ exports a deep_scrub function
# that shadows the module's name
j_ds = importlib.import_module("seaweedfs_tpu.maintenance.deep_scrub")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, and the slab pool emptied after the module (the
    test workers share their machine)."""
    from seaweedfs_tpu_torch.ops.device_pool import reset_pool

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_pool()


def _make_volume(directory, vid, n_bytes, seed=0):
    base = os.path.join(str(directory), str(vid))
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes())
    crcs = write_ec_files(base, batched=True, device="cpu")
    save_volume_info(base, version=3, extra={"shard_crc32c": crcs})
    return base


def _flip(path, offset, mask=0xFF):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _both(targets_of, device="cpu", **kw):
    """Scrub with each package (fresh targets each), the port on `device`
    (one device or a list) -> (port, jax)."""
    t_st, j_st = {}, {}
    got = t_ds.deep_scrub(targets_of(t_ds), device=device, stage_stats=t_st,
                          **kw)
    want = j_ds.deep_scrub(targets_of(j_ds), stage_stats=j_st, **kw)
    assert got["volumes"] == want["volumes"]
    assert got["corrupt"] == want["corrupt"]
    assert got["scrubbed_bytes"] == want["scrubbed_bytes"]
    return got, want, t_st, j_st


def _host_both(directory, vid, **kw):
    got = t_ds.deep_scrub_host(str(directory), "", vid, device="cpu", **kw)
    want = j_ds.deep_scrub_host(str(directory), "", vid, **kw)
    assert got == want
    return got


class TestDeviceVsHost:
    def test_clean_volumes_verify_on_both_paths(self, tmp_path):
        base = _make_volume(tmp_path, 1, (2 << 20) + 999, seed=1)
        out, _, st, _ = _both(lambda m: [m.local_target(base, 1)])
        v = out["volumes"][0]
        assert v["ok"] and v["recomputed"] and out["corrupt"] == []
        assert out["backend"] == "device-pooled"
        host = _host_both(tmp_path, 1, needle_walk=False)
        assert host["corrupt"] == [] and host["missing"] == []

    def test_both_paths_flag_the_same_corrupt_shards(self, tmp_path):
        base = _make_volume(tmp_path, 1, (2 << 20) + 1234, seed=2)
        _flip(base + ".ec04", 4096)   # data shard
        _flip(base + ".ec11", 100)    # parity shard
        out, _, _, _ = _both(lambda m: [m.local_target(base, 1)])
        host = _host_both(tmp_path, 1, needle_walk=False)
        assert out["volumes"][0]["corrupt"] == host["corrupt"] == [4, 11]
        assert out["volumes"][0]["parity_mismatch"] == []

    def test_missing_shard_reported_not_crashed(self, tmp_path):
        base = _make_volume(tmp_path, 1, 1 << 20, seed=3)
        os.unlink(base + ".ec06")
        out, _, _, _ = _both(lambda m: [m.local_target(base, 1)])
        v = out["volumes"][0]
        assert v["missing"] == [6]
        assert not v["recomputed"] and v["corrupt"] == []
        assert _host_both(tmp_path, 1, needle_walk=False)["missing"] == [6]

    def test_parity_record_drift_caught_only_by_recompute(self, tmp_path):
        """A parity file flipped AND its file CRC laundered into the .vif:
        the file-CRC sweep passes, the recompute flags it."""
        base = _make_volume(tmp_path, 1, (1 << 20) + 77, seed=4)
        _flip(base + ".ec12", 2000)
        with open(base + ".vif") as f:
            info = json.load(f)
        info["shard_crc32c"][12] = shard_file_crc32c(base + ".ec12")
        with open(base + ".vif", "w") as f:
            json.dump(info, f)
        host = _host_both(tmp_path, 1, needle_walk=False)
        assert host["corrupt"] == [] and host["ok"]
        out, _, _, _ = _both(lambda m: [m.local_target(base, 1)])
        v = out["volumes"][0]
        assert v["parity_mismatch"] == [12] and not v["ok"]
        assert out["corrupt"] == [{"volume": 1, "shards": [12]}]


class TestCrossVolumeBatching:
    def test_many_volumes_share_one_geometry(self, tmp_path):
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 333,
                              seed=10 + i) for i in range(5)]
        _flip(bases[2] + ".ec01", 50)
        out, _, st, j_st = _both(
            lambda m: [m.local_target(b, i + 1) for i, b in enumerate(bases)])
        assert st["backend"] == "device-pooled"
        assert st["k_shapes"] == j_st["k_shapes"] == [10]
        # spans of several volumes shared dispatches (the JAX package
        # rounds its batch up to its mesh width)
        assert st["batch_units"] > 1 and st["batches"] < 5
        assert {c["volume"]: c["shards"] for c in out["corrupt"]} == {3: [1]}
        assert all(v["recomputed"] for v in out["volumes"])
        assert st["wall"] > 0
        for k in ("read_frac", "dispatch_frac", "encode_crc_frac"):
            assert 0.0 <= st[k] <= 1.0
        assert st["pool"]["allocs"] >= 0

    def test_parity_steps_are_counted_for_the_device_report(self,
                                                           tmp_path):
        """Every parity-step call of a scrub adds one to the process's
        count, which the device report (/debug/pprof/device) carries
        beside the kernel launches; on the CPU the plain version runs
        and no launch is counted."""
        from seaweedfs_tpu_torch import profiling
        from seaweedfs_tpu_torch.ops import rs_cuda

        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 77,
                              seed=30 + i) for i in range(3)]
        before = profiling.device_timeline()
        launches = dict(rs_cuda.launches)
        st = {}
        t_ds.deep_scrub([t_ds.local_target(b, i + 1)
                         for i, b in enumerate(bases)], device="cpu",
                        stage_stats=st, batch_units=2)
        after = profiling.device_timeline()
        assert st["batches"] > 1
        assert after["scrub_steps"] - before["scrub_steps"] == \
            st["batches"]
        assert after["launches"] == launches == dict(rs_cuda.launches)

    def test_throttle_sees_every_span_byte(self, tmp_path):
        base = _make_volume(tmp_path, 1, 1 << 20, seed=20)
        seen_t, seen_j = [], []
        got = t_ds.deep_scrub([t_ds.local_target(base, 1)], device="cpu",
                              throttle=seen_t.append)
        want = j_ds.deep_scrub([j_ds.local_target(base, 1)],
                               throttle=seen_j.append)
        total = sum(os.path.getsize(base + f".ec{sid:02d}")
                    for sid in range(TOTAL_SHARDS_COUNT))
        assert sum(seen_t) == sum(seen_j) == total
        assert got["scrubbed_bytes"] == want["scrubbed_bytes"] == total

    def test_unreadable_reader_degrades_to_verdict(self, tmp_path):
        base = _make_volume(tmp_path, 1, 1 << 20, seed=21)

        def flaky(mod):
            good = mod.local_target(base, 1)

            def reader(sid, off, size):
                if sid == 3:
                    raise OSError("disk went away")
                return good.reader(sid, off, size)

            return [mod.ScrubTarget(volume=1, collection="",
                                    stored=list(good.stored),
                                    sizes=list(good.sizes), reader=reader)]

        out, _, _, _ = _both(flaky)
        v = out["volumes"][0]
        assert v["unreadable"] == [3]
        assert not v["recomputed"] and 3 not in v["corrupt"]
        assert not v["ok"]

    @pytest.mark.parametrize("sid", [3, 12])
    def test_unreachable_remote_shard_degrades_to_verdict(self, tmp_path,
                                                         sid):
        """F6: the maintenance worker's reader raises the RPC layer's
        error for a shard no peer serves; both packages report the shard
        unreadable (the port raised out of the scrub before)."""
        from seaweedfs_tpu.rpc.http_rpc import RpcError as JRpcError
        from seaweedfs_tpu_torch.rpc.http_rpc import RpcError as TRpcError

        base = _make_volume(tmp_path, 1, 1 << 20, seed=22)

        def unreachable(mod):
            good = mod.local_target(base, 1)
            err = TRpcError if mod is t_ds else JRpcError

            def reader(shard, off, size):
                if shard == sid:
                    raise err(f"shard 1.{shard} unreachable", 502)
                return good.reader(shard, off, size)

            return [mod.ScrubTarget(volume=1, collection="",
                                    stored=list(good.stored),
                                    sizes=list(good.sizes), reader=reader)]

        out, _, _, _ = _both(unreachable)
        v = out["volumes"][0]
        assert v["unreadable"] == [sid] and not v["ok"]
        assert v["recomputed"] is (sid >= 10)


class TestStageTimersAndSpans:
    """The port's scrub times its stages where the work happens, on the
    clock its spans share (perf_counter_ns), and opens a background
    `maint.deep_scrub` span with three children per batch.  The JAX
    package has neither; the verdicts stay equal (the `_both` cases)."""

    def test_stage_stats_nest_and_stay_within_the_wall(self, tmp_path):
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 91,
                              seed=40 + i) for i in range(3)]
        _flip(bases[1] + ".ec12", 7)
        got, _, st, _ = _both(
            lambda m: [m.local_target(b, i + 1) for i, b in enumerate(bases)],
            batch_units=2)
        assert got["corrupt"] == [{"volume": 2, "shards": [12]}]
        leaves = t_ds.READ_LEAVES + t_ds.COMPLETE_LEAVES + (
            "dispatch", "lane_wait", "setup", "finish")
        for k in leaves + ("read", "encode_crc", "wall"):
            assert st[k] >= 0.0, k
        assert st["batches"] > 1
        # the read leaves are worker-seconds, inside the tasks' own
        # seconds, which the pool's workers spend within the caller's wait
        assert sum(st[k] for k in t_ds.READ_LEAVES) <= st["read_busy"]
        assert st["read_busy"] <= \
            st["read"] * st["read_workers"] + 0.002
        assert st["parity_wait"] + st["parity_crc"] <= \
            st["encode_crc"] + 0.002
        # the caller's own stages follow one another within the wall
        assert sum(st[k] for k in ("read", "lane_wait", "dispatch",
                                   "encode_crc", "setup", "finish")) <= \
            st["wall"] + 0.002
        assert st["pread"] > 0 and st["span_crc"] > 0
        assert st["parity_crc"] > 0
        # local targets fill their stage rows in place: nothing is copied
        assert st["stage_copy"] == 0 and st["read_copied_bytes"] == 0
        assert st["read_direct_bytes"] > 0
        # the card's event times are absent on the CPU
        assert not any(k.startswith("device_") for k in st)

    def test_pread_counts_the_reader_time(self, tmp_path):
        """A reader that sleeps 10 ms per span puts at least 10 ms per read
        into `pread` (a lower bound alone: no wall-clock upper bound)."""
        import time

        base = _make_volume(tmp_path, 1, 1 << 20, seed=41)
        reads = []

        def slow(mod):
            good = mod.local_target(base, 1)

            def reader(sid, off, size):
                reads.append(sid)
                time.sleep(0.010)
                return good.reader(sid, off, size)

            return [mod.ScrubTarget(volume=1, collection="",
                                    stored=list(good.stored),
                                    sizes=list(good.sizes), reader=reader,
                                    close=good.close)]

        st = {}
        out = t_ds.deep_scrub(slow(t_ds), device="cpu", stage_stats=st)
        assert out["volumes"][0]["ok"]
        assert len(reads) >= TOTAL_SHARDS_COUNT
        assert st["pread"] >= 0.010 * len(reads)
        assert st["read_busy"] >= st["pread"]
        assert st["read"] * st["read_workers"] >= st["pread"]

    def test_scrub_records_a_root_with_three_spans_per_batch(
            self, tmp_path, monkeypatch):
        from seaweedfs_tpu_torch import tracing

        monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
        tracing.RECORDER.reset()
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 13,
                              seed=50 + i) for i in range(2)]
        st = {}
        out = t_ds.deep_scrub([t_ds.local_target(b, i + 1)
                               for i, b in enumerate(bases)], device="cpu",
                              stage_stats=st, batch_units=1)
        assert tracing.current() is None
        index = tracing.RECORDER.index()
        assert [e["root"] for e in index] == ["maint.deep_scrub"]
        tree = tracing.RECORDER.get(index[0]["trace_id"])
        (root,) = tree["tree"]
        assert root["tags"] == {"volumes": 2, "qos_class": "background",
                                "bytes": out["scrubbed_bytes"],
                                "batches": st["batches"],
                                "backend": "device-pooled",
                                "read_workers": st["read_workers"],
                                "crc_card_bytes": st["crc_card_bytes"],
                                "crc_host_bytes": 0,
                                "read_direct_bytes": out["scrubbed_bytes"],
                                "read_copied_bytes": 0}
        kids = root["children"]
        names = sorted({c["name"] for c in kids})
        assert names == ["scrub.batch.complete", "scrub.batch.dispatch",
                         "scrub.batch.read"]
        assert len(kids) == 3 * st["batches"]
        for name in names:
            assert sum(c["name"] == name for c in kids) == st["batches"]
        # duration_ms is rounded to the microsecond
        r0 = root["mono_start_ns"]
        r1 = r0 + root["duration_ms"] * 1e6
        for c in kids:
            assert c["children"] == []
            assert r0 <= c["mono_start_ns"]
            assert c["mono_start_ns"] + c["duration_ms"] * 1e6 <= r1 + 1e3
        reads = [c for c in kids if c["name"] == "scrub.batch.read"]
        for k in t_ds.READ_LEAVES:
            assert sum(c["tags"][k] for c in reads) == \
                pytest.approx(st[k], abs=1e-5)
        tracing.RECORDER.reset()

    def test_slow_scrub_keeps_its_fast_batch_spans_unsampled(
            self, tmp_path, monkeypatch):
        """With sampling off, a scrub slower than WEED_TRACE_SLOW_MS is
        kept whole: its per-batch spans, each fast, join the trace after
        the root decided to keep it (here the time goes to the target's
        close, outside every batch span)."""
        import time

        from seaweedfs_tpu_torch import tracing

        monkeypatch.setenv("WEED_TRACE_SAMPLE", "0")
        monkeypatch.setenv("WEED_TRACE_SLOW_MS", "1000")
        tracing.RECORDER.reset()
        base = _make_volume(tmp_path, 1, 1 << 20, seed=60)
        target = t_ds.local_target(base, 1)
        real_close = target.close

        def slow_close():
            time.sleep(1.05)
            real_close()

        target.close = slow_close
        st = {}
        t_ds.deep_scrub([target], device="cpu", stage_stats=st,
                        span_bytes=64 << 10, batch_units=4)
        (entry,) = tracing.RECORDER.index()
        assert entry["root"] == "maint.deep_scrub" and entry["slow"]
        tree = tracing.RECORDER.get(entry["trace_id"])
        kids = tree["tree"][0]["children"]
        assert st["batches"] > 1 and len(kids) == 3 * st["batches"]
        assert max(c["duration_ms"] for c in kids) < 1000
        tracing.RECORDER.reset()

    def test_concurrent_scrubs_count_every_parity_step(self, tmp_path):
        """Scrubs on more threads than cores, with a short switch
        interval, lose no update of the process's scrub totals, which
        the device report carries."""
        import sys
        import threading

        from seaweedfs_tpu_torch import profiling

        bases = [_make_volume(tmp_path, i + 1, 1 << 20, seed=70 + i)
                 for i in range(2)]
        n = 2 * (os.cpu_count() or 1) + 2
        before = profiling.device_timeline()["scrub_steps"]
        stats = [{} for _ in range(n)]

        def scrub(i):
            t_ds.deep_scrub([t_ds.local_target(bases[i % 2], i % 2 + 1)],
                            device="cpu", stage_stats=stats[i],
                            span_bytes=256 << 10, batch_units=1)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=scrub, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert all(st["batches"] == 4 for st in stats)
        after = profiling.device_timeline()["scrub_steps"]
        assert after - before == 4 * n

    def test_device_report_carries_the_scrub_device_seconds(self, tmp_path):
        """/debug/pprof/device reports the process's event-timed scrub
        seconds beside its parity-step calls: a scrub on the CPU adds its
        steps and no second (it records no event); a batch recorded with
        event seconds adds them."""
        from seaweedfs_tpu_torch import profiling

        base = _make_volume(tmp_path, 1, 1 << 20, seed=72)
        tl = profiling.device_timeline()
        assert set(tl["scrub_device_s"]) == {"h2d", "kernel", "d2h"}
        assert all(v >= 0.0 for v in tl["scrub_device_s"].values())
        st = {}
        t_ds.deep_scrub([t_ds.local_target(base, 1)], device="cpu",
                        stage_stats=st, span_bytes=256 << 10, batch_units=1)
        after = profiling.device_timeline()
        assert after["scrub_steps"] - tl["scrub_steps"] == st["batches"] > 1
        assert after["scrub_device_s"] == tl["scrub_device_s"]
        added = {"h2d": 0.25, "kernel": 0.5, "d2h": 0.125}
        profiling.record_scrub_batch(1, **added)
        last = profiling.device_timeline()
        assert last["scrub_steps"] == after["scrub_steps"] + 1
        for k, v in added.items():
            assert last["scrub_device_s"][k] - after["scrub_device_s"][k] \
                == pytest.approx(v, abs=2e-6)


def _pool_of(monkeypatch, workers):
    """Have the port's scrub read on `workers` threads: it takes half the
    cores it sees."""
    monkeypatch.setattr(t_ds, "available_cpu_count", lambda: 2 * workers)


def _slow_target(mod, base, vid, delay, reads=None):
    """A local target whose reader sleeps `delay()` seconds per span (so
    the tasks overlap on any machine, one core or many)."""
    import time

    good = mod.local_target(base, vid)

    def reader(sid, off, size):
        if reads is not None:
            reads.append(sid)
        time.sleep(delay())
        return good.reader(sid, off, size)

    return mod.ScrubTarget(volume=vid, collection="",
                           stored=list(good.stored), sizes=list(good.sizes),
                           reader=reader, close=good.close)


class TestReadWorkers:
    """A batch's read stage runs one task per shard on a pool of half the
    cores' threads (inline with one): each shard's spans are read and
    chained in offset order, and the results do not depend on the pool's
    size."""

    @pytest.mark.parametrize("workers", [1, 2, 4, 14])
    def test_worker_counts_give_the_same_chains_and_verdicts(
            self, tmp_path, monkeypatch, workers):
        _pool_of(monkeypatch, workers)
        sizes = [(1 << 20) + 77, (10 << 20) + 4321, (2 << 20) + 999]
        bases = [_make_volume(tmp_path, i + 1, n, seed=80 + i)
                 for i, n in enumerate(sizes)]
        _flip(bases[0] + ".ec04", 300_123)    # data shard, second span
        _flip(bases[2] + ".ec11", 1_000_000)  # parity shard, tail span
        # a data shard cut short mid-span: its stage rows are read short or
        # not at all, so the recompute sees their zeroed tails
        os.truncate(bases[2] + ".ec07", 456_789)
        made = {}

        def targets_of(mod):
            made[mod] = [mod.local_target(b, i + 1)
                         for i, b in enumerate(bases)]
            return made[mod]

        # 300 000-byte spans leave a short tail span in every shard
        out, _, st, _ = _both(targets_of, span_bytes=300_000, batch_units=2)
        assert st["read_workers"] == workers and st["batches"] > 1
        assert {c["volume"]: c["shards"] for c in out["corrupt"]} == \
            {1: [4], 3: [7, 11]}
        for got, want in zip(made[t_ds], made[j_ds]):
            assert got.chains == want.chains
            assert got.computed == want.computed
        # a clean volume's recomputed parity CRCs are the stored ones
        assert made[t_ds][1].computed == made[t_ds][1].stored[10:]

    def test_jittered_readers_keep_each_shard_in_offset_order(
            self, tmp_path, monkeypatch):
        import random

        _pool_of(monkeypatch, 4)
        rng = random.Random(7)
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 555,
                              seed=90 + i) for i in range(2)]
        targets = [_slow_target(t_ds, b, i + 1,
                                lambda: rng.random() * 0.003)
                   for i, b in enumerate(bases)]
        st = {}
        out = t_ds.deep_scrub(targets, device="cpu", stage_stats=st,
                              span_bytes=128 << 10, batch_units=3)
        assert st["batches"] > 1
        for t, v in zip(targets, out["volumes"]):
            assert t.chains == t.stored and v["ok"] and v["recomputed"]

    def test_read_busy_counts_the_overlapped_worker_seconds(
            self, tmp_path, monkeypatch):
        _pool_of(monkeypatch, 4)
        base = _make_volume(tmp_path, 1, 1 << 20, seed=95)
        reads = []
        st = {}
        out = t_ds.deep_scrub(
            [_slow_target(t_ds, base, 1, lambda: 0.005, reads)],
            device="cpu", stage_stats=st, span_bytes=256 << 10)
        assert out["volumes"][0]["ok"]
        assert st["read_workers"] == 4
        assert st["read_busy"] >= 0.005 * len(reads)
        # 14 tasks on 4 workers: the caller waits for about 4 of them
        assert st["read"] <= 0.6 * st["read_busy"]

    def test_failing_shards_under_a_pool_give_the_reference_verdicts(
            self, tmp_path, monkeypatch):
        """A data shard that goes unreadable mid-sweep and a parity shard
        that no peer serves, read by four workers, beside a clean volume
        that shares their batches."""
        from seaweedfs_tpu.rpc.http_rpc import RpcError as JRpcError
        from seaweedfs_tpu_torch.rpc.http_rpc import RpcError as TRpcError

        _pool_of(monkeypatch, 4)
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 99,
                              seed=96 + i) for i in range(2)]

        def failing(mod):
            good = mod.local_target(bases[0], 1)
            err = TRpcError if mod is t_ds else JRpcError

            def reader(sid, off, size):
                if sid == 3 and off >= 512 << 10:
                    raise OSError("disk went away")
                if sid == 12:
                    raise err(f"shard 1.{sid} unreachable", 502)
                return good.reader(sid, off, size)

            return [mod.ScrubTarget(volume=1, collection="",
                                    stored=list(good.stored),
                                    sizes=list(good.sizes), reader=reader),
                    mod.local_target(bases[1], 2)]

        out, _, st, _ = _both(failing, span_bytes=256 << 10, batch_units=3)
        assert st["read_workers"] == 4
        bad, clean = out["volumes"]
        assert bad["unreadable"] == [3, 12] and not bad["recomputed"]
        assert not bad["ok"] and clean["ok"] and clean["recomputed"]

    def test_workers_read_under_the_callers_class_deadline_and_span(
            self, tmp_path, monkeypatch):
        """A reader that fetches from a peer runs on a pool thread with the
        caller's QoS class, deadline and its batch's read span (the parent
        of a peer fetch's span), as inline."""
        from seaweedfs_tpu_torch import qos, tracing
        from seaweedfs_tpu_torch.qos import classify
        from seaweedfs_tpu_torch.rpc.http_rpc import (current_deadline,
                                                      deadline_scope)

        _pool_of(monkeypatch, 4)
        base = _make_volume(tmp_path, 1, 1 << 20, seed=97)
        good = t_ds.local_target(base, 1)
        seen = set()

        def reader(sid, off, size):
            span = tracing.current()
            seen.add((classify.current_class(), current_deadline(),
                      span.name if span else None))
            return good.reader(sid, off, size)

        with qos.qos_scope(qos.BACKGROUND, tenant="maintenance"), \
                deadline_scope(600):
            want = current_deadline()
            out = t_ds.deep_scrub(
                [t_ds.ScrubTarget(volume=1, collection="",
                                  stored=list(good.stored),
                                  sizes=list(good.sizes), reader=reader,
                                  close=good.close)],
                device="cpu", span_bytes=256 << 10)
        assert out["volumes"][0]["ok"]
        assert seen == {(qos.BACKGROUND, want, "scrub.batch.read")}

    def test_a_shared_pacer_debits_every_byte_from_the_workers(
            self, tmp_path, monkeypatch):
        """A lost update of the pacer's totals would break the sums."""
        import sys
        import threading

        from seaweedfs_tpu_torch.maintenance.pacer import BytePacer

        _pool_of(monkeypatch, 4)
        bases = [_make_volume(tmp_path, i + 1, 1 << 20, seed=98 + i)
                 for i in range(2)]
        pacer = BytePacer(rate_bytes=4 << 20)
        clock, slept, lock = [0.0], [], threading.Lock()

        def sleep(s):
            with lock:
                slept.append(s)
                clock[0] += s

        pacer.now = lambda: clock[0]
        pacer.sleep = sleep
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            out = t_ds.deep_scrub([t_ds.local_target(b, i + 1)
                                   for i, b in enumerate(bases)],
                                  device="cpu", throttle=pacer.throttle,
                                  span_bytes=256 << 10)
        finally:
            sys.setswitchinterval(old)
        total = sum(os.path.getsize(b + f".ec{sid:02d}")
                    for b in bases for sid in range(TOTAL_SHARDS_COUNT))
        assert pacer.paced_bytes == out["scrubbed_bytes"] == total
        assert slept and pacer.throttled_seconds == \
            pytest.approx(sum(slept))


def _file_crcs(base, sizes):
    """The CRC32C of each present shard file, read whole on the host."""
    from seaweedfs_tpu_torch.ops import crc32c as crc_host

    out = []
    for sid in range(TOTAL_SHARDS_COUNT):
        if sizes[sid] < 0:
            out.append(0)
            continue
        with open(base + f".ec{sid:02d}", "rb") as f:
            out.append(crc_host.crc32c(f.read(sizes[sid])))
    return out


def _parity_crcs(base, sizes):
    """The CRC32C of each parity row recomputed on the host from the data
    shard files (zero-padded to the longest shard), cut to its parity
    file's length (the longest shard's where the file is missing)."""
    from seaweedfs_tpu_torch.ops import crc32c as crc_host
    from seaweedfs_tpu_torch.ops.gf256 import parity_matrix
    from seaweedfs_tpu_torch.ops.rs_cuda import gf_apply_plain

    longest = max(sizes)
    data = np.zeros((10, longest), dtype=np.uint8)
    for sid in range(10):
        with open(base + f".ec{sid:02d}", "rb") as f:
            raw = f.read(sizes[sid])
        data[sid, :len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    par = gf_apply_plain(parity_matrix(10, 14), torch.from_numpy(data))
    return [crc_host.crc32c(par[j].numpy()[:sizes[10 + j]
                                           if sizes[10 + j] >= 0
                                           else longest])
            for j in range(4)]


def _case_volumes(tmp_path, case):
    """(bases, span_bytes) of one case; the files altered as it says."""
    if case == "several_targets":
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 4099,
                              seed=110 + i) for i in range(3)]
        _flip(bases[1] + ".ec02", 123_457)
        return bases, 96 << 10
    base = _make_volume(tmp_path, 1, (2 << 20) + 3 * 1111, seed=120)
    if case == "flipped":
        _flip(base + ".ec04", 200_001)
        _flip(base + ".ec13", 77)
    elif case == "truncated_data":
        os.truncate(base + ".ec06", 100_003)
    elif case == "truncated_parity":
        # a parity file shorter than the data shards: its recomputed row
        # runs on past the file in the span that holds the cut
        os.truncate(base + ".ec11", 150_001)
    elif case == "missing_parity":
        os.unlink(base + ".ec12")
    return [base], 64 << 10


class TestCardCrc:
    """Every CRC of a recompute batch comes from K8 (its plain version on
    the CPU) as raw images that the host finalizes and chains: the chains
    and the recomputed parity CRCs equal the JAX package's and the files'
    own CRCs, whatever the spans' lengths."""

    @pytest.mark.parametrize("case,n_dev", [
        pytest.param(case, n_dev,
                     id=case if n_dev == 1 else f"{case}-two_devices")
        for n_dev in (1, 2)
        for case in ("clean", "flipped", "truncated_data",
                     "truncated_parity", "missing_parity",
                     "several_targets")])
    def test_chains_and_parity_crcs_equal_jax_and_the_files(
            self, tmp_path, monkeypatch, case, n_dev):
        """On one device and split over two (each taking its half of a
        batch's units; in `truncated_parity` the second zeroes the parity
        tail)."""
        device = "cpu"
        if n_dev == 2:
            monkeypatch.setenv("WEED_EC_DEVICE_SHARD", "2")
            device = ["cpu", "cpu"]
        bases, span = _case_volumes(tmp_path, case)
        made = {}

        def targets_of(mod):
            made[mod] = [mod.local_target(b, i + 1)
                         for i, b in enumerate(bases)]
            return made[mod]

        # spans not dividing the shards leave a short tail span each
        out, want, st, _ = _both(targets_of, device=device, span_bytes=span,
                                 batch_units=3)
        # the batch rounded up to a whole number of units per device
        assert st["batch_units"] == {1: 3, 2: 4}[n_dev]
        for got, ref, base in zip(made[t_ds], made[j_ds], bases):
            assert got.chains == ref.chains
            assert got.computed == ref.computed
            assert got.chains == _file_crcs(base, got.sizes)
            assert got.computed == _parity_crcs(base, got.sizes)
        # every shard byte, and each recomputed parity row to its file's
        # length (the longest shard's where the file is missing)
        card = sum(sum(s for s in t.sizes if s >= 0)
                   + sum(s if s >= 0 else t.shard_len for s in t.sizes[10:])
                   for t in made[t_ds])
        assert st["crc_card_bytes"] == card
        assert st["crc_host_bytes"] == 0
        assert st["span_crc"] > 0 and st["parity_crc"] > 0
        verdicts = {v["volume"]: v for v in out["volumes"]}
        if case == "flipped":
            assert verdicts[1]["corrupt"] == [4, 13]
        elif case.startswith("truncated"):
            assert verdicts[1]["corrupt"] == [6 if "data" in case else 11]
        elif case == "missing_parity":
            assert verdicts[1]["missing"] == [12]
        elif case == "several_targets":
            assert st["batches"] > 1
            assert [v["ok"] for v in out["volumes"]] == [True, False, True]
        else:
            assert verdicts[1]["ok"]
            # the recompute matches the encode: the stored parity CRCs
            assert made[t_ds][0].computed == made[t_ds][0].stored[10:]

    def test_a_reader_failing_mid_sweep_keeps_the_second_chain(
            self, tmp_path):
        """A data shard that goes unreadable mid-sweep stops the
        recompute; its target is then chained again by the host's
        file-CRC sweep (PERF.md §7), as in the JAX package, and that
        sweep's bytes are the host's."""
        base = _make_volume(tmp_path, 1, (2 << 20) + 5, seed=130)
        made = {}

        def failing(mod):
            good = mod.local_target(base, 1)

            def reader(sid, off, size):
                if sid == 5 and off >= 128 << 10:
                    raise OSError("disk went away")
                return good.reader(sid, off, size)

            made[mod] = mod.ScrubTarget(volume=1, collection="",
                                        stored=list(good.stored),
                                        sizes=list(good.sizes),
                                        reader=reader)
            return [made[mod]]

        out, _, st, _ = _both(failing, span_bytes=64 << 10, batch_units=2)
        got, ref = made[t_ds], made[j_ds]
        assert (got.chains, got.computed) == (ref.chains, ref.computed)
        v = out["volumes"][0]
        assert v["unreadable"] == [5] and not v["recomputed"]
        assert not v["ok"] and v["corrupt"]
        assert st["crc_card_bytes"] > 0 and st["crc_host_bytes"] > 0

    def test_a_target_without_recompute_is_crcd_on_the_host(self, tmp_path):
        base = _make_volume(tmp_path, 1, 1 << 20, seed=131)
        os.unlink(base + ".ec03")
        st = {}
        out = t_ds.deep_scrub([t_ds.local_target(base, 1)], device="cpu",
                              stage_stats=st)
        assert out["volumes"][0]["missing"] == [3]
        assert st["crc_card_bytes"] == 0
        assert st["crc_host_bytes"] == sum(
            os.path.getsize(base + f".ec{sid:02d}")
            for sid in range(TOTAL_SHARDS_COUNT) if sid != 3)

    def test_a_flipped_parity_step_output_turns_the_verdict(
            self, tmp_path, monkeypatch):
        """One byte altered in the parity step's output (the benchmark's
        flip_k5 control) reads as a parity mismatch: the recomputed
        parity's CRC comes from the rows K1 wrote."""
        from seaweedfs_tpu_torch.parallel import mesh

        base = _make_volume(tmp_path, 1, (1 << 20) + 999, seed=132)
        real = mesh.gf_apply

        def flipped(matrix, data, out=None):
            res = real(matrix, data, out=out)
            res[0, data.shape[-1] // 2] ^= 0x5A
            return res

        monkeypatch.setattr(mesh, "gf_apply", flipped)
        st = {}
        out = t_ds.deep_scrub([t_ds.local_target(base, 1)], device="cpu",
                              stage_stats=st)
        v = out["volumes"][0]
        assert v["corrupt"] == [] and v["parity_mismatch"] == [10]
        assert not v["ok"]


def _bytes_form(t):
    """`t` with its `read_into` taken away: its spans come as `bytes`."""
    t.read_into = None
    return t


def _failing_target(base, vid, sid, from_off):
    """A local target whose shard `sid` fails from `from_off` on, through
    both its reader and its read_into."""
    good = t_ds.local_target(base, vid)

    def reader(s, off, size):
        if s == sid and off >= from_off:
            raise OSError("disk went away")
        return good.reader(s, off, size)

    def read_into(s, off, view):
        if s == sid and off >= from_off:
            raise OSError("disk went away")
        return good.read_into(s, off, view)

    return t_ds.ScrubTarget(volume=vid, collection="",
                            stored=list(good.stored),
                            sizes=list(good.sizes), reader=reader,
                            close=good.close, read_into=read_into)


class TestDirectRead:
    """A target with `read_into` has its spans read straight into their
    stage rows (no `bytes`, no `stage_copy`); chains, recomputed parity
    CRCs, verdicts and `bytes_read` are those of the `bytes` form, and
    one call may mix targets of both forms."""

    @pytest.mark.parametrize("case", ["short_tail", "missing_parity",
                                      "read_into_raises",
                                      "raises_from_the_start",
                                      "mixed_targets"])
    @pytest.mark.parametrize("workers", [1, 4])
    def test_the_direct_form_equals_the_bytes_form(
            self, tmp_path, monkeypatch, case, workers):
        _pool_of(monkeypatch, workers)
        bases = [_make_volume(tmp_path, 1, (2 << 20) + 3 * 1111, seed=140)]
        if case == "missing_parity":
            os.unlink(bases[0] + ".ec12")
        if case == "mixed_targets":
            bases.append(_make_volume(tmp_path, 2, (1 << 20) + 777,
                                      seed=141))
            _flip(bases[1] + ".ec05", 99_999)

        def targets(direct):
            if case == "read_into_raises":
                out = [_failing_target(bases[0], 1, 3, 400_000)]
            elif case == "raises_from_the_start":
                out = [_failing_target(bases[0], 1, 12, 0)]
            else:
                out = [t_ds.local_target(b, i + 1)
                       for i, b in enumerate(bases)]
            if not direct:
                return [_bytes_form(t) for t in out]
            if case == "mixed_targets":
                _bytes_form(out[1])
            return out

        runs = []
        for direct in (True, False):
            st = {}
            ts = targets(direct)
            # 300 000-byte spans leave a short, zero-tailed last span
            out = t_ds.deep_scrub(ts, device="cpu", stage_stats=st,
                                  span_bytes=300_000, batch_units=2)
            runs.append((out, ts, st))
        (got, direct, st), (want, plain, pst) = runs
        assert got == want
        for a, b in zip(direct, plain):
            assert (a.chains, a.computed, a.bytes_read, a.unreadable,
                    a.recompute) == (b.chains, b.computed, b.bytes_read,
                                     b.unreadable, b.recompute)
        # the bytes staged: every span of every batch, in either form
        staged = st["read_direct_bytes"] + st["read_copied_bytes"]
        assert staged == pst["read_copied_bytes"] > 0
        assert pst["read_direct_bytes"] == 0 and pst["stage_copy"] > 0
        v = got["volumes"][0]
        if case == "mixed_targets":
            assert st["read_direct_bytes"] == sum(
                os.path.getsize(bases[0] + f".ec{sid:02d}")
                for sid in range(TOTAL_SHARDS_COUNT))
            assert st["read_copied_bytes"] == direct[1].bytes_read
            assert got["corrupt"] == [{"volume": 2, "shards": [5]}]
        else:
            assert st["read_copied_bytes"] == 0 and st["stage_copy"] == 0
        if case == "read_into_raises":
            assert v["unreadable"] == [3] and not v["recomputed"]
            assert not v["ok"]
        elif case == "raises_from_the_start":
            assert v["unreadable"] == [12] and v["recomputed"]
            assert 12 not in v["corrupt"] and not v["ok"]
        elif case == "missing_parity":
            assert v["missing"] == [12] and v["recomputed"]
        else:
            assert v["ok"] and direct[0].computed == direct[0].stored[10:]
            assert direct[0].chains == _file_crcs(bases[0], direct[0].sizes)

    def test_the_root_span_carries_the_read_counts(self, tmp_path,
                                                   monkeypatch):
        from seaweedfs_tpu_torch import tracing

        monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
        tracing.RECORDER.reset()
        bases = [_make_volume(tmp_path, i + 1, (1 << 20) + i * 55,
                              seed=150 + i) for i in range(2)]
        st = {}
        t_ds.deep_scrub([t_ds.local_target(bases[0], 1),
                         _bytes_form(t_ds.local_target(bases[1], 2))],
                        device="cpu", stage_stats=st)
        (entry,) = [e for e in tracing.RECORDER.index(limit=1000)
                    if e["root"] == "maint.deep_scrub"]
        (root,) = tracing.RECORDER.get(entry["trace_id"])["tree"]
        for k in ("read_direct_bytes", "read_copied_bytes"):
            assert root["tags"][k] == st[k] > 0
        tracing.RECORDER.reset()

    def test_read_into_fills_past_partial_reads_and_stops_at_eof(
            self, tmp_path, monkeypatch):
        """preadv may return less than asked: the fill reads on from where
        it stopped, and returns what the file had."""
        base = _make_volume(tmp_path, 1, 1 << 20, seed=160)
        t = t_ds.local_target(base, 1)
        real = os.preadv
        calls = []

        def partial(fd, bufs, offset):
            calls.append(offset)
            (mv,) = bufs
            return real(fd, [mv[:1000]], offset)

        monkeypatch.setattr(os, "preadv", partial)
        size = t.sizes[4]
        with open(base + ".ec04", "rb") as f:
            whole = f.read()
        view = np.full(5000, 0xAB, dtype=np.uint8)
        assert t.read_into(4, 1234, view) == 5000
        assert view.tobytes() == whole[1234:6234] and len(calls) == 5
        tail = np.full(3000, 0xAB, dtype=np.uint8)
        assert t.read_into(4, size - 100, tail) == 100
        assert tail[:100].tobytes() == whole[-100:]
        assert (tail[100:] == 0xAB).all()
        t.close()


def test_host_scrub_needle_walk_and_verify_shard_files(tmp_path):
    """The needle walk reads every live needle of a needle volume in both
    packages, with shards lost; verify_shard_files classifies files."""
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    d = str(tmp_path)
    vol = Volume(d, "", 4)
    rng = np.random.default_rng(6)
    for i in range(1, 40):
        n = Needle.create(rng.bytes(int(rng.integers(1, 30_000))))
        n.id, n.cookie = i, 77
        vol.write_needle(n)
    vol.close()
    base = os.path.join(d, "4")
    crcs = encoder.write_ec_files(base, 10000, 100, device="cpu")
    encoder.write_sorted_file_from_idx(base)
    encoder.save_volume_info(base, version=3, extra={"shard_crc32c": crcs})
    os.unlink(base + ".ec02")
    _flip(base + ".ec07", 10)
    got = _host_both(tmp_path, 4)
    assert got["needles_checked"] == 39
    assert got["missing"] == [2] and got["corrupt"] == [7]
    assert got["needles_bad"] > 0 and not got["ok"]
    clean, corrupt, absent = verify_shard_files(base, crcs)
    assert (corrupt, absent) == ([7], [2]) and len(clean) == 12
    with pytest.raises(ValueError, match="no shard_crc32c"):
        verify_shard_files(base, None)
