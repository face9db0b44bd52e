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


def _both(targets_of, **kw):
    """Scrub with each package (fresh targets each) -> (port, jax)."""
    t_st, j_st = {}, {}
    got = t_ds.deep_scrub(targets_of(t_ds), device="cpu", stage_stats=t_st,
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
