"""The port's native engine binding (storage/native_engine.py) and its TCP
fast path against the JAX package's.

The port compiles its own copy of native/vol_native.cpp and loads that,
so the two packages in this process run two engines.  Held exact:

* the same operations through both packages' engine-backed volumes give
  byte-identical .dat and .idx files and the same reads;
* a second engine map over the same files tails the writer's .idx
  (refresh_from_idx, a prefork worker's view) to the state the JAX
  package's Python map reaches by its own tail;
* the port's VolumeTcpClient reads a port server and a JAX server alike,
  intact and degraded EC needles, and the JAX client reads the port's;
* the two engines share no state.
"""

import itertools
import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import native_engine as j_ne
from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import needle_map as j_nm
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.volume_server import server as j_server
from seaweedfs_tpu.wdclient import volume_tcp_client as j_tcp
from seaweedfs_tpu_torch.storage import native_engine as t_ne
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.volume_server import server as t_server
from seaweedfs_tpu_torch.wdclient import volume_tcp_client as t_tcp

LOST = (0, 5, 11, 13)


@pytest.fixture
def pinned_clock(monkeypatch):
    """time.time_ns as a counter restarted per package, so both stamp
    equal append times on equal writes."""
    state = {}
    lock = threading.Lock()

    def restart():
        state["ticks"] = itertools.count(1_700_000_000_000_000_000, 999_983)

    def fake():
        with lock:
            return next(state["ticks"])

    restart()
    monkeypatch.setattr(time, "time_ns", fake)
    return restart


def _ops(seed: int, count: int = 80):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(1, count + 1):
        ops.append(("write", i, 0x7000 + i,
                    rng.bytes(int(rng.integers(1, 5000)))))
        if i % 5 == 0:
            ops.append(("delete", i - 2, 0x7000 + i - 2, None))
        if i % 9 == 0:
            ops.append(("write", i - 1, 0x7000 + i - 1, rng.bytes(77)))
    return ops


def _apply(vol, needle_mod, ops):
    for kind, nid, cookie, data in ops:
        if kind == "write":
            n = needle_mod.Needle.create(data)
            n.id, n.cookie = nid, cookie
            vol.write_needle(n)
        else:
            vol.delete_needle(needle_mod.Needle(id=nid, cookie=cookie))


def _live(ops) -> dict:
    live = {}
    for kind, nid, cookie, data in ops:
        if kind == "write":
            live[nid] = (cookie, data)
        else:
            live.pop(nid, None)
    return live


def _read(vol, nid, cookie):
    try:
        return vol.read_needle(nid, cookie=cookie).data
    except Exception as e:  # noqa: BLE001 - the error class is compared
        return type(e).__name__


def test_both_packages_run_engine_maps():
    assert t_ne.available() and j_ne.available()
    assert os.path.dirname(t_ne.lib_path()).endswith(
        os.path.join("seaweedfs_tpu_torch", "_build"))
    assert t_ne.lib()._name == t_ne.lib_path() != j_ne._LIB_PATH


def test_engine_maps_files_identical_and_reads(tmp_path, pinned_clock):
    ops = _ops(3)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    tv = t_volume.Volume(str(tdir), "c", 4)
    _apply(tv, t_needle, ops)
    pinned_clock()
    jv = j_volume.Volume(str(jdir), "c", 4)
    _apply(jv, j_needle, ops)
    try:
        assert isinstance(tv.nm, t_ne.NativeNeedleMap)
        assert isinstance(jv.nm, j_ne.NativeNeedleMap)
        live = _live(ops)
        for nid in range(1, max(live) + 2):
            cookie = live.get(nid, (0x7000 + nid, None))[0]
            assert _read(tv, nid, cookie) == _read(jv, nid, cookie)
        assert [(k, v.offset, v.size) for k, v in tv.nm.items_ascending()] \
            == [(k, v.offset, v.size) for k, v in jv.nm.items_ascending()]
        assert (tv.file_count(), tv.deleted_count(), tv.content_size(),
                tv.deleted_size(), tv.max_file_key(),
                tv.last_append_at_ns) == \
            (jv.file_count(), jv.deleted_count(), jv.content_size(),
             jv.deleted_size(), jv.max_file_key(), jv.last_append_at_ns)
        tv.read_only = jv.read_only = True
        assert tv.read_only and jv.read_only
    finally:
        tv.close()
        jv.close()
    for ext in (".dat", ".idx"):
        assert (tdir / f"c_4{ext}").read_bytes() == \
            (jdir / f"c_4{ext}").read_bytes()


def test_engine_map_tails_the_idx_like_jax(tmp_path):
    """A second engine map over a volume's files (what a prefork worker
    holds) replays the writer's later appends, deletes included, to the
    state the JAX package's Python map reaches by refresh_from_idx."""
    ops = _ops(5, 40)
    v = t_volume.Volume(str(tmp_path), "", 6)
    _apply(v, t_needle, ops[:20])
    dat, idx = v.file_name(".dat"), v.file_name(".idx")
    reader = t_ne.NativeNeedleMap(dat, idx, v.version, False, True, False)
    jreader = j_nm.NeedleMap(idx)
    try:
        assert reader.refresh_from_idx() == 0
        _apply(v, t_needle, ops[20:])
        appended = (os.path.getsize(idx) - reader._idx_tail) // 16
        assert appended > 0
        assert reader.refresh_from_idx() == appended
        assert reader.refresh_from_idx() == 0
        assert jreader.refresh_from_idx() == appended
        for nid in range(1, 42):
            got, want = reader.get(nid), jreader.get(nid)
            assert (got is None) == (want is None), nid
            if got is not None:
                assert (got.offset, got.size) == (want.offset, want.size)
            mine = v.nm.get(nid)
            assert (mine is None) == (got is None)
            if got is not None:
                assert (mine.offset, mine.size) == (got.offset, got.size)
    finally:
        reader.close()
        jreader.close()
        v.close()


# -- the TCP fast path ------------------------------------------------------

def _dead_master() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.fixture
def two_tcp_servers(tmp_path, monkeypatch):
    """A port and a JAX volume server with the TCP fast path, each over
    its own copy of the same files: volume 1 EC-encoded with LOST gone,
    volume 2 intact."""
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    monkeypatch.setenv("WEED_MAINT", "0")
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(11)
    needles = {1: {}, 2: {}}
    store = Store([str(src)], ec_encoder_backend="torch", device="cpu")
    try:
        for vid in (1, 2):
            store.add_volume(vid)
            for nid in range(1, 31):
                data = rng.bytes(int(rng.integers(1, 200_000)))
                cookie = int(rng.integers(1, 1 << 32))
                n = Needle.create(data)
                n.id, n.cookie = nid, cookie
                store.write_needle(vid, n)
                needles[vid][f"{vid},{nid:x}{cookie:08x}"] = data
        store.ec_generate(1)
        store.delete_volume(1)
    finally:
        store.close()
    for sid in LOST:
        os.remove(src / ("1" + to_ext(sid)))
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    shutil.copytree(src, tdir)
    shutil.copytree(src, jdir)
    ts = t_server.VolumeServer([str(tdir)], _dead_master(), port=0,
                               device="cpu", enable_tcp=True,
                               pulse_seconds=3600)
    js = j_server.VolumeServer([str(jdir)], _dead_master(), port=0,
                               enable_tcp=True, pulse_seconds=3600)
    ts.start()
    js.start()
    try:
        yield ts, js, needles
    finally:
        ts.stop()
        js.stop()


def test_tcp_client_reads_port_and_jax_servers_alike(two_tcp_servers):
    ts, js, needles = two_tcp_servers
    assert ts.tcp_port > 0 and js.tcp_port > 0
    assert getattr(ts, "_native_owner", False)
    t_client, j_client = t_tcp.VolumeTcpClient(), j_tcp.VolumeTcpClient()
    try:
        before = t_ne.server_stats()
        jbefore = j_ne.server_stats()
        for vid in (1, 2):
            for fid, data in needles[vid].items():
                for client in (t_client, j_client):
                    assert client.read_needle(ts.address, fid) == data, fid
                    assert client.read_needle(js.address, fid) == data, fid
        for server in (ts, js):
            with pytest.raises((t_tcp.VolumeTcpError, j_tcp.VolumeTcpError)):
                t_client.read_needle(server.address, "2,ff12345678")
        after = t_ne.server_stats()
        # every read of the port's server ran on the port's engine: the
        # degraded EC needles through its recovery rows, on the host
        assert after["read"] - before["read"] == 2 * len(needles[2]) + 1
        assert after["ec_read"] - before["ec_read"] == 2 * len(needles[1])
        assert after["fallback"] == before["fallback"]
        if getattr(js, "_native_owner", False):
            jafter = j_ne.server_stats()
            assert jafter["ec_read"] - jbefore["ec_read"] == \
                2 * len(needles[1])
    finally:
        t_client.close()
        j_client.close()


def test_engines_share_no_state(two_tcp_servers):
    """Serving, JWT keys and counters of the port's engine are its own:
    the JAX engine's registry never learns the port's volumes."""
    ts, js, needles = two_tcp_servers
    assert t_ne.server_port() == ts.tcp_port
    assert j_ne.server_port() != ts.tcp_port
    jstats = j_ne.server_stats()
    client = t_tcp.VolumeTcpClient()
    try:
        fid = next(iter(needles[2]))
        assert client.read_needle(ts.address, fid) == needles[2][fid]
        assert j_ne.server_stats() == jstats
        # a read key on the port's engine guards the port's listener only
        t_ne.server_set_jwt(None, "port-only-key", 10)
        try:
            with pytest.raises(t_tcp.VolumeTcpError) as e:
                client.read_needle(ts.address, fid)
            assert e.value.status == 401
            if getattr(js, "_native_owner", False):
                assert client.read_needle(js.address, fid) == \
                    needles[2][fid]
        finally:
            t_ne.server_set_jwt(None, "", 10)
    finally:
        client.close()


def test_resource_pool_like_jax():
    """The TCP client's pool: the same borrow/give-back/broken/close
    sequence opens, reuses and closes the same resources in both
    packages."""
    from seaweedfs_tpu.wdclient import resource_pool as j_rp
    from seaweedfs_tpu_torch.wdclient import resource_pool as t_rp

    logs = {}
    for name, mod in (("t", t_rp), ("j", j_rp)):
        made, closed = itertools.count(1), []
        pool = mod.ResourcePool(lambda: next(made), closed.append,
                                max_open=3, max_idle=1, borrow_timeout=0.05)
        log = []
        a, b, c = pool.borrow(), pool.borrow(), pool.borrow()
        try:
            pool.borrow()
        except TimeoutError:
            log.append("timeout")
        pool.give_back(a)
        pool.give_back(b)          # past max_idle: closed
        pool.give_back(c, broken=True)
        log += [pool.borrow(), pool.stats, list(closed)]
        with pool.use() as r:
            log.append(r)
        pool.close()
        try:
            pool.borrow()
        except mod.PoolClosedError:
            log.append("closed")
        log.append(list(closed))
        logs[name] = log
    assert logs["t"] == logs["j"]
    assert "timeout" in logs["t"] and "closed" in logs["t"]
