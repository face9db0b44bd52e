"""Inline-EC volumes through the port's Store, DiskLocation and deep scrub,
against the JAX package's: the same needles (time.time_ns pinned) through
both Stores under WEED_EC_INLINE=1 give byte-identical shard logs, equal
heartbeats (an inline volume reports as a writable volume, never as EC
shards), remounts through DiskLocation, deletes, and deep scrubs that
return the JAX package's verify_inline_volume dict, clean and with one
flipped parity byte.  The port runs with device="cpu"."""

import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.maintenance.deep_scrub import \
    deep_scrub_host as j_deep_scrub_host
from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import store as j_store
from seaweedfs_tpu_torch.maintenance.deep_scrub import \
    deep_scrub_host as t_deep_scrub_host
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import store as t_store
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
from seaweedfs_tpu_torch.storage.erasure_coding.inline import \
    InlineEcVolume

FILES = [to_ext(i) for i in range(14)] + [".eci", ".vif"]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv("WEED_EC_INLINE", "1")
    monkeypatch.setenv("WEED_EC_STRIPE_KB", "8")
    monkeypatch.setenv("WEED_EC_INLINE_FLUSH_MS", "0")
    monkeypatch.delenv("WEED_EC_INLINE_DEVICE", raising=False)
    monkeypatch.delenv("WEED_EC_CODE", raising=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    from seaweedfs_tpu_torch.ops.device_pool import reset_pool

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_pool()


@pytest.fixture
def pinned_clock(monkeypatch):
    state = {}
    lock = threading.Lock()

    def restart():
        state["ticks"] = itertools.count(1_700_000_000_000_000_000,
                                         1_000_003)

    def fake():
        with lock:
            return next(state["ticks"])

    restart()
    monkeypatch.setattr(time, "time_ns", fake)
    return restart


def _needle(mod, nid: int, payload: bytes):
    n = mod.Needle.create(payload)
    n.id, n.cookie = nid, 0x4242
    return n


def _payloads(count: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {i + 1: rng.integers(0, 256, int(rng.integers(100, 9000)),
                                dtype=np.uint8).tobytes()
            for i in range(count)}


def _fill_both(tmp_path, pinned_clock, vid: int, collection: str,
               written: dict):
    """Both Stores on their own directory, the same needles through
    add_volume + write_needle; returns (jax store, port store)."""
    stores = []
    for sub, mod_store, mod_needle, kw in (
            ("j", j_store, j_needle, {}),
            ("t", t_store, t_needle, {"device": "cpu"})):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        pinned_clock()
        store = mod_store.Store([str(d)], **kw)
        store.add_volume(vid, collection)
        for nid, payload in written.items():
            size, unchanged = store.write_needle(
                vid, _needle(mod_needle, nid, payload))
            assert size > 0 and not unchanged
        store.find_ec_volume(vid).writer.drain(tail=True)
        stores.append(store)
    return stores


def _files(d, base: str) -> dict:
    out = {}
    for ext in FILES:
        with open(os.path.join(str(d), base + ext), "rb") as f:
            out[ext] = f.read()
    return out


def _strip_time(hb: dict) -> dict:
    hb = dict(hb)
    hb["volumes"] = [{k: v for k, v in vol.items()
                      if k != "modified_at_second"}
                     for vol in hb["volumes"]]
    return hb


@pytest.mark.parametrize("family", ["rs_vandermonde", "cauchy", "pm_msr"])
def test_store_routes_inline_volumes_like_the_reference(
        tmp_path, pinned_clock, monkeypatch, family):
    monkeypatch.setenv("WEED_EC_CODE_PICS", family)
    written = _payloads(40, seed=1)
    js, ts = _fill_both(tmp_path, pinned_clock, 42, "pics", written)
    try:
        ev = ts.find_ec_volume(42)
        assert isinstance(ev, InlineEcVolume) and ev.family.name == family
        assert ts.find_volume(42) is None
        for nid, payload in written.items():
            assert ts.read_needle(42, nid).data == payload
        jh, th = js.collect_heartbeat(), ts.collect_heartbeat()
        assert _strip_time(th) == _strip_time(jh)
        vols = [v for v in th["volumes"] if v["id"] == 42]
        assert vols and vols[0]["collection"] == "pics"
        assert not vols[0]["read_only"]
        assert vols[0]["size"] == ev.writer.logical_size
        # writable to the master: never also a sealed EC shard entry
        assert all(s["id"] != 42 for s in th["ec_shards"])
        ts.delete_needle(42, _needle(t_needle, 3, b""))
        js.delete_needle(42, _needle(j_needle, 3, b""))
        with pytest.raises(Exception):
            ts.read_needle(42, 3)
        assert _strip_time(ts.collect_heartbeat()) == \
            _strip_time(js.collect_heartbeat())
    finally:
        js.close()
        ts.close()
    assert _files(tmp_path / "t", "pics_42") == \
        _files(tmp_path / "j", "pics_42")


def test_classic_collections_untouched(tmp_path):
    store = t_store.Store([str(tmp_path)], device="cpu")
    try:
        store.add_volume(3, "logs")  # no EC policy: a classic volume
        assert store.find_volume(3) is not None
        assert store.find_ec_volume(3) is None
    finally:
        store.close()


def test_remount_through_disk_location(tmp_path, pinned_clock,
                                       monkeypatch):
    """Both packages' Stores reopen each directory's inline volume (the
    port's through DiskLocation on its device) and read every needle of
    either package's volume."""
    monkeypatch.setenv("WEED_EC_CODE_PICS", "cauchy")
    written = _payloads(30, seed=2)
    js, ts = _fill_both(tmp_path, pinned_clock, 9, "pics", written)
    js.close()
    ts.close()
    for sub in ("j", "t"):
        loc = DiskLocation(str(tmp_path / sub), device="cpu")
        loc.load_existing_volumes()
        try:
            ev = loc.ec_volumes[9]
            assert isinstance(ev, InlineEcVolume)
            assert ev.family.name == "cauchy"
            assert ev.device == torch.device("cpu")
            for nid, payload in written.items():
                assert ev.read_needle(nid).data == payload
        finally:
            loc.close()
        store = j_store.Store([str(tmp_path / sub)])
        try:
            for nid, payload in written.items():
                assert store.read_needle(9, nid).data == payload
        finally:
            store.close()


def test_delete_volume_removes_the_logs(tmp_path, pinned_clock,
                                        monkeypatch):
    monkeypatch.setenv("WEED_EC_CODE_PICS", "rs_vandermonde")
    js, ts = _fill_both(tmp_path, pinned_clock, 5, "pics",
                        _payloads(10, seed=3))
    try:
        for store in (js, ts):
            store.delete_volume(5)
            assert store.find_ec_volume(5) is None
        assert os.listdir(tmp_path / "t") == ["vol_dir.uuid"]
        assert sorted(os.listdir(tmp_path / "t")) == \
            sorted(os.listdir(tmp_path / "j"))
        with pytest.raises(Exception):
            ts.delete_volume(5)
    finally:
        js.close()
        ts.close()


def _flip(path: str, offset: int):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("family", ["rs_vandermonde", "pm_msr"])
def test_deep_scrub_of_an_inline_volume_matches(tmp_path, pinned_clock,
                                                monkeypatch, family):
    """deep_scrub_host sends a .scl volume to verify_inline_volume in both
    packages: equal dicts, clean, then exactly the row of one flipped
    parity byte."""
    monkeypatch.setenv("WEED_EC_CODE_PICS", family)
    written = _payloads(60, seed=4)
    js, ts = _fill_both(tmp_path, pinned_clock, 11, "pics", written)
    k = ts.find_ec_volume(11).writer.k
    unit = ts.find_ec_volume(11).writer.unit
    js.close()
    ts.close()

    def both():
        jr = j_deep_scrub_host(str(tmp_path / "j"), "pics", 11)
        tr = t_deep_scrub_host(str(tmp_path / "t"), "pics", 11,
                               device="cpu")
        assert tr == jr
        return tr

    report = both()
    assert report["ok"] and report["inline"] and not report["corrupt"]
    assert report["needles_checked"] == len(written)
    for sub in ("j", "t"):
        _flip(os.path.join(str(tmp_path / sub), "pics_11" + to_ext(k + 1)),
              unit + 77)  # row 1 of the second parity log
    report = both()
    assert report["corrupt"] == [1] and not report["ok"]
    assert report["needles_bad"] == 0
