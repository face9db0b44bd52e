"""The port's tiered chunk cache (`util/chunk_cache.py` over `cache/`) and
the filer's use of it, against the JAX package's, on the CPU.

- `CacheVolume`, `OnDiskCacheLayer` and `TieredChunkCache`: the same put
  and get sequences give equal answers, counters and segment files
  (`reset`, FIFO rotation, oversized entries, size classes, RAM eviction
  served from disk, hit and miss counts, `close`).
- Rotation racing readers: no torn or mis-indexed read, exact counters.
- A port filer with a disk cache tier serves warm reads from it, and a
  read warms the next chunk in the background, as the JAX filer does.
Tolerance: equality throughout.
"""

import hashlib
import os
import threading
import time

import pytest

from test_torch_filer import cluster

from seaweedfs_tpu.util import chunk_cache as j_cc
from seaweedfs_tpu_torch.util import chunk_cache as t_cc

CC = {"jax": j_cc, "port": t_cc}


def _segment_files(d):
    return sorted((f, os.path.getsize(os.path.join(d, f)))
                  for f in os.listdir(d) if f.endswith(".dat"))


def _cache_case(cc, case, d):
    if case == "cache_volume_put_get_reset":
        v = cc.CacheVolume(str(d / "v.dat"), 1024)
        v.put("1,a", b"alpha")
        v.put("1,b", b"beta")
        out = [v.get("1,a"), v.get("1,b"), v.get("1,c")]
        size = v.file_size
        v.reset()
        out += [v.get("1,a"), size, v.file_size]
        v.close()
        return out
    if case == "layer_rotation_evicts_oldest":
        layer = cc.OnDiskCacheLayer(str(d), "t", 200, 2)
        for fid, b in (("1,a", b"A"), ("1,b", b"B"), ("1,c", b"C")):
            layer.put(fid, b * 90)
        out = [layer.get(f) for f in ("1,a", "1,b", "1,c")]
        out.append(_segment_files(d))
        layer.close()
        return out
    if case == "layer_oversized_entry_skipped":
        layer = cc.OnDiskCacheLayer(str(d), "t", 100, 2)
        layer.put("1,x", b"X" * 500)
        out = layer.get("1,x")
        layer.close()
        return out
    if case == "size_classes_route_to_layers":
        c = cc.TieredChunkCache(str(d), mem_bytes=1 << 20,
                                disk_bytes=64 << 20, unit_size=1024)
        items = {"1,s": b"s" * 512, "1,m": b"m" * 3000, "1,l": b"L" * 9000}
        for fid, data in items.items():
            c.put(fid, data)
        out = [c.get(f) == data for f, data in items.items()]
        out += [c.mem.get("1,s") is not None, c.mem.get("1,m"),
                c.layers[1].get("1,m") == items["1,m"],
                c.layers[2].get("1,l") == items["1,l"], _segment_files(d)]
        c.close()
        return out
    if case == "small_survives_memory_eviction_via_disk":
        c = cc.TieredChunkCache(str(d), mem_bytes=1024,
                                disk_bytes=64 << 20, unit_size=1024)
        c.put("1,a", b"a" * 600)
        c.put("1,b", b"b" * 600)
        out = [c.mem.get("1,a"), c.get("1,a"), c.hits, c.misses,
               dict(c.tier_hits)]
        c.close()
        return out
    if case == "hit_miss_counters":
        c = cc.TieredChunkCache(str(d), disk_bytes=1 << 20, unit_size=1024)
        out = [c.get("1,none")]
        c.put("1,x", b"x")
        out += [c.get("1,x"), c.hits, c.misses]
        c.close()
        return out
    c = cc.TieredChunkCache(str(d), disk_bytes=1 << 20)
    c.put("1,x", b"x" * 10)
    before = _segment_files(d)
    c.close()
    return before, _segment_files(d)


@pytest.mark.parametrize("case", [
    "cache_volume_put_get_reset", "layer_rotation_evicts_oldest",
    "layer_oversized_entry_skipped", "size_classes_route_to_layers",
    "small_survives_memory_eviction_via_disk", "hit_miss_counters",
    "close_removes_segment_files"])
def test_chunk_cache_like_jax(tmp_path, case):
    out = {}
    for pkg, cc in CC.items():
        (tmp_path / pkg).mkdir()
        out[pkg] = _cache_case(cc, case, tmp_path / pkg)
    assert out["port"] == out["jax"]
    got = out["port"]
    if case == "cache_volume_put_get_reset":
        assert got[:4] == [b"alpha", b"beta", None, None] and got[5] == 0
    elif case == "layer_rotation_evicts_oldest":
        assert got[:3] == [None, b"B" * 90, b"C" * 90]
    elif case == "layer_oversized_entry_skipped":
        assert got is None
    elif case == "size_classes_route_to_layers":
        assert got[:7] == [True] * 4 + [None, True, True]
    elif case == "small_survives_memory_eviction_via_disk":
        assert got[0] is None and got[1] == b"a" * 600
        assert got[4]["disk"] == 1
    elif case == "hit_miss_counters":
        assert got == [None, b"x", 1, 1]
    else:
        assert got[0] and got[1] == []


def _payload_for(fid: str, size: int) -> bytes:
    seed = hashlib.blake2b(fid.encode(), digest_size=8).digest()
    return (seed * (size // len(seed) + 1))[:size]


def test_layer_rotation_never_tears_reads(tmp_path):
    """Rotation-driven eviction racing four readers of a port layer: a
    read may miss, never return torn or mis-indexed bytes."""
    layer = t_cc.OnDiskCacheLayer(str(tmp_path), "cc", 8192, 2)
    fids = [f"7,{i:x}" for i in range(64)]
    errors, hits = [], []
    start = threading.Barrier(5)

    def reader():
        start.wait()
        n = 0
        for _ in range(40):
            for fid in fids:
                data = layer.get(fid)
                if data is None:
                    continue
                n += 1
                if data != _payload_for(fid, 200):
                    errors.append((fid, len(data)))
        hits.append(n)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    start.wait()
    for _ in range(6):
        for fid in fids:
            layer.put(fid, _payload_for(fid, 200))
    for t in readers:
        t.join(timeout=60)
    assert not errors and sum(hits) > 0
    assert layer.get(fids[-1]) == _payload_for(fids[-1], 200)
    layer.close()


def test_tiered_cache_integrity_and_counters_under_race(tmp_path):
    c = t_cc.TieredChunkCache(str(tmp_path), mem_bytes=4096,
                              disk_bytes=64 << 10, unit_size=1024)
    fids = [(f"9,{k}{i}", sz) for k, sz in
            (("s", 600), ("m", 3000), ("l", 7000)) for i in range(8)]
    errors, gets = [], []
    start = threading.Barrier(4)

    def reader():
        start.wait()
        n = 0
        for _ in range(30):
            for fid, sz in fids:
                data = c.get(fid)
                n += 1
                if data is not None and data != _payload_for(fid, sz):
                    errors.append(fid)
        gets.append(n)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers:
        t.start()
    start.wait()
    for _ in range(4):
        for fid, sz in fids:
            c.put(fid, _payload_for(fid, sz))
    for t in readers:
        t.join(timeout=60)
    assert not errors
    assert c.hits + c.misses == sum(gets) and c.hits > 0
    c.close()


PAYLOAD = bytes(range(256)) * 16  # four 1 KiB chunks


def test_filer_reads_hit_the_disk_cache_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    out = {}
    for pkg in ("jax", "port"):
        with cluster(pkg, tmp_path / pkg, chunk_size=1024,
                     cache_dir=str(tmp_path / pkg / "cache"),
                     chunk_cache_bytes=2048) as (_, _, filer):
            filer.save_bytes("/c/f.bin", PAYLOAD)
            entry = filer.filer.find_entry("/c/f.bin")
            reads = [filer.read_bytes(entry) == PAYLOAD]
            before = filer.chunk_cache.hits
            reads.append(filer.read_bytes(entry) == PAYLOAD)
            snap = filer.chunk_cache.stats_snapshot()
            out[pkg] = (reads, filer.chunk_cache.hits - before,
                        snap["tier_hits"], snap["misses"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True, True] and out["port"][1] == 4


def test_read_warms_the_next_chunk_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    out = {}
    for pkg in ("jax", "port"):
        with cluster(pkg, tmp_path / pkg, chunk_size=1024) as (_, _, filer):
            entry = filer.save_bytes("/p/seq.bin", PAYLOAD)
            chunks = sorted(entry.chunks, key=lambda c: c.offset)
            filer.chunk_cache = type(filer.chunk_cache)(64 << 20)
            first = filer.read_bytes(entry, 0, 1024) == PAYLOAD[:1024]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and \
                    filer.chunk_cache.mem.get(chunks[1].fid) is None:
                time.sleep(0.02)
            out[pkg] = (first,
                        filer.chunk_cache.mem.get(chunks[1].fid) is not None,
                        [filer.chunk_cache.mem.get(c.fid) is not None
                         for c in (chunks[2], chunks[3])])
    assert out["port"] == out["jax"] == (True, True, [False, False])
