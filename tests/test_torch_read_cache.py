"""The port's tiered read cache against the JAX package's: the same hit,
miss, promotion, QoS-bypass, invalidation and eviction sequence through
both `TieredReadCache`s gives the same answers, the same per-tier
counters, the same tier contents and the same read-cache metric deltas.

The HBM tier runs on the CPU here (`device="cpu"` in the port, JAX's
`device_put` on its CPU backend).  Chunk payloads are a function of the
fid in the shared sequences; a fid whose bytes change (an overwrite) is
the R1 case, which the port answers with the new bytes.  Every
comparison is exact; no case asserts a wall-clock time."""

import threading

import numpy as np
import pytest

from seaweedfs_tpu.cache import ChunkCache as JChunkCache
from seaweedfs_tpu.cache import TieredReadCache as JCache
from seaweedfs_tpu.qos import classify as j_cls
from seaweedfs_tpu.stats import metrics as j_metrics
from seaweedfs_tpu_torch.cache import ChunkCache as TChunkCache
from seaweedfs_tpu_torch.cache import HbmTier
from seaweedfs_tpu_torch.cache import TieredReadCache as TCache
from seaweedfs_tpu_torch.cache import (OnDiskCacheLayer, RamCache,
                                       default_hbm_bytes, default_mem_bytes)
from seaweedfs_tpu_torch.ops import device_pool as t_pool
from seaweedfs_tpu_torch.qos import classify as t_cls
from seaweedfs_tpu_torch.stats import metrics as t_metrics

CHUNK = 4096


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv("WEED_HEAT_EPOCH_S", "3600")
    monkeypatch.delenv("WEED_READ_CACHE_BG_FILL", raising=False)
    monkeypatch.delenv("WEED_QOS", raising=False)


def _payload(fid: str, n: int = CHUNK) -> bytes:
    seed = sum(fid.encode()) * 131 + len(fid)
    return np.random.default_rng(seed).bytes(n)


def _read_cache_metrics(metrics) -> dict:
    out = {}
    for name in ("SeaweedFS_read_cache_requests_total",
                 "SeaweedFS_read_cache_fill_total",
                 "SeaweedFS_read_cache_invalidations_total",
                 "SeaweedFS_chunk_cache_oversize_drops_total"):
        for labels, v in metrics.REGISTRY._metrics[name]._values.items():
            out[(name, labels)] = v
    return out


def _delta(before, after):
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] - before.get(k, 0.0)}


def _ops(seed: int, n: int = 300):
    """A seeded op stream over a Zipf-skewed fid set."""
    rng = np.random.default_rng(seed)
    fids = [f"{1 + i % 3},{i:x}" for i in range(24)]
    ops = []
    for _ in range(n):
        r = rng.random()
        fid = fids[int(rng.zipf(1.3)) % len(fids)]
        if r < 0.55:
            ops.append(("get", fid))
        elif r < 0.85:
            ops.append(("put", fid))
        elif r < 0.90:
            ops.append(("bg_put", fid))
        elif r < 0.96:
            ops.append(("invalidate", fid))
        elif r < 0.99:
            ops.append(("invalidate_volume", int(fid.split(",")[0])))
        else:
            ops.append(("clear", None))
    return ops


def _run(cache, cls, ops) -> list:
    out = []
    for op, arg in ops:
        if op == "get":
            got = cache.get(arg)
            out.append(None if got is None else bytes(got) == _payload(arg))
        elif op == "put":
            out.append(cache.put(arg, _payload(arg)))
        elif op == "bg_put":
            with cls.qos_scope("background"):
                out.append(cache.put(arg, _payload(arg)))
        elif op == "invalidate":
            out.append(cache.invalidate(arg, "overwrite"))
        elif op == "invalidate_volume":
            out.append(cache.invalidate_volume(arg, "vacuum"))
        else:
            out.append(cache.clear())
    return out


def _state(cache) -> dict:
    snap = cache.stats_snapshot()
    return {"snap": snap, "ram": sorted(cache.mem._data),
            "hbm": sorted(cache.hbm._keys) if cache.hbm is not None else None}


def _held_keys(tier: HbmTier) -> list:
    res = t_pool.get_pool().residents_under(tier.pool_prefix)
    assert all(refs == 1 for refs, _ in res.values())
    return sorted(k[2] for k in res)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("hbm", [0, 3 * CHUNK])
def test_sequence_equal_jax(seed, hbm):
    """Hits by tier, misses, promotions into a small HBM tier (which
    evicts), QoS bypasses and invalidations: equal answers, counters,
    tier contents and metric deltas; the pool holds one reference per
    live HBM key of the port's tier."""
    ops = _ops(seed)
    jc = JCache(mem_bytes=3 * CHUNK, hbm_bytes=hbm)
    tc = TCache(mem_bytes=3 * CHUNK, hbm_bytes=hbm, device="cpu")
    b = [_read_cache_metrics(m) for m in (j_metrics, t_metrics)]
    assert _run(jc, j_cls, ops) == _run(tc, t_cls, ops)
    a = [_read_cache_metrics(m) for m in (j_metrics, t_metrics)]
    assert _delta(b[0], a[0]) == _delta(b[1], a[1])
    assert _state(jc) == _state(tc)
    snap = tc.stats_snapshot()
    assert snap["tier_hits"]["ram"] > 0 and snap["misses"] > 0
    if hbm:
        assert snap["tier_hits"]["hbm"] > 0
        assert _held_keys(tc.hbm) == sorted(tc.hbm._keys)
        assert tc.hbm.held_bytes() == tc.hbm.size_bytes <= hbm
    jc.close()
    tc.close()
    if hbm:
        assert _held_keys(tc.hbm) == []


def test_resident_gauges_equal_stats_snapshot():
    tc = TCache(mem_bytes=4 * CHUNK, hbm_bytes=3 * CHUNK, device="cpu")
    _run(tc, t_cls, _ops(11, 120))
    snap = tc.stats_snapshot()
    gauge = t_metrics.ReadCacheResidentBytesGauge._values
    tc.put("9,1", _payload("9,1"))  # publishes every tier's bytes
    snap = tc.stats_snapshot()
    assert gauge[("ram",)] == snap["resident_bytes"]["ram"]
    assert gauge[("hbm",)] == snap["resident_bytes"]["hbm"]
    tc.close()


def _r1(cache) -> bytes:
    """Put A, promote it, overwrite it with B (invalidate, put, promote),
    push it out of RAM with three other chunks, then get it."""
    cache.put("1,a", b"A" * CHUNK)
    for _ in range(3):
        cache.get("1,a")
    cache.invalidate("1,a", "overwrite")
    cache.put("1,a", b"B" * CHUNK)
    for _ in range(3):
        cache.get("1,a")
    for fid in ("1,b", "1,c", "1,d"):
        cache.put(fid, b"x" * CHUNK)
    assert cache.mem.get("1,a") is None
    return cache.get("1,a")


def test_overwrite_serves_new_bytes_from_hbm():
    """R1: after an overwrite, the HBM tier serves the new bytes.  The
    JAX package's HbmTier keys its slab by the fid alone and lets the
    released slab idle in its pool, where the next put of the fid finds
    it: on this sequence it serves b"AAAA..." from HBM.  The port keys
    each upload by a fresh generation and drops a released slab, so it
    serves b"BBBB..."."""
    tc = TCache(mem_bytes=2 * CHUNK, hbm_bytes=1 << 20, device="cpu")
    got = _r1(tc)
    assert got == b"B" * CHUNK
    assert tc.stats_snapshot()["tier_hits"]["hbm"] == 1
    assert _held_keys(tc.hbm) == sorted(tc.hbm._keys)
    tc.close()


@pytest.mark.parametrize("how", ["pop", "evict", "drop_prefix", "clear"])
def test_hbm_slab_never_handed_back_after_release(how):
    """A fid popped, evicted, dropped by volume or cleared never finds its
    old slab on a later put, and no slab of the tier idles in the pool."""
    tier = HbmTier(2 * CHUNK, device="cpu")
    assert tier.put("3,a", b"A" * CHUNK)
    if how == "pop":
        assert tier.pop("3,a")
    elif how == "evict":
        tier.put("3,b", b"b" * CHUNK)
        tier.put("3,c", b"c" * CHUNK)
        assert tier.get("3,a") is None
    elif how == "drop_prefix":
        assert tier.drop_prefix("3,") == 1
    else:
        tier.clear()
    assert tier.put("3,a", b"Z" * CHUNK)
    assert tier.get("3,a") == b"Z" * CHUNK
    assert _held_keys(tier) == sorted(tier._keys)
    assert tier.held_bytes() == tier.size_bytes
    tier.close()
    assert _held_keys(tier) == []


def test_hbm_refusals_and_capacity():
    tier = HbmTier(3 * CHUNK, device="cpu")
    assert not tier.put("1,a", ("needle", 0, 10))  # not bytes
    assert not tier.put("1,a", b"")
    assert not tier.put("1,a", b"x" * (3 * CHUNK + 1))
    for i in range(5):
        assert tier.put(f"1,{i}", bytes([i]) * CHUNK)
    assert len(tier) == 3 and tier.size_bytes == 3 * CHUNK
    assert [tier.get(f"1,{i}") for i in (0, 1)] == [None, None]
    assert tier.get("1,4") == b"\x04" * CHUNK
    assert tier.put("1,4", b"ignored")  # a present fid keeps its slab
    assert tier.get("1,4") == b"\x04" * CHUNK
    assert tier.put("1,m", memoryview(b"m" * 10))
    assert tier.put("1,n", bytearray(b"n" * 10))
    assert tier.get("1,m") == b"m" * 10 and tier.get("1,n") == b"n" * 10
    tier.close()


def test_background_fill_knob(monkeypatch):
    """Background traffic bypasses the fill unless WEED_READ_CACHE_BG_FILL
    is 1; with WEED_QOS=0 every fill is admitted."""
    for env, admitted in ((None, False), ("1", True)):
        if env:
            monkeypatch.setenv("WEED_READ_CACHE_BG_FILL", env)
        for cache, cls in ((JCache(mem_bytes=1 << 20, hbm_bytes=0), j_cls),
                           (TCache(mem_bytes=1 << 20, hbm_bytes=0), t_cls)):
            with cls.qos_scope("background"):
                cache.put("5,1", b"x")
            assert (cache.get("5,1") is not None) == admitted
            assert cache.stats_snapshot()["fills"] == (
                {"admitted": 1, "qos_bypass": 0} if admitted
                else {"admitted": 0, "qos_bypass": 1})
    monkeypatch.delenv("WEED_READ_CACHE_BG_FILL")
    monkeypatch.setenv("WEED_QOS", "0")
    tc = TCache(mem_bytes=1 << 20, hbm_bytes=0)
    with t_cls.qos_scope("background"):
        tc.put("5,1", b"x")
    assert tc.get("5,1") == b"x"


def test_disk_layers_equal_jax(tmp_path):
    """With disk layers: small chunks ride RAM and layer 0, larger ones
    their own layers; get_slice hands a dup'd fd for disk-only chunks;
    oversize chunks are dropped and counted."""
    sizes = {"2,s": 512, "2,m": 2048, "2,l": 8192, "2,x": 200_000}
    out = []
    for name, Cache in (("j", JCache), ("t", TCache)):
        c = Cache(mem_bytes=1 << 20, directory=str(tmp_path / name),
                  disk_bytes=1 << 18, unit_size=1024, hbm_bytes=0)
        for fid, n in sizes.items():
            c.put(fid, _payload(fid, n))
        got = {fid: c.get(fid) == _payload(fid, n) if c.get(fid) else None
               for fid, n in sizes.items()}
        fd, off, length = c.get_slice("2,l")
        import os

        try:
            assert os.pread(fd, length, off) == _payload("2,l", 8192)
        finally:
            os.close(fd)
        assert c.get_slice("2,s") is None  # a RAM hit takes the memory path
        out.append((got, [layer.size_bytes for layer in c.layers],
                    [layer.oversize_drops for layer in c.layers],
                    c.stats_snapshot()))
        assert c.invalidate_volume(2) == 4
        c.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("segments", [2, 3])
def test_disk_layer_rotates_fifo(tmp_path, segments):
    outs = []
    for name, mod in (("j", __import__("seaweedfs_tpu.cache.disk",
                                       fromlist=["x"])),
                      ("t", __import__("seaweedfs_tpu_torch.cache.disk",
                                       fromlist=["x"]))):
        d = tmp_path / name
        d.mkdir()
        layer = mod.OnDiskCacheLayer(str(d), "c", 3 * 1000 * segments,
                                     segments)
        for i in range(12 * segments):
            layer.put(f"7,{i}", bytes([i]) * 900)
        outs.append([layer.get(f"7,{i}") is not None
                     for i in range(12 * segments)])
        assert layer.invalidate("7,1") is False
        layer.close()
    assert outs[0] == outs[1]
    assert isinstance(OnDiskCacheLayer, type)


def test_chunk_cache_and_ram_cache_equal_jax():
    out = []
    for Chunk in (JChunkCache, TChunkCache):
        c = Chunk(3 * CHUNK)
        assert c.hbm is None and c.layers == []
        for i in range(5):
            c.put(f"1,{i}", _payload(f"1,{i}"))
        out.append(([c.get(f"1,{i}") is not None for i in range(5)],
                    len(c), c.size_bytes, c.capacity, c.stats_snapshot()))
    assert out[0] == out[1]
    r = RamCache(10)
    r.put("a", object(), nbytes=4)
    assert r.size_bytes == 4 and r.pop("a") and not r.pop("a")


def test_default_budgets_read_the_knobs(monkeypatch):
    monkeypatch.delenv("WEED_READ_CACHE_HBM_MB", raising=False)
    monkeypatch.delenv("WEED_READ_CACHE_MB", raising=False)
    assert default_hbm_bytes() == 0 and default_mem_bytes() == 64 << 20
    monkeypatch.setenv("WEED_READ_CACHE_HBM_MB", "1.5")
    assert default_hbm_bytes() == int(1.5 * (1 << 20))
    monkeypatch.setenv("WEED_READ_CACHE_HBM_MB", "0")
    c = TCache()  # no HBM budget: no device is touched
    assert c.hbm is None


def test_concurrent_readers_see_their_own_bytes():
    """Eight threads over one cache with a small HBM tier: every get
    returns the fid's own bytes, and the pool's references match the
    tier's keys at the end."""
    tc = TCache(mem_bytes=4 * CHUNK, hbm_bytes=6 * CHUNK, device="cpu")
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            fid = f"4,{int(rng.zipf(1.2)) % 16:x}"
            got = tc.get(fid)
            if got is None:
                tc.put(fid, _payload(fid))
            elif bytes(got) != _payload(fid):
                errors.append(fid)
            if rng.random() < 0.02:
                tc.invalidate(fid)

    threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert _held_keys(tc.hbm) == sorted(tc.hbm._keys)
    assert tc.stats_snapshot()["tier_hits"]["hbm"] > 0
    tc.close()
