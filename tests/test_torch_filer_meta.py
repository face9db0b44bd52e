"""The port's filer metadata paths against the JAX package's, on the CPU.

- `LogBuffer`: flushes, `read_since`, the ring cap and a failed flush's
  requeue give equal answers.
- The persisted change log: the dated segments' entries and bytes, the
  replay of persisted then buffered events and the `since` cursor are
  equal on the same script (clocks pinned per package).
- Hardlinks: shared content, updates through either link, refcounted
  chunk reclamation and its rollback, and their replay through the meta
  feed give equal entries, reclaimed chunks and events.
- Chunk manifests: folding, resolving and the deletion list (every data
  and manifest fid) are equal, manifest blobs byte for byte;
  `MANIFEST_BATCH` is 1,000 in both.
- The reader cache, path rules (`FilerConf` bytes, `FILER_CONF_PATH`,
  `ec_code`) and the meta aggregator (`apply_meta_event`, a live peer's
  feed followed and bootstrapped, across packages).
- The sharded filer store: `ShardMap` scripts, `slot_of` against
  `ShardedSqliteStore`'s placement, and a port master with two port
  store servers splitting, routing, renaming across slots and taking
  over a crashed holder's slots.
Tolerance: equality throughout.  Cluster cases wait on deadlines and
stop every server in a `finally`.
"""

import json
import time

import pytest

from test_torch_filer import PKG, pinned  # noqa: F401 (a fixture)

from seaweedfs_tpu.filer import filechunk_manifest as j_manifest
from seaweedfs_tpu.filer import meta_aggregator as j_agg
from seaweedfs_tpu.filer import reader_cache as j_reader
from seaweedfs_tpu.filer import shard_map as j_shard_map
from seaweedfs_tpu.util import log_buffer as j_log
from seaweedfs_tpu_torch.filer import cluster_store as t_cluster_store
from seaweedfs_tpu_torch.filer import filechunk_manifest as t_manifest
from seaweedfs_tpu_torch.filer import meta_aggregator as t_agg
from seaweedfs_tpu_torch.filer import reader_cache as t_reader
from seaweedfs_tpu_torch.filer import shard_map as t_shard_map
from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call
from seaweedfs_tpu_torch.util import log_buffer as t_log

for _pkg, _mods in (("jax", (j_manifest, j_agg, j_reader, j_shard_map,
                             j_log)),
                    ("port", (t_manifest, t_agg, t_reader, t_shard_map,
                              t_log))):
    (PKG[_pkg].manifest, PKG[_pkg].agg, PKG[_pkg].reader,
     PKG[_pkg].shard_map, PKG[_pkg].log) = _mods


def _file_entry(ns, path, content=b"", chunks=None):
    now = ns.filer.time.time()
    return ns.entry.Entry(
        full_path=path, attr=ns.entry.Attr(mtime=now, crtime=now,
                                           file_size=len(content)),
        content=content, chunks=chunks or [])


def _both(case, fn):
    out = {pkg: fn(PKG[pkg], case) for pkg in PKG}
    assert out["port"] == out["jax"]
    return out["port"]


# -- LogBuffer -------------------------------------------------------------------


def _log_case(ns, case):
    if case == "flush_moves_entries":
        flushed = []
        buf = ns.log.LogBuffer(lambda a, b, items: flushed.append(
            (a, b, items)))
        buf.add(1, "x")
        buf.add(2, "y")
        return (buf.read_since(0), buf.flush(), flushed, buf.read_since(0),
                buf.last_flushed_ns)
    if case == "read_since_filters":
        buf = ns.log.LogBuffer()
        buf.add(10, "a")
        buf.add(20, "b")
        return buf.read_since(10)
    if case == "ring_cap":
        buf = ns.log.LogBuffer(max_entries=3)
        for i in range(10):
            buf.add(i, i)
        return buf.read_since(-1)
    calls = []

    def flaky(start, stop, items):
        calls.append(items)
        if len(calls) == 1:
            raise RuntimeError("persist hiccup")

    buf = ns.log.LogBuffer(flaky)
    buf.add(1, "x")
    with pytest.raises(RuntimeError):
        buf.flush()
    return buf.read_since(0), buf.flush(), buf.read_since(0), calls


@pytest.mark.parametrize("case", ["flush_moves_entries", "read_since_filters",
                                  "ring_cap", "failed_flush_requeues"])
def test_log_buffer_like_jax(case):
    got = _both(case, _log_case)
    expect = {"flush_moves_entries": (["x", "y"], 2, [(1, 2, ["x", "y"])],
                                      [], 2),
              "read_since_filters": ["b"], "ring_cap": [7, 8, 9],
              "failed_flush_requeues": (["x"], 1, [], [["x"], ["x"]])}
    assert got == expect[case]


# -- the persisted change log ----------------------------------------------------


def _meta_log_case(ns, case):
    f = ns.filer.Filer()
    f.enable_meta_log(background=False)
    if case == "flush_writes_dated_segment":
        f.create_entry(_file_entry(ns, "/a/b.txt", b"hi"))
        n = f.flush_meta_log()
        days = f.store.list_directory(ns.filer.SYSTEM_LOG_DIR, limit=10)
        segs = f.store.list_directory(days[0].full_path, limit=10)
        return n, [d.to_dict() for d in days], [s.to_dict() for s in segs]
    if case == "subscribe_replays_persisted_then_tails":
        f.create_entry(_file_entry(ns, "/a/1.txt", b"1"))
        f.flush_meta_log()
        f.create_entry(_file_entry(ns, "/a/2.txt", b"2"))
        return f.subscribe_metadata(0, "/a")
    if case == "since_cursor_resumes_without_duplicates":
        f.create_entry(_file_entry(ns, "/a/1.txt", b"1"))
        cursor = f.subscribe_metadata(0, "/a")[-1]["ts_ns"]
        f.flush_meta_log()
        f.create_entry(_file_entry(ns, "/a/2.txt", b"2"))
        return f.subscribe_metadata(cursor, "/a")
    f.create_entry(_file_entry(ns, "/x.txt", b"x"))
    return f.flush_meta_log(), f.flush_meta_log(), f.subscribe_metadata(0)


@pytest.mark.parametrize("case", [
    "flush_writes_dated_segment", "subscribe_replays_persisted_then_tails",
    "since_cursor_resumes_without_duplicates", "log_dir_itself_not_logged"])
def test_meta_log_persistence_like_jax(pinned, case):
    got = _both(case, _meta_log_case)
    if case == "flush_writes_dated_segment":
        n, days, segs = got
        assert n >= 1 and len(days) == 1 and len(segs) == 1
        events = [json.loads(line) for line in
                  bytes.fromhex(segs[0]["content"]).decode().splitlines()]
        assert any(e["new_entry"] and
                   e["new_entry"]["full_path"] == "/a/b.txt" for e in events)
    elif case == "subscribe_replays_persisted_then_tails":
        assert [e["new_entry"]["full_path"] for e in got] == [
            "/a/1.txt", "/a/2.txt"]
    elif case == "since_cursor_resumes_without_duplicates":
        assert [e["new_entry"]["full_path"] for e in got] == ["/a/2.txt"]
    else:
        assert all(not e["directory"].startswith("/topics/.system/log")
                   for e in got[2])


# -- hardlinks --------------------------------------------------------------------


def _hardlink_case(ns, case):
    f = ns.filer.Filer()
    reclaimed = []
    f.on_delete_chunks = reclaimed.extend
    C = ns.entry.FileChunk
    out = {}

    def chunked(path, fid):
        e = _file_entry(ns, path, chunks=[C(fid=fid, offset=0, size=5)])
        e.attr.file_size = 5
        f.create_entry(e)

    if case == "links_share_content":
        f.create_entry(_file_entry(ns, "/f1", b"shared"))
        f.create_hard_link("/f1", "/f2")
        out["found"] = [f.find_entry(p).to_dict() for p in ("/f1", "/f2")]
    elif case == "update_via_one_link_visible_in_other":
        f.create_entry(_file_entry(ns, "/f1", b"v1"))
        f.create_hard_link("/f1", "/f2")
        e = f.find_entry("/f2")
        e.content, e.attr.file_size = b"v2", 2
        f.update_entry(e)
        out["found"] = f.find_entry("/f1").to_dict()
    elif case == "overwrite_of_hardlink_pointer_releases_reference":
        chunked("/f1", "7,bb")
        f.create_hard_link("/f1", "/f2")
        f.create_entry(_file_entry(ns, "/f2", b"new"))
        out["before"] = [c.fid for c in reclaimed]
        f.delete_entry("/f1")
    elif case == "listing_resolves_hardlink_sizes":
        e = _file_entry(ns, "/d/a", b"hello")
        f.create_entry(e)
        f.create_hard_link("/d/a", "/d/b")
        out["sizes"] = {x.name: x.size() for x in f.list_directory("/d")}
        out["raw"] = f.store.find_entry("/d/b").to_dict()
    elif case == "update_preserves_extended":
        e = _file_entry(ns, "/f1", b"x")
        e.extended = {"k": "v"}
        f.create_entry(e)
        f.create_hard_link("/f1", "/f2")
        upd = f.find_entry("/f1")
        upd.content = b"y"
        f.update_entry(upd)
        out["found"] = f.find_entry("/f2").to_dict()
    elif case == "hardlinks_replicate_through_meta_feed":
        dst = ns.filer.Filer()
        f.create_entry(_file_entry(ns, "/f1", b"shared"))
        f.create_hard_link("/f1", "/f2")
        for event in f.subscribe_metadata(0):
            ns.agg.apply_meta_event(dst, event)
        out["replica"] = [dst.find_entry(p).content for p in ("/f1", "/f2")]
        e = f.find_entry("/f2")
        e.content = b"v2"
        f.update_entry(e)
        for event in f.subscribe_metadata(0):
            ns.agg.apply_meta_event(dst, event)
        out["after"] = dst.find_entry("/f1").content
    elif case == "failed_link_rolls_back_refcount":
        chunked("/f1", "7,cc")
        new_dir = _file_entry(ns, "/adir", b"")
        f.create_entry(new_dir)
        new_dir.attr.mode |= 0o40000
        f.store.update_entry(new_dir)
        with pytest.raises(ValueError) as err:
            f.create_hard_link("/f1", "/adir")
        out["error"] = str(err.value)
        f.delete_entry("/f1")
    elif case == "chunks_reclaimed_only_at_last_unlink":
        chunked("/f1", "7,aa")
        f.create_hard_link("/f1", "/f2")
        f.delete_entry("/f1")
        out["before"] = [c.fid for c in reclaimed]
        out["f2"] = f.find_entry("/f2").to_dict()
        f.delete_entry("/f2")
    else:  # relink_same_record_keeps_refcount_balanced
        chunked("/f1", "7,dd")
        f.create_hard_link("/f1", "/f2")
        f.create_hard_link("/f1", "/f2")
        f.delete_entry("/f1")
        f.delete_entry("/f2")
    out["reclaimed"] = [c.fid for c in reclaimed]
    out["events"] = f.subscribe_metadata(0)
    return out


@pytest.mark.parametrize("case", [
    "links_share_content", "update_via_one_link_visible_in_other",
    "overwrite_of_hardlink_pointer_releases_reference",
    "listing_resolves_hardlink_sizes", "update_preserves_extended",
    "hardlinks_replicate_through_meta_feed",
    "failed_link_rolls_back_refcount",
    "chunks_reclaimed_only_at_last_unlink",
    "relink_same_record_keeps_refcount_balanced"])
def test_hardlinks_like_jax(pinned, case):
    got = _both(case, _hardlink_case)
    reclaimed = {"overwrite_of_hardlink_pointer_releases_reference": ["7,bb"],
                 "failed_link_rolls_back_refcount": ["7,cc"],
                 "chunks_reclaimed_only_at_last_unlink": ["7,aa"],
                 "relink_same_record_keeps_refcount_balanced": ["7,dd"]}
    assert got["reclaimed"] == reclaimed.get(case, [])
    if "before" in got:
        assert got["before"] == []
    if case == "links_share_content":
        a, b = got["found"]
        assert a["content"] == b["content"] == b"shared".hex()
        assert a["hard_link_id"] == b["hard_link_id"] != ""
    if case == "listing_resolves_hardlink_sizes":
        assert got["sizes"] == {"a": 5, "b": 5}
        assert got["raw"]["content"] == "" and got["raw"]["chunks"] == []
    if case == "hardlinks_replicate_through_meta_feed":
        assert got["replica"] == [b"shared", b"shared"]
        assert got["after"] == b"v2"


# -- chunk manifests --------------------------------------------------------------


def _manifest_case(ns, case):
    store = {}
    C = ns.entry.FileChunk

    def save(blob):
        fid = f"m,{len(store):04x}"
        store[fid] = blob
        return C(fid=fid, offset=0, size=len(blob))

    n, batch = {"small_list_untouched": (5, 100), "round_trip": (25, 10),
                "keep_manifests_lists_every_fid": (20, 10),
                "manifest_covers_span": (10, 10),
                "nested_manifests": (350, 7)}[case]
    chunks = [C(fid=f"1,{i:04x}", offset=i * 10, size=10, modified_ts_ns=i,
                etag=f"{i:08x}") for i in range(n)]
    folded = ns.manifest.maybe_manifestize(save, chunks, batch=batch)
    return {
        "folded": [c.to_dict() for c in folded],
        "has": ns.manifest.has_chunk_manifest(folded),
        "resolved": [c.to_dict() for c in ns.manifest.resolve_chunk_manifest(
            lambda fid: store[fid], folded)],
        "everything": sorted(c.fid for c in ns.manifest.resolve_chunk_manifest(
            lambda fid: store[fid], folded, keep_manifests=True)),
        "blobs": {k: bytes(v) for k, v in store.items()},
        "etag": ns.chunks.etag_of_chunks(folded),
        "data": sorted(c.fid for c in chunks),
    }


@pytest.mark.parametrize("case", [
    "small_list_untouched", "round_trip", "keep_manifests_lists_every_fid",
    "manifest_covers_span", "nested_manifests"])
def test_chunk_manifest_like_jax(case):
    got = _both(case, _manifest_case)
    assert j_manifest.MANIFEST_BATCH == t_manifest.MANIFEST_BATCH == 1000
    if case == "small_list_untouched":
        assert not got["has"] and len(got["folded"]) == 5
    else:
        assert got["has"]
        assert sorted(c["fid"] for c in got["resolved"]) == got["data"]
        assert set(got["data"]) | set(got["blobs"]) == set(got["everything"])
    if case == "round_trip":
        assert len([c for c in got["folded"]
                    if not c.get("is_chunk_manifest")]) == 5
    if case == "manifest_covers_span":
        (only,) = got["folded"]
        assert only["offset"] == 0 and only["size"] == 100


# -- the reader cache and path rules -----------------------------------------------


def _reader_case(ns, case):
    if case == "lru_eviction_by_bytes":
        c = ns.reader.ChunkCache(capacity_bytes=100)
        c.put("a", b"x" * 60)
        c.put("b", b"y" * 60)
        return c.get("a"), c.get("b"), c.size_bytes
    if case == "get_refreshes_recency":
        c = ns.reader.ChunkCache(capacity_bytes=100)
        c.put("a", b"x" * 40)
        c.put("b", b"y" * 40)
        c.get("a")
        c.put("c", b"z" * 40)
        return c.get("a"), c.get("b")
    c = ns.reader.ChunkCache(capacity_bytes=10)
    c.put("big", b"x" * 11)
    return c.get("big")


@pytest.mark.parametrize("case", ["lru_eviction_by_bytes",
                                  "get_refreshes_recency",
                                  "oversized_never_cached"])
def test_reader_cache_like_jax(case):
    got = _both(case, _reader_case)
    expect = {"lru_eviction_by_bytes": (None, b"y" * 60, 60),
              "get_refreshes_recency": (b"x" * 40, None),
              "oversized_never_cached": None}
    assert got == expect[case]


def _conf_case(ns, case):
    P = ns.conf.PathConf
    conf = ns.conf.FilerConf()
    if case == "longest_prefix_wins":
        conf.add(P(location_prefix="/", replication="000"))
        conf.add(P(location_prefix="/buckets/", replication="001"))
        conf.add(P(location_prefix="/buckets/hot/", replication="010",
                   collection="hot", ec_code="cauchy"))
        return ([conf.match_path(p).replication for p in
                 ("/buckets/hot/x", "/buckets/cold/x", "/other")],
                conf.match_path("/buckets/hot/x").ec_code, conf.to_bytes())
    if case == "save_load_round_trip":
        f = ns.filer.Filer()
        conf.add(P(location_prefix="/ro/", read_only=True))
        conf.add(P(location_prefix="/warm/", collection="warm",
                   ec_code="cauchy", ttl="7d"))
        conf.save(f)
        loaded = ns.conf.FilerConf.load(f)
        return (loaded.match_path("/ro/x").read_only,
                loaded.match_path("/rw/x").read_only,
                loaded.match_path("/warm/a").ec_code,
                f.find_entry(ns.conf.FILER_CONF_PATH).to_dict())
    conf.add(P(location_prefix="/a/", collection="c"))
    conf.delete("/a/")
    return conf.match_path("/a/x").collection, conf.to_bytes()


@pytest.mark.parametrize("case", ["longest_prefix_wins",
                                  "save_load_round_trip", "delete_rule"])
def test_filer_conf_like_jax(pinned, case):
    got = _both(case, _conf_case)
    if case == "longest_prefix_wins":
        assert got[0] == ["010", "001", "000"] and got[1] == "cauchy"
    elif case == "save_load_round_trip":
        assert got[:3] == (True, False, "cauchy") and got[3]["content"]
    else:
        assert got[0] == ""


# -- meta aggregation --------------------------------------------------------------


def _agg_case(ns, case):
    src, dst = ns.filer.Filer(), ns.filer.Filer()
    out = {}
    if case == "apply_meta_event_create_update_delete":
        src.create_entry(_file_entry(ns, "/d/a.txt", b"1"))
        e = src.find_entry("/d/a.txt")
        e.content = b"22"
        src.update_entry(e)
        for event in src.subscribe_metadata(0):
            ns.agg.apply_meta_event(dst, event)
        out["after_update"] = dst.find_entry("/d/a.txt").to_dict()
        src.delete_entry("/d/a.txt")
        for event in src.subscribe_metadata(0):
            ns.agg.apply_meta_event(dst, event)
        with pytest.raises(ns.store.NotFoundError):
            dst.find_entry("/d/a.txt")
    else:  # rename_event_replay
        src.create_entry(_file_entry(ns, "/d/old.txt", b"x"))
        src.rename("/d/old.txt", "/d/new.txt")
        for event in src.subscribe_metadata(0):
            ns.agg.apply_meta_event(dst, event)
        out["new"] = dst.find_entry("/d/new.txt").to_dict()
        with pytest.raises(ns.store.NotFoundError):
            dst.find_entry("/d/old.txt")
    out["events"] = src.subscribe_metadata(0)
    return out


@pytest.mark.parametrize("case", ["apply_meta_event_create_update_delete",
                                  "rename_event_replay"])
def test_meta_aggregation_like_jax(pinned, case):
    got = _both(case, _agg_case)
    if case == "rename_event_replay":
        assert got["new"]["content"] == b"x".hex()
    else:
        assert got["after_update"]["content"] == b"22".hex()


@pytest.mark.parametrize("mix", ["port-peer", "jax-peer"])
def test_aggregator_follows_and_bootstraps_a_peer(pinned, mix):
    """A port aggregator follows a peer filer of either package, and a
    fresh port filer bootstraps from it."""
    ns = PKG["port" if mix == "port-peer" else "jax"]
    kw = {"device": "cpu"} if mix == "port-peer" else {}
    peer = ns.fserver.FilerServer(master_address="127.0.0.1:1", **kw)
    peer.server.start()
    try:
        for name in ("x", "a", "b"):
            peer.filer.create_entry(_file_entry(ns, f"/p/{name}.txt",
                                                name.encode()))
        agg = t_agg.MetaAggregator([peer.address])
        assert agg.poll_once(peer.address) == 4  # /p and three files
        assert [e["new_entry"]["full_path"] for e in agg.events()] == [
            "/p", "/p/x.txt", "/p/a.txt", "/p/b.txt"]
        assert agg.poll_once(peer.address) == 0
        assert agg.events() == peer.filer.subscribe_metadata(0)
        fresh = PKG["port"].filer.Filer()
        assert t_agg.MetaAggregator.bootstrap_from_peer(peer.address,
                                                        fresh) == 4
        assert [fresh.find_entry(f"/p/{n}.txt").content
                for n in "xab"] == [b"x", b"a", b"b"]
    finally:
        peer.server.stop()


def test_filer_aggregates_its_peers_feed(pinned, tmp_path):
    """`/metadata/aggregate` of a port filer with a JAX peer merges both
    feeds in timestamp order, as the JAX filer does with a port peer."""
    out = {}
    for me, other in (("port", "jax"), ("jax", "port")):
        peer = PKG[other].fserver.FilerServer(
            "127.0.0.1:1", **({"device": "cpu"} if other == "port" else {}))
        peer.server.start()
        me_srv = None
        try:
            peer.filer.create_entry(_file_entry(PKG[other], "/peer/f", b"p"))
            me_srv = PKG[me].fserver.FilerServer(
                "127.0.0.1:1", peers=[peer.address],
                **({"device": "cpu"} if me == "port" else {}))
            me_srv.server.start()
            me_srv.meta_aggregator.poll_once(peer.address)
            me_srv.filer.create_entry(_file_entry(PKG[me], "/mine/g", b"m"))
            out[me] = [e["new_entry"]["full_path"] for e in call(
                me_srv.address, "/metadata/aggregate")["events"]]
        finally:
            if me_srv is not None:
                me_srv.server.stop()
            peer.server.stop()
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == ["/mine", "/mine/g", "/peer", "/peer/f"]


# -- the sharded filer store --------------------------------------------------------


def _shard_case(ns, case):
    S = ns.shard_map.ShardMap
    if case == "first_holder_takes_everything":
        m = S(slots=8)
        return m.lease("a", now=0.0, ttl=10.0), m.holder_of("/any/dir")
    if case == "fair_share_converges_on_join":
        m = S(slots=8)
        return [m.lease("a", now=0.0, ttl=10.0),
                m.lease("b", now=1.0, ttl=10.0),
                m.lease("a", now=2.0, ttl=10.0),
                m.lease("b", now=3.0, ttl=10.0)]
    if case == "expiry_frees_slots":
        m = S(slots=8)
        m.lease("a", now=0.0, ttl=5.0)
        return m.lease("b", now=6.0, ttl=5.0)
    if case == "release_frees_immediately":
        m = S(slots=8)
        m.lease("a", now=0.0, ttl=10.0)
        m.lease("b", now=1.0, ttl=10.0)
        return m.release("a", now=2.0), m.lease("b", now=3.0, ttl=10.0)
    m = S(slots=4)
    return [m.lease(h, now=float(t), ttl=10.0)["epoch"]
            for t, h in enumerate("aaba")]


@pytest.mark.parametrize("case", [
    "first_holder_takes_everything", "fair_share_converges_on_join",
    "expiry_frees_slots", "release_frees_immediately",
    "epoch_only_bumps_on_change"])
def test_shard_map_like_jax(case):
    got = json.loads(json.dumps(_both(case, _shard_case)))
    if case == "first_holder_takes_everything":
        assert got[0]["slots"] == list(range(8)) and got[1] == "a"
    elif case == "fair_share_converges_on_join":
        assert got[1]["slots"] == [] and len(got[2]["slots"]) == 4
        assert set(got[2]["slots"]) | set(got[3]["slots"]) == set(range(8))
    elif case == "expiry_frees_slots":
        assert len(got["slots"]) == 8
    elif case == "release_frees_immediately":
        assert len(got[0]["released"]) == 8 and len(got[1]["slots"]) == 8
    else:
        assert got[0] == got[1] == got[2] < got[3]


def test_slot_hash_matches_the_sharded_store_like_jax(tmp_path):
    out = {}
    for pkg in PKG:
        ns = PKG[pkg]
        store = ns.store.ShardedSqliteStore(str(tmp_path / pkg),
                                            shard_count=8)
        for d in ("/photos", "/docs", "/a/b"):
            store.insert_entry(ns.entry.Entry(full_path=f"{d}/x.jpg"))
        out[pkg] = [[e["full_path"] for e in store.dump_slot(s)]
                    for s in range(8)]
        store.close()
    assert out["port"] == out["jax"]
    slot = t_shard_map.slot_of("/photos", 8)
    assert slot == j_shard_map.slot_of("/photos", 8)
    assert out["port"][slot] == ["/photos/x.jpg"]


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _dirs_for_distinct_slots(slots, a_slots, b_slots):
    a_dir = b_dir = None
    for i in range(10_000):
        d = f"/bucket{i}"
        s = t_shard_map.slot_of(d, slots)
        a_dir = a_dir or (d if s in a_slots else None)
        b_dir = b_dir or (d if s in b_slots else None)
        if a_dir and b_dir:
            return a_dir, b_dir
    raise AssertionError("the hash never hit both slot sets")


def test_port_store_servers_split_route_rename_and_take_over(tmp_path,
                                                            monkeypatch):
    """A port master's replicated shard map with two port store servers:
    the fair-share split on a join, handover of moved slots, one-hop
    routing, a cross-slot rename, the `ClusterStore` client and the
    takeover of a crashed holder's slots."""
    from seaweedfs_tpu_torch.master.server import MasterServer

    monkeypatch.setenv("WEED_FILER_SHARD_LEASE", "1.0")
    ns = PKG["port"]
    (tmp_path / "m").mkdir()
    master = MasterServer(port=0, pulse_seconds=1.0,
                          raft_dir=str(tmp_path / "m"))
    master.start()
    servers = []
    try:
        for name in ("s1", "s2"):
            servers.append(ns.store_server.FilerStoreServer(
                port=0, store=ns.store.ShardedSqliteStore(
                    str(tmp_path / name), shard_count=8),
                masters=[master.address]))
        s1, s2 = servers
        s1.start()
        assert _wait_for(lambda: len(s1._held) == 8)
        E = ns.entry.Entry
        for i in range(40):
            call(s1.address, "/store/insert", method="POST",
                 payload=E(full_path=f"/seed{i}/obj").to_dict())
        s2.start()
        assert _wait_for(lambda: len(s1._held) == len(s2._held) == 4 and
                         len(s1._map) == len(s2._map) == 8), (s1._held,
                                                              s2._held)
        assert s1._held.isdisjoint(s2._held)
        moved = [f"/seed{i}" for i in range(40)
                 if t_shard_map.slot_of(f"/seed{i}", 8) in s2._held]
        got = call(s2.address, f"/store/find?path={moved[0]}/obj")
        assert got["full_path"] == moved[0] + "/obj"
        a_dir, b_dir = _dirs_for_distinct_slots(8, s1._held, s2._held)
        call(s2.address, "/store/insert", method="POST",
             payload=E(full_path=a_dir + "/x").to_dict())
        assert call(s1.address, f"/store/find?path={a_dir}/x")[
            "full_path"] == a_dir + "/x"
        r = call(s1.address, "/store/rename", method="POST",
                 payload={"path": a_dir + "/x", "new_path": b_dir + "/y"})
        assert r["to"] == b_dir + "/y"
        with pytest.raises(RpcError) as e:
            call(s1.address, f"/store/find?path={a_dir}/x")
        assert e.value.status == 404
        cs = t_cluster_store.ClusterStore([master.address])
        cs.insert_entry(E(full_path=b_dir + "/via-client"))
        assert {e.full_path for e in cs.list_directory(b_dir)} == {
            b_dir + "/y", b_dir + "/via-client"}
        r = call(master.address, "/filer/shards")
        assert r["map"] == master.raft.fsm.shard_map.assignments()
        # crash: s2 stops renewing without a goodbye
        s2._lease_stop.set()
        if s2._lease_thread is not None:
            s2._lease_thread.join(timeout=5)
        s2.server.stop()
        servers.remove(s2)
        s2.store.close()
        assert _wait_for(lambda: len(s1._held) == 8), s1._held
        call(s1.address, "/store/insert", method="POST",
             payload=E(full_path=b_dir + "/after").to_dict())
        assert call(s1.address, f"/store/find?path={b_dir}/after")[
            "full_path"] == b_dir + "/after"
    finally:
        for srv in servers:
            srv.stop()
        master.stop()
