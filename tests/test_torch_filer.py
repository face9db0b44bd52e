"""The port's filer against the JAX package's, on the CPU.

- The chunk model (visible intervals, read views, sizes, etags) gives
  equal answers on the same chunk lists.
- The memory, sqlite and remote stores (a live `FilerStoreServer` with
  its `RemoteStore` client) answer the store conformance script alike;
  the sqlite rows are equal, and each package's client reads the other
  package's store server.
- The filer core (parents, recursive delete, chunk reclamation, rename,
  the change log, a file over a directory) gives equal entries, events
  and reclaimed chunks.
- One JAX and one port cluster (a master, two volume servers and a filer
  with 1 KiB chunks) answer the same HTTP script: chunked and inlined
  writes, Range reads, listings, deletes with chunk reclamation, renames,
  `/metadata/subscribe`, tags, `/kv/*`, glob listings and the chunk
  proxy.  Replies, entries and events are equal with fids renamed by
  their first appearance; the filers' clocks are pinned per package.
- Path TTL rules, two stateless filers over one store server, the HBM
  tier serving an overwritten path's new bytes (R1) and the fork rule
  (the constructor makes no CUDA call).
Tolerance: equality throughout.  Every server binds port 0 and is
stopped in a `finally`.
"""

import contextlib
import http.client
import itertools
import json
import re
import sqlite3
import types
import uuid

import pytest

from test_torch_volume_server import _PinnedTime

from seaweedfs_tpu import remote_storage as j_rs
from seaweedfs_tpu.filer import entry as j_entry
from seaweedfs_tpu.filer import filechunks as j_chunks
from seaweedfs_tpu.filer import filer as j_filer
from seaweedfs_tpu.filer import filer_conf as j_conf
from seaweedfs_tpu.filer import filer_store as j_store
from seaweedfs_tpu.filer import remote_storage as j_remote
from seaweedfs_tpu.filer import server as j_fserver
from seaweedfs_tpu.filer import store_server as j_store_server
from seaweedfs_tpu.master import server as j_master
from seaweedfs_tpu.rpc import http_rpc as j_rpc
from seaweedfs_tpu.util import cipher as j_cipher
from seaweedfs_tpu.volume_server import server as j_vs
from seaweedfs_tpu_torch import remote_storage as t_rs
from seaweedfs_tpu_torch.filer import entry as t_entry
from seaweedfs_tpu_torch.filer import filechunks as t_chunks
from seaweedfs_tpu_torch.filer import filer as t_filer
from seaweedfs_tpu_torch.filer import filer_conf as t_conf
from seaweedfs_tpu_torch.filer import filer_store as t_store
from seaweedfs_tpu_torch.filer import remote_storage as t_remote
from seaweedfs_tpu_torch.filer import server as t_fserver
from seaweedfs_tpu_torch.filer import store_server as t_store_server
from seaweedfs_tpu_torch.master import server as t_master
from seaweedfs_tpu_torch.rpc import http_rpc as t_rpc
from seaweedfs_tpu_torch.util import cipher as t_cipher
from seaweedfs_tpu_torch.volume_server import server as t_vs

PKG = {
    "jax": types.SimpleNamespace(
        entry=j_entry, chunks=j_chunks, filer=j_filer, conf=j_conf,
        store=j_store, remote=j_remote, rs=j_rs, fserver=j_fserver,
        store_server=j_store_server, master=j_master, vs=j_vs,
        rpc=j_rpc, cipher=j_cipher, vs_kw={}),
    "port": types.SimpleNamespace(
        entry=t_entry, chunks=t_chunks, filer=t_filer, conf=t_conf,
        store=t_store, remote=t_remote, rs=t_rs, fserver=t_fserver,
        store_server=t_store_server, master=t_master, vs=t_vs,
        rpc=t_rpc, cipher=t_cipher, vs_kw={"device": "cpu"}),
}

_FID = re.compile(r"^\d+,[0-9a-f]{9,}(_\d+)?$")


def canon(value, names=None):
    """`value` with every fid replaced by `<fN>`, N its first appearance
    (fids differ between two clusters; their roles do not)."""
    names = {} if names is None else names
    if isinstance(value, dict):
        return {k: canon(v, names) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(canon(v, names) for v in value)
    if isinstance(value, str) and _FID.match(value):
        return names.setdefault(value, f"<f{len(names)}>")
    return value


class _Frozen(_PinnedTime):
    """time() and time_ns() both pinned: chunk uploads on pool threads
    draw their stamps in no fixed order."""

    def time_ns(self):
        return 1_700_000_000_000_000_000


class _Uuids:
    """`uuid` with seeded uuid4() (hardlink ids)."""

    def __init__(self):
        self._n = itertools.count(1)

    def uuid4(self):
        return uuid.UUID(int=next(self._n))

    def __getattr__(self, name):
        return getattr(uuid, name)


def pin_clocks(mp, pkg: str):
    """Pin the filer modules' clocks (and hardlink ids) of one package."""
    ns = PKG[pkg]
    tick = _PinnedTime(pin_time=True)
    for mod in (ns.filer, ns.entry, ns.conf, ns.remote, ns.rs):
        mp.setattr(mod, "time", tick)
    mp.setattr(ns.fserver, "time", _Frozen(pin_time=True))
    mp.setattr(ns.filer, "uuid", _Uuids())


@pytest.fixture
def pinned(monkeypatch):
    for pkg in PKG:
        pin_clocks(monkeypatch, pkg)


@contextlib.contextmanager
def cluster(pkg, root, n_volumes=1, **filer_kw):
    """A master, `n_volumes` volume servers and a filer of one package;
    everything stopped on exit."""
    ns = PKG[pkg]
    started = []
    try:
        (root / "m").mkdir(parents=True)
        master = ns.master.MasterServer(port=0, pulse_seconds=0.2,
                                        raft_dir=str(root / "m"))
        master.start()
        started.append(master)
        vss = []
        for i in range(n_volumes):
            d = root / f"v{i}"
            d.mkdir()
            vs = ns.vs.VolumeServer([str(d)], master.address, port=0,
                                    pulse_seconds=0.2, **ns.vs_kw)
            vs.start()
            started.append(vs)
            vs.heartbeat_once()
            vss.append(vs)
        if pkg == "port":
            filer_kw.setdefault("device", "cpu")
        filer = ns.fserver.FilerServer(master.address, port=0, **filer_kw)
        filer.start()
        started.append(filer)
        yield master, vss, filer
    finally:
        for s in reversed(started):
            s.stop()


def request(addr, method, path, body=None, headers=None):
    """(status, reply headers worth comparing, body)."""
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        keep = {h: resp.getheader(h) for h in
                ("Content-Type", "Content-Range", "Etag", "Accept-Ranges",
                 "Content-Length")
                if resp.getheader(h) is not None}
        keep.update({k: v for k, v in resp.getheaders()
                     if k.lower().startswith("seaweed-")})
        return resp.status, keep, data
    finally:
        conn.close()


def _json(reply):
    status, headers, body = reply
    return status, json.loads(body) if body else None


# -- the chunk model --------------------------------------------------------------


def _chunk_case(ns, case):
    def chunk(fid, offset, size, ts=0, etag=""):
        return ns.entry.FileChunk(fid=fid, offset=offset, size=size,
                                  modified_ts_ns=ts, etag=etag)

    vis = ns.chunks.non_overlapping_visible_intervals
    if case == "non_overlapping":
        got = vis([chunk("a", 0, 100, 1), chunk("b", 100, 100, 2)])
    elif case == "full_overwrite":
        got = vis([chunk("a", 0, 100, 1), chunk("b", 0, 100, 2)])
    elif case == "partial_overwrite_middle":
        got = vis([chunk("a", 0, 300, 1), chunk("b", 100, 100, 2)])
    elif case == "read_views_range":
        views = ns.chunks.read_chunk_views(
            [chunk("a", 0, 100, 1), chunk("b", 100, 100, 2)], 50, 100)
        return [(v.fid, v.offset_in_chunk, v.size) for v in views]
    elif case == "total_size":
        return ns.entry.total_size([chunk("a", 0, 10), chunk("b", 100, 5)])
    else:  # etag_single_vs_multi
        c1 = chunk("a", 0, 5, etag="aabb")
        c2 = chunk("b", 5, 5, etag="ccdd")
        return (ns.chunks.etag_of_chunks([c1]),
                ns.chunks.etag_of_chunks([c1, c2]))
    return [(v.start, v.stop, v.fid, v.chunk_offset) for v in got]


@pytest.mark.parametrize("case", [
    "non_overlapping", "full_overwrite", "partial_overwrite_middle",
    "read_views_range", "total_size", "etag_single_vs_multi"])
def test_chunk_model_like_jax(case):
    port = _chunk_case(PKG["port"], case)
    assert port == _chunk_case(PKG["jax"], case)
    expect = {
        "non_overlapping": [(0, 100, "a", 0), (100, 200, "b", 0)],
        "full_overwrite": [(0, 100, "b", 0)],
        "partial_overwrite_middle": [(0, 100, "a", 0), (100, 200, "b", 0),
                                     (200, 300, "a", 200)],
        "read_views_range": [("a", 50, 50), ("b", 0, 50)],
        "total_size": 105,
    }
    if case in expect:
        assert port == expect[case]
    else:
        assert port[0] == "aabb" and port[1].endswith("-2")


# -- store conformance -------------------------------------------------------------


def _open_store(pkg, kind, root, servers):
    ns = PKG[pkg]
    if kind == "memory":
        return ns.store.MemoryStore()
    if kind == "sqlite":
        return ns.store.SqliteStore(str(root / f"{pkg}.db"))
    srv = ns.store_server.FilerStoreServer(port=0)
    srv.start()
    servers.append(srv)
    return ns.store_server.RemoteStore(srv.address)


def _store_script(ns, store, op):
    E, A, C = ns.entry.Entry, ns.entry.Attr, ns.entry.FileChunk
    names = lambda es: [e.name for e in es]  # noqa: E731
    if op == "insert_find_delete":
        store.insert_entry(E(full_path="/dir/file.txt",
                             attr=A(mtime=1.0, file_size=10)))
        found = store.find_entry("/dir/file.txt").to_dict()
        store.delete_entry("/dir/file.txt")
        with pytest.raises(ns.store.NotFoundError):
            store.find_entry("/dir/file.txt")
        return found
    if op == "list_directory_pagination":
        for i in range(10):
            store.insert_entry(E(full_path=f"/d/f{i:02d}"))
        return (names(store.list_directory("/d", limit=4)),
                names(store.list_directory("/d", start_file="f03",
                                           limit=4)))
    if op == "list_prefix":
        for name in ("apple", "banana", "apricot"):
            store.insert_entry(E(full_path=f"/d/{name}"))
        return names(store.list_directory("/d", prefix="ap"))
    if op == "delete_folder_children":
        for p in ("/a/b/c", "/a/b/d/e", "/ab/keep"):
            store.insert_entry(E(full_path=p))
        store.delete_folder_children("/a/b")
        return (names(store.list_directory("/a/b")),
                names(store.list_directory("/ab")))
    store.insert_entry(E(full_path="/f", chunks=[
        C(fid="3,ab12", offset=0, size=100, etag="ee")]))
    return store.find_entry("/f").to_dict()


_EXPECT = {
    "list_directory_pagination": (["f00", "f01", "f02", "f03"],
                                  ["f04", "f05", "f06", "f07"]),
    "list_prefix": ["apple", "apricot"],
    "delete_folder_children": ([], ["keep"]),
}


@pytest.mark.parametrize("op", ["insert_find_delete",
                                "list_directory_pagination", "list_prefix",
                                "delete_folder_children", "chunks_roundtrip"])
@pytest.mark.parametrize("kind", ["memory", "sqlite", "remote"])
def test_store_conformance_like_jax(tmp_path, kind, op):
    servers, out = [], {}
    try:
        for pkg in PKG:
            store = _open_store(pkg, kind, tmp_path, servers)
            out[pkg] = _store_script(PKG[pkg], store, op)
            store.close()
    finally:
        for srv in servers:
            srv.stop()
    assert out["port"] == out["jax"]
    if op in _EXPECT:
        assert out["port"] == _EXPECT[op]
    if kind == "sqlite":
        rows = {}
        for pkg in PKG:
            with sqlite3.connect(tmp_path / f"{pkg}.db") as db:
                rows[pkg] = db.execute(
                    "SELECT * FROM filemeta ORDER BY 1, 2").fetchall()
        assert rows["port"] == rows["jax"]


@pytest.mark.parametrize("client", ["port-client-jax-server",
                                    "jax-client-port-server"])
def test_remote_store_crosses_packages(client):
    srv_pkg, cli_pkg = (("jax", "port") if client.startswith("port")
                        else ("port", "jax"))
    srv = PKG[srv_pkg].store_server.FilerStoreServer(port=0)
    srv.start()
    try:
        store = PKG[cli_pkg].store_server.RemoteStore(srv.address)
        got = _store_script(PKG[cli_pkg], store, "chunks_roundtrip")
        listed = [e.full_path for e in store.list_directory("/")]
        store.close()
    finally:
        srv.stop()
    assert got == _store_script(PKG["jax"], j_store.MemoryStore(),
                                "chunks_roundtrip")
    assert listed == ["/f"]


# -- the filer core ---------------------------------------------------------------


def _core_case(ns, case):
    f = ns.filer.Filer()
    E, A, C = ns.entry.Entry, ns.entry.Attr, ns.entry.FileChunk
    reclaimed = []
    f.on_delete_chunks = reclaimed.extend
    out = {}
    if case == "parent_dirs_auto_created":
        f.create_entry(E(full_path="/a/b/c/file"))
        out["dirs"] = [f.find_entry(p).to_dict() for p in ("/a/b/c", "/a")]
    elif case == "delete_directory_requires_recursive":
        f.create_entry(E(full_path="/d/x"))
        with pytest.raises(ValueError) as e:
            f.delete_entry("/d")
        out["error"] = str(e.value)
        f.delete_entry("/d", recursive=True)
        with pytest.raises(ns.store.NotFoundError):
            f.find_entry("/d")
    elif case == "delete_reclaims_chunks":
        f.create_entry(E(full_path="/f", chunks=[C(fid="1,aa", offset=0,
                                                   size=5)]))
        f.delete_entry("/f")
    elif case == "overwrite_reclaims_orphaned_chunks":
        f.create_entry(E(full_path="/f", chunks=[C(fid="1,aa", offset=0,
                                                   size=5)]))
        f.create_entry(E(full_path="/f", chunks=[C(fid="1,bb", offset=0,
                                                   size=6)]))
    elif case == "rename_file_and_dir":
        f.create_entry(E(full_path="/old/f1"))
        f.create_entry(E(full_path="/old/sub/f2"))
        f.rename("/old", "/new")
        out["new"] = [f.find_entry(p).to_dict()
                      for p in ("/new/f1", "/new/sub/f2")]
        with pytest.raises(ns.store.NotFoundError):
            f.find_entry("/old/f1")
    elif case == "metadata_log":
        f.create_entry(E(full_path="/x/y"))
        f.delete_entry("/x/y")
        out["scoped"] = f.subscribe_metadata(since_ns=0, path_prefix="/other")
    elif case == "file_over_directory_rejected":
        f.create_entry(E(full_path="/d/child"))
        with pytest.raises(ValueError) as e:
            f.create_entry(E(full_path="/d", attr=A(file_size=3)))
        out["error"] = str(e.value)
    else:  # expired_entry_vanishes
        now = ns.filer.time.time()
        f.create_entry(E(full_path="/t/old.bin",
                         attr=A(mtime=now - 100, crtime=now - 100,
                                ttl_sec=10, file_size=1), content=b"x"))
        f.create_entry(E(full_path="/t/fresh.bin",
                         attr=A(mtime=now, crtime=now, ttl_sec=3600,
                                file_size=1), content=b"y"))
        out["names"] = [e.name for e in f.list_directory("/t")]
        with pytest.raises(ns.store.NotFoundError):
            f.find_entry("/t/old.bin")
    out["reclaimed"] = [c.fid for c in reclaimed]
    out["events"] = f.subscribe_metadata(0)
    return out


@pytest.mark.parametrize("case", [
    "parent_dirs_auto_created", "delete_directory_requires_recursive",
    "delete_reclaims_chunks", "overwrite_reclaims_orphaned_chunks",
    "rename_file_and_dir", "metadata_log", "file_over_directory_rejected",
    "expired_entry_vanishes"])
def test_filer_core_like_jax(pinned, case):
    port = _core_case(PKG["port"], case)
    assert port == _core_case(PKG["jax"], case)
    if case == "delete_reclaims_chunks" or \
            case == "overwrite_reclaims_orphaned_chunks":
        assert port["reclaimed"] == ["1,aa"]
    if case == "metadata_log":
        # mkdir /x + create /x/y + delete /x/y
        assert len(port["events"]) == 3 and port["scoped"] == []
        assert port["events"][-1]["new_entry"] is None
    if case == "expired_entry_vanishes":
        assert port["names"] == ["fresh.bin"]


# -- one cluster of each package, answering the same HTTP script --------------------


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """A JAX and a port cluster (two volume servers, a filer with 1 KiB
    chunks), their filer clocks pinned for the module."""
    root = tmp_path_factory.mktemp("stacks")
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as es:
        mp.setenv("WEED_MAINT", "0")
        mp.setenv("WEED_MAINT_WORKER", "0")
        out = {}
        for pkg in PKG:
            pin_clocks(mp, pkg)
            out[pkg] = es.enter_context(cluster(pkg, root / pkg, 2,
                                                chunk_size=1024))
        yield out


def _both(stacks, script):
    out = {pkg: canon(script(*stacks[pkg], PKG[pkg])) for pkg in PKG}
    assert out["port"] == out["jax"]
    return out["port"]


PAYLOAD = bytes(range(256)) * 20  # 5120 bytes: five 1 KiB chunks


def test_write_read_roundtrip_chunked_like_jax(stacks):
    def script(master, vss, filer, ns):
        post = _json(request(filer.address, "POST", "/docs/data.bin",
                             PAYLOAD, {"Content-Type": "application/x-bin"}))
        got = request(filer.address, "GET", "/docs/data.bin")
        head = request(filer.address, "HEAD", "/docs/data.bin")
        return post, got, head, filer.filer.find_entry(
            "/docs/data.bin").to_dict()

    post, got, head, entry = _both(stacks, script)
    assert post == (200, {"name": "data.bin", "size": len(PAYLOAD),
                          "md5": entry["attr"]["md5"]})
    assert got[0] == 200 and got[2] == PAYLOAD
    assert head[0] == 200 and head[2] == b""
    assert [c["offset"] for c in entry["chunks"]] == [0, 1024, 2048, 3072,
                                                     4096]


def test_small_file_inlined_like_jax(stacks):
    def script(master, vss, filer, ns):
        request(filer.address, "POST", "/small.txt", b"tiny")
        return (filer.filer.find_entry("/small.txt").to_dict(),
                request(filer.address, "GET", "/small.txt"))

    entry, got = _both(stacks, script)
    assert entry["content"] == b"tiny".hex() and entry["chunks"] == []
    assert got[2] == b"tiny"


@pytest.mark.parametrize("spec", ["bytes=1000-2999", "bytes=-100",
                                  "bytes=5000-", "bytes=6000-7000"])
def test_range_read_like_jax(stacks, spec):
    path = "/r/" + spec.replace("=", "_")

    def script(master, vss, filer, ns):
        request(filer.address, "POST", path, PAYLOAD)
        return request(filer.address, "GET", path, headers={"Range": spec})

    status, headers, body = _both(stacks, script)
    if spec == "bytes=6000-7000":
        assert status == 416
    else:
        lo, hi = {"bytes=1000-2999": (1000, 3000), "bytes=-100": (5020, 5120),
                  "bytes=5000-": (5000, 5120)}[spec]
        assert status == 206 and body == PAYLOAD[lo:hi]
        assert headers["Content-Range"] == f"bytes {lo}-{hi - 1}/5120"


def test_directory_listing_like_jax(stacks):
    def script(master, vss, filer, ns):
        for name in ("a.txt", "b.txt", "c.txt"):
            request(filer.address, "POST", f"/dir/{name}", b"x")
        request(filer.address, "POST", "/dir/big.bin", PAYLOAD)
        return (_json(request(filer.address, "GET", "/dir")),
                _json(request(filer.address, "GET",
                              "/dir/?limit=2&lastFileName=b.txt")),
                _json(request(filer.address, "GET",
                              "/dir/?metadata=true")))

    plain, page, meta = _both(stacks, script)
    assert [e["FullPath"] for e in plain[1]["Entries"]] == [
        "/dir/a.txt", "/dir/b.txt", "/dir/big.bin", "/dir/c.txt"]
    assert [e["FullPath"] for e in page[1]["Entries"]] == [
        "/dir/big.bin", "/dir/c.txt"]
    assert len(meta[1]["Entries"][2]["chunks"]) == 5


def test_delete_and_chunk_reclaim_like_jax(stacks):
    def script(master, vss, filer, ns):
        request(filer.address, "POST", "/del.bin", b"z" * 3000)
        fids = [c.fid for c in filer.filer.find_entry("/del.bin").chunks]
        deleted = request(filer.address, "DELETE", "/del.bin")
        gone = request(filer.address, "GET", "/del.bin")[0]
        chunk_status = []
        for fid in fids:
            url = ns.rpc.call(master.address,
                              f"/dir/lookup?volumeId={fid.split(',')[0]}"
                              )["locations"][0]["url"]
            chunk_status.append(request(url, "GET", f"/{fid}")[0])
        return fids, deleted[0], gone, chunk_status

    fids, deleted, gone, chunk_status = _both(stacks, script)
    assert len(fids) == 3 and deleted == 204 and gone == 404
    assert chunk_status == [404, 404, 404]


def test_recursive_delete_like_jax(stacks):
    def script(master, vss, filer, ns):
        request(filer.address, "POST", "/tree/a/1.bin", PAYLOAD[:2000])
        request(filer.address, "POST", "/tree/a/b/2.txt", b"2")
        refused = _json(request(filer.address, "DELETE", "/tree"))
        done = request(filer.address, "DELETE", "/tree?recursive=true")[0]
        return refused, done, request(filer.address, "GET", "/tree/a")[0]

    refused, done, gone = _both(stacks, script)
    assert refused[0] == 400 and done == 204 and gone == 404


def test_rename_via_mv_from_like_jax(stacks):
    def script(master, vss, filer, ns):
        request(filer.address, "POST", "/src.txt", b"move me")
        request(filer.address, "POST", "/mv/big.bin", PAYLOAD)
        out = [_json(request(filer.address, "POST",
                             "/dst.txt?mv.from=/src.txt", b"")),
               _json(request(filer.address, "POST",
                             "/moved/?mv.from=/mv", b""))]
        return out + [request(filer.address, "GET", p)[::2]
                      for p in ("/dst.txt", "/src.txt", "/moved/big.bin")]

    renamed, moved, dst, src, big = _both(stacks, script)
    assert renamed == (200, {"from": "/src.txt", "to": "/dst.txt"})
    assert dst == (200, b"move me") and src[0] == 404
    assert big == (200, PAYLOAD)


def test_metadata_subscribe_like_jax(stacks):
    def script(master, vss, filer, ns):
        request(filer.address, "POST", "/sub/f.txt", b"x")
        request(filer.address, "POST", "/sub/g.bin", PAYLOAD[:3000])
        request(filer.address, "DELETE", "/sub/f.txt")
        events = _json(request(filer.address, "GET",
                               "/metadata/subscribe?pathPrefix=/sub"))
        since = events[1]["events"][1]["ts_ns"]
        later = _json(request(filer.address, "GET",
                              f"/metadata/subscribe?since={since}"
                              "&pathPrefix=/sub"))
        return events, later

    events, later = _both(stacks, script)
    kinds = [(e["old_entry"] or {}).get("full_path", "") + ">" +
             (e["new_entry"] or {}).get("full_path", "")
             for e in events[1]["events"]]
    assert kinds == [">/sub/f.txt", ">/sub/g.bin", "/sub/f.txt>"]
    assert len(later[1]["events"]) == 1


def test_object_tagging_lifecycle_like_jax(stacks):
    def script(master, vss, filer, ns):
        a = filer.address
        out = [request(a, "POST", "/t/file.txt", b"data")[0],
               request(a, "PUT", "/t/file.txt?tagging", b"",
                       {"Seaweed-Color": "blue", "Seaweed-Owner": "ops",
                        "X-Other": "ignored"})[0],
               _json(request(a, "GET", "/t/file.txt?tagging")),
               request(a, "GET", "/t/file.txt"),
               request(a, "DELETE", "/t/file.txt?tagging=Color")[0],
               _json(request(a, "GET", "/t/file.txt?tagging")),
               request(a, "DELETE", "/t/file.txt?tagging")[0],
               _json(request(a, "GET", "/t/file.txt?tagging")),
               request(a, "DELETE", "/t/file.txt?tagging")[0],
               # lowercase tag headers read back and delete too
               request(a, "POST", "/t/lower.txt", b"x")[0],
               request(a, "PUT", "/t/lower.txt?tagging", b"",
                       {"seaweed-shade": "grey"})[0],
               _json(request(a, "GET", "/t/lower.txt?tagging")),
               request(a, "DELETE", "/t/lower.txt?tagging=Shade")[0],
               _json(request(a, "GET", "/t/lower.txt?tagging"))]
        return out

    out = _both(stacks, script)
    assert out[2] == (200, {"Seaweed-Color": "blue", "Seaweed-Owner": "ops"})
    assert out[3][1]["Seaweed-Color"] == "blue" and out[3][2] == b"data"
    assert out[5] == (200, {"Seaweed-Owner": "ops"}) and out[7] == (200, {})
    assert out[8] == 304
    assert out[11][1] in ({"seaweed-shade": "grey"}, {"Seaweed-Shade": "grey"})
    assert out[13] == (200, {})


def test_kv_api_like_jax(stacks):
    import base64

    key = base64.b64encode(b"cluster/state").decode()
    ukey = base64.urlsafe_b64encode(b"cluster/state").decode()

    def script(master, vss, filer, ns):
        a = filer.address
        put = lambda v: _json(request(  # noqa: E731
            a, "POST", "/kv/put", json.dumps({"key": key, "value": v})))
        return [put(base64.b64encode(b"v1").decode()),
                _json(request(a, "GET", f"/kv/get?key={ukey}")),
                put(""),
                _json(request(a, "GET", f"/kv/get?key={ukey}")),
                _json(request(a, "GET", "/kv/get?key=%21not-base64%21"))[0],
                _json(request(a, "POST", "/kv/put",
                              json.dumps({"key": "!bad!", "value": ""})))[0],
                [e["FullPath"] for e in _json(request(
                    a, "GET", "/?limit=100"))[1]["Entries"]
                 if e["FullPath"].startswith("/etc/seaweedfs/kv")]]

    out = _both(stacks, script)
    assert base64.b64decode(out[1][1]["value"]) == b"v1"
    assert out[3] == (200, {"value": None})
    assert out[4] == 400 and out[5] == 400 and out[6] == []


def test_glob_listing_like_jax(stacks):
    def script(master, vss, filer, ns):
        for name in ("a1.log", "a2.log", "a2.txt", "b1.log", "readme"):
            request(filer.address, "POST", f"/g/{name}", b"x")
        return [[e["FullPath"].rsplit("/", 1)[1] for e in _json(
            request(filer.address, "GET", "/g/?" + q))[1]["Entries"]]
            for q in ("namePattern=*.log", "namePattern=a%3F.log",
                      "namePattern=a*&namePatternExclude=*.txt",
                      "prefix=a2")]

    out = _both(stacks, script)
    assert out == [["a1.log", "a2.log", "b1.log"], ["a1.log", "a2.log"],
                   ["a1.log", "a2.log"], ["a2.log", "a2.txt"]]


def test_chunk_proxy_like_jax(stacks):
    payload = bytes(range(256)) * 40

    def script(master, vss, filer, ns):
        request(filer.address, "POST", "/p/blob.bin", payload)
        fid = filer.filer.find_entry("/p/blob.bin").chunks[0].fid
        return (fid, request(filer.address, "GET", f"/?proxyChunkId={fid}"),
                request(filer.address, "GET", f"/?proxyChunkId={fid}",
                        headers={"Range": "bytes=100-199"}))

    fid, whole, ranged = _both(stacks, script)
    assert whole[0] == 200 and whole[2] == payload[:1024]
    assert ranged[0] == 206 and ranged[2] == payload[100:200]
    assert ranged[1]["Content-Range"] == "bytes 100-199/1024"


def test_overwrite_and_read_only_rule_like_jax(stacks):
    def script(master, vss, filer, ns):
        a = filer.address
        request(a, "POST", "/ow/f.bin", PAYLOAD)
        request(a, "POST", "/ow/f.bin", PAYLOAD[::-1][:2500])
        conf = ns.conf.FilerConf()
        conf.add(ns.conf.PathConf(location_prefix="/ro/", read_only=True))
        conf.save(filer.filer)
        filer._conf_cache = (0.0, conf)
        out = [request(a, "GET", "/ow/f.bin")[::2],
               _json(request(a, "POST", "/ro/x.txt", b"x")),
               filer.filer.find_entry("/ow/f.bin").to_dict()]
        conf.delete("/ro/")
        conf.save(filer.filer)
        filer._conf_cache = (0.0, conf)
        return out

    got, refused, entry = _both(stacks, script)
    assert got == (200, PAYLOAD[::-1][:2500])
    assert refused[0] == 403 and len(entry["chunks"]) == 3


# -- configurations of their own ---------------------------------------------------


def test_ttl_rule_flows_to_assign_and_entry_like_jax(tmp_path, pinned,
                                                     monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    out = {}
    for pkg in PKG:
        ns = PKG[pkg]
        with cluster(pkg, tmp_path / pkg, chunk_size=1024) as (m, _, filer):
            conf = ns.conf.FilerConf()
            conf.add(ns.conf.PathConf(location_prefix="/cache/", ttl="3m"))
            conf.save(filer.filer)
            filer._conf_cache = (0.0, conf)
            entry = filer.save_bytes("/cache/x.bin", b"z" * 4000)
            vid = int(entry.chunks[0].fid.split(",")[0])
            status = ns.rpc.call(m.address, "/dir/status")
            vol = next(v for dc in status["datacenters"]
                       for r in dc["racks"] for n in r["nodes"]
                       for v in n["volume_list"] if v["id"] == vid)
            out[pkg] = (canon(entry.to_dict()), vol.get("ttl"),
                        filer.read_bytes(entry))
    assert out["port"] == out["jax"]
    assert out["port"][0]["attr"]["ttl_sec"] == 180
    assert out["port"][1] not in (0, "", None)
    assert out["port"][2] == b"z" * 4000


def test_two_filers_share_one_store_server(tmp_path):
    """Two stateless port filers over a JAX `filer.store` and two JAX
    filers over a port one see one namespace."""
    out = {}
    for srv_pkg, filer_pkg in (("jax", "port"), ("port", "jax")):
        ns = PKG[filer_pkg]
        srv = PKG[srv_pkg].store_server.FilerStoreServer(port=0)
        srv.start()
        filers = []
        try:
            for _ in range(3):
                kw = {"device": "cpu"} if filer_pkg == "port" else {}
                f = ns.fserver.FilerServer(
                    "127.0.0.1:1", store=ns.store_server.RemoteStore(
                        srv.address), **kw)
                f.server.start()
                filers.append(f)
            fa, fb, fc = (f.address for f in filers)
            out[filer_pkg] = [
                request(fa, "POST", "/shared/hello.txt", b"from-A")[0],
                request(fb, "GET", "/shared/hello.txt")[::2],
                request(fb, "PUT", "/shared/hello.txt?tagging", b"",
                        {"Seaweed-Team": "infra"})[0],
                _json(request(fa, "GET", "/shared/hello.txt?tagging")),
                request(fb, "DELETE", "/shared/hello.txt")[0],
                request(fa, "GET", "/shared/hello.txt")[0],
                _json(request(fc, "GET", "/shared/"))[1]["Entries"]]
        finally:
            for f in filers:
                f.server.stop()
            srv.stop()
    assert out["port"] == out["jax"]
    assert out["port"][1] == (200, b"from-A")
    assert out["port"][3] == (200, {"Seaweed-Team": "infra"})
    assert out["port"][5] == 404 and out["port"][6] == []


def test_port_filer_over_jax_volume_servers(tmp_path, monkeypatch):
    """A port filer chunks into, reads from and reclaims on a JAX
    cluster."""
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    ns = PKG["jax"]
    (tmp_path / "m").mkdir()
    (tmp_path / "v").mkdir()
    master = ns.master.MasterServer(port=0, pulse_seconds=0.2,
                                    raft_dir=str(tmp_path / "m"))
    started = [master]
    try:
        master.start()
        vs = ns.vs.VolumeServer([str(tmp_path / "v")], master.address,
                                port=0, pulse_seconds=0.2)
        vs.start()
        started.append(vs)
        vs.heartbeat_once()
        filer = t_fserver.FilerServer(master.address, port=0,
                                      chunk_size=1024, device="cpu")
        filer.start()
        started.append(filer)
        request(filer.address, "POST", "/x/p.bin", PAYLOAD)
        fids = [c.fid for c in filer.filer.find_entry("/x/p.bin").chunks]
        assert request(filer.address, "GET", "/x/p.bin")[2] == PAYLOAD
        assert request(filer.address, "GET", "/x/p.bin",
                       headers={"Range": "bytes=1500-2600"})[2] == \
            PAYLOAD[1500:2601]
        assert request(filer.address, "DELETE", "/x/p.bin")[0] == 204
        assert [request(vs.address, "GET", f"/{fid}")[0]
                for fid in fids] == [404] * 5
    finally:
        for s in reversed(started):
            s.stop()


def test_overwrite_serves_new_bytes_from_the_hbm_tier(tmp_path,
                                                      monkeypatch):
    """R1 at the filer: with the HBM tier on (CPU device), a path whose
    chunks were promoted to the tier and then left the RAM tier reads
    back its new bytes after an overwrite."""
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_READ_CACHE_HBM_MB", "1")
    old, new = PAYLOAD, bytes(reversed(PAYLOAD))
    with cluster("port", tmp_path, chunk_size=1024) as (_, _, filer):
        cache = filer.chunk_cache
        assert cache.hbm is not None
        for body in (old, new):
            request(filer.address, "POST", "/hot/f.bin", body)
            for _ in range(3):  # a miss, then RAM hits that promote
                assert request(filer.address, "GET", "/hot/f.bin")[2] == body
            cache.mem.clear()
            before = cache.stats_snapshot()["tier_hits"]["hbm"]
            assert request(filer.address, "GET", "/hot/f.bin")[2] == body
            assert cache.stats_snapshot()["tier_hits"]["hbm"] == before + 5
        assert cache.hbm.size_bytes == len(new)  # the old chunks left


def test_filer_constructor_makes_no_cuda_call(monkeypatch):
    """The fork rule: a filer whose HBM tier is on the card (device left
    to the card) is built without any CUDA runtime call; the card is
    found through NVML and touched at the first upload."""
    import torch

    calls = []

    def record(name, ret=None):
        def fn(*a, **kw):
            calls.append(name)
            return ret
        return fn

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name, ret in (("is_available", True), ("current_device", 0),
                      ("init", None), ("_lazy_init", None),
                      ("set_device", None), ("synchronize", None)):
        monkeypatch.setattr(torch.cuda, name, record(name, ret))
    monkeypatch.setattr(torch._C, "_cuda_getDeviceCount",
                        record("_cuda_getDeviceCount", 1), raising=False)
    monkeypatch.setenv("WEED_READ_CACHE_HBM_MB", "64")
    f = t_fserver.FilerServer("127.0.0.1:1", port=0)
    try:
        assert f.chunk_cache.hbm.device == torch.device("cuda", 0)
    finally:
        f.server.httpd.server_close()
        f.chunk_cache.close()
        f._io_pool.shutdown(wait=False)
    assert calls == []


def test_filer_with_the_hbm_tier_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("WEED_READ_CACHE_HBM_MB", "64")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fserver.FilerServer("127.0.0.1:1", port=0)
