"""The port's replication against the JAX package's, on the CPU.

Two clusters per package (a master, a volume server and a filer with
512-byte chunks each, as `tests/test_replication.py` builds them) take
the same writes, renames and deletes, and each package's `Replicator`
carries them from cluster a to a sink: a `FilerSink` on cluster b (with
path scoping, excluded directories and the signatures that break an
active-active loop), a `LocalSink` (full and incremental), an `S3Sink`
into cluster b's gateway, parallel lanes (`run_once(concurrency=4)`),
the file queue and the Kafka wire protocol (`run_from_queue`, with the
repo's stub broker); `MetaBackup` and `restore_listing` back a path up
into sqlite; `make_sink` parses the same specs.  The applied counts, the
sink's files and bytes, and the restored listings are equal.

R9 (ROADMAP §3): a bucket with a completed multipart upload.  Its parts'
create events name paths that the completion deleted, so the JAX
`Replicator` fails on the first part, returns, and `-once` stops there
(a continuous sync retries it forever); the port skips those events
and replicates the whole bucket.  Tolerance: equality throughout.
Every server binds port 0 and is stopped in a `finally`.
"""

import contextlib
import os
import time
import types

import pytest

from test_torch_filer import _Uuids

from seaweedfs_tpu import notification as j_notification
from seaweedfs_tpu import replication as j_repl
from seaweedfs_tpu.filer import filer_store as j_store
from seaweedfs_tpu.filer import server as j_fserver
from seaweedfs_tpu.master import server as j_master
from seaweedfs_tpu.notification import kafka_wire as j_kafka
from seaweedfs_tpu.replication import meta_backup as j_meta
from seaweedfs_tpu.replication import replicator as j_replicator
from seaweedfs_tpu.rpc import http_rpc as j_rpc
from seaweedfs_tpu.s3api import server as j_s3
from seaweedfs_tpu.volume_server import server as j_vs
from seaweedfs_tpu_torch import notification as t_notification
from seaweedfs_tpu_torch import replication as t_repl
from seaweedfs_tpu_torch.filer import filer_store as t_store
from seaweedfs_tpu_torch.filer import server as t_fserver
from seaweedfs_tpu_torch.master import server as t_master
from seaweedfs_tpu_torch.notification import kafka_wire as t_kafka
from seaweedfs_tpu_torch.replication import meta_backup as t_meta
from seaweedfs_tpu_torch.replication import replicator as t_replicator
from seaweedfs_tpu_torch.rpc import http_rpc as t_rpc
from seaweedfs_tpu_torch.s3api import server as t_s3
from seaweedfs_tpu_torch.volume_server import server as t_vs

PKG = {
    "jax": types.SimpleNamespace(
        master=j_master, vs=j_vs, fserver=j_fserver, repl=j_repl,
        replicator=j_replicator, meta=j_meta, rpc=j_rpc, s3=j_s3,
        store=j_store, notification=j_notification, kafka=j_kafka, kw={}),
    "port": types.SimpleNamespace(
        master=t_master, vs=t_vs, fserver=t_fserver, repl=t_repl,
        replicator=t_replicator, meta=t_meta, rpc=t_rpc, s3=t_s3,
        store=t_store, notification=t_notification, kafka=t_kafka,
        kw={"device": "cpu"}),
}


@contextlib.contextmanager
def mini_cluster(pkg, root, chunk_size=512):
    ns = PKG[pkg]
    started = []
    try:
        master = ns.master.MasterServer(port=0, pulse_seconds=0.2)
        master.start()
        started.append(master)
        root.mkdir(parents=True)
        vs = ns.vs.VolumeServer([str(root)], master.address, port=0,
                                pulse_seconds=0.2, **ns.kw)
        vs.start()
        started.append(vs)
        vs.heartbeat_once()
        filer = ns.fserver.FilerServer(master.address, port=0,
                                       chunk_size=chunk_size, **ns.kw)
        filer.start()
        started.append(filer)
        yield filer
    finally:
        for s in reversed(started):
            s.stop()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Clusters a and b of each package, shared by the module: each test
    writes under its own top-level directory."""
    root = tmp_path_factory.mktemp("repl")
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as es:
        mp.setenv("WEED_MAINT", "0")
        mp.setenv("WEED_MAINT_WORKER", "0")
        out = {}
        for pkg in PKG:
            out[pkg] = tuple(es.enter_context(
                mini_cluster(pkg, root / pkg / tag)) for tag in ("a", "b"))
        yield out


def _both(clusters, script):
    out = {pkg: script(ns, *clusters[pkg]) for pkg, ns in PKG.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def put(ns, filer, path, body, mime="text/plain"):
    ns.rpc.call(filer.address, path, raw=body, method="POST",
                headers={"Content-Type": mime})


def get(ns, filer, path):
    """The file's bytes, or the status of the error."""
    try:
        return ns.rpc.call(filer.address, path, parse=False)
    except ns.rpc.RpcError as e:
        return e.status


def tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


BIG = bytes((i * 7) % 251 for i in range(2048))  # > chunk_size: chunked


def test_filer_sink_create_update_delete_like_jax(clusters):
    def script(ns, fa, fb):
        rep = ns.repl.Replicator(ns.repl.FilerSource(fa.address, "/fs1/"),
                                 ns.repl.FilerSink(fb.address, "/fs1"))
        put(ns, fa, "/fs1/docs/readme.txt", b"hello replication")
        put(ns, fa, "/fs1/docs/big.bin", BIG, "application/octet-stream")
        applied1, cursor = rep.run_once(0)
        state1 = [get(ns, fb, "/fs1/docs/readme.txt"),
                  get(ns, fb, "/fs1/docs/big.bin")]
        put(ns, fa, "/fs1/docs/readme.txt", b"updated")
        applied2, cursor = rep.run_once(cursor)
        ns.rpc.call(fa.address, "/fs1/docs/big.bin", method="DELETE")
        applied3, cursor = rep.run_once(cursor)
        applied4, _ = rep.run_once(cursor)
        return (applied1, state1, applied2, applied3, applied4,
                get(ns, fb, "/fs1/docs/readme.txt"),
                get(ns, fb, "/fs1/docs/big.bin"))

    out = _both(clusters, script)
    assert out[1] == [b"hello replication", BIG]
    assert out[4] == 0 and out[5] == b"updated" and out[6] == 404


def test_rename_becomes_delete_create_like_jax(clusters):
    def script(ns, fa, fb):
        rep = ns.repl.Replicator(ns.repl.FilerSource(fa.address, "/rn/"),
                                 ns.repl.FilerSink(fb.address, "/rn"))
        put(ns, fa, "/rn/a.txt", b"payload")
        _, cursor = rep.run_once(0)
        ns.rpc.call(fa.address, "/rn/b.txt?mv.from=/rn/a.txt", raw=b"",
                    method="POST")
        applied, _ = rep.run_once(cursor)
        return (applied, get(ns, fb, "/rn/b.txt"), get(ns, fb, "/rn/a.txt"))

    assert _both(clusters, script)[1:] == (b"payload", 404)


def test_path_scoping_and_exclude_like_jax(clusters):
    def script(ns, fa, fb):
        rep = ns.repl.Replicator(
            ns.repl.FilerSource(fa.address, "/data/"),
            ns.repl.FilerSink(fb.address, "/mirror"),
            exclude_dirs=["/data/tmp"])
        put(ns, fa, "/data/keep.txt", b"keep")
        put(ns, fa, "/data/tmp/skip.txt", b"skip")
        put(ns, fa, "/outside.txt", b"outside")
        applied, _ = rep.run_once(0)
        return (applied, [get(ns, fb, p) for p in (
            "/mirror/keep.txt", "/mirror/tmp/skip.txt",
            "/mirror/outside.txt", "/outside.txt")])

    applied, got = _both(clusters, script)
    assert got == [b"keep", 404, 404, 404]


def test_signature_breaks_active_active_loop_like_jax(clusters):
    def script(ns, fa, fb):
        ab = ns.repl.Replicator(
            ns.repl.FilerSource(fa.address, "/aa/"),
            ns.repl.FilerSink(fb.address, "/aa", signature=111),
            signature=222)
        ba = ns.repl.Replicator(
            ns.repl.FilerSource(fb.address, "/aa/"),
            ns.repl.FilerSink(fa.address, "/aa", signature=222),
            signature=111)
        put(ns, fa, "/aa/x.txt", b"from-a")
        steps = [ab.run_once(0)[0]]
        back, ba_cursor = ba.run_once(0)
        steps.append(back)
        put(ns, fb, "/aa/y.txt", b"from-b")
        applied, _ = ba.run_once(ba_cursor)
        steps.append(applied)
        steps.append(ab.run_once(0)[0])
        return steps, get(ns, fa, "/aa/x.txt"), get(ns, fa, "/aa/y.txt")

    steps, x, y = _both(clusters, script)
    assert steps[1] == 0 and steps[2] == 1 and (x, y) == (b"from-a",
                                                          b"from-b")


@pytest.mark.parametrize("incremental", [False, True])
def test_local_sink_like_jax(clusters, tmp_path, incremental):
    def script(ns, fa, fb):
        d = tmp_path / f"{ns.fserver.__name__.split('.')[0]}"
        top = f"/site{int(incremental)}"
        rep = ns.repl.Replicator(
            ns.repl.FilerSource(fa.address, top + "/"),
            ns.repl.LocalSink(str(d), is_incremental=incremental))
        put(ns, fa, f"{top}/index.html", b"<html>hi</html>")
        put(ns, fa, f"{top}/assets/app.js", b"console.log(1)")
        put(ns, fa, f"{top}/assets/big.bin", BIG)
        applied, cursor = rep.run_once(0)
        first = tree(d)
        ns.rpc.call(fa.address, f"{top}/index.html", method="DELETE")
        applied2, _ = rep.run_once(cursor)
        return applied, first, applied2, tree(d)

    applied, first, applied2, after = _both(clusters, script)
    date = time.strftime("%Y-%m-%d", time.gmtime())
    prefix = f"{date}/" if incremental else ""
    assert first[f"{prefix}assets/big.bin"] == BIG
    assert f"{prefix}index.html" not in after


def test_s3_sink_into_the_gateway_like_jax(clusters):
    def script(ns, fa, fb):
        s3 = ns.s3.S3ApiServer(fb, port=0)
        s3.start()
        try:
            sink = ns.repl.make_sink(f"s3://mirror/pre?endpoint={s3.address}")
            sink.client.create_bucket("mirror")
            rep = ns.repl.Replicator(ns.repl.FilerSource(fa.address, "/s3s/"),
                                     sink)
            put(ns, fa, "/s3s/obj.bin", b"s3-bound bytes")
            put(ns, fa, "/s3s/dir/big.bin", BIG)
            applied, cursor = rep.run_once(0)
            got = [sink.client.get_object("mirror", k)
                   for k in ("pre/obj.bin", "pre/dir/big.bin")]
            ns.rpc.call(fa.address, "/s3s/obj.bin", method="DELETE")
            applied2, _ = rep.run_once(cursor)
            return (applied, got, applied2,
                    sorted(sink.client.list_keys("mirror")))
        finally:
            s3.stop()

    out = _both(clusters, script)
    assert out[1] == [b"s3-bound bytes", BIG] and out[3] == [
        "pre/dir/big.bin"]


def test_meta_backup_and_restore_listing_like_jax(clusters, tmp_path):
    def script(ns, fa, fb):
        store = str(tmp_path / f"{ns.fserver.__name__.split('.')[0]}.db")
        put(ns, fa, "/m/one.txt", b"1")
        put(ns, fa, "/m/two.txt", b"22")
        put(ns, fa, "/m/sub/big.bin", BIG)
        backup = ns.meta.MetaBackup(fa.address, "/m", store)
        first, again = backup.run_once(), backup.run_once()
        ns.rpc.call(fa.address, "/m/one.txt", method="DELETE")
        third = backup.run_once()
        backup.close()
        listed = ns.meta.restore_listing(store, "/m")
        return first, again, third, sorted(
            (e["full_path"], e["attr"]["file_size"], len(e["chunks"]),
             e["attr"]["md5"]) for e in listed)

    first, again, third, listed = _both(clusters, script)
    assert again == 0 and third == 1
    assert [p for p, *_ in listed] == ["/m/sub", "/m/sub/big.bin",
                                       "/m/two.txt"]


@pytest.mark.parametrize("spec", ["filer://h:1/dir", "local:///tmp/x",
                                  "s3://b/d?endpoint=h:1", "s3://b/d",
                                  "ftp://nope"])
def test_make_sink_like_jax(spec):
    def script(ns):
        try:
            sink = ns.repl.make_sink(spec)
        except ValueError as e:
            return "error", str(e)
        return (sink.name, getattr(sink, "bucket", None),
                getattr(sink, "directory", None),
                getattr(sink, "sink_dir", None))

    out = {pkg: script(ns) for pkg, ns in PKG.items()}
    assert out["port"] == out["jax"]


def test_parallel_lanes_like_jax(clusters):
    def script(ns, fa, fb):
        bodies = {}
        for i in range(24):
            body = (b"payload-%02d-" % i) * 50
            fa.save_bytes(f"/par/d{i % 3}/f{i}.bin", body)
            bodies[f"/pdst/d{i % 3}/f{i}.bin"] = body
        fa.filer.rename("/par/d0/f0.bin", "/par/d0/renamed.bin")
        del bodies["/pdst/d0/f0.bin"]
        bodies["/pdst/d0/renamed.bin"] = b"payload-00-" * 50
        rep = ns.repl.Replicator(ns.repl.FilerSource(fa.address, "/par/"),
                                 ns.repl.FilerSink(fb.address, "/pdst/"))
        applied, cursor = rep.run_once(0, concurrency=4)
        again, cursor2 = rep.run_once(cursor, concurrency=4)
        return (applied, again, cursor2 == cursor,
                {p: get(ns, fb, p) == b for p, b in bodies.items()},
                get(ns, fb, "/pdst/d0/f0.bin"))

    applied, again, same, ok, gone = _both(clusters, script)
    assert applied >= 25 and again == 0 and same and all(ok.values())
    assert gone == 404


def test_file_queue_replication_like_jax(clusters, tmp_path):
    def script(ns, fa, fb):
        qpath = str(tmp_path / f"{ns.fserver.__name__.split('.')[0]}.jsonl")
        fa.filer.notification_queue = ns.notification.FileQueue(qpath)
        try:
            for i in range(10):
                put(ns, fa, f"/fq/q{i % 2}/f{i}.bin", (b"mq-%02d-" % i) * 40)
            put(ns, fa, "/fq/q0/gone.bin", b"to-delete")
            ns.rpc.call(fa.address, "/fq/q0/gone.bin", method="DELETE")
        finally:
            fa.filer.notification_queue = None
        rep = ns.repl.Replicator(ns.repl.FilerSource(fa.address, "/fq/"),
                                 ns.repl.FilerSink(fb.address, "/fqdst/"))
        first = ns.replicator.run_from_queue(
            ns.notification.FileQueueInput(qpath), rep, once=True)
        again = ns.replicator.run_from_queue(
            ns.notification.FileQueueInput(qpath), rep, once=True)
        return (first, again,
                [get(ns, fb, f"/fqdst/q{i % 2}/f{i}.bin") for i in range(10)],
                get(ns, fb, "/fqdst/q0/gone.bin"))

    first, again, got, gone = _both(clusters, script)
    assert again == 0 and got == [(b"mq-%02d-" % i) * 40 for i in range(10)]
    assert gone == 404


def test_kafka_wire_roundtrip_like_jax():
    def script(ns):
        broker = ns.kafka.StubBroker()
        try:
            c = ns.kafka.MinimalKafkaClient("127.0.0.1", broker.port,
                                            "events")
            offs = [c.produce(b"k%d" % i, b"v%d" % i) for i in range(5)]
            got = [(o, k, v) for o, k, v in c.fetch(0)]
            none = c.fetch_offset("g1")
            c.commit_offset("g1", 3)
            out = (offs, got, none, c.fetch_offset("g1"),
                   [o for o, _, _ in c.fetch(3)])
            c2 = ns.kafka.MinimalKafkaClient("127.0.0.1", broker.port,
                                             "other")
            out += (c2.fetch(0),)
            c.close()
            c2.close()
            return out
        finally:
            broker.close()

    out = {pkg: script(ns) for pkg, ns in PKG.items()}
    assert out["port"] == out["jax"]
    assert out["port"][0] == list(range(5)) and out["port"][2] == -1


def test_kafka_queue_replication_like_jax(clusters):
    def script(ns, fa, fb):
        broker = ns.kafka.StubBroker()
        hosts = [f"127.0.0.1:{broker.port}"]
        try:
            fa.filer.notification_queue = ns.notification.KafkaQueue(
                hosts, "fevents")
            try:
                for i in range(8):
                    put(ns, fa, f"/kq/k{i % 2}/f{i}.bin",
                        (b"kq-%02d-" % i) * 30)
                put(ns, fa, "/kq/k0/gone.bin", b"bye")
                ns.rpc.call(fa.address, "/kq/k0/gone.bin", method="DELETE")
            finally:
                fa.filer.notification_queue = None
            rep = ns.repl.Replicator(ns.repl.FilerSource(fa.address, "/kq/"),
                                     ns.repl.FilerSink(fb.address, "/kqdst/"))
            counts = []
            for _ in range(2):
                qin = ns.notification.KafkaQueueInput(hosts, "fevents")
                counts.append(ns.replicator.run_from_queue(qin, rep,
                                                           once=True))
                qin.close()
            return (counts, [get(ns, fb, f"/kqdst/k{i % 2}/f{i}.bin")
                             for i in range(8)],
                    get(ns, fb, "/kqdst/k0/gone.bin"),
                    broker.message_count("fevents"))
        finally:
            broker.close()

    counts, got, gone, messages = _both(clusters, script)
    assert counts[1] == 0 and gone == 404
    assert got == [(b"kq-%02d-" % i) * 30 for i in range(8)]


# -- R9: the parts of a completed multipart upload ----------------------------


def test_completed_multipart_upload_replicates_whole_bucket(tmp_path,
                                                            monkeypatch):
    """A bucket whose history holds a completed multipart upload, backed
    up by each package's `Replicator` into a `LocalSink` as `filer.backup
    -once` drives it.  The JAX one stops at the first part (its path was
    deleted by the completion); the port skips the parts and backs up
    every object."""
    import xml.etree.ElementTree as ET

    monkeypatch.setenv("WEED_MAINT", "0")
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    ns_xml = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    got = {}
    for pkg, ns in PKG.items():
        monkeypatch.setattr(ns.s3, "uuid", _Uuids())
        with mini_cluster(pkg, tmp_path / pkg / "a", chunk_size=1024) as fa:
            s3 = ns.s3.S3ApiServer(fa, port=0)
            s3.start()
            try:
                c = ns.repl.make_sink(
                    f"s3://b/?endpoint={s3.address}").client
                c.create_bucket("b")
                c.put_object("b", "before.bin", BIG)
                root = ET.fromstring(c._request(
                    "POST", "/b/mp.bin", {"uploads": ""}, parse=False))
                uid = root.find(f"{ns_xml}UploadId").text
                for n in (1, 2):
                    c._request("PUT", "/b/mp.bin",
                               {"partNumber": str(n), "uploadId": uid},
                               body=bytes([n]) * 5000, parse=False)
                c._request("POST", "/b/mp.bin", {"uploadId": uid},
                           parse=False)
                c.put_object("b", "after.bin", b"after the upload")
            finally:
                s3.stop()
            rep = ns.repl.Replicator(
                ns.repl.FilerSource(fa.address, "/buckets/b"),
                ns.repl.LocalSink(str(tmp_path / pkg / "backup")))
            cursor, polls = 0, []
            while True:  # filer.backup -once
                applied, cursor = rep.run_once(cursor)
                polls.append(applied)
                if applied == 0:
                    break
            got[pkg] = polls, tree(tmp_path / pkg / "backup")
    want = {"before.bin": BIG, "mp.bin": b"\x01" * 5000 + b"\x02" * 5000,
            "after.bin": b"after the upload"}
    assert got["port"][1] == want
    # stuck at the first part: an empty file, and nothing after it
    assert got["jax"][1] == {
        "before.bin": BIG,
        ".uploads/00000000000000000000000000000001/00001.part": b""}


@pytest.mark.parametrize("concurrency", [1, 4])
def test_unreadable_chunk_holds_the_cursor(clusters, tmp_path, monkeypatch,
                                           concurrency):
    """The source answers 404 for a file it still holds while the chunk's
    volume has no locations (its server out of the topology).  The port
    must not take that for a path that is gone: `run_once` keeps its
    cursor before the file, and once the volume is back the next poll
    backs it up.  Port only: the JAX package has no `SourceGone`."""
    ns = PKG["port"]
    fa = clusters["port"][0]
    top = f"/unread{concurrency}"
    body = BIG * 2  # above the filer's inline limit: on the volume
    put(ns, fa, f"{top}/a.bin", body, "application/octet-stream")
    put(ns, fa, f"{top}/b.txt", b"beside it")
    ts = {e["new_entry"]["full_path"]: e["ts_ns"]
          for e in t_repl.FilerSource(fa.address, top).subscribe(0)
          if e.get("new_entry")}
    rep = t_repl.Replicator(t_repl.FilerSource(fa.address, top),
                            t_repl.LocalSink(str(tmp_path)))
    monkeypatch.setattr(fa, "_lookup_urls", lambda fid: [])
    assert get(ns, fa, f"{top}/a.bin") == 404
    _, cursor = rep.run_once(0, concurrency=concurrency)
    assert cursor < ts[f"{top}/a.bin"]
    assert "a.bin" not in tree(tmp_path)
    monkeypatch.undo()
    rep.run_once(cursor, concurrency=concurrency)
    assert tree(tmp_path) == {"a.bin": body, "b.txt": b"beside it"}
