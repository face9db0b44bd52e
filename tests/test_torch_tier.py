"""The port's volume tiering (storage/tier.py, storage/backend.TieredFile,
remote_storage) against the JAX package's.

Both packages upload the same volume to a `LocalRemoteStorage` tier and
download it back: the remote objects, the .vif sidecars and the
downloaded .dat are byte-identical, reads in between go through
`TieredFile` (also after a restart finds only the .vif), and the volume
server's tier and remote routes (/admin/volume/tier_upload,
tier_download, /admin/remote/fetch_write) answer alike.  Exact.
"""

import itertools
import os
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu.remote_storage import RemoteConf as JConf
from seaweedfs_tpu.rpc.http_rpc import call as j_call
from seaweedfs_tpu.storage import backend as j_backend
from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import tier as j_tier
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.volume_server import server as j_server
from seaweedfs_tpu_torch.remote_storage import RemoteConf as TConf
from seaweedfs_tpu_torch.remote_storage import (LocalRemoteStorage,
                                                RemoteLocation)
from seaweedfs_tpu_torch.storage import backend as t_backend
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import tier as t_tier
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.volume_server import server as t_server

PKGS = {"jax": (j_volume, j_needle, j_tier, j_backend, JConf),
        "torch": (t_volume, t_needle, t_tier, t_backend, TConf)}


@pytest.fixture
def pinned_time(monkeypatch):
    """time.time and time.time_ns from counters restarted per package."""
    state = {}

    def restart():
        state["ns"] = itertools.count(1_700_000_000_000_000_000, 1_000_003)

    monkeypatch.setattr(time, "time_ns", lambda: next(state["ns"]))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.5)
    restart()
    return restart


@pytest.fixture
def backends(tmp_path):
    yield {name: str(tmp_path / f"remote_{name}") for name in PKGS}
    for name in PKGS:
        PKGS[name][2]._BACKENDS.pop("tier1", None)


def _needles(seed=4, count=25):
    rng = np.random.default_rng(seed)
    return {nid: (0x3000 + nid, rng.bytes(int(rng.integers(1, 3 << 20))))
            for nid in range(1, count + 1)}


def _tree(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_upload_download_like_jax(tmp_path, pinned_time, backends):
    needles = _needles()
    files, reads = {}, {}
    for name, (vol_mod, needle_mod, tier, backend, conf) in PKGS.items():
        pinned_time()
        d = tmp_path / name
        d.mkdir()
        tier.register_tier_backend(conf(name="tier1", type="local",
                                        directory=backends[name]))
        v = vol_mod.Volume(str(d), "c", 3)
        for nid, (cookie, data) in needles.items():
            n = needle_mod.Needle.create(data)
            n.id, n.cookie = nid, cookie
            v.write_needle(n)
        original = (d / "c_3.dat").read_bytes()
        remote = tier.tier_upload(v, "tier1", "volumes")
        assert remote.file_size == len(original)
        assert isinstance(v.data, backend.TieredFile) and v.read_only
        assert not (d / "c_3.dat").exists()
        got = {nid: v.read_needle(nid, cookie=c).data
               for nid, (c, _) in needles.items()}
        v.close()
        # a restart finds only the .vif: the volume loads from the tier
        v = vol_mod.Volume(str(d), "c", 3)
        assert isinstance(v.data, backend.TieredFile) and v.read_only
        assert {nid: v.read_needle(nid, cookie=c).data
                for nid, (c, _) in needles.items()} == got
        vif_tiered = (d / "c_3.vif").read_bytes()
        remote_tree = _tree(backends[name])
        size = tier.tier_download(v)
        assert size == len(original)
        assert (d / "c_3.dat").read_bytes() == original
        assert not v.read_only
        n = needle_mod.Needle.create(b"after the download")
        n.id, n.cookie = 99, 0x99
        v.write_needle(n)
        v.close()
        files[name] = (original, vif_tiered, remote_tree,
                       (d / "c_3.vif").read_bytes(),
                       (d / "c_3.dat").read_bytes(),
                       (d / "c_3.idx").read_bytes(), _tree(backends[name]))
        reads[name] = got
    assert reads["torch"] == reads["jax"] == {
        nid: data for nid, (_, data) in needles.items()}
    assert files["torch"] == files["jax"]
    assert list(files["torch"][2]) == ["volumes/c_3.dat"]


@pytest.mark.parametrize("size,offset,length", [
    (0, 0, 10), (1, 0, 1), (5 << 20, 0, 5 << 20), ((3 << 20) + 7, 1 << 20,
                                                   (2 << 20) + 7),
    ((3 << 20) + 7, (1 << 20) - 3, 9), (4096, 4000, 500)])
def test_tiered_file_reads_like_jax(size, offset, length):
    """TieredFile's block cache returns the same bytes as the JAX one for
    reads across block edges and past the end; writes are refused."""
    rng = np.random.default_rng(size)
    blob = rng.bytes(size)
    fetched = {"t": [], "j": []}

    def fetch(tag):
        def fn(off, n):
            fetched[tag].append((off, n))
            return blob[off:off + n]
        return fn

    tf = t_backend.TieredFile(fetch("t"), size, name="x", cache_blocks=2)
    jf = j_backend.TieredFile(fetch("j"), size, name="x", cache_blocks=2)
    for _ in range(2):
        assert tf.read_at(length, offset) == jf.read_at(length, offset) == \
            blob[offset:offset + length]
    assert fetched["t"] == fetched["j"]
    assert tf.size() == size and tf.fileno() is None
    for fn in (lambda f: f.write_at(b"x", 0), lambda f: f.append(b"x"),
               lambda f: f.truncate(0)):
        with pytest.raises(OSError):
            fn(tf)


def _dead_master() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_server_tier_and_remote_routes_like_jax(tmp_path, monkeypatch,
                                               backends):
    """The same admin sequence against a JAX and a port server: tier
    upload, reads from the tier, tier download, and fetch_write of a
    remote object's range into a needle; the replies and the bytes
    served are equal."""
    monkeypatch.setenv("WEED_MAINT", "0")
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    src = tmp_path / "objects"
    src.mkdir()
    obj = np.random.default_rng(2).bytes(300_000)
    LocalRemoteStorage(TConf(name="ext", type="local",
                             directory=str(src))).write_file(
        RemoteLocation.parse("ext/bucket/a/obj.bin"), obj)
    payloads = _needles(6, 12)
    replies = {}
    for name, mod in (("jax", j_server), ("torch", t_server)):
        d = tmp_path / f"srv_{name}"
        d.mkdir()
        conf = PKGS[name][4](name="tier1", type="local",
                             directory=backends[name])
        kw = {"device": "cpu"} if name == "torch" else {}
        vs = mod.VolumeServer([str(d)], _dead_master(), port=0,
                              tier_backends=[conf], pulse_seconds=3600,
                              **kw)
        vs.start()
        got = []
        try:
            addr = vs.address
            got.append(j_call(addr, "/admin/assign_volume", {"volume": 5}))
            for nid, (cookie, data) in payloads.items():
                j_call(addr, f"/5,{nid:x}{cookie:08x}", raw=data,
                       method="POST")
            got.append(j_call(addr, "/admin/volume/tier_upload",
                              {"volume": 5, "backend": "tier1"}))
            got.append([j_call(addr, f"/5,{nid:x}{c:08x}", parse=False)
                        for nid, (c, _) in payloads.items()])
            got.append(j_call(addr, "/admin/volume/tier_download",
                              {"volume": 5}))
            got.append(j_call(addr, "/admin/assign_volume", {"volume": 6}))
            got.append(j_call(addr, "/admin/remote/fetch_write", {
                "volume": 6, "needle_id": 0x77, "cookie": 0x1234,
                "remote_conf": {"name": "ext", "type": "local",
                                "directory": str(src)},
                "remote_location": "ext/bucket/a/obj.bin",
                "offset": 1000, "size": 5000}))
            got.append(j_call(addr, "/6,7700001234", parse=False))
            got.append(_tree(backends[name]))
        finally:
            vs.stop()
        replies[name] = got
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][2] == [d for _, d in payloads.values()]
    assert replies["torch"][6] == obj[1000:6000]


def test_write_after_download_reads_back(tmp_path, backends):
    """A volume tiered and downloaded again without a restart takes new
    writes that read back.  The JAX package's engine-backed volume keeps
    appending to the .dat the upload unlinked, so its read of the new
    needle fails; the port registers the downloaded file."""
    results = {}
    for name, (vol_mod, needle_mod, tier, _, conf) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        tier.register_tier_backend(conf(name="tier1", type="local",
                                        directory=backends[name]))
        v = vol_mod.Volume(str(d), "", 7)
        try:
            for nid in (1, 2):
                n = needle_mod.Needle.create(bytes([nid]) * 1000)
                n.id, n.cookie = nid, 0x42
                v.write_needle(n)
            tier.tier_upload(v, "tier1", "volumes")
            tier.tier_download(v)
            n = needle_mod.Needle.create(b"written after the download")
            n.id, n.cookie = 3, 0x42
            v.write_needle(n)
            try:
                results[name] = v.read_needle(3, cookie=0x42).data
            except Exception as e:  # noqa: BLE001 - recorded and compared
                results[name] = type(e).__name__
        finally:
            v.close()
    assert results["torch"] == b"written after the download"
    assert results["jax"] != results["torch"]


# -- the S3 provider and its SigV4 client, against a recording fake --------

class _FakeS3:
    """A path-style S3 endpoint in a thread: PUT/GET (with Range)/DELETE
    objects, ListObjectsV2; records every request's method, path and
    headers."""

    def __init__(self):
        import http.server
        import threading

        self.objects: dict = {}
        self.requests: list = []
        fake = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, body=b"", ctype="application/xml"):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _record(self, body=b""):
                keep = {k: v for k, v in self.headers.items()
                        if k.lower() in ("authorization", "x-amz-date",
                                         "x-amz-content-sha256", "range",
                                         "content-type", "host")}
                fake.requests.append((self.command, self.path, keep,
                                      len(body)))

            def do_PUT(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                self._record(body)
                fake.objects[self.path.split("?")[0]] = body
                self._send(200)

            def do_DELETE(self):
                self._record()
                fake.objects.pop(self.path.split("?")[0], None)
                self._send(204)

            def do_GET(self):
                import urllib.parse

                self._record()
                path, _, qs = self.path.partition("?")
                if "list-type=2" in qs:
                    q = dict(urllib.parse.parse_qsl(qs))
                    bucket = path.strip("/")
                    keys = sorted(
                        k[len(bucket) + 2:] for k in fake.objects
                        if k.startswith(f"/{bucket}/")
                        and k[len(bucket) + 2:].startswith(
                            q.get("prefix", ""))
                        and k[len(bucket) + 2:] > q.get("start-after", ""))
                    items = "".join(
                        f"<Contents><Key>{k}</Key><Size>"
                        f"{len(fake.objects[f'/{bucket}/{k}'])}</Size>"
                        f"<ETag>\"e{len(k)}\"</ETag><LastModified>"
                        "2026-01-02T03:04:05.000Z</LastModified></Contents>"
                        for k in keys)
                    body = ("<ListBucketResult><IsTruncated>false"
                            f"</IsTruncated>{items}</ListBucketResult>")
                    return self._send(200, body.encode())
                data = fake.objects.get(path)
                if data is None:
                    return self._send(404, b"<Error/>")
                rng = self.headers.get("Range")
                if rng:
                    lo, hi = rng.split("=")[1].split("-")
                    data = data[int(lo):int(hi) + 1]
                    return self._send(206, data, "application/octet-stream")
                self._send(200, data, "application/octet-stream")

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_s3_provider_and_tier_like_jax(tmp_path, monkeypatch, pinned_time):
    """Both packages' S3RemoteStorage (make_remote_client type "s3") and a
    tier upload/download through it send the same signed requests
    (SigV4 over a pinned clock) and read the same bytes and listings."""
    from seaweedfs_tpu.remote_storage import RemoteLocation as JLoc
    from seaweedfs_tpu.remote_storage import make_remote_client as j_make
    from seaweedfs_tpu_torch.remote_storage import make_remote_client

    fixed = time.struct_time((2026, 10, 17, 9, 0, 0, 5, 290, 0))
    monkeypatch.setattr(time, "gmtime", lambda *a: fixed)
    blob = np.random.default_rng(3).bytes(200_000)
    seen = {}
    fake = _FakeS3()  # one endpoint: the Host header is signed
    for name, make, loc_cls in (("jax", j_make, JLoc),
                                ("torch", make_remote_client,
                                 RemoteLocation)):
        fake.objects.clear()
        fake.requests.clear()
        pinned_time()
        try:
            conf = PKGS[name][4](name="s3t", type="s3", endpoint=fake.addr,
                                 access_key="AK", secret_key="SK")
            client = make(conf)
            loc = loc_cls.parse("s3t/bkt/dir/a.bin")
            out = [client.write_file(loc, blob).size,
                   client.read_file(loc) == blob,
                   client.read_range(loc, 1000, 777) == blob[1000:1777],
                   [(o.key, o.size, o.etag, o.mtime) for o in
                    client.traverse(loc_cls.parse("s3t/bkt/dir"))],
                   vars(client.stat(loc))]
            client.delete_file(loc)
            out.append(client.stat(loc))
            # a volume tiered to the S3 backend and brought back
            tier = PKGS[name][2]
            tier.register_tier_backend(conf)
            d = tmp_path / name
            d.mkdir()
            v = PKGS[name][0].Volume(str(d), "", 8)
            try:
                for nid in range(1, 6):
                    n = PKGS[name][1].Needle.create(bytes([nid]) * 5000)
                    n.id, n.cookie = nid, 0x55
                    v.write_needle(n)
                dat = (d / "8.dat").read_bytes()
                tier.tier_upload(v, "s3t", "volumes")
                out.append(fake.objects.get("/volumes/8.dat") == dat)
                out.append([v.read_needle(i, cookie=0x55).data
                            for i in range(1, 6)])
                out.append(tier.tier_download(v))
                out.append((d / "8.dat").read_bytes() == dat)
            finally:
                v.close()
                tier._BACKENDS.pop("s3t", None)
            seen[name] = (out, [(m, p, h.get("Authorization"),
                                 h.get("X-Amz-Date"), h.get("Range"), n)
                                for m, p, h, n in fake.requests])
        finally:
            if name == "torch":
                fake.close()
    assert seen["torch"] == seen["jax"]
    out, reqs = seen["torch"]
    assert out[:3] == [len(blob), True, True] and out[5] is None
    assert all(r[2] and r[2].startswith("AWS4-HMAC-SHA256") for r in reqs)
