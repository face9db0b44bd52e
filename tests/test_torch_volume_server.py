"""The port's volume server over HTTP against the JAX package's.

(a) One scripted HTTP sequence against a JAX `VolumeServer` and a port
    one, each heartbeating to its own JAX `MasterServer`: assign, POSTs
    (raw, gzip, JWT), GETs (Range, HEAD, 404, cookie mismatch), DELETE,
    vacuum, `/admin/ec/generate`, mount, `delete_shards` of 4, degraded
    GETs, rebuild, scrub, `recover_stats`, `/query`, `/healthz`,
    `/metrics`.  Status codes, bodies and the listed headers are equal,
    the files on disk byte-identical, and the exposition deltas of the
    volume server's families equal under the strict parser of
    tests/test_metrics_exposition.py.  The JAX server encodes with
    `ec_encoder_backend="tpu"`, the port's with "cuda" on device="cpu"
    (the card's batched route through K2's plain version).  The clocks
    that reach the files (a needle's append time, its last-modified
    second) are pinned per package.
(b) A mixed cluster: a JAX master, three port volume servers, the JAX
    shell's `ec.encode` of the busiest volume, one server's shards lost,
    `ec.rebuild`, and every object read back byte-identical through the
    JAX client, some of it across servers through `/admin/ec/shard_read`.
(c) The route tables differ by exactly the routes still to port, and the
    parts that wait raise at construction.
"""

import gzip
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from test_torch_metrics import _samples

from seaweedfs_tpu.master.server import MasterServer
from seaweedfs_tpu.ops import device_pool as j_pool
from seaweedfs_tpu.rpc import policy as j_policy
from seaweedfs_tpu.rpc.http_rpc import call as j_call
from seaweedfs_tpu.security import Guard as JGuard
from seaweedfs_tpu.security import SigningKey, gen_write_jwt
from seaweedfs_tpu.security import jwt_auth as j_jwt
from seaweedfs_tpu.shell import commands as sh
from seaweedfs_tpu.stats import metrics as j_metrics
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.storage.erasure_coding import recover as j_recover
from seaweedfs_tpu.util import faults as j_faults
from seaweedfs_tpu.volume_server import server as j_server
from seaweedfs_tpu_torch.ops import device_pool as t_pool
from seaweedfs_tpu_torch.rpc import policy as t_policy
from seaweedfs_tpu_torch.security import Guard as TGuard
from seaweedfs_tpu_torch.security import jwt_auth as t_jwt
from seaweedfs_tpu_torch.stats import metrics as t_metrics
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.storage.erasure_coding import recover as t_recover
from seaweedfs_tpu_torch.util import faults as t_faults
from seaweedfs_tpu_torch.volume_server import server as t_server

KEY = "vs-secret"
LOST = [0, 5, 11, 13]
HEADERS = ("Content-Type", "Etag", "X-File-Name", "X-Last-Modified",
           "Content-Range", "Content-Encoding", "Accept-Ranges",
           "Content-Length", "Retry-After")
# the volume server's own families; heartbeats and the masters (which
# share the JAX registry) are excluded by the label filter below
FAMILIES = ("SeaweedFS_volumeServer_request", "SeaweedFS_volumeServer_throttle",
            "SeaweedFS_volumeServer_ec_encode_bytes",
            "SeaweedFS_volumeServer_ec_recover_cache",
            "SeaweedFS_volumeServer_ec_recover_spans",
            "SeaweedFS_volumeServer_ec_recover_bytes",
            "SeaweedFS_read_cache_requests", "SeaweedFS_read_cache_fill",
            "SeaweedFS_read_cache_invalidations",
            "SeaweedFS_security_jwt_cache", "SeaweedFS_rpc_hop_seconds",
            "SeaweedFS_access_records", "SeaweedFS_qos_requests",
            "SeaweedFS_gateway_sendfile_bytes")


# routes a master's telemetry loop scrapes on its own schedule
SCRAPED = ("/metrics", "/debug/access", "/cluster/events", "/debug/qos")


def _reset_process_state():
    for faults, policy in ((j_faults, j_policy), (t_faults, t_policy)):
        faults.REGISTRY.clear()
        policy.reset_state()
    for recover, pool in ((j_recover, j_pool), (t_recover, t_pool)):
        recover.STATS.reset()
        pool.reset_pool()


class _PinnedTime:
    """A module's `time` with pinned clocks: time_ns() a counter (a
    needle's append time), time() a constant second (a needle's
    last-modified stamp); everything else is the real module's."""

    def __init__(self, pin_time: bool):
        self._ticks = iter(range(1_700_000_000_000_000_000, 1 << 62,
                                 1_000_003))
        self._lock = threading.Lock()
        self._pin_time = pin_time

    def time_ns(self):
        with self._lock:
            return next(self._ticks)

    def time(self):
        return 1_700_000_000.0 if self._pin_time else time.time()

    def __getattr__(self, name):
        return getattr(time, name)


def _request(addr, method, path, body=None, headers=None):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {h: resp.getheader(h) for h in HEADERS
                             if resp.getheader(h) is not None}, data
    finally:
        conn.close()


def _needles(seed: int, count: int):
    """(nid, cookie, body, headers) with log-uniform 10 B..200 KiB bodies:
    raw, named text the store gzips, client-gzipped, and JSON lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, count + 1):
        size = int(np.exp(rng.uniform(np.log(10), np.log(200 << 10))))
        cookie = 0x10000000 + i * 7919
        kind = i % 4
        if kind == 1:
            body = (b"line %d of text\n" % i) * max(1, size // 16)
            headers = {"Content-Type": "text/plain",
                       "X-File-Name": f"n{i}.txt"}
        elif kind == 2:
            body = gzip.compress(rng.bytes(size) + b"z" * 300, mtime=0)
            headers = {"Content-Encoding": "gzip",
                       "Content-Type": "application/octet-stream"}
        elif kind == 3 and i < 12:
            body = b"".join(json.dumps(
                {"id": i * 10 + k, "size": int(rng.integers(0, 100)),
                 "tag": ["a", "b"][k % 2]}).encode() + b"\n"
                for k in range(20))
            headers = {"Content-Type": "application/octet-stream"}
        else:
            body = rng.bytes(size)
            headers = {}
        out.append((i, cookie, body, headers))
    return out


def _tree(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))
            if name != "vol_dir.uuid" and not name.endswith(".lock")}


def _run_sequence(vs, master, needles, tokens) -> list:
    """The scripted sequence against one volume server; returns the
    replies it saw, in order."""
    log = []
    addr = vs.address

    def req(method, path, body=None, headers=None, keep_body=True):
        status, hdrs, data = _request(addr, method, path, body, headers)
        log.append((method, path, status, hdrs,
                    data if keep_body else len(data)))
        return status, hdrs, data

    a = j_call(master.address, "/dir/assign")
    # the master picks among its writable volumes at random: write into
    # the lowest-numbered one the growth gave both servers
    vids = sorted(v for loc in vs.store.locations for v in loc.volumes)
    vid = vids[0]
    log.append(("assign", sorted(a), a["url"] == addr, vids))
    fid = {nid: f"{vid},{nid:x}{cookie:08x}"
           for nid, cookie, _, _ in needles}

    def auth(nid):
        return {"Authorization": "BEARER " + tokens[fid[nid]]}

    for nid, _, body, headers in needles:
        req("POST", f"/{fid[nid]}", body, {**headers, **auth(nid)})
    nid0 = needles[0][0]
    req("POST", f"/{fid[nid0]}", b"x")                        # no token
    req("POST", f"/{fid[nid0]}", b"x", auth(needles[1][0]))  # wrong fid
    req("POST", f"/{vid},zz", b"x", auth(nid0))               # bad fid

    def read_all(skip=()):
        for nid, cookie, body, _ in needles:
            if nid in skip:
                req("GET", f"/{fid[nid]}")
                continue
            req("GET", f"/{fid[nid]}", keep_body=False)
            status, _, data = log[-1][2], None, None
            assert status == 200, (nid, log[-1])
            req("HEAD", f"/{fid[nid]}")
            req("GET", f"/{fid[nid]}", headers={"Range": "bytes=3-40"})
            req("GET", f"/{fid[nid]}", headers={"Range": "bytes=-7"})
            req("GET", f"/{fid[nid]}",
                headers={"Range": "bytes=900000000-"})
            req("GET", f"/{fid[nid]}", headers={"Accept-Encoding": "gzip"})
        bad_cookie = f"{vid},{needles[2][0]:x}{0xdeadbeef:08x}"
        req("GET", f"/{bad_cookie}")
        req("GET", f"/{vid},{9999:x}{1:08x}")
        req("GET", f"/{vid + 1000},{1:x}{1:08x}")

    read_all()
    deleted = [n[0] for n in needles[5:30:6]]
    for nid in deleted:
        req("DELETE", f"/{fid[nid]}", headers=auth(nid))
    req("DELETE", f"/{fid[needles[0][0]]}")  # no token
    read_all(skip=deleted)
    for step in ("check", "compact", "commit"):
        req("POST", f"/admin/vacuum/{step}", json.dumps({"volume": vid}))
    read_all(skip=deleted)
    for path, body in [("/admin/readonly", {"volume": vid}),
                       ("/admin/ec/generate", {"volume": vid}),
                       ("/admin/ec/mount", {"volume": vid,
                                            "shard_ids": list(range(14))}),
                       ("/admin/delete_volume", {"volume": vid}),
                       ("/admin/ec/delete_shards", {"volume": vid,
                                                    "shard_ids": LOST})]:
        req("POST", path, json.dumps(body))
    read_all(skip=deleted)
    req("POST", "/admin/ec/rebuild", json.dumps({"volume": vid}))
    req("POST", "/admin/ec/mount", json.dumps({"volume": vid,
                                               "shard_ids": LOST}))
    req("POST", "/admin/ec/scrub", json.dumps({"volume": vid}))
    status, _, body = _request(addr, "GET", "/admin/ec/recover_stats")
    stats = json.loads(body)
    log.append(("recover_stats", status,
                {k: stats[k] for k in ("cache_hits", "cache_misses",
                                       "spans", "batches",
                                       "recovered_bytes")},
                stats["volumes"]))
    json_fids = [fid[n[0]] for n in needles if n[0] % 4 == 3 and n[0] < 12]
    req("POST", "/query", json.dumps({
        "from_file_ids": json_fids,
        "filter": {"field": "size", "operand": ">", "value": "40"},
        "selections": ["id", "tag"]}))
    req("POST", "/query", json.dumps({"from_file_ids": [f"{vid},zz"]}))
    req("GET", "/healthz")
    status, _, body = _request(addr, "GET", "/readyz")
    log.append(("readyz", status, json.loads(body)["ready"]))
    status, hdrs, body = _request(addr, "GET", "/metrics")
    log.append(("metrics", status, hdrs["Content-Type"]))
    # the families' decode-plan caches and read-amp counters are
    # process-wide: compare what this volume server says of its volume
    status, _, body = _request(addr, "GET", "/admin/ec/codes?volume=%d"
                               % vid)
    codes = json.loads(body)
    log.append(("codes", status, codes["default_family"],
                sorted(codes["families"]), codes["volumes"]))
    req("GET", "/admin/ec/shard_read?volume=%d&shard=3&offset=0&size=64"
        % vid)
    req("GET", "/admin/ec/shard_read?volume=%d&shard=99&offset=0&size=8"
        % vid)
    req("GET", "/nowhere-not-a-fid")
    return log


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    """Both packages' servers through the same sequence; the logs, the
    directories and the exposition deltas."""
    root = tmp_path_factory.mktemp("scripted")
    needles = _needles(3, 36)
    # one token per fid for both runs (a token carries its expiry second)
    signing = SigningKey(KEY, 3600)
    tokens = {}
    for vid in range(1, 20):
        for nid, cookie, _, _ in needles:
            f = f"{vid},{nid:x}{cookie:08x}"
            tokens[f] = gen_write_jwt(signing, f)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in ("WEED_MAINT", "WEED_MAINT_WORKER"):
            mp.setenv(k, "0")
        mp.setenv("WEED_TRACE_SAMPLE", "0")
        mp.setenv("WEED_TRACE_SLOW_MS", "1e9")
        _reset_process_state()
        before = (_samples(j_metrics.REGISTRY.expose()),
                  _samples(t_metrics.REGISTRY.expose()))
        for name, server_mod, volume_mod, guard, kw in (
                ("jax", j_server, j_volume, JGuard,
                 {"ec_encoder_backend": "tpu"}),
                ("torch", t_server, t_volume, TGuard,
                 {"ec_encoder_backend": "cuda", "device": "cpu"})):
            mp.setattr(server_mod, "time", _PinnedTime(pin_time=True))
            mp.setattr(volume_mod, "time", _PinnedTime(pin_time=False))
            d = root / name
            d.mkdir()
            master = MasterServer(port=0, volume_size_limit_mb=64,
                                  pulse_seconds=0.2)
            master.start()
            vs = server_mod.VolumeServer(
                [str(d)], master.address, port=0, pulse_seconds=0.2,
                guard=guard(signing_key=KEY), **kw)
            vs.start()
            try:
                vs.heartbeat_once()
                j_jwt._jwt_cache_clear()
                t_jwt._jwt_cache_clear()
                out[name] = _run_sequence(vs, master, needles, tokens)
            finally:
                vs.stop()
                master.stop()
            out[name + "_files"] = _tree(d)
        after = (_samples(j_metrics.REGISTRY.expose()),
                 _samples(t_metrics.REGISTRY.expose()))
    for i, name in enumerate(("jax", "torch")):
        out[name + "_delta"] = _volume_delta(before[i], after[i])
    return out


def _volume_delta(before: dict, after: dict) -> dict:
    out = {}
    for key in set(before) | set(after):
        sname, labels = key
        lab = dict(labels)
        if not sname.startswith(FAMILIES):
            continue
        if sname.startswith("SeaweedFS_rpc_hop_seconds") and (
                lab.get("dst") != "volume" or lab.get("src") != "client"
                or lab.get("route") in SCRAPED):
            continue
        if lab.get("service", "volume") != "volume":
            continue
        d = after.get(key, 0.0) - before.get(key, 0.0)
        if d:
            out[key] = round(d, 9)
    return out


def test_scripted_replies_equal(scripted):
    j, t = scripted["jax"], scripted["torch"]
    assert len(j) == len(t)
    for jstep, tstep in zip(j, t):
        assert jstep == tstep
    statuses = {step[2] for step in t if isinstance(step[2], int)}
    assert {200, 201, 204, 206, 401, 404, 416} & statuses >= \
        {200, 206, 401, 404, 416}


def test_scripted_sequence_reads_degraded(scripted):
    """The EC part did what it says: 4 shards lost, reads recovered
    through the decode path, the rebuild gave back exactly those 4, the
    scrub found every shard clean."""
    t = scripted["torch"]
    stats = [s for s in t if s[0] == "recover_stats"][0]
    assert stats[1] == 200 and stats[2]["spans"] > 0
    rebuilt = [s for s in t if s[1] == "/admin/ec/rebuild"][0]
    assert json.loads(rebuilt[4]) == {"rebuilt_shard_ids": LOST}
    scrub = json.loads([s for s in t if s[1] == "/admin/ec/scrub"][0][4])
    assert scrub["clean"] == list(range(14)) and scrub["corrupt"] == []
    query = [s for s in t if s[1] == "/query"][0]
    assert query[2] == 200 and json.loads(query[4])["records"]


def test_scripted_files_byte_identical(scripted):
    j, t = scripted["jax_files"], scripted["torch_files"]
    assert sorted(j) == sorted(t)
    assert any(name.endswith(".ec13") for name in t)
    for name in j:
        assert j[name] == t[name], name


def test_scripted_exposition_deltas_equal(scripted):
    j, t = scripted["jax_delta"], scripted["torch_delta"]
    assert j == t
    names = {k[0] for k in t}
    assert {"SeaweedFS_volumeServer_request_total",
            "SeaweedFS_volumeServer_ec_encode_bytes_total",
            "SeaweedFS_volumeServer_ec_recover_spans_total",
            "SeaweedFS_rpc_hop_seconds_count"} <= names


# -- (b) a mixed cluster ---------------------------------------------------------


@pytest.fixture
def mixed_cluster(tmp_path, monkeypatch):
    for k in ("WEED_MAINT", "WEED_MAINT_WORKER"):
        monkeypatch.setenv(k, "0")
    _reset_process_state()
    master = MasterServer(port=0, volume_size_limit_mb=64, pulse_seconds=0.2)
    master.start()
    servers = []
    for i in range(3):
        d = tmp_path / f"vs{i}"
        d.mkdir()
        vs = t_server.VolumeServer([str(d)], master.address, port=0,
                                   rack=f"rack{i % 2}", pulse_seconds=0.2,
                                   ec_encoder_backend="cuda", device="cpu")
        vs.start()
        vs.heartbeat_once()
        servers.append(vs)
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def test_mixed_cluster_ec_encode_rebuild_reads(mixed_cluster):
    master, servers = mixed_cluster
    rng = np.random.default_rng(17)
    stored = {}
    for i in range(60):
        a = j_call(master.address, "/dir/assign")
        payload = rng.bytes(int(rng.integers(200, 40000)))
        j_call(a["url"], f"/{a['fid']}", raw=payload, method="POST")
        stored[a["fid"]] = payload
    by_vid = {}
    for fid in stored:
        by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
    vid = max(sorted(by_vid), key=lambda v: len(by_vid[v]))
    env = sh.CommandEnv(master.address)
    sh.ec_encode(env, vid)
    for vs in servers:
        vs.heartbeat_once()
    ec = j_call(master.address, f"/ec/lookup?volumeId={vid}")
    holders = {loc["url"] for e in ec["shard_id_locations"]
               for loc in e["locations"]}
    assert len(ec["shard_id_locations"]) == 14 and len(holders) >= 2

    hop = ("SeaweedFS_rpc_hop_seconds_count",)

    def shard_reads():
        return sum(v for (name, labels), v in
                   _samples(t_metrics.REGISTRY.expose()).items()
                   if name in hop and
                   dict(labels).get("route") == "/admin/ec/shard_read")

    # lose one server's shards (up to 4), then ec.rebuild
    victim = max(servers, key=lambda s: len(
        s.store.find_ec_volume(vid).shards
        if s.store.find_ec_volume(vid) else []))
    lost = sorted(victim.store.find_ec_volume(vid).shards)[:4]
    j_call(victim.address, "/admin/ec/delete_shards",
           {"volume": vid, "shard_ids": lost})
    victim.heartbeat_once()
    before = shard_reads()
    for vs in servers:  # degraded, from every holder, across servers
        if vs.store.find_ec_volume(vid) is None:
            continue
        for fid in by_vid[vid]:
            assert j_call(vs.address, f"/{fid}", parse=False) == \
                stored[fid]
    assert shard_reads() > before
    result = sh.ec_rebuild(env, vid)
    assert sorted(result["missing"]) == lost
    for vs in servers:
        vs.heartbeat_once()
    ec = j_call(master.address, f"/ec/lookup?volumeId={vid}")
    assert len(ec["shard_id_locations"]) == 14
    for vs in servers:  # every holder serves every object of the volume
        if vs.store.find_ec_volume(vid) is None:
            continue
        for fid in by_vid[vid]:
            assert j_call(vs.address, f"/{fid}", parse=False) == \
                stored[fid]
    for fid, payload in stored.items():  # and the plain volumes
        loc = j_call(master.address,
                     f"/dir/lookup?volumeId={fid.split(',')[0]}")
        assert j_call(loc["locations"][0]["url"], f"/{fid}",
                      parse=False) == payload


# -- (c) the route tables and what waits -------------------------------------------

# routes of the JAX volume server the port does not serve yet; this set
# only shrinks, and the tier and remote routes emptied it
NOT_PORTED_ROUTES: set = set()


@pytest.fixture
def two_servers(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    dead = "127.0.0.1:1"  # nothing listens: heartbeats fail, as designed
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    js = j_server.VolumeServer([str(tmp_path / "j")], dead, port=0)
    ts = t_server.VolumeServer([str(tmp_path / "t")], dead, port=0,
                               device="cpu")
    yield js, ts
    js.server.httpd.server_close()
    ts.server.httpd.server_close()
    js.read_cache.close()
    ts.read_cache.close()
    js.store.close()
    ts.store.close()


def test_route_tables_differ_by_the_declared_set(two_servers):
    js, ts = two_servers
    jr, tr = set(js.server.routes), set(ts.server.routes)
    assert tr <= jr
    assert jr - tr == NOT_PORTED_ROUTES
    assert ts.server.default_route is not None
    assert ts.server.fanout_prefixes == js.server.fanout_prefixes
    # the maintenance worker waits for the control plane (ROADMAP item 8)
    assert hasattr(js, "maintenance_worker")
    assert not hasattr(ts, "maintenance_worker")


@pytest.mark.parametrize("part", ["enable_tcp", "tier_backends",
                                  "WEED_HTTP_WORKERS"])
def test_waiting_parts_raise(tmp_path, monkeypatch, part):
    """The parts that raised before they were ported (the TCP fast path,
    tier backends, prefork workers) now construct as the JAX server
    does: a port-0 server never preforks, a tier backend is registered
    under its name, and the TCP listener binds."""
    from seaweedfs_tpu_torch.remote_storage import RemoteConf
    from seaweedfs_tpu_torch.storage import tier as t_tier

    kw = {}
    if part == "enable_tcp":
        kw["enable_tcp"] = True
    elif part == "tier_backends":
        kw["tier_backends"] = [RemoteConf(name="x", type="local",
                                          directory=str(tmp_path / "r"))]
    else:
        monkeypatch.setenv("WEED_HTTP_WORKERS", "2")
    ts = t_server.VolumeServer([str(tmp_path)], "127.0.0.1:1", port=0,
                               device="cpu", **kw)
    ts.start()
    try:
        assert ts.server._prefork_workers == 1
        if part == "enable_tcp":
            assert ts.tcp_port > 0
        if part == "tier_backends":
            assert t_tier.tier_backends()["x"].directory == str(
                tmp_path / "r")
    finally:
        ts.stop()
        t_tier._BACKENDS.pop("x", None)


def test_dead_master_error_tier_spares_each_read_a_lookup(tmp_path,
                                                          monkeypatch):
    """With the master unreachable the EC location lookup lands in the
    11 s error tier: a burst of degraded reads costs one lookup."""
    vs = t_server.VolumeServer([str(tmp_path)], "127.0.0.1:1", port=0,
                               device="cpu")
    calls = []
    real = t_policy.call_policy

    def counted(addr, path, *a, **kw):
        calls.append(path)
        return real(addr, path, *a, **kw)

    monkeypatch.setattr(t_policy, "call_policy", counted)
    try:
        for _ in range(20):
            assert vs._ec_shard_locations(7) == {}
        assert calls == ["/ec/lookup?volumeId=7"]
        assert vs._ec_locations[7][2] is True
        assert t_server.EC_SHARD_CACHE_TTL_ERROR == 11.0
    finally:
        vs.server.httpd.server_close()
        vs.read_cache.close()
        vs.store.close()
