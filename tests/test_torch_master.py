"""The port's master against the JAX package's.

The same seeded heartbeats go into both packages' `Topology`: the
`to_dict()` views, lookups, EC lookups and the change feed's deltas are
equal.  `volume_growth` places the same volumes on the same nodes for
replica placements 000, 001, 010 and 100 over several data-center and
rack shapes (the global `random` seeded alike before each package's
call).  Then the same HTTP requests go to a JAX and a port
`MasterServer` fed the same heartbeats: assign (fid shape, keys and
counts), lookup, EC lookup, `/col/list`, `/dir/status`,
`/cluster/status` and the maintenance routes reply alike.  The port's
route table is the JAX master's less `NOT_PORTED_ROUTES`, which this
file pins empty.  Tolerance: equality throughout.
"""

import random

import numpy as np
import pytest

from seaweedfs_tpu.master import sequence as j_sequence
from seaweedfs_tpu.master import server as j_server
from seaweedfs_tpu.master import topology as j_topology
from seaweedfs_tpu.master import volume_growth as j_growth
from seaweedfs_tpu.rpc.http_rpc import RpcError as JRpcError
from seaweedfs_tpu.rpc.http_rpc import call as j_call
from seaweedfs_tpu.storage.super_block import ReplicaPlacement as JRP
from seaweedfs_tpu_torch.master import sequence as t_sequence
from seaweedfs_tpu_torch.master import server as t_server
from seaweedfs_tpu_torch.master import topology as t_topology
from seaweedfs_tpu_torch.master import volume_growth as t_growth
from seaweedfs_tpu_torch.rpc.http_rpc import RpcError
from seaweedfs_tpu_torch.rpc.http_rpc import call as t_call
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement as TRP

# (data centers, racks per data center, nodes per rack)
SHAPES = {"1dc-1rack": (1, 1, 3), "1dc-3racks": (1, 3, 2),
          "2dc-2racks": (2, 2, 2), "3dc-2racks": (3, 2, 1)}
PLACEMENTS = ("000", "001", "010", "100")
LIMIT = 1 << 20  # volume size limit of these topologies


def heartbeats(seed: int, shape: tuple, rounds: int = 3) -> list:
    """`rounds` full-sync heartbeats from every node of `shape`: plain
    volumes of two collections and four placements, EC shard bits, and
    load telemetry, each round moving some of them."""
    rng = np.random.default_rng(seed)
    dcs, racks, per_rack = shape
    nodes = [(f"10.{d}.{r}.{n}", 8080 + n, f"dc{d}", f"rack{d}-{r}")
             for d in range(dcs) for r in range(racks)
             for n in range(per_rack)]
    out = []
    for _ in range(rounds):
        for ip, port, dc, rack in nodes:
            vids = sorted({int(v) for v in rng.integers(1, 13, 4)})
            volumes = [{
                "id": v, "collection": ("", "pics")[v % 2],
                "size": int(rng.integers(0, LIMIT * 5 // 4)),
                "file_count": int(rng.integers(0, 500)),
                "delete_count": int(rng.integers(0, 50)),
                "deleted_byte_count": int(rng.integers(0, LIMIT // 2)),
                "read_only": bool(rng.random() < 0.15),
                "replica_placement": (0, 1, 10, 100)[v % 4],
                "modified_at_second": 1_700_000_000 + v}
                for v in vids]
            ec = [{"id": v, "collection": ("", "pics")[v % 2],
                   "ec_index_bits": int(rng.integers(1, 1 << 14))}
                  for v in (20, 21) if rng.random() < 0.7]
            out.append({
                "ip": ip, "port": port, "public_url": f"{ip}:{port}",
                "data_center": dc, "rack": rack,
                "max_volume_count": int(rng.integers(4, 12)),
                "max_file_key": int(rng.integers(0, 10_000)),
                "volumes": volumes, "ec_shards": ec,
                "telemetry": {"occupancy": float(rng.random()),
                              "rps": float(rng.integers(0, 300)),
                              "draining": False}})
    return out


def fed(topology_mod, hbs: list):
    """A Topology of `topology_mod` fed `hbs`, with its change feed."""
    topo = topology_mod.Topology(volume_size_limit=LIMIT)
    deltas = []
    topo.on_change = deltas.append
    for hb in hbs:
        topo.process_heartbeat(hb)
    return topo, deltas


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_topology_views_and_change_feed_equal(shape, seed):
    hbs = heartbeats(seed, SHAPES[shape])
    jt, jd = fed(j_topology, hbs)
    tt, td = fed(t_topology, hbs)
    assert tt.to_dict() == jt.to_dict()
    assert td == jd and td
    for vid in list(range(0, 14)) + [20, 21, 99]:
        for coll in ("", "pics"):
            assert tt.lookup(vid, coll) == jt.lookup(vid, coll)
        assert tt.lookup_ec_shards(vid) == jt.lookup_ec_shards(vid)
    for rp in (0, 1, 10, 100):
        for coll in ("", "pics"):
            assert tt.writable_count(coll, rp, 0) == \
                jt.writable_count(coll, rp, 0)
    assert tt.assign_file_id(5) == jt.assign_file_id(5)
    # a node leaves: the same removals reach both feeds
    node = sorted(jt.nodes)[0]
    jt.unregister_node(node)
    tt.unregister_node(node)
    assert td == jd and tt.to_dict() == jt.to_dict()
    assert tt.next_volume_id() == jt.next_volume_id()


@pytest.mark.parametrize("rp", PLACEMENTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_volume_growth_places_alike(shape, rp):
    hbs = [dict(hb, volumes=[], ec_shards=[])
           for hb in heartbeats(5, SHAPES[shape], rounds=1)]
    jt, _ = fed(j_topology, hbs)
    tt, _ = fed(t_topology, hbs)
    picks = {}
    for name, growth, topo, rp_cls in (("jax", j_growth, jt, JRP),
                                       ("port", t_growth, tt, TRP)):
        opt = growth.VolumeGrowOption(
            collection="pics", replica_placement=rp_cls.parse(rp))
        got = []
        random.seed(11)
        for _ in range(growth.find_volume_count(
                opt.replica_placement.copy_count())):
            try:
                vid, servers = growth.grow_one_volume(
                    topo, opt, lambda server, vid: None)
            except ValueError as e:
                got.append(("refused", str(e)))
                break
            got.append((vid, [s.id for s in servers]))
            for s in servers:  # the heartbeat that would follow
                topo.process_heartbeat({
                    "ip": s.ip, "port": s.port,
                    "data_center": s.dc.id, "rack": s.rack.id,
                    "max_volume_count": s.max_volume_count,
                    "volumes": [{"id": v.id, "collection": v.collection,
                                 "replica_placement": v.replica_placement}
                                for v in s.volumes.values()] + [
                        {"id": vid, "collection": "pics",
                         "replica_placement": opt.replica_placement
                         .to_byte()}]})
        picks[name] = got
    assert picks["port"] == picks["jax"]
    assert tt.to_dict() == jt.to_dict()


def test_memory_sequencer_equal():
    js, ts = j_sequence.MemorySequencer(), t_sequence.MemorySequencer()
    rng = np.random.default_rng(3)
    for _ in range(200):
        if rng.random() < 0.2:
            m = int(rng.integers(0, 5000))
            js.set_max(m)
            ts.set_max(m)
        n = int(rng.integers(1, 50))
        assert ts.next_batch(n) == js.next_batch(n)


# -- the master over HTTP --------------------------------------------------------


@pytest.fixture
def master_pair(tmp_path, monkeypatch):
    """A JAX and a port master, each with its own raft dir, fed the same
    heartbeats; curators and workers parked so the queues hold only what
    the test puts there."""
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    masters = {}
    for name, mod in (("jax", j_server), ("port", t_server)):
        d = tmp_path / name
        d.mkdir()
        m = mod.MasterServer(port=0, volume_size_limit_mb=1,
                             pulse_seconds=60.0, raft_dir=str(d))
        m.start()
        masters[name] = m
    hbs = heartbeats(7, SHAPES["2dc-2racks"], rounds=2)
    for hb in hbs:
        for m in masters.values():
            j_call(m.address, "/api/heartbeat", hb)
    yield masters
    for m in masters.values():
        m.stop()


def _strip(d, address):
    """A reply with the master's own address replaced by a placeholder."""
    if isinstance(d, dict):
        return {k: _strip(v, address) for k, v in d.items()
                if k not in ("feed_id",)}
    if isinstance(d, list):
        return [_strip(v, address) for v in d]
    if isinstance(d, str):
        return d.replace(address, "<self>")
    return d


def test_routes_reply_alike(master_pair):
    j, t = master_pair["jax"], master_pair["port"]

    def both(path, payload=None, **kw):
        return [_strip(j_call(m.address, path, payload, **kw), m.address)
                for m in (j, t)]

    for m in (j, t):
        assert m.raft.is_leader or _wait_leader(m)
    for path in ("/dir/status", "/col/list", "/cluster/status",
                 "/maintenance/status", "/maintenance/queue",
                 "/dir/lookup?volumeId=3", "/dir/lookup?volumeId=99",
                 "/dir/lookup?fileId=4,01637037d6",
                 "/dir/lookup?volumeId=5&collection=pics",
                 "/ec/lookup?volumeId=20", "/ec/lookup?volumeId=21",
                 "/raft/status"):
        try:
            jr, tr = both(path)
        except JRpcError as e:
            with pytest.raises(RpcError) as te:
                t_call(t.address, path)
            assert te.value.status == e.status, path
            continue
        if path == "/raft/status":
            for r in (jr, tr):  # clocks of this run
                r.pop("term", None)
                r.pop("lease_remaining", None)
        assert tr == jr, path
    # assigns: the same keys, counts and holders; the vid is one of the
    # layout's writables either way (the pick is random)
    # only layouts with writables: a grow would call the fake nodes
    layouts = [(lay["collection"], lay["replication"])
               for lay in j.topo.to_dict()["layouts"] if lay["writables"]]
    assert len(layouts) >= 2
    for i, (coll, rep) in enumerate(layouts):
        params = f"?collection={coll}&replication={rep}&count={i + 1}"
        jr = j_call(j.address, "/dir/assign" + params)
        tr = t_call(t.address, "/dir/assign" + params)
        jv, jk = jr["fid"].split(",")
        tv, tk = tr["fid"].split(",")
        assert (tr["count"], tk[:-8]) == (jr["count"], jk[:-8])
        assert len(tk) == len(jk)
        for m, r, v in ((j, jr, jv), (t, tr, tv)):
            holders = [loc["url"] for loc in j_call(
                m.address, f"/dir/lookup?volumeId={v}")["locations"]]
            assert r["url"] in holders
    jt = j.topo.to_dict()
    assert t.topo.to_dict() == jt
    # maintenance routes: the same job through each queue
    for m in (j, t):
        j_call(m.address, "/maintenance/run",
               {"type": "vacuum", "volume": 3, "collection": "",
                "params": {"garbage_ratio": 0.5}})
    jq, tq = both("/maintenance/queue")
    for q in (jq, tq):
        for job in q["jobs"]:
            job.pop("created_at")
    assert tq == jq
    jl, tl = both("/maintenance/lease",
                  {"worker": "w1", "limit": 1, "ec_volumes": []})
    for r in (jl, tl):
        for job in r["jobs"]:
            for k in ("created_at", "lease_expires"):
                job.pop(k)
    assert tl == jl and tl["jobs"]
    jid = tl["jobs"][0]["id"]
    jc, tc = both("/maintenance/complete",
                  {"id": jid, "worker": "w1", "outcome": "ok",
                   "report": {}})
    assert tc == jc
    js, ts = both("/maintenance/status")
    assert ts == js


def _wait_leader(m, timeout=10.0):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        if m.raft.is_leader:
            return True
        time.sleep(0.05)
    return False


def test_route_tables_differ_by_not_ported_routes(master_pair):
    j, t = master_pair["jax"], master_pair["port"]
    jr, tr = set(j.server.routes), set(t.server.routes)
    assert tr <= jr
    assert jr - tr == t_server.NOT_PORTED_ROUTES == set()
    assert t.server.parent_prefixes == j.server.parent_prefixes
    # the health plane feeds the curator's alert seam, as in the JAX master
    assert t.curator.alerts_fn == t.health.firing
    assert j.curator.alerts_fn == j.health.firing
    for path in ("/cluster/health", "/cluster/alerts", "/cluster/usage"):
        assert set(t_call(t.address, path)) == set(j_call(j.address, path))


def test_native_assign_through_the_ports_engine(tmp_path, monkeypatch):
    """enable_native_assign on the port's build of the engine, as
    tests/test_native_engine.py holds the JAX master's: the master leases
    fid key ranges to the engine's 'A' handler; raw 'A' requests mint
    unique fids, HTTP assigns draw other keys from the same sequencer,
    and a minted fid is writable over the TCP path."""
    import json
    import time

    from test_native_engine import raw_request

    from seaweedfs_tpu_torch.storage import native_engine as t_ne
    from seaweedfs_tpu_torch.storage import types as t_types
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    if not t_ne.available():
        pytest.skip("the port's engine did not build here")
    (tmp_path / "m").mkdir()
    (tmp_path / "v").mkdir()
    master = t_server.MasterServer(port=0, pulse_seconds=0.2,
                                   raft_dir=str(tmp_path / "m"),
                                   enable_native_assign=True)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.address, port=0,
                      pulse_seconds=0.2, enable_tcp=True, device="cpu")
    vs.start()
    vs.heartbeat_once()
    try:
        assert master._native_assign
        port = t_ne.server_port()
        assert t_call(master.address, "/dir/status")[
            "native_assign_port"] == port
        deadline = time.time() + 10
        st, body = 503, b""
        while time.time() < deadline:
            st, body = raw_request(port, b"A\n")
            if st == 0:
                break
            time.sleep(0.1)
        assert st == 0, body
        seen = set()
        for _ in range(300):
            st, body = raw_request(port, b"A\n")
            assert st == 0
            fid = json.loads(body)["fid"]
            assert fid not in seen
            seen.add(fid)
        native_keys = {t_types.parse_file_id(f)[1] for f in seen}
        http_keys = {t_types.parse_file_id(
            t_call(master.address, "/dir/assign")["fid"])[1]
            for _ in range(30)}
        assert not http_keys & native_keys
        st, body = raw_request(port, b"A\n")
        fid = json.loads(body)["fid"]
        st, _ = raw_request(port, f"W {fid} 5\nhello".encode())
        assert st == 0
    finally:
        vs.stop()
        master.stop()
