"""The port's master client and fid leases against the JAX package's.

- `FidLeaseCache`: the same scripted assigns (batching, TTL and JWT
  expiry, low-water refill, pass-through, leader-change invalidation)
  give the same master calls and the same fids (the shape of
  tests/test_fid_lease.py).
- `VidMap` and `MasterClient._apply_watch_reply`: the same seeded watch
  replies (deltas, resyncs, a failover's new feed id, a leader that
  joined later) leave equal caches, cursors and master lists.
- Live, over a port raft group of three: the JAX and the port client
  assign and look up, the leader stops, both fail over to the new leader
  and their watch cursors restart on its feed; `MasterFollower` serves
  lookups and assigns from a port master.
Tolerance: equality throughout.  Cluster cases wait on deadlines.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_raft import free_ports, leaders, wait_for

from seaweedfs_tpu.wdclient import fid_lease as j_fid_lease
from seaweedfs_tpu.wdclient import masterclient as j_mc
from seaweedfs_tpu_torch.master import server as t_server
from seaweedfs_tpu_torch.master.follower import MasterFollower
from seaweedfs_tpu_torch.rpc import policy as t_policy
from seaweedfs_tpu_torch.rpc.http_rpc import call
from seaweedfs_tpu_torch.wdclient import fid_lease as t_fid_lease
from seaweedfs_tpu_torch.wdclient import masterclient as t_mc


def counting_assign(record, reply=None):
    """assign_fn stub: records (count, replication, collection, ttl)."""
    lock = threading.Lock()

    def assign(n, replication="", collection="", ttl=""):
        with lock:
            record.append((n, replication, collection, ttl))
            seq = len(record)
        out = {"fid": f"3,{seq:08x}ab", "url": "127.0.0.1:9999",
               "publicUrl": "127.0.0.1:9999", "count": n}
        if reply:
            out.update(reply)
        return out

    return assign


def _scenario(name, fid_lease, mc_mod, monkeypatch):
    """Run one lease scenario on one package; returns (calls, fids)."""
    env = {"WEED_FILER_ASSIGN_LEASE": "16"}
    reply = None
    if name == "ttl_expiry":
        env["WEED_FILER_ASSIGN_LEASE_TTL"] = "0.05"
    elif name == "auth_expiry":
        env["WEED_FILER_ASSIGN_LEASE_TTL"] = "8.0"
        reply = {"auth": "tok", "authExpiresSeconds": 2.1}
    elif name == "low_water":
        env["WEED_FILER_ASSIGN_LEASE"] = "4"
    elif name == "disabled":
        env["WEED_FILER_ASSIGN_LEASE"] = "1"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    cache = fid_lease.FidLeaseCache(counting_assign(calls, reply),
                                    name="t")
    fids = []
    if name == "batch":
        fids = [cache.get()["fid"] for _ in range(12)]
        fids += [cache.get(collection="pics")["fid"] for _ in range(3)]
    elif name in ("ttl_expiry", "auth_expiry"):
        fids.append(cache.get()["fid"])
        time.sleep(0.2)
        fids.append(cache.get()["fid"])
    elif name == "low_water":
        fids = [cache.get()["fid"] for _ in range(4)]
        assert wait_for(lambda: len(calls) >= 2, timeout=5)
        fids.append(cache.get()["fid"])
    elif name == "disabled":
        fids = [cache.get()["fid"] for _ in range(3)]
    elif name == "leader_change":
        fids.append(cache.get()["fid"])
        mc = mc_mod.MasterClient("127.0.0.1:0", name="t")
        mc._apply_watch_reply({"feed_id": "master-a"})
        mc._apply_watch_reply({"feed_id": "master-b"})
        fids.append(cache.get()["fid"])
    elif name == "invalidate":
        fids.append(cache.get()["fid"])
        cache.invalidate("stale")
        fids.append(cache.get()["fid"])
    stats = cache.stats()
    for k in [k for k in stats if "age" in k or "expires" in k]:
        stats.pop(k)
    return calls, fids, stats


@pytest.mark.parametrize("name", ["batch", "ttl_expiry", "auth_expiry",
                                  "low_water", "disabled",
                                  "leader_change", "invalidate"])
def test_fid_leases_equal(name, monkeypatch):
    j = _scenario(name, j_fid_lease, j_mc, monkeypatch)
    t = _scenario(name, t_fid_lease, t_mc, monkeypatch)
    assert t == j
    assert t[1]  # handed fids out


def test_lease_knobs_read_alike(monkeypatch):
    for raw in ("", "0", "1", "64", "junk", "-3"):
        monkeypatch.setenv("WEED_FILER_ASSIGN_LEASE", raw)
        monkeypatch.setenv("WEED_FILER_ASSIGN_LEASE_TTL", raw)
        assert t_fid_lease.lease_count() == j_fid_lease.lease_count()
        assert t_fid_lease.lease_ttl() == j_fid_lease.lease_ttl()


def _replies(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out, seq, feed = [], 0, "m1/00000001"
    for i in range(60):
        r = rng.random()
        if r < 0.08:
            feed = f"m{int(rng.integers(2, 5))}/{i:08x}"
            seq = 0
        deltas = []
        for _ in range(int(rng.integers(0, 4))):
            seq += 1
            deltas.append({"seq": seq, "op": ("add", "remove")[
                int(rng.random() < 0.3)],
                "volume": int(rng.integers(1, 8)),
                "url": f"10.0.0.{int(rng.integers(1, 4))}:8080",
                "publicUrl": "p"})
        out.append({"seq": seq, "deltas": deltas, "feed_id": feed,
                    "leader": f"10.9.0.{int(rng.integers(1, 4))}:9333",
                    "resync": bool(rng.random() < 0.05)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watch_replies_fold_alike(seed):
    clients = [mod.MasterClient(["10.9.0.1:9333"], name="w")
               for mod in (j_mc, t_mc)]
    for r in _replies(seed):
        states = []
        for c in clients:
            c._apply_watch_reply(r)
            states.append((c._seq, c._feed_id, list(c.masters),
                           c.current_master,
                           {v: c.vid_map.get(v) for v in range(1, 8)},
                           len(c.vid_map)))
        assert states[1] == states[0]


def test_vid_map_ops_alike():
    rng = np.random.default_rng(4)
    maps = [j_mc.VidMap(), t_mc.VidMap()]
    for _ in range(300):
        vid = int(rng.integers(1, 6))
        url = f"h{int(rng.integers(3))}"
        r = rng.random()
        for m in maps:
            if r < 0.5:
                m.add(vid, url, url + "p")
            elif r < 0.8:
                m.remove(vid, url)
            elif r < 0.97:
                m.set(vid, [{"url": url, "publicUrl": url}])
            else:
                m.clear()
        assert [maps[1].get(v) for v in range(6)] == \
            [maps[0].get(v) for v in range(6)]
        assert len(maps[1]) == len(maps[0])


# -- live: failover over a port raft group ---------------------------------------


@pytest.fixture
def port_trio(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    ports = free_ports(3)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    for i, p in enumerate(ports):
        d = tmp_path / f"m{i}"
        d.mkdir()
        m = t_server.MasterServer(port=p, peers=list(addrs),
                                  raft_dir=str(d), pulse_seconds=1.0,
                                  raft_election_timeout=0.6)
        m.start()
        masters.append(m)
    yield masters
    for m in masters:
        m.stop()


def _heartbeat(m, ip="10.1.1.1", port=8080, vids=(1, 2, 3)):
    call(m.address, "/api/heartbeat", {
        "ip": ip, "port": port, "public_url": f"{ip}:{port}",
        "max_volume_count": 8, "max_file_key": 100,
        "volumes": [{"id": v, "collection": "", "size": 10,
                     "replica_placement": 0} for v in vids]})


def test_clients_fail_over_to_the_new_leader(port_trio):
    masters = port_trio
    t_policy.reset_state()
    assert wait_for(lambda: len(leaders(masters)) == 1, timeout=30)
    leader = leaders(masters)[0]
    for m in masters:  # every master's topology knows the node
        _heartbeat(m)
    # list the dead-to-be leader first, so each client starts there
    order = [leader.address] + [m.address for m in masters
                                if m is not leader]
    clients = [mod.MasterClient(list(order), name="c")
               for mod in (j_mc, t_mc)]
    for c in clients:
        assert c.assign()["url"] == "10.1.1.1:8080"
        assert [loc["url"] for loc in c.lookup(2)] == ["10.1.1.1:8080"]
        c._apply_watch_reply(call(leader.address,
                                  "/dir/watch?since=0&timeout=0.1"))
        assert c._seq > 0 and c._feed_id
    old_feed = clients[1]._feed_id
    leader.stop()
    rest = [m for m in masters if m is not leader]
    assert wait_for(lambda: len(leaders(rest)) == 1, timeout=30)
    new = leaders(rest)[0]
    for m in rest:
        _heartbeat(m)
    for c in clients:
        assert wait_for(lambda c=c: _assigns(c), timeout=30)
        # a surviving master answered (a follower proxies to the leader)
        assert c.current_master in {m.address for m in rest}
        # the new leader's feed is another sequence space: the cursor
        # restarts and the cache empties, then refills from the feed
        c._apply_watch_reply(call(new.address,
                                  "/dir/watch?since=0&timeout=0.1"))
        assert c._seq == 0 and c._feed_id != old_feed
        assert len(c.vid_map) == 0
        reply = call(new.address,
                     f"/dir/watch?since={c._seq}&timeout=0.1")
        c._apply_watch_reply(reply)
        assert c._seq > 0 and len(c.vid_map) == 3
        # the client follows the leader the feed names
        assert c.current_master == reply["leader"]
        assert reply["leader"] in {m.address for m in rest}
    assert (clients[1]._seq, clients[1]._feed_id) == \
        (clients[0]._seq, clients[0]._feed_id)


def _assigns(client) -> bool:
    try:
        return client.assign()["url"] == "10.1.1.1:8080"
    except Exception:
        return False


def test_follower_serves_lookups_and_assigns(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    (tmp_path / "m").mkdir()
    m = t_server.MasterServer(port=0, pulse_seconds=1.0,
                              raft_dir=str(tmp_path / "m"))
    m.start()
    follower = MasterFollower([m.address], port=0)
    follower.start()
    try:
        assert wait_for(lambda: m.raft.is_leader)
        _heartbeat(m, vids=(7,))
        found = call(follower.address, "/dir/lookup?volumeId=7")
        assert found == {"volumeId": "7", "locations": [
            {"url": "10.1.1.1:8080", "publicUrl": "10.1.1.1:8080"}]}
        assert call(follower.address, "/dir/assign")["fid"] \
            .startswith("7,")
        st = call(follower.address, "/cluster/status")
        assert st["Follower"] is True and st["Masters"] == [m.address]
    finally:
        follower.stop()
        m.stop()
