"""The port's replicated control state against the JAX package's.

- `ControlFSM`: the same commands give equal returns and snapshots with
  the same JSON, shard map included; each package restores the other's
  snapshot and applies the rest of the log to the same state.
- `ShardMap`: the same seeded leases, releases and resizes give equal
  maps.
- A port raft group of three elects one leader, replicates, survives the
  leader's stop, and lets a learner join (`/raft/join`) and be promoted.
- Carried state, in place of carried weights: a port master boots from a
  `raft_dir` a JAX master wrote, with the same `max_volume_id`, queue
  and shard map; the reverse holds too.
- A mixed group of one JAX and two port masters agrees on one committed
  log over the wire.
Tolerance: equality throughout.  Cluster cases wait on deadlines.
"""

import json
import time

import numpy as np
import pytest

from test_control_plane_ha import _command_script
from test_raft import free_ports, leaders, wait_for

from seaweedfs_tpu.filer import shard_map as j_shard_map
from seaweedfs_tpu.master import fsm as j_fsm
from seaweedfs_tpu.master import server as j_server
from seaweedfs_tpu.rpc.http_rpc import RpcError as JRpcError
from seaweedfs_tpu_torch.filer import shard_map as t_shard_map
from seaweedfs_tpu_torch.master import fsm as t_fsm
from seaweedfs_tpu_torch.master import raft as t_raft
from seaweedfs_tpu_torch.master import server as t_server
from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call


def on_leader(masters, fn, timeout=30.0):
    """fn(leader) on whichever master leads, tried again when a
    leadership change under load makes the leader refuse it (a refused
    command that still commits is deduped or superseded by the retry)."""
    deadline = time.time() + timeout
    while True:
        assert wait_for(lambda: len(leaders(masters)) == 1, timeout=30)
        try:
            return fn(leaders(masters)[0])
        except (RpcError, JRpcError):
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def converged(masters) -> bool:
    """Every master has applied the same log."""
    return (len({m.raft.commit_index for m in masters}) == 1
            and len({_dump(m.raft.fsm) for m in masters}) == 1)


def _dump(fsm) -> str:
    return json.dumps(fsm.snapshot(), sort_keys=True)


def _script() -> list:
    """The JAX package's FSM determinism script plus a shard resize."""
    return _command_script() + [
        {"type": "filer.lease", "now": 208.0,
         "holder": "127.0.0.1:7103", "ttl": 30.0},
        {"type": "filer.resize", "op": "start", "to": 16, "now": 209.0},
        {"type": "filer.resize", "op": "ack", "now": 210.0,
         "holder": "127.0.0.1:7102"},
        {"type": "filer.resize", "op": "ack", "now": 211.0,
         "holder": "127.0.0.1:7103"},
        {"type": "filer.resize", "op": "commit", "now": 212.0},
        {"type": "filer.resize", "op": "bogus", "now": 213.0},
        {"type": "no.such.command", "now": 214.0},
    ]


def test_fsm_returns_and_snapshots_equal():
    j, t = j_fsm.ControlFSM(), t_fsm.ControlFSM()
    for cmd in _script():
        assert t.apply(dict(cmd)) == j.apply(dict(cmd)), cmd
        assert _dump(t) == _dump(j), cmd
    assert t.snapshot()["shards"]["slots"] == 16


@pytest.mark.parametrize("cut", [1, 9, 17, 24])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_fsm_restores_the_others_snapshot(direction, cut):
    src, dst = (j_fsm, t_fsm) if direction == "jax-to-port" \
        else (t_fsm, j_fsm)
    cmds = _script()
    full = src.ControlFSM()
    for cmd in cmds:
        full.apply(dict(cmd))
    head = src.ControlFSM()
    for cmd in cmds[:cut]:
        head.apply(dict(cmd))
    resumed = dst.ControlFSM()
    resumed.restore(json.loads(json.dumps(head.snapshot())))
    for cmd in cmds[cut:]:
        resumed.apply(dict(cmd))
    assert _dump(resumed) == _dump(full)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_map_sequences_equal(seed):
    rng = np.random.default_rng(seed)
    maps = [j_shard_map.ShardMap(slots=8), t_shard_map.ShardMap(slots=8)]
    now = 100.0
    holders = [f"127.0.0.1:{7100 + i}" for i in range(5)]
    for _ in range(120):
        now += float(rng.integers(0, 6))
        h = holders[int(rng.integers(len(holders)))]
        r = rng.random()
        if r < 0.5:
            op = ("lease", h, now, float(rng.integers(3, 20)))
        elif r < 0.65:
            op = ("release", h, now)
        elif r < 0.75:
            op = ("resize_start", int((4, 16, 32)[int(rng.integers(3))]),
                  now)
        elif r < 0.88:
            op = ("resize_ack", h, now)
        elif r < 0.95:
            op = ("resize_commit", now)
        else:
            op = ("resize_abort", now)
        got = [getattr(m, op[0])(*op[1:]) for m in maps]
        assert got[1] == got[0], op
        assert maps[1].to_dict() == maps[0].to_dict()
        assert maps[1].resize_pending(now) == maps[0].resize_pending(now)
        for d in ("/a", "/buckets/x/y", "/z/"):
            assert maps[1].holder_of(d) == maps[0].holder_of(d)
    d = maps[0].to_dict()
    assert t_shard_map.ShardMap.from_dict(d).to_dict() == d


# -- a port raft group -----------------------------------------------------------


def _start(mod, tmp_path, name, port, peers, **kw):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    m = mod.MasterServer(port=port, peers=peers, raft_dir=str(d),
                         raft_election_timeout=0.6, pulse_seconds=1.0,
                         **kw)
    m.start()
    return m


@pytest.fixture
def port_trio(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    ports = free_ports(3)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    masters = [_start(t_server, tmp_path, f"m{i}", p, list(addrs))
               for i, p in enumerate(ports)]
    yield masters
    for m in masters:
        m.stop()


def test_port_group_elects_replicates_and_fails_over(port_trio):
    masters = port_trio
    vids = [on_leader(masters, lambda m: m.raft.next_volume_id())
            for _ in range(5)]
    assert vids == sorted(set(vids))
    on_leader(masters, lambda m: m.raft.propose({
        "type": "curator.enqueue", "now": 5.0, "job_type": "ec.rebuild",
        "volume": 9, "collection": "", "params": {}}))
    assert wait_for(lambda: converged(masters)
                    and len(leaders(masters)) == 1)
    leader = leaders(masters)[0]
    assert leader.raft.max_volume_id == vids[-1]
    assert [(j["id"], j["type"]) for j in leader.raft.fsm.queue.jobs()] \
        == [("j1", "ec.rebuild")]
    want = _dump(leader.raft.fsm)
    # the leader stops: a new one is elected with the same state and
    # allocation goes on past the old ids
    leader.stop()
    rest = [m for m in masters if m is not leader]
    assert wait_for(lambda: len(leaders(rest)) == 1, timeout=30)
    assert all(_dump(m.raft.fsm) == want for m in rest)
    assert on_leader(rest, lambda m: m.raft.next_volume_id()) > vids[-1]
    # a follower refuses a proposal with 409 (sampled again if the
    # leadership moved under load between the two reads)
    status = None
    for _ in range(10):
        assert wait_for(lambda: len(leaders(rest)) == 1, timeout=30)
        follower = next(m for m in rest if not m.raft.is_leader)
        try:
            follower.raft.propose({"type": "topology.epoch", "now": 9.0})
        except RpcError as e:
            status = e.status
            if status == 409:
                break
        time.sleep(0.3)
    assert status == 409


def test_port_learner_joins_and_is_promoted(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    m0 = _start(t_server, tmp_path, "m0", 0, None)
    joiners = []
    try:
        assert wait_for(lambda: m0.raft.is_leader)
        for i in range(t_raft.SNAPSHOT_THRESHOLD + 8):
            m0.raft.propose({"type": "curator.enqueue", "now": 10.0 + i,
                             "job_type": "deep.scrub", "volume": i,
                             "collection": ""})
        assert m0.raft.snapshot_index > 0
        first = m0.raft.next_volume_id()
        for i in (1, 2):
            m = _start(t_server, tmp_path, f"m{i}", 0, [m0.address],
                       join=True)
            joiners.append(m)
            assert m.raft.address not in m.raft.voters
        assert wait_for(lambda: all(m.address in m0.raft.voters
                                    for m in joiners), timeout=30)
        assert m0.raft.learners == []
        group = [m0] + joiners
        assert on_leader(group, lambda m: m.raft.next_volume_id()) > first
        assert wait_for(lambda: converged(group))
        status = call(m0.address, "/raft/status")
        assert sorted(status["voters"]) == sorted(
            m.address for m in group)
    finally:
        for m in joiners:
            m.stop()
        m0.stop()


# -- carried state ---------------------------------------------------------------


def _write_state(mod, d) -> dict:
    """A single master of `mod` over `d`: allocations, queue work through
    the curator's raft proxy, a filer shard lease; returns its view."""
    m = mod.MasterServer(port=0, raft_dir=str(d), pulse_seconds=1.0)
    m.start()
    try:
        assert wait_for(lambda: m.raft.is_leader)
        for _ in range(3):
            m.raft.next_volume_id()
        q = m.curator.queue
        q.now = lambda: 1234.0
        q.enqueue("ec.rebuild", 4, "", {"missing": [0, 5]})
        q.enqueue("deep.scrub", 6, "pics", {})
        q.enqueue("vacuum", 2, "", {"garbage_ratio": 0.5})
        (leased,) = q.lease("127.0.0.1:8080", limit=1)
        q.complete(leased["id"], "127.0.0.1:8080")
        call(m.address, "/filer/shard_lease",
             {"holder": "127.0.0.1:8888", "ttl": 600.0})
        return {"max_volume_id": m.raft.max_volume_id,
                "fsm": _dump(m.raft.fsm)}
    finally:
        m.stop()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_master_boots_from_the_others_raft_dir(tmp_path, monkeypatch,
                                               direction):
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    src, dst = (j_server, t_server) if direction == "jax-to-port" \
        else (t_server, j_server)
    d = tmp_path / "raft"
    d.mkdir()
    want = _write_state(src, d)
    m = dst.MasterServer(port=0, raft_dir=str(d), pulse_seconds=1.0)
    m.start()
    try:
        assert m.raft.max_volume_id == want["max_volume_id"] == 3
        assert _dump(m.raft.fsm) == want["fsm"]
        fsm = json.loads(want["fsm"])
        assert [j["type"] for j in fsm["queue"]["jobs"]] == \
            ["deep.scrub", "vacuum"]
        assert m.raft.fsm.shard_map.to_dict() == fsm["shards"]
        assert wait_for(lambda: m.raft.is_leader)
        assert m.raft.next_volume_id() == 4
        assert call(m.address, "/maintenance/queue")["jobs"] == \
            m.raft.fsm.queue.jobs()
    finally:
        m.stop()


# -- a mixed group ---------------------------------------------------------------


def test_mixed_group_agrees_on_one_log(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    monkeypatch.setenv("WEED_MAINT", "0")
    ports = free_ports(3)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    mods = (j_server, t_server, t_server)
    masters = [_start(mod, tmp_path, f"m{i}", p, list(addrs))
               for i, (mod, p) in enumerate(zip(mods, ports))]
    try:
        ids = []
        for i in range(12):
            # through whichever master leads now (either package)
            if i % 3 == 0:
                ids.append(on_leader(
                    masters, lambda m: m.raft.next_volume_id()))
            else:
                on_leader(masters, lambda m, i=i: m.raft.propose({
                    "type": "curator.enqueue", "now": 50.0 + i,
                    "job_type": "deep.scrub", "volume": i,
                    "collection": ""}))
        assert ids == sorted(set(ids))
        assert wait_for(lambda: converged(masters)
                        and len(leaders(masters)) == 1)
        assert masters[0].raft.max_volume_id == ids[-1]
        assert sorted(j["volume"] for j in
                      masters[1].raft.fsm.queue.jobs()) == \
            [i for i in range(12) if i % 3]
        # the JAX master stops if it leads, else the port leader: the
        # rest go on with one log
        leader = leaders(masters)[0]
        victim = masters[0] if masters[0] is leader else leader
        victim.stop()
        rest = [m for m in masters if m is not victim]
        assert on_leader(rest, lambda m: m.raft.next_volume_id()) > ids[-1]
        assert wait_for(lambda: converged(rest))
    finally:
        for m in masters:
            m.stop()
