"""Deep scrub of an EC volume spread over seven volume servers, as the
shell's `ec.encode` lays it out: 2 shards per server, so the scrubbing
server reads 2 shards from its disk and 12 from its peers.

An in-process master and seven port volume servers (device="cpu") in one
rack; seeded needles POSTed into volume 1 on the first server, which the
shell's `ec_encode` turns into 14 shards spread 2 per server.  The port's
`deep_scrub([vs.scrub_target(vid)])` on the source is held to the plain
reference of the benchmark (ecbench/reference/spread_scrub.py, on the
servers' files) and to the JAX package's deep scrub of the gathered files:
the same verdict, the same 14 file CRC chains and the same 4 recomputed
parity CRCs; with a byte flipped in a peer's shard, the same one corrupt
shard; with a peer stopped, its shards unreadable and the verdict not
clean.  The peer fetches count their bytes under the background class and
hang their `ec.peer_read` spans under the batch read spans, and the
maintenance worker's deep.scrub report keeps its shape, its pacer and
the master's shard map of now (R5).
Tolerance: equality throughout.
"""

import importlib
import os
import shutil

import numpy as np
import pytest

from test_torch_volume_server import _reset_process_state

from ecbench.reference import spread_scrub
from seaweedfs_tpu_torch import qos, tracing
from seaweedfs_tpu_torch.maintenance import deep_scrub as t_ds
from seaweedfs_tpu_torch.master import server as t_master
from seaweedfs_tpu_torch.rpc.http_rpc import call
from seaweedfs_tpu_torch.shell import commands as t_sh
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.volume_server import server as t_server

# the JAX package's maintenance/__init__ exports a deep_scrub function
# that shadows the module's name
j_ds = importlib.import_module("seaweedfs_tpu.maintenance.deep_scrub")

VID = 1
SERVERS = 7
TOTAL = spread_scrub.TOTAL_SHARDS


def _needles(seed: int = 31, count: int = 24):
    rng = np.random.default_rng(seed)
    return [(i, 0x30000000 + i * 7919,
             rng.bytes(int(np.exp(rng.uniform(np.log(200),
                                              np.log(60 << 10))))))
            for i in range(1, count + 1)]


class Cluster:
    """A master and seven volume servers over volume 1, ec.encoded."""

    def __init__(self, root):
        (root / "m").mkdir()
        self.master = t_master.MasterServer(port=0, volume_size_limit_mb=64,
                                            pulse_seconds=0.2,
                                            raft_dir=str(root / "m"))
        self.master.start()
        self.servers, self.dirs = [], []
        for i in range(SERVERS):
            d = root / f"vs{i}"
            d.mkdir()
            vs = t_server.VolumeServer(
                [str(d)], self.master.address, port=0, pulse_seconds=0.2,
                ec_encoder_backend="cuda", device="cpu")
            vs.start()
            self.servers.append(vs)
            self.dirs.append(str(d))
        call(self.source.address, "/admin/assign_volume", {"volume": VID})
        for vs in self.servers:
            vs.heartbeat_once()
        for nid, cookie, body in _needles():
            call(self.source.address, f"/{VID},{nid:x}{cookie:08x}",
                 raw=body, method="POST")
        t_sh.ec_encode(t_sh.CommandEnv(self.master.address), VID)
        for vs in self.servers:
            vs.heartbeat_once()

    @property
    def source(self):
        return self.servers[0]

    def holder(self, sid: int) -> int:
        (i,) = spread_scrub.collect(self.dirs, VID)[sid]
        return i

    def gather(self, into) -> str:
        """Every shard file and the .vif copied into one directory;
        returns the volume's base name there."""
        for sid in range(TOTAL):
            name = spread_scrub.shard_name(VID, sid)
            shutil.copy(os.path.join(self.dirs[self.holder(sid)], name),
                        os.path.join(into, name))
        shutil.copy(os.path.join(self.dirs[0], f"{VID}.vif"),
                    os.path.join(into, f"{VID}.vif"))
        return os.path.join(into, str(VID))

    def stop(self):
        for vs in self.servers:
            vs.stop()
        self.master.stop()


@pytest.fixture
def cluster(tmp_path, monkeypatch):
    for k, v in (("WEED_MAINT_WORKER", "0"), ("WEED_MAINT_INTERVAL", "3600"),
                 ("WEED_TRACE_SAMPLE", "0")):
        monkeypatch.setenv(k, v)
    _reset_process_state()
    c = Cluster(tmp_path)
    try:
        yield c
    finally:
        c.stop()


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _port_scrub(c):
    target = c.source.scrub_target(VID)
    out = t_ds.deep_scrub([target], device="cpu")
    return out["volumes"][0], target


def _jax_scrub(c, tmp_path):
    d = tmp_path / "gathered"
    d.mkdir(exist_ok=True)
    target = j_ds.local_target(c.gather(str(d)), VID)
    out = j_ds.deep_scrub([target])
    return out["volumes"][0], target


def test_ec_encode_spreads_two_shards_per_server(cluster):
    held = spread_scrub.collect(cluster.dirs, VID)
    assert spread_scrub.layout_wrong(held, SERVERS, 2) == 0
    assert sorted(held) == list(range(TOTAL))
    local = sorted(cluster.source.store.find_ec_volume(VID).shards)
    assert local == sorted(s for s, (i,) in held.items() if i == 0)


def test_scrub_of_the_spread_volume_equals_the_references(cluster, tmp_path):
    got, target = _port_scrub(cluster)
    ref = spread_scrub.scrub(cluster.dirs, VID, "cpu")
    want, j_target = _jax_scrub(cluster, tmp_path)
    assert got["ok"] is ref["clean"] is want["ok"] is True
    assert target.chains == ref["chains"] == j_target.chains
    assert target.computed == ref["computed"] == j_target.computed
    assert got == want
    assert ref["parity_rows_wrong"] == 0


@pytest.mark.parametrize("where", ["data", "parity"])
def test_a_flipped_byte_on_a_peer_is_the_one_corrupt_shard(cluster,
                                                          tmp_path, where):
    held = spread_scrub.collect(cluster.dirs, VID)
    remote = [s for s, (i,) in sorted(held.items()) if i != 0]
    sid = next(s for s in remote
               if (s < spread_scrub.DATA_SHARDS) == (where == "data"))
    _flip(os.path.join(cluster.dirs[held[sid][0]],
                       spread_scrub.shard_name(VID, sid)), 4097)
    got, target = _port_scrub(cluster)
    ref = spread_scrub.scrub(cluster.dirs, VID, "cpu")
    want, j_target = _jax_scrub(cluster, tmp_path)
    assert got["corrupt"] == want["corrupt"] == [sid]
    assert got["parity_mismatch"] == want["parity_mismatch"] == []
    assert not got["ok"] and not ref["clean"]
    assert target.chains == ref["chains"] == j_target.chains
    assert [i for i in range(TOTAL)
            if ref["chains"][i] != ref["stored"][i]] == [sid]
    assert target.computed == ref["computed"]
    assert got == want


def test_a_stopped_peer_leaves_its_shards_unreadable(cluster):
    peer = cluster.holder(next(
        s for s in range(TOTAL) if cluster.holder(s) != 0))
    gone = sorted(s for s in range(TOTAL) if cluster.holder(s) == peer)
    cluster.servers[peer].stop()
    before = metrics.EcPeerReadErrorsCounter._values.get(("background",), 0)
    got, _ = _port_scrub(cluster)
    # a server holds shards i and i + 7, one of them a data shard: the
    # recompute stops.  (The shards read before that are then chained a
    # second time by the file-CRC sweep, as in the JAX package, and read
    # as corrupt: not pinned here.)
    assert got["unreadable"] == gone
    assert not got["ok"] and not got["recomputed"]
    assert metrics.EcPeerReadErrorsCounter._values[("background",)] \
        - before >= len(gone)


def test_peer_fetches_count_background_bytes_and_hang_under_batches(
        cluster, monkeypatch):
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    monkeypatch.setenv("WEED_TRACE_MAX_TRACES", "100000")
    tracing.RECORDER.reset()
    held = spread_scrub.collect(cluster.dirs, VID)
    remote_bytes = sum(
        os.path.getsize(os.path.join(cluster.dirs[i],
                                     spread_scrub.shard_name(VID, s)))
        for s, (i,) in held.items() if i != 0)
    values = metrics.EcPeerReadBytesCounter._values
    before = dict(values)
    secs = metrics.EcPeerReadSecondsCounter._values.get(("background",), 0)
    got, _ = _port_scrub(cluster)
    assert got["ok"]
    rose = {k: v - before.get(k, 0) for k, v in values.items()
            if v != before.get(k, 0)}
    assert rose == {("background",): remote_bytes}
    assert metrics.EcPeerReadSecondsCounter._values[("background",)] > secs

    (entry,) = [e for e in tracing.RECORDER.index(limit=100000)
                if e["root"] == "maint.deep_scrub"]
    (root,) = tracing.RECORDER.get(entry["trace_id"])["tree"]
    peer_reads = []
    for batch in root["children"]:
        kids = [k for k in batch["children"] if k["name"] == "ec.peer_read"]
        assert not kids or batch["name"] == "scrub.batch.read"
        peer_reads += kids
    assert len(peer_reads) == 12 * len(
        [b for b in root["children"] if b["name"] == "scrub.batch.read"])
    assert sum(k["tags"]["bytes"] for k in peer_reads) == remote_bytes
    assert {k["tags"]["qos_class"] for k in peer_reads} == {"background"}
    assert {k["tags"]["shard"] for k in peer_reads} == {
        s for s, (i,) in held.items() if i != 0}
    tracing.RECORDER.reset()


def test_worker_report_keeps_its_shape_its_pacer_and_the_map_of_now(
        cluster, tmp_path):
    """The worker's deep.scrub executor, now over scrub_target: the
    verdict of the JAX package's scrub of the same files, the report's
    keys as before, every scrubbed byte through the worker's pacer, and a
    stale location cache (a map without the peers) dropped first."""
    vs = cluster.source
    vs._ec_locations[VID] = (1e18, {}, False)  # fresh forever, empty
    worker = vs.maintenance_worker
    paced = worker.pacer.snapshot()["paced_bytes"]
    with qos.qos_scope(qos.BACKGROUND, tenant="maintenance"):
        report = worker._execute({"id": "j1", "type": "deep.scrub",
                                  "volume": VID, "collection": ""})
    want, _ = _jax_scrub(cluster, tmp_path)
    assert set(report) == set(want) | {"stage_stats", "pacer"}
    assert {k: report[k] for k in want} == want and report["ok"]
    assert report["pacer"]["paced_bytes"] - paced == report["bytes"]
    assert report["stage_stats"]["backend"] == "device-pooled"


def test_a_spread_volume_target_reads_through_bytes_alone(cluster):
    """With 12 of its 14 shards on peers, the target offers no
    `read_into`: every span, its 2 local shards' too, is staged through
    `bytes`."""
    target = cluster.source.scrub_target(VID)
    assert target.read_into is None
    st = {}
    out = t_ds.deep_scrub([target], device="cpu", stage_stats=st)
    assert out["volumes"][0]["ok"]
    assert st["read_direct_bytes"] == 0
    assert st["read_copied_bytes"] == out["scrubbed_bytes"]


def test_a_wholly_held_volume_target_fills_the_stage_in_place(cluster):
    """A volume whose 14 shards are all mounted on the scrubbing server:
    its target offers `read_into` (each shard's pread into the stage),
    and its scrub is the JAX package's over the same files, with every
    span filled in place."""
    vs, vid = cluster.source, VID + 1
    call(vs.address, "/admin/assign_volume", {"volume": vid})
    for nid, cookie, body in _needles(seed=37, count=12):
        call(vs.address, f"/{vid},{nid:x}{cookie:08x}", raw=body,
             method="POST")
    for path, body in (("/admin/readonly", {"volume": vid}),
                       ("/admin/ec/generate", {"volume": vid}),
                       ("/admin/ec/mount", {"volume": vid,
                                            "shard_ids": list(range(TOTAL))})):
        call(vs.address, path, body)
    target = vs.scrub_target(vid)
    assert target.read_into is not None
    st = {}
    got = t_ds.deep_scrub([target], device="cpu", stage_stats=st)
    want = j_ds.deep_scrub([j_ds.local_target(
        os.path.join(cluster.dirs[0], str(vid)), vid)])
    assert got["volumes"] == want["volumes"] and got["volumes"][0]["ok"]
    assert st["read_copied_bytes"] == 0 and st["stage_copy"] == 0
    assert st["read_direct_bytes"] == got["scrubbed_bytes"] > 0
