"""The port's scale shell and scale jobs, as tests/test_elasticity.py holds
the JAX package's.

- `cluster.scale` through the port's shell: the status view joins the
  curator's knobs with each node's telemetry, and the manual verbs
  enqueue the same jobs, equal to the JAX shell's on a JAX cluster.
- `scale.drain` run by the port's worker under a read storm: zero failed
  foreground reads, interactive p99 inside the isolation bound, every
  byte on the survivor.
- `scale.up` through the in-process seam, on both packages' workers.
- `scale.up` through the real subprocess path: a port master and volume
  server in a fresh interpreter (never a forked test process); the
  worker starts `python -m seaweedfs_tpu_torch volume -device cpu`,
  which registers with the master and is reaped by the server's stop.
Tolerance: equality, and the reference's latency bound.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from seaweedfs_tpu.maintenance.jobs import TYPE_SCALE_DRAIN, TYPE_SCALE_UP
from seaweedfs_tpu_torch.loadgen import percentile
from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cluster(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    monkeypatch.delenv("WEED_SCALE", raising=False)
    if pkg == "port":
        from seaweedfs_tpu_torch.master.server import MasterServer
        from seaweedfs_tpu_torch.volume_server.server import VolumeServer
        kw = {"device": "cpu"}
    else:
        from seaweedfs_tpu.master.server import MasterServer
        from seaweedfs_tpu.volume_server.server import VolumeServer
        kw = {}
    root = tmp_path / pkg
    (root / "m").mkdir(parents=True)
    master = MasterServer(port=0, volume_size_limit_mb=64,
                          pulse_seconds=0.2, raft_dir=str(root / "m"))
    master.start()
    servers = []
    for i in range(2):
        d = root / f"vs{i}"
        d.mkdir()
        vs = VolumeServer([str(d)], master.address, port=0,
                          rack=f"rack{i}", pulse_seconds=0.2, **kw)
        vs.start()
        vs.heartbeat_once()
        servers.append(vs)
    return master, servers


@pytest.fixture
def scale_cluster(tmp_path, monkeypatch):
    """A port master and two port volume servers on the CPU; worker
    threads parked so tests drive poll_once()."""
    master, servers = _cluster("port", tmp_path, monkeypatch)
    yield master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def _preload(master, n=40, size=2048):
    stored = {}
    for _ in range(n):
        a = call(master.address, "/dir/assign")
        payload = os.urandom(size)
        call(a["url"], f"/{a['fid']}", raw=payload, method="POST")
        stored[a["fid"]] = payload
    return stored


def _read(master, fid, retries=3):
    """Foreground read with fresh-lookup retry: mid-evacuation a volume
    may vanish from its old holder between lookup and GET."""
    vid = int(fid.split(",")[0])
    last = None
    for attempt in range(retries + 1):
        try:
            found = call(master.address, f"/dir/lookup?volumeId={vid}")
            for loc in found["locations"]:
                try:
                    return call(loc["url"], f"/{fid}")
                except RpcError as e:
                    last = e
        except RpcError as e:
            last = e
        time.sleep(0.05 * (attempt + 1))
    raise last or RpcError(f"unreachable {fid}", 404)


class TestScaleShell:
    def test_status_joins_knobs_and_telemetry(self, tmp_path, monkeypatch):
        from seaweedfs_tpu.shell import commands as j_sh
        from seaweedfs_tpu.shell import commands_scale as j_scale
        from seaweedfs_tpu_torch.shell import commands as t_sh
        from seaweedfs_tpu_torch.shell import commands_scale as t_scale

        views = {}
        for pkg, sh, scale in (("jax", j_sh, j_scale),
                               ("port", t_sh, t_scale)):
            master, servers = _cluster(pkg, tmp_path, monkeypatch)
            try:
                st = scale.scale_status(sh.CommandEnv(master.address))
            finally:
                for vs in servers:
                    vs.stop()
                master.stop()
            names = {vs.address: f"<vs{i}>" for i, vs in enumerate(servers)}
            st["nodes"] = sorted(({**n, "url": names[n["url"]]}
                                  for n in st["nodes"]),
                                 key=lambda n: n["url"])
            views[pkg] = st
        assert views["port"] == views["jax"]
        st = views["port"]
        assert st["autoscale"]["enabled"] is False
        assert len(st["nodes"]) == 2 and st["scale_jobs"] == []
        for n in st["nodes"]:
            assert n.keys() >= {"url", "volumes", "occupancy", "rps",
                                "draining"}
            assert n["draining"] is False

    def test_manual_up_and_drain_enqueue_jobs(self, scale_cluster):
        from seaweedfs_tpu_torch.shell import commands as sh
        from seaweedfs_tpu_torch.shell import commands_scale as scale

        master, servers = scale_cluster
        env = sh.CommandEnv(master.address)
        assert scale.scale_up(env)["enqueued"]
        target = servers[1].store.url
        assert scale.scale_drain(env, target)["enqueued"]
        with pytest.raises(ValueError):
            scale.scale_drain(env, "")
        jobs = scale.scale_status(env)["scale_jobs"]
        assert {j["type"] for j in jobs} == {TYPE_SCALE_UP,
                                             TYPE_SCALE_DRAIN}
        drain = next(j for j in jobs if j["type"] == TYPE_SCALE_DRAIN)
        assert drain["params"]["server"] == target


def test_scale_drain_under_storm_keeps_reads_whole(scale_cluster):
    """scale.drain of a populated server while a read storm runs: the
    port's worker completes the drain (read-only demotion, evacuation,
    deregistration) with zero failed foreground reads, interactive p99
    within the isolation bound, and every byte on the survivor."""
    master, servers = scale_cluster
    stored = _preload(master, n=40)
    fids = sorted(stored)
    for vs in servers:
        vs.heartbeat_once()

    base = []
    for fid in fids[:30]:
        t0 = time.monotonic()
        assert _read(master, fid) == stored[fid]
        base.append(time.monotonic() - t0)
    base_p99 = percentile(sorted(base), 0.99)
    bound = max(2.0 * base_p99, base_p99 + 0.25)

    victim_url = servers[1].store.url
    stop = threading.Event()

    def storm():
        i = 0
        while not stop.is_set():
            try:
                _read(master, fids[i % len(fids)], retries=0)
            except RpcError:
                pass  # storm reads are load, not the assertion
            i += 1

    storm_threads = [threading.Thread(target=storm, daemon=True)
                     for _ in range(6)]
    for th in storm_threads:
        th.start()
    call(master.address, "/maintenance/run",
         {"type": TYPE_SCALE_DRAIN, "params": {"server": victim_url}})
    drained = {"n": 0}

    def drain():
        drained["n"] = servers[0].maintenance_worker.poll_once()

    drain_th = threading.Thread(target=drain, daemon=True)
    drain_th.start()
    lats, failures = [], 0
    deadline = time.monotonic() + 60.0
    i = 0
    while (drain_th.is_alive() or i < 20) and time.monotonic() < deadline:
        fid = fids[i % len(fids)]
        t0 = time.monotonic()
        try:
            assert _read(master, fid) == stored[fid]
        except RpcError:
            failures += 1
        lats.append(time.monotonic() - t0)
        i += 1
    drain_th.join(timeout=30.0)
    stop.set()
    for th in storm_threads:
        th.join(timeout=5.0)

    assert not drain_th.is_alive(), "drain never completed"
    assert drained["n"] == 1, "worker leased no scale.drain job"
    assert servers[0].maintenance_worker.failed == 0
    assert failures == 0, f"{failures} foreground reads failed mid-drain"
    p99 = percentile(sorted(lats), 0.99)
    assert p99 <= bound, (f"drain p99 {p99 * 1e3:.1f}ms exceeds bound "
                          f"{bound * 1e3:.1f}ms (base "
                          f"{base_p99 * 1e3:.1f}ms)")
    (done,) = master.curator.queue.history
    assert done["type"] == TYPE_SCALE_DRAIN and done["outcome"] == "ok"
    # the victim left the topology (a heartbeat it sent just before its
    # leave can land after it; the master's reaper then drops the node
    # after its missed pulses, in both packages)
    deadline = time.monotonic() + 15.0
    while True:
        servers[0].heartbeat_once()
        status = call(master.address, "/dir/status")
        urls = [n["url"] for dc in status["datacenters"]
                for rack in dc["racks"] for n in rack["nodes"]]
        if urls == [servers[0].store.url] or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert urls == [servers[0].store.url]
    for fid, payload in stored.items():
        assert _read(master, fid) == payload


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_scale_up_through_the_in_process_seam(tmp_path, monkeypatch, pkg):
    """A server with a spawn seam grows the cluster in its own process:
    the job's report and the new node's registration agree across
    packages."""
    master, servers = _cluster(pkg, tmp_path, monkeypatch)
    vs_cls = type(servers[0])
    kw = {"device": "cpu"} if pkg == "port" else {}
    spawned = []

    def spawn(job):
        d = tmp_path / pkg / f"spawn{len(spawned)}"
        d.mkdir()
        vs = vs_cls([str(d)], master.address, port=0, pulse_seconds=0.2,
                    **kw)
        vs.start()
        vs.heartbeat_once()
        spawned.append(vs)
        return vs.address

    servers[0].spawn_volume_server = spawn
    worker = servers[0].maintenance_worker
    reports = []
    execute = worker._execute
    worker._execute = lambda job: reports.append(execute(job)) or reports[-1]
    try:
        call(master.address, "/maintenance/run",
             {"type": TYPE_SCALE_UP, "params": {"from": "test"}})
        assert servers[0].maintenance_worker.poll_once() == 1
        (done,) = master.curator.queue.history
        assert done["type"] == TYPE_SCALE_UP and done["outcome"] == "ok"
        assert reports == [{"spawned": spawned[0].address,
                            "mode": "in-process"}]
        status = call(master.address, "/dir/status")
        urls = {n["url"] for dc in status["datacenters"]
                for rack in dc["racks"] for n in rack["nodes"]}
        assert urls == {vs.address for vs in servers + spawned}
    finally:
        for vs in spawned + servers:
            vs.stop()
        master.stop()


SUBPROCESS_SCALE_UP = r"""
import json, os, sys, time
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.rpc.http_rpc import call
from seaweedfs_tpu_torch.volume_server.server import VolumeServer

root = sys.argv[1]
os.makedirs(os.path.join(root, "m"))
os.makedirs(os.path.join(root, "v"))
master = MasterServer(port=0, pulse_seconds=0.5,
                      raft_dir=os.path.join(root, "m"))
master.start()
vs = VolumeServer([os.path.join(root, "v")], master.address, port=0,
                  pulse_seconds=0.5, device="cpu",
                  ec_encoder_backend="torch")
vs.start()
vs.heartbeat_once()
out = {}
reports = []
execute = vs.maintenance_worker._execute
vs.maintenance_worker._execute = (
    lambda job: reports.append(execute(job)) or reports[-1])
try:
    call(master.address, "/maintenance/run",
         {"type": "scale.up", "params": {"from": "test"}})
    out["leased"] = vs.maintenance_worker.poll_once()
    out["report"] = reports[0]
    out["failed"] = vs.maintenance_worker.failed
    (child,) = vs.scale_children
    out["args"] = child.args
    status = call(master.address, "/dir/status")
    out["nodes"] = sorted(n["url"] for dc in status["datacenters"]
                          for r in dc["racks"] for n in r["nodes"])
    out["self"] = vs.address
    out["pid"] = child.pid
finally:
    vs.stop()
    master.stop()
out["reaped"] = child.poll() is not None
print(json.dumps(out))
"""


def test_scale_up_spawns_the_ports_volume_server(tmp_path):
    """The worker's subprocess path, in a fresh interpreter: the child is
    the port's CLI on the spawner's device and backend, registers with
    the master, and is gone after the spawner stops."""
    env = dict(os.environ, WEED_MAINT_WORKER="0", WEED_MAINT_INTERVAL="3600",
               WEED_SCALE_DIR=str(tmp_path), WEED_SCALE_SPAWN_TIMEOUT="90")
    proc = subprocess.Popen(
        [sys.executable, "-c", SUBPROCESS_SCALE_UP, str(tmp_path / "c")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        stdout, stderr = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    out = json.loads(stdout.strip().splitlines()[-1])
    assert out["leased"] == 1 and out["failed"] == 0, out
    assert out["report"]["mode"] == "subprocess"
    assert out["report"]["nodes"] == 2
    workdir = out["report"]["spawned"]
    assert os.path.dirname(workdir) == str(tmp_path)
    assert out["args"][1:] == [
        "-m", "seaweedfs_tpu_torch", "volume", "-dir", workdir,
        "-mserver", out["args"][out["args"].index("-mserver") + 1],
        "-port", "0", "-pulseSeconds", "0.5", "-device", "cpu",
        "-ecBackend", "torch"]
    assert len(out["nodes"]) == 2 and out["self"] in out["nodes"]
    assert out["reaped"]
    with pytest.raises(ProcessLookupError):
        os.kill(out["pid"], 0)
