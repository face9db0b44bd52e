"""The port's prefork workers (rpc/prefork.py) against the JAX package's.

Two tiers:

* in-process cases of tests/test_prefork.py held against both packages:
  the worker knobs, a port-0 server that never preforks, the connection
  pool's split across workers, `merge_expositions`;
* ``@pytest.mark.multiproc`` cases (skipped below 2 usable cores by
  conftest): a port `VolumeServer(device="cpu")` with 3 workers, started
  in a fresh interpreter that imports only the port (the test process is
  never forked), serving POST then GET from the workers, DELETE-then-GET
  as 404, degraded GETs of an EC volume on disk equal to the JAX
  package's reads of the same files, a SIGKILLed worker respawned from
  the template and serving, drain fanned out to every worker, and no
  process of the group left after SIGTERM.

Every comparison is exact.
"""

import http.client
import json
import os
import select
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu.rpc import http_rpc as j_http
from seaweedfs_tpu.rpc import prefork as j_prefork
from seaweedfs_tpu.stats import metrics as j_stats
from seaweedfs_tpu.storage.erasure_coding import ec_volume as j_ecv
from seaweedfs_tpu_torch.rpc import http_rpc as t_http
from seaweedfs_tpu_torch.rpc import prefork as t_prefork
from seaweedfs_tpu_torch.stats import metrics as t_stats

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (j_prefork, j_http, j_stats),
        "torch": (t_prefork, t_http, t_stats)}


# -- in-process cases, both packages ---------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_worker_count_parsing(monkeypatch, pkg):
    prefork = PKGS[pkg][0]
    monkeypatch.delenv("WEED_HTTP_WORKERS", raising=False)
    got = [prefork.worker_count()]
    for raw in ("4", "0", "not-a-number", "-3"):
        monkeypatch.setenv("WEED_HTTP_WORKERS", raw)
        got.append(prefork.worker_count())
    assert got == [1, 4, 1, 1, 1]
    assert prefork.reuseport_available() == hasattr(socket, "SO_REUSEPORT")
    assert prefork.fork_available() == hasattr(os, "fork")
    assert prefork.role() == "solo" and prefork.worker_id() == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_port_zero_server_never_preforks(monkeypatch, pkg):
    http = PKGS[pkg][1]
    monkeypatch.setenv("WEED_HTTP_WORKERS", "4")
    s = http.RpcServer("127.0.0.1", 0, service_name="prefork-t")
    try:
        assert s._prefork_workers == 1
        assert s.fanout_prefixes == set() and s.parent_prefixes == set()
    finally:
        s.httpd.server_close()


class _FakeConn:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def _pool_state(pool):
    return (pool.max_idle, pool.idle_ttl,
            {a: len(v) for a, v in pool._idle.items()})


@pytest.mark.parametrize("workers,env", [(4, None), (16, None), (1, None),
                                         (3, "30"), (5, "7")])
def test_pool_split_like_jax(monkeypatch, workers, env):
    """configure_for_prefork gives each worker the same share of the idle
    budget and trims the same excess, in both packages."""
    if env is None:
        monkeypatch.delenv("WEED_RPC_MAX_IDLE", raising=False)
    else:
        monkeypatch.setenv("WEED_RPC_MAX_IDLE", env)
    states, closed = [], []
    for http in (j_http, t_http):
        pool = http._ConnPool()
        conns = [_FakeConn() for _ in range(12)]
        pool._idle = {"a:1": [(c, 0.0) for c in conns[:9]],
                      "b:2": [(c, 0.0) for c in conns[9:]]}
        pool.configure_for_prefork(workers)
        states.append(_pool_state(pool))
        closed.append([c.closed for c in conns])
    assert states[0] == states[1]
    assert closed[0] == closed[1]


def test_reinit_after_fork_forgets_without_closing_like_jax():
    got = []
    for http in (j_http, t_http):
        pool = http._ConnPool()
        conn = _FakeConn()
        pool._idle = {"a:1": [(conn, 0.0)]}
        old_lock = pool._lock
        pool.reinit_after_fork()
        got.append((pool._idle, conn.closed, pool._lock is old_lock,
                    pool._last_sweep))
    assert got[0] == got[1] == ({}, False, False, 0.0)


@pytest.mark.parametrize("parts", [
    [("0", '# HELP m_total things\n# TYPE m_total counter\n'
           'm_total{service="volume"} 1\nplain_gauge 5\n'),
     ("1", '# HELP m_total things\n# TYPE m_total counter\n'
           'm_total{service="volume"} 2\n')],
    [("0", '# HELP h_seconds lat\n# TYPE h_seconds histogram\n'
           'h_seconds_bucket{le="0.1"} 3\nh_seconds_bucket{le="+Inf"} 4\n'
           'h_seconds_sum 0.5\nh_seconds_count 4\n'),
     ("2", '# HELP h_seconds lat\n# TYPE h_seconds histogram\n'
           'h_seconds_bucket{le="0.1"} 1\nh_seconds_bucket{le="+Inf"} 1\n'
           'h_seconds_sum 0.01\nh_seconds_count 1\n'),
     ("3", "")],
])
def test_merge_expositions_like_jax(parts):
    merged = t_stats.merge_expositions(parts)
    assert merged == j_stats.merge_expositions(parts)
    assert merged.count("# TYPE") == len({
        line.split()[2] for _, text in parts for line in text.splitlines()
        if line.startswith("# TYPE")})


# -- multi-process cases ------------------------------------------------------

# The server of the multiproc cases, run in a fresh interpreter: it
# imports only the port (asserted), adds a /debug/ route that reports this
# process's worker id, pid, reads and recover stats, and stops on SIGTERM.
SERVER = r"""
import json, os, signal, sys, threading

a = json.loads(sys.argv[1])
sys.path.insert(0, a["repo"])
from seaweedfs_tpu_torch.rpc import prefork
from seaweedfs_tpu_torch.storage.erasure_coding import recover
from seaweedfs_tpu_torch.volume_server.server import VolumeServer

bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
assert not bad, bad
vs = VolumeServer([a["dir"]], a["master"], port=a["port"], device="cpu",
                  pulse_seconds=3600)


def whoami(req):
    return {"wid": prefork.worker_id(), "pid": os.getpid(),
            "role": prefork.role(), "reads": vs._req_counts["read"],
            "maint": any(t.name == "maint-worker" and t.is_alive()
                         for t in threading.enumerate()),
            "draining": vs.draining, "recover": recover.STATS.snapshot(),
            "template": (vs.server._prefork.template_pid
                         if vs.server._prefork is not None else 0)}


vs.server.add("GET", "/debug/whoami", whoami)
vs.start()
done = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: done.set())
print("READY", flush=True)
done.wait()
vs.stop()
"""


def _free_port() -> int:
    # below 45536 so the TCP fast path's port + 20000 convention fits
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port < 45536:
            return port


def _dead_master() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


class _Fleet:
    """A port VolumeServer with `workers` processes in a fresh
    interpreter; the registry under `reg`."""

    def __init__(self, tmp_path, data_dir, workers=3, maint_worker=False):
        self.reg = tmp_path / "registry"
        self.reg.mkdir()
        self.port = _free_port()
        self.addr = f"127.0.0.1:{self.port}"
        env = dict(os.environ, WEED_HTTP_WORKERS=str(workers),
                   WEED_PREFORK_DIR=str(self.reg), WEED_MAINT="0",
                   WEED_MAINT_WORKER="1" if maint_worker else "0",
                   WEED_MAINT_POLL="0.2")
        env.pop("PYTHONPATH", None)
        self.log = open(tmp_path / "server.log", "w")
        spec = {"repo": REPO_ROOT, "dir": str(data_dir),
                "master": _dead_master(), "port": self.port}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SERVER, json.dumps(spec)], env=env,
            cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=self.log,
            text=True)
        ready, _, _ = select.select([self.proc.stdout], [], [], 120)
        line = self.proc.stdout.readline() if ready else ""
        if line.strip() != "READY":
            self.proc.kill()
            self.proc.wait(timeout=30)
        assert line.strip() == "READY", self._tail()
        self.wait_registered(workers)

    def _tail(self) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-3000:]

    def group_dir(self):
        groups = [g for g in os.listdir(self.reg) if g.startswith("volume-")]
        assert len(groups) == 1, groups
        return self.reg / groups[0]

    def entries(self) -> dict:
        out = {}
        g = self.group_dir()
        for name in os.listdir(g):
            if name.startswith("w") and name.endswith(".json"):
                try:
                    with open(g / name) as f:
                        e = json.load(f)
                except ValueError:
                    continue  # mid-write
                out[e["wid"]] = e
        return out

    def wait_registered(self, n, timeout=60.0, exclude_pid=None):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ent = self.entries()
            if len(ent) >= n and all(
                    e["pid"] != exclude_pid for e in ent.values()):
                return ent
            assert self.proc.poll() is None, self._tail()
            time.sleep(0.1)
        raise AssertionError(f"workers never registered: {self.entries()}")

    def whoami_all(self) -> dict:
        return {wid: t_http.call(e["sideband"], "/debug/whoami")
                for wid, e in self.entries().items()}

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.proc.stdout.close()
        self.log.close()


def _fresh_get(addr: str, path: str, method="GET", body=None):
    """One request on a fresh connection (SO_REUSEPORT spreads new
    connections over the workers by their 4-tuple)."""
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            state = [ln for ln in f if ln.startswith("State:")][0]
    except (OSError, IndexError):
        return False
    return "Z" not in state.split()[1]


def _ec_volume_on_disk(tmp_path, vid=1, lost=(0, 5, 11, 13)):
    """A port Store writes seeded needles into volume `vid`, encodes it
    (device="cpu"), drops the .dat/.idx and four shards, as a restarted
    volume server would find it; returns {nid: (cookie, data)}."""
    from seaweedfs_tpu_torch.storage import types as t_types
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.default_rng(8)
    needles = {}
    store = Store([str(data_dir)], ec_encoder_backend="torch",
                  device="cpu")
    try:
        store.add_volume(vid)
        for nid in range(1, 41):
            data = rng.bytes(int(rng.integers(1, 300_000)))
            cookie = int(rng.integers(1, 1 << 32))
            n = Needle.create(data)
            n.id, n.cookie = nid, cookie
            store.write_needle(vid, n)
            needles[nid] = (cookie, data)
        store.add_volume(vid + 1)  # empty: the PUT target of the fleet
        store.ec_generate(vid)
        store.delete_volume(vid)
    finally:
        store.close()
    for sid in lost:
        os.remove(data_dir / (str(vid) + to_ext(sid)))
    assert t_types.parse_file_id("1,0100000001")  # fid format in use
    return data_dir, needles


@pytest.fixture
def fleet(tmp_path):
    data_dir, needles = _ec_volume_on_disk(tmp_path)
    f = _Fleet(tmp_path, data_dir)
    f.data_dir, f.needles = data_dir, needles
    try:
        yield f
    finally:
        f.stop()


@pytest.mark.multiproc
def test_writes_reach_workers_through_the_idx_tail(fleet):
    """POSTs are forwarded to the parent; GETs on fresh connections land
    on every worker, which serves them from its .idx tail; after a DELETE
    every process answers 404."""
    rng = np.random.default_rng(9)
    objs = {}
    for nid in range(1, 31):
        data = rng.bytes(int(rng.integers(1, 50_000)))
        fid = f"2,{nid:x}{0x1234abcd:08x}"
        status, body = _fresh_get(fleet.addr, "/" + fid, "POST", data)
        assert status == 201 or status == 200, body
        objs[fid] = data
    for _ in range(4):
        for fid, data in objs.items():
            assert _fresh_get(fleet.addr, "/" + fid) == (200, data)
    reads = {wid: w["reads"] for wid, w in fleet.whoami_all().items()}
    assert sum(1 for wid, r in reads.items() if wid > 0 and r > 0) >= 2, \
        reads
    gone = sorted(objs)[:10]
    for fid in gone:
        assert _fresh_get(fleet.addr, "/" + fid, "DELETE")[0] in (200, 202)
    for fid in gone:
        # straight to each worker's sideband: every process must agree
        for e in fleet.entries().values():
            assert _fresh_get(e["sideband"], "/" + fid)[0] == 404, (
                e["wid"], fid)
    for fid in sorted(objs)[10:]:
        for e in fleet.entries().values():
            assert _fresh_get(e["sideband"], "/" + fid) == (200, objs[fid])


@pytest.mark.multiproc
def test_degraded_reads_equal_jax_respawn_and_teardown(fleet):
    """Every worker serves degraded GETs of the EC volume on disk equal to
    the JAX package's reads of the same files; a SIGKILLed worker comes
    back from the template (a new pid in its registry entry) and serves
    them too; SIGTERM leaves no process of the group behind."""
    jev = j_ecv.EcVolume(str(fleet.data_dir), "", 1)
    for sid in (1, 2, 3, 4, 6, 7, 8, 9, 10, 12):
        jev.add_shard(j_ecv.EcVolumeShard(str(fleet.data_dir), "", 1, sid))
    try:
        expect = {nid: jev.read_needle(nid, cookie).data
                  for nid, (cookie, _) in fleet.needles.items()}
    finally:
        jev.close()
    assert expect == {nid: d for nid, (_, d) in fleet.needles.items()}

    def read_all(addr):
        for nid, (cookie, _) in fleet.needles.items():
            got = _fresh_get(addr, f"/1,{nid:x}{cookie:08x}")
            assert got == (200, expect[nid]), (addr, nid, got[0])

    ent = fleet.entries()
    assert ent[0]["pid"] == fleet.proc.pid
    for e in ent.values():
        read_all(e["sideband"])
    info = fleet.whoami_all()
    assert {w["role"] for wid, w in info.items() if wid} == {"worker"}
    assert all(w["recover"]["spans"] > 0 for w in info.values()), info
    template = info[0]["template"]
    assert _alive(template) and template not in {
        e["pid"] for e in ent.values()}

    # the shared QoS segment of the group (qos/shm.py's parent path), and
    # /debug/qos merged over the workers
    with open(fleet.group_dir() / "qos_shm.json") as f:
        shm_name = json.load(f)["name"]
    assert os.path.exists("/dev/shm/" + shm_name.lstrip("/"))
    qos = t_http.call(fleet.addr, "/debug/qos")
    assert sorted(qos["workers"]) == ["0", "1", "2"]

    victim = ent[2]["pid"]
    os.kill(victim, signal.SIGKILL)
    ent = fleet.wait_registered(3, exclude_pid=victim)
    assert ent[2]["pid"] != victim
    read_all(ent[2]["sideband"])
    info2 = t_http.call(ent[2]["sideband"], "/debug/whoami")
    assert info2["pid"] == ent[2]["pid"] and info2["recover"]["spans"] > 0
    metrics = t_http.call(fleet.addr, "/metrics", parse=False).decode()
    assert "SeaweedFS_gateway_worker_respawns_total" in metrics

    pids = [e["pid"] for e in ent.values()] + [template]
    fleet.stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.1)
    assert not [p for p in pids if _alive(p)]
    assert os.listdir(fleet.reg) == []
    assert not os.path.exists("/dev/shm/" + shm_name.lstrip("/"))


@pytest.mark.multiproc
def test_drain_fans_out_from_a_worker(fleet):
    """/admin/drain delivered to worker 1's sideband reaches every process
    of the fleet."""
    ent = fleet.entries()
    resp = t_http.call(ent[1]["sideband"], "/admin/drain",
                       payload={"draining": True}, method="POST")
    assert resp.get("draining") is True, resp
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        states = {wid: w["draining"] for wid, w in fleet.whoami_all().items()}
        if all(states.values()):
            break
        time.sleep(0.1)
    assert states == {0: True, 1: True, 2: True}, states


# -- the fork rule: no CUDA runtime call before a process may fork ----------

def test_store_over_ec_volume_makes_no_cuda_call(tmp_path, monkeypatch):
    """Building a Store and a VolumeServer (device left to the card, HBM
    read-cache tier on) over a directory holding an EC volume with four
    lost shards makes no CUDA runtime call: the card is found through
    NVML (device_count) and the context is left to the first dispatch, in
    the process that dispatches.  Here NVML is made to report one card
    and every call that would initialize CUDA records itself."""
    import torch

    from seaweedfs_tpu_torch.cache.hbm import HbmTier
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    data_dir, _ = _ec_volume_on_disk(tmp_path)
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

    store = Store([str(data_dir)], ec_encoder_backend="cuda")
    try:
        ev = store.find_ec_volume(1)
        assert ev is not None and ev.device == torch.device("cuda", 0)
        assert HbmTier(1 << 20).device == torch.device("cuda", 0)
    finally:
        store.close()
    vs = VolumeServer([str(data_dir)], _dead_master(), port=0,
                      ec_encoder_backend="cuda")
    try:
        assert vs.read_cache.hbm is not None
        assert vs.store.find_ec_volume(1).device == torch.device("cuda", 0)
    finally:
        vs.server.httpd.server_close()
        vs.read_cache.close()
        vs.store.close()
    assert calls == []
