"""The port's shell, curator and maintenance worker against the JAX
package's, end to end on the CPU.

One scripted heal runs in three clusters of a master and three volume
servers: all JAX (master, servers, shell), all port (servers on
device="cpu": K2's and K1's plain versions), and a port master and
shell driving JAX volume servers (whose JAX workers lease the port
curator's jobs).  The script: seeded needles POSTed into volume 1 under
pinned clocks, the shell's `ec.encode`, `.ec00 .ec05 .ec11 .ec13` lost,
every needle read through `/ec/lookup` while the curator's `ec.rebuild`
is pending, a worker leasing and running it, a `deep.scrub` forced
through `/maintenance/run` (clean), one flipped byte of `.ec12`, the
scrub finding it and the `ec.rebuild` that follows repairing it.  The
shard files, `.ecx` and `.vif` after encode, rebuild and repair are
byte-identical across the three, as are the job histories and scrub
verdicts.  A scale job the port's worker cannot run fails with the JAX
worker's error.

The filer-backed commands (fs.*, remote.*, s3.*, `volume.fsck`'s
cross-check, `ec.encode` reading a collection's `ec_code` rule) run the
same script against a JAX and a port cluster with a filer, each through
its own package's shell, and answer alike (fids renamed, filer clocks
pinned); without a reachable filer the rule reads as "".
Tolerance: equality throughout.  The clusters wait on deadlines.
"""

import json
import os
import time

import numpy as np
import pytest

from test_torch_filer import canon, cluster, pin_clocks
from test_torch_volume_server import _PinnedTime, _reset_process_state

from seaweedfs_tpu import notification as j_notify
from seaweedfs_tpu.master import server as j_master
from seaweedfs_tpu.shell import commands as j_sh
from seaweedfs_tpu.shell import commands_fs as j_fs
from seaweedfs_tpu.shell import commands_remote as j_rem
from seaweedfs_tpu.shell import commands_volume as j_vol_sh
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.volume_server import server as j_server
from seaweedfs_tpu_torch import notification as t_notify
from seaweedfs_tpu_torch.master import server as t_master
from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call
from seaweedfs_tpu_torch.shell import commands as t_sh
from seaweedfs_tpu_torch.shell import commands_fs as t_fs
from seaweedfs_tpu_torch.shell import commands_remote as t_rem
from seaweedfs_tpu_torch.shell import commands_maintenance as t_maint_sh
from seaweedfs_tpu_torch.shell import commands_volume as t_vol_sh
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.volume_server import server as t_server

LOST = [0, 5, 11, 13]
VID = 1

CLUSTERS = {
    # name: (master module, server module, volume module, shell, kwargs)
    "jax": (j_master, j_server, j_volume, j_sh,
            {"ec_encoder_backend": "tpu"}),
    "port": (t_master, t_server, t_volume, t_sh,
             {"ec_encoder_backend": "cuda", "device": "cpu"}),
    "port-master-jax-servers": (t_master, j_server, j_volume, t_sh,
                                {"ec_encoder_backend": "tpu"}),
}


def _needles(seed: int = 21, count: int = 48):
    rng = np.random.default_rng(seed)
    return [(i, 0x20000000 + i * 104729,
             rng.bytes(int(np.exp(rng.uniform(np.log(200),
                                              np.log(60 << 10))))))
            for i in range(1, count + 1)]


def _ec_files(servers) -> dict:
    """Every EC file of volume 1 on any server: name -> bytes (copies on
    several holders must agree)."""
    out = {}
    for vs in servers:
        for loc in vs.store.locations:
            for name in sorted(os.listdir(loc.directory)):
                if not name.startswith(f"{VID}.") or name.endswith(
                        (".dat", ".idx", ".tmp")):
                    continue
                with open(os.path.join(loc.directory, name), "rb") as f:
                    data = f.read()
                assert out.setdefault(name, data) == data, name
    return out


def _holder(servers, sid):
    for vs in servers:
        for loc in vs.store.locations:
            p = os.path.join(loc.directory, f"{VID}.ec{sid:02d}")
            if os.path.exists(p):
                return vs, p
    return None, None


def _jobs_done(master) -> list:
    return [(h["type"], h["volume"], h["outcome"], h["attempts"])
            for h in master.curator.queue.history]


def _drain(master, servers, rounds=6):
    """Let the servers' workers lease until the queue is empty (each
    poll leases at most one job; deep.scrub goes to holders only)."""
    for _ in range(rounds):
        if not master.curator.queue.jobs():
            return
        for vs in servers:
            vs.maintenance_worker.poll_once()
    assert master.curator.queue.jobs() == []


def _heal(root, name, mp) -> dict:
    master_mod, server_mod, volume_mod, sh, kw = CLUSTERS[name]
    mp.setattr(server_mod, "time", _PinnedTime(pin_time=True))
    mp.setattr(volume_mod, "time", _PinnedTime(pin_time=False))
    d = root / name
    (d / "m").mkdir(parents=True)
    master = master_mod.MasterServer(port=0, volume_size_limit_mb=64,
                                     pulse_seconds=0.2,
                                     raft_dir=str(d / "m"))
    master.start()
    servers = []
    out = {}
    try:
        for i in range(3):
            (d / f"vs{i}").mkdir()
            vs = server_mod.VolumeServer(
                [str(d / f"vs{i}")], master.address, port=0,
                rack=f"rack{i % 2}", pulse_seconds=0.2, **kw)
            vs.start()
            servers.append(vs)
        call(servers[0].address, "/admin/assign_volume", {"volume": VID})
        for vs in servers:
            vs.heartbeat_once()
        needles = _needles()
        fids = {nid: f"{VID},{nid:x}{cookie:08x}"
                for nid, cookie, _ in needles}
        for nid, _, body in needles:
            call(servers[0].address, f"/{fids[nid]}", raw=body,
                 method="POST")
        env = sh.CommandEnv(master.address)
        plan = sh.ec_encode(env, VID)
        assert sorted(s for ids in plan["allocation"].values()
                      for s in ids) == list(range(14))
        for vs in servers:
            vs.heartbeat_once()
        out["encoded"] = _ec_files(servers)
        assert len([n for n in out["encoded"] if ".ec" in n
                    and n[-2:].isdigit()]) == 14

        # the loss: four shards deleted on their holders
        for sid in LOST:
            vs, _ = _holder(servers, sid)
            call(vs.address, "/admin/ec/delete_shards",
                 {"volume": VID, "shard_ids": [sid]})
        for vs in servers:
            vs.heartbeat_once()
        master.curator.tick()
        queued = [(j["type"], j["volume"], j["params"])
                  for j in master.curator.queue.jobs()]
        assert queued == [("ec.rebuild", VID, {"missing": LOST})]
        out["queued"] = queued
        # every needle reads while the rebuild is pending (degraded)
        for nid, _, body in needles:
            ec = call(master.address, f"/ec/lookup?volumeId={VID}")
            reader = ec["shard_id_locations"][0]["locations"][0]["url"]
            assert call(reader, f"/{fids[nid]}", parse=False) == body
        _drain(master, servers)
        for vs in servers:
            vs.heartbeat_once()
        out["rebuilt"] = _ec_files(servers)
        assert out["rebuilt"] == out["encoded"]

        # a forced deep scrub runs clean, then finds a flipped byte
        scrub = []
        for flip in (False, True):
            if flip:
                _, path = _holder(servers, 12)
                with open(path, "r+b") as f:
                    f.seek(777)
                    b = f.read(1)
                    f.seek(777)
                    f.write(bytes([b[0] ^ 0x5A]))
            call(master.address, "/maintenance/run",
                 {"type": "deep.scrub", "volume": VID})
            scrubs = len(_jobs_done(master))
            # until a holder has run the scrub; the server that served
            # the outage's degraded reads polls last: its cached shard
            # map of the outage sends a JAX worker's scrub through R5,
            # which test_scrub_after_degraded_reads_and_a_rebuild pins
            # (the shell places shards at random, so who that server
            # is varies from run to run)
            for vs in sorted(servers, key=lambda v: v.address == reader):
                if len(_jobs_done(master)) == scrubs:
                    vs.maintenance_worker.poll_once()
            scrub.append([(j["type"], j["params"])
                          for j in master.curator.queue.jobs()])
            _drain(master, servers)
        out["scrub"] = scrub
        for vs in servers:
            vs.heartbeat_once()
        out["repaired"] = _ec_files(servers)
        assert out["repaired"] == out["encoded"]
        clean = sh.ec_scrub(env, VID)
        assert clean[0]["clean_shards"] == 14 and not clean[0]["corrupt"]
        out["history"] = _jobs_done(master)
        for nid, _, body in needles:
            ec = call(master.address, f"/ec/lookup?volumeId={VID}")
            url = ec["shard_id_locations"][-1]["locations"][0]["url"]
            assert call(url, f"/{fids[nid]}", parse=False) == body
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
    return out


@pytest.fixture(scope="module")
def heals(tmp_path_factory):
    root = tmp_path_factory.mktemp("heal")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEED_MAINT_WORKER", "0")  # workers polled by the test
        mp.setenv("WEED_MAINT_INTERVAL", "3600")  # curator ticked by it
        mp.setenv("WEED_MAINT_COOLDOWN", "0")
        mp.setenv("WEED_TRACE_SAMPLE", "0")
        for name in CLUSTERS:
            _reset_process_state()
            out[name] = _heal(root, name, mp)
    return out


@pytest.mark.parametrize("stage", ["encoded", "rebuilt", "repaired"])
@pytest.mark.parametrize("cluster", ["port", "port-master-jax-servers"])
def test_heal_files_byte_identical(heals, cluster, stage):
    got, want = heals[cluster][stage], heals["jax"][stage]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert {f"{VID}.vif", f"{VID}.ecx"} <= set(got)


@pytest.mark.parametrize("cluster", ["port", "port-master-jax-servers"])
def test_heal_jobs_and_verdicts_equal(heals, cluster):
    got, want = heals[cluster], heals["jax"]
    assert got["queued"] == want["queued"]
    assert got["scrub"] == want["scrub"]
    assert got["history"] == want["history"]
    # clean scrub, then the flipped byte of .ec12 turned into a rebuild
    assert want["scrub"][0] == []
    assert want["scrub"][1] == [("ec.rebuild", {
        "from": "deep.scrub", "corrupt": [12], "missing": []})]
    assert [h[:3] for h in want["history"]] == [
        ("ec.rebuild", VID, "ok"), ("deep.scrub", VID, "ok"),
        ("deep.scrub", VID, "ok"), ("ec.rebuild", VID, "ok")]


# -- scale jobs that cannot run, and what the shell does not do yet ---------------


@pytest.fixture
def port_cluster(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    monkeypatch.setenv("WEED_MAINT_ATTEMPTS", "1")
    (tmp_path / "m").mkdir()
    master = t_master.MasterServer(port=0, volume_size_limit_mb=64,
                                   pulse_seconds=0.2,
                                   raft_dir=str(tmp_path / "m"))
    master.start()
    (tmp_path / "vs").mkdir()
    vs = t_server.VolumeServer([str(tmp_path / "vs")], master.address,
                               port=0, pulse_seconds=0.2, device="cpu")
    vs.start()
    vs.heartbeat_once()
    yield master, vs
    vs.stop()
    master.stop()


@pytest.mark.parametrize("job_type", ["scale.up", "scale.drain"])
def test_scale_jobs_fail_with_the_named_error(port_cluster, job_type):
    """A scale job queued through the shell that the worker cannot run
    (a refusing spawn seam, a drain naming no server) fails on the
    master's queue with the JAX worker's error."""
    master, vs = port_cluster

    def refuse(job):
        raise RuntimeError("no room for another volume server")

    vs.spawn_volume_server = refuse
    env = t_sh.CommandEnv(master.address)
    t_maint_sh.maintenance_run(env, job_type, params={})
    assert vs.maintenance_worker.poll_once() == 1
    assert vs.maintenance_worker.failed == 1
    (done,) = master.curator.queue.history
    assert done["type"] == job_type and done["outcome"] == "failed"
    assert done["last_error"] == (
        "RuntimeError: no room for another volume server"
        if job_type == "scale.up" else
        "ValueError: scale.drain needs params.server")
    status = t_maint_sh.maintenance_status(env)
    assert status["queue"]["finished"] == 1


def test_filer_paths_raise_until_the_filer_comes(port_cluster):
    """Without a filer, or with a registered one that is gone, the
    collection's `ec_code` rule reads as "" (as in the reference), and
    `volume.fsck`'s cross-check against a dead filer raises the RPC
    error; without a filer address fsck reports the stored needles."""
    master, vs = port_cluster
    env = t_sh.CommandEnv(master.address)
    assert t_sh._collection_ec_code(env, "pics") == ""  # no filer
    call(master.address, "/cluster/register",
         {"type": "filer", "address": "127.0.0.1:1"})
    assert t_sh._collection_ec_code(env, "pics") == ""  # filer gone
    report = t_vol_sh.volume_fsck(env)
    assert report == {"volumes": 0, "stored_needles": 0}
    with pytest.raises(RpcError):
        t_vol_sh.volume_fsck(env, filer_address="127.0.0.1:1")
    assert t_sh.volume_list(env) == call(master.address, "/dir/status")
    assert t_vol_sh.collection_list(env) == []


@pytest.mark.parametrize("cluster", ["jax", "port"])
def test_scrub_after_degraded_reads_and_a_rebuild(tmp_path, monkeypatch,
                                                  cluster):
    """R5: servers that served degraded reads keep the outage's shard map
    in their location cache (the 7-minute tier for an incomplete map).
    After the rebuild, a deep scrub leased by one that did not rebuild
    cannot reach the rebuilt shards through that map: the JAX worker's
    scrub reports them unreadable and every other shard corrupt, and the
    curator queues a needless ec.rebuild; the port's worker reads the
    master's layout of now and scrubs clean."""
    master_mod, server_mod, _, sh, kw = CLUSTERS[cluster]
    for k, v in (("WEED_MAINT_WORKER", "0"), ("WEED_MAINT_INTERVAL", "3600"),
                 ("WEED_MAINT_COOLDOWN", "0"), ("WEED_TRACE_SAMPLE", "0")):
        monkeypatch.setenv(k, v)
    _reset_process_state()
    (tmp_path / "m").mkdir()
    master = master_mod.MasterServer(port=0, volume_size_limit_mb=64,
                                     pulse_seconds=0.2,
                                     raft_dir=str(tmp_path / "m"))
    master.start()
    servers = []
    try:
        for i in range(3):
            (tmp_path / f"vs{i}").mkdir()
            vs = server_mod.VolumeServer(
                [str(tmp_path / f"vs{i}")], master.address, port=0,
                rack=f"rack{i % 2}", pulse_seconds=0.2, **kw)
            vs.start()
            servers.append(vs)
        call(servers[0].address, "/admin/assign_volume", {"volume": VID})
        for vs in servers:
            vs.heartbeat_once()
        needles = _needles(seed=23, count=24)
        for nid, cookie, body in needles:
            call(servers[0].address, f"/{VID},{nid:x}{cookie:08x}",
                 raw=body, method="POST")
        env = sh.CommandEnv(master.address)
        sh.ec_encode(env, VID)
        for sid in LOST:
            vs, _ = _holder(servers, sid)
            call(vs.address, "/admin/ec/delete_shards",
                 {"volume": VID, "shard_ids": [sid]})
        for vs in servers:
            vs.heartbeat_once()
        for vs in servers:  # degraded reads from every holder
            for nid, cookie, body in needles:
                assert call(vs.address, f"/{VID},{nid:x}{cookie:08x}",
                            parse=False) == body
        master.curator.tick()
        _drain(master, servers)
        for vs in servers:
            vs.heartbeat_once()
        rebuilder, _ = _holder(servers, LOST[0])
        scrubber = next(vs for vs in servers if vs is not rebuilder)
        call(master.address, "/maintenance/run",
             {"type": "deep.scrub", "volume": VID})
        assert scrubber.maintenance_worker.poll_once() == 1
        assert scrubber.maintenance_worker.failed == 0
        assert master.curator.queue.history[-1]["type"] == "deep.scrub"
        queued = master.curator.queue.jobs()
        if cluster == "jax":
            (job,) = queued
            assert job["type"] == "ec.rebuild"
            assert job["params"]["from"] == "deep.scrub"
            assert job["params"]["corrupt"]
        else:
            assert queued == []
        # the shards themselves are sound either way
        assert sh.ec_scrub(env, VID)[0]["clean_shards"] == 14
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


# -- the filer-backed commands -----------------------------------------------------

SHELLS = {"jax": (j_sh, j_fs, j_rem, j_vol_sh, j_notify),
          "port": (t_sh, t_fs, t_rem, t_vol_sh, t_notify)}


def _seed(addr):
    for path, body in [("/docs/a.txt", b"aaa"), ("/docs/sub/b.txt", b"bbbb"),
                       ("/top.bin", b"t" * 3000)]:
        call(addr, path, raw=body, method="POST")


def _fs_script(pkg, env, filer, tmp, mp):
    sh, fs, _, _, notify = SHELLS[pkg]
    out = {}
    _seed(filer.address)
    out["ls"] = fs.fs_ls(env, "/")
    out["ls_l"] = fs.fs_ls(env, "/docs", long_format=True)
    out["du"] = fs.fs_du(env, "/")
    out["tree"] = fs.fs_tree(env, "/")
    out["cat"] = fs.fs_cat(env, "/docs/a.txt")
    out["meta_cat"] = fs.fs_meta_cat(env, "/top.bin")
    dump = str(tmp / f"{pkg}.jsonl")
    out["saved"] = fs.fs_meta_save(env, "/", output=dump)
    with open(dump) as f:
        out["dump"] = [json.loads(line) for line in f]
    call(filer.address, "/top.bin?skipChunkDelete=true", method="DELETE")
    with pytest.raises(Exception):
        fs.fs_cat(env, "/top.bin")
    out["loaded"] = fs.fs_meta_load(env, dump)
    out["restored"] = fs.fs_cat(env, "/top.bin")
    out["mkdir"] = fs.fs_mkdir(env, "/newdir")
    out["mv"] = fs.fs_mv(env, "/docs/a.txt", "/newdir/a.txt")
    out["moved"] = fs.fs_cat(env, "/newdir/a.txt")
    fs.fs_rm(env, "/newdir", recursive=True)
    out["after_rm"] = fs.fs_ls(env, "/")
    out["pwd"] = [fs.fs_pwd(env), fs.fs_cd(env, "/docs"), fs.fs_pwd(env),
                  fs.resolve_path(env, "sub/b.txt"),
                  fs.resolve_path(env, "../docs/./sub"),
                  fs.fs_cd(env, "sub")]
    with pytest.raises(Exception) as e:
        fs.fs_cd(env, "/nope")
    out["cd_nope"] = e.value.status
    fs.fs_cd(env, "/")
    sent = []

    class FakeQueue:
        name = "fake"

        def send(self, key, event):
            sent.append((key, event))

        def close(self):
            pass

    mp.setattr(notify, "load_notification_queue", lambda conf: FakeQueue())
    mp.setattr(fs, "time", _PinnedTime(pin_time=True))
    out["notify"] = (fs.fs_meta_notify(env, "/docs"), sent)
    mp.setattr(fs, "time", time)  # s3.clean.uploads ages by the clock
    out["configure"] = [
        fs.fs_configure(env, "/protected/", read_only=True),
        fs.fs_configure(env, "/warm/", collection="warm", ec_code="cauchy"),
    ]
    filer._conf_cache = (0.0, filer._conf_cache[1])  # the 1 s refresh
    with pytest.raises(RpcError) as e:
        call(filer.address, "/protected/x", raw=b"no", method="POST")
    out["read_only"] = e.value.status
    with pytest.raises(Exception) as e:
        fs.fs_configure(env, "/bad/", ec_code="no-such-family")
    out["bad_family"] = type(e.value).__name__
    out["ec_code"] = [sh._collection_ec_code(env, c)
                      for c in ("warm", "other")]
    fs.fs_configure(env, "/protected/", delete=True)
    # s3.* over the same filer
    out["buckets"] = [fs.s3_bucket_list(env), fs.s3_bucket_create(env, "media"),
                      fs.s3_bucket_create(env, "qb"), fs.s3_bucket_list(env)]
    call(filer.address, "/buckets/media/.uploads/u1/", raw=b"",
         method="POST")
    out["clean"] = fs.s3_clean_uploads(env, timeout_seconds=0.0)
    fs.s3_bucket_delete(env, "media")
    out["quota"] = [fs.s3_bucket_quota(env, "qb", "set", 50),
                    fs.fs_configure(env, "/buckets/qb/", ttl="3d"),
                    fs.s3_bucket_quota(env, "qb", "get"),
                    fs.s3_bucket_quota_enforce(env)]
    out["identity"] = [fs.s3_configure(env, "alice", "AKID", "SECRET",
                                       actions=["Read", "Write"]),
                       call(filer.address, "/etc/iam/identity.json")]
    out["breaker"] = [fs.s3_circuitbreaker(env, actions="Read:Count",
                                           values="100", buckets="qb"),
                      fs.s3_circuitbreaker(env)]
    out["final"] = fs.fs_meta_save(env, "/")
    return out


def test_fs_and_s3_commands_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    out = {}
    for pkg in SHELLS:
        pin_clocks(monkeypatch, pkg)
        with cluster(pkg, tmp_path / pkg, chunk_size=512) as (m, _, filer):
            env = SHELLS[pkg][0].CommandEnv(m.address,
                                            filer_address=filer.address)
            out[pkg] = canon(_fs_script(pkg, env, filer, tmp_path,
                                        monkeypatch))
    for key in out["jax"]:
        assert out["port"][key] == out["jax"][key], key
    got = out["port"]
    assert {e["name"] for e in got["ls"]} >= {"docs", "top.bin"}
    assert got["du"]["files"] == 3 and got["du"]["bytes"] == 3007
    assert got["restored"] == b"t" * 3000 and got["loaded"] == len(
        got["saved"])
    assert got["notify"][0]["notified"] == 2  # /docs/sub and its file
    assert got["read_only"] == 403 and got["ec_code"] == ["cauchy", ""]
    assert got["clean"] == ["/buckets/media/.uploads/u1"]
    assert got["quota"][2]["quota_mb"] == 50


def _remote_script(pkg, env, filer, remote_tree):
    _, _, rem, _, _ = SHELLS[pkg]
    out = {"configure": rem.remote_configure(env, name="prod", type="local",
                                             directory=remote_tree)}
    out["list"] = rem.remote_configure(env)
    out["mount"] = rem.remote_mount(env, "/mnt/prod", "prod/bkt")
    out["mappings"] = rem.remote_mount(env)
    meta = lambda: call(filer.address,  # noqa: E731
                        "/mnt/prod/photos/?metadata=true")
    read = lambda p: call(filer.address, p, parse=False)  # noqa: E731
    out["meta"] = meta()
    out["read"] = [read("/mnt/prod/photos/cat.jpg"),
                   read("/mnt/prod/readme.md")]
    out["cache"] = [rem.remote_cache(env, "/mnt/prod"), meta(),
                    read("/mnt/prod/photos/cat.jpg")]
    out["uncache"] = [rem.remote_uncache(env, "/mnt/prod"), meta(),
                      read("/mnt/prod/photos/cat.jpg")]
    with open(os.path.join(remote_tree, "bkt", "new.txt"), "wb") as f:
        f.write(b"fresh")
    os.utime(os.path.join(remote_tree, "bkt", "new.txt"),
             (1_600_000_000, 1_600_000_000))
    out["sync"] = [rem.remote_meta_sync(env, "/mnt/prod"),
                   read("/mnt/prod/new.txt")]
    out["buckets"] = rem.remote_mount_buckets(env, "prod/bkt2")
    out["unmount"] = [rem.remote_unmount(env, "/mnt/prod"),
                      rem.remote_mount(env)]
    with pytest.raises(RpcError) as e:
        read("/mnt/prod/readme.md")
    out["gone"] = e.value.status
    out["delete"] = [rem.remote_configure(env, name="prod", delete=True),
                     rem.remote_configure(env)]
    return out


def test_remote_commands_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    out = {}
    for pkg in SHELLS:
        pin_clocks(monkeypatch, pkg)
        root = tmp_path / f"remote-{pkg}"
        (root / "bkt" / "photos").mkdir(parents=True)
        (root / "bkt2").mkdir()
        (root / "bkt" / "photos" / "cat.jpg").write_bytes(b"meow" * 700)
        (root / "bkt" / "readme.md").write_bytes(b"# docs")
        (root / "bkt2" / "x.bin").write_bytes(b"x" * 10)
        for path in root.rglob("*"):
            os.utime(path, (1_600_000_000, 1_600_000_000))
        with cluster(pkg, tmp_path / pkg, chunk_size=512) as (m, _, filer):
            env = SHELLS[pkg][0].CommandEnv(m.address,
                                            filer_address=filer.address)
            got = _remote_script(pkg, env, filer, str(root))
            out[pkg] = canon(json.loads(json.dumps(
                got, default=lambda b: b.hex()).replace(str(root),
                                                        "<remote>")))
    for key in out["jax"]:
        assert out["port"][key] == out["jax"][key], key
    got = out["port"]
    assert got["mount"]["synced"] == 2 and got["cache"][0]["cached"] == 2
    assert got["read"] == [(b"meow" * 700).hex(), b"# docs".hex()]
    assert got["gone"] == 404


def test_ec_encode_reads_the_filers_rule_and_fsck_cross_checks(
        tmp_path, monkeypatch):
    """`fs.configure -ecCode cauchy` on a collection's prefix, files
    written through the filer, then the shell's `ec.encode` of the
    collection's volume: its `.vif` names `cauchy` in both packages (the
    filer found through the master's registry), and `volume.fsck`
    cross-checks the filer's chunks against the stored needles alike."""
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    bodies = [bytes([i]) * (3000 + 977 * i) for i in range(6)]
    out = {}
    for pkg in SHELLS:
        sh, fs, _, vol_sh, _ = SHELLS[pkg]
        with cluster(pkg, tmp_path / pkg, n_volumes=3,
                     chunk_size=2048) as (m, vss, filer):
            env = sh.CommandEnv(m.address)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and not call(
                    m.address, "/cluster/nodes?type=filer")["cluster_nodes"]:
                time.sleep(0.05)
            fs.fs_configure(env, "/warm/", collection="warm",
                            ec_code="cauchy")
            filer._conf_cache = (0.0, filer._conf_cache[1])
            for i, body in enumerate(bodies):
                call(filer.address, f"/warm/f{i}.bin", raw=body,
                     method="POST")
            call(filer.address, "/warm/f0.bin", method="DELETE")
            for vs in vss:
                vs.heartbeat_once()
            fsck = vol_sh.volume_fsck(env, filer_address=filer.address)
            vids = sorted({int(c["fid"].split(",")[0])
                           for e in fs.fs_meta_save(env, "/warm/")
                           for c in e.get("chunks", [])})
            sh.ec_encode(env, vids[0], collection="warm")
            vif = next(json.loads((p / f"warm_{vids[0]}.vif").read_text())
                       for p in (tmp_path / pkg).iterdir()
                       if (p / f"warm_{vids[0]}.vif").exists())
            reads = [call(filer.address, f"/warm/f{i}.bin", parse=False)
                     == bodies[i] for i in range(1, len(bodies))]
            out[pkg] = (sh._collection_ec_code(env, "warm"),
                        vif.get("code_family"), reads,
                        {k: v for k, v in fsck.items() if k != "orphaned"},
                        sum(fsck["orphaned"].values()))
    assert out["port"] == out["jax"]
    code, family, reads, fsck, orphaned = out["port"]
    assert code == family == "cauchy" and all(reads)
    assert fsck["missing_chunks"] == [] and fsck["referenced_needles"] > 0
    # the deleted file's two chunks stay in the volume until a vacuum
    assert orphaned == 2
