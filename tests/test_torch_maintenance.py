"""The port's maintenance control loop against the JAX package's.

- `JobQueue`: the same seeded sequence of enqueue, lease, renew,
  complete, fail and expire under one fake clock gives equal returns,
  equal `jobs()`, `stats()` and history, and a byte-identical journal;
  each package replays the other's journal to the same state.
- Detectors: the same topology (seeded heartbeats into each package's
  `Topology`), clock and `last_scrub` give equal snapshots and equal job
  specs from `scan`, `scan_temperature`, `scan_shard_scale` and
  `scan_scale` (`WEED_SCALE=1`).
- `Curator.tick` over each package's topology gives equal queues, and
  `on_complete` turns the same scrub findings into the same rebuild.
- `BytePacer` debits and sleeps alike on a fake clock.
- The port's worker fails a scale.up or scale.drain it cannot run with
  the JAX worker's error.
Tolerance: equality throughout.
"""

import numpy as np
import pytest

from test_torch_master import SHAPES, fed, heartbeats

from seaweedfs_tpu.maintenance import curator as j_curator
from seaweedfs_tpu.maintenance import detectors as j_detectors
from seaweedfs_tpu.maintenance import jobs as j_jobs
from seaweedfs_tpu.maintenance import pacer as j_pacer
from seaweedfs_tpu.maintenance import queue as j_queue
from seaweedfs_tpu.master import topology as j_topology
from seaweedfs_tpu_torch.maintenance import curator as t_curator
from seaweedfs_tpu_torch.maintenance import detectors as t_detectors
from seaweedfs_tpu_torch.maintenance import jobs as t_jobs
from seaweedfs_tpu_torch.maintenance import pacer as t_pacer
from seaweedfs_tpu_torch.maintenance import queue as t_queue
from seaweedfs_tpu_torch.maintenance import worker as t_worker
from seaweedfs_tpu_torch.master import topology as t_topology


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_job_tables_equal():
    assert t_jobs.PRIORITIES == j_jobs.PRIORITIES
    assert t_jobs.JOB_TYPES == j_jobs.JOB_TYPES
    for name in ("PENDING", "LEASED", "DONE", "TYPE_SHARD_SPLIT",
                 "TYPE_SHARD_MERGE"):
        assert getattr(t_jobs, name) == getattr(j_jobs, name)


def _ops(seed: int, n: int = 160) -> list:
    """A seeded op script over a few workers, volumes and job types."""
    rng = np.random.default_rng(seed)
    types = list(j_jobs.JOB_TYPES)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            ops.append(("enqueue", types[int(rng.integers(len(types)))],
                        int(rng.integers(0, 6)),
                        ("", "pics")[int(rng.integers(2))],
                        {"n": int(rng.integers(10))}))
        elif r < 0.55:
            ops.append(("lease", f"w{int(rng.integers(3))}",
                        int(rng.integers(1, 4)),
                        sorted({int(v) for v in rng.integers(0, 6, 3)})))
        elif r < 0.63:
            ops.append(("renew", int(rng.integers(1, 40)),
                        f"w{int(rng.integers(3))}"))
        elif r < 0.75:
            ops.append(("complete", int(rng.integers(1, 40)),
                        f"w{int(rng.integers(3))}"))
        elif r < 0.85:
            ops.append(("fail", int(rng.integers(1, 40)),
                        f"w{int(rng.integers(3))}"))
        elif r < 0.9:
            ops.append(("pause", bool(rng.random() < 0.5)))
        else:
            ops.append(("expire",))
        ops.append(("tick", float(rng.integers(1, 40))))
    return ops


def _drive(q, clock, ops) -> list:
    out = []
    for op in ops:
        kind = op[0]
        if kind == "tick":
            clock.t += op[1]
            continue
        if kind == "enqueue":
            r = q.enqueue(op[1], op[2], op[3], op[4])
        elif kind == "lease":
            r = q.lease(op[1], limit=op[2], ec_volumes=op[3])
        elif kind in ("renew", "complete", "fail"):
            # mostly a job that is leased now, by its worker or another
            leased = [j for j in q.jobs() if j["state"] == "leased"]
            jid, worker = f"j{op[1]}", op[2]
            if leased and op[1] % 4:
                pick = leased[op[1] % len(leased)]
                jid = pick["id"]
                worker = pick["worker"] if op[1] % 8 else worker
            if kind == "renew":
                r = q.renew(jid, worker)
            else:
                job = q.complete(jid, worker) if kind == "complete" \
                    else q.fail(jid, worker, "disk gone")
                r = job.to_dict() if job else None
        elif kind == "pause":
            q.paused = op[1]
            r = q.paused
        else:
            r = q.expire_leases()
        out.append((kind, r))
    return out


def _state(q) -> dict:
    return {"jobs": q.jobs(), "stats": q.stats(),
            "history": list(q.history), "paused": q.paused}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_queue_sequence_and_journal_equal(tmp_path, seed):
    queues = []
    for name, mod in (("j", j_queue), ("t", t_queue)):
        clock = FakeClock()
        q = mod.JobQueue(journal_path=str(tmp_path / f"{name}.jlog"),
                         lease_seconds=30.0, max_attempts=3,
                         retry_backoff=5.0)
        q.now = clock
        queues.append((q, _drive(q, clock, _ops(seed))))
    (jq, jr), (tq, tr) = queues
    assert tr == jr
    assert _state(tq) == _state(jq)
    with open(tmp_path / "j.jlog", "rb") as a, \
            open(tmp_path / "t.jlog", "rb") as b:
        assert b.read() == a.read()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_each_package_replays_the_others_journal(tmp_path, direction):
    src, dst = (j_queue, t_queue) if direction == "jax-to-port" \
        else (t_queue, j_queue)
    clock = FakeClock()
    path = str(tmp_path / "maintenance.jlog")
    q = src.JobQueue(journal_path=path, lease_seconds=30.0)
    q.now = clock
    _drive(q, clock, _ops(9, n=60))
    with open(path, "a") as f:
        f.write('{"op":"set","job":{"id":"j')  # a torn tail
    replayed = [mod.JobQueue(journal_path=path) for mod in (dst, src)]
    for r in replayed:
        r.now = clock
    assert replayed[0].jobs() == replayed[1].jobs() == q.jobs()
    assert replayed[0]._seq == replayed[1]._seq
    assert replayed[0].enqueue("vacuum", 77) == \
        replayed[1].enqueue("vacuum", 77)


# -- detectors -----------------------------------------------------------------


def _snapshots(seed: int, shape: str):
    hbs = heartbeats(seed, SHAPES[shape])
    jt, _ = fed(j_topology, hbs)
    tt, _ = fed(t_topology, hbs)
    return j_detectors.snapshot(jt), t_detectors.snapshot(tt)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scan_specs_equal(shape, seed, scale, monkeypatch):
    monkeypatch.setenv("WEED_SCALE", "1" if scale else "0")
    monkeypatch.setenv("WEED_SCALE_ON_ALERT", "1")
    js, ts = _snapshots(seed, shape)
    assert ts == js
    rng = np.random.default_rng(seed)
    last_scrub = {20: 5_000.0, 21: float(rng.integers(0, 100_000))}
    for now in (6_000.0, 100_000.0):
        for kw in ({}, {"garbage_threshold": 0.05, "balance_skew": 1},
                   {"vacuum_enabled": False, "scrub_interval": 10.0},
                   {"alerts": ["availability"], "scale_up_occ": 0.2}):
            jspec = j_detectors.scan(js, now, last_scrub, **kw)
            tspec = t_detectors.scan(ts, now, last_scrub, **kw)
            assert tspec == jspec
    assert t_detectors.scan_scale(ts, scale_enabled=True,
                                  scale_drain_occ=0.99,
                                  scale_drain_rps=1e9) == \
        j_detectors.scan_scale(js, scale_enabled=True,
                               scale_drain_occ=0.99, scale_drain_rps=1e9)


@pytest.mark.parametrize("seed", [2, 3])
def test_scan_temperature_and_shard_scale_equal(seed, monkeypatch):
    monkeypatch.setenv("WEED_HEAT_TIER", "1")
    monkeypatch.setenv("WEED_SHARD_SCALE", "1")
    js, ts = _snapshots(seed, "2dc-2racks")
    rng = np.random.default_rng(seed)
    usage = {"volumes": {str(v): float(rng.integers(0, 3))
                         for v in range(1, 13)},
             "totals": {"reads": 120}}
    for max_hints in (0, 2, 10):
        assert t_detectors.scan_temperature(ts, usage,
                                            max_hints=max_hints) == \
            j_detectors.scan_temperature(js, usage, max_hints=max_hints)
    assert t_detectors.scan_temperature(ts, None) == []
    for slots in (1, 2, 4, 64, 256):
        for holders in (0, 1, 3, 9):
            for resize in (None, {"to": 8}):
                shards = {"slots": slots, "holders": holders,
                          "resize": resize}
                assert t_detectors.scan_shard_scale(shards) == \
                    j_detectors.scan_shard_scale(shards)
    assert t_detectors.heat_tier_enabled() == \
        j_detectors.heat_tier_enabled()


# -- the curator ---------------------------------------------------------------


class _Raft:
    is_leader = True


class _Master:
    def __init__(self, topo):
        self.raft = _Raft()
        self.topo = topo
        self.auto_vacuum_interval = 900.0
        self.garbage_threshold = 0.3


@pytest.mark.parametrize("seed", [1, 6])
def test_curator_tick_gives_equal_queues(seed, monkeypatch):
    monkeypatch.setenv("WEED_MAINT_COOLDOWN", "60")
    hbs = heartbeats(seed, SHAPES["1dc-3racks"])
    curators = []
    for cmod, tmod in ((j_curator, j_topology), (t_curator, t_topology)):
        topo, _ = fed(tmod, hbs)
        cur = cmod.Curator(_Master(topo), interval=3600)
        clock = FakeClock(50_000.0)
        cur.now = cur.queue.now = clock
        curators.append((cur, clock))
    (jc, jclock), (tc, tclock) = curators
    assert tc.tick() == jc.tick()
    assert tc.queue.jobs() == jc.queue.jobs()
    assert tc.tick() == jc.tick() == []  # deduped while live
    # a deep scrub finding closes the loop into a rebuild
    for cur in (jc, tc):
        jid = cur.queue.enqueue("deep.scrub", 21, "pics")
        cur.queue.lease("w1", types=["deep.scrub"], ec_volumes=[21])
        cur.on_complete(cur.queue.complete(jid, "w1"),
                        {"corrupt": [3], "missing": [],
                         "parity_mismatch": [3]})
    assert tc.queue.jobs() == jc.queue.jobs()
    assert tc.last_scrub == jc.last_scrub
    # a completed repair cools its (type, volume) down
    for cur, clock in curators:
        for job in cur.queue.lease("w2", limit=20):
            cur.on_complete(cur.queue.complete(job["id"], "w2"), {})
        clock.t += 30
    assert tc.tick() == jc.tick()
    assert tc.queue.jobs() == jc.queue.jobs()
    assert tc.scans == jc.scans and tc.enqueued == jc.enqueued


# -- the pacer -----------------------------------------------------------------


def test_pacer_debits_and_sleeps_alike():
    rng = np.random.default_rng(5)
    sizes = [int(s) for s in rng.integers(1, 600_000, 60)]
    loads = [float(x) for x in rng.random(60) * 1.4]
    runs = []
    for mod in (j_pacer, t_pacer):
        load = [0.0]
        p = mod.BytePacer(rate_bytes=4 << 20, load_fn=lambda: load[0],
                          floor_frac=0.1)
        slept, now = [], [0.0]
        p.now = lambda: now[0]
        p.sleep = lambda d: (slept.append(d),
                             now.__setitem__(0, now[0] + d))
        for nbytes, lv in zip(sizes, loads):
            load[0] = lv
            p.throttle(nbytes)
            now[0] += 0.01
        runs.append((slept, p.snapshot()))
    assert runs[1] == runs[0]


def test_pacer_knobs_read_alike(monkeypatch):
    monkeypatch.setenv("WEED_MAINT_RATE_MB", "512")
    monkeypatch.setenv("WEED_MAINT_FLOOR", "0.25")
    jp, tp = j_pacer.BytePacer(), t_pacer.BytePacer()
    assert tp.base_rate() == jp.base_rate() == 512 << 20
    assert tp.floor_frac() == jp.floor_frac() == 0.25


# -- the worker's scale executors ------------------------------------------------


class _NoRoomServer:
    """A volume server whose spawn seam refuses to grow the cluster."""
    master_address = "127.0.0.1:1"
    address = "127.0.0.1:2"

    @staticmethod
    def spawn_volume_server(job):
        raise RuntimeError(f"no room for {job['type']}")


@pytest.mark.parametrize("job_type", ["scale.up", "scale.drain"])
def test_scale_jobs_fail_with_the_named_error(job_type):
    """A scale job that cannot run fails with the JAX worker's error: a
    refusing spawn seam for scale.up, a drain without its server."""
    from seaweedfs_tpu.maintenance import worker as j_worker

    job = {"id": "j1", "type": job_type, "volume": 0, "params": {}}
    errors = []
    for mod in (j_worker, t_worker):
        w = mod.MaintenanceWorker(server=_NoRoomServer())
        with pytest.raises((RuntimeError, ValueError)) as e:
            w._execute(job)
        errors.append((type(e.value), str(e.value)))
        with pytest.raises(ValueError, match="unknown job type"):
            w._execute({"id": "j2", "type": "nope", "volume": 0})
    assert errors[1] == errors[0]
    assert errors[0] == ((RuntimeError, "no room for scale.up")
                         if job_type == "scale.up" else
                         (ValueError, "scale.drain needs params.server"))


def test_worker_knobs_read_alike(monkeypatch):
    from seaweedfs_tpu.maintenance import worker as j_worker

    monkeypatch.setenv("WEED_MAINT_POLL", "0.5")
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    jw = j_worker.MaintenanceWorker(server=None)
    tw = t_worker.MaintenanceWorker(server=None)
    assert tw.poll_seconds() == jw.poll_seconds() == 0.5
    assert tw.enabled() is jw.enabled() is False
    tw.start()  # disabled: no thread
    assert tw._thread is None
    assert tw.pacer.snapshot() == jw.pacer.snapshot()
