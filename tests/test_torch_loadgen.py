"""The port's load generator against the JAX package's.

`schedule_bytes(build_schedule(...))` is byte-identical for several
seeds and `WEED_LOAD_*` settings (the blake2b draw contract); the
generators' single draws agree; `percentile`, `ReplayStats.summary` and
`replay` (counts, failures, a pre-set `stop`, and the forked
`processes>1` path in a fresh interpreter) behave as the JAX ones do.
Tolerance: equality throughout.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from seaweedfs_tpu import loadgen as j_loadgen
from seaweedfs_tpu.loadgen import generators as j_gen
from seaweedfs_tpu_torch import loadgen as t_loadgen
from seaweedfs_tpu_torch.loadgen import generators as t_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 42, 1234, 2**31 + 7])
def test_schedule_bytes_equal_for_seeds(seed):
    kw = dict(seed=seed, duration_s=2.0, rate_rps=150.0, n_objects=500,
              n_tenants=100)
    jb = j_loadgen.schedule_bytes(j_loadgen.build_schedule(**kw))
    tb = t_loadgen.schedule_bytes(t_loadgen.build_schedule(**kw))
    assert tb == jb and tb


@pytest.mark.parametrize("env", [
    {},
    {"WEED_LOAD_SEED": "777", "WEED_LOAD_DURATION": "1.5"},
    {"WEED_LOAD_RATE": "400", "WEED_LOAD_OBJECTS": "60000",
     "WEED_LOAD_TENANTS": "200", "WEED_LOAD_DURATION": "1"},
    {"WEED_LOAD_ZIPF_S": "0.8", "WEED_LOAD_TENANTS": "7",
     "WEED_LOAD_DURATION": "3"},
])
def test_schedule_bytes_equal_under_env_knobs(monkeypatch, env):
    for key in ("WEED_LOAD_SEED", "WEED_LOAD_DURATION", "WEED_LOAD_RATE",
                "WEED_LOAD_OBJECTS", "WEED_LOAD_TENANTS",
                "WEED_LOAD_ZIPF_S"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert t_loadgen.load_seed() == j_loadgen.load_seed()
    for write_ratio in (0.05, 0.5):
        jb = j_loadgen.schedule_bytes(
            j_loadgen.build_schedule(write_ratio=write_ratio))
        tb = t_loadgen.schedule_bytes(
            t_loadgen.build_schedule(write_ratio=write_ratio))
        assert tb == jb


def test_generator_draws_equal():
    rng = np.random.default_rng(4)
    for n in rng.integers(0, 10**6, 50):
        n = int(n)
        assert t_gen._unit(9, "s", n) == j_gen._unit(9, "s", n)
    jz, tz = j_gen.ZipfPopularity(1000, seed=5), t_gen.ZipfPopularity(
        1000, seed=5)
    js, ts = j_gen.SizeMixture(seed=5), t_gen.SizeMixture(seed=5)
    jm, tm = j_gen.DiurnalTenantMix(200, seed=5), t_gen.DiurnalTenantMix(
        200, seed=5)
    for n in range(300):
        assert tz.sample(n) == jz.sample(n)
        assert ts.sample(n) == js.sample(n)
        assert tm.sample(n * 37.5, n) == jm.sample(n * 37.5, n)
        assert t_gen.tenant_class(5, n) == j_gen.tenant_class(5, n)
    assert t_gen.SizeMixture.DEFAULT == j_gen.SizeMixture.DEFAULT
    assert t_gen.poisson_arrivals(200.0, 3.0, seed=3) == \
        j_gen.poisson_arrivals(200.0, 3.0, seed=3)


def test_percentile_like_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 7, 100, 1001):
        vals = sorted(float(v) for v in rng.random(n))
        for p in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert t_loadgen.percentile(vals, p) == \
                j_loadgen.percentile(vals, p)


def test_replay_stats_summary_like_jax():
    rng = np.random.default_rng(8)
    stats = [j_loadgen.ReplayStats(), t_loadgen.ReplayStats()]
    classes = ["interactive", "standard", "background", "other"]
    for _ in range(500):
        cls = classes[int(rng.integers(0, 4))]
        secs = float(rng.random() / 10)
        ok = bool(rng.random() < 0.9)
        for st in stats:
            st.record(cls, secs, ok)
    extra = {"latencies": {"interactive": [0.5, 0.25]},
             "failures": {"background": 3}}
    for st in stats:
        st.merge(extra)
        st.wall_s = 2.5
    assert stats[1].to_dict() == stats[0].to_dict()
    assert stats[1].summary() == stats[0].summary()
    assert t_loadgen.ReplayStats().summary() == \
        j_loadgen.ReplayStats().summary()


def _replay_counts(loadgen):
    sched = loadgen.build_schedule(seed=6, duration_s=1.0, rate_rps=200.0,
                                   n_objects=50, n_tenants=10)
    seen = []
    lock = threading.Lock()

    def send(req):
        from seaweedfs_tpu_torch.qos import classify as t_cls
        from seaweedfs_tpu.qos import classify as j_cls

        cls = (t_cls if loadgen is t_loadgen else j_cls)
        with lock:
            seen.append((req.obj, cls.current_class(), cls.current_tenant()))
        if req.obj % 7 == 0:
            raise RuntimeError("boom")
        return req.obj % 5 != 0

    out = loadgen.replay(sched, send, workers=4, open_loop=False)
    return ({k: v for k, v in out.items()
             if k in ("requests", "failures")},
            {c: (v["requests"], v["failures"])
             for c, v in out["by_class"].items()},
            sorted(seen))


def test_replay_counts_and_scopes_like_jax():
    jax, port = _replay_counts(j_loadgen), _replay_counts(t_loadgen)
    assert port == jax
    assert port[0]["failures"] > 0 and port[0]["requests"] > 0
    # every send ran under its request's QoS class and tenant
    assert {cls for _, cls, _ in port[2]} <= {"interactive", "standard",
                                              "background"}


def test_replay_stop_like_jax():
    for loadgen in (j_loadgen, t_loadgen):
        sched = loadgen.build_schedule(seed=8, duration_s=30.0,
                                       rate_rps=100.0, n_objects=20,
                                       n_tenants=5)
        stop = threading.Event()
        stop.set()
        out = loadgen.replay(sched, lambda r: True, workers=2,
                             open_loop=True, stop=stop)
        assert out["requests"] == 0 and out["failures"] == 0
    assert t_loadgen.replay([], lambda r: True) == \
        j_loadgen.replay([], lambda r: True)


def test_forked_replay_in_a_fresh_interpreter():
    """`processes>1` forks: it runs in a fresh interpreter that imports
    no torch (never in a test process), and counts every request."""
    code = (
        "import json, sys\n"
        "from seaweedfs_tpu_torch.loadgen import build_schedule, replay\n"
        "s = build_schedule(seed=3, duration_s=1.0, rate_rps=300.0,\n"
        "                   n_objects=40, n_tenants=8)\n"
        "out = replay(s, lambda r: r.obj % 3 != 0, workers=2,\n"
        "             processes=3, open_loop=False)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'seaweedfs_tpu')]\n"
        "print(json.dumps([len(s), out['requests'], out['failures'],\n"
        "                  sum(r.obj % 3 != 0 for r in s), bad]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, requests, failures, good, bad = json.loads(
        res.stdout.strip().splitlines()[-1])
    assert requests + failures == n and requests == good and bad == []
