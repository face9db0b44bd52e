"""The port's admission control, quotas and shared QoS segment against the
JAX package: the same seeded sequences through both packages'
`TokenBucket`, `TenantBuckets`, `DrrQueue`, `AdmissionGate`,
`CollectionQuotas` and `shm` on a fake clock give equal decisions, equal
snapshots and equal ``qos_*`` exposition deltas.  Follows tests/test_qos.py
and tests/test_qos_shm.py.
"""

import random
import threading
import time
from types import SimpleNamespace

import pytest

from test_torch_metrics import _Delta

from seaweedfs_tpu import qos as j_qos
from seaweedfs_tpu.qos import admission as j_adm
from seaweedfs_tpu.qos import quota as j_quota
from seaweedfs_tpu.qos import shm as j_shm
from seaweedfs_tpu.rpc import http_rpc as j_http
from seaweedfs_tpu_torch import qos as t_qos
from seaweedfs_tpu_torch.qos import admission as t_adm
from seaweedfs_tpu_torch.qos import quota as t_quota
from seaweedfs_tpu_torch.qos import shm as t_shm
from seaweedfs_tpu_torch.rpc import http_rpc as t_http

PKGS = {
    "jax": SimpleNamespace(qos=j_qos, adm=j_adm, quota=j_quota, shm=j_shm,
                           http=j_http),
    "torch": SimpleNamespace(qos=t_qos, adm=t_adm, quota=t_quota,
                             shm=t_shm, http=t_http),
}
CLASSES = ("interactive", "standard", "background")
QOS_FAMILIES = ("SeaweedFS_qos_",)


@pytest.fixture(autouse=True)
def _no_segment(monkeypatch):
    for k in ("WEED_QOS_TENANT_RPS", "WEED_QOS_TENANT_BURST",
              "WEED_QOS_WEIGHTS", "WEED_QOS_QUOTA", "WEED_QOS"):
        monkeypatch.delenv(k, raising=False)
    for p in PKGS.values():
        p.shm.destroy()
    yield
    for p in PKGS.values():
        p.shm.destroy()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(fn):
    return tuple(fn(p) for p in PKGS.values())


def test_token_and_tenant_buckets_equal(monkeypatch):
    monkeypatch.setenv("WEED_QOS_TENANT_RPS", "5")
    monkeypatch.setenv("WEED_QOS_TENANT_BURST", "3")

    def run(p):
        clock = FakeClock()
        rng = random.Random(21)
        tb = p.adm.TokenBucket(rate=4.0, burst=6.0, now=clock)
        tenants = p.adm.TenantBuckets(now=clock)
        out = []
        for _ in range(600):
            r = rng.random()
            if r < 0.3:
                out.append(tb.try_take(rng.choice([0.5, 1.0, 2.0])))
            elif r < 0.8:
                out.append(tenants.try_take(rng.choice(["a", "b", "c", ""])))
            else:
                clock.t += rng.choice([0.05, 0.2, 1.0])
        return out, tenants.snapshot()

    j, t = _both(run)
    assert j == t
    assert True in t[0] and False in t[0]


def test_drr_queue_order_equal(monkeypatch):
    monkeypatch.setenv("WEED_QOS_WEIGHTS", "interactive=5,standard=3,"
                                           "background=1")

    def run(p):
        rng = random.Random(8)
        q = p.adm.DrrQueue()
        popped = []
        for i in range(500):
            if rng.random() < 0.55:
                q.push(rng.choice(CLASSES), i)
            else:
                popped.append(q.pop())
        while len(q):
            popped.append(q.pop())
        return popped, q.weights

    j, t = _both(run)
    assert j == t and t[1] == {"interactive": 5, "standard": 3,
                               "background": 1}


def test_gate_without_waiting_equal(monkeypatch):
    """admit(wait=False) and releases: admitted or shed, never parked
    longer than the call; snapshots and qos_* deltas equal."""
    monkeypatch.setenv("WEED_QOS_T_LIMIT", "3")
    monkeypatch.setenv("WEED_QOS_TENANT_RPS", "20")
    monkeypatch.setenv("WEED_QOS_TENANT_BURST", "4")
    results = {}
    snaps = {}
    with _Delta(QOS_FAMILIES) as d:
        for name, p in PKGS.items():
            clock = FakeClock()
            gate = p.adm.AdmissionGate("tgate", limit_env="WEED_QOS_T_LIMIT",
                                       now=clock)
            rng = random.Random(13)
            held, out = [], []
            for _ in range(400):
                r = rng.random()
                if r < 0.55:
                    try:
                        held.append(gate.admit(
                            rng.choice(CLASSES),
                            tenant=rng.choice(["x", "y"]), wait=False))
                        out.append("admit")
                    except p.http.RpcError as e:
                        out.append(e.status)
                elif r < 0.85 and held:
                    held.pop(rng.randrange(len(held)))()
                    out.append("release")
                else:
                    clock.t += 0.1
                out.append(round(gate.occupancy(), 4))
            for rel in held:
                rel()
            results[name] = out
            snaps[name] = gate.snapshot()
    assert results["jax"] == results["torch"]
    assert snaps["jax"] == snaps["torch"]
    assert {429, 503} <= set(results["torch"])
    assert d.jax == d.port and d.port


def test_gate_dispatches_parked_waiters_in_drr_order(monkeypatch):
    """limit 1: one holder, then waiters parked in a fixed order; each
    release dispatches the next by deficit round robin."""
    monkeypatch.setenv("WEED_QOS_T_LIMIT", "1")
    monkeypatch.setenv("WEED_QOS_WEIGHTS", "interactive=3,standard=2,"
                                           "background=1")
    order = ["background", "standard", "interactive", "background",
             "interactive", "standard", "interactive", "background"]

    def run(p):
        gate = p.adm.AdmissionGate("tdrr", limit_env="WEED_QOS_T_LIMIT")
        first = gate.admit("standard", tenant="")
        got, lock = [], threading.Lock()
        releases = {}

        def waiter(i, cls):
            rel = gate.admit(cls, tenant="")
            with lock:
                got.append((i, cls))
                releases[i] = rel

        threads = []
        for i, cls in enumerate(order):
            th = threading.Thread(target=waiter, args=(i, cls), daemon=True)
            th.start()
            threads.append(th)
            deadline = time.monotonic() + 5
            while sum(gate.queued.values()) < i + 1:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        first()
        for k in range(len(order)):
            deadline = time.monotonic() + 5
            while len(got) < k + 1:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            with lock:
                rel = releases[got[k][0]]
            rel()
        for th in threads:
            th.join(5)
        return got, gate.snapshot()["admitted"]

    j, t = _both(run)
    assert j == t
    assert t[0][0][1] == "interactive"


def test_collection_quotas_equal(monkeypatch):
    monkeypatch.setenv("WEED_QOS_QUOTA", "photos=4ops+1mb,logs=2ops,*=8ops")

    def run(p):
        clock = FakeClock()
        q = p.quota.CollectionQuotas(now=clock)
        rng = random.Random(31)
        out = []
        for _ in range(500):
            if rng.random() < 0.8:
                out.append(q.allow(rng.choice(["photos", "logs", "misc", ""]),
                                   nbytes=rng.choice([0, 1000, 400000])))
            else:
                clock.t += rng.choice([0.1, 0.5])
        return out, q.snapshot()

    with _Delta(QOS_FAMILIES) as d:
        j, t = _both(run)
    assert j == t
    assert t[1]["rejects"]["ops"] > 0 and t[1]["rejects"]["bytes"] > 0
    assert d.jax == d.port and d.port


def test_shared_segment_equal_and_cross_attached(monkeypatch):
    """Tenant buckets and gate rows in each package's segment on a fake
    monotonic clock; then the JAX package attaches the port's segment by
    name and reads the same snapshot."""
    ns = [5_000_000_000]
    monkeypatch.setattr(time, "monotonic_ns", lambda: ns[0])

    def run(p):
        ns[0] = 5_000_000_000
        seg = p.shm.create(4)
        try:
            rng = random.Random(41)
            out = []
            for _ in range(400):
                if rng.random() < 0.8:
                    out.append(seg.tenant_take(rng.choice(["t1", "t2", "q"]),
                                               rate=3.0, burst=2.0))
                else:
                    ns[0] += rng.choice([100_000_000, 700_000_000])
            for wid, cls, field, v in [(0, "interactive", "inflight", 2),
                                       (1, "standard", "queued", 3),
                                       (2, "background", "admitted", 7)]:
                p.shm.set_worker_id(wid)
                seg.gate_set("volume", cls, field, v)
            p.shm.set_worker_id(0)
            stats = {k: seg.tenant_stats(k) for k in ("t1", "t2", "q", "x")}
            snap = seg.snapshot()
            snap.pop("segment")
            return out, stats, snap, seg.gate_total("inflight")
        finally:
            if p.shm.ACTIVE is not None and p.shm.ACTIVE is not seg:
                p.shm.destroy()

    j = run(PKGS["jax"])
    j_shm.destroy()
    t = run(PKGS["torch"])
    assert j == t and t[3] == 2
    seg = t_shm.ACTIVE
    try:
        other = j_shm.QosShm(name=seg.name)
        try:
            theirs = other.snapshot()
            ours = seg.snapshot()
            assert theirs == ours
            assert other.tenant_stats("t1") == seg.tenant_stats("t1")
        finally:
            other.close()
    finally:
        t_shm.destroy()


def test_snapshot_and_debug_qos_route(monkeypatch):
    # the device lanes and the quota meter are process-wide: start both
    # packages from zero, then drive the same quota sequence through each
    monkeypatch.setenv("WEED_QOS_QUOTA", "photos=2ops,*=4ops")
    clock = FakeClock()
    for p in PKGS.values():
        p.qos.LANES.reset()
        monkeypatch.setattr(p.qos, "QUOTAS",
                            p.quota.CollectionQuotas(now=clock))
        for coll in ("photos", "photos", "photos", "logs", ""):
            p.qos.QUOTAS.allow(coll)
    gate = t_adm.AdmissionGate("volume", limit_env="WEED_QOS_VS_LIMIT")
    jgate = j_adm.AdmissionGate("volume", limit_env="WEED_QOS_VS_LIMIT")
    snap = t_qos.snapshot(gate)
    jsnap = j_qos.snapshot(jgate)
    assert snap == jsnap
    assert snap["quotas"]["rejects"] == {"ops": 1, "bytes": 0}
    srv = t_http.RpcServer("127.0.0.1", 0, service_name="q")
    t_qos.mount(srv, gate=gate)
    srv.start()
    try:
        assert j_http.call(srv.address, "/debug/qos") == jsnap
    finally:
        srv.stop()
