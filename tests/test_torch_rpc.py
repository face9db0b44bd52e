"""The port's RPC layer (seaweedfs_tpu_torch/rpc) against the JAX package.

The scenarios of tests/test_conn_pool.py and tests/test_rpc_policy.py run
through both packages on the same inputs (fake clocks, a seeded
`random`, injected faults, no real sleeps) and their decisions and
snapshots must be equal; then the wire is crossed both ways: the port's
`call`/`call_stream` against a JAX `RpcServer`, and the JAX client against
a port `RpcServer`.
"""

import random
import socket
import threading
import time
from types import SimpleNamespace

import pytest

from seaweedfs_tpu import tracing as j_tracing
from seaweedfs_tpu.master.server import MasterServer
from seaweedfs_tpu.qos import classify as j_qos
from seaweedfs_tpu.rpc import http_rpc as j_http
from seaweedfs_tpu.rpc import policy as j_policy
from seaweedfs_tpu.util import faults as j_faults
from seaweedfs_tpu.volume_server import server as j_server
from seaweedfs_tpu_torch import tracing as t_tracing
from seaweedfs_tpu_torch.qos import classify as t_qos
from seaweedfs_tpu_torch.rpc import http_rpc as t_http
from seaweedfs_tpu_torch.rpc import policy as t_policy
from seaweedfs_tpu_torch.util import faults as t_faults
from seaweedfs_tpu_torch.volume_server import server as t_server

PKGS = {
    "jax": SimpleNamespace(http=j_http, policy=j_policy, faults=j_faults,
                           server=j_server, tracing=j_tracing, qos=j_qos),
    "torch": SimpleNamespace(http=t_http, policy=t_policy, faults=t_faults,
                             server=t_server, tracing=t_tracing, qos=t_qos),
}


def _reset_all():
    for p in PKGS.values():
        p.faults.REGISTRY.clear()
        p.policy.reset_state()


@pytest.fixture(autouse=True)
def clean_state():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture
def no_sleep(monkeypatch):
    """Record every backoff each package's policy layer would take."""
    slept = {name: [] for name in PKGS}
    for name, p in PKGS.items():
        monkeypatch.setattr(p.policy, "sleep", slept[name].append)
        monkeypatch.setattr(p.faults.REGISTRY, "sleep", lambda s: None)
    return slept


@pytest.fixture(scope="module")
def master():
    m = MasterServer(port=0, pulse_seconds=0.2)
    m.start()
    yield m
    m.stop()


def _both(fn):
    """fn(pkg) for both packages -> (jax result, torch result)."""
    out = []
    for p in PKGS.values():
        _reset_all()
        out.append(fn(p))
    return tuple(out)


# -- connection pool (tests/test_conn_pool.py) --------------------------------

class FakeConn:
    sock = None

    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_pool_idle_cap_evicts_oldest():
    def run(p):
        pool = p.http._ConnPool(max_idle_per_addr=16, idle_ttl=30.0)
        conns = [FakeConn() for _ in range(25)]
        for c in conns:
            pool.put("10.0.0.1:80", c)
        with pool._lock:
            idle = [conns.index(c) for c, _ in pool._idle["10.0.0.1:80"]]
        return [c.closed for c in conns], idle

    j, t = _both(run)
    assert j == t
    assert t[0] == [True] * 9 + [False] * 16 and t[1] == list(range(9, 25))


def test_pool_ttl_reap_covers_quiet_addresses():
    def run(p):
        pool = p.http._ConnPool(max_idle_per_addr=100, idle_ttl=0.05)
        addrs = [f"10.0.0.{i}:80" for i in range(4)]
        conns = {a: [FakeConn() for _ in range(25)] for a in addrs}
        for a in addrs:
            for c in conns[a]:
                pool.put(a, c)
        time.sleep(0.12)
        pool._last_sweep = 0.0  # the sweep may run now
        pool.put(addrs[0], FakeConn())
        with pool._lock:
            kept = sorted(pool._idle)
        return ({a: all(c.closed for c in conns[a]) for a in addrs}, kept)

    j, t = _both(run)
    assert j == t
    assert all(t[0].values()) and t[1] == ["10.0.0.0:80"]


def test_pool_get_discards_expired_and_dropped():
    def run(p):
        pool = p.http._ConnPool(max_idle_per_addr=16, idle_ttl=0.05)
        c = FakeConn()
        pool.put("127.0.0.1:1", c)
        time.sleep(0.08)
        fresh = pool.get("127.0.0.1:1", timeout=1.0)
        dropped = FakeConn()  # sock None: a reaped socket
        pool.put("127.0.0.1:2", dropped)
        other = pool.get("127.0.0.1:2", timeout=1.0)
        return c.closed, fresh is c, dropped.closed, other is dropped

    j, t = _both(run)
    assert j == t == (True, False, True, False)


def test_pool_put_get_race_keeps_invariants():
    pool = t_http._ConnPool(max_idle_per_addr=4, idle_ttl=30.0)
    addrs = [f"10.1.0.{i}:80" for i in range(4)]
    made, lock, errors = [], threading.Lock(), []

    def worker(seed):
        try:
            for i in range(200):
                a = addrs[(seed + i) % len(addrs)]
                c = FakeConn()
                with lock:
                    made.append(c)
                pool.put(a, c)
                if i % 3 == 0:
                    pool.get(a, timeout=1.0).close()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    with pool._lock:
        assert all(len(idle) <= 4 for idle in pool._idle.values())
        idle_conns = {c for lst in pool._idle.values() for c, _ in lst}
    assert not [c for c in made if not c.closed and c not in idle_conns]


# -- policy decisions (tests/test_rpc_policy.py) -------------------------------

CLASSIFY_CASES = [("GET", "/3,0101f0"), ("HEAD", "/3,0101f0"),
                  ("POST", "/3,0101f0"), ("DELETE", "/3,0101f0"),
                  ("POST", "/3,0101f0?type=replicate"),
                  ("POST", "/dir/lookup?volumeId=3"), ("POST", "/dir/assign"),
                  ("POST", "/admin/ec/generate"), ("PUT", "/b/k"),
                  ("GET", "/admin/ec/shard_read?volume=1")]


def test_idempotency_and_retryable_equal():
    for method, path in CLASSIFY_CASES:
        assert t_policy.is_idempotent(method, path) == \
            j_policy.is_idempotent(method, path), (method, path)
    for status, transport in [(503, False), (429, False), (200, True),
                              (404, False), (403, False), (500, False),
                              (502, True), (504, False)]:
        assert t_policy.retryable(
            t_http.RpcError("x", status, transport=transport)) == \
            j_policy.retryable(
                j_http.RpcError("x", status, transport=transport))
    assert not t_policy.retryable(ValueError("x"))


def test_backoff_and_budget_equal_under_seeded_random():
    def run(p):
        rng = random.Random(11)
        delays = [p.policy.backoff_delay(a, base=0.025, cap=2.0,
                                         rand=rng.random)
                  for a in range(1, 40)]
        b = p.policy.RetryBudget(ratio=0.3, cap=3.0)
        rng = random.Random(12)
        spends = []
        for _ in range(300):
            if rng.random() < 0.6:
                b.on_request()
            else:
                spends.append(b.try_spend())
        return delays, spends, b.tokens

    j, t = _both(run)
    assert j == t
    assert t[0][0] <= 0.05 and max(t[0]) <= 2.0


def test_breaker_decisions_equal_on_fake_clock(monkeypatch):
    clock = [1000.0]
    for p in PKGS.values():
        monkeypatch.setattr(p.policy, "now", lambda: clock[0])

    def run(p):
        clock[0] = 1000.0
        rng = random.Random(5)
        br = p.policy.Breaker("a:1", failures=3, open_secs=5.0)
        trail = []
        for _ in range(400):
            r = rng.random()
            if r < 0.35:
                br.on_failure()
            elif r < 0.5:
                br.on_success()
            elif r < 0.8:
                trail.append(br.allow())
            else:
                clock[0] += rng.choice([0.5, 2.0, 5.1])
            trail.append(br.state)
        return trail

    j, t = _both(run)
    assert j == t
    assert {"closed", "open", "half_open"} <= set(t)


def test_call_policy_retries_equal(master, no_sleep):
    spec = "error,status=503,times=2,side=client,route=/dir/status*"

    def run(p):
        random.seed(3)
        p.faults.REGISTRY.configure(spec)
        r = p.policy.call_policy(master.address, "/dir/status",
                                 method="GET")
        return isinstance(r, dict), p.faults.REGISTRY.rules[0].fires

    assert _both(run) == ((True, 2), (True, 2))
    assert no_sleep["jax"] == no_sleep["torch"] and \
        len(no_sleep["torch"]) == 2


@pytest.mark.parametrize("status,budget,fires", [(404, None, 1),
                                                 (503, "dry", 1)])
def test_call_policy_stops_retrying_equal(master, no_sleep, status, budget,
                                          fires):
    def run(p):
        p.faults.REGISTRY.configure(
            f"error,status={status},side=client,route=/dir/status*")
        kw = {}
        if budget:
            kw["budget"] = p.policy.RetryBudget(ratio=0.0, cap=0.0)
        with pytest.raises(p.http.RpcError) as e:
            p.policy.call_policy(master.address, "/dir/status",
                                 method="GET", **kw)
        return e.value.status, p.faults.REGISTRY.rules[0].fires

    assert _both(run) == ((status, fires), (status, fires))
    assert no_sleep == {"jax": [], "torch": []}


def test_breaker_opens_and_fails_fast_equal(no_sleep):
    dst = "127.0.0.1:45678"

    def run(p):
        p.faults.REGISTRY.configure(f"reset,dst={dst}")
        for _ in range(5):
            with pytest.raises(p.http.RpcError):
                p.policy.call_policy(dst, "/x", method="GET", retries=0)
        state = p.policy.BREAKERS.get(dst).state
        with pytest.raises(p.http.RpcError) as e:
            p.policy.call_policy(dst, "/x", method="GET", retries=0)
        return state, "circuit open" in str(e.value), \
            p.faults.REGISTRY.rules[0].fires

    assert _both(run) == (("open", True, 5), ("open", True, 5))


def test_breakers_are_per_package(no_sleep):
    """A master dying under one package must not open the other's
    breakers: the two policy layers hold separate boards."""
    dst = "127.0.0.1:45679"
    t_faults.REGISTRY.configure(f"reset,dst={dst}")
    for _ in range(5):
        with pytest.raises(t_http.RpcError):
            t_policy.call_policy(dst, "/x", method="GET", retries=0)
    assert t_policy.BREAKERS.get(dst).state == "open"
    assert j_policy.BREAKERS.get(dst).state == "closed"


def test_failover_order_and_round_backoff_equal(no_sleep):
    m1, m2 = "127.0.0.1:18801", "127.0.0.1:18802"

    def run(p):
        random.seed(9)
        p.faults.REGISTRY.configure(f"reset,dst={m1};reset,dst={m2}")
        with pytest.raises(p.http.RpcError) as e:
            p.policy.failover_call([m1, m2], "/dir/status", method="GET",
                                   rounds=2)
        return e.value.transport, [
            ev["dst"] for ev in p.faults.REGISTRY.snapshot()["log"]]

    assert _both(run) == ((True, [m1, m2, m1, m2]),) * 2
    assert no_sleep["jax"] == no_sleep["torch"] and \
        len(no_sleep["torch"]) == 1


def test_failover_skips_open_breaker_to_live_master(master, no_sleep):
    dead = "127.0.0.1:18809"
    t_faults.REGISTRY.configure(f"reset,dst={dead}")
    for _ in range(5):
        t_policy.BREAKERS.get(dead).on_failure()
    resp, winner = t_policy.failover_call([dead, master.address],
                                          "/dir/status", method="GET")
    assert isinstance(resp, dict) and winner == master.address
    assert t_faults.REGISTRY.snapshot()["log"] == []


def test_hedging():
    def boom():
        raise t_http.RpcError("down", 503)

    assert t_policy.hedged("/k", [lambda: 41 + 1]) == 42
    with pytest.raises(ValueError):
        t_policy.hedged("/k", [])
    assert t_policy.hedged("/k", [boom, lambda: "ok"]) == "ok"
    with pytest.raises(t_http.RpcError):
        t_policy.hedged("/k", [boom, boom])

    def slow():
        time.sleep(0.3)
        return "slow"

    t0 = time.monotonic()
    assert t_policy.hedged("/k2", [slow, lambda: "fast"]) == "fast"
    assert time.monotonic() - t0 < 0.25


def test_hedge_delays_equal():
    rng = random.Random(4)
    samples = [rng.expovariate(40.0) for _ in range(150)]

    def run(p):
        h = p.policy.HedgeTracker()
        out = []
        for i, s in enumerate(samples):
            h.observe(f"/k{i % 3}", s)
            out.append(h.delay(f"/k{i % 3}"))
        return out, h.delay("/cold")

    j, t = _both(run)
    assert j == t and t[1] == pytest.approx(0.025)


def test_shedder_bounds_inflight(monkeypatch):
    s = t_server._RequestShedder(1)
    assert s.try_acquire() and not s.try_acquire()
    s.release()
    assert s.try_acquire()
    s.release()
    assert all(t_server._RequestShedder(0).try_acquire()
               for _ in range(50))
    monkeypatch.setenv("WEED_VS_MAX_INFLIGHT", "2")
    s = t_server._RequestShedder(1)
    assert s.try_acquire() and s.try_acquire() and not s.try_acquire()


# -- deadlines -----------------------------------------------------------------

def test_deadline_scope_and_client_refusal():
    with t_http.deadline_scope(timeout=1.0):
        outer = t_http.current_deadline()
        with t_http.deadline_scope(timeout=100.0):
            assert t_http.current_deadline() == outer
    assert t_http.current_deadline() is None
    with t_http.deadline_scope(absolute=time.time() - 1):
        with pytest.raises(t_http.RpcError) as e:
            t_http.call("127.0.0.1:1", "/x")
    assert e.value.status == 504


# -- across the wire -------------------------------------------------------------

def _echo_server(p):
    """An RpcServer of package `p` whose routes report what the dispatch
    loop installed: deadline, trace, QoS, body."""
    srv = p.http.RpcServer("127.0.0.1", 0, service_name="echo")

    def info(req):
        sp = p.tracing.current()
        return {"deadline": p.http.current_deadline(),
                "trace": sp.trace_id if sp is not None else None,
                "qos": [p.qos.current_class(), p.qos.current_tenant()],
                "body": len(req.body), "q": req.param("q")}

    def fail(req):
        raise p.http.RpcError("nope here", 418,
                              headers={"Retry-After": "3"})

    def chunks(req):
        n = int(req.param("n", "3"))
        return p.http.Response(iter([bytes([65 + i]) * 1000
                                     for i in range(n)]))

    srv.add("POST", "/info", info)
    srv.add("GET", "/info", info)
    srv.add("GET", "/raw", lambda req: bytes(range(256)) * 4)
    srv.add("GET", "/fail", fail)
    srv.add("GET", "/boom", lambda req: 1 // 0)
    srv.add("GET", "/chunks", chunks)
    srv.add("GET", "/sized", lambda req: p.http.Response(
        iter([b"x" * 700, b"y" * 300]), headers={"Content-Length": "1000"}))
    srv.start()
    return srv


@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_cross_wire(client, server, monkeypatch):
    c, s = PKGS[client], PKGS[server]
    monkeypatch.setenv("WEED_TRACE_SAMPLE", "1")
    srv = _echo_server(s)
    try:
        addr = srv.address
        got = c.http.call(addr, "/info?q=7", {"a": 1})
        assert got["body"] == len(b'{"a": 1}') and got["q"] == "7"
        assert got["deadline"] is None and got["qos"][0] == "standard"
        assert c.http.call(addr, "/raw") == bytes(range(256)) * 4
        assert b"".join(c.http.call_stream(addr, "/chunks?n=4")) == \
            b"A" * 1000 + b"B" * 1000 + b"C" * 1000 + b"D" * 1000
        assert b"".join(c.http.call_stream(addr, "/sized")) == \
            b"x" * 700 + b"y" * 300
        for stream in (False, True):
            with pytest.raises(c.http.RpcError) as e:
                if stream:
                    c.http.call_stream(addr, "/fail")
                else:
                    c.http.call(addr, "/fail")
            assert e.value.status == 418 and str(e.value) == "nope here"
        with pytest.raises(c.http.RpcError) as e:
            c.http.call(addr, "/fail")
        assert e.value.headers == {"Retry-After": "3"}
        with pytest.raises(c.http.RpcError) as e:
            c.http.call(addr, "/boom")
        assert e.value.status == 500 and \
            str(e.value) == "ZeroDivisionError: integer division or " \
                            "modulo by zero"
        with pytest.raises(c.http.RpcError) as e:
            c.http.call(addr, "/nowhere")
        assert e.value.status == 404
        # the deadline rides X-Deadline and is pinned on the handler
        with c.http.deadline_scope(timeout=30.0):
            dl = c.http.current_deadline()
            got = c.http.call(addr, "/info")
        assert got["deadline"] == pytest.approx(dl, abs=1e-5)
        with pytest.raises(c.http.RpcError) as e:
            c.http.call(addr, "/info", headers={
                c.http.DEADLINE_HEADER: f"{time.time() - 5:.6f}"})
        assert e.value.status == 504 and "deadline exceeded before" in \
            str(e.value)
        # trace context: the handler's span belongs to the caller's trace
        with c.tracing.span("client.op", "test") as sp:
            got = c.http.call(addr, "/info")
        assert got["trace"] == sp.trace_id
        # QoS class and tenant ride X-QoS-Class / X-QoS-Tenant
        with c.qos.qos_scope("background", tenant="t9"):
            got = c.http.call(addr, "/info")
        assert got["qos"] == ["background", "t9"]
    finally:
        srv.stop()


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_port_server_refuses_prefork(monkeypatch):
    """An ephemeral (port-0) server refuses to prefork whatever
    WEED_HTTP_WORKERS says, as the JAX package's does: only an explicitly
    bound port shards into workers (never a test process)."""
    monkeypatch.setenv("WEED_HTTP_WORKERS", "2")
    for mod in (t_http, j_http):
        s = mod.RpcServer("127.0.0.1", 0, service_name="x")
        try:
            assert s._prefork_workers == 1 and s._prefork is None
        finally:
            s.httpd.server_close()
    monkeypatch.setenv("WEED_HTTP_WORKERS", "3")
    s = t_http.RpcServer("127.0.0.1", _free_port(), service_name="x")
    try:
        assert s._prefork_workers == 3 and s._prefork is None
    finally:
        s.httpd.server_close()
