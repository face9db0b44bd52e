"""Deterministic fault injection: the chaos substrate for robustness
tests and live incident drills.

A process-wide registry of rules, each matched against an RPC or disk
event by (side, dst, route) globs and fired with a configured
probability.  Determinism is the whole point: the fire/no-fire decision
for the k-th event matching a rule is a pure hash of
(seed, rule_id, k) — NOT a shared RNG stream — so the injected sequence
per rule is identical across runs regardless of thread interleaving
between rules.  Re-running a test with the same WEED_FAULTS spec and
seed replays the same faults.

Spec syntax (WEED_FAULTS env var, also accepted by POST /debug/faults):

    rule[;rule...]
    rule  = kind,key=value[,key=value...]
    kind  = latency | error | reset | short_read | disk_error
    keys  = pct=<float 0..100>   fire probability (default 100)
            ms=<float>           latency to inject (latency kind)
            status=<int>         HTTP status to inject (error kind,
                                 default 503)
            dst=<glob>           destination "host:port" filter
            route=<glob>         request path filter
            side=<client|server|disk|any>  hook side (default any)
            times=<int>          stop after N fires (0 = unlimited)
            id=<name>            stable rule id (default kind#index)

Example — 5% 503s to one volume server plus 50 ms on every lookup:

    WEED_FAULTS='error,status=503,pct=5,dst=127.0.0.1:8080;latency,ms=50,route=/dir/lookup*'
    WEED_FAULTS_SEED=42

Hook points (all no-ops while no rules are loaded — a single module
bool guards the hot path):

  * rpc/http_rpc.py call()/call_stream()  -> on_rpc("client", dst, route)
  * RpcServer._dispatch                   -> on_rpc("server", dst, route)
  * storage/erasure_coding/inline.py      -> on_disk(path, "write") per
                                             shard-log write, on_disk(path,
                                             "commit") per commit record

The port's own copy of seaweedfs_tpu/util/faults.py.  Each fired fault
counts in SeaweedFS_faults_injected_total, and loading rules writes a
``faults.active`` event to the journal.  Every daemon mounts GET/POST
/debug/faults (debug_handler) to inspect counters and flip rules live.
The storage/backend.py DiskFile hooks come with the native engine
(ROADMAP item 7).
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import threading
import time
from typing import Callable, List

from ..stats import events as _events
from ..stats import metrics as _stats


class FaultInjected(Exception):
    """Raised by the hooks for error/reset/short_read/disk_error kinds;
    carries the HTTP status the fault should surface as.  Converted to
    RpcError (rpc layer) or OSError (disk layer) at the hook site."""

    def __init__(self, rule_id: str, kind: str, status: int = 503):
        super().__init__(f"injected fault [{rule_id}] kind={kind}")
        self.rule_id = rule_id
        self.kind = kind
        self.status = status


KINDS = ("latency", "error", "reset", "short_read", "disk_error")


class FaultRule:
    __slots__ = ("id", "kind", "pct", "ms", "status", "dst", "route",
                 "side", "times", "nbytes", "matches", "fires")

    def __init__(self, kind: str, id: str = "", pct: float = 100.0,
                 ms: float = 0.0, status: int = 503, dst: str = "*",
                 route: str = "*", side: str = "any", times: int = 0,
                 nbytes: int = 0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.kind = kind
        self.id = id or kind
        self.pct = pct
        self.ms = ms
        self.status = status
        self.dst = dst
        self.route = route
        self.side = side
        self.times = times
        self.nbytes = nbytes  # short_read cut point (0 = half the body)
        self.matches = 0  # events that matched the filters
        self.fires = 0    # events where the hash said "fire"

    def accepts(self, side: str, dst: str, route: str) -> bool:
        if self.side not in ("any", side):
            return False
        if self.times and self.fires >= self.times:
            return False
        return fnmatch.fnmatchcase(dst, self.dst) and \
            fnmatch.fnmatchcase(route, self.route)

    def to_dict(self) -> dict:
        return {"id": self.id, "kind": self.kind, "pct": self.pct,
                "ms": self.ms, "status": self.status, "dst": self.dst,
                "route": self.route, "side": self.side,
                "times": self.times, "bytes": self.nbytes,
                "matches": self.matches, "fires": self.fires}


def _decision(seed: int, rule_id: str, n: int) -> float:
    """Pure [0,1) decision value for the n-th event matching a rule.
    blake2b of (seed, rule_id, n): replayable independently of thread
    scheduling across rules, unlike a shared RNG stream."""
    h = hashlib.blake2b(f"{seed}:{rule_id}:{n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


def parse_spec(spec: str) -> List[FaultRule]:
    rules: List[FaultRule] = []
    for i, part in enumerate(p.strip() for p in spec.split(";")):
        if not part:
            continue
        tokens = [t.strip() for t in part.split(",") if t.strip()]
        kind, kv = tokens[0], {}
        for tok in tokens[1:]:
            k, _, v = tok.partition("=")
            kv[k.strip()] = v.strip()
        rules.append(FaultRule(
            kind,
            id=kv.get("id", f"{kind}#{i}"),
            pct=float(kv.get("pct", 100)),
            ms=float(kv.get("ms", 0)),
            status=int(kv.get("status", 503)),
            dst=kv.get("dst", "*"),
            route=kv.get("route", "*"),
            side=kv.get("side", "any"),
            times=int(kv.get("times", 0)),
            nbytes=int(kv.get("bytes", 0))))
    return rules


class FaultRegistry:
    """Process-wide rule set + deterministic decision log."""

    LOG_MAX = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.rules: List[FaultRule] = []
        self.seed = 0
        self.log: List[tuple] = []  # (rule_id, n, side, dst, route, kind)
        # injectable so tests drive latency with a fake clock
        self.sleep: Callable[[float], None] = time.sleep
        self._loaded_env = False

    # -- configuration ---------------------------------------------------

    def configure(self, spec: str, seed: int = 0):
        rules = parse_spec(spec)
        with self._lock:
            self.rules = rules
            self.seed = seed
            self.log = []
        _set_active(bool(rules))
        if rules:
            _events.emit(_events.FAULTS_ACTIVE, service="faults",
                         detail={"rules": len(rules), "seed": seed})

    def add_rule(self, spec: str):
        rules = parse_spec(spec)
        with self._lock:
            self.rules.extend(rules)
        _set_active(True)

    def clear(self):
        with self._lock:
            self.rules = []
            self.log = []
        _set_active(False)

    def reset_counters(self):
        """Rewind match/fire counters + log so the same rule set replays
        the identical sequence (decisions are f(seed, rule, n))."""
        with self._lock:
            for r in self.rules:
                r.matches = r.fires = 0
            self.log = []

    def load_env(self, force: bool = False):
        """Pick up WEED_FAULTS/WEED_FAULTS_SEED once per process (or
        again with force=True after the env changed)."""
        if self._loaded_env and not force:
            return
        self._loaded_env = True
        spec = os.environ.get("WEED_FAULTS", "")
        if spec:
            self.configure(spec,
                           int(os.environ.get("WEED_FAULTS_SEED", "0")))

    # -- event evaluation ------------------------------------------------

    def _fired(self, side: str, dst: str, route: str
               ) -> List[FaultRule]:
        fired = []
        with self._lock:
            for rule in self.rules:
                if not rule.accepts(side, dst, route):
                    continue
                rule.matches += 1
                n = rule.matches
                if _decision(self.seed, rule.id, n) * 100.0 < rule.pct:
                    rule.fires += 1
                    fired.append(rule)
                    if len(self.log) < self.LOG_MAX:
                        self.log.append((rule.id, n, side, dst, route,
                                         rule.kind))
        for rule in fired:
            _stats.FaultsInjectedCounter.labels(rule.kind, rule.id).inc()
        return fired

    def on_rpc(self, side: str, dst: str, route: str):
        """RPC hook: sleeps for latency rules, raises FaultInjected for
        error/reset kinds, returns a short-read byte cap (or None)."""
        short_read = None
        for rule in self._fired(side, dst, route):
            if rule.kind == "latency":
                self.sleep(rule.ms / 1000.0)
            elif rule.kind == "error":
                raise FaultInjected(rule.id, "error", rule.status)
            elif rule.kind == "reset":
                raise FaultInjected(rule.id, "reset", 503)
            elif rule.kind == "short_read":
                short_read = rule
        return short_read

    def on_disk(self, path: str, op: str):
        """Disk-I/O hook: dst = file path, route = op (read/write/sync).
        disk_error raises OSError; latency rules with side=disk sleep."""
        for rule in self._fired("disk", path, op):
            if rule.kind == "latency":
                self.sleep(rule.ms / 1000.0)
            elif rule.kind in ("error", "disk_error"):
                raise OSError(
                    5, f"injected disk fault [{rule.id}] on {op}")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [r.to_dict() for r in self.rules],
                "log": [{"rule": rid, "n": n, "side": side, "dst": dst,
                         "route": route, "kind": kind}
                        for rid, n, side, dst, route, kind in self.log],
            }


REGISTRY = FaultRegistry()

# hot-path guard: call()/dispatch/disk writes check this single bool
# before paying any lock or match cost
ACTIVE = False


def _set_active(value: bool):
    global ACTIVE
    ACTIVE = value


def on_rpc(side: str, dst: str, route: str):
    """Cheap front door for the rpc layer (no-op unless rules loaded)."""
    if not ACTIVE:
        return None
    return REGISTRY.on_rpc(side, dst, route)


def on_disk(path: str, op: str):
    if not ACTIVE:
        return
    REGISTRY.on_disk(path, op)


def load_env():
    REGISTRY.load_env()


def debug_handler(req):
    """GET/POST /debug/faults — mounted on every daemon.

    GET returns {seed, rules[], log[]}.  POST accepts JSON:
      {"spec": "...", "seed": N}  replace the rule set
      {"add": "rule[;rule]"}      append rules
      {"clear": true}             drop all rules
      {"reset": true}             rewind counters/log for replay
    """
    if req.handler.command == "GET":
        return REGISTRY.snapshot()
    body = req.json()
    if body.get("clear"):
        REGISTRY.clear()
    if body.get("reset"):
        REGISTRY.reset_counters()
    if "spec" in body:
        REGISTRY.configure(body["spec"], int(body.get("seed", 0)))
    elif "add" in body:
        REGISTRY.add_rule(body["add"])
    return REGISTRY.snapshot()


def mount(server):
    """Register the /debug/faults routes on an RpcServer."""
    server.add("GET", "/debug/faults", debug_handler)
    server.add("POST", "/debug/faults", debug_handler)
