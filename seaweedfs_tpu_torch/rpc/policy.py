"""Unified outbound RPC policy: retries, backoff, budgets, breakers,
hedging.

Replaces the ad-hoc failover loops that grew in MasterClient, the
volume server's master loop and the filer fan-outs with one shared
layer:

  * per-route idempotency classification — only idempotent requests
    retry after the send phase (a non-idempotent RPC may already be
    executing on the far side);
  * exponential backoff with FULL jitter (delay = U(0, min(cap,
    base * 2^attempt))) — synchronized retry waves are worse than the
    original failure;
  * a global retry-budget token bucket: every initial request deposits
    a fraction of a token, every retry withdraws one, so retries are
    capped at ~WEED_RPC_RETRY_BUDGET of live traffic and a brown-out
    cannot snowball into a retry storm;
  * per-destination circuit breakers with half-open probing
    (generalizing s3api/circuit_breaker.py's admission idea from
    per-bucket concurrency to per-peer failure state);
  * deadline propagation: deadline_scope() pins an absolute wall-clock
    deadline that call() forwards in X-Deadline and servers enforce, so
    work the client has already given up on is rejected, not executed;
  * hedged requests for idempotent reads: a second copy fired after an
    adaptive p95 delay, first success wins.

Knobs (env, read per call so tests flip them live):
  WEED_RPC_RETRIES        extra attempts for idempotent calls (def 2)
  WEED_RPC_BACKOFF_MS     backoff base (def 25)
  WEED_RPC_BACKOFF_CAP_MS backoff ceiling (def 2000)
  WEED_RPC_RETRY_BUDGET   retry/request token ratio (def 0.2)
  WEED_BREAKER_FAILURES   consecutive failures to open (def 5)
  WEED_BREAKER_OPEN_SECS  open-state cooldown before a probe (def 5)
  WEED_RPC_HEDGE_MS       hedge delay floor / cold default (def 25)

Counterpart of seaweedfs_tpu/rpc/policy.py.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..stats import metrics as _stats
from .http_rpc import (RpcError, call, current_deadline, deadline_scope,
                       in_caller_context)

__all__ = [
    "is_idempotent", "retryable", "backoff_delay", "RetryBudget",
    "Breaker", "BREAKERS", "call_policy", "failover_call",
    "HedgeTracker", "HEDGE", "hedged", "deadline_scope",
]

# test seams: monkeypatch for fake-clock tests (no real sleeps)
sleep = time.sleep
now = time.monotonic


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else default


# -- idempotency classification ----------------------------------------------

# POST routes that are safe to re-send: pure lookups, status probes, and
# replication writes (needle replays dedup via the unchanged-content
# check in write_needle)
_IDEMPOTENT_POST_PREFIXES = (
    "/dir/lookup", "/dir/status", "/vol/status", "/cluster/status",
    "/stats", "/admin/ec/shard_locations",
)


def is_idempotent(method: str, path: str) -> bool:
    if method in ("GET", "HEAD"):
        return True
    if "type=replicate" in path:
        return True
    return any(path.startswith(p) for p in _IDEMPOTENT_POST_PREFIXES)


def retryable(err: Exception) -> bool:
    """Transport failures and overload/unavailable statuses retry;
    permanent 4xxs never do (satellite: RpcError now carries enough to
    tell them apart)."""
    if not isinstance(err, RpcError):
        return False
    if getattr(err, "transport", False):
        return True
    return err.status in (429, 502, 503)


def _dest_failure(err: RpcError) -> bool:
    """Does this error indict the DESTINATION (breaker-relevant)?  A 4xx
    is the caller's problem; the peer answered fine."""
    return getattr(err, "transport", False) or err.status >= 500


def _route_label(path: str) -> str:
    """Bounded-cardinality route label: the path sans query, collapsed
    to '/<fid>' for default-route object paths (digits/commas)."""
    p = path.split("?", 1)[0]
    seg = p.split("/", 2)[1] if "/" in p else p
    if seg and seg[0].isdigit():
        return "/<fid>"
    return "/" + "/".join(p.split("/")[1:3]) if p != "/" else "/"


def backoff_delay(attempt: int, base: Optional[float] = None,
                  cap: Optional[float] = None,
                  rand: Callable[[], float] = random.random) -> float:
    """Full-jitter exponential backoff (seconds) for retry `attempt`
    (1-based)."""
    if base is None:
        base = _env_float("WEED_RPC_BACKOFF_MS", 25.0) / 1000.0
    if cap is None:
        cap = _env_float("WEED_RPC_BACKOFF_CAP_MS", 2000.0) / 1000.0
    return rand() * min(cap, base * (2 ** (attempt - 1)))


class RetryBudget:
    """Token bucket bounding retries to a fraction of live traffic.
    Every initial request deposits `ratio` tokens (clamped to `cap`);
    every retry spends one.  When the bucket is dry the retry is simply
    not attempted — the original error propagates."""

    def __init__(self, ratio: Optional[float] = None, cap: float = 64.0):
        self._lock = threading.Lock()
        self._tokens = cap  # start full: cold-start retries allowed
        self.cap = cap
        self._ratio = ratio

    @property
    def ratio(self) -> float:
        if self._ratio is not None:
            return self._ratio
        return _env_float("WEED_RPC_RETRY_BUDGET", 0.2)

    def on_request(self):
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


BUDGET = RetryBudget()


# -- per-destination circuit breakers ----------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class Breaker:
    """Per-destination failure breaker with half-open probing.  Opens
    after N consecutive destination failures; while open, allow() fails
    fast (no socket).  After the cooldown ONE caller is admitted as a
    probe (half-open); its success closes the breaker, its failure
    re-opens the cooldown."""

    def __init__(self, dst: str, failures: Optional[int] = None,
                 open_secs: Optional[float] = None):
        self.dst = dst
        self._lock = threading.Lock()
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False
        self._threshold = failures
        self._open_secs = open_secs

    @property
    def threshold(self) -> int:
        return self._threshold if self._threshold is not None else \
            _env_int("WEED_BREAKER_FAILURES", 5)

    @property
    def open_secs(self) -> float:
        return self._open_secs if self._open_secs is not None else \
            _env_float("WEED_BREAKER_OPEN_SECS", 5.0)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str):
        self._state = state
        _stats.BreakerStateGauge.labels(self.dst).set(_STATE_VALUE[state])

    def allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now() - self._opened_at >= self.open_secs:
                    self._set_state(HALF_OPEN)
                    self._probing = True
                    return True  # this caller is the probe
                return False
            # HALF_OPEN: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def on_success(self):
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def on_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN or \
                    (self._state == CLOSED and
                     self._failures >= self.threshold):
                self._set_state(OPEN)
                self._opened_at = now()


class _BreakerBoard:
    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: dict[str, Breaker] = {}

    def get(self, dst: str) -> Breaker:
        with self._lock:
            br = self._breakers.get(dst)
            if br is None:
                br = self._breakers[dst] = Breaker(dst)
            return br

    def reset(self):
        with self._lock:
            self._breakers.clear()


BREAKERS = _BreakerBoard()


# -- the unified call wrapper ------------------------------------------------

def call_policy(addr: str, path: str, payload: Optional[dict] = None,
                method: Optional[str] = None, timeout: float = 30.0,
                raw: Optional[bytes] = None,
                headers: Optional[dict] = None, parse: bool = True, *,
                idempotent: Optional[bool] = None,
                retries: Optional[int] = None,
                breaker: bool = True,
                budget: Optional[RetryBudget] = None):
    """call() with the full outbound policy applied: breaker admission,
    classified retries with full-jitter backoff, retry budget, and
    deadline awareness (never sleeps past the propagated deadline)."""
    if method is None:
        method = "POST" if (raw is not None or payload is not None) \
            else "GET"
    if idempotent is None:
        idempotent = is_idempotent(method, path)
    if retries is None:
        retries = _env_int("WEED_RPC_RETRIES", 2) if idempotent else 0
    budget = budget or BUDGET
    br = BREAKERS.get(addr) if breaker else None
    label = _route_label(path)
    last: Optional[RpcError] = None
    for attempt in range(retries + 1):
        if attempt:
            if not retryable(last):
                break
            dl = current_deadline()
            if dl is not None and dl - time.time() <= 0:
                _stats.RpcRetryCounter.labels(label, "deadline").inc()
                break
            if not budget.try_spend():
                _stats.RpcRetryCounter.labels(label, "budget_dry").inc()
                break
            delay = backoff_delay(attempt)
            if dl is not None:
                delay = min(delay, max(0.0, dl - time.time()))
            if delay > 0:
                sleep(delay)
            _stats.RpcRetryCounter.labels(label, "retry").inc()
        if br is not None and not br.allow():
            last = RpcError(f"circuit open to {addr}", 503, addr=addr,
                            route=path, transport=True)
            break  # the same destination stays open for open_secs
        budget.on_request()
        try:
            result = call(addr, path, payload=payload, method=method,
                          timeout=timeout, raw=raw, headers=headers,
                          parse=parse)
        except RpcError as e:
            last = e
            if br is not None:
                if _dest_failure(e):
                    br.on_failure()
                else:
                    br.on_success()
            continue
        if br is not None:
            br.on_success()
        return result
    raise last


def failover_call(addrs: Sequence[str], path: str,
                  payload: Optional[dict] = None,
                  method: Optional[str] = None, timeout: float = 30.0,
                  rounds: int = 2, headers: Optional[dict] = None,
                  parse: bool = True) -> Tuple[object, str]:
    """Ordered failover through `addrs` (first = preferred): try each
    once per round, skipping destinations whose breaker is open (unless
    every breaker is open — then all are tried, someone must probe).
    Full-jitter backoff between rounds only, so a healthy secondary is
    reached with zero added latency.  Returns (result, winning addr)."""
    last: Optional[RpcError] = None
    for rnd in range(rounds):
        if rnd:
            dl = current_deadline()
            delay = backoff_delay(rnd)
            if dl is not None:
                delay = min(delay, max(0.0, dl - time.time()))
            if delay > 0:
                sleep(delay)
        candidates = [a for a in addrs
                      if BREAKERS.get(a).state != OPEN] or list(addrs)
        for addr in candidates:
            try:
                return call_policy(
                    addr, path, payload=payload, method=method,
                    timeout=timeout, headers=headers, parse=parse,
                    retries=0), addr
            except RpcError as e:
                last = e
                if not retryable(e):
                    raise
    raise last


# -- hedged requests ---------------------------------------------------------

class HedgeTracker:
    """Adaptive per-route hedge delay: p95 of a small ring of recent
    latencies, floored at WEED_RPC_HEDGE_MS (also the cold default)."""

    def __init__(self, size: int = 64):
        self._lock = threading.Lock()
        self._rings: dict[str, List[float]] = {}
        self._pos: dict[str, int] = {}
        self.size = size

    def observe(self, key: str, seconds: float):
        with self._lock:
            ring = self._rings.setdefault(key, [])
            if len(ring) < self.size:
                ring.append(seconds)
            else:
                pos = self._pos.get(key, 0)
                ring[pos] = seconds
                self._pos[key] = (pos + 1) % self.size
            self._pos.setdefault(key, 0)

    def delay(self, key: str) -> float:
        floor = _env_float("WEED_RPC_HEDGE_MS", 25.0) / 1000.0
        with self._lock:
            ring = self._rings.get(key)
            if not ring:
                return floor
            s = sorted(ring)
            p95 = s[min(len(s) - 1, int(len(s) * 0.95))]
        return max(floor, p95)


HEDGE = HedgeTracker()


def reset_state():
    """Drop all process-global policy state: circuit breakers, the
    retry-budget bucket, and the hedge latency rings.  For bench/test
    phase isolation — breakers and budgets are keyed by address, and a
    later phase reusing an ephemeral port (or sharing the process) must
    not inherit an earlier phase's failures."""
    BREAKERS.reset()
    with BUDGET._lock:
        BUDGET._tokens = BUDGET.cap
    with HEDGE._lock:
        HEDGE._rings.clear()
        HEDGE._pos.clear()


def hedged(key: str, attempts: Sequence[Callable[[], object]]):
    """Run attempts[0]; if it hasn't answered after the adaptive p95
    delay (or fails), fire the next attempt.  First success wins, losers
    are abandoned (their sockets drain in their own threads).  Only for
    idempotent reads.  Raises the last error if all attempts fail."""
    if not attempts:
        raise ValueError("hedged: no attempts for %s" % key)
    if len(attempts) == 1:
        return attempts[0]()
    results: "queue.Queue[tuple]" = queue.Queue()
    label = _route_label(key)
    # racer threads have fresh locals: carry the caller's deadline and
    # QoS context over, same rule as the server dispatch loop
    @in_caller_context
    def run(i: int, fn: Callable[[], object]):
        t0 = now()
        try:
            results.put((True, fn(), i, now() - t0))
        except Exception as e:
            results.put((False, e, i, now() - t0))

    delay = HEDGE.delay(key)
    launched = 1
    threading.Thread(target=run, args=(0, attempts[0]),
                     daemon=True).start()
    pending, last_err = 1, None
    while pending:
        try:
            timeout = delay if launched < len(attempts) else None
            ok, value, i, took = results.get(timeout=timeout)
        except queue.Empty:
            # primary is slow: fire the hedge
            threading.Thread(target=run,
                             args=(launched, attempts[launched]),
                             daemon=True).start()
            _stats.RpcHedgeCounter.labels(label, "fired").inc()
            launched += 1
            pending += 1
            continue
        pending -= 1
        if ok:
            HEDGE.observe(key, took)
            if i > 0:
                _stats.RpcHedgeCounter.labels(label, "win").inc()
            return value
        last_err = value
        if launched < len(attempts):  # fail fast: next attempt now
            threading.Thread(target=run,
                             args=(launched, attempts[launched]),
                             daemon=True).start()
            _stats.RpcHedgeCounter.labels(label, "fired").inc()
            launched += 1
            pending += 1
    raise last_err
