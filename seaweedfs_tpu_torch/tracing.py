"""Distributed request tracing with hot-path span profiling.

One client request fans out across master, filer, volume and s3 daemons
over rpc/http_rpc.py; before this module each subsystem grew its own
ad-hoc stage stats (encode stage_stats, RecoverStats) and nothing tied a
slow reply to the hop or kernel stage that caused it.  Here:

  * trace context (trace id, parent span id, sampling bit) rides every
    outbound ``call``/``call_stream`` as ``X-Trace-Id`` / ``X-Span-Id`` /
    ``X-Trace-Sampled`` headers and is extracted in ``RpcServer``
    dispatch, so spans from all daemons in a request share one trace;
  * hot paths (needle read/write, fsync group commit, chunk assembly,
    EC encode stages, degraded-read fetch/decode/serve, a shard span
    fetched from a peer, ``ec.peer_read``) open child spans under the
    enclosing server span;
  * a process-wide bounded recorder keeps whole traces: every sampled
    trace (probability ``WEED_TRACE_SAMPLE``), plus — always on — any
    trace containing a span slower than ``WEED_TRACE_SLOW_MS``.  Fast
    unsampled spans bypass the recorder entirely, so the steady-state
    cost with sampling off is just the duration measurement; a slow
    span promotes its trace from that span onward;
  * ``GET /debug/traces`` (recent index) and ``GET /debug/traces/<id>``
    (full span tree) are mounted on every daemon.

Counterpart of seaweedfs_tpu/tracing.py.

The daemons share one process in tests/bench (like stats.REGISTRY), so
the recorder is process-global and spans carry a ``service`` label —
"spans two daemons" means two distinct services in one trace.

Knobs (env, read live so daemons/tests flip them without restarts):
  WEED_TRACE_SAMPLE      probability a new trace is kept (default 0.01)
  WEED_TRACE_SLOW_MS     always-keep threshold per span (default 250)
  WEED_TRACE_MAX_TRACES  recorder trace capacity (default 256)
  WEED_TRACE_MAX_SPANS   per-trace span cap (default 512)
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Optional

from .stats import metrics as _stats

TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"
SAMPLED_HEADER = "X-Trace-Sampled"
SRC_HEADER = "X-Trace-Src"


# The knobs below are read on every span, which on the gateway hot path
# means several os.environ round-trips (str encode + wrapper dict) per
# request.  They must stay *live* (tests flip them mid-process), so the
# parse is memoized against the raw env value: same raw -> cached parse,
# changed raw -> reparse.  CPython keeps the authoritative bytes mapping
# in os.environ._data and os.environ.__setitem__ writes through to it,
# so a direct .get() there is live and one C dict lookup.
_ENV_DATA = getattr(os.environ, "_data", None)
_env_memo: dict = {}


def _env_live(key: str, key_b: bytes, parse, default):
    if _ENV_DATA is not None:
        raw = _ENV_DATA.get(key_b)
    else:  # non-CPython fallback
        raw = os.environ.get(key)
    memo = _env_memo.get(key)
    if memo is not None and memo[0] == raw:
        return memo[1]
    try:
        val = parse(raw) if raw else default
    except ValueError:
        val = default
    _env_memo[key] = (raw, val)
    return val


def sample_rate() -> float:
    return _env_live("WEED_TRACE_SAMPLE", b"WEED_TRACE_SAMPLE",
                     lambda raw: min(1.0, max(0.0, float(raw))), 0.01)


def slow_ms() -> float:
    return _env_live("WEED_TRACE_SLOW_MS", b"WEED_TRACE_SLOW_MS",
                     float, 250.0)


def _env_int(name: str, default: int) -> int:
    return _env_live(name, name.encode(), int, default)


# Sequential ids from a random 63-bit start: unique within the process
# (cross-process traces already share ids via the propagation headers)
# and much cheaper than 64 fresh random bits per span.
_ids = itertools.count(random.getrandbits(62))


def _new_id() -> str:
    return f"{next(_ids):016x}"


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "status", "tags", "start_ts", "duration", "sampled",
                 "is_root", "route", "mono_start_ns")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, service: str,
                 sampled: bool, is_root: bool,
                 tags: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        # the enclosing RPC route ("GET /dir/assign"); dispatch spans
        # are born with name==route, children inherit it in start() —
        # this is what lets the profiler slice samples per route
        self.route = name
        self.status = "ok"
        self.tags = tags
        self.start_ts = time.time()
        self.duration: Optional[float] = None
        self.sampled = sampled
        self.is_root = is_root
        # the start on time.perf_counter_ns(), the clock a benchmark ties
        # to the device trace; start_ts (wall time) is for reading
        self.mono_start_ns = time.perf_counter_ns()

    def set_tag(self, key: str, value):
        if self.tags is None:
            self.tags = {}
        self.tags[key] = value

    def backdate(self, seconds: float):
        """Move the span's start `seconds` earlier, on both clocks."""
        self.start_ts -= seconds
        self.mono_start_ns -= int(seconds * 1e9)

    def finish(self, status: Optional[str] = None,
               duration: Optional[float] = None):
        """Close the span and hand it to the recorder.  ``duration``
        overrides the measured wall time (spans synthesised from
        externally-measured stage timers)."""
        if self.duration is not None:
            return  # already finished
        if status is not None:
            self.status = status
        self.duration = (
            duration if duration is not None
            else (time.perf_counter_ns() - self.mono_start_ns) * 1e-9)
        RECORDER.record(self)

    def to_dict(self) -> dict:
        out = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "status": self.status,
            "start": round(self.start_ts, 6),
            "mono_start_ns": self.mono_start_ns,
            "duration_ms": round((self.duration or 0.0) * 1000.0, 3),
        }
        if self.tags:
            out["tags"] = self.tags
        return out


_ctx = threading.local()

# mirror of every thread's installed span, keyed by thread ident.  The
# profiler samples OTHER threads' stacks from its own thread, where
# threading.local is unreadable — swap()/restore() keep this map exact
# (same writers, same order), and the sampler prunes dead idents.
_thread_spans: dict = {}


def current() -> Optional[Span]:
    return getattr(_ctx, "span", None)


def swap(span: Optional[Span]) -> Optional[Span]:
    """Install `span` as the thread's current span; returns the previous
    one for restore() (the non-context-manager form used by the server
    dispatch loop)."""
    prev = getattr(_ctx, "span", None)
    _ctx.span = span
    if span is not None:
        _thread_spans[threading.get_ident()] = span
    else:
        _thread_spans.pop(threading.get_ident(), None)
    return prev


def restore(prev: Optional[Span]):
    _ctx.span = prev
    if prev is not None:
        _thread_spans[threading.get_ident()] = prev
    else:
        _thread_spans.pop(threading.get_ident(), None)


def span_for_thread(tid: int) -> Optional[Span]:
    """The span installed on thread `tid`, if any (profiler cross-thread
    read; racy by design — a stale span only mislabels one sample)."""
    return _thread_spans.get(tid)


def prune_thread_spans(live_tids):
    """Drop mirror entries for threads that no longer exist (a pool
    thread that died with a span installed would pin it forever)."""
    dead = [tid for tid in list(_thread_spans) if tid not in live_tids]
    for tid in dead:
        _thread_spans.pop(tid, None)


def start(name: str, service: str = "", parent: Optional[Span] = None,
          tags: Optional[dict] = None) -> Span:
    """Create (but do not install) a span.  With no parent — explicit or
    thread-local — a new root trace starts and takes its sampling
    decision."""
    if parent is None:
        parent = current()
    if parent is not None:
        sp = Span(parent.trace_id, _new_id(), parent.span_id, name,
                  service or parent.service, parent.sampled, False, tags)
        sp.route = parent.route  # children keep the request route
        return sp
    return Span(_new_id(), _new_id(), None, name, service,
                random.random() < sample_rate(), True, tags)


def from_headers(name: str, service: str, headers) -> Span:
    """Server-side extraction: continue the caller's trace when the
    propagation headers are present, else open a new root."""
    trace_id = headers.get(TRACE_HEADER)
    if trace_id:
        return Span(trace_id, _new_id(), headers.get(SPAN_HEADER), name,
                    service, headers.get(SAMPLED_HEADER) == "1", False)
    return Span(_new_id(), _new_id(), None, name, service,
                random.random() < sample_rate(), True)


def tag_qos(span: Span, qos_class: str, tenant: str = "") -> None:
    """Stamp a span with its QoS class.  Background spans get a route
    suffix so the profiler's per-route sample shares (and `weed.py
    profile`) separate background CPU time — replication fan-out,
    curator jobs, deep scrub — from foreground request handling.
    Children inherit the suffixed route via start()."""
    if qos_class and qos_class != "standard":
        span.set_tag("qos_class", qos_class)
    if tenant:
        span.set_tag("qos_tenant", tenant)
    if qos_class == "background" and not span.route.endswith(" [bg]"):
        span.route = span.route + " [bg]"


def inject(headers: dict, span: Optional[Span] = None) -> dict:
    """Stamp the propagation headers for an outbound call (no-op when
    the calling thread carries no span)."""
    sp = span if span is not None else current()
    if sp is not None:
        headers.setdefault(TRACE_HEADER, sp.trace_id)
        headers.setdefault(SPAN_HEADER, sp.span_id)
        headers.setdefault(SAMPLED_HEADER, "1" if sp.sampled else "0")
        if sp.service:
            headers.setdefault(SRC_HEADER, sp.service)
    return headers


class _SpanCtx:
    """Class-based context manager: @contextmanager allocates a
    generator + _GeneratorContextManager per use, which shows up on the
    request hot path (two spans per gateway request)."""

    __slots__ = ("sp", "prev")

    def __init__(self, sp: Span):
        self.sp = sp

    def __enter__(self) -> Span:
        self.prev = swap(self.sp)
        return self.sp

    def __exit__(self, exc_type, exc, tb):
        sp = self.sp
        if exc_type is not None:
            sp.status = f"error: {exc_type.__name__}"
        restore(self.prev)
        sp.finish()
        return False


def span(name: str, service: str = "", parent: Optional[Span] = None,
         tags: Optional[dict] = None) -> _SpanCtx:
    """Open a child span of the thread's current (or explicit `parent`)
    span for the duration of the block.  Pass `parent` explicitly when
    the work runs on a pool thread that did not inherit the request
    thread's context (chunk fan-outs)."""
    return _SpanCtx(start(name, service, parent, tags))


def record_span(name: str, duration: float, service: str = "",
                parent: Optional[Span] = None, tags: Optional[dict] = None,
                status: str = "ok") -> Span:
    """Adopt an externally-measured duration as a finished span (the
    bridge for stage timers aggregated outside a with-block, e.g. the
    encode pipeline's per-stage busy seconds)."""
    sp = start(name, service, parent, tags)
    sp.backdate(duration)
    sp.finish(status=status, duration=duration)
    return sp


def span_between(name: str, t0_ns: int, t1_ns: int, parent: Span,
                 tags: Optional[dict] = None) -> Span:
    """A finished child span over [t0_ns, t1_ns] of perf_counter_ns, not
    yet handed to the recorder: finish_tree records it after its root."""
    sp = start(name, parent=parent, tags=tags)
    sp.start_ts -= (sp.mono_start_ns - t0_ns) * 1e-9
    sp.mono_start_ns = t0_ns
    sp.duration = (t1_ns - t0_ns) * 1e-9
    return sp


def finish_tree(root: Span, children: list):
    """Finish `root`, then record its finished `children` (span_between).
    Retention is decided at the root: a fast unsampled child recorded
    before it is dropped (Recorder.record's fast path), so a slow root
    would keep its trace without them.  After a kept root the children
    join its trace (up to WEED_TRACE_MAX_SPANS, the rest counted as
    truncated); after a dropped one they are dropped too."""
    root.finish()
    for sp in children:
        RECORDER.record(sp)


class Recorder:
    """Bounded process-wide trace store.  Sampled traces and traces that
    ever contained a slow span are kept; other traces buffer until their
    root span finishes and are then discarded.  Both the trace count and
    the per-trace span count are capped, so memory is bounded no matter
    the request rate."""

    def __init__(self, max_traces: Optional[int] = None,
                 max_spans: Optional[int] = None):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self.max_traces = max_traces
        self.max_spans = max_spans

    def _caps(self) -> tuple[int, int]:
        return (self.max_traces or _env_int("WEED_TRACE_MAX_TRACES", 256),
                self.max_spans or _env_int("WEED_TRACE_MAX_SPANS", 512))

    def record(self, span: Span):
        slow = (span.duration or 0.0) * 1000.0 >= slow_ms()
        if not span.sampled and not slow and \
                span.trace_id not in self._traces:
            # Fast path for the steady state with sampling off: the
            # span can neither start nor join a kept trace, so skip
            # the lock + buffer entirely.  A later slow span still
            # promotes its trace from that point on; the pre-slow fast
            # spans of such a trace are the (deliberate) fidelity cost.
            if span.is_root:
                _stats.TraceRetentionCounter.labels("dropped").inc()
            return
        max_traces, max_spans = self._caps()
        kept = dropped = False
        with self._lock:
            rec = self._traces.get(span.trace_id)
            if rec is None:
                rec = self._traces[span.trace_id] = {
                    "spans": [], "kept": span.sampled, "slow": False,
                    "truncated": 0, "ts": span.start_ts}
            else:
                self._traces.move_to_end(span.trace_id)
                rec["ts"] = max(rec["ts"], span.start_ts)
            if len(rec["spans"]) < max_spans:
                rec["spans"].append(span)
            else:
                rec["truncated"] += 1
            if span.sampled:
                rec["kept"] = True
            if slow:
                rec["kept"] = rec["slow"] = True
            if span.is_root and not rec["kept"]:
                # fast unsampled trace complete: forget it
                del self._traces[span.trace_id]
                dropped = True
            else:
                kept = span.is_root and rec["kept"]
                while len(self._traces) > max_traces:
                    self._traces.popitem(last=False)
        if dropped:
            _stats.TraceRetentionCounter.labels("dropped").inc()
        elif kept:
            _stats.TraceRetentionCounter.labels("kept").inc()

    def index(self, limit: int = 100) -> list[dict]:
        """Most-recent-first summaries of the kept traces."""
        with self._lock:
            recs = [(tid, rec) for tid, rec in self._traces.items()
                    if rec["kept"]]
        out = []
        for tid, rec in reversed(recs[-limit:]):
            spans = rec["spans"]
            root = next((s for s in spans if s.parent_id is None), None)
            start_ts = min((s.start_ts for s in spans), default=0.0)
            end_ts = max((s.start_ts + (s.duration or 0.0) for s in spans),
                         default=start_ts)
            out.append({
                "trace_id": tid,
                "root": (root or spans[0]).name if spans else "",
                "services": sorted({s.service for s in spans if s.service}),
                "spans": len(spans) + rec["truncated"],
                "duration_ms": round((end_ts - start_ts) * 1000.0, 3),
                "start": round(start_ts, 6),
                "slow": rec["slow"],
            })
        return out

    def get(self, trace_id: str) -> Optional[dict]:
        """Full span tree for one trace: spans whose parent is absent
        (remote or still running) surface as roots."""
        with self._lock:
            rec = self._traces.get(trace_id)
            spans = list(rec["spans"]) if rec else None
        if spans is None:
            return None
        nodes = {s.span_id: dict(s.to_dict(), children=[]) for s in spans}
        roots = []
        for s in sorted(spans, key=lambda s: s.start_ts):
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent else roots).append(node)
        return {"trace_id": trace_id, "spans": len(spans),
                "truncated": rec["truncated"], "slow": rec["slow"],
                "tree": roots}

    def aggregate(self, prefix: str = "") -> dict:
        """Busy seconds + span counts per span name across every
        recorded trace — the trace-derived stage breakdown."""
        with self._lock:
            spans = [s for rec in self._traces.values()
                     for s in rec["spans"]]
        out: dict[str, dict] = {}
        for s in spans:
            if prefix and not s.name.startswith(prefix):
                continue
            agg = out.setdefault(s.name, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += s.duration or 0.0
        for agg in out.values():
            agg["seconds"] = round(agg["seconds"], 6)
        return out

    def reset(self):
        with self._lock:
            self._traces.clear()


RECORDER = Recorder()


def traces_handler(req):
    """RpcServer route for GET /debug/traces (index) and
    GET /debug/traces/<id> (full tree).  Register with the bare prefix —
    longest-prefix matching routes both shapes here."""
    from .rpc.http_rpc import RpcError

    rest = req.path[len("/debug/traces"):].strip("/")
    if not rest:
        try:
            limit = int(req.param("limit") or 100)
        except ValueError:
            limit = 100
        return {"traces": RECORDER.index(limit=limit)}
    tree = RECORDER.get(rest)
    if tree is None:
        raise RpcError(f"trace {rest} not found (evicted or dropped)", 404)
    return tree
