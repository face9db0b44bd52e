"""Continuous profiling: folded call stacks and the device telemetry of
the EC pipeline.

Counterpart of seaweedfs_tpu/profiling.py.

  * host side: a sampling profiler over ``sys._current_frames()`` that
    keeps full folded call stacks (``frame.f_back`` walk, bounded
    stack-interning table), tagged with the sampled thread's name and
    the active RPC route from tracing's thread-local span context, so a
    profile slices per daemon, per thread pool and per route.  It runs
    always-on at a low ``WEED_PROF_HZ`` rate once ``ensure_started`` is
    called, and ``profile_burst`` takes an on-demand burst beside it.
    The profiler measures its own duty cycle and exports it as the
    ``SeaweedFS_profiler_overhead_ratio`` gauge;
  * device side: the dispatch-to-ready latency of each EC device batch,
    measured between two CUDA events from the dispatch of its H2D copy to
    its parity being ready on the host, and the analytic cost of each
    parity-step geometry (GF(2^8) multiply-adds and the device bytes it
    reads and writes), exported as the ``ec_kernel_*`` families;
  * cluster side: ``merge_folded`` combines per-daemon profiles under
    per-daemon root frames into one cluster flamegraph.

Every daemon mounts ``GET /debug/pprof`` (``profile?seconds=N&hz=M``,
``heap``, ``device``) through :func:`mount`.

Knobs (env, read live like the WEED_TRACE_* family):
  WEED_PROF_HZ          always-on sampling rate (default 5; 0 disables)
  WEED_PROF_MAX_STACKS  interned-stack table cap (default 8192)
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from . import tracing
from .stats import metrics as _stats

_TRUNCATED = "(truncated)"
_MAX_DEPTH = 64


def prof_hz() -> float:
    return tracing._env_live(
        "WEED_PROF_HZ", b"WEED_PROF_HZ",
        lambda raw: max(0.0, float(raw)), 5.0)


def max_stacks() -> int:
    return tracing._env_live(
        "WEED_PROF_MAX_STACKS", b"WEED_PROF_MAX_STACKS", int, 8192)


# -- folded-stack engine ------------------------------------------------------

# frame labels are interned per (code object, line): the sampler walks
# the same hot frames thousands of times, so the format+basename cost is
# paid once per distinct frame, not per sample
_label_cache: dict = {}


def _frame_label(frame, leaf: bool) -> str:
    co = frame.f_code
    # leaf frames keep the sampled line (hot-line attribution, like the
    # old flat sampler); caller frames use the def line so one function
    # is ONE flamegraph frame no matter which call site is live.
    # f_lineno can be None when the target thread is mid-transition
    # (CPython computes it lazily from f_lasti) — fall back to the def
    # line rather than dropping the whole sample
    lineno = (frame.f_lineno if leaf else None) or co.co_firstlineno
    key = (co, lineno)
    label = _label_cache.get(key)
    if label is None:
        if len(_label_cache) > 4 * max_stacks():
            _label_cache.clear()
        label = "%s (%s:%d)" % (co.co_name,
                                os.path.basename(co.co_filename), lineno)
        label = label.replace(";", ":")  # ';' is the fold separator
        _label_cache[key] = label
    return label


def fold_stack(frame) -> str:
    """Root-first collapsed stack for one thread's current frame."""
    parts = []
    leaf = True
    while frame is not None and len(parts) < _MAX_DEPTH:
        parts.append(_frame_label(frame, leaf))
        leaf = False
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class StackSampler:
    """All-thread folded-stack sampling profiler.

    Samples ``sys._current_frames()`` on a timer like Go's pprof CPU
    profile; each sample's key is ``thread[;route];frame;frame;...`` in
    flamegraph.pl collapsed form.  ``publish=True`` (the always-on
    instance) mirrors per-route sample counts into the Prometheus
    registry.  The sampler measures its own busy time, so its duty
    cycle (``overhead_ratio``) is observable, not guessed."""

    def __init__(self, hz: Optional[float] = None,
                 publish: bool = False, exclude=()):
        self.hz = hz  # None: follow WEED_PROF_HZ live
        self.samples: dict[str, int] = {}
        self.total = 0
        self.truncated = 0
        self.errors = 0
        self.route_samples: dict[str, int] = {}
        self.busy = 0.0
        self.started = 0.0
        self._publish = publish
        self._exclude = set(exclude)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._names: dict[int, str] = {}
        self._ticks = 0

    # -- lifecycle ----------------------------------------------------

    def start(self):
        self.started = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, name="weed-prof", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> bool:
        """Stop sampling; True when the sampler thread actually joined
        (False: it is still finishing one last tick — daemonized, so it
        cannot outlive the process, but the caller should say so)."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def _interval(self) -> float:
        hz = self.hz if self.hz is not None else prof_hz()
        return (1.0 / hz) if hz and hz > 0 else 0.0

    def _loop(self):
        me = threading.get_ident()
        while True:
            interval = self._interval()
            if interval <= 0:  # live-disabled: idle cheaply, stay alive
                if self._stop.wait(0.5):
                    return
                continue
            if self._stop.wait(interval):
                return
            t0 = time.perf_counter()
            try:
                self._sample_once(me)
            except Exception:
                # sampling races against every other thread's execution
                # state; one unreadable tick must not kill the always-on
                # sampler for the remaining process lifetime
                self.errors += 1
            self.busy += time.perf_counter() - t0

    # -- sampling -----------------------------------------------------

    def _sample_once(self, me: int):
        frames = sys._current_frames()
        names = self._names
        if any(tid not in names for tid in frames):
            names = self._names = {
                t.ident: t.name for t in threading.enumerate()}
        self._ticks += 1
        if self._ticks % 128 == 0:
            tracing.prune_thread_spans(frames.keys())
        cap = max_stacks()
        routes = []
        with self._lock:
            for tid, frame in frames.items():
                if tid == me or tid in self._exclude:
                    continue
                sp = tracing.span_for_thread(tid)
                route = (sp.route or "") if sp is not None else ""
                key = "%s;%s" % (names.get(tid) or "thread-%d" % tid,
                                 fold_stack(frame))
                if route:
                    thread, _, rest = key.partition(";")
                    key = "%s;%s;%s" % (thread, route, rest)
                    routes.append(route)
                    self.route_samples[route] = \
                        self.route_samples.get(route, 0) + 1
                if key not in self.samples and len(self.samples) >= cap:
                    self.truncated += 1
                    key = _TRUNCATED
                self.samples[key] = self.samples.get(key, 0) + 1
                self.total += 1
        if self._publish:
            for route in routes:
                _stats.ProfilerRouteSamplesCounter.labels(route).inc()

    # -- reporting ----------------------------------------------------

    def overhead_ratio(self) -> float:
        wall = time.perf_counter() - self.started if self.started else 0.0
        return (self.busy / wall) if wall > 0 else 0.0

    def folded(self, limit: int = 0) -> str:
        """Collapsed-stack text, hottest stacks first — feed directly to
        flamegraph.pl / speedscope."""
        with self._lock:
            items = sorted(self.samples.items(), key=lambda kv: -kv[1])
        if limit:
            items = items[:limit]
        return "".join("%s %d\n" % kv for kv in items)

    def top_frames(self, n: int = 12) -> list[dict]:
        """Self-time ranking by leaf frame (the bench JSON breakdown)."""
        agg: dict[str, int] = {}
        with self._lock:
            total = self.total or 1
            for stack, count in self.samples.items():
                leaf = stack.rsplit(";", 1)[-1]
                agg[leaf] = agg.get(leaf, 0) + count
        ranked = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
        return [{"frame": frame, "samples": count,
                 "pct": round(100.0 * count / total, 1)}
                for frame, count in ranked]

    def snapshot(self) -> dict:
        with self._lock:
            return {"samples": self.total, "stacks": len(self.samples),
                    "truncated": self.truncated, "errors": self.errors,
                    "overhead_ratio": round(self.overhead_ratio(), 6)}


# -- always-on process profiler ----------------------------------------------

_PROFILER: Optional[StackSampler] = None
_prof_lock = threading.Lock()


def ensure_started() -> Optional[StackSampler]:
    """Start the process-wide always-on sampler (idempotent; called by
    every daemon mount).  WEED_PROF_HZ is read live inside the loop, so
    0 parks the thread rather than preventing creation."""
    global _PROFILER
    if _PROFILER is None:
        with _prof_lock:
            if _PROFILER is None:
                prof = StackSampler(hz=None, publish=True)
                prof.start()
                _PROFILER = prof
    return _PROFILER


def profiler() -> Optional[StackSampler]:
    return _PROFILER


def overhead_ratio() -> float:
    prof = _PROFILER
    return prof.overhead_ratio() if prof is not None else 0.0


def stack_count() -> float:
    prof = _PROFILER
    return float(len(prof.samples)) if prof is not None else 0.0


def profile_burst(seconds: float, hz: float, exclude=()) -> str:
    """On-demand burst: a dedicated sampler for `seconds` at `hz`,
    returning collapsed stacks.  Runs beside the always-on sampler
    without disturbing its counters."""
    sampler = StackSampler(hz=hz, publish=False, exclude=exclude)
    sampler.start()
    time.sleep(seconds)
    sampler.stop()
    return sampler.folded()


# -- device kernel timeline ---------------------------------------------------

_tl_lock = threading.Lock()
_DEVICE_TIMELINE: "deque[dict]" = deque(maxlen=512)
_KERNEL_COST: dict[str, dict] = {}
_SCRUB_TOTALS = {"steps": 0, "h2d": 0.0, "kernel": 0.0, "d2h": 0.0}


def record_device_batch(latency_s: float, units: int = 0, k: int = 0,
                        devices: int = 1):
    """One EC device batch completed after `latency_s` seconds, dispatch
    to parity ready, as two CUDA events measured it.
    `devices` is the shard width of the dispatch — the histogram is
    labeled by it, so a stall that only appears at a given mesh width
    shows up as its own latency series."""
    _stats.EcKernelDispatchHistogram.labels(str(devices)).observe(latency_s)
    with _tl_lock:
        _DEVICE_TIMELINE.append({
            "ts": round(time.time(), 3),
            "dispatch_ready_ms": round(latency_s * 1e3, 3),
            "units": units, "k": k, "devices": devices})


def record_scrub_batch(steps: int, h2d: float = 0.0, kernel: float = 0.0,
                       d2h: float = 0.0):
    """One deep-scrub batch completed: its parity-step calls (one K1 launch
    per call for RS(10,4)'s four parity rows) and the seconds its CUDA
    events measured around the H2D, the step and CRC, and the images' D2H
    (none on the CPU).  `device_timeline` reports the process's totals."""
    with _tl_lock:
        _SCRUB_TOTALS["steps"] += steps
        _SCRUB_TOTALS["h2d"] += h2d
        _SCRUB_TOTALS["kernel"] += kernel
        _SCRUB_TOTALS["d2h"] += d2h


def record_kernel_cost(geometry: str, flops: float, bytes_accessed: float,
                       extra: Optional[dict] = None):
    """The analytic cost of one parity-step geometry (from mesh.py):
    GF(2^8) multiply-adds and the device bytes it reads and writes."""
    entry = {"flops": float(flops), "bytes_accessed": float(bytes_accessed)}
    if extra:
        entry.update(extra)
    with _tl_lock:
        _KERNEL_COST[geometry] = entry
    _stats.EcKernelFlopsGauge.labels(geometry).set(float(flops))
    _stats.EcKernelBytesGauge.labels(geometry).set(float(bytes_accessed))


def device_timeline() -> dict:
    """Recent batch latencies, per-geometry step cost, the device pool's
    occupancy snapshot (when a pool exists), and this process's kernel
    launches with the deep scrubs' parity-step calls among them, beside
    the scrubs' device seconds (H2D, kernel, D2H) timed by CUDA events."""
    from .ops import device_pool, rs_cuda

    pool = device_pool._pool  # do not materialize a pool just to report
    with _tl_lock:
        timeline = list(_DEVICE_TIMELINE)
        cost = {k: dict(v) for k, v in _KERNEL_COST.items()}
        scrub = dict(_SCRUB_TOTALS)
    return {"timeline": timeline, "kernel_cost": cost,
            "pool": pool.snapshot() if pool is not None else {},
            "launches": dict(rs_cuda.launches),
            "scrub_steps": scrub.pop("steps"),
            "scrub_device_s": {k: round(v, 6) for k, v in scrub.items()}}


def reset_device_telemetry():
    """Drop the timeline and the cost table."""
    with _tl_lock:
        _DEVICE_TIMELINE.clear()
        _KERNEL_COST.clear()


# -- cluster merge ------------------------------------------------------------

def merge_folded(profiles: dict[str, str]) -> str:
    """Merge per-daemon collapsed-stack texts into one cluster profile:
    each daemon becomes a root frame, identical stacks sum."""
    merged: dict[str, int] = {}
    for daemon in sorted(profiles):
        for line in profiles[daemon].splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stack, _, count = line.rpartition(" ")
            try:
                n = int(count)
            except ValueError:
                continue
            if not stack:
                continue
            key = "%s;%s" % (daemon, stack)
            merged[key] = merged.get(key, 0) + n
    return "".join("%s %d\n" % kv for kv in
                   sorted(merged.items(), key=lambda kv: -kv[1]))


# -- HTTP surface -------------------------------------------------------------

def _heap_text(req) -> str:
    import tracemalloc

    if req.param("stop") == "1":
        if tracemalloc.is_tracing():
            tracemalloc.stop()
        return "# tracemalloc disarmed\n"
    if not tracemalloc.is_tracing():
        # armed on demand: tracing allocations is too costly to leave on
        tracemalloc.start(12)
        return ("# tracemalloc armed (12 frames); re-fetch "
                "/debug/pprof/heap for allocation sites, "
                "?stop=1 to disarm\n")
    try:
        limit = int(req.param("limit") or 50)
    except ValueError:
        limit = 50
    snapshot = tracemalloc.take_snapshot()
    lines = ["# tracemalloc top allocation sites"]
    lines.extend(str(stat) for stat in
                 snapshot.statistics("lineno")[:limit])
    return "\n".join(lines) + "\n"


def pprof_handler(req):
    """RpcServer route for the /debug/pprof family.  Register with the
    bare prefix — longest-prefix matching routes profile/heap/device
    here, like traces_handler."""
    from .rpc.http_rpc import Response, RpcError

    rest = req.path[len("/debug/pprof"):].strip("/")
    if not rest:
        prof = _PROFILER
        return {
            "endpoints": ["/debug/pprof/profile?seconds=N&hz=M",
                          "/debug/pprof/heap", "/debug/pprof/device"],
            "always_on": prof.snapshot() if prof is not None else None,
            "hz": prof_hz(),
        }
    if rest == "profile":
        try:
            seconds = float(req.param("seconds") or 2.0)
        except ValueError:
            seconds = 2.0
        try:
            hz = float(req.param("hz") or 99.0)
        except ValueError:
            hz = 99.0
        seconds = max(0.0, min(seconds, 120.0))
        hz = max(1.0, min(hz, 1000.0))
        if seconds == 0:  # cumulative always-on profile, no wait
            prof = _PROFILER
            if prof is None:
                raise RpcError(
                    "always-on profiler not running; use ?seconds=N", 400)
            text = prof.folded()
        else:
            text = profile_burst(seconds, hz,
                                 exclude={threading.get_ident()})
        return Response(text.encode(),
                        content_type="text/plain; charset=utf-8")
    if rest == "heap":
        return Response(_heap_text(req).encode(),
                        content_type="text/plain; charset=utf-8")
    if rest == "device":
        return device_timeline()
    raise RpcError(f"unknown pprof endpoint {rest!r}", 404)


def mount(server):
    """Register /debug/pprof on an RpcServer and start the always-on
    sampler (every daemon front end calls this, like faults.mount)."""
    server.add("GET", "/debug/pprof", pprof_handler)
    ensure_started()
