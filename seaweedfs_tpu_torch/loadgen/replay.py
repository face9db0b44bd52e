"""Replay pool: drive a generated schedule against a live cluster.

Open-loop by default (requests fire at their scheduled Poisson arrival
times — late requests fire immediately, they are never dropped), with
a closed-loop mode for max-throughput storms.  Each request runs under
``qos.qos_scope(qos_class, tenant=...)`` so the X-QoS-* headers ride
every hop exactly like production traffic and per-tenant token buckets
see hundreds of distinct keys.

The pool is multi-process capable: ``processes=N`` forks N children,
each replaying a stride-partitioned slice with its own thread pool and
piping its stats back — real client-side parallelism that does not
share the parent's GIL.  ``processes=0`` (default) stays in-process
with threads, which is what the 1-core CI harness can actually use.

The port's own copy of seaweedfs_tpu/loadgen/replay.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .. import qos
from .generators import Request

_CLASSES = {"interactive": None, "standard": None, "background": None}


def percentile(sorted_vals: list[float], p: float) -> float:
    """p in [0,1] over an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(len(sorted_vals) * p) - 1))
    return sorted_vals[idx]


class ReplayStats:
    """Mergeable per-class latency/failure accounting."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: dict[str, list[float]] = {
            c: [] for c in _CLASSES}
        self.failures: dict[str, int] = {c: 0 for c in _CLASSES}
        self.wall_s = 0.0

    def record(self, qos_class: str, seconds: float, ok: bool):
        cls = qos_class if qos_class in self.latencies else "standard"
        with self.lock:
            if ok:
                self.latencies[cls].append(seconds)
            else:
                self.failures[cls] += 1

    def merge(self, other: dict):
        with self.lock:
            for cls, vals in other.get("latencies", {}).items():
                self.latencies.setdefault(cls, []).extend(vals)
            for cls, n in other.get("failures", {}).items():
                self.failures[cls] = self.failures.get(cls, 0) + n

    def to_dict(self) -> dict:
        with self.lock:
            return {"latencies": {c: list(v)
                                  for c, v in self.latencies.items()},
                    "failures": dict(self.failures)}

    def summary(self) -> dict:
        with self.lock:
            all_lat = sorted(v for vals in self.latencies.values()
                             for v in vals)
            by_class = {}
            for cls, vals in self.latencies.items():
                vals = sorted(vals)
                by_class[cls] = {
                    "requests": len(vals),
                    "failures": self.failures.get(cls, 0),
                    "p50_ms": round(percentile(vals, 0.50) * 1e3, 3),
                    "p99_ms": round(percentile(vals, 0.99) * 1e3, 3),
                }
            n = len(all_lat)
            failures = sum(self.failures.values())
            return {
                "requests": n, "failures": failures,
                "wall_s": round(self.wall_s, 3),
                "rps": round(n / self.wall_s, 1) if self.wall_s else 0.0,
                "p50_ms": round(percentile(all_lat, 0.50) * 1e3, 3),
                "p99_ms": round(percentile(all_lat, 0.99) * 1e3, 3),
                "by_class": by_class,
            }


def _replay_slice(schedule: list[Request],
                  send: Callable[[Request], bool],
                  stats: ReplayStats, start: float, time_scale: float,
                  open_loop: bool,
                  stop: Optional[threading.Event] = None):
    for req in schedule:
        if stop is not None and stop.is_set():
            return
        if open_loop:
            delay = start + req.t * time_scale - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        t0 = time.perf_counter()
        ok = False
        try:
            with qos.qos_scope(req.qos_class, tenant=req.tenant):
                ok = bool(send(req))
        except Exception:
            ok = False
        stats.record(req.qos_class, time.perf_counter() - t0, ok)


def _replay_threads(schedule: list[Request],
                    send: Callable[[Request], bool], workers: int,
                    time_scale: float, open_loop: bool,
                    stop: Optional[threading.Event] = None
                    ) -> ReplayStats:
    stats = ReplayStats()
    start = time.monotonic()
    workers = max(1, workers)
    slices = [schedule[i::workers] for i in range(workers)]
    threads = [threading.Thread(
        target=_replay_slice,
        args=(s, send, stats, start, time_scale, open_loop, stop),
        name=f"loadgen-{i}", daemon=True)
        for i, s in enumerate(slices) if s]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats.wall_s = time.monotonic() - start
    return stats


def replay(schedule: list[Request], send: Callable[[Request], bool],
           workers: int = 8, processes: int = 0,
           time_scale: float = 1.0, open_loop: bool = True,
           stop: Optional[threading.Event] = None) -> dict:
    """Replay `schedule`, calling ``send(req) -> bool`` per request.

    Returns the merged summary dict (requests/failures/rps/p50/p99
    overall and by QoS class).  With ``processes > 0`` the schedule is
    stride-partitioned across forked children (each running `workers`
    threads); exceptions from `send` count as failures, never abort
    the replay."""
    if not schedule:
        return ReplayStats().summary()
    if processes and processes > 1:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        t_wall = time.monotonic()
        pipes, procs = [], []
        for i in range(processes):
            part = schedule[i::processes]
            if not part:
                continue
            rx, tx = ctx.Pipe(duplex=False)

            def child(part=part, tx=tx):
                st = _replay_threads(part, send, workers, time_scale,
                                     open_loop)
                tx.send(st.to_dict())
                tx.close()

            p = ctx.Process(target=child, daemon=True)
            p.start()
            pipes.append(rx)
            procs.append(p)
        merged = ReplayStats()
        for rx in pipes:
            try:
                merged.merge(rx.recv())
            except EOFError:
                pass  # child died; its requests count as unrecorded
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        merged.wall_s = time.monotonic() - t_wall
        return merged.summary()
    stats = _replay_threads(schedule, send, workers, time_scale,
                            open_loop, stop)
    return stats.summary()
