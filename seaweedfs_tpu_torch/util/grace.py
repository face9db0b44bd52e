"""Graceful shutdown + profiling hooks (weed/util/grace).

Parity with grace.OnInterrupt / grace.SetupProfiling (util/grace/
signal_handling.go, pprof.go): daemons register cleanup hooks that run
exactly once on SIGINT/SIGTERM or normal exit, and -cpuprofile /
-memprofile flags dump a cProfile trace / tracemalloc snapshot on
shutdown — the Python equivalents of Go's pprof cpu/heap profiles.

The port's own copy of seaweedfs_tpu/util/grace.py.
"""

from __future__ import annotations

import atexit
import signal
import sys
import threading
from typing import Callable, Optional

_hooks: list[Callable[[], None]] = []
# RLock: a signal can land while the main thread holds the lock in
# on_interrupt/_run_hooks; the handler re-enters on the same thread
_hook_lock = threading.RLock()
_installed = False
_ran = False

_cpu_profiler = None
_cpu_profile_path = ""
_mem_profile_path = ""


class SamplingProfiler:
    """pprof-style sampling CPU profiler covering ALL threads.

    cProfile only traces the thread that enabled it — useless for a
    daemon whose work happens on HTTP worker threads while main sits in
    signal.pause().  This delegates to profiling.StackSampler (the same
    folded-stack engine behind /debug/pprof/profile), so the shutdown
    dump is collapsed-stack text that feeds straight into flamegraph.pl
    or speedscope — the old flat leaf-frame report carried no caller
    context."""

    def __init__(self, interval: float = 0.005):
        from .. import profiling

        self.interval = interval
        self._sampler = profiling.StackSampler(hz=1.0 / interval)

    @property
    def total(self) -> int:
        return self._sampler.total

    @property
    def samples(self) -> dict:
        return self._sampler.samples

    def start(self):
        self._sampler.start()

    def stop_and_dump(self, path: str):
        if not self._sampler.stop():
            # the sampler thread is daemonized so it cannot hang exit,
            # but a dump racing one last tick deserves a trace, not
            # silence (the old implementation leaked the thread quietly)
            from . import glog

            glog.warningf("cpu profile sampler did not join in time; "
                          "dump may miss the final tick")
        with open(path, "w") as f:
            f.write(f"# sampling cpu profile: {self.total} samples "
                    f"@ {self.interval * 1000:.1f}ms "
                    f"(collapsed stacks — flamegraph.pl/speedscope)\n")
            f.write(self._sampler.folded())


def on_interrupt(hook: Callable[[], None]):
    """Register a cleanup hook (grace.OnInterrupt); installs the signal
    handlers on first use."""
    global _installed
    with _hook_lock:
        _hooks.append(hook)
        if not _installed:
            _installed = True
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    signal.signal(sig, _handle_signal)
                except ValueError:
                    pass  # not the main thread (tests): atexit covers it
            atexit.register(_run_hooks)


def _run_hooks():
    global _ran
    with _hook_lock:
        if _ran:
            return
        _ran = True
        hooks, _hooks[:] = list(_hooks), []
    _stop_profiling()
    for hook in reversed(hooks):
        try:
            hook()
        except Exception:
            pass


def _handle_signal(signum, frame):
    _run_hooks()
    sys.exit(0)


def setup_profiling(cpu_profile: str = "", mem_profile: str = ""):
    """grace.SetupProfiling: start CPU/heap profiling now, dump on
    shutdown.  The CPU profile samples every thread (flat text report,
    hottest lines first)."""
    global _cpu_profiler, _cpu_profile_path, _mem_profile_path
    if cpu_profile:
        _cpu_profile_path = cpu_profile
        _cpu_profiler = SamplingProfiler()
        _cpu_profiler.start()
    if mem_profile:
        import tracemalloc

        _mem_profile_path = mem_profile
        tracemalloc.start(10)
    if cpu_profile or mem_profile:
        on_interrupt(lambda: None)  # ensure handlers are installed


def _stop_profiling():
    global _cpu_profiler
    if _cpu_profiler is not None:
        _cpu_profiler.stop_and_dump(_cpu_profile_path)
        _cpu_profiler = None
    if _mem_profile_path:
        import tracemalloc

        if tracemalloc.is_tracing():
            snapshot = tracemalloc.take_snapshot()
            with open(_mem_profile_path, "w") as f:
                for stat in snapshot.statistics("lineno")[:100]:
                    f.write(f"{stat}\n")
            tracemalloc.stop()


def _reset_for_tests():
    global _ran, _installed
    with _hook_lock:
        _hooks.clear()
        _ran = False
