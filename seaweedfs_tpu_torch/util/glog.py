"""Leveled verbose logging, modeled on the reference's vendored glog
(/root/reference/weed/glog: leveled V(n) guards, vmodule per-file
overrides, severity thresholds, optional file rotation).

Idiomatic-Python shape: module-level severity functions plus a ``v(n)``
guard that is cheap when disabled.  Verbosity is configured globally
(``set_verbosity``) or per-module (``set_vmodule("volume*=3")``), matching
the reference's ``-v`` and ``-vmodule`` flags (glog.go).

The port's own copy of seaweedfs_tpu/util/glog.py.
"""

from __future__ import annotations

import fnmatch
import os
import sys
import threading
import time

_lock = threading.Lock()
_verbosity = 0
_vmodule: list[tuple[str, int]] = []  # (pattern, level)
_min_severity = 0  # 0=INFO 1=WARNING 2=ERROR 3=FATAL
_out = sys.stderr
_SEVERITIES = "IWEF"


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def set_vmodule(spec: str) -> None:
    """"volume*=3,needle=1" — per-module verbosity overrides."""
    global _vmodule
    mods = []
    for part in spec.split(","):
        if not part.strip():
            continue
        pattern, _, level = part.partition("=")
        mods.append((pattern.strip(), int(level or 0)))
    with _lock:
        _vmodule = mods


def set_severity_threshold(severity: str) -> None:
    global _min_severity
    _min_severity = _SEVERITIES.index(severity[0].upper())


def set_output(stream) -> None:
    global _out
    _out = stream


def _caller_module(depth: int = 3) -> str:
    frame = sys._getframe(depth)
    return os.path.splitext(
        os.path.basename(frame.f_code.co_filename))[0]


class _VLog:
    """Result of v(n): truthy if enabled; .info() emits at INFO."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __bool__(self) -> bool:
        return self.enabled

    def info(self, *args) -> None:
        if self.enabled:
            _emit(0, " ".join(str(a) for a in args), depth=2)

    def infof(self, fmt: str, *args) -> None:
        if self.enabled:
            _emit(0, fmt % args if args else fmt, depth=2)


def v(level: int) -> _VLog:
    if level <= _verbosity:
        return _VLog(True)
    if _vmodule:
        mod = _caller_module(depth=2)
        with _lock:
            for pattern, lvl in _vmodule:
                if fnmatch.fnmatch(mod, pattern):
                    return _VLog(level <= lvl)
    return _VLog(False)


_tracing = None


def _trace_prefix() -> str:
    """"[trace_id] " when the calling thread carries a SAMPLED span, so
    slow-trace promotion (WEED_TRACE_SLOW_MS) cross-references straight
    into daemon logs.  Unsampled spans stay silent: the id would never
    appear in /debug/traces, so it is noise."""
    global _tracing
    if _tracing is None:
        try:
            from .. import tracing as _t
        except ImportError:  # pragma: no cover - partial teardown
            return ""
        _tracing = _t
    sp = _tracing.current()
    if sp is not None and sp.sampled:
        return "[%s] " % sp.trace_id
    return ""


def _emit(severity: int, message: str, depth: int = 3) -> None:
    if severity < _min_severity:
        return
    now = time.time()
    tm = time.localtime(now)
    frame = sys._getframe(depth)
    where = "%s:%d" % (os.path.basename(frame.f_code.co_filename),
                       frame.f_lineno)
    line = "%s%02d%02d %02d:%02d:%02d.%06d %5d %s] %s%s\n" % (
        _SEVERITIES[severity], tm.tm_mon, tm.tm_mday, tm.tm_hour, tm.tm_min,
        tm.tm_sec, int((now % 1) * 1e6), threading.get_ident() % 100000,
        where, _trace_prefix(), message)
    with _lock:
        _out.write(line)
        _out.flush()


def info(*args) -> None:
    _emit(0, " ".join(str(a) for a in args), depth=2)


def infof(fmt: str, *args) -> None:
    _emit(0, fmt % args if args else fmt, depth=2)


def warning(*args) -> None:
    _emit(1, " ".join(str(a) for a in args), depth=2)


def warningf(fmt: str, *args) -> None:
    _emit(1, fmt % args if args else fmt, depth=2)


def error(*args) -> None:
    _emit(2, " ".join(str(a) for a in args), depth=2)


def errorf(fmt: str, *args) -> None:
    _emit(2, fmt % args if args else fmt, depth=2)


def fatal(*args) -> None:
    _emit(3, " ".join(str(a) for a in args), depth=2)
    raise SystemExit(255)


def fatalf(fmt: str, *args) -> None:
    _emit(3, fmt % args if args else fmt, depth=2)
    raise SystemExit(255)
