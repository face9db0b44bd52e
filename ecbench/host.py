"""What the host was doing around a run's window: diagnostics, not metrics.

Each reading comes from this process's own files and from `/proc`, and
changes nothing: no cache is dropped, no file written, no other process
touched.  A `/proc` file that the kernel (or a sandbox's kernel) does not
keep leaves its readings out.

  sample()     at the window's open and close: `/proc/meminfo` (Cached,
               Dirty, Writeback), the CPU's ticks from `/proc/stat` (steal,
               iowait and the rest), a few `/proc/vmstat` counters
               (writeback, reclaim, compaction, huge pages), the pressure
               stall totals of `/proc/pressure/*` where the kernel keeps
               them, and this process's `getrusage` (CPU seconds, context
               switches, page faults)
  between()    two samples as the window's deltas and shares
  residency()  the share of a file's pages in the page cache, by
               `mincore` over a read-only `mmap` of it (libc through ctypes)
  calls()      a call loop's per-call GiB/s: quartiles, and the GiB/s of
               each tenth of the window by the calls that started in it
"""

from __future__ import annotations

import ctypes
import functools
import mmap
import os
import resource
import statistics
import time

PROC = "/proc"
MEMINFO = ("Cached", "Dirty", "Writeback")
CPU_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
              "steal")
PRESSURE = ("cpu", "io", "memory")
# the kernel's own work a window may share the host with: writeback,
# reclaim, compaction, huge pages, faults
VMSTAT = ("nr_dirtied", "nr_written", "pgscan_kswapd", "pgscan_direct",
          "compact_stall", "compact_daemon_wake", "thp_fault_alloc",
          "thp_collapse_alloc", "pgmajfault", "workingset_refault_file")
GIB = float(1 << 30)

def _lines(name: str) -> list:
    """The lines of `PROC/name`, or none where this kernel (or sandbox)
    does not keep that file."""
    try:
        with open(os.path.join(PROC, name)) as f:
            return f.read().splitlines()
    except OSError:
        return []


def _meminfo() -> dict:
    out = {}
    for line in _lines("meminfo"):
        key, _, rest = line.partition(":")
        if key in MEMINFO:
            out[key + "_kib"] = int(rest.split()[0])
    return out


def _cpu_ticks() -> dict:
    head = (_lines("stat") or [""])[0].split()
    return dict(zip(CPU_FIELDS, (int(v) for v in head[1:1 + len(CPU_FIELDS)])))


def _vmstat() -> dict:
    out = {}
    for line in _lines("vmstat"):
        key, _, v = line.partition(" ")
        if key in VMSTAT:
            out[key] = int(v)
    return out


def _pressure() -> dict:
    """The `some` stall total (microseconds) of each resource, where the
    kernel keeps pressure stall information."""
    out = {}
    for res in PRESSURE:
        for field in (_lines("pressure/" + res) or [""])[0].split()[1:]:
            k, _, v = field.partition("=")
            if k == "total":
                out[res] = int(v)
    return out


def sample() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.monotonic(), "mem": _meminfo(), "cpu": _cpu_ticks(),
            "vmstat": _vmstat(), "pressure_us": _pressure(),
            "rusage": {"utime_s": ru.ru_utime, "stime_s": ru.ru_stime,
                       "nivcsw": ru.ru_nivcsw, "nvcsw": ru.ru_nvcsw,
                       "majflt": ru.ru_majflt, "minflt": ru.ru_minflt}}


def between(a: dict, b: dict) -> dict:
    """The window's host readings from its open (`a`) and close (`b`)
    samples: memory at both ends, the CPU's ticks as shares of all ticks
    in it, stall and rusage deltas."""
    secs = b["t"] - a["t"]
    ticks = {k: b["cpu"][k] - a["cpu"][k] for k in a["cpu"]}
    total = sum(ticks.values())
    out = {"open": a["mem"], "close": b["mem"],
           "cpu_share": ({k: v / total for k, v in ticks.items()}
                         if total > 0 else {}),
           "vmstat": {k: b["vmstat"][k] - a["vmstat"][k]
                      for k in a["vmstat"] if k in b["vmstat"]},
           "rusage": {k: b["rusage"][k] - a["rusage"][k]
                      for k in a["rusage"]}}
    if secs > 0:
        out["pressure_share"] = {
            k: (b["pressure_us"][k] - a["pressure_us"][k]) / 1e6 / secs
            for k in a["pressure_us"] if k in b["pressure_us"]}
    return out


@functools.cache
def _lib():
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.mmap.restype = ctypes.c_void_p
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_ubyte))
    libc.mincore.restype = ctypes.c_int
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    libc.munmap.restype = ctypes.c_int
    return libc


def residency(path: str) -> tuple:
    """(pages in the page cache, pages) of the file at `path`."""
    libc = _lib()
    page = mmap.PAGESIZE
    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        if size == 0:
            return 0, 0
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr in (None, ctypes.c_void_p(-1).value):
            raise OSError(ctypes.get_errno(), "mmap of " + path)
        try:
            n = -(-size // page)
            vec = (ctypes.c_ubyte * n)()
            if libc.mincore(addr, size, vec) != 0:
                raise OSError(ctypes.get_errno(), "mincore of " + path)
            return sum(v & 1 for v in vec), n
        finally:
            libc.munmap(addr, size)
    finally:
        os.close(fd)


def resident_share(paths: list):
    """The share of the pages of all `paths` that sit in the page cache;
    None where the kernel refuses the mapping or the query."""
    try:
        got = [residency(p) for p in paths]
    except OSError:
        return None
    pages = sum(n for _, n in got)
    return sum(r for r, _ in got) / pages if pages else 0.0


def calls(window_calls: list, t_open: float, seconds: float) -> dict:
    """Per-call GiB/s (each call's bytes over its own seconds) of the
    window: the whole window's, quartiles, and by tenth of the window the
    GiB/s of the calls that started in it (None where none did)."""
    rates = [c["bytes"] / GIB / c["s"] for c in window_calls if c["s"] > 0]
    took = sum(c["s"] for c in window_calls)
    out = {"n": len(rates),
           "gib_s": sum(c["bytes"] for c in window_calls) / GIB / took
           if took > 0 else None}
    if len(rates) >= 2:
        out["gib_s_quartiles"] = statistics.quantiles(rates, n=4)
    tenths = [[0, 0.0] for _ in range(10)]
    for c in window_calls:
        k = min(9, max(0, int(10 * (c["t0"] - t_open) / seconds)))
        tenths[k][0] += c["bytes"]
        tenths[k][1] += c["s"]
    out["gib_s_by_tenth"] = [b / GIB / s if s > 0 else None
                             for b, s in tenths]
    return out
