"""The device's timeline, host spans, kernel calls: what a run reads.

The benchmark's own instrumentation: the spans and calls only in
`--trace 1` runs, the timeline in every run on the card (its busy time is
an end-to-end metric, `scrub_card_ms_per_gib`):

  spans    a wrapper around each layer entry of the program that the
           deployment names (module attribute or class method) records
           (name, start, end) on the host clock while the window is open;
  calls    a wrapper around the kernel entry points records each launch's
           shape (p output rows, d input rows, L bytes per row), from which
           the benchmark counts the bytes the kernel has to move (peaks.py);
  timeline torch.profiler (CUPTI) over the window: every kernel, copy and
           memset on the card, bracketed by two markers that also tie the
           trace's clock to the host clock of the spans.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
START, END = "ecbench.window.start", "ecbench.window.end"


class Recorder:
    def __init__(self):
        self.active = False
        self.spans: list = []
        self.calls: dict[str, list] = {}
        self._undo: list = []
        self._lock = threading.Lock()

    def _patch(self, owner, attr: str, wrapper):
        real = owner.__dict__[attr] if isinstance(owner, type) \
            else getattr(owner, attr)
        self._undo.append((owner, attr, real))
        setattr(owner, attr, wrapper(real))

    def wrap_span(self, owner, attr: str, name: str):
        def wrapper(real):
            @functools.wraps(real)
            def spanned(*args, **kwargs):
                if not self.active:
                    return real(*args, **kwargs)
                t0 = time.perf_counter_ns()
                try:
                    return real(*args, **kwargs)
                finally:
                    self.spans.append((name, t0, time.perf_counter_ns()))
            return spanned
        self._patch(owner, attr, wrapper)

    def wrap_kernel(self, owner, attr: str, label: str):
        """Record (p, d, L) of each call of a K1-style entry
        (matrix (p, d), data (d, L)) that runs on the card."""
        self.calls.setdefault(label, [])

        def wrapper(real):
            @functools.wraps(real)
            def counted(matrix, data, *args, **kwargs):
                if self.active and data.device.type == "cuda":
                    p, d = matrix.shape
                    with self._lock:
                        self.calls[label].append(
                            (int(p), int(d), int(data.shape[-1])))
                return real(matrix, data, *args, **kwargs)
            return counted
        self._patch(owner, attr, wrapper)

    def restore(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


class Timeline:
    """torch.profiler over the measured window.  Its preparation, CUPTI's
    (some seconds on the card's host), runs on a thread of its own from
    `prepare()`, beside the set-up; `start()` waits for it and begins the
    trace, on the thread that later closes it."""

    def __init__(self, path: str):
        import torch

        self.torch = torch
        self.path = path
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.host0 = self.host1 = 0
        self._preparing = None

    def prepare(self):
        self._preparing = threading.Thread(target=self.prof.prepare_trace,
                                           name="ecbench-profiler-prepare")
        self._preparing.start()

    def start(self):
        self._preparing.join()
        self.prof.start_trace()

    def open(self):
        with self.torch.profiler.record_function(START):
            self.host0 = time.perf_counter_ns()

    def close(self):
        with self.torch.profiler.record_function(END):
            self.host1 = time.perf_counter_ns()
        self.torch.cuda.synchronize()
        self.prof.stop_trace()
        self.prof.export_chrome_trace(self.path)

    def read(self, spans: list, priority: list) -> dict:
        """busy_s, window_s, device time by operation, and idle time by
        the innermost harness span open on the host meanwhile."""
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        marks = {e["name"]: e["ts"] for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in (START, END)}
        if START not in marks or END not in marks:
            raise RuntimeError("the trace lost the window's markers")
        ws, we = marks[START], marks[END]
        dev, by_name = [], {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = max(e["ts"], ws), min(e["ts"] + e.get("dur", 0), we)
            if b <= a:
                continue
            dev.append((a, b))
            key = short_name(e["name"])
            by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        busy = union(dev)
        idle = subtract([(ws, we)], busy)
        # host clock (ns) -> trace clock (us), through the start marker
        shift = ws - self.host0 / 1000.0
        labelled = {}
        for name in priority:
            cover = union([(t0 / 1000.0 + shift, t1 / 1000.0 + shift)
                           for n, t0, t1 in spans if n == name])
            labelled[name] = length(intersect(idle, cover)) * 1e-6
            idle = subtract(idle, cover)
        labelled["no harness span"] = length(idle) * 1e-6
        return {"busy_s": length(busy) * 1e-6, "window_s": (we - ws) * 1e-6,
                "device_ops": by_name, "idle_by_span": labelled}


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    signature: "void (anonymous namespace)::gf_apply_kernel<1, 16,
    true>(unsigned int const*, ...)" -> "gf_apply_kernel"."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = head.split("<")[0].replace("void ", "").strip()
    return head.split("::")[-1] or name


def union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(x: list, y: list) -> list:
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: list, y: list) -> list:
    """x minus y, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for a, b in x:
        cur = a
        while j < len(y) and y[j][1] <= cur:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            c, d = y[k]
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def length(iv: list) -> float:
    return sum(b - a for a, b in iv)
