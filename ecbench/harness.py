"""One run of one cell: set-up, the measured window, the reference check.

`run()` does everything but the look for a card (run.py's), so that a
test can drive a whole run on the CPU with the port's plain kernels.

The two loops a traffic mix can ask for (its "loop"):

  open    load processes send a fixed schedule (schedule.open_loop) at
          the cell's rate; latency runs from each request's due time;
          the window's requests are all waited for (up to `grace_s`).
  calls   the harness itself calls the deployment's entry back to back
          for the window; the last call runs to its end, and the window
          ends with it.

Every reply and every call's result goes to the deployment's reference
check once the window has closed, the device's peak memory has been read
and the servers are stopped.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import time

from . import faults, host, schedule, spec
from .trace import Recorder, Timeline

WORK = os.path.join(spec.HERE, "_work")
LOADER = os.path.join(spec.HERE, "loader.py")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class Window:
    """Opens and closes the measured window: counters, host spans, the
    device timeline, and the host's readings at both ends (host.py)."""

    def __init__(self, dep, recorder, timeline):
        self.dep, self.recorder, self.timeline = dep, recorder, timeline
        self.before = self.after = None
        self.host_open = self.host_close = None
        self.resident_open = None
        self.t_open = self.t_close = 0.0

    def open(self):
        self.resident_open = host.resident_share(self.dep.shard_files())
        self.before = self.dep.snapshot()
        if self.timeline is not None:
            self.timeline.open()
        if self.recorder is not None:
            self.recorder.active = True
        self.host_open = host.sample()
        self.t_open = time.monotonic()

    def close(self):
        self.t_close = time.monotonic()
        self.host_close = host.sample()
        if self.recorder is not None:
            self.recorder.active = False
        if self.timeline is not None:
            self.timeline.close()
        self.after = self.dep.snapshot()


def _start_loaders(specs: list, workdir: str) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    for i, sp in enumerate(specs):
        sp["out"] = os.path.join(workdir, f"loader{i}.json")
        path = sp["out"] + ".spec"
        with open(path, "w") as f:
            json.dump(sp, f)
        procs.append(subprocess.Popen(
            [sys.executable, LOADER, path], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=workdir, env=env))
    for p in procs:
        if p.stdout.readline().strip() != "ready":
            raise RuntimeError("a load process did not start: "
                               + p.stderr.read()[-2000:])
    return procs


def _go(procs: list, lead: float = 0.25) -> float:
    t0 = time.monotonic() + lead
    for p in procs:
        p.stdin.write(f"go {t0!r}\n")
        p.stdin.flush()
    return t0


def _finish_loaders(procs: list, specs: list, deadline: float) -> list:
    records = []
    for p, sp in zip(procs, specs):
        try:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            raise RuntimeError("a load process outlived the window's grace")
        if p.returncode != 0:
            raise RuntimeError(f"a load process failed: {err[-2000:]}")
        with open(sp["out"]) as f:
            records.extend(json.load(f))
    return records


def _kill(procs: list):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _sleep_until(t: float):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def open_loop(dep, mix: dict, params: dict, seed: int, seconds: float,
              window: Window, workdir: str) -> dict:
    rate, warm = params["rate_per_s"], mix["warmup_s"]
    n = dep.n_keys()
    sched = [(-1 - i, due, rank) for i, (due, rank) in enumerate(
        schedule.open_loop(rate, warm, n, mix["zipf_theta"], seed,
                           "warmup", 0.0))]
    sched += list((i, due, rank) for i, (due, rank) in enumerate(
        schedule.open_loop(rate, seconds, n, mix["zipf_theta"], seed,
                           "window", warm)))
    specs = [{"endpoint": dep.endpoint,
              "conns": mix["conns_per_loader"], "requests": []}
             for _ in range(mix["loaders"])]
    key = {}
    for j, (k, due, rank) in enumerate(sched):
        key[k] = dep.key_of_rank(rank)
        specs[j % len(specs)]["requests"].append(
            [k, due, "GET", dep.path(key[k])])
    procs = _start_loaders(specs, workdir)
    try:
        t0 = _go(procs)
        _sleep_until(t0 + warm)
        window.open()
        records = _finish_loaders(procs, specs,
                                  t0 + warm + seconds + mix["grace_s"])
        window.close()
    finally:
        _kill(procs)
    got = {r[0] for r in records}
    late = [r[2] - r[1] for r in records if r[0] >= 0]
    inwin = [[key[r[0]]] + r[1:] for r in records if r[0] >= 0]
    return {"replies": [[key[r[0]]] + r[1:] for r in records],
            "missing": sum(1 for k in key if k not in got),
            "attempted": sum(1 for k in key if k >= 0),
            "window": inwin,
            "latencies_s": [r[3] - r[1] for r in inwin if r[4] == 200],
            "lateness_s": late}


def call_loop(dep, mix: dict, params: dict, seed: int, seconds: float,
              window: Window, workdir: str) -> dict:
    warm = [dep.scrub_once() for _ in range(mix["warmup_calls"])]
    window.open()
    calls = []
    t = window.t_open
    while t < window.t_open + seconds:
        c = dep.scrub_once()
        now = time.monotonic()
        c["t0"], c["s"] = t, now - t
        calls.append(c)
        t = now
    window.close()
    return {"calls": warm + calls, "window_calls": calls,
            "attempted": len(calls),
            "scrub_bytes": sum(c["bytes"] for c in calls),
            "scrub_s": window.t_close - window.t_open}


LOOPS = {"open": open_loop, "calls": call_loop}


def _device_info(device: str) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out)
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return info


def _deployment(cell: dict, params: dict, seed: int, device: str,
                workdir: str, overrides: dict = None):
    """The cell's deployment object, with the card's kernels built (on a
    checkout's first run) and loaded."""
    cfg = dict(spec.config(cell["config"]), **(overrides or {}))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    if device == "cuda":
        from seaweedfs_tpu_torch.ops import _build as kernels
        from seaweedfs_tpu_torch.ops import native

        kernels.build_all()
        native.lib()
    deploy = importlib.import_module(f"ecbench.deploy.{cfg['deployment']}")
    return deploy.Deployment(cfg, params, seed, device, workdir)


def _build(dep):
    dep.build()
    # set-up's writes reach the disk before the window, so that the
    # kernel's writeback of them does not run inside it
    os.sync()


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", fault: str = None, overrides: dict = None,
        t_start: float = None, workroot: str = WORK,
        params: dict = None) -> dict:
    """One run; returns the result line's object (checks last)."""
    t_start = time.monotonic() if t_start is None else t_start
    bench = spec.benchmark()
    cell = spec.cell(cell_name)
    mix = spec.traffic(cell["traffic"])
    params = params if params is not None else cell.get("params", {})
    workdir = os.path.join(workroot, cell_name)
    if fault:
        faults.install(fault)
    recorder = timeline = None
    if device == "cuda":
        # the card's busy time is an end-to-end metric, so every run on
        # the card traces the window's device operations; the profiler
        # gets ready beside the set-up
        timeline = Timeline(os.path.join(workdir, "trace.json"))
        timeline.prepare()
    dep = _deployment(cell, params, seed, device, workdir, overrides)
    try:
        _build(dep)
        resident_setup = host.resident_share(dep.shard_files())
        if trace:
            recorder = Recorder()
            sites = dep.sites()
            for owner, attr, label in sites["kernels"]:
                recorder.wrap_kernel(owner, attr, label)
            for owner, attr, name in sites["spans"]:
                recorder.wrap_span(owner, attr, name)
        if timeline is not None:
            timeline.start()
        window = Window(dep, recorder, timeline)
        out = LOOPS[mix["loop"]](dep, mix, params, seed, seconds, window,
                                 workdir)
        setup_s = window.t_open - t_start
        device_info = _device_info(device)
        tl = None
        if timeline is not None:
            tl = timeline.read(recorder.spans if recorder else [],
                               span_priority(dep.sites()) if recorder else [])
            if trace:
                device_info["busy_s"] = tl["busy_s"]
                device_info["window_s"] = tl["window_s"]
        dep.stop()
        checks = verify(dep, mix, out, device)
    finally:
        dep.stop()
        if recorder is not None:
            recorder.restore()
    dep.cleanup()
    ctx = {"setup_s": setup_s, "before": window.before,
           "after": window.after, "trace": tl,
           "kernel_calls": recorder.calls if recorder else {},
           "device": device_info, **out}
    metrics = {}
    for m in spec.metrics_for(cell_name, trace, bench):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if mix["loop"] == "calls":
        failed = sum(1 for c in out["window_calls"] if c.get("wrong"))
    else:
        failed = out["missing"] + sum(
            1 for r in out["window"]
            if r[4] != 200 or r[6] != dep.expected_digest(r[0]))
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and tl is not None:
        ops = sorted(tl["device_ops"].items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(tl["idle_by_span"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [["host in " + k, v] for k, v in idle[:10]
                          if v > 0]}
    if "lateness_s" in out and out["lateness_s"]:
        late = sorted(out["lateness_s"])
        result["load"] = {"lateness_p50_ms": 1e3 * late[len(late) // 2],
                          "lateness_max_ms": 1e3 * late[-1]}
    result["host"] = _host_readings(window, out, resident_setup, seconds)
    _diagnose(ctx, result["host"])
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def span_priority(sites: dict) -> list:
    """The span names in the order the idle time is labelled by them,
    innermost first; a name that two sites share is labelled once, at its
    first place."""
    return list(dict.fromkeys(n for _, _, n in sites["spans"]))


# the deep scrub's stage timers whose seconds per GiB scrubbed say which
# stage a slow window lost its time in
STAGE_KEYS = ("wall", "read", "read_busy", "pread", "device_h2d",
              "device_kernel", "encode_crc")


def _host_readings(window: Window, out: dict, resident_setup: float,
                   seconds: float) -> dict:
    """The result line's `host` object: where a run's level may come
    from (host.py); diagnostics, not metrics."""
    got = {"resident_share_setup": resident_setup,
           "resident_share_open": window.resident_open,
           **host.between(window.host_open, window.host_close)}
    calls = out.get("window_calls")
    if calls:
        got["calls"] = host.calls(calls, window.t_open, seconds)
        gib = sum(c["bytes"] for c in calls) / host.GIB
        if gib > 0:
            got["stage_s_per_gib"] = {
                k: sum(c["stats"].get(k, 0.0) for c in calls) / gib
                for k in STAGE_KEYS if any(k in c["stats"] for c in calls)}
    return got


def _diagnose(ctx: dict, readings: dict):
    """What may make a window stray, on stderr: the host's readings, the
    program's device pool allocations and the interpreter's collections
    in the window, and the window's p95 latency in each second."""
    for k, v in readings.items():
        log("host: %s %s" % (k, json.dumps(v)))
    calls = ctx.get("window_calls")
    if calls:
        log("window: per-call bytes and seconds %s" % json.dumps(
            [[c["bytes"], c["s"]] for c in calls]))
    b, a = ctx["before"], ctx["after"]
    log("window: pool allocs %+d, evictions %+d; gc collections %s" % (
        a["pool"]["allocs"] - b["pool"]["allocs"],
        a["pool"]["evictions"] - b["pool"]["evictions"],
        [y - x for x, y in zip(b["gc"], a["gc"])]))
    window = ctx.get("window") or []
    if window and window[0][1] is not None:
        import numpy as np

        t = np.array([r[1] for r in window])
        lat = np.array([r[3] - r[1] for r in window]) * 1e3
        sec = np.floor(t - t.min()).astype(int)
        p95 = [round(float(np.percentile(lat[sec == s], 95)), 1)
               for s in range(sec.max() + 1) if (sec == s).any()]
        log("window: p95 ms by second of due time: %s" % p95)


def verify(dep, mix: dict, out: dict, device: str) -> dict:
    import torch

    dev = torch.device(device)
    if mix["loop"] == "calls":
        checks = dep.verify_scrubs(out["calls"], dev)
    else:
        checks = dep.verify_gets(out["replies"], dev, mix["sample_rows"])
        checks["unanswered"] = (out["missing"], 0)
    if device == "cuda":
        torch.cuda.synchronize()
    return checks


def sweep(cell_name: str, seed: int, seconds: float, rates: list,
          device: str = "cuda") -> list:
    """The knee sweep of an open-loop cell: one set-up, then one window
    at each offered rate in turn (each with the mix's warm-up); returns
    per rate the offered and achieved rates, p50/p95 from due, lateness,
    and failures.  Used once, to fix a cell's rate."""
    import numpy as np

    cell = spec.cell(cell_name)
    mix = spec.traffic(cell["traffic"])
    workdir = os.path.join(WORK, cell_name)
    dep = _deployment(cell, cell.get("params", {}), seed, device, workdir)
    rows = []
    try:
        _build(dep)
        for rate in rates:
            params = dict(cell.get("params", {}), rate_per_s=rate)
            window = Window(dep, None, None)
            out = open_loop(dep, mix, params, seed, seconds, window, workdir)
            lat = np.array(out["latencies_s"]) * 1e3
            done = [r[3] for r in out["window"] if r[4] == 200]
            span = max(done) - mix["warmup_s"] if done else 0.0
            rows.append({
                "offered_per_s": rate,
                "achieved_per_s": len(done) / span if span > 0 else 0.0,
                "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
                "p95_ms": float(np.percentile(lat, 95)) if len(lat) else None,
                "lateness_p95_ms": float(np.percentile(
                    out["lateness_s"], 95)) * 1e3,
                "failed": sum(1 for r in out["window"] if r[4] != 200)
                + out["missing"]})
            log("sweep " + json.dumps(rows[-1]))
    finally:
        dep.stop()
        dep.cleanup()
    return rows
