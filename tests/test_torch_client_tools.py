"""The port's client tools against the JAX package's, on the CPU.

- `BenchResult`'s percentiles and report print the same text for the
  same latencies.
- `run_benchmark` over HTTP, over the TCP fast path (`use_tcp`) and, where
  each package's native engine is built, over the engine's port
  (`use_native`: the port's own build of `native/vol_native.cpp`) writes
  and reads the same counts and bytes with no error against a cluster of
  its own package, and deletes the same share of what it wrote.
- The CLI's `upload` and `download` (each package's `main`) store and
  return the same bytes, and print the same reply, on one cluster.
Tolerance: equality throughout (times are not compared).  Every server
binds port 0 and is stopped in a `finally`.
"""

import contextlib
import json
import types

import numpy as np
import pytest

import weed as j_weed
from seaweedfs_tpu import benchmark as j_bench
from seaweedfs_tpu.master import server as j_master
from seaweedfs_tpu.rpc import http_rpc as j_rpc
from seaweedfs_tpu.storage import native_engine as j_native
from seaweedfs_tpu.volume_server import server as j_vs
from seaweedfs_tpu_torch import benchmark as t_bench
from seaweedfs_tpu_torch import weed as t_weed
from seaweedfs_tpu_torch.master import server as t_master
from seaweedfs_tpu_torch.rpc import http_rpc as t_rpc
from seaweedfs_tpu_torch.storage import native_engine as t_native
from seaweedfs_tpu_torch.volume_server import server as t_vs

PKG = {
    "jax": types.SimpleNamespace(bench=j_bench, master=j_master, vs=j_vs,
                                 rpc=j_rpc, native=j_native, weed=j_weed,
                                 kw={}),
    "port": types.SimpleNamespace(bench=t_bench, master=t_master, vs=t_vs,
                                  rpc=t_rpc, native=t_native, weed=t_weed,
                                  kw={"device": "cpu"}),
}


@contextlib.contextmanager
def cluster(pkg, root, **vs_kw):
    ns = PKG[pkg]
    started = []
    try:
        master = ns.master.MasterServer(port=0, pulse_seconds=0.2)
        master.start()
        started.append(master)
        root.mkdir(parents=True)
        vs = ns.vs.VolumeServer([str(root)], master.address, port=0,
                                pulse_seconds=0.2, **ns.kw, **vs_kw)
        vs.start()
        started.append(vs)
        vs.heartbeat_once()
        yield master, vs
    finally:
        for s in reversed(started):
            s.stop()


@pytest.fixture
def quiet_maintenance(monkeypatch):
    monkeypatch.setenv("WEED_MAINT", "0")
    monkeypatch.setenv("WEED_MAINT_WORKER", "0")


@pytest.mark.parametrize("lat", [[], [5.0], [3.0, 1.0, 2.0],
                                 list(np.random.default_rng(4).gamma(
                                     2.0, 3.0, 997))])
def test_bench_result_report_like_jax(lat):
    def script(ns):
        r = ns.bench.BenchResult(requests=len(lat), errors=1,
                                 bytes=1024 * len(lat), seconds=2.5,
                                 latencies_ms=list(lat))
        return r.report("write"), [r.percentile(p) for p in (0, 50, 99.9,
                                                             100)]

    out = {pkg: script(ns) for pkg, ns in PKG.items()}
    assert out["port"] == out["jax"]


def _counts(w, r):
    return (w.requests, w.errors, w.bytes, len(w.latencies_ms),
            r.requests, r.errors, r.bytes, len(r.latencies_ms))


def _volume_needles(vs):
    """(needles written, needles deleted) over the server's volumes."""
    vols = [v for loc in vs.store.locations for v in loc.volumes.values()]
    return (sum(v.file_count() for v in vols),
            sum(v.deleted_count() for v in vols))


@pytest.mark.parametrize("mode", ["http", "tcp"])
def test_run_benchmark_like_jax(tmp_path, quiet_maintenance, mode):
    out = {}
    for pkg, ns in PKG.items():
        with cluster(pkg, tmp_path / pkg,
                     enable_tcp=mode == "tcp") as (master, vs):
            w, r = ns.bench.run_benchmark(
                master.address, num_files=40, file_size=300, concurrency=4,
                quiet=True, use_tcp=mode == "tcp", delete_percent=25)
            out[pkg] = _counts(w, r), _volume_needles(vs)
    assert out["port"] == out["jax"]
    assert out["port"] == ((40, 0, 12000, 40, 40, 0, 12000, 40), (40, 10))


def test_run_benchmark_native_like_jax(tmp_path, quiet_maintenance):
    """`-useNative`: fids assigned in batches, the C++ load generator
    writing and reading them on the engine's port (each package's own
    engine)."""
    out = {}
    for pkg, ns in PKG.items():
        if not ns.native.available():
            pytest.fail(f"the {pkg} native engine did not build")
        with cluster(pkg, tmp_path / pkg, enable_tcp=True) as (master, vs):
            if not getattr(vs, "_native_owner", False):
                pytest.skip("another test holds the process-wide native port")
            w, r = ns.bench.run_benchmark(
                master.address, num_files=120, file_size=256, concurrency=4,
                use_native=True, assign_batch=50, quiet=True)
            out[pkg] = _counts(w, r)
    assert out["port"] == out["jax"] == (120, 0, 30720, 120, 120, 0, 30720,
                                         120)


def test_upload_and_download_commands_like_jax(tmp_path, quiet_maintenance,
                                               capsys):
    body = np.random.default_rng(6).bytes(20000)
    src = tmp_path / "in.bin"
    src.write_bytes(body)
    with cluster("port", tmp_path / "c") as (master, vs):
        replies, got = {}, {}
        for pkg, ns in PKG.items():
            ns.weed.main(["upload", str(src), "-master", master.address])
            replies[pkg] = json.loads(capsys.readouterr().out)
        for pkg, ns in PKG.items():
            for who, reply in replies.items():
                out = tmp_path / f"{pkg}-{who}.bin"
                ns.weed.main(["download", reply["fid"], "-master",
                              master.address, "-output", str(out)])
                printed = capsys.readouterr().out.strip()
                got[pkg, who] = printed == (f"wrote {len(body)} bytes to "
                                            f"{out}"), out.read_bytes()
    assert replies["port"]["size"] == replies["jax"]["size"]
    assert replies["port"]["url"] == replies["jax"]["url"] == vs.address
    assert all(v == (True, body) for v in got.values())
