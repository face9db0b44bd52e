"""Load benchmark: concurrent write-then-read of small files.

Port of `weed benchmark` (weed/command/benchmark.go:27-90): N files of a
given size written through master assign + volume POST at a set
concurrency, then read back randomly, with a latency histogram and the
same percentile report (p50..p99.9/max) as the reference README's
published numbers (README.md:342-391).

The port's own copy of seaweedfs_tpu/benchmark.py.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from .rpc.http_rpc import RpcError, call


@dataclass
class BenchResult:
    requests: int = 0
    errors: int = 0
    bytes: int = 0
    seconds: float = 0.0
    latencies_ms: list = field(default_factory=list)

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        data = sorted(self.latencies_ms)
        idx = min(len(data) - 1, int(len(data) * p / 100))
        return data[idx]

    def report(self, title: str) -> str:
        rps = self.requests / self.seconds if self.seconds else 0
        mbps = self.bytes / 1e6 / self.seconds if self.seconds else 0
        lines = [
            f"--- {title} ---",
            f"requests: {self.requests}, errors: {self.errors}",
            f"time: {self.seconds:.2f}s, {rps:.1f} req/s, {mbps:.2f} MB/s",
        ]
        for p in (50, 66, 75, 80, 90, 95, 98, 99, 99.9):
            lines.append(f"  p{p}: {self.percentile(p):.2f} ms")
        if self.latencies_ms:
            lines.append(f"  max: {max(self.latencies_ms):.2f} ms")
        return "\n".join(lines)


def run_benchmark(master_address: str, num_files: int = 1000,
                  file_size: int = 1024, concurrency: int = 16,
                  delete_percent: int = 0, replication: str = "000",
                  do_read: bool = True, quiet: bool = False,
                  use_tcp: bool = False, use_native: bool = False,
                  assign_batch: int = 256, per_file_assign: bool = False):
    if per_file_assign:
        return _run_full_native(master_address, num_files, file_size,
                                concurrency, quiet)
    if use_native:
        return _run_native(master_address, num_files, file_size,
                           concurrency, delete_percent, replication,
                           do_read, quiet, assign_batch)
    tcp_client = None
    if use_tcp:  # benchmark -useTcp (command/benchmark.go)
        from .wdclient.volume_tcp_client import VolumeTcpClient

        tcp_client = VolumeTcpClient(max_conns_per_server=concurrency)
    payload = random.randbytes(file_size)
    fids: list[tuple[str, str]] = []
    fid_lock = threading.Lock()
    write = BenchResult()
    counter = {"n": 0}

    def write_worker():
        while True:
            with fid_lock:
                if counter["n"] >= num_files:
                    return
                counter["n"] += 1
            t0 = time.perf_counter()
            try:
                a = call(master_address,
                         f"/dir/assign?replication={replication}")
                headers = ({"Authorization": "BEARER " + a["auth"]}
                           if a.get("auth") else {})
                call(a["url"], f"/{a['fid']}", raw=payload, method="POST",
                     headers=headers)
                dt = (time.perf_counter() - t0) * 1e3
                with fid_lock:
                    write.requests += 1
                    write.bytes += file_size
                    write.latencies_ms.append(dt)
                    fids.append((a["url"], a["fid"]))
            except RpcError:
                with fid_lock:
                    write.errors += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=write_worker)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    write.seconds = time.perf_counter() - t0

    read = BenchResult()
    if tcp_client is not None and not (do_read and fids):
        tcp_client.close()
    if do_read and fids:
        reads_left = {"n": len(fids)}

        def read_worker():
            while True:
                with fid_lock:
                    if reads_left["n"] <= 0:
                        return
                    reads_left["n"] -= 1
                url, fid = random.choice(fids)
                t0 = time.perf_counter()
                try:
                    # broad catch: the TCP path raises VolumeTcpError/
                    # OSError/TimeoutError, not just RpcError — a dead
                    # reader thread would silently skew the report
                    data = (tcp_client.read_needle(url, fid)
                            if tcp_client is not None
                            else call(url, f"/{fid}"))
                    dt = (time.perf_counter() - t0) * 1e3
                    with fid_lock:
                        read.requests += 1
                        read.bytes += len(data)
                        read.latencies_ms.append(dt)
                except Exception:
                    with fid_lock:
                        read.errors += 1

        t0 = time.perf_counter()
        threads = [threading.Thread(target=read_worker)
                   for _ in range(concurrency)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            if tcp_client is not None:
                tcp_client.close()
        read.seconds = time.perf_counter() - t0

    if delete_percent > 0:
        for url, fid in fids[: len(fids) * delete_percent // 100]:
            try:
                call(url, f"/{fid}", method="DELETE")
            except RpcError:
                pass

    if not quiet:
        print(write.report("write"))
        if do_read:
            print(read.report("read"))
    return write, read


def _run_full_native(master_address: str, num_files: int, file_size: int,
                     concurrency: int, quiet: bool):
    """Per-file assign + write, both off the GIL: each request fetches a
    fresh fid from the master's native 'A' handler (lease-fed by the
    Python master) and writes it to the assigned volume server — the
    reference benchmark's exact per-file flow (command/benchmark.go
    writeFiles).  Requires master AND volume servers started with -tcp
    on conventional ports (native port = http port + 20000).  Reads are
    not run (fids/cookies are minted inside the C++ generator); use the
    batched mode for read rates."""
    from .storage import native_engine

    if not native_engine.available():
        raise RuntimeError("native engine unavailable (build native/)")
    status = call(master_address, "/dir/status")
    nport = status.get("native_assign_port", 0)
    if not nport:
        raise RuntimeError(
            "master native assign not enabled (start master with -tcp)")
    host = master_address.rsplit(":", 1)[0]
    write = BenchResult()
    secs, errs, lat = native_engine.bench(
        host, int(nport), "F", ["-"], num_files, file_size, concurrency)
    write.requests = num_files - errs
    write.errors = errs
    write.bytes = (num_files - errs) * file_size
    write.seconds = secs
    write.latencies_ms = lat.tolist()
    if not quiet:
        print(write.report("write (per-file native assign)"))
    return write, BenchResult()


def _run_native(master_address: str, num_files: int, file_size: int,
                concurrency: int, delete_percent: int, replication: str,
                do_read: bool, quiet: bool, assign_batch: int,
                http_phase: bool = False, pre_phase_hook=None):
    """Native-engine benchmark: the load generator is the C++ one in
    native/vol_native.cpp (like the reference's compiled Go benchmark
    client), hitting the volume server's native fast-path port.  File ids
    are assigned from the master in batches via /dir/assign?count=N (the
    reference's Assign count parameter, operation/assign_file_id.go) and
    expanded with the fid "_delta" convention.

    JWT-secured clusters: assign replies carry fid-scoped tokens that
    ride with each fid; the cluster's jwt.signing expires_after_seconds
    must outlive the whole write phase (the harness uses 3600 s), since
    every token is minted during the up-front assign loop.

    pre_phase_hook(by_server): called after assigns, before the write
    phase — e.g. to wait for replica-set propagation on replicated
    volumes so the native plane serves the writes rather than 307ing."""
    from .storage import native_engine
    from .wdclient.volume_tcp_client import VolumeTcpClient

    if not native_engine.available():
        raise RuntimeError("native engine unavailable (build native/)")
    resolver = VolumeTcpClient()
    by_server: dict[str, list[str]] = {}
    write = BenchResult()
    t_assign0 = time.perf_counter()
    remaining = num_files
    while remaining > 0:
        k = min(assign_batch, remaining)
        a = call(master_address,
                 f"/dir/assign?replication={replication}&count={k}")
        fid = a["fid"]
        # JWT clusters: carry the assign's token with each fid ("fid jwt"
        # entries; the C++ generator appends it to the framed request line —
        # one batch token authorizes fid and its _N variants)
        suffix = f" {a['auth']}" if a.get("auth") else ""
        group = by_server.setdefault(a["url"], [])
        group.append(fid + suffix)
        group.extend(f"{fid}_{i}{suffix}" for i in range(1, k))
        remaining -= k
    assign_seconds = time.perf_counter() - t_assign0

    def tcp_endpoint(url: str) -> tuple[str, int]:
        host, port = resolver.tcp_address(url).rsplit(":", 1)
        return host, int(port)

    def run_phase(op: str, result: BenchResult, payload: int):
        """Drive every server concurrently (svn_bench releases the GIL);
        wall-clock is the slowest server, so multi-server runs report
        true aggregate throughput."""
        from concurrent.futures import ThreadPoolExecutor

        def one(item):
            url, fids = item
            host, port = tcp_endpoint(url)
            return native_engine.bench(host, port, op, fids, len(fids),
                                       payload, concurrency)

        with ThreadPoolExecutor(max_workers=len(by_server)) as pool:
            outs = list(pool.map(one, by_server.items()))
        for (url, fids), (secs, errs, lat) in zip(by_server.items(), outs):
            result.requests += len(fids) - errs
            result.errors += errs
            result.bytes += (len(fids) - errs) * file_size
            result.seconds = max(result.seconds, secs)
            result.latencies_ms.extend(lat.tolist())

    if pre_phase_hook is not None:
        pre_phase_hook(by_server)
    run_phase("W", write, file_size)

    read = BenchResult()
    if do_read:
        run_phase("R", read, 0)
    read.http_rps = 0.0
    if http_phase:
        # the native port also answers plain HTTP GETs: measure the
        # reference benchmark's own modality (README.md:372-381)
        http = BenchResult()
        run_phase("H", http, 0)
        read.http_rps = (http.requests / http.seconds
                         if http.seconds else 0.0)

    if delete_percent > 0:
        for url, fids in by_server.items():
            host, port = tcp_endpoint(url)
            n = len(fids) * delete_percent // 100
            if n:
                native_engine.bench(host, port, "D", fids[:n], n, 0,
                                    concurrency)

    if not quiet:
        print(f"(assign: {num_files} fids in {assign_seconds:.2f}s, "
              f"batch={assign_batch})")
        print(write.report("write (native)"))
        if do_read:
            print(read.report("read (native)"))
    return write, read
