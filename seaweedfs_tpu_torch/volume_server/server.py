"""Volume server daemon: public object HTTP API + admin/EC RPC + heartbeat.

Parity with weed/server/volume_server*.go:
  * GET/HEAD/POST/DELETE /{fid} with replication fan-out guarded by
    type=replicate (volume_server_handlers_write.go:18-137,
    topology/store_replicate.go:24-141)
  * admin RPCs: allocate/delete/mount/readonly/vacuum/status
    (volume_grpc_admin.go, volume_grpc_vacuum.go)
  * the 9 EC handlers: generate/rebuild/copy/delete/mount/unmount/
    shard-read/blob-delete/to-volume (volume_grpc_erasure_coding.go:38-438)
  * heartbeat client loop (volume_grpc_client_to_master.go:46-120)

EC reads use the local -> remote -> reconstruct ladder; remote shard spans
are fetched over HTTP from peers found via the master's EC lookup, cached
with a freshness window (store_ec.go:227-268).

Counterpart of seaweedfs_tpu/volume_server/server.py, on the same routes,
JSON shapes, headers and status codes, so the JAX package's master, shell
and clients drive it unchanged.  `device` is where the server's EC work
runs (its Store's device): the CUDA card unless the caller passes
device="cpu".  `/admin/ec/generate` and `/admin/ec/rebuild` encode through
kernel K2 on the card, and a read behind a lost shard decodes through K1.
A CUDA error inside a handler is that request's 500 reply, never a quiet
host decode.

Prefork workers (WEED_HTTP_WORKERS > 1 on an explicit port) serve reads
from their snapshot of the Store plus the .idx tail and forward writes
to the parent (rpc/prefork.py).  Each worker is forked from the group's
template, before the parent touches the card, and makes its own CUDA
context at its first K1; it pins torch to one CPU thread.  `enable_tcp`
starts the native engine's TCP fast path (the Python loop where the
engine is missing), and `tier_backends` registers remote tiers for
`/admin/volume/tier_upload`, `tier_download` and
`/admin/remote/fetch_write`.  `start` starts the maintenance worker
(maintenance/worker.py, off with WEED_MAINT_WORKER=0) that leases the
curator's jobs from the master: an ec.rebuild job rebuilds through K2
and a deep.scrub job recomputes parity through K1 on the server's
device.  With prefork workers it runs in the parent alone, started after
the group's template has forked.  A scale.up job spawns a volume server
through the port's CLI (`python -m seaweedfs_tpu_torch volume`) on this
server's device, backend and pulse; a scale.drain job moves the named
server's volumes and EC shards off it, then has it leave.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np

from .. import profiling, qos, tracing
from ..rpc import prefork as _prefork
from ..rpc import policy
from ..rpc.http_rpc import (FileSlice, Request, Response, RpcError,
                            RpcServer, call, call_stream, sendfile_enabled,
                            stream_file)
from ..util import faults
from ..security import Guard, gen_write_jwt, token_from_request
from ..stats import access
from ..stats import events as events_mod
from ..stats import healthz
from ..stats import metrics as stats
from ..storage import types as t
from ..storage.erasure_coding import TOTAL_SHARDS_COUNT, to_ext
from ..storage.erasure_coding import codes as ec_codes
from ..storage.erasure_coding import decoder as ec_decoder
from ..storage.erasure_coding.encoder import load_volume_info
from ..storage.erasure_coding.ec_volume import (EcDeletedError,
                                                EcNotFoundError,
                                                rebuild_ecx_file)
from ..storage import volume_backup
from ..storage.needle import Needle
from ..storage.store import Store
from ..storage.volume import (CookieMismatchError, DeletedError,
                              NotFoundError, VolumeError)

# EC shard-location cache freshness tiers (store_ec.go:227-268): a lookup
# that errored or found too few shards to reconstruct stays fresh only
# briefly; an incomplete-but-usable set refreshes at a medium cadence; a
# full set is trusted for a long window.
EC_SHARD_CACHE_TTL_ERROR = 11.0
EC_SHARD_CACHE_TTL_INCOMPLETE = 7 * 60.0
EC_SHARD_CACHE_TTL_HEALTHY = 37 * 60.0


def _resp_len(resp) -> int:
    """Bytes a handler reply carries (access accounting): buffered
    bodies directly, streamed/sendfile bodies via Content-Length."""
    body = getattr(resp, "body", resp)
    if isinstance(body, (bytes, bytearray, memoryview)):
        return len(body)
    headers = getattr(resp, "headers", None) or {}
    try:
        return int(headers.get("Content-Length", 0) or 0)
    except (TypeError, ValueError):
        return 0


class _EcBindingEntry:
    """One EC volume's native serving state (binding + the EcVolume
    instance it was built from, to detect remounts)."""

    __slots__ = ("ev", "binding")

    def __init__(self, ev, binding):
        self.ev = ev
        self.binding = binding


class _InflightGate:
    """In-flight byte throttle (volume_server.go:21-50 cond-var limits).

    Bounds the bytes concurrently being PROCESSED by upload/download
    handlers; the HTTP substrate has already buffered the request body by
    routing time, so this caps needle assembly + replication fan-out
    concurrency rather than socket buffering.  Zero limit = unlimited."""

    def __init__(self, limit_bytes: int, timeout: float = 30.0):
        self.limit = limit_bytes
        self.timeout = timeout
        self._current = 0
        self._cond = threading.Condition()

    def acquire(self, n: int, timeout: float = None) -> bool:
        if self.limit <= 0:
            return True
        deadline = time.monotonic() + (
            self.timeout if timeout is None else timeout)
        with self._cond:
            # a single oversized request may exceed the limit when alone
            while self._current > 0 and self._current + n > self.limit:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            self._current += n
            return True

    def release(self, n: int):
        if self.limit <= 0:
            return
        with self._cond:
            self._current -= n
            self._cond.notify_all()


class _RequestShedder:
    """Bounded-inflight load shedding for the object API: unlike the
    byte gates above (which QUEUE callers), excess requests are shed
    immediately with 503 + Retry-After so clients back off instead of
    piling onto a saturated server.  Zero limit = off; the limit is
    re-read per request (WEED_VS_MAX_INFLIGHT) so it can be flipped
    live."""

    def __init__(self, limit: int = 0):
        self.limit = limit
        self._current = 0
        self._lock = threading.Lock()

    def _effective_limit(self) -> int:
        env = os.environ.get("WEED_VS_MAX_INFLIGHT", "")
        return int(env) if env else self.limit

    def try_acquire(self) -> bool:
        limit = self._effective_limit()
        with self._lock:
            if limit > 0 and self._current >= limit:
                return False
            self._current += 1
            return True

    def release(self):
        with self._lock:
            self._current -= 1

    @property
    def current(self) -> int:
        with self._lock:
            return self._current


def _remove_quiet(*paths: str):
    """Best-effort unlink for rollback paths."""
    for path in paths:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass


def _parse_range(header: str, total: int):
    """Parse a Range header against an entity of `total` bytes
    (volume_server_handlers_read.go:238 processRangeRequest).

    -> (start, end_exclusive) for a single satisfiable range, None when
    unsatisfiable (caller replies 416), Ellipsis to ignore the header and
    serve the full entity (malformed or multi-range)."""
    if not header.startswith("bytes="):
        return ...
    spec = header[len("bytes="):]
    if "," in spec:  # multi-range: legal to ignore and serve 200
        return ...
    start_s, _, end_s = spec.partition("-")
    try:
        if start_s == "":
            n = int(end_s)  # suffix form: last n bytes
            if n <= 0:
                return None
            return max(0, total - n), total
        start = int(start_s)
        end = int(end_s) + 1 if end_s else total
    except ValueError:
        return ...
    if start >= total or start < 0 or end <= start:
        return None
    return start, min(end, total)


_GZIPPABLE_MIME = ("text/", "application/json", "application/javascript",
                   "application/xml", "application/xhtml", "image/svg")
_GZIPPABLE_EXT = (".txt", ".htm", ".html", ".css", ".js", ".json", ".xml",
                  ".csv", ".svg", ".md", ".log", ".conf", ".yaml", ".yml")


def _is_gzippable(name: bytes, mime: bytes) -> bool:
    """Compressibility heuristic (util/http/compression.go IsGzippable):
    by mime family first, by filename extension otherwise."""
    m = mime.decode(errors="replace").lower()
    if m:
        if any(m.startswith(p) for p in _GZIPPABLE_MIME):
            return True
        if m == "application/octet-stream":
            pass  # fall through to the extension check
        else:
            return False
    n = name.decode(errors="replace").lower()
    return any(n.endswith(e) for e in _GZIPPABLE_EXT)


def _pin_worker_threads(_wid: int):
    """Post-fork hook of a prefork worker: one torch CPU thread, so the
    worker never enters a parallel region of a thread pool it inherited
    (see rpc/prefork.py)."""
    import torch

    torch.set_num_threads(1)


class VolumeServer:
    def __init__(self, directories: list[str], master_address: str,
                 host: str = "127.0.0.1", port: int = 0,
                 public_url: str = "", data_center: str = "",
                 rack: str = "", max_volume_counts: Optional[list[int]] = None,
                 pulse_seconds: float = 5.0, ec_encoder_backend=None,
                 guard: Optional[Guard] = None, tier_backends=None,
                 enable_tcp: bool = False, read_mode: str = "proxy",
                 needle_map_kind: str = "memory", fsync: bool = False,
                 upload_limit_mb: int = 0, download_limit_mb: int = 0,
                 max_inflight_requests: int = 0, device=None):
        if read_mode not in ("local", "proxy", "redirect"):
            raise ValueError(f"unknown readMode {read_mode!r}")
        self.read_mode = read_mode
        self.upload_gate = _InflightGate(upload_limit_mb << 20)
        self.download_gate = _InflightGate(download_limit_mb << 20)
        self.request_shedder = _RequestShedder(max_inflight_requests)
        # weighted-fair admission over the same limit; WEED_QOS=0 falls
        # back to the flat shedder above (WEED_VS_MAX_INFLIGHT is the
        # deprecated alias for WEED_QOS_VS_LIMIT)
        self.qos_gate = qos.AdmissionGate(
            "volume", limit_env="WEED_QOS_VS_LIMIT",
            fallback_env="WEED_VS_MAX_INFLIGHT",
            default_limit=max_inflight_requests)
        # workload analytics sketches for this daemon's needle traffic
        self.access_recorder = access.AccessRecorder(node="volume")
        self.enable_tcp = enable_tcp
        self._tcp_sock = None
        # tier backends must be registered before Store discovery so
        # .vif-only (tiered) volumes load (storage/tier.py registry)
        if tier_backends:
            from ..storage import tier

            for conf in tier_backends:
                tier.register_tier_backend(conf)
        self.server = RpcServer(host, port, service_name="volume")
        if self.server._prefork_workers > 1:
            # workers serve reads from their fork-time needle-map
            # snapshot and tail the .idx for needles the parent wrote
            # after the fork — which requires unbuffered idx appends
            from ..storage import needle_map as _needle_map

            _needle_map.FLUSH_APPENDS = True
            self.server.on_worker_start(_pin_worker_threads)
        # drain/leave must reach every prefork worker, not just the
        # parent that executed them
        self.server.fanout_prefixes.update({"/admin/drain",
                                            "/admin/leave"})
        # the configured seed list survives leader redirects so a dead
        # leader never strands the heartbeat loop
        self._seed_masters = [m for m in master_address.split(",") if m]
        self.master_address = self._seed_masters[0]
        self.pulse_seconds = pulse_seconds
        self.guard = guard or Guard()
        self.store = Store(
            directories, max_volume_counts, ip=host,
            port=self.server.port, public_url=public_url,
            data_center=data_center, rack=rack,
            ec_encoder_backend=ec_encoder_backend,
            needle_map_kind=needle_map_kind, fsync=fsync, device=device)
        # a disk-failure demotion must reach the master NOW, not at the
        # next pulse: assigns in the gap would keep landing on the
        # demoted volume (the heartbeat reports read_only per volume)
        self.store.on_demote = self._on_demote
        # unified read cache over the needle-read path: parsed needles
        # keyed by fid, validated against the live needle map on every
        # hit (RAM + optional HBM tier on the server's device; no disk
        # tier — the needles are already on local disk).  The HBM tier
        # refuses these (needle, offset, size) tuples: it holds bytes
        from ..cache import TieredReadCache

        self.read_cache = TieredReadCache(device=device)
        self._stop = threading.Event()
        # elasticity state: `draining` marks this server read-only while
        # the curator evacuates it; the request counters feed the rps /
        # byte-rate telemetry piggybacked on every heartbeat
        self.draining = False
        self._tele_lock = threading.Lock()
        self._req_counts = {"read": 0, "write": 0, "bytes": 0}
        self._tele_prev = (time.monotonic(), 0, 0, 0)
        self._occ_peak = 0.0
        # children spawned by scale.up jobs are reaped in stop()
        self.scale_children: list = []
        # in-process spawn seam: tests install a callable(job) -> url
        # here so scale.up never starts a process; None means a
        # `python -m seaweedfs_tpu_torch volume` subprocess
        self.spawn_volume_server = None
        # per-volume-id copy locks: concurrent copies of the SAME vid must
        # not race each other's temp files / exists-checks, but a slow copy
        # of one volume must not serialize copies of unrelated volumes
        self._copy_locks: dict[int, threading.Lock] = {}
        self._copy_locks_mu = threading.Lock()
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._ec_locations: dict[int, tuple[float, dict[int, list[str]]]] = {}
        self._register_routes()
        # EC volumes discovered on disk at startup need the remote-fetch
        # ladder too, not just ones mounted via RPC
        for loc in self.store.locations:
            for vid, ev in loc.ec_volumes.items():
                ev.remote_reader = self._make_remote_reader(vid)
        # maintenance worker: pulls curator jobs from the master and
        # executes them under the foreground-load-aware byte pacer
        from ..maintenance.worker import MaintenanceWorker

        self.maintenance_worker = MaintenanceWorker(self)

    @property
    def address(self) -> str:
        return self.server.address

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self.server.start()
        if self.enable_tcp:
            self._start_tcp()
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True)
        self._heartbeat_thread.start()
        # after server.start(): a prefork group's template has forked by
        # then, so the worker thread lives in this (the parent) process
        self.maintenance_worker.start()

    def stop(self):
        self._stop.set()
        self.maintenance_worker.stop()
        for child in self.scale_children:
            try:  # subprocess volume servers spawned by scale.up jobs
                child.terminate()
                child.wait(timeout=10)
            except Exception:
                pass
        self.scale_children = []
        if getattr(self, "_native_owner", False) or \
                getattr(self, "_native_jwt_owner", False) or \
                getattr(self, "_native_listener_owner", False):
            from ..storage import native_engine

            if getattr(self, "_native_owner", False):
                for vid in getattr(self, "_native_bound", set()):
                    native_engine.unserve_volume(vid)
                for vid, entry in getattr(self, "_native_ec", {}).items():
                    native_engine.unserve_ec_volume(vid)
                    entry.binding.close()
                native_engine.release_serving()
                self._native_owner = False
            if getattr(self, "_native_jwt_owner", False):
                native_engine.server_set_jwt("", "", 10)
                self._native_jwt_owner = False
            if getattr(self, "_native_listener_owner", False):
                native_engine.server_stop()
                self._native_listener_owner = False
        if self._tcp_sock is not None:
            try:
                self._tcp_sock.close()
            except OSError:
                pass
        self.server.stop()
        self.read_cache.close()
        self.store.close()

    # -- native fast-path serving registry ------------------------------------
    def _sync_native_serving(self):
        """Keep the native TCP server's vid->volume bindings in step with
        the store (only the server instance that owns the process-wide
        native listener binds; others leave the registry alone)."""
        if not getattr(self, "_native_owner", False):
            return
        from ..storage import native_engine

        current = {}
        ec_current = {}
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                # TTL volumes serve natively too: the engine 404s
                # expired needles itself (svn_set_ttl, set at map
                # creation — volume_read.go:27-35 semantics)
                if isinstance(v.nm, native_engine.NativeNeedleMap):
                    current[vid] = v.nm
            for vid, ev in list(loc.ec_volumes.items()):
                ec_current[vid] = ev
        bound = getattr(self, "_native_bound", set())
        for vid in bound - current.keys():
            native_engine.unserve_volume(vid)
        for vid, nm in current.items():
            native_engine.serve_volume(vid, nm)
        self._native_bound = set(current)
        # EC volumes: bind local-shard read serving; rebind when the
        # EcVolume instance or its shard set changed (mount/copy/rebuild)
        ec_bound = getattr(self, "_native_ec", {})
        for vid in set(ec_bound) - ec_current.keys():
            native_engine.unserve_ec_volume(vid)
            ec_bound.pop(vid).binding.close()
        for vid, ev in ec_current.items():
            entry = ec_bound.get(vid)
            if entry is not None and entry.ev is not ev:
                native_engine.unserve_ec_volume(vid)
                entry.binding.close()
                entry = None
            if entry is None:
                try:
                    binding = native_engine.NativeEcBinding(ev)
                except (OSError, RuntimeError):
                    continue  # e.g. .ecx missing mid-copy: retry next sync
                entry = _EcBindingEntry(ev, binding)
                ec_bound[vid] = entry
            else:
                entry.binding.sync_shards(ev)
            native_engine.serve_ec_volume(vid, entry.binding)
        self._native_ec = ec_bound
        self._sync_native_replicas()

    def _sync_native_replicas(self):
        """Publish each replicated volume's peer fast-path addresses to
        the engine so native writes fan out without a 307 round-trip
        (store_replicate.go:24-141's location set, refreshed from the
        master's lookup on the heartbeat cadence; resolution failures
        just leave the vid unpublished — writes fall back to the Python
        handler's fan-out)."""
        from ..storage import native_engine
        from ..wdclient.volume_tcp_client import VolumeTcpClient

        now = time.monotonic()
        cache = getattr(self, "_replica_sync", None)
        if cache is None:
            cache = self._replica_sync = {"at": 0.0, "vids": {},
                                          "fresh": {}}
        if now - cache["at"] < max(self.pulse_seconds * 4, 4.0):
            return
        cache["at"] = now
        client = getattr(self, "_replica_tcp", None)
        if client is None:
            client = self._replica_tcp = VolumeTcpClient()
        # bound the heartbeat-path work: unpublished vids first, then
        # round-robin refresh of published ones every REFRESH seconds,
        # at most BUDGET lookups per tick (each is a blocking master
        # round-trip — hundreds of replicated volumes must not stall
        # the heartbeat thread for seconds)
        BUDGET, REFRESH = 16, 30.0
        candidates = []
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                extra = v.super_block.replica_placement.copy_count() - 1
                if extra <= 0 or not isinstance(
                        v.nm, native_engine.NativeNeedleMap):
                    continue
                age = now - cache["fresh"].get(vid, 0.0)
                if vid not in cache["vids"]:
                    candidates.append((0.0, vid))  # never resolved
                elif age >= REFRESH:
                    candidates.append((-age, vid))  # stalest first
        candidates.sort()
        for _, vid in candidates[:BUDGET]:
            try:
                lookup = call(self.master_address,
                              f"/dir/lookup?volumeId={vid}", timeout=5)
                others = [l["url"] for l in lookup.get("locations", [])
                          if l["url"] != self.store.url]
                addrs = [client.tcp_address(u) for u in others]
            except Exception:
                continue  # unpublished: native writes 307 for now
            cache["fresh"][vid] = now
            if cache["vids"].get(vid) != addrs:
                native_engine.set_replicas(vid, addrs)
                cache["vids"][vid] = addrs

    # -- TCP fast path (volume_server_tcp, port+20000) -----------------------
    def _start_tcp(self):
        """Prefer the native engine's off-GIL server; fall back to the
        Python loop (reads only) when the library is missing, JWT signing
        requires the Python guard, or another in-process volume server
        already owns the native listener."""
        from ..storage import native_engine
        from ..wdclient.volume_tcp_client import TCP_PORT_OFFSET

        if native_engine.available():
            host, port = self.server.address.rsplit(":", 1)
            wanted = int(port) + TCP_PORT_OFFSET
            bound = native_engine.server_port()
            if bound <= 0:
                try:
                    bound = native_engine.server_start(
                        host, wanted if wanted <= 65535 else 0,
                        http_redirect=self.server.address)
                    self._native_listener_owner = True
                except OSError:
                    bound = 0
            # the listener may already exist (combined process: the
            # master starts it for assign leases); SERVING vids is a
            # separate, single-claim role per process
            if bound > 0 and native_engine.claim_serving():
                # JWT-secured clusters ride the fast path too: the
                # engine verifies fid-scoped HS256 tokens itself
                # (guard.go:18-50 semantics).  Keys are set only AFTER
                # the serving claim succeeds: a server that did not
                # engage must neither set nor (on stop) clear the
                # engine-global keys another in-process server relies
                # on — clearing them would fail open.
                if self.guard.signing or self.guard.read_signing:
                    native_engine.server_set_jwt(
                        self.guard.signing.key,
                        self.guard.read_signing.key,
                        self.guard.signing.expires_after_seconds)
                    self._native_jwt_owner = True
                # the listener may predate this volume server (combined
                # process: the master starts it for assign leases) —
                # the HTTP 302 fallback must point at OUR full handler
                native_engine.server_set_redirect(self.server.address)
                self.tcp_port = bound
                self._native_owner = True
                self._native_bound = set()
                self._sync_native_serving()
                return
        if not self.enable_tcp:
            return
        self._start_tcp_python()

    def _start_tcp_python(self):
        import socket
        import struct

        from ..wdclient.volume_tcp_client import TCP_PORT_OFFSET

        host, port = self.server.address.rsplit(":", 1)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        wanted = int(port) + TCP_PORT_OFFSET
        try:
            sock.bind((host, wanted if wanted <= 65535 else 0))
        except OSError:
            sock.bind((host, 0))  # convention port taken: ephemeral,
            # clients discover it via /admin/status tcp_port
        sock.listen(64)
        self._tcp_sock = sock
        self.tcp_port = sock.getsockname()[1]

        def reply(conn, status: int, payload: bytes):
            conn.sendall(struct.pack(">II", status, len(payload))
                         + payload)

        def serve_conn(conn):
            try:
                buf = b""
                while not self._stop.is_set():
                    while b"\n" not in buf:
                        chunk = conn.recv(4096)
                        if not chunk:
                            return
                        buf += chunk
                    line, _, buf = buf.partition(b"\n")
                    parts = line.decode(errors="replace").split()
                    if len(parts) not in (2, 3) or parts[0] != "G":
                        reply(conn, 400, b"bad request")
                        return
                    fid = parts[1]
                    # same read security as the HTTP path: an optional
                    # JWT rides as the third token
                    if self.guard.read_signing:
                        try:
                            self.guard.verify_read(
                                parts[2] if len(parts) == 3 else "",
                                fid)
                        except PermissionError as e:
                            reply(conn, 401, str(e).encode())
                            continue
                    try:
                        vid, nid, cookie = t.parse_file_id(fid)
                        n = self.store.read_needle(vid, nid,
                                                   cookie=cookie)
                        data = n.data
                        if n.is_compressed:
                            # fast path has no Accept-Encoding: agree
                            # with the HTTP handler and serve plain
                            import gzip as _gzip

                            data = _gzip.decompress(data)
                        reply(conn, 0, data)
                    except (NotFoundError, EcNotFoundError,
                            DeletedError, EcDeletedError,
                            CookieMismatchError):
                        reply(conn, 404, b"not found")
                    except Exception as e:
                        reply(conn, 500, str(e).encode())
            finally:
                conn.close()

        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = sock.accept()
                except OSError:
                    return
                threading.Thread(target=serve_conn, args=(conn,),
                                 daemon=True).start()

        threading.Thread(target=accept_loop, daemon=True).start()

    def _h_metrics(self, req: Request):
        """Prometheus exposition, with the native engine's off-GIL
        request counters folded in at scrape time."""
        if getattr(self, "_native_owner", False):
            from ..storage import native_engine

            for op, n in native_engine.server_stats().items():
                stats.VolumeServerNativeRequestCounter.labels(
                    op).set_cumulative(n)
        return stats.metrics_handler(req)

    def heartbeat_once(self):
        # keep native fast-path bindings fresh (handles change across
        # vacuum commits and volume add/delete)
        self._sync_native_serving()
        hb = self.store.collect_heartbeat()
        hb["telemetry"] = self._telemetry()
        if self.access_recorder.enabled:
            # access sketches ride the beat the node already sends —
            # the leader merges summaries, raw keys never leave here
            hb["access"] = self.access_recorder.summary()
        targets = [self.master_address] + [
            m for m in self._seed_masters if m != self.master_address]
        # shared failover policy: per-master breakers skip a dead seed,
        # full-jitter backoff separates rounds (was a hand-rolled loop)
        resp, winner = policy.failover_call(
            targets, "/api/heartbeat", payload=hb, timeout=10, rounds=1)
        self.master_address = winner
        self.store.volume_size_limit = resp.get("volume_size_limit", 0)
        # raft leader failover (volume_grpc_client_to_master.go:46-76):
        # keep heartbeating the leader so assigns see our volumes
        leader = resp.get("leader_address")
        if leader and not resp.get("leader", True):
            self.master_address = leader
        return resp

    def _heartbeat_loop(self):
        while not self._stop.is_set():
            try:
                self.heartbeat_once()
            except RpcError:
                pass
            except Exception:
                # the heartbeat thread must never die: a missed beat is
                # recoverable, a dead loop gets the node reaped by the
                # master and strands every volume it holds
                import logging

                logging.getLogger(__name__).exception(
                    "heartbeat iteration failed")
            self._stop.wait(self.pulse_seconds)

    # -- routing -------------------------------------------------------------
    def _guarded(self, fn):
        """IP allow-list on admin routes (guard.go WhiteList wrapper)."""
        def wrapped(req: Request):
            peer = req.handler.client_address[0]
            if not self.guard.check_white_list(peer):
                raise RpcError(f"ip {peer} not allowed", 403)
            return fn(req)
        return wrapped

    def _register_routes(self):
        s = self.server
        g = self._guarded
        s.add("GET", "/admin/status",
              g(lambda r: {**self.store.status(),
                           "tcp_port": getattr(self, "tcp_port", 0)}))
        s.add("POST", "/admin/assign_volume", g(self._h_assign_volume))
        s.add("POST", "/admin/delete_volume", g(self._h_delete_volume))
        s.add("POST", "/admin/readonly", g(self._h_readonly))
        s.add("POST", "/admin/volume/mount", g(self._h_volume_mount))
        s.add("POST", "/admin/volume/unmount", g(self._h_volume_unmount))
        s.add("POST", "/admin/volume/copy", g(self._h_volume_copy))
        s.add("GET", "/admin/volume/status", g(self._h_volume_status))
        s.add("GET", "/admin/volume/tail", g(self._h_volume_tail))
        s.add("POST", "/admin/volume/sync", g(self._h_volume_sync))
        s.add("GET", "/admin/volume/read_all", g(self._h_volume_read_all))
        s.add("POST", "/admin/batch_delete", self._h_batch_delete)
        s.add("POST", "/admin/vacuum/check", g(self._h_vacuum_check))
        s.add("POST", "/admin/vacuum/compact", g(self._h_vacuum_compact))
        s.add("POST", "/admin/vacuum/commit", g(self._h_vacuum_commit))
        s.add("POST", "/admin/ec/generate", g(self._h_ec_generate))
        s.add("POST", "/admin/ec/rebuild", g(self._h_ec_rebuild))
        s.add("POST", "/admin/ec/mount", g(self._h_ec_mount))
        s.add("POST", "/admin/ec/unmount", g(self._h_ec_unmount))
        s.add("POST", "/admin/ec/copy", g(self._h_ec_copy))
        s.add("POST", "/admin/ec/delete_shards", g(self._h_ec_delete_shards))
        s.add("POST", "/admin/ec/to_volume", g(self._h_ec_to_volume))
        s.add("POST", "/admin/ec/scrub", g(self._h_ec_scrub))
        s.add("GET", "/admin/ec/recover_stats", g(self._h_ec_recover_stats))
        s.add("GET", "/admin/ec/codes", g(self._h_ec_codes))
        s.add("GET", "/admin/ec/inline_status", g(self._h_ec_inline_status))
        s.add("GET", "/admin/ec/shard_file", self._h_ec_shard_file)
        s.add("GET", "/admin/ec/shard_read", self._h_ec_shard_read)
        s.add("GET", "/admin/ec/shard_project", self._h_ec_shard_project)
        s.add("POST", "/admin/ec/rebuild_projected",
              g(self._h_ec_rebuild_projected))
        s.add("POST", "/admin/volume/configure_replication",
              g(self._h_configure_replication))
        s.add("POST", "/admin/volume/tier_upload", g(self._h_tier_upload))
        s.add("POST", "/admin/volume/tier_download",
              g(self._h_tier_download))
        s.add("POST", "/admin/remote/fetch_write",
              g(self._h_remote_fetch_write))
        s.add("POST", "/admin/drain", g(self._h_drain))
        s.add("POST", "/admin/leave", g(self._h_leave))
        s.add("POST", "/query", self._h_query)
        s.add("GET", "/metrics", self._h_metrics)
        s.add("GET", "/debug/traces", tracing.traces_handler)
        faults.mount(s)
        profiling.mount(s)
        qos.mount(s, gate=self.qos_gate)
        events_mod.mount(s)
        access.mount(s, self.access_recorder)
        healthz.mount_health(s, ready=self._ready_checks)
        s.add("GET", "/ui", self._h_ui)
        s.default_route = self._handle_object

    def _ready_checks(self):
        n_locations = len(self.store.locations)
        return [("store", n_locations > 0,
                 f"{n_locations} mounted location(s)"),
                ("master", bool(self.master_address),
                 f"master={self.master_address or 'unknown'}"),
                ("draining", not self.draining,
                 "draining" if self.draining else "serving"),
                healthz.gate_check(self.qos_gate)]

    def _on_demote(self, vid: int):
        events_mod.emit(events_mod.READONLY_DEMOTION, service="volume",
                        node=self.address, detail={"volume": vid})
        self._try_heartbeat()

    def _h_ui(self, req: Request):
        """Status page (server/volume_server_ui/volume.html)."""
        from ..util import ui

        rows = []
        ec_rows = []
        for loc in self.store.locations:
            with loc.lock:
                for vid, v in sorted(loc.volumes.items()):
                    dat_size, _ = v.file_stat()
                    rows.append((
                        vid, v.collection or "(default)", dat_size,
                        v.file_count(), v.deleted_count(),
                        str(v.super_block.replica_placement),
                        "readonly" if v.read_only else "writable"))
                for vid, ev in sorted(loc.ec_volumes.items()):
                    ec_rows.append((vid, ev.collection or "(default)",
                                    sorted(ev.shard_bits().shard_ids())))
        body = ui.page(
            f"SeaweedFS-TPU Volume Server {self.address}",
            ui.section("Server", ui.kv_table({
                "master": self.master_address,
                "directories": ", ".join(
                    loc.directory for loc in self.store.locations),
                "data center": self.store.data_center or "-",
                "rack": self.store.rack or "-",
                "tcp fast path": getattr(self, "tcp_port", 0) or "off",
            })),
            ui.section("Volumes", ui.table(
                ("id", "collection", "size", "files", "deleted",
                 "replication", "mode"), rows)),
            ui.section("EC shards", ui.table(
                ("volume", "collection", "shards"), ec_rows)),
        )
        return Response(body, content_type="text/html; charset=utf-8")

    def _h_configure_replication(self, req: Request):
        """VolumeConfigure (volume server side of
        command_volume_configure_replication.go): rewrite the
        replica-placement byte in the superblock on disk."""
        from ..storage.super_block import ReplicaPlacement

        p = req.json()
        v = self._volume_or_404(int(p["volume"]))
        rp = ReplicaPlacement.parse(p.get("replication", "000"))
        with v.lock:
            v.super_block.replica_placement = rp
            v.data.write_at(v.super_block.to_bytes(), 0)
            v.data.sync()
        self._try_heartbeat()
        return {"volume": v.id, "replication": str(rp)}

    def _h_tier_upload(self, req: Request):
        """VolumeTierMoveDatToRemote (volume_grpc_tier_upload.go): ship
        the .dat to a configured tier backend; volume turns readonly."""
        from ..storage import tier

        p = req.json()
        v = self._volume_or_404(int(p["volume"]))
        try:
            remote = tier.tier_upload(
                v, p["backend"], p.get("bucket", "volumes"),
                keep_local=bool(p.get("keep_local")))
        except ValueError as e:
            raise RpcError(str(e), 400)
        self._try_heartbeat()
        return {"volume": v.id, "key": remote.key,
                "size": remote.file_size}

    def _h_remote_fetch_write(self, req: Request):
        """FetchAndWriteNeedle (volume_grpc_remote.go:16-83): pull a
        remote object's byte range from the external store DIRECTLY into
        a local needle, so remote.cache of large objects never
        round-trips the bytes through the filer process.  Fans out to
        the volume's replicas like a normal write."""
        from ..remote_storage import (RemoteConf, RemoteLocation,
                                      make_remote_client)

        p = req.json()
        vid = int(p["volume"])
        nid = int(p["needle_id"])
        cookie = int(p["cookie"])
        self._volume_or_404(vid)
        client = make_remote_client(RemoteConf.from_dict(p["remote_conf"]))
        loc = RemoteLocation.parse(p["remote_location"])
        offset = int(p.get("offset", 0))
        size = int(p.get("size", -1))
        data = client.read_range(loc, offset, size) if size >= 0 \
            else client.read_file(loc)
        n = Needle.create(data)
        n.id, n.cookie = nid, cookie
        self.store.write_needle(vid, n)
        fid = f"{vid},{nid:x}{cookie:08x}"
        self._replicate(vid, fid, "POST", data,
                        {"Content-Type": "application/octet-stream"})
        return {"size": len(data), "eTag": n.etag()}

    def _h_tier_download(self, req: Request):
        """VolumeTierMoveDatFromRemote (volume_grpc_tier_download.go)."""
        from ..storage import tier

        v = self._volume_or_404(int(req.json()["volume"]))
        try:
            size = tier.tier_download(v)
        except ValueError as e:
            raise RpcError(str(e), 400)
        self._try_heartbeat()
        return {"volume": v.id, "size": size}

    def _h_drain(self, req: Request):
        """Graceful-drain step 1 (scale.drain): demote every local
        volume to read-only and flag the node as draining so assigns
        stop landing here while the curator paces the evacuation.
        ``{"draining": false}`` undoes an aborted drain."""
        p = req.json()
        draining = bool(p.get("draining", True))
        self.draining = draining
        demoted = []
        for loc in self.store.locations:
            with loc.lock:
                vids = list(loc.volumes)
            for vid in vids:
                try:
                    self.store.mark_volume_readonly(vid, draining)
                    demoted.append(vid)
                except NotFoundError:
                    pass  # deleted between listing and demotion
        stats.VolumeServerDrainingGauge.set(1.0 if draining else 0.0)
        events_mod.emit(events_mod.DRAIN, service="volume",
                        node=self.address,
                        detail={"draining": draining,
                                "demoted": len(demoted)})
        self._try_heartbeat()  # master must see read_only NOW
        return {"draining": draining, "volumes": sorted(demoted)}

    def _h_leave(self, req: Request):
        """VolumeServerLeave (volume_grpc_admin.go): stop heartbeating and
        unregister from the master so assigns stop landing here; the
        process keeps serving reads until stopped."""
        self._stop.set()  # ends the heartbeat loop only; server threads
        # are owned by RpcServer and keep running
        try:
            call(self.master_address, "/dir/leave",
                 {"ip": self.store.ip, "port": self.store.port}, timeout=5)
        except RpcError:
            pass  # master reaps on missed pulses anyway
        return {}

    # -- structured query (volume_grpc_query.go Query) -----------------------
    def _h_query(self, req: Request):
        """SELECT over JSON-lines/CSV needle content: body carries
        from_file_ids, filter {field, operand, value}, selections, and
        input_serialization (volume_server.proto QueryRequest)."""
        from ..query import Query, query_csv, query_json_lines

        spec = req.json()
        filt = spec.get("filter") or {}
        query = Query(field=filt.get("field", ""),
                      op=filt.get("operand", ""),
                      value=str(filt.get("value", "")))
        selections = spec.get("selections") or []
        input_ser = spec.get("input_serialization") or {"json": {}}
        records = []
        for fid in spec.get("from_file_ids", []):
            try:
                vid, nid, cookie = t.parse_file_id(fid)
            except ValueError as e:
                raise RpcError(f"bad fid {fid}: {e}", 400)
            try:
                n = self.store.read_needle(vid, nid, cookie=cookie)
            except (NotFoundError, EcNotFoundError, DeletedError,
                    EcDeletedError, CookieMismatchError):
                raise RpcError(f"{fid} not found", 404)
            if "csv" in input_ser:
                records.extend(query_csv(
                    n.data, selections, query,
                    input_ser["csv"].get("file_header_info", "USE")))
            else:
                records.extend(query_json_lines(n.data, selections, query))
        return {"records": records}

    # -- public object API ---------------------------------------------------
    def _handle_object(self, method: str, req: Request):
        if qos.enabled():
            # class/tenant installed by the dispatch loop from the
            # X-QoS-* headers; unclassified reads count as interactive
            # so foreground GETs outrank queued background work
            cls = qos.current_class()
            if qos.QOS_HEADER not in req.headers \
                    and method in ("GET", "HEAD"):
                cls = qos.INTERACTIVE
            try:
                release = self.qos_gate.admit(cls)
            except RpcError:
                stats.VolumeServerThrottleRejects.labels("inflight").inc()
                raise
            try:
                return self._handle_object_accounted(method, req)
            finally:
                release()
        if not self.request_shedder.try_acquire():
            stats.VolumeServerThrottleRejects.labels("inflight").inc()
            raise RpcError(
                "too many requests: inflight limit", 503,
                headers={"Retry-After": qos.retry_after(1, 3)})
        try:
            return self._handle_object_accounted(method, req)
        finally:
            self.request_shedder.release()

    def _handle_object_accounted(self, method: str, req: Request):
        out = self._handle_object_inner(method, req)
        body = getattr(out, "body", out)
        if isinstance(body, (bytes, bytearray)):
            n = len(body)
        elif isinstance(body, FileSlice):
            n = body.length
        else:
            n = 0
        if method in ("POST", "PUT"):
            n += len(req.body or b"")
        with self._tele_lock:
            key = "write" if method in ("POST", "PUT") else "read"
            self._req_counts[key] += 1
            self._req_counts["bytes"] += n
            sample = (self._req_counts["read"]
                      + self._req_counts["write"]) % 8 == 0
        if sample:
            # a heartbeat-instant occupancy read misses bursts entirely
            # (the gate is usually idle at the sampling moment); peak
            # occupancy observed from INSIDE requests — while this one
            # still holds its admission — is the congestion signal
            occ = self.qos_gate.occupancy()
            if occ > self._occ_peak:
                self._occ_peak = occ
        return out

    def _telemetry(self) -> dict:
        """Per-heartbeat load sample for the curator's autoscale
        detectors: admission-gate occupancy plus rps / byte-rate over
        the window since the previous heartbeat."""
        now = time.monotonic()
        with self._tele_lock:
            reads = self._req_counts["read"]
            writes = self._req_counts["write"]
            nbytes = self._req_counts["bytes"]
            t0, rw0, _, b0 = self._tele_prev
            self._tele_prev = (now, reads + writes, 0, nbytes)
            peak, self._occ_peak = self._occ_peak, 0.0
        dt = max(1e-6, now - t0)
        return {"occupancy": round(
                    max(peak, self.qos_gate.occupancy()), 4),
                "rps": round((reads + writes - rw0) / dt, 2),
                "mbps": round((nbytes - b0) / dt / float(1 << 20), 3),
                "draining": self.draining}

    def _handle_object_inner(self, method: str, req: Request):
        fid = req.path.lstrip("/").replace("/", ",", 1)
        if not fid or "," not in fid:
            raise RpcError(f"invalid fid path {req.path!r}", 400)
        try:
            vid, nid, cookie = t.parse_file_id(fid)
        except ValueError as e:
            raise RpcError(str(e), 400)
        if method in ("GET", "HEAD"):
            if self.guard.read_signing:
                try:
                    self.guard.verify_read(
                        token_from_request(req.headers, req.query), fid)
                except PermissionError as e:
                    raise RpcError(str(e), 401)
            stats.VolumeServerRequestCounter.labels("read").inc()
            t0 = time.monotonic()
            nbytes = 0
            try:
                with stats.VolumeServerRequestHistogram.labels(
                        "read").time():
                    with tracing.span("needle.read", tags={"fid": fid}):
                        resp = self._read_object(
                            vid, nid, cookie, method, req, fid)
                nbytes = _resp_len(resp)
                return resp
            finally:
                self._record_access("read", vid, fid, nbytes,
                                    time.monotonic() - t0)
        if method in ("POST", "PUT"):
            # JWT check before any byte is written
            # (volume_server_handlers_write.go:30-38)
            self._check_write_auth(req, fid)
            stats.VolumeServerRequestCounter.labels("write").inc()
            n_bytes = len(req.body)
            if not self.upload_gate.acquire(n_bytes):
                stats.VolumeServerThrottleRejects.labels("upload").inc()
                raise RpcError("too many requests: upload limit", 429)
            t0 = time.monotonic()
            try:
                with stats.VolumeServerRequestHistogram.labels(
                        "write").time():
                    with tracing.span(
                            "needle.write",
                            tags={"fid": fid, "bytes": n_bytes}):
                        return self._write_object(vid, nid, cookie, req)
            finally:
                self.upload_gate.release(n_bytes)
                self._record_access("write", vid, fid, n_bytes,
                                    time.monotonic() - t0)
        if method == "DELETE":
            self._check_write_auth(req, fid)
            stats.VolumeServerRequestCounter.labels("delete").inc()
            with tracing.span("needle.delete", tags={"fid": fid}):
                resp = self._delete_object(vid, nid, cookie, req)
            self._record_access("delete", vid, fid, 0, 0.0)
            return resp
        raise RpcError(f"unsupported method {method}", 405)

    def _record_access(self, op: str, vid: int, fid: str, nbytes: int,
                       latency_s: float):
        """Feed the workload analytics sketches (stats/access.py); the
        QoS class/tenant were set from the request headers by dispatch,
        so gateway-attributed tenants flow through unchanged."""
        v = self.store.find_volume(vid)
        coll = v.collection if v is not None else ""
        if not coll:
            ev = self.store.find_ec_volume(vid)
            coll = getattr(ev, "collection", "") if ev is not None else ""
        self.access_recorder.record(
            op, collection=coll, tenant=qos.current_tenant(),
            volume=vid, fid=fid, nbytes=nbytes,
            latency_s=latency_s, qos_class=qos.current_class())

    def _check_write_auth(self, req: Request, fid: str):
        try:
            self.guard.verify_write(
                token_from_request(req.headers, req.query), fid)
        except PermissionError as e:
            raise RpcError(str(e), 401)

    def _read_object(self, vid: int, nid: int, cookie: int, method: str,
                     req: Request, fid: str):
        v = self.store.find_volume(vid)
        if v is None and self.store.find_ec_volume(vid) is None:
            # volume not local: readMode local|proxy|redirect
            # (volume_server_handlers_read.go:30-70)
            return self._read_nonlocal(vid, method, req, fid)
        self._refresh_worker_view(v)
        n = self._cached_needle(v, vid, nid, cookie)
        if n is None:
            resp = self._sendfile_read(v, vid, nid, cookie, method, req)
            if resp is not None:
                return resp
        if n is None:
            nv_before = v.nm.get(nid) if v is not None else None
            try:
                n = self.store.read_needle(vid, nid, cookie=cookie)
            except (NotFoundError, EcNotFoundError):
                n = self._retry_after_idx_refresh(v, vid, nid, cookie)
                if n is None:
                    raise RpcError("not found", 404)
            except (DeletedError, EcDeletedError):
                raise RpcError("already deleted", 404)
            except (CookieMismatchError,) as e:
                raise RpcError(str(e), 404)
            self._fill_needle_cache(v, vid, nid, n, nv_before)
        if not self.download_gate.acquire(len(n.data)):
            stats.VolumeServerThrottleRejects.labels("download").inc()
            raise RpcError("too many requests: download limit", 429)
        try:
            return self._build_read_response(n, method, req)
        finally:
            self.download_gate.release(len(n.data))

    def _refresh_worker_view(self, v):
        """Prefork worker: tail the .idx BEFORE resolving a read, not
        only on a local miss: deletes and overwrites the parent applied
        after the fork still RESOLVE in this worker's stale snapshot (to
        the old offset/size), so a miss-only refresh would serve deleted
        or superseded bytes indefinitely (DELETE-then-GET returning 200
        with the old data).  The no-news case is one fstat:
        refresh_from_idx compares the .idx size against the consumed
        tail and returns without reading.  Every map kind of the port
        tails, the native engine's too (the JAX package's native map
        does not)."""
        if v is None or not _prefork.is_worker():
            return
        with v.lock:
            try:
                v.nm.refresh_from_idx()
            except OSError:
                pass  # racing a vacuum's .idx swap: serve the snapshot

    def _retry_after_idx_refresh(self, v, vid: int, nid: int,
                                 cookie: int):
        """Prefork worker: a needle-map miss may be a needle the parent
        wrote after our fork.  Tail the (flush-per-append) .idx and
        retry once before 404ing; the HTTP layer additionally retries
        residual misses against the parent process."""
        if not _prefork.is_worker() or v is None:
            return None
        with v.lock:
            applied = v.nm.refresh_from_idx()
        if not applied:
            return None
        try:
            return self.store.read_needle(vid, nid, cookie=cookie)
        except (VolumeError, EcNotFoundError, EcDeletedError):
            return None

    def _sendfile_read(self, v, vid: int, nid: int, cookie: int,
                       method: str, req: Request):
        """Zero-copy GET: a big uncompressed needle goes straight from
        the .dat to the client socket via sendfile — the payload never
        enters Python.  Small needles (below WEED_SENDFILE_MIN) keep the
        buffered path so they still populate the RAM needle cache, which
        is faster for them than a syscall round trip.  Returns None to
        fall back to the buffered path (which also owns all error
        reporting: any storage error here falls through to it)."""
        if v is None or not sendfile_enabled():
            return None
        try:
            min_size = int(
                os.environ.get("WEED_SENDFILE_MIN", "") or 65536)
        except ValueError:
            min_size = 65536
        try:
            sliced = v.read_needle_slice(nid, cookie, min_size=min_size)
        except VolumeError:
            return None
        if sliced is None:
            return None
        n, data_off, data_len, fd = sliced
        fd_owned = True  # until closed here or handed to a FileSlice
        try:
            headers = {"Etag": f'"{n.etag()}"', "Accept-Ranges": "bytes"}
            if n.has_name:
                headers["X-File-Name"] = n.name.decode(errors="replace")
            if n.last_modified:
                headers["X-Last-Modified"] = str(n.last_modified)
            content_type = (n.mime.decode(errors="replace") if n.has_mime
                            else "application/octet-stream")
            status = 200
            offset, length = data_off, data_len
            range_header = req.headers.get("Range")
            if range_header:
                r = _parse_range(range_header, data_len)
                if r is None:
                    fd_owned = False
                    os.close(fd)
                    return Response(
                        b"", 416, content_type,
                        {"Content-Range": f"bytes */{data_len}"})
                if r is not ...:  # a single satisfiable range
                    start, end = r
                    headers["Content-Range"] = (
                        f"bytes {start}-{end - 1}/{data_len}")
                    offset, length = data_off + start, end - start
                    status = 206
            if not self.download_gate.acquire(length):
                fd_owned = False
                os.close(fd)
                stats.VolumeServerThrottleRejects.labels("download").inc()
                raise RpcError("too many requests: download limit", 429)
            gate = self.download_gate
            try:
                if method == "HEAD":
                    fd_owned = False
                    os.close(fd)
                    gate.release(length)
                    headers["Content-Length"] = str(length)
                    return Response(b"", status, content_type, headers)
                # the gate must be held for the TRANSFER's lifetime:
                # the bytes move in _reply_file AFTER this handler
                # returns, and -concurrentDownloadLimitMB exists to
                # bound in-flight bytes for exactly these large reads —
                # FileSlice.close() (the reply path's finally) releases
                body = FileSlice(fd, offset, length, close_fd=True,
                                 on_close=lambda: gate.release(length))
                fd_owned = False  # the reply path closes it
                return Response(body, status, content_type, headers)
            except BaseException:
                gate.release(length)
                raise
        except BaseException:
            if fd_owned:
                os.close(fd)
            raise

    def _cached_needle(self, v, vid: int, nid: int, cookie: int):
        """Serve a needle read out of the unified read cache when the
        live needle map still agrees with the cached (offset, size) —
        overwrites, deletes and vacuum offset shifts all change the
        map, so a stale entry self-invalidates (defense in depth on top
        of the explicit invalidation hooks)."""
        if v is None or v.ttl:  # EC reads and TTL expiry go to the store
            return None
        key = f"{vid},{nid:x}"
        cached = self.read_cache.get(key)
        if cached is None:
            return None
        n, off, size = cached
        nv = v.nm.get(nid)
        if nv is None or nv.offset != off or nv.size != size:
            self.read_cache.invalidate(key, reason="stale")
            return None
        if cookie is not None and n.cookie != cookie:
            raise RpcError(f"cookie mismatch for needle {nid:x}", 404)
        return n

    def _fill_needle_cache(self, v, vid: int, nid: int, n: Needle,
                           nv_before):
        """Admit a freshly-read needle, pinned to the (offset, size) it
        was read at; a concurrent overwrite between the read and this
        fill shows up as a map probe mismatch and skips the fill."""
        if v is None or v.ttl:
            return
        nv = v.nm.get(nid)
        if nv is None or nv_before is None or \
                nv.offset != nv_before.offset or nv.size != nv_before.size:
            return
        self.read_cache.put(f"{vid},{nid:x}", (n, nv.offset, nv.size),
                            nbytes=len(n.data))

    def _build_read_response(self, n: Needle, method: str, req: Request):
        headers = {"Etag": f'"{n.etag()}"', "Accept-Ranges": "bytes"}
        if n.has_name:
            headers["X-File-Name"] = n.name.decode(errors="replace")
        if n.last_modified:
            headers["X-Last-Modified"] = str(n.last_modified)
        content_type = (n.mime.decode(errors="replace") if n.has_mime
                        else "application/octet-stream")

        data = n.data
        range_header = req.headers.get("Range")
        if n.is_compressed:
            accepts_gzip = "gzip" in (
                req.headers.get("Accept-Encoding") or "")
            if accepts_gzip and not range_header:
                # pass the stored gzip bytes through untouched
                # (volume_server_handlers_read.go:180-199 semantics)
                headers["Content-Encoding"] = "gzip"
            else:
                import gzip as _gzip

                data = _gzip.decompress(data)
        status = 200
        if range_header and "Content-Encoding" not in headers:
            sliced = _parse_range(range_header, len(data))
            if sliced is None:
                return Response(
                    b"", 416, content_type,
                    {"Content-Range": f"bytes */{len(data)}"})
            if sliced is not ...:  # a single satisfiable range
                start, end = sliced
                headers["Content-Range"] = (
                    f"bytes {start}-{end - 1}/{len(data)}")
                # zero-copy slice: the socket writes the view straight
                # out of the (possibly cached) needle bytes
                data = memoryview(data)[start:end]
                status = 206
        if method == "HEAD":
            # entity size, not body size (the handler sends no body)
            headers["Content-Length"] = str(len(data))
            return Response(b"", status, content_type, headers)
        return Response(data, status, content_type, headers)

    def _read_nonlocal(self, vid: int, method: str, req: Request,
                       fid: str):
        """Non-local read: 404 (local), 302 to a holder (redirect), or
        fetch-and-relay (proxy) — volume_server_handlers_read.go:30,303."""
        if self.read_mode == "local":
            raise RpcError(f"volume {vid} not found locally "
                           "(readMode=local)", 404)
        if req.headers.get("X-SW-Proxied"):
            # already one proxy hop away: never proxy a proxy (stale
            # master lookups could otherwise ping-pong two non-holders
            # until threads exhaust)
            raise RpcError(f"volume {vid} not found at proxy target", 404)
        try:
            lookup = policy.call_policy(
                self.master_address, f"/dir/lookup?volumeId={vid}",
                timeout=10)
        except RpcError:
            lookup = {}
        others = [loc for loc in lookup.get("locations", [])
                  if loc["url"] != self.store.url]
        if not others:
            raise RpcError(f"volume {vid} has no other locations", 404)
        target = others[0]
        stats.VolumeServerProxiedReadCounter.labels(self.read_mode).inc()
        if self.read_mode == "redirect":
            public = target.get("publicUrl") or target["url"]
            return Response(b"", 302, headers={
                "Location": f"http://{public}/{fid}"})
        # proxy: forward the read (with range/encoding negotiation) and
        # relay status + entity headers
        import urllib.error
        import urllib.request

        fwd = urllib.request.Request(
            f"http://{target['url']}/{fid}", method=method)
        fwd.add_header("X-SW-Proxied", "1")
        for h in ("Range", "Accept-Encoding", "Authorization"):
            if req.headers.get(h):
                fwd.add_header(h, req.headers[h])
        try:
            with urllib.request.urlopen(fwd, timeout=30) as resp:
                body = resp.read()
                relay = {k: v for k, v in resp.headers.items()
                         if k in ("Etag", "Content-Range",
                                  "Content-Encoding", "X-File-Name",
                                  "X-Last-Modified", "Accept-Ranges")}
                return Response(
                    body, resp.status,
                    resp.headers.get("Content-Type",
                                     "application/octet-stream"), relay)
        except urllib.error.HTTPError as e:
            raise RpcError(f"proxied read failed: {e}", e.code)
        except OSError as e:
            raise RpcError(f"proxied read failed: {e}", 502)

    def _write_object(self, vid: int, nid: int, cookie: int, req: Request):
        is_replicate = req.param("type") == "replicate"
        name = (req.headers.get("X-File-Name") or "").encode()
        mime = (req.headers.get("Content-Type") or "").encode()
        body = req.body
        is_compressed = (req.headers.get("Content-Encoding") or "") == "gzip"
        if not is_compressed and _is_gzippable(name, mime) \
                and len(body) > 128:
            # store-side gzip when it pays (CreateNeedleFromRequest,
            # needle.go:100; util.MaybeGzipData).  mtime=0 keeps the
            # bytes deterministic so replicas dedup identically.
            import gzip as _gzip

            packed = _gzip.compress(body, 6, mtime=0)
            if len(packed) < len(body) * 9 // 10:
                body = packed
                is_compressed = True
        n = Needle.create(
            body,
            name=name,
            mime=mime,
            last_modified=int(time.time()),
            is_compressed=is_compressed,
        )
        n.id, n.cookie = nid, cookie
        try:
            size, unchanged = self.store.write_needle(vid, n)
        except NotFoundError:
            raise RpcError(f"volume {vid} not found", 404)
        except CookieMismatchError as e:
            raise RpcError(str(e), 403)
        except VolumeError as e:
            raise RpcError(str(e), 500)
        self.read_cache.invalidate(f"{vid},{nid:x}", reason="overwrite")
        if not is_replicate:
            self._replicate(vid, f"{vid},{nid:x}{cookie:08x}", "POST",
                            req.body, dict(req.headers.items()))
        return {"name": (n.name or b"").decode(errors="replace"),
                "size": size, "eTag": n.etag()}

    def _delete_object(self, vid: int, nid: int, cookie: int, req: Request):
        is_replicate = req.param("type") == "replicate"
        n = Needle(id=nid, cookie=cookie)
        try:
            size = self.store.delete_needle(vid, n)
        except NotFoundError:
            raise RpcError(f"volume {vid} not found", 404)
        self.read_cache.invalidate(f"{vid},{nid:x}", reason="delete")
        if not is_replicate:
            self._replicate(vid, f"{vid},{nid:x}{cookie:08x}", "DELETE",
                            None, {})
        return {"size": size}

    def _replicate(self, vid: int, fid: str, method: str,
                   body: Optional[bytes], headers: dict):
        """Fan out to the other replicas (store_replicate.go:24-114);
        any replica failure fails the request, as in the reference."""
        try:
            lookup = policy.call_policy(
                self.master_address, f"/dir/lookup?volumeId={vid}",
                timeout=10)
        except RpcError:
            return  # master unreachable: single-copy write stands
        others = [loc["url"] for loc in lookup.get("locations", [])
                  if loc["url"] != self.store.url]
        # wire headers arrive with arbitrary capitalisation; match them
        # case-insensitively or replicas silently lose mime/filename
        lowered = {k.lower(): v for k, v in headers.items()}
        headers = {canonical: lowered[canonical.lower()]
                   for canonical in ("Content-Type", "X-File-Name",
                                     "Content-Encoding")
                   if canonical.lower() in lowered}
        if self.guard.signing:
            # replicas share security.toml; re-sign for the fan-out hop
            headers["Authorization"] = "BEARER " + gen_write_jwt(
                self.guard.signing, fid)
        if not others:
            return
        with tracing.span("needle.replicate",
                          tags={"fid": fid, "replicas": len(others)}), \
                qos.qos_scope(qos.BACKGROUND):
            # replication fan-out is auto-tagged background: replicas
            # admit it behind their own foreground traffic
            for url in others:
                # breaker-guarded, retried fan-out: type=replicate is
                # idempotent (unchanged-content writes dedup), so a
                # flaky replica gets jittered retries and a dead one
                # fails fast once its breaker opens
                policy.call_policy(
                    url, f"/{fid}?type=replicate", method=method,
                    raw=body, headers=headers, timeout=30,
                    idempotent=True)

    # -- admin ---------------------------------------------------------------
    def _h_assign_volume(self, req: Request):
        p = req.json()
        self.store.add_volume(int(p["volume"]), p.get("collection", ""),
                              p.get("replication", "000"),
                              p.get("ttl", ""))
        self._try_heartbeat()
        return {}

    def _h_delete_volume(self, req: Request):
        vid = int(req.json()["volume"])
        # share the copy lock: a delete landing between a copy's mount and
        # its status read must not turn the completed copy into a 500
        with self._vid_copy_lock(vid):
            self.store.delete_volume(vid)
        self._try_heartbeat()
        return {}

    def _h_readonly(self, req: Request):
        p = req.json()
        self.store.mark_volume_readonly(int(p["volume"]),
                                        bool(p.get("readonly", True)))
        return {}

    def _volume_or_404(self, vid: int):
        v = self.store.find_volume(vid)
        if v is None:
            raise RpcError(f"volume {vid} not found", 404)
        return v

    def _h_vacuum_check(self, req: Request):
        v = self._volume_or_404(int(req.json()["volume"]))
        return {"garbage_ratio": v.garbage_level()}

    def _h_vacuum_compact(self, req: Request):
        self._volume_or_404(int(req.json()["volume"])).compact()
        return {}

    def _h_vacuum_commit(self, req: Request):
        vid = int(req.json()["volume"])
        self._volume_or_404(vid).commit_compact()
        # compaction shifts needle offsets: cached (offset, size) pins
        # are stale en masse, drop the whole volume's entries
        self.read_cache.invalidate_volume(vid, reason="vacuum")
        return {}

    # -- volume copy/tail/backup (volume_grpc_copy.go, _tail.go, backup) -----
    def _h_volume_mount(self, req: Request):
        """VolumeMount: load an existing on-disk volume into the store."""
        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        for loc in self.store.locations:
            if os.path.exists(loc._base_name(collection, vid) + ".dat"):
                loc.add_volume(vid, collection)
                self._try_heartbeat()
                return {}
        raise RpcError(f"volume {vid} data file not found", 404)

    def _h_volume_unmount(self, req: Request):
        """VolumeUnmount: close + forget the volume, leave files on disk."""
        vid = int(req.json()["volume"])
        with self._vid_copy_lock(vid):
            loc = self.store.location_of(vid)
            if loc is None:
                raise RpcError(f"volume {vid} not found", 404)
            loc.unload_volume(vid)
        self._try_heartbeat()
        return {}

    def _h_volume_copy(self, req: Request):
        """VolumeCopy: pull .dat/.idx/.vif from a source server and mount
        (volume_grpc_copy.go doCopyFile over the CopyFile stream)."""
        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        source = p["source"]
        # serialize copies of this vid: two concurrent requests for the
        # same vid must not both pass the exists-checks (TOCTOU) and then
        # have one's rollback unlink the other's freshly-mounted files
        with self._vid_copy_lock(vid):
            if self.store.has_volume(vid):
                raise RpcError(f"volume {vid} already exists", 409)
            loc = self.store.locations[0]
            base = loc._base_name(collection, vid)
            if os.path.exists(base + ".dat"):
                raise RpcError(f"volume {vid} files already on disk", 409)
            # fetch to temp names; rename only once every file arrived, so
            # a mid-copy failure leaves no stray .dat/.idx behind.  .idx
            # first: writes that land between the two fetches then only
            # extend the .dat, and the integrity check truncates that
            # unreferenced tail on mount — the reverse order would leave
            # the .idx pointing past the copied .dat's EOF
            fetched: list[str] = []
            try:
                for ext in (".idx", ".dat", ".vif"):
                    try:
                        chunks = call_stream(
                            source,
                            f"/admin/ec/shard_file?volume={vid}"
                            f"&collection={collection}&ext={ext}",
                            timeout=600)
                    except RpcError as e:
                        if e.status == 404 and ext == ".vif":
                            continue
                        raise
                    with open(base + ext + ".cpy", "wb") as f:
                        for chunk in chunks:
                            f.write(chunk)
                    fetched.append(ext)
            except Exception:
                # RpcError before the first byte OR a mid-stream error
                _remove_quiet(*(base + ext + ".cpy"
                                for ext in (".idx", ".dat", ".vif")))
                raise
            for ext in fetched:
                os.replace(base + ext + ".cpy", base + ext)
            try:
                loc.add_volume(vid, collection)
            except Exception:
                # keep all-or-nothing: an unloadable copy (corrupt
                # source) must not squat on the volume id's file names —
                # but never touch files backing a volume that IS mounted
                if self.store.find_volume(vid) is None:
                    _remove_quiet(*(base + ext for ext in fetched))
                raise
            # read the cursor inside the lock: a concurrent delete after
            # release must not turn a completed copy into a 500
            last_ns = self.store.find_volume(vid).last_append_at_ns
        self._try_heartbeat()
        return {"last_append_at_ns": last_ns}

    def _vid_copy_lock(self, vid: int) -> threading.Lock:
        with self._copy_locks_mu:
            return self._copy_locks.setdefault(vid, threading.Lock())

    def _h_volume_status(self, req: Request):
        """VolumeStatus + ReadVolumeFileStatus."""
        v = self._volume_or_404(int(req.param("volume", "0")))
        with v.lock:
            v.nm.flush()
        return {
            "volume": v.id,
            "last_append_at_ns": v.last_append_at_ns,
            "compaction_revision": v.super_block.compaction_revision,
            "dat_size": v.data.size(),
            "idx_size": v.index_file_size(),
            "file_count": v.file_count(),
            "read_only": v.read_only,
        }

    def _h_volume_tail(self, req: Request):
        """VolumeTailSender: raw needle records appended after since_ns,
        streamed (volume_grpc_tail.go sends 64 KB frames); the resume
        cursor rides a header computed from a header-only walk before the
        body starts."""
        v = self._volume_or_404(int(req.param("volume", "0")))
        since_ns = int(req.param("since_ns", "0"))
        limit = int(req.param("limit", str(64 << 20)))
        chunks, length, last_ns = volume_backup.iter_appended_bytes(
            v, since_ns, limit)
        return Response(chunks, headers={
            "X-Last-Append-At-Ns": str(last_ns),
            "Content-Length": str(length)})

    def _h_volume_sync(self, req: Request):
        """VolumeIncrementalCopy client side: catch this replica up from a
        source replica (volume_backup.go IncrementalBackup)."""
        p = req.json()
        v = self._volume_or_404(int(p["volume"]))
        source = p["source"]

        def fetch(since_ns: int) -> bytes:
            data = call(source,
                        f"/admin/volume/tail?volume={v.id}"
                        f"&since_ns={since_ns}", timeout=600)
            return data if isinstance(data, (bytes, bytearray)) else b""

        applied = volume_backup.incremental_backup(v, fetch)
        return {"applied": applied,
                "last_append_at_ns": v.last_append_at_ns}

    def _h_volume_read_all(self, req: Request):
        """ReadAllNeedles: stream every live needle's metadata as NDJSON
        (volume_grpc_read_all.go; drives volume.fsck).  Chunked transfer:
        a billion-needle volume streams without server-side buffering."""
        v = self._volume_or_404(int(req.param("volume", "0")))
        include_deleted = req.param("deleted") == "true"

        def gen():
            batch: list[str] = []
            for n, offset in v.scan():
                if not include_deleted and not n.data and n.size == 0:
                    continue
                batch.append(json.dumps({
                    "id": n.id, "cookie": n.cookie, "size": len(n.data),
                    "offset": offset, "crc": n.checksum,
                    "append_at_ns": n.append_at_ns}))
                if len(batch) >= 512:
                    yield ("\n".join(batch) + "\n").encode()
                    batch.clear()
            if batch:
                yield ("\n".join(batch) + "\n").encode()

        return Response(gen(), content_type="application/x-ndjson")

    def _h_batch_delete(self, req: Request):
        """BatchDelete (volume_grpc_batch_delete.go): many fids, one call.
        On a jwt-secured cluster each fid needs write authorization."""
        fids = req.json().get("fids", [])
        token = token_from_request(req.headers, req.query)
        results = []
        for fid in fids:
            try:
                self.guard.verify_write(token, fid)
            except PermissionError as e:
                results.append({"fid": fid, "status": 401, "error": str(e)})
                continue
            try:
                vid, nid, cookie = t.parse_file_id(fid)
            except ValueError as e:
                results.append({"fid": fid, "status": 400, "error": str(e)})
                continue
            try:
                size = self.store.delete_needle(
                    vid, Needle(id=nid, cookie=cookie))
                self.read_cache.invalidate(f"{vid},{nid:x}",
                                           reason="delete")
                results.append({"fid": fid, "status": 200, "size": size})
            except NotFoundError:
                results.append({"fid": fid, "status": 404,
                                "error": "volume not found"})
            except VolumeError as e:
                results.append({"fid": fid, "status": 500, "error": str(e)})
        return {"results": results}

    # -- EC handlers (volume_grpc_erasure_coding.go) -------------------------
    def _h_ec_generate(self, req: Request):
        p = req.json()
        self.store.ec_generate(int(p["volume"]),
                               code_family=p.get("code_family") or None)
        return {}

    def _h_ec_rebuild(self, req: Request):
        p = req.json()
        vid = int(p["volume"])
        rebuilt = self.store.ec_rebuild(vid, p.get("collection", ""))
        self.read_cache.invalidate_volume(vid, reason="rebuild")
        return {"rebuilt_shard_ids": rebuilt}

    def _h_ec_mount(self, req: Request):
        p = req.json()
        vid = int(p["volume"])
        self.store.ec_mount(p.get("collection", ""), vid,
                            [int(s) for s in p["shard_ids"]])
        ev = self.store.find_ec_volume(vid)
        if ev is not None and ev.remote_reader is None:
            ev.remote_reader = self._make_remote_reader(vid)
        self._try_heartbeat()
        return {}

    def _h_ec_unmount(self, req: Request):
        p = req.json()
        self.store.ec_unmount(int(p["volume"]),
                              [int(s) for s in p["shard_ids"]])
        self._try_heartbeat()
        return {}

    def _h_ec_copy(self, req: Request):
        """VolumeEcShardsCopy: pull shard files from a source server."""
        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        source = p["source"]
        loc = self.store.locations[0]
        base = loc._base_name(collection, vid)
        exts = [to_ext(int(s)) for s in p.get("shard_ids", [])]
        if p.get("copy_ecx_file", True):
            exts += [".ecx", ".ecj", ".vif"]
        # same per-vid serialization as volume copy: a failing request's
        # rollback must not unlink a concurrent request's temp files
        with self._vid_copy_lock(vid):
            # stream to temp names, rename when complete: a mid-transfer
            # failure must never leave a truncated shard mounted later
            fetched: list[str] = []
            try:
                for ext in exts:
                    try:
                        chunks = call_stream(
                            source,
                            f"/admin/ec/shard_file?volume={vid}"
                            f"&collection={collection}&ext={ext}",
                            timeout=600)
                    except RpcError as e:
                        if e.status == 404 and ext in (".ecj", ".vif"):
                            continue  # optional sidecars
                        raise
                    with open(base + ext + ".cpy", "wb") as f:
                        for chunk in chunks:
                            f.write(chunk)
                    fetched.append(ext)
            except Exception:
                # RpcError before the first byte OR a mid-stream socket
                # error: remove every temp incl. the partial in-progress
                _remove_quiet(*(base + ext + ".cpy" for ext in exts))
                raise
            for ext in fetched:
                os.replace(base + ext + ".cpy", base + ext)
        return {}

    def _h_ec_scrub(self, req: Request):
        """Verify LOCAL shards of an EC volume against the .vif CRC
        record (the fused-encode checksums).  Report-only: repairing a
        corrupt shard needs >= 10 survivors, which one holder rarely
        has, so the shell's ec.scrub routes repairs through ec.rebuild
        after deleting the corrupt shard cluster-wide."""
        from ..storage.erasure_coding.encoder import load_volume_info
        from ..storage.tools import verify_shard_files

        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        loc = self.store.location_of(vid) or self.store.locations[0]
        base = loc._base_name(collection, vid)
        info = load_volume_info(base) or {}
        try:
            clean, corrupt, _ = verify_shard_files(
                base, info.get("shard_crc32c"))
        except ValueError as e:
            raise RpcError(str(e), 404)
        # 'absent' is normal here (shards spread over holders); the shell
        # derives cluster-wide missing from the union of holder reports
        return {"volume": vid, "clean": clean, "corrupt": corrupt}

    def _h_ec_delete_shards(self, req: Request):
        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        shard_ids = [int(s) for s in p["shard_ids"]]
        self.store.ec_unmount(vid, shard_ids)
        for loc in self.store.locations:
            base = loc._base_name(collection, vid)
            _remove_quiet(*(base + to_ext(sid) for sid in shard_ids))
            # when no shards remain, drop the index sidecars too
            if not any(os.path.exists(base + to_ext(i))
                       for i in range(TOTAL_SHARDS_COUNT)):
                _remove_quiet(base + ".ecx", base + ".ecj", base + ".vif")
        # push the shrunken ShardBits to the master NOW: callers chain
        # ec.rebuild right after a delete and plan from the master's view
        self._try_heartbeat()
        return {}

    def _h_ec_to_volume(self, req: Request):
        """VolumeEcShardsToVolume: decode local shards back to .dat/.idx."""
        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        loc = self.store.location_of(vid) or self.store.locations[0]
        base = loc._base_name(collection, vid)
        rebuild_ecx_file(base)
        dat_size = ec_decoder.find_dat_file_size(base, base)
        fam = ec_codes.get_family(
            (load_volume_info(base) or {}).get("code_family"))
        ec_decoder.write_dat_file(base, dat_size,
                                  data_shards=fam.data_shards)
        ec_decoder.write_idx_file_from_ec_index(base)
        # unmount EC runtime, load as a normal volume
        ev = self.store.find_ec_volume(vid)
        if ev is not None:
            self.store.ec_unmount(vid, list(ev.shards))
        loc.add_volume(vid, collection)
        self._try_heartbeat()
        return {}

    def _h_ec_recover_stats(self, req: Request):
        """Degraded-read telemetry: the process-wide stage/cache stats
        plus each mounted EC volume's recovered-block cache occupancy
        (same numbers the Prometheus ec_recover_* vectors export)."""
        from ..storage.erasure_coding.recover import STATS

        out = STATS.snapshot()
        volumes = {}
        for loc in self.store.locations:
            for vid, ev in loc.ec_volumes.items():
                volumes[str(vid)] = {
                    "cache_blocks": len(ev._recover_cache),
                    "cache_bytes": ev._recover_cache.size_bytes,
                }
        out["volumes"] = volumes
        return out

    def _h_ec_shard_file(self, req: Request):
        vid = int(req.param("volume", "0"))
        collection = req.param("collection", "") or ""
        ext = req.param("ext", "")
        if not ext.startswith(".ec") and ext not in (".ecx", ".ecj", ".vif",
                                                     ".dat", ".idx"):
            raise RpcError(f"disallowed ext {ext}", 400)
        if ext in (".dat", ".idx"):
            v = self.store.find_volume(vid)
            if v is not None:
                with v.lock:
                    v.nm.flush()
                    v.data.sync()
        for loc in self.store.locations:
            path = loc._base_name(collection, vid) + ext
            if os.path.exists(path):
                # stream with a fixed-size snapshot: a 30 GB volume moves
                # chunk by chunk (doCopyFile semantics, volume_grpc_copy.go)
                return stream_file(path)
        raise RpcError(f"{vid}{ext} not found", 404)

    def _h_ec_shard_read(self, req: Request):
        """VolumeEcShardRead: serve a span of a locally-mounted shard."""
        vid = int(req.param("volume", "0"))
        shard_id = int(req.param("shard", "0"))
        offset = int(req.param("offset", "0"))
        size = int(req.param("size", "0"))
        ev = self.store.find_ec_volume(vid)
        if ev is None or shard_id not in ev.shards:
            raise RpcError(f"shard {vid}.{shard_id} not found", 404)
        return ev.shards[shard_id].read_at(size, offset)

    def _h_ec_codes(self, req: Request):
        """Coding-tier introspection: registered families (geometry,
        repair read amp, decode-plan cache hit ratios), this process's
        rebuild read-amp counters, and each mounted EC volume's family.
        ?volume=N narrows to one volume."""
        want_vid = int(req.param("volume", "0"))
        volumes = {}
        for loc in self.store.locations:
            for vid, ev in loc.ec_volumes.items():
                if want_vid and vid != want_vid:
                    continue
                volumes[str(vid)] = {
                    "collection": ev.collection,
                    "family": ev.family.name,
                    "shards": sorted(ev.shards),
                }
        return {
            "default_family": ec_codes.DEFAULT_FAMILY,
            "families": ec_codes.describe_families(),
            "rebuild_read_amp": ec_codes.rebuild_read_amp_snapshot(),
            "volumes": volumes,
        }

    def _h_ec_inline_status(self, req: Request):
        """Inline-EC write-path introspection: every mounted volume that
        carries an inline stripe writer reports its commit watermark,
        tail occupancy and realised write amplification.  ?volume=N
        narrows to one volume."""
        want_vid = int(req.param("volume", "0"))
        volumes = {}
        for loc in self.store.locations:
            for vid, ev in loc.ec_volumes.items():
                writer = getattr(ev, "writer", None)
                if writer is None:
                    continue
                if want_vid and vid != want_vid:
                    continue
                st = writer.status()
                st["collection"] = ev.collection
                volumes[str(vid)] = st
        return {"inline_volumes": volumes, "count": len(volumes)}

    def _h_ec_shard_project(self, req: Request):
        """Sub-shard read RPC: stream GF(2^8) projection ``vec @ lanes``
        of a locally-mounted shard — the helper side of a regenerating-
        code repair.  The reply is 1/alpha the shard's size, which is
        the whole point: the rebuilder pulls d of these instead of k
        full shards."""
        vid = int(req.param("volume", "0"))
        shard_id = int(req.param("shard", "0"))
        vec = tuple(int(x) for x in req.param("vec", "").split(",") if x)
        ev = self.store.find_ec_volume(vid)
        if ev is None or shard_id not in ev.shards:
            raise RpcError(f"shard {vid}.{shard_id} not found", 404)
        fam = ev.family
        if fam.sub_shards <= 1:
            raise RpcError(
                f"volume {vid} family {fam.name} has no sub-shards", 400)
        if len(vec) != fam.sub_shards:
            raise RpcError(
                f"vec needs {fam.sub_shards} coefficients", 400)
        shard = ev.shards[shard_id]
        total = shard.ecd_file_size
        chunk = (4 << 20) // fam.sub_shards * fam.sub_shards

        def gen():
            pos = 0
            while pos < total:
                n = min(chunk, total - pos)
                buf = shard.read_at(n, pos)
                if len(buf) != n:
                    raise RpcError(
                        f"short read shard {vid}.{shard_id}", 500)
                yield fam.project(
                    np.frombuffer(buf, dtype=np.uint8), vec).tobytes()
                pos += n

        return Response(gen(), content_type="application/octet-stream")

    def _h_ec_rebuild_projected(self, req: Request):
        """Projection rebuild: pull d helper projections over the wire
        and combine them into the lost shard locally — the repair-optimal
        rebuild for regenerating families (moves shard_size * d / alpha
        bytes instead of shard_size * k).  Verifies the rebuilt CRC
        against the .vif record when one exists and feeds the
        maintenance_ec_rebuild_* read-amp metrics."""
        import concurrent.futures as cf

        from ..ops.crc32c import crc32c

        p = req.json()
        vid = int(p["volume"])
        collection = p.get("collection", "")
        lost = int(p["shard"])
        sources = {int(s["shard_id"]): s["url"] for s in p["sources"]}
        loc = self.store.location_of(vid) or self.store.locations[0]
        base = loc._base_name(collection, vid)
        info = load_volume_info(base) or {}
        fam = ec_codes.get_family(info.get("code_family"))
        plan = fam.repair_plan(lost, sources)
        if plan.kind != "projection":
            raise RpcError(
                f"family {fam.name} has no projection repair for shard "
                f"{lost} from {sorted(sources)}", 400)
        vec_param = ",".join(str(x) for x in plan.vector)

        def pull(h: int) -> str:
            path = f"{base}.proj{h:02d}"
            chunks = call_stream(
                sources[h],
                f"/admin/ec/shard_project?volume={vid}&shard={h}"
                f"&vec={vec_param}", timeout=600)
            with open(path, "wb") as f:
                for chunk in chunks:
                    f.write(chunk)
            return path

        proj_paths: dict[int, str] = {}
        with self._vid_copy_lock(vid):
            try:
                with cf.ThreadPoolExecutor(
                        max_workers=len(plan.helpers),
                        thread_name_prefix="ec-project") as pool:
                    futs = {h: pool.submit(pull, h) for h in plan.helpers}
                    for h, fut in futs.items():
                        proj_paths[h] = fut.result()
                widths = {os.path.getsize(path)
                          for path in proj_paths.values()}
                if len(widths) != 1:
                    raise RpcError(
                        f"helper projections disagree on size: {widths}",
                        502)
                width = widths.pop()
                crc = 0
                step = (1 << 20)
                files = [open(proj_paths[h], "rb") for h in plan.helpers]
                try:
                    with open(base + to_ext(lost) + ".cpy", "wb") as out:
                        pos = 0
                        while pos < width:
                            n = min(step, width - pos)
                            stack = np.stack([
                                np.frombuffer(f.read(n), dtype=np.uint8)
                                for f in files])
                            restored = np.ascontiguousarray(
                                fam.combine_projections(plan, stack)
                            ).tobytes()
                            out.write(restored)
                            crc = crc32c(restored, crc)
                            pos += n
                finally:
                    for f in files:
                        f.close()
                stored = info.get("shard_crc32c")
                if (isinstance(stored, list)
                        and len(stored) == TOTAL_SHARDS_COUNT
                        and crc != stored[lost]):
                    _remove_quiet(base + to_ext(lost) + ".cpy")
                    raise RpcError(
                        f"projected rebuild of shard {vid}.{lost} does "
                        "not match the recorded CRC — a helper shard is "
                        "corrupt", 502)
                os.replace(base + to_ext(lost) + ".cpy", base + to_ext(lost))
            finally:
                _remove_quiet(*proj_paths.values())
        read_bytes = width * len(plan.helpers)
        rebuilt_bytes = width * fam.sub_shards
        ec_codes.note_rebuild(fam.name, read_bytes, rebuilt_bytes)
        self.read_cache.invalidate_volume(vid, reason="rebuild")
        return {"rebuilt_shard_ids": [lost], "read_bytes": read_bytes,
                "rebuilt_bytes": rebuilt_bytes,
                "read_amp": round(read_bytes / rebuilt_bytes, 4),
                "crc32c": crc}

    # -- remote EC shard fetch (store_ec.go read ladder) ---------------------
    def _make_remote_reader(self, vid: int):
        """`remote_reader(shard, offset, size)`: a span of a shard this
        server does not hold, from a holder the master's EC lookup names
        (hedged over the holders), or None where no holder answers.
        Each fetch is an `ec.peer_read` span under the caller's current
        span and counts its bytes, seconds and failures under the
        caller's QoS class (a deep scrub's are background)."""
        def remote_reader(shard_id: int, offset: int,
                          size: int) -> Optional[bytes]:
            locations = self._ec_shard_locations(vid).get(shard_id, [])
            candidates = [u for u in locations if u != self.store.url]
            cls = qos.current_class()
            if not candidates:
                stats.EcPeerReadErrorsCounter.labels(cls).inc()
                self._note_ec_lookup_error(vid)
                return None

            def fetch(url):
                def attempt():
                    data = call(
                        url,
                        f"/admin/ec/shard_read?volume={vid}"
                        f"&shard={shard_id}&offset={offset}&size={size}",
                        timeout=30)
                    if not isinstance(data, (bytes, bytearray)):
                        raise RpcError(
                            f"unexpected shard_read reply from {url}",
                            502, addr=url, transport=True)
                    return bytes(data)
                return attempt

            t0 = time.perf_counter()
            with tracing.span("ec.peer_read", tags={
                    "shard": shard_id, "peer": candidates[0],
                    "qos_class": cls}) as sp:
                # hedged survivor fetch: a slow holder stops gating the
                # whole degraded read once the adaptive p95 delay
                # elapses — the next holder races it and the first
                # answer wins
                try:
                    data = policy.hedged("/admin/ec/shard_read",
                                         [fetch(u) for u in candidates])
                except Exception:
                    data = None
                    sp.status = "error"
                sp.set_tag("bytes", len(data) if data is not None else 0)
            stats.EcPeerReadSecondsCounter.labels(cls).inc(
                time.perf_counter() - t0)
            if data is None:
                stats.EcPeerReadErrorsCounter.labels(cls).inc()
                # all candidates failed: demote the cache entry to the
                # error tier so the next read re-resolves quickly
                self._note_ec_lookup_error(vid)
                return None
            stats.EcPeerReadBytesCounter.labels(cls).inc(len(data))
            return data
        return remote_reader

    def scrub_target(self, vid: int, collection: Optional[str] = None):
        """The deep scrub's ScrubTarget over held EC volume `vid`: the
        shards mounted here read from disk, every other shard span by
        span from its holder through the remote reader, at the volume's
        shard size (a shard no holder serves is reported unreadable).
        Only where all 14 shards are mounted here does the target also
        offer `read_into`, each shard's pread into the caller's buffer; a
        volume with any shard on a peer is read through `reader` alone.
        `collection` labels the verdict (the volume's own by default).
        Raises where the volume is not held here or its .vif records no
        shard CRCs.

        The shard map is the master's of now, not the degraded-read
        location cache: after a rebuild, a map cached during the outage
        lacks the rebuilt shards for its 7-minute tier, and the scrub of
        the healed volume would fail (the JAX worker's R5, ROADMAP §3)."""
        from ..maintenance.deep_scrub import ScrubTarget

        ev = self.store.find_ec_volume(vid)
        if ev is None:
            raise RuntimeError(f"ec volume {vid} not held here")
        base = ev.base_file_name()
        info = load_volume_info(base) or {}
        stored = info.get("shard_crc32c")
        if not isinstance(stored, list) \
                or len(stored) != TOTAL_SHARDS_COUNT:
            raise RuntimeError(f"{base}.vif has no shard_crc32c record")
        local = dict(ev.shards)
        nominal = ev.shard_size
        sizes = [local[s].ecd_file_size if s in local else nominal
                 for s in range(TOTAL_SHARDS_COUNT)]
        self._ec_locations.pop(vid, None)
        remote = self._make_remote_reader(vid)

        def reader(sid: int, offset: int, size: int) -> bytes:
            shard = local.get(sid)
            if shard is not None:
                return shard.read_at(size, offset)
            data = remote(sid, offset, size)
            if data is None:
                raise RpcError(f"shard {vid}.{sid} unreachable", 502)
            return data

        read_into = None
        if len(local) == TOTAL_SHARDS_COUNT:
            # every shard on this disk: the scrub fills its stage in place
            def read_into(sid: int, offset: int, view) -> int:
                return local[sid].read_into(view, offset)

        return ScrubTarget(
            volume=vid,
            collection=ev.collection if collection is None else collection,
            stored=list(stored), sizes=sizes, reader=reader,
            read_into=read_into)

    def _note_ec_lookup_error(self, vid: int):
        cached = self._ec_locations.get(vid)
        if cached is not None:
            self._ec_locations[vid] = (cached[0], cached[1], True)

    def _ec_shard_locations(self, vid: int) -> dict[int, list[str]]:
        """Tiered-freshness shard location cache
        (cachedLookupEcShardLocations, store_ec.go:227-268)."""
        now = time.time()
        cached = self._ec_locations.get(vid)
        if cached is not None:
            fetched_at, locations, had_error = cached
            if had_error:
                ttl = EC_SHARD_CACHE_TTL_ERROR
            elif len(locations) < TOTAL_SHARDS_COUNT:
                ttl = EC_SHARD_CACHE_TTL_INCOMPLETE
            else:
                ttl = EC_SHARD_CACHE_TTL_HEALTHY
            if now - fetched_at < ttl:
                return locations
        try:
            resp = policy.call_policy(
                self.master_address, f"/ec/lookup?volumeId={vid}",
                timeout=10)
            locations = {
                e["shard_id"]: [loc["url"] for loc in e["locations"]]
                for e in resp.get("shard_id_locations", [])
            }
            had_error = False
        except RpcError:
            locations = cached[1] if cached else {}
            had_error = True
        self._ec_locations[vid] = (now, locations, had_error)
        return locations

    def _try_heartbeat(self):
        try:
            self.heartbeat_once()
        except RpcError:
            pass
