"""Filer HTTP server: path-addressed files over the volume store.

Parity with weed/server/filer_server_handlers_*.go:
  * POST/PUT /path: auto-chunked upload — split body into chunks, assign a
    fid per chunk from the master, upload to volume servers, save the entry
    (filer_server_handlers_write_autochunk.go:23-130); small files inline
    into the entry
  * GET /path: entry resolution -> chunk fetches -> reassembled body with
    Range support (filer_server_handlers_read.go); directories return JSON
    listings (?limit=&lastFileName=)
  * DELETE /path?recursive=true: recursive delete + chunk reclamation
  * POST /path?mv.from=/src: rename
  * GET /metadata/subscribe?since=: change-log tail (SubscribeMetadata)

The port's own copy of seaweedfs_tpu/filer/server.py.  `device` is where
the chunk cache's HBM tier (WEED_READ_CACHE_HBM_MB) keeps 4 MiB chunks
resident: the CUDA card unless the caller passes device="cpu".  The
constructor makes no CUDA call: the tier touches the card at its first
upload, in the process that uploads, so a prefork group (WEED_HTTP_WORKERS)
forks before anything holds a context.  An overwritten path is served its
new bytes from the tier (the port's `HbmTier` keys each upload by its
generation).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

from .. import profiling, qos, tracing
from ..rpc import policy
from ..rpc.http_rpc import (FileSlice, Request, Response, RpcError,
                            RpcServer, call, sendfile_enabled)
from ..util import faults
from ..security import Guard, gen_read_jwt, gen_write_jwt
from ..stats import access
from ..stats import events as events_mod
from ..stats import healthz
from ..stats import metrics as stats
from ..storage.needle import PAIR_NAME_PREFIX
from .entry import Attr, Entry, FileChunk, total_size
from .filechunk_manifest import (MANIFEST_BATCH, has_chunk_manifest,
                                 maybe_manifestize, resolve_chunk_manifest)
from .filechunks import etag_of_chunks, read_chunk_views
from ..wdclient.masterclient import MasterClient
from .filer import Filer
from .filer_conf import FilerConf
from .filer_store import FilerStore, NotFoundError
from .meta_aggregator import MetaAggregator
from ..cache import TieredReadCache

DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024  # filer -maxMB default (4MB)
INLINE_LIMIT = 2048  # small-content inlining threshold
_DEFAULT_PREFETCH = 4


def prefetch_chunks() -> int:
    """Streaming-GET look-ahead window K; 0 disables streaming."""
    raw = os.environ.get("WEED_FILER_PREFETCH_CHUNKS", "")
    if not raw:
        return _DEFAULT_PREFETCH
    try:
        return max(0, int(raw))
    except ValueError:
        return _DEFAULT_PREFETCH


class FilerServer:
    def __init__(self, master_address: str, host: str = "127.0.0.1",
                 port: int = 0, store: Optional[FilerStore] = None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 replication: str = "", collection: str = "",
                 guard: Optional[Guard] = None,
                 peers: Optional[list[str]] = None,
                 persist_meta_log: bool = False,
                 chunk_cache_bytes: Optional[int] = None,
                 manifest_batch: int = MANIFEST_BATCH,
                 cipher: bool = False,
                 cache_dir: str = "",
                 cache_disk_bytes: int = 1 << 30,
                 device=None):
        # -master may name the whole raft trio ("a,b,c"): every
        # master call then fails over through the MasterClient (leader
        # hints, per-master breakers) instead of pinning one address
        self.masters = [m.strip() for m in master_address.split(",")
                        if m.strip()]
        self.master_address = self.masters[0]
        self._master_client = MasterClient(self.masters, name="filer")
        self.chunk_size = chunk_size
        self.replication = replication
        self.collection = collection
        # encrypt-at-rest: every uploaded chunk gets a fresh AES-256-GCM
        # key stored on its chunk record (-encryptVolumeData,
        # filer_server_handlers_write_cipher.go)
        if cipher:
            from ..util.cipher import cipher_available

            if not cipher_available():
                raise RuntimeError(
                    "-encryptVolumeData needs the cryptography library; "
                    "refusing to start a filer that would fail every "
                    "write")
        self.cipher = cipher
        self.guard = guard or Guard()
        self.filer = Filer(store)
        self.filer.on_delete_chunks = self._delete_chunks
        if persist_meta_log:
            self.filer.enable_meta_log()
        # unified tiered read-through cache (cache/): host RAM LRU,
        # optional HBM pinning (WEED_READ_CACHE_HBM_MB), and with a
        # -cacheDir the size-classed on-disk FIFO layers
        self.chunk_cache = TieredReadCache(
            mem_bytes=chunk_cache_bytes, directory=cache_dir,
            disk_bytes=cache_disk_bytes, device=device)
        self.manifest_batch = manifest_batch
        self.meta_aggregator: Optional[MetaAggregator] = None
        if peers:
            self.meta_aggregator = MetaAggregator(
                [p for p in peers if p])
        self._conf_cache: tuple[float, FilerConf] = (0.0, FilerConf())
        self._prefetch_lock = threading.Lock()
        self._prefetching: set[str] = set()
        # chunk fetches prefer the volume servers' TCP fast path (native
        # engine); servers without one are negative-cached per URL
        from ..wdclient.volume_tcp_client import VolumeTcpClient

        self._tcp_client = VolumeTcpClient()
        self._tcp_bad: dict[str, float] = {}
        # amortized fid leasing: one /dir/assign?count=N master call
        # hands out N fids locally (WEED_FILER_ASSIGN_LEASE)
        from ..wdclient import fid_lease

        self._fid_lease = fid_lease.FidLeaseCache(
            lambda n, repl, coll, t: self._assign(
                count=n, replication=repl, collection=coll, ttl=t),
            name=f"filer:{port}")
        # shared chunk I/O pool: upload fan-out, buffered-read fan-in and
        # the streaming-GET prefetch window all ride these threads instead
        # of paying a ThreadPoolExecutor spin-up per request
        self._io_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="filer-io")
        self.server = RpcServer(host, port, service_name="filer")
        # prefork workers must not touch a sqlite connection that was
        # opened before the fork; new serve threads reopen lazily
        self.server.on_worker_start(
            lambda wid: self.filer.store.forget_connections())
        # observability mounts shadow the matching user paths, like the
        # /metadata/, /remote/ and /kv/ prefixes below
        self.server.add("GET", "/metrics", stats.metrics_handler)
        self.server.add("GET", "/debug/traces", tracing.traces_handler)
        faults.mount(self.server)
        profiling.mount(self.server)
        # weighted-fair front-end admission (WEED_QOS_FILER_LIMIT; 0 =
        # classify/count only, never queue)
        self.qos_gate = qos.AdmissionGate("filer",
                                          limit_env="WEED_QOS_FILER_LIMIT")
        # workload analytics sketches for this filer's chunk traffic
        self.access_recorder = access.AccessRecorder(node="filer")
        qos.mount(self.server, gate=self.qos_gate)
        events_mod.mount(self.server)
        access.mount(self.server, self.access_recorder)
        healthz.mount_health(self.server, ready=self._ready_checks)
        self.server.add("GET", "/metadata/subscribe", self._h_subscribe)
        self.server.add("GET", "/metadata/aggregate", self._h_aggregate)
        self.server.add("POST", "/remote/configure", self._h_remote_configure)
        self.server.add("GET", "/remote/list", self._h_remote_list)
        self.server.add("POST", "/remote/mount", self._h_remote_mount)
        self.server.add("POST", "/remote/unmount", self._h_remote_unmount)
        self.server.add("POST", "/remote/meta_sync", self._h_remote_meta_sync)
        self.server.add("POST", "/remote/cache", self._h_remote_cache)
        self.server.add("POST", "/remote/uncache", self._h_remote_uncache)
        # generic KV (the HTTP/JSON face of filer_grpc_server_kv.go)
        self.server.add("GET", "/kv/get", self._h_kv_get)
        self.server.add("POST", "/kv/put", self._h_kv_put)
        self.server.add("POST", "/kv/delete", self._h_kv_delete)
        self.server.default_route = self._handle
        self._stop_event = threading.Event()
        self._register_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return self.server.address

    def _ready_checks(self):
        return [("master", bool(self.masters),
                 f"masters={','.join(self.masters) or 'unknown'}"),
                ("store", self.filer.store is not None,
                 type(self.filer.store).__name__
                 if self.filer.store is not None else "no store"),
                healthz.gate_check(self.qos_gate)]

    def start(self):
        self.server.start()
        if self.meta_aggregator is not None:
            self.meta_aggregator.start()
        self._register_thread = threading.Thread(
            target=self._register_loop, daemon=True)
        self._register_thread.start()

    def stop(self):
        self._stop_event.set()
        if self.meta_aggregator is not None:
            self.meta_aggregator.stop()
        self.server.stop()
        self.filer.close()  # flush buffered change-log events
        self.filer.store.close()
        self.chunk_cache.close()  # tiered cache drops its disk segments
        self._tcp_client.close()
        self._io_pool.shutdown(wait=False)

    # -- per-path configuration (filer_conf.go, 1s refresh) ------------------
    def filer_conf(self) -> FilerConf:
        ts, conf = self._conf_cache
        now = time.time()
        if now - ts > 1.0:
            conf = FilerConf.load(self.filer)
            self._conf_cache = (now, conf)
        return conf

    def _register_loop(self):
        """Announce this filer in the master's cluster registry
        (cluster.go KeepConnected membership).  The refresh interval tracks
        the master's pulse so liveness cutoffs (pulse*3) always see us."""
        interval = 5.0
        while not self._stop_event.is_set():
            try:
                # every master keeps its own in-memory membership
                # registry, so announce to all of them — the one that
                # wins the next election must already know this filer
                reachable = 0
                for m in self.masters:
                    try:
                        r = call(m, "/cluster/register",
                                 {"type": "filer",
                                  "address": self.address}, timeout=10)
                        reachable += 1
                        interval = min(5.0,
                                       float(r.get("pulse_seconds", 5.0)))
                    except RpcError:
                        continue
                if not reachable:
                    raise RpcError("no master reachable", 503)
            except RpcError:
                pass
            self._stop_event.wait(interval)

    # -- volume cluster plumbing ---------------------------------------------
    def _assign(self, count: int = 1, replication: str = "",
                collection: str = "", ttl: str = "") -> dict:
        query = f"count={count}"
        if replication or self.replication:
            query += f"&replication={replication or self.replication}"
        if collection or self.collection:
            query += f"&collection={collection or self.collection}"
        if ttl:
            # per-path TTL rules land chunks on TTL volume layouts the
            # master expires wholesale (filer_conf.go -> assign ttl)
            query += f"&ttl={ttl}"
        return self._master_client.call(f"/dir/assign?{query}",
                                        timeout=30)

    def _lookup_urls(self, fid: str) -> list[str]:
        """All replica holders of a fid's volume, via the policy layer
        (lookup GETs retry with jittered backoff on a flaky master)."""
        vid = fid.split(",")[0]
        found = self._master_client.call(
            f"/dir/lookup?volumeId={vid}", timeout=10)
        return [l["url"] for l in found["locations"]]

    def _lookup_url(self, fid: str) -> str:
        return self._lookup_urls(fid)[0]

    def _delete_chunks(self, chunks: list[FileChunk],
                       exclude_fids: Optional[set] = None):
        # expand manifest chunks so the data chunks they list are deleted
        # too (manifest blobs themselves, at every level, are also chunks
        # to reclaim); exclude_fids applies AFTER expansion so chunks a
        # manifest lists but another entry now owns survive (multipart
        # complete hands part data chunks to the final entry)
        if has_chunk_manifest(chunks):
            try:
                chunks = resolve_chunk_manifest(
                    self._fetch_chunk, chunks, keep_manifests=True)
            except (RpcError, ValueError):
                pass  # a manifest blob is already gone; delete what we have
        if exclude_fids:
            chunks = [c for c in chunks if c.fid not in exclude_fids]
        for chunk in chunks:
            # a deleted fid must never serve stale bytes out of the
            # read cache, even if a later write reuses the fid
            self.chunk_cache.invalidate(chunk.fid, reason="delete")
            headers = {}
            if self.guard.signing:
                # filer shares security.toml; sign its own delete token
                headers["Authorization"] = "BEARER " + gen_write_jwt(
                    self.guard.signing, chunk.fid)
            try:
                call(self._lookup_url(chunk.fid), f"/{chunk.fid}",
                     method="DELETE", headers=headers, timeout=10)
            except RpcError:
                pass  # chunk may already be gone; vacuum reclaims the rest

    # -- request routing -----------------------------------------------------
    def _handle(self, method: str, req: Request):
        if qos.enabled():
            cls = qos.current_class()
            if qos.QOS_HEADER not in req.headers:
                # unclassified gateway traffic: reads are interactive,
                # writes standard; the collection is the tenant key
                cls = qos.INTERACTIVE if method in ("GET", "HEAD") \
                    else qos.STANDARD
            # an upstream gateway's X-QoS-Tenant (the S3 layer sends
            # its sigv4-derived key) wins over the collection fallback
            # so usage accounting and the token buckets agree on who
            # the tenant is, whichever door the request came through
            tenant = (req.headers.get(qos.TENANT_HEADER)
                      or req.param("collection") or self.collection or "")
            cls = qos.class_for_tenant(tenant, cls)
            release = self.qos_gate.admit(cls, tenant)
            prev = qos.set_qos(cls, tenant)
            try:
                return self._handle_inner(method, req)
            finally:
                qos.set_qos(*prev)
                release()
        return self._handle_inner(method, req)

    def _handle_inner(self, method: str, req: Request):
        path = req.path or "/"
        if method in ("GET", "HEAD"):
            stats.FilerRequestCounter.labels("read").inc()
            with stats.FilerRequestHistogram.labels("read").time():
                return self._h_read(path, req, method)
        # mutations: stamp the caller's replication signature (if any) onto
        # the resulting metadata events so sync loops can break cycles
        sig_header = req.headers.get("X-Sw-Signature", "")
        try:
            sigs = [int(s) for s in sig_header.split(",") if s.strip()] \
                if sig_header else None
        except ValueError:
            raise RpcError("malformed X-Sw-Signature header", 400)
        self.filer.set_event_signatures(sigs)
        try:
            if method in ("POST", "PUT"):
                stats.FilerRequestCounter.labels("write").inc()
                with stats.FilerRequestHistogram.labels("write").time():
                    return self._h_write(path, req)
            if method == "DELETE":
                stats.FilerRequestCounter.labels("delete").inc()
                with stats.FilerRequestHistogram.labels("delete").time():
                    return self._h_delete(path, req)
        finally:
            self.filer.set_event_signatures(None)
        raise RpcError(f"unsupported method {method}", 405)

    def _check_writable(self, path: str):
        """Reject mutation of a read-only prefix (filer_conf.go rules)."""
        if self.filer_conf().match_path(self.filer._norm(path)).read_only:
            raise RpcError(f"{path} is read-only", 403)

    # -- write (auto-chunk) --------------------------------------------------
    def _h_write(self, path: str, req: Request):
        if "tagging" in req.query:
            # add/replace Seaweed- prefixed attributes from headers
            # (PutTaggingHandler, filer_server_handlers_tagging.go:16-54)
            return self._h_put_tagging(path, req)
        move_from = req.param("mv.from")
        if move_from:
            self._check_writable(move_from)
            self._check_writable(path)
            try:
                self.filer.rename(move_from, path)
            except NotFoundError:
                raise RpcError(f"{move_from} not found", 404)
            return {"from": move_from, "to": path}

        if path.endswith("/"):
            # mkdir-style: create the directory entry
            from .entry import new_directory_entry

            self._check_writable(path)
            self.filer.create_entry(new_directory_entry(
                self.filer._norm(path)))
            return {"name": path}

        if req.param("meta") == "true":
            # metadata-only restore (fs.meta.load): recreate the entry
            # record verbatim — chunk fids must still be resolvable
            self._check_writable(path)
            entry = Entry.from_dict(req.json())
            entry.full_path = self.filer._norm(path)
            self.filer.create_entry(entry)
            return {"name": entry.name, "size": entry.size()}

        body = req.body
        mime = req.headers.get("Content-Type") or ""
        entry = self.save_bytes(path, body, mime,
                                extended=self._seaweed_headers(req))
        return {"name": entry.name, "size": len(body),
                "md5": entry.attr.md5}

    @staticmethod
    def _is_tag(name) -> bool:
        """Case-insensitive Seaweed- prefix test, used consistently by
        the write, read, response-header, and delete paths (clients and
        HTTP/2 intermediaries may lowercase header names)."""
        return isinstance(name, str) and \
            name.lower().startswith(PAIR_NAME_PREFIX.lower())

    @staticmethod
    def _seaweed_headers(req: Request) -> dict:
        """Seaweed- prefixed request headers become extended attributes
        (needle.PairNamePrefix pass-through, the tagging surface)."""
        out = {}
        for name in req.headers:
            if FilerServer._is_tag(name):
                out[name] = req.headers[name]
        return out

    def _h_put_tagging(self, path: str, req: Request):
        self._check_writable(path)
        try:
            entry = self.filer.find_entry(path)
        except NotFoundError:
            raise RpcError(f"{path} not found", 404)
        entry.extended = dict(entry.extended or {})
        entry.extended.update(self._seaweed_headers(req))
        self.filer.update_entry(entry)
        return Response(b"", 202)

    def _h_delete_tagging(self, path: str, req: Request):
        """Remove all (or the listed) Seaweed- attributes
        (DeleteTaggingHandler: ?tagging=tag1,tag2 picks specific tags)."""
        self._check_writable(path)
        try:
            entry = self.filer.find_entry(path)
        except NotFoundError:
            raise RpcError(f"{path} not found", 404)
        wanted = {t.strip().lower() for t in
                  (req.param("tagging") or "").split(",") if t.strip()}
        kept, dropped = {}, False
        for k, v in (entry.extended or {}).items():
            if self._is_tag(k) and (
                    not wanted
                    or k[len(PAIR_NAME_PREFIX):].lower() in wanted):
                dropped = True
                continue
            kept[k] = v
        if not dropped:
            return Response(b"", 304)
        entry.extended = kept
        self.filer.update_entry(entry)
        return Response(b"", 202)

    def _proxy_chunk(self, file_id: str, req: Request):
        """Relay one chunk through the filer
        (filer_server_handlers_proxy.go proxyToVolumeServer).  Range
        requests fetch the whole chunk and slice locally so the reply
        carries a correct 206 + Content-Range (forwarding the Range and
        rewrapping as 200 would mislabel a partial body as complete)."""
        url = self._lookup_url(file_id)
        try:
            data = call(url, f"/{file_id}", timeout=30)
        except RpcError as e:
            raise RpcError(f"proxy chunk {file_id}: {e}", e.status or 502)
        if not isinstance(data, (bytes, bytearray)):
            import json as _json

            data = _json.dumps(data).encode()
        data = bytes(data)
        range_header = req.headers.get("Range", "")
        if range_header.startswith("bytes="):
            size = len(data)
            spec = range_header[6:].split(",")[0]
            lo_s, _, hi_s = spec.partition("-")
            if lo_s:
                start = int(lo_s)
                stop = min(int(hi_s), size - 1) + 1 if hi_s else size
            else:  # suffix range
                start = max(0, size - int(hi_s or 0))
                stop = size
            if start >= size or stop <= start:
                raise RpcError("range not satisfiable", 416)
            return Response(
                data[start:stop], 206, "application/octet-stream",
                {"Content-Range": f"bytes {start}-{stop - 1}/{size}"})
        return Response(data, 200, "application/octet-stream")

    def _assign_leased(self, replication: str = "", collection: str = "",
                       ttl: str = "") -> dict:
        """Assign one fid, preferring the lease cache (batched master
        calls); the cache keys on the EFFECTIVE placement parameters so
        per-path rules and server defaults cannot alias."""
        from ..wdclient import fid_lease

        repl = replication or self.replication
        coll = collection or self.collection
        if fid_lease.lease_count() <= 1:
            return self._assign(replication=repl, collection=coll, ttl=ttl)
        return self._fid_lease.get(replication=repl, collection=coll,
                                   ttl=ttl)

    def _upload_assigned(self, assign: dict, payload: bytes) -> dict:
        """Push one blob at its assigned fid; TCP fast path when the
        cluster is unauthenticated, HTTP otherwise/on fallback."""
        fid, url = assign["fid"], assign["url"]
        up = None
        if not assign.get("auth"):
            # unauthenticated cluster: chunk uploads ride the native
            # fast path (the W protocol carries no JWT; the native
            # server is only up when signing is off). 307/absence falls
            # back to HTTP below.
            up = self._upload_chunk_tcp(url, fid, payload)
        if up is None:
            headers = {"Content-Type": "application/octet-stream"}
            if assign.get("auth"):
                # forward the assign-minted write JWT (jwt-enabled
                # cluster)
                headers["Authorization"] = "BEARER " + assign["auth"]
            # re-POSTing the same fid+payload dedups on the volume
            # server (unchanged-content check), so the chunk upload is
            # safely retryable and rides the breaker for its target
            up = policy.call_policy(
                url, f"/{fid}", raw=payload, method="POST",
                headers=headers, timeout=60, idempotent=True)
        return up

    def _upload_blob(self, piece: bytes, replication: str = "",
                     collection: str = "", ttl: str = "") -> FileChunk:
        """Assign a fid and upload one blob to the volume cluster; with
        -encryptVolumeData the volume only ever sees AES-GCM ciphertext
        and the per-chunk key rides the chunk record (fs.encrypt,
        filer_server_handlers_write_cipher.go)."""
        key = b""
        payload = piece
        if self.cipher:
            from ..util.cipher import encrypt, gen_cipher_key

            key = gen_cipher_key()
            payload = encrypt(piece, key)
        with tracing.span("filer.assign"):
            assign = self._assign_leased(replication=replication,
                                         collection=collection, ttl=ttl)
        try:
            up = self._upload_assigned(assign, payload)
        except RpcError as e:
            # a leased fid can go stale between master calls (volume
            # recycled/full, expired write JWT): drop the batch and
            # retry exactly once with a fresh direct assign
            if not assign.get("leased") or \
                    e.status not in (401, 403, 404, 500, 503):
                raise
            stats.FilerFidLeaseCounter.labels("stale_retry").inc()
            self._fid_lease.invalidate(reason=f"upload {e.status}")
            with tracing.span("filer.assign"):
                assign = self._assign(replication=replication,
                                      collection=collection, ttl=ttl)
            up = self._upload_assigned(assign, payload)
        # size is the PLAINTEXT length: interval math over the logical
        # file must not see the nonce/tag overhead
        return FileChunk(fid=assign["fid"], offset=0, size=len(piece),
                         etag=up.get("eTag", ""),
                         modified_ts_ns=time.time_ns(),
                         cipher_key=key)

    def save_bytes(self, path: str, body: bytes, mime: str = "",
                   extended: Optional[dict] = None) -> Entry:
        """Auto-chunked write used by both the filer HTTP API and the S3
        gateway: small bodies inline, larger ones chunk to the volume
        cluster (doPutAutoChunk, _write_upload.go); per-path rules from
        /etc/seaweedfs/filer.conf pick collection/replication and enforce
        read-only prefixes."""
        with tracing.span("filer.save", tags={"bytes": len(body)}):
            return self._save_bytes(path, body, mime, extended)

    def _save_bytes(self, path: str, body: bytes, mime: str = "",
                    extended: Optional[dict] = None) -> Entry:
        path = self.filer._norm(path)
        rule = self.filer_conf().match_path(path)
        if rule.read_only:
            raise RpcError(f"{rule.location_prefix} is read-only", 403)
        if rule.max_file_name_length and \
                len(path.rsplit("/", 1)[-1]) > rule.max_file_name_length:
            raise RpcError("file name too long", 400)
        now = time.time()
        md5 = hashlib.md5(body).hexdigest()
        ttl_sec = 0
        rule_ttl = rule.ttl
        if rule_ttl:
            from ..storage.ttl import TTL

            try:
                ttl_sec = TTL.parse(rule_ttl).minutes() * 60
            except ValueError:
                # a malformed rule must fail the SAME way for inline and
                # chunked writes: drop it everywhere, don't ship the raw
                # string to /dir/assign where parsing would 500 — but
                # say so, or 'temporary' data quietly becomes permanent
                from ..util import glog

                glog.warningf("ignoring malformed ttl %r on rule %s",
                              rule_ttl, rule.location_prefix)
                ttl_sec, rule_ttl = 0, ""
        entry = Entry(
            full_path=path,
            attr=Attr(mtime=now, crtime=now, mime=mime, md5=md5,
                      file_size=len(body), ttl_sec=ttl_sec),
            extended=extended or {})
        if len(body) <= INLINE_LIMIT:
            entry.content = body
        else:
            offsets = list(range(0, len(body), self.chunk_size))
            failed = threading.Event()
            # chunk uploads run on pool threads that do not inherit this
            # thread's trace context: hand them the parent explicitly
            parent_span = tracing.current()

            def upload(off: int) -> FileChunk:
                if failed.is_set():
                    # a sibling chunk already failed: do not keep
                    # uploading thousands of soon-to-be-orphaned blobs
                    raise RpcError("aborted: sibling chunk failed", 500)
                try:
                    piece = body[off:off + self.chunk_size]
                    with tracing.span("filer.chunk_upload",
                                      parent=parent_span,
                                      tags={"offset": off,
                                            "bytes": len(piece)}):
                        chunk = self._upload_blob(piece, rule.replication,
                                                  rule.collection, rule_ttl)
                except Exception:
                    failed.set()
                    raise
                chunk.offset = off
                return chunk

            if len(offsets) == 1:
                entry.chunks = [upload(0)]
            else:
                # upload chunks concurrently (the reference fans chunk
                # uploads out per goroutine, _write_upload.go): a large
                # body otherwise pays one serial assign+POST round trip
                # per chunk.  The shared I/O pool overlaps the
                # slice/encrypt work of later chunks with the uploads of
                # earlier ones.  On failure the fan-out aborts and the
                # already-uploaded siblings are best-effort DELETEd:
                # vacuum only compacts deleted needles, so a
                # never-referenced upload would otherwise leak until its
                # volume is removed
                futures = [self._io_pool.submit(upload, off)
                           for off in offsets]
                uploaded, first_err = [], None
                for f in futures:
                    try:
                        uploaded.append(f.result())
                    except Exception as e:  # noqa: BLE001 — re-raised
                        if first_err is None:
                            first_err = e
                if first_err is not None:
                    try:
                        self._delete_chunks(uploaded)
                    except Exception:  # noqa: BLE001 — reclamation only
                        pass
                    raise first_err
                entry.chunks = uploaded
            entry.chunks = maybe_manifestize(
                lambda blob: self._upload_blob(blob, rule.replication,
                                               rule.collection, rule_ttl),
                entry.chunks, self.manifest_batch)
        with tracing.span("filer.meta_save"):
            self.filer.create_entry(entry)
        return entry

    def _fetch_chunk(self, fid: str) -> bytes:
        """Whole-chunk fetch through the LRU chunk cache
        (reader_cache.go)."""
        from ..stats.metrics import FilerChunkCacheCounter

        t0 = time.monotonic()
        cached = self.chunk_cache.get(fid)
        if cached is not None:
            FilerChunkCacheCounter.inc(labels=("hit",))
            self._record_chunk(fid, len(cached),
                               time.monotonic() - t0, "ram")
            return cached
        FilerChunkCacheCounter.inc(labels=("miss",))
        urls = self._lookup_urls(fid)
        if not urls:
            raise RpcError(f"chunk {fid} has no locations", 404)
        jwt = (gen_read_jwt(self.guard.read_signing, fid)
               if self.guard.read_signing else "")
        data = self._fetch_chunk_tcp(urls[0], fid, jwt) if urls else None
        if data is None:
            headers = {"Authorization": "BEARER " + jwt} if jwt else {}

            def fetch(url):
                def attempt():
                    got = call(url, f"/{fid}", headers=headers,
                               timeout=60)
                    if isinstance(got, dict):
                        raise RpcError(f"chunk {fid} fetch failed", 500,
                                       addr=url, route=f"/{fid}")
                    return bytes(got)
                return attempt

            # hedged replica read: when the volume is replicated, a slow
            # holder is raced by the next replica after the adaptive p95
            # delay; on single-copy volumes this degenerates to one call
            data = policy.hedged(
                "/chunk_fetch", [fetch(u) for u in urls])
        self.chunk_cache.put(fid, data)
        self._record_chunk(fid, len(data), time.monotonic() - t0, "miss")
        return data

    def _record_chunk(self, fid: str, nbytes: int, latency_s: float,
                      tier: str):
        """Workload analytics: every chunk fetch (cache hit or volume
        round trip) heats the fid's sketch entry under the tenant the
        QoS layer attributed (X-QoS-Tenant / collection)."""
        try:
            vid = int(fid.split(",", 1)[0])
        except (ValueError, AttributeError):
            vid = 0
        self.access_recorder.record(
            "chunk", collection=self.collection or "",
            tenant=qos.current_tenant(), volume=vid, fid=fid,
            nbytes=nbytes, latency_s=latency_s,
            qos_class=qos.current_class(), cache_tier=tier)

    def _upload_chunk_tcp(self, url: str, fid: str, payload: bytes):
        """Write one chunk over the fast-path port; None to fall back
        to HTTP (no native port, replicated/TTL volume, error)."""
        import json as _json

        from ..wdclient.volume_tcp_client import VolumeTcpError

        now = time.time()
        if now < self._tcp_bad.get(url, 0.0):
            return None
        try:
            raw = self._tcp_client.write_needle(url, fid, payload)
            return _json.loads(raw)
        except VolumeTcpError as e:
            if e.status == 404:
                # the fid itself is bad (stale lease / recycled volume):
                # the port works fine — raise so the lease retry path
                # can re-assign instead of blacklisting the fast path
                raise RpcError(f"chunk {fid} upload: volume gone",
                               404) from None
            self._tcp_bad[url] = now + 60.0
            return None
        except Exception:
            # 307 already fell back to HTTP inside the client; anything
            # surfacing here means the port itself is unusable
            self._tcp_bad[url] = now + 60.0
            return None

    def _fetch_chunk_tcp(self, url: str, fid: str, jwt: str):
        """Try the volume server's TCP fast path for the chunk fetch
        (served off-GIL by the native engine when built).  Servers
        without a fast-path port — or answering 307 for this volume —
        are negative-cached so the filer pays one probe per minute, not
        two RPCs per chunk.  Returns None to fall back to HTTP; raises
        for a real miss (the chunk is gone either way)."""
        from ..wdclient.volume_tcp_client import VolumeTcpError

        now = time.time()
        if now < self._tcp_bad.get(url, 0.0):
            return None
        try:
            return self._tcp_client.read_needle(url, fid, jwt=jwt,
                                                http_fallback=False)
        except VolumeTcpError as e:
            if e.status == 404:
                raise RpcError(f"chunk {fid} not found", 404) from None
            self._tcp_bad[url] = now + 60.0
            return None
        except Exception:
            self._tcp_bad[url] = now + 60.0
            return None

    def read_bytes(self, entry: Entry, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        """Reassemble [start, start+length) of an entry's content."""
        with tracing.span("filer.read",
                          tags={"bytes": length if length is not None
                                else entry.size() - start}):
            return b"".join(self._read_parts(entry, start, length))

    def read_view(self, entry: Entry, start: int = 0,
                  length: Optional[int] = None):
        """Zero-copy buffered read: ``(parts, n)`` where `parts` is a
        list of buffers (`memoryview` slices over cached chunk bytes)
        covering [start, start+n) — written straight into the socket
        send with no intermediate `bytes` concatenation."""
        with tracing.span("filer.read",
                          tags={"bytes": length if length is not None
                                else entry.size() - start}):
            parts = self._read_parts(entry, start, length)
        return parts, sum(len(p) for p in parts)

    def _read_parts(self, entry: Entry, start: int = 0,
                    length: Optional[int] = None) -> list:
        size = entry.size()
        if length is None:
            length = size - start
        if entry.content:
            return [memoryview(entry.content)[start:start + length]]
        if entry.remote_entry and not entry.chunks:
            # metadata-only remote mount entry: read through to the
            # remote object (read_remote.go; remote.cache materialises)
            from .remote_storage import read_through

            return [memoryview(read_through(self.filer, entry))
                    [start:start + length]]
        chunks = entry.chunks
        if has_chunk_manifest(chunks):
            chunks = resolve_chunk_manifest(self._fetch_chunk, chunks)
        views = read_chunk_views(chunks, start, length)
        # fetch+decrypt once per UNIQUE chunk (overwrites can split one
        # chunk into several views), concurrently like the write fan-out
        # (stream.go reads chunk views in parallel goroutines); the
        # first failure short-circuits the queued fetches
        keys = {v.fid: v.cipher_key for v in views}
        fids = list(keys)
        failed = threading.Event()
        # pool threads lack the request thread's trace AND QoS context:
        # hand both over explicitly so chunk fetches keep the caller's
        # tenant attribution (access records, outbound QoS headers)
        parent_span = tracing.current()
        qos_cls, qos_tenant = qos.current_class(), qos.current_tenant()

        def fetch(fid: str) -> bytes:
            if failed.is_set():
                raise RpcError("aborted: sibling chunk fetch failed", 500)
            try:
                with qos.qos_scope(qos_cls, qos_tenant), \
                        tracing.span("filer.chunk_fetch",
                                     parent=parent_span,
                                     tags={"fid": fid}):
                    data = self._fetch_chunk(fid)
                if keys[fid]:
                    # cache holds what the volume stores (ciphertext);
                    # plaintext exists only in flight
                    from ..util.cipher import decrypt

                    data = decrypt(data, keys[fid])
            except Exception:
                failed.set()
                raise
            return data

        if len(fids) <= 1:
            blobs = {fid: fetch(fid) for fid in fids}
        else:
            blobs = dict(zip(fids, self._io_pool.map(fetch, fids)))
        # memoryview slices over the (immutable) fetched chunk bytes:
        # the socket writes them directly, so a GET never copies the
        # payload after the fetch/decrypt step
        parts = [memoryview(blobs[v.fid])[v.offset_in_chunk:
                                          v.offset_in_chunk + v.size]
                 for v in views]
        self._maybe_prefetch(chunks, start + length)
        return parts

    def _maybe_prefetch(self, chunks, next_offset: int):
        """Sequential read-ahead (reader_cache.go MaybeCache +
        reader_pattern.go): warm the chunk that starts where this read
        ended, in the background, so streaming readers never stall on
        the next fetch."""
        nxt = next((c for c in chunks if c.offset == next_offset), None)
        if nxt is None or self.chunk_cache.get(nxt.fid) is not None:
            return
        with self._prefetch_lock:
            if nxt.fid in self._prefetching or \
                    len(self._prefetching) >= 4:  # bounded look-ahead
                return
            self._prefetching.add(nxt.fid)
        qos_cls, qos_tenant = qos.current_class(), qos.current_tenant()

        def fetch():
            try:
                # the read-ahead is caused by this reader: bill it to
                # the same tenant the triggering request carried
                with qos.qos_scope(qos_cls, qos_tenant):
                    self._fetch_chunk(nxt.fid)
            except RpcError:
                pass  # a miss here is only a lost optimisation
            finally:
                with self._prefetch_lock:
                    self._prefetching.discard(nxt.fid)

        threading.Thread(target=fetch, daemon=True,
                         name=f"prefetch-{nxt.fid}").start()

    # -- streamed read -------------------------------------------------------
    def read_stream(self, entry: Entry, start: int = 0,
                    length: Optional[int] = None
                    ) -> Optional[tuple[Iterator[bytes], int]]:
        """Bounded-window streaming read: a (chunk iterator, byte count)
        pair for [start, start+length), or None when the buffered path
        is the right answer (inline content, remote mounts, single-chunk
        bodies, or streaming disabled via WEED_FILER_PREFETCH_CHUNKS=0).

        Up to K chunk fetches run ahead of the reply cursor on the
        shared I/O pool — chunks complete out of order, bytes are
        yielded in order — so first-byte latency is one chunk fetch
        regardless of object size.  The first chunk is fetched before
        this returns: common failures (missing chunk, no locations)
        still surface as a proper error status instead of a truncated
        200."""
        if prefetch_chunks() <= 0:
            return None
        size = entry.size()
        if length is None:
            length = size - start
        if entry.content or not entry.chunks or \
                (entry.remote_entry and not entry.chunks):
            return None
        chunks = entry.chunks
        if has_chunk_manifest(chunks):
            chunks = resolve_chunk_manifest(self._fetch_chunk, chunks)
        views = read_chunk_views(chunks, start, length)
        if len({v.fid for v in views}) <= 1:
            return None  # nothing to pipeline; buffered path is simpler
        span = tracing.start("filer.stream", tags={"bytes": length})
        gen = self._stream_views(views, span)
        try:
            first = next(gen)
        except StopIteration:
            span.finish()
            return iter(()), 0
        except BaseException:
            span.finish(status="error")
            raise

        def run():
            try:
                yield first
                yield from gen
            finally:
                span.finish()

        return run(), length

    def _stream_views(self, views, parent_span) -> Iterator[bytes]:
        keys = {v.fid: v.cipher_key for v in views}
        order = list(keys)  # unique fids in first-use order
        pos = {fid: i for i, fid in enumerate(order)}
        last_use: dict[str, int] = {}
        for i, v in enumerate(views):
            last_use[v.fid] = i
        window = max(1, prefetch_chunks())
        # captured at generator start (inside the request's QoS scope);
        # window fetches run on pool threads after the dispatch scope
        # has been restored, so they need the pair pinned explicitly
        qos_cls, qos_tenant = qos.current_class(), qos.current_tenant()

        def fetch(fid: str) -> bytes:
            with qos.qos_scope(qos_cls, qos_tenant), \
                    tracing.span("filer.chunk_fetch", parent=parent_span,
                                 tags={"fid": fid}):
                data = self._fetch_chunk(fid)
            if keys[fid]:
                from ..util.cipher import decrypt

                data = decrypt(data, keys[fid])
            return data

        futures: dict[str, object] = {}
        submitted = 0

        def pump(cursor: int):
            # keep fetches in flight for the window ahead of the cursor
            nonlocal submitted
            while submitted < len(order) and submitted <= cursor + window:
                fid = order[submitted]
                futures[fid] = self._io_pool.submit(fetch, fid)
                submitted += 1

        blobs: dict[str, bytes] = {}
        try:
            for i, v in enumerate(views):
                cursor = pos[v.fid]
                pump(cursor)
                stats.FilerPrefetchWindowGauge.set(
                    submitted - cursor - 1)
                blob = blobs.get(v.fid)
                if blob is None:
                    blob = futures.pop(v.fid).result()
                    blobs[v.fid] = blob
                yield blob[v.offset_in_chunk:v.offset_in_chunk + v.size]
                if last_use[v.fid] == i:
                    blobs.pop(v.fid, None)  # free as the cursor passes
        finally:
            stats.FilerPrefetchWindowGauge.set(0)
            for f in futures.values():
                f.cancel()

    # -- read ----------------------------------------------------------------
    def _h_read(self, path: str, req: Request, method: str):
        proxy_chunk = req.param("proxyChunkId")
        if proxy_chunk:
            # direct filer->volume chunk relay for clients that cannot
            # reach volume servers (filer_server_handlers_proxy.go)
            return self._proxy_chunk(proxy_chunk, req)
        try:
            with tracing.span("filer.lookup"):
                entry = self.filer.find_entry(path)
        except NotFoundError:
            raise RpcError(f"{path} not found", 404)
        if "tagging" in req.query:
            # object tags as JSON (the Seaweed- extended attributes;
            # write with PUT ?tagging, remove with DELETE ?tagging)
            return {k: v for k, v in (entry.extended or {}).items()
                    if self._is_tag(k)}
        if entry.is_directory:
            if "text/html" in (req.headers.get("Accept") or ""):
                return self._render_ui(entry)  # browser surface
            return self._list_directory(entry, req)

        size = entry.size()
        start, length = 0, size
        status = 200
        headers = {}
        range_header = req.headers.get("Range")
        if range_header and range_header.startswith("bytes="):
            spec = range_header[6:].split(",")[0]
            lo_s, _, hi_s = spec.partition("-")
            lo = int(lo_s) if lo_s else None
            hi = int(hi_s) if hi_s else None
            if lo is None:  # suffix range: last N bytes
                start = max(0, size - (hi or 0))
                length = size - start
            else:
                start = lo
                length = (min(hi, size - 1) - lo + 1) if hi is not None \
                    else size - lo
            if start >= size or length <= 0:
                raise RpcError("range not satisfiable", 416)
            status = 206
            headers["Content-Range"] = \
                f"bytes {start}-{start + length - 1}/{size}"

        if entry.attr.mime:
            content_type = entry.attr.mime
        else:
            content_type = "application/octet-stream"
        headers["Etag"] = f'"{entry.attr.md5 or etag_of_chunks(entry.chunks)}"'
        headers["Accept-Ranges"] = "bytes"
        for k, v in (entry.extended or {}).items():
            # tags ride responses as Seaweed- headers (the reference's
            # read path exposes PairNamePrefix attributes this way)
            if self._is_tag(k) and isinstance(v, str):
                headers[k] = v
        if method == "HEAD":
            headers["Content-Length"] = str(length)
            return Response(b"", status, content_type, headers)

        zero = self._sendfile_read(entry, start, length, status,
                                   content_type, headers)
        if zero is not None:
            return zero
        streamed = self.read_stream(entry, start, length)
        if streamed is not None:
            body_iter, n = streamed
            # a known length keeps the reply on raw writes (no chunked
            # framing) while _reply_stream flushes chunk by chunk
            headers["Content-Length"] = str(n)
            stats.FilerStreamedReadCounter.labels("streamed").inc()
            return Response(body_iter, status, content_type, headers)
        # buffered path: memoryview parts over cached chunk bytes go
        # straight into the socket send — no b"".join copy
        parts, n = self.read_view(entry, start, length)
        headers["Content-Length"] = str(n)
        stats.FilerStreamedReadCounter.labels("zero_copy").inc()
        body = parts[0] if len(parts) == 1 else iter(parts)
        return Response(body, status, content_type, headers)

    def _sendfile_read(self, entry: Entry, start: int, length: int,
                       status: int, content_type: str, headers: dict):
        """Zero-copy GET for the common hot case: a single-chunk,
        cipher-free entry whose chunk sits in the on-disk cache tier —
        the bytes go disk cache -> socket via sendfile without ever
        entering Python.  Returns None to fall back to the streamed /
        buffered paths (RAM-cached chunks stay on those: an in-memory
        memoryview write is already zero-copy for them)."""
        if not sendfile_enabled() or entry.content \
                or len(entry.chunks) != 1:
            return None
        c = entry.chunks[0]
        if c.cipher_key or c.is_chunk_manifest or c.offset != 0:
            return None
        if start < 0 or start + length > c.size:
            return None
        sl = self.chunk_cache.get_slice(c.fid)
        if sl is None:
            return None
        fd, off, ln = sl
        if ln != c.size:  # cached bytes disagree with metadata: stale
            os.close(fd)
            return None
        headers["Content-Length"] = str(length)
        stats.FilerStreamedReadCounter.labels("sendfile").inc()
        return Response(FileSlice(fd, off + start, length, close_fd=True),
                        status, content_type, headers)

    def _list_directory(self, entry: Entry, req: Request):
        limit = int(req.param("limit", "100"))
        last = req.param("lastFileName", "") or ""
        entries = self.filer.list_directory(
            entry.full_path, start_file=last, limit=limit,
            prefix=req.param("prefix", "") or "",
            name_pattern=req.param("namePattern", "") or "",
            name_pattern_exclude=req.param("namePatternExclude", "") or "")
        if req.param("metadata") == "true":
            # full entry dicts incl. chunks (fs.meta.cat / fsck surface)
            rendered = [e.to_dict() for e in entries]
        else:
            rendered = [
                {
                    "FullPath": e.full_path,
                    "Mtime": e.attr.mtime,
                    "Mode": e.attr.mode,
                    "Mime": e.attr.mime,
                    "FileSize": e.size(),
                    "IsDirectory": e.is_directory,
                } for e in entries
            ]
        return {
            "Path": entry.full_path,
            "Entries": rendered,
            "Limit": limit,
            "LastFileName": entries[-1].name if entries else "",
            "ShouldDisplayLoadMore": len(entries) == limit,
        }

    # -- delete --------------------------------------------------------------
    def _h_delete(self, path: str, req: Request):
        if "tagging" in req.query:
            return self._h_delete_tagging(path, req)
        self._check_writable(path)
        recursive = req.param("recursive") == "true"
        try:
            self.filer.delete_entry(
                path, recursive=recursive,
                delete_chunks=req.param("skipChunkDelete") != "true")
        except NotFoundError:
            raise RpcError(f"{path} not found", 404)
        except ValueError as e:
            raise RpcError(str(e), 400)
        return Response(b"", 204)

    def _render_ui(self, entry: Entry) -> Response:
        """Browser UI (server/filer_ui): served when a directory GET asks
        for text/html — a dedicated /ui route would shadow a stored file
        at that path, so content negotiation picks the surface instead."""
        from . import remote_storage as rs
        from ..util import ui

        entries = self.filer.list_directory(entry.full_path, limit=1000)
        prefix = entry.full_path.rstrip("/")
        listing = ui.table(
            ("name", "type", "size"),
            [(f"{prefix}/{e.name}",
              "dir" if e.is_directory else (e.attr.mime or "file"),
              "-" if e.is_directory else e.size()) for e in entries])
        mappings = rs.read_mount_mappings(self.filer)
        body = ui.page(
            f"SeaweedFS-TPU Filer {self.address} — {entry.full_path}",
            ui.section("Filer", ui.kv_table({
                "master": self.master_address,
                "store": type(self.filer.store).__name__,
                "chunk size": self.chunk_size,
                "metadata log": "persisted"
                if self.filer.meta_log_enabled else "in-memory",
                "peers": ", ".join(self.meta_aggregator.peers)
                if self.meta_aggregator else "-",
            })),
            ui.section(f"Listing of {entry.full_path}", listing),
            ui.section("Remote mounts", ui.table(
                ("directory", "remote"), sorted(mappings.items()))),
        )
        return Response(body, content_type="text/html; charset=utf-8")

    # -- remote storage mounts (weed/filer/remote_storage.go; shell
    # remote.* commands drive these endpoints) -------------------------------
    def _h_remote_configure(self, req: Request):
        from ..remote_storage import RemoteConf
        from . import remote_storage as rs

        p = req.json()
        if p.get("delete"):
            rs.delete_remote_conf(self.filer, p["name"])
            return {}
        conf = RemoteConf.from_dict(p)
        if conf.type not in ("s3", "local"):
            raise RpcError(f"unknown remote type {conf.type!r}", 400)
        rs.save_remote_conf(self.filer, conf)
        return conf.to_dict()

    def _h_remote_list(self, req: Request):
        from . import remote_storage as rs

        return {
            "storages": [c.to_dict()
                         for c in rs.list_remote_confs(self.filer)],
            "mappings": rs.read_mount_mappings(self.filer),
        }

    def _h_remote_mount(self, req: Request):
        from ..remote_storage import RemoteLocation
        from . import remote_storage as rs

        p = req.json()
        directory, remote = p["dir"], p["remote"]
        try:  # validate the storage name before touching any state
            rs.load_remote_conf(self.filer,
                                RemoteLocation.parse(remote).name)
        except NotFoundError as e:
            raise RpcError(str(e), 404)
        self.filer._ensure_parents(directory.rstrip("/") or "/")
        from .entry import new_directory_entry

        try:
            self.filer.find_entry(directory.rstrip("/"))
        except NotFoundError:
            self.filer.create_entry(
                new_directory_entry(directory.rstrip("/")))
        rs.insert_mount_mapping(self.filer, directory, remote)
        synced = rs.sync_metadata(self.filer, directory)
        return {"dir": directory, "remote": remote, "synced": synced}

    def _h_remote_unmount(self, req: Request):
        from . import remote_storage as rs

        directory = req.json()["dir"].rstrip("/") or "/"
        if directory not in rs.read_mount_mappings(self.filer):
            raise RpcError(f"{directory} is not mounted", 404)
        rs.delete_mount_mapping(self.filer, directory)
        try:
            self.filer.delete_entry(directory, recursive=True)
        except NotFoundError:
            pass
        return {}

    def _h_remote_meta_sync(self, req: Request):
        from . import remote_storage as rs

        directory = req.json()["dir"]
        try:
            return {"synced": rs.sync_metadata(self.filer, directory)}
        except NotFoundError as e:
            raise RpcError(str(e), 404)

    def _walk_remote_entries(self, directory: str):
        stack = [directory.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            for e in self.filer.list_directory(d, limit=100000):
                if e.is_directory:
                    stack.append(e.full_path)
                elif e.remote_entry:
                    yield e

    def _h_remote_cache(self, req: Request):
        """Materialise remote objects locally (command_remote_cache.go).

        Large objects are fetched BY THE VOLUME SERVER (the
        FetchAndWriteNeedle analogue, /admin/remote/fetch_write —
        volume_grpc_remote.go:16-83): the filer assigns fids and sends
        the remote conf+location+range; object bytes flow external
        store -> volume server, never through this process.  Small
        objects (inline threshold) and volume servers without the RPC
        fall back to filer-transit."""
        from . import remote_storage as rs
        from ..storage.types import parse_file_id

        directory = req.json()["dir"]
        cached = 0
        for entry in self._walk_remote_entries(directory):
            if entry.chunks or entry.content:
                continue  # already cached
            size = int((entry.remote_entry or {}).get("remote_size", 0))
            # cipher-enabled filers keep the transit path: volumes must
            # only ever see ciphertext, which the volume server cannot
            # produce from the plaintext remote object
            mapped = rs.mapped_location(self.filer, entry.full_path) \
                if size > INLINE_LIMIT and not self.cipher else None
            if mapped is not None:
                _, loc = mapped
                conf = rs.load_remote_conf(self.filer, loc.name)
                chunks = []
                try:
                    for off in range(0, size, self.chunk_size):
                        clen = min(self.chunk_size, size - off)
                        assign = self._assign()
                        vid, nid, cookie = parse_file_id(assign["fid"])
                        up = call(
                            assign["url"], "/admin/remote/fetch_write",
                            {"volume": vid, "needle_id": nid,
                             "cookie": cookie,
                             "remote_conf": conf.to_dict(),
                             "remote_location": str(loc),
                             "offset": off, "size": clen}, timeout=300)
                        chunks.append(FileChunk(
                            fid=assign["fid"], offset=off,
                            size=int(up["size"]),
                            etag=up.get("eTag", ""),
                            modified_ts_ns=time.time_ns()))
                    entry.chunks = chunks
                    entry.attr.file_size = size
                    # no whole-object md5: the bytes never transited
                    # this process — readers fall back to the chunk
                    # etags (etag_of_chunks), like any chunked upload
                    self.filer.create_entry(entry)
                    cached += 1
                    continue
                except RpcError:
                    # older volume server / transient failure: reclaim
                    # the needles already written, then fall back to
                    # filer-transit for this entry
                    if chunks:
                        try:
                            self._delete_chunks(chunks)
                        except Exception:
                            pass
            data = rs.read_through(self.filer, entry)
            entry.attr.file_size = len(data)
            entry.attr.md5 = hashlib.md5(data).hexdigest()
            if len(data) <= INLINE_LIMIT:
                entry.content = data
            else:
                offset = 0
                while offset < len(data):
                    piece = data[offset:offset + self.chunk_size]
                    chunk = self._upload_blob(piece)
                    chunk.offset = offset
                    entry.chunks.append(chunk)
                    offset += len(piece)
            self.filer.create_entry(entry)
            cached += 1
        return {"cached": cached}

    def _h_remote_uncache(self, req: Request):
        """Drop local copies, keep remote metadata
        (command_remote_uncache.go)."""
        directory = req.json()["dir"]
        uncached = 0
        for entry in self._walk_remote_entries(directory):
            if not entry.chunks and not entry.content:
                continue
            if entry.chunks:
                self._delete_chunks(entry.chunks)
            entry.chunks = []
            entry.content = b""
            self.filer.create_entry(entry)
            uncached += 1
        return {"uncached": uncached}

    # -- metadata subscription ----------------------------------------------
    # -- generic KV (filer_grpc_server_kv.go over the HTTP substrate) --------
    @staticmethod
    def _b64(value: str, urlsafe: bool = False) -> bytes:
        import base64
        import binascii

        try:
            decode = base64.urlsafe_b64decode if urlsafe \
                else base64.b64decode
            return decode(value or "")
        except (binascii.Error, ValueError):
            raise RpcError("malformed base64", 400)

    def _h_kv_get(self, req: Request):
        import base64

        key = self._b64(req.param("key", "") or "", urlsafe=True)
        if not key:
            raise RpcError("missing key", 400)
        value = self.filer.kv_get(key)
        return {"value": base64.b64encode(value).decode()
                if value is not None else None}

    def _h_kv_put(self, req: Request):
        body = req.json()
        key = self._b64(body.get("key", ""))
        if not key:
            raise RpcError("missing key", 400)
        self.filer.kv_put(key, self._b64(body.get("value", "")))
        return {}

    def _h_kv_delete(self, req: Request):
        key = self._b64(req.json().get("key", ""))
        if not key:
            raise RpcError("missing key", 400)
        self.filer.kv_delete(key)
        return {}

    def _h_subscribe(self, req: Request):
        since = int(req.param("since", "0"))
        prefix = req.param("pathPrefix", "/") or "/"
        return {"events": self.filer.subscribe_metadata(since, prefix)}

    def _h_aggregate(self, req: Request):
        """Merged peer feed (meta_aggregator.go MetaAggregator)."""
        since = int(req.param("since", "0"))
        events = self.filer.subscribe_metadata(since)
        if self.meta_aggregator is not None:
            events = sorted(events + self.meta_aggregator.events(since),
                            key=lambda e: e["ts_ns"])
        return {"events": events}
