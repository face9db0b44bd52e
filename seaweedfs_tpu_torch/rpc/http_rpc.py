"""HTTP RPC substrate: the daemon-to-daemon communication backbone.

Counterpart of seaweedfs_tpu/rpc/http_rpc.py, on the same wire: JSON-bodied
control calls and raw-byte responses for data streams over stdlib
HTTP/1.1, served by a threading server.  The headers (X-Deadline, the
trace context, X-QoS-Class/X-QoS-Tenant, Retry-After, X-Raft-Leader), the
error bodies and the status codes are the JAX package's, so a client of
either package drives a server of the other.  This layer never carries
tensor traffic.

Every request runs on its own handler thread.  Torch keeps the current
CUDA device per thread, so a handler that reaches the card resolves its
device through `device.resolve`, never through thread state.

With WEED_HTTP_WORKERS > 1 an explicitly bound server preforks its
workers (rpc/prefork.py): workers forward writes to the parent, retry a
local 404 there, and fan drain/leave out to the fleet.
"""

from __future__ import annotations

import http.client
import json
import os
import select
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .. import tracing
from ..qos import classify as _qos
from ..stats import metrics as _stats
from ..util import faults as _faults
from . import prefork as _prefork


class RpcError(Exception):
    """RPC failure carrying enough context for retry policy: the remote
    HTTP status (or 503 for transport failures), the destination and
    route, whether the error is a TRANSPORT failure (peer unreachable /
    connection died — the request may never have been delivered) vs a
    REMOTE response (the peer answered with >= 400), and optional extra
    response headers (Retry-After on shed responses)."""

    def __init__(self, message: str, status: int = 500, *,
                 addr: str = "", route: str = "",
                 transport: bool = False,
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.addr = addr
        self.route = route
        self.transport = transport
        self.headers = headers or {}


# -- deadline propagation ----------------------------------------------------

DEADLINE_HEADER = "X-Deadline"  # absolute wall-clock epoch seconds

_deadline_local = threading.local()


def current_deadline() -> Optional[float]:
    """The absolute (epoch seconds) deadline pinned on this thread, or
    None.  Set by deadline_scope() on clients and by the dispatch loop
    on servers, so nested outbound calls inherit the caller's budget."""
    return getattr(_deadline_local, "value", None)


def set_deadline(value: Optional[float]) -> Optional[float]:
    prev = getattr(_deadline_local, "value", None)
    _deadline_local.value = value
    return prev


def in_caller_context(fn: Callable, span=None) -> Callable:
    """`fn` wrapped for another thread (a pool worker or racer, whose
    thread locals do not follow the caller's): it runs under the calling
    thread's deadline and QoS class and tenant, and under `span` when one
    is given, so its RPCs stay inside the caller's budget, keep their
    class downstream and join the caller's trace.  The worker's own
    context is restored afterwards."""
    dl = current_deadline()
    qctx = (_qos.current_class(), _qos.current_tenant())

    def run(*args):
        prev = set_deadline(dl)
        prev_q = _qos.set_qos(*qctx)
        prev_s = tracing.swap(span) if span is not None else None
        try:
            return fn(*args)
        finally:
            if span is not None:
                tracing.restore(prev_s)
            _qos.set_qos(*prev_q)
            set_deadline(prev)
    return run


class deadline_scope:
    """Context manager pinning an absolute deadline for everything this
    thread calls: `with deadline_scope(2.0): ...` caps all nested RPC
    timeouts and is forwarded in X-Deadline.  Never EXTENDS an already
    tighter inherited deadline."""

    def __init__(self, timeout: Optional[float] = None,
                 absolute: Optional[float] = None):
        dl = absolute if absolute is not None else (
            time.time() + timeout if timeout is not None else None)
        inherited = current_deadline()
        if dl is None or (inherited is not None and inherited < dl):
            dl = inherited
        self._dl = dl
        self._prev: Optional[float] = None

    def __enter__(self):
        self._prev = set_deadline(self._dl)
        return self._dl

    def __exit__(self, *exc):
        set_deadline(self._prev)
        return False


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, path: str,
                 query: dict, body: bytes):
        self.handler = handler
        self.path = path
        self.query = query  # dict[str, str] (first value wins)
        self.body = body
        self.headers = handler.headers

    def json(self) -> dict:
        if not self.body:
            return {}
        return json.loads(self.body)

    def param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        value = self.query.get(name)
        # blank values ("?limit=") behave as absent for value params;
        # flag params ("?delete=") test membership via `in req.query`
        return default if value in (None, "") else value


class Response:
    """Return from a route: json dict, bytes, or a (status, headers, body).

    `body` may also be an ITERATOR of byte chunks — the server then
    streams it without buffering: with a Content-Length header the chunks
    are written raw; without one the reply uses HTTP/1.1 chunked
    transfer-encoding (the substrate for VolumeCopy/CopyFile-style
    streaming RPCs, volume_server.proto:49-53)."""

    def __init__(self, body=b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[dict] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}


def stream_file(path: str, chunk_size: int = 4 << 20,
                headers: Optional[dict] = None) -> Response:
    """Response that streams a file with a fixed Content-Length snapshot
    (bytes appended mid-stream are not sent)."""
    import os

    length = os.path.getsize(path)

    def gen():
        left = length
        with open(path, "rb") as f:
            while left > 0:
                chunk = f.read(min(chunk_size, left))
                if not chunk:
                    break
                left -= len(chunk)
                yield chunk

    h = dict(headers or {})
    h["Content-Length"] = str(length)
    return Response(gen(), headers=h)


def sendfile_enabled() -> bool:
    """Zero-copy writeback is on unless WEED_SENDFILE=0 (or the platform
    has no os.sendfile — then FileSlice bodies take the pread path)."""
    return os.environ.get("WEED_SENDFILE", "1") != "0"


class FileSlice:
    """Zero-copy reply body: a byte range of an open file, written with
    os.sendfile straight from the page cache to the client socket — the
    data never crosses into Python.  Producers (volume .dat reads, disk
    cache hits) hand a dup'd fd with close_fd=True when the underlying
    file may be closed or replaced while the reply is in flight: the dup
    pins the inode, so the bytes stay valid.

    `on_close` fires exactly once when the reply path finishes with the
    slice (the _reply_file finally) — resource gates ride it (the
    volume download throttle holds its byte budget for the TRANSFER's
    lifetime, not just header construction)."""

    __slots__ = ("fd", "offset", "length", "_close_fd", "_on_close")

    def __init__(self, fd: int, offset: int, length: int,
                 close_fd: bool = False, on_close=None):
        self.fd = fd
        self.offset = offset
        self.length = length
        self._close_fd = close_fd
        self._on_close = on_close

    def read_bytes(self) -> bytes:
        """Materialize the slice (HEAD replies, fallback paths, tests)."""
        return os.pread(self.fd, self.length, self.offset)

    def close(self):
        if self._close_fd and self.fd >= 0:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = -1
        cb, self._on_close = self._on_close, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


_STATUS_PHRASES = {s.value: s.phrase for s in HTTPStatus}


class _LeanHeaders(dict):
    """Case-insensitive read view over headers parsed by the lean
    request parser.  Keys keep their wire casing (metadata copy loops
    and SigV2/V4 canonicalization see what the client sent); lookups
    try the exact key first — our own clients send canonical casing, so
    this is a single C dict probe — and fall back to a lazily-built
    lowercase index (probing absent optional headers like the trace and
    deadline carriers must not cost a case-folding scan per request)."""

    __slots__ = ("_lower",)

    def _fold(self, key: str):
        try:
            low = self._lower
        except AttributeError:
            low = self._lower = {k.lower(): v for k, v in self.items()}
        return low.get(key.lower())

    def get(self, key, default=None):
        v = dict.get(self, key)
        if v is None:
            v = self._fold(key)
        return v if v is not None else default

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return dict.__contains__(self, key) or \
            self._fold(key) is not None


Route = Callable[[Request], object]


class RpcServer:
    """Route-table HTTP server.  Routes are matched by (method, prefix);
    the longest prefix wins.  A default route handles everything else
    (object GET/POST by fid on volume servers)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 service_name: str = "rpc"):
        self.routes: dict[tuple[str, str], Route] = {}
        self.default_route: Optional[Callable[[str, Request], object]] = None
        # daemon identity for trace spans and the hop-latency vector
        # (masters/filers/volume servers/s3 gateways set their own)
        self.service_name = service_name
        # precompiled route tables (rebuilt on add()): first-segment
        # buckets + the small list of prefixes that can match across a
        # segment boundary — _match then touches a handful of candidates
        # instead of linearly scanning every registered route
        self._match_by_seg: dict[tuple[str, str], list] = {}
        self._match_loose: dict[str, list] = {}
        # hoisted per-request metric child: one labels() lookup per
        # server instead of per request
        self._inflight = _stats.RpcInflightGauge.labels(service_name)
        self._sendfile_bytes = \
            _stats.GatewaySendfileBytesCounter.labels(service_name)
        # prefork (WEED_HTTP_WORKERS): only explicitly-bound ports shard
        # into worker processes; port-0 servers are ephemeral (test
        # fixtures, embedded sidecars) and must never fork the host
        # process
        self._prefork = None
        self._prefork_workers = (
            _prefork.worker_count()
            if port != 0 and _prefork.fork_available() else 1)
        # admin routes the parent re-delivers to every worker after
        # handling them itself (graceful drain / leave must reach the
        # whole fleet, whichever process accepted the request)
        self.fanout_prefixes: set[str] = set()
        # GET/HEAD routes workers must proxy to worker 0 anyway: state
        # that lives only in the parent process (raft leadership, the
        # heartbeat-fed topology) — a worker's fork-time copy would
        # answer with stale or leaderless state, not just miss new keys
        self.parent_prefixes: set[str] = set()
        self._on_worker_start: list[Callable[[int], None]] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # keep-alive + Nagle + delayed ACK = 40 ms quanta per
            # response; buffered wfile coalesces the status line +
            # headers + body into one send() (stdlib's default of 0
            # makes every header line its own syscall)
            wbufsize = 64 * 1024
            disable_nagle_algorithm = True
            # reap idle keep-alive connections: each one pins a handler
            # thread + fd; clients transparently retry a reaped socket
            timeout = 60
            _date_cache = (0, "")  # whole-second Date header memo

            def log_message(self, fmt, *args):
                pass

            def date_time_string(self, timestamp=None):
                # one strftime per second, not per response
                if timestamp is not None:
                    return super().date_time_string(timestamp)
                now = int(time.time())
                cached = Handler._date_cache
                if cached[0] == now:
                    return cached[1]
                rendered = super().date_time_string(now)
                Handler._date_cache = (now, rendered)
                return rendered

            def parse_request(self):
                # Lean fast path for plain HTTP/1.0-1.1 requests: the
                # stdlib routes every request's headers through
                # email.parser (feedparser + Message, whose .get()
                # lower()s each stored key per lookup) — ~0.1 ms of
                # pure GIL time per request.  Anything unusual in the
                # request line falls back to the stdlib parser.
                requestline = str(self.raw_requestline,
                                  "iso-8859-1").rstrip("\r\n")
                words = requestline.split()
                if len(words) != 3 or \
                        words[2] not in ("HTTP/1.1", "HTTP/1.0"):
                    return super().parse_request()
                self.requestline = requestline
                self.command, self.path, self.request_version = words
                self.close_connection = words[2] == "HTTP/1.0"
                headers = _LeanHeaders()
                setdefault = dict.setdefault  # no case-folding scans
                rl = self.rfile.readline
                last = None
                count = 0
                while True:
                    line = rl(65537)
                    if len(line) > 65536:
                        self.send_error(431, "Header line too long")
                        return False
                    if line in (b"\r\n", b"\n", b""):
                        break
                    count += 1
                    if count > 100:
                        self.send_error(431, "Too many headers")
                        return False
                    if line[0] in (32, 9):  # obs-fold continuation
                        if last is not None:
                            headers[last] = (
                                dict.__getitem__(headers, last) + " " +
                                line.strip().decode("iso-8859-1"))
                        continue
                    idx = line.find(b":")
                    if idx < 1:
                        continue
                    key = line[:idx].decode("iso-8859-1")
                    setdefault(headers, key,
                               line[idx + 1:].strip().decode("iso-8859-1"))
                    last = key
                self.headers = headers
                conntype = (headers.get("Connection") or "").lower()
                if conntype == "close":
                    self.close_connection = True
                elif conntype == "keep-alive":
                    self.close_connection = False
                if (headers.get("Expect") or "").lower() == \
                        "100-continue" and \
                        self.request_version == "HTTP/1.1":
                    if not self.handle_expect_100():
                        return False
                return True

            def _dispatch(self, method: str):
                raw_path = self.path
                if "?" in raw_path:
                    parsed = urllib.parse.urlsplit(raw_path)
                    path = parsed.path
                    query = {k: v[0] for k, v in
                             urllib.parse.parse_qs(
                                 parsed.query,
                                 keep_blank_values=True).items()}
                else:  # hot path: no query string, nothing to parse
                    path, query = raw_path, {}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                req = Request(self, path, query, body)
                pf = outer._prefork
                # admin routes that must reach the whole fleet: the
                # receiving process executes them locally and re-delivers
                # to every peer below — a worker must NOT forward them to
                # the parent, since the forwarded copy (FWD marked) is
                # served strictly locally and the fanout would be lost
                fanout_path = (
                    pf is not None and
                    _prefork.FWD_HEADER not in self.headers and
                    any(path.startswith(p)
                        for p in outer.fanout_prefixes))
                if pf is not None and _prefork.is_worker() and \
                        not fanout_path and \
                        _prefork.FWD_HEADER not in self.headers and \
                        not path.startswith("/debug/") and \
                        (method not in ("GET", "HEAD") or
                         any(path.startswith(p)
                             for p in outer.parent_prefixes)):
                    # prefork workers are read replicas of a fork-time
                    # snapshot: every mutation is relayed to the single
                    # writer (the parent) over its control sideband
                    try:
                        resp = pf.forward_to_parent(method, raw_path,
                                                    body, self.headers)
                    except RpcError as e:
                        resp = Response(
                            json.dumps({"error": str(e)}).encode(),
                            e.status, "application/json",
                            headers=dict(e.headers))
                    self._reply(resp)
                    return
                route, prefix = outer._match(method, path)
                # route label for the span name / hop vector: the matched
                # prefix ("*" = default route), never the raw path — label
                # cardinality must stay bounded
                label = prefix if route is not None else "*"
                service = outer.service_name
                sp = tracing.from_headers(f"{method} {label}", service,
                                          self.headers)
                # install the caller's QoS context (class + tenant) for
                # the handler's duration, exactly like the deadline; tag
                # the dispatch span so profiler route shares separate
                # background from foreground CPU time
                qcls, qtenant = _qos.from_headers(self.headers)
                tracing.tag_qos(sp, qcls, qtenant)
                prev_qos = _qos.set_qos(qcls, qtenant)
                src = self.headers.get(tracing.SRC_HEADER) or "client"
                outer._inflight.inc()
                t0 = time.perf_counter()
                prev = tracing.swap(sp)
                # honor the caller's propagated deadline: work it has
                # already abandoned is rejected, not executed, and the
                # remaining budget is pinned for nested outbound calls
                deadline = None
                dl_header = self.headers.get(DEADLINE_HEADER)
                if dl_header:
                    try:
                        deadline = float(dl_header)
                    except ValueError:
                        deadline = None
                prev_dl = set_deadline(deadline)
                try:
                    try:
                        if deadline is not None and \
                                time.time() >= deadline:
                            raise RpcError(
                                f"deadline exceeded before {method} "
                                f"{label} started", 504)
                        if _faults.ACTIVE:
                            try:
                                _faults.on_rpc("server", outer.address,
                                               path)
                            except _faults.FaultInjected as f:
                                raise RpcError(str(f), f.status) \
                                    from None
                        if route is None:
                            if outer.default_route is not None:
                                result = outer.default_route(method, req)
                            else:
                                raise RpcError(
                                    f"no route {method} {path}", 404)
                        else:
                            result = route(req)
                        resp = outer._coerce(result)
                    except RpcError as e:
                        resp = Response(
                            json.dumps({"error": str(e)}).encode(),
                            e.status, "application/json",
                            headers=dict(e.headers))
                    except Exception as e:  # internal errors as 500 JSON
                        resp = Response(
                            json.dumps({"error": f"{type(e).__name__}: {e}"}
                                       ).encode(), 500, "application/json")
                    if pf is not None and \
                            _prefork.FWD_HEADER not in self.headers:
                        if resp.status == 404 and _prefork.is_worker() \
                                and method in ("GET", "HEAD"):
                            # fork-snapshot miss: data written after this
                            # worker was born is visible to the parent
                            try:
                                resp = pf.forward_to_parent(
                                    method, raw_path, body, self.headers)
                            except RpcError:
                                pass  # keep the honest local 404
                        elif resp.status < 400 and fanout_path:
                            # whichever process accepted the admin
                            # request (with SO_REUSEPORT that is a
                            # non-parent worker (N-1)/N of the time)
                            # re-delivers it to every peer, parent
                            # included — drain/leave must never
                            # dead-end in one process
                            pf.fanout(method, raw_path, body, self.headers)
                    if resp.status >= 400:
                        sp.status = f"error {resp.status}"
                    if sp.sampled:
                        # hand the trace id back so callers can fetch the
                        # span tree from /debug/traces/<id>
                        resp.headers.setdefault(tracing.TRACE_HEADER,
                                                sp.trace_id)
                    self._reply(resp)
                finally:
                    _qos.set_qos(*prev_qos)
                    set_deadline(prev_dl)
                    tracing.restore(prev)
                    sp.finish()
                    outer._inflight.dec()
                    _stats.RpcHopHistogram.labels(src, service, label) \
                        .observe(time.perf_counter() - t0)

            _server_line = ""  # version_string() is constant; memoized

            def _reply(self, resp: Response):
                body = resp.body
                if isinstance(body, str):
                    body = body.encode()
                if isinstance(body, FileSlice):
                    self._reply_file(resp, body)
                    return
                if not isinstance(body, (bytes, bytearray, memoryview)):
                    # iterators stream; memoryview bodies (zero-copy
                    # cache hits) take the buffered single-write path —
                    # len() and wfile.write() both accept them directly
                    self._reply_stream(resp, body)
                    return
                # one formatted write into the buffered wfile instead
                # of send_response + N send_header calls (each its own
                # format + encode + buffer append)
                srv = Handler._server_line
                if not srv:
                    srv = Handler._server_line = self.version_string()
                status = resp.status
                extra = resp.headers
                head = [f"HTTP/1.1 {status} "
                        f"{_STATUS_PHRASES.get(status, '')}\r\n"
                        f"Server: {srv}\r\n"
                        f"Date: {self.date_time_string()}\r\n"
                        f"Content-Type: {resp.content_type}\r\n"]
                if not extra:
                    head.append(f"Content-Length: {len(body)}\r\n\r\n")
                else:
                    if "Content-Length" not in extra:
                        head.append(f"Content-Length: {len(body)}\r\n")
                    for k, v in extra.items():
                        head.append(f"{k}: {v}\r\n")
                        if k.lower() == "connection" and \
                                str(v).lower() == "close":
                            self.close_connection = True
                    head.append("\r\n")
                self.wfile.write("".join(head).encode("latin-1"))
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _reply_file(self, resp: Response, fs: FileSlice):
                """Write a FileSlice body: buffered head, then
                os.sendfile from the source fd to the client socket
                (zero user-space copies).  Falls back to a pread loop
                when sendfile is disabled/unavailable or refuses the fd
                pair (e.g. non-regular files)."""
                try:
                    srv = Handler._server_line
                    if not srv:
                        srv = Handler._server_line = self.version_string()
                    head = [f"HTTP/1.1 {resp.status} "
                            f"{_STATUS_PHRASES.get(resp.status, '')}\r\n"
                            f"Server: {srv}\r\n"
                            f"Date: {self.date_time_string()}\r\n"
                            f"Content-Type: {resp.content_type}\r\n"]
                    if "Content-Length" not in resp.headers:
                        head.append(f"Content-Length: {fs.length}\r\n")
                    for k, v in resp.headers.items():
                        head.append(f"{k}: {v}\r\n")
                        if k.lower() == "connection" and \
                                str(v).lower() == "close":
                            self.close_connection = True
                    head.append("\r\n")
                    self.wfile.write("".join(head).encode("latin-1"))
                    if self.command == "HEAD":
                        return
                    self.wfile.flush()  # head must precede spliced bytes
                    sent = 0
                    if sendfile_enabled() and hasattr(os, "sendfile"):
                        out = self.connection.fileno()
                        wait = self.connection.gettimeout()
                        try:
                            while sent < fs.length:
                                try:
                                    n = os.sendfile(out, fs.fd,
                                                    fs.offset + sent,
                                                    fs.length - sent)
                                except BlockingIOError:
                                    # a socket with a timeout is
                                    # non-blocking underneath: a slow
                                    # reader fills its buffer, so wait
                                    # for room as socket.sendall does
                                    # (poll: no FD_SETSIZE limit)
                                    room = select.poll()
                                    room.register(out, select.POLLOUT)
                                    if not room.poll(
                                            None if wait is None
                                            else wait * 1000):
                                        raise TimeoutError(
                                            "sendfile: client stalled")
                                    continue
                                if n == 0:
                                    break  # source truncated under us
                                sent += n
                        except OSError:
                            if sent:
                                # mid-transfer failure: the framing is
                                # already committed, sever the socket
                                self.close_connection = True
                                return
                            sent = -1  # untouched: safe to fall back
                        if sent > 0:
                            outer._sendfile_bytes.inc(sent)
                        if 0 < sent < fs.length:
                            self.close_connection = True  # short source
                        if sent >= 0:
                            return
                    # pread fallback (WEED_SENDFILE=0, platform without
                    # sendfile, or sendfile rejected the fd pair)
                    done = 0
                    while done < fs.length:
                        chunk = os.pread(fs.fd,
                                         min(1 << 20, fs.length - done),
                                         fs.offset + done)
                        if not chunk:
                            self.close_connection = True
                            break
                        self.wfile.write(chunk)
                        done += len(chunk)
                finally:
                    fs.close()

            def _reply_stream(self, resp: Response, chunks):
                """Stream an iterator body: raw writes under a known
                Content-Length, chunked transfer-encoding otherwise."""
                chunked = "Content-Length" not in resp.headers
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                if chunked:
                    self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                if self.command == "HEAD":
                    return
                try:
                    for chunk in chunks:
                        if not chunk:
                            continue
                        if chunked:
                            self.wfile.write(b"%x\r\n" % len(chunk))
                            self.wfile.write(chunk)
                            self.wfile.write(b"\r\n")
                        else:
                            self.wfile.write(chunk)
                        # push each chunk out now: the buffered wfile
                        # would otherwise hold early chunks hostage and
                        # void the first-byte win of streaming replies
                        self.wfile.flush()
                    if chunked:
                        self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    # the body generator (or the peer's socket) failed
                    # after the status line went out: the only honest
                    # signal left is a severed connection — the framing
                    # (Content-Length short / missing terminal chunk)
                    # tells the client the transfer is truncated
                    self.close_connection = True

            def do_GET(self):
                self._dispatch("GET")

            def do_HEAD(self):
                self._dispatch("HEAD")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        class Server(ThreadingHTTPServer):
            # the stdlib default backlog of 5 causes 1s+ SYN-retransmit
            # stalls under modest concurrency (16 clients saturate it)
            request_queue_size = 128

            def __init__(s, *a, **kw):
                s._conns = set()
                s._conns_lock = threading.Lock()
                super().__init__(*a, **kw)

            # track established connections: shutdown() only stops the
            # accept loop, and a keep-alive handler thread would keep
            # serving a STOPPED daemon's state (zombie server) — stop()
            # must be able to sever them
            def process_request(s, request, client_address):
                with s._conns_lock:
                    s._conns.add(request)
                super().process_request(request, client_address)

            def shutdown_request(s, request):
                with s._conns_lock:
                    s._conns.discard(request)
                super().shutdown_request(request)

            def close_all_connections(s):
                with s._conns_lock:
                    conns = list(s._conns)
                for sock in conns:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

            def wait_connections_closed(s, timeout: float = 5.0) -> bool:
                """Wait for in-flight handler threads to finish their
                current request and exit (they deregister the socket in
                shutdown_request) — callers tear down shared state next,
                and a handler mid-mutation must not race that."""
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    with s._conns_lock:
                        if not s._conns:
                            return True
                    time.sleep(0.01)
                return False

        self._handler_cls = Handler
        self._server_cls = Server
        self.httpd = Server((host, port), Handler, bind_and_activate=False)
        if self._prefork_workers > 1 and _prefork.reuseport_available():
            # ALL sockets on a port must set SO_REUSEPORT for a later
            # one to join, so the parent's main listener opts in up
            # front when workers will shard this port
            try:
                self.httpd.socket.setsockopt(
                    socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except OSError:
                pass
        try:
            self.httpd.server_bind()
            self.httpd.server_activate()
        except BaseException:
            self.httpd.server_close()
            raise
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None


    def _rebuild_match_tables(self):
        """Precompile the route set.  Prefixes with an interior slash
        ("/dir/assign") can only match a path whose first segment equals
        theirs, so they live in per-(method, segment) buckets; prefixes
        without one ("", "/", "/metrics") may match across a segment
        boundary ("/metricsfoo") and go to the small loose list.  Both
        are sorted longest-first so the first startswith hit wins, and
        the finished dicts are swapped in atomically — handler threads
        read them lock-free."""
        by_seg: dict[tuple[str, str], list] = {}
        loose: dict[str, list] = {}
        for (m, prefix), route in self.routes.items():
            cut = prefix.find("/", 1)
            if cut > 0:
                by_seg.setdefault((m, prefix[1:cut]), []) \
                    .append((prefix, route))
            else:
                loose.setdefault(m, []).append((prefix, route))
        for bucket in by_seg.values():
            bucket.sort(key=lambda pr: len(pr[0]), reverse=True)
        for bucket in loose.values():
            bucket.sort(key=lambda pr: len(pr[0]), reverse=True)
        self._match_by_seg = by_seg
        self._match_loose = loose

    def _match(self, method: str, path: str
               ) -> tuple[Optional[Route], str]:
        """(route, matched prefix); (None, "") when no prefix matches.
        Longest prefix wins, exactly like the linear scan this replaces,
        but via the precompiled tables."""
        cut = path.find("/", 1)
        seg = path[1:cut] if cut > 0 else path[1:]
        best, best_prefix = None, ""
        for prefix, route in self._match_by_seg.get((method, seg), ()):
            if path.startswith(prefix):
                best, best_prefix = route, prefix
                break  # longest-first order: first hit is the winner
        for prefix, route in self._match_loose.get(method, ()):
            if len(prefix) <= len(best_prefix):
                break  # longest-first: nothing longer remains
            if path.startswith(prefix):
                best, best_prefix = route, prefix
                break
        return best, best_prefix

    @staticmethod
    def _coerce(result) -> Response:
        if isinstance(result, Response):
            return result
        if isinstance(result, FileSlice):
            return Response(result)
        if isinstance(result, (dict, list)):
            return Response(json.dumps(result).encode(), 200,
                            "application/json")
        if isinstance(result, (bytes, bytearray)):
            return Response(bytes(result))
        if result is None:
            return Response(b"", 204)
        return Response(str(result).encode(), 200, "text/plain")

    def route(self, method: str, prefix: str):
        def deco(fn: Route):
            self.add(method, prefix, fn)
            return fn
        return deco

    def add(self, method: str, prefix: str, fn: Route):
        self.routes[(method, prefix)] = fn
        self._rebuild_match_tables()

    def _new_listener(self, host: str, port: int, reuseport: bool = False):
        """Another HTTP server sharing this RpcServer's routes: worker
        listeners on the shared port (SO_REUSEPORT) and the loopback
        sidebands the prefork group uses for forwarding/scraping."""
        srv = self._server_cls((host, port), self._handler_cls,
                               bind_and_activate=False)
        srv.daemon_threads = True
        if reuseport:
            srv.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        try:
            srv.server_bind()
            srv.server_activate()
        except BaseException:
            srv.server_close()
            raise
        return srv

    def on_worker_start(self, fn: Callable[[int], None]):
        """Register a post-fork hook (runs in each worker child before
        it starts accepting).  Daemons use this to reopen per-process
        resources — e.g. the filer's sqlite connection, which cannot be
        shared across a fork."""
        self._on_worker_start.append(fn)

    def on_worker_start_fire(self, wid: int):
        for fn in self._on_worker_start:
            try:
                fn(wid)
            except Exception:
                pass

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self):
        if self._prefork_workers > 1 and self._prefork is None:
            # the parent keeps serving as worker 0 on the listener it
            # already owns; N-1 workers shard the same port.  The group
            # forks its template before this process starts serving.
            self._prefork = _prefork.PreforkGroup(self,
                                                  self._prefork_workers)
            self._prefork.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        if self._prefork is not None and not _prefork.is_worker():
            self._prefork.stop()
            self._prefork = None
        self.httpd.shutdown()
        # sever live keep-alive connections: their handler threads would
        # otherwise keep answering from this daemon's torn-down state
        # (clients transparently retry on a fresh connection) — then
        # drain in-flight requests before the caller tears down stores
        self.httpd.close_all_connections()
        self.httpd.wait_connections_closed()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


# -- client helpers ----------------------------------------------------------


class _NoDelayConnection(http.client.HTTPConnection):
    """HTTPConnection with TCP_NODELAY: headers and body go out as
    separate send()s, and Nagle would hold the second for the peer's
    delayed ACK (~40 ms) on every pooled reuse."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _ConnPool:
    """Keep-alive HTTP connection pool, shared process-wide — the
    analogue of the reference's cached gRPC client connections
    (rpc/grpc_client_server.go:27-41).  Bounded idle list per address;
    borrowed connections that error are closed, not returned."""

    def __init__(self, max_idle_per_addr: int = 16,
                 idle_ttl: float = 30.0):
        self._lock = threading.Lock()
        self._idle: dict[str, list] = {}  # addr -> [(conn, stored_at)]
        self.max_idle = self._env_max_idle(max_idle_per_addr)
        self.idle_ttl = idle_ttl
        self._last_sweep = 0.0

    @staticmethod
    def _env_max_idle(default: int) -> int:
        raw = os.environ.get("WEED_POOL_MAX_IDLE", "")
        try:
            return max(1, int(raw)) if raw else default
        except ValueError:
            return default


    def configure_for_prefork(self, workers: int):
        """Per-process-aware sizing: with N workers on this host, each
        process keeps 1/N of the per-peer idle budget (floor 2) and
        reaps idle sockets faster — otherwise N workers hold N full
        pools against every peer, multiplying its fd load by N."""
        if workers <= 1:
            return
        base = self._env_max_idle(16)
        trimmed = []
        with self._lock:
            self.max_idle = max(2, base // workers)
            self.idle_ttl = min(self.idle_ttl, 10.0)
            for idle in self._idle.values():
                while len(idle) > self.max_idle:
                    trimmed.append(idle.pop(0)[0])
        for conn in trimmed:
            conn.close()

    def reinit_after_fork(self):
        """Forget every pooled connection WITHOUT closing the sockets,
        and REPLACE the lock rather than acquire it.  Freshly-forked
        workers inherit the parent's pooled fds; reusing them would
        interleave two processes' requests on one TCP stream, and
        close()ing them here is unnecessary (the child drops its
        reference either way — the parent still owns the socket).  The
        lock must not be acquired: the parent keeps serving while it
        forks, so a child can inherit it mid-hold and would deadlock
        before ever binding its listener."""
        self._lock = threading.Lock()
        self._idle = {}
        self._last_sweep = 0.0

    def _sweep(self, now: float):
        """Background-free lazy reap: every get/put piggybacks a cheap
        periodic pass over ALL addresses, so idle sockets whose TTL
        expired while their address went quiet still get closed instead
        of pinning fds until the peer reaps them.  Expired connections
        are collected under the lock but closed outside it."""
        if now - self._last_sweep < min(5.0, self.idle_ttl / 2):
            return
        expired = []
        with self._lock:
            if now - self._last_sweep < min(5.0, self.idle_ttl / 2):
                return  # another thread swept while we waited
            self._last_sweep = now
            for addr in list(self._idle):
                kept = []
                for conn, stored_at in self._idle[addr]:
                    if now - stored_at > self.idle_ttl:
                        expired.append(conn)
                    else:
                        kept.append((conn, stored_at))
                if kept:
                    self._idle[addr] = kept
                else:
                    del self._idle[addr]
        for conn in expired:
            conn.close()

    @staticmethod
    def _dropped(conn) -> bool:
        """A healthy idle keep-alive socket has nothing to read; pending
        readability means the server closed it (FIN queued) or sent
        stray bytes — reusing it would fail mid-request, which for a
        non-idempotent RPC cannot be retried.  This also protects
        against the address being REBOUND by a different server."""
        sock = conn.sock
        if sock is None:
            return True
        try:
            # non-blocking MSG_PEEK instead of select(): select raises
            # ValueError past FD_SETSIZE (1024 fds).  The socket must be
            # put in true non-blocking mode — in timeout mode CPython
            # waits for readability BEFORE recv, so MSG_DONTWAIT alone
            # would still block for the full socket timeout
            sock.setblocking(False)
            sock.recv(1, socket.MSG_PEEK)
        except (BlockingIOError, InterruptedError):
            return False  # nothing queued: healthy idle keep-alive
        except OSError:
            return True
        return True  # EOF (b"") or stray queued bytes

    def get(self, addr: str, timeout: float):
        now = time.monotonic()
        self._sweep(now)
        while True:
            with self._lock:
                idle = self._idle.get(addr)
                item = idle.pop() if idle else None
            if item is None:
                host, _, port = addr.partition(":")
                return _NoDelayConnection(
                    host, int(port) if port else 80, timeout=timeout)
            conn, stored_at = item
            if now - stored_at > self.idle_ttl or self._dropped(conn):
                conn.close()
                continue
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn

    def put(self, addr: str, conn):
        now = time.monotonic()
        evicted = None
        with self._lock:
            idle = self._idle.setdefault(addr, [])
            if len(idle) >= self.max_idle:
                # keep the connection just used (freshest, least likely
                # to be server-reaped) and evict the oldest idle one;
                # close it outside the lock — get() may be racing us
                evicted = idle.pop(0)[0]
            idle.append((conn, now))
        if evicted is not None:
            evicted.close()
        self._sweep(now)


_POOL = _ConnPool()

# pick up a WEED_FAULTS spec set before process start; daemons/tests
# that set it later reconfigure via faults.REGISTRY or /debug/faults
_faults.load_env()


def call(addr: str, path: str, payload: Optional[dict] = None,
         method: Optional[str] = None, timeout: float = 30.0,
         raw: Optional[bytes] = None, headers: Optional[dict] = None,
         parse: bool = True):
    """JSON RPC call; returns parsed JSON (or raw bytes for non-JSON).
    parse=False always returns the raw body — required when fetching
    stored object content whose mime may itself be application/json."""
    data = None
    req_headers = _qos.inject(tracing.inject(dict(headers or {})))
    if raw is not None:
        data = raw
    elif payload is not None:
        data = json.dumps(payload).encode()
        req_headers["Content-Type"] = "application/json"
    if method is None:
        method = "POST" if data is not None else "GET"
    # propagate the thread's deadline: cap this hop's timeout by the
    # remaining budget and forward the absolute value downstream
    deadline = current_deadline()
    if deadline is not None and DEADLINE_HEADER not in req_headers:
        remaining = deadline - time.time()
        if remaining <= 0:
            raise RpcError(
                f"deadline exceeded before call to {addr}{path}", 504,
                addr=addr, route=path)
        timeout = min(timeout, remaining)
        req_headers[DEADLINE_HEADER] = f"{deadline:.6f}"
    if _faults.ACTIVE:
        try:
            short = _faults.on_rpc("client", addr, path)
        except _faults.FaultInjected as f:
            if f.kind == "reset":
                raise RpcError(
                    f"cannot reach {addr}: injected connection reset",
                    503, addr=addr, route=path, transport=True) \
                    from None
            raise RpcError(str(f), f.status, addr=addr,
                           route=path) from None
        if short is not None:
            raise RpcError(
                f"truncated response from {addr}: injected short read",
                502, addr=addr, route=path, transport=True) from None
    # one retry, ONLY for a pooled connection the server closed while it
    # sat idle (keep-alive reap, restart): those fail with a reset /
    # disconnect before any response.  Timeouts and errors on fresh
    # connections never retry — re-sending a non-idempotent RPC that may
    # already be executing would double-apply the mutation
    stale_errors = (http.client.RemoteDisconnected,
                    http.client.BadStatusLine,
                    ConnectionResetError, BrokenPipeError)
    for attempt in (0, 1):
        if attempt == 0:
            conn = _POOL.get(addr, timeout)
        else:  # bypass the pool: it may hold MORE stale sockets
            host, _, port = addr.partition(":")
            conn = _NoDelayConnection(host, int(port) if port else 80,
                                      timeout=timeout)
        fresh = conn.sock is None
        try:
            # SEND phase: a reuse failure here means the server closed
            # the idle socket before receiving the request — safe to
            # retry any method, it was never fully delivered
            conn.request(method, path, body=data, headers=req_headers)
        except stale_errors as e:
            conn.close()
            if attempt == 0 and not fresh:
                continue
            raise RpcError(f"cannot reach {addr}: {e}", 503,
                           addr=addr, route=path,
                           transport=True) from None
        except (http.client.HTTPException, ConnectionError,
                socket.timeout, TimeoutError, OSError) as e:
            conn.close()
            raise RpcError(f"cannot reach {addr}: {e}", 503,
                           addr=addr, route=path,
                           transport=True) from None
        try:
            # RECEIVE phase: the request reached the server and may have
            # EXECUTED even though the response was lost — only
            # idempotent methods may retry here
            resp = conn.getresponse()
            body = resp.read()
            status = resp.status
            ctype = resp.headers.get("Content-Type", "")
            keep = not resp.will_close
        except stale_errors as e:
            conn.close()
            if attempt == 0 and not fresh and method in ("GET", "HEAD"):
                continue
            raise RpcError(f"cannot reach {addr}: {e}", 503,
                           addr=addr, route=path,
                           transport=True) from None
        except (http.client.HTTPException, ConnectionError,
                socket.timeout, TimeoutError, OSError) as e:
            conn.close()
            raise RpcError(f"cannot reach {addr}: {e}", 503,
                           addr=addr, route=path,
                           transport=True) from None
        if keep:
            _POOL.put(addr, conn)
        else:
            conn.close()
        if status >= 400:
            try:
                message = json.loads(body).get("error", body.decode())
            except Exception:
                message = body.decode(errors="replace")
            err_headers = {}
            retry_after = resp.headers.get("Retry-After")
            if retry_after:
                err_headers["Retry-After"] = retry_after
            # raft leader hint on not-leader rejections: clients retry
            # against the hinted address before the next failover round
            leader_hint = resp.headers.get("X-Raft-Leader")
            if leader_hint:
                err_headers["X-Raft-Leader"] = leader_hint
            raise RpcError(message, status, addr=addr, route=path,
                           headers=err_headers or None)
        if parse and "application/json" in ctype:
            return json.loads(body) if body else {}
        return body


def call_stream(addr: str, path: str, payload: Optional[dict] = None,
                method: Optional[str] = None, timeout: float = 600.0,
                chunk_size: int = 4 << 20,
                headers: Optional[dict] = None):
    """Like call() but returns an iterator of response-body chunks —
    nothing is buffered beyond one chunk (receiver side of the streaming
    RPCs; urllib decodes chunked transfer-encoding transparently).
    Errors before the first byte raise RpcError like call()."""
    url = f"http://{addr}{path}"
    data = None
    req_headers = _qos.inject(tracing.inject(dict(headers or {})))
    if payload is not None:
        data = json.dumps(payload).encode()
        req_headers["Content-Type"] = "application/json"
    if method is None:
        method = "POST" if data is not None else "GET"
    deadline = current_deadline()
    if deadline is not None and DEADLINE_HEADER not in req_headers:
        remaining = deadline - time.time()
        if remaining <= 0:
            raise RpcError(
                f"deadline exceeded before call to {addr}{path}", 504,
                addr=addr, route=path)
        timeout = min(timeout, remaining)
        req_headers[DEADLINE_HEADER] = f"{deadline:.6f}"
    short_rule = None
    if _faults.ACTIVE:
        try:
            short_rule = _faults.on_rpc("client", addr, path)
        except _faults.FaultInjected as f:
            if f.kind == "reset":
                raise RpcError(
                    f"cannot reach {addr}: injected connection reset",
                    503, addr=addr, route=path, transport=True) \
                    from None
            raise RpcError(str(f), f.status, addr=addr,
                           route=path) from None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=req_headers)
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            message = json.loads(body).get("error", body.decode())
        except Exception:
            message = body.decode(errors="replace")
        raise RpcError(message, e.code, addr=addr, route=path) from None
    except (urllib.error.URLError, socket.timeout, ConnectionError) as e:
        raise RpcError(f"cannot reach {addr}: {e}", 503, addr=addr,
                       route=path, transport=True) from None

    try:
        expected = int(resp.headers.get("Content-Length", ""))
    except ValueError:
        expected = -1  # absent or malformed: length unknown, no check

    # an injected short read truncates the body partway: the advertised
    # length check below then fails the stream exactly like a real
    # prematurely-closed transfer
    cut = None
    if short_rule is not None:
        cut = short_rule.nbytes or (
            expected // 2 if expected > 0 else 1)

    def gen():
        got = 0
        try:
            while True:
                try:
                    chunk = resp.read(chunk_size)
                except Exception as e:  # IncompleteRead, socket errors
                    raise RpcError(
                        f"stream from {addr} broke mid-body: {e}", 502,
                        addr=addr, route=path, transport=True)
                if not chunk:
                    break
                got += len(chunk)
                if cut is not None and got >= cut:
                    yield chunk[:max(0, len(chunk) - (got - cut))]
                    raise RpcError(
                        f"stream from {addr} broke mid-body: "
                        f"injected short read [{short_rule.id}]", 502,
                        addr=addr, route=path, transport=True)
                yield chunk
            # a prematurely-closed connection can look like EOF on
            # incremental reads; enforce the advertised length so a
            # truncated transfer NEVER passes as complete
            if 0 <= expected != got:
                raise RpcError(
                    f"truncated stream from {addr}: "
                    f"{got} of {expected} bytes", 502,
                    addr=addr, route=path, transport=True)
        finally:
            resp.close()

    return gen()
