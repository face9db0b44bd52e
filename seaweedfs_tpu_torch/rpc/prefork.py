"""Multi-process gateway front end (SO_REUSEPORT worker sharding).

One Python interpreter is the throughput ceiling of every HTTP gateway
in the system: the GIL serializes request handling no matter how many
threads `ThreadingHTTPServer` spawns.  `WEED_HTTP_WORKERS=N` preforks
the serving tier the way nginx/haproxy do:

  * the parent process IS worker 0: it keeps serving on the listener
    it already bound, so there is never a window where the port is
    bound but nobody accepts;
  * N-1 worker processes each bind a fresh ``SO_REUSEPORT`` socket on
    the same (host, port), so the kernel load-balances accepts across
    the fleet.  Where SO_REUSEPORT is missing workers accept on the
    listening fd inherited over ``fork``;
  * a supervisor thread in the parent respawns crashed workers, and a
    fork-deadlock watchdog kills a worker that never registers;
  * every process additionally binds a loopback *sideband* listener
    sharing the same routes, registered in a small on-disk registry, so
    /metrics, /debug/qos and /debug/traces can be scrape-merged across
    the worker set and graceful drain (/admin/drain, /admin/leave) can
    fan out from whichever worker received it.

Consistency model: workers forward every non-GET/HEAD request to the
parent over the sideband (single-writer), and retry locally-404ing
GET/HEAD reads against the parent: a worker's view of volume indexes is
a snapshot, so reads of data written after it miss locally and are
served by the writer.  Volume workers additionally tail the flushed .idx
(see storage/needle_map.py) so the hot read path stays local.

The port's own copy of seaweedfs_tpu/rpc/prefork.py, with one change of
design: every worker is forked from a *template* process.  A CUDA
context does not survive ``fork``, and the parent creates one as soon
as it runs a kernel (``/admin/ec/generate``), so a worker forked from
the parent after that fails its first kernel.  `PreforkGroup.start`
therefore forks the template first, before anything of the parent
touches the card and before the group starts any thread; the template
never serves, starts no thread and holds no lock, forks each worker
(the first N-1 and every respawn) on a command from the parent over a
pipe, reaps them, and reports each worker's pid and exit status back,
so the parent keeps supervising by pid.  Each worker creates its own
CUDA context at its first dispatch.  A respawned worker therefore starts
from the template's snapshot (the state at `start`), which the
consistency model above already covers.  The same design keeps workers
clear of the parent's torch CPU thread pool (a child forked after
libgomp started its threads can hang in its first parallel region).

Prefork only engages for explicitly-bound ports.  Ephemeral port-0
servers (test fixtures, embedded sidecars) stay single-process, which
also guarantees a test process is never forked.
"""

from __future__ import annotations

import ctypes
import json
import os
import random
import select
import shutil
import signal
import socket
import tempfile
import threading
import time
from typing import Optional

from ..stats import metrics as _stats

# Marks a request that already crossed a prefork hop (worker->parent
# forward, parent->worker fanout, or an aggregation scrape).  Any
# request carrying it is served strictly locally: never re-forwarded,
# never fanned out, never re-aggregated.
FWD_HEADER = "X-Weed-Prefork-Fwd"

_ROLE = "solo"  # "solo" | "parent" | "worker"
_WORKER_ID = 0


def worker_count() -> int:
    """The configured WEED_HTTP_WORKERS (>=1; bad values mean 1)."""
    raw = os.environ.get("WEED_HTTP_WORKERS", "")
    try:
        return max(1, int(raw)) if raw else 1
    except ValueError:
        return 1


def reuseport_available() -> bool:
    return hasattr(socket, "SO_REUSEPORT")


def fork_available() -> bool:
    return hasattr(os, "fork")


def role() -> str:
    return _ROLE


def worker_id() -> int:
    return _WORKER_ID


def is_worker() -> bool:
    return _ROLE == "worker"


def _set_role(role_: str, wid: int):
    global _ROLE, _WORKER_ID
    _ROLE = role_
    _WORKER_ID = wid


_PR_SET_PDEATHSIG = 1


def _die_with_parent(sig: int):
    """Ask the kernel to send `sig` to this process when its parent
    exits (Linux prctl), so no worker or template outlives its group."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, int(sig), 0, 0, 0)
    except (OSError, AttributeError):
        pass  # not Linux: stop() still tears the group down


class PreforkGroup:
    """Supervisor owned by the parent RpcServer; the template and the
    workers forked from it reuse the same object (inherited state) for
    addresses and registry."""

    def __init__(self, server, workers: int):
        self.server = server
        self.workers = workers
        self.dir = ""               # worker registry (w<id>.json files)
        self.control_addr = ""      # parent sideband workers forward to
        self._pids: dict[int, int] = {}  # wid -> pid (parent only)
        # wid -> monotonic deadline by which a freshly-forked child must
        # have written its registry entry (fork-deadlock watchdog)
        self._spawn_deadlines: dict[int, float] = {}
        try:
            self._spawn_grace = float(os.environ.get(
                "WEED_PREFORK_SPAWN_DEADLINE", "") or 15.0)
        except ValueError:
            self._spawn_grace = 15.0
        self._stopping = False
        self._reaper: Optional[threading.Thread] = None
        self._control = None        # parent sideband httpd
        self._control_thread = None
        self._child_httpd = None    # worker main listener (child only)
        self._child_sideband = None
        self.qos_shm = None
        self.template_pid = 0
        self._cmd_w = -1            # parent -> template commands
        self._evt_r = -1            # template -> parent pid/exit events
        self._cond = threading.Condition()

    # -- parent ---------------------------------------------------------

    def start(self):
        base = os.environ.get("WEED_PREFORK_DIR", "")
        if base:
            os.makedirs(base, exist_ok=True)
            self.dir = tempfile.mkdtemp(
                prefix=f"{self.server.service_name}-", dir=base)
        else:
            self.dir = tempfile.mkdtemp(
                prefix=f"weed-prefork-{self.server.service_name}-")
        self._init_qos_shm()
        # the control sideband is bound BEFORE the template forks so
        # every worker is born knowing where writes go
        self._control = self.server._new_listener("127.0.0.1", 0)
        self.control_addr = f"127.0.0.1:{self._control.server_address[1]}"
        _set_role("parent", 0)
        self._install_aggregators()
        from .http_rpc import _POOL
        _POOL.configure_for_prefork(self.workers)
        self._start_template()
        self._control_thread = threading.Thread(
            target=self._control.serve_forever, kwargs={"poll_interval": 0.5},
            daemon=True, name=f"{self.server.service_name}-prefork-control")
        self._control_thread.start()
        self._write_entry(0, os.getpid(), self.control_addr)
        _stats.GatewayWorkersGauge.labels(self.server.service_name).set(
            float(self.workers))
        self._reaper = threading.Thread(
            target=self._reap_loop, daemon=True,
            name=f"{self.server.service_name}-prefork-reaper")
        self._reaper.start()
        for wid in range(1, self.workers):
            self._fork(wid)

    def _init_qos_shm(self):
        if os.environ.get("WEED_QOS_SHM", "auto") == "0":
            return
        try:
            from ..qos import shm as qshm
            self.qos_shm = qshm.create(self.workers)
        except Exception:
            self.qos_shm = None  # degrade to per-process QoS
        if self.qos_shm is not None:
            self._write_json("qos_shm.json", {"name": self.qos_shm.name})

    def _write_json(self, name: str, payload: dict):
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _write_entry(self, wid: int, pid: int, sideband: str):
        self._write_json(f"w{wid}.json",
                         {"wid": wid, "pid": pid, "sideband": sideband})

    def peers(self) -> list[dict]:
        """Every registered worker (including self), sorted by wid."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("w") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue  # worker mid-respawn; its entry reappears
        out.sort(key=lambda e: e.get("wid", 0))
        return out

    # -- the template ------------------------------------------------------

    def _start_template(self):
        cmd_r, cmd_w = os.pipe()
        evt_r, evt_w = os.pipe()
        pid = os.fork()
        if pid == 0:
            try:
                os.close(cmd_w)
                os.close(evt_r)
                self._template_main(cmd_r, evt_w)
            finally:
                os._exit(0)
        os.close(cmd_r)
        os.close(evt_w)
        self.template_pid = pid
        self._cmd_w = cmd_w
        self._evt_r = evt_r

    def _template_main(self, cmd_r: int, evt_w: int):
        """The template's loop: fork a worker per "fork <wid>" line, reap
        workers, report "pid <wid> <pid>" and "exit <wid> <pid> <status>"
        lines.  EOF on the command pipe (the parent closed it or died)
        ends the template after its workers."""
        _die_with_parent(signal.SIGKILL)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        children: dict[int, int] = {}  # pid -> wid
        buf = b""
        open_ = True
        while open_ or children:
            if open_:
                ready, _, _ = select.select([cmd_r], [], [], 0.1)
            else:
                ready = []
                time.sleep(0.05)
            if ready:
                chunk = os.read(cmd_r, 4096)
                if not chunk:
                    open_ = False
                    for pid in children:
                        try:
                            os.kill(pid, signal.SIGTERM)
                        except OSError:
                            pass
                    give_up = time.monotonic() + 5.0
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    verb, _, arg = line.decode().partition(" ")
                    if verb != "fork":
                        continue
                    wid = int(arg)
                    pid = os.fork()
                    if pid == 0:
                        try:
                            os.close(cmd_r)
                            os.close(evt_w)
                            _die_with_parent(signal.SIGTERM)
                            self._child_main(wid)
                        finally:
                            os._exit(0)
                    children[pid] = wid
                    os.write(evt_w, f"pid {wid} {pid}\n".encode())
            for pid, wid in list(children.items()):
                try:
                    done, status = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    done, status = pid, 0
                if done:
                    del children[pid]
                    try:
                        os.write(evt_w,
                                 f"exit {wid} {pid} {status}\n".encode())
                    except OSError:
                        pass  # the parent is gone
            if not open_ and children and time.monotonic() > give_up:
                for pid in children:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass

    def _fork(self, wid: int, wait: bool = True):
        """Ask the template for worker `wid`; with `wait`, block until it
        reports the pid."""
        with self._cond:
            self._pids.pop(wid, None)
        os.write(self._cmd_w, f"fork {wid}\n".encode())
        if not wait:
            return
        deadline = time.monotonic() + self._spawn_grace
        with self._cond:
            while wid not in self._pids:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise OSError(f"prefork template never forked worker "
                                  f"{wid}")
                self._cond.wait(left)

    def _entry(self, wid: int) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, f"w{wid}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _kill_unregistered(self):
        """Fork-deadlock watchdog.  Post-fork code is written to never
        ACQUIRE inherited locks (structures are replaced instead), but
        on_worker_start hooks and library internals are beyond that
        guarantee.  A child that wedges before writing its registry
        entry is alive yet serves nothing: silently shrunk capacity.
        Kill it past the spawn deadline; the template reports the exit
        and the supervisor respawns it."""
        now = time.monotonic()
        for wid, deadline in list(self._spawn_deadlines.items()):
            pid = self._pids.get(wid)
            if pid is None:
                self._spawn_deadlines.pop(wid, None)
                continue
            ent = self._entry(wid)
            if ent is not None and ent.get("pid") == pid:
                self._spawn_deadlines.pop(wid, None)
            elif now >= deadline:
                self._spawn_deadlines.pop(wid, None)
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass

    def _on_event(self, line: str):
        parts = line.split()
        if len(parts) < 3:
            return
        verb, wid, pid = parts[0], int(parts[1]), int(parts[2])
        if verb == "pid":
            with self._cond:
                self._pids[wid] = pid
                self._spawn_deadlines[wid] = (time.monotonic()
                                              + self._spawn_grace)
                self._cond.notify_all()
            return
        if verb != "exit":
            return
        with self._cond:
            if self._pids.get(wid) != pid:
                return
            del self._pids[wid]
            self._cond.notify_all()
        if self._stopping:
            return
        service = self.server.service_name
        _stats.GatewayWorkerRespawnsCounter.labels(service).inc()
        from ..stats import events as _events

        _events.emit(_events.WORKER_RESPAWN, service=service,
                     node=self.server.address,
                     detail={"worker": wid, "pid": pid})
        try:
            self._fork(wid, wait=False)
        except OSError:
            pass  # the template is gone: serve with the surviving fleet

    def _reap_loop(self):
        buf = b""
        while True:
            ready, _, _ = select.select([self._evt_r], [], [], 0.2)
            if ready:
                try:
                    chunk = os.read(self._evt_r, 4096)
                except OSError:
                    chunk = b""
                if not chunk:
                    return  # the template exited
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    self._on_event(line.decode())
            if not self._stopping:
                self._kill_unregistered()

    def stop(self, timeout: float = 5.0):
        self._stopping = True
        with self._cond:
            pids = list(self._pids.values())
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except (OSError, ProcessLookupError):
                pass
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pids and time.monotonic() < deadline:
                self._cond.wait(0.05)
            left = list(self._pids.values())
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        # EOF on the command pipe ends the template after its workers
        try:
            os.close(self._cmd_w)
        except OSError:
            pass
        if self.template_pid:
            end = time.monotonic() + timeout + 6.0
            while time.monotonic() < end:
                try:
                    done, _ = os.waitpid(self.template_pid, os.WNOHANG)
                except ChildProcessError:
                    done = self.template_pid
                if done:
                    break
                time.sleep(0.05)
            else:
                try:
                    os.kill(self.template_pid, signal.SIGKILL)
                    os.waitpid(self.template_pid, 0)
                except (OSError, ChildProcessError):
                    pass
            self.template_pid = 0
        if self._reaper is not None:
            self._reaper.join(timeout=2.0)
        try:
            os.close(self._evt_r)
        except OSError:
            pass
        with self._cond:
            self._pids.clear()
        self._spawn_deadlines.clear()
        if self._control is not None:
            try:
                self._control.shutdown()
                self._control.server_close()
            except OSError:
                pass
        if self.qos_shm is not None:
            try:
                from ..qos import shm as qshm
                qshm.destroy()
            except Exception:
                pass
            self.qos_shm = None
        shutil.rmtree(self.dir, ignore_errors=True)
        _set_role("solo", 0)

    # -- child ----------------------------------------------------------

    def _child_main(self, wid: int):
        server = self.server
        _set_role("worker", wid)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, self._child_term)
        random.seed(os.urandom(16))
        from . import http_rpc
        # Post-fork code must never acquire an inherited lock (one may
        # have been captured mid-hold by a thread that does not exist
        # here).  Shared structures are REPLACED, not locked:
        # inherited pooled client sockets are shared with the parent
        # (reusing one would interleave two processes on one TCP stream)
        http_rpc._POOL.reinit_after_fork()
        http_rpc._POOL.configure_for_prefork(self.workers)
        # Inherited accepted connections belong to the parent's threads
        # (which do not exist post-fork).  Swap in a fresh lock + set,
        # then close() the old ones — close only drops this process's
        # reference; never shutdown(), the fds are shared.
        conns = getattr(server.httpd, "_conns", None)
        if conns is not None:
            server.httpd._conns_lock = threading.Lock()
            server.httpd._conns = set()
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass
        if self.qos_shm is not None:
            from ..qos import shm as qshm
            qshm.set_worker_id(wid)
            self.qos_shm.reinit_after_fork()
            # service-scoped: in a combined daemon another service's
            # worker shares this wid, and its live counters must survive
            self.qos_shm.reset_worker(wid, server.service_name)
        httpd = None
        if reuseport_available():
            try:
                httpd = server._new_listener(server.host, server.port,
                                             reuseport=True)
            except OSError:
                httpd = None
        if httpd is None:
            # fd-sharing fallback: accept on the inherited listener
            httpd = server.httpd
        else:
            try:
                server.httpd.socket.close()
            except OSError:
                pass
        self._child_httpd = httpd
        server.on_worker_start_fire(wid)
        sideband = server._new_listener("127.0.0.1", 0)
        self._child_sideband = sideband
        threading.Thread(target=sideband.serve_forever,
                         kwargs={"poll_interval": 0.5}, daemon=True,
                         name=f"{server.service_name}-w{wid}-sideband"
                         ).start()
        self._write_entry(wid, os.getpid(),
                          f"127.0.0.1:{sideband.server_address[1]}")
        httpd.serve_forever(poll_interval=0.2)

    def _child_term(self, _signum, _frame):
        # shutdown() deadlocks when called from the serve_forever
        # thread (the one signals land on), so drain from a helper
        def drain():
            try:
                if self._child_httpd is not None:
                    self._child_httpd.shutdown()
                    self._child_httpd.wait_connections_closed(3.0)
            except Exception:
                pass
            os._exit(0)

        threading.Thread(target=drain, daemon=True).start()

    # -- request forwarding --------------------------------------------

    def proxy(self, addr: str, method: str, raw_path: str,
              body: bytes, headers) -> "object":
        """Relay one request verbatim to `addr`, preserving status,
        content type and body bytes (call() would re-encode error
        bodies, mangling e.g. S3 XML error documents)."""
        from .http_rpc import RpcError, Response, _POOL
        hop = {"connection", "keep-alive", "transfer-encoding", "te",
               "upgrade", "proxy-connection", "host", "content-length"}
        fwd = {k: v for k, v in headers.items() if k.lower() not in hop}
        fwd[FWD_HEADER] = "1"
        conn = _POOL.get(addr, 60.0)
        try:
            conn.request(method, raw_path, body=body or None, headers=fwd)
            r = conn.getresponse()
            data = r.read()
        except Exception as e:
            try:
                conn.close()
            except OSError:
                pass
            raise RpcError(f"prefork forward to {addr} failed: {e}",
                           502, addr=addr, route=raw_path, transport=True)
        if r.will_close:
            conn.close()
        else:
            _POOL.put(addr, conn)
        drop = {"connection", "keep-alive", "transfer-encoding",
                "content-length", "content-type", "date", "server"}
        out = {k: v for k, v in r.getheaders() if k.lower() not in drop}
        ctype = r.headers.get("Content-Type") or "application/octet-stream"
        return Response(data, r.status, ctype, out)

    def forward_to_parent(self, method: str, raw_path: str, body: bytes,
                          headers):
        return self.proxy(self.control_addr, method, raw_path, body, headers)

    def fanout(self, method: str, raw_path: str, body: bytes, headers):
        """Re-deliver an admin request to every OTHER worker's sideband
        (graceful drain / leave must reach the whole fleet)."""
        me = worker_id()
        for peer in self.peers():
            if peer.get("wid") == me:
                continue
            try:
                self.proxy(peer["sideband"], method, raw_path, body, headers)
            except Exception:
                pass  # a respawning worker picks up state via its env

    # -- cross-worker observability ------------------------------------

    def _scrape(self, addr: str, path: str, parse: bool):
        from .http_rpc import call
        return call(addr, path, parse=parse, timeout=5.0,
                    headers={FWD_HEADER: "1"})

    def _install_aggregators(self):
        server = self.server
        routes = server.routes

        def wrap(method, prefix, make):
            orig = routes.get((method, prefix))
            if orig is not None:
                server.add(method, prefix, make(orig))

        wrap("GET", "/metrics", self._make_metrics_agg)
        wrap("GET", "/debug/qos", self._make_qos_agg)
        wrap("GET", "/debug/traces", self._make_traces_agg)

    def _others(self):
        me = worker_id()
        return [p for p in self.peers() if p.get("wid") != me]

    def _make_metrics_agg(self, orig):
        group = self

        def handler(req):
            from .http_rpc import Response
            local = orig(req)
            if FWD_HEADER in req.headers:
                return local
            body = local.body if hasattr(local, "body") else local
            if isinstance(body, (bytearray, memoryview)):
                body = bytes(body)
            text = body.decode() if isinstance(body, bytes) else str(body)
            parts = [(str(worker_id()), text)]
            for peer in group._others():
                try:
                    raw = group._scrape(peer["sideband"], "/metrics",
                                        parse=False)
                    parts.append((str(peer["wid"]), raw.decode()))
                except Exception:
                    continue
            merged = _stats.merge_expositions(parts)
            return Response(merged.encode(),
                            content_type="text/plain; version=0.0.4")

        return handler

    def _make_qos_agg(self, orig):
        group = self

        def handler(req):
            local = orig(req)
            if FWD_HEADER in req.headers or not isinstance(local, dict):
                return local
            out = dict(local)
            out["workers"] = {str(worker_id()): local}
            for peer in group._others():
                try:
                    out["workers"][str(peer["wid"])] = group._scrape(
                        peer["sideband"], "/debug/qos", parse=True)
                except Exception:
                    continue
            return out

        return handler

    def _make_traces_agg(self, orig):
        group = self

        def handler(req):
            from .http_rpc import RpcError
            rest = req.path[len("/debug/traces"):].strip("/")
            if FWD_HEADER in req.headers:
                return orig(req)
            if not rest:  # index: concatenation of every worker's list
                local = orig(req)
                if not isinstance(local, dict):
                    return local
                merged = dict(local)
                traces = list(local.get("traces", []))
                for peer in group._others():
                    try:
                        remote = group._scrape(peer["sideband"],
                                               "/debug/traces", parse=True)
                        traces.extend(remote.get("traces", []))
                    except Exception:
                        continue
                merged["traces"] = traces
                return merged
            try:
                return orig(req)
            except RpcError as local_err:
                for peer in group._others():
                    try:
                        return group._scrape(peer["sideband"], req.path,
                                             parse=True)
                    except Exception:
                        continue
                raise local_err

        return handler
