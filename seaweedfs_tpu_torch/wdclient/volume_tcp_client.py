"""TCP fast path for volume reads/writes (wdclient/volume_tcp_client.go).

HTTP adds per-request header parsing on the hottest path — the
reference's experimental TCP mode trades it for a trivial framed
protocol on a dedicated port (http port + 20000).  Frame format:

  request:  "G <fid>[ <jwt>]\n"          (read needle; jwt when the
                                          cluster signs reads)
            "W <fid> <length>\n<body>"   (write needle, native engine)
            "D <fid>\n"                  (delete needle, native engine)
  response: u32be status | u32be length | payload
            status 0 = ok, 307 = fall back to the HTTP port (volume not
            served natively), 401 = unauthorized, 404 = not found,
            500 = error

The server side is the native engine (native/vol_native.cpp) when the
library is available, else the Python TCP loop (reads only).
Connections are pooled per server address via ResourcePool.

The port's own copy of seaweedfs_tpu/wdclient/volume_tcp_client.py.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from .resource_pool import ResourcePool

TCP_PORT_OFFSET = 20000  # mirrors the reference's port+20000 convention


class VolumeTcpError(Exception):
    def __init__(self, message: str, status: int = 500):
        super().__init__(message)
        self.status = status


class VolumeTcpClient:
    """Pooled TCP connections to volume servers' fast-path ports."""

    def __init__(self, max_conns_per_server: int = 8):
        self._pools: dict[str, ResourcePool[socket.socket]] = {}
        self._resolved: dict[str, str] = {}  # http url -> tcp addr
        self._lock = threading.Lock()
        self._max = max_conns_per_server

    def _pool(self, tcp_addr: str) -> ResourcePool:
        with self._lock:
            pool = self._pools.get(tcp_addr)
            if pool is None:
                host, port = tcp_addr.rsplit(":", 1)

                def factory(host=host, port=int(port)):
                    s = socket.create_connection((host, port), timeout=30)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    return s

                pool = ResourcePool(
                    factory, close_fn=lambda s: s.close(),
                    max_open=self._max, max_idle=self._max)
                self._pools[tcp_addr] = pool
            return pool

    def tcp_address(self, http_url: str) -> str:
        """port+20000 by convention, verified with one cheap probe; when
        the convention port is not listening (ephemeral test ports, or a
        combined process whose single native listener rides the master's
        port) ask the server's /admin/status for its actual tcp_port."""
        with self._lock:
            cached = self._resolved.get(http_url)
        if cached:
            return cached
        host, port = http_url.rsplit(":", 1)
        wanted = int(port) + TCP_PORT_OFFSET
        resolved = ""
        if wanted <= 65535:
            try:
                probe = socket.create_connection((host, wanted),
                                                 timeout=0.5)
                probe.close()
                resolved = f"{host}:{wanted}"
            except OSError:
                pass
        if not resolved:
            from ..rpc.http_rpc import call

            status = call(http_url, "/admin/status", timeout=10)
            tcp_port = status.get("tcp_port", 0)
            if not tcp_port:
                raise VolumeTcpError(
                    f"{http_url} does not serve the TCP fast path", 503)
            resolved = f"{host}:{tcp_port}"
        with self._lock:
            self._resolved[http_url] = resolved
        return resolved

    def _request(self, volume_server_url: str, frame: bytes) -> bytes:
        try:
            pool = self._pool(self.tcp_address(volume_server_url))
            with pool.use() as conn:
                conn.sendall(frame)
                header = _read_exact(conn, 8)
                status, length = struct.unpack(">II", header)
                payload = _read_exact(conn, length)
        except OSError as e:
            # a dead pooled connection often means the server restarted
            # on a new ephemeral port: drop the cached resolution so the
            # next call re-probes instead of pinning HTTP-fallback forever
            with self._lock:
                self._resolved.pop(volume_server_url, None)
            raise VolumeTcpError(f"fast path unreachable: {e}", 307) \
                from None
        if status != 0:
            raise VolumeTcpError(
                payload.decode(errors="replace") or "request failed",
                status)
        return payload

    def read_needle(self, volume_server_url: str, fid: str,
                    jwt: str = "", http_fallback: bool = True) -> bytes:
        """Fast-path read; a 307 (volume not served natively: EC volume,
        sqlite index, TTL volume, vacuum window) falls back to HTTP
        unless the caller wants to see the 307 and route itself."""
        line = f"G {fid} {jwt}\n" if jwt else f"G {fid}\n"
        try:
            return self._request(volume_server_url, line.encode())
        except VolumeTcpError as e:
            if e.status != 307 or not http_fallback:
                raise
            return self._http_fallback(volume_server_url, fid, "GET",
                                       jwt=jwt)

    def write_needle(self, volume_server_url: str, fid: str,
                     data: bytes, jwt: str = "") -> bytes:
        """Fast-path write (native engine only; JWT-secured clusters
        pass the assign's fid-scoped token).  307 (no native engine,
        replica set unpublished, vacuum window) falls back to the HTTP
        handler, whose fan-out + identical-rewrite dedup keep a
        partially-forwarded native attempt consistent."""
        line = f"W {fid} {len(data)} {jwt}\n" if jwt \
            else f"W {fid} {len(data)}\n"
        try:
            return self._request(volume_server_url, line.encode() + data)
        except VolumeTcpError as e:
            if e.status != 307:
                raise
            return self._http_fallback(volume_server_url, fid, "POST",
                                       body=data, jwt=jwt)

    def delete_needle(self, volume_server_url: str, fid: str,
                      jwt: str = "") -> bytes:
        line = f"D {fid} {jwt}\n" if jwt else f"D {fid}\n"
        try:
            return self._request(volume_server_url, line.encode())
        except VolumeTcpError as e:
            if e.status != 307:
                raise
            return self._http_fallback(volume_server_url, fid, "DELETE",
                                       jwt=jwt)

    def _http_fallback(self, url: str, fid: str, method: str,
                       body: Optional[bytes] = None, jwt: str = "") -> bytes:
        from ..rpc.http_rpc import RpcError, call

        headers = {"Authorization": "BEARER " + jwt} if jwt else {}
        try:
            result = call(url, f"/{fid}", method=method, raw=body,
                          headers=headers, timeout=30)
        except RpcError as e:
            raise VolumeTcpError(str(e), e.status) from None
        if isinstance(result, (bytes, bytearray)):
            return bytes(result)
        import json as _json

        return _json.dumps(result).encode()

    def close(self):
        with self._lock:
            pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            pool.close()


def _read_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n > 0:
        chunk = conn.recv(n)
        if not chunk:
            raise VolumeTcpError("connection closed mid-frame")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)
