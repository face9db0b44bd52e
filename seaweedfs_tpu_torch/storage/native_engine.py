"""ctypes bindings for the native volume engine (native/vol_native.cpp).

The engine owns the hot data plane of a volume: the needle index, the
.dat append path with its .idx entry log, and a framed-TCP server that
answers read/write/delete requests entirely off the GIL (the reference's
equivalent surface is compiled Go: weed/storage/needle_map,
volume_write.go, and the volume server's handler goroutines).

Python and C++ share one index and one append mutex per volume, so
requests served natively and requests served by the Python HTTP handlers
always see each other's writes.  `NativeNeedleMap` plugs the engine into
`Volume` behind the same interface as the pure-Python map kinds
(needle_map.py BaseNeedleMap).

The port's own copy of seaweedfs_tpu/storage/native_engine.py.  The
engine keeps process-global state (request counters, the vid-to-handle
serving registries, JWT keys, replica sets), so the port never loads the
JAX package's `native/libseaweedvol.so`: it compiles its own copy of
`native/vol_native.cpp` with the Makefile's flags into the git-ignored
`seaweedfs_tpu_torch/_build/` (named by a hash of source and flags) and
loads that, so both packages in one process run two engines that share
nothing.

Degraded EC reads on the native TCP port are served on the host, by the
engine itself, through the recovery rows `NativeEcBinding` pushes (one
GF(2^8) row per missing data shard over 10 local survivors).  That is
the JAX package's design for this path, not a fallback from the card:
the HTTP path decodes through kernel K1 on the card.

Set SW_NATIVE=0 to disable the engine even when the library builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from . import idx as idx_mod
from . import types as t

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "vol_native.cpp")
_BUILD_DIR = os.path.join(_REPO, "seaweedfs_tpu_torch", "_build")
# native/Makefile's flags for libseaweedvol.so
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LINK = ("-lpthread", "-lz")

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_u32 = ctypes.c_uint32


def lib_path() -> str:
    """Where the port's build of the engine lives (by source and flags)."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS + _LINK).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libseaweedvol-{h.hexdigest()[:16]}.so")


def _build(path: str):
    """Compile the engine into `path`, one process at a time (a lock file
    beside it), writing through a temporary name."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "libseaweedvol.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o",
                        tmp, _SOURCE, *_LINK], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)


@functools.lru_cache(maxsize=1)
def lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("SW_NATIVE", "1") == "0":
        return None
    path = lib_path()
    if not os.path.exists(path):
        try:
            _build(path)
        except (OSError, subprocess.SubprocessError):
            return None  # no toolchain: the Python maps serve, as with
            # SW_NATIVE=0
    try:
        cdll = ctypes.CDLL(path)
    except OSError:
        return None
    cdll.svn_register.restype = _i64
    cdll.svn_register.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    cdll.svn_unregister.argtypes = [_i64]
    cdll.svn_set_flags.argtypes = [_i64, ctypes.c_int, ctypes.c_int]
    cdll.svn_serve.argtypes = [_u32, _i64]
    cdll.svn_nm_put.argtypes = [_i64, _u64, _u64, _i64]
    cdll.svn_nm_put_if_newer.argtypes = [_i64, _u64, _u64, _i64]
    cdll.svn_nm_delete.argtypes = [_i64, _u64, _u64]
    cdll.svn_nm_set_memory.argtypes = [_i64, _u64, _u64, _i64]
    cdll.svn_nm_get.argtypes = [_i64, _u64, ctypes.POINTER(_u64),
                                ctypes.POINTER(_i64)]
    cdll.svn_nm_stats.argtypes = [_i64, ctypes.POINTER(_i64)]
    cdll.svn_nm_visit.restype = _i64
    cdll.svn_nm_visit.argtypes = [_i64, ctypes.POINTER(_i64), _i64]
    cdll.svn_append.restype = _i64
    cdll.svn_append.argtypes = [_i64, ctypes.c_char_p, _i64]
    cdll.svn_size.restype = _i64
    cdll.svn_size.argtypes = [_i64]
    cdll.svn_sync.argtypes = [_i64]
    cdll.svn_touch.argtypes = [_i64, _u64, _i64]
    cdll.svn_quiesce.argtypes = [_i64]
    cdll.svn_last_modified.restype = _i64
    cdll.svn_last_modified.argtypes = [_i64]
    cdll.svn_ec_register.restype = _i64
    cdll.svn_ec_register.argtypes = [ctypes.c_char_p, ctypes.c_int, _i64,
                                     _i64]
    cdll.svn_ec_add_shard.argtypes = [_i64, ctypes.c_int, ctypes.c_char_p]
    cdll.svn_ec_remove_shard.argtypes = [_i64, ctypes.c_int]
    cdll.svn_ec_set_recovery.argtypes = [_i64, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int]
    cdll.svn_ec_serve.argtypes = [_u32, _i64]
    cdll.svn_ec_unregister.argtypes = [_i64]
    cdll.svn_ec_refresh.argtypes = [_i64]
    cdll.svn_set_ttl.argtypes = [_i64, _i64, _u32]
    cdll.svn_set_replication.argtypes = [_i64, ctypes.c_int]
    cdll.svn_set_replicas.argtypes = [_u32, ctypes.c_char_p]
    cdll.svn_server_set_jwt.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int]
    cdll.svn_server_start.restype = ctypes.c_int
    cdll.svn_server_start.argtypes = [ctypes.c_char_p, ctypes.c_int]
    cdll.svn_server_set_redirect.argtypes = [ctypes.c_char_p]
    cdll.svn_server_port.restype = ctypes.c_int
    cdll.svn_assign_add_lease.argtypes = [_u32, ctypes.c_char_p,
                                          ctypes.c_char_p, _u64, _u64]
    cdll.svn_assign_remaining.restype = _i64
    cdll.svn_assign_remaining.argtypes = [_i64]
    cdll.svn_assign_clear.argtypes = []
    cdll.svn_server_stop.restype = ctypes.c_int
    cdll.svn_server_stats.argtypes = [ctypes.POINTER(_i64)]
    cdll.svn_bench.restype = ctypes.c_double
    cdll.svn_bench.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_char_p, _i64, _i64, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(_i64)]
    return cdll


def available() -> bool:
    return lib() is not None


class NeedleValue:
    __slots__ = ("offset", "size")

    def __init__(self, offset: int, size: int):
        self.offset = offset
        self.size = size


class NativeNeedleMap:
    """BaseNeedleMap-compatible map whose storage, counters and .idx
    append log live in the native engine (one source of truth shared with
    the native TCP server)."""

    kind = "native"

    def __init__(self, dat_path: str, idx_path: str, version: int,
                 writable: bool, read_only: bool, fsync: bool,
                 ttl_sec: int = 0, extra_copies: int = 0,
                 ttl_raw: int = 0):
        self._lib = lib()
        if self._lib is None:
            raise RuntimeError("native engine unavailable")
        self.index_path = idx_path
        h = self._lib.svn_register(dat_path.encode(), idx_path.encode(),
                                   version, int(writable), int(read_only),
                                   int(fsync))
        if h <= 0:
            raise OSError(-h, f"svn_register({dat_path!r}) failed")
        self.handle = h
        # bytes of the .idx this map holds: the whole file once the engine
        # has loaded it, plus every entry appended through this object.  A
        # prefork worker's copy tails the parent's appends from here
        # (refresh_from_idx).
        self._idx_tail = os.path.getsize(idx_path)
        if ttl_sec:
            # ttl_raw = the volume TTL's (count<<8)|unit form: native
            # writes stamp FlagHasTtl + these 2 bytes into each needle
            self._lib.svn_set_ttl(h, int(ttl_sec), int(ttl_raw))
        if extra_copies:
            self._lib.svn_set_replication(h, int(extra_copies))

    # -- mutate --------------------------------------------------------------
    def put(self, nid: int, offset: int, size: int):
        self._lib.svn_nm_put(self.handle, nid, offset, size)
        self._idx_tail += t.NEEDLE_MAP_ENTRY_SIZE

    def put_if_newer(self, nid: int, offset: int, size: int) -> bool:
        """Atomic form of the write path's "newer offset wins" guard
        (volume_write.go:160-165): evaluated under the engine's map lock
        so a racing native-port write cannot be clobbered.  Raises
        OSError when the .idx append failed (ENOSPC/EIO) — the write
        must fail before it is acknowledged, not vanish on restart."""
        rc = self._lib.svn_nm_put_if_newer(self.handle, nid, offset, size)
        if rc < 0:
            raise OSError(-rc, "idx append failed")
        if rc == 1:
            self._idx_tail += t.NEEDLE_MAP_ENTRY_SIZE
        return rc == 1

    def delete(self, nid: int, offset: int):
        rc = self._lib.svn_nm_delete(self.handle, nid, offset)
        if rc < 0:
            raise OSError(-rc, "idx append failed")
        self._idx_tail += t.NEEDLE_MAP_ENTRY_SIZE

    def refresh_from_idx(self) -> int:
        """Replay entries another process appended to the .idx since this
        map last read it, into this process's engine map only (a prefork
        worker tailing the parent's writes; the worker never appends).
        Returns the number of entries applied.

        The JAX package's native map has no such method, so its workers
        serve a needle the parent deleted after the fork from their stale
        snapshot (DELETE-then-GET answers 200 with the old bytes); the
        port tails the log as the Python maps do."""
        size = os.path.getsize(self.index_path)
        size -= size % t.NEEDLE_MAP_ENTRY_SIZE
        if size <= self._idx_tail:
            return 0
        with open(self.index_path, "rb") as f:
            f.seek(self._idx_tail)
            raw = f.read(size - self._idx_tail)
        n = len(raw) // t.NEEDLE_MAP_ENTRY_SIZE
        for i in range(n):
            nid, off, sz = idx_mod.unpack_entry(
                raw[i * t.NEEDLE_MAP_ENTRY_SIZE:
                    (i + 1) * t.NEEDLE_MAP_ENTRY_SIZE])
            self._lib.svn_nm_set_memory(self.handle, nid, off, sz)
        self._idx_tail += n * t.NEEDLE_MAP_ENTRY_SIZE
        return n

    def set_in_memory(self, nid: int, offset: int, size: int):
        self._lib.svn_nm_set_memory(self.handle, nid, offset, size)

    # -- query ---------------------------------------------------------------
    def get(self, nid: int) -> Optional[NeedleValue]:
        off = _u64()
        size = _i64()
        r = self._lib.svn_nm_get(self.handle, nid, ctypes.byref(off),
                                 ctypes.byref(size))
        if r != 1:
            return None
        return NeedleValue(off.value, size.value)

    def __contains__(self, nid: int) -> bool:
        return self.get(nid) is not None

    def _stats(self) -> np.ndarray:
        out = (ctypes.c_int64 * 7)()
        self._lib.svn_nm_stats(self.handle, out)
        return np.ctypeslib.as_array(out).copy()

    @property
    def file_count(self) -> int:
        return int(self._stats()[0])

    @property
    def deleted_count(self) -> int:
        return int(self._stats()[1])

    def content_size(self) -> int:
        return int(self._stats()[2])

    def deleted_size(self) -> int:
        return int(self._stats()[3])

    def max_file_key(self) -> int:
        return int(self._stats()[4])

    def __len__(self) -> int:
        return int(self._stats()[5])

    def last_append_ns(self) -> int:
        return int(self._stats()[6])

    def last_modified(self) -> int:
        return max(0, int(self._lib.svn_last_modified(self.handle)))

    def items_ascending(self) -> Iterator[tuple[int, NeedleValue]]:
        if not self.handle:
            return
        cap = max(len(self), 1)
        while True:
            buf = (ctypes.c_int64 * (cap * 3))()
            n = self._lib.svn_nm_visit(self.handle, buf, cap)
            if n >= 0:
                break
            if n == -(2 ** 63):  # INT64_MIN: handle gone (closed under us)
                return
            cap = -n  # raced a concurrent insert: retry at the new size
        arr = np.ctypeslib.as_array(buf)[: n * 3].reshape(n, 3)
        for nid, off, size in arr:
            yield int(nid), NeedleValue(int(off), int(size))

    def ascending_visit(self, fn: Callable[[int, NeedleValue], None]):
        for nid, nv in self.items_ascending():
            fn(nid, nv)

    # -- append path ---------------------------------------------------------
    def append_dat(self, blob: bytes) -> int:
        """Append a record to the .dat under the engine's shared write
        mutex; returns the landing offset."""
        off = self._lib.svn_append(self.handle, blob, len(blob))
        if off < 0:
            raise OSError(-off, "native append failed")
        return off

    def touch(self, append_ns: int, modified_ts: int):
        self._lib.svn_touch(self.handle, append_ns, modified_ts)

    def set_flags(self, writable: Optional[bool] = None,
                  read_only: Optional[bool] = None):
        self._lib.svn_set_flags(
            self.handle,
            -1 if writable is None else int(writable),
            -1 if read_only is None else int(read_only))

    def quiesce(self):
        """Disable native-path writes and drain any in-flight append."""
        self._lib.svn_quiesce(self.handle)

    # -- durability ----------------------------------------------------------
    def flush(self):
        pass  # idx appends are unbuffered write()s

    def sync(self):
        self._lib.svn_sync(self.handle)

    def close(self):
        if self.handle:
            self._lib.svn_unregister(self.handle)
            self.handle = 0

    def bytes_per_entry(self) -> float:
        return 25.0  # 16B slot + state byte + vector overhead


class NativeEcBinding:
    """Native serving of an EcVolume's local-shard reads: the .ecx and
    every local `.ecNN` open in C++, bound to the vid for the TCP server.
    Reads whose intervals touch a non-local shard answer 307 and fall
    back to the Python ladder (remote fetch / on-the-fly reconstruct)."""

    def __init__(self, ec_volume):
        self._lib = lib()
        if self._lib is None:
            raise RuntimeError("native engine unavailable")
        base = ec_volume.base_file_name()
        h = self._lib.svn_ec_register(
            (base + ".ecx").encode(), ec_volume.version,
            ec_volume.large_block_size, ec_volume.small_block_size)
        if h <= 0:
            raise OSError(-h, f"svn_ec_register({base!r}) failed")
        self.handle = h
        self.shard_ids: frozenset = frozenset()
        self.sync_shards(ec_volume)

    def sync_shards(self, ec_volume):
        current = frozenset(ec_volume.shards)
        for sid in sorted(current - self.shard_ids):
            shard = ec_volume.shards[sid]
            self._lib.svn_ec_add_shard(
                self.handle, sid, shard.file_name().encode())
        for sid in sorted(self.shard_ids - current):
            # unmounted shards must stop serving (and release the fd:
            # ec.balance deletes the file after moving it)
            self._lib.svn_ec_remove_shard(self.handle, sid)
        changed = current != self.shard_ids
        self.shard_ids = current
        if changed:
            # recovery rows depend only on the shard SET; skip the
            # matrix inversions + 14 FFI calls on every unchanged
            # heartbeat resync
            self._sync_recovery(current)
        self._lib.svn_ec_refresh(self.handle)

    def _sync_recovery(self, current: frozenset):
        """Push per-missing-shard reconstruction rows so the engine
        serves DEGRADED reads natively: with >=10 local shards, any
        missing data shard's span is a fixed GF(2^8) combination of the
        survivors' same-offset bytes (rebuild_matrix — the one-matmul
        form of klauspost Reconstruct).  A wrong row cannot serve
        silently: the needle CRC check rejects it."""
        if len(current) >= 10:
            from ..parallel.batched_encode import rebuild_matrix

            present = sorted(current)
            for sid in range(14):
                if sid in current:
                    self._lib.svn_ec_set_recovery(
                        self.handle, sid, b"", b"", 0)
                    continue
                chosen, matrix = rebuild_matrix(present, [sid])
                self._lib.svn_ec_set_recovery(
                    self.handle, sid, bytes(chosen[:10]),
                    bytes(int(c) for c in matrix[0][:10]), 10)
        else:
            for sid in range(14):
                self._lib.svn_ec_set_recovery(self.handle, sid, b"",
                                              b"", 0)

    def close(self):
        if self.handle:
            self._lib.svn_ec_unregister(self.handle)
            self.handle = 0


def serve_ec_volume(vid: int, binding: NativeEcBinding) -> bool:
    cdll = lib()
    if cdll is None:
        return False
    return cdll.svn_ec_serve(vid, binding.handle) == 0


def unserve_ec_volume(vid: int):
    cdll = lib()
    if cdll is not None:
        cdll.svn_ec_serve(vid, 0)


# -- server / serving registry ----------------------------------------------

def serve_volume(vid: int, nm) -> bool:
    """Bind vid -> nm.handle for the native TCP server (0 unbinds)."""
    cdll = lib()
    if cdll is None or not isinstance(nm, NativeNeedleMap):
        return False
    return cdll.svn_serve(vid, nm.handle) == 0


def unserve_volume(vid: int):
    cdll = lib()
    if cdll is not None:
        cdll.svn_serve(vid, 0)


def server_set_redirect(addr: str):
    """Point the native port's HTTP 302 fallback at the full handler
    (the listener may have been started by a daemon that didn't know
    the volume server's address, e.g. the master in a combined
    process)."""
    cdll = lib()
    if cdll is not None:
        cdll.svn_server_set_redirect(addr.encode())


def server_set_jwt(write_key: str | bytes | None = "",
                   read_key: str | bytes | None = "",
                   expire_s: int = 10):
    """Configure HS256 signing keys for the fast-path port (writes
    require fid-scoped tokens; reads too when read_key is set).  The
    'A' assign handler mints matching write tokens.

    The keys are engine-global and shared by every in-process daemon:
    pass None to leave a key untouched, so one owner (e.g. a master
    shutting down) can clear ITS key without clearing the other
    daemon's.  Empty string explicitly disables a key."""
    cdll = lib()
    if cdll is None:
        return

    def enc(k):
        if k is None:
            return None
        return k.encode() if isinstance(k, str) else bytes(k)

    cdll.svn_server_set_jwt(enc(write_key), enc(read_key), int(expire_s))


def set_replicas(vid: int, addrs: list[str]):
    """Publish vid's peer fast-path addresses for native write fan-out
    (empty list clears)."""
    cdll = lib()
    if cdll is not None:
        cdll.svn_set_replicas(vid, ",".join(addrs).encode())


def server_start(host: str, port: int, http_redirect: str = "") -> int:
    """Start the native fast-path server; returns the bound port.
    `http_redirect` is the volume server's full HTTP address — plain
    HTTP requests the native port cannot serve 302 there."""
    cdll = lib()
    if cdll is None:
        raise RuntimeError("native engine unavailable")
    cdll.svn_server_set_redirect(http_redirect.encode())
    bound = cdll.svn_server_start(host.encode(), port)
    if bound < 0:
        raise OSError(-bound, "native server start failed")
    return bound


def server_stop():
    cdll = lib()
    if cdll is not None:
        cdll.svn_server_stop()


def server_port() -> int:
    """Bound port of the process-wide native listener (0 = none)."""
    cdll = lib()
    return cdll.svn_server_port() if cdll is not None else 0


# one volume server per process may own the vid->handle serving registry
# (the listener itself may have been started by the master for assign
# leases in a combined process — serving is a separate claim)
_serving_lock = threading.Lock()
_serving_claimed = False


def claim_serving() -> bool:
    global _serving_claimed
    with _serving_lock:
        if _serving_claimed:
            return False
        _serving_claimed = True
        return True


def release_serving():
    global _serving_claimed
    with _serving_lock:
        _serving_claimed = False


def assign_add_lease(vid: int, url: str, public_url: str,
                     key_start: int, key_end: int) -> bool:
    """Lease [key_start, key_end] (inclusive) of volume vid's key space
    to the native 'A' assign handler."""
    cdll = lib()
    if cdll is None:
        return False
    return cdll.svn_assign_add_lease(
        vid, url.encode(), (public_url or "").encode(),
        key_start, key_end) == 0


def assign_remaining(max_age_ms: int = 0) -> int:
    """Remaining leased keys; prunes exhausted leases and, when
    max_age_ms > 0, leases older than that (per-lease staleness bound)."""
    cdll = lib()
    return (int(cdll.svn_assign_remaining(max_age_ms))
            if cdll is not None else 0)


def assign_clear():
    cdll = lib()
    if cdll is not None:
        cdll.svn_assign_clear()


def server_stats() -> dict:
    """Cumulative native-server request counters (process-wide)."""
    cdll = lib()
    if cdll is None:
        return {}
    out = (ctypes.c_int64 * 7)()
    cdll.svn_server_stats(out)
    keys = ("read", "ec_read", "write", "delete", "http_read",
            "fallback", "error")
    return dict(zip(keys, (int(v) for v in out)))


def bench(host: str, port: int, op: str, fids: list[str], nreqs: int,
          payload_size: int = 0, concurrency: int = 16
          ) -> tuple[float, int, np.ndarray]:
    """Drive the native load generator; returns (seconds, errors,
    latencies_ms ndarray)."""
    cdll = lib()
    if cdll is None:
        raise RuntimeError("native engine unavailable")
    blob = "\n".join(fids).encode()
    lat = (ctypes.c_float * nreqs)()
    errs = _i64()
    seconds = cdll.svn_bench(host.encode(), port, ord(op[0]), blob,
                             len(fids), nreqs, payload_size, concurrency,
                             lat, ctypes.byref(errs))
    lat_ms = np.ctypeslib.as_array(lat).astype(np.float64) / 1000.0
    # request slots never claimed (all workers dead) report latency 0;
    # they are already counted in errs — drop them from the histogram
    lat_ms = lat_ms[lat_ms > 0]
    return seconds, int(errs.value), lat_ms


__all__ = ["lib", "available", "NativeNeedleMap", "serve_volume",
           "unserve_volume", "server_start", "server_stop", "bench"]
