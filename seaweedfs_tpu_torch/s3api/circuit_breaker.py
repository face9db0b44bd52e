"""Request/byte concurrency limits for the S3 gateway.

Parity with weed/s3api/s3api_circuit_breaker.go: global and per-bucket
limits on simultaneous request count and in-flight upload/download bytes,
split by read/write action.  Exceeding a limit returns 503 SlowDown.  The
reference stores limits in the filer at /etc/s3/circuit_breaker.json and
hot-reloads; here the config is the same JSON shape, loadable from the
filer or passed directly.

The port's own copy of seaweedfs_tpu/s3api/circuit_breaker.py.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

CONFIG_PATH = "/etc/s3/circuit_breaker.json"

# limit kinds (s3_pb CircuitBreakerConfig actions)
LIMIT_COUNT = "Count"
LIMIT_BYTES = "MB"  # configured in megabytes like the reference shell


class SlowDown(Exception):
    """Raised when a limit trips; maps to S3 503 SlowDown."""


class _Gauge:
    __slots__ = ("count", "bytes")

    def __init__(self):
        self.count = 0
        self.bytes = 0


class CircuitBreaker:
    def __init__(self, config: Optional[dict] = None):
        self._lock = threading.Lock()
        self._global = _Gauge()
        self._buckets: dict[str, _Gauge] = {}
        self.enabled = False
        self.global_limits: dict[str, int] = {}
        self.bucket_limits: dict[str, dict[str, int]] = {}
        if config:
            self.load(config)

    def load(self, config: dict):
        """Config shape (circuit_breaker.json):
        {"global": {"enabled": true, "actions": {"Read:Count": 100,
         "Write:MB": 512, ...}},
         "buckets": {"b1": {"enabled": true, "actions": {...}}}}

        Built off to the side and swapped under the lock: hot-reload runs
        on a request thread while other requests are admitting."""
        glob = config.get("global", {})
        enabled = bool(glob.get("enabled"))
        global_limits = {k: int(v)
                         for k, v in glob.get("actions", {}).items()}
        bucket_limits: dict[str, dict[str, int]] = {}
        for bucket, conf in config.get("buckets", {}).items():
            if conf.get("enabled"):
                bucket_limits[bucket] = {
                    k: int(v) for k, v in conf.get("actions", {}).items()}
        with self._lock:
            self.enabled = enabled
            self.global_limits = global_limits
            self.bucket_limits = bucket_limits

    @classmethod
    def load_from_filer(cls, filer_server) -> "CircuitBreaker":
        return cls(read_config(filer_server) or {})

    # -- admission ----------------------------------------------------------
    def _check(self, limits: dict[str, int], gauge: _Gauge, action: str,
               nbytes: int):
        count_limit = limits.get(f"{action}:{LIMIT_COUNT}")
        if count_limit is not None and gauge.count + 1 > count_limit:
            raise SlowDown(f"too many concurrent {action} requests")
        byte_limit = limits.get(f"{action}:{LIMIT_BYTES}")
        if byte_limit is not None and \
                gauge.bytes + nbytes > byte_limit * (1 << 20):
            raise SlowDown(f"too many concurrent {action} bytes")

    def acquire(self, bucket: str, action: str, nbytes: int = 0):
        """Admit a request or raise SlowDown.  Returns a release handle."""
        with self._lock:
            # read the whole configuration under the same lock load()
            # swaps it under: one admission, ONE consistent config
            enabled = self.enabled
            bucket_rules = self.bucket_limits.get(bucket)
            if not enabled and bucket_rules is None:
                return lambda: None
            # only limited buckets need a gauge; unknown bucket names
            # must not grow the map unboundedly
            bucket_gauge = self._buckets.setdefault(bucket, _Gauge()) \
                if bucket_rules is not None else None
            if enabled:
                self._check(self.global_limits, self._global, action, nbytes)
            if bucket_rules is not None:
                self._check(bucket_rules, bucket_gauge, action, nbytes)
                bucket_gauge.count += 1
                bucket_gauge.bytes += nbytes
            self._global.count += 1
            self._global.bytes += nbytes

        released = threading.Event()

        def release():
            if released.is_set():
                return
            released.set()
            with self._lock:
                self._global.count -= 1
                self._global.bytes -= nbytes
                if bucket_gauge is not None:
                    bucket_gauge.count -= 1
                    bucket_gauge.bytes -= nbytes

        return release


def read_config(filer_server) -> Optional[dict]:
    """Fetch /etc/s3/circuit_breaker.json through the filer's full read
    path — configs past the inline limit live in chunks, so
    entry.content alone would silently read as empty.

    Returns {} when no config exists, and None on a TRANSIENT read
    failure: a hot-reloading caller must keep its current limits rather
    than silently dropping all throttles."""
    from ..filer.filer_store import NotFoundError
    from ..rpc.http_rpc import RpcError

    try:
        entry = filer_server.filer.find_entry(CONFIG_PATH)
        return json.loads(filer_server.read_bytes(entry).decode())
    except (NotFoundError, ValueError):
        return {}
    except RpcError:
        return None
