"""Generic bounded resource pool (wdclient/resource_pool, the Dropbox
net2-derived pool the reference vendors): borrow/return with a cap on
open resources, idle reuse, and broken-resource disposal.

The port's own copy of seaweedfs_tpu/wdclient/resource_pool.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class PoolClosedError(Exception):
    pass


class ResourcePool(Generic[T]):
    def __init__(self, factory: Callable[[], T],
                 close_fn: Optional[Callable[[T], None]] = None,
                 max_open: int = 16, max_idle: int = 4,
                 borrow_timeout: float = 30.0):
        self._factory = factory
        self._close_fn = close_fn or (lambda r: None)
        self._max_open = max_open
        self._max_idle = max_idle
        self._borrow_timeout = borrow_timeout
        self._idle: list[T] = []
        self._open_count = 0
        self._closed = False
        self._cond = threading.Condition()

    def borrow(self) -> T:
        deadline = time.monotonic() + self._borrow_timeout
        with self._cond:
            while True:
                if self._closed:
                    raise PoolClosedError("pool is closed")
                if self._idle:
                    return self._idle.pop()
                if self._open_count < self._max_open:
                    self._open_count += 1
                    break  # create outside the lock
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("no pooled resource available")
                self._cond.wait(remaining)
        try:
            return self._factory()
        except Exception:
            with self._cond:
                self._open_count -= 1
                self._cond.notify()
            raise

    def give_back(self, resource: T, broken: bool = False):
        with self._cond:
            if broken or self._closed \
                    or len(self._idle) >= self._max_idle:
                self._open_count -= 1
                self._cond.notify()
                to_close = resource
            else:
                self._idle.append(resource)
                self._cond.notify()
                return
        self._close_fn(to_close)

    def use(self):
        """Context manager: with pool.use() as r: ..."""
        pool = self

        class _Ctx:
            def __enter__(self):
                self.resource = pool.borrow()
                return self.resource

            def __exit__(self, exc_type, exc, tb):
                pool.give_back(self.resource, broken=exc_type is not None)
                return False

        return _Ctx()

    def close(self):
        with self._cond:
            self._closed = True
            idle, self._idle = self._idle, []
            self._open_count -= len(idle)
            self._cond.notify_all()
        for resource in idle:
            self._close_fn(resource)

    @property
    def stats(self) -> dict:
        with self._cond:
            return {"open": self._open_count, "idle": len(self._idle),
                    "max_open": self._max_open}
