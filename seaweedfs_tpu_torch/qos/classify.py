"""Request classification: QoS class + tenant key, thread-local scope,
and RPC header propagation.

Every request carries a QoS class — ``interactive`` (latency-sensitive
foreground reads), ``standard`` (ordinary writes / unclassified
traffic), or ``background`` (replication fan-out, curator jobs,
deep-scrub and bulk-encode traffic) — and an optional tenant key (the
S3 access key or the collection).  Both ride RPC headers
(``X-QoS-Class`` / ``X-QoS-Tenant``) exactly the way deadlines ride
``X-Deadline``: clients stamp the thread-local values into outbound
calls, ``RpcServer._dispatch`` installs them for the handler's
duration, and pool fan-outs re-pin them with :func:`set_qos` the same
way they re-pin deadlines.

Counterpart of seaweedfs_tpu/qos/classify.py.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional, Tuple

INTERACTIVE = "interactive"
STANDARD = "standard"
BACKGROUND = "background"

# dispatch-priority order: interactive drains first, background last
CLASSES = (INTERACTIVE, STANDARD, BACKGROUND)

QOS_HEADER = "X-QoS-Class"
TENANT_HEADER = "X-QoS-Tenant"

_ctx = threading.local()


def enabled() -> bool:
    """Master switch: WEED_QOS=0 restores the legacy flat shed gates."""
    return os.environ.get("WEED_QOS", "1") != "0"


def normalize(cls: Optional[str]) -> str:
    return cls if cls in CLASSES else STANDARD


def current_class() -> str:
    return getattr(_ctx, "qos_class", None) or STANDARD


def current_tenant() -> str:
    return getattr(_ctx, "qos_tenant", None) or ""


def set_qos(cls: Optional[str],
            tenant: Optional[str] = None) -> Tuple[Optional[str],
                                                   Optional[str]]:
    """Install (class, tenant) on this thread; returns the previous pair
    for restore — the non-context-manager form used by the server
    dispatch loop and pool fan-outs."""
    prev = (getattr(_ctx, "qos_class", None),
            getattr(_ctx, "qos_tenant", None))
    _ctx.qos_class = cls
    _ctx.qos_tenant = tenant
    return prev


class qos_scope:
    """``with qos_scope("background", tenant="maintenance"):`` — pins the
    class (and optionally the tenant) for the block; nested scopes
    restore the enclosing pair on exit.  ``tenant=None`` keeps the
    enclosing tenant."""

    __slots__ = ("cls", "tenant", "_prev")

    def __init__(self, cls: str, tenant: Optional[str] = None):
        self.cls = normalize(cls)
        self.tenant = tenant

    def __enter__(self):
        keep = current_tenant() if self.tenant is None else self.tenant
        self._prev = set_qos(self.cls, keep)
        return self

    def __exit__(self, *exc):
        set_qos(*self._prev)
        return False


def inject(headers: dict) -> dict:
    """Stamp the thread's QoS context into outbound RPC headers (no-op
    for unclassified standard traffic with no tenant)."""
    cls = getattr(_ctx, "qos_class", None)
    if cls:
        headers.setdefault(QOS_HEADER, cls)
    tenant = getattr(_ctx, "qos_tenant", None)
    if tenant:
        headers.setdefault(TENANT_HEADER, tenant)
    return headers


def from_headers(headers) -> Tuple[str, str]:
    """Server-side extraction: (class, tenant) from the propagation
    headers, defaulting to ``standard`` / no tenant."""
    return (normalize(headers.get(QOS_HEADER)),
            headers.get(TENANT_HEADER) or "")


def class_for_tenant(tenant: str, default: str) -> str:
    """Front-end classification override: WEED_QOS_CLASS_MAP maps tenant
    keys (S3 access keys / collections) to classes, e.g.
    ``analytics=background,mobile-app=interactive``."""
    spec = os.environ.get("WEED_QOS_CLASS_MAP", "")
    if spec and tenant:
        for part in spec.split(","):
            k, _, v = part.partition("=")
            if k.strip() == tenant and v.strip() in CLASSES:
                return v.strip()
    return default


def retry_after(base: int = 1, spread: int = 3,
                rand=random.random) -> str:
    """Jittered Retry-After header value in [base, base+spread] whole
    seconds — constant values synchronize shed clients into retry
    storms; full jitter decorrelates them."""
    base = max(1, int(base))
    spread = max(0, int(spread))
    return str(base + int(rand() * (spread + 1)) if spread else base)
