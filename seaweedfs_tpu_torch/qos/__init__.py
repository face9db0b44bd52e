"""Cluster quality-of-service: tenant-aware admission control,
weighted-fair scheduling, and priority device lanes.

Counterpart of seaweedfs_tpu/qos/__init__.py.

* :mod:`.classify`: QoS classes (interactive/standard/background), tenant
  keys, thread-local scope, and X-QoS-Class/X-QoS-Tenant header
  propagation.
* :mod:`.admission`: per-daemon front-end gates: bounded per-class
  queues, deficit-round-robin dispatch, per-tenant token buckets,
  class-aware shedding (background first, interactive last).
* :mod:`.quota`: per-collection byte/ops quotas.
* :mod:`.shm`: the shared-memory state a prefork group would share.
* :mod:`.lanes`: foreground/background device lanes for the EC pipeline:
  degraded-read decodes preempt queued background batches on the card.

Every daemon mounts ``GET /debug/qos`` via :func:`mount`.
"""

from __future__ import annotations

from .admission import (AdmissionGate, DrrQueue, TenantBuckets,  # noqa: F401
                        TokenBucket, class_weights)
from .classify import (BACKGROUND, CLASSES, INTERACTIVE,  # noqa: F401
                       QOS_HEADER, STANDARD, TENANT_HEADER,
                       class_for_tenant, current_class, current_tenant,
                       enabled, from_headers, inject, normalize,
                       qos_scope, retry_after, set_qos)
from .lanes import LANES, DeviceLanes, lanes_enabled  # noqa: F401
from .quota import QUOTAS, CollectionQuotas  # noqa: F401
from . import shm  # noqa: F401


def snapshot(gate=None) -> dict:
    """One daemon's QoS state: its admission gate (if it has one), the
    process-wide device lanes, and the quota meter."""
    return {
        "enabled": enabled(),
        "gate": gate.snapshot() if gate is not None else None,
        "lanes": LANES.snapshot(),
        "quotas": QUOTAS.snapshot(),
    }


def mount(server, gate=None):
    """Register GET /debug/qos on an RpcServer."""
    server.add("GET", "/debug/qos", lambda req: snapshot(gate))
