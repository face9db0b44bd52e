"""Liveness and readiness probes for every daemon.

``GET /healthz`` answers 200 the moment the RpcServer accepts
connections — process liveness, nothing else.  ``GET /readyz`` runs the
daemon's registered readiness checks (raft leader known, store mounted,
admission gates not saturated, not draining) and answers 503 with the
failing checks listed until all pass, so load balancers and
``weed.py top``/``cluster.check`` can tell "up" from "able to serve".

Counterpart of seaweedfs_tpu/stats/healthz.py.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Optional, Tuple

Check = Tuple[str, bool, str]  # (name, ok, detail)


def _gate_saturation() -> float:
    try:
        return float(os.environ.get("WEED_READY_GATE_OCC", "") or 0.95)
    except ValueError:
        return 0.95


def gate_check(gate) -> Check:
    """Shared readiness check: the QoS admission gate still has
    headroom (a saturated gate means new requests only queue)."""
    if gate is None:
        return ("gate", True, "no gate")
    occ = gate.occupancy()
    limit = _gate_saturation()
    return ("gate", occ < limit, f"occupancy={occ:.2f} limit={limit:.2f}")


def mount_health(server, ready: Optional[Callable[[], Iterable[Check]]]
                 = None):
    """Register /healthz + /readyz on an RpcServer (the qos.mount /
    faults.mount pattern).  ``ready`` returns the daemon's check
    tuples; omitted means always ready once serving."""

    def h_healthz(req):
        return {"ok": True, "service": server.service_name}

    def h_readyz(req):
        from ..rpc.http_rpc import Response

        checks: list = []
        if ready is not None:
            try:
                checks = list(ready())
            except Exception as e:  # a probe must never raise a 500
                checks = [("ready", False, f"{type(e).__name__}: {e}")]
        ok = all(c[1] for c in checks)
        body = {"ready": ok, "service": server.service_name,
                "checks": [{"name": n, "ok": good, "detail": d}
                           for n, good, d in checks]}
        if ok:
            return body
        return Response(json.dumps(body).encode(), status=503,
                        content_type="application/json")

    server.add("GET", "/healthz", h_healthz)
    server.add("GET", "/readyz", h_readyz)
