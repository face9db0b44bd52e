"""Shell commands for the cluster QoS subsystem.

``qos.status`` fans ``GET /debug/qos`` out to every live daemon —
master, every volume server in the topology, and every filer / s3
gateway in the cluster registry — and returns one merged view plus a
small cluster-wide rollup (total shed / queued / in-flight per class).

The port's own copy of seaweedfs_tpu/shell/commands_qos.py.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..rpc.http_rpc import RpcError, call
from .commands import CommandEnv


def _discover(env: CommandEnv) -> dict:
    """{display_name: address} for every reachable daemon."""
    targets = {f"master {env.master_address}": env.master_address}
    topo = env.master("/dir/status")
    for dc in topo.get("datacenters", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                targets[f"volume {n['url']}"] = n["url"]
    for kind in ("filer", "s3"):
        try:
            nodes = env.master(f"/cluster/nodes?type={kind}")
        except (RpcError, OSError):
            continue
        for n in nodes.get("cluster_nodes", []):
            targets[f"{kind} {n['address']}"] = n["address"]
    return targets


def qos_status(env: CommandEnv) -> dict:
    targets = _discover(env)

    def fetch(addr: str):
        return call(addr, "/debug/qos", timeout=10)

    daemons: dict = {}
    failed: list = []
    with ThreadPoolExecutor(max_workers=max(4, len(targets))) as pool:
        futs = {name: pool.submit(fetch, addr)
                for name, addr in targets.items()}
        for name, fut in futs.items():
            try:
                daemons[name] = fut.result()
            except (RpcError, OSError) as e:
                failed.append(f"{name}: {e}")

    rollup = {"inflight": {}, "queued": {}, "shed": {}, "admitted": {}}
    lanes_totals = {"preemptions": 0, "background_wait_seconds": 0.0}
    for snap in daemons.values():
        gate = snap.get("gate") or {}
        for field in rollup:
            for cls, n in (gate.get(field) or {}).items():
                rollup[field][cls] = rollup[field].get(cls, 0) + n
        lanes = snap.get("lanes") or {}
        lanes_totals["preemptions"] += lanes.get("preemptions", 0)
        lanes_totals["background_wait_seconds"] += lanes.get(
            "background_wait_seconds", 0.0)
    lanes_totals["background_wait_seconds"] = round(
        lanes_totals["background_wait_seconds"], 3)
    return {"daemons": daemons, "rollup": rollup,
            "lanes": lanes_totals, "unreachable": failed}
