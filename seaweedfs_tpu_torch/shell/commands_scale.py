"""cluster.scale: elasticity status + manual scale job triggers.

The status view joins the curator's autoscale knobs with the per-node
load telemetry the detectors consume (occupancy / rps / draining from
each volume server's last heartbeat), so an operator sees exactly what
the autoscaler sees.  The up/drain verbs enqueue the same raft-
replicated scale.up / scale.drain jobs the detectors would.

The port's own copy of seaweedfs_tpu/shell/commands_scale.py.
"""

from __future__ import annotations

from ..maintenance.jobs import TYPE_SCALE_DRAIN, TYPE_SCALE_UP
from .commands import CommandEnv


def scale_status(env: CommandEnv) -> dict:
    """Autoscaler view: knobs, queue, and per-node telemetry."""
    maint = env.master("/maintenance/status")
    topo = env.master("/dir/status")
    nodes = [{"url": n["url"], "volumes": n["volumes"],
              "ec_shards": n.get("ecShards", 0),
              "occupancy": n.get("occupancy", 0.0),
              "rps": n.get("rps", 0.0),
              "draining": n.get("draining", False)}
             for dc in topo.get("datacenters", [])
             for rack in dc.get("racks", [])
             for n in rack.get("nodes", [])]
    scale_jobs = [j for j in env.master("/maintenance/queue")
                  .get("jobs", [])
                  if j.get("type") in (TYPE_SCALE_UP, TYPE_SCALE_DRAIN)]
    return {"autoscale": maint.get("autoscale", {}),
            "nodes": sorted(nodes, key=lambda n: n["url"]),
            "scale_jobs": scale_jobs}


def scale_up(env: CommandEnv) -> dict:
    """Enqueue a manual scale.up (grow the cluster by one server)."""
    return env.master("/maintenance/run",
                      {"type": TYPE_SCALE_UP,
                       "params": {"from": "shell"}})


def scale_drain(env: CommandEnv, server: str) -> dict:
    """Enqueue a graceful drain of `server` (read-only demotion ->
    paced evacuation -> deregistration)."""
    if not server:
        raise ValueError("cluster.scale -drain needs a server address")
    return env.master("/maintenance/run",
                      {"type": TYPE_SCALE_DRAIN,
                       "params": {"server": server, "from": "shell"}})
