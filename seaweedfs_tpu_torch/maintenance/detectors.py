"""Curator detectors: topology state -> maintenance job specs.

`snapshot()` flattens the leader's live Topology (under its lock) into
a plain dict; `scan()` is a pure function over that dict, so detector
behaviour is unit-testable with fabricated snapshots and the detector
pass itself never blocks on the topology lock or the network (the old
auto-vacuum synchronously called every volume server from the reap
loop — the curator only *reads heartbeat state* here and defers the
actual RPCs to the worker executing the job).

The port's own copy of seaweedfs_tpu/maintenance/detectors.py.
"""

from __future__ import annotations

import os
from typing import Optional

from ..storage.erasure_coding import TOTAL_SHARDS_COUNT
from .jobs import (TYPE_BALANCE, TYPE_DEEP_SCRUB, TYPE_EC_REBUILD,
                   TYPE_FIX_REPLICATION, TYPE_SCALE_DRAIN,
                   TYPE_SCALE_UP, TYPE_SHARD_MERGE, TYPE_SHARD_SPLIT,
                   TYPE_TIER_MOVE, TYPE_VACUUM)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def snapshot(topo) -> dict:
    """Flatten a master Topology into the dict `scan()` consumes."""
    volumes: dict[int, dict] = {}
    node_ec: dict[str, int] = {}
    node_volumes: dict[str, int] = {}
    nodes: list[dict] = []
    with topo.lock:
        for dc in topo.dcs.values():
            for rack in dc.racks.values():
                for node in rack.nodes.values():
                    node_ec[node.url] = sum(
                        b.count() for b in node.ec_shards.values())
                    node_volumes[node.url] = len(node.volumes)
                    tele = getattr(node, "telemetry", None) or {}
                    nodes.append({
                        "url": node.url,
                        "volumes": len(node.volumes),
                        "ec_shards": node_ec[node.url],
                        "occupancy": float(tele.get("occupancy", 0.0)),
                        "rps": float(tele.get("rps", 0.0)),
                        "mbps": float(tele.get("mbps", 0.0)),
                        "draining": bool(tele.get("draining", False)),
                        "free": max(0, node.max_volume_count
                                    - len(node.volumes)),
                    })
                    for v in node.volumes.values():
                        agg = volumes.setdefault(v.id, {
                            "id": v.id, "collection": v.collection,
                            "size": 0, "deleted_bytes": 0,
                            "replication": v.replica_placement,
                            "replicas": 0, "read_only": False})
                        agg["replicas"] += 1
                        agg["size"] = max(agg["size"], v.size)
                        agg["deleted_bytes"] = max(
                            agg["deleted_bytes"], v.deleted_byte_count)
                        agg["read_only"] = (agg["read_only"]
                                            or v.read_only)
        ec = [{"id": vid,
               "collection": topo.ec_collections.get(vid, ""),
               "shards": sorted(sid for sid, nodes in shard_map.items()
                                if nodes)}
              for vid, shard_map in topo.ec_shard_map.items()]
    return {"volumes": sorted(volumes.values(), key=lambda v: v["id"]),
            "ec": sorted(ec, key=lambda e: e["id"]),
            "node_ec_shards": node_ec,
            "node_volumes": node_volumes,
            "nodes": sorted(nodes, key=lambda n: n["url"])}


def scan(snap: dict, now: float, last_scrub: dict,
         garbage_threshold: float = 0.3,
         scrub_interval: Optional[float] = None,
         balance_skew: Optional[int] = None,
         vacuum_enabled: bool = True,
         scale_enabled: Optional[bool] = None,
         scale_up_occ: Optional[float] = None,
         scale_drain_occ: Optional[float] = None,
         scale_min_nodes: Optional[int] = None,
         alerts: Optional[list] = None) -> list[dict]:
    """All detectors over one snapshot -> job specs
    ({type, volume, collection, params}), urgent first."""
    if scrub_interval is None:
        scrub_interval = _env_float("WEED_MAINT_SCRUB_INTERVAL", 86400.0)
    if balance_skew is None:
        balance_skew = int(_env_float("WEED_MAINT_BALANCE_SKEW", 4))
    specs: list[dict] = []

    # missing-or-lost EC shards -> rebuild (most urgent: every missing
    # shard is erasure-budget already spent)
    for e in snap.get("ec", []):
        have = set(e["shards"])
        if have and len(have) < TOTAL_SHARDS_COUNT:
            missing = sorted(set(range(TOTAL_SHARDS_COUNT)) - have)
            specs.append({"type": TYPE_EC_REBUILD, "volume": e["id"],
                          "collection": e["collection"],
                          "params": {"missing": missing}})

    # replica count below placement -> one cluster-wide fix pass
    from ..storage.super_block import ReplicaPlacement

    under = []
    for v in snap.get("volumes", []):
        want = ReplicaPlacement.from_byte(v.get("replication", 0) or 0) \
            .copy_count()
        if v["replicas"] < want:
            under.append(v["id"])
    if under:
        specs.append({"type": TYPE_FIX_REPLICATION, "volume": 0,
                      "collection": "",
                      "params": {"volumes": sorted(under)}})

    # garbage ratio over threshold -> vacuum (replaces the master's
    # in-reap-loop auto-vacuum pass)
    if vacuum_enabled:
        for v in snap.get("volumes", []):
            size = v.get("size", 0)
            if size <= 0 or v.get("read_only"):
                continue
            ratio = v.get("deleted_bytes", 0) / float(size)
            if ratio > garbage_threshold:
                specs.append({"type": TYPE_VACUUM, "volume": v["id"],
                              "collection": v["collection"],
                              "params": {"garbage_ratio":
                                         round(ratio, 4)}})

    # stale scrub -> deep scrub (never-scrubbed volumes are due
    # immediately; the queue's dedupe + the pacer bound the sweep)
    for e in snap.get("ec", []):
        if len(e["shards"]) < TOTAL_SHARDS_COUNT:
            continue  # rebuild first; scrub after it converges
        if now - last_scrub.get(e["id"], 0.0) >= scrub_interval:
            specs.append({"type": TYPE_DEEP_SCRUB, "volume": e["id"],
                          "collection": e["collection"], "params": {}})

    # placement skew -> balance.  Both populations count: EC
    # shard-count spread AND plain-volume count spread (the original
    # detector only watched EC shards, so a cluster whose plain
    # volumes all landed on one server never rebalanced).
    kinds = []
    skew = 0
    ec_counts = list(snap.get("node_ec_shards", {}).values())
    if len(ec_counts) >= 2:
        ec_skew = max(ec_counts) - min(ec_counts)
        if ec_skew > balance_skew:
            kinds.append("ec")
            skew = max(skew, ec_skew)
    vol_counts = list(snap.get("node_volumes", {}).values())
    if len(vol_counts) >= 2:
        vol_skew = max(vol_counts) - min(vol_counts)
        if vol_skew > balance_skew:
            kinds.append("volume")
            skew = max(skew, vol_skew)
    if kinds:
        specs.append({"type": TYPE_BALANCE, "volume": 0,
                      "collection": "",
                      "params": {"skew": skew,
                                 "kinds": sorted(kinds)}})

    specs.extend(scan_scale(snap, scale_enabled=scale_enabled,
                            scale_up_occ=scale_up_occ,
                            scale_drain_occ=scale_drain_occ,
                            scale_min_nodes=scale_min_nodes,
                            alerts=alerts))
    return specs


def scan_scale(snap: dict, scale_enabled: Optional[bool] = None,
               scale_up_occ: Optional[float] = None,
               scale_drain_occ: Optional[float] = None,
               scale_min_nodes: Optional[int] = None,
               scale_up_rps: Optional[float] = None,
               scale_drain_rps: Optional[float] = None,
               alerts: Optional[list] = None,
               scale_on_alert: Optional[bool] = None) -> list[dict]:
    """Autoscaler detectors over per-node telemetry.

    Opt-in via WEED_SCALE=1 (capacity changes must never surprise a
    cluster that didn't ask for them).  Scale UP when either pressure
    signal trips fleet-wide: peak admission-gate occupancy above
    WEED_SCALE_UP_OCC (clients queueing), or mean per-node rps above
    WEED_SCALE_UP_RPS (0 disables the rps trigger).  Scale DOWN when
    every node idles below WEED_SCALE_DRAIN_OCC *and* mean rps is
    under WEED_SCALE_DRAIN_RPS, with spare nodes beyond
    WEED_SCALE_MIN_NODES -> drain the emptiest server (fewest
    volumes + shards, so the evacuation moves the least data)."""
    if scale_enabled is None:
        scale_enabled = os.environ.get("WEED_SCALE", "0") not in (
            "0", "", "false", "no")
    if not scale_enabled:
        return []
    if scale_up_occ is None:
        scale_up_occ = _env_float("WEED_SCALE_UP_OCC", 0.75)
    if scale_drain_occ is None:
        scale_drain_occ = _env_float("WEED_SCALE_DRAIN_OCC", 0.15)
    if scale_min_nodes is None:
        scale_min_nodes = int(_env_float("WEED_SCALE_MIN_NODES", 1))
    if scale_up_rps is None:
        scale_up_rps = _env_float("WEED_SCALE_UP_RPS", 0.0)
    if scale_drain_rps is None:
        scale_drain_rps = _env_float("WEED_SCALE_DRAIN_RPS", 1.0)
    if scale_on_alert is None:
        scale_on_alert = os.environ.get("WEED_SCALE_ON_ALERT", "0") \
            not in ("0", "", "false", "no")
    nodes = [n for n in snap.get("nodes", []) if not n["draining"]]
    if not nodes:
        return []
    # opt-in SLO trigger: a firing burn-rate alert (health plane) means
    # the error budget is being spent NOW — add capacity without
    # waiting for occupancy to cross its threshold
    if scale_on_alert and alerts:
        return [{"type": TYPE_SCALE_UP, "volume": 0, "collection": "",
                 "params": {"reason": "slo.alert",
                            "alerts": sorted(alerts),
                            "nodes": len(nodes)}}]
    occs = [n["occupancy"] for n in nodes]
    mean_occ = sum(occs) / len(occs)
    mean_rps = sum(n["rps"] for n in nodes) / len(nodes)
    if mean_occ > scale_up_occ \
            or (scale_up_rps > 0 and mean_rps > scale_up_rps):
        return [{"type": TYPE_SCALE_UP, "volume": 0, "collection": "",
                 "params": {"occupancy": round(mean_occ, 4),
                            "rps": round(mean_rps, 1),
                            "nodes": len(nodes)}}]
    if len(nodes) > scale_min_nodes and max(occs) < scale_drain_occ \
            and mean_rps < scale_drain_rps:
        victim = min(nodes, key=lambda n: (n["volumes"] + n["ec_shards"],
                                           n["url"]))
        return [{"type": TYPE_SCALE_DRAIN, "volume": 0,
                 "collection": "",
                 "params": {"server": victim["url"],
                            "occupancy": round(max(occs), 4),
                            "rps": round(mean_rps, 1)}}]
    return []


def heat_tier_enabled() -> bool:
    return os.environ.get("WEED_HEAT_TIER", "0") not in (
        "0", "", "false", "no")


def scan_temperature(snap: dict, usage: Optional[dict],
                     enabled: Optional[bool] = None,
                     cold_reads: Optional[float] = None,
                     max_hints: Optional[int] = None) -> list[dict]:
    """Heat-driven placement hints over the leader's merged usage view.

    Opt-in via WEED_HEAT_TIER=1 (placement advice must never surprise
    a cluster that didn't ask for it).  A volume whose decay-weighted
    read count in the fleet sketch sits below WEED_HEAT_TIER_COLD_READS
    while holding live data is *cold*: emit an advisory ``tier.move``
    spec pointing at storage/tier.py's remote backends.  The decayed
    sketch means a volume hot last week but idle now qualifies —
    exactly the temperature signal ROADMAP item 3's cold-tier work
    needs.  At most WEED_HEAT_TIER_MAX_HINTS hints per scan (coldest
    first) so a freshly-enabled detector cannot flood the queue."""
    if enabled is None:
        enabled = heat_tier_enabled()
    if not enabled or not usage:
        return []
    if cold_reads is None:
        cold_reads = _env_float("WEED_HEAT_TIER_COLD_READS", 1.0)
    if max_hints is None:
        max_hints = int(_env_float("WEED_HEAT_TIER_MAX_HINTS", 4))
    vol_reads = {str(k): float(v)
                 for k, v in (usage.get("volumes") or {}).items()}
    total_reads = float(usage.get("totals", {}).get("reads", 0) or 0)
    if total_reads <= 0:
        return []   # no traffic at all means no temperature signal
    cold = []
    for v in snap.get("volumes", []):
        if v.get("size", 0) <= 0:
            continue   # nothing to move
        reads = vol_reads.get(str(v["id"]), 0.0)
        if reads < cold_reads:
            cold.append((reads, v))
    cold.sort(key=lambda rv: (rv[0], rv[1]["id"]))
    return [{"type": TYPE_TIER_MOVE, "volume": v["id"],
             "collection": v["collection"],
             "params": {"reads": round(reads, 3),
                        "fleet_reads": round(total_reads, 1),
                        "advisory": True, "dest": "cold"}}
            for reads, v in cold[:max(0, max_hints)]]


def scan_shard_scale(shards: dict,
                     enabled: Optional[bool] = None,
                     split_per_holder: Optional[float] = None,
                     merge_per_holder: Optional[float] = None
                     ) -> list[dict]:
    """Filer shard-count elasticity over the replicated shard map.

    Opt-in via WEED_SHARD_SCALE=1.  `shards` is the curator's view:
    {"slots": N, "holders": active store servers, "resize": in-flight}.
    SPLIT when holders outgrow the slot space (fewer than
    WEED_SHARD_SPLIT_PER_HOLDER slots per holder means joiners sit
    idle) — to the smallest doubling that restores the floor.  MERGE
    one halving at a time when the space is far too fine
    (more than WEED_SHARD_MERGE_PER_HOLDER slots per holder), so a
    shrunk fleet stops paying per-slot lease/handover overhead.  The
    doubling/halving rule keeps old and new counts divisible, which is
    what makes holders' re-sharding purely local."""
    if enabled is None:
        enabled = os.environ.get("WEED_SHARD_SCALE", "0") not in (
            "0", "", "false", "no")
    if not enabled or shards.get("resize"):
        return []
    slots = int(shards.get("slots", 0))
    holders = int(shards.get("holders", 0))
    if slots <= 0 or holders <= 0:
        return []
    if split_per_holder is None:
        split_per_holder = _env_float("WEED_SHARD_SPLIT_PER_HOLDER", 1.0)
    if merge_per_holder is None:
        merge_per_holder = _env_float("WEED_SHARD_MERGE_PER_HOLDER",
                                      16.0)
    if split_per_holder > 0 and slots < holders * split_per_holder:
        to = slots
        while to < holders * split_per_holder:
            to *= 2
        return [{"type": TYPE_SHARD_SPLIT, "volume": 0, "collection": "",
                 "params": {"from": slots, "to": to,
                            "holders": holders}}]
    if merge_per_holder > 0 and slots % 2 == 0 \
            and slots > holders * merge_per_holder:
        return [{"type": TYPE_SHARD_MERGE, "volume": 0, "collection": "",
                 "params": {"from": slots, "to": slots // 2,
                            "holders": holders}}]
    return []
