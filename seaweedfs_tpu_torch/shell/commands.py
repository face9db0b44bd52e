"""Admin shell commands: the cluster orchestration layer.

Parity with weed/shell/command_ec_*.go and command_volume_*.go: ec.encode's
6-step flow (mark readonly -> generate on source -> spread shards by free
slots -> mount on targets -> cleanup source -> delete original volume;
command_ec_encode.go:95-192), ec.decode's collect-to-one-server flow,
ec.rebuild's roomiest-node rebuild, and ec.balance's spread.  Every command
supports plan-only mode (no RPCs) the way the reference's tests pass
applyBalancing=false (shell/command_ec_test.go).

The port's own copy of seaweedfs_tpu/shell/commands.py.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..rpc.http_rpc import RpcError, call
from ..storage.erasure_coding import TOTAL_SHARDS_COUNT

# shared fan-out pool for holder-parallel commands (ec.scrub): sized for
# I/O-bound RPC waits, lazily built so import stays thread-free
_fanout_pool: Optional[cf.ThreadPoolExecutor] = None
_fanout_lock = threading.Lock()


def _fanout() -> cf.ThreadPoolExecutor:
    global _fanout_pool
    with _fanout_lock:
        if _fanout_pool is None:
            _fanout_pool = cf.ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="shell-fanout")
        return _fanout_pool


@dataclass
class CommandEnv:
    master_address: str
    filer_address: str = ""  # discovered lazily via the cluster registry
    admin_token: int = 0  # LeaseAdminToken lease for lock/unlock
    cwd: str = "/"  # fs.cd working directory for relative fs.* paths

    def master(self, path: str, payload=None, **kw):
        return call(self.master_address, path, payload, **kw)


@dataclass
class EcNode:
    url: str
    free_slots: int
    dc: str = ""
    rack: str = ""
    shards: dict[int, list[int]] = field(default_factory=dict)  # vid -> ids
    collections: dict[int, str] = field(default_factory=dict)  # vid -> name

    def shard_count(self) -> int:
        return sum(len(s) for s in self.shards.values())

    def rack_key(self) -> tuple[str, str]:
        return (self.dc, self.rack)


def collect_ec_nodes(env: CommandEnv) -> list[EcNode]:
    """Build the EC-capable node list from the master's topology view."""
    topo = env.master("/dir/status")
    nodes = []
    for dc in topo.get("datacenters", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                nodes.append(EcNode(url=n["url"], free_slots=n["free"],
                                    dc=n.get("dc", dc["id"]),
                                    rack=n.get("rack", rack["id"])))
    # fill current shard placements
    for vid in topo.get("ec_volumes", []):
        try:
            lookup = env.master(f"/ec/lookup?volumeId={vid}")
        except RpcError:
            continue
        collection = lookup.get("collection", "")
        for entry in lookup.get("shard_id_locations", []):
            for loc in entry["locations"]:
                for node in nodes:
                    if node.url == loc["url"]:
                        node.shards.setdefault(vid, []).append(
                            entry["shard_id"])
                        node.collections[vid] = collection
    return nodes


def balanced_ec_distribution(nodes: list[EcNode],
                             shard_count: int = TOTAL_SHARDS_COUNT
                             ) -> dict[str, list[int]]:
    """Rack-first shard spread: racks are filled round-robin (so a rack
    failure loses at most ceil(shards/racks) <= 4 of 14 shards whenever
    more than three racks exist), and within a rack shards round-robin
    over the nodes with free EC slots.  Combines balancedEcDistribution
    (command_ec_encode.go:253-269) with the rack-spreading objective of
    ec.balance (command_ec_balance.go:27-100) at placement time instead
    of fixing rack clustering after the fact.  Slot budget = free volume
    slots in shard units."""
    import random

    if not nodes:
        raise ValueError("no ec nodes available")
    allocation: dict[str, list[int]] = {n.url: [] for n in nodes}
    free = {n.url: n.free_slots * TOTAL_SHARDS_COUNT for n in nodes}

    racks: dict[tuple[str, str], list[EcNode]] = {}
    for n in nodes:
        racks.setdefault(n.rack_key(), []).append(n)
    rack_keys = list(racks.keys())
    random.shuffle(rack_keys)
    rack_node_index = {rk: random.randrange(len(racks[rk]))
                       for rk in rack_keys}

    def rack_has_free(rk) -> bool:
        return any(free[n.url] - len(allocation[n.url]) > 0
                   for n in racks[rk])

    shard_id = 0
    rack_index = 0
    spins = 0
    while shard_id < shard_count:
        rk = rack_keys[rack_index % len(rack_keys)]
        rack_index += 1
        if not rack_has_free(rk):
            spins += 1
            if spins > len(rack_keys):
                raise ValueError("not enough free ec slots")
            continue
        spins = 0
        # round-robin inside the rack, skipping slotless nodes
        rnodes = racks[rk]
        for _ in range(len(rnodes)):
            node = rnodes[rack_node_index[rk] % len(rnodes)]
            rack_node_index[rk] += 1
            if free[node.url] - len(allocation[node.url]) > 0:
                allocation[node.url].append(shard_id)
                shard_id += 1
                break
    return {url: ids for url, ids in allocation.items() if ids}


# -- ec.encode ---------------------------------------------------------------


def collect_volume_ids_for_ec_encode(env: CommandEnv, collection: str = "",
                                     full_percent: float = 95.0,
                                     quiet_seconds: float = 3600.0,
                                     now: Optional[float] = None
                                     ) -> list[int]:
    """Auto-EC candidate selection (collectVolumeIdsForEcEncode,
    command_ec_encode.go:271-302): volumes at least full_percent% of the
    master's volume size limit AND unmodified for quiet_seconds.  The
    reference keys on fullness + quiescence only; readonly volumes stay
    eligible (they encode fine)."""
    import time as _time

    topo = env.master("/dir/status")
    size_limit = topo.get("volume_size_limit", 0)
    if not size_limit:
        return []
    threshold = size_limit * full_percent / 100.0
    now = _time.time() if now is None else now
    vids: set[int] = set()
    for dc in topo.get("datacenters", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                for v in n.get("volume_list", []):
                    # exact-match selection, reference semantics
                    # (command_ec_encode.go:288): "" selects only the
                    # default (unnamed) collection, never a wildcard
                    if v.get("collection", "") != collection:
                        continue
                    if v.get("size", 0) < threshold:
                        continue
                    modified = v.get("modified_at", 0)
                    if modified and now - modified < quiet_seconds:
                        continue
                    vids.add(v["id"])
    return sorted(vids)


def ec_encode_auto(env: CommandEnv, collection: str = "",
                   full_percent: float = 95.0,
                   quiet_seconds: float = 3600.0,
                   plan_only: bool = False,
                   now: Optional[float] = None) -> list[dict]:
    """ec.encode -fullPercent=X -quietFor=Y: select full+quiet volumes
    from the topology and encode each (command_ec_encode.go:57-93)."""
    vids = collect_volume_ids_for_ec_encode(
        env, collection, full_percent, quiet_seconds, now=now)
    return [ec_encode(env, vid, collection, plan_only=plan_only)
            for vid in vids]


def _collection_ec_code(env: CommandEnv, collection: str) -> str:
    """The ``ec_code`` of the filer path-config rule that targets this
    collection (fs.configure -ecCode), "" when no filer / no rule.  The
    env-var overrides still win — the volume server's policy resolution
    (codes.family_for_collection) checks them first."""
    try:
        from ..filer.filer_conf import FILER_CONF_PATH
        from .commands_fs import _get_json_config, find_filer
        conf = _get_json_config(find_filer(env), FILER_CONF_PATH)
    except Exception:  # no filer in this deployment, or conf unreadable
        return ""
    for loc in conf.get("locations", []):
        if loc.get("collection", "") == collection and loc.get("ec_code"):
            return loc["ec_code"]
    return ""


def ec_encode(env: CommandEnv, vid: int, collection: str = "",
              plan_only: bool = False) -> dict:
    lookup = env.master(f"/dir/lookup?volumeId={vid}")
    locations = [loc["url"] for loc in lookup["locations"]]
    if not locations:
        raise RpcError(f"volume {vid} has no locations", 404)
    source = locations[0]
    nodes = collect_ec_nodes(env)
    allocation = balanced_ec_distribution(nodes)
    plan = {
        "volume": vid,
        "source": source,
        "replicas": locations,
        "allocation": allocation,
    }
    if plan_only:
        return plan

    # 1. freeze writes on every replica
    for url in locations:
        call(url, "/admin/readonly", {"volume": vid, "readonly": True})
    # 2. generate the 14 shard files + .ecx on the source (TPU encode);
    # the filer's per-collection ec_code rule rides along so the volume
    # server's policy resolution sees the path-config layer too
    payload: dict = {"volume": vid}
    ec_code = _collection_ec_code(env, collection)
    if ec_code:
        payload["code_family"] = ec_code
    call(source, "/admin/ec/generate", payload, timeout=3600)
    # 3/4. spread + mount
    for url, shard_ids in allocation.items():
        if url != source:
            call(url, "/admin/ec/copy",
                 {"volume": vid, "collection": collection,
                  "shard_ids": shard_ids, "source": source,
                  "copy_ecx_file": True}, timeout=3600)
        call(url, "/admin/ec/mount",
             {"volume": vid, "collection": collection,
              "shard_ids": shard_ids})
    # 5. cleanup: remove shard files that left the source
    source_kept = allocation.get(source, [])
    to_remove = [s for s in range(TOTAL_SHARDS_COUNT)
                 if s not in source_kept]
    if to_remove:
        call(source, "/admin/ec/delete_shards",
             {"volume": vid, "collection": collection,
              "shard_ids": to_remove})
    # 6. drop the original volume from every replica
    for url in locations:
        call(url, "/admin/delete_volume", {"volume": vid})
    return plan


# -- ec.decode ---------------------------------------------------------------


def ec_decode(env: CommandEnv, vid: int, collection: str = "",
              plan_only: bool = False) -> dict:
    lookup = env.master(f"/ec/lookup?volumeId={vid}")
    shard_locations = {
        e["shard_id"]: [loc["url"] for loc in e["locations"]]
        for e in lookup.get("shard_id_locations", [])
    }
    if not shard_locations:
        raise RpcError(f"ec volume {vid} not found", 404)
    # collect to the server already holding the most shards
    counts: dict[str, int] = {}
    for urls in shard_locations.values():
        for url in urls:
            counts[url] = counts.get(url, 0) + 1
    target = max(counts, key=counts.get)
    missing = [sid for sid, urls in shard_locations.items()
               if target not in urls]
    plan = {"volume": vid, "target": target, "copy_shards": missing}
    if plan_only:
        return plan

    for sid in missing:
        source = shard_locations[sid][0]
        call(target, "/admin/ec/copy",
             {"volume": vid, "collection": collection, "shard_ids": [sid],
              "source": source, "copy_ecx_file": False}, timeout=3600)
    call(target, "/admin/ec/to_volume",
         {"volume": vid, "collection": collection}, timeout=3600)
    # remove shards everywhere
    for url in set(u for urls in shard_locations.values() for u in urls):
        all_ids = [sid for sid, urls in shard_locations.items()
                   if url in urls]
        ids = all_ids if url != target else list(range(TOTAL_SHARDS_COUNT))
        if ids:
            try:
                call(url, "/admin/ec/delete_shards",
                     {"volume": vid, "collection": collection,
                      "shard_ids": ids})
            except RpcError:
                pass
    return plan


# -- ec.rebuild --------------------------------------------------------------


def _volume_family_info(vid: int, shard_locations: dict[int, list[str]]
                        ) -> dict:
    """Ask any shard holder which code family the volume was encoded with
    (served from its .vif record via /admin/ec/codes).  Holders predating
    the coding tier, or unreachable ones, fall back to the RS default so
    mixed clusters keep rebuilding the way they always did."""
    fallback = {"family": "rs_vandermonde",
                "data_shards": TOTAL_SHARDS_COUNT - 4, "repair_helpers": 0}
    holders = sorted({u for urls in shard_locations.values() for u in urls})
    for url in holders:
        try:
            info = call(url, f"/admin/ec/codes?volume={vid}")
        except (RpcError, OSError):
            continue
        vol = (info.get("volumes") or {}).get(str(vid))
        if not vol:
            continue
        fam = (info.get("families") or {}).get(vol.get("family", ""), {})
        return {"family": vol.get("family", fallback["family"]),
                "data_shards": fam.get("data_shards",
                                       fallback["data_shards"]),
                "repair_helpers": fam.get("repair_helpers", 0)}
    return fallback


def ec_rebuild(env: CommandEnv, vid: int, collection: str = "",
               plan_only: bool = False) -> dict:
    lookup = env.master(f"/ec/lookup?volumeId={vid}")
    shard_locations = {
        e["shard_id"]: [loc["url"] for loc in e["locations"]]
        for e in lookup.get("shard_id_locations", [])
    }
    present = sorted(shard_locations)
    missing = [s for s in range(TOTAL_SHARDS_COUNT) if s not in present]
    if not missing:
        return {"volume": vid, "missing": [], "rebuilder": None}
    fam = _volume_family_info(vid, shard_locations)
    # repairability bound is the family's, not RS's: any MDS family decodes
    # from data_shards survivors (pm_msr tolerates 9 losses, not 4)
    if len(present) < fam["data_shards"]:
        raise RpcError(
            f"ec volume {vid} has only {len(present)} shards "
            f"({fam['family']} needs {fam['data_shards']}), unrepairable",
            500)
    nodes = collect_ec_nodes(env)
    rebuilder = max(nodes, key=lambda n: n.free_slots)
    plan = {"volume": vid, "missing": missing, "rebuilder": rebuilder.url,
            "family": fam["family"], "mode": "copy_decode"}
    if plan_only:
        if (fam["repair_helpers"] and len(missing) == 1
                and len(present) >= fam["repair_helpers"]):
            plan["mode"] = "projection"
        return plan

    local = rebuilder.shards.get(vid, [])
    if (fam["repair_helpers"] and len(missing) == 1
            and len(present) >= fam["repair_helpers"]):
        # repair-optimal path: helpers stream sub-shard projections, the
        # rebuilder combines them — d/alpha of the lost bytes on the wire
        # instead of data_shards full shards
        try:
            if not local:
                # sidecars (.ecx/.vif) needed to mount + CRC-check the result
                call(rebuilder.url, "/admin/ec/copy",
                     {"volume": vid, "collection": collection,
                      "shard_ids": [], "source": shard_locations[present[0]][0],
                      "copy_ecx_file": True}, timeout=3600)
            sources = [{"shard_id": sid, "url": shard_locations[sid][0]}
                       for sid in present]
            reply = call(rebuilder.url, "/admin/ec/rebuild_projected",
                         {"volume": vid, "collection": collection,
                          "shard": missing[0], "sources": sources},
                         timeout=3600)
            call(rebuilder.url, "/admin/ec/mount",
                 {"volume": vid, "collection": collection,
                  "shard_ids": missing})
            plan.update(mode="projection",
                        read_bytes=reply.get("read_bytes"),
                        read_amp=reply.get("read_amp"))
            return plan
        except (RpcError, OSError):
            pass  # older holders / transient failure: full copy-decode below

    # gather surviving shards on the rebuilder
    for sid in present:
        if sid in local:
            continue
        source = shard_locations[sid][0]
        if source == rebuilder.url:
            continue
        call(rebuilder.url, "/admin/ec/copy",
             {"volume": vid, "collection": collection, "shard_ids": [sid],
              "source": source, "copy_ecx_file": True}, timeout=3600)
    call(rebuilder.url, "/admin/ec/rebuild",
         {"volume": vid, "collection": collection}, timeout=3600)
    call(rebuilder.url, "/admin/ec/mount",
         {"volume": vid, "collection": collection, "shard_ids": missing})
    # drop the temporarily copied survivors from the rebuilder's disk
    copied = [s for s in present
              if s not in local and s not in missing]
    if copied:
        call(rebuilder.url, "/admin/ec/delete_shards",
             {"volume": vid, "collection": collection,
              "shard_ids": copied})
    return plan


# -- ec.codes ----------------------------------------------------------------


def ec_codes(env: CommandEnv, vid: Optional[int] = None) -> dict:
    """Cluster view of the coding tier: registered families plus the
    family each mounted EC volume was encoded with, fanned over every
    volume server's /admin/ec/codes."""
    topo = env.master("/dir/status")
    urls = sorted({n["url"]
                   for dc in topo.get("datacenters", [])
                   for rack in dc.get("racks", [])
                   for n in rack.get("nodes", [])})
    path = "/admin/ec/codes" + (f"?volume={vid}" if vid is not None else "")
    futs = {url: _fanout().submit(call, url, path, timeout=30)
            for url in urls}
    report: dict = {"families": {}, "default_family": None,
                    "volumes": {}, "rebuild_read_amp": {}, "errors": []}
    for url in sorted(futs):
        try:
            r = futs[url].result()
        except (RpcError, OSError) as e:
            report["errors"].append({"node": url, "error": str(e)})
            continue
        report["families"].update(r.get("families", {}))
        report["default_family"] = (report["default_family"]
                                    or r.get("default_family"))
        for v, meta in (r.get("volumes") or {}).items():
            entry = report["volumes"].setdefault(
                v, {**meta, "shards": [], "holders": {}})
            entry["holders"][url] = sorted(meta.get("shards", []))
            entry["shards"] = sorted(
                set(entry["shards"]) | set(meta.get("shards", [])))
        if r.get("rebuild_read_amp"):
            # per-node snapshots: rebuild counters live on the rebuilder
            report["rebuild_read_amp"][url] = r["rebuild_read_amp"]
    if not report["errors"]:
        del report["errors"]
    return report


# -- ec.balance --------------------------------------------------------------


def _move_shard(moves: list[dict], source: EcNode, target: EcNode,
                vid: int, sid: int):
    source.shards[vid].remove(sid)
    if not source.shards[vid]:
        del source.shards[vid]
    target.shards.setdefault(vid, []).append(sid)
    target.collections.setdefault(vid, source.collections.get(vid, ""))
    moves.append({"volume": vid, "shard": sid,
                  "collection": source.collections.get(vid, ""),
                  "from": source.url, "to": target.url})


def _shard_slot_budget(nodes: list[EcNode]) -> dict[str, int]:
    """Free EC capacity per node in shard units (free volume slots x 14)."""
    return {n.url: n.free_slots * TOTAL_SHARDS_COUNT for n in nodes}


def _balance_racks(nodes: list[EcNode], moves: list[dict],
                   budget: dict[str, int]):
    """Phase 1 (doBalanceEcShardsAcrossRacks, command_ec_balance.go:27-63):
    per volume, no rack may hold more than ceil(shards/racks) shards —
    a rack failure must never take out more than one parity group's worth.
    Every pick is gated on remaining shard-slot budget (the reference's
    freeEcSlot > 0 gate in pickRackToBalanceShardsInto)."""
    racks: dict[tuple, list[EcNode]] = {}
    for n in nodes:
        racks.setdefault(n.rack_key(), []).append(n)
    if len(racks) <= 1:
        return
    vids = sorted({vid for n in nodes for vid in n.shards})
    for vid in vids:
        shards_per_rack = {
            rk: [(n, sid) for n in rnodes for sid in n.shards.get(vid, [])]
            for rk, rnodes in racks.items()}
        total = sum(len(v) for v in shards_per_rack.values())
        cap = -(-total // len(racks))  # ceil
        for rk, holders in sorted(shards_per_rack.items(),
                                  key=lambda kv: -len(kv[1])):
            while len(holders) > cap:
                node, sid = holders.pop()
                # a node may hold several distinct shard ids of one volume
                # (only the rack cap is a hard constraint); never duplicate
                # the same shard id on a node, never overfill a node
                candidates = [
                    (rk2, n2) for rk2, rnodes2 in racks.items()
                    if len(shards_per_rack[rk2]) < cap
                    for n2 in rnodes2
                    if budget[n2.url] > 0
                    and sid not in n2.shards.get(vid, [])]
                if not candidates:
                    break
                rk2, target = min(
                    candidates,
                    key=lambda c: (len(shards_per_rack[c[0]]),
                                   -budget[c[1].url]))
                _move_shard(moves, node, target, vid, sid)
                budget[target.url] -= 1
                budget[node.url] += 1
                shards_per_rack[rk2].append((target, sid))


def _balance_nodes(nodes: list[EcNode], moves: list[dict],
                   budget: dict[str, int]):
    """Phase 2 (doBalanceEcShardsWithinRacks + AcrossRacks node step):
    within each rack, even shard counts over nodes, never co-locating a
    volume's shards on one node, never overfilling a node."""
    racks: dict[tuple, list[EcNode]] = {}
    for n in nodes:
        racks.setdefault(n.rack_key(), []).append(n)
    for rnodes in racks.values():
        total = sum(n.shard_count() for n in rnodes)
        average = -(-total // len(rnodes))  # ceil
        overfull = [n for n in rnodes if n.shard_count() > average]
        for node in overfull:
            while node.shard_count() > average:
                vid, ids = max(node.shards.items(),
                               key=lambda kv: len(kv[1]))
                candidates = [n for n in rnodes if n is not node
                              and n.shard_count() < average
                              and budget[n.url] > 0
                              and vid not in n.shards]
                if not candidates:
                    break
                target = max(candidates, key=lambda n: budget[n.url])
                _move_shard(moves, node, target, vid, ids[-1])
                budget[target.url] -= 1
                budget[node.url] += 1


def ec_balance(env: CommandEnv, plan_only: bool = False) -> list[dict]:
    """Even out shard placement (command_ec_balance.go:27-100): first
    spread each volume's shards across racks (no rack over
    ceil(shards/racks)), then even node counts within each rack, never
    co-locating a volume's shards on one node."""
    nodes = collect_ec_nodes(env)
    if not nodes:
        return []
    moves: list[dict] = []
    budget = _shard_slot_budget(nodes)
    _balance_racks(nodes, moves, budget)
    _balance_nodes(nodes, moves, budget)
    if plan_only:
        return moves
    for move in moves:
        call(move["to"], "/admin/ec/copy",
             {"volume": move["volume"], "collection": move["collection"],
              "shard_ids": [move["shard"]],
              "source": move["from"], "copy_ecx_file": True}, timeout=3600)
        call(move["to"], "/admin/ec/mount",
             {"volume": move["volume"], "collection": move["collection"],
              "shard_ids": [move["shard"]]})
        call(move["from"], "/admin/ec/delete_shards",
             {"volume": move["volume"], "collection": move["collection"],
              "shard_ids": [move["shard"]]})
    return moves


def ec_evacuate(env: CommandEnv, server: str,
                plan_only: bool = False) -> list[dict]:
    """Move every EC shard off `server` (the shard half of a graceful
    drain; command_volume_server_evacuate.go's EC branch).  Targets are
    picked emptiest-first under the same never-duplicate-a-shard-id /
    slot-budget constraints as ec.balance."""
    nodes = collect_ec_nodes(env)
    source = next((n for n in nodes if n.url == server), None)
    if source is None or not source.shards:
        return []
    peers = [n for n in nodes if n.url != server]
    if not peers:
        raise RpcError(f"no peers to evacuate {server} onto", 409)
    budget = _shard_slot_budget(peers)
    moves: list[dict] = []
    for vid in sorted(source.shards):
        for sid in sorted(source.shards[vid]):
            candidates = [n for n in peers
                          if budget[n.url] > 0
                          and sid not in n.shards.get(vid, [])]
            if not candidates:
                raise RpcError(
                    f"no capacity to evacuate shard {vid}.{sid} "
                    f"off {server}", 507)
            target = min(candidates,
                         key=lambda n: (n.shard_count(), -budget[n.url],
                                        n.url))
            _move_shard(moves, source, target, vid, sid)
            budget[target.url] -= 1
    if plan_only:
        return moves
    for move in moves:
        call(move["to"], "/admin/ec/copy",
             {"volume": move["volume"], "collection": move["collection"],
              "shard_ids": [move["shard"]],
              "source": move["from"], "copy_ecx_file": True}, timeout=3600)
        call(move["to"], "/admin/ec/mount",
             {"volume": move["volume"], "collection": move["collection"],
              "shard_ids": [move["shard"]]})
        call(move["from"], "/admin/ec/delete_shards",
             {"volume": move["volume"], "collection": move["collection"],
              "shard_ids": [move["shard"]]})
    return moves


# -- ec.scrub ----------------------------------------------------------------


def ec_scrub(env: CommandEnv, vid: Optional[int] = None,
             repair: bool = False, plan_only: bool = False) -> list[dict]:
    """Cluster-wide EC integrity sweep: every shard holder verifies its
    local shards against the fused-encode CRC record (.vif); corrupt
    shards are deleted and rebuilt from survivors with -repair.  No
    reference analogue — the reference stores no shard checksums."""
    topo = env.master("/dir/status")
    vids = ([vid] if vid is not None
            else sorted(topo.get("ec_volumes", [])))
    reports = []
    for v in vids:
        try:
            lookup = env.master(f"/ec/lookup?volumeId={v}")
        except RpcError:
            continue
        collection = lookup.get("collection", "")
        holders = {loc["url"]
                   for e in lookup.get("shard_id_locations", [])
                   for loc in e["locations"]}
        corrupt: list[tuple[str, int]] = []
        errors: list[dict] = []
        clean_union: set[int] = set()
        # every holder walks its own disks — fan the scrub RPCs out in
        # parallel instead of serializing 600s-budget calls per holder
        futs = {url: _fanout().submit(
                    call, url, "/admin/ec/scrub",
                    {"volume": v, "collection": collection}, timeout=600)
                for url in sorted(holders)}
        for url in sorted(futs):
            try:
                r = futs[url].result()
            except (RpcError, OSError) as e:
                errors.append({"holder": url, "error": str(e)})
                continue
            clean_union.update(r.get("clean", []))
            corrupt.extend((url, sid) for sid in r.get("corrupt", []))
        # a shard corrupt on one holder but clean elsewhere is covered;
        # missing = no intact copy anywhere AND no corrupt copy either
        seen = clean_union | {sid for _, sid in corrupt}
        missing = sorted(set(range(TOTAL_SHARDS_COUNT)) - seen)
        report = {"volume": v, "clean_shards": len(clean_union),
                  "corrupt": [{"holder": u, "shard": s}
                              for u, s in corrupt
                              if s not in clean_union],
                  "missing": missing}
        if errors:
            report["errors"] = errors
        degraded = report["corrupt"] or missing
        if degraded and repair and not plan_only:
            # rebuild needs the volume's family's data_shards intact
            # copies (10 for RS/Cauchy, 5 for pm_msr)
            shard_locations = {
                e["shard_id"]: [loc["url"] for loc in e["locations"]]
                for e in lookup.get("shard_id_locations", [])}
            need = _volume_family_info(v, shard_locations)["data_shards"]
            if len(clean_union) < need:
                report["rebuild_error"] = (
                    f"only {len(clean_union)} clean shards — corrupt "
                    "copies left in place for manual recovery")
            else:
                for url, sid in corrupt:
                    call(url, "/admin/ec/delete_shards",
                         {"volume": v, "collection": collection,
                          "shard_ids": [sid]})
                try:
                    report["rebuild"] = ec_rebuild(env, v, collection)
                except RpcError as e:
                    report["rebuild_error"] = str(e)
        reports.append(report)
    return reports


# -- volume.* ----------------------------------------------------------------


def volume_list(env: CommandEnv) -> dict:
    return env.master("/dir/status")


def volume_vacuum(env: CommandEnv,
                  garbage_threshold: Optional[float] = None) -> dict:
    path = "/vol/vacuum"
    if garbage_threshold is not None:
        path += f"?garbageThreshold={garbage_threshold}"
    return env.master(path, {})


def volume_query(env: CommandEnv, file_ids: list[str],
                 selections: Optional[list[str]] = None, field: str = "",
                 op: str = "", value: str = "",
                 csv: bool = False) -> list[dict]:
    """SELECT over stored objects: route each fid to a server holding its
    volume and run the /query RPC there (volume_grpc_query.go)."""
    by_url: dict[str, list[str]] = {}
    for fid in file_ids:
        vid = fid.split(",")[0]
        found = env.master(f"/dir/lookup?volumeId={vid}")
        locations = found.get("locations", [])
        if not locations:
            raise RpcError(f"volume {vid} not found", 404)
        by_url.setdefault(locations[0]["url"], []).append(fid)
    records: list[dict] = []
    for url, fids in by_url.items():
        resp = call(url, "/query", {
            "from_file_ids": fids,
            "selections": selections or [],
            "filter": {"field": field, "operand": op, "value": value},
            "input_serialization": {"csv": {}} if csv else {"json": {}},
        })
        records.extend(resp.get("records", []))
    return records
