"""Admin shell: volume.*, collection.*, cluster.*, lock/unlock commands.

Parity with weed/shell/command_volume_*.go, command_collection_*.go,
command_cluster_*.go, command_lock_unlock.go.  Every mutating command
supports plan-only mode (returns the intended operations without RPCs),
matching how the reference's tests pass applyBalancing=false
(shell/command_volume_balance_test.go, _fix_replication_test.go).

The port's own copy of seaweedfs_tpu/shell/commands_volume.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from ..rpc.http_rpc import RpcError, call, call_stream
from ..storage.super_block import ReplicaPlacement
from .commands import CommandEnv, needs_filer


@dataclass
class VolumeServerNode:
    """One volume server's view from the master topology."""

    url: str
    dc: str = ""
    rack: str = ""
    free: int = 0
    max: int = 0
    volumes: list[dict] = field(default_factory=list)

    def volume_ids(self) -> set[int]:
        return {v["id"] for v in self.volumes}


def collect_volume_servers(env: CommandEnv) -> list[VolumeServerNode]:
    topo = env.master("/dir/status")
    nodes = []
    for dc in topo.get("datacenters", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                nodes.append(VolumeServerNode(
                    url=n["url"], dc=n.get("dc", dc["id"]),
                    rack=n.get("rack", rack["id"]),
                    free=n.get("free", 0), max=n.get("max", 0),
                    volumes=n.get("volume_list", [])))
    return nodes


def _find_volume(nodes: list[VolumeServerNode],
                 vid: int) -> list[tuple[VolumeServerNode, dict]]:
    return [(n, v) for n in nodes for v in n.volumes if v["id"] == vid]


def is_good_move_by_placement(rp: ReplicaPlacement,
                              locations: list[tuple[str, str]]) -> bool:
    """Whether a replica set laid out at `locations` ((dc, rack) per
    replica) satisfies the replica placement — the gate the reference
    applies to every balance/evacuate move (command_volume_balance.go
    isGoodMoveByPlacement): the replicas must span exactly diff_dc+1
    data centers, no DC may use more than diff_rack+1 racks, and no rack
    may hold more than same_rack+1 replicas."""
    dcs: dict[str, set[str]] = {}
    rack_counts: dict[tuple[str, str], int] = {}
    for dc, rack in locations:
        dcs.setdefault(dc, set()).add(rack)
        rack_counts[(dc, rack)] = rack_counts.get((dc, rack), 0) + 1
    if len(dcs) != rp.diff_dc + 1:
        return False
    for racks in dcs.values():
        if len(racks) > rp.diff_rack + 1:
            return False
    return all(c <= rp.same_rack + 1 for c in rack_counts.values())


def _placement_allows_move(nodes: list[VolumeServerNode], vid: int,
                           source: VolumeServerNode,
                           target: VolumeServerNode) -> bool:
    """Placement check for moving one replica of vid source->target."""
    replicas = _find_volume(nodes, vid)
    if not replicas:
        return False
    rp = ReplicaPlacement.from_byte(replicas[0][1].get("replication", 0))
    after = [(n.dc, n.rack) for n, _ in replicas if n.url != source.url]
    after.append((target.dc, target.rack))
    return is_good_move_by_placement(rp, after)


# -- basic volume ops (command_volume_{mount,unmount,move,copy,delete}.go) ---

def volume_mount(env: CommandEnv, vid: int, server: str,
                 collection: str = "") -> dict:
    return call(server, "/admin/volume/mount",
                {"volume": vid, "collection": collection})


def volume_unmount(env: CommandEnv, vid: int, server: str) -> dict:
    return call(server, "/admin/volume/unmount", {"volume": vid})


def volume_delete(env: CommandEnv, vid: int, server: str,
                  collection: str = "") -> dict:
    return call(server, "/admin/delete_volume",
                {"volume": vid, "collection": collection})


def volume_mark(env: CommandEnv, vid: int, server: str,
                writable: bool) -> dict:
    """command_volume_mark.go: flip a replica readonly/writable."""
    return call(server, "/admin/readonly",
                {"volume": vid, "readonly": not writable})


def volume_copy(env: CommandEnv, vid: int, source: str, target: str,
                collection: str = "") -> dict:
    """command_volume_copy.go: replicate a volume onto target (keeps
    the source copy)."""
    return call(target, "/admin/volume/copy",
                {"volume": vid, "collection": collection,
                 "source": source}, timeout=600)


def volume_move(env: CommandEnv, vid: int, source: str, target: str,
                collection: str = "", plan_only: bool = False) -> dict:
    """command_volume_move.go: copy to target, then drop the source copy.
    The copy lands readonly-consistent because the .idx is fetched before
    the .dat (see _h_volume_copy); writes during the move land on the
    source and are lost only if they arrive between copy and delete —
    the reference marks the volume readonly first, so do the same."""
    plan = {"volume": vid, "source": source, "target": target,
            "steps": ["mark readonly on source", "copy to target",
                      "delete on source"]}
    if plan_only:
        return plan
    call(source, "/admin/readonly", {"volume": vid, "readonly": True})
    try:
        call(target, "/admin/volume/copy",
             {"volume": vid, "collection": collection, "source": source},
             timeout=600)
    except RpcError:
        # roll the source back to writable rather than stranding it
        call(source, "/admin/readonly", {"volume": vid, "readonly": False})
        raise
    call(source, "/admin/delete_volume",
         {"volume": vid, "collection": collection})
    plan["done"] = True
    return plan


# -- volume.balance (command_volume_balance.go) ------------------------------

def volume_balance(env: CommandEnv, collection: str = "ALL",
                   plan_only: bool = False) -> list[dict]:
    """Even out volume counts: move volumes from the fullest servers to
    the emptiest until every server is within one volume of the mean
    (the reference balances by ratio of used to max slots)."""
    nodes = collect_volume_servers(env)
    if not nodes:
        return []

    def eligible(v: dict) -> bool:
        return collection in ("ALL", v.get("collection", ""))

    counts = {n.url: sum(1 for v in n.volumes if eligible(v))
              for n in nodes}
    moves: list[dict] = []
    placed: dict[str, set[int]] = {n.url: n.volume_ids() for n in nodes}
    while True:
        fullest = max(nodes, key=lambda n: counts[n.url])
        emptiest = min(nodes, key=lambda n: counts[n.url])
        if counts[fullest.url] - counts[emptiest.url] <= 1:
            break
        candidates = [v for v in fullest.volumes
                      if eligible(v) and not v.get("read_only")
                      and v["id"] not in placed[emptiest.url]
                      and _placement_allows_move(nodes, v["id"],
                                                 fullest, emptiest)]
        if not candidates:
            break
        victim = min(candidates, key=lambda v: v["size"])
        moves.append({"volume": victim["id"],
                      "collection": victim.get("collection", ""),
                      "from": fullest.url, "to": emptiest.url})
        counts[fullest.url] -= 1
        counts[emptiest.url] += 1
        placed[emptiest.url].add(victim["id"])
        fullest.volumes = [v for v in fullest.volumes
                           if v["id"] != victim["id"]]
        emptiest.volumes.append(victim)  # keep placement checks current
    if not plan_only:
        for m in moves:
            volume_move(env, m["volume"], m["from"], m["to"],
                        collection=m["collection"])
    return moves


# -- volume.fix.replication (command_volume_fix_replication.go) --------------

def volume_fix_replication(env: CommandEnv,
                           plan_only: bool = False) -> list[dict]:
    """Repair replica counts: volumes with fewer replicas than their
    replica placement demands get copied to a server that lacks them
    (rack/dc-aware placement is approximated by preferring other racks);
    over-replicated volumes lose their newest extra copy."""
    nodes = collect_volume_servers(env)
    by_vid: dict[int, list[tuple[VolumeServerNode, dict]]] = {}
    for n in nodes:
        for v in n.volumes:
            by_vid.setdefault(v["id"], []).append((n, v))
    actions: list[dict] = []
    for vid, replicas in sorted(by_vid.items()):
        rp = ReplicaPlacement.from_byte(replicas[0][1]
                                        .get("replication", 0))
        want = rp.copy_count()
        have = len(replicas)
        if have < want:
            holders = {n.url for n, _ in replicas}
            holder_racks = {(n.dc, n.rack) for n, _ in replicas}
            spare = [n for n in nodes
                     if n.url not in holders and n.free > 0]
            # prefer racks that hold no replica yet (placement spirit)
            spare.sort(key=lambda n: ((n.dc, n.rack) in holder_racks,
                                      -n.free))
            for target in spare[:want - have]:
                actions.append({"action": "copy", "volume": vid,
                                "from": replicas[0][0].url,
                                "to": target.url,
                                "collection": replicas[0][1]
                                .get("collection", "")})
        elif have > want:
            for n, v in replicas[want:]:
                actions.append({"action": "delete", "volume": vid,
                                "from": n.url,
                                "collection": v.get("collection", "")})
    if not plan_only:
        for a in actions:
            if a["action"] == "copy":
                volume_copy(env, a["volume"], a["from"], a["to"],
                            collection=a["collection"])
            else:
                volume_delete(env, a["volume"], a["from"],
                              collection=a["collection"])
    return actions


# -- volume.delete_empty (command_volume_delete_empty.go) --------------------

def volume_delete_empty(env: CommandEnv, quiet_for: float = 3600.0,
                        plan_only: bool = False) -> list[dict]:
    """Delete volumes holding no live entries — but never an active write
    target: the volume must have been quiet for `quiet_for` seconds
    (reference -quietFor flag) and must not be in any layout's writable
    list (it could be handed out by /dir/assign right now)."""
    import time as _time

    topo = env.master("/dir/status")
    writable: set[int] = set()
    for layout in topo.get("layouts", []):
        writable.update(layout.get("writables", []))
    nodes = collect_volume_servers(env)
    targets = []
    for n in nodes:
        for v in n.volumes:
            if v.get("file_count", 0) - v.get("delete_count", 0) > 0:
                continue
            try:
                status = call(n.url,
                              f"/admin/volume/status?volume={v['id']}")
            except RpcError:
                continue
            last_append = status.get("last_append_at_ns", 0)
            if last_append == 0 and v["id"] in writable:
                # never-written writable volume: quiescence is unknowable
                # and /dir/assign may be handing out its fids right now
                continue
            if _time.time_ns() - last_append < quiet_for * 1e9:
                continue
            targets.append({"volume": v["id"], "from": n.url,
                            "collection": v.get("collection", "")})
    if not plan_only:
        for a in targets:
            volume_delete(env, a["volume"], a["from"],
                          collection=a["collection"])
    return targets


# -- volume.server.evacuate / .leave (command_volume_server_evacuate.go) -----

def volume_server_evacuate(env: CommandEnv, server: str,
                           plan_only: bool = False) -> list[dict]:
    """Move every volume off one server, spreading to the roomiest
    servers that don't already hold a replica."""
    nodes = collect_volume_servers(env)
    source = next((n for n in nodes if n.url == server), None)
    if source is None:
        raise RpcError(f"server {server} not in topology", 404)
    others = [n for n in nodes if n.url != server]
    holders: dict[int, set[str]] = {}
    for n in nodes:
        for v in n.volumes:
            holders.setdefault(v["id"], set()).add(n.url)
    moves = []
    load = {n.url: len(n.volumes) for n in others}
    for v in sorted(source.volumes, key=lambda v: -v["size"]):
        candidates = [n for n in others
                      if n.url not in holders.get(v["id"], set())
                      and _placement_allows_move(nodes, v["id"], source, n)]
        if not candidates:
            # placement-satisfying target preferred; fall back to any
            # non-holder so evacuation still drains the server
            candidates = [n for n in others
                          if n.url not in holders.get(v["id"], set())]
        if not candidates:
            moves.append({"volume": v["id"], "from": server,
                          "to": None, "error": "no free target"})
            continue
        target = min(candidates, key=lambda n: load[n.url])
        load[target.url] += 1
        moves.append({"volume": v["id"],
                      "collection": v.get("collection", ""),
                      "from": server, "to": target.url})
    if not plan_only:
        for m in moves:
            if m.get("to"):
                volume_move(env, m["volume"], m["from"], m["to"],
                            collection=m.get("collection", ""))
    return moves


def volume_server_leave(env: CommandEnv, server: str) -> dict:
    """command_volume_server_leave.go: ask a server to stop heartbeating
    so the master drops it from the topology."""
    return call(server, "/admin/leave", {})


def _stream_ndjson(url: str, path: str):
    """Iterate NDJSON records from a streaming endpoint without buffering
    the whole body (read_all streams chunked for billion-needle volumes)."""
    buf = b""
    for chunk in call_stream(url, path, timeout=600):
        buf += chunk
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            line, buf = buf[:nl], buf[nl + 1:]
            if line.strip():
                yield json.loads(line)
    if buf.strip():
        yield json.loads(buf)


# -- volume.check.disk (command_volume_check_disk.go) ------------------------

def volume_check_disk(env: CommandEnv,
                      plan_only: bool = False) -> list[dict]:
    """Compare replicas of each volume needle-by-needle (via the
    read_all NDJSON stream) and sync missing appends from the replica
    with newer data using the incremental-copy RPC."""
    nodes = collect_volume_servers(env)
    by_vid: dict[int, list[VolumeServerNode]] = {}
    for n in nodes:
        for v in n.volumes:
            by_vid.setdefault(v["id"], []).append(n)
    fixes = []
    for vid, holders in sorted(by_vid.items()):
        if len(holders) < 2:
            continue
        id_sets: dict[str, set[int]] = {}
        for n in holders:
            id_sets[n.url] = {
                rec["id"] for rec in _stream_ndjson(
                    n.url, f"/admin/volume/read_all?volume={vid}")}
        union: set[int] = set()
        for ids in id_sets.values():
            union |= ids
        for url, ids in id_sets.items():
            missing = union - ids
            if not missing:
                continue
            # donor: the OTHER replica holding the most of what this one
            # lacks (with cross-divergence no replica holds the union, so
            # each behind replica syncs from its best counterpart)
            donor = max((u for u in id_sets if u != url),
                        key=lambda u: len(id_sets[u] & missing))
            if not id_sets[donor] & missing:
                continue
            fixes.append({"volume": vid, "behind": url,
                          "missing": len(missing), "source": donor})
    if not plan_only:
        for f in fixes:
            call(f["behind"], "/admin/volume/sync",
                 {"volume": f["volume"], "source": f["source"]},
                 timeout=600)
    return fixes


# -- volume.fsck (command_volume_fsck.go) ------------------------------------

def volume_fsck(env: CommandEnv, filer_address: str = "",
                verbose: bool = False) -> dict:
    """Cross-check filer chunk references against volume contents:
    chunks pointing at missing needles are broken reads; needles no
    filer entry references are orphaned space (reference -findMissingChunksInFiler
    / default orphan mode).  Without a filer address it reports the
    stored needles; the cross-check raises until the filer is ported."""
    nodes = collect_volume_servers(env)
    stored: dict[int, set[int]] = {}
    for n in nodes:
        for v in n.volumes:
            ids = stored.setdefault(v["id"], set())
            for rec in _stream_ndjson(
                    n.url, f"/admin/volume/read_all?volume={v['id']}"):
                ids.add(rec["id"])
    report: dict = {"volumes": len(stored),
                    "stored_needles": sum(len(s) for s in stored.values())}
    if not filer_address:
        return report
    needs_filer("volume.fsck's filer cross-check")


# -- volume.configure.replication (command_volume_configure_replication.go) --

def volume_configure_replication(env: CommandEnv, vid: int,
                                 replication: str) -> list[dict]:
    """Rewrite the replica-placement byte in each replica's superblock."""
    rp = ReplicaPlacement.parse(replication)
    nodes = collect_volume_servers(env)
    out = []
    for n, v in _find_volume(nodes, vid):
        resp = call(n.url, "/admin/volume/configure_replication",
                    {"volume": vid, "replication": str(rp)})
        out.append({"url": n.url, **resp})
    if not out:
        raise RpcError(f"volume {vid} not found", 404)
    return out


# -- volume.tier.* (command_volume_tier_{upload,download,move}.go) -----------

def volume_tier_upload(env: CommandEnv, vid: int, server: str,
                       backend: str, bucket: str = "volumes",
                       keep_local: bool = False) -> dict:
    return call(server, "/admin/volume/tier_upload",
                {"volume": vid, "backend": backend, "bucket": bucket,
                 "keep_local": keep_local}, timeout=3600)


def volume_tier_download(env: CommandEnv, vid: int, server: str) -> dict:
    return call(server, "/admin/volume/tier_download", {"volume": vid},
                timeout=3600)


def volume_tier_move(env: CommandEnv, vid: int, backend: str,
                     bucket: str = "volumes",
                     plan_only: bool = False) -> list[dict]:
    """Tier every replica of the volume (the reference's tier.move picks
    volumes by age/size; explicit vid here, selection in the caller)."""
    nodes = collect_volume_servers(env)
    holders = _find_volume(nodes, vid)
    if not holders:
        raise RpcError(f"volume {vid} not found", 404)
    plan = [{"volume": vid, "server": n.url, "backend": backend}
            for n, _ in holders]
    if not plan_only:
        for p in plan:
            p.update(volume_tier_upload(env, vid, p["server"], backend,
                                        bucket=bucket))
    return plan


# -- collection.* (command_collection_{list,delete}.go) ----------------------

def collection_list(env: CommandEnv) -> list[str]:
    return env.master("/col/list").get("collections", [])


def collection_delete(env: CommandEnv, name: str,
                      plan_only: bool = False) -> list[dict]:
    if plan_only:
        nodes = collect_volume_servers(env)
        return [{"url": n.url, "volume": v["id"]}
                for n in nodes for v in n.volumes
                if v.get("collection", "") == name]
    return env.master("/col/delete", {"collection": name}).get("deleted", [])


# -- cluster.* (command_cluster_{check,ps,raft_*}.go) ------------------------

def cluster_ps(env: CommandEnv) -> dict:
    out = {"masters": [], "filers": [], "volume_servers": []}
    raft = env.master("/raft/status")
    for peer in raft.get("peers", []):
        role = "leader" if peer == raft.get("leader") else "follower"
        out["masters"].append({"address": peer, "role": role})
    filers = env.master("/cluster/nodes?type=filer")
    out["filers"] = filers.get("cluster_nodes", [])
    out["volume_servers"] = [
        {"address": n.url, "volumes": len(n.volumes), "free": n.free}
        for n in collect_volume_servers(env)]
    return out


def cluster_check(env: CommandEnv) -> list[str]:
    """Health sweep: every component reachable, raft has a leader,
    volumes have enough replicas."""
    problems = []
    try:
        raft = env.master("/raft/status")
        if not raft.get("leader"):
            problems.append("raft: no leader elected")
        # replication stragglers: a follower far behind the leader's
        # log is one failover away from forcing a long catch-up (or an
        # availability gap) — surface it before it matters
        for peer, f in (raft.get("followers") or {}).items():
            if f.get("lag", 0) > 16:
                problems.append(
                    f"raft: follower {peer} lags {f['lag']} entries "
                    f"(match_index {f.get('match_index', 0)} vs leader "
                    f"{raft.get('last_index', 0)})")
        applied_lag = (raft.get("last_index", 0)
                       - raft.get("applied_index", 0))
        if applied_lag > 64:
            problems.append(
                f"raft: {applied_lag} log entries not yet applied "
                "to the FSM")
    except RpcError as e:
        problems.append(f"master unreachable: {e}")
        return problems
    for n in collect_volume_servers(env):
        problems.extend(_probe_ready(n.url, "volume server"))
    for f in env.master("/cluster/nodes?type=filer") \
            .get("cluster_nodes", []):
        problems.extend(_probe_ready(f["address"], "filer"))
    # firing SLO burn-rate alerts from the leader's health plane
    try:
        for a in env.master("/cluster/alerts").get("alerts", []):
            problems.append(
                f"slo: alert {a['rule']} firing "
                f"(burn fast={a['burn_fast']} slow={a['burn_slow']})")
    except RpcError:
        pass  # pre-health-plane master
    under = [a for a in volume_fix_replication(env, plan_only=True)
             if a["action"] == "copy"]
    for a in under:
        problems.append(f"volume {a['volume']} under-replicated")
    return problems


def _probe_ready(address: str, what: str) -> list[str]:
    """Liveness (/healthz) then readiness (/readyz) of one daemon;
    a 503 readyz reports the individual failing checks."""
    problems = []
    try:
        call(address, "/healthz", timeout=5)
    except RpcError as e:
        return [f"{what} {address} unreachable: {e}"]
    try:
        call(address, "/readyz", timeout=5)
    except RpcError as e:
        detail = ""
        try:
            import json as _json

            body = _json.loads(str(e))
            detail = ", ".join(
                f"{c['name']}: {c['detail']}"
                for c in body.get("checks", []) if not c["ok"])
        except Exception:
            pass
        problems.append(f"{what} {address} not ready"
                        + (f" ({detail})" if detail else f": {e}"))
    return problems


def cluster_health(env: CommandEnv) -> dict:
    """The leader health plane's single JSON rollup."""
    return env.master("/cluster/health")


def cluster_raft_ps(env: CommandEnv) -> dict:
    return env.master("/raft/status")


def cluster_raft_add(env: CommandEnv, address: str) -> dict:
    return env.master("/raft/add_peer", {"address": address})


def cluster_raft_remove(env: CommandEnv, address: str) -> dict:
    return env.master("/raft/remove_peer", {"address": address})


# -- filer shard split / merge (online slot-count evolution) -----------------

def filer_shards_status(env: CommandEnv) -> dict:
    return env.master("/filer/shards")


def filer_shards_split(env: CommandEnv, to: int) -> dict:
    """Grow the filer metadata slot count online (two-phase: holders
    re-shard locally + dual-write, then the map flips atomically)."""
    return env.master("/filer/shard_resize",
                      {"op": "start", "to": int(to)})


def filer_shards_merge(env: CommandEnv, to: int) -> dict:
    """Shrink the slot count online; same two-phase handover."""
    return env.master("/filer/shard_resize",
                      {"op": "start", "to": int(to)})


# -- lock / unlock (command_lock_unlock.go, LeaseAdminToken) -----------------

def shell_lock(env: CommandEnv, client: str = "shell") -> dict:
    resp = env.master("/admin/lock", {
        "name": "admin", "client": client,
        "token": getattr(env, "admin_token", 0) or 0})
    env.admin_token = resp.get("token", 0)
    return resp


def shell_unlock(env: CommandEnv) -> dict:
    resp = env.master("/admin/unlock", {
        "name": "admin", "token": getattr(env, "admin_token", 0) or 0})
    env.admin_token = 0
    return resp
