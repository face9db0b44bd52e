"""weed — the port's command line: `python -m seaweedfs_tpu_torch <cmd>`.

The port's own counterpart of the repo's `weed.py`, with the same
subcommands, flags and meanings for every daemon and tool whose modules
are ported: master, master.follower, volume, server (master + volume),
shell, maintenance, top, lint-dashboards, profile, the offline volume
tools (backup, compact, fix, scrub, export), version and autocomplete.
The commands that need the filer or the gateways are listed in
`NOT_PORTED_COMMANDS` and exit non-zero naming ROADMAP item 9.

One flag is the port's own: `-device` on the commands that do EC work
(volume, server, scrub).  Empty (the default) means the CUDA card;
`-device cpu` runs the kernels' plain PyTorch versions on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from .rpc.http_rpc import RpcError, call

VERSION = "seaweedfs_tpu_torch 0.1 (RS(10,4) EC on CUDA via PyTorch)"

# subcommands of the JAX package's weed.py that wait for the filer and
# the gateways (ROADMAP item 9)
NOT_PORTED_COMMANDS = frozenset({
    "filer", "filer.store", "s3", "iam", "benchmark", "upload",
    "download", "filer.copy", "filer.cat", "filer.sync", "filer.backup",
    "filer.replicate", "filer.meta.backup", "filer.remote.sync",
    "filer.remote.gateway", "filer.meta.tail", "scaffold"})

_ITEM_9 = "the filer and the gateways are not ported yet (ROADMAP item 9)"


def _completion_script(subcommands) -> str:
    """Bash completion for the weed CLI (command/autocomplete.go)."""
    words = " ".join(subcommands)
    return f"""# bash completion for weed — `source <(python -m seaweedfs_tpu_torch autocomplete)`
_weed_complete() {{
    local cur="${{COMP_WORDS[COMP_CWORD]}}"
    if [ "$COMP_CWORD" -eq 1 ]; then
        COMPREPLY=( $(compgen -W "{words}" -- "$cur") )
    else
        COMPREPLY=( $(compgen -f -- "$cur") )
    fi
}}
complete -F _weed_complete weed weed.py"""


def _wait_forever(stoppables):
    from .util import grace

    # graceful shutdown via the grace hooks (also dumps any active
    # -cpuprofile/-memprofile on the way out)
    grace.on_interrupt(lambda: _stop_all(stoppables))
    signal.pause()


def _stop_all(stoppables):
    for s in reversed(stoppables):
        try:
            s.stop()
        except Exception:
            pass


def _load_guard():
    """Build a security Guard from security.toml (weed/security/guard.go)."""
    from .security import Guard
    from .util.config import load_configuration

    conf = load_configuration("security")
    return Guard(
        white_list=[w for w in
                    str(conf.get("access.ui", "") or "").split(",") if w],
        signing_key=str(conf.get("jwt.signing.key", "") or ""),
        expires_after_seconds=conf.get_int(
            "jwt.signing.expires_after_seconds", 10),
        read_signing_key=str(conf.get("jwt.signing.read.key", "") or ""),
        read_expires_after_seconds=conf.get_int(
            "jwt.signing.read.expires_after_seconds", 60))


def cmd_master(args):
    from .master.server import MasterServer

    # -peers wins; WEED_MASTER_PEERS covers fleet-managed deployments
    # where every master gets the same env
    peer_spec = args.peers or os.environ.get("WEED_MASTER_PEERS", "")
    peers = [p for p in peer_spec.split(",") if p]
    m = MasterServer(host=args.ip, port=args.port,
                     volume_size_limit_mb=args.volumeSizeLimitMB,
                     default_replication=args.defaultReplication,
                     pulse_seconds=args.pulseSeconds,
                     guard=_load_guard(),
                     peers=peers, raft_dir=args.mdir,
                     enable_native_assign=args.tcp,
                     join=args.join)
    m.start()
    mode = " (joining as learner)" if args.join else ""
    print(f"master listening on {m.address}{mode}" +
          (f", raft peers {m.raft.peers}" if peers else ""), flush=True)
    _wait_forever([m])


def cmd_master_follower(args):
    from .master.follower import MasterFollower

    f = MasterFollower(args.masters.split(","), host=args.ip, port=args.port)
    f.start()
    print(f"master follower on {f.address} tracking {args.masters}",
          flush=True)
    _wait_forever([f])


def _parse_tier_backends(specs):
    """-tier name=local:/dir or name=s3:endpoint[,accessKey,secretKey]"""
    from .remote_storage import RemoteConf

    confs = []
    for spec in specs or []:
        name, _, rest = spec.partition("=")
        kind, _, params = rest.partition(":")
        if kind == "local":
            confs.append(RemoteConf(name=name, type="local",
                                    directory=params))
        elif kind == "s3":
            parts = params.split(",")
            confs.append(RemoteConf(
                name=name, type="s3", endpoint=parts[0],
                access_key=parts[1] if len(parts) > 1 else "",
                secret_key=parts[2] if len(parts) > 2 else ""))
        else:
            raise ValueError(f"bad tier spec {spec!r}")
    return confs


def cmd_volume(args):
    from .volume_server.server import VolumeServer

    dirs = args.dir.split(",")
    maxes = [int(x) for x in args.max.split(",")] if args.max else None
    if maxes and len(maxes) == 1:
        maxes = maxes * len(dirs)
    vs = VolumeServer(dirs, args.mserver, host=args.ip, port=args.port,
                      rack=args.rack, data_center=args.dataCenter,
                      max_volume_counts=maxes,
                      pulse_seconds=args.pulseSeconds,
                      guard=_load_guard(),
                      tier_backends=_parse_tier_backends(args.tier),
                      enable_tcp=args.tcp, read_mode=args.readMode,
                      fsync=args.fsync, needle_map_kind=args.index,
                      ec_encoder_backend=args.ecBackend or None,
                      upload_limit_mb=args.concurrentUploadLimitMB,
                      download_limit_mb=args.concurrentDownloadLimitMB,
                      device=args.device or None)
    vs.start()
    print(f"volume server listening on {vs.address}, dirs={dirs}",
          flush=True)
    _wait_forever([vs])


def cmd_server(args):
    """Combined master + volume in one process (weed/command/server.go).
    The filer, S3 and IAM parts wait for ROADMAP item 9."""
    from .master.server import MasterServer
    from .volume_server.server import VolumeServer

    if args.filer or args.s3 or args.iam:
        print(f"error: -filer/-s3/-iam: {_ITEM_9}", file=sys.stderr)
        sys.exit(2)
    stoppables = []
    guard = _load_guard()
    master = MasterServer(host=args.ip, port=args.masterPort,
                          volume_size_limit_mb=args.volumeSizeLimitMB,
                          pulse_seconds=args.pulseSeconds, guard=guard,
                          enable_native_assign=args.tcp)
    master.start()
    stoppables.append(master)
    print(f"master on {master.address}", flush=True)

    dirs = args.dir.split(",")
    vs = VolumeServer(dirs, master.address, host=args.ip,
                      port=args.volumePort, rack=args.rack,
                      pulse_seconds=args.pulseSeconds, guard=guard,
                      enable_tcp=args.tcp, device=args.device or None)
    vs.start()
    vs.heartbeat_once()
    stoppables.append(vs)
    print(f"volume server on {vs.address}", flush=True)
    _wait_forever(stoppables)


def _shell_handlers(env):
    """The admin command registry (weed/shell/commands.go) over the
    ported commands; the fs.*, remote.* and s3.* families need the
    filer and raise NotImplementedError naming ROADMAP item 9."""
    from .shell import commands as sh
    from .shell import commands_maintenance as mnt
    from .shell import commands_qos as qos_cmds
    from .shell import commands_scale as scale
    from .shell import commands_volume as vol

    def show(value):
        print(json.dumps(value, indent=2, default=str), flush=True)

    def flag(a, name, default=None):
        for item in a:
            if item.startswith(f"-{name}="):
                return item.split("=", 1)[1]
        return default

    def filer_waits(name):
        return lambda a: sh.needs_filer(name)

    plan = lambda a: "-plan" in a or "-n" in a
    handlers = {
        # volume family
        "volume.list": lambda a: show(sh.volume_list(env)),
        "volume.vacuum": lambda a: show(sh.volume_vacuum(
            env, float(a[0]) if a else None)),
        "volume.balance": lambda a: show(vol.volume_balance(
            env, collection=flag(a, "collection", "ALL"),
            plan_only=plan(a))),
        "volume.move": lambda a: show(vol.volume_move(
            env, int(a[0]), a[1], a[2], plan_only=plan(a))),
        "volume.copy": lambda a: show(vol.volume_copy(
            env, int(a[0]), a[1], a[2])),
        "volume.delete": lambda a: show(vol.volume_delete(
            env, int(a[0]), a[1])),
        "volume.delete_empty": lambda a: show(vol.volume_delete_empty(
            env, plan_only=plan(a))),
        "volume.mount": lambda a: show(vol.volume_mount(
            env, int(a[0]), a[1])),
        "volume.unmount": lambda a: show(vol.volume_unmount(
            env, int(a[0]), a[1])),
        "volume.mark": lambda a: show(vol.volume_mark(
            env, int(a[0]), a[1], writable="-writable" in a)),
        "volume.fix.replication": lambda a: show(
            vol.volume_fix_replication(env, plan_only=plan(a))),
        "volume.check.disk": lambda a: show(vol.volume_check_disk(
            env, plan_only=plan(a))),
        "volume.fsck": lambda a: show(vol.volume_fsck(
            env, filer_address=flag(a, "filer", ""),
            verbose="-v" in a)),
        "volume.configure.replication": lambda a: show(
            vol.volume_configure_replication(
                env, int(a[0]), flag(a, "replication", "000"))),
        "volume.server.evacuate": lambda a: show(
            vol.volume_server_evacuate(env, a[0], plan_only=plan(a))),
        "volume.server.leave": lambda a: show(
            vol.volume_server_leave(env, a[0])),
        "volume.tier.upload": lambda a: show(vol.volume_tier_upload(
            env, int(a[0]), a[1], flag(a, "backend", "default"),
            bucket=flag(a, "bucket", "volumes"),
            keep_local="-keepLocal" in a)),
        "volume.tier.download": lambda a: show(vol.volume_tier_download(
            env, int(a[0]), a[1])),
        "volume.tier.move": lambda a: show(vol.volume_tier_move(
            env, int(a[0]), flag(a, "backend", "default"),
            bucket=flag(a, "bucket", "volumes"), plan_only=plan(a))),
        "volume.query": lambda a: show(sh.volume_query(
            env, [a[0]],
            selections=(flag(a, "select", "") or "").split(",")
            if flag(a, "select") else None,
            field=flag(a, "field", ""), op=flag(a, "op", ""),
            value=flag(a, "value", ""), csv="-csv" in a)),
        # ec family — ec.encode takes an explicit volume id, or selects
        # full+quiet volumes with -fullPercent/-quietFor (seconds), the
        # reference's auto-EC trigger (command_ec_encode.go:271-302)
        "ec.encode": lambda a: show(
            (lambda vids: sh.ec_encode(
                env, int(vids[0]), collection=flag(a, "collection", ""),
                plan_only=plan(a))
             if vids else
             sh.ec_encode_auto(
                env, collection=flag(a, "collection", ""),
                full_percent=float(flag(a, "fullPercent", "95")),
                quiet_seconds=float(flag(a, "quietFor", "3600")),
                plan_only=plan(a)))(
            [x for x in a if not x.startswith("-")])),
        "ec.decode": lambda a: show(sh.ec_decode(
            env, int(a[0]), plan_only=plan(a))),
        "ec.rebuild": lambda a: show(sh.ec_rebuild(
            env, int(a[0]), plan_only=plan(a))),
        "ec.balance": lambda a: show(sh.ec_balance(
            env, plan_only=plan(a))),
        "ec.scrub": lambda a: show(sh.ec_scrub(
            env,
            vid=(lambda v: int(v[0]) if v else None)(
                [x for x in a if not x.startswith("-")]),
            repair="-repair" in a, plan_only=plan(a))),
        # coding-tier inventory: registered code families plus the family
        # each mounted EC volume was encoded with
        "ec.codes": lambda a: show(sh.ec_codes(
            env,
            vid=(lambda v: int(v[0]) if v else None)(
                [x for x in a if not x.startswith("-")]))),
        # maintenance family — curator status/queue on the master
        "maintenance.status": lambda a: show(mnt.maintenance_status(env)),
        "maintenance.queue": lambda a: show(mnt.maintenance_queue(env)),
        "maintenance.pause": lambda a: show(mnt.maintenance_pause(
            env, paused="-resume" not in a)),
        "maintenance.run": lambda a: show(mnt.maintenance_run(
            env, job_type=flag(a, "type"),
            volume=int(flag(a, "volume", "0") or 0),
            collection=flag(a, "collection", ""))),
        # qos — cluster-wide /debug/qos rollup
        "qos.status": lambda a: show(qos_cmds.qos_status(env)),
        # collection / cluster
        "collection.list": lambda a: show(vol.collection_list(env)),
        "collection.delete": lambda a: show(vol.collection_delete(
            env, a[0], plan_only=plan(a))),
        # elasticity — autoscaler status + manual scale.up / scale.drain
        "cluster.scale": lambda a: show(
            scale.scale_up(env) if "-up" in a
            else scale.scale_drain(env, flag(a, "drain", ""))
            if flag(a, "drain") else scale.scale_status(env)),
        "cluster.ps": lambda a: show(vol.cluster_ps(env)),
        "cluster.check": lambda a: show(vol.cluster_check(env)),
        "cluster.health": lambda a: show(vol.cluster_health(env)),
        "cluster.raft.ps": lambda a: show(vol.cluster_raft_ps(env)),
        "raft.status": lambda a: show(vol.cluster_raft_ps(env)),
        "cluster.raft.add": lambda a: show(vol.cluster_raft_add(
            env, a[0])),
        "cluster.raft.remove": lambda a: show(vol.cluster_raft_remove(
            env, a[0])),
        "filer.shards": lambda a: show(vol.filer_shards_status(env)),
        "filer.shards.split": lambda a: show(vol.filer_shards_split(
            env, int(a[0]))),
        "filer.shards.merge": lambda a: show(vol.filer_shards_merge(
            env, int(a[0]))),
        "lock": lambda a: show(vol.shell_lock(env)),
        "unlock": lambda a: show(vol.shell_unlock(env)),
    }
    for name in FILER_SHELL_COMMANDS:
        handlers[name] = filer_waits(name)
    return handlers


# the shell commands of the JAX package's fs, remote and s3 families:
# each needs the filer (ROADMAP item 9)
FILER_SHELL_COMMANDS = (
    "fs.ls", "fs.cat", "fs.mkdir", "fs.rm", "fs.mv", "fs.du", "fs.tree",
    "fs.cd", "fs.pwd", "fs.meta.cat", "fs.meta.save", "fs.meta.load",
    "fs.meta.notify", "fs.configure", "remote.configure", "remote.mount",
    "remote.unmount", "remote.meta.sync", "remote.cache",
    "remote.uncache", "remote.mount.buckets", "s3.bucket.list",
    "s3.bucket.create", "s3.bucket.delete", "s3.clean.uploads",
    "s3.configure", "s3.bucket.quota", "s3.bucket.quota.enforce",
    "s3.circuitbreaker")


def cmd_shell(args):
    from .shell import commands as sh

    env = sh.CommandEnv(args.master, filer_address=args.filer)
    handlers = _shell_handlers(env)

    def run_line(line: str) -> bool:
        if line in (".exit", "exit", "quit"):
            return False
        if line in (".help", "help"):
            print("commands:", ", ".join(sorted(handlers)))
            return True
        name, *rest = line.split()
        fn = handlers.get(name)
        if fn is None:
            print(f"unknown command {name!r}; .help lists commands")
            return True
        try:
            fn(rest)
        except (RpcError, ValueError, IndexError,
                NotImplementedError) as e:
            print(f"error: {e}", flush=True)
        return True

    if args.c:
        for line in args.c.split(";"):
            if line.strip() and not run_line(line.strip()):
                return
        return
    print(f"connected to master {args.master}; .help for commands")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            return
        if line and not run_line(line):
            return


def cmd_backup(args):
    """Keep a local, incrementally-updated copy of one volume
    (weed/command/backup.go): first run fetches .dat/.idx wholesale,
    later runs tail only the new appends."""
    from .storage import volume_backup
    from .storage.volume import Volume

    found = call(args.master, f"/dir/lookup?volumeId={args.volumeId}")
    locations = found.get("locations", [])
    if not locations:
        print(f"error: volume {args.volumeId} not found")
        sys.exit(1)
    source = locations[0]["url"]
    os.makedirs(args.dir, exist_ok=True)
    name = (f"{args.collection}_{args.volumeId}" if args.collection
            else str(args.volumeId))
    dat_path = os.path.join(args.dir, name + ".dat")
    if not os.path.exists(dat_path):
        for ext in (".idx", ".dat"):
            blob = call(source,
                        f"/admin/ec/shard_file?volume={args.volumeId}"
                        f"&collection={args.collection}&ext={ext}",
                        timeout=3600)
            with open(os.path.join(args.dir, name + ext), "wb") as f:
                f.write(blob if isinstance(blob, bytes) else b"")
        print(f"full copy of volume {args.volumeId} from {source}")
        return
    v = Volume(args.dir, args.collection, args.volumeId)
    try:
        applied = volume_backup.incremental_backup(
            v, lambda since: _fetch_tail(source, args.volumeId, since))
        print(f"applied {applied} new records from {source}")
    finally:
        v.close()


def _fetch_tail(source: str, vid: int, since_ns: int) -> bytes:
    data = call(source,
                f"/admin/volume/tail?volume={vid}&since_ns={since_ns}",
                timeout=600)
    return data if isinstance(data, (bytes, bytearray)) else b""


def cmd_compact(args):
    """Offline vacuum of a volume directory (weed/command/compact.go)."""
    from .storage.tools import compact_offline

    print(json.dumps(compact_offline(args.dir, args.collection,
                                     args.volumeId)))


def cmd_fix(args):
    """Rebuild the .idx from the .dat (weed/command/fix.go)."""
    from .storage.tools import rebuild_index

    count = rebuild_index(args.dir, args.collection, args.volumeId)
    print(f"rebuilt index from {count} records")


def cmd_scrub(args):
    """Verify local EC shards against the fused-CRC record in .vif; with
    -repair, regenerate corrupt/missing shards from survivors on the
    `-device`."""
    from .storage.tools import scrub_ec_volume

    report = scrub_ec_volume(args.dir, args.collection, args.volumeId,
                             repair=args.repair, device=args.device or None)
    print(json.dumps(report, indent=2))
    if (report["corrupt"] or report["missing"]) and not args.repair:
        raise SystemExit(1)  # degraded redundancy is not healthy


def cmd_export(args):
    """Export a volume's live needles (weed/command/export.go)."""
    from .storage.tools import export_volume

    records = export_volume(args.dir, args.collection, args.volumeId,
                            output_tar=args.o,
                            newer_than_ts=args.newer or 0.0)
    for r in records:
        print(json.dumps(r))
    if args.o:
        print(f"wrote {len(records)} files to {args.o}",
              file=sys.stderr)


def cmd_profile(args):
    """Cluster flamegraph: fan /debug/pprof/profile out to every live
    daemon (master topology + cluster membership discovery), merge the
    folded stacks under per-daemon root frames, print/write collapsed-
    stack text ready for flamegraph.pl or speedscope."""
    from concurrent.futures import ThreadPoolExecutor

    from . import profiling

    master = args.master
    targets: dict[str, str] = {f"master {master}": master}
    try:
        topo = call(master, "/dir/status")
    except (RpcError, OSError) as e:
        print(f"error: master {master} unreachable: {e}")
        sys.exit(1)
    for dc in topo.get("datacenters", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                targets[f"volume {n['url']}"] = n["url"]
    for kind in ("filer", "s3"):
        try:
            nodes = call(master, f"/cluster/nodes?type={kind}")
        except (RpcError, OSError):
            continue
        for n in nodes.get("cluster_nodes", []):
            targets[f"{kind} {n['address']}"] = n["address"]

    seconds, hz = args.seconds, args.hz
    path = f"/debug/pprof/profile?seconds={seconds}&hz={hz}"

    def fetch(addr: str):
        return call(addr, path, parse=False, timeout=seconds + 30.0)

    profiles: dict[str, str] = {}
    failed: list[str] = []
    with ThreadPoolExecutor(max_workers=max(4, len(targets))) as pool:
        futures = {name: pool.submit(fetch, addr)
                   for name, addr in targets.items()}
        for name, fut in futures.items():
            try:
                profiles[name.replace(";", ":")] = \
                    fut.result().decode("utf-8", "replace")
            except (RpcError, OSError) as e:
                failed.append(f"{name}: {e}")

    merged = profiling.merge_folded(profiles)
    header = (f"# cluster cpu profile: {len(profiles)}/{len(targets)} "
              f"daemons, {seconds}s @ {hz}Hz\n")
    for f in failed:
        header += f"# unreachable: {f}\n"
    if args.o:
        with open(args.o, "w") as f:
            f.write(header + merged)
        print(f"wrote {args.o} ({len(merged.splitlines())} stacks from "
              f"{len(profiles)} daemons)")
    else:
        print(header + merged, end="")
    if not profiles:
        sys.exit(1)


def cmd_maintenance(args):
    """One-shot curator control from the command line: status/queue
    dumps, pause/resume, or force a detector pass / explicit job —
    the same /maintenance/* surface the shell commands use."""
    from .shell import commands_maintenance as mnt
    from .shell.commands import CommandEnv

    env = CommandEnv(args.master)
    try:
        if args.action == "status":
            out = mnt.maintenance_status(env)
        elif args.action == "queue":
            out = mnt.maintenance_queue(env)
        elif args.action == "pause":
            out = mnt.maintenance_pause(env, paused=True)
        elif args.action == "resume":
            out = mnt.maintenance_pause(env, paused=False)
        else:  # run
            out = mnt.maintenance_run(
                env, job_type=args.type or None, volume=args.volume,
                collection=args.collection)
    except (RpcError, OSError) as e:
        print(f"error: master {args.master} unreachable: {e}")
        sys.exit(1)
    print(json.dumps(out, indent=2, default=str))


def _render_top(h, master):
    """One frame of `weed top` from the /cluster/health rollup."""
    lines = [f"cluster {h.get('status', '?').upper():10s}  "
             f"leader {h.get('leader') or '?'}  "
             f"(via {master}, scrape "
             f"{h.get('scrape', {}).get('interval_ms', 0):.0f}ms, "
             f"duty {h.get('scrape', {}).get('duty', 0):.4f})", ""]
    lines.append(f"{'NODE':28s} {'KIND':8s} {'UP':3s} READY")
    for addr, n in sorted(h.get("nodes", {}).items()):
        ready = "-"
        if n.get("up"):
            try:
                call(addr, "/readyz", timeout=2)
                ready = "yes"
            except (RpcError, OSError):
                ready = "NO"
        lines.append(f"{addr:28s} {n.get('kind', '?'):8s} "
                     f"{'up' if n.get('up') else 'DOWN':3s} {ready}")
    lines.append("")
    lines.append(f"{'SLO RULE':20s} {'BURN 5m':>8s} {'BURN 1h':>8s} "
                 f"{'P99 ms':>8s} STATE")
    for name, a in sorted(h.get("slo", {}).items()):
        p99 = a.get("detail", {}).get("p99_ms")
        lines.append(
            f"{name:20s} {a.get('burn_fast', 0):8.2f} "
            f"{a.get('burn_slow', 0):8.2f} "
            f"{p99 if p99 is not None else '-':>8} "
            f"{'FIRING' if a.get('firing') else 'ok'}")
    events = h.get("events", [])[-8:]
    if events:
        lines.append("")
        lines.append("RECENT EVENTS")
        for e in events:
            lines.append(f"  {e['ts']:.1f} {e['kind']:16s} "
                         f"{e.get('service', ''):8s} {e.get('node', '')}")
    return lines


def _render_usage(u):
    """Workload-analytics frame of `weed top`: the hot-key / tenant
    rollup from GET /cluster/usage (decayed sketch merge, so the
    numbers are recent-traffic weighted, not lifetime totals)."""
    lines = []
    t = u.get("totals", {})
    lines.append(
        f"workload (last epochs, decayed): "
        f"{t.get('reads', 0):.0f} reads / {t.get('writes', 0):.0f} writes, "
        f"{t.get('bytes_read', 0) / 1e6:.1f}MB out / "
        f"{t.get('bytes_written', 0) / 1e6:.1f}MB in, "
        f"~{t.get('distinct_keys', 0)} distinct keys "
        f"({len(u.get('nodes', []))} reporting daemons)")
    top = u.get("top_keys", [])
    if top:
        lines.append("")
        lines.append(f"{'HOT KEY':40s} {'READS':>9s} {'SHARE':>7s}")
        for e in top[:10]:
            lines.append(f"{e.get('fid', '?'):40s} "
                         f"{e.get('reads', 0):9.0f} "
                         f"{e.get('share', 0) * 100:6.1f}%")
    tenants = u.get("tenants", {})
    if tenants:
        # ops/bytes come per-op from the usage view; the terminal view
        # wants one scalar per tenant
        def total(e, field):
            return sum((e.get(field) or {}).values())

        lines.append("")
        lines.append(f"{'TENANT':24s} {'OPS':>9s} {'BYTES':>12s} "
                     f"{'~KEYS':>7s}")
        ranked = sorted(tenants.items(),
                        key=lambda kv: (-total(kv[1], "bytes"), kv[0]))
        for name, e in ranked[:10]:
            lines.append(f"{name or '(none)':24s} "
                         f"{total(e, 'ops'):9.0f} "
                         f"{total(e, 'bytes'):12.0f} "
                         f"{e.get('distinct_keys', 0):7d}")
    return lines


def cmd_top(args):
    """Live terminal view over GET /cluster/health (+ per-node readyz
    probes) — the cluster-wide answer to `kubectl get nodes`."""
    import time as _time

    frames = 0
    while True:
        try:
            h = call(args.master, "/cluster/health", timeout=5)
        except (RpcError, OSError) as e:
            print(f"error: master {args.master} unreachable: {e}")
            sys.exit(1)
        lines = _render_top(h, args.master)
        try:
            u = call(args.master, "/cluster/usage", timeout=5)
        except (RpcError, OSError):
            u = None
        if u and u.get("nodes"):
            lines.append("")
            lines.extend(_render_usage(u))
        if not args.once and sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H")
        print("\n".join(lines), flush=True)
        frames += 1
        if args.once or (args.n and frames >= args.n):
            return
        try:
            _time.sleep(args.interval)
        except KeyboardInterrupt:
            return


def cmd_lint_dashboards(args):
    """Grafana-vs-registry + SLO-rule lint; non-zero exit on any
    dangling metric reference."""
    from .stats import lint

    problems = lint.run(args.path or None)
    for prob in problems:
        print(f"lint: {prob}")
    if problems:
        sys.exit(1)
    print("dashboards + SLO rules reference only registered families")


def cmd_not_ported(args):
    print(f"error: {args.command}: {_ITEM_9}", file=sys.stderr)
    sys.exit(2)


def _workers_flag(p):
    p.add_argument("-workers", type=int, default=0,
                   help="prefork this many gateway worker processes per "
                        "HTTP listener via SO_REUSEPORT (sets "
                        "WEED_HTTP_WORKERS; 0/1 = single process)")


def _device_flag(p):
    p.add_argument("-device", default="",
                   help="where EC work runs: empty for the CUDA card "
                        "(default), 'cpu' for the plain PyTorch versions "
                        "of the kernels on the host")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="weed", description=__doc__)
    parser.add_argument("-v", type=int, default=0,
                        help="glog verbosity level")
    parser.add_argument("-cpuprofile", default="",
                        help="dump a cProfile trace here on shutdown")
    parser.add_argument("-memprofile", default="",
                        help="dump a heap snapshot here on shutdown")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("master", help="start a master server")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-pulseSeconds", type=float, default=5.0)
    p.add_argument("-peers", default="",
                   help="comma-separated other master addresses (raft)")
    p.add_argument("-join", action="store_true",
                   help="join the -peers cluster as a non-voting "
                        "learner (promoted to voter after catch-up) "
                        "instead of bootstrapping as a voter")
    p.add_argument("-mdir", default="", help="raft state directory")
    p.add_argument("-tcp", action="store_true",
                   help="serve per-file assigns on the native fast-path "
                        "port (port+20000) via leased fid ranges")
    _workers_flag(p)
    p.set_defaults(fn=cmd_master)

    p = sub.add_parser("master.follower",
                       help="read-only lookup/assign cache master")
    p.add_argument("-masters", default="127.0.0.1:9333")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9334)
    p.set_defaults(fn=cmd_master_follower)

    p = sub.add_parser("volume", help="start a volume server")
    p.add_argument("-dir", default="./data")
    p.add_argument("-max", default="8")
    p.add_argument("-mserver", default="127.0.0.1:9333")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-rack", default="")
    p.add_argument("-dataCenter", default="")
    p.add_argument("-pulseSeconds", type=float, default=5.0)
    p.add_argument("-tier", action="append", default=[],
                   help="tier backend: name=local:/dir or "
                        "name=s3:endpoint[,ak,sk] (repeatable)")
    p.add_argument("-tcp", action="store_true",
                   help="serve the TCP read fast path on port+20000")
    p.add_argument("-readMode", default="proxy",
                   choices=["local", "proxy", "redirect"],
                   help="how to serve reads of non-local volumes")
    p.add_argument("-fsync", action="store_true",
                   help="group-commit fsync before acknowledging writes")
    p.add_argument("-ecBackend", default="",
                   choices=["", "cuda", "tpu", "cpu", "torch", "jax",
                            "numpy", "auto"],
                   help="EC codec: cuda (batched device pipeline; 'tpu' "
                        "is the JAX package's name for it) | cpu (AVX2) "
                        "| torch | jax (the device codec) | numpy | auto; "
                        "empty picks through the measured link")
    p.add_argument("-index", default="memory",
                   choices=["memory", "compact", "sqlite"],
                   help="needle index kind (compact: 16 B/needle numpy "
                        "arrays; sqlite: disk-backed)")
    p.add_argument("-concurrentUploadLimitMB", type=int, default=0,
                   help="in-flight upload byte throttle (0 = unlimited)")
    p.add_argument("-concurrentDownloadLimitMB", type=int, default=0,
                   help="in-flight download byte throttle (0 = unlimited)")
    _workers_flag(p)
    _device_flag(p)
    p.set_defaults(fn=cmd_volume)

    p = sub.add_parser("server", help="combined master+volume "
                                      "(the filer and s3 wait)")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", default="./data")
    p.add_argument("-masterPort", type=int, default=9333)
    p.add_argument("-volumePort", type=int, default=8080)
    p.add_argument("-filerPort", type=int, default=8888)
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    p.add_argument("-pulseSeconds", type=float, default=5.0)
    p.add_argument("-filer", action="store_true",
                   help="not ported yet (ROADMAP item 9)")
    p.add_argument("-s3", action="store_true",
                   help="not ported yet (ROADMAP item 9)")
    p.add_argument("-iam", action="store_true",
                   help="not ported yet (ROADMAP item 9)")
    p.add_argument("-iamPort", type=int, default=8111)
    p.add_argument("-db", default="")
    p.add_argument("-store", default="sqlite",
                   help="filer store kind (with -filer)")
    p.add_argument("-storeAddress", default="",
                   help="shared `weed filer.store` address (-store remote)")
    p.add_argument("-config", default="")
    p.add_argument("-rack", default="")
    p.add_argument("-tcp", action="store_true",
                   help="enable the volume TCP read fast path")
    p.add_argument("-encryptVolumeData", action="store_true",
                   help="encrypt chunk data at rest (with -filer)")
    _workers_flag(p)
    _device_flag(p)
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("shell", help="interactive admin shell")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-filer", default="",
                   help="filer for fs.*/s3.* (default: discover via master)")
    p.add_argument("-c", default="",
                   help="run ;-separated commands and exit")
    p.set_defaults(fn=cmd_shell)

    p = sub.add_parser("profile",
                       help="cluster-wide CPU flamegraph: burst-profile "
                            "every live daemon and merge the stacks")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-seconds", type=float, default=5.0,
                   help="burst duration per daemon")
    p.add_argument("-hz", type=float, default=99.0,
                   help="sampling rate during the burst")
    p.add_argument("-o", default="",
                   help="write collapsed stacks here (default: stdout)")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("maintenance",
                       help="curator control: status, queue, pause/"
                            "resume, or force a scan/job")
    p.add_argument("action",
                   choices=["status", "queue", "pause", "resume", "run"])
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-type", default="",
                   help="run: enqueue one explicit job of this type "
                        "(ec.rebuild / fix.replication / vacuum / "
                        "deep.scrub / balance) instead of a full scan")
    p.add_argument("-volume", type=int, default=0,
                   help="run: volume id for the explicit job")
    p.add_argument("-collection", default="",
                   help="run: collection for the explicit job")
    p.set_defaults(fn=cmd_maintenance)

    p = sub.add_parser("top", help="live cluster health view "
                                   "(/cluster/health + readyz probes)")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-interval", type=float, default=2.0,
                   help="seconds between redraws")
    p.add_argument("-n", type=int, default=0,
                   help="frames to render (0 = until interrupted)")
    p.add_argument("-once", action="store_true",
                   help="print one frame and exit (scripting)")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("lint-dashboards",
                       help="check grafana panels and SLO rules against "
                            "the metrics registry")
    p.add_argument("-path", default="",
                   help="dashboard json (default: bundled dashboard)")
    p.set_defaults(fn=cmd_lint_dashboards)

    p = sub.add_parser("backup",
                       help="local incremental copy of one volume")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dir", default=".")
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser("compact", help="offline vacuum of a volume")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.set_defaults(fn=cmd_compact)

    p = sub.add_parser("fix", help="rebuild a volume .idx from its .dat")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.set_defaults(fn=cmd_fix)

    p = sub.add_parser("scrub", help="verify EC shards against the CRCs "
                       "recorded by the device-fused encode (.vif)")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-repair", action="store_true",
                   help="rebuild corrupt/missing shards from survivors")
    _device_flag(p)
    p.set_defaults(fn=cmd_scrub)

    p = sub.add_parser("export", help="export a volume's live needles")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-o", default="", help="write a tar archive here")
    p.add_argument("-newer", type=float, default=0,
                   help="only needles modified after this unix time")
    p.set_defaults(fn=cmd_export)

    for name in sorted(NOT_PORTED_COMMANDS):
        p = sub.add_parser(name, help="not ported yet (ROADMAP item 9)")
        p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("version", help="print version")
    p.set_defaults(fn=lambda a: print(VERSION))

    p = sub.add_parser("autocomplete",
                       help="print a bash completion script "
                            "(source it or install under "
                            "/etc/bash_completion.d)")
    p.set_defaults(fn=lambda a: print(_completion_script(
        sorted(sub.choices))))
    return parser


def main(argv=None):
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.command not in NOT_PORTED_COMMANDS:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if getattr(args, "workers", 0):
        # flag wins over env; RpcServer reads WEED_HTTP_WORKERS at bind
        os.environ["WEED_HTTP_WORKERS"] = str(args.workers)
    if args.v:
        from .util import glog

        glog.set_verbosity(args.v)
    if args.cpuprofile or args.memprofile:
        from .util import grace

        grace.setup_profiling(args.cpuprofile, args.memprofile)
    try:
        args.fn(args)
    except BrokenPipeError:  # e.g. `... top | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
