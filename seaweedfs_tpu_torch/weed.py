"""weed — the port's command line: `python -m seaweedfs_tpu_torch <cmd>`.

The port's own counterpart of the repo's `weed.py`, with the same
subcommands, flags and meanings for every daemon and tool: master,
master.follower, volume, filer, filer.store, s3, iam, server (master +
volume, with -filer a filer, with -s3/-iam the gateways over it), shell,
maintenance, top, lint-dashboards, profile, the offline volume tools
(backup, compact, fix, scrub, export), benchmark, upload, download,
filer.copy, filer.cat, the replication tools (filer.sync, filer.backup,
filer.replicate, filer.meta.backup, filer.meta.tail, filer.remote.sync,
filer.remote.gateway), scaffold, version and autocomplete.

One flag is the port's own: `-device` on the commands that do device
work (volume, filer, s3, iam, server, scrub).  Empty (the default) means
the CUDA card; `-device cpu` runs the kernels' plain PyTorch versions
(and keeps the filer's HBM cache tier) on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from .rpc.http_rpc import RpcError, call

VERSION = "seaweedfs_tpu_torch 0.1 (RS(10,4) EC on CUDA via PyTorch)"


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


def _make_filer_store(kind: str, path: str, store_address: str = "",
                      masters: str = ""):
    from .filer.filer_store import (PerBucketStoreRouter,
                                                 ShardedSqliteStore,
                                                 SqliteStore)

    if kind == "remote":
        # stateless filer against a shared `weed filer.store` service
        # (the redis-family HA mode, universal_redis_store.go)
        from .filer.store_server import RemoteStore

        if not store_address:
            raise SystemExit("-store remote needs -storeAddress host:port")
        return RemoteStore(store_address)
    if kind == "cluster":
        # stateless filer routing by the master-replicated shard map to
        # a fleet of `weed filer.store -master ...` slot holders
        from .filer.cluster_store import ClusterStore

        if not masters:
            raise SystemExit("-store cluster needs -master host:port")
        return ClusterStore(masters.split(","))
    if kind not in ("sqlite", "sharded", "perbucket"):
        raise SystemExit(f"unknown filer store kind {kind!r} "
                         "(sqlite | sharded | perbucket | remote | "
                         "cluster)")
    if not path:
        if kind != "sqlite":
            raise SystemExit(
                f"-store {kind} is persistent and needs -db <path>")
        return None  # in-memory store
    if kind == "sqlite":
        return SqliteStore(path)
    if kind == "sharded":
        return ShardedSqliteStore(path)
    return PerBucketStoreRouter(path)


def cmd_filer_store(args):
    """`weed filer.store`: host one shared metadata store for many
    stateless filers (-store remote)."""
    from .filer.store_server import (FilerStoreServer,
                                                  make_store)

    store = make_store(args.db_kind, args.dir)
    masters = [m for m in (args.master or "").split(",") if m]
    s = FilerStoreServer(host=args.ip, port=args.port, store=store,
                         masters=masters)
    s.start()
    print(f"filer.store ({args.db_kind}) listening on {s.address}" +
          (f", leasing shards from {masters}" if masters else ""),
          flush=True)
    _wait_forever([s])


def cmd_filer(args):
    from .filer.server import FilerServer

    store = _make_filer_store(args.store, args.db,
                              getattr(args, "storeAddress", ""),
                              masters=args.master)
    f = FilerServer(args.master, host=args.ip, port=args.port, store=store,
                    chunk_size=args.maxMB * 1024 * 1024,
                    replication=args.replication,
                    collection=args.collection, guard=_load_guard(),
                    peers=args.peers.split(",") if args.peers else None,
                    persist_meta_log=args.metaLog,
                    cipher=args.encryptVolumeData,
                    cache_dir=args.cacheDir,
                    cache_disk_bytes=args.cacheCapacityMB << 20,
                    device=args.device or None)
    _wire_notification(f)
    f.start()
    stoppables = [f]
    if args.metricsPort:
        from .stats.metrics import start_metrics_server

        m = start_metrics_server(args.ip, args.metricsPort)
        stoppables.append(m)
        print(f"metrics on {m.address}/metrics", flush=True)
    print(f"filer listening on {f.address}", flush=True)
    _wait_forever(stoppables)


def _wire_notification(filer_server):
    """Attach the notification.toml sink, if configured."""
    from .notification import load_notification_queue
    from .util.config import load_configuration

    try:
        queue = load_notification_queue(load_configuration("notification"))
    except RuntimeError as e:
        print(f"notification sink disabled: {e}", flush=True)
        return
    if queue is not None:
        filer_server.filer.notification_queue = queue
        print(f"notification sink: {queue.name}", flush=True)


def _load_identities(path):
    from .s3api.auth import Identity

    if not path:
        return None
    with open(path) as f:
        config = json.load(f)
    return [Identity(name=i["name"], access_key=i["access_key"],
                     secret_key=i["secret_key"],
                     actions=i.get("actions", ["Admin"]))
            for i in config.get("identities", [])]


def cmd_s3(args):
    from .filer.filer_store import SqliteStore
    from .filer.server import FilerServer
    from .s3api.server import S3ApiServer

    store = SqliteStore(args.db) if args.db else None
    filer = FilerServer(args.master, port=0, store=store,
                        guard=_load_guard(),
                        cipher=args.encryptVolumeData,
                        device=args.device or None)
    filer.start()
    s3 = S3ApiServer(filer, host=args.ip, port=args.port,
                     identities=_load_identities(args.config))
    s3.start()
    stoppables = [s3, filer]
    if args.metricsPort:
        from .stats.metrics import start_metrics_server

        m = start_metrics_server(args.ip, args.metricsPort)
        stoppables.append(m)
        print(f"metrics on {m.address}/metrics", flush=True)
    print(f"s3 gateway on {s3.address} (filer {filer.address})", flush=True)
    _wait_forever(stoppables)


def cmd_iam(args):
    from .filer.filer_store import SqliteStore
    from .filer.server import FilerServer
    from .iamapi.server import IamApiServer
    from .s3api.server import S3ApiServer

    store = SqliteStore(args.db) if args.db else None
    filer = FilerServer(args.master, port=0, store=store,
                        guard=_load_guard(),
                        cipher=args.encryptVolumeData,
                        device=args.device or None)
    filer.start()
    s3 = S3ApiServer(filer, port=args.s3Port,
                     identities=_load_identities(args.config))
    s3.start()
    iam = IamApiServer(filer, host=args.ip, port=args.port, s3_server=s3)
    iam.start()
    print(f"iam api on {iam.address} (s3 {s3.address})", flush=True)
    _wait_forever([iam, s3, filer])


def cmd_server(args):
    """Combined master + volume + filer (+ s3, + iam) in one process
    (weed/command/server.go)."""
    from .filer.server import FilerServer
    from .master.server import MasterServer
    from .s3api.server import S3ApiServer
    from .volume_server.server import VolumeServer

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

    if args.filer or args.s3 or args.iam:
        store = _make_filer_store(args.store, args.db,
                                  getattr(args, "storeAddress", ""),
                                  masters=master.address)
        filer = FilerServer(master.address, host=args.ip,
                            port=args.filerPort, store=store, guard=guard,
                            cipher=args.encryptVolumeData,
                            device=args.device or None)
        _wire_notification(filer)
        filer.start()
        stoppables.append(filer)
        print(f"filer on {filer.address}", flush=True)
        if args.s3 or args.iam:
            s3 = S3ApiServer(filer, host=args.ip, port=args.s3Port,
                             identities=_load_identities(args.config))
            s3.start()
            stoppables.append(s3)
            print(f"s3 gateway on {s3.address}", flush=True)
            if args.iam:
                from .iamapi.server import IamApiServer

                iam = IamApiServer(filer, host=args.ip,
                                   port=args.iamPort, s3_server=s3)
                iam.start()
                stoppables.append(iam)
                print(f"iam api on {iam.address}", flush=True)
    _wait_forever(stoppables)


def _shell_handlers(env):
    """The full admin command registry (weed/shell/commands.go)."""
    from .shell import commands as sh
    from .shell import commands_fs as fs
    from .shell import commands_maintenance as mnt
    from .shell import commands_qos as qos_cmds
    from .shell import commands_remote as rem
    from .shell import commands_scale as scale
    from .shell import commands_volume as vol

    def show(value):
        print(json.dumps(value, indent=2, default=str), flush=True)

    def flag(a, name, default=None):
        for item in a:
            if item.startswith(f"-{name}="):
                return item.split("=", 1)[1]
        return default

    plan = lambda a: "-plan" in a or "-n" in a
    ap = lambda p: fs.resolve_path(env, p)  # fs.* paths obey fs.cd
    return {
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
        # fs family
        "fs.ls": lambda a: show(fs.fs_ls(
            env, ap(a[-1] if a and not a[-1].startswith("-") else ""),
            long_format="-l" in a)),
        "fs.cat": lambda a: sys.stdout.buffer.write(
            fs.fs_cat(env, ap(a[0]))),
        "fs.mkdir": lambda a: show(fs.fs_mkdir(env, ap(a[0]))),
        "fs.rm": lambda a: fs.fs_rm(
            env, ap(a[-1]), recursive="-r" in a),
        "fs.mv": lambda a: show(fs.fs_mv(env, ap(a[0]), ap(a[1]))),
        "fs.du": lambda a: show(fs.fs_du(env, ap(a[0] if a else ""))),
        "fs.tree": lambda a: print("\n".join(fs.fs_tree(
            env, ap(a[0] if a else "")))),
        "fs.cd": lambda a: show(fs.fs_cd(env, a[0] if a else "/")),
        "fs.pwd": lambda a: show(fs.fs_pwd(env)),
        "fs.meta.cat": lambda a: show(fs.fs_meta_cat(env, ap(a[0]))),
        "fs.meta.save": lambda a: show({"saved": len(fs.fs_meta_save(
            env, ap(a[-1] if a and not a[-1].startswith("-") else ""),
            output=flag(a, "o", "")))}),
        "fs.meta.load": lambda a: show(
            {"loaded": fs.fs_meta_load(env, a[0])}),
        "fs.meta.notify": lambda a: show(fs.fs_meta_notify(
            env, ap(a[0] if a else ""))),
        "fs.configure": lambda a: show(fs.fs_configure(
            env, flag(a, "locationPrefix", a[0] if a else "/"),
            collection=flag(a, "collection", ""),
            replication=flag(a, "replication", ""),
            ttl=flag(a, "ttl", ""),
            read_only=True if "-readOnly" in a else None,
            ec_code=flag(a, "ecCode", ""),
            delete="-delete" in a)),
        # remote storage family
        "remote.configure": lambda a: show(rem.remote_configure(
            env, name=flag(a, "name", ""), type=flag(a, "type", "s3"),
            endpoint=flag(a, "endpoint", ""),
            access_key=flag(a, "access_key", ""),
            secret_key=flag(a, "secret_key", ""),
            directory=flag(a, "dir", ""), delete="-delete" in a)),
        "remote.mount": lambda a: show(rem.remote_mount(
            env, directory=flag(a, "dir", ""),
            remote=flag(a, "remote", ""))),
        "remote.unmount": lambda a: show(rem.remote_unmount(
            env, flag(a, "dir", ""))),
        "remote.meta.sync": lambda a: show(rem.remote_meta_sync(
            env, flag(a, "dir", ""))),
        "remote.cache": lambda a: show(rem.remote_cache(
            env, flag(a, "dir", ""))),
        "remote.uncache": lambda a: show(rem.remote_uncache(
            env, flag(a, "dir", ""))),
        "remote.mount.buckets": lambda a: show(rem.remote_mount_buckets(
            env, flag(a, "remote", ""))),
        # s3 family
        "s3.bucket.list": lambda a: show(fs.s3_bucket_list(env)),
        "s3.bucket.create": lambda a: show(fs.s3_bucket_create(
            env, flag(a, "name", a[0] if a else ""))),
        "s3.bucket.delete": lambda a: fs.s3_bucket_delete(
            env, flag(a, "name", a[0] if a else "")),
        "s3.clean.uploads": lambda a: show(fs.s3_clean_uploads(
            env, float(flag(a, "timeAgo", 24 * 3600)))),
        "s3.configure": lambda a: show(fs.s3_configure(
            env, flag(a, "user", "admin"),
            flag(a, "access_key", ""), flag(a, "secret_key", ""),
            actions=(flag(a, "actions", "Admin") or "").split(","))),
        "s3.bucket.quota": lambda a: show(fs.s3_bucket_quota(
            env, flag(a, "name", ""), op=flag(a, "op", "set"),
            size_mb=int(flag(a, "sizeMB", "0")))),
        "s3.bucket.quota.enforce": lambda a: show(
            fs.s3_bucket_quota_enforce(env, apply="-apply" in a)),
        "s3.circuitbreaker": lambda a: show(fs.s3_circuitbreaker(
            env, actions=flag(a, "actions", ""),
            values=flag(a, "values", ""),
            buckets=flag(a, "buckets", ""),
            enable=(True if "-enable" in a
                    else False if "-disable" in a else None),
            delete="-delete" in a)),
    }


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
        except (RpcError, ValueError, IndexError) as e:
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


def cmd_benchmark(args):
    from .benchmark import run_benchmark

    run_benchmark(args.master, num_files=args.n, file_size=args.size,
                  concurrency=args.c, delete_percent=args.deletePercent,
                  replication=args.replication, use_tcp=args.useTcp,
                  use_native=args.useNative, assign_batch=args.assignBatch,
                  per_file_assign=args.perFileAssign)


def cmd_upload(args):
    with open(args.file, "rb") as f:
        body = f.read()
    a = call(args.master, f"/dir/assign?replication={args.replication}")
    headers = {"X-File-Name": os.path.basename(args.file)}
    if a.get("auth"):
        headers["Authorization"] = "BEARER " + a["auth"]
    resp = call(a["url"], f"/{a['fid']}", raw=body, method="POST",
                headers=headers)
    print(json.dumps({"fid": a["fid"], "url": a["url"],
                      "size": resp.get("size")}))


def cmd_download(args):
    vid = args.fid.split(",")[0]
    found = call(args.master, f"/dir/lookup?volumeId={vid}")
    data = call(found["locations"][0]["url"], f"/{args.fid}")
    out = args.output or args.fid.replace(",", "_")
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes to {out}")


def _sync_state_path(tag: str) -> str:
    import hashlib

    digest = hashlib.md5(tag.encode()).hexdigest()[:12]
    return os.path.expanduser(f"~/.weed_sync_{digest}.json")


def _load_offsets(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_offsets(path: str, offsets: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(offsets, f)
    os.replace(tmp, path)


def cmd_filer_sync(args):
    """Continuous one- or two-way sync between filers
    (weed/command/filer_sync.go)."""
    import hashlib
    import time

    from .replication import FilerSink, FilerSource, Replicator

    # key includes the paths: different path pairs between the same
    # endpoints must not share cursors
    state = args.state or _sync_state_path(
        f"{args.a}{args.a_path}|{args.b}{args.b_path}")
    offsets = _load_offsets(state)

    def _sig(tag: str) -> int:
        # stable across restarts (unlike hash()), never 0
        return (int.from_bytes(hashlib.md5(tag.encode()).digest()[:4],
                               "big") & 0x7FFFFFFF) or 1

    sig_ab, sig_ba = _sig(f"{args.a}->{args.b}"), _sig(f"{args.b}->{args.a}")
    # each direction stamps its own signature on sink writes and SKIPS
    # events stamped by the opposite direction (they are its echoes)
    pairs = [("a->b", FilerSource(args.a, args.a_path),
              FilerSink(args.b, args.b_path, signature=sig_ab), sig_ba)]
    if not args.isActivePassive:
        pairs.append(("b->a", FilerSource(args.b, args.b_path),
                      FilerSink(args.a, args.a_path, signature=sig_ba),
                      sig_ab))
    reps = [(name, Replicator(src, snk, signature=skip_sig))
            for name, src, snk, skip_sig in pairs]
    print(f"filer.sync {args.a}{args.a_path} <-> {args.b}{args.b_path} "
          f"({'active-passive' if args.isActivePassive else 'two-way'})",
          flush=True)
    while True:
        moved = 0
        for name, rep in reps:
            applied, cursor = rep.run_once(offsets.get(name, 0),
                                           concurrency=args.concurrency)
            if cursor != offsets.get(name, 0):
                offsets[name] = cursor
                _save_offsets(state, offsets)
            moved += applied
        if args.once and moved == 0:
            break
        if not moved:
            time.sleep(args.interval)


def cmd_filer_backup(args):
    """Incremental content backup of a filer path to a local/s3 sink
    (weed/command/filer_backup.go)."""
    import time

    from .replication import FilerSource, Replicator, make_sink

    sink = make_sink(args.sink, access_key=args.accessKey,
                     secret_key=args.secretKey,
                     is_incremental=args.incremental)
    source = FilerSource(args.filer, args.filerPath)
    rep = Replicator(source, sink,
                     exclude_dirs=[d for d in args.exclude.split(",") if d])
    state = args.state or _sync_state_path(
        f"backup{args.filer}{args.filerPath}|{args.sink}")
    offsets = _load_offsets(state)
    while True:
        applied, cursor = rep.run_once(offsets.get("backup", 0))
        if cursor != offsets.get("backup", 0):
            offsets["backup"] = cursor
            _save_offsets(state, offsets)
        if args.once and applied == 0:
            break
        if not applied:
            time.sleep(args.interval)


def cmd_filer_replicate(args):
    """MQ-driven replication consumer (weed/command/filer_replication.go):
    events arrive from the notification queue configured in
    notification.toml, not from a live filer subscription."""
    from .notification import load_notification_input
    from .replication import FilerSource, Replicator, make_sink
    from .replication.replicator import run_from_queue
    from .util.config import load_configuration

    queue_input = load_notification_input(load_configuration("notification"))
    if queue_input is None:
        raise SystemExit(
            "no notification input defined in notification.toml "
            "(enable notification.file or notification.kafka)")
    sink = make_sink(args.sink, access_key=args.accessKey,
                     secret_key=args.secretKey,
                     is_incremental=args.incremental)
    source = FilerSource(args.filer, args.filerPath)
    rep = Replicator(source, sink,
                     exclude_dirs=[d for d in args.exclude.split(",") if d])
    print(f"filer.replicate: {queue_input.name} queue -> {args.sink}",
          flush=True)
    applied = run_from_queue(queue_input, rep, once=args.once,
                             idle_sleep=args.interval)
    if args.once:
        print(f"applied {applied} events")


def cmd_filer_meta_backup(args):
    """Metadata-only backup into a local sqlite store
    (weed/command/filer_meta_backup.go)."""
    import time

    from .replication.meta_backup import MetaBackup, restore_listing

    if args.restore:
        for entry in restore_listing(args.store, args.filerPath):
            print(json.dumps(entry))
        return
    backup = MetaBackup(args.filer, args.filerPath, args.store)
    try:
        while True:
            applied = backup.run_once()
            if args.once and applied == 0:
                break
            if not applied:
                time.sleep(args.interval)
    finally:
        backup.close()


def cmd_filer_meta_tail(args):
    """Print the filer metadata change feed
    (weed/command/filer_meta_tail.go)."""
    import time

    from .replication import FilerSource

    source = FilerSource(args.filer, args.pathPrefix)
    since = int((time.time() - args.timeAgo) * 1e9) if args.timeAgo else 0
    while True:
        events = source.subscribe(since)
        for event in events:
            print(json.dumps(event))
            since = max(since, event["ts_ns"])
        if args.once:
            break
        if not events:
            time.sleep(args.interval)


def cmd_filer_copy(args):
    """Copy local files/directories into the filer
    (weed/command/filer_copy.go)."""
    dest = args.path.rstrip("/")  # "" for root: targets join as /name
    copied = 0
    for src in args.files:
        src = src.rstrip("/")
        if os.path.isdir(src):
            base = os.path.basename(src)
            for dirpath, _, files in os.walk(src):
                rel_dir = os.path.relpath(dirpath, src)
                for name in sorted(files):
                    rel = name if rel_dir == "." \
                        else f"{rel_dir}/{name}"
                    target = f"{dest}/{base}/{rel}"
                    _copy_one(args.filer, os.path.join(dirpath, name),
                              target)
                    copied += 1
        else:
            _copy_one(args.filer, src,
                      f"{dest}/{os.path.basename(src)}")
            copied += 1
    print(f"copied {copied} files to {args.filer}{dest}")


def _copy_one(filer: str, local_path: str, target: str):
    import mimetypes
    import urllib.parse

    with open(local_path, "rb") as f:
        body = f.read()
    mime = mimetypes.guess_type(local_path)[0] or \
        "application/octet-stream"
    call(filer, urllib.parse.quote(target), raw=body, method="POST",
         headers={"Content-Type": mime}, timeout=600)


def cmd_filer_cat(args):
    """Stream one filer file to stdout (weed/command/filer_cat.go)."""
    import urllib.parse

    # the raw GET can't distinguish a stored .json file from a
    # directory listing, so check the entry type via the parent listing
    path = "/" + args.path.strip("/")
    parent, _, name = path.rpartition("/")
    listing = call(args.filer,
                   urllib.parse.quote(parent or "/") + "/?limit=10000",
                   timeout=60)
    entry = next((e for e in listing.get("Entries", [])
                  if e.get("FullPath", "").rsplit("/", 1)[-1] == name),
                 None)
    if entry is None:
        print(f"error: {path} not found", file=sys.stderr)
        sys.exit(1)
    if entry.get("IsDirectory"):
        print(f"error: {path} is a directory", file=sys.stderr)
        sys.exit(1)
    data = call(args.filer, urllib.parse.quote(path), parse=False,
                timeout=600)
    sys.stdout.buffer.write(data)


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


def cmd_filer_remote_sync(args):
    """Push local changes under a remote mount back to the remote
    storage (weed/command/filer_remote_sync.go; filer.remote.gateway is
    the same loop pointed at /buckets)."""
    import time

    from .remote_storage import RemoteConf, RemoteLocation, make_remote_client
    from .replication import FilerSource

    directory = args.dir.rstrip("/") or "/"
    listing = call(args.filer, "/remote/list")
    mappings = listing.get("mappings", {})
    if directory not in mappings:
        print(f"error: {directory} is not a remote mount "
              f"(mounted: {sorted(mappings) or 'none'})")
        sys.exit(1)
    root = RemoteLocation.parse(mappings[directory])
    conf = next((c for c in listing.get("storages", [])
                 if c["name"] == root.name), None)
    if conf is None:
        print(f"error: remote storage {root.name!r} not configured")
        sys.exit(1)
    client = make_remote_client(RemoteConf.from_dict(conf))
    source = FilerSource(args.filer, directory + "/")
    state = args.state or _sync_state_path(
        f"remote{args.filer}{directory}")
    offsets = _load_offsets(state)
    print(f"filer.remote.sync {args.filer}{directory} -> {root}",
          flush=True)

    def loc_of(full_path: str) -> "RemoteLocation":
        rel = full_path[len(directory):].lstrip("/")
        return RemoteLocation(root.name, root.bucket,
                              root.path.rstrip("/") + "/" + rel)

    def in_mount(e):
        return e and e["full_path"].startswith(directory + "/")

    def entry_is_dir(e):
        return bool(e.get("attr", {}).get("mode", 0) & 0o40000)

    while True:
        cursor = offsets.get("sync", 0)
        moved = 0
        for event in source.subscribe(cursor):
            old, new = event.get("old_entry"), event.get("new_entry")
            try:
                # drop the old remote object on delete AND on rename
                if in_mount(old) and (
                        new is None
                        or old["full_path"] != new["full_path"]):
                    if entry_is_dir(old):
                        client.delete_prefix(loc_of(old["full_path"]))
                    else:
                        client.delete_file(loc_of(old["full_path"]))
                    moved += 1
                if in_mount(new) and not entry_is_dir(new) \
                        and not new.get("remote_entry"):
                    # a genuinely local change (mount syncs carry
                    # remote_entry and must not echo back)
                    path = new["full_path"]
                    data = source.read_entry_bytes(path)
                    client.write_file(loc_of(path), data)
                    moved += 1
            except RpcError as e:
                print(f"push {(new or old)['full_path']}: {e} "
                      "(will retry)")
                break
            cursor = max(cursor, event["ts_ns"])
        if cursor != offsets.get("sync", 0):
            offsets["sync"] = cursor
            _save_offsets(state, offsets)
        if args.once and moved == 0:
            break
        if not moved:
            time.sleep(args.interval)


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


def cmd_scaffold(args):
    from .util.config import scaffold

    text = scaffold(args.config)
    if args.output:
        path = os.path.join(args.output, args.config + ".toml")
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path}")
    else:
        print(text, end="")


def _workers_flag(p):
    p.add_argument("-workers", type=int, default=0,
                   help="prefork this many gateway worker processes per "
                        "HTTP listener via SO_REUSEPORT (sets "
                        "WEED_HTTP_WORKERS; 0/1 = single process)")


def _device_flag(p):
    p.add_argument("-device", default="",
                   help="where device work runs (EC kernels, the "
                        "filer's HBM cache tier): empty for the CUDA card "
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

    p = sub.add_parser("filer", help="start a filer server")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-metricsPort", type=int, default=0,
                   help="serve /metrics on a dedicated port")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-maxMB", type=int, default=4)
    p.add_argument("-db", default="", help="sqlite path (default: memory)")
    p.add_argument("-store", default="sqlite",
                   help="store kind: sqlite | sharded | perbucket | "
                        "remote | cluster")
    p.add_argument("-storeAddress", default="",
                   help="shared `weed filer.store` address (-store remote)")
    p.add_argument("-replication", default="")
    p.add_argument("-collection", default="")
    p.add_argument("-peers", default="",
                   help="comma-separated peer filers to aggregate")
    p.add_argument("-metaLog", action="store_true",
                   help="persist the metadata change log")
    p.add_argument("-encryptVolumeData", action="store_true",
                   help="encrypt chunk data at rest (per-chunk AES keys "
                        "in filer metadata)")
    p.add_argument("-cacheDir", default="",
                   help="directory for the tiered on-disk chunk cache")
    p.add_argument("-cacheCapacityMB", type=int, default=1024,
                   help="on-disk chunk cache budget (with -cacheDir)")
    _workers_flag(p)
    _device_flag(p)
    p.set_defaults(fn=cmd_filer)

    p = sub.add_parser("filer.store",
                       help="host one shared metadata store for many "
                            "stateless filers (-store remote)")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8889)
    p.add_argument("-dir", default="",
                   help="persistence directory (default: memory)")
    p.add_argument("-db_kind", default="memory",
                   help="embedded kind: memory | sqlite | sharded | "
                        "perbucket")
    p.add_argument("-master", default="",
                   help="comma-separated masters: lease directory shards "
                        "from the replicated map (cluster mode)")
    p.set_defaults(fn=cmd_filer_store)

    p = sub.add_parser("s3", help="start an s3 gateway (+embedded filer)")
    p.add_argument("-metricsPort", type=int, default=0,
                   help="serve /metrics on a dedicated port")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-db", default="")
    p.add_argument("-config", default="", help="identities json")
    p.add_argument("-encryptVolumeData", action="store_true",
                   help="encrypt chunk data at rest")
    _workers_flag(p)
    _device_flag(p)
    p.set_defaults(fn=cmd_s3)

    p = sub.add_parser("iam", help="start an IAM management API (+s3+filer)")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8111)
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-db", default="", help="sqlite path (default: memory)")
    p.add_argument("-config", default="", help="s3 identities json")
    p.add_argument("-encryptVolumeData", action="store_true",
                   help="encrypt chunk data at rest")
    _device_flag(p)
    p.set_defaults(fn=cmd_iam)

    p = sub.add_parser("server", help="combined master+volume(+filer)(+s3)")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", default="./data")
    p.add_argument("-masterPort", type=int, default=9333)
    p.add_argument("-volumePort", type=int, default=8080)
    p.add_argument("-filerPort", type=int, default=8888)
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    p.add_argument("-pulseSeconds", type=float, default=5.0)
    p.add_argument("-filer", action="store_true",
                   help="also start a filer on -filerPort")
    p.add_argument("-s3", action="store_true",
                   help="also start an s3 gateway on -s3Port")
    p.add_argument("-iam", action="store_true",
                   help="also start the IAM API on -iamPort")
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

    p = sub.add_parser("benchmark", help="write/read load benchmark")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-n", type=int, default=1000)
    p.add_argument("-size", type=int, default=1024)
    p.add_argument("-c", type=int, default=16)
    p.add_argument("-deletePercent", type=int, default=0)
    p.add_argument("-replication", default="000")
    p.add_argument("-useTcp", action="store_true",
                   help="read over the TCP fast path")
    p.add_argument("-useNative", action="store_true",
                   help="drive the native engine's fast-path port with "
                        "the C++ load generator (batched assigns)")
    p.add_argument("-assignBatch", type=int, default=256,
                   help="fids per /dir/assign?count= call in -useNative "
                        "mode")
    p.add_argument("-perFileAssign", action="store_true",
                   help="per-file native assigns (master -tcp lease "
                        "service) + native writes; write phase only")
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("upload", help="upload one file")
    p.add_argument("file")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-replication", default="000")
    p.set_defaults(fn=cmd_upload)

    p = sub.add_parser("download", help="download by fid")
    p.add_argument("fid")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-output", default="")
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("filer.copy",
                       help="copy local files/dirs into the filer")
    p.add_argument("files", nargs="+")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-path", default="/", help="destination directory")
    p.set_defaults(fn=cmd_filer_copy)

    p = sub.add_parser("filer.cat", help="stream a filer file to stdout")
    p.add_argument("path")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.set_defaults(fn=cmd_filer_cat)

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

    p = sub.add_parser("filer.sync", help="sync two filers continuously")
    p.add_argument("-a", required=True, help="source filer host:port")
    p.add_argument("-b", required=True, help="target filer host:port")
    p.add_argument("-a.path", dest="a_path", default="/")
    p.add_argument("-b.path", dest="b_path", default="/")
    p.add_argument("-isActivePassive", action="store_true",
                   help="one-way a->b only")
    p.add_argument("-state", default="", help="offset state file")
    p.add_argument("-concurrency", type=int, default=1,
                   help="parallel sync lanes partitioned by path hash")
    p.add_argument("-interval", type=float, default=2.0)
    p.add_argument("-once", action="store_true",
                   help="exit when caught up (for scripting/tests)")
    p.set_defaults(fn=cmd_filer_sync)

    p = sub.add_parser("filer.backup",
                       help="replicate filer data to local/s3 sink")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-filerPath", default="/")
    p.add_argument("-sink", required=True,
                   help="local:///dir | s3://bucket/dir?endpoint=host:port"
                        " | filer://host:port/dir")
    p.add_argument("-accessKey", default="")
    p.add_argument("-secretKey", default="")
    p.add_argument("-incremental", action="store_true",
                   help="file changes under yyyy-mm-dd dirs")
    p.add_argument("-exclude", default="",
                   help="comma-separated directories to skip")
    p.add_argument("-state", default="")
    p.add_argument("-interval", type=float, default=2.0)
    p.add_argument("-once", action="store_true")
    p.set_defaults(fn=cmd_filer_backup)

    p = sub.add_parser("filer.replicate",
                       help="consume notification-queue events into a "
                            "replication sink (MQ-driven mode)")
    p.add_argument("-filer", default="127.0.0.1:8888",
                   help="source filer (chunk data reads)")
    p.add_argument("-filerPath", default="/")
    p.add_argument("-sink", required=True,
                   help="local:///dir | s3://bucket/dir?endpoint=host:port"
                        " | filer://host:port/dir")
    p.add_argument("-accessKey", default="")
    p.add_argument("-secretKey", default="")
    p.add_argument("-incremental", action="store_true")
    p.add_argument("-exclude", default="")
    p.add_argument("-interval", type=float, default=1.0)
    p.add_argument("-once", action="store_true",
                   help="drain the queue and exit")
    p.set_defaults(fn=cmd_filer_replicate)

    p = sub.add_parser("filer.meta.backup",
                       help="continuously back up filer metadata to sqlite")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-filerPath", default="/")
    p.add_argument("-store", required=True, help="sqlite backup file")
    p.add_argument("-restore", action="store_true",
                   help="print entries from the backup store and exit")
    p.add_argument("-interval", type=float, default=2.0)
    p.add_argument("-once", action="store_true")
    p.set_defaults(fn=cmd_filer_meta_backup)

    p = sub.add_parser("filer.remote.sync",
                       help="push local changes under a mount to remote")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-dir", required=True, help="mounted directory")
    p.add_argument("-state", default="")
    p.add_argument("-interval", type=float, default=2.0)
    p.add_argument("-once", action="store_true")
    p.set_defaults(fn=cmd_filer_remote_sync)

    p = sub.add_parser("filer.remote.gateway",
                       help="push bucket changes under /buckets to remote")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-dir", default="/buckets")
    p.add_argument("-state", default="")
    p.add_argument("-interval", type=float, default=2.0)
    p.add_argument("-once", action="store_true")
    p.set_defaults(fn=cmd_filer_remote_sync)

    p = sub.add_parser("filer.meta.tail",
                       help="print filer metadata change events")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-pathPrefix", default="/")
    p.add_argument("-timeAgo", type=float, default=0,
                   help="start this many seconds in the past")
    p.add_argument("-interval", type=float, default=1.0)
    p.add_argument("-once", action="store_true")
    p.set_defaults(fn=cmd_filer_meta_tail)

    p = sub.add_parser("scaffold", help="print a config template")
    p.add_argument("-config", default="security",
                   help="security|master|filer|replication|notification")
    p.add_argument("-output", default="", help="write <name>.toml to dir")
    p.set_defaults(fn=cmd_scaffold)

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
    args = parser.parse_args(argv)
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
