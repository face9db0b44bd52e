"""Admin shell: fs.* and s3.* commands against a filer.

Parity with weed/shell/command_fs_*.go and command_s3_*.go: namespace
inspection (ls/du/tree/cat/meta), mutation (mkdir/rm/mv), metadata
save/load round-trips, bucket management under /buckets, stale multipart
upload cleanup, and identity configuration shared with the IAM API.

The port's own copy of seaweedfs_tpu/shell/commands_fs.py.  The S3
gateway's circuit-breaker config path is kept here until the gateway
(ROADMAP item 9b) is ported.
"""

from __future__ import annotations

import json
import time
import urllib.parse
from typing import Optional

from ..rpc.http_rpc import RpcError, call
from .commands import CommandEnv

BUCKETS_ROOT = "/buckets"
IDENTITY_CONFIG_PATH = "/etc/iam/identity.json"


def _get_json_config(filer: str, path: str) -> dict:
    """Fetch a JSON config entry through the filer HTTP read path; {} on
    absence or parse failure.  Shared by fs.configure / s3.configure /
    quota / circuitbreaker so the fetch-and-parse logic lives once."""
    try:
        raw = call(filer, urllib.parse.quote(path))
        return raw if isinstance(raw, dict) else json.loads(
            raw if isinstance(raw, str) else raw.decode())
    except (RpcError, ValueError):
        return {}


def find_filer(env: CommandEnv) -> str:
    """Resolve a filer address: explicit on the env, else the master's
    cluster registry (shell.go filer discovery)."""
    addr = getattr(env, "filer_address", "")
    if addr:
        return addr
    members = env.master("/cluster/nodes?type=filer") \
        .get("cluster_nodes", [])
    if not members:
        raise RpcError("no filer registered with the master", 404)
    addr = members[0]["address"]
    env.filer_address = addr
    return addr


def _list(filer: str, path: str, metadata: bool = False) -> list[dict]:
    dir_path = path if path.endswith("/") else path + "/"
    out: list[dict] = []
    last = ""
    while True:
        q = f"?limit=1000&lastFileName={urllib.parse.quote(last)}"
        if metadata:
            q += "&metadata=true"
        resp = call(filer, urllib.parse.quote(dir_path) + q)
        if not isinstance(resp, dict):
            # the filer answered with file CONTENT: path names a file
            raise RpcError(f"{path} is not a directory", 400)
        entries = resp.get("Entries", []) or []
        out.extend(entries)
        if not resp.get("ShouldDisplayLoadMore"):
            return out
        last = resp.get("LastFileName", "")
        if not last:
            return out


def _name(entry: dict) -> str:
    return (entry.get("FullPath") or entry.get("full_path", "")) \
        .rsplit("/", 1)[-1]


def _is_dir(entry: dict) -> bool:
    if "IsDirectory" in entry:
        return entry["IsDirectory"]
    return bool(entry.get("attr", {}).get("mode", 0) & 0o40000)


def _size(entry: dict) -> int:
    if "FileSize" in entry:
        return entry["FileSize"]
    return entry.get("attr", {}).get("file_size", 0)


# -- fs.* --------------------------------------------------------------------

def fs_ls(env: CommandEnv, path: str = "/",
          long_format: bool = False) -> list[dict]:
    filer = find_filer(env)
    entries = _list(filer, path)
    if long_format:
        return [{"name": _name(e), "is_dir": _is_dir(e),
                 "size": _size(e), "mode": e.get("Mode", 0),
                 "mtime": e.get("Mtime", 0)} for e in entries]
    return [{"name": _name(e), "is_dir": _is_dir(e)} for e in entries]


def fs_cat(env: CommandEnv, path: str) -> bytes:
    body = call(find_filer(env), urllib.parse.quote(path), parse=False)
    if isinstance(body, bytes):
        return body
    raise RpcError(f"{path} is a directory", 400)


def fs_mkdir(env: CommandEnv, path: str) -> dict:
    return call(find_filer(env), urllib.parse.quote(path.rstrip("/")) + "/",
                raw=b"", method="POST")


def fs_rm(env: CommandEnv, path: str, recursive: bool = False) -> None:
    q = "?recursive=true" if recursive else ""
    call(find_filer(env), urllib.parse.quote(path) + q, method="DELETE")


def fs_mv(env: CommandEnv, src: str, dst: str) -> dict:
    return call(find_filer(env),
                f"{urllib.parse.quote(dst)}?mv.from="
                f"{urllib.parse.quote(src, safe='')}",
                raw=b"", method="POST")


def fs_du(env: CommandEnv, path: str = "/") -> dict:
    """command_fs_du.go: recursive file/dir/byte accounting."""
    filer = find_filer(env)
    files = dirs = size = 0

    def walk(p: str):
        nonlocal files, dirs, size
        for e in _list(filer, p):
            if _is_dir(e):
                dirs += 1
                walk(p.rstrip("/") + "/" + _name(e))
            else:
                files += 1
                size += _size(e)

    walk(path)
    return {"path": path, "files": files, "dirs": dirs, "bytes": size}


def fs_tree(env: CommandEnv, path: str = "/") -> list[str]:
    filer = find_filer(env)
    lines: list[str] = []

    def walk(p: str, depth: int):
        for e in _list(filer, p):
            name = _name(e)
            lines.append("  " * depth
                         + (name + "/" if _is_dir(e) else name))
            if _is_dir(e):
                walk(p.rstrip("/") + "/" + name, depth + 1)

    walk(path, 0)
    return lines


def fs_meta_cat(env: CommandEnv, path: str) -> dict:
    """command_fs_meta_cat.go: the raw entry record."""
    filer = find_filer(env)
    parent, _, name = path.rstrip("/").rpartition("/")
    for e in _list(filer, parent or "/", metadata=True):
        if e.get("full_path", "").rsplit("/", 1)[-1] == name:
            return e
    raise RpcError(f"{path} not found", 404)


def fs_meta_save(env: CommandEnv, path: str = "/",
                 output: str = "") -> list[dict]:
    """command_fs_meta_save.go: dump the subtree's full metadata as
    JSON-lines (returned, and written to `output` when given)."""
    filer = find_filer(env)
    records: list[dict] = []

    def walk(p: str):
        for e in _list(filer, p, metadata=True):
            records.append(e)
            if _is_dir(e):
                walk(e["full_path"] + "/")

    walk(path)
    if output:
        with open(output, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return records


def fs_meta_load(env: CommandEnv, input_path: str) -> int:
    """command_fs_meta_load.go: restore entries saved by fs.meta.save.
    Directories are recreated; file entries are restored with their
    chunk lists verbatim (the chunks must still exist on the volume
    servers)."""
    from ..filer.entry import Entry

    filer = find_filer(env)
    count = 0
    with open(input_path) as f:
        for line in f:
            if not line.strip():
                continue
            record = json.loads(line)
            entry = Entry.from_dict(record)
            if entry.is_directory:
                call(filer, urllib.parse.quote(entry.full_path) + "/",
                     raw=b"", method="POST")
            else:
                # restore metadata-only: re-post inlined content, or
                # re-attach chunks through the meta endpoint
                call(filer,
                     urllib.parse.quote(entry.full_path) + "?meta=true",
                     payload=record, method="POST")
            count += 1
    return count


# -- s3.* --------------------------------------------------------------------

def s3_bucket_list(env: CommandEnv) -> list[dict]:
    filer = find_filer(env)
    try:
        entries = _list(filer, BUCKETS_ROOT)
    except RpcError as e:
        if e.status == 404:
            return []
        raise
    return [{"name": _name(e)} for e in entries if _is_dir(e)]


def s3_bucket_create(env: CommandEnv, name: str) -> dict:
    return call(find_filer(env), f"{BUCKETS_ROOT}/{name}/",
                raw=b"", method="POST")


def s3_bucket_delete(env: CommandEnv, name: str) -> None:
    call(find_filer(env), f"{BUCKETS_ROOT}/{name}?recursive=true",
         method="DELETE")


def s3_clean_uploads(env: CommandEnv,
                     timeout_seconds: float = 24 * 3600) -> list[str]:
    """command_s3_clean_uploads.go: abort multipart uploads older than
    the timeout (their staging dirs live under <bucket>/.uploads/)."""
    filer = find_filer(env)
    removed = []
    now = time.time()
    for bucket in s3_bucket_list(env):
        uploads_dir = f"{BUCKETS_ROOT}/{bucket['name']}/.uploads"
        try:
            uploads = _list(filer, uploads_dir)
        except RpcError:
            continue
        for u in uploads:
            if now - u.get("Mtime", 0) > timeout_seconds:
                path = f"{uploads_dir}/{_name(u)}"
                call(filer, path + "?recursive=true", method="DELETE")
                removed.append(path)
    return removed


def s3_configure(env: CommandEnv, user: str, access_key: str,
                 secret_key: str,
                 actions: Optional[list[str]] = None) -> dict:
    """command_s3_configure.go: upsert an identity in the shared
    identity config (the same file the IAM API manages)."""
    filer = find_filer(env)
    config = _get_json_config(filer, IDENTITY_CONFIG_PATH)
    identities = [i for i in config.get("identities", [])
                  if i.get("name") != user]
    identities.append({
        "name": user,
        "credentials": [{"accessKey": access_key,
                         "secretKey": secret_key}],
        "actions": actions or ["Admin"],
    })
    config["identities"] = identities
    body = json.dumps(config, indent=2).encode()
    call(filer, IDENTITY_CONFIG_PATH, raw=body, method="POST",
         headers={"Content-Type": "application/json"})
    return config


def fs_configure(env: CommandEnv, location_prefix: str,
                 collection: str = "", replication: str = "",
                 ttl: str = "", read_only: Optional[bool] = None,
                 max_file_name_length: int = 0,
                 ec_code: str = "",
                 delete: bool = False) -> dict:
    """command_fs_configure.go: edit the per-path rules stored at
    /etc/seaweedfs/filer.conf in the filer itself."""
    from ..filer.filer_conf import FILER_CONF_PATH

    filer = find_filer(env)
    conf = _get_json_config(filer, FILER_CONF_PATH)
    existing = next((loc for loc in conf.get("locations", [])
                     if loc.get("location_prefix") == location_prefix), {})
    locations = [loc for loc in conf.get("locations", [])
                 if loc.get("location_prefix") != location_prefix]
    if not delete:
        # merge into the existing rule for this prefix: an unrelated
        # ttl/replication edit must not drop quota fields set by
        # s3.bucket.quota (or any other keys) on the same prefix
        rule: dict = dict(existing)
        rule["location_prefix"] = location_prefix
        if collection:
            rule["collection"] = collection
        if replication:
            rule["replication"] = replication
        if ttl:
            rule["ttl"] = ttl
        if read_only is not None:
            rule["read_only"] = read_only
        if max_file_name_length:
            rule["max_file_name_length"] = max_file_name_length
        if ec_code:
            # validate before persisting: a typo'd family name must fail
            # here, not at encode time months later
            from ..storage.erasure_coding.codes import get_family
            get_family(ec_code)
            rule["ec_code"] = ec_code
        locations.append(rule)
    conf["locations"] = locations
    call(filer, FILER_CONF_PATH, raw=json.dumps(conf, indent=2).encode(),
         method="POST", headers={"Content-Type": "application/json"})
    return conf


# -- fs.cd / fs.pwd (command_fs_cd.go, command_fs_pwd.go) --------------------

def resolve_path(env: CommandEnv, path: str) -> str:
    """Resolve `path` against the shell's working directory, handling
    "." / ".." segments (util.ResolvePath semantics)."""
    cwd = getattr(env, "cwd", "/") or "/"
    if not path:
        return cwd
    if not path.startswith("/"):
        path = cwd.rstrip("/") + "/" + path
    parts: list[str] = []
    for seg in path.split("/"):
        if seg in ("", "."):
            continue
        if seg == "..":
            if parts:
                parts.pop()
            continue
        parts.append(seg)
    return "/" + "/".join(parts)


def fs_cd(env: CommandEnv, path: str = "/") -> dict:
    """Change the shell's working directory; the target must be a
    listable directory."""
    target = resolve_path(env, path)
    if target != "/":
        # ONE limit=1 request proves existence + directory-ness; a full
        # _list() would page through every entry of a huge directory
        resp = call(find_filer(env),
                    urllib.parse.quote(target.rstrip("/") + "/")
                    + "?limit=1")
        if not isinstance(resp, dict):
            raise RpcError(f"{target} is not a directory", 400)
    env.cwd = target
    return {"cwd": target}


def fs_pwd(env: CommandEnv) -> dict:
    return {"cwd": getattr(env, "cwd", "/") or "/"}


# -- fs.meta.notify (command_fs_meta_notify.go) ------------------------------

def fs_meta_notify(env: CommandEnv, path: str = "/") -> dict:
    """Re-send a create EventNotification for every entry under `path`
    to the notification.toml sink — used to prime a fresh downstream
    consumer with the existing tree."""
    from ..notification import load_notification_queue
    from ..util.config import load_configuration

    queue = load_notification_queue(load_configuration("notification"))
    if queue is None:
        raise RpcError("no notification sink configured "
                       "(weed scaffold -config=notification)", 400)
    filer = find_filer(env)
    sent = 0

    def walk(p: str):
        nonlocal sent
        for e in _list(filer, p, metadata=True):
            full = p.rstrip("/") + "/" + _name(e)
            # flat MetaEvent shape (filer.MetaEvent.to_dict) — the same
            # records the filer's own queue emits, so replicator /
            # aggregator consumers see a normal create event
            queue.send(full, {
                "ts_ns": time.time_ns(),
                "directory": p.rstrip("/") or "/",
                "old_entry": None,
                "new_entry": e,
            })
            sent += 1
            if _is_dir(e):
                walk(full)

    try:
        walk(resolve_path(env, path))
    finally:
        queue.close()  # flush buffered events even on a mid-walk error
    return {"notified": sent}


# -- s3.bucket.quota / s3.bucket.quota.enforce -------------------------------
# (command_s3_bucket_quota.go, command_s3_bucket_quota_check.go) — quota
# rides the bucket's filer-conf rule; enforce compares the bucket
# collection's physical size from the master topology and toggles the
# rule's read_only flag

def _load_conf_locations(filer: str) -> list[dict]:
    from ..filer.filer_conf import FILER_CONF_PATH

    return _get_json_config(filer, FILER_CONF_PATH) \
        .get("locations", []) or []


def _save_conf_locations(filer: str, locations: list[dict]) -> None:
    from ..filer.filer_conf import FILER_CONF_PATH

    call(filer, urllib.parse.quote(FILER_CONF_PATH),
         raw=json.dumps({"locations": locations}, indent=2).encode(),
         method="POST")


def s3_bucket_quota(env: CommandEnv, name: str, op: str = "set",
                    size_mb: int = 0) -> dict:
    """set/get/remove/enable/disable a bucket's quota (stored as
    quota_mb on the bucket's path rule; negative means disabled)."""
    if not name:
        raise RpcError("empty bucket name", 400)
    filer = find_filer(env)
    prefix = f"{BUCKETS_ROOT}/{name}/"
    locations = _load_conf_locations(filer)
    rule = next((r for r in locations
                 if r.get("location_prefix") == prefix), None)
    current = int(rule.get("quota_mb", 0)) if rule else 0
    if op == "get":
        return {"bucket": name, "quota_mb": current}
    if op == "set":
        new = size_mb
    elif op == "remove":
        new = 0
    elif op == "enable":
        new = abs(current)
    elif op == "disable":
        new = -abs(current)
    else:
        raise RpcError(f"unknown op {op!r} "
                       "(set|get|remove|enable|disable)", 400)
    locations = [r for r in locations
                 if r.get("location_prefix") != prefix]
    if rule is None:
        rule = {"location_prefix": prefix}
    if new:
        rule["quota_mb"] = new
    else:
        rule.pop("quota_mb", None)
    if new <= 0 and rule.get("quota_read_only"):
        # removing/disabling the quota lifts an enforcement-set
        # read_only — enforce won't revisit a rule with no quota
        rule.pop("quota_read_only", None)
        rule.pop("read_only", None)
    # keep the rule if it still says anything
    if len(rule) > 1:
        locations.append(rule)
    _save_conf_locations(filer, locations)
    return {"bucket": name, "quota_mb": new}


def s3_bucket_quota_enforce(env: CommandEnv, apply: bool = False) -> dict:
    """Compare each bucket collection's physical size to its quota; over
    quota -> mark the bucket rule read_only (with -apply), under quota ->
    clear a read_only this command set."""
    filer = find_filer(env)
    status = env.master("/dir/status")
    sizes: dict[str, int] = {}
    for dc in status.get("datacenters", []):
        for rack in dc.get("racks", []):
            for node in rack.get("nodes", []):
                for v in node.get("volume_list", []):
                    col = v.get("collection", "")
                    sizes[col] = sizes.get(col, 0) + int(v.get("size", 0))
    locations = _load_conf_locations(filer)
    report, changed = [], False
    for rule in locations:
        prefix = rule.get("location_prefix", "")
        quota_mb = int(rule.get("quota_mb", 0))
        # rules with an enforcement-set read_only stay in scope even
        # after the quota is removed, so the flag can be cleared
        if not prefix.startswith(f"{BUCKETS_ROOT}/") or \
                (quota_mb <= 0 and not rule.get("quota_read_only")):
            continue
        bucket = prefix[len(BUCKETS_ROOT) + 1:].strip("/")
        used = sizes.get(bucket, 0)
        over = quota_mb > 0 and used > quota_mb << 20
        report.append({"bucket": bucket, "quota_mb": quota_mb,
                       "used_bytes": used, "over": over,
                       "read_only": rule.get("read_only", False)})
        if over and not rule.get("read_only"):
            rule["read_only"] = True
            rule["quota_read_only"] = True  # we set it; we may clear it
            changed = True
        elif not over and rule.get("quota_read_only"):
            rule["read_only"] = False
            rule.pop("quota_read_only", None)
            changed = True
    if changed and apply:
        _save_conf_locations(filer, locations)
    return {"buckets": report, "applied": bool(changed and apply)}


# -- s3.circuitbreaker (command_s3_circuitbreaker.go) ------------------------

def s3_circuitbreaker(env: CommandEnv, actions: str = "",
                      values: str = "", buckets: str = "",
                      enable: Optional[bool] = None,
                      delete: bool = False) -> dict:
    """Read or edit /etc/s3/circuit_breaker.json through the filer.

    actions: comma list like "Read:Count,Write:MB"; values: matching
    comma list of limits; buckets: comma list to scope the edit (global
    when empty)."""
    from ..s3api.circuit_breaker import CONFIG_PATH

    filer = find_filer(env)
    config = _get_json_config(filer, CONFIG_PATH)
    if actions or enable is not None or delete:
        targets = ([("buckets", b) for b in buckets.split(",") if b]
                   or [("global", None)])
        acts = [a for a in actions.split(",") if a]
        vals = [int(v) for v in values.split(",") if v] if values else []
        if acts and not delete and len(acts) != len(vals):
            raise RpcError("actions and values must pair up", 400)
        for scope, bucket in targets:
            if scope == "global":
                node = config.setdefault("global", {})
            else:
                node = config.setdefault("buckets", {}) \
                    .setdefault(bucket, {})
            if delete:
                for a in acts or list(node.get("actions", {})):
                    node.get("actions", {}).pop(a, None)
            else:
                for a, v in zip(acts, vals):
                    node.setdefault("actions", {})[a] = v
            if enable is not None:
                node["enabled"] = enable
            elif "enabled" not in node:
                node["enabled"] = True
        call(filer, urllib.parse.quote(CONFIG_PATH),
             raw=json.dumps(config, indent=2).encode(), method="POST")
    return config
