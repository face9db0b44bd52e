"""Admin shell: remote.* commands (weed/shell/command_remote_*.go).

All state lives in the filer (/etc/remote/); these commands drive the
filer's /remote/* endpoints.

The port's own copy of seaweedfs_tpu/shell/commands_remote.py.
"""

from __future__ import annotations

from typing import Optional

from ..rpc.http_rpc import call
from .commands import CommandEnv
from .commands_fs import find_filer


def remote_configure(env: CommandEnv, name: str = "", type: str = "s3",
                     endpoint: str = "", access_key: str = "",
                     secret_key: str = "", directory: str = "",
                     delete: bool = False) -> dict:
    if not name:  # bare remote.configure lists configured storages
        return call(find_filer(env), "/remote/list")
    return call(find_filer(env), "/remote/configure", {
        "name": name, "type": type, "endpoint": endpoint,
        "access_key": access_key, "secret_key": secret_key,
        "directory": directory, "delete": delete})


def remote_mount(env: CommandEnv, directory: str = "",
                 remote: str = "") -> dict:
    if not directory:  # bare remote.mount lists mappings
        return call(find_filer(env), "/remote/list").get("mappings", {})
    return call(find_filer(env), "/remote/mount",
                {"dir": directory, "remote": remote}, timeout=600)


def remote_unmount(env: CommandEnv, directory: str) -> dict:
    return call(find_filer(env), "/remote/unmount", {"dir": directory})


def remote_meta_sync(env: CommandEnv, directory: str) -> dict:
    return call(find_filer(env), "/remote/meta_sync",
                {"dir": directory}, timeout=600)


def remote_cache(env: CommandEnv, directory: str) -> dict:
    return call(find_filer(env), "/remote/cache", {"dir": directory},
                timeout=3600)


def remote_uncache(env: CommandEnv, directory: str) -> dict:
    return call(find_filer(env), "/remote/uncache", {"dir": directory},
                timeout=600)


def remote_mount_buckets(env: CommandEnv, remote: str,
                         buckets_dir: str = "/buckets") -> list[dict]:
    """command_remote_mount_buckets.go: mount every bucket of a remote
    under the buckets dir."""
    from ..remote_storage import RemoteLocation

    filer = find_filer(env)
    loc = RemoteLocation.parse(remote)
    # buckets on s3 = top-level listing isn't exposed by the minimal
    # client; mount the named bucket only, or each bucket listed locally
    out = []
    if loc.bucket:
        out.append(remote_mount(env, f"{buckets_dir}/{loc.bucket}",
                                str(loc)))
    return out
