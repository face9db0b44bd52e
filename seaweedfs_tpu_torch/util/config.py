"""TOML configuration with WEED_* environment overrides + scaffold.

The reference loads {security,filer,master,replication,notification}.toml
via viper from ., ~/.seaweedfs/, /etc/seaweedfs/ with env-var overrides of
the form WEED_SECTION_KEY (weed/command/scaffold.go:15-60,
weed/util/config.go).  Python 3.11+ ships tomllib, so parsing is stdlib.
``scaffold(name)`` emits a commented template like `weed scaffold`.

The port's own copy of seaweedfs_tpu/util/config.py.
"""

from __future__ import annotations

import os
from typing import Any, Optional

try:
    import tomllib
except ModuleNotFoundError:  # tomllib is 3.11+; tomli is its backport
    try:
        import tomli as tomllib
    except ModuleNotFoundError:
        tomllib = None

_SEARCH_DIRS = [".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs"]


class Configuration:
    """Nested-dict TOML view with dotted-key access and env overrides:
    get('jwt.signing.key') checks WEED_JWT_SIGNING_KEY first."""

    def __init__(self, data: Optional[dict] = None, prefix: str = "WEED"):
        self.data = data or {}
        self.prefix = prefix

    def get(self, dotted: str, default: Any = None) -> Any:
        env_key = "%s_%s" % (self.prefix,
                             dotted.upper().replace(".", "_").replace("-", "_"))
        if env_key in os.environ:
            return os.environ[env_key]
        node: Any = self.data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_bool(self, dotted: str, default: bool = False) -> bool:
        v = self.get(dotted, default)
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        return bool(v)

    def get_int(self, dotted: str, default: int = 0) -> int:
        v = self.get(dotted, default)
        return int(v)

    def sub(self, dotted: str) -> "Configuration":
        node = self.get(dotted, {})
        return Configuration(node if isinstance(node, dict) else {},
                             self.prefix)


def load_configuration(name: str, required: bool = False,
                       search_dirs: Optional[list[str]] = None
                       ) -> Configuration:
    """Load <name>.toml from the search path (util.LoadConfiguration)."""
    for d in search_dirs or _SEARCH_DIRS:
        path = os.path.join(d, name + ".toml")
        if os.path.isfile(path):
            if tomllib is None:
                # env overrides still apply via Configuration.get
                return Configuration({})
            with open(path, "rb") as f:
                return Configuration(tomllib.load(f))
    if required:
        raise FileNotFoundError(
            "%s.toml not found in %s" % (name, search_dirs or _SEARCH_DIRS))
    return Configuration({})


_SCAFFOLDS = {
    "security": '''\
# Put this file to one of:
# ./security.toml, $HOME/.seaweedfs/security.toml, /etc/seaweedfs/security.toml
# this file is read by master, volume server, and filer

[jwt.signing]
# generate a 32-byte random key and set it on master + volume servers to
# require a signed token for every write
key = ""
expires_after_seconds = 10

[jwt.signing.read]
key = ""
expires_after_seconds = 60

[access]
# comma-separated IPs/CIDRs allowed to use the admin UI and APIs
ui = ""
''',
    "master": '''\
[master.maintenance]
# periodically run these scripts like a cron job
scripts = """
  ec.encode -fullPercent=95 -quietFor=1h
  ec.rebuild -force
  ec.balance -force
  volume.balance -force
"""
sleep_minutes = 17

[master.sequencer]
type = "raft"  # raft | snowflake
sequencer_snowflake_id = 0

[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1
''',
    "filer": '''\
# Filer store configuration. Exactly one store should be enabled.

[leveldb]
# embedded sorted-key store (sqlite-backed in this implementation)
enabled = true
dir = "./filerldb"

[memory]
# in-RAM store for tests
enabled = false

[redis]
enabled = false
address = "localhost:6379"
''',
    "replication": '''\
[source.filer]
enabled = true
grpcAddress = "localhost:18888"
directory = "/buckets"

[sink.filer]
enabled = false
grpcAddress = "localhost:18888"
directory = "/backup"
replication = ""
collection = ""
ttlSec = 0

[sink.local]
enabled = false
directory = "/data"
''',
    "notification": '''\
[notification.log]
# this is only for debugging purpose and does not work with "weed filer.replicate"
enabled = false

[notification.file]
# append every filer change event as a JSON line to a local file
enabled = false
path = "filer_events.jsonl"

[notification.kafka]
enabled = false
hosts = "kafka1:9092"
topic = "seaweedfs_filer"
''',
}


def scaffold(name: str) -> str:
    if name not in _SCAFFOLDS:
        raise KeyError("unknown config %r (choose from %s)" % (
            name, ", ".join(sorted(_SCAFFOLDS))))
    return _SCAFFOLDS[name]
