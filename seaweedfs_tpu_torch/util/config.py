"""TOML configuration with WEED_* environment overrides.

The reference loads {security,filer,master,replication,notification}.toml
via viper from ., ~/.seaweedfs/, /etc/seaweedfs/ with env-var overrides of
the form WEED_SECTION_KEY (weed/command/scaffold.go:15-60,
weed/util/config.go).  Python 3.11+ ships tomllib, so parsing is stdlib.

The port's own copy of the configuration half of
seaweedfs_tpu/util/config.py; ``scaffold`` (the config templates of
`weed scaffold`) waits for the filer (ROADMAP item 9).
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
