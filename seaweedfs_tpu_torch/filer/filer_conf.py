"""Per-path filer configuration rules stored inside the filer itself.

Parity with weed/filer/filer_conf.go: a config entry at
/etc/seaweedfs/filer.conf holds a list of path-prefix rules
(collection, replication, ttl, read-only, ...); writes under a prefix pick
up the most-specific (longest) matching rule.  The reference stores
protobuf text; this stores JSON with the same rule fields.

The port's own copy of seaweedfs_tpu/filer/filer_conf.py.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field

from .entry import Attr, Entry
from .filer_store import NotFoundError

FILER_CONF_PATH = "/etc/seaweedfs/filer.conf"  # filer_conf.go FilerConfName


@dataclass
class PathConf:
    location_prefix: str = "/"
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    disk_type: str = ""
    fsync: bool = False
    read_only: bool = False
    max_file_name_length: int = 0
    # erasure-coding code family for volumes in this collection
    # ("rs_vandermonde" / "cauchy" / "pm_msr"; "" = cluster default)
    ec_code: str = ""
    # s3.bucket.quota: MiB budget for the bucket this rule covers
    # (negative = configured but disabled); quota_read_only records that
    # read_only was set BY quota enforcement so it can be auto-cleared
    quota_mb: int = 0
    quota_read_only: bool = False


@dataclass
class FilerConf:
    rules: list[PathConf] = field(default_factory=list)

    def add(self, rule: PathConf):
        self.rules = [r for r in self.rules
                      if r.location_prefix != rule.location_prefix]
        self.rules.append(rule)

    def delete(self, location_prefix: str):
        self.rules = [r for r in self.rules
                      if r.location_prefix != location_prefix]

    def match_path(self, path: str) -> PathConf:
        """Longest-prefix rule wins (filer_conf.go MatchStorageRule)."""
        best = PathConf()
        best_len = -1
        for rule in self.rules:
            prefix = rule.location_prefix
            if path.startswith(prefix) and len(prefix) > best_len:
                best, best_len = rule, len(prefix)
        return best

    def to_bytes(self) -> bytes:
        return json.dumps({"locations": [asdict(r) for r in self.rules]},
                          indent=2).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "FilerConf":
        doc = json.loads(data.decode()) if data else {}
        known = PathConf.__dataclass_fields__
        return cls(rules=[
            PathConf(**{k: v for k, v in r.items() if k in known})
            for r in doc.get("locations", [])])

    # -- persistence in the filer tree --------------------------------------
    def save(self, filer):
        body = self.to_bytes()
        filer.create_entry(Entry(
            full_path=FILER_CONF_PATH,
            attr=Attr(mtime=time.time(), crtime=time.time(),
                      file_size=len(body)),
            content=body))

    @classmethod
    def load(cls, filer) -> "FilerConf":
        try:
            return cls.from_bytes(filer.find_entry(FILER_CONF_PATH).content)
        except NotFoundError:
            return cls()
