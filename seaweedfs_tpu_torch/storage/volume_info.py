""".vif sidecar: persisted per-volume info next to the .dat.

The reference persists a VolumeInfo protobuf (version, replica placement,
tiered-file locations) as <volume>.vif via SaveVolumeInfo
(weed/storage/volume_info/volume_info.go:83); JSON here, same role: the
sidecar survives EC encode (the .dat is deleted) so decode/rebuild know the
needle version, and it carries remote-tier file locations.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class RemoteFile:
    backend_type: str = ""
    backend_id: str = ""
    key: str = ""
    offset: int = 0
    file_size: int = 0
    modified_time: int = 0
    extension: str = ""

    def to_dict(self) -> dict:
        return {"backend_type": self.backend_type,
                "backend_id": self.backend_id, "key": self.key,
                "offset": self.offset, "file_size": self.file_size,
                "modified_time": self.modified_time,
                "extension": self.extension}

    @classmethod
    def from_dict(cls, d: dict) -> "RemoteFile":
        return cls(**{k: d.get(k, getattr(cls, k, ""))
                      for k in ("backend_type", "backend_id", "key", "offset",
                                "file_size", "modified_time", "extension")})


@dataclass
class VolumeInfo:
    version: int = 3
    replica_placement: str = "000"
    ttl: str = ""
    compaction_revision: int = 0
    files: list[RemoteFile] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"version": self.version,
                "replica_placement": self.replica_placement,
                "ttl": self.ttl,
                "compaction_revision": self.compaction_revision,
                "files": [f.to_dict() for f in self.files]}


def save_volume_info(path: str, info: VolumeInfo):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info.to_dict(), f, indent=1)
    os.replace(tmp, path)


def load_volume_info(path: str) -> VolumeInfo | None:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    return VolumeInfo(
        version=int(d.get("version", 3)),
        replica_placement=str(d.get("replica_placement", "000")),
        ttl=str(d.get("ttl", "")),
        compaction_revision=int(d.get("compaction_revision", 0)),
        files=[RemoteFile.from_dict(x) for x in d.get("files", [])])
