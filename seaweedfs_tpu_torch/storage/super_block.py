"""Volume superblock (first 8 bytes of every .dat) and replica placement.

Byte layout (weed/storage/super_block/super_block.go:16-30):
  0: version | 1: replica placement | 2-3: TTL | 4-5: compaction revision |
  6-7: extra size (reserved; extra bytes follow when nonzero).

Replica placement "xyz" = DiffDataCenter/DiffRack/SameRack counts
(replica_placement.go:8-56).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .needle import CURRENT_VERSION
from .ttl import EMPTY_TTL, TTL

SUPER_BLOCK_SIZE = 8


class SuperBlockError(Exception):
    pass


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack: int = 0
    diff_rack: int = 0
    diff_dc: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        s = (s or "000").rjust(3, "0")
        vals = []
        for ch in s:
            v = int(ch)
            if not 0 <= v <= 2:
                raise ValueError(f"unknown replication type {s!r}")
            vals.append(v)
        return cls(diff_dc=vals[0], diff_rack=vals[1], same_rack=vals[2])

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = EMPTY_TTL
    compaction_revision: int = 0
    extra: bytes = b""

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        struct.pack_into(">H", header, 4, self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise SuperBlockError("super block extra too large")
            struct.pack_into(">H", header, 6, len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @property
    def block_size(self) -> int:
        return SUPER_BLOCK_SIZE + len(self.extra)

    @classmethod
    def from_file(cls, f) -> "SuperBlock":
        """Read from an open binary file positioned anywhere
        (super_block_read.go ReadSuperBlock)."""
        f.seek(0)
        header = f.read(SUPER_BLOCK_SIZE)
        if len(header) != SUPER_BLOCK_SIZE:
            raise SuperBlockError(
                f"cannot read volume super block: got {len(header)} bytes")
        version = header[0]
        if version not in (1, 2, 3):
            raise SuperBlockError(f"unsupported volume version {version}")
        sb = cls(
            version=version,
            replica_placement=ReplicaPlacement.from_byte(header[1]),
            ttl=TTL.from_bytes(header[2:4]),
            compaction_revision=struct.unpack(">H", header[4:6])[0],
        )
        extra_size = struct.unpack(">H", header[6:8])[0]
        if extra_size:
            sb.extra = f.read(extra_size)
            if len(sb.extra) != extra_size:
                raise SuperBlockError("cannot read super block extra")
        return sb
