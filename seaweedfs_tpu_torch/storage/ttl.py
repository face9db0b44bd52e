"""Time-to-live encoding: 1 count byte + 1 unit byte on disk.

Wire/disk-compatible with the reference's weed/storage/needle/volume_ttl.go:
units minute/hour/day/week/month/year stored as 1..6, empty as (0, 0).
"""

from __future__ import annotations

from dataclasses import dataclass

EMPTY_BYTES = b"\x00\x00"

_UNITS = {  # stored byte -> (suffix, minutes)
    1: ("m", 1),
    2: ("h", 60),
    3: ("d", 60 * 24),
    4: ("w", 60 * 24 * 7),
    5: ("M", 60 * 24 * 30),
    6: ("y", 60 * 24 * 365),
}
_SUFFIXES = {s: b for b, (s, _) in _UNITS.items()}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = 0

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """"3m"/"4h"/"5d"/"6w"/"7M"/"8y"; bare digits mean minutes."""
        if not s:
            return EMPTY_TTL
        unit_ch = s[-1]
        if unit_ch.isdigit():
            return cls(count=int(s), unit=_SUFFIXES["m"])
        if unit_ch not in _SUFFIXES:
            raise ValueError(f"unknown ttl unit {unit_ch!r}")
        return cls(count=int(s[:-1]), unit=_SUFFIXES[unit_ch])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return EMPTY_TTL
        return cls(count=b[0], unit=b[1])

    @classmethod
    def from_uint32(cls, v: int) -> "TTL":
        return cls.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_uint32(self) -> int:
        if self.count == 0:
            return 0
        return (self.count << 8) | self.unit

    def minutes(self) -> int:
        if self.unit not in _UNITS:
            return 0
        return self.count * _UNITS[self.unit][1]

    def __str__(self) -> str:
        if self.count == 0 or self.unit not in _UNITS:
            return ""
        return f"{self.count}{_UNITS[self.unit][0]}"

    def __bool__(self) -> bool:
        return self.count != 0 and self.unit in _UNITS


EMPTY_TTL = TTL()
