"""Vandermonde RS(10,4): today's wire format and the default family.

Delegates matrix building and the decode-plan cache to `ops.gf256` and
`ops.rs_numpy`, so family decodes and the codec's own share one plan
cache (and its lru statistics).
"""

from __future__ import annotations

from ....ops import gf256, rs_numpy
from .base import CodeFamily


class RSVandermonde(CodeFamily):
    name = "rs_vandermonde"
    data_shards = 10
    parity_shards = 4

    def encode_matrix(self):
        return gf256.build_matrix(self.data_shards, self.total_shards)

    def decode_rows(self, survivors, targets):
        return rs_numpy.decode_rows(self.data_shards, self.total_shards,
                                    survivors, targets)

    def plan_cache_info(self) -> dict:
        info = rs_numpy.decode_plan_cache_info()
        total = info.hits + info.misses
        return {"hits": info.hits, "misses": info.misses,
                "size": info.currsize,
                "hit_ratio": round(info.hits / total, 4) if total else None}

    def decode_kind(self) -> str:
        return "vandermonde gauss-jordan (shared lru cache)"
