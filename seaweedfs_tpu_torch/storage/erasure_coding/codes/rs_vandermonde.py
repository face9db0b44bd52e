"""Vandermonde RS(10,4): today's wire format and the default family.

Delegates matrix building and the decode-plan cache to `ops.gf256` and
`ops.rs_numpy`, so family decodes and the codec's own share one plan
cache.
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
