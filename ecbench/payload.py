"""The data a run stores and reads back, made from the run's seed.

The layout (how many needles, their ids, sizes and popularity ranks) comes
from a fixed generator, so every seed stores the same sizes in the same
places; the seed makes the bytes and the cookies.  The payloads are one
blob from the seed's generator, needle i's bytes a slice of it, so the
benchmark holds every expected byte without a second copy.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .schedule import seed_rng

LAYOUT_SEED = 0x5EAF_0EC


class NeedleSet:
    """Needles of log-uniform sizes in [min_size, max_size] until
    `total_bytes`: ascending sparse ids, a fixed scrambled popularity
    order (rank r is needle by_rank[r]), and the seed's bytes and
    cookies."""

    def __init__(self, total_bytes: int, min_size: int, max_size: int,
                 seed: int):
        lay = np.random.default_rng(LAYOUT_SEED)
        sizes, total = [], 0
        lo, hi = np.log(min_size), np.log(max_size)
        while total < total_bytes:
            s = int(np.exp(lay.uniform(lo, hi)))
            sizes.append(s)
            total += s
        n = len(sizes)
        self.sizes = np.array(sizes, dtype=np.int64)
        self.ids = np.cumsum(lay.integers(1, 1000, n)).astype(np.int64)
        self.by_rank = lay.permutation(n)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])
        rng = seed_rng(seed)
        self.cookies = rng.integers(1, 1 << 32, n, dtype=np.int64)
        self.blob = rng.bytes(int(self.sizes.sum()))

    def __len__(self) -> int:
        return len(self.sizes)

    def data(self, i: int) -> memoryview:
        off = int(self.offsets[i])
        return memoryview(self.blob)[off:off + int(self.sizes[i])]

    def digest(self, i: int) -> str:
        return hashlib.blake2b(self.data(i), digest_size=16).hexdigest()
