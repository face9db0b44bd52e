"""Request schedules: seed -> what every load process sends, and when.

The draws are frozen copies of the port's load generator
(seaweedfs_tpu_torch/loadgen/generators.py: `_unit`, `ZipfPopularity`,
and `poisson_arrivals`' inverse transform of exponential gaps): every
uniform is blake2b("{seed}:{stream}:{n}") mapped to [0, 1), so a
schedule is a pure function of its arguments.

One rule keeps runs of different seeds comparable: the seed never
changes the work, only its order.  The multiset of inter-arrival gaps and
the multiset of key ranks are drawn from fixed streams; the run's seed
permutes both, so every seed sends the same requests of the same sizes at
the same mean rate, in another order.  The data they read is made from
the seed (payload.py).
"""

from __future__ import annotations

import bisect
import hashlib
import math

import numpy as np

FIXED = 0  # the seed of the streams that every run shares


def _unit(seed: int, stream: str, n: int) -> float:
    """The n-th uniform draw of a named stream, in [0, 1)."""
    h = hashlib.blake2b(f"{seed}:{stream}:{n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


class ZipfPopularity:
    """Zipfian popularity: P(rank i) is proportional to 1/(i+1)^s,
    sampled by inverse CDF over the cumulative weights."""

    def __init__(self, n_objects: int, s: float = 0.99, seed: int = 0,
                 stream: str = "zipf"):
        if n_objects <= 0:
            raise ValueError("n_objects must be positive")
        self.n_objects = n_objects
        self.seed = seed
        self.stream = stream
        self._cum: list[float] = []
        total = 0.0
        for i in range(n_objects):
            total += 1.0 / float(i + 1) ** s
            self._cum.append(total)
        self._total = total

    def sample(self, n: int) -> int:
        u = _unit(self.seed, self.stream, n) * self._total
        return min(self.n_objects - 1, bisect.bisect_left(self._cum, u))


def seed_rng(seed: int) -> np.random.Generator:
    """The run's own generator; any integer seed, however large."""
    return np.random.default_rng(int(seed) % (1 << 64))


def open_loop(rate: float, seconds: float, n_keys: int, theta: float,
              seed: int, segment: str = "window",
              offset: float = 0.0) -> list[tuple[float, int]]:
    """(due time, key rank) of every request of one open-loop segment:
    round(rate * seconds) requests from [offset, offset + seconds), with
    Poisson gaps and Zipf(theta) ranks drawn from fixed streams, both in
    the order the seed gives them."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.array([-math.log(1.0 - _unit(FIXED, f"{segment}.gap", i))
                     for i in range(n)])
    # scaled so that the n arrivals and the gap after the last fill the
    # segment: the rate is exact for every seed
    gaps *= seconds / (gaps.sum() * (n + 1) / n)
    zipf = ZipfPopularity(n_keys, theta, FIXED, f"{segment}.rank")
    ranks = np.array([zipf.sample(i) for i in range(n)])
    rng = seed_rng(seed)
    gaps = gaps[rng.permutation(n)]
    ranks = ranks[rng.permutation(n)]
    due = offset + np.cumsum(gaps)
    return list(zip(due.tolist(), ranks.tolist()))

