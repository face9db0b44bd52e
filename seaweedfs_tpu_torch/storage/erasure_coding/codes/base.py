"""Code-family base: the contract every erasure-code family implements.

A family is a (data_shards, parity_shards, sub_shards) geometry plus the
GF(2^8) matrices that drive it:

- ``encode_matrix()``: the full systematic generator over *lanes*.  A shard
  is split into ``sub_shards`` (alpha) interleaved lanes — byte t of a block
  belongs to lane ``t % alpha`` — so the generator is
  ``(total*alpha, data*alpha)`` with the top ``data*alpha`` rows the
  identity.  Scalar codes (RS) have alpha == 1 and this degenerates to the
  classic ``(total, data)`` matrix.
- ``decode_rows(survivors, targets)``: the decode planner.  Given exactly
  ``data_shards`` survivors (any mix of data and parity) it returns the
  matrix mapping the survivor lane stack straight to the target shards'
  lanes — one GF mat-vec per degraded span, never a full Reconstruct.
  Plans are cached per family.

Everything here is host-side NumPy; the GF apply itself runs in
`ops.codec.reconstruct_span` (kernel K1 on the card).  Projection repair
(regenerating codes) comes with the families that need it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ....ops import gf256
from ....ops.rs_numpy import ReconstructError

PLAN_CACHE_SIZE = 4096


class CodeFamily:
    """Base class; subclasses set the geometry and the generator matrix."""

    name = "?"
    data_shards = 0
    parity_shards = 0
    sub_shards = 1       # alpha: lanes per shard (1 for scalar MDS codes)

    def __init__(self):
        self._plan_lock = threading.Lock()
        self._plans = OrderedDict()

    # -- geometry -----------------------------------------------------------

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    def check_block(self, nbytes: int) -> None:
        if nbytes % self.sub_shards:
            raise ReconstructError(
                f"{self.name}: block of {nbytes} bytes is not divisible by "
                f"sub_shards={self.sub_shards}")

    # -- matrices -----------------------------------------------------------

    def encode_matrix(self) -> np.ndarray:
        """(total*alpha, data*alpha) systematic generator, read-only."""
        raise NotImplementedError

    def parity_matrix(self) -> np.ndarray:
        """The parity lane rows ((total-data)*alpha, data*alpha)."""
        return self.encode_matrix()[self.data_shards * self.sub_shards:]

    # -- lane interleaving ---------------------------------------------------
    # Byte t of a block belongs to lane t % alpha.  Because every block size
    # the striper produces is divisible by alpha, lane index is uniform over
    # the whole shard file and any alpha-aligned range is self-contained.

    def to_lanes(self, arr: np.ndarray) -> np.ndarray:
        """(m, L) byte rows -> (m*alpha, L/alpha) lane rows."""
        a = self.sub_shards
        if a == 1:
            return arr
        m, length = arr.shape
        self.check_block(length)
        return (arr.reshape(m, length // a, a).swapaxes(1, 2)
                .reshape(m * a, length // a))

    def from_lanes(self, lanes: np.ndarray) -> np.ndarray:
        """(m*alpha, W) lane rows -> (m, W*alpha) byte rows."""
        a = self.sub_shards
        if a == 1:
            return lanes
        ma, width = lanes.shape
        m = ma // a
        return (lanes.reshape(m, a, width).swapaxes(1, 2)
                .reshape(m, width * a))

    # -- decode planner ------------------------------------------------------

    def decode_rows(self, survivors, targets) -> np.ndarray:
        """(len(targets)*alpha, data*alpha) decode matrix: maps the lane
        stack of exactly ``data_shards`` survivors (in the given order) to
        the targets' lanes.  Cached per (survivors, targets)."""
        survivors = tuple(int(s) for s in survivors)
        targets = tuple(int(t) for t in targets)
        key = (survivors, targets)
        with self._plan_lock:
            rows = self._plans.get(key)
            if rows is not None:
                self._plans.move_to_end(key)
                return rows
        rows = self._build_decode_rows(survivors, targets)
        rows = np.ascontiguousarray(rows)
        rows.setflags(write=False)
        with self._plan_lock:
            self._plans[key] = rows
            while len(self._plans) > PLAN_CACHE_SIZE:
                self._plans.popitem(last=False)
        return rows

    def _build_decode_rows(self, survivors, targets) -> np.ndarray:
        """Generic planner: invert the survivors' lane submatrix."""
        k, a = self.data_shards, self.sub_shards
        if len(survivors) != k:
            raise ReconstructError(
                f"{self.name}: decode plan needs exactly {k} survivors, "
                f"got {len(survivors)}")
        full = self.encode_matrix()
        for t in targets:
            if not 0 <= t < self.total_shards:
                raise ReconstructError(f"target shard {t} out of range")
        if survivors == tuple(range(k)):
            inv = None  # identity submatrix: skip the inversion entirely
        else:
            lane_rows = [s * a + lane for s in survivors for lane in range(a)]
            try:
                inv = gf256.gf_invert(full[lane_rows])
            except np.linalg.LinAlgError:
                raise ReconstructError(
                    f"{self.name}: survivor set {survivors} is singular")
        rows = []
        for t in targets:
            tr = full[t * a:(t + 1) * a]
            rows.append(tr if inv is None else gf256.gf_matmul(tr, inv))
        return np.concatenate(rows)
