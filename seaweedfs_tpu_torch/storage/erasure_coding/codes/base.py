"""Code-family base: the contract every erasure-code family implements.

A family is a (data_shards, parity_shards, sub_shards) geometry plus the
GF(2^8) matrices that drive it:

- ``encode_matrix()``: the full systematic generator over *lanes*.  A shard
  is split into ``sub_shards`` (alpha) interleaved lanes — byte t of a block
  belongs to lane ``t % alpha`` — so the generator is
  ``(total*alpha, data*alpha)`` with the top ``data*alpha`` rows the
  identity.  Scalar codes (RS, Cauchy) have alpha == 1 and this degenerates
  to the classic ``(total, data)`` matrix.
- ``decode_rows(survivors, targets)``: the decode planner.  Given exactly
  ``data_shards`` survivors (any mix of data and parity) it returns the
  matrix mapping the survivor lane stack straight to the target shards'
  lanes — one GF mat-vec per degraded span, never a full Reconstruct.
  Plans are cached per family, and each family may build its plan with its
  own cheap inversion (closed-form Cauchy, lane-block inversion for MSR).
- ``repair_plan(lost, alive)``: what to *read* to rebuild a shard.  MDS
  scalar codes read k full shards; regenerating codes read small
  projections from d > k helpers instead (``kind == "projection"``).

Everything here is host-side NumPy.  The GF apply is passed in as
``apply_fn`` (the native host kernel, or K1 on the card through
`ops.codec.reconstruct_span` and the pooled parity step).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ....ops import gf256
from ....ops.rs_numpy import ReconstructError, gf_apply_matrix

PLAN_CACHE_SIZE = 4096


@dataclass(frozen=True, eq=False)
class RepairPlan:
    """What to read (and how to combine it) to rebuild ``lost``.

    kind:    "decode"     — read k full survivor shards, run decode_rows.
             "projection" — read a 1/alpha-size projection from each of d
                            helpers; combine with ``combine``.
    reads:   ((shard_id, fraction_of_shard_read), ...) in helper order.
    vector:  helper-side projection vector (alpha,) for "projection" plans:
             each helper ships ``vector @ its_lane_stack``.
    combine: (alpha, d) matrix turning the stacked helper projections into
             the lost shard's lanes.
    """

    kind: str
    lost: int
    reads: tuple
    vector: tuple = None
    combine: np.ndarray = None

    @property
    def helpers(self) -> tuple:
        return tuple(s for s, _ in self.reads)

    @property
    def read_fraction(self) -> float:
        """Total survivor bytes consumed per rebuilt shard (the read amp)."""
        return float(sum(f for _, f in self.reads))


class CodeFamily:
    """Base class; subclasses set the geometry and the generator matrix."""

    name = "?"
    data_shards = 0
    parity_shards = 0
    sub_shards = 1       # alpha: lanes per shard (1 for scalar MDS codes)
    repair_helpers = 0   # d: helpers per projection repair (0: none)

    def __init__(self):
        self._plan_lock = threading.Lock()
        self._plans = OrderedDict()
        self._plan_hits = 0
        self._plan_misses = 0

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

    # -- encode / decode -----------------------------------------------------

    def encode_blocks(self, data: np.ndarray, apply_fn=None) -> np.ndarray:
        """(data_shards, L) data rows -> (parity_shards, L) parity rows."""
        apply_fn = apply_fn or gf_apply_matrix
        lanes = self.to_lanes(np.ascontiguousarray(data))
        par = apply_fn(self.parity_matrix(), np.ascontiguousarray(lanes))
        return np.ascontiguousarray(self.from_lanes(np.asarray(par)))

    def decode_blocks(self, survivors, inputs: np.ndarray, targets,
                      apply_fn=None) -> np.ndarray:
        """Reconstruct ``targets`` from the (k, L) survivor stack."""
        apply_fn = apply_fn or gf_apply_matrix
        rows = self.decode_rows(tuple(survivors), tuple(targets))
        lanes = self.to_lanes(np.ascontiguousarray(inputs))
        out = apply_fn(np.asarray(rows), np.ascontiguousarray(lanes))
        return np.ascontiguousarray(self.from_lanes(np.asarray(out)))

    def choose_survivors(self, alive) -> tuple:
        """Pick the decode read set: lowest shard ids first, so the all-data
        identity fast path is taken whenever the data shards are alive."""
        picked = tuple(sorted(int(s) for s in alive))[:self.data_shards]
        if len(picked) < self.data_shards:
            raise ReconstructError(
                f"{self.name}: need {self.data_shards} survivors, "
                f"have {len(picked)}")
        return picked

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
                self._plan_hits += 1
                self._plans.move_to_end(key)
                return rows
            self._plan_misses += 1
        rows = self._build_decode_rows(survivors, targets)
        rows = np.ascontiguousarray(rows)
        rows.setflags(write=False)
        with self._plan_lock:
            self._plans[key] = rows
            while len(self._plans) > PLAN_CACHE_SIZE:
                self._plans.popitem(last=False)
        return rows

    def _build_decode_rows(self, survivors, targets) -> np.ndarray:
        """Generic planner: invert the survivors' lane submatrix.  Families
        with structure (Cauchy) override this with a cheaper construction."""
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

    def plan_cache_info(self) -> dict:
        with self._plan_lock:
            hits, misses, size = (self._plan_hits, self._plan_misses,
                                  len(self._plans))
        total = hits + misses
        return {"hits": hits, "misses": misses, "size": size,
                "hit_ratio": round(hits / total, 4) if total else None}

    # -- repair -------------------------------------------------------------

    def repair_plan(self, lost: int, alive) -> RepairPlan:
        """Read plan for rebuilding ``lost``.  Base: MDS decode from k full
        survivors.  Regenerating families override with projection plans."""
        alive = [s for s in alive if s != lost]
        chosen = self.choose_survivors(alive)
        return RepairPlan(kind="decode", lost=int(lost),
                          reads=tuple((s, 1.0) for s in chosen))

    def project(self, block: np.ndarray, vector) -> np.ndarray:
        """Helper-side projection: (L,) shard bytes x (alpha,) vector ->
        (L/alpha,) bytes.  Only meaningful when sub_shards > 1."""
        if self.sub_shards == 1:
            raise ReconstructError(
                f"{self.name}: scalar code has no projection repair")
        vec = np.asarray(vector, dtype=np.uint8).reshape(1, self.sub_shards)
        lanes = self.to_lanes(np.asarray(block, dtype=np.uint8).reshape(1, -1))
        return gf_apply_matrix(vec, np.ascontiguousarray(lanes))[0]

    def combine_projections(self, plan: RepairPlan,
                            projections: np.ndarray) -> np.ndarray:
        """(d, W) stacked helper projections -> (alpha*W,) lost shard bytes."""
        if plan.combine is None:
            raise ReconstructError(f"{self.name}: plan has no combine step")
        lanes = gf_apply_matrix(plan.combine,
                                np.ascontiguousarray(projections))
        return self.from_lanes(lanes)[0] if self.sub_shards > 1 else lanes[0]

    # -- introspection -------------------------------------------------------

    def single_repair_read_fraction(self) -> float:
        """Survivor bytes consumed per rebuilt byte for a one-shard repair."""
        if self.repair_helpers:
            return self.repair_helpers / self.sub_shards
        return float(self.data_shards)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "data_shards": self.data_shards,
            "parity_shards": self.parity_shards,
            "total_shards": self.total_shards,
            "sub_shards": self.sub_shards,
            "repair_helpers": self.repair_helpers,
            "single_repair_read_amp": self.single_repair_read_fraction(),
            "decode": self.decode_kind(),
            "plan_cache": self.plan_cache_info(),
        }

    def decode_kind(self) -> str:
        return "lane-block inversion (cached)"
