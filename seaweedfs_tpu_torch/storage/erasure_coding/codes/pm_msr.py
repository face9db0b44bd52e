"""Product-matrix MSR (14, 5): repair-optimal regenerating code.

Rashmi-Shah-Kumar product-matrix construction at the canonical d = 2k-2
point (IT Trans. 2011), instantiated over GF(2^8) as:

    n = 14 shards, k = 5 data shards, d = 8 repair helpers,
    alpha = 4 sub-shards per shard, B = k * alpha = 20 message symbols.

MSR codes cannot exist above rate ~1/2 at d = 2k-2, so this family trades
capacity (2.8x storage overhead vs RS(10,4)'s 1.4x) for repair bandwidth:
rebuilding one lost shard reads a 1/alpha-size projection from each of d
helpers, d/alpha = 2 bytes moved per rebuilt byte instead of 10.  That is
the cold/archival point of the policy knob, not a replacement for RS on
hot data.

Construction (all arithmetic in GF(2^8), evaluation points theta_i = i):

    Psi_i = (1, theta_i, ..., theta_i^(d-1))          encoding row, node i
    phi_i = (1, theta_i, ..., theta_i^(alpha-1))      first half of Psi_i
    lambda_i = theta_i^alpha                           all distinct because
                                                       gcd(alpha, 255) = 1
    M = [S1; S2], S1/S2 symmetric alpha x alpha holding the B message
    symbols; node i stores w_i = Psi_i M = phi_i S1 + lambda_i phi_i S2.

The raw map A: message params -> all n*alpha stored symbols is made
systematic by precoding with the inverse of its top k*alpha block, so data
shards hold plain volume bytes and undegraded reads never touch the code.

Repair of node f from any d helpers: helper h ships the alpha->1 projection
w_h . phi_f; stacking the d projections gives Psi_H (M phi_f), and because
Psi_H is Vandermonde it is invertible, yielding M phi_f = (S1 phi_f,
S2 phi_f), whence w_f = S1 phi_f + lambda_f S2 phi_f by symmetry of S1/S2.
The combine matrix below is exactly [I | lambda_f I] Psi_H^-1.
"""

from __future__ import annotations

import functools

import numpy as np

from ....ops import gf256
from ....ops.rs_numpy import ReconstructError
from .base import CodeFamily, RepairPlan


def _theta(i: int) -> int:
    return i


def _phi(i: int, alpha: int) -> list:
    return [gf256.gf_exp(_theta(i), c) for c in range(alpha)]


def _lambda(i: int, alpha: int) -> int:
    return gf256.gf_exp(_theta(i), alpha)


@functools.lru_cache(maxsize=4)
def _raw_and_generator(k: int, total: int, alpha: int):
    """Build A (raw param->symbol map) and the systematic generator G.

    The B = k*alpha message parameters are the free entries of the two
    symmetric alpha x alpha matrices S1, S2 (alpha*(alpha+1)/2 each).
    Row (i*alpha + s) of A is the coefficient vector of stored symbol s of
    node i:  w_i[s] = sum_r phi_i[r] S1[r, s] + lambda_i sum_r phi_i[r]
    S2[r, s], where S[r, s] is the parameter indexed by the sorted pair.
    """
    pairs = [(a, b) for a in range(alpha) for b in range(alpha) if a <= b]
    npairs = len(pairs)
    nparams = 2 * npairs
    if nparams != k * alpha:
        raise ValueError("pm_msr geometry mismatch: B != k*alpha")
    raw = np.zeros((total * alpha, nparams), dtype=np.uint8)
    for i in range(total):
        phi = _phi(i, alpha)
        lam = _lambda(i, alpha)
        for s in range(alpha):
            row = raw[i * alpha + s]
            for which in range(2):
                scale = 1 if which == 0 else lam
                for p, (a, b) in enumerate(pairs):
                    # S[r, s] with sorted (r, s) == (a, b): r = a when s = b,
                    # r = b when s = a (one term only when a == b)
                    coeff = 0
                    if s == b:
                        coeff ^= phi[a]
                    if s == a and a != b:
                        coeff ^= phi[b]
                    row[which * npairs + p] = gf256.gf_mul(scale, coeff)
    precode = gf256.gf_invert(raw[:k * alpha])
    gen = gf256.gf_matmul(raw, precode)
    gen.setflags(write=False)
    return raw, gen


class ProductMatrixMSR(CodeFamily):
    name = "pm_msr"
    data_shards = 5
    parity_shards = 9
    sub_shards = 4
    repair_helpers = 8  # d = 2k - 2

    def encode_matrix(self):
        return _raw_and_generator(self.data_shards, self.total_shards,
                                  self.sub_shards)[1]

    def repair_plan(self, lost: int, alive) -> RepairPlan:
        lost = int(lost)
        if not 0 <= lost < self.total_shards:
            raise ReconstructError(f"shard {lost} out of range")
        helpers = tuple(sorted(int(s) for s in alive if int(s) != lost))
        if len(helpers) < self.repair_helpers:
            # not enough helpers for the bandwidth-optimal path: the MDS
            # decode plan (any k survivors)
            return super().repair_plan(lost, helpers)
        helpers = helpers[:self.repair_helpers]
        frac = 1.0 / self.sub_shards
        return RepairPlan(
            kind="projection", lost=lost,
            reads=tuple((h, frac) for h in helpers),
            vector=tuple(_phi(lost, self.sub_shards)),
            combine=self._combine_matrix(lost, helpers))

    @functools.lru_cache(maxsize=256)
    def _combine_matrix(self, lost: int, helpers: tuple) -> np.ndarray:
        """(alpha, d) matrix: [I | lambda_lost I] Psi_helpers^-1."""
        a, d = self.sub_shards, self.repair_helpers
        psi = np.zeros((d, d), dtype=np.uint8)
        for r, h in enumerate(helpers):
            for c in range(d):
                psi[r, c] = gf256.gf_exp(_theta(h), c)
        try:
            psi_inv = gf256.gf_invert(psi)
        except np.linalg.LinAlgError:
            raise ReconstructError(f"pm_msr: helper set {helpers} singular")
        lam = _lambda(lost, a)
        sel = np.zeros((a, d), dtype=np.uint8)
        for r in range(a):
            sel[r, r] = 1
            sel[r, a + r] = lam
        out = gf256.gf_matmul(sel, psi_inv)
        out.setflags(write=False)
        return out

    def decode_kind(self) -> str:
        return ("lane-block inversion (cached); single-shard repair via "
                "d-helper projections")
