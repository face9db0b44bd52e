"""Cauchy MDS (10, 4): same geometry as RS, cheaper decode planning.

Generator is the systematic [I; C] with C[i, j] = 1/(x_i + y_j), y_j = j for
the data shards and x_i = 10 + i for the parity shards (disjoint sets, so
every square submatrix of C is invertible: MDS by construction).

The planner never runs a k x k Gauss-Jordan sweep: with e erased data shards
the survivor system reduces to an e x e Cauchy subsystem whose inverse has a
closed form (``gf256.cauchy_inverse``), so plan construction is O(e^2 * k)
instead of O(k^3).  Plans are bit-identical to brute-force inversion of the
same generator, just cheaper to build.
"""

from __future__ import annotations

import numpy as np

from ....ops import gf256
from ....ops.rs_numpy import ReconstructError
from .base import CodeFamily


class CauchyMDS(CodeFamily):
    name = "cauchy"
    data_shards = 10
    parity_shards = 4

    def encode_matrix(self):
        return gf256.build_cauchy_matrix(self.data_shards, self.total_shards)

    def _build_decode_rows(self, survivors, targets):
        k = self.data_shards
        if len(survivors) != k:
            raise ReconstructError(
                f"cauchy: decode plan needs exactly {k} survivors, "
                f"got {len(survivors)}")
        for t in targets:
            if not 0 <= t < self.total_shards:
                raise ReconstructError(f"target shard {t} out of range")
        full = self.encode_matrix()
        mt = gf256.mul_table()
        sset = set(survivors)
        col = {s: i for i, s in enumerate(survivors)}
        data_surv = [s for s in survivors if s < k]
        par_surv = [s for s in survivors if s >= k]
        missing = [m for m in range(k) if m not in sset]
        # |survivors| == k forces |par_surv| == |missing|: the erased data
        # shards are recovered through an e x e Cauchy subsystem
        #   sum_m C[p_i, m] x_m = parity(p_i) + sum_d C[p_i, d] x_d
        # whose inverse B is closed-form, no Gauss-Jordan.
        rec = {}
        if missing:
            binv = gf256.cauchy_inverse(tuple(par_surv), tuple(missing))
            for j, m in enumerate(missing):
                row = np.zeros(k, dtype=np.uint8)
                for i, p in enumerate(par_surv):
                    row[col[p]] = binv[j, i]
                for d in data_surv:
                    acc = 0
                    for i, p in enumerate(par_surv):
                        acc ^= int(mt[binv[j, i], full[p, d]])
                    row[col[d]] = acc
                rec[m] = row
        rows = []
        for t in targets:
            if t in sset:
                row = np.zeros(k, dtype=np.uint8)
                row[col[t]] = 1
            elif t < k:
                row = rec[t]
            else:
                # missing parity: its encode row composed over recovered data
                row = np.zeros(k, dtype=np.uint8)
                for d in data_surv:
                    row[col[d]] = full[t, d]
                for m in missing:
                    c = int(full[t, m])
                    if c:
                        row = row ^ mt[c, rec[m]]
            rows.append(row)
        return np.stack(rows)

    def decode_kind(self) -> str:
        return "cauchy closed-form inverse (O(e^2) plans)"
