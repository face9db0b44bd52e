"""Reed-Solomon codec base, decode plans and the pure-NumPy backend.

Mirrors the `reedsolomon.Encoder` interface (Encode / Verify / Reconstruct
/ ReconstructData).  Every backend shares the control flow of
`RSCodecBase` and differs only in `_apply`, the GF matrix kernel: NumPy
here, the torch/CUDA one in rs_torch.py.

Shard convention (klauspost's): `shards` is a list of total_shards equal-
length byte buffers, None where a shard is missing; shards 0..data-1 are
data, the rest parity.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf256


class ReconstructError(Exception):
    pass


@functools.lru_cache(maxsize=4096)
def _decode_rows_cached(data_shards: int, total_shards: int,
                        survivors: tuple, targets: tuple) -> np.ndarray:
    """Rows of the decode matrix mapping the ordered survivors straight to
    the target shards: one (t, d) x (d, L) GF mat-vec per span.  When the
    survivors are exactly the data shards no inversion happens."""
    if len(survivors) != data_shards:
        raise ReconstructError(
            f"decode plan needs exactly {data_shards} survivors, "
            f"got {len(survivors)}")
    full = gf256.build_matrix(data_shards, total_shards)
    inv = None
    if list(survivors) != list(range(data_shards)):
        inv = gf256.gf_invert(full[list(survivors)])
    rows = []
    for t in targets:
        if not 0 <= t < total_shards:
            raise ReconstructError(f"target shard {t} out of range")
        if inv is None:
            rows.append(np.eye(data_shards, dtype=np.uint8)[t]
                        if t < data_shards else full[t])
        elif t < data_shards:
            rows.append(inv[t])
        else:
            rows.append(gf256.gf_matmul(full[t:t + 1], inv)[0])
    out = np.stack(rows).astype(np.uint8)
    out.setflags(write=False)  # cached: callers must not mutate
    return out


def decode_rows(data_shards: int, total_shards: int,
                survivors, targets) -> np.ndarray:
    """(len(targets), data_shards) decode matrix for reconstructing
    `targets` from inputs stacked in `survivors` order (read-only)."""
    return _decode_rows_cached(data_shards, total_shards,
                               tuple(int(s) for s in survivors),
                               tuple(int(t) for t in targets))


def decode_plan_cache_info():
    """lru statistics (hits, misses, currsize) of the decode-plan cache."""
    return _decode_rows_cached.cache_info()


def gf_apply_matrix(matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """out[i] = XOR_j mul(matrix[i, j], inputs[j]); (m, k) x (k, L)."""
    mt = gf256.mul_table()
    m, _ = matrix.shape
    out = np.zeros((m, inputs.shape[1]), dtype=np.uint8)
    for j in range(matrix.shape[1]):
        rows = mt[matrix[:, j]]  # (m, 256) lookup rows
        out ^= np.take_along_axis(
            rows, np.broadcast_to(inputs[j], (m, inputs.shape[1])), axis=1)
    return out


class RSCodecBase:
    """RS(data, parity) codec over GF(2^8), klauspost-compatible."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("too many shards for GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = gf256.build_matrix(data_shards, self.total_shards)

    def _apply(self, matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
        """out[i] = XOR_j gf_mul(matrix[i,j], inputs[j]); host uint8."""
        raise NotImplementedError

    def encode(self, shards: list) -> list:
        """Fill parity shards from data shards; returns the full list."""
        arrs = self._as_arrays(shards)
        self._check_shape(arrs, need_all_data=True)
        data = np.stack(arrs[:self.data_shards])
        parity = self._apply(self.matrix[self.data_shards:], data)
        return list(data) + [parity[i] for i in range(self.parity_shards)]

    def verify(self, shards: list) -> bool:
        arrs = self._as_arrays(shards)
        self._check_shape(arrs, need_all=True)
        data = np.stack(arrs[:self.data_shards])
        parity = self._apply(self.matrix[self.data_shards:], data)
        return all(np.array_equal(parity[i], arrs[self.data_shards + i])
                   for i in range(self.parity_shards))

    def reconstruct(self, shards: list) -> list:
        """Fill every missing (None) shard; returns the shard list."""
        return self._reconstruct(shards, data_only=False)

    def reconstruct_data(self, shards: list) -> list:
        """Fill only missing data shards (parity stays None)."""
        return self._reconstruct(shards, data_only=True)

    def _reconstruct(self, shards: list, data_only: bool) -> list:
        arrs = self._as_arrays(shards)
        self._check_shape(arrs)
        present = [i for i, s in enumerate(arrs) if s is not None]
        if len(present) == self.total_shards:
            return arrs
        if len(present) < self.data_shards:
            raise ReconstructError(
                f"too few shards: {len(present)} < {self.data_shards}")
        # klauspost's subset: the first data_shards present shards.  With
        # every data shard present the submatrix is the identity and only
        # parity regenerates below.
        missing_data = [i for i in range(self.data_shards) if arrs[i] is None]
        if missing_data:
            sub_rows = present[:self.data_shards]
            inv = gf256.gf_invert(self.matrix[sub_rows])
            inputs = np.stack([arrs[i] for i in sub_rows])
            regenerated = self._apply(inv[missing_data], inputs)
            for out_i, i in enumerate(missing_data):
                arrs[i] = regenerated[out_i]
        if not data_only:
            missing_parity = [i for i in range(self.data_shards,
                                               self.total_shards)
                              if arrs[i] is None]
            if missing_parity:
                data = np.stack(arrs[:self.data_shards])
                regenerated = self._apply(self.matrix[missing_parity], data)
                for out_i, i in enumerate(missing_parity):
                    arrs[i] = regenerated[out_i]
        return arrs

    @staticmethod
    def _as_arrays(shards: list) -> list:
        out = []
        for s in shards:
            if s is None:
                out.append(None)
            elif isinstance(s, np.ndarray):
                out.append(s.astype(np.uint8, copy=False))
            else:
                out.append(np.frombuffer(s, dtype=np.uint8))
        return out

    def _check_shape(self, arrs: list, need_all: bool = False,
                     need_all_data: bool = False):
        if len(arrs) != self.total_shards:
            raise ValueError(
                f"expected {self.total_shards} shards, got {len(arrs)}")
        length = None
        for i, s in enumerate(arrs):
            if s is None:
                if need_all or (need_all_data and i < self.data_shards):
                    raise ValueError(f"shard {i} missing")
                continue
            if length is None:
                length = len(s)
            elif len(s) != length:
                raise ValueError("shards have differing lengths")
        if length is None:
            raise ValueError("no shards present")


class NumpyEncoder(RSCodecBase):
    """Pure-NumPy reference backend (table-lookup GF math)."""

    def _apply(self, matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
        return gf_apply_matrix(matrix, inputs)
