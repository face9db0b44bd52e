"""Plain GF(2^8) Reed-Solomon reference: the parity of data shards.

The field is GF(2^8) over the polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D)
with generator 2, the field of klauspost/reedsolomon that SeaweedFS's EC
uses.  The encoding matrix is that library's: a (total x data) Vandermonde
matrix, v[r][c] = r^c, times the inverse of its top square, so that the
top rows are the identity and the bottom rows make the parity.

Written from the definitions alone: it imports nothing of the system
under test.  The parity is computed with plain PyTorch gathers on the
given device, in blocks, so that it fits beside whatever else is there.
"""

from __future__ import annotations

import numpy as np
import torch

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def power(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


def mul_table() -> np.ndarray:
    """(256, 256) uint8: mul_table()[a, b] = a * b."""
    a = np.arange(256)
    la = LOG[a][:, None] + LOG[a][None, :]
    t = EXP[la % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def matmul(a: list, b: list) -> list:
    out = []
    for row in a:
        new = []
        for c in range(len(b[0])):
            acc = 0
            for k, x in enumerate(row):
                acc ^= mul(x, b[k][c])
            new.append(acc)
        out.append(new)
    return out


def invert(m: list) -> list:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = len(m)
    work = [list(row) + [int(i == j) for j in range(n)]
            for i, row in enumerate(m)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if work[r][col]), None)
        if pivot is None:
            raise ValueError("singular matrix")
        work[col], work[pivot] = work[pivot], work[col]
        scale = inv(work[col][col])
        work[col] = [mul(scale, x) for x in work[col]]
        for r in range(n):
            if r != col and work[r][col]:
                f = work[r][col]
                work[r] = [x ^ mul(f, y) for x, y in zip(work[r], work[col])]
    return [row[n:] for row in work]


def parity_matrix(data_shards: int = 10, parity_shards: int = 4) -> np.ndarray:
    """(parity, data) uint8: the parity rows of the systematic
    Vandermonde encoding matrix."""
    total = data_shards + parity_shards
    vm = [[power(r, c) for c in range(data_shards)] for r in range(total)]
    top_inv = invert(vm[:data_shards])
    full = matmul(vm, top_inv)
    return np.array(full[data_shards:], dtype=np.uint8)


def apply(matrix: np.ndarray, data: torch.Tensor,
          block: int = 16 << 20) -> torch.Tensor:
    """out[i] = XOR_j matrix[i, j] * data[j]: (p, d) matrix, (d, L) uint8
    tensor -> (p, L) uint8 on data's device, a block of columns at a
    time."""
    p, d = matrix.shape
    if data.dim() != 2 or data.shape[0] != d or data.dtype != torch.uint8:
        raise ValueError(f"expected a ({d}, L) uint8 tensor, got "
                         f"{data.dtype} {tuple(data.shape)}")
    table = torch.from_numpy(mul_table()).to(data.device)
    rows = [[table[int(matrix[i, j])] for j in range(d)] for i in range(p)]
    length = data.shape[1]
    out = torch.empty((p, length), dtype=torch.uint8, device=data.device)
    for c0 in range(0, length, block):
        cols = data[:, c0:c0 + block].long()
        for i in range(p):
            acc = torch.zeros(cols.shape[1], dtype=torch.uint8,
                              device=data.device)
            for j in range(d):
                acc ^= rows[i][j][cols[j]]
            out[i, c0:c0 + block] = acc
    return out
