"""GF(2^8) arithmetic and matrix algebra for Reed-Solomon coding.

Field: GF(2^8) with the generating polynomial x^8+x^4+x^3+x^2+1 (0x11D) and
generator element 2, the field of klauspost/reedsolomon and Backblaze's
JavaReedSolomon.  Matrices built here equal the JAX package's
(`seaweedfs_tpu/ops/gf256.py`) entry for entry, so parity is bit-identical
across the two packages and the reference's shards.

Host-side NumPy only; the CUDA kernels in rs_cuda.py consume the small
product tables built from these matrices.
"""

from __future__ import annotations

import functools

import numpy as np

FIELD_SIZE = 256
GENERATING_POLYNOMIAL = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
GENERATOR = 2


def _generate_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables; exp is doubled (510 entries) to skip the mod 255."""
    exp = np.zeros(510, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GENERATING_POLYNOMIAL
    exp[255:510] = exp[0:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _generate_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[LOG_TABLE[a] + LOG_TABLE[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_inverse(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP_TABLE[(255 - LOG_TABLE[a]) % 255])


def gf_exp(a: int, n: int) -> int:
    """a**n in the field, as klauspost's galExp (n==0 -> 1, a==0 -> 0)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table (64 KiB)."""
    table = EXP_TABLE[(LOG_TABLE[:, None] + LOG_TABLE[None, :]) % 255]
    table = table.astype(np.uint8)
    table[0, :] = 0
    table[:, 0] = 0
    table.setflags(write=False)
    return table


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8). a: (m, k) uint8, b: (k, n) uint8."""
    products = mul_table()[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(products, axis=1)


def gf_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def gf_invert(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination."""
    n = m.shape[0]
    if m.shape[1] != n:
        raise ValueError(f"cannot invert non-square matrix {m.shape}")
    work = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)],
                          axis=1)
    mt = mul_table()
    for r in range(n):
        if work[r, r] == 0:
            for below in range(r + 1, n):
                if work[below, r] != 0:
                    work[[r, below]] = work[[below, r]]
                    break
            else:
                raise np.linalg.LinAlgError("matrix is singular over GF(2^8)")
        work[r] = mt[gf_inverse(int(work[r, r])), work[r]]
        for other in range(n):
            if other != r and work[other, r] != 0:
                work[other] ^= mt[int(work[other, r]), work[r]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r, c] = r**c in GF(2^8), the klauspost/Backblaze construction."""
    vm = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            vm[r, c] = gf_exp(r, c)
    return vm


@functools.lru_cache(maxsize=32)
def build_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic encoding matrix, identical to klauspost's buildMatrix:
    vm @ inv(vm[:data]), so rows 0..data-1 are the identity and rows
    data..total-1 generate parity."""
    vm = vandermonde(total_shards, data_shards)
    m = gf_matmul(vm, gf_invert(vm[:data_shards]))
    m.setflags(write=False)
    return m


def parity_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """The parity rows ((total-data) x data) of the encoding matrix."""
    return build_matrix(data_shards, total_shards)[data_shards:]


def cauchy_matrix(xs: tuple[int, ...], ys: tuple[int, ...]) -> np.ndarray:
    """Cauchy matrix C[i, j] = 1 / (xs[i] + ys[j]) over GF(2^8).  xs and
    ys must be disjoint (no zero denominator); every square submatrix of
    a Cauchy matrix is then invertible, so [I; C] is an MDS generator."""
    if set(xs) & set(ys):
        raise ValueError("cauchy_matrix: xs and ys must be disjoint")
    c = np.zeros((len(xs), len(ys)), dtype=np.uint8)
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            c[i, j] = gf_inverse(x ^ y)
    return c


@functools.lru_cache(maxsize=32)
def build_cauchy_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic [I; C] generator with ys = 0..data-1, xs = data..total-1."""
    ys = tuple(range(data_shards))
    xs = tuple(range(data_shards, total_shards))
    m = np.concatenate([gf_identity(data_shards), cauchy_matrix(xs, ys)])
    m.setflags(write=False)
    return m


def cauchy_inverse(xs: tuple[int, ...], ys: tuple[int, ...]) -> np.ndarray:
    """Closed-form inverse of the square Cauchy matrix 1/(xs[i] + ys[j]):

    B[j, i] = prod_k(xs[i]+ys[k]) * prod_k(xs[k]+ys[j])
              / ((xs[i]+ys[j]) * prod_{k!=i}(xs[i]+xs[k])
                 * prod_{k!=j}(ys[j]+ys[k]))

    O(e^2) products per entry, no Gauss-Jordan sweep."""
    e = len(xs)
    if len(ys) != e:
        raise ValueError("cauchy_inverse: needs a square system")
    inv = np.zeros((e, e), dtype=np.uint8)
    for i in range(e):
        for j in range(e):
            num = 1
            for k in range(e):
                num = gf_mul(num, xs[i] ^ ys[k])
                num = gf_mul(num, xs[k] ^ ys[j])
            den = xs[i] ^ ys[j]
            for k in range(e):
                if k != i:
                    den = gf_mul(den, xs[i] ^ xs[k])
                if k != j:
                    den = gf_mul(den, ys[j] ^ ys[k])
            inv[j, i] = gf_div(num, den)
    return inv


def coeff_bit_matrix(coeffs: np.ndarray) -> np.ndarray:
    """Expand a (p, d) GF(2^8) matrix to its (p*8, d*8) GF(2) form:
    B[i*8+r, j*8+s] = bit r of gf_mul(coeffs[i, j], 1 << s)."""
    p, d = coeffs.shape
    powers = (1 << np.arange(8)).astype(np.uint8)
    prod = mul_table()[coeffs[:, :, None], powers[None, None, :]]  # (p,d,s)
    bits = (prod[:, :, :, None] >> np.arange(8)) & 1  # (p, d, s, r)
    return np.ascontiguousarray(
        bits.transpose(0, 3, 1, 2).reshape(p * 8, d * 8)).astype(np.uint8)
