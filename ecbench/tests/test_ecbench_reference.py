"""The plain reference against known vectors and against the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ecbench.reference import crc32c, gf256

# the parity rows of RS(10,4) in klauspost/reedsolomon's systematic
# Vandermonde form (the matrix SeaweedFS's EC encodes with)
PARITY = [[129, 150, 175, 184, 210, 196, 254, 232, 3, 2],
          [150, 129, 184, 175, 196, 210, 232, 254, 2, 3],
          [191, 214, 98, 10, 6, 111, 223, 183, 5, 4],
          [214, 191, 10, 98, 111, 6, 183, 223, 4, 5]]


def test_crc32c_check_value():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    assert crc32c.crc32c(b"") == 0


def test_crc32c_continues_and_batches():
    rng = np.random.default_rng(3)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 3000, 20)]
    whole = crc32c.crc32c_many(msgs)
    for m, c in zip(msgs, whole):
        cut = len(m) // 3
        assert crc32c.crc32c(m[cut:], crc=crc32c.crc32c(m[:cut])) == c


def test_crc32c_across_groups(monkeypatch):
    data = np.random.default_rng(4).bytes(70_000)
    want = crc32c.crc32c(data)
    monkeypatch.setattr(crc32c, "GROUP_BYTES", 4096)
    assert crc32c.crc32c(data) == want


def test_crc32c_matches_the_port():
    from seaweedfs_tpu_torch.ops import crc32c as port

    data = np.random.default_rng(5).bytes(100_003)
    assert crc32c.crc32c(data) == port.crc32c(data)


def test_parity_matrix_known_vector():
    assert gf256.parity_matrix(10, 4).tolist() == PARITY


def test_parity_of_a_small_stripe():
    # stripe of one byte per shard: data shard j holds j + 1
    data = torch.arange(1, 11, dtype=torch.uint8).view(10, 1)
    want = []
    for row in PARITY:
        acc = 0
        for c, x in zip(row, range(1, 11)):
            acc ^= gf256.mul(c, x)
        want.append([acc])
    assert gf256.apply(gf256.parity_matrix(), data).tolist() == want
    assert gf256.mul(2, 0x80) == 0x1D


@pytest.mark.parametrize("length", [1, 1000, 65_537])
def test_parity_matches_the_port(length):
    from seaweedfs_tpu_torch.ops import rs_numpy

    rng = np.random.default_rng(length)
    d = np.frombuffer(rng.bytes(10 * length), np.uint8).reshape(10, length)
    shards = [d[i].copy() for i in range(10)] + \
        [np.zeros(length, np.uint8) for _ in range(4)]
    shards = rs_numpy.NumpyEncoder(10, 4).encode(shards)
    ref = gf256.apply(gf256.parity_matrix(), torch.from_numpy(d.copy()),
                      block=4096)
    assert np.array_equal(ref.numpy(), np.stack(
        [np.asarray(s) for s in shards[10:]]))
