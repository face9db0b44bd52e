"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc; without one each test skips (the
decision is made inside the fixture, never at import).  On the card run
them with `python -m pytest tests/test_torch_cuda.py -q`; chip_smoke.py
makes the same checks at the main path's shapes."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.gf256 import parity_matrix
from seaweedfs_tpu_torch.ops.rs_numpy import decode_rows

PARITY = np.ascontiguousarray(parity_matrix(10, 14))
REBUILD = np.array(decode_rows(10, 14, [1, 2, 3, 4, 6, 7, 8, 9, 10, 12],
                               (0, 5, 11, 13)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bytes(seed, shape, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape,
                                         dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("length", [1, 3, 50, 4096, 65536 + 3])
def test_gf_apply_matches_plain(cuda, length):
    x = _bytes(length, (10, length), cuda)
    for m in (PARITY, REBUILD[:1], _bytes(1, (20, 10), "cpu").numpy()):
        before = rs_cuda.launches["gf_apply"]
        got = rs_cuda.gf_apply(m, x)
        assert rs_cuda.launches["gf_apply"] > before
        assert torch.equal(got, rs_cuda.gf_apply_plain(m, x))


@pytest.mark.parametrize("batch,length", [(1, 1), (2, 50), (3, 4099),
                                          (2, 1 << 16), (1, (1 << 20) + 3)])
def test_fused_apply_crc_matches_plain(cuda, batch, length):
    x = _bytes(batch * length, (batch, 10, length), cuda)
    for m in (PARITY, REBUILD):
        before = rs_cuda.launches["fused_apply_crc"]
        out, crc = rs_cuda.fused_apply_crc(m, x)
        assert rs_cuda.launches["fused_apply_crc"] == before + 1
        want, want_crc = rs_cuda.fused_apply_crc_plain(m, x)
        assert torch.equal(out, want)
        assert torch.equal(crc, want_crc)


def _misaligned(seed, shape, offset, dev):
    """A contiguous view `offset` bytes into a flat buffer: its pointer is
    off a 16-byte boundary, so the kernels take their byte path."""
    n = int(np.prod(shape))
    view = _bytes(seed, (n + offset,), dev)[offset:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("length", [50, 4096 + 3, 1 << 16])
def test_fused_apply_crc_on_unaligned_views(cuda, offset, length):
    x = _misaligned(offset + length, (1, 10, length), offset, cuda)
    out, crc = rs_cuda.fused_apply_crc(PARITY, x)
    want, want_crc = rs_cuda.fused_apply_crc_plain(PARITY, x)
    assert torch.equal(out, want) and torch.equal(crc, want_crc)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("length", [50, 4096 + 3, 1 << 16])
def test_gf_apply_on_unaligned_views(cuda, offset, length):
    x = _misaligned(offset + length, (10, length), offset, cuda)
    for m in (PARITY, REBUILD[:1]):
        assert torch.equal(rs_cuda.gf_apply(m, x),
                           rs_cuda.gf_apply_plain(m, x))


@pytest.mark.parametrize("d", [3, 10, 20])
@pytest.mark.parametrize("p", [1, 5, 8, 16, 20])
def test_kernels_at_row_counts(cuda, p, d):
    """K1 at every row count (its wrapper splits 20 rows into groups of
    16); K2 up to its 16 rows, raising above."""
    m = _bytes(p * 100 + d, (p, d), "cpu").numpy()
    for length in (4096, 4096 + 3):
        x = _bytes(length + d, (2, d, length), cuda)
        assert torch.equal(rs_cuda.gf_apply(m, x[0]),
                           rs_cuda.gf_apply_plain(m, x[0]))
        if p > rs_cuda.MAX_ROWS:
            with pytest.raises(ValueError):
                rs_cuda.fused_apply_crc(m, x)
            continue
        out, crc = rs_cuda.fused_apply_crc(m, x)
        want, want_crc = rs_cuda.fused_apply_crc_plain(m, x)
        assert torch.equal(out, want) and torch.equal(crc, want_crc)


def test_encode_pipeline_on_card_equals_cpu(cuda, tmp_path):
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, to_ext

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 3 * (1 << 20) + 4321, dtype=np.uint8)
    bases = [str(tmp_path / n) for n in ("gpu", "cpu")]
    for b in bases:
        data.tofile(b + ".dat")
    got = encoder.write_ec_files(bases[0], device=cuda)
    want = encoder.write_ec_files(bases[1], device="cpu")
    assert got == want
    for i in range(14):
        with open(bases[0] + to_ext(i), "rb") as a, \
                open(bases[1] + to_ext(i), "rb") as b:
            assert a.read() == b.read()


def test_degraded_reads_on_card(cuda, tmp_path):
    """Every needle of a small volume read back with 4 shards lost: each
    recovered 256 KiB block (a 2.5 MiB survivor stack) goes through K1,
    one launch per decode batch."""
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder
    from seaweedfs_tpu_torch.storage.erasure_coding import recover
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
        EcVolume, EcVolumeShard)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = np.random.default_rng(4)
    v = Volume(str(tmp_path), "", 1)
    live = {}
    for i in range(1, 301):
        n = Needle.create(rng.bytes(int(rng.integers(1, 40_000))))
        n.id, n.cookie = i, 0x100 + i
        v.write_needle(n)
        live[i] = n.data
    base = v.file_name()
    v.close()
    encoder.write_ec_files(base, device=cuda)
    encoder.write_sorted_file_from_idx(base)
    ev = EcVolume(str(tmp_path), "", 1, device=cuda)
    for i in range(14):
        if i not in (0, 5, 11, 13):
            ev.add_shard(EcVolumeShard(str(tmp_path), "", 1, i))
    before = (rs_cuda.launches["gf_apply"],
              recover.STATS.snapshot()["batches"])
    for i, data in live.items():
        assert ev.read_needle(i, cookie=0x100 + i).data == data
    launched = rs_cuda.launches["gf_apply"] - before[0]
    batches = recover.STATS.snapshot()["batches"] - before[1]
    assert launched == batches > 0
    ev.close()
