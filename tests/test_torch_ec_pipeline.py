"""The port's EC slice against the JAX package: shard files and CRCs from
write_ec_files / encode_volumes, and rebuilds across the two packages.
Both run on the CPU here (the port through its kernels' plain versions);
every comparison is exact."""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.parallel import batched_encode as j_be
from seaweedfs_tpu.storage.erasure_coding import encoder as j_enc
from seaweedfs_tpu.storage.erasure_coding import to_ext
from seaweedfs_tpu_torch.ops import crc32c as t_crc
from seaweedfs_tpu_torch.parallel import batched_encode as t_be
from seaweedfs_tpu_torch.storage import erasure_coding as t_ec
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc

LARGE, SMALL = 10000, 100  # the JAX package's test block sizes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs test files in
    parallel worker processes beside timing-sensitive cluster tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volume(tmp_path, name: str, size: int, seed: int) -> str:
    base = str(tmp_path / name)
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return base


def _twin(tmp_path, base: str, name: str) -> str:
    other = str(tmp_path / name)
    os.link(base + ".dat", other + ".dat")
    return other


def _shard(base: str, i: int) -> bytes:
    with open(base + to_ext(i), "rb") as f:
        return f.read()


def _assert_same_shards(a: str, b: str):
    for i in range(14):
        assert _shard(a, i) == _shard(b, i), f"shard {i}"


@pytest.mark.parametrize("size", [1, 999, SMALL * 10, SMALL * 10 * 7 + 13,
                                  LARGE * 10 + 1, LARGE * 10 * 2 + 12345])
def test_write_ec_files_equals_jax(tmp_path, size):
    base = _volume(tmp_path, "t", size, size)
    ref = _twin(tmp_path, base, "j")
    got = t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    want = j_enc.write_ec_files(ref, large_block_size=LARGE,
                                small_block_size=SMALL, batched=True)
    _assert_same_shards(base, ref)
    assert list(got) == [int(c) for c in want]
    for i in range(14):
        assert got[i] == t_crc.crc32c(_shard(base, i))


def test_empty_volume(tmp_path):
    base = _volume(tmp_path, "empty", 0, 0)
    assert t_enc.write_ec_files(base, LARGE, SMALL, device="cpu") == [0] * 14
    for i in range(14):
        assert os.path.getsize(base + to_ext(i)) == 0


def test_odd_chunk_length(tmp_path):
    """small_block=50: chunks not divisible by 4 or 16."""
    base = _volume(tmp_path, "odd", 1230, 3)
    ref = _twin(tmp_path, base, "oddref")
    got = t_be.encode_volumes([base], large_block=500, small_block=50,
                              device="cpu")[base]
    want = j_be.encode_volumes([ref], large_block=500, small_block=50)[ref]
    _assert_same_shards(base, ref)
    assert got == [int(c) for c in want]


def test_multi_volume_one_pipeline(tmp_path):
    bases = [_volume(tmp_path, f"v{k}", 997 * (k + 1) + k, k)
             for k in range(5)]
    refs = [_twin(tmp_path, b, f"r{k}") for k, b in enumerate(bases)]
    st: dict = {}
    got = t_be.encode_volumes(bases, large_block=LARGE, small_block=SMALL,
                              batch_units=3, stage_stats=st, device="cpu")
    want = j_be.encode_volumes(refs, large_block=LARGE, small_block=SMALL)
    for b, r in zip(bases, refs):
        _assert_same_shards(b, r)
        assert got[b] == [int(c) for c in want[r]]
    assert st["batches"] > 1 and st["batch_units"] == 3


def test_inflight_knob_and_stage_stats(tmp_path, monkeypatch):
    base = _volume(tmp_path, "knob", LARGE * 10 + 4321, 5)
    ref = _twin(tmp_path, base, "knobref")
    monkeypatch.setenv("WEED_EC_DEVICE_INFLIGHT", "1")
    st: dict = {}
    got = t_enc.write_ec_files(base, LARGE, SMALL, stage_stats=st,
                               device="cpu")
    want = j_enc.write_ec_files(ref, large_block_size=LARGE,
                                small_block_size=SMALL, batched=True)
    _assert_same_shards(base, ref)
    assert got == [int(c) for c in want]
    assert st["inflight"] == 1
    for k in ("read", "dispatch", "encode_crc", "write"):
        assert st[k] >= 0 and 0 <= st[f"{k}_frac"] <= 1.5
    # a CPU device takes the pooled route with the host CRC walk
    assert st["backend"] == "device-pooled"
    assert st["crc_path"] == "host"
    assert st["batches"] >= 1


PATTERNS = [[0], [10, 11, 12, 13], [0, 5, 11, 13]]


@pytest.mark.parametrize("lost", PATTERNS)
def test_rebuild_jax_encoded_with_port(tmp_path, lost):
    base = _volume(tmp_path, "jx", LARGE * 10 + 4321, 11)
    crcs = j_enc.write_ec_files(base, large_block_size=LARGE,
                                small_block_size=SMALL, batched=True)
    golden = {sid: _shard(base, sid) for sid in lost}
    for sid in lost:
        os.unlink(base + to_ext(sid))
    got = t_enc.rebuild_ec_files(base, device="cpu")
    assert got == {sid: int(crcs[sid]) for sid in lost}
    for sid in lost:
        assert _shard(base, sid) == golden[sid]


@pytest.mark.parametrize("lost", PATTERNS)
def test_rebuild_port_encoded_with_jax(tmp_path, lost):
    base = _volume(tmp_path, "tx", LARGE * 10 + 4321, 12)
    crcs = t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    golden = {sid: _shard(base, sid) for sid in lost}
    for sid in lost:
        os.unlink(base + to_ext(sid))
    got = j_be.rebuild_shards(base)
    assert {k: int(v) for k, v in got.items()} == \
        {sid: crcs[sid] for sid in lost}
    for sid in lost:
        assert _shard(base, sid) == golden[sid]


@pytest.mark.parametrize("lost", PATTERNS)
def test_rebuild_crcs_equal_jax_rebuild(tmp_path, lost):
    """Both packages rebuild the same loss from the same survivors, with a
    short final chunk (the shard is not a whole number of 1 MiB chunks)
    and several batches."""
    base = _volume(tmp_path, "a", 3 * (1 << 20) + 77777, 13)
    t_enc.write_ec_files(base, device="cpu")
    ref = str(tmp_path / "b")
    for i in range(14):
        os.link(base + to_ext(i), ref + to_ext(i))
    for sid in lost:
        os.unlink(base + to_ext(sid))
        os.unlink(ref + to_ext(sid))
    got = t_be.rebuild_shards(base, batch_units=1, device="cpu")
    want = j_be.rebuild_shards(ref, batch_units=1)
    assert got == {k: int(v) for k, v in want.items()}
    for sid in lost:
        assert _shard(base, sid) == _shard(ref, sid)


def test_rebuild_noop_and_too_few(tmp_path):
    base = _volume(tmp_path, "rn", 5000, 13)
    t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    assert t_be.rebuild_shards(base, device="cpu") == {}
    for sid in range(5):
        os.unlink(base + to_ext(sid))
    with pytest.raises(ValueError):
        t_be.rebuild_shards(base, device="cpu")


def test_rebuild_empty_shards(tmp_path):
    base = _volume(tmp_path, "e", 0, 0)
    t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    os.unlink(base + to_ext(4))
    assert t_enc.rebuild_ec_files(base, device="cpu") == {4: 0}
    assert os.path.getsize(base + to_ext(4)) == 0


def test_plan_and_chunk_len_equal_jax(tmp_path):
    base = _volume(tmp_path, "p", LARGE * 10 * 2 + 5, 9)
    assert t_be._plan_volume(base, LARGE, SMALL).rows == \
        j_be._plan_volume(base, LARGE, SMALL).rows
    for large, small in ((1 << 30, 1 << 20), (10000, 100), (300, 77)):
        assert t_be._chunk_len(large, small) == j_be._chunk_len(large, small)


def test_volume_info_cross_reads(tmp_path):
    base = str(tmp_path / "vif")
    t_enc.save_volume_info(base, 3, {"shard_crc32c": list(range(14))})
    assert j_enc.load_volume_info(base) == \
        {"version": 3, "shard_crc32c": list(range(14))}
    j_enc.save_volume_info(base, 2)
    assert t_enc.load_volume_info(base) == {"version": 2}
    assert t_enc.load_volume_info(str(tmp_path / "none")) is None


def test_constants_equal_jax():
    from seaweedfs_tpu.storage import erasure_coding as j_ec

    for name in ("DATA_SHARDS_COUNT", "PARITY_SHARDS_COUNT",
                 "TOTAL_SHARDS_COUNT", "LARGE_BLOCK_SIZE",
                 "SMALL_BLOCK_SIZE"):
        assert getattr(t_ec, name) == getattr(j_ec, name)
    assert [t_ec.to_ext(i) for i in range(14)] == \
        [j_ec.to_ext(i) for i in range(14)]


def test_other_code_families_not_ported(tmp_path):
    """The other families (ported since) take the family host loop: the
    JAX package's shard CRCs, and a lost shard rebuilt byte for byte."""
    base = _volume(tmp_path, "fam", 1000, 1)
    for name in ("cauchy", "pm_msr"):
        crcs = t_enc.write_ec_files(base, LARGE, SMALL, family=name,
                                    device="cpu")
        assert crcs == j_enc.write_ec_files(base, large_block_size=LARGE,
                                            small_block_size=SMALL,
                                            family=name)
        with open(base + to_ext(12), "rb") as f:
            want = f.read()
        os.remove(base + to_ext(12))
        assert t_enc.rebuild_ec_files(base, family=name, device="cpu") \
            == {12: crcs[12]}
        with open(base + to_ext(12), "rb") as f:
            assert f.read() == want
    assert len(t_enc.write_ec_files(base, LARGE, SMALL,
                                    family="rs_vandermonde",
                                    device="cpu")) == 14
