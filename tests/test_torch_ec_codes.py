"""The port's code families and family encode / rebuild routes against the
JAX package's: generators, parity rows, decode plans, projection repair,
descriptions, shard files, CRCs and rebuild statistics, all exact (GF(2^8)
integer math, tolerance 0).  Inputs are numpy-seeded; the port runs with
device="cpu"."""

import itertools
import os

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf256 as j_gf
from seaweedfs_tpu.storage.erasure_coding import codes as j_codes
from seaweedfs_tpu.storage.erasure_coding import encoder as j_enc
from seaweedfs_tpu_torch.ops import gf256 as t_gf
from seaweedfs_tpu_torch.ops.rs_numpy import ReconstructError
from seaweedfs_tpu_torch.storage.erasure_coding import codes as t_codes
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc
from seaweedfs_tpu_torch.storage.erasure_coding import to_ext

FAMILIES = ("rs_vandermonde", "cauchy", "pm_msr")
TOTAL = 14


def _fams(name):
    return j_codes.get_family(name), t_codes.get_family(name)


def _without_counters(desc: dict) -> dict:
    """describe() minus the plan cache's hit/miss counters, which depend
    on each process's call history, not on the family."""
    out = dict(desc)
    out["plan_cache"] = sorted(desc["plan_cache"])
    return out


# -- field helpers --------------------------------------------------------


def test_cauchy_builders_and_division_match():
    rng = np.random.default_rng(5)
    for _ in range(20):
        pts = rng.permutation(256)[:8].tolist()
        xs, ys = tuple(pts[:4]), tuple(pts[4:])
        assert np.array_equal(t_gf.cauchy_matrix(xs, ys),
                              j_gf.cauchy_matrix(xs, ys))
        assert np.array_equal(t_gf.cauchy_inverse(xs, ys),
                              j_gf.cauchy_inverse(xs, ys))
        a, b = (int(v) for v in rng.integers(0, 256, 2))
        if b:
            assert t_gf.gf_div(a, b) == j_gf.gf_div(a, b)
    for k, n in ((10, 14), (6, 9), (3, 5)):
        assert np.array_equal(t_gf.build_cauchy_matrix(k, n),
                              j_gf.build_cauchy_matrix(k, n))
    with pytest.raises(ValueError):
        t_gf.cauchy_matrix((1, 2), (2, 3))
    with pytest.raises(ZeroDivisionError):
        t_gf.gf_div(3, 0)


# -- the families ---------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_matrices_and_description_match(name):
    j, t = _fams(name)
    assert np.array_equal(t.encode_matrix(), j.encode_matrix())
    assert np.array_equal(t.parity_matrix(), j.parity_matrix())
    assert _without_counters(t.describe()) == _without_counters(j.describe())
    assert (t.data_shards, t.parity_shards, t.sub_shards,
            t.repair_helpers) == (j.data_shards, j.parity_shards,
                                  j.sub_shards, j.repair_helpers)


def test_registry_matches():
    assert t_codes.family_names() == j_codes.family_names()
    tj = j_codes.describe_families()
    tt = t_codes.describe_families()
    assert {k: _without_counters(v) for k, v in tt.items()} == \
        {k: _without_counters(v) for k, v in tj.items()}
    for bad in ("no_such_code", "RS"):
        with pytest.raises(ValueError):
            t_codes.get_family(bad)
    assert t_codes.get_family(None).name == t_codes.DEFAULT_FAMILY


@pytest.mark.parametrize("erased", [0, 1, 2, 3, 4])
def test_cauchy_decode_rows_every_pattern(erased):
    """Every pattern of `erased` lost shards: the closed-form plans of
    every target (the lost shards, then all 14) equal JAX's."""
    j, t = _fams("cauchy")
    for lost in itertools.combinations(range(TOTAL), erased):
        alive = [s for s in range(TOTAL) if s not in lost]
        surv = t.choose_survivors(alive)
        assert surv == j.choose_survivors(alive)
        for targets in (lost, tuple(range(TOTAL))):
            if targets:
                assert np.array_equal(t.decode_rows(surv, targets),
                                      j.decode_rows(surv, targets))


@pytest.mark.parametrize("erased", range(1, 10))
def test_pm_msr_decode_rows_seeded_sample(erased):
    j, t = _fams("pm_msr")
    rng = np.random.default_rng(100 + erased)
    for _ in range(4):
        lost = tuple(sorted(rng.permutation(TOTAL)[:erased].tolist()))
        alive = [s for s in range(TOTAL) if s not in lost]
        surv = t.choose_survivors(alive)
        assert surv == j.choose_survivors(alive)
        assert np.array_equal(t.decode_rows(surv, lost),
                              j.decode_rows(surv, lost))


@pytest.mark.parametrize("lost", range(TOTAL))
def test_pm_msr_projection_repair_every_single_loss(lost):
    """repair_plan, the helpers' projections and their combination equal
    JAX's for each lost shard, and the combination rebuilds the shard."""
    j, t = _fams("pm_msr")
    alive = [s for s in range(TOTAL) if s != lost]
    tp, jp = t.repair_plan(lost, alive), j.repair_plan(lost, alive)
    assert (tp.kind, tp.lost, tp.reads, tp.vector) == \
        (jp.kind, jp.lost, jp.reads, jp.vector)
    assert tp.kind == "projection" and tp.read_fraction == 2.0
    assert np.array_equal(tp.combine, jp.combine)
    rng = np.random.default_rng(lost)
    data = rng.integers(0, 256, (t.data_shards, 4096), dtype=np.uint8)
    shards = np.concatenate([data, t.encode_blocks(data)])
    projs = np.stack([t.project(shards[h], tp.vector) for h in tp.helpers])
    assert np.array_equal(projs, np.stack(
        [j.project(shards[h], jp.vector) for h in jp.helpers]))
    got = t.combine_projections(tp, projs)
    assert np.array_equal(got, j.combine_projections(jp, projs))
    assert np.array_equal(got, shards[lost])


@pytest.mark.parametrize("name,lost,alive", [
    ("pm_msr", 3, [0, 1, 2, 4, 5, 6]),      # < d helpers: decode plan
    ("cauchy", 11, range(TOTAL)),
    ("rs_vandermonde", 0, range(1, TOTAL)),
])
def test_decode_repair_plans_match(name, lost, alive):
    j, t = _fams(name)
    tp, jp = t.repair_plan(lost, list(alive)), j.repair_plan(lost,
                                                             list(alive))
    assert (tp.kind, tp.lost, tp.reads, tp.read_fraction) == \
        (jp.kind, jp.lost, jp.reads, jp.read_fraction)
    assert tp.kind == "decode" and tp.combine is None
    if t.sub_shards == 1:
        with pytest.raises(ReconstructError):
            t.project(np.zeros(8, dtype=np.uint8), (1,))


@pytest.mark.parametrize("name", FAMILIES)
def test_encode_and_decode_blocks_match(name):
    j, t = _fams(name)
    rng = np.random.default_rng(len(name))
    width = 4 * 1031
    data = rng.integers(0, 256, (t.data_shards, width), dtype=np.uint8)
    par = t.encode_blocks(data)
    assert np.array_equal(par, j.encode_blocks(data))
    shards = np.concatenate([data, par])
    lost = tuple(sorted(rng.permutation(TOTAL)[:t.parity_shards].tolist()))
    surv = t.choose_survivors([s for s in range(TOTAL) if s not in lost])
    got = t.decode_blocks(surv, shards[list(surv)], lost)
    assert np.array_equal(got, j.decode_blocks(surv, shards[list(surv)],
                                               lost))
    assert np.array_equal(got, shards[list(lost)])
    with pytest.raises(ReconstructError):
        t.choose_survivors(list(range(t.data_shards - 1)))


# -- family encode and rebuild -------------------------------------------


def _dat(path: str, nbytes: int, seed: int):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())


def _shards(base: str) -> list:
    out = []
    for i in range(TOTAL):
        with open(base + to_ext(i), "rb") as f:
            out.append(f.read())
    return out


# large, small block sizes; the .dat has an odd tail, and the first
# geometry has large rows before the small ones
GEOMETRIES = [(16 << 10, 4 << 10), (64 << 10, 8 << 10)]


@pytest.mark.parametrize("name", ["cauchy", "pm_msr"])
@pytest.mark.parametrize("large,small", GEOMETRIES)
def test_write_ec_files_family_byte_identical(tmp_path, name, large, small):
    jb, tb = str(tmp_path / "j"), str(tmp_path / "t")
    for b in (jb, tb):
        _dat(b + ".dat", 600_001, seed=large + small)
    jc = j_enc.write_ec_files(jb, family=name, large_block_size=large,
                              small_block_size=small, chunk_bytes=3000)
    tc = t_enc.write_ec_files(tb, family=name, large_block_size=large,
                              small_block_size=small, chunk_bytes=3000,
                              device="cpu")
    assert [int(c) for c in tc] == [int(c) for c in jc]
    assert _shards(tb) == _shards(jb)
    k = t_codes.get_family(name).data_shards
    with open(tb + ".dat", "rb") as f:
        dat = f.read()
    # the data shards carry the .dat striped row-major, zero-padded
    if len(dat) <= large * k:  # small rows only
        rows = -(-len(dat) // (small * k))
        got = b"".join(
            _shards(tb)[i][r * small:(r + 1) * small]
            for r in range(rows) for i in range(k))
        assert got[:len(dat)] == dat and not got[len(dat):].strip(b"\0")


REBUILDS = [("pm_msr", (3,), "projection"), ("pm_msr", (12,), "projection"),
            ("pm_msr", (0, 7), "decode"), ("cauchy", (2,), "decode"),
            ("cauchy", (0, 13), "decode"),
            ("rs_vandermonde", (4,), "decode")]


@pytest.mark.parametrize("name,lost,kind", REBUILDS)
def test_rebuild_ec_files_planned_byte_identical(tmp_path, name, lost,
                                                 kind):
    jb, tb = str(tmp_path / "j"), str(tmp_path / "t")
    for b in (jb, tb):
        _dat(b + ".dat", 300_007, seed=len(lost))
        j_enc.write_ec_files(b, family=name, large_block_size=32 << 10,
                             small_block_size=8 << 10,
                             batched=False)
    want = _shards(jb)
    for b in (jb, tb):
        for sid in lost:
            os.remove(b + to_ext(sid))
    js, ts = {}, {}
    jc = j_enc.rebuild_ec_files(jb, family=name, stats=js,
                                buffer_size=5000)
    tc = t_enc.rebuild_ec_files(tb, family=name, stats=ts,
                                buffer_size=5000, device="cpu")
    assert tc == jc and sorted(tc) == list(lost)
    assert ts == js and ts["plan"] == kind
    assert _shards(tb) == _shards(jb) == want
    if kind == "projection":
        assert ts["read_amp"] == 2.0 and len(ts["helpers"]) == 8
