"""The port's inline write-path EC against the JAX package's.

The same needles (time.time_ns pinned, so both packages stamp equal
append times) go into a JAX and a port InlineEcVolume; shard logs, .eci
and .vif must come out byte-identical for every code family, with stripe
parity on the host codec or on the pooled parity step
(WEED_EC_INLINE_DEVICE=1: JAX's step on its CPU mesh, with its host
fallback patched to raise; the port's ParityStep on device="cpu").  Each
package mounts and reads the other's volumes.  The reference's own inline
scenarios (tail reads, degraded reads, remount heal, torn and corrupt
commit records, geometry, policy) are rerun against the port, and the
port's fault contract is pinned: a failing device route raises from
drain/close instead of being swallowed, an OSError commit is retried, and
a SIGKILL during a stalled commit loses no acked write.  Exact byte
comparisons throughout (tolerance 0)."""

import itertools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage.erasure_coding import codes as j_codes
from seaweedfs_tpu.storage.erasure_coding import inline as j_inline
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu_torch.parallel import mesh as t_mesh
from seaweedfs_tpu_torch.storage.erasure_coding import codes as t_codes
from seaweedfs_tpu_torch.storage.erasure_coding import inline as t_inline
from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
from seaweedfs_tpu_torch.storage.needle import Needle as TNeedle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("rs_vandermonde", "cauchy", "pm_msr")
FILES = [to_ext(i) for i in range(14)] + [".eci", ".vif"]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """8 KiB stripe units and no tail timer: tail parity lands only on
    drain/close, so the commit sequence is the same in both packages."""
    monkeypatch.setenv("WEED_EC_STRIPE_KB", "8")
    monkeypatch.setenv("WEED_EC_INLINE_FLUSH_MS", "0")
    monkeypatch.delenv("WEED_EC_INLINE_DEVICE", raising=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    from seaweedfs_tpu_torch.ops.device_pool import reset_pool

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_pool()


@pytest.fixture
def pinned_clock(monkeypatch):
    """time.time_ns as a counter; calling the fixture's value restarts it,
    so both packages stamp equal append times on equal writes."""
    state = {}
    lock = threading.Lock()

    def restart():
        state["ticks"] = itertools.count(1_700_000_000_000_000_000,
                                         1_000_003)

    def fake():
        with lock:
            return next(state["ticks"])

    restart()
    monkeypatch.setattr(time, "time_ns", fake)
    return restart


@pytest.fixture
def device_route(monkeypatch):
    """WEED_EC_INLINE_DEVICE=1 on both sides, with JAX's silent host
    fallback turned into a failure."""
    import seaweedfs_tpu.ops.codec as j_codec

    def no_host(*_a, **_k):
        raise AssertionError("JAX inline encode fell back to the host")

    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "1")
    monkeypatch.setattr(j_codec, "_apply_rows_host", no_host)


def _payloads(count: int, seed: int, lo: int = 100, hi: int = 9000):
    rng = np.random.default_rng(seed)
    return {i + 1: rng.integers(0, 256, int(rng.integers(lo, hi)),
                                dtype=np.uint8).tobytes()
            for i in range(count)}


def _write(ev, needle_cls, written: dict):
    for nid, payload in written.items():
        n = needle_cls.create(payload)
        n.id, n.cookie = nid, 0x1234
        ev.write_needle(n, check_cookie=False)


def _t_vol(path, family=None, vid=7, create=False, collection="pics"):
    return t_inline.InlineEcVolume(str(path), collection, vid,
                                   family=family, create=create,
                                   device="cpu")


def _j_vol(path, family=None, vid=7, create=False, collection="pics"):
    return j_inline.InlineEcVolume(str(path), collection, vid,
                                   family=family, create=create)


def _files(path, vid=7, collection="pics", names=FILES) -> dict:
    out = {}
    for ext in names:
        with open(os.path.join(str(path), f"{collection}_{vid}{ext}"),
                  "rb") as f:
            out[ext] = f.read()
    return out


def _both(tmp_path, pinned_clock, family, written, vid=7):
    """Write `written` into a JAX and a port volume (same clock), drain
    both with a tail commit; returns (jax dir, port dir, jax status,
    port status), both volumes closed."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    pinned_clock()
    ev = _j_vol(jd, family, vid, create=True)
    try:
        _write(ev, JNeedle, written)
        ev.writer.drain(tail=True)
        js = ev.writer.status()
    finally:
        ev.close()
    pinned_clock()
    ev = _t_vol(td, family, vid, create=True)
    try:
        _write(ev, TNeedle, written)
        ev.writer.drain(tail=True)
        ts = ev.writer.status()
    finally:
        ev.close()
    return jd, td, js, ts


def _records(path, vid=7, collection="pics"):
    return t_inline.read_commit_log(
        os.path.join(str(path), f"{collection}_{vid}.scl"))


def _check_scl(jd, td):
    """Full-row records agree on (kind, row, stripe CRC) in order; the
    fields that depend on when the flusher ran are held to the
    reference's invariants (monotonic rows, clean record CRCs, no torn
    bytes)."""
    tr, jr = _records(td), _records(jd)
    key = [(r["kind"], r["row_index"], r["stripe_crc"]) for r in tr]
    assert key == [(r["kind"], r["row_index"], r["stripe_crc"])
                   for r in jr]
    full = [r["row_index"] for r in tr if r["kind"] == t_inline.KIND_FULL]
    assert full == sorted(full) and tr
    assert os.path.getsize(os.path.join(str(td), "pics_7.scl")) == \
        len(tr) * t_inline.SCL_RECORD_SIZE


# -- byte identity and cross reads -------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_logs_byte_identical_host_route(tmp_path, pinned_clock, family):
    written = _payloads(70, seed=3)
    jd, td, js, ts = _both(tmp_path, pinned_clock, family, written)
    assert _files(td) == _files(jd)
    assert ts == js
    _check_scl(jd, td)


@pytest.mark.parametrize("family", FAMILIES)
def test_logs_byte_identical_device_route(tmp_path, pinned_clock,
                                          device_route, family):
    written = _payloads(70, seed=4)
    jd, td, js, ts = _both(tmp_path, pinned_clock, family, written)
    assert _files(td) == _files(jd)
    assert ts == js
    _check_scl(jd, td)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_package_reads_the_others_volume(tmp_path, pinned_clock,
                                              family):
    written = _payloads(50, seed=5)
    jd, td, _, _ = _both(tmp_path, pinned_clock, family, written)
    ev = _t_vol(jd)
    try:
        assert ev.family.name == family
        for nid, payload in written.items():
            assert ev.read_needle(nid).data == payload
    finally:
        ev.close()
    ev = _j_vol(td)
    try:
        for nid, payload in written.items():
            assert ev.read_needle(nid).data == payload
    finally:
        ev.close()


# -- batching --------------------------------------------------------------


@pytest.fixture(scope="module")
def batch_writers(tmp_path_factory):
    """One port writer per alpha (RS: 1, pm_msr: 4), device route on."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WEED_EC_STRIPE_KB", "8")
    out = {}
    for fam in ("rs_vandermonde", "pm_msr"):
        d = tmp_path_factory.mktemp("batch_" + fam)
        out[fam] = t_inline.InlineEcWriter(os.path.join(str(d), "b"),
                                           family=fam, create=True,
                                           device="cpu")
    mp.undo()
    yield out
    for w in out.values():
        w.close()


@pytest.mark.parametrize("family", ["rs_vandermonde", "pm_msr"])
@pytest.mark.parametrize("rows", range(1, 17))
def test_one_call_batch_equals_per_row(batch_writers, monkeypatch, family,
                                       rows):
    """R rows through ONE parity step call give the bytes of R per-row
    calls and of the JAX family's encode of the R rows laid end to end."""
    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "1")
    w = batch_writers[family]
    rng = np.random.default_rng(rows)
    data = [rng.integers(0, 256, w.row_bytes, dtype=np.uint8).tobytes()
            for _ in range(rows)]
    before = w.device_encodes
    batch = w._encode_rows(data)
    assert w.device_encodes == before + 1
    per_row = np.hstack([w._encode_rows([r]) for r in data])
    assert np.array_equal(batch, per_row)
    span = np.hstack([np.frombuffer(r, dtype=np.uint8).reshape(w.k, w.unit)
                      for r in data])
    assert np.array_equal(
        batch, j_codes.get_family(family).encode_blocks(span))
    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "0")
    assert np.array_equal(w._encode_rows(data), batch)
    assert w.device_encodes == before + 1 + rows


def test_more_rows_than_a_batch_are_refused(batch_writers):
    w = batch_writers["rs_vandermonde"]
    with pytest.raises(ValueError):
        w._encode_rows([bytes(w.row_bytes)] * 17)


def test_commit_batches_are_one_device_call_each(tmp_path, monkeypatch):
    """The flusher's full-row batches and the audit's runs of committed
    rows: one device step call each."""
    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "1")
    ev = _t_vol(tmp_path, "rs_vandermonde", create=True)
    try:
        _write(ev, TNeedle, _payloads(250, seed=8, lo=4000, hi=12000))
        ev.writer.drain(tail=True)
        st = ev.writer.encode_stats()
        full_rows = ev.writer.durable_rows
        assert full_rows > 16
        # every full-row batch plus the one tail commit
        assert st["device_encodes"] == st["commit_batches"] + 1
        assert st["commit_batches"] <= full_rows
        before = ev.writer.device_encodes
        report = t_inline.audit_inline_volume(ev)
        assert report["ok"] and report["rows_checked"] == full_rows + 1
        # the audit's drain commits the tail once more, then re-encodes
        # the committed rows in runs of at most 16
        assert ev.writer.device_encodes - before == 1 + -(-(full_rows + 1)
                                                          // 16)
    finally:
        ev.close()


# -- the reference's scenarios, against the port ------------------------------


def test_tail_served_before_any_commit(tmp_path, pinned_clock):
    payload = b"tail-resident needle " * 40
    evs = []
    for mk, cls, sub in ((_j_vol, JNeedle, "j"), (_t_vol, TNeedle, "t")):
        (tmp_path / sub).mkdir()
        pinned_clock()
        ev = mk(tmp_path / sub, "rs_vandermonde", create=True)
        n = cls.create(payload)
        n.id, n.cookie = 1, 0x1234
        ev.write_needle(n, check_cookie=False)
        assert ev.writer.stripes_committed == 0
        assert ev.read_needle(1).data == payload
        evs.append(ev)
    try:
        # data and parity spans of the uncommitted tail row agree
        for sid in (0, 1, 10, 13):
            assert evs[1].writer.tail_read(sid, 0, 3000) == \
                evs[0].writer.tail_read(sid, 0, 3000)
        for ev in evs:
            ev.writer.drain(tail=True)
            assert ev.writer.stripes_committed >= 1
            assert ev.read_needle(1).data == payload
    finally:
        for ev in evs:
            ev.close()
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("knob", ["0", "1"])
def test_degraded_reads_byte_identical(tmp_path, monkeypatch, family, knob):
    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", knob)
    ev = _t_vol(tmp_path, family, create=True)
    try:
        written = _payloads(60, seed=17)
        _write(ev, TNeedle, written)
        ev.writer.drain(tail=True)
        fam = ev.family
        losses = ([0, fam.data_shards - 1, fam.data_shards]
                  if family != "pm_msr" else [0, 2, 5, 13])
        for sid in losses[:fam.parity_shards]:
            ev.shards.pop(sid).close()
            os.remove(ev.base_file_name() + to_ext(sid))
        for nid, payload in written.items():
            assert ev.read_needle(nid).data == payload
    finally:
        ev.close()


@pytest.mark.parametrize("family", FAMILIES)
def test_remount_heals_deleted_shard_logs(tmp_path, pinned_clock, family):
    written = _payloads(60, seed=47)
    jd, td, _, _ = _both(tmp_path, pinned_clock, family, written)
    k = t_codes.get_family(family).data_shards
    for d in (jd, td):
        for sid in (1, k + 1):
            os.remove(os.path.join(str(d), "pics_7" + to_ext(sid)))
    ev = _j_vol(jd)
    ev.close()
    ev = _t_vol(td)
    try:
        for nid, payload in written.items():
            assert ev.read_needle(nid).data == payload
        assert t_inline.audit_inline_volume(ev)["ok"]
        for sid in (1, k + 1):
            assert os.path.getsize(ev.base_file_name() + to_ext(sid)) \
                == ev.writer.shard_extent(sid)
    finally:
        ev.close()
    shards = [to_ext(i) for i in range(14)] + [".eci"]
    assert _files(td, names=shards) == _files(jd, names=shards)


def test_remount_beyond_tolerance_fails_loudly(tmp_path, pinned_clock):
    jd, td, _, _ = _both(tmp_path, pinned_clock, "rs_vandermonde",
                         _payloads(40, seed=53))
    for d in (jd, td):
        for sid in range(5):  # 5 lost > the RS(10,4) tolerance
            os.remove(os.path.join(str(d), "pics_7" + to_ext(sid)))
    with pytest.raises(OSError, match="beyond the"):
        _j_vol(jd)
    with pytest.raises(OSError, match="beyond the"):
        _t_vol(td)


def test_torn_commit_record_is_discarded(tmp_path, pinned_clock):
    written = _payloads(40, seed=37)
    jd, td, _, _ = _both(tmp_path, pinned_clock, "rs_vandermonde", written)
    for d in (jd, td):
        with open(os.path.join(str(d), "pics_7.scl"), "r+b") as f:
            f.seek(0, os.SEEK_END)
            f.write(b"\xde\xad" * (t_inline.SCL_RECORD_SIZE // 4))
    ev = _t_vol(td)
    try:
        for nid, payload in written.items():
            assert ev.read_needle(nid).data == payload
        assert os.path.getsize(os.path.join(str(td), "pics_7.scl")) % \
            t_inline.SCL_RECORD_SIZE == 0
        assert t_inline.audit_inline_volume(ev)["ok"]
    finally:
        ev.close()
    _j_vol(jd).close()
    shards = [to_ext(i) for i in range(14)] + [".eci"]
    assert _files(td, names=shards) == _files(jd, names=shards)


def test_corrupt_record_crc_stops_the_scan(tmp_path, pinned_clock):
    _, td, _, _ = _both(tmp_path, pinned_clock, "rs_vandermonde",
                        _payloads(40, seed=41))
    scl = os.path.join(str(td), "pics_7.scl")
    records = t_inline.read_commit_log(scl)
    assert len(records) >= 2
    with open(scl, "r+b") as f:
        f.seek((len(records) - 1) * t_inline.SCL_RECORD_SIZE + 10)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    kept = t_inline.read_commit_log(scl)
    assert len(kept) == len(records) - 1
    assert kept == j_inline.read_commit_log(scl)


def test_commit_records_pack_like_the_reference():
    rng = np.random.default_rng(11)
    for _ in range(20):
        kind = int(rng.integers(0, 2))
        row, logical, idx = (int(v) for v in rng.integers(0, 1 << 40, 3))
        crc = int(rng.integers(0, 1 << 32))
        offs = [int(v) for v in rng.integers(0, 1 << 40, 14)]
        rec = t_inline.pack_record(kind, row, logical, idx, crc, offs)
        assert rec == j_inline.pack_record(kind, row, logical, idx, crc,
                                           offs)
        assert t_inline.unpack_record(rec) == j_inline.unpack_record(rec)
        assert t_inline.unpack_record(rec[:-1] + b"\0") is None


def test_shard_extent_partition():
    for unit, k in ((4096, 10), (8192, 5)):
        for logical in (0, 1, unit - 1, unit, unit * k, unit * k + 5,
                        unit * k * 3 + unit + 17):
            ext = [t_inline.inline_shard_extent(logical, unit, k, sid)
                   for sid in range(k)]
            assert sum(ext) == logical
            assert ext == [j_inline.inline_shard_extent(logical, unit, k,
                                                        sid)
                           for sid in range(k)]


@pytest.mark.parametrize("family", FAMILIES)
def test_stripe_unit_alpha_alignment(monkeypatch, family):
    for kb in ("3", "8", "64", "", "junk"):
        monkeypatch.setenv("WEED_EC_STRIPE_KB", kb)
        unit = t_inline.stripe_unit_bytes(t_codes.get_family(family))
        assert unit == j_inline.stripe_unit_bytes(
            j_codes.get_family(family))
        assert unit % (t_codes.get_family(family).sub_shards * 8) == 0


# -- the policy ---------------------------------------------------------------


def _policy_both(collection, path_conf=None):
    got = t_inline.inline_family_for(collection, path_conf)
    assert got == j_inline.inline_family_for(collection, path_conf)
    return got


def test_policy_off_by_default(monkeypatch):
    monkeypatch.delenv("WEED_EC_INLINE", raising=False)
    monkeypatch.setenv("WEED_EC_CODE_PICS", "cauchy")
    assert _policy_both("pics") is None


def test_policy_explicit_collection(monkeypatch):
    monkeypatch.setenv("WEED_EC_INLINE", "1")
    monkeypatch.setenv("WEED_EC_CODE_PICS", "cauchy")
    assert _policy_both("pics") == "cauchy"


def test_policy_unconfigured_collection_stays_classic(monkeypatch):
    monkeypatch.setenv("WEED_EC_INLINE", "1")
    monkeypatch.delenv("WEED_EC_CODE", raising=False)
    monkeypatch.delenv("WEED_EC_CODE_LOGS", raising=False)
    assert _policy_both("logs") is None


def test_policy_path_conf_and_global_fallback(monkeypatch):
    class PathConf:
        ec_code = "pm_msr"

    monkeypatch.setenv("WEED_EC_INLINE", "1")
    monkeypatch.delenv("WEED_EC_CODE_DOCS", raising=False)
    assert _policy_both("docs", PathConf()) == "pm_msr"
    monkeypatch.setenv("WEED_EC_CODE", "rs_vandermonde")
    assert _policy_both("docs") == "rs_vandermonde"


def test_policy_bad_family_raises_before_any_log_is_cut(tmp_path,
                                                        monkeypatch):
    from seaweedfs_tpu_torch.storage.store import Store

    monkeypatch.setenv("WEED_EC_INLINE", "1")
    monkeypatch.setenv("WEED_EC_CODE_PICS", "no_such_code")
    with pytest.raises(ValueError):
        t_inline.inline_family_for("pics")
    with pytest.raises(ValueError):
        j_inline.inline_family_for("pics")
    store = Store([str(tmp_path)], device="cpu")
    try:
        with pytest.raises(ValueError):
            store.add_volume(5, "pics")
    finally:
        store.close()
    assert not [n for n in os.listdir(tmp_path) if ".ec" in n]


# -- faults -------------------------------------------------------------------


def test_device_error_surfaces_and_loses_no_acked_write(tmp_path,
                                                        monkeypatch):
    """A failing parity step is never swallowed: the flusher stops, the
    error comes out of drain, append and close, and a remount recomputes
    the uncommitted rows' parity, every acked needle intact."""
    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "1")

    def boom(self, data, out):
        raise RuntimeError("injected kernel failure")

    ev = _t_vol(tmp_path, "rs_vandermonde", create=True)
    written = _payloads(40, seed=61, lo=4000, hi=9000)
    acked = {}
    with monkeypatch.context() as m:
        m.setattr(t_mesh.ParityStep, "__call__", boom)
        for nid, payload in written.items():
            try:  # cuts rows: the flusher fails, and appends stop
                _write(ev, TNeedle, {nid: payload})
            except RuntimeError:
                break
            acked[nid] = payload
        assert len(acked) > 8
        with pytest.raises(RuntimeError, match="injected kernel failure"):
            ev.writer.drain(tail=True)
        with pytest.raises(RuntimeError):
            _write(ev, TNeedle, {999: b"late"})
        with pytest.raises(RuntimeError):
            ev.close()
        assert ev.writer.durable_rows == 0
    ev = _t_vol(tmp_path)
    try:
        for nid, payload in acked.items():
            assert ev.read_needle(nid).data == payload
        assert 999 not in dict(ev.writer.nm.items_ascending())
        assert t_inline.audit_inline_volume(ev)["ok"]
    finally:
        ev.close()


def test_disk_error_in_a_commit_is_retried(tmp_path):
    """An OSError from a parity write keeps the row pending; the flusher
    retries it and the volume ends clean."""
    ev = _t_vol(tmp_path, "rs_vandermonde", create=True)
    w = ev.writer
    real = w._pwrite_shard
    failures = []

    def flaky(sid, offset, buf):
        if sid >= w.k and not failures:
            failures.append(sid)
            raise OSError(5, "injected parity write failure")
        return real(sid, offset, buf)

    w._pwrite_shard = flaky
    try:
        written = _payloads(30, seed=67, lo=4000, hi=9000)
        _write(ev, TNeedle, written)
        w.drain(tail=True)
        assert failures and w.durable_rows > 0
        assert t_inline.audit_inline_volume(ev)["ok"]
    finally:
        ev.close()


_CHILD = r"""
import os, sys
import numpy as np
from seaweedfs_tpu_torch.util import faults
from seaweedfs_tpu_torch.storage.erasure_coding.inline import InlineEcVolume
from seaweedfs_tpu_torch.storage.needle import Needle

workdir, vid = sys.argv[1], int(sys.argv[2])
# every stripe-commit record write sleeps 10 s: the parent's kill lands
# with parity written but the record torn
faults.REGISTRY.configure(
    "latency, ms=10000, dst=*.scl, route=commit, side=disk, pct=100", seed=1)
ev = InlineEcVolume(workdir, "chaos", vid, family="rs_vandermonde",
                    create=True, device="cpu")
i = 1
while True:
    size = 8192 + (i * 13331) % (96 << 10)
    payload = np.random.default_rng(i).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    n = Needle.create(payload)
    n.id, n.cookie = i, 0xABC
    ev.write_needle(n, check_cookie=False)
    print(f"ACKED {i}", flush=True)
    i += 1
"""


def _chaos_payload(i: int) -> bytes:
    size = 8192 + (i * 13331) % (96 << 10)
    return np.random.default_rng(i).integers(0, 256, size,
                                             dtype=np.uint8).tobytes()


def test_sigkill_during_stalled_commit_loses_no_acked_write(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, WEED_EC_INLINE="1",
               WEED_EC_STRIPE_KB="64", WEED_EC_INLINE_FLUSH_MS="500")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp_path), "61"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    last = 0
    try:
        while last < 25:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError("writer child died early: "
                                     + proc.stderr.read()[-2000:])
            if line.startswith("ACKED "):
                last = int(line.split()[1])
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == -9
    # the kill landed with commit records stalled: fewer rows recorded
    # than the acked stream filled
    ev = t_inline.InlineEcVolume(str(tmp_path), "chaos", 61, device="cpu")
    try:
        for i in range(1, last + 1):
            assert ev.read_needle(i).data == _chaos_payload(i)
    finally:
        ev.close()
    report = t_inline.verify_inline_volume(str(tmp_path), "chaos", 61,
                                           device="cpu")
    assert report["ok"] and report["needles_checked"] >= last
    ev = j_inline.InlineEcVolume(str(tmp_path), "chaos", 61)
    try:
        for i in range(1, last + 1):
            assert ev.read_needle(i).data == _chaos_payload(i)
    finally:
        ev.close()


def test_fault_rules_decide_like_the_reference():
    from seaweedfs_tpu.util import faults as j_faults
    from seaweedfs_tpu_torch.util import faults as t_faults

    spec = ("latency,ms=5,dst=*.scl,route=commit,side=disk,pct=30;"
            "disk_error,dst=*.ec0?,route=write,pct=10,times=3")
    tr, jr = t_faults.parse_spec(spec), j_faults.parse_spec(spec)
    assert [r.to_dict() for r in tr] == [r.to_dict() for r in jr]
    for n in range(200):
        assert t_faults._decision(7, "x", n) == j_faults._decision(7, "x",
                                                                   n)
    reg = t_faults.FaultRegistry()
    reg.sleep = lambda s: None
    reg.configure(spec, seed=3)
    try:
        fired = 0
        for _ in range(100):
            try:
                reg.on_disk("/v/c_1.ec03", "write")
            except OSError:
                fired += 1
        assert fired == 3
        assert reg.snapshot()["rules"][1]["fires"] == 3
    finally:
        reg.clear()
        t_faults._set_active(False)
    assert not t_faults.ACTIVE
