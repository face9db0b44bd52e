"""The port's EC lifecycle on one node against the JAX package: locate,
code families, .ecx, degraded reads through EcVolume (every needle, with
up to four shards lost), deletes with the .ecj journal, and decode back
to a volume.  Every comparison is of bytes (tolerance 0).  The port runs
on the CPU here: with WEED_EC_RECOVER_DEVICE=1 its recovered blocks go
through kernel K1's plain version, else through the host codec."""

import hashlib
import itertools
import os
import random
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec as j_codec
from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.storage.erasure_coding import codes as j_codes
from seaweedfs_tpu.storage.erasure_coding import decoder as j_dec
from seaweedfs_tpu.storage.erasure_coding import ec_volume as j_ecv
from seaweedfs_tpu.storage.erasure_coding import encoder as j_enc
from seaweedfs_tpu.storage.erasure_coding import locate as j_locate
from seaweedfs_tpu_torch.ops import codec as t_codec
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.storage.erasure_coding import codes as t_codes
from seaweedfs_tpu_torch.storage.erasure_coding import decoder as t_dec
from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume as t_ecv
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc
from seaweedfs_tpu_torch.storage.erasure_coding import locate as t_locate
from seaweedfs_tpu_torch.storage.erasure_coding import recover as t_recover
from seaweedfs_tpu_torch.storage.erasure_coding import to_ext

LARGE, SMALL = 10000, 100  # the JAX package's test block sizes
VID = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs test files in
    parallel worker processes beside timing-sensitive cluster tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def k1_plain(monkeypatch):
    """Send every recovered block through K1's plain version."""
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")


def _write_needles(vol, needle_mod, count: int, seed: int,
                   deletes=()) -> dict:
    """Seeded needles of 1 B..1.5 KiB with names; returns the live
    {id: (cookie, data)}."""
    rng = np.random.default_rng(seed)
    live = {}
    for i in range(1, count + 1):
        data = rng.bytes(int(rng.integers(1, 1500)))
        n = needle_mod.Needle.create(data, name=f"f{i}".encode())
        n.id, n.cookie = i, 0x1000 + i
        vol.write_needle(n)
        live[i] = (n.cookie, data)
    for nid in deletes:
        vol.delete_needle(needle_mod.Needle(id=nid, cookie=0x1000 + nid))
        live.pop(nid)
    return live


@pytest.fixture(scope="module")
def jax_encoded(tmp_path_factory):
    """A volume written and EC-encoded by the JAX package (~40 KiB, so
    small blocks only, as tests/test_erasure_coding.py sizes it)."""
    d = str(tmp_path_factory.mktemp("jax_ec"))
    v = j_volume.Volume(d, "", VID)
    live = _write_needles(v, j_needle, 50, seed=11, deletes=(4, 17, 33))
    base = v.file_name()
    v.close()
    crcs = j_enc.write_ec_files(base, large_block_size=LARGE,
                                small_block_size=SMALL, batched=True)
    j_enc.write_sorted_file_from_idx(base)
    j_enc.save_volume_info(base, version=3,
                           extra={"shard_crc32c": [int(c) for c in crcs]})
    return d, base, live


@pytest.fixture(scope="module")
def port_encoded(tmp_path_factory):
    """The same lifecycle through the port alone (K2's plain version),
    on fresh needles in ascending id order with no deletes, so that a
    decode gives back the volume's own .dat and .idx."""
    d = str(tmp_path_factory.mktemp("port_ec"))
    v = t_volume.Volume(d, "", VID)
    live = _write_needles(v, t_needle, 50, seed=12)
    base = v.file_name()
    v.close()
    crcs = t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    t_enc.write_sorted_file_from_idx(base)
    t_enc.save_volume_info(base, version=3, extra={"shard_crc32c": crcs})
    return d, base, live


def _copy_volume(src_dir: str, dst) -> str:
    dst = str(dst)
    shutil.copytree(src_dir, dst)
    return dst


def _mount(mod, d, lost=(), **kw):
    ev = mod.EcVolume(d, "", VID, large_block_size=LARGE,
                      small_block_size=SMALL, **kw)
    for i in range(14):
        if i not in lost:
            ev.add_shard(mod.EcVolumeShard(d, "", VID, i))
    return ev


def _read_every_needle(ev, live: dict, deleted_err):
    for nid, (cookie, data) in live.items():
        n = ev.read_needle(nid, cookie=cookie)
        assert n.id == nid and n.data == data
    for nid in set(range(1, max(live) + 1)) - set(live):
        with pytest.raises(deleted_err):
            ev.read_needle(nid)


# -- locate --------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_locate_data_equals_jax(seed):
    rng = np.random.default_rng(seed)
    large, small = 10000, 100
    for _ in range(200):
        dat_size = int(rng.integers(1, 40 * large * 10))
        offset = int(rng.integers(0, dat_size))
        size = int(rng.integers(1, 3 * large))
        got = t_locate.locate_data(large, small, dat_size, offset, size)
        want = j_locate.locate_data(large, small, dat_size, offset, size)
        assert [vars(iv) for iv in got] == [vars(iv) for iv in want]
        assert [iv.to_shard_id_and_offset(large, small) for iv in got] == \
            [iv.to_shard_id_and_offset(large, small) for iv in want]


def test_locate_crosses_from_large_to_small_blocks():
    large, small = 10000, 100
    dat = 2 * large * 10 + 5 * small
    offset = 2 * large * 10 - 50  # 50 bytes before the last large row ends
    got = t_locate.locate_data(large, small, dat, offset, 200)
    assert [(iv.block_index, iv.is_large_block, iv.size) for iv in got] == \
        [(19, True, 50), (0, False, 100), (1, False, 50)]
    assert [vars(iv) for iv in got] == \
        [vars(iv) for iv in j_locate.locate_data(large, small, dat,
                                                 offset, 200)]


# -- code families -------------------------------------------------------------


def test_code_family_registry():
    fam = t_codes.get_family()
    assert fam is t_codes.get_family("rs_vandermonde")
    assert (fam.data_shards, fam.parity_shards, fam.total_shards,
            fam.sub_shards) == (10, 4, 14, 1)
    assert np.array_equal(fam.encode_matrix(),
                          j_codes.get_family().encode_matrix())
    assert np.array_equal(fam.parity_matrix(),
                          j_codes.get_family().parity_matrix())
    for name in ("cauchy", "pm_msr"):
        other = t_codes.get_family(name)
        assert np.array_equal(other.encode_matrix(),
                              j_codes.get_family(name).encode_matrix())
        with pytest.raises(FileNotFoundError):
            t_enc.write_ec_files("/nonexistent", family=name, device="cpu")
    with pytest.raises(ValueError):
        t_codes.get_family("nope")


@pytest.mark.parametrize("lost", [(0,), (3, 12), (0, 5, 11, 13),
                                  (10, 11, 12, 13), (1, 2, 3, 4)])
def test_decode_rows_equal_jax(lost):
    survivors = [s for s in range(14) if s not in lost][:10]
    fam, jfam = t_codes.get_family(), j_codes.get_family()
    want = jfam.decode_rows(survivors, lost)
    assert np.array_equal(fam.decode_rows(survivors, lost), want)
    # the generic planner and its cache give the same rows as RS's own
    generic = t_codes.CodeFamily.decode_rows(fam, survivors, lost)
    assert np.array_equal(generic, want)
    assert t_codes.CodeFamily.decode_rows(fam, survivors, lost) is generic


class _TwoLanes:
    """A two-lane geometry for the lane views (no such family is ported
    yet; the views are the contract families with sub_shards > 1 use)."""
    name, data_shards, parity_shards, sub_shards = "two", 10, 4, 2


def test_lane_views_equal_jax():
    port = type("P", (_TwoLanes, t_codes.CodeFamily), {})()
    ref = type("J", (_TwoLanes, j_codes.CodeFamily), {})()
    x = np.random.default_rng(0).integers(0, 256, (3, 40), dtype=np.uint8)
    lanes = port.to_lanes(x)
    assert np.array_equal(lanes, ref.to_lanes(x))
    assert np.array_equal(port.from_lanes(lanes), x)
    with pytest.raises(t_codec.ReconstructError):
        port.to_lanes(x[:, :39])


# -- .ecx and encode ----------------------------------------------------------


def test_ecx_identical_over_jax_volume(jax_encoded, tmp_path):
    d, base, _ = jax_encoded
    other = str(tmp_path / "1")
    shutil.copy(base + ".idx", other + ".idx")
    t_enc.write_sorted_file_from_idx(other)
    assert open(other + ".ecx", "rb").read() == \
        open(base + ".ecx", "rb").read()


def test_port_encode_equals_jax_encode(port_encoded, tmp_path):
    d, base, _ = port_encoded
    ref = str(tmp_path / "1")
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, ref + ext)
    j_enc.write_ec_files(ref, large_block_size=LARGE, small_block_size=SMALL,
                         batched=True)
    j_enc.write_sorted_file_from_idx(ref)
    for ext in [to_ext(i) for i in range(14)] + [".ecx"]:
        assert open(base + ext, "rb").read() == open(ref + ext, "rb").read()


# -- degraded reads -------------------------------------------------------------


LOSS_PATTERNS = [()] + [tuple(sorted(random.Random(k).sample(range(14), n)))
                        for n in (1, 2, 3, 4) for k in range(2)] + \
    [(0, 5, 11, 13), (0, 1, 2, 3), (10, 11, 12, 13)]


@pytest.mark.parametrize("lost", LOSS_PATTERNS,
                         ids=lambda p: "-".join(map(str, p)) or "none")
def test_port_reads_jax_volume(jax_encoded, k1_plain, lost):
    d, _, live = jax_encoded
    ev = _mount(t_ecv, d, lost, device="cpu")
    _read_every_needle(ev, live, t_ecv.EcError)
    ev.close()


@pytest.mark.parametrize("lost", LOSS_PATTERNS[::2],
                         ids=lambda p: "-".join(map(str, p)) or "none")
def test_jax_reads_port_volume(port_encoded, lost):
    d, _, live = port_encoded
    ev = _mount(j_ecv, d, lost)
    _read_every_needle(ev, live, j_ecv.EcError)
    ev.close()


@pytest.mark.parametrize("route", ["host", "k1_plain"])
def test_degraded_read_routes(port_encoded, monkeypatch, route):
    """Both routes of reconstruct_span serve every needle; the size
    threshold alone picks the route."""
    d, _, live = port_encoded
    calls = []
    real = t_codec.apply_matrix

    def counting(rows, data, out=None):
        calls.append(tuple(data.shape))
        return real(rows, data, out)

    monkeypatch.setattr(t_codec, "apply_matrix", counting)
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
    if route == "k1_plain":
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")
    ev = _mount(t_ecv, d, (0, 5, 11, 13), device="cpu")
    _read_every_needle(ev, live, t_ecv.EcError)
    ev.close()
    # the volume's survivor stacks are far below the default 512 KiB
    assert bool(calls) == (route == "k1_plain")


@pytest.mark.parametrize("n", [1, 100, 64 * 1024 + 3])
def test_reconstruct_span_routes_equal_jax(monkeypatch, n):
    rng = np.random.default_rng(n)
    survivors = [0, 1, 2, 4, 6, 7, 8, 9, 10, 12]
    inputs = rng.integers(0, 256, (10, n), dtype=np.uint8)
    want = j_codec.reconstruct_span(survivors, inputs, 3)
    fam = t_codes.get_family()
    # slab_key is the stack's content identity (resident in the pool)
    key = hashlib.blake2b(inputs.tobytes(), digest_size=16).digest()
    for knob in ("0", "1", "auto"):
        monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", knob)
        for min_kb in ("0", "", "bad"):
            monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", min_kb)
            for family in (None, fam):
                got = t_codec.reconstruct_span(survivors, inputs, 3,
                                               slab_key=key, family=family,
                                               device="cpu")
                assert np.array_equal(got, want)


def test_recover_knobs_and_device_switch(monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.delenv("WEED_EC_RECOVER_DEVICE", raising=False)
    assert not t_codec.recover_device_enabled(cpu)
    assert t_codec.recover_device_enabled(card)
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "0")
    assert not t_codec.recover_device_enabled(card)
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "force")
    assert t_codec.recover_device_enabled(cpu)
    monkeypatch.delenv("WEED_EC_RECOVER_DEVICE_MIN_KB", raising=False)
    assert t_codec.recover_device_min_bytes() == 512 << 10
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "64")
    assert t_codec.recover_device_min_bytes() == 64 << 10
    for env, want in (({}, (64 << 20, 256 << 10, True)),
                      ({"WEED_EC_RECOVER_CACHE_MB": "0.5",
                        "WEED_EC_RECOVER_BLOCK_KB": "0",
                        "WEED_EC_RECOVER_COALESCE": "no"},
                       (1 << 19, 0, False))):
        for k in ("CACHE_MB", "BLOCK_KB", "COALESCE"):
            monkeypatch.delenv("WEED_EC_RECOVER_" + k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert t_recover.recover_knobs() == want
        from seaweedfs_tpu.storage.erasure_coding import recover as j_rec
        assert j_rec.recover_knobs() == want


def test_failing_decode_launch_raises(port_encoded, k1_plain, monkeypatch):
    """No route hides the device: a failing K1 launch fails the read."""
    d, _, live = port_encoded

    def broken(rows, data, out=None):
        raise RuntimeError("gf_apply launch failed: cudaError 700")

    monkeypatch.setattr(t_codec, "apply_matrix", broken)
    ev = _mount(t_ecv, d, (0,), device="cpu")
    behind_lost = [nid for nid in live
                   if any(iv.to_shard_id_and_offset(LARGE, SMALL)[0] == 0
                          for iv in ev.locate_needle(nid)[2])]
    assert behind_lost
    with pytest.raises(RuntimeError, match="cudaError"):
        ev.read_needle(behind_lost[0])
    ev.close()


def test_knobs_off_reads_stay_correct(jax_encoded, k1_plain, monkeypatch):
    monkeypatch.setenv("WEED_EC_RECOVER_CACHE_MB", "0")
    monkeypatch.setenv("WEED_EC_RECOVER_BLOCK_KB", "0")
    monkeypatch.setenv("WEED_EC_RECOVER_COALESCE", "0")
    d, _, live = jax_encoded
    ev = _mount(t_ecv, d, (0, 5, 11, 13), device="cpu")
    before = t_recover.STATS.snapshot()
    _read_every_needle(ev, live, t_ecv.EcError)
    after = ev.recover_stats()
    assert after["cache_hits"] == before["cache_hits"]
    assert after["cache_misses"] > before["cache_misses"]
    assert after["cache_blocks"] == 0
    ev.close()


def test_exact_span_recovery_without_local_shards(jax_encoded, k1_plain):
    """No local shard: the exact span is the unit, survivors come from
    the remote hook, and the lost shard's holder answers nothing."""
    d, base, _ = jax_encoded
    shard_bytes = {i: open(base + to_ext(i), "rb").read() for i in range(14)}
    ev = _mount(t_ecv, d, range(14), device="cpu")
    calls = []

    def remote(sid, offset, size):
        if sid in (0, 3):
            raise OSError("holder down")
        calls.append(sid)
        return shard_bytes[sid][offset:offset + size]

    ev.remote_reader = remote
    assert ev.read_shard_span(0, 37, 150) == shard_bytes[0][37:187]
    n = len(calls)
    assert ev.read_shard_span(0, 37, 150) == shard_bytes[0][37:187]
    assert len(calls) == n  # served from the recovered-block cache
    ev.close()


def test_concurrent_readers_stack_spans(jax_encoded, k1_plain, monkeypatch):
    """8 reader threads over distinct blocks of one lost shard: the
    decode batcher stacks their spans into shared decodes, and the
    results stay exact."""
    monkeypatch.setenv("WEED_EC_RECOVER_BLOCK_KB", str(SMALL / 1024))
    d, base, _ = jax_encoded
    shard0 = open(base + to_ext(0), "rb").read()
    ev = _mount(t_ecv, d, (0,), device="cpu")
    batcher = ev._recover_batcher
    real = batcher._decode_fn
    first = threading.Event()

    def queued() -> int:
        with batcher._lock:
            return sum(len(q) for q in batcher._queues.values())

    def slow_first(survivors, target, inputs, spans):
        if not first.is_set():
            # hold the first decode until the other 7 spans have queued
            first.set()
            gate.wait(timeout=30)
            deadline = time.monotonic() + 30
            while queued() < 7 and time.monotonic() < deadline:
                time.sleep(0.001)
        return real(survivors, target, inputs, spans)

    batcher._decode_fn = slow_first
    gate = threading.Barrier(8)
    before = t_recover.STATS.snapshot()
    results = [None] * 8
    offsets = [k * SMALL for k in range(8)]

    def reader(i):
        if i:
            first.wait(timeout=30)
            gate.wait(timeout=30)
        results[i] = ev.read_shard_span(0, offsets[i], 60)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    for i in range(8):
        assert results[i] == shard0[offsets[i]:offsets[i] + 60]
    after = ev.recover_stats()
    assert after["batched_spans"] - before["batched_spans"] == 7
    assert after["spans"] - before["spans"] == 8
    assert after["batches"] - before["batches"] == 2
    ev.close()


def test_concurrent_readers_every_needle(port_encoded, k1_plain):
    """8 threads read every needle behind 4 lost shards at once."""
    d, _, live = port_encoded
    ev = _mount(t_ecv, d, (0, 5, 11, 13), device="cpu")
    errors = []
    items = list(live.items())

    def reader(k):
        try:
            for nid, (cookie, data) in items[k::8]:
                assert ev.read_needle(nid, cookie=cookie).data == data
        except BaseException as e:  # re-raised in the main thread below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    ev.close()


def test_launch_counter_exact_under_threads():
    """count_launch from 8 threads: no increment is lost."""
    rs_cuda.reset_launches()
    per_thread = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            rs_cuda.count_launch("gf_apply") for _ in range(per_thread)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert rs_cuda.launches["gf_apply"] == 8 * per_thread
    assert rs_cuda.launches["fused_apply_crc"] == 0
    rs_cuda.reset_launches()
    assert set(rs_cuda.launches.values()) == {0}


def test_mount_without_card_raises(port_encoded, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, _, _ = port_encoded
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ecv.EcVolume(d, "", VID)


def test_shard_bits():
    bits = t_ecv.ShardBits().add(0).add(5).add(13)
    assert bits.shard_ids() == [0, 5, 13] and bits.count() == 3
    assert bits.remove(5) == t_ecv.ShardBits().add(0).add(13)
    assert bits.minus(t_ecv.ShardBits(1)).plus(t_ecv.ShardBits(2)).bits == \
        j_ecv.ShardBits(bits.bits).minus(j_ecv.ShardBits(1)).plus(
            j_ecv.ShardBits(2)).bits
    assert len({bits, t_ecv.ShardBits(bits.bits)}) == 1


def test_missing_needle_and_too_many_lost(port_encoded, k1_plain):
    d, _, live = port_encoded
    ev = _mount(t_ecv, d, (0, 1, 2, 3, 4), device="cpu")
    with pytest.raises(t_ecv.EcNotFoundError):
        ev.read_needle(10_000)
    with pytest.raises(t_ecv.EcError, match="need 10 shards"):
        for nid, (cookie, _) in live.items():
            ev.read_needle(nid, cookie=cookie)
    ev.close()


# -- delete, journal and decode ---------------------------------------------------


@pytest.mark.parametrize("deleted", [(), (2, 9), (1, 50, 25, 26)])
def test_delete_journal_and_decode_equal_jax(jax_encoded, tmp_path, k1_plain,
                                             deleted):
    d, base, live = jax_encoded
    td = _copy_volume(d, tmp_path / "t")
    jd = _copy_volume(d, tmp_path / "j")
    tev = _mount(t_ecv, td, (3,), device="cpu")
    jev = _mount(j_ecv, jd, (3,))
    for nid in deleted:
        tev.delete_needle(nid)
        jev.delete_needle(nid)
    tev.delete_needle(999_999)  # absent: no journal entry
    for nid in deleted:
        if nid in live:
            with pytest.raises(t_ecv.EcDeletedError):
                tev.read_needle(nid)
    tev.close()
    jev.close()
    tb, jb = os.path.join(td, "1"), os.path.join(jd, "1")
    for ext in (".ecx", ".ecj"):
        assert open(tb + ext, "rb").read() == open(jb + ext, "rb").read()
    # decode back to a volume, before and after folding the journal
    for b, dec in ((tb, t_dec), (jb, j_dec)):
        os.rename(b + ".dat", b + ".dat.orig")
        os.rename(b + ".idx", b + ".idx.orig")
        size = dec.find_dat_file_size(b, b)
        dec.write_dat_file(b, size, large_block_size=LARGE,
                           small_block_size=SMALL)
        dec.write_idx_file_from_ec_index(b)
    assert t_dec.read_ec_volume_version(tb) == 3
    for ext in (".dat", ".idx"):
        assert open(tb + ext, "rb").read() == open(jb + ext, "rb").read()
    t_ecv.rebuild_ecx_file(tb)
    j_ecv.rebuild_ecx_file(jb)
    assert not os.path.exists(tb + ".ecj")
    assert open(tb + ".ecx", "rb").read() == open(jb + ".ecx", "rb").read()
    # the decoded volume loads in either package and serves the survivors
    for mod, d2 in ((t_volume, td), (j_volume, td)):
        vol = mod.Volume(d2, "", VID)
        for nid, (cookie, data) in live.items():
            if nid not in deleted:
                assert vol.read_needle(nid, cookie=cookie).data == data
        vol.close()


def test_rebuild_then_decode_is_byte_identical(port_encoded, tmp_path):
    """The tentpole's last step at small size: lose 4 shards, rebuild
    them (K2's plain version), decode to .dat/.idx equal to the
    originals."""
    d, base, _ = port_encoded
    td = _copy_volume(d, tmp_path / "t")
    b = os.path.join(td, "1")
    originals = {i: open(b + to_ext(i), "rb").read() for i in range(14)}
    for i in (0, 5, 11, 13):
        os.remove(b + to_ext(i))
    got = t_enc.rebuild_ec_files(b, device="cpu")
    assert sorted(got) == [0, 5, 11, 13]
    for i in range(14):
        assert open(b + to_ext(i), "rb").read() == originals[i]
    for ext in (".dat", ".idx"):
        os.rename(b + ext, b + ext + ".orig")
    t_dec.write_dat_file(b, t_dec.find_dat_file_size(b, b),
                         large_block_size=LARGE, small_block_size=SMALL)
    t_dec.write_idx_file_from_ec_index(b)
    for ext in (".dat", ".idx"):
        assert open(b + ext, "rb").read() == open(b + ext + ".orig",
                                                  "rb").read()


def test_large_block_volume_round_trip(tmp_path, k1_plain):
    """A volume past 10 large blocks: reads cross from the large rows to
    the small ones, through reconstruction."""
    d = str(tmp_path)
    v = t_volume.Volume(d, "", VID)
    rng = np.random.default_rng(5)
    live = {}
    for i in range(1, 90):
        data = rng.bytes(int(rng.integers(1000, 3000)))
        n = t_needle.Needle.create(data)
        n.id, n.cookie = i, i
        v.write_needle(n)
        live[i] = (i, data)
    base = v.file_name()
    v.close()
    assert os.path.getsize(base + ".dat") > LARGE * 10 + SMALL * 10
    t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    t_enc.write_sorted_file_from_idx(base)
    for lost in ((1, 2, 3, 4), (0, 9, 10, 12)):
        ev = _mount(t_ecv, d, lost, device="cpu")
        _read_every_needle(ev, live, t_ecv.EcError)
        ev.close()
        jev = _mount(j_ecv, d, lost)
        _read_every_needle(jev, live, j_ecv.EcError)
        jev.close()


def test_recovered_block_cache_lru_and_single_flight():
    stats = t_recover.RecoverStats()
    cache = t_recover.RecoveredBlockCache(stats)
    assert cache.get_or_recover(("a",), lambda: b"x" * 10, 25, True) == \
        b"x" * 10
    assert cache.get_or_recover(("a",), lambda: b"?", 25, True) == b"x" * 10
    cache.get_or_recover(("b",), lambda: b"y" * 10, 25, True)
    cache.get_or_recover(("c",), lambda: b"z" * 10, 25, True)  # evicts a
    assert len(cache) == 2 and cache.size_bytes == 20
    assert cache.get_or_recover(("d",), lambda: b"w" * 30, 25, True) == \
        b"w" * 30  # oversized: served, never cached
    assert len(cache) == 2
    with pytest.raises(ValueError):
        cache.get_or_recover(("e",), lambda: (_ for _ in ()).throw(
            ValueError("boom")), 25, True)
    snap = stats.snapshot(wall=1.0)
    assert (snap["cache_hits"], snap["cache_misses"]) == (1, 5)
    assert "fetch_frac" in snap
    stats.reset()
    assert stats.snapshot()["cache_misses"] == 0


def test_batcher_error_reaches_every_waiter():
    stats = t_recover.RecoverStats()

    def bad(survivors, target, inputs, spans):
        raise RuntimeError("decode failed")

    batcher = t_recover.SpanDecodeBatcher(bad, stats)
    with pytest.raises(RuntimeError):
        batcher.decode((0,), 1, np.zeros((1, 4), dtype=np.uint8))
    assert stats.snapshot()["batches"] == 0


@pytest.mark.parametrize("seed", range(3))
def test_search_sorted_index_equals_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 40, 300))
    path = tmp_path / "x.ecx"
    path.write_bytes(b"".join(
        int(k).to_bytes(8, "big") + bytes(8) for k in keys))
    with open(path, "rb") as f:
        for k in itertools.chain(keys[::7], rng.integers(1, 1 << 40, 50)):
            assert t_ecv.search_sorted_index(f.fileno(), len(keys), int(k)) \
                == j_ecv.search_sorted_index(f.fileno(), len(keys), int(k))


# -- F4: the resident decode route --------------------------------------------


@pytest.mark.parametrize("nids,hits", [((1,), 1), ((1, 2, 3), 3)])
def test_second_decode_reuses_the_resident_upload_like_jax(
        jax_encoded, k1_plain, tmp_path, nids, hits):
    """Needles read twice with .ec00 and .ec05 lost, the recovered block
    cache cleared between the passes: the second pass decodes the same
    survivor spans again, and both packages serve it from the slab
    already resident on the device: one upload of the 41,000-byte
    survivor stack, one resident slab.  Needle 1 lies in .ec00 and
    needle 2 in .ec05 of the same row, so reading needles 1-3 adds a hit
    in each pass for the other lost shard (needle 3 then hits the
    recovered block cache)."""
    from seaweedfs_tpu.ops import device_pool as j_pool
    from seaweedfs_tpu_torch.ops import device_pool as t_pool

    d, _, live = jax_encoded
    snaps = []
    for mod, pool_mod, name in ((t_ecv, t_pool, "t"), (j_ecv, j_pool, "j")):
        pool_mod.reset_pool()
        kw = {"device": "cpu"} if mod is t_ecv else {}
        ev = _mount(mod, _copy_volume(d, tmp_path / name), lost=(0, 5), **kw)
        try:
            for _ in range(2):
                ev._recover_cache.clear()
                for nid in nids:
                    cookie, data = live[nid]
                    assert ev.read_needle(nid, cookie=cookie).data == data
            snap = pool_mod.get_pool().snapshot()
        finally:
            ev.close()
            pool_mod.reset_pool()
        snaps.append({k: snap[k] for k in ("resident_hits",
                                           "resident_slabs", "h2d_bytes")})
    assert snaps[0] == snaps[1] == {"resident_hits": hits,
                                    "resident_slabs": 1,
                                    "h2d_bytes": 41000}


def test_resident_keys_are_the_mount_and_the_spans(jax_encoded, k1_plain,
                                                   tmp_path):
    """A resident survivor stack is keyed by the mount and the spans'
    positions: the same span decoded again hits it, a remount of the
    same volume never meets an earlier mount's upload, and a stack the
    tail stripe helped fill is not kept at all."""
    from seaweedfs_tpu_torch.ops import device_pool as t_pool

    d, _, live = jax_encoded
    d = _copy_volume(d, tmp_path / "t")
    cookie, data = live[1]
    t_pool.reset_pool()
    try:
        for mount in range(2):
            ev = _mount(t_ecv, d, lost=(0, 5), device="cpu")
            try:
                for _ in range(2):
                    ev._recover_cache.clear()
                    assert ev.read_needle(1, cookie=cookie).data == data
                survivors = tuple(i for i in range(14)
                                  if i not in (0, 5))[:10]
                stack = np.stack([np.frombuffer(
                    ev.shards[i].read_at(64, 0), dtype=np.uint8)
                    for i in survivors])
                slabs = t_pool.get_pool().snapshot()["resident_slabs"]
                ev._decode_span(survivors, 0, stack, ((0, 64), None))
                assert t_pool.get_pool().snapshot()["resident_slabs"] \
                    == slabs
            finally:
                ev.close()
            snap = t_pool.get_pool().snapshot()
            assert (snap["resident_hits"], snap["resident_slabs"],
                    snap["h2d_bytes"]) == (mount + 1, mount + 1,
                                           (41000 + 640) * (mount + 1))
    finally:
        t_pool.reset_pool()


def test_batcher_hands_the_spans_in_stacking_order():
    seen = []

    def decode(survivors, target, inputs, spans):
        seen.append(spans)
        return inputs[0]

    batcher = t_recover.SpanDecodeBatcher(decode, t_recover.RecoverStats())
    out = batcher.decode((1, 2), 0, np.ones((2, 5), dtype=np.uint8),
                         span=(40, 5))
    assert out.tolist() == [1] * 5 and seen == [((40, 5),)]
    batcher._decode_batch((1, 2), 0, [
        t_recover._DecodeReq(np.zeros((2, 3), dtype=np.uint8), (0, 3)),
        t_recover._DecodeReq(np.ones((2, 2), dtype=np.uint8), None)])
    assert seen[1] == ((0, 3), None)
