"""The port's needle and volume formats against the JAX package: needles,
.idx entries, TTLs, superblocks, .vif sidecars, needle maps and whole
volumes, byte for byte (tolerance 0), with each package reading what the
other wrote."""

import itertools
import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import backend as j_backend
from seaweedfs_tpu.storage import idx as j_idx
from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import needle_map as j_nm
from seaweedfs_tpu.storage import super_block as j_sb
from seaweedfs_tpu.storage import ttl as j_ttl
from seaweedfs_tpu.storage import types as j_types
from seaweedfs_tpu.storage import volume as j_volume
from seaweedfs_tpu.storage import volume_info as j_vif
from seaweedfs_tpu_torch.ops import crc32c as t_crc
from seaweedfs_tpu_torch.storage import backend as t_backend
from seaweedfs_tpu_torch.storage import idx as t_idx
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import needle_map as t_nm
from seaweedfs_tpu_torch.storage import super_block as t_sb
from seaweedfs_tpu_torch.storage import ttl as t_ttl
from seaweedfs_tpu_torch.storage import types as t_types
from seaweedfs_tpu_torch.storage import volume as t_volume
from seaweedfs_tpu_torch.storage import volume_info as t_vif

FLAGS = ("name", "mime", "last_modified", "ttl", "pairs", "compressed",
         "manifest")
FLAG_SETS = [c for r in range(len(FLAGS) + 1)
             for c in itertools.combinations(FLAGS, r)]


def _needle_parts(rng, flags, size=None) -> dict:
    """Seeded Needle.create keyword arguments with the given flags on."""
    size = int(rng.integers(1, 600)) if size is None else size
    kw = {"data": rng.bytes(size)}
    if "name" in flags:
        kw["name"] = b"file-" + rng.bytes(8).hex().encode()
    if "mime" in flags:
        kw["mime"] = b"image/jpeg"
    if "last_modified" in flags:
        kw["last_modified"] = int(rng.integers(1, 1 << 39))
    if "pairs" in flags:
        kw["pairs"] = b'{"Seaweed-k":"' + rng.bytes(4).hex().encode() + b'"}'
    if "compressed" in flags:
        kw["is_compressed"] = True
    if "manifest" in flags:
        kw["is_chunk_manifest"] = True
    return kw


def _both_needles(kw, flags, nid, cookie, ns):
    out = []
    for mod, ttl_mod in ((j_needle, j_ttl), (t_needle, t_ttl)):
        extra = {"ttl": ttl_mod.TTL.parse("3d")} if "ttl" in flags else {}
        n = mod.Needle.create(**kw, **extra)
        n.id, n.cookie, n.append_at_ns = nid, cookie, ns
        out.append(n)
    return out


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("flags", FLAG_SETS[::3] + [FLAGS],
                         ids=lambda f: "+".join(f) or "plain")
def test_needle_bytes_equal_and_cross_parse(version, flags):
    rng = np.random.default_rng(len(flags) * 10 + version)
    kw = _needle_parts(rng, flags)
    jn, tn = _both_needles(kw, flags, 0x1234567890ab, 0xdeadbeef,
                           1_700_000_000_123_456_789)
    blob = tn.to_bytes(version)
    assert blob == jn.to_bytes(version)
    assert tn.size == jn.size
    for reader, n in ((t_needle, tn), (j_needle, jn)):
        got = reader.Needle()
        got.read_bytes(blob, 8, n.size, version)
        assert (got.id, got.cookie, got.data) == (n.id, n.cookie, n.data)
        assert got.checksum == t_crc.crc32c(kw["data"])
        if version > 1:
            assert (got.flags, got.name, got.mime, got.pairs,
                    got.last_modified, str(got.ttl)) == \
                (n.flags, n.name, n.mime, n.pairs, n.last_modified,
                 str(n.ttl))
        if version == 3:
            assert got.append_at_ns == n.append_at_ns
    assert t_needle.get_actual_size(tn.size, version) == len(blob) == \
        j_needle.get_actual_size(jn.size, version)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_needle_header_body_and_errors_match(version):
    rng = np.random.default_rng(version)
    kw = _needle_parts(rng, ("name", "ttl"), size=333)
    jn, tn = _both_needles(kw, ("name", "ttl"), 77, 99, 5)
    blob = bytearray(tn.to_bytes(version))
    th, tsize = t_needle.read_needle_header(bytes(blob[:16]))
    jh, jsize = j_needle.read_needle_header(bytes(blob[:16]))
    assert (th.id, th.cookie, tsize) == (jh.id, jh.cookie, jsize)
    body = bytes(blob[16:])
    th.read_needle_body(body, version)
    jh.read_needle_body(body, version)
    assert (th.data, th.checksum, th.append_at_ns) == \
        (jh.data, jh.checksum, jh.append_at_ns)
    # the legacy rotated CRC form is accepted by both
    crc_at = 16 + tn.size
    legacy = t_crc.value(tn.checksum).to_bytes(4, "big")
    assert t_crc.value(tn.checksum) == j_needle.crc32c_mod.value(tn.checksum)
    ok = bytes(blob[:crc_at]) + legacy + bytes(blob[crc_at + 4:])
    for mod in (t_needle, j_needle):
        mod.Needle().read_bytes(ok, 8, tn.size, version)
    blob[20] ^= 0xFF  # inside the data
    with pytest.raises(t_needle.CrcError):
        t_needle.Needle().read_bytes(bytes(blob), 8, tn.size, version)
    with pytest.raises(t_needle.SizeMismatchError):
        t_needle.Needle().read_bytes(bytes(blob), 8, tn.size + 1, version)


def test_empty_needle_tombstone_shape():
    for version in (1, 2, 3):
        tn = t_needle.Needle(id=5, cookie=6, append_at_ns=7)
        jn = j_needle.Needle(id=5, cookie=6, append_at_ns=7)
        assert tn.to_bytes(version) == jn.to_bytes(version)
        assert tn.size == 0


def test_types_round_trips_equal():
    rng = np.random.default_rng(3)
    for off in rng.integers(0, 1 << 35, 200) // 8 * 8:
        off = int(off)
        assert t_types.offset_to_bytes(off) == j_types.offset_to_bytes(off)
        assert t_types.offset_from_bytes(t_types.offset_to_bytes(off)) == off
    for size in [0, 1, -1, -5, (1 << 31) - 1] + list(rng.integers(
            -(1 << 31), 1 << 31, 100)):
        b = t_types.size_to_bytes(int(size))
        assert b == j_types.size_to_bytes(int(size))
        assert t_types.size_from_bytes(b) == j_types.size_from_bytes(b) \
            == int(size)
    for vid, nid, cookie in [(1, 0x123, 0xabcdef01), (77, 1 << 60, 0)]:
        fid = t_types.format_file_id(vid, nid, cookie)
        assert fid == j_types.format_file_id(vid, nid, cookie)
        assert t_types.parse_file_id(fid) == (vid, nid, cookie)
        assert t_types.parse_file_id(fid + "_3") == \
            j_types.parse_file_id(fid + "_3")
    for bad in ("nocomma", "1,abc", "1," + "f" * 30):
        with pytest.raises(ValueError):
            t_types.parse_file_id(bad)


@pytest.mark.parametrize("spec", ["", "5", "3m", "4h", "5d", "6w", "7M",
                                  "8y"])
def test_ttl_round_trips_equal(spec):
    tt, jt = t_ttl.TTL.parse(spec), j_ttl.TTL.parse(spec)
    assert tt.to_bytes() == jt.to_bytes()
    assert (str(tt), tt.minutes(), tt.to_uint32(), bool(tt)) == \
        (str(jt), jt.minutes(), jt.to_uint32(), bool(jt))
    assert t_ttl.TTL.from_bytes(jt.to_bytes()) == tt
    assert t_ttl.TTL.from_uint32(jt.to_uint32()) == tt


def test_idx_entries_equal_and_cross_read(tmp_path):
    rng = np.random.default_rng(4)
    entries = [(int(k), int(o) * 8, int(s)) for k, o, s in zip(
        rng.integers(1, 1 << 62, 300), rng.integers(0, 1 << 31, 300),
        rng.integers(-2, 1 << 20, 300))]
    blob = b"".join(t_idx.pack_entry(*e) for e in entries)
    assert blob == b"".join(j_idx.pack_entry(*e) for e in entries)
    assert list(t_idx.iter_index(blob + b"\x01" * 7)) == entries
    path = str(tmp_path / "x.idx")
    with open(path, "wb") as f:
        f.write(blob)
    got, want = [], []
    t_idx.walk_index_file(path, lambda *e: got.append(e))
    j_idx.walk_index_file(path, lambda *e: want.append(e))
    assert got == want == entries


@pytest.mark.parametrize("placement,ttl,extra", [
    ("000", "", b""), ("001", "3d", b""), ("210", "8y", b"\x01\x02\x03"),
    ("100", "4h", b"x" * 300)])
def test_super_block_round_trip_equal(tmp_path, placement, ttl, extra):
    tb = t_sb.SuperBlock(
        replica_placement=t_sb.ReplicaPlacement.parse(placement),
        ttl=t_ttl.TTL.parse(ttl), compaction_revision=513, extra=extra)
    jb = j_sb.SuperBlock(
        replica_placement=j_sb.ReplicaPlacement.parse(placement),
        ttl=j_ttl.TTL.parse(ttl), compaction_revision=513, extra=extra)
    assert tb.to_bytes() == jb.to_bytes()
    assert tb.block_size == jb.block_size
    path = tmp_path / "sb"
    path.write_bytes(jb.to_bytes() + b"rest")
    with open(path, "rb") as f:
        got = t_sb.SuperBlock.from_file(f)
    assert (got.version, str(got.replica_placement), str(got.ttl),
            got.compaction_revision, got.extra) == \
        (3, placement, str(tb.ttl), 513, extra)
    assert got.replica_placement.copy_count() == \
        jb.replica_placement.copy_count()
    path.write_bytes(b"\x09" + bytes(7))
    with open(path, "rb") as f, pytest.raises(t_sb.SuperBlockError):
        t_sb.SuperBlock.from_file(f)


def test_volume_info_cross_read(tmp_path):
    a, b = str(tmp_path / "a.vif"), str(tmp_path / "b.vif")
    files = [t_vif.RemoteFile("s3", "default", "k1", 0, 100, 5, ".dat")]
    t_vif.save_volume_info(a, t_vif.VolumeInfo(
        version=2, replica_placement="010", ttl="3d", files=files))
    j_vif.save_volume_info(b, j_vif.VolumeInfo(
        version=2, replica_placement="010", ttl="3d",
        files=[j_vif.RemoteFile("s3", "default", "k1", 0, 100, 5, ".dat")]))
    assert open(a).read() == open(b).read()
    assert t_vif.load_volume_info(b).to_dict() == \
        j_vif.load_volume_info(a).to_dict()
    assert t_vif.load_volume_info(str(tmp_path / "none.vif")) is None


def _idx_log(rng, n=400) -> bytes:
    """A seeded .idx log with overwrites, deletes and zero sizes."""
    out = []
    for _ in range(n):
        key = int(rng.integers(1, 120))
        r = rng.random()
        if r < 0.2:
            out.append(t_idx.pack_entry(key, 0, t_types.TOMBSTONE_FILE_SIZE))
        elif r < 0.25:
            out.append(t_idx.pack_entry(key, int(rng.integers(1, 1 << 20)) * 8,
                                        0))
        else:
            out.append(t_idx.pack_entry(key, int(rng.integers(1, 1 << 20)) * 8,
                                        int(rng.integers(1, 1 << 16))))
    return b"".join(out)


def _map_state(nm):
    return (nm.file_count, nm.deleted_count, nm.deleted_bytes,
            nm.content_bytes, nm.max_key, len(nm),
            [(k, v.offset, v.size) for k, v in nm.items_ascending()])


@pytest.mark.parametrize("kind", ["memory", "compact", "sqlite"])
def test_needle_map_equals_jax(tmp_path, kind):
    path = str(tmp_path / "m.idx")
    with open(path, "wb") as f:
        f.write(_idx_log(np.random.default_rng(5)))
    got = t_nm.load_needle_map_from_idx(path, kind=kind)
    want = j_nm.load_needle_map_from_idx(path, kind=kind)
    assert _map_state(got) == _map_state(want)
    # an appending map: puts and deletes write the same .idx
    a, b = str(tmp_path / "a.idx"), str(tmp_path / "b.idx")
    tm, jm = t_nm.new_needle_map(kind, a), j_nm.new_needle_map(kind, b)
    for nid, off, size in t_idx.iter_index(_idx_log(
            np.random.default_rng(6), 200)):
        for m in (tm, jm):
            if size == t_types.TOMBSTONE_FILE_SIZE:
                m.delete(nid, 4096)
            else:
                m.put(nid, off or 8, size)
    state = _map_state(tm)
    assert state == _map_state(jm)
    tm.close()
    jm.close()
    assert open(a, "rb").read() == open(b, "rb").read()
    reopened = t_nm.new_needle_map(kind, a)
    assert _map_state(reopened)[:5] == state[:5]
    reopened.close()


def test_needle_map_kinds():
    assert isinstance(t_nm.new_needle_map("sqlite"), t_nm.SqliteNeedleMap)
    with pytest.raises(ValueError):
        t_nm.new_needle_map("nope")
    nm = t_nm.new_needle_map("memory")
    nm.put(3, 8, 10)
    assert 3 in nm and nm.get(3).size == 10 and nm.get(4) is None


def test_disk_file(tmp_path):
    path = str(tmp_path / "f")
    with t_backend.DiskFile(path, create=True) as f:
        assert f.append(b"abc") == 0
        assert f.append(b"defg") == 3
        f.write_at(b"X", 1)
        assert f.read_at(10, 0) == b"aXcdefg"
        f.truncate(2)
        f.sync()
        assert f.size() == 2 and f.name == path
    assert f.fileno() is None


@pytest.fixture
def pinned_clock(monkeypatch):
    """time.time_ns as a counter; calling the fixture's value restarts
    it, so both packages stamp equal append times on equal writes."""
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


def _seeded_ops(seed: int, count: int = 60):
    """(kind, id, cookie, create kwargs, flags) writes, rewrites and
    deletes, each needle's parts from the seed."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(1, count + 1):
        flags = FLAG_SETS[int(rng.integers(0, len(FLAG_SETS)))]
        flags = tuple(f for f in flags if f != "ttl")
        kw = _needle_parts(rng, flags, size=int(rng.integers(1, 2000)))
        ops.append(("write", i, 0x5000 + i, kw))
        if i % 7 == 0:
            ops.append(("delete", i - 3, 0x5000 + i - 3, None))
        if i % 11 == 0:
            ops.append(("write", i - 1, 0x5000 + i - 1,
                        _needle_parts(rng, (), size=100)))
    return ops


def _apply(vol, needle_mod, ops):
    for kind, nid, cookie, kw in ops:
        if kind == "write":
            n = needle_mod.Needle.create(**kw)
            n.id, n.cookie = nid, cookie
            vol.write_needle(n)
        else:
            n = needle_mod.Needle(id=nid, cookie=cookie)
            vol.delete_needle(n)


def _live(ops) -> dict:
    live = {}
    for kind, nid, cookie, kw in ops:
        if kind == "write":
            live[nid] = (cookie, kw["data"])
        else:
            live.pop(nid, None)
    return live


def _read_all(vol, live, deleted_err):
    for nid, (cookie, data) in live.items():
        n = vol.read_needle(nid, cookie=cookie)
        assert n.data == data
    for nid in set(range(1, max(live) + 1)) - set(live):
        with pytest.raises(deleted_err):
            vol.read_needle(nid)


@pytest.mark.parametrize("fsync", [False, True])
def test_volume_files_identical_and_cross_read(tmp_path, pinned_clock,
                                               fsync):
    ops = _seeded_ops(8)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    tv = t_volume.Volume(str(tdir), "c", 9, fsync=fsync)
    _apply(tv, t_needle, ops)
    pinned_clock()
    jv = j_volume.Volume(str(jdir), "c", 9, fsync=fsync)
    _apply(jv, j_needle, ops)
    assert (tv.file_count(), tv.deleted_count(), tv.content_size(),
            tv.deleted_size(), tv.max_file_key()) == \
        (jv.file_count(), jv.deleted_count(), jv.content_size(),
         jv.deleted_size(), jv.max_file_key())
    tv.close()
    jv.close()
    for ext in (".dat", ".idx"):
        assert (tdir / ("c_9" + ext)).read_bytes() == \
            (jdir / ("c_9" + ext)).read_bytes(), ext
    live = _live(ops)
    # each package reads the other's volume (a cold start: superblock,
    # integrity check, needle map from the .idx)
    tv = t_volume.Volume(str(jdir), "c", 9)
    jv = j_volume.Volume(str(tdir), "c", 9)
    _read_all(tv, live, t_volume.DeletedError)
    _read_all(jv, live, j_volume.DeletedError)
    assert tv.last_append_at_ns == jv.last_append_at_ns > 0
    scanned = [(n.id, n.size, n.data, off) for n, off in tv.scan()]
    assert scanned == [(n.id, n.size, n.data, off) for n, off in jv.scan()]
    tv.close()
    jv.close()


def test_volume_write_semantics(tmp_path, pinned_clock):
    v = t_volume.Volume(str(tmp_path), "", 3)
    n = t_needle.Needle.create(b"hello")
    n.id, n.cookie = 1, 42
    off, size, unchanged = v.write_needle(n)
    assert (off, unchanged) == (8, False)
    again = t_needle.Needle.create(b"hello")
    again.id, again.cookie = 1, 42
    assert v.write_needle(again)[2] is True  # identical rewrite deduped
    other = t_needle.Needle.create(b"x")
    other.id, other.cookie = 1, 43
    with pytest.raises(t_volume.CookieMismatchError):
        v.write_needle(other)
    with pytest.raises(t_volume.CookieMismatchError):
        v.read_needle(1, cookie=7)
    with pytest.raises(t_volume.NotFoundError):
        v.read_needle(2)
    assert v.delete_needle(t_needle.Needle(id=1, cookie=42)) == size
    assert v.delete_needle(t_needle.Needle(id=1, cookie=42)) == 0
    with pytest.raises(t_volume.DeletedError):
        v.read_needle(1)
    v.read_only = True
    with pytest.raises(t_volume.VolumeError):
        v.write_needle(n)
    v.close()


def test_volume_truncates_a_torn_tail(tmp_path, pinned_clock):
    v = t_volume.Volume(str(tmp_path), "", 4)
    for i in range(1, 4):
        n = t_needle.Needle.create(bytes([i]) * 100)
        n.id, n.cookie = i, i
        v.write_needle(n)
    v.close()
    dat = tmp_path / "4.dat"
    good = dat.stat().st_size
    with open(dat, "ab") as f:
        f.write(b"\x00" * 13)  # an append torn after its .idx entry
    v = t_volume.Volume(str(tmp_path), "", 4)
    assert dat.stat().st_size == good
    assert v.read_needle(3).data == bytes([3]) * 100
    v.close()


def test_tiered_volume_refused(tmp_path):
    """A .vif naming a tier backend this process has not registered is
    refused by both packages alike (the volume cannot reach its data)."""
    t_vif.save_volume_info(str(tmp_path / "5.vif"), t_vif.VolumeInfo(
        files=[t_vif.RemoteFile("s3", "d", "k")]))
    with pytest.raises(ValueError, match="not configured") as te:
        t_volume.Volume(str(tmp_path), "", 5)
    with pytest.raises(ValueError) as je:
        j_volume.Volume(str(tmp_path), "", 5)
    assert str(te.value) == str(je.value)


# -- compaction, zero-copy slices, backup and offline tools ---------------------


def _seeded_volume(mod_volume, mod_needle, directory, ops, vid=9, **kw):
    v = mod_volume.Volume(str(directory), "c", vid, **kw)
    _apply(v, mod_needle, ops)
    return v


def _dirs(tmp_path):
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    return tdir, jdir


def test_compaction_files_identical(tmp_path, pinned_clock):
    """compact, writes racing the copy, commit_compact (makeup diff):
    both packages leave byte-identical .dat/.idx and the same reads."""
    ops = _seeded_ops(17, count=80)
    race = [("write", 200, 0x9000, {"data": b"late" * 50}),
            ("delete", 5, 0x5005, None), ("write", 7, 0x5007,
                                          {"data": b"rewrite"})]
    tdir, jdir = _dirs(tmp_path)
    vols = []
    for directory, vmod, nmod in ((tdir, t_volume, t_needle),
                                  (jdir, j_volume, j_needle)):
        pinned_clock()
        v = _seeded_volume(vmod, nmod, directory, ops)
        level = v.garbage_level()
        before = v.data.size()  # the .idx may still sit in a write buffer
        v.compact()
        _apply(v, nmod, race)
        v.commit_compact()
        vols.append((v, level, before, v.file_stat(), v.index_file_size(),
                     v.super_block.compaction_revision))
    (tv, *trest), (jv, *jrest) = vols
    assert trest == jrest and trest[0] > 0 and trest[2][0] < trest[1]
    live = _live(ops + race)
    # compaction drops deleted needles from the map: a read of one is a
    # miss, no longer a tombstone
    _read_all(tv, live, (t_volume.DeletedError, t_volume.NotFoundError))
    tv.close()
    jv.close()
    for ext in (".dat", ".idx"):
        assert (tdir / ("c_9" + ext)).read_bytes() == \
            (jdir / ("c_9" + ext)).read_bytes(), ext
    assert not (tdir / "c_9.cpd").exists()


def test_commit_compact_refuses_a_revision_mismatch(tmp_path, pinned_clock):
    v = _seeded_volume(t_volume, t_needle, tmp_path, _seeded_ops(3, 20))
    v.compact()
    _apply(v, t_needle, [("write", 99, 1, {"data": b"x"})])
    v.last_compact_revision += 5
    with pytest.raises(t_volume.VolumeError, match="compact revision"):
        v.commit_compact()
    assert not (tmp_path / "c_9.cpd").exists()
    assert v.read_needle(99).data == b"x"
    v.close()


def test_read_needle_slice_equal(tmp_path, pinned_clock):
    rng = np.random.default_rng(23)
    ops = []
    for i in range(1, 40):
        flags = FLAG_SETS[int(rng.integers(0, len(FLAG_SETS)))]
        flags = tuple(f for f in flags if f != "ttl")
        size = int(rng.choice([0, 10, 5000, 70000]))
        kw = _needle_parts(rng, flags, size=size)
        ops.append(("write", i, 0x700 + i, kw))
    ops.append(("delete", 4, 0x704, None))
    tdir, jdir = _dirs(tmp_path)
    pinned_clock()
    tv = _seeded_volume(t_volume, t_needle, tdir, ops)
    pinned_clock()
    jv = _seeded_volume(j_volume, j_needle, jdir, ops)

    def view(v, errs, nid, cookie, min_size):
        try:
            got = v.read_needle_slice(nid, cookie, min_size=min_size)
        except errs as e:
            return type(e).__name__
        if got is None:
            return None
        n, off, length, fd = got
        try:
            payload = os.pread(fd, length, off)
        finally:
            os.close(fd)
        return (n.id, n.cookie, n.size, n.flags, n.name, n.mime,
                n.last_modified, n.pairs, n.checksum, n.append_at_ns,
                n.etag(), off, length, payload, n.data)

    terrs = (t_volume.NotFoundError, t_volume.DeletedError,
             t_volume.CookieMismatchError)
    jerrs = (j_volume.NotFoundError, j_volume.DeletedError,
             j_volume.CookieMismatchError)
    seen = set()
    for i in range(1, 42):
        for cookie in (0x700 + i, None, 1):
            for min_size in (0, 65536):
                t_view = view(tv, terrs, i, cookie, min_size)
                assert t_view == view(jv, jerrs, i, cookie, min_size)
                seen.add("slice" if isinstance(t_view, tuple)
                         else t_view if isinstance(t_view, str)
                         else "NoneType")
                if isinstance(t_view, tuple):
                    assert t_view[13] == tv.read_needle(i).data
    assert {"slice", "NoneType", "DeletedError", "NotFoundError",
            "CookieMismatchError"} <= seen
    tv.close()
    jv.close()


def test_volume_backup_equal(tmp_path, pinned_clock):
    """binary search by append time, the tail stream and an incremental
    backup between replicas, in both packages on identical volumes."""
    from seaweedfs_tpu.storage import volume_backup as j_vb
    from seaweedfs_tpu_torch.storage import volume_backup as t_vb

    ops = _seeded_ops(29, count=50)
    tdir, jdir = _dirs(tmp_path)
    out = []
    for directory, vmod, nmod, vb in ((tdir, t_volume, t_needle, t_vb),
                                      (jdir, j_volume, j_needle, j_vb)):
        pinned_clock()
        src = _seeded_volume(vmod, nmod, directory, ops[:40])
        stamps = [0, 1_700_000_000_000_000_000]
        for n, off in src.scan():
            stamps.append(n.append_at_ns)
        found = [vb.binary_search_by_append_at_ns(src, s) for s in stamps]
        blob, cursor = vb.read_appended_bytes(src, stamps[10], limit=3000)
        chunks, length, cur2 = vb.iter_appended_bytes(src, stamps[10],
                                                      limit=3000)
        streamed = b"".join(chunks)
        dst = vmod.Volume(str(directory), "c", 10)
        applied = vb.incremental_backup(
            dst, lambda since: vb.read_appended_bytes(src, since,
                                                      limit=2000)[0])
        _apply(src, nmod, ops[40:])
        applied2 = vb.incremental_backup(
            dst, lambda since: vb.read_appended_bytes(src, since)[0])
        out.append((found, blob, cursor, streamed, length, cur2, applied,
                    applied2, dst.last_append_at_ns, dst.file_count()))
        src.close()
        dst.close()
    assert out[0] == out[1]
    assert out[0][1] == out[0][3] and out[0][6] > 0 and out[0][7] > 0
    for ext in (".dat", ".idx"):
        assert (tdir / ("c_10" + ext)).read_bytes() == \
            (jdir / ("c_10" + ext)).read_bytes(), ext
        assert (tdir / ("c_10" + ext)).read_bytes() == \
            (tdir / ("c_9" + ext)).read_bytes(), ext


def test_offline_tools_equal(tmp_path, pinned_clock):
    """scan_dat, rebuild_index, export_volume (with its tar) and
    compact_offline on identical volume files."""
    from seaweedfs_tpu.storage import tools as j_tools
    from seaweedfs_tpu_torch.storage import tools as t_tools

    ops = _seeded_ops(37, count=40)
    tdir, jdir = _dirs(tmp_path)
    out = []
    for directory, vmod, nmod, tools in ((tdir, t_volume, t_needle, t_tools),
                                         (jdir, j_volume, j_needle,
                                          j_tools)):
        pinned_clock()
        _seeded_volume(vmod, nmod, directory, ops).close()
        scanned = [(n.id, n.size, n.data, off) for n, off in
                   tools.scan_dat(str(directory / "c_9.dat"))]
        idx_before = (directory / "c_9.idx").read_bytes()
        (directory / "c_9.idx").unlink()
        count = tools.rebuild_index(str(directory), "c", 9)
        idx_rebuilt = (directory / "c_9.idx").read_bytes()
        tar = str(directory / "export.tar")
        records = tools.export_volume(str(directory), "c", 9,
                                      output_tar=tar)
        records_del = tools.export_volume(str(directory), "c", 9,
                                          include_deleted=True)
        with open(tar, "rb") as f:
            tar_members = sorted(m.name for m in
                                 __import__("tarfile").open(fileobj=f))
        (directory / "c_9.idx").write_bytes(idx_before)
        compacted = tools.compact_offline(str(directory), "c", 9)
        out.append((scanned, count, idx_rebuilt, records, records_del,
                    tar_members, compacted,
                    (directory / "c_9.dat").read_bytes(),
                    (directory / "c_9.idx").read_bytes()))
    assert out[0] == out[1]
    assert out[0][6]["reclaimed"] > 0 and len(out[0][3]) > 0


def test_scrub_ec_volume_equal(tmp_path):
    """scrub_ec_volume reports and repairs a corrupt and a missing shard
    equal to the JAX package's, rebuilt shards byte-identical."""
    from seaweedfs_tpu.storage import tools as j_tools
    from seaweedfs_tpu_torch.storage import tools as t_tools
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    v = t_volume.Volume(str(src), "", 7)
    for i in range(1, 30):
        n = t_needle.Needle.create(rng.bytes(int(rng.integers(100, 30000))))
        n.id, n.cookie = i, i
        v.write_needle(n)
    v.close()
    base = str(src / "7")
    crcs = t_enc.write_ec_files(base, 10000, 100, device="cpu", batched=True)
    t_enc.save_volume_info(base, version=3,
                           extra={"shard_crc32c": list(crcs)})
    out = []
    for name, tools in (("t", t_tools), ("j", j_tools)):
        d = tmp_path / name
        shutil.copytree(src, d)
        with open(d / "7.ec03", "r+b") as f:
            f.seek(17)
            f.write(b"\xff")
        (d / "7.ec12").unlink()
        kw = {"device": "cpu"} if tools is t_tools else {}
        clean = tools.scrub_ec_volume(str(d), "", 7, **kw)
        repaired = tools.scrub_ec_volume(str(d), "", 7, repair=True, **kw)
        after = tools.scrub_ec_volume(str(d), "", 7, **kw)
        out.append((clean, repaired, after,
                    [(d / f"7.ec{i:02d}").read_bytes() for i in range(14)]))
    assert out[0] == out[1]
    assert out[0][1]["repaired"] == [3, 12]
    assert out[0][2]["corrupt"] == [] and out[0][2]["missing"] == []
    assert out[0][3] == [(src / f"7.ec{i:02d}").read_bytes()
                         for i in range(14)]


def test_needle_parse_path_and_etag_equal():
    for fid in ["01637037d6", "1637037d6_3", "ab00000000", "ffffffff0a0b0c0d"]:
        got = []
        for mod in (t_needle, j_needle):
            n = mod.Needle()
            n.parse_path(fid)
            got.append((n.id, n.cookie))
        assert got[0] == got[1], fid
    for data in (b"", b"x", b"hello" * 1000):
        assert t_needle.Needle.create(data).etag() == \
            j_needle.Needle.create(data).etag()


def test_needle_map_ascending_visit_equal(tmp_path):
    rng = np.random.default_rng(3)
    got = []
    for mod, d in ((t_nm, tmp_path / "t"), (j_nm, tmp_path / "j")):
        d.mkdir()
        nm = mod.NeedleMap(str(d / "1.idx"))
        for _ in range(300):
            nid = int(rng.integers(1, 200))
            if rng.random() < 0.8:
                nm.put(nid, int(rng.integers(1, 1 << 20)) * 8,
                       int(rng.integers(1, 5000)))
            else:
                nm.delete(nid, 8)
        seen = []
        nm.ascending_visit(lambda nid, nv: seen.append(
            (nid, nv.offset, nv.size)))
        nm.close()
        got.append(seen)
        rng = np.random.default_rng(3)
    assert got[0] == got[1] and got[0] == sorted(got[0])


# -- the worker's .idx tail, the sqlite kind, MmapFile, disk fault hooks --------


@pytest.mark.parametrize("kind", ["memory", "compact", "sqlite"])
def test_refresh_from_idx_equals_jax(tmp_path, monkeypatch, kind):
    """A reader map tails what a writer map appends to the same .idx
    (FLUSH_APPENDS, as a prefork server sets it): the port's and the JAX
    package's readers reach the writer's state, applying the same counts,
    and their sqlite DBs reopen to it."""
    from seaweedfs_tpu_torch.storage import needle_map as nm_mod

    monkeypatch.setattr(nm_mod, "FLUSH_APPENDS", True)
    monkeypatch.setattr(j_nm, "FLUSH_APPENDS", True)
    entries = list(t_idx.iter_index(_idx_log(np.random.default_rng(12),
                                             150)))
    got = {}
    for name, mod in (("t", t_nm), ("j", j_nm)):
        path = str(tmp_path / f"{name}.idx")
        writer = mod.new_needle_map(kind, path)
        # a sqlite reader keeps a DB of its own beside the writer's
        reader = (mod.SqliteNeedleMap(path, db_path=path + ".reader")
                  if kind == "sqlite" else mod.new_needle_map(kind, path))
        applied = []
        for i, (nid, off, size) in enumerate(entries):
            if size == t_types.TOMBSTONE_FILE_SIZE:
                writer.delete(nid, 4096)
            else:
                writer.put(nid, off or 8, size)
            if i % 37 == 36:
                applied.append(reader.refresh_from_idx())
        applied.append(reader.refresh_from_idx())
        applied.append(reader.refresh_from_idx())
        got[name] = (applied, _map_state(reader), _map_state(writer)[-1])
        writer.close()
        reader.close()
    assert got["t"] == got["j"]
    assert got["t"][1][-1] == got["t"][2] and got["t"][0][-1] == 0


def test_sqlite_map_volume_files_equal(tmp_path, pinned_clock):
    """A volume on the sqlite kind writes the same .dat/.idx and reads the
    same needles as the JAX package's, and reopens from its DB."""
    ops = _seeded_ops(21, 40)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    tv = t_volume.Volume(str(tdir), "", 4, needle_map_kind="sqlite")
    _apply(tv, t_needle, ops)
    pinned_clock()
    jv = j_volume.Volume(str(jdir), "", 4, needle_map_kind="sqlite")
    _apply(jv, j_needle, ops)
    assert isinstance(tv.nm, t_nm.SqliteNeedleMap)
    tv.close()
    jv.close()
    for ext in (".dat", ".idx"):
        assert (tdir / f"4{ext}").read_bytes() == \
            (jdir / f"4{ext}").read_bytes()
    tv = t_volume.Volume(str(tdir), "", 4, needle_map_kind="sqlite")
    jv = j_volume.Volume(str(jdir), "", 4, needle_map_kind="sqlite")
    try:
        assert _map_state(tv.nm) == _map_state(jv.nm)
        _read_all(tv, _live(ops), t_volume.DeletedError)
    finally:
        tv.close()
        jv.close()


def test_mmap_file_equals_jax(tmp_path):
    """The same operations on both packages' MmapFile: the same reads
    (through the mapping, regrown after appends), sizes and file bytes."""
    files = {}
    for name, mod in (("t", t_backend), ("j", j_backend)):
        path = str(tmp_path / f"{name}.bin")
        f = mod.MmapFile(path, create=True)
        log = [f.read_at(10, 0), f.size()]
        r = np.random.default_rng(14)
        for i in range(30):
            blob = r.bytes(int(r.integers(1, 9000)))
            log.append(f.append(blob))
            off = int(r.integers(0, f.size()))
            log.append(f.read_at(int(r.integers(1, 5000)), off))
            if i % 7 == 6:
                log.append(f.write_at(b"overwritten", off))
                log.append(f.read_at(20, off))
        f.truncate(f.size() // 2)
        log += [f.size(), f.read_at(100, f.size() - 50), f.name == path,
                f.fileno() is not None]
        f.sync()
        f.close()
        log.append(f.fileno())
        files[name] = (log, open(path, "rb").read())
    assert files["t"] == files["j"]


@pytest.mark.parametrize("op", ["read", "write", "sync"])
def test_disk_fault_hooks_equal_jax(tmp_path, op):
    """A disk_error rule for one file and op makes both packages' DiskFile
    and MmapFile raise the same EIO on that op alone, and counts alike."""
    from seaweedfs_tpu.util import faults as j_faults
    from seaweedfs_tpu_torch.util import faults as t_faults

    got = {}
    for name, mod, faults in (("t", t_backend, t_faults),
                              ("j", j_backend, j_faults)):
        d = tmp_path / name
        d.mkdir()
        hit, spared = str(d / "hit.dat"), str(d / "spared.dat")
        faults.REGISTRY.configure(
            f"disk_error,side=disk,dst={d}/hit*,route={op}")
        try:
            out = []
            for cls in (mod.DiskFile, mod.MmapFile):
                for path in (hit, spared):
                    f = cls(path, create=True)
                    for call in (lambda: f.append(b"abc"),
                                 lambda: f.write_at(b"x", 0),
                                 lambda: f.read_at(3, 0),
                                 lambda: f.sync()):
                        try:
                            res = call()
                            out.append(("ok", res))
                        except OSError as e:
                            out.append(("err", e.errno, str(e)[:40]))
                    f.close()
                    os.remove(path)
            snap = faults.REGISTRY.snapshot()
            out.append([r.get("fired") for r in snap["rules"]])
        finally:
            faults.REGISTRY.clear()
        got[name] = out
    assert got["t"] == got["j"]
    assert any(x[0] == "err" for x in got["t"][:-1])
