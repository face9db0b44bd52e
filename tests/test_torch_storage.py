"""The port's needle and volume formats against the JAX package: needles,
.idx entries, TTLs, superblocks, .vif sidecars, needle maps and whole
volumes, byte for byte (tolerance 0), with each package reading what the
other wrote."""

import itertools
import threading
import time

import numpy as np
import pytest

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


@pytest.mark.parametrize("kind", ["memory", "compact"])
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
    assert _map_state(tm) == _map_state(jm)
    tm.close()
    jm.close()
    assert open(a, "rb").read() == open(b, "rb").read()
    reopened = t_nm.new_needle_map(kind, a)
    assert _map_state(reopened)[:5] == _map_state(tm)[:5]
    reopened.close()


def test_needle_map_kinds():
    with pytest.raises(NotImplementedError):
        t_nm.new_needle_map("sqlite")
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
    t_vif.save_volume_info(str(tmp_path / "5.vif"), t_vif.VolumeInfo(
        files=[t_vif.RemoteFile("s3", "d", "k")]))
    with pytest.raises(NotImplementedError):
        t_volume.Volume(str(tmp_path), "", 5)
