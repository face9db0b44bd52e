"""The port's Store and DiskLocation against the JAX package's: the same
needles written through both stores (time.time_ns pinned, so append
times agree) give byte-identical .dat, .idx, shard files, .ecx and .vif
through ec_generate and ec_generate_batch; each package reads the other's
EC volumes with shards lost; ec_rebuild verifies against the .vif CRCs
and raises on a corrupt survivor in both; the per-collection family
policy and the heartbeat agree.  The port runs with device="cpu"."""

import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage import needle as j_needle
from seaweedfs_tpu.storage import store as j_store
from seaweedfs_tpu.storage.erasure_coding import codes as j_codes
from seaweedfs_tpu.storage.erasure_coding import encoder as j_enc
from seaweedfs_tpu.storage.volume import VolumeError as JVolumeError
from seaweedfs_tpu_torch.storage import needle as t_needle
from seaweedfs_tpu_torch.storage import store as t_store
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.erasure_coding import codes as t_codes
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc
from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
from seaweedfs_tpu_torch.storage.volume import VolumeError

LOST = (0, 5, 11, 13)
EC_FILES = [to_ext(i) for i in range(14)] + [".ecx", ".vif"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, and the slab pool emptied after the module (the
    test workers share their machine)."""
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


def _ops(seed: int, count: int = 40):
    """Seeded (kind, id, cookie, data, name) writes and deletes."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(1, count + 1):
        size = int(np.exp(rng.uniform(np.log(10), np.log(40_000))))
        name = b"obj-" + rng.bytes(4).hex().encode()
        ops.append(("write", i, 0x7000 + i, rng.bytes(size), name))
        if i % 9 == 0:
            ops.append(("delete", i - 4, 0x7000 + i - 4, None, None))
    return ops


def _fill(store, needle_mod, vid: int, ops, collection: str = ""):
    store.add_volume(vid, collection)
    for kind, nid, cookie, data, name in ops:
        if kind == "write":
            n = needle_mod.Needle.create(data, name=name)
            n.id, n.cookie = nid, cookie
            store.write_needle(vid, n)
        else:
            store.delete_needle(vid, needle_mod.Needle(id=nid, cookie=cookie))


def _live(ops) -> dict:
    live = {}
    for kind, nid, cookie, data, _ in ops:
        if kind == "write":
            live[nid] = (cookie, data)
        else:
            live.pop(nid, None)
    return live


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same_files(a: str, b: str, vid: int, exts):
    for ext in exts:
        assert _bytes(os.path.join(a, f"{vid}{ext}")) == \
            _bytes(os.path.join(b, f"{vid}{ext}")), ext


def _stores(tmp_path, pinned_clock, vids, port_backend, jax_backend,
            seed=1):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    js = j_store.Store([jd], ec_encoder_backend=jax_backend)
    ts = t_store.Store([td], ec_encoder_backend=port_backend, device="cpu")
    ops = {vid: _ops(seed + vid) for vid in vids}
    for store, mod in ((js, j_needle), (ts, t_needle)):
        pinned_clock()
        for vid in vids:
            _fill(store, mod, vid, ops[vid])
    return js, ts, jd, td, ops


@pytest.mark.parametrize("port_backend,jax_backend",
                         [("cuda", "tpu"), ("tpu", "tpu"), (None, "tpu"),
                          ("cpu", "cpu"), ("numpy", "numpy")])
def test_ec_generate_files_equal_jax(tmp_path, pinned_clock, port_backend,
                                     jax_backend):
    js, ts, jd, td, ops = _stores(tmp_path, pinned_clock, [3],
                                  port_backend, jax_backend)
    js.ec_generate(3)
    ts.ec_generate(3)
    _same_files(jd, td, 3, [".dat", ".idx"] + EC_FILES)
    vif = t_store.ec_encoder.load_volume_info(os.path.join(td, "3"))
    assert vif["code_family"] == "rs_vandermonde"
    assert ("shard_crc32c" in vif) == (port_backend in ("cuda", "tpu", None))
    js.close()
    ts.close()


def test_ec_generate_batch_files_equal_jax(tmp_path, pinned_clock):
    vids = [1, 2, 4]
    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, vids, "cuda", "tpu",
                                seed=10)
    js.ec_generate_batch(vids)
    st: dict = {}
    ts.ec_generate_batch(vids, stage_stats=st)
    assert st["batches"] >= 1 and st["backend"].startswith("device-")
    for vid in vids:
        _same_files(jd, td, vid, [".dat", ".idx"] + EC_FILES)
    js.close()
    ts.close()


def test_ec_generate_batch_host_codec_per_volume(tmp_path, pinned_clock):
    """A codec backend encodes each volume through the host loop (no CRC
    record), as the JAX package does."""
    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, [1, 2], "cpu",
                                "cpu", seed=20)
    js.ec_generate_batch([1, 2])
    ts.ec_generate_batch([1, 2])
    for vid in (1, 2):
        _same_files(jd, td, vid, EC_FILES)
    js.close()
    ts.close()


def _to_ec(store, vid: int, lost=LOST):
    """The volume server's flow after ec.encode: drop the volume, mount
    the surviving shards."""
    store.delete_volume(vid)
    store.ec_mount("", vid, [s for s in range(14) if s not in lost])


def _read_all(store, vid: int, live: dict, deleted, not_found):
    for nid, (cookie, data) in live.items():
        n = store.read_needle(vid, nid, cookie=cookie)
        assert n.data == data and n.cookie == cookie, nid
    for nid in deleted:
        with pytest.raises(not_found):
            store.read_needle(vid, nid)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_ec_volume(tmp_path, pinned_clock,
                                                 monkeypatch, writer):
    """The writer's store encodes; shards are lost; the other package's
    Store, opened over the same directory, discovers the EC volume and
    serves every needle (recovering those behind lost shards)."""
    from seaweedfs_tpu.storage.erasure_coding.ec_volume import \
        EcNotFoundError as JNotFound
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import \
        EcNotFoundError as TNotFound

    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")
    d = str(tmp_path / "v")
    ops = _ops(5, count=60)
    live = _live(ops)
    deleted = {op[1] for op in ops if op[0] == "delete"} - set(live)
    if writer == "jax":
        w = j_store.Store([d], ec_encoder_backend="tpu")
        _fill(w, j_needle, 7, ops)
    else:
        w = t_store.Store([d], ec_encoder_backend="cuda", device="cpu")
        _fill(w, t_needle, 7, ops)
    w.ec_generate(7)
    w.delete_volume(7)
    w.close()
    for sid in LOST:
        os.unlink(os.path.join(d, f"7{to_ext(sid)}"))
    if writer == "jax":
        r = t_store.Store([d], device="cpu")
        not_found = (TNotFound, t_store.NotFoundError)
    else:
        r = j_store.Store([d])
        not_found = (JNotFound, j_store.NotFoundError)
    assert r.find_volume(7) is None and r.find_ec_volume(7) is not None
    hb = r.collect_heartbeat()
    bits = sum(1 << s for s in range(14) if s not in LOST)
    assert hb["ec_shards"] == [{"id": 7, "collection": "",
                                "ec_index_bits": bits}]
    _read_all(r, 7, live, deleted, not_found)
    r.close()


def test_ec_rebuild_verifies_against_vif(tmp_path, pinned_clock):
    """A clean rebuild returns the rebuilt ids and byte-identical shards
    in both packages; with a corrupt survivor both raise."""
    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, [9], "cuda", "tpu",
                                seed=30)
    amp0 = t_codes.rebuild_read_amp_snapshot().get("rs_vandermonde")
    for store, d in ((js, jd), (ts, td)):
        store.ec_generate(9)
        _to_ec(store, 9, lost=())
        golden = {s: _bytes(os.path.join(d, f"9{to_ext(s)}")) for s in LOST}
        store.ec_unmount(9, list(LOST))
        for s in LOST:
            os.unlink(os.path.join(d, f"9{to_ext(s)}"))
        assert store.ec_rebuild(9) == sorted(LOST)
        for s in LOST:
            assert _bytes(os.path.join(d, f"9{to_ext(s)}")) == golden[s]
    amp1 = t_codes.rebuild_read_amp_snapshot()["rs_vandermonde"]
    shard = os.path.getsize(os.path.join(td, f"9{to_ext(0)}"))
    base = amp0 or {"read_bytes": 0, "rebuilt_bytes": 0}
    assert amp1["rebuilt_bytes"] - base["rebuilt_bytes"] == 4 * shard
    assert amp1["read_bytes"] - base["read_bytes"] == 10 * shard
    for store, d, err in ((js, jd, JVolumeError), (ts, td, VolumeError)):
        os.unlink(os.path.join(d, f"9{to_ext(0)}"))
        with open(os.path.join(d, f"9{to_ext(1)}"), "r+b") as f:
            f.seek(17)
            b = f.read(1)
            f.seek(17)
            f.write(bytes([b[0] ^ 0x5A]))
        with pytest.raises(err, match="do not match"):
            store.ec_rebuild(9)
    js.close()
    ts.close()


def test_family_for_collection_equal_jax(monkeypatch):
    for var in [k for k in os.environ if k.startswith("WEED_EC_CODE")]:
        monkeypatch.delenv(var)
    for coll in ("", "photos", "a-b.c"):
        assert t_codes.family_for_collection(coll) == \
            j_codes.family_for_collection(coll) == "rs_vandermonde"
    monkeypatch.setenv("WEED_EC_CODE", "rs_vandermonde")
    assert t_codes.family_for_collection("x") == "rs_vandermonde"
    monkeypatch.setenv("WEED_EC_CODE_A_B_C", "cauchy")
    assert j_codes.family_for_collection("a-b.c") == "cauchy"
    assert t_codes.family_for_collection("a-b.c") == "cauchy"
    assert t_codes._collection_env_key("") == \
        j_codes._collection_env_key("") == "WEED_EC_CODE_DEFAULT"

    class Conf:
        ec_code = "nope"

    monkeypatch.delenv("WEED_EC_CODE_A_B_C")
    for mod in (t_codes, j_codes):
        with pytest.raises(ValueError):
            mod.family_for_collection("z", path_conf=Conf())


def test_store_family_policy_and_inline(tmp_path, monkeypatch):
    ts = t_store.Store([str(tmp_path)], device="cpu",
                       ec_encoder_backend="cuda")
    ts.add_volume(1, "photos")
    n = t_needle.Needle.create(b"x" * 100)
    n.id, n.cookie = 1, 2
    ts.write_needle(1, n)
    monkeypatch.setenv("WEED_EC_CODE_PHOTOS", "pm_msr")
    base = str(tmp_path / "photos_1")
    for encode in (lambda: ts.ec_generate(1),
                   lambda: ts.ec_generate_batch([1])):
        encode()   # the family host loop, whatever the backend
        info = t_enc.load_volume_info(base)
        assert info["code_family"] == "pm_msr"
        assert info["shard_crc32c"] == j_enc.write_ec_files(
            base, family="pm_msr")
    monkeypatch.delenv("WEED_EC_CODE_PHOTOS")
    assert t_store.inline_family_for("photos") is None
    monkeypatch.setenv("WEED_EC_INLINE", "1")
    ts.add_volume(2, "photos")      # no EC policy: a classic volume
    assert ts.find_volume(2) is not None
    monkeypatch.setenv("WEED_EC_CODE_PHOTOS", "pm_msr")
    assert t_store.inline_family_for("photos") == "pm_msr"
    ev = ts.add_volume(3, "photos")
    assert ts.find_ec_volume(3) is ev and ev.family.name == "pm_msr"
    ev = ts.locations[0].add_inline_volume(4)
    assert ev.family.name == "rs_vandermonde" and ev.writer.unit
    ts.close()


def test_heartbeat_and_admin_equal_jax(tmp_path, pinned_clock):
    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, [1, 2], "cuda",
                                "tpu", seed=40)
    for store in (js, ts):
        store.mark_volume_readonly(2)
        store.volume_size_limit = 1 << 30
    hj, ht = js.status(), ts.status()
    for hb in (hj, ht):
        for v in hb["volumes"]:
            v.pop("modified_at_second")
    assert hj == ht
    assert ht["free_slots"] == 6 and ht["volumes"][1]["read_only"]
    with pytest.raises(VolumeError, match="already exists"):
        ts.add_volume(1)
    with pytest.raises(t_store.NotFoundError):
        ts.read_needle(99, 1)
    with pytest.raises(t_store.NotFoundError):
        ts.mark_volume_readonly(99)
    ts.delete_volume(1)
    assert not os.path.exists(os.path.join(td, "1.dat"))
    with pytest.raises(t_store.NotFoundError):
        ts.delete_volume(1)
    js.close()
    ts.close()


def test_disk_location_counts_and_uuid(tmp_path):
    loc = DiskLocation(str(tmp_path), 3, device="cpu")
    uuid = loc.uuid
    loc.add_volume(1)
    loc.add_volume(2)
    assert loc.volume_count() == 2 and loc.free_slots() == 1
    with pytest.raises(ValueError):
        loc.add_volume(1)
    assert loc.unload_volume(2) is not None and loc.volume_count() == 1
    assert loc.unload_volume(2) is None
    loc.close()
    again = DiskLocation(str(tmp_path), 3, device="cpu")
    assert again.uuid == uuid
    again.load_existing_volumes()
    assert sorted(again.volumes) == [1, 2]
    assert again.unmount_ec_shard(1, 0) is False
    again.close()


def test_ec_entry_points_raise_without_cuda(tmp_path, pinned_clock,
                                            monkeypatch):
    """Without a card and without device="cpu" the Store's EC entry
    points raise; a store of plain volumes still opens and serves."""
    from seaweedfs_tpu_torch.maintenance import deep_scrub

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    for backend in (None, "cuda"):
        ts = t_store.Store([d], ec_encoder_backend=backend)
        if ts.find_volume(1) is None:
            _fill(ts, t_needle, 1, _ops(3, count=5))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.ec_generate(1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.ec_generate_batch([1])
        assert ts.read_needle(1, 1).data
        ts.close()
    assert not os.path.exists(os.path.join(d, "1.ec00"))
    cs = t_store.Store([d], ec_encoder_backend="cuda", device="cpu")
    cs.ec_generate(1)
    cs.delete_volume(1)
    cs.ec_mount("", 1, list(range(1, 14)))
    cs.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_store.Store([d])   # mounting an EC volume resolves the device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deep_scrub.deep_scrub([deep_scrub.local_target(
            os.path.join(d, "1"), 1)])
    ts = t_store.Store([d], device="cpu")
    ts.ec_unmount(1, list(range(1, 14)))
    ts.device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.ec_rebuild(1)
    ts.close()


# -- repairs: a damaged volume on disk, a failing demotion hook, the JAX
# package's codec names --------------------------------------------------

def _damage(d: str, case: str):
    """Write one damaged volume (id 5 or 6) beside the healthy volume 1."""
    def put(name, data):
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)

    if case == "dat_3_bytes":
        put("5.dat", b"\x03\x00\x00")
    elif case == "version_9":
        raw = bytearray(_bytes(os.path.join(d, "1.dat")))
        raw[0] = 9
        put("5.dat", bytes(raw))
        put("5.idx", _bytes(os.path.join(d, "1.idx")))
    elif case == "extra_overrun":
        # the superblock's extra length (bytes 6-7) names 256 bytes; the
        # file holds 10 after the header
        raw = bytearray(_bytes(os.path.join(d, "1.dat"))[:8])
        raw[6:8] = (256).to_bytes(2, "big")
        put("5.dat", bytes(raw) + b"\x00" * 10)
    elif case == "bad_vif":
        put("6.ecx", b"")
        put("6.ec00", b"\x00" * 64)
        put("6.vif", b"{bad")
    elif case == "unknown_family":
        put("6.ecx", b"")
        put("6.ec00", b"\x00" * 64)
        put("6.vif", b'{"version": 3, "code_family": "nope"}')
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", ["dat_3_bytes", "version_9",
                                  "extra_overrun", "bad_vif",
                                  "unknown_family"])
def test_damaged_volume_skipped_like_jax(tmp_path, pinned_clock, case):
    """Both Stores start over a directory holding one damaged volume and
    load the same volumes and EC volumes: the damaged one is skipped."""
    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, [1], None, None)
    js.close()
    ts.close()
    for d in (jd, td):
        _damage(d, case)
    js = j_store.Store([jd])
    ts = t_store.Store([td], device="cpu")
    for jl, tl in zip(js.locations, ts.locations):
        assert sorted(jl.volumes) == sorted(tl.volumes) == [1]
        assert sorted(jl.ec_volumes) == sorted(tl.ec_volumes)
    assert ts.read_needle(1, 1).data == js.read_needle(1, 1).data
    js.close()
    ts.close()


def test_failing_ec_mount_on_cuda_still_raises(tmp_path, monkeypatch):
    """A mount that fails for want of a card is not a damaged volume."""
    d = str(tmp_path)
    _damage(d, "bad_vif")
    os.remove(os.path.join(d, "6.vif"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_store.Store([d])


def test_failing_demote_hook_keeps_volume_error(tmp_path, pinned_clock):
    """A disk error on write demotes the volume in both packages; an
    on_demote hook that raises does not replace the VolumeError, and each
    package counts the demotion in its own registry."""
    from seaweedfs_tpu.stats import metrics as j_metrics
    from seaweedfs_tpu_torch.stats import metrics as t_metrics

    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, [1], None, None)
    before = (j_metrics.VolumeReadonlyDemotions._values.get((), 0.0),
              t_metrics.VolumeReadonlyDemotions._values.get((), 0.0))

    def eio(*a, **kw):
        raise OSError(5, "Input/output error")

    def hook(vid):
        raise RuntimeError(f"heartbeat push failed for {vid}")

    for store, mod, err in ((js, j_needle, JVolumeError),
                            (ts, t_needle, VolumeError)):
        store.on_demote = hook
        store.find_volume(1).write_needle = eio
        n = mod.Needle.create(b"after the disk died")
        n.id, n.cookie = 999, 7
        with pytest.raises(err, match="demoted read-only"):
            store.write_needle(1, n)
        assert store.find_volume(1).read_only
    after = (j_metrics.VolumeReadonlyDemotions._values.get((), 0.0),
             t_metrics.VolumeReadonlyDemotions._values.get((), 0.0))
    assert after[0] - before[0] == after[1] - before[1] == 1
    js.close()
    ts.close()


def test_jax_codec_name_encodes_like_jax(tmp_path, pinned_clock):
    """-ec.backend=jax: the JAX package's device codec name drives the
    port's TorchEncoder on the store's device; shard files, .ecx and the
    .vif (with any shard CRCs) are byte-identical to the JAX package's."""
    js, ts, jd, td, _ = _stores(tmp_path, pinned_clock, [1], "jax", "jax")
    js.ec_generate(1)
    ts.ec_generate(1)
    _same_files(jd, td, 1, EC_FILES)
    assert t_store.ec_encoder.load_volume_info(os.path.join(td, "1")) == \
        j_enc.load_volume_info(os.path.join(jd, "1"))
    js.close()
    ts.close()
