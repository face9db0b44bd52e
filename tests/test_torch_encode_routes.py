"""The port's encode routes against the JAX package: the pooled kb route
(one and two CPU devices, host or fused CRC, any inflight depth), the
words route, the host pipeline (encode_volumes(host_codec=...), its
write-behind stage and knobs), the host loops of write_ec_files /
rebuild_ec_files (encoder=, batched=) and the link-probe auto-selection.
Shards and CRCs are compared byte for byte."""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.parallel import batched_encode as j_be
from seaweedfs_tpu.storage.erasure_coding import encoder as j_enc
from seaweedfs_tpu.storage.erasure_coding import to_ext
from seaweedfs_tpu_torch.ops import codec as t_codec
from seaweedfs_tpu_torch.ops import crc32c as t_crc
from seaweedfs_tpu_torch.ops.device_pool import get_pool, reset_pool
from seaweedfs_tpu_torch.parallel import batched_encode as t_be
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as t_enc
from seaweedfs_tpu_torch.util import platform as t_plat

LARGE, SMALL = 10000, 100  # the JAX package's test block sizes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, and the slab pool emptied after the module (the
    test workers share their machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    reset_pool()


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


def _jax_host(tmp_path, base: str, name: str, large=LARGE,
              small=SMALL) -> str:
    """The JAX package's synchronous host loop over a twin .dat."""
    ref = _twin(tmp_path, base, name)
    j_enc.write_ec_files(ref, large_block_size=large,
                         small_block_size=small, batched=False)
    return ref


def _assert_same(got_base: str, ref_base: str, crcs=None):
    for i in range(14):
        got = _shard(got_base, i)
        assert got == _shard(ref_base, i), f"shard {i}"
        if crcs is not None:
            assert crcs[i] == t_crc.crc32c(got), f"crc {i}"


# -- the pooled route ---------------------------------------------------------


@pytest.mark.parametrize("fused", ["0", "1"])
def test_pooled_route_two_devices_equals_jax(tmp_path, monkeypatch, fused):
    """Mixed block sizes and padded tails batched through one pooled
    dispatch split over two CPU devices: byte- and CRC-identical to the
    JAX package's pipeline."""
    monkeypatch.setenv("WEED_EC_DEVICE_SHARD", "2")
    monkeypatch.setenv("WEED_EC_FUSED_CRC", fused)
    sizes = [LARGE * 10 + SMALL * 3 + 57, SMALL * 10, 999, 1]
    bases = [_volume(tmp_path, f"m{k}", s, 100 + k)
             for k, s in enumerate(sizes)]
    refs = [_twin(tmp_path, b, f"r{k}") for k, b in enumerate(bases)]
    st: dict = {}
    got = t_be.encode_volumes(bases, large_block=LARGE, small_block=SMALL,
                              mesh=["cpu", "cpu"], stage_stats=st)
    want = j_be.encode_volumes(refs, large_block=LARGE, small_block=SMALL)
    for b, r in zip(bases, refs):
        _assert_same(b, r, got[b])
        assert got[b] == [int(c) for c in want[r]]
    assert st["devices"] == 2 and st["device_shard"] == "sharded:2"
    assert st["batch_units"] % 2 == 0
    assert st["backend"] == ("device-pooled-fused-crc" if fused == "1"
                             else "device-pooled")
    assert st["crc_path"] == ("fused-device" if fused == "1" else "host")
    assert st["zero_copy_h2d"] is False


@pytest.mark.parametrize("depth", ["1", "4"])
def test_pooled_slot_reuse_is_safe(tmp_path, monkeypatch, depth):
    """Recycled staging slots and output slots must not corrupt results
    at any inflight depth, with several batches in flight."""
    monkeypatch.setenv("WEED_EC_DEVICE_INFLIGHT", depth)
    monkeypatch.setenv("WEED_EC_FUSED_CRC", "1")
    bases = [_volume(tmp_path, f"d{k}", SMALL * 10 * 3 + 7 * k, 200 + k)
             for k in range(6)]
    crcs = t_be.encode_volumes(bases, large_block=LARGE, small_block=SMALL,
                               batch_units=2, device="cpu")
    for k, b in enumerate(bases):
        _assert_same(b, _jax_host(tmp_path, b, f"dr{k}"), crcs[b])


def test_pooled_stage_stats_schema_and_zero_allocations(tmp_path):
    """Repeat encodes of one geometry re-lease the pool's slabs: the
    allocation count does not move after the first run.  The stage
    stats keep the JAX package's keys."""
    reset_pool()
    for rep in range(3):
        bases = [_volume(tmp_path, f"s{rep}v{k}", SMALL * 10 * 4 + 11, k)
                 for k in range(3)]
        st: dict = {}
        t_be.encode_volumes(bases, large_block=LARGE, small_block=SMALL,
                            stage_stats=st, device="cpu")
        snap = get_pool().snapshot()
        if rep == 0:
            first = snap["allocs"]
        else:
            assert snap["allocs"] == first, snap
            assert snap["lease_hits"] > 0
    for k in ("backend", "crc_path", "k_shapes", "inflight",
              "staging_slots", "zero_copy_h2d", "devices", "device_shard",
              "kernel", "kernel_cost", "pool", "wall", "host_crc"):
        assert k in st, k
    assert st["zero_copy_h2d"] is True and st["devices"] == 1
    assert st["k_shapes"] == [10]
    assert set(st["kernel"]) == {"batches", "dispatch_ready_p50_ms",
                                 "dispatch_ready_p95_ms",
                                 "dispatch_ready_max_ms"}
    (geom, cost), = st["kernel_cost"].items()
    assert geom == f"k10xb{st['batch_units']}xw{SMALL}"
    assert cost["flops"] == 4 * 10 * st["batch_units"] * SMALL
    assert st["pool"]["leased_slots"] == 0
    reset_pool()


def test_compacted_rows(tmp_path, monkeypatch):
    """A volume whose tail row holds fewer than 10 data blocks compacts
    the zero rows away (k_shapes below 10), fused or not."""
    for fused in ("0", "1"):
        monkeypatch.setenv("WEED_EC_FUSED_CRC", fused)
        base = _volume(tmp_path, f"c{fused}", SMALL * 3 + 5, 31)
        st: dict = {}
        crcs = t_be.encode_volumes([base], large_block=LARGE,
                                   small_block=SMALL, stage_stats=st,
                                   device="cpu")[base]
        assert st["k_shapes"] == [4]
        _assert_same(base, _jax_host(tmp_path, base, f"cr{fused}"), crcs)


def test_words_route_equals_jax(tmp_path, monkeypatch):
    """The words route (K2 on (B, 10, L) staging), taken on a card,
    driven here on the CPU through its plain version."""
    monkeypatch.setattr(t_be, "words_capable", lambda devices, chunk: True)
    bases = [_volume(tmp_path, f"w{k}", 997 * (k + 1) + LARGE * 10 * k, k)
             for k in range(3)]
    st: dict = {}
    got = t_be.encode_volumes(bases, large_block=LARGE, small_block=SMALL,
                              batch_units=3, stage_stats=st, device="cpu")
    assert st["backend"] == "device-words"
    assert st["crc_path"] == "fused-device" and st["k_shapes"] == []
    for k, b in enumerate(bases):
        _assert_same(b, _jax_host(tmp_path, b, f"wr{k}"), got[b])


# -- the host pipeline --------------------------------------------------------


@pytest.mark.parametrize("size", [1, SMALL * 10 * 7 + 13,
                                  LARGE * 10 * 2 + 12345])
def test_host_pipeline_equals_jax(tmp_path, size):
    base = _volume(tmp_path, "hp", size, size % 97)
    ref = _twin(tmp_path, base, "hpj")
    got = t_be.encode_volumes([base], large_block=LARGE, small_block=SMALL,
                              host_codec=True)[base]
    want = j_be.encode_volumes([ref], large_block=LARGE, small_block=SMALL,
                               host_codec=True)[ref]
    _assert_same(base, ref, got)
    assert got == [int(c) for c in want]


def test_host_pipeline_multi_volume_and_numpy_codec(tmp_path):
    bases = [_volume(tmp_path, f"hm{k}", 977 * (k + 1), k) for k in range(4)]
    got = t_be.encode_volumes(bases, large_block=LARGE, small_block=SMALL,
                              host_codec=t_codec.new_encoder(
                                  backend="numpy"))
    for k, b in enumerate(bases):
        _assert_same(b, _jax_host(tmp_path, b, f"hmr{k}"), got[b])


def test_host_pipeline_tiny_blocks_iov_cap(tmp_path):
    """Spans that would exceed IOV_MAX rows still encode."""
    base = _volume(tmp_path, "tiny", 2_000_000, 5)
    crcs = t_be.encode_volumes([base], large_block=10000, small_block=100,
                               host_codec=True)[base]
    _assert_same(base, _jax_host(tmp_path, base, "tinyr", 10000, 100), crcs)


def test_host_pipeline_large_block_col_chunks(tmp_path, monkeypatch):
    """Rows whose block exceeds _HOST_SPAN_MAX_BLOCK take the column-chunk
    path (strided preads per shard), here at small sizes."""
    monkeypatch.setattr(t_be, "_HOST_SPAN_MAX_BLOCK", 4096)
    monkeypatch.setattr(t_be, "_HOST_COL_CHUNK", 3000)
    base = _volume(tmp_path, "col", LARGE * 10 + 3 * SMALL * 10 + 123, 9)
    items = t_be._host_work_items([t_be._plan_volume(base, LARGE, SMALL)])
    assert {w.kind for w in items} == {"col", "span"}
    crcs = t_be.encode_volumes([base], large_block=LARGE, small_block=SMALL,
                               host_codec=True)[base]
    _assert_same(base, _jax_host(tmp_path, base, "colr"), crcs)


class TestWriteBehindStage:
    """Write-behind is byte- and CRC-identical to the inline path, a
    pwritev without progress fails the encode, and the stage stats
    attribute write and flush separately."""

    def _encode(self, tmp_path, monkeypatch, tag, size=1_234_567, seed=21,
                **env):
        base = _volume(tmp_path, tag, size, seed)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        st: dict = {}
        crcs = t_be.encode_volumes([base], large_block=LARGE,
                                   small_block=SMALL, host_codec=True,
                                   stage_stats=st)[base]
        return base, crcs, st

    def test_write_behind_matches_inline(self, tmp_path, monkeypatch):
        b_async, c_async, st = self._encode(
            tmp_path, monkeypatch, "wb",
            WEED_EC_HOST_WORKERS="4", WEED_EC_WRITERS="3",
            WEED_EC_WRITE_BEHIND="1", WEED_EC_WRITE_FLUSH_MB="1")
        assert st["write_behind"] is True and st["writers"] == 3
        b_inline, c_inline, st2 = self._encode(
            tmp_path, monkeypatch, "inl", WEED_EC_HOST_WORKERS="1")
        assert st2["write_behind"] is False and st2["writers"] == 0
        assert c_async == c_inline
        _assert_same(b_async, b_inline, c_async)

    def test_sync_mode_knob_matches(self, tmp_path, monkeypatch):
        b_sync, c_sync, st = self._encode(
            tmp_path, monkeypatch, "sync",
            WEED_EC_HOST_WORKERS="4", WEED_EC_WRITE_BEHIND="0")
        assert st["write_behind"] is False and st["writers"] == 0
        b_inline, c_inline, _ = self._encode(
            tmp_path, monkeypatch, "sref", WEED_EC_HOST_WORKERS="1")
        assert c_sync == c_inline
        _assert_same(b_sync, b_inline)

    def test_stage_stats_schema(self, tmp_path, monkeypatch):
        _, _, st = self._encode(
            tmp_path, monkeypatch, "ss",
            WEED_EC_HOST_WORKERS="2", WEED_EC_WRITE_BEHIND="1",
            WEED_EC_WRITERS="0", WEED_EC_WRITE_FLUSH_MB="1")
        for k in ("read", "encode_crc", "write", "flush", "wall"):
            assert isinstance(st[k], float) and st[k] >= 0.0, k
        for k in ("read", "encode_crc", "write", "flush"):
            assert isinstance(st[f"{k}_frac"], float), k
        assert st["backend"] == "host-pipeline" and st["fused"] is True
        assert st["workers"] == 2 and st["writers"] >= 1
        assert st["write_behind"] is True
        assert isinstance(st["flushes"], int) and st["items"] >= 1
        assert st["write"] + st["flush"] <= st["wall"] * (st["workers"] + 1)

    @pytest.mark.parametrize("workers", ["1", "4"])
    def test_zero_progress_pwritev_is_hard_error(self, tmp_path, monkeypatch,
                                                 workers):
        base = _volume(tmp_path, f"zp{workers}", 123_456, 7)
        monkeypatch.setenv("WEED_EC_HOST_WORKERS", workers)
        monkeypatch.setattr(os, "pwritev", lambda fd, bufs, off: 0)
        with pytest.raises(OSError, match="no progress"):
            t_be.encode_volumes([base], large_block=LARGE,
                                small_block=SMALL, host_codec=True)

    def test_short_pwritev_retries_to_full_length(self, tmp_path,
                                                  monkeypatch):
        real_pwritev = os.pwritev
        calls = {"n": 0}

        def short_pwritev(fd, bufs, offset):
            calls["n"] += 1
            mv = memoryview(bufs[0]).cast("B")
            return real_pwritev(fd, [mv[:max(1, mv.nbytes // 2)]], offset)

        base = _volume(tmp_path, "short", 234_567, 13)
        monkeypatch.setenv("WEED_EC_HOST_WORKERS", "2")
        monkeypatch.setattr(os, "pwritev", short_pwritev)
        crcs = t_be.encode_volumes([base], large_block=LARGE,
                                   small_block=SMALL, host_codec=True)[base]
        monkeypatch.setattr(os, "pwritev", real_pwritev)
        assert calls["n"] > 0
        _assert_same(base, _jax_host(tmp_path, base, "shortr"), crcs)


# -- the encoder entry points -------------------------------------------------


def test_write_ec_files_encoder_and_batched(tmp_path):
    """encoder= (and batched=False) run the host loop, which returns None;
    batched=True the device pipeline; all byte-identical to the JAX
    package's host loop."""
    base = _volume(tmp_path, "e", LARGE * 10 + 5555, 41)
    ref = _jax_host(tmp_path, base, "ej")
    for name, kw in (("enc", {"encoder": t_codec.new_encoder(
                         backend="cpu")}),
                     ("nb", {"batched": False}),
                     ("np", {"encoder": t_codec.new_encoder(
                         backend="numpy"), "chunk_bytes": 37})):
        b = _twin(tmp_path, base, name)
        assert t_enc.write_ec_files(b, LARGE, SMALL, device="cpu",
                                    **kw) is None
        _assert_same(b, ref)
    b = _twin(tmp_path, base, "bt")
    crcs = t_enc.write_ec_files(b, LARGE, SMALL, device="cpu", batched=True)
    _assert_same(b, ref, crcs)


def test_rebuild_ec_files_encoder_and_batched(tmp_path):
    base = _volume(tmp_path, "rb", LARGE * 10 + 4321, 42)
    crcs = t_enc.write_ec_files(base, LARGE, SMALL, device="cpu")
    golden = {sid: _shard(base, sid) for sid in (0, 5, 11, 13)}
    for kw, want in (({"encoder": t_codec.new_encoder(backend="cpu"),
                       "buffer_size": 333}, None),
                     ({"batched": False}, None),
                     ({"batched": True}, "crc")):
        for sid in golden:
            os.unlink(base + to_ext(sid))
        got = t_enc.rebuild_ec_files(base, device="cpu", **kw)
        assert sorted(got) == sorted(golden)
        for sid, data in golden.items():
            assert _shard(base, sid) == data
            assert got[sid] == (crcs[sid] if want else None)
    assert t_enc.rebuild_ec_files(base, device="cpu", batched=False) == {}


def test_auto_selection_picks_host_pipeline_on_slow_link(tmp_path,
                                                          monkeypatch):
    """When the link probe predicts the device loses, the default encode
    runs the host pipeline, which still returns the shard CRCs, on one
    core (inline) and on many; the default rebuild runs the host loop."""
    card = torch.device("cuda", 0)
    monkeypatch.setattr(t_plat.device_mod, "resolve", lambda d=None: card)
    monkeypatch.setattr(t_plat, "link_throughput", lambda **kw: (5.0, 2.0))
    assert t_plat.prefer_batched_encode() is False
    ref = None
    for cores in (8, 1):
        monkeypatch.setattr(t_plat, "available_cpu_count", lambda: cores)
        monkeypatch.setattr(t_be, "available_cpu_count", lambda: cores)
        base = _volume(tmp_path, f"slow{cores}", 12345, 5)
        st: dict = {}
        crcs = t_enc.write_ec_files(base, LARGE, SMALL, stage_stats=st)
        assert st["backend"] == "host-pipeline"
        assert st["workers"] == cores
        ref = ref or _jax_host(tmp_path, base, "slowref")
        _assert_same(base, ref, crcs)
    os.unlink(base + to_ext(3))
    assert t_enc.rebuild_ec_files(base) == {3: None}
    assert _shard(base, 3) == _shard(ref, 3)
    # a fast link keeps the device pipeline (here the CPU runs it)
    monkeypatch.setattr(t_plat, "link_throughput", lambda **kw: (1e6, 1e6))
    assert t_plat.prefer_batched_encode() is True


def test_new_encoder_backends(monkeypatch):
    rng = np.random.default_rng(8)
    data = [rng.integers(0, 256, 64, dtype=np.uint8) for _ in range(10)]
    full = [t_codec.new_encoder(backend=b).encode(list(data) + [None] * 4)
            for b in ("cpu", "numpy", "torch")]
    for other in full[1:]:
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(full[0], other))
    assert isinstance(t_codec.new_host_encoder(), t_codec.NativeEncoder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert isinstance(t_codec.new_encoder(backend="auto"),
                      t_codec.NativeEncoder)
    monkeypatch.setattr(t_codec.native, "lib", lambda: None)
    assert isinstance(t_codec.new_encoder(backend="auto"),
                      t_codec.NumpyEncoder)
    assert isinstance(t_codec.new_host_encoder(), t_codec.NumpyEncoder)
    with pytest.raises(RuntimeError, match="native library"):
        t_codec.NativeEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_codec.new_encoder()   # the default stays "cuda"
