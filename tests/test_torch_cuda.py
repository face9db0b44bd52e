"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc; without one each test skips (the
decision is made inside the fixture, never at import).  On the card run
them with `python -m pytest tests/test_torch_cuda.py -q`; chip_smoke.py
makes the same checks at the main path's shapes."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.crc_device import batched_crc32c_raw
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


def _crc_rows_reference(view):
    """K8's plain version on a CPU copy, and batched_crc32c_raw on the card
    one batch item at a time (its float32 bit planes take 32 bytes of
    device memory per input byte)."""
    plain = rs_cuda.crc32c_rows_plain(view.cpu())
    raw = torch.stack([batched_crc32c_raw(view[i])
                       for i in range(view.shape[0])])
    return plain, raw.cpu()


@pytest.mark.parametrize("length", [16, 4096, 1 << 20, 3 * 4096 + 5])
@pytest.mark.parametrize("rows", [1, 14, 18])
@pytest.mark.parametrize("batch", [1, 3, 7])
def test_crc32c_rows_matches_plain_and_batched(cuda, batch, rows, length):
    """K8 over the (B, R, L) permute of an (R, B, L) slab, the deep
    scrub's layout: bit-exact against its plain version and against
    batched_crc32c_raw."""
    slab = _bytes(batch * rows + length, (rows, batch, length), cuda)
    view = slab.permute(1, 0, 2)
    before = rs_cuda.launches["crc32c_rows"]
    got = rs_cuda.crc32c_rows(view)
    assert rs_cuda.launches["crc32c_rows"] == before + 1
    plain, raw = _crc_rows_reference(view)
    assert got.dtype == torch.int64 and got.shape == (batch, rows)
    assert torch.equal(got.cpu(), plain) and torch.equal(got.cpu(), raw)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("length", [50, 4096 + 3, 1 << 16])
def test_crc32c_rows_on_unaligned_views(cuda, offset, length):
    x = _misaligned(offset + length, (3, 18, length), offset, cuda)
    plain, raw = _crc_rows_reference(x)
    got = rs_cuda.crc32c_rows(x).cpu()
    assert torch.equal(got, plain) and torch.equal(got, raw)


def test_crc32c_rows_into_out_allocates_nothing(cuda):
    """With `out=` a steady caller allocates no device memory; the
    images land in `out`."""
    slabs = [_bytes(40 + i, (18, 3, 1 << 20), cuda) for i in range(2)]
    out = torch.empty((3, 18), dtype=torch.int64, device=cuda)
    rs_cuda.crc32c_rows(slabs[0].permute(1, 0, 2), out=out)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    for i in range(8):
        assert rs_cuda.crc32c_rows(slabs[i % 2].permute(1, 0, 2),
                                   out=out) is out
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] == \
        allocs
    plain, _ = _crc_rows_reference(slabs[1].permute(1, 0, 2))
    assert torch.equal(out.cpu(), plain)


def test_deep_scrub_takes_every_crc_on_the_card(cuda, tmp_path):
    """A recompute scrub on the card launches K1 and K8 once per batch,
    CRCs no byte on the host, and gives the CPU scrub's chains, parity
    CRCs and verdicts, with a short tail span and a parity file cut
    short."""
    import os

    from seaweedfs_tpu_torch.maintenance.deep_scrub import (deep_scrub,
                                                            local_target)
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    base = str(tmp_path / "1")
    _bytes(13, ((12 << 20) + 77,), "cpu").numpy().tofile(base + ".dat")
    crcs = encoder.write_ec_files(base, batched=True, device="cpu")
    encoder.save_volume_info(base, 3, {"shard_crc32c": crcs})
    os.truncate(base + ".ec12", 700_001)
    seen = []
    for dev in (cuda, "cpu"):
        st: dict = {}
        k1 = rs_cuda.launches["gf_apply"]
        k8 = rs_cuda.launches["crc32c_rows"]
        t = local_target(base, 1)
        out = deep_scrub([t], device=dev, stage_stats=st,
                         span_bytes=300_000, batch_units=3)
        if dev is cuda:
            assert rs_cuda.launches["gf_apply"] - k1 == st["batches"] > 1
            assert rs_cuda.launches["crc32c_rows"] - k8 == st["batches"]
        assert st["crc_host_bytes"] == 0 and st["crc_card_bytes"] > 0
        seen.append((out["volumes"], t.chains, t.computed))
    assert seen[0] == seen[1]
    assert seen[0][0][0]["corrupt"] == [12]


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


@pytest.mark.parametrize("length", [50, 4096, 4096 + 3])
def test_gf_apply_strided_rows_and_out(cuda, length):
    """K1 on rows of a larger buffer (row stride > L) into `out=`: no
    copy, the result in the caller's buffer."""
    base = _bytes(length, (10, 3, length), cuda)
    view = base[:, 1, :]
    out = torch.empty((4, length), dtype=torch.uint8, device=cuda)
    got = rs_cuda.gf_apply(PARITY, view, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, rs_cuda.gf_apply_plain(PARITY, view))


@pytest.mark.parametrize("length", [50, 4096, (1 << 16) + 3])
@pytest.mark.parametrize("k", [1, 3, 7, 10])
def test_fused_apply_crc_on_permuted_views(cuda, k, length):
    """K2 reading the (B, k, L) permute of a (k, B, L) buffer and writing
    through the permute of a (p, B, L) slot, with preallocated CRC and
    scratch: equal to the plain version, nothing copied."""
    m = np.ascontiguousarray(PARITY[:, :k])
    buf = _bytes(k * length, (k, 3, length), cuda)
    slot = torch.zeros((4, 3, length), dtype=torch.uint8, device=cuda)
    crc = torch.empty((3, k + 4), dtype=torch.int64, device=cuda)
    part = torch.empty(rs_cuda.k2_scratch_shape(4, k, 3, length),
                       dtype=torch.int32, device=cuda)
    for rep in range(2):  # the first call builds the cached tables
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        rs_cuda.fused_apply_crc(m, buf.permute(1, 0, 2),
                                slot.permute(1, 0, 2), crc, part)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before
    want, want_crc = rs_cuda.fused_apply_crc_plain(
        m, buf.permute(1, 0, 2).contiguous())
    assert torch.equal(slot.permute(1, 0, 2), want)
    assert torch.equal(crc, want_crc)


@pytest.mark.parametrize("fused", [False, True])
def test_parity_step_on_card(cuda, fused):
    """The pooled parity step at every compacted k, held against its
    plain version on the same inputs; 8 steady-state calls allocate
    nothing on the device."""
    from seaweedfs_tpu_torch.parallel.mesh import make_parity_step

    step = make_parity_step([cuda], fused_crc=fused)
    plain = make_parity_step([torch.device("cpu")], fused_crc=fused)
    for k in range(1, 11):
        x = _bytes(k, (k, 3, 4096 + 4), cuda)
        out = torch.empty((4, 3, 4096 + 4), dtype=torch.uint8, device=cuda)
        crc = step(x, out)
        ref = torch.empty((4, 3, 4096 + 4), dtype=torch.uint8)
        ref_crc = plain(x.cpu(), ref)
        assert torch.equal(out.cpu(), ref)
        if fused:
            assert torch.equal(crc.cpu(), ref_crc)
    x = _bytes(0, (10, 2, 1 << 16), cuda)
    out = torch.empty((4, 2, 1 << 16), dtype=torch.uint8, device=cuda)
    step(x, out)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(8):
        step(x, out)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before


def test_reconstruct_span_pinned_and_resident(cuda, monkeypatch):
    from seaweedfs_tpu_torch.ops.codec import reconstruct_span
    from seaweedfs_tpu_torch.ops.device_pool import get_pool, reset_pool

    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")
    reset_pool()
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    x = _bytes(9, (10, 1 << 18), "cpu").numpy()
    want = reconstruct_span(survivors, x, 0, device="cpu")
    for key in (None, b"k", b"k"):
        got = reconstruct_span(survivors, x, 0, slab_key=key, device=cuda)
        assert np.array_equal(got, want)
    snap = get_pool().snapshot()
    assert snap["resident_hits"] == 1 and snap["resident_misses"] == 1
    reset_pool()


def test_pooled_route_and_deep_scrub_on_card(cuda, tmp_path, monkeypatch):
    """The pooled route (taken on a card for chunks not divisible by 4,
    fused CRC) and deep scrub's K1 recompute, on the card."""
    from seaweedfs_tpu_torch.maintenance.deep_scrub import (deep_scrub,
                                                            local_target)
    from seaweedfs_tpu_torch.parallel.batched_encode import encode_volumes
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder, to_ext

    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 100_003, dtype=np.uint8)
    bases = [str(tmp_path / n) for n in ("gpu", "cpu")]
    for b in bases:
        data.tofile(b + ".dat")
    st: dict = {}
    got = encode_volumes([bases[0]], 10000, 50, stage_stats=st,
                         device=cuda)[bases[0]]
    want = encode_volumes([bases[1]], 10000, 50, device="cpu")[bases[1]]
    assert st["backend"] == "device-pooled-fused-crc" and got == want
    for i in range(14):
        with open(bases[0] + to_ext(i), "rb") as a, \
                open(bases[1] + to_ext(i), "rb") as b:
            assert a.read() == b.read()
    encoder.save_volume_info(bases[0], 3, {"shard_crc32c": got})
    out = deep_scrub([local_target(bases[0], 1)], device=cuda)
    assert out["volumes"][0]["ok"] and out["volumes"][0]["recomputed"]


def test_deep_scrub_times_its_batches_with_cuda_events(cuda, tmp_path):
    """On the card each scrub batch's H2D, parity step and D2H are timed
    by CUDA events: stage_stats carries their seconds, which fit in the
    call's wall, and the process's device report grows by them; the
    verdict and CRC chains equal the plain scrub's on the CPU."""
    from seaweedfs_tpu_torch import profiling
    from seaweedfs_tpu_torch.maintenance.deep_scrub import (deep_scrub,
                                                            local_target)
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    base = str(tmp_path / "1")
    _bytes(12, ((3 << 20) + 11,), "cpu").numpy().tofile(base + ".dat")
    crcs = encoder.write_ec_files(base, batched=True, device="cpu")
    encoder.save_volume_info(base, 3, {"shard_crc32c": crcs})
    before = profiling.device_timeline()
    st: dict = {}
    got = local_target(base, 1)
    out = deep_scrub([got], device=cuda, stage_stats=st,
                     span_bytes=256 << 10, batch_units=2)
    after = profiling.device_timeline()
    want = local_target(base, 1)
    deep_scrub([want], device="cpu")
    assert out["volumes"][0]["ok"] and out["volumes"][0]["recomputed"]
    assert (got.chains, got.computed) == (want.chains, want.computed)
    keys = ("device_h2d", "device_kernel", "device_d2h")
    assert all(st[k] > 0 for k in keys)
    assert sum(st[k] for k in keys) <= st["wall"]
    assert after["scrub_steps"] - before["scrub_steps"] == st["batches"] > 1
    for k in ("h2d", "kernel", "d2h"):
        grew = after["scrub_device_s"][k] - before["scrub_device_s"][k]
        assert grew == pytest.approx(st["device_" + k], abs=1e-5)


def test_deep_scrub_read_workers_on_card(cuda, tmp_path, monkeypatch):
    """A multi-span scrub on the card read by 8 workers gives the chains,
    recomputed parity CRCs and verdicts of one worker and of the CPU."""
    from seaweedfs_tpu_torch.maintenance import deep_scrub as ds
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    bases = [str(tmp_path / str(i)) for i in (1, 2)]
    for i, b in enumerate(bases):
        _bytes(20 + i, ((11 << 20) + 333 * i,), "cpu").numpy().tofile(
            b + ".dat")
        crcs = encoder.write_ec_files(b, batched=True, device="cpu")
        encoder.save_volume_info(b, 3, {"shard_crc32c": crcs})
    with open(bases[1] + ".ec02", "r+b") as f:
        f.seek(700_001)
        flipped = bytes([f.read(1)[0] ^ 0xFF])
        f.seek(700_001)
        f.write(flipped)
    seen = []
    for dev, workers in ((cuda, 8), (cuda, 1), ("cpu", 1)):
        st: dict = {}
        # the scrub reads on half the cores it sees
        monkeypatch.setattr(ds, "available_cpu_count", lambda: 2 * workers)
        targets = [ds.local_target(b, i + 1) for i, b in enumerate(bases)]
        out = ds.deep_scrub(targets, device=dev, stage_stats=st,
                            span_bytes=300_000, batch_units=3)
        assert st["read_workers"] == workers and st["batches"] > 1
        seen.append((out["volumes"], [(t.chains, t.computed)
                                      for t in targets]))
    assert seen[0] == seen[1] == seen[2]
    assert seen[0][0][0]["ok"] and seen[0][0][1]["corrupt"] == [2]


def test_deep_scrub_fills_the_pinned_stage_in_place(cuda, tmp_path,
                                                   monkeypatch):
    """A local target's spans read by its `read_into` straight into the
    pinned stage give the K8 images, chains, recomputed parity CRCs,
    verdicts and bytes of the same target read through `bytes`."""
    from seaweedfs_tpu_torch.maintenance import deep_scrub as ds
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    base = str(tmp_path / "1")
    _bytes(30, ((12 << 20) + 77,), "cpu").numpy().tofile(base + ".dat")
    crcs = encoder.write_ec_files(base, batched=True, device="cpu")
    encoder.save_volume_info(base, 3, {"shard_crc32c": crcs})
    with open(base + ".ec07", "r+b") as f:
        f.seek(900_001)
        flipped = bytes([f.read(1)[0] ^ 0xFF])
        f.seek(900_001)
        f.write(flipped)
    real = rs_cuda.crc32c_rows
    images: list = []

    def recording(data, out=None):
        res = real(data, out=out)
        images[-1].append(res.to("cpu", copy=True))
        return res

    monkeypatch.setattr(rs_cuda, "crc32c_rows", recording)
    seen = []
    for direct in (True, False):
        images.append([])
        t = ds.local_target(base, 1)
        pinned = []
        fill = t.read_into

        def read_into(sid, off, view):
            pinned.append(torch.from_numpy(view).is_pinned())
            return fill(sid, off, view)

        t.read_into = read_into if direct else None
        st: dict = {}
        out = ds.deep_scrub([t], device=cuda, stage_stats=st,
                            span_bytes=300_000, batch_units=3)
        form = "read_direct_bytes" if direct else "read_copied_bytes"
        assert st[form] == out["scrubbed_bytes"] > 0
        assert (st["stage_copy"] == 0) is direct
        assert all(pinned) and bool(pinned) is direct
        assert len(images[-1]) == st["batches"] > 1
        seen.append((out["volumes"], t.chains, t.computed, t.bytes_read))
    assert seen[0] == seen[1]
    assert seen[0][0][0]["corrupt"] == [7]
    # the rows of a batch's units (a last, partial batch leaves the rest
    # of its stage as an earlier batch left it)
    b = st["batch_units"]
    units = -(-max(t.sizes) // st["span_bytes"])
    for k, (x, y) in enumerate(zip(*images)):
        n = min(b, units - k * b)
        assert torch.equal(x[:n], y[:n])


def test_survivor_stack_needs_no_staging_copy(cuda, monkeypatch):
    """No stack is copied into a staging slab on its way to the card: a
    pageable one crosses from its own memory, one assembled in the slab
    `survivor_stack` leases crosses from that slab.  The route leases only
    the pinned slab its output row comes back through."""
    from seaweedfs_tpu_torch.ops import codec
    from seaweedfs_tpu_torch.ops.device_pool import get_pool

    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    x = _bytes(11, (10, 4096 * 3), "cpu").numpy()
    want = codec.reconstruct_span(survivors, x, 0, device="cpu")
    staged = []
    real = codec._lease_host
    monkeypatch.setattr(codec, "_lease_host",
                        lambda pool, n, dev: staged.append(n) or
                        real(pool, n, dev))
    assert np.array_equal(codec.reconstruct_span(survivors, x, 0,
                                                 device=cuda), want)
    assert staged == [x.shape[1]]      # the row's only
    with codec.survivor_stack(x.shape, cuda) as slab:
        assert torch.from_numpy(slab).is_pinned()
        np.stack(list(x), out=slab)
        staged.clear()
        assert np.array_equal(codec.reconstruct_span(survivors, slab, 0,
                                                     device=cuda), want)
        assert staged == [x.shape[1]]
    assert get_pool().snapshot()["leased_slots"] == 0
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "1024")
    with codec.survivor_stack(x.shape, cuda) as slab:
        assert slab is None            # too small for the card's route


@pytest.mark.parametrize("family,launches", [("rs_vandermonde", 1),
                                             ("cauchy", 1), ("pm_msr", 3)])
@pytest.mark.parametrize("rows", [1, 5, 16])
def test_inline_batch_step_matches_plain(cuda, tmp_path, monkeypatch,
                                         family, launches, rows):
    """An inline commit batch is one parity step call on the card: K1
    once per 16 parity lane rows (RS and Cauchy: 1 launch, pm_msr's 36
    lane rows: 3), equal to the plain GF parity of the rows' lanes and to
    the host route; no allocation on the card after the first batch."""
    from seaweedfs_tpu_torch.ops.device_pool import get_pool
    from seaweedfs_tpu_torch.storage.erasure_coding.inline import \
        InlineEcWriter

    monkeypatch.setenv("WEED_EC_STRIPE_KB", "64")
    monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "1")
    w = InlineEcWriter(str(tmp_path / "v"), family=family, create=True,
                       device=cuda)
    try:
        fam, a = w.family, w.family.sub_shards
        rng = np.random.default_rng(rows)
        data = [rng.integers(0, 256, w.row_bytes, dtype=np.uint8).tobytes()
                for _ in range(rows)]
        w._encode_rows(data)  # first batch: leases and tables
        pool = get_pool()
        allocs = pool.snapshot()["allocs"]
        torch.cuda.synchronize()
        mem = torch.cuda.memory_stats()["allocation.all.allocated"]
        before = rs_cuda.launches["gf_apply"]
        got = w._encode_rows(data)
        assert rs_cuda.launches["gf_apply"] - before == launches
        assert pool.snapshot()["allocs"] == allocs
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == mem
        span = np.hstack([np.frombuffer(r, dtype=np.uint8).reshape(
            w.k, w.unit) for r in data])
        lanes = torch.from_numpy(np.ascontiguousarray(
            fam.to_lanes(span))).to(cuda)
        plain = rs_cuda.gf_apply_plain(fam.parity_matrix(), lanes)
        assert np.array_equal(got, fam.from_lanes(plain.cpu().numpy()))
        monkeypatch.setenv("WEED_EC_INLINE_DEVICE", "0")
        assert np.array_equal(got, w._encode_rows(data))
    finally:
        w.close()


def test_hbm_tier_round_trips_4mib_on_card(cuda):
    """A 4 MiB chunk goes up with one H2D copy into a resident slab of
    the pool on the card and comes back byte for byte."""
    from seaweedfs_tpu_torch.cache import HbmTier
    from seaweedfs_tpu_torch.ops.device_pool import get_pool

    tier = HbmTier(64 << 20)
    assert tier.device.type == "cuda"
    data = np.random.default_rng(4).bytes(4 << 20)
    pool = get_pool()
    h2d, d2h = pool.h2d_bytes, pool.d2h_bytes
    assert tier.put("1,a", data)
    (refs, nbytes), = pool.residents_under(tier.pool_prefix).values()
    assert (refs, nbytes) == (1, 4 << 20)
    payload = pool.acquire_resident(("read_cache", tier._tier, "1,a", 1),
                                    lambda: None, 0)
    assert payload.is_cuda and payload.numel() == 4 << 20
    pool.release_resident(("read_cache", tier._tier, "1,a", 1))
    assert tier.get("1,a") == data
    assert pool.h2d_bytes - h2d == pool.d2h_bytes - d2h == 4 << 20
    tier.close()
    assert pool.residents_under(tier.pool_prefix) == {}


def test_hbm_overwrite_serves_new_bytes_on_card(cuda):
    """R1 on the card: after invalidate and a new put of the same fid,
    the HBM tier serves the new bytes."""
    from seaweedfs_tpu_torch.cache import TieredReadCache

    chunk = 1 << 20
    c = TieredReadCache(mem_bytes=2 * chunk, hbm_bytes=16 * chunk)
    c.put("1,a", b"A" * chunk)
    for _ in range(3):
        c.get("1,a")
    c.invalidate("1,a", "overwrite")
    c.put("1,a", b"B" * chunk)
    for _ in range(3):
        c.get("1,a")
    for fid in ("1,b", "1,c", "1,d"):
        c.put(fid, b"x" * chunk)
    assert c.get("1,a") == b"B" * chunk
    assert c.stats_snapshot()["tier_hits"]["hbm"] == 1
    c.close()


def test_hbm_put_on_missing_device_raises(cuda):
    """A tier asked for a device index that does not exist raises from
    put: no quiet miss, no CPU copy."""
    from seaweedfs_tpu_torch.cache import HbmTier

    tier = HbmTier(1 << 20, device=f"cuda:{torch.cuda.device_count()}")
    with pytest.raises(RuntimeError):  # torch.AcceleratorError is one
        tier.put("1,a", b"x" * 1024)
    assert len(tier) == 0


def test_volume_server_over_http_on_card(cuda, tmp_path, monkeypatch):
    """A port VolumeServer on the card: 16 POSTs, /admin/ec/generate
    (K2), four shards lost, every object served over HTTP through K1."""
    from seaweedfs_tpu_torch.rpc.http_rpc import call
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE", "1")
    monkeypatch.setenv("WEED_EC_RECOVER_DEVICE_MIN_KB", "0")
    vs = VolumeServer([str(tmp_path)], "127.0.0.1:1", port=0,
                      ec_encoder_backend="cuda")
    vs.server.start()
    try:
        addr = vs.address
        call(addr, "/admin/assign_volume", {"volume": 5})
        rng = np.random.default_rng(16)
        stored = {}
        for i in range(1, 17):
            fid = f"5,{i:x}{0x1000 + i:08x}"
            stored[fid] = rng.bytes(int(rng.integers(100, 300000)))
            call(addr, f"/{fid}", raw=stored[fid], method="POST")
        rs_cuda.reset_launches()
        call(addr, "/admin/readonly", {"volume": 5})
        call(addr, "/admin/ec/generate", {"volume": 5})
        assert rs_cuda.launches["fused_apply_crc"] > 0
        call(addr, "/admin/ec/mount", {"volume": 5,
                                       "shard_ids": list(range(14))})
        call(addr, "/admin/delete_volume", {"volume": 5})
        call(addr, "/admin/ec/delete_shards",
             {"volume": 5, "shard_ids": [0, 5, 11, 13]})
        rs_cuda.reset_launches()
        for fid, data in stored.items():
            assert call(addr, f"/{fid}", parse=False) == data
        assert rs_cuda.launches["gf_apply"] > 0
    finally:
        vs.stop()



def test_curator_rebuild_job_launches_k2_on_card(cuda, tmp_path,
                                                 monkeypatch):
    """A port master and one port VolumeServer on the card: the shell's
    ec.encode (K2), four shards lost, the curator queues ec.rebuild, the
    server's worker leases it and rebuilds through K2; the rebuilt
    shards equal the encoded ones."""
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.rpc.http_rpc import call
    from seaweedfs_tpu_torch.shell import commands as sh
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    monkeypatch.setenv("WEED_MAINT_WORKER", "0")
    monkeypatch.setenv("WEED_MAINT_INTERVAL", "3600")
    (tmp_path / "m").mkdir()
    (tmp_path / "v").mkdir()
    master = MasterServer(port=0, pulse_seconds=0.2,
                          raft_dir=str(tmp_path / "m"))
    master.start()
    vs = VolumeServer([str(tmp_path / "v")], master.address, port=0,
                      ec_encoder_backend="cuda", pulse_seconds=0.2)
    vs.start()
    try:
        call(vs.address, "/admin/assign_volume", {"volume": 6})
        vs.heartbeat_once()
        rng = np.random.default_rng(26)
        for i in range(1, 17):
            call(vs.address, f"/6,{i:x}{0x2000 + i:08x}",
                 raw=rng.bytes(int(rng.integers(100, 300000))),
                 method="POST")
        rs_cuda.reset_launches()
        sh.ec_encode(sh.CommandEnv(master.address), 6)
        assert rs_cuda.launches["fused_apply_crc"] > 0
        d = tmp_path / "v"
        encoded = {s: (d / f"6.ec{s:02d}").read_bytes() for s in range(14)}
        call(vs.address, "/admin/ec/delete_shards",
             {"volume": 6, "shard_ids": [0, 5, 11, 13]})
        vs.heartbeat_once()
        master.curator.tick()
        assert [j["type"] for j in master.curator.queue.jobs()] == \
            ["ec.rebuild"]
        rs_cuda.reset_launches()
        assert vs.maintenance_worker.poll_once() == 1
        assert rs_cuda.launches["fused_apply_crc"] > 0
        (done,) = master.curator.queue.history
        assert done["outcome"] == "ok"
        assert {s: (d / f"6.ec{s:02d}").read_bytes()
                for s in range(14)} == encoded
    finally:
        vs.stop()
        master.stop()

FORK_CHILD = r"""
import json, os, sys

a = json.loads(sys.argv[1])
sys.path.insert(0, a["repo"])
os.environ["WEED_EC_RECOVER_DEVICE"] = "1"
os.environ["WEED_EC_RECOVER_DEVICE_MIN_KB"] = "0"
import torch

from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.storage.store import Store

store = Store([a["dir"]], ec_encoder_backend="cuda")
ev = store.find_ec_volume(1)
assert ev is not None and ev.device.type == "cuda", ev
assert not torch.cuda.is_initialized(), "the Store made a CUDA context"
want = {int(k): v for k, v in a["needles"].items()}
pid = os.fork()
if pid == 0:
    ok = 1
    try:
        for nid, (cookie, crc) in want.items():
            n = store.read_needle(1, nid, cookie=cookie)
            assert n.checksum == crc, nid
        assert rs_cuda.launches["gf_apply"] > 0
        ok = 0
    finally:
        os._exit(ok)
_, status = os.waitpid(pid, 0)
assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0, status
print("CHILD-OK", flush=True)
"""


def test_forked_child_decodes_through_k1(cuda, tmp_path):
    """The fork rule on the card: in a fresh interpreter a Store over an
    EC volume with four lost shards leaves CUDA uninitialized, and a
    child forked after it reads every degraded needle through its own
    K1 (a Store that initialized CUDA before the fork failed here)."""
    import json
    import os
    import subprocess
    import sys

    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    rng = np.random.default_rng(31)
    needles = {}
    store = Store([str(tmp_path)], ec_encoder_backend="cuda")
    try:
        store.add_volume(1)
        for nid in range(1, 25):
            n = Needle.create(rng.bytes(int(rng.integers(1, 400_000))))
            n.id, n.cookie = nid, int(rng.integers(1, 1 << 32))
            store.write_needle(1, n)
            needles[nid] = (n.cookie, n.checksum)
        store.ec_generate(1)
        store.delete_volume(1)
    finally:
        store.close()
    for sid in (0, 5, 11, 13):
        os.remove(tmp_path / ("1" + to_ext(sid)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", FORK_CHILD, json.dumps(
            {"repo": repo, "dir": str(tmp_path), "needles": needles})],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "CHILD-OK" in res.stdout, res.stderr


@pytest.mark.parametrize("length", [1, 7, 4096, 65536 + 3])
def test_portable_step_forms_on_card(cuda, length):
    """K7 on the card: every apply_matrix method launches K1, the batched
    steps launch K2, each equal to its CPU formulation."""
    from seaweedfs_tpu_torch.ops import gf256, rs_torch
    from seaweedfs_tpu_torch.parallel import mesh

    x = _bytes(length, (10, length), cuda)
    for method in rs_torch.METHODS:
        rs_cuda.reset_launches()
        got = rs_torch.apply_matrix(PARITY, x, method=method)
        assert rs_cuda.launches["gf_apply"] == 1
        assert torch.equal(got.cpu(), rs_torch.apply_matrix(
            PARITY, x.cpu(), method=method))
    data = _bytes(length + 1, (2, 10, length), cuda)
    bm = gf256.coeff_bit_matrix(PARITY).astype(np.int8)
    consts = rs_torch._bit_constants_cached(*rs_cuda._matrix_key(PARITY))
    want = mesh.batched_encode_step(bm, data.cpu())
    steps = [lambda: mesh.batched_encode_step(bm, data),
             lambda: mesh.make_sharded_encoder(words=False)(data)]
    if length % 4 == 0:
        steps.append(lambda: mesh.batched_swar_encode_step(consts, data))
    for step in steps:
        rs_cuda.reset_launches()
        par, crc = step()
        assert rs_cuda.launches["fused_apply_crc"] == 1
        assert torch.equal(par.cpu(), want[0])
        assert torch.equal(crc.cpu().to(torch.int64), want[1])
    rs_cuda.reset_launches()
    par = mesh._parity_bits_matmul(bm, data)
    assert rs_cuda.launches["gf_apply"] == 1
    assert torch.equal(par.cpu(), want[0])


def test_s3_get_behind_lost_shards_decodes_through_k1_and_hits_hbm(
        cuda, tmp_path, monkeypatch):
    """The S3 gateway over a filer on the card: objects PUT through S3,
    their volume EC-encoded (K2) with four shards lost, every object GET
    through S3 byte-identical with the volume server decoding through
    K1; a single-chunk object read three times (promoted to the HBM
    tier), the RAM tier flushed by the other objects, then served from
    the HBM tier."""
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.rpc.http_rpc import call
    from seaweedfs_tpu_torch.s3api.server import S3ApiServer
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer
    from seaweedfs_tpu_torch.wdclient.s3_client import S3Client

    for knob, value in (("WEED_EC_RECOVER_DEVICE", "1"),
                        ("WEED_EC_RECOVER_DEVICE_MIN_KB", "0"),
                        ("WEED_READ_CACHE_HBM_MB", "64"),
                        ("WEED_READ_CACHE_MB", "1"),
                        ("WEED_MAINT", "0"), ("WEED_MAINT_WORKER", "0")):
        monkeypatch.setenv(knob, value)
    chunk = 256 << 10
    rng = np.random.default_rng(21)
    objects = {f"o{i}": rng.bytes(3 * chunk - 1000) for i in range(8)}
    objects["single"] = rng.bytes(chunk - 100)
    master = MasterServer(port=0, pulse_seconds=0.2)
    master.start()
    started = [master]
    try:
        vs = VolumeServer([str(tmp_path)], master.address, port=0,
                          pulse_seconds=0.2, ec_encoder_backend="cuda")
        vs.start()
        started.append(vs)
        vs.heartbeat_once()
        filer = FilerServer(master.address, port=0, chunk_size=chunk)
        filer.start()
        started.append(filer)
        s3 = S3ApiServer(filer, port=0)
        s3.start()
        started.append(s3)
        client = S3Client(s3.address)
        client.create_bucket("warm")
        for key, body in objects.items():
            client.put_object("warm", key, body)
        vids = {int(c.fid.split(",")[0]) for key in objects
                for c in filer.filer.find_entry(f"/buckets/warm/{key}").chunks}
        rs_cuda.reset_launches()
        for vid in sorted(vids):
            call(vs.address, "/admin/readonly", {"volume": vid})
            call(vs.address, "/admin/ec/generate", {"volume": vid})
            call(vs.address, "/admin/ec/mount",
                 {"volume": vid, "shard_ids": list(range(14))})
            call(vs.address, "/admin/delete_volume", {"volume": vid})
            call(vs.address, "/admin/ec/delete_shards",
                 {"volume": vid, "shard_ids": [0, 5, 11, 13]})
        assert rs_cuda.launches["fused_apply_crc"] > 0
        vs.heartbeat_once()
        rs_cuda.reset_launches()
        for key, body in objects.items():
            assert client.get_object("warm", key) == body, key
        assert rs_cuda.launches["gf_apply"] > 0
        for _ in range(2):
            assert client.get_object("warm", "single") == objects["single"]
        for key in sorted(objects)[:8]:
            client.get_object("warm", key)  # flush the 1 MiB RAM tier
        before = filer.chunk_cache.stats_snapshot()["tier_hits"]["hbm"]
        assert client.get_object("warm", "single") == objects["single"]
        assert filer.chunk_cache.stats_snapshot()["tier_hits"]["hbm"] \
            == before + 1
    finally:
        for s in reversed(started):
            s.stop()
