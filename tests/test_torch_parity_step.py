"""The port's pooled parity step and its plumbing against the JAX package:
make_parity_step (K1 and K2 forms, k = 1..10, a matrix override, two
devices), the strided and out= entries of K1 and K2, the device lists,
the step's cost record, the device timeline, the QoS lanes and the
platform probes.  Everything runs on the CPU (the kernels' plain
versions); every comparison is exact."""

import threading

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from seaweedfs_tpu.ops import crc32c as j_crc
from seaweedfs_tpu.ops import gf256 as j_gf
from seaweedfs_tpu.ops.rs_numpy import gf_apply_matrix as j_apply
from seaweedfs_tpu.parallel import mesh as j_mesh
from seaweedfs_tpu_torch import profiling
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.parallel import mesh as t_mesh
from seaweedfs_tpu_torch.qos.lanes import LANES, DeviceLanes
from seaweedfs_tpu_torch.util import platform as plat

CPU = torch.device("cpu")
PARITY = np.ascontiguousarray(j_gf.parity_matrix(10, 14), dtype=np.uint8)


def _jax_step(matrix, key, data, fused):
    """JAX's make_parity_step on a one-device CPU mesh over (k, B, L)
    bytes (L % 4 == 0) -> parity bytes (p, B, L), raw CRCs (k + p, B)."""
    import jax.numpy as jnp

    k, b, length = data.shape
    p = matrix.shape[0]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "block"))
    step = j_mesh.make_parity_step(mesh, matrix=matrix, key=key,
                                   fused_crc=fused)
    out0 = jnp.zeros((p, b, length // 4), jnp.int32)
    res = step(jnp.asarray(data.view(np.int32)), out0)
    par, raw = (res if fused else (res, None))
    par = np.ascontiguousarray(np.asarray(par)).view(np.uint8)
    return par.reshape(p, b, length), \
        None if raw is None else np.asarray(raw).astype(np.int64)


def _host(matrix, data):
    """The JAX package's host math: parity (p, B, L) and raw CRC images
    (k + p, B) of every data and parity row."""
    k, b, length = data.shape
    par = np.stack([j_apply(matrix, data[:, i]) for i in range(b)], axis=1)
    full = np.concatenate([data, par], axis=0)
    raw = np.array([[j_crc.raw_update(0, full[r, i].tobytes())
                     for i in range(b)] for r in range(full.shape[0])],
                   dtype=np.int64)
    return par, raw


def _run_port(step, data, p):
    x = torch.from_numpy(data.copy())
    out = torch.zeros((p,) + data.shape[1:], dtype=torch.uint8)
    crc = step(x, out)
    return out.numpy(), None if crc is None else crc.numpy()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", range(1, 11))
def test_parity_step_equals_jax(k, fused):
    """Compacted k rows: the matrix's first k columns, parity and raw CRCs
    equal JAX's step at an even L and the host math at odd L."""
    rng = np.random.default_rng(100 * k + fused)
    step = t_mesh.make_parity_step([CPU], fused_crc=fused)
    data = rng.integers(0, 256, (k, 3, 64), dtype=np.uint8)
    got, got_crc = _run_port(step, data, 4)
    want, want_crc = _jax_step(PARITY, ("rs", k, fused), data, fused)
    assert np.array_equal(got, want)
    if fused:
        assert np.array_equal(got_crc, want_crc)
    else:
        assert got_crc is None
    for length in (37, 50):
        data = rng.integers(0, 256, (k, 2, length), dtype=np.uint8)
        got, got_crc = _run_port(step, data, 4)
        want, want_crc = _host(PARITY[:, :k], data)
        assert np.array_equal(got, want)
        if fused:
            assert np.array_equal(got_crc, want_crc)


@pytest.mark.parametrize("fused", [False, True])
def test_parity_step_matrix_override_equals_jax(fused):
    rng = np.random.default_rng(7 + fused)
    matrix = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    step = t_mesh.make_parity_step([CPU], matrix=matrix, key="fam5x7",
                                   fused_crc=fused)
    assert t_mesh.make_parity_step([CPU], matrix=matrix, key="fam5x7",
                                   fused_crc=fused) is step
    data = rng.integers(0, 256, (7, 4, 128), dtype=np.uint8)
    got, got_crc = _run_port(step, data, 5)
    want, want_crc = _jax_step(matrix, ("fam5x7", fused), data, fused)
    assert np.array_equal(got, want)
    if fused:
        assert np.array_equal(got_crc, want_crc)


@pytest.mark.parametrize("fused", [False, True])
def test_parity_step_two_devices_splits_batch(fused):
    """On two devices the step takes per-device shards of the B axis and
    launches once per device; the stitched result equals one device's."""
    rng = np.random.default_rng(11 + fused)
    data = rng.integers(0, 256, (6, 4, 40), dtype=np.uint8)
    one = t_mesh.make_parity_step([CPU], fused_crc=fused)
    two = t_mesh.make_parity_step([CPU, CPU], fused_crc=fused)
    want, want_crc = _run_port(one, data, 4)
    parts = t_mesh.split_batch(4, 2)
    outs = [torch.zeros((4, hi - lo, 40), dtype=torch.uint8)
            for lo, hi in parts]
    crcs = two([torch.from_numpy(data[:, lo:hi].copy()) for lo, hi in parts],
               outs)
    assert np.array_equal(np.concatenate([o.numpy() for o in outs], axis=1),
                          want)
    if fused:
        assert np.array_equal(
            np.concatenate([c.numpy() for c in crcs], axis=1), want_crc)
    with pytest.raises(ValueError):
        two([torch.zeros((6, 2, 40), dtype=torch.uint8)], outs)


def test_parity_step_checks_shapes():
    step = t_mesh.make_parity_step([CPU])
    with pytest.raises(ValueError):
        step(torch.zeros((11, 2, 8), dtype=torch.uint8),
             torch.zeros((4, 2, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        step(torch.zeros((3, 2, 8), dtype=torch.uint8),
             torch.zeros((4, 3, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):  # the K1 form needs contiguous slots
        step(torch.zeros((3, 8, 2), dtype=torch.uint8).permute(0, 2, 1),
             torch.zeros((4, 2, 8), dtype=torch.uint8))


def test_k1_out_and_row_strides_plain():
    """K1's entry on a strided (d, L) view (rows of a larger buffer) with
    `out=`: the result lands in `out` and equals the JAX package's host
    GF apply of the contiguous copy."""
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.integers(0, 256, (10, 3, 41),
                                         dtype=np.uint8))
    view = base[:, 1, :]               # row stride 123, not contiguous
    assert not view.is_contiguous()
    out = torch.empty((4, 41), dtype=torch.uint8)
    got = rs_cuda.gf_apply(PARITY, view, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert np.array_equal(out.numpy(),
                          j_apply(PARITY, view.contiguous().numpy()))
    with pytest.raises(ValueError):   # out must be contiguous (p, L)
        rs_cuda.gf_apply(PARITY, view,
                         out=torch.empty((41, 4), dtype=torch.uint8).t())
    with pytest.raises(ValueError):   # bytes within a row are contiguous
        rs_cuda.gf_apply(PARITY, torch.zeros((41, 10),
                                             dtype=torch.uint8).t())


def test_k2_permuted_views_plain():
    """K2's entry on the (B, k, L) permute of a (k, B, L) buffer, writing
    through the permute of a (p, B, L) slot: equal to the JAX package's
    host math, into the caller's buffers."""
    rng = np.random.default_rng(4)
    k, b, length = 7, 3, 33
    buf = torch.from_numpy(rng.integers(0, 256, (k, b, length),
                                        dtype=np.uint8))
    slot = torch.zeros((4, b, length), dtype=torch.uint8)
    crc = torch.zeros((b, k + 4), dtype=torch.int64)
    m = np.ascontiguousarray(PARITY[:, :k])
    out, got_crc = rs_cuda.fused_apply_crc(m, buf.permute(1, 0, 2),
                                           out=slot.permute(1, 0, 2),
                                           crc=crc)
    assert out.data_ptr() == slot.data_ptr() and got_crc is crc
    want, want_raw = _host(m, buf.numpy())
    assert np.array_equal(slot.numpy(), want)
    assert np.array_equal(crc.numpy().T, want_raw)
    assert rs_cuda.k2_scratch_shape(4, k, b, length)[:2] == (b, k + 4)
    with pytest.raises(ValueError):   # crc is (B, d + p)
        rs_cuda.fused_apply_crc(m, buf.permute(1, 0, 2),
                                crc=torch.zeros((b, k), dtype=torch.int64))


def test_shard_devices_and_mesh(monkeypatch):
    devs = [CPU, CPU, CPU]
    monkeypatch.setenv("WEED_EC_DEVICE_SHARD", "2")
    assert t_mesh.shard_devices(devs) == [CPU, CPU]
    monkeypatch.setenv("WEED_EC_DEVICE_SHARD", "9")
    assert len(t_mesh.shard_devices(devs)) == 3
    monkeypatch.setenv("WEED_EC_DEVICE_SHARD", "auto")
    monkeypatch.setattr(plat, "available_cpu_count", lambda: 1)
    assert t_mesh.shard_devices(devs) == [CPU]   # CPU: one per core
    assert t_mesh.make_ec_mesh("cpu") == [CPU]
    monkeypatch.setenv("WEED_EC_DEVICE_SHARD", "2")
    assert t_mesh.make_ec_mesh(["cpu", CPU]) == [CPU, CPU]
    assert t_mesh.split_batch(6, 3) == [(0, 2), (2, 4), (4, 6)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_ec_mesh()


def test_words_capable():
    card = torch.device("cuda", 0)
    assert t_mesh.words_capable([card], 1 << 20)
    assert not t_mesh.words_capable([card], 50)
    assert not t_mesh.words_capable([card, card], 1 << 20)
    assert not t_mesh.words_capable([CPU], 1 << 20)


def test_step_cost_and_device_timeline():
    profiling.reset_device_telemetry()
    entry = t_mesh.step_cost_analysis("k3xb2xw64f-test", 3, 2, 64, 4, True)
    assert entry == {"flops": 4 * 3 * 2 * 64.0,
                     "bytes_accessed": float(7 * 2 * 64 + 8 * 7 * 2)}
    profiling.record_device_batch(0.0125, units=2, k=3, devices=1)
    tl = profiling.device_timeline()
    assert tl["timeline"][-1]["dispatch_ready_ms"] == 12.5
    assert tl["timeline"][-1]["k"] == 3
    assert tl["kernel_cost"]["k3xb2xw64f-test"]["flops"] == entry["flops"]
    profiling.reset_device_telemetry()
    assert profiling.device_timeline()["timeline"] == []


class _Ticks:
    """A clock that moves one second per reading, so a lane's recorded
    wait counts the readings it took, the same in both packages."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _lanes_record(lanes_cls, monkeypatch) -> list:
    """One background batch stalled behind a foreground decode until it
    exits, then the starvation floor at 0 and the lanes switched off:
    the lanes' snapshots along the way."""
    monkeypatch.setenv("WEED_QOS_BG_MAX_STALL_MS", "60000")
    monkeypatch.delenv("WEED_QOS", raising=False)
    lanes = lanes_cls(now=_Ticks())
    entered, release, done = (threading.Event() for _ in range(3))
    waits = []

    def foreground():
        with lanes.foreground():
            entered.set()
            release.wait(10)

    fg = threading.Thread(target=foreground)
    fg.start()
    assert entered.wait(10)
    waiter = threading.Thread(
        target=lambda: (waits.append(lanes.background_checkpoint()),
                        done.set()))
    waiter.start()
    assert not done.wait(0.2)          # stalled behind the foreground
    stalled = lanes.snapshot()
    release.set()
    assert done.wait(10)
    fg.join(10)
    waiter.join(10)
    assert not fg.is_alive() and not waiter.is_alive()
    record = [stalled, lanes.snapshot()]
    monkeypatch.setenv("WEED_QOS_BG_MAX_STALL_MS", "0")
    with lanes.foreground():
        waits.append(lanes.background_checkpoint())  # floor: no stall
    monkeypatch.setenv("WEED_QOS", "0")
    with lanes.foreground():
        waits.append(lanes.background_checkpoint())  # lanes off
    record += [lanes.snapshot(), waits]
    lanes.reset()
    return record + [lanes.snapshot()]


def test_background_checkpoint_waits_for_foreground(monkeypatch):
    """A background batch waits while a foreground decode is in flight
    and proceeds once it exits; the starvation floor bounds the wait and
    WEED_QOS=0 turns the lanes off.  The port's DeviceLanes and the JAX
    package's run the same sequence on the same clock and agree."""
    from seaweedfs_tpu.qos import lanes as j_lanes

    want = _lanes_record(j_lanes.DeviceLanes, monkeypatch)
    got = _lanes_record(DeviceLanes, monkeypatch)
    assert got == want
    stalled, after, off, waits, cleared = got
    assert stalled["foreground_active"] == 1
    assert stalled["preemptions"] == 1 and stalled["background_batches"] == 0
    assert after["preemptions"] == 1 and after["foreground_batches"] == 1
    assert after["background_batches"] == 1
    assert after["background_wait_seconds"] > 0
    assert waits[0] > 0 and waits[1] >= 0.0 and waits[2] == 0.0
    assert off["enabled"] is False and off["background_batches"] == 2
    assert cleared["foreground_batches"] == 0


def test_decode_batch_runs_in_foreground_lane():
    from seaweedfs_tpu_torch.storage.erasure_coding.recover import \
        SpanDecodeBatcher

    seen = []

    def decode(survivors, target, inputs, spans):
        seen.append(LANES.snapshot()["foreground_active"])
        return inputs[0]

    before = LANES.snapshot()["foreground_batches"]
    out = SpanDecodeBatcher(decode).decode((1, 2), 0,
                                           np.ones((2, 5), dtype=np.uint8))
    assert seen == [1] and out.tolist() == [1] * 5
    assert LANES.snapshot()["foreground_batches"] == before + 1
    assert LANES.snapshot()["foreground_active"] == 0


def test_platform_probes(monkeypatch):
    assert plat.available_cpu_count() >= 1
    assert plat.prefer_batched_encode("cpu") is True
    assert plat.link_throughput(device="cpu") == (0.0, 0.0)
    assert plat.host_codec_gibps() > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert plat.on_cuda() is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plat.prefer_batched_encode()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plat.link_throughput()


def test_auto_selection_under_patched_link(monkeypatch):
    """On a card the choice follows the predicted link rate against the
    host codec (test_batched_encode.py's auto-selection cases)."""
    card = torch.device("cuda", 0)
    monkeypatch.setattr(plat.device_mod, "resolve", lambda d=None: card)
    monkeypatch.setattr(plat, "link_throughput",
                        lambda **kw: (5.0, 2.0))   # MB/s, relay class
    assert plat.predicted_batched_gibps() < 0.01
    assert plat.prefer_batched_encode() is False
    monkeypatch.setattr(plat, "link_throughput", lambda **kw: (1e6, 1e6))
    assert plat.prefer_batched_encode() is True
    monkeypatch.setattr(plat, "link_throughput", lambda **kw: (0.0, 0.0))
    assert plat.prefer_batched_encode() is False
