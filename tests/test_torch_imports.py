"""The port stands alone: no JAX and nothing of the JAX package in its
sources or its process, and no quiet CPU fallback of its device path."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "seaweedfs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "seaweedfs_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_sources_import_no_jax():
    sources = _port_sources()
    assert len(sources) > 10
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path, node.module))
    assert not bad


def test_process_loads_no_jax():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from seaweedfs_tpu_torch import device
    from seaweedfs_tpu_torch.ops.codec import new_encoder, reconstruct_span
    from seaweedfs_tpu_torch.parallel.batched_encode import (encode_volumes,
                                                             rebuild_shards)
    from seaweedfs_tpu_torch.parallel.mesh import encode_batch
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder

    base = str(tmp_path / "v")
    with open(base + ".dat", "wb") as f:
        f.write(bytes(range(256)) * 10)
    inputs = np.zeros((10, 64), dtype=np.uint8)
    calls = [
        lambda: device.resolve(),
        lambda: device.resolve("cuda"),
        lambda: new_encoder(10, 4),
        lambda: new_encoder(10, 4, backend="cuda"),
        lambda: reconstruct_span(list(range(10)), inputs, 12),
        lambda: encode_batch(np.zeros((1, 10, 64), dtype=np.uint8)),
        lambda: encoder.write_ec_files(base, 10000, 100),
        lambda: encoder.rebuild_ec_files(base),
        lambda: encode_volumes([base]),
        lambda: rebuild_shards(base),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(base + ".ec00")  # nothing ran on the host


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    from seaweedfs_tpu_torch import device
    from seaweedfs_tpu_torch.ops.codec import new_encoder, reconstruct_span

    assert device.resolve("cpu") == torch.device("cpu")
    enc = new_encoder(10, 4, backend="torch")
    full = enc.encode([np.full(8, i, dtype=np.uint8) for i in range(10)]
                      + [None] * 4)
    got = reconstruct_span(list(range(1, 11)), np.stack(full[1:11]), 0,
                           device="cpu")
    assert np.array_equal(got, full[0])
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_kernel_wrappers_launch_only_on_cuda_tensors():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.gf256 import parity_matrix

    before = dict(rs_cuda.launches)
    m = parity_matrix(10, 14)
    rs_cuda.gf_apply(m, torch.zeros((10, 5), dtype=torch.uint8))
    rs_cuda.fused_apply_crc(m, torch.zeros((1, 10, 5), dtype=torch.uint8))
    assert rs_cuda.launches == before
    rs_cuda.reset_launches()
    assert set(rs_cuda.launches.values()) == {0}


def test_new_slice_modules_are_covered():
    """The inline-EC slice's modules are among the sources both checks
    above walk."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()[1:]}
    for mod in ("storage/erasure_coding/inline.py",
                "storage/erasure_coding/codes/cauchy.py",
                "storage/erasure_coding/codes/pm_msr.py",
                "util/faults.py"):
        assert mod in rel


def test_inline_and_family_entry_points_raise_without_cuda(no_cuda,
                                                           tmp_path):
    from seaweedfs_tpu_torch.maintenance.deep_scrub import deep_scrub_host
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.inline import (
        InlineEcVolume, InlineEcWriter, verify_inline_volume)

    base = str(tmp_path / "v")
    with open(base + ".dat", "wb") as f:
        f.write(bytes(range(256)) * 10)
    calls = [
        lambda: InlineEcVolume(str(tmp_path), "c", 1, family="cauchy",
                               create=True),
        lambda: InlineEcWriter(str(tmp_path / "w"), family="pm_msr",
                               create=True),
        lambda: encoder.write_ec_files(base, 10000, 100, family="cauchy"),
        lambda: encoder.rebuild_ec_files(base, family="pm_msr"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(base + ".ec00")
    assert not os.path.exists(str(tmp_path / "c_1.ec00"))
    InlineEcVolume(str(tmp_path), "c", 1, family="cauchy", create=True,
                   device="cpu").close()
    for call in (lambda: verify_inline_volume(str(tmp_path), "c", 1),
                 lambda: deep_scrub_host(str(tmp_path), "c", 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("mod", [
    "stats/__init__.py", "stats/metrics.py", "stats/events.py",
    "stats/sketch.py", "stats/access.py", "tracing.py", "profiling.py",
    "qos/__init__.py", "qos/classify.py", "cache/__init__.py",
    "cache/ram.py", "cache/disk.py", "cache/hbm.py", "cache/read_cache.py"])
def test_substrate_and_cache_modules_are_covered(mod):
    """The observability substrate's and the read cache's modules are
    among the sources both no-JAX checks above walk."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()[1:]}
    assert mod in rel


def test_cache_entry_points_raise_without_cuda(no_cuda):
    """The HBM tier, and a read cache given an HBM budget, run on the card
    unless asked for the CPU; without an HBM budget the cache touches no
    device."""
    from seaweedfs_tpu_torch.cache import HbmTier, TieredReadCache

    for call in (lambda: HbmTier(1 << 20),
                 lambda: TieredReadCache(mem_bytes=1 << 20,
                                         hbm_bytes=1 << 20)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert TieredReadCache(mem_bytes=1 << 20, hbm_bytes=0).hbm is None
    assert HbmTier(1 << 20, device="cpu").put("1,a", b"x")


@pytest.mark.parametrize("mod", [
    "rpc/__init__.py", "rpc/http_rpc.py", "rpc/policy.py", "qos/shm.py",
    "qos/admission.py", "qos/quota.py", "security/__init__.py",
    "security/jwt_auth.py", "stats/healthz.py", "query/__init__.py",
    "query/json_query.py", "util/ui.py", "storage/volume_backup.py",
    "storage/tools.py", "volume_server/__init__.py",
    "volume_server/server.py"])
def test_server_slice_modules_are_covered(mod):
    """The volume server's slice (RPC, admission, security, HTTP
    surfaces, storage pieces, the server) is among the sources both
    no-JAX checks above walk."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()[1:]}
    assert mod in rel


def test_volume_server_ec_routes_fail_without_cuda(no_cuda, tmp_path):
    """A volume server left on its default device answers an EC encode
    with a 500 that names the missing card, and writes no shard: the
    device error is the request's reply, never a host encode."""
    from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    vs = VolumeServer([str(tmp_path)], "127.0.0.1:1", port=0,
                      ec_encoder_backend="cuda")
    vs.server.start()
    try:
        call(vs.address, "/admin/assign_volume", {"volume": 3})
        call(vs.address, "/3,01000000aa", raw=b"hello", method="POST")
        assert call(vs.address, "/3,01000000aa", parse=False) == b"hello"
        with pytest.raises(RpcError) as e:
            call(vs.address, "/admin/ec/generate", {"volume": 3})
        assert e.value.status == 500 and "no CUDA device" in str(e.value)
        assert not os.path.exists(str(tmp_path / "3.ec00"))
    finally:
        vs.stop()


@pytest.mark.parametrize("mod", [
    "rpc/prefork.py", "storage/native_engine.py", "storage/tier.py",
    "storage/backend.py", "storage/needle_map.py",
    "remote_storage/__init__.py", "wdclient/__init__.py",
    "wdclient/resource_pool.py", "wdclient/s3_client.py",
    "wdclient/volume_tcp_client.py", "ops/rs_torch.py", "parallel/mesh.py"])
def test_multiprocess_and_native_modules_are_covered(mod):
    """The multi-process and native slice (prefork workers, the native
    engine, tiers and remote storage, the clients, the portable step
    forms) is among the sources both no-JAX checks above walk."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()[1:]}
    assert mod in rel


def test_portable_step_forms_raise_without_cuda(no_cuda):
    """The K7 entry points run on the card unless asked for the CPU."""
    from seaweedfs_tpu_torch.ops.rs_torch import TorchEncoder
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh

    for method in ("pallas", "swar", "mxu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchEncoder(method=method)
        assert TorchEncoder(device="cpu", method=method).method == method
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh("cpu") == [torch.device("cpu")]
