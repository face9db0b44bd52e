"""Platform probes: usable cores, the CUDA card, the host<->device link,
and the encode backend's auto-selection.

Counterpart of seaweedfs_tpu/util/platform.py.  The batched device
pipeline moves every `.dat` byte over the link and 0.4 bytes of parity
back, so on a machine whose link is slower than the host codec the host
pipeline encodes faster end to end.  `prefer_batched_encode` predicts the
device pipeline's rate from a measured link probe (pinned 4 MiB copies
timed with CUDA events, cached with a TTL and smoothed) and compares it
with the host codec's measured rate.

Like every entry point of the port, the probes resolve their device
first: without a card and without device="cpu" they raise.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import torch

from .. import device as device_mod

_lock = threading.Lock()
_LINK_TTL_S = 600.0
_LINK_PROBE_BYTES = 4 << 20
_link_cache: dict = {}  # {"h2d": MB/s, "d2h": MB/s, "at": monotonic}
# bytes that come back over the link per input byte (4 parity per 10 data)
_PARITY_RATIO = 0.4
# pipeline efficiency against the raw link numbers (dispatch gaps)
_LINK_EFFICIENCY = 0.85
_host_codec_cache: list = []


def available_cpu_count() -> int:
    """Cores this process may run on: the scheduling affinity mask where
    the platform has one (cgroup cpusets, taskset), else os.cpu_count().
    Worker pools size from this, not from the machine's core count."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def on_cuda() -> bool:
    """True when a CUDA card is present."""
    return torch.cuda.is_available()


def link_throughput(probe_bytes: int = _LINK_PROBE_BYTES,
                    ttl: float = _LINK_TTL_S,
                    device=None) -> tuple[float, float]:
    """(h2d_MBps, d2h_MBps) of the host<->card link: one pinned
    `probe_bytes` buffer copied to the card and back, timed between CUDA
    events, smoothed (EWMA) and cached for `ttl` seconds.  A CPU device
    has no link and reads (0, 0)."""
    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        return 0.0, 0.0
    with _lock:
        cached = dict(_link_cache)
    if cached and time.monotonic() - cached["at"] < ttl:
        return cached["h2d"], cached["d2h"]
    host = torch.zeros(probe_bytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(probe_bytes, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev)
    card.copy_(host, non_blocking=True)  # warm the path end to end
    host.copy_(card, non_blocking=True)
    stream.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record(stream)
    card.copy_(host, non_blocking=True)
    ev[1].record(stream)
    host.copy_(card, non_blocking=True)
    ev[2].record(stream)
    ev[2].synchronize()
    mib = probe_bytes / (1 << 20)
    h2d = mib / max(ev[0].elapsed_time(ev[1]) / 1e3, 1e-9)
    d2h = mib / max(ev[1].elapsed_time(ev[2]) / 1e3, 1e-9)
    with _lock:
        if _link_cache:  # EWMA: smooth one-off hiccups
            h2d = 0.5 * h2d + 0.5 * _link_cache["h2d"]
            d2h = 0.5 * d2h + 0.5 * _link_cache["d2h"]
        _link_cache.update(h2d=h2d, d2h=d2h, at=time.monotonic())
    return h2d, d2h


def predicted_batched_gibps(device=None) -> float:
    """Predicted disk-to-shards rate of the batched device pipeline in
    GiB/s: every input byte crosses the link up and 0.4 bytes of parity
    come back, at a fixed efficiency."""
    h2d, d2h = link_throughput(device=device)
    if h2d <= 0 or d2h <= 0:
        return 0.0
    mbps = _LINK_EFFICIENCY / (1.0 / h2d + _PARITY_RATIO / d2h)
    return mbps / 1024.0


def host_codec_gibps() -> float:
    """Measured rate of the host EC codec (GiB/s), derated to an end to
    end estimate; cached per process."""
    if _host_codec_cache:
        return _host_codec_cache[0]
    import numpy as np

    from ..ops import codec as codec_mod

    enc = codec_mod.new_host_encoder(10, 4)
    data = np.zeros((10, 4 << 20), dtype=np.uint8)
    matrix = np.asarray(enc.matrix[10:])
    enc._apply(matrix, data[:, :1 << 20])  # warm
    t0 = time.monotonic()
    enc._apply(matrix, data)
    kernel = data.nbytes / float(1 << 30) / max(time.monotonic() - t0, 1e-6)
    # end to end is the smaller of the codec and the host pipeline's I/O
    # side: ~1.2 GiB/s of read + write per worker, scaling with the
    # worker fan-out
    workers = int(os.environ.get("WEED_EC_HOST_WORKERS", "0") or 0) \
        or max(1, min(16, available_cpu_count()))
    rate = min(kernel * 0.75, 1.2 * workers)
    _host_codec_cache.append(rate)
    return rate


def prefer_batched_encode(device=None) -> bool:
    """True when the batched device pipeline is predicted to beat the host
    codec end to end on this machine's link.  A CPU device shares host
    memory, so there is no link to lose on: True."""
    dev = device_mod.resolve(device)
    if dev.type == "cpu":
        return True
    predicted = predicted_batched_gibps(dev)
    host = host_codec_gibps()
    if predicted <= 0:
        return False
    if predicted < host:
        logging.getLogger(__name__).info(
            "ec encode auto-backend: host codec (link-capped device path "
            "predicted %.3f GiB/s < host %.3f GiB/s)", predicted, host)
        return False
    return True
