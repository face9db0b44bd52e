"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # the whole run (one card)
    python3 chip_smoke.py --quick    # build and kernel checks only
    python3 chip_smoke.py --kernels  # build, kernel checks and timing

Phases:
  1. build the CUDA kernels from the checkout's sources (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, at ragged lengths and through misaligned
     pointers (tolerance 0: exact integer math), and time both with CUDA
     events, cold in L2 (`time_cold`); time reconstruct_span's host
     route against its K1 route at 64 KiB, 256 KiB and 1 MiB spans;
  3. the raw-volume path, RS(10,4) over a seeded 256 MiB `.dat` (cut
     from 1 GiB to leave the run's time to phase 4): write_ec_files,
     rebuild_ec_files after three loss patterns, reconstruct_span and
     new_encoder("cuda").reconstruct of a lost data shard, each checked
     byte for byte and CRC for CRC;
  4. the needle path at real size (SURVEY §7's minimum slice): a ~1 GiB
     volume of ~7,000 seeded needles written through Volume, EC-encoded
     on the card (K2) with its .ecx and .vif, 4 shard files deleted, every
     needle read back through EcVolume's degraded-read ladder (K1 for
     each recovered block), once on one thread and once on 8, then the
     lost shards rebuilt (K2) and the volume decoded back to a .dat and
     .idx byte-identical to the originals;
  5. one JSON line of per-kernel numbers, then the card's name and power
     limit, then the result line.

Exits non-zero, printing no result, when there is no CUDA device or any
check fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import _build, codec, native, rs_cuda
from seaweedfs_tpu_torch.ops import crc32c as crc_host
from seaweedfs_tpu_torch.ops.codec import new_encoder, reconstruct_span
from seaweedfs_tpu_torch.ops.crc_device import batched_crc32c_raw, finalize
from seaweedfs_tpu_torch.ops.gf256 import parity_matrix
from seaweedfs_tpu_torch.ops.rs_numpy import decode_rows
from seaweedfs_tpu_torch.storage.erasure_coding import (decoder, encoder,
                                                        recover, to_ext)
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
    EcVolume, EcVolumeShard)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
MIB = 1 << 20
VOLUME_BYTES = 256 * MIB    # phase 3's raw volume
NEEDLE_VOLUME_BYTES = 1 << 30  # phase 4: one ~1 GiB needle volume
NEEDLE_MIN, NEEDLE_MAX = 1 << 10, 1 << 20  # log-uniform needle sizes
LOST = (0, 5, 11, 13)       # two data and two parity shards
READERS = 8                 # threads of phase 4's concurrent pass
CHUNK = MIB                 # the pipeline's column chunk for 1 MiB blocks
SEED = 20261016
SPIN_CYCLES = 200_000_000   # ~0.1 s of card time to queue timed runs behind

KERNELS = {
    "gf_apply": {
        "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:29",
    },
    "fused_apply_crc": {
        "source": "seaweedfs_tpu_torch/csrc/fused_apply_crc.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:201",
    },
}


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def time_cold(fn, sets, reps: int = 24) -> float:
    """Mean device milliseconds of one call of `fn`, cold in L2.

    Run i calls fn(*sets[i % len(sets)]): the sets' inputs together
    exceed the card's 50 MB L2, so each run reads its input from device
    memory, as the pipeline does with a batch fresh from its H2D copy.
    Every run's outputs are kept until the end, so each run writes fresh
    memory too.  The runs are queued behind a spin kernel, between two
    CUDA events around the whole run, so the card runs them back to back
    and neither the host's launch overhead nor per-run events enter the
    time (a function that waits for the card itself, as a pageable copy
    does, still pays its wait)."""
    # warm-up: one pass over every run's inputs, so the caching allocator
    # holds every output block before the timed runs (no cudaMalloc in
    # them)
    keep = [fn(*sets[i % len(sets)]) for i in range(reps + 1)]
    torch.cuda.synchronize()
    keep.clear()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(reps):
        keep.append(fn(*sets[(i + 1) % len(sets)]))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernels(fn, sets, reps: int = 8) -> list[tuple[str, int, float]]:
    """(kernel name, launches, mean device us) of `reps` cold calls of
    `fn`, from torch.profiler's CUDA activity: the device time of each
    kernel a call launches, without the gaps between them."""
    from torch.profiler import ProfilerActivity, profile

    keep = [fn(*sets[i % len(sets)]) for i in range(reps + 1)]
    torch.cuda.synchronize()
    keep.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            keep.append(fn(*sets[(i + 1) % len(sets)]))
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0)
        if total > 0 and e.count > 0:
            rows.append((e.key, e.count, total / e.count))
    return rows


def gpu_state() -> str:
    """The card's SM clock (now / max), power draw and temperature, read
    beside the timings: a card below its limits runs slower under load."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return q.stdout.strip().splitlines()[0]


def rand_bytes(rng, shape, dev) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.from_numpy(np.frombuffer(rng.bytes(n), dtype=np.uint8)
                            .reshape(shape).copy()).to(dev)


# -- phase 2 -----------------------------------------------------------------


def compare_k1(matrix, data) -> int:
    got = rs_cuda.gf_apply(matrix, data)
    want = rs_cuda.gf_apply_plain(matrix, data)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    check(err == 0 and torch.equal(got, want),
          f"gf_apply differs from plain at {tuple(data.shape)}")
    return err


def compare_k2(matrix, data) -> int:
    got, got_crc = rs_cuda.fused_apply_crc(matrix, data)
    want, want_crc = rs_cuda.fused_apply_crc_plain(matrix, data)
    torch.cuda.synchronize()
    err = max(int((got.int() - want.int()).abs().max()),
              int((got_crc - want_crc).abs().max()))
    check(err == 0 and torch.equal(got, want) and
          torch.equal(got_crc, want_crc),
          f"fused_apply_crc differs from plain at {tuple(data.shape)}")
    return err


def misaligned(rng, shape, offset: int, dev) -> torch.Tensor:
    """Seeded bytes of `shape` as a contiguous view that starts `offset`
    bytes into a fresh buffer, so its pointer is off a 16-byte boundary."""
    n = int(np.prod(shape))
    view = rand_bytes(rng, (n + offset,), dev)[offset:].view(shape)
    check(view.data_ptr() % 16 != 0, "view is 16-byte aligned")
    return view


def kernel_phase(dev, mode: str) -> dict:
    rng = np.random.default_rng(SEED)
    par = np.ascontiguousarray(parity_matrix(10, 14))
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    rebuild = np.ascontiguousarray(
        decode_rows(10, 14, survivors, (0, 5, 11, 13)))
    row = np.ascontiguousarray(
        decode_rows(10, 14, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10], (3,)))
    # distinct input sets, together beyond the 50 MB L2 (time_cold)
    enc_sets = [(par, rand_bytes(rng, (6, 10, MIB), dev)) for _ in range(4)]
    k1_sets = [(row, rand_bytes(rng, (10, MIB), dev)) for _ in range(8)]
    enc_in, k1_in = enc_sets[0][1], k1_sets[0][1]
    errs = {"gf_apply": 0, "fused_apply_crc": 0}

    def k2(m, x):
        errs["fused_apply_crc"] = max(errs["fused_apply_crc"],
                                      compare_k2(m, x))

    def k1(m, x):
        errs["gf_apply"] = max(errs["gf_apply"], compare_k1(m, x))

    k2(par, enc_in)
    k2(rebuild, enc_in)
    k1(row, k1_in)
    k1(par, k1_in)
    for length in (1, 50, 4096 + 3, MIB + 3):
        k2(par, rand_bytes(rng, (2, 10, length), dev))
        k2(rebuild, rand_bytes(rng, (1, 10, length), dev))
        k1(row, rand_bytes(rng, (10, length), dev))
        for offset in (1, 3):
            k2(par, misaligned(rng, (1, 10, length), offset, dev))
            k1(par, misaligned(rng, (10, length), offset, dev))
    k2(par, misaligned(rng, (1, 10, MIB), 1, dev))
    k1(row, misaligned(rng, (10, MIB), 3, dev))
    log(f"kernels match their plain versions (max_abs_err {errs})")
    if mode == "quick":
        return {}
    # one K2 encode launch moves 60 MiB in and 24 MiB out (+ the CRCs),
    # one K1 reconstruct of a 1 MiB span 10 MiB in and 1 MiB out
    k2_bytes = enc_in.numel() + 6 * 4 * MIB + 6 * 14 * 8
    k1_bytes = k1_in.numel() + MIB
    log(f"card before timing (sm clock, max, power, temp): {gpu_state()}")
    stats = {
        "fused_apply_crc": {
            "ms": time_cold(rs_cuda.fused_apply_crc, enc_sets),
            "plain_ms": time_cold(rs_cuda.fused_apply_crc_plain, enc_sets,
                                  reps=8),
            "bytes": k2_bytes,
        },
        "gf_apply": {
            "ms": time_cold(rs_cuda.gf_apply, k1_sets),
            "plain_ms": time_cold(rs_cuda.gf_apply_plain, k1_sets, reps=8),
            "bytes": k1_bytes,
        },
    }
    log(f"card after timing: {gpu_state()}")
    for name, fn, sets in (("fused_apply_crc", rs_cuda.fused_apply_crc,
                            enc_sets),
                           ("gf_apply", rs_cuda.gf_apply, k1_sets)):
        for key, count, us in profile_kernels(fn, sets):
            log(f"profile {name}: {key[:60]} x{count} {us:.3f} us")
    for name, s in stats.items():
        s["max_abs_err"] = errs[name]
        s["bound_ms"] = s["bytes"] / HBM_BYTES_PER_S * 1e3
        s["bound_share"] = s["bound_ms"] / s["ms"]
        log(f"{name} (cold L2): {s['ms'] * 1e3:.3f} us, plain "
            f"{s['plain_ms'] * 1e3:.3f} us, bound "
            f"{s['bound_ms'] * 1e3:.3f} us, "
            f"{100 * s['bound_share']:.1f}% of its bound")
    return stats


class knobs:
    """Set WEED_* environment knobs for a `with` block, then restore."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.prev = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def median_ms(fn, reps: int = 20) -> float:
    """Median host-clock ms of `fn()` over `reps` calls after 3 warm-up
    calls; `fn` returns host memory, so each call ends in a sync."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def route_phase(dev) -> dict:
    """reconstruct_span's two routes for one decode row x (10, S): the
    host codec (the native library's GF apply) and the device route
    (pageable H2D of the survivor stack, K1, D2H), as median host-clock
    ms per call, beside K1 alone cold in L2 (`time_cold`).  The routes'
    crossing is what WEED_EC_RECOVER_DEVICE_MIN_KB (512) should sit at."""
    check(native.lib() is not None, "the native host library did not build")
    rng = np.random.default_rng(SEED + 1)
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    row = np.ascontiguousarray(decode_rows(10, 14, survivors, (0,)))
    out = {}
    for span in (64 << 10, 256 << 10, MIB):
        x = np.frombuffer(rng.bytes(10 * span), np.uint8).reshape(
            10, span).copy()
        want = codec._apply_rows_host(row, x)[0]
        res = {}
        for route, knob in (("host", "0"), ("device", "1")):
            with knobs(WEED_EC_RECOVER_DEVICE=knob,
                       WEED_EC_RECOVER_DEVICE_MIN_KB="0"):
                got = reconstruct_span(survivors, x, 0, device=dev)
                check(np.array_equal(got, want),
                      f"reconstruct_span {route} route differs at {span}")
                res[route + "_ms"] = median_ms(
                    lambda: reconstruct_span(survivors, x, 0, device=dev))
        nsets = max(8, -(-64 * MIB // (10 * span)))
        sets = [(row, rand_bytes(rng, (10, span), dev)) for _ in range(nsets)]
        res["k1_ms"] = time_cold(rs_cuda.gf_apply, sets)
        out[span] = res
        log(f"reconstruct_span (10, {span >> 10} KiB) -> 1 row: host "
            f"{res['host_ms']:.4f} ms, device route {res['device_ms']:.4f} "
            f"ms (K1 alone, cold: {res['k1_ms'] * 1e3:.3f} us)")
    return out


# -- phase 3 -----------------------------------------------------------------


def write_volume(path: str, nbytes: int, seed: int):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        left = nbytes
        while left:
            take = min(64 * MIB, left)
            f.write(rng.bytes(take))
            left -= take


def read_chunk(f, off: int, n: int) -> np.ndarray:
    f.seek(off)
    buf = np.zeros(n, dtype=np.uint8)
    f.readinto(memoryview(buf))  # zeros past EOF: the format's padding
    return buf


def verify_encode(base: str, crcs: list[int], dev) -> None:
    """Data shards equal the .dat striping; parity equals the plain GF
    apply on the card; every shard-file CRC equals the plain CRC on the
    card, chunk by chunk, finalized and chained; three chunks also agree
    with the host crc32c."""
    par = np.ascontiguousarray(parity_matrix(10, 14))
    shard_size = os.path.getsize(base + to_ext(0))
    rows = shard_size // CHUNK
    files = [open(base + to_ext(i), "rb") for i in range(14)]
    rolling = [0] * 14
    host_checked = 0
    try:
        with open(base + ".dat", "rb") as dat:
            for r in range(rows):
                stripe = read_chunk(dat, r * 10 * CHUNK, 10 * CHUNK)
                shards = np.stack([read_chunk(f, r * CHUNK, CHUNK)
                                   for f in files])
                check(np.array_equal(shards[:10], stripe.reshape(10, CHUNK)),
                      f"data shards differ from the .dat at row {r}")
                x = torch.from_numpy(shards).to(dev)
                want = rs_cuda.gf_apply_plain(par, x[:10])
                check(torch.equal(want, x[10:]), f"parity differs at row {r}")
                fin = finalize(batched_crc32c_raw(x), CHUNK)
                for s in range(14):
                    rolling[s] = crc_host.crc32c_combine(rolling[s],
                                                         int(fin[s]), CHUNK)
                if r in (0, rows // 2, rows - 1):
                    for s in (0, 9, 13):
                        check(int(fin[s]) == crc_host.crc32c(shards[s]),
                              f"plain CRC differs from host crc32c at "
                              f"row {r} shard {s}")
                        host_checked += 1
    finally:
        for f in files:
            f.close()
    check(rolling == [int(c) for c in crcs],
          "returned shard CRCs differ from the plain CRC of the files")
    log(f"encode verified: {rows} rows, 14 CRCs, {host_checked} chunks "
        "against the host crc32c")


def same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(16 * MIB), fb.read(16 * MIB)
            if x != y:
                return False
            if not x:
                return True


def rebuild_pattern(base: str, lost: list[int], crcs: list[int], dev) -> float:
    for sid in lost:
        os.replace(base + to_ext(sid), base + to_ext(sid) + ".orig")
    t0 = time.perf_counter()
    got = encoder.rebuild_ec_files(base, device=dev)
    secs = time.perf_counter() - t0
    check(sorted(got) == sorted(lost), f"rebuild returned {sorted(got)}")
    for sid in lost:
        check(same_file(base + to_ext(sid), base + to_ext(sid) + ".orig"),
              f"rebuilt shard {sid} differs")
        check(got[sid] == crcs[sid], f"rebuilt shard {sid} CRC differs")
        os.unlink(base + to_ext(sid) + ".orig")
    return secs


def reconstruct_phase(base: str, dev) -> int:
    """Rebuild .ec03's content through reconstruct_span in 1 MiB spans and
    through the Encoder seam, comparing bytes."""
    target = 3
    survivors = [0, 1, 2, 4, 5, 6, 7, 8, 9, 10]
    files = {i: open(base + to_ext(i), "rb") for i in survivors + [target]}
    enc = new_encoder(10, 4, backend="cuda")
    spans = os.path.getsize(base + to_ext(target)) // CHUNK
    try:
        for k in range(spans):
            inputs = np.stack([read_chunk(files[i], k * CHUNK, CHUNK)
                               for i in survivors])
            want = read_chunk(files[target], k * CHUNK, CHUNK)
            got = reconstruct_span(survivors, inputs, target, device=dev)
            check(np.array_equal(got, want), f"reconstruct_span span {k}")
            shards = [None] * 14
            for i, s in zip(survivors, inputs):
                shards[i] = s
            full = enc.reconstruct(shards)
            check(np.array_equal(full[target], want),
                  f"Encoder.reconstruct span {k}")
    finally:
        for f in files.values():
            f.close()
    return spans


def main_path(dev, workdir: str) -> dict:
    """Phase 3 on a raw .dat; returns the kernels' launches in it."""
    base = os.path.join(workdir, "1")
    t0 = time.perf_counter()
    write_volume(base + ".dat", VOLUME_BYTES, SEED)
    log(f"wrote a seeded {VOLUME_BYTES} B volume in "
        f"{time.perf_counter() - t0:.2f} s")
    gib = VOLUME_BYTES / (1 << 30)
    rs_cuda.reset_launches()
    stats: dict = {}
    t0 = time.perf_counter()
    crcs = encoder.write_ec_files(base, stage_stats=stats, device=dev)
    enc_s = time.perf_counter() - t0
    launches_encode = dict(rs_cuda.launches)
    rebuild_s = {}
    for lost in ([0], [10, 11, 12, 13], [0, 5, 11, 13]):
        rebuild_s[str(lost)] = rebuild_pattern(base, lost, crcs, dev)
    spans = reconstruct_phase(base, dev)
    launches = dict(rs_cuda.launches)
    log(f"encode: {enc_s:.3f} s, {gib / enc_s:.3f} GiB/s of .dat bytes")
    log("encode stage_stats: " + json.dumps(stats, sort_keys=True))
    for k, s in rebuild_s.items():
        log(f"rebuild {k}: {s:.3f} s, {gib / s:.3f} GiB/s of .dat bytes")
    log(f"reconstructed .ec03 in {spans} spans, both routes byte-identical")
    log(f"launches on the main path: {launches} "
        f"(encode alone: {launches_encode})")
    # the checks read the files back; they run after the counted phases
    verify_encode(base, crcs, dev)
    for name in os.listdir(workdir):
        os.unlink(os.path.join(workdir, name))
    return launches


# -- phase 4 -----------------------------------------------------------------


def write_needle_volume(workdir: str, nbytes: int, seed: int) -> dict:
    """Needles through Volume.write_needle until `nbytes` of data: sizes
    log-uniform in [NEEDLE_MIN, NEEDLE_MAX], random names and cookies,
    ascending sparse ids.  Returns {id: (cookie, data)}."""
    rng = np.random.default_rng(seed)
    vol = Volume(workdir, "", 1)
    written = {}
    total, nid = 0, 0
    lo, hi = np.log(NEEDLE_MIN), np.log(NEEDLE_MAX)
    while total < nbytes:
        nid += int(rng.integers(1, 1000))
        size = int(np.exp(rng.uniform(lo, hi)))
        n = Needle.create(rng.bytes(size),
                          name=f"obj-{rng.bytes(6).hex()}.jpg".encode(),
                          mime=b"image/jpeg")
        n.id, n.cookie = nid, int(rng.integers(1, 1 << 32))
        vol.write_needle(n)
        written[nid] = (n.cookie, n.data)
        total += size
    vol.close()
    return written


def mount(workdir: str, dev) -> EcVolume:
    ev = EcVolume(workdir, "", 1, device=dev)
    for sid in range(14):
        if sid not in LOST:
            ev.add_shard(EcVolumeShard(workdir, "", 1, sid))
    return ev


def read_pass(ev, written: dict, ids: list, lat: dict = None) -> int:
    """Read each needle of `ids` through `ev` and check it; with `lat`,
    record each read's seconds under lat[id]."""
    for nid in ids:
        cookie, data = written[nid]
        t0 = time.perf_counter()
        n = ev.read_needle(nid, cookie=cookie)  # read_bytes checks the CRC
        if lat is not None:
            lat[nid] = time.perf_counter() - t0
        check(n.data == data and n.cookie == cookie,
              f"needle {nid:x} read back differs")
    return len(ids)


def pct_ms(secs: list, q: float) -> float:
    return float(np.percentile(secs, q)) * 1e3 if secs else float("nan")


def needle_phase(dev, workdir: str) -> dict:
    """Phase 4; returns the kernels' launches in it."""
    check(native.lib() is not None,
          "the native host library did not build: the needle CRCs of a "
          "1 GiB volume need it")
    base = os.path.join(workdir, "1")
    rs_cuda.reset_launches()
    t0 = time.perf_counter()
    written = write_needle_volume(workdir, NEEDLE_VOLUME_BYTES, SEED + 4)
    write_s = time.perf_counter() - t0
    dat_bytes = os.path.getsize(base + ".dat")
    log(f"needle volume: {len(written)} needles, {dat_bytes} B of .dat, "
        f"written in {write_s:.3f} s")

    stats: dict = {}
    t0 = time.perf_counter()
    crcs = encoder.write_ec_files(base, stage_stats=stats, device=dev)
    enc_s = time.perf_counter() - t0
    encoder.write_sorted_file_from_idx(base)
    encoder.save_volume_info(base, version=3, extra={"shard_crc32c": crcs})
    log(f"needle volume encode: {enc_s:.3f} s, "
        f"{dat_bytes / enc_s / (1 << 30):.3f} GiB/s of .dat bytes "
        f"(+ .ecx and .vif in {time.perf_counter() - t0 - enc_s:.3f} s)")
    log("needle volume encode stage_stats: " + json.dumps(stats,
                                                          sort_keys=True))
    for sid in LOST:
        os.replace(base + to_ext(sid), base + to_ext(sid) + ".lost")

    # pass 1: one reader, default knobs (256 KiB blocks, 64 MiB cache)
    ev = mount(workdir, dev)
    behind = {nid for nid in written
              if any(iv.to_shard_id_and_offset(
                  ev.large_block_size, ev.small_block_size)[0] in LOST
                  for iv in ev.locate_needle(nid)[2])}
    recover.STATS.reset()
    k1_before = rs_cuda.launches["gf_apply"]
    lat: dict = {}
    t0 = time.perf_counter()
    read_pass(ev, written, sorted(written), lat)
    pass1_s = time.perf_counter() - t0
    k1 = rs_cuda.launches["gf_apply"] - k1_before
    st1 = ev.recover_stats()
    ev.close()
    lost_lat = [lat[i] for i in behind]
    ok_lat = [lat[i] for i in written if i not in behind]
    log(f"pass 1 (1 reader): {len(written)} needles read in {pass1_s:.3f} s, "
        f"{len(behind)} behind a lost shard; recovered blocks "
        f"{st1['cache_misses']}, K1 launches {k1}, batches "
        f"{st1['batches']}, batched_spans {st1['batched_spans']}, cache "
        f"hits {st1['cache_hits']} misses {st1['cache_misses']}")
    log(f"pass 1 read latency ms: behind a lost shard p50 "
        f"{pct_ms(lost_lat, 50):.4f} p99 {pct_ms(lost_lat, 99):.4f}; intact "
        f"p50 {pct_ms(ok_lat, 50):.4f} p99 {pct_ms(ok_lat, 99):.4f}")
    log(f"pass 1 stage seconds: fetch {st1['fetch_seconds']} decode "
        f"{st1['decode_seconds']} serve {st1['serve_seconds']}")
    check(len(behind) > 0, "no needle sits behind a lost shard")
    check(k1 > 0 and k1 == st1["batches"],
          f"pass 1: {k1} K1 launches for {st1['batches']} decode batches")

    # pass 2: READERS threads over a fresh mount, each on its own stretch
    # of the volume, so that decodes of one lost shard stack
    ev = mount(workdir, dev)
    recover.STATS.reset()
    k1_before = rs_cuda.launches["gf_apply"]
    ids = sorted(written)
    chunks = [ids[k * len(ids) // READERS:(k + 1) * len(ids) // READERS]
              for k in range(READERS)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(READERS) as pool:
        counts = [f.result() for f in [pool.submit(read_pass, ev, written, c)
                                       for c in chunks]]
    pass2_s = time.perf_counter() - t0
    k1_2 = rs_cuda.launches["gf_apply"] - k1_before
    st2 = ev.recover_stats()
    ev.close()
    widths = st2["recovered_bytes"] / max(1, st2["batches"]) / 10 / MIB
    log(f"pass 2 ({READERS} readers): {sum(counts)} needles in "
        f"{pass2_s:.3f} s; K1 launches {k1_2}, batches {st2['batches']}, "
        f"spans {st2['spans']}, batched_spans {st2['batched_spans']}, "
        f"coalesced {st2['coalesced']}, cache hits {st2['cache_hits']} "
        f"misses {st2['cache_misses']}, mean K1 input (10, "
        f"{widths:.3f} MiB)")
    check(sum(counts) == len(written), "pass 2 missed needles")
    check(k1_2 > 0 and k1_2 == st2["batches"],
          f"pass 2: {k1_2} K1 launches for {st2['batches']} decode batches")
    check(st2["batched_spans"] > 0, "pass 2 stacked no spans")

    # rebuild the lost shards (K2), then decode back to a volume
    t0 = time.perf_counter()
    rebuilt = encoder.rebuild_ec_files(base, device=dev)
    rebuild_s = time.perf_counter() - t0
    check(sorted(rebuilt) == sorted(LOST), f"rebuilt {sorted(rebuilt)}")
    for sid in LOST:
        check(rebuilt[sid] == crcs[sid], f"rebuilt shard {sid} CRC differs")
        check(same_file(base + to_ext(sid), base + to_ext(sid) + ".lost"),
              f"rebuilt shard {sid} differs")
    launches = dict(rs_cuda.launches)
    for ext in (".dat", ".idx"):
        os.replace(base + ext, base + ext + ".orig")
    t0 = time.perf_counter()
    decoder.write_dat_file(base, decoder.find_dat_file_size(base, base))
    decoder.write_idx_file_from_ec_index(base)
    decode_s = time.perf_counter() - t0
    for ext in (".dat", ".idx"):
        check(same_file(base + ext, base + ext + ".orig"),
              f"decoded {ext} differs from the volume's")
    log(f"rebuild {list(LOST)}: {rebuild_s:.3f} s; decode to .dat/.idx: "
        f"{decode_s:.3f} s; both byte-identical to the originals")
    log(f"launches on the needle path: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels; no main path")
    args = ap.parse_args()
    mode = "quick" if args.quick else "kernels" if args.kernels else "all"
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SOURCES)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    stats = kernel_phase(dev, mode)
    if mode != "quick":
        route_phase(dev)
    launches = {}
    if mode == "all":
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            raw = main_path(dev, workdir)
            needles = needle_phase(dev, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for name in KERNELS:
            check(raw.get(name, 0) > 0 and needles.get(name, 0) > 0,
                  f"{name} was not launched on both paths")
        launches = {name: raw[name] + needles[name] for name in KERNELS}
        rows = []
        for name, meta in KERNELS.items():
            s = stats[name]
            rows.append({
                "name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"], "launches": launches[name],
                "max_abs_err": s["max_abs_err"], "matched": True,
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "timing": "cold",
                "bound_share": s["bound_share"],
                "us": s["ms"] * 1e3, "plain_us": s["plain_ms"] * 1e3,
                "bound_us": s["bound_ms"] * 1e3,
            })
        print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
