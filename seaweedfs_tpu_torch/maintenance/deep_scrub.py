"""Deep scrub: re-encode and compare, not just re-hash.

Counterpart of seaweedfs_tpu/maintenance/deep_scrub.py.  The plain scrub
(storage.tools.verify_shard_files) re-hashes each .ecNN file against the
CRC the encode recorded: it catches bitrot inside a file but cannot tell
whether the parity still matches the data.  Deep scrub goes further:

 * every present shard file is streamed span by span (paced through an
   optional throttle) and its rolling CRC32C chained exactly like the
   whole-file CRC, so the bitrot check rides along on the same reads;
   a batch's 14 shards are read by as many tasks on a pool of threads
   into leased pinned staging (straight into it where the target's
   shards are all on this server's disk);
 * the 14 shard spans of a batch go to the card as one (18, B, L) slab
   (spans of different volumes share one geometry); the pooled parity
   step (parallel/mesh.make_parity_step, K1 on the card) writes the
   parity recomputed from the ten data spans into its last four rows,
   and one K8 launch (ops/rs_cuda.crc32c_rows) takes the raw CRC32C
   image of all 18 rows; only those images come back, and the host
   finalizes them and chains them in offset order into the shards' file
   CRCs and the recomputed parity's CRCs, which are compared with the
   stored ones: that proves data and parity agree end to end;
 * `deep_scrub_host` walks the files' CRCs and the sorted .ecx, re-reading
   every live needle and verifying its own CRC.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import profiling, tracing
from ..ops import crc32c as crc_host
from ..qos import lanes as _lanes
from ..qos.classify import BACKGROUND, qos_scope
from ..rpc.http_rpc import in_caller_context
from ..stats import metrics as _stats
from ..storage.erasure_coding import (DATA_SHARDS_COUNT,
                                      PARITY_SHARDS_COUNT,
                                      TOTAL_SHARDS_COUNT, to_ext)
from ..util.platform import available_cpu_count


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def span_bytes_default() -> int:
    """WEED_MAINT_SPAN_KB: the deep-scrub span (device chunk) size."""
    return max(4096, _env_int("WEED_MAINT_SPAN_KB", 1024) << 10)


def _inflight() -> int:
    return max(1, _env_int("WEED_EC_DEVICE_INFLIGHT", 3))


@dataclass
class ScrubTarget:
    """One EC volume to deep-scrub.  `reader(shard, offset, size)` returns
    up to `size` bytes of that shard; a short return means EOF, an
    exception that the shard is unreachable.  A target whose shards are
    all on this server's disk may also give `read_into(shard, offset,
    view)`, which fills the writable 1-D uint8 `view` from that offset
    and returns the bytes filled, with the same meaning of a short return
    and of an exception: the read stage then fills its stage rows in
    place, with no `bytes` between."""

    volume: int
    collection: str
    stored: list            # 14 recorded CRC32Cs from the .vif
    sizes: list             # per-shard byte length; -1 when absent
    reader: Callable[[int, int, int], bytes]
    close: Optional[Callable[[], None]] = None
    read_into: Optional[Callable[[int, int, np.ndarray], int]] = None
    # run-time state
    chains: list = field(default_factory=list)
    computed: list = field(default_factory=list)
    recompute: bool = True
    unreadable: set = field(default_factory=set)
    bytes_read: int = 0

    def __post_init__(self):
        self.chains = [0] * TOTAL_SHARDS_COUNT
        self.computed = [0] * PARITY_SHARDS_COUNT
        # the recompute needs every data shard; file CRCs cover the rest
        self.recompute = all(
            self.sizes[i] >= 0 for i in range(DATA_SHARDS_COUNT))

    @property
    def shard_len(self) -> int:
        return max([s for s in self.sizes if s >= 0] or [0])


def local_target(base: str, volume: int = 0,
                 collection: str = "") -> ScrubTarget:
    """A ScrubTarget over local .ecNN files."""
    from ..storage.erasure_coding.ec_volume import pread_into
    from ..storage.erasure_coding.encoder import load_volume_info

    info = load_volume_info(base) or {}
    stored = info.get("shard_crc32c")
    if not isinstance(stored, list) or len(stored) != TOTAL_SHARDS_COUNT:
        raise ValueError(f"{base}.vif has no shard_crc32c record")
    sizes = []
    for sid in range(TOTAL_SHARDS_COUNT):
        path = base + to_ext(sid)
        sizes.append(os.path.getsize(path) if os.path.exists(path) else -1)
    fds: dict[int, int] = {}

    def fd_of(sid: int) -> int:
        fd = fds.get(sid)
        if fd is None:
            fd = fds[sid] = os.open(base + to_ext(sid), os.O_RDONLY)
        return fd

    def reader(sid: int, offset: int, size: int) -> bytes:
        return os.pread(fd_of(sid), size, offset)

    def read_into(sid: int, offset: int, view: np.ndarray) -> int:
        return pread_into(fd_of(sid), view, offset)

    def close():
        for fd in fds.values():
            os.close(fd)
        fds.clear()

    return ScrubTarget(volume=volume, collection=collection,
                       stored=list(stored), sizes=sizes,
                       reader=reader, close=close, read_into=read_into)


def _read_span(t: ScrubTarget, sid: int, off: int, chunk: int,
               throttle, timers: dict) -> bytes:
    """One paced span read; its time goes to `timers` "pread" (the reader;
    the throttle's pacing to nothing).  A reader that fails marks the
    shard unreadable (and, for a data shard, stops the recompute): that
    is the verdict, not an error of the scrub.  The caller chains the
    span into the shard's file CRC and counts its bytes into
    `t.bytes_read`."""
    want = min(chunk, max(0, t.sizes[sid] - off))
    if want <= 0:
        return b""
    t0 = time.perf_counter()
    try:
        raw = t.reader(sid, off, want)
    except Exception:
        timers["pread"] += time.perf_counter() - t0
        t.unreadable.add(sid)
        if sid < DATA_SHARDS_COUNT:
            t.recompute = False
        return b""
    timers["pread"] += time.perf_counter() - t0
    if raw and throttle is not None:
        throttle(len(raw))
    return raw


def _fill_span(t: ScrubTarget, sid: int, off: int, row: np.ndarray,
               throttle, timers: dict) -> int:
    """`_read_span` through the target's `read_into`: the span is read
    straight into its stage row, and the bytes filled are returned."""
    want = min(len(row), max(0, t.sizes[sid] - off))
    if want <= 0:
        return 0
    t0 = time.perf_counter()
    try:
        n = t.read_into(sid, off, row[:want])
    except Exception:
        timers["pread"] += time.perf_counter() - t0
        t.unreadable.add(sid)
        if sid < DATA_SHARDS_COUNT:
            t.recompute = False
        return 0
    timers["pread"] += time.perf_counter() - t0
    if n and throttle is not None:
        throttle(n)
    return n


def _read_shard(targets: list, metas: list, sid: int, chunk: int,
                throttle, buf: np.ndarray, lens: np.ndarray) -> tuple:
    """One task of a batch's read stage: shard `sid`'s span of every unit
    in `metas` into its stage row, whose tail past the bytes read is
    zeroed, with the bytes read in `lens[sid, k]` (every span, also of a
    target that stopped recomputing: its file CRC needs it).  A target
    with `read_into` fills the row in place; any other's span comes as
    `bytes` and is copied in.  The stage `buf` is (devices, 14, per, L),
    each device's rows one block, so unit k's row is `buf[k // per, sid,
    k % per]`.  Returns (the task's seconds, its leaf timers, {target
    index: bytes read}): the caller adds them up, so no two tasks write
    one counter."""
    t0 = time.perf_counter()
    timers = dict.fromkeys(READ_LEAVES, 0.0)
    got: dict = {}
    per = buf.shape[2]
    for k, (ti, off) in enumerate(metas):
        if targets[ti].read_into is not None:
            row = buf[k // per, sid, k % per]
            n = _fill_span(targets[ti], sid, off, row, throttle, timers)
            got[ti] = got.get(ti, 0) + n
            lens[sid, k] = n
            c1 = time.perf_counter()
            if n < chunk:
                row[n:] = 0
            timers["stage_fill"] += time.perf_counter() - c1
            continue
        raw = _read_span(targets[ti], sid, off, chunk, throttle, timers)
        n = len(raw)
        got[ti] = got.get(ti, 0) + n
        lens[sid, k] = n
        row = buf[k // per, sid, k % per]
        c0 = time.perf_counter()
        if n:
            row[:n] = np.frombuffer(raw, dtype=np.uint8)
        c1 = time.perf_counter()
        if n < chunk:
            row[n:] = 0
        timers["stage_copy"] += c1 - c0
        timers["stage_fill"] += time.perf_counter() - c1
    return time.perf_counter() - t0, timers, got


def _chain_span(crc: int, raw: int, n: int, chunk: int) -> int:
    """crc32c(A || M) from crc = crc32c(A) and K8's raw image of M's
    staged row, M || 0^(chunk - n): the zero tail undone (an invertible
    advance), the image finalized with M's length and combined.  The
    advances are table-driven, cached per length."""
    if n < chunk:
        raw = crc_host.unadvance_by(chunk - n)(raw)
    return crc_host.advance_by(n)(crc) ^ raw ^ crc_host.crc32c_zeros(n)


def _parity_lengths(t: ScrubTarget, off: int, chunk: int) -> list:
    """The bytes of each recomputed parity row of the span at `off` that
    its parity file's CRC covers: up to the file's size, or the longest
    shard's where the file is missing."""
    out = []
    for j in range(PARITY_SHARDS_COUNT):
        psize = t.sizes[DATA_SHARDS_COUNT + j]
        if psize < 0:
            psize = t.shard_len
        out.append(min(chunk, max(0, psize - off)))
    return out


def _verdict(t: ScrubTarget) -> dict:
    missing = [s for s in range(TOTAL_SHARDS_COUNT) if t.sizes[s] < 0]
    corrupt = [s for s in range(TOTAL_SHARDS_COUNT)
               if t.sizes[s] >= 0 and s not in t.unreadable
               and t.chains[s] != t.stored[s]]
    parity_mismatch = []
    if t.recompute and not any(s < DATA_SHARDS_COUNT for s in corrupt):
        # the data is bit-identical to what was encoded, so a recompute
        # mismatch means the stored parity record disagrees with the data
        for j in range(PARITY_SHARDS_COUNT):
            sid = DATA_SHARDS_COUNT + j
            if t.computed[j] != t.stored[sid] and sid not in corrupt:
                parity_mismatch.append(sid)
    return {"volume": t.volume, "collection": t.collection,
            "corrupt": corrupt, "missing": missing,
            "unreadable": sorted(t.unreadable),
            "parity_mismatch": parity_mismatch,
            "recomputed": t.recompute,
            "bytes": t.bytes_read,
            "ok": not (corrupt or missing or t.unreadable
                       or parity_mismatch)}


# a batch's device slab: the 14 shard spans, then the parity rows that K1
# recomputes from the first ten
SLAB_ROWS = TOTAL_SHARDS_COUNT + PARITY_SHARDS_COUNT

# the leaf stage timers under `read` and under `encode_crc`
READ_LEAVES = ("pread", "stage_fill", "stage_copy")
COMPLETE_LEAVES = ("parity_wait", "span_crc", "parity_crc")
# the event-timed intervals of each batch on the card
DEVICE_STAGES = ("h2d", "kernel", "d2h")


def _record(timers: dict, **seconds) -> dict:
    """Add each measured interval to the call's `timers`; returns them as
    the tags of the batch span they belong to."""
    for k, v in seconds.items():
        timers[k] += v
    return {k: round(v, 6) for k, v in seconds.items()}


def deep_scrub(targets: list, device=None, span_bytes: Optional[int] = None,
               batch_units: Optional[int] = None, throttle=None,
               stage_stats: Optional[dict] = None) -> dict:
    """Deep-scrub `targets`, batching recompute spans across volumes into
    one device geometry on `device` (one device or a list; None means
    every CUDA card, raising without one).  Returns {"volumes":
    [per-target verdicts], "scrubbed_bytes", "corrupt", "backend"}.

    Each batch's read stage is 14 tasks, one per shard, each reading that
    shard's spans of the batch into the pinned stage; they run on a pool
    of threads made for the call, half the cores this process may use (at
    most 14), or inline where that is one.  The throttle is called from
    those threads, so a scrub paced below one thread's speed (the
    maintenance worker's, at its default rate) gains nothing from the
    pool.  The CRC32C of every span of a recompute batch, and of its
    recomputed parity, is taken on the device (K8); the file-CRC sweep of
    targets that cannot recompute stays inline, on the host.

    `stage_stats` receives seconds per stage: `read` (the caller's wait
    from taking a staging entry to the batch's last task done), of which
    the leaves `pread`, `stage_fill` (zeroing the rows' tails) and
    `stage_copy` (copying `bytes` spans into their rows) are
    worker-seconds summed over the tasks, as is `read_busy` (the tasks'
    own seconds; `read_busy / read` is the mean number of busy workers);
    `read_workers`, the pool size used (1 when nothing ran on a pool);
    `lane_wait`, `dispatch`, `encode_crc` (of
    which `parity_wait`, and `span_crc` and `parity_crc`: finalizing and
    chaining the shard spans' and the recomputed parity's CRC images on
    the caller's thread; in the inline sweep `span_crc` is its host CRC),
    `setup` and `finish`, the call's `wall`, and on the card the
    event-timed `device_h2d`, `device_kernel` (the step and K8) and
    `device_d2h` (the images), also added to the process's totals
    (profiling.record_scrub_batch); and the counts `crc_card_bytes`
    (shard and recomputed parity bytes whose CRC the device took),
    `crc_host_bytes` (bytes the host CRC'd), `read_direct_bytes` (span
    bytes a target's `read_into` filled into the stage in place) and
    `read_copied_bytes` (span bytes staged through a reader's `bytes`).
    The call is a `maint.deep_scrub` span (background, tagged with
    `read_workers` and the four counts) with `scrub.batch.read` (tagged
    with its leaves in worker-seconds), `.dispatch` and `.complete`
    children per batch; a reader's peer fetches (`ec.peer_read`) hang
    under their batch's read span.  The call runs in the background QoS
    class."""
    root = tracing.start("maint.deep_scrub",
                         tags={"volumes": len(targets)})
    tracing.tag_qos(root, BACKGROUND)
    children: list = []
    prev = tracing.swap(root)
    try:
        # background work whoever calls it: a peer fetch is counted and
        # admitted downstream as such
        with qos_scope(BACKGROUND):
            out = _scrub(targets, device, span_bytes, batch_units,
                         throttle, stage_stats, root, children)
    finally:
        tracing.restore(prev)
    tracing.finish_tree(root, children)
    return out


def _scrub(targets: list, device, span_bytes: Optional[int],
           batch_units: Optional[int], throttle, stage_stats: Optional[dict],
           root, children: list) -> dict:
    """deep_scrub's sweep, under its span `root`; each batch's spans go to
    `children`."""
    from ..ops.device_pool import get_pool, lease_tensor
    from ..ops.rs_cuda import crc32c_rows
    from ..parallel.mesh import make_ec_mesh, make_parity_step

    wall0 = time.perf_counter_ns()
    devices = make_ec_mesh(device)
    cuda = devices[0].type == "cuda"
    timers = dict.fromkeys(("read", "read_busy", "dispatch", "encode_crc",
                            "lane_wait", "setup", "finish") + READ_LEAVES
                           + COMPLETE_LEAVES
                           + (tuple("device_" + k for k in DEVICE_STAGES)
                              if cuda else ()), 0.0)
    counts = dict.fromkeys(("crc_card_bytes", "crc_host_bytes",
                            "read_direct_bytes", "read_copied_bytes"), 0)

    chunk = span_bytes or span_bytes_default()
    max_len = max([t.shard_len for t in targets] or [0])
    # no point padding spans past the largest shard; keep words whole
    if max_len > 0:
        chunk = min(chunk, max_len + (-max_len) % 4)
    chunk = max(4096, chunk - chunk % 4)

    # units: (target index, offset) spans of recompute-capable targets;
    # file-CRC-only targets stream without device dispatch
    units: list[tuple[int, int]] = []
    for ti, t in enumerate(targets):
        if t.recompute and t.shard_len > 0:
            units.extend((ti, off) for off in range(0, t.shard_len, chunk))

    backend = "host-crc32c"
    batches = 0
    b = 0
    depth = _inflight()
    pool_stats = None
    workers = 1
    if units:
        # half the cores: past that the tasks gain little on the card
        # host and the runs swing with its other tenants, and a
        # background job leaves the rest to the foreground
        workers = max(1, min(TOTAL_SHARDS_COUNT, available_cpu_count() // 2))
        n_dev = len(devices)
        if batch_units is None:
            # ~32 MB of data spans per dispatch: at the default 1 MB span
            # three volumes' spans share a geometry
            batch_units = max(1, (32 << 20) // (DATA_SHARDS_COUNT * chunk))
        b = min(batch_units, len(units))
        b = max(n_dev, -(-b // n_dev) * n_dev)
        # the units split in order over the devices (mesh.split_batch):
        # unit k is row k % per of device k // per
        per = b // n_dev
        step = make_parity_step(devices)
        backend = "device-pooled"
        pool = get_pool()
        # the pool's byte counters label a batch over N devices "sharded:N"
        dev_label = f"sharded:{n_dev}" if n_dev > 1 else str(devices[0])
        pool_before = pool.snapshot()

        # ring entries: pinned staging of the 14 shard rows, each device's
        # one block (one H2D copy), and the bytes read into each; a
        # per-device (18, per, L) slab and its CRC images; the pinned
        # images; each card's timing events (the CPU's batches are not
        # event-timed); an entry is refilled only after its batch was
        # synchronized
        streams = [torch.cuda.current_stream(d) for d in devices] \
            if cuda else []
        ring = []
        for _ in range(depth + 1):
            ring.append({
                "stage": lease_tensor(pool, "maint-stage",
                                      (n_dev, TOTAL_SHARDS_COUNT, per, chunk),
                                      torch.uint8, pinned=cuda),
                "lens": np.zeros((TOTAL_SHARDS_COUNT, b), dtype=np.int64),
                "slab": [lease_tensor(pool, "maint-slab",
                                      (SLAB_ROWS, per, chunk), torch.uint8, d)
                         for d in devices],
                "crc": [lease_tensor(pool, "maint-crc", (per, SLAB_ROWS),
                                     torch.int64, d) for d in devices],
                "himg": lease_tensor(pool, "maint-himg", (b, SLAB_ROWS),
                                     torch.int64, pinned=cuda),
                "marks": [[torch.cuda.Event(enable_timing=True)
                           for _ in range(len(DEVICE_STAGES) + 1)]
                          for _ in streams],
            })
        free = deque(ring)
        pending: deque = deque()  # (entry, metas)

        def _mark(entry, j):
            """Record the entry's j-th timing event on each card's stream."""
            for evs, stream in zip(entry["marks"], streams):
                evs[j].record(stream)

        def _complete():
            """Finalize the oldest batch's images and chain them, in the
            order of its units and so of each shard's offsets."""
            entry, metas = pending.popleft()
            t0 = time.perf_counter_ns()
            for evs in entry["marks"]:
                evs[-1].synchronize()
            t1 = time.perf_counter_ns()
            dev: dict = {}
            for evs in entry["marks"]:
                for k, e0, e1 in zip(DEVICE_STAGES, evs, evs[1:]):
                    dev[k] = dev.get(k, 0.0) + e0.elapsed_time(e1) * 1e-3
            profiling.record_scrub_batch(1, **dev)
            himg = entry["himg"].payload.numpy()
            pool.note_d2h(himg.nbytes, device=dev_label)
            images = himg.tolist()
            lens = entry["lens"].T.tolist()
            t2 = time.perf_counter_ns()
            for k, (ti, _) in enumerate(metas):
                t, img = targets[ti], images[k]
                for sid, n in enumerate(lens[k]):
                    if n:
                        t.chains[sid] = _chain_span(t.chains[sid], img[sid],
                                                    n, chunk)
                        counts["crc_card_bytes"] += n
            t3 = time.perf_counter_ns()
            for k, (ti, off) in enumerate(metas):
                t, img = targets[ti], images[k]
                if not t.recompute:
                    continue  # went unreadable mid-sweep: chain invalid
                for j, real in enumerate(_parity_lengths(t, off, chunk)):
                    if real > 0:
                        t.computed[j] = _chain_span(
                            t.computed[j], img[TOTAL_SHARDS_COUNT + j],
                            real, chunk)
                        counts["crc_card_bytes"] += real
            t4 = time.perf_counter_ns()
            free.append(entry)
            timers["encode_crc"] += (t4 - t0) * 1e-9
            tags = _record(timers, **{"device_" + k: v
                                      for k, v in dev.items()},
                           parity_wait=(t1 - t0) * 1e-9,
                           span_crc=(t3 - t2) * 1e-9,
                           parity_crc=(t4 - t3) * 1e-9)
            children.append(tracing.span_between(
                "scrub.batch.complete", t0, t4, root, tags))

        def _zero_parity_tails(lens, metas, par):
            """Where a unit's recomputed parity row runs on past its parity
            file's span (a parity file shorter than a data shard), zero that
            tail on the device, so the row's image is the span's followed by
            zeros, as for every other short row."""
            for k, (ti, off) in enumerate(metas):
                t = targets[ti]
                if not t.recompute:
                    continue
                longest = int(lens[:DATA_SHARDS_COUNT, k].max())
                for j, real in enumerate(_parity_lengths(t, off, chunk)):
                    if real < longest:
                        par[k // per][j, k % per, real:].zero_()

        def _dispatch(entry, metas):
            """The stage's H2D, the step, K8 and the images' D2H of one
            batch, each device's part on its current stream, with the
            entry's timing events recorded there before the H2D, after it,
            after K8 and after the D2H."""
            stage = entry["stage"].payload
            himg = entry["himg"].payload
            slabs = [ls.payload for ls in entry["slab"]]
            _mark(entry, 0)
            for i, slab in enumerate(slabs):
                slab[:TOTAL_SHARDS_COUNT].copy_(stage[i], non_blocking=True)
            _mark(entry, 1)
            pool.note_h2d(stage.numel(), device=dev_label)
            par = [s[TOTAL_SHARDS_COUNT:] for s in slabs]
            step([s[:DATA_SHARDS_COUNT] for s in slabs], par)
            _zero_parity_tails(entry["lens"], metas, par)
            for slab, crc in zip(slabs, entry["crc"]):
                crc32c_rows(slab.permute(1, 0, 2), out=crc.payload)
            _mark(entry, 2)
            for i, crc in enumerate(entry["crc"]):
                himg[i * per:(i + 1) * per].copy_(crc.payload,
                                                  non_blocking=True)
            _mark(entry, 3)

        timers["setup"] = (time.perf_counter_ns() - wall0) * 1e-9
        readers = cf.ThreadPoolExecutor(
            workers, thread_name_prefix="scrub-read") if workers > 1 \
            else None
        try:
            for start in range(0, len(units), b):
                metas = units[start:start + b]
                if not free:
                    _complete()
                entry = free.popleft()
                buf = entry["stage"].payload.numpy()
                args = [(targets, metas, sid, chunk, throttle, buf,
                         entry["lens"])
                        for sid in range(TOTAL_SHARDS_COUNT)]
                t0 = time.perf_counter_ns()
                # the batch's read span exists before its tasks, so that
                # a peer fetch (ec.peer_read) hangs under it; a task
                # keeps the caller's budget, class and trace
                read_span = tracing.span_between("scrub.batch.read", t0,
                                                 t0, root)
                task = in_caller_context(_read_shard, read_span)
                if readers is None:
                    done = [task(*a) for a in args]
                else:
                    done = [f.result() for f in
                            [readers.submit(task, *a) for a in args]]
                t1 = time.perf_counter_ns()
                leaves = dict.fromkeys(READ_LEAVES, 0.0)
                for busy, got, nbytes in done:
                    timers["read_busy"] += busy
                    for k, v in got.items():
                        leaves[k] += v
                    for ti, n in nbytes.items():
                        targets[ti].bytes_read += n
                        counts["read_copied_bytes" if targets[ti].read_into
                               is None else "read_direct_bytes"] += n
                read_span.duration = (t1 - t0) * 1e-9
                timers["read"] += read_span.duration
                read_span.tags = _record(timers, **leaves)
                children.append(read_span)
                # background lane: yield to in-flight foreground decodes
                timers["lane_wait"] += _lanes.LANES.background_checkpoint()
                t2 = time.perf_counter_ns()
                _dispatch(entry, metas)
                t3 = time.perf_counter_ns()
                timers["dispatch"] += (t3 - t2) * 1e-9
                children.append(tracing.span_between(
                    "scrub.batch.dispatch", t2, t3, root))
                pending.append((entry, metas))
                batches += 1
                if len(pending) >= depth:
                    _complete()
            while pending:
                _complete()
        finally:
            t0 = time.perf_counter_ns()
            if readers is not None:
                # no task may still write a stage the pool gets back
                readers.shutdown(wait=True, cancel_futures=True)
            for stream in streams:
                stream.synchronize()
            for entry in ring:
                for ls in [entry["stage"], entry["himg"]] + entry["slab"] \
                        + entry["crc"]:
                    pool.release(ls)
            timers["finish"] += (time.perf_counter_ns() - t0) * 1e-9
        pool_after = pool.snapshot()
        pool_stats = {"allocs": pool_after.get("allocs", 0),
                      "lease_hits": (pool_after.get("lease_hits", 0)
                                     - pool_before.get("lease_hits", 0))}
    else:
        timers["setup"] = (time.perf_counter_ns() - wall0) * 1e-9

    # file-CRC-only sweep for targets without recompute units, on the host
    t0 = time.perf_counter_ns()
    for t in targets:
        if t.recompute and t.shard_len > 0:
            continue
        for sid in range(TOTAL_SHARDS_COUNT):
            off = 0
            while t.sizes[sid] >= 0 and off < t.sizes[sid]:
                raw = _read_span(t, sid, off, chunk, throttle, timers)
                if not raw:
                    break
                c0 = time.perf_counter()
                t.chains[sid] = crc_host.crc32c(raw, t.chains[sid])
                timers["span_crc"] += time.perf_counter() - c0
                counts["crc_host_bytes"] += len(raw)
                off += len(raw)
                t.bytes_read += len(raw)
    t1 = time.perf_counter_ns()
    # inline: one busy worker for the whole sweep
    timers["read"] += (t1 - t0) * 1e-9
    timers["read_busy"] += (t1 - t0) * 1e-9

    volumes = []
    for t in targets:
        volumes.append(_verdict(t))
        if t.close is not None:
            t.close()
    t_end = time.perf_counter_ns()
    timers["finish"] += (t_end - t1) * 1e-9
    wall = (t_end - wall0) * 1e-9
    # reported both in stage_stats and as tags of the root span
    summary = {"batches": batches, "backend": backend,
               "read_workers": workers, **counts}
    if stage_stats is not None:
        stage_stats.update({k: round(v, 6) for k, v in timers.items()})
        stage_stats.update(summary)
        stage_stats["wall"] = round(wall, 6)
        stage_stats["batch_units"] = b
        stage_stats["k_shapes"] = [DATA_SHARDS_COUNT] if units else []
        stage_stats["inflight"] = depth
        stage_stats["span_bytes"] = chunk
        for k in ("read", "dispatch", "encode_crc"):
            stage_stats[f"{k}_frac"] = (
                round(timers[k] / wall, 3) if wall > 0 else 0.0)
        if pool_stats is not None:
            stage_stats["pool"] = pool_stats
    total = sum(v["bytes"] for v in volumes)
    root.set_tag("bytes", total)
    for k, v in summary.items():
        root.set_tag(k, v)
    _stats.MaintScrubbedBytesCounter.inc(total)
    # a parity record that disagrees with the recompute is corruption too
    # (of the parity file or of the record): both kinds are reported
    return {"volumes": volumes, "scrubbed_bytes": total,
            "corrupt": [{"volume": v["volume"],
                         "shards": sorted(set(v["corrupt"])
                                          | set(v["parity_mismatch"]))}
                        for v in volumes
                        if v["corrupt"] or v["parity_mismatch"]],
            "backend": backend}


def deep_scrub_host(directory: str, collection: str, vid: int,
                    throttle=None, needle_walk: bool = True,
                    device=None) -> dict:
    """Host scrub: chunked, paced whole-file CRC verification plus a
    needle walk, in which every live needle of the sorted .ecx is read
    again and its own CRC verified (catching, at needle granularity,
    corruption the file CRC localises only to a shard).  The walk reads
    through an EcVolume on `device`, so a needle behind a missing shard
    is recovered there.  An inline-EC volume (a `.scl` commit log; its
    shard logs have no whole-file CRC record) goes to
    `verify_inline_volume` on `device`."""
    from ..storage import types as t
    from ..storage.erasure_coding.ec_volume import EcVolume, EcVolumeShard
    from ..storage.erasure_coding.encoder import load_volume_info
    from ..storage.tools import verify_shard_files

    base = (os.path.join(directory, f"{collection}_{vid}") if collection
            else os.path.join(directory, str(vid)))
    if os.path.exists(base + ".scl"):
        from ..storage.erasure_coding.inline import verify_inline_volume

        return verify_inline_volume(directory, collection, vid,
                                    device=device)
    info = load_volume_info(base) or {}
    stored = info.get("shard_crc32c")
    clean, corrupt, absent = verify_shard_files(base, stored,
                                                throttle=throttle)
    checked = bad = 0
    bad_needles: list[int] = []
    if needle_walk and os.path.exists(base + ".ecx"):
        from ..storage.erasure_coding.ec_volume import EcError
        from ..storage.needle import NeedleError

        ev = EcVolume(directory, collection, vid, device=device)
        try:
            for sid in range(TOTAL_SHARDS_COUNT):
                if os.path.exists(base + to_ext(sid)):
                    ev.add_shard(EcVolumeShard(directory, collection,
                                               vid, sid))
            n_entries = ev.ecx_file_size // t.NEEDLE_MAP_ENTRY_SIZE
            for pos in range(n_entries):
                nid, _, size = ev._read_ecx_entry(pos)
                if t.size_is_deleted(size):
                    continue
                checked += 1
                try:
                    ev.read_needle(nid)
                except (EcError, NeedleError):
                    # a needle that fails its own checks is the verdict;
                    # a failing launch still raises
                    bad += 1
                    if len(bad_needles) < 64:
                        bad_needles.append(nid)
        finally:
            ev.close()
    return {"volume": vid, "collection": collection,
            "clean": clean, "corrupt": corrupt, "missing": absent,
            "needles_checked": checked, "needles_bad": bad,
            "bad_needles": bad_needles,
            "ok": not (corrupt or bad)}
