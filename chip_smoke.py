"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # the whole run (one card)
    python3 chip_smoke.py --quick    # build and kernel checks only
    python3 chip_smoke.py --kernels  # build, kernel checks and timing
    python3 chip_smoke.py --routes   # build, kernel checks, decode routes
    python3 chip_smoke.py --inline   # build, kernel checks, phase 6 only
    python3 chip_smoke.py --cache    # build, kernel checks, phase 7 only
    python3 chip_smoke.py --server   # build, kernel checks, phase 8 only
    python3 chip_smoke.py --prefork  # build, kernel checks, phase 9 only
    python3 chip_smoke.py --cluster  # build, kernel checks, phase 10 only
    python3 chip_smoke.py --elastic  # build, kernel checks, phase 11 only
    python3 chip_smoke.py --filer    # build, kernel checks, phase 12 only
    python3 chip_smoke.py --s3       # build, kernel checks, phase 13 only

Phases:
  1. build the CUDA kernels from the checkout's sources (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, at ragged lengths and through misaligned
     pointers (tolerance 0: exact integer math), and time both with CUDA
     events, cold in L2 (`time_cold`); the same for the pooled parity
     step (parallel/mesh.make_parity_step, the JAX package's "K5" served
     by K1 and K2) in both forms at the encode shape and at compacted k,
     with the check that it writes into its leased slot and allocates
     nothing on the card in its steady state; time reconstruct_span's
     host route, its K1 route from a pageable and from a pinned stack,
     and its resident-slab hit at spans of 64 KiB to 4 MiB, in
     interleaved rounds that give each time's spread;
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
  5. the Store phase at real size: a Store over a temporary directory on
     the card (-ec.backend=cuda), four ~256 MiB volumes of seeded needles
     written through Store.write_needle, ec_generate_batch over all four,
     the first volume encoded again (pool lease hits), the volumes
     unmounted and remounted as EC with 4 shards of one lost, every needle
     of that volume read through Store.read_needle, ec_rebuild (verified
     against the .vif CRCs), deep_scrub of all four clean, then again
     with one parity byte flipped (exactly that shard reported), and the
     encode auto-selection's choice with the measured link;
  6. inline write-path EC on the card at real size, through the Store
     (the JAX package's inline defaults: RS(10,4) for collection `pics`,
     64 KiB stripe units, tail flush every 500 ms, WEED_EC_INLINE=1 and
     WEED_EC_INLINE_DEVICE=1): ~1 GiB of seeded needles through
     Store.write_needle from 4 writer threads while a reader reads acked
     needles back, drain; every parity log equal to the plain GF parity
     of the data logs on the card, the audit clean, K1 launches in the
     ingest window equal to the writer's device encodes (one pooled
     parity step call per commit batch), no pool allocation after the
     first batch; the volume closed, .ec01 and .ec11 deleted and healed
     by a remount through DiskLocation, every needle read; .ec00 .ec05
     .ec11 .ec13 lost and every needle read through the degraded ladder
     (K1 per recovered block); deep_scrub clean, then exactly the row of
     one flipped parity byte; the same for ~128 MiB of pm_msr (collection
     `cold`: 3 K1 launches per encode call), and 256 MiB with
     WEED_EC_INLINE_DEVICE=0 for the host codec's encode time per batch;
  7. the tiered read cache on the card in front of a degraded EC volume,
     the filer's chunk-cache path over warm storage: WEED_READ_CACHE_HBM_MB
     =1024 (the HBM tier: resident slabs of the device pool on the card),
     64 MiB of RAM, no disk layer; 384 seeded 4 MiB needles (1.5 GiB)
     through Store.write_needle, EC-encoded on the card (K2), .ec00 .ec05
     .ec11 .ec13 deleted, the volume remounted as EC; 8,000 gets from 4
     threads over a seeded Zipf(1.1) of the fids, each miss read through
     Store.read_needle (a degraded read, K1 per recovered block) and put,
     every chunk checked byte for byte; hits in both tiers, the HBM tier
     evicting and within its 1 GiB, the pool's held bytes of the tier equal
     to it, a background get admitting no fill, an overwritten needle
     served new from the HBM tier, no slab of the tier left after clear();
     RAM-hit, HBM-hit and miss latencies;
  8. the volume server over HTTP on the card: a VolumeServer
     (-ec.backend=cuda) whose master is a closed local port, so its
     heartbeats and EC location lookups fail with RpcError as they would
     behind a dead master (the lookup's 11 s error tier must spare each
     degraded read a connect); ~1 GiB of phase 4's seeded needles POSTed
     raw from 8 connections of a load process that imports neither torch
     nor the port (every ack's ETag = the needle's CRC32C), a sample GET
     intact, then the shell's ec.encode sequence on one holder
     (/admin/readonly, /admin/ec/generate on the card through K2,
     /admin/ec/mount of 14 shards, /admin/delete_volume), .ec00 .ec05
     .ec11 .ec13 dropped through /admin/ec/delete_shards, every needle
     GET from 8 connections behind the lost shards (bytes and CRC, K1
     launches = the decode batches of /admin/ec/recover_stats),
     /admin/ec/rebuild against the .vif CRCs, /admin/ec/scrub clean, and
     /metrics scraped and parsed strictly: the EcRecover* samples equal
     /admin/ec/recover_stats, the device-pool gauges the pool, the
     request counters the load process's own counts;
  9. the volume server with WEED_HTTP_WORKERS=4 and the TCP fast path,
     started in a fresh interpreter (the fork rule: no CUDA context
     before the group forks), each process decoding through its own K1;
 10. a cluster that heals itself: three masters in one raft group and
     three volume servers on the card (-ec.backend=cuda), each with its
     maintenance worker, all in this process; ~1 GiB of phase 4's needle
     mix assigned through the master client's fid leases, each fid's
     volume looked up, POSTed from the load process; the shell's
     ec.encode of every volume (K2 on the holder, 14 shards spread over
     the three); the raft leader stopped, a new one elected, heartbeats
     and assigns failing over; .ec00 .ec05 .ec11 .ec13 of one volume
     deleted, the new leader's curator queueing ec.rebuild through raft,
     every needle of the volume read through /ec/lookup while the job is
     pending (K1 = decode batches on each server), a worker leasing it
     and rebuilding through K2, the shards against their .vif CRCs; a
     forced deep.scrub clean through K5's K1 form, then one flipped byte
     of .ec12 reported and repaired by the ec.rebuild that follows;
     every job ok and leased once;
 11. a cluster of separate processes through a node death: three masters
     and five volume servers (-ec.backend=cuda), each started through the
     port's command line (python -m seaweedfs_tpu_torch); 256 MiB of the
     load generator's objects POSTed from load processes, the shell's
     ec.encode of every volume through the command line (K2; at most 4
     shards of a volume per server); open-loop traffic replayed by
     forked load processes that import no torch; the volume server
     holding the most shards SIGKILLed: the health plane's NODE_DOWN and
     availability ALERT_FIRE (within 10 s), the curator's repairs and
     scale.up, a sixth server through the command line, every volume at
     14 shards (K2), degraded GETs meanwhile (K1); the dead node
     restarted over its directory, ALERT_CLEAR and /cluster/health ok;
     no wrong byte, every acked write read back; in every server process
     K1 launches = decode batches + deep-scrub parity steps; forced deep
     scrubs clean (K1); degraded GETs from each server process; every
     shard file equal to its .vif CRC; top, lint-dashboards, cluster.scale
     and qos.status through the command line; nothing left after SIGTERM;
 12. a filer over warm EC storage, as separate processes of the port's
     command line: one master, three volume servers (-ec.backend=cuda)
     and one filer (-maxMB 4, a 1 GiB HBM tier for its chunk cache);
     fs.configure gives /warm/ the collection `warm` and the Cauchy code;
     ~1.1 GiB of seeded files POSTed through the filer from 8
     connections; volume.fsck clean; the shell's ec.encode of the
     collection (K2 with the Cauchy rows, every .vif naming cauchy);
     every file read whole, then .ec00 .ec05 .ec11 .ec13 of the largest
     volume dropped and every file read whole and by a Range (K1 = decode
     batches in every server process); Zipf(1.1) GETs and a sweep past
     the HBM tier (hits and evictions), single-chunk probes for HBM-hit
     and miss latencies, an overwrite read back new; fs.ls, fs.du, fs.cat
     and filer.cat through the command line; /metadata/subscribe holding
     every create; nothing left after SIGTERM;
 13. the S3 gateway and the IAM API over warm EC storage, as separate
     processes of the port's command line: one master, three volume
     servers (-ec.backend=cuda) and one `iam` process serving the IAM
     API, the S3 API and their embedded filer (a 1 GiB HBM tier for its
     chunk cache, found through the master's registry); keys made through
     the IAM API and taken by the gateway without a restart; bucket `warm`
     given its collection by fs.configure (RS(10,4)); 100 seeded 10 MiB
     objects PUT by SigV4-signing load processes that import no torch,
     every ETag the body's MD5; a 64 MiB multipart upload of 8 MiB parts
     and a streaming aws-chunked PUT; the shell's ec.encode (K2); every
     object read whole, then .ec00 .ec05 .ec11 .ec13 of the largest
     volume dropped and every object read whole and by a Range (K1);
     30 s of MinIO warp's mixed traffic (45% GET, 30% STAT, 15% PUT, 10%
     DELETE, 20 connections) on the degraded volumes, every acknowledged
     PUT read back and every deleted key 404; ListObjectsV2 by prefix and
     delimiter; a read-only key, an unknown key and a deleted key
     refused; s3.circuitbreaker's per-bucket limit answering 503
     SlowDown; single-chunk objects served from the HBM tier;
     filer.backup, filer.meta.backup and filer.sync through the command
     line, byte-identical; benchmark, upload and download; K1 = decode
     batches in every volume server process; nothing left after SIGTERM;
 14. one JSON line of per-kernel numbers, then the card's name and power
     limit, then the result line.

Phases 5 to 8 also hold the metrics registry's exposition against the
components' own counters (encode bytes, degraded-read mirrors and spans,
the device pool, deep scrub, inline EC, the read cache) and parse it
strictly.

Exits non-zero, printing no result, when there is no CUDA device or any
check fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import re
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from seaweedfs_tpu_torch import tracing
from seaweedfs_tpu_torch.cache import TieredReadCache
from seaweedfs_tpu_torch.maintenance.deep_scrub import (deep_scrub,
                                                        deep_scrub_host,
                                                        local_target)
from seaweedfs_tpu_torch.ops import _build, codec, gf256, native, rs_cuda
from seaweedfs_tpu_torch.ops import crc32c as crc_host
from seaweedfs_tpu_torch.ops.codec import new_encoder, reconstruct_span
from seaweedfs_tpu_torch.ops.crc_device import batched_crc32c_raw, finalize
from seaweedfs_tpu_torch.ops.device_pool import get_pool
from seaweedfs_tpu_torch.ops.gf256 import parity_matrix
from seaweedfs_tpu_torch.ops.rs_numpy import decode_rows
from seaweedfs_tpu_torch.parallel.mesh import (make_parity_step,
                                               parity_step_plain)
from seaweedfs_tpu_torch.qos import qos_scope
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage.erasure_coding import (decoder, encoder,
                                                        recover, to_ext)
from seaweedfs_tpu_torch.storage.erasure_coding import codes as ec_codes
from seaweedfs_tpu_torch.storage.erasure_coding import inline
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import (
    EcVolume, EcVolumeShard)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import platform

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
MIB = 1 << 20
VOLUME_BYTES = 256 * MIB    # phase 3's raw volume
NEEDLE_VOLUME_BYTES = 1 << 30  # phase 4: one ~1 GiB needle volume
STORE_VOLUMES = 4           # phase 5: four volumes of ~256 MiB of needles
STORE_VOLUME_BYTES = 256 * MIB
NEEDLE_MIN, NEEDLE_MAX = 1 << 10, 1 << 20  # log-uniform needle sizes
INLINE_BYTES = 1 << 30      # phase 6: ~1 GiB of needles, RS(10,4)
INLINE_MSR_BYTES = 128 * MIB   # phase 6: pm_msr
INLINE_HOST_BYTES = 256 * MIB  # phase 6: RS on the host codec
INLINE_WRITERS = 4          # writer threads of phase 6's ingest
MSR_LOST = (0, 2, 5, 13)    # pm_msr losses (its tolerance is 9)
LOST = (0, 5, 11, 13)       # two data and two parity shards
READERS = 8                 # threads of phase 4's concurrent pass
CACHE_NEEDLES = 384         # phase 7: 4 MiB chunks, 1.5 GiB in all
CACHE_CHUNK = 4 * MIB       # the filer's default chunk size
CACHE_GETS = 8000           # phase 7's gets, Zipf(CACHE_ZIPF) over the fids
CACHE_ZIPF = 1.1
CACHE_THREADS = 4
CACHE_HBM_MB = 1024         # WEED_READ_CACHE_HBM_MB of phase 7
CACHE_RAM_MB = 64           # WEED_READ_CACHE_MB of phase 7 (its default)
SERVER_BYTES = 1 << 30      # phase 8: ~1 GiB of needles over HTTP
SERVER_CONNS = 8            # connections of phase 8's load process
SERVER_SAMPLE = 1000        # needles of phase 8's intact GET sample
PREFORK_WORKERS = 4         # phase 9: WEED_HTTP_WORKERS (parent + 3)
PREFORK_EC_BYTES = 1 << 30  # phase 9: volume 1, EC with 4 shards lost
PREFORK_PUT_BYTES = 256 * MIB  # phase 9: PUTs into volume 2
PREFORK_DELETES = 50        # phase 9: needles deleted, then GET 404
PREFORK_RESPAWN_GETS = 400  # phase 9: degraded GETs on the respawned worker
PREFORK_TCP_READS = 1000    # phase 9: TCP reads, intact and degraded each
PREFORK_RECONNECT = 16      # requests per load connection before reopening
PREFORK_LOAD_PROCS = 4      # phase 9's split-client passes: load processes
CLUSTER_BYTES = 1 << 30     # phase 10: ~1 GiB of needles through assigns
CLUSTER_SIZE = 3            # phase 10: masters in the raft group, and servers
CLUSTER_LIMIT_MB = 1024     # the reference master's volume_size_limit_mb
CLUSTER_PULSE = 1.0         # heartbeat pulse of phase 10's masters and servers
# phase 10's maintenance knobs: poll and scan every second or less so the
# phase fits its time, the pacer's rate raised out of the scrub's way, no
# scrub queued by age (phase 10 forces its scrubs) and no balance moves
# (the failover's new volumes would skew the counts): the curator's jobs
# in the phase are the repairs it measures; a 5 s cooldown, since the
# availability alert's scrubs queue rebuilds that find nothing, and the
# default 60 s after them holds the real rebuild back (ROADMAP, open
# item 2)
CLUSTER_KNOBS = {"WEED_MAINT_POLL": "0.5", "WEED_MAINT_INTERVAL": "1",
                 "WEED_MAINT_RATE_MB": "65536",
                 "WEED_MAINT_SCRUB_INTERVAL": "1e12",
                 "WEED_MAINT_BALANCE_SKEW": "1000000",
                 "WEED_HEALTH_SCRAPE_MS": "500",
                 "WEED_MAINT_COOLDOWN": "5"}
ELASTIC_BYTES = 128 * MIB   # phase 11: the load generator's objects (cut
                            # from ~1 GiB, then 512 and 256 MiB, for the
                            # run's wall)
ELASTIC_SERVERS = 5         # phase 11: volume servers, one process each
ELASTIC_PULSE = 1.0         # heartbeat pulse of phase 11's processes
ELASTIC_LOADERS = 4         # phase 11's preload processes
ELASTIC_CONNS = 4           # connections of each preload process
ELASTIC_REPLAY_PROCS = 4    # loadgen.replay(processes=) of the traffic
ELASTIC_REPLAY_THREADS = 8  # threads of each replay process
ELASTIC_DURATION = 24       # seconds of open-loop traffic (WEED_LOAD_DURATION;
                            # cut from 36 for the run's wall: the kill comes
                            # at 8 s, the heal ~10-12 s after it)
ELASTIC_KILL_AFTER = 8      # seconds into the traffic the node dies
ELASTIC_READBACK = 1000     # preloaded objects read back after the heal
# phase 11's knobs: phase 10's maintenance knobs; the autoscaler on, with
# the health plane's alert as its trigger (the occupancy trigger and the
# drain off: the phase measures the scale-up the alert asks for); the
# health plane's scrape and burn windows compressed to the reference
# chaos test's (tests/test_health_plane.py), cuts for the run's time
ELASTIC_KNOBS = {**CLUSTER_KNOBS, "WEED_SCALE": "1",
                 "WEED_SCALE_ON_ALERT": "1", "WEED_SCALE_MIN_NODES": "5",
                 "WEED_SCALE_UP_OCC": "2", "WEED_SCALE_DRAIN_OCC": "0",
                 "WEED_HEALTH_SCRAPE_MS": "500", "WEED_SLO_FAST_S": "2",
                 "WEED_SLO_SLOW_S": "6", "WEED_LOAD_RATE": "200"}
FILER_BYTES = 1152 * MIB    # phase 12: files through the filer (> its 1 GiB
                            # HBM tier, so the sweep must evict)
FILER_MIN_FILE = 4 << 10    # phase 12's file sizes: log-uniform, 1 to 16
FILER_MAX_FILE = 64 * MIB   # chunks of the filer's 4 MiB (-maxMB 4)
FILER_SERVERS = 3           # phase 12's volume servers, one process each
FILER_CONNS = 8             # connections of phase 12's load processes
FILER_ZIPF_GETS = 400       # phase 12: GETs over a seeded Zipf(1.1) of files
FILER_PROBES = 48           # phase 12: single-chunk files probed one by one
FILER_ENCODE_PERCENT = 0.001  # ec.encode -fullPercent: every volume of the
                            # collection holding more than ~10 KiB
FILER_HBM_MB = 1024         # the filer's WEED_READ_CACHE_HBM_MB
FILER_RAM_MB = 64           # the filer's WEED_READ_CACHE_MB (its default)
# phase 12's knobs: no scrub by age and no balance moves (phase 10's), and
# the curator paused by the phase (the lost shards stay lost while the
# reads measure them)
FILER_KNOBS = {"WEED_MAINT_SCRUB_INTERVAL": "1e12",
               "WEED_MAINT_BALANCE_SKEW": "1000000"}
S3_SERVERS = 3              # phase 13's volume servers, one process each
S3_MAX_VOLUMES = 64         # their -max: the bucket, its re-grown volumes
                            # after the encode, and the second filer's
S3_OBJECTS = 100            # phase 13's preload: 100 objects of warp's
S3_OBJECT = 10 * MIB        # default 10 MiB (3 chunks of the filer's 4 MiB)
S3_LOADERS = 4              # load processes of phase 13 ...
S3_CONNS = 5                # ... of 5 connections each: warp's 20 clients
S3_MIX = {"GET": 45, "STAT": 30, "PUT": 15, "DELETE": 10}  # warp mixed
S3_MIX_S = 30               # seconds of the mix
S3_MULTIPART = 64 * MIB     # one multipart upload ...
S3_PART = 8 * MIB           # ... in the AWS CLI's default 8 MiB parts
S3_BURST = 12               # concurrent PUTs against the breaker's limit
S3_PROBE = 4 * MIB          # single-chunk objects for the HBM-tier probes
S3_PROBES = 8
S3_SYNC_LANES = 8           # filer.sync -concurrency: lanes by path hash
S3_BENCH_N = 2000           # `benchmark -n 2000 -size 1024 -c 8`
S3_HBM_MB = 1024            # the gateway's WEED_READ_CACHE_HBM_MB
S3_RAM_MB = 64              # the gateway's WEED_READ_CACHE_MB (its default)
CHUNK = MIB                 # the pipeline's column chunk for 1 MiB blocks
SEED = 20261016
PARITY = np.ascontiguousarray(parity_matrix(10, 14))
PHASE_NUMBERS: dict = {}    # each phase's end-to-end numbers, by phase
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


# -- the metrics exposition --------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>.*)\})? '
    r'(?P<value>-?(?:\d+\.?\d*(?:e[+-]?\d+)?|\+Inf|-Inf|NaN))$')
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"')


def _labels(raw) -> tuple:
    out, pos = [], 0
    while raw and pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        check(m is not None, f"exposition: bad label body {raw!r}")
        out.append((m.group("key"), m.group("val")))
        pos = m.end()
        if pos < len(raw):
            check(raw[pos] == ",", f"exposition: bad label separator {raw!r}")
            pos += 1
    return tuple(sorted(out))


def exposition(text: str = None) -> dict:
    """The port's whole exposition (or `text`, a scraped one), parsed
    strictly: HELP, then TYPE, then samples for every family, each sample
    line `name{labels} value`, and every histogram's buckets cumulative
    up to le="+Inf" = _count.  Returns {(sample name, labels): value}
    plus "_families"/"_lines"."""
    if text is None:
        text = metrics.REGISTRY.expose()
    check(text.endswith("\n"), "exposition: no final newline")
    out, kinds, family = {}, {}, None
    buckets: dict = {}
    lines = text.splitlines()
    for line in lines:
        if line.startswith("# HELP "):
            family = line.split(" ", 3)[2]
            check(family not in kinds, f"exposition: duplicate {family}")
            kinds[family] = None
        elif line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            check(name == family and kinds[name] is None and
                  kind in ("counter", "gauge", "histogram"),
                  f"exposition: bad TYPE line {line!r}")
            kinds[name] = kind
        else:
            m = _SAMPLE_RE.match(line)
            check(m is not None, f"exposition: bad sample line {line!r}")
            name = m.group("name")
            check(family is not None and kinds[family] is not None and
                  (name == family or name in (family + "_bucket",
                                              family + "_sum",
                                              family + "_count")),
                  f"exposition: sample {name} outside its family")
            labels = _labels(m.group("labels"))
            value = float(m.group("value").replace("+Inf", "inf"))
            out[(name, labels)] = value
            if name.endswith("_bucket"):
                series = tuple(kv for kv in labels if kv[0] != "le")
                buckets.setdefault((family, series), []).append(
                    (float(dict(labels)["le"].replace("+Inf", "inf")), value))
    for (family, series), bs in buckets.items():
        les, counts = [b[0] for b in bs], [b[1] for b in bs]
        check(les == sorted(les) and les[-1] == float("inf") and
              counts == sorted(counts) and
              out[(family + "_count", series)] == counts[-1],
              f"exposition: histogram {family}{series} not cumulative")
    out["_families"], out["_lines"] = len(kinds), len(lines)
    return out


def sample(expo: dict, name: str, **labels) -> float:
    return expo.get((name, tuple(sorted(labels.items()))), 0.0)


def sample_sum(expo: dict, name: str) -> float:
    return sum(v for k, v in expo.items()
               if isinstance(k, tuple) and k[0] == name)


def log_exposition(where: str) -> dict:
    expo = exposition()
    log(f"exposition after {where}: {expo['_families']} families, "
        f"{expo['_lines']} lines, parsed strictly (histograms cumulative)")
    return expo


def check_pool_gauges(pool, where: str, expo: dict = None):
    """The DevicePool gauges (of `expo`, else of the registry now) equal
    the pool's own snapshot."""
    snap = pool.snapshot()
    if expo is None:
        expo = exposition()
    p = "SeaweedFS_volumeServer_device_pool_"
    got = {"bytes": sample(expo, p + "bytes"),
           "hwm_bytes": sample(expo, p + "hwm_bytes"),
           "free_slots": sample(expo, p + "slots", state="free"),
           "leased_slots": sample(expo, p + "slots", state="leased"),
           "resident_slabs": sample(expo, p + "slots", state="resident")}
    want = {k: snap[k] for k in got}
    check(got == want, f"{where}: device pool gauges {got} != snapshot "
          f"{want}")


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


def compare_k8(data) -> int:
    got = rs_cuda.crc32c_rows(data)
    want = rs_cuda.crc32c_rows_plain(data.cpu())
    torch.cuda.synchronize()
    err = int((got.cpu() - want).abs().max())
    check(err == 0 and torch.equal(got.cpu(), want),
          f"crc32c_rows differs from plain at {tuple(data.shape)}")
    return err


def misaligned(rng, shape, offset: int, dev) -> torch.Tensor:
    """Seeded bytes of `shape` as a contiguous view that starts `offset`
    bytes into a fresh buffer, so its pointer is off a 16-byte boundary."""
    n = int(np.prod(shape))
    view = rand_bytes(rng, (n + offset,), dev)[offset:].view(shape)
    check(view.data_ptr() % 16 != 0, "view is 16-byte aligned")
    return view


def leased_slot(pool, shape, dev, offset: int = 0):
    """A (p, B, L) output slot leased from the DevicePool, as the pipeline
    leases its out-ring; offset > 0 starts the view off a 16-byte
    boundary.  Returns (lease, view)."""
    n = int(np.prod(shape))
    ls = pool.lease(("smoke-k5-out", n + offset),
                    lambda: torch.empty(n + offset, dtype=torch.uint8,
                                        device=dev), n + offset, device=dev)
    return ls, ls.payload[offset:offset + n].view(shape)


def compare_k5(step, fused: bool, data, ls, out) -> int:
    """The parity step against its plain version on the same inputs; the
    parity must land in the leased slot."""
    crc = step(data, out)
    want, want_crc = parity_step_plain(PARITY, data, fused)
    torch.cuda.synchronize()
    check(out.data_ptr() >= ls.payload.data_ptr() and
          out.data_ptr() < ls.payload.data_ptr() + ls.nbytes,
          "parity step output is not the leased slot")
    err = int((out.int() - want.int()).abs().max())
    same = torch.equal(out, want)
    if fused:
        err = max(err, int((crc - want_crc).abs().max()))
        same = same and torch.equal(crc, want_crc)
    check(err == 0 and same, f"parity step (fused={fused}) differs from "
          f"plain at {tuple(data.shape)}")
    return err


def k5_phase(dev, rng, mode: str) -> dict:
    """The pooled parity step in both forms: at the encode geometry (10, 6,
    1 MiB) and compacted k = 1, 3, 7, at odd L and through misaligned
    data and slots, exact; then 8 steady-state calls that must not grow
    the card's allocation count; then (not --quick) cold timing at the
    encode geometry beside K2 on (6, 10, 1 MiB)."""
    pool = get_pool()
    err = 0
    cases = [(10, 6, MIB, 0), (1, 6, MIB, 0), (3, 6, MIB, 0),
             (7, 6, MIB, 0), (10, 2, MIB + 3, 0), (3, 3, 4096 + 3, 0),
             (7, 2, MIB, 1), (10, 3, 4096 + 5, 3)]
    steady = {}
    for fused in (False, True):
        step = make_parity_step([dev], fused_crc=fused)
        for k, b, length, offset in cases:
            data = (rand_bytes(rng, (k, b, length), dev) if not offset else
                    misaligned(rng, (k, b, length), offset, dev))
            ls, out = leased_slot(pool, (4, b, length), dev, offset)
            err = max(err, compare_k5(step, fused, data, ls, out))
            pool.release(ls)
        data = rand_bytes(rng, (10, 6, MIB), dev)
        ls, out = leased_slot(pool, (4, 6, MIB), dev)
        step(data, out)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(8):
            step(data, out)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_stats()["allocation.all.allocated"] - before
        check(grew == 0, f"parity step (fused={fused}) allocated {grew} "
              "times on the card in 8 steady-state calls")
        steady["fused" if fused else "k1"] = grew
        pool.release(ls)
    log(f"parity step matches its plain version in both forms (k = 1, 3, "
        f"7, 10; odd L; misaligned), max_abs_err {err}; device "
        f"allocations over 8 steady-state calls: {steady}")
    if mode == "quick":
        return {"max_abs_err": err}
    res = {"max_abs_err": err, "steady_allocations": steady}
    # one step at the encode geometry moves 60 MiB in and 24 MiB out (+ 14
    # int64 CRCs per batch item when fused), as K2 does on (6, 10, 1 MiB)
    for fused in (True, False):
        step = make_parity_step([dev], fused_crc=fused)
        held = [leased_slot(pool, (4, 6, MIB), dev) for _ in range(4)]
        sets = [(rand_bytes(rng, (10, 6, MIB), dev), out)
                for _, out in held]
        name = "fused" if fused else "k1"
        res[name + "_ms"] = time_cold(lambda x, o: step(x, o), sets)
        res[name + "_plain_ms"] = time_cold(
            lambda x, o: parity_step_plain(PARITY, x, fused), sets, reps=4)
        res[name + "_bytes"] = 10 * 6 * MIB + 4 * 6 * MIB + \
            (6 * 14 * 8 if fused else 0)
        res[name + "_bound_ms"] = res[name + "_bytes"] / HBM_BYTES_PER_S * 1e3
        for ls, _ in held:
            pool.release(ls)
    log(f"parity step (cold L2, (10, 6, 1 MiB)): fused "
        f"{res['fused_ms'] * 1e3:.3f} us (plain "
        f"{res['fused_plain_ms'] * 1e3:.3f} us, bound "
        f"{res['fused_bound_ms'] * 1e3:.3f} us), K1 form "
        f"{res['k1_ms'] * 1e3:.3f} us (plain {res['k1_plain_ms'] * 1e3:.3f}"
        f" us, bound {res['k1_bound_ms'] * 1e3:.3f} us)")
    return res


def k7_phase(dev, rng):
    """The portable step forms ("K7") at the encode path's shapes: every
    rs_torch.apply_matrix method launches K1 once on a (10, 1 MiB + 3)
    stack, batched_encode_step, batched_swar_encode_step and the
    words=False encoder launch K2 once on (6, 10, 1 MiB), and
    _parity_bits_matmul K1 once; each equals the kernel's plain version
    on the card and, at 4,099 bytes, its own CPU formulation."""
    from seaweedfs_tpu_torch.ops import rs_torch
    from seaweedfs_tpu_torch.parallel import mesh

    bm = gf256.coeff_bit_matrix(PARITY).astype(np.int8)
    consts = rs_torch._bit_constants_cached(*rs_cuda._matrix_key(PARITY))
    x = rand_bytes(rng, (10, MIB + 3), dev)
    want = rs_cuda.gf_apply_plain(PARITY, x)
    small = rand_bytes(rng, (10, 4099), dev)
    for method in rs_torch.METHODS:
        rs_cuda.reset_launches()
        got = rs_torch.apply_matrix(PARITY, x, method=method)
        check(rs_cuda.launches["gf_apply"] == 1 and torch.equal(got, want),
              f"K7 apply_matrix(method={method!r}) on the card")
        check(torch.equal(rs_torch.apply_matrix(PARITY, small,
                                                method=method).cpu(),
                          rs_torch.apply_matrix(PARITY, small.cpu(),
                                                method=method)),
              f"K7 {method!r}: the card differs from its CPU form")
    data = rand_bytes(rng, (6, 10, MIB), dev)
    want_par, want_crc = rs_cuda.fused_apply_crc_plain(PARITY, data)
    for name, step in (
            ("batched_encode_step",
             lambda d: mesh.batched_encode_step(bm, d)),
            ("batched_swar_encode_step",
             lambda d: mesh.batched_swar_encode_step(consts, d)),
            ("make_sharded_encoder(words=False)",
             mesh.make_sharded_encoder(words=False))):
        rs_cuda.reset_launches()
        par, crc = step(data)
        check(rs_cuda.launches["fused_apply_crc"] == 1 and
              torch.equal(par, want_par) and
              torch.equal(crc.to(torch.int64), want_crc.to(torch.int64)),
              f"K7 {name} on the card")
        cpu = small.view(1, 10, -1)[:, :, :4096].cpu()
        check(all(torch.equal(a.cpu().to(b.dtype), b) for a, b in zip(
            step(cpu.to(dev)), step(cpu))), f"K7 {name}: the card "
            "differs from its CPU form")
    rs_cuda.reset_launches()
    par = mesh._parity_bits_matmul(bm, data)
    check(rs_cuda.launches["gf_apply"] == 1 and torch.equal(par, want_par),
          "K7 _parity_bits_matmul on the card")
    rs_cuda.reset_launches()
    log("K7 step forms: apply_matrix swar/mxu/pallas (K1), "
        "batched_encode_step, batched_swar_encode_step, "
        "make_sharded_encoder(words=False) (K2) and _parity_bits_matmul "
        "(K1) equal the plain versions and their CPU forms")


def kernel_phase(dev, mode: str) -> dict:
    rng = np.random.default_rng(SEED)
    par = PARITY
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    rebuild = np.ascontiguousarray(
        decode_rows(10, 14, survivors, (0, 5, 11, 13)))
    row = np.ascontiguousarray(
        decode_rows(10, 14, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10], (3,)))
    # distinct input sets, together beyond the 50 MB L2 (time_cold)
    enc_sets = [(par, rand_bytes(rng, (6, 10, MIB), dev)) for _ in range(4)]
    k1_sets = [(row, rand_bytes(rng, (10, MIB), dev)) for _ in range(8)]
    enc_in, k1_in = enc_sets[0][1], k1_sets[0][1]
    # the deep scrub's K8 shape: the (B, 18, L) permute of an (18, B, L)
    # slab of 14 shard rows and 4 recomputed parity rows
    k8_sets = [(rand_bytes(rng, (18, 3, MIB), dev).permute(1, 0, 2),)
               for _ in range(4)]
    errs = {"gf_apply": 0, "fused_apply_crc": 0, "crc32c_rows": 0}

    def k8(x):
        errs["crc32c_rows"] = max(errs["crc32c_rows"], compare_k8(x))

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
    k8(k8_sets[0][0])
    for length in (1, 16, 50, 4096 + 3, MIB + 3):
        k8(rand_bytes(rng, (18, 3, length), dev).permute(1, 0, 2))
        k8(misaligned(rng, (2, 18, length), 3, dev))
    log(f"kernels match their plain versions (max_abs_err {errs})")
    k5 = k5_phase(dev, rng, mode)
    k7_phase(dev, rng)
    if mode == "quick":
        return {}
    # one K2 encode launch moves 60 MiB in and 24 MiB out (+ the CRCs),
    # one K1 reconstruct of a 1 MiB span 10 MiB in and 1 MiB out
    k2_bytes = enc_in.numel() + 6 * 4 * MIB + 6 * 14 * 8
    k1_bytes = k1_in.numel() + MIB
    # one K8 launch over the scrub's slab reads 54 MiB, writes 54 images
    k8_bytes = k8_sets[0][0].numel() + 3 * 18 * 8
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
        "crc32c_rows": {
            "ms": time_cold(rs_cuda.crc32c_rows, k8_sets),
            "plain_ms": time_cold(batched_crc32c_raw, k8_sets, reps=8),
            "bytes": k8_bytes,
        },
    }
    stats["parity_step"] = k5
    log(f"card after timing: {gpu_state()}")
    for name, fn, sets in (("fused_apply_crc", rs_cuda.fused_apply_crc,
                            enc_sets),
                           ("gf_apply", rs_cuda.gf_apply, k1_sets),
                           ("crc32c_rows", rs_cuda.crc32c_rows, k8_sets)):
        for key, count, us in profile_kernels(fn, sets):
            log(f"profile {name}: {key[:60]} x{count} {us:.3f} us")
    for name in ("fused_apply_crc", "gf_apply", "crc32c_rows"):
        s = stats[name]
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


ROUTE_SPANS = (64 << 10, 256 << 10, MIB, 4 * MIB)
ROUTE_ROUNDS = 5


def route_phase(dev) -> dict:
    """reconstruct_span's routes for one decode row x (10, S): the host
    codec (the native library's GF apply); the device route from a
    pageable stack (H2D straight from it, K1 into a leased slab, D2H to a
    pinned slab); the same from a stack assembled in the pinned slab that
    `codec.survivor_stack` leases, as EcVolume's read ladder does; and the
    resident-slab hit (slab_key set, the stack already on the card).  The
    routes are timed in ROUTE_ROUNDS rounds that interleave them, each a
    median of 20 calls (host clock); a route's line gives the median of
    its rounds and their range, beside K1 alone cold in L2 (`time_cold`).
    Where two routes' ranges overlap, the run does not say which is
    faster.  The routes' crossing is what WEED_EC_RECOVER_DEVICE_MIN_KB
    (512) should sit at."""
    check(native.lib() is not None, "the native host library did not build")
    rng = np.random.default_rng(SEED + 1)
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    row = np.ascontiguousarray(decode_rows(10, 14, survivors, (0,)))
    out = {}
    for span in ROUTE_SPANS:
        x = np.frombuffer(rng.bytes(10 * span), np.uint8).reshape(
            10, span).copy()
        want = codec._apply_rows_host(row, x)[0]
        hits0 = get_pool().snapshot()["resident_hits"]
        with knobs(WEED_EC_RECOVER_DEVICE="1",
                   WEED_EC_RECOVER_DEVICE_MIN_KB="0"), \
                codec.survivor_stack(x.shape, dev) as slab:
            check(slab is not None and torch.from_numpy(slab).is_pinned(),
                  "survivor_stack leased no pinned slab for the card")
            np.copyto(slab, x)
            routes = {"host": ("0", None, x), "pageable": ("1", None, x),
                      "pinned": ("1", None, slab),
                      "resident": ("1", b"route-%d" % span, x)}
            rounds = {route: [] for route in routes}
            for route, (knob, key, stack) in routes.items():
                with knobs(WEED_EC_RECOVER_DEVICE=knob):
                    got = reconstruct_span(survivors, stack, 0, slab_key=key,
                                           device=dev)
                check(np.array_equal(got, want),
                      f"reconstruct_span {route} route differs at {span}")
            for _ in range(ROUTE_ROUNDS):
                for route, (knob, key, stack) in routes.items():
                    with knobs(WEED_EC_RECOVER_DEVICE=knob):
                        rounds[route].append(median_ms(
                            lambda: reconstruct_span(survivors, stack, 0,
                                                     slab_key=key,
                                                     device=dev)))
        hits = get_pool().snapshot()["resident_hits"] - hits0
        check(hits >= 20 * ROUTE_ROUNDS,
              f"resident route hit the pool {hits} times")
        res = {}
        for route, ms in rounds.items():
            res[route + "_ms"] = float(np.median(ms))
            res[route + "_range_ms"] = [min(ms), max(ms)]
        res.update(route_steps(dev, row, x))
        nsets = max(8, -(-64 * MIB // (10 * span)))
        sets = [(row, rand_bytes(rng, (10, span), dev)) for _ in range(nsets)]
        res["k1_ms"] = time_cold(rs_cuda.gf_apply, sets)
        out[span] = res
        log(f"reconstruct_span (10, {span >> 10} KiB) -> 1 row, median "
            f"[range] of {ROUTE_ROUNDS} rounds, ms: " + ", ".join(
                f"{route} {res[route + '_ms']:.4f} "
                f"[{res[route + '_range_ms'][0]:.4f}, "
                f"{res[route + '_range_ms'][1]:.4f}]" for route in routes)
            + f" ({hits} pool hits; K1 alone, cold: "
            f"{res['k1_ms'] * 1e3:.3f} us)")
        log(f"  steps (median ms, host clock, each ending in a sync): "
            f"copy into a pinned buffer {res['stage_ms']:.4f}, H2D pinned "
            f"{res['h2d_pinned_ms']:.4f}, H2D pageable "
            f"{res['h2d_pageable_ms']:.4f}, K1 {res['k1_sync_ms']:.4f}, "
            f"D2H {res['d2h_ms']:.4f}; the route's body with no pool "
            f"(pageable H2D, K1, D2H, each allocating) {res['bare_ms']:.4f}")
    return out


def route_steps(dev, row, x) -> dict:
    """The device route's steps for one (10, S) stack, each timed alone
    (median host-clock ms of 20 calls, each ending in a synchronize): a
    copy into a pinned buffer (what staging a pageable stack would add),
    its H2D, an H2D from the pageable array itself, K1, the D2H of the
    row; and the route's body with no pool (allocating H2D, K1, D2H)."""
    stream = torch.cuda.current_stream(dev)
    pinned = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
    din = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    dout = torch.empty((1, x.shape[1]), dtype=torch.uint8, device=dev)
    hout = torch.empty((1, x.shape[1]), dtype=torch.uint8, pin_memory=True)
    host = torch.from_numpy(x)

    def synced(fn):
        def run():
            fn()
            stream.synchronize()
        return run

    return {
        "stage_ms": median_ms(lambda: np.copyto(pinned.numpy(), x)),
        "h2d_pinned_ms": median_ms(synced(
            lambda: din.copy_(pinned, non_blocking=True))),
        "h2d_pageable_ms": median_ms(synced(lambda: din.copy_(host))),
        "k1_sync_ms": median_ms(synced(
            lambda: rs_cuda.gf_apply(row, din, out=dout))),
        "d2h_ms": median_ms(synced(
            lambda: hout.copy_(dout, non_blocking=True))),
        "bare_ms": median_ms(
            lambda: rs_cuda.gf_apply(row, host.to(dev)).cpu().numpy()),
    }


def route_profile(dev, span: int = 64 << 10, calls: int = 400):
    """cProfile of `calls` device-route decodes of one row x (10, span)
    from a pinned stack: where the route's host time goes beyond its
    copies and K1 (the functions with the most time of their own)."""
    import cProfile
    import pstats

    rng = np.random.default_rng(SEED + 2)
    survivors = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    with knobs(WEED_EC_RECOVER_DEVICE="1",
               WEED_EC_RECOVER_DEVICE_MIN_KB="0"), \
            codec.survivor_stack((10, span), dev) as slab:
        np.copyto(slab, np.frombuffer(rng.bytes(10 * span), np.uint8)
                  .reshape(10, span))
        for _ in range(20):
            reconstruct_span(survivors, slab, 0, device=dev)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(calls):
            reconstruct_span(survivors, slab, 0, device=dev)
        prof.disable()
        wall = time.perf_counter() - t0
    log(f"route profile: {calls} pinned-route decodes of (10, "
        f"{span >> 10} KiB) in {wall * 1e3:.3f} ms under cProfile "
        f"(own time per call, us):")
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:16]
    for (file, line, func), (_, ncalls, own, cum, _) in rows:
        log(f"  {own / calls * 1e6:9.2f} own {cum / calls * 1e6:9.2f} cum "
            f"{ncalls // calls:3d}x {os.path.basename(file)}:{line} {func}")


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
    log(f"pass 2 stage seconds (summed over readers): fetch "
        f"{st2['fetch_seconds']} decode {st2['decode_seconds']} serve "
        f"{st2['serve_seconds']}")
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


# -- phase 5 -----------------------------------------------------------------


def fill_store(store, vids, nbytes: int, seed: int) -> tuple[dict, int]:
    """Seeded needles through Store.write_needle until each volume holds
    `nbytes` of data (sizes log-uniform in [NEEDLE_MIN, NEEDLE_MAX]).
    Returns the first volume's {id: (cookie, data)} and the bytes
    written."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log(NEEDLE_MIN), np.log(NEEDLE_MAX)
    kept, total = {}, 0
    for vid in vids:
        store.add_volume(vid)
        written, nid = 0, 0
        while written < nbytes:
            nid += int(rng.integers(1, 1000))
            size = int(np.exp(rng.uniform(lo, hi)))
            n = Needle.create(rng.bytes(size),
                              name=f"obj-{rng.bytes(6).hex()}.jpg".encode(),
                              mime=b"image/jpeg")
            n.id, n.cookie = nid, int(rng.integers(1, 1 << 32))
            store.write_needle(vid, n)
            if vid == vids[0]:
                kept[nid] = (n.cookie, n.data)
            written += size
        total += written
    return kept, total


def flip_byte(path: str, offset: int):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def check_recover_mirrors(before: dict, after: dict, rst: dict) -> dict:
    """The EcRecover* samples moved by the counts `rst` (RecoverStats, or
    /admin/ec/recover_stats) reports over a window that began with
    RecoverStats reset."""
    p = "SeaweedFS_volumeServer_ec_recover_"

    def moved(name, **labels):
        return sample(after, p + name, **labels) - \
            sample(before, p + name, **labels)

    got = {"cache_hits": moved("cache_total", result="hit"),
           "cache_misses": moved("cache_total", result="miss"),
           "coalesced": moved("cache_total", result="coalesced"),
           "spans": moved("spans_total", mode="solo")
           + moved("spans_total", mode="batched"),
           "batched_spans": moved("spans_total", mode="batched"),
           "recovered_bytes": moved("bytes_total")}
    want = {k: rst[k] for k in got}
    check(got == want, f"EcRecover* mirrors {got} != RecoverStats {want}")
    return want


def check_recover_metrics(before: dict, after: dict, rst: dict, k1: int):
    """check_recover_mirrors, the stage seconds, and the recorded
    ec.recover.decode spans equal to the decode batches and K1's
    launches."""
    want = check_recover_mirrors(before, after, rst)
    p = "SeaweedFS_volumeServer_ec_recover_"
    for stage in ("fetch", "decode", "serve"):
        check(sample(after, p + "stage_seconds", stage=stage) ==
              round(getattr(recover.STATS, f"{stage}_seconds"), 6),
              f"EcRecoverStageSeconds{{{stage}}} != RecoverStats")
    spans = tracing.RECORDER.aggregate("ec.recover.decode").get(
        "ec.recover.decode", {}).get("count", 0)
    check(spans == rst["batches"] == k1,
          f"{spans} ec.recover.decode spans, {rst['batches']} decode "
          f"batches, {k1} K1 launches")
    log(f"recover metrics: EcRecover* mirrors = RecoverStats {want}; "
        f"ec.recover.decode spans {spans} = decode batches = K1 launches")


def store_phase(dev, workdir: str) -> dict:
    """Phase 5; returns the kernels' launches in it."""
    check(native.lib() is not None, "the native host library did not build")
    vids = list(range(1, STORE_VOLUMES + 1))
    store = Store([workdir], device=dev, ec_encoder_backend="cuda")
    pool = get_pool()
    rs_cuda.reset_launches()
    # every trace of this window is kept, so the spans can be counted
    tracing_on = knobs(WEED_TRACE_SAMPLE="1", WEED_TRACE_MAX_TRACES="1000000")
    tracing_on.__enter__()
    expo0, pool0 = exposition(), pool.snapshot()
    try:
        t0 = time.perf_counter()
        kept, data_bytes = fill_store(store, vids, STORE_VOLUME_BYTES,
                                      SEED + 5)
        write_s = time.perf_counter() - t0
        dat = {v: os.path.getsize(os.path.join(workdir, f"{v}.dat"))
               for v in vids}
        log(f"store: {len(vids)} volumes, {sum(dat.values())} B of .dat "
            f"({data_bytes} B of needle data) written through "
            f"Store.write_needle in {write_s:.3f} s")

        # the encode makes each volume durable first (fsync of its .dat);
        # done here on its own, so that cost is read apart from the encode
        t0 = time.perf_counter()
        for v in vids:
            store.find_volume(v).sync()
        sync_s = time.perf_counter() - t0
        st: dict = {}
        t0 = time.perf_counter()
        store.ec_generate_batch(vids, stage_stats=st)
        batch_s = time.perf_counter() - t0
        log(f"store: fsync of the {len(vids)} volumes {sync_s:.3f} s; "
            f"ec_generate_batch: {batch_s:.3f} s, "
            f"{sum(dat.values()) / batch_s / (1 << 30):.3f} GiB/s of .dat "
            "bytes (+ .ecx and .vif)")
        log("store ec_generate_batch stage_stats: " +
            json.dumps(st, sort_keys=True))
        check(st["backend"] == "device-words",
              f"ec_generate_batch took {st['backend']}")
        hits0 = pool.snapshot()["lease_hits"]
        st2: dict = {}
        t0 = time.perf_counter()
        store.ec_generate(1, stage_stats=st2)
        again_s = time.perf_counter() - t0
        hits = pool.snapshot()["lease_hits"] - hits0
        log(f"store ec_generate of volume 1 again: {again_s:.3f} s, "
            f"{dat[1] / again_s / (1 << 30):.3f} GiB/s, pool lease hits "
            f"{hits}, stage wall {st2['wall']} s, read {st2['read']} s, "
            f"pool allocs {st2['pool']['allocs']}")
        check(hits > 0, "the second encode re-leased no pool slab")
        enc = sample(exposition(), "SeaweedFS_volumeServer_ec_encode_bytes_"
                     "total") - sample(expo0, "SeaweedFS_volumeServer_ec_"
                                       "encode_bytes_total")
        check(enc == sum(dat.values()) + dat[1],
              f"EcEncodeBytesCounter moved {enc}, the encodes took "
              f"{sum(dat.values()) + dat[1]} B of .dat")
        log(f"store metrics: EcEncodeBytesCounter +{int(enc)} = the .dat "
            "bytes of ec_generate_batch and the repeat encode")

        base1 = os.path.join(workdir, "1")
        for v in vids:
            store.delete_volume(v)
        for sid in LOST:
            os.replace(base1 + to_ext(sid), base1 + to_ext(sid) + ".lost")
        for v in vids:
            store.ec_mount("", v, [sid for sid in range(14)
                                   if v != 1 or sid not in LOST])
        recover.STATS.reset()
        tracing.RECORDER.reset()
        expo_r0, k1_r0 = exposition(), rs_cuda.launches["gf_apply"]
        t0 = time.perf_counter()
        for nid, (cookie, data) in kept.items():
            n = store.read_needle(1, nid, cookie=cookie)  # checks the CRC
            check(n.data == data and n.cookie == cookie and
                  n.checksum == crc_host.crc32c(data),
                  f"store needle {nid:x} read back differs")
        read_s = time.perf_counter() - t0
        rst = recover.STATS.snapshot()
        check_recover_metrics(expo_r0, exposition(), rst,
                              rs_cuda.launches["gf_apply"] - k1_r0)
        check_pool_gauges(pool, "store degraded reads")
        log(f"store degraded reads: {len(kept)} needles of volume 1 in "
            f"{read_s:.3f} s, every one equal and CRC-checked; recovered "
            f"blocks {rst['cache_misses']}, decode batches {rst['batches']}"
            f", fetch/decode/serve s {rst['fetch_seconds']}/"
            f"{rst['decode_seconds']}/{rst['serve_seconds']}, device pool "
            f"{rst['device_pool']}")

        t0 = time.perf_counter()
        rebuilt = store.ec_rebuild(1)
        rebuild_s = time.perf_counter() - t0
        check(rebuilt == sorted(LOST), f"ec_rebuild returned {rebuilt}")
        for sid in LOST:
            check(same_file(base1 + to_ext(sid), base1 + to_ext(sid) +
                            ".lost"), f"rebuilt shard {sid} differs")
            os.unlink(base1 + to_ext(sid) + ".lost")
        log(f"store ec_rebuild {list(LOST)}: {rebuild_s:.3f} s, verified "
            "against the .vif CRCs and byte-identical")

        def scrub(stats=None):
            targets = [local_target(os.path.join(workdir, str(v)), v)
                       for v in vids]
            return deep_scrub(targets, device=dev, stage_stats=stats)

        st3: dict = {}
        expo_s0 = exposition()
        t0 = time.perf_counter()
        out = scrub(st3)
        scrub_s = time.perf_counter() - t0
        scrubbed = out["scrubbed_bytes"]
        check(out["corrupt"] == [] and all(v["ok"] and v["recomputed"]
                                           for v in out["volumes"]),
              f"deep scrub of clean volumes: {out['corrupt']}")
        gibps = out["scrubbed_bytes"] / scrub_s / (1 << 30)
        log(f"store deep_scrub (clean): {out['scrubbed_bytes']} B in "
            f"{scrub_s:.3f} s, {gibps:.3f} GiB/s of shard bytes; backend "
            f"{out['backend']}; stage_stats "
            f"{json.dumps(st3, sort_keys=True)}")
        flip_byte(os.path.join(workdir, "3" + to_ext(12)), 12345)
        out = scrub()
        check(out["corrupt"] == [{"volume": 3, "shards": [12]}],
              f"deep scrub after one flipped parity byte: {out['corrupt']}")
        log("store deep_scrub after flipping one byte of 3.ec12: "
            f"{out['corrupt']}")
        scrubbed += out["scrubbed_bytes"]
        expo = exposition()
        name = "SeaweedFS_volumeServer_maintenance_scrubbed_bytes_total"
        check(sample(expo, name) - sample(expo_s0, name) == scrubbed,
              f"MaintScrubbedBytesCounter moved "
              f"{sample(expo, name) - sample(expo_s0, name)}, deep scrub "
              f"reported {scrubbed}")
        snap = pool.snapshot()
        for way in ("h2d", "d2h"):
            name = f"SeaweedFS_volumeServer_ec_device_{way}_bytes_total"
            moved = sample_sum(expo, name) - sample_sum(expo0, name)
            own = snap[f"{way}_bytes"] - pool0[f"{way}_bytes"]
            check(moved == own, f"{name} moved {moved}, the pool's own "
                  f"{way} total {own}")
        check_pool_gauges(pool, "the Store phase")
        log(f"store metrics: MaintScrubbedBytesCounter +{scrubbed}; "
            "EcDevice H2D/D2H counters = the pool's own totals "
            f"(+{snap['h2d_bytes'] - pool0['h2d_bytes']} / "
            f"+{snap['d2h_bytes'] - pool0['d2h_bytes']} B); device pool "
            "gauges = pool.snapshot()")
        log_exposition("the Store phase")
        launches = dict(rs_cuda.launches)
    finally:
        tracing_on.__exit__(None, None, None)
        store.close()
    h2d, d2h = platform.link_throughput(device=dev)
    log(f"encode auto-selection: prefer_batched_encode -> "
        f"{platform.prefer_batched_encode(dev)}; link h2d {h2d:.1f} MB/s, "
        f"d2h {d2h:.1f} MB/s (pinned 4 MiB, CUDA events); predicted "
        f"{platform.predicted_batched_gibps(dev):.3f} GiB/s against host "
        f"codec {platform.host_codec_gibps():.3f} GiB/s")
    log(f"launches on the store path: {launches}")
    return launches


# -- phase 6 -----------------------------------------------------------------


def seeded_needles(nbytes: int, seed: int) -> dict:
    """{id: (cookie, data)} of log-uniform [NEEDLE_MIN, NEEDLE_MAX] needles
    until `nbytes` of data, cut from one seeded buffer made in bulk."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log(NEEDLE_MIN), np.log(NEEDLE_MAX)
    sizes = []
    while sum(sizes) < nbytes:
        sizes.append(int(np.exp(rng.uniform(lo, hi))))
    blob = rng.bytes(sum(sizes))
    cookies = rng.integers(1, 1 << 32, len(sizes))
    out, pos = {}, 0
    for i, size in enumerate(sizes):
        out[1 + i] = (int(cookies[i]), blob[pos:pos + size])
        pos += size
    return out


def ingest(store, vid: int, needles: dict, readers: bool = True) -> dict:
    """Write `needles` through Store.write_needle from INLINE_WRITERS
    threads (each its own stride of ids) while, with `readers`, one thread
    reads acked needles back through Store.read_needle and checks them.
    Returns the wall seconds and the reader's counts."""
    ev = store.find_ec_volume(vid)
    acked: list = []
    done = [False]
    reads = {"reads": 0, "tail_served": 0}
    real_tail = ev.tail_reader

    def counting_tail(sid, off, size):
        got = real_tail(sid, off, size)
        if got is not None:
            reads["tail_served"] += 1
        return got

    ev.tail_reader = counting_tail

    def writer(ids):
        for nid in ids:
            cookie, data = needles[nid]
            n = Needle.create(data, name=f"obj-{nid:x}.jpg".encode(),
                              mime=b"image/jpeg")
            n.id, n.cookie = nid, cookie
            store.write_needle(vid, n)
            acked.append(nid)

    def reader():
        rng = np.random.default_rng(SEED + 6)
        while not done[0]:
            if not acked:
                time.sleep(0.001)
                continue
            # the newest acks most often: they sit in the rows in flight
            nid = acked[max(0, len(acked) - 1 - int(rng.integers(0, 64)))]
            cookie, data = needles[nid]
            n = store.read_needle(vid, nid, cookie=cookie)
            check(n.data == data, f"needle {nid:x} read during ingest")
            reads["reads"] += 1

    ids = sorted(needles)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(INLINE_WRITERS + 1) as pool:
        rd = pool.submit(reader) if readers else None
        for f in [pool.submit(writer, ids[k::INLINE_WRITERS])
                  for k in range(INLINE_WRITERS)]:
            f.result()
        write_s = time.perf_counter() - t0
        ev.writer.drain(tail=True)
        wall = time.perf_counter() - t0
        done[0] = True
        if rd is not None:
            rd.result()
    ev.tail_reader = real_tail
    check(len(acked) == len(needles), "ingest lost acks")
    return {"write_s": write_s, "wall_s": wall, **reads}


def check_parity_logs(base: str, fam, unit: int, dev) -> int:
    """Every parity log equals the plain GF parity (K1's plain version on
    the card) of the zero-padded data logs, 16 stripe rows at a time.
    Returns the rows checked."""
    k, p = fam.data_shards, fam.parity_shards
    rows = os.path.getsize(base + to_ext(k)) // unit
    files = [open(base + to_ext(i), "rb") for i in range(k + p)]
    matrix = np.ascontiguousarray(fam.parity_matrix())
    try:
        for r0 in range(0, rows, 16):
            n = min(16, rows - r0) * unit
            stack = np.stack([read_chunk(f, r0 * unit, n) for f in files])
            lanes = torch.from_numpy(np.ascontiguousarray(
                fam.to_lanes(stack[:k]))).to(dev)
            want = fam.from_lanes(
                rs_cuda.gf_apply_plain(matrix, lanes).cpu().numpy())
            check(np.array_equal(want, stack[k:]),
                  f"{fam.name} parity logs differ at rows {r0}..")
    finally:
        for f in files:
            f.close()
    return rows


def read_all(store, vid: int, needles: dict) -> tuple[float, list]:
    """Read every needle through Store.read_needle; (wall s, per-read s)."""
    lat = []
    t0 = time.perf_counter()
    for nid, (cookie, data) in needles.items():
        t1 = time.perf_counter()
        n = store.read_needle(vid, nid, cookie=cookie)  # checks the CRC
        lat.append(time.perf_counter() - t1)
        check(n.data == data and n.cookie == cookie,
              f"needle {nid:x} of volume {vid} read back differs")
    return time.perf_counter() - t0, lat


def lose_and_read(store, vid: int, needles: dict, lost,
                  per_call: int) -> dict:
    """Unmount and delete `lost` shard logs of the mounted volume and read
    every needle through the degraded ladder; K1 launches must equal the
    decode batches (plus any tail parity encode, `per_call` each)."""
    ev = store.find_ec_volume(vid)
    for sid in lost:
        ev.shards.pop(sid).close()
        os.remove(ev.base_file_name() + to_ext(sid))
    recover.STATS.reset()
    k1 = rs_cuda.launches["gf_apply"]
    enc = ev.writer.device_encodes
    wall, lat = read_all(store, vid, needles)
    k1 = rs_cuda.launches["gf_apply"] - k1
    enc = ev.writer.device_encodes - enc
    st = recover.STATS.snapshot()
    check(st["batches"] > 0 and k1 == st["batches"] + enc * per_call,
          f"degraded reads: {k1} K1 launches for {st['batches']} decode "
          f"batches and {enc} encodes")
    return {"wall_s": wall, "p50_ms": pct_ms(lat, 50),
            "p99_ms": pct_ms(lat, 99), "k1": k1, "batches": st["batches"],
            "blocks": st["cache_misses"], "decode_s": st["decode_seconds"],
            "fetch_s": st["fetch_seconds"]}


def batch_encode_ms(w, reps: int = 20) -> dict:
    """Median host-clock ms of one 16-row commit-batch encode, the card's
    route (one parity step call) and the host codec's, on the calling
    thread with no ingest running, in alternating turns."""
    rng = np.random.default_rng(SEED + 9)
    rows = [rng.bytes(w.row_bytes) for _ in range(16)]
    times = {"1": [], "0": []}
    for i in range(reps + 2):
        for knob in (("1", "0") if i % 2 else ("0", "1")):
            with knobs(WEED_EC_INLINE_DEVICE=knob):
                t0 = time.perf_counter()
                w._encode_rows(rows)
                if i >= 2:
                    times[knob].append(time.perf_counter() - t0)
    return {"card_ms": float(np.median(times["1"])) * 1e3,
            "host_ms": float(np.median(times["0"])) * 1e3}


def tail_records(base: str) -> int:
    return sum(r["kind"] == inline.KIND_TAIL
               for r in inline.read_commit_log(base + ".scl"))


def check_inline_metrics(before: dict, after: dict, w, status: dict):
    """The EcInline* families moved with the writer's own counts over its
    ingest, drain included."""
    p = "SeaweedFS_ec_inline_"

    def moved(name, **labels):
        return sample(after, p + name, **labels) - \
            sample(before, p + name, **labels)

    rows = moved("stripes_committed_total", kind="full") + \
        moved("stripes_committed_total", kind="tail")
    logical = moved("bytes_total", kind="logical")
    amp = sample(after, p + "write_amp")
    check(rows == w.stripes_committed,
          f"EcInlineStripesCommitted moved {rows}, the writer committed "
          f"{w.stripes_committed} rows")
    check(amp == round(status["write_amp"], 4),
          f"EcInlineWriteAmp {amp} != {round(status['write_amp'], 4)}")
    check(logical == status["logical_size"],
          f"EcInlineBytesCounter{{logical}} moved {logical}, the writer "
          f"ingested {status['logical_size']} B")
    log(f"inline metrics: EcInlineStripesCommitted +{int(rows)} = the "
        f"writer's rows; EcInlineWriteAmp {amp}; EcInlineBytesCounter"
        f"{{logical}} +{int(logical)} = its logical bytes")
    log_exposition("an inline ingest")


def inline_volume(dev, workdir: str, vid: int, collection: str,
                  nbytes: int, seed: int, lost) -> tuple[dict, dict]:
    """One inline volume on the card: ingest, drain, parity logs against
    the plain version, the audit, the window's K1 launches against the
    writer's device encodes, pool allocations after the first batch, then
    `lost` shard logs deleted and every needle read degraded.  Returns
    its numbers and needles."""
    fam = ec_codes.get_family(
        ec_codes.family_for_collection(collection))
    per_call = -(-fam.parity_shards * fam.sub_shards // rs_cuda.MAX_ROWS)
    pool = get_pool()
    needles = seeded_needles(nbytes, seed)
    store = Store([workdir], device=dev)
    try:
        ev = store.add_volume(vid, collection)
        check(isinstance(ev, inline.InlineEcVolume) and ev.family is fam,
              f"volume {vid} of {collection!r} is not an inline volume of "
              f"{fam.name}")
        w = ev.writer
        rs_cuda.reset_launches()
        first = {}

        def watch():  # the pool's allocations once the first batch ran
            while not first:
                if w.device_encodes >= 1:
                    first["allocs"] = pool.snapshot()["allocs"]
                    if dev.type == "cuda":
                        first["mem"] = torch.cuda.memory_stats()[
                            "allocation.all.allocated"]
                    return
                time.sleep(0.0005)

        watcher = concurrent.futures.ThreadPoolExecutor(1)
        fw = watcher.submit(watch)
        logical_bytes = sum(len(d) for _, d in needles.values())
        expo0 = exposition()
        with knobs(WEED_TRACE_SAMPLE="1"):
            res = ingest(store, vid, needles)
        fw.result(timeout=60)
        watcher.shutdown()
        k1 = rs_cuda.launches["gf_apply"]
        st = w.encode_stats()
        status = w.status()
        check_inline_metrics(expo0, exposition(), w, status)
        allocs = pool.snapshot()["allocs"] - first["allocs"]
        check(st["device_encodes"] > 0 and
              k1 == st["device_encodes"] * per_call,
              f"{fam.name}: {k1} K1 launches in the ingest window for "
              f"{st['device_encodes']} device encodes x {per_call}")
        check(allocs == 0, f"{fam.name}: the pool allocated {allocs} slabs "
              "after the first commit batch")
        if dev.type == "cuda":
            grew = torch.cuda.memory_stats()["allocation.all.allocated"] \
                - first["mem"]
            check(grew == 0, f"{fam.name}: {grew} card allocations after "
                  "the first commit batch")
        base = ev.base_file_name()
        rows = check_parity_logs(base, fam, w.unit, dev)
        t0 = time.perf_counter()
        audit = inline.audit_inline_volume(ev)
        audit_s = time.perf_counter() - t0
        check(audit["ok"] and audit["needles_checked"] == len(needles),
              f"{fam.name} audit: {audit}")
        alone = batch_encode_ms(w)
        gib = logical_bytes / res["wall_s"] / (1 << 30)
        out = {
            "family": fam.name, "needles": len(needles),
            "logical_bytes": logical_bytes, "ingest_s": res["wall_s"],
            "write_s": res["write_s"], "ingest_gibps": gib,
            "write_amp": status["write_amp"],
            "batches": st["commit_batches"],
            "encode_ms_per_batch": st["commit_encode_seconds"] * 1e3
            / max(1, st["commit_batches"]),
            "device_encodes": st["device_encodes"], "k1": k1,
            "k1_per_encode": per_call, "tail_commits": tail_records(base),
            "rows": rows, "audit_s": audit_s, "reads": res["reads"],
            "tail_served": res["tail_served"], "pool_allocs_after": allocs,
            "alone_card_ms": alone["card_ms"],
            "alone_host_ms": alone["host_ms"],
        }
        log(f"inline {fam.name} ingest: {len(needles)} needles, "
            f"{logical_bytes} B in {res['wall_s']:.3f} s "
            f"({res['write_s']:.3f} s to the last ack), {gib:.3f} GiB/s of "
            f"logical bytes; write amp {status['write_amp']}; "
            f"{st['commit_batches']} commit batches, flusher encode "
            f"{out['encode_ms_per_batch']:.3f} ms per batch on the card; "
            f"{out['tail_commits']} tail commits; {res['reads']} reads "
            f"during ingest ({res['tail_served']} tail spans)")
        log(f"inline {fam.name}: K1 launches in the ingest window {k1} = "
            f"{st['device_encodes']} device encodes x {per_call}; pool "
            f"allocations after the first batch {allocs}; {rows} parity "
            f"rows equal to the plain version; audit {audit_s:.3f} s clean")
        log(f"inline {fam.name}: one 16-row batch encode alone (median of "
            f"20, host clock): card {alone['card_ms']:.3f} ms, host codec "
            f"{alone['host_ms']:.3f} ms")
        if lost:
            deg = lose_and_read(store, vid, needles, lost, per_call)
            out["degraded"] = deg
            log(f"inline {fam.name} degraded reads, {list(lost)} lost: "
                f"{len(needles)} needles in {deg['wall_s']:.3f} s, p50 "
                f"{deg['p50_ms']:.4f} ms p99 {deg['p99_ms']:.4f} ms; "
                f"{deg['blocks']} recovered blocks, {deg['batches']} decode "
                f"batches, K1 launches {deg['k1']}, fetch/decode s "
                f"{deg['fetch_s']}/{deg['decode_s']}")
    finally:
        store.close()
    out["launches"] = dict(rs_cuda.launches)
    return out, needles


def inline_phase(dev, workdir: str) -> dict:
    """Phase 6, each volume in its own directory under `workdir` (a Store
    mounts every inline volume of its directory); returns the kernels'
    launches in it."""
    check(native.lib() is not None, "the native host library did not build")
    rs_dir, msr_dir, host_dir = (os.path.join(workdir, d)
                                 for d in ("rs", "msr", "host"))
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)

    with knobs(WEED_EC_INLINE="1", WEED_EC_INLINE_DEVICE="1",
               WEED_EC_CODE_PICS="rs_vandermonde", WEED_EC_CODE_COLD="pm_msr",
               WEED_EC_STRIPE_KB="64", WEED_EC_INLINE_FLUSH_MS="500"):
        rs, needles = inline_volume(dev, rs_dir, 1, "pics", INLINE_BYTES,
                                    SEED + 6, lost=None)
        add(rs["launches"])
        base = os.path.join(rs_dir, "pics_1")
        for sid in (1, 11):
            os.remove(base + to_ext(sid))
        rs_cuda.reset_launches()
        t0 = time.perf_counter()
        store = Store([rs_dir], device=dev)  # DiskLocation remounts, heals
        heal_s = time.perf_counter() - t0
        try:
            ev = store.find_ec_volume(1)
            check(isinstance(ev, inline.InlineEcVolume),
                  "the remount did not mount the inline volume")
            for sid in (1, 11):
                check(os.path.getsize(base + to_ext(sid)) ==
                      ev.writer.shard_extent(sid),
                      f"healed .ec{sid:02d} is not at its committed extent")
            heal_k1 = rs_cuda.launches["gf_apply"]
            read_s, lat = read_all(store, 1, needles)
            log(f"inline remount with .ec01 .ec11 deleted: healed in "
                f"{heal_s:.3f} s ({heal_k1} K1 launches); {len(needles)} "
                f"needles read in {read_s:.3f} s (p50 {pct_ms(lat, 50):.4f}"
                f" ms p99 {pct_ms(lat, 99):.4f} ms)")
            deg = lose_and_read(store, 1, needles, LOST, 1)
            log(f"inline rs_vandermonde degraded reads, {list(LOST)} lost: "
                f"{len(needles)} needles in {deg['wall_s']:.3f} s, p50 "
                f"{deg['p50_ms']:.4f} ms p99 {deg['p99_ms']:.4f} ms; "
                f"{deg['blocks']} recovered blocks, {deg['batches']} decode "
                f"batches, K1 launches {deg['k1']}, fetch/decode s "
                f"{deg['fetch_s']}/{deg['decode_s']}")
        finally:
            store.close()
        t0 = time.perf_counter()
        rep = deep_scrub_host(rs_dir, "pics", 1, device=dev)
        scrub_s = time.perf_counter() - t0
        check(rep["ok"] and rep["inline"] and not rep["corrupt"] and
              rep["needles_checked"] == len(needles),
              f"deep scrub of the inline volume: {rep}")
        unit = 64 << 10
        flip_byte(base + to_ext(12), 3 * unit + 123)
        t0 = time.perf_counter()
        rep = deep_scrub_host(rs_dir, "pics", 1, device=dev)
        scrub2_s = time.perf_counter() - t0
        check(rep["corrupt"] == [3] and not rep["ok"] and
              rep["needles_bad"] == 0,
              f"deep scrub after one flipped parity byte: {rep['corrupt']}")
        log(f"inline deep_scrub (mount heals the 4 lost logs, audit): "
            f"{scrub_s:.3f} s clean, {rep['rows_checked']} rows; after "
            f"flipping one byte of pics_1.ec12: {scrub2_s:.3f} s, corrupt "
            f"rows {rep['corrupt']}")
        add(rs_cuda.launches)

        msr, _ = inline_volume(dev, msr_dir, 2, "cold", INLINE_MSR_BYTES,
                               SEED + 7, lost=MSR_LOST)
        add(msr["launches"])
        check(msr["k1_per_encode"] == 3, "pm_msr: not 3 K1 launches a call")
    # the two parity routes side by side at 256 MiB, same ingest (4
    # writers and the reader), in turns: card, host, host, card
    pair = {"1": [], "0": []}
    for turn, knob in enumerate(("1", "0", "0", "1")):
        with knobs(WEED_EC_INLINE="1", WEED_EC_INLINE_DEVICE=knob,
                   WEED_EC_CODE_PICS="rs_vandermonde", WEED_EC_STRIPE_KB="64",
                   WEED_EC_INLINE_FLUSH_MS="500"):
            rs_cuda.reset_launches()
            needles = seeded_needles(INLINE_HOST_BYTES, SEED + 8)
            store = Store([os.path.join(host_dir, str(turn))], device=dev)
            try:
                ev = store.add_volume(3, "pics")
                res = ingest(store, 3, needles)
                st = ev.writer.encode_stats()
                check((st["device_encodes"] > 0) == (knob == "1") and
                      rs_cuda.launches["gf_apply"] ==
                      st["device_encodes"], f"route {knob}: launches "
                      f"{rs_cuda.launches} for {st['device_encodes']}")
                check(inline.audit_inline_volume(ev)["ok"],
                      f"route {knob}: audit failed")
                add(rs_cuda.launches)
                logical = sum(len(d) for _, d in needles.values())
                ms = st["commit_encode_seconds"] * 1e3 / max(
                    1, st["commit_batches"])
                pair[knob].append((logical / res["wall_s"] / (1 << 30), ms,
                                   st["commit_batches"]))
                log(f"inline 256 MiB, {'card' if knob == '1' else 'host'} "
                    f"route (turn {turn}): {logical} B in "
                    f"{res['wall_s']:.3f} s, "
                    f"{pair[knob][-1][0]:.3f} GiB/s; "
                    f"{st['commit_batches']} commit batches, flusher encode "
                    f"{ms:.3f} ms per batch")
            finally:
                store.close()
    host_ms = float(np.mean([m for _, m, _ in pair["0"]]))
    summary = {k: rs[k] for k in ("ingest_gibps", "write_amp",
                                  "encode_ms_per_batch", "batches",
                                  "tail_commits", "device_encodes", "k1",
                                  "audit_s")}
    summary.update(heal_s=heal_s, degraded_p50_ms=deg["p50_ms"],
                   degraded_p99_ms=deg["p99_ms"], host_encode_ms=host_ms,
                   alone_card_ms=rs["alone_card_ms"],
                   alone_host_ms=rs["alone_host_ms"],
                   msr_alone_card_ms=msr["alone_card_ms"],
                   msr_alone_host_ms=msr["alone_host_ms"],
                   msr_ingest_gibps=msr["ingest_gibps"],
                   msr_encode_ms_per_batch=msr["encode_ms_per_batch"],
                   msr_k1=msr["k1"], msr_device_encodes=msr["device_encodes"])
    log("inline summary: " + json.dumps(summary, sort_keys=True))
    log(f"launches on the inline path: {launches}")
    return launches


# -- phase 7 -----------------------------------------------------------------


def read_through(cache, store, vid: int, nid: int, cookie: int) -> tuple:
    """The filer's read-through: a get, and on a miss the needle read
    through the Store (a degraded read behind a lost shard) and put.
    Returns (bytes, "hit" or "miss")."""
    fid = f"{vid},{nid:x}"
    got = cache.get(fid)
    if got is not None:
        return got, "hit"
    data = store.read_needle(vid, nid, cookie=cookie).data
    cache.put(fid, data)
    return data, "miss"


def cache_phase(dev, workdir: str) -> dict:
    """Phase 7: the tiered read cache on the card (HBM tier 1 GiB, RAM
    64 MiB, no disk layer) in front of an EC volume of 384 seeded 4 MiB
    needles with 4 shards lost; returns the kernels' launches in it."""
    check(native.lib() is not None, "the native host library did not build")
    vid, vid_rw = 1, 2
    rng = np.random.default_rng(SEED + 9)
    blob = rng.bytes(CACHE_NEEDLES * CACHE_CHUNK)
    cookies = rng.integers(1, 1 << 32, CACHE_NEEDLES)
    ids = sorted(int(x) for x in rng.choice(1 << 24, CACHE_NEEDLES,
                                            replace=False) + 1)
    chunks = {nid: (int(cookies[i]),
                    blob[i * CACHE_CHUNK:(i + 1) * CACHE_CHUNK])
              for i, nid in enumerate(ids)}
    pool = get_pool()
    rs_cuda.reset_launches()
    store = Store([workdir], device=dev, ec_encoder_backend="cuda")
    cache = None
    try:
        t0 = time.perf_counter()
        store.add_volume(vid)
        for nid in ids:
            cookie, data = chunks[nid]
            n = Needle.create(data, name=f"chunk-{nid:x}".encode())
            n.id, n.cookie = nid, cookie
            store.write_needle(vid, n)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.ec_generate(vid)
        encode_s = time.perf_counter() - t0
        base = os.path.join(workdir, str(vid))
        dat = os.path.getsize(base + ".dat")
        store.delete_volume(vid)
        for sid in LOST:
            os.remove(base + to_ext(sid))
        store.ec_mount("", vid, [sid for sid in range(14) if sid not in LOST])
        log(f"cache: {CACHE_NEEDLES} needles of {CACHE_CHUNK} B ({dat} B of "
            f".dat) written through Store.write_needle in {write_s:.3f} s, "
            f"EC-encoded on the card in {encode_s:.3f} s, "
            f".ec00 .ec05 .ec11 .ec13 deleted and the volume remounted as EC")

        with knobs(WEED_READ_CACHE_HBM_MB=str(CACHE_HBM_MB),
                   WEED_READ_CACHE_MB=str(CACHE_RAM_MB)):
            mem0 = torch.cuda.memory_allocated(dev)
            cache = TieredReadCache()
        hbm_cap = int(CACHE_HBM_MB * MIB)
        check(cache.hbm is not None and cache.hbm.device == dev and
              cache.hbm.capacity == hbm_cap and
              cache.capacity == int(CACHE_RAM_MB * MIB),
              "the read cache's HBM tier is not on the card at its budget")
        # a seeded Zipf(1.1) over the fids: rank r drawn with weight r^-s
        ranks = np.arange(1, CACHE_NEEDLES + 1, dtype=np.float64)
        weights = ranks ** -CACHE_ZIPF
        order = rng.permutation(ids)
        draws = order[rng.choice(CACHE_NEEDLES, CACHE_GETS,
                                 p=weights / weights.sum())]
        lat = {"hit": [], "miss": []}
        rec0, expo0 = recover.STATS.snapshot(), exposition()
        snap0 = cache.stats_snapshot()
        k1_0 = rs_cuda.launches["gf_apply"]

        def reader(part):
            out = {"hit": [], "miss": []}
            for nid in part:
                cookie, want = chunks[int(nid)]
                t = time.perf_counter()
                got, how = read_through(cache, store, vid, int(nid), cookie)
                out[how].append(time.perf_counter() - t)
                check(bytes(got) == want, f"chunk {int(nid):x} differs")
            return out

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(CACHE_THREADS) as ex:
            for res in ex.map(reader, [draws[k::CACHE_THREADS]
                                       for k in range(CACHE_THREADS)]):
                for k in lat:
                    lat[k] += res[k]
        reads_s = time.perf_counter() - t0
        k1 = rs_cuda.launches["gf_apply"] - k1_0
        snap = cache.stats_snapshot()
        zipf_ratio = snap["hit_ratio"]
        rec = recover.STATS.snapshot()
        hbm = cache.hbm
        grew = torch.cuda.memory_allocated(dev) - mem0
        log(f"cache: {CACHE_GETS} gets from {CACHE_THREADS} threads over "
            f"Zipf({CACHE_ZIPF}) of {CACHE_NEEDLES} fids in {reads_s:.3f} s, "
            f"every chunk equal; tiers {json.dumps(snap, sort_keys=True)}; "
            f"HBM tier {len(hbm)} chunks, {hbm.size_bytes} B, "
            f"{hbm.evictions} evictions; card memory +{grew} B; "
            f"degraded decode batches {rec['batches'] - rec0['batches']}, "
            f"K1 launches {k1}")
        check(snap["tier_hits"]["hbm"] > 0 and snap["tier_hits"]["ram"] > 0,
              f"phase 7 tier hits {snap['tier_hits']}")
        check(k1 > 0, "no K1 launch on the cache path's misses")
        zipf_hbm = len(hbm)

        # A chunk reaches the HBM tier after two RAM hits, and the RAM tier
        # holds 16 chunks, so the Zipf draw promotes only its head (tens
        # of chunks).  A sweep that reads every chunk three times in a row
        # promotes all 384 (1.5 GiB) through the 1 GiB tier.
        t0 = time.perf_counter()
        for nid in ids:
            for _ in range(3):
                got, _ = read_through(cache, store, vid, nid, chunks[nid][0])
            check(bytes(got) == chunks[nid][1], f"sweep chunk {nid:x}")
        sweep_s = time.perf_counter() - t0
        snap = cache.stats_snapshot()
        grew = torch.cuda.memory_allocated(dev) - mem0
        log(f"cache: the Zipf gets left {zipf_hbm} chunks in the HBM tier; "
            f"a sweep reading each of the {CACHE_NEEDLES} chunks 3 times in "
            f"{sweep_s:.3f} s left {len(hbm)} chunks, {hbm.size_bytes} B, "
            f"after {hbm.evictions} evictions; card memory +{grew} B")
        check(hbm.evictions > 0, "the HBM tier never evicted")
        check(hbm.size_bytes <= hbm_cap, f"HBM tier {hbm.size_bytes} B")
        check(hbm.held_bytes() == hbm.size_bytes,
              f"the pool holds {hbm.held_bytes()} B of the tier's slabs, "
              f"the tier {hbm.size_bytes} B")
        check(grew >= hbm.size_bytes,
              f"card memory grew {grew} B under {hbm.size_bytes} B of HBM "
              "tier")

        # the read-cache families equal the cache's own counters
        expo = exposition()
        moved = {t: sample(expo, "SeaweedFS_read_cache_requests_total",
                           tier=t)
                 - sample(expo0, "SeaweedFS_read_cache_requests_total",
                          tier=t) for t in ("hbm", "ram", "disk", "miss")}
        want = {t: snap["tier_hits"][t] - snap0["tier_hits"][t]
                for t in ("hbm", "ram", "disk")}
        want["miss"] = snap["misses"] - snap0["misses"]
        fills = {o: sample(expo, "SeaweedFS_read_cache_fill_total",
                           outcome=o)
                 - sample(expo0, "SeaweedFS_read_cache_fill_total",
                          outcome=o) for o in ("admitted", "qos_bypass")}
        resident = {t: sample(expo, "SeaweedFS_read_cache_resident_bytes",
                              tier=t) for t in ("ram", "hbm")}
        check(moved == want and fills == {
            o: snap["fills"][o] - snap0["fills"][o] for o in fills} and
            resident == snap["resident_bytes"],
            f"read cache samples {moved} {fills} {resident} != "
            f"stats_snapshot {snap}")
        log("cache exposition: " + json.dumps(
            {"requests": moved, "fills": fills, "resident_bytes": resident},
            sort_keys=True) + " = stats_snapshot()")

        # hit latencies alone, one thread: RAM hits of the chunks in RAM,
        # HBM hits of chunks in the HBM tier and not in RAM
        ram_lat, hbm_lat = [], []
        in_ram = list(cache.mem._data)
        for _ in range(25):
            for fid in in_ram[-8:]:
                t = time.perf_counter()
                cache.get(fid)
                ram_lat.append(time.perf_counter() - t)
        only_hbm = [f for f in list(hbm._keys)
                    if cache.mem.get(f) is None][:200]
        for fid in only_hbm:
            before = cache.stats_snapshot()["tier_hits"]["hbm"]
            t = time.perf_counter()
            got = cache.get(fid)
            hbm_lat.append(time.perf_counter() - t)
            nid = int(fid.split(",")[1], 16)
            check(got == chunks[nid][1] and
                  cache.stats_snapshot()["tier_hits"]["hbm"] == before + 1,
                  f"HBM hit of {fid}")
        summary = {
            "gets": CACHE_GETS, "threads": CACHE_THREADS,
            "reads_s": reads_s, "hit_ratio": zipf_ratio,
            "tier_hits": snap["tier_hits"], "misses": snap["misses"],
            "hbm_chunks": len(hbm), "hbm_bytes": hbm.size_bytes,
            "hbm_evictions": hbm.evictions, "card_bytes_grew": grew,
            "k1": k1, "zipf_hbm_chunks": zipf_hbm, "sweep_s": sweep_s,
            "ram_hit_ms": [pct_ms(ram_lat, 50), pct_ms(ram_lat, 99)],
            "hbm_hit_ms": [pct_ms(hbm_lat, 50), pct_ms(hbm_lat, 99)],
            "miss_ms": [pct_ms(lat["miss"], 50), pct_ms(lat["miss"], 99)],
            "hit_ms_4_threads": [pct_ms(lat["hit"], 50),
                                 pct_ms(lat["hit"], 99)],
            "hbm_hit_samples": len(hbm_lat), "ram_hit_samples": len(ram_lat),
        }
        log("cache summary (p50, p99 ms): " + json.dumps(summary,
                                                         sort_keys=True))
        check(len(hbm_lat) > 0, "no chunk was in the HBM tier alone")

        # a get under the background class admits no fill
        cold = next(f for f in (f"{vid},{nid:x}" for nid in ids)
                    if cache.mem.get(f) is None and f not in hbm._keys)
        bypass0 = cache.stats_snapshot()["fills"]["qos_bypass"]
        with qos_scope("background"):
            nid = int(cold.split(",")[1], 16)
            got, how = read_through(cache, store, vid, nid, chunks[nid][0])
        check(how == "miss" and got == chunks[nid][1] and
              cache.stats_snapshot()["fills"]["qos_bypass"] == bypass0 + 1
              and cache.mem.get(cold) is None and cold not in hbm._keys,
              "a background get filled the cache")

        # R1 on the card: a promoted needle overwritten through the Store
        # (on a writable volume) comes back new from the HBM tier
        store.add_volume(vid_rw)
        old, new = rng.bytes(CACHE_CHUNK), rng.bytes(CACHE_CHUNK)
        for data in (old, new):
            if data is new:
                fid = f"{vid_rw},1"
                for _ in range(3):
                    read_through(cache, store, vid_rw, 1, 77)
                check(fid in hbm._keys, "the old needle was not promoted")
                cache.invalidate(fid, "overwrite")
            n = Needle.create(data, name=b"overwritten")
            n.id, n.cookie = 1, 77
            store.write_needle(vid_rw, n)
        got, how = read_through(cache, store, vid_rw, 1, 77)
        check(how == "miss" and got == new, "the overwrite read through")
        for _ in range(3):
            read_through(cache, store, vid_rw, 1, 77)
        check(fid in hbm._keys, "the new needle was not promoted")
        for nid in ids[:20]:  # push it out of RAM
            cache.put(f"{vid},{nid:x}", chunks[nid][1])
        check(cache.mem.get(fid) is None, "the needle is still in RAM")
        hits0 = cache.stats_snapshot()["tier_hits"]["hbm"]
        got = cache.get(fid)
        check(got == new and
              cache.stats_snapshot()["tier_hits"]["hbm"] == hits0 + 1,
              "R1: the HBM tier did not serve the overwritten bytes")
        log("cache R1 on the card: overwrite, invalidate, read-through, "
            "promote, out of RAM: the HBM tier served the new bytes")

        cache.invalidate_volume(vid)
        cache.invalidate_volume(vid_rw)
        cache.clear()
        held = pool.residents_under(hbm.pool_prefix)
        check(held == {} and len(hbm) == 0,
              f"the tier still holds {len(held)} slabs after clear()")
        log("cache: invalidate_volume and clear() left no slab of the tier "
            "in the pool")
        log_exposition("the cache phase")
        launches = dict(rs_cuda.launches)
    finally:
        if cache is not None:
            cache.close()
        store.close()
    log(f"launches on the cache path: {launches}")
    return launches


# -- phase 8: the volume server over HTTP --------------------------------------

# The load process of phase 8: stdlib and numpy only (no torch, nothing of
# the port), so the server's interpreter lock is its own.  It makes the
# same seeded needles as seeded_needles(), then POSTs or GETs the ids it
# is given from its own keep-alive connections and writes what it saw.
LOADER = r"""
import http.client, itertools, json, sys, threading, time
import numpy as np

with open(sys.argv[1]) as f:  # the spec: too long for an argument
    a = json.load(f)
rng = np.random.default_rng(a["seed"])
lo, hi = np.log(a["min"]), np.log(a["max"])
sizes = []
while sum(sizes) < a["nbytes"]:
    sizes.append(int(np.exp(rng.uniform(lo, hi))))
blob = memoryview(rng.bytes(sum(sizes)))
cookies = rng.integers(1, 1 << 32, len(sizes))
needles, pos = {}, 0
for i, size in enumerate(sizes):
    needles[1 + i] = (int(cookies[i]), blob[pos:pos + size])
    pos += size
ids = a["ids"] or sorted(needles)
# per-needle [server, path] (fids a master assigned), else the one server
targets = a.get("targets") or {}
counter = itertools.count()
lat, etags, bad, moved = {}, {}, [], [0]
lock = threading.Lock()


def worker():
    conns = {}

    def connection(addr):
        if addr not in conns:
            host, port = addr.split(":")
            conns[addr] = http.client.HTTPConnection(host, int(port),
                                                     timeout=300)
        return conns[addr]

    sent = 0
    try:
        while True:
            i = next(counter)
            if i >= len(ids):
                return
            sent += 1
            if a["reconnect"] and sent % a["reconnect"] == 0:
                # a new connection: SO_REUSEPORT spreads connections, not
                # requests, over a prefork server's processes
                for c in conns.values():
                    c.close()
                conns.clear()
            nid = ids[i]
            cookie, data = needles[nid]
            addr, path = targets.get(str(nid)) or (
                a["addr"], "/%d,%x%08x" % (a["vid"], nid, cookie))
            conn = connection(addr)
            t0 = time.perf_counter()
            if a["mode"] == "put":
                conn.request("POST", path, body=data)
            else:
                conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            dt = time.perf_counter() - t0
            if a["mode"] == "put":
                ok = resp.status == 200
                etag = json.loads(body).get("eTag") if ok else None
                n = len(data)
            else:
                ok = resp.status == 200 and body == data
                etag = (resp.getheader("Etag") or "").strip('"')
                n = len(body)
            with lock:
                lat[nid] = dt
                etags[nid] = etag
                moved[0] += n
                if not ok:
                    bad.append([nid, resp.status, body[:200].decode(
                        "latin-1")])
    finally:
        for c in conns.values():
            c.close()


assert not [m for m in sys.modules if m.split(".")[0] in (
    "torch", "seaweedfs_tpu_torch", "seaweedfs_tpu", "jax")]
if a["gate"]:  # one of several load processes: start on the parent's word
    print("ready", flush=True)
    sys.stdin.readline()
start = time.time()
t0 = time.perf_counter()
threads = [threading.Thread(target=worker) for _ in range(a["conns"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
with open(a["out"], "w") as f:
    json.dump({"n": len(lat), "bytes": moved[0], "wall": wall,
               "start": start, "end": time.time(),
               "lat": list(lat.values()),
               "etags": {str(k): v for k, v in etags.items()},
               "bad": bad}, f)
"""


def http_load(addr: str, vid: int, mode: str, ids, workdir: str,
              nbytes: int = SERVER_BYTES, seed: int = SEED + 12,
              reconnect: int = 0, procs: int = 1,
              targets: dict = None) -> dict:
    """Run the load process against `addr`: POST ("put") or GET the
    seeded needles `ids` (all of them when None; seeded_needles(nbytes,
    seed)) from SERVER_CONNS connections, each reopened every `reconnect`
    requests when nonzero; returns its report.  With `procs` > 1 the
    connections and the ids are split over that many load processes
    (contiguous slices), started together once each has made its data;
    the report merges theirs, its wall from the first start to the last
    end.  `targets` ({id: (server, path)}) sends each needle to its own
    server and path instead of `addr` and "/<vid>,<id><cookie>"."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if ids is None and procs > 1:
        ids = sorted(seeded_needles(nbytes, seed))
    slices = [ids] if procs == 1 else [
        ids[i * len(ids) // procs:(i + 1) * len(ids) // procs]
        for i in range(procs)]
    runs = []
    for i, part in enumerate(slices):
        out = os.path.join(workdir, f"load_{mode}_{time.monotonic_ns()}_"
                           f"{i}.json")
        spec = {"addr": addr, "vid": vid, "mode": mode, "ids": part or [],
                "nbytes": nbytes, "seed": seed, "min": NEEDLE_MIN,
                "max": NEEDLE_MAX, "conns": SERVER_CONNS // procs,
                "out": out, "reconnect": reconnect, "gate": procs > 1,
                "targets": {str(nid): list(targets[nid]) for nid in
                            (part or sorted(targets))} if targets else {}}
        with open(out + ".spec", "w") as f:
            json.dump(spec, f)
        proc = subprocess.Popen(
            [sys.executable, "-c", LOADER, out + ".spec"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=workdir, env=env)
        runs.append((proc, out))
    if procs > 1:
        for proc, _ in runs:
            check(proc.stdout.readline().strip() == "ready",
                  "a load process did not start")
        for proc, _ in runs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
    reports = []
    for proc, out in runs:
        _, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"the load process failed: {err}")
        with open(out) as f:
            reports.append(json.load(f))
    if procs == 1:
        return reports[0]
    merged = {"n": sum(r["n"] for r in reports),
              "bytes": sum(r["bytes"] for r in reports),
              "wall": (max(r["end"] for r in reports)
                       - min(r["start"] for r in reports)),
              "lat": [x for r in reports for x in r["lat"]],
              "etags": {k: v for r in reports for k, v in r["etags"].items()},
              "bad": [x for r in reports for x in r["bad"]]}
    return merged


def http_json(addr: str, path: str, payload=None, method=None):
    """One request to the server; any non-2xx reply fails the run."""
    from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call

    try:
        return call(addr, path, payload, method=method, timeout=3600)
    except RpcError as e:
        raise AssertionError(f"{path}: {e.status} {e}") from None


def server_phase(dev, workdir: str) -> dict:
    """Phase 8: a VolumeServer on the card over HTTP behind a dead master;
    returns the kernels' launches in it."""
    import socket

    from seaweedfs_tpu_torch.rpc import policy
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer

    check(native.lib() is not None, "the native host library did not build")
    vid = 8
    with socket.socket() as sock:  # a local port nothing listens on
        sock.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sock.getsockname()[1]}"
    needles = seeded_needles(SERVER_BYTES, SEED + 12)
    etag = {nid: "%08x" % crc_host.crc32c(data)
            for nid, (_, data) in needles.items()}
    total = sum(len(d) for _, d in needles.values())
    lookups = []
    real_call_policy = policy.call_policy

    def counted(addr, path, *a, **kw):
        lookups.append((time.monotonic(), path))
        return real_call_policy(addr, path, *a, **kw)

    policy.call_policy = counted
    policy.reset_state()
    rs_cuda.reset_launches()
    vs = VolumeServer([workdir], dead, port=0, ec_encoder_backend="cuda")
    vs.start()
    out = {}
    try:
        addr = vs.address
        check(vs.store.device is None, "the server's store was given a "
              "device: it should resolve the card itself")
        expo0 = exposition(http_get_text(addr, "/metrics"))
        http_json(addr, "/admin/assign_volume", {"volume": vid})
        put = http_load(addr, vid, "put", None, workdir)
        check(not put["bad"] and put["n"] == len(needles),
              f"PUT: {len(put['bad'])} failed, e.g. {put['bad'][:3]}")
        wrong = [nid for nid in needles if put["etags"][str(nid)] !=
                 etag[nid]]
        check(not wrong, f"{len(wrong)} acks' ETags are not the needles' "
              f"CRC32C, e.g. {wrong[:5]}")
        out["put_mib_s"] = total / MIB / put["wall"]
        out["put_req_s"] = put["n"] / put["wall"]
        out["put_p50_ms"] = pct_ms(put["lat"], 50)
        out["put_p99_ms"] = pct_ms(put["lat"], 99)
        out["put_wall_s"] = put["wall"]
        log(f"server: {put['n']} needles, {total} B POSTed raw from "
            f"{SERVER_CONNS} connections in {put['wall']:.3f} s: "
            f"{out['put_mib_s']:.1f} MiB/s, {out['put_req_s']:.0f} req/s, "
            f"p50 {out['put_p50_ms']:.3f} ms, p99 {out['put_p99_ms']:.3f} "
            "ms; every ETag = the needle's CRC32C")
        sample_ids = sorted(np.random.default_rng(SEED + 13).choice(
            sorted(needles), min(SERVER_SAMPLE, len(needles)),
            replace=False).tolist())
        intact = http_load(addr, vid, "get", sample_ids, workdir)
        check(not intact["bad"], f"intact GET: {intact['bad'][:3]}")
        out["get_intact_p50_ms"] = pct_ms(intact["lat"], 50)
        out["get_intact_p99_ms"] = pct_ms(intact["lat"], 99)
        out["get_intact_req_s"] = intact["n"] / intact["wall"]
        out["get_intact_mib_s"] = intact["bytes"] / MIB / intact["wall"]

        # the shell's ec.encode sequence on one holder
        http_json(addr, "/admin/readonly", {"volume": vid})
        dat = os.path.getsize(os.path.join(workdir, f"{vid}.dat"))
        k2 = rs_cuda.launches["fused_apply_crc"]
        t0 = time.perf_counter()
        http_json(addr, "/admin/ec/generate", {"volume": vid})
        out["generate_s"] = time.perf_counter() - t0
        k2 = rs_cuda.launches["fused_apply_crc"] - k2
        check(k2 > 0, "K2 did not launch in /admin/ec/generate")
        out["generate_gib_s"] = dat / (1 << 30) / out["generate_s"]
        http_json(addr, "/admin/ec/mount", {"volume": vid,
                                            "shard_ids": list(range(14))})
        http_json(addr, "/admin/delete_volume", {"volume": vid})
        http_json(addr, "/admin/ec/delete_shards",
                  {"volume": vid, "shard_ids": list(LOST)})
        base = os.path.join(workdir, str(vid))
        check(not any(os.path.exists(base + to_ext(s)) for s in LOST),
              "delete_shards left a lost shard on disk")
        log(f"server: /admin/ec/generate of {dat} B on the card in "
            f"{out['generate_s']:.3f} s ({out['generate_gib_s']:.3f} GiB/s, "
            f"{k2} K2 launches); 14 shards mounted, the volume deleted, "
            ".ec00 .ec05 .ec11 .ec13 dropped")

        # every needle behind the lost shards, from 8 connections
        recover.STATS.reset()
        before = exposition(http_get_text(addr, "/metrics"))
        k1 = rs_cuda.launches["gf_apply"]
        lookups.clear()
        t_window = time.monotonic()
        degraded = http_load(addr, vid, "get", None, workdir)
        window_s = time.monotonic() - t_window
        k1 = rs_cuda.launches["gf_apply"] - k1
        check(not degraded["bad"] and degraded["n"] == len(needles),
              f"degraded GET: {len(degraded['bad'])} failed, e.g. "
              f"{degraded['bad'][:3]}")
        wrong = [nid for nid in needles if degraded["etags"][str(nid)] !=
                 etag[nid]]
        check(not wrong, f"{len(wrong)} degraded GETs' ETags are not the "
              "needles' CRC32C")
        rst = http_json(addr, "/admin/ec/recover_stats")
        check(rst["batches"] > 0 and k1 == rst["batches"],
              f"{k1} K1 launches in the degraded window, "
              f"{rst['batches']} decode batches")
        after = exposition(http_get_text(addr, "/metrics"))
        check_recover_mirrors(before, after, rst)
        ec_lookups = [t for t, path in lookups if path.startswith(
            "/ec/lookup")]
        check(len(ec_lookups) <= window_s / 11.0 + 1,
              f"{len(ec_lookups)} EC location lookups to the dead master "
              f"in a {window_s:.1f} s window: the error tier did not hold")
        out["get_degraded_p50_ms"] = pct_ms(degraded["lat"], 50)
        out["get_degraded_p99_ms"] = pct_ms(degraded["lat"], 99)
        out["degraded_mib_s"] = degraded["bytes"] / MIB / degraded["wall"]
        out["degraded_req_s"] = degraded["n"] / degraded["wall"]
        out["degraded_wall_s"] = degraded["wall"]
        log(f"server: intact GET of {intact['n']} needles p50 "
            f"{out['get_intact_p50_ms']:.3f} ms p99 "
            f"{out['get_intact_p99_ms']:.3f} ms; degraded GET of all "
            f"{degraded['n']} from {SERVER_CONNS} connections in "
            f"{degraded['wall']:.3f} s ({out['degraded_mib_s']:.1f} MiB/s) "
            f"p50 {out['get_degraded_p50_ms']:.3f} ms p99 "
            f"{out['get_degraded_p99_ms']:.3f} ms; {k1} K1 launches = "
            f"{rst['batches']} decode batches ({rst['batched_spans']} "
            f"batched spans); {len(ec_lookups)} EC lookups to the dead "
            f"master in {window_s:.1f} s")

        # rebuild against the .vif CRCs, then scrub
        t0 = time.perf_counter()
        got = http_json(addr, "/admin/ec/rebuild", {"volume": vid})
        out["rebuild_s"] = time.perf_counter() - t0
        check(sorted(got["rebuilt_shard_ids"]) == list(LOST),
              f"rebuild gave {got}")
        stored = encoder.load_volume_info(base)["shard_crc32c"]
        for sid in LOST:
            with open(base + to_ext(sid), "rb") as f:
                check(crc_host.crc32c(f.read()) == stored[sid],
                      f"rebuilt .ec{sid:02d} does not match its .vif CRC")
        http_json(addr, "/admin/ec/mount", {"volume": vid,
                                            "shard_ids": list(LOST)})
        scrub = http_json(addr, "/admin/ec/scrub", {"volume": vid})
        check(scrub["clean"] == list(range(14)) and not scrub["corrupt"],
              f"scrub after the rebuild: {scrub}")
        log(f"server: /admin/ec/rebuild of {sorted(LOST)} in "
            f"{out['rebuild_s']:.3f} s, each equal to its .vif CRC; "
            "/admin/ec/scrub clean")

        # the scrape against the load process's own counts and the pool
        final = exposition(http_get_text(addr, "/metrics"))
        req = "SeaweedFS_volumeServer_request_total"
        writes = sample(final, req, type="write") - sample(expo0, req,
                                                           type="write")
        reads = sample(final, req, type="read") - sample(expo0, req,
                                                         type="read")
        check(writes == put["n"] and
              reads == intact["n"] + degraded["n"],
              f"request counters moved {writes} writes, {reads} reads; "
              f"the load process sent {put['n']} POSTs and "
              f"{intact['n'] + degraded['n']} GETs")
        check_pool_gauges(get_pool(), "server", final)
        log(f"server: /metrics ({final['_families']} families, "
            f"{final['_lines']} lines, parsed strictly): request counters "
            f"= the load process's {put['n']} POSTs and "
            f"{intact['n'] + degraded['n']} GETs, device-pool gauges = "
            "the pool, EcRecover* = /admin/ec/recover_stats")
    finally:
        policy.call_policy = real_call_policy
        vs.stop()
        policy.reset_state()
    launches = dict(rs_cuda.launches)
    PHASE_NUMBERS["server"] = out
    log("server numbers: " + json.dumps(out, sort_keys=True))
    log(f"launches on the server path: {launches}")
    return launches


# Phase 9's server, run in a fresh interpreter (fork + exec): it imports
# only the port (asserted), leaves CUDA uninitialized until its processes
# dispatch (asserted before the group forks), adds a /debug/ route that
# reports this process's kernel launches, decode batches and requests,
# and stops on SIGTERM.  "rehearse" runs it on the CPU with each kernel's
# plain version counted as the card counts the kernel.
PREFORK_SERVER = r"""
import json, os, signal, sys, threading

a = json.loads(sys.argv[1])
sys.path.insert(0, a["repo"])
import torch

from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.rpc import prefork
from seaweedfs_tpu_torch.storage.erasure_coding import recover
from seaweedfs_tpu_torch.volume_server.server import VolumeServer

bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu")]
assert not bad, bad
device = None
if a["rehearse"]:
    from seaweedfs_tpu_torch import device as device_mod
    from seaweedfs_tpu_torch.ops import rs_torch
    from seaweedfs_tpu_torch.parallel import batched_encode, mesh

    real_resolve, real_mesh = device_mod.resolve, mesh.make_ec_mesh
    device_mod.resolve = lambda d=None: real_resolve(
        "cpu" if d is None or str(d).startswith("cuda") else d)
    mesh.make_ec_mesh = batched_encode.make_ec_mesh = (
        lambda d=None: real_mesh("cpu" if d is None else d))
    batched_encode.words_capable = lambda *_: True
    real_k1, real_k2 = rs_torch.gf_apply, mesh.fused_apply_crc

    def k1(*args, **kw):
        rs_cuda.count_launch("gf_apply")
        return real_k1(*args, **kw)

    def k2(*args, **kw):
        rs_cuda.count_launch("fused_apply_crc")
        return real_k2(*args, **kw)

    rs_torch.gf_apply, mesh.fused_apply_crc = k1, k2
    os.environ["WEED_EC_RECOVER_DEVICE"] = "1"
vs = VolumeServer([a["dir"]], a["master"], port=a["port"],
                  ec_encoder_backend="cuda", enable_tcp=True)
assert not torch.cuda.is_initialized(), "CUDA initialized before the fork"


def smoke(req):
    return {"wid": prefork.worker_id(), "pid": os.getpid(),
            "role": prefork.role(), "launches": dict(rs_cuda.launches),
            "recover": recover.STATS.snapshot(),
            "reads": vs._req_counts["read"],
            "writes": vs._req_counts["write"],
            "cuda_initialized": torch.cuda.is_initialized(),
            "tcp_port": getattr(vs, "tcp_port", 0),
            "template": (vs.server._prefork.template_pid
                         if vs.server._prefork is not None else 0)}


vs.server.add("GET", "/debug/smoke", smoke)
vs.start()
done = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: done.set())
print("READY", flush=True)
done.wait()
vs.stop()
"""


def free_port() -> int:
    """A free local port below 45536 (the TCP fast path listens on the
    HTTP port + 20000)."""
    import socket

    while True:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if port < 45536:
            return port


def proc_alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/status") as f:
            state = [ln for ln in f if ln.startswith("State:")]
    except OSError:
        return False
    return bool(state) and "Z" not in state[0].split()[1]


class PreforkFleet:
    """Phase 9's server process (with `workers` processes) and its
    registry."""

    def __init__(self, workdir: str, data: str, master: str,
                 rehearse: bool, workers: int = PREFORK_WORKERS):
        self.workers = workers
        self.reg = os.path.join(workdir, f"registry_{workers}")
        os.makedirs(self.reg)
        self.port = free_port()
        self.addr = f"127.0.0.1:{self.port}"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(WEED_HTTP_WORKERS=str(workers),
                   WEED_PREFORK_DIR=self.reg)
        self.log_path = os.path.join(workdir, f"server_{workers}.log")
        self.log = open(self.log_path, "w")
        spec = {"repo": os.path.dirname(os.path.abspath(__file__)),
                "dir": data, "master": master, "port": self.port,
                "rehearse": rehearse}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", PREFORK_SERVER, json.dumps(spec)],
            env=env, cwd=workdir, stdout=subprocess.PIPE, stderr=self.log,
            text=True)
        ready, _, _ = select.select([self.proc.stdout], [], [], 300)
        line = self.proc.stdout.readline() if ready else ""
        if line.strip() != "READY":
            self.proc.kill()
            self.proc.wait(timeout=60)
        check(line.strip() == "READY", "the prefork server did not start: "
              + self.tail())
        if workers > 1:
            self.wait_registered()

    def tail(self) -> str:
        if not self.log.closed:
            self.log.flush()
        with open(self.log_path) as f:
            return f.read()[-4000:]

    def entries(self) -> dict:
        groups = [g for g in os.listdir(self.reg) if g.startswith("volume-")]
        check(len(groups) == 1, f"prefork registry groups {groups}")
        out, gdir = {}, os.path.join(self.reg, groups[0])
        for name in os.listdir(gdir):
            if name.startswith("w") and name.endswith(".json"):
                try:
                    with open(os.path.join(gdir, name)) as f:
                        e = json.load(f)
                except ValueError:
                    continue  # mid-write
                out[e["wid"]] = e
        return out

    def wait_registered(self, gone_pid: int = 0, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ent = self.entries()
            if len(ent) == self.workers and all(
                    e["pid"] != gone_pid for e in ent.values()):
                return ent
            check(self.proc.poll() is None, "the prefork server exited: "
                  + self.tail())
            time.sleep(0.1)
        check(False, f"workers never registered: {self.entries()}")

    def smoke(self) -> dict:
        """/debug/smoke of every process, through its own sideband."""
        if self.workers == 1:
            return {0: http_json(self.addr, "/debug/smoke")}
        return {wid: http_json(e["sideband"], "/debug/smoke")
                for wid, e in self.entries().items()}

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.proc.stdout.close()
        self.log.close()


def load_numbers(rep: dict, total_bytes: int = None) -> dict:
    n = rep["n"]
    return {"wall_s": rep["wall"], "n": n,
            "mib_s": (total_bytes if total_bytes is not None
                      else rep["bytes"]) / MIB / rep["wall"],
            "req_s": n / rep["wall"], "p50_ms": pct_ms(rep["lat"], 50),
            "p99_ms": pct_ms(rep["lat"], 99)}


def check_launches_are_batches(info: dict, where: str):
    for wid, w in info.items():
        check(w["launches"]["gf_apply"] == w["recover"]["batches"],
              f"{where}: worker {wid} launched K1 "
              f"{w['launches']['gf_apply']} times for "
              f"{w['recover']['batches']} decode batches")


def recover_samples(expo: dict, name: str) -> float:
    """The sum over every worker label of an EcRecover* counter."""
    p = "SeaweedFS_volumeServer_ec_recover_" + name
    return sum(v for k, v in expo.items() if isinstance(k, tuple)
               and k[0] == p)


def one_process_baseline(workdir: str, data: str, master: str,
                         ec_needles: dict, put_needles: dict, live: list,
                         rehearse: bool) -> dict:
    """The same server with WEED_HTTP_WORKERS=1 over the directory phase
    9's fleet left, driven as the fleet was: half of volume 1's degraded
    GETs from one load process, the other half from
    PREFORK_LOAD_PROCS (its block cache cold, as the fleet's was), and
    volume 2's live needles from one and from PREFORK_LOAD_PROCS."""
    base = PreforkFleet(workdir, data, master, rehearse, workers=1)
    out = {}
    try:
        ids = sorted(ec_needles)
        half = len(ids) // 2
        for key, part, procs, vid, nbytes, seed in (
                ("degraded", ids[:half], 1, 1, PREFORK_EC_BYTES, SEED + 20),
                ("degraded_split", ids[half:], PREFORK_LOAD_PROCS, 1,
                 PREFORK_EC_BYTES, SEED + 20),
                ("get_intact", live, 1, 2, PREFORK_PUT_BYTES, SEED + 21),
                ("get_intact_split", live, PREFORK_LOAD_PROCS, 2,
                 PREFORK_PUT_BYTES, SEED + 21)):
            rep = http_load(base.addr, vid, "get", part, workdir,
                            nbytes=nbytes, seed=seed,
                            reconnect=PREFORK_RECONNECT, procs=procs)
            check(not rep["bad"] and rep["n"] == len(part),
                  f"one-process {key}: {rep['bad'][:3]}")
            out[key] = load_numbers(rep)
        info = base.smoke()
        check_launches_are_batches(info, "the one-process server")
        out["launches"] = info[0]["launches"]
    finally:
        base.stop()
    check(base.proc.returncode == 0, "the one-process server exited "
          f"{base.proc.returncode}: " + base.tail())
    log("prefork: the same passes against WEED_HTTP_WORKERS=1 (MiB/s, "
        "req/s, p50 ms, p99 ms): " + json.dumps(
            {k: [round(v[m], 3) for m in ("mib_s", "req_s", "p50_ms",
                                          "p99_ms")]
             for k, v in out.items() if k != "launches"}))
    return out


def prefork_phase(dev, workdir: str, rehearse: bool = False) -> dict:
    """Phase 9: the volume server with WEED_HTTP_WORKERS=4 and the TCP
    fast path, started in a fresh interpreter over a directory holding an
    EC volume with 4 lost shards; returns the kernels' launches on the
    path, summed over this process (the setup encode) and every server
    process (the killed worker's counts read before the kill)."""
    from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call
    from seaweedfs_tpu_torch.wdclient.volume_tcp_client import \
        VolumeTcpClient

    check(native.lib() is not None, "the native host library did not build")
    rs_cuda.reset_launches()
    data = os.path.join(workdir, "data")
    os.makedirs(data)
    ec_needles = seeded_needles(PREFORK_EC_BYTES, SEED + 20)
    ec_etag = {nid: "%08x" % crc_host.crc32c(d)
               for nid, (_, d) in ec_needles.items()}
    store = Store([data], ec_encoder_backend="cuda")
    try:
        store.add_volume(1)
        store.add_volume(2)
        t0 = time.perf_counter()
        for nid, (cookie, blob) in ec_needles.items():
            n = Needle.create(blob)
            n.id, n.cookie = nid, cookie
            store.write_needle(1, n)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.ec_generate(1)
        gen_s = time.perf_counter() - t0
        store.delete_volume(1)
    finally:
        store.close()
    for sid in LOST:
        os.remove(os.path.join(data, "1" + to_ext(sid)))
    setup = dict(rs_cuda.launches)
    check(setup["fused_apply_crc"] > 0, "the setup encode launched no K2")
    ec_bytes = sum(len(d) for _, d in ec_needles.values())
    log(f"prefork: volume 1 set up: {len(ec_needles)} needles, {ec_bytes} "
        f"B written in {write_s:.3f} s, encoded on the card in "
        f"{gen_s:.3f} s ({setup['fused_apply_crc']} K2 launches), .dat/.idx "
        "and .ec00 .ec05 .ec11 .ec13 removed; volume 2 empty")
    import socket as _socket
    with _socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sock.getsockname()[1]}"
    fleet = PreforkFleet(workdir, data, dead, rehearse)
    out = {"usable_cores": platform.available_cpu_count()}
    totals = {"gf_apply": 0, "fused_apply_crc": 0}
    pids = set()
    try:
        addr = fleet.addr
        ent = fleet.entries()
        check(ent[0]["pid"] == fleet.proc.pid, "worker 0 is not the parent")
        info = fleet.smoke()
        template = info[0]["template"]
        pids |= {e["pid"] for e in ent.values()} | {template}
        check(not any(w["cuda_initialized"] for w in info.values()),
              f"a process made a CUDA context before any request: {info}")
        check(info[0]["tcp_port"] > 0, "the TCP fast path did not start")
        log(f"prefork: {PREFORK_WORKERS} processes on {addr} (parent pid "
            f"{fleet.proc.pid}, template {template}, workers "
            f"{sorted(e['pid'] for w, e in ent.items() if w)}); "
            f"{out['usable_cores']} usable cores; TCP port "
            f"{info[0]['tcp_port']}")

        # 3: every needle of volume 1, behind the lost shards: the first
        # half (by offset) from one load process, as phase 8; the second
        # from PREFORK_LOAD_PROCS, so whether the client or the server
        # bounds the rate shows without a warm block cache
        ids = sorted(ec_needles)
        half = len(ids) // 2
        deg = http_load(addr, 1, "get", ids[:half], workdir,
                        nbytes=PREFORK_EC_BYTES, seed=SEED + 20,
                        reconnect=PREFORK_RECONNECT)
        deg_split = http_load(addr, 1, "get", ids[half:], workdir,
                              nbytes=PREFORK_EC_BYTES, seed=SEED + 20,
                              reconnect=PREFORK_RECONNECT,
                              procs=PREFORK_LOAD_PROCS)
        etags = {**deg["etags"], **deg_split["etags"]}
        check(not deg["bad"] and not deg_split["bad"] and
              deg["n"] + deg_split["n"] == len(ec_needles),
              f"degraded GET: {len(deg['bad']) + len(deg_split['bad'])} "
              f"failed, e.g. {(deg['bad'] + deg_split['bad'])[:3]}")
        wrong = [nid for nid in ec_needles
                 if etags[str(nid)] != ec_etag[nid]]
        check(not wrong, f"{len(wrong)} degraded ETags are not CRC32C")
        info = fleet.smoke()
        check_launches_are_batches(info, "degraded GETs")
        k1_procs = [wid for wid, w in info.items()
                    if w["launches"]["gf_apply"] > 0]
        check(len(k1_procs) >= 3, f"K1 launched in processes {k1_procs} "
              "only; at least 3 of 4 must decode")
        out["degraded"] = load_numbers(deg)
        out["degraded_split"] = load_numbers(deg_split)
        log(f"prefork: degraded GET of {deg['n']} needles from one load "
            f"process in {deg['wall']:.3f} s ({out['degraded']['mib_s']:.1f}"
            f" MiB/s, {out['degraded']['req_s']:.0f} req/s, p50 "
            f"{out['degraded']['p50_ms']:.3f} ms, p99 "
            f"{out['degraded']['p99_ms']:.3f} ms); the other "
            f"{deg_split['n']} from {PREFORK_LOAD_PROCS} in "
            f"{deg_split['wall']:.3f} s "
            f"({out['degraded_split']['mib_s']:.1f} MiB/s, "
            f"{out['degraded_split']['req_s']:.0f} req/s, p50 "
            f"{out['degraded_split']['p50_ms']:.3f} ms, p99 "
            f"{out['degraded_split']['p99_ms']:.3f} ms); K1 launches = "
            "decode batches per process: " + json.dumps(
                {w: [i["launches"]["gf_apply"], i["recover"]["batches"]]
                 for w, i in info.items()}))

        # 4: PUTs (forwarded to the parent), GETs from the workers
        put_needles = seeded_needles(PREFORK_PUT_BYTES, SEED + 21)
        put_bytes = sum(len(d) for _, d in put_needles.values())
        put_etag = {nid: "%08x" % crc_host.crc32c(d)
                    for nid, (_, d) in put_needles.items()}
        reads0 = {w: i["reads"] for w, i in info.items()}
        put = http_load(addr, 2, "put", None, workdir,
                        nbytes=PREFORK_PUT_BYTES, seed=SEED + 21,
                        reconnect=PREFORK_RECONNECT)
        check(not put["bad"] and put["n"] == len(put_needles),
              f"PUT: {len(put['bad'])} failed, e.g. {put['bad'][:3]}")
        check(all(put["etags"][str(n)] == put_etag[n] for n in put_needles),
              "a PUT's ETag is not its needle's CRC32C")
        info = fleet.smoke()
        writes = {w: i["writes"] for w, i in info.items()}
        check(writes[0] == put["n"] and not any(
            writes[w] for w in writes if w),
            f"writes by process {writes}: all must land in the parent")
        got = http_load(addr, 2, "get", None, workdir,
                        nbytes=PREFORK_PUT_BYTES, seed=SEED + 21,
                        reconnect=PREFORK_RECONNECT)
        check(not got["bad"], f"GET of the PUTs: {got['bad'][:3]}")
        got_split = http_load(addr, 2, "get", None, workdir,
                              nbytes=PREFORK_PUT_BYTES, seed=SEED + 21,
                              reconnect=PREFORK_RECONNECT,
                              procs=PREFORK_LOAD_PROCS)
        check(not got_split["bad"] and got_split["n"] == len(put_needles),
              f"split GET of the PUTs: {got_split['bad'][:3]}")
        info = fleet.smoke()
        served = {w: i["reads"] - reads0[w] for w, i in info.items()}
        check(sum(1 for w, r in served.items() if w and r) >= 2,
              f"GETs of the PUTs served by process {served}")
        out["put"] = load_numbers(put, put_bytes)
        out["get_intact"] = load_numbers(got)
        out["get_intact_split"] = load_numbers(got_split)
        gone = sorted(put_needles)[:PREFORK_DELETES]
        for nid in gone:
            call(addr, "/2,%x%08x" % (nid, put_needles[nid][0]),
                 method="DELETE")
        for nid in gone:
            for e in fleet.entries().values():
                try:
                    call(e["sideband"], "/2,%x%08x" % (
                        nid, put_needles[nid][0]), parse=False)
                    check(False, f"worker {e['wid']} served deleted {nid}")
                except RpcError as err:
                    check(err.status == 404, f"deleted {nid} on worker "
                          f"{e['wid']}: {err.status} {err}")
        log(f"prefork: PUT {put['n']} needles ({put_bytes} B, forwarded "
            f"to the parent) in {put['wall']:.3f} s "
            f"({out['put']['mib_s']:.1f} MiB/s, {out['put']['req_s']:.0f} "
            f"req/s, p50 {out['put']['p50_ms']:.3f} ms, p99 "
            f"{out['put']['p99_ms']:.3f} ms); GET back in "
            f"{got['wall']:.3f} s ({out['get_intact']['mib_s']:.1f} MiB/s, "
            f"{out['get_intact']['req_s']:.0f} req/s, p50 "
            f"{out['get_intact']['p50_ms']:.3f} ms, p99 "
            f"{out['get_intact']['p99_ms']:.3f} ms), served by process "
            f"{served}; again from {PREFORK_LOAD_PROCS} load processes in "
            f"{got_split['wall']:.3f} s "
            f"({out['get_intact_split']['mib_s']:.1f} MiB/s, "
            f"{out['get_intact_split']['req_s']:.0f} req/s, p50 "
            f"{out['get_intact_split']['p50_ms']:.3f} ms, p99 "
            f"{out['get_intact_split']['p99_ms']:.3f} ms); {len(gone)} "
            "DELETEs then GET = 404 on every process")

        # 5: /admin/ec/generate of volume 2 runs K2 in the parent
        before = fleet.smoke()
        http_json(addr, "/admin/readonly", {"volume": 2})
        t0 = time.perf_counter()
        http_json(addr, "/admin/ec/generate", {"volume": 2})
        out["generate_s"] = time.perf_counter() - t0
        info = fleet.smoke()
        k2 = {w: i["launches"]["fused_apply_crc"]
              - before[w]["launches"]["fused_apply_crc"]
              for w, i in info.items()}
        check(k2[0] > 0 and not any(k2[w] for w in k2 if w),
              f"K2 launches of /admin/ec/generate by process {k2}")
        log(f"prefork: /admin/ec/generate of volume 2 in "
            f"{out['generate_s']:.3f} s, {k2[0]} K2 launches in the parent "
            "(after the forks), none in the workers")

        # 6: SIGKILL a worker; its respawn decodes through its own K1
        victim = fleet.entries()[2]
        for name in totals:
            totals[name] += info[2]["launches"][name]
        os.kill(victim["pid"], signal.SIGKILL)
        t0 = time.monotonic()
        ent = fleet.wait_registered(gone_pid=victim["pid"])
        out["respawn_s"] = time.monotonic() - t0
        fresh = ent[2]
        pids.add(fresh["pid"])
        ids = sorted(ec_needles)[:PREFORK_RESPAWN_GETS]
        rsp = http_load(fresh["sideband"], 1, "get", ids, workdir,
                        nbytes=PREFORK_EC_BYTES, seed=SEED + 20)
        check(not rsp["bad"], f"respawned worker's GETs: {rsp['bad'][:3]}")
        w2 = http_json(fresh["sideband"], "/debug/smoke")
        check(w2["pid"] == fresh["pid"] and w2["launches"]["gf_apply"] > 0
              and w2["launches"]["gf_apply"] == w2["recover"]["batches"],
              f"the respawned worker {w2}")
        log(f"prefork: worker 2 (pid {victim['pid']}) SIGKILLed, respawned "
            f"from the template as pid {fresh['pid']} in "
            f"{out['respawn_s']:.2f} s; it served {rsp['n']} degraded GETs "
            f"with {w2['launches']['gf_apply']} K1 launches = "
            f"{w2['recover']['batches']} decode batches")

        # 7: the TCP fast path, 8 threads
        live = [n for n in sorted(put_needles) if n not in set(gone)]
        tcp_ids = ([("2,%x%08x" % (n, put_needles[n][0]), put_needles[n][1])
                    for n in live[:PREFORK_TCP_READS]],
                   [("1,%x%08x" % (n, ec_needles[n][0]), ec_needles[n][1])
                    for n in sorted(ec_needles)[:PREFORK_TCP_READS]])
        check(all(len(items) == PREFORK_TCP_READS for items in tcp_ids),
              "too few needles for the TCP reads")
        client = VolumeTcpClient(max_conns_per_server=SERVER_CONNS)
        try:
            for label, items in zip(("tcp_intact", "tcp_degraded"),
                                    tcp_ids):
                def read(item):
                    t = time.perf_counter()
                    body = client.read_needle(addr, item[0])
                    return body == item[1], time.perf_counter() - t, \
                        len(body)
                t0 = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(
                        SERVER_CONNS) as ex:
                    res = list(ex.map(read, items))
                wall = time.perf_counter() - t0
                check(all(r[0] for r in res), f"{label}: a TCP read "
                      "differs from the needle")
                out[label] = {"n": len(res), "wall_s": wall,
                              "req_s": len(res) / wall,
                              "mib_s": sum(r[2] for r in res) / MIB / wall,
                              "p50_ms": pct_ms([r[1] for r in res], 50),
                              "p99_ms": pct_ms([r[1] for r in res], 99)}
        finally:
            client.close()
        log("prefork: TCP reads byte-equal from 8 threads: " + json.dumps(
            {k: out[k] for k in ("tcp_intact", "tcp_degraded")},
            sort_keys=True))

        # 8: the aggregated exposition against each process's stats
        info = fleet.smoke()
        expo = exposition(http_get_text(addr, "/metrics"))
        workers_seen = {dict(k[1]).get("worker") for k in expo
                        if isinstance(k, tuple) and k[0].startswith(
                            "SeaweedFS_volumeServer_ec_recover_")}
        check(workers_seen >= {str(w) for w in info},
              f"the merged exposition has workers {workers_seen}")
        for name, key in (("bytes_total", "recovered_bytes"),):
            check(recover_samples(expo, name) ==
                  sum(i["recover"][key] for i in info.values()),
                  f"EcRecover {name} over the workers "
                  f"{recover_samples(expo, name)} != the processes' "
                  f"{sum(i['recover'][key] for i in info.values())}")
        spans = recover_samples(expo, "spans_total")
        check(spans == sum(i["recover"]["spans"] for i in info.values()),
              f"EcRecover spans over the workers {spans} != the processes'")
        native_reads = sum(v for k, v in expo.items() if isinstance(k, tuple)
                           and k[0].startswith(
                               "SeaweedFS_volumeServer_native")
                           and dict(k[1]).get("type") in ("read", "ec_read"))
        check(native_reads >= 2 * PREFORK_TCP_READS,
              f"{native_reads} native TCP reads for "
              f"{2 * PREFORK_TCP_READS} TCP reads")
        log(f"prefork: /metrics merged over workers {sorted(workers_seen)} "
            f"({expo['_families']} families, {expo['_lines']} lines, parsed "
            f"strictly): EcRecover bytes and spans = the processes' "
            f"recover stats; native TCP reads {native_reads:.0f}")
        for wid, i in info.items():
            for name in totals:
                totals[name] += i["launches"][name]
        check_launches_are_batches(info, "the whole phase")
    finally:
        fleet.stop()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(proc_alive(p) for p in pids):
        time.sleep(0.2)
    left = [p for p in pids if proc_alive(p)]
    check(not left, f"processes of the group left after SIGTERM: {left}")
    check(fleet.proc.returncode == 0, "the prefork server exited "
          f"{fleet.proc.returncode}: " + fleet.tail())
    check(not os.listdir(fleet.reg), "the prefork registry was left")
    log(f"prefork: SIGTERM to the parent; none of {sorted(pids)} remains, "
        "registry removed")
    one = one_process_baseline(workdir, data, dead, ec_needles, put_needles,
                               live, rehearse)
    one_launches = one.pop("launches")
    out["one_process"] = one
    for name in totals:
        totals[name] += one_launches[name]
    ph8 = PHASE_NUMBERS.get("server")
    if ph8:
        out["phase8"] = {
            "put": {"mib_s": ph8["put_mib_s"], "req_s": ph8["put_req_s"],
                    "p50_ms": ph8["put_p50_ms"], "p99_ms": ph8["put_p99_ms"],
                    "wall_s": ph8["put_wall_s"]},
            "get_intact": {"mib_s": ph8["get_intact_mib_s"],
                           "req_s": ph8["get_intact_req_s"],
                           "p50_ms": ph8["get_intact_p50_ms"],
                           "p99_ms": ph8["get_intact_p99_ms"]},
            "degraded": {"mib_s": ph8["degraded_mib_s"],
                         "req_s": ph8["degraded_req_s"],
                         "p50_ms": ph8["get_degraded_p50_ms"],
                         "p99_ms": ph8["get_degraded_p99_ms"],
                         "wall_s": ph8["degraded_wall_s"]}}
    PHASE_NUMBERS["prefork"] = out
    log("prefork numbers (phase 8's single process beside them): "
        + json.dumps(out, sort_keys=True))
    launches = {name: setup[name] + totals[name] for name in totals}
    log(f"launches on the prefork path: {launches}")
    return launches


# -- phase 10: a cluster that heals itself ------------------------------------


def wait_until(pred, timeout: float, what: str, interval: float = 0.02):
    """Poll `pred` until it returns a truthy value; fail the run with
    `what` after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        check(time.monotonic() < deadline, f"timed out: {what}")
        time.sleep(interval)


def ec_holders(addr: str, vid: int) -> dict:
    """{shard id: [holder urls]} from the master's /ec/lookup."""
    ec = http_json(addr, f"/ec/lookup?volumeId={vid}")
    return {e["shard_id"]: [loc["url"] for loc in e["locations"]]
            for e in ec["shard_id_locations"]}


def shard_files(servers, vid: int) -> dict:
    """{shard id: (server, path)} of volume `vid`'s shard files on the
    servers' disks (the first copy of each)."""
    found = {}
    for vs in servers:
        base = os.path.join(vs.store.locations[0].directory, str(vid))
        for sid in range(14):
            if sid not in found and os.path.exists(base + to_ext(sid)):
                found[sid] = (vs, base + to_ext(sid))
    return found


def crc_clean_shards(servers, vid: int) -> list:
    """The shard ids whose file on disk holds its .vif CRC."""
    good = []
    for sid, (vs, path) in sorted(shard_files(servers, vid).items()):
        stored = encoder.load_volume_info(path[:-len(to_ext(sid))])
        with open(path, "rb") as f:
            if crc_host.crc32c(f.read()) == stored["shard_crc32c"][sid]:
                good.append(sid)
    return good


def cluster_phase(dev, workdir: str) -> dict:
    """Phase 10: three masters in one raft group and three volume servers
    on the card, each with its maintenance worker; writes through the
    master client's fid leases, the shell's ec.encode, a leader failover,
    four shards lost and healed by the curator's ec.rebuild job, a deep
    scrub clean and then finding a flipped parity byte that the next
    rebuild repairs.  Returns the kernels' launches in it."""
    import threading

    from seaweedfs_tpu_torch.maintenance.jobs import (TYPE_DEEP_SCRUB,
                                                      TYPE_EC_REBUILD)
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.rpc import policy
    from seaweedfs_tpu_torch.rpc.http_rpc import call
    from seaweedfs_tpu_torch.shell import commands as sh
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer
    from seaweedfs_tpu_torch.wdclient import FidLeaseCache, MasterClient

    out = {}
    per_server: dict = {}
    ran = []  # (server, job, report, t0, t1) of every job a worker ran
    lock = threading.Lock()

    def note(url: str, name: str, n: int):
        row = per_server.setdefault(url, dict.fromkeys(KERNELS, 0))
        row[name] += n

    def recording(vs):
        real = vs.maintenance_worker._execute

        def execute(job):
            t0 = time.monotonic()
            report = real(job)
            with lock:
                ran.append((vs.address, job, report, t0, time.monotonic()))
            return report

        vs.maintenance_worker._execute = execute

    def ran_job(type_: str, vid: int, after: int):
        with lock:
            return next((r for r in ran[after:] if r[1]["type"] == type_
                         and r[1]["volume"] == vid), None)

    def leader_of(group):
        ls = [m for m in group if m.raft.is_leader]
        return ls[0] if len(ls) == 1 else None

    masters, servers, mc, stopped = [], [], None, set()
    # the needles (the load process makes the same ones) and their CRCs,
    # before any daemon starts: making 1 GiB holds the interpreter lock
    # for seconds, which would starve the masters' raft heartbeats
    needles = seeded_needles(CLUSTER_BYTES, SEED + 20)
    total = sum(len(d) for _, d in needles.values())
    etag = {nid: "%08x" % crc_host.crc32c(data)
            for nid, (_, data) in needles.items()}
    t_phase = time.monotonic()
    log(f"cluster: knobs {CLUSTER_KNOBS} (WEED_MAINT_RATE_MB raised so "
        "the pacer does not set the scrub's pace)")
    # maintenance starts after the bulk load and its encode (the curators
    # are enabled below): a tick between two holders' mounts of one
    # encode would see a partial shard set and queue a needless rebuild
    with knobs(**CLUSTER_KNOBS, WEED_MAINT="0"):
        policy.reset_state()
        rs_cuda.reset_launches()
        ports = set()
        while len(ports) < CLUSTER_SIZE:
            ports.add(free_port())
        addrs = [f"127.0.0.1:{p}" for p in sorted(ports)]
        try:
            for i, port in enumerate(sorted(ports)):
                d = os.path.join(workdir, f"master{i}")
                os.makedirs(d)
                m = MasterServer(port=port, peers=list(addrs), raft_dir=d,
                                 volume_size_limit_mb=CLUSTER_LIMIT_MB,
                                 default_replication="000",
                                 pulse_seconds=CLUSTER_PULSE)
                m.start()
                masters.append(m)
            leader = wait_until(lambda: leader_of(masters), 30,
                                "no raft leader among three masters")
            for i in range(CLUSTER_SIZE):
                d = os.path.join(workdir, f"volume{i}")
                os.makedirs(d)
                vs = VolumeServer([d], ",".join(addrs), port=0,
                                  data_center="dc1", rack=f"rack{i + 1}",
                                  pulse_seconds=CLUSTER_PULSE,
                                  ec_encoder_backend="cuda")
                check(vs.store.device is None, "the server's store was "
                      "given a device: it should resolve the card itself")
                recording(vs)
                vs.start()
                servers.append(vs)
            wait_until(lambda: len(leader.topo.nodes) == CLUSTER_SIZE, 30,
                       "the volume servers' heartbeats never reached the "
                       "leader")
            log(f"cluster: masters {addrs} (leader {leader.address}), "
                f"volume servers {[vs.address for vs in servers]}")

            # -- writes: fids from the master client's batched leases
            mc = MasterClient(list(addrs), name="chip_smoke")
            mc.start()
            calls = [0]

            def assign(n, replication="", collection="", ttl=""):
                calls[0] += 1
                return mc.assign(count=n, replication=replication,
                                 collection=collection, ttl=ttl)

            cache = FidLeaseCache(assign, name="chip_smoke")
            t0 = time.perf_counter()
            fids = {nid: cache.get() for nid in needles}
            assign_s = time.perf_counter() - t0
            out["assign_req_s"] = len(fids) / assign_s
            out["assign_master_calls"] = calls[0]
            targets = {}
            for nid, a in fids.items():
                urls = mc.lookup_file_id(a["fid"])
                check(urls == [f"{a['url']}/{a['fid']}"],
                      f"{a['fid']}: /dir/lookup gave {urls}, the assign "
                      f"{a['url']}")
                targets[nid] = (a["url"], "/" + a["fid"])
            log(f"cluster: {len(fids)} fids through the master client's "
                f"leases in {assign_s:.3f} s ({out['assign_req_s']:.0f} "
                f"assigns/s, {calls[0]} master calls); each fid's volume "
                "looked up through /dir/lookup")
            put = http_load(addrs[0], 0, "put", None, workdir,
                            nbytes=CLUSTER_BYTES, seed=SEED + 20,
                            targets=targets)
            check(not put["bad"] and put["n"] == len(needles),
                  f"PUT: {len(put['bad'])} failed, e.g. {put['bad'][:3]}")
            wrong = [n for n in needles if put["etags"][str(n)] != etag[n]]
            check(not wrong, f"{len(wrong)} acks' ETags are not the "
                  "needles' CRC32C")
            out["put_mib_s"] = total / MIB / put["wall"]
            out["put_req_s"] = put["n"] / put["wall"]
            out["put_p50_ms"] = pct_ms(put["lat"], 50)
            out["put_p99_ms"] = pct_ms(put["lat"], 99)
            by_vid: dict = {}
            for nid, a in fids.items():
                by_vid.setdefault(int(a["fid"].split(",")[0]),
                                  []).append(nid)
            log(f"cluster: {put['n']} needles, {total} B POSTed from "
                f"{SERVER_CONNS} connections to their holders in "
                f"{put['wall']:.3f} s: {out['put_mib_s']:.1f} MiB/s, "
                f"{out['put_req_s']:.0f} req/s, p50 "
                f"{out['put_p50_ms']:.3f} ms, p99 {out['put_p99_ms']:.3f} "
                "ms; needles by volume "
                + json.dumps({v: len(n) for v, n in sorted(by_vid.items())}))

            # -- the shell's ec.encode of every volume that holds needles
            for vs in servers:
                vs.heartbeat_once()
            env = sh.CommandEnv(leader.address)
            t0 = time.perf_counter()
            for vid in sorted(by_vid):
                source = mc.lookup(vid)[0]["url"]
                k2 = rs_cuda.launches["fused_apply_crc"]
                plan = sh.ec_encode(env, vid)
                note(source, "fused_apply_crc",
                     rs_cuda.launches["fused_apply_crc"] - k2)
                check(len(plan["allocation"]) == CLUSTER_SIZE,
                      f"ec.encode of {vid} spread over "
                      f"{len(plan['allocation'])} servers")
            out["encode_s"] = time.perf_counter() - t0
            check(per_server and all(r["fused_apply_crc"] > 0
                                     for r in per_server.values()),
                  "K2 did not launch on an encoding holder")
            for vs in servers:
                vs.heartbeat_once()

            def settled(master, v):
                """14 shards of `v`, each on one holder (a rebuild's
                copied survivors gone from the master's view too)."""
                held = ec_holders(master.address, v)
                return len(held) == 14 and all(
                    len(urls) == 1 for urls in held.values())

            def all_encoded(master):
                return all(settled(master, v) for v in by_vid)

            wait_until(lambda: all_encoded(leader), 30,
                       "the encoded volumes' 14 shards never all showed")
            log(f"cluster: ec.encode of {len(by_vid)} volumes in "
                f"{out['encode_s']:.3f} s, K2 on each source "
                + json.dumps({u: r["fused_apply_crc"]
                              for u, r in sorted(per_server.items())})
                + "; 14 shards of each spread over the three servers")
            for m in masters:  # maintenance on, the bulk load is in
                m.curator.enabled = True
                m.curator.start()

            # -- failover: the raft leader stops
            old = leader
            t0 = time.monotonic()
            old.stop()
            stopped.add(old.address)
            rest = [m for m in masters if m is not old]
            leader = wait_until(lambda: leader_of(rest), 30,
                                "no new raft leader")
            out["elect_s"] = time.monotonic() - t0
            wait_until(lambda: len(leader.topo.nodes) == CLUSTER_SIZE
                       and all_encoded(leader), 30,
                       "the heartbeats never failed over to the new leader")
            out["heartbeats_s"] = time.monotonic() - t0

            def assigned():
                try:
                    return mc.assign()
                except Exception:
                    return None

            first = wait_until(assigned, 30, "assigns did not go on")
            out["failover_s"] = time.monotonic() - t0
            writes = [first] + [mc.assign() for _ in range(31)]
            rng = np.random.default_rng(SEED + 21)
            bodies = [rng.bytes(4096 + i) for i in range(len(writes))]
            for a, body in zip(writes, bodies):
                call(a["url"], "/" + a["fid"], raw=body, method="POST")
            for a, body in zip(writes, bodies):
                check(call(a["url"], "/" + a["fid"], parse=False) == body,
                      "a write after the failover did not read back")
            log(f"cluster: leader {old.address} stopped; {leader.address} "
                f"elected in {out['elect_s']:.3f} s, every heartbeat on it "
                f"after {out['heartbeats_s']:.3f} s, the first assign after "
                f"{out['failover_s']:.3f} s; 32 writes through new assigns "
                "read back")
            # the new leader's health plane sees the stopped master down:
            # its availability alert queues a deep.scrub of every EC
            # volume, which must run before the loss the phase measures
            # (as many as the new leader's topology held when it fired)
            wait_until(lambda: "availability" in leader.health.firing(),
                       30, "the stopped master fired no availability alert")
            out["stop_to_alert_s"] = time.monotonic() - t0
            rounds = leader.health.rounds
            wait_until(lambda: leader.health.rounds >= rounds + 1
                       and not leader.curator.queue.jobs(), 120,
                       "the alert's maintenance jobs never drained")
            log(f"cluster: the health plane fired availability "
                f"{out['stop_to_alert_s']:.3f} s after the stop; the "
                f"{sum(1 for r in ran if r[1]['type'] == TYPE_DEEP_SCRUB)} "
                "deep scrubs it queued ran, with "
                f"{sum(1 for r in ran if r[1]['type'] == TYPE_EC_REBUILD)} "
                "ec.rebuild jobs")

            # -- the loss, with leasing paused while every needle is read
            env = sh.CommandEnv(leader.address)
            vid = max(sorted(by_vid), key=lambda v: len(by_vid[v]))
            holders = ec_holders(leader.address, vid)
            base_any = shard_files(servers, vid)[1][1][:-len(to_ext(1))]
            stored = encoder.load_volume_info(base_any)["shard_crc32c"]
            shard_bytes = os.path.getsize(shard_files(servers, vid)[1][1])
            http_json(leader.address, "/maintenance/pause", {"paused": True})
            n_ran = len(ran)
            t_loss = time.monotonic()
            for sid in LOST:
                for url in holders[sid]:
                    http_json(url, "/admin/ec/delete_shards",
                              {"volume": vid, "shard_ids": [sid]})

            def rebuild_queued():
                return next((j for j in leader.curator.queue.jobs()
                             if j["type"] == TYPE_EC_REBUILD
                             and j["volume"] == vid), None)

            job = wait_until(rebuild_queued, 30,
                             "the curator never queued ec.rebuild")
            out["loss_to_queued_s"] = time.monotonic() - t_loss
            check(set(job["params"]["missing"]) <= set(LOST)
                  and job["params"]["missing"], f"queued {job}")
            check(all(sid not in ec_holders(leader.address, vid)
                      for sid in LOST), "a lost shard is still listed")
            log(f"cluster: volume {vid} ({len(by_vid[vid])} needles, "
                f"{shard_bytes} B shards) lost .ec00 .ec05 .ec11 .ec13; "
                f"the new leader's curator queued {job['id']} "
                f"(ec.rebuild, missing {job['params']['missing']}) through "
                f"raft after {out['loss_to_queued_s']:.3f} s")

            # every needle of the volume while the job is pending, by GET
            # through /ec/lookup, a third from each holder in turn
            ec = http_json(leader.address, f"/ec/lookup?volumeId={vid}")
            readers = sorted({loc["url"] for e in ec["shard_id_locations"]
                              for loc in e["locations"]})
            check(len(readers) == CLUSTER_SIZE, f"holders {readers}")
            ids = sorted(by_vid[vid])
            lat, got_bytes, wall = [], 0, 0.0
            for i, url in enumerate(readers):
                part = ids[i::len(readers)]
                recover.STATS.reset()
                k1 = rs_cuda.launches["gf_apply"]
                rep = http_load(url, vid, "get", part, workdir,
                                nbytes=CLUSTER_BYTES, seed=SEED + 20,
                                targets={n: (url, targets[n][1])
                                         for n in part})
                k1 = rs_cuda.launches["gf_apply"] - k1
                batches = recover.STATS.snapshot()["batches"]
                check(not rep["bad"] and rep["n"] == len(part),
                      f"degraded GET from {url}: {rep['bad'][:3]}")
                wrong = [n for n in part if rep["etags"][str(n)] != etag[n]]
                check(not wrong, f"{len(wrong)} degraded GETs' ETags are "
                      "not the needles' CRC32C")
                check(batches > 0 and k1 == batches,
                      f"{url}: {k1} K1 launches, {batches} decode batches")
                note(url, "gf_apply", k1)
                lat += rep["lat"]
                got_bytes += rep["bytes"]
                wall += rep["wall"]
                out.setdefault("degraded_k1_by_server", {})[url] = k1
            check(rebuild_queued() is not None and len(ran) == n_ran,
                  "the rebuild ran while leasing was paused")
            out["get_degraded_p50_ms"] = pct_ms(lat, 50)
            out["get_degraded_p99_ms"] = pct_ms(lat, 99)
            out["degraded_mib_s"] = got_bytes / MIB / wall
            log(f"cluster: every needle of volume {vid} read by GET while "
                f"the job was pending ({len(ids)} needles from "
                f"{len(readers)} holders in turn, {SERVER_CONNS} "
                f"connections): {out['degraded_mib_s']:.1f} MiB/s, p50 "
                f"{out['get_degraded_p50_ms']:.3f} ms, p99 "
                f"{out['get_degraded_p99_ms']:.3f} ms; K1 launches = decode "
                "batches on each server "
                + json.dumps(out["degraded_k1_by_server"]))

            # leasing on: a worker leases the job and rebuilds through K2
            k2 = rs_cuda.launches["fused_apply_crc"]
            t_unpause = time.monotonic()
            http_json(leader.address, "/maintenance/pause",
                      {"paused": False})
            done = wait_until(lambda: ran_job(TYPE_EC_REBUILD, vid, n_ran),
                              120, "no worker ran the ec.rebuild job")
            out["unpause_to_leased_s"] = done[3] - t_unpause
            wait_until(lambda: settled(leader, vid), 30,
                       f"volume {vid} never showed 14 shards again")
            t_healthy = time.monotonic()
            k2 = rs_cuda.launches["fused_apply_crc"] - k2
            check(k2 > 0, "K2 did not launch in the rebuild job")
            rebuilder = shard_files(servers, vid)[LOST[0]][0].address
            note(rebuilder, "fused_apply_crc", k2)
            check(crc_clean_shards(servers, vid) == list(range(14)),
                  "a shard of the rebuilt volume does not hold its .vif "
                  "CRC")
            hist = wait_until(lambda: [h for h in leader.curator.queue
                                       .history if h["id"] == job["id"]],
                              30, "the rebuild job never completed")
            check(hist[0]["outcome"] == "ok", f"rebuild job: {hist[0]}")
            out["rebuild_job_s"] = done[4] - done[3]
            out["rebuild_gib_s"] = (10 * shard_bytes / (1 << 30)
                                    / out["rebuild_job_s"])
            out["leased_to_healthy_s"] = t_healthy - done[3]
            out["time_to_recover_s"] = (out["loss_to_queued_s"]
                                        + t_healthy - t_unpause)
            log(f"cluster: {job['id']} leased by {done[0]} "
                f"{out['unpause_to_leased_s']:.3f} s after leasing resumed, "
                f"ran {out['rebuild_job_s']:.3f} s "
                f"({out['rebuild_gib_s']:.3f} GiB/s of data shards, {k2} K2 "
                f"launches on the rebuilder {rebuilder}), 14 healthy shards "
                f"{out['leased_to_healthy_s']:.3f} s after the lease, each "
                "equal to its .vif CRC; time to recover (loss to queued, "
                "then leasing resumed to 14 healthy shards) "
                f"{out['time_to_recover_s']:.3f} s")

            # -- deep scrub through K5's K1 form: clean, then a flipped byte.
            # The failover's stopped master fired the health plane's
            # availability alert, which queued a deep.scrub of every EC
            # volume: let those finish first, so the forced job is the
            # one measured
            scrubs = []
            for flip in (False, True):
                wait_until(lambda: not leader.curator.queue.jobs(), 120,
                           "the alert's maintenance jobs never drained")
                if flip:
                    _, path = shard_files(servers, vid)[12]
                    flip_byte(path, shard_bytes // 2)
                n_before = len(ran)
                k1 = rs_cuda.launches["gf_apply"]
                http_json(leader.address, "/maintenance/run",
                          {"type": TYPE_DEEP_SCRUB, "volume": vid})
                r = wait_until(lambda: ran_job(TYPE_DEEP_SCRUB, vid,
                                               n_before), 120,
                               "no worker ran the deep.scrub job")
                k1 = rs_cuda.launches["gf_apply"] - k1
                check(k1 > 0, "K1 did not launch in the deep scrub")
                note(r[0], "gf_apply", k1)
                report = r[2]
                scrubs.append({"server": r[0], "k1": k1,
                               "seconds": r[4] - r[3],
                               "bytes": report["bytes"],
                               "corrupt": report["corrupt"],
                               "parity_mismatch": report["parity_mismatch"],
                               "ok": report["ok"]})
                if not flip:
                    check(report["ok"], f"deep scrub not clean: {report}")
                    continue
                check(sorted(set(report["corrupt"])
                             | set(report["parity_mismatch"])) == [12],
                      f"the flipped byte of .ec12 reported as {report}")
                n_before = len(ran)
                k2 = rs_cuda.launches["fused_apply_crc"]
                r = wait_until(lambda: ran_job(TYPE_EC_REBUILD, vid,
                                               n_before), 120,
                               "no ec.rebuild followed the scrub's finding")
                check(r[1]["params"].get("from") == "deep.scrub",
                      f"the repair job was {r[1]}")
                wait_until(lambda: crc_clean_shards(servers, vid)
                           == list(range(14)) and settled(leader, vid), 30,
                           ".ec12 was not repaired")
                k2 = rs_cuda.launches["fused_apply_crc"] - k2
                check(k2 > 0, "K2 did not launch in the repair")
                note(shard_files(servers, vid)[12][0].address,
                     "fused_apply_crc", k2)
                out["repair_job_s"] = r[4] - r[3]
            out["scrub"] = scrubs
            out["deep_scrub_gib_s"] = (scrubs[0]["bytes"] / (1 << 30)
                                       / scrubs[0]["seconds"])
            log(f"cluster: deep.scrub of volume {vid} on {scrubs[0]['server']}"
                f" clean in {scrubs[0]['seconds']:.3f} s "
                f"({out['deep_scrub_gib_s']:.3f} GiB/s of "
                f"{scrubs[0]['bytes']} B, {scrubs[0]['k1']} K1 launches); "
                "one byte of .ec12 flipped: the next scrub reported "
                f"corrupt {scrubs[1]['corrupt']} parity_mismatch "
                f"{scrubs[1]['parity_mismatch']}, and the ec.rebuild it "
                f"queued repaired it in {out['repair_job_s']:.3f} s")

            # -- strictness: every job ok, none leased twice
            status = http_json(leader.address, "/maintenance/status")
            queue = http_json(leader.address, "/maintenance/queue")
            check(not queue["jobs"], f"jobs left: {queue['jobs']}")
            bad = [h for h in queue["history"]
                   if h["outcome"] != "ok" or h["attempts"] != 1]
            check(not bad, f"jobs failed or leased twice: {bad}")
            check(all(vs.maintenance_worker.failed == 0 for vs in servers),
                  "a maintenance worker failed a job")
            out["launches_by_server"] = per_server
            log("cluster: K1 and K2 launches by server "
                + json.dumps(per_server, sort_keys=True))
            log("cluster: /maintenance/status " + json.dumps(
                {k: status[k] for k in ("leader", "scans", "enqueued",
                                        "queue")}, sort_keys=True))
            log("cluster: queue history " + json.dumps(
                [{k: h[k] for k in ("id", "type", "volume", "worker",
                                    "outcome", "attempts")}
                 for h in queue["history"]]))
        finally:
            if mc is not None:
                mc.stop()
            for vs in servers:
                vs.stop()
            for m in masters:
                if m.address not in stopped:
                    m.stop()
            policy.reset_state()
    launches = dict(rs_cuda.launches)
    out["wall_s"] = time.monotonic() - t_phase
    PHASE_NUMBERS["cluster"] = out
    log("cluster numbers: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("scrub",)},
        sort_keys=True))
    log(f"launches on the cluster path: {launches}")
    return launches


# -- phase 11: a cluster of separate processes through a node death ----------

# Phase 11's load process, in a fresh interpreter that imports no torch:
# the port's load generator (stdlib only) and numpy.  "preload" POSTs
# each object to the fid the phase assigned; "replay" builds the
# schedule from the WEED_LOAD_* knobs and replays it open-loop from
# forked processes, each request under its tenant's and class's headers,
# writing one record per request.  An object's bytes are a pure function
# of (seed, index), so every process makes the same ones.
ELASTIC_LOADER = r"""
import http.client, json, os, sys, threading, time, zlib
import numpy as np

with open(sys.argv[1]) as f:
    a = json.load(f)
sys.path.insert(0, a["repo"])
from seaweedfs_tpu_torch import loadgen


def payload(key, size):
    return np.random.default_rng([a["seed"], key]).bytes(size)


class Conns(threading.local):
    def get(self, addr):
        if not hasattr(self, "c"):
            self.c = {}
        if addr not in self.c:
            host, port = addr.split(":")
            self.c[addr] = http.client.HTTPConnection(host, int(port),
                                                      timeout=30)
        return self.c[addr]

    def drop(self, addr):
        c = getattr(self, "c", {}).pop(addr, None)
        if c is not None:
            c.close()


conns = Conns()


def request(addr, method, path, body=None, headers=None):
    for attempt in (0, 1):  # a kept-alive connection the server closed
        conn = conns.get(addr)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        except (http.client.RemoteDisconnected, BrokenPipeError,
                ConnectionResetError):
            conns.drop(addr)
            if attempt:
                raise
        except OSError:
            conns.drop(addr)
            raise


def transfer():  # POST ("preload") or GET and check ("get") each target
    targets, sizes = a["targets"], a["sizes"]
    counter, lock = iter(range(len(targets))), threading.Lock()
    lat, bad, moved = [], [], [0]

    def worker():
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            obj, url, fid = targets[i][:3]
            span = targets[i][3:]  # [lo, hi]: a Range GET of those bytes
            data = payload(obj, sizes[obj])
            t0 = time.perf_counter()
            if a["mode"] == "preload":
                status, body = request(url, "POST", "/" + fid, data)
                ok = status in (200, 201)
            elif span:
                data = data[span[0]:span[1] + 1]
                status, body = request(url, "GET", "/" + fid, headers={
                    "Range": "bytes=%d-%d" % tuple(span)})
                ok = status == 206 and body == data
            else:
                status, body = request(url, "GET", "/" + fid)
                ok = status == 200 and body == data
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                moved[0] += len(data)
                if not ok:
                    bad.append([obj, status, body[:200].decode("latin-1")])

    threads = [threading.Thread(target=worker) for _ in range(a["conns"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"n": len(lat), "wall": time.perf_counter() - t0, "lat": lat,
            "bytes": moved[0], "bad": bad}


def replay():
    fids, sizes, masters = a["fids"], a["sizes"], a["masters"]
    locs, lock = {}, threading.Lock()

    def lookup(vid, fresh=False):
        with lock:
            if not fresh and vid in locs:
                return locs[vid]
        for m in masters:
            try:
                status, body = request(m, "GET",
                                       "/dir/lookup?volumeId=%d" % vid)
            except OSError:
                continue
            if status == 200:
                urls = [loc["url"] for loc in json.loads(body)["locations"]]
                with lock:
                    locs[vid] = urls
                return urls
        return []

    files = {}

    def record(rec):
        pid = os.getpid()  # one file per forked replay process
        if pid not in files:
            files[pid] = open(os.path.join(a["dir"], "req_%d.log" % pid),
                              "a", buffering=1)
        files[pid].write(json.dumps(rec) + "\n")

    def get(req):
        fid = fids[req.obj]
        vid = int(fid.split(",")[0])
        for fresh in (False, True):
            for url in lookup(vid, fresh):
                try:
                    status, body = request(url, "GET", "/" + fid)
                except OSError:
                    continue  # a dead holder: the next location
                if status == 200:
                    return body == payload(req.obj, sizes[req.obj]), True
        return False, False

    def put(req, n):
        key = (1 << 40) + n
        data = payload(key, req.size)
        for m in masters:
            try:
                status, body = request(m, "GET", "/dir/assign")
            except OSError:
                continue
            if status != 200:
                continue
            asg = json.loads(body)
            try:
                status, _ = request(asg["url"], "POST", "/" + asg["fid"],
                                    data)
            except OSError:
                return None
            if status in (200, 201):
                return asg["fid"], key, zlib.crc32(data)
            return None
        return None

    seq = iter(range(1 << 62))

    def send(req):
        t0 = time.time()
        if req.op == "GET":
            right, ok = get(req)
            rec = {"t": t0, "op": "GET", "cls": req.qos_class, "ok": ok,
                   "wrong": ok and not right, "obj": req.obj}
        else:
            with lock:
                n = next(seq)
            acked = put(req, n + 1000000 * os.getpid())
            rec = {"t": t0, "op": "PUT", "cls": req.qos_class,
                   "ok": acked is not None, "wrong": False,
                   "ack": list(acked) if acked else None,
                   "size": req.size}
        rec["lat"] = time.time() - t0
        record(rec)
        return rec["ok"] and not rec["wrong"]

    schedule = loadgen.build_schedule()
    print("schedule %d %.3f" % (len(schedule), time.time()), flush=True)
    summary = loadgen.replay(schedule, send, workers=a["workers"],
                             processes=a["processes"])
    return {"summary": summary, "requests": len(schedule)}


bad_mods = [m for m in sys.modules
            if m.split(".")[0] in ("torch", "jax", "seaweedfs_tpu")]
assert not bad_mods, bad_mods
result = replay() if a["mode"] == "replay" else transfer()
with open(a["out"], "w") as f:
    json.dump(result, f)
"""


def cli(args, env, log_path):
    """Start `python -m seaweedfs_tpu_torch <args>`, a process of its
    own, its errors appended to `log_path`."""
    with open(log_path, "a") as log_f:
        return subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch"] + list(args),
            env=env, cwd=os.path.dirname(log_path), stdout=subprocess.PIPE,
            stderr=log_f, text=True)


def listening(proc, name: str, log_path: str):
    """Wait for a daemon's "listening on" line; fail the run with its
    log if it does not come."""
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    line = proc.stdout.readline() if ready else ""
    if "listening on" not in line:
        proc.kill()
        proc.wait(timeout=30)
        with open(log_path) as f:
            check(False, f"{name} did not start: {line!r} "
                  f"{f.read()[-3000:]}")


def cli_run(args, env, timeout: float = 300, raw: bool = False):
    """Run one command of the port's CLI to its end; returns its output
    (bytes with `raw`)."""
    res = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch"] + list(args),
        env=env, capture_output=True, text=not raw, timeout=timeout)
    check(res.returncode == 0, f"{args[:2]} exited {res.returncode}: "
          f"{res.stdout[-2000:]!r} {res.stderr[-2000:]!r}")
    return res.stdout


def loader_run(spec: dict, workdir: str, env: dict, tag: str,
               background: bool = False):
    """ELASTIC_LOADER with `spec` in a fresh interpreter; waits for its
    report unless `background` (then returns the process)."""
    out = os.path.join(workdir, f"elastic_{tag}.json")
    spec = dict(spec, out=out, repo=os.path.dirname(
        os.path.abspath(__file__)))
    with open(out + ".spec", "w") as f:
        json.dump(spec, f)
    proc = subprocess.Popen(
        [sys.executable, "-c", ELASTIC_LOADER, out + ".spec"], env=env,
        cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    if background:
        return proc, out
    _, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"the {tag} load process failed: {err}")
    with open(out) as f:
        return json.load(f)


def elastic_payload(seed: int, key: int, size: int) -> bytes:
    return np.random.default_rng([seed, key]).bytes(size)


def process_counts(url: str) -> dict:
    """One server process's kernel launches, deep-scrub parity steps and
    decode batches, from its own routes."""
    dev = http_json(url, "/debug/pprof/device")
    rec = http_json(url, "/admin/ec/recover_stats")
    return {"gf_apply": dev["launches"]["gf_apply"],
            "fused_apply_crc": dev["launches"]["fused_apply_crc"],
            "scrub_steps": dev["scrub_steps"], "batches": rec["batches"]}


def proc_tree_pids(root: str) -> list:
    """Pids of live processes whose command line names `root`."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode("latin-1")
        except OSError:
            continue
        if root in cmd and proc_alive(int(name)):
            pids.append(int(name))
    return pids


def elastic_phase(dev, workdir: str, rehearse: bool = False) -> dict:
    """Phase 11: three masters and five volume servers, each a process of
    its own started through the port's CLI; 256 MiB of the load
    generator's objects, every volume EC-encoded by the shell's CLI (K2),
    open-loop traffic from forked load processes, the volume server
    holding the most shards SIGKILLed: the health plane sees it and
    alerts, the curator heals every volume (K2) and scales the cluster
    (a sixth server through the CLI) while degraded GETs decode through
    K1; the dead node restarted over its directory, the alert cleared, a
    forced deep scrub of every volume clean (K1).  Returns the kernels'
    launches in it, summed over the server processes.  `rehearse` runs
    the servers on the CPU and skips the launch counts (CPU tensors run
    the plain versions and count nothing)."""
    from seaweedfs_tpu_torch.loadgen import SizeMixture
    from seaweedfs_tpu_torch.maintenance.jobs import (TYPE_DEEP_SCRUB,
                                                      TYPE_EC_REBUILD,
                                                      TYPE_SCALE_UP)
    from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call
    from seaweedfs_tpu_torch.wdclient import FidLeaseCache, MasterClient

    out: dict = {}
    t_phase = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ELASTIC_KNOBS, PYTHONPATH=repo,
               WEED_SCALE_DIR=os.path.join(workdir, "scale"))
    os.makedirs(env["WEED_SCALE_DIR"])
    device_flag = ["-device", "cpu"] if rehearse else []
    log(f"elastic: knobs {ELASTIC_KNOBS}")

    # the objects: the load generator's size mixture, bytes from (seed, i)
    sizes_gen = SizeMixture(seed=SEED + 30)
    sizes, total = [], 0
    while total < ELASTIC_BYTES:
        sizes.append(sizes_gen.sample(len(sizes)))
        total += sizes[-1]
    n_obj = len(sizes)
    env["WEED_LOAD_OBJECTS"] = str(n_obj)
    seed = SEED + 31

    procs: dict = {}  # name -> Popen
    mports = []
    while len(mports) < 3:
        p = free_port()
        if p not in mports:
            mports.append(p)
    maddrs = [f"127.0.0.1:{p}" for p in mports]
    vports = []
    while len(vports) < ELASTIC_SERVERS:
        p = free_port()
        if p not in vports and p not in mports:
            vports.append(p)
    vaddrs = [f"127.0.0.1:{p}" for p in vports]

    def volume_args(i):
        d = os.path.join(workdir, f"volume{i}")
        return (["volume", "-dir", d, "-port", str(vports[i]),
                 "-mserver", ",".join(maddrs), "-rack", f"rack{i + 1}",
                 "-dataCenter", "dc1", "-pulseSeconds",
                 str(ELASTIC_PULSE), "-ecBackend", "cuda"] + device_flag)

    def leader() -> str:
        for m in maddrs:
            if procs.get(m) is None or procs[m].poll() is not None:
                continue
            try:
                st = http_json(m, "/cluster/status")
            except (AssertionError, OSError):
                continue
            if st.get("IsLeader"):
                return m
        return ""

    def nodes(m: str) -> list:
        st = http_json(m, "/dir/status")
        return sorted(n["url"] for dc in st["datacenters"]
                      for r in dc["racks"] for n in r["nodes"])

    def events_since(m: str, seq: int) -> list:
        return http_json(m, f"/cluster/events?since={seq}")["events"]

    mc = None
    try:
        # -- 1. the cluster: every process through the port's CLI
        t0 = time.monotonic()
        starting = []
        for i, m in enumerate(maddrs):
            d = os.path.join(workdir, f"master{i}")
            os.makedirs(d)
            starting.append((m, ["master", "-port", str(mports[i]),
                                 "-mdir", d, "-peers", ",".join(maddrs),
                                 "-volumeSizeLimitMB",
                                 str(CLUSTER_LIMIT_MB),
                                 "-defaultReplication", "000",
                                 "-pulseSeconds", str(ELASTIC_PULSE)]))
        for i, v in enumerate(vaddrs):
            os.makedirs(os.path.join(workdir, f"volume{i}"))
            starting.append((v, volume_args(i)))
        def log_of(name):
            return os.path.join(workdir, name.replace(":", "_") + ".log")

        for name, args in starting:  # started together, awaited after
            procs[name] = cli(args, env, log_of(name))
        for name, proc in procs.items():
            listening(proc, name, log_of(name))
        lead = wait_until(leader, 60, "no raft leader among the masters")
        wait_until(lambda: nodes(lead) == sorted(vaddrs), 60,
                   "the volume servers never all registered")
        out["start_s"] = time.monotonic() - t0
        log(f"elastic: masters {maddrs} (leader {lead}), volume servers "
            f"{vaddrs}, each a process of the port's CLI, up in "
            f"{out['start_s']:.3f} s")
        check(http_json(lead, "/maintenance/pause", {"paused": True})
              ["paused"], "maintenance did not pause")

        # -- 2. preload through the master client's fid leases
        mc = MasterClient(list(maddrs), name="chip_smoke")
        mc.start()
        cache = FidLeaseCache(
            lambda n, replication="", collection="", ttl="": mc.assign(
                count=n, replication=replication, collection=collection,
                ttl=ttl), name="chip_smoke")
        t0 = time.perf_counter()
        leased = [cache.get() for _ in range(n_obj)]
        out["assign_req_s"] = n_obj / (time.perf_counter() - t0)
        fids = [a["fid"] for a in leased]
        targets = [[i, a["url"], a["fid"]] for i, a in enumerate(leased)]
        parts = [targets[i::ELASTIC_LOADERS]
                 for i in range(ELASTIC_LOADERS)]
        t0 = time.perf_counter()
        runs = [loader_run({"mode": "preload", "seed": seed,
                            "sizes": sizes, "targets": part,
                            "conns": ELASTIC_CONNS}, workdir, env,
                           f"preload{i}", background=True)
                for i, part in enumerate(parts)]
        reps = []
        for (proc, path), i in zip(runs, range(len(runs))):
            _, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"preload process failed: {err}")
            with open(path) as f:
                reps.append(json.load(f))
        put_wall = time.perf_counter() - t0
        bad = [b for r in reps for b in r["bad"]]
        check(not bad and sum(r["n"] for r in reps) == n_obj,
              f"preload: {len(bad)} failed, e.g. {bad[:3]}")
        lat = [x for r in reps for x in r["lat"]]
        out.update(preload_objects=n_obj, preload_bytes=total,
                   preload_s=put_wall,
                   preload_mib_s=total / MIB / put_wall,
                   preload_req_s=n_obj / put_wall,
                   preload_p50_ms=pct_ms(lat, 50),
                   preload_p99_ms=pct_ms(lat, 99))
        by_vid: dict = {}
        for i, fid in enumerate(fids):
            by_vid.setdefault(int(fid.split(",")[0]), []).append(i)
        log(f"elastic: {n_obj} objects ({total} B, the load generator's "
            f"size mixture) POSTed to their fids' holders by "
            f"{ELASTIC_LOADERS} load processes of {ELASTIC_CONNS} "
            f"connections in {put_wall:.3f} s: "
            f"{out['preload_mib_s']:.1f} MiB/s, "
            f"{out['preload_req_s']:.0f} req/s, p50 "
            f"{out['preload_p50_ms']:.3f} ms, p99 "
            f"{out['preload_p99_ms']:.3f} ms; fids leased at "
            f"{out['assign_req_s']:.0f}/s; objects by volume "
            + json.dumps({v: len(o) for v, o in sorted(by_vid.items())}))

        # -- the shell's ec.encode of every volume, through the CLI (K2)
        before = {v: process_counts(v) for v in vaddrs}
        t0 = time.perf_counter()
        text = cli_run(["shell", "-master", lead, "-c",
                        "; ".join(f"ec.encode {v}" for v in sorted(by_vid))],
                       env)
        out["encode_s"] = time.perf_counter() - t0
        check(not [ln for ln in text.splitlines()
                    if ln.startswith("error")], f"ec.encode: {text[-3000:]}")

        def spread(v):
            held = ec_holders(lead, v)
            if len(held) != 14 or any(len(u) != 1 for u in held.values()):
                return None
            per: dict = {}
            for urls in held.values():
                per[urls[0]] = per.get(urls[0], 0) + 1
            return per

        wait_until(lambda: all(spread(v) for v in by_vid), 60,
                   "the encoded volumes' 14 shards never all showed")
        spreads = {v: spread(v) for v in sorted(by_vid)}
        most = max(max(p.values()) for p in spreads.values())
        check(most <= 4, f"a server holds {most} shards of one volume: "
              "RS(10,4) would lose data with it")
        k2_src = {v: process_counts(v)["fused_apply_crc"]
                  - before[v]["fused_apply_crc"] for v in vaddrs}
        if not rehearse:
            check(sum(k2_src.values()) > 0, "K2 did not launch in encode")
        out["max_shards_per_server"] = most
        log(f"elastic: ec.encode of {len(by_vid)} volumes through the "
            f"shell's CLI in {out['encode_s']:.3f} s, K2 by server "
            f"{json.dumps(k2_src)}; at most {most} shards of a volume on "
            "one server (/ec/lookup)")

        # -- maintenance on; the plane must see every target up
        http_json(lead, "/maintenance/pause", {"paused": False})
        wait_until(lambda: not http_json(lead, "/maintenance/queue")[
            "jobs"], 120, "maintenance jobs of the encode never drained")
        rounds0 = http_json(lead, "/cluster/health")["scrape"]["rounds"]

        def healthy():
            h = http_json(lead, "/cluster/health")
            return (h["scrape"]["rounds"] >= rounds0 + 3
                    and h["status"] == "ok"
                    and len(h["nodes"]) == 3 + ELASTIC_SERVERS
                    and all(n["up"] for n in h["nodes"].values())
                    and not http_json(lead, "/cluster/alerts")["alerts"])

        wait_until(healthy, 60, "the health plane never read ok")
        seq0 = http_json(lead, "/cluster/events?since=0")["seq"]
        hist0 = len(http_json(lead, "/maintenance/queue")["history"])

        # -- 3. traffic: open-loop replay from forked load processes
        traffic, traffic_out = loader_run(
            {"mode": "replay", "seed": seed, "sizes": sizes, "fids": fids,
             "masters": [lead] + [m for m in maddrs if m != lead],
             "dir": workdir, "workers": ELASTIC_REPLAY_THREADS,
             "processes": ELASTIC_REPLAY_PROCS}, workdir,
            dict(env, WEED_LOAD_SEED=str(seed + 1),
                 WEED_LOAD_DURATION=str(ELASTIC_DURATION)), "replay",
            background=True)
        ready, _, _ = select.select([traffic.stdout], [], [], 120)
        line = traffic.stdout.readline() if ready else ""
        check(line.startswith("schedule "), f"the replay did not start: "
              f"{line!r}")
        t_traffic = float(line.split()[2])
        time.sleep(max(0.0, t_traffic + ELASTIC_KILL_AFTER - time.time()))

        # -- 4. the kill: the server holding the most shards
        counts_by: dict = {}
        for v, per in spreads.items():
            for url, n in per.items():
                counts_by[url] = counts_by.get(url, 0) + n
        victim = max(sorted(counts_by), key=lambda u: counts_by[u])
        victim_i = vaddrs.index(victim)
        pre_kill = {v: process_counts(v) for v in vaddrs}
        hit = sorted(v for v, per in spreads.items() if victim in per)
        t_kill = time.time()
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        log(f"elastic: SIGKILL {victim} ({counts_by[victim]} shards, of "
            f"volumes {hit}) {t_kill - t_traffic:.3f} s into the traffic")
        originals = set(vaddrs)

        def newcomer():
            lead_now = leader()
            if not lead_now:
                return None
            extra = [u for u in nodes(lead_now) if u not in originals]
            return extra[0] if extra else None

        new_url = wait_until(newcomer, 120, "scale.up never added a "
                             "server")
        out["kill_to_newcomer_s"] = time.time() - t_kill

        def whole(v):
            held = ec_holders(leader() or lead, v)
            return len(held) == 14 and all(
                any(u != victim for u in urls) for urls in held.values())

        wait_until(lambda: all(whole(v) for v in by_vid), 120,
                   "the lost shards were never rebuilt")
        t_whole = time.time()
        out["kill_to_whole_s"] = t_whole - t_kill
        lead = leader() or lead
        evs = events_since(lead, seq0)
        q = http_json(lead, "/maintenance/queue")
        log("elastic: jobs from the encode to the heal, s from the kill "
            + json.dumps([{
                "type": j["type"], "volume": j["volume"],
                "worker": j.get("worker"), "outcome": j.get("outcome"),
                "attempts": j.get("attempts"),
                "from": (j.get("params") or {}).get("from")
                or (j.get("params") or {}).get("alert"),
                "created": round(j.get("created_at", 0) - t_kill, 3),
                "finished": round(j.get("finished_at", 0) - t_kill, 3)
                if j.get("finished_at") else None,
                "error": j.get("last_error") or None}
                for j in q["history"] + q["jobs"]]))

        def first(kind, node=None, after=0.0):
            return next((e for e in evs if e["kind"] == kind
                         and (node is None or e["node"] == node)
                         and e["ts"] >= after), None)

        down = first("node.down", victim)
        fire = first("alert.fire", "availability")
        check(down is not None and fire is not None,
              f"journal: down {down}, fire {fire}")
        check(down["seq"] < fire["seq"], "ALERT_FIRE before NODE_DOWN")
        jobs = [e for e in evs if e["kind"] in ("job.enqueued", "scale.up")
                and e["ts"] >= t_kill]
        check(jobs, "no job was queued after the kill")
        out["kill_to_node_down_s"] = down["ts"] - t_kill
        out["kill_to_alert_fire_s"] = fire["ts"] - t_kill
        out["down_to_fire_s"] = fire["ts"] - down["ts"]
        out["kill_to_first_job_s"] = min(e["ts"] for e in jobs) - t_kill
        check(out["down_to_fire_s"] <= 10.0,
              f"availability fired {out['down_to_fire_s']:.3f} s after "
              "NODE_DOWN (bound 10 s)")
        log(f"elastic: from the kill, by the journal: NODE_DOWN "
            f"{out['kill_to_node_down_s']:.3f} s, ALERT_FIRE availability "
            f"{out['kill_to_alert_fire_s']:.3f} s, first job queued "
            f"{out['kill_to_first_job_s']:.3f} s; newcomer {new_url} in "
            f"/dir/status after {out['kill_to_newcomer_s']:.3f} s; every "
            f"volume at 14 shards after {out['kill_to_whole_s']:.3f} s")

        # -- 5. the dead node restarted over its directory
        t_restart = time.time()
        procs[victim] = cli(volume_args(victim_i), env, log_of(victim))
        listening(procs[victim], victim, log_of(victim))
        wait_until(lambda: victim in nodes(leader() or lead), 60,
                   "the restarted server never registered")

        def cleared():
            lead_now = leader() or lead
            clear = next((e for e in events_since(lead_now, seq0)
                          if e["kind"] == "alert.clear"
                          and e["node"] == "availability"
                          and e["seq"] > fire["seq"]), None)
            h = http_json(lead_now, "/cluster/health")
            return clear if clear and h["status"] == "ok" else None

        clear = wait_until(cleared, 90, "the availability alert never "
                           "cleared, or /cluster/health never read ok")
        t_ok = time.time()
        out["kill_to_alert_clear_s"] = clear["ts"] - t_kill
        out["restart_to_ok_s"] = t_ok - t_restart
        log(f"elastic: {victim} restarted through the CLI; ALERT_CLEAR "
            f"{out['kill_to_alert_clear_s']:.3f} s after the kill, "
            f"/cluster/health ok {out['restart_to_ok_s']:.3f} s after the "
            "restart")

        # -- 6. the traffic's verdict, per class and window
        _, err = traffic.communicate(timeout=ELASTIC_DURATION + 300)
        check(traffic.returncode == 0, f"the replay failed: {err}")
        with open(traffic_out) as f:
            rep = json.load(f)
        recs = []
        for name in os.listdir(workdir):
            if name.startswith("req_") and name.endswith(".log"):
                with open(os.path.join(workdir, name)) as f:
                    recs += [json.loads(ln) for ln in f if ln.strip()]
        check(len(recs) == rep["requests"], f"{len(recs)} records for "
              f"{rep['requests']} scheduled requests")
        wrong = [r for r in recs if r["wrong"]]
        check(not wrong, f"{len(wrong)} GETs read wrong bytes: {wrong[:3]}")
        windows = {"before": (0, t_kill), "outage": (t_kill, t_whole),
                   "healed": (t_whole, 1e18)}
        table = {}
        for wname, (lo, hi) in windows.items():
            for cls in ("interactive", "standard", "background", "all"):
                sel = [r for r in recs if lo <= r["t"] < hi
                       and (cls == "all" or r["cls"] == cls)]
                span = (min(hi, max((r["t"] for r in sel), default=lo))
                        - max(lo, t_traffic)) if sel else 0.0
                ok = [r["lat"] for r in sel if r["ok"]]
                table[f"{wname}/{cls}"] = {
                    "requests": len(sel),
                    "failures": sum(not r["ok"] for r in sel),
                    "get_failures": sum(not r["ok"] for r in sel
                                        if r["op"] == "GET"),
                    "p50_ms": pct_ms(ok, 50), "p99_ms": pct_ms(ok, 99),
                    "rps": len(sel) / span if span > 0 else 0.0}
        out["traffic"] = table
        out["traffic_summary"] = rep["summary"]
        for k, row in sorted(table.items()):
            log(f"elastic: traffic {k}: " + json.dumps(row, sort_keys=True))

        # every acknowledged object reads back right: the preload and the
        # replay's acked PUTs
        acked = [r["ack"] for r in recs if r["op"] == "PUT" and r["ok"]]
        lead = leader() or lead

        def read_back(fid):
            vid = int(fid.split(",")[0])
            try:
                found = call(lead, f"/dir/lookup?volumeId={vid}")
            except RpcError as e:
                views = {}
                for m in maddrs + sorted(set(vaddrs) | {new_url}):
                    try:
                        st = call(m, "/dir/status" if m in maddrs
                                  else "/admin/status")
                    except (RpcError, OSError) as e2:
                        views[m] = str(e2)
                        continue
                    views[m] = json.dumps(st)[:3000]
                check(False, f"acked {fid}: lookup {e}; views {views}")
            urls = [loc["url"] for loc in found["locations"]]
            for url in urls:
                try:
                    return call(url, "/" + fid, parse=False)
                except (RpcError, OSError):
                    continue
            raise AssertionError(f"{fid}: no holder served it")

        import zlib

        for fid, key, crc in acked:
            check(zlib.crc32(read_back(fid)) == crc,
                  f"acked PUT {fid} read back wrong")
        rng = np.random.default_rng(SEED + 32)
        picks = sorted(set(int(i) for i in rng.integers(
            0, n_obj, ELASTIC_READBACK)))
        for i in picks:
            check(read_back(fids[i]) == elastic_payload(seed, i, sizes[i]),
                  f"object {i} ({fids[i]}) read back wrong")
        out["acked_puts"] = len(acked)
        log(f"elastic: {len(acked)} acked PUTs of the replay and "
            f"{len(picks)} preloaded objects read back right after the "
            "heal; no GET of the replay read wrong bytes")

        # -- the kernels in every server process: K1 = decode batches
        # plus the deep scrubs' parity steps (before the forced scrubs)
        live = sorted(set(vaddrs) | {new_url})
        mid = {v: process_counts(v) for v in live}
        if not rehearse:
            for v, c in mid.items():
                check(c["gf_apply"] == c["batches"] + c["scrub_steps"],
                      f"{v}: {c['gf_apply']} K1 launches for "
                      f"{c['batches']} decode batches and "
                      f"{c['scrub_steps']} scrub parity steps")
        out["decode_batches"] = {v: c["batches"] for v, c in mid.items()}
        log("elastic: per server process, after the heal "
            + json.dumps(mid, sort_keys=True))

        # -- a forced deep.scrub of every volume: clean, through K1
        n_hist = len(http_json(lead, "/maintenance/queue")["history"])
        t0 = time.perf_counter()
        for v in sorted(by_vid):
            http_json(lead, "/maintenance/run",
                      {"type": TYPE_DEEP_SCRUB, "volume": v})

        def scrubs_done():
            q = http_json(leader() or lead, "/maintenance/queue")
            done = [h for h in q["history"][n_hist:]
                    if h["type"] == TYPE_DEEP_SCRUB]
            pend = [j for j in q["jobs"] if j["type"] == TYPE_DEEP_SCRUB]
            return (done, q) if not pend and len(done) >= len(by_vid) \
                else None

        done, q = wait_until(scrubs_done, 300, "the forced deep scrubs "
                             "never finished")
        out["scrub_all_s"] = time.perf_counter() - t0
        check(all(h["outcome"] == "ok" for h in done),
              f"a deep scrub failed: {done}")
        repairs = [j for j in q["jobs"] + q["history"][n_hist:]
                   if j["type"] == TYPE_EC_REBUILD
                   and j["params"].get("from") == "deep.scrub"]
        check(not repairs, f"the forced scrubs found damage: {repairs}")
        end = {v: process_counts(v) for v in live}
        scrub_k1 = {v: end[v]["gf_apply"] - mid[v]["gf_apply"]
                    for v in live}
        if not rehearse:
            check(sum(scrub_k1.values()) > 0, "K1 did not launch in the "
                  "deep scrubs")
            for v, c in end.items():
                check(c["gf_apply"] == c["batches"] + c["scrub_steps"],
                      f"{v}: K1 {c['gf_apply']} after the scrubs")
        log(f"elastic: forced deep.scrub of {len(by_vid)} volumes clean in "
            f"{out['scrub_all_s']:.3f} s, K1 by server "
            + json.dumps(scrub_k1, sort_keys=True))

        # -- degraded GETs per server process, as phase 10 reads them in
        # one interpreter: leasing paused, .ec00 .ec05 .ec11 .ec13 of the
        # biggest volume dropped, every object of it GET, a share from
        # each holder process in turn; then the curator heals it
        vid = max(sorted(by_vid), key=lambda v: len(by_vid[v]))
        http_json(lead, "/maintenance/pause", {"paused": True})
        held = ec_holders(lead, vid)
        for sid in LOST:
            for url in held[sid]:
                http_json(url, "/admin/ec/delete_shards",
                          {"volume": vid, "shard_ids": [sid]})
        wait_until(lambda: all(sid not in ec_holders(lead, vid)
                               for sid in LOST), 30,
                   "the dropped shards stayed listed")
        readers = sorted({u for urls in ec_holders(lead, vid).values()
                          for u in urls})
        objs = sorted(by_vid[vid])
        burst = {}
        for i, url in enumerate(readers):
            part = objs[i::len(readers)]
            c0 = process_counts(url)
            rep = loader_run({"mode": "get", "seed": seed, "sizes": sizes,
                              "targets": [[o, url, fids[o]] for o in part],
                              "conns": SERVER_CONNS}, workdir, env,
                             f"degraded{i}")
            c1 = process_counts(url)
            check(not rep["bad"] and rep["n"] == len(part),
                  f"degraded GET from {url}: {rep['bad'][:3]}")
            k1 = c1["gf_apply"] - c0["gf_apply"]
            batches = c1["batches"] - c0["batches"]
            if not rehearse:
                check(batches > 0 and k1 == batches
                      and c1["scrub_steps"] == c0["scrub_steps"],
                      f"{url}: {k1} K1 launches for {batches} decode "
                      "batches")
            burst[url] = {"objects": rep["n"], "k1": k1,
                          "batches": batches,
                          "mib_s": rep["bytes"] / MIB / rep["wall"],
                          "req_s": rep["n"] / rep["wall"],
                          "p50_ms": pct_ms(rep["lat"], 50),
                          "p99_ms": pct_ms(rep["lat"], 99)}
        out["degraded_by_process"] = burst
        log(f"elastic: volume {vid} lost .ec00 .ec05 .ec11 .ec13 with "
            f"leasing paused; every object of it ({len(objs)}) GET, a share "
            f"from each holder process in turn ({SERVER_CONNS} "
            "connections): " + json.dumps(burst, sort_keys=True))
        t0 = time.monotonic()
        http_json(lead, "/maintenance/pause", {"paused": False})
        def settled(v):  # 14 shards listed, whoever holds them now
            return len(ec_holders(lead, v)) == 14

        wait_until(lambda: settled(vid), 120, f"volume {vid} never healed")
        out["burst_heal_s"] = time.monotonic() - t0
        log(f"elastic: volume {vid} back at 14 shards "
            f"{out['burst_heal_s']:.3f} s after leasing resumed")

        # every shard file on every disk holds its .vif CRC
        dirs = [os.path.join(workdir, f"volume{i}")
                for i in range(ELASTIC_SERVERS)]
        for root, _, files in os.walk(env["WEED_SCALE_DIR"]):
            if any(f.endswith(".ecx") for f in files):
                dirs.append(root)
        shards_checked = 0
        for d in dirs:
            for v in by_vid:
                base = os.path.join(d, str(v))
                if not os.path.exists(base + ".vif"):
                    continue
                stored = encoder.load_volume_info(base)["shard_crc32c"]
                for sid in range(14):
                    path = base + to_ext(sid)
                    if os.path.exists(path):
                        with open(path, "rb") as f:
                            data = f.read()
                        if crc_host.crc32c(data) != stored[sid]:
                            held = ec_holders(lead, v).get(sid)
                            sizes_of = sorted({os.path.getsize(
                                base + to_ext(j)) for j in range(14)
                                if os.path.exists(base + to_ext(j))})
                            check(False, f"{path} ({len(data)} B, shard "
                                  f"sizes there {sizes_of}, holders "
                                  f"{held}, mtime "
                                  f"{os.path.getmtime(path) - t_kill:.3f}"
                                  " s after the kill) does not hold its "
                                  ".vif CRC")
                        shards_checked += 1
        out["shard_files_checked"] = shards_checked
        log(f"elastic: {shards_checked} shard files on the servers' "
            "disks, each equal to its .vif CRC")

        # -- the health plane's own numbers, the CLI and the shell
        h = http_json(lead, "/cluster/health")
        expo = exposition(http_get_text(lead, "/metrics"))
        out["plane"] = {
            "rounds": h["scrape"]["rounds"], "duty": h["scrape"]["duty"],
            "tsdb": h["tsdb"],
            "scrape_errors_dead_target": sample(
                expo, "SeaweedFS_cluster_scrape_errors_total",
                target=victim)}
        check(out["plane"]["scrape_errors_dead_target"] > 0,
              "no scrape error counted for the dead target")
        log("elastic: health plane on the leader "
            + json.dumps(out["plane"], sort_keys=True))
        # four CLI processes at once: each one's time is its interpreter
        with concurrent.futures.ThreadPoolExecutor(4) as pool_:
            top, lint, scale, qos_view = pool_.map(
                lambda args: cli_run(args, env),
                (["top", "-master", lead, "-once"], ["lint-dashboards"],
                 ["shell", "-master", lead, "-c", "cluster.scale"],
                 ["shell", "-master", lead, "-c", "qos.status"]))
        check(top.startswith("cluster OK"), f"top: {top[:500]}")
        scale, qos_view = json.loads(scale), json.loads(qos_view)
        scale_jobs = [h for h in http_json(lead, "/maintenance/queue")
                      ["history"][hist0:] if h["type"] == TYPE_SCALE_UP]
        check(scale_jobs and scale_jobs[0]["outcome"] == "ok",
              f"scale.up jobs {scale_jobs}")
        check(new_url in [n["url"] for n in scale["nodes"]],
              "cluster.scale does not list the newcomer")
        check(f"volume {new_url}" in qos_view["daemons"],
              "qos.status does not reach the newcomer")
        log(f"elastic: top -once ({len(top.splitlines())} lines), "
            f"lint-dashboards ({lint.strip()}), cluster.scale "
            f"({len(scale['nodes'])} nodes, autoscale "
            f"{json.dumps(scale['autoscale'], sort_keys=True)}), "
            f"qos.status ({len(qos_view['daemons'])} daemons) through the "
            "CLI")
        queue = http_json(lead, "/maintenance/queue")
        log("elastic: jobs after the kill " + json.dumps(
            [{k: j.get(k) for k in ("type", "volume", "worker", "outcome",
                                    "attempts")}
             for j in queue["history"][hist0:]]))
        final = {v: process_counts(v) for v in live}
        if not rehearse:
            for v, c in final.items():
                check(c["gf_apply"] == c["batches"] + c["scrub_steps"],
                      f"{v}: K1 {c['gf_apply']} at the end")
        launches = {name: sum(final[v][name] for v in live)
                    + pre_kill[victim][name] for name in KERNELS}
        out["launches_by_process"] = final
    finally:
        if mc is not None:
            mc.stop()
        # -- shutdown: SIGTERM every process, the scale child through
        # its spawner
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        left = proc_tree_pids(workdir)
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    check(not left, f"processes left after SIGTERM: {left}")
    check(all(p.returncode == 0 for n, p in procs.items()),
          "a process did not exit 0 on SIGTERM: " + json.dumps(
              {n: p.returncode for n, p in procs.items()}))
    out["wall_s"] = time.monotonic() - t_phase
    PHASE_NUMBERS["elastic"] = out
    log("elastic numbers: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("traffic",)},
        sort_keys=True, default=str))
    log(f"launches on the elastic path: {launches}")
    return launches


def filer_phase(dev, workdir: str, rehearse: bool = False) -> dict:
    """Phase 12: a filer over warm EC storage, SeaweedFS's documented
    setup (one master at the default 1 GiB volume limit, three volume
    servers with -ec.backend=cuda, one filer at -maxMB 4 with a 1 GiB HBM
    tier for its chunk cache), each a process of the port's CLI.  The
    shell's fs.configure gives /warm/ the collection `warm` and the
    Cauchy code; ~1.1 GiB of seeded files (log-uniform 4 KiB-64 MiB)
    POSTed through the filer from 8 connections; the shell's ec.encode of
    the collection (K2 with the Cauchy parity rows, the `.vif`s naming
    `cauchy`); every file read whole; .ec00 .ec05 .ec11 .ec13 of the
    largest volume dropped and every file read whole and by one Range
    (K1 = decode batches in every server process); Zipf(1.1) GETs, then a
    sweep reading every file three times, past the HBM tier; single-chunk
    files probed one by one for HBM-hit and miss latencies; an overwrite
    of the hottest path read back new; fs.ls, fs.du, fs.cat, volume.fsck
    and filer.cat through the CLI; /metadata/subscribe holding every
    create; nothing left after SIGTERM.  Returns the kernels' launches,
    summed over the volume server processes.  `rehearse` runs everything
    on the CPU and skips the launch counts."""
    from seaweedfs_tpu_torch.rpc.http_rpc import call

    out: dict = {}
    t_phase = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(FILER_KNOBS, PYTHONPATH=repo)
    filer_env = dict(env, WEED_READ_CACHE_HBM_MB=str(FILER_HBM_MB),
                     WEED_READ_CACHE_MB=str(FILER_RAM_MB))
    device_flag = ["-device", "cpu"] if rehearse else []

    # the files: log-uniform sizes, bytes from (seed, index)
    rng = np.random.default_rng(SEED + 40)
    sizes, total = [], 0
    while total < FILER_BYTES:
        sizes.append(int(np.exp(rng.uniform(np.log(FILER_MIN_FILE),
                                            np.log(FILER_MAX_FILE)))))
        total += sizes[-1]
    n = len(sizes)
    seed = SEED + 41
    paths = [f"warm/d{i % 8}/f{i:04d}.bin" for i in range(n)]

    ports = []
    while len(ports) < FILER_SERVERS + 2:
        p = free_port()
        if p not in ports:
            ports.append(p)
    maddr = f"127.0.0.1:{ports[0]}"
    faddr = f"127.0.0.1:{ports[1]}"
    vaddrs = [f"127.0.0.1:{p}" for p in ports[2:]]
    procs: dict = {}

    def log_of(name):
        return os.path.join(workdir, name.replace(":", "_") + ".log")

    def cache_counts() -> dict:
        expo = exposition(http_get_text(faddr, "/metrics"))
        got = {t: sample(expo, "SeaweedFS_read_cache_requests_total",
                         tier=t) for t in ("hbm", "ram", "disk", "miss")}
        got["hbm_resident"] = sample(
            expo, "SeaweedFS_read_cache_resident_bytes", tier="hbm")
        got["h2d"] = sample_sum(
            expo, "SeaweedFS_volumeServer_ec_device_h2d_bytes_total")
        return got

    def run_load(mode, targets, tag, conns=FILER_CONNS):
        rep = loader_run({"mode": mode, "seed": seed, "sizes": sizes,
                          "targets": targets, "conns": conns}, workdir,
                         env, tag)
        check(not rep["bad"] and rep["n"] == len(targets),
              f"filer {tag}: {len(rep['bad'])} bad, e.g. {rep['bad'][:3]}")
        return {"n": rep["n"], "bytes": rep["bytes"], "s": rep["wall"],
                "mib_s": rep["bytes"] / MIB / rep["wall"],
                "req_s": rep["n"] / rep["wall"],
                "p50_ms": pct_ms(rep["lat"], 50),
                "p99_ms": pct_ms(rep["lat"], 99)}

    try:
        # -- the deployment: every daemon through the port's CLI
        t0 = time.monotonic()
        mdir = os.path.join(workdir, "master")
        os.makedirs(mdir)
        starting = [(maddr, ["master", "-port", str(ports[0]), "-mdir", mdir,
                             "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB),
                             "-defaultReplication", "000",
                             "-pulseSeconds", "1"], env)]
        for i, v in enumerate(vaddrs):
            d = os.path.join(workdir, f"volume{i}")
            os.makedirs(d)
            starting.append((v, ["volume", "-dir", d, "-port", v.split(":")[1],
                                 "-mserver", maddr, "-rack", f"rack{i + 1}",
                                 "-dataCenter", "dc1", "-pulseSeconds", "1",
                                 "-ecBackend", "cuda"] + device_flag, env))
        starting.append((faddr, ["filer", "-port", str(ports[1]), "-master",
                                 maddr, "-db", os.path.join(workdir,
                                                            "filer.db"),
                                 "-maxMB", "4"] + device_flag, filer_env))
        for name, args, penv in starting:
            procs[name] = cli(args, penv, log_of(name))
        for name, proc in procs.items():
            listening(proc, name, log_of(name))

        def registered():
            st = http_json(maddr, "/dir/status")
            nodes = sorted(n["url"] for dc in st["datacenters"]
                           for r in dc["racks"] for n in r["nodes"])
            filers = http_json(maddr, "/cluster/nodes?type=filer")
            return nodes == sorted(vaddrs) and filers["cluster_nodes"]

        wait_until(registered, 60, "the volume servers and the filer never "
                   "registered")
        out["start_s"] = time.monotonic() - t0
        http_json(maddr, "/maintenance/pause", {"paused": True})
        log(f"filer: master {maddr}, volume servers {vaddrs}, filer {faddr} "
            f"(HBM tier {FILER_HBM_MB} MiB, RAM {FILER_RAM_MB} MiB), each a "
            f"process of the port's CLI, up in {out['start_s']:.3f} s")

        # -- 1. the path rule through the shell's CLI
        text = cli_run(["shell", "-master", maddr, "-c",
                        "fs.configure -locationPrefix=/warm/ "
                        "-collection=warm -ecCode=cauchy"], env)
        rule = json.loads(text)["locations"]
        check({"location_prefix": "/warm/", "collection": "warm",
               "ec_code": "cauchy"}.items() <= rule[0].items(),
              f"fs.configure: {rule}")
        time.sleep(1.2)  # the filer re-reads its path rules each second

        # -- 2. the upload from 8 connections
        put = run_load("preload", [[i, faddr, paths[i]] for i in range(n)],
                       "upload")
        out["files"], out["bytes"] = n, total
        out["upload"] = put
        log(f"filer: {n} files ({total} B, log-uniform "
            f"{FILER_MIN_FILE}-{FILER_MAX_FILE} B) POSTed through the "
            f"filer from {FILER_CONNS} connections: {put['mib_s']:.1f} "
            f"MiB/s, {put['req_s']:.1f} req/s, p50 {put['p50_ms']:.3f} ms, "
            f"p99 {put['p99_ms']:.3f} ms")

        def warm_volumes():
            st = http_json(maddr, "/dir/status")
            return {v["id"]: v["size"] for dc in st["datacenters"]
                    for r in dc["racks"] for nd in r["nodes"]
                    for v in nd["volume_list"]
                    if v.get("collection") == "warm"}

        wait_until(lambda: sum(warm_volumes().values()) >= total, 30,
                   "the heartbeats never reported the uploaded bytes")
        vol_sizes = warm_volumes()
        t0 = time.perf_counter()
        fsck = json.loads(cli_run(["shell", "-master", maddr, "-c",
                                   f"volume.fsck -filer={faddr}"], env))
        out["fsck_s"] = time.perf_counter() - t0
        check(fsck["missing_chunks"] == [] and
              fsck["referenced_needles"] >= n and
              not any(fsck["orphaned"].values()),
              f"volume.fsck: {json.dumps(fsck)[:2000]}")
        out["fsck"] = {k: fsck[k] for k in ("volumes", "stored_needles",
                                            "referenced_needles")}

        # -- 3. the shell's ec.encode of the collection (K2)
        before = {v: process_counts(v) for v in vaddrs}
        t0 = time.perf_counter()
        text = cli_run(["shell", "-master", maddr, "-c",
                        "ec.encode -collection=warm -fullPercent="
                        f"{FILER_ENCODE_PERCENT} -quietFor=0"], env)
        out["encode_s"] = time.perf_counter() - t0
        check(not text.startswith("error"), f"ec.encode: {text[-3000:]}")
        vids = sorted(p["volume"] for p in json.loads(text))
        floor = CLUSTER_LIMIT_MB * MIB * FILER_ENCODE_PERCENT / 100
        check(vids == sorted(v for v, size in vol_sizes.items()
                             if size >= floor), f"ec.encode encoded {vids} "
              f"of {vol_sizes}")
        wait_until(lambda: all(len(ec_holders(maddr, v)) == 14
                               for v in vids), 60,
                   "the encoded volumes' 14 shards never all showed")
        k2 = {v: process_counts(v)["fused_apply_crc"]
              - before[v]["fused_apply_crc"] for v in vaddrs}
        if not rehearse:
            check(sum(k2.values()) > 0, "K2 did not launch in ec.encode")
        families = {}
        for i in range(FILER_SERVERS):
            for v in vids:
                base = os.path.join(workdir, f"volume{i}", f"warm_{v}")
                if os.path.exists(base + ".vif"):
                    families.setdefault(v, set()).add(
                        encoder.load_volume_info(base).get("code_family"))
        check(sorted(families) == vids and all(
            f == {"cauchy"} for f in families.values()),
            f"the .vif families: {families}")
        log(f"filer: ec.encode of collection warm ({len(vids)} volumes "
            f"{json.dumps(vol_sizes, sort_keys=True)} B) through the "
            f"shell's CLI in {out['encode_s']:.3f} s; K2 by server "
            f"{json.dumps(k2)}; every .vif names cauchy, the filer's rule")

        # -- 4. every file read whole, intact; then 4 shards of the
        # largest volume lost and every file read whole and by a Range
        order = [[i, faddr, paths[i]] for i in range(n)]
        out["intact"] = run_load("get", order, "intact")
        vid = max(vids, key=lambda v: vol_sizes[v])
        held = ec_holders(maddr, vid)
        for sid in LOST:
            for url in held[sid]:
                http_json(url, "/admin/ec/delete_shards",
                          {"volume": vid, "shard_ids": [sid]})
        wait_until(lambda: all(sid not in ec_holders(maddr, vid)
                               for sid in LOST), 30,
                   "the dropped shards stayed listed")
        mid = {v: process_counts(v) for v in vaddrs}
        out["degraded"] = run_load("get", order, "degraded")
        spans = []
        for i in range(n):
            lo = int(rng.integers(0, sizes[i]))
            hi = int(rng.integers(lo, min(sizes[i], lo + 8 * MIB)))
            spans.append([i, faddr, paths[i], lo, hi])
        out["ranges"] = run_load("get", spans, "ranges")
        after = {v: process_counts(v) for v in vaddrs}
        decode = {v: {"k1": after[v]["gf_apply"] - mid[v]["gf_apply"],
                      "batches": after[v]["batches"] - mid[v]["batches"]}
                  for v in vaddrs}
        if not rehearse:
            check(sum(d["k1"] for d in decode.values()) > 0,
                  "K1 did not launch behind the lost shards")
            for v, c in after.items():
                check(c["gf_apply"] == c["batches"] + c["scrub_steps"],
                      f"{v}: {c['gf_apply']} K1 launches for "
                      f"{c['batches']} decode batches")
        out["decode_by_process"] = decode
        for tag in ("intact", "degraded", "ranges"):
            r = out[tag]
            log(f"filer: {tag} reads of {r['n']} files ({r['bytes']} B, "
                f"{FILER_CONNS} connections): {r['mib_s']:.1f} MiB/s, "
                f"{r['req_s']:.1f} req/s, p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms")
        log(f"filer: volume {vid} lost .ec00 .ec05 .ec11 .ec13; every file "
            "byte-identical whole and by Range; K1 and decode batches by "
            "server " + json.dumps(decode, sort_keys=True))

        # -- 5. Zipf(1.1) GETs, then a sweep past the HBM tier
        c0 = cache_counts()
        ranks = rng.permutation(n)
        draws = [int(ranks[(z - 1) % n]) for z in rng.zipf(CACHE_ZIPF,
                                                           FILER_ZIPF_GETS)]
        out["zipf"] = run_load("get", [[i, faddr, paths[i]] for i in draws],
                               "zipf")
        c1 = cache_counts()
        sweep = [[i, faddr, paths[i]] for i in range(n) for _ in range(3)]
        out["sweep"] = run_load("get", sweep, "sweep", conns=1)
        c2 = cache_counts()
        # single-chunk files one by one, in sweep order: the early ones
        # left the HBM tier, the later ones are in it
        singles = [i for i in range(n) if sizes[i] <= 4 * MIB]
        picks = [singles[j * len(singles) // FILER_PROBES]
                 for j in range(min(FILER_PROBES, len(singles)))]
        lat = {"hbm": [], "ram": [], "miss": [], "disk": []}
        pre = cache_counts()  # nothing else reads between the probes
        for i in picks:
            t0 = time.perf_counter()
            body = call(faddr, "/" + paths[i], parse=False, timeout=120)
            dt = time.perf_counter() - t0
            check(body == elastic_payload(seed, i, sizes[i]),
                  f"probe {paths[i]} read wrong")
            post = cache_counts()
            tier = [t for t in lat if post[t] > pre[t]]
            check(len(tier) == 1, f"probe {paths[i]}: tiers {tier}")
            lat[tier[0]].append(dt)
            pre = post
        c3 = pre
        tiers = {t: c3[t] - c0[t] for t in ("hbm", "ram", "disk", "miss")}
        evicted = c3["h2d"] - c3["hbm_resident"]
        check(tiers["hbm"] > 0, f"no HBM-tier hit: {tiers}")
        check(c3["hbm_resident"] <= FILER_HBM_MB * MIB,
              f"the HBM tier holds {c3['hbm_resident']} B")
        check(lat["hbm"] and lat["miss"],
              f"probes found no HBM hit or no miss: "
              f"{ {t: len(v) for t, v in lat.items()} }")
        if not rehearse:
            check(evicted > 0, f"the sweep evicted nothing: {c3}")
        out["cache"] = {"tiers": tiers, "zipf_hbm_hits": c1["hbm"] - c0["hbm"],
                        "sweep_hbm_hits": c2["hbm"] - c1["hbm"],
                        "hbm_resident": c3["hbm_resident"],
                        "h2d": c3["h2d"], "evicted_bytes": evicted,
                        "probes": {t: len(v) for t, v in lat.items()},
                        "hbm_hit_p50_ms": pct_ms(lat["hbm"], 50),
                        "miss_p50_ms": pct_ms(lat["miss"], 50),
                        "ram_hit_p50_ms": pct_ms(lat["ram"], 50)}
        for tag in ("zipf", "sweep"):
            r = out[tag]
            log(f"filer: {tag} GETs ({r['n']}, {r['bytes']} B): "
                f"{r['mib_s']:.1f} MiB/s, p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms")
        log("filer: chunk cache over the Zipf GETs, the sweep and the "
            "probes " + json.dumps(out["cache"], sort_keys=True))

        # -- 6. an overwrite of the hottest path reads back new
        hot = int(ranks[0])
        new = elastic_payload(seed, (1 << 40) + hot, sizes[hot])
        call(faddr, "/" + paths[hot], raw=new, method="POST", timeout=300)
        for _ in range(3):
            check(call(faddr, "/" + paths[hot], parse=False,
                       timeout=300) == new,
                  f"{paths[hot]} served old bytes after its overwrite")
        log(f"filer: {paths[hot]} ({sizes[hot]} B, the Zipf head) "
            "overwritten, read back new three times")

        # -- 7. the shell's fs.* and filer.cat through the CLI
        small = min(range(n), key=lambda i: sizes[i])
        ls = cli_run(["shell", "-master", maddr, "-c",
                      "fs.ls -l /warm/d0"], env)
        du = json.loads(cli_run(["shell", "-master", maddr, "-c",
                                 "fs.du /warm"], env))
        check(du["files"] == n and du["bytes"] == total,
              f"fs.du: {du} for {n} files of {total} B")
        check(len(json.loads(ls)) == len(range(0, n, 8)), f"fs.ls: {ls}")
        cat = cli_run(["shell", "-master", maddr, "-c",
                       f"fs.cat /{paths[small]}"], env, raw=True)
        check(cat == elastic_payload(seed, small, sizes[small]),
              "fs.cat read wrong bytes")
        got = cli_run(["filer.cat", "/" + paths[hot], "-filer", faddr], env,
                      raw=True)
        check(got == new, "filer.cat read wrong bytes")
        log(f"filer: fs.ls -l /warm/d0, fs.du /warm ({du}), fs.cat of "
            f"{paths[small]}, volume.fsck before the encode "
            f"({json.dumps(out['fsck'])}) and filer.cat of {paths[hot]} "
            "through the CLI")

        # -- 8. the change feed saw every create
        events = http_json(faddr, "/metadata/subscribe?since=0"
                           "&pathPrefix=/warm/")["events"]
        created = {e["new_entry"]["full_path"] for e in events
                   if e["new_entry"] and not e["old_entry"]}
        check({"/" + p for p in paths} <= created,
              f"/metadata/subscribe missed "
              f"{sorted({'/' + p for p in paths} - created)[:5]}")
        out["events"] = len(events)
        final = {v: process_counts(v) for v in vaddrs}
        launches = {name: sum(c[name] for c in final.values())
                    for name in KERNELS}
        out["launches_by_process"] = final
    finally:
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        left = proc_tree_pids(workdir)
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    check(not left, f"processes left after SIGTERM: {left}")
    check(all(p.returncode == 0 for p in procs.values()),
          "a process did not exit 0 on SIGTERM: " + json.dumps(
              {n: p.returncode for n, p in procs.items()}))
    out["wall_s"] = time.monotonic() - t_phase
    PHASE_NUMBERS["filer"] = out
    log("filer numbers: " + json.dumps(out, sort_keys=True, default=str))
    log(f"launches on the filer path: {launches}")
    return launches


S3_LOADER = r"""
import hashlib, hmac, http.client, json, random, sys, threading, time
import urllib.parse
import numpy as np

with open(sys.argv[1]) as f:
    a = json.load(f)
_keys = {}


def payload(key, size):
    return np.random.default_rng([a["seed"]] + list(key)).bytes(size)


def quote(s, safe="/~"):
    return urllib.parse.quote(s, safe=safe)


def signing_key(datestamp):
    if datestamp not in _keys:
        k = ("AWS4" + a["secret_key"]).encode()
        for part in (datestamp, "us-east-1", "s3", "aws4_request"):
            k = hmac.new(k, part.encode(), hashlib.sha256).digest()
        _keys[datestamp] = k
    return _keys[datestamp]


def sign(method, path, query, payload_hash):
    # SigV4 header auth, as the AWS SDKs send it
    now = time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    datestamp = time.strftime("%Y%m%d", now)
    headers = {"Host": a["endpoint"], "X-Amz-Date": amz_date,
               "X-Amz-Content-Sha256": payload_hash}
    signed = sorted(k.lower() for k in headers)
    lower = {k.lower(): v for k, v in headers.items()}
    cq = "&".join(sorted("%s=%s" % (quote(k, "~"), quote(v, "~"))
                         for k, v in query.items()))
    canonical = "\n".join([
        method, quote(path), cq,
        "".join("%s:%s\n" % (h, " ".join(lower[h].split()))
                for h in signed), ";".join(signed), payload_hash])
    scope = "%s/us-east-1/s3/aws4_request" % datestamp
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    sig = hmac.new(signing_key(datestamp), sts.encode(),
                   hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        "AWS4-HMAC-SHA256 Credential=%s/%s, SignedHeaders=%s, Signature=%s"
        % (a["access_key"], scope, ";".join(signed), sig))
    return headers


EMPTY = hashlib.sha256(b"").hexdigest()
local = threading.local()


def request(method, name, body=b"", rng=None):
    path = a["prefix"] + name
    headers = sign(method, path, {}, hashlib.sha256(body).hexdigest()
                   if body else EMPTY) if a["sign"] else {}
    if body:
        headers["Content-Type"] = "application/octet-stream"
    if rng:
        headers["Range"] = "bytes=%d-%d" % tuple(rng)
    for attempt in (0, 1):  # a kept-alive connection the server closed
        if getattr(local, "conn", None) is None:
            host, port = a["endpoint"].split(":")
            local.conn = http.client.HTTPConnection(host, int(port),
                                                    timeout=300)
        try:
            local.conn.request(method, quote(path), body=body or None,
                               headers=headers)
            resp = local.conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        except (http.client.RemoteDisconnected, BrokenPipeError,
                ConnectionResetError):
            local.conn.close()
            local.conn = None
            if attempt:
                raise


def etag_of(headers):
    return {k.lower(): v for k, v in headers.items()}.get("etag",
                                                          "").strip('"')


def one(t, stats):
    # one target: PUT it ("put"), GET it whole or by Range and check bytes
    # and ETag ("get"), or check that it is gone ("gone")
    mode = a["mode"]
    t0 = time.perf_counter()
    if mode == "put":
        body = payload(t["key"], t["size"])
        status, headers, reply = request("PUT", t["name"], body)
        md5 = hashlib.md5(body).hexdigest()
        ok = status == 200 and etag_of(headers) == md5
        moved, extra = len(body), md5
    elif mode == "gone":
        status, headers, reply = request("GET", t["name"])
        ok = status == 404 and b"NoSuchKey" in reply
        moved, extra = 0, None
    else:
        want = payload(t["key"], t["size"])
        span = t.get("span")
        status, headers, reply = request("GET", t["name"], rng=span)
        if span:
            want = want[span[0]:span[1] + 1]
        ok = status == (206 if span else 200) and reply == want and (
            not a["sign"] or etag_of(headers) == t["etag"])
        moved, extra = len(want), None
    dt = time.perf_counter() - t0
    with stats["lock"]:
        stats["lat"].append(dt)
        stats["bytes"] += moved
        if extra is not None:
            stats["etags"][t["name"]] = extra
        if not ok:
            stats["bad"].append([t["name"], status,
                                 reply[:200].decode("latin-1")])


def transfer():
    targets = a["targets"]
    stats = {"lock": threading.Lock(), "lat": [], "bytes": 0, "etags": {},
             "bad": []}
    it = iter(targets)

    def worker():
        while True:
            with stats["lock"]:
                t = next(it, None)
            if t is None:
                return
            try:
                one(t, stats)
            except OSError as e:  # recorded: a failed request fails the run
                with stats["lock"]:
                    stats["bad"].append([t["name"], 0, repr(e)])

    threads = [threading.Thread(target=worker) for _ in range(a["conns"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stats.pop("lock")
    return dict(stats, n=len(stats["lat"]), wall=time.perf_counter() - t0)


def mix():
    # warp mixed: closed loop, each connection draws GET/STAT/PUT/DELETE
    # by the weights; DELETE takes the oldest key this connection PUT
    ops = list(a["weights"])
    weights = [a["weights"][o] for o in ops]
    pool = a["pool"]  # preloaded [name, key, size, etag]
    lock = threading.Lock()
    lat = {o: [] for o in ops}
    moved = {o: 0 for o in ops}
    live, deleted, bad = [], [], []
    start = time.monotonic()
    deadline = start + a["duration"]

    def worker(tid):
        own = []
        try:
            loop(tid, own)
        except OSError as e:  # recorded: a failed request fails the run
            with lock:
                bad.append(["error", "", 0, repr(e)])
        with lock:
            live.extend(own)

    def loop(tid, own):
        rnd = random.Random(a["proc"] * 1000 + tid)
        n = 0
        while time.monotonic() < deadline:
            op = rnd.choices(ops, weights)[0]
            if op == "DELETE" and not own:
                continue
            t0 = time.perf_counter()
            if op in ("GET", "STAT"):
                name, key, size, etag = rnd.choice(pool + own)
                if op == "GET":
                    status, headers, reply = request("GET", name)
                    ok = status == 200 and etag_of(headers) == etag and \
                        reply == payload(key, size)
                    nbytes = len(reply)
                else:
                    status, headers, reply = request("HEAD", name)
                    ok = status == 200 and {
                        k.lower(): v for k, v in headers.items()
                    }.get("content-length") == str(size)
                    nbytes = 0
            elif op == "PUT":
                key = [4, a["proc"], tid, n]
                n += 1
                name = "mix/p%d/t%d/%05d" % tuple(key[1:])
                body = payload(key, a["size"])
                status, headers, reply = request("PUT", name, body)
                etag = hashlib.md5(body).hexdigest()
                ok = status == 200 and etag_of(headers) == etag
                if ok:
                    own.append([name, key, a["size"], etag])
                nbytes = len(body)
            else:
                name = own.pop(0)[0]
                status, headers, reply = request("DELETE", name)
                ok = status == 204
                if ok:
                    with lock:
                        deleted.append(name)
                nbytes = 0
            dt = time.perf_counter() - t0
            with lock:
                lat[op].append(dt)
                moved[op] += nbytes
                if not ok:
                    bad.append([op, name, status,
                                reply[:200].decode("latin-1")])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(a["conns"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"lat": lat, "bytes": moved, "live": live, "deleted": deleted,
            "bad": bad, "wall": time.monotonic() - start}


bad_mods = [m for m in sys.modules
            if m.split(".")[0] in ("torch", "jax", "seaweedfs_tpu",
                                   "seaweedfs_tpu_torch")]
assert not bad_mods, bad_mods
result = mix() if a["mode"] == "mix" else transfer()
with open(a["out"], "w") as f:
    json.dump(result, f)
"""


def s3_payload(seed: int, key, size: int) -> bytes:
    """The bytes of one phase 13 object: as S3_LOADER's payload()."""
    return np.random.default_rng([seed] + list(key)).bytes(size)


def s3_loader(spec: dict, workdir: str, env: dict, tag: str,
              procs: int = 1) -> list:
    """S3_LOADER in `procs` fresh interpreters at once, `targets` dealt
    round-robin; returns their reports."""
    runs = []
    for p in range(procs):
        out = os.path.join(workdir, f"s3_{tag}_{p}.json")
        one = dict(spec, out=out, proc=p)
        if "targets" in spec:
            one["targets"] = spec["targets"][p::procs]
        with open(out + ".spec", "w") as f:
            json.dump(one, f)
        runs.append((subprocess.Popen(
            [sys.executable, "-c", S3_LOADER, out + ".spec"], env=env,
            cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), out))
    reports = []
    for proc, out in runs:
        _, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"the s3 {tag} load process failed: "
              f"{err[-3000:]}")
        with open(out) as f:
            reports.append(json.load(f))
    return reports


def s3_iam(addr: str, action: str, **params) -> bytes:
    """One IAM API call; anything but 200 fails the run."""
    import urllib.parse

    from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call

    body = urllib.parse.urlencode({"Action": action, **params}).encode()
    try:
        return call(addr, "/", raw=body, method="POST", parse=False,
                    headers={"Content-Type":
                             "application/x-www-form-urlencoded"})
    except RpcError as e:
        raise AssertionError(f"IAM {action}: {e.status} {e}") from None


def s3_phase(dev, workdir: str, rehearse: bool = False) -> dict:
    """Phase 13: SeaweedFS's S3 gateway with the IAM API over warm EC
    storage, each daemon a process of the port's CLI: one master, three
    volume servers (-ec.backend=cuda) and one `iam` process that serves
    the IAM API, the S3 API and their embedded filer (a 1 GiB HBM tier
    for its chunk cache).  Keys made through the IAM API; bucket `warm`
    given its collection by fs.configure; 100 seeded 10 MiB objects PUT
    by SigV4-signing load processes, a 64 MiB multipart upload and a
    streaming aws-chunked PUT; the shell's ec.encode (K2); every object
    read intact, then .ec00 .ec05 .ec11 .ec13 of the largest volume
    dropped and every object read whole and by one Range (K1); 30 s of
    MinIO warp's mixed traffic; listings, key probes, the circuit
    breaker, HBM-tier probes; filer.backup, filer.meta.backup and
    filer.sync through the CLI; benchmark, upload and download; nothing
    left after SIGTERM.  Returns the kernels' launches, summed over the
    volume server processes.  `rehearse` runs on the CPU and skips the
    launch counts."""
    import xml.etree.ElementTree as ET

    from seaweedfs_tpu_torch.rpc.http_rpc import call
    from seaweedfs_tpu_torch.wdclient.s3_client import S3Client

    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    iam_ns = "{https://iam.amazonaws.com/doc/2010-05-08/}"
    out: dict = {}
    t_phase = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(FILER_KNOBS, PYTHONPATH=repo)
    gw_env = dict(env, WEED_READ_CACHE_HBM_MB=str(S3_HBM_MB),
                  WEED_READ_CACHE_MB=str(S3_RAM_MB))
    device_flag = ["-device", "cpu"] if rehearse else []
    seed = SEED + 50
    # every live object of the bucket: name -> [payload key, size, etag]
    objects: dict = {}

    ports = []
    while len(ports) < S3_SERVERS + 4:
        p = free_port()
        if p not in ports:
            ports.append(p)
    maddr = f"127.0.0.1:{ports[0]}"
    iam_addr = f"127.0.0.1:{ports[1]}"
    s3_addr = f"127.0.0.1:{ports[2]}"
    f2_addr = f"127.0.0.1:{ports[3]}"
    vaddrs = [f"127.0.0.1:{p}" for p in ports[4:]]
    procs: dict = {}

    def log_of(name):
        return os.path.join(workdir, name.replace(":", "_") + ".log")

    def start(name, args, penv, marker="listening on"):
        procs[name] = cli(args, penv, log_of(name))
        ready, _, _ = select.select([procs[name].stdout], [], [], 120)
        line = procs[name].stdout.readline() if ready else ""
        if marker not in line:
            procs[name].kill()
            procs[name].wait(timeout=30)
            with open(log_of(name)) as f:
                check(False, f"{name} did not start: {line!r} "
                      f"{f.read()[-3000:]}")

    def shell(cmd):
        return cli_run(["shell", "-master", maddr, "-filer", faddr, "-c",
                        cmd], env)

    def cache_counts() -> dict:
        expo = exposition(http_get_text(s3_addr, "/metrics"))
        return {t: sample(expo, "SeaweedFS_read_cache_requests_total",
                          tier=t) for t in ("hbm", "ram", "disk", "miss")}

    def numbers(reps) -> dict:
        lat = [x for r in reps for x in r["lat"]]
        nbytes = sum(r["bytes"] for r in reps)
        wall = max(r["wall"] for r in reps)
        return {"n": len(lat), "bytes": nbytes, "s": wall,
                "mib_s": nbytes / MIB / wall, "req_s": len(lat) / wall,
                "p50_ms": pct_ms(lat, 50), "p99_ms": pct_ms(lat, 99)}

    def load(mode, targets, tag, key, nprocs=S3_LOADERS,
             conns=S3_CONNS, endpoint=None, prefix="/warm/"):
        reps = s3_loader({"mode": mode, "seed": seed, "targets": targets,
                          "conns": conns, "endpoint": endpoint or s3_addr,
                          "prefix": prefix, "sign": endpoint is None,
                          "access_key": key[0], "secret_key": key[1]},
                         workdir, env, tag, nprocs)
        bad = [b for r in reps for b in r["bad"]]
        check(not bad and sum(len(r["lat"]) for r in reps) == len(targets),
              f"s3 {tag}: {len(bad)} bad, e.g. {bad[:3]}")
        got = numbers(reps)
        for r in reps:
            got.setdefault("etags", {}).update(r["etags"])
        return got

    def report(tag, r):
        log(f"s3: {tag}: {r['n']} requests, {r['bytes']} B in "
            f"{r['s']:.3f} s: {r['mib_s']:.1f} MiB/s, {r['req_s']:.1f} "
            f"req/s, p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms")

    def reads(names, tag, key, spans=False, rng=None):
        targets = []
        for name in names:
            k, size, etag = objects[name]
            t = {"name": name, "key": k, "size": size, "etag": etag}
            if spans:
                lo = int(rng.integers(0, size))
                t["span"] = [lo, int(rng.integers(lo, min(size, lo + 8 * MIB)))]
            targets.append(t)
        return load("get", targets, tag, key)

    try:
        # -- 1. the deployment: every daemon through the port's CLI
        t0 = time.monotonic()
        mdir = os.path.join(workdir, "master")
        os.makedirs(mdir)
        ids = os.path.join(workdir, "identities.json")
        with open(ids, "w") as f:
            json.dump({"identities": [{"name": "admin",
                                       "access_key": "AKADMIN",
                                       "secret_key": "SKADMIN"}]}, f)
        procs[maddr] = cli(["master", "-port", str(ports[0]), "-mdir", mdir,
                            "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB),
                            "-defaultReplication", "000",
                            "-pulseSeconds", "1"], env, log_of(maddr))
        for i, v in enumerate(vaddrs):
            d = os.path.join(workdir, f"volume{i}")
            os.makedirs(d)
            procs[v] = cli(["volume", "-dir", d, "-port", v.split(":")[1],
                            "-max", str(S3_MAX_VOLUMES), "-mserver", maddr,
                            "-rack", f"rack{i + 1}", "-dataCenter", "dc1",
                            "-pulseSeconds", "1", "-ecBackend", "cuda"]
                           + device_flag, env, log_of(v))
        start("iam", ["iam", "-port", str(ports[1]), "-s3Port",
                      str(ports[2]), "-master", maddr, "-config", ids,
                      "-db", os.path.join(workdir, "filer.db")]
              + device_flag, gw_env, marker=f"iam api on {iam_addr} "
              f"(s3 {s3_addr})")
        for v in [maddr] + vaddrs:
            listening(procs[v], v, log_of(v))

        def registered():
            st = http_json(maddr, "/dir/status")
            nodes = sorted(n["url"] for dc in st["datacenters"]
                           for r in dc["racks"] for n in r["nodes"])
            filers = http_json(maddr, "/cluster/nodes?type=filer")
            return nodes == sorted(vaddrs) and filers["cluster_nodes"]

        # `weed iam` prints the IAM and S3 addresses; the embedded filer
        # is found as the shell finds it, in the master's registry
        faddr = wait_until(registered, 60, "the volume servers and the "
                           "embedded filer never registered")[0]["address"]
        out["start_s"] = time.monotonic() - t0
        http_json(maddr, "/maintenance/pause", {"paused": True})
        log(f"s3: master {maddr}, volume servers {vaddrs}, iam api "
            f"{iam_addr} with the s3 gateway {s3_addr} and the embedded "
            f"filer {faddr} (HBM tier {S3_HBM_MB} MiB, RAM {S3_RAM_MB} "
            f"MiB), each a process of the port's CLI, up in "
            f"{out['start_s']:.3f} s")

        # -- 2. IAM: the traffic's key and a read-only key, live
        admin = S3Client(s3_addr, "AKADMIN", "SKADMIN")
        check(admin.send("GET", "/")[0] == 200,
              "the -config admin key was refused")
        check(S3Client(s3_addr).send("GET", "/")[0] == 403,
              "an unsigned request passed the -config gateway")
        keys = {}
        for user, verbs in (("app", ["s3:GetObject", "s3:PutObject",
                                     "s3:ListBucket"]),
                            ("reader", ["s3:GetObject", "s3:ListBucket"])):
            s3_iam(iam_addr, "CreateUser", UserName=user)
            root = ET.fromstring(s3_iam(iam_addr, "CreateAccessKey",
                                        UserName=user))
            keys[user] = (root.find(f".//{iam_ns}AccessKeyId").text,
                          root.find(f".//{iam_ns}SecretAccessKey").text)
            s3_iam(iam_addr, "PutUserPolicy", UserName=user,
                   PolicyName=f"{user}-warm", PolicyDocument=json.dumps({
                       "Version": "2012-10-17", "Statement": [{
                           "Effect": "Allow", "Action": verbs,
                           "Resource": ["arn:aws:s3:::warm",
                                        "arn:aws:s3:::warm/*"]}]}))
        policy = s3_iam(iam_addr, "GetUserPolicy", UserName="app")
        check(b"s3:PutObject" in policy, f"GetUserPolicy: {policy[:500]}")
        app = S3Client(s3_addr, *keys["app"])
        reader = S3Client(s3_addr, *keys["reader"])

        # -- 3. the bucket (the new key, no restart), its path rule, and
        # the preload from 4 processes
        status, _, body = app.send("PUT", "/warm")
        check(status == 200, f"CreateBucket with the IAM key: {status} "
              f"{body[:300]}")
        rule = json.loads(shell("fs.configure -locationPrefix=/buckets/warm/ "
                                "-collection=warm"))["locations"]
        check({"location_prefix": "/buckets/warm/",
               "collection": "warm"}.items() <= rule[0].items(),
              f"fs.configure: {rule}")
        time.sleep(1.2)  # the filer re-reads its path rules each second
        preload = [{"name": f"obj/{i:04d}", "key": [0, i],
                    "size": S3_OBJECT} for i in range(S3_OBJECTS)]
        put = load("put", preload, "preload", keys["app"])
        for t in preload:
            objects[t["name"]] = [t["key"], t["size"], put["etags"][t["name"]]]
        out["put"] = {k: v for k, v in put.items() if k != "etags"}
        report(f"PUT of {S3_OBJECTS} objects of {S3_OBJECT} B from "
               f"{S3_LOADERS} processes x {S3_CONNS} connections, every "
               "ETag the body's MD5", out["put"])

        # a multipart upload of 8 MiB parts (the AWS CLI's default
        # multipart_chunksize), then a streaming aws-chunked PUT
        mp_key, mp = [1, 0], s3_payload(seed, [1, 0], S3_MULTIPART)
        t0 = time.perf_counter()
        root = ET.fromstring(app._request("POST", "/warm/mp/big.bin",
                                          {"uploads": ""}, parse=False))
        upload_id = root.find(f"{ns}UploadId").text
        for part in range(S3_MULTIPART // S3_PART):
            app._request("PUT", "/warm/mp/big.bin",
                         {"partNumber": str(part + 1),
                          "uploadId": upload_id},
                         body=mp[part * S3_PART:(part + 1) * S3_PART],
                         parse=False)
        root = ET.fromstring(app._request("POST", "/warm/mp/big.bin",
                                          {"uploadId": upload_id},
                                          parse=False))
        out["multipart_s"] = time.perf_counter() - t0
        mp_etag = root.find(f"{ns}ETag").text.strip('"')
        check(mp_etag.endswith(f"-{S3_MULTIPART // S3_PART}"),
              f"multipart ETag {mp_etag}")
        objects["mp/big.bin"] = [mp_key, S3_MULTIPART, mp_etag]
        st_key, st = [2, 0], s3_payload(seed, [2, 0], S3_OBJECT)
        t0 = time.perf_counter()
        app.put_object_streaming("warm", "stream/obj.bin", st)
        out["streaming_put_s"] = time.perf_counter() - t0
        objects["stream/obj.bin"] = [st_key, S3_OBJECT,
                                     hashlib.md5(st).hexdigest()]
        log(f"s3: multipart upload of {S3_MULTIPART} B in "
            f"{S3_MULTIPART // S3_PART} parts of {S3_PART} B: "
            f"{out['multipart_s']:.3f} s (ETag {mp_etag}); streaming "
            f"aws-chunked PUT of {S3_OBJECT} B: "
            f"{out['streaming_put_s']:.3f} s")

        # -- 4. the shell's ec.encode of the collection (K2)
        def warm_volumes():
            st = http_json(maddr, "/dir/status")
            return {v["id"]: v["size"] for dc in st["datacenters"]
                    for r in dc["racks"] for nd in r["nodes"]
                    for v in nd["volume_list"]
                    if v.get("collection") == "warm"}

        total = sum(size for _, size, _ in objects.values())
        wait_until(lambda: sum(warm_volumes().values()) >= total, 30,
                   "the heartbeats never reported the uploaded bytes")
        vol_sizes = warm_volumes()
        before = {v: process_counts(v) for v in vaddrs}
        t0 = time.perf_counter()
        text = shell("ec.encode -collection=warm -fullPercent="
                     f"{FILER_ENCODE_PERCENT} -quietFor=0")
        out["encode_s"] = time.perf_counter() - t0
        check(not text.startswith("error"), f"ec.encode: {text[-3000:]}")
        vids = sorted(p["volume"] for p in json.loads(text))
        floor = CLUSTER_LIMIT_MB * MIB * FILER_ENCODE_PERCENT / 100
        check(vids == sorted(v for v, size in vol_sizes.items()
                             if size >= floor), f"ec.encode encoded {vids} "
              f"of {vol_sizes}")
        wait_until(lambda: all(len(ec_holders(maddr, v)) == 14
                               for v in vids), 60,
                   "the encoded volumes' 14 shards never all showed")
        k2 = {v: process_counts(v)["fused_apply_crc"]
              - before[v]["fused_apply_crc"] for v in vaddrs}
        if not rehearse:
            check(sum(k2.values()) > 0, "K2 did not launch in ec.encode")
        families = {}
        for i in range(S3_SERVERS):
            for v in vids:
                base = os.path.join(workdir, f"volume{i}", f"warm_{v}")
                if os.path.exists(base + ".vif"):
                    info = encoder.load_volume_info(base)
                    families.setdefault(v, set()).add(
                        (info.get("code_family"), len(
                            info.get("shard_crc32c", []))))
        check(sorted(families) == vids and all(
            f == {("rs_vandermonde", 14)} for f in families.values()),
            f"the .vif families: {families}")
        log(f"s3: ec.encode of collection warm ({len(vids)} volumes "
            f"{json.dumps(vol_sizes, sort_keys=True)} B) through the "
            f"shell's CLI in {out['encode_s']:.3f} s; K2 by server "
            f"{json.dumps(k2)}; every .vif RS(10,4) Vandermonde with 14 "
            "shard CRCs")

        # -- 5. every object read intact; 4 shards of the largest volume
        # lost; every object read whole and by one Range
        names = sorted(objects)
        out["intact"] = reads(names, "intact", keys["app"])
        vid = max(vids, key=lambda v: vol_sizes[v])
        held = ec_holders(maddr, vid)
        for sid in LOST:
            for url in held[sid]:
                http_json(url, "/admin/ec/delete_shards",
                          {"volume": vid, "shard_ids": [sid]})
        wait_until(lambda: all(sid not in ec_holders(maddr, vid)
                               for sid in LOST), 30,
                   "the dropped shards stayed listed")
        mid = {v: process_counts(v) for v in vaddrs}
        out["degraded"] = reads(names, "degraded", keys["app"])
        out["ranges"] = reads(names, "ranges", keys["app"], spans=True,
                              rng=np.random.default_rng(seed))
        after = {v: process_counts(v) for v in vaddrs}
        decode = {v: {"k1": after[v]["gf_apply"] - mid[v]["gf_apply"],
                      "batches": after[v]["batches"] - mid[v]["batches"]}
                  for v in vaddrs}
        if not rehearse:
            check(sum(d["k1"] for d in decode.values()) > 0,
                  "K1 did not launch behind the lost shards")
        out["decode_by_process"] = decode
        for tag in ("intact", "degraded", "ranges"):
            report(f"{tag} GETs of every object", out[tag])
        log(f"s3: volume {vid} lost .ec00 .ec05 .ec11 .ec13; every object "
            "byte-identical whole and by Range, the multipart one equal to "
            "its parts; K1 and decode batches by server "
            + json.dumps(decode, sort_keys=True))

        # -- 6. warp mixed, closed loop, on the degraded volumes
        pool = [[n, objects[n][0], objects[n][1], objects[n][2]]
                for n in sorted(objects) if n.startswith("obj/")]
        reps = s3_loader({"mode": "mix", "seed": seed, "pool": pool,
                          "conns": S3_CONNS, "endpoint": s3_addr,
                          "prefix": "/warm/", "sign": True,
                          "access_key": keys["app"][0],
                          "secret_key": keys["app"][1],
                          "weights": S3_MIX, "size": S3_OBJECT,
                          "duration": S3_MIX_S}, workdir, env, "mix",
                         S3_LOADERS)
        bad = [b for r in reps for b in r["bad"]]
        check(not bad, f"s3 mix: {len(bad)} bad, e.g. {bad[:3]}")
        wall = max(r["wall"] for r in reps)
        mixed = {}
        for op in S3_MIX:
            lat = [x for r in reps for x in r["lat"][op]]
            nbytes = sum(r["bytes"][op] for r in reps)
            mixed[op] = {"n": len(lat), "ops_s": len(lat) / wall,
                         "mib_s": nbytes / MIB / wall,
                         "p50_ms": pct_ms(lat, 50),
                         "p99_ms": pct_ms(lat, 99)}
        check(all(mixed[op]["n"] > 0 for op in S3_MIX),
              f"an operation of the mix never ran: {mixed}")
        out["mix"] = {"wall_s": wall, "ops": mixed,
                      "ops_s": sum(m["n"] for m in mixed.values()) / wall}
        for r in reps:
            for name, key, size, etag in r["live"]:
                objects[name] = [key, size, etag]
        deleted = [n for r in reps for n in r["deleted"]]
        log(f"s3: warp mixed for {wall:.3f} s from {S3_LOADERS} processes "
            f"x {S3_CONNS} connections: {out['mix']['ops_s']:.1f} ops/s; "
            + "; ".join(f"{op} {m['n']} ({m['ops_s']:.1f}/s, "
                        f"{m['mib_s']:.1f} MiB/s, p50 {m['p50_ms']:.3f} "
                        f"ms, p99 {m['p99_ms']:.3f} ms)"
                        for op, m in mixed.items()))
        live_mix = sorted(n for n in objects if n.startswith("mix/"))
        if live_mix:
            out["readback"] = reads(live_mix, "readback", keys["app"])
        if deleted:
            load("gone", [{"name": n} for n in deleted], "gone",
                 keys["app"], nprocs=1)
        log(f"s3: after the mix, {len(live_mix)} acknowledged PUTs read "
            f"back byte-identical, {len(deleted)} deleted keys answer 404")

        # -- 7. listings and key probes
        def listing(client, **query):
            keys_, prefixes, token = [], [], None
            while True:
                q = {"list-type": "2", **query}
                if token:
                    q["continuation-token"] = token
                status, _, body = client.send("GET", "/warm", q)
                check(status == 200, f"ListObjectsV2 {q}: {status}")
                root = ET.fromstring(body)
                keys_ += [e.find(f"{ns}Key").text
                          for e in root.findall(f"{ns}Contents")]
                prefixes += [e.find(f"{ns}Prefix").text
                             for e in root.findall(f"{ns}CommonPrefixes")]
                token = root.findtext(f"{ns}NextContinuationToken")
                if root.findtext(f"{ns}IsTruncated") != "true":
                    return keys_, prefixes

        got, _ = listing(app, prefix="obj/")
        check(got == sorted(n for n in objects if n.startswith("obj/")),
              f"ListObjectsV2 prefix=obj/: {len(got)} keys")
        got, _ = listing(app, prefix="mix/")
        check(got == live_mix, f"ListObjectsV2 prefix=mix/: {len(got)} "
              f"keys, {len(live_mix)} live")
        got, prefixes = listing(app, delimiter="/")
        want = sorted({n.split("/")[0] + "/" for n in objects})
        check(got == [] and sorted(prefixes) == want,
              f"ListObjectsV2 delimiter=/: {got} {prefixes}")
        small = "obj/0000"
        status, _, body = reader.send("PUT", "/warm/ro.bin", body=b"x")
        check(status == 403, f"the read-only key's PUT: {status}")
        status, _, body = reader.send("GET", "/warm/" + small)
        check(status == 200 and body == s3_payload(seed, [0, 0], S3_OBJECT),
              f"the read-only key's GET: {status}")
        status, _, body = S3Client(s3_addr, "AKNOBODY", "SK").send(
            "GET", "/warm/" + small)
        check(status == 403 and b"InvalidAccessKeyId" in body,
              f"an unknown key: {status} {body[:200]}")
        s3_iam(iam_addr, "DeleteAccessKey", UserName="reader",
               AccessKeyId=keys["reader"][0])
        status, _, body = reader.send("GET", "/warm/" + small)
        check(status == 403 and b"InvalidAccessKeyId" in body,
              f"the deleted key: {status} {body[:200]}")
        log("s3: ListObjectsV2 by prefix and by delimiter equal to the "
            "bucket's keys; the read-only key PUT 403 / GET 200; an "
            "unknown key 403; the deleted key 403")

        # -- 8. a per-bucket count limit through s3.circuitbreaker
        def burst(tag, n=S3_BURST):
            body = s3_payload(seed, [5, 0], 4 * MIB)
            gate = threading.Barrier(n)

            def one(i):
                gate.wait()
                return app.send("PUT", f"/warm/cb/{tag}{i}", body=body)

            with concurrent.futures.ThreadPoolExecutor(n) as pool_:
                return list(pool_.map(one, range(n)))

        def reload_breaker():
            # the gateway re-reads the breaker's file at most once a second,
            # on a request: past that TTL, one PUT makes it read the file
            time.sleep(1.2)
            check(app.send("PUT", "/warm/cb/reload", body=b"r")[0] == 200,
                  "the PUT that reloads the breaker")

        shell("s3.circuitbreaker -actions=Write:Count -values=1 "
              "-buckets=warm -enable")
        reload_breaker()
        got = burst("a-")
        codes = [s for s, _, _ in got]
        check(all(s in (200, 503) for s in codes), f"burst: {codes}")
        check(all(b"SlowDown" in b for s, _, b in got if s == 503),
              "a 503 without SlowDown")
        slowed = codes.count(503)
        check(slowed > 0, "no request of a burst past the limit got 503")
        shell("s3.circuitbreaker -actions=Write:Count -buckets=warm -delete")
        reload_breaker()
        codes = [s for s, _, _ in burst("b-")]
        check(codes == [200] * S3_BURST, f"after the limit left: {codes}")
        for name in [f"cb/{tag}{i}" for tag in ("a-", "b-")
                     for i in range(S3_BURST)] + ["cb/reload"]:
            check(app.send("DELETE", f"/warm/{name}")[0] == 204,
                  "DELETE of a burst object")
        log(f"s3: s3.circuitbreaker Write:Count=1 on bucket warm: "
            f"{slowed} of a burst of {S3_BURST} PUTs got 503 SlowDown; "
            f"after -delete all {S3_BURST} passed")

        # -- 9. the HBM tier: single-chunk objects read 4 times, the RAM
        # tier flushed, then read once more: an HBM hit
        probes = [{"name": f"probe/{i:02d}", "key": [3, i],
                   "size": S3_PROBE} for i in range(S3_PROBES)]
        got = load("put", probes, "probes", keys["app"], nprocs=1)
        for t in probes:
            objects[t["name"]] = [t["key"], t["size"], got["etags"][t["name"]]]
        lat = {"hbm": [], "ram": [], "miss": [], "disk": []}
        tiers = []
        counts = [None]  # the last scrape: nothing else reads meanwhile

        def probe(t):
            pre = counts[0] or cache_counts()
            t0 = time.perf_counter()
            body = app.get_object("warm", t["name"])
            dt = time.perf_counter() - t0
            check(body == s3_payload(seed, t["key"], t["size"]),
                  f"probe {t['name']} read wrong")
            post = counts[0] = cache_counts()
            tier = [k for k in lat if post[k] > pre[k]]
            check(len(tier) == 1, f"probe {t['name']}: tiers {tier}")
            lat[tier[0]].append(dt)
            return tier[0]

        for t in probes:
            tiers.append([probe(t) for _ in range(4)])
        flush = [n for n in sorted(objects) if n.startswith("obj/")][
            :S3_RAM_MB * MIB // S3_OBJECT + 2]
        reads(flush, "flush", keys["app"])
        counts[0] = None
        for t, seen in zip(probes, tiers):
            seen.append(probe(t))
            check(seen[-1] == "hbm", f"{t['name']}: the fifth read was a "
                  f"{seen[-1]} (reads {seen})")
        check(lat["miss"], f"no probe read missed: {tiers}")
        out["hbm"] = {"reads": tiers,
                      "hbm_hit_p50_ms": pct_ms(lat["hbm"], 50),
                      "miss_p50_ms": pct_ms(lat["miss"], 50),
                      "ram_hit_p50_ms": pct_ms(lat["ram"], 50)}
        log(f"s3: {S3_PROBES} single-chunk objects ({S3_PROBE} B) read 4 "
            f"times, {len(flush)} objects read past the {S3_RAM_MB} MiB RAM "
            f"tier, then read once more: every fifth read an HBM hit; p50 "
            f"HBM hit {out['hbm']['hbm_hit_p50_ms']:.3f} ms, miss "
            f"{out['hbm']['miss_p50_ms']:.3f} ms, RAM hit "
            f"{out['hbm']['ram_hit_p50_ms']:.3f} ms")

        # -- 10. replication through the CLI, on the degraded volumes;
        # the second filer (filer.sync's target) starts meanwhile
        procs[f2_addr] = cli(["filer", "-port", str(ports[3]), "-master",
                              maddr, "-db", os.path.join(workdir,
                                                         "filer2.db"),
                              "-maxMB", "4"] + device_flag, env,
                             log_of(f2_addr))
        live_bytes = sum(size for _, size, _ in objects.values())
        bk = os.path.join(workdir, "backup")
        t0 = time.perf_counter()
        cli_run(["filer.backup", "-filer", faddr, "-filerPath",
                 "/buckets/warm", "-sink", f"local://{bk}", "-once",
                 "-state", os.path.join(workdir, "backup.state")], env,
                timeout=900)
        out["backup_s"] = time.perf_counter() - t0
        files = set()
        for root_, _, fs in os.walk(bk):
            files |= {os.path.relpath(os.path.join(root_, f), bk)
                      for f in fs}
        check(files == set(objects), "filer.backup: extra "
              f"{sorted(files - set(objects))[:5]}, missing "
              f"{sorted(set(objects) - files)[:5]}")
        for name, (key, size, _) in objects.items():
            with open(os.path.join(bk, name), "rb") as f:
                check(f.read() == s3_payload(seed, key, size),
                      f"filer.backup: {name} differs")
        db = os.path.join(workdir, "meta.db")
        t0 = time.perf_counter()
        cli_run(["filer.meta.backup", "-filer", faddr, "-filerPath",
                 "/buckets/warm", "-store", db, "-once"], env)
        out["meta_backup_s"] = time.perf_counter() - t0
        listed = [json.loads(ln) for ln in cli_run(
            ["filer.meta.backup", "-filerPath", "/buckets/warm", "-store",
             db, "-restore"], env).splitlines()]
        sizes = {e["full_path"]: e["attr"]["file_size"] for e in listed
                 if not e["attr"]["mode"] & 0o40000}
        check(sizes == {f"/buckets/warm/{n}": s
                        for n, (_, s, _) in objects.items()},
              "filer.meta.backup -restore differs from the bucket")
        listening(procs[f2_addr], f2_addr, log_of(f2_addr))
        t0 = time.perf_counter()
        cli_run(["filer.sync", "-a", faddr, "-b", f2_addr, "-a.path",
                 "/buckets/warm/", "-b.path", "/buckets/warm/",
                 "-isActivePassive", "-once", "-concurrency",
                 str(S3_SYNC_LANES), "-state",
                 os.path.join(workdir, "sync.state")], env, timeout=900)
        out["sync_s"] = time.perf_counter() - t0
        load("get", [{"name": n, "key": k, "size": s, "etag": e}
                     for n, (k, s, e) in sorted(objects.items())],
             "synced", ("", ""), endpoint=f2_addr, prefix="/buckets/warm/")
        out["replicated_bytes"] = live_bytes
        for tag in ("backup", "sync"):
            s = out[f"{tag}_s"]
            log(f"s3: filer.{tag} of {len(objects)} objects ({live_bytes} "
                f"B) through the CLI: {s:.3f} s, "
                f"{live_bytes / MIB / s:.1f} MiB/s")
        log(f"s3: filer.meta.backup of {len(listed)} entries through the "
            f"CLI: {out['meta_backup_s']:.3f} s, "
            f"{len(listed) / out['meta_backup_s']:.1f} entries/s")
        log("s3: filer.backup byte-identical, filer.meta.backup -restore "
            "equal to the bucket, filer.sync -isActivePassive byte-identical "
            "through the second filer")

        # -- 11. the client tools through the CLI
        t0 = time.perf_counter()
        text = cli_run(["benchmark", "-master", maddr, "-n",
                        str(S3_BENCH_N), "-size", "1024", "-c", "8"], env,
                       timeout=600)
        out["benchmark_s"] = time.perf_counter() - t0
        for phase in ("write", "read"):
            check(f"--- {phase} ---\nrequests: {S3_BENCH_N}, errors: 0\n"
                  in text, f"benchmark: {text[-2000:]}")
        out["benchmark"] = text
        log("s3: benchmark -n %d -size 1024 -c 8 through the CLI:\n%s"
            % (S3_BENCH_N, text.rstrip()))
        up = os.path.join(workdir, "upload.bin")
        with open(up, "wb") as f:
            f.write(st)
        fid = json.loads(cli_run(["upload", up, "-master", maddr], env))["fid"]
        down = os.path.join(workdir, "download.bin")
        cli_run(["download", fid, "-master", maddr, "-output", down], env)
        with open(down, "rb") as f:
            check(f.read() == st, "download returned other bytes")
        log(f"s3: upload then download of {len(st)} B ({fid}) "
            "byte-identical")

        # -- 12. the kernels, per volume server process
        final = {v: process_counts(v) for v in vaddrs}
        if not rehearse:
            for v, c in final.items():
                check(c["gf_apply"] == c["batches"] + c["scrub_steps"],
                      f"{v}: {c['gf_apply']} K1 launches for "
                      f"{c['batches']} decode batches")
        launches = {name: sum(c[name] for c in final.values())
                    for name in KERNELS}
        out["launches_by_process"] = final
    finally:
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        left = proc_tree_pids(workdir)
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    check(not left, f"processes left after SIGTERM: {left}")
    check(all(p.returncode == 0 for p in procs.values()),
          "a process did not exit 0 on SIGTERM: " + json.dumps(
              {n: p.returncode for n, p in procs.items()}))
    out["wall_s"] = time.monotonic() - t_phase
    PHASE_NUMBERS["s3"] = out
    log("s3 numbers: " + json.dumps(
        {k: v for k, v in out.items() if k != "benchmark"}, sort_keys=True,
        default=str))
    log(f"s3: the phase took {out['wall_s']:.3f} s")
    log(f"launches on the s3 path: {launches}")
    return launches


def http_get_text(addr: str, path: str) -> str:
    from seaweedfs_tpu_torch.rpc.http_rpc import call

    return call(addr, path, parse=False).decode()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels; no main path")
    ap.add_argument("--routes", action="store_true",
                    help="build and check the kernels, time and profile "
                         "reconstruct_span's routes; no main path")
    ap.add_argument("--inline", action="store_true",
                    help="build and check the kernels, then phase 6 (inline "
                         "EC) alone")
    ap.add_argument("--cache", action="store_true",
                    help="build and check the kernels, then phase 7 (the "
                         "tiered read cache) alone")
    ap.add_argument("--server", action="store_true",
                    help="build and check the kernels, then phase 8 (the "
                         "volume server over HTTP) alone")
    ap.add_argument("--prefork", action="store_true",
                    help="build and check the kernels, then phase 9 (the "
                         "volume server with prefork workers and the TCP "
                         "fast path) alone")
    ap.add_argument("--cluster", action="store_true",
                    help="build and check the kernels, then phase 10 (a "
                         "cluster of masters and volume servers that heals "
                         "an EC volume) alone")
    ap.add_argument("--elastic", action="store_true",
                    help="build and check the kernels, then phase 11 (a "
                         "cluster of separate processes through a node "
                         "death) alone")
    ap.add_argument("--filer", action="store_true",
                    help="build and check the kernels, then phase 12 (a "
                         "filer over warm EC storage) alone")
    ap.add_argument("--s3", action="store_true",
                    help="build and check the kernels, then phase 13 (the "
                         "S3 gateway and the IAM API over warm EC "
                         "storage) alone")
    args = ap.parse_args()
    mode = ("quick" if args.quick else "kernels" if args.kernels
            else "routes" if args.routes else "inline" if args.inline
            else "cache" if args.cache else "server" if args.server
            else "prefork" if args.prefork
            else "cluster" if args.cluster
            else "elastic" if args.elastic
            else "filer" if args.filer
            else "s3" if args.s3 else "all")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()
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
    stats = kernel_phase(dev, "quick" if mode in ("routes", "inline",
                                                  "cache", "server",
                                                  "prefork", "cluster",
                                                  "elastic", "filer", "s3")
                         else mode)
    if mode in ("kernels", "routes", "all"):
        route_phase(dev)
    if mode == "routes":
        route_profile(dev)
    if mode in ("inline", "cache", "server", "prefork", "cluster",
                "elastic", "filer", "s3"):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            {"inline": inline_phase, "cache": cache_phase,
             "server": server_phase, "prefork": prefork_phase,
             "cluster": cluster_phase, "elastic": elastic_phase,
             "filer": filer_phase, "s3": s3_phase}[mode](dev, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    launches = {}
    if mode == "all":
        # each path resets the launch counts before it runs and reads
        # them after; the kernels each one must have launched
        needs = {"raw": KERNELS, "needle": KERNELS, "store": KERNELS,
                 "inline": ("gf_apply",), "cache": KERNELS,
                 "server": KERNELS, "prefork": KERNELS,
                 "cluster": KERNELS, "elastic": KERNELS, "filer": KERNELS,
                 "s3": KERNELS}
        paths = {}
        for label, phase in (("raw", main_path), ("needle", needle_phase),
                             ("store", store_phase),
                             ("inline", inline_phase),
                             ("cache", cache_phase),
                             ("server", server_phase),
                             ("prefork", prefork_phase),
                             ("cluster", cluster_phase),
                             ("elastic", elastic_phase),
                             ("filer", filer_phase),
                             ("s3", s3_phase)):
            workdir = tempfile.mkdtemp(prefix="chip_smoke_")
            t_path = time.perf_counter()
            try:
                paths[label] = phase(dev, workdir)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            log(f"path {label}: {time.perf_counter() - t_path:.3f} s")
        for label, counts in paths.items():
            for name in needs[label]:
                check(counts.get(name, 0) > 0,
                      f"{name} was not launched on the {label} path")
        launches = {name: sum(c[name] for c in paths.values())
                    for name in KERNELS}
        k5 = stats["parity_step"]
        log("parity step (K5, served by K1 and K2): " + json.dumps(
            {k: v for k, v in k5.items()}, sort_keys=True))
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
                "launches_by_path": {label: counts[name]
                                     for label, counts in paths.items()},
            })
        # an estimate of the kernels' share of phase 10's wall: each
        # launch counted at its phase 2 time, taken at phase 2's shapes
        busy_ms = sum(paths["cluster"][name] * stats[name]["ms"]
                      for name in KERNELS)
        wall_s = PHASE_NUMBERS["cluster"]["wall_s"]
        log(f"cluster: its K1 and K2 launches at phase 2's times (an "
            f"estimate at phase 2's shapes): {busy_ms:.3f} ms of the "
            f"phase's {wall_s:.3f} s ({busy_ms / 10 / wall_s:.4f}%)")
        busy_ms = sum(paths["s3"][name] * stats[name]["ms"]
                      for name in KERNELS)
        wall_s = PHASE_NUMBERS["s3"]["wall_s"]
        log(f"s3: its K1 and K2 launches at phase 2's times (an estimate "
            f"at phase 2's shapes): {busy_ms:.3f} ms of the phase's "
            f"{wall_s:.3f} s ({busy_ms / 10 / wall_s:.4f}%)")
        log(f"the whole run took {time.perf_counter() - t_run:.3f} s")
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
