"""Prometheus-style metrics registry with text exposition.

Counterpart of seaweedfs_tpu/stats/metrics.py.  A dependency-free
registry of counters, gauges and histograms that produces the Prometheus
text exposition format.  Every family the JAX package registers is
registered here under the same name, help string, labels and buckets,
so one dashboard (`grafana/`) reads either package; the EC peer-read
families are the port's alone.  `metrics_handler`
serves it at /metrics on every daemon; `start_metrics_server` serves it
on a port of its own.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

_DEFAULT_BUCKETS = (
    .0001, .0003, .001, .003, .01, .03, .1, .3, 1, 3, 10, 30, 100)


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
        for n, v in zip(names, values))
    return "{%s}" % inner


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_="", label_names=()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def labels(self, *values) -> "_CounterChild":
        return _CounterChild(self, tuple(str(v) for v in values))

    def inc(self, amount: float = 1.0, labels: tuple = ()):
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def set_cumulative(self, value: float, labels: tuple = ()):
        """Adopt an externally-maintained cumulative count (e.g. the
        C++ engine's off-GIL counters) while keeping counter semantics:
        the stored value never goes backwards, so rate()/increase()
        stay correct."""
        with self._lock:
            if value >= self._values.get(labels, 0.0):
                self._values[labels] = float(value)

    def expose(self) -> list[str]:
        lines = ["# HELP %s %s" % (self.name, self.help),
                 "# TYPE %s counter" % self.name]
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items or [((), 0.0)] if not self.label_names else items:
            lines.append("%s%s %s" % (
                self.name, _fmt_labels(self.label_names, labels),
                _fmt_value(v)))
        return lines


class _CounterChild:
    __slots__ = ("_parent", "_labels")

    def __init__(self, parent, labels):
        self._parent, self._labels = parent, labels

    def inc(self, amount: float = 1.0):
        self._parent.inc(amount, self._labels)

    def set_cumulative(self, value: float):
        self._parent.set_cumulative(value, self._labels)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_="", label_names=(), fn=None):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}
        self._fn = fn  # callable -> float, for self-sampling gauges

    def labels(self, *values) -> "_GaugeChild":
        return _GaugeChild(self, tuple(str(v) for v in values))

    def set(self, value: float, labels: tuple = ()):
        with self._lock:
            self._values[labels] = float(value)

    def add(self, amount: float, labels: tuple = ()):
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def remove(self, *values):
        """Drop every label series whose leading label values match —
        a departed scrape target must not export a stale series
        forever (and get re-ingested as a live signal)."""
        prefix = tuple(str(v) for v in values)
        with self._lock:
            for k in [k for k in self._values
                      if k[:len(prefix)] == prefix]:
                del self._values[k]

    def expose(self) -> list[str]:
        lines = ["# HELP %s %s" % (self.name, self.help),
                 "# TYPE %s gauge" % self.name]
        if self._fn is not None:
            lines.append("%s %s" % (self.name, _fmt_value(self._fn())))
            return lines
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for labels, v in items:
            lines.append("%s%s %s" % (
                self.name, _fmt_labels(self.label_names, labels),
                _fmt_value(v)))
        return lines


class _GaugeChild:
    __slots__ = ("_parent", "_labels")

    def __init__(self, parent, labels):
        self._parent, self._labels = parent, labels

    def set(self, value: float):
        self._parent.set(value, self._labels)

    def add(self, amount: float):
        self._parent.add(amount, self._labels)

    def inc(self, amount: float = 1.0):
        self._parent.add(amount, self._labels)

    def dec(self, amount: float = 1.0):
        self._parent.add(-amount, self._labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_="", label_names=(),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def labels(self, *values) -> "_HistogramChild":
        return _HistogramChild(self, tuple(str(v) for v in values))

    def observe(self, value: float, labels: tuple = ()):
        with self._lock:
            counts = self._counts.setdefault(
                labels, [0] * (len(self.buckets) + 1))
            self._sums[labels] = self._sums.get(labels, 0.0) + value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    return
            counts[-1] += 1

    def time(self, labels: tuple = ()):
        return _Timer(self, labels)

    def expose(self) -> list[str]:
        lines = ["# HELP %s %s" % (self.name, self.help),
                 "# TYPE %s histogram" % self.name]
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        for labels, counts in items:
            cumulative = 0
            for b, c in zip(self.buckets, counts):
                cumulative += c
                lines.append('%s_bucket%s %d' % (
                    self.name,
                    _fmt_labels(self.label_names + ("le",),
                                labels + (_fmt_value(b),)),
                    cumulative))
            cumulative += counts[-1]
            lines.append('%s_bucket%s %d' % (
                self.name,
                _fmt_labels(self.label_names + ("le",), labels + ("+Inf",)),
                cumulative))
            lines.append("%s_sum%s %s" % (
                self.name, _fmt_labels(self.label_names, labels),
                _fmt_value(sums[labels])))
            lines.append("%s_count%s %d" % (
                self.name, _fmt_labels(self.label_names, labels), cumulative))
        return lines


class _HistogramChild:
    __slots__ = ("_parent", "_labels")

    def __init__(self, parent, labels):
        self._parent, self._labels = parent, labels

    def observe(self, value: float):
        self._parent.observe(value, self._labels)

    def time(self):
        return _Timer(self._parent, self._labels)


class _Timer:
    def __init__(self, hist, labels):
        self._hist, self._labels = hist, labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, self._labels)
        return False


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help_="", label_names=()) -> Counter:
        return self.register(Counter(name, help_, label_names))

    def gauge(self, name, help_="", label_names=(), fn=None) -> Gauge:
        return self.register(Gauge(name, help_, label_names, fn=fn))

    def histogram(self, name, help_="", label_names=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, label_names, buckets))

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# The standard vectors upstream SeaweedFS registers (weed/stats/metrics.go),
# shared by every daemon in-process.
MasterReceivedHeartbeatCounter = REGISTRY.counter(
    "SeaweedFS_master_received_heartbeats", "master received heartbeats",
    ("type",))
MasterVolumeLayoutWritable = REGISTRY.gauge(
    "SeaweedFS_master_volume_layout_writable",
    "writable volumes per layout", ("collection", "rp", "ttl"))
MasterPickForWriteErrorCounter = REGISTRY.counter(
    "SeaweedFS_master_pick_for_write_error", "pick-for-write errors")
VolumeServerRequestCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_request_total", "volume server requests",
    ("type",))
VolumeServerRequestHistogram = REGISTRY.histogram(
    "SeaweedFS_volumeServer_request_seconds", "volume server request latency",
    ("type",))
# requests served entirely by the native engine (off-GIL; adopted from
# the C++ cumulative counters right before each exposition — a counter,
# so Prometheus rate()/increase() type-check)
VolumeServerNativeRequestCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_native_request_total",
    "native fast-path requests", ("type",))
VolumeServerVolumeCounter = REGISTRY.gauge(
    "SeaweedFS_volumeServer_volumes", "volumes managed", ("collection", "type"))
VolumeServerReadOnlyVolumeGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_read_only_volumes", "read-only volumes")
VolumeServerProxiedReadCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_proxied_read_total",
    "non-local reads served per readMode outcome", ("mode",))
VolumeServerThrottleRejects = REGISTRY.counter(
    "SeaweedFS_volumeServer_throttle_rejects_total",
    "requests rejected (429) by the in-flight byte throttles",
    ("direction",))
VolumeFsyncBatchCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_fsync_batches_total",
    "group-commit fsync batches flushed")
EcEncodeBytesCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_encode_bytes_total",
    "volume bytes pushed through the batched EC encode pipeline")
EcEncodeStageSeconds = REGISTRY.gauge(
    "SeaweedFS_volumeServer_ec_encode_stage_seconds",
    "busy seconds per host EC encode stage, last encode run", ("stage",))
EcWritebackFlushCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_writeback_flushes_total",
    "sync_file_range writeback-pacing windows flushed by EC writers")
EcRecoverStageSeconds = REGISTRY.gauge(
    "SeaweedFS_volumeServer_ec_recover_stage_seconds",
    "cumulative busy seconds per degraded-read stage", ("stage",))
EcRecoverCacheCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_recover_cache_total",
    "recovered-block cache lookups by outcome "
    "(hit / miss / coalesced)", ("result",))
EcRecoverSpanCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_recover_spans_total",
    "spans reconstructed on the degraded-read path, by decode mode",
    ("mode",))
EcRecoverBytesCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_recover_bytes_total",
    "survivor bytes pushed through degraded-read decodes")
# inline write-path EC (storage/erasure_coding/inline.py): needles
# stream straight into striped shard logs, parity commits per stripe
EcInlineStripesCommitted = REGISTRY.counter(
    "SeaweedFS_ec_inline_stripes_committed_total",
    "stripe commit records appended by inline EC writers "
    "(full = a complete k-block row, tail = a zero-padded partial row)",
    ("kind",))
EcInlineTailBytes = REGISTRY.gauge(
    "SeaweedFS_ec_inline_tail_bytes",
    "bytes buffered in the partially-filled tail stripe, last writer")
EcInlineWriteAmp = REGISTRY.gauge(
    "SeaweedFS_ec_inline_write_amp",
    "physical bytes written / logical bytes ingested, last inline "
    "EC commit (the (k+p)/k floor is 1.4 for RS(10,4))")
EcInlineBytesCounter = REGISTRY.counter(
    "SeaweedFS_ec_inline_bytes_total",
    "inline EC writer traffic: logical = needle stream bytes acked, "
    "physical = extra parity + commit-record bytes", ("kind",))
EcInlineCommitSeconds = REGISTRY.histogram(
    "SeaweedFS_ec_inline_stripe_commit_seconds",
    "stripe commit latency: QoS background-lane wait + parity encode "
    "+ shard-log and commit-record writes")
# device pipeline: the HBM slab pool behind the batched EC dispatch
# path (ops/device_pool.py) and the host<->device transfer volume of
# the encode/rebuild/recover device paths
DevicePoolSlotsGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_device_pool_slots",
    "EC device-pool slabs by state (free / leased / resident)",
    ("state",))
DevicePoolBytesGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_device_pool_bytes",
    "total bytes retained or leased by the EC device slab pool")
DevicePoolEvictionsCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_device_pool_evictions_total",
    "idle EC device-pool slabs evicted by the WEED_EC_DEVICE_POOL_MB cap")
EcDeviceH2dBytesCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_device_h2d_bytes_total",
    "bytes staged host->device by the EC device dispatch paths, by "
    "target device (\"host\" = host staging, \"sharded:N\" = an N-way "
    "sharded mesh transfer)", ("device",))
EcDeviceD2hBytesCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_device_d2h_bytes_total",
    "bytes fetched device->host by the EC device dispatch paths, by "
    "source device", ("device",))
DevicePoolDeviceBytesGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_device_pool_device_bytes",
    "EC device-pool slab bytes by placement (per-device free-lists "
    "never cross devices)", ("device",))
FilerChunkCacheCounter = REGISTRY.counter(
    "SeaweedFS_filer_chunk_cache_total",
    "filer chunk cache lookups", ("result",))
# unified HBM -> host RAM -> disk read-through cache (cache/ package)
ReadCacheRequestsCounter = REGISTRY.counter(
    "SeaweedFS_read_cache_requests_total",
    "unified read cache lookups by serving tier "
    "(hbm / ram / disk / miss)", ("tier",))
ReadCacheFillCounter = REGISTRY.counter(
    "SeaweedFS_read_cache_fill_total",
    "read cache fill admissions (admitted / qos_bypass — background "
    "traffic bypasses the fill path unless WEED_READ_CACHE_BG_FILL=1)",
    ("outcome",))
ReadCacheResidentBytesGauge = REGISTRY.gauge(
    "SeaweedFS_read_cache_resident_bytes",
    "bytes resident in the unified read cache, by tier", ("tier",))
ReadCacheInvalidationsCounter = REGISTRY.counter(
    "SeaweedFS_read_cache_invalidations_total",
    "read cache entries dropped by cause "
    "(delete / overwrite / vacuum / rebuild / stale)", ("reason",))
ChunkCacheOversizeDropsCounter = REGISTRY.counter(
    "SeaweedFS_chunk_cache_oversize_drops_total",
    "chunks too large for every segment of a disk cache layer, "
    "dropped at admission (historically a silent drop)")
# gateway fast-path vectors: fid leasing on the write path, streamed
# chunk prefetch on the read path, and the signature caches that keep
# per-request crypto off the hot path
FilerFidLeaseCounter = REGISTRY.counter(
    "SeaweedFS_filer_fid_lease_total",
    "fid lease cache outcomes on the filer assign path "
    "(hit / miss / refill / expired / invalidated / stale_retry)",
    ("event",))
FilerPrefetchWindowGauge = REGISTRY.gauge(
    "SeaweedFS_filer_read_prefetch_window",
    "chunk fetches in flight ahead of the streaming GET cursor")
FilerStreamedReadCounter = REGISTRY.counter(
    "SeaweedFS_filer_read_reply_total",
    "filer GET replies by delivery mode (streamed / buffered)",
    ("mode",))
JwtCacheCounter = REGISTRY.counter(
    "SeaweedFS_security_jwt_cache_total",
    "JWT signature-verification cache lookups (hit / miss)",
    ("result",))
S3SigV4KeyCacheCounter = REGISTRY.counter(
    "SeaweedFS_s3_sigv4_key_cache_total",
    "SigV4 derived signing-key cache lookups (hit / miss)",
    ("result",))
FilerRequestCounter = REGISTRY.counter(
    "SeaweedFS_filer_request_total", "filer requests", ("type",))
FilerRequestHistogram = REGISTRY.histogram(
    "SeaweedFS_filer_request_seconds", "filer request latency", ("type",))
S3RequestCounter = REGISTRY.counter(
    "SeaweedFS_s3_request_total", "s3 requests", ("action", "code"))
S3RequestHistogram = REGISTRY.histogram(
    "SeaweedFS_s3_request_seconds", "s3 request latency", ("action",))
# cross-hop tracing vectors: observed SERVER-side in RpcServer dispatch
# (src from the caller's X-Trace-Src header, dst = the serving daemon,
# route = the matched route prefix — bounded label sets, no addresses)
RpcHopHistogram = REGISTRY.histogram(
    "SeaweedFS_rpc_hop_seconds",
    "cross-daemon request hop latency by source/destination/route",
    ("src", "dst", "route"))
RpcInflightGauge = REGISTRY.gauge(
    "SeaweedFS_rpc_inflight_requests",
    "requests currently inside a daemon's dispatch", ("service",))
TraceRetentionCounter = REGISTRY.counter(
    "SeaweedFS_trace_traces_total",
    "root-span trace retention decisions (kept / dropped)", ("result",))
# fault-tolerance layer vectors: retries/hedges observed CLIENT-side in
# rpc/policy.py, breaker state per destination, injected faults from
# util/faults.py, and master-side dead-node reaps
RpcRetryCounter = REGISTRY.counter(
    "SeaweedFS_rpc_retries_total",
    "outbound retry decisions by route and reason "
    "(retry / budget_dry / deadline)", ("route", "reason"))
RpcHedgeCounter = REGISTRY.counter(
    "SeaweedFS_rpc_hedges_total",
    "hedged idempotent reads by route (fired / win)",
    ("route", "outcome"))
BreakerStateGauge = REGISTRY.gauge(
    "SeaweedFS_breaker_state",
    "per-destination circuit breaker state "
    "(0=closed 1=open 2=half-open)", ("dst",))
FaultsInjectedCounter = REGISTRY.counter(
    "SeaweedFS_faults_injected_total",
    "faults fired by the deterministic injection registry",
    ("kind", "rule"))
TopologyDeadNodesCounter = REGISTRY.counter(
    "SeaweedFS_topology_dead_nodes_total",
    "volume servers reaped by the master after missed heartbeats")
VolumeReadonlyDemotions = REGISTRY.counter(
    "SeaweedFS_volume_readonly_demotions_total",
    "volumes auto-demoted to read-only after disk write failures")


# -- continuous profiling (profiling.py): the always-on folded-stack
# sampler's self-measured duty cycle and per-route sample counts, plus
# the device-side kernel telemetry fed by the EC dispatch pipeline
def _profiler_overhead() -> float:
    from .. import profiling

    return profiling.overhead_ratio()


def _profiler_stacks() -> float:
    from .. import profiling

    return profiling.stack_count()


ProfilerOverheadGauge = REGISTRY.gauge(
    "SeaweedFS_profiler_overhead_ratio",
    "fraction of wall time the always-on stack sampler spends sampling",
    fn=_profiler_overhead)
ProfilerStacksGauge = REGISTRY.gauge(
    "SeaweedFS_profiler_stacks",
    "distinct folded stacks interned by the always-on sampler",
    fn=_profiler_stacks)
ProfilerRouteSamplesCounter = REGISTRY.counter(
    "SeaweedFS_profiler_route_samples_total",
    "always-on profiler samples attributed to an active RPC route",
    ("route",))
EcKernelDispatchHistogram = REGISTRY.histogram(
    "SeaweedFS_volumeServer_ec_kernel_dispatch_ready_seconds",
    "host-observed dispatch->ready latency per EC device batch, by the "
    "device count the batch was sharded over", ("devices",))
EcKernelFlopsGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_ec_kernel_flops",
    "XLA cost-analysis flops per compiled EC parity geometry",
    ("geometry",))
EcKernelBytesGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_ec_kernel_bytes_accessed",
    "XLA cost-analysis bytes accessed per compiled EC parity geometry",
    ("geometry",))
DevicePoolHwmBytesGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_device_pool_hwm_bytes",
    "high-watermark of bytes held by the EC device slab pool")
DevicePoolHwmSecondsGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_device_pool_hwm_seconds",
    "seconds the EC device slab pool spent at >=95% of its watermark")
# maintenance curator (seaweedfs_tpu/maintenance): the leader's job
# queue, the workers' execution outcomes, and the byte pacer that
# keeps background scrubs out of the foreground's way
MaintQueueJobsGauge = REGISTRY.gauge(
    "SeaweedFS_master_maintenance_queue_jobs",
    "live maintenance jobs in the curator queue, by state",
    ("state",))
MaintJobsCounter = REGISTRY.counter(
    "SeaweedFS_master_maintenance_jobs_total",
    "maintenance jobs finished, by type and outcome",
    ("type", "outcome"))
MaintJobSecondsHistogram = REGISTRY.histogram(
    "SeaweedFS_volumeServer_maintenance_job_seconds",
    "maintenance job execution latency on the worker, by type",
    ("type",))
MaintScrubbedBytesCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_maintenance_scrubbed_bytes_total",
    "shard bytes streamed through deep scrub")
# EC shard spans fetched from peers by a volume server's remote reader
# (degraded reads, deep scrubs of spread volumes), by the caller's QoS
# class; the seconds are summed over the fetching threads.  The port's
# own families: the JAX package has no such counters.
EcPeerReadBytesCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_peer_read_bytes_total",
    "EC shard bytes fetched from peer volume servers", ("qos_class",))
EcPeerReadSecondsCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_peer_read_seconds_total",
    "seconds spent fetching EC shard spans from peers, summed over "
    "threads", ("qos_class",))
EcPeerReadErrorsCounter = REGISTRY.counter(
    "SeaweedFS_volumeServer_ec_peer_read_errors_total",
    "EC shard span fetches that no peer answered", ("qos_class",))
MaintPacerRateGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_maintenance_pacer_bytes_per_second",
    "effective maintenance byte rate after foreground-load backoff")
# repair-efficient coding tier (storage/erasure_coding/codes): rebuild
# traffic by code family — read_bytes counts survivor bytes CONSUMED by
# the rebuilder (post-projection for regenerating codes, i.e. what a
# distributed rebuild moves over the network)
MaintEcRebuildReadBytes = REGISTRY.counter(
    "SeaweedFS_volumeServer_maintenance_ec_rebuild_read_bytes_total",
    "survivor bytes consumed by EC rebuilds, by code family",
    ("family",))
MaintEcRebuildRebuiltBytes = REGISTRY.counter(
    "SeaweedFS_volumeServer_maintenance_ec_rebuild_rebuilt_bytes_total",
    "shard bytes written by EC rebuilds, by code family",
    ("family",))
MaintEcRebuildReadAmpGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_maintenance_ec_rebuild_read_amp",
    "bytes read per rebuilt byte across this process's EC rebuilds, "
    "by code family",
    ("family",))
# control-plane raft (seaweedfs_tpu/master/raft.py): one series per
# local raft node, labeled by its advertised address, so a 3-master
# deployment shows term agreement and replication lag at a glance
RaftTermGauge = REGISTRY.gauge(
    "SeaweedFS_raft_term",
    "current raft term on this master", ("node",))
RaftCommitIndexGauge = REGISTRY.gauge(
    "SeaweedFS_raft_commit_index",
    "highest quorum-committed raft log index on this master", ("node",))
RaftAppliedLagGauge = REGISTRY.gauge(
    "SeaweedFS_raft_applied_lag",
    "raft log entries appended but not yet applied to the FSM "
    "(last_index - applied_index)", ("node",))


# -- cluster QoS: tenant-aware admission, weighted-fair queues, and the
# foreground/background device lanes ----------------------------------------
QosRequestsCounter = REGISTRY.counter(
    "SeaweedFS_qos_requests_total",
    "front-end requests by QoS class and admission outcome",
    ("service", "class", "outcome"))
QosInflightGauge = REGISTRY.gauge(
    "SeaweedFS_qos_inflight",
    "admitted in-flight requests per QoS class",
    ("service", "class"))
QosQueueDepthGauge = REGISTRY.gauge(
    "SeaweedFS_qos_queue_depth",
    "requests parked in the weighted-fair queues per QoS class",
    ("service", "class"))
QosQueueWaitHistogram = REGISTRY.histogram(
    "SeaweedFS_qos_queue_wait_seconds",
    "time a request spent queued before dispatch or shed",
    ("class",))
QosTenantThrottledCounter = REGISTRY.counter(
    "SeaweedFS_qos_tenant_throttled_total",
    "requests denied by per-tenant token buckets",
    ("service", "class"))
QosQuotaRejectsCounter = REGISTRY.counter(
    "SeaweedFS_qos_quota_rejects_total",
    "assigns/uploads denied by per-collection quotas, by resource kind",
    ("kind",))
QosLaneActiveGauge = REGISTRY.gauge(
    "SeaweedFS_qos_lane_active",
    "device-lane work items currently active, by lane",
    ("lane",))
QosLaneBatchesCounter = REGISTRY.counter(
    "SeaweedFS_qos_lane_batches_total",
    "device batches dispatched, by lane",
    ("lane",))
QosLanePreemptionsCounter = REGISTRY.counter(
    "SeaweedFS_qos_lane_preemptions_total",
    "background device batches stalled behind foreground decodes")
QosLaneWaitSecondsCounter = REGISTRY.counter(
    "SeaweedFS_qos_lane_wait_seconds_total",
    "cumulative seconds background batches waited on the foreground lane")
QosSharedGateOccupancyGauge = REGISTRY.gauge(
    "SeaweedFS_qos_shared_gate_occupancy",
    "fleet-wide admission occupancy ((inflight+queued)/limit) read from "
    "the cross-worker shared-memory gate rows",
    ("service",))


# -- prefork gateway workers (rpc/prefork.py): worker-fleet health and
# the zero-copy writeback path ----------------------------------------------
GatewayWorkersGauge = REGISTRY.gauge(
    "SeaweedFS_gateway_workers",
    "configured prefork worker processes sharding this gateway's port",
    ("service",))
GatewayWorkerRespawnsCounter = REGISTRY.counter(
    "SeaweedFS_gateway_worker_respawns_total",
    "crashed gateway workers respawned by the prefork supervisor",
    ("service",))
GatewaySendfileBytesCounter = REGISTRY.counter(
    "SeaweedFS_gateway_sendfile_bytes_total",
    "response bytes spliced to client sockets with os.sendfile "
    "(zero-copy writeback), by service",
    ("service",))


# -- cluster elasticity: per-node load telemetry the autoscale
# detectors consume, and the scale events they emit -------------------------
ScaleNodeOccupancyGauge = REGISTRY.gauge(
    "SeaweedFS_master_scale_node_occupancy",
    "admission-gate occupancy ((inflight+queued)/limit) last "
    "heartbeated by each volume server", ("node",))
ScaleNodeRpsGauge = REGISTRY.gauge(
    "SeaweedFS_master_scale_node_rps",
    "object requests per second last heartbeated by each volume server",
    ("node",))
ScaleClusterSizeGauge = REGISTRY.gauge(
    "SeaweedFS_master_scale_cluster_volume_servers",
    "volume servers currently registered in the topology")
ScaleEventsCounter = REGISTRY.counter(
    "SeaweedFS_master_scale_events_total",
    "autoscale jobs enqueued by the curator, by action (up|drain)",
    ("action",))
VolumeServerDrainingGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_draining",
    "1 while this volume server is draining (read-only, being "
    "evacuated before deregistration)")


# -- cluster health plane (master/health.py): the leader-resident scrape
# loop, the ring TSDB it fills, the SLO burn-rate evaluator, and the
# structured event journal ---------------------------------------------------
ClusterTargetUpGauge = REGISTRY.gauge(
    "SeaweedFS_cluster_target_up",
    "1 when the leader's last /metrics scrape of this daemon "
    "succeeded, 0 when it failed or timed out", ("target", "kind"))
ClusterScrapeErrorsCounter = REGISTRY.counter(
    "SeaweedFS_cluster_scrape_errors_total",
    "scrape attempts that failed or blew their per-target deadline",
    ("target",))
ClusterScrapeRoundsCounter = REGISTRY.counter(
    "SeaweedFS_cluster_scrape_rounds_total",
    "scrape rounds completed by the leader's health plane")
ClusterScrapeDutyGauge = REGISTRY.gauge(
    "SeaweedFS_cluster_scrape_duty_ratio",
    "scrape-loop busy seconds per second of wall clock at the "
    "configured WEED_HEALTH_SCRAPE_MS cadence (self-measured)")
ClusterTsdbSeriesGauge = REGISTRY.gauge(
    "SeaweedFS_cluster_tsdb_series",
    "live series held by the in-memory ring TSDB")
ClusterTsdbDroppedCounter = REGISTRY.counter(
    "SeaweedFS_cluster_tsdb_dropped_total",
    "samples dropped because the WEED_TSDB_MAX_SERIES cap was hit")
ClusterSloBurnRateGauge = REGISTRY.gauge(
    "SeaweedFS_cluster_slo_burn_rate",
    "error-budget burn rate per SLO rule and window (1.0 = burning "
    "exactly the budget; >1 exhausts it early)", ("rule", "window"))
ClusterSloAlertGauge = REGISTRY.gauge(
    "SeaweedFS_cluster_slo_alert_firing",
    "1 while this SLO rule's multi-window burn-rate alert is firing",
    ("rule",))
ClusterSloTransitionsCounter = REGISTRY.counter(
    "SeaweedFS_cluster_slo_alert_transitions_total",
    "alert state transitions per SLO rule (fire|clear)",
    ("rule", "to"))
ClusterEventsCounter = REGISTRY.counter(
    "SeaweedFS_cluster_events_total",
    "structured events appended to this process's journal, by kind",
    ("kind",))


# -- workload analytics plane (stats/access.py + stats/sketch.py): the
# per-daemon access recorder's own health, and the leader's assembled
# cluster usage view -----------------------------------------------------


def _access_tracked_keys() -> float:
    from . import access

    return float(access.tracked_keys_total())


def _access_sketch_bytes() -> float:
    from . import access

    return float(access.memory_bytes_total())


AccessRecordsCounter = REGISTRY.counter(
    "SeaweedFS_access_records_total",
    "data-path accesses fed to this daemon's access recorder, by op "
    "(read|write|delete|chunk)", ("op",))
AccessTrackedKeysGauge = REGISTRY.gauge(
    "SeaweedFS_access_tracked_keys",
    "fids currently tracked by the hot-key Space-Saving sketch "
    "(bounded by WEED_HEAT_MAX_KEYS)", fn=_access_tracked_keys)
AccessSketchBytesGauge = REGISTRY.gauge(
    "SeaweedFS_access_sketch_bytes",
    "approximate resident footprint of this daemon's access sketches",
    fn=_access_sketch_bytes)
UsageReadsGauge = REGISTRY.gauge(
    "SeaweedFS_usage_reads",
    "decay-weighted fleet read ops in the leader's merged usage view")
UsageWritesGauge = REGISTRY.gauge(
    "SeaweedFS_usage_writes",
    "decay-weighted fleet write ops in the leader's merged usage view")
UsageBytesGauge = REGISTRY.gauge(
    "SeaweedFS_usage_bytes",
    "decay-weighted fleet bytes moved in the merged usage view, by "
    "direction (read|write)", ("op",))
UsageDistinctKeysGauge = REGISTRY.gauge(
    "SeaweedFS_usage_distinct_keys",
    "HyperLogLog distinct-fid estimate across all reporting daemons")
UsageTenantsGauge = REGISTRY.gauge(
    "SeaweedFS_usage_tenants",
    "tenants present in the leader's merged usage view")
UsageCollectionsGauge = REGISTRY.gauge(
    "SeaweedFS_usage_collections",
    "collections present in the leader's merged usage view")
UsageHotShareGauge = REGISTRY.gauge(
    "SeaweedFS_usage_hot_share",
    "share of fleet reads hitting the single hottest fid (the "
    "access.hotkey journal event fires past WEED_HEAT_HOT_SHARE)")


# -- process self-metrics (upstream SeaweedFS's Go runtime collectors:
# prometheus.NewGoCollector/NewProcessCollector) -----------------------------
_PROCESS_START = time.time()
try:
    import resource as _resource
except ImportError:  # non-POSIX fallback
    _resource = None


def _proc_rss_bytes() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os as _os

        return float(pages * _os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        if _resource is not None:
            # ru_maxrss is KiB on Linux (peak, not current — still
            # better than nothing where /proc is unavailable)
            return float(
                _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss * 1024)
        return 0.0


def _proc_open_fds() -> float:
    try:
        import os as _os

        return float(len(_os.listdir("/proc/self/fd")))
    except OSError:
        return 0.0


def _proc_gc_collections() -> float:
    import gc

    return float(sum(s.get("collections", 0) for s in gc.get_stats()))


ProcessResidentMemoryGauge = REGISTRY.gauge(
    "SeaweedFS_process_resident_memory_bytes",
    "resident set size of this process", fn=_proc_rss_bytes)
ProcessOpenFdsGauge = REGISTRY.gauge(
    "SeaweedFS_process_open_fds",
    "open file descriptors in this process", fn=_proc_open_fds)
ProcessThreadsGauge = REGISTRY.gauge(
    "SeaweedFS_process_threads",
    "live Python threads in this process",
    fn=lambda: float(threading.active_count()))
ProcessGcCollectionsGauge = REGISTRY.gauge(
    "SeaweedFS_process_gc_collections",
    "cumulative GC collections across generations",
    fn=_proc_gc_collections)
ProcessUptimeGauge = REGISTRY.gauge(
    "SeaweedFS_process_uptime_seconds",
    "seconds since this process registered its metrics",
    fn=lambda: time.time() - _PROCESS_START)
ProcessStartTimeGauge = REGISTRY.gauge(
    "SeaweedFS_process_start_time_seconds",
    "unix time the process registered its metrics",
    fn=lambda: _PROCESS_START)


def _label_sample(line: str, worker: str) -> str:
    """Inject worker="<id>" into one exposition sample line.  Split on
    the LAST space (label values may contain escaped spaces/braces, the
    value never does)."""
    sample, _, value = line.rpartition(" ")
    if not sample:
        return line
    if sample.endswith("}"):
        return f'{sample[:-1]},worker="{worker}"}} {value}'
    return f'{sample}{{worker="{worker}"}} {value}'


def merge_expositions(parts: "list[tuple[str, str]]") -> str:
    """Merge per-worker /metrics scrapes into one exposition: every
    sample gains a worker="<id>" label, and each family's # HELP/# TYPE
    header appears exactly once with ALL workers' samples grouped under
    it (prometheus parsers reject duplicate family blocks).  `parts` is
    [(worker_id, exposition_text), ...]; the prefork aggregation route
    (rpc/prefork.py) feeds it the local registry plus sideband scrapes."""
    meta: dict = {}          # family -> [help/type lines]
    samples: dict = {}       # family -> [labeled sample lines]
    order: list = []         # family first-seen order
    for worker, text in parts:
        family = ""
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("#"):
                words = line.split(None, 3)
                if len(words) >= 3 and words[1] in ("HELP", "TYPE"):
                    family = words[2]
                    if family not in meta:
                        meta[family] = []
                        samples[family] = []
                        order.append(family)
                    if len(meta[family]) < 2:  # HELP + TYPE, once
                        meta[family].append(line)
                continue
            if family not in samples:  # headerless stray sample
                meta[family] = []
                samples[family] = []
                order.append(family)
            samples[family].append(_label_sample(line, worker))
    out = []
    for family in order:
        out.extend(meta[family])
        out.extend(samples[family])
    return "\n".join(out) + "\n"


def metrics_handler(req):
    """RpcServer route serving the registry in text exposition format."""
    from ..rpc.http_rpc import Response

    return Response(REGISTRY.expose().encode(),
                    content_type="text/plain; version=0.0.4")


def start_metrics_server(host: str = "127.0.0.1",
                         port: int = 0):
    """Dedicated metrics endpoint on its own port (the reference's
    -metricsPort; stats/metrics.go StartMetricsServer).  Daemons whose
    main port serves a user namespace (filer paths, s3 buckets) cannot
    mount /metrics there without shadowing user data."""
    from .. import profiling, qos, tracing
    from ..rpc.http_rpc import RpcServer
    from ..util import faults

    server = RpcServer(host, port, service_name="metrics")
    server.add("GET", "/metrics", metrics_handler)
    server.add("GET", "/debug/traces", tracing.traces_handler)
    faults.mount(server)
    profiling.mount(server)
    qos.mount(server)
    server.start()
    return server
