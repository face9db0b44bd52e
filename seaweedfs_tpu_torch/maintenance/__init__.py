"""Continuous maintenance: curator scheduler, job queue, workers.

The master's leader runs a :class:`Curator` that scans heartbeat state
for anomalies (missing EC shards, under-replication, garbage, stale
scrubs, placement skew) and feeds a persistent deduped priority
:class:`JobQueue`.  Volume servers run a :class:`MaintenanceWorker`
that leases jobs, executes them under a :class:`BytePacer` that backs
off against foreground load, and reports outcomes.  Deep scrub
re-encodes data-shard spans through the pooled parity step (K1 on the
card) and compares chained CRCs against the stored `.vif` records.

The port's own copy of seaweedfs_tpu/maintenance/__init__.py, less the
re-export of the `deep_scrub` and `deep_scrub_host` functions: the first
would shadow the `deep_scrub` module's name in this package (import them
from `.deep_scrub`)."""

from .curator import Curator
from .deep_scrub import ScrubTarget
from .jobs import (JOB_TYPES, TYPE_BALANCE, TYPE_DEEP_SCRUB,
                   TYPE_EC_REBUILD, TYPE_FIX_REPLICATION, TYPE_VACUUM,
                   Job)
from .pacer import BytePacer
from .queue import JobQueue
from .worker import MaintenanceWorker

__all__ = [
    "Curator", "MaintenanceWorker", "JobQueue", "Job", "BytePacer",
    "ScrubTarget", "JOB_TYPES",
    "TYPE_EC_REBUILD", "TYPE_FIX_REPLICATION", "TYPE_VACUUM",
    "TYPE_DEEP_SCRUB", "TYPE_BALANCE",
]
