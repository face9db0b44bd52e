"""Workload-replay traffic engine (loadgen).

Seeded-deterministic generators for Haystack-style skewed traffic —
zipfian object popularity, object-size mixtures, a diurnal tenant mix
across hundreds of QoS tenants, and open-loop Poisson request
schedules — plus a replay pool that drives a schedule against a live
mini-cluster with the QoS class/tenant headers installed per request.

Determinism contract: every random decision hashes
``blake2b(f"{seed}:{stream}:{n}")`` exactly like the fault-injection
replay (util/faults.py), so the k-th draw of a named stream is a pure
function of the seed — the same ``WEED_LOAD_SEED`` yields a
byte-identical schedule regardless of worker interleaving.

The port's own copy of seaweedfs_tpu/loadgen/__init__.py.
"""

from .generators import (DiurnalTenantMix, Request, SizeMixture,
                         ZipfPopularity, build_schedule, load_seed,
                         poisson_arrivals, schedule_bytes, tenant_class)
from .replay import ReplayStats, percentile, replay

__all__ = [
    "DiurnalTenantMix", "Request", "SizeMixture", "ZipfPopularity",
    "build_schedule", "load_seed", "poisson_arrivals", "schedule_bytes",
    "tenant_class", "ReplayStats", "percentile", "replay",
]
