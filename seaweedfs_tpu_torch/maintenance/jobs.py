"""Typed maintenance jobs (the curator's unit of work).

Each job targets one volume (or the whole cluster for the global
types) and carries a small params dict the executor interprets.  Jobs
are deduped by (type, volume, collection) while live, so a detector
firing every scan cannot flood the queue — at most one live job per
target exists at a time (single-flight per volume).

The port's own copy of seaweedfs_tpu/maintenance/jobs.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# Job types in repair-urgency order: a lost/corrupt EC shard burns
# durability margin, so it outranks replica fixes, which outrank
# space reclaim, which outranks the background integrity sweep and
# cosmetic placement moves.  Elasticity jobs (the autoscaler's
# scale.up / scale.drain) come last: capacity changes are never more
# urgent than durability repairs.
TYPE_EC_REBUILD = "ec.rebuild"
TYPE_FIX_REPLICATION = "fix.replication"
TYPE_VACUUM = "vacuum"
TYPE_DEEP_SCRUB = "deep.scrub"
TYPE_BALANCE = "balance"
TYPE_SCALE_UP = "scale.up"
TYPE_SCALE_DRAIN = "scale.drain"
# filer shard-count elasticity: handled by the curator proposing
# filer.resize through raft directly, never enqueued as worker jobs
TYPE_SHARD_SPLIT = "filer.shard_split"
TYPE_SHARD_MERGE = "filer.shard_merge"
# advisory placement hint from the temperature detector: this volume
# is cold enough for the remote tier (storage/tier.py); least urgent
# of all — moving cold data is never time-critical
TYPE_TIER_MOVE = "tier.move"

PRIORITIES = {
    TYPE_EC_REBUILD: 0,
    TYPE_FIX_REPLICATION: 1,
    TYPE_VACUUM: 2,
    TYPE_DEEP_SCRUB: 3,
    TYPE_BALANCE: 4,
    TYPE_SCALE_UP: 5,
    TYPE_SCALE_DRAIN: 6,
    TYPE_TIER_MOVE: 7,
}
JOB_TYPES = tuple(PRIORITIES)

# job lifecycle states
PENDING = "pending"
LEASED = "leased"
DONE = "done"


@dataclass
class Job:
    id: str
    type: str
    volume: int = 0            # 0 for cluster-global jobs
    collection: str = ""
    params: dict = field(default_factory=dict)
    priority: int = 0
    state: str = PENDING
    created_at: float = 0.0
    not_before: float = 0.0    # retry backoff gate
    attempts: int = 0
    worker: str = ""
    lease_expires: float = 0.0
    last_error: str = ""
    outcome: str = ""

    @property
    def key(self) -> tuple:
        return (self.type, self.volume, self.collection)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Job":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
