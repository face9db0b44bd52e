"""Admin shell: maintenance.* commands over the curator's HTTP surface.

Thin RPC wrappers around the master's /maintenance/* routes
(maintenance/curator.py): status and queue inspection, pause/resume,
and forcing a detector pass or a single explicit job.  No reference
analogue — the reference's maintenance lives in ad-hoc shell commands
run by an operator; here the curator runs them continuously.

The port's own copy of seaweedfs_tpu/shell/commands_maintenance.py.
"""

from __future__ import annotations

from typing import Optional

from .commands import CommandEnv


def maintenance_status(env: CommandEnv) -> dict:
    """Curator status: enabled/leader flags, scan counters, queue depth
    by state and type, per-volume last deep-scrub clock."""
    return env.master("/maintenance/status")


def maintenance_queue(env: CommandEnv) -> dict:
    """Live jobs plus the tail of finished-job history."""
    return env.master("/maintenance/queue")


def maintenance_pause(env: CommandEnv, paused: bool = True) -> dict:
    """Stop (or resume) handing out leases; detectors keep enqueueing."""
    return env.master("/maintenance/pause", {"paused": bool(paused)})


def maintenance_run(env: CommandEnv, job_type: Optional[str] = None,
                    volume: int = 0, collection: str = "",
                    params: Optional[dict] = None) -> dict:
    """Force work now: with job_type, enqueue that one job; without,
    run a full detector pass instead of waiting for the interval."""
    if job_type:
        return env.master("/maintenance/run",
                          {"type": job_type, "volume": int(volume),
                           "collection": collection,
                           "params": params or {}})
    return env.master("/maintenance/run", {})
