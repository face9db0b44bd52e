"""Volume-server maintenance worker: lease, execute, report.

Each volume server runs one worker thread (WEED_MAINT_WORKER=0
disables) that polls the master's /maintenance/lease every
WEED_MAINT_POLL seconds, executes the job through the matching shell
repair primitive or the deep-scrub pipeline, renews the lease while
working, and reports complete/fail.  All maintenance I/O the worker
performs locally runs under one BytePacer wired to the server's
request shedder, so foreground traffic automatically squeezes
background repairs down to the pacer floor.  An ec.rebuild job
rebuilds through K2 on the rebuilding server; a deep.scrub job
recomputes parity through the pooled step's K1 form on this server's
device.  A scale.up job spawns `python -m seaweedfs_tpu_torch volume`
on the spawning server's device, codec backend and heartbeat pulse.

The port's own copy of seaweedfs_tpu/maintenance/worker.py.
"""

from __future__ import annotations

import os
import threading
import time

from .. import qos
from ..rpc.http_rpc import RpcError, call
from ..stats import metrics
from ..util import glog
from .jobs import (TYPE_BALANCE, TYPE_DEEP_SCRUB, TYPE_EC_REBUILD,
                   TYPE_FIX_REPLICATION, TYPE_SCALE_DRAIN,
                   TYPE_SCALE_UP, TYPE_TIER_MOVE, TYPE_VACUUM)
from .pacer import BytePacer


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class MaintenanceWorker:
    def __init__(self, server):
        self.server = server  # the VolumeServer
        self.pacer = BytePacer(load_fn=self._foreground_load)
        self._stop = threading.Event()
        self._thread = None
        self.executed = 0
        self.failed = 0
        self.last_job = {}

    @property
    def worker_id(self) -> str:
        return self.server.address

    def enabled(self) -> bool:
        return os.environ.get("WEED_MAINT_WORKER", "1") != "0"

    def poll_seconds(self) -> float:
        return _env_float("WEED_MAINT_POLL", 5.0)

    def _foreground_load(self) -> float:
        """Occupancy of the QoS admission gate (in-flight + queued over
        the limit) — the same signal that queues/sheds foreground
        requests drives pacer backoff.  With QoS disabled, fall back to
        the legacy request-shedder fraction."""
        gate = getattr(self.server, "qos_gate", None)
        if gate is not None and qos.enabled():
            return gate.occupancy()
        shed = getattr(self.server, "request_shedder", None)
        if shed is None:
            return 0.0
        limit = shed._effective_limit()
        if not limit or limit <= 0:
            return 0.0
        return min(1.0, shed.current / float(limit))

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if not self.enabled() or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="maint-worker", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.poll_seconds()):
            try:
                self.poll_once()
            except Exception as e:
                glog.warning(f"maintenance worker poll failed: {e}")

    # -- one lease/execute/report round --------------------------------------
    def poll_once(self) -> int:
        """Lease and run up to one job; returns jobs executed."""
        try:
            resp = call(self.server.master_address, "/maintenance/lease",
                        {"worker": self.worker_id, "limit": 1,
                         "ec_volumes": self._held_ec_volumes()},
                        timeout=10)
        except (RpcError, OSError):
            return 0  # master unreachable / follower: retry next poll
        jobs = resp.get("jobs") or []
        lease_seconds = float(resp.get("lease_seconds", 60.0))
        for job in jobs:
            self._run(job, lease_seconds)
        return len(jobs)

    def _held_ec_volumes(self) -> list:
        out = []
        for loc in self.server.store.locations:
            out.extend(loc.ec_volumes)
        return sorted(set(out))

    def _run(self, job: dict, lease_seconds: float):
        stop_renew = threading.Event()

        def renew_loop():
            while not stop_renew.wait(max(1.0, lease_seconds / 3.0)):
                try:
                    call(self.server.master_address,
                         "/maintenance/renew",
                         {"id": job["id"], "worker": self.worker_id},
                         timeout=10)
                except (RpcError, OSError):
                    pass  # expiry requeues if the master stays away

        rt = threading.Thread(target=renew_loop, daemon=True,
                              name=f"maint-renew-{job['id']}")
        rt.start()
        t0 = time.perf_counter()
        self.last_job = {"id": job["id"], "type": job["type"],
                         "volume": job["volume"]}
        try:
            # curator jobs run (and fan out RPCs) as background-class
            # maintenance traffic: peers admit them behind foreground
            with qos.qos_scope(qos.BACKGROUND, tenant="maintenance"):
                report = self._execute(job)
            metrics.MaintJobSecondsHistogram.labels(job["type"]) \
                .observe(time.perf_counter() - t0)
            self.executed += 1
            self._report("/maintenance/complete",
                         {"id": job["id"], "worker": self.worker_id,
                          "outcome": "ok", "report": report})
        except Exception as e:
            self.failed += 1
            glog.warning(f"maintenance job {job['id']} "
                         f"({job['type']} v{job['volume']}) failed: {e}")
            self._report("/maintenance/fail",
                         {"id": job["id"], "worker": self.worker_id,
                          "error": f"{type(e).__name__}: {e}"})
        finally:
            stop_renew.set()
            rt.join(timeout=5)

    def _report(self, route: str, payload: dict):
        try:
            call(self.server.master_address, route, payload, timeout=10)
        except (RpcError, OSError):
            pass  # lease expiry recovers; don't crash the worker

    # -- executors -----------------------------------------------------------
    def _shell_env(self):
        from ..shell.commands import CommandEnv

        return CommandEnv(self.server.master_address)

    def _execute(self, job: dict) -> dict:
        fn = {TYPE_EC_REBUILD: self._exec_ec_rebuild,
              TYPE_FIX_REPLICATION: self._exec_fix_replication,
              TYPE_VACUUM: self._exec_vacuum,
              TYPE_DEEP_SCRUB: self._exec_deep_scrub,
              TYPE_BALANCE: self._exec_balance,
              TYPE_SCALE_UP: self._exec_scale_up,
              TYPE_SCALE_DRAIN: self._exec_scale_drain,
              TYPE_TIER_MOVE: self._exec_tier_move}.get(job["type"])
        if fn is None:
            raise ValueError(f"unknown job type {job['type']!r}")
        return fn(job)

    def _exec_ec_rebuild(self, job: dict) -> dict:
        """Repair corrupt AND missing shards: the scrub-with-repair
        pass deletes bad shards cluster-wide, rebuilds from clean
        survivors, and re-verifies against the stored CRCs."""
        from ..shell import commands as sh

        out = sh.ec_scrub(self._shell_env(), vid=job["volume"],
                          repair=True)
        # clean_shards/corrupt/missing are the PRE-repair state; a report
        # that was degraded converged iff the rebuild actually ran
        bad = [v for v in out
               if v.get("rebuild_error")
               or ((v.get("corrupt") or v.get("missing"))
                   and "rebuild" not in v)]
        if bad:
            raise RuntimeError(f"rebuild did not converge: {bad}")
        return {"volumes": len(out),
                "rebuilt": [v["volume"] for v in out if "rebuild" in v]}

    def _exec_fix_replication(self, job: dict) -> dict:
        from ..shell import commands_volume as vol

        actions = vol.volume_fix_replication(self._shell_env())
        return {"actions": actions}

    def _exec_vacuum(self, job: dict) -> dict:
        """The old master auto-vacuum pass, for one volume, from a
        worker: check garbage on every holder, then compact+commit —
        the synchronous holder RPCs now burn a worker thread, not the
        leader's reap loop."""
        vid = job["volume"]
        threshold = float(job.get("params", {})
                          .get("garbage_threshold", 0.0))
        looked = call(self.server.master_address,
                      f"/dir/lookup?volumeId={vid}", timeout=10)
        urls = sorted({loc["url"] for loc in looked.get("locations", [])})
        compacted = []
        for url in urls:
            check = call(url, "/admin/vacuum/check", {"volume": vid},
                         timeout=60)
            if check.get("garbage_ratio", 0.0) <= max(0.0, threshold):
                continue
            call(url, "/admin/vacuum/compact", {"volume": vid},
                 timeout=600)
            call(url, "/admin/vacuum/commit", {"volume": vid},
                 timeout=600)
            compacted.append(url)
        return {"volume": vid, "compacted": compacted}

    def _exec_deep_scrub(self, job: dict) -> dict:
        """Device-batched deep scrub of one locally-held EC volume
        (VolumeServer.scrub_target: local shards stream from disk, the
        others fetch from peers via /admin/ec/shard_read), everything
        paced."""
        from .deep_scrub import deep_scrub

        vid = job["volume"]
        collection = job.get("collection", "")
        ev = self.server.store.find_ec_volume(vid)
        if ev is None:
            raise RuntimeError(f"ec volume {vid} not held here")
        if getattr(ev, "writer", None):
            # inline EC volume: audit the live writer in place —
            # recompute every committed stripe's parity + CRC against
            # the commit log and re-read every live needle
            from ..storage.erasure_coding.inline import \
                audit_inline_volume

            report = audit_inline_volume(ev)
            report["pacer"] = self.pacer.snapshot()
            return report
        target = self.server.scrub_target(vid, collection)
        stage_stats: dict = {}
        out = deep_scrub([target], device=self.server.store.device,
                         throttle=self.pacer.throttle,
                         stage_stats=stage_stats)
        v = out["volumes"][0]
        report = {**v, "stage_stats": stage_stats,
                  "pacer": self.pacer.snapshot()}
        return report

    def _exec_balance(self, job: dict) -> dict:
        """Rebalance whichever populations the detector flagged
        (params["kinds"]): EC shards, plain volumes, or both."""
        from ..shell import commands as sh
        from ..shell import commands_volume as vol

        kinds = job.get("params", {}).get("kinds") or ["ec"]
        report: dict = {}
        if "ec" in kinds:
            report["ec_moves"] = sh.ec_balance(self._shell_env())
        if "volume" in kinds:
            report["volume_moves"] = vol.volume_balance(self._shell_env())
        return report

    # -- elasticity executors ------------------------------------------------
    def _exec_scale_up(self, job: dict) -> dict:
        """Grow the cluster by one volume server.  In-process when the
        host installed a spawn seam (tests); otherwise start a
        `python -m seaweedfs_tpu_torch volume` subprocess like this
        server (`_volume_command`), and wait until the master's topology
        shows the newcomer."""
        spawn = getattr(self.server, "spawn_volume_server", None)
        if callable(spawn):
            url = spawn(job)
            return {"spawned": url, "mode": "in-process"}
        import subprocess
        import sys
        import tempfile

        base = os.environ.get("WEED_SCALE_DIR") or tempfile.gettempdir()
        workdir = tempfile.mkdtemp(prefix="weed-scale-", dir=base)
        before = self._cluster_node_count()
        proc = subprocess.Popen(
            self._volume_command(workdir), env=self._child_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self.server.scale_children.append(proc)
        deadline = time.monotonic() + _env_float(
            "WEED_SCALE_SPAWN_TIMEOUT", 90.0)
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"spawned volume server exited rc={proc.returncode}")
            if self._cluster_node_count() > before:
                return {"spawned": workdir, "mode": "subprocess",
                        "nodes": before + 1}
            time.sleep(0.5)
        proc.terminate()
        raise RuntimeError("spawned volume server never registered")

    def _volume_command(self, workdir: str) -> list:
        """The port's CLI for a volume server like this one: the same
        master, heartbeat pulse, device (`-device cpu` from a CPU server,
        else the card) and `-ecBackend`.  The pulse matters: a master
        reaps a node silent for three of its own pulses, so a newcomer on
        the CLI's default 5 s pulse under a faster master would be reaped
        between heartbeats, and the volumes it was given with it (the
        JAX worker spawns it so: ROADMAP §3, R6)."""
        import sys

        cmd = [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
               "-dir", workdir, "-mserver", self.server.master_address,
               "-port", "0", "-pulseSeconds", str(self.server.pulse_seconds)]
        store = self.server.store
        if store.device is not None:
            import torch

            cmd += ["-device", torch.device(store.device).type]
        if store.ec_encoder_backend:
            cmd += ["-ecBackend", store.ec_encoder_backend]
        return cmd

    @staticmethod
    def _child_env() -> dict:
        """This environment, with the port's package importable from
        any working directory."""
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.environ.get("PYTHONPATH", "")
        return dict(os.environ,
                    PYTHONPATH=root + (os.pathsep + path if path else ""))

    def _cluster_node_count(self) -> int:
        try:
            status = call(self.server.master_address, "/dir/status",
                          timeout=10)
        except (RpcError, OSError):
            return -1
        return sum(len(r.get("nodes", []))
                   for dc in status.get("datacenters", [])
                   for r in dc.get("racks", []))

    def _exec_scale_drain(self, job: dict) -> dict:
        """Graceful drain: read-only demotion, curator-paced volume and
        EC-shard evacuation, then deregistration — all as background
        QoS traffic, so interactive reads stay inside their isolation
        bounds while the node empties."""
        from ..shell import commands as sh
        from ..shell import commands_volume as vol

        server = job.get("params", {}).get("server")
        if not server:
            raise ValueError("scale.drain needs params.server")
        env = self._shell_env()
        call(server, "/admin/drain", {"draining": True}, timeout=30)
        moves = vol.volume_server_evacuate(env, server)
        shard_moves = sh.ec_evacuate(env, server)
        call(server, "/admin/leave", {}, timeout=30)
        return {"server": server, "volume_moves": moves,
                "ec_shard_moves": shard_moves}

    def _exec_tier_move(self, job: dict) -> dict:
        """Advisory for now: the temperature detector flagged this
        volume as cold.  Surface the hint (journal + job report) so an
        operator — or the future cold-tier mover (ROADMAP item 3) —
        can act on it with storage/tier.py's tier_upload; the hint
        itself performs no data movement."""
        params = dict(job.get("params", {}))
        return {"volume": job["volume"], "advisory": True,
                "action": "none", "hint": params}
