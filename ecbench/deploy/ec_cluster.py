"""Seven SeaweedFS volume servers over one warm EC volume, spread as the
shell's `ec.encode` spreads it.

Set-up: a master and the source volume server run in the harness's own
process, the source on the card (`-ec.backend cuda`); the other servers
are `python -m seaweedfs_tpu_torch volume` processes, as `weed volume`
runs, each over a directory of its own and on the host alone (`-device
cpu`): they serve shard spans and dispatch nothing to the card.  While
they start, the configuration's needles are written through the port's
`Store` into one volume in the source's directory, as in the one-server
deployment.  The shell's `ec_encode` then has the source generate the
14 shards on the card, spreads them over the servers (one rack: 2 per
server whatever its shuffle picks), mounts them, removes from the source
those that left it and deletes the plain volume, as a user's `ec.encode`
does.  The maintenance loops are off (WEED_MAINT=0, WEED_MAINT_WORKER=0).

A call is the maintenance worker's deep scrub of the volume, run on the
source: `deep_scrub([server.scrub_target(vid)])` reads its 2 shards from
disk and the 12 others span by span from their holders over HTTP.

Every peer is a child the kernel kills when the harness process dies
(PR_SET_PDEATHSIG), and `stop()` ends them, so none outlives a run,
however the run ends.
"""

from __future__ import annotations

import ctypes
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time

from .. import expo
from ..payload import NeedleSet
from ..reference import spread_scrub
from . import volume_server as one_server

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the program's counters of the remote reader; the families a parent
# without them lacks are left out
PEER_FAMILIES = ("EcPeerReadBytesCounter", "EcPeerReadSecondsCounter",
                 "EcPeerReadErrorsCounter")
START_S = 120.0  # for peers to start, register and take their shards
PR_SET_PDEATHSIG = 1


def _die_with_parent():
    """preexec_fn of a peer: the kernel kills it when the harness dies."""
    libc = ctypes.CDLL(None, use_errno=True)
    parent = os.getpid()

    def arm():
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
        if os.getppid() != parent:  # the parent died before the prctl
            os._exit(1)
    return arm


def sites() -> dict:
    """The one-server deployment's sites, with the peer fetch (the
    remote reader's hedged call) as the innermost span."""
    from seaweedfs_tpu_torch.rpc import policy

    out = one_server.sites()
    return {"kernels": out["kernels"],
            "spans": [(policy, "hedged", "ec.peer_read")] + out["spans"]}


class Deployment:
    def __init__(self, cfg: dict, params: dict, seed: int, device: str,
                 workdir: str):
        self.cfg, self.seed = cfg, seed
        self.device = device
        self.workdir = workdir
        self.dirs = [os.path.join(workdir, "vs%d" % i)
                     for i in range(cfg["servers"])]
        self.vid = 1
        self.master = self.server = None
        self.peers: list = []
        self.peer_urls: list = []

    # -- set-up -------------------------------------------------------------
    def build(self):
        os.environ["WEED_MAINT"] = "0"
        os.environ["WEED_MAINT_WORKER"] = "0"
        from seaweedfs_tpu_torch.master.server import MasterServer
        from seaweedfs_tpu_torch.shell import commands as sh
        from seaweedfs_tpu_torch.volume_server.server import VolumeServer

        for d in self.dirs:
            os.makedirs(d)
        c = self.cfg
        self.master = MasterServer(
            port=0, volume_size_limit_mb=c["volume_size_limit_mb"])
        self.master.start()
        lines = self._spawn_peers()
        port_dev = None if self.device == "cuda" else self.device
        self._write_volume(port_dev)
        self.server = VolumeServer([self.dirs[0]], self.master.address,
                                   port=0, ec_encoder_backend=c["ec_backend"],
                                   device=port_dev)
        self.server.start()
        self.server.heartbeat_once()
        deadline = time.monotonic() + START_S
        self.peer_urls = [self._peer_address(i, q, deadline)
                          for i, q in enumerate(lines)]
        self._wait(deadline, "servers to register",
                   lambda: self._nodes() == len(self.dirs))
        sh.ec_encode(sh.CommandEnv(self.master.address), self.vid)
        self._wait(deadline, "every shard to be located once",
                   lambda: self._located() == [1] * spread_scrub.TOTAL_SHARDS)

    def _write_volume(self, port_dev):
        """The seed's needles, written through the port's Store into
        volume `vid` in the source's directory."""
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.storage.store import Store

        c = self.cfg
        ns = NeedleSet(c["volume_bytes"], c["needle_min_bytes"],
                       c["needle_max_bytes"], self.seed)
        store = Store([self.dirs[0]], ec_encoder_backend=c["ec_backend"],
                      device=port_dev)
        try:
            store.add_volume(self.vid, replication=c["replication"])
            for i in range(len(ns)):
                n = Needle.create(ns.data(i), name=b"obj-%06x.jpg" % i,
                                  mime=b"image/jpeg")
                n.id, n.cookie = int(ns.ids[i]), int(ns.cookies[i])
                store.write_needle(self.vid, n)
        finally:
            store.close()

    def _spawn_peers(self) -> list:
        """Start the peers; returns a queue of each one's stdout lines."""
        env = dict(os.environ)
        path = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = ROOT + (os.pathsep + path if path else "")
        c = self.cfg
        lines = []
        for i, d in enumerate(self.dirs[1:], start=1):
            cmd = [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
                   "-dir", d, "-mserver", self.master.address,
                   "-port", "0", "-device", c["peer_device"],
                   "-ecBackend", c["ec_backend"]]
            with open(os.path.join(self.workdir, "peer%d.log" % i),
                      "wb") as log:
                p = subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                                     stdout=subprocess.PIPE, stderr=log,
                                     cwd=self.workdir, env=env,
                                     preexec_fn=_die_with_parent())
            self.peers.append(p)
            q: queue.Queue = queue.Queue()
            threading.Thread(target=_drain, args=(p.stdout, q),
                             daemon=True).start()
            lines.append(q)
        return lines

    def _peer_address(self, i: int, lines: queue.Queue,
                      deadline: float) -> str:
        head = "volume server listening on "
        while True:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                raise RuntimeError("peer %d did not start: %s" % (
                    i + 1, self._peer_log(i + 1)))
            if line.startswith(head):
                return line[len(head):].split(",")[0].strip()

    def _peer_log(self, i: int) -> str:
        try:
            with open(os.path.join(self.workdir, "peer%d.log" % i),
                      "rb") as f:
                return f.read()[-2000:].decode(errors="replace")
        except OSError:
            return ""

    def _wait(self, deadline: float, what: str, done):
        while not done():
            if time.monotonic() > deadline:
                raise RuntimeError("timed out waiting for " + what)
            time.sleep(0.1)

    def _nodes(self) -> int:
        from seaweedfs_tpu_torch.rpc.http_rpc import call

        topo = call(self.master.address, "/dir/status", timeout=10)
        return sum(len(r.get("nodes", []))
                   for dc in topo.get("datacenters", [])
                   for r in dc.get("racks", []))

    def _located(self) -> list:
        from seaweedfs_tpu_torch.rpc.http_rpc import RpcError, call

        try:
            got = call(self.master.address,
                       "/ec/lookup?volumeId=%d" % self.vid, timeout=10)
        except RpcError:
            return []
        where = {e["shard_id"]: len(e["locations"])
                 for e in got.get("shard_id_locations", [])}
        return [where.get(s, 0) for s in range(spread_scrub.TOTAL_SHARDS)]

    def stop(self):
        for s in (self.server, self.master):
            if s is not None:
                s.stop()
        self.server = self.master = None
        for p in self.peers:
            if p.poll() is None:
                p.terminate()
        for p in self.peers:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.peers = []

    # -- traffic --------------------------------------------------------------
    def scrub_once(self) -> dict:
        """One call of the deep scrub the maintenance worker's deep.scrub
        job runs on the source server, over its target of the spread
        volume; returns what the reference judges."""
        from seaweedfs_tpu_torch.maintenance import deep_scrub as ds

        target = self.server.scrub_target(self.vid)
        stats: dict = {}
        port_dev = None if self.device == "cuda" else self.device
        got = ds.deep_scrub([target], device=port_dev, stage_stats=stats)
        return {"bytes": got["scrubbed_bytes"], "stats": stats,
                "ok": got["volumes"][0]["ok"],
                "chains": list(target.chains),
                "computed": list(target.computed)}

    # -- what the metrics read ----------------------------------------------
    def snapshot(self) -> dict:
        """The one-server counters, the remote reader's counters, and the
        peers' expositions summed (their request histograms)."""
        from seaweedfs_tpu_torch.rpc.http_rpc import call
        from seaweedfs_tpu_torch.stats import metrics

        out = one_server.snapshot()
        families = [getattr(metrics, n) for n in PEER_FAMILIES
                    if hasattr(metrics, n)]
        out["expo"].update(expo.parse("\n".join(
            line for f in families for line in f.expose())))
        peers: dict = {}
        for url in self.peer_urls:
            text = call(url, "/metrics", parse=False, timeout=10)
            for k, v in expo.parse(bytes(text).decode()).items():
                peers[k] = peers.get(k, 0.0) + v
        out["peer_expo"] = peers
        return out

    sites = staticmethod(sites)

    def shard_files(self) -> list:
        """The paths of the volume's 14 shard files, on whichever server
        holds each."""
        names = ["%d.ec%02d" % (self.vid, s)
                 for s in range(spread_scrub.TOTAL_SHARDS)]
        return [os.path.join(d, n) for d in self.dirs for n in names
                if os.path.exists(os.path.join(d, n))]

    # -- the reference ---------------------------------------------------------
    def verify_scrubs(self, calls: list, dev) -> dict:
        """The layout, and every call's verdict, file CRC chains and
        recomputed parity CRCs, against the plain reference's
        recomputation of the whole volume from the servers' files."""
        ref = spread_scrub.scrub(self.dirs, self.vid, dev)
        for c in calls:
            c["wrong_verdict"] = c["ok"] != ref["clean"]
            c["wrong_crcs"] = (c["chains"] != ref["chains"]
                               or c["computed"] != ref["computed"])
            c["wrong"] = c["wrong_verdict"] or c["wrong_crcs"]
        return {"scrub_verdicts_wrong": (
                    sum(int(c["wrong_verdict"]) for c in calls), 0),
                "scrub_crcs_wrong": (
                    sum(int(c["wrong_crcs"]) for c in calls), 0),
                "parity_rows_wrong": (ref["parity_rows_wrong"], 0),
                "shard_crc_wrong": (sum(
                    int(a != b) for a, b in zip(ref["chains"],
                                                ref["stored"])), 0),
                "layout_wrong": (spread_scrub.layout_wrong(
                    ref["held"], len(self.dirs),
                    self.cfg["shards_per_server"]), 0)}

    def cleanup(self):
        shutil.rmtree(self.workdir, ignore_errors=True)


def _drain(stream, q: queue.Queue):
    """A peer's stdout, line by line, then None at its end."""
    for raw in stream:
        q.put(raw.decode(errors="replace"))
    q.put(None)
