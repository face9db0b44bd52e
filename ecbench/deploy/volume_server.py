"""One SeaweedFS volume server holding a sealed, ec.encoded warm volume.

Set-up, in the harness's own process: the configuration's needles are
written through the port's `Store` into one volume, the volume is sealed
(read-only) and encoded by `Store.ec_generate` on the card (`-ec.backend
cuda`), and the plain volume is deleted, as the shell's `ec.encode` leaves
a node.  The cell's lost shards are then moved out of the volume's
directory (the server never sees them; the reference still reads them),
and a master and a `VolumeServer` are started over the directory, as
`weed master` and `weed volume` would start them.  The maintenance loops
are off (WEED_MAINT=0, WEED_MAINT_WORKER=0): the cell measures the outage
before a repair, and a curator would rebuild the lost shards under it.
"""

from __future__ import annotations

import gc
import os
import shutil

import numpy as np
import torch

from .. import expo
from ..payload import NeedleSet
from ..reference import crc32c as ref_crc
from ..reference import gf256 as ref_gf
from ..schedule import seed_rng

DATA_SHARDS, PARITY_SHARDS = 10, 4
SMALL_BLOCK = 1 << 20


def snapshot() -> dict:
    """The counters the per-layer metrics and the window's diagnosis
    read, taken at the window's open and close."""
    from seaweedfs_tpu_torch.ops.device_pool import get_pool
    from seaweedfs_tpu_torch.stats import metrics

    pool = get_pool().snapshot()
    # only the family the readers use: a whole exposition at the
    # window's open would hold the interpreter lock long enough to stall
    # the servers' threads at the start of the window
    return {"expo": expo.parse(
        "\n".join(metrics.VolumeServerRequestHistogram.expose())),
            "pool": {k: pool[k] for k in ("allocs", "lease_hits",
                                          "evictions")},
            "gc": [g["collections"] for g in gc.get_stats()]}


def sites() -> dict:
    """Where a traced run wraps the program: kernel entries (shapes)
    and layer entries (host spans), innermost span first."""
    from seaweedfs_tpu_torch.maintenance import deep_scrub as ds
    from seaweedfs_tpu_torch.ops import codec, rs_torch
    from seaweedfs_tpu_torch.parallel import mesh
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import \
        EcVolume

    spans = [(rs_torch, "gf_apply", "k1.launch"),
             (mesh, "gf_apply", "k5.launch"),
             (codec, "reconstruct_span", "ec.decode"),
             (EcVolume, "_fetch_survivors", "ec.fetch_survivors"),
             (ds, "_read_span", "scrub.read_span")]
    if hasattr(ds, "_fill_span"):
        # a span read straight into the stage is the same layer's read
        spans.append((ds, "_fill_span", "scrub.read_span"))
    spans += [(EcVolume, "_recover_span", "ec.recover_span"),
              (EcVolume, "read_needle", "ec.read_needle")]
    return {"kernels": [(mesh, "gf_apply", "k5")], "spans": spans}


class Deployment:
    def __init__(self, cfg: dict, params: dict, seed: int, device: str,
                 workdir: str):
        self.cfg, self.params, self.seed = cfg, params, seed
        self.device = device
        self.workdir = workdir
        self.voldir = os.path.join(workdir, "vol")
        self.lostdir = os.path.join(workdir, "lost")
        self.vid = 1
        self.lost = list(params.get("lost_shards", []))
        self.master = self.server = None

    # -- set-up -------------------------------------------------------------
    def build(self):
        os.environ["WEED_MAINT"] = "0"
        os.environ["WEED_MAINT_WORKER"] = "0"
        from seaweedfs_tpu_torch.master.server import MasterServer
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.storage.store import Store
        from seaweedfs_tpu_torch.volume_server.server import VolumeServer

        os.makedirs(self.voldir)
        os.makedirs(self.lostdir)
        c = self.cfg
        self.needles = ns = NeedleSet(c["volume_bytes"], c["needle_min_bytes"],
                                      c["needle_max_bytes"], self.seed)
        port_dev = None if self.device == "cuda" else self.device
        store = Store([self.voldir], ec_encoder_backend=c["ec_backend"],
                      device=port_dev)
        try:
            store.add_volume(self.vid, replication=c["replication"])
            for i in range(len(ns)):
                n = Needle.create(ns.data(i), name=b"obj-%06x.jpg" % i,
                                  mime=b"image/jpeg")
                n.id, n.cookie = int(ns.ids[i]), int(ns.cookies[i])
                store.write_needle(self.vid, n)
            store.mark_volume_readonly(self.vid)
            store.ec_generate(self.vid)
            store.delete_volume(self.vid)
        finally:
            store.close()
        for sid in self.lost:
            name = "%d.ec%02d" % (self.vid, sid)
            os.rename(os.path.join(self.voldir, name),
                      os.path.join(self.lostdir, name))
        self.master = MasterServer(port=0,
                                   volume_size_limit_mb=c["volume_size_limit_mb"])
        self.master.start()
        self.server = VolumeServer([self.voldir], self.master.address,
                                   port=0, ec_encoder_backend=c["ec_backend"],
                                   device=port_dev)
        self.server.start()
        self.server.heartbeat_once()
        self.endpoint = self.server.address

    def stop(self):
        for s in (self.server, self.master):
            if s is not None:
                s.stop()
        self.server = self.master = None

    # -- traffic --------------------------------------------------------------
    def n_keys(self) -> int:
        return len(self.needles)

    def key_of_rank(self, rank: int) -> int:
        return int(self.needles.by_rank[rank])

    def path(self, i: int) -> str:
        ns = self.needles
        return "/%d,%x%08x" % (self.vid, int(ns.ids[i]), int(ns.cookies[i]))

    def expected_digest(self, i: int) -> str:
        return self.needles.digest(i)

    def scrub_once(self) -> dict:
        """One call of the entry the maintenance worker's deep.scrub job
        calls, over this node's volume; returns what the reference
        judges."""
        from seaweedfs_tpu_torch.maintenance import deep_scrub as ds

        target = ds.local_target(os.path.join(self.voldir, str(self.vid)),
                                 volume=self.vid)
        stats: dict = {}
        port_dev = None if self.device == "cuda" else self.device
        got = ds.deep_scrub([target], device=port_dev, stage_stats=stats)
        return {"bytes": got["scrubbed_bytes"], "stats": stats,
                "ok": got["volumes"][0]["ok"],
                "chains": list(target.chains),
                "computed": list(target.computed)}

    # -- what the metrics read ----------------------------------------------
    snapshot = staticmethod(snapshot)
    sites = staticmethod(sites)

    # -- the reference ---------------------------------------------------------
    def _shard_path(self, sid: int) -> str:
        name = "%d.ec%02d" % (self.vid, sid)
        d = self.lostdir if sid in self.lost else self.voldir
        return os.path.join(d, name)

    def shard_files(self) -> list:
        """The paths of the volume's 14 shard files, lost ones included."""
        return [self._shard_path(s)
                for s in range(DATA_SHARDS + PARITY_SHARDS)]

    def _stored_crcs(self) -> list:
        import json

        with open(os.path.join(self.voldir, "%d.vif" % self.vid)) as f:
            return [int(c) for c in json.load(f)["shard_crc32c"]]

    def verify_encode(self, rows: list, dev, parity_crcs: bool = False) -> dict:
        return check_encode([self._shard_path(s) for s in range(
            DATA_SHARDS + PARITY_SHARDS)], self._stored_crcs(), rows, dev,
            parity_crcs)

    def verify_gets(self, replies: list, dev, sample_rows: int) -> dict:
        """Every reply against the seed's bytes, every replied needle's
        ETag against the reference CRC32C of those bytes, and the encode
        of a seeded sample of stripe rows."""
        wrong = [r for r in replies
                 if r[4] != 200 or r[6] != self.expected_digest(r[0])]
        etag = {r[0]: r[7] for r in replies if r[4] == 200}
        keys = sorted(etag)
        crcs = ref_crc.crc32c_many(
            [torch.from_numpy(np.frombuffer(self.needles.data(k),
                                            dtype=np.uint8).copy())
             for k in keys],
            device=dev)
        etag_wrong = sum(int(etag[k] != "%08x" % c)
                         for k, c in zip(keys, crcs))
        rows = self.n_rows()
        pick = sorted(seed_rng(self.seed + 1).choice(
            rows, min(sample_rows, rows), replace=False).tolist())
        enc = self.verify_encode(pick, dev)
        return {"wrong_replies": (len(wrong), 0),
                "etag_vs_reference_crc": (etag_wrong, 0),
                "parity_rows_wrong": (enc["parity_rows_wrong"], 0),
                "shard_crc_wrong": (enc["shard_crc_wrong"], 0)}

    def verify_scrubs(self, calls: list, dev) -> dict:
        """Every call's verdict, file CRC chains and recomputed parity CRCs
        against the reference's recomputation of the whole volume."""
        enc = self.verify_encode(list(range(self.n_rows())), dev,
                                 parity_crcs=True)
        clean = (enc["crcs"] == self._stored_crcs()
                 and enc["computed"] == enc["crcs"][DATA_SHARDS:])
        for c in calls:
            c["wrong_verdict"] = c["ok"] != clean
            c["wrong_crcs"] = (c["chains"] != enc["crcs"]
                               or c["computed"] != enc["computed"])
            c["wrong"] = c["wrong_verdict"] or c["wrong_crcs"]
        bad_verdict = sum(int(c["wrong_verdict"]) for c in calls)
        bad_crc = sum(int(c["wrong_crcs"]) for c in calls)
        return {"scrub_verdicts_wrong": (bad_verdict, 0),
                "scrub_crcs_wrong": (bad_crc, 0),
                "parity_rows_wrong": (enc["parity_rows_wrong"], 0),
                "shard_crc_wrong": (enc["shard_crc_wrong"], 0)}

    def n_rows(self) -> int:
        size = os.path.getsize(self._shard_path(DATA_SHARDS))
        return -(-size // SMALL_BLOCK)

    def cleanup(self):
        shutil.rmtree(self.workdir, ignore_errors=True)


def check_encode(paths: list, stored: list, rows: list, dev,
             parity_crcs: bool = False) -> dict:
    """Parity of the given small-block rows, worked out again from the
    data shards, against the parity shards; every shard file's CRC32C
    against the CRC the encode recorded in the .vif.  With
    `parity_crcs` (all rows), also the CRC32C of each recomputed
    parity shard."""
    shards = [np.fromfile(p, dtype=np.uint8) for p in paths]
    matrix = ref_gf.parity_matrix(DATA_SHARDS, PARITY_SHARDS)
    wrong_rows, pieces = 0, []
    for r in rows:
        cut = slice(r * SMALL_BLOCK, (r + 1) * SMALL_BLOCK)
        data = torch.from_numpy(np.stack(
            [s[cut] for s in shards[:DATA_SHARDS]])).to(dev)
        par = ref_gf.apply(matrix, data)
        if parity_crcs:
            pieces.append(par)
        want = torch.from_numpy(np.stack(
            [s[cut] for s in shards[DATA_SHARDS:]])).to(dev)
        wrong_rows += int(not torch.equal(par, want))
    crcs = ref_crc.crc32c_many(
        [torch.from_numpy(s) for s in shards], device=dev)
    out = {"parity_rows_wrong": wrong_rows, "crcs": crcs,
           "shard_crc_wrong": sum(int(a != b) for a, b in
                                  zip(crcs, stored))}
    if parity_crcs:
        parity = torch.cat(pieces, dim=1)
        out["computed"] = ref_crc.crc32c_many(list(parity), device=dev)
    return out
