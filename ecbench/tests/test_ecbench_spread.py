"""The spread deployment's cell on the CPU: a whole run at a small size
comes out correct, a planted fault under the timed path does not, and its
reference check refuses a layout that collapses onto one server."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecbench import spec
from ecbench.deploy import ec_cluster
from ecbench.reference import spread_scrub

CELL = "volume_warm_ec_spread7.deep_scrub"


@pytest.mark.parametrize("fault,correct", [(None, True), ("flip_k5", False)])
def test_run_on_the_cpu(fault, correct, tmp_path):
    args = [sys.executable, "-m", "ecbench.tests.cpu_rehearsal", CELL,
            "2718281828", "3", fault or "", str(tmp_path)]
    p = subprocess.run(args, cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is correct, result["checks"]
    assert result["checks"]["layout_wrong"]["value"] == 0
    if correct:
        assert result["failed"] == 0 and result["attempted"] > 0
        for m in ("scrub_peer_fetch_share", "peer_shard_read_ms",
                  "scrub_read_share"):
            assert result["metrics"][m]["value"] > 0, m
    else:
        assert result["checks"]["scrub_crcs_wrong"]["value"] > 0
    assert _processes_under(str(tmp_path)) == []


def _processes_under(path: str) -> list:
    """Pids of the live processes whose command line names `path`."""
    out = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if path.encode() in f.read():
                    out.append(int(pid))
        except (OSError, ValueError):
            continue
    return out


def _encoded_volume(directory: str, vid: int) -> None:
    """A volume's 14 shard files and .vif in `directory`, through the
    port's encoder on the CPU."""
    from seaweedfs_tpu_torch.storage.erasure_coding.encoder import (
        save_volume_info, write_ec_files)

    base = os.path.join(directory, str(vid))
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(5).bytes((1 << 20) + 4321))
    crcs = write_ec_files(base, batched=True, device="cpu")
    save_volume_info(base, version=3, extra={"shard_crc32c": crcs})
    os.remove(base + ".dat")


@pytest.mark.parametrize("spread", [True, False])
def test_verify_scrubs_counts_a_collapsed_layout(spread, tmp_path):
    cfg = spec.config("volume_warm_ec_spread7")
    dep = ec_cluster.Deployment(cfg, {}, 1, "cpu", str(tmp_path))
    for d in dep.dirs:
        os.makedirs(d)
    _encoded_volume(dep.dirs[0], dep.vid)
    if spread:
        for sid in range(spread_scrub.TOTAL_SHARDS):
            to = dep.dirs[sid % cfg["servers"]]
            if to != dep.dirs[0]:
                name = spread_scrub.shard_name(dep.vid, sid)
                shutil.move(os.path.join(dep.dirs[0], name),
                            os.path.join(to, name))
    checks = dep.verify_scrubs([], torch.device("cpu"))
    assert checks["layout_wrong"][0] == (0 if spread else cfg["servers"])
    assert all(v == 0 for k, (v, _) in checks.items() if k != "layout_wrong")
