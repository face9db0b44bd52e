"""Whole runs on the CPU at a small size, with the look for a card
skipped: a sound run comes out correct, and each fault the cell can have,
planted under the timed path, comes out not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from ecbench import spec

CASES = [
    ("volume_warm_ec.degraded_get", None, True),
    ("volume_warm_ec.degraded_get", "flip_decode", False),
    ("volume_warm_ec.degraded_get", "flip_k1", False),
    ("volume_warm_ec.degraded_get", "stale_k1", False),
    ("volume_warm_ec.degraded_get", "half_k1", False),
    ("volume_warm_ec.degraded_get", "flip_read", False),
    ("volume_warm_ec.deep_scrub", None, True),
    ("volume_warm_ec.deep_scrub", "flip_k5", False),
    ("volume_warm_ec.deep_scrub", "stale_k5", False),
    ("volume_warm_ec.deep_scrub", "half_k5", False),
]


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_run_on_the_cpu(cell, fault, correct, tmp_path):
    args = [sys.executable, "-m", "ecbench.tests.cpu_rehearsal", cell,
            "918273645", "3", fault or "", str(tmp_path)]
    p = subprocess.run(args, cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is correct, result["checks"]
    assert list(result)[-1] == "checks"
    if correct:
        assert result["failed"] == 0 and result["attempted"] > 0
    else:
        assert any(c["value"] > c["limit"]
                   for c in result["checks"].values())


def test_run_py_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                        "--workload", "volume_warm_ec.degraded_get",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
