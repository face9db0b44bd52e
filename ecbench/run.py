"""The benchmark of seaweedfs_tpu_torch: one run of one cell on one card.

    python3 ecbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Builds the cell's deployment from the seed (set-up, timed as setup_s),
measures for S seconds, checks every reply or call against the plain
reference, and prints one JSON line last on stdout: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, breakdown (traced runs), and the numbers that
decided `correct`, each beside its limit.  Those numbers are also the last
lines on stderr.  With no CUDA card it exits 2 and prints no result.

`--fault NAME` plants a fault under the timed path (faults.py): the
control and its tests use it.  `--sweep R1,R2,...` runs the knee sweep
of an open-loop cell (one window per offered rate) and prints its rows.
Measured runs use neither.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# a library of the port must not load JAX behind its back
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--sweep", default=None,
                    help="comma-separated offered rates: the knee sweep")
    a = ap.parse_args(argv)

    import torch

    from ecbench import harness, spec

    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"ecbench: {a.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if a.sweep:
        try:
            rows = harness.sweep(a.workload, a.seed, a.seconds,
                                 [float(r) for r in a.sweep.split(",")])
        finally:
            shutil.rmtree(harness.WORK, ignore_errors=True)
        print(json.dumps({"sweep": rows}), flush=True)
        return 0
    try:
        result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                             device="cuda", fault=a.fault, t_start=T_START)
    finally:
        shutil.rmtree(harness.WORK, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"ecbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
