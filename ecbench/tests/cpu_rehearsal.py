"""Drive one whole benchmark run on the CPU at a small size.

    python -m ecbench.tests.cpu_rehearsal CELL SEED SECONDS [FAULT [WORKROOT]]

The harness's look for a card is skipped (harness.run is called directly
with device="cpu"), the port's device routes are pointed at the host as
its own CPU tests point them (the batched encode's words route, K1's
plain version counted as a launch for the decode and the parity step),
and the configuration is cut to a few MiB.  Prints the result line.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SMALL = {"volume_bytes": 6 << 20, "needle_min_bytes": 1024,
         "needle_max_bytes": 256 << 10}
SMALL_CELL = {"rate_per_s": 60}


def prepare():
    os.environ["WEED_EC_RECOVER_DEVICE"] = "1"
    os.environ["WEED_EC_RECOVER_DEVICE_MIN_KB"] = "0"
    from seaweedfs_tpu_torch.parallel import batched_encode

    batched_encode.words_capable = lambda *_: True


def main(argv) -> int:
    cell, seed, seconds = argv[0], int(argv[1]), float(argv[2])
    fault = argv[3] if len(argv) > 3 and argv[3] else None
    workroot = argv[4] if len(argv) > 4 else None
    prepare()
    from ecbench import harness, spec

    params = dict(spec.cell(cell).get("params", {}))
    if "rate_per_s" in params:
        params.update(SMALL_CELL)
    result = harness.run(cell, seed, seconds, trace=True, device="cpu",
                         fault=fault, overrides=SMALL, params=params,
                         workroot=workroot or os.path.join(harness.WORK, "cpu"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
