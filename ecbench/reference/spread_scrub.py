"""Plain reference for a deep scrub of one EC volume spread over servers.

Given the servers' directories, it finds each of the volume's 14 shard
files wherever it lies, checks the layout (each shard held exactly once,
the same number on every server), and works out from the files alone what
a deep scrub of the whole volume has to report: each shard file's CRC32C,
the CRC32C of each parity shard recomputed from the ten data shards, and
the verdict (clean exactly when every file's CRC is the one the encode
recorded in the .vif and every recomputed parity CRC is the stored parity
CRC).  It also counts the small-block rows whose stored parity is not the
recomputed one.

Written from the definitions alone, on bytes, with plain PyTorch on the
given device (gf256, crc32c): it imports nothing of the system under test.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import crc32c as ref_crc
from . import gf256 as ref_gf

DATA_SHARDS, PARITY_SHARDS = 10, 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
ROW_BYTES = 1 << 20  # the small block: one stripe row of every shard


def shard_name(vid: int, sid: int) -> str:
    return "%d.ec%02d" % (vid, sid)


def collect(dirs: list, vid: int) -> dict:
    """{shard id: [index of each directory holding its file]}."""
    held: dict = {}
    for i, d in enumerate(dirs):
        for sid in range(TOTAL_SHARDS):
            if os.path.exists(os.path.join(d, shard_name(vid, sid))):
                held.setdefault(sid, []).append(i)
    return held


def layout_wrong(held: dict, n_servers: int, per_server: int) -> int:
    """Shards not held exactly once, plus servers that do not hold
    exactly `per_server` shards: 0 for the layout `ec.encode` makes over
    `n_servers` servers of one rack."""
    counts = [0] * n_servers
    for where in held.values():
        for i in where:
            counts[i] += 1
    return (sum(1 for sid in range(TOTAL_SHARDS)
                if len(held.get(sid, [])) != 1)
            + sum(1 for c in counts if c != per_server))


def stored_crcs(dirs: list, vid: int) -> list:
    """The 14 shard CRC32Cs the encode recorded, from the first .vif of
    the volume found in `dirs`."""
    for d in dirs:
        path = os.path.join(d, "%d.vif" % vid)
        if os.path.exists(path):
            with open(path) as f:
                return [int(c) for c in json.load(f)["shard_crc32c"]]
    raise FileNotFoundError(f"no {vid}.vif in {dirs}")


def scrub(dirs: list, vid: int, dev) -> dict:
    """What a deep scrub of volume `vid`, spread over `dirs`, must
    report: {"held", "stored", "chains" (14 file CRCs, None where no
    server holds the shard), "computed" (4 recomputed parity CRCs, None
    without all ten data shards), "parity_rows_wrong", "clean"}."""
    held = collect(dirs, vid)
    stored = stored_crcs(dirs, vid)
    shards = [np.fromfile(os.path.join(dirs[held[sid][0]],
                                       shard_name(vid, sid)), dtype=np.uint8)
              if sid in held else None for sid in range(TOTAL_SHARDS)]
    present = [s for s in shards if s is not None]
    crcs = iter(ref_crc.crc32c_many([torch.from_numpy(s) for s in present],
                                    device=dev))
    chains = [next(crcs) if s is not None else None for s in shards]
    computed, rows_wrong = None, 0
    if all(s is not None for s in shards[:DATA_SHARDS]):
        length = max(s.size for s in shards[:DATA_SHARDS])
        matrix = ref_gf.parity_matrix(DATA_SHARDS, PARITY_SHARDS)
        pieces = []
        for r0 in range(0, length, ROW_BYTES):
            width = min(ROW_BYTES, length - r0)
            data = torch.zeros((DATA_SHARDS, width), dtype=torch.uint8)
            for i, s in enumerate(shards[:DATA_SHARDS]):
                row = s[r0:r0 + width]
                data[i, :row.size] = torch.from_numpy(row)
            par = ref_gf.apply(matrix, data.to(dev))
            pieces.append(par)
            want = [s[r0:r0 + width] if s is not None else None
                    for s in shards[DATA_SHARDS:]]
            rows_wrong += int(any(
                w is None or not torch.equal(
                    par[j, :w.size], torch.from_numpy(w).to(dev))
                for j, w in enumerate(want)))
        parity = torch.cat(pieces, dim=1)
        lengths = [s.size if s is not None else length
                   for s in shards[DATA_SHARDS:]]
        computed = ref_crc.crc32c_many(
            [parity[j, :n] for j, n in enumerate(lengths)], device=dev)
    clean = (chains == stored and computed is not None
             and computed == stored[DATA_SHARDS:])
    return {"held": held, "stored": stored, "chains": chains,
            "computed": computed, "parity_rows_wrong": rows_wrong,
            "clean": clean}
