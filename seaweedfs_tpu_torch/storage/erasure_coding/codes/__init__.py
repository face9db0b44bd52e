"""Code-family registry.

Families (all 14 shards on the wire, so shard spread and `.ecNN` naming
are family-agnostic):

    rs_vandermonde  RS(10,4), today's format and the default.
    cauchy          Cauchy MDS(10,4): same geometry, closed-form decode
                    planning instead of Gauss-Jordan.
    pm_msr          Product-matrix MSR(14,5): 2 bytes read per rebuilt byte
                    on single-shard repair (vs 10 for RS) at 2.8x storage,
                    the cold/archival point.

Policy for a new volume's collection (first match wins):

    WEED_EC_CODE_<COLLECTION>   per-collection override (non-alnum -> "_",
                                upper-cased; empty collection -> DEFAULT)
    path_conf.ec_code           the filer path rule's choice, when given
    WEED_EC_CODE                cluster-wide default override
    rs_vandermonde              built-in default

Volumes carry their family in `.vif` metadata (`code_family`); a volume
without one is RS.
"""

from __future__ import annotations

import os
import re
import threading

from ....stats import metrics as _stats
from .base import CodeFamily, RepairPlan  # noqa: F401 (re-export)
from .cauchy import CauchyMDS
from .pm_msr import ProductMatrixMSR
from .rs_vandermonde import RSVandermonde

DEFAULT_FAMILY = "rs_vandermonde"
_FAMILIES = {cls.name: cls()
             for cls in (RSVandermonde, CauchyMDS, ProductMatrixMSR)}


def family_names() -> list:
    return list(_FAMILIES)


def get_family(name: str = None) -> CodeFamily:
    """Resolve a family by name; None/"" means the default (RS)."""
    if not name:
        name = DEFAULT_FAMILY
    try:
        return _FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown EC code family {name!r} (known: {family_names()})")


def describe_families() -> dict:
    return {name: fam.describe() for name, fam in _FAMILIES.items()}


def _collection_env_key(collection: str) -> str:
    slug = re.sub(r"[^A-Za-z0-9]", "_", collection or "DEFAULT").upper()
    return f"WEED_EC_CODE_{slug}"


def family_for_collection(collection: str, path_conf=None) -> str:
    """The code family name for a new EC volume in `collection` (module
    docstring); validated, so a typo raises before any shard is cut."""
    name = os.environ.get(_collection_env_key(collection))
    if not name:
        name = getattr(path_conf, "ec_code", "") or None
    if not name:
        name = os.environ.get("WEED_EC_CODE")
    get_family(name)
    return name or DEFAULT_FAMILY


# -- rebuild read-amplification accounting ----------------------------------

_amp_lock = threading.Lock()
_amp_totals: dict = {}  # family -> [read_bytes, rebuilt_bytes]


def note_rebuild(family: str, read_bytes: int, rebuilt_bytes: int) -> None:
    """Record one rebuild's traffic: survivor bytes consumed and bytes
    rebuilt (their ratio is the repair-bandwidth figure of merit), and
    mirror it into the maintenance_ec_rebuild_* families."""
    with _amp_lock:
        tot = _amp_totals.setdefault(family, [0, 0])
        tot[0] += int(read_bytes)
        tot[1] += int(rebuilt_bytes)
        amp = tot[0] / tot[1] if tot[1] else 0.0
    _stats.MaintEcRebuildReadBytes.labels(family).inc(int(read_bytes))
    _stats.MaintEcRebuildRebuiltBytes.labels(family).inc(int(rebuilt_bytes))
    _stats.MaintEcRebuildReadAmpGauge.labels(family).set(amp)


def rebuild_read_amp_snapshot() -> dict:
    """{family: {read_bytes, rebuilt_bytes, read_amp}} since process start."""
    with _amp_lock:
        return {
            fam: {"read_bytes": r, "rebuilt_bytes": w,
                  "read_amp": round(r / w, 4) if w else None}
            for fam, (r, w) in _amp_totals.items()
        }
