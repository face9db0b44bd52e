"""Code-family registry.

Families (all 14 shards on the wire, so shard spread and `.ecNN` naming
are family-agnostic):

    rs_vandermonde  RS(10,4), today's format and the default.
    cauchy          Cauchy MDS(10,4)             } not ported yet: asking
    pm_msr          Product-matrix MSR(14,5)     } for them raises

Volumes carry their family in `.vif` metadata (`code_family`); a volume
without one is RS.
"""

from __future__ import annotations

from .base import CodeFamily  # noqa: F401 (re-export)
from .rs_vandermonde import RSVandermonde

DEFAULT_FAMILY = "rs_vandermonde"
_FAMILIES = {RSVandermonde.name: RSVandermonde()}
_LATER_FAMILIES = ("cauchy", "pm_msr")


def family_names() -> list:
    return list(_FAMILIES)


def get_family(name: str = None) -> CodeFamily:
    """Resolve a family by name; None/"" means the default (RS)."""
    if not name:
        name = DEFAULT_FAMILY
    if name in _LATER_FAMILIES:
        raise NotImplementedError(
            f"code family {name!r} is not ported; only {DEFAULT_FAMILY!r} is")
    try:
        return _FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown EC code family {name!r} (known: {family_names()})")
