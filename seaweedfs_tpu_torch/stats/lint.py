"""Dashboard / SLO-rule lint: every observability artefact must
reference metric families the registry actually exports.

``python -m seaweedfs_tpu_torch lint-dashboards`` (and the perf_smoke test that wraps it)
runs two checks:

* every ``SeaweedFS_*`` token in every Grafana panel query resolves to
  a registered family (histogram ``_bucket``/``_sum``/``_count``
  components resolve to their base family);
* every active SLO rule (stats/slo.py) references a registered family,
  and a latency rule's family is really a histogram — a typo in
  ``WEED_SLO_RULES`` would otherwise silently evaluate to "no traffic,
  no burn" forever.

Returns problem strings instead of raising, so the CLI can print them
all and exit non-zero once.

The port's own copy of seaweedfs_tpu/stats/lint.py.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

from . import metrics as _stats
from . import slo as slo_mod


def default_dashboard_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "grafana", "grafana_seaweedfs_tpu.json")


# Rows the shipped dashboard must keep, with family tokens each row's
# panels must query — deleting a row (or renaming a family out from
# under it) fails the lint, not just a human eyeball pass.  Applied
# only to the repo's own dashboard; ad-hoc dashboards passed by path
# are checked for dangling references only.
PINNED_ROWS = {
    "Workload analytics": (
        "SeaweedFS_access_records_total",
        "SeaweedFS_access_tracked_keys",
        "SeaweedFS_access_sketch_bytes",
        "SeaweedFS_usage_reads",
        "SeaweedFS_usage_bytes",
        "SeaweedFS_usage_distinct_keys",
        "SeaweedFS_usage_hot_share",
    ),
}


def lint_dashboard(path: Optional[str] = None) -> List[str]:
    pin = path is None or \
        os.path.abspath(path) == default_dashboard_path()
    path = path or default_dashboard_path()
    problems: List[str] = []
    try:
        with open(path) as f:
            dashboard = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable dashboard: {e}"]
    panels = dashboard.get("panels", [])
    exprs = [(p.get("title", "?"), t.get("expr", ""))
             for p in panels for t in p.get("targets", [])]
    if not exprs:
        return [f"{path}: dashboard has no queries"]
    registered = set(_stats.REGISTRY._metrics)
    for title, expr in exprs:
        for token in re.findall(r"SeaweedFS_\w+", expr):
            base = re.sub(r"_(bucket|sum|count)$", "", token)
            if base not in registered and token not in registered:
                problems.append(
                    f"panel {title!r} references unknown metric {token}")
    if pin:
        titles = {p.get("title") for p in panels
                  if p.get("type") == "row"}
        joined = "\n".join(e for _, e in exprs)
        for row, families in PINNED_ROWS.items():
            if row not in titles:
                problems.append(f"pinned row {row!r} missing")
            for fam in families:
                if fam not in joined:
                    problems.append(
                        f"no panel queries pinned family {fam}")
    return problems


def lint_slo_rules(rules=None) -> List[str]:
    problems: List[str] = []
    rules = rules if rules is not None else slo_mod.active_rules()
    if not rules:
        return ["no SLO rules active (WEED_SLO_RULES parsed to nothing)"]
    registered = _stats.REGISTRY._metrics
    for rule in rules:
        fam = rule.family
        if rule.kind == "availability":
            # the liveness pseudo-family is fed by the scrape loop and
            # also registered as a real gauge on the leader
            if fam not in registered:
                problems.append(
                    f"rule {rule.name!r}: unknown family {fam}")
            continue
        metric = registered.get(fam)
        if metric is None:
            problems.append(f"rule {rule.name!r}: unknown family {fam}")
        elif getattr(metric, "kind", "") != "histogram":
            problems.append(
                f"rule {rule.name!r}: latency rule needs a histogram, "
                f"{fam} is a {getattr(metric, 'kind', '?')}")
    return problems


def run(path: Optional[str] = None) -> List[str]:
    """Full lint pass; empty list means clean."""
    return lint_dashboard(path) + lint_slo_rules()
