"""SQL-ish SELECT over JSON-lines needle content.

Parity with weed/query/json/query_json.go: each line of a stored object
is one JSON record; a query has a dotted field path, an operator, and a
value; passing records are projected down to the selected fields.  Type
semantics mirror filterJson(): string/number/bool comparisons are
type-directed by the *record's* value, `%`/`!%` are glob matches on
strings, an empty operator tests mere existence, and a missing field
never matches.  The reference leaves CSV input unimplemented
(volume_grpc_query.go:38 empty branch); here CSV-with-header is
supported as well since the request schema advertises it.

Counterpart of seaweedfs_tpu/query/json_query.py.
"""

from __future__ import annotations

import csv
import io
import json
from dataclasses import dataclass
from typing import Any, Iterable


@dataclass
class Query:
    field: str = ""
    op: str = ""
    value: str = ""


_MISSING = object()


def get_path(obj: Any, path: str) -> Any:
    """Resolve a gjson-style dotted path (list elements by integer
    index); None when the path is absent."""
    found, value = _lookup(obj, path)
    return value if found else None


def _lookup(obj: Any, path: str) -> tuple[bool, Any]:
    cur = obj
    if not path:
        return False, None
    for part in path.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                return False, None
            cur = cur[part]
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return False, None
        else:
            return False, None
    return True, cur


def _glob_match(s: str, pattern: str) -> bool:
    """tidwall/match semantics: `*` any run, `?` one char (no [] classes)."""
    # iterative two-pointer with backtracking
    si = pi = 0
    star = -1
    mark = 0
    while si < len(s):
        if pi < len(pattern) and pattern[pi] in ("?", s[si]):
            si += 1
            pi += 1
        elif pi < len(pattern) and pattern[pi] == "*":
            star, mark = pi, si
            pi += 1
        elif star != -1:
            pi = star + 1
            mark += 1
            si = mark
        else:
            return False
    while pi < len(pattern) and pattern[pi] == "*":
        pi += 1
    return pi == len(pattern)


def filter_record(record: Any, query: Query) -> bool:
    """Type-directed comparison per query_json.go filterJson()."""
    found, value = _lookup(record, query.field)
    if not found:
        return False
    if query.op == "":
        return True  # existence test
    op, rpv = query.op, query.value
    if isinstance(value, str):
        table = {
            "=": value == rpv, "!=": value != rpv,
            "<": value < rpv, "<=": value <= rpv,
            ">": value > rpv, ">=": value >= rpv,
            "%": _glob_match(value, rpv),
            "!%": not _glob_match(value, rpv),
        }
        return table.get(op, False)
    if isinstance(value, bool):  # before number: bool is an int subclass
        if value:
            return {"=": rpv == "true", "!=": rpv != "true",
                    ">": rpv == "false", ">=": True}.get(op, False)
        return {"=": rpv == "false", "!=": rpv != "false",
                "<": rpv == "true", "<=": True}.get(op, False)
    if isinstance(value, (int, float)):
        try:
            rpvn = float(rpv)
        except ValueError:
            rpvn = 0.0
        num = float(value)
        return {"=": num == rpvn, "!=": num != rpvn,
                "<": num < rpvn, "<=": num <= rpvn,
                ">": num > rpvn, ">=": num >= rpvn}.get(op, False)
    return False


def _project(record: Any, selections: list[str]) -> Any:
    if not selections:
        return record
    out = {}
    for sel in selections:
        found, value = _lookup(record, sel)
        if found:
            # last path segment names the output column (gjson behavior
            # of ToJson naming by selection)
            out[sel] = value
    return out


def query_json_lines(data: bytes, selections: list[str],
                     query: Query) -> list[dict]:
    """Run the filter+projection over JSON-lines content; skips
    unparseable lines like gjson.ForEachLine does."""
    results = []
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except ValueError:
            continue
        if filter_record(record, query):
            results.append(_project(record, selections))
    return results


def query_csv(data: bytes, selections: list[str], query: Query,
              file_header_info: str = "USE") -> list[dict]:
    """CSV input: rows become dicts keyed by header (USE) or _1.._n
    (NONE/IGNORE), then share the JSON filter/projection path."""
    text = data.decode(errors="replace")
    rows: Iterable[list[str]] = csv.reader(io.StringIO(text))
    rows = list(rows)
    if not rows:
        return []
    if file_header_info.upper() == "USE":
        header, body = rows[0], rows[1:]
    else:
        width = max(len(r) for r in rows)
        header = [f"_{i + 1}" for i in range(width)]
        body = rows if file_header_info.upper() == "NONE" else rows[1:]
    results = []
    for row in body:
        record: dict[str, Any] = {}
        for key, cell in zip(header, row):
            try:
                record[key] = json.loads(cell)  # numbers/bools pass through
            except ValueError:
                record[key] = cell
        if filter_record(record, query):
            results.append(_project(record, selections))
    return results
