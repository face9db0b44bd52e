"""Prometheus text exposition -> {(family sample, labels): value}."""

from __future__ import annotations

import re

_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        labels = tuple(sorted(_LABEL.findall(m.group(3) or "")))
        try:
            out[(m.group(1), labels)] = float(m.group(4))
        except ValueError:
            continue
    return out


def value(expo: dict, name: str, **labels) -> float:
    """The sample `name` whose labels include `labels` (0 when absent)."""
    want = set(labels.items())
    return sum(v for (n, ls), v in expo.items()
               if n == name and want <= set(ls))


def delta(ctx: dict, name: str, **labels) -> float:
    return value(ctx["after"]["expo"], name, **labels) - \
        value(ctx["before"]["expo"], name, **labels)
