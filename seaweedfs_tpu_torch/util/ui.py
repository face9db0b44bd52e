"""Minimal server status pages (weed/server/{master,volume_server,
filer}_ui): one self-contained HTML page per daemon showing identity,
counters, and topology tables — no external assets.

Counterpart of seaweedfs_tpu/util/ui.py.
"""

from __future__ import annotations

import html
import time
from typing import Iterable

_PAGE = """<!DOCTYPE html>
<html><head><title>{title}</title><style>
body {{ font-family: -apple-system, 'Segoe UI', sans-serif; margin: 2em;
       color: #1a2b33; }}
h1 {{ font-size: 1.4em; }} h2 {{ font-size: 1.1em; margin-top: 1.5em; }}
table {{ border-collapse: collapse; min-width: 30em; }}
th, td {{ border: 1px solid #cdd7db; padding: .35em .7em;
          text-align: left; font-size: .92em; }}
th {{ background: #eef3f5; }}
.footer {{ margin-top: 2em; color: #7a8a92; font-size: .8em; }}
</style></head><body>
<h1>{title}</h1>
{body}
<div class="footer">seaweedfs_tpu &middot; rendered {now}</div>
</body></html>"""


def _esc(v) -> str:
    return html.escape(str(v))


def table(headers: Iterable[str], rows: Iterable[Iterable]) -> str:
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def kv_table(pairs: dict) -> str:
    return table(("property", "value"), pairs.items())


def section(title: str, content: str) -> str:
    return f"<h2>{_esc(title)}</h2>\n{content}"


def page(title: str, *sections: str) -> bytes:
    return _PAGE.format(
        title=_esc(title), body="\n".join(sections),
        now=time.strftime("%Y-%m-%d %H:%M:%S")).encode()
