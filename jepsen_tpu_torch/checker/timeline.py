"""HTML per-process op timeline.

The port of the reference's ``jepsen_tpu/checker/timeline.py``
(jepsen.checker.timeline, jepsen/src/jepsen/checker/timeline.clj): pairs
invocations with completions (timeline.clj:33-53), renders one column per
process with a coloured div per op (:97-121), and writes ``timeline.html``
into the test's store directory (:159-179).
"""

from __future__ import annotations

import html as _html
from typing import Optional

from . import Checker, checker_fn
from .. import store
from ..history import History

_COLORS = {
    "ok": "#6DB6FE",
    "info": "#FFAA26",
    "fail": "#FEB5DA",
}

_STYLE = """
body { font-family: sans-serif; }
.ops { position: relative; }
.op { position: absolute; padding: 2px; border-radius: 2px;
      overflow: hidden; font-size: 10px; border: 1px solid #888; }
.op:hover { overflow: visible; z-index: 10; min-width: 12em; }
"""

PROCESS_WIDTH = 130  # px per process column
HEIGHT_PER_NS = 0.0000006  # vertical scale (timeline.clj:25-31)
MIN_HEIGHT = 16


def render(history: History, test: Optional[dict] = None) -> str:
    """Render the history as standalone HTML (timeline.clj:123-157)."""
    pairs = history.pairs()
    procs = sorted(
        {iv.process for iv in pairs},
        key=lambda p: (isinstance(p, str), p),
    )
    col_of = {p: i for i, p in enumerate(procs)}
    t0 = min((iv.inv_time for iv in pairs), default=0)
    t_max = max(
        (iv.ret_time for iv in pairs if iv.ret_time != float("inf")),
        default=t0,
    )
    divs = []
    for iv in pairs:
        left = col_of[iv.process] * PROCESS_WIDTH
        top = (iv.inv_time - t0) * HEIGHT_PER_NS
        end = iv.ret_time if iv.ret_time != float("inf") else t_max
        height = max((end - iv.inv_time) * HEIGHT_PER_NS, MIN_HEIGHT)
        color = _COLORS.get(iv.type, "#eee")
        title = (
            f"{iv.process} {iv.f} {iv.value_in!r} -> {iv.type} "
            f"{iv.value_out!r}"
        )
        divs.append(
            f'<div class="op" style="left:{left}px;top:{top + 40:.1f}px;'
            f"width:{PROCESS_WIDTH - 12}px;height:{height:.1f}px;"
            f'background:{color}" title="{_html.escape(title)}">'
            f"{_html.escape(str(iv.process))} {_html.escape(str(iv.f))} "
            f"{_html.escape(repr(iv.value_out if iv.type == 'ok' else iv.value_in))}"
            "</div>"
        )
    heads = "".join(
        f'<div style="position:absolute;left:{col_of[p] * PROCESS_WIDTH}px;'
        f'top:0;font-weight:bold">{_html.escape(str(p))}</div>'
        for p in procs
    )
    name = (test or {}).get("name", "test")
    return (
        f"<html><head><title>{_html.escape(str(name))} timeline</title>"
        f"<style>{_STYLE}</style></head><body>"
        f'<h1>{_html.escape(str(name))}</h1><div class="ops">{heads}'
        + "".join(divs)
        + "</div></body></html>"
    )


def html() -> Checker:
    """Checker writing timeline.html into the store (timeline.clj:159-179)."""

    def chk(test, history, opts):
        content = render(history, test)
        if store.wanted(test):
            sub = (opts or {}).get("subdirectory")
            parts = ([str(sub), "timeline.html"] if sub else
                     ["timeline.html"])
            path = store.path_mk(test, *parts)
            path.write_text(content)
            return {"valid": True, "file": str(path)}
        return {"valid": True}

    return checker_fn(chk, "timeline")
