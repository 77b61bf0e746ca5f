"""Failure-witness rendering for linearizability refutations.

The port of the reference's ``jepsen_tpu/checker/linear_viz.py``. The
reference renders the search's final configurations to ``linear.svg``
when a history is not linearizable (checker.clj:202-209, via
knossos.linear.report). This module renders the ``stuck_configs`` that
every engine's refutation carries (the native C search's witness, the
device search's final frontier, the host oracle's) into:

- ``linear.txt``: a plain-text report: the deepest configurations, the
  model state, and why each pending op cannot extend the linearization;
- ``linear.svg``: a per-process timeline around the stuck point: the
  linearized ops, the pending ops that could not linearize (coloured by
  reason), and the open (``:info``) ops.

The ``linearizable`` checker writes both into the test's store directory.
"""

from __future__ import annotations

from typing import Optional

from ..ops.encode import OPEN, encode_history

# Palette (matches the tutorial's timeline colors).
_C_LIN = "#78a878"       # linearized
_C_REJECT = "#c24f4f"    # pending, model rejects
_C_BLOCKED = "#d99a3d"   # pending, real-time blocked
_C_EXPLORED = "#7d7dc2"  # pending, all continuations explored
_C_OPEN = "#9a9a9a"      # open (:info), not linearized
_C_OTHER = "#d8d8d8"     # other unlinearized ops


def _pending_color(why: str) -> str:
    if why.startswith("real-time-blocked"):
        return _C_BLOCKED
    if why.startswith("model rejects"):
        return _C_REJECT
    return _C_EXPLORED


def failure_report(model, history_ops, res: dict) -> str:
    """Plain-text refutation explanation from a checker result map."""
    lines = [
        "Linearizability refuted.",
        f"  op count:        {res.get('op_count')}",
        f"  max linearized:  {res.get('max_linearized')}",
        f"  engine:          "
        f"{res.get('backend') or ('device' if res.get('device') else 'native' if res.get('native') else 'host')}",
        "",
    ]
    stuck = res.get("stuck_configs") or []
    if not stuck:
        lines.append("(no witness captured)")
        return "\n".join(lines)
    lines.append(f"Deepest configurations reached ({len(stuck)} shown):")
    for i, cfg in enumerate(stuck):
        lines.append(f"\nconfig {i}: state={cfg.get('state')} "
                     f"({len(cfg.get('linearized') or [])} ops linearized)")
        for p in cfg.get("pending") or []:
            if isinstance(p, dict):
                lines.append(f"  cannot linearize {p.get('op')}")
                lines.append(f"    because: {p.get('why')}")
            else:  # host-oracle entries are plain strings
                lines.append(f"  pending: {p}")
    return "\n".join(lines)


def render_linear_svg(model, history_ops, res: dict,
                      path: Optional[str] = None,
                      context_ops: int = 14) -> str:
    """Render the first stuck configuration as a per-process timeline
    SVG around the stuck point; returns the SVG text (and writes it to
    ``path`` when given)."""
    stuck = (res.get("stuck_configs") or [{}])[0]
    enc = encode_history(model, history_ops)
    n = enc.n
    lin = set(stuck.get("linearized") or [])
    pending = {p["row"]: p["why"] for p in (stuck.get("pending") or [])
               if isinstance(p, dict)}

    # Focus window: rows around the earliest pending op.
    anchor = min(pending) if pending else max(lin) if lin else 0
    lo = max(0, anchor - context_ops)
    hi = min(n, anchor + context_ops + 1)
    rows = [i for i in range(lo, hi)]
    procs = []
    for i in rows:
        pr = enc.intervals[i].process
        if pr not in procs:
            procs.append(pr)

    x0, y0, lane_h, px = 160, 40, 26, 9.0
    t_lo = int(enc.inv[rows[0]])
    t_hi = max(int(enc.ret[i]) if enc.ret[i] != OPEN else int(enc.inv[i]) + 4
               for i in rows)
    width = x0 + int((t_hi - t_lo + 2) * px) + 40
    height = y0 + lane_h * len(procs) + 70

    def esc(s):
        return (str(s).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    svg = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        f'<text x="8" y="18" font-size="13">not linearizable — state '
        f'{esc(stuck.get("state"))}, {len(lin)} ops linearized '
        f'(showing ops {lo}..{hi - 1})</text>',
    ]
    for li, pr in enumerate(procs):
        y = y0 + li * lane_h
        svg.append(f'<text x="8" y="{y + 14}">proc {esc(pr)}</text>')
        svg.append(f'<line x1="{x0}" y1="{y + lane_h - 4}" '
                   f'x2="{width - 20}" y2="{y + lane_h - 4}" '
                   f'stroke="#eee"/>')
    for i in rows:
        iv = enc.intervals[i]
        li = procs.index(iv.process)
        y = y0 + li * lane_h
        xa = x0 + (int(enc.inv[i]) - t_lo) * px
        is_open = enc.ret[i] == OPEN
        xb = (width - 30 if is_open
              else x0 + (int(enc.ret[i]) - t_lo) * px)
        if i in lin:
            color = _C_LIN
        elif i in pending:
            color = _pending_color(pending[i])
        elif is_open:
            color = _C_OPEN
        else:
            color = _C_OTHER
        label = model.describe_op(int(enc.opcode[i]), int(enc.a1[i]),
                                  int(enc.a2[i]), enc.table)
        svg.append(
            f'<rect x="{xa:.0f}" y="{y}" width="{max(xb - xa, 6):.0f}" '
            f'height="{lane_h - 8}" rx="3" fill="{color}" '
            f'fill-opacity="0.75"><title>{esc(label)}'
            f'{" — " + esc(pending[i]) if i in pending else ""}'
            f'</title></rect>')
        svg.append(f'<text x="{xa + 2:.0f}" y="{y + 13}" '
                   f'font-size="9">{esc(label)[:18]}</text>')
    ly = y0 + lane_h * len(procs) + 18
    legend = [(_C_LIN, "linearized"), (_C_REJECT, "model rejects"),
              (_C_BLOCKED, "real-time blocked"),
              (_C_EXPLORED, "explored"), (_C_OPEN, "open (:info)")]
    lx = x0
    for color, name in legend:
        svg.append(f'<rect x="{lx}" y="{ly}" width="12" height="12" '
                   f'rx="2" fill="{color}"/>')
        svg.append(f'<text x="{lx + 16}" y="{ly + 10}">{name}</text>')
        lx += 24 + 8 * len(name)
    svg.append("</svg>")
    text = "\n".join(svg)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
