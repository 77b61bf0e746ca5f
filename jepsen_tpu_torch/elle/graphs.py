"""Shared op->edge builders of the Elle dependency-graph checkers.

The port of the reference's ``jepsen_tpu/elle/graphs.py``. Both txn
interpretations (:mod:`.append`, :mod:`.wr`) derive their
:class:`~jepsen_tpu_torch.elle.DepGraph` edges through these three
helpers:

- ww along a *recovered version chain* (list-append's longest-read
  prefix order): adjacent versions, then last-observed → each
  unordered tail writer (:func:`add_version_chain`);
- ww along *forced write pairs* (rw-register's per-process /
  realtime / writes-follow-reads chains), returning the successor map
  rw inference walks (:func:`add_write_chains`);
- wr writer→reader plus rw reader→next-version writer for one read
  observation (:func:`add_read_edges`).

All node arguments are DepGraph node ids; ``None`` marks an unknown
author and contributes no edge — sound, never inventing a cycle.
"""

from __future__ import annotations

from typing import Iterable, Optional

from . import RW, WR, WW, DepGraph


def add_version_chain(g: DepGraph, nodes: list,
                      tail_nodes: Iterable = ()) -> None:
    """ww edges along one key's recovered version order.

    ``nodes``: the version order's writer nodes, oldest first (None
    entries are skipped edge-wise). ``tail_nodes``: writers of versions
    known to lie strictly AFTER the whole chain but mutually unordered
    (list-append's never-observed appends) — each gets a ww edge from
    the last observed writer only."""
    for a, b in zip(nodes, nodes[1:]):
        if a is not None and b is not None and a != b:
            g.add(a, b, WW)
    if nodes:
        a = nodes[-1]
        if a is not None:
            for u in tail_nodes:
                if u is not None and u != a:
                    g.add(a, u, WW)


def add_read_edges(g: DepGraph, reader: int, writer: Optional[int],
                   next_writers: Iterable = ()) -> None:
    """Edges for one read observation: wr from the writer of the
    version it observed (``None`` for a read of the initial/empty
    state), rw to every writer of a version forced after what it
    observed."""
    if writer is not None and writer != reader:
        g.add(writer, reader, WR)
    for w in next_writers:
        if w is not None and w != reader:
            g.add(reader, w, RW)


def add_write_chains(g: DepGraph, chains: Iterable[tuple]) -> dict:
    """ww edges for forced write-order pairs ``(earlier, later)``;
    returns the ``{writer: set(successors)}`` map rw inference walks
    (reader of v → chain successors of v's writer)."""
    succ: dict = {}
    for i1, i2 in chains:
        if i1 != i2:
            g.add(i1, i2, WW)
            succ.setdefault(i1, set()).add(i2)
    return succ
