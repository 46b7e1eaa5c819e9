"""Shares of the program's own spans (``repro_torch.tracing``), for the
per-layer readers that read them.

Each root span the program closed in this process (or absorbed from its
forked batch producer) carries the self time of every span name in its
subtree. A reader's share is the self time of some of those names over
the root's duration, and the metric is the median of that share over the
kept roots, which leaves out the cold first pass or batch. A program
without the tracer reads nothing (None).
"""
from __future__ import annotations

import statistics

__all__ = ["median_share", "share"]


def share(root, names) -> float:
    """The self time of the spans named in ``names`` (a whole name, or a
    prefix ending in ``.``) over ``root``'s duration, in %."""
    total = sum(ns for name, ns in root.self_ns.items()
                if any(name == n or (n.endswith(".") and name.startswith(n)) for n in names))
    return 100.0 * total / root.dur_ns


def median_share(root_name: str, names):
    """The median over the program's ``root_name`` roots of ``share``; None
    when the program has no tracer or closed no such root."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    shares = [share(r, names) for r in tracing.roots(root_name) if r.dur_ns > 0]
    return statistics.median(shares) if shares else None
