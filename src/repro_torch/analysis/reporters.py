"""Render a :class:`~repro_torch.analysis.core.Report` as text or JSON.
Port of ``repro/analysis/reporters.py``.

The JSON document (``--format json --out glint_report.json``) is the
machine-readable report; the text form is the human gate output.
"""
from __future__ import annotations

import json

from repro_torch.analysis.core import Report, active_rules

__all__ = ["render_text", "render_json", "render_rule_catalog"]


def render_text(report: Report, *, show_suppressed: bool = False) -> str:
    lines = [f.render() for f in report.findings]
    if show_suppressed and report.suppressed:
        lines.append("-- suppressed (pragma'd, non-gating) --")
        lines.extend(f.render() + "  [suppressed]" for f in report.suppressed)
    counts = report.counts()
    by_rule = (
        " (" + ", ".join(f"{r}: {n}" for r, n in counts.items()) + ")"
        if counts
        else ""
    )
    lines.append(
        f"glint: {len(report.findings)} finding(s){by_rule}, "
        f"{len(report.suppressed)} suppressed, "
        f"{report.files_checked} file(s), "
        f"{len(report.rule_ids)} rule(s)"
    )
    return "\n".join(lines)


def render_json(report: Report) -> str:
    return json.dumps(report.to_dict(), indent=2, sort_keys=False)


def render_rule_catalog() -> str:
    """The ``--list-rules`` output: every registered rule with family and
    rationale, grouped deterministically by id."""
    out = []
    for rule in active_rules():
        out.append(f"{rule.id}  {rule.name}  [{rule.family}]")
        for line in rule.rationale.split(". "):
            line = line.strip().rstrip(".")
            if line:
                out.append(f"    {line}.")
    return "\n".join(out)
