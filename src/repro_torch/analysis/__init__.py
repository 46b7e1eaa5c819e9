"""``repro_torch.analysis``: determinism & PyTorch-hygiene static analysis
(glint) for the port. Port of ``repro/analysis/``.

A stdlib-``ast`` rule engine that machine-checks the conventions the
port's correctness claims rest on: keyed randomness and explicit
``torch.Generator``s (no global RNG state), stable iteration orders,
kernel wrappers that run a plain twin on the CPU and never fall back on
the card, no host syncs in the wrappers, bucketed shapes, and the
project's registry/shim discipline. Gates the port's own files via::

    python -m repro_torch.analysis

and is a library like the other subsystems::

    from repro_torch.analysis import run_checks
    report = run_checks(["src/repro_torch"])
    assert report.ok, report.findings

Importing it loads neither ``torch`` nor ``jax`` nor any ``repro`` module:
it runs where only the standard library and numpy are installed.
Per-line suppression: ``# glint: disable=DET001 -- justification`` (the
justification is mandatory; E002 flags pragmas without one). Add a rule
by subclassing :class:`Rule` and decorating with ``@register_rule``. The
runtime companion :func:`recompile_guard` asserts the tuner's
one-sweep-per-(op, bucket, dtype) bound over any block of inference calls.
"""
from repro_torch.analysis.core import (
    PARSE_ERROR_ID,
    PRAGMA_REASON_ID,
    RULES,
    SKIP_MARKER,
    FileContext,
    Finding,
    Report,
    Rule,
    active_rules,
    check_file,
    check_source,
    iter_python_files,
    register_rule,
    run_checks,
)
from repro_torch.analysis.reporters import render_json, render_rule_catalog, render_text
from repro_torch.analysis.runtime import RecompileError, RecompileReport, recompile_guard
import repro_torch.analysis.rules  # noqa: F401  (registers every rule in RULES)

__all__ = [
    "RULES",
    "Rule",
    "Finding",
    "FileContext",
    "Report",
    "SKIP_MARKER",
    "PARSE_ERROR_ID",
    "PRAGMA_REASON_ID",
    "register_rule",
    "active_rules",
    "check_source",
    "check_file",
    "iter_python_files",
    "run_checks",
    "render_text",
    "render_json",
    "render_rule_catalog",
    "RecompileError",
    "RecompileReport",
    "recompile_guard",
]
