"""CLI: ``python -m repro_torch.analysis [paths...]``, the port's lint gate.
Port of ``repro/analysis/__main__.py``.

With no paths it checks the port's own files, relative to the working
directory (run it from the repository's root): ``src/repro_torch``,
``tests/test_torch_*.py``, ``chip_smoke.py`` and ``tools/``. Exit code 0
when no unsuppressed finding survives, 1 otherwise (2 for usage errors).
``--format json --out glint_report.json`` writes the machine-readable
report (always written, even when gating fails)."""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.core import run_checks
from repro_torch.analysis.reporters import render_json, render_rule_catalog, render_text


def default_paths(root=".") -> list:
    """The port's own files under ``root``: the package, its tests, the
    card's smoke script and the tools."""
    root = Path(root)
    return ([root / "src" / "repro_torch"] + sorted((root / "tests").glob("test_torch_*.py"))
            + [root / "chip_smoke.py", root / "tools"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="glint: determinism & PyTorch-hygiene static analysis for the port",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: the port's own files)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None, help="also write the report (in --format) to this file")
    ap.add_argument("--select", default=None, help="comma-separated rule ids/names/families to run")
    ap.add_argument("--ignore", default=None, help="comma-separated rule ids/names/families to skip")
    ap.add_argument("--show-suppressed", action="store_true", help="list pragma-suppressed findings too")
    ap.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(render_rule_catalog())
        return 0

    select = args.select.split(",") if args.select else None
    ignore = args.ignore.split(",") if args.ignore else None
    report = run_checks(args.paths or default_paths(), select=select, ignore=ignore)

    rendered = (
        render_json(report)
        if args.format == "json"
        else render_text(report, show_suppressed=args.show_suppressed)
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(rendered + "\n")
        # keep the gate's text summary visible even when the report file
        # carries the full JSON
        print(render_text(report, show_suppressed=args.show_suppressed))
    else:
        print(rendered)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
