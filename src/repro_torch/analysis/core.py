"""The glint rule engine: stdlib-``ast`` static analysis for the port.
Port of ``repro/analysis/core.py``.

The analyzer exists because the system's correctness claims (bit-identical
results under any interleaving: keyed randomness and explicit generators;
one tuner sweep per (op, bucket, dtype): shape bucketing; no fallback from
a kernel to its plain version on the card) are *conventions*: nothing in
Python stops the next change from drawing from a global RNG, iterating a
``set`` into a result, or padding an input to a data-dependent length.
Each convention is encoded here as a ``Rule`` over a parsed AST, so the
properties are machine-checked instead of review-checked.

Rules live in a ``RULES`` :class:`~repro_torch.utils.Registry` keyed by
rule id (``DET001`` ...); each rule is a small object with ``check(ctx) ->
findings``, and a shared :class:`FileContext` owns the parse tree plus the
cross-rule helpers (import-alias resolution, parent links, suppression
pragmas). Per-line suppression is ``# glint: disable=DET001`` (or a bare
``# glint: disable`` for every rule) and every suppression must carry a
justification. The pragma grammar and the ids of the rules both linters
share are the reference's, so one pragma serves both; an id a linter does
not know is ignored by it.
"""
from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.utils import Registry

__all__ = [
    "RULES",
    "Rule",
    "Finding",
    "FileContext",
    "Report",
    "SKIP_MARKER",
    "PARSE_ERROR_ID",
    "PRAGMA_REASON_ID",
    "active_rules",
    "check_source",
    "check_file",
    "iter_python_files",
    "run_checks",
]

RULES: Registry = Registry("lint rule")

#: drop a file with this name into a directory to exclude the whole subtree
#: from directory scans (used by the known-bad self-test corpus; explicitly
#: named files are always checked)
SKIP_MARKER = ".glint-skip"

#: pseudo-rule id for files the engine cannot parse
PARSE_ERROR_ID = "E001"

#: pseudo-rule id for a ``glint: disable`` pragma with no justification text
PRAGMA_REASON_ID = "E002"

_SUPPRESS_ALL = "*"


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    name: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "name": self.name,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}[{self.name}] {self.message}"

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)


class Rule:
    """Base class: subclass, set the class attributes, implement ``check``.

    Register instances with ``@RULES.register("DETxxx")`` (the decorator
    form works on classes too: register the instance, not the class)."""

    id: str = "GLINT000"
    name: str = "base-rule"
    family: str = "engine"  # determinism | torch | kernels | project
    rationale: str = ""

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        return Finding(self.id, self.name, ctx.path, line, col, message)


def register_rule(cls):
    """Class decorator: instantiate and register under the rule's id."""
    RULES.register(cls.id, cls())
    return cls


# ---------------------------------------------------------------------------
# FileContext: one parsed file + the helpers every rule shares
# ---------------------------------------------------------------------------


class FileContext:
    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = str(path).replace("\\", "/")
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self._parents: dict | None = None
        self._imports: dict | None = None
        self._suppress: dict | None = None
        self._pragma_issues: list | None = None
        self._fn_assigns: dict | None = None

    # True for library code (rules about internal call discipline apply
    # only there; examples/benchmarks may exercise deprecated surfaces): a
    # path with a ``repro_torch`` part, or a ``repro`` part as the
    # reference's self-test corpus has
    @property
    def is_library(self) -> bool:
        return not {"repro", "repro_torch"}.isdisjoint(Path(self.path).parts)

    # -- structural helpers --------------------------------------------
    @property
    def parents(self) -> dict:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def parent(self, node) -> ast.AST | None:
        return self.parents.get(node)

    def ancestors(self, node) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_function(self, node) -> ast.AST | None:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def calls(self) -> Iterator[ast.Call]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                yield node

    # -- import-alias resolution ---------------------------------------
    @property
    def import_map(self) -> dict:
        """Local name -> canonical dotted prefix (``np`` -> ``numpy``,
        ``from numpy import random as nr`` -> ``nr: numpy.random``)."""
        if self._imports is None:
            m: dict[str, str] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname:
                            m[a.asname] = a.name
                        else:
                            root = a.name.split(".")[0]
                            m[root] = root
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    for a in node.names:
                        m[a.asname or a.name] = f"{node.module}.{a.name}"
            self._imports = m
        return self._imports

    def resolve(self, node) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, or None.

        ``np.random.rand`` -> ``numpy.random.rand`` given ``import numpy as
        np``.  Roots that were never imported resolve with their literal
        name (callers match on known module prefixes)."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.import_map.get(node.id, node.id))
        return ".".join(reversed(parts))

    # -- suppression pragmas -------------------------------------------
    @property
    def suppressions(self) -> dict:
        """line number -> set of suppressed rule ids (or ``{"*"}``).

        Pragma grammar: ``# glint: disable=DET001,JAX004 -- justification``
        (or a bare ``# glint: disable -- justification`` for every rule).
        A trailing pragma applies to its own line; a pragma on a standalone
        comment line applies to the next code line (so long statements can
        carry a multi-line justification above them).  The justification is
        any text after the id list; pragmas without one are recorded in
        :attr:`pragma_issues` and reported as ``E002``."""
        if self._suppress is None:
            sup: dict[int, set] = {}
            issues: list[tuple[int, int]] = []
            try:
                tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
                for tok in tokens:
                    if tok.type != tokenize.COMMENT:
                        continue
                    text = tok.string
                    marker = "glint:"
                    if marker not in text:
                        continue
                    directive = text.split(marker, 1)[1].strip()
                    if not directive.startswith("disable"):
                        continue
                    rest = directive[len("disable"):].strip()
                    if rest.startswith("="):
                        ids_part, _, reason = rest[1:].lstrip().partition(" ")
                        ids = {
                            r.strip().upper()
                            for r in ids_part.split(",")
                            if r.strip()
                        }
                    else:
                        ids, reason = {_SUPPRESS_ALL}, rest
                    if not reason.strip().strip("-—:(").strip():
                        issues.append((tok.start[0], tok.start[1]))
                    sup.setdefault(self._pragma_target(tok.start[0]), set()).update(ids)
            except tokenize.TokenError:
                pass
            self._suppress = sup
            self._pragma_issues = issues
        return self._suppress

    @property
    def pragma_issues(self) -> list:
        """(line, col) of each disable pragma lacking a justification."""
        self.suppressions  # populate
        return self._pragma_issues

    def _pragma_target(self, line: int) -> int:
        """Line a pragma at ``line`` suppresses: itself for a trailing
        pragma, else the next non-blank non-comment line."""
        text = self.lines[line - 1] if line - 1 < len(self.lines) else ""
        if not text.strip().startswith("#"):
            return line
        for nxt in range(line + 1, len(self.lines) + 1):
            stripped = self.lines[nxt - 1].strip()
            if stripped and not stripped.startswith("#"):
                return nxt
        return line

    def suppressed(self, finding: Finding) -> bool:
        ids = self.suppressions.get(finding.line)
        return bool(ids) and (_SUPPRESS_ALL in ids or finding.rule.upper() in ids)

    # -- simple local dataflow -----------------------------------------
    def name_assignment(self, node, name: str):
        """The RHS of the last simple ``name = <expr>`` assignment in the
        function (or module) enclosing ``node`` — one-level resolution for
        shape/bucket provenance checks."""
        if self._fn_assigns is None:
            self._fn_assigns = {}
        scope = self.enclosing_function(node) or self.tree
        if scope not in self._fn_assigns:
            amap: dict[str, ast.AST] = {}
            for n in ast.walk(scope):
                if isinstance(n, ast.Assign):
                    for tgt in n.targets:
                        if isinstance(tgt, ast.Name):
                            amap[tgt.id] = n.value
                elif isinstance(n, ast.AnnAssign) and n.value is not None:
                    if isinstance(n.target, ast.Name):
                        amap[n.target.id] = n.value
            self._fn_assigns[scope] = amap
        return self._fn_assigns[scope].get(name)


# ---------------------------------------------------------------------------
# Report + engine entry points
# ---------------------------------------------------------------------------


@dataclass
class Report:
    findings: list = field(default_factory=list)  # unsuppressed, gating
    suppressed: list = field(default_factory=list)
    files_checked: int = 0
    rule_ids: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "files_checked": self.files_checked,
            "rules": list(self.rule_ids),
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
        }


def active_rules(select=None, ignore=None) -> list:
    """Registered rule instances, filtered by id/name, ordered by id."""
    sel = {s.strip().upper() for s in select} if select else None
    ign = {s.strip().upper() for s in ignore} if ignore else set()

    def wanted(rule) -> bool:
        keys = {rule.id.upper(), rule.name.upper(), rule.family.upper()}
        if keys & ign:
            return False
        return sel is None or bool(keys & sel)

    rules = [RULES.get(rid) for rid in RULES]
    return sorted((r for r in rules if wanted(r)), key=lambda r: r.id)


def check_source(
    source: str, path: str = "<string>", rules=None
) -> tuple[list, list]:
    """Run ``rules`` over one source string -> (findings, suppressed)."""
    rules = active_rules() if rules is None else rules
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        f = Finding(
            PARSE_ERROR_ID,
            "parse-error",
            str(path).replace("\\", "/"),
            exc.lineno or 0,
            exc.offset or 0,
            f"file does not parse: {exc.msg}",
        )
        return [f], []
    ctx = FileContext(path, source, tree)
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            (suppressed if ctx.suppressed(f) else findings).append(f)
    # pragma hygiene is engine-level and cannot be pragma-suppressed
    for line, col in ctx.pragma_issues:
        findings.append(
            Finding(
                PRAGMA_REASON_ID,
                "pragma-without-reason",
                ctx.path,
                line,
                col,
                "glint: disable pragma has no justification; append one "
                "after the rule ids (e.g. `disable=DET001 -- why`)",
            )
        )
    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)
    return findings, suppressed


def check_file(path, rules=None) -> tuple[list, list]:
    source = Path(path).read_text(encoding="utf-8")
    return check_source(source, path=str(path), rules=rules)


def iter_python_files(paths) -> list:
    """Expand files/directories into a sorted, de-duplicated .py file list.

    Directory scans prune ``__pycache__`` and any subtree holding a
    ``SKIP_MARKER`` file; explicitly named files are always included."""
    seen: set = set()
    out: list[Path] = []
    skip_cache: dict[Path, bool] = {}

    def _skipped(d: Path) -> bool:
        if d not in skip_cache:
            skip_cache[d] = d.name == "__pycache__" or (d / SKIP_MARKER).exists()
        return skip_cache[d]

    def _add(f: Path) -> None:
        key = f.resolve()
        if key not in seen:
            seen.add(key)
            out.append(f)

    for p in paths:
        p = Path(p)
        if p.is_file():
            if p.suffix == ".py":
                _add(p)
        elif p.is_dir():
            if _skipped(p):
                continue
            for f in sorted(p.rglob("*.py")):
                rel = f.relative_to(p)
                dirs = [p / Path(*rel.parts[: i + 1]) for i in range(len(rel.parts) - 1)]
                if any(_skipped(d) for d in dirs):
                    continue
                _add(f)
    return out


def run_checks(paths, *, select=None, ignore=None) -> Report:
    """Analyze ``paths`` (files and/or directories) with the active rules.

    The library entry point behind ``python -m repro_torch.analysis``;
    returns a :class:`Report` whose ``ok`` is the gate condition."""
    rules = active_rules(select=select, ignore=ignore)
    report = Report(rule_ids=[r.id for r in rules])
    for f in iter_python_files(paths):
        found, sup = check_file(f, rules=rules)
        report.findings.extend(found)
        report.suppressed.extend(sup)
        report.files_checked += 1
    report.findings.sort(key=Finding.sort_key)
    report.suppressed.sort(key=Finding.sort_key)
    return report
