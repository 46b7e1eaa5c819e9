"""Kernel-hygiene rules (KRN0xx). Port of ``repro/analysis/rules/kernels.py``.

The hand-written CUDA kernels are the one place the port's numerics are not
PyTorch's, so each carries the obligations the rest of the suite depends
on. In the reference they are an ``interpret`` parameter plumbed into each
``pl.pallas_call`` and a ``*_ref`` oracle for each ``*_pallas`` wrapper. In
the port a wrapper's device picks the path: a CPU tensor runs the plain
version of ``repro_torch.kernels.ref`` (what CPU CI and the parity tests
hold the kernel to), a CUDA tensor launches the kernel or raises, never
falling back (``build.on_cpu``). KRN001 machine-checks both halves,
structurally, so no naming convention is needed (the port's twins are named
irregularly: ``flash_attention`` and ``attention_ref``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Rule, register_rule

__all__ = ["KernelWrapperHygiene", "in_kernel_wrappers"]

#: modules of ``repro_torch/kernels/`` that hold no wrapper: the plain
#: versions, the build and binding layer, and the tuner (which launches on
#: the card only, on purpose, and refuses a CPU device)
_NOT_WRAPPERS = ("ref.py", "build.py", "autotune.py")

_REF_MODULE = "repro_torch.kernels.ref"


def in_kernel_wrappers(ctx: FileContext) -> bool:
    """True for a module of ``repro_torch/kernels/`` that holds kernel
    wrappers (every one there but ``_NOT_WRAPPERS``)."""
    parts = ctx.path.split("/")
    return (
        len(parts) >= 3
        and parts[-3:-1] == ["repro_torch", "kernels"]
        and parts[-1] not in _NOT_WRAPPERS
    )


def _leaf(fn) -> str | None:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _is_ref_call(ctx: FileContext, call: ast.Call) -> bool:
    name = ctx.resolve(call.func) or ""
    return name.startswith(_REF_MODULE + ".")


def _calls(node) -> list:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


class _Module:
    """The module-level defs of one file and what each calls: functions by
    name, and classes (an autograd ``Function``'s ``apply``) by the class."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.defs = {
            n.name: n
            for n in ctx.tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
        }
        self._reaches: dict = {}

    def callees(self, node) -> list:
        out = []
        for call in _calls(node):
            fn = call.func
            if isinstance(fn, ast.Name) and fn.id in self.defs:
                out.append(self.defs[fn.id])
            elif (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and isinstance(self.defs.get(fn.value.id), ast.ClassDef)
            ):
                out.append(self.defs[fn.value.id])
        return out

    @staticmethod
    def launches(node) -> bool:
        """Calls a ``launch_*`` function itself."""
        return any((_leaf(c.func) or "").startswith("launch_") for c in _calls(node))

    def cpu_test(self, test) -> bool:
        """``test`` calls ``on_cpu``, or a local helper that returns it."""
        for call in _calls(test):
            if _leaf(call.func) == "on_cpu":
                return True
            d = self.defs.get(_leaf(call.func) or "")
            if (
                isinstance(d, ast.FunctionDef)
                and any(_leaf(c.func) == "on_cpu" for c in _calls(d))
                and not self.reaches(d, set())
            ):
                return True
        return False

    def cpu_branch(self, fn) -> bool:
        """``fn`` has an ``if`` on the tensors' device whose CPU side calls
        a plain version of ``repro_torch.kernels.ref``."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            test, side = node.test, node.body
            if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
                test, side = test.operand, node.orelse
            if self.cpu_test(test) and any(
                _is_ref_call(self.ctx, c) for s in side for c in _calls(s)
            ):
                return True
        return False

    def guarded(self, d) -> bool:
        return (
            isinstance(d, ast.FunctionDef)
            and not d.name.startswith("_")
            and self.cpu_branch(d)
        )

    def reaches(self, d, seen: set) -> bool:
        """``d`` reaches a ``launch_*`` call other than through a wrapper
        with a CPU branch."""
        if d.name in self._reaches:
            return self._reaches[d.name]
        if d.name in seen:
            return False
        seen = seen | {d.name}
        hit = self.launches(d) or any(
            not self.guarded(c) and self.reaches(c, seen) for c in self.callees(d)
        )
        self._reaches[d.name] = hit
        return hit

    def plain_path(self, call: ast.Call) -> bool:
        """``call`` runs a plain version: a function of the ref module, or a
        local helper that calls one and launches nothing."""
        if _is_ref_call(self.ctx, call):
            return True
        d = self.defs.get(_leaf(call.func) or "") if isinstance(call.func, ast.Name) else None
        return (
            isinstance(d, ast.FunctionDef)
            and any(_is_ref_call(self.ctx, c) for c in _calls(d))
            and not self.reaches(d, set())
        )


@register_rule
class KernelWrapperHygiene(Rule):
    id = "KRN001"
    name = "kernel-wrapper-hygiene"
    family = "kernels"
    rationale = (
        "Replaces the reference's pallas-kernel-hygiene (interpret= "
        "plumbing and a *_ref oracle per *_pallas wrapper).  In a module of "
        "repro_torch/kernels/ (all but ref.py, build.py and autotune.py), "
        "every public wrapper that reaches a launch_* call must branch on "
        "build.on_cpu(...) (or a local helper returning it) and call a plain "
        "version of repro_torch.kernels.ref on the CPU side, or reach the "
        "launch only through a wrapper that does: a kernel without a plain "
        "twin is hand-written numerics nothing can hold it to.  And an "
        "except handler there may not run the plain path (a ref call, a "
        "helper of them, or .cpu()): a kernel that fails on the card must "
        "raise, never fall back"
    )

    def check(self, ctx: FileContext):
        if not in_kernel_wrappers(ctx):
            return
        mod = _Module(ctx)
        for name, d in mod.defs.items():
            if (
                isinstance(d, ast.FunctionDef)
                and not name.startswith("_")
                and not name.startswith("launch_")
                and not mod.cpu_branch(d)
                and mod.reaches(d, set())
            ):
                yield self.finding(
                    ctx,
                    d,
                    f"{name} reaches a kernel launch with no CPU branch: test "
                    "build.on_cpu(...) and call its plain version from "
                    "repro_torch.kernels.ref there, or reach the launch "
                    "through a wrapper that does",
                )
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            for stmt in node.body:
                for call in _calls(stmt):
                    if mod.plain_path(call) or _leaf(call.func) == "cpu":
                        yield self.finding(
                            ctx,
                            call,
                            "an except handler runs the plain path: a kernel "
                            "that fails on the card must raise, not fall back "
                            "to its plain version",
                        )
