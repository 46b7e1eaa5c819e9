"""PyTorch hygiene rules (TRH0xx): the port's counterparts of the
reference's JAX rules (``repro/analysis/rules/jax_hygiene.py``).

The reference's contract is one jit compile per (layer, bucket) and one
transfer each way per batch. The port runs eagerly, so its form of the same
contract is: the kernel wrappers never wait on the card (``chip_smoke.py``
times them by CUDA-graph replay, which a host sync breaks, and the engine's
slices copy once each way), and padded shapes come from the bucketers (a
bucket is one serving shape, so one cuBLAS choice and one set of a row's
bits, and one tuner sweep per (op, bucket, dtype)).

- TRH001 host-sync-in-wrapper replaces JAX001 host-sync-in-jit.
- TRH002 unbucketed-pad replaces JAX004, over ``numpy.pad`` and
  ``torch.nn.functional.pad``.
- JAX002 (jit-in-loop) and JAX003 (non-hashable static arg) have no
  counterpart: eager PyTorch builds no compile cache per call, and
  ``kernels.build.library`` compiles each CUDA source once per process.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Rule, register_rule
from repro_torch.analysis.rules.kernels import in_kernel_wrappers

__all__ = ["HostSyncInWrapper", "UnbucketedPad"]

# methods that copy a tensor's values to the host (or wait for the card)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_FNS = {"torch.cuda.synchronize"}
# Python scalar annotations: a parameter so annotated is a host value
_SCALAR_TYPES = {"int", "bool", "float", "str"}


def _static_safe(node, statics: set) -> bool:
    """True when an expression is safe to concretize on the host: it reads
    only metadata (.shape/.ndim/.size/.dtype, .numel(), len()), host names
    (``statics``), or constants; never a tensor's *values*. A called
    function's own name is not a value."""
    callees = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim", "size", "dtype"):
            return True
        if isinstance(n, ast.Call):
            if (isinstance(n.func, ast.Name) and n.func.id == "len") or (
                isinstance(n.func, ast.Attribute) and n.func.attr == "numel"
            ):
                return True
            callees.add(n.func)
    names = {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name) and n not in callees
    }
    return names <= statics


def _module_names(tree) -> set:
    """Names bound at module level: imports, defs, classes, constants."""
    out: set = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
    return out


def _host_names(fn, module: set) -> set:
    """The names of ``fn`` that hold host values: self/cls, parameters
    annotated as Python scalars or ``torch.dtype``, module-level names,
    ``for`` targets over ``range(...)``, and locals assigned only from such
    values (to a fixpoint)."""
    args = fn.args
    out = {"self", "cls"} | module
    for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        ann = a.annotation
        if isinstance(ann, ast.Constant):
            ann = ast.Name(id=str(ann.value))
        if (isinstance(ann, ast.Name) and ann.id in _SCALAR_TYPES) or (
            isinstance(ann, ast.Attribute) and ann.attr == "dtype"
        ):
            out.add(a.arg)
    assigns: dict = {}
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.For)
            and isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
        ):
            out.update(n.id for n in ast.walk(node.target) if isinstance(n, ast.Name))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigns.setdefault(t.id, []).append(node.value)
    grew = True
    while grew:
        grew = False
        for name, values in assigns.items():
            if name not in out and all(_static_safe(v, out) for v in values):
                out.add(name)
                grew = True
    return out


@register_rule
class HostSyncInWrapper(Rule):
    id = "TRH001"
    name = "host-sync-in-wrapper"
    family = "torch"
    rationale = (
        "Replaces JAX001 host-sync-in-jit.  .item()/.tolist()/.cpu()/"
        ".numpy(), torch.cuda.synchronize() and float()/int()/bool() of a "
        "tensor make the host wait for the card.  Inside a kernel wrapper "
        "(the modules of repro_torch/kernels/ but ref.py, whose plain "
        "versions run on the CPU, build.py, and autotune.py, which syncs "
        "on purpose to time) that breaks CUDA-graph capture and the "
        "engine's one copy each way per slice.  Concretize only metadata "
        "(.shape, .numel(), len()) and Python scalar parameters"
    )

    def check(self, ctx: FileContext):
        if not in_kernel_wrappers(ctx):
            return
        module = _module_names(ctx.tree)
        seen: set = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            statics = _host_names(fn, module)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or node in seen:
                    continue
                seen.add(node)  # a nested def's calls are checked once
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                    yield self.finding(
                        ctx, node,
                        f".{f.attr}() in a kernel wrapper copies to the host "
                        "and waits for the card",
                    )
                elif ctx.resolve(f) in _SYNC_FNS:
                    yield self.finding(
                        ctx, node,
                        "torch.cuda.synchronize() in a kernel wrapper waits "
                        "for the card",
                    )
                elif (
                    isinstance(f, ast.Name)
                    and f.id in ("float", "int", "bool")
                    and node.args
                    and not _static_safe(node.args[0], statics)
                ):
                    yield self.finding(
                        ctx, node,
                        f"{f.id}(...) of a (possibly) tensor value in a kernel "
                        "wrapper waits for the card; only metadata (.shape, "
                        ".numel(), len()) and scalar parameters may be "
                        "concretized",
                    )


# helpers whose output is an approved padded/bucketed length
_BUCKET_HELPERS = {
    "round_up",
    "ceil_div",
    "pow2_ceil",
    "_pow2_ceil",
    "_bucket",
    "_vertex_bucket",
    "_edge_bucket",
    "next_power_of_2",
    "bit_length",
}
_BUCKETY_NAME_PARTS = ("pad", "quantum", "bucket", "cap")
_PAD_FNS = {"numpy.pad", "torch.nn.functional.pad"}


@register_rule
class UnbucketedPad(Rule):
    id = "TRH002"
    name = "unbucketed-pad"
    family = "torch"
    rationale = (
        "Replaces JAX004 unbucketed-pad.  Padding an input to a raw "
        "data-dependent length (x.shape[0], len(batch), ...) makes every "
        "distinct input size a distinct shape: in the port a distinct "
        "serving shape (cuBLAS picks per shape, and so a row's bits) and "
        "one more tuner sweep.  Pad lengths must come through the "
        "bucketers: round_up / _pow2_ceil / the engine's "
        "_vertex_bucket/_edge_bucket, or an explicit quantum"
    )

    def check(self, ctx: FileContext):
        for call in ctx.calls():
            fn = call.func
            dn = ctx.resolve(fn)
            leaf = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None
            )
            if leaf == "pad_to" and len(call.args) >= 2:
                if not self._bucketed(ctx, call, call.args[1]):
                    yield self.finding(
                        ctx,
                        call.args[1],
                        "pad_to length is a raw data-dependent value; route "
                        "it through round_up/_pow2_ceil or a *_quantum so "
                        "shapes stay bucketed",
                    )
            elif dn in _PAD_FNS and len(call.args) >= 2:
                for expr in self._width_exprs(call.args[1]):
                    if not self._bucketed(ctx, call, expr):
                        yield self.finding(
                            ctx,
                            expr,
                            "pad width is a raw data-dependent value; derive "
                            "it from a bucketed length (round_up/_pow2_ceil) "
                            "so shapes stay bucketed",
                        )

    @staticmethod
    def _width_exprs(widths):
        """Non-constant leaf expressions of a pad-width spec."""
        if isinstance(widths, (ast.Tuple, ast.List)):
            for el in widths.elts:
                yield from UnbucketedPad._width_exprs(el)
        elif not isinstance(widths, ast.Constant):
            yield widths

    def _bucketed(self, ctx: FileContext, call, expr, depth: int = 1) -> bool:
        """An expression produces a bucketed length if any term is a
        constant-only expression, an approved helper call, ceil-style
        floor-div/shift arithmetic, a bucket-named variable, or (one level
        deep) a name assigned from one of those."""
        if isinstance(expr, ast.Constant):
            return True
        for n in ast.walk(expr):
            if isinstance(n, (ast.FloorDiv, ast.LShift)):
                return True
            if isinstance(n, ast.Call):
                f = n.func
                leaf = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None
                )
                if leaf in _BUCKET_HELPERS:
                    return True
            if isinstance(n, ast.Name) and any(
                part in n.id.lower() for part in _BUCKETY_NAME_PARTS
            ):
                return True
        if depth > 0:
            for n in ast.walk(expr):
                if isinstance(n, ast.Name):
                    rhs = ctx.name_assignment(call, n.id)
                    if rhs is not None and self._bucketed(ctx, call, rhs, depth - 1):
                        return True
        return False
