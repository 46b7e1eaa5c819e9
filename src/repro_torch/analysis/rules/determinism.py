"""Determinism rules (DET0xx). Port of ``repro/analysis/rules/determinism.py``.

GLISP's reproducibility contract is *keyed* randomness: every random draw
is derived from an explicit ``(seed, request, hop, server, chunk)`` key, so
results are bit-identical under any interleaving, prefetch depth, or
service sharing.  These rules flag the ways Python code silently breaks
that contract: process-global RNG state, hash-order iteration, and wall
clock / filesystem enumeration feeding computed values.  On the torch side
the convention is an explicit ``torch.Generator`` handed to every draw
(``normal_(..., generator=generator)``), so DET001 also flags PyTorch's
process-global generator: its seeding functions, and every sampling call
that takes ``generator=`` but is called without it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Rule, register_rule

__all__ = [
    "UnseededGlobalRng",
    "SetIteration",
    "WallclockValue",
    "UnkeyedSubmit",
]

# numpy.random attributes that are fine: explicitly seeded constructors and
# bit generators.  Everything else on the module (`rand`, `seed`, `shuffle`,
# ...) mutates or reads the hidden global MT19937 state.
_NP_RANDOM_OK = {
    "default_rng",
    "Generator",
    "SeedSequence",
    "BitGenerator",
    "RandomState",  # legacy but explicitly seedable; flag only global fns
    "PCG64",
    "PCG64DXSM",
    "Philox",
    "SFC64",
    "MT19937",
}

# stdlib random: only the explicitly-seeded instance constructor is allowed
# (SystemRandom is *designed* to be irreproducible)
_PY_RANDOM_OK = {"Random"}

# torch functions that seed or set the process-global generator
_TORCH_GLOBAL_SEEDING = {
    "torch.manual_seed",
    "torch.seed",
    "torch.set_rng_state",
    "torch.random.manual_seed",
    "torch.random.seed",
    "torch.random.set_rng_state",
    "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
    "torch.cuda.seed",
    "torch.cuda.seed_all",
    "torch.cuda.set_rng_state",
    "torch.cuda.set_rng_state_all",
}

# torch sampling functions that take ``generator=``: without it they draw
# from the process-global generator
_TORCH_SAMPLERS = {
    "torch.rand",
    "torch.randn",
    "torch.randint",
    "torch.randperm",
    "torch.bernoulli",
    "torch.multinomial",
    "torch.normal",
    "torch.poisson",
    "torch.rand_like",
    "torch.randn_like",
    "torch.randint_like",
}

# in-place Tensor samplers (and ``torch.nn.init``'s of the same names), by
# method name: each takes ``generator=``
_TORCH_INPLACE_SAMPLERS = {
    "uniform_",
    "normal_",
    "random_",
    "bernoulli_",
    "exponential_",
    "geometric_",
    "cauchy_",
    "log_normal_",
}


def _passes_generator(call: ast.Call) -> bool:
    """``generator=`` given, or a ``**kwargs`` that may carry it."""
    return any(kw.arg in ("generator", None) for kw in call.keywords)


@register_rule
class UnseededGlobalRng(Rule):
    id = "DET001"
    name = "unseeded-global-rng"
    family = "determinism"
    rationale = (
        "Global-state RNG calls (np.random.rand, random.shuffle, ...) share "
        "one hidden stream across the whole process, so results depend on "
        "call order, thread/process scheduling and unrelated code.  Use "
        "np.random.default_rng(seed) / random.Random(seed), or derive a key "
        "the way the sampling service does (np.random.SeedSequence).  On "
        "the torch side, torch.manual_seed and every torch.rand / randn / "
        "randint / randperm / normal_ / uniform_ ... without generator= use "
        "PyTorch's process-global generator: pass a seeded torch.Generator."
    )

    def check(self, ctx: FileContext):
        for call in ctx.calls():
            fn = call.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in _TORCH_INPLACE_SAMPLERS
                and not _passes_generator(call)
            ):
                yield self.finding(
                    ctx,
                    call,
                    f".{fn.attr}(...) without generator= draws from PyTorch's "
                    "process-global generator; pass a seeded torch.Generator",
                )
                continue
            dn = ctx.resolve(fn)
            if dn is None:
                continue
            if dn in _TORCH_GLOBAL_SEEDING:
                yield self.finding(
                    ctx,
                    call,
                    f"{dn} reads or sets PyTorch's process-global generator; "
                    "create a torch.Generator and seed it with manual_seed",
                )
                continue
            if dn in _TORCH_SAMPLERS and not _passes_generator(call):
                yield self.finding(
                    ctx,
                    call,
                    f"{dn} without generator= draws from PyTorch's "
                    "process-global generator; pass a seeded torch.Generator",
                )
                continue
            parts = dn.split(".")
            if (
                len(parts) == 3
                and parts[:2] == ["numpy", "random"]
                and parts[2] not in _NP_RANDOM_OK
            ):
                yield self.finding(
                    ctx,
                    call,
                    f"np.random.{parts[2]} uses process-global RNG state; "
                    "use np.random.default_rng(seed) or a SeedSequence key",
                )
            elif (
                len(parts) == 2
                and parts[0] == "random"
                and parts[1] not in _PY_RANDOM_OK
            ):
                yield self.finding(
                    ctx,
                    call,
                    f"random.{parts[1]} uses process-global RNG state; "
                    "use random.Random(seed)",
                )


def _is_setish(node) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    )


# order-independent reductions: consuming a set through these is fine
_ORDER_FREE = {"sorted", "len", "sum", "min", "max", "any", "all", "bool", "set", "frozenset"}
# order-preserving consumers: a set here leaks hash order into the result
_ORDER_SENSITIVE = {"list", "tuple", "enumerate", "reversed", "iter", "map", "filter", "zip"}
_ORDER_SENSITIVE_DOTTED = {"numpy.array", "numpy.asarray", "numpy.fromiter"}


@register_rule
class SetIteration(Rule):
    id = "DET002"
    name = "set-iteration"
    family = "determinism"
    rationale = (
        "Set iteration order follows the hash seed and insertion history, "
        "not a stable order, so any value built by iterating a set can "
        "differ between runs/processes.  Sort first (sorted(...)) or use "
        "np.unique, which is already sorted."
    )

    _MSG = (
        "iterating a set leaks hash order into the result; wrap in "
        "sorted(...) or use np.unique"
    )

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.For) and _is_setish(node.iter):
                yield self.finding(ctx, node.iter, self._MSG)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
                for comp in node.generators:
                    if _is_setish(comp.iter):
                        yield self.finding(ctx, comp.iter, self._MSG)
            elif isinstance(node, ast.Call):
                dn = ctx.resolve(node.func)
                sensitive = dn in _ORDER_SENSITIVE_DOTTED or (
                    isinstance(node.func, ast.Name)
                    and node.func.id in _ORDER_SENSITIVE
                ) or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                )
                if sensitive:
                    for arg in node.args:
                        if _is_setish(arg):
                            yield self.finding(ctx, arg, self._MSG)


# always nondeterministic as *values* (wall clock, uuid, os entropy)
_VALUE_FNS = {
    "time.time": "time.perf_counter for timing, or pass timestamps in explicitly",
    "time.time_ns": "time.perf_counter_ns for timing",
    "datetime.datetime.now": "pass timestamps in explicitly",
    "datetime.datetime.utcnow": "pass timestamps in explicitly",
    "datetime.datetime.today": "pass timestamps in explicitly",
    "datetime.date.today": "pass dates in explicitly",
    "uuid.uuid1": "a content hash (repro_torch.utils.stable_hash64) or uuid5 over stable inputs",
    "uuid.uuid4": "a content hash (repro_torch.utils.stable_hash64) or uuid5 over stable inputs",
    "os.urandom": "a seeded np.random.default_rng",
}

# OS-order directory enumeration: fine when reduced order-free (sorted, len,
# emptiness tests), hash-order hazard when the listing order reaches a value
_LISTING_FNS = {"os.listdir", "os.scandir", "os.walk", "glob.glob", "glob.iglob"}


@register_rule
class WallclockValue(Rule):
    id = "DET003"
    name = "wallclock-value"
    family = "determinism"
    rationale = (
        "time.time()/uuid4()/os.listdir() feed OS state into computed "
        "values: runs stop being reproducible and cache keys stop being "
        "content-addressed.  Directory listings are OS-order; sort them.  "
        "Relative timing should use time.perf_counter (allowed)."
    )

    def check(self, ctx: FileContext):
        for call in ctx.calls():
            dn = ctx.resolve(call.func)
            if dn in _VALUE_FNS:
                yield self.finding(
                    ctx,
                    call,
                    f"{dn}() is nondeterministic as a value; use "
                    f"{_VALUE_FNS[dn]}",
                )
            elif dn in _LISTING_FNS and not self._order_free(ctx, call):
                yield self.finding(
                    ctx,
                    call,
                    f"{dn}() returns entries in OS order; wrap in sorted(...) "
                    "(or reduce order-free: len/emptiness)",
                )

    @staticmethod
    def _order_free(ctx: FileContext, call: ast.Call) -> bool:
        parent = ctx.parent(call)
        if isinstance(parent, ast.Call) and isinstance(parent.func, ast.Name):
            if parent.func.id in _ORDER_FREE:
                return True
        if isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.Not):
            return True
        if isinstance(parent, (ast.If, ast.While, ast.Assert)) and parent.test is call:
            return True
        return False


@register_rule
class UnkeyedSubmit(Rule):
    id = "DET004"
    name = "unkeyed-submit"
    family = "determinism"
    rationale = (
        "SamplingService.submit without an explicit key= falls back to a "
        "service-assigned sequence key, so the draw depends on what else "
        "shares the service and in what order.  Library code must thread a "
        "caller-owned key (the pipeline's (seed, batch_index), the engine's "
        "(seed, layer, part) ...) so results survive any interleaving."
    )

    def check(self, ctx: FileContext):
        if not ctx.is_library:
            return
        for call in ctx.calls():
            fn = call.func
            named_submit = (
                isinstance(fn, ast.Attribute) and fn.attr == "submit"
            ) or (isinstance(fn, ast.Name) and fn.id == "submit")
            if not named_submit or not call.args:
                continue
            has_key = any(kw.arg in ("key", None) for kw in call.keywords)
            if not has_key:
                yield self.finding(
                    ctx,
                    call,
                    "submit(...) without an explicit key=; pass a "
                    "caller-owned RNG key so the request stream is "
                    "independent of service sharing",
                )
