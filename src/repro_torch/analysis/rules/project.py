"""Project-invariant rules (PRJ0xx). Port of ``repro/analysis/rules/project.py``.

These encode GLISP-repo conventions the earlier PRs established: errors
are never swallowed silently outside finalizers, deprecated shims are for
*external* callers only (library code uses the replacement surfaces), and
every registry key a config or call site names must actually be registered
— config validation and the live registries must not drift.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Rule, register_rule

__all__ = [
    "SilentExceptPass",
    "DeprecatedShimCall",
    "ConfigRegistryDrift",
    "BlockingWaitNoTimeout",
    "UnboundedRequestQueue",
    "MultiprocessingHygiene",
]


_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BROAD for e in t.elts)
    return False


def _body_is_silent(body) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / `...`
        return False
    return True


@register_rule
class SilentExceptPass(Rule):
    id = "PRJ001"
    name = "silent-except-pass"
    family = "project"
    rationale = (
        "`except Exception: pass` swallows every failure — including the "
        "determinism bugs the rest of this analyzer looks for — with no "
        "trace.  Narrow to the exceptions the block can actually raise and "
        "log them; only __del__ finalizers (where raising is unusable) are "
        "exempt."
    )

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not (_is_broad(node) and _body_is_silent(node.body)):
                continue
            fn = ctx.enclosing_function(node)
            if fn is not None and fn.name == "__del__":
                continue
            yield self.finding(
                ctx,
                node,
                "broad except with a silent body swallows all errors; "
                "narrow the exception types and log at debug "
                "(only __del__ is exempt)",
            )


# deprecated surfaces (kept one release for external callers) and the shim
# modules that define them — the only library files allowed to mention them
_SHIM_CALLS = {
    "adadne": "PARTITIONERS.get('adadne').partition(...)",
    "distributed_ne": "PARTITIONERS.get('dne').partition(...)",
    "TwoLevelCache": "repro_torch.core.storage.HybridCache",
    "ChunkedEmbeddingStore": "repro_torch.core.storage.DFSTier",
}
_SHIM_FILES = (
    "repro_torch/core/partition/dne.py",
    "repro_torch/core/inference/cache.py",
    "repro_torch/core/inference/store.py",
    "repro_torch/core/storage/store.py",
    "repro_torch/core/sampling/service.py",
    "repro_torch/api/backends.py",
)


@register_rule
class DeprecatedShimCall(Rule):
    id = "PRJ002"
    name = "deprecated-shim-call"
    family = "project"
    rationale = (
        "backend.sample(), TwoLevelCache, ChunkedEmbeddingStore and the "
        "free-function partitioners survive only as deprecation shims for "
        "external callers.  Library code calling a shim re-entrenches the "
        "old surface and dodges the replacements' contracts (keyed submit, "
        "tiered storage, PartitionPlan scorecards)."
    )

    def check(self, ctx: FileContext):
        if not ctx.is_library:
            return
        if ctx.path.endswith(_SHIM_FILES):
            return
        for call in ctx.calls():
            fn = call.func
            leaf = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None
            )
            if leaf in _SHIM_CALLS:
                yield self.finding(
                    ctx,
                    call,
                    f"{leaf} is a deprecated shim; library code should use "
                    f"{_SHIM_CALLS[leaf]}",
                )
            elif isinstance(fn, ast.Attribute) and fn.attr == "sample":
                yield self.finding(
                    ctx,
                    call,
                    ".sample(...) is the deprecated submit-and-wait shim; "
                    "library code should submit(seeds, spec, key=...) and "
                    "take ticket.result()",
                )


# config field -> registry holding its legal values
_FIELD_REGISTRIES = {
    "partitioner": "PARTITIONERS",
    "sampler": "SAMPLERS",
    "reorder": "REORDERS",
    "cache_policy": "CACHE_POLICIES",
    "storage_tiers": "STORAGE_TIERS",
}


@register_rule
class ConfigRegistryDrift(Rule):
    id = "PRJ003"
    name = "config-registry-drift"
    family = "project"
    rationale = (
        "GLISPConfig's registry-named fields and any literal "
        "REGISTRY.get('name') lookup are promises about what is "
        "registered; when a registry entry is renamed the promise silently "
        "breaks at a distant call site.  This rule resolves every literal "
        "key against the *live* registries at lint time."
    )

    def _registries(self) -> dict | None:
        try:
            from repro_torch.api import backends
        except ImportError:
            return None  # analyzing a foreign tree: nothing to resolve
        return {
            name: getattr(backends, name)
            for name in sorted(set(_FIELD_REGISTRIES.values()))
            if hasattr(backends, name)
        }

    def check(self, ctx: FileContext):
        registries = None
        for node in ast.walk(ctx.tree):
            # literal lookups: PARTITIONERS.get("name") anywhere
            if isinstance(node, ast.Call):
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "get"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in _FIELD_REGISTRIES.values()
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    if self._in_raises_block(ctx, node):
                        continue  # tests asserting the unknown-key error
                    if registries is None:
                        registries = self._registries()
                        if registries is None:
                            return
                    reg = registries.get(fn.value.id)
                    key = node.args[0].value
                    if reg is not None and key not in reg:
                        yield self.finding(
                            ctx,
                            node.args[0],
                            f"{fn.value.id}.get({key!r}): no such entry "
                            f"(registered: {', '.join(reg.names())})",
                        )
            # GLISPConfig field defaults
            elif isinstance(node, ast.ClassDef) and node.name == "GLISPConfig":
                if registries is None:
                    registries = self._registries()
                    if registries is None:
                        return
                yield from self._check_defaults(ctx, node, registries)

    @staticmethod
    def _in_raises_block(ctx, node) -> bool:
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    ce = item.context_expr
                    if (
                        isinstance(ce, ast.Call)
                        and ctx.resolve(ce.func) == "pytest.raises"
                    ):
                        return True
        return False

    def _check_defaults(self, ctx, cls, registries):
        for stmt in cls.body:
            if not (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and stmt.value is not None
            ):
                continue
            reg = registries.get(_FIELD_REGISTRIES.get(stmt.target.id, ""))
            if reg is None:
                continue
            values = (
                stmt.value.elts
                if isinstance(stmt.value, (ast.Tuple, ast.List))
                else [stmt.value]
            )
            for v in values:
                if (
                    isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                    and v.value not in reg
                ):
                    yield self.finding(
                        ctx,
                        v,
                        f"GLISPConfig.{stmt.target.id} default {v.value!r} "
                        f"is not registered "
                        f"(registered: {', '.join(reg.names())})",
                    )


def _queue_like(recv: ast.expr) -> bool:
    """Does the receiver *name* look like a queue (``q``, ``cmd_q``,
    ``work_queue``, ``self._data_q``)?  Name-based on purpose: dict.get
    and registry .get calls stay out of scope."""
    name = None
    if isinstance(recv, ast.Name):
        name = recv.id
    elif isinstance(recv, ast.Attribute):
        name = recv.attr
    if name is None:
        return False
    low = name.lower()
    return low == "q" or low.endswith("_q") or "queue" in low


@register_rule
class BlockingWaitNoTimeout(Rule):
    id = "PRJ004"
    name = "blocking-wait-no-timeout"
    family = "project"
    rationale = (
        "a bare ticket.result() or queue.get() in library code blocks "
        "forever when the producing server/worker dies — exactly the hang "
        "the fault-tolerance layer exists to prevent.  Pass timeout= "
        "(timeout=None is fine: it states the unbounded wait is deliberate "
        "or defers to a configured deadline) so a dead peer surfaces as an "
        "exception instead of a wedged process."
    )

    def check(self, ctx: FileContext):
        if not ctx.is_library:
            return
        for call in ctx.calls():
            fn = call.func
            if not isinstance(fn, ast.Attribute):
                continue
            if call.args or any(kw.arg == "timeout" for kw in call.keywords):
                continue
            if fn.attr == "result":
                yield self.finding(
                    ctx,
                    call,
                    ".result() without timeout= blocks forever if the "
                    "request never completes; pass timeout= (None to defer "
                    "to the configured deadline)",
                )
            elif fn.attr == "get" and _queue_like(fn.value):
                yield self.finding(
                    ctx,
                    call,
                    "queue .get() without timeout= hangs if the producer "
                    "died; poll with timeout= and check the worker is alive",
                )


# constructors whose no-argument form is an unbounded FIFO
_UNBOUNDED_QUEUES = {
    "queue.Queue",
    "queue.LifoQueue",
    "queue.PriorityQueue",
    "multiprocessing.Queue",
    "multiprocessing.JoinableQueue",
}


@register_rule
class UnboundedRequestQueue(Rule):
    id = "PRJ005"
    name = "unbounded-request-queue"
    family = "project"
    rationale = (
        "an unbounded request buffer turns overload into unbounded memory "
        "growth and unbounded queueing delay — by the time anything "
        "surfaces, every queued request has already missed its deadline.  "
        "Library queues must carry a capacity: pass maxsize=/maxlen=, or "
        "enforce an explicit admission bound that REJECTS (like "
        "repro_torch.serve.RequestQueue) and suppress with the justification."
    )

    def check(self, ctx: FileContext):
        if not ctx.is_library:
            return
        for call in ctx.calls():
            target = ctx.resolve(call.func)
            if target in _UNBOUNDED_QUEUES:
                # a positional arg or maxsize= states the bound
                if call.args or any(
                    kw.arg == "maxsize" for kw in call.keywords
                ):
                    continue
                yield self.finding(
                    ctx,
                    call,
                    f"{target}() without maxsize is an unbounded buffer; "
                    "bound it or shed load explicitly at admission",
                )
            elif target == "queue.SimpleQueue":
                yield self.finding(
                    ctx,
                    call,
                    "queue.SimpleQueue cannot be bounded at all; use "
                    "queue.Queue(maxsize=...) for request buffering",
                )
            elif target == "collections.deque":
                if any(kw.arg == "maxlen" for kw in call.keywords) or len(
                    call.args
                ) >= 2:
                    continue
                if self._assigned_to_queue_name(ctx, call):
                    yield self.finding(
                        ctx,
                        call,
                        "deque used as a queue with no maxlen; bound it or "
                        "enforce an explicit admission-depth check",
                    )

    @staticmethod
    def _assigned_to_queue_name(ctx: FileContext, call: ast.Call) -> bool:
        """Only deques *named* like queues are in scope — scratch deques
        (visit stacks, sliding windows) are legitimate unbounded uses."""
        parent = ctx.parent(call)
        if isinstance(parent, ast.Assign):
            return any(_queue_like(t) for t in parent.targets)
        if isinstance(parent, ast.AnnAssign):
            return _queue_like(parent.target)
        return False


# receivers whose ``.Process`` attribute is the multiprocessing ctor:
# the module itself or a start-method context (``mp.get_context("fork")``
# conventionally lands in a name like ``ctx``)
_MP_RECEIVERS = ("mp", "multiprocessing", "ctx", "context")

# receiver names that denote a child process handle; thread handles
# (``t``, ``thread``) stay out of scope — a daemon thread dies with the
# interpreter, an unjoined child process does not
_PROC_NAMES = ("proc", "worker", "child", "popen", "subproc")


def _recv_name(recv: ast.expr) -> str | None:
    if isinstance(recv, ast.Name):
        return recv.id
    if isinstance(recv, ast.Attribute):
        return recv.attr
    return None


def _proc_like(recv: ast.expr) -> bool:
    name = _recv_name(recv)
    return name is not None and any(p in name.lower() for p in _PROC_NAMES)


@register_rule
class MultiprocessingHygiene(Rule):
    id = "PRJ006"
    name = "multiprocessing-hygiene"
    family = "project"
    rationale = (
        "a child process spawned without daemon=True outlives a crashed "
        "parent as an orphan holding its pipe fds open, and a bare "
        ".join()/.wait() on a process handle blocks forever when the child "
        "wedges instead of exiting — the distributed tier's crash-recovery "
        "contract requires every spawn to state daemon= and every reap to "
        "carry a timeout= bound (suppress with the justification where the "
        "child is provably already dead, e.g. after SIGKILL)."
    )

    def check(self, ctx: FileContext):
        if not ctx.is_library:
            return
        for call in ctx.calls():
            fn = call.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr == "Process":
                resolved = ctx.resolve(fn) or ""
                recv = _recv_name(fn.value) or ""
                if resolved != "multiprocessing.Process" and not any(
                    m in recv.lower() for m in _MP_RECEIVERS
                ):
                    continue  # some other .Process attribute
                if any(kw.arg == "daemon" for kw in call.keywords):
                    continue
                yield self.finding(
                    ctx,
                    call,
                    "Process(...) without daemon=: an orphaned child "
                    "outlives a crashed parent; state daemon= explicitly",
                )
            elif fn.attr in ("join", "wait") and _proc_like(fn.value):
                if call.args or any(
                    kw.arg == "timeout" for kw in call.keywords
                ):
                    continue
                yield self.finding(
                    ctx,
                    call,
                    f".{fn.attr}() on a process handle without timeout= "
                    "blocks forever if the child wedges; bound the reap "
                    "with timeout=",
                )
