"""Deterministic fault injection for chaos testing and failover machinery.

GLISP's deployment story assumes sampling servers, storage tiers, and
prefetch workers that can fail and recover.  This module provides the
shared vocabulary for *exercising* those failure paths reproducibly:

``FaultPlan``
    A frozen schedule of per-site failure specs.  Whether invocation
    ``n`` of site ``s`` fails is a pure function of ``(plan.seed, s, n)``
    — a hash-derived Bernoulli draw — so a chaos run is exactly
    reproducible: rerunning the same plan against the same workload
    injects the same faults at the same points.

``FaultInjector``
    The runtime counterpart: carries per-site invocation counters and
    burst state.  Subsystems call ``fire(site)`` at their injection
    point; it raises :class:`InjectedFault` when the schedule says so.

``RetryPolicy``
    Capped exponential backoff shared by the sampling dispatch path and
    the tiered-storage read path.

``CircuitBreaker``
    Quarantines a repeatedly failing target (e.g. one sampling-server
    replica) so dispatches stop burning retry budget on it, with a
    half-open probe after a cooldown.

Sites are dotted names spaced per subsystem (``server.<part>.<replica>``,
``disk.read``, ``dfs.read``, ``worker``, ``train.step``); plans match
them with ``fnmatch`` patterns (first match wins), so one plan can
target a single replica (``server.0.1``) or a whole subsystem
(``server.*``).
"""

from __future__ import annotations

import fnmatch
import hashlib
import struct
import time
from dataclasses import dataclass, field

__all__ = [
    "CircuitBreaker",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "RetryPolicy",
]


class InjectedFault(RuntimeError):
    """A failure raised by a :class:`FaultInjector` per its plan."""

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected fault at site {site!r} (invocation {invocation})")
        self.site = site
        self.invocation = invocation


@dataclass(frozen=True)
class FaultSpec:
    """Failure behaviour for one site pattern.

    ``p`` is the per-invocation Bernoulli probability of *triggering* a
    failure; a trigger fails ``burst`` consecutive invocations (the
    trigger itself plus ``burst - 1`` followers), modelling a server
    that stays down briefly rather than flapping per call.  ``limit``
    caps the total failures the site may inject (``None`` = unlimited);
    a finite limit lets property tests guarantee that retries
    eventually succeed (any dispatch recovers once
    ``attempts * replicas > limit``).
    """

    p: float = 0.0
    burst: int = 1
    limit: int | None = None

    def validate(self) -> None:
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {self.p}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.limit is not None and self.limit < 0:
            raise ValueError(f"limit must be >= 0, got {self.limit}")

    def to_dict(self) -> dict:
        return {"p": self.p, "burst": self.burst, "limit": self.limit}


def _unit_draw(seed: int, site: str, invocation: int) -> float:
    """Uniform [0, 1) draw keyed by ``(seed, site, invocation)``.

    Hash-derived (blake2b) rather than a stateful generator so the
    decision for any invocation is independent of evaluation order —
    two subsystems interleaving their sites cannot perturb each other.
    """
    payload = site.encode() + struct.pack("<qq", seed, invocation)
    digest = hashlib.blake2b(payload, digest_size=8).digest()
    return struct.unpack("<Q", digest)[0] / 2.0**64


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, frozen chaos schedule.

    ``sites`` maps ``fnmatch`` patterns to :class:`FaultSpec`; the first
    matching pattern wins, so specific overrides (``("server.0.0",
    FaultSpec(p=1.0))``) should precede catch-alls (``("server.*",
    FaultSpec(p=0.05))``).  The plan itself is immutable; runtime
    counters live in the :class:`FaultInjector` it spawns.
    """

    seed: int = 0
    sites: tuple = ()

    def __post_init__(self):
        for entry in self.sites:
            pattern, spec = entry
            if not isinstance(pattern, str) or not isinstance(spec, FaultSpec):
                raise TypeError(
                    "FaultPlan.sites entries must be (pattern, FaultSpec), "
                    f"got {entry!r}"
                )
            spec.validate()

    @classmethod
    def bernoulli(
        cls,
        p: float,
        *,
        site: str = "*",
        seed: int = 0,
        burst: int = 1,
        limit: int | None = None,
    ) -> "FaultPlan":
        """Single-pattern convenience constructor."""
        return cls(seed=seed, sites=((site, FaultSpec(p=p, burst=burst, limit=limit)),))

    def spec_for(self, site: str) -> FaultSpec | None:
        for pattern, spec in self.sites:
            if fnmatch.fnmatchcase(site, pattern):
                return spec
        return None

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "sites": [[pattern, spec.to_dict()] for pattern, spec in self.sites],
        }


class FaultInjector:
    """Runtime state for a :class:`FaultPlan`: per-site counters + bursts.

    Not thread-safe by itself; callers that share one injector across
    threads (e.g. ``SamplingService`` under its round lock) must already
    serialise the calls.  Each site's decision stream depends only on
    its own invocation count, so distinct sites never perturb each
    other.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.invocations: dict[str, int] = {}
        self.failures: dict[str, int] = {}
        self._burst_left: dict[str, int] = {}

    def should_fail(self, site: str) -> bool:
        """Advance site ``site`` by one invocation; True if it must fail."""
        spec = self.plan.spec_for(site)
        if spec is None or (spec.p <= 0.0 and self._burst_left.get(site, 0) <= 0):
            return False
        n = self.invocations.get(site, 0)
        self.invocations[site] = n + 1
        fails = self.failures.get(site, 0)
        if spec.limit is not None and fails >= spec.limit:
            return False
        if self._burst_left.get(site, 0) > 0:
            self._burst_left[site] -= 1
            self.failures[site] = fails + 1
            return True
        if _unit_draw(self.plan.seed, site, n) < spec.p:
            self._burst_left[site] = spec.burst - 1
            self.failures[site] = fails + 1
            return True
        return False

    def fire(self, site: str) -> None:
        """Raise :class:`InjectedFault` if this invocation should fail."""
        if self.should_fail(site):
            raise InjectedFault(site, self.invocations.get(site, 1) - 1)

    def total_failures(self) -> int:
        return sum(self.failures.values())

    def counters(self) -> dict:
        """Per-site ``{"invocations": n, "failures": f}`` snapshot."""
        return {
            site: {
                "invocations": self.invocations.get(site, 0),
                "failures": self.failures.get(site, 0),
            }
            for site in sorted(self.invocations)
        }


def as_injector(faults) -> FaultInjector | None:
    """Normalise a ``FaultPlan | FaultInjector | None`` into an injector.

    Config carries the frozen plan; runtime objects want the stateful
    injector.  Passing an injector through lets several subsystems share
    one set of counters when a test wires them together by hand.
    """
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return faults.injector()
    raise TypeError(f"expected FaultPlan, FaultInjector, or None, got {type(faults)!r}")


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff for transient-failure retries.

    ``max_attempts`` counts total tries per target (1 = no retry).  The
    default ``base_delay_s=0`` keeps in-process chaos tests instant;
    real transports set a small base so retries do not hammer a server
    that is restarting.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.0
    max_delay_s: float = 0.1
    multiplier: float = 2.0

    def validate(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("retry delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {self.multiplier}")

    def backoff(self, attempt: int) -> float:
        """Delay before retrying after the ``attempt``-th failure (1-based)."""
        if self.base_delay_s <= 0.0:
            return 0.0
        return min(self.max_delay_s, self.base_delay_s * self.multiplier ** (attempt - 1))

    def sleep(self, attempt: int, *, deadline: float | None = None) -> None:
        """Sleep the backoff for ``attempt``, clipped to ``deadline``.

        ``deadline`` is an absolute ``time.monotonic()`` value; when the
        budget is already spent the sleep is skipped so deadline-aware
        callers can fail fast instead of overshooting.
        """
        delay = self.backoff(attempt)
        if deadline is not None:
            delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0.0:
            time.sleep(delay)

    def to_dict(self) -> dict:
        return {
            "max_attempts": self.max_attempts,
            "base_delay_s": self.base_delay_s,
            "max_delay_s": self.max_delay_s,
            "multiplier": self.multiplier,
        }


@dataclass
class CircuitBreaker:
    """Quarantines a target after repeated consecutive failures.

    After ``threshold`` consecutive failures the breaker opens:
    ``allow()`` returns False for the next ``cooldown`` checks, then a
    single half-open probe is admitted.  A probe success closes the
    breaker; a probe failure re-opens it immediately.  The cooldown is
    counted in ``allow()`` calls, not wall time, so breaker behaviour is
    as deterministic as the dispatch schedule driving it.
    """

    threshold: int = 3
    cooldown: int = 8
    consecutive_failures: int = 0
    opens: int = 0
    _cooldown_left: int = field(default=0, repr=False)
    _half_open: bool = field(default=False, repr=False)

    def allow(self) -> bool:
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            if self._cooldown_left == 0:
                self._half_open = True
                return True
            return False
        return True

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._half_open = False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self._half_open or self.consecutive_failures >= self.threshold:
            self._cooldown_left = self.cooldown
            self._half_open = False
            self.consecutive_failures = 0
            self.opens += 1

    @property
    def state(self) -> str:
        if self._cooldown_left > 0:
            return "open"
        if self._half_open:
            return "half_open"
        return "closed"
