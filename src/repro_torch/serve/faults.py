"""Deterministic fault-injection harness for the serving lifecycle (a
copy of ``repro.serve.faults``: the same sites, grammar and seeded
draws, so one spec and seed inject the same faults on both sides).

The chaos suite (``tests/test_faults.py``) and the CI ``chaos`` job
need to provoke every failure path — executor exceptions, poisoned
co-batches, deadline pressure, exhausted convergence budgets — *and*
reproduce a failing run exactly.  So faults are injected at **named
sites** by a seeded :class:`FaultInjector` the service consults at
each site; the whole schedule is a pure function of the spec string
and seed.

Sites (checked where the real failure would originate):

``dispatch``
    raise :class:`InjectedFault` in ``Service._launch`` just before the
    batch is handed to the executor — models a trace/compile/launch
    failure.  Fires per *batch*.
``drain``
    raise in ``Executor.drain_one`` before it waits on the batch's CUDA
    event — models an asynchronous device-side execution failure.  Fires per
    *batch*.
``poison``
    mark a submitted request as poisoned (fires per *request*); any
    batch execution whose requests include a poisoned one raises
    :class:`InjectedFault` deterministically, which is exactly the
    semantics the executor's bisect-retry quarantine needs to isolate
    it.
``deadline``
    deadline pressure: override the request's deadline with ``value``
    milliseconds (fires per request), so it expires while queued.
``budget``
    non-convergence pressure: compile bucket programs with
    ``max_chunks=value`` so the scheduler watchdog trips and results
    come back degraded (``value`` is part of ``Executable.key``, so
    injected and clean programs never share a cache entry).

Spec grammar (also accepted from the ``REPRO_FAULTS`` environment
variable, e.g. in the CI chaos job)::

    REPRO_FAULTS="seed=1702;dispatch:p=0.2,n=2;poison:p=0.1;budget:value=1"

``;``-separated clauses; ``seed=<int>`` fixes the RNG, every other
clause is ``site[:key=value,...]`` with keys ``n`` (max fires, 0 =
unlimited), ``p`` (per-opportunity probability) and ``value``
(site-specific payload).  Services built without an explicit
``faults=`` injector pick up the environment via :func:`from_env`;
:data:`NULL` never fires.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np

from repro_torch.serve.errors import ServeError

#: Every site the service consults, in lifecycle order.
SITES = ("dispatch", "drain", "poison", "deadline", "budget")


class InjectedFault(RuntimeError):
    """The injected failure itself.

    Deliberately *not* a :class:`~repro_torch.serve.errors.ServeError`: it
    models an unstructured backend/kernel failure, and the whole point
    of the chaos suite is asserting the service converts it into typed
    per-request outcomes.
    """

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at site {site!r}"
                         + (f": {detail}" if detail else ""))
        self.site = site


class FaultSpecError(ServeError):
    """A malformed fault spec string (bad site/key/number)."""

    code = "fault_spec"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed site: fire up to ``n`` times (0 = unlimited), each
    opportunity with probability ``p``; ``value`` is the site payload
    (budget's ``max_chunks``, deadline's milliseconds)."""

    site: str
    n: int = 0
    p: float = 1.0
    value: float | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {self.site!r}; sites: {', '.join(SITES)}"
            )
        if self.n < 0:
            raise FaultSpecError(f"site {self.site!r}: n must be >= 0")
        if not 0.0 <= self.p <= 1.0:
            raise FaultSpecError(f"site {self.site!r}: p must be in [0, 1]")


class FaultInjector:
    """Seeded, replayable fault schedule over the named sites.

    Decision order is the order sites are consulted at run time, so a
    given (spec, seed, request stream) always injects the same faults.
    ``fired`` counts injections per site (surfaced by
    ``Service.stats()['faults']``).
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs: dict[str, FaultSpec] = {}
        for spec in specs:
            if spec.site in self.specs:
                raise FaultSpecError(f"duplicate fault site {spec.site!r}")
            self.specs[spec.site] = spec
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.fired: collections.Counter = collections.Counter()

    def armed(self, site: str) -> bool:
        return site in self.specs

    def should_fire(self, site: str) -> bool:
        """Consume one opportunity at ``site``; True iff it injects."""
        spec = self.specs.get(site)
        if spec is None:
            return False
        if spec.n and self.fired[site] >= spec.n:
            return False
        if spec.p < 1.0 and self._rng.random() >= spec.p:
            return False
        self.fired[site] += 1
        return True

    def check(self, site: str, detail: str = "") -> None:
        """Raise :class:`InjectedFault` iff ``site`` fires now."""
        if self.should_fire(site):
            raise InjectedFault(site, detail)

    def value(self, site: str, default=None):
        """The armed site's payload (no fire accounting) — used for
        *pressure* sites (budget) whose effect must be stable across
        every compile of the same bucket."""
        spec = self.specs.get(site)
        return default if spec is None or spec.value is None else spec.value

    def snapshot(self) -> dict:
        """JSON-serializable view: armed sites + per-site fire counts."""
        return {
            "seed": self.seed,
            "armed": sorted(self.specs),
            "fired": {k: int(v) for k, v in sorted(self.fired.items())},
        }

    def __repr__(self):
        return (f"FaultInjector(seed={self.seed}, "
                f"sites={sorted(self.specs)}, fired={dict(self.fired)})")


#: Injector with no armed sites — every check is a no-op.
NULL = FaultInjector()


def parse(text: str) -> FaultInjector:
    """Parse the ``REPRO_FAULTS`` grammar into an injector."""
    seed = 0
    specs = []
    for clause in filter(None, (c.strip() for c in text.split(";"))):
        if clause.startswith("seed="):
            try:
                seed = int(clause[5:])
            except ValueError:
                raise FaultSpecError(f"bad seed clause {clause!r}") from None
            continue
        site, _, rest = clause.partition(":")
        kwargs: dict = {}
        for kv in filter(None, (p.strip() for p in rest.split(","))):
            key, eq, raw = kv.partition("=")
            if not eq or key not in ("n", "p", "value"):
                raise FaultSpecError(
                    f"bad fault option {kv!r} in clause {clause!r} "
                    "(keys: n, p, value)"
                )
            try:
                kwargs[key] = int(raw) if key == "n" else float(raw)
            except ValueError:
                raise FaultSpecError(
                    f"bad number {raw!r} in clause {clause!r}"
                ) from None
        specs.append(FaultSpec(site=site.strip(), **kwargs))
    return FaultInjector(specs, seed=seed)


def from_env(environ=os.environ) -> FaultInjector:
    """Injector from ``REPRO_FAULTS``; :data:`NULL` when unset/empty."""
    text = environ.get("REPRO_FAULTS", "").strip()
    return parse(text) if text else NULL
