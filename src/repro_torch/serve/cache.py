"""Compiled-program cache: LRU over bucket programs (a copy of
``repro.serve.cache``).

Each entry wraps the callable compiled for one bucket program together
with the :class:`~repro_torch.core.chain.ChainPlan` it embeds
(``entry.plan.key`` exposes it for introspection/metrics).  Keys are
the port's ``Executable.key`` — lowered run signature + bucket shape/
dtype/backend + plan key + device, the same identity the
``repro_torch.api`` compile cache uses — so the serve cache key and the
compile key are one object; custom (non-expression) OpSpecs key on
(name, params) instead.  Eviction is least-recently-used; ``warm``
prefill builds entries without counting toward the hit/miss statistics
so steady-state hit-rate stays meaningful.
"""
from __future__ import annotations

import collections
from typing import Any, NamedTuple


class CacheEntry(NamedTuple):
    fn: Any              # the batched program (a plain callable)
    plan: Any            # ChainPlan it embeds (None: torch engine)
    key: tuple
    #: stats-returning variant ``(inputs) -> (outputs, (N,) converged)``
    #: (``Executable.run_batch_stats``); None for custom OpSpecs, whose
    #: hand-written run exposes no convergence watchdog.
    stats_fn: Any = None
    #: the underlying ``api.Executable`` for expression ops; None for
    #: custom OpSpecs.
    exe: Any = None

    def primary(self):
        """The callable the executor dispatches (and warmup executes):
        the stats variant when the program has one, else ``fn``."""
        return self.stats_fn if self.stats_fn is not None else self.fn


class CompiledProgramCache:
    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: collections.OrderedDict[tuple, CacheEntry] = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.warm_builds = 0

    def get(self, key: tuple, builder) -> CacheEntry:
        """Look up, counting a hit/miss; ``builder()`` fills on miss."""
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        return self._insert(key, builder)

    def warm(self, key: tuple, builder) -> CacheEntry:
        """Prefill an entry (no hit/miss accounting)."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return entry
        self.warm_builds += 1
        return self._insert(key, builder)

    def _insert(self, key: tuple, builder) -> CacheEntry:
        entry = builder()
        if not isinstance(entry, CacheEntry):
            entry = CacheEntry(fn=entry, plan=None, key=key)
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "warm_builds": self.warm_builds,
            "hit_rate": self.hits / total if total else 0.0,
        }

    def entries(self) -> list[CacheEntry]:
        """Resident entries, LRU-first (introspection/tests)."""
        return list(self._entries.values())

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)
