"""Bounded deterministic fixed-point engine for the rewrite rules (port
of ``repro.opt.engine``).

:func:`rewrite_traced` canonicalizes an
:class:`~repro_torch.api.expr.Expr` graph by running the registered
rules (``repro_torch.opt.rules``) bottom-up to a fixed point, and
returns the rewritten root together with the ordered trace of every
rule application, which ``repro_torch.api.compile`` hands to the
:class:`~repro_torch.api.executable.Executable` as ``rewrite_trace``.

Determinism and termination:

* rules are tried in registry order at every node, first match wins;
  within one pass the graph is rebuilt bottom-up with structural
  memoization, so identical sub-DAGs rewrite identically and stay
  shared;
* each pass may cascade (a node is re-matched after a rule fires on
  it, bounded by :data:`MAX_NODE_STEPS`), and whole passes repeat
  until the root stops changing, bounded by :data:`MAX_PASSES`;
* guards see consumer counts of the graph *at the start of the pass*
  (a conservative snapshot — a vetoed match is retried next pass with
  fresh counts, so the bound is on latency, not on what gets found).

The engine enforces the one global safety invariant rules cannot
express locally: a rewrite must preserve the graph's named-input
signature (the calling convention of the compiled program).  If a
rule ever changes it, the whole rewrite is discarded and the source
graph is returned untouched.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.api.expr import Expr
from repro_torch.api.lower import _consumer_counts, _input_names
from repro_torch.opt import rules as _rules

__all__ = ["Applied", "RewriteResult", "rewrite", "rewrite_traced",
           "clear_rewrite_cache"]

#: Whole-graph passes before the engine gives up (a diverging rule set
#: is a bug; every built-in rule strictly shrinks the graph or is
#: applied at most once per node, so 2-3 passes is typical).
MAX_PASSES = 32

#: Cascaded rule firings at a single node within one pass.
MAX_NODE_STEPS = 16


@dataclasses.dataclass(frozen=True)
class Applied:
    """One rule application: ``before`` → ``after`` (both sub-graphs
    of the rewrite in flight; replayable in isolation because every
    rule is locally exact)."""

    rule: str
    before: Expr
    after: Expr


@dataclasses.dataclass(frozen=True)
class RewriteResult:
    source: Expr
    expr: Expr
    trace: tuple  # of Applied, in application order

    @property
    def changed(self) -> bool:
        return self.expr != self.source

    @property
    def n_applied(self) -> int:
        return len(self.trace)


class RewriteContext:
    """Per-pass graph context handed to rule guards."""

    def __init__(self, root: Expr):
        self._counts = _consumer_counts(root)

    def consumers(self, node: Expr) -> int:
        """How many parents ``node`` had at the start of this pass."""
        return self._counts.get(node, 0)


def _apply_at(node: Expr, active, ctx: RewriteContext, trace: list) -> Expr:
    """Cascade rules at one node (children already rewritten)."""
    for _ in range(MAX_NODE_STEPS):
        for rule in active:
            bindings = rule.pattern(node)
            if bindings is None:
                continue
            if not rule.guard(bindings, ctx):
                continue
            replacement = rule.build(bindings)
            if replacement == node:
                continue
            trace.append(Applied(rule.name, node, replacement))
            node = replacement
            break
        else:
            return node
    return node


def _one_pass(root: Expr, active, trace: list) -> Expr:
    ctx = RewriteContext(root)
    memo: dict = {}

    def rec(node: Expr) -> Expr:
        hit = memo.get(node)
        if hit is not None:
            return hit
        new_args = tuple(rec(a) for a in node.args)
        if new_args != node.args:
            node2 = Expr(node.kind, new_args, node.params)
        else:
            node2 = node
        out = _apply_at(node2, active, ctx, trace)
        memo[node] = out
        return out

    return rec(root)


@functools.lru_cache(maxsize=1024)
def rewrite_traced(expr: Expr) -> RewriteResult:
    """Canonicalize ``expr``; returns the rewritten graph + trace.

    Pure and memoized — safe to call from the compile cache's key
    derivation.
    """
    active = _rules.active_rules()
    trace: list = []
    node = expr
    for _ in range(MAX_PASSES):
        before = node
        node = _one_pass(node, active, trace)
        if node == before:
            break
    if node != expr and _input_names(node) != _input_names(expr):
        # a rule dropped or reordered a named input: the rewritten
        # program would have a different calling convention — discard
        return RewriteResult(expr, expr, ())
    return RewriteResult(expr, node, tuple(trace))


def rewrite(expr: Expr) -> Expr:
    """The canonical form of ``expr`` (same graph if nothing fired)."""
    return rewrite_traced(expr).expr


def clear_rewrite_cache() -> None:
    rewrite_traced.cache_clear()
