"""Algebraic rewrite rules over morphology expression graphs (port of
``repro.opt.rules``: the same rules, names, order and guards).

Every rule is a :class:`Rule` — a *pattern / guard / rewrite* triple
over :class:`~repro_torch.api.expr.Expr` nodes — registered in
:data:`DEFAULT_RULES` in a deterministic order (the fixed-point loop
in ``repro_torch.opt.engine`` applies them in registry order, first
match wins).  Rules must be **exactness-provable**: the rewritten graph
is bit-identical to the original on every input, dtype and engine,
which is what lets ``repro_torch.api.compile`` apply them by default.
The catalog, the lattice-algebra argument behind each rule and the
recipe for adding one live in ``docs/OPTIMIZER.md``.

The built-in catalog (morphology algebra over the 3×3 elementary
filters the paper's chains are built from):

``neutral-chain`` / ``neutral-sat``
    zero-length erode/dilate chains and ``sat_sub``/``sat_add`` with
    ``h == 0`` are identities — eliminated.
``chain-merge``
    ε_a ∘ ε_b = ε_{a+b} (δ dual): adjacent same-op chains merge and,
    because both association orders collapse to one node, re-associate
    to a canonical form — two source graphs that differ only in chain
    association lower to one shared program (this is what feeds the
    compile cache's shared-program hits and serve's cross-bucket
    sharing).  Guarded on the inner chain having no other consumer, so
    a shared intermediate is never recomputed.
``opening-absorb`` / ``closing-absorb``
    granulometry absorption γ_s γ_t = γ_t γ_s = γ_max(s,t) (φ dual):
    the s-fold 3×3 ball family is a granulometry (B_t = B_s ⊕ B_{t-s}
    for t ≥ s), so stacked openings collapse — γ/φ idempotence
    (s == t) is the degenerate case.
``double-reconstruct``
    Rec(Rec(m, f), f) = Rec(m, f): reconstruction is idempotent in its
    marker (its output is already a geodesic fixpoint under ``f``).
``geodesic-prefix``
    Rec(δ_f^n(m), f) = Rec(m, f): a fixed-length geodesic prefix of a
    reconstruction toward the *same* mask and op is absorbed by the
    limit — the whole geodesic segment is dead.
``rec-opening-idem``
    γ_rec^s γ_rec^s = γ_rec^s (φ_rec dual): opening by reconstruction
    is an algebraic opening, so applying it to its own output is dead
    work — an entire convergent segment is pruned.
``self-reconstruct`` / ``self-geodesic``
    Rec(f, f) = f and δ_f^n(f) = f: the mask is its own fixpoint —
    the convergent segment is dead and pruned entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.api.expr import E, Expr

__all__ = ["Rule", "DEFAULT_RULES", "register_rule", "rule_names"]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One algebraic rewrite: pattern → (guard) → replacement.

    ``pattern(node)`` returns a bindings dict when the node matches
    (``None`` otherwise); ``guard(bindings, ctx)`` may veto a match
    using graph context (consumer counts of the *current* root — see
    :class:`repro_torch.opt.engine.RewriteContext`); ``build(bindings)``
    constructs the replacement.  The replacement must be bit-exact and
    must preserve the graph's input-leaf set (the engine enforces the
    latter).
    """

    name: str
    pattern: Callable      # Expr -> dict | None
    guard: Callable        # (bindings, RewriteContext) -> bool
    build: Callable        # bindings -> Expr
    doc: str = ""


def _no_guard(bindings, ctx) -> bool:
    return True


def _chain(node: Expr, op: str | None = None):
    """Match an erode/dilate chain node; returns (op, s, child)."""
    if node.kind not in ("erode", "dilate"):
        return None
    if op is not None and node.kind != op:
        return None
    return node.kind, node.param("s"), node.args[0]


def _opening_like(node: Expr):
    """Match γ_s (dilate∘erode) or φ_s (erode∘dilate) with equal s.

    Returns ``(outer_op, s, operand)`` where ``outer_op`` is the kind
    of the *outer* chain ("dilate" for an opening, "erode" for a
    closing).
    """
    outer = _chain(node)
    if outer is None:
        return None
    o_op, o_s, inner_node = outer
    inner = _chain(inner_node, "erode" if o_op == "dilate" else "dilate")
    if inner is None or inner[1] != o_s:
        return None
    return o_op, o_s, inner[2]


# -- patterns ---------------------------------------------------------------


def _p_neutral_chain(node: Expr):
    m = _chain(node)
    if m is not None and m[1] == 0:
        return {"child": m[2]}
    return None


def _p_neutral_sat(node: Expr):
    if node.kind in ("sat_sub", "sat_add") and node.param("h") == 0:
        return {"child": node.args[0]}
    return None


def _p_chain_merge(node: Expr):
    outer = _chain(node)
    if outer is None:
        return None
    op, a, child = outer
    inner = _chain(child, op)
    if inner is None:
        return None
    return {"op": op, "a": a, "b": inner[1], "x": inner[2], "inner": child}


def _g_chain_merge(b, ctx) -> bool:
    # merging through a shared intermediate would recompute it for the
    # other consumers; the lowerer applies the same single-consumer rule
    return ctx.consumers(b["inner"]) <= 1


def _b_chain_merge(b) -> Expr:
    return Expr(b["op"], (b["x"],), (("s", b["a"] + b["b"]),))


def _p_absorb(kind: str):
    """Pattern factory for γ_s γ_t (kind='dilate') / φ_s φ_t ('erode')."""

    def pattern(node: Expr):
        outer = _opening_like(node)
        if outer is None or outer[0] != kind:
            return None
        _, s, y = outer
        inner = _opening_like(y)
        if inner is None or inner[0] != kind:
            return None
        _, t, x = inner
        return {"s": s, "t": t, "x": x, "inner": y}

    return pattern


def _g_absorb(b, ctx) -> bool:
    # s <= t collapses to the existing inner node (always safe); s > t
    # builds a fresh γ_s(x) / φ_s(x), so require the inner stage to
    # have no other consumer (it would otherwise still be computed).
    return b["s"] <= b["t"] or ctx.consumers(b["inner"]) <= 1


def _b_absorb(kind: str):
    def build(b) -> Expr:
        if b["s"] <= b["t"]:
            return b["inner"]
        make = E.opening if kind == "dilate" else E.closing
        return make(b["s"], b["x"])

    return build


def _p_double_reconstruct(node: Expr):
    if node.kind != "reconstruct":
        return None
    marker, mask = node.args
    if (marker.kind == "reconstruct" and marker.args[1] == mask
            and marker.param("op") == node.param("op")):
        return {"inner": marker}
    return None


def _p_geodesic_prefix(node: Expr):
    if node.kind != "reconstruct":
        return None
    marker, mask = node.args
    if (marker.kind == "geodesic" and marker.args[1] == mask
            and marker.param("op") == node.param("op")):
        return {"m": marker.args[0], "f": mask, "op": node.param("op")}
    return None


def _b_geodesic_prefix(b) -> Expr:
    return E.reconstruct(b["m"], b["f"], op=b["op"])


def _p_rec_opening_idem(node: Expr):
    """γ_rec^s γ_rec^s = γ_rec^s (and the φ_rec dual).

    Matches ``Rec_δ(ε_s(Rec_δ(ε_s(f), f)), f)`` — opening by
    reconstruction applied to its own output — and collapses to the
    inner reconstruction.  Exact because γ_rec^s is an algebraic
    opening (anti-extensive, increasing, idempotent); the erode→dilate
    /dilate→erode pairing below is what makes it one.
    """
    if node.kind != "reconstruct":
        return None
    op = node.param("op")
    chain_op = "erode" if op == "dilate" else "dilate"
    marker, mask = node.args
    m = _chain(marker, chain_op)
    if m is None:
        return None
    _, s, inner = m
    if inner.kind != "reconstruct" or inner.param("op") != op:
        return None
    if inner.args[1] != mask:
        return None
    im = _chain(inner.args[0], chain_op)
    if im is None or im[1] != s or im[2] != mask:
        return None
    return {"inner": inner}


def _p_self_reconstruct(node: Expr):
    if node.kind == "reconstruct" and node.args[0] == node.args[1]:
        return {"x": node.args[0]}
    return None


def _p_self_geodesic(node: Expr):
    if node.kind == "geodesic" and node.args[0] == node.args[1]:
        return {"x": node.args[0]}
    return None


#: The built-in exactness-provable catalog, in application order.
#: Shrinking rules run first so compositions (e.g. ``sat_sub(f, 0)``
#: feeding a reconstruction) cascade within one pass.
DEFAULT_RULES: tuple = (
    Rule("neutral-chain", _p_neutral_chain, _no_guard,
         lambda b: b["child"],
         "ε_0 = δ_0 = id: zero-length chains are identities"),
    Rule("neutral-sat", _p_neutral_sat, _no_guard,
         lambda b: b["child"],
         "sat_sub/sat_add with h=0 clamp nothing: x ∓ 0 = x"),
    Rule("self-reconstruct", _p_self_reconstruct, _no_guard,
         lambda b: b["x"],
         "Rec(f, f) = f: the mask is already a geodesic fixpoint"),
    Rule("self-geodesic", _p_self_geodesic, _no_guard,
         lambda b: b["x"],
         "δ_f^n(f) = f (ε dual): geodesic steps from the mask are dead"),
    Rule("double-reconstruct", _p_double_reconstruct, _no_guard,
         lambda b: b["inner"],
         "Rec(Rec(m, f), f) = Rec(m, f): reconstruction is idempotent"),
    Rule("geodesic-prefix", _p_geodesic_prefix, _no_guard,
         _b_geodesic_prefix,
         "Rec(δ_f^n(m), f) = Rec(m, f): a bounded geodesic prefix is "
         "absorbed by the reconstruction limit"),
    Rule("rec-opening-idem", _p_rec_opening_idem, _no_guard,
         lambda b: b["inner"],
         "γ_rec^s γ_rec^s = γ_rec^s (φ_rec dual): opening by "
         "reconstruction is an algebraic opening, hence idempotent"),
    Rule("chain-merge", _p_chain_merge, _g_chain_merge, _b_chain_merge,
         "ε_a ε_b = ε_{a+b} (δ dual): canonicalizes chain association"),
    Rule("opening-absorb", _p_absorb("dilate"), _g_absorb,
         _b_absorb("dilate"),
         "γ_s γ_t = γ_max(s,t): granulometry absorption (idempotence "
         "at s = t)"),
    Rule("closing-absorb", _p_absorb("erode"), _g_absorb,
         _b_absorb("erode"),
         "φ_s φ_t = φ_max(s,t): dual granulometry absorption"),
)

_EXTRA_RULES: list = []


def register_rule(rule: Rule) -> Rule:
    """Append a custom rule after the built-in catalog (extension
    point; see ``docs/OPTIMIZER.md`` for the exactness obligations).
    Clears the engine's memoized rewrites so the new rule applies to
    already-seen graphs."""
    if rule.name in rule_names():
        raise ValueError(f"rule {rule.name!r} already registered")
    _EXTRA_RULES.append(rule)
    from repro_torch.opt import engine

    engine.clear_rewrite_cache()
    return rule


def active_rules() -> tuple:
    return DEFAULT_RULES + tuple(_EXTRA_RULES)


def rule_names() -> tuple:
    return tuple(r.name for r in active_rules())
