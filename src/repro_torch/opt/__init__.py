"""Expression optimizer: exact algebraic rewrites over Expr graphs
(port of ``repro.opt``, pure Python over ``repro_torch.api.expr``).

The compiler middle-end — runs between composition
(``repro_torch.api.expr``) and lowering (``repro_torch.api.lower``).
``rewrite()`` canonicalizes a graph with the exactness-provable rule
catalog in ``repro_torch.opt.rules`` (the reference's rules, names,
order and guards); ``repro_torch.api.compile`` applies it by default
(escape hatch ``rewrite=False``) and keys its cache on the canonical
form, so source graphs that are algebraically equal share one compiled
program.
"""
from repro_torch.opt.engine import (Applied, RewriteResult,
                                    clear_rewrite_cache, rewrite,
                                    rewrite_traced)
from repro_torch.opt.rules import (DEFAULT_RULES, Rule, active_rules,
                                   register_rule, rule_names)

__all__ = [
    "Applied",
    "RewriteResult",
    "Rule",
    "DEFAULT_RULES",
    "active_rules",
    "register_rule",
    "rule_names",
    "rewrite",
    "rewrite_traced",
    "clear_rewrite_cache",
]
