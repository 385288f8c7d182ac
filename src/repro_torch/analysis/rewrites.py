"""Rewrite soundness hook (check class f; port of
``repro.analysis.rewrites``): numeric replay of the expression
optimizer's applied rules.

The optimizer (``repro_torch.opt``) only ships exactness-*provable* rules,
but a proof about the algebra is not a proof about the implementation:
a pattern that binds the wrong operand, a guard that under-constrains,
or a build that swaps arguments would all survive the static checks
(the rewritten program is still structurally valid — it just computes
the wrong thing).  This module closes that gap dynamically:

* :func:`replay_applied` re-executes one :class:`~repro_torch.opt.engine.
  Applied` step — the rule's ``before`` and ``after`` sub-graphs,
  compiled **unrewritten** on the ``"torch"`` oracle engine, on
  ``device`` — on randomized small inputs and demands bit-equality.
  Because every rule is locally exact, each step is checkable in
  isolation; the composition of bit-exact steps is bit-exact, so a
  clean trace proves the whole rewrite.
* :func:`check_rewrites` drives the end-to-end contract for one
  source expression: replays every trace step, re-runs the structural
  halo/pad-state proof on the rewritten program, and additionally
  executes ``source`` vs ``canonical`` whole-graph on random inputs
  (belt and braces — it would only fire if the per-step argument
  itself were wrong).

Wired in at two levels: ``verify_executable(level="sound")`` replays
the trace an executable was compiled with on the executable's own
device, and ``python -m repro_torch.analysis.lint --rewrites`` sweeps
the serve registry's source expressions through :func:`check_rewrites`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import ERROR, WARN, Finding

__all__ = ["replay_applied", "check_trace", "check_rewrites",
           "random_inputs", "REPLAY_SHAPE3", "REPLAY_DTYPES"]

#: Replay geometry: small enough that the oracle converges fast,
#: batched and ragged enough to exercise per-image reductions.
REPLAY_SHAPE3 = (2, 24, 33)

#: Dtypes replayed by default: the paper's integer lattice and a float
#: lattice (saturation and identity values differ between them).
REPLAY_DTYPES = ("uint8", "float32")


def random_inputs(names, shape3, dtype, seed: int):
    """One random array per input leaf, dtype-appropriate range."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    out = {}
    for i, name in enumerate(names):
        if dt.kind in "ui":
            hi = min(255, np.iinfo(dt).max)
            arr = rng.integers(0, hi, size=shape3, endpoint=True, dtype=dt)
        else:
            arr = rng.random(size=shape3).astype(dt)
        out[name] = arr
    return out


def _execute(expr, inputs: dict, shape3, dtype, device):
    """Evaluate ``expr`` verbatim (optimizer off) on the ``"torch"``
    oracle engine on ``device``; outputs come back as NumPy arrays."""
    from repro_torch.api.compile import compile as api_compile
    from repro_torch.api.lower import _input_names

    exe = api_compile(expr, shape3, dtype, "torch", verify=False,
                      rewrite=False, device=device)
    outs = exe(*(inputs[n] for n in _input_names(expr)))
    outs = outs if isinstance(outs, tuple) else (outs,)
    return tuple(o.cpu().numpy() for o in outs)


def replay_applied(step, shape3=REPLAY_SHAPE3, dtypes=REPLAY_DTYPES,
                   n_samples: int = 2, seed: int = 0, *,
                   device=None) -> list:
    """Numerically replay one applied rule; bit-inequality is an ERROR.

    Both sides run with ``rewrite=False`` so the replay cannot be
    masked by the very engine under test.
    """
    from repro_torch.api.lower import LoweringError, _input_names

    out = []
    names = _input_names(step.before)
    for dtype in dtypes:
        for k in range(n_samples):
            inputs = random_inputs(names, shape3, dtype,
                                   seed + 7919 * k)
            try:
                got_before = _execute(step.before, inputs, shape3, dtype,
                                      device)
                got_after = _execute(step.after, inputs, shape3, dtype,
                                     device)
            except LoweringError as e:
                # a mid-rewrite sub-graph need not be a standalone
                # program (e.g. a picked QDT plane); nothing to replay
                out.append(Finding(
                    "rewrite", WARN, f"rule {step.rule}",
                    f"sub-graph not replayable in isolation: {e}"))
                return out
            if len(got_before) != len(got_after):
                out.append(Finding(
                    "rewrite", ERROR, f"rule {step.rule}",
                    f"output arity changed: {len(got_before)} → "
                    f"{len(got_after)}"))
                return out
            for i, (a, b) in enumerate(zip(got_before, got_after)):
                if not np.array_equal(a, b):
                    diff = int(np.sum(a != b))
                    out.append(Finding(
                        "rewrite", ERROR, f"rule {step.rule}",
                        f"not bit-exact on {dtype} sample {k} (output "
                        f"{i}): {diff} differing pixel(s) — "
                        f"{step.before.label()} vs {step.after.label()}"))
                    return out
    return out


def check_trace(trace, shape3=REPLAY_SHAPE3, dtypes=REPLAY_DTYPES,
                n_samples: int = 2, seed: int = 0, *, device=None) -> list:
    """Replay every step of a rewrite trace (each rule in isolation)."""
    out = []
    for step in trace:
        out.extend(replay_applied(step, shape3, dtypes, n_samples, seed,
                                  device=device))
    return out


def check_rewrites(expr, shape3=REPLAY_SHAPE3, dtypes=REPLAY_DTYPES,
                   n_samples: int = 2, seed: int = 0, *,
                   device=None) -> list:
    """Full soundness check of the optimizer on one source expression:
    per-step replay + structural re-proof + whole-graph equality."""
    from repro_torch.analysis import halo
    from repro_torch.api.lower import LoweringError, _input_names, lower
    from repro_torch.opt import rewrite_traced

    result = rewrite_traced(expr)
    out = check_trace(result.trace, shape3, dtypes, n_samples, seed,
                      device=device)
    if not result.changed:
        return out

    # the rewritten program must still satisfy the pad-state proof
    try:
        out.extend(halo.check_program(lower(result.expr)))
    except LoweringError as e:
        out.append(Finding(
            "rewrite", ERROR, "canonical graph",
            f"source lowers but its canonical form does not: {e}"))
        return out

    names = _input_names(expr)
    if _input_names(result.expr) != names:
        out.append(Finding(
            "rewrite", ERROR, "canonical graph",
            f"input signature changed: {names} → "
            f"{_input_names(result.expr)}"))
        return out
    for dtype in dtypes:
        for k in range(n_samples):
            inputs = random_inputs(names, shape3, dtype, seed + 104729 * k)
            got_src = _execute(expr, inputs, shape3, dtype, device)
            got_can = _execute(result.expr, inputs, shape3, dtype, device)
            for i, (a, b) in enumerate(zip(got_src, got_can)):
                if not np.array_equal(a, b):
                    out.append(Finding(
                        "rewrite", ERROR, "canonical graph",
                        f"execute(rewrite(g)) != execute(g) on {dtype} "
                        f"sample {k} (output {i}) after "
                        f"{result.n_applied} rule application(s)"))
                    return out
    return out
